"""ZeRO-Infinity parameter streaming: host-resident block parameters.

The port's copy of ``deepspeed_tpu/runtime/zero/param_stream.py``
(reference ``offload_param``: parameter partitions live in host memory and
stream to the device just before use, ``partitioned_param_swapper.py:35``,
``zero/stage3.py:486``).

The model's stacked ``[L, ...]`` block parameters live on the host: a
float32 master (adopted from the block optimizer's flat buffer, so updates
land in place), a compute copy in the compute dtype (pinned when the
engine runs on CUDA) and a float32 gradient accumulator.  Each layer runs
through :class:`_StreamedBlock`, a ``torch.autograd.Function`` that is
the JAX ``custom_vjp`` (``param_stream.py:108-140``): its forward loads
layer ``i`` from the compute copy and saves only ``(i, x)``; its backward
reloads the layer, re-runs the block under autograd (a manual remat),
adds the weight gradient into the host accumulator and returns only dx.
The device therefore holds at most two streamed layers: the one computing
and the next one, whose load runs on a side stream meanwhile.  The
accumulation into host memory runs on a worker thread, so the card goes
on with the next layer's backward while the host adds.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ...ops import cpu_adam
from ...utils.logging import logger

Blocks = Dict[str, Any]


class StreamedParamStore:
    """Host store for ``[L, ...]``-stacked block parameters with gradient
    accumulation.  ``blocks``: name -> stacked leaf (tensor on any device,
    or array); ``device``: where the layers run."""

    def __init__(self, blocks: Blocks, compute_dtype=torch.bfloat16,
                 device: Optional[torch.device] = None):
        self.names = list(blocks)
        leaves = [blocks[k] for k in self.names]
        self.num_layers = int(leaves[0].shape[0])
        self.device = torch.device(device or "cpu")
        self.compute_dtype = compute_dtype
        # float32 arrays are adopted as they are (the block optimizer's
        # master views, so its updates land in place); others are copied
        self.master: List[np.ndarray] = []
        for x in leaves:
            if isinstance(x, np.ndarray) and x.dtype == np.float32 and \
                    x.flags.c_contiguous:
                self.master.append(x)
                continue
            m = np.empty(tuple(x.shape), np.float32)
            torch.from_numpy(m).copy_(torch.as_tensor(x).detach())
            self.master.append(m)
        pin = self.device.type == "cuda"
        # one flat compute buffer and one flat float32 gradient accumulator,
        # leaves as views, in the block optimizer's flat order: its bf16
        # output lands in the compute copy and it reads the gradient in place
        total = sum(m.size for m in self.master)
        self.compute_flat = torch.empty(total, dtype=compute_dtype,
                                        pin_memory=pin)
        self.grad_flat = torch.zeros(total, dtype=torch.float32)
        self.compute: List[torch.Tensor] = []
        self.grad_acc: List[np.ndarray] = []
        off = 0
        for m in self.master:
            self.compute.append(self.compute_flat[off:off + m.size].view(
                m.shape))
            self.grad_acc.append(
                self.grad_flat[off:off + m.size].numpy().reshape(m.shape))
            off += m.size
        self.refresh_compute()
        # one layer's f32 gradient staged on the host, two in flight
        self._stage = [[torch.empty(m.shape[1:], dtype=torch.float32,
                                    pin_memory=pin) for m in self.master]
                       for _ in range(2)]
        self._stage_busy: List[Optional[Any]] = [None, None]
        self._next_stage = 0
        self._pool = ThreadPoolExecutor(1, thread_name_prefix="ds_stream")
        self._loaded: Dict[int, tuple] = {}
        self._side = torch.cuda.Stream(self.device) if pin else None
        self.bytes_in = 0          # host -> device, weights
        self.bytes_out = 0         # device -> host, gradients
        logger.info(f"param streaming: {self.num_layers} layers, "
                    f"{sum(m.nbytes for m in self.master) / 1e9:.2f}GB fp32 "
                    "master host-resident")

    # ---------------------------------------------------------------- loads
    def _issue_load(self, i: int) -> None:
        """Start copying layer ``i``'s compute weights to the device."""
        if i in self._loaded or not 0 <= i < self.num_layers:
            return
        if self._side is None:
            self._loaded[i] = ([c[i].clone() for c in self.compute], None)
            return
        cur = torch.cuda.current_stream(self.device)
        # allocated on the compute stream, written on the side stream once
        # the compute stream's earlier work (which may have freed this
        # memory) is done
        bufs = [torch.empty(c.shape[1:], dtype=c.dtype, device=self.device)
                for c in self.compute]
        self._side.wait_stream(cur)
        with torch.cuda.stream(self._side):
            for b, c in zip(bufs, self.compute):
                b.copy_(c[i], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._side)
        self._loaded[i] = (bufs, ev)
        self.bytes_in += sum(b.numel() * b.element_size() for b in bufs)

    def load(self, i: int, ahead: int) -> Dict[str, torch.Tensor]:
        """Layer ``i``'s weights on the device, and the load of layer
        ``i + ahead`` started."""
        self._issue_load(i)
        bufs, ev = self._loaded.pop(i)
        if ev is not None:
            torch.cuda.current_stream(self.device).wait_event(ev)
        self._issue_load(i + ahead)
        return dict(zip(self.names, bufs))

    # ------------------------------------------------------------ gradients
    def push(self, i: int, grads: List[torch.Tensor]) -> None:
        """Add layer ``i``'s weight gradient (float32 of the compute-dtype
        cotangent) into the host accumulator, on the worker thread."""
        k = self._next_stage
        self._next_stage ^= 1
        if self._stage_busy[k] is not None:
            self._stage_busy[k].result()
        stage = self._stage[k]
        for s, g in zip(stage, grads):
            s.copy_(g.to(torch.float32), non_blocking=True)
        self.bytes_out += sum(s.numel() * 4 for s in stage)
        ev = None
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
        # OpenMP sizes its pool per thread: the worker takes the caller's
        threads = cpu_adam.get_num_threads()

        def accumulate():
            if ev is not None:
                ev.synchronize()
            cpu_adam.set_num_threads(threads)
            for acc, s in zip(self.grad_acc, stage):
                cpu_adam.add_(acc[i].reshape(-1), s.reshape(-1))

        self._stage_busy[k] = self._pool.submit(accumulate)

    def join(self) -> None:
        """Wait for every pushed gradient to be in the accumulator."""
        for k, fut in enumerate(self._stage_busy):
            if fut is not None:
                fut.result()
                self._stage_busy[k] = None
        self._loaded.clear()

    def streamed_block(self, call_block: Callable):
        """``apply(i, x)``: ``call_block(layer, x)`` on layer ``i`` with the
        weights streamed (forward and backward, :class:`_StreamedBlock`)."""

        def apply(i, x):
            return _StreamedBlock.apply(x, i, self, call_block)

        return apply

    # ---------------------------------------------------------- host-side API
    def pop_grads(self) -> List[np.ndarray]:
        """Return and clear the accumulated [L, ...] block grads (fp32)."""
        self.join()
        out = [g.copy() for g in self.grad_acc]
        self.grad_flat.zero_()
        return out

    def sq_grad_norm(self) -> float:
        """The accumulated block gradients' sum of squares (float64)."""
        self.join()
        return cpu_adam.sq_norm(self.grad_flat)

    def refresh_compute(self) -> None:
        """Re-cast the compute copy after a master update."""
        for c, m in zip(self.compute, self.master):
            c.copy_(torch.from_numpy(m))

    def master_blocks(self) -> Blocks:
        return dict(zip(self.names, self.master))

    def load_master(self, blocks: Blocks) -> None:
        for m, name in zip(self.master, self.names):
            torch.from_numpy(m).copy_(torch.as_tensor(blocks[name]))
        self.refresh_compute()

    def close(self) -> None:
        self.join()
        self._pool.shutdown(wait=True)


class _StreamedBlock(torch.autograd.Function):
    """One streamed layer: the forward keeps only ``x``; the backward
    reloads the layer and recomputes the block under autograd."""

    @staticmethod
    def forward(ctx, x, i, store, call_block):
        layer = store.load(i, ahead=1)
        out = call_block(layer, x)
        ctx.save_for_backward(x)
        ctx.i, ctx.store, ctx.call_block = i, store, call_block
        return out

    @staticmethod
    def backward(ctx, ct):
        (x,) = ctx.saved_tensors
        store = ctx.store
        layer = store.load(ctx.i, ahead=-1)
        with torch.enable_grad():
            xd = x.detach().requires_grad_()
            leaves = [layer[n].requires_grad_() for n in store.names]
            out = ctx.call_block(dict(zip(store.names, leaves)), xd)
            grads = torch.autograd.grad(out, [xd] + leaves, ct)
        store.push(ctx.i, list(grads[1:]))
        return grads[0], None, None, None
