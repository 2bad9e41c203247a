"""ZeRO-Offload / ZeRO-Infinity optimizer-state offload tiers.

The port's copy of ``deepspeed_tpu/runtime/zero/offload.py`` (reference
mechanics, SURVEY §2.1):
 - ZeRO-Offload: the optimizer state (fp32 master + Adam moments) lives in
   host memory and the optimizer step runs on the host CPU through the
   vectorized C++ Adam (``ops/cpu_adam.py``);
 - ZeRO-Infinity: the moments live in files under ``nvme_path`` and are
   swapped through two host staging buffers of ``sub_group_size``
   elements: the read of group i+1 and the write-back of group i-1 overlap
   the Adam compute of group i through ``ops/aio.py``.

One rank holds the whole partition here (world size 1; the multi-rank
partitions come with ``ROADMAP.md`` Queue A 8).  The arithmetic is
elementwise, so a step taken group by group, or piece by piece through
:meth:`HostOffloadOptimizer.step_stream`, gives the bits of one whole
step: the offload engine uses that to stream gradients in and weights out
through a small pinned ring instead of staging the whole f32 gradient on
the host.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
import uuid
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ...ops.aio import AsyncIOHandle
from ...ops.cpu_adam import DeepSpeedCPUAdagrad, DeepSpeedCPUAdam, sq_norm
from ...utils.logging import logger

Leaf = Union[np.ndarray, torch.Tensor]


def _make_cpu_optimizer(name: str, params: dict):
    """The host optimizer and its moment count for a config optimizer
    name (``offload.py:39``)."""
    name = (name or "adam").lower()
    params = dict(params or {})
    params.pop("torch_adam", None)
    params.pop("fused", None)
    lr = params.pop("lr", 1e-3)
    if name in ("adam", "adamw", "fusedadam"):
        adamw = True if name == "adamw" else bool(params.pop("adam_w_mode", True))
        return DeepSpeedCPUAdam(
            lr=lr, betas=tuple(params.pop("betas", (0.9, 0.999))),
            eps=params.pop("eps", 1e-8),
            weight_decay=params.pop("weight_decay", 0.0),
            bias_correction=params.pop("bias_correction", True),
            adamw_mode=adamw), 2
    if name == "adagrad":
        return DeepSpeedCPUAdagrad(
            lr=lr, eps=params.pop("eps", 1e-10),
            weight_decay=params.pop("weight_decay", 0.0)), 1
    raise ValueError(
        f"optimizer {name!r} has no CPU-offload implementation "
        "(reference supports cpu adam/adagrad for offload)")


def _flat_host(leaf: Leaf) -> torch.Tensor:
    """A leaf as a flat float32 tensor (on its own device)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().reshape(-1).to(torch.float32)
    return torch.from_numpy(np.ascontiguousarray(np.asarray(leaf, np.float32))
                            ).reshape(-1)


class HostRing:
    """The transfer protocol of :meth:`HostOffloadOptimizer.step_stream`
    when the gradient and the compute copy are host (CPU) buffers: the
    gradient is read in place and a bf16 compute copy is written in place
    by the step; a float32 one takes the updated master slice.  With no
    ``compute`` it only feeds the gradient (the JAX API's
    :meth:`HostOffloadOptimizer.step`)."""

    chunk = None

    def __init__(self, grads: Leaf, compute: Optional[torch.Tensor] = None):
        self._grads = grads
        self._compute = compute

    def begin(self, pieces):
        pass

    def grads(self, start, end):
        return self._grads[start:end]

    def out16(self, start, end):
        if self._compute is not None and \
                self._compute.dtype == torch.bfloat16:
            return self._compute[start:end]
        return None

    def put(self, start, end, out):
        if self._compute is not None and \
                self._compute.dtype != torch.bfloat16:
            self._compute[start:end].copy_(torch.from_numpy(out))


class DeviceRing:
    """The transfer protocol of :meth:`HostOffloadOptimizer.step_stream`
    between a flat float32 gradient and a flat compute copy on a CUDA
    device, through a ring of pinned host slots of ``chunk`` elements:
    ``slots`` gradient slots, whose copies to the host run ahead of the
    host step on one stream, and two slots for the updated weights (bf16
    bits written by the step, or the float32 master slice copied in),
    whose copies to the card run on another.  The host step never waits
    for a copy other than the one of the piece it needs.  Counts the bytes
    each way and the host's time waiting for gradients, stepping and
    waiting for a free weight slot (:attr:`stats`)."""

    def __init__(self, grads: torch.Tensor, compute: torch.Tensor,
                 chunk: int = 1 << 24, slots: int = 3):
        self._grads = grads
        self._compute = compute
        self.chunk = int(chunk)
        self._g = [torch.empty(self.chunk, dtype=torch.float32,
                               pin_memory=True) for _ in range(slots)]
        self._o = [torch.empty(self.chunk, dtype=compute.dtype,
                               pin_memory=True) for _ in range(2)]
        self._g_ev = [torch.cuda.Event() for _ in self._g]
        self._o_ev = [None, None]
        self._d2h = torch.cuda.Stream(grads.device)
        self._h2d = torch.cuda.Stream(grads.device)
        self.stats = {}

    def begin(self, pieces):
        self._pieces = pieces
        self._i = 0
        self.stats = {"d2h_bytes": 0, "h2d_bytes": 0, "wait_grads_s": 0.0,
                      "host_step_s": 0.0, "wait_slot_s": 0.0}
        # the gradient is final on the compute stream
        self._d2h.wait_stream(torch.cuda.current_stream(self._grads.device))
        for k in range(min(len(self._g), len(pieces))):
            self._fetch(k)

    def _fetch(self, k):
        s, e = self._pieces[k]
        slot = k % len(self._g)
        with torch.cuda.stream(self._d2h):
            self._g[slot][:e - s].copy_(self._grads[s:e], non_blocking=True)
            self._g_ev[slot].record(self._d2h)
        self.stats["d2h_bytes"] += (e - s) * 4

    def grads(self, start, end):
        k = self._i
        if self._pieces[k] != (start, end):
            raise RuntimeError(f"ring piece {k} is {self._pieces[k]}, "
                               f"asked for {(start, end)}")
        t0 = time.perf_counter()
        self._g_ev[k % len(self._g)].synchronize()
        self._t_step = time.perf_counter()
        self.stats["wait_grads_s"] += self._t_step - t0
        return self._g[k % len(self._g)][:end - start]

    def _free_slot(self, j):
        if self._o_ev[j] is not None:
            t0 = time.perf_counter()
            self._o_ev[j].synchronize()
            self.stats["wait_slot_s"] += time.perf_counter() - t0

    def out16(self, start, end):
        if self._compute.dtype != torch.bfloat16:
            return None
        j = self._i % 2
        self._free_slot(j)
        return self._o[j][:end - start]

    def put(self, start, end, out):
        self.stats["host_step_s"] += time.perf_counter() - self._t_step
        k, j, n = self._i, self._i % 2, end - start
        src = self._o[j][:n]
        if self._compute.dtype != torch.bfloat16:
            self._free_slot(j)
            src.copy_(torch.from_numpy(out))
        with torch.cuda.stream(self._h2d):
            self._compute[start:end].copy_(src, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._h2d)
        self._o_ev[j] = ev
        self.stats["h2d_bytes"] += n * src.element_size()
        if k + len(self._g) < len(self._pieces):
            self._fetch(k + len(self._g))
        self._i += 1

    def finish(self):
        """Order the compute stream after every copy of the step."""
        cur = torch.cuda.current_stream(self._grads.device)
        cur.wait_stream(self._d2h)
        cur.wait_stream(self._h2d)


class HostOffloadOptimizer:
    """Flat host-side optimizer partition with an optional NVMe moment
    tier."""

    def __init__(self, init_leaves: Sequence[Leaf], optimizer_name: str,
                 optimizer_params: dict, device: str = "cpu",
                 nvme_path: Optional[str] = None,
                 sub_group_size: int = int(1e9), aio_threads: int = 8):
        self.shapes = [tuple(l.shape) for l in init_leaves]
        self.sizes = [int(np.prod(s)) if s else 1 for s in self.shapes]
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)]).astype(
            np.int64)
        self.total = int(self.offsets[-1])
        self.master = np.empty(self.total, np.float32)
        master_t = torch.from_numpy(self.master)
        for leaf, off, size in zip(init_leaves, self.offsets[:-1], self.sizes):
            # leaf by leaf: a device leaf crosses once, with no host copy
            # of the whole model besides the master
            master_t[off:off + size].copy_(_flat_host(leaf))

        self.opt, self._n_moments = _make_cpu_optimizer(optimizer_name,
                                                        optimizer_params)
        # count of *applied* updates: drives the host-side lr schedule
        self.applied_steps = 0
        self.device = device
        self.sub_group_size = max(int(sub_group_size), 1)
        self._nvme_dir = None
        self._aio: Optional[AsyncIOHandle] = None

        if device == "nvme":
            base = nvme_path or tempfile.gettempdir()
            self._nvme_dir = os.path.join(base,
                                          f"ds_tpu_swap_{uuid.uuid4().hex[:8]}")
            os.makedirs(self._nvme_dir, exist_ok=True)
            self._aio = AsyncIOHandle(aio_threads)
            # one handle per staging buffer so wait() is per-buffer: the
            # write-back of buffer A only joins when A is about to be reused,
            # overlapping it with the compute on buffer B
            self._stage_aio = [AsyncIOHandle(max(aio_threads // 2, 1))
                               for _ in range(2)]
            zeros = np.zeros(min(self.sub_group_size, self.total), np.float32)
            for name in self._moment_names():
                with open(self._moment_path(name), "wb") as f:
                    remaining = self.total
                    while remaining > 0:
                        n = min(remaining, zeros.size)
                        f.write(zeros[:n].tobytes())
                        remaining -= n
            nbuf = min(self.sub_group_size, self.total)
            self._stage = [
                {name: np.zeros(nbuf, np.float32)
                 for name in self._moment_names()} for _ in range(2)]
            logger.info(
                f"nvme offload: {self.total * 4 * self._n_moments / 1e6:.1f}MB "
                f"of moments at {self._nvme_dir}, "
                f"sub_group={self.sub_group_size}")
        else:
            self._moments = [np.zeros(self.total, np.float32)
                             for _ in range(self._n_moments)]

    # ------------------------------------------------------------------ utils
    def _moment_names(self) -> List[str]:
        return ["exp_avg", "exp_avg_sq"][:self._n_moments]

    def _moment_path(self, name: str) -> str:
        return os.path.join(self._nvme_dir, f"{name}.bin")

    def _groups(self):
        for start in range(0, self.total, self.sub_group_size):
            yield start, min(start + self.sub_group_size, self.total)

    def _opt_step(self, p, g, moments, lr, out16=None):
        if self._n_moments == 2:
            self.opt.step(p, g, moments[0], moments[1], lr=lr, out16=out16)
        else:
            self.opt.step(p, g, moments[0], lr=lr, out16=out16)

    def _moment_groups(self):
        """``(start, end, moment buffers)`` over the partition: the whole
        in-memory moments (``cpu``), or each ``sub_group_size`` group staged
        from the swap files (``nvme``: the read of the next group is in
        flight while the caller steps this one, whose write-back starts when
        the caller resumes the generator)."""
        if self.device != "nvme":
            yield 0, self.total, self._moments
            return
        groups = list(self._groups())
        names = self._moment_names()
        cur, nxt = 0, 1
        for name in names:
            self._stage_aio[cur].async_pread(
                self._stage[cur][name][:groups[0][1] - groups[0][0]],
                self._moment_path(name), groups[0][0] * 4)
        failures = 0
        for gi, (start, end) in enumerate(groups):
            n = end - start
            if gi + 1 < len(groups):
                # buffer `nxt` may still be writing back group gi-1: join
                # that first, then start prefetching group gi+1 into it
                failures += self._stage_aio[nxt].wait()
                s2, e2 = groups[gi + 1]
                for name in names:
                    self._stage_aio[nxt].async_pread(
                        self._stage[nxt][name][:e2 - s2],
                        self._moment_path(name), s2 * 4)
            failures += self._stage_aio[cur].wait()
            bufs = [self._stage[cur][name][:n] for name in names]
            yield start, end, bufs
            for name, buf in zip(names, bufs):
                self._stage_aio[cur].async_pwrite(buf, self._moment_path(name),
                                                  start * 4)
            cur, nxt = nxt, cur
        failures += self._stage_aio[0].wait() + self._stage_aio[1].wait()
        if failures:
            raise IOError(f"nvme swap: {failures} failed I/O ops in "
                          f"{self._nvme_dir}")

    # ------------------------------------------------------------------- step
    def step(self, grad_leaves: Sequence[Leaf],
             lr: Optional[float] = None) -> List[np.ndarray]:
        """Update the master partition in place; returns new param leaves
        (``offload.py:134``)."""
        flat_g = np.empty(self.total, np.float32)
        flat_t = torch.from_numpy(flat_g)
        for leaf, off, size in zip(grad_leaves, self.offsets[:-1], self.sizes):
            flat_t[off:off + size].copy_(_flat_host(leaf))
        self.step_stream(HostRing(flat_g), lr)
        return self.param_leaves()

    def pieces(self, chunk: Optional[int]) -> List[Tuple[int, int]]:
        """The ``[start, end)`` ranges :meth:`step_stream` steps, in order:
        each moment group cut into pieces of at most ``chunk`` elements."""
        bounds = ([(0, self.total)] if self.device != "nvme"
                  else list(self._groups()))
        out = []
        for start, end in bounds:
            step = chunk or (end - start)
            out.extend((s, min(s + step, end)) for s in range(start, end, step))
        return out

    def step_stream(self, ring, lr: Optional[float] = None) -> None:
        """One update of the whole partition, piece by piece.  ``ring``
        moves the data: ``ring.chunk`` (the largest piece, or None),
        ``ring.begin(pieces)`` before the first piece,
        ``ring.grads(start, end)`` the float32 host gradient of
        ``master[start:end]``, ``ring.out16(start, end)`` a buffer for the
        updated weights as bf16 bits (or None), and ``ring.put(start, end,
        out)`` after the piece is stepped, with that buffer or the master
        slice.  The same bits as one whole step."""
        pieces = self.pieces(ring.chunk)
        ring.begin(pieces)
        it = iter(pieces)
        count = getattr(self.opt, "step_count", None)
        for start, end, moments in self._moment_groups():
            while True:
                s, e = next(it)
                g = ring.grads(s, e)
                out16 = ring.out16(s, e)
                if count is not None:
                    # one update of the whole partition: every piece steps
                    # at the same count
                    self.opt.step_count = count
                self._opt_step(self.master[s:e], g,
                               [mm[s - start:e - start] for mm in moments],
                               lr, out16)
                ring.put(s, e, out16 if out16 is not None
                         else self.master[s:e])
                if e == end:
                    break
        self.applied_steps += 1

    def param_leaves(self) -> List[np.ndarray]:
        return [self.master[off:off + size].reshape(shape)
                for off, size, shape in zip(self.offsets[:-1], self.sizes,
                                            self.shapes)]

    # ------------------------------------------------------- clip / state_dict
    def global_grad_norm(self, grad_leaves: Sequence[Leaf]) -> float:
        return float(np.sqrt(sum(
            sq_norm(_flat_host(g).contiguous()) for g in grad_leaves)))

    def state_dict(self) -> dict:
        moments = {}
        if self.device == "nvme":
            for name in self._moment_names():
                buf = np.empty(self.total, np.float32)
                self._aio.async_pread(buf, self._moment_path(name), 0)
                if self._aio.wait():
                    raise IOError(
                        f"nvme swap: failed to read {name} moments from "
                        f"{self._nvme_dir} for checkpointing")
                moments[name] = buf
        else:
            for name, m in zip(self._moment_names(), self._moments):
                moments[name] = m
        return {"master": self.master,
                "step_count": getattr(self.opt, "step_count", 0),
                "applied_steps": self.applied_steps, **moments}

    def load_state_dict(self, sd: dict) -> None:
        self.master[:] = sd["master"]
        if hasattr(self.opt, "step_count"):
            self.opt.step_count = int(sd.get("step_count", 0))
        self.applied_steps = int(sd.get("applied_steps",
                                        sd.get("step_count", 0)))
        for i, name in enumerate(self._moment_names()):
            if name not in sd:
                continue
            if self.device == "nvme":
                buf = np.ascontiguousarray(sd[name], np.float32)
                self._aio.async_pwrite(buf, self._moment_path(name), 0)
                if self._aio.wait():
                    raise IOError(
                        f"nvme swap: failed to restore {name} moments into "
                        f"{self._nvme_dir} from checkpoint")
            else:
                self._moments[i][:] = sd[name]

    def close(self) -> None:
        if self._aio is not None:
            self._aio.close()
            for h in self._stage_aio:
                h.close()
            self._aio = None
        if self._nvme_dir and os.path.isdir(self._nvme_dir):
            shutil.rmtree(self._nvme_dir, ignore_errors=True)
