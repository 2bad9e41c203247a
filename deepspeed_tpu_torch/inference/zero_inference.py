"""ZeRO-Inference: serve a model bigger than the card's memory — the
PyTorch port of ``deepspeed_tpu/inference/zero_inference.py``.

The reference's ZeRO-Inference (zero stage 3 with ``offload_param: cpu``
driving inference-only forwards; OPT-30B on one GPU in ``BASELINE.md``)
keeps the weights in host memory and moves each layer's weights to the
GPU as its forward runs, amortising the traffic over a large batch.

Here, as in the JAX package, the stacked transformer blocks stay in host
memory (int8 records when ``quant`` is on, so ~1 byte a parameter crosses
the link) and stream through the card one layer at a time; the embedding,
the final norm and the head stay on the card, as do ``pin_layers``
leading layers and every layer's KV cache (allocated per layer, so no
``[L, ...]`` stack and no second copy of it exist).

How a layer reaches the card.  The host blocks are page-locked in place
(``cudaHostRegister`` over each stacked leaf: exactly their bytes; the
caching pinned allocator would round each leaf up to a power of two,
~1.6x OPT-30B's 59 GB), so a layer crosses in one DMA per leaf at the
link's rate with no host copy and no CPU thread in the way; a pageable
source plus a pinned staging ring would add a host memcpy as fast as the
link itself (39-52 GB/s against 51-55 GB/s on an H100 machine's host) on
the critical path.  Layers leave the card through :class:`HostStaging`.  A side copy stream fills a ring of ``prefetch + 1``
device slots, each shaped like one layer: the copy of layer ``i +
prefetch + 1`` waits (a CUDA event) for the layer that held its slot to
finish computing, and layer ``i``'s compute waits for its copy, so the
copy of the next layer overlaps the layer computing.  Every
``sync_every`` streamed layers the host waits on an event after the
layer's compute, which bounds the work in flight without reading a value
back.

Throughput model: a decode step moves every streamed layer's bytes over
the host link, so ``tokens/s ~= batch * link_GB_s / streamed_GB``; big
batches amortise it.  The reference's 43 tok/s for OPT-30B was measured
on a V100 over PCIe; no number from that source carries over.
"""

from __future__ import annotations

import time
import weakref
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..ops import sampling as sampling_ops
from ..utils.logging import log_dist

PyTree = Any


def _map(fn: Callable, tree: PyTree) -> PyTree:
    """``fn`` over the tensors of a nested dict (records included)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree: PyTree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def check_layers(blocks: PyTree, num_layers: int) -> None:
    """Raise unless the ``[L, ...]`` stacks hold ``num_layers`` layers."""
    held = _leaves(blocks)[0].shape[0]
    if held != num_layers:
        raise ValueError(f"stacked blocks carry {held} layers but "
                         f"num_layers={num_layers}")


def _split_layers(blocks: PyTree, num_layers: int) -> List[PyTree]:
    """``[L, ...]``-stacked host subtree -> per-layer subtrees (views)."""
    check_layers(blocks, num_layers)
    return [_map(lambda a, i=i: a[i], blocks) for i in range(num_layers)]


def _register(tensors: List[torch.Tensor]) -> List[int]:
    """Page-lock each host tensor's bytes in place (``cudaHostRegister``);
    returns the registered addresses."""
    cudart = torch.cuda.cudart()
    ptrs = []
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if not nbytes:
            continue
        err = int(cudart.cudaHostRegister(t.data_ptr(), nbytes, 0))
        if err:
            _unregister(ptrs)
            raise RuntimeError(f"cudaHostRegister of {nbytes} bytes failed "
                               f"with cudaError {err}")
        ptrs.append(t.data_ptr())
    return ptrs


def _unregister(ptrs: List[int], keep_alive=None) -> None:
    """Undo :func:`_register` (``keep_alive``: the tensors, referenced
    until their pages are unlocked)."""
    del keep_alive
    if not ptrs:
        return
    cudart = torch.cuda.cudart()
    for p in ptrs:
        cudart.cudaHostUnregister(p)
    ptrs.clear()


class HostStaging:
    """Page-locked host buffers shaped like one layer, reused for every
    layer that leaves the card: ``stage(layer)`` copies a device layer
    into them and returns host views, valid until the next call (the
    caller copies them into the host stacks first).  A copy into
    pageable memory runs at 6-8 GB/s on an H100 machine's host, into
    page-locked memory at the link's rate; the host copy that follows
    faults the stacks' pages in faster than ``cudaHostRegister`` does on
    memory never touched (OPT-30B: 24.7 s against 41.3 s, PERF.md)."""

    def __init__(self):
        self._bufs: Dict[tuple, torch.Tensor] = {}
        self._registered: List[int] = []

    def __call__(self, layer: PyTree, path=()) -> PyTree:
        if isinstance(layer, dict):
            return {k: self(v, path + (k,)) for k, v in layer.items()}
        buf = self._bufs.get(path)
        if buf is None:
            buf = torch.empty(tuple(layer.shape), dtype=layer.dtype)
            self._registered += _register([buf])
            self._bufs[path] = buf
        return buf.copy_(layer)

    def close(self) -> None:
        _unregister(self._registered)
        self._bufs.clear()


class StreamedGenerator:
    """Per-layer streamed prefill and decode over host-resident blocks.

    Built by :class:`~deepspeed_tpu_torch.inference.engine.InferenceEngine`
    when ``zero_inference.enabled``; the resident ``generate``'s semantics
    (greedy or sampled with the same token picker, ``fold_in(PRNGKey(seed),
    position)`` keys, eos fill), so the two paths give the same tokens at
    the same weights.  ``stream_hooks``: ``embed(params, ids, pos) -> x``,
    ``block(layer, x, ck, cv, pos) -> x`` (writes the layer's cache in
    place) and ``head(params, x_last) -> logits``."""

    def __init__(self, *, resident_params, host_blocks, num_layers: int,
                 stream_hooks: Dict[str, Any], init_cache, cache_dtype,
                 device, pin_layers: int = 0, prefetch: int = 1,
                 sync_every: int = 1, picker_factory=None):
        self.resident = resident_params
        self.num_layers = num_layers
        self.hooks = stream_hooks
        self._init_cache = init_cache
        self.cache_dtype = cache_dtype
        self.device = torch.device(device)
        self.prefetch = max(1, int(prefetch))
        self.sync_every = max(1, int(sync_every))
        self._picker_factory = picker_factory
        cuda = self.device.type == "cuda"
        # page-locked in place, unlocked when this object goes (the
        # finalizer holds the blocks until then)
        self._registered = _register(_leaves(host_blocks)) if cuda else []
        self._finalizer = weakref.finalize(
            self, _unregister, self._registered, _leaves(host_blocks))
        self.host_layers = _split_layers(host_blocks, num_layers)
        self.pin_layers = min(max(0, int(pin_layers)), num_layers)
        # the first pin_layers layers live on the card for good
        self._prefix = [_map(lambda a: a.to(self.device),
                             self.host_layers[i])
                        for i in range(self.pin_layers)]
        streamed = self.host_layers[self.pin_layers:]
        #: bytes that cross the host -> device link per full layer pass
        self.streamed_bytes = sum(
            t.numel() * t.element_size()
            for layer in streamed for t in _leaves(layer))
        # the device ring: prefetch + 1 slots shaped like one layer
        n_slots = min(self.prefetch + 1, len(streamed))
        self._slots = [_map(lambda a: torch.empty_like(a, device=self.device),
                            streamed[0]) for _ in range(n_slots)]
        del streamed
        self._ready: List[Optional[torch.cuda.Event]] = [None] * n_slots
        self._free: List[Optional[torch.cuda.Event]] = [None] * n_slots
        self._copy = torch.cuda.Stream(self.device) if cuda else None
        #: per-phase wall clock of the LAST completed generate
        self.last_timings = {"prefill_s": None, "decode_step_s": []}
        log_dist(
            f"zero-inference: {num_layers} layers, {self.pin_layers} "
            f"pinned, {self.streamed_bytes / 2**30:.2f} GiB streamed per "
            f"step, {n_slots} device slots", ranks=[0])

    def close(self) -> None:
        """Unlock the host blocks' pages now (also done when the generator
        is collected)."""
        self._finalizer()

    # ------------------------------------------------------------------ layers
    def _fetch(self, i: int) -> int:
        """Start the copy of streamed layer ``i`` into its slot; returns
        the slot."""
        j = (i - self.pin_layers) % len(self._slots)
        src, dst = _leaves(self.host_layers[i]), _leaves(self._slots[j])
        if self._copy is None:
            for d, s in zip(dst, src):
                d.copy_(s)
            return j
        with torch.cuda.stream(self._copy):
            if self._free[j] is not None:
                # the slot's last layer has finished computing
                self._copy.wait_event(self._free[j])
            for d, s in zip(dst, src):
                d.copy_(s, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._copy)
        self._ready[j] = ev
        return j

    def _layer_stream(self):
        """Device-resident per-layer weight trees, in order: the pinned
        prefix, then the streamed layers through the ring, ``prefetch``
        copies ahead of compute."""
        for i in range(self.pin_layers):
            yield self._prefix[i]
        window: List[int] = []
        nxt = self.pin_layers
        while nxt < self.num_layers or window:
            while nxt < self.num_layers and \
                    len(window) < len(self._slots):
                window.append(self._fetch(nxt))
                nxt += 1
            j = window.pop(0)
            if self._copy is not None:
                torch.cuda.current_stream(self.device).wait_event(
                    self._ready[j])
            yield self._slots[j]
            if self._copy is not None:
                # the layer's compute is queued: the slot frees after it
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(self.device))
                self._free[j] = ev

    def _sync(self) -> None:
        """Bound the work in flight: wait for the compute queued so far
        (an event, no value read back)."""
        if self._copy is None:
            return
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        ev.synchronize()

    def _run_layers(self, x, caches, pos: int):
        """One pass over all layers (prefill T = prompt or decode T = 1)."""
        block = self.hooks["block"]
        for i, layer in enumerate(self._layer_stream()):
            x = block(layer, x, caches[i][0], caches[i][1], pos)
            if (i + 1) % self.sync_every == 0 and i >= self.pin_layers:
                self._sync()
        return x

    def _make_caches(self, b: int, cache_len: int):
        """Per-layer device caches shaped as one layer of the model's
        stacked ``init_cache`` (read on the meta device, so the stack is
        never allocated)."""
        spec = self._init_cache(b, cache_len, self.cache_dtype, "meta")
        k, v = spec["k"], spec["v"]
        return [(torch.zeros(k.shape[1:], dtype=k.dtype, device=self.device),
                 torch.zeros(v.shape[1:], dtype=v.dtype, device=self.device))
                for _ in range(self.num_layers)]

    def _wait(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---------------------------------------------------------------- generate
    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0,
                 seed: Optional[int] = None):
        """The resident ``generate`` over streamed layers: int32 ``[B,
        prompt + max_new_tokens]`` with eos back-fill;
        :attr:`last_timings` holds the prefill's seconds and each decode
        step's."""
        from .engine import _auto_seed, _fill_after_eos

        input_ids = np.asarray(input_ids)
        b, prompt_len = input_ids.shape
        total = prompt_len + max_new_tokens
        pick = self._picker_factory((do_sample, float(temperature),
                                     int(top_k), float(top_p))
                                    if do_sample else None)
        rng = sampling_ops.PRNGKey(_auto_seed(self, seed), self.device)
        # reset before streaming, so a failure cannot leave a previous
        # run's timings looking current
        self.last_timings = {"prefill_s": None, "decode_step_s": []}
        if max_new_tokens <= 0:
            return np.array(input_ids, dtype=np.int32)
        cache_len = -(-total // 128) * 128
        caches = self._make_caches(b, cache_len)
        buf = torch.zeros((b, total), dtype=torch.int64, device=self.device)
        buf[:, :prompt_len] = torch.as_tensor(input_ids, device=self.device)
        embed, head = self.hooks["embed"], self.hooks["head"]

        t0 = time.perf_counter()
        x = embed(self.resident, buf[:, :prompt_len], 0)
        x = self._run_layers(x, caches, 0)
        nxt = pick(head(self.resident, x[:, -1]), rng, prompt_len)
        buf[:, prompt_len] = nxt
        done = nxt == eos_token_id if eos_token_id is not None else None
        self._wait()
        self.last_timings["prefill_s"] = time.perf_counter() - t0

        for pos in range(prompt_len, total - 1):
            if done is not None and bool(done.all()):
                break
            t0 = time.perf_counter()
            x = embed(self.resident, buf[:, pos:pos + 1], pos)
            x = self._run_layers(x, caches, pos)
            nxt = pick(head(self.resident, x[:, -1]), rng, pos + 1)
            buf[:, pos + 1] = nxt
            if done is not None:
                done |= nxt == eos_token_id
            self._wait()
            self.last_timings["decode_step_s"].append(
                time.perf_counter() - t0)
        out = buf.cpu().numpy().astype(np.int32)
        return _fill_after_eos(out, prompt_len, eos_token_id)
