"""Continuous-batching serving over a block-paged KV cache with prefix reuse
and chunked prefill — the PyTorch port of
``deepspeed_tpu/inference/serving.py`` in its greedy chunked-prefill mode.

 - **Block-paged KV pool**: one ``[L, num_blocks, HKV, block_size, hd]``
   cache plus per-slot ``int32`` block tables mapping each sequence's
   logical block index (``position // block_size``) to a physical block.
   Blocks come from a refcounted free-list allocator
   (``inference/paged.py``); physical block 0 is reserved scratch — pad
   rows and inactive slots write their discarded KV there, so every device
   call keeps a fixed shape.  Decode attention walks the tables in a CUDA
   kernel (``ops/decode_attention.py``).
 - **Prefix cache**: a token trie over *full* blocks.  A request whose
   prompt shares a block-aligned prefix with an earlier prefilled sequence
   reuses those blocks with zero recompute — only the tail is prefilled.
   Reuse is capped below the full prompt and is full-block only, so shared
   blocks are read-only.  When the allocator runs dry, least-recently-used
   cache entries are evicted first; if that is not enough, the
   *latest-admitted* sequence is preempted — its blocks are freed and it
   re-enters the queue front with its generated tokens folded into the
   prompt (greedy decoding makes the recompute token-exact).
 - **Chunked prefill**: prompts advance through the cache in fixed windows
   of ``prefill_chunk`` tokens, ``prefill_batch`` sequences per call,
   interleaved with decode steps.  Windows of up to 16 tokens run the paged
   verify kernel; wider ones the gather-based plain path.
 - **Quantized serving** (``quantize=``): ``"kv8"`` stores the pool as int8
   records (codes plus a per-token bf16 scale table, ``ops/paged_kv.py``)
   read by the kv8 variants of the paged kernels; ``"w8a8"`` requires an
   engine whose blocks are w8a8 records (``init_serving`` builds one), so
   decode matmuls run the w8a8 kernels; ``"w8a8+kv8"`` both.

 - **Captured decode step**: on CUDA the decode step — embedding, every
   layer with its paged attention kernel, KV scatter and matmuls, the
   head and the token rule — is one ``torch.cuda.CUDAGraph`` per decode
   shape (slots x block-table width), captured at the second decode
   iteration (the first runs eagerly, so every kernel library, constant
   and counter the step uses exists before capture) and replayed after
   that: the host copies the step's operands into one static buffer,
   replays, and reads the ``[slots, K]`` tokens back once.  The pool is
   written in place, so the graph's input and output pool are the same
   tensors.  Graphs are bounded by an LRU (``utils/lru.py``) and counted
   in ``stats()["captured_graphs"]``, the port's ``compile_count``.  A
   capture runs under ``torch.cuda.set_sync_debug_mode("error")``, and a
   capture or replay that fails raises: there is no eager fallback.  On
   the CPU the same step runs eagerly.
 - **Fused decode** (``decode_steps=K``): one captured window of K decode
   steps with per-slot eos and budget checks on the device behind an
   ``active`` mask (the JAX ``fused_core`` while loop; a graph cannot exit
   early, so the window always runs K steps, frozen rows re-feeding their
   last token at a frozen length).  The host catches up once per window
   at the fence by replaying the K = 1 commit sequence.
 - **Sampling** (``sampling=True``, the JAX default): per-request
   ``temperature`` / ``top_k`` / ``top_p`` / ``seed`` ride as ``[slots]``
   operands of the same graph (``ops/sampling.py``), keyed by the
   request's seed and emitted-token index, so sampled streams replay token
   for token across preemption and across K; ``temperature=0`` rows are
   the argmax.

Scheduling is iteration-level: every :meth:`ServingEngine.step` admits
waiting requests into free slots (gated on block availability — the queue
head blocks admission, no starvation), advances every prefilling slot by one
chunk, then runs one decode step (or one fused window of K) over all slots
with per-sequence positions.  Greedy outputs are token-identical to
sequential ``generate``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops import decode_attention, quantized_matmul
from ..ops import sampling as sampling_ops
from ..ops.paged_kv import blocks_for, is_quantized_pool, quantize_pool
from ..ops.quantization import tree_leaves
from ..utils.logging import log_dist
from ..utils.lru import LRUCache
from .paged import BlockAllocator, PrefixCache


@dataclasses.dataclass
class Request:
    """One serving request: prompt token ids + a completion budget, plus
    the per-request sampling contract (``serving.py:346``).
    ``temperature=0`` (the default) is greedy and rides the same decode
    graph as sampled traffic; ``seed`` keys the counter-based PRNG
    (``ops/sampling.py``), so a sampled stream is a pure function of
    ``(prompt, params, seed)``.  ``mask_builder`` (constrained decoding)
    comes with the speculative-verify slice and must be ``None``."""
    uid: Any
    prompt: np.ndarray                      # int32 [prompt_len]
    max_new_tokens: int = 32
    temperature: float = 0.0                # 0 = greedy (the default row)
    top_k: int = 0                          # 0 = off
    top_p: float = 1.0                      # 1 = off
    seed: int = 0                           # counter-based PRNG root
    mask_builder: Optional[Any] = None      # constrained decoding: later

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError(f"request {self.uid!r}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.uid!r}: max_new_tokens must "
                             "be >= 1")
        if self.temperature < 0:
            raise ValueError(f"request {self.uid!r}: temperature must be "
                             f">= 0 (0 = greedy), got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"request {self.uid!r}: top_k must be >= 0 "
                             f"(0 = off), got {self.top_k}")
        if not 0 < self.top_p <= 1:
            raise ValueError(f"request {self.uid!r}: top_p must be in "
                             f"(0, 1] (1 = off), got {self.top_p}")
        # the PRNG root is stored as a uint32 at admission
        if not 0 <= self.seed < 2 ** 32:
            raise ValueError(f"request {self.uid!r}: seed must be in "
                             f"[0, 2**32), got {self.seed}")
        if self.mask_builder is not None:
            raise NotImplementedError(
                f"request {self.uid!r}: mask_builder (constrained decoding) "
                "is not ported yet — it comes with the PyTorch port's "
                "speculative-verify slice (ROADMAP.md Queue A item 3)")

    @property
    def sampled(self) -> bool:
        """True when this request draws from the sampler (any nonzero
        temperature)."""
        return self.temperature > 0


class RequestHandle:
    """Live view of one submitted request: per-token streaming and
    completion.  The engine appends committed tokens as the scheduler emits
    them; the caller reads ``tokens()``, a streaming cursor
    (``next_token``), or the final padded ``[prompt + completion]`` array
    (``result()``).  A preemption keeps the handle: already-streamed tokens
    stand (greedy resume recomputes the identical sequence).  Transitions
    run under one condition variable, so the handle may be read from
    another thread than the scheduler's."""

    def __init__(self, request: Request):
        self.request = request
        self.uid = request.uid
        self.status = "queued"          # -> "active" -> "finished"
        self._tokens: List[int] = []
        self._result: Optional[np.ndarray] = None
        self._cond = threading.Condition()
        self._cursor = 0

    def _on_active(self) -> None:
        with self._cond:
            self.status = "active"
            self._cond.notify_all()

    def _on_tokens(self, toks) -> None:
        with self._cond:
            self._tokens.extend(int(t) for t in toks)
            self._cond.notify_all()

    def _on_finish(self, result: np.ndarray) -> None:
        with self._cond:
            self._result = result
            self.status = "finished"
            self._cond.notify_all()

    @property
    def done(self) -> bool:
        return self.status == "finished"

    def tokens(self) -> List[int]:
        """Every token committed so far (a copy)."""
        with self._cond:
            return list(self._tokens)

    def next_token(self, timeout: Optional[float] = None) -> Optional[int]:
        """Streaming cursor: the next committed token, or ``None`` once the
        request is finished.  ``timeout=0`` polls (``None`` then also means
        "nothing new yet"); a positive ``timeout`` that expires with the
        request still live raises ``TimeoutError``; ``None`` blocks."""
        with self._cond:
            self._cond.wait_for(
                lambda: self._cursor < len(self._tokens) or self.done,
                timeout)
            if self._cursor < len(self._tokens):
                tok = self._tokens[self._cursor]
                self._cursor += 1
                return tok
            if self.done or not timeout:
                return None
            raise TimeoutError(
                f"request {self.uid!r} streamed nothing new within "
                f"{timeout}s (status {self.status})")

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until completion; the padded ``[prompt + completion]``
        array.  Raises ``TimeoutError`` if ``timeout`` expires first."""
        with self._cond:
            if not self._cond.wait_for(lambda: self.done, timeout):
                raise TimeoutError(
                    f"request {self.uid!r} still {self.status} after "
                    f"{timeout}s")
            return self._result


@dataclasses.dataclass
class _PendingItem:
    """One queued request plus its resume/streaming context."""
    req: Request
    prior: List[int]               # tokens generated before a preemption
    priority: int = 0
    eos: Optional[int] = None
    handle: Optional[RequestHandle] = None
    _order: tuple = (0, 0)         # (-priority, seq) — queue sort key


class _PendingQueue:
    """Priority-then-FIFO admission queue.  Items sort by ``(-priority,
    submit seq)``, except preemption resumes (``push_front``), which jump
    ahead of everything: the resumed sequence holds admission recency and
    the no-starvation gate reasons about the literal queue head."""

    def __init__(self):
        self._items: List[_PendingItem] = []
        self._seq = 0
        self._front = -1

    def push(self, item: _PendingItem) -> None:
        item._order = (-int(item.priority), self._seq)
        self._seq += 1
        i = len(self._items)
        while i > 0 and self._items[i - 1]._order > item._order:
            i -= 1
        self._items.insert(i, item)

    def push_front(self, item: _PendingItem) -> None:
        item._order = (-(1 << 30), self._front)
        self._front -= 1
        self._items.insert(0, item)

    def popleft(self) -> _PendingItem:
        return self._items.pop(0)

    def __len__(self) -> int:
        return len(self._items)

    def __bool__(self) -> bool:
        return bool(self._items)

    def __getitem__(self, i) -> _PendingItem:
        return self._items[i]


@dataclasses.dataclass
class _SlotState:
    req: Request
    admit_seq: int                 # admission recency (preemption victim order)
    prompt_eff: np.ndarray         # prompt (+ pre-preemption tokens on resume)
    prior: List[int]               # tokens generated before a preemption
    out: List[int] = dataclasses.field(default_factory=list)
    base: int = 0                  # tokens already in the paged cache
    phase: str = "prefill"         # "prefill" -> "decode"
    eos: Optional[int] = None
    handle: Optional[RequestHandle] = None

    @property
    def plen_eff(self) -> int:
        return int(self.prompt_eff.size)

    @property
    def gen_count(self) -> int:
        return len(self.prior) + len(self.out)


#: the decode step's [slots] int32 operands, in staging-buffer order (the
#: block tables follow them)
_OPERANDS = ("tokens", "lengths", "active", "budgets", "eos", "counts",
             "temps", "topks", "topps", "seeds")

#: an LRU entry for a decode shape that has run eagerly once, not captured
_WARMED = "warmed"


def _kernel_wrappers():
    """Every kernel wrapper a decode step may launch (launch bookkeeping)."""
    return decode_attention.KERNELS + quantized_matmul.KERNELS


class _CapturedStep:
    """One captured decode graph and the launches of each kernel wrapper
    it holds; a replay adds them, so ``fn.launches`` counts executions."""

    def __init__(self, graph, launches):
        self.graph = graph
        self.launches = launches

    def replay(self) -> None:
        self.graph.replay()
        for fn, n in self.launches:
            fn.launches += n


#: legal ``quantize=`` values (order-normalized; ``None`` = full precision)
_QUANT_MODES = ("kv8", "w8a8", "w8a8+kv8")


def _parse_quantize(quantize):
    """Normalize the ``quantize=`` knob -> ``(normalized str | None,
    kv_quant, want_w8a8)``; raises naming the legal values
    (``serving.py:249``)."""
    if quantize is None or quantize == "":
        return None, False, False
    parts = sorted(str(quantize).split("+"))
    if not set(parts) <= {"kv8", "w8a8"} or len(set(parts)) != len(parts):
        raise ValueError(
            f"quantize={quantize!r} — expected one of {_QUANT_MODES} "
            "(or None for full precision)")
    norm = "+".join(p for p in ("w8a8", "kv8") if p in parts)
    return norm, "kv8" in parts, "w8a8" in parts


def _percentile(samples, q: float) -> Optional[float]:
    return float(np.percentile(np.asarray(samples), q)) if samples else None


class ServingEngine:
    """Iteration-level (continuous-batching) scheduler over an
    :class:`~deepspeed_tpu_torch.inference.engine.InferenceEngine`'s
    KV-decode path, with a block-paged cache (module docstring).

    engine:         an ``init_inference`` engine whose model carries
                    ``decode_hooks`` with ``supports_lengths`` and
                    ``supports_paged``.
    slots:          max concurrently-active sequences.
    max_seq_len:    per-sequence budget (prompt + completion), at most the
                    model context length.
    block_size:     tokens per KV block (also the prefix-reuse granularity).
    num_blocks:     physical pool size incl. the scratch block.  Default
                    ``1 + slots * ceil(max_seq_len/block_size)`` (no
                    oversubscription); smaller pools rely on prefix eviction
                    and preemption.
    prefill_chunk:  chunk window length (at least 2: a width-1 window would
                    read as a decode step).
    prefill_batch:  sequences per prefill call; short groups pad with
                    scratch-routed rows.
    prefix_caching: enable the block trie.
    decode_steps:   K >= 1 decode steps per captured window (module
                    docstring); K = 1 is one step an iteration.
    sampling:       thread the per-request sampling operands through the
                    decode step and the prefill's first token; ``False``
                    keeps the argmax alone and refuses sampled requests.
    quantize:       ``None``, ``"kv8"``, ``"w8a8"`` or ``"w8a8+kv8"``
                    (module docstring).
    """

    def __init__(self, engine, *, slots: int = 8,
                 max_seq_len: Optional[int] = None,
                 prefill_batch: int = 4,
                 block_size: int = 32,
                 num_blocks: Optional[int] = None,
                 prefill_chunk: int = 128,
                 prefix_caching: bool = True,
                 decode_steps: int = 1,
                 sampling: bool = True,
                 quantize: Optional[str] = None):
        self._K = int(decode_steps)
        if self._K < 1:
            raise ValueError(
                f"decode_steps must be >= 1, got {decode_steps}")
        self.sampling = bool(sampling)
        self.quantize, self.kv_quant, want_w8a8 = _parse_quantize(quantize)
        qcfg = engine._config.quant
        self.weight_quant = qcfg.type if qcfg.enabled else None
        if want_w8a8 and self.weight_quant != "w8a8":
            raise ValueError(
                "quantize includes 'w8a8' but the wrapped engine carries "
                f"{self.weight_quant or 'full-precision'} weights — build "
                "it with config={'quant': {'enabled': True, 'type': "
                "'w8a8'}} (init_serving(quantize=...) does this for you)")
        hooks = getattr(engine.module, "decode_hooks", None) or {}
        if not (hooks.get("supports_lengths") and hooks.get("supports_paged")):
            raise ValueError(
                f"continuous batching needs decode_hooks with per-sequence "
                f"lengths and the paged cache; {engine.module.name} lacks them")
        if self.kv_quant and not hooks.get("supports_kv_quant"):
            raise ValueError(
                f"model {engine.module.name}'s decode hooks do not declare "
                "int8-KV support (supports_kv_quant) — a family qualifies "
                "when every pool read/write goes through ops/paged_kv "
                "(record-aware); set the flag after verifying that, or drop "
                "quantize='kv8'")
        self.engine = engine
        self.device = engine.device
        self._fwd = hooks["forward_cached"]
        max_ctx = hooks.get("max_seq_len")
        if max_seq_len is None:
            max_seq_len = max_ctx or 512
        if max_ctx is not None and max_seq_len > max_ctx:
            raise ValueError(
                f"max_seq_len {max_seq_len} exceeds the model context "
                f"length {max_ctx}")
        self.max_seq_len = int(max_seq_len)
        self.slots = int(slots)
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.block_size = int(block_size)
        self._cache_len = blocks_for(self.max_seq_len, block_size) * block_size
        self._nbper = self._cache_len // block_size      # block-table width
        # floor of 2: forward_cached reads T == 1 as per-row decode, so a
        # width-1 prefill window would be misread (serving.py:895-900)
        self.prefill_chunk = max(2, min(int(prefill_chunk), self._cache_len))
        self.prefill_batch = int(prefill_batch)
        if self.prefill_batch < 1:
            raise ValueError(
                f"prefill_batch must be >= 1, got {prefill_batch}")
        if num_blocks is None:
            num_blocks = 1 + self.slots * self._nbper
        if num_blocks < 1 + self._nbper:
            raise ValueError(
                f"num_blocks {num_blocks} cannot hold one full sequence "
                f"({self._nbper} blocks + 1 scratch)")
        self._alloc = BlockAllocator(num_blocks)
        self._prefix = PrefixCache(self.block_size) if prefix_caching else None
        if self.kv_quant:
            # int8 records built from the float pool's shapes alone (a
            # meta-device pool): no transient float + int8 double footprint
            self._cache = quantize_pool(
                hooks["init_cache"](num_blocks, self.block_size, engine.dtype,
                                    "meta"), device=self.device)
            self._kv_dtype = "int8"
        else:
            self._cache = hooks["init_cache"](num_blocks, self.block_size,
                                              engine.dtype, self.device)
            self._kv_dtype = str(engine.dtype).replace("torch.", "")
        # host-side block tables; entry 0 = scratch doubles as "unset"
        self._tables = np.zeros((self.slots, self._nbper), np.int32)
        self._held: List[List[int]] = [[] for _ in range(self.slots)]
        self._tokens = np.zeros(self.slots, np.int64)
        self._lengths = np.zeros(self.slots, np.int32)
        self._pending = _PendingQueue()
        self._active: Dict[int, _SlotState] = {}
        self._live_uids: set = set()
        self._admit_seq = 0
        self._blocked_gate = None          # (head id, resume len, version)
        self._admission_log: Optional[list] = None
        self._trace_times: Dict[Any, Dict[str, float]] = {}
        self._ttft: deque = deque(maxlen=4096)   # recent finished requests
        self._tpot: deque = deque(maxlen=4096)
        # per-slot sampling knobs, set at admission; idle rows keep the
        # greedy defaults (serving.py:1220-1223)
        self._temps = np.zeros(self.slots, np.float32)
        self._topks = np.zeros(self.slots, np.int32)
        self._topps = np.ones(self.slots, np.float32)
        self._seeds = np.zeros(self.slots, np.uint32)
        self._init_decode_buffers()
        #: captured decode graphs by decode shape (serving.py:1236-1241)
        self._graphs = LRUCache(capacity=4)
        self._eager_only = False
        self.counters = dict.fromkeys(
            ("iterations", "decode_steps", "prefill_calls", "admitted",
             "preempted", "finished", "prompt_tokens", "prefix_hit_tokens",
             "generated_tokens", "fused_iterations", "host_fence_waits",
             "captured_graphs", "sampled_requests"), 0)
        log_dist(
            f"ServingEngine: slots={self.slots}, cache_len={self._cache_len}, "
            f"block_size={self.block_size}, num_blocks={num_blocks}, chunked "
            f"prefill (chunk={self.prefill_chunk}, prefix_cache="
            f"{self._prefix is not None}), prefill_batch={self.prefill_batch}"
            f", quantize={self.quantize}, sampling={self.sampling}"
            + (f", fused decode K={self._K}" if self._K > 1 else ""),
            ranks=[0])

    @property
    def prefix_hit_tokens(self) -> int:
        return self.counters["prefix_hit_tokens"]

    @property
    def preempted(self) -> int:
        return self.counters["preempted"]

    # ------------------------------------------------------------- blocks
    def _release_slot(self, slot: int) -> None:
        for b in self._held[slot]:
            self._alloc.decref(b)
        self._held[slot] = []
        self._tables[slot] = 0
        self._tokens[slot] = 0
        self._lengths[slot] = 0
        # idle rows revert to the greedy defaults: their lanes still run
        # in every decode step (outputs discarded)
        self._temps[slot] = 0.0
        self._topks[slot] = 0
        self._topps[slot] = 1.0
        self._seeds[slot] = 0

    def _preempt(self, slot: int) -> None:
        """Evict a sequence under block pressure: free its blocks and
        re-queue it at the FRONT with generated tokens folded into the
        prompt (greedy => recompute is token-exact)."""
        st = self._active.pop(slot)
        self._release_slot(slot)
        self._pending.push_front(_PendingItem(
            req=st.req, prior=st.prior + st.out, eos=st.eos,
            handle=st.handle))
        self.counters["preempted"] += 1

    def _alloc_block(self, requester: int) -> Optional[int]:
        """One fresh block, reclaiming in order: free list -> LRU prefix-
        cache eviction -> preempting the latest-admitted sequence.  Returns
        ``None`` iff the requester itself was preempted."""
        while True:
            b = self._alloc.alloc()
            if b is not None:
                return b
            if self._prefix is not None and self._prefix.evict_one(self._alloc):
                continue
            victim = max(self._active, key=lambda s: self._active[s].admit_seq)
            if victim == requester and len(self._active) == 1:
                # cannot happen when num_blocks >= nbper + 1 (ctor check)
                raise RuntimeError(
                    "paged KV pool too small for a single sequence")
            self._preempt(victim)
            if victim == requester:
                return None

    def _ensure_blocks(self, slot: int, upto: int) -> bool:
        """Make the slot's table cover positions ``[0, upto)``; may preempt
        other slots (or the slot itself — returns False)."""
        for li in range(blocks_for(upto, self.block_size)):
            if slot not in self._active:
                return False
            if self._tables[slot, li] == 0:
                b = self._alloc_block(requester=slot)
                if b is None:
                    return False
                self._tables[slot, li] = b
                self._held[slot].append(b)
        return slot in self._active

    # --------------------------------------------------------------- schedule
    def _admit(self) -> None:
        """Head-of-queue-gated admission into free slots, gated on block
        availability (free + prefix-evictable) so an admitted sequence can
        always prefill its prompt; the queue head blocks admission when it
        does not fit — no starvation."""
        pending, active = self._pending, self._active
        free = [s for s in range(self.slots) if s not in active]
        reserved = 0                       # blocks promised to this call's
        while pending and free:            # earlier joiners, not yet alloc'd
            item = pending[0]
            req, prior = item.req, item.prior
            # blocked-head memo: while nothing refcount-related moved, the
            # gate's answer cannot change
            gate_key = (id(req), len(prior), self._alloc.version)
            if gate_key == self._blocked_gate:
                break
            prompt_eff = np.concatenate(
                [req.prompt, np.asarray(prior, np.int32)]) \
                if prior else req.prompt
            plen = int(prompt_eff.size)
            total_need = blocks_for(plen + 1, self.block_size)
            n_hit = self._prefix.probe(prompt_eff, plen - 1) \
                if self._prefix is not None else 0

            def _avail():
                return self._alloc.free_blocks - reserved + \
                    (self._prefix.evictable(self._alloc)
                     if self._prefix is not None else 0)

            if total_need - n_hit > _avail():
                self._blocked_gate = gate_key
                break
            hits: List[int] = []
            if self._prefix is not None:
                # cap below the full prompt: >= 1 tail token must prefill
                hits = self._prefix.lookup(prompt_eff, plen - 1, self._alloc)
            # re-check post-claim: claimed hit blocks no longer count as
            # evictable, so the probe gate can be optimistic by up to n_hit
            need = total_need - len(hits)
            if need > _avail():
                for b in hits:
                    self._alloc.decref(b)
                self._blocked_gate = (id(req), len(prior),
                                      self._alloc.version)
                break
            reserved += max(need, 0)
            pending.popleft()
            slot = free.pop(0)
            # a preemption resume keeps its original admission time
            self._trace_times.setdefault(
                req.uid, {"admit": time.perf_counter(), "first": None})
            self._tables[slot, :len(hits)] = hits
            self._held[slot] = list(hits)
            st = _SlotState(req=req, admit_seq=self._admit_seq,
                            prompt_eff=prompt_eff, prior=list(prior),
                            base=len(hits) * self.block_size,
                            eos=item.eos, handle=item.handle)
            self._admit_seq += 1
            active[slot] = st
            if self.sampling:
                self._temps[slot] = np.float32(req.temperature)
                self._topks[slot] = np.int32(req.top_k)
                self._topps[slot] = np.float32(req.top_p)
                self._seeds[slot] = np.uint32(req.seed)
            if st.handle is not None:
                st.handle._on_active()
            if self._admission_log is not None:
                self._admission_log.append((req.uid, slot))
            self.counters["admitted"] += 1
            self.counters["prompt_tokens"] += plen
            self.counters["prefix_hit_tokens"] += st.base

    # --------------------------------------------------- incremental serving
    def _validate_request(self, r: Request) -> None:
        total = len(r.prompt) + r.max_new_tokens
        if total > self.max_seq_len:
            raise ValueError(
                f"request {r.uid!r}: prompt ({len(r.prompt)}) + "
                f"max_new_tokens ({r.max_new_tokens}) = {total} exceeds "
                f"max_seq_len {self.max_seq_len}")
        if r.sampled and not self.sampling:
            raise ValueError(
                f"request {r.uid!r} asks for temperature="
                f"{r.temperature} but this engine was built with "
                "sampling=False (argmax only) — rebuild with sampling=True "
                "to serve sampled traffic")

    def submit(self, request: Request, *, priority: int = 0,
               eos_token_id: Optional[int] = None) -> RequestHandle:
        """Enqueue one request and return its :class:`RequestHandle`.
        Admission happens on subsequent :meth:`step` calls; higher
        ``priority`` admits first, FIFO within a priority."""
        self._validate_request(request)
        if request.uid in self._live_uids:
            raise ValueError(
                f"request uid {request.uid!r} is already in flight")
        if not self._pending and not self._active:
            self._blocked_gate = None      # object ids of an old trace
        handle = RequestHandle(request)
        self._pending.push(_PendingItem(
            req=request, prior=[], priority=priority, eos=eos_token_id,
            handle=handle))
        self.counters["sampled_requests"] += int(request.sampled)
        self._live_uids.add(request.uid)
        return handle

    @torch.no_grad()
    def step(self) -> bool:
        """ONE scheduler iteration: admit, advance prefills by one chunk,
        run one decode step.  Returns whether work remains."""
        if not self._pending and not self._active:
            return False
        params = self.engine.params
        self.counters["iterations"] += 1
        self._admit()
        self._run_prefill(params)
        if self._K > 1:
            self._run_fused_decode()
        else:
            self._run_plain_decode()
        return bool(self._pending or self._active)

    def serve(self, requests: Sequence[Request],
              eos_token_id: Optional[int] = None,
              admission_log: Optional[list] = None) -> Dict[Any, np.ndarray]:
        """Run a request trace to completion; returns ``uid -> [prompt +
        completion]`` int32 arrays, padded to ``prompt + max_new_tokens``
        with eos back-fill (HF semantics, same as ``generate``).
        ``admission_log``, when given, collects ``(uid, slot)`` in admission
        order."""
        requests = list(requests)
        if not requests:
            return {}
        if self._pending or self._active:
            raise RuntimeError(
                "serve() on a busy engine — requests are already in "
                "flight; drive submit()/step() instead")
        uids = [r.uid for r in requests]
        if len(set(uids)) != len(uids):
            raise ValueError("duplicate request uids")
        for r in requests:
            self._validate_request(r)
        handles = [self.submit(r, eos_token_id=eos_token_id)
                   for r in requests]
        self._admission_log = admission_log
        try:
            while self.step():
                pass
        finally:
            self._admission_log = None
        return {h.uid: h.result(timeout=0) for h in handles}

    # ----------------------------------------------------------------- decode
    def _emit(self, slot: int, st: _SlotState, tok: int) -> None:
        """Commit one generated token: stream it, stamp the first-token
        time, and finish the request on eos or budget."""
        st.out.append(tok)
        self.counters["generated_tokens"] += 1
        if st.handle is not None:
            st.handle._on_tokens((tok,))
        tm = self._trace_times.get(st.req.uid)
        if tm is not None and tm["first"] is None:
            tm["first"] = time.perf_counter()
        if (st.eos is not None and tok == st.eos) \
                or st.gen_count >= st.req.max_new_tokens:
            self._finish_slot(slot)
        else:
            self._tokens[slot] = tok

    def _finish_slot(self, slot: int) -> None:
        """Complete a request: build the padded ``[prompt + completion]``
        result (eos back-fill), record latencies, release the slot, resolve
        the handle."""
        st = self._active.pop(slot)
        req = st.req
        gen = np.asarray(st.prior + st.out, np.int32)
        eos_hit = st.eos is not None and gen.size and gen[-1] == st.eos
        out = np.zeros(req.max_new_tokens, np.int32)
        out[:gen.size] = gen
        if eos_hit:
            out[gen.size:] = st.eos
        tm = self._trace_times.pop(req.uid, None)
        if tm is not None and tm["first"] is not None:
            done = time.perf_counter()
            self._ttft.append(tm["first"] - tm["admit"])
            self._tpot.append((done - tm["first"]) / (gen.size - 1)
                              if gen.size > 1 else 0.0)
        self.counters["finished"] += 1
        self._release_slot(slot)
        self._live_uids.discard(req.uid)
        if st.handle is not None:
            st.handle._on_finish(np.concatenate([req.prompt, out]))

    def _to_device(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    # ------------------------------------------------------ decode operands
    def _init_decode_buffers(self) -> None:
        """The decode step's operands in ONE int32 buffer (float knobs and
        uint32 seeds as their bit patterns), staged on the host (pinned on
        CUDA) and copied to the device in one transfer a step; the step
        reads the device views, so a captured graph sees new values
        through fixed addresses.  ``_dev_out`` receives the ``[slots, K]``
        tokens (``-1`` past a slot's end)."""
        s, nbper = self.slots, self._nbper
        n = len(_OPERANDS) * s + s * nbper
        cuda = self.device.type == "cuda"
        self._host_ops = torch.zeros(n, dtype=torch.int32, pin_memory=cuda)
        self._dev_ops = torch.zeros(n, dtype=torch.int32,
                                    device=self.device) if cuda \
            else self._host_ops
        host = self._host_ops.numpy()
        self._op_np, self._op_dev = {}, {}
        for i, name in enumerate(_OPERANDS):
            self._op_np[name] = host[i * s:(i + 1) * s]
            self._op_dev[name] = self._dev_ops[i * s:(i + 1) * s]
        for name in ("temps", "topps"):
            self._op_np[name] = self._op_np[name].view(np.float32)
            self._op_dev[name] = self._op_dev[name].view(torch.float32)
        off = len(_OPERANDS) * s
        self._op_np["tables"] = host[off:].reshape(s, nbper)
        self._op_dev["tables"] = self._dev_ops[off:].view(s, nbper)
        self._dev_out = torch.full((s, self._K), -1, dtype=torch.int32,
                                   device=self.device)

    def _decode_counts(self) -> np.ndarray:
        """[slots] emitted counts for a decode dispatch (idle rows 0 —
        their greedy lane never touches the PRNG)."""
        counts = np.zeros(self.slots, np.int32)
        for slot, st in self._active.items():
            if st.phase == "decode":
                counts[slot] = st.gen_count
        return counts

    def _samp_rows(self, group, rows: int):
        """The ROW-gathered sampling operands of a prefill call (pad rows
        keep the greedy defaults): ``(temps, topks, topps, seeds,
        counts)`` device tensors from one host->device copy, or ``None``
        for a ``sampling=False`` engine (``serving.py:1861``)."""
        if not self.sampling:
            return None
        packed = np.zeros((5, rows), np.int32)
        temps, topps = packed[0].view(np.float32), packed[2].view(np.float32)
        topps[:] = 1.0
        for row, slot in enumerate(group):
            temps[row] = self._temps[slot]
            packed[1, row] = self._topks[slot]
            topps[row] = self._topps[slot]
            packed[3, row] = self._seeds[slot].view(np.int32)
            packed[4, row] = self._active[slot].gen_count
        dev = self._to_device(packed)
        return (dev[0].view(torch.float32), dev[1], dev[2].view(torch.float32),
                dev[3], dev[4])

    def _next_tokens(self, logits, samp) -> torch.Tensor:
        """The per-row token rule of every step (``serving.py:1809``):
        argmax for a ``sampling=False`` engine; otherwise a per-row
        ``where(temp > 0)`` between the sampler (counter-keyed by the
        row's seed and emitted count) and the same argmax, so one graph
        serves mixed greedy and sampled batches.  int32 ``[rows]``."""
        if samp is None:
            return logits.argmax(dim=-1).to(torch.int32)
        temps, topks, topps, seeds, counts = samp
        greedy, lp = sampling_ops.filtered_logprobs(logits, temps, topks,
                                                    topps)
        keys = sampling_ops.slot_keys(seeds, counts, sampling_ops.SALT_TOKEN)
        return torch.where(temps > 0, sampling_ops.sample_tokens(lp, keys),
                           greedy)

    # ------------------------------------------------- captured decode step
    def _decode_body(self) -> None:
        """The device work of one decode dispatch: K steps over every slot
        reading the static operand views, the pool written in place, the
        ``[slots, K]`` tokens into ``_dev_out`` (``fused_core``,
        ``serving.py:1927-1975``; K = 1 is ``step_core``).  Nothing here
        creates a device tensor from a host value or synchronises, so it
        runs eagerly and under CUDA-graph capture alike.  Rows with
        ``active == 0`` emit ``-1``; a row that stops (eos or budget)
        re-feeds its last token at a frozen length — an idempotent rewrite
        of its KV, or a write past its held span, which its table routes to
        the scratch block."""
        v = self._op_dev
        params = self.engine.params
        toks, lens, act = v["tokens"], v["lengths"], v["active"] != 0
        outs = []
        for i in range(self._K):
            logits, _ = self._fwd(params, toks.to(torch.int64)[:, None],
                                  self._cache, 0, lengths=lens,
                                  block_tables=v["tables"])
            samp = None if not self.sampling else (
                v["temps"], v["topks"], v["topps"], v["seeds"],
                v["counts"] + i)
            nxt = self._next_tokens(logits, samp)
            outs.append(torch.where(act, nxt, -1))
            if i + 1 < self._K:
                lens = lens + act.to(torch.int32)
                toks = torch.where(act, nxt, toks)
                act = act & (nxt != v["eos"]) & (v["budgets"] > i + 1)
        self._dev_out.copy_(torch.stack(outs, dim=1))

    def _capture(self) -> "_CapturedStep":
        """Capture :meth:`_decode_body` as a CUDA graph, under
        ``set_sync_debug_mode("error")`` so that a synchronisation in the
        step raises.  The kernel wrappers count their launches on the host
        while the body is captured; those counts are taken back (a capture
        executes nothing) and kept, and each replay adds them."""
        wrappers = _kernel_wrappers()
        before = [fn.launches for fn in wrappers]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    self._decode_body()
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
            held = tuple((fn, fn.launches - n)
                         for fn, n in zip(wrappers, before)
                         if fn.launches != n)
        finally:
            for fn, n in zip(wrappers, before):
                fn.launches = n
        self.counters["captured_graphs"] += 1
        return _CapturedStep(graph, held)

    def _run_decode_step(self) -> None:
        """Run :meth:`_decode_body` once: eagerly on the CPU; on CUDA
        eagerly at the first dispatch of a decode shape, then from the
        captured graph (captured at the second dispatch, replayed from
        then on)."""
        if self.device.type != "cuda" or self._eager_only:
            self._decode_body()
            return
        key = (self.slots, self._nbper, self._K, self.sampling)
        rec = self._graphs.get(key)
        if rec is None:
            self._decode_body()
            self._graphs.put(key, _WARMED)
            return
        if rec is _WARMED:
            rec = self._capture()
            self._graphs.put(key, rec)
        rec.replay()

    def _serve_eager(self, requests, eos_token_id=None):
        """:meth:`serve` with every decode step run eagerly, never from a
        graph: the reference the captured step is held against."""
        self._eager_only = True
        try:
            return self.serve(requests, eos_token_id=eos_token_id)
        finally:
            self._eager_only = False

    def _dispatch_decode(self, bt, active, budgets, eos_ids) -> np.ndarray:
        """Stage one decode dispatch's operands, run it, and read the
        ``[slots, K]`` int32 tokens back (the one host wait of the
        dispatch)."""
        o = self._op_np
        o["tokens"][:] = self._tokens
        o["lengths"][:] = self._lengths
        o["active"][:] = active
        o["budgets"][:] = budgets
        o["eos"][:] = eos_ids
        o["counts"][:] = self._decode_counts()
        o["temps"][:] = self._temps
        o["topks"][:] = self._topks
        o["topps"][:] = self._topps
        o["seeds"][:] = self._seeds.view(np.int32)
        o["tables"][:] = bt
        if self._dev_ops is not self._host_ops:
            self._dev_ops.copy_(self._host_ops, non_blocking=True)
        self._run_decode_step()
        return self._dev_out.cpu().numpy().copy()

    def _run_plain_decode(self) -> None:
        """One single-token decode step over every slot (``serving.py:
        3746-3782``); prefilling and empty slots point at the scratch
        block."""
        active = self._active
        for slot in sorted((s for s, st in active.items()
                            if st.phase == "decode"),
                           key=lambda s: active[s].admit_seq):
            if slot in active:
                self._ensure_blocks(slot, int(self._lengths[slot]) + 1)
        dec = sorted(s for s, st in active.items() if st.phase == "decode")
        if not dec:
            return
        bt = np.zeros_like(self._tables)
        bt[dec] = self._tables[dec]
        actv = np.zeros(self.slots, np.int32)
        actv[dec] = 1
        nxt = self._dispatch_decode(bt, actv, actv, -1)
        self.counters["decode_steps"] += 1
        for slot in dec:
            self._lengths[slot] += 1       # the fed token is now cached
            self._emit(slot, active[slot], int(nxt[slot, 0]))

    def _run_fused_decode(self) -> None:
        """``decode_steps`` decode iterations in one dispatch
        (``serving.py:3795-3887``): blocks are reserved for the whole
        window before it (``_ensure_blocks`` up to each slot's remaining
        budget, the device budget clamped to the held span), eos and budget
        checks run on the device, and the host catches up at the fence by
        replaying the committed ``out[slot, i]`` tokens through the K = 1
        commit sequence."""
        K = self._K
        active = self._active
        dec = sorted((s for s, st in active.items() if st.phase == "decode"),
                     key=lambda s: active[s].admit_seq)
        want: Dict[int, int] = {}
        for slot in dec:
            if slot in active and active[slot].phase == "decode":
                st = active[slot]
                ln = int(self._lengths[slot])
                w = max(1, min(K, st.req.max_new_tokens - st.gen_count))
                want[slot] = w
                self._ensure_blocks(slot, min(ln + w, self._cache_len))
        dec = sorted(s for s, st in active.items() if st.phase == "decode")
        budgets = np.zeros(self.slots, np.int32)
        eos_ids = np.full(self.slots, -1, np.int32)
        actv = np.zeros(self.slots, np.int32)
        for slot in dec:
            st = active[slot]
            ln = int(self._lengths[slot])
            # a window never writes past the blocks it reserved
            span = int(np.count_nonzero(self._tables[slot])) \
                * self.block_size
            b = min(want.get(slot, K), max(span - ln, 0))
            if b < 1:
                continue
            budgets[slot] = b
            actv[slot] = 1
            if st.eos is not None:
                eos_ids[slot] = int(st.eos)
        dec = [s for s in dec if actv[s]]
        if not dec:
            return
        bt = np.zeros_like(self._tables)
        bt[dec] = self._tables[dec]
        out = self._dispatch_decode(bt, actv, budgets, eos_ids)
        self.counters["host_fence_waits"] += 1
        trips = 0
        for slot in dec:
            st = active[slot]
            emitted = 0
            for i in range(K):
                tok = int(out[slot, i])
                if tok < 0:
                    break
                emitted += 1
                self._lengths[slot] += 1
                self._emit(slot, st, tok)
                if slot not in active:
                    break
            trips = max(trips, emitted)
        # decode_steps counts the deepest slot's emitted steps, as the JAX
        # while loop's trip count does
        self.counters["decode_steps"] += trips
        self.counters["fused_iterations"] += trips

    def _run_prefill(self, params) -> None:
        """Advance prefilling slots by one ``prefill_chunk`` window each,
        ``prefill_batch`` rows per call (pad rows write to scratch)."""
        active = self._active
        pre = [s for s, st in sorted(active.items(),
                                     key=lambda kv: kv[1].admit_seq)
               if st.phase == "prefill"]
        ready = []
        for slot in pre:
            if slot not in active:
                continue                   # preempted by an earlier alloc
            st = active[slot]
            v = min(self.prefill_chunk, st.plen_eff - st.base)
            if self._ensure_blocks(slot, st.base + v):
                ready.append(slot)
        for i in range(0, len(ready), self.prefill_batch):
            group = [s for s in ready[i:i + self.prefill_batch]
                     if s in active]
            if group:
                self._run_prefill_group(group, params)

    def _run_prefill_group(self, group, params) -> None:
        """One prefill call: each row advances its slot by ``min(chunk,
        remaining prompt)`` tokens from its own base; rows whose window
        reaches the last prompt token yield the slot's first generated
        token (logits gathered per row at ``valid - 1``)."""
        active = self._active
        j, width = self.prefill_batch, self.prefill_chunk
        ids = np.zeros((j, width), np.int64)
        bt = np.zeros((j, self._nbper), np.int32)
        base = np.zeros(j, np.int32)
        valid = np.zeros(j, np.int32)
        for row, slot in enumerate(group):
            st = active[slot]
            v = min(width, st.plen_eff - st.base)
            ids[row, :v] = st.prompt_eff[st.base:st.base + v]
            bt[row] = self._tables[slot]
            base[row] = st.base
            valid[row] = v
        samp = self._samp_rows(group, j)
        logits, self._cache = self._fwd(
            params, self._to_device(ids), self._cache, self._to_device(base),
            lengths=self._to_device(valid), block_tables=self._to_device(bt))
        first = self._next_tokens(logits, samp).cpu().numpy()
        self.counters["prefill_calls"] += 1
        for row, slot in enumerate(group):
            st = active[slot]
            st.base += int(valid[row])
            if st.base < st.plen_eff:
                continue                   # more chunks to go
            st.phase = "decode"
            if self._prefix is not None:
                # cache the prompt's FULL blocks (the trailing partial block
                # also holds generated tokens — never shared)
                nfull = st.plen_eff // self.block_size
                if nfull:
                    self._prefix.register(st.prompt_eff,
                                          self._tables[slot, :nfull],
                                          self._alloc)
            self._lengths[slot] = st.plen_eff
            self._emit(slot, st, int(first[row]))

    # ------------------------------------------------------------------ stats
    def stats(self) -> Dict[str, Any]:
        """Serving-loop counters: admissions, preemptions (``evicted``),
        decode steps (the deepest slot's steps of each fused window),
        fused iterations and host fences (``decode_steps > 1``), captured
        decode graphs, sampled requests and prefill calls, prefix-cache
        hit rate, block
        occupancy, TTFT/TPOT percentiles over recent finished requests, the
        KV pool's footprint (``kv_pool_bytes``: codes plus the scale table
        under ``kv8``) and quantization, and the launches of each
        decode-attention and int8-matmul kernel (process-wide executions:
        a replayed graph adds the launches it holds)."""
        c = self.counters
        pool_bytes = sum(t.numel() * t.element_size()
                         for t in tree_leaves(self._cache))
        scale_bytes = sum(leaf["ps"].numel() * leaf["ps"].element_size()
                          for leaf in self._cache.values()
                          if is_quantized_pool(leaf))
        st = {
            "iterations": c["iterations"],
            "decode_steps": c["decode_steps"],
            "fused_iterations": c["fused_iterations"],
            "host_fence_waits": c["host_fence_waits"],
            "captured_graphs": c["captured_graphs"],
            "sampling": self.sampling,
            "sampled_requests": c["sampled_requests"],
            "prefill_calls": c["prefill_calls"],
            "admitted": c["admitted"],
            "evicted": c["preempted"],
            "finished": c["finished"],
            "generated_tokens": c["generated_tokens"],
            "prompt_tokens": c["prompt_tokens"],
            "prefix_hit_tokens": c["prefix_hit_tokens"],
            "prefix_cache_hit_rate": (c["prefix_hit_tokens"] / c["prompt_tokens"]
                                      if c["prompt_tokens"] else 0.0),
            "prefix_cache_entries": len(self._prefix) if self._prefix else 0,
            "prefix_cache_evictions": self._prefix.evictions
            if self._prefix is not None else 0,
            "blocks_in_use": self._alloc.blocks_in_use,
            "free_blocks": self._alloc.free_blocks,
            "num_blocks": self._alloc.num_blocks,
            "block_size": self.block_size,
            "queue_depth": len(self._pending),
            "ttft_p50_s": _percentile(self._ttft, 50),
            "ttft_p95_s": _percentile(self._ttft, 95),
            "tpot_p50_s": _percentile(self._tpot, 50),
            "tpot_p95_s": _percentile(self._tpot, 95),
            "quantize": self.quantize,
            "kv_dtype": self._kv_dtype,
            "weight_quant": self.weight_quant,
            "kv_scale_bytes": scale_bytes,
            "kv_pool_bytes": pool_bytes,
        }
        for fn in decode_attention.KERNELS + quantized_matmul.KERNELS:
            st[f"{fn.__name__}_launches"] = fn.launches
        return st
