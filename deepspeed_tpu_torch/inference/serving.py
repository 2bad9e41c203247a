"""Continuous-batching serving over a block-paged KV cache with prefix reuse
and chunked or bucketed prefill — the PyTorch port of
``deepspeed_tpu/inference/serving.py`` on one GPU (the host and NVMe KV
tiers, resident windows, disaggregated roles and the multi-GPU modes come
with their slices).

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
   verify kernel; wider ones the gather-based plain path.  **Bucketed
   prefill** (``chunked_prefill=False``, chosen when ``prompt_buckets`` is
   passed): a whole prompt in one window of its ladder rung
   (:func:`default_buckets`), grouped by rung, ``prefill_batch`` rows a
   call; no prefix reuse and no speculative decoding, as in the JAX
   package.
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
 - **Speculative decoding** (``spec_tokens=K``): each decode iteration is
   one round — a proposer guesses K tokens a slot (a draft model's
   captured K-step rollout into its own pool over the target's block
   tables, or the host's n-gram lookup, ``inference/spec.py``), one
   captured verify step scores the ``[pending, d_1..d_K]`` window of
   every slot through the paged verify kernel at T = K + 1, and the host
   commits the accepted prefix plus one target token: the argmax prefix
   match (token-exact with plain greedy decode) or, on a sampling engine,
   the delta-proposal rejection sampler (distribution-exact).
 - **Constrained decoding** (``logit_masks=True``): a ``[slots, vocab]``
   bool operand, rebuilt each iteration from each request's
   ``mask_builder`` (``inference/constrain.py``), gates every token rule
   — prefill's first token, the decode step and verify — before
   temperature, top-k and top-p.

Scheduling is iteration-level: every :meth:`ServingEngine.step` applies
deferred cancels, admits waiting requests into free slots in priority
order (gated on block availability — the queue head blocks admission, no
starvation), advances every prefilling slot by one chunk, then runs one
decode step (or one fused window of K) over all slots with per-sequence
positions (or one speculative round), and under ``debug_checks`` audits
the paged state (``analysis/invariants.py``).  Greedy outputs are
token-identical to sequential ``generate``.

**Control surface**: ``submit(request, priority=, slo_class=)`` returns a
:class:`RequestHandle` (streaming, ``result()``, ``cancel()``);
``cancel(uid)`` drops a queued request at once and releases an active slot
at the next iteration boundary (tokens already streamed stand);
``drain()`` preempts every active slot and hands back the whole queue,
generated tokens folded in, for re-submission; ``resolved_config()``
round-trips through ``init_serving``.

**Telemetry** (``telemetry/``, always on): every counter ``stats()``
reports and the TTFT/TPOT distributions live in a
:class:`~deepspeed_tpu_torch.telemetry.MetricsRegistry` (``metrics``); a
bounded ring of scheduler events (``trace_capacity``, 0 = off) exports as
Chrome trace JSON (``dump_trace``; ``telemetry/trace.py`` says which spans
end at a device sync); ``slo_report()`` and ``flops_report()`` are the
per-class attainment and FLOPs/MFU views; ``serve(profile_dir=)`` opens a
``torch.profiler`` window over its first ``profile_iters`` iterations.
The recompile sentry (``analysis/sentry.py``) counts each logical
program's builds against ``compile_budget``.
"""

from __future__ import annotations

import dataclasses
import inspect
import math
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..analysis.invariants import audit_serving_engine
from ..analysis.sentry import RecompileSentry, backend_compiles
from ..ops import decode_attention, quantized_matmul
from ..ops import sampling as sampling_ops
from ..ops.paged_kv import (blocks_for, is_quantized_pool, pool_payload,
                            quantize_pool)
from ..ops.quantization import tree_leaves
from ..telemetry import MetricsRegistry, ProfilerWindow, TraceTimeline
from ..telemetry.slo import SLOTracker
from ..utils.cuda_graphs import graph_capture
from ..utils.logging import log_dist
from ..utils.lru import LRUCache
from .paged import BlockAllocator, PrefixCache
from .spec import NGramProposer, greedy_accept, rejection_accept


def default_buckets(max_seq_len: int, lo: int = 32) -> Tuple[int, ...]:
    """Power-of-two prompt-bucket ladder ``[lo, .., max_seq_len]``
    (``serving.py:324``): ``lo`` above ``max_seq_len`` clamps to a single
    ``(max_seq_len,)`` bucket, a non-power-of-two ``max_seq_len`` gets
    exactly one tail entry, and ``lo < 1`` raises instead of looping
    forever."""
    if max_seq_len < 1:
        raise ValueError(f"max_seq_len must be >= 1, got {max_seq_len}")
    if lo < 1:
        raise ValueError(f"bucket floor lo must be >= 1, got {lo}")
    b = min(lo, max_seq_len)
    buckets = []
    while b < max_seq_len:
        buckets.append(b)
        b *= 2
    if not buckets or buckets[-1] != max_seq_len:
        buckets.append(max_seq_len)
    return tuple(buckets)


@dataclasses.dataclass
class Request:
    """One serving request: prompt token ids + a completion budget, plus
    the per-request sampling contract (``serving.py:346``).
    ``temperature=0`` (the default) is greedy and rides the same decode
    graph as sampled traffic; ``seed`` keys the counter-based PRNG
    (``ops/sampling.py``), so a sampled stream is a pure function of
    ``(prompt, params, seed)``.  ``mask_builder`` (a
    :class:`~deepspeed_tpu_torch.inference.constrain.LogitMaskBuilder`)
    opens the constrained-decoding lane; it needs an engine built with
    ``logit_masks=True``."""
    uid: Any
    prompt: np.ndarray                      # int32 [prompt_len]
    max_new_tokens: int = 32
    temperature: float = 0.0                # 0 = greedy (the default row)
    top_k: int = 0                          # 0 = off
    top_p: float = 1.0                      # 1 = off
    seed: int = 0                           # counter-based PRNG root
    mask_builder: Optional[Any] = None      # constrained-decoding hook

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

    @property
    def sampled(self) -> bool:
        """True when this request draws from the sampler (any nonzero
        temperature)."""
        return self.temperature > 0


#: ``slo_class`` -> default admission priority (``submit``): an SLO class
#: is a coarse priority band with a stable name — an explicit nonzero
#: ``priority=`` always wins over the class default (``serving.py:400``)
SLO_PRIORITY = {"realtime": 2, "interactive": 1, "standard": 0, "batch": -1,
                "giant_context": 0}


class RequestHandle:
    """Live view of one submitted request: per-token streaming, completion
    and cancellation.  The engine appends committed tokens as the
    scheduler emits them; the caller reads ``tokens()``, a streaming cursor
    (``next_token``), or the final padded ``[prompt + completion]`` array
    (``result()``, ``None`` if the request was cancelled).  A preemption
    keeps the handle: already-streamed tokens stand (greedy resume
    recomputes the identical sequence), and so does a drain handed back to
    ``_submit_item``.  Transitions run under one condition variable, so the
    handle may be read from another thread than the scheduler's."""

    def __init__(self, request: Request, *, priority: int = 0,
                 slo_class: Optional[str] = None, canceller=None):
        self.request = request
        self.uid = request.uid
        self.priority = int(priority)
        self.slo_class = slo_class
        # "queued" -> "active" -> "finished" | "cancelled"
        self.status = "queued"
        self._tokens: List[int] = []
        self._result: Optional[np.ndarray] = None
        self._cond = threading.Condition()
        self._cursor = 0
        self._canceller = canceller

    def _on_active(self) -> None:
        with self._cond:
            if self.status == "queued":
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

    def _on_cancel(self) -> None:
        with self._cond:
            self.status = "cancelled"
            self._cond.notify_all()

    def set_canceller(self, canceller) -> None:
        """Rebind the cancel route (a drain handoff), under the handle's
        condition: the stream may be read concurrently."""
        with self._cond:
            self._canceller = canceller

    @property
    def done(self) -> bool:
        return self.status in ("finished", "cancelled")

    def tokens(self) -> List[int]:
        """Every token committed so far (a copy)."""
        with self._cond:
            return list(self._tokens)

    def cancel(self) -> bool:
        """Cancel through the engine that owns the request now; ``False``
        if it already finished (``serving.py:511``)."""
        return bool(self._canceller and self._canceller(self.uid))

    def next_token(self, timeout: Optional[float] = None) -> Optional[int]:
        """Streaming cursor: the next committed token, or ``None`` once the
        request is finished or cancelled.  ``timeout=0`` polls (``None`` then also means
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

    def result(self, timeout: Optional[float] = None) -> Optional[np.ndarray]:
        """Block until completion; the padded ``[prompt + completion]``
        array, or ``None`` if cancelled.  Raises ``TimeoutError`` if
        ``timeout`` expires first."""
        with self._cond:
            if not self._cond.wait_for(lambda: self.done, timeout):
                raise TimeoutError(
                    f"request {self.uid!r} still {self.status} after "
                    f"{timeout}s")
            return self._result


@dataclasses.dataclass
class _PendingItem:
    """One queued request plus its resume/streaming context — what the
    pending queue holds and what ``drain()`` hands back."""
    req: Request
    prior: List[int]               # tokens generated before a preemption
    priority: int = 0
    slo_class: Optional[str] = None
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

    def remove(self, uid) -> Optional[_PendingItem]:
        for i, item in enumerate(self._items):
            if item.req.uid == uid:
                return self._items.pop(i)
        return None

    def drain(self) -> List[_PendingItem]:
        items, self._items = self._items, []
        return items

    def __len__(self) -> int:
        return len(self._items)

    def __bool__(self) -> bool:
        return bool(self._items)

    def __iter__(self):
        return iter(self._items)

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
    priority: int = 0
    slo_class: Optional[str] = None
    handle: Optional[RequestHandle] = None

    @property
    def plen_eff(self) -> int:
        return int(self.prompt_eff.size)

    @property
    def gen_count(self) -> int:
        return len(self.prior) + len(self.out)

    @property
    def pos_cap(self) -> int:
        """One past the highest cache position this request can ever
        commit: original prompt + completion budget.  Speculative windows
        reaching past it write to the scratch block instead of allocating
        blocks the request can never use (``serving.py:658``)."""
        return self.plen_eff - len(self.prior) + self.req.max_new_tokens


#: the device steps' [slots] int32 operands, in staging-buffer order (the
#: block tables, then the speculative window ``ids [slots, K+1]``, follow
#: them; the ``[slots, vocab]`` bool masks sit after the int32 words)
_OPERANDS = ("tokens", "lengths", "active", "budgets", "eos", "counts",
             "temps", "topks", "topps", "seeds", "valid")

#: rows of the speculative round's int32 output ``[5, slots, K+1]``: the
#: verify step's per-position argmax, accept verdicts (K used), plain
#: draws, residual draws (K used), and the window it scored
_SPEC_OUT = ("scored", "accept", "plain", "resid", "ids")

#: an LRU entry for a decode shape that has run eagerly once, not captured
_WARMED = "warmed"


def _validate_decode_hooks(module, *, speculative: bool = False,
                           kv_quant: bool = False, sampling: bool = False,
                           role: str = "model"):
    """Fail at construction, naming the missing hook, instead of deep
    inside the first prefill (``serving.py:263-320``): the hook dict and
    the ``forward_cached`` signature."""
    hooks = getattr(module, "decode_hooks", None)
    name = getattr(module, "name", "<model>")
    if not hooks:
        raise ValueError(
            f"continuous batching needs decode_hooks; {role} {name} has "
            "none")
    for key in ("init_cache", "forward_cached"):
        if key not in hooks:
            raise ValueError(
                f"{role} {name}: decode_hooks is missing the '{key}' hook")
    if not hooks.get("supports_lengths"):
        raise ValueError(
            f"{role} {name}'s decode hooks predate per-sequence lengths "
            "(supports_lengths) — update its forward_cached to the lengths "
            "contract first")
    if not hooks.get("supports_paged"):
        raise ValueError(
            f"{role} {name}'s decode hooks predate the block-paged cache "
            "(supports_paged) — thread block_tables through its "
            "forward_cached first")
    if speculative and not hooks.get("supports_verify"):
        raise ValueError(
            f"{role} {name}'s decode hooks lack the speculative verify "
            "head (supports_verify) — add all-position logits "
            "(all_positions=True) to its forward_cached first")
    if sampling and not hooks.get("supports_sampling"):
        raise ValueError(
            f"{role} {name}'s decode hooks do not declare sampling "
            "support (supports_sampling) — a family qualifies when its "
            "forward_cached returns full-vocab logits the on-device "
            "sampler can filter; set the flag after verifying that, or "
            "build the engine with sampling=False (greedy-only)")
    if kv_quant and not hooks.get("supports_kv_quant"):
        raise ValueError(
            f"{role} {name}'s decode hooks do not declare int8-KV support "
            "(supports_kv_quant) — a family qualifies when every pool "
            "read/write goes through ops/paged_kv (record-aware); set the "
            "flag after verifying that, or drop quantize='kv8'")
    try:
        sig = inspect.signature(hooks["forward_cached"])
    except (TypeError, ValueError):    # C callables carry no signature
        sig = None
    if sig is not None:
        need = ["lengths", "block_tables"] + \
            (["all_positions"] if speculative else [])
        missing = [kw for kw in need if kw not in sig.parameters]
        if missing:
            raise ValueError(
                f"{role} {name}: forward_cached does not accept the "
                f"{missing} keyword(s) its hook flags promise "
                f"(signature: forward_cached{sig})")
    return hooks


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


def _nbytes(pool) -> int:
    """Device bytes of a pool (codes plus scales for int8 records)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(pool))


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
    prompt_buckets: ascending prompt-length ladder (bucketed mode).
    block_size:     tokens per KV block (also the prefix-reuse granularity).
    num_blocks:     physical pool size incl. the scratch block.  Default
                    ``1 + slots * ceil(max_seq_len/block_size)`` (no
                    oversubscription); smaller pools rely on prefix eviction
                    and preemption.
    chunked_prefill: ``True`` = fixed-window chunked prefill; ``False`` =
                    the bucket ladder (no prefix reuse, no speculative
                    decoding).  ``None`` = bucketed iff ``prompt_buckets``
                    is passed.
    prefill_chunk:  chunk window length (chunked mode; at least 2: a
                    width-1 window would read as a decode step).
    prefill_batch:  sequences per prefill call (both modes); short groups
                    pad with scratch-routed rows.
    prefix_caching: enable the block trie (chunked mode only).
    decode_steps:   K >= 1 decode steps per captured window (module
                    docstring); K = 1 is one step an iteration.
    sampling:       thread the per-request sampling operands through the
                    decode step and the prefill's first token; ``False``
                    keeps the argmax alone and refuses sampled requests.
    quantize:       ``None``, ``"kv8"``, ``"w8a8"`` or ``"w8a8+kv8"``
                    (module docstring).
    spec_tokens:    speculative draft length K (0 = off; K + 1 <= the
                    verify kernel's ``VERIFY_T_MAX`` window; chunked mode
                    only).  Each decode iteration becomes one round:
                    propose K tokens a slot, score the ``[pending,
                    d_1..d_K]`` window in one captured verify step, commit
                    the accepted prefix plus one target token.
                    ``decode_steps`` is inert then.
    draft:          a draft model (``models.gpt2.build`` or
                    ``models.llama.build``, wrapped with this engine's
                    config on its device) or an ``InferenceEngine``
                    sharing the target's vocabulary; its pool shares the
                    target's block tables.  ``None`` drafts by n-gram
                    lookup over each request's own tokens.
    ngram_max / ngram_min: the n-gram proposer's longest / shortest match.
    spec_verifier:  ``"rejection"`` (distribution-exact; greedy rows are the
                    argmax prefix match) or ``"greedy"`` (``sampling=False``
                    engines only).
    logit_masks:    thread a ``[slots, vocab]`` bool mask through every
                    token rule, rebuilt each iteration from each request's
                    ``mask_builder`` (``inference/constrain.py``); needs
                    ``sampling=True``.
    debug_checks:   enforce the contracts (``analysis/``): the recompile
                    sentry raises on a build past ``compile_budget``, and
                    the paged-state audit runs after every scheduler
                    iteration.  Off: the sentry still counts
                    (``stats()['retraces_observed']``).
    trace_capacity: the trace timeline's ring size (``dump_trace``); 0
                    disables event recording (the registry behind
                    ``stats()`` stays on).
    slo_targets:    per-``slo_class`` latency targets and objectives,
                    merged over ``telemetry/slo.py``'s
                    ``DEFAULT_SLO_TARGETS``.
    peak_flops:     the MFU denominator of :meth:`flops_report`.
    """

    def __init__(self, engine, *, slots: int = 8,
                 max_seq_len: Optional[int] = None,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 prefill_batch: int = 4,
                 block_size: int = 32,
                 num_blocks: Optional[int] = None,
                 chunked_prefill: Optional[bool] = None,
                 prefill_chunk: int = 128,
                 prefix_caching: bool = True,
                 decode_steps: int = 1,
                 spec_tokens: int = 0,
                 quantize: Optional[str] = None,
                 draft=None,
                 ngram_max: int = 3,
                 ngram_min: int = 1,
                 sampling: bool = True,
                 spec_verifier: str = "rejection",
                 logit_masks: bool = False,
                 debug_checks: bool = False,
                 trace_capacity: int = 16384,
                 slo_targets: Optional[Dict[str, Dict[str, float]]] = None,
                 peak_flops: Optional[float] = None):
        # the JAX constructor's checks, in its order (serving.py:822-866)
        self.spec_tokens = int(spec_tokens)
        if self.spec_tokens < 0:
            raise ValueError(f"spec_tokens must be >= 0, got {spec_tokens}")
        vmax = decode_attention.VERIFY_T_MAX
        if self.spec_tokens and self.spec_tokens + 1 > vmax:
            raise ValueError(
                f"spec_tokens={spec_tokens} needs a {spec_tokens + 1}-token "
                f"verify window but the paged verify kernel takes at most "
                f"{vmax} — lower spec_tokens to {vmax - 1} or less")
        if draft is not None and not self.spec_tokens:
            raise ValueError(
                "a draft model was given but spec_tokens is 0 — pass "
                "spec_tokens=K to enable speculative decoding")
        self.sampling = bool(sampling)
        self.spec_verifier = str(spec_verifier)
        if self.spec_verifier not in ("rejection", "greedy"):
            raise ValueError(
                f"spec_verifier must be 'rejection' or 'greedy', got "
                f"{spec_verifier!r}")
        if self.spec_tokens and self.sampling and \
                self.spec_verifier == "greedy":
            raise ValueError(
                "speculative decoding on a sampling engine requires the "
                "rejection verifier (spec_verifier='rejection') — the "
                "greedy prefix-matcher would silently reshape sampled "
                "output distributions; pass sampling=False to keep the "
                "legacy greedy verifier")
        self.logit_masks = bool(logit_masks)
        if self.logit_masks and not self.sampling:
            raise ValueError(
                "logit_masks=True needs the sampling stack — constrained "
                "decoding applies the mask inside the sampler programs; "
                "drop sampling=False")
        self.quantize, self.kv_quant, want_w8a8 = _parse_quantize(quantize)
        qcfg = engine._config.quant
        self.weight_quant = qcfg.type if qcfg.enabled else None
        if want_w8a8 and self.weight_quant != "w8a8":
            raise ValueError(
                "quantize includes 'w8a8' but the wrapped engine carries "
                f"{self.weight_quant or 'full-precision'} weights — build "
                "it with config={'quant': {'enabled': True, 'type': "
                "'w8a8'}} (init_serving(quantize=...) does this for you)")
        hooks = _validate_decode_hooks(engine.module,
                                       speculative=bool(self.spec_tokens),
                                       kv_quant=self.kv_quant,
                                       sampling=self.sampling)
        self._K = int(decode_steps)
        if self._K < 1:
            raise ValueError(
                f"decode_steps must be >= 1, got {decode_steps}")
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
        # chunked unless the caller passed a ladder (serving.py:891-908)
        self.chunked_prefill = (prompt_buckets is None) \
            if chunked_prefill is None else bool(chunked_prefill)
        if self.chunked_prefill:
            self.prompt_buckets: Tuple[int, ...] = ()
            # floor of 2: forward_cached reads T == 1 as per-row decode,
            # so a width-1 prefill window would be misread
            self.prefill_chunk = max(2, min(int(prefill_chunk),
                                            self._cache_len))
        else:
            buckets = tuple(sorted(prompt_buckets)) if prompt_buckets \
                else default_buckets(self.max_seq_len)
            if any(b > self.max_seq_len for b in buckets):
                raise ValueError(
                    f"prompt bucket(s) {buckets} exceed max_seq_len "
                    f"{self.max_seq_len}")
            self.prompt_buckets = buckets
            self.prefill_chunk = 0
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
        self._prefix = PrefixCache(self.block_size) \
            if (prefix_caching and self.chunked_prefill) else None
        self._cache = self._init_pool(hooks, num_blocks, engine.dtype)
        self._kv_dtype = "int8" if self.kv_quant \
            else str(engine.dtype).replace("torch.", "")
        self._pool_shape = tuple(pool_payload(
            next(iter(self._cache.values()))).shape)
        #: blocks whose int8 scale rows are live (kv8): allocated and
        #: retired in lockstep with the blocks (the audit's scale-lockstep)
        self._kv_scale_live: set = set()
        # host-side block tables; entry 0 = scratch doubles as "unset"
        self._tables = np.zeros((self.slots, self._nbper), np.int32)
        self._held: List[List[int]] = [[] for _ in range(self.slots)]
        self._tokens = np.zeros(self.slots, np.int64)
        self._lengths = np.zeros(self.slots, np.int32)
        # per-slot sampling knobs, set at admission; idle rows keep the
        # greedy defaults (serving.py:1220-1223)
        self._temps = np.zeros(self.slots, np.float32)
        self._topks = np.zeros(self.slots, np.int32)
        self._topps = np.ones(self.slots, np.float32)
        self._seeds = np.zeros(self.slots, np.uint32)
        self._vocab = int(getattr(engine.module.model_config, "vocab_size",
                                  0) or 0)
        if self.logit_masks and not self._vocab:
            raise ValueError(
                "logit_masks=True needs the model config to expose "
                "vocab_size — the [slots, vocab] mask operand is sized "
                "from it")
        #: constrained decoding: per-slot bool logit mask (True = allowed)
        self._masks = np.ones((self.slots, self._vocab), bool) \
            if self.logit_masks else None

        # ----- the recompile sentry over the logical programs
        # (analysis/sentry.py): 2 chunked (1 prefill + 1 decode; the
        # n-gram verify replaces decode), 3 with a draft model, the ladder
        # + the cache-width preemption fallback + decode bucketed
        self.debug_checks = bool(debug_checks)
        if self.spec_tokens:
            self.compile_budget = 3 if draft is not None else 2
        elif self.chunked_prefill:
            self.compile_budget = 2
        else:
            self.compile_budget = len(self.prompt_buckets) + 2
        self.sentry = RecompileSentry(name="serving",
                                      strict=self.debug_checks,
                                      total_budget=self.compile_budget)
        #: one entry per logical program built (the compile probe)
        self.compiled_programs: List[Any] = []
        #: CUDA graphs captured (a decode, verify or draft step's build on
        #: CUDA; re-captures after an LRU drop included)
        self.captured_graphs = 0

        # ----- speculative decoding (serving.py:1292-1358)
        self._draft = None                 # draft InferenceEngine
        self._dcache = None                # draft paged pool (shares tables)
        self._proposer = None              # host-side n-gram proposer
        self.ngram_max = int(ngram_max)    # kept for resolved_config()
        self.ngram_min = int(ngram_min)
        if self.spec_tokens:
            if not self.chunked_prefill:
                raise ValueError(
                    "speculative decoding requires chunked-prefill mode — "
                    "drop prompt_buckets / pass chunked_prefill=True")
            if draft is not None:
                self._draft = self._wrap_draft(draft, num_blocks)
            else:
                self._proposer = NGramProposer(self.spec_tokens,
                                               max_n=ngram_max,
                                               min_n=ngram_min)
        self._init_decode_buffers()
        #: captured graphs by step and shape (serving.py:1236-1241)
        self._graphs = LRUCache(capacity=4)
        self._eager_only = False

        # ----- telemetry (telemetry/): every counter stats() reports is a
        # cell of this registry (serving.py:1407-1546; the host-tier, NVMe,
        # handoff, window and sp families come with their features)
        m = self.metrics = MetricsRegistry()
        self._c_iterations = m.counter(
            "serving_iterations_total", "scheduler iterations run")
        self._c_decode_steps = m.counter(
            "serving_decode_steps_total", "single-token decode steps")
        self._c_fused_iterations = m.counter(
            "serving_fused_iterations_total",
            "device-side decode iterations executed inside fused "
            "multi-step windows (0 when decode_steps == 1)")
        self._c_host_fence_waits = m.counter(
            "serving_host_fence_waits_total",
            "host blocks on the device fence — one per fused decode "
            "window, the ONLY sync of the fused decode path")
        self._c_prefill_calls = m.counter(
            "serving_prefill_calls_total", "prefill program invocations")
        self._c_admitted = m.counter(
            "serving_requests_admitted_total", "requests admitted to slots")
        self._c_preempted = m.counter(
            "serving_requests_preempted_total",
            "sequences preempted under block pressure")
        self._c_prompt_tokens = m.counter(
            "serving_prompt_tokens_total", "prompt tokens admitted")
        self._c_prefix_hit_tokens = m.counter(
            "serving_prefix_hit_tokens_total",
            "prompt tokens served from the prefix cache")
        self._c_spec_rounds = m.counter(
            "serving_spec_rounds_total", "speculative draft-verify rounds")
        self._c_drafted = m.counter(
            "serving_spec_drafted_tokens_total", "draft tokens proposed")
        self._c_accepted = m.counter(
            "serving_spec_accepted_tokens_total", "draft tokens accepted")
        self._c_spec_rejected = m.counter(
            "serving_spec_draft_rejected_total",
            "draft tokens the verifier rejected (rejection sampler or "
            "greedy mismatch)")
        self._c_sampled = {
            mode: m.counter("serving_sampled_requests_total",
                            "submitted requests by sampling mode",
                            mode=mode)
            for mode in ("greedy", "sampled", "constrained")}
        self._h_accept_ratio = m.histogram(
            "serving_spec_accept_ratio",
            buckets=(0.0, 0.25, 0.5, 0.75, 1.0),
            help="per-round fraction of drafted tokens accepted")
        self._c_finished = m.counter(
            "serving_requests_finished_total", "requests run to completion")
        self._c_cancelled = m.counter(
            "serving_requests_cancelled_total",
            "requests cancelled before completion (queued or active)")
        self._c_gen_tokens = m.counter(
            "serving_generated_tokens_total",
            "tokens committed across all requests (prefill first tokens, "
            "decode steps, accepted speculative drafts)")
        self._g_queue_depth = m.gauge(
            "serving_queue_depth", "requests waiting for a slot")
        self._c_invariant_checks = m.counter(
            "serving_invariant_checks_total",
            "paged-state audits run (analysis/invariants.py)")
        self._c_resume_recompute = m.counter(
            "serving_resume_recompute_tokens_total",
            "prompt tokens re-prefilled when admitting a preemption resume "
            "(near zero with the host tier: demoted state promotes back)")
        self._h_ttft = m.histogram(
            "serving_ttft_seconds", help="per-request time to first token")
        self._h_tpot = m.histogram(
            "serving_tpot_seconds",
            help="per-request time per output token (decode cadence)")
        self._g_blocks_in_use = m.gauge(
            "serving_blocks_in_use", "physical KV blocks referenced")
        self._g_free_blocks = m.gauge(
            "serving_free_blocks", "physical KV blocks on the free list")
        # SLO attainment accounting: every finished request lands in its
        # class's histograms and counters on THIS registry
        self._slo = SLOTracker(m, slo_targets)
        self.peak_flops = peak_flops
        self._flops_profiler = None        # built lazily by flops_report()
        #: prefill calls by window width (bucketed mode bills each rung)
        self._prefill_calls_by_width: Dict[int, int] = {}
        #: noted flow ids (uid -> Chrome flow id): admission emits the
        #: matching flow-finish (note_flow)
        self._flow_ids: Dict[Any, int] = {}
        self.timeline = TraceTimeline(capacity=trace_capacity)
        if self.timeline.enabled:
            # one span lane per SLOT: a request's span lands on the slot
            # that finished it — the lane count never grows with traffic
            for s in range(self.slots):
                self.timeline.thread(f"slot {s}")
        self.sentry.on_trace = self._emit_trace_event
        self._latencies = deque(maxlen=256)  # recent finished requests
        self._trace_times: Dict[Any, Dict[str, Any]] = {}
        self._admit_seq = 0
        self._blocked_gate = None          # (head id, resume len, version)
        self._pending = _PendingQueue()
        self._active: Dict[int, _SlotState] = {}
        self._live_uids: set = set()       # pending + active uids
        self._cancel_flags: set = set()    # active-slot cancels, applied at
        self._admission_log: Optional[list] = None  # the next boundary
        self._step_log: Optional[list] = None
        log_dist(
            f"ServingEngine: slots={self.slots}, cache_len={self._cache_len}, "
            f"block_size={self.block_size}, num_blocks={num_blocks}, "
            + (f"chunked prefill (chunk={self.prefill_chunk}, prefix_cache="
               f"{self._prefix is not None})" if self.chunked_prefill
               else f"bucketed prefill {self.prompt_buckets}")
            + f", prefill_batch={self.prefill_batch}"
            f", quantize={self.quantize}, sampling={self.sampling}"
            + (f", fused decode K={self._K}" if self._K > 1
               and not self.spec_tokens else "")
            + (f", speculative K={self.spec_tokens} ("
               + (f"draft {self._draft.module.name}" if self._draft
                  else "n-gram") + ")" if self.spec_tokens else "")
            + (", logit_masks" if self.logit_masks else ""),
            ranks=[0])

    def close(self) -> None:
        """Release host-side tier resources (``serving.py:1634``).
        Idempotent; a no-op until the port has an NVMe tier: the device pool
        and captured graphs are garbage-collected as usual."""

    def _init_pool(self, hooks, num_blocks: int, dtype):
        """A paged pool from a model's ``init_cache`` hook on this
        engine's device; under ``kv8`` int8 records built from the float
        pool's shapes alone (a meta-device pool), so there is no transient
        float + int8 double footprint."""
        if self.kv_quant:
            return quantize_pool(
                hooks["init_cache"](num_blocks, self.block_size, dtype,
                                    "meta"), device=self.device)
        return hooks["init_cache"](num_blocks, self.block_size, dtype,
                                   self.device)

    def _wrap_draft(self, draft, num_blocks: int):
        """The draft as an ``InferenceEngine`` on the target's device (a
        model is wrapped with the target engine's config, as
        ``serving.py:1307-1308`` does), validated, with its pool of the
        draft's own KV shapes over the target's block ids."""
        from .engine import InferenceEngine

        if not isinstance(draft, InferenceEngine):
            draft = InferenceEngine(draft, self.engine._config,
                                    device=self.device)
        if draft.device != self.device:
            raise ValueError(
                f"the draft engine lives on {draft.device} but the target "
                f"on {self.device} — build both on one device")
        dhooks = _validate_decode_hooks(draft.module, role="draft model",
                                        kv_quant=self.kv_quant,
                                        sampling=self.sampling)
        tv = getattr(self.engine.module.model_config, "vocab_size", None)
        dv = getattr(draft.module.model_config, "vocab_size", None)
        if tv is not None and dv is not None and tv != dv:
            raise ValueError(
                f"draft model vocab size {dv} != target vocab size {tv} — "
                "speculative decoding needs a shared tokenizer")
        self._dcache = self._init_pool(dhooks, num_blocks, draft.dtype)
        return draft

    # -------------------------------------------------------------- telemetry
    # counter attributes are read-only views over the registry cells
    @property
    def iterations(self) -> int:
        return int(self._c_iterations.value)

    @property
    def decode_steps(self) -> int:
        return int(self._c_decode_steps.value)

    @property
    def prefill_calls(self) -> int:
        return int(self._c_prefill_calls.value)

    @property
    def admitted(self) -> int:
        return int(self._c_admitted.value)

    @property
    def preempted(self) -> int:
        return int(self._c_preempted.value)

    @property
    def prompt_tokens(self) -> int:
        return int(self._c_prompt_tokens.value)

    @property
    def prefix_hit_tokens(self) -> int:
        return int(self._c_prefix_hit_tokens.value)

    @property
    def spec_rounds(self) -> int:
        return int(self._c_spec_rounds.value)

    @property
    def drafted_tokens(self) -> int:
        return int(self._c_drafted.value)

    @property
    def accepted_tokens(self) -> int:
        return int(self._c_accepted.value)

    @property
    def invariant_checks_run(self) -> int:
        return int(self._c_invariant_checks.value)

    @property
    def compile_count(self) -> int:
        return len(self.compiled_programs)

    def _emit_trace_event(self, entry) -> None:
        """Sentry build callback: every build of a logical program lands on
        the timeline — ``retrace`` past its budget (contract drift),
        ``program_build`` otherwise."""
        over = entry.budget is not None and entry.traces > entry.budget
        self.timeline.instant("retrace" if over else "program_build",
                              entry=entry.name, traces=entry.traces)

    def _note_build(self, entry: str, program: tuple) -> None:
        """One build of a logical program (``analysis/sentry.py``): the
        sentry counts it (and raises past the budget under
        ``debug_checks``); its first build enters ``compiled_programs``,
        as the JAX package lists each program it builds once."""
        if entry not in self.sentry.report():
            self.compiled_programs.append(program)
        self.sentry.record(entry, program)

    def dump_trace(self, path: str) -> str:
        """Write the per-request trace timeline as Chrome ``trace_event``
        JSON (open at https://ui.perfetto.dev); returns ``path``.  The
        ring holds the most recent ``trace_capacity`` events —
        ``stats()['trace_events_dropped']`` says how much history fell
        off."""
        return self.timeline.dump(
            path, process_name=f"serving:{self.engine.module.name}")

    def note_flow(self, uid, flow_id: int) -> None:
        """Register a Chrome flow id for a routed request: admission emits
        the matching flow-finish (``f``) event.  The caller owns flow-id
        uniqueness across every ring that will be merged."""
        self._flow_ids[uid] = int(flow_id)

    def slo_report(self) -> Dict[str, Dict[str, Any]]:
        """Per-``slo_class`` attainment report (``telemetry/slo.py``):
        requests, TTFT/TPOT attainment against the configured targets,
        percentiles, and error-budget burn rates."""
        return self._slo.report()

    def flops_report(self, peak_flops: Optional[float] = None,
                     window_s: Optional[float] = None) -> Dict[str, Any]:
        """FLOPs/MFU snapshot (``telemetry/flops.py``): per-program FLOPs
        (``FlopCounterMode`` on meta tensors, analytic fallback),
        cumulative ``serving_model_flops_total``, the MFU gauge against
        ``peak_flops`` (defaults to the constructor's), and the
        prefill/decode/swap/idle busy fractions from the timeline.  It
        builds no program and captures no graph."""
        if self._flops_profiler is None:
            from ..telemetry.flops import ServingFlopsProfiler

            self._flops_profiler = ServingFlopsProfiler(
                self, peak_flops=self.peak_flops)
        return self._flops_profiler.report(peak_flops=peak_flops,
                                           window_s=window_s)

    # ------------------------------------------------------------- blocks
    def _decref(self, b: int) -> None:
        """Release one reference; when the block frees, retire its scale-
        ledger entry in the same step (kv8)."""
        self._alloc.decref(b)
        if self._alloc.refcount(b) == 0:
            self._kv_scale_live.discard(b)

    def _release_slot(self, slot: int) -> None:
        for b in self._held[slot]:
            self._decref(b)
        self._held[slot] = []
        self._tables[slot] = 0
        self._tokens[slot] = 0
        self._lengths[slot] = 0
        # idle rows revert to the greedy, unmasked defaults: their lanes
        # still run in every decode step (outputs discarded)
        self._temps[slot] = 0.0
        self._topks[slot] = 0
        self._topps[slot] = 1.0
        self._seeds[slot] = 0
        if self._masks is not None:
            self._masks[slot, :] = True

    def _preempt(self, slot: int) -> None:
        """Evict a sequence under block pressure: free its blocks (the
        target's and, through the shared tables, the draft pool's) and
        re-queue it at the FRONT with generated tokens folded into the
        prompt (greedy => recompute is token-exact)."""
        st = self._active.pop(slot)
        nblocks = len(self._held[slot])
        self._release_slot(slot)
        self._pending.push_front(_PendingItem(
            req=st.req, prior=st.prior + st.out, priority=st.priority,
            slo_class=st.slo_class, eos=st.eos, handle=st.handle))
        self._c_preempted.inc()
        self.timeline.instant("preempt", uid=str(st.req.uid), slot=slot,
                              blocks_freed=nblocks)

    def _alloc_block(self, requester: int) -> Optional[int]:
        """One fresh block, reclaiming in order: free list -> LRU prefix-
        cache eviction -> preempting the latest-admitted sequence.  Returns
        ``None`` iff the requester itself was preempted."""
        while True:
            b = self._alloc.alloc()
            if b is not None:
                if self.kv_quant:
                    self._kv_scale_live.add(b)
                return b
            if self._prefix is not None:
                evicted = self._prefix.evict_one(self._alloc)
                if evicted:
                    self._kv_scale_live.discard(evicted)
                    self.timeline.instant("evict_block", block=int(evicted))
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
    def _bucket_for(self, prompt_len: int) -> int:
        for b in self.prompt_buckets:
            if prompt_len <= b:
                return b
        raise ValueError(
            f"prompt length {prompt_len} exceeds the largest bucket "
            f"{self.prompt_buckets[-1]}")

    def _prefill_width(self, prompt_len: int) -> int:
        """Prefill window for a prompt in bucketed mode: its ladder rung —
        or the full cache width for a preemption resume whose prompt (with
        generated tokens folded in) outgrew the ladder, instead of failing
        mid-trace (``serving.py:2981``).  Floor of 2 for the same T == 1
        reason as ``prefill_chunk``."""
        for b in self.prompt_buckets:
            if prompt_len <= b:
                return max(2, b)
        return self._cache_len

    def _admit(self) -> None:
        """Head-of-queue-gated admission into free slots (priority order),
        gated on block availability (free + prefix-evictable) so an
        admitted sequence can always prefill its prompt; the queue head
        blocks admission when it does not fit — no starvation."""
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
                    self._decref(b)
                self._blocked_gate = (id(req), len(prior),
                                      self._alloc.version)
                break
            reserved += max(need, 0)
            pending.popleft()
            slot = free.pop(0)
            # a preemption resume keeps its original admission time, so its
            # TTFT/TPOT and its timeline span cover the whole wait
            self._trace_times.setdefault(
                req.uid, {"admit": time.perf_counter(), "first": None,
                          "admit_us": self.timeline.now_us()})
            self._tables[slot, :len(hits)] = hits
            self._held[slot] = list(hits)
            st = _SlotState(req=req, admit_seq=self._admit_seq,
                            prompt_eff=prompt_eff, prior=list(prior),
                            base=len(hits) * self.block_size,
                            eos=item.eos, priority=item.priority,
                            slo_class=item.slo_class, handle=item.handle)
            self._admit_seq += 1
            active[slot] = st
            if self.sampling:
                self._temps[slot] = np.float32(req.temperature)
                self._topks[slot] = np.int32(req.top_k)
                self._topps[slot] = np.float32(req.top_p)
                self._seeds[slot] = np.uint32(req.seed)
                if self._masks is not None:
                    self._masks[slot, :] = True
            if st.handle is not None:
                st.handle._on_active()
            if self._admission_log is not None:
                self._admission_log.append((req.uid, slot))
            self._c_admitted.inc()
            self._c_prompt_tokens.inc(plen)
            self._c_prefix_hit_tokens.inc(st.base)
            if prior:
                # tokens a preemption resume re-prefills
                self._c_resume_recompute.inc(plen - st.base)
            # prefix_hit_tokens == 0 is the cache-miss record
            self.timeline.instant("admit", uid=str(req.uid), slot=slot,
                                  prompt_tokens=plen,
                                  prefix_hit_tokens=st.base,
                                  resumed=bool(prior))
            fid = self._flow_ids.pop(req.uid, None)
            if fid is not None:
                self.timeline.flow_end("route", fid, uid=str(req.uid),
                                       slot=slot)

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
        if r.mask_builder is not None and not self.logit_masks:
            raise ValueError(
                f"request {r.uid!r} carries a mask_builder but this "
                "engine was built without the constrained-decoding lane "
                "— pass logit_masks=True (the [slots, vocab] mask "
                "operand is only threaded through the programs then)")
        if not self.chunked_prefill:
            self._bucket_for(len(r.prompt))  # raises if no bucket fits

    def _session_boundary_reset(self) -> None:
        """First submit into an idle engine: object ids from the previous
        trace are stale."""
        if not self._pending and not self._active:
            self._blocked_gate = None

    def submit(self, request: Request, *, priority: int = 0,
               slo_class: Optional[str] = None,
               eos_token_id: Optional[int] = None) -> RequestHandle:
        """Enqueue one request and return its :class:`RequestHandle`
        (streaming, ``result()``, ``cancel()``).  Admission happens on
        subsequent :meth:`step` calls; higher ``priority`` admits first,
        FIFO within a priority; ``slo_class`` maps to a default priority
        through :data:`SLO_PRIORITY` when ``priority`` is 0 and names the
        class ``slo_report()`` accounts the request under."""
        self._validate_request(request)
        if request.uid in self._live_uids:
            raise ValueError(
                f"request uid {request.uid!r} is already in flight")
        self._session_boundary_reset()
        if priority == 0 and slo_class is not None:
            priority = SLO_PRIORITY.get(str(slo_class), 0)
        handle = RequestHandle(request, priority=priority,
                               slo_class=slo_class, canceller=self.cancel)
        self._pending.push(_PendingItem(
            req=request, prior=[], priority=priority, slo_class=slo_class,
            eos=eos_token_id, handle=handle))
        self._c_sampled["constrained" if request.mask_builder is not None
                        else "sampled" if request.sampled
                        else "greedy"].inc()
        self._live_uids.add(request.uid)
        self._g_queue_depth.set(len(self._pending))
        self.timeline.instant("submit", uid=str(request.uid),
                              priority=int(priority),
                              slo=str(slo_class) if slo_class else "")
        return handle

    def _submit_item(self, item: _PendingItem, canceller=None) -> None:
        """Enqueue a fully-formed pending item — a request :meth:`drain`
        handed back — keeping its handle, prior tokens, priority and eos,
        so streaming continues on the same handle (``serving.py:3209``).
        ``canceller`` is the cancel route to rebind (default: this
        engine's)."""
        self._validate_request(item.req)
        if item.req.uid in self._live_uids:
            raise ValueError(
                f"request uid {item.req.uid!r} is already in flight")
        self._session_boundary_reset()
        if item.handle is not None:
            item.handle.set_canceller(canceller or self.cancel)
        self._pending.push(item)
        self._live_uids.add(item.req.uid)
        self._g_queue_depth.set(len(self._pending))
        self.timeline.instant("submit", uid=str(item.req.uid),
                              priority=int(item.priority),
                              resumed=bool(item.prior))

    def _cancel_pending(self, uid) -> bool:
        item = self._pending.remove(uid)
        if item is None:
            return False
        self._live_uids.discard(uid)
        self._blocked_gate = None          # the head may have been this item
        self._trace_times.pop(uid, None)
        fid = self._flow_ids.pop(uid, None)
        if fid is not None:
            # never admitted: close the noted flow here
            self.timeline.flow_end("route", fid, uid=str(uid),
                                   cancelled=True)
        self._c_cancelled.inc()
        self._g_queue_depth.set(len(self._pending))
        self.timeline.instant("cancelled", uid=str(uid), queued=True)
        if item.handle is not None:
            item.handle._on_cancel()
        return True

    def cancel(self, uid) -> bool:
        """Cancel a live request (``serving.py:3259``).  Queued: dropped
        immediately.  Active: the slot and its blocks release at the NEXT
        scheduler-iteration boundary — the only point the paged-state
        invariants are guaranteed to hold — with a ``cancelled`` timeline
        event; tokens already streamed stand.  ``False`` when the uid is
        unknown or already finished."""
        if self._cancel_pending(uid):
            return True
        if any(st.req.uid == uid for st in self._active.values()):
            self._cancel_flags.add(uid)
            return True
        return False

    def _process_cancellations(self) -> None:
        """Apply deferred active-slot cancels at the iteration boundary:
        pop the slot, decref its blocks (prefix-shared blocks survive in
        the trie), and emit the ``cancelled`` event."""
        if not self._cancel_flags:
            return
        flags, self._cancel_flags = self._cancel_flags, set()
        for uid in flags:
            slot = next((s for s, st in self._active.items()
                         if st.req.uid == uid), None)
            if slot is None:
                # finished before the boundary, or preempted back to the
                # queue — the pending path handles the latter
                self._cancel_pending(uid)
                continue
            st = self._active.pop(slot)
            nblocks = len(self._held[slot])
            self._release_slot(slot)
            self._live_uids.discard(uid)
            self._trace_times.pop(uid, None)
            self._c_cancelled.inc()
            self.timeline.instant("cancelled", uid=str(uid), slot=slot,
                                  blocks_freed=nblocks)
            if st.handle is not None:
                st.handle._on_cancel()

    @torch.no_grad()
    def step(self) -> bool:
        """ONE scheduler iteration: apply cancellations, admit, advance
        prefills by one window, run one decode step (a draft-verify round
        in speculative mode), audit under ``debug_checks``.  Constrained
        slots' masks are rebuilt before each of the two dispatches: a slot
        that finishes prefill decodes in the same iteration, and its first
        token gates the second.  Returns whether work remains."""
        self._process_cancellations()
        if not self._pending and not self._active:
            self._g_queue_depth.set(0)
            return False
        params = self.engine.params
        self._c_iterations.inc()
        admitted0, preempted0 = self.admitted, self.preempted
        self._admit()
        self._refresh_masks()
        self._run_prefill(params)
        self._refresh_masks()
        if self.spec_tokens:
            self._run_spec_decode()
        elif self._K > 1:
            self._run_fused_decode()
        else:
            self._run_plain_decode()
        self._g_queue_depth.set(len(self._pending))
        if self._step_log is not None:
            self._step_log.append({
                "iteration": self.iterations,
                "admitted": self.admitted - admitted0,
                "evicted": self.preempted - preempted0,
                "blocks_in_use": self._alloc.blocks_in_use,
            })
        if self.debug_checks:
            # the scheduler's host state is only guaranteed consistent at
            # iteration boundaries (the audit drops its own event on the
            # timeline)
            audit_serving_engine(self, self._active)
            self._c_invariant_checks.inc()
        return bool(self._pending or self._active)

    def drain(self) -> List[_PendingItem]:
        """Quiesce this engine for a handoff (``serving.py:3368``):
        preempt every active slot (its generated tokens fold into the
        resume prompt) and hand back the whole pending queue, each item
        ready for :meth:`_submit_item` here or on another engine.  After a
        drain the pool holds only prefix-cache blocks."""
        self._process_cancellations()
        for slot in sorted(self._active,
                           key=lambda s: -self._active[s].admit_seq):
            self._preempt(slot)
        items = self._pending.drain()
        self._blocked_gate = None
        for item in items:
            # the latency span can only finish on the engine that admits
            # the resume; a still-noted flow id closes now
            self._trace_times.pop(item.req.uid, None)
            fid = self._flow_ids.pop(item.req.uid, None)
            if fid is not None:
                self.timeline.flow_end("route", fid,
                                       uid=str(item.req.uid),
                                       handoff=True)
            self._live_uids.discard(item.req.uid)
        self._g_queue_depth.set(0)
        self.timeline.instant("drain", handoff=len(items))
        return items

    def serve(self, requests: Sequence[Request],
              eos_token_id: Optional[int] = None,
              admission_log: Optional[list] = None,
              step_log: Optional[list] = None,
              debug_checks: Optional[bool] = None,
              profile_dir: Optional[str] = None,
              profile_iters: Optional[int] = None) -> Dict[Any, np.ndarray]:
        """Run a request trace to completion; returns ``uid -> [prompt +
        completion]`` int32 arrays, padded to ``prompt + max_new_tokens``
        with eos back-fill (HF semantics, same as ``generate``).  A thin
        wrapper over ``submit`` and ``step``.

        ``admission_log``, when given, collects ``(uid, slot)`` in admission
        order; ``step_log`` one dict per iteration (admitted / evicted /
        blocks_in_use).  ``debug_checks`` overrides the engine's flag from
        here on (per-iteration audits, a strict sentry).  ``profile_dir``
        opens a ``torch.profiler`` window (``telemetry/trace.py``
        :class:`ProfilerWindow`, CUDA activity on the card) over this
        call's first ``profile_iters`` scheduler iterations (``None`` = the
        whole call) and exports it as a Chrome trace into ``profile_dir``;
        the window's start and stop are timeline events."""
        if debug_checks is not None:
            self.debug_checks = bool(debug_checks)
            self.sentry.strict = self.debug_checks
        requests = list(requests)
        if not requests:
            return {}
        if self._pending or self._active:
            raise RuntimeError(
                "serve() on a busy engine — requests are already in "
                "flight; drive submit()/step() instead")
        for r in requests:
            self._validate_request(r)
        uids = [r.uid for r in requests]
        if len(set(uids)) != len(uids):
            raise ValueError("duplicate request uids")
        handles = [self.submit(r, eos_token_id=eos_token_id)
                   for r in requests]
        self._admission_log = admission_log
        self._step_log = step_log
        window = None
        if profile_dir is not None:
            window = ProfilerWindow(profile_dir,
                                    cuda=self.device.type == "cuda")
            if window.start():
                self.timeline.instant("profiler_start",
                                      profile_dir=str(profile_dir))
        iter0 = self.iterations
        try:
            while self.step():
                if window is not None and window.active and \
                        profile_iters is not None and \
                        self.iterations - iter0 >= profile_iters:
                    window.stop()
                    self.timeline.instant("profiler_stop")
        finally:
            self._admission_log = None
            self._step_log = None
            if window is not None and window.active:
                window.stop()
                self.timeline.instant("profiler_stop")
        return {h.uid: h.result(timeout=0) for h in handles}

    # ----------------------------------------------------------------- decode
    def _emit(self, slot: int, st: _SlotState, tok: int) -> None:
        """Commit one generated token: stream it, stamp the first-token
        time, and finish the request on eos or budget."""
        st.out.append(tok)
        self._c_gen_tokens.inc()
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
        result (eos back-fill), record its latencies, SLO class and span,
        release the slot, resolve the handle."""
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
            ttft = tm["first"] - tm["admit"]
            tpot = ((done - tm["first"]) / (gen.size - 1)) \
                if gen.size > 1 else 0.0
            self._c_finished.inc()
            self._h_ttft.observe(ttft)
            self._h_tpot.observe(tpot)
            # unclassified traffic lands in "standard"
            self._slo.observe(st.slo_class, ttft, tpot)
            self._latencies.append({"uid": req.uid,
                                    "new_tokens": int(gen.size),
                                    "ttft_s": ttft, "tpot_s": tpot})
            # the request's span on the finishing slot's lane: admission
            # (original — a preemption resume keeps it) to completion
            self.timeline.complete(
                f"req {req.uid}", tm["admit_us"], tid=slot + 1,
                uid=str(req.uid), new_tokens=int(gen.size),
                eos=bool(eos_hit), ttft_s=ttft)
        self._release_slot(slot)
        self._live_uids.discard(req.uid)
        if st.handle is not None:
            st.handle._on_finish(np.concatenate([req.prompt, out]))

    def _to_device(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    # ------------------------------------------------------ decode operands
    def _init_decode_buffers(self) -> None:
        """Every device step's operands in ONE buffer, staged on the host
        (pinned on CUDA) and copied to the device in one transfer a
        dispatch; the steps read the device views, so a captured graph
        sees new values through fixed addresses.  int32 words first:
        ``_OPERANDS`` (float knobs and uint32 seeds as their bit
        patterns), the block tables, and with ``spec_tokens`` the window
        ``ids [slots, K+1]``; then, with ``logit_masks``, the ``[slots,
        vocab]`` bool masks, one byte each.  ``_dev_out`` receives the
        decode step's ``[slots, K]`` tokens (``-1`` past a slot's end),
        ``_spec_out`` a speculative round's ``[5, slots, K+1]``
        (``_SPEC_OUT``)."""
        s, nbper = self.slots, self._nbper
        width = self.spec_tokens + 1 if self.spec_tokens else 0
        words = len(_OPERANDS) * s + s * nbper + s * width
        nbytes = 4 * words + (-(-s * self._vocab // 4) * 4
                              if self.logit_masks else 0)
        cuda = self.device.type == "cuda"
        self._host_ops = torch.zeros(nbytes, dtype=torch.uint8,
                                     pin_memory=cuda)
        self._dev_ops = torch.zeros(nbytes, dtype=torch.uint8,
                                    device=self.device) if cuda \
            else self._host_ops
        host = self._host_ops[:4 * words].view(torch.int32)
        dev = self._dev_ops[:4 * words].view(torch.int32)
        self._op_np, self._op_dev = {}, {}
        regions = [(name, i * s, (s,)) for i, name in enumerate(_OPERANDS)]
        off = len(_OPERANDS) * s
        regions.append(("tables", off, (s, nbper)))
        if width:
            regions.append(("ids", off + s * nbper, (s, width)))
        for name, start, shape in regions:
            n = math.prod(shape)
            self._op_np[name] = host[start:start + n].numpy().reshape(shape)
            self._op_dev[name] = dev[start:start + n].view(shape)
        for name in ("temps", "topps"):
            self._op_np[name] = self._op_np[name].view(np.float32)
            self._op_dev[name] = self._op_dev[name].view(torch.float32)
        if self.logit_masks:
            n = s * self._vocab
            self._op_np["masks"] = self._host_ops[4 * words:4 * words + n] \
                .numpy().view(bool).reshape(s, self._vocab)
            self._op_dev["masks"] = self._dev_ops[4 * words:4 * words + n] \
                .view(torch.bool).view(s, self._vocab)
        self._dev_out = torch.full((s, self._K), -1, dtype=torch.int32,
                                   device=self.device)
        self._spec_out = torch.zeros((len(_SPEC_OUT), s, width),
                                     dtype=torch.int32, device=self.device)

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
        keep the greedy, unmasked defaults): ``(temps, topks, topps,
        seeds, counts, masks)`` device tensors, ``masks`` ``None`` without
        ``logit_masks``, or ``None`` for a ``sampling=False`` engine
        (``serving.py:1861-1887``)."""
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
        masks = None
        if self.logit_masks:
            masks = np.ones((rows, self._vocab), bool)
            masks[:len(group)] = self._masks[list(group)]
            masks = self._to_device(masks)
        return (dev[0].view(torch.float32), dev[1], dev[2].view(torch.float32),
                dev[3], dev[4], masks)

    def _step_samp(self, offset: int = 0):
        """The slot-indexed sampling operands of a device step, read from
        the static operand views, emission counts advanced by ``offset``;
        ``None`` for a ``sampling=False`` engine."""
        if not self.sampling:
            return None
        v = self._op_dev
        return (v["temps"], v["topks"], v["topps"], v["seeds"],
                v["counts"] + offset, v.get("masks"))

    def _next_tokens(self, logits, samp,
                     salt: int = sampling_ops.SALT_TOKEN) -> torch.Tensor:
        """The per-row token rule of every step (``serving.py:1809``):
        argmax for a ``sampling=False`` engine; otherwise a per-row
        ``where(temp > 0)`` between the sampler (counter-keyed by the
        row's seed, emitted count and ``salt``) and the same masked
        argmax, so one graph serves mixed greedy, sampled and constrained
        batches.  int32 ``[rows]``."""
        if samp is None:
            return logits.argmax(dim=-1).to(torch.int32)
        temps, topks, topps, seeds, counts, masks = samp
        greedy, lp = sampling_ops.filtered_logprobs(logits, temps, topks,
                                                    topps, masks)
        keys = sampling_ops.slot_keys(seeds, counts, salt)
        return torch.where(temps > 0, sampling_ops.sample_tokens(lp, keys),
                           greedy)

    # ------------------------------------------------- captured device steps
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
            nxt = self._next_tokens(logits, self._step_samp(i))
            outs.append(torch.where(act, nxt, -1))
            if i + 1 < self._K:
                lens = lens + act.to(torch.int32)
                toks = torch.where(act, nxt, toks)
                act = act & (nxt != v["eos"]) & (v["budgets"] > i + 1)
        self._dev_out.copy_(torch.stack(outs, dim=1))

    def _draft_body(self) -> None:
        """The draft rollout (``propose``, ``serving.py:2203-2230``): K
        single-token steps of the draft model from each slot's pending
        token at its committed length, through the target's block tables
        into the draft pool; sampled rows draw from the draft's own
        filtered distribution with ``SALT_DRAFT`` keys (no masks: drafts
        of constrained slots are never accepted).  The drafts land in the
        window operand ``ids[:, 1:]`` the verify step reads (0 in rows with
        no window, as the host stages them for the n-gram proposer)."""
        v = self._op_dev
        dfwd = self._draft.module.decode_hooks["forward_cached"]
        dparams = self._draft.params
        toks, lens = v["tokens"], v["lengths"]
        drafts = []
        for i in range(self.spec_tokens):
            logits, _ = dfwd(dparams, toks.to(torch.int64)[:, None],
                             self._dcache, 0, lengths=lens,
                             block_tables=v["tables"])
            samp = self._step_samp(i)
            if samp is not None:
                samp = samp[:5] + (None,)
            toks = self._next_tokens(logits, samp, sampling_ops.SALT_DRAFT)
            drafts.append(toks)
            lens = lens + 1
        v["ids"][:, 1:].copy_(torch.where(v["valid"][:, None] > 0,
                                          torch.stack(drafts, dim=1), 0))

    def _verify_body(self) -> None:
        """The verify step (``verify``, ``serving.py:2109-2177``): one
        paged forward of every slot's ``[pending, d_1..d_K]`` window at its
        committed length (``valid`` tokens of it; 0 routes a row's writes
        to scratch) through the paged verify kernel at T = K + 1, scoring
        every position (``all_positions``: the model multiplies one
        window position at a time, so each position's logits are the
        decode step's bits and greedy spec serving is token-exact with
        plain serving in every dtype, where the JAX verify multiplies all
        ``slots * (K+1)`` rows at once).  Writes ``_spec_out``: the
        per-position (masked) argmax, and on a sampling engine the
        rejection sampler's accept verdicts and its two tail lanes — the
        plain draw (a cap or bonus stop) and the residual draw (a
        rejection stop), both on the ``SALT_RESIDUAL`` keys of their
        emission index; the host walker picks one by stop reason.
        Temperature-0 rows are the greedy prefix match bit for bit."""
        v = self._op_dev
        ids = v["ids"]
        k = self.spec_tokens
        rows, width = ids.shape
        out = self._spec_out
        logits, _ = self._fwd(self.engine.params, ids.to(torch.int64),
                              self._cache, v["lengths"], lengths=v["valid"],
                              block_tables=v["tables"], all_positions=True)
        out[4].copy_(ids)
        if not self.sampling:
            out[0].copy_(logits.argmax(dim=-1))
            return
        temps, topks, topps, seeds, counts, masks = self._step_samp()
        vocab = logits.shape[-1]

        def rep(x):
            return x[:, None].expand(rows, width).reshape(-1)

        mrep = None if masks is None else \
            masks[:, None].expand(rows, width, vocab).reshape(-1, vocab)
        greedy, lp = sampling_ops.filtered_logprobs(
            logits.reshape(-1, vocab), rep(temps), rep(topks), rep(topps),
            mrep)
        scored = greedy.reshape(rows, width)
        lp = lp.reshape(rows, width, vocab)
        # position i decides emission counts + i
        pos = lp[:, :-1].reshape(-1, vocab)
        drafts = ids[:, 1:].reshape(-1)
        p_d = sampling_ops.token_probs(pos, drafts).reshape(rows, k)
        u = sampling_ops.accept_uniforms(sampling_ops.grid_keys(
            seeds, counts, sampling_ops.SALT_ACCEPT, k))
        fkeys = sampling_ops.grid_keys(seeds, counts,
                                       sampling_ops.SALT_RESIDUAL, width)
        plain = sampling_ops.sample_tokens(lp.reshape(-1, vocab),
                                           fkeys.reshape(-1, 2))
        rkeys = sampling_ops.grid_keys(seeds, counts,
                                       sampling_ops.SALT_RESIDUAL, k)
        resid = sampling_ops.sample_tokens(
            sampling_ops.residual_logits(pos, drafts), rkeys.reshape(-1, 2))
        hot = temps[:, None] > 0
        out[0].copy_(scored)
        out[1, :, :k].copy_(u < p_d)
        out[2].copy_(torch.where(hot, plain.reshape(rows, width), scored))
        out[3, :, :k].copy_(torch.where(hot, resid.reshape(rows, k),
                                        scored[:, :k]))

    def _capture(self, body) -> "_CapturedStep":
        """Capture ``body`` as a CUDA graph, under
        ``set_sync_debug_mode("error")`` so that a synchronisation in the
        step raises, and with automatic garbage collection paused, so that
        no collection frees another graph inside the capture
        (``utils/cuda_graphs.py``).  The kernel wrappers count their
        launches on the host while the body is captured; those counts are
        taken back (a capture executes nothing) and kept, and each replay
        adds them."""
        wrappers = _kernel_wrappers()
        before = [fn.launches for fn in wrappers]
        graph = torch.cuda.CUDAGraph()
        try:
            with graph_capture(graph):
                mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    body()
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
            held = tuple((fn, fn.launches - n)
                         for fn, n in zip(wrappers, before)
                         if fn.launches != n)
        finally:
            for fn, n in zip(wrappers, before):
                fn.launches = n
        self.captured_graphs += 1
        return _CapturedStep(graph, held)

    def _run_step(self, key, body, program: tuple) -> None:
        """Run one device step ``body``: eagerly on the CPU; on CUDA
        eagerly at the first dispatch of its ``key`` (step and shape), then
        from the captured graph (captured at the second dispatch, replayed
        from then on).  ``program`` is the step's logical program
        (``compiled_programs``): built at the capture on CUDA, at the first
        call on the CPU (``analysis/sentry.py``)."""
        rec = self._graphs.get(key)
        if self.device.type != "cuda" or self._eager_only:
            if rec is None and not self._eager_only:
                self._note_build(program[0], program)
                self._graphs.put(key, _WARMED)
            body()
            return
        if rec is None:
            body()
            self._graphs.put(key, _WARMED)
            return
        if rec is _WARMED:
            self._note_build(program[0], program)
            rec = self._capture(body)
            self._graphs.put(key, rec)
        rec.replay()

    def _serve_eager(self, requests, eos_token_id=None):
        """:meth:`serve` with every device step run eagerly, never from a
        graph: the reference the captured steps are held against."""
        self._eager_only = True
        try:
            return self.serve(requests, eos_token_id=eos_token_id)
        finally:
            self._eager_only = False

    def _stage(self, bt, counts) -> None:
        """Write the operands every step reads into the host staging
        buffer: pending tokens, committed lengths, emission counts, the
        sampling knobs, the masks and the block tables ``bt``."""
        o = self._op_np
        o["tokens"][:] = self._tokens
        o["lengths"][:] = self._lengths
        o["counts"][:] = counts
        o["temps"][:] = self._temps
        o["topks"][:] = self._topks
        o["topps"][:] = self._topps
        o["seeds"][:] = self._seeds.view(np.int32)
        o["tables"][:] = bt
        if self._masks is not None:
            o["masks"][:] = self._masks

    def _upload(self) -> None:
        """The dispatch's one host-to-device copy of the staged operands."""
        if self._dev_ops is not self._host_ops:
            self._dev_ops.copy_(self._host_ops, non_blocking=True)

    def _dispatch_decode(self, bt, active, budgets, eos_ids) -> np.ndarray:
        """Stage one decode dispatch's operands, run it, and read the
        ``[slots, K]`` int32 tokens back (the one host wait of the
        dispatch)."""
        self._stage(bt, self._decode_counts())
        o = self._op_np
        o["active"][:] = active
        o["budgets"][:] = budgets
        o["eos"][:] = eos_ids
        self._upload()
        self._run_step(("decode", self.slots, self._nbper, self._K,
                        self.sampling, self.logit_masks), self._decode_body,
                       ("decode", self.slots) if self._K == 1
                       else ("decode", self.slots, self._K))
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
        with self.timeline.span("decode", slots=len(dec)):
            nxt = self._dispatch_decode(bt, actv, actv, -1)
        self._c_decode_steps.inc()
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
                if self._masks is not None \
                        and st.req.mask_builder is not None:
                    # constrained slots advance ONE token a dispatch: the
                    # host rebuilds the mask row between dispatches only
                    w = 1
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
        with self.timeline.span("decode", slots=len(dec), fused=K):
            out = self._dispatch_decode(bt, actv, budgets, eos_ids)
        self._c_host_fence_waits.inc()
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
        self._c_decode_steps.inc(trips)
        self._c_fused_iterations.inc(trips)

    def _refresh_masks(self) -> None:
        """Rebuild every constrained slot's ``[vocab]`` mask row from its
        builder (``serving.py:1889-1912``): ``mask_builder.allowed(
        generated tokens, remaining budget)``.  Unconstrained rows were set
        all-True at admission and release and stay so."""
        if self._masks is None:
            return
        for slot, st in self._active.items():
            mb = st.req.mask_builder
            if mb is None:
                continue
            row = np.asarray(
                mb.allowed(st.prior + st.out,
                           st.req.max_new_tokens - st.gen_count),
                dtype=bool)
            if row.shape != (self._vocab,):
                raise ValueError(
                    f"request {st.req.uid!r}: mask_builder.allowed() "
                    f"returned shape {row.shape}, expected "
                    f"({self._vocab},) (the model's vocab_size)")
            self._masks[slot, :] = row

    def _run_spec_decode(self) -> None:
        """One speculative draft-verify round over every decode-phase slot
        (``serving.py:3889-4018``).  Propose K tokens a slot (the draft
        model's captured rollout, or the host's n-gram lookup), score the
        ``[pending, d_1..d_K]`` window in one captured verify step at each
        slot's committed length, then commit the accepted draft prefix
        plus one target token (``spec.greedy_accept``, or
        ``spec.rejection_accept`` on a sampling engine).  Rejected tokens
        roll back by *not* advancing ``_lengths``: their KV stays past the
        committed length, masked, and the next round overwrites it.  Block
        demand is capped at each request's ``pos_cap``; window positions
        past it write to scratch."""
        k = self.spec_tokens
        active = self._active
        dec = sorted((s for s, st in active.items() if st.phase == "decode"),
                     key=lambda s: active[s].admit_seq)
        for slot in dec:
            if slot in active and active[slot].phase == "decode":
                st = active[slot]
                ln = int(self._lengths[slot])
                cap = max(st.pos_cap, ln + 1)
                self._ensure_blocks(slot,
                                    min(ln + k + 1, cap, self._cache_len))
        dec = sorted(s for s, st in active.items() if st.phase == "decode")
        if not dec:
            return
        bt = np.zeros_like(self._tables)
        bt[dec] = self._tables[dec]
        self._stage(bt, self._decode_counts())
        o = self._op_np
        o["valid"][:] = 0
        o["valid"][dec] = k + 1
        o["ids"][:] = 0
        o["ids"][dec, 0] = self._tokens[dec]
        # spec_propose ends without a device sync (the rollout's launches
        # only); spec_verify ends at the round's read-back
        with self.timeline.span(
                "spec_propose", slots=len(dec),
                mode="draft" if self._draft is not None else "ngram"):
            if self._draft is None:
                for slot in dec:
                    st = active[slot]
                    o["ids"][slot, 1:] = self._proposer.propose(
                        np.concatenate([st.prompt_eff,
                                        np.asarray(st.out, np.int32)]))
            self._upload()
            if self._draft is not None:
                self._run_step(("draft", self.slots, self._nbper, k,
                                self.sampling), self._draft_body,
                               ("draft", self.slots, k))
        with self.timeline.span("spec_verify", slots=len(dec), window=k + 1):
            self._run_step(("verify", self.slots, self._nbper, k + 1,
                            self.sampling, self.logit_masks),
                           self._verify_body, ("verify", self.slots, k + 1))
            out = self._spec_out.cpu().numpy()
        scored, accept, plain, resid, ids = out
        self._c_spec_rounds.inc()
        # a draft model caps acceptance at K-1: the K-th draft's KV was
        # never written to the draft pool, so accepting it would leave a
        # hole at the draft's next feed position
        max_accept = k - 1 if self._draft is not None else k
        accept_lens = []
        for slot in dec:
            st = active[slot]
            cap = max_accept
            if self._masks is not None and st.req.mask_builder is not None:
                # constrained slots accept no draft: the mask row is built
                # per emitted token, so only the window's first position
                # is gated right; the cap-0 stop emits plain[0]
                cap = 0
            budget = st.req.max_new_tokens - st.gen_count
            if self.sampling:
                emitted, accepted, finished = rejection_accept(
                    ids[slot].tolist(), accept[slot, :k].tolist(),
                    plain[slot].tolist(), resid[slot, :k].tolist(), cap,
                    st.eos, budget)
                verdicts = accept[slot, :k] != 0
            else:
                emitted, accepted, finished = greedy_accept(
                    ids[slot].tolist(), scored[slot].tolist(), cap,
                    st.eos, budget)
                verdicts = ids[slot, 1:] == scored[slot, :k]
            # the counters count the drafts whose verdicts are real: not
            # the cap-ineligible ones, nor positions past the budget
            eligible = min(k, cap, budget)
            raw = 0
            while raw < eligible and verdicts[raw]:
                raw += 1
            self._c_drafted.inc(eligible)
            self._c_accepted.inc(raw)
            self._c_spec_rejected.inc(eligible - raw)
            if eligible:
                self._h_accept_ratio.observe(raw / eligible)
            accept_lens.append(accepted)
            for tok in emitted:            # the last finishes iff finished
                self._emit(slot, st, tok)
            if not finished:
                # commit = pending + accepted drafts; the last emitted
                # token is the new pending feed
                self._lengths[slot] += accepted + 1
        self.timeline.instant("spec_accept", accept_lens=accept_lens,
                              drafted=k * len(dec))

    def _run_prefill(self, params) -> None:
        """Advance prefilling slots: one ``prefill_chunk`` window per slot
        per iteration (chunked mode), or the whole prompt in its bucket's
        window (bucketed mode, grouped by bucket, ``serving.py:4021-4069``).
        Both run ``prefill_batch`` rows per call; pad rows write to
        scratch."""
        active = self._active
        pre = [s for s, st in sorted(active.items(),
                                     key=lambda kv: kv[1].admit_seq)
               if st.phase == "prefill"]
        if not pre:
            return
        groups = []
        if self.chunked_prefill:
            ready = []
            for slot in pre:
                if slot not in active:
                    continue               # preempted by an earlier alloc
                st = active[slot]
                v = min(self.prefill_chunk, st.plen_eff - st.base)
                if self._ensure_blocks(slot, st.base + v):
                    ready.append(slot)
            for i in range(0, len(ready), self.prefill_batch):
                group = [s for s in ready[i:i + self.prefill_batch]
                         if s in active]
                if group:
                    groups.append((self.prefill_chunk, group))
        else:
            by_bucket: Dict[int, list] = {}
            for slot in pre:
                if slot not in active:
                    continue
                st = active[slot]
                if self._ensure_blocks(slot, st.plen_eff):
                    by_bucket.setdefault(self._prefill_width(st.plen_eff),
                                         []).append(slot)
            for bucket in sorted(by_bucket):
                grp = by_bucket[bucket]
                for i in range(0, len(grp), self.prefill_batch):
                    group = [s for s in grp[i:i + self.prefill_batch]
                             if s in active]
                    if group:
                        groups.append((bucket, group))
        for width, group in groups:
            group = [s for s in group if s in active]
            if group:
                self._run_prefill_group(width, group, params)

    def _run_prefill_group(self, width, group, params) -> None:
        """One prefill call: each row advances its slot by ``min(width,
        remaining prompt)`` tokens from its own base; rows whose window
        reaches the last prompt token yield the slot's first generated
        token (logits gathered per row at ``valid - 1``).  With a draft
        model the draft's pool takes the same window through the same
        tables (the JAX server's fused prefill, ``serving.py:2070-2086``).
        A width's first call builds its logical program."""
        active = self._active
        j = self.prefill_batch
        if width not in self._prefill_calls_by_width:
            self._note_build(f"prefill[w{width}]", ("prefill", width, j))
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
        # the span ends at the first tokens' read-back (a device sync)
        with self.timeline.span("prefill", width=width, rows=len(group),
                                slots=list(map(int, group))):
            d_ids, d_base = self._to_device(ids), self._to_device(base)
            kw = dict(lengths=self._to_device(valid),
                      block_tables=self._to_device(bt))
            logits, self._cache = self._fwd(params, d_ids, self._cache,
                                            d_base, **kw)
            if self._draft is not None:
                dfwd = self._draft.module.decode_hooks["forward_cached"]
                _, self._dcache = dfwd(self._draft.params, d_ids,
                                       self._dcache, d_base, **kw)
            first = self._next_tokens(logits, samp).cpu().numpy()
        self._c_prefill_calls.inc()
        self._prefill_calls_by_width[width] = \
            self._prefill_calls_by_width.get(width, 0) + 1
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
            if self.spec_tokens and self.sampling and st.prior \
                    and st.req.sampled:
                # a sampled speculative resume: the original stream's token
                # at emission index len(prior) came out of a verify round
                # (accept / residual keys), not the prefill's token key — so
                # back up one position instead of emitting: the last resumed
                # token becomes the pending window head (its KV is rewritten
                # with the same values), and the next round starts at the
                # original round boundary (serving.py:4155-4168)
                self._tokens[slot] = int(st.prompt_eff[-1])
                self._lengths[slot] = st.plen_eff - 1
                continue
            self._lengths[slot] = st.plen_eff
            self._emit(slot, st, int(first[row]))

    # ------------------------------------------------------------------ stats
    def resolved_config(self) -> Dict[str, Any]:
        """The engine's resolved serving knobs as a round-trippable,
        JSON-able ``init_serving`` kwargs dict (``serving.py:4181-4234``):
        ``init_serving(model, **srv.resolved_config())`` rebuilds an engine
        that behaves the same (auto knobs — ``chunked_prefill``,
        ``num_blocks``, SLO targets — come back resolved).  The keys of
        features the port does not have yet (``engine_mode``, ``sp``, the
        KV tiers, ``role``, the NVMe keys, ``shard_kv``, ``topology``)
        carry the one value the port runs: their defaults (``shard_kv``
        False and ``topology`` 1, the one-card layout).

        Not captured: the wrapped ``init_inference`` engine itself (model,
        params, dtype, quant group sizes) and a ``draft`` model object — a
        draft-model speculative engine round-trips to the n-gram proposer
        at the same ``spec_tokens``."""
        return {
            "slots": self.slots,
            "max_seq_len": self.max_seq_len,
            "block_size": self.block_size,
            "num_blocks": int(self._alloc.num_blocks),
            "chunked_prefill": bool(self.chunked_prefill),
            "prefill_chunk": int(self.prefill_chunk),
            "decode_steps": self._K,
            "engine_mode": "replicas",
            "sp": 1,
            "resident_window_blocks": 0,
            "prompt_buckets": list(self.prompt_buckets) or None,
            "prefill_batch": self.prefill_batch,
            "prefix_caching": self._prefix is not None,
            "spec_tokens": self.spec_tokens,
            "ngram_max": self.ngram_max,
            "ngram_min": self.ngram_min,
            "sampling": self.sampling,
            "spec_verifier": self.spec_verifier,
            "logit_masks": self.logit_masks,
            "quantize": self.quantize,
            "host_blocks": 0,
            "swap_batch": 8,
            "role": "both",
            "nvme_blocks": 0,
            "nvme_high_watermark": 0.9,
            "nvme_path": None,
            "shard_kv": False,
            "topology": 1,
            "debug_checks": self.debug_checks,
            "trace_capacity": int(self.timeline.capacity),
            "slo_targets": {cls: dict(t)
                            for cls, t in self._slo.targets.items()},
            "peak_flops": self.peak_flops,
        }

    def _kv_footprint(self) -> Dict[str, Any]:
        """KV memory accounting: pool shape and bytes (codes plus the scale
        table under ``kv8``), and the draft pool's bytes."""
        out = {
            "quantize": self.quantize,
            "kv_dtype": self._kv_dtype,
            "weight_quant": self.weight_quant,
            "kv_scale_bytes": sum(
                leaf["ps"].numel() * leaf["ps"].element_size()
                for leaf in self._cache.values() if is_quantized_pool(leaf)),
            "kv_pool_shape": list(self._pool_shape),
            "kv_pool_bytes": _nbytes(self._cache),
        }
        if self._dcache is not None:
            out["draft_pool_bytes"] = _nbytes(self._dcache)
        return out

    def _latency_stats(self) -> Dict[str, Any]:
        """TTFT/TPOT percentiles over every finished request, from the
        registry's streaming histograms (``None`` before the first)."""
        out: Dict[str, Any] = {
            "requests_finished": int(self._c_finished.value)}
        for key, hist in (("ttft", self._h_ttft), ("tpot", self._h_tpot)):
            for q in (50, 95):
                out[f"{key}_p{q}_s"] = hist.quantile(q / 100.0)
        return out

    def stats(self) -> Dict[str, Any]:
        """Serving-loop observability, every counter a view over
        ``self.metrics`` (``serving.py:4287``): the compile probe and
        sentry, admissions, preemptions (``evicted``), cancels, decode
        steps (the deepest slot's steps of each fused window), fused
        iterations and host fences, prefill calls, sampled and constrained
        requests, the prefix-cache hit rate, block occupancy, TTFT/TPOT
        percentiles, the KV footprint, the speculative counters, the
        timeline ring's health and the resolved config.  The port's own
        keys: ``captured_graphs`` (CUDA graphs captured) and the launches
        of each decode-attention and int8-matmul kernel (process-wide executions: a replayed graph
        adds the launches it holds).  The JAX keys of features the port
        does not have yet (the tp, dp, sp, resident-window, host-tier,
        disaggregation and NVMe keys) are left out."""
        self._g_blocks_in_use.set(self._alloc.blocks_in_use)
        self._g_free_blocks.set(self._alloc.free_blocks)
        st = {
            "mode": "chunked" if self.chunked_prefill else "bucketed",
            "compile_count": self.compile_count,
            "compile_budget": self.compile_budget,
            "debug_checks": self.debug_checks,
            "invariant_checks_run": self.invariant_checks_run,
            "retraces_observed": self.sentry.retraces_observed,
            "backend_compiles": backend_compiles(),
            "captured_graphs": self.captured_graphs,
            "iterations": self.iterations,
            "decode_steps": self.decode_steps,
            "fused_iterations": int(self._c_fused_iterations.value),
            "host_fence_waits": int(self._c_host_fence_waits.value),
            "prefill_calls": self.prefill_calls,
            "admitted": self.admitted,
            "evicted": self.preempted,
            "cancelled": int(self._c_cancelled.value),
            "queue_depth": len(self._pending),
            "generated_tokens": int(self._c_gen_tokens.value),
            "prompt_tokens": self.prompt_tokens,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefix_cache_hit_rate": (
                self.prefix_hit_tokens / self.prompt_tokens
                if self.prompt_tokens else 0.0),
            "prefix_cache_entries": len(self._prefix)
            if self._prefix is not None else 0,
            "prefix_cache_evictions": self._prefix.evictions
            if self._prefix is not None else 0,
            "blocks_in_use": self._alloc.blocks_in_use,
            "free_blocks": self._alloc.free_blocks,
            "num_blocks": self._alloc.num_blocks,
            "block_size": self.block_size,
            "speculative": (
                None if not self.spec_tokens else
                f"draft:{self._draft.module.name}" if self._draft
                else "ngram"),
            "spec_tokens": self.spec_tokens,
            "spec_rounds": self.spec_rounds,
            "drafted_tokens": self.drafted_tokens,
            "accepted_tokens": self.accepted_tokens,
            "acceptance_rate": (self.accepted_tokens / self.drafted_tokens
                                if self.drafted_tokens else 0.0),
            "sampling": self.sampling,
            "spec_verifier": self.spec_verifier,
            "logit_masks": self.logit_masks,
            "sampled_requests": int(
                self._c_sampled["sampled"].value
                + self._c_sampled["constrained"].value),
            "spec_draft_rejected": int(self._c_spec_rejected.value),
            "resume_recompute_tokens": int(self._c_resume_recompute.value),
            "trace_capacity": self.timeline.capacity,
            "trace_events": len(self.timeline),
            "trace_events_dropped": self.timeline.dropped,
            "config": self.resolved_config(),
        }
        st.update(self._kv_footprint())
        st.update(self._latency_stats())
        for fn in decode_attention.KERNELS + quantized_matmul.KERNELS:
            st[f"{fn.__name__}_launches"] = fn.launches
        return st
