"""FLOPs/MFU profiler for the serving engine: per-program FLOPs counted by
``torch.utils.flop_counter.FlopCounterMode`` (with the JAX package's
deterministic analytic estimate as the fallback), cumulative model-FLOPs
accounting, an MFU gauge, and a busy-fraction breakdown from the trace
timeline — the port's copy of ``deepspeed_tpu/telemetry/flops.py``.

A *program* is one ``(family, shape)`` the engine has built
(``ServingEngine.compiled_programs``): ``decode``, ``prefill`` at each
window width, ``verify`` and ``draft``.  Where the JAX package lowers the
raw program body for XLA's ``cost_analysis``, the port runs the family's
forward — the model's ``forward_cached`` hook, as the device step calls it
— on **meta tensors** of the live shapes (parameters, pool, operands)
under ``FlopCounterMode``:

 - meta tensors hold no memory and launch nothing: no device work, no
   CUDA graph, no build — ``compile_count`` is unchanged by a report;
 - on meta tensors every kernel wrapper takes its plain PyTorch version
   (they dispatch on ``is_cuda``), so the counter sees the attention's
   ``einsum`` products and every matmul.  The hand-written kernels
   themselves are invisible to it: a count of a CUDA run would miss
   attention.  That is why the count runs on meta.

Families left on the analytic count: any whose plain body cannot run on
meta tensors (the profiler logs why and keeps the analytic estimate), and
any count that misses the analytic estimate by more than 25%
(:meth:`ServingFlopsProfiler._reconcile`, the JAX rule).  The count
excludes the token rule (argmax / sampler: element-wise, which the
analytic formula leaves out too).  The decode family is counted for ONE
step and billed per ``decode_steps`` (the deepest slot's steps of each
fused window), as the JAX package bills its fused loop.

Accounting: ``report()`` multiplies per-program FLOPs by the engine's
invocation counters (``decode_steps`` / ``prefill_calls`` by width /
``spec_rounds``) into ``serving_model_flops_total``, sets the
``serving_mfu`` gauge against a configurable ``peak_flops`` (the card's
peak for the serving dtype — the MFU denominator), and decomposes wall
time into ``serving_busy_fraction{phase=prefill|decode|swap|idle}`` from
the ``X``-span durations already on the trace timeline (host time; see
``telemetry/trace.py`` for which spans end at a device sync).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..utils.logging import logger

__all__ = ["analytic_components", "analytic_program_flops",
           "busy_fractions", "ServingFlopsProfiler"]

#: timeline ``X`` span names folded into each busy phase
_PHASE_SPANS = {
    "prefill": ("prefill",),
    "decode": ("decode", "spec_propose", "spec_verify"),
    "swap": ("swap",),
}


def _model_dims(model_config) -> Dict[str, int]:
    """Transformer dimensions with family-tolerant attribute fallbacks."""
    h = int(model_config.hidden_size)
    heads = int(model_config.num_heads)
    kvh = int(getattr(model_config, "num_kv_heads",
                      getattr(model_config, "num_key_value_heads", heads)))
    ffn = int(getattr(model_config, "ffn_hidden_size",
                      getattr(model_config, "intermediate_size", 4 * h)))
    return {"layers": int(model_config.num_layers), "hidden": h,
            "heads": heads, "kv_heads": kvh, "ffn": ffn,
            "vocab": int(model_config.vocab_size)}


def analytic_components(family: str, dims: Dict[str, int], *,
                        rows: int, width: int, ctx: int
                        ) -> Dict[str, float]:
    """Closed-form FLOPs components for one invocation of a fixed-shape
    serving program (the JAX package's formula, unchanged) — ``{"head": lm-head flops, "layers": all-layer
    flops}`` — for ``rows × width`` tokens, each token's attention
    spanning the full padded table width ``ctx`` (fixed-shape kernels
    compute the pads too — that IS the executed work).  2 FLOPs per MAC
    throughout.

    Per token: QKV ``2h(h + 2·kvh·hd)`` + attention out ``2h²`` + MLP
    ``4h·ffn`` + scores/weighted-sum ``4h·ctx`` (per-query-head width ×
    context, GQA-invariant), per layer; plus the LM head ``2hV`` — at
    the **last position only** for prefill/decode (the programs gather
    final-position logits) and at every window position for the
    ``all_positions`` verify head and the draft rollout (one head per
    scan step).  LayerNorms/softmax/residuals are O(h)/O(ctx) per token
    — noise next to the matmuls — and excluded.
    """
    L, h = dims["layers"], dims["hidden"]
    hd = h // dims["heads"]
    kv_width = dims["kv_heads"] * hd
    per_layer = (2 * h * (h + 2 * kv_width)   # qkv projections
                 + 2 * h * h                  # attention out projection
                 + 4 * h * dims["ffn"]        # mlp up + down
                 + 4 * h * ctx)               # scores + weighted sum
    tokens = rows * width
    head_positions = tokens if family in ("verify", "draft") else rows
    return {"head": float(head_positions * 2 * h * dims["vocab"]),
            "layers": float(tokens * L * per_layer)}


def analytic_program_flops(family: str, dims: Dict[str, int], *,
                           rows: int, width: int, ctx: int) -> float:
    """Total of :func:`analytic_components`."""
    c = analytic_components(family, dims, rows=rows, width=width, ctx=ctx)
    return c["head"] + c["layers"]


def busy_fractions(timeline, window_s: Optional[float] = None
                   ) -> Dict[str, float]:
    """Decompose the timeline window into prefill/decode/swap/idle
    fractions from the ``X``-span durations already on the ring.  The
    window defaults to first-event → last-event-end over the live ring
    (a wrapped ring reports its retained window — check
    ``trace_events_dropped``)."""
    events = timeline.events()
    spans = {phase: 0.0 for phase in _PHASE_SPANS}
    lo = hi = None
    for e in events:
        ts = e["ts"]
        end = ts + e.get("dur", 0.0)
        lo = ts if lo is None else min(lo, ts)
        hi = end if hi is None else max(hi, end)
        if e.get("ph") != "X":
            continue
        for phase, names in _PHASE_SPANS.items():
            if e["name"] in names:
                spans[phase] += e.get("dur", 0.0) / 1e6
                break
    window = window_s if window_s is not None else \
        ((hi - lo) / 1e6 if lo is not None and hi > lo else 0.0)
    out = {"window_s": window}
    if window <= 0.0:
        out.update({p: 0.0 for p in _PHASE_SPANS})
        out["idle"] = 0.0
        return out
    busy = 0.0
    for phase in _PHASE_SPANS:
        frac = min(spans[phase] / window, 1.0)
        out[phase] = frac
        busy += frac
    out["idle"] = max(0.0, 1.0 - busy)
    return out


def _meta(tree):
    """A copy of a nested dict / list / tuple of tensors as meta tensors of
    the same shapes and dtypes (non-tensor leaves kept)."""
    import torch

    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_meta(v) for v in tree)
    return tree


class ServingFlopsProfiler:
    """FLOPs/MFU accounting over one :class:`ServingEngine` (module
    docstring).  Construct once per engine (``srv.flops_report()`` does);
    metric cells land on the engine's registry."""

    def __init__(self, srv, peak_flops: Optional[float] = None):
        self.srv = srv
        self.peak_flops = peak_flops
        self._programs: Dict[str, Dict[str, Any]] = {}
        self._last_total = 0.0
        m = srv.metrics
        self._c_model_flops = m.counter(
            "serving_model_flops_total",
            "model FLOPs executed by the serving programs (per-program "
            "cost × invocation counters; padding included)")
        self._g_mfu = m.gauge(
            "serving_mfu", "model FLOPs utilization: flops_total / "
            "(elapsed wall time × peak_flops)")
        self._g_busy = {
            phase: m.gauge(
                "serving_busy_fraction",
                "fraction of the timeline window spent in each scheduler "
                "phase", phase=phase)
            for phase in ("prefill", "decode", "swap", "idle")}

    # -------------------------------------------------------- per-program cost
    def _shape_meta(self, family: str,
                    width: Optional[int] = None) -> Dict[str, int]:
        srv = self.srv
        if family == "decode":
            return {"rows": srv.slots, "width": 1}
        if family == "prefill":
            return {"rows": srv.prefill_batch, "width": int(width)}
        if family == "verify":
            return {"rows": srv.slots, "width": srv.spec_tokens + 1}
        if family == "draft":
            # K single-token steps per invocation
            return {"rows": srv.slots, "width": srv.spec_tokens}
        return {"rows": 0, "width": 0}

    def _plain_call(self, family: str, width: Optional[int]) -> None:
        """The family's forward on meta tensors of the live shapes: what
        the device step computes, minus the token rule."""
        import torch

        srv = self.srv
        slots, nb = srv.slots, srv._nbper

        def i64(*shape):
            return torch.empty(shape, dtype=torch.int64, device="meta")

        def i32(*shape):
            return torch.empty(shape, dtype=torch.int32, device="meta")

        if family == "draft":
            fwd = srv._draft.module.decode_hooks["forward_cached"]
            params, cache = _meta(srv._draft.params), _meta(srv._dcache)
            for _ in range(srv.spec_tokens):
                fwd(params, i64(slots, 1), cache, 0, lengths=i32(slots),
                    block_tables=i32(slots, nb))
            return
        params, cache = _meta(srv.engine.params), _meta(srv._cache)
        if family == "decode":
            srv._fwd(params, i64(slots, 1), cache, 0, lengths=i32(slots),
                     block_tables=i32(slots, nb))
        elif family == "prefill":
            j = srv.prefill_batch
            srv._fwd(params, i64(j, width), cache, i32(j),
                     lengths=i32(j), block_tables=i32(j, nb))
        elif family == "verify":
            srv._fwd(params, i64(slots, srv.spec_tokens + 1), cache,
                     i32(slots), lengths=i32(slots),
                     block_tables=i32(slots, nb), all_positions=True)
        else:
            raise KeyError(f"unknown program family {family!r}")

    def _counted_flops(self, family: str,
                       width: Optional[int] = None) -> Optional[float]:
        """``FlopCounterMode``'s count of the family's plain body on meta
        tensors; ``None`` when it cannot run there or counts nothing."""
        from torch.utils.flop_counter import FlopCounterMode

        try:
            with FlopCounterMode(display=False) as counter:
                self._plain_call(family, width)
            flops = float(counter.get_total_flops())
            return flops if flops > 0.0 else None
        except Exception as e:   # a body that cannot run on meta tensors
            logger.warning(
                f"flops profiler: FlopCounterMode({family}) unavailable "
                f"({e}); using the analytic estimate")
            return None

    def _entries(self):
        """(entry_name, family, width) for every program built so far
        (``compiled_programs``).  Prefill is per-WIDTH: the bucketed
        ladder builds one program per bucket, and each is costed (and
        call-counted) at its own width; chunked mode has exactly one
        width, so its entry keeps the plain "prefill" name."""
        srv = self.srv
        out = []
        for prog in srv.compiled_programs:
            family = prog[0]
            if family == "prefill":
                w = int(prog[1])
                name = "prefill" if srv.chunked_prefill else f"prefill[w{w}]"
                out.append((name, family, w))
            else:
                out.append((family, family, None))
        return out

    def profile_programs(self, refresh: bool = False
                         ) -> Dict[str, Dict[str, Any]]:
        """Per-program FLOPs for every program the engine has built so
        far: ``{"flops_per_call", "flops_analytic", "tokens_per_call",
        "source"}`` — cached per entry (shapes are fixed once built).
        ``flops_cost_analysis`` keeps the JAX schema's key and holds the
        ``FlopCounterMode`` count."""
        srv = self.srv
        dims = _model_dims(srv.engine.module.model_config)
        ddims = _model_dims(srv._draft.module.model_config) \
            if srv._draft is not None else None
        for name, family, width in self._entries():
            if name in self._programs and not refresh:
                continue
            meta = self._shape_meta(family, width)
            fam_dims = ddims if family == "draft" else dims
            comp = analytic_components(
                family, fam_dims, rows=meta["rows"], width=meta["width"],
                ctx=srv._cache_len)
            analytic = comp["head"] + comp["layers"]
            counted = self._counted_flops(family, width)
            flops, source = self._reconcile(counted, analytic)
            self._programs[name] = {
                "rows": meta["rows"],
                "width": meta["width"],
                "flops_analytic": analytic,
                "flops_cost_analysis": counted,
                "flops_per_call": flops,
                "tokens_per_call": meta["rows"] * max(meta["width"], 1),
                "source": source,
            }
        return self._programs

    @staticmethod
    def _reconcile(counted: Optional[float], analytic: float):
        """The count stands when it sits within 25% of the analytic
        estimate (``telemetry/flops.py:322-347``'s bar); otherwise — or
        when there is none — the deterministic analytic estimate wins and
        the count is kept for reference.  The port's layers run as a
        Python loop, so the count covers all of them (the JAX rule's
        ``fori_loop``-scaled branch has nothing to correct here)."""
        if counted is not None and abs(counted - analytic) <= 0.25 * analytic:
            return counted, "flop_counter"
        return analytic, "analytic"

    # ---------------------------------------------------------------- report
    def report(self, peak_flops: Optional[float] = None,
               window_s: Optional[float] = None) -> Dict[str, Any]:
        """FLOPs/MFU snapshot: per-program costs, cumulative model FLOPs
        (also pushed into ``serving_model_flops_total``), the MFU gauge
        against ``peak_flops`` (falls back to the constructor value), and
        the busy-fraction breakdown.  ``window_s`` overrides the MFU
        wall-clock denominator (default: time since the engine was
        built)."""
        srv = self.srv
        programs = self.profile_programs()
        calls = {"decode": srv.decode_steps,
                 "verify": srv.spec_rounds,
                 "draft": srv.spec_rounds if srv._draft is not None
                 else 0}
        for name, family, width in self._entries():
            if family == "prefill":
                calls[name] = srv._prefill_calls_by_width.get(width, 0)
        total = sum(p["flops_per_call"] * calls.get(f, 0)
                    for f, p in programs.items())
        if total > self._last_total:
            self._c_model_flops.inc(total - self._last_total)
            self._last_total = total
        window = window_s if window_s is not None else \
            srv.timeline.now_us() / 1e6
        peak = peak_flops if peak_flops is not None else self.peak_flops
        mfu = (total / (window * peak)) if peak and window > 0 else None
        if mfu is not None:
            self._g_mfu.set(mfu)
        busy = busy_fractions(srv.timeline)
        for phase, g in self._g_busy.items():
            g.set(busy[phase])
        gen = int(srv._c_gen_tokens.value)
        return {
            "programs": {f: dict(p) for f, p in programs.items()},
            "program_calls": {f: int(calls.get(f, 0)) for f in programs},
            "model_flops_total": total,
            "flops_per_generated_token": (total / gen) if gen else None,
            "generated_tokens": gen,
            "window_s": window,
            "peak_flops": peak,
            "mfu": mfu,
            "busy_fractions": busy,
        }
