"""SLO attainment accounting: per-class TTFT/TPOT distributions,
attainment counters against configurable latency targets, and
error-budget burn-rate gauges — the port's copy of
``deepspeed_tpu/telemetry/slo.py`` (one engine's tracker; the router's
merge of several, ``merged_slo_report``, comes with the fleet layers).

Every finished request lands in its class's streaming TTFT/TPOT
histograms and attainment counters, so ``slo_report()`` answers "is the
realtime class meeting its target, and how fast is it burning its error
budget?".

Definitions (per class, per latency dimension):

 - **attainment** = attained / total — the fraction of finished requests
   at or under the class target.
 - **objective** — the attainment fraction the class promises (e.g.
   "99% of realtime requests see TTFT <= 0.5s").
 - **burn rate** = (1 - attainment) / (1 - objective) — how fast the
   error budget burns: 1.0 = exactly on budget, >1 = violating faster
   than the objective allows, 0 = no violations.

Requests submitted without an ``slo_class`` are accounted under
``"standard"``, so attainment is never flattered by unclassified traffic.

Metric families (on the owning engine's registry; label ``slo_class``,
plus ``slo`` in ``{ttft, tpot}`` on the attainment/burn families):

 - ``serving_slo_requests_total{slo_class=}``
 - ``serving_slo_attained_total{slo_class=, slo=}``
 - ``serving_slo_ttft_seconds{slo_class=}`` /
   ``serving_slo_tpot_seconds{slo_class=}`` (histograms)
 - ``serving_slo_burn_rate{slo_class=, slo=}`` (gauge)

Everything is host-side and O(1) per finished request.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, Mapping, Optional, Sequence

from .metrics import MetricsRegistry

__all__ = ["DEFAULT_SLO_TARGETS", "SLOTracker", "merged_windowed_burn"]

#: per-class latency targets + attainment objective.  The classes mirror
#: ``inference/serving.py SLO_PRIORITY``; targets are deliberately
#: generous defaults — production overrides them per deployment
#: (``init_serving(slo_targets=...)``).
DEFAULT_SLO_TARGETS: Dict[str, Dict[str, float]] = {
    "realtime":    {"ttft_s": 0.5,  "tpot_s": 0.05, "objective": 0.99},
    "interactive": {"ttft_s": 1.0,  "tpot_s": 0.10, "objective": 0.95},
    "standard":    {"ttft_s": 2.5,  "tpot_s": 0.25, "objective": 0.90},
    "batch":       {"ttft_s": 30.0, "tpot_s": 1.00, "objective": 0.50},
    # 100k+-token prompts: TTFT is dominated by streaming prefill (long
    # by construction), but once decoding the resident-window engine
    # should hold an interactive-grade token cadence
    "giant_context": {"ttft_s": 60.0, "tpot_s": 0.30, "objective": 0.90},
}

_DIMS = ("ttft", "tpot")

#: bucket count of the rolling attainment window (per class): the window
#: is quantised into this many time buckets of ``window_s / N`` seconds
#: each, so windowed burn costs O(1) per observation and O(N) per query
_WINDOW_BUCKETS = 16


class SLOTracker:
    """Per-class SLO accounting over one engine's finished requests.

    Parameters
    ----------
    registry:  the engine's :class:`MetricsRegistry` — all cells live
               there, so scrapes/snapshots/federation see them for free.
    targets:   ``{class: {"ttft_s", "tpot_s", "objective"}}`` overrides,
               merged OVER :data:`DEFAULT_SLO_TARGETS` per class (a
               partial override keeps the other fields' defaults); new
               class names are allowed.
    window_s:  span of the rolling attainment window behind
               :meth:`windowed_burn` (the cumulative ``slo_report``
               surface is unaffected).
    clock:     second-denominated monotonic clock (injectable for
               tests; defaults to :func:`time.monotonic`).
    """

    def __init__(self, registry: MetricsRegistry,
                 targets: Optional[Mapping[str, Mapping[str, float]]]
                 = None, *, window_s: float = 60.0, clock=None):
        self.registry = registry
        self.window_s = float(window_s)
        self._clock = clock or time.monotonic
        self._bucket_w = max(self.window_s / _WINDOW_BUCKETS, 1e-6)
        #: cls -> ring of [bucket_index, n, ttft_attained, tpot_attained]
        self._window: Dict[str, deque] = {}
        self.targets: Dict[str, Dict[str, float]] = {
            cls: dict(t) for cls, t in DEFAULT_SLO_TARGETS.items()}
        for cls, t in (targets or {}).items():
            base = self.targets.setdefault(
                cls, dict(DEFAULT_SLO_TARGETS["standard"]))
            base.update(t)
        self._cells: Dict[str, Dict[str, Any]] = {}
        # create every configured class's cells up front: the metric
        # schema (and the report key set) is stable regardless of which
        # classes this trace's traffic happened to exercise
        for cls in self.targets:
            self._class_cells(cls)

    def _class_cells(self, cls: str) -> Dict[str, Any]:
        cells = self._cells.get(cls)
        if cells is None:
            m = self.registry
            cells = self._cells[cls] = {
                "requests": m.counter(
                    "serving_slo_requests_total",
                    "finished requests accounted per SLO class",
                    slo_class=cls),
                "ttft_hist": m.histogram(
                    "serving_slo_ttft_seconds",
                    help="per-class time to first token", slo_class=cls),
                "tpot_hist": m.histogram(
                    "serving_slo_tpot_seconds",
                    help="per-class time per output token", slo_class=cls),
                "ttft_attained": m.counter(
                    "serving_slo_attained_total",
                    "finished requests at or under the class target",
                    slo_class=cls, slo="ttft"),
                "tpot_attained": m.counter(
                    "serving_slo_attained_total",
                    "finished requests at or under the class target",
                    slo_class=cls, slo="tpot"),
                "ttft_burn": m.gauge(
                    "serving_slo_burn_rate",
                    "error-budget burn rate: (1 - attainment) / "
                    "(1 - objective); > 1 violates faster than the "
                    "objective allows", slo_class=cls, slo="ttft"),
                "tpot_burn": m.gauge(
                    "serving_slo_burn_rate",
                    "error-budget burn rate: (1 - attainment) / "
                    "(1 - objective); > 1 violates faster than the "
                    "objective allows", slo_class=cls, slo="tpot"),
            }
        return cells

    def observe(self, slo_class: Optional[str], ttft_s: float,
                tpot_s: float) -> None:
        """Account one finished request (``None`` class → "standard")."""
        cls = str(slo_class) if slo_class is not None else "standard"
        cells = self._class_cells(cls)
        tgt = self.targets.setdefault(
            cls, dict(DEFAULT_SLO_TARGETS["standard"]))
        cells["requests"].inc()
        cells["ttft_hist"].observe(ttft_s)
        cells["tpot_hist"].observe(tpot_s)
        total = cells["requests"].value
        for dim, v in (("ttft", ttft_s), ("tpot", tpot_s)):
            if v <= tgt[f"{dim}_s"]:
                cells[f"{dim}_attained"].inc()
            attainment = cells[f"{dim}_attained"].value / total
            allowed = max(1.0 - tgt["objective"], 1e-9)
            cells[f"{dim}_burn"].set((1.0 - attainment) / allowed)
        # rolling window: fold the observation into the current time
        # bucket (ring bounded at one spare bucket past the window)
        idx = int(self._clock() / self._bucket_w)
        ring = self._window.setdefault(
            cls, deque(maxlen=_WINDOW_BUCKETS + 1))
        if not ring or ring[-1][0] != idx:
            ring.append([idx, 0, 0, 0])
        b = ring[-1]
        b[1] += 1
        b[2] += 1 if ttft_s <= tgt["ttft_s"] else 0
        b[3] += 1 if tpot_s <= tgt["tpot_s"] else 0

    def windowed_burn(self, window_s: Optional[float] = None
                      ) -> Dict[str, Dict[str, Any]]:
        """Per-class burn rate over the last ``window_s`` seconds only
        (defaults to the tracker's configured window) — the scale-up /
        incident-trigger signal, where the process-lifetime cumulative
        ``burn_rate`` in :meth:`report` is useless after the first hour
        of healthy traffic has banked budget."""
        return merged_windowed_burn([self], window_s=window_s)

    # ------------------------------------------------------------ reporting
    def report(self) -> Dict[str, Dict[str, Any]]:
        """Per-class attainment report — a stable-schema dict view over
        the cells (class key set = configured targets plus any class
        traffic introduced).  One engine's view: the fleet-wide merge of
        several trackers' histograms (``merged_slo_report``) comes with
        the router."""
        out: Dict[str, Dict[str, Any]] = {}
        for cls in sorted(self.targets):
            tgt = self.targets[cls]
            c = self._cells.get(cls)
            requests = int(c["requests"].value) if c is not None else 0
            entry: Dict[str, Any] = {
                "requests": requests,
                "objective": tgt["objective"],
            }
            for dim in _DIMS:
                entry[f"{dim}_target_s"] = tgt[f"{dim}_s"]
                attained = int(c[f"{dim}_attained"].value) \
                    if c is not None else 0
                entry[f"{dim}_attained"] = attained
                if requests:
                    attainment = attained / requests
                    entry[f"{dim}_attainment"] = attainment
                    entry[f"{dim}_burn_rate"] = (1.0 - attainment) / \
                        max(1.0 - tgt["objective"], 1e-9)
                else:
                    entry[f"{dim}_attainment"] = None
                    entry[f"{dim}_burn_rate"] = 0.0
                hist = c[f"{dim}_hist"] if c is not None else None
                entry[f"{dim}_p50_s"] = hist.quantile(0.50) \
                    if hist is not None else None
                entry[f"{dim}_p95_s"] = hist.quantile(0.95) \
                    if hist is not None else None
            out[cls] = entry
        return out


def merged_windowed_burn(trackers: Sequence["SLOTracker"],
                         window_s: Optional[float] = None
                         ) -> Dict[str, Dict[str, Any]]:
    """Fleet-wide per-class burn rate over the last ``window_s`` seconds
    (default: the first tracker's window; capped per tracker by its own
    ring retention).  Buckets whose span overlaps the window sum across
    trackers; attainment and burn recompute from the windowed totals
    exactly like :func:`merged_slo_report` does from the cumulative
    ones.  Classes with zero windowed traffic report ``attainment=None``
    and ``burn_rate=0.0`` — a quiet class is not a burning class."""
    if not trackers:
        return {}
    w = float(window_s) if window_s is not None else trackers[0].window_s
    classes: Dict[str, Dict[str, float]] = {}
    for t in trackers:
        for cls, tgt in t.targets.items():
            classes.setdefault(cls, tgt)
        for cls in t._window:
            classes.setdefault(cls, DEFAULT_SLO_TARGETS["standard"])
    out: Dict[str, Dict[str, Any]] = {}
    for cls in sorted(classes):
        tgt = classes[cls]
        n = ttft_att = tpot_att = 0
        for t in trackers:
            ring = t._window.get(cls)
            if not ring:
                continue
            # a bucket overlaps (now - w, now] iff its span's right edge
            # is past the window's left edge
            min_idx = int((t._clock() - min(w, t.window_s))
                          / t._bucket_w)
            for idx, bn, ba, bp in ring:
                if idx >= min_idx:
                    n += bn
                    ttft_att += ba
                    tpot_att += bp
        entry: Dict[str, Any] = {"requests": n, "window_s": w,
                                 "objective": tgt["objective"]}
        allowed = max(1.0 - tgt["objective"], 1e-9)
        for dim, att in (("ttft", ttft_att), ("tpot", tpot_att)):
            if n:
                attainment = att / n
                entry[f"{dim}_attainment"] = attainment
                entry[f"{dim}_burn_rate"] = (1.0 - attainment) / allowed
            else:
                entry[f"{dim}_attainment"] = None
                entry[f"{dim}_burn_rate"] = 0.0
        out[cls] = entry
    return out
