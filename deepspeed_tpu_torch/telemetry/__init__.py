"""Telemetry layer of the port (``deepspeed_tpu/telemetry/``): the metrics
registry, the trace timeline with its ``torch.profiler`` window, SLO
accounting and the FLOPs/MFU profiler.  Host-side throughout.

 - :mod:`~deepspeed_tpu_torch.telemetry.metrics` — counters / gauges /
   fixed-bucket streaming histograms with labels; Prometheus text, JSON
   snapshots and ``(name, value, step)`` events.  ``ServingEngine.stats()``
   is a view over one registry.
 - :mod:`~deepspeed_tpu_torch.telemetry.trace` — a bounded ring of
   per-request scheduler events exportable as Chrome ``trace_event`` JSON,
   and the ``torch.profiler`` window.
 - :mod:`~deepspeed_tpu_torch.telemetry.slo` — per-``slo_class`` TTFT/TPOT
   histograms, attainment counters and burn-rate gauges behind
   ``slo_report()``.
 - :mod:`~deepspeed_tpu_torch.telemetry.flops` — the serving FLOPs/MFU
   profiler behind ``flops_report()``.

Fleet federation (``aggregate``), the live exposition server (``server``)
and the incident recorder (``incident``) serve the router and the fleet and
come with them (ROADMAP Queue A 9).
"""

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      DEFAULT_TIME_BUCKETS_S)
from .trace import ProfilerWindow, TraceTimeline, validate_chrome_trace
from .slo import DEFAULT_SLO_TARGETS, SLOTracker, merged_windowed_burn

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "DEFAULT_TIME_BUCKETS_S", "ProfilerWindow", "TraceTimeline",
    "validate_chrome_trace", "DEFAULT_SLO_TARGETS", "SLOTracker",
    "merged_windowed_burn",
]
