"""Metrics registry: counters, gauges and fixed-bucket streaming histograms
with labels, exposed as Prometheus text and JSON snapshots — the port's copy
of ``deepspeed_tpu/telemetry/metrics.py`` (host-only, the same exposition
bytes for the same operations).

 - :class:`Counter` / :class:`Gauge`: one float cell each — an ``inc`` /
   ``set`` is an attribute store, nothing else, so engine hot loops can
   afford one per event.
 - :class:`Histogram`: **fixed-bucket streaming** — observations land in
   ``bisect``-found buckets; memory is ``len(bounds) + 1`` ints forever,
   regardless of how many requests a long ``serve()`` session records.
   Quantiles are estimated by linear interpolation inside the covering
   bucket — exact to within one bucket width and monotone in ``q``.
 - :class:`MetricsRegistry`: get-or-create families keyed by metric name,
   series keyed by sorted label items (Prometheus data model).
   ``prometheus_text()`` renders the standard text exposition,
   ``snapshot()`` a JSON-able dict, and ``to_events(step)`` the
   ``(name, value, step)`` triples a monitor backend consumes.

Everything here is host-side and allocation-light: a metric update never
touches the device, and none belongs inside a captured CUDA graph (host
timers and telemetry go *around* device calls, never inside them).
"""

from __future__ import annotations

import json
import threading
from bisect import bisect_left
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "DEFAULT_TIME_BUCKETS_S",
]

#: default histogram bounds for second-denominated latencies: log-spaced
#: 10us..60s — TTFT/TPOT on anything from CPU-sim tests to real traffic
#: lands mid-range, keeping the one-bucket-width quantile error small
DEFAULT_TIME_BUCKETS_S: Tuple[float, ...] = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
    1e-2, 2.5e-2, 5e-2, 1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0, 10.0,
    30.0, 60.0)


class Counter:
    """Monotone counter.  ``inc`` only; negative increments raise (a
    decreasing "counter" is a gauge — Prometheus scrapers reset-detect on
    counters, so a decrement would read as a process restart)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        self.value += n

    def get(self) -> float:
        return self.value


class Gauge:
    """Point-in-time value; ``set`` overwrites, ``add`` nudges."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def add(self, n: float = 1.0) -> None:
        self.value += n

    def get(self) -> float:
        return self.value


class Histogram:
    """Fixed-bucket streaming histogram over non-negative observations.

    ``bounds`` are ascending finite bucket *upper* edges; one implicit
    overflow bucket catches everything past the last edge.  Memory is
    bounded at construction time — an observation is a ``bisect`` plus
    two adds, and quantiles read only the bucket counters.
    """

    __slots__ = ("bounds", "counts", "count", "sum")

    def __init__(self, bounds: Sequence[float] = DEFAULT_TIME_BUCKETS_S):
        b = tuple(float(x) for x in bounds)
        if not b:
            raise ValueError("histogram needs at least one bucket bound")
        if any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(f"bucket bounds must be strictly ascending: {b}")
        self.bounds = b
        self.counts = [0] * (len(b) + 1)       # + overflow
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v

    def mean(self) -> Optional[float]:
        return (self.sum / self.count) if self.count else None

    def quantile(self, q: float) -> Optional[float]:
        """Estimate the ``q``-quantile (``0 <= q <= 1``) by linear
        interpolation inside the covering bucket; ``None`` when empty.
        The overflow bucket clamps to the last finite edge (same
        convention as Prometheus ``histogram_quantile``)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if not self.count:
            return None
        rank = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            if cum + c >= rank:
                if i == len(self.bounds):          # overflow bucket
                    return self.bounds[-1]
                lo = self.bounds[i - 1] if i else 0.0
                hi = self.bounds[i]
                return lo + (hi - lo) * max(rank - cum, 0.0) / c
            cum += c
        return self.bounds[-1]

    def bucket_counts(self) -> List[Tuple[float, int]]:
        """Cumulative ``(upper_edge, count)`` pairs, Prometheus ``le``
        style, ending with ``(inf, total)``."""
        out: List[Tuple[float, int]] = []
        cum = 0
        for edge, c in zip(self.bounds, self.counts):
            cum += c
            out.append((edge, cum))
        out.append((float("inf"), self.count))
        return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """One metric name: its type, help text, and labeled series."""

    __slots__ = ("name", "kind", "help", "monitor_name", "series")

    def __init__(self, name: str, kind: str, help: str,
                 monitor_name: Optional[str]):
        self.name = name
        self.kind = kind
        self.help = help
        self.monitor_name = monitor_name
        self.series: Dict[Tuple[Tuple[str, str], ...], Any] = {}


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    body = ",".join(f'{k}="{_escape(v)}"' for k, v in key)
    return "{" + body + "}"


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


_NAME_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:")


class MetricsRegistry:
    """Get-or-create registry of metric families.

    ``counter/gauge/histogram(name, help=..., **labels)`` returns the
    live metric cell for ``(name, labels)`` — the same cell every call,
    so engines fetch once in ``__init__`` and poke the cell on the hot
    path.  Re-registering a name with a different type raises (one name,
    one type: the Prometheus data model, and the bug it catches is two
    subsystems silently sharing a counter).

    ``monitor_name`` (family-level, optional) is the display name
    ``to_events`` emits for a monitor backend — metric names must stay in
    the Prometheus charset, but monitor event names are slash-namespaced
    (``Train/Samples/train_loss``).
    """

    def __init__(self, namespace: str = ""):
        if namespace and any(ch not in _NAME_OK for ch in namespace):
            raise ValueError(f"invalid metric namespace {namespace!r}")
        self.namespace = namespace
        self._families: Dict[str, _Family] = {}
        # registry lock: family/series CREATION and the reader walks
        # (snapshot / prometheus_text / to_events / families) — a reader
        # must not iterate the family dict while another thread registers
        # a new labeled series.  Cell UPDATES (inc/set/observe) stay
        # lock-free: each is a GIL-atomic store on the hot path, and
        # readers tolerate a torn-by-one-observation histogram.  Registry
        # regions are leaves that never take another lock.
        self._reg_lock = threading.Lock()

    # ------------------------------------------------------------- creation
    def _get(self, name: str, kind: str, help: str,
             monitor_name: Optional[str], labels: Dict[str, str],
             **ctor_kwargs):
        with self._reg_lock:
            return self._get_locked(name, kind, help, monitor_name,
                                    labels, **ctor_kwargs)

    def _get_locked(self, name: str, kind: str, help: str,
                    monitor_name: Optional[str], labels: Dict[str, str],
                    **ctor_kwargs):
        if self.namespace and not name.startswith(self.namespace + "_"):
            name = f"{self.namespace}_{name}"
        if any(ch not in _NAME_OK for ch in name) or name[:1].isdigit():
            raise ValueError(f"invalid metric name {name!r}")
        fam = self._families.get(name)
        if fam is None:
            fam = self._families[name] = _Family(name, kind, help,
                                                 monitor_name)
        elif fam.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as a {fam.kind}, "
                f"cannot re-register as a {kind}")
        key = _label_key(labels)
        cell = fam.series.get(key)
        if cell is None:
            cell = fam.series[key] = _KINDS[kind](**ctor_kwargs)
        elif kind == "histogram":
            # same rationale as the kind check: two subsystems silently
            # sharing one histogram under DIFFERENT bucket scales would
            # clamp one side's quantiles to the other's last edge with no
            # error anywhere
            want = tuple(float(x) for x in ctor_kwargs["bounds"])
            if want != cell.bounds:
                raise ValueError(
                    f"histogram {name!r}{dict(key) or ''} already exists "
                    f"with buckets {cell.bounds}, cannot re-request with "
                    f"{want}")
        return cell

    def counter(self, name: str, help: str = "",
                monitor_name: Optional[str] = None, **labels) -> Counter:
        return self._get(name, "counter", help, monitor_name, labels)

    def gauge(self, name: str, help: str = "",
              monitor_name: Optional[str] = None, **labels) -> Gauge:
        return self._get(name, "gauge", help, monitor_name, labels)

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_TIME_BUCKETS_S,
                  help: str = "", monitor_name: Optional[str] = None,
                  **labels) -> Histogram:
        return self._get(name, "histogram", help, monitor_name, labels,
                         bounds=buckets)

    # -------------------------------------------------------------- reading
    def families(self) -> Iterable[_Family]:
        with self._reg_lock:
            return list(self._families.values())

    def _walk(self) -> List[Tuple["_Family", List[Tuple[Any, Any]]]]:
        """Structure snapshot for the reader walks: families and their
        series lists copied under the registry lock (a scrape must not
        iterate dicts a worker thread is inserting into); cell reads
        then happen lock-free outside it."""
        with self._reg_lock:
            return [(fam, list(fam.series.items()))
                    for fam in self._families.values()]

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able view of every series (the ``--emit-metrics`` bench
        artifact and the engine debug surface)."""
        out: Dict[str, Any] = {}
        for fam, fam_series in self._walk():
            series = []
            for key, cell in fam_series:
                entry: Dict[str, Any] = {"labels": dict(key)}
                if fam.kind == "histogram":
                    entry.update({
                        "count": cell.count,
                        "sum": cell.sum,
                        "buckets": [[e, c] for e, c in cell.bucket_counts()
                                    if e != float("inf")],
                        "p50": cell.quantile(0.50),
                        "p95": cell.quantile(0.95),
                        "p99": cell.quantile(0.99),
                    })
                else:
                    entry["value"] = cell.value
                series.append(entry)
            out[fam.name] = {"type": fam.kind, "help": fam.help,
                             "series": series}
        return out

    def snapshot_json(self, indent: int = 2) -> str:
        return json.dumps(self.snapshot(), indent=indent)

    def prometheus_text(self) -> str:
        """Standard Prometheus text exposition (v0.0.4): ``# HELP`` /
        ``# TYPE`` headers, one sample line per series, histogram
        ``_bucket``/``_sum``/``_count`` expansion with cumulative
        ``le`` edges."""
        lines: List[str] = []
        for fam, fam_series in self._walk():
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for key, cell in fam_series:
                if fam.kind == "histogram":
                    for edge, cum in cell.bucket_counts():
                        le = "+Inf" if edge == float("inf") else repr(edge)
                        lk = _label_str(key + (("le", le),))
                        lines.append(f"{fam.name}_bucket{lk} {cum}")
                    ls = _label_str(key)
                    lines.append(f"{fam.name}_sum{ls} {cell.sum}")
                    lines.append(f"{fam.name}_count{ls} {cell.count}")
                else:
                    lines.append(
                        f"{fam.name}{_label_str(key)} {cell.value}")
        return "\n".join(lines) + "\n"

    def to_events(self, step: int) -> List[Tuple[str, float, int]]:
        """``(name, value, step)`` triples for a monitor backend's
        fan-out.  Counters/gauges emit their value under
        ``monitor_name`` (or the metric name); histograms emit
        ``<name>_p50`` / ``_p95`` / ``_count`` scalars.  Labeled series
        suffix their label values onto the name (CSV filenames must stay
        1:1 with series)."""
        events: List[Tuple[str, float, int]] = []
        for fam, fam_series in self._walk():
            base = fam.monitor_name or fam.name
            for key, cell in fam_series:
                name = base + "".join(f"/{v}" for _, v in key)
                if fam.kind == "histogram":
                    if not cell.count:
                        continue
                    events.append((f"{name}_p50", cell.quantile(0.50), step))
                    events.append((f"{name}_p95", cell.quantile(0.95), step))
                    events.append((f"{name}_count", float(cell.count), step))
                else:
                    events.append((name, cell.value, step))
        return events
