"""Per-request trace timeline: a bounded host-side ring buffer of engine
events, exportable as Chrome ``trace_event`` JSON (Perfetto-viewable) — the
port's copy of ``deepspeed_tpu/telemetry/trace.py``.

``ServingEngine.stats()`` aggregates; it cannot answer "where did THIS
slow request spend its time".  The timeline records one small dict per
scheduler event — admit, prefill window, decode step, spec propose /
verify / accept, prefix hit, block eviction, preemption, cancel, drain,
finish, plus the recompile sentry's build events and the per-iteration
invariant audits — into a ``deque(maxlen=capacity)``: bounded memory, O(1)
append, and a ``dropped`` counter that says how much history fell off the
ring.  ``capacity=0`` disables recording (one predicate per would-be
event).

**What a span measures on the card.**  Every span is host time between
two ``perf_counter`` readings.  A span that ends at a device sync covers
the device work launched inside it; one that does not covers only the
launches.  In ``inference/serving.py``:

 - ``prefill`` ends at a sync: the window's first tokens are read back
   (``.cpu()``) inside it;
 - ``decode`` ends at a sync: the captured step's ``[slots, K]`` tokens
   are read back inside it;
 - ``spec_verify`` ends at a sync: the round's ``[5, slots, K+1]`` output
   is read back inside it, so it also covers the draft rollout that
   ``spec_propose`` launched;
 - ``spec_propose`` does NOT end at a sync: with a draft model it covers
   the rollout's launches only (its device time lands in ``spec_verify``),
   with the n-gram proposer it is host work alone.

Device time per kernel comes from :class:`ProfilerWindow` (``torch.profiler``
with CUDA activity), not from these spans.

Export (:meth:`TraceTimeline.to_chrome` / :meth:`dump`) follows the
Chrome ``trace_event`` JSON-object format: ``X`` (complete) events carry
``ts``+``dur``, ``i`` (instant) events just ``ts``, ``s``/``f`` flow
events carry a shared ``id`` and render as arrows between lanes, every
event has ``pid``/``tid``, timestamps are microseconds since the timeline
epoch and sorted ascending, and ``M`` metadata events name the process
and each registered thread lane.  Load the file at https://ui.perfetto.dev
(or ``chrome://tracing``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

from ..utils.logging import logger

__all__ = ["TraceTimeline", "ProfilerWindow", "validate_chrome_trace"]

#: tid of the shared scheduler lane (request lanes are allocated upward)
SCHEDULER_TID = 0


class TraceTimeline:
    """Bounded ring buffer of trace events with Chrome export.

    Parameters
    ----------
    capacity:  max events retained (oldest evicted first; ``dropped``
               counts evictions).  ``0`` disables recording — every emit
               is one ``if`` and the buffer stays empty.
    pid:       the exported ``pid`` (multi-process launchers pass
               their process rank so merged traces stay distinct).
    clock:     second-denominated monotonic clock (injectable for tests).
    """

    def __init__(self, capacity: int = 16384, pid: int = 0, clock=None):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        self.capacity = int(capacity)
        self.enabled = self.capacity > 0
        self.pid = int(pid)
        self._clock = clock or time.perf_counter
        self._t0 = self._clock()
        self._events: deque = deque(maxlen=max(self.capacity, 1))
        self.emitted = 0
        self.dropped = 0
        self._thread_names: Dict[int, str] = {SCHEDULER_TID: "scheduler"}
        self._next_tid = 1
        # lane allocation is check-then-act (look up name, else mint a
        # tid) and runs off the hot path, so it takes a lock; the emit
        # path stays lock-free on purpose — deque appends are GIL-atomic
        # and the ring tolerates interleaved emitters (the router
        # timeline is written by worker threads AND the caller thread)
        self._names_lock = threading.Lock()

    # ------------------------------------------------------------------ time
    def now_us(self) -> float:
        """Microseconds since the timeline epoch (event ``ts`` domain)."""
        return (self._clock() - self._t0) * 1e6

    @property
    def epoch_s(self) -> float:
        """The timeline's epoch on its own clock — rings recorded in one
        process share a clock, so a merge of rings re-bases every
        ring's ``ts`` onto the earliest epoch."""
        return self._t0

    # --------------------------------------------------------------- threads
    def thread(self, name: str) -> int:
        """Allocate (or look up) a named lane; returns its ``tid``.
        Lanes are for small, fixed sets (the serving engine allocates one
        per SLOT at construction — request spans land on the slot that
        finished them), never per-request values: every lane is a
        name-table entry and a Perfetto row forever."""
        with self._names_lock:
            for tid, n in self._thread_names.items():
                if n == name:
                    return tid
            tid = self._next_tid
            self._next_tid += 1
            self._thread_names[tid] = name
            return tid

    # ---------------------------------------------------------------- emits
    def _push(self, ev: Dict[str, Any]) -> None:
        if len(self._events) == self._events.maxlen:
            self.dropped += 1
        self._events.append(ev)
        self.emitted += 1

    def instant(self, name: str, tid: int = SCHEDULER_TID,
                ts: Optional[float] = None, **args) -> None:
        """One ``i`` (instant) event."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "i", "s": "t",
              "ts": self.now_us() if ts is None else ts,
              "pid": self.pid, "tid": tid}
        if args:
            ev["args"] = args
        self._push(ev)

    def complete(self, name: str, start_us: float,
                 tid: int = SCHEDULER_TID, end_us: Optional[float] = None,
                 **args) -> None:
        """One ``X`` (complete) event spanning ``[start_us, end_us]``
        (``end_us`` defaults to now)."""
        if not self.enabled:
            return
        end = self.now_us() if end_us is None else end_us
        ev = {"name": name, "ph": "X", "ts": start_us,
              "dur": max(end - start_us, 0.0),
              "pid": self.pid, "tid": tid}
        if args:
            ev["args"] = args
        self._push(ev)

    def flow_start(self, name: str, flow_id: int,
                   tid: int = SCHEDULER_TID, ts: Optional[float] = None,
                   **args) -> None:
        """One ``s`` (flow start) event.  Chrome flow events with the same
        ``id`` render as an arrow between lanes — even across ``pid``s in
        a merged multi-replica document — which is how a routed request's
        router span links to its replica admission, and a cross-replica
        KV pull links its source lane to its target lane.  Callers must
        allocate ``flow_id`` uniquely across every ring that will be
        merged (the ``ReplicaRouter`` owns one counter for the fleet)."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "s", "cat": "flow", "id": int(flow_id),
              "ts": self.now_us() if ts is None else ts,
              "pid": self.pid, "tid": tid}
        if args:
            ev["args"] = args
        self._push(ev)

    def flow_end(self, name: str, flow_id: int,
                 tid: int = SCHEDULER_TID, ts: Optional[float] = None,
                 **args) -> None:
        """One ``f`` (flow finish) event — the arrowhead of the matching
        :meth:`flow_start`.  ``bp: "e"`` binds it to the enclosing slice
        (Chrome's "bind to enclosing" convention)."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "f", "cat": "flow", "bp": "e",
              "id": int(flow_id),
              "ts": self.now_us() if ts is None else ts,
              "pid": self.pid, "tid": tid}
        if args:
            ev["args"] = args
        self._push(ev)

    @contextmanager
    def span(self, name: str, tid: int = SCHEDULER_TID, **args):
        """Context manager emitting an ``X`` event around the body; the
        body can mutate ``args`` in place (accept-lengths are known only
        after the verify pass returns)."""
        if not self.enabled:
            yield args
            return
        start = self.now_us()
        try:
            yield args
        finally:
            self.complete(name, start, tid=tid, **args)

    # ---------------------------------------------------------------- export
    def __len__(self) -> int:
        return len(self._events) if self.enabled else 0

    def events(self) -> List[Dict[str, Any]]:
        """Live events, oldest first (the ring view — NOT yet sorted)."""
        return list(self._events) if self.enabled else []

    def to_chrome(self, process_name: str = "deepspeed_tpu") -> Dict[str, Any]:
        """Chrome ``trace_event`` JSON-object document: ``M`` metadata
        naming the process and lanes, then every ring event sorted by
        ``ts`` ascending."""
        meta: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "ts": 0.0,
            "pid": self.pid, "tid": SCHEDULER_TID,
            "args": {"name": process_name},
        }]
        with self._names_lock:
            lanes = sorted(self._thread_names.items())
        for tid, name in lanes:
            meta.append({"name": "thread_name", "ph": "M", "ts": 0.0,
                         "pid": self.pid, "tid": tid,
                         "args": {"name": name}})
        body = sorted(self.events(), key=lambda e: e["ts"])
        return {"traceEvents": meta + body,
                "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped,
                              "emitted_events": self.emitted}}

    def dump(self, path: str, process_name: str = "deepspeed_tpu") -> str:
        """Write the Chrome trace JSON to ``path``; returns ``path``
        (open it at https://ui.perfetto.dev)."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(process_name), f)
        return path


def validate_chrome_trace(doc: Dict[str, Any],
                          strict_flows: Optional[bool] = None
                          ) -> Dict[str, Any]:
    """Schema-check an exported Chrome ``trace_event`` document; raises
    :class:`ValueError` naming the first violation, returns a summary.

    Checked (the contract the serving bench records and the telemetry
    tests pin): ``traceEvents`` is a list; every event carries ``name`` /
    ``ph`` / ``ts`` / ``pid`` / ``tid``; phases are ``M``/``i``/``X``/
    ``B``/``E``/``s``/``f`` with ``X`` events carrying a non-negative
    ``dur``, ``B``/``E`` balanced per ``(pid, tid)``, ``s``/``f`` flow
    events carrying an ``id``; non-metadata timestamps are monotone
    non-decreasing (sorted export).

    ``strict_flows`` additionally requires every flow to PAIR — each
    finish follows a start with the same id, no start dangles.  Default
    ``None`` auto-enables it for merged multi-source documents
    (``otherData.sources``, the ``merge_chrome_traces`` marker) and
    leaves single rings lenient: one replica's ring legitimately holds
    only its half of a cross-ring flow (the router holds the other), so
    strict pairing is a whole-fleet property.  Unpaired flows are
    counted in ``flow_unmatched`` either way (in a merged document a
    nonzero count means the other end was never emitted or fell off a
    ring — check ``dropped_events``).

    Disaggregated ``handoff`` instants pair the same way per ``uid``:
    the prefill engine emits its half first (args carry ``slot``), the
    router's pump emits the routing half second (args carry
    ``src``/``dst``), so a router-side handoff with no preceding
    engine-side one is a fabricated hop — an error under strict, else
    counted.  An engine-side handoff with no router half is a PARKED
    request the pump has not collected yet (legal at dump time) and
    only counts in ``handoff_unmatched``.  Summary counts let callers
    assert content (e.g. per-request span count, cross-replica flow
    count) without re-walking."""
    if strict_flows is None:
        strict_flows = bool(doc.get("otherData", {}).get("sources"))
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        raise ValueError("traceEvents must be a non-empty list")
    last_ts = None
    open_spans: Dict[tuple, int] = {}
    flow_started: Dict[Any, int] = {}      # flow id -> finish count
    handoff_parked: Dict[Any, int] = {}    # uid -> unconsumed engine half
    summary = {"events": len(events), "complete": 0, "instant": 0,
               "metadata": 0, "request_spans": 0, "flow_starts": 0,
               "flow_ends": 0, "flow_unmatched": 0, "handoffs": 0,
               "handoff_unmatched": 0}
    orphan_ends = 0
    orphan_handoffs = 0
    for i, e in enumerate(events):
        for field in ("name", "ph", "ts", "pid", "tid"):
            if field not in e:
                raise ValueError(f"event {i} ({e.get('name')!r}) is "
                                 f"missing {field!r}")
        ph = e["ph"]
        if ph not in ("M", "i", "X", "B", "E", "s", "f"):
            raise ValueError(f"event {i} has unknown phase {ph!r}")
        if ph == "M":
            summary["metadata"] += 1
            continue
        if last_ts is not None and e["ts"] < last_ts:
            raise ValueError(
                f"event {i} ts {e['ts']} < previous {last_ts} — export "
                "must be sorted")
        last_ts = e["ts"]
        if ph == "X":
            if e.get("dur", -1) < 0:
                raise ValueError(
                    f"complete event {i} ({e['name']!r}) lacks a "
                    "non-negative dur")
            summary["complete"] += 1
            if str(e["name"]).startswith("req "):
                summary["request_spans"] += 1
        elif ph == "i":
            summary["instant"] += 1
            if e["name"] == "handoff":
                args = e.get("args", {})
                uid = args.get("uid")
                if "src" in args or "dst" in args:     # router pump half
                    summary["handoffs"] += 1
                    if handoff_parked.get(uid, 0) > 0:
                        handoff_parked[uid] -= 1
                    elif strict_flows:
                        raise ValueError(
                            f"event {i}: router handoff for uid {uid!r} "
                            "without a preceding engine-side handoff — "
                            "a request was routed off a prefill replica "
                            "that never parked it")
                    else:
                        orphan_handoffs += 1
                else:                                  # engine park half
                    handoff_parked[uid] = handoff_parked.get(uid, 0) + 1
        elif ph == "B":
            key = (e["pid"], e["tid"])
            open_spans[key] = open_spans.get(key, 0) + 1
        elif ph == "E":
            key = (e["pid"], e["tid"])
            if not open_spans.get(key):
                raise ValueError(
                    f"event {i}: E without a matching B on lane {key}")
            open_spans[key] -= 1
        elif ph in ("s", "f"):
            if "id" not in e:
                raise ValueError(
                    f"flow event {i} ({e['name']!r}) is missing 'id'")
            if ph == "s":
                flow_started.setdefault(e["id"], 0)
                summary["flow_starts"] += 1
            else:
                if e["id"] not in flow_started:
                    if strict_flows:
                        raise ValueError(
                            f"event {i}: flow finish 'f' (id {e['id']!r}) "
                            "without a preceding flow start 's'")
                    orphan_ends += 1
                else:
                    flow_started[e["id"]] += 1
                summary["flow_ends"] += 1
    dangling = {k: v for k, v in open_spans.items() if v}
    if dangling:
        raise ValueError(f"unclosed B spans on lanes {dangling}")
    unfinished = [fid for fid, ends in flow_started.items() if not ends]
    if unfinished and strict_flows:
        raise ValueError(f"flow start(s) without a finish: {unfinished}")
    summary["flow_unmatched"] = orphan_ends + len(unfinished)
    # engine-side handoffs never pumped are legitimately parked (tolerated
    # even under strict — a dump can land mid-park), but they are visible:
    summary["handoff_unmatched"] = orphan_handoffs + \
        sum(handoff_parked.values())
    return summary


class ProfilerWindow:
    """Idempotent ``torch.profiler`` bracket around N engine iterations.

    ``start()`` opens a profiler (CPU activity, plus CUDA activity when
    ``cuda`` is set and a GPU is present); ``stop()`` closes it and exports
    the bracketed region as a Chrome trace,
    ``profile_dir/serving.<pid>.<ns>.pt.trace.json`` (``path`` after the
    stop).  Device kernels appear there by name with
    their device durations.  Both degrade to logged warnings when the
    profiler is unavailable or already active (nested windows) —
    profiling never fails the serving loop.
    """

    def __init__(self, profile_dir: str, cuda: bool = True):
        self.profile_dir = str(profile_dir)
        self.cuda = bool(cuda)
        self.path: Optional[str] = None
        self.active = False
        self._prof = None

    def start(self) -> bool:
        if self.active:
            return True
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.cuda and torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            os.makedirs(self.profile_dir, exist_ok=True)
            prof = profile(activities=acts)
            prof.start()
            self._prof = prof
            self.active = True
        except Exception as e:  # unavailable profiler / nested window
            logger.warning(f"torch.profiler window not started: {e}")
        return self.active

    def stop(self) -> None:
        if not self.active:
            return
        self.active = False
        prof, self._prof = self._prof, None
        try:
            if self.cuda:
                import torch

                if torch.cuda.is_available():
                    torch.cuda.synchronize()
            prof.stop()
            path = os.path.join(
                self.profile_dir,
                f"serving.{os.getpid()}.{time.time_ns()}.pt.trace.json")
            prof.export_chrome_trace(path)
            self.path = path
        except Exception as e:
            logger.warning(f"torch.profiler window not stopped cleanly: {e}")
