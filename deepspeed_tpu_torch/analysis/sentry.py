"""Recompile sentry: build-count enforcement for the compile contracts the
serving engine promises — the port's version of
``deepspeed_tpu/analysis/sentry.py``.

The serving stack's performance story rests on a *compile budget*: a
chunked trace builds exactly 1 prefill + 1 decode program, a speculative
trace at most 3, the bucketed fallback ``len(buckets) + 2`` (ladder +
cache-width preemption fallback + decode).  In the JAX package a program
is a traced XLA computation and the sentry counts traces.  The port
compiles nothing at run time; its unit is the **logical program**, one
``(family, shape)`` — ``("decode", slots[, K])``, ``("prefill", width,
prefill_batch)``, ``("verify", slots, K + 1)``, ``("draft", slots, K)``.
A logical program is *built* on CUDA when its graph is captured (the
decode, verify and draft steps; ``inference/serving.py``), and on the CPU,
or for an eager prefill window, at its first call.  The engine reports
each build here with its shape signature; a second build of one entry (a
graph re-captured after the LRU dropped it, a window width the engine did
not plan for) is contract drift.

In ``strict`` mode (``ServingEngine(debug_checks=True)``) a build beyond
an entry's budget — or beyond the engine's declared total — raises
:class:`RetraceError` naming the entry and diffing its signatures.
Non-strict mode counts: ``retraces_observed`` feeds ``stats()``.

:func:`backend_compiles` returns ``None``, as the JAX function does before
its ``jax.monitoring`` listener is installed: the port has no compiler
event to listen to (its kernels are built by ``nvcc`` before they launch,
``ops/op_builder.py``, and PyTorch's eager ops compile nothing), so the
listener is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


class RetraceError(RuntimeError):
    """A logical program was built past its compile budget."""

    def __init__(self, message: str, name: str = "",
                 signatures: Optional[Sequence[Tuple[str, ...]]] = None):
        super().__init__(message)
        self.name = name
        self.signatures = list(signatures or [])


def signature_diff(prev: Sequence[str], cur: Sequence[str]) -> List[str]:
    """Human-readable diff of two build signatures — only the fields that
    moved (plus arity changes)."""
    out: List[str] = []
    for i in range(max(len(prev), len(cur))):
        a = prev[i] if i < len(prev) else "<absent>"
        b = cur[i] if i < len(cur) else "<absent>"
        if a != b:
            out.append(f"  - {a}\n  + {b}")
    return out or ["  (signatures identical — the program was rebuilt "
                   "for the same shape: a captured graph dropped by the "
                   "LRU and captured again)"]


@dataclasses.dataclass
class _Entry:
    name: str
    budget: Optional[int]               # None = unbudgeted (count only)
    traces: int = 0
    signatures: List[Tuple[str, ...]] = dataclasses.field(
        default_factory=list)

    #: keep previous + current signature only — all any diff ever prints
    _KEEP = 2

    def record(self, sig: Tuple[str, ...]) -> None:
        self.traces += 1
        self.signatures.append(sig)
        if len(self.signatures) > self._KEEP:
            del self.signatures[0]


class RecompileSentry:
    """Per-engine build-count monitor over named logical programs.

    Parameters
    ----------
    name:          label for error messages ("serving", ...).
    strict:        raise :class:`RetraceError` when an entry exceeds its
                   budget or the total exceeds ``total_budget``.  Off:
                   count only.
    total_budget:  engine-wide program ceiling (the <=2/<=3 contracts);
                   ``None`` = per-entry budgets only.
    """

    def __init__(self, name: str = "", strict: bool = False,
                 total_budget: Optional[int] = None):
        self.name = name
        self.strict = bool(strict)
        self.total_budget = total_budget
        self._entries: Dict[str, _Entry] = {}
        #: optional telemetry hook, called with the :class:`_Entry` on
        #: EVERY build (before any strict-mode raise, so a fatal rebuild
        #: still lands on the caller's timeline)
        self.on_trace: Optional[Callable[[_Entry], None]] = None

    # ------------------------------------------------------------- registry
    def register(self, name: str, budget: Optional[int] = 1) -> _Entry:
        """Declare an entry (idempotent — re-registering updates the
        budget and keeps counts)."""
        e = self._entries.get(name)
        if e is None:
            e = self._entries[name] = _Entry(name=name, budget=budget)
        else:
            e.budget = budget
        return e

    def record(self, name: str, signature: Sequence[Any],
               budget: Optional[int] = 1) -> _Entry:
        """Count one build of entry ``name`` (registered on first use with
        ``budget``) with its shape ``signature``; raises in strict mode
        past a budget."""
        entry = self._entries.get(name) or self.register(name, budget)
        entry.record(tuple(str(s) for s in signature))
        if self.on_trace is not None:
            self.on_trace(entry)
        if self.strict:
            over_entry = entry.budget is not None and \
                entry.traces > entry.budget
            over_total = self.total_budget is not None and \
                self.traces > self.total_budget
            if over_entry or over_total:
                raise RetraceError(self._violation(entry, over_entry),
                                   name=entry.name,
                                   signatures=entry.signatures)
        return entry

    def _violation(self, entry: _Entry, over_entry: bool) -> str:
        label = f"{self.name}:{entry.name}" if self.name else entry.name
        if over_entry:
            head = (f"recompile sentry: '{label}' built {entry.traces}x "
                    f"(budget {entry.budget}) — the program is not "
                    "shape-stable")
        else:
            head = (f"recompile sentry: build of '{label}' pushed the "
                    f"engine past its total compile budget "
                    f"({self.traces} > {self.total_budget})")
        if len(entry.signatures) >= 2:
            diff = signature_diff(entry.signatures[-2], entry.signatures[-1])
            head += ("\nsignature diff (previous build -> this build):\n"
                     + "\n".join(diff))
        head += "\nper-entry builds: " + ", ".join(
            f"{e.name}={e.traces}" for e in self._entries.values())
        return head

    # -------------------------------------------------------------- reading
    @property
    def traces(self) -> int:
        return sum(e.traces for e in self._entries.values())

    @property
    def retraces_observed(self) -> int:
        """Builds beyond the declared contract — 0 means every program was
        built exactly as declared.  Counts per-entry overruns and total-
        budget drift; ``max`` of the two so one overrun is never counted
        twice."""
        per_entry = sum(max(0, e.traces - e.budget)
                        for e in self._entries.values()
                        if e.budget is not None)
        over_total = max(0, self.traces - self.total_budget) \
            if self.total_budget is not None else 0
        return max(per_entry, over_total)

    def report(self) -> Dict[str, Dict[str, Any]]:
        return {e.name: {"traces": e.traces, "budget": e.budget}
                for e in self._entries.values()}


def backend_compiles() -> Optional[int]:
    """Backend compiles observed process-wide: always ``None`` in the port
    (module docstring)."""
    return None
