"""Runtime correctness tooling of the port (``deepspeed_tpu/analysis/``):

 - :mod:`~deepspeed_tpu_torch.analysis.sentry` — the recompile sentry:
   build counts of the serving engine's logical programs against its
   declared compile budget; ``debug_checks`` raises past it.
 - :mod:`~deepspeed_tpu_torch.analysis.invariants` — the O(blocks)
   paged-state audit run after every scheduler round under
   ``debug_checks``.

The lock-discipline layer (``concurrency``) serves the threaded fleet and
comes with it (ROADMAP Queue A 9); the static lint (``lint``) with the
tooling (Queue A 10).
"""

from .invariants import (PagedStateError, audit_paged_state,
                         audit_serving_engine)
from .sentry import RecompileSentry, RetraceError, backend_compiles

__all__ = ["PagedStateError", "audit_paged_state", "audit_serving_engine",
           "RecompileSentry", "RetraceError", "backend_compiles"]
