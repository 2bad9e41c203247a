"""CUDA-graph capture that Python's garbage collector cannot break.

While a stream is captured in CUDA's global capture mode (PyTorch's
default), some runtime calls are illegal anywhere in the process, and one
of them ends the capture with ``cudaErrorStreamCaptureInvalidated`` at
``capture_end``.  Destroying another graph is one (``cudaGraphExecDestroy``
in ``CUDAGraph``'s destructor, which only warns on failure), and objects
that hold graphs, such as a dropped ``ServingEngine`` with its captured
steps, live in reference cycles that only the cyclic collector frees.  If
an automatic collection runs in the captured body, it frees them there and
the capture fails, on one run in several, as the allocation counts fall.
PyTorch stopped collecting before a capture (``force_cudagraph_gc``), so
:func:`graph_capture` pauses automatic collection for the capture instead:
such garbage is freed at the first collection after it.
"""

from __future__ import annotations

import contextlib
import gc

import torch


@contextlib.contextmanager
def graph_capture(graph, **kwargs):
    """``torch.cuda.graph(graph, **kwargs)`` with automatic garbage
    collection paused from before the capture begins to after it ends;
    the collector's state is restored on the way out, whatever happened."""
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, **kwargs):
            yield
    finally:
        if was_enabled:
            gc.enable()
