"""One CUDA graph capture with Python's cyclic garbage collector held off.

``torch.cuda.graph`` collects garbage before it begins a capture.  A
collection that the captured code's own allocations trigger midway runs
the destructors of whatever it frees on the capturing thread, and one
that calls CUDA (freeing a graph, an event or memory of an earlier
user) invalidates the capture.  The train step's capture failed so
(``cudaErrorStreamCaptureInvalidated``) in a long run of the on-card tests
on an H100, and passed with the collector off.  Every capture of the
port goes through :func:`capture`."""

from __future__ import annotations

import contextlib
import gc

import torch

__all__ = ["capture"]


@contextlib.contextmanager
def capture(graph: torch.cuda.CUDAGraph, pool=None):
    """``torch.cuda.graph(graph, pool, capture_error_mode="thread_local")``
    with automatic garbage collection disabled until the capture ends."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode="thread_local"):
            yield
    finally:
        if enabled:
            gc.enable()
