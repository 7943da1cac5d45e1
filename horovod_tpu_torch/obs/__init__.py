"""Observability: the metrics registry (a copy of the JAX package's),
``xprof`` (FLOPs, peak memory and live MFU) and :func:`training_step`.

The JAX package's request tracing and timeline (``obs/tracing.py``,
``timeline.py``) are not ported yet, so :func:`training_step` observes
metrics and nests no span."""

from __future__ import annotations

import contextlib
import time

from horovod_tpu_torch.obs import registry, xprof  # noqa: F401
from horovod_tpu_torch.obs.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    training_metrics,
)

__all__ = ["registry", "xprof", "Counter", "Gauge", "Histogram",
           "MetricsRegistry", "default_registry", "training_metrics",
           "training_step"]


@contextlib.contextmanager
def training_step(name: str = "train_step"):
    """Span one training step: observes ``training_step_seconds``,
    ``training_steps_total`` and ``training_last_step_seconds`` in the
    default registry and refreshes the live ``training_mfu`` gauge when
    :func:`~horovod_tpu_torch.obs.xprof.set_training_cost` armed it.

    ``name`` names the step's span in the JAX package's timeline; the
    port has no timeline yet, so it is unused.  The wall time is the
    host's: close the step with a read of its result (or a synchronize)
    inside the block, or it measures the launches."""
    m = training_metrics()
    t0 = time.monotonic()
    try:
        yield
    finally:
        dt = time.monotonic() - t0
        m.step_time.observe(dt)
        m.steps.inc()
        m.last_step.set(dt)
        xprof.observe_step(dt, m.mfu)
