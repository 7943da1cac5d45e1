"""Observability: the metrics registry, request tracing and the
timeline, the fleet view, ``xprof`` and :func:`training_step` — the JAX
package's ``obs`` with the same exports.

* :mod:`~horovod_tpu_torch.obs.registry` — typed process-wide metrics
  with Prometheus text exposition.  Serving engines keep private
  registries; training, elastic and timeline metrics live in
  :func:`~horovod_tpu_torch.obs.registry.default_registry`.
* :mod:`~horovod_tpu_torch.obs.tracing` — per-request trace and span
  ids (``X-Trace-Id``, ``X-Parent-Span``, ``X-Trace-Sampled``) through
  submit, prefill, decode and retirement, a timing breakdown in every
  ``/generate`` reply, a JSONL event log, the span stream that
  :mod:`~horovod_tpu_torch.obs.trace_store` assembles into trees, and
  request spans, tick phases and lifecycle instants (captures, engine
  restarts, watchdog stalls) on the :class:`~horovod_tpu_torch.
  timeline.Timeline` writer.
* :mod:`~horovod_tpu_torch.obs.aggregate` / :mod:`~horovod_tpu_torch.
  obs.fleet` — per-rank exports merged into one fleet view, stragglers
  and skew.
* :mod:`~horovod_tpu_torch.obs.xprof` — FLOPs, peak memory, live MFU.
* :func:`training_step` — the training-side span.

    from horovod_tpu_torch import obs
    obs.tracing.start("/tmp/trace.json", jsonl_path="/tmp/trace.jsonl")
    for batch in data:
        with obs.training_step():
            loss = step(params, batch).item()
"""

from __future__ import annotations

import contextlib
import time

from horovod_tpu_torch.obs import (  # noqa: F401
    aggregate,
    fleet,
    registry,
    trace_store,
    tracing,
    xprof,
)
from horovod_tpu_torch.obs.registry import (  # noqa: F401
    Counter,
    DuplicateMetricError,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    elastic_metrics,
    training_metrics,
)
from horovod_tpu_torch.obs.trace_store import TraceStore  # noqa: F401
from horovod_tpu_torch.obs.tracing import (  # noqa: F401
    PARENT_SPAN_HEADER,
    SAMPLED_HEADER,
    TRACE_ID_HEADER,
    RequestTrace,
    SpanRecorder,
    SpanSampling,
    Tracer,
    mint_span_id,
    mint_trace_id,
    record_compile,
)

__all__ = [
    "aggregate", "fleet", "registry", "trace_store", "tracing", "xprof",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "DuplicateMetricError", "default_registry",
    "training_metrics", "elastic_metrics",
    "TRACE_ID_HEADER", "PARENT_SPAN_HEADER", "SAMPLED_HEADER",
    "RequestTrace", "Tracer", "SpanRecorder", "SpanSampling",
    "TraceStore", "mint_trace_id", "mint_span_id",
    "record_compile", "training_step",
]


@contextlib.contextmanager
def training_step(name: str = "train_step"):
    """Span one training step: observes ``training_step_seconds``,
    ``training_steps_total`` and ``training_last_step_seconds`` in the
    default registry, refreshes the live ``training_mfu`` gauge when
    :func:`~horovod_tpu_torch.obs.xprof.set_training_cost` armed it,
    and, when a timeline is recording, nests a ``name`` span (category
    ``"training"``) onto the time axis of the serving request spans.

    The wall time is the host's: close the step with a read of its
    result (or a synchronize) inside the block, or it measures the
    launches."""
    m = training_metrics()
    from horovod_tpu_torch import timeline as TL

    tl = TL.get()
    t0 = time.monotonic()
    if tl is not None:
        tl.begin(name, "training")
    try:
        yield
    finally:
        dt = time.monotonic() - t0
        if tl is not None:
            tl.end(name)
        m.step_time.observe(dt)
        m.steps.inc()
        m.last_step.set(dt)
        xprof.observe_step(dt, m.mfu)
