"""Observability: the metrics registry (a copy of the JAX package's)."""

from horovod_tpu_torch.obs.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
