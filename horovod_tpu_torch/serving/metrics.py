"""Serving observability: the engine's instrument panel over a private
:class:`~horovod_tpu_torch.obs.registry.MetricsRegistry`.

Counterpart of ``horovod_tpu/serving/metrics.py``, holding the
instruments the paged greedy engine of this slice updates, under the
same ``serving_*`` family names and the same ``/stats`` snapshot keys.
"""

from __future__ import annotations

from typing import Dict, Optional

from horovod_tpu_torch.obs.registry import (
    TICK_PHASE_BUCKETS,
    Histogram,
    MetricsRegistry,
)

__all__ = ["ServingMetrics"]


class ServingMetrics:
    """* ``ttft`` / ``queue_wait`` — submit-to-first-token and
      submit-to-admission latency, ``{class=}``-labeled families.
    * ``token_latency`` — per-token decode-tick latency.
    * ``queue_depth`` / ``slot_occupancy`` — gauges sampled every tick.
    * ``admitted`` / ``rejected`` / ``completed`` / ``cancelled`` —
      request counters; ``tokens_generated`` — tokens emitted.
    * ``engine_failures`` — tick failures (each leaves the engine
      ``failed`` in this slice).
    * ``tick_dispatch`` / ``tick_device_wait`` / ``tick_host`` — the
      decode tick's phases: enqueueing the tick's work, blocking on its
      results, and host bookkeeping.
    * ``kv_pages_*`` / ``kv_bytes_per_token`` — page-pool gauges.
    * ``decode_ticks`` / ``host_syncs`` — ticks dispatched and blocking
      fetches on the serving path.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        r = registry if registry is not None else MetricsRegistry()
        self.registry = r
        self.ttft = r.histogram(
            "serving_ttft_seconds",
            "Submit-to-first-token latency (queueing + prefill), "
            "labeled by SLO priority class", labels=("class",))
        self.queue_wait = r.histogram(
            "serving_queue_wait_seconds",
            "Submit-to-admission latency, labeled by SLO priority class",
            labels=("class",))
        self.token_latency = r.histogram(
            "serving_token_latency_seconds",
            "Per-token decode-tick latency (dispatch to host fetch)")
        self.queue_depth = r.gauge(
            "serving_queue_depth", "Requests queued awaiting admission")
        self.slot_occupancy = r.gauge(
            "serving_slot_occupancy", "Active slots / total slots")
        self.admitted = r.counter(
            "serving_requests_admitted_total", "Requests admitted to slots")
        self.rejected = r.counter(
            "serving_requests_rejected_total",
            "Typed rejections (queue-full, deadline, too-long)")
        self.completed = r.counter(
            "serving_requests_completed_total",
            "Requests retired with tokens (eos/length/capacity/deadline)")
        self.cancelled = r.counter(
            "serving_requests_cancelled_total",
            "Requests cancelled caller-side")
        self.tokens_generated = r.counter(
            "serving_tokens_generated_total", "Tokens emitted to futures")
        self.engine_failures = r.counter(
            "serving_engine_failures_total", "Tick failures")
        self.tick_dispatch = r.histogram(
            "serving_tick_dispatch_seconds",
            "Time to enqueue one decode tick's device work",
            buckets=TICK_PHASE_BUCKETS)
        self.tick_device_wait = r.histogram(
            "serving_tick_device_wait_seconds",
            "Host-visible wait fetching a tick's results",
            buckets=TICK_PHASE_BUCKETS)
        self.tick_host = r.histogram(
            "serving_tick_host_seconds",
            "Host bookkeeping per tick (emit/retire)",
            buckets=TICK_PHASE_BUCKETS)
        self.decode_ticks = r.counter(
            "serving_decode_ticks_total", "Decode ticks dispatched")
        self.host_syncs = r.counter(
            "serving_host_syncs_total",
            "Host sync points (blocking value fetches) on the serving path")
        self.kv_pages_total = r.gauge(
            "serving_kv_pages_total", "KV page pool size")
        self.kv_pages_free = r.gauge(
            "serving_kv_pages_free",
            "KV pages on the free heap (admission headroom)")
        self.kv_bytes_per_token = r.gauge(
            "serving_kv_bytes_per_token",
            "KV cache bytes per stored token (k+v across layers, incl. "
            "int8 scales)")

    def observe_ttft(self, priority: str, v: float) -> None:
        self.ttft.labels(**{"class": priority}).observe(v)

    def observe_queue_wait(self, priority: str, v: float) -> None:
        self.queue_wait.labels(**{"class": priority}).observe(v)

    @staticmethod
    def _merged(family) -> Dict:
        """Class-merged histogram snapshot, rebuilt bucket-wise from the
        labeled children (they share the default bucket edges)."""
        h = Histogram()
        for _, child in family.children():
            st = child.state()
            h._counts = [a + b for a, b in zip(h._counts, st["counts"])]
            h._sum += st["sum"]
            h._count += st["count"]
        return h.snapshot()

    @staticmethod
    def _by_class(family) -> Dict:
        return {key[0]: child.snapshot()
                for key, child in family.children()}

    def snapshot(self) -> Dict:
        ticks = self.decode_ticks.value
        return {
            "ttft_seconds": self._merged(self.ttft),
            "ttft_seconds_by_class": self._by_class(self.ttft),
            "queue_wait_seconds_by_class": self._by_class(self.queue_wait),
            "token_latency_seconds": self.token_latency.snapshot(),
            "queue_depth": self.queue_depth.value,
            "slot_occupancy": self.slot_occupancy.value,
            "requests_admitted": self.admitted.value,
            "requests_rejected": self.rejected.value,
            "requests_completed": self.completed.value,
            "requests_cancelled": self.cancelled.value,
            "tokens_generated": self.tokens_generated.value,
            "engine_failures": self.engine_failures.value,
            "tick_dispatch_seconds": self.tick_dispatch.snapshot(),
            "tick_device_wait_seconds": self.tick_device_wait.snapshot(),
            "tick_host_seconds": self.tick_host.snapshot(),
            "decode_ticks": ticks,
            "kv_pages_total": self.kv_pages_total.value,
            "kv_pages_free": self.kv_pages_free.value,
            "kv_bytes_per_token": self.kv_bytes_per_token.value,
            "host_syncs": self.host_syncs.value,
            "host_syncs_per_tick":
                round(self.host_syncs.value / ticks, 4) if ticks else None,
        }
