"""Serving observability: the engine's instrument panel over a private
:class:`~horovod_tpu_torch.obs.registry.MetricsRegistry`.

Counterpart of ``horovod_tpu/serving/metrics.py``, holding the
instruments the port's engine and server update, under the same
``serving_*`` family names and the same ``/stats`` snapshot keys.
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
    * ``engine_failures`` / ``engine_restarts`` — tick failures and
      watchdog stalls, and the supervised restarts that followed.
    * ``resumed`` / ``resume_wasted_tokens`` — in-flight requests
      re-admitted after a restart, and the tokens their re-prefills
      computed a second time; ``preemptions`` — admitted requests
      suspended under slot or page pressure.
    * ``tick_dispatch`` / ``tick_device_wait`` / ``tick_host`` — the
      decode tick's phases: enqueueing the tick's work, blocking on its
      results, and host bookkeeping.
    * ``kv_pages_*`` / ``kv_bytes_per_token`` — page-pool gauges.
    * ``decode_ticks`` / ``host_syncs`` — ticks dispatched and blocking
      fetches on the serving path (``host_syncs_per_tick`` in /stats).
    * ``streamed_tokens`` / ``disconnects`` — SSE token events written,
      and streaming clients that hung up (their requests cancelled).
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
        self.preemptions = r.counter(
            "serving_preemptions_total",
            "Admitted requests suspended under slot/page pressure "
            "(requeued with their journal frontier; output stays "
            "byte-identical)")
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
        self.resumed = r.counter(
            "serving_requests_resumed_total",
            "In-flight requests re-admitted after an engine restart "
            "(journaled decode state; the original future stays live)")
        self.resume_wasted_tokens = r.counter(
            "serving_resume_wasted_tokens",
            "Tokens re-prefilled by resume admissions (prompt + "
            "previously emitted) — the bounded re-work durability costs")
        self.engine_failures = r.counter(
            "serving_engine_failures_total",
            "Tick failures and watchdog stalls")
        self.engine_restarts = r.counter(
            "serving_engine_restarts_total",
            "Successful supervised restarts (slot cache reset in place)")
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
        self.streamed_tokens = r.counter(
            "serving_streamed_tokens_total",
            "Tokens delivered as SSE token events (stream=true)")
        self.disconnects = r.counter(
            "serving_disconnects_total",
            "Streaming clients that vanished mid-stream (request "
            "cancelled, slot/pages reclaimed within one tick)")

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
            "preemptions": self.preemptions.value,
            "token_latency_seconds": self.token_latency.snapshot(),
            "queue_depth": self.queue_depth.value,
            "slot_occupancy": self.slot_occupancy.value,
            "requests_admitted": self.admitted.value,
            "requests_rejected": self.rejected.value,
            "requests_completed": self.completed.value,
            "requests_cancelled": self.cancelled.value,
            "requests_resumed": self.resumed.value,
            "resume_wasted_tokens": self.resume_wasted_tokens.value,
            "tokens_generated": self.tokens_generated.value,
            "engine_failures": self.engine_failures.value,
            "engine_restarts": self.engine_restarts.value,
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
            "streamed_tokens": self.streamed_tokens.value,
            "disconnects": self.disconnects.value,
        }
