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
    * ``tokens_per_tick`` — tokens one tick emitted for a slot (1
      without speculation, 1..k+1 with it); ``spec_drafted`` /
      ``spec_accepted`` / ``spec_wasted`` — draft tokens proposed,
      accepted by the verify, and rejected; ``spec_acceptance`` — the
      accepted share per slot per speculative tick.
    * ``streamed_tokens`` / ``disconnects`` — SSE token events written,
      and streaming clients that hung up (their requests cancelled);
      ``streamed_ttfb`` — request arrival to the first streamed token
      event on the wire.
    * ``model_flops_per_token`` / ``achieved_flops`` — the configured
      model FLOPs a generated token
      (``EngineConfig.model_flops_per_token``) and the achieved model
      FLOP/s over the recent token-rate window (both 0, and ``None`` in
      the snapshot, until configured).
    * ``tuning_*`` — the online autotuner's samples, rollbacks, last and
      best objective (``EngineConfig.autotune``).
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
        self.kv_pages_shared = r.gauge(
            "serving_kv_pages_shared",
            "KV pages referenced by more than one owner "
            "(prefix sharing in effect)")
        self.kv_bytes_per_token = r.gauge(
            "serving_kv_bytes_per_token",
            "KV cache bytes per stored token (k+v across layers, incl. "
            "int8 scales)")
        # Speculative decoding: every active slot observes how many
        # tokens one tick emitted for it, so the speculative engine and
        # the plain one report on the same axis; wasted = drafted -
        # accepted is the draft work that disagreement burned.
        self.tokens_per_tick = r.histogram(
            "serving_tokens_per_tick",
            "Tokens emitted per slot per decode tick (1 without "
            "speculation; 1..K+1 with it)",
            buckets=tuple(float(b) for b in range(1, 18)))
        self.spec_drafted = r.counter(
            "serving_spec_drafted_tokens_total",
            "Draft tokens proposed to the verify kernel")
        self.spec_accepted = r.counter(
            "serving_spec_accepted_tokens_total",
            "Draft tokens the target's greedy verify accepted")
        self.spec_wasted = r.counter(
            "serving_spec_wasted_tokens_total",
            "Draft tokens rejected by the verify (drafted - accepted)")
        self.spec_acceptance = r.histogram(
            "serving_spec_acceptance_ratio",
            "Accepted/drafted ratio per slot per speculative tick",
            buckets=(0.0, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875,
                     1.0))
        self.streamed_tokens = r.counter(
            "serving_streamed_tokens_total",
            "Tokens delivered as SSE token events (stream=true)")
        self.disconnects = r.counter(
            "serving_disconnects_total",
            "Streaming clients that vanished mid-stream (request "
            "cancelled, slot/pages reclaimed within one tick)")
        self.streamed_ttfb = r.histogram(
            "serving_streamed_ttfb_seconds",
            "Request arrival to first streamed token event on the "
            "wire (the honest user-facing TTFT for stream=true)")
        self.model_flops_per_token = r.gauge(
            "serving_model_flops_per_token",
            "Configured model FLOPs per generated token "
            "(EngineConfig.model_flops_per_token; 0 = not configured)")
        self.achieved_flops = r.gauge(
            "serving_achieved_flops_per_sec",
            "Achieved model FLOP/s over the recent token-rate window "
            "(tokens/sec x model_flops_per_token; 0 until configured "
            "and two samples apart)")
        # The online autotuner (tuning/tuner.py): one sample is one knob
        # setting scored over one window of worked ticks.  Registered
        # whether or not a tuner runs, as in the JAX engine.
        self.tuning_samples = r.counter(
            "tuning_samples_total",
            "Knob settings scored by the online autotuner "
            "(one per scoring window, warmup/settling discarded)")
        self.tuning_rollbacks = r.counter(
            "tuning_rollbacks_total",
            "Tuning samples rolled back for violating a per-class "
            "SLO constraint beyond the guard band")
        self.tuning_objective = r.gauge(
            "tuning_objective",
            "Weighted objective of the most recent scored window")
        self.tuning_best_objective = r.gauge(
            "tuning_best_objective",
            "Best constraint-satisfying objective seen this trajectory")

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
            "kv_pages_shared": self.kv_pages_shared.value,
            "kv_bytes_per_token": self.kv_bytes_per_token.value,
            "host_syncs": self.host_syncs.value,
            "host_syncs_per_tick":
                round(self.host_syncs.value / ticks, 4) if ticks else None,
            "tokens_per_tick": self.tokens_per_tick.snapshot(),
            "spec_drafted_tokens": self.spec_drafted.value,
            "spec_accepted_tokens": self.spec_accepted.value,
            "spec_wasted_tokens": self.spec_wasted.value,
            "spec_acceptance_ratio":
                round(self.spec_accepted.value / self.spec_drafted.value,
                      4) if self.spec_drafted.value else None,
            "streamed_tokens": self.streamed_tokens.value,
            "disconnects": self.disconnects.value,
            "streamed_ttfb_seconds": self.streamed_ttfb.snapshot(),
            "model_flops_per_token":
                self.model_flops_per_token.value or None,
            "achieved_flops_per_sec": self.achieved_flops.value or None,
        }
