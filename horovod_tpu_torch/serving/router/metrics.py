"""Router observability: the front tier's instrument panel.

Same shape as :class:`~horovod_tpu_torch.serving.metrics.ServingMetrics` —
every instrument lives under a ``router_*`` Prometheus family in a
PRIVATE :class:`~horovod_tpu_torch.obs.registry.MetricsRegistry` (tests and
benchmarks create many routers per process), surfaced verbatim through
the router's ``/stats`` and as text exposition through its
``/metrics``.  Every family is cataloged in docs/observability.md and
linted by ``tests/test_fleet.py::TestMetricsNamingLint``.
"""

from __future__ import annotations

from typing import Dict, Optional

from horovod_tpu_torch.obs.registry import (
    DEFAULT_LATENCY_BUCKETS,
    MetricsRegistry,
)

__all__ = ["RouterMetrics"]


class RouterMetrics:
    """The front tier's counters/gauges/histograms.

    * ``requests`` / ``requests_failed`` — proxied ``/generate``
      requests, and the ones the router could NOT place anywhere
      (attempts exhausted or no replica in rotation) — the
      zero-dropped-requests number to alert on.
    * ``retries`` / ``failovers`` — individual retry attempts after a
      replica failed mid-request, and requests that ultimately
      SUCCEEDED only because of a retry (each one is a request a
      single-replica deployment would have dropped).
    * ``resume_failovers`` — failovers that CONTINUED a partially
      decoded request from its resume descriptor (a replica's typed
      engine-failure response, or a SIGKILL'd replica's journal file)
      instead of re-executing from scratch — each one is paid-for
      prefill/decode work the failover preserved.
    * ``replicas_total`` / ``replicas_in_rotation`` — supervised
      replicas vs. replicas the balancer will actually route to;
      ``total - in_rotation`` is the capacity currently draining,
      respawning, or warming.
    * ``replica_evictions`` — times a replica left rotation (poll
      failure, stale heartbeat, failed/draining state, or a proxy
      marking it dead mid-request).
    * ``replica_restarts`` — supervisor respawns (the serving analogue
      of ``elastic_restarts_total``).
    * ``poll_errors`` — registry polls that failed (connection refused
      / timeout / bad payload); a burst of these around an eviction is
      the normal failure signature.
    * ``drain_timeouts`` — drains that blew through ``shutdown_grace``
      and escalated to SIGKILL (supervisor stop or slot recycle); each
      one means in-flight requests failed over through the journal
      instead of finishing locally.
    * ``proxy_latency`` — wall time of one proxy ATTEMPT (connect +
      replica generate + relay), success or failure.
    * ``rollout_*`` — the fleet-reconfiguration state machine
      (docs/serving.md "Fleet rollouts"): rollouts started /
      promoted / rolled back, replica recycle steps executed, whether
      one is active, and the last canary-vs-incumbent window scores.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        r = registry if registry is not None else MetricsRegistry()
        self.registry = r
        self.requests = r.counter(
            "router_requests_total", "Proxied /generate requests")
        self.requests_failed = r.counter(
            "router_requests_failed_total",
            "Requests the router could not place on any replica "
            "(attempts exhausted or rotation empty)")
        self.retries = r.counter(
            "router_retries_total",
            "Retry attempts after a replica failed mid-request")
        self.failovers = r.counter(
            "router_failovers_total",
            "Requests that succeeded only via retry on another replica")
        self.resume_failovers = r.counter(
            "router_resume_failovers_total",
            "Failovers that resumed a partially decoded request from "
            "its resume descriptor instead of re-executing from scratch")
        self.replicas_total = r.gauge(
            "router_replicas_total", "Replicas under supervision")
        self.replicas_in_rotation = r.gauge(
            "router_replicas_in_rotation",
            "Replicas currently eligible for routing")
        self.replica_evictions = r.counter(
            "router_replica_evictions_total",
            "Times a replica left rotation (stale/failed/unreachable)")
        self.replica_restarts = r.counter(
            "router_replica_restarts_total",
            "Replica processes respawned by the supervisor")
        self.poll_errors = r.counter(
            "router_poll_errors_total",
            "Registry health polls that failed")
        self.drain_timeouts = r.counter(
            "router_drain_timeouts_total",
            "Replica drains that exceeded shutdown_grace and were "
            "escalated to SIGKILL")
        self.rollouts_started = r.counter(
            "rollout_started_total",
            "Fleet rollouts accepted by the controller")
        self.rollout_promotions = r.counter(
            "rollout_promotions_total",
            "Rollouts that promoted the candidate config fleet-wide")
        self.rollout_rollbacks = r.counter(
            "rollout_rollbacks_total",
            "Rollouts rolled back to the incumbent config (canary SLO "
            "breach, crash loop, drain timeout, eviction, or operator "
            "abort)")
        self.rollout_steps = r.counter(
            "rollout_steps_total",
            "Replica recycle steps (drain + rebuild of one slot) "
            "executed by the rollout controller, rollback included")
        self.rollout_active = r.gauge(
            "rollout_active",
            "1 while a rollout (or rollback) is in flight, else 0")
        self.rollout_canary_score = r.gauge(
            "rollout_canary_score",
            "Objective score of the canary's last scoring window")
        self.rollout_incumbent_score = r.gauge(
            "rollout_incumbent_score",
            "Objective score of the incumbent fleet over the same "
            "window the canary was scored on")
        self.proxy_latency = r.histogram(
            "router_proxy_latency_seconds",
            "Wall time of one proxy attempt (connect through relay)",
            buckets=DEFAULT_LATENCY_BUCKETS)

    def snapshot(self) -> Dict:
        return {
            "requests": self.requests.value,
            "requests_failed": self.requests_failed.value,
            "retries": self.retries.value,
            "failovers": self.failovers.value,
            "resume_failovers": self.resume_failovers.value,
            "replicas_total": self.replicas_total.value,
            "replicas_in_rotation": self.replicas_in_rotation.value,
            "replica_evictions": self.replica_evictions.value,
            "replica_restarts": self.replica_restarts.value,
            "poll_errors": self.poll_errors.value,
            "drain_timeouts": self.drain_timeouts.value,
            "rollouts_started": self.rollouts_started.value,
            "rollout_promotions": self.rollout_promotions.value,
            "rollout_rollbacks": self.rollout_rollbacks.value,
            "rollout_steps": self.rollout_steps.value,
            "rollout_active": self.rollout_active.value,
            "rollout_canary_score": self.rollout_canary_score.value,
            "rollout_incumbent_score":
                self.rollout_incumbent_score.value,
            "proxy_latency_seconds": self.proxy_latency.snapshot(),
        }
