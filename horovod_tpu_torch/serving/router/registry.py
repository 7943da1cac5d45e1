"""ReplicaRegistry: the live routing set, maintained by health polls.

The registry is the router's single source of truth about replicas.
The supervisor :meth:`ReplicaRegistry.add`/:meth:`remove`\\ s endpoints
as it spawns and reaps processes; a poll thread GETs each replica's
``/stats`` every ``poll_interval`` seconds and keeps a
:class:`ReplicaStatus` per endpoint from the snapshot's four stable
contract keys (docs/serving.md "HTTP API"):

* ``queue_depth`` (int) and ``occupancy`` (float) — what
  join-shortest-queue balances on;
* ``engine_state`` — only ``healthy``/``degraded`` replicas are
  routable; ``draining``/``failed`` leave rotation within one poll;
* ``heartbeat_age_s`` (float; ``-1.0`` = no tick completed yet) —
  a replica whose engine stopped ticking for ``heartbeat_stale``
  seconds is wedged even if its HTTP thread still answers, and leaves
  rotation; a fresh replica that NEVER ticks gets ``startup_grace``
  from the moment it is added before the same judgment.

The contract also carries two INFORMATIONAL typed keys — ``tp`` (the
replica's tensor-parallel degree) and ``mesh`` (its device layout;
docs/serving.md "Tensor-parallel replicas") — surfaced per replica in
the router's ``/stats`` fleet view but never routed on: a tp=K
replica is one queue like any other.

``fail_threshold`` consecutive poll failures (connection refused,
timeout, garbage payload) also evict — a SIGKILL'd replica stops
answering long before anyone inspects its exit code.  The proxy path
can evict faster still with :meth:`mark_failed` (a failed ``/generate``
connection is fresher evidence than the last poll).  Re-admission has
HYSTERESIS: an evicted replica needs ``readmit_threshold`` (default 2)
CONSECUTIVE good polls before it rejoins rotation, so a flapping
replica — one that answers every other poll — stays out instead of
oscillating in and out every ``poll_interval``.  A replica that was
never evicted (failures below threshold, never marked) is unaffected:
one good poll still clears a transient blip.

The contract's ``config_generation`` key (an opaque int label stamped
by the supervisor at spawn; docs/serving.md "Fleet rollouts") is
tracked per replica so the rollout controller can verify fleet
convergence — like ``tp``/``mesh`` it is never routed on.

:meth:`pick` implements join-shortest-queue: least ``queue_depth``,
then least ``occupancy``, round-robin among ties so equally idle
replicas share load instead of dogpiling the lowest id.  During a
rollout, :meth:`set_canary` overlays a deterministic weighted split:
the canary replica receives exactly ``weight`` of picks (a credit
accumulator, no RNG) and everyone else splits the rest by JSQ.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional

from horovod_tpu_torch.serving.router.metrics import RouterMetrics

logger = logging.getLogger("horovod_tpu_torch")

__all__ = ["ReplicaEndpoint", "ReplicaRegistry", "ReplicaStatus"]

ROUTABLE_STATES = ("healthy", "degraded")


@dataclasses.dataclass(frozen=True)
class ReplicaEndpoint:
    """Where one replica listens.  ``rid`` is unique per PROCESS
    generation (``r<slot>g<gen>`` from the supervisor) so a respawn is
    a new endpoint with fresh poll state, never a stale carryover.

    ``journal_path`` is the replica's request-journal file when the
    supervisor armed one (``--journal``): the router reads it
    POST-MORTEM after a connection-level death to resume the dead
    replica's in-flight requests elsewhere — part of the routing
    contract, like the four ``/stats`` keys."""

    rid: str
    host: str
    port: int
    journal_path: Optional[str] = None

    @property
    def base_url(self) -> str:
        return f"http://{self.host}:{self.port}"


@dataclasses.dataclass
class ReplicaStatus:
    """Last known health of one replica, as the poll thread saw it."""

    endpoint: ReplicaEndpoint
    queue_depth: int = 0
    occupancy: float = 0.0
    engine_state: str = "unknown"
    heartbeat_age_s: float = -1.0
    # Serving topology (docs/serving.md "Tensor-parallel replicas"):
    # the replica's tensor-parallel degree and mesh layout, surfaced
    # from the /stats contract's typed tp/mesh keys so operators (and
    # capacity planners reading the router's per-replica view) can
    # tell one tp=K replica from K tp=1 replicas.  Informational —
    # routing still balances on queue_depth/occupancy alone.
    tp: int = 1
    mesh: str = ""
    # Which config generation this replica was built at (stamped by the
    # supervisor via --config-gen, echoed through /stats).  The rollout
    # controller reads it to prove fleet convergence; routing ignores it.
    config_gen: int = 0
    added_at: float = 0.0
    last_ok: Optional[float] = None     # monotonic time of last good poll
    consecutive_failures: int = 0
    consecutive_ok: int = 0             # good polls since last failure/mark
    marked_failed: bool = False         # proxy-side eviction flag
    mark_seq: int = 0                   # bumped per mark_failed (race guard)
    ever_routable: bool = False
    polls: int = 0

    def as_dict(self) -> Dict:
        return {
            "rid": self.endpoint.rid,
            "url": self.endpoint.base_url,
            "queue_depth": self.queue_depth,
            "occupancy": self.occupancy,
            "engine_state": self.engine_state,
            "heartbeat_age_s": self.heartbeat_age_s,
            "tp": self.tp,
            "mesh": self.mesh,
            "config_generation": self.config_gen,
            "consecutive_poll_failures": self.consecutive_failures,
            "marked_failed": self.marked_failed,
            "polls": self.polls,
        }


class ReplicaRegistry:
    """Thread-safe routing set over polled replica health.

    ``poll_interval`` bounds eviction latency (a dead replica leaves
    rotation within one interval plus ``fail_threshold - 1`` extra
    polls); ``poll_timeout`` bounds how long one wedged replica can
    delay the sweep.  Polls run sequentially in one daemon thread —
    the front tier targets a handful of replicas, not hundreds.
    """

    def __init__(self, *, poll_interval: float = 0.25,
                 poll_timeout: float = 2.0,
                 fail_threshold: int = 2,
                 readmit_threshold: int = 2,
                 heartbeat_stale: float = 60.0,
                 startup_grace: Optional[float] = None,
                 metrics: Optional[RouterMetrics] = None) -> None:
        if fail_threshold < 1:
            raise ValueError("fail_threshold must be >= 1")
        if readmit_threshold < 1:
            raise ValueError("readmit_threshold must be >= 1")
        self.poll_interval = poll_interval
        self.poll_timeout = poll_timeout
        self.fail_threshold = fail_threshold
        self.readmit_threshold = readmit_threshold
        self.heartbeat_stale = heartbeat_stale
        # A cold replica pays imports + XLA compiles before its first
        # tick; give it the stale budget (or more) before calling a
        # -1.0 heartbeat "wedged".
        self.startup_grace = (startup_grace if startup_grace is not None
                              else max(heartbeat_stale, 60.0))
        self.metrics = metrics if metrics is not None else RouterMetrics()
        self._lock = threading.Lock()
        self._status: Dict[str, ReplicaStatus] = {}
        self._rr = 0  # round-robin tiebreak cursor
        # Canary overlay (rollout controller): while set, pick() routes
        # exactly `weight` of requests to the canary rid via a credit
        # accumulator and JSQ-balances the rest across the incumbents.
        self._canary_rid: Optional[str] = None
        self._canary_weight = 0.0
        self._canary_credit = 0.0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- membership (supervisor-driven) -----------------------------------

    def add(self, endpoint: ReplicaEndpoint) -> None:
        with self._lock:
            if endpoint.rid in self._status:
                raise ValueError(f"replica {endpoint.rid} already registered")
            self._status[endpoint.rid] = ReplicaStatus(
                endpoint=endpoint, added_at=time.monotonic())
            self.metrics.replicas_total.set(len(self._status))

    def remove(self, rid: str) -> None:
        with self._lock:
            self._status.pop(rid, None)
            self.metrics.replicas_total.set(len(self._status))
            self.metrics.replicas_in_rotation.set(
                sum(1 for s in self._status.values()
                    if self._routable(s)))

    def mark_failed(self, rid: str) -> None:
        """Proxy-side eviction: a /generate attempt to this replica
        just failed at the connection level.  Takes effect immediately;
        ``readmit_threshold`` consecutive successful polls re-admit."""
        with self._lock:
            st = self._status.get(rid)
            if st is None or st.marked_failed:
                return
            if self._routable(st):
                self.metrics.replica_evictions.inc()
                self._instant("replica_evicted",
                              {"rid": rid, "reason": "proxy_failure"})
            st.marked_failed = True
            st.mark_seq += 1
            st.consecutive_ok = 0
            self.metrics.replicas_in_rotation.set(
                sum(1 for s in self._status.values()
                    if self._routable(s)))

    # -- canary overlay (rollout controller) -------------------------------

    def set_canary(self, rid: str, weight: float) -> None:
        """Route exactly ``weight`` (0..1) of picks to ``rid`` while it
        is routable and at least one other replica is too; the rest go
        through normal JSQ over the incumbents.  Deterministic: a
        credit accumulator, not a coin flip, so a scoring window of K
        requests sends ``floor``/``ceil`` of ``weight*K`` to the
        canary."""
        with self._lock:
            self._canary_rid = rid
            self._canary_weight = max(0.0, min(1.0, float(weight)))
            self._canary_credit = 0.0

    def clear_canary(self) -> None:
        with self._lock:
            self._canary_rid = None
            self._canary_weight = 0.0
            self._canary_credit = 0.0

    def canary(self) -> Optional[str]:
        with self._lock:
            return self._canary_rid

    # -- routing set -------------------------------------------------------

    def _routable(self, st: ReplicaStatus) -> bool:
        """Caller holds the lock (or owns a private copy)."""
        if st.marked_failed or st.last_ok is None:
            return False
        if st.consecutive_failures >= self.fail_threshold:
            return False
        if st.engine_state not in ROUTABLE_STATES:
            return False
        if st.heartbeat_age_s >= 0.0:
            if st.heartbeat_age_s > self.heartbeat_stale:
                return False
        elif time.monotonic() - st.added_at > self.startup_grace:
            return False  # never ticked, past the warmup allowance
        return True

    def statuses(self) -> List[ReplicaStatus]:
        """Snapshot of every registered replica's last known status."""
        with self._lock:
            return [dataclasses.replace(s) for s in self._status.values()]

    def in_rotation(self) -> List[ReplicaStatus]:
        with self._lock:
            return [dataclasses.replace(s) for s in self._status.values()
                    if self._routable(s)]

    def is_routable(self, rid: str) -> bool:
        with self._lock:
            st = self._status.get(rid)
            return st is not None and self._routable(st)

    def pick(self, exclude=()) -> Optional[ReplicaStatus]:
        """Join-shortest-queue: least ``queue_depth``, then least
        ``occupancy``, round-robin among ties.  ``exclude`` skips
        replicas this request already tried."""
        exclude = set(exclude)
        with self._lock:
            cands = [s for s in self._status.values()
                     if self._routable(s) and s.endpoint.rid not in exclude]
            if not cands:
                return None
            if self._canary_rid is not None:
                canary = next((s for s in cands
                               if s.endpoint.rid == self._canary_rid), None)
                others = [s for s in cands if s is not canary]
                if canary is not None and others:
                    self._canary_credit += self._canary_weight
                    if self._canary_credit >= 1.0:
                        self._canary_credit -= 1.0
                        return dataclasses.replace(canary)
                    cands = others
                # Canary alone in rotation (or gone): fall through to
                # plain JSQ — availability beats the traffic split.
            best = min((s.queue_depth, s.occupancy) for s in cands)
            ties = sorted(
                (s for s in cands
                 if (s.queue_depth, s.occupancy) == best),
                key=lambda s: s.endpoint.rid)
            st = ties[self._rr % len(ties)]
            self._rr += 1
            return dataclasses.replace(st)

    # -- polling -----------------------------------------------------------

    def _fetch_stats(self, endpoint: ReplicaEndpoint) -> Dict:
        with urllib.request.urlopen(endpoint.base_url + "/stats",
                                    timeout=self.poll_timeout) as r:
            return json.loads(r.read())

    def poll_now(self) -> None:
        """One synchronous sweep over every registered replica —
        the poll thread's body, also callable directly from tests."""
        with self._lock:
            endpoints = [(s.endpoint, s.mark_seq)
                         for s in self._status.values()]
        for ep, pre_fetch_seq in endpoints:
            try:
                snap = self._fetch_stats(ep)
                qd = int(snap["queue_depth"])
                occ = float(snap["occupancy"])
                state = str(snap["engine_state"])
                hb = float(snap["heartbeat_age_s"])
                # tp/mesh joined the contract later; .get defaults
                # keep a mixed-version fleet pollable during a rollout.
                tp = int(snap.get("tp", 1))
                mesh_desc = str(snap.get("mesh", ""))
                cg = int(snap.get("config_generation", 0))
            except Exception as e:
                self.metrics.poll_errors.inc()
                with self._lock:
                    st = self._status.get(ep.rid)
                    if st is None:
                        continue
                    was = self._routable(st)
                    st.consecutive_failures += 1
                    st.consecutive_ok = 0
                    st.polls += 1
                    if was and not self._routable(st):
                        self.metrics.replica_evictions.inc()
                        self._instant("replica_evicted", {
                            "rid": ep.rid, "reason": f"poll: {e}"})
                        logger.warning(
                            "router: replica %s left rotation (poll "
                            "failure #%d: %s)", ep.rid,
                            st.consecutive_failures, e)
                continue
            with self._lock:
                st = self._status.get(ep.rid)
                if st is None:
                    continue  # removed mid-poll
                was = self._routable(st)
                st.queue_depth = qd
                st.occupancy = occ
                st.engine_state = state
                st.heartbeat_age_s = hb
                st.tp = tp
                st.mesh = mesh_desc
                st.config_gen = cg
                st.last_ok = time.monotonic()
                st.consecutive_ok += 1
                # Re-admission hysteresis: an EVICTED replica (failures
                # at/past threshold, or proxy-marked) must string
                # together readmit_threshold good polls before its
                # eviction state clears — a flapper that fails every
                # other poll never makes it back.  A replica that was
                # never evicted clears a sub-threshold blip on the
                # first good poll, as before.
                evicted = (st.marked_failed
                           or st.consecutive_failures >= self.fail_threshold)
                if (not evicted
                        or st.consecutive_ok >= self.readmit_threshold):
                    st.consecutive_failures = 0
                    # Clear the proxy-side eviction only if no NEW mark
                    # landed while this (lock-free) fetch was in flight —
                    # a mark issued after the snapshot was taken is
                    # fresher evidence than the snapshot.
                    if st.mark_seq == pre_fetch_seq:
                        st.marked_failed = False
                st.polls += 1
                now_routable = self._routable(st)
                if was and not now_routable:
                    self.metrics.replica_evictions.inc()
                    self._instant("replica_evicted", {
                        "rid": ep.rid, "reason": state
                        if state not in ROUTABLE_STATES else "stale"})
                    logger.warning(
                        "router: replica %s left rotation (state=%s, "
                        "heartbeat_age=%.3fs)", ep.rid, state, hb)
                elif now_routable and not was:
                    self._instant("replica_rejoined" if st.ever_routable
                                  else "replica_ready", {"rid": ep.rid})
                if now_routable:
                    st.ever_routable = True
        with self._lock:
            self.metrics.replicas_in_rotation.set(
                sum(1 for s in self._status.values() if self._routable(s)))

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.poll_interval):
            try:
                self.poll_now()
            except Exception:  # pragma: no cover - never kill the sweep
                logger.exception("router: poll sweep failed")

    def start(self) -> "ReplicaRegistry":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._poll_loop, name="router-registry",
                daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None

    @staticmethod
    def _instant(name: str, args: Dict) -> None:
        """Timeline instants (replica lifecycle on the one Perfetto
        axis) — observability never gates routing."""
        try:
            from horovod_tpu_torch.obs import tracing as obs_tracing

            obs_tracing.instant(name, args)
        except Exception:  # pragma: no cover
            pass
