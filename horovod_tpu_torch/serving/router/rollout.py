"""RolloutController: zero-downtime fleet reconfiguration.

The port of ``horovod_tpu/serving/router/rollout.py``, code for code
(``tests/test_torch_port_rollout.py`` compares the syntax trees) but for
one repair: :meth:`RolloutController.start` and
:meth:`RolloutController.recover` return the status read BEFORE their
thread starts.  The JAX methods read it after, so under load the
returned state is whatever the thread has reached (a recovery over a
fleet whose drains complete at once can already read ``rolled_back``).

The tuning package makes candidate configs SCORABLE (``tuning.replay.tune`` over a
journaled trace, the online tuner over a live window); this module
makes them DEPLOYABLE.  The controller composes the front tier's
existing primitives — supervised drain (the SIGTERM → graceful-drain →
``shutdown_grace`` → SIGKILL sequence), journaled resume + router
failover (in-flight requests continue byte-identical on a survivor),
and the tuning objective with its per-class TTFT-p99 guard bands —
into a rolling, canaried, automatically-rolled-back reconfiguration:

``idle → draining → rebuilding → canary → rolling → done``
``                                  ↘ rolling_back → rolled_back``
``(refused / nothing rebuilt yet → aborted)``

One replica at a time (healthy capacity never drops below N−1; a
1-replica fleet is refused without ``allow_capacity_dip``), the
controller:

1. **drains** the slot through :meth:`ReplicaSupervisor.drain_slot`
   (in-flight requests fail over with journal descriptors — zero
   dropped requests, outputs byte-identical to the oracle),
2. **rebuilds** it at the candidate spec (a per-slot override the exit
   watcher respawns into; ``config_gen`` is stamped through
   ``--config-gen`` and echoed by the replica's ``/stats``),
3. admits the FIRST rebuilt replica as a **canary**: the registry
   routes exactly ``canary_weight`` of picks to it (deterministic
   credit accumulator) while the controller diffs every replica's
   ``/stats`` counters over ``canary_windows`` scoring windows and
   scores canary vs. incumbent with :class:`~horovod_tpu_torch.tuning.
   Objective` — any per-class TTFT-p99 past ``slo × (1 + guard_band)``
   trips, as does a canary crash/eviction or (when
   ``min_score_delta`` is set) a score materially below the
   incumbents',
4. **rolls** the remaining slots through the same drain/rebuild step,
5. **promotes** the candidate to the supervisor's base spec.

Any trip — canary SLO breach, canary crash, crash loop past
``crash_budget`` respawns, registry eviction, drain overruning its
budget, an operator :meth:`abort`, or an injected fault at any of the
four ``rollout_*`` sites — triggers **automatic rollback** through the
SAME one-at-a-time machinery: every slot already rebuilt at the
candidate is recycled back to the incumbent spec, and the terminal
state is ``rolled_back``.  The invariant the chaos suite
(tests/test_rollout.py) proves: under faults at every step the fleet
never ends in a mixed config, never drops a request, and always
converges to all-incumbent or all-candidate in bounded time.

Durability: every transition is journaled as append-only JSONL
(``rollout.journal.jsonl`` beside the request journals), so a
SIGKILL'd supervisor process can :meth:`recover` deterministically —
resume FORWARD when the canary had already been promoted (a ``rolling``
state was journaled), roll BACK otherwise — converging the fleet by
comparing each live replica's ``/stats`` config generation against the
target.

Fault sites (``FaultInjector``): ``rollout_drain``,
``rollout_rebuild``, ``rollout_canary``, ``rollout_promote`` — probed
in the CONTROLLER (supervisor process), one per step, so the chaos
suite can fail every step of the machine deterministically.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from horovod_tpu_torch.serving.router.registry import ReplicaRegistry
from horovod_tpu_torch.serving.router.supervisor import (
    ReplicaSpec,
    ReplicaSupervisor,
)
from horovod_tpu_torch.tuning import Objective, WindowStats

logger = logging.getLogger("horovod_tpu_torch")

__all__ = ["RolloutController", "RolloutError"]

#: Every state the machine can be in; terminal ones end the run thread.
STATES = ("idle", "draining", "rebuilding", "canary", "rolling", "done",
          "rolling_back", "rolled_back", "aborted")
TERMINAL_STATES = ("done", "rolled_back", "aborted")


class RolloutError(RuntimeError):
    """A rollout could not be started (already active, bad candidate,
    or a fleet shape the safety rules refuse)."""


class _Trip(Exception):
    """Internal: a trip condition fired — unwind to rollback."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


def _parse_buckets(hist: Dict) -> Tuple[List[float], List[int]]:
    """``{"buckets": {"<edge>": n, "+Inf": n}}`` -> (sorted edges,
    per-bucket counts with the overflow bucket last)."""
    overflow = 0
    items: List[Tuple[float, int]] = []
    for key, count in (hist.get("buckets") or {}).items():
        if key == "+Inf":
            overflow = int(count)
        else:
            items.append((float(key), int(count)))
    items.sort()
    return ([e for e, _ in items],
            [c for _, c in items] + [overflow])


def _hist_delta_p99(now: Dict, base: Optional[Dict]) -> Optional[float]:
    """Windowed p99 from two HTTP histogram snapshots (the
    ``{"buckets": ...}`` shape every replica's ``/stats`` serves) — the
    over-the-wire twin of the online tuner's ``_Window._p99`` (same
    rank walk, same upper-edge convention; both snapshots share the
    default bucket edges)."""
    if not isinstance(now, dict):
        return None
    edges, counts = _parse_buckets(now)
    if base is not None:
        _, base_counts = _parse_buckets(base)
        if len(base_counts) == len(counts):
            counts = [a - b for a, b in zip(counts, base_counts)]
    total = sum(counts)
    if total <= 0 or not edges:
        return None
    rank, cum = 0.99 * total, 0
    for i, c in enumerate(counts):
        cum += c
        if cum >= rank:
            return edges[i] if i < len(edges) else edges[-1]
    return edges[-1]


class _StatsWindow:
    """Baseline of one replica's cumulative ``/stats`` counters; diffs
    into a :class:`WindowStats` the tuning objective can score."""

    def __init__(self, snap: Dict):
        self.tokens = int(snap.get("tokens_generated", 0))
        self.ticks = int(snap.get("decode_ticks", 0))
        self.preempt = int(snap.get("preemptions", 0))
        self.ttft = dict(snap.get("ttft_seconds_by_class") or {})

    def close(self, snap: Dict) -> WindowStats:
        p99 = {}
        for cls, hist in (snap.get("ttft_seconds_by_class") or {}).items():
            v = _hist_delta_p99(hist, self.ttft.get(cls))
            if v is not None:
                p99[cls] = v
        return WindowStats(
            ticks=max(int(snap.get("decode_ticks", 0)) - self.ticks, 0),
            tokens=max(int(snap.get("tokens_generated", 0))
                       - self.tokens, 0),
            preemptions=max(int(snap.get("preemptions", 0))
                            - self.preempt, 0),
            ttft_p99=p99)


def _merge_windows(stats: List[WindowStats]) -> WindowStats:
    """Aggregate the incumbents into one fleet-side window: counters
    sum; per-class p99 takes the WORST replica (the conservative read —
    the canary must not look good merely because one incumbent had a
    quiet window)."""
    p99: Dict[str, float] = {}
    for w in stats:
        for cls, v in w.ttft_p99.items():
            p99[cls] = max(p99.get(cls, 0.0), v)
    return WindowStats(
        ticks=sum(w.ticks for w in stats),
        tokens=sum(w.tokens for w in stats),
        preemptions=sum(w.preemptions for w in stats),
        ttft_p99=p99)


class RolloutController:
    """Drive one rolling fleet reconfiguration at a time.

    Wire it between the supervisor and the router::

        ctl = RolloutController(sup, registry)
        rt = RouterServer(registry, rollout=ctl, ...)
        # POST /rollout {"candidate": {"max_prefills_per_tick": 4}}

    ``candidate`` is a flat dict of config deltas: keys naming
    :class:`ReplicaSpec` fields override the spec, everything else
    becomes an ``engine_knobs`` entry (an EngineConfig field carried as
    ``--set name=value``) — exactly the ``settings`` shape
    ``tuning.replay.tune`` returns in its ``best`` entry, so a tuned
    candidate deploys verbatim.
    """

    def __init__(self, supervisor: ReplicaSupervisor,
                 registry: Optional[ReplicaRegistry] = None, *,
                 objective: Optional[Objective] = None,
                 canary_weight: float = 0.2,
                 canary_windows: int = 2,
                 window_s: float = 1.0,
                 guard_band: float = 0.5,
                 min_score_delta: Optional[float] = None,
                 ready_timeout: float = 120.0,
                 drain_margin: float = 5.0,
                 crash_budget: int = 1,
                 allow_capacity_dip: bool = False,
                 journal_path: Optional[str] = None,
                 faults=None) -> None:
        self.sup = supervisor
        self.registry = registry if registry is not None \
            else supervisor.registry
        self.objective = objective or Objective()
        self.canary_weight = float(canary_weight)
        self.canary_windows = int(canary_windows)
        self.window_s = float(window_s)
        self.guard_band = float(guard_band)
        self.min_score_delta = min_score_delta
        self.ready_timeout = float(ready_timeout)
        self.drain_margin = float(drain_margin)
        self.crash_budget = int(crash_budget)
        self.allow_capacity_dip = bool(allow_capacity_dip)
        self.faults = faults
        if journal_path is None:
            jdir = getattr(supervisor, "_journal_dir", None)
            if jdir:
                journal_path = os.path.join(jdir, "rollout.journal.jsonl")
        self.journal_path = journal_path
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._abort = threading.Event()
        self.state = "idle"
        self.trip_reason: Optional[str] = None
        self._candidate: Dict = {}
        self._candidate_spec: Optional[ReplicaSpec] = None
        self._incumbent_spec: Optional[ReplicaSpec] = None
        self._rebuilt_slots: List[int] = []
        self._step_durations: Dict[str, float] = {}
        self._scores: Dict[str, Optional[float]] = {
            "canary": None, "incumbent": None}

    # -- public surface ----------------------------------------------------

    @property
    def active(self) -> bool:
        return self.state not in ("idle",) + TERMINAL_STATES

    def status(self) -> Dict:
        with self._lock:
            return {
                "state": self.state,
                "active": self.active,
                "candidate": dict(self._candidate),
                "config_generation": (
                    self._candidate_spec.config_gen
                    if self._candidate_spec is not None else None),
                "rebuilt_slots": list(self._rebuilt_slots),
                "trip_reason": self.trip_reason,
                "canary_score": self._scores["canary"],
                "incumbent_score": self._scores["incumbent"],
                "step_durations_s": {
                    k: round(v, 3)
                    for k, v in self._step_durations.items()},
            }

    def start(self, candidate: Dict, *,
              allow_capacity_dip: Optional[bool] = None) -> Dict:
        """Validate and launch a rollout of ``candidate``; returns the
        initial status.  Raises :class:`RolloutError` when one is
        already active or the fleet shape is refused."""
        if callable(self.sup.spec):
            raise RolloutError(
                "rollouts need a ReplicaSpec-based supervisor (callable "
                "command factories carry no config to re-render)")
        if not isinstance(candidate, dict) or not candidate:
            raise RolloutError("candidate must be a non-empty dict of "
                               "config deltas")
        dip_ok = (self.allow_capacity_dip if allow_capacity_dip is None
                  else bool(allow_capacity_dip))
        if self.sup.n_replicas < 2 and not dip_ok:
            raise RolloutError(
                "refusing to roll a 1-replica fleet (the drain step "
                "would take the whole fleet down); pass "
                "allow_capacity_dip to override")
        with self._lock:
            if self.active:
                raise RolloutError(
                    f"a rollout is already {self.state}")
            incumbent = self.sup.spec
            field_names = {f.name for f in dataclasses.fields(ReplicaSpec)}
            field_names -= {"config_gen", "engine_knobs", "extra_args"}
            spec_over = {k: v for k, v in candidate.items()
                         if k in field_names}
            knobs = {k: v for k, v in candidate.items()
                     if k not in field_names}
            self._incumbent_spec = incumbent
            self._candidate_spec = dataclasses.replace(
                incumbent, **spec_over,
                engine_knobs={**dict(incumbent.engine_knobs), **knobs},
                config_gen=incumbent.config_gen + 1)
            self._candidate = dict(candidate)
            self._rebuilt_slots = []
            self._step_durations = {}
            self._scores = {"canary": None, "incumbent": None}
            self.trip_reason = None
            self._abort.clear()
            # Journal the start BEFORE the first state transition so
            # recovery's scan sees every state event under its start.
            self._journal({"e": "start", "candidate": dict(candidate),
                           "config_gen": self._candidate_spec.config_gen,
                           "n_replicas": self.sup.n_replicas})
            self._set_state("draining", locked=True)
        self.registry.metrics.rollouts_started.inc()
        self.registry.metrics.rollout_active.set(1)
        self._instant("rollout_start", {
            "config_gen": self._candidate_spec.config_gen})
        # The status as launched, read before the run thread exists: a
        # read after its start would report whatever state the thread
        # has reached by then.
        status = self.status()
        self._thread = threading.Thread(
            target=self._run, name="rollout-controller", daemon=True)
        self._thread.start()
        return status

    def abort(self) -> Dict:
        """Operator abort: trips the machine at its next step boundary
        (in-flight drain steps finish; the rollback recycles whatever
        was already rebuilt)."""
        self._abort.set()
        return self.status()

    def wait(self, timeout: float = 600.0) -> bool:
        """Block until the run thread parks in a terminal state."""
        t = self._thread
        if t is not None:
            t.join(timeout)
        return self.state in ("idle",) + TERMINAL_STATES

    def recover(self) -> Optional[Dict]:
        """Resume or roll back an unfinished rollout after a supervisor
        restart, from the journal alone.

        Deterministic rule: a journaled ``rolling`` state means the
        canary was already scored and promoted — resume FORWARD to
        all-candidate; anything earlier rolls BACK to all-incumbent.
        Either way the fleet converges to a single config generation.
        Returns the status when a recovery was launched, None when the
        journal shows no unfinished rollout."""
        events = self._read_journal()
        pending = None
        saw_rolling = False
        for ev in events:
            if ev.get("e") == "start":
                pending = ev
                saw_rolling = False
            elif ev.get("e") == "state" and ev.get("s") == "rolling":
                saw_rolling = True
            elif ev.get("e") == "end":
                pending = None
        if pending is None:
            return None
        candidate = dict(pending.get("candidate") or {})
        target_gen = int(pending.get("config_gen", 1))
        with self._lock:
            if self.active:
                raise RolloutError("cannot recover while a rollout is "
                                   f"{self.state}")
            incumbent = self.sup.spec
            field_names = {f.name for f in dataclasses.fields(ReplicaSpec)}
            field_names -= {"config_gen", "engine_knobs", "extra_args"}
            spec_over = {k: v for k, v in candidate.items()
                         if k in field_names}
            knobs = {k: v for k, v in candidate.items()
                     if k not in field_names}
            self._incumbent_spec = incumbent
            self._candidate_spec = dataclasses.replace(
                incumbent, **spec_over,
                engine_knobs={**dict(incumbent.engine_knobs), **knobs},
                config_gen=target_gen)
            self._candidate = candidate
            self._rebuilt_slots = []
            self._step_durations = {}
            self.trip_reason = None
            self._abort.clear()
            self._set_state("rolling" if saw_rolling else "rolling_back",
                            locked=True)
        self.registry.metrics.rollout_active.set(1)
        self._journal({"e": "recover",
                       "forward": saw_rolling,
                       "config_gen": target_gen})
        logger.warning(
            "rollout: recovering unfinished rollout to gen %d — %s",
            target_gen, "resuming forward" if saw_rolling
            else "rolling back")
        status = self.status()
        self._thread = threading.Thread(
            target=self._run_recovery, args=(saw_rolling,),
            name="rollout-recovery", daemon=True)
        self._thread.start()
        return status

    # -- state machine internals -------------------------------------------

    def _set_state(self, state: str, locked: bool = False) -> None:
        assert state in STATES, state
        if locked:
            self.state = state
        else:
            with self._lock:
                self.state = state
        self._journal({"e": "state", "s": state})
        self._instant("rollout_state", {"state": state})

    def _probe(self, site: str) -> None:
        if self.faults is not None:
            self.faults.probe(site)

    def _check_abort(self) -> None:
        if self._abort.is_set():
            raise _Trip("operator_abort")

    def _run(self) -> None:
        t_total = time.monotonic()
        try:
            slots = list(range(self.sup.n_replicas))
            for i, slot in enumerate(slots):
                self._check_abort()
                if i == 0:
                    self._set_state("draining")
                else:
                    self._probe("rollout_promote")
                    self._set_state("rolling")
                self._roll_slot(slot, self._candidate_spec)
                if i == 0:
                    self._canary_phase(slot)
            self._promote()
        except _Trip as trip:
            self._rollback(trip.reason)
        except Exception as e:  # injected faults land here too
            self._rollback(f"{type(e).__name__}: {e}")
        finally:
            self._step_durations["total"] = time.monotonic() - t_total
            self.registry.metrics.rollout_active.set(0)
            self._journal({"e": "end", "state": self.state,
                           "trip": self.trip_reason})

    def _roll_slot(self, slot: int, spec: ReplicaSpec,
                   count_step: bool = True) -> str:
        """Drain one slot and wait for its respawn at ``spec`` to be
        routable; returns the new rid.  Raises :class:`_Trip` on drain
        overrun or a crash loop past ``crash_budget``."""
        t0 = time.monotonic()
        self._probe("rollout_drain")
        self.sup.set_slot_spec(slot, spec)
        if count_step and slot not in self._rebuilt_slots:
            # Recorded the MOMENT the override lands, not after the
            # rebuild completes: from here on any respawn of this slot
            # runs the candidate config, so a trip anywhere past this
            # line must recycle it or the fleet ends mixed.
            self._rebuilt_slots.append(slot)
        old = self.sup.handle(slot)
        old_gen = old.gen if old is not None else -1
        self._journal({"e": "slot", "slot": slot,
                       "target_gen": spec.config_gen,
                       "from_rid": old.rid if old else None})
        if old is not None:
            self.sup.drain_slot(
                slot, reason=f"rollout gen {spec.config_gen}")
        # The drain's worst case is graceful-drain + the supervisor's
        # SIGKILL escalation; past that plus a margin something is
        # genuinely stuck and the rollout must not wait on it.
        drain_budget = (getattr(spec, "drain_timeout", 10.0)
                        + getattr(self.sup, "_shutdown_grace", 5.0)
                        + self.drain_margin)
        deadline = time.monotonic() + drain_budget
        while True:
            h = self.sup.handle(slot)
            if h is not None and h.gen > old_gen:
                break
            if time.monotonic() > deadline:
                raise _Trip(f"drain_timeout slot {slot}")
            time.sleep(0.05)
        self._step_durations[f"drain_slot{slot}"] = time.monotonic() - t0
        t1 = time.monotonic()
        self._probe("rollout_rebuild")
        if self.state == "draining":
            self._set_state("rebuilding")
        base_gen = h.gen
        respawns = 0
        deadline = time.monotonic() + self.ready_timeout
        while True:
            h = self.sup.handle(slot)
            if h is None:
                raise _Trip(f"slot {slot} vanished during rebuild")
            if h.gen > base_gen:
                respawns += h.gen - base_gen
                base_gen = h.gen
                if respawns > self.crash_budget:
                    raise _Trip(
                        f"crash_loop slot {slot} "
                        f"({respawns} respawns during rebuild)")
            if self.registry.is_routable(h.rid):
                break
            if time.monotonic() > deadline:
                raise _Trip(f"rebuild_timeout slot {slot}")
            time.sleep(0.05)
        if count_step:
            self.registry.metrics.rollout_steps.inc()
        self._step_durations[f"rebuild_slot{slot}"] = \
            time.monotonic() - t1
        self._journal({"e": "rebuilt", "slot": slot, "rid": h.rid})
        return h.rid

    def _fetch_stats(self, st) -> Optional[Dict]:
        import urllib.request

        try:
            with urllib.request.urlopen(
                    st.endpoint.base_url + "/stats",
                    timeout=self.registry.poll_timeout) as r:
                return json.loads(r.read())
        except Exception:
            return None

    def _canary_phase(self, slot: int) -> None:
        """Score the first rebuilt replica against the incumbent fleet
        for ``canary_windows`` live windows; trips on SLO breach past
        the guard band, canary crash/eviction, or (when configured) a
        materially worse objective score."""
        t0 = time.monotonic()
        self._probe("rollout_canary")
        self._set_state("canary")
        h = self.sup.handle(slot)
        if h is None:
            raise _Trip("canary vanished before scoring")
        rid = h.rid
        self.registry.set_canary(rid, self.canary_weight)
        try:
            for window in range(self.canary_windows):
                self._check_abort()
                statuses = {s.endpoint.rid: s
                            for s in self.registry.in_rotation()}
                if rid not in statuses:
                    raise _Trip("canary left rotation")
                canary_st = statuses.pop(rid)
                base_snap = self._fetch_stats(canary_st)
                if base_snap is None:
                    raise _Trip("canary unreachable")
                canary_base = _StatsWindow(base_snap)
                inc_base = {}
                for r, s in statuses.items():
                    snap = self._fetch_stats(s)
                    if snap is not None:
                        inc_base[r] = (s, _StatsWindow(snap))
                time.sleep(self.window_s)
                cur = self.sup.handle(slot)
                if cur is None or cur.gen != h.gen:
                    raise _Trip("canary crashed during scoring window")
                end_snap = self._fetch_stats(canary_st)
                if end_snap is None or not self.registry.is_routable(rid):
                    raise _Trip("canary evicted during scoring window")
                cw = canary_base.close(end_snap)
                inc_windows = []
                for r, (s, base) in inc_base.items():
                    snap = self._fetch_stats(s)
                    if snap is not None:
                        inc_windows.append(base.close(snap))
                iw = _merge_windows(inc_windows) if inc_windows else None
                c_score, c_excess = self.objective.score(cw)
                self._scores["canary"] = round(c_score, 6)
                self.registry.metrics.rollout_canary_score.set(c_score)
                i_score = None
                if iw is not None:
                    i_score, _ = self.objective.score(iw)
                    self._scores["incumbent"] = round(i_score, 6)
                    self.registry.metrics.rollout_incumbent_score.set(
                        i_score)
                self._journal({"e": "score", "window": window,
                               "canary": self._scores["canary"],
                               "incumbent": self._scores["incumbent"],
                               "excess": {k: round(v, 4)
                                          for k, v in c_excess.items()}})
                violated = [cls for cls, over in c_excess.items()
                            if over > self.guard_band]
                if violated:
                    raise _Trip(
                        "canary_slo_breach: "
                        + ", ".join(f"{cls} p99 over SLO by "
                                    f"{c_excess[cls]:.0%}"
                                    for cls in violated))
                if (self.min_score_delta is not None
                        and i_score is not None
                        and c_score < i_score - self.min_score_delta):
                    raise _Trip(
                        f"canary_score {c_score:.4f} below incumbent "
                        f"{i_score:.4f} - {self.min_score_delta}")
        finally:
            self.registry.clear_canary()
            self._step_durations["canary"] = time.monotonic() - t0

    def _promote(self) -> None:
        self.sup.set_base_spec(self._candidate_spec)
        self.registry.metrics.rollout_promotions.inc()
        self._set_state("done")
        self._instant("rollout_done", {
            "config_gen": self._candidate_spec.config_gen})
        logger.info(
            "rollout: promoted config gen %d fleet-wide (%d slots)",
            self._candidate_spec.config_gen, self.sup.n_replicas)

    def _rollback(self, reason: str) -> None:
        """Converge every candidate-config slot back to the incumbent
        spec through the same one-at-a-time machinery.  Best-effort but
        bounded: a slot that cannot be recycled within its budgets is
        logged and skipped (the supervisor keeps respawning it at the
        incumbent spec regardless, because the override is cleared)."""
        with self._lock:
            self.trip_reason = reason
        rebuilt = list(self._rebuilt_slots)
        self.registry.clear_canary()
        self.registry.metrics.rollout_rollbacks.inc()
        self._journal({"e": "trip", "reason": reason,
                       "rebuilt_slots": rebuilt})
        self._instant("rollout_trip", {"reason": reason})
        logger.warning("rollout: tripped (%s); rolling back %d slot(s)",
                       reason, len(rebuilt))
        if not rebuilt:
            # Nothing ever reached the candidate config: the fleet is
            # already all-incumbent.
            for slot in range(self.sup.n_replicas):
                self.sup.clear_slot_spec(slot)
            self._set_state("aborted")
            return
        self._set_state("rolling_back")
        t0 = time.monotonic()
        for slot in range(self.sup.n_replicas):
            self.sup.clear_slot_spec(slot)
        for slot in rebuilt:
            try:
                self._roll_slot(slot, self._incumbent_spec,
                                count_step=False)
                self.registry.metrics.rollout_steps.inc()
            except _Trip as trip:
                # Keep converging the rest; the cleared override means
                # ANY future respawn of this slot lands incumbent.
                logger.warning(
                    "rollout: rollback of slot %d overran (%s); its "
                    "override is cleared, the supervisor converges it",
                    slot, trip.reason)
        for slot in rebuilt:
            # The recycle re-set an override (to the incumbent spec,
            # so it is content-identical to the base) — drop it so the
            # supervisor ends with a clean override table.
            self.sup.clear_slot_spec(slot)
        self._rebuilt_slots = []
        self._step_durations["rollback"] = time.monotonic() - t0
        self._set_state("rolled_back")
        self._instant("rollout_rolled_back", {"reason": reason})

    def _run_recovery(self, forward: bool) -> None:
        """Post-restart convergence: recycle every slot whose LIVE
        config generation (per the registry's polled ``/stats`` labels)
        differs from the target — candidate gen when resuming forward,
        incumbent gen on rollback."""
        t_total = time.monotonic()
        target_spec = (self._candidate_spec if forward
                       else self._incumbent_spec)
        try:
            # One fresh poll so config_gen labels reflect live replicas.
            if self.registry._thread is None:
                self.registry.poll_now()
            by_slot: Dict[int, int] = {}
            for st in self.registry.statuses():
                rid = st.endpoint.rid
                try:
                    slot = int(rid[1:rid.index("g")])
                except ValueError:
                    continue
                by_slot[slot] = st.config_gen
            for slot in range(self.sup.n_replicas):
                self._check_abort()
                if forward:
                    self.sup.set_slot_spec(slot, target_spec)
                live_gen = by_slot.get(slot)
                if live_gen == target_spec.config_gen:
                    continue
                self._roll_slot(slot, target_spec, count_step=forward)
                self.registry.metrics.rollout_steps.inc()
            if forward:
                self._promote()
            else:
                for slot in range(self.sup.n_replicas):
                    self.sup.clear_slot_spec(slot)
                self._set_state("rolled_back")
        except _Trip as trip:
            if forward:
                self._rollback(f"recovery: {trip.reason}")
            else:
                with self._lock:
                    self.trip_reason = trip.reason
                self._set_state("rolled_back")
        except Exception as e:  # pragma: no cover - recovery last resort
            with self._lock:
                self.trip_reason = f"{type(e).__name__}: {e}"
            self._set_state("rolled_back" if not forward else "aborted")
        finally:
            self._step_durations["total"] = time.monotonic() - t_total
            self.registry.metrics.rollout_active.set(0)
            self._journal({"e": "end", "state": self.state,
                           "trip": self.trip_reason})

    # -- journal -----------------------------------------------------------

    def _journal(self, event: Dict) -> None:
        if not self.journal_path:
            return
        event = {"t": round(time.time(), 3), **event}
        try:
            os.makedirs(os.path.dirname(self.journal_path) or ".",
                        exist_ok=True)
            with open(self.journal_path, "a") as f:
                f.write(json.dumps(event) + "\n")
                f.flush()
                os.fsync(f.fileno())
        except OSError:  # pragma: no cover - durability best effort
            logger.exception("rollout: journal append failed")

    def _read_journal(self) -> List[Dict]:
        if not self.journal_path:
            return []
        try:
            with open(self.journal_path) as f:
                out = []
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        out.append(json.loads(line))
                    except json.JSONDecodeError:
                        continue  # torn tail write from a SIGKILL
                return out
        except OSError:
            return []

    @staticmethod
    def _instant(name: str, args: Dict) -> None:
        try:
            from horovod_tpu_torch.obs import tracing as obs_tracing

            obs_tracing.instant(name, args)
        except Exception:  # pragma: no cover
            pass
