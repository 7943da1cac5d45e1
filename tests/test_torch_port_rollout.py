"""The port's fleet rollout controller
(``horovod_tpu_torch/serving/router/rollout.py``) against the JAX
package's, on the CPU.

* The copy: ``rollout.py`` is the JAX module code for code but for one
  repair — :meth:`RolloutController.start` and ``recover`` return the
  status read before their thread starts (the JAX methods read it
  after, so the returned state is whatever the thread has reached:
  ``test_status_is_read_before_the_thread_runs`` shows the difference
  on both packages under the worst schedule, the thread running to its
  end before the caller reads).
* The JAX tier-1 classes of ``tests/test_rollout.py`` on the same fakes
  (a supervisor and registry whose drains and respawns complete at
  once, canned ``/stats`` snapshots): ``TestRolloutMachine``'s state
  machine and fault matrix, ``TestRolloutRecovery``,
  ``TestScoringWindows`` and ``TestRolloutAdminEndpoint``, against the
  port's modules.
* The scoring contract: a window over the port engine's own ``/stats``
  scores as the JAX engine's does.
"""

import ast
import importlib
import json
import re
import threading
import time
import types
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from horovod_tpu import serving as JS
from horovod_tpu_torch import serving
from horovod_tpu_torch.serving.router import (
    ReplicaEndpoint,
    ReplicaRegistry,
    ReplicaSpec,
    RolloutController,
    RolloutError,
    RouterMetrics,
    RouterServer,
)

import torch_port_parity as P

rollout_mod = importlib.import_module(
    "horovod_tpu_torch.serving.router.rollout")
jax_rollout = importlib.import_module("horovod_tpu.serving.router.rollout")

pytestmark = pytest.mark.rollout

ROOT = Path(__file__).resolve().parents[1]


def _tree(pkg: str, rename: bool) -> ast.Module:
    text = (ROOT / pkg / "serving/router/rollout.py").read_text()
    if rename:
        text = re.sub(r"\bhorovod_tpu\b", "horovod_tpu_torch", text)
    tree = ast.parse(text)
    tree.body = tree.body[1:]
    return tree


def test_rollout_copy_but_the_status_repair():
    """The port's ``rollout.py`` is the JAX module once ``start`` and
    ``recover`` read their returned status where the JAX ones do (after
    the thread starts): the repair moves that read and nothing else."""
    def normalise(tree, port_side):
        for node in ast.walk(tree):
            if not (isinstance(node, ast.FunctionDef)
                    and node.name in ("start", "recover")):
                continue
            body = node.body
            if port_side:
                # status = self.status(); <thread start>; return status
                i = next(k for k, st in enumerate(body)
                         if ast.unparse(st) == "status = self.status()")
                assert ast.unparse(body[-1]) == "return status"
                del body[i]
                body[-1] = ast.parse("return self.status()").body[0]
            else:
                assert ast.unparse(body[-1]) == "return self.status()"
        return ast.dump(tree)

    assert normalise(_tree("horovod_tpu_torch", False), True) == \
        normalise(_tree("horovod_tpu", True), False)


class _JoiningThread(threading.Thread):
    """The worst schedule for a caller: the thread runs to its end inside
    ``start()``, before the caller's next line."""

    def start(self):
        super().start()
        self.join()


@pytest.mark.parametrize("package", ["port", "jax"])
def test_status_is_read_before_the_thread_runs(package, monkeypatch,
                                               tmp_path):
    """The reference fault behind the JAX suite's flaky
    ``test_recover_rolls_back_before_promotion_point``: on a fleet whose
    drains complete at once, the JAX ``recover()`` returns the state its
    thread reached (``rolled_back``) when the thread runs before the
    caller reads; the port's returns ``rolling_back``, the state it
    launched, under any schedule.  ``start()`` likewise (``draining``)."""
    mod = rollout_mod if package == "port" else jax_rollout
    shim = types.SimpleNamespace(Thread=_JoiningThread, Lock=threading.Lock,
                                 Event=threading.Event)
    monkeypatch.setattr(mod, "threading", shim)
    path = str(tmp_path / "rollout.jsonl")
    with open(path, "w") as f:
        for e in ({"e": "start", "candidate": {"slots": 8},
                   "config_gen": 1, "n_replicas": 3},
                  {"e": "state", "s": "canary"}):
            f.write(json.dumps({"t": 0.0, **e}) + "\n")
    reg, incumbent, sup = TestRolloutRecovery()._fleet([1, 0, 0])
    ctl = _controller(sup, journal_path=path)
    ctl.__class__ = mod.RolloutController
    st = ctl.recover()
    assert ctl.state == "rolled_back"          # the thread has ended
    want = "rolling_back" if package == "port" else "rolled_back"
    assert st["state"] == want
    reg = _FakeRegistry()
    sup = _FakeSupervisor(ReplicaSpec(seed=0), 2, reg)
    ctl = _controller(sup)
    ctl.__class__ = mod.RolloutController
    st = ctl.start({"max_prefills_per_tick": 1})
    assert ctl.state == "done"
    assert st["state"] == ("draining" if package == "port" else "done")


def test_scoring_window_over_the_port_engine_stats():
    """The controller's ``_StatsWindow`` over two ``/stats`` snapshots of
    the port's engine reads what it reads over the JAX engine's, the
    same requests run on both: the tokens, a per-class p99 on one of the
    shared bucket edges (the latencies themselves differ: the JAX engine
    compiles during its first requests)."""
    model = P.make_model(0)
    scores = []
    for S, eng in (
            (serving, serving.InferenceEngine(
                model.tparams, model.tcfg,
                serving.EngineConfig(n_slots=2, max_len=24), device="cpu")),
            (JS, JS.InferenceEngine(model.jparams, model.jcfg,
                                    JS.EngineConfig(n_slots=2,
                                                    max_len=24)))):
        base = rollout_mod._StatsWindow(json.loads(json.dumps(eng.stats())))
        futs = [eng.submit([1 + i, 2, 3], max_new_tokens=5)
                for i in range(3)]
        while not all(f.done() for f in futs):
            eng.step()
        end = json.loads(json.dumps(eng.stats()))
        w = base.close(end)
        edges, _ = rollout_mod._parse_buckets(
            end["ttft_seconds_by_class"]["interactive"])
        assert w.ttft_p99["interactive"] in edges
        scores.append((w.tokens, sorted(w.ttft_p99), edges))
        assert w.tokens == 15 and w.ticks > 0
    assert scores[0] == scores[1]


class _FakeHandle:
    def __init__(self, slot, gen):
        self.slot = slot
        self.gen = gen

    @property
    def rid(self):
        return f"r{self.slot}g{self.gen}"


class _FakeStatus:
    """Just enough ReplicaStatus surface for the controller: an
    endpoint with a rid/base_url and the polled config generation."""

    def __init__(self, rid, config_gen=0):
        self.endpoint = ReplicaEndpoint(rid, "127.0.0.1", 1)
        self.config_gen = config_gen


class _FakeRegistry:
    """The registry surface the controller touches, no HTTP."""

    def __init__(self):
        self.metrics = RouterMetrics()
        self.poll_timeout = 1.0
        self._thread = object()   # "poll thread running"
        self.routable = {}        # rid -> config_gen
        self.canary_rid = None
        self.canary_weight = 0.0
        self.canary_history = []

    def is_routable(self, rid):
        return rid in self.routable

    def in_rotation(self):
        return [_FakeStatus(rid, g) for rid, g in self.routable.items()]

    statuses = in_rotation

    def poll_now(self):
        pass

    def set_canary(self, rid, weight):
        self.canary_rid = rid
        self.canary_weight = weight
        self.canary_history.append(rid)

    def clear_canary(self):
        self.canary_rid = None
        self.canary_weight = 0.0


class _FakeSupervisor:
    """Drain-and-respawn completes synchronously: ``drain_slot`` swaps
    in a NEW handle one generation up (the real supervisor's exit
    watcher does this asynchronously) and marks the new rid routable
    at its slot spec's config generation.  ``drain_mode`` scripts the
    failure shapes the trips need."""

    def __init__(self, spec, n_replicas, registry, *,
                 drain_mode="ok", shutdown_grace=0.05):
        self._spec = spec
        self.n_replicas = n_replicas
        self.registry = registry
        self._shutdown_grace = shutdown_grace
        self._slot_specs = {}
        self._journal_dir = None
        self.handles = {}
        self.drained = []          # (slot, reason) in drain order
        self.drain_mode = drain_mode
        for slot in range(n_replicas):
            h = _FakeHandle(slot, 0)
            self.handles[slot] = h
            registry.routable[h.rid] = spec.config_gen

    @property
    def spec(self):
        return self._spec

    def set_base_spec(self, spec):
        self._spec = spec
        self._slot_specs.clear()

    def slot_spec(self, slot):
        return self._slot_specs.get(slot, self._spec)

    def set_slot_spec(self, slot, spec):
        self._slot_specs[slot] = spec

    def clear_slot_spec(self, slot):
        self._slot_specs.pop(slot, None)

    def handle(self, slot):
        return self.handles.get(slot)

    def respawn(self, slot, routable=True):
        old = self.handles[slot]
        self.registry.routable.pop(old.rid, None)
        h = _FakeHandle(slot, old.gen + 1)
        self.handles[slot] = h
        if routable:
            self.registry.routable[h.rid] = \
                self.slot_spec(slot).config_gen
        return h

    def drain_slot(self, slot, reason="rollout"):
        self.drained.append((slot, reason))
        if self.drain_mode == "stuck":
            return self.handles[slot]     # never exits, never respawns
        if self.drain_mode == "unroutable":
            return self.respawn(slot, routable=False)
        return self.respawn(slot)


def _snap(tokens=0, ticks=0, preempt=0, ttft=None):
    """One cumulative /stats payload in the replica contract shape."""
    hists = {}
    for cls, buckets in (ttft or {}).items():
        total = sum(buckets.values())
        hists[cls] = {"count": total, "sum": 0.0, "buckets": buckets}
    return {"tokens_generated": tokens, "decode_ticks": ticks,
            "preemptions": preempt, "ttft_seconds_by_class": hists}


def _wire_stats(ctl, feeds):
    """Replace the controller's HTTP fetch with canned snapshot
    sequences: ``feeds[rid]`` is a list consumed one per fetch (the
    last entry repeats, so counters keep their final plateau)."""
    cursors = {}

    def fetch(st):
        rid = st.endpoint.rid
        seq = feeds.get(rid)
        if not seq:
            return None
        i = cursors.get(rid, 0)
        cursors[rid] = i + 1
        return seq[min(i, len(seq) - 1)]

    ctl._fetch_stats = fetch


def _controller(sup, **kw):
    kw.setdefault("window_s", 0.01)
    kw.setdefault("canary_windows", 1)
    kw.setdefault("drain_margin", 0.05)
    kw.setdefault("ready_timeout", 2.0)
    ctl = RolloutController(sup, **kw)
    # Default canned stats: a healthy, in-SLO window for everyone.
    good = [_snap(tokens=0, ticks=0),
            _snap(tokens=50, ticks=10,
                  ttft={"interactive": {"0.25": 5, "+Inf": 0}})]
    feeds = {}
    for slot in range(sup.n_replicas):
        for gen in range(6):
            feeds[f"r{slot}g{gen}"] = good
    _wire_stats(ctl, feeds)
    return ctl


def _assert_converged(sup, reg, spec):
    """The terminal invariant: every slot routable at ``spec``'s
    config generation, no slot overrides left behind."""
    assert sup._slot_specs == {}
    gens = {slot: reg.routable.get(sup.handles[slot].rid)
            for slot in range(sup.n_replicas)}
    assert gens == {s: spec.config_gen for s in range(sup.n_replicas)}, \
        f"fleet not converged: {gens}"


# ---------------------------------------------------------------------------
# unit: state machine
# ---------------------------------------------------------------------------


class TestRolloutMachine:
    def test_happy_path_promotes_fleet(self, tmp_path):
        reg = _FakeRegistry()
        sup = _FakeSupervisor(ReplicaSpec(seed=0), 3, reg)
        ctl = _controller(
            sup, journal_path=str(tmp_path / "rollout.jsonl"))
        st = ctl.start({"max_prefills_per_tick": 4, "page_size": 16})
        assert st["state"] in ("draining", "rebuilding", "canary",
                               "rolling", "done")
        assert ctl.wait(10.0)
        assert ctl.state == "done"
        assert ctl.trip_reason is None
        # promotion: candidate became the fleet-wide base spec
        assert sup.spec.config_gen == 1
        assert sup.spec.max_prefills_per_tick == 4       # spec field
        assert sup.spec.engine_knobs == {"page_size": 16}  # engine knob
        _assert_converged(sup, reg, sup.spec)
        # one drain per slot, in slot order, tagged with the target gen
        assert [s for s, _ in sup.drained] == [0, 1, 2]
        assert all("gen 1" in r for _, r in sup.drained)
        # the first rebuilt replica was the canary, then cleared
        assert reg.canary_history == ["r0g1"]
        assert reg.canary_rid is None
        snap = reg.metrics.snapshot()
        assert snap["rollouts_started"] == 1
        assert snap["rollout_promotions"] == 1
        assert snap["rollout_rollbacks"] == 0
        assert snap["rollout_steps"] == 3
        assert snap["rollout_active"] == 0
        status = ctl.status()
        assert status["config_generation"] == 1
        assert status["canary_score"] is not None
        for key in ("drain_slot0", "rebuild_slot0", "canary", "total"):
            assert key in status["step_durations_s"]
        # journal: start .. states .. end, with a score event
        events = [json.loads(l) for l in
                  (tmp_path / "rollout.jsonl").read_text().splitlines()]
        assert events[0]["e"] == "start"
        assert events[0]["config_gen"] == 1
        assert events[-1]["e"] == "end"
        assert events[-1]["state"] == "done"
        assert any(e["e"] == "score" for e in events)
        states = [e["s"] for e in events if e["e"] == "state"]
        assert states[0] == "draining" and states[-1] == "done"
        assert "rolling" in states

    def test_candidate_split_and_generation_bump(self):
        reg = _FakeRegistry()
        base = ReplicaSpec(seed=0, config_gen=3,
                           engine_knobs={"overlap": True})
        sup = _FakeSupervisor(base, 2, reg)
        ctl = _controller(sup)
        ctl.start({"slots": 8, "speculation_k": 2})
        assert ctl.wait(10.0)
        cand = ctl._candidate_spec
        assert cand.slots == 8                     # ReplicaSpec field
        assert cand.config_gen == 4                # bumped from base
        # new knob merged over the incumbent's existing knobs
        assert cand.engine_knobs == {"overlap": True, "speculation_k": 2}

    def test_refusals(self):
        reg = _FakeRegistry()
        sup = _FakeSupervisor(ReplicaSpec(seed=0), 2, reg)
        ctl = _controller(sup)
        with pytest.raises(RolloutError, match="non-empty"):
            ctl.start({})
        with pytest.raises(RolloutError, match="non-empty"):
            ctl.start("slots=8")
        # 1-replica fleet: the drain step would take 100% of capacity
        sup1 = _FakeSupervisor(ReplicaSpec(seed=0), 1, _FakeRegistry())
        with pytest.raises(RolloutError, match="allow_capacity_dip"):
            _controller(sup1).start({"slots": 8})
        # callable command factories carry no config to re-render
        supc = _FakeSupervisor(ReplicaSpec(seed=0), 2, _FakeRegistry())
        supc._spec = lambda slot, port: ["true"]
        with pytest.raises(RolloutError, match="callable"):
            _controller(supc).start({"slots": 8})

    def test_one_replica_with_capacity_dip_promotes(self):
        reg = _FakeRegistry()
        sup = _FakeSupervisor(ReplicaSpec(seed=0), 1, reg)
        ctl = _controller(sup, allow_capacity_dip=True)
        ctl.start({"slots": 8})
        assert ctl.wait(10.0)
        assert ctl.state == "done"
        assert sup.spec.config_gen == 1
        _assert_converged(sup, reg, sup.spec)

    def test_double_start_refused_while_active(self):
        reg = _FakeRegistry()
        sup = _FakeSupervisor(ReplicaSpec(seed=0), 2, reg)
        ctl = _controller(sup, canary_windows=50, window_s=0.1)
        ctl.start({"slots": 8})
        try:
            with pytest.raises(RolloutError, match="already"):
                ctl.start({"slots": 16})
        finally:
            ctl.abort()
            assert ctl.wait(10.0)

    @pytest.mark.parametrize("site", ["rollout_drain", "rollout_rebuild",
                                      "rollout_canary", "rollout_promote"])
    def test_fault_at_every_site_converges_to_incumbent(self, site):
        """THE chaos invariant at unit scale: a deterministic injected
        fault at each of the four controller sites ends in a terminal
        rollback state with the whole fleet back at the incumbent
        config generation — never mixed, no overrides left."""
        reg = _FakeRegistry()
        incumbent = ReplicaSpec(seed=0)
        sup = _FakeSupervisor(incumbent, 3, reg)
        inj = serving.FaultInjector([
            serving.FaultSpec(site=site, kind="raise")])
        ctl = _controller(sup, faults=inj)
        ctl.start({"slots": 8})
        assert ctl.wait(10.0)
        assert ctl.state in ("rolled_back", "aborted")
        assert "InjectedFaultError" in ctl.trip_reason
        assert sup.spec is incumbent            # never promoted
        _assert_converged(sup, reg, incumbent)
        snap = reg.metrics.snapshot()
        assert snap["rollout_rollbacks"] == 1
        assert snap["rollout_promotions"] == 0
        assert snap["rollout_active"] == 0
        assert reg.canary_rid is None
        if site == "rollout_drain":
            # tripped before ANY slot was touched: nothing to recycle
            assert ctl.state == "aborted"
            assert sup.drained == []
        else:
            # slot 0 ran the candidate config and had to be recycled
            assert ctl.state == "rolled_back"
            assert sup.handles[0].gen == 2      # out and back

    def test_canary_slo_breach_rolls_back(self):
        reg = _FakeRegistry()
        incumbent = ReplicaSpec(seed=0)
        sup = _FakeSupervisor(incumbent, 3, reg)
        ctl = _controller(sup)
        # Canary p99 lands in the 1.0s bucket: 2x the 0.5s interactive
        # SLO = 100% excess, over the 50% guard band.
        bad = [_snap(),
               _snap(tokens=50, ticks=10,
                     ttft={"interactive": {"0.25": 0, "1": 10,
                                           "+Inf": 0}})]
        good = [_snap(),
                _snap(tokens=50, ticks=10,
                      ttft={"interactive": {"0.25": 10, "+Inf": 0}})]
        _wire_stats(ctl, {"r0g1": bad, "r1g0": good, "r2g0": good})
        ctl.start({"slots": 8})
        assert ctl.wait(10.0)
        assert ctl.state == "rolled_back"
        assert "canary_slo_breach" in ctl.trip_reason
        assert "interactive" in ctl.trip_reason
        assert sup.spec is incumbent
        _assert_converged(sup, reg, incumbent)
        assert reg.metrics.snapshot()["rollout_rollbacks"] == 1

    def test_canary_score_below_incumbent_rolls_back(self):
        reg = _FakeRegistry()
        incumbent = ReplicaSpec(seed=0)
        sup = _FakeSupervisor(incumbent, 3, reg)
        ctl = _controller(sup, min_score_delta=1.0)
        # In-SLO but much slower than the incumbents: 1 token/tick vs 8.
        slow = [_snap(), _snap(tokens=10, ticks=10)]
        fast = [_snap(), _snap(tokens=80, ticks=10)]
        _wire_stats(ctl, {"r0g1": slow, "r1g0": fast, "r2g0": fast})
        ctl.start({"slots": 8})
        assert ctl.wait(10.0)
        assert ctl.state == "rolled_back"
        assert "below incumbent" in ctl.trip_reason
        _assert_converged(sup, reg, incumbent)
        st = ctl.status()
        assert st["canary_score"] < st["incumbent_score"]

    def test_canary_crash_rolls_back(self):
        """The canary's handle generation moving during a scoring
        window (the exit watcher respawned it = it crashed) trips."""
        reg = _FakeRegistry()
        incumbent = ReplicaSpec(seed=0)
        sup = _FakeSupervisor(incumbent, 3, reg)
        ctl = _controller(sup, window_s=0.2, canary_windows=5)
        ctl.start({"slots": 8})
        deadline = time.monotonic() + 5.0
        while reg.canary_rid is None and time.monotonic() < deadline:
            time.sleep(0.005)
        assert reg.canary_rid == "r0g1"
        sup.respawn(0)                          # crash + respawn
        assert ctl.wait(10.0)
        assert ctl.state == "rolled_back"
        assert "canary" in ctl.trip_reason
        assert sup.spec is incumbent
        _assert_converged(sup, reg, incumbent)

    def test_operator_abort_rolls_back(self):
        reg = _FakeRegistry()
        incumbent = ReplicaSpec(seed=0)
        sup = _FakeSupervisor(incumbent, 3, reg)
        ctl = _controller(sup, window_s=0.2, canary_windows=50)
        ctl.start({"slots": 8})
        deadline = time.monotonic() + 5.0
        while reg.canary_rid is None and time.monotonic() < deadline:
            time.sleep(0.005)
        ctl.abort()
        assert ctl.wait(10.0)
        assert ctl.state == "rolled_back"
        assert ctl.trip_reason == "operator_abort"
        _assert_converged(sup, reg, incumbent)

    def test_drain_overrun_trips_bounded(self):
        """A slot that never exits its drain must not wedge the
        rollout: the budget (drain_timeout + shutdown_grace + margin)
        trips it into rollback."""
        reg = _FakeRegistry()
        incumbent = ReplicaSpec(seed=0, drain_timeout=0.05)
        sup = _FakeSupervisor(incumbent, 2, reg, drain_mode="stuck",
                              shutdown_grace=0.05)
        ctl = _controller(sup, drain_margin=0.05)
        t0 = time.monotonic()
        ctl.start({"slots": 8})
        assert ctl.wait(10.0)
        assert time.monotonic() - t0 < 5.0
        assert ctl.state == "rolled_back"
        assert "drain_timeout" in ctl.trip_reason
        assert sup.spec is incumbent
        # the recycle overran too (drains stay stuck) — overrides are
        # still cleared so the supervisor converges any future respawn
        assert sup._slot_specs == {}

    def test_rebuild_timeout_trips(self):
        """A respawn that never becomes routable trips within
        ready_timeout instead of waiting forever."""
        reg = _FakeRegistry()
        incumbent = ReplicaSpec(seed=0)
        sup = _FakeSupervisor(incumbent, 2, reg,
                              drain_mode="unroutable")
        ctl = _controller(sup, ready_timeout=0.2)
        ctl.start({"slots": 8})
        assert ctl.wait(10.0)
        assert ctl.state == "rolled_back"
        assert "rebuild_timeout" in ctl.trip_reason
        assert sup.spec is incumbent
        assert sup._slot_specs == {}


# ---------------------------------------------------------------------------
# unit: journal + recovery decision rule
# ---------------------------------------------------------------------------


class TestRolloutRecovery:
    def _journal(self, path, events):
        with open(path, "w") as f:
            for e in events:
                f.write(json.dumps({"t": 0.0, **e}) + "\n")

    def _fleet(self, slot_gens):
        """A fake fleet whose live config generations are scripted —
        the state a restarted supervisor would observe by polling."""
        reg = _FakeRegistry()
        incumbent = ReplicaSpec(seed=0)
        sup = _FakeSupervisor(incumbent, len(slot_gens), reg)
        for slot, gen in enumerate(slot_gens):
            if gen:
                h = sup.handles[slot]
                reg.routable.pop(h.rid, None)
                h2 = _FakeHandle(slot, 1)
                sup.handles[slot] = h2
                reg.routable[h2.rid] = gen
        return reg, incumbent, sup

    def test_no_pending_rollout_returns_none(self, tmp_path):
        path = str(tmp_path / "rollout.jsonl")
        reg, _, sup = self._fleet([0, 0])
        ctl = _controller(sup, journal_path=path)
        assert ctl.recover() is None            # no journal at all
        self._journal(path, [
            {"e": "start", "candidate": {"slots": 8}, "config_gen": 1,
             "n_replicas": 2},
            {"e": "state", "s": "draining"},
            {"e": "end", "state": "rolled_back", "trip": "x"},
        ])
        assert ctl.recover() is None            # finished cleanly

    def test_recover_rolls_back_before_promotion_point(self, tmp_path):
        """SIGKILLed mid-canary (no ``rolling`` state journaled): the
        candidate was never deemed good — recovery recycles the one
        candidate-config slot back to the incumbent."""
        path = str(tmp_path / "rollout.jsonl")
        reg, incumbent, sup = self._fleet([1, 0, 0])
        self._journal(path, [
            {"e": "start", "candidate": {"slots": 8}, "config_gen": 1,
             "n_replicas": 3},
            {"e": "state", "s": "draining"},
            {"e": "state", "s": "rebuilding"},
            {"e": "state", "s": "canary"},
        ])
        ctl = _controller(sup, journal_path=path)
        st = ctl.recover()
        assert st is not None and st["state"] == "rolling_back"
        assert ctl.wait(10.0)
        assert ctl.state == "rolled_back"
        assert sup.spec is incumbent
        _assert_converged(sup, reg, incumbent)
        # only the mismatched slot was recycled
        assert [s for s, _ in sup.drained] == [0]
        ev = [json.loads(l) for l in open(path)]
        assert any(e.get("e") == "recover" and e["forward"] is False
                   for e in ev)
        assert ev[-1]["e"] == "end"

    def test_recover_resumes_forward_past_promotion_point(
            self, tmp_path):
        """SIGKILLed while ``rolling`` (canary already scored good):
        recovery finishes the promotion — only the slots still at the
        incumbent generation are recycled, and the candidate becomes
        the base spec."""
        path = str(tmp_path / "rollout.jsonl")
        reg, incumbent, sup = self._fleet([1, 1, 0])
        self._journal(path, [
            {"e": "start", "candidate": {"slots": 8}, "config_gen": 1,
             "n_replicas": 3},
            {"e": "state", "s": "draining"},
            {"e": "state", "s": "rebuilding"},
            {"e": "state", "s": "canary"},
            {"e": "state", "s": "rolling"},
        ])
        ctl = _controller(sup, journal_path=path)
        st = ctl.recover()
        assert st is not None and st["state"] == "rolling"
        assert ctl.wait(10.0)
        assert ctl.state == "done"
        assert sup.spec.config_gen == 1
        assert sup.spec.slots == 8
        _assert_converged(sup, reg, sup.spec)
        assert [s for s, _ in sup.drained] == [2]

    def test_recover_tolerates_torn_tail(self, tmp_path):
        """A SIGKILL can tear the journal's final line mid-write; the
        reader must skip it, not crash or mis-decide."""
        path = str(tmp_path / "rollout.jsonl")
        reg, incumbent, sup = self._fleet([1, 0])
        self._journal(path, [
            {"e": "start", "candidate": {"slots": 8}, "config_gen": 1,
             "n_replicas": 2},
            {"e": "state", "s": "draining"},
        ])
        with open(path, "a") as f:
            f.write('{"t": 0.0, "e": "sta')   # torn write
        ctl = _controller(sup, journal_path=path)
        assert ctl.recover() is not None
        assert ctl.wait(10.0)
        assert ctl.state == "rolled_back"
        _assert_converged(sup, reg, incumbent)


# ---------------------------------------------------------------------------
# unit: scoring plumbing
# ---------------------------------------------------------------------------


class TestScoringWindows:
    def test_hist_delta_p99_diffs_cumulative_buckets(self):
        base = {"buckets": {"0.1": 100, "0.5": 0, "+Inf": 0}}
        now = {"buckets": {"0.1": 100, "0.5": 10, "+Inf": 0}}
        # all 10 WINDOWED observations sit in the 0.5 bucket — the 100
        # older ones in 0.1 must not drag the p99 down
        assert rollout_mod._hist_delta_p99(now, base) == 0.5
        # un-windowed, the 109th of 110 observations is still in the
        # 0.5 bucket (upper-edge convention, same as _Window._p99)
        assert rollout_mod._hist_delta_p99(now, None) == 0.5
        only_low = {"buckets": {"0.1": 100, "0.5": 1, "+Inf": 0}}
        assert rollout_mod._hist_delta_p99(only_low, None) == 0.1
        assert rollout_mod._hist_delta_p99(base, base) is None  # empty
        assert rollout_mod._hist_delta_p99({}, None) is None

    def test_stats_window_diffs_counters(self):
        w = rollout_mod._StatsWindow(_snap(tokens=100, ticks=20,
                                           preempt=3))
        out = w.close(_snap(tokens=160, ticks=30, preempt=4,
                            ttft={"interactive": {"0.25": 5,
                                                  "+Inf": 0}}))
        assert (out.tokens, out.ticks, out.preemptions) == (60, 10, 1)
        assert out.ttft_p99 == {"interactive": 0.25}

    def test_merge_windows_sums_counters_takes_worst_p99(self):
        from horovod_tpu_torch.tuning import WindowStats
        merged = rollout_mod._merge_windows([
            WindowStats(ticks=10, tokens=50, preemptions=1,
                        ttft_p99={"interactive": 0.1}),
            WindowStats(ticks=20, tokens=80, preemptions=0,
                        ttft_p99={"interactive": 0.4, "batch": 1.0}),
        ])
        assert (merged.ticks, merged.tokens, merged.preemptions) \
            == (30, 130, 1)
        assert merged.ttft_p99 == {"interactive": 0.4, "batch": 1.0}


# ---------------------------------------------------------------------------
# unit: the POST/GET /rollout admin surface
# ---------------------------------------------------------------------------


def _http(base, path, payload=None, timeout=10):
    if payload is None:
        req = urllib.request.Request(base + path)
    else:
        req = urllib.request.Request(
            base + path, data=json.dumps(payload).encode()
            if not isinstance(payload, bytes) else payload,
            headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class TestRolloutAdminEndpoint:
    def test_no_controller_is_typed_503(self):
        rt = RouterServer(ReplicaRegistry(), port=0,
                          own_registry_thread=False).start()
        try:
            base = "http://%s:%d" % rt.address
            code, body = _http(base, "/rollout")
            assert code == 503
            assert body["type"] == "no_rollout_controller"
            code, body = _http(base, "/rollout", {"candidate": {"x": 1}})
            assert code == 503
            assert body["type"] == "no_rollout_controller"
        finally:
            rt.stop()

    def test_admin_lifecycle_and_validation(self):
        reg = _FakeRegistry()
        sup = _FakeSupervisor(ReplicaSpec(seed=0), 2, reg)
        ctl = _controller(sup, window_s=0.2, canary_windows=100)
        rt = RouterServer(ReplicaRegistry(), port=0, rollout=ctl,
                          own_registry_thread=False).start()
        try:
            base = "http://%s:%d" % rt.address
            code, body = _http(base, "/rollout", b"not json")
            assert (code, body["type"]) == (400, "bad_request")
            code, body = _http(base, "/rollout", {"nope": 1})
            assert (code, body["type"]) == (400, "bad_request")
            code, body = _http(base, "/rollout", {"candidate": {}})
            assert (code, body["type"]) == (400, "bad_request")
            # a shape the CONTROLLER refuses (1-replica fleet) is a
            # typed bad_candidate, distinct from a malformed body
            sup1 = _FakeSupervisor(ReplicaSpec(seed=0), 1,
                                   _FakeRegistry())
            rt.rollout = _controller(sup1)
            code, body = _http(base, "/rollout",
                               {"candidate": {"slots": 8}})
            assert (code, body["type"]) == (400, "bad_candidate")
            rt.rollout = ctl
            # accepted: 202 + live status; visible through GET and the
            # router's own /stats
            code, body = _http(base, "/rollout",
                               {"candidate": {"slots": 8}})
            assert code == 202
            assert body["active"] is True
            assert body["config_generation"] == 1
            code, body = _http(base, "/rollout")
            assert code == 200 and body["active"] is True
            code, body = _http(base, "/stats")
            assert body["rollout"]["active"] is True
            # a second start while active is a 409, not a new rollout
            code, body = _http(base, "/rollout",
                               {"candidate": {"slots": 16}})
            assert (code, body["type"]) == (409, "rollout_active")
            # operator abort over HTTP unwinds it
            code, body = _http(base, "/rollout", {"abort": True})
            assert code == 200
            assert ctl.wait(10.0)
            assert ctl.state == "rolled_back"
            assert ctl.trip_reason == "operator_abort"
        finally:
            ctl.abort()
            ctl.wait(10.0)
            rt.stop()