"""The port's serving front tier (``horovod_tpu_torch/serving/router/``)
against the JAX package's, on the CPU.

* The copies: ``metrics.py``, ``registry.py`` and ``server.py`` are the
  JAX modules code for code once the JAX source names the port's
  package; ``supervisor.py`` is too, less its named departures;
  ``replica_main.py`` keeps the JAX parsers and command line, plus
  ``--device``; the package exports what the JAX one does.
* The JAX tier-1 classes of ``tests/test_router.py`` on the same fakes
  (stdlib HTTP servers impersonating replicas): ``TestRegistry``,
  ``TestRouterProxy``, ``TestResumeFailover``, ``TestRouterSpans`` and
  ``TestSupervisorBackoff``, run against the port's modules;
  ``TestStatsContract`` against the port's own engine on the CPU, with
  the keys and types the registry and the rollout controller read held
  to the JAX engine's.
* The model half of ``replica_main``: pickles that round-trip between
  the packages, ``--tp`` above 1 and a missing CUDA device refused.
* The slice as a whole: a tiny JAX model through the JAX ``dump_model``
  into two port replicas (``--device cpu``) behind the port's router,
  one SIGKILLed mid-burst; every reply equals the JAX
  ``greedy_decode``.
"""

import ast
import json
import os
import re
import signal
import socket
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu.serving.router as JROUTER
from horovod_tpu import serving as JS
from horovod_tpu.models import transformer as JT
from horovod_tpu.serving.router import replica_main as JRM
from horovod_tpu_torch import serving
from horovod_tpu_torch.models import transformer as T
from horovod_tpu_torch.serving import router as TROUTER
from horovod_tpu_torch.serving.router import replica_main as TRM
from horovod_tpu_torch.serving.router import supervisor as TSUP
from horovod_tpu_torch.serving.router import (
    ReplicaEndpoint,
    ReplicaRegistry,
    ReplicaSpec,
    ReplicaSupervisor,
    RouterServer,
)
from horovod_tpu_torch.serving.router.replica_main import parse_fault

import torch_port_parity as P

pytestmark = pytest.mark.router

ROOT = Path(__file__).resolve().parents[1]


def _tree(pkg: str, rel: str, rename: bool) -> ast.Module:
    """The module's syntax tree without its docstring; ``rename`` turns
    every ``horovod_tpu`` module name of the JAX source into the
    port's."""
    text = (ROOT / pkg / rel).read_text()
    if rename:
        text = re.sub(r"\bhorovod_tpu\b", "horovod_tpu_torch", text)
    tree = ast.parse(text)
    tree.body = tree.body[1:]
    return tree


def _defs(tree: ast.Module) -> dict:
    return {getattr(n, "name", None): n for n in tree.body}


# ---------------------------------------------------------------------------
# the copies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rel", ["serving/router/metrics.py",
                                 "serving/router/registry.py",
                                 "serving/router/server.py"])
def test_copies_stay_verbatim(rel):
    """The port's module is the JAX package's, code for code, once the
    JAX source names the port's package."""
    assert ast.dump(_tree("horovod_tpu_torch", rel, False)) == \
        ast.dump(_tree("horovod_tpu", rel, True))


def test_supervisor_copy_but_four_departures():
    """``supervisor.py`` is the JAX module less its departures:
    ``ReplicaSpec.device`` rendered as ``--device``; no ``XLA_FLAGS`` for a
    ``tp > 1`` spec.  Like the JAX module it takes ``_free_port`` from the
    runner's ``run_func`` (which held its own copy before the port had a
    runner).  (The spawned module's name follows the rename.)"""
    def strip(tree, jax_side):
        body = []
        for node in tree.body:
            if isinstance(node, ast.ClassDef) and \
                    node.name == "ReplicaSpec" and not jax_side:
                n = len(node.body)
                node.body = [f for f in node.body if not (
                    isinstance(f, ast.AnnAssign)
                    and f.target.id == "device")]
                assert len(node.body) == n - 1
                cmd = _defs(node)["command"].body[0].value
                assert [ast.unparse(e) for e in cmd.elts[-2:]] == \
                    ["'--device'", "self.device"]
                cmd.elts = cmd.elts[:-2]
            body.append(node)
        tree.body = body
        for node in ast.walk(tree):
            if isinstance(node, ast.If) and ast.unparse(node.test) == \
                    "tp > 1" and jax_side:
                assert "XLA_FLAGS" in ast.unparse(node.body[:2])
                node.body = node.body[2:]
        return ast.dump(tree)

    rel = "serving/router/supervisor.py"
    assert strip(_tree("horovod_tpu_torch", rel, False), False) == \
        strip(_tree("horovod_tpu", rel, True), True)
    # The supervisor's _free_port is the port runner's, which is the JAX
    # runner's, code for code.
    from horovod_tpu.runner import run_func

    from horovod_tpu_torch.runner import run_func as port_run_func

    assert TSUP._free_port is port_run_func._free_port
    jax_free = _defs(ast.parse(Path(run_func.__file__).read_text()))
    port_free = _defs(_tree("horovod_tpu_torch", "runner/run_func.py", False))
    assert ast.dump(port_free["_free_port"]) == \
        ast.dump(jax_free["_free_port"])


def test_replica_main_keeps_the_jax_command_line():
    """``replica_main``'s parsers are the JAX ones, code for code, and its
    command line is the JAX one plus ``--device``, each shared flag with
    the JAX default."""
    rel = "serving/router/replica_main.py"
    port = _defs(_tree("horovod_tpu_torch", rel, False))
    jax_ = _defs(_tree("horovod_tpu", rel, True))
    for name in ("parse_setting", "parse_fault"):
        assert ast.dump(port[name]) == ast.dump(jax_[name])

    def flags(fn):
        out = {}
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "attr", None) == "add_argument"):
                kw = {k.arg: ast.unparse(k.value) for k in node.keywords
                      if k.arg in ("default", "type", "action", "dest")}
                out[node.args[0].value] = kw
        return out

    pf, jf = flags(port["main"]), flags(jax_["main"])
    assert set(pf) - set(jf) == {"--device"}
    assert set(jf) <= set(pf)
    for name in jf:
        assert pf[name] == jf[name], name


def test_package_exports_match():
    assert TROUTER.__all__ == JROUTER.__all__
    for name in JROUTER.__all__:
        a, b = getattr(TROUTER, name), getattr(JROUTER, name)
        assert getattr(a, "__name__", a) == getattr(b, "__name__", b)


class _FakeReplica:
    """A stdlib HTTP server impersonating one replica: ``/stats``
    serves a mutable snapshot dict, ``/generate`` behavior is scripted
    per instance (``ok`` / ``drop`` / ``hang`` / an HTTP status)."""

    def __init__(self, rid, *, queue_depth=0, occupancy=0.0,
                 state="healthy", heartbeat=0.01):
        self.rid = rid
        self.stats = {"queue_depth": queue_depth, "occupancy": occupancy,
                      "engine_state": state, "heartbeat_age_s": heartbeat}
        self.mode = "ok"
        self.hang_s = 10.0
        self.seen_trace_ids = []
        self.seen_parent_spans = []
        self.seen_sampled = []
        self.seen_bodies = []
        self.generate_hits = 0
        self.reply_tokens = [1, 2, 3]
        self.resume_desc = None  # payload for mode="503resume"
        fake = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _json(self, code, payload, headers=()):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                for k, v in headers:
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/stats":
                    self._json(200, dict(fake.stats))
                else:
                    self._json(404, {})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                try:
                    fake.seen_bodies.append(json.loads(raw or b"{}"))
                except json.JSONDecodeError:
                    fake.seen_bodies.append(None)
                fake.generate_hits += 1
                fake.seen_trace_ids.append(
                    self.headers.get("X-Trace-Id"))
                fake.seen_parent_spans.append(
                    self.headers.get("X-Parent-Span"))
                fake.seen_sampled.append(
                    self.headers.get("X-Trace-Sampled"))
                if fake.mode == "drop":
                    # Die mid-request, SIGKILL-style: no status line,
                    # no body, just a dead socket.
                    self.connection.shutdown(socket.SHUT_RDWR)
                    self.connection.close()
                    return
                if fake.mode == "hang":
                    time.sleep(fake.hang_s)
                if fake.mode == "503":
                    self._json(503, {"error": "draining",
                                     "type": "draining"},
                               headers=[("Retry-After", "1")])
                    return
                if fake.mode == "429":
                    self._json(429, {"error": "queue full",
                                     "type": "queue_full"})
                    return
                if fake.mode == "503resume":
                    # A terminal engine failure mid-request: the typed
                    # 503 carries the resume descriptor, exactly like
                    # serving/server.py's engine_failed path.
                    self._json(503, {"error": "engine failed",
                                     "type": "engine_failed",
                                     "resume": fake.resume_desc})
                    return
                self._json(200, {"tokens": list(fake.reply_tokens),
                                 "finish_reason": "length",
                                 "served_by": fake.rid})

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    @property
    def endpoint(self):
        host, port = self._httpd.server_address[:2]
        return ReplicaEndpoint(self.rid, host, port)

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()


def _registry(*fakes, **kw):
    kw.setdefault("poll_interval", 0.05)
    kw.setdefault("poll_timeout", 1.0)
    reg = ReplicaRegistry(**kw)
    for f in fakes:
        reg.add(f.endpoint)
    reg.poll_now()
    return reg


def _post(base, payload, headers=(), timeout=30):
    req = urllib.request.Request(
        base + "/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **dict(headers)})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


class TestRegistry:
    def test_jsq_picks_shortest_queue_then_occupancy(self):
        fakes = [_FakeReplica("a", queue_depth=5, occupancy=0.2),
                 _FakeReplica("b", queue_depth=1, occupancy=0.9),
                 _FakeReplica("c", queue_depth=1, occupancy=0.1)]
        reg = _registry(*fakes)
        try:
            assert reg.pick().endpoint.rid == "c"  # ties broken by occ
            fakes[2].stats["queue_depth"] = 7
            reg.poll_now()
            assert reg.pick().endpoint.rid == "b"
        finally:
            for f in fakes:
                f.stop()

    def test_jsq_round_robin_among_ties(self):
        fakes = [_FakeReplica("a"), _FakeReplica("b"), _FakeReplica("c")]
        reg = _registry(*fakes)
        try:
            picks = [reg.pick().endpoint.rid for _ in range(6)]
            # All equal load: every replica shares, none is dogpiled.
            assert sorted(set(picks)) == ["a", "b", "c"]
            assert picks[:3] != [picks[0]] * 3
        finally:
            for f in fakes:
                f.stop()

    def test_pick_excludes_tried_replicas(self):
        fakes = [_FakeReplica("a"), _FakeReplica("b")]
        reg = _registry(*fakes)
        try:
            assert reg.pick(exclude={"a", "b"}) is None
            assert reg.pick(exclude={"a"}).endpoint.rid == "b"
        finally:
            for f in fakes:
                f.stop()

    def test_nonroutable_states_leave_rotation(self):
        f = _FakeReplica("a")
        reg = _registry(f)
        try:
            assert reg.is_routable("a")
            for state in ("draining", "failed", "unknown"):
                f.stats["engine_state"] = state
                reg.poll_now()
                assert not reg.is_routable("a"), state
            f.stats["engine_state"] = "degraded"  # restarted = routable
            reg.poll_now()
            assert reg.is_routable("a")
            assert reg.metrics.replica_evictions.value == 1
        finally:
            f.stop()

    def test_stale_heartbeat_evicts(self):
        f = _FakeReplica("a", heartbeat=0.01)
        reg = _registry(f, heartbeat_stale=5.0)
        try:
            assert reg.is_routable("a")
            f.stats["heartbeat_age_s"] = 99.0  # engine stopped ticking
            reg.poll_now()
            assert not reg.is_routable("a")
        finally:
            f.stop()

    def test_never_ticked_gets_startup_grace_then_evicts(self):
        f = _FakeReplica("a", heartbeat=-1.0)
        reg = _registry(f, heartbeat_stale=5.0, startup_grace=0.2)
        try:
            assert reg.is_routable("a")  # warming, within grace
            time.sleep(0.25)
            assert not reg.is_routable("a")  # never ticked: wedged
        finally:
            f.stop()

    def test_poll_failures_evict_after_threshold(self):
        f = _FakeReplica("a")
        reg = _registry(f, fail_threshold=2)
        try:
            assert reg.is_routable("a")
        finally:
            f.stop()  # replica gone: polls now fail
        reg.poll_now()
        assert reg.is_routable("a")  # one failure: benefit of the doubt
        reg.poll_now()
        assert not reg.is_routable("a")
        assert reg.metrics.poll_errors.value == 2

    def test_mark_failed_is_immediate_readmit_needs_hysteresis(self):
        f = _FakeReplica("a")
        reg = _registry(f)  # readmit_threshold default 2
        try:
            reg.mark_failed("a")
            assert not reg.is_routable("a")
            assert reg.pick() is None
            reg.poll_now()  # first good poll: still out (hysteresis)
            assert not reg.is_routable("a")
            reg.poll_now()  # second CONSECUTIVE good poll re-admits
            assert reg.is_routable("a")
        finally:
            f.stop()

    def test_flapping_replica_stays_out_of_rotation(self):
        """Regression: a replica that answers only
        every other poll must NOT oscillate in and out of rotation —
        before re-admission hysteresis, each good poll re-admitted it
        for a full poll interval and each bad one evicted it again."""
        f = _FakeReplica("a")
        reg = _registry(f, fail_threshold=1, readmit_threshold=2)
        good = dict(f.stats)
        try:
            assert reg.is_routable("a")
            for _ in range(4):     # flap: fail, ok, fail, ok, ...
                f.stats.clear()    # garbage payload = failed poll
                reg.poll_now()
                assert not reg.is_routable("a")
                f.stats.update(good)
                reg.poll_now()     # ONE good poll must not re-admit
                assert not reg.is_routable("a")
            # Steady recovery: the second consecutive good poll readmits.
            reg.poll_now()
            assert reg.is_routable("a")
        finally:
            f.stop()

    def test_canary_weighted_pick_is_deterministic(self):
        fakes = [_FakeReplica("a"), _FakeReplica("b"), _FakeReplica("c")]
        reg = _registry(*fakes)
        try:
            reg.set_canary("c", 0.25)
            picks = [reg.pick().endpoint.rid for _ in range(40)]
            # Credit accumulator: exactly weight * picks go canary-ward.
            assert picks.count("c") == 10
            # Incumbents split the rest; nobody is starved.
            assert picks.count("a") > 0 and picks.count("b") > 0
            reg.clear_canary()
            picks = [reg.pick().endpoint.rid for _ in range(9)]
            assert picks.count("c") == 3  # plain JSQ round-robin again
        finally:
            for f in fakes:
                f.stop()

    def test_canary_alone_in_rotation_still_picked(self):
        """Availability beats the traffic split: a canary that is the
        only routable replica serves everything rather than nothing."""
        fakes = [_FakeReplica("a"), _FakeReplica("b")]
        reg = _registry(*fakes)
        try:
            reg.set_canary("b", 0.1)
            fakes[0].stats["engine_state"] = "failed"
            reg.poll_now()
            picks = [reg.pick().endpoint.rid for _ in range(5)]
            assert picks == ["b"] * 5
        finally:
            for f in fakes:
                f.stop()

    def test_config_generation_tracked_from_stats(self):
        f = _FakeReplica("a")
        reg = _registry(f)
        try:
            assert reg.statuses()[0].config_gen == 0  # absent -> 0
            f.stats["config_generation"] = 3
            reg.poll_now()
            st = reg.statuses()[0]
            assert st.config_gen == 3
            assert st.as_dict()["config_generation"] == 3
        finally:
            f.stop()


@pytest.fixture
def front():
    """(router base url, fakes dict, registry, router) over two fake
    replicas, polls driven MANUALLY (no thread) for determinism."""
    fakes = {"a": _FakeReplica("a"), "b": _FakeReplica("b")}
    reg = _registry(*fakes.values())
    rt = RouterServer(reg, port=0, max_attempts=3, retry_backoff=0.01,
                      proxy_timeout=2.0, own_registry_thread=False)
    rt.start()
    host, port = rt.address
    yield f"http://{host}:{port}", fakes, reg, rt
    rt.stop()
    for f in fakes.values():
        f.stop()


class TestRouterProxy:
    def test_proxies_and_tags_replica(self, front):
        base, fakes, reg, rt = front
        code, resp, hdrs = _post(base, {"tokens": [1], "max_new_tokens": 2})
        assert code == 200 and resp["tokens"] == [1, 2, 3]
        assert hdrs["X-Router-Replica"] in ("a", "b")
        assert hdrs["X-Router-Attempts"] == "1"
        assert reg.metrics.requests.value == 1

    def test_trace_id_propagates_and_echoes(self, front):
        base, fakes, reg, rt = front
        code, resp, hdrs = _post(base, {"tokens": [1]},
                                 headers=[("X-Trace-Id", "tid-router-1")])
        assert code == 200
        assert hdrs["X-Trace-Id"] == "tid-router-1"
        served = hdrs["X-Router-Replica"]
        assert fakes[served].seen_trace_ids == ["tid-router-1"]

    def test_connection_drop_fails_over_zero_client_errors(self, front):
        base, fakes, reg, rt = front
        fakes["a"].mode = "drop"
        for _ in range(4):  # JSQ ties rotate: both replicas get tried
            code, resp, hdrs = _post(base, {"tokens": [1]})
            assert code == 200 and resp["served_by"] == "b"
        assert reg.metrics.retries.value >= 1
        assert reg.metrics.failovers.value >= 1
        assert reg.metrics.requests_failed.value == 0
        # The drop ALSO evicted a: until a poll clears it, b is alone.
        assert not reg.is_routable("a")

    def test_proxy_timeout_fails_over(self, front):
        base, fakes, reg, rt = front
        fakes["a"].mode = "hang"
        fakes["a"].hang_s = 30.0  # >> proxy_timeout=2.0
        t0 = time.monotonic()
        code, resp, hdrs = _post(base, {"tokens": [1]}, timeout=30)
        assert code == 200 and resp["served_by"] == "b"
        assert time.monotonic() - t0 < 10.0
        assert not reg.is_routable("a")

    def test_all_replicas_dead_typed_503_with_retry_after(self, front):
        base, fakes, reg, rt = front
        fakes["a"].mode = fakes["b"].mode = "drop"
        code, resp, hdrs = _post(base, {"tokens": [1]})
        assert code == 503 and resp["type"] == "no_replicas"
        assert "Retry-After" in hdrs
        assert resp["attempts"] == 2
        assert reg.metrics.requests_failed.value == 1

    def test_typed_503_from_replicas_is_relayed(self, front):
        base, fakes, reg, rt = front
        fakes["a"].mode = fakes["b"].mode = "503"
        code, resp, hdrs = _post(base, {"tokens": [1]})
        assert code == 503 and resp["type"] == "draining"
        assert "Retry-After" in hdrs
        # Both were TRIED before giving up (retry-elsewhere-first).
        assert fakes["a"].generate_hits + fakes["b"].generate_hits >= 2

    def test_429_retried_elsewhere_then_relayed(self, front):
        base, fakes, reg, rt = front
        fakes["a"].mode = "429"
        code, resp, hdrs = _post(base, {"tokens": [1]})
        assert code == 200 and resp["served_by"] == "b"
        fakes["b"].mode = "429"
        code, resp, hdrs = _post(base, {"tokens": [1]})
        assert code == 429 and resp["type"] == "queue_full"

    def test_empty_rotation_healthz_503(self):
        reg = ReplicaRegistry(poll_interval=0.05)
        rt = RouterServer(reg, port=0, own_registry_thread=False).start()
        try:
            host, port = rt.address
            try:
                urllib.request.urlopen(
                    f"http://{host}:{port}/healthz", timeout=5)
                assert False, "expected 503"
            except urllib.error.HTTPError as e:
                assert e.code == 503
                assert e.headers.get("Retry-After") is not None
                assert json.loads(e.read())["replicas_in_rotation"] == 0
        finally:
            rt.stop()

    def test_stats_and_metrics_endpoints(self, front):
        base, fakes, reg, rt = front
        _post(base, {"tokens": [1]})
        with urllib.request.urlopen(base + "/stats", timeout=5) as r:
            s = json.loads(r.read())
        assert s["policy"] == "join-shortest-queue"
        assert sorted(s["in_rotation"]) == ["a", "b"]
        assert s["replicas"]["a"]["engine_state"] == "healthy"
        with urllib.request.urlopen(base + "/metrics", timeout=5) as r:
            text = r.read().decode()
        assert "# TYPE router_requests_total counter" in text
        assert "router_replicas_in_rotation" in text


class TestResumeFailover:
    """Resume-aware failover: the router re-dispatches a
    failed replica's partially decoded request WITH its resume state —
    prompt + emitted tokens, reduced decode budget, REMAINING deadline
    — and prepends the carried tokens to the final response."""

    def _front(self, a_kw=None, b_kw=None, **rt_kw):
        # a is the JSQ choice (empty queue); b is the failover target.
        fakes = {"a": _FakeReplica("a", queue_depth=0),
                 "b": _FakeReplica("b", queue_depth=5)}
        reg = _registry(*fakes.values())
        rt_kw.setdefault("max_attempts", 3)
        rt_kw.setdefault("retry_backoff", 0.01)
        rt_kw.setdefault("proxy_timeout", 2.0)
        rt = RouterServer(reg, port=0, own_registry_thread=False,
                          **rt_kw).start()
        host, port = rt.address
        return f"http://{host}:{port}", fakes, reg, rt

    def _teardown(self, fakes, rt):
        rt.stop()
        for f in fakes.values():
            f.stop()

    def test_503_descriptor_redispatches_with_resume_state(self):
        base, fakes, reg, rt = self._front()
        try:
            fakes["a"].mode = "503resume"
            fakes["a"].resume_desc = {"emitted_tokens": [7, 8],
                                      "deadline_remaining_ms": 5000.0}
            fakes["b"].reply_tokens = [9, 11]
            code, resp, hdrs = _post(
                base, {"tokens": [1, 2], "max_new_tokens": 4,
                       "timeout_ms": 60000})
            assert code == 200
            # carried + continuation, one seamless result
            assert resp["tokens"] == [7, 8, 9, 11]
            assert resp["resumed"] is True
            assert resp["resume_carried_tokens"] == 2
            assert hdrs["X-Router-Replica"] == "b"
            # b received the RESUME dispatch: frontier prompt, reduced
            # budget, remaining (not fresh) deadline
            body = fakes["b"].seen_bodies[-1]
            assert body["tokens"] == [1, 2, 7, 8]
            assert body["max_new_tokens"] == 2
            # the REMAINING budget, aged by the router's own dwell
            # time (backoff + bookkeeping) — never a fresh 60000
            assert 3000.0 < body["timeout_ms"] <= 5000.0
            m = reg.metrics
            assert m.resume_failovers.value == 1
            assert m.failovers.value == 1
        finally:
            self._teardown(fakes, rt)

    def test_deadline_expired_mid_failover_maps_to_504(self):
        """SATELLITE: the resumed budget is what is LEFT — a
        descriptor whose deadline already lapsed resolves as the
        existing typed 504, without burning another replica."""
        base, fakes, reg, rt = self._front()
        try:
            fakes["a"].mode = "503resume"
            fakes["a"].resume_desc = {"emitted_tokens": [7, 8],
                                      "deadline_remaining_ms": 0.0}
            code, resp, hdrs = _post(
                base, {"tokens": [1, 2], "max_new_tokens": 4,
                       "timeout_ms": 60000})
            assert code == 504
            assert resp["type"] == "deadline_exceeded"
            assert resp["tokens_so_far"] == [7, 8]
            assert fakes["b"].generate_hits == 0  # never dispatched
        finally:
            self._teardown(fakes, rt)

    def test_connection_drop_resumes_via_journal_lookup(self):
        """The SIGKILL signature: a dead connection yields no
        descriptor, so the router consults resume_lookup (the
        supervisor's post-mortem journal reader) and resumes from
        whatever the dead replica journaled."""
        looked_up = []

        def lookup(rid, trace_id):
            looked_up.append((rid, trace_id))
            if rid == "a":
                return {"emitted_tokens": [21, 22, 23],
                        "deadline_remaining_ms": 8000.0}
            return None

        base, fakes, reg, rt = self._front(resume_lookup=lookup)
        try:
            fakes["a"].mode = "drop"
            fakes["b"].reply_tokens = [30]
            code, resp, hdrs = _post(
                base, {"tokens": [5, 6], "max_new_tokens": 6},
                headers=[("X-Trace-Id", "tid-sigkill")])
            assert code == 200
            assert resp["tokens"] == [21, 22, 23, 30]
            assert resp["resumed"] is True
            assert looked_up == [("a", "tid-sigkill")]
            body = fakes["b"].seen_bodies[-1]
            assert body["tokens"] == [5, 6, 21, 22, 23]
            assert body["max_new_tokens"] == 3
            assert 6000.0 < body["timeout_ms"] <= 8000.0  # aged, not fresh
            assert not reg.is_routable("a")  # still evicted on the spot
            assert reg.metrics.resume_failovers.value == 1
        finally:
            self._teardown(fakes, rt)

    def test_drop_without_descriptor_reexecutes_from_scratch(self):
        """No journal, no descriptor: the pre-journal contract holds —
        plain retry of the ORIGINAL request elsewhere."""
        base, fakes, reg, rt = self._front()
        try:
            fakes["a"].mode = "drop"
            code, resp, hdrs = _post(
                base, {"tokens": [5, 6], "max_new_tokens": 6})
            assert code == 200
            assert resp["tokens"] == [1, 2, 3]
            assert "resumed" not in resp
            body = fakes["b"].seen_bodies[-1]
            assert body["tokens"] == [5, 6]
            assert body["max_new_tokens"] == 6
            assert reg.metrics.resume_failovers.value == 0
        finally:
            self._teardown(fakes, rt)

    def test_carry_exhausting_budget_completes_without_redispatch(self):
        """A descriptor whose emitted tokens already spend the whole
        decode budget (the replica died after its last token, before
        answering): the router finishes the request from the carry —
        re-dispatching would send max_new_tokens=0 and bounce as a
        400."""
        base, fakes, reg, rt = self._front()
        try:
            fakes["a"].mode = "503resume"
            fakes["a"].resume_desc = {"emitted_tokens": [7, 8, 9],
                                      "deadline_remaining_ms": 5000.0}
            code, resp, hdrs = _post(
                base, {"tokens": [1, 2], "max_new_tokens": 3,
                       "timeout_ms": 60000})
            assert code == 200
            assert resp["tokens"] == [7, 8, 9]
            assert resp["finish_reason"] == "length"
            assert resp["resumed"] is True
            assert fakes["b"].generate_hits == 0  # nothing re-dispatched
            assert reg.metrics.resume_failovers.value == 1
        finally:
            self._teardown(fakes, rt)

    def test_carry_ending_in_eos_completes_without_redispatch(self):
        """A carried tail ending in eos_id is a FINISHED generation —
        continuing it elsewhere would decode past EOS, emitting tokens
        an uninterrupted run never would."""
        base, fakes, reg, rt = self._front()
        try:
            fakes["a"].mode = "503resume"
            fakes["a"].resume_desc = {"emitted_tokens": [7, 42],
                                      "deadline_remaining_ms": 5000.0}
            code, resp, hdrs = _post(
                base, {"tokens": [1, 2], "max_new_tokens": 9,
                       "eos_id": 42, "timeout_ms": 60000})
            assert code == 200
            assert resp["tokens"] == [7, 42]
            assert resp["finish_reason"] == "eos"
            assert resp["resumed"] is True
            assert fakes["b"].generate_hits == 0
        finally:
            self._teardown(fakes, rt)

    def test_exhausted_attempts_relay_carries_full_resume_state(self):
        """Every replica failed typed: the relayed 503's descriptor is
        rewritten to the FULL accumulated frontier, so an upstream
        caller can itself resume from the true position."""
        base, fakes, reg, rt = self._front(max_attempts=2)
        try:
            for f in fakes.values():
                f.mode = "503resume"
            fakes["a"].resume_desc = {"emitted_tokens": [7, 8],
                                      "deadline_remaining_ms": 9000.0}
            fakes["b"].resume_desc = {"emitted_tokens": [9],
                                      "deadline_remaining_ms": 7000.0}
            code, resp, hdrs = _post(
                base, {"tokens": [1, 2], "max_new_tokens": 6,
                       "timeout_ms": 60000})
            assert code == 503 and resp["type"] == "engine_failed"
            assert resp["resume"]["emitted_tokens"] == [7, 8, 9]
            # b's dispatch already carried a's tokens
            body = fakes["b"].seen_bodies[-1]
            assert body["tokens"] == [1, 2, 7, 8]
            assert body["max_new_tokens"] == 4
        finally:
            self._teardown(fakes, rt)


@pytest.mark.tracing
class TestRouterSpans:
    def _front(self, tmp_path, span_dir=True, **rt_kw):
        from horovod_tpu_torch.obs import tracing as TR

        assert TR.spans() is None
        rec = TR.start_spans(
            str(tmp_path / "router.spans.jsonl"), proc="router",
            role="router",
            sampling=TR.SpanSampling(latency_threshold_s=600.0))
        fakes = {"a": _FakeReplica("a", queue_depth=0),
                 "b": _FakeReplica("b", queue_depth=5)}
        reg = _registry(*fakes.values())
        rt_kw.setdefault("max_attempts", 3)
        rt_kw.setdefault("retry_backoff", 0.01)
        rt_kw.setdefault("proxy_timeout", 2.0)
        if span_dir:
            rt_kw.setdefault("span_dir", str(tmp_path))
        rt = RouterServer(reg, port=0, own_registry_thread=False,
                          **rt_kw).start()
        host, port = rt.address
        return f"http://{host}:{port}", fakes, reg, rt, rec

    def _teardown(self, fakes, rt):
        from horovod_tpu_torch.obs import tracing as TR

        rt.stop()
        for f in fakes.values():
            f.stop()
        TR.stop_spans()

    def _get(self, url):
        try:
            with urllib.request.urlopen(url, timeout=10) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def test_failover_builds_one_tree_with_attempt_parentage(
            self, tmp_path):
        """A 503-resume failover: the router's stream carries root +
        two attempt spans, each dispatch carries ITS attempt span id in
        X-Parent-Span, the continuation is force-sampled
        (X-Trace-Sampled), and GET /trace/<id> assembles the tree with
        the resume edge and carried-token accounting."""
        base, fakes, reg, rt, rec = self._front(tmp_path)
        try:
            fakes["a"].mode = "503resume"
            fakes["a"].resume_desc = {"emitted_tokens": [7, 8],
                                      "deadline_remaining_ms": 5000.0,
                                      "span_id": "deadbeefdeadbeef"}
            fakes["b"].reply_tokens = [9, 11]
            code, resp, hdrs = _post(
                base, {"tokens": [1, 2], "max_new_tokens": 4,
                       "timeout_ms": 60000})
            assert code == 200 and resp["resumed"] is True
            tid = hdrs["X-Trace-Id"]
            # each replica saw a DIFFERENT parent (its own attempt span)
            pa, pb = (fakes["a"].seen_parent_spans[-1],
                      fakes["b"].seen_parent_spans[-1])
            assert pa and pb and pa != pb
            # first attempt: nothing interesting yet — not forced;
            # the failover continuation IS forced end to end
            assert fakes["a"].seen_sampled[-1] is None
            assert fakes["b"].seen_sampled[-1] == "1"

            code, autopsy = self._get(f"{base}/trace/{tid}")
            assert code == 200
            assert autopsy["resumed"] is True
            assert autopsy["carried_tokens"] == 2
            assert autopsy["retries"] == 1
            root = autopsy["tree"][0]
            assert root["name"] == "router /generate"
            att = {c["name"]: c for c in root["children"]}
            assert set(att) == {"attempt 1 -> a", "attempt 2 -> b"}
            assert att["attempt 1 -> a"]["span_id"] == pa
            assert att["attempt 2 -> b"]["span_id"] == pb
            assert att["attempt 1 -> a"]["status"] == "http:503"
            assert att["attempt 2 -> b"]["status"] == "http:200"
            resume_ev = [e for e in autopsy["events"]
                         if e["type"] == "resume"][0]
            assert resume_ev["attrs"]["carried"] == 2
            # the descriptor's span id links the dead attempt in
            assert resume_ev["attrs"]["resumed_from_span"] \
                == "deadbeefdeadbeef"
            assert root["attrs"]["attempts"] == 2
            assert root["attrs"]["resumed"] is True
            assert root["status"] == "http:200"
        finally:
            self._teardown(fakes, rt)

    def test_router_ingress_parent_span_validation(self, tmp_path):
        """ROUTER-ingress twins of the replica-ingress edge cases
        (tests/test_tracing.py): a client X-Parent-Span nests the
        router root — but only alongside a VALID X-Trace-Id; spoofed /
        malformed / oversized parents are dropped."""
        base, fakes, reg, rt, rec = self._front(tmp_path)
        try:
            cases = [
                ({"X-Trace-Id": "up-1", "X-Parent-Span": "c" * 16},
                 "up-1", "c" * 16),       # valid: honored
                ({"X-Parent-Span": "d" * 16},
                 None, None),             # spoofed on a fresh trace
                ({"X-Trace-Id": "up-2", "X-Parent-Span": "x" * 65},
                 "up-2", None),           # oversized
                ({"X-Trace-Id": "up-3", "X-Parent-Span": "sp ace"},
                 "up-3", None),           # malformed
                ({"X-Trace-Id": "bad id!", "X-Parent-Span": "e" * 16},
                 None, None),             # invalid trace id => both out
            ]
            for headers, want_tid, want_parent in cases:
                code, resp, _ = _post(
                    base, {"tokens": [1], "max_new_tokens": 2},
                    headers=headers)
                assert code == 200
                tid = resp.get("trace_id") or \
                    fakes["a"].seen_trace_ids[-1]
                if want_tid is not None:
                    assert tid == want_tid
                with open(rec.path) as f:
                    roots = [json.loads(l) for l in f
                             if '"router /generate"' in l]
                root = [r for r in roots if r["trace"] == tid][-1]
                assert root.get("parent") == want_parent, headers
        finally:
            self._teardown(fakes, rt)

    def test_client_force_sample_rides_through_to_the_replica(
            self, tmp_path):
        """X-Trace-Sampled from the CLIENT (with a valid trace id — the
        same trust gate as X-Parent-Span) must reach the replica on the
        FIRST attempt: it is the documented way to capture one
        request's full tick detail through the front tier."""
        base, fakes, reg, rt, rec = self._front(tmp_path)
        try:
            _post(base, {"tokens": [1], "max_new_tokens": 2},
                  headers={"X-Trace-Id": "force-1",
                           "X-Trace-Sampled": "1"})
            assert fakes["a"].seen_sampled[-1] == "1"
            # the gate: no (valid) trace id => not trusted
            _post(base, {"tokens": [1], "max_new_tokens": 2},
                  headers={"X-Trace-Sampled": "1"})
            assert fakes["a"].seen_sampled[-1] is None
        finally:
            self._teardown(fakes, rt)

    def test_client_parent_forwarded_without_router_recorder(self):
        """A replicas-only span deployment (no recorder in the router
        process): the client's validated X-Parent-Span must still be
        FORWARDED so the replica's span joins the upstream tree —
        dropped silently only when invalid/untrusted."""
        from horovod_tpu_torch.obs import tracing as TR

        assert TR.spans() is None  # no router recorder in this test
        fakes = {"a": _FakeReplica("a")}
        reg = _registry(*fakes.values())
        rt = RouterServer(reg, port=0, own_registry_thread=False,
                          max_attempts=2, proxy_timeout=2.0).start()
        try:
            host, port = rt.address
            base = f"http://{host}:{port}"
            _post(base, {"tokens": [1], "max_new_tokens": 2},
                  headers={"X-Trace-Id": "up-fwd",
                           "X-Parent-Span": "f" * 16})
            assert fakes["a"].seen_parent_spans[-1] == "f" * 16
            _post(base, {"tokens": [1], "max_new_tokens": 2},
                  headers={"X-Parent-Span": "f" * 16})  # no trace id
            assert fakes["a"].seen_parent_spans[-1] is None
        finally:
            rt.stop()
            fakes["a"].stop()

    def test_trace_endpoint_error_paths(self, tmp_path):
        base, fakes, reg, rt, rec = self._front(tmp_path)
        try:
            code, resp = self._get(f"{base}/trace/not!valid!")
            assert code == 400 and resp["type"] == "bad_trace_id"
            code, resp = self._get(f"{base}/trace/{'0' * 16}")
            assert code == 404 and resp["type"] == "unknown_trace"
            # a broken STORE must not masquerade as a missing trace
            rt.span_dir = str(tmp_path / "moved_or_mistyped")
            code, resp = self._get(f"{base}/trace/{'0' * 16}")
            assert code == 500 and resp["type"] == "span_store_error"
        finally:
            self._teardown(fakes, rt)

    def test_trace_endpoint_without_span_dir_is_typed_503(
            self, tmp_path):
        base, fakes, reg, rt, rec = self._front(tmp_path,
                                                span_dir=False)
        try:
            code, resp = self._get(f"{base}/trace/{'0' * 16}")
            assert code == 503 and resp["type"] == "no_span_store"
        finally:
            self._teardown(fakes, rt)


class TestSupervisorBackoff:
    def test_crash_loop_respawns_with_backoff(self):
        import sys

        def cmd(slot, port):
            return [sys.executable, "-c", "import sys; sys.exit(3)"]

        reg = ReplicaRegistry(poll_interval=10.0)  # polls irrelevant
        sup = ReplicaSupervisor(cmd, 1, registry=reg,
                                backoff_initial=0.15, backoff_max=0.6,
                                backoff_reset_after=999.0,
                                monitor_interval=0.02)
        sup.start()
        try:
            deadline = time.monotonic() + 8.0
            while (reg.metrics.replica_restarts.value < 3
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            restarts = reg.metrics.replica_restarts.value
            assert restarts >= 3, "supervisor stopped respawning"
            h = sup.handle(0)
            assert h.gen >= 3 and h.rid == f"r0g{h.gen}"
        finally:
            sup.stop(drain=False)
        # Exponential backoff rate-limited the loop: in ~a second of
        # 0.15 * 2^n delays there cannot have been tens of respawns.
        assert reg.metrics.replica_restarts.value < 15

    def test_spec_command_and_fault_parsing(self):
        spec = ReplicaSpec(seed=7, slots=3, warm=(8, 16),
                           faults=("decode_tick:hang:5:2.5",))
        cmd = spec.command(1234)
        assert "--port" in cmd and "1234" in cmd
        assert cmd.count("--warm") == 2 and "--fault" in cmd
        f = parse_fault("decode_tick:hang:5:2.5")
        assert (f.site, f.kind, f.skip, f.delay) == \
            ("decode_tick", "hang", 5, 2.5)
        with pytest.raises(Exception):
            parse_fault("nonsense")

# ---------------------------------------------------------------------------
# the /stats routing contract + Retry-After on the port's engine
# ---------------------------------------------------------------------------


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model():
    """The tiny f32 model in both packages (one set of weights)."""
    return P.make_model(0)


def _engine(model, **kw):
    return serving.InferenceEngine(
        model.tparams, model.tcfg,
        serving.EngineConfig(n_slots=2, max_len=16, **kw), device="cpu")


#: The /stats keys the registry and the rollout controller read.
CONTRACT = ("queue_depth", "occupancy", "engine_state", "heartbeat_age_s",
            "tp", "mesh", "config_generation", "tokens_generated",
            "decode_ticks", "preemptions", "ttft_seconds_by_class",
            "autotune")


@pytest.mark.serving
class TestStatsContract:
    def test_contract_keys_always_present_and_typed(self, model):
        engine = _engine(model)
        snap = engine.stats()  # BEFORE any tick: the cold-start shape
        assert isinstance(snap["queue_depth"], int)
        assert isinstance(snap["occupancy"], float)
        assert isinstance(snap["engine_state"], str)
        assert isinstance(snap["heartbeat_age_s"], float)
        assert snap["heartbeat_age_s"] == -1.0  # no tick yet, not null
        assert snap["engine_state"] == "healthy"

        fut = engine.submit([1, 2, 3], max_new_tokens=3)
        while not fut.done():
            engine.step()
        snap = engine.stats()
        assert snap["heartbeat_age_s"] >= 0.0
        assert isinstance(snap["occupancy"], float)
        assert isinstance(snap["queue_depth"], int)

    def test_registry_polls_a_real_server(self, model):
        engine = _engine(model)
        with serving.ServingServer(engine, port=0) as srv:
            host, port = srv.address
            reg = ReplicaRegistry(poll_interval=0.05)
            reg.add(ReplicaEndpoint("real", host, port))
            reg.poll_now()
            assert reg.is_routable("real")
            engine.begin_drain()
            reg.poll_now()
            assert not reg.is_routable("real")  # draining leaves rotation

    def test_draining_503_carries_retry_after(self, model):
        engine = _engine(model)
        with serving.ServingServer(engine, port=0) as srv:
            host, port = srv.address
            engine.begin_drain()
            code, resp, hdrs = _post(
                f"http://{host}:{port}",
                {"tokens": [1, 2], "max_new_tokens": 2})
            assert code == 503 and resp["type"] == "draining"
            assert hdrs.get("Retry-After") == "1"
            try:
                urllib.request.urlopen(
                    f"http://{host}:{port}/healthz", timeout=5)
                assert False, "expected 503"
            except urllib.error.HTTPError as e:
                assert e.code == 503
                assert e.headers.get("Retry-After") is not None
                assert isinstance(
                    json.loads(e.read())["heartbeat_age_s"], float)

    def test_contract_types_match_the_jax_engine(self, model):
        """Every key the registry and the rollout controller read, after
        the same request on both engines: present, of the JAX engine's
        type, and the per-class TTFT histogram of the JAX shape."""
        jeng = JS.InferenceEngine(
            model.jparams, model.jcfg,
            JS.EngineConfig(n_slots=2, max_len=16, config_generation=3))
        teng = _engine(model, config_generation=3)
        for eng in (jeng, teng):
            fut = eng.submit([1, 2, 3], max_new_tokens=3)
            while not fut.done():
                eng.step()
        js, ts = jeng.stats(), teng.stats()
        for key in CONTRACT:
            assert type(ts[key]) is type(js[key]), key
        assert (ts["tp"], ts["mesh"], ts["config_generation"]) == \
            (js["tp"], js["mesh"], 3) == (1, "", 3)
        assert ts["autotune"] is False and "tuning" not in ts
        jh = js["ttft_seconds_by_class"]["interactive"]
        th = ts["ttft_seconds_by_class"]["interactive"]
        assert set(th) == set(jh)
        assert list(th["buckets"]) == list(jh["buckets"])
        assert th["count"] == jh["count"] == 1
        # The registry reads them into the same status either way.
        for snap in (js, ts):
            st = _status_from(snap)
            assert st["config_generation"] == 3 and st["tp"] == 1


def _status_from(snap):
    """The registry's view of one /stats payload (served by a fake)."""
    f = _FakeReplica("x")
    f.stats = dict(snap)
    reg = _registry(f)
    try:
        return reg.statuses()[0].as_dict()
    finally:
        f.stop()


# ---------------------------------------------------------------------------
# replica_main's model half
# ---------------------------------------------------------------------------


def _args(**kw):
    import argparse

    base = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                max_seq=48, kv_heads=2, seed=0)
    base.update(kw)
    return argparse.Namespace(**base)


def test_jax_pickle_serves_from_the_port(model, tmp_path):
    """A pickle the JAX ``dump_model`` wrote loads into the port (its
    config field for field, the weights exactly), and the port's engine
    on it gives the JAX ``greedy_decode``'s tokens."""
    path = str(tmp_path / "jax.pkl")
    JRM.dump_model(path, model.jparams, model.jcfg)
    params, cfg = TRM.load_model(path, device="cpu")
    assert (cfg.vocab_size, cfg.d_model, cfg.n_layers, cfg.n_kv_heads,
            cfg.dtype, cfg.attention_impl) == \
        (64, 32, 2, 2, torch.float32, "reference")
    flat_t = {k: v for k, v in params["layers"].items()}
    for k, v in model.jparams["layers"].items():
        assert np.array_equal(flat_t[k].numpy(), np.asarray(v)), k
    engine = serving.InferenceEngine(
        params, cfg, serving.EngineConfig(n_slots=2, max_len=40),
        device="cpu")
    prompt = [3, 1, 4, 1, 5]
    fut = engine.submit(prompt, max_new_tokens=12)
    while not fut.done():
        engine.step()
    want = np.asarray(JT.greedy_decode(
        model.jparams, jnp.asarray([prompt], jnp.int32), 12,
        model.jcfg))[0].tolist()
    assert fut.result() == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_pickle_loads_in_jax(dtype, tmp_path):
    """The port's ``dump_model`` writes the JAX format: f32 numpy leaves
    (no bf16 array, whatever the model's dtype) and the config with the
    dtype by name; the JAX ``load_model`` reads it back to the same
    weights and a config of the same fields."""
    cfg = T.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                              n_layers=2, d_ff=64, max_seq=48,
                              n_kv_heads=2, dtype=dtype,
                              attention_impl="flash")
    params = T.init_params(cfg, seed=3, device="cpu")
    path = str(tmp_path / "port.pkl")
    TRM.dump_model(path, params, cfg)
    jparams, jcfg = JRM.load_model(path)
    leaves = jax.tree_util.tree_leaves(jparams)
    assert leaves and all(x.dtype == np.float32 for x in leaves)
    assert jcfg.dtype == getattr(jnp, str(dtype).split(".")[1])
    assert (jcfg.d_model, jcfg.n_kv_heads, jcfg.attention_impl) == \
        (32, 2, "flash")
    for k, v in params["layers"].items():
        assert np.array_equal(np.asarray(jparams["layers"][k]),
                              v.float().numpy()), k
    # ... and the port reads its own pickle back unchanged.
    back, bcfg = TRM.load_model(path, device="cpu")
    assert bcfg == cfg
    for k, v in params["layers"].items():
        assert torch.equal(back["layers"][k], v), k


def test_build_model_is_seeded_f32(tmp_path):
    (a, cfg), (b, _) = (TRM.build_model(_args(seed=5), device="cpu")
                        for _ in range(2))
    assert cfg.dtype == torch.float32 and cfg.attention_impl == "reference"
    assert torch.equal(a["embed"], b["embed"])
    c, _ = TRM.build_model(_args(seed=6), device="cpu")
    assert not torch.equal(a["embed"], c["embed"])


def test_replica_refuses_tp_and_a_missing_card(monkeypatch):
    """A ``--tp`` the model cannot split (3 over 4 heads) raises the typed
    ``ShardingConfigError`` before any rank starts; ``--device cuda``
    without a CUDA device raises, never serving from the CPU instead."""
    from horovod_tpu_torch.serving.sharding import ShardingConfigError

    with pytest.raises(ShardingConfigError, match="n_heads"):
        TRM.main(["--port", "0", "--tp", "3", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TRM.main(["--port", "0"])
    spec = ReplicaSpec(seed=1)
    cmd = spec.command(1234)
    assert cmd[cmd.index("--device") + 1] == "cuda"
    cmd = ReplicaSpec(device="cpu").command(1)
    assert cmd[cmd.index("--device") + 1] == "cpu"


def test_free_port_binds():
    port = TSUP._free_port()
    with socket.socket() as s:
        s.bind(("127.0.0.1", port))


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

#: The whole-slice test's own time limit (seconds): replica start-up,
#: the burst, the kill and the resume.
SLICE_LIMIT_S = 150


class _TimeLimit:
    """Fail (not hang) past ``seconds``: SIGALRM in the main thread."""

    def __init__(self, seconds):
        self.seconds = seconds

    def __enter__(self):
        def fire(signum, frame):
            raise TimeoutError(f"over the {self.seconds} s time limit")

        self._old = signal.signal(signal.SIGALRM, fire)
        signal.alarm(self.seconds)
        return self

    def __exit__(self, *exc):
        signal.alarm(0)
        signal.signal(signal.SIGALRM, self._old)
        return False


def _ref_greedy(model, prompt, steps):
    return np.asarray(JT.greedy_decode(
        model.jparams, jnp.asarray([prompt], jnp.int32), steps,
        model.jcfg))[0].tolist()


def _burst(base, prompts, steps, kill_after=None, timeout=60):
    """One concurrent request per prompt; ``kill_after()`` once half of
    them are in flight.  An entry for every request: a transport error
    to the router would be a dropped request."""
    results = {}
    started = threading.Semaphore(0)

    def client(i):
        started.release()
        try:
            code, resp, hdrs = _post(base, {"tokens": prompts[i],
                                            "max_new_tokens": steps},
                                     timeout=timeout)
            results[i] = (code, resp, hdrs)
        except Exception as e:  # transport failure = a drop
            results[i] = (None, repr(e), {})

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    if kill_after is not None:
        for _ in range(len(prompts) // 2):
            started.acquire()
        kill_after()
    for t in threads:
        t.join()
    return results


@pytest.mark.chaos
def test_jax_pickle_two_port_replicas_sigkill_mid_burst(model, tmp_path):
    """The slice end to end: the JAX ``dump_model`` pickle served by two
    port replicas (``--device cpu``) behind the port's router with
    journals and ``resume_lookup``; one replica SIGKILLed while a request
    is mid-decode.  Every request returns 200 with tokens equal to the
    JAX ``greedy_decode`` of that pickle, exactly, at least one of them
    resumed from the dead replica's journal; the slot respawns.  Each
    decode tick is paced by a 25 ms ``hang`` fault so the kill lands
    mid-decode."""
    steps = 20
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(1, 60, 2 + i % 4)]
               for i in range(6)]
    # The oracles before any replica exists: one process computing at a
    # time on the host's CPUs.
    want = [_ref_greedy(model, p, steps) for p in prompts]
    pkl = str(tmp_path / "model.pkl")
    JRM.dump_model(pkl, model.jparams, model.jcfg)
    pace = tuple(f"decode_tick:hang:{i}:0.025" for i in range(200))
    spec = ReplicaSpec(params_path=pkl, slots=4, warm=(8,),
                       tick_timeout=30.0, drain_timeout=3.0,
                       request_timeout=90.0, faults=pace, device="cpu")
    reg = ReplicaRegistry(poll_interval=0.1, poll_timeout=1.0,
                          heartbeat_stale=5.0)
    sup = ReplicaSupervisor(spec, 2, registry=reg, unhealthy_grace=1.5,
                            shutdown_grace=2.0, backoff_initial=0.1,
                            journal_dir=str(tmp_path / "journal"),
                            log_dir=str(tmp_path / "logs"))
    rt = RouterServer(reg, port=0, max_attempts=4, retry_backoff=0.05,
                      proxy_timeout=60.0, resume_lookup=sup.resume_lookup)
    killed = {}
    with _TimeLimit(SLICE_LIMIT_S):
        sup.start()
        rt.start()
        try:
            assert sup.wait_ready(timeout=90), "replicas never ready"
            host, port = rt.address
            base = f"http://{host}:{port}"

            def kill_busy_replica():
                deadline = time.monotonic() + 30.0
                while time.monotonic() < deadline:
                    for h in sup.replicas():
                        try:
                            live = serving.RequestJournal.read_live(
                                sup._journal_paths[h.rid])
                        except Exception:
                            continue
                        if any(3 <= len(d["emitted_tokens"]) <= steps - 6
                               for d in live.values()):
                            killed["rid"] = h.rid
                            os.kill(h.pid, signal.SIGKILL)
                            return
                    time.sleep(0.01)
                raise AssertionError("no replica ever got mid-decode")

            results = _burst(base, prompts, steps, timeout=90,
                             kill_after=kill_busy_replica)
            assert len(results) == len(prompts)
            carried = 0
            served_by = set()
            for i, (code, resp, hdrs) in results.items():
                assert code == 200, f"request {i}: {code} {resp}"
                assert resp["tokens"] == want[i], f"request {i}"
                served_by.add(hdrs.get("X-Router-Replica"))
                if resp.get("resumed"):
                    carried += resp["resume_carried_tokens"]
            assert carried >= 1, f"no request resumed: {results}"
            assert reg.metrics.resume_failovers.value >= 1
            # The killed slot respawns as the next generation.
            slot = int(killed["rid"][1:killed["rid"].index("g")])
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                h = sup.handle(slot)
                if h is not None and h.gen >= 1 and reg.is_routable(h.rid):
                    break
                time.sleep(0.1)
            else:
                raise AssertionError("the killed slot never rejoined")
        finally:
            rt.stop()
            sup.stop(drain=False)
