"""horovod_tpu_torch's serving engine against the JAX package's
``greedy_decode`` oracle and the port's own ``sample_decode``, on the
CPU at f32.

The gold check is token identity: whatever shares the slot pool and
whenever a request was admitted, its greedy output equals per-request
``greedy_decode`` of the JAX package on the same weights, and its
sampled output equals the port's per-request ``sample_decode`` at the
same seed (held to JAX's in ``test_torch_port_sampling.py``), with the
overlapped pipeline on and off.  Also here: one host sync per steady
decode tick, the HTTP front with sampling and SSE streaming, the device
rule, and import hygiene (the port never loads JAX or the JAX
package)."""

import ast
import http.client
import json
import socket
import subprocess
import sys
import textwrap
import time
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as JT
from horovod_tpu_torch import serving
from horovod_tpu_torch.models import params_from_jax
from horovod_tpu_torch.models import transformer as T
from horovod_tpu_torch.serving import sse

from conftest import http_post_json


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model():
    jcfg = JT.TransformerConfig(
        vocab_size=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
        max_seq=48, dtype=jnp.float32, attention_impl="reference",
        n_kv_heads=2)
    tcfg = T.TransformerConfig(
        vocab_size=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
        max_seq=48, dtype=torch.float32, attention_impl="flash",
        n_kv_heads=2)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, device="cpu")
    return jparams, jcfg, tparams, tcfg


def _oracle(model, prompt, steps):
    jparams, jcfg, _, _ = model
    return np.asarray(JT.greedy_decode(
        jparams, jnp.asarray([prompt], jnp.int32), steps, jcfg))[0].tolist()


def _engine(model, **kw):
    _, _, tparams, tcfg = model
    ec = dict(n_slots=3, max_len=40, max_prefills_per_tick=2,
              min_prefill_bucket=4, page_size=8)
    ec.update(kw)
    return serving.InferenceEngine(tparams, tcfg, serving.EngineConfig(**ec),
                                   device="cpu")


def _port_oracle(model, prompt, steps, seed=0, temperature=0.0, **kw):
    _, _, tparams, tcfg = model
    return T.sample_decode(tparams, torch.tensor([prompt]), steps, tcfg,
                           rng=serving.seed_key(seed),
                           temperature=temperature, **kw)[0].tolist()


def _run(engine, futs, max_ticks=300):
    for _ in range(max_ticks):
        if all(f.done() for f in futs):
            return
        engine.step()
    raise AssertionError("engine did not finish within the tick budget")


class TestEngineTokenIdentity:
    @pytest.mark.parametrize("kv", [None, "int8"])
    def test_staggered_admissions_match_jax_greedy(self, model, kv):
        """More requests than slots, admitted at different ticks, with
        unequal prompt lengths (several buckets), retired by length."""
        engine = _engine(model, kv_dtype=kv)
        rng = np.random.default_rng(7)
        prompts = [rng.integers(0, 64, n).tolist() for n in (3, 9, 5, 12, 17)]
        steps = [11, 6, 9, 11, 4]
        futs = [engine.submit(prompts[0], max_new_tokens=steps[0])]
        engine.step()
        futs.append(engine.submit(prompts[1], max_new_tokens=steps[1]))
        engine.step()
        futs += [engine.submit(p, max_new_tokens=n)
                 for p, n in zip(prompts[2:], steps[2:])]
        _run(engine, futs)
        if kv is None:  # int8 pages are lossy: checked for full length only
            for p, n, f in zip(prompts, steps, futs):
                assert f.result(timeout=0) == _oracle(model, p, n)
        for n, f in zip(steps, futs):
            assert len(f.result(timeout=0)) == n
            assert f.finish_reason == "length"
        st = engine.stats()
        assert st["requests_completed"] == 5 and st["slots_active"] == 0
        assert st["kv_pages_free"] == st["kv_pages_total"]
        assert st["host_syncs_per_tick"] is not None

    def test_eos_retirement(self, model):
        engine = _engine(model)
        prompt = [5, 9, 2, 33]
        ref = _oracle(model, prompt, 8)
        eos = ref[3]
        fut = engine.submit(prompt, max_new_tokens=8, eos_id=eos)
        _run(engine, [fut])
        assert fut.result(timeout=0) == ref[:ref.index(eos) + 1]
        assert fut.finish_reason == "eos"


# (prompt length, new tokens, sampling parameters): greedy and sampled
# requests of every kind, more than the slots, unequal lengths.
MIXED = [(3, 11, {}), (9, 6, dict(temperature=1.0, seed=1)),
         (5, 9, dict(temperature=0.8, top_k=5, seed=2)), (12, 7, {}),
         (4, 12, dict(temperature=1.3, top_p=0.9, seed=3)),
         (17, 5, dict(temperature=0.7, top_k=8, top_p=0.8, seed=4)),
         (2, 10, dict(temperature=2.0, seed=2 ** 31 - 1))]


class TestSampledEngine:
    @pytest.mark.parametrize("overlap", [True, False],
                             ids=["overlap", "sync"])
    def test_mixed_burst_equals_sample_decode(self, model, overlap):
        """A staggered burst of greedy and sampled requests: each one's
        tokens equal the port's per-request ``sample_decode`` exactly
        (greedy ones also JAX's ``greedy_decode``)."""
        engine = _engine(model, overlap=overlap)
        rng = np.random.default_rng(11)
        cases = [(rng.integers(0, 64, n).tolist(), steps, kw)
                 for n, steps, kw in MIXED]
        futs = []
        for prompt, steps, kw in cases:
            futs.append(engine.submit(prompt, max_new_tokens=steps, **kw))
            engine.step()
        _run(engine, futs)
        for (prompt, steps, kw), f in zip(cases, futs):
            assert f.result(timeout=0) == _port_oracle(model, prompt, steps,
                                                       **kw), kw
            if not kw:
                assert f.result(timeout=0) == _oracle(model, prompt, steps)
        st = engine.stats()
        assert st["overlap"] is overlap and st["decode_compilations"] == 0
        assert st["requests_completed"] == len(cases)
        assert st["kv_pages_free"] == st["kv_pages_total"]

    def test_overlap_and_sync_identical_with_eos_and_cancel(self, model):
        """The same staggered workload with an EOS stop, a mid-stream
        cancellation and a reused slot gives identical tokens and finish
        reasons with the pipeline on and off."""
        eos_ref = _port_oracle(model, [20, 21, 22], 12, seed=8,
                               temperature=1.0)
        eos = eos_ref[4]
        cases = [([3, 4, 5, 6], 9, {}),
                 ([20, 21, 22], 12, dict(temperature=1.0, seed=8,
                                         eos_id=eos)),
                 ([10, 11], 5, dict(temperature=0.9, top_k=4, seed=5)),
                 ([7, 8, 9, 1, 2, 3, 4, 5, 6], 7, {})]
        outs = {}
        for overlap in (True, False):
            engine = _engine(model, overlap=overlap, n_slots=2)
            victim = engine.submit([9, 8, 7], max_new_tokens=30,
                                   temperature=1.2, seed=6)
            futs = []
            for prompt, steps, kw in cases:
                futs.append(engine.submit(prompt, max_new_tokens=steps,
                                          **kw))
                engine.step()
                if len(victim.tokens_so_far()) >= 3 and victim.cancel():
                    pass
            _run(engine, futs + [victim])
            assert victim.finish_reason == "cancelled"
            got = victim.result(timeout=0)
            assert got == _port_oracle(model, [9, 8, 7], len(got), seed=6,
                                       temperature=1.2)
            outs[overlap] = [(f.result(timeout=0), f.finish_reason)
                             for f in futs]
            assert engine.stats()["slots_active"] == 0
        assert outs[True] == outs[False]
        assert outs[True][1] == (eos_ref[:5], "eos")
        for (prompt, steps, kw), (toks, reason) in zip(cases, outs[True]):
            if "eos_id" not in kw:
                assert toks == _port_oracle(model, prompt, steps, **kw)
                assert reason == "length"

    @pytest.mark.parametrize("overlap", [True, False],
                             ids=["overlap", "sync"])
    def test_steady_state_one_host_sync_per_tick(self, model, overlap):
        """No admission, no retirement: exactly one host sync (the fetch)
        per dispatched decode tick."""
        engine = _engine(model, overlap=overlap, n_slots=2)
        futs = [engine.submit([2, 3, 4], max_new_tokens=30),
                engine.submit([5, 6], max_new_tokens=30, temperature=1.0,
                              seed=3)]
        for _ in range(4):  # admission and the pipeline fill
            engine.step()
        syncs0 = engine.metrics.host_syncs.value
        ticks0 = engine.metrics.decode_ticks.value
        for _ in range(12):
            engine.step()
        assert not any(f.done() for f in futs)
        assert engine.metrics.decode_ticks.value - ticks0 == 12
        assert engine.metrics.host_syncs.value - syncs0 == 12
        _run(engine, futs)


class TestEngineRules:
    def test_typed_rejections(self, model):
        engine = _engine(model)
        with pytest.raises(serving.ServingError, match="temperature"):
            engine.submit([1, 2], max_new_tokens=4, temperature=-0.7)
        with pytest.raises(serving.ServingError, match="top_p"):
            engine.submit([1, 2], max_new_tokens=4, top_p=1.5)
        with pytest.raises(serving.ServingError, match="seed"):
            engine.submit([1, 2], max_new_tokens=4, seed=-1)
        with pytest.raises(serving.ServingError, match="token ids"):
            engine.submit([1, 64])
        with pytest.raises(serving.RequestTooLongError):
            engine.submit([1] * 30, max_new_tokens=20)
        small = _engine(model, n_pages=2)
        with pytest.raises(serving.CacheOutOfPagesError):
            small.submit([1] * 20, max_new_tokens=4)

    def test_nonfinite_logits_fail_every_future(self, model):
        """NaN weights: every logit is non-finite.  Under the default
        supervision each failed step restarts the engine and resumes its
        requests, until ``max_restarts + 1`` consecutive failures make it
        terminally ``failed`` with every future resolved with
        ``EngineFailedError``; ``step`` never raises.  The port checks
        the prefill's logits as well as the decode tick's, so it fails at
        every admission and no request emits a token, with the
        overlapped pipeline (the default) and without.  The JAX engine's
        synchronous tick goes through the same sequence, but emits the
        argmax of NaN from each prefill first (and its overlapped
        pipeline never spends the budget: ``ROADMAP.md``)."""
        ref = _nan_weights_record(model, "jax", overlap=False, steps=6)
        assert [o[:2] for o in ref.pop("outcomes")] == \
            [("err", "EngineFailedError")] * 3
        for overlap in (True, False):
            rec = _nan_weights_record(model, "port", overlap=overlap,
                                      steps=6)
            assert rec.pop("outcomes") == \
                [("err", "EngineFailedError", [])] * 3
            assert rec == ref
        assert rec["steps"] == [True] * 4 + [False] * 2  # terminal: idle
        assert rec["health"] == serving.FAILED and rec["terminal"]
        assert rec["trail"] == ["healthy", "degraded", "failed"]
        assert rec["counts"] == (4, 3, 6)  # failures, restarts, resumed

    def test_nonfinite_decode_logits_with_overlap_go_terminal(self, model):
        """Non-finite logits at every decode tick, finite prefills: with
        the overlapped pipeline the step after a restart only admits and
        dispatches.  It fetches nothing, so it is not a clean tick and
        refills no budget: the engine goes terminal after
        ``max_restarts + 1`` failures, each request holding the correct
        tokens its prefills emitted.  That is the synchronous tick's
        record, and the JAX engine's synchronous one, in twice the steps
        (the JAX engine's overlapped pipeline counts the dispatch-only
        step clean and restarts forever: ``ROADMAP.md``)."""
        ref = _nan_weights_record(model, "jax", overlap=False, steps=6,
                                  nan_weights=False)
        assert ref["outcomes"] == [
            ("err", "EngineFailedError", _oracle(model, [1, 2, 3], 4))] * 2 \
            + [("err", "EngineFailedError", [])]
        assert ref["steps"] == [True] * 4 + [False] * 2
        assert ref["counts"] == (4, 3, 6)
        for overlap, steps in ((False, 6), (True, 10)):
            rec = _nan_weights_record(model, "port", overlap=overlap,
                                      steps=steps, nan_weights=False)
            assert rec.pop("steps") == [True] * (steps - 2) + [False] * 2
            assert rec == {k: v for k, v in ref.items() if k != "steps"}

    def test_no_device_and_no_cuda_raises(self, model, monkeypatch):
        _, _, tparams, tcfg = model
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serving.InferenceEngine(tparams, tcfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.init_params(tcfg)


def _nan_weights_record(model, package, *, overlap, steps,
                        nan_weights=True):
    """Three requests through ``package``'s engine (two slots), ``steps``
    steps: on NaN output weights, or with ``nan_weights=False`` on the
    true weights with non-finite logits injected at every decode tick.
    Returns each step's result, each future's outcome, the health,
    terminal, the state trail and (failures, restarts, resumed)."""
    from horovod_tpu import serving as JS
    from torch_port_parity import outcome

    jparams, jcfg, tparams, tcfg = model
    S = JS if package == "jax" else serving
    faults = None
    if nan_weights:
        nan = float("nan")
        jparams = {**jparams, "head": jnp.full_like(jparams["head"], nan)}
        tparams = {**tparams, "head": torch.full_like(tparams["head"], nan)}
    else:
        faults = S.FaultInjector([S.FaultSpec(
            site="decode_tick", kind="nonfinite", max_fires=None)])
    ec = S.EngineConfig(n_slots=2, max_len=40, min_prefill_bucket=4,
                        overlap=overlap, restart_backoff=0.001,
                        restart_backoff_max=0.002, tick_timeout=0,
                        faults=faults)
    engine = JS.InferenceEngine(jparams, jcfg, ec) if package == "jax" \
        else serving.InferenceEngine(tparams, tcfg, ec, device="cpu")
    futs = [engine.submit([1, 2, 3], max_new_tokens=8) for _ in range(3)]
    worked = [engine.step() for _ in range(steps)]
    st = engine.stats()
    if engine.terminal:
        with pytest.raises(S.EngineFailedError):
            engine.submit([1])
    return {"steps": worked, "outcomes": [outcome(f) for f in futs],
            "health": engine.health, "terminal": engine.terminal,
            "trail": st["state_transitions"],
            "counts": (st["engine_failures"], st["engine_restarts"],
                       st["requests_resumed"])}


def test_http_generate_matches_jax_greedy(model):
    engine = _engine(model)
    engine.warmup((4,))
    srv = serving.ServingServer(engine, port=0).start()
    try:
        base = "http://%s:%d" % srv.address
        prompt = [4, 8, 15, 16, 23, 42]
        code, body = http_post_json(base + "/generate",
                                    {"tokens": prompt, "max_new_tokens": 7})
        assert code == 200
        assert body["tokens"] == _oracle(model, prompt, 7)
        assert body["finish_reason"] == "length"
        code, body = http_post_json(base + "/generate",
                                    {"tokens": prompt, "temperature": -1.0})
        assert code == 400 and "temperature" in body["error"]
        sampled = {"tokens": prompt, "max_new_tokens": 9,
                   "temperature": 0.9, "top_k": 10, "top_p": 0.95,
                   "seed": 1234}
        code, body = http_post_json(base + "/generate", sampled)
        assert code == 200
        assert body["tokens"] == _port_oracle(
            model, prompt, 9, seed=1234, temperature=0.9, top_k=10,
            top_p=0.95)
        for bad in ({"top_p": 2.0}, {"seed": -3}, {"top_k": "x"}):
            code, body = http_post_json(base + "/generate",
                                        {"tokens": prompt, **bad})
            assert code == 400, bad
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert r.status == 200
            assert json.loads(r.read())["status"] == "healthy"
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            st = json.loads(r.read())
        assert st["requests_completed"] >= 1 and st["device"] == "cpu"
    finally:
        srv.stop(drain_timeout=10)
    assert engine.health == serving.DRAINING


def _stream(srv, body):
    """POST a streamed /generate; returns (connection, response)."""
    c = http.client.HTTPConnection(*srv.address, timeout=30)
    c.request("POST", "/generate", json.dumps({**body, "stream": True}),
              {"Content-Type": "application/json"})
    r = c.getresponse()
    assert r.status == 200
    assert r.getheader("Content-Type") == "text/event-stream"
    return c, r


def test_http_stream_equals_reply_and_oracle(model):
    engine = _engine(model)
    engine.warmup((4,))
    srv = serving.ServingServer(engine, port=0).start()
    try:
        body = {"tokens": [4, 8, 15, 16], "max_new_tokens": 10,
                "temperature": 1.1, "top_k": 20, "seed": 77}
        c, r = _stream(srv, body)
        events = sse.read_stream(r)
        c.close()
        kinds = [k for k, _ in events]
        assert kinds == ["token"] * 10 + ["done"]
        assert [e["i"] for _, e in events[:-1]] == list(range(10))
        done = events[-1][1]
        assert [e["token"] for _, e in events[:-1]] == done["tokens"]
        code, plain = http_post_json(
            "http://%s:%d/generate" % srv.address, body)
        assert code == 200 and plain["tokens"] == done["tokens"]
        assert done["tokens"] == _port_oracle(
            model, body["tokens"], 10, seed=77, temperature=1.1, top_k=20)
        assert done["finish_reason"] == "length"
        st = engine.stats()
        assert st["streamed_tokens"] == 10
    finally:
        srv.stop(drain_timeout=10)


def test_http_stream_disconnect_frees_the_slot(model, monkeypatch):
    """A client that hangs up mid-stream cancels its request: the slot
    and its pages are free within a tick.  The tick is slowed so that
    the request is still decoding when the client leaves."""
    engine = _engine(model)
    run = engine._tick.run

    def slow_run():
        time.sleep(0.06)
        return run()

    monkeypatch.setattr(engine._tick, "run", slow_run)
    srv = serving.ServingServer(engine, port=0).start()
    try:
        c, r = _stream(srv, {"tokens": [1, 2, 3], "max_new_tokens": 30})
        parser, events = sse.SSEParser(), []
        while sum(k == "token" for k, _ in events) < 2:
            events += parser.feed(r.read1(4096))
        c.sock.shutdown(socket.SHUT_RDWR)
        c.close()
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            st = engine.stats()
            if st["disconnects"] == 1 and st["slots_active"] == 0:
                break
            time.sleep(0.05)
        assert st["disconnects"] == 1 and st["slots_active"] == 0
        assert st["requests_cancelled"] == 1
        assert st["kv_pages_free"] == st["kv_pages_total"]
    finally:
        srv.stop(drain_timeout=10)


def test_import_hygiene():
    """Importing every module of the port loads neither JAX nor the JAX
    package (a fresh interpreter, modules diffed around the import), and
    ``chip_smoke.py`` imports neither anywhere in its source (parsed, so
    imports inside functions count too)."""
    root = Path(__file__).resolve().parents[1]
    tree = ast.parse((root / "chip_smoke.py").read_text())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            imported.add(node.module)
    assert {"torch", "horovod_tpu_torch.ops"} <= imported
    bad = sorted(m for m in imported
                 if m.split(".")[0] in ("jax", "jaxlib", "horovod_tpu"))
    assert not bad, f"chip_smoke.py imports {bad}"
    code = textwrap.dedent("""
        import pkgutil, sys
        before = set(sys.modules)
        import horovod_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            horovod_tpu_torch.__path__, "horovod_tpu_torch.")]
        for name in names:
            __import__(name)
        new = set(sys.modules) - before
        bad = sorted(m for m in new if m.split(".")[0] in
                     ("jax", "jaxlib", "horovod_tpu"))
        need = {"horovod_tpu_torch.ops.threefry",
                "horovod_tpu_torch.serving.sampling",
                "horovod_tpu_torch.serving.graph",
                "horovod_tpu_torch.serving.sse",
                "horovod_tpu_torch.serving.faults",
                "horovod_tpu_torch.serving.journal"}
        print(len(names), bad, sorted(need - set(names)))
        sys.exit(1 if bad or need - set(names) or len(names) < 16 else 0)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stdout + out.stderr
