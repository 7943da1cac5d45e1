"""horovod_tpu_torch's serving engine against the JAX package's
``greedy_decode`` oracle, on the CPU at f32.

The gold check is token identity: whatever shares the slot pool and
whenever a request was admitted, its greedy output equals per-request
``greedy_decode`` of the JAX package on the same weights.  Also here:
the HTTP front, the device rule, and import hygiene (the port never
loads JAX or the JAX package)."""

import ast
import json
import subprocess
import sys
import textwrap
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


class TestEngineRules:
    def test_typed_rejections(self, model):
        engine = _engine(model)
        with pytest.raises(serving.ServingError, match="not yet ported"):
            engine.submit([1, 2], temperature=0.7)
        with pytest.raises(serving.ServingError, match="token ids"):
            engine.submit([1, 64])
        with pytest.raises(serving.RequestTooLongError):
            engine.submit([1] * 30, max_new_tokens=20)
        small = _engine(model, n_pages=2)
        with pytest.raises(serving.CacheOutOfPagesError):
            small.submit([1] * 20, max_new_tokens=4)

    def test_nonfinite_logits_fail_every_future(self, model):
        _, _, tparams, tcfg = model
        bad = {**tparams, "head": torch.full_like(tparams["head"],
                                                  float("nan"))}
        engine = serving.InferenceEngine(
            bad, tcfg, serving.EngineConfig(n_slots=2, max_len=40,
                                            min_prefill_bucket=4),
            device="cpu")
        futs = [engine.submit([1, 2, 3], max_new_tokens=4)
                for _ in range(3)]
        with pytest.raises(serving.EngineFailedError):
            for _ in range(10):
                engine.step()
        assert engine.health == serving.FAILED
        for f in futs:
            with pytest.raises(serving.EngineFailedError):
                f.result(timeout=0)
        with pytest.raises(serving.EngineFailedError):
            engine.submit([1])

    def test_no_device_and_no_cuda_raises(self, model, monkeypatch):
        _, _, tparams, tcfg = model
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serving.InferenceEngine(tparams, tcfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.init_params(tcfg)


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
                                    {"tokens": prompt, "temperature": 1.0})
        assert code == 400 and "not yet ported" in body["error"]
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert r.status == 200
            assert json.loads(r.read())["status"] == "healthy"
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            st = json.loads(r.read())
        assert st["requests_completed"] >= 1 and st["device"] == "cpu"
    finally:
        srv.stop(drain_timeout=10)
    assert engine.health == serving.DRAINING


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
        print(len(names), bad)
        sys.exit(1 if bad or len(names) < 10 else 0)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stdout + out.stderr
