"""The port's self-tuning serving (``horovod_tpu_torch/tuning/``) against
the JAX package's, on the CPU.

* The copies: ``gp.py`` and ``tuner.py`` are the JAX modules code for
  code; ``params.py`` is too, less ``cfg.paged`` (the port is paged
  only) and the chunk knob's range, narrowed to the values whose chunk
  graphs warmup captured; ``replay.py`` is the JAX module less its
  engine build (the port's, which builds every JAX knob, ``tp``
  included); the package exports what the JAX one does.
* The JAX tier-1 classes of ``tests/test_tuning.py`` on the port: the
  GP, EI, sweep and knob units, the online tuner's rollback and crash
  isolation, trace replay, ``GET /tuning`` and the restart hook.
* Parity: the GP and the optimizer on the same seeded inputs in both
  packages; ``online_knob_space`` on the same warmed configuration; a
  journal the JAX engine wrote replays on the port token for token.
* The online tuner on a port engine: every request's tokens equal the
  JAX ``greedy_decode``, and no admission shape is reached after warmup
  (on the card: no capture) while it applies values; the engine fields
  it drives (``page_grant_ahead``, ``_spec_runtime_enabled``,
  ``reset_window`` on a restart).
"""

import ast
import importlib
import json
import re
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu.tuning as JTUNE
from horovod_tpu import serving as JS
from horovod_tpu.models import transformer as JT
from horovod_tpu.tuning import gp as JGP
from horovod_tpu.tuning import params as JPARAMS
from horovod_tpu_torch import serving
from horovod_tpu_torch import tuning as TTUNE
from horovod_tpu_torch.models import transformer as T
from horovod_tpu_torch.tuning import (
    BayesianOptimizer,
    CategoricalSweep,
    GaussianProcess,
    Knob,
    KnobSpace,
    Objective,
    OnlineTuner,
    apply_settings,
    online_knob_space,
    read_trace,
    replay,
)
from horovod_tpu_torch.tuning.replay import warm_lens

import torch_port_parity as P

# The package exports a function ``replay`` that shadows the module.
TREPLAY = importlib.import_module("horovod_tpu_torch.tuning.replay")

pytestmark = [pytest.mark.serving, pytest.mark.tuning]

ROOT = Path(__file__).resolve().parents[1]


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


def _ref_greedy(model, prompt, steps):
    """The per-request greedy oracle: the port's ``greedy_decode``, held
    to the JAX package's in ``test_torch_port_sampling.py`` (the JAX
    one compiles at every call, a second each on the CPU)."""
    return P.oracle(model, prompt, steps)


def _jax_greedy(model, prompt, steps):
    return np.asarray(JT.greedy_decode(
        model.jparams, jnp.asarray([prompt], jnp.int32), steps,
        model.jcfg))[0].tolist()


def _engine(model, **kw):
    defaults = dict(n_slots=4, max_len=48, max_queue_depth=64,
                    max_prefills_per_tick=2, tick_timeout=0.0)
    defaults.update(kw)
    return serving.InferenceEngine(
        model.tparams, model.tcfg, serving.EngineConfig(**defaults),
        device="cpu")


def _jax_engine(model, **kw):
    defaults = dict(n_slots=4, max_len=48, max_queue_depth=64,
                    max_prefills_per_tick=2, tick_timeout=0.0)
    defaults.update(kw)
    return JS.InferenceEngine(model.jparams, model.jcfg,
                              JS.EngineConfig(**defaults))


def _shapes(engine) -> dict:
    """The admission shapes run so far (on the card, one capture each)."""
    return {kind: engine._graphs.keys(kind)
            for kind in ("full", "suffix", "sample")}


# ---------------------------------------------------------------------------
# the copies
# ---------------------------------------------------------------------------


def _tree(pkg: str, rel: str, rename: bool) -> ast.Module:
    text = (ROOT / pkg / rel).read_text()
    if rename:
        text = re.sub(r"\bhorovod_tpu\b", "horovod_tpu_torch", text)
    tree = ast.parse(text)
    tree.body = tree.body[1:]
    return tree


def _defs(tree: ast.Module) -> dict:
    """Top-level definitions by name (functions, classes, assignments)."""
    out = {}
    for n in tree.body:
        if isinstance(n, ast.Assign):
            out[n.targets[0].id] = n
        elif hasattr(n, "name"):
            out[n.name] = n
    return out


@pytest.mark.parametrize("rel", ["tuning/gp.py", "tuning/tuner.py",
                                 "tuning/__init__.py"])
def test_copies_stay_verbatim(rel):
    assert ast.dump(_tree("horovod_tpu_torch", rel, False)) == \
        ast.dump(_tree("horovod_tpu", rel, True))


def test_params_copy_but_paged_and_the_chunk_range():
    """``params.py`` is the JAX module but for ``online_knob_space``
    (the chunk knob's bounds from ``_captured_chunk_bounds``; the page
    knob, as in the JAX module, only on a paged engine) and the two
    helpers that compute them."""
    port = _defs(_tree("horovod_tpu_torch", "tuning/params.py", False))
    jax_ = _defs(_tree("horovod_tpu", "tuning/params.py", True))
    assert set(port) - set(jax_) == {"_pow2", "_captured_chunk_bounds"}
    for name in set(jax_) - {"online_knob_space"}:
        assert ast.dump(port[name]) == ast.dump(jax_[name]), name
    text = ast.unparse(port["online_knob_space"])
    assert "if cfg.paged:" in text and "_captured_chunk_bounds" in text


def test_replay_copy_but_the_engine_build():
    """``replay.py`` is the JAX module but for ``_build_cli_engine`` and
    the CLI's ``--device``: the same names, no knob left out."""
    port = _defs(_tree("horovod_tpu_torch", "tuning/replay.py", False))
    jax_ = _defs(_tree("horovod_tpu", "tuning/replay.py", True))
    assert set(port) == set(jax_)
    for name in set(jax_) - {"_build_cli_engine", "main", "__all__"}:
        assert ast.dump(port[name]) == ast.dump(jax_[name]), name
    main = ast.unparse(port["main"])
    assert ast.unparse(jax_["main"]) == main.replace(
        "    ap.add_argument('--device', default='cuda', help=\"the "
        "engine's device: cuda (the default) or cpu\")\n", "")


def test_package_exports_match():
    assert TTUNE.__all__ == JTUNE.__all__


def _cli_args():
    import argparse

    return argparse.Namespace(params="", seed=0, vocab=64, d_model=32,
                              n_heads=4, n_layers=2, d_ff=64, max_seq=48,
                              kv_heads=2, slots=2, max_queue_depth=8,
                              max_prefills_per_tick=1, chunk=0, set={},
                              device="cpu")


def test_unsupported_offline_knobs_are_typed(model):
    """Every JAX offline knob builds, ``tp`` too, never dropped: ``tp`` 1
    reaches the engine, and a ``tp`` this one-process job cannot honor
    raises the typed ``ShardingConfigError`` (past its devices), as the
    JAX engine does past its visible devices."""
    from horovod_tpu_torch.serving.sharding import ShardingConfigError

    assert not hasattr(TREPLAY, "UNSUPPORTED_KNOBS")
    args = _cli_args()
    assert TREPLAY._build_cli_engine(args, {"tp": 1}).engine_cfg.tp == 1
    with pytest.raises(ShardingConfigError, match="devices"):
        TREPLAY._build_cli_engine(args, {"tp": 2})
    engine = TREPLAY._build_cli_engine(args, {"page_grant_ahead": 1})
    assert engine.engine_cfg.page_grant_ahead == 1
    assert engine.device.type == "cpu"


@pytest.mark.parametrize("knob,engaged", [("paged", None),
                                          ("paged_kernel", False)])
def test_offline_paged_knobs_build_engines(model, knob, engaged):
    """``--set paged=false`` builds the slot-contiguous engine and
    ``--set paged_kernel=false`` the gathered-pages one, and each serves
    the oracle's tokens; the online space of the slot-contiguous engine
    has no page knob, as the JAX module's."""
    engine = TREPLAY._build_cli_engine(_cli_args(), {knob: False})
    st = engine.stats()
    assert st["paged"] is (knob != "paged")
    assert st.get("paged_kernel_engaged") is engaged
    fut = engine.submit([1, 2, 3], max_new_tokens=5)
    while not fut.done():
        engine.step()
    ref = T.greedy_decode(engine.params, torch.tensor([[1, 2, 3]]), 5,
                          engine.cfg)
    assert fut.result(timeout=0) == ref[0].tolist()
    names = {k.name for k in online_knob_space(engine).knobs}
    assert ("page_grant_ahead" in names) is (knob != "paged")


# ---------------------------------------------------------------------------
# the JAX units, on the port
# ---------------------------------------------------------------------------


class TestGaussianProcess:
    def test_interpolates_training_points(self):
        x = np.linspace(0.0, 1.0, 8).reshape(-1, 1)
        y = np.sin(3.0 * x[:, 0])
        gp = GaussianProcess()
        gp.fit(x, y)
        mu, sigma = gp.predict(x)
        assert np.allclose(mu, y, atol=1e-2)
        assert np.all(sigma < 0.1)
        _, far = gp.predict(np.array([[3.0]]))
        assert far[0] > sigma.max()

    def test_conditioning_guard_escalates_jitter(self):
        x = np.linspace(0.0, 1e-6, 8).reshape(-1, 1)
        y = np.sin(np.arange(8.0))
        gp = GaussianProcess(noise=1e-18)
        gp.fit(x, y)
        assert gp.last_jitter > 1e-18
        mu, _ = gp.predict(x[:1])
        assert np.isfinite(mu[0])

    def test_ei_finds_1d_argmax(self):
        bo = BayesianOptimizer(bounds=[(0.0, 1.0)], seed=3)
        for _ in range(12):
            x = bo.suggest()
            bo.register(x, -(x[0] - 0.3) ** 2)
        best_x, best_y = bo.best
        assert abs(best_x[0] - 0.3) < 0.12
        assert best_y > -0.015

    def test_ei_finds_2d_argmax(self):
        bo = BayesianOptimizer(bounds=[(0.0, 1.0), (0.0, 1.0)], seed=5)
        for _ in range(18):
            x = bo.suggest()
            bo.register(x, -(x[0] - 0.7) ** 2 - (x[1] - 0.2) ** 2)
        best_x, _ = bo.best
        assert abs(best_x[0] - 0.7) < 0.2
        assert abs(best_x[1] - 0.2) < 0.2

    def test_seeded_trajectories_are_deterministic(self):
        def run():
            bo = BayesianOptimizer(bounds=[(0.0, 1.0)], seed=11)
            out = []
            for _ in range(6):
                x = bo.suggest()
                bo.register(x, -(x[0] - 0.5) ** 2)
                out.append(x[0])
            return out

        assert run() == run()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gp_and_optimizer_match_jax(seed):
    """The same seeded inputs through both packages' GP (fit, mean,
    sigma, jitter) and optimizer (every suggestion of a 2-d run)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (9, 2))
    y = np.sin(3.0 * x[:, 0]) + x[:, 1] ** 2
    q = rng.uniform(-0.5, 1.5, (16, 2))
    out = []
    for mod in (TTUNE.gp, JGP):
        gp = mod.GaussianProcess()
        gp.fit(x, y)
        out.append((*gp.predict(q), gp.last_jitter))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)

    def trajectory(mod):
        bo = mod.BayesianOptimizer(bounds=[(0.0, 1.0), (1.0, 8.0)],
                                   seed=seed)
        xs = []
        for _ in range(8):
            s = bo.suggest()
            bo.register(s, -(s[0] - 0.4) ** 2 - (s[1] - 5.0) ** 2 / 9)
            xs.append(list(s))
        return xs, bo.best

    (tx, tb), (jx, jb) = trajectory(TTUNE.gp), trajectory(JGP)
    assert tx == jx
    assert list(tb[0]) == list(jb[0]) and tb[1] == jb[1]


class TestCategoricalSweep:
    def test_walks_all_values_and_fixes_best(self):
        sweep = CategoricalSweep(names=["a", "b"],
                                 values=[[1, 2], [True, False]])
        scores = {(1, True): 1.0, (2, True): 3.0,
                  (2, False): 2.0}
        seen = []
        while not sweep.done:
            cur = sweep.current()
            seen.append((cur["a"], cur["b"]))
            sweep.observe(scores.get((cur["a"], cur["b"]), 0.0))
        assert sweep.fixed == {"a": 2, "b": True}
        assert len(seen) == 4
        assert {a for a, _ in seen} == {1, 2}
        assert {b for _, b in seen} == {True, False}


class TestKnobSpace:
    def test_bo_knob_clamps_and_rounds(self):
        k = Knob(name="k", default=2, kind="bo", bounds=(1, 4))
        assert k.clamp(2.6) == 3
        assert k.clamp(-5) == 1
        assert k.clamp(99) == 4

    def test_sweep_knob_rejects_non_candidates(self):
        k = Knob(name="s", default=0, kind="sweep", candidates=(0, 1, 2))
        assert k.clamp(1) == 1
        assert k.clamp(7) == 0

    def test_space_clamp_drops_unknown_keys(self):
        space = KnobSpace([Knob(name="k", default=2, kind="bo",
                                bounds=(1, 4))])
        out = space.clamp({"k": 9, "stranger": 1})
        assert out == {"k": 4}

    def test_online_space_derived_from_warmed_engine(self, model):
        """The JAX test's space with the warmup reaching every chunk
        position (a 46-token prompt at max_len 48), and the apply path:
        config swap plus the scheduler's attribute, no new shape."""
        engine = _engine(model, prefill_chunk_tokens=8,
                         min_prefill_bucket=4)
        engine.warmup([12, 46])
        space = online_knob_space(engine)
        by_name = {k.name: k for k in space.knobs}
        assert by_name["max_prefills_per_tick"].bounds == (1, 2)
        assert by_name["prefill_chunk_tokens"].bounds == (5, 8)
        assert by_name["page_grant_ahead"].kind == "sweep"
        shapes = _shapes(engine)
        applied = apply_settings(engine, {
            "max_prefills_per_tick": 1, "prefill_chunk_tokens": 6,
            "page_grant_ahead": 1})
        assert applied == {"max_prefills_per_tick": 1,
                           "prefill_chunk_tokens": 6,
                           "page_grant_ahead": 1}
        assert engine.engine_cfg.max_prefills_per_tick == 1
        assert engine.scheduler.max_prefills_per_tick == 1
        assert engine.engine_cfg.prefill_chunk_tokens == 6
        assert _shapes(engine) == shapes


@pytest.mark.parametrize("warm", [[12, 46], [4, 12]])
def test_online_space_matches_jax(model, warm):
    """``online_knob_space`` on the same warmed configuration in both
    packages: the same knobs, kinds, defaults, candidates and bounds,
    but for the chunk knob's range, which the port narrows to the values
    whose chunk graphs warmup captured.  A warmup reaching every chunk
    position keeps the JAX range (5..8); one of prompts up to 12 tokens
    leaves chunk positions 16..40 at other page counts uncaptured for
    values under 8, so the port keeps only 8 (and the knob drops out)."""
    kw = dict(prefill_chunk_tokens=8, min_prefill_bucket=4)
    spaces = []
    for make, space_of in ((_engine, online_knob_space),
                           (_jax_engine, JPARAMS.online_knob_space)):
        engine = make(model, **kw)
        engine.warmup(warm)
        spaces.append({k["name"]: k for k in space_of(engine).describe()})
        engine.stop()
    port, jax_ = spaces
    assert jax_["prefill_chunk_tokens"]["candidates"] == [5, 6, 7, 8]
    if warm == [12, 46]:
        assert port == jax_
    else:
        assert "prefill_chunk_tokens" not in port
        del jax_["prefill_chunk_tokens"]
        assert port == jax_


def test_chunk_range_reaches_only_captured_shapes(model):
    """Every value the narrowed chunk knob allows ingests prompts up to
    the construction value's capture-free length with no new admission
    shape, token-identical to the oracle."""
    engine = _engine(model, prefill_chunk_tokens=8, min_prefill_bucket=4)
    engine.warmup([12, 30])
    knob = {k.name: k for k in online_knob_space(engine).knobs}.get(
        "prefill_chunk_tokens")
    lo, hi = knob.bounds if knob else (8, 8)
    assert hi == 8
    shapes = _shapes(engine)
    rng = np.random.default_rng(5)
    for c in range(lo, hi + 1):
        apply_settings(engine, {"prefill_chunk_tokens": c})
        prompts = [rng.integers(0, 64, n).tolist() for n in (9, 23, 31)]
        futs = [engine.submit(p, max_new_tokens=4) for p in prompts]
        while not all(f.done() for f in futs):
            engine.step()
        for p, f in zip(prompts, futs):
            assert f.result(timeout=0) == _ref_greedy(model, p, 4), c
        assert _shapes(engine) == shapes, c


# ---------------------------------------------------------------------------
# the online tuner on the port's engine
# ---------------------------------------------------------------------------


class TestOnlineTuner:
    def test_oracle_safe_and_capture_stable_while_tuning(self, model):
        """The tentpole invariant on the port: with the tuner applying
        values on a chunked engine (mixed prompt lengths and classes),
        every request's tokens equal the JAX ``greedy_decode``, no
        admission shape is reached after warmup (on the card, no graph
        is captured) and the tuner applied values.  The JAX
        ``greedy_decode`` checks one prompt of each class; the port's
        (held to it) every one."""
        engine = _engine(model, prefill_chunk_tokens=8,
                         min_prefill_bucket=4)
        engine.warmup([4, 8, 12, 46])
        shapes = _shapes(engine)
        tuner = OnlineTuner.install(engine, window_ticks=3,
                                    warmup_windows=0, bo_samples=3)
        rng = np.random.default_rng(2)
        futs, prompts = [], []
        for i in range(16):
            prompt = rng.integers(0, 64, 3 + i % 9 + (20 if i % 5 == 0
                                                      else 0)).tolist()
            prompts.append(prompt)
            futs.append(engine.submit(
                prompt, max_new_tokens=5,
                priority="interactive" if i % 3 else "batch"))
        seen = []
        for _ in range(4000):
            if all(f.done() for f in futs):
                break
            engine.step()
            cur = dict(tuner._current)
            if not seen or seen[-1] != cur:
                seen.append(cur)
        for prompt, f in zip(prompts, futs):
            assert f.result(timeout=0) == _ref_greedy(model, prompt, 5)
        for i in (0, 1):
            assert futs[i].result(timeout=0) == \
                _jax_greedy(model, prompts[i], 5)
        assert _shapes(engine) == shapes
        assert engine.decode_compilations == 0  # the CPU tick is eager
        assert tuner._samples >= 1 and len(seen) >= 3, seen
        snap = engine.stats()["tuning"]
        assert snap["phase"] in ("sweep", "bo", "pinned")
        assert engine.metrics.tuning_samples.value == snap["samples"]

    def test_rollback_on_constraint_violation(self, model):
        """An impossible TTFT SLO makes every scored window a violation:
        the tuner rolls each sample back to the defaults and counts it;
        the tokens equal the JAX engine's on the same params, its own
        tuner running the same way."""
        outs = []
        for make in (_engine, _jax_engine):
            engine = make(model)
            engine.warmup([4])
            mod = OnlineTuner if make is _engine else JTUNE.OnlineTuner
            obj = (Objective if make is _engine else JTUNE.Objective)(
                ttft_slo={"interactive": 1e-9})
            tuner = mod.install(engine, window_ticks=3, bo_samples=2,
                                guard_band=0.0, objective=obj)
            futs = [engine.submit([1 + i, 2, 3], max_new_tokens=4)
                    for i in range(10)]
            for _ in range(2000):
                if all(f.done() for f in futs) and tuner._samples >= 2:
                    break
                engine.step()
                if not all(f.done() for f in futs):
                    continue
                futs.append(engine.submit([5, 6], max_new_tokens=4))
            outs.append([f.result(timeout=0) for f in futs[:10]])
            assert tuner._rollbacks >= 1
            assert engine.metrics.tuning_rollbacks.value == \
                tuner._rollbacks
            assert tuner._current == tuner.space.defaults()
            engine.stop()
        assert outs[0] == outs[1]
        assert outs[0][0] == _jax_greedy(model, [1, 2, 3], 4)

    def test_tuner_crash_never_takes_serving_down(self, model):
        engine = _engine(model)
        engine.warmup([4])

        class Broken:
            def on_tick(self, engine, worked):
                raise RuntimeError("tuner bug")

        engine._tuner = Broken()
        fut = engine.submit([1, 2, 3], max_new_tokens=4)
        for _ in range(300):
            if fut.done():
                break
            engine.step()
        assert fut.result(timeout=0)
        assert engine._tuner is None
        engine.stop()

    def test_restart_resets_the_scoring_window(self, model):
        """``_recover`` drops the tuner's window: the first window after
        a restart scores post-restart counters only."""
        inj = serving.FaultInjector()
        engine = _engine(model, faults=inj, restart_backoff=0.001)
        engine.warmup([4])
        tuner = OnlineTuner.install(engine, window_ticks=1000)
        fut = engine.submit([1, 2, 3], max_new_tokens=12)
        while len(fut.tokens_so_far()) < 3:
            engine.step()
        assert tuner._window is not None and tuner._ticks > 0
        inj.add(serving.FaultSpec(site="decode_tick", kind="raise",
                                  skip=inj.visits("decode_tick")))
        restarts = engine.metrics.engine_restarts.value
        while engine.metrics.engine_restarts.value == restarts:
            engine.step()
        assert tuner._window is None and tuner._ticks == 0
        while not fut.done():
            engine.step()
        assert fut.result(timeout=0) == _ref_greedy(model, [1, 2, 3], 12)


def test_page_grant_ahead_grants_pages_early(model):
    """``page_grant_ahead`` widens the plain tick's grant by that many
    pages, capped at the request's last real write; the tokens do not
    move."""
    used = {}
    for ahead in (0, 2):
        engine = _engine(model, page_size=4, page_grant_ahead=ahead)
        fut = engine.submit([1, 2, 3], max_new_tokens=20)
        engine.step()  # admission and the first tick's grants
        used[ahead] = engine.slots.n_pages - engine.slots.free_pages
        while not fut.done():
            engine.step()
        assert fut.result(timeout=0) == _ref_greedy(model, [1, 2, 3], 20)
    assert used[2] == used[0] + 2


def test_spec_gate_is_admission_data(model):
    """``spec_enabled`` off routes new admissions to the plain tick (the
    opt-out mask); the tokens equal the oracle either way and no tick is
    rebuilt."""
    engine = _engine(model, speculative=True, spec_k=3)
    engine.warmup([4])
    space = {k.name: k for k in online_knob_space(engine).knobs}
    assert space["spec_enabled"].candidates == (True, False)
    ticks = (engine._tick, engine._spec_tick)
    for on in (True, False):
        apply_settings(engine, {"spec_enabled": on})
        runs = (engine._tick.runs, engine._spec_tick.runs)
        fut = engine.submit([1, 2, 3, 1, 2, 3], max_new_tokens=10)
        while not fut.done():
            engine.step()
        assert fut.result(timeout=0) == \
            _ref_greedy(model, [1, 2, 3, 1, 2, 3], 10)
        spec_runs = engine._spec_tick.runs - runs[1]
        assert (spec_runs > 0) == on
    assert (engine._tick, engine._spec_tick) == ticks


# ---------------------------------------------------------------------------
# trace replay
# ---------------------------------------------------------------------------


def _capture(make, model, jp, sampled=False):
    engine = make(model, journal_path=jp)
    engine.warmup([4, 12])
    rng = np.random.default_rng(4)
    futs = []
    for i in range(10):
        prompt = rng.integers(0, 64, 3 + i % 9).tolist()
        kw = {}
        if sampled and i % 2:
            kw = dict(temperature=0.8, seed=40 + i)
        futs.append(engine.submit(
            prompt, max_new_tokens=5,
            priority="interactive" if i % 2 else "batch", **kw))
    for _ in range(2000):
        if all(f.done() for f in futs):
            break
        engine.step()
    outs = [f.result(timeout=0) for f in futs]
    engine.stop()
    return outs


@pytest.fixture(scope="module")
def captured(model, tmp_path_factory):
    """One journal the port's engine wrote (greedy and seeded-sampled)."""
    jp = str(tmp_path_factory.mktemp("tuning") / "trace.jsonl")
    return jp, _capture(_engine, model, jp, sampled=True)


class TestReplay:
    def test_read_trace_keeps_ended_entries_in_arrival_order(
            self, captured):
        jp, outs = captured
        trace = read_trace(jp)
        assert len(trace) == 10
        assert all(r.ended for r in trace)
        assert sorted(len(r.emitted) for r in trace) \
            == sorted(len(o) for o in outs)
        arrivals = [r.arrival for r in trace]
        assert arrivals == sorted(arrivals)
        assert {r.priority for r in trace} == {"interactive", "batch"}

    def test_replay_is_token_identical_both_timings(self, model,
                                                    captured):
        jp, _ = captured
        trace = read_trace(jp)
        assert any(r.temperature > 0 for r in trace)
        engine = _engine(model)
        engine.warmup(warm_lens(trace, engine))
        for timing in ("afap", "original"):
            report = replay(engine, trace, timing=timing, speed=100.0)
            assert report.compared == len(trace)
            assert report.token_identical == report.compared, \
                (timing, report.mismatched_ids)
            assert report.decode_recompiles == 0
            assert report.completed == len(trace)
            assert report.score > 0
        engine.stop()

    def test_pre_arrival_journal_replays_in_file_order(self, tmp_path):
        jp = str(tmp_path / "old.jsonl")
        with open(jp, "w") as f:
            f.write('{"e":"b","id":2,"prompt":[5,6],"max_new":3}\n')
            f.write('{"e":"b","id":1,"prompt":[7],"max_new":3}\n')
        trace = read_trace(jp)
        assert [r.id for r in trace] == [2, 1]
        assert all(r.arrival == 0.0 for r in trace)

    def test_replay_rejects_unknown_timing(self, model):
        with pytest.raises(ValueError):
            replay(object(), [], timing="warp")

    def test_jax_journal_replays_on_the_port(self, model, tmp_path):
        """A journal the JAX engine wrote (greedy and seeded-sampled)
        reads into the same trace through both packages and replays on
        the port's engine token for token."""
        jp = str(tmp_path / "jax.jsonl")
        outs = _capture(_jax_engine, model, jp, sampled=True)
        trace = read_trace(jp)
        jtrace = JTUNE.read_trace(jp)
        assert [json.dumps(r.__dict__, default=list) for r in trace] == \
            [json.dumps(r.__dict__, default=list) for r in jtrace]
        assert sorted(map(tuple, outs)) == \
            sorted(tuple(r.emitted) for r in trace)
        engine = _engine(model)
        engine.warmup(warm_lens(trace, engine))
        report = replay(engine, trace, timing="afap")
        assert report.compared == len(trace) == 10
        assert report.token_identical == report.compared, \
            report.mismatched_ids


class TestTuningEndpoint:
    def test_get_tuning_serves_snapshot(self, model):
        engine = _engine(model, autotune=True)
        assert engine._tuner is None
        engine.warmup([4])
        assert engine._tuner is not None
        assert engine.stats()["autotune"] is True
        assert "tuning" in engine.stats()
        with serving.ServingServer(engine, port=0) as srv:
            host, port = srv.address
            with urllib.request.urlopen(
                    f"http://{host}:{port}/tuning", timeout=10) as r:
                out = json.loads(r.read())
            assert out["enabled"] is True
            assert out["phase"] in ("warmup", "sweep", "bo", "pinned")
            assert "best" in out and "space" in out
            engine._tuner = None
            with urllib.request.urlopen(
                    f"http://{host}:{port}/tuning", timeout=10) as r:
                assert json.loads(r.read()) == {"enabled": False}


@pytest.mark.slow
class TestOfflineTuning:
    def test_offline_bo_over_replay_runs(self, model, captured):
        """The offline backend: BO over whole replay runs, one fresh
        engine a sample (slow, as the JAX test is)."""
        from horovod_tpu_torch.tuning.replay import tune

        jp, _ = captured
        trace = read_trace(jp)
        built = []

        def build(settings):
            engine = _engine(
                model,
                max_prefills_per_tick=settings["max_prefills_per_tick"])
            engine.warmup(warm_lens(trace, engine))
            built.append(settings)
            return engine

        out = tune(build, trace,
                   bounds={"max_prefills_per_tick": (1, 2)},
                   samples=3, seed=0)
        assert len(built) == 3
        assert len(out["trajectory"]) == 3
        best = out["best"]
        assert best["settings"]["max_prefills_per_tick"] in (1, 2)
        assert best["report"]["token_identical"] \
            == best["report"]["compared"]


class TestResetWindow:
    def test_reset_window_drops_baseline(self):
        tuner = OnlineTuner(KnobSpace([
            Knob(name="k", default=2, kind="bo", bounds=(1, 4))]))
        tuner._window = object()
        tuner._ticks = 17
        tuner.reset_window()
        assert tuner._window is None
        assert tuner._ticks == 0
