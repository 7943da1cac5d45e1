"""Shared harness of the port's serving durability tests
(``test_torch_port_chaos.py``, ``test_torch_port_durability.py``,
``test_torch_port_sched.py``): one tiny f32 model in both packages,
engines of either package from one set of keywords, and a runner that
drives the same scenario through the JAX engine and the port's and
requires the same record from both.

A scenario is a function ``scenario(S, make)``: ``S`` is the package's
``serving`` module (its ``FaultSpec`` and error types), ``make(**kw)``
gives that package's engine, its ``FaultInjector`` in
``engine.engine_cfg.faults``.  It returns a record of what came out —
each future's :func:`outcome`, the engine's :func:`counters` since the
scenario began, the injector's firings — built only from plain values
and exception type names, so the two records compare with ``==``.

The JAX engine compiles its prefill buckets and its tick per instance,
seconds on the CPU, so scenarios that ask for it run on engines lent
from a per-process pool (:func:`lease`) and read every counter as a
difference."""

import collections
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from horovod_tpu import serving as JS
from horovod_tpu.models import transformer as JT
from horovod_tpu_torch import serving as TS
from horovod_tpu_torch.models import params_from_jax
from horovod_tpu_torch.models import transformer as T

Model = collections.namedtuple("Model", "jparams jcfg tparams tcfg")

#: The ``/stats`` keys both engines must agree on.
COUNTERS = ("engine_failures", "engine_restarts", "requests_resumed",
            "resume_wasted_tokens", "preemptions", "journal_inflight",
            "requests_completed", "requests_cancelled", "requests_rejected",
            "state_transitions")

#: Engine keywords of every scenario: a small pool, short restart
#: backoff, and no watchdog unless a scenario arms one.
BASE = dict(n_slots=3, max_len=40, min_prefill_bucket=4, page_size=8,
            restart_backoff=0.001, restart_backoff_max=0.002, tick_timeout=0)


def make_model(seed: int = 0) -> Model:
    """The tiny model in both packages, its weights drawn with numpy
    from ``seed`` at ``JT.init_params``'s shapes and scales (norms at
    one, matrices normal over the square root of their input width, the
    embedding unit normal)."""
    kw = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
              max_seq=48, n_kv_heads=2)
    jcfg = JT.TransformerConfig(**kw, dtype=jnp.float32,
                                attention_impl="reference")
    tcfg = T.TransformerConfig(**kw, dtype=torch.float32,
                               attention_impl="flash")
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name.startswith("ln"):
            return np.ones(leaf.shape, np.float32)
        fan_in = {"embed": 1, "w_down": jcfg.d_ff}.get(name, jcfg.d_model)
        return (rng.standard_normal(leaf.shape)
                / np.sqrt(fan_in)).astype(np.float32)

    shapes = jax.eval_shape(lambda k: JT.init_params(k, jcfg),
                            jax.random.PRNGKey(0))
    weights = jax.tree_util.tree_map_with_path(draw, shapes)
    return Model(jax.tree_util.tree_map(jnp.asarray, weights), jcfg,
                 params_from_jax(weights, tcfg, device="cpu"), tcfg)


def make_engine(model: Model, package: str, **kw):
    """A fresh engine of ``package``; ``faults`` defaults to an empty
    injector of the package's own."""
    S = JS if package == "jax" else TS
    kw.setdefault("faults", S.FaultInjector())
    if package == "jax":
        return JS.InferenceEngine(model.jparams, model.jcfg,
                                  JS.EngineConfig(**kw))
    return TS.InferenceEngine(model.tparams, model.tcfg,
                              TS.EngineConfig(**kw), device="cpu")


_LENT: dict = {}


def lease(model: Model, package: str, **kw):
    """An idle engine of ``package`` built with ``kw``, kept for the next
    scenario of this process that asks for the same keywords.  One left
    busy or unhealthy by a scenario, or whose state trail nears the
    engine's 50-entry cap, is replaced."""
    key = (package, id(model), tuple(sorted(kw.items())))
    engine = _LENT.get(key)
    if engine is None or not _idle(engine):
        engine = _LENT[key] = make_engine(model, package, **kw)
    return engine


def _idle(engine) -> bool:
    return (engine.health == "healthy" and not engine.terminal
            and engine.scheduler.depth == 0
            and engine.stats()["slots_active"] == 0
            and (engine.journal is None or len(engine.journal) == 0)
            and len(engine.state_transitions) < 40)


def run_both(model: Model, scenario, *, shared: bool = False, **kw):
    """The scenario's record from each package's engine (``kw`` over
    :data:`BASE`; with ``shared``, engines lent by :func:`lease`);
    asserts they are equal and returns the port's."""
    records = {}
    for package, S in (("jax", JS), ("port", TS)):
        def make(_package=package, **more):
            cfg = {**BASE, **kw, **more}
            if shared:
                return lease(model, _package, **cfg)
            return make_engine(model, _package, **cfg)
        records[package] = scenario(S, make)
    assert records["port"] == records["jax"]
    return records["port"]


def outcome(fut):
    """``("ok", tokens, finish reason)`` or ``("err", error type name,
    tokens emitted before it)``."""
    try:
        return ("ok", fut.result(timeout=0), fut.finish_reason)
    except Exception as e:  # the typed failure is the outcome
        return ("err", type(e).__name__, fut.tokens_so_far())


def counters(engine, since=None) -> dict:
    """The :data:`COUNTERS` of ``engine``; with ``since`` (an earlier
    reading) the counts are the differences and the state trail starts
    at the state of that reading: what a scenario did on a lent engine,
    or past a warmup, whose sweep differs between the packages (the JAX
    one also warms its compiled first-token sampler)."""
    st = engine.stats()
    out = {k: st[k] for k in COUNTERS}
    for k, v in (since or {}).items():
        if k == "state_transitions":
            out[k] = out[k][len(v) - 1:]
        else:
            out[k] -= v
    return out


def settle(futs, timeout=30.0) -> list:
    """Wait for every future (a typed error counts as resolved) and
    return their outcomes."""
    for f in futs:
        try:
            f.result(timeout=timeout)
        except Exception:  # the outcome records it
            pass
    return [outcome(f) for f in futs]


def wait_for(pred, timeout=15.0, poll=0.01) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(poll)
    return False


def run(engine, futs, max_ticks=400):
    for _ in range(max_ticks):
        if all(f.done() for f in futs):
            return
        engine.step()
    raise AssertionError("engine did not finish within the tick budget")


def step_until(engine, pred, max_ticks=400):
    for _ in range(max_ticks):
        if pred():
            return
        engine.step()
    raise AssertionError("condition not reached within the tick budget")


def oracle(model: Model, prompt, steps, *, seed=0, temperature=0.0,
           **kw):
    """The per-request oracle: the port's ``sample_decode`` at the
    request's seed (``greedy_decode`` at temperature 0), held to the JAX
    package's in ``test_torch_port_sampling.py``."""
    return T.sample_decode(model.tparams, torch.tensor([prompt]), steps,
                           model.tcfg, rng=TS.seed_key(seed),
                           temperature=temperature, **kw)[0].tolist()

