"""The port's speculative decoding against the JAX package, on the CPU.

Following ``tests/test_speculative.py``, at its tiny shapes (vocab 64,
d_model 32, 4 heads over 2 kv heads, 2 layers; a 1-layer draft):

* the model functions on the same seeded numpy inputs —
  ``ngram_propose`` (tokens equal), ``draft_propose_paged`` (drafts
  equal, pool within 1e-5) and ``decode_verify_paged`` over f32, bf16
  and int8 pools, with perfect, partial and garbage drafts, the
  ``spec_on`` opt-out, a sampled row, an inactive row and a window past
  the table's capacity.  ``t`` and ``acc`` must be equal and positions
  equal; max logits within 1e-5 at f32 (2e-2 over bf16 pages, 1e-4 over
  int8 ones); pool positions the verify leaves alone bit-equal to their
  input in both packages and the positions it writes the same set, their
  values within 1e-5 at f32 (a bf16 step, an int8 step otherwise: the
  K/V come from matmuls whose summation order differs between XLA and
  PyTorch).  The port runs ``kernel=False`` and ``kernel=True`` (K4's
  plain version on the CPU, merged by log-sum-exp with the window pass)
  against JAX's ``kernel=False``; at one shape JAX's ``kernel=True``
  runs too, its Pallas kernel in interpret mode.
* ``_retire_pending``'s multi-token emission, driven with fabricated
  pending records (the JAX class of the same name).
* whole engines: the same scenario through both packages' speculative
  engines, for each draft source (n-gram, a 1-layer draft model, the
  target as its own draft), must give the same record — tokens, finish
  reasons, the speculation counters (drafted, accepted, wasted, tokens a
  tick), decode ticks, prefill calls, restarts and resumes — and greedy
  tokens equal to ``greedy_decode``: staggered admission with the
  pipeline on and off, EOS inside an accepted run, cancellation, the
  per-request opt-out, the adaptive disable and probe cycle (the live
  mask step by step), a decode fault mid-speculation, chunked admission
  (the model draft degrades the slot, the n-gram draft lands its
  history), page pressure preempting under window grants, shared-prefix
  copy-on-write, bf16 and int8 pages, the warmup and its decode tick
  count (the JAX ``_decode_traces`` against the ticks the port ran:
  each is one CUDA graph on the card), stats and metrics, the server's
  ``"speculative"`` field.

JAX tests with no counterpart here: ``test_speculative_requires_paged``
(the port is paged only: ``EngineConfig`` has no ``paged`` field), and
the JAX engine's tuner gate (``_spec_runtime_enabled``, set by
``tuning/``, which is not ported).  The ``spec_fallback`` span events
are held to the JAX engine's in ``test_torch_port_obs.py``.

Engines are lent across scenarios (``run_both(shared=True)``) and read
their counters as differences; torch runs one thread."""

import dataclasses
import json
import time
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as JT
from horovod_tpu_torch import serving as TS
from horovod_tpu_torch.models import transformer as T
from horovod_tpu_torch.serving.engine import _SlotState

from torch_port_parity import (
    counters,
    make_engine,
    make_model,
    oracle,
    outcome,
    run,
    run_both,
)

K = 3  # spec_k, as tests/test_speculative.py

#: Every speculative engine of the scenarios (``tests/test_speculative.py``'s).
SPEC = dict(n_slots=4, max_len=40, min_prefill_bucket=4,
            max_prefills_per_tick=2, speculative=True, spec_k=K)

#: Speculation counters both engines must agree on, read as differences.
SPEC_KEYS = ("spec_drafted_tokens", "spec_accepted_tokens",
             "spec_wasted_tokens", "decode_ticks", "prefill_calls",
             "tokens_generated")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model():
    return make_model()


@pytest.fixture(scope="module")
def draft():
    return make_model(7, n_layers=1)


def _drafts(model, draft):
    """The draft sources by name: n-gram, a 1-layer model, the target."""
    return {"ngram": None, "model": draft, "self": model}


def _spec_counts(engine, since=None) -> dict:
    st = engine.stats()
    out = {k: st[k] for k in SPEC_KEYS}
    out["tokens_per_tick"] = [st["tokens_per_tick"]["count"],
                              st["tokens_per_tick"]["sum"]]
    for k, v in (since or {}).items():
        out[k] = ([a - b for a, b in zip(out[k], v)]
                  if isinstance(v, list) else out[k] - v)
    return out


# --- the model functions ------------------------------------------------------


def test_ngram_propose_matches_jax():
    """The JAX package's hand cases (a repeated bigram, a pure repeat
    gated to committed positions, no match), then random histories of
    a small alphabet at every position."""
    hist = np.asarray([[1, 2, 3, 1, 2, 0, 0, 0], [5, 5, 5, 5, 5, 0, 0, 0],
                       [1, 2, 3, 4, 5, 0, 0, 0]], np.int32)
    pos = np.asarray([4, 4, 4], np.int32)
    got = T.ngram_propose(torch.from_numpy(hist).long(),
                          torch.from_numpy(pos), 3)
    assert got.tolist() == [[3, 1, 2], [5, 5, 5], [5, 5, 5]]
    rng = np.random.default_rng(0)
    for k in (1, 3, 4):
        hist = rng.integers(0, 4, (16, 24)).astype(np.int32)
        pos = np.arange(16, dtype=np.int32) + rng.integers(0, 8, 16)
        want = np.asarray(JT.ngram_propose(jnp.asarray(hist),
                                           jnp.asarray(pos), k))
        got = T.ngram_propose(torch.from_numpy(hist).long(),
                              torch.from_numpy(pos.astype(np.int32)), k)
        np.testing.assert_array_equal(got.numpy(), want)


S, P, PS, MP, W = 6, 17, 8, 4, K + 1


def _pools(kind, cfg, seed):
    """The same random pool in both packages: ``(jax pool, port pool)``
    (positions: a slot mid-page, one at 0, one past capacity - 2, the
    rest scattered)."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, P, cfg.kv_heads, PS, cfg.head_dim)
    pos = np.asarray([5, 0, 17, MP * PS - 2, 9, 13][:S], np.int32)
    if kind == "int8":
        arrs = {"k": rng.integers(-127, 128, shape).astype(np.int8),
                "v": rng.integers(-127, 128, shape).astype(np.int8),
                "k_scale": (rng.random(shape[:-1]) * 0.05
                            + 1e-3).astype(np.float32),
                "v_scale": (rng.random(shape[:-1]) * 0.05
                            + 1e-3).astype(np.float32)}
    else:
        arrs = {n: rng.standard_normal(shape).astype(np.float32)
                for n in ("k", "v")}
    jdt = {"bf16": jnp.bfloat16}.get(kind)
    tdt = {"bf16": torch.bfloat16}.get(kind)
    jp = {n: jnp.asarray(a, jdt) if jdt and n in ("k", "v")
          else jnp.asarray(a) for n, a in arrs.items()}
    tp = {n: torch.from_numpy(a.copy()).to(tdt) if tdt and n in ("k", "v")
          else torch.from_numpy(a.copy()) for n, a in arrs.items()}
    jp["pos"] = jnp.asarray(pos)
    tp["pos"] = torch.from_numpy(pos.copy())
    return jp, tp


def _clone(pool):
    return {k: v.clone() for k, v in pool.items()}


def _verify_case(m, kind):
    """Rows: 0 perfect drafts (acc = K), 1 the first draft right, 2
    inactive, 3 a window past the table, 4 sampled, 5 perfect drafts
    but ``spec_on`` False.  Perfect drafts come from the port's own
    verify run on the prefix of the window (each offset depends only on
    the offsets before it)."""
    rng = np.random.default_rng(11)
    table = rng.integers(1, P, (S, MP)).astype(np.int32)
    active = np.asarray([True, True, False, True, True, True])
    win = rng.integers(0, 64, (S, W)).astype(np.int32)
    _, tpool = _pools(kind, m.jcfg, 5)
    targs = (torch.from_numpy(table), m.tcfg, torch.from_numpy(active))
    for j in range(1, W):
        t, _, _, _ = T.decode_verify_paged(
            m.tparams, torch.from_numpy(win), _clone(tpool), *targs)
        for row in (0, 5) + ((1,) if j == 1 else ()):
            win[row, j] = int(t[row, j - 1])
    spec_on = np.asarray([True, True, True, True, True, False])
    temp = np.asarray([0, 0, 0, 0, 0.8, 0], np.float32)
    keys = rng.integers(0, 2 ** 32, (S, 2), dtype=np.uint64).astype(
        np.uint32)
    sample = (temp, np.zeros(S, np.int32), np.zeros(S, np.float32), keys)
    return table, active, win, spec_on, sample


def _compare_verify(jout, tout, jin, tin, active, kind, tol):
    jt, jm, ja, jpool = jout
    tt, tm, ta, tpool = tout
    a = active
    np.testing.assert_array_equal(tt.numpy()[a], np.asarray(jt)[a])
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tm.numpy()[a], np.asarray(jm)[a], atol=tol,
                               rtol=tol)
    np.testing.assert_array_equal(tpool["pos"].numpy(),
                                  np.asarray(jpool["pos"]))
    for name in tin:
        if name == "pos":
            continue
        # Page 0 is the NULL page: inactive rows and rejected drafts
        # race to it, and nothing reads it.
        j0 = np.asarray(jin[name], np.float32)[:, 1:]
        t0 = tin[name].float().numpy()[:, 1:]
        j1 = np.asarray(jpool[name], np.float32)[:, 1:]
        t1 = tpool[name].float().numpy()[:, 1:]
        np.testing.assert_array_equal(t0, j0)
        np.testing.assert_array_equal(t1 != t0, j1 != j0)
        step = {"f32": 1e-5, "bf16": 2e-2}.get(kind, 1.0)
        if name.endswith("scale"):
            step = 1e-5
        np.testing.assert_allclose(t1, j1, atol=step, rtol=step)


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("kind,tol", [("f32", 1e-5), ("bf16", 2e-2),
                                      ("int8", 1e-4)])
def test_verify_matches_jax(model, kind, tol, kernel):
    """``decode_verify_paged`` of the port (``kernel`` False or True)
    against JAX's ``kernel=False`` on the same pool and windows."""
    m = model
    table, active, win, spec_on, sample = _verify_case(m, kind)
    jpool, tpool = _pools(kind, m.jcfg, 5)
    jin, tin = dict(jpool), _clone(tpool)
    jout = JT.decode_verify_paged(
        m.jparams, jnp.asarray(win), jpool, jnp.asarray(table), m.jcfg,
        jnp.asarray(active), jnp.asarray(spec_on),
        sample=tuple(jnp.asarray(x) for x in sample))
    tout = T.decode_verify_paged(
        m.tparams, torch.from_numpy(win), tpool, torch.from_numpy(table),
        m.tcfg, torch.from_numpy(active), torch.from_numpy(spec_on),
        sample=tuple(torch.from_numpy(np.asarray(x, np.int64)
                                      if x.dtype.kind in "iu" else x)
                     for x in sample), kernel=kernel)
    assert tout[3] is tpool  # updated in place
    _compare_verify(jout, tout, jin, tin, active, kind, tol)
    acc = tout[2].tolist()
    assert acc[0] == K and acc[1] == 1 and acc[2] == 0
    assert acc[4] == 0 and acc[5] == 0  # sampled; opted out
    assert int(tout[3]["pos"][3]) == MP * PS - 2 + acc[3] + 1


def test_verify_kernel_matches_jax_kernel(model):
    """At one shape JAX's ``kernel=True`` (the Pallas kernel in interpret
    mode over the committed pages, merged with the window pass) against
    the port's ``kernel=True`` (K4's plain version on the CPU)."""
    m = model
    table, active, win, spec_on, sample = _verify_case(m, "f32")
    jpool, tpool = _pools("f32", m.jcfg, 5)
    jin, tin = dict(jpool), _clone(tpool)
    jout = JT.decode_verify_paged(
        m.jparams, jnp.asarray(win), jpool, jnp.asarray(table), m.jcfg,
        jnp.asarray(active), jnp.asarray(spec_on), kernel=True)
    tout = T.decode_verify_paged(
        m.tparams, torch.from_numpy(win), tpool, torch.from_numpy(table),
        m.tcfg, torch.from_numpy(active), torch.from_numpy(spec_on),
        kernel=True)
    _compare_verify(jout, tout, jin, tin, active, "f32", 1e-5)


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_draft_propose_matches_jax(model, draft, kernel):
    """``draft_propose_paged`` of the 1-layer draft: drafts equal, the
    draft pool's positions advanced by ``k + 1``, its pages within 1e-5
    of JAX's (the NULL page aside)."""
    jpool, tpool = _pools("f32", draft.jcfg, 3)
    rng = np.random.default_rng(2)
    table = rng.integers(1, P, (S, MP)).astype(np.int32)
    active = np.asarray([True, True, False, True, True, True])
    # Positions within the table: the JAX step checks capacity eagerly.
    pos = np.asarray([5, 0, 17, 20, 9, 13], np.int32)
    jpool["pos"], tpool["pos"] = jnp.asarray(pos), torch.from_numpy(pos.copy())
    toks = rng.integers(0, 64, S).astype(np.int32)
    jd, jp = JT.draft_propose_paged(
        draft.jparams, jnp.asarray(toks), jpool, jnp.asarray(table),
        draft.jcfg, jnp.asarray(active), K)
    td, tp = T.draft_propose_paged(
        draft.tparams, torch.from_numpy(toks), tpool,
        torch.from_numpy(table), draft.tcfg, torch.from_numpy(active), K,
        kernel=kernel)
    np.testing.assert_array_equal(td.numpy()[active],
                                  np.asarray(jd)[active])
    assert tp["pos"].tolist() == (pos + (K + 1) * active).tolist()
    for name in ("k", "v"):
        np.testing.assert_allclose(tp[name].numpy()[:, 1:],
                                   np.asarray(jp[name])[:, 1:], atol=1e-5,
                                   rtol=1e-5)


# --- _retire_pending's multi-token emission -----------------------------------


class TestRetirePendingMultiToken:
    """The fetch boundary's 1..K+1 tokens a slot, with fabricated pending
    records (no device decode): ``tests/test_speculative.py``'s class of
    the same name."""

    def _engine_with_slot(self, model, *, max_new=10, eos=None,
                          prompt=(1, 2)):
        eng = make_engine(model, "port", **SPEC, resume=False)
        fut = TS.GenerationFuture()
        req = TS.Request(prompt=list(prompt), max_new_tokens=max_new,
                         future=fut, eos_id=eos)
        slot = eng.slots.alloc()
        eng._states[slot] = _SlotState(request=req, last_token=5,
                                       n_generated=1)
        eng._page_pos[slot] = len(prompt)
        return eng, slot, req, fut

    @staticmethod
    def _pending(eng, slot, req, row, acc):
        n = eng.engine_cfg.n_slots
        nxt = np.zeros((n, K + 1), np.int64)
        nxt[slot] = row
        active = np.zeros(n, bool)
        active[slot] = True
        accs = np.zeros(n, np.int64)
        accs[slot] = acc
        reqs = [None] * n
        reqs[slot] = req
        fetch = TS.graph.download(torch.from_numpy(nxt),
                                  torch.ones((n, K + 1)),
                                  torch.from_numpy(accs))
        return {"fetch": fetch, "active": active, "reqs": reqs,
                "kind": None, "dispatched_at": time.monotonic(),
                "spec": np.ones(n, bool)}

    @pytest.mark.parametrize("acc,want", [(0, 1), (1, 2), (2, 3),
                                          (K, K + 1)])
    def test_emits_acc_plus_one(self, model, acc, want):
        eng, slot, req, fut = self._engine_with_slot(model)
        eng._retire_pending(self._pending(eng, slot, req,
                                          [11, 12, 13, 14], acc))
        assert fut.tokens_so_far() == [11, 12, 13, 14][:want]
        assert eng._states[slot] is not None
        assert eng._page_pos[slot] == 2 + acc + 1  # the fetch-time mirror
        assert eng.metrics.tokens_per_tick.snapshot()["sum"] == want

    def test_zero_tokens_on_stale_identity(self, model):
        eng, slot, req, fut = self._engine_with_slot(model)
        other = TS.Request(prompt=[9], max_new_tokens=5,
                           future=TS.GenerationFuture())
        p = self._pending(eng, slot, req, [11, 12, 13, 14], K)
        eng._states[slot] = _SlotState(request=other, last_token=1,
                                       n_generated=0)
        eng._retire_pending(p)
        assert fut.tokens_so_far() == []
        assert other.future.tokens_so_far() == []

    @pytest.mark.parametrize("eos,max_new,reason", [(12, 10, "eos"),
                                                    (None, 3, "length")])
    def test_retirement_inside_run_drops_tail(self, model, eos, max_new,
                                              reason):
        eng, slot, req, fut = self._engine_with_slot(model, eos=eos,
                                                     max_new=max_new)
        eng._retire_pending(self._pending(eng, slot, req,
                                          [11, 12, 13, 14], K))
        assert fut.tokens_so_far() == [11, 12]
        assert fut.finish_reason == reason
        assert eng._states[slot] is None
        assert eng.slots.free_count == eng.engine_cfg.n_slots


# --- whole engines ------------------------------------------------------------


#: tests/test_speculative.py's staggered workload: two buckets, unequal
#: lengths, slot reuse, more requests than slots, one EOS case.
CASES = [([3, 4, 5, 6], 9, None), ([10, 11], 5, None),
         ([7, 8, 9, 1, 2, 3, 4, 5, 6], 7, None), ([12, 13, 14], 11, None),
         ([5, 6], 4, None), ([20, 21, 22], 12, "eos")]


def _cases(model):
    out = []
    for prompt, steps, kind in CASES:
        ref = oracle(model, prompt, steps)
        out.append((prompt, steps, ref[2] if kind == "eos" else None, ref))
    return out


def _staggered(engine, cases):
    futs = []
    for prompt, steps, eos, _ in cases:
        futs.append(engine.submit(prompt, max_new_tokens=steps, eos_id=eos))
        engine.step()
        engine.step()
    run(engine, futs)
    return [outcome(f) for f in futs]


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "sync"])
@pytest.mark.parametrize("source", ["ngram", "model", "self"])
def test_staggered_matches_jax(model, draft, source, overlap):
    """The staggered workload twice through the same engine: the same
    tokens both times, the greedy oracle's (cut at the EOS case's stop),
    and the same record as the JAX engine's, speculation counters
    included."""
    cases = _cases(model)
    d = _drafts(model, draft)[source]

    def scenario(S, make):
        engine = make(**SPEC, overlap=overlap, draft=d)
        before, spec0 = counters(engine), _spec_counts(engine)
        outs = [_staggered(engine, cases), _staggered(engine, cases)]
        return {"outs": outs, "stats": counters(engine, since=before),
                "spec": _spec_counts(engine, since=spec0)}

    rec = run_both(model, scenario, shared=True)
    assert rec["outs"][0] == rec["outs"][1]
    for (prompt, steps, eos, ref), got in zip(cases, rec["outs"][0]):
        want = ref if eos is None else ref[:ref.index(eos) + 1]
        assert got == ("ok", want, "length" if eos is None else "eos")
    assert rec["spec"]["spec_drafted_tokens"] > 0
    if source == "self":
        assert rec["spec"]["spec_accepted_tokens"] > 0


def test_eos_inside_accepted_run(model):
    """The target as its own draft accepts everything, so the EOS lands
    inside an accepted run and the rest of the run is dropped."""
    full = oracle(model, [3, 4, 5, 6], 9)

    def scenario(S, make):
        engine = make(**SPEC, draft=model)
        spec0 = _spec_counts(engine)
        f = engine.submit([3, 4, 5, 6], max_new_tokens=9, eos_id=full[2])
        run(engine, [f])
        return {"out": outcome(f), "spec": _spec_counts(engine, since=spec0)}

    rec = run_both(model, scenario, shared=True)
    assert rec["out"] == ("ok", full[:3], "eos")
    assert rec["spec"]["spec_accepted_tokens"] > 0


def test_self_draft_multiplies_tokens_per_tick(model):
    """Acceptance 1 and more than 1.5 tokens a tick with the target as
    its own draft, in both packages alike."""

    def scenario(S, make):
        engine = make(**SPEC, draft=model)
        spec0 = _spec_counts(engine)
        f = engine.submit([3, 4, 5, 6], max_new_tokens=12)
        run(engine, [f])
        return {"out": outcome(f), "spec": _spec_counts(engine, since=spec0)}

    rec = run_both(model, scenario, shared=True)
    assert rec["out"] == ("ok", oracle(model, [3, 4, 5, 6], 12), "length")
    s = rec["spec"]
    assert s["spec_drafted_tokens"] == s["spec_accepted_tokens"] > 0
    assert s["tokens_per_tick"][1] / s["tokens_per_tick"][0] > 1.5


def test_cancellation_mid_speculation(model):
    def scenario(S, make):
        engine = make(**SPEC)
        f1 = engine.submit([3, 4, 5, 6], max_new_tokens=30)
        f2 = engine.submit([10, 11], max_new_tokens=6)
        engine.step()
        engine.step()
        f1.cancel()
        run(engine, [f1, f2])
        return [outcome(f1), outcome(f2)]

    (s1, got, reason), f2 = run_both(model, scenario, shared=True)
    assert reason == "cancelled"
    assert got == oracle(model, [3, 4, 5, 6], 30)[:len(got)]
    assert f2 == ("ok", oracle(model, [10, 11], 6), "length")


@pytest.mark.parametrize("source", ["ngram", "self"])
def test_per_request_opt_out(model, draft, source):
    """``speculative=False`` decodes one token a tick as data: the same
    tokens; alone in the pool it runs the plain tick."""
    d = _drafts(model, draft)[source]

    def scenario(S, make):
        engine = make(**SPEC, draft=d)
        spec0 = _spec_counts(engine)
        f1 = engine.submit([3, 4, 5, 6], max_new_tokens=9,
                           speculative=False)
        f2 = engine.submit([10, 11], max_new_tokens=5)
        run(engine, [f1, f2])
        return {"outs": [outcome(f1), outcome(f2)],
                "spec": _spec_counts(engine, since=spec0)}

    rec = run_both(model, scenario, shared=True)
    assert rec["outs"] == [("ok", oracle(model, [3, 4, 5, 6], 9), "length"),
                           ("ok", oracle(model, [10, 11], 5), "length")]


@pytest.mark.parametrize("source", ["ngram", "model"])
def test_adaptive_disable_and_probe_cycle(model, draft, source):
    """A stream the draft cannot predict: the slot is disabled after its
    evaluation window, plain ticks run, a probe re-enables it every 8
    ticks and it is disabled again — the live mask equal in both
    packages at every step, and the tokens the oracle's."""
    d = _drafts(model, draft)[source]

    def scenario(S, make):
        engine = make(**SPEC, draft=d, spec_probe_period=8, spec_window=2)
        spec0 = _spec_counts(engine)
        f = engine.submit([3, 4, 5, 6], max_new_tokens=30)
        trail = []
        for _ in range(500):
            if f.done():
                break
            engine.step()
            trail.append(int(engine._spec_live.sum()))
        return {"out": outcome(f), "trail": trail,
                "spec": _spec_counts(engine, since=spec0)}

    rec = run_both(model, scenario)
    assert rec["out"] == ("ok", oracle(model, [3, 4, 5, 6], 30), "length")
    assert min(rec["trail"]) < SPEC["n_slots"]  # a disable happened
    # A probe re-enabled it after the disable.
    first = rec["trail"].index(min(rec["trail"]))
    assert max(rec["trail"][first:]) == SPEC["n_slots"]


@pytest.mark.parametrize("skip", [1, 2])
@pytest.mark.parametrize("source", ["ngram", "model"])
def test_restart_resume_mid_speculation(model, draft, source, skip):
    """A decode tick raising at the ``skip``-th speculative tick: the
    futures resume to the oracle's tokens, with the same restart and
    resume counts in both packages."""
    d = _drafts(model, draft)[source]
    want = [oracle(model, [3, 4, 5, 6], 9),
            oracle(model, [7, 8, 9, 1, 2, 3, 4, 5, 6], 7)]

    def scenario(S, make):
        engine = make(**SPEC, draft=d)
        before = counters(engine)
        inj = engine.engine_cfg.faults
        inj.add(S.FaultSpec(site="decode_tick", kind="raise",
                            skip=inj.visits("decode_tick") + skip))
        futs = [engine.submit([3, 4, 5, 6], max_new_tokens=9),
                engine.submit([7, 8, 9, 1, 2, 3, 4, 5, 6], max_new_tokens=7)]
        run(engine, futs)
        return {"outs": [outcome(f) for f in futs],
                "stats": counters(engine, since=before)}

    rec = run_both(model, scenario, shared=True)
    assert [o[1] for o in rec["outs"]] == want
    assert rec["stats"]["engine_restarts"] == 1
    assert rec["stats"]["requests_resumed"] > 0


@pytest.mark.parametrize("source", ["ngram", "model"])
def test_chunked_admission(model, draft, source):
    """A prompt longer than the chunk: a model draft degrades its slot to
    plain (no speculation for it), the n-gram draft lands its history
    and keeps speculating; tokens the oracle's either way."""
    d = _drafts(model, draft)[source]
    long = np.random.default_rng(3).integers(1, 64, 21).tolist()

    def scenario(S, make):
        engine = make(**SPEC, draft=d, prefill_chunk_tokens=8)
        spec0 = _spec_counts(engine)
        futs = [engine.submit(long, max_new_tokens=8),
                engine.submit([5, 6], max_new_tokens=6)]
        run(engine, futs)
        return {"outs": [outcome(f) for f in futs],
                "spec": _spec_counts(engine, since=spec0)}

    rec = run_both(model, scenario, shared=True)
    assert rec["outs"] == [("ok", oracle(model, long, 8), "length"),
                           ("ok", oracle(model, [5, 6], 6), "length")]


def test_page_pressure_preempts_under_window_grants(model):
    """A pool below parity: the window grants (``2W - 1`` positions
    ahead with a tick in flight) run out of pages and preempt the
    younger request, which resumes to the oracle's tokens."""
    prompts = [[3, 4, 5, 6, 7, 8, 9, 10], [11, 12, 13, 14, 15, 16, 17, 18]]

    def scenario(S, make):
        engine = make(**{**SPEC, "n_slots": 2}, n_pages=5)
        before = counters(engine)
        futs = [engine.submit(p, max_new_tokens=16) for p in prompts]
        run(engine, futs)
        return {"outs": [outcome(f) for f in futs],
                "stats": counters(engine, since=before)}

    rec = run_both(model, scenario, shared=True)
    assert [o[1] for o in rec["outs"]] == [oracle(model, p, 16)
                                           for p in prompts]
    assert rec["stats"]["preemptions"] >= 1


def test_cow_prefix_sharing_under_speculation(model):
    """Registered-prefix sharers, the attach-only prompt among them,
    decode speculatively to the oracle's tokens; the prefix is
    prefilled once."""
    pre = [9, 9, 9, 9, 9, 1, 2]

    def scenario(S, make):
        engine = make(**SPEC)
        c0 = engine.stats()["prefill_calls"]
        engine.register_prefix(pre)
        futs = [engine.submit(pre + [k], max_new_tokens=8) for k in (3, 4, 5)]
        futs.append(engine.submit(pre, max_new_tokens=6))
        run(engine, futs)
        engine.unregister_prefix(pre)
        return {"outs": [outcome(f) for f in futs],
                "calls": engine.stats()["prefill_calls"] - c0}

    rec = run_both(model, scenario, shared=True)
    assert rec["outs"] == [("ok", oracle(model, pre + [k], 8), "length")
                           for k in (3, 4, 5)] + [
        ("ok", oracle(model, pre, 6), "length")]
    assert rec["calls"] <= 3


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_quantized_pages(model, kv):
    """Over bf16 and int8 pages the speculative engine gives the plain
    engine's tokens (the window's K/V takes the storage round trip), in
    both packages alike."""

    def scenario(S, make):
        outs = {}
        for spec in (True, False):
            engine = make(**{**SPEC, "speculative": spec}, kv_dtype=kv)
            futs = [engine.submit([3, 4, 5, 6], max_new_tokens=9),
                    engine.submit([10, 11], max_new_tokens=6)]
            run(engine, futs)
            outs[spec] = [outcome(f) for f in futs]
        return outs

    rec = run_both(model, scenario, shared=True)
    assert rec[True] == rec[False]


def test_knobs_are_validated(model):
    """spec_k < 1, an unknown draft source, a model draft without its
    parameters, a draft of another vocabulary: ``ValueError`` in both."""
    other = make_model(1, n_layers=1)
    bad = other._replace(
        jcfg=dataclasses.replace(other.jcfg, vocab_size=32),
        tcfg=dataclasses.replace(other.tcfg, vocab_size=32))

    def scenario(S, make):
        errs = []
        for kw in (dict(spec_k=0), dict(spec_draft="medusa"),
                   dict(spec_draft="model"), dict(draft=bad)):
            try:
                make(**{**SPEC, **kw})
                errs.append(None)
            except ValueError as e:
                errs.append(type(e).__name__)
        return errs

    assert run_both(model, scenario) == ["ValueError"] * 4


def test_warmup_and_decode_tick_count(model, draft):
    """A warmed speculative engine has run both decode ticks — the JAX
    engine's ``decode_compilations`` (its two executables) equals the
    ticks the port ran, each one CUDA graph on the card — and the
    warmup's acceptance leaves no slot disabled; a burst after it adds
    no tick kind."""

    def scenario(S, make):
        engine = make(**SPEC, draft=draft)
        engine.warmup((4, 9))
        kinds = (engine.stats()["decode_compilations"] if S is not TS
                 else sum(t.runs > 0 for t in (engine._tick,
                                               engine._spec_tick)))
        live = int(engine._spec_live.sum())
        futs = [engine.submit([3, 4, 5, 6], max_new_tokens=9),
                engine.submit([10, 11], max_new_tokens=5,
                              speculative=False)]
        run(engine, futs)
        after = (engine.stats()["decode_compilations"] if S is not TS
                 else sum(t.runs > 0 for t in (engine._tick,
                                               engine._spec_tick)))
        return {"kinds": [kinds, after], "live": live,
                "outs": [outcome(f) for f in futs]}

    rec = run_both(model, scenario)
    assert rec["kinds"] == [2, 2]
    assert rec["live"] == SPEC["n_slots"]


def test_stats_and_metrics(model):
    def scenario(S, make):
        engine = make(**SPEC)
        f = engine.submit([3, 4, 5, 6], max_new_tokens=6)
        run(engine, [f])
        st = engine.stats()
        return {k: st[k] for k in ("speculative", "spec_k", "spec_draft",
                                   "spec_slots_live", "draft_pages_free",
                                   "spec_drafted_tokens",
                                   "spec_accepted_tokens",
                                   "spec_wasted_tokens",
                                   "spec_acceptance_ratio")} | {
            "tokens_per_tick": st["tokens_per_tick"]["count"]}

    rec = run_both(model, scenario)
    assert rec["speculative"] is True and rec["spec_k"] == K
    assert rec["spec_draft"] == "ngram" and rec["draft_pages_free"] is None
    assert rec["spec_drafted_tokens"] >= rec["spec_accepted_tokens"]
    assert rec["tokens_per_tick"] > 0
    plain = make_engine(model, "port")
    assert plain.stats()["speculative"] is False


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_http_speculative_field(model, draft):
    """``POST /generate`` with and without ``"speculative": false`` on a
    model-draft engine: the oracle's tokens both ways; ``/stats`` carries
    the speculation counters."""
    engine = make_engine(model, "port", draft=draft, **SPEC)
    srv = TS.ServingServer(engine, port=0).start()
    try:
        url = "http://%s:%d" % srv.address
        for spec in (None, False):
            body = {"tokens": [3, 4, 5, 6], "max_new_tokens": 9}
            if spec is not None:
                body["speculative"] = spec
            assert _post(url + "/generate", body)["tokens"] == \
                oracle(model, [3, 4, 5, 6], 9)
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            st = json.loads(r.read())
    finally:
        srv.stop()
    assert st["speculative"] is True and st["spec_draft"] == "model"
    assert st["spec_drafted_tokens"] > 0
    assert st["tokens_per_tick"]["count"] > 0


# --- the speculative tick against the JAX engine's ------------------------------


@pytest.mark.parametrize("source", ["ngram", "self"])
def test_spec_tick_body_matches_jax_tick(model, source):
    """The port's speculative tick body (``SpecTick.body``, eager on the
    CPU) against the JAX engine's jitted speculative ``_tick`` on the same
    state: next tokens, windows, accepted lengths and positions equal,
    max logits within 1e-5, the pool as in the verify tests; the n-gram
    history (the input tokens and the accepted drafts committed, nothing
    else) equal, or the draft pool's position back at the target's.
    Row 0 is set up to accept every draft (its history repeats the last
    bigram followed by the target's own continuation, or the draft is
    the target), row 1 random, row 2 inactive, row 3 sampled."""
    m = model
    n, max_len = SPEC["n_slots"], SPEC["max_len"]
    max_pages = max_len // PS
    rng = np.random.default_rng(4)
    table = rng.integers(1, P, (n, max_pages)).astype(np.int32)
    active = np.asarray([True, True, False, True])
    spec_on = np.asarray([True, True, True, False])
    pos = np.asarray([12, 7, 3, 20], np.int32)
    tokens = rng.integers(0, 64, n).astype(np.int64)
    tokens[0] = 33
    # The target's greedy continuation of row 0 from its input token.
    _, tpool0 = _pools("f32", m.jcfg, 8)
    tpool0["pos"] = torch.from_numpy(pos[:n].copy())
    win = np.zeros((n, W), np.int64)
    win[:, 0] = tokens
    for j in range(1, W):
        t, _, _, _ = T.decode_verify_paged(
            m.tparams, torch.from_numpy(win), _clone(tpool0),
            torch.from_numpy(table), m.tcfg, torch.from_numpy(active))
        win[0, j] = int(t[0, j - 1])
    hist = rng.integers(40, 64, (n, max_len)).astype(np.int64)
    hist[0, 2:4] = [32, 33]  # the bigram (32, 33) ...
    hist[0, 4:4 + K] = win[0, 1:]  # ... followed by the continuation
    hist[0, pos[0] - 1] = 32  # and again at the end, 33 the input token
    temp = np.asarray([0, 0, 0, 0.8], np.float32)
    keys = rng.integers(0, 2 ** 32, (n, 2), dtype=np.uint64).astype(np.uint32)
    samp = (temp, np.zeros(n, np.int32), np.zeros(n, np.float32), keys)

    jeng = make_engine(m, "jax", **SPEC, draft=m if source == "self" else None)
    jpool, tpool = _pools("f32", m.jcfg, 8)
    jpool["pos"], tpool["pos"] = jnp.asarray(pos), torch.from_numpy(pos.copy())
    # The jitted tick donates its pool: keep host copies of the input.
    jin = {k: np.array(v) for k, v in jpool.items()}
    tin = _clone(tpool)
    jargs = [jnp.asarray(tokens, jnp.int32), jnp.asarray(active),
             jnp.asarray(spec_on), jnp.asarray(table)]
    jsamp = tuple(jnp.asarray(x) for x in samp)
    tsamp = (torch.from_numpy(temp), torch.zeros(n, dtype=torch.int64),
             torch.zeros(n), torch.from_numpy(keys.astype(np.int64)))
    plain = TS.graph.DecodeTick(m.tparams, m.tcfg, tpool, tsamp, n,
                                max_pages, "cpu")
    plain.tokens.copy_(torch.from_numpy(tokens))
    plain.active.copy_(torch.from_numpy(active))
    plain.table.copy_(torch.from_numpy(table))
    if source == "ngram":
        jnxt, jt, jm, ja, jp, jh = jeng._tick_fn(
            m.jparams, *jargs, jpool, jnp.asarray(hist, jnp.int32), *jsamp)
        tick = TS.graph.SpecTick(plain, K, max_len)
        tick.hist[:, :max_len] = torch.from_numpy(hist)
    else:
        djpool, dtpool = _pools("f32", m.jcfg, 9)
        djpool["pos"] = jnp.asarray(pos + 5)  # the entry copy resets it
        dtpool["pos"] = torch.from_numpy(pos + 5)
        dtable = rng.integers(1, P, (n, max_pages)).astype(np.int32)
        jnxt, jt, jm, ja, jp, jdp = jeng._tick_fn(
            m.jparams, m.jparams, *jargs[:3], jargs[3],
            jnp.asarray(dtable), jpool, djpool, *jsamp)
        tick = TS.graph.SpecTick(plain, K, max_len,
                                 (m.tparams, m.tcfg, dtpool))
        tick.dtable.copy_(torch.from_numpy(dtable))
    tick.spec_on.copy_(torch.from_numpy(spec_on))
    tt, tm, ta = tick.body()
    _compare_verify((jt, jm, ja, jp), (tt, tm, ta, tpool), jin, tin, active,
                    "f32", 1e-5)
    np.testing.assert_array_equal(plain.tokens.numpy(), np.asarray(jnxt))
    if source == "ngram":
        assert ta[0] == K
        np.testing.assert_array_equal(tick.hist[:, :max_len].numpy(),
                                      np.asarray(jh))
    else:
        assert tick.draft[2]["pos"].tolist() == tpool["pos"].tolist() == \
            np.asarray(jdp["pos"]).tolist()
