"""The port's captured admission path against the JAX package, on the
CPU at f32 (bf16 where said), at the tiny shapes of
``test_torch_port_prefix.py`` and ``test_torch_port_chunked.py``.

On the card an admission is one replay of a CUDA graph per shape
(``serving/graph.py``, :class:`PrefillGraphs`); on the CPU the same
bodies run eagerly, and these tests hold them to what they replace:

* K1's plain version with the shift as a 0-dim tensor (the device
  shift a captured suffix prefill replays with) equals it with the int
  shift, at every mask case of ``test_torch_port_ops.py`` and the
  suffix shift, outputs and gradients, bit for bit;
* ``prefill_with_prefix`` over a page-padded prefix (NULL pages past
  its pages, junk past ``p0``) with a tensor ``p0`` equals the JAX
  function given the same padded prefix (f32 1e-5: summation order;
  bf16 2e-2 of the largest value, as ``test_torch_port_prefix.py``:
  the packages round the projections at different points) and the
  exact-cut prefix of PR 7's path (1e-6: the suffix sits at ``p0`` in a
  longer key buffer, the same sums in another order);
* each graph body equals the eager sequence it replaces — ``prefill``
  then ``land``, the suffix prefill then ``land``, the sampler — in
  logits, picks, pool bytes and positions;
* after the same warmup and traffic, both engines report the same
  ``prefill_buckets`` and the same suffix shapes (the JAX engine's,
  spied on its ``_suffix_prefill``, with the registered prefix's page
  count padded to a power of two as the port pads it), for a prefix run
  and a chunked run, with tokens equal to the oracle."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as JT
from horovod_tpu_torch import serving as TS
from horovod_tpu_torch.models import params_from_jax
from horovod_tpu_torch.models import transformer as T
from horovod_tpu_torch.ops import attention as A
from horovod_tpu_torch.serving.cache import NULL_PAGE, pad_pages
from horovod_tpu_torch.serving.graph import PrefillGraphs

from torch_port_parity import BASE, make_model, make_engine, oracle, \
    outcome, run

PS = 8  # the parity engines' page size

#: A 19-token prefix: three pages of 8, the last partial, padded to four.
PREFIX19 = [7, 3, 9, 1, 4, 2, 8, 6, 5, 3, 2, 11, 13, 17, 19, 23, 29, 31,
            37]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model():
    return make_model()


def _pow2(n):
    p = 1
    while p < n:
        p *= 2
    return p


# --- K1 with a tensor shift --------------------------------------------------

# (S, T, shift): causal, bottom-right causal, fully masked (the mask cases
# of test_torch_port_ops.py), a shifted diagonal, and a suffix over a
# 40-position prefix (shift = -p0).
SHIFT_CASES = [(64, 64, 0), (64, 128, -64), (8, 8, 8), (32, 32, 5),
               (16, 56, -40)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("S,T,shift", SHIFT_CASES,
                         ids=["causal", "bottom_right", "none_visible",
                              "shifted", "suffix"])
def test_plain_k1_tensor_shift_equals_int_shift(S, T, shift, dtype):
    """``flash_attention_shifted`` with the shift as a 0-dim int32
    tensor gives the int shift's outputs and gradients exactly, GQA
    G = 2."""
    rng = np.random.RandomState(S + T)
    q0 = torch.from_numpy(rng.randn(2, 4, S, 16).astype(np.float32))
    k0, v0 = (torch.from_numpy(rng.randn(2, 2, T, 16).astype(np.float32))
              for _ in range(2))
    do = torch.from_numpy(rng.randn(2, 4, S, 16).astype(np.float32))
    got = []
    for s in (shift, torch.tensor(shift, dtype=torch.int32)):
        q, k, v = (x.to(dtype).requires_grad_() for x in (q0, k0, v0))
        o, lse = A.flash_attention_shifted(q, k, v, s)
        (o.float() * do).sum().backward()
        got.append([o, lse, q.grad, k.grad, v.grad])
    for a, b in zip(*got):
        assert torch.equal(a, b)


def test_device_shift_is_checked():
    """K1 takes a tensor shift only as a 0-dim int32 on q's device."""
    q = torch.zeros((1, 2, 4, 64))
    assert A._device_shift(None, q) is None
    assert A._device_shift(3, q) is None
    for bad in (torch.tensor([1], dtype=torch.int32),
                torch.tensor(1, dtype=torch.int64)):
        with pytest.raises(ValueError, match="0-dim int32"):
            A._device_shift(bad, q)


# --- prefill_with_prefix over a page-padded prefix ---------------------------


def _padded_prefix(model, p0, seed):
    """Prefix K/V ``(L, H_kv, P0, Dh)`` f32 for ``p0`` random tokens (the
    JAX prefill), ``P0`` its page count padded to a power of two times
    the page size; junk past ``p0``: a page's tail, then the NULL
    pages."""
    P0 = _pow2(-(-p0 // PS)) * PS
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, model.jcfg.vocab_size, (1, p0))
    cache = JT.init_cache(model.jcfg, 1, P0)
    _, cache = JT.prefill(model.jparams, jnp.asarray(toks), cache,
                          model.jcfg)
    k, v = (np.array(cache[n][:, 0]) for n in ("k", "v"))
    k[:, :, p0:] = rng.standard_normal(k[:, :, p0:].shape)
    v[:, :, p0:] = rng.standard_normal(v[:, :, p0:].shape)
    return k, v


def _port(params, cfg, suffix, pk, pv, p0, lens):
    logits, out = T.prefill_with_prefix(
        params, torch.tensor(suffix), torch.tensor(pk), torch.tensor(pv),
        p0, cfg, true_len=torch.tensor(lens))
    return logits, out


class TestPaddedPrefix:
    @pytest.mark.parametrize("impl", ["reference", "flash"])
    @pytest.mark.parametrize("p0", [5, 11, 19, 24],
                             ids=["p5_pages1", "p11_pages2", "p19_pages4",
                                  "p24_pages4"])
    def test_matches_jax_and_the_exact_cut(self, model, impl, p0):
        """K = 2 suffixes of 7 and 3 real tokens (bucket 8) over the
        padded prefix with ``p0`` a tensor: logits, suffix K/V and
        positions equal the JAX function's on the same padded prefix;
        against the prefix cut to exactly ``p0`` (the int path) within
        1e-6."""
        pk, pv = _padded_prefix(model, p0, seed=p0)
        suffix = np.random.default_rng(p0 + 1).integers(0, 64, (2, 8))
        lens = [7, 3]
        tcfg = dataclasses.replace(model.tcfg, attention_impl=impl)
        jl, jo = JT.prefill_with_prefix(
            model.jparams, jnp.asarray(suffix), jnp.asarray(pk),
            jnp.asarray(pv), p0, model.jcfg, true_len=jnp.asarray(lens))
        tl, to = _port(model.tparams, tcfg, suffix, pk, pv,
                       torch.tensor(p0), lens)
        assert to["pos"].tolist() == np.asarray(jo["pos"]).tolist()
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                                   rtol=1e-5)
        for n in ("k", "v"):
            np.testing.assert_allclose(to[n].numpy(), np.asarray(jo[n]),
                                       atol=1e-5, rtol=1e-5)
        cl, co = _port(model.tparams, tcfg, suffix, pk[:, :, :p0],
                       pv[:, :, :p0], p0, lens)
        np.testing.assert_allclose(tl.numpy(), cl.numpy(), atol=1e-6,
                                   rtol=0)
        for n in ("k", "v"):
            np.testing.assert_allclose(to[n].numpy(), co[n].numpy(),
                                       atol=1e-6, rtol=0)

    def test_bf16_model(self, model):
        """A bf16 model over the padded prefix with a tensor ``p0``:
        within 2e-2 of the largest value of the JAX function's logits
        and suffix K/V."""
        jcfg = dataclasses.replace(model.jcfg, dtype=jnp.bfloat16)
        tcfg = dataclasses.replace(model.tcfg, dtype=torch.bfloat16)
        tparams = params_from_jax(
            {"embed": np.asarray(model.jparams["embed"]),
             "layers": {k: np.asarray(v)
                        for k, v in model.jparams["layers"].items()},
             "ln_f": np.asarray(model.jparams["ln_f"]),
             "head": np.asarray(model.jparams["head"])}, tcfg, device="cpu")
        p0 = 19
        pk, pv = _padded_prefix(model, p0, seed=8)
        suffix = np.random.default_rng(3).integers(0, 64, (2, 8))
        jl, jo = JT.prefill_with_prefix(
            model.jparams, jnp.asarray(suffix), jnp.asarray(pk),
            jnp.asarray(pv), p0, jcfg, true_len=jnp.asarray([8, 4]))
        tl, to = _port(tparams, tcfg, suffix, pk, pv, torch.tensor(p0),
                       [8, 4])
        pairs = [(tl, jl)] + [(to[n], jo[n]) for n in ("k", "v")]
        for t, j in pairs:
            j = np.asarray(j, np.float32)
            assert np.abs(t.float().numpy() - j).max() \
                <= 2e-2 * np.abs(j).max()


def test_pad_pages():
    """Page ids NULL-padded to a power-of-two count, the JAX
    ``_gather_landed`` rule."""
    assert pad_pages([5]) == [5]
    assert pad_pages([5, 6]) == [5, 6]
    assert pad_pages([5, 6, 7]) == [5, 6, 7, NULL_PAGE]
    assert pad_pages(list(range(1, 6))) == [1, 2, 3, 4, 5] + [NULL_PAGE] * 3


# --- the graph bodies against the eager sequences ---------------------------


def _two_pools(model):
    """Two page caches in one state: random pool bytes and positions, so
    that every byte a landing must leave alone is checked too."""
    pcs = [TS.PagedSlotCache(model.tcfg, 3, 40, page_size=PS, device="cpu")
           for _ in range(2)]
    g = torch.Generator().manual_seed(0)
    for name, t in pcs[0].cache.items():
        if t.is_floating_point():
            t.copy_(torch.randn(t.shape, generator=g))
        else:
            t.copy_(torch.randint(0, 30, t.shape, generator=g))
    for name, t in pcs[1].cache.items():
        t.copy_(pcs[0].cache[name])
    return pcs


def _assert_pools(pcs, atol=None):
    for name in pcs[0].cache:
        a, b = pcs[0].cache[name], pcs[1].cache[name]
        if atol is None or not a.is_floating_point():
            assert torch.equal(a, b), name
        else:
            torch.testing.assert_close(a, b, atol=atol, rtol=0)


def test_full_body_equals_prefill_then_land(model):
    """``("full", 8, 2)``: the body's logits, argmax and max logit equal
    ``prefill``'s; its landing writes the pool and positions that
    ``land`` writes, byte for byte; a prefix registration's landing
    (``valid`` 0) leaves every position as it was."""
    pcs = _two_pools(model)
    lens = np.array([6, 3])
    padded = np.random.default_rng(4).integers(0, 64, (2, 8))
    for pc in pcs:
        slots = [pc.alloc(), pc.alloc()]
        for s, n in zip(slots, lens):
            for idx in range(pc.pages_for(int(n))):
                pc.grant(s, idx)
    graphs = PrefillGraphs(model.tparams, model.tcfg, pcs[0].cache, "cpu")
    g = graphs.get(("full", 8, 2))
    new_pos, phys, off = pcs[0].landing(slots, lens, bucket=8)
    g.set(tokens=padded, lens=lens, slots=slots, new_pos=new_pos, valid=1,
          phys=phys, off=off)
    logits, picks, mx = graphs.run(g)
    cache = T.init_cache(model.tcfg, 2, 8, device="cpu")
    want, pre = T.prefill(model.tparams, torch.tensor(padded), cache,
                          model.tcfg, true_len=torch.tensor(lens))
    pcs[1].land(slots, pre, lens)
    assert torch.equal(logits, want)
    assert torch.equal(picks, torch.argmax(want, -1))
    assert torch.equal(mx, want.amax(-1))
    _assert_pools(pcs)
    # A slotless landing: raw pages, no position written.
    pages = [pc.grant_raw(2) for pc in pcs][0]
    phys, off = pcs[0].landing_raw(pages, 11, bucket=16)
    g = graphs.get(("full", 16, 1))
    g.set(tokens=np.arange(16)[None], lens=[11], slots=0, new_pos=0,
          valid=0, phys=phys, off=off)
    graphs.run(g)
    cache = T.init_cache(model.tcfg, 1, 16, device="cpu")
    _, pre = T.prefill(model.tparams, torch.arange(16)[None], cache,
                       model.tcfg, true_len=torch.tensor([11]))
    pcs[1].land_raw(pages, pre, 11)
    _assert_pools(pcs)
    assert graphs.keys("full") == [(8, 2), (16, 1)]
    assert graphs.captures == {"full": 0, "suffix": 0, "sample": 0}


def test_suffix_body_equals_gather_prefill_land(model):
    """``("suffix", 4, 8, 2)``: two slots attach a 19-token prefix's
    three pages (the partial one copied on write) and land suffixes of 5
    and 2 tokens.  The body, over the NULL-padded pages with ``p0`` as
    data, equals the eager call of ``prefill_with_prefix`` on the same
    padded gather exactly, and PR 7's sequence (the gather cut to
    ``p0``, the prefill, ``land``) within 1e-6; positions equal."""
    pcs = _two_pools(model)
    p0, lens = 19, np.array([5, 2])
    rng = np.random.default_rng(6)
    toks = rng.integers(0, 64, (1, 32))
    padded = rng.integers(0, 64, (2, 8))
    cache = T.init_cache(model.tcfg, 1, 32, device="cpu")
    _, pre = T.prefill(model.tparams, torch.tensor(toks), cache, model.tcfg,
                       true_len=torch.tensor([p0]))
    for pc in pcs:
        pages = pc.grant_raw(3)
        pc.land_raw(pages, pre, p0)
        slots = [pc.alloc(), pc.alloc()]
        for s, n in zip(slots, lens):
            pc.attach(s, pages)
            pc.cow(s, 2)
            for idx in range(3, pc.pages_for(p0 + int(n))):
                pc.grant(s, idx)
    graphs = PrefillGraphs(model.tparams, model.tcfg, pcs[0].cache, "cpu")
    g = graphs.get(("suffix", 4, 8, 2))
    new_pos, phys, off = pcs[0].landing(slots, lens, p0, bucket=8)
    g.set(tokens=padded, lens=lens, p0=p0, pages=pad_pages(pages),
          slots=slots, new_pos=new_pos, valid=1, phys=phys, off=off)
    gk, gv = TS.cache.gather_prefix_pages(
        pcs[0].cache, torch.tensor(pad_pages(pages)))
    same, _ = T.prefill_with_prefix(
        model.tparams, torch.tensor(padded), gk, gv, torch.tensor(p0),
        model.tcfg, true_len=torch.tensor(lens))
    logits, picks, mx = graphs.run(g)
    assert torch.equal(logits, same)
    pk, pv = pcs[1].gather_prefix(pages)
    want, suf = T.prefill_with_prefix(
        model.tparams, torch.tensor(padded), pk[:, :, :p0], pv[:, :, :p0],
        p0, model.tcfg, true_len=torch.tensor(lens))
    pcs[1].land(slots, suf, lens, start=p0)
    torch.testing.assert_close(logits, want, atol=1e-6, rtol=0)
    assert torch.equal(picks, torch.argmax(logits, -1))
    assert torch.equal(mx, logits.amax(-1))
    _assert_pools(pcs, atol=1e-6)
    assert pcs[0].cache["pos"][slots].tolist() == (p0 + lens).tolist()
    assert graphs.keys("suffix") == [(4, 8, 2)]


def test_sample_body_equals_the_sampler(model):
    """``("sample", 3)``: the sampler over the copied logits at each
    row's key position, greedy and sampled rows mixed, and the max
    logit."""
    graphs = PrefillGraphs(model.tparams, model.tcfg, {}, "cpu")
    g = graphs.get(("sample", 3))
    logits = torch.from_numpy(
        np.random.default_rng(2).standard_normal((3, 64)).astype(np.float32))
    g.logits.copy_(logits)
    cols = dict(temp=[0.0, 1.1, 0.8], top_k=[0, 9, 0],
                top_p=[0.0, 0.0, 0.9], pos=[5, 12, 7],
                keys=np.stack([TS.seed_key(s) for s in (0, 3, 4)]))
    g.set(**cols)
    toks, mx = graphs.run(g)
    f32 = torch.float32
    want = T.sample_token_rows(
        logits, torch.tensor(cols["temp"], dtype=f32),
        torch.tensor(cols["top_k"]), torch.tensor(cols["top_p"], dtype=f32),
        torch.from_numpy(cols["keys"].astype(np.int64)),
        torch.tensor(cols["pos"]), torch.zeros(3, dtype=torch.long))
    assert torch.equal(toks, want) and torch.equal(mx, logits.amax(-1))
    assert graphs.keys("sample") == [(3,)]


# --- both engines: the same compile sets -------------------------------------


def _spy_jax_suffix(engine):
    """Record each JAX suffix prefill's shape key (prefix pages, suffix
    bucket, k) — what its jit cache compiles per."""
    seen = set()
    real = engine._suffix_prefill

    def spy(params, padded, lens, pk, pv, p0):
        seen.add((pk.shape[2] // PS, padded.shape[1], padded.shape[0]))
        return real(params, padded, lens, pk, pv, p0)

    engine._suffix_prefill = spy
    return seen


def _compile_sets(model, scenario, **kw):
    """The scenario on a fresh engine of each package -> each engine's
    ``prefill_buckets``, suffix shapes and outcomes; the JAX suffix
    shapes with their page count padded to a power of two, as the port
    gathers them.  The JAX ones are also returned as recorded."""
    out = {}
    for package in ("jax", "port"):
        engine = make_engine(model, package, **{**BASE, **kw})
        seen = _spy_jax_suffix(engine) if package == "jax" else None
        futs = scenario(engine)
        st = engine.stats()
        shapes = (sorted(seen) if seen is not None
                  else st["prefill_suffix_shapes"])
        out[package] = {"buckets": st["prefill_buckets"],
                        "suffix": sorted({(_pow2(n), b, k)
                                          for n, b, k in shapes}),
                        "raw": shapes,
                        "futs": [outcome(f) for f in futs]}
        if package == "port":
            assert (st["prefill_compilations"],
                    st["sample_compilations"]) == (0, 0)  # the CPU
    return out


def test_prefix_run_compiles_the_same_shapes(model):
    """A 19-token prefix (three pages) registered and warmed, then
    sharers with suffixes of 2, 5 and 9 tokens, greedy and sampled, and
    a plain prompt: the same ``prefill_buckets`` in both engines, and
    the same suffix shapes once the JAX engine's three prefix pages are
    counted as the port's four; tokens equal the oracle."""
    rng = np.random.default_rng(11)
    prompts = [PREFIX19 + rng.integers(0, 64, n).tolist() for n in (2, 5, 9)]
    prompts.append(rng.integers(0, 64, 13).tolist())
    kws = [{}, dict(temperature=1.1, seed=3), {}, {}]

    def scenario(engine):
        engine.register_prefix(PREFIX19)
        engine.warmup((3,))
        futs = [engine.submit(p, max_new_tokens=4, **kw)
                for p, kw in zip(prompts, kws)]
        run(engine, futs)
        return futs

    rec = _compile_sets(model, scenario)
    jax_, port = rec["jax"], rec["port"]
    assert port["buckets"] == [tuple(b) for b in jax_["buckets"]]
    assert port["suffix"] == jax_["suffix"] == port["raw"]
    assert {n for n, _, _ in jax_["raw"]} == {3}
    assert {n for n, _, _ in port["raw"]} == {4}
    assert port["futs"] == jax_["futs"] == [
        ("ok", oracle(model, p, 4, **kw), "length")
        for p, kw in zip(prompts, kws)]


def test_chunked_run_compiles_the_same_shapes(model):
    """Chunks of 8 over prompts of 41 and 27 tokens and a short one:
    both engines gather the landed pages NULL-padded to a power of two,
    so the suffix shapes are equal as recorded (1, 2, 4 and 8 pages),
    and so are the ``prefill_buckets``; tokens equal the oracle."""
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, 64, n).tolist() for n in (41, 5, 27)]

    def scenario(engine):
        engine.warmup((3,))
        futs = [engine.submit(p, max_new_tokens=4) for p in prompts]
        run(engine, futs)
        return futs

    rec = _compile_sets(model, scenario, max_len=48, prefill_chunk_tokens=8)
    jax_, port = rec["jax"], rec["port"]
    assert port["buckets"] == [tuple(b) for b in jax_["buckets"]]
    assert port["raw"] == jax_["raw"] == port["suffix"]
    assert {n for n, _, _ in port["raw"]} == {1, 2, 4, 8}
    assert port["futs"] == jax_["futs"] == [
        ("ok", oracle(model, p, 4), "length") for p in prompts]
