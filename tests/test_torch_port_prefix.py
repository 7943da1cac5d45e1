"""The port's shared-prefix admission against the JAX engine, on the CPU
at f32.

``prefill_with_prefix`` first: the same suffix, prefix K/V and weights
through both packages (atol = rtol = 1e-4, f32 summation order), by the
port's ``reference`` route and its ``flash`` route (K1's plain version
on the CPU), with the prefix page-aligned and not, K = 2 rows of
different real lengths; a bf16 model (2e-2 of the largest logit: bf16
rounds each product's operands to 2^-8 of a value, and the two packages
round at different points of the projections); and a prefix read back
from an int8 pool through each package's ``gather_prefix``.

Then the engine, following ``tests/test_paged.py`` (prefix sharing,
its lifecycle, resume over shared pages) and ``tests/test_sampling.py``
(sampled sharers of an attach-only admission): the same stepped
scenario runs through both engines from one set of weights and must
give the same record — tokens or typed errors, the prefill count, the
pages shared and free, the restart and resume counters.  A prefix is
prefilled once for its sharers; a prompt that is the prefix admits
with no prefill; the sharers' copies of the prefix's partial last page
leave the shared page as it was; a restart or a failure invalidates the
prefix, which re-prefills once; a failed prefix prefill unpins its
pages; a resumed request re-attaches and the refcounts come back to the
registry's pin.  Copy-on-write keeps the pool tensors where they lie
(the captured tick reads them by address).

The scenarios run on one lent pair of engines and read their counters
as differences; each unregisters its prefix before it returns."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu import serving as JS
from horovod_tpu.models import transformer as JT
from horovod_tpu_torch import serving as TS
from horovod_tpu_torch.models import params_from_jax
from horovod_tpu_torch.models import transformer as T

from torch_port_parity import counters, make_model, oracle, outcome, run, \
    run_both

TOL = dict(atol=1e-4, rtol=1e-4)

#: An 11-token prefix: not a multiple of the page size 8, so its last
#: page is partial and every sharer copies it before writing.
PREFIX11 = [7, 3, 9, 1, 4, 2, 8, 6, 5, 3, 2]
#: An 8-token prefix: one whole page.
PREFIX8 = [1, 2, 3, 4, 5, 6, 7, 8]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model():
    return make_model()


# --- prefill_with_prefix ----------------------------------------------------


def _prefix_kv(model, p0, P0, seed):
    """Prefix K/V ``(L, H_kv, P0, Dh)`` f32: the JAX prefill of ``p0``
    random tokens, then junk past ``p0`` (a page's tail)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, model.jcfg.vocab_size, (1, p0))
    cache = JT.init_cache(model.jcfg, 1, P0)
    _, cache = JT.prefill(model.jparams, jnp.asarray(toks), cache,
                          model.jcfg)
    k, v = (np.array(cache[n][:, 0]) for n in ("k", "v"))
    k[:, :, p0:] = rng.standard_normal(k[:, :, p0:].shape)
    v[:, :, p0:] = rng.standard_normal(v[:, :, p0:].shape)
    return k, v


def _both(model, tparams, tcfg, jparams, jcfg, suffix, pk, pv, p0,
          true_len):
    jl, jo = JT.prefill_with_prefix(
        jparams, jnp.asarray(suffix), jnp.asarray(pk), jnp.asarray(pv), p0,
        jcfg, true_len=jnp.asarray(true_len))
    tl, to = T.prefill_with_prefix(
        tparams, torch.tensor(suffix), torch.tensor(pk), torch.tensor(pv),
        p0, tcfg, true_len=torch.tensor(true_len))
    assert to["pos"].tolist() == np.asarray(jo["pos"]).tolist()
    return (np.asarray(jl, np.float32), tl.float().numpy(),
            {n: (np.asarray(jo[n], np.float32), to[n].float().numpy())
             for n in ("k", "v")})


class TestPrefillWithPrefix:
    @pytest.mark.parametrize("impl", ["reference", "flash"])
    @pytest.mark.parametrize("p0,P0", [(8, 8), (11, 16)],
                             ids=["aligned", "unaligned"])
    def test_matches_jax(self, model, impl, p0, P0):
        """K = 2 suffixes of 6 and 3 real tokens (bucket 8) over one
        prefix, the page tail past ``p0`` junk: logits, suffix K/V and
        positions equal the JAX function's."""
        pk, pv = _prefix_kv(model, p0, P0, seed=p0)
        suffix = np.random.default_rng(1).integers(0, 64, (2, 8))
        tcfg = dataclasses.replace(model.tcfg, attention_impl=impl)
        jl, tl, kv = _both(model, model.tparams, tcfg, model.jparams,
                           model.jcfg, suffix, pk, pv, p0, [6, 3])
        np.testing.assert_allclose(tl, jl, **TOL)
        for j, t in kv.values():
            np.testing.assert_allclose(t, j, **TOL)

    def test_flash_route_launches_k1_shifted(self, model, monkeypatch):
        """The ``flash`` route attends through K1's wrapper once a layer
        over the page-padded prefix and the suffix, ``P0 + S0`` keys,
        with ``shift = -p0`` as a 0-dim int32 tensor (the device shift a
        captured graph replays with): the page tail lies past every
        row's diagonal, so it never counts."""
        seen = []
        real = T.attn.flash_attention_shifted

        def spy(q, k, v, shift, sm_scale=None):
            assert isinstance(shift, torch.Tensor) and shift.dim() == 0 \
                and shift.dtype == torch.int32
            seen.append((tuple(q.shape), tuple(k.shape), int(shift)))
            return real(q, k, v, shift, sm_scale)

        monkeypatch.setattr(T.attn, "flash_attention_shifted", spy)
        pk, pv = _prefix_kv(model, 11, 16, seed=3)
        T.prefill_with_prefix(model.tparams,
                              torch.zeros((2, 8), dtype=torch.long),
                              torch.tensor(pk), torch.tensor(pv), 11,
                              model.tcfg, true_len=torch.tensor([8, 2]))
        cfg = model.tcfg
        assert seen == [((2, cfg.n_heads, 8, cfg.head_dim),
                         (2, cfg.kv_heads, 16 + 8, cfg.head_dim), -11)] \
            * cfg.n_layers

    def test_bf16_model(self, model):
        """A bf16 model (both packages cast the same f32 weights): the
        logits within 2e-2 of the largest, the suffix K/V within 2e-2 of
        the largest value (both bf16)."""
        jcfg = dataclasses.replace(model.jcfg, dtype=jnp.bfloat16)
        tcfg = dataclasses.replace(model.tcfg, dtype=torch.bfloat16)
        tparams = params_from_jax(
            {"embed": np.asarray(model.jparams["embed"]),
             "layers": {k: np.asarray(v)
                        for k, v in model.jparams["layers"].items()},
             "ln_f": np.asarray(model.jparams["ln_f"]),
             "head": np.asarray(model.jparams["head"])}, tcfg, device="cpu")
        pk, pv = _prefix_kv(model, 11, 16, seed=5)
        suffix = np.random.default_rng(2).integers(0, 64, (2, 8))
        jl, tl, kv = _both(model, tparams, tcfg, model.jparams, jcfg,
                           suffix, pk, pv, 11, [8, 5])
        assert np.abs(tl - jl).max() <= 2e-2 * np.abs(jl).max()
        for j, t in kv.values():
            assert np.abs(t - j).max() <= 2e-2 * np.abs(j).max()

    def test_int8_pool(self, model):
        """A prefix landed in an int8 pool and read back through each
        package's ``gather_prefix`` (dequantized to f32): the gathered
        K/V agree, and so does the suffix prefill over them."""
        p0, ps = 11, 8
        rng = np.random.default_rng(7)
        toks = rng.integers(0, 64, (1, 16))
        jpc = JS.PagedSlotCache(model.jcfg, 2, 40, page_size=ps,
                                kv_dtype="int8")
        tpc = TS.PagedSlotCache(model.tcfg, 2, 40, page_size=ps,
                                kv_dtype="int8", device="cpu")
        jcache = JT.init_cache(model.jcfg, 1, 16)
        _, jpre = JT.prefill(model.jparams, jnp.asarray(toks), jcache,
                             model.jcfg, true_len=jnp.asarray([p0]))
        tcache = T.init_cache(model.tcfg, 1, 16, device="cpu")
        _, tpre = T.prefill(model.tparams, torch.tensor(toks), tcache,
                            model.tcfg, true_len=torch.tensor([p0]))
        got = []
        for pc, pre in ((jpc, jpre), (tpc, tpre)):
            pages = pc.grant_raw(pc.pages_for(p0))
            pc.land_raw(pages, pre, p0)
            got.append([np.asarray(x, np.float32)[:, :, :p0]
                        for x in pc.gather_prefix(pages)])
        for j, t in zip(*got):
            np.testing.assert_allclose(t, j, **TOL)
        suffix = rng.integers(0, 64, (2, 8))
        jl, tl, kv = _both(model, model.tparams, model.tcfg, model.jparams,
                           model.jcfg, suffix, *got[0], p0, [8, 4])
        np.testing.assert_allclose(tl, jl, **TOL)


# --- the paging surface ------------------------------------------------------


def test_cow_keeps_the_pool_tensors(model):
    """``cow`` copies a shared page inside the pool tensors: every
    tensor keeps its storage (the captured tick reads it by address),
    the copy equals the source, the table moves and the refcounts
    follow."""
    pc = TS.PagedSlotCache(model.tcfg, 2, 40, page_size=8, kv_dtype="int8",
                           device="cpu")
    for t in pc.cache.values():
        t.copy_(torch.randint(-100, 100, t.shape).to(t.dtype))
    ptrs = {k: t.data_ptr() for k, t in pc.cache.items()}
    pages = pc.grant_raw(2)
    s = pc.alloc()
    pc.attach(s, pages)
    assert pc.pages_shared == 2
    dst = pc.cow(s, 1)
    assert dst not in pages and pc.table[s, 1] == dst
    assert pc.cow(s, 1) == dst  # already private: a no-op
    assert pc.pages_shared == 1
    assert {k: t.data_ptr() for k, t in pc.cache.items()} == ptrs
    for name in ("k", "v", "k_scale", "v_scale"):
        t = pc.cache[name]
        assert torch.equal(t[:, dst], t[:, pages[1]]), name
    pc.free(s)
    pc.release_raw(pages)
    assert pc.free_pages == pc.n_pages


# --- the engine --------------------------------------------------------------

#: The lent engines: three slots, K = 2 (BASE: pages of 8, max_len 40).
POOL = dict(n_slots=3, max_queue_depth=8)


def _steps(engine, futs):
    """Step until every future resolves; the most pages shared at once."""
    shared = 0
    for _ in range(400):
        if all(f.done() for f in futs):
            return shared
        engine.step()
        shared = max(shared, engine.slots.pages_shared)
    raise AssertionError("engine did not finish within the tick budget")


def _pages(engine):
    return {"free": engine.slots.free_pages, "n": engine.slots.n_pages,
            "shared": engine.slots.pages_shared}


def _calls(engine):
    return engine.stats()["prefill_calls"]


class TestPrefixSharing:
    def test_prefix_prefilled_once_for_its_sharers(self, model):
        """Four sharers, greedy and sampled, suffixes of 2-5 tokens: the
        prefix is prefilled once at registration, each admission group
        runs one suffix prefill over its pages, the pages are shared
        while they decode, and the tokens equal the whole prompt's
        oracle.  After the drain the pin is all that holds pages; after
        ``unregister_prefix`` none."""
        rng = np.random.default_rng(5)
        sufs = [rng.integers(0, 64, n).tolist() for n in (3, 5, 2, 4)]
        kws = [{}, dict(temperature=1.1, seed=3), {},
               dict(temperature=0.8, top_k=9, seed=4)]

        def scenario(S, make):
            engine = make(**POOL)
            before, c0 = counters(engine), _calls(engine)
            engine.register_prefix(PREFIX11)
            reg = _calls(engine) - c0
            futs = [engine.submit(PREFIX11 + s, max_new_tokens=7, **kw)
                    for s, kw in zip(sufs, kws)]
            shared = _steps(engine, futs)
            pinned = _pages(engine)
            engine.unregister_prefix(PREFIX11)
            return {"futs": [outcome(f) for f in futs], "reg": reg,
                    "calls": _calls(engine) - c0, "shared": shared,
                    "pinned": pinned, "after": _pages(engine),
                    "gauge": engine.stats()["kv_pages_shared"],
                    "stats": counters(engine, since=before)}

        rec = run_both(model, scenario, shared=True)
        for s, kw, out in zip(sufs, kws, rec["futs"]):
            assert out == ("ok", oracle(model, PREFIX11 + s, 7, **kw),
                           "length")
        assert rec["reg"] == 1 and 1 + 2 <= rec["calls"] <= 1 + 4
        assert rec["shared"] >= 1 and rec["gauge"] == 0
        assert rec["pinned"]["free"] == rec["pinned"]["n"] - 2
        assert rec["after"]["free"] == rec["after"]["n"]
        assert rec["stats"]["requests_completed"] == 4

    def test_prompt_is_the_prefix_admits_without_prefill(self, model):
        """Prompts that are the prefix admit with no forward pass: the
        pages attach, greedy sharers emit the cached first token and
        sampled ones each draw their own from the prefix's logits at key
        position ``len(prompt)``; decode copies the shared partial page
        before its first write."""
        kws = [dict(temperature=1.4, seed=3), dict(temperature=1.4, seed=17),
               {}]

        def scenario(S, make):
            engine = make(**POOL, max_prefills_per_tick=3)
            c0 = _calls(engine)
            engine.register_prefix(PREFIX11)
            c1 = _calls(engine)
            futs = [engine.submit(list(PREFIX11), max_new_tokens=6, **kw)
                    for kw in kws]
            shared = _steps(engine, futs)
            calls = _calls(engine) - c1
            engine.unregister_prefix(PREFIX11)
            return {"futs": [outcome(f) for f in futs], "reg": c1 - c0,
                    "calls": calls, "shared": shared,
                    "after": _pages(engine)}

        rec = run_both(model, scenario, shared=True)
        for kw, out in zip(kws, rec["futs"]):
            assert out == ("ok", oracle(model, PREFIX11, 6, **kw), "length")
        assert rec["futs"][0][1] != rec["futs"][1][1]
        assert (rec["reg"], rec["calls"]) == (1, 0)
        assert rec["shared"] >= 1
        assert rec["after"]["free"] == rec["after"]["n"]

    def test_copies_leave_the_shared_page_as_it_was(self, model):
        """Two sharers decode into their copies of the partial prefix
        page; a later sharer still reads the prefix's own K/V."""
        rng = np.random.default_rng(9)
        wave1 = [PREFIX11 + rng.integers(0, 64, n).tolist() for n in (3, 2)]
        late = PREFIX11 + rng.integers(0, 64, 4).tolist()

        def scenario(S, make):
            engine = make(**POOL)
            engine.register_prefix(PREFIX11)
            w1 = [engine.submit(p, max_new_tokens=6) for p in wave1]
            run(engine, w1)
            f2 = engine.submit(late, max_new_tokens=8)
            run(engine, [f2])
            engine.unregister_prefix(PREFIX11)
            return {"futs": [outcome(f) for f in w1 + [f2]],
                    "after": _pages(engine)}

        rec = run_both(model, scenario, shared=True)
        assert rec["futs"] == [("ok", oracle(model, p, n), "length")
                               for p, n in zip(wave1 + [late], (6, 6, 8))]
        assert rec["after"]["free"] == rec["after"]["n"]


class TestPrefixLifecycle:
    def test_restart_invalidates_and_reprefills_once(self, model):
        """A restart resets the pool: the entry re-prefills once at its
        next use, and sharing goes on (one re-registration prefill and
        one suffix prefill)."""

        def scenario(S, make):
            engine = make(**POOL)
            engine.register_prefix(PREFIX8)
            f1 = engine.submit(PREFIX8 + [9], max_new_tokens=4)
            run(engine, [f1])
            c0 = _calls(engine)
            with engine._lock:
                engine._consec_failures = 0
                engine._restart()
            f2 = engine.submit(PREFIX8 + [9, 10], max_new_tokens=4)
            shared = _steps(engine, [f2])
            calls = _calls(engine) - c0
            run(engine, [engine.submit([3], max_new_tokens=2)])  # healthy
            engine.unregister_prefix(PREFIX8)
            return {"futs": [outcome(f) for f in (f1, f2)], "calls": calls,
                    "shared": shared, "after": _pages(engine)}

        rec = run_both(model, scenario, shared=True)
        assert rec["futs"] == [
            ("ok", oracle(model, PREFIX8 + [9], 4), "length"),
            ("ok", oracle(model, PREFIX8 + [9, 10], 4), "length")]
        assert rec["calls"] == 2 and rec["shared"] >= 1
        assert rec["after"]["free"] == rec["after"]["n"]

    @pytest.mark.parametrize("prompt,min_tokens", [
        (PREFIX11 + [40, 41, 42], 2), (PREFIX11, 3)],
        ids=["suffix", "prompt_is_prefix"])
    def test_failure_resumes_over_the_reprefilled_prefix(self, model, prompt,
                                                         min_tokens):
        """A decode fault mid-stream: the failure invalidates the prefix
        (its pages died with the pool), the restart re-prefills it once
        and the request resumes by attaching it and prefilling only its
        suffix (the emitted tokens, when the prompt was the prefix); the
        tokens equal an uninterrupted run's, the pages are shared while
        it decodes, and the refcounts come back to the registry's pin."""

        def scenario(S, make):
            engine = make(**POOL)
            inj = engine.engine_cfg.faults
            before = counters(engine)
            engine.register_prefix(PREFIX11)
            fut = engine.submit(prompt, max_new_tokens=9)
            while len(fut.tokens_so_far()) < min_tokens:
                engine.step()
            inj.add(S.FaultSpec(site="decode_tick", kind="raise",
                                skip=inj.visits("decode_tick")))
            c0 = _calls(engine)
            shared = _steps(engine, [fut])
            calls = _calls(engine) - c0
            pinned = _pages(engine)
            engine.unregister_prefix(PREFIX11)
            return {"fut": outcome(fut), "calls": calls, "shared": shared,
                    "pinned": pinned, "after": _pages(engine),
                    "stats": counters(engine, since=before)}

        rec = run_both(model, scenario, shared=True)
        assert rec["fut"] == ("ok", oracle(model, prompt, 9), "length")
        assert rec["calls"] == 2 and rec["shared"] >= 1
        st = rec["stats"]
        assert (st["engine_restarts"], st["requests_resumed"],
                st["journal_inflight"]) == (1, 1, 0)
        assert rec["pinned"]["free"] == rec["pinned"]["n"] - 2
        assert rec["after"]["free"] == rec["after"]["n"]

    def test_terminate_then_unregister(self, model):
        """``terminate`` resets the pool, pins included: unregistering a
        prefix registered before it is a no-op, not an underflow."""

        def scenario(S, make):
            engine = make(**POOL)
            engine.register_prefix(PREFIX8)
            engine.terminate("test teardown")
            engine.unregister_prefix(PREFIX8)
            return {"after": _pages(engine), "state": engine.health}

        rec = run_both(model, scenario)
        assert rec["after"]["free"] == rec["after"]["n"]
        assert rec["state"] == "failed"

    def test_failed_prefix_prefill_unpins_its_pages(self, model):
        """A prefix prefill that dies after its pages were pinned unpins
        them, and leaves no entry behind."""
        boom = RuntimeError("injected prefill failure")

        def fail(*a, **k):
            raise boom

        def scenario(S, make):
            engine = make(**POOL)
            free0 = engine.slots.free_pages
            # Each engine's whole-prompt prefill: the JAX engine's
            # compiled function, the port's eager call.
            name = "_prefill_fn" if S is JS else "_prefill_rows"
            setattr(engine, name, fail)
            try:
                engine.register_prefix(PREFIX11)
                raised = None
            except RuntimeError as e:
                raised = str(e)
            finally:
                delattr(engine, name)
            return {"raised": raised, "free": engine.slots.free_pages - free0,
                    "registered": engine.stats()["prefixes_registered"]}

        rec = run_both(model, scenario, shared=True)
        assert rec == {"raised": "injected prefill failure", "free": 0,
                       "registered": 0}

    def test_typed_registration_errors(self, model):
        """An empty prefix and one longer than a slot are typed errors,
        the same in both packages."""

        def scenario(S, make):
            engine = make(**POOL)
            got = []
            for tokens in ([], list(range(41))):
                try:
                    engine.register_prefix(tokens)
                    got.append(None)
                except S.ServingError as e:
                    got.append(type(e).__name__)
            return got

        assert run_both(model, scenario, shared=True) == \
            ["ServingError", "RequestTooLongError"]
