"""horovod_tpu_torch's Transformer against the JAX package's, at f32.

One tiny configuration (L=2, d=64, H=4, H_kv=2), JAX's own seeded
parameters loaded through ``params_from_jax``, and the same numpy
inputs through both.  Tolerance atol = rtol = 1e-4 (f32 summation order
differs between XLA and PyTorch)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu import serving as jserving
from horovod_tpu.models import transformer as JT
from horovod_tpu_torch.models import params_from_jax
from horovod_tpu_torch.models import transformer as T
from horovod_tpu_torch.serving import init_page_pool

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(impl="flash"):
    jcfg = JT.TransformerConfig(
        vocab_size=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
        max_seq=64, dtype=jnp.float32, attention_impl=impl, n_kv_heads=2)
    tcfg = T.TransformerConfig(
        vocab_size=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
        max_seq=64, dtype=torch.float32, attention_impl=impl, n_kv_heads=2)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, device="cpu")
    return jparams, jcfg, tparams, tcfg


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


class TestParams:
    def test_params_from_jax_round_trip(self, model):
        jparams, _, tparams, _ = model
        flat_j = jax.tree_util.tree_leaves_with_path(jparams)
        assert len(flat_j) == 2 + 1 + len(tparams["layers"])
        for path, leaf in flat_j:
            node = tparams
            for key in path:
                node = node[key.key]
            assert tuple(node.shape) == leaf.shape
            np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))

    def test_bf16_load_casts_matrices_keeps_norms_f32(self, model):
        jparams, _, _, tcfg = model
        cfg16 = dataclasses.replace(tcfg, dtype=torch.bfloat16)
        p = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                            cfg16, device="cpu")
        assert p["layers"]["wq"].dtype == torch.bfloat16
        assert p["head"].dtype == torch.bfloat16
        assert p["layers"]["ln1"].dtype == torch.float32
        np.testing.assert_array_equal(
            p["embed"].float().numpy(),
            np.asarray(jnp.asarray(jparams["embed"]).astype(jnp.bfloat16)
                       .astype(jnp.float32)))

    def test_init_params_layout_matches_jax(self, model):
        jparams, _, _, tcfg = model
        p = T.init_params(tcfg, seed=0, device="cpu")
        for name, leaf in jparams["layers"].items():
            assert tuple(p["layers"][name].shape) == leaf.shape
        for name in ("embed", "ln_f", "head"):
            assert tuple(p[name].shape) == jparams[name].shape

    def test_unported_configs_raise(self):
        with pytest.raises(NotImplementedError):
            T.TransformerConfig(n_experts=4)
        with pytest.raises(NotImplementedError):
            T.TransformerConfig(attention_impl="ring")


class TestPrefill:
    @pytest.mark.parametrize("impl", ["reference", "flash"])
    def test_logits_and_kv_match_jax(self, model, impl):
        jparams, jcfg, tparams, tcfg = model
        jcfg = dataclasses.replace(jcfg, attention_impl=impl)
        tcfg = dataclasses.replace(tcfg, attention_impl=impl)
        rng = np.random.RandomState(0)
        prompt = rng.randint(0, 64, (2, 16)).astype(np.int32)
        lens = np.asarray([16, 9], np.int32)
        jl, jc = JT.prefill(jparams, jnp.asarray(prompt),
                            JT.init_cache(jcfg, 2, 24), jcfg,
                            true_len=jnp.asarray(lens))
        tl, tc = T.prefill(tparams, torch.from_numpy(prompt).long(),
                           T.init_cache(tcfg, 2, 24, device="cpu"), tcfg,
                           true_len=torch.from_numpy(lens))
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        np.testing.assert_allclose(_np(tc["k"]), _np(jc["k"]), **TOL)
        np.testing.assert_allclose(_np(tc["v"]), _np(jc["v"]), **TOL)
        assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist()

    def test_decode_step_matches_jax(self, model):
        jparams, jcfg, tparams, tcfg = model
        prompt = np.asarray([[3, 1, 4, 1, 5]], np.int32)
        _, jc = JT.prefill(jparams, jnp.asarray(prompt),
                           JT.init_cache(jcfg, 1, 12), jcfg)
        _, tc = T.prefill(tparams, torch.from_numpy(prompt).long(),
                          T.init_cache(tcfg, 1, 12, device="cpu"), tcfg)
        for tok in (9, 2, 6):
            jl, jc = JT.decode_step(jparams, jnp.asarray([tok], jnp.int32),
                                    jc, jcfg)
            tl, tc = T.decode_step(tparams, torch.tensor([tok]), tc, tcfg)
            np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        assert tc["pos"] == int(jc["pos"]) == 8


class TestDecodeStepPaged:
    @pytest.mark.parametrize("kv", [None, "int8"])
    def test_out_of_order_tables_match_jax(self, model, kv):
        """Ticks over a shuffled page table crossing page boundaries, with
        an inactive row; the port's kernel path (plain paged_attend on
        the CPU) and unfused path both against JAX's unfused tick."""
        jparams, jcfg, tparams, tcfg = model
        rng = np.random.RandomState(1)
        S, Pn, ps, MP = 3, 10, 4, 4
        jpool = jserving.init_page_pool(jcfg, S, Pn, ps, kv_dtype=kv)
        kf = rng.randn(*jpool["k"].shape).astype(np.float32)
        vf = rng.randn(*jpool["v"].shape).astype(np.float32)
        if kv == "int8":
            kq, ks = JT.kv_quantize(jnp.asarray(kf))
            vq, vs = JT.kv_quantize(jnp.asarray(vf))
            jpool.update(k=kq, v=vq, k_scale=ks, v_scale=vs)
        else:
            jpool.update(k=jnp.asarray(kf), v=jnp.asarray(vf))
        pos = np.asarray([5, 2, 9], np.int32)
        jpool["pos"] = jnp.asarray(pos)
        table = np.asarray(rng.permutation(np.arange(1, Pn))[:S * 3]
                           .reshape(S, 3), np.int32)
        table = np.concatenate([table, np.zeros((S, MP - 3), np.int32)], 1)
        active = np.asarray([True, False, True])
        tpools = []
        for _ in range(2):
            tp = init_page_pool(tcfg, S, Pn, ps, kv, device="cpu")
            for name in tp:
                tp[name] = torch.from_numpy(np.array(jpool[name]))
            tpools.append(tp)
        toks = rng.randint(0, 64, S)
        jtab, ttab = jnp.asarray(table), torch.from_numpy(table)
        for _ in range(4):  # crosses the page boundary at position 8
            jl, jpool = JT.decode_step_paged(
                jparams, jnp.asarray(toks, jnp.int32), jpool, jtab, jcfg,
                jnp.asarray(active))
            for tp, kernel in zip(tpools, (True, False)):
                tl, _ = T.decode_step_paged(
                    tparams, torch.from_numpy(toks), tp, ttab, tcfg,
                    torch.from_numpy(active), kernel=kernel)
                np.testing.assert_allclose(_np(tl)[active],
                                           _np(jl)[active], **TOL)
                assert tp["pos"].tolist() == np.asarray(jpool["pos"]).tolist()
            toks = np.array(jnp.argmax(jl, -1))
        # Every page but the NULL page 0, which only inactive rows write
        # (their attention differs between the unfused and kernel paths
        # and nothing ever reads it).
        for name in jpool:
            if name != "pos":
                np.testing.assert_allclose(_np(tpools[1][name])[:, 1:],
                                           _np(jpool[name])[:, 1:], **TOL)

    def test_capacity_guard(self, model):
        _, _, tparams, tcfg = model
        pool = init_page_pool(tcfg, 2, 5, 8, device="cpu")
        pool["pos"] = torch.tensor([16, 0], dtype=torch.int32)
        with pytest.raises(ValueError, match="capacity"):
            T.decode_step_paged(tparams, torch.zeros(2, dtype=torch.long),
                                pool, torch.zeros((2, 2), dtype=torch.int32),
                                tcfg, torch.tensor([True, False]))


def test_greedy_decode_matches_jax(model):
    jparams, jcfg, tparams, tcfg = model
    prompt = np.asarray([[7, 7, 2, 9, 30, 11]], np.int32)
    want = np.asarray(JT.greedy_decode(jparams, jnp.asarray(prompt), 8,
                                       jcfg))[0].tolist()
    got, gap = T.greedy_decode(tparams, torch.from_numpy(prompt).long(), 8,
                               tcfg, margins=True)
    assert got[0].tolist() == want
    assert (gap >= 0).all()
