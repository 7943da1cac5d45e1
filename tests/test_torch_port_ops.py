"""horovod_tpu_torch kernels' plain versions against the JAX package.

Same seeded numpy inputs through the JAX function (its Pallas kernel in
interpret mode on the CPU, as the JAX package's own tests run it) and
the port's counterpart (its plain PyTorch version on the CPU).  The
CUDA kernels themselves are held against the plain versions on the card
by ``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``.

Tolerances: f32 attention agrees to summation order (atol = rtol =
1e-5); paged decode to 1e-4 for f32 and int8 pools (dequant pinned to
f32 in both) and 2e-2 for bf16 pools (the Pallas kernel casts the
unnormalized weights to bf16, the plain version the normalized ones).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as JT
from horovod_tpu.ops import attention as JA
from horovod_tpu.ops import paged_attention as JPA
from horovod_tpu_torch.models import transformer as T
from horovod_tpu_torch.ops import attention as A
from horovod_tpu_torch.ops import paged_attention as PA


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


class TestFlashAttention:
    @pytest.mark.parametrize("causal", [False, True])
    def test_matches_jax_flash(self, causal):
        rng = np.random.RandomState(0)
        q, k, v = (rng.randn(2, 4, 64, 32).astype(np.float32)
                   for _ in range(3))
        o_j, lse_j = JA._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), 0 if causal else None,
                                   None, 32, 32)
        o_t, lse_t = A.flash_attention_lse(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal)
        np.testing.assert_allclose(_np(o_t), _np(o_j), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(_np(lse_t), _np(lse_j), atol=1e-5,
                                   rtol=1e-5)
        o_only = A.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal)
        np.testing.assert_array_equal(_np(o_only), _np(o_t))

    def test_gqa_head_mapping(self):
        """K/V with H_kv heads: query head h reads kv head h // G — the
        port takes unexpanded K/V, JAX the jnp.repeat expansion."""
        rng = np.random.RandomState(1)
        H, Hkv = 8, 2
        q = rng.randn(1, H, 32, 16).astype(np.float32)
        k, v = (rng.randn(1, Hkv, 32, 16).astype(np.float32)
                for _ in range(2))
        o_j = JA.flash_attention(jnp.asarray(q),
                                 JA.expand_kv(jnp.asarray(k), H),
                                 JA.expand_kv(jnp.asarray(v), H), True)
        o_t = A.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), True)
        np.testing.assert_allclose(_np(o_t), _np(o_j), atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(
            _np(A.expand_kv(torch.from_numpy(k), H)),
            _np(JA.expand_kv(jnp.asarray(k), H)))

    def test_fully_masked_rows_and_reference(self):
        """shift past every column: o = 0, lse = NEG_INF, as in JAX."""
        rng = np.random.RandomState(2)
        q, k, v = (rng.randn(1, 2, 8, 16).astype(np.float32)
                   for _ in range(3))
        o, lse = A._reference_attention_lse(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            8, 0.25)
        assert not o.any() and (lse <= A.NEG_INF / 2).all()
        ref_j = JA.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=True)
        ref_t = A.reference_attention(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), causal=True)
        np.testing.assert_allclose(_np(ref_t), _np(ref_j), atol=1e-5,
                                   rtol=1e-5)


def _edge_case(kv):
    """The TestFusedPagedKernel edge table: a slot at table capacity, a
    partial last page, a fully masked slot, and two slots sharing
    pages."""
    rng = np.random.RandomState(3)
    S, Hkv, G, Dh, ps, MP, Pn = 4, 2, 2, 16, 8, 3, 8
    qg = rng.randn(S, Hkv, G, Dh).astype(np.float32)
    kf = rng.randn(Pn, Hkv, ps, Dh).astype(np.float32)
    vf = rng.randn(Pn, Hkv, ps, Dh).astype(np.float32)
    table = np.asarray(rng.randint(1, Pn, (S, MP)), np.int32)
    table[1] = table[0]
    limit = np.asarray([ps * MP, 5, 0, ps + 3], np.int32)
    if kv == "int8":
        kq, ks = JT.kv_quantize(jnp.asarray(kf))
        vq, vs = JT.kv_quantize(jnp.asarray(vf))
        jargs = (jnp.asarray(qg), kq, vq, ks, vs)
        targs = (torch.from_numpy(qg),) + tuple(
            torch.from_numpy(np.array(a)) for a in (kq, vq, ks, vs))
    else:
        jdt = jnp.bfloat16 if kv == "bf16" else jnp.float32
        tdt = torch.bfloat16 if kv == "bf16" else torch.float32
        jargs = (jnp.asarray(qg), jnp.asarray(kf, jdt), jnp.asarray(vf, jdt),
                 None, None)
        targs = (torch.from_numpy(qg), torch.from_numpy(kf).to(tdt),
                 torch.from_numpy(vf).to(tdt), None, None)
    return jargs, targs, table, limit


class TestPagedAttend:
    @pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
    def test_matches_jax_kernel_and_reference(self, kv):
        jargs, targs, table, limit = _edge_case(kv)
        o_jk, l_jk = JPA._pallas_paged_attend(
            *jargs, jnp.asarray(table), jnp.asarray(limit), jnp.float32)
        o_jr, l_jr = JPA.paged_attend_reference(
            *jargs, jnp.asarray(table), jnp.asarray(limit),
            compute_dtype=jnp.float32)
        o_t, l_t = PA.paged_attend(*targs, torch.from_numpy(table),
                                   torch.from_numpy(limit),
                                   compute_dtype=torch.float32)
        live = limit > 0
        for o_j, l_j, tol in ((o_jk, l_jk, 2e-2 if kv == "bf16" else 1e-4),
                              (o_jr, l_jr, 1e-4)):
            np.testing.assert_allclose(_np(o_t), _np(o_j), atol=tol,
                                       rtol=tol)
            np.testing.assert_allclose(_np(l_t)[live], _np(l_j)[live],
                                       atol=tol, rtol=tol)
        assert not _np(o_t)[~live].any()
        assert (_np(l_t)[~live] <= PA.NEG_INF / 2).all()

    def test_int8_dequant_to_bf16_matches_jax(self):
        jargs, targs, table, limit = _edge_case("int8")
        o_j, l_j = JPA.paged_attend_reference(
            *jargs, jnp.asarray(table), jnp.asarray(limit),
            compute_dtype=jnp.bfloat16)
        o_t, l_t = PA.paged_attend_reference(
            *targs, torch.from_numpy(table), torch.from_numpy(limit),
            compute_dtype=torch.bfloat16)
        np.testing.assert_allclose(_np(o_t), _np(o_j), atol=2e-2, rtol=2e-2)


class TestQuantization:
    def test_kv_quantize_bit_exact(self):
        rng = np.random.RandomState(0)
        x = rng.randn(3, 5, 7, 16).astype(np.float32)
        x[0, 0, 0] = 0.0                 # the eps clamp
        x[1, 1, 1, :2] = [0.5, -0.5]     # ties on the rounding grid
        q_j, s_j = JT.kv_quantize(jnp.asarray(x))
        q_t, s_t = T.kv_quantize(torch.from_numpy(x))
        np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            np.testing.assert_array_equal(
                _np(T.kv_dequantize(q_t, s_t, tdt)),
                _np(JT.kv_dequantize(q_j, s_j, jdt)))
        assert PA.DEQUANT_COMPUTE == torch.float32
