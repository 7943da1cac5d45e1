"""horovod_tpu_torch's CUDA kernels against their plain versions, on the
card.  Every test here is marked ``cuda`` and skips without a CUDA
device: the kernels have no CPU mode.  The file imports no JAX, so it
also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances: f32 1e-4 (summation order); bf16 5e-2 for flash attention
(the plain version rounds the scores to bf16, the kernel keeps them in
f32) and 2e-2 for bf16 paged pools (weights cast to bf16 before versus
after normalizing).
"""

import numpy as np
import pytest
import torch

from horovod_tpu_torch.models import transformer as T
from horovod_tpu_torch.ops import attention as A
from horovod_tpu_torch.ops import paged_attention as PA

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_kernel(dev, dtype, tol, D):
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((2, 8, 200, D), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((2, 2, 200, D), generator=g, device=dev).to(dtype)
            for _ in range(2))
    before = A.flash_fwd_launches
    o, lse = A.flash_attention_lse(q, k, v, True)
    assert A.flash_fwd_launches == before + 1
    o_r, l_r = A._reference_attention_lse(
        q, A.expand_kv(k, 8), A.expand_kv(v, 8), 0, 1 / D ** 0.5)
    assert (o.float() - o_r.float()).abs().max().item() <= tol
    assert (lse - l_r).abs().max().item() <= tol


def _edge_case(kv, dev):
    """Partial last page, a slot at table capacity, a limit=0 slot and
    two slots sharing pages."""
    rng = np.random.RandomState(3)
    S, Hkv, G, Dh, ps, MP, Pn = 4, 2, 2, 64, 16, 3, 8
    qg = torch.from_numpy(rng.randn(S, Hkv, G, Dh).astype(np.float32))
    kf = torch.from_numpy(rng.randn(Pn, Hkv, ps, Dh).astype(np.float32))
    vf = torch.from_numpy(rng.randn(Pn, Hkv, ps, Dh).astype(np.float32))
    table = np.asarray(rng.randint(1, Pn, (S, MP)), np.int32)
    table[1] = table[0]
    limit = np.asarray([ps * MP, 5, 0, ps + 3], np.int32)
    if kv == "int8":
        (kq, ks), (vq, vs) = T.kv_quantize(kf), T.kv_quantize(vf)
        args = (qg, kq, vq, ks, vs)
    else:
        dt = torch.bfloat16 if kv == "bf16" else torch.float32
        args = (qg, kf.to(dt), vf.to(dt), None, None)
    args = [a.to(dev) if a is not None else None for a in args]
    return (args, torch.from_numpy(table).to(dev),
            torch.from_numpy(limit).to(dev))


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
def test_paged_kernel(dev, kv):
    args, table, limit = _edge_case(kv, dev)
    before = PA.paged_attend_launches
    o, lse = PA.paged_attend(*args, table, limit,
                             compute_dtype=torch.float32)
    assert PA.paged_attend_launches == before + 1
    o_r, l_r = PA.paged_attend_reference(*args, table, limit,
                                         compute_dtype=torch.float32)
    tol = 2e-2 if kv == "bf16" else 1e-4
    live = limit > 0
    assert (o - o_r).abs().max().item() <= tol
    assert (lse[live] - l_r[live]).abs().max().item() <= tol
    assert not o[~live].any() and (lse[~live] <= PA.NEG_INF / 2).all()


def test_cuda_input_never_falls_back(dev):
    q = torch.zeros((1, 2, 8, 48), device=dev)  # head_dim 48: no kernel
    with pytest.raises(ValueError, match="head_dim"):
        A.flash_attention(q, q, q, True)
    x = torch.zeros((1, 2, 8, 64), device=dev)
    with pytest.raises(NotImplementedError):
        A.flash_attention(x.clone().requires_grad_(), x, x, True)
    with pytest.raises(TypeError, match="int32"):
        PA.paged_attend(torch.zeros((1, 1, 1, 64), device=dev),
                        x[0, :1, None], x[0, :1, None], None, None,
                        torch.zeros((1, 1), dtype=torch.int64, device=dev),
                        torch.ones(1, dtype=torch.int32, device=dev))
