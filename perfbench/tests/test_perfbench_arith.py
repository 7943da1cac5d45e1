"""The frozen arithmetic against ``FlopCounterMode`` on the plain references,
and the attention counts against a brute count."""

import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import arith
from perfbench.families import decoder as fam_decoder
from perfbench.families import resnet as fam_resnet
from perfbench.reference import decoder, precision, resnet

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _config(name, **sizes):
    with open(CONFIGS / f"{name}.json") as f:
        c = json.load(f)
    c.update(sizes)
    return c


@pytest.mark.parametrize("stages,filters,image", [([1, 1, 1, 1], 8, 32),
                                                  ([2, 1, 1, 1], 8, 64),
                                                  ([1, 2, 1, 1], 4, 48)])
def test_resnet_flops_match_the_counter(stages, filters, image):
    torch.manual_seed(0)
    c = _config("resnet50", stage_sizes=stages, num_filters=filters,
                image_size=image, num_classes=10)
    params, _ = fam_resnet.weights(c, 3, "cpu")
    for p in params.values():
        p.requires_grad_()
    x = torch.randn(2, 3, image, image)
    with FlopCounterMode(display=False) as fc:
        logits, _ = resnet.forward(params, x, c, precision.Exact,
                                   recompute=False)
        resnet.cross_entropy(logits, torch.tensor([1, 2])).backward()
    assert fc.get_total_flops() == 2 * arith.resnet_train_flops_per_image(c)


def test_resnet50_forward_is_the_published_count():
    # 4.09 G multiply-adds a 224x224 image (He et al. 2015, table 1,
    # "3.8 x 10^9" without the v1.5 stride move; torchvision 4.09 GMACs).
    c = _config("resnet50")
    assert arith.resnet_forward_flops_per_image(c) / 2e9 == pytest.approx(
        4.089, abs=5e-3)
    assert len(arith.resnet_convs(c)) == 53


def test_lm_flops_match_the_counter():
    c = _config("mistral7b-l8", hidden_size=128, num_attention_heads=2,
                num_key_value_heads=1, intermediate_size=96,
                num_hidden_layers=2, vocab_size=64)
    B, S = 2, 16
    params = dict(fam_decoder.initial_state(c, 5, "cpu"))
    for p in params.values():
        p.requires_grad_()
    tok = torch.randint(0, 64, (B, S))
    with FlopCounterMode(display=False) as fc:
        decoder.loss(params, tok, tok, c, precision.Exact,
                     recompute=False).backward()
    d = arith.lm_dims(c)
    full_attention = 12.0 * d["L"] * B * S * S * d["H"] * d["Dh"]
    matmuls = 6.0 * arith.lm_matmul_params(c) * B * S
    assert fc.get_total_flops() == matmuls + full_attention
    # The model-FLOPs count keeps half of the full score products.
    assert arith.lm_train_flops_per_token(c, S) * B * S == \
        matmuls + full_attention / 2


def test_mistral_matmul_params():
    assert arith.lm_matmul_params(_config("mistral7b-l8")) == 1_879_048_192


@pytest.mark.parametrize("S", [1, 2, 7, 33])
def test_attention_counts_against_a_brute_count(S):
    B, H, Hkv, D = 2, 4, 2, 8
    pairs = sum(1 for i in range(S) for j in range(S) if j <= i)
    assert arith.causal_pairs(S) == pairs
    q = torch.zeros(B, H, S, D, dtype=torch.bfloat16)
    k = torch.zeros(B, Hkv, S, D, dtype=torch.bfloat16)
    lse = torch.zeros(B, H, S, dtype=torch.float32)
    flops, nbytes = arith.attention_fwd(B, H, Hkv, S, D)
    assert flops == 2 * 2 * D * pairs * B * H  # q·k and p·v, a pair each
    assert nbytes == 2 * q.nbytes + 2 * k.nbytes + lse.nbytes
    flops, nbytes = arith.attention_bwd(B, H, Hkv, S, D)
    assert flops == 5 * 2 * D * pairs * B * H
    # reads q, k, v, o, dO, lse; writes dq, dk, dv
    assert nbytes == 4 * q.nbytes + 4 * k.nbytes + lse.nbytes


def test_bound_takes_the_slower_side():
    peak = {"bf16_flops": 1e12, "hbm_bytes": 1e9}
    assert arith.bound_seconds(2e12, 1e9, peak) == 2.0
    assert arith.bound_seconds(1e12, 3e9, peak) == 3.0
