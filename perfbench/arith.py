"""The benchmark's frozen yardstick: operations and bytes of the work a cell
asks for, counted from its configuration and shapes alone.

Nothing here reads the program.  The counts are the benchmark's, so that a
change to the program cannot move the measure it is judged by:

* :func:`resnet_train_flops_per_image`: convolutions and the classifier's
  matrix product, forward and backward, two operations a multiply-add (the
  count ``torch.utils.flop_counter.FlopCounterMode`` gives on the plain
  reference; BatchNorm, pooling and the optimizer are not counted).  The
  stem's input needs no gradient, so its backward is the weight gradient
  alone.
* :func:`lm_matmul_params` and :func:`lm_train_flops_per_token`: the
  decoder's model FLOPs, 6 a matrix parameter a token (the embedding is a
  lookup, the head a product) plus causal attention at 6 · layers ·
  sequence · width a token (half of the full score and value products,
  three times for forward and backward).
* :func:`attention_fwd` and :func:`attention_bwd`: the work of one causal
  grouped-query attention call and of its backward, for a kernel's share
  of its roofline.  Operations count every (query, key) pair the mask
  keeps; bytes count each input read once and each output written once.
"""

from __future__ import annotations

from typing import Dict, List, Tuple


def _same_out(n: int, stride: int) -> int:
    return -(-n // stride)


def resnet_convs(config: Dict) -> List[Tuple[str, int, int, int, int, int]]:
    """``(name, k, c_in, c_out, out_h, out_w)`` of every convolution of a
    bottleneck ResNet (v1.5: the stride on the 3×3), in forward order."""
    size = config["image_size"]
    f0 = config["num_filters"]
    # The 7×7/2 stem padded 3, then the 3×3/2 max pool padded 1.
    stem = (size + 6 - 7) // 2 + 1
    out = [("stem", 7, 3, f0, stem, stem)]
    res = (stem + 2 - 3) // 2 + 1
    c_in = f0
    for i, blocks in enumerate(config["stage_sizes"]):
        f = f0 * 2 ** i
        for j in range(blocks):
            s = 2 if i > 0 and j == 0 else 1
            r_out = _same_out(res, s)
            out.append((f"s{i}b{j}.conv0", 1, c_in, f, res, res))
            out.append((f"s{i}b{j}.conv1", 3, f, f, r_out, r_out))
            out.append((f"s{i}b{j}.conv2", 1, f, 4 * f, r_out, r_out))
            if s != 1 or c_in != 4 * f:
                out.append((f"s{i}b{j}.proj", 1, c_in, 4 * f, r_out, r_out))
            c_in, res = 4 * f, r_out
    return out


def resnet_forward_flops_per_image(config: Dict) -> float:
    convs = resnet_convs(config)
    total = sum(2 * k * k * ci * co * h * w for _, k, ci, co, h, w in convs)
    width = convs[-1][3]
    return float(total + 2 * width * config["num_classes"])


def resnet_train_flops_per_image(config: Dict) -> float:
    """Forward, then the input and weight gradients of every product, less
    the stem's input gradient."""
    _, k, ci, co, h, w = resnet_convs(config)[0]
    stem_dgrad = 2.0 * k * k * ci * co * h * w
    return 3 * resnet_forward_flops_per_image(config) - stem_dgrad


def lm_dims(config: Dict) -> Dict[str, int]:
    """The decoder's sizes under short names, from a configuration in the
    Hugging Face ``config.json`` keys."""
    d = config["hidden_size"]
    h = config["num_attention_heads"]
    return {"D": d, "H": h, "Hkv": config["num_key_value_heads"],
            "Dh": config.get("head_dim") or d // h,
            "F": config["intermediate_size"],
            "L": config["num_hidden_layers"], "V": config["vocab_size"]}


def lm_matmul_params(config: Dict) -> int:
    """Parameters that take part in matrix products: the attention and MLP
    projections of every layer and the untied head (not the embedding)."""
    s = lm_dims(config)
    attn = s["D"] * s["H"] * s["Dh"] * 2 + s["D"] * s["Hkv"] * s["Dh"] * 2
    return s["L"] * (attn + 3 * s["D"] * s["F"]) + s["D"] * s["V"]


def lm_train_flops_per_token(config: Dict, seq: int) -> float:
    s = lm_dims(config)
    attention = 6.0 * s["L"] * seq * s["H"] * s["Dh"]
    return 6.0 * lm_matmul_params(config) + attention


def causal_pairs(S: int) -> int:
    """(query, key) pairs a causal mask keeps over S positions, query ``i``
    seeing keys ``0 .. i``."""
    return S * (S + 1) // 2


def _attn_shapes(B, H, Hkv, S, D, elt):
    q = B * H * S * D * elt
    kv = B * Hkv * S * D * elt
    lse = B * H * S * 4
    return q, kv, lse


def attention_fwd(B: int, H: int, Hkv: int, S: int, D: int,
                  elt: int = 2) -> Tuple[float, float]:
    """``(flops, bytes)`` of causal attention forward: S = Q K^T and O = P V
    over the kept pairs; reads q, k, v, writes o and the f32 logsumexp."""
    q, kv, lse = _attn_shapes(B, H, Hkv, S, D, elt)
    return 4.0 * D * causal_pairs(S) * B * H, float(q + 2 * kv + q + lse)


def attention_bwd(B: int, H: int, Hkv: int, S: int, D: int,
                  elt: int = 2) -> Tuple[float, float]:
    """``(flops, bytes)`` of its backward from (q, k, v, o, dO, lse): the
    scores again, dP = dO V^T, dV = P^T dO, dQ = dS K, dK = dS^T Q over the
    kept pairs; reads q, k, v, o, dO and the logsumexp, writes dq, dk,
    dv."""
    q, kv, lse = _attn_shapes(B, H, Hkv, S, D, elt)
    reads = 3 * q + 2 * kv + lse
    writes = q + 2 * kv
    return 10.0 * D * causal_pairs(S) * B * H, float(reads + writes)


def bound_seconds(flops: float, nbytes: float, peak: Dict) -> float:
    """The least time the card could take: the larger of operations over
    its peak rate and bytes over its memory bandwidth."""
    return max(flops / peak["bf16_flops"], nbytes / peak["hbm_bytes"])

