"""Plain Mistral-style decoder, in float32 PyTorch functions.

Mistral 7B (Jiang et al. 2023, arXiv:2310.06825; the Hugging Face
``MistralForCausalLM``): token embedding; per layer a pre-norm RMSNorm,
grouped-query causal attention with rotary embeddings over the two halves
of each head (``rotate_half``), a residual add, a pre-norm RMSNorm, the
SwiGLU MLP ``down(silu(gate(x)) · up(x))`` and a residual add; a final
RMSNorm and an untied head; the mean next-token cross-entropy.  No
sliding window.  RMSNorm's epsilon is the configuration's
``rms_norm_eps``.

The parameters are a dict in the program's layout, the layers stacked on
a leading axis (``layers.wq`` is ``(L, D, H, Dh)``, applied as ``x @
wq``); :data:`HF_NAMES` maps each to the Hugging Face checkpoint's names.
Attention is computed in blocks of query rows, and each layer is
recomputed in the backward (``torch.utils.checkpoint``), so that a
sequence of 4096 fits in float32.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

#: The program's name -> the Hugging Face name (``{l}``: the layer; the
#: HF matrices are ``(out, in)``, the program's ``(in, heads, head_dim)``
#: or ``(in, out)``).
HF_NAMES = {
    "embed": "model.embed_tokens.weight",
    "layers.ln1": "model.layers.{l}.input_layernorm.weight",
    "layers.wq": "model.layers.{l}.self_attn.q_proj.weight",
    "layers.wk": "model.layers.{l}.self_attn.k_proj.weight",
    "layers.wv": "model.layers.{l}.self_attn.v_proj.weight",
    "layers.wo": "model.layers.{l}.self_attn.o_proj.weight",
    "layers.ln2": "model.layers.{l}.post_attention_layernorm.weight",
    "layers.w_gate": "model.layers.{l}.mlp.gate_proj.weight",
    "layers.w_up": "model.layers.{l}.mlp.up_proj.weight",
    "layers.w_down": "model.layers.{l}.mlp.down_proj.weight",
    "ln_f": "model.norm.weight",
    "head": "lm_head.weight",
}
LAYER_KEYS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w_gate", "w_up",
              "w_down")
#: Query rows a block of the attention.
Q_BLOCK = 512


def shapes(c: Dict) -> Dict[str, tuple]:
    """Every tensor's shape, from the configuration's keys."""
    D, H, Hkv = c["hidden_size"], c["num_attention_heads"], \
        c["num_key_value_heads"]
    Dh, F_, L, V = c.get("head_dim") or D // H, c["intermediate_size"], \
        c["num_hidden_layers"], c["vocab_size"]
    return {"embed": (V, D), "layers.ln1": (L, D),
            "layers.wq": (L, D, H, Dh), "layers.wk": (L, D, Hkv, Dh),
            "layers.wv": (L, D, Hkv, Dh), "layers.wo": (L, H, Dh, D),
            "layers.ln2": (L, D), "layers.w_gate": (L, D, F_),
            "layers.w_up": (L, D, F_), "layers.w_down": (L, F_, D),
            "ln_f": (D,), "head": (D, V)}


def _mm(x, w, prec):
    return prec.result(prec.operand(x) @ prec.operand(w))


def _rmsnorm(x, w, eps, prec):
    return prec.act(x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
                    * w)


def _rope(x, theta):
    """``x`` ``(B, S, H, Dh)``: rotate the halves by position ·
    θ^(-2i/Dh)."""
    B, S, H, Dh = x.shape
    half = Dh // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                       device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _attention(q, k, v, prec):
    """Causal softmax attention of ``(B, H, S, Dh)`` q over ``(B, Hkv, S,
    Dh)`` k, v, kv head ``j`` serving query heads ``j·G .. j·G + G − 1``,
    in blocks of :data:`Q_BLOCK` query rows."""
    H, S, Dh = q.shape[1], q.shape[2], q.shape[3]
    k = k.repeat_interleave(H // k.shape[1], dim=1)
    v = v.repeat_interleave(H // v.shape[1], dim=1)
    scale = 1.0 / math.sqrt(Dh)
    out = []
    for a in range(0, S, Q_BLOCK):
        b = min(a + Q_BLOCK, S)
        s = _mm(q[:, :, a:b], k[:, :, :b].transpose(-1, -2), prec) * scale
        rows = torch.arange(a, b, device=q.device)[:, None]
        cols = torch.arange(b, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, float("-inf"))
        out.append(_mm(torch.softmax(s, dim=-1), v[:, :, :b], prec))
    return torch.cat(out, dim=2)


def _layer(x, c, prec, *w):
    ln1, wq, wk, wv, wo, ln2, wg, wu, wd = w
    B, S, D = x.shape
    h = _rmsnorm(x, ln1, c["rms_norm_eps"], prec)
    q = _mm(h, wq.flatten(1), prec).view(B, S, wq.shape[1], wq.shape[2])
    k = _mm(h, wk.flatten(1), prec).view(B, S, wk.shape[1], wk.shape[2])
    v = _mm(h, wv.flatten(1), prec).view(B, S, wv.shape[1], wv.shape[2])
    q = prec.act(_rope(q, c["rope_theta"]))
    k = prec.act(_rope(k, c["rope_theta"]))
    o = _attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                   prec)
    x = prec.act(x + _mm(o.transpose(1, 2).reshape(B, S, -1),
                         wo.flatten(0, 1), prec))
    h = _rmsnorm(x, ln2, c["rms_norm_eps"], prec)
    m = prec.act(F.silu(_mm(h, wg, prec)) * _mm(h, wu, prec))
    return prec.act(x + _mm(m, wd, prec))


def loss(p: Dict[str, torch.Tensor], tokens, targets, c: Dict, prec,
         recompute: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy of ``tokens`` ``(B, S)`` against
    ``targets``."""
    x = prec.act(p["embed"][tokens.long()])
    for l in range(c["num_hidden_layers"]):
        w = [p[f"layers.{k}"][l] for k in LAYER_KEYS]
        x = checkpoint(_layer, x, c, prec, *w, use_reentrant=False) \
            if recompute else _layer(x, c, prec, *w)
    logits = _mm(_rmsnorm(x, p["ln_f"], c["rms_norm_eps"], prec), p["head"],
                 prec)
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).mean()
