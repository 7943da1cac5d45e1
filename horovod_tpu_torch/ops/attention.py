"""Attention for prefill: the flash-attention forward kernel (K1) and its
plain PyTorch version.

Counterpart of ``horovod_tpu/ops/attention.py`` (the parts prefill
needs).  Layout convention: ``(batch, heads, seq, head_dim)``, f32 or
bf16.

* :func:`flash_attention` / :func:`flash_attention_lse` — on a CUDA
  tensor, the hand-written kernel ``csrc/flash_fwd.cu`` (one launch per
  call, counted in :data:`flash_fwd_launches`); on a CPU tensor, the
  plain version :func:`_reference_attention_lse`.  K/V may carry fewer
  heads than Q (grouped-query attention): the kernel maps query head
  ``h`` to kv head ``h // G`` itself, the plain version expands with
  :func:`expand_kv` first.
* Forward only: training (the backward kernels and the
  ``autograd.Function``) comes with a later slice, so a CUDA input that
  requires grad raises ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from horovod_tpu_torch.ops import _cuda
from horovod_tpu_torch.ops._cuda import NEG_INF

__all__ = ["NEG_INF", "expand_kv", "flash_attention", "flash_attention_lse",
           "reference_attention"]

#: Launches of the K1 kernel in this process (a run reads it before and
#: after to prove its main path went through the kernel).
flash_fwd_launches = 0


def _sm_scale(q, sm_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale


def expand_kv(kv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Grouped-query attention: repeat K/V heads up to ``n_heads``
    (``jnp.repeat`` order: kv head ``j`` serves query heads
    ``j*G .. j*G+G-1``)."""
    H_kv = kv.shape[1]
    if H_kv == n_heads:
        return kv
    if n_heads % H_kv != 0:
        raise ValueError(
            f"n_heads ({n_heads}) must be a multiple of kv heads ({H_kv})")
    return torch.repeat_interleave(kv, n_heads // H_kv, dim=1)


def _reference_attention_lse(q, k, v, shift, scale):
    """One O(S^2) score computation -> (output, logsumexp).

    ``shift``: None for unmasked, else an int — position (row, col) is
    attended iff ``col + shift <= row`` (0 is standard causal)."""
    scores = torch.einsum("bhsd,bhtd->bhst", q, k).float() * scale
    if shift is not None:
        S, T = scores.shape[-2], scores.shape[-1]
        rows = torch.arange(S, device=q.device)[:, None]
        cols = torch.arange(T, device=q.device)[None, :]
        scores = torch.where(cols + shift <= rows, scores,
                             torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.where(scores > NEG_INF * 0.5, torch.exp(scores - m),
                    torch.zeros_like(scores))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    o = torch.einsum("bhst,bhtd->bhsd", (p / l_safe).to(v.dtype), v)
    lse = torch.where(l[..., 0] > 0, m[..., 0] + torch.log(l_safe[..., 0]),
                      torch.full_like(l[..., 0], NEG_INF))
    return o, lse


def reference_attention(q, k, v, *, causal: bool = False,
                        sm_scale: Optional[float] = None):
    """O(S^2)-memory oracle; K/V must already have ``H`` heads."""
    o, _ = _reference_attention_lse(q, k, v, 0 if causal else None,
                                    _sm_scale(q, sm_scale))
    return o


def _flash_fwd_cuda(q, k, v, causal: bool, scale: float):
    global flash_fwd_launches
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash_attention backward is not ported yet (the training "
            "slice brings the backward kernels)")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B,H,S,D) and k, v (B,H_kv,T,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % Hkv != 0:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} "
                         "do not match (batch, head_dim, or H % H_kv)")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash kernel takes one dtype of f32/bf16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if D not in (64, 128):
        raise ValueError(f"flash kernel takes head_dim 64 or 128, got {D}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash kernel needs contiguous q, k, v")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    lib = _cuda.library("flash_fwd")
    fn = lib.flash_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    rc = fn(_cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(o),
            _cuda.ptr(lse), B, H, Hkv, S, T, D,
            int(q.dtype == torch.bfloat16), int(causal), scale,
            _cuda.stream(q.device))
    _cuda.check(lib, rc, "flash_fwd launch")
    flash_fwd_launches += 1
    return o, lse


def flash_attention_lse(q, k, v, causal: bool = False,
                        sm_scale: Optional[float] = None):
    """Fused attention -> ``(o, lse)``: ``(B, H, S, D) x (B, H_kv, T, D)
    -> (B, H, S, D), (B, H, S)``.  CUDA tensors run kernel K1 (or the call
    raises); CPU tensors run the plain version."""
    scale = _sm_scale(q, sm_scale)
    if q.is_cuda:
        return _flash_fwd_cuda(q, k, v, causal, scale)
    H = q.shape[1]
    return _reference_attention_lse(q, expand_kv(k, H), expand_kv(v, H),
                                    0 if causal else None, scale)


def flash_attention(q, k, v, causal: bool = False,
                    sm_scale: Optional[float] = None):
    """Fused attention output only (see :func:`flash_attention_lse`)."""
    return flash_attention_lse(q, k, v, causal, sm_scale)[0]
