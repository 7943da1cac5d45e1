"""Flash attention: the forward kernel (K1), the backward pair (K2, K3),
their plain PyTorch versions, and the ``autograd.Function`` that joins
them.

Counterpart of ``horovod_tpu/ops/attention.py`` (the flash functions).
Layout convention: ``(batch, heads, seq, head_dim)``, f32 or bf16.  K/V
may carry fewer heads than Q (grouped-query attention): the kernels map
query head ``h`` to kv head ``h // G`` themselves, and the plain
versions expand with :func:`expand_kv` (whose gradient is the per-group
sum, as ``jnp.repeat``'s is).

* :func:`flash_attention`, :func:`flash_attention_with_lse` and
  :func:`flash_attention_shifted` mirror the JAX functions of the same
  names.  All three run one :class:`_FlashAttention`: on CUDA tensors
  the forward launches ``csrc/flash_fwd.cu`` (K1) and the backward
  ``csrc/flash_bwd.cu`` (K2 for dk/dv, K3 for dq); on CPU tensors both
  directions run the plain versions (:func:`_reference_attention_lse`,
  :func:`_flash_bwd_reference`).  A CUDA tensor the kernels do not take
  raises; nothing falls back.
* The mask is a shift: position (row, col) attends iff
  ``col + shift <= row`` (``None`` for no mask, 0 for causal).
* Each launch adds one to its counter (:data:`flash_fwd_launches`,
  :data:`flash_bwd_dkdv_launches`, :data:`flash_bwd_dq_launches`), so a
  run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from horovod_tpu_torch.ops import _cuda
from horovod_tpu_torch.ops._cuda import NEG_INF

__all__ = ["NEG_INF", "expand_kv", "flash_attention",
           "flash_attention_shifted", "flash_attention_with_lse",
           "reference_attention"]

#: Launches of K1 (forward), K2 (dk/dv) and K3 (dq) in this process.
flash_fwd_launches = 0
flash_bwd_dkdv_launches = 0
flash_bwd_dq_launches = 0


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


def _allowed(S, T, shift, device):
    """``(S, T)`` bool: position (row, col) attends iff
    ``col + shift <= row``."""
    rows = torch.arange(S, device=device)[:, None]
    cols = torch.arange(T, device=device)[None, :]
    return cols + shift <= rows


# --- plain versions -----------------------------------------------------------


def _reference_attention_lse(q, k, v, shift, scale):
    """One O(S^2) score computation -> (output, logsumexp).

    ``shift``: None for unmasked, else an int — position (row, col) is
    attended iff ``col + shift <= row`` (0 is standard causal)."""
    scores = torch.einsum("bhsd,bhtd->bhst", q, k).float() * scale
    if shift is not None:
        allowed = _allowed(scores.shape[-2], scores.shape[-1], shift, q.device)
        scores = torch.where(allowed, scores, torch.full_like(scores, NEG_INF))
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


def _bwd_probs(q, k, v, do, lse, delta, shift, scale):
    """What K2 and K3 each recompute from the saved logsumexp, in f32 of
    the rounded operands: ``p = exp(q k^T * scale - lse)`` (0 where
    masked) and ``ds = p * (do v^T - delta) * scale``, with K/V expanded
    to q's heads."""
    H, S, T = q.shape[1], q.shape[2], k.shape[2]
    f = torch.float32
    kf, vf = expand_kv(k, H).to(f), expand_kv(v, H).to(f)
    s = torch.einsum("bhsd,bhtd->bhst", q.to(f), kf) * scale
    p = torch.exp(s - lse[..., None])
    if shift is not None:
        p = torch.where(_allowed(S, T, shift, q.device), p,
                        torch.zeros_like(p))
    dp = torch.einsum("bhsd,bhtd->bhst", do.to(f), vf)
    return p, p * (dp - delta[..., None]) * scale, kf


def _flash_bwd_dkdv_reference(q, k, v, do, lse, delta, shift, scale):
    """Plain version of K2 -> ``(dk, dv)``: p rounded to ``do``'s dtype
    before ``p^T do``, ds to q's before ``ds^T q``, products in f32;
    GQA sums dk/dv over each group in f32 and casts once, as K2 does."""
    B, H, _, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    f = torch.float32
    p, ds, _ = _bwd_probs(q, k, v, do, lse, delta, shift, scale)
    dv = torch.einsum("bhst,bhsd->bhtd", p.to(do.dtype).to(f), do.to(f))
    dk = torch.einsum("bhst,bhsd->bhtd", ds.to(q.dtype).to(f), q.to(f))
    G = H // Hkv
    return (dk.reshape(B, Hkv, G, T, D).sum(2).to(k.dtype),
            dv.reshape(B, Hkv, G, T, D).sum(2).to(v.dtype))


def _flash_bwd_dq_reference(q, k, v, do, lse, delta, shift, scale):
    """Plain version of K3 -> ``dq``: ds rounded to k's dtype before
    ``ds k``, products in f32."""
    _, ds, kf = _bwd_probs(q, k, v, do, lse, delta, shift, scale)
    dq = torch.einsum("bhst,bhtd->bhsd", ds.to(k.dtype).to(torch.float32),
                      kf)
    return dq.to(q.dtype)


def _flash_bwd_reference(q, k, v, do, lse, delta, shift, scale):
    """Plain version of K2 + K3 -> ``(dq, dk, dv)``: the analytic flash
    gradients from the saved logsumexp (the JAX package's blockwise
    fallback, ``_flash_bwd``, in one block) with the kernels' rounding
    points.  ``do`` is in q's dtype; ``delta = rowsum(do * o) - dlse``
    in f32."""
    dk, dv = _flash_bwd_dkdv_reference(q, k, v, do, lse, delta, shift,
                                       scale)
    return (_flash_bwd_dq_reference(q, k, v, do, lse, delta, shift, scale),
            dk, dv)


# --- the kernels --------------------------------------------------------------


def _check_inputs(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B,H,S,D) and k, v (B,H_kv,T,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, S, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[1] != 0:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} "
                         "do not match (batch, head_dim, or H % H_kv)")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash kernels take one dtype of f32/bf16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if D not in (64, 128):
        raise ValueError(f"flash kernels take head_dim 64 or 128, got {D}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash kernels need contiguous q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash kernels need 16-byte aligned q, k, v "
                         "(rows are copied 16 bytes at a time)")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")


def _mask_args(shift, S, T):
    """``(masked, shift)`` for the C entry points; the shift is clamped
    to ``[-T, S]``, which keeps the mask and fits an int."""
    if shift is None:
        return 0, 0
    return 1, max(-T, min(S, int(shift)))


def _bind(lib, name, n_ptr):
    """The C entry point ``name``: ``n_ptr`` pointers, then B, H, H_kv,
    S, T, D, is_bf16, masked, shift, the scale and the stream."""
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _flash_fwd_cuda(q, k, v, shift, scale):
    global flash_fwd_launches
    _check_inputs(q, k, v)
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    lib = _cuda.library("flash_fwd")
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    rc = _bind(lib, "flash_fwd", 5)(
        _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(o),
            _cuda.ptr(lse), B, H, Hkv, S, T, D,
            int(q.dtype == torch.bfloat16), *_mask_args(shift, S, T), scale,
            _cuda.stream(q.device))
    _cuda.check(lib, rc, "flash_fwd launch")
    flash_fwd_launches += 1
    return o, lse


def _bwd_args(q, k, v, do, lse, delta, shift):
    """Checks for K2/K3 -> the loaded library, the six input pointers and
    the int arguments of both entry points."""
    _check_inputs(q, k, v)
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if do.shape != q.shape or do.dtype != q.dtype or not do.is_contiguous() \
            or do.data_ptr() % 16:
        raise ValueError("do must be contiguous and 16-byte aligned, with "
                         "q's shape and dtype")
    if lse.shape != (B, H, S) or delta.shape != (B, H, S) or not (
            lse.dtype == delta.dtype == torch.float32
            and lse.is_contiguous() and delta.is_contiguous()):
        raise ValueError("lse and delta must be contiguous f32 (B, H, S)")
    lib = _cuda.library("flash_bwd")
    ins = [_cuda.ptr(t) for t in (q, k, v, do, lse, delta)]
    dims = (B, H, Hkv, S, T, D, int(q.dtype == torch.bfloat16),
            *_mask_args(shift, S, T))
    return lib, ins, dims


def _flash_bwd_dkdv_cuda(q, k, v, do, lse, delta, shift, scale):
    """K2 on the current stream -> ``(dk, dv)``."""
    global flash_bwd_dkdv_launches
    lib, ins, dims = _bwd_args(q, k, v, do, lse, delta, shift)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = _bind(lib, "flash_bwd_dkdv", 8)(
        *ins, _cuda.ptr(dk), _cuda.ptr(dv), *dims, scale,
        _cuda.stream(q.device))
    _cuda.check(lib, rc, "flash_bwd_dkdv launch")
    flash_bwd_dkdv_launches += 1
    return dk, dv


def _flash_bwd_dq_cuda(q, k, v, do, lse, delta, shift, scale):
    """K3 on the current stream -> ``dq``."""
    global flash_bwd_dq_launches
    lib, ins, dims = _bwd_args(q, k, v, do, lse, delta, shift)
    dq = torch.empty_like(q)
    rc = _bind(lib, "flash_bwd_dq", 7)(*ins, _cuda.ptr(dq), *dims, scale,
                                       _cuda.stream(q.device))
    _cuda.check(lib, rc, "flash_bwd_dq launch")
    flash_bwd_dq_launches += 1
    return dq


# --- autograd ----------------------------------------------------------------


def _forward(q, k, v, shift, scale):
    if q.is_cuda:
        return _flash_fwd_cuda(q, k, v, shift, scale)
    H = q.shape[1]
    return _reference_attention_lse(q, expand_kv(k, H), expand_kv(v, H),
                                    shift, scale)


class _FlashAttention(torch.autograd.Function):
    """``(q, k, v) -> (o, lse)``, both differentiable.  Saves
    ``(q, k, v, o, lse)``; the backward folds the lse cotangent in as
    ``delta -= dlse`` (``d lse_i / d s_ij = p_ij``)."""

    @staticmethod
    def forward(ctx, q, k, v, shift, scale):
        o, lse = _forward(q, k, v, shift, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.shift, ctx.scale = shift, scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        do = torch.zeros_like(o) if do is None else do.to(q.dtype)
        delta = (do.float() * o.float()).sum(-1)
        if dlse is not None:
            delta = delta - dlse.float()
        args = (q, k, v, do.contiguous(), lse, delta, ctx.shift, ctx.scale)
        if q.is_cuda:
            dk, dv = _flash_bwd_dkdv_cuda(*args)
            dq = _flash_bwd_dq_cuda(*args)
        else:
            dq, dk, dv = _flash_bwd_reference(*args)
        return dq, dk, dv, None, None


def flash_attention_with_lse(q, k, v, causal: bool = False,
                             sm_scale: Optional[float] = None):
    """Fused attention -> ``(o, lse)``: ``(B, H, S, D) x (B, H_kv, T, D)
    -> (B, H, S, D), (B, H, S)``, both differentiable.  CUDA tensors run
    the kernels (or the call raises); CPU tensors the plain versions."""
    return _FlashAttention.apply(q, k, v, 0 if causal else None,
                                 _sm_scale(q, sm_scale))


def flash_attention(q, k, v, causal: bool = False,
                    sm_scale: Optional[float] = None):
    """Fused attention output only (see :func:`flash_attention_with_lse`)."""
    return flash_attention_with_lse(q, k, v, causal, sm_scale)[0]


def flash_attention_shifted(q, k, v, shift, sm_scale: Optional[float] = None):
    """Flash attention with a runtime shifted-causal mask -> ``(o, lse)``:
    position (row, col) attends iff ``col + shift <= row``.  ``shift``
    0 is causal, ``<= -T`` attends everything, ``>= S`` masks everything
    (o = 0, lse = NEG_INF)."""
    return _FlashAttention.apply(q, k, v, int(shift), _sm_scale(q, sm_scale))
