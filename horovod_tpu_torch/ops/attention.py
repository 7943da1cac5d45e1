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
  ``col + shift <= row`` (``None`` for no mask, 0 for causal).  The
  forward also takes the shift as a 0-dim int32 tensor on q's device,
  which K1 reads from device memory (a CUDA graph bakes an int into the
  launch; a tensor it reads by address).
* Each launch adds one to its counter (:data:`flash_fwd_launches`,
  :data:`flash_bwd_dkdv_launches`, :data:`flash_bwd_dq_launches`), so a
  run can show that its main path went through the kernels, and one to
  the same kernel's count for its dtype (``*_launches_by_dtype``: f32
  and bf16 run different kernel functions).
* Sequence parallelism over a process group, as the JAX functions of
  the same names compute it under ``shard_map``: :func:`ring_attention`
  and :func:`zigzag_ring_attention` (K/V shards passed around the ring
  point to point, each chunk one :class:`_FlashAttention` call with the
  ring's shift, merged by logsumexp in f32) and
  :func:`ulysses_attention` (all-to-all to a head subset over the whole
  sequence and back).  :func:`_virtual_ring` runs the ring's step body
  for every rank in one process, the exchange a list rotation.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch.basics import resolve_device
from horovod_tpu_torch.ops import _cuda
from horovod_tpu_torch.ops._cuda import NEG_INF
from horovod_tpu_torch.ops.moe import _all_to_all

__all__ = ["NEG_INF", "expand_kv", "flash_attention",
           "flash_attention_shifted", "flash_attention_with_lse",
           "reference_attention", "ring_attention", "ulysses_attention",
           "zigzag_perm", "zigzag_positions", "zigzag_ring_attention"]

#: Launches of K1 (forward), K2 (dk/dv) and K3 (dq) in this process.
flash_fwd_launches = 0
flash_bwd_dkdv_launches = 0
flash_bwd_dq_launches = 0
#: The same launches by dtype name ("float32", "bfloat16").
flash_fwd_launches_by_dtype: dict = {}
flash_bwd_dkdv_launches_by_dtype: dict = {}
flash_bwd_dq_launches_by_dtype: dict = {}


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

    ``shift``: None for unmasked, else an int or a 0-dim integer tensor
    on q's device (never read back to the host) — position (row, col) is
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
    # The bf16 kernels' tensor maps (TMA) need, beyond that alignment and
    # rows of D * 2 = 128 or 256 bytes, a head's stride under 2^40 bytes.
    if max(S, k.shape[2]) * D * q.element_size() >= 1 << 40:
        raise ValueError(f"flash kernels take a head of under 2^40 bytes, "
                         f"got {max(S, k.shape[2])} rows of {D}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")


def _mask_args(shift, S, T):
    """``(masked, shift)`` for the C entry points; the shift is clamped
    to ``[-T, S]``, which keeps the mask and fits an int.  (A tensor
    shift is read back here: the backward pair takes it by value.)"""
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


def _bind_fwd(lib):
    """K1's entry point ``flash_fwd``: :func:`_bind`'s arguments, then
    the device shift's pointer (None: the by-value shift)."""
    fn = _bind(lib, "flash_fwd", 5)
    fn.argtypes = fn.argtypes + [ctypes.c_void_p]
    return fn


def _device_shift(shift, q):
    """The pointer K1 reads a tensor shift from, or None for an int (or
    no) shift.  A tensor must be a 0-dim int32 on q's device."""
    if not isinstance(shift, torch.Tensor):
        return None
    if shift.dim() != 0 or shift.dtype != torch.int32 \
            or shift.device != q.device:
        raise ValueError(f"a tensor shift must be a 0-dim int32 on "
                         f"{q.device}, got {tuple(shift.shape)} "
                         f"{shift.dtype} on {shift.device}")
    return _cuda.ptr(shift)


def _flash_fwd_cuda(q, k, v, shift, scale):
    global flash_fwd_launches
    _check_inputs(q, k, v)
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    shift_dev = _device_shift(shift, q)
    mask = (1, 0) if shift_dev is not None else _mask_args(shift, S, T)
    lib = _cuda.library("flash_fwd")
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    rc = _bind_fwd(lib)(
        _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(o),
        _cuda.ptr(lse), B, H, Hkv, S, T, D, int(q.dtype == torch.bfloat16),
        *mask, scale, _cuda.stream(q.device), shift_dev)
    _cuda.check(lib, rc, "flash_fwd launch")
    flash_fwd_launches += 1
    _cuda.count(flash_fwd_launches_by_dtype, q.dtype)
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
    _cuda.count(flash_bwd_dkdv_launches_by_dtype, q.dtype)
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
    _cuda.count(flash_bwd_dq_launches_by_dtype, q.dtype)
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
    (o = 0, lse = NEG_INF).  ``shift`` is an int, or a 0-dim int32 tensor
    on q's device: K1 then reads it from device memory (a CUDA graph
    replays with whatever it holds), and the plain version uses it as a
    tensor; neither reads it back to the host."""
    if not isinstance(shift, torch.Tensor):
        shift = int(shift)
    return _FlashAttention.apply(q, k, v, shift, _sm_scale(q, sm_scale))


# --- sequence parallelism: ring, zigzag ring and Ulysses ----------------------


def _chunk_attn(q, k, v, mask, scale):
    """Attention of local q over one K/V chunk with a bool mask (True =
    allowed) in f32 -> the chunk's normalised output and logsumexp (the
    ring's ``impl="reference"`` chunk; K/V expanded to q's heads)."""
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    o = torch.einsum("bhst,bhtd->bhsd", p / l_safe, v.float())
    return o, (m + torch.log(l_safe))[..., 0]


def _chunk(q, k, v, shift, scale, impl):
    """``(o, lse)``, both f32, of q over one K/V chunk; ``shift`` None
    attends everything, an int masks as :func:`flash_attention_shifted`
    does.  ``flash``: one :class:`_FlashAttention` call (K1 forward, K2
    and K3 backward on CUDA) on the unexpanded K/V, the operands made
    contiguous (the kernels take no strided view; the copy's gradient
    flows back into the slice); ``reference``: :func:`_chunk_attn`."""
    if impl == "flash":
        o, lse = _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                       v.contiguous(), shift, scale)
        return o.float(), lse
    H = q.shape[1]
    mask = None if shift is None else _allowed(
        q.shape[2], k.shape[2], shift, q.device)[None, None]
    return _chunk_attn(q, expand_kv(k, H), expand_kv(v, H), mask, scale)


def _merge(acc, o_c, lse_c):
    """Fold one chunk's ``(o, lse)`` into the running ``(o, lse)`` by
    logsumexp, in f32."""
    o, lse = acc
    lse_new = torch.logaddexp(lse, lse_c)
    return (o * torch.exp(lse - lse_new)[..., None]
            + o_c * torch.exp(lse_c - lse_new)[..., None]), lse_new


def _ring_blocks(me, src, P, n, causal, zigzag):
    """The chunk calls of rank ``me`` at the step it holds rank ``src``'s
    K/V: ``(q part, K/V part, shift)``, the parts 0 for the whole shard,
    or 0/1 for the early/late half in the zigzag layout; ``n`` is the
    shard length.

    The ring: one call, the globally causal mask restricted to the
    ``(me, src)`` shard pair being the shifted mask ``(src - me) * n``
    (earlier shards wholly visible, the diagonal causal, later shards
    wholly masked: o = 0, lse = NEG_INF, which the merge annihilates).
    The zigzag layout (rank i holds global chunks i and 2P-1-i, each
    ``n/2`` long): three calls, ``q_early x k_late`` being masked for
    every pair and never issued."""
    if not zigzag:
        return [(0, 0, (src - me) * n if causal else None)]
    c = n // 2
    my_b, src_b = 2 * P - 1 - me, 2 * P - 1 - src
    return [(0, 0, (src - me) * c),       # alive iff src <= me
            (1, 0, (src - my_b) * c),     # always wholly visible
            (1, 1, (src_b - my_b) * c)]   # alive iff src >= me


def _ring_pass(qs, ks, vs, ranks, P, exchange, *, causal, zigzag, scale,
               impl):
    """The ring's P steps for the ranks this process holds: ``qs[i]``,
    ``ks[i]``, ``vs[i]`` are rank ``ranks[i]``'s shards.  At each step
    every held rank runs its chunk calls (:func:`_ring_blocks`) on the
    K/V it holds and merges them; then ``exchange(ks, vs)`` passes every
    K/V shard on to the next rank (rank r then holds what r - 1 held),
    except after the last step, whose rotation would never be read.
    A real ring holds one rank and exchanges over its process group
    (:class:`_PPermute`); the virtual ring (:func:`_virtual_ring`) holds
    all P and rotates its list."""
    n = ks[0].shape[2]

    def split(t):  # the whole shard, or its early and late halves
        if not zigzag:
            return [t]
        return [t[:, :, :n // 2].contiguous(), t[:, :, n // 2:].contiguous()]

    def empty(q):
        return (torch.zeros(q.shape, dtype=torch.float32, device=q.device),
                torch.full(q.shape[:3], NEG_INF, dtype=torch.float32,
                           device=q.device))

    q_parts = [split(q) for q in qs]
    acc = [[empty(q) for q in parts] for parts in q_parts]
    for s in range(P):
        for i, me in enumerate(ranks):
            src = (me - s) % P
            k_parts, v_parts = split(ks[i]), split(vs[i])
            for qi, kvi, shift in _ring_blocks(me, src, P, n, causal,
                                               zigzag):
                acc[i][qi] = _merge(acc[i][qi], *_chunk(
                    q_parts[i][qi], k_parts[kvi], v_parts[kvi], shift,
                    scale, impl))
        if s < P - 1:
            ks, vs = exchange(ks, vs)
    return [(torch.cat([o for o, _ in a], dim=2) if zigzag else a[0][0])
            .to(q.dtype) for a, q in zip(acc, qs)]


class _PPermute(torch.autograd.Function):
    """``lax.ppermute`` with ``perm = [(i, (i + 1) % P)]`` over a process
    group, for any number of tensors in one ``batch_isend_irecv``: each
    is sent to rank ``(r + 1) % P`` and replaced by the one received from
    ``(r - 1) % P``.  The backward runs the reverse permutation (the
    transpose of a permutation)."""

    @staticmethod
    def _shift(group, ts, step):
        r, P = dist.get_rank(group), dist.get_world_size(group)
        to = dist.get_global_rank(group, (r + step) % P)
        frm = dist.get_global_rank(group, (r - step) % P)
        ts = [t.contiguous() for t in ts]
        outs = [torch.empty_like(t) for t in ts]
        ops = [dist.P2POp(dist.isend, t, to, group) for t in ts]
        ops += [dist.P2POp(dist.irecv, o, frm, group) for o in outs]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return outs

    @staticmethod
    def forward(ctx, group, *ts):
        ctx.group = group
        return tuple(_PPermute._shift(group, ts, 1))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_PPermute._shift(ctx.group, grads, -1))


def _group_exchange(group):
    """The real ring's exchange: this rank's K and V shards to the next
    rank of ``group``, one ``batch_isend_irecv``."""
    def exchange(ks, vs):
        k, v = _PPermute.apply(group, ks[0], vs[0])
        return [k], [v]
    return exchange


def _rotate(ks, vs):
    """The virtual ring's exchange: rank r takes what rank r - 1 held.
    Each shard passes through a view, so that, as after a real exchange,
    every step's K/V is a tensor of its own whose gradient sums that
    step's chunk and the later steps' (the same additions, in the same
    order, as the real ring's backward)."""
    def turn(ts):
        return [t.view_as(t) for t in ts[-1:] + ts[:-1]]
    return turn(ks), turn(vs)


def _check_impl(impl):
    if impl not in ("flash", "reference"):
        raise ValueError(f"unknown impl {impl!r}; expected 'flash' or "
                         "'reference'")


def _virtual_ring(qs, ks, vs, *, causal: bool = False, zigzag: bool = False,
                  sm_scale: Optional[float] = None, impl: str = "flash"):
    """Every rank of a P-rank ring in this process (P = ``len(qs)``):
    ``qs[r]``, ``ks[r]``, ``vs[r]`` are rank r's shards, the exchange a
    rotation of the list, the step body :func:`ring_attention`'s (or, with
    ``zigzag``, :func:`zigzag_ring_attention`'s, ``causal`` implied) ->
    every rank's output.  One card runs every chunk call of the ring at
    P > 1 this way, and the tests hold it to the ring over a process
    group bit for bit."""
    _check_impl(impl)
    P = len(qs)
    if zigzag and qs[0].shape[2] % 2:
        raise ValueError("zigzag shard length must be even (two chunks)")
    return _ring_pass(list(qs), list(ks), list(vs), list(range(P)), P,
                      _rotate, causal=causal or zigzag, zigzag=zigzag,
                      scale=_sm_scale(qs[0], sm_scale), impl=impl)


def ring_attention(q, k, v, *, group, causal: bool = False,
                   sm_scale: Optional[float] = None, impl: str = "flash"):
    """Sequence-parallel attention over the ranks of ``group``: every rank
    holds a contiguous sequence shard of q ``(B, H, S, D)`` and k/v
    ``(B, H_kv, T, D)`` (``H % H_kv == 0``), and the K/V shards rotate
    around the ring (:class:`_PPermute`, point-to-point) while each
    step's chunk attention merges by logsumexp in f32.

    ``impl="flash"``: each chunk is one call of the flash kernels (K1
    forward, K2/K3 backward on CUDA) with the shift ``(src - me) * T``
    (a Python int: the rank is known on the host), on the unexpanded
    K/V; ``"reference"``: the masked f32 chunk (:func:`_chunk_attn`) on
    K/V expanded to H heads.  The rotating shards keep H_kv heads.
    Differentiable; the backward rides the reverse permutation back
    around the ring.  P = 1 exchanges nothing."""
    _check_impl(impl)
    return _ring_pass([q], [k], [v], [dist.get_rank(group)],
                      dist.get_world_size(group), _group_exchange(group),
                      causal=causal, zigzag=False,
                      scale=_sm_scale(q, sm_scale), impl=impl)[0]


def zigzag_perm(S: int, P: int):
    """Column permutation mapping a contiguous global sequence to the
    zigzag layout: rank i holds global chunks ``(i, 2P-1-i)`` of size
    ``S/(2P)``.  Returns (perm, inv): permute data columns by ``perm``
    before sharding contiguously; ``inv`` restores the original order."""
    if S % (2 * P):
        raise ValueError(f"sequence {S} must divide into 2*{P} chunks")
    Sc = S // (2 * P)
    idx = np.arange(S).reshape(2 * P, Sc)
    perm = np.concatenate(
        [np.concatenate([idx[i], idx[2 * P - 1 - i]]) for i in range(P)])
    return perm, np.argsort(perm)


def _zigzag_positions(S_local: int, me: int, P: int, device):
    """f32 global positions of rank ``me``'s zigzag rows."""
    Sc = S_local // 2
    ar = torch.arange(Sc, dtype=torch.float32, device=device)
    return torch.cat([me * Sc + ar, (2 * P - 1 - me) * Sc + ar])


def zigzag_positions(S_local: int, group, *, device=None):
    """Global position ids of this rank's zigzag rows (feed to RoPE):
    ``[me*Sc + 0..Sc-1, (2P-1-me)*Sc + 0..Sc-1]``, f32, on ``device``
    (CUDA unless the caller passes ``"cpu"``)."""
    return _zigzag_positions(S_local, dist.get_rank(group),
                             dist.get_world_size(group),
                             resolve_device(device))


def zigzag_ring_attention(q, k, v, *, group, sm_scale: Optional[float] = None,
                          impl: str = "flash"):
    """Causal ring attention with the zigzag layout (rows permuted by
    :func:`zigzag_perm`, RoPE positions from :func:`zigzag_positions`):
    rank i holds global chunks ``i`` and ``2P-1-i``, so every rank has
    the same causal work at every step.  Each step issues three chunk
    calls (:func:`_ring_blocks`), on the halves of q and of the K/V
    shard it holds; ``q_early x k_late`` is masked for every pair and
    never issued.  Otherwise as :func:`ring_attention`."""
    _check_impl(impl)
    if q.shape[2] % 2:
        raise ValueError("zigzag shard length must be even (two chunks)")
    return _ring_pass([q], [k], [v], [dist.get_rank(group)],
                      dist.get_world_size(group), _group_exchange(group),
                      causal=True, zigzag=True,
                      scale=_sm_scale(q, sm_scale), impl=impl)[0]


def _seq_to_heads(x, group, P):
    """``(B, h, S, D)`` sequence shards -> ``(B, h/P, P*S, D)``: rank j
    gets head block j of every rank, concatenated along the sequence in
    rank order (``lax.all_to_all(split_axis=1, concat_axis=2,
    tiled=True)``)."""
    B, h, S, D = x.shape
    t = _all_to_all(x.reshape(B, P, h // P, S, D).transpose(0, 1), group)
    return t.permute(1, 2, 0, 3, 4).reshape(B, h // P, P * S, D)


def _heads_to_seq(x, group, P):
    """The inverse: ``(B, h/P, P*S, D)`` -> ``(B, h, S, D)``, rank j
    getting sequence block j, heads concatenated in rank order."""
    B, hp, SG, D = x.shape
    S = SG // P
    t = _all_to_all(x.reshape(B, hp, P, S, D).permute(2, 0, 1, 3, 4), group)
    return t.transpose(0, 1).reshape(B, P * hp, S, D)


def ulysses_attention(q, k, v, *, group, causal: bool = False,
                      sm_scale: Optional[float] = None, impl: str = "flash"):
    """All-to-all sequence parallelism over ``group`` (the
    DeepSpeed-Ulysses pattern): every rank holds a sequence shard ``(B,
    H, S, D)``; one ``all_to_all_single`` redistributes to ``(B, H/P,
    P*S, D)`` (the whole sequence, a head subset), local attention runs
    (``flash``: K1-K3; ``reference``: the plain softmax), and the inverse
    exchange restores the sequence shards.  Needs ``H % P == 0``.  GQA:
    K/V are resharded at their own head count when it divides P (the
    kernels map the heads; the plain version expands after), otherwise
    expanded to H heads first.  The collective runs at every size, P = 1
    included.  Differentiable (the exchange's backward is the reverse
    exchange)."""
    _check_impl(impl)
    P = dist.get_world_size(group)
    H = q.shape[1]
    if H % P != 0:
        from horovod_tpu_torch.parallel.meshes import axis_name_of

        name = axis_name_of(group) or "group"
        raise ValueError(
            f"ulysses_attention needs heads ({H}) divisible by the "
            f"'{name}' axis size ({P}); use ring_attention otherwise")
    if k.shape[1] % P == 0:
        kh, vh = _seq_to_heads(k, group, P), _seq_to_heads(v, group, P)
    else:
        kh = _seq_to_heads(expand_kv(k, H), group, P)
        vh = _seq_to_heads(expand_kv(v, H), group, P)
    qh = _seq_to_heads(q, group, P)
    if impl == "flash":
        oh = flash_attention(qh, kh, vh, causal, sm_scale=sm_scale)
    else:
        oh = reference_attention(qh, expand_kv(kh, H // P),
                                 expand_kv(vh, H // P), causal=causal,
                                 sm_scale=sm_scale)
    return _heads_to_seq(oh, group, P)
