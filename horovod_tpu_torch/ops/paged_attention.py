"""Paged-attention decode: the hand-written kernel (K4) and its plain
PyTorch version.

Counterpart of ``horovod_tpu/ops/paged_attention.py``.  Decode attention
reads every active slot's K/V straight from the paged pool: each slot's
page-table row names the physical pages, positions ``< limit[s]``
attend, int8 pages are dequantized in the load.  On a CUDA tensor
:func:`paged_attend` launches ``csrc/paged_attention.cu`` (counted in
:data:`paged_attend_launches`); on a CPU tensor it runs
:func:`paged_attend_reference`, the gather -> dequant -> masked softmax
path the unfused decode tick runs.  The JAX package's
``kernel_supported`` gate encoded TPU tiling rules and is not copied; the
CUDA kernel takes any page size and any R, and a head dim that its
16-byte vector loads can cut (a multiple of 8, of 16 for int8 pools, at
most 128): other head dims raise ``ValueError`` on a CUDA tensor.

The kernel is split-K flash-decoding: the slot's page-table entries are
cut into fixed runs (:func:`split_grid`, from the shapes alone, never
from ``limit``), one CTA a run writes a partial softmax state into
scratch allocated here, and a second kernel combines the partials.  The
first kernel is chosen by pool dtype and ``R``: a bf16 pool with ``R >
8`` (the speculative verify's ``G * W`` rows) runs the rows kernel, which
copies each page by TMA once for up to 32 rows and runs the scores and
``p . v`` on the tensor cores; every other call runs the split kernel on
the CUDA cores.
"""

from __future__ import annotations

import ctypes
import math

import torch

from horovod_tpu_torch.ops import _cuda
from horovod_tpu_torch.ops._cuda import NEG_INF

__all__ = ["DEQUANT_COMPUTE", "NEG_INF", "paged_attend",
           "paged_attend_reference", "split_grid"]

#: Calls of K4 (its split and combine kernels, launched together) in
#: this process.
paged_attend_launches = 0
#: The same calls by their query rows a kv head, R (the decode tick's G,
#: the speculative verify's G * W).
paged_attend_launches_by_rows: dict = {}
#: The same calls by the pool's dtype name ("float32", "bfloat16",
#: "int8"): each pool dtype runs its own kernel functions.
paged_attend_launches_by_dtype: dict = {}

# The pinned dequant compute dtype: int8 payloads and their scales
# multiply in f32 — even when the compute dtype is bf16 — and only THEN
# cast to the target dtype.  The kernel's load does the same, so the two
# paths round int8 pages identically.
DEQUANT_COMPUTE = torch.float32


def _dequant(q, scale, dtype):
    """``kv_dequantize``'s contract: f32 multiply, then one cast."""
    return (q.to(DEQUANT_COMPUTE)
            * scale[..., None].to(DEQUANT_COMPUTE)).to(dtype)


def paged_attend_reference(qg, k_pool, v_pool, k_scale, v_scale, table,
                           limit, *, compute_dtype=None):
    """Plain version of :func:`paged_attend`: gather the pages into
    logical order, dequantize, masked softmax — the unfused decode path's
    rounding (stored-dtype products with f32 accumulation, weights
    normalized and then cast to V's dtype)."""
    S, Hkv, R, Dh = qg.shape
    max_pages = table.shape[1]
    ps = k_pool.shape[2]
    if compute_dtype is None:
        compute_dtype = DEQUANT_COMPUTE
    table = table.long()

    def gather(pool_l):                       # (P,Hkv,ps,Dh) -> logical
        g = pool_l[table]                     # (S, max_pages, Hkv, ps, Dh)
        return g.movedim(1, 2).reshape(S, Hkv, max_pages * ps, Dh)

    if k_scale is not None:
        def gather_sc(scale_l):
            g = scale_l[table]
            return g.movedim(1, 2).reshape(S, Hkv, max_pages * ps)

        kg = _dequant(gather(k_pool), gather_sc(k_scale), compute_dtype)
        vg = _dequant(gather(v_pool), gather_sc(v_scale), compute_dtype)
    else:
        kg = gather(k_pool)
        vg = gather(v_pool)
    # Products of stored-dtype values are exact in f32: upcasting both
    # operands is JAX's preferred_element_type=f32 contraction.
    s = torch.einsum("skrd,sktd->skrt", qg.to(kg.dtype).float(),
                     kg.float()) / math.sqrt(Dh)
    T = max_pages * ps
    vis = (torch.arange(T, device=qg.device)[None, :]
           < limit.to(qg.device)[:, None])    # (S, T)
    s = torch.where(vis[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    any_vis = (limit.to(qg.device) > 0)[:, None, None, None]
    p = torch.exp(s - torch.where(any_vis, m, torch.zeros_like(m)))
    l = p.sum(dim=-1, keepdim=True)
    w = torch.where(any_vis, p / l, torch.zeros_like(p))
    o = torch.einsum("skrt,sktd->skrd", w.to(vg.dtype).float(), vg.float())
    lse = torch.where(any_vis[..., 0], m[..., 0] + torch.log(l[..., 0]),
                      torch.full_like(l[..., 0], NEG_INF))
    return o, lse


_POOL_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# CTAs the split kernel aims for: ~4 a streaming multiprocessor of an
# H100 (132), so that every SM keeps several page copies in flight.
SPLIT_TARGET_CTAS = 512
_R_BLOCK = 8  # query rows a CTA of the split kernel when R > 4
_ROWS_BLOCK = 32  # query rows a CTA of the rows kernel (bf16 pools, R > 8)
_PPS_MAX = 1024  # pages a split, at most (their ids sit in shared memory)


def split_grid(S: int, Hkv: int, R: int, max_pages: int, pool_dtype=None):
    """``(pages_per_split, grid)`` of K4's first kernel: ``grid = (S *
    H_kv, n_split, R blocks)``.  A bf16 pool with ``R > 8`` runs the
    tensor-core rows kernel, ``R`` in blocks of 32; every other call the
    split kernel, ``R`` in blocks of 4 or 8 (the C entry point
    ``paged_attend`` makes the same choice).  From the shapes and dtype
    alone — reading ``limit`` on the host would add a device sync to
    every layer."""
    if pool_dtype == torch.bfloat16 and R > _R_BLOCK:
        r_blocks = -(-R // _ROWS_BLOCK)
    else:
        r_blocks = 1 if R <= 4 else -(-R // _R_BLOCK)
    n_split = max(1, min(max_pages,
                         -(-SPLIT_TARGET_CTAS // (S * Hkv * r_blocks))),
                  -(-max_pages // _PPS_MAX))
    pps = -(-max_pages // n_split)
    return pps, (S * Hkv, -(-max_pages // pps), r_blocks)


def _paged_attend_cuda(qg, k_pool, v_pool, k_scale, v_scale, table, limit,
                       compute_dtype):
    global paged_attend_launches
    S, Hkv, R, Dh = qg.shape
    P, Hkv_p, ps, Dh_p = k_pool.shape
    max_pages = table.shape[1]
    if v_pool.shape != k_pool.shape or (Hkv_p, Dh_p) != (Hkv, Dh):
        raise ValueError(f"pool {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} does not match qg "
                         f"{tuple(qg.shape)}")
    if table.shape[0] != S or tuple(limit.shape) != (S,):
        raise ValueError(f"table {tuple(table.shape)} / limit "
                         f"{tuple(limit.shape)} do not match {S} slots")
    kind = _POOL_KIND.get(k_pool.dtype)
    if kind is None or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"pool dtype must be one of f32/bf16/int8, got "
                        f"{k_pool.dtype}/{v_pool.dtype}")
    if table.dtype != torch.int32 or limit.dtype != torch.int32:
        raise TypeError("table and limit must be int32")
    quantized = kind == 2
    if quantized:
        if k_scale is None or v_scale is None:
            raise ValueError("int8 pools need k_scale and v_scale")
        if (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32
                or tuple(k_scale.shape) != (P, Hkv, ps)
                or v_scale.shape != k_scale.shape):
            raise ValueError("scales must be f32 (P, H_kv, page)")
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"int8 pools dequantize to f32 or bf16, not "
                            f"{compute_dtype}")
    step = 16 if quantized else 8
    if Dh % step or Dh > 128:
        raise ValueError(f"the paged kernel takes a head_dim that is a "
                         f"multiple of {step} and at most 128 (16-byte "
                         f"vector loads of {k_pool.dtype} rows), got {Dh}")
    tensors = [qg, k_pool, v_pool, table, limit] + (
        [k_scale, v_scale] if quantized else [])
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("paged kernel needs contiguous inputs")
    if any(t.device != qg.device for t in tensors):
        raise ValueError("paged kernel inputs must be on one device")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged kernel needs 16-byte aligned pools (pages "
                         "are copied 16 bytes at a time)")
    lib = _cuda.library("paged_attention")
    fn = lib.paged_attend
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int])
    # The kernel reads q in f32 or bf16 and rounds it to the compute
    # dtype itself; other dtypes are widened here.
    if qg.dtype not in (torch.float32, torch.bfloat16):
        qg = qg.float()
    o = torch.empty((S, Hkv, R, Dh), dtype=torch.float32, device=qg.device)
    lse = torch.empty((S, Hkv, R), dtype=torch.float32, device=qg.device)
    pps, grid = split_grid(S, Hkv, R, max_pages, k_pool.dtype)
    part = torch.empty(S * Hkv * grid[1] * R * (Dh + 2), dtype=torch.float32,
                       device=qg.device)
    null = ctypes.c_void_p(0)
    rc = fn(_cuda.ptr(qg), _cuda.ptr(k_pool), _cuda.ptr(v_pool),
            _cuda.ptr(k_scale) if quantized else null,
            _cuda.ptr(v_scale) if quantized else null,
            _cuda.ptr(table), _cuda.ptr(limit), _cuda.ptr(o), _cuda.ptr(lse),
            S, Hkv, R, Dh, ps, max_pages, kind,
            int(compute_dtype == torch.bfloat16), math.sqrt(Dh),
            _cuda.stream(qg.device), _cuda.ptr(part), pps,
            int(qg.dtype == torch.bfloat16), P)
    _cuda.check(lib, rc, "paged_attend launch")
    paged_attend_launches += 1
    paged_attend_launches_by_rows[R] = paged_attend_launches_by_rows.get(
        R, 0) + 1
    _cuda.count(paged_attend_launches_by_dtype, k_pool.dtype)
    return o, lse


def paged_attend(qg, k_pool, v_pool, k_scale, v_scale, table, limit, *,
                 compute_dtype=None):
    """Decode attention directly against a paged KV pool.

    Args:
      qg: ``(S, H_kv, R, Dh)`` grouped queries (``R = G`` for a one-token
        decode tick).
      k_pool / v_pool: ONE layer's pool, ``(P, H_kv, page, Dh)`` in the
        stored dtype (f32 / bf16 / int8).
      k_scale / v_scale: ``(P, H_kv, page)`` f32 per-vector scales for
        int8 pools, else ``None``.
      table: ``(S, max_pages)`` int32 physical page ids.
      limit: ``(S,)`` int32 — attend logical positions ``< limit[s]``
        (``0`` masks a slot entirely).
      compute_dtype: dtype int8 pages are dequantized to (the model's
        dtype; f32 when None); unquantized pools compute in their
        stored dtype.

    Returns ``(o, lse)``: ``o`` ``(S, H_kv, R, Dh)`` f32 (zeros for fully
    masked rows), ``lse`` ``(S, H_kv, R)`` f32 (``NEG_INF`` when fully
    masked).  CUDA tensors launch kernel K4 or raise; CPU tensors run
    :func:`paged_attend_reference`.
    """
    if k_scale is None:
        compute_dtype = k_pool.dtype
    elif compute_dtype is None:
        compute_dtype = DEQUANT_COMPUTE
    if qg.is_cuda:
        return _paged_attend_cuda(qg, k_pool, v_pool, k_scale, v_scale,
                                  table, limit, compute_dtype)
    return paged_attend_reference(qg, k_pool, v_pool, k_scale, v_scale,
                                  table, limit, compute_dtype=compute_dtype)
