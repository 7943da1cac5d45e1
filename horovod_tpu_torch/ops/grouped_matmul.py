"""The grouped (ragged) matrix products of the dropless MoE dispatch:
kernels G1 and G2 (``csrc/grouped_matmul.cu``), their plain PyTorch
versions, and the wrappers that choose between them.

No Pallas original: the counterpart of ``lax.ragged_dot(xs, W,
counts)``, an XLA op, which ``horovod_tpu/ops/moe.py`` ``dropless_moe``
calls for the experts' three products, and of its VJP.  ``out[t] = xs[t]
@ W[g(t)]`` with the rows of ``xs`` sorted by group and the groups given
as ``offsets``, the cumsum of the group sizes with a leading 0, an ``(E
+ 1,)`` int32 tensor on ``xs``'s device.  The kernels read the offsets
from device memory, so one launch (and one CUDA graph) serves every
routing: nothing is read back to the host.  PyTorch has no public
grouped product that takes its offsets from the device.

* :func:`grouped_matmul`: a CUDA tensor launches G1 (f32 or bf16, f32
  accumulation, output in the input dtype) or raises — a bad dtype,
  shape, contiguity or alignment, a failed build, a failed launch;
  nothing falls back.  A CPU tensor runs
  :func:`grouped_matmul_reference`.
* Its backward, on CUDA: ``dx = dy @ W[g(t)]^T`` is G1 again, with W
  read transposed (:func:`grouped_matmul_dx`), and ``dW[e] = xs_e^T
  dy_e`` is G2 (:func:`grouped_matmul_dw`), each only where autograd
  needs it; no host read, so a train step captures it.  The plain
  versions (:func:`grouped_matmul_dx_reference`,
  :func:`grouped_matmul_dw_reference`) are what the CPU tests hold to
  JAX's VJP; on the CPU autograd differentiates the plain forward.
* :data:`grouped_matmul_launches` counts G1's launches (both modes),
  :data:`grouped_matmul_dw_launches` G2's; ``*_launches_by_dtype`` the
  same by dtype (f32 and bf16 run different kernel functions).
"""

from __future__ import annotations

import ctypes

import torch

from horovod_tpu_torch.ops import _cuda

__all__ = ["MAX_GROUPS", "grouped_matmul", "grouped_matmul_dw",
           "grouped_matmul_dw_reference", "grouped_matmul_dx",
           "grouped_matmul_dx_reference", "grouped_matmul_reference",
           "group_offsets"]

#: Launches of G1 (forward and transposed) in this process.
grouped_matmul_launches = 0
#: Launches of G2 in this process.
grouped_matmul_dw_launches = 0
#: The same launches by dtype name ("float32", "bfloat16").
grouped_matmul_launches_by_dtype: dict = {}
grouped_matmul_dw_launches_by_dtype: dict = {}

#: The most groups (experts) G1 and G2 take: a CTA walks the offsets.
MAX_GROUPS = 64


def group_offsets(sorted_groups: torch.Tensor, n_groups: int) -> torch.Tensor:
    """``(E + 1,)`` int32 offsets of the runs of ``sorted_groups`` (a
    sorted integer vector of group ids): ``searchsorted`` of ``0..E``,
    on the device, as the JAX package counts its group sizes."""
    eye = torch.arange(n_groups + 1, dtype=sorted_groups.dtype,
                       device=sorted_groups.device)
    return torch.searchsorted(sorted_groups, eye).to(torch.int32)


def _group_masks(T: int, offsets, device):
    """``mask_e`` for each group: the rows ``offsets[e] <= t <
    offsets[e + 1]``, compared on the device."""
    rows = torch.arange(T, device=device)
    return [(rows >= offsets[e]) & (rows < offsets[e + 1])
            for e in range(offsets.shape[0] - 1)]


def grouped_matmul_reference(xs, w, offsets):
    """Plain version: ``Σ_e mask_e · (xs @ W[e])``, taken with ``where``
    (the masked dense formulation of JAX's CPU lowering of
    ``ragged_dot``): exact, and no host read.  Rows outside every group
    are zero."""
    out = torch.zeros((xs.shape[0], w.shape[2]), dtype=xs.dtype,
                      device=xs.device)
    for e, mask in enumerate(_group_masks(xs.shape[0], offsets, xs.device)):
        out = torch.where(mask[:, None], xs @ w[e], out)
    return out


def grouped_matmul_dx_reference(dy, w, offsets):
    """Plain version of the input's gradient: the forward's plain version
    on ``W[e]^T`` (``dy (T, N)``, ``w (E, K, N)`` -> ``(T, K)``)."""
    return grouped_matmul_reference(dy, w.transpose(1, 2), offsets)


def grouped_matmul_dw_reference(xs, dy, offsets):
    """Plain version of the weights' gradient: ``dW[e] = (mask_e · xs)^T
    @ dy``, one masked product a group (``xs (T, K)``, ``dy (T, N)`` ->
    ``(E, K, N)``): exact, and no host read.  Rows outside every group
    contribute nothing; an empty group's gradient is zero."""
    zero = torch.zeros((), dtype=xs.dtype, device=xs.device)
    return torch.stack([torch.where(mask[:, None], xs, zero).t() @ dy
                        for mask in _group_masks(xs.shape[0], offsets,
                                                 xs.device)])


def _check_common(a, offsets, E):
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"grouped_matmul takes f32 or bf16, got {a.dtype}")
    if offsets.shape != (E + 1,) or offsets.dtype != torch.int32:
        raise ValueError(f"offsets must be ({E + 1},) int32, got "
                         f"{tuple(offsets.shape)} {offsets.dtype}")
    if not 1 <= E <= MAX_GROUPS:
        raise ValueError(f"grouped_matmul takes 1..{MAX_GROUPS} groups, "
                         f"got {E}")


def _check_operands(a, b, offsets):
    if b.dtype != a.dtype:
        raise TypeError(f"grouped_matmul takes one dtype of f32/bf16, got "
                        f"{a.dtype}, {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()
            and offsets.is_contiguous()):
        raise ValueError("grouped_matmul needs contiguous operands and "
                         "offsets")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("grouped_matmul needs 16-byte aligned operands "
                         "(rows are copied 16 bytes at a time)")
    if not (a.device == b.device == offsets.device):
        raise ValueError("operands and offsets must be on one device")


def _check(xs, w, offsets, transpose_w: bool = False):
    """G1's operands: ``xs (T, K)`` and ``w (E, K, N)``, or with
    ``transpose_w`` ``xs (T, N)`` (the output's gradient)."""
    if xs.dim() != 2 or w.dim() != 3 or \
            w.shape[2 if transpose_w else 1] != xs.shape[1]:
        want = "(T, N) and w (E, K, N)" if transpose_w else \
            "(T, K) and w (E, K, N)"
        raise ValueError(f"need xs {want}; got {tuple(xs.shape)}, "
                         f"{tuple(w.shape)}")
    T = xs.shape[0]
    E, K, N = w.shape
    _check_common(xs, offsets, E)
    if K % 8 or N % 8 or T < 1:
        raise ValueError(f"grouped_matmul needs K and N multiples of 8 and "
                         f"T >= 1, got T={T} K={K} N={N}")
    _check_operands(xs, w, offsets)


def _check_dw(xs, dy, offsets):
    """G2's operands: ``xs (T, K)``, ``dy (T, N)``, ``E + 1`` offsets."""
    if xs.dim() != 2 or dy.dim() != 2 or xs.shape[0] != dy.shape[0]:
        raise ValueError(f"need xs (T, K) and dy (T, N); got "
                         f"{tuple(xs.shape)}, {tuple(dy.shape)}")
    (T, K), N = xs.shape, dy.shape[1]
    _check_common(xs, offsets, offsets.shape[0] - 1)
    if K % 8 or N % 8 or T < 1:
        raise ValueError(f"grouped_matmul_dw needs K and N multiples of 8 "
                         f"and T >= 1, got T={T} K={K} N={N}")
    _check_operands(xs, dy, offsets)


def _bind(lib):
    fn = lib.grouped_matmul
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    return fn


def _bind_dw(lib):
    fn = lib.grouped_matmul_dw
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    return fn


def _grouped_matmul_cuda(xs, w, offsets, transpose_w: bool = False):
    """G1 on the current stream -> ``out (T, N)`` (``(T, K)`` with
    ``transpose_w``) in xs's dtype."""
    global grouped_matmul_launches
    _check(xs, w, offsets, transpose_w)
    T = xs.shape[0]
    E, K, N = w.shape
    lib = _cuda.library("grouped_matmul")
    out = torch.empty((T, K if transpose_w else N), dtype=xs.dtype,
                      device=xs.device)
    rc = _bind(lib)(_cuda.ptr(xs), _cuda.ptr(w), _cuda.ptr(offsets),
                    _cuda.ptr(out), T, K, N, E,
                    int(xs.dtype == torch.bfloat16), int(transpose_w),
                    _cuda.stream(xs.device))
    _cuda.check(lib, rc, "grouped_matmul launch")
    grouped_matmul_launches += 1
    _cuda.count(grouped_matmul_launches_by_dtype, xs.dtype)
    return out


def _grouped_matmul_dw_cuda(xs, dy, offsets):
    """G2 on the current stream -> ``dw (E, K, N)`` in xs's dtype."""
    global grouped_matmul_dw_launches
    _check_dw(xs, dy, offsets)
    (T, K), N, E = xs.shape, dy.shape[1], offsets.shape[0] - 1
    lib = _cuda.library("grouped_matmul")
    dw = torch.empty((E, K, N), dtype=xs.dtype, device=xs.device)
    rc = _bind_dw(lib)(_cuda.ptr(xs), _cuda.ptr(dy), _cuda.ptr(offsets),
                       _cuda.ptr(dw), T, K, N, E,
                       int(xs.dtype == torch.bfloat16),
                       _cuda.stream(xs.device))
    _cuda.check(lib, rc, "grouped_matmul_dw launch")
    grouped_matmul_dw_launches += 1
    _cuda.count(grouped_matmul_dw_launches_by_dtype, xs.dtype)
    return dw


class _GroupedMatmul(torch.autograd.Function):
    """G1 as an autograd node: its backward is G1 on ``W^T`` for the
    input and G2 for the weights, each launched only when needed."""

    @staticmethod
    def forward(ctx, xs, w, offsets):
        ctx.save_for_backward(xs, w, offsets)
        return _grouped_matmul_cuda(xs, w, offsets)

    @staticmethod
    def backward(ctx, grad):
        xs, w, offsets = ctx.saved_tensors
        grad = grad.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _grouped_matmul_cuda(grad, w, offsets, transpose_w=True)
        if ctx.needs_input_grad[1]:
            dw = _grouped_matmul_dw_cuda(xs, grad, offsets)
        return dx, dw, None


def grouped_matmul(xs, w, offsets):
    """``out[t] = xs[t] @ w[g(t)]`` for rows ``offsets[g] <= t <
    offsets[g + 1]``: ``xs (T, K)`` sorted by group, ``w (E, K, N)``,
    ``offsets (E + 1,)`` int32 on the same device.  CUDA tensors launch
    G1 (or raise), and differentiate through G1 and G2; CPU tensors run
    the plain version."""
    if xs.is_cuda:
        return _GroupedMatmul.apply(xs, w, offsets)
    return grouped_matmul_reference(xs, w, offsets)


def grouped_matmul_dx(dy, w, offsets):
    """``dx[t] = dy[t] @ w[g(t)]^T`` (``dy (T, N)``, ``w (E, K, N)`` ->
    ``(T, K)``): G1 with W read transposed on CUDA tensors, the plain
    version on CPU ones."""
    if dy.is_cuda:
        return _grouped_matmul_cuda(dy, w, offsets, transpose_w=True)
    return grouped_matmul_dx_reference(dy, w, offsets)


def grouped_matmul_dw(xs, dy, offsets):
    """``dW[e] = Σ_{t in group e} xs[t]^T dy[t]`` (``xs (T, K)``, ``dy
    (T, N)`` -> ``(E, K, N)``): G2 on CUDA tensors, the plain version on
    CPU ones."""
    if xs.is_cuda:
        return _grouped_matmul_dw_cuda(xs, dy, offsets)
    return grouped_matmul_dw_reference(xs, dy, offsets)
