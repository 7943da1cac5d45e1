"""The grouped (ragged) matrix product of the dropless MoE dispatch:
kernel G1 (``csrc/grouped_matmul.cu``), its plain PyTorch version, and
the wrapper that chooses between them.

No Pallas original: the counterpart of ``lax.ragged_dot(xs, W,
counts)``, an XLA op, which ``horovod_tpu/ops/moe.py`` ``dropless_moe``
calls for the experts' three products.  ``out[t] = xs[t] @ W[g(t)]``
with the rows of ``xs`` sorted by group and the groups given as
``offsets``, the cumsum of the group sizes with a leading 0, an ``(E +
1,)`` int32 tensor on ``xs``'s device.  G1 reads the offsets from device
memory, so one launch (and one CUDA graph) serves every routing: nothing
is read back to the host.  PyTorch has no public grouped product that
takes its offsets from the device.

* :func:`grouped_matmul`: a CUDA tensor launches G1 (f32 or bf16, f32
  accumulation, output in the input dtype) or raises — a bad dtype,
  shape, contiguity or alignment, a failed build, a failed launch;
  nothing falls back.  A CPU tensor runs
  :func:`grouped_matmul_reference`.
* G1 has no backward: dropless is the serving dispatch, and training
  runs the switch dispatch.  The CUDA path's ``autograd.Function``
  raises in its backward; the plain version is differentiable (the CPU
  tests hold its gradients to JAX's).
* :data:`grouped_matmul_launches` counts G1's launches.
"""

from __future__ import annotations

import ctypes

import torch

from horovod_tpu_torch.ops import _cuda

__all__ = ["MAX_GROUPS", "grouped_matmul", "grouped_matmul_reference",
           "group_offsets"]

#: Launches of G1 in this process.
grouped_matmul_launches = 0

#: The most groups (experts) G1 takes: each CTA walks the offsets.
MAX_GROUPS = 64


def group_offsets(sorted_groups: torch.Tensor, n_groups: int) -> torch.Tensor:
    """``(E + 1,)`` int32 offsets of the runs of ``sorted_groups`` (a
    sorted integer vector of group ids): ``searchsorted`` of ``0..E``,
    on the device, as the JAX package counts its group sizes."""
    eye = torch.arange(n_groups + 1, dtype=sorted_groups.dtype,
                       device=sorted_groups.device)
    return torch.searchsorted(sorted_groups, eye).to(torch.int32)


def grouped_matmul_reference(xs, w, offsets):
    """Plain version: ``Σ_e mask_e · (xs @ W[e])`` with ``mask_e`` the
    rows ``offsets[e] <= t < offsets[e + 1]``, taken with ``where`` (the
    masked dense formulation of JAX's CPU lowering of ``ragged_dot``):
    exact, and no host read.  Rows outside every group are zero."""
    rows = torch.arange(xs.shape[0], device=xs.device)
    out = torch.zeros((xs.shape[0], w.shape[2]), dtype=xs.dtype,
                      device=xs.device)
    for e in range(w.shape[0]):
        mask = (rows >= offsets[e]) & (rows < offsets[e + 1])
        out = torch.where(mask[:, None], xs @ w[e], out)
    return out


def _check(xs, w, offsets):
    if xs.dim() != 2 or w.dim() != 3 or w.shape[1] != xs.shape[1]:
        raise ValueError(f"need xs (T, K) and w (E, K, N); got "
                         f"{tuple(xs.shape)}, {tuple(w.shape)}")
    T, K = xs.shape
    E, _, N = w.shape
    if xs.dtype not in (torch.float32, torch.bfloat16) or w.dtype != xs.dtype:
        raise TypeError(f"grouped_matmul takes one dtype of f32/bf16, got "
                        f"{xs.dtype}, {w.dtype}")
    if offsets.shape != (E + 1,) or offsets.dtype != torch.int32:
        raise ValueError(f"offsets must be ({E + 1},) int32, got "
                         f"{tuple(offsets.shape)} {offsets.dtype}")
    if not 1 <= E <= MAX_GROUPS:
        raise ValueError(f"grouped_matmul takes 1..{MAX_GROUPS} groups, "
                         f"got {E}")
    if K % 8 or N % 8 or T < 1:
        raise ValueError(f"grouped_matmul needs K and N multiples of 8 and "
                         f"T >= 1, got T={T} K={K} N={N}")
    if not (xs.is_contiguous() and w.is_contiguous()
            and offsets.is_contiguous()):
        raise ValueError("grouped_matmul needs contiguous xs, w, offsets")
    if xs.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("grouped_matmul needs 16-byte aligned xs and w "
                         "(rows are copied 16 bytes at a time)")
    if not (xs.device == w.device == offsets.device):
        raise ValueError("xs, w, offsets must be on one device")


def _bind(lib):
    fn = lib.grouped_matmul
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    return fn


def _grouped_matmul_cuda(xs, w, offsets):
    """G1 on the current stream -> ``out (T, N)`` in xs's dtype."""
    global grouped_matmul_launches
    _check(xs, w, offsets)
    T, K = xs.shape
    E, _, N = w.shape
    lib = _cuda.library("grouped_matmul")
    out = torch.empty((T, N), dtype=xs.dtype, device=xs.device)
    rc = _bind(lib)(_cuda.ptr(xs), _cuda.ptr(w), _cuda.ptr(offsets),
                    _cuda.ptr(out), T, K, N, E,
                    int(xs.dtype == torch.bfloat16), _cuda.stream(xs.device))
    _cuda.check(lib, rc, "grouped_matmul launch")
    grouped_matmul_launches += 1
    return out


class _GroupedMatmul(torch.autograd.Function):
    """G1 as an autograd node whose backward raises: the dropless
    dispatch serves, it does not train."""

    @staticmethod
    def forward(ctx, xs, w, offsets):
        return _grouped_matmul_cuda(xs, w, offsets)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "grouped_matmul (G1) has no backward on CUDA: the dropless MoE "
            "dispatch is for serving; train with moe_impl='switch' (the "
            "CUDA backward is on ROADMAP.md)")


def grouped_matmul(xs, w, offsets):
    """``out[t] = xs[t] @ w[g(t)]`` for rows ``offsets[g] <= t <
    offsets[g + 1]``: ``xs (T, K)`` sorted by group, ``w (E, K, N)``,
    ``offsets (E + 1,)`` int32 on the same device.  CUDA tensors launch
    G1 (or raise); CPU tensors run the plain version."""
    if xs.is_cuda:
        return _GroupedMatmul.apply(xs, w, offsets)
    return grouped_matmul_reference(xs, w, offsets)
