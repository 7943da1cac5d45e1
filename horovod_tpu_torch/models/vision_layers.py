"""The building blocks of the vision models, each with flax's behaviour.

Shared by :mod:`~horovod_tpu_torch.models.resnet` and
:mod:`~horovod_tpu_torch.models.inception`, the counterparts of
``horovod_tpu/models/resnet.py`` and ``inception.py``:

* :class:`Conv` is flax ``nn.Conv(use_bias=False, dtype=dtype)`` over f32
  parameters: the f32 master kernel is cast to the compute dtype at each
  use.  Padding is flax's: ``"SAME"``, ``"VALID"`` or explicit
  ``((top, bottom), (left, right))``.  ``"SAME"`` at stride 2 pads one
  more row after than before where the input is even (ResNet's strided
  3×3), so an asymmetric padding is ``F.pad`` then a conv with none.
* :class:`BatchNorm` is flax ``nn.BatchNorm`` on its
  ``force_float32_reductions`` path: mean and variance reduced in f32
  from the compute-dtype activations, the normalisation in f32, the
  output cast back.  In training it normalises with the batch's
  statistics and moves the running ones, ``running = m · running +
  (1 − m) · batch``, with the biased variance, as flax does
  (``torch.nn.BatchNorm2d`` moves ``running_var`` by the unbiased one).
  In ``eval()`` it uses the running statistics.  The statistics are the
  rank's own: flax's ``axis_name`` is None, so there is no SyncBN.
* The head is an f32 :class:`torch.nn.Linear`.

Tensors are NCHW in ``torch.channels_last``, the physical NHWC of the
JAX models; a flax mean over ``axis=(1, 2)`` is a mean over ``(2, 3)``.

:func:`init_variables` draws the parameters with flax's initializers
(``lecun_normal`` kernels, unit BatchNorm scales — zero where a block's
last BatchNorm asks — zero biases, zero means and unit variances).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.basics import resolve_device

__all__ = ["BatchNorm", "Conv", "init_variables", "same_avg_pool"]

Padding = Union[str, Sequence[Tuple[int, int]]]


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


class Conv(nn.Module):
    """flax ``nn.Conv(features, kernel, strides, padding, use_bias=False,
    dtype=dtype)``: the weight is ``(out, in, kh, kw)`` in f32."""

    def __init__(self, in_channels: int, features: int, kernel,
                 strides=1, padding: Padding = "SAME",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.kernel = _pair(kernel)
        self.strides = _pair(strides)
        self.padding = padding
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_channels,
                                               *self.kernel))

    def _pads(self, size) -> Tuple[Tuple[int, int], ...]:
        if self.padding == "VALID":
            return ((0, 0), (0, 0))
        if self.padding != "SAME":
            return tuple(tuple(p) for p in self.padding)
        pads = []
        for n, k, s in zip(size, self.kernel, self.strides):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads.append((total // 2, total - total // 2))
        return tuple(pads)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        w = self.weight.to(self.dtype)
        (top, bottom), (left, right) = self._pads(x.shape[-2:])
        if top == bottom and left == right:
            return F.conv2d(x, w, stride=self.strides, padding=(top, left))
        return F.conv2d(F.pad(x, (left, right, top, bottom)), w,
                        stride=self.strides)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum, epsilon, dtype=x's)`` over NCHW:
    ``weight``/``bias`` are flax's ``scale``/``bias`` and the buffers
    ``running_mean``/``running_var`` its ``batch_stats`` ``mean``/``var``,
    all f32.  ``zero_scale`` starts the scale at zero
    (``scale_init=zeros``)."""

    def __init__(self, features: int, *, eps: float, momentum: float = 0.9,
                 zero_scale: bool = False):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.zero_scale = zero_scale
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        # The native kernel reduces a low-precision input in f32 and
        # normalises in f32; given no running buffers it moves none, and
        # returns the batch mean and 1 / sqrt(biased var + eps).
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            var = invstd.pow(-2).sub_(self.eps)
            self.running_mean.mul_(self.momentum).add_(
                mean, alpha=1 - self.momentum)
            self.running_var.mul_(self.momentum).add_(
                var, alpha=1 - self.momentum)
        return y


def same_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """flax ``avg_pool(x, (3, 3), strides=(1, 1), padding="SAME")``, which
    counts the padded zeros in the divisor (``count_include_pad``)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


def _lecun_normal_(w: torch.Tensor, fan_in: int, g: torch.Generator):
    """flax ``lecun_normal``: a normal truncated at ±2 standard deviations,
    rescaled so that its variance is ``1 / fan_in``.  Drawn in logical
    order, whatever ``w``'s memory format."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    t = torch.empty(w.shape, device=w.device)
    w.copy_(nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                  generator=g))


@torch.no_grad()
def init_variables(model: nn.Module, seed: int = 0, *,
                   device=None) -> nn.Module:
    """Move ``model`` to ``device`` (CUDA unless ``"cpu"`` is passed) and
    draw its parameters there from a ``torch.Generator`` seeded with
    ``seed``, with flax's initializers; reset its batch statistics.
    Returns the model.  The numbers differ from ``jax.random``'s:
    :func:`~horovod_tpu_torch.models.convert.vision_from_flax` loads the
    JAX package's own."""
    device = resolve_device(device)
    model.to(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, Conv):
            _lecun_normal_(mod.weight, mod.weight[0].numel(), g)
        elif isinstance(mod, nn.Linear):
            _lecun_normal_(mod.weight, mod.in_features, g)
            mod.bias.zero_()
        elif isinstance(mod, BatchNorm):
            mod.weight.fill_(0.0 if mod.zero_scale else 1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
    return model
