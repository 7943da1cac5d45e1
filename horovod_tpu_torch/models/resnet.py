"""ResNet v1.5 (ResNet-18 to -152), the counterpart of
``horovod_tpu/models/resnet.py``: bf16 compute over f32 parameters and
f32 BatchNorm statistics, an f32 head, NCHW in ``channels_last``.

Submodules carry flax's auto-names (``conv_init``, ``bn_init``,
``BottleneckBlock_0`` …; in a block ``Conv_0``, ``BatchNorm_0`` …,
``conv_proj``, ``norm_proj``; ``head``), so that
:func:`~horovod_tpu_torch.models.convert.vision_from_flax` maps the flax
variables by path.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.vision_layers import (BatchNorm, Conv,
                                                    init_variables)

__all__ = ["BottleneckBlock", "MODELS", "ResNet", "ResNetBlock", "create",
           "init_variables"]

_norm = partial(BatchNorm, eps=1e-5, momentum=0.9)


class ResNetBlock(nn.Module):
    """Basic (2-conv) residual block for ResNet-18/34."""

    expansion = 1

    def __init__(self, in_channels: int, filters: int, strides: int,
                 dtype: torch.dtype):
        super().__init__()
        self.Conv_0 = Conv(in_channels, filters, 3, strides, dtype=dtype)
        self.BatchNorm_0 = _norm(filters)
        self.Conv_1 = Conv(filters, filters, 3, dtype=dtype)
        self.BatchNorm_1 = _norm(filters, zero_scale=True)
        self._project(in_channels, filters, strides, dtype)

    def _project(self, in_channels, filters, strides, dtype):
        # flax projects when the residual's shape differs from the
        # output's: a stride or a change of width.
        out = filters * self.expansion
        self.has_proj = strides != 1 or in_channels != out
        if self.has_proj:
            self.conv_proj = Conv(in_channels, out, 1, strides, dtype=dtype)
            self.norm_proj = _norm(out)

    def _residual(self, x):
        return self.norm_proj(self.conv_proj(x)) if self.has_proj else x

    def forward(self, x):
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        return torch.relu(self._residual(x) + y)


class BottleneckBlock(ResNetBlock):
    """1-3-1 bottleneck block for ResNet-50/101/152 (v1.5: the stride on
    the 3×3)."""

    expansion = 4

    def __init__(self, in_channels: int, filters: int, strides: int,
                 dtype: torch.dtype):
        nn.Module.__init__(self)
        self.Conv_0 = Conv(in_channels, filters, 1, dtype=dtype)
        self.BatchNorm_0 = _norm(filters)
        self.Conv_1 = Conv(filters, filters, 3, strides, dtype=dtype)
        self.BatchNorm_1 = _norm(filters)
        self.Conv_2 = Conv(filters, filters * 4, 1, dtype=dtype)
        self.BatchNorm_2 = _norm(filters * 4, zero_scale=True)
        self._project(in_channels, filters, strides, dtype)

    def forward(self, x):
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = torch.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        return torch.relu(self._residual(x) + y)


class ResNet(nn.Module):
    """``stem``: ``"conv7"``, the 7×7/2 conv (padding 3); or ``"s2d"``,
    a 2×2 space-to-depth then a 4×4/1 conv padded (2, 1) — the same
    function class, 12 input channels instead of 3.  Either is followed
    by BatchNorm, relu and a 3×3/2 max pool padded 1."""

    def __init__(self, stage_sizes, block_cls, num_classes: int = 1000,
                 num_filters: int = 64, dtype: torch.dtype = torch.bfloat16,
                 stem: str = "conv7"):
        super().__init__()
        if stem not in ("conv7", "s2d"):
            raise ValueError(f"stem must be 'conv7' or 's2d', not {stem!r}")
        self.dtype = dtype
        self.stem = stem
        if stem == "s2d":
            self.conv_init = Conv(12, num_filters, 4, 1,
                                  padding=((2, 1), (2, 1)), dtype=dtype)
        else:
            self.conv_init = Conv(3, num_filters, 7, 2,
                                  padding=((3, 3), (3, 3)), dtype=dtype)
        self.bn_init = _norm(num_filters)
        self.blocks = []
        channels = num_filters
        for i, block_size in enumerate(stage_sizes):
            for j in range(block_size):
                name = f"{block_cls.__name__}_{len(self.blocks)}"
                filters = num_filters * 2 ** i
                self.add_module(name, block_cls(
                    channels, filters, 2 if i > 0 and j == 0 else 1, dtype))
                self.blocks.append(name)
                channels = filters * block_cls.expansion
        self.head = nn.Linear(channels, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: ``(B, 3, H, W)`` images -> ``(B, num_classes)`` f32
        logits.  Train mode uses and moves the batch statistics."""
        x = x.to(self.dtype)
        if self.stem == "s2d":
            # (dy, dx, c) channel order, as the JAX NHWC
            # reshape(B, H/2, 2, W/2, 2, C).transpose(0, 1, 3, 2, 4, 5).
            B, C, H, W = x.shape
            x = x.reshape(B, C, H // 2, 2, W // 2, 2).permute(0, 3, 5, 1, 2, 4)
            x = x.reshape(B, 4 * C, H // 2, W // 2).contiguous(
                memory_format=torch.channels_last)
        x = torch.relu(self.bn_init(self.conv_init(x)))
        x = F.max_pool2d(x, 3, 2, 1)  # flax pads max_pool with -inf too
        for name in self.blocks:
            x = getattr(self, name)(x)
        # jnp.mean keeps the compute dtype; the head is f32.
        return self.head(x.mean((2, 3)).float())


ResNet18 = partial(ResNet, [2, 2, 2, 2], ResNetBlock)
ResNet34 = partial(ResNet, [3, 4, 6, 3], ResNetBlock)
ResNet50 = partial(ResNet, [3, 4, 6, 3], BottleneckBlock)
ResNet101 = partial(ResNet, [3, 4, 23, 3], BottleneckBlock)
ResNet152 = partial(ResNet, [3, 8, 36, 3], BottleneckBlock)

MODELS = {
    "ResNet18": ResNet18,
    "ResNet34": ResNet34,
    "ResNet50": ResNet50,
    "ResNet101": ResNet101,
    "ResNet152": ResNet152,
}


def create(name: str = "ResNet50", num_classes: int = 1000,
           dtype: torch.dtype = torch.bfloat16, stem: str = "conv7", *,
           num_filters: int = 64, seed: int = 0, device=None) -> ResNet:
    """``MODELS[name]`` on ``device`` (CUDA unless ``"cpu"`` is passed),
    parameters drawn by :func:`init_variables` from ``seed``, in
    ``channels_last``."""
    model = MODELS[name](num_classes=num_classes, num_filters=num_filters,
                         dtype=dtype, stem=stem)
    init_variables(model, seed, device=device)
    return model.to(memory_format=torch.channels_last)
