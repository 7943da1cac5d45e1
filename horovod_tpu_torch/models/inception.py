"""Inception V3 without the aux head, the counterpart of
``horovod_tpu/models/inception.py``: bf16 compute, f32 BatchNorm
statistics (eps 1e-3) and head, NCHW in ``channels_last``; native size
299.

Every ``"SAME"`` conv is stride 1 with odd kernels, so its padding is
symmetric; the stride-2 convs are ``"VALID"``.  The pool branches'
``avg_pool(..., padding="SAME")`` counts the padded zeros, as flax's
does.  Submodules carry flax's auto-names (``BasicConv_0`` …,
``InceptionA_0`` …, in a ``BasicConv`` ``Conv_0`` and ``BatchNorm_0``,
``head``) for :func:`~horovod_tpu_torch.models.convert.vision_from_flax`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.vision_layers import (BatchNorm, Conv,
                                                    init_variables,
                                                    same_avg_pool)

__all__ = ["BasicConv", "InceptionA", "InceptionB", "InceptionC",
           "InceptionD", "InceptionE", "InceptionV3", "create",
           "init_variables"]


class BasicConv(nn.Module):
    """conv → BatchNorm → relu."""

    def __init__(self, in_channels: int, features: int, kernel,
                 strides=1, padding="SAME", dtype=torch.bfloat16):
        super().__init__()
        self.Conv_0 = Conv(in_channels, features, kernel, strides, padding,
                           dtype)
        self.BatchNorm_0 = BatchNorm(features, eps=1e-3, momentum=0.9)

    def forward(self, x):
        return torch.relu(self.BatchNorm_0(self.Conv_0(x)))


class _Mixed(nn.Module):
    """A block of ``BasicConv_i`` submodules, numbered in creation order
    as flax numbers them."""

    def __init__(self, dtype):
        super().__init__()
        self.dtype = dtype
        self._n = 0

    def conv(self, in_channels, features, kernel, strides=1,
             padding="SAME") -> BasicConv:
        c = BasicConv(in_channels, features, kernel, strides, padding,
                      self.dtype)
        self.add_module(f"BasicConv_{self._n}", c)
        self._n += 1
        return c


class InceptionA(_Mixed):
    def __init__(self, in_channels: int, pool_features: int, dtype):
        super().__init__(dtype)
        self.b1 = self.conv(in_channels, 64, 1)
        self.b5 = [self.conv(in_channels, 48, 1), self.conv(48, 64, 5)]
        self.b3 = [self.conv(in_channels, 64, 1), self.conv(64, 96, 3),
                   self.conv(96, 96, 3)]
        self.bp = self.conv(in_channels, pool_features, 1)
        self.out_channels = 64 + 64 + 96 + pool_features

    def forward(self, x):
        b5, b3 = x, x
        for c in self.b5:
            b5 = c(b5)
        for c in self.b3:
            b3 = c(b3)
        return torch.cat([self.b1(x), b5, b3, self.bp(same_avg_pool(x))], 1)


class InceptionB(_Mixed):
    """35×35 -> 17×17 grid reduction."""

    def __init__(self, in_channels: int, dtype):
        super().__init__(dtype)
        self.b3 = self.conv(in_channels, 384, 3, 2, "VALID")
        self.bd = [self.conv(in_channels, 64, 1), self.conv(64, 96, 3),
                   self.conv(96, 96, 3, 2, "VALID")]
        self.out_channels = 384 + 96 + in_channels

    def forward(self, x):
        bd = x
        for c in self.bd:
            bd = c(bd)
        return torch.cat([self.b3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(_Mixed):
    """17×17 blocks with factorized 7×7 (1×7 + 7×1) convolutions."""

    def __init__(self, in_channels: int, channels_7x7: int, dtype):
        super().__init__(dtype)
        c7 = channels_7x7
        self.b1 = self.conv(in_channels, 192, 1)
        self.b7 = [self.conv(in_channels, c7, 1), self.conv(c7, c7, (1, 7)),
                   self.conv(c7, 192, (7, 1))]
        self.bd = [self.conv(in_channels, c7, 1), self.conv(c7, c7, (7, 1)),
                   self.conv(c7, c7, (1, 7)), self.conv(c7, c7, (7, 1)),
                   self.conv(c7, 192, (1, 7))]
        self.bp = self.conv(in_channels, 192, 1)
        self.out_channels = 4 * 192

    def forward(self, x):
        b7, bd = x, x
        for c in self.b7:
            b7 = c(b7)
        for c in self.bd:
            bd = c(bd)
        return torch.cat([self.b1(x), b7, bd, self.bp(same_avg_pool(x))], 1)


class InceptionD(_Mixed):
    """17×17 -> 8×8 grid reduction."""

    def __init__(self, in_channels: int, dtype):
        super().__init__(dtype)
        self.b3 = [self.conv(in_channels, 192, 1),
                   self.conv(192, 320, 3, 2, "VALID")]
        self.b7 = [self.conv(in_channels, 192, 1), self.conv(192, 192, (1, 7)),
                   self.conv(192, 192, (7, 1)),
                   self.conv(192, 192, 3, 2, "VALID")]
        self.out_channels = 320 + 192 + in_channels

    def forward(self, x):
        b3, b7 = x, x
        for c in self.b3:
            b3 = c(b3)
        for c in self.b7:
            b7 = c(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(_Mixed):
    """8×8 blocks with split 1×3 / 3×1 branches."""

    def __init__(self, in_channels: int, dtype):
        super().__init__(dtype)
        self.b1 = self.conv(in_channels, 320, 1)
        self.b3 = self.conv(in_channels, 384, 1)
        self.b3_split = [self.conv(384, 384, (1, 3)),
                         self.conv(384, 384, (3, 1))]
        self.bd = [self.conv(in_channels, 448, 1), self.conv(448, 384, 3)]
        self.bd_split = [self.conv(384, 384, (1, 3)),
                         self.conv(384, 384, (3, 1))]
        self.bp = self.conv(in_channels, 192, 1)
        self.out_channels = 320 + 768 + 768 + 192

    def forward(self, x):
        b3 = self.b3(x)
        bd = x
        for c in self.bd:
            bd = c(bd)
        return torch.cat([self.b1(x), *(c(b3) for c in self.b3_split),
                          *(c(bd) for c in self.bd_split),
                          self.bp(same_avg_pool(x))], 1)


class InceptionV3(nn.Module):
    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        # stem: 299×299×3 -> 35×35×192
        self.stem = []
        for i, args in enumerate([(3, 32, 3, 2, "VALID"),
                                  (32, 32, 3, 1, "VALID"), (32, 64, 3),
                                  (64, 80, 1, 1, "VALID"),
                                  (80, 192, 3, 1, "VALID")]):
            self.add_module(f"BasicConv_{i}", BasicConv(*args, dtype=dtype))
            self.stem.append(getattr(self, f"BasicConv_{i}"))
        self.mixed = []
        channels = 192
        for cls, *args in ((InceptionA, 32), (InceptionA, 64),
                           (InceptionA, 64), (InceptionB,),
                           (InceptionC, 128), (InceptionC, 160),
                           (InceptionC, 160), (InceptionC, 192),
                           (InceptionD,), (InceptionE,), (InceptionE,)):
            block = cls(channels, *args, dtype=dtype)
            n = sum(1 for b in self.mixed if isinstance(b, cls))
            self.add_module(f"{cls.__name__}_{n}", block)
            self.mixed.append(block)
            channels = block.out_channels
        self.head = nn.Linear(channels, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: ``(B, 3, H, W)`` images -> ``(B, num_classes)`` f32
        logits."""
        x = x.to(self.dtype)
        for i, c in enumerate(self.stem):
            x = c(x)
            if i in (2, 4):
                x = F.max_pool2d(x, 3, 2)
        for block in self.mixed:
            x = block(x)
        # jnp.mean keeps the compute dtype; the head is f32.
        return self.head(x.mean((2, 3)).float())


def create(name: str = "InceptionV3", num_classes: int = 1000,
           dtype: torch.dtype = torch.bfloat16, *, seed: int = 0,
           device=None) -> InceptionV3:
    """InceptionV3 on ``device`` (CUDA unless ``"cpu"`` is passed),
    parameters drawn by :func:`init_variables` from ``seed``, in
    ``channels_last``."""
    if name != "InceptionV3":
        raise ValueError(f"unknown model {name!r}")
    model = InceptionV3(num_classes=num_classes, dtype=dtype)
    init_variables(model, seed, device=device)
    return model.to(memory_format=torch.channels_last)
