"""The precision a plain reference computes in.

:class:`Exact` leaves everything in float32.  :class:`FP8` is the control,
the configurations' bf16 one step lower where it matters: every operand of
a matrix product or convolution is rounded to float8 e4m3 in the forward,
and every gradient that enters one in the backward to float8 e5m2, each
tensor scaled by its largest magnitude (the usual fp8 training recipe),
while every other activation, and its gradient, is held in bf16 as the
program holds it.  Accumulation stays in float32.
"""

from __future__ import annotations

import torch


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / torch.finfo(dtype).max,
                        torch.ones_like(amax))
    return ((x.detach().float() / scale).to(dtype).float() * scale).to(x.dtype)


class _GradE5M2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


class _BF16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


class Exact:
    name = "f32"

    @staticmethod
    def operand(x: torch.Tensor) -> torch.Tensor:
        return x

    @staticmethod
    def result(y: torch.Tensor) -> torch.Tensor:
        return y

    @staticmethod
    def act(x: torch.Tensor) -> torch.Tensor:
        return x


class FP8:
    name = "fp8"

    @staticmethod
    def operand(x: torch.Tensor) -> torch.Tensor:
        # The gradient passes the rounding unchanged (straight through);
        # :meth:`result` rounds it where it enters the product.
        return x + (_round(x, torch.float8_e4m3fn) - x).detach()

    @staticmethod
    def result(y: torch.Tensor) -> torch.Tensor:
        return _BF16.apply(_GradE5M2.apply(y))

    @staticmethod
    def act(x: torch.Tensor) -> torch.Tensor:
        return _BF16.apply(x)



def strict_f32() -> None:
    """Float32 products in float32: TF32 off for matrix products and
    convolutions (both on the card's tensor cores otherwise), and cuDNN's
    heuristics instead of its timed search."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
