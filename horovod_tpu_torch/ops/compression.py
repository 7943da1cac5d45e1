"""Gradient compression applied around a collective.

Counterpart of ``horovod_tpu/ops/compression.py`` on tensors:
``Compression.none``, ``fp16`` and ``bf16``.  ``compress(tensor) ->
(tensor, ctx)`` casts a floating tensor to 16 bits for the wire;
``decompress(tensor, ctx)`` restores its dtype.  Other tensors pass
through.
"""

from __future__ import annotations

import torch

__all__ = ["Compression", "Compressor"]


class Compressor:
    """Interface: ``compress(tensor) -> (tensor, ctx)``;
    ``decompress(tensor, ctx) -> tensor``."""

    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    """Identity (``Compression.none``)."""

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    dtype: torch.dtype

    @classmethod
    def compress(cls, tensor):
        if not tensor.is_floating_point():
            return tensor, None
        return tensor.to(cls.dtype), tensor.dtype

    @staticmethod
    def decompress(tensor, ctx):
        return tensor if ctx is None else tensor.to(ctx)


class FP16Compressor(_CastCompressor):
    dtype = torch.float16


class BF16Compressor(_CastCompressor):
    dtype = torch.bfloat16


class Compression:
    """Namespace of compressors (``Compression.none``, ``.fp16``,
    ``.bf16``)."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
