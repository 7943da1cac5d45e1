"""The parts of ``jax.random`` that the sampler uses, in PyTorch.

The serving engine's sampled pick must draw the same random numbers as
the JAX package's, so that a request's tokens equal the per-request
``sample_decode`` oracle of either package.  This module is the port's
own copy of JAX's threefry PRNG (``jax._src.prng``): the Threefry-2x32
hash with 20 rounds, ``fold_in``, 32-bit ``random_bits``, ``uniform``,
``gumbel`` (the default "low" mode) and ``categorical`` (the Gumbel-max
trick, as ``jax.random.categorical`` samples with replacement).

A key is an int64 tensor ``(..., 2)`` holding the two uint32 words of a
raw JAX key (``np.asarray(jax.random.PRNGKey(seed))``); leading
dimensions batch independent keys.  The uint32 arithmetic runs in int64
with ``& 0xFFFFFFFF`` after every add and shift: PyTorch's uint32 has
few CUDA operators, while int64 add, shift and xor run on the CPU, on
CUDA and under CUDA-graph capture alike.  The integer stages (bits and
the uniform's mantissa) are bit-identical to JAX; ``gumbel``'s two
``log``s may differ from XLA's by an ulp.

``random_bits`` has the bit layout of ``jax_threefry_partitionable``
(JAX's default since 0.5): the counter of element ``i`` is ``(0, i)``
and the bits are the xor of the two output words.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["categorical", "fold_in", "gumbel", "random_bits",
           "threefry2x32", "uniform"]

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x, d: int):
    return ((x << d) & MASK) | (x >> (32 - d))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of the counter pair ``(x1, x2)`` under the
    key ``(k1, k2)``: int64 tensors of uint32 values that broadcast
    together.  Returns the two output words (JAX's
    ``_threefry2x32_lowering``, unrolled)."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + k1) & MASK
    x2 = (x2 + k2) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def fold_in(key, data):
    """``jax.random.fold_in`` for each key of ``key (..., 2)`` with the
    integer ``data`` (a tensor broadcasting to ``key[..., 0]``, or an
    int): the hash of the counter ``(0, data mod 2**32)``."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def random_bits(key, shape):
    """32-bit ``jax.random.bits`` of ``shape`` for each key of ``key
    (..., 2)`` -> int64 ``(..., *shape)`` of uint32 values."""
    shape = tuple(shape)
    n = int(np.prod(shape)) if shape else 1
    if n >= 2 ** 32:
        raise ValueError(f"random_bits of {n} values: the counter is "
                         "32 bits here")
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(*lead, 1)
    k2 = key[..., 1].reshape(*lead, 1)
    iota = torch.arange(n, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(iota), iota)
    return (y1 ^ y2).reshape(*lead, *shape)


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0):
    """f32 ``jax.random.uniform`` in ``[minval, maxval)``: 23 random
    mantissa bits under the exponent of 1.0, minus 1, scaled in f32."""
    bits = random_bits(key, shape)
    one = int(np.array(1.0, np.float32).view(np.uint32))
    floats = ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    out = floats * float(hi - lo) + float(lo)
    return torch.clamp_min(out, float(lo))


def gumbel(key, shape):
    """f32 standard Gumbel samples, ``jax.random.gumbel``'s "low" mode:
    ``-log(-log(u))`` with ``u`` uniform in ``[tiny, 1)``."""
    u = uniform(key, shape, minval=_TINY, maxval=1.0)
    return -torch.log(-torch.log(u))


def categorical(key, logits):
    """One draw from each row of ``logits (..., V)`` with its own key of
    ``key (..., 2)``: ``argmax(logits + gumbel)``, the first index on a
    tie, as ``jax.random.categorical`` samples with replacement."""
    g = gumbel(key, logits.shape[-1:])
    return torch.argmax(g + logits, dim=-1)
