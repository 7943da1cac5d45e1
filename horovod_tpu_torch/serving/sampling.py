"""Per-request sampling parameters as per-slot data of the decode tick.

Counterpart of ``horovod_tpu/serving/sampling.py`` (copied; the port
imports nothing of the JAX package).  Every request carries its own
``temperature`` / ``top_k`` / ``top_p`` / ``seed``; the engine rides
them through the tick as per-slot columns plus per-slot key rows
(:func:`~horovod_tpu_torch.models.transformer.sample_token_rows`).  One
tick serves every mix of parameters, and greedy is a temperature-0 row,
so request churn never recaptures the tick's CUDA graph.

Reproducibility: a slot's output equals ``sample_decode`` (the
per-request oracle) at the same seed and parameters.  The key of the
token at position ``p`` is ``fold_in(fold_in(seed_key(seed), p), 0)``.

This module owns the host half: parameter validation (:func:`validate`),
the seed-to-key map (:func:`seed_key`, no device operation a submit),
and the per-slot columns (:class:`SlotSampling`), whose device copies
are static tensors refreshed only when a slot's parameters change.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from horovod_tpu_torch.serving.graph import upload_into
from horovod_tpu_torch.serving.scheduler import ServingError

__all__ = ["MAX_SEED", "SamplingParams", "SlotSampling", "seed_key",
           "validate"]

#: Seeds are non-negative int32: ``jax.random.PRNGKey`` packs a seed
#: below 2**32 into the low key word, so :func:`seed_key` is exact for
#: every seed in [0, 2**31).
MAX_SEED = 2 ** 31


def validate(temperature=0.0, top_k=0, top_p=0.0,
             seed=None) -> Tuple[float, int, float, int]:
    """Normalize and validate one request's sampling parameters.

    Returns ``(temperature, top_k, top_p, seed)`` as plain
    ``(float, int, float, int)``; raises :class:`ServingError` (HTTP
    400) on anything the sampler cannot honor.  ``temperature=0`` is
    greedy; ``top_k=0`` and ``top_p`` of 0 or 1 disable their
    filters."""
    try:
        temperature = float(temperature if temperature is not None else 0.0)
        top_k = int(top_k if top_k is not None else 0)
        top_p = float(top_p if top_p is not None else 0.0)
        seed = int(seed if seed is not None else 0)
    except (TypeError, ValueError) as e:
        raise ServingError(f"bad sampling parameter: {e}")
    if not math.isfinite(temperature) or temperature < 0.0:
        raise ServingError(
            f"temperature must be finite and >= 0, got {temperature}")
    if top_k < 0:
        raise ServingError(f"top_k must be >= 0, got {top_k}")
    if not math.isfinite(top_p) or not 0.0 <= top_p <= 1.0:
        raise ServingError(f"top_p must be in [0, 1], got {top_p}")
    if not 0 <= seed < MAX_SEED:
        raise ServingError(
            f"seed must be in [0, {MAX_SEED}), got {seed}")
    return temperature, top_k, top_p, seed


def seed_key(seed: int) -> np.ndarray:
    """``np.asarray(jax.random.PRNGKey(seed))`` without JAX: the threefry
    key of a seed in [0, 2**31) is ``[0, seed]`` uint32."""
    if not 0 <= seed < MAX_SEED:
        raise ValueError(f"seed out of range [0, {MAX_SEED}): {seed}")
    return np.array([0, seed], np.uint32)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """One request's sampling knobs, validated (a bundle for callers that
    pass them around together; ``scheduler.Request`` carries them as
    plain fields)."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    seed: int = 0

    @classmethod
    def make(cls, temperature=0.0, top_k=0, top_p=0.0,
             seed=None) -> "SamplingParams":
        return cls(*validate(temperature, top_k, top_p, seed))

    @property
    def sampled(self) -> bool:
        return self.temperature > 0.0


class SlotSampling:
    """The per-slot sampling columns: a host mirror and static device
    tensors.

    The engine sets a slot's row at admission and zeroes it at release
    (a zero row is greedy — what inactive and greedy slots need).
    :meth:`device` returns the four device tensors — always the same
    ones, so a captured tick reads them by address — after refreshing
    them from the mirror when a row changed (pinned, non-blocking
    copies: no host sync)."""

    def __init__(self, n_slots: int, device=None):
        self.temperature = np.zeros(n_slots, np.float32)
        self.top_k = np.zeros(n_slots, np.int64)
        self.top_p = np.zeros(n_slots, np.float32)
        self.key = np.zeros((n_slots, 2), np.int64)
        dev = torch.device(device) if device is not None else \
            torch.device("cpu")
        self._dev = tuple(torch.zeros(a.shape, device=dev,
                                      dtype=torch.from_numpy(a).dtype)
                          for a in self._host())
        self._dirty = True

    def _host(self) -> tuple:
        return self.temperature, self.top_k, self.top_p, self.key

    def set(self, slot: int, *, temperature: float, top_k: int,
            top_p: float, seed: int) -> None:
        self.temperature[slot] = temperature
        self.top_k[slot] = top_k
        self.top_p[slot] = top_p
        self.key[slot] = seed_key(seed)
        self._dirty = True

    def clear(self, slot: int) -> None:
        self.temperature[slot] = 0.0
        self.top_k[slot] = 0
        self.top_p[slot] = 0.0
        self.key[slot] = 0
        self._dirty = True

    def reset(self) -> None:
        """Zero every row (the failure path)."""
        for a in self._host():
            a[...] = 0
        self._dirty = True

    def device(self) -> tuple:
        """The ``(temperature, top_k, top_p, keys)`` device columns the
        tick reads, refreshed first when a row changed."""
        if self._dirty:
            for dst, src in zip(self._dev, self._host()):
                upload_into(dst, src)
            self._dirty = False
        return self._dev
