"""GP regression + Expected-Improvement Bayesian optimization — the
``common/optim/`` math (``gaussian_process.{h,cc}``,
``bayesian_optimization.h``) in NumPy, shared by the online serving
tuner (:mod:`horovod_tpu_torch.tuning.tuner`) and the offline replay tuner
(:mod:`horovod_tpu_torch.tuning.replay`).

This is the serving twin of the training-side port in
:mod:`horovod_tpu_torch.autotune` with two hardenings the serving loop
needs:

* a kernel-matrix CONDITIONING GUARD: serving scores repeat (two
  windows at the same knob can score near-identically, and the online
  tuner revisits pinned points), which drives the RBF Gram matrix
  toward singularity.  ``fit`` escalates the diagonal jitter by 10x
  per Cholesky failure up to ``max_jitter`` instead of raising out of
  the engine's tick loop;
* ``maximize=False`` support, because serving objectives mix
  directions (throughput up, p99 TTFT down) — the optimizer works on
  a single scalar but each knob declares its direction in
  :mod:`horovod_tpu_torch.tuning.params`.

Problem sizes are tiny (≤ a few dozen samples, ≤ 4 dims), so exact
Cholesky inference on the host is the right tool — no Eigen, no GPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "GaussianProcess",
    "ExpectedImprovement",
    "BayesianOptimizer",
    "CategoricalSweep",
]


def _erf(x: np.ndarray) -> np.ndarray:
    # Abramowitz & Stegun 7.1.26, vectorized; |error| < 1.5e-7 —
    # plenty for an acquisition argmax.
    sign = np.sign(x)
    x = np.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * x)
    y = 1.0 - (
        ((((1.061405429 * t - 1.453152027) * t) + 1.421413741) * t
         - 0.284496736) * t + 0.254829592
    ) * t * np.exp(-x * x)
    return sign * y


class GaussianProcess:
    """RBF-kernel GP with exact Cholesky inference and a jitter-
    escalation conditioning guard.

    ``k(a, b) = exp(-0.5 |a-b|^2 / length_scale^2)``; targets are
    normalized to zero mean / unit variance before the solve (the
    reference normalizes the same way), so ``length_scale`` and
    ``noise`` are scale-free.
    """

    def __init__(self, length_scale: float = 0.3,
                 noise: float = 1e-6, max_jitter: float = 1e-2) -> None:
        self.length_scale = float(length_scale)
        self.noise = float(noise)
        self.max_jitter = float(max_jitter)
        #: jitter actually used by the last ``fit`` (== ``noise``
        #: unless the conditioning guard escalated it).
        self.last_jitter = float(noise)
        self._x: Optional[np.ndarray] = None

    def _kernel(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        d = a[:, None, :] - b[None, :, :]
        sq = np.sum(d * d, axis=-1)
        return np.exp(-0.5 * sq / (self.length_scale ** 2))

    def fit(self, x: np.ndarray, y: np.ndarray) -> None:
        x = np.atleast_2d(np.asarray(x, np.float64))
        y = np.asarray(y, np.float64).ravel()
        if x.shape[0] != y.shape[0]:
            raise ValueError(
                f"GP fit: {x.shape[0]} inputs vs {y.shape[0]} targets")
        self._x = x
        self._ymean = float(y.mean()) if y.size else 0.0
        self._ystd = float(y.std()) + 1e-12
        yn = (y - self._ymean) / self._ystd
        k = self._kernel(x, x)
        # Conditioning guard: duplicate / near-duplicate rows (repeat
        # scores at a pinned knob) make K singular.  Escalate the
        # diagonal jitter instead of letting LinAlgError escape into
        # the serving tick loop.
        jitter = self.noise
        while True:
            try:
                self._L = np.linalg.cholesky(k + jitter * np.eye(len(x)))
                break
            except np.linalg.LinAlgError:
                jitter *= 10.0
                if jitter > self.max_jitter:
                    raise
        self.last_jitter = jitter
        self._alpha = np.linalg.solve(
            self._L.T, np.linalg.solve(self._L, yn))

    def predict(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Posterior mean and stddev at ``x`` (denormalized)."""
        x = np.atleast_2d(np.asarray(x, np.float64))
        if self._x is None:
            return np.zeros(len(x)), np.ones(len(x))
        ks = self._kernel(x, self._x)
        mu = ks @ self._alpha
        v = np.linalg.solve(self._L, ks.T)
        var = np.clip(1.0 - np.sum(v * v, axis=0), 1e-12, None)
        return mu * self._ystd + self._ymean, np.sqrt(var) * self._ystd


class ExpectedImprovement:
    """EI acquisition (``bayesian_optimization.h:93``):
    ``EI(u) = (mu - best - xi) Phi(z) + sigma phi(z)``."""

    def __init__(self, xi: float = 0.01) -> None:
        self.xi = float(xi)

    def __call__(self, gp: GaussianProcess, u: np.ndarray,
                 best: float) -> np.ndarray:
        mu, sigma = gp.predict(u)
        imp = mu - best - self.xi
        z = imp / sigma
        phi = np.exp(-0.5 * z * z) / np.sqrt(2 * np.pi)
        Phi = 0.5 * (1 + _erf(z / np.sqrt(2)))
        ei = imp * Phi + sigma * phi
        ei[sigma < 1e-10] = 0.0
        return ei


class BayesianOptimizer:
    """EI-driven maximizer over a box domain.

    ``register(x, y)`` feeds observed (knobs, score) pairs;
    ``suggest()`` returns the next point — random exploration while
    fewer than ``bootstrap`` samples exist, then the EI argmax over
    ``n_candidates`` uniform candidates (equivalent to the reference's
    L-BFGS restarts at these dimensionalities).  All randomness comes
    from the seeded ``RandomState``, so two optimizers built with the
    same seed propose the same trajectory — the property the online
    tuner's determinism tests rely on.
    """

    def __init__(self, bounds: Sequence[Tuple[float, float]], *,
                 xi: float = 0.01, seed: int = 0,
                 bootstrap: int = 3, n_candidates: int = 512) -> None:
        self.bounds = np.asarray(bounds, np.float64)
        if self.bounds.ndim != 2 or self.bounds.shape[1] != 2:
            raise ValueError(f"bounds must be (d, 2), got {self.bounds.shape}")
        self.gp = GaussianProcess(length_scale=0.3)
        self.acq = ExpectedImprovement(xi=xi)
        self.bootstrap = int(bootstrap)
        self.n_candidates = int(n_candidates)
        self.xs: List[np.ndarray] = []
        self.ys: List[float] = []
        self._rng = np.random.RandomState(seed)

    def _normalize(self, x: np.ndarray) -> np.ndarray:
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        return (x - lo) / np.maximum(hi - lo, 1e-12)

    def _denormalize(self, u: np.ndarray) -> np.ndarray:
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        return lo + u * (hi - lo)

    def register(self, x: Sequence[float], y: float) -> None:
        self.xs.append(self._normalize(np.asarray(x, np.float64)))
        self.ys.append(float(y))
        self.gp.fit(np.stack(self.xs), np.asarray(self.ys))

    @property
    def best(self) -> Tuple[np.ndarray, float]:
        """(knobs, score) of the best observation so far."""
        i = int(np.argmax(self.ys))
        return self._denormalize(self.xs[i]), self.ys[i]

    def suggest(self) -> np.ndarray:
        if len(self.xs) < self.bootstrap:
            return self._denormalize(self._rng.rand(self.bounds.shape[0]))
        cand = self._rng.rand(self.n_candidates, self.bounds.shape[0])
        ei = self.acq(self.gp, cand, best=max(self.ys))
        return self._denormalize(cand[int(np.argmax(ei))])


@dataclass
class CategoricalSweep:
    """Chained exhaustive sweep over discrete knobs — the
    ``CategoricalParameterChain`` half of the reference's
    ``ParameterManager`` split: categoricals are swept one value per
    scoring window (others held), best fixed before moving on;
    continuous knobs go to the jointly-BO'd half.

    ``names[i]`` has candidates ``values[i]``; ``values[i][0]`` must
    be what the system is ACTUALLY running when the sweep starts (the
    first window's score is attributed to it without an apply).

    Drive it with ``current()`` (the settings dict to run next) and
    ``observe(score)`` (returns True while the sweep is still live).
    """

    names: List[str]
    values: List[List]

    def __post_init__(self) -> None:
        if len(self.names) != len(self.values):
            raise ValueError("names/values length mismatch")
        for name, vals in zip(self.names, self.values):
            if not vals:
                raise ValueError(f"categorical {name!r} has no values")
        self._i = 0          # which param is being swept
        self._j = 0          # which value of that param
        self._scores: List[float] = []
        self._fixed: Dict[str, object] = {
            n: v[0] for n, v in zip(self.names, self.values)}
        self.done = not self.names

    def current(self) -> Dict[str, object]:
        """Settings to run for the NEXT scoring window."""
        out = dict(self._fixed)
        if not self.done:
            out[self.names[self._i]] = self.values[self._i][self._j]
        return out

    def observe(self, score: float) -> bool:
        """Record the window score for ``current()``.  Returns True
        while more sweep windows remain."""
        if self.done:
            return False
        self._scores.append(float(score))
        param = self.names[self._i]
        if self._j + 1 < len(self.values[self._i]):
            self._j += 1
            return True
        # This param's sweep is complete: pin its best value.
        best = int(np.argmax(self._scores))
        self._fixed[param] = self.values[self._i][best]
        self._scores = []
        self._j = 0
        self._i += 1
        self.done = self._i >= len(self.names)
        return not self.done

    @property
    def fixed(self) -> Dict[str, object]:
        """Best-so-far pinned values (all params once ``done``)."""
        return dict(self._fixed)
