"""Online serving autotuner — the reference ``ParameterManager``
driven from the engine's tick loop.

Enable with ``EngineConfig(autotune=True)``: after :meth:`warmup` the
engine installs an :class:`OnlineTuner` over the compile-safe knob
space :func:`~horovod_tpu_torch.tuning.params.online_knob_space` derives,
and every :meth:`~horovod_tpu_torch.serving.engine.InferenceEngine.step`
calls :meth:`OnlineTuner.on_tick` after the tick's work (outside the
step lock — applies re-acquire it, so the swap is a clean tick
boundary, the serving analogue of
``Controller::SynchronizeParameters``).

The reference phase machine, re-used shape for shape
(``parameter_manager.h:42-246``):

1. **warmup** — ``warmup_windows`` scoring windows discarded;
2. **sweep** — categorical knobs by chained exhaustive sweep
   (:class:`~horovod_tpu_torch.tuning.gp.CategoricalSweep`): one value per
   window, best pinned per knob;
3. **bo** — the joint integer box (``max_prefills_per_tick``, chunk
   budget) by GP + Expected Improvement for ``bo_samples`` windows;
4. **pinned** — frozen at the best constraint-satisfying sample
   (defaults, when nothing beat them).

Scoring is pure observation: one window = ``window_ticks`` WORKED
ticks (idle ticks don't advance it), scored from deltas of the
metrics the engine already keeps — ``tokens_generated`` per tick
(speculation's multiplier folds in automatically),
``serving_ttft_seconds{class=}`` windowed p99 (cumulative bucket
counts diffed at the window edges), and preemptions.  The weighted
objective carries per-class TTFT SLO constraints: a sample whose p99
exceeds its class SLO is penalized proportionally, and one beyond
``slo x (1 + guard_band)`` is ROLLED BACK — the last known-good
setting is re-applied immediately, the violating score still teaches
the GP where not to go.

Because every knob in the online space is admission/batching policy,
no sample can change emitted tokens (the engine's token-identity
invariant holds for any admission order) and no sample can compile
(the params.py contract) — tuning is oracle-safe and compile-stable
by construction, which ``tests/test_tuning.py`` enforces.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from horovod_tpu_torch.obs import tracing as obs_tracing
from horovod_tpu_torch.tuning.gp import BayesianOptimizer, CategoricalSweep
from horovod_tpu_torch.tuning.params import (
    KnobSpace,
    apply_settings,
    online_knob_space,
)

__all__ = ["Objective", "WindowStats", "OnlineTuner"]


@dataclass
class WindowStats:
    """What one scoring window observed (metric deltas)."""

    ticks: int
    tokens: int
    preemptions: int
    ttft_p99: Dict[str, float]    # class -> windowed p99 seconds
    spec_acceptance: Optional[float] = None

    @property
    def tokens_per_tick(self) -> float:
        return self.tokens / max(self.ticks, 1)


@dataclass
class Objective:
    """Weighted serving objective with per-class TTFT SLO constraints.

    ``score = tokens_per_tick
              - ttft_weight * sum_c max(0, p99_c - slo_c) / slo_c
              - preempt_weight * preemptions_per_tick``

    Speculation needs no term of its own: accepted drafts raise
    tokens_per_tick, wasted drafts lower it through slower ticks.
    ``score()`` also returns each class's fractional SLO excess so the
    tuner can apply its rollback guard band.
    """

    ttft_slo: Dict[str, float] = field(
        default_factory=lambda: {"interactive": 0.5})
    ttft_weight: float = 2.0
    preempt_weight: float = 0.5

    def score(self, w: WindowStats) -> Tuple[float, Dict[str, float]]:
        s = w.tokens_per_tick
        excess: Dict[str, float] = {}
        for cls, slo in self.ttft_slo.items():
            p99 = w.ttft_p99.get(cls)
            if p99 is None or slo <= 0:
                continue
            over = max(0.0, p99 - slo) / slo
            if over > 0:
                excess[cls] = over
                s -= self.ttft_weight * over
        s -= self.preempt_weight * (w.preemptions / max(w.ticks, 1))
        return s, excess


class _Window:
    """Baseline snapshot of the cumulative metrics a window diffs."""

    def __init__(self, metrics):
        self.metrics = metrics
        self.tokens = metrics.tokens_generated.value
        self.preempt = metrics.preemptions.value
        self.drafted = metrics.spec_drafted.value
        self.accepted = metrics.spec_accepted.value
        self.ttft = {key[0]: child.state()
                     for key, child in metrics.ttft.children()}

    @staticmethod
    def _p99(now: Dict, base: Optional[Dict]) -> Optional[float]:
        counts = list(now["counts"])
        if base is not None:
            counts = [a - b for a, b in zip(counts, base["counts"])]
        total = sum(counts)
        if not total:
            return None
        buckets = now["buckets"]
        rank, cum = 0.99 * total, 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= rank:
                return buckets[i] if i < len(buckets) else buckets[-1]
        return buckets[-1]

    def close(self, ticks: int) -> WindowStats:
        m = self.metrics
        p99 = {}
        for key, child in m.ttft.children():
            v = self._p99(child.state(), self.ttft.get(key[0]))
            if v is not None:
                p99[key[0]] = v
        drafted = m.spec_drafted.value - self.drafted
        acc = None
        if drafted > 0:
            acc = (m.spec_accepted.value - self.accepted) / drafted
        return WindowStats(
            ticks=ticks,
            tokens=m.tokens_generated.value - self.tokens,
            preemptions=m.preemptions.value - self.preempt,
            ttft_p99=p99, spec_acceptance=acc)


class OnlineTuner:
    """Tick-driven knob tuner over one engine's compile-safe space."""

    #: trajectory entries kept for /tuning (full history lives in the
    #: timeline instants)
    MAX_TRAJECTORY = 128

    def __init__(self, space: KnobSpace, *,
                 objective: Optional[Objective] = None,
                 window_ticks: int = 32, warmup_windows: int = 1,
                 bo_samples: int = 10, guard_band: float = 0.5,
                 seed: int = 0):
        self.space = space
        self.objective = objective or Objective()
        self.window_ticks = int(window_ticks)
        self.warmup_windows = int(warmup_windows)
        self.bo_samples = int(bo_samples)
        self.guard_band = float(guard_band)
        self._lock = threading.Lock()
        self._defaults = space.defaults()
        self._current: Dict[str, object] = dict(self._defaults)
        self._best: Tuple[Optional[float], Dict] = (None, dict(self._defaults))
        self._samples = 0
        self._rollbacks = 0
        self._discard = 0
        self._warmups_left = self.warmup_windows
        self._ticks = 0
        self._window: Optional[_Window] = None
        self._trajectory: List[Dict] = []
        self._sweep: Optional[CategoricalSweep] = None
        self._bo: Optional[BayesianOptimizer] = None
        self._bo_x: Optional[List[float]] = None
        sweep_knobs = space.sweep_knobs
        if sweep_knobs:
            self._sweep = CategoricalSweep(
                names=[k.name for k in sweep_knobs],
                values=[list(k.candidates) for k in sweep_knobs])
        bo_knobs = space.bo_knobs
        if bo_knobs:
            self._bo = BayesianOptimizer(
                bounds=[(float(k.bounds[0]), float(k.bounds[1]))
                        for k in bo_knobs], seed=seed)
        if not space.knobs:
            self.phase = "pinned"     # nothing tunable: inert
        elif self._warmups_left > 0:
            self.phase = "warmup"
        else:
            self.phase = "sweep" if self._sweep is not None else "bo"

    # -- installation -------------------------------------------------------

    @classmethod
    def install(cls, engine, **kw) -> "OnlineTuner":
        """Derive the compile-safe space from a WARMED engine, attach
        the tuner, return it.  Idempotent per engine."""
        if getattr(engine, "_tuner", None) is not None:
            return engine._tuner
        tuner = cls(online_knob_space(engine), **kw)
        engine._tuner = tuner
        return tuner

    # -- tick hook (called by InferenceEngine.step, outside its lock) -------

    def on_tick(self, engine, worked: bool) -> None:
        with self._lock:
            metrics = engine.metrics
            if self._window is None or self._window.metrics is not metrics:
                # First tick, or a benchmark swapped in a fresh
                # ServingMetrics: cumulative deltas against the old
                # object would go negative — restart the window.
                self._window = _Window(metrics)
                self._ticks = 0
                return
            if self.phase == "pinned" or not worked:
                return
            self._ticks += 1
            if self._ticks < self.window_ticks:
                return
            stats = self._window.close(self._ticks)
            self._window = _Window(metrics)
            self._ticks = 0
            self._advance(engine, stats)

    def reset_window(self) -> None:
        """Drop the current scoring window's baseline — called by the
        engine's supervised-restart path (``_recover``), so the first
        post-restart window starts from post-restart counters instead
        of scoring the crash (dead time, resume re-prefills, inflated
        TTFT) against whatever knob setting happened to be live."""
        with self._lock:
            self._window = None
            self._ticks = 0

    def _advance(self, engine, stats: WindowStats) -> None:
        metrics = engine.metrics
        if self.phase == "warmup":
            self._warmups_left -= 1
            if self._warmups_left <= 0:
                self.phase = "sweep" if self._sweep is not None else "bo"
                self._propose(engine)
            return
        if self._discard > 0:
            # Settling: requests admitted under the previous setting
            # are still in flight — this window's score would blend
            # two settings.
            self._discard -= 1
            return
        score, excess = self.objective.score(stats)
        self._samples += 1
        violated = any(v > self.guard_band for v in excess.values())
        metrics.tuning_samples.inc()
        metrics.tuning_objective.set(score)
        entry = {
            "sample": self._samples, "phase": self.phase,
            "settings": dict(self._current), "objective": round(score, 6),
            "tokens_per_tick": round(stats.tokens_per_tick, 4),
            "ttft_p99": {k: round(v, 6) for k, v in stats.ttft_p99.items()},
            "violated": violated,
        }
        self._trajectory.append(entry)
        del self._trajectory[:-self.MAX_TRAJECTORY]
        obs_tracing.instant("tuning.sample", {
            "sample": self._samples, "phase": self.phase,
            "objective": round(score, 6), "violated": violated,
            **{f"knob.{k}": v for k, v in self._current.items()}})
        if not violated and (self._best[0] is None or score > self._best[0]):
            self._best = (score, dict(self._current))
            metrics.tuning_best_objective.set(score)
        # Feed the active optimizer FIRST (a violating sample still
        # teaches the GP where not to go), then pick the next setting
        # — or roll back to known-good if this one breached the band.
        if self.phase == "sweep":
            assert self._sweep is not None
            alive = self._sweep.observe(score)
            if alive:
                self._apply(engine, self._sweep.current())
            else:
                pinned = self._sweep.fixed
                self._current.update(pinned)
                if self._bo is not None:
                    self.phase = "bo"
                    self._apply(engine, pinned)
                else:
                    self._pin(engine, extra=pinned)
        elif self.phase == "bo":
            assert self._bo is not None
            x = self._bo_x or [float(self._current[k.name])
                               for k in self.space.bo_knobs]
            self._bo.register(x, score)
            if len(self._bo.ys) >= self.bo_samples:
                self._pin(engine)
            else:
                self._propose(engine)
        if violated and self.phase != "pinned":
            self._rollback(engine, metrics)

    def _propose(self, engine) -> None:
        """Apply the next setting for the (new) current phase."""
        if self.phase == "sweep" and self._sweep is not None:
            self._apply(engine, self._sweep.current())
        elif self.phase == "bo" and self._bo is not None:
            if not self._bo.ys:
                # First BO window scores the settings ALREADY running
                # (the sweep's pinned categoricals + BO defaults) — the
                # reference credits the incumbent before exploring.
                self._bo_x = [float(self._current[k.name])
                              for k in self.space.bo_knobs]
                return
            u = self._bo.suggest()
            proposal = {k.name: u[i]
                        for i, k in enumerate(self.space.bo_knobs)}
            clamped = self.space.clamp(proposal)
            self._bo_x = [float(clamped[k.name])
                          for k in self.space.bo_knobs]
            self._apply(engine, clamped)

    def _apply(self, engine, settings: Dict[str, object]) -> None:
        settings = self.space.clamp(settings)
        changed = {k: v for k, v in settings.items()
                   if self._current.get(k) != v}
        self._current.update(settings)
        if not changed:
            return
        with engine._lock:   # tick boundary: step() is not mid-tick
            apply_settings(engine, changed)
        by_name = {k.name: k for k in self.space.knobs}
        self._discard = max(
            (by_name[n].discard_windows for n in changed if n in by_name),
            default=0)

    def _rollback(self, engine, metrics) -> None:
        """A sample breached an SLO constraint beyond the guard band:
        re-apply the last known-good settings NOW instead of waiting
        out another proposal cycle."""
        self._rollbacks += 1
        metrics.tuning_rollbacks.inc()
        good = self._best[1] if self._best[0] is not None \
            else dict(self._defaults)
        obs_tracing.instant("tuning.rollback", {
            "sample": self._samples,
            **{f"knob.{k}": v for k, v in good.items()}})
        self._apply(engine, dict(good))

    def _pin(self, engine, extra: Optional[Dict] = None) -> None:
        """Converge: freeze at the best constraint-satisfying sample."""
        best = dict(self._best[1])
        if extra:
            best.update({k: v for k, v in extra.items() if k not in best})
        self.phase = "pinned"
        self._apply(engine, best)
        obs_tracing.instant("tuning.pinned", {
            "samples": self._samples,
            "objective": self._best[0],
            **{f"knob.{k}": v for k, v in best.items()}})

    # -- introspection (GET /tuning, /stats) --------------------------------

    @property
    def converged(self) -> bool:
        return self.phase == "pinned"

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "phase": self.phase,
                "samples": self._samples,
                "rollbacks": self._rollbacks,
                "window_ticks": self.window_ticks,
                "current": dict(self._current),
                "best": {
                    "objective": self._best[0],
                    "settings": dict(self._best[1]),
                },
                "constraints": dict(self.objective.ttft_slo),
                "guard_band": self.guard_band,
                "space": self.space.describe(),
                "trajectory": list(self._trajectory),
            }
