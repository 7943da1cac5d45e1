"""The comparison that decides ``correct``.

Set-up drives the program's own train step from the seed through its
first three steps, on batches whose rows all differ, and reads from that
same object: each step's loss, the first gradient as the optimizer got it
(worked out from its state after one step), and, before a fourth step
runs, how far three steps moved every parameter and every running
statistic.  Once the window has closed and the program's state is freed,
the plain reference follows the same three steps from the same weights and
batches, and the two are compared.  The numbers:

* ``loss``: the largest gap of a step's loss, relative to the reference's;
* ``grad``: the worst leaf's gap between the program's norm of its first
  gradient and the reference's, over the reference's norm of that leaf or
  of the median leaf, whichever is larger;
* ``change``: the same, of the change after three steps.  A leaf whose
  reference gradient stays under a thousandth of the median leaf's in all
  three steps is left out (it moves by round-off alone); running
  statistics have no gradient and are always in;
* ``grad_median``, ``change_median``: the median leaf's gap, where the
  worst leaf's is noise (see ``PERF.md``: BatchNorm's scale and shift
  gradients are sums that nearly cancel);
* ``change.<kind>``, for a family that sorts its leaves into kinds
  (ResNet: convolutions, BatchNorm's scales, shifts, running means and
  running variances, the classifier): the worst leaf's change gap among
  the leaves of that kind, over the larger of the leaf's reference norm
  and the median of its kind's; ``change_median.<kind>``, the median
  leaf's.  So a kind the program leaves unmoved reads 1 on both whatever
  the other kinds do.

A configuration's ``correct_limits`` names the numbers compared for it,
each with its limit; the others are reported and not compared.  A stacked
tensor (the decoder's layers) counts as one leaf a layer.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

Named = Iterable[Tuple[str, torch.Tensor]]
#: Leaves whose largest reference gradient is under this share of the
#: median leaf's are left out of ``change``.
GRAD_FLOOR = 1e-3


@dataclasses.dataclass
class Readings:
    losses: List[float]
    grad: Dict[str, float]               # leaf -> norm of the first gradient
    change: Dict[str, float]             # leaf -> norm of the 3-step change
    grad_max: Optional[Dict[str, float]] = None  # reference: over 3 steps


def leaf_norms(named: Named, split: Callable) -> Dict[str, float]:
    out = {}
    for name, t in named:
        for leaf, v in split(name, t):
            out[leaf] = float(torch.linalg.vector_norm(v.detach().float()))
    return out


def change_norms(now: Named, initial: Named, split: Callable
                 ) -> Dict[str, float]:
    """Norms of ``now − initial``, leaf by leaf; ``initial`` is drawn
    lazily, one tensor at a time, in the same order as ``now``."""
    now = dict(now)
    out = {}
    for name, t0 in initial:
        for (leaf, v), (_, v0) in zip(split(name, now[name]),
                                      split(name, t0)):
            out[leaf] = float(torch.linalg.vector_norm(
                v.detach().float() - v0.float()))
        del t0
    return out


def program_readings(program, family, config: Dict, seed: int, device,
                     steps: int = 3) -> Readings:
    """The program's first ``steps`` steps on batches 0 .. steps−1."""
    losses, grad = [], None
    for i in range(steps):
        losses.append(float(program.step(i)))
        if i == 0:
            grad = leaf_norms(program.first_grads(), family.split)
    change = change_norms(program.state(),
                          family.initial_state(config, seed, device),
                          family.split)
    return Readings(losses, grad, change)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep=None) -> Dict[str, float]:
    """Leaf -> the gap of its norms over the larger of its reference norm
    and the median leaf's, over the leaves that ``keep`` keeps."""
    keys = [k for k in ref if keep is None or keep(k)]
    med = statistics.median(ref[k] for k in keys)
    gaps = {}
    for k in keys:
        p, den = prog.get(k, 0.0), max(ref[k], med)
        if not math.isfinite(p):
            gaps[k] = math.inf
        elif den > 0:
            gaps[k] = abs(p - ref[k]) / den
        else:
            gaps[k] = 0.0 if p == 0 else math.inf
    return gaps


def gaps_of(prog: Readings, ref: Readings,
            kinds: Optional[Dict[str, str]] = None
            ) -> Dict[str, Dict[str, float]]:
    """Each number's leaf gaps: ``grad``, ``change`` and, with ``kinds``
    (leaf -> kind), ``change.<kind>``."""
    med = statistics.median(ref.grad_max.values())

    def moved(k):
        return k not in ref.grad_max or ref.grad_max[k] >= GRAD_FLOOR * med

    out = {"grad": leaf_gaps(prog.grad, ref.grad),
           "change": leaf_gaps(prog.change, ref.change, moved)}
    for kind in sorted(set((kinds or {}).values())):
        out[f"change.{kind}"] = leaf_gaps(
            prog.change, ref.change,
            lambda k, kind=kind: moved(k) and kinds.get(k) == kind)
    return out


def compare(prog: Readings, ref: Readings,
            kinds: Optional[Dict[str, str]] = None) -> Dict[str, float]:
    """Every number of a run (see the module's docstring)."""
    loss = max((abs(p - r) / abs(r) if math.isfinite(p) else math.inf)
               for p, r in zip(prog.losses, ref.losses))
    gaps = gaps_of(prog, ref, kinds)
    out = {"loss": loss, "grad": max(gaps["grad"].values()),
           "change": max(gaps["change"].values()),
           "grad_median": statistics.median(gaps["grad"].values()),
           "change_median": statistics.median(gaps["change"].values())}
    for name, g in gaps.items():
        if name.startswith("change."):
            out[name] = max(g.values())
            out["change_median." + name.split(".", 1)[1]] = statistics.median(
                g.values())
    return out


def worst_leaves(prog: Readings, ref: Readings,
                 kinds: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Each worst-leaf number's leaf, for the look at a reading."""
    return {name: max(g, key=g.get)
            for name, g in gaps_of(prog, ref, kinds).items()}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """``(correct, {number: {value, limit}})`` over the numbers that
    ``limits`` names: correct when each is finite and within its limit."""
    checks = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
