"""The measured window: every step the program runs for ``--seconds``, and
the statistics taken over all of them.

A step's time is the interval between two marks on the device's timeline
(CUDA events recorded at the step boundaries), so a host stall that
starves the card lengthens the step it delays.  The host never runs more
than two steps ahead of the card, as a training loop that reads its loss
does.  The rate is all the work of the window over all of its time on the
host's clock, from a synchronised start to the synchronised end of the
last step.  On more than one rank every rank runs the same steps: rank 0
names the last one (:class:`Agreement`).
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Dict, List

import torch


class CudaClock:
    """Marks on the card's timeline."""

    def __init__(self, device):
        self.device = device

    def mark(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    @staticmethod
    def wait(mark) -> None:
        mark.synchronize()

    @staticmethod
    def ms(a, b) -> float:
        return a.elapsed_time(b)

    def sync(self) -> None:
        torch.cuda.synchronize(self.device)


class HostClock:
    """Marks on the host's clock, where there is no card (the CPU tests)."""

    @staticmethod
    def mark():
        return time.perf_counter()

    @staticmethod
    def wait(mark) -> None:
        pass

    @staticmethod
    def ms(a, b) -> float:
        return (b - a) * 1e3

    @staticmethod
    def sync() -> None:
        pass


def clock_for(device) -> object:
    return CudaClock(device) if torch.device(device).type == "cuda" \
        else HostClock()


@dataclasses.dataclass
class WindowStats:
    steps: int
    seconds: float
    step_ms: List[float]
    items_per_step: Dict[str, int]
    nonfinite: int

    def rate(self, item: str):
        n = self.items_per_step.get(item)
        return None if n is None else n * self.steps / self.seconds

    def step_ms_p95(self) -> float:
        return p95(self.step_ms)


def p95(values: List[float]) -> float:
    """The 95th percentile, interpolated between the nearest ranks (as
    numpy's default)."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=20, method="inclusive")[18]


class Agreement:
    """The window's last step, the same on every rank: once its time is up,
    rank 0 names a step a few past its own in a store (a
    ``torch.distributed.Store``) that the other ranks read after each
    step.  The ranks' collectives keep them within a step or two of each
    other, well inside the margin; a rank already past it (ranks that
    exchange nothing run apart) stops where it is."""

    KEY = "perfbench_window_end"
    MARGIN = 8

    def __init__(self, store, rank: int):
        self.store, self.rank, self.end = store, rank, None

    def done(self, n: int, time_up: bool) -> bool:
        if self.end is None:
            if self.rank == 0:
                if time_up:
                    self.end = n + self.MARGIN
                    self.store.set(self.KEY, str(self.end))
            elif self.store.check([self.KEY]):
                self.end = int(self.store.get(self.KEY))
        return self.end is not None and n >= self.end


def run_window(step: Callable[[int], torch.Tensor], seconds: float, clock,
               items_per_step: Dict[str, int], first: int = 0,
               ahead: int = 2, agreement: Agreement = None) -> WindowStats:
    """Call ``step(first), step(first + 1), ...`` until ``seconds`` have
    passed on the host's clock, or with ``agreement`` until the agreed
    last step; each returns its loss on the device."""
    clock.sync()
    marks = [clock.mark()]
    losses = []
    t0 = time.perf_counter()
    n = 0
    while True:
        losses.append(step(first + n))
        marks.append(clock.mark())
        n += 1
        if n > ahead:
            clock.wait(marks[n - ahead])
        time_up = time.perf_counter() - t0 >= seconds
        if agreement.done(n, time_up) if agreement else time_up:
            break
    clock.sync()
    elapsed = time.perf_counter() - t0
    step_ms = [clock.ms(marks[i], marks[i + 1]) for i in range(n)]
    nonfinite = int((~torch.isfinite(torch.stack(
        [l.detach().float().reshape(()) for l in losses]))).sum())
    return WindowStats(n, elapsed, step_ms, dict(items_per_step), nonfinite)
