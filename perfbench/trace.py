"""The traced stretch: a few steady steps under ``torch.profiler``, reduced
to what ran on the card and when.

The stretch is timed twice: by CUDA events around it (``window_s``) and by
the union of the device intervals the profiler recorded (``busy_s``).  The
profiler's own span (first start to last end) is kept beside the events'
time, so that a trace that lost records shows as a span shorter than the
events' window.
"""

from __future__ import annotations

import dataclasses
import re
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

Interval = Tuple[float, float]
#: Gaps labelled one by one, longest first; the rest are summed as one.
LABELLED_GAPS = 500
#: Steps run under a profiler before the traced ones, and dropped.
PROFILER_WARMUP = 2


@dataclasses.dataclass
class TraceStats:
    """Device records of the stretch, in seconds from its first record."""

    kernels: List[Tuple[str, float, float]]  # (name, start, end)
    host: List[Tuple[str, float, float]]     # host ranges and operators
    window_s: float                          # CUDA events around the stretch
    steps: int

    @property
    def busy_s(self) -> float:
        return union_length([(s, e) for _, s, e in self.kernels])

    @property
    def span_s(self) -> float:
        if not self.kernels:
            return 0.0
        return max(e for _, _, e in self.kernels) - min(
            s for _, s, _ in self.kernels)

    def seconds_matching(self, pattern: str) -> Tuple[float, int]:
        """Total device time and count of the records whose name matches
        ``pattern`` (a regular expression, searched)."""
        rx = re.compile(pattern)
        hits = [e - s for name, s, e in self.kernels if rx.search(name)]
        return sum(hits), len(hits)

    def idle_share(self) -> Optional[float]:
        if not self.kernels or self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def breakdown(self, labelled: "TraceStats" = None,
                  top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the idle gaps of
        ``labelled`` (a stretch traced with the host's operators; default
        this one) summed by the innermost host range or operator open at
        each gap's middle."""
        labelled = labelled or self
        by_name: Dict[str, float] = defaultdict(float)
        for name, s, e in self.kernels:
            by_name[name[:160]] += e - s
        gaps: Dict[str, float] = defaultdict(float)
        found = sorted(idle_gaps([(s, e) for _, s, e in labelled.kernels]),
                       key=lambda g: g[0] - g[1])
        starts = np.array([s for _, s, _ in labelled.host])
        ends = np.array([e for _, _, e in labelled.host])
        for n, (a, b) in enumerate(found):
            if n >= LABELLED_GAPS:
                gaps["shorter gaps"] += b - a
                continue
            mid = (a + b) / 2
            open_ = np.nonzero((starts <= mid) & (ends >= mid))[0]
            label = (labelled.host[open_[np.argmin(ends[open_] -
                                                   starts[open_])]][0]
                     if len(open_) else "no host range")
            gaps[label[:160]] += b - a

        def order(d):
            return sorted(d.items(), key=lambda kv: -kv[1])[:top]

        return {"device_ops": [[k, v] for k, v in order(by_name)],
                "idle_gaps": [[k, v] for k, v in order(gaps)]}


def merged(intervals: List[Interval]) -> List[Interval]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_length(intervals: List[Interval]) -> float:
    return sum(e - s for s, e in merged(intervals))


def idle_gaps(intervals: List[Interval]) -> List[Interval]:
    m = merged(intervals)
    return [(m[i][1], m[i + 1][0]) for i in range(len(m) - 1)
            if m[i + 1][0] > m[i][1]]


def _records(prof):
    """``(device records, host records)`` as (name, start s, end s)."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        rec = (e.name, tr.start / 1e6, tr.end / 1e6)
        if e.device_type == DeviceType.CUDA:
            annotation = getattr(e, "is_user_annotation", False)
            if not annotation and tr.end > tr.start:
                dev.append(rec)
        else:
            host.append(rec)
    t0 = min((s for _, s, _ in dev), default=0.0)
    shift = lambda recs: [(n, s - t0, e - t0) for n, s, e in recs]
    return shift(dev), shift(host)


def trace_stretch(step: Callable[[int], torch.Tensor], first: int,
                  steps: int, clock, device,
                  host_ops: bool = False) -> TraceStats:
    """Run ``steps`` steps from ``first`` under the profiler, after
    :data:`PROFILER_WARMUP` steps under a profiler of their own, dropped
    (the profiler's start): on a card its kernels, copies and fills alone
    (recording every host operator slows an eager step, and so inflates
    the card's idle share), with ``host_ops`` the host's operators and
    ranges as well."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CUDA] if cuda else []
    if host_ops or not cuda:
        acts.append(ProfilerActivity.CPU)
    with profile(activities=acts):
        for i in range(PROFILER_WARMUP):
            step(first + i)
        clock.sync()
    with profile(activities=acts) as prof:
        start = clock.mark()
        for i in range(PROFILER_WARMUP, PROFILER_WARMUP + steps):
            with record_function("bench.step"):
                step(first + i)
        end = clock.mark()
        clock.sync()
    dev, host = _records(prof)
    return TraceStats(dev, host, clock.ms(start, end) / 1e3, steps)
