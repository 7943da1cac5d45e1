"""Typed process-wide metrics registry with Prometheus text exposition.

A verbatim copy of ``horovod_tpu/obs/registry.py`` (stdlib only): the
port keeps its own copy because importing anything from ``horovod_tpu``
loads JAX.  The references to the JAX package below describe the
original.

The reference exposes its runtime state as free-form timeline events and
ad-hoc counters; production serving (ROADMAP north star) needs the other
two legs of observability: *scrapeable* metrics in a standard format and
one place where every subsystem's instruments live.  This module is that
place — deliberately dependency-free (stdlib only) so every layer
(serving engine, training loop, elastic supervisor, timeline) can
register instruments without import cycles.

Design:

* **Instruments** — :class:`Counter` (monotonic), :class:`Gauge`
  (set-to-value), :class:`Histogram` (fixed buckets + implicit +Inf
  overflow; constant memory forever).  All thread-safe: they are updated
  from engine/watchdog/notification threads and read from HTTP handler
  threads.
* **Families** — a metric created with ``labels=(...)`` is a family;
  :meth:`_Family.labels` returns the per-labelset child instrument
  (created lazily, cached).
* **Registry** — maps *unique* names to instruments.  Duplicate
  registration raises :class:`DuplicateMetricError` (the classic
  copy-paste bug where two subsystems silently share a counter);
  idempotent create-or-fetch is explicit via ``exist_ok=True`` and still
  type-checks the existing entry.
* **Exposition** — :meth:`MetricsRegistry.to_prometheus` renders the
  Prometheus text format (0.0.4): ``# HELP`` / ``# TYPE`` headers,
  cumulative ``_bucket{le=...}`` series + ``_sum`` / ``_count`` for
  histograms.  :meth:`MetricsRegistry.snapshot` is the JSON-friendly
  view ``/stats``-style endpoints serve.

Two registry scopes exist on purpose: each serving engine owns a private
registry (its lifetime — tests and benchmarks create many engines per
process), while process-wide training/elastic/timeline metrics live in
:func:`default_registry`.  ``ServingServer``'s ``/metrics`` renders
both, so one scrape covers serving, training, and elastic families.
"""

from __future__ import annotations

import re
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "DuplicateMetricError", "default_registry",
    "training_metrics", "elastic_metrics",
    "DEFAULT_LATENCY_BUCKETS", "TICK_PHASE_BUCKETS",
]


class DuplicateMetricError(ValueError):
    """A metric with this name is already registered (or exists with a
    different type/label set than the one requested)."""


_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


class Counter:
    """Monotonic counter."""

    def __init__(self) -> None:
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: Union[int, float] = 1) -> None:
        if n < 0:
            raise ValueError(f"counters only go up (inc by {n})")
        with self._lock:
            self._v += n

    @property
    def value(self) -> Union[int, float]:
        return self._v


class Gauge:
    """Instantaneous value."""

    def __init__(self) -> None:
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._v -= n

    @property
    def value(self) -> float:
        return self._v


# Latency buckets in seconds: 1ms .. 60s, roughly x2.5 per step — wide
# enough for CPU-smoke ticks and TPU production alike.
DEFAULT_LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

# Tick-phase buckets extend down to 10us: an async dispatch (and a
# fully-hidden device wait) is sub-millisecond, which the request-level
# buckets above cannot resolve.
TICK_PHASE_BUCKETS = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
) + DEFAULT_LATENCY_BUCKETS


class Histogram:
    """Fixed-bucket histogram with an implicit +Inf overflow bucket.

    Percentiles come from the cumulative bucket counts (the
    Prometheus-style estimate: the reported pN is the upper edge of the
    bucket containing the N-th percentile observation), which keeps
    memory constant no matter how long the server runs.
    """

    def __init__(self, buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        self.buckets: List[float] = sorted(float(b) for b in buckets)
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        i = 0
        while i < len(self.buckets) and v > self.buckets[i]:
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def mean(self) -> Optional[float]:
        return self._sum / self._count if self._count else None

    def _percentile(self, counts: List[int], total: int,
                    q: float) -> Optional[float]:
        if not total:
            return None
        rank = q * total
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= rank:
                return self.buckets[i] if i < len(self.buckets) \
                    else self.buckets[-1]
        return self.buckets[-1]

    def percentile(self, q: float) -> Optional[float]:
        """Upper edge of the bucket holding the q-quantile observation
        (q in [0, 1]); None when empty.

        Edge semantics (docs/observability.md "Percentile semantics"),
        relied on by fleet-merged p99s — these are *bucket estimates*,
        not exact quantiles:

        * the returned value is always a configured bucket **upper
          edge** — an observation of 1.5 in buckets (1, 2, 4) reports
          as 2;
        * an observation exactly **on** an edge belongs to that edge's
          bucket (``observe`` advances while ``v > edge``), so
          ``observe(2.0)`` → ``percentile(1.0) == 2``;
        * quantiles landing in the **+Inf overflow bucket report the
          largest finite edge** (the histogram cannot know how far past
          it the tail went) — a merged p99 equal to the top edge means
          "at least this", not "exactly this";
        * ``q == 0`` reports the smallest configured edge (whether or
          not that bucket holds any mass) — a floor, not a minimum.
        """
        with self._lock:
            counts, total = list(self._counts), self._count
        return self._percentile(counts, total, q)

    def state(self) -> Dict:
        """The mergeable raw state under ONE lock hold: bucket edges,
        per-bucket (non-cumulative) counts including the trailing +Inf
        overflow, sum, and count — the wire format
        :mod:`horovod_tpu.obs.aggregate` merges bucket-wise across
        ranks."""
        with self._lock:
            return {
                "buckets": list(self.buckets),
                "counts": list(self._counts),
                "sum": self._sum,
                "count": self._count,
            }

    def snapshot(self) -> Dict:
        # One locked copy; count/sum/buckets AND percentiles all
        # describe the same population (an observe() racing /stats must
        # not split them).
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        return {
            "count": total,
            "sum": round(s, 6),
            "mean": round(s / total, 6) if total else None,
            "p50": self._percentile(counts, total, 0.50),
            "p99": self._percentile(counts, total, 0.99),
            "buckets": {
                ("%g" % b): c for b, c in zip(self.buckets, counts)
            } | {"+Inf": counts[-1]},
        }

    def cumulative(self) -> Tuple[List[int], int, float]:
        """(cumulative per-bucket counts incl. +Inf, count, sum) under
        one lock hold — the Prometheus ``_bucket{le=...}`` series."""
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        cum, acc = [], 0
        for c in counts:
            acc += c
            cum.append(acc)
        return cum, total, s


class _Family:
    """A labeled metric family: one child instrument per label-value
    tuple, created lazily and cached forever (label cardinality is the
    caller's responsibility, as in Prometheus clients)."""

    def __init__(self, make, labelnames: Sequence[str]):
        self._make = make
        self.labelnames: Tuple[str, ...] = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    def labels(self, **kv):
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"expected labels {self.labelnames}, got {tuple(kv)}")
        key = tuple(str(kv[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make()
            return child

    def children(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())


class _Entry:
    __slots__ = ("kind", "help", "labelnames", "obj")

    def __init__(self, kind, help, labelnames, obj):
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self.obj = obj


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(names: Sequence[str], values: Sequence[str],
                extra: Sequence[Tuple[str, str]] = ()) -> str:
    pairs = [f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{_escape_label(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _fmt_value(v) -> str:
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


class MetricsRegistry:
    """Name -> instrument map with duplicate detection, lock-safe
    snapshots, and Prometheus text exposition."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: Dict[str, _Entry] = {}

    # -- creation ----------------------------------------------------------

    def _create(self, name: str, kind: str, make, help: str,
                labels: Sequence[str], exist_ok: bool):
        if not _METRIC_NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for l in labels:
            if not _LABEL_NAME_RE.match(l):
                raise ValueError(f"invalid label name {l!r}")
        with self._lock:
            e = self._entries.get(name)
            if e is not None:
                if (exist_ok and e.kind == kind
                        and e.labelnames == tuple(labels)):
                    return e.obj
                raise DuplicateMetricError(
                    f"metric {name!r} already registered as {e.kind} "
                    f"with labels {e.labelnames} "
                    f"(requested {kind} with labels {tuple(labels)}"
                    f"{'' if exist_ok else '; pass exist_ok=True to share'})")
            obj = _Family(make, labels) if labels else make()
            self._entries[name] = _Entry(kind, help, labels, obj)
            return obj

    def counter(self, name: str, help: str = "", *,
                labels: Sequence[str] = (), exist_ok: bool = False):
        """Create and register a :class:`Counter` (or a counter family
        when ``labels`` is non-empty)."""
        return self._create(name, "counter", Counter, help, labels, exist_ok)

    def gauge(self, name: str, help: str = "", *,
              labels: Sequence[str] = (), exist_ok: bool = False):
        return self._create(name, "gauge", Gauge, help, labels, exist_ok)

    def histogram(self, name: str, help: str = "", *,
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
                  labels: Sequence[str] = (), exist_ok: bool = False):
        return self._create(name, "histogram",
                            lambda: Histogram(buckets=buckets),
                            help, labels, exist_ok)

    # -- introspection -----------------------------------------------------

    def get(self, name: str):
        """The registered instrument/family, or None."""
        with self._lock:
            e = self._entries.get(name)
        return e.obj if e is not None else None

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)

    def _series(self, e: _Entry) -> Iterable[Tuple[Tuple[str, ...], object]]:
        if e.labelnames:
            return e.obj.children()
        return [((), e.obj)]

    def snapshot(self) -> Dict:
        """JSON-friendly view: scalar for counters/gauges, the
        histogram snapshot dict for histograms; labeled families map
        ``label="value"`` series keys to the same."""
        with self._lock:
            entries = sorted(self._entries.items())
        out: Dict = {}
        for name, e in entries:
            def one(inst):
                if e.kind == "histogram":
                    return inst.snapshot()
                return inst.value
            if e.labelnames:
                out[name] = {
                    ",".join(f'{n}="{v}"' for n, v in zip(e.labelnames, key)):
                        one(inst)
                    for key, inst in self._series(e)
                }
            else:
                out[name] = one(e.obj)
        return out

    def export(self) -> Dict:
        """Typed, mergeable JSON view — the fleet-aggregation wire
        format (:mod:`horovod_tpu.obs.aggregate`).  Unlike
        :meth:`snapshot` (which flattens to /stats-friendly scalars and
        loses the instrument kind), this keeps everything a remote
        merger needs: kind, help, label names, and per-series values —
        histograms as raw ``{buckets, counts, sum, count}`` state so
        they merge bucket-wise::

            {name: {"kind": "counter"|"gauge"|"histogram",
                    "help": ..., "labels": [...],
                    "series": [{"l": {label: value}, "v": scalar}
                               | {"l": {...}, "h": histogram_state}]}}
        """
        with self._lock:
            entries = sorted(self._entries.items())
        out: Dict = {}
        for name, e in entries:
            series = []
            for key, inst in self._series(e):
                s: Dict = {"l": dict(zip(e.labelnames, key))}
                if e.kind == "histogram":
                    s["h"] = inst.state()
                else:
                    s["v"] = inst.value
                series.append(s)
            out[name] = {"kind": e.kind, "help": e.help,
                         "labels": list(e.labelnames), "series": series}
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4 for every registered
        metric (serve with content type
        ``text/plain; version=0.0.4``)."""
        with self._lock:
            entries = sorted(self._entries.items())
        lines: List[str] = []
        for name, e in entries:
            if e.help:
                lines.append(f"# HELP {name} {_escape_help(e.help)}")
            lines.append(f"# TYPE {name} {e.kind}")
            for key, inst in self._series(e):
                labels = _fmt_labels(e.labelnames, key)
                if e.kind == "histogram":
                    cum, total, s = inst.cumulative()
                    for edge, c in zip(inst.buckets, cum):
                        le = _fmt_labels(e.labelnames, key,
                                         extra=[("le", "%g" % edge)])
                        lines.append(f"{name}_bucket{le} {c}")
                    le = _fmt_labels(e.labelnames, key,
                                     extra=[("le", "+Inf")])
                    lines.append(f"{name}_bucket{le} {total}")
                    lines.append(f"{name}_sum{labels} {_fmt_value(s)}")
                    lines.append(f"{name}_count{labels} {total}")
                else:
                    lines.append(f"{name}{labels} {_fmt_value(inst.value)}")
        return "\n".join(lines) + "\n" if lines else ""


# -- process-wide default registry -------------------------------------------

_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry: training, elastic, eager-runtime, and
    timeline metrics live here.  Serving engines keep private
    registries (one per engine lifetime); ``/metrics`` renders both."""
    return _default


class _Namespace:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def training_metrics(registry: Optional[MetricsRegistry] = None) -> _Namespace:
    """Create-or-fetch the training metric family: step time, step
    count, XLA compile events (labeled by instrumented function), the
    last-step-duration gauge (rides the elastic heartbeat payload so
    the driver's straggler detector sees per-rank step time), and the
    live MFU gauge (set by ``obs.training_step`` once
    :func:`horovod_tpu.obs.xprof.set_training_cost` told it the step's
    FLOPs).  Idempotent — every caller gets the same instruments."""
    r = registry if registry is not None else _default
    return _Namespace(
        step_time=r.histogram(
            "training_step_seconds",
            "Wall-clock duration of one training step "
            "(horovod_tpu.obs.training_step)", exist_ok=True),
        steps=r.counter(
            "training_steps_total",
            "Training steps completed", exist_ok=True),
        last_step=r.gauge(
            "training_last_step_seconds",
            "Wall-clock duration of the most recent training step "
            "(published in the elastic heartbeat payload)",
            exist_ok=True),
        mfu=r.gauge(
            "training_mfu",
            "Live model-FLOPs utilization of the last training step "
            "(step FLOPs / step seconds / chip peak; requires "
            "obs.xprof.set_training_cost)", exist_ok=True),
        compiles=r.counter(
            "xla_compiles_total",
            "XLA trace/compile events observed at instrumented jit sites",
            labels=("fn",), exist_ok=True),
    )


def elastic_metrics(registry: Optional[MetricsRegistry] = None) -> _Namespace:
    """Create-or-fetch the elastic metric family: supervised restarts,
    re-rendezvous count + current epoch, and the worker-side
    commit/rollback counters.  Idempotent."""
    r = registry if registry is not None else _default
    return _Namespace(
        restarts=r.counter(
            "elastic_restarts_total",
            "Elastic restarts (driver resets + worker-side retries)",
            exist_ok=True),
        rendezvous=r.counter(
            "elastic_rendezvous_total",
            "Rendezvous epochs started (driver) / re-inits (worker)",
            exist_ok=True),
        rendezvous_epoch=r.gauge(
            "elastic_rendezvous_epoch",
            "Current rendezvous epoch", exist_ok=True),
        commits=r.counter(
            "elastic_commits_total",
            "State.commit() calls (committed-consistent boundaries)",
            exist_ok=True),
        rollbacks=r.counter(
            "elastic_rollbacks_total",
            "State.rollback() calls (uncommitted steps discarded)",
            exist_ok=True),
    )
