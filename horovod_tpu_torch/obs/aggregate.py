"""Cross-rank metric aggregation: merge per-rank registry exports into
one fleet view.

A copy of ``horovod_tpu/obs/aggregate.py`` (standard library only, its
imports renamed to the port's): the port keeps its own because
importing anything from ``horovod_tpu`` loads JAX.
``tests/test_torch_port_tracing.py`` holds it to the original,
code for code.

Horovod's cross-rank timeline existed because per-worker views hide
exactly the failures that matter at fleet scale — negotiation stalls
and stragglers (Sergeev & Del Balso, 2018).  The metrics analogue: each
elastic worker publishes its registry's mergeable export
(:meth:`~horovod_tpu_torch.obs.registry.MetricsRegistry.export`) over the
rendezvous KV, and the driver merges them here into ONE scrape target.

Merge semantics, by instrument kind:

* **counters** sum across ranks per label-set (the Prometheus
  federation convention — a fleet-total counter is the only counter
  that means anything);
* **gauges** cannot be summed meaningfully (occupancy, epoch, skew…),
  so every rank's series is kept, re-labeled with ``rank=``/``host=``,
  PLUS a cross-rank roll-up: ``<name>_min`` / ``<name>_median`` /
  ``<name>_max`` synthetic gauges per label-set;
* **histograms** merge bucket-wise — per-bucket counts, sum, and count
  add — which is exact (no quantile-of-quantiles estimation error),
  but REQUIRES identical bucket edges on every rank: a mismatch raises
  the typed :class:`BucketMismatchError` rather than silently
  producing garbage percentiles.

A kind disagreement between ranks (one rank says counter, another says
gauge for the same family — a version-skew smell) raises the typed
:class:`MergeConflictError`.

Percentiles over merged histograms inherit the single-histogram edge
semantics (see :meth:`~horovod_tpu_torch.obs.registry.Histogram.percentile`):
values land on bucket upper edges, and a quantile falling in the +Inf
overflow reports the largest finite edge.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

from horovod_tpu_torch.obs.registry import (
    Histogram,
    _escape_help,
    _fmt_labels,
    _fmt_value,
)

__all__ = [
    "MergeConflictError", "BucketMismatchError", "FleetAggregate",
    "merge_exports", "merged_histogram",
]


class MergeConflictError(ValueError):
    """Two ranks exported the same family name with different kinds or
    label names — aggregation refuses to guess."""


class BucketMismatchError(MergeConflictError):
    """Two ranks exported the same histogram family with different
    bucket edges; bucket-wise merging would silently mis-bin, so this
    is a typed error instead."""


def merged_histogram(states: List[Dict]) -> Histogram:
    """Bucket-wise merge of :meth:`Histogram.state` dicts into one
    (in-memory) :class:`Histogram` — counts, sum, and count add; edges
    must agree (:class:`BucketMismatchError` otherwise)."""
    if not states:
        raise ValueError("nothing to merge")
    edges = list(states[0]["buckets"])
    h = Histogram(buckets=edges)
    for st in states:
        if list(st["buckets"]) != edges:
            raise BucketMismatchError(
                f"histogram bucket edges differ across ranks: "
                f"{edges} vs {list(st['buckets'])}")
        counts = list(st["counts"])
        if len(counts) != len(edges) + 1:
            raise BucketMismatchError(
                f"histogram has {len(counts)} buckets for "
                f"{len(edges)} edges (expected {len(edges) + 1})")
        for i, c in enumerate(counts):
            h._counts[i] += int(c)
        h._sum += float(st["sum"])
        h._count += int(st["count"])
    return h


def _series_key(labels: Mapping[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _MergedFamily:
    __slots__ = ("kind", "help", "labelnames", "per_rank")

    def __init__(self, kind: str, help: str, labelnames: List[str]):
        self.kind = kind
        self.help = help
        self.labelnames = list(labelnames)
        # series-key -> rank -> scalar value | histogram state
        self.per_rank: Dict[Tuple, Dict[str, object]] = {}


class FleetAggregate:
    """The merged view of many ranks' registry exports.

    Build with :func:`merge_exports`; consume via :meth:`to_prometheus`
    (the fleet scrape body, ``rank``/``host``-labeled) or
    :meth:`snapshot` (the ``/fleet`` JSON view)."""

    def __init__(self, hosts: Optional[Mapping[str, str]] = None):
        self._fams: Dict[str, _MergedFamily] = {}
        self._hosts: Dict[str, str] = dict(hosts or {})
        self.ranks: List[str] = []

    # -- building ----------------------------------------------------------

    def add(self, rank, export: Mapping[str, Dict],
            host: Optional[str] = None) -> None:
        """Fold one rank's registry export in.  ``rank`` becomes the
        ``rank=`` label value; ``host`` (optional) the ``host=``
        label."""
        rank = str(rank)
        if rank not in self.ranks:
            self.ranks.append(rank)
        if host is not None:
            self._hosts[rank] = str(host)
        for name, fam in export.items():
            kind = fam.get("kind")
            labelnames = list(fam.get("labels", ()))
            mf = self._fams.get(name)
            if mf is None:
                mf = self._fams[name] = _MergedFamily(
                    kind, fam.get("help", ""), labelnames)
            elif mf.kind != kind or mf.labelnames != labelnames:
                raise MergeConflictError(
                    f"family {name!r} disagrees across ranks: "
                    f"{mf.kind}{mf.labelnames} vs {kind}{labelnames}")
            for s in fam.get("series", ()):
                key = _series_key(s.get("l", {}))
                slot = mf.per_rank.setdefault(key, {})
                slot[rank] = s["h"] if kind == "histogram" else s["v"]

    # -- consumption -------------------------------------------------------

    def _merged_series(self, mf: _MergedFamily):
        """Yield (series_key, merged_value) where merged_value is the
        summed counter, the merged Histogram, or (for gauges) the
        per-rank dict."""
        for key in sorted(mf.per_rank):
            ranks = mf.per_rank[key]
            if mf.kind == "counter":
                yield key, sum(ranks.values())
            elif mf.kind == "histogram":
                yield key, merged_histogram(
                    [ranks[r] for r in sorted(ranks)])
            else:
                yield key, ranks

    @staticmethod
    def _gauge_rollup(values: List[float]) -> Dict[str, float]:
        import statistics

        vs = [float(v) for v in values]
        return {"min": min(vs), "median": statistics.median(vs),
                "max": max(vs)}

    def snapshot(self) -> Dict:
        """JSON-friendly merged view (the ``/fleet`` ``metrics`` key):
        counters as fleet sums, gauges as ``{per_rank, min, median,
        max}``, histograms as the merged
        :meth:`~horovod_tpu_torch.obs.registry.Histogram.snapshot`."""
        out: Dict = {}
        for name in sorted(self._fams):
            mf = self._fams[name]
            fam_out: Dict = {}
            for key, merged in self._merged_series(mf):
                skey = ",".join(f'{k}="{v}"' for k, v in key) or "_"
                if mf.kind == "counter":
                    fam_out[skey] = merged
                elif mf.kind == "histogram":
                    fam_out[skey] = merged.snapshot()
                else:
                    per_rank = {r: v for r, v in sorted(merged.items())}
                    fam_out[skey] = {
                        "per_rank": per_rank,
                        **self._gauge_rollup(list(per_rank.values())),
                    }
            out[name] = fam_out if mf.labelnames else \
                fam_out.get("_", fam_out)
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition (0.0.4) of the fleet view:
        counters summed, each gauge series per rank with
        ``rank``/``host`` labels plus ``_min``/``_median``/``_max``
        roll-up gauges, histograms merged bucket-wise."""
        lines: List[str] = []
        for name in sorted(self._fams):
            mf = self._fams[name]
            if mf.kind == "counter":
                self._emit_counter(lines, name, mf)
            elif mf.kind == "histogram":
                self._emit_histogram(lines, name, mf)
            else:
                self._emit_gauge(lines, name, mf)
        return "\n".join(lines) + "\n" if lines else ""

    def _head(self, lines, name, kind, help):
        if help:
            lines.append(f"# HELP {name} {_escape_help(help)}")
        lines.append(f"# TYPE {name} {kind}")

    def _emit_counter(self, lines, name, mf) -> None:
        self._head(lines, name, "counter", mf.help)
        for key, total in self._merged_series(mf):
            labels = _fmt_labels([k for k, _ in key], [v for _, v in key])
            lines.append(f"{name}{labels} {_fmt_value(total)}")

    def _rank_extra(self, rank: str):
        extra = [("rank", rank)]
        host = self._hosts.get(rank)
        if host is not None:
            extra.append(("host", host))
        return extra

    def _emit_gauge(self, lines, name, mf) -> None:
        self._head(lines, name, "gauge", mf.help)
        rollups: List[Tuple[Tuple, Dict[str, float]]] = []
        for key, ranks in self._merged_series(mf):
            names = [k for k, _ in key]
            values = [v for _, v in key]
            for rank in sorted(ranks, key=lambda r: (len(r), r)):
                labels = _fmt_labels(names, values,
                                     extra=self._rank_extra(rank))
                lines.append(f"{name}{labels} {_fmt_value(ranks[rank])}")
            rollups.append((key, self._gauge_rollup(
                list(ranks.values()))))
        for stat in ("min", "median", "max"):
            self._head(lines, f"{name}_{stat}", "gauge",
                       f"Cross-rank {stat} of {name}" if mf.help else "")
            for key, roll in rollups:
                labels = _fmt_labels([k for k, _ in key],
                                     [v for _, v in key])
                lines.append(
                    f"{name}_{stat}{labels} {_fmt_value(roll[stat])}")

    def _emit_histogram(self, lines, name, mf) -> None:
        self._head(lines, name, "histogram", mf.help)
        for key, h in self._merged_series(mf):
            names = [k for k, _ in key]
            values = [v for _, v in key]
            labels = _fmt_labels(names, values)
            cum, total, s = h.cumulative()
            for edge, c in zip(h.buckets, cum):
                le = _fmt_labels(names, values, extra=[("le", "%g" % edge)])
                lines.append(f"{name}_bucket{le} {c}")
            le = _fmt_labels(names, values, extra=[("le", "+Inf")])
            lines.append(f"{name}_bucket{le} {total}")
            lines.append(f"{name}_sum{labels} {_fmt_value(s)}")
            lines.append(f"{name}_count{labels} {total}")


def merge_exports(exports: Mapping[object, Mapping[str, Dict]],
                  hosts: Optional[Mapping[object, str]] = None
                  ) -> FleetAggregate:
    """Merge ``{rank: registry.export()}`` into one
    :class:`FleetAggregate` (``hosts`` optionally maps rank →
    hostname for the ``host=`` label)."""
    agg = FleetAggregate(
        hosts={str(k): str(v) for k, v in (hosts or {}).items()})
    for rank in sorted(exports, key=lambda r: (len(str(r)), str(r))):
        agg.add(rank, exports[rank])
    return agg
