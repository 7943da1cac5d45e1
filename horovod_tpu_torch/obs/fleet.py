"""Driver-side fleet observability: aggregate worker snapshots, detect
stragglers, serve one fleet-level scrape.

A copy of ``horovod_tpu/obs/fleet.py`` (standard library only, its
imports renamed to the port's): the port keeps its own because
importing anything from ``horovod_tpu`` loads JAX.
``tests/test_torch_port_tracing.py`` holds it to the original,
code for code.

The ElasticDriver can already see *liveness* (exit codes, stale
heartbeats); this module gives it *slowness* and *state*:

* each elastic worker publishes its registry export and a step-duration
  heartbeat payload over the rendezvous KV
  (the JAX package's ``elastic.worker.WorkerNotificationManager``;
  the port's driver side is not ported yet);
* the driver feeds them into a :class:`FleetMonitor`, which merges the
  exports (:mod:`horovod_tpu_torch.obs.aggregate` — counters sum, gauges get
  ``rank``/``host`` labels + min/median/max, histograms merge
  bucket-wise) and watches per-rank step durations for **stragglers**:
  a rank whose step time exceeds ``straggler_threshold`` × the fleet
  median for ``straggler_patience`` consecutive step reports is
  flagged — a warning log, an ``elastic_straggler_total{rank=}``
  counter, and an ``elastic_straggler`` timeline instant.  Detection is
  REPORT-ONLY: the driver surfaces the rank (``/fleet`` carries the
  same list the Blacklist would need) but never evicts on slowness —
  slow-but-correct must stay a human call;
* :class:`FleetServer` serves the merged view over HTTP:
  ``GET /metrics`` (Prometheus 0.0.4, the strict-parser-clean fleet
  exposition) and ``GET /fleet`` (JSON: per-rank status, skew,
  stragglers, merged metrics).

Horovod's cross-worker timeline existed for exactly this blind spot —
per-worker views hide negotiation stalls and stragglers; the skew gauge
(slowest/median step time, ``elastic_step_time_skew``) is that signal
as a number.
"""

from __future__ import annotations

import json
import logging
import os
import statistics
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from horovod_tpu_torch.obs import tracing as obs_tracing
from horovod_tpu_torch.obs.aggregate import FleetAggregate, merge_exports
from horovod_tpu_torch.obs.registry import MetricsRegistry

logger = logging.getLogger("horovod_tpu_torch")

__all__ = ["FleetMonitor", "FleetServer", "parse_heartbeat"]


def parse_heartbeat(raw: bytes) -> Dict:
    """Decode a heartbeat KV payload: the structured JSON form
    (``{"t": wall, "steps": n, "step_s": last}``) or the legacy bare
    ``repr(time.time())`` float (pre-fleet workers keep working)."""
    text = raw.decode() if isinstance(raw, (bytes, bytearray)) else raw
    try:
        payload = json.loads(text)
    except (json.JSONDecodeError, ValueError):
        return {}
    if isinstance(payload, dict):
        return payload
    if isinstance(payload, (int, float)):
        return {"t": float(payload)}
    return {}


class _RankState:
    __slots__ = ("host", "export", "step_s", "steps", "strikes",
                 "flagged", "last_seen")

    def __init__(self, host: Optional[str]):
        self.host = host
        self.export: Optional[Dict] = None
        self.step_s: Optional[float] = None
        self.steps: Optional[float] = None
        self.strikes = 0
        self.flagged = False
        self.last_seen: Optional[float] = None


class FleetMonitor:
    """Thread-safe store + detector behind the driver's fleet view.

    Feed it with :meth:`heartbeat` / :meth:`snapshot` as KV data
    arrives; read :meth:`prometheus`, :meth:`fleet_json`, and
    :meth:`stragglers`.  ``begin_epoch`` clears per-rank state at a
    re-rendezvous (rank ids are reassigned across epochs) while the
    monitor's own counters — straggler episodes are a job-lifetime
    fact — survive."""

    def __init__(self, *, straggler_threshold: float = 2.0,
                 straggler_patience: int = 3,
                 registry: Optional[MetricsRegistry] = None):
        if straggler_threshold <= 1.0:
            raise ValueError("straggler_threshold must be > 1.0")
        if straggler_patience < 1:
            raise ValueError("straggler_patience must be >= 1")
        self.straggler_threshold = straggler_threshold
        self.straggler_patience = straggler_patience
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._skew = self.registry.gauge(
            "elastic_step_time_skew",
            "Slowest/median per-rank step duration across the fleet "
            "(1.0 = perfectly even)", exist_ok=True)
        self._straggler_total = self.registry.counter(
            "elastic_straggler_total",
            "Sustained-straggler episodes detected (report-only)",
            labels=("rank",), exist_ok=True)
        self._ranks_reporting = self.registry.gauge(
            "fleet_ranks_reporting",
            "Ranks with a live fleet heartbeat this epoch",
            exist_ok=True)
        self._lock = threading.Lock()
        self._ranks: Dict[str, _RankState] = {}
        self.epoch: Optional[int] = None

    # -- ingestion ---------------------------------------------------------

    def begin_epoch(self, epoch: int) -> None:
        with self._lock:
            self.epoch = epoch
            self._ranks.clear()
            self._ranks_reporting.set(0)
            self._skew.set(0.0)

    def _rank(self, rank, host) -> _RankState:
        key = str(rank)
        st = self._ranks.get(key)
        if st is None:
            st = self._ranks[key] = _RankState(host)
            self._ranks_reporting.set(len(self._ranks))
        if host is not None:
            st.host = host
        return st

    def heartbeat(self, rank, host: Optional[str],
                  payload: Dict) -> None:
        """One heartbeat KV observation.  Step-duration fields advance
        the straggler detector only when ``steps`` moved — one strike
        per *step report*, not per driver poll, so ``patience`` reads
        as "flagged within K slow steps"."""
        with self._lock:
            st = self._rank(rank, host)
            st.last_seen = time.monotonic()
            steps = payload.get("steps")
            step_s = payload.get("step_s")
            fresh = (steps is not None and steps != st.steps)
            if steps is not None:
                st.steps = steps
            if step_s is not None:
                st.step_s = float(step_s)
            if fresh and st.step_s is not None:
                self._evaluate_locked(str(rank), st)

    def snapshot(self, rank, host: Optional[str], export: Dict) -> None:
        """One registry-export KV observation."""
        with self._lock:
            st = self._rank(rank, host)
            st.export = export
            st.last_seen = time.monotonic()

    # -- straggler detection -----------------------------------------------

    def _evaluate_locked(self, rank: str, st: _RankState) -> None:
        steps = {r: s.step_s for r, s in self._ranks.items()
                 if s.step_s is not None and s.step_s > 0}
        if len(steps) < 2:
            return
        self._skew.set(max(steps.values())
                       / statistics.median(steps.values()))
        # Compare against the median of the OTHER ranks: including the
        # suspect in its own reference would make slowest/median
        # mathematically bounded below 2x on a 2-rank fleet — a 10x
        # straggler could never be flagged at the default threshold.
        peers = [s for r, s in steps.items() if r != rank]
        if not peers:
            return
        med = statistics.median(peers)
        ratio = st.step_s / med
        if ratio <= self.straggler_threshold:
            st.strikes = 0
            st.flagged = False
            return
        st.strikes += 1
        if st.strikes < self.straggler_patience or st.flagged:
            return
        st.flagged = True
        self._straggler_total.labels(rank=rank).inc()
        logger.warning(
            "fleet: rank %s%s is a sustained straggler: step %.4fs vs "
            "peer median %.4fs (%.1fx > %.1fx threshold for %d "
            "consecutive steps) — report-only, not evicting",
            rank, f" on {st.host}" if st.host else "", st.step_s, med,
            ratio, self.straggler_threshold, st.strikes)
        try:
            obs_tracing.instant("elastic_straggler", {
                "rank": rank, "host": st.host, "step_s": st.step_s,
                "median_step_s": med, "ratio": round(ratio, 3)})
        except Exception:  # pragma: no cover - tracing never gates
            pass

    def stragglers(self) -> List[str]:
        """Ranks currently flagged as sustained stragglers (the list a
        blacklist-on-slowness policy would consume; today report-only)."""
        with self._lock:
            return sorted(r for r, st in self._ranks.items() if st.flagged)

    @property
    def skew(self) -> float:
        return self._skew.value

    # -- views -------------------------------------------------------------

    def aggregate(self) -> FleetAggregate:
        """Merge the currently-held rank exports."""
        with self._lock:
            exports = {r: st.export for r, st in self._ranks.items()
                       if st.export is not None}
            hosts = {r: st.host for r, st in self._ranks.items()
                     if st.export is not None and st.host}
        return merge_exports(exports, hosts)

    def prometheus(self) -> str:
        """The fleet ``/metrics`` body: every rank's families merged
        (``rank``/``host``-labeled) plus the monitor's own skew /
        straggler / reporting families."""
        return self.aggregate().to_prometheus() \
            + self.registry.to_prometheus()

    def fleet_json(self) -> Dict:
        """The ``/fleet`` JSON view: per-rank status + skew +
        stragglers + the merged metric snapshot."""
        now = time.monotonic()
        with self._lock:
            ranks = {
                r: {
                    "host": st.host,
                    "heartbeat_age_s": (round(now - st.last_seen, 3)
                                        if st.last_seen is not None
                                        else None),
                    "steps": st.steps,
                    "step_seconds": st.step_s,
                    "straggler": st.flagged,
                    "has_metrics": st.export is not None,
                }
                for r, st in self._ranks.items()
            }
            epoch = self.epoch
        return {
            "epoch": epoch,
            "ranks": ranks,
            "step_time_skew": self.skew,
            "straggler_threshold": self.straggler_threshold,
            "straggler_patience": self.straggler_patience,
            "stragglers": self.stragglers(),
            "metrics": self.aggregate().snapshot(),
        }


class _FleetHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):  # quiet: the scrape IS the log
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        monitor: FleetMonitor = self.server.monitor
        try:
            if self.path == "/metrics":
                self._send(200, monitor.prometheus().encode(),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif self.path == "/fleet":
                self._send(200, json.dumps(monitor.fleet_json()).encode(),
                           "application/json")
            else:
                self._send(404, json.dumps(
                    {"error": f"unknown path {self.path}",
                     "paths": ["/metrics", "/fleet"]}).encode(),
                    "application/json")
        except Exception as e:  # aggregation conflicts -> 500, not a hang
            self._send(500, json.dumps(
                {"error": f"{type(e).__name__}: {e}"}).encode(),
                "application/json")


class FleetServer:
    """Threaded stdlib-HTTP front for a :class:`FleetMonitor`
    (``GET /metrics`` + ``GET /fleet``); port 0 binds ephemeral."""

    def __init__(self, monitor: FleetMonitor, *,
                 host: str = "127.0.0.1", port: int = 0):
        self.monitor = monitor
        self.host = host
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self):
        """``(host, port)`` a scraper can actually connect to: a
        0.0.0.0 wildcard bind is reported as this host's reachable
        name (``HOROVOD_HOSTNAME``, like the rendezvous server) — the
        wildcard is a bind address, not a destination."""
        if self._httpd is None:
            host, port = self.host, self.port
        else:
            host, port = self._httpd.server_address[:2]
        if host in ("0.0.0.0", "::"):
            host = os.environ.get("HOROVOD_HOSTNAME", "127.0.0.1")
        return (host, port)

    def start(self) -> "FleetServer":
        if self._httpd is not None:
            return self
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          _FleetHandler)
        self._httpd.daemon_threads = True
        self._httpd.monitor = self.monitor
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="fleet-metrics-http",
            daemon=True)
        self._thread.start()
        logger.info("fleet: metrics endpoint at http://%s:%d/metrics",
                    *self.address)
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
