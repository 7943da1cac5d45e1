"""Merge per-rank Perfetto/Chrome trace files onto one time axis.

A copy of ``horovod_tpu/obs/merge.py`` (standard library only, its
imports renamed to the port's): the port keeps its own because
importing anything from ``horovod_tpu`` loads JAX.
``tests/test_torch_port_tracing.py`` holds it to the original,
code for code.

Horovod's timeline was a single cross-worker file by construction (rank
0 wrote everyone's negotiation events); here every rank records its own
host-side timeline (``HOROVOD_TIMELINE`` with the ``%r`` rank
substitution — see docs/timeline.md), so N ranks produce N JSON files
that Perfetto can only show one at a time.  This tool merges them::

    python -m horovod_tpu_torch.obs.merge merged.json rank0.json rank1.json ...
    python -m horovod_tpu_torch.obs.merge merged.json 'trace.rank*.json'

Each input file's ``pid`` values are remapped into a disjoint per-input
range, and a ``process_name`` / ``process_sort_index`` metadata pair is
emitted per input, so the merged file shows ONE labeled process track
per rank — train steps, serving spans, tick phases, and instants from
all ranks on a shared clock.  (Timestamps are ``CLOCK_MONOTONIC``
microseconds: directly comparable for ranks on one host, which is
where multi-process tests and single-host multi-chip jobs live.  For
ranks from different hosts pass ``--align-start`` to re-zero each
input at its earliest event — relative phasing across hosts is then
approximate.)

Truncated inputs (a rank killed before its writer appended the closing
bracket — exactly the ranks worth debugging) are repaired on read.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from typing import Dict, List, Optional, Tuple

__all__ = ["load_trace", "merge_traces", "main"]

# Per-input pid block: input i owns [(i+1)*PID_STRIDE, (i+2)*PID_STRIDE).
PID_STRIDE = 1000

_RANK_RE = re.compile(r"(?:rank|\br)[._-]?(\d+)", re.IGNORECASE)
# The `%r` filename style (tl.0.json ... tl.11.json): bare digits right
# before the final extension are the rank — without this, lexicographic
# glob order would label tl.10.json "rank 2".
_TRAILING_NUM_RE = re.compile(r"(\d+)\.[^.]+$")


def load_trace(path: str) -> List[dict]:
    """Load a Chrome-trace JSON event array, repairing the truncation a
    killed writer leaves behind: a missing ``]``, a trailing comma, or
    a PARTIAL last event (buffered IO means a SIGKILL cuts the file at
    an arbitrary byte — the partial object is dropped back to the last
    complete event boundary)."""
    with open(path) as f:
        text = f.read()
    if not text.strip():
        # A rank killed before its writer's first flush leaves a 0-byte
        # file: that is "no events", not a merge-stopping error.
        return []

    def _as_events(data):
        if isinstance(data, dict):  # {"traceEvents": [...]} container
            data = data.get("traceEvents", [])
        if not isinstance(data, list):
            raise ValueError(f"{path}: not a Chrome-trace event array")
        return data

    try:
        return _as_events(json.loads(text))
    except json.JSONDecodeError:
        pass
    body = text.strip().rstrip(",")
    if body.endswith("]"):
        return _as_events(json.loads(body))  # re-raises if hopeless
    try:  # clean truncation: events intact, only the trailer missing
        return _as_events(json.loads(body + "\n]"))
    except json.JSONDecodeError:
        pass
    # Cut back to the last complete event: try each '}' from the end as
    # the final closing brace (an inner brace of a nested args dict
    # fails to parse and the scan continues leftward).
    i = len(body)
    while True:
        i = body.rfind("}", 0, i)
        if i < 0:
            raise ValueError(f"{path}: unrecoverable truncated trace")
        try:
            return _as_events(json.loads(body[:i + 1].rstrip(",") + "\n]"))
        except json.JSONDecodeError:
            continue


def _label_for(path: str, index: int) -> str:
    base = os.path.basename(path)
    m = _RANK_RE.search(base) or _TRAILING_NUM_RE.search(base)
    return f"rank {m.group(1)}" if m else f"rank {index}"


def merge_traces(inputs: List[str], *,
                 labels: Optional[List[str]] = None,
                 align_start: bool = False
                 ) -> Tuple[List[dict], Dict[str, int]]:
    """Merge trace files into one event list.

    Returns ``(events, stats)`` where stats counts events per input.
    Each input gets a disjoint pid block (one distinct Perfetto process
    track per rank) with ``process_name`` metadata, events otherwise
    untouched (same clock) unless ``align_start`` re-zeroes each input
    at its earliest timestamp."""
    merged: List[dict] = []
    stats: Dict[str, int] = {}
    for i, path in enumerate(inputs):
        try:
            events = load_trace(path)
        except (OSError, ValueError) as e:
            # One hopeless input (mid-write garbage, a deleted dead-rank
            # file, an unmatched glob kept as a literal path) must not
            # cost the healthy ranks their merged view.
            print(f"  {path}: skipped ({e})", file=sys.stderr)
            stats[path] = 0
            continue
        label = labels[i] if labels and i < len(labels) \
            else _label_for(path, i)
        base = (i + 1) * PID_STRIDE
        pid_map: Dict[object, int] = {}
        t0 = None
        if align_start:
            ts = [e["ts"] for e in events if "ts" in e]
            t0 = min(ts) if ts else 0.0

        def _pid(orig) -> int:
            new = pid_map.get(orig)
            if new is None:
                new = base + len(pid_map)
                pid_map[orig] = new
                name = label if len(pid_map) == 1 \
                    else f"{label} (pid {orig})"
                merged.append({"name": "process_name", "ph": "M",
                               "pid": new, "args": {"name": name}})
                merged.append({"name": "process_sort_index", "ph": "M",
                               "pid": new, "args": {"sort_index": i}})
            return new

        n = 0
        for ev in events:
            ev = dict(ev)
            ev["pid"] = _pid(ev.get("pid", 0))
            if t0 is not None and "ts" in ev:
                ev["ts"] = ev["ts"] - t0
            merged.append(ev)
            n += 1
        stats[path] = n
    return merged, stats


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.obs.merge",
        description="Merge per-rank timeline JSON files into one "
                    "Perfetto trace with one process track per rank.")
    ap.add_argument("output", help="merged trace path (overwritten)")
    ap.add_argument("inputs", nargs="+",
                    help="per-rank trace files (globs accepted)")
    ap.add_argument("--align-start", action="store_true",
                    help="re-zero each input at its earliest event "
                         "(for ranks from different hosts whose "
                         "monotonic clocks do not share an epoch)")
    args = ap.parse_args(argv)

    paths: List[str] = []
    for pattern in args.inputs:
        hits = sorted(glob.glob(pattern))
        paths.extend(hits if hits else [pattern])
    # De-dup while keeping order; never merge the output into itself.
    seen = set()
    out_abs = os.path.abspath(args.output)
    paths = [p for p in paths
             if os.path.abspath(p) != out_abs
             and not (os.path.abspath(p) in seen
                      or seen.add(os.path.abspath(p)))]
    if not paths:
        ap.error("no input trace files matched")

    events, stats = merge_traces(paths, align_start=args.align_start)
    if not any(stats.values()):
        print("error: no readable trace events in any input; "
              "not writing " + args.output, file=sys.stderr)
        return 1
    with open(args.output, "w") as f:
        json.dump(events, f)
    for path, n in stats.items():
        print(f"  {path}: {n} events")
    print(f"merged {len(paths)} trace(s), {len(events)} events "
          f"-> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
