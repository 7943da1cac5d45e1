"""CLI over the span collector: request autopsies from the terminal.

A copy of ``horovod_tpu/obs/trace.py`` (standard library only, its
imports renamed to the port's): the port keeps its own because
importing anything from ``horovod_tpu`` loads JAX.
``tests/test_torch_port_tracing.py`` holds it to the original,
code for code.

    # list every trace the span streams know about
    python -m horovod_tpu_torch.obs.trace --spans /tmp/spans --list

    # ASCII tree of one trace (the SIGKILL-failover autopsy view)
    python -m horovod_tpu_torch.obs.trace --spans /tmp/spans 1f0c9a2b40d311ee

    # full autopsy JSON (same payload as the router's GET /trace/<id>)
    python -m horovod_tpu_torch.obs.trace --spans /tmp/spans TRACE --json

    # Perfetto export: one track per process, spans + typed events
    python -m horovod_tpu_torch.obs.trace --spans /tmp/spans TRACE \\
        --perfetto /tmp/trace.json

``--spans`` points at the spans directory every process of one
deployment writes into (``ReplicaSupervisor(span_dir=...)`` + the
router's own recorder); individual stream files or globs work too.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from horovod_tpu_torch.obs.trace_store import TraceStore

__all__ = ["main"]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.obs.trace",
        description="Assemble per-process span streams into one "
                    "cross-process trace tree (ASCII / JSON / Perfetto).")
    ap.add_argument("trace_id", nargs="?", default=None,
                    help="trace id to render (omit with --list)")
    ap.add_argument("--spans", required=True, action="append",
                    help="spans directory, stream file, or glob "
                         "(repeatable)")
    ap.add_argument("--list", action="store_true",
                    help="list known trace ids with a one-line summary")
    ap.add_argument("--json", action="store_true",
                    help="print the full autopsy JSON instead of the "
                         "ASCII tree")
    ap.add_argument("--perfetto", default="",
                    help="write a Chrome-trace/Perfetto file for the "
                         "trace (one track per process)")
    args = ap.parse_args(argv)

    paths = []
    for p in args.spans:
        paths.append(os.path.join(p, "*.jsonl") if os.path.isdir(p)
                     else p)
    store = TraceStore(paths)

    if args.list:
        ids = store.trace_ids()
        if not ids:
            print("no traces found", file=sys.stderr)
            return 1
        for tid in ids:
            a = store.autopsy(tid)
            dur = f"{a['duration_s']:.3f}s" \
                if a["duration_s"] is not None else "?"
            flags = []
            if a["resumed"]:
                flags.append("resumed")
            if a["failovers"]:
                flags.append(f"failovers={a['failovers']}")
            if a["unfinished_spans"]:
                flags.append(f"unfinished={len(a['unfinished_spans'])}")
            print(f"{tid}  spans={a['span_count']} "
                  f"procs={len(a['processes'])} dur={dur}"
                  + (("  [" + ", ".join(flags) + "]") if flags else ""))
        return 0

    if not args.trace_id:
        ap.error("need a trace id (or --list)")
    autopsy = store.autopsy(args.trace_id)
    if autopsy is None:
        print(f"trace {args.trace_id} not found in "
              f"{len(store.paths)} stream(s)", file=sys.stderr)
        return 1

    if args.perfetto:
        events = store.perfetto(args.trace_id)
        with open(args.perfetto, "w") as f:
            json.dump(events, f)
        print(f"wrote {len(events)} events -> {args.perfetto}")

    if args.json:
        print(json.dumps(autopsy, indent=2))
    else:
        print(store.ascii_tree(args.trace_id))
    return 0


if __name__ == "__main__":
    try:
        raise SystemExit(main())
    except BrokenPipeError:  # `... | head` closed the pipe: not an error
        raise SystemExit(0)
