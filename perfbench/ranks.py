"""A run of a cell on more than one card: one process a rank, as
data-parallel training runs.

``run.main`` starts, for a cell with ``chips`` above 1, ``chips`` copies of

    python3 -m perfbench.ranks <workload> <seed> <seconds> <trace> <device>

each with its rank in the launcher's environment that
``horovod_tpu_torch.basics.init`` reads (``HOROVOD_RANK``, ``HOROVOD_SIZE``,
the local ones, ``HOROVOD_COORDINATOR_ADDR``; the native controller's
``HOROVOD_NATIVE_PORT``), each port a free one, and ``PERFBENCH_STORE``, the
address of the store in which rank 0 names the window's last step
(``perfbench.window.Agreement``).  Every rank runs ``run.run_cell``; rank 0
alone runs the plain reference and the comparison.  The launcher waits for
every rank, ends them all when one fails, and merges their results
(:func:`merge`).
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import random
import socket
import subprocess
import sys
from typing import Dict, List, Optional, Sequence


def free_ports(n: int) -> List[int]:
    """``n`` distinct ports free now, below the range the system hands out
    to outgoing connections (the ranks' own open many), so none of those
    takes one before its listener binds it."""
    rng, held, ports = random.SystemRandom(), [], []
    try:
        while len(ports) < n:
            s = socket.socket()
            held.append(s)
            try:
                s.bind(("127.0.0.1", rng.randrange(20000, 32000)))
            except OSError:
                continue
            ports.append(s.getsockname()[1])
    finally:
        for s in held:
            s.close()
    return ports


def rank_env(rank: int, world: int, ports: Sequence[int]) -> Dict:
    master, native, store = ports
    return {"HOROVOD_RANK": str(rank), "HOROVOD_SIZE": str(world),
            "HOROVOD_LOCAL_RANK": str(rank), "HOROVOD_LOCAL_SIZE": str(world),
            "HOROVOD_COORDINATOR_ADDR": f"127.0.0.1:{master}",
            "HOROVOD_NATIVE_PORT": str(native),
            "PERFBENCH_STORE": f"127.0.0.1:{store}"}


def launch(cmd: Sequence[str], world: int, cwd=None,
           env: Optional[Dict] = None) -> List[Dict]:
    """Run ``cmd`` once a rank and wait for all -> each rank's result (the
    last line of its standard output).  Raises when a rank fails, after
    ending the others."""
    ports = free_ports(3)
    base = dict(os.environ if env is None else env)
    procs = [subprocess.Popen(list(cmd), cwd=cwd, stdout=subprocess.PIPE,
                              text=True,
                              env={**base, **rank_env(r, world, ports)})
             for r in range(world)]
    outs: List[Optional[str]] = [None] * world
    failed = None
    with concurrent.futures.ThreadPoolExecutor(world) as pool:
        futures = {pool.submit(p.communicate): r
                   for r, p in enumerate(procs)}
        for f in concurrent.futures.as_completed(futures):
            r = futures[f]
            outs[r] = f.result()[0]
            if procs[r].returncode != 0 and failed is None:
                failed = r
                for p in procs:
                    if p.poll() is None:
                        p.kill()
    for p in procs:
        p.wait()
    if failed is not None:
        raise RuntimeError(f"rank {failed} of {world} exited with code "
                           f"{procs[failed].returncode}")
    return [json.loads(o.strip().splitlines()[-1]) for o in outs]


def merge(results: List[Dict]) -> Dict:
    """Rank 0's result, with the device reading of them all: the peak of
    the fullest card, busy seconds averaged over the cards, and every
    forbidden module any rank loaded."""
    out = dict(results[0])
    dev = out["device"] = dict(out["device"])
    dev["count"] = len(results)
    peaks = [r["device"]["memory_peak_bytes"] for r in results]
    dev["memory_peak_bytes"] = None if None in peaks else max(peaks)
    if "busy_s" in dev:
        dev["busy_s"] = sum(r["device"]["busy_s"] for r in results) / len(
            results)
    out["forbidden_modules"] = sorted(
        {m for r in results for m in r["forbidden_modules"]})
    return out


def run(workload: str, seed: int, seconds: float, trace: bool, world: int,
        device: str = "cuda") -> Dict:
    # faulthandler: a rank that dies on a signal prints its stack.
    cmd = [sys.executable, "-X", "faulthandler", "-m", "perfbench.ranks",
           workload, str(seed), str(seconds), str(int(trace)), device]
    return merge(launch(cmd, world))


def main(argv=None) -> int:
    from perfbench import run as run_mod

    workload, seed, seconds, trace, device = (argv or sys.argv[1:])
    out = run_mod.run_cell(workload, int(seed), float(seconds),
                           bool(int(trace)), device=device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
