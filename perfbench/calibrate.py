"""The readings that the limits of ``correct`` are set from, for one cell,
in one process (the benchmark's own runs never run this).

    python3 -m perfbench.calibrate --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--look-f32] [--out FILE]

For each of ``--seeds``: the program's first three steps from the seed,
as a run of the cell reads them, against the plain reference
(``program``; with ``--look-f32`` the program computes in float32, where
its family has the option: a look at what bf16 alone moves).  For each of
``--control-seeds``, with no program: the reference computed in fp8
(``control``, :class:`~perfbench.reference.precision.FP8`) and the
reference with half of each batch left out
(``half_batch``), each against the float32 reference.  A state left
unchanged reads 1 on ``change`` and needs no run.  One JSON line a
reading.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
import time

import torch

from perfbench import check
from perfbench.reference import precision
from perfbench.run import kinds_of, load_cell


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def readings(workload: str, seeds, control_seeds, device="cuda", emit=print,
             look_f32=False):
    _, cell, config, traffic = load_cell(workload)
    fam = importlib.import_module(f"perfbench.families.{config['family']}")
    kinds = kinds_of(fam, config)
    if look_f32:
        config = {**config, "program_dtype": "float32"}
    dev = torch.device(device)
    from horovod_tpu_torch import basics

    basics.init(device=None if dev.type == "cuda" else "cpu")
    try:
        for seed in seeds:
            t0 = time.perf_counter()
            prog = fam.Program(config, traffic, seed, dev)
            got = check.program_readings(prog, fam, config, seed, dev)
            prog.free()
            del prog
            _free(dev)
            precision.strict_f32()
            ref = fam.reference(config, traffic, seed, dev, precision.Exact)
            _free(dev)
            emit({"kind": "program_f32" if look_f32 else "program",
                  "seed": seed, **check.compare(got, ref, kinds),
                  "worst": check.worst_leaves(got, ref, kinds),
                  "losses": got.losses,
                  "ref_losses": ref.losses,
                  "seconds": time.perf_counter() - t0})
    finally:
        basics.shutdown()
    for seed in control_seeds:
        precision.strict_f32()
        ref = fam.reference(config, traffic, seed, dev, precision.Exact)
        _free(dev)
        for kind, prec, fault in (("control", precision.FP8, None),
                                  ("half_batch", precision.Exact,
                                   "half_batch")):
            t0 = time.perf_counter()
            other = fam.reference(config, traffic, seed, dev, prec, fault)
            _free(dev)
            emit({"kind": kind, "seed": seed,
                  **check.compare(other, ref, kinds),
                  "worst": check.worst_leaves(other, ref, kinds),
                  "losses": other.losses, "ref_losses": ref.losses,
                  "seconds": time.perf_counter() - t0})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--look-f32", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    ints = lambda s: [int(x) for x in s.split(",") if x]
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        rec = {"workload": args.workload, **rec}
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    try:
        readings(args.workload, ints(args.seeds), ints(args.control_seeds),
                 emit=emit, look_f32=args.look_f32)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
