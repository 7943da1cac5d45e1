"""One run of one cell of the port's benchmark.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``horovod_tpu_torch`` beside
``perfbench/`` and ``BENCHMARK.json``, on a machine with the cards the cell
asks for.  It prints, as the last line of standard output, one JSON object:
``correct``, ``attempted`` and ``failed`` (the window's steps, and those
whose loss is not finite), ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number that decided ``correct``
beside its limit (also the last lines of standard error).

Everything about a cell is found by name: the cell's entry in
``BENCHMARK.json`` names a configuration (``perfbench/configs/<name>.json``,
whose ``family`` names the module under ``perfbench/families/`` that builds
the program and its plain reference) and a traffic mix
(``perfbench/traffic/<name>.json``, the parameters that family's generator
reads, among them the ``path``, a module under ``perfbench/paths/`` that
drives the train step); each metric is read by
``perfbench/metrics/<name>.py`` (:func:`metric_file`).  A cell on more than
one card runs one process a rank (``perfbench.ranks``).

A run: set-up (the program's model and train step over weights and
batches made on the device from the seed; its first three steps, read for
the check; warm-up), the window of ``--seconds`` (``perfbench.window``),
with ``--trace 1`` a profiled stretch after it (``perfbench.trace``), then,
with the program's state freed, the plain reference's three steps and the
comparison (``perfbench.check``).  ``setup_s`` runs from this module's
import to the window's start.

It exits non-zero, printing no result, without enough CUDA devices, and
if ``jax``, ``jaxlib``, ``flax`` or ``horovod_tpu`` (top-level names,
compared whole) is loaded once the window has closed.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "horovod_tpu"})
#: Steps traced with the host's operators, for the idle gaps' labels.
LABELLED_STEPS = 2
#: Every build and kernel cache a library of the program could use, at
#: fixed paths inside the checkout (the port builds its kernels under
#: ``build/`` itself).
CACHES = {"TRITON_CACHE_DIR": "build/triton",
          "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
          "CUDA_CACHE_PATH": "build/cuda_cache"}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, root: Path = ROOT):
    """``(benchmark, cell, configuration as run, traffic)`` of a cell by
    name."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"perfbench: no workload {workload!r} in "
                         f"BENCHMARK.json ({sorted(cells)})")
    cell = cells[workload]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = _json(root / entry["file"])
    # ``as_run``: the values the program runs with where it departs from
    # the source (each listed under ``departures``).
    config.update(config.get("as_run", {}))
    return (bench, cell, config,
            _json(root / "perfbench" / "traffic" / f"{cell['traffic']}.json"))


def metrics_of(bench: dict, cell: dict, trace: bool) -> list:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    ones: those that list it, or list no cells (a per-layer one then where
    the cell reports the end-to-end metric it moves)."""
    def listed(m):
        return cell["name"] in m.get("workloads", [cell["name"]])

    e2e = [m for m in bench["end_to_end"] if listed(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"] if listed(m)
            and (m["moves"] in names or "workloads" in m)]


def metric_file(name: str, root: Path = ROOT) -> Path:
    """``perfbench/metrics/<name>.py``, else the reader of the name's
    part before its first dot (``idle_share.lm`` -> ``idle_share.py``)."""
    d = root / "perfbench" / "metrics"
    exact = d / f"{name}.py"
    return exact if exact.exists() else d / f"{name.split('.')[0]}.py"


def read_metric(name: str, ctx, root: Path = ROOT):
    """The metric's reader's ``read(ctx)`` (:func:`metric_file`): a
    number, or None where it finds nothing to read."""
    path = metric_file(name, root)
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def kinds_of(family, config: dict):
    """The family's leaf -> kind map, or None where it sorts none."""
    return family.kinds(config) if hasattr(family, "kinds") else None


def _counters() -> dict:
    from horovod_tpu_torch.obs.registry import Counter, default_registry

    reg = default_registry()
    return {n: reg.get(n).value for n in reg.names()
            if isinstance(reg.get(n), Counter)}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", breaker=None, root: Path = ROOT) -> dict:
    """One run -> the result object (see the module's docstring).
    ``breaker(program)``, for the tests, breaks the program after it is
    built."""
    import torch

    from perfbench import check, paths, peaks, window
    from perfbench.reference import precision
    from perfbench.trace import PROFILER_WARMUP, trace_stretch

    bench, cell, config, traffic = load_cell(workload, root)
    fam = importlib.import_module(f"perfbench.families.{config['family']}")
    rank = int(os.environ.get("HOROVOD_RANK", "0"))
    world = int(os.environ.get("HOROVOD_SIZE", "1"))
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and world > 1:
        dev = torch.device("cuda", rank)
    agreement = None
    if world > 1:
        host, port = os.environ["PERFBENCH_STORE"].rsplit(":", 1)
        agreement = window.Agreement(torch.distributed.TCPStore(
            host, int(port), world, rank == 0), rank)

    from horovod_tpu_torch import basics

    basics.init(device=None if cuda else "cpu")
    try:
        prog = fam.Program(config, traffic, seed, dev, rank, world)
        if breaker is not None:
            breaker(prog)
        readings = check.program_readings(prog, fam, config, seed, dev)
        k = len(readings.losses)
        for _ in range(traffic["warmup_steps"]):
            prog.step(k)
            k += 1
        clock = window.clock_for(dev)
        clock.sync()
        for span in prog.spans.values():
            span[:] = [0.0, 0]
        before = _counters()
        setup_s = time.perf_counter() - _T0
        win = window.run_window(prog.step, seconds, clock,
                                prog.items_per_step, first=k,
                                agreement=agreement)
        k += win.steps
        after = _counters()
        spans = {n: list(v) for n, v in prog.spans.items()}
        tr = labelled = None
        if trace:
            tr = trace_stretch(prog.step, k, traffic["trace_steps"], clock,
                               dev)
            k += PROFILER_WARMUP + tr.steps
            labelled = trace_stretch(prog.step, k, LABELLED_STEPS, clock,
                                     dev, host_ops=True)
        kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
        peak_bytes = torch.cuda.max_memory_allocated(dev) if cuda else None
        ctx = SimpleNamespace(
            config=config, traffic=traffic, cell=cell, setup_s=setup_s,
            window=win, trace=tr, spans=spans, peak_bytes=peak_bytes,
            counters={n: after[n] - before.get(n, 0) for n in after},
            peak=peaks.peak_of(kind))
        metrics = {}
        for m in metrics_of(bench, cell, trace):
            v = read_metric(m["name"], ctx, root)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        prog.free()
        del prog
    finally:
        basics.shutdown()
    gc.collect()
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    found = forbidden_modules()
    correct, checks, numbers, ref_losses = None, {}, {}, []
    if rank == 0:
        precision.strict_f32()
        ref = fam.reference(config, traffic, seed, dev, precision.Exact,
                            world=world,
                            loss_over=paths.load(traffic["path"]).LOSS_OVER)
        numbers = check.compare(readings, ref, kinds_of(fam, config))
        correct, checks = check.verdict(numbers, config["correct_limits"])
        ref_losses = ref.losses
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": world, "memory_peak_bytes": peak_bytes,
                   "power_limit_w": peaks.power_limit_w(dev.index or 0)
                   if cuda else None}
    out = {"correct": correct, "attempted": win.steps,
           "failed": win.nonfinite, "metrics": metrics,
           "device": device_info}
    if tr is not None:
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = tr.breakdown(labelled)
        # The profiler's span against the CUDA events' window, and the
        # traced stretch's step against the window's (tracing's cost).
        out["trace_check"] = {
            "span_s": tr.span_s, "window_s": tr.window_s,
            "traced_step_ms": tr.window_s / tr.steps * 1e3,
            "untraced_step_ms": win.seconds / win.steps * 1e3,
            "labelled_step_ms": labelled.window_s / labelled.steps * 1e3}
    out["forbidden_modules"] = found
    out["readings"] = {"numbers": numbers, "losses": readings.losses,
                       "reference_losses": ref_losses}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, rel in CACHES.items():
        os.environ[var] = str(ROOT / rel)

    bench, cell, _, _ = load_cell(args.workload)
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found {found}", file=sys.stderr)
        return 2
    if cell["chips"] == 1:
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace))
    else:
        from perfbench import ranks

        out = ranks.run(args.workload, args.seed, args.seconds,
                        bool(args.trace), cell["chips"])
    found = sorted(set(out.pop("forbidden_modules"))
                   | set(forbidden_modules()))
    if found:
        print(f"perfbench: the run loaded {found}; the benchmark measures "
              "horovod_tpu_torch alone", file=sys.stderr)
        return 3
    want = {m["name"] for m in metrics_of(bench, cell, bool(args.trace))}
    missing = sorted(want - set(out["metrics"]))
    if not args.trace and missing:
        print(f"perfbench: end-to-end metrics not read: {missing}",
              file=sys.stderr)
        return 4
    print(f"correct {out['correct']}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
