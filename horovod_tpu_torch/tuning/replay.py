"""Journaled-trace replay: re-drive an engine with real traffic.

The port of ``horovod_tpu/tuning/replay.py``: the trace reader, the
replay loop, the offline tuner and the CLI are the JAX module's code
(``tests/test_torch_port_tuning.py`` compares them); the engine build
(:func:`_build_cli_engine`) is the port's, through
:mod:`~horovod_tpu_torch.serving.router.replica_main`'s model loaders on
``--device`` (``cuda`` unless ``cpu`` is asked for).  Offline knobs that
the port's engine does not have — ``paged_kernel`` (the port is paged
and always decodes through its kernel) and ``tp`` (tensor-parallel
serving is not ported) — raise :class:`UnsupportedKnobError` rather than
being dropped.

A journal file becomes a trace (every begun request with its emitted
tokens and arrival offset); :func:`replay` drives a warmed engine with
it open-loop at the original spacing or as fast as admission accepts,
scores the run with the online tuner's
:class:`~horovod_tpu_torch.tuning.tuner.Objective`, and checks every
replayed request's tokens against the journal's record.  :func:`tune`
runs Bayesian optimization over replay runs, one engine a sample, so
constructor knobs (``kv_dtype``, ``n_slots``, ``page_size``,
``spec_k``) are tunable offline.

CLI::

    python -m horovod_tpu_torch.tuning.replay trace.jsonl --seed 0 \\
        --warm 8 --device cpu
    python -m horovod_tpu_torch.tuning.replay trace.jsonl \\
        --params model.pkl --afap --json score.json \\
        --set prefill_chunk_tokens=16
"""

from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["TraceRequest", "ReplayReport", "read_trace", "replay",
           "warm_lens", "tune", "main", "UnsupportedKnobError"]

#: EngineConfig fields of the JAX engine that the port's engine lacks,
#: with the reason.
UNSUPPORTED_KNOBS = {
    "paged_kernel": "the port is paged only and always decodes through "
                    "its paged-attention kernel",
    "paged": "the port is paged only",
    "tp": "tensor-parallel serving is not ported",
}


class UnsupportedKnobError(ValueError):
    """An offline knob the port's engine cannot build."""


@dataclass
class TraceRequest:
    """One journaled request, reconstructed for replay."""

    id: int
    prompt: Tuple[int, ...]
    max_new_tokens: int
    eos_id: Optional[int] = None
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    seed: int = 0
    priority: str = "interactive"
    stream: bool = False
    #: monotonic offset (s) from journal open; 0.0 for pre-arrival
    #: journals (those replay in file order with no spacing).
    arrival: float = 0.0
    #: tokens the ORIGINAL run emitted (complete iff ``ended``).
    emitted: List[int] = field(default_factory=list)
    ended: bool = False


def read_trace(path: str) -> List[TraceRequest]:
    """Parse a journal file into a replayable trace.

    Unlike :meth:`RequestJournal.read_live` (the failover reader,
    which keeps only entries that never ended), this keeps EVERY begun
    entry with its full emitted-token record — ended entries are the
    fidelity oracle, live ones replay their remaining budget too.
    Tolerates a torn final line.  Entries are ordered by arrival
    offset (file order for pre-arrival journals, whose offsets are all
    0 — Python's sort is stable, so file order survives)."""
    reqs: Dict[int, TraceRequest] = {}
    order: List[int] = []
    try:
        with open(path, "r", encoding="utf-8") as f:
            raw = f.read()
    except OSError:
        return []
    for line in raw.splitlines():
        if not line.strip():
            continue
        try:
            ev = json.loads(line)
        except json.JSONDecodeError:
            continue  # torn write at the capture instant
        e, rid = ev.get("e"), ev.get("id")
        if e == "b":
            samp = ev.get("samp") or [0.0, 0, 0.0, 0]
            arr = ev.get("arr") or [0.0, None]
            if rid not in reqs:
                order.append(rid)
            reqs[rid] = TraceRequest(
                id=rid, prompt=tuple(ev.get("prompt") or ()),
                max_new_tokens=int(ev.get("max_new") or 0),
                eos_id=ev.get("eos"),
                temperature=float(samp[0]), top_k=int(samp[1]),
                top_p=float(samp[2]), seed=int(samp[3]),
                priority=ev.get("pri") or "interactive",
                stream=bool(ev.get("stream")),
                arrival=float(arr[0] or 0.0))
        elif e == "t" and rid in reqs:
            reqs[rid].emitted.append(int(ev["t"]))
        elif e == "e" and rid in reqs:
            reqs[rid].ended = True
    out = [reqs[rid] for rid in order if reqs[rid].prompt]
    out.sort(key=lambda r: r.arrival)
    return out


def warm_lens(trace: Sequence[TraceRequest], engine) -> List[int]:
    """One representative prompt length per compile bucket the trace
    will touch — what :meth:`InferenceEngine.warmup` needs so replay
    measures serving, not XLA."""
    seen: Dict[int, int] = {}
    for r in trace:
        b = engine._bucket(len(r.prompt))
        seen.setdefault(b, len(r.prompt))
    return sorted(seen.values())


@dataclass
class ReplayReport:
    """The score JSON one replay run emits."""

    requests: int
    completed: int
    failed: int
    duration_s: float
    ticks: int
    tokens: int
    tokens_per_sec: float
    tokens_per_tick: float
    ttft_p99: Dict[str, float]
    preemptions: int
    decode_recompiles: int
    #: fidelity: replayed outputs compared against the journal record
    compared: int
    token_identical: int
    mismatched_ids: List[int]
    timing: str
    score: float

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


def replay(engine, trace: Sequence[TraceRequest], *,
           timing: str = "original", speed: float = 1.0,
           objective=None, max_seconds: float = 600.0) -> ReplayReport:
    """Drive ``engine`` (already warmed) with ``trace``, synchronously
    (the replay owns the tick loop — do not ``start()`` the engine).

    ``timing="original"`` submits each request at ``arrival / speed``
    seconds after replay start, stepping the engine while waiting
    (open-loop: a slow engine falls behind, which is the point);
    ``"afap"`` submits as fast as admission control accepts.
    """
    if timing not in ("original", "afap"):
        raise ValueError(f"timing must be 'original' or 'afap', "
                         f"got {timing!r}")
    from horovod_tpu_torch.serving.scheduler import QueueFullError
    from horovod_tpu_torch.tuning.tuner import Objective, _Window

    objective = objective or Objective()
    metrics = engine.metrics
    base = _Window(metrics)
    ticks0 = metrics.decode_ticks.value
    compiles0 = engine.decode_compilations
    preempt0 = metrics.preemptions.value

    futures: List[Tuple[TraceRequest, object]] = []
    failed = 0
    t0 = time.monotonic()
    deadline = t0 + max_seconds
    for r in sorted(trace, key=lambda x: x.arrival):
        if timing == "original":
            due = t0 + r.arrival / max(speed, 1e-9)
            while time.monotonic() < due:
                if not engine.step():
                    # idle and early: sleep the remainder in small
                    # slices so arrival spacing stays honest
                    time.sleep(min(0.001, max(0.0, due - time.monotonic())))
        streamed: List[int] = []
        on_token = (lambda tok, piece, _s=streamed: _s.append(int(tok))) \
            if r.stream else None
        while True:
            try:
                fut = engine.submit(
                    list(r.prompt), max_new_tokens=r.max_new_tokens,
                    eos_id=r.eos_id, on_token=on_token,
                    temperature=r.temperature, top_k=r.top_k,
                    top_p=r.top_p, seed=r.seed, priority=r.priority)
                futures.append((r, fut))
                break
            except QueueFullError:
                if time.monotonic() > deadline:
                    failed += 1
                    break
                engine.step()  # drain some queue, retry
            except Exception:
                failed += 1  # typed rejection (too long for this cfg…)
                break
    while (not all(f.done() for _, f in futures)
           and time.monotonic() < deadline):
        engine.step()
    duration = time.monotonic() - t0

    compared = identical = completed = 0
    mismatched: List[int] = []
    for r, fut in futures:
        if not fut.done():
            failed += 1
            continue
        try:
            toks = fut.result(timeout=0)
        except Exception:
            failed += 1
            continue
        completed += 1
        if not r.emitted:
            continue
        compared += 1
        # Ended entries recorded their COMPLETE output; a journal that
        # stopped mid-request holds a prefix — compare what exists.
        want = r.emitted if r.ended else r.emitted[:len(toks)]
        got = toks if r.ended else toks[:len(r.emitted)]
        if got == want:
            identical += 1
        else:
            mismatched.append(r.id)

    stats = base.close(max(metrics.decode_ticks.value - ticks0, 1))
    score, _ = objective.score(stats)
    ticks = metrics.decode_ticks.value - ticks0
    return ReplayReport(
        requests=len(trace), completed=completed, failed=failed,
        duration_s=round(duration, 4), ticks=ticks,
        tokens=stats.tokens,
        tokens_per_sec=round(stats.tokens / max(duration, 1e-9), 3),
        tokens_per_tick=round(stats.tokens / max(ticks, 1), 4),
        ttft_p99={k: round(v, 6) for k, v in stats.ttft_p99.items()},
        preemptions=metrics.preemptions.value - preempt0,
        decode_recompiles=engine.decode_compilations - compiles0,
        compared=compared, token_identical=identical,
        mismatched_ids=mismatched[:32], timing=timing,
        score=round(score, 6))


def tune(build_engine: Callable[[Dict], object],
         trace: Sequence[TraceRequest], *,
         bounds: Dict[str, Tuple[float, float]],
         samples: int = 8, seed: int = 0, timing: str = "afap",
         objective=None) -> Dict:
    """Offline Bayesian optimization over replay runs.

    ``build_engine(settings)`` must return a WARMED engine constructed
    with the integer-rounded ``settings`` (one fresh engine per sample
    — constructor knobs are fair game here).  ``bounds`` maps knob
    name -> (lo, hi) inclusive.  Returns the winning settings, their
    report, and the full objective trajectory."""
    from horovod_tpu_torch.tuning.gp import BayesianOptimizer

    names = sorted(bounds)
    bo = BayesianOptimizer(
        bounds=[tuple(map(float, bounds[n])) for n in names], seed=seed)
    history: List[Dict] = []
    best: Optional[Dict] = None
    for i in range(samples):
        x = bo.suggest()
        settings = {n: int(round(float(x[j])))
                    for j, n in enumerate(names)}
        engine = build_engine(settings)
        try:
            report = replay(engine, trace, timing=timing,
                            objective=objective)
        finally:
            stop = getattr(engine, "stop", None)
            if stop is not None:
                try:
                    stop()
                except Exception:
                    pass
        bo.register([float(settings[n]) for n in names], report.score)
        entry = {"sample": i + 1, "settings": settings,
                 "score": report.score,
                 "report": report.to_json()}
        history.append(entry)
        if best is None or report.score > best["score"]:
            best = entry
    return {"best": best, "trajectory": [
        {"sample": h["sample"], "settings": h["settings"],
         "score": h["score"]} for h in history]}


def _build_cli_engine(args, settings: Optional[Dict] = None):
    """Model + engine from the replica_main flag conventions (shared
    loader — a replayed replica and a live one must agree on what a
    ``--params`` pickle means), on ``args.device``.  Raises
    :class:`UnsupportedKnobError` for a knob the port's engine lacks."""
    from horovod_tpu_torch import serving
    from horovod_tpu_torch.serving.router.replica_main import (
        build_model,
        load_model,
    )

    overrides = dict(args.set or {})
    if settings:
        overrides.update(settings)
    for name in overrides:
        if name in UNSUPPORTED_KNOBS:
            raise UnsupportedKnobError(
                f"{name}: {UNSUPPORTED_KNOBS[name]}")
    device = getattr(args, "device", None) or "cuda"
    if args.params:
        params, cfg = load_model(args.params, device=device)
    else:
        params, cfg = build_model(args, device=device)
    ecfg_kw = dict(
        n_slots=args.slots, max_len=cfg.max_seq,
        max_queue_depth=args.max_queue_depth,
        max_prefills_per_tick=args.max_prefills_per_tick,
        prefill_chunk_tokens=args.chunk,
        tick_timeout=0.0)   # synchronous replay: no watchdog thread
    ecfg_kw.update(overrides)
    engine = serving.InferenceEngine(
        params, cfg, serving.EngineConfig(**ecfg_kw), device=device)
    return engine


def _parse_set(text: str) -> Tuple[str, object]:
    """``name=value`` -> (name, typed value) for EngineConfig fields."""
    if "=" not in text:
        raise ValueError(f"--set wants name=value, got {text!r}")
    name, raw = text.split("=", 1)
    for cast in (int, float):
        try:
            return name, cast(raw)
        except ValueError:
            pass
    if raw in ("true", "True"):
        return name, True
    if raw in ("false", "False"):
        return name, False
    if raw in ("none", "None"):
        return name, None
    return name, raw


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.tuning.replay",
        description="replay a journaled serving trace and emit a "
                    "score JSON (offline tuning backend + perf gate)")
    ap.add_argument("trace", help="journal JSONL file to replay")
    ap.add_argument("--params", default="",
                    help="model pickle from replica_main.dump_model()")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=64)
    ap.add_argument("--d-model", type=int, default=32)
    ap.add_argument("--n-heads", type=int, default=4)
    ap.add_argument("--n-layers", type=int, default=2)
    ap.add_argument("--d-ff", type=int, default=64)
    ap.add_argument("--max-seq", type=int, default=48)
    ap.add_argument("--kv-heads", type=int, default=2)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-queue-depth", type=int, default=64)
    ap.add_argument("--max-prefills-per-tick", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="the engine's device: cuda (the default) or cpu")
    ap.add_argument("--chunk", type=int, default=0,
                    help="prefill_chunk_tokens (0 = whole-prompt)")
    ap.add_argument("--set", type=_parse_set, action="append",
                    default=[], metavar="FIELD=VALUE",
                    help="override any EngineConfig field "
                         "(repeatable), e.g. --set kv_dtype=bf16")
    ap.add_argument("--afap", action="store_true",
                    help="submit as fast as admission control accepts "
                         "instead of at original arrival spacing")
    ap.add_argument("--speed", type=float, default=1.0,
                    help="arrival-spacing speedup for original timing "
                         "(2.0 = replay at twice the recorded rate)")
    ap.add_argument("--json", default="",
                    help="write the score JSON here (also printed)")
    args = ap.parse_args(argv)
    args.set = dict(args.set)

    trace = read_trace(args.trace)
    if not trace:
        print(json.dumps({"error": f"no requests in {args.trace}"}))
        return 2
    engine = _build_cli_engine(args)
    engine.warmup(warm_lens(trace, engine))
    report = replay(engine, trace,
                    timing="afap" if args.afap else "original",
                    speed=args.speed)
    blob = report.to_json()
    print(json.dumps(blob))
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(blob, f, indent=2, sort_keys=True)
            f.write("\n")
    return 0 if report.token_identical == report.compared else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
