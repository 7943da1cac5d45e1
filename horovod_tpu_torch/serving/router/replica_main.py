"""One serving replica: a full engine + HTTP server, as a process.

The port of ``horovod_tpu/serving/router/replica_main.py``: the
command line, the lifecycle and the parsers are the JAX module's
(``tests/test_torch_port_router.py`` compares them), the model half is
rewritten for the port:

* :func:`dump_model` / :func:`load_model` keep the JAX pickle format —
  f32 numpy parameters in the JAX package's layout and the
  ``TransformerConfig`` fields with the dtype by name — so a pickle the
  JAX ``dump_model`` wrote serves from the port (through
  :func:`~horovod_tpu_torch.models.convert.params_from_jax`) and the
  port's loads in the JAX package.  No bf16 numpy array enters the
  pickle: the parameters are f32 in both packages.
* :func:`build_model` draws seeded f32 parameters with the port's
  ``init_params`` from the shape flags (the numbers are not
  ``jax.random``'s).
* ``--device`` is ``cuda`` unless the caller asks for ``cpu``; with no
  CUDA device it raises, never falls back to the CPU.
* ``--tp N`` serves one engine sharded over N ranks
  (:mod:`~horovod_tpu_torch.serving.sharding`), one process a rank, over
  NCCL on CUDA (rank ``r`` on visible device ``r``) and gloo with
  ``--device cpu``.  This process is rank 0, the leader: it checks the
  split (typed :class:`~horovod_tpu_torch.serving.sharding.
  ShardingConfigError`) before it starts the N - 1 followers (this
  module again, the same flags), and only it listens for HTTP, journals
  and writes spans.  A follower dies with its leader (the kernel's
  parent-death signal, SIGKILL, set before it runs anything) and exits
  when the leader stops or is lost.

Lifecycle contract with the supervisor: SIGTERM / SIGINT -> graceful
drain, exit 0; the engine going terminally ``failed`` -> exit
:data:`~horovod_tpu_torch.serving.router.supervisor.
EXIT_CODE_REPLICA_FAILED`; ``--journal PATH`` journals in-flight
requests to a file the router reads after a SIGKILL to resume them on a
survivor; ``--fault site:kind[:skip[:delay]]`` arms a deterministic
FaultInjector, its skips counted from after warmup.

Run one by hand:

    python -m horovod_tpu_torch.serving.router.replica_main --port 8001 \\
        --seed 0 --warm 8 --device cpu [--tp 2]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import pickle
import signal
import subprocess
import sys
import threading

#: A follower rank's environment: its rank and the rendezvous port.
_TP_RANK = "HOROVOD_REPLICA_TP_RANK"
_TP_PORT = "HOROVOD_REPLICA_TP_PORT"


def dump_model(path: str, params, cfg) -> None:
    """Write a model where ``--params`` can load it, in the JAX
    package's format: the parameters as f32 numpy arrays (the port's
    tensors are in the JAX layout already) and the ``TransformerConfig``
    fields, the dtype by name."""
    import dataclasses

    import torch

    def host(x):
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items()}
        return x.detach().to("cpu", torch.float32).numpy()

    cfg_dict = dataclasses.asdict(cfg)
    cfg_dict["dtype"] = str(cfg.dtype).replace("torch.", "")
    with open(path, "wb") as f:
        pickle.dump({"params": host(params), "cfg": cfg_dict}, f)


def load_model(path: str, device=None):
    """A :func:`dump_model` pickle (either package's) -> ``(params on
    device, TransformerConfig)``.  Fields the port's config does not
    have (the JAX mixture-of-experts options) are dropped when the model
    is dense; a model with experts raises, as the port's config does."""
    import dataclasses

    import torch

    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.models.convert import params_from_jax

    with open(path, "rb") as f:
        blob = pickle.load(f)
    cfg_dict = dict(blob["cfg"])
    cfg_dict["dtype"] = getattr(torch, cfg_dict["dtype"])
    fields = {f.name for f in dataclasses.fields(T.TransformerConfig)}
    cfg = T.TransformerConfig(
        **{k: v for k, v in cfg_dict.items() if k in fields})
    return params_from_jax(blob["params"], cfg, device=device), cfg


def _config(args):
    import torch

    from horovod_tpu_torch.models import transformer as T

    return T.TransformerConfig(
        vocab_size=args.vocab, d_model=args.d_model,
        n_heads=args.n_heads, n_layers=args.n_layers, d_ff=args.d_ff,
        max_seq=args.max_seq, dtype=torch.float32,
        attention_impl="reference", n_kv_heads=args.kv_heads)


def build_model(args, device=None):
    from horovod_tpu_torch.models import transformer as T

    cfg = _config(args)
    return T.init_params(cfg, seed=args.seed, device=device), cfg


def parse_setting(text: str):
    """``name=value`` -> (name, typed value), same typing ladder as the
    replay CLI's settings (int → float → bool/none → str)."""
    if "=" not in text:
        raise argparse.ArgumentTypeError(
            f"--set wants name=value, got {text!r}")
    name, raw = text.split("=", 1)
    name = name.strip()
    raw = raw.strip()
    for cast in (int, float):
        try:
            return name, cast(raw)
        except ValueError:
            pass
    low = raw.lower()
    if low in ("true", "false"):
        return name, low == "true"
    if low in ("none", "null"):
        return name, None
    return name, raw


def parse_fault(text: str):
    """``site:kind[:skip[:delay]]`` -> FaultSpec."""
    from horovod_tpu_torch.serving.faults import FaultSpec

    parts = text.split(":")
    if len(parts) < 2:
        raise argparse.ArgumentTypeError(
            f"--fault wants site:kind[:skip[:delay]], got {text!r}")
    spec = {"site": parts[0], "kind": parts[1]}
    if len(parts) > 2:
        spec["skip"] = int(parts[2])
    if len(parts) > 3:
        spec["delay"] = float(parts[3])
    return FaultSpec(**spec)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="one supervised serving replica")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--params", default="",
                    help="pickle from dump_model() (overrides the "
                         "seeded-init shape flags)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=64)
    ap.add_argument("--d-model", type=int, default=32)
    ap.add_argument("--n-heads", type=int, default=4)
    ap.add_argument("--n-layers", type=int, default=2)
    ap.add_argument("--d-ff", type=int, default=64)
    ap.add_argument("--max-seq", type=int, default=48)
    ap.add_argument("--kv-heads", type=int, default=2)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: shard this replica's "
                         "engine over tp ranks, one process each "
                         "(heads + MLP hidden split, paged KV pool "
                         "head-sharded); this process leads and starts "
                         "the others")
    ap.add_argument("--device", default="cuda",
                    help="the engine's device: cuda (the default; no "
                         "CUDA device is an error) or cpu")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-queue-depth", type=int, default=64)
    ap.add_argument("--max-prefills-per-tick", type=int, default=2)
    ap.add_argument("--tick-timeout", type=float, default=60.0,
                    help="engine watchdog budget (0 disables)")
    ap.add_argument("--request-timeout", type=float, default=120.0)
    ap.add_argument("--drain-timeout", type=float, default=10.0)
    ap.add_argument("--journal", default="",
                    help="request-journal JSONL path (survives SIGKILL; "
                         "the router reads it post-mortem to resume "
                         "this replica's in-flight requests elsewhere)")
    ap.add_argument("--spans", default="",
                    help="span-stream JSONL path (distributed tracing; "
                         "the process label is the filename stem, e.g. "
                         "r0g1.spans.jsonl -> r0g1).  Flushed per "
                         "record, so a SIGKILL leaves the started "
                         "spans for the router's /trace autopsy")
    ap.add_argument("--span-latency-threshold", type=float, default=1.0,
                    help="tail-sampling latency threshold in seconds: "
                         "requests slower than this keep full tick-"
                         "level span detail")
    ap.add_argument("--span-head-rate", type=float, default=0.0,
                    help="deterministic head-sampling rate [0,1] for "
                         "full span detail on otherwise-boring requests")
    ap.add_argument("--no-resume", action="store_true",
                    help="disable in-engine restart-resume (in-flight "
                         "requests fail typed on a supervised restart, "
                         "the pre-journal behavior)")
    ap.add_argument("--warm", type=int, action="append", default=[],
                    help="prompt lengths to pre-compile before "
                         "accepting traffic (repeatable)")
    ap.add_argument("--autotune", action="store_true",
                    help="install the online autotuner after warmup "
                         "(GET /tuning exposes its state; needs "
                         "--warm so a warmed knob space exists — "
                         "docs/serving.md 'Autotuning')")
    ap.add_argument("--fault", type=parse_fault, action="append",
                    default=[], metavar="SITE:KIND[:SKIP[:DELAY]]",
                    help="deterministic FaultInjector spec (chaos "
                         "tests; repeatable)")
    ap.add_argument("--config-gen", type=int, default=0,
                    help="config-generation label stamped into the "
                         "engine's /stats (fleet rollouts; never read "
                         "by the engine itself)")
    ap.add_argument("--set", type=parse_setting, action="append",
                    default=[], dest="settings", metavar="NAME=VALUE",
                    help="extra EngineConfig field override, typed "
                         "like the replay CLI's settings (repeatable; "
                         "how a rollout candidate carries knobs with "
                         "no dedicated flag)")
    args = ap.parse_args(argv)

    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {args.device}: no CUDA device (pass --device cpu "
            "to serve on the CPU)")

    from horovod_tpu_torch import serving
    from horovod_tpu_torch.serving.router.supervisor import (
        EXIT_CODE_REPLICA_FAILED,
    )

    rank, followers = 0, []
    if args.tp > 1:
        rank, followers = _join_tp(args, argv)
        if rank:  # a follower: no listener, no journal, no spans
            args.spans = args.journal = ""

    if args.spans:
        from horovod_tpu_torch.obs import tracing as obs_tracing

        stem = os.path.basename(args.spans).split(".")[0]
        obs_tracing.start_spans(
            args.spans, proc=stem or f"pid{os.getpid()}",
            role="replica",
            sampling=obs_tracing.SpanSampling(
                latency_threshold_s=args.span_latency_threshold,
                head_rate=args.span_head_rate))

    device = args.device
    if args.tp > 1 and device.startswith("cuda"):
        device = f"cuda:{rank}"
    if args.params:
        params, cfg = load_model(args.params, device=device)
    else:
        params, cfg = build_model(args, device=device)

    # Armed EMPTY here; the specs are added AFTER warmup so their
    # skips are post-warmup relative (below) — a spec present during
    # warmup could fire inside it and burn its budget (or wedge the
    # replica) before the listener even exists.
    inj = serving.FaultInjector() if args.fault else None
    cfg_kwargs = dict(
        n_slots=args.slots, max_len=cfg.max_seq,
        max_queue_depth=args.max_queue_depth,
        max_prefills_per_tick=args.max_prefills_per_tick,
        tick_timeout=args.tick_timeout,
        autotune=args.autotune,
        resume=not args.no_resume,
        journal_path=args.journal or None, faults=inj,
        config_generation=args.config_gen, tp=args.tp)
    # --set overrides land LAST so a rollout candidate can retarget any
    # EngineConfig field, dedicated flag or not.
    cfg_kwargs.update(dict(args.settings))
    engine = serving.InferenceEngine(
        params, cfg, serving.EngineConfig(**cfg_kwargs), device=device)
    if args.warm or args.autotune:
        # Capture BEFORE the listener exists: the registry's first
        # successful poll means "routable", and a routable replica must
        # never capture a graph inside a request (or a tight watchdog
        # budget).  --autotune without --warm still warms the default
        # length: the tuner installs at the end of warmup and reads its
        # knob space from the graphs warmup captured.
        engine.warmup(sorted(set(args.warm)) or [1])
    if inj is not None:
        # --fault skips count from AFTER warmup (the post-warm
        # relative idiom from tests/test_chaos.py): how many probe
        # visits warmup itself spends is a pipeline internal no chaos
        # test should have to predict.
        for spec in args.fault:
            spec.skip += inj.visits(spec.site)
            inj.add(spec)

    if rank:
        # The leader's steps until it stops (exit 0) or is lost.
        engine.follow()
        return EXIT_CODE_REPLICA_FAILED if engine.terminal else 0

    stop_requested = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda signum, frame: stop_requested.set())

    srv = serving.ServingServer(
        engine, host=args.host, port=args.port,
        request_timeout=args.request_timeout).start()
    host, port = srv.address
    print(f"replica ready on {host}:{port} (slots={args.slots}, "
          f"device={engine.device}, pid={os.getpid()})", flush=True)

    failed = False
    while not stop_requested.is_set():
        if engine.terminal:
            failed = True
            break
        stop_requested.wait(0.2)

    srv.stop(drain_timeout=args.drain_timeout)
    for p in followers:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
    if args.spans:
        from horovod_tpu_torch.obs import tracing as obs_tracing

        obs_tracing.stop_spans()
    print(f"replica on port {port} stopped "
          f"(engine state: {engine.health})", flush=True)
    return EXIT_CODE_REPLICA_FAILED if failed else 0


def _die_with_parent() -> None:
    """SIGKILL this process when its parent dies (Linux
    ``PR_SET_PDEATHSIG``): a follower rank never outlives its leader."""
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(1, signal.SIGKILL, 0, 0, 0) != 0:  # PR_SET_PDEATHSIG
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG)")


def _join_tp(args, argv):
    """Rank 0 checks the split, starts the followers and joins the tp
    group with them; a follower (its rank in the environment) joins.
    Returns ``(rank, follower processes)``."""
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.serving.sharding import validate_tp
    from horovod_tpu_torch.serving.router.supervisor import _free_port

    rank = int(os.environ.get(_TP_RANK, "0"))
    followers = []
    if rank == 0:
        cfg = (load_model(args.params, device="cpu")[1] if args.params
               else _config(args))
        validate_tp(cfg, args.tp)
        port = _free_port()
        argv = list(sys.argv[1:] if argv is None else argv)
        for r in range(1, args.tp):
            env = dict(os.environ, **{_TP_RANK: str(r), _TP_PORT: str(port)})
            followers.append(subprocess.Popen(
                [sys.executable, "-m",
                 "horovod_tpu_torch.serving.router.replica_main", *argv],
                env=env, preexec_fn=_die_with_parent))
        print("tp followers: " + " ".join(str(p.pid) for p in followers),
              flush=True)
        os.environ[_TP_PORT] = str(port)
    else:
        if os.getppid() == 1:  # the leader died before the signal was set
            sys.exit(1)
        # The leader's stop ends a follower (a signal to the process
        # group must not kill it under a draining leader).
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, signal.SIG_IGN)
    for var, val in (("HOROVOD_RANK", rank), ("HOROVOD_SIZE", args.tp),
                     ("HOROVOD_LOCAL_RANK", rank),
                     ("HOROVOD_LOCAL_SIZE", args.tp),
                     ("HOROVOD_NATIVE", 0)):
        os.environ[var] = str(val)
    basics.init(device=args.device if args.device == "cpu"
                else f"cuda:{rank}",
                init_method=f"tcp://127.0.0.1:{os.environ[_TP_PORT]}")
    return rank, followers


if __name__ == "__main__":
    sys.exit(main())
