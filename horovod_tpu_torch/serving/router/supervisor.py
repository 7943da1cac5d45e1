"""ReplicaSupervisor: keep N engine replicas alive, forever.

The port of ``horovod_tpu/serving/router/supervisor.py``, code for code
(``tests/test_torch_port_router.py`` compares the syntax trees) but
for four departures:

* :func:`_free_port` lives here: the port has no ``runner/`` package
  yet, whose ``run_func`` holds the JAX one;
* the spawned module is :mod:`horovod_tpu_torch.serving.router.
  replica_main`;
* :class:`ReplicaSpec` carries ``device`` (``"cuda"`` unless the caller
  asks for ``"cpu"``), rendered as ``--device``: every replica process
  opens its own CUDA context on the card, no NCCL between them;
* a ``tp > 1`` spec gets no ``XLA_FLAGS`` (its replica refuses
  ``--tp > 1``: tensor-parallel serving is not ported), only the
  visible-devices pinning.

Replicas are independent: a death never touches the survivors, the dead
slot respawns alone (exponential backoff, unbounded restarts) while the
registry keeps routing to the rest.  A replica whose engine went
terminally ``failed`` exits with :data:`EXIT_CODE_REPLICA_FAILED`; one
that is alive but unroutable past ``unhealthy_grace`` (or never routable
within ``startup_timeout``) is drained: SIGTERM, ``shutdown_grace``,
SIGKILL.  Each spawn gets a fresh port and identity ``r<slot>g<gen>``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from horovod_tpu_torch.serving.router.registry import (
    ReplicaEndpoint,
    ReplicaRegistry,
)

logger = logging.getLogger("horovod_tpu_torch")

__all__ = ["EXIT_CODE_REPLICA_FAILED", "ReplicaHandle", "ReplicaSpec",
           "ReplicaSupervisor"]

#: A replica whose engine went terminally ``failed`` exits with this
#: code (cf. the elastic worker's EXIT_CODE_RESTART=75): the exit
#: watcher sees an unambiguous "engine dead, process fine" and
#: respawns without waiting for the registry to notice.
EXIT_CODE_REPLICA_FAILED = 76


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclasses.dataclass
class ReplicaSpec:
    """What one replica process serves — rendered into a
    ``python -m horovod_tpu_torch.serving.router.replica_main`` command line.

    Either ``params_path`` (a pickle written by
    :func:`horovod_tpu_torch.serving.router.replica_main.dump_model` — the
    trained-model path ``examples/serve.py --replicas`` uses) or the
    model-shape fields + ``seed`` (deterministic init, what the tests
    use: every replica built from the same seed serves oracle-identical
    greedy output).  ``faults`` are replica-side FaultInjector specs
    (``site:kind[:skip[:delay]]``) for chaos tests.
    """

    params_path: Optional[str] = None
    seed: int = 0
    vocab: int = 64
    d_model: int = 32
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 64
    max_seq: int = 48
    n_kv_heads: int = 2
    #: tensor-parallel degree per replica, rendered as ``--tp``; the
    #: port's replica refuses anything above 1 (tensor-parallel serving
    #: is not ported).
    tp: int = 1
    slots: int = 4
    max_queue_depth: int = 64
    max_prefills_per_tick: int = 2
    tick_timeout: float = 60.0
    request_timeout: float = 120.0
    drain_timeout: float = 10.0
    warm: Sequence[int] = ()
    faults: Sequence[str] = ()
    #: Config-generation label (docs/serving.md "Fleet rollouts"):
    #: stamped into the replica's EngineConfig and echoed through its
    #: /stats so the rollout controller can prove which config a live
    #: process was built at.  0 = the incumbent baseline.
    config_gen: int = 0
    #: Extra EngineConfig overrides rendered as repeatable
    #: ``--set name=value`` flags (typed like replay's settings:
    #: int/float/bool/none/str) — how a rollout candidate carries
    #: engine knobs that have no dedicated CLI flag.
    engine_knobs: Dict[str, object] = dataclasses.field(
        default_factory=dict)
    extra_args: Sequence[str] = ()
    #: The replica's device: ``"cuda"`` (each replica opens its own CUDA
    #: context on the card) unless the caller asks for ``"cpu"``.
    device: str = "cuda"

    def command(self, port: int, host: str = "127.0.0.1") -> List[str]:
        cmd = [sys.executable, "-m",
               "horovod_tpu_torch.serving.router.replica_main",
               "--host", host,
               "--port", str(port),
               "--slots", str(self.slots),
               "--max-queue-depth", str(self.max_queue_depth),
               "--max-prefills-per-tick", str(self.max_prefills_per_tick),
               "--tick-timeout", repr(self.tick_timeout),
               "--request-timeout", repr(self.request_timeout),
               "--drain-timeout", repr(self.drain_timeout),
               "--device", self.device]
        if self.params_path:
            cmd += ["--params", self.params_path]
        else:
            cmd += ["--seed", str(self.seed),
                    "--vocab", str(self.vocab),
                    "--d-model", str(self.d_model),
                    "--n-heads", str(self.n_heads),
                    "--n-layers", str(self.n_layers),
                    "--d-ff", str(self.d_ff),
                    "--max-seq", str(self.max_seq),
                    "--kv-heads", str(self.n_kv_heads)]
        if self.tp > 1:
            cmd += ["--tp", str(self.tp)]
        for w in self.warm:
            cmd += ["--warm", str(w)]
        for f in self.faults:
            cmd += ["--fault", f]
        if self.config_gen:
            cmd += ["--config-gen", str(self.config_gen)]
        for name, value in self.engine_knobs.items():
            rendered = ("none" if value is None
                        else str(value).lower() if isinstance(value, bool)
                        else str(value))
            cmd += ["--set", f"{name}={rendered}"]
        cmd += list(self.extra_args)
        return cmd


@dataclasses.dataclass
class ReplicaHandle:
    """One supervised replica slot's live process."""

    slot: int
    gen: int
    port: int
    proc: subprocess.Popen
    spawned_at: float
    restarts: int = 0            # respawns of this SLOT so far
    term_sent_at: Optional[float] = None
    kill_sent: bool = False      # drain escalated to SIGKILL (once)
    unroutable_since: Optional[float] = None

    @property
    def rid(self) -> str:
        return f"r{self.slot}g{self.gen}"

    @property
    def pid(self) -> int:
        return self.proc.pid


class ReplicaSupervisor:
    """Spawn, monitor, drain, and respawn N replica processes.

    ``spec`` is a :class:`ReplicaSpec` or a callable
    ``(slot, port) -> command list`` for custom replica programs.  The
    supervisor feeds the shared ``registry`` (creating one when not
    given): endpoints are added at spawn and removed at reap, so the
    router's routing set always reflects live processes — readiness
    itself comes from the registry's polls.
    """

    def __init__(self, spec, n_replicas: int, *,
                 registry: Optional[ReplicaRegistry] = None,
                 host: str = "127.0.0.1",
                 env: Optional[Dict[str, str]] = None,
                 backoff_initial: float = 0.5,
                 backoff_max: float = 10.0,
                 backoff_reset_after: float = 30.0,
                 shutdown_grace: float = 5.0,
                 unhealthy_grace: float = 5.0,
                 startup_timeout: float = 300.0,
                 monitor_interval: float = 0.1,
                 log_dir: Optional[str] = None,
                 journal_dir: Optional[str] = None,
                 span_dir: Optional[str] = None) -> None:
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        self._spec = spec
        self.n_replicas = n_replicas
        self.registry = registry if registry is not None \
            else ReplicaRegistry()
        self._host = host
        self._env = env
        self._backoff_initial = backoff_initial
        self._backoff_max = backoff_max
        self._backoff_reset_after = backoff_reset_after
        self._shutdown_grace = shutdown_grace
        self._unhealthy_grace = unhealthy_grace
        self._startup_timeout = startup_timeout
        self._monitor_interval = monitor_interval
        self._log_dir = log_dir
        # Request-journal files (docs/serving.md "Front tier"): each
        # replica journals its in-flight decode state to
        # journal_dir/<rid>.journal.jsonl; the mapping OUTLIVES the
        # process (kept after reap) so the router can read a SIGKILL'd
        # replica's journal post-mortem and resume its requests
        # elsewhere (RouterServer(resume_lookup=sup.resume_lookup)).
        self._journal_dir = journal_dir
        self._journal_paths: Dict[str, str] = {}
        # Span streams (docs/observability.md "Distributed tracing"):
        # each replica generation appends spans to
        # span_dir/<rid>.spans.jsonl; the directory is what
        # RouterServer(span_dir=...) assembles GET /trace/<id> from —
        # a SIGKILL'd generation's stream is exactly the evidence the
        # autopsy needs, so files survive the reap (pruned past gen-1
        # like journals, bounding crash loops).
        self._span_dir = span_dir
        self._span_paths: Dict[str, str] = {}
        self._lock = threading.Lock()
        self._handles: Dict[int, ReplicaHandle] = {}   # slot -> handle
        self._respawn_at: Dict[int, float] = {}        # slot -> monotonic
        self._gen: Dict[int, int] = {}
        # Per-slot spec overrides (rollout controller): a slot with an
        # override respawns at THAT spec instead of self._spec — the
        # mechanism by which a rolling reconfiguration rebuilds one
        # replica at a time while the rest keep the incumbent config.
        self._slot_specs: Dict[int, ReplicaSpec] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ReplicaSupervisor":
        if self._thread is not None:
            return self
        self._stop.clear()
        for slot in range(self.n_replicas):
            self._spawn(slot)
        self._thread = threading.Thread(
            target=self._monitor_loop, name="replica-supervisor",
            daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop supervision and tear every replica down — gracefully
        (SIGTERM → replica drain) when ``drain``, escalating to
        SIGKILL after ``shutdown_grace`` either way."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
        with self._lock:
            handles = list(self._handles.values())
            self._handles.clear()
            self._respawn_at.clear()
        for h in handles:
            self.registry.remove(h.rid)
            if h.proc.poll() is None:
                self._signal(h, signal.SIGTERM if drain else signal.SIGKILL)
        deadline = time.monotonic() + self._shutdown_grace
        for h in handles:
            while h.proc.poll() is None and time.monotonic() < deadline:
                time.sleep(0.05)
            if h.proc.poll() is None:
                if drain:
                    h.kill_sent = True
                    self.registry.metrics.drain_timeouts.inc()
                    self._instant("replica_drain_timeout",
                                  {"rid": h.rid, "pid": h.pid,
                                   "grace_s": self._shutdown_grace})
                    logger.warning(
                        "router: replica %s (pid %d) did not drain "
                        "within shutdown_grace=%.1fs at stop; "
                        "escalating to SIGKILL", h.rid, h.pid,
                        self._shutdown_grace)
                self._signal(h, signal.SIGKILL)
                h.proc.wait()

    def wait_ready(self, n: Optional[int] = None,
                   timeout: float = 300.0) -> bool:
        """Block until ``n`` (default: all) replicas are in rotation.
        The registry poll thread must be running (RouterServer.start
        does that) — or poll here when it is not."""
        want = self.n_replicas if n is None else n
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.registry._thread is None:
                self.registry.poll_now()
            if len(self.registry.in_rotation()) >= want:
                return True
            time.sleep(0.1)
        return False

    def replicas(self) -> List[ReplicaHandle]:
        with self._lock:
            return list(self._handles.values())

    def handle(self, slot: int) -> Optional[ReplicaHandle]:
        with self._lock:
            return self._handles.get(slot)

    # -- per-slot spec overrides (rollout controller) ----------------------

    @property
    def spec(self):
        """The fleet-wide base spec (ReplicaSpec or command callable)."""
        return self._spec

    def set_base_spec(self, spec: ReplicaSpec) -> None:
        """Promote ``spec`` to the fleet-wide base and drop every slot
        override — the rollout controller's final act after a full
        promotion (from here on, ANY respawn lands on the new config)."""
        with self._lock:
            self._spec = spec
            self._slot_specs.clear()

    def slot_spec(self, slot: int):
        """The spec ``slot`` will (re)spawn at: its override when the
        rollout controller set one, else the fleet-wide base spec."""
        with self._lock:
            return self._slot_specs.get(slot, self._spec)

    def set_slot_spec(self, slot: int, spec: ReplicaSpec) -> None:
        """Override ``slot``'s spec — takes effect on its NEXT spawn
        (the rollout controller drains the slot to trigger one)."""
        if callable(self._spec):
            raise TypeError(
                "slot spec overrides require a ReplicaSpec base, not a "
                "callable command factory")
        with self._lock:
            self._slot_specs[slot] = spec

    def clear_slot_spec(self, slot: int) -> None:
        with self._lock:
            self._slot_specs.pop(slot, None)

    def drain_slot(self, slot: int,
                   reason: str = "rollout") -> Optional[ReplicaHandle]:
        """Start the graceful drain of one slot's live process (SIGTERM
        → the replica's drain handler; the monitor escalates to SIGKILL
        after ``shutdown_grace``).  The exit watcher then respawns the
        slot at :meth:`slot_spec` — this is the rollout controller's
        one-replica-at-a-time rebuild primitive.  Returns the handle
        being drained (None for an empty slot)."""
        with self._lock:
            h = self._handles.get(slot)
        if h is None or h.proc.poll() is not None:
            return h
        if h.term_sent_at is None:
            h.term_sent_at = time.monotonic()
            self._instant("replica_drain",
                          {"rid": h.rid, "pid": h.pid, "reason": reason})
            logger.info("router: draining replica %s (pid %d) for %s",
                        h.rid, h.pid, reason)
            self._signal(h, signal.SIGTERM)
        return h

    # -- spawn / reap ------------------------------------------------------

    def _command(self, slot: int, port: int,
                 journal_path: Optional[str] = None,
                 span_path: Optional[str] = None) -> List[str]:
        if callable(self._spec):
            # Custom commands own their bind address; the registry
            # still polls self._host, so the callable must agree.
            # (Journaling/span streams are replica_main plumbing —
            # custom programs arm their own.)
            return list(self._spec(slot, port))
        cmd = self.slot_spec(slot).command(port, self._host)
        if journal_path:
            cmd += ["--journal", journal_path]
        if span_path:
            cmd += ["--spans", span_path]
        return cmd

    def resume_lookup(self, rid: str, trace_id: str) -> Optional[Dict]:
        """Post-mortem resume descriptor for ``trace_id`` on replica
        ``rid`` — reads the (possibly dead) replica's journal file.
        Wire this into ``RouterServer(resume_lookup=...)``; it keeps
        working after the reap removed the endpoint from the
        registry."""
        path = self._journal_paths.get(rid)
        if not path:
            return None
        try:
            from horovod_tpu_torch.serving.journal import RequestJournal

            return RequestJournal.read_live(path).get(trace_id)
        except Exception:  # pragma: no cover - post-mortem best effort
            return None

    def _arm_gen_file(self, base_dir: Optional[str], paths: Dict[str, str],
                      slot: int, gen: int, suffix: str) -> Optional[str]:
        """One per-generation artifact file (journal or span stream):
        create its path under ``base_dir``, record it in ``paths``
        (the mapping OUTLIVES the process so post-mortem readers keep
        working after the reap), and prune this slot's generations
        older than gen-1 — the previous generation is live evidence
        the router may be reading right now, anything older is
        bounded away so a crash loop cannot grow the directory."""
        if not base_dir or callable(self._spec):
            return None
        os.makedirs(base_dir, exist_ok=True)
        path = os.path.join(base_dir, f"r{slot}g{gen}.{suffix}")
        paths[f"r{slot}g{gen}"] = path
        for g in range(gen - 1):
            old = paths.pop(f"r{slot}g{g}", None)
            if old:
                try:
                    os.remove(old)
                except OSError:
                    pass
        return path

    def _spawn(self, slot: int) -> None:
        gen = self._gen.get(slot, -1) + 1
        self._gen[slot] = gen
        port = _free_port()
        env = dict(os.environ)
        if self._env:
            env.update(self._env)
        # The replica must import horovod_tpu_torch no matter where the
        # supervisor's process got it from (checkout, PYTHONPATH, or
        # bare cwd): pin the package's own root onto the child's path.
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        env["PYTHONPATH"] = (pkg_root + os.pathsep + env["PYTHONPATH"]
                             if env.get("PYTHONPATH") else pkg_root)
        # A tp > 1 spec gets a disjoint set of visible devices per slot
        # (stable across respawns); an operator who already pinned the
        # env wins.  Its replica refuses --tp > 1 (tensor-parallel
        # serving is not ported), so no XLA flag is set here.
        spec = self.slot_spec(slot)
        tp = getattr(spec, "tp", 1) if not callable(spec) else 1
        if tp > 1:
            ordinals = ",".join(str(slot * tp + i) for i in range(tp))
            for var in ("CUDA_VISIBLE_DEVICES", "TPU_VISIBLE_DEVICES"):
                if var not in env:
                    env[var] = ordinals
        prev = self._handles.get(slot)
        restarts = prev.restarts + 1 if prev is not None else 0
        journal_path = self._arm_gen_file(
            self._journal_dir, self._journal_paths, slot, gen,
            "journal.jsonl")
        span_path = self._arm_gen_file(
            self._span_dir, self._span_paths, slot, gen, "spans.jsonl")
        out = subprocess.DEVNULL
        if self._log_dir:
            os.makedirs(self._log_dir, exist_ok=True)
            out = open(os.path.join(self._log_dir,
                                    f"r{slot}g{gen}.log"), "wb")
        proc = subprocess.Popen(
            self._command(slot, port, journal_path, span_path), env=env,
            stdout=out, stderr=subprocess.STDOUT if self._log_dir
            else subprocess.DEVNULL,
            start_new_session=True)
        if out is not subprocess.DEVNULL:
            out.close()  # the child holds its own fd now
        h = ReplicaHandle(slot=slot, gen=gen, port=port, proc=proc,
                          spawned_at=time.monotonic(), restarts=restarts)
        with self._lock:
            self._handles[slot] = h
            self._respawn_at.pop(slot, None)
        self.registry.add(ReplicaEndpoint(h.rid, self._host, port,
                                          journal_path=journal_path))
        self._instant("replica_spawn" if gen == 0 else "replica_respawn",
                      {"rid": h.rid, "pid": proc.pid, "port": port})
        if gen:
            self.registry.metrics.replica_restarts.inc()
            logger.warning(
                "router: respawned replica slot %d as %s (pid %d, "
                "port %d, restart #%d)", slot, h.rid, proc.pid, port,
                restarts)

    def _signal(self, h: ReplicaHandle, sig: int) -> None:
        try:
            # The whole session: a replica that forked helpers dies
            # with them (start_new_session=True above).
            os.killpg(os.getpgid(h.proc.pid), sig)
        except (ProcessLookupError, PermissionError, OSError):
            try:
                h.proc.send_signal(sig)
            except (ProcessLookupError, OSError):
                pass

    # -- monitor -----------------------------------------------------------

    def _monitor_loop(self) -> None:
        while not self._stop.wait(self._monitor_interval):
            try:
                self._sweep()
            except Exception:  # pragma: no cover - supervision survives
                logger.exception("router: supervisor sweep failed")

    def _sweep(self) -> None:
        now = time.monotonic()
        routable = {s.endpoint.rid
                    for s in self.registry.in_rotation()}
        with self._lock:
            handles = list(self._handles.items())
        for slot, h in handles:
            rc = h.proc.poll()
            if rc is not None:
                self._reap(slot, h, rc, now)
                continue
            # Health policing over the registry's view: a live process
            # whose replica is terminally failed, wedged (stale
            # heartbeat), or unreachable gets the drain sequence.
            if h.rid in routable:
                h.unroutable_since = None
                if h.term_sent_at is None:
                    continue
            if h.term_sent_at is not None:
                if (now - h.term_sent_at >= self._shutdown_grace
                        and not h.kill_sent):
                    # Drain blew its budget: count it, mark the
                    # timeline, and escalate ONCE — in-flight requests
                    # now fail over via the journal instead of
                    # finishing locally.
                    h.kill_sent = True
                    self.registry.metrics.drain_timeouts.inc()
                    self._instant("replica_drain_timeout",
                                  {"rid": h.rid, "pid": h.pid,
                                   "grace_s": self._shutdown_grace})
                    logger.warning(
                        "router: replica %s (pid %d) drain exceeded "
                        "shutdown_grace=%.1fs; escalating to SIGKILL",
                        h.rid, h.pid, self._shutdown_grace)
                    self._signal(h, signal.SIGKILL)
                continue
            if h.unroutable_since is None:
                h.unroutable_since = now
                continue
            grace = (self._unhealthy_grace
                     if self._was_ready(h) else self._startup_timeout)
            if now - h.unroutable_since >= grace:
                logger.warning(
                    "router: replica %s (pid %d) unroutable for %.1fs; "
                    "draining and respawning", h.rid, h.pid,
                    now - h.unroutable_since)
                self._instant("replica_drain", {"rid": h.rid,
                                                "pid": h.pid})
                h.term_sent_at = now
                self._signal(h, signal.SIGTERM)

    def _was_ready(self, h: ReplicaHandle) -> bool:
        for s in self.registry.statuses():
            if s.endpoint.rid == h.rid:
                return s.ever_routable
        return False

    def _reap(self, slot: int, h: ReplicaHandle, rc: int,
              now: float) -> None:
        with self._lock:
            if self._handles.get(slot) is not h:
                return  # already replaced
            first = slot not in self._respawn_at
            if first:
                if now - h.spawned_at >= self._backoff_reset_after:
                    # Survived long enough: this death starts a FRESH
                    # backoff sequence (crash loops back off, steady
                    # replicas respawn instantly).
                    h.restarts = -1  # _spawn adds 1 -> 0
                    backoff = 0.0
                else:
                    backoff = min(
                        self._backoff_initial * (2.0 ** h.restarts),
                        self._backoff_max)
                self._respawn_at[slot] = now + backoff
            when = self._respawn_at[slot]
        if first:
            self.registry.remove(h.rid)
            self._instant("replica_exit", {"rid": h.rid, "pid": h.pid,
                                           "exit_code": rc})
            logger.warning(
                "router: replica %s (pid %d) exited with code %s%s%s",
                h.rid, h.pid, rc,
                " (engine terminally failed)"
                if rc == EXIT_CODE_REPLICA_FAILED else "",
                " (drain timed out; was SIGKILLed)"
                if h.kill_sent else "")
        if now >= when and not self._stop.is_set():
            self._spawn(slot)

    @staticmethod
    def _instant(name: str, args: Dict) -> None:
        try:
            from horovod_tpu_torch.obs import tracing as obs_tracing

            obs_tracing.instant(name, args)
        except Exception:  # pragma: no cover
            pass
