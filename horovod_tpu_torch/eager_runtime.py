"""Eager-path runtime: Python side of the native control plane.

Counterpart of ``horovod_tpu/eager_runtime.py``.  Wires the native library
(:mod:`horovod_tpu_torch.native` — negotiation, fusion planning, response
cache, stall inspection, timeline) to the eager data plane, the
``torch.distributed`` collectives of :mod:`horovod_tpu_torch.ops.collectives`
(NCCL on the card, gloo on the CPU).

Division of labor, mirroring the reference's architecture
(``common/operations.cc`` background loop -> ``ops/*`` execution):

* Python enqueues a named request per eager collective and blocks on a
  handle (the reference's framework-binding role,
  ``torch/mpi_ops_v2.cc:52-79``).
* The native background thread negotiates global readiness each cycle and
  calls back into :meth:`EagerRuntime._execute` with a (possibly fused)
  Response (the reference's ``PerformOperation``,
  ``common/operations.cc:295``).
* ``_execute`` runs the collective over the runtime's own process group
  (every rank, made at :func:`start`, so a negotiated collective never
  shares a communicator with a direct one) and parks results until the
  waiting caller collects them.  A fused allreduce is ``torch.cat`` of
  the flattened inputs, one ``all_reduce``, and views split back out.

On the card the executor orders itself against the submitter, as
upstream Horovod's ``horovod/torch/ready_event.cc`` does: a CUDA event
recorded on the caller's current stream at submission, which the
executor's own stream waits on before the collective; the waiter's
stream then waits on an event the executor recorded after it.  The
current device is thread-local, so the executor sets it on its thread.

A rank that has Joined keeps executing responses with zero-filled inputs
(the reference's zero-tensor substitution, ``global_state.h:104-107``),
on its own device, in the response's dtype.

Departures from the JAX module: :func:`start` raises when the library
cannot be built or the runtime cannot start (JAX returns None and falls
back to its direct path; here only ``HOROVOD_NATIVE=0`` takes it), and a
submission refused by a runtime that has stopped (a peer gone, a shutdown)
raises :class:`CollectiveError`, as a failed wait does.
"""

from __future__ import annotations

import atexit
import itertools
import os
import threading
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from horovod_tpu_torch import basics
from horovod_tpu_torch import native

_OP_TO_NATIVE = {}
_NATIVE_TO_OP = {}


def _op_maps():
    from horovod_tpu_torch.ops import collectives as C

    global _OP_TO_NATIVE, _NATIVE_TO_OP
    if not _OP_TO_NATIVE:
        _OP_TO_NATIVE = {
            C.Average: native.OP_AVERAGE,
            C.Sum: native.OP_SUM,
            C.Adasum: native.OP_ADASUM,
            C.Min: native.OP_MIN,
            C.Max: native.OP_MAX,
            C.Product: native.OP_PRODUCT,
        }
        _NATIVE_TO_OP = {v: k for k, v in _OP_TO_NATIVE.items()}
    return _OP_TO_NATIVE, _NATIVE_TO_OP


class CollectiveError(RuntimeError):
    """A collective failed — coordinator-detected mismatch, stall shutdown,
    or abort (reference: Response::ERROR delivered to the status callback)."""


class EagerRuntime:
    def __init__(self, rt: "native.NativeRuntime", group,
                 device: torch.device) -> None:
        self._rt = rt
        self._group = group
        self._device = device
        self._cuda = device.type == "cuda"
        self._stream = (torch.cuda.Stream(self._device) if self._cuda
                        else None)
        self._lock = threading.Lock()
        # name -> (tensor, the submitter's CUDA event or None)
        self._inputs: Dict[str, Any] = {}
        # name -> (result, the executor's CUDA event or None)
        self._results: Dict[str, Any] = {}
        self._counters = {k: itertools.count() for k in
                          ("allreduce", "allgather", "broadcast", "alltoall",
                           "reducescatter", "barrier")}
        # Fusion observability (reference timeline's per-response grouping,
        # as cheap counters): responses executed vs tensors they carried —
        # tensors/responses is the achieved fusion ratio.  Mirrored into
        # the process registry so /metrics scrapes see the eager path.
        self.responses_executed = 0
        self.tensors_executed = 0
        try:
            from horovod_tpu_torch.obs.registry import default_registry

            r = default_registry()
            self._m_responses = r.counter(
                "eager_responses_executed_total",
                "Eager collective responses executed (post-fusion groups)",
                exist_ok=True)
            self._m_tensors = r.counter(
                "eager_tensors_executed_total",
                "Tensors carried by executed eager responses "
                "(tensors/responses = achieved fusion ratio)",
                exist_ok=True)
        except Exception:  # pragma: no cover - metrics never gate eager ops
            self._m_responses = self._m_tensors = None
        rt.set_executor(self._execute)

    # ---- naming (reference: "allreduce.noname.N" convention in the torch
    # binding when no name is given; deterministic because every rank issues
    # eager ops in the same program order) --------------------------------

    def auto_name(self, kind: str, name: Optional[str]) -> str:
        if name:
            return name
        return f"{kind}.noname.{next(self._counters[kind])}"

    # ---- submission ------------------------------------------------------

    def submit(self, name: str, op_type: int, x: torch.Tensor, *,
               reduce_op: int = 0, root_rank: int = 0,
               prescale: float = 1.0, postscale: float = 1.0) -> int:
        ready = None
        if x.is_cuda:
            # ready_event.cc: the executor's stream waits for the work the
            # caller queued on its stream before submitting.
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(x.device))
        with self._lock:
            if name in self._inputs:
                raise CollectiveError(
                    f"tensor name {name!r} already pending (duplicate "
                    "submission race — reference DUPLICATE_NAME_ERROR)")
            self._inputs[name] = (x, ready)
        try:
            return self._rt.enqueue(
                name, op_type, tuple(x.shape), x.dtype,
                reduce_op=reduce_op, root_rank=root_rank,
                prescale=prescale, postscale=postscale)
        except Exception as e:
            with self._lock:
                self._inputs.pop(name, None)
            if isinstance(e, native.NativeError) \
                    and e.code != native.STATUS_DUPLICATE:
                raise CollectiveError(str(e)) from e
            raise

    def submit_barrier(self) -> int:
        name = self.auto_name("barrier", None)
        return self._rt.enqueue(name, native.BARRIER, (), torch.uint8)

    def barrier(self) -> None:
        try:
            self._rt.wait(self.submit_barrier())
        except native.NativeError as e:
            raise CollectiveError(str(e)) from e

    def join(self) -> int:
        """Block until all ranks joined (native JOIN accounting; this rank's
        executor keeps contributing zeros meanwhile).  Returns the rank
        that joined LAST, as observed by the coordinator (reference DoJoin
        contract — the rank holding the most-advanced state)."""
        try:
            self._rt.wait(self._rt.enqueue_join())
        except native.NativeError as e:
            raise CollectiveError(str(e)) from e
        return self._rt.last_joined_rank()

    def last_joined_rank(self) -> int:
        return self._rt.last_joined_rank()

    def poll(self, handle: int) -> bool:
        return self._rt.poll(handle)

    def wait(self, handle: int, name: str) -> torch.Tensor:
        try:
            self._rt.wait(handle)
        except native.NativeError as e:
            with self._lock:
                self._inputs.pop(name, None)
                self._results.pop(name, None)
            raise CollectiveError(str(e)) from e
        with self._lock:
            if name not in self._results:
                self._inputs.pop(name, None)
                raise CollectiveError(f"no result produced for {name!r}")
            out, done = self._results.pop(name)
        if done is not None:
            # The caller's stream waits for the collective, and the
            # result (allocated on the executor's stream) is not reused
            # before the caller's stream is done with it.
            cur = torch.cuda.current_stream(out.device)
            cur.wait_event(done)
            out.record_stream(cur)
        with self._lock:
            # Dropped only now: the caller's stream has waited for the
            # executor's reads of it.
            self._inputs.pop(name, None)
        return out

    # ---- execution callback (native background thread) -------------------

    def _execute(self, resp: "native.Response") -> int:
        self.responses_executed += 1
        self.tensors_executed += len(resp.tensor_names)
        if self._m_responses is not None:
            self._m_responses.inc()
            self._m_tensors.inc(len(resp.tensor_names))
        try:
            if not self._cuda:
                return self._run(resp)
            torch.cuda.set_device(self._device)  # thread-local
            with torch.cuda.stream(self._stream):
                return self._run(resp)
        except Exception:
            import traceback

            traceback.print_exc()
            return native.STATUS_INVALID

    def _run(self, resp: "native.Response") -> int:
        from horovod_tpu_torch.ops import adasum as _ad
        from horovod_tpu_torch.ops import collectives as C

        _, to_op = _op_maps()
        with self._lock:
            inputs = []
            mine = []  # whether this rank actually submitted each tensor
            for tname, shape in zip(resp.tensor_names, resp.shapes):
                if tname in self._inputs:
                    x, ready = self._inputs[tname]
                    if ready is not None:
                        self._stream.wait_event(ready)
                    inputs.append(x)
                    mine.append(True)
                else:
                    # Joined rank: contribute zeros.
                    inputs.append(torch.zeros(
                        shape, dtype=native.dtype_of(resp.dtype),
                        device=self._device))
                    mine.append(False)

        g = self._group
        w = C._world(g)
        # The runtime's collectives are flat, as the JAX eager path is;
        # HOROVOD_HIERARCHICAL_* shape the direct path and the step.
        with C._hierarchical(False):
            if resp.type == native.ALLREDUCE:
                op = to_op[resp.op]
                pre = resp.prescale if resp.prescale != 1.0 else None
                post = resp.postscale if resp.postscale != 1.0 else None
                if op == C.Adasum:
                    # Fused Adasum keeps PER-TENSOR coefficients
                    # (reference adasum.h FusedAllreduce): concatenating
                    # would collapse the group to one global dot product.
                    ins = [C._scale_(a.clone(), pre) for a in inputs]
                    outs = [C._scale_(o, post) for o in
                            _ad.adasum_allreduce_group(ins, group=g,
                                                       eager=True)]
                else:
                    flat = (torch.cat([a.reshape(-1) for a in inputs])
                            if len(inputs) > 1 else
                            inputs[0].reshape(-1).clone())
                    red = C._allreduce_start(flat, op, pre, post, False,
                                             w).wait()
                    outs = [piece.view(a.shape) for a, piece in zip(
                        inputs, red.split([a.numel() for a in inputs]))]
            elif resp.type == native.ALLGATHER:
                outs = [C._allgather_start(inputs[0], False, w).wait()]
            elif resp.type == native.BROADCAST:
                outs = [C._broadcast_start(inputs[0].clone(), resp.root_rank,
                                           False, w).wait()]
            elif resp.type == native.ALLTOALL:
                outs = [C._alltoall_start(inputs[0], None, False, w).wait()]
            elif resp.type == native.RESP_REDUCESCATTER:
                outs = [C._reducescatter_start(inputs[0], to_op[resp.op],
                                               False, w).wait()]
            else:
                return native.STATUS_INVALID

        done = None
        if self._cuda:
            done = torch.cuda.Event()
            done.record(self._stream)
        with self._lock:
            for tname, out, is_mine in zip(resp.tensor_names, outs, mine):
                if is_mine:
                    self._results[tname] = (out, done)
        return native.STATUS_OK

    # ---- introspection ---------------------------------------------------

    def cycles(self) -> int:
        return self._rt.cycles()

    def cache_hits(self) -> int:
        return self._rt.cache_hits()

    def cache_entries(self) -> int:
        return self._rt.cache_entries()

    def joined_count(self) -> int:
        """Coordinator-observed count of currently-joined ranks (0 on
        non-coordinator ranks)."""
        return self._rt.joined_count()

    def set_fusion_bytes(self, nbytes: int) -> None:
        """Adjust the native fusion planner's threshold (autotuner knob —
        reference ParameterManager -> TensorFusionThresholdBytes)."""
        self._rt.set_fusion_bytes(int(nbytes))

    def set_cycle_ms(self, ms: float) -> None:
        """Adjust the background negotiation cycle time (autotuner knob —
        reference HOROVOD_CYCLE_TIME / ParameterManager joint BO)."""
        self._rt.set_cycle_us(int(ms * 1000))

    def set_cache_capacity(self, n: int) -> None:
        """Resize (and clear) the response cache; applied by the
        background thread between cycles.  The bit-vector protocol pads
        length mismatches during propagation, so ranks may apply this at
        slightly different cycles without error."""
        self._rt.set_cache_capacity(int(n))

    def shutdown(self) -> None:
        self._rt.shutdown()


# ---- lifecycle ---------------------------------------------------------------

_runtime: Optional[EagerRuntime] = None
_start_lock = threading.Lock()


def enabled_by_env() -> bool:
    return os.environ.get("HOROVOD_NATIVE", "1") not in ("0", "false", "")


def native_port() -> int:
    """``HOROVOD_NATIVE_PORT``, else the JAX package's rule: the
    coordinator port + 3, offset by 2 per elastic epoch, else 9374."""
    # Distinct from the rendezvous KV port and the coordination port
    # (KV+2): the native control plane listens on KV+3.  Elastic
    # restarts offset by the rendezvous epoch so a relaunch never
    # races the dead epoch's lingering listener (the ElasticDriver
    # also exports a fresh HOROVOD_NATIVE_PORT per epoch; this covers
    # manually relaunched elastic jobs).
    port = os.environ.get("HOROVOD_NATIVE_PORT")
    if port is None:
        base = os.environ.get("HOROVOD_COORDINATOR_PORT")
        port = str(int(base) + 3) if base else "9374"
        epoch = os.environ.get("HOROVOD_ELASTIC_EPOCH")
        if epoch:
            port = str(int(port) + 2 * int(epoch))
    return int(port)


def start(timeline_path: Optional[str] = None) -> Optional[EagerRuntime]:
    """Start the native eager runtime for this process (idempotent), after
    :func:`~horovod_tpu_torch.basics.init` has joined the process group:
    every rank calls it (it makes the runtime's process group).  Returns
    None when ``HOROVOD_NATIVE=0``, in which case eager ops use the direct
    (un-negotiated) path; raises when the library cannot be built or the
    runtime cannot start."""
    global _runtime
    with _start_lock:
        if _runtime is not None:
            return _runtime
        if not enabled_by_env():
            return None
        rank = basics.process_rank()
        size = basics.num_processes()
        addr = os.environ.get("HOROVOD_COORDINATOR_ADDR", "127.0.0.1")
        if ":" in addr:
            addr = addr.split(":")[0]
        rt = native.NativeRuntime()
        group = dist.new_group(list(range(size)))
        rt.init(rank, size, addr, native_port(), timeline_path=timeline_path)
        _runtime = EagerRuntime(rt, group, basics.device())
        return _runtime


def get() -> Optional[EagerRuntime]:
    return _runtime


def stop() -> None:
    global _runtime
    with _start_lock:
        if _runtime is not None:
            _runtime.shutdown()
            _runtime = None


atexit.register(stop)
