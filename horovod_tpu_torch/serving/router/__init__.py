"""Replicated serving front tier: the port of
``horovod_tpu/serving/router/``, with the same exports.

One engine replica is a single point of failure; this package spreads
traffic over N replica processes and keeps N true:

* :class:`~horovod_tpu_torch.serving.router.supervisor.ReplicaSupervisor`
  spawns N replica processes (each a full engine + HTTP server on its
  own port, :mod:`horovod_tpu_torch.serving.router.replica_main`; on
  one card each opens its own CUDA context), watches their exit codes,
  and drains and respawns dead, terminally ``failed`` or wedged
  replicas with exponential backoff;
* :class:`~horovod_tpu_torch.serving.router.registry.ReplicaRegistry`
  polls each replica's ``/stats`` (``queue_depth``, ``occupancy``,
  ``engine_state``, ``heartbeat_age_s``, ``config_generation``) and
  keeps the routing set;
* :class:`~horovod_tpu_torch.serving.router.server.RouterServer` proxies
  ``/generate`` join-shortest-queue, propagates ``X-Trace-Id``, and on a
  replica failure mid-request fails over to another replica, resuming
  a partially decoded request from its resume descriptor (the replica's
  typed failure reply, or its journal file read after a SIGKILL);
* :class:`~horovod_tpu_torch.serving.router.rollout.RolloutController`
  rolls the fleet to a new configuration one replica at a time, with a
  canary and automatic rollback.

    from horovod_tpu_torch.serving.router import (
        ReplicaRegistry, ReplicaSpec, ReplicaSupervisor, RouterServer)

    registry = ReplicaRegistry()
    sup = ReplicaSupervisor(ReplicaSpec(seed=0, device="cpu"),
                            n_replicas=3, registry=registry).start()
    sup.wait_ready(timeout=120)
    with RouterServer(registry, port=8000) as rt:
        ...                       # POST /generate just like one engine
    sup.stop()
"""

from horovod_tpu_torch.serving.router.metrics import RouterMetrics
from horovod_tpu_torch.serving.router.registry import (
    ReplicaEndpoint,
    ReplicaRegistry,
    ReplicaStatus,
)
from horovod_tpu_torch.serving.router.rollout import (
    RolloutController,
    RolloutError,
)
from horovod_tpu_torch.serving.router.server import RouterServer
from horovod_tpu_torch.serving.router.supervisor import (
    EXIT_CODE_REPLICA_FAILED,
    ReplicaHandle,
    ReplicaSpec,
    ReplicaSupervisor,
)

__all__ = [
    "EXIT_CODE_REPLICA_FAILED",
    "ReplicaEndpoint", "ReplicaHandle", "ReplicaRegistry", "ReplicaSpec",
    "ReplicaStatus", "ReplicaSupervisor", "RolloutController",
    "RolloutError", "RouterMetrics", "RouterServer",
]
