"""horovod_tpu_torch: the PyTorch + CUDA port of ``horovod_tpu``.

A second package beside the JAX one, built slice by slice; the JAX
package stays the reference each slice is tested against.  It serves
and trains the flagship Transformer LM: ``models`` (parameters, the
training forward and loss, prefill, paged decode), ``ops`` (the
hand-written Hopper kernels — flash attention forward and backward,
paged-attention decode — each beside its plain PyTorch version, and the
collectives, Adasum, sparse reduction, fusion and compression of the
gradient reduction),
``basics`` (process group, rank and size, the local and cross groups
over ``torch.distributed``), ``optim`` (``DistributedOptimizer``,
``DistributedAdasumOptimizer``, ``DistributedGradientTape``), ``state``
(parameter, optimizer-state and object broadcast), ``join`` (masked
averaging for ranks out of data), ``spmd`` (the data-parallel train
step, captured as a CUDA graph on the card), ``serving`` (the paged
continuous-batching engine and its HTTP server), ``obs`` (the metrics
registry, request tracing and spans, the trace store and its CLIs
``python -m horovod_tpu_torch.obs.trace`` and ``.obs.merge``, the fleet
view, ``xprof``'s FLOP count and live MFU, ``training_step``),
``timeline`` (the Chrome-trace host timeline and ``torch.profiler``
around it; ``start_timeline`` / ``stop_timeline`` here),
``data`` (the rank-sharded, device-prefetching ``DataLoader``) and
``bench`` (the synthetic ResNet-50 img/s benchmark); ``models`` also
holds the vision models (ResNet, InceptionV3, the MLP) and their loader
for flax variables.

Since slice 18 the package is also the JAX package's top-level API (the
Horovod "minimal code change" contract), with the launcher
(``python -m horovod_tpu_torch.runner``, the port's ``horovodrun``),
``elastic`` (``State``, ``run``), ``checkpoint`` and ``callbacks``:

    import horovod_tpu_torch as hvd
    hvd.init()                                  # cuda:<local rank>, NCCL
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(params, lr=1e-3))
    step = hvd.spmd.make_train_step(loss_fn, opt)   # captured on CUDA
    hvd.broadcast_parameters(params, root_rank=0)

Since slice 19 ``init`` also starts the native control plane
(``native``, ``eager_runtime``: eager collectives negotiated by name,
fused, cached; ``join`` in arrival order; ``autotune`` under
``HOROVOD_AUTOTUNE``), unless ``HOROVOD_NATIVE=0``; ``allreduce_async_``
and ``broadcast_async_`` work in place.  ``parallel`` holds the
multi-axis mesh (``MeshSpec``, ``make_mesh``: a
``DeviceMesh``; ``bind`` and the axis reads), sequence parallelism
(``ring_attention``, ``ulysses_attention``; the model's ``ring``,
``ring_zigzag``, ``ring_reference`` and ``ulysses`` impls) and the
pipeline (``pipeline_apply``, ``pipeline_value_and_grad``: GPipe, 1F1B,
interleaved; the model's ``pipelined_value_and_grad``); the model's
expert parallelism is ``TransformerConfig(moe_axis=)``.  The
package has every top-level name of the JAX package, the worker meshes
among them (``AXIS``, ``CROSS_AXIS``, ``LOCAL_AXIS``, ``mesh``,
``hierarchical_mesh``, ``axis_name``, ``sharding_for``,
``worker_index``), ``parallel.PartitionSpec`` / ``NamedSharding`` over
DTensor, and GSPMD training (``spmd.make_gspmd_train_step``, ``shard``,
``run``, ``init_replicated``, ``shard_batch``; the ``DataLoader``'s and
``checkpoint``'s pod modes) over every axis, pp and ep included.
Importing the package builds no kernel or library and touches no CUDA
device.

It imports ``torch`` and never ``jax`` or ``horovod_tpu``.  Entry points
run on CUDA unless the caller passes ``device="cpu"``.
"""

from horovod_tpu_torch.basics import (  # noqa: F401
    AXIS,
    CROSS_AXIS,
    LOCAL_AXIS,
    NotInitializedError,
    axis_name,
    ccl_built,
    cross_rank,
    cross_size,
    ddl_built,
    gloo_built,
    gloo_enabled,
    hierarchical_mesh,
    init,
    is_homogeneous,
    is_initialized,
    local_rank,
    local_size,
    mesh,
    mpi_built,
    mpi_enabled,
    mpi_threads_supported,
    nccl_built,
    num_processes,
    process_rank,
    rank,
    sharding_for,
    shutdown,
    size,
    worker_index,
    xla_built,
)
from horovod_tpu_torch.ops.collectives import (  # noqa: F401
    Adasum,
    Average,
    Max,
    Min,
    Product,
    Sum,
    allgather,
    allgather_async,
    allreduce,
    allreduce_async,
    allreduce_async_,
    alltoall,
    alltoall_async,
    barrier,
    broadcast,
    broadcast_async,
    broadcast_async_,
    grouped_allreduce,
    poll,
    process_sum,
    reducescatter,
    reducescatter_async,
    synchronize,
)
from horovod_tpu_torch.ops.compression import Compression  # noqa: F401
from horovod_tpu_torch.optim import (  # noqa: F401
    DistributedAdasumOptimizer,
    DistributedGradientTape,
    DistributedOptimizer,
    distributed_gradients,
)
from horovod_tpu_torch.state import (  # noqa: F401
    allgather_object,
    broadcast_object,
    broadcast_optimizer_state,
    broadcast_parameters,
)
from horovod_tpu_torch.join import join, masked_average  # noqa: F401
from horovod_tpu_torch import (  # noqa: F401
    callbacks,
    data,
    elastic,
    obs,
    parallel,
    spmd,
    timeline,
)
from horovod_tpu_torch.data import DataLoader  # noqa: F401
from horovod_tpu_torch.timeline import (  # noqa: F401
    start_timeline,
    stop_timeline,
)

__version__ = "0.1.0"

__all__ = [k for k in dir() if not k.startswith("_")]
