"""Parallelism beyond the data-parallel step.

Counterpart of ``horovod_tpu/parallel``.

- :mod:`horovod_tpu_torch.parallel.meshes` — the multi-axis mesh
  (:class:`MeshSpec`, :func:`make_mesh`: a ``DeviceMesh`` with axes
  dp, pp, ep, fsdp, sp, tp) and the binding of its axes (:func:`bind`,
  :func:`axis_group`, :func:`axis_index`, :func:`axis_size`), which
  the model's sequence-parallel attention reads.
- :mod:`horovod_tpu_torch.parallel.sharding` — :class:`PartitionSpec`
  (``P``) and :class:`NamedSharding` over DTensor, the port's
  ``jax.sharding``; ``distribute`` and ``full`` place a tree and gather
  it back.
- :func:`ring_attention` and :func:`ulysses_attention` (re-exports of
  :mod:`horovod_tpu_torch.ops.attention`'s) — sequence parallelism over
  a process group.
- :mod:`horovod_tpu_torch.parallel.pipeline` — pipeline parallelism
  over the ``pp`` group: :func:`pipeline_apply`,
  :func:`pipeline_value_and_grad` (GPipe, 1F1B, interleaved),
  :func:`stack_to_stages`.
"""

from horovod_tpu_torch.parallel.meshes import (  # noqa: F401
    AXIS_ORDER,
    MeshSpec,
    axis_group,
    axis_index,
    axis_size,
    bind,
    infer_spec,
    make_mesh,
)
from horovod_tpu_torch.parallel.sharding import (  # noqa: F401
    NamedSharding,
    P,
    PartitionSpec,
)
from horovod_tpu_torch.parallel.pipeline import (  # noqa: F401
    pipeline_apply,
    pipeline_value_and_grad,
    stack_to_stages,
)
from horovod_tpu_torch.ops.attention import (  # noqa: F401
    ring_attention,
    ulysses_attention,
)
