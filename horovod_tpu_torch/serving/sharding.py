"""Tensor-parallel serving: one engine's tick sharded Megatron-style over
a ``tp`` group.

Counterpart of ``horovod_tpu/serving/sharding.py``.  The JAX engine
annotates its jitted tick bodies with shardings over a tp mesh and
GSPMD inserts the collectives; the port runs the same split by hand
(:mod:`~horovod_tpu_torch.models.transformer`'s sharded body):

* parameters cut by :func:`~horovod_tpu_torch.models.transformer.
  serving_param_specs` — attention heads and the MLP hidden dimension
  over tp, the embedding and the LM head at the vocabulary, norms
  replicated — each shard contiguous (:meth:`ServingSharding.
  shard_params`);
* the paged KV pool split by kv head, never by page id
  (:func:`~horovod_tpu_torch.models.transformer.paged_pool_specs`), so
  page tables, grants, refcounts and copy-on-write stay host data;
* K1 (prefill) and K4 (the decode tick and the verify) run shard-locally
  on ``H / tp`` query heads over ``H_kv / tp`` kv heads, with no traffic
  across heads; the ``wo`` and ``w_down`` partials and the embedding are
  summed over tp (``all_reduce``, in f32, rounded once), the
  vocabulary-sharded logits gathered (``all_gather``).

One process a tp rank (the real form, over ``torch.distributed``: NCCL
on CUDA, gloo on the CPU) is how PyTorch serves tensor parallelism;
every rank builds the same engine on its own shards, and the leader
(rank 0) replicates each step's inputs to the others
(:class:`~horovod_tpu_torch.serving.engine.InferenceEngine`).  The
virtual form (the engine's private ``_virtual_tp``) holds every shard in
one process over a group of one: the same body, its partials summed in
shard order, which is what a card without peers can check.

:func:`ensure_devices` has no flag to arm: a process cannot conjure
ranks the way a JAX CPU host forces devices, so it checks the job's
world and raises typed.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch.distributed as dist

from horovod_tpu_torch.basics import resolve_device
from horovod_tpu_torch.models import transformer as T
from horovod_tpu_torch.parallel.meshes import MeshSpec, make_mesh
from horovod_tpu_torch.parallel.sharding import NamedSharding, named_shardings

__all__ = ["ShardingConfigError", "ServingSharding", "StepInputs",
           "ensure_devices", "make_tp_mesh", "validate_tp"]


class ShardingConfigError(ValueError):
    """A tensor-parallel configuration the group or the model cannot
    honor, raised typed at engine construction, never left to surface as
    a shape crash inside a tick."""


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def ensure_devices(n: int) -> None:
    """Raise :class:`ShardingConfigError` unless the job holds at least
    ``n`` ranks (one a device).  The JAX function arms a forced-device
    flag before its backend starts; the port's devices are the ranks of
    ``torch.distributed``, which only a launcher can add."""
    have = _world()
    if n > have:
        raise ShardingConfigError(
            f"tp={n} exceeds the {have} visible devices (one a rank: "
            f"start {n} ranks, e.g. replica_main --tp {n})")


def validate_tp(cfg: "T.TransformerConfig", tp: int,
                n_devices: Optional[int] = None) -> None:
    """Typed divisibility and topology checks, in JAX's order and words.

    Heads are the unit tensor parallelism splits (wq/wo at ``n_heads``,
    wk/wv and the KV pool at ``kv_heads``), so both must divide by
    ``tp``; the MLP hidden dimension and the vocabulary split unevenly
    where they must.  ``n_devices``: the ranks of the tp group's world
    (None skips the check: the virtual form needs no peers)."""
    if tp < 1:
        raise ShardingConfigError(f"tp must be >= 1, got {tp}")
    if cfg.n_heads % tp:
        raise ShardingConfigError(
            f"n_heads={cfg.n_heads} not divisible by tp={tp}; "
            f"attention heads are the tensor-parallel split unit")
    if cfg.kv_heads % tp:
        raise ShardingConfigError(
            f"kv_heads={cfg.kv_heads} (n_kv_heads={cfg.n_kv_heads}) "
            f"not divisible by tp={tp}; the KV pool shards by kv head")
    if n_devices is not None and tp > n_devices:
        raise ShardingConfigError(
            f"tp={tp} exceeds the {n_devices} visible devices (one a "
            f"rank: start {tp} ranks)")


def make_tp_mesh(tp: int, devices: Optional[Sequence[int]] = None, *,
                 device=None):
    """A serving mesh (:func:`~horovod_tpu_torch.parallel.meshes.
    make_mesh` of ``MeshSpec(tp=tp)``: tp innermost, the training-only
    axes at size 1) over the job's world, which must hold exactly ``tp``
    ranks; ``devices``, if given, lists them (``range(tp)``)."""
    if devices is None:
        devices = list(range(_world()))
        if tp > len(devices):
            raise ShardingConfigError(
                f"tp={tp} exceeds the {len(devices)} visible devices "
                f"(one a rank: start {tp} ranks)")
    if len(devices) != tp or list(devices) != list(range(_world())):
        raise ShardingConfigError(
            f"tp={tp} mesh needs exactly tp devices (the job's ranks), "
            f"got {len(devices)}")
    return make_mesh(MeshSpec(tp=tp), device)


class ServingSharding:
    """One tp serving group and every layout the engine's tick bodies
    need, built once at engine construction.

    The real form (``virtual=False``): a :func:`make_tp_mesh` mesh over
    the job's ranks, this rank's shard ``index = (rank,)``, ``group`` the
    tp process group (the collectives' group), and ``host_group`` a gloo
    group over the same ranks for the leader's step inputs (the tp group
    itself on the CPU).  The virtual form: no mesh and no group, every
    shard local (``index = 0..tp-1``).  ``draft_cfg`` (a model draft) is
    validated for the same group: its pool is slot-aligned with the
    target's and splits by its own kv heads."""

    def __init__(self, cfg: "T.TransformerConfig", tp: int, *,
                 device=None,
                 draft_cfg: Optional["T.TransformerConfig"] = None,
                 virtual: bool = False):
        validate_tp(cfg, tp, None if virtual else _world())
        if draft_cfg is not None:
            validate_tp(draft_cfg, tp)
        self.cfg = cfg
        self.tp = tp
        self.virtual = virtual
        self.device = resolve_device(device)
        if virtual:
            self.mesh = None
            self.group = self.host_group = None
            self.rank = 0
            self.index = tuple(range(tp))
            return
        self.mesh = make_tp_mesh(tp, device=self.device)
        self.group = self.mesh.get_group("tp")
        self.rank = int(self.mesh.get_local_rank("tp"))
        self.index = (self.rank,)
        self.host_group = (self.group if dist.get_backend(self.group) == "gloo"
                           else dist.new_group(list(range(tp)),
                                               backend="gloo"))

    @property
    def leader(self) -> bool:
        """Rank 0 of the group (the virtual form's one process)."""
        return self.rank == 0

    @property
    def replicated(self) -> bool:
        """True when other ranks run this engine's steps beside it."""
        return self.group is not None

    def local_sizes(self, n: int) -> list:
        """The local shards' sizes of a dimension of ``n`` split over
        tp."""
        b = T.tp_bounds(n, self.tp)
        return [b[i + 1] - b[i] for i in self.index]

    # -- layouts ------------------------------------------------------------

    def _named(self, specs):
        if self.mesh is None:
            raise ValueError("the virtual form has no mesh to name "
                             "shardings over; read the specs")
        return named_shardings(self.mesh, specs)

    def param_shardings(self, cfg: Optional["T.TransformerConfig"] = None):
        return self._named(T.serving_param_specs(cfg or self.cfg))

    def shard_params(self, params: Dict,
                     cfg: Optional["T.TransformerConfig"] = None
                     ) -> "T.TPShards":
        """This process's shards of ``params`` (:func:`~horovod_tpu_torch.
        models.transformer.shard_params`)."""
        return T.shard_params(params, self, cfg or self.cfg)

    def pool_shardings(self, quantized: bool = False) -> Dict:
        return self._named(T.paged_pool_specs(quantized))

    def prefill_cache_shardings(self) -> Dict:
        """A prefill's K/V block and ``pos``: head-sharded K/V, so the
        landing scatter into the sharded pool is local."""
        specs = T.cache_specs()
        return self._named({k: specs[k] for k in ("k", "v", "pos")})

    def prefix_kv_sharding(self) -> NamedSharding:
        return self._named(T.prefix_kv_specs())

    def paged_kernel_shardings(self, quantized: bool = False):
        """K4's operand and result shardings, in :func:`~horovod_tpu_torch.
        models.transformer.paged_kernel_specs` order."""
        in_specs, out_specs = T.paged_kernel_specs(quantized)
        return (list(self._named(list(in_specs))),
                list(self._named(list(out_specs))))

    # -- observability ------------------------------------------------------

    def describe(self) -> str:
        """The ``/stats`` ``mesh`` value, e.g. ``"tp=2 devices=cpu:0,1"``
        (the tp ranks; the virtual form repeats its one device)."""
        dev = self.device
        if self.virtual:
            ids = ",".join([str(dev.index or 0)] * self.tp)
        else:
            ids = ",".join(str(r) for r in range(self.tp))
        return f"tp={self.tp} devices={dev.type}:{ids}"


class StepInputs:
    """The leader's per-step message to the other ranks of a replicated
    tp engine: one ``broadcast_object_list`` from rank 0 over the
    sharding's gloo ``host_group`` (Python objects never go through
    NCCL)."""

    def __init__(self, sharding: ServingSharding):
        self.group = sharding.host_group
        self.leader = sharding.leader

    def exchange(self, msg=None):
        """The leader sends ``msg``; a follower receives and returns it."""
        box = [msg if self.leader else None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]
