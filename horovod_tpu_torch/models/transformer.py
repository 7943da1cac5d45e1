"""The decoder-only Transformer LM in PyTorch: training and serving.

Counterpart of ``horovod_tpu/models/transformer.py``: parameters, the
training forward and loss (:func:`forward`, :func:`loss_fn`,
:func:`synthetic_batch`; flash attention K1-K3 when
``attention_impl="flash"``; sequence parallelism over the bound ``sp``
mesh axis with ``ring``, ``ring_zigzag``, ``ring_reference`` and
``ulysses``; each layer rematerialised with
``remat=True``, policy ``full`` or ``dots``; a top-1
mixture-of-experts MLP with ``n_experts > 1``, its Switch balance loss
and :func:`expert_load`), prefill (whole prompts, and suffixes over an
already-cached prefix: :func:`prefill_with_prefix`, K1 with a runtime
shift), the contiguous-cache decode step
with the per-request :func:`sample_decode` / :func:`greedy_decode`
oracles, the per-slot sampler :func:`sample_token_rows` (JAX's threefry
draws, :mod:`~horovod_tpu_torch.ops.threefry`), and the paged decode
tick (paged-attention kernel K4 with ``kernel=True``), and speculative
decoding's pieces: the proposers :func:`ngram_propose` (prompt lookup)
and :func:`draft_propose_paged` (a shallower draft model's greedy steps)
and the W-wide :func:`decode_verify_paged` (K4 at ``R = G * W`` over the
committed pages, merged by log-sum-exp with the window's own causal
attention).

GSPMD training (``spmd.make_gspmd_train_step``): :func:`param_specs`
and :func:`batch_specs` are JAX's sharding rules; with parameters placed
by them as DTensors, the same :func:`loss_fn` runs on DTensors (flash
K1-K3 under ``local_map`` on each rank's rows and heads, the switch MoE
on every token with the experts gathered over ep, the layer stack
gathered over pp before it is unbound, the embedding and the loss
vocabulary-parallel over ``tp``), and on plain tensors it computes what
it always did.

Tensor-parallel serving: :func:`serving_param_specs` and the cache,
pool, kernel and prefix specs are JAX's; :func:`shard_params` cuts a
model into the shards a process holds (:class:`TPShards`), and the
serving bodies (:func:`prefill`, :func:`prefill_with_prefix`,
:func:`decode_step`, :func:`decode_step_paged`,
:func:`decode_verify_paged`, so :func:`greedy_decode` and
:func:`sample_decode` too) run them: each local shard's heads (K1, K4)
and hidden slice, the partials reduced over the tp group, the logits
gathered (the section's comment below).

Expert parallelism (``moe_axis``) and the pipeline
(:func:`pipelined_forward`, :func:`pipelined_value_and_grad`: GPipe,
1F1B, interleaved over the bound ``pp`` axis, through
:mod:`horovod_tpu_torch.parallel.pipeline`) read the bound mesh
(``parallel.bind``).  With ``moe_axis`` the parameters stay whole on
every rank: rank e of the axis runs its resident experts (slice
``[e*E_loc, (e+1)*E_loc)`` of the ``(L, E, ...)`` stacks) on every
rank's tokens routed to them (one all_to_all each way), so the
gradient of an expert stack is zero outside the resident slice and
complete inside it, and the average over the axis is JAX's reassembly
of the resident pieces (``psum``, then ``/ ep``): a plain
``DistributedOptimizer(axis_name=moe_axis)`` trains it, averaging the
other parameters' gradients over the axis as JAX's ``pmean`` does.

Parameters are a plain dict in the JAX package's layout: layers stacked
on a leading ``L`` axis, the same names and shapes.  Every matrix is
cast to ``cfg.dtype`` at use, as in JAX, so the same code serves f32
master parameters (training: ``param_dtype=torch.float32``) and
matrices already held in ``cfg.dtype`` (serving's default, where the
casts are no-ops).  The RMSNorm scales and the MoE router stay f32: the
switch and dropless dispatches route in f32 from the f32 parameter, as
JAX's do, while the dense dispatch casts the router to ``cfg.dtype`` at
use, as JAX's ``_moe_mlp_dense`` does (so at bf16 a prefill and a
decode step can route one token differently, in both packages).

MoE dispatch by path, as in JAX: training runs ``cfg.moe_impl``
(``"switch"`` by default), :func:`prefill` and
:func:`prefill_with_prefix` the dropless grouped products (G1 on CUDA),
and every per-step decode path the dense every-expert dispatch.

Unlike JAX, tensors are mutable: caches and page pools are updated in
place (the JAX engine donates them to the same effect).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from horovod_tpu_torch.basics import resolve_device
from horovod_tpu_torch.ops import attention as attn
from horovod_tpu_torch.ops import moe
from horovod_tpu_torch.ops import paged_attention as pa
from horovod_tpu_torch.ops import threefry
from horovod_tpu_torch.parallel import meshes
from horovod_tpu_torch.parallel import pipeline as _pl
from horovod_tpu_torch.parallel.sharding import P

__all__ = ["TPShards", "TransformerConfig", "batch_specs", "cache_specs",
           "decode_step", "decode_step_paged", "decode_step_slots",
           "decode_verify_paged", "draft_propose_paged", "expert_load",
           "forward", "greedy_decode", "init_cache", "init_params",
           "kv_dequantize", "kv_quantize", "loss_fn", "ngram_propose",
           "paged_kernel_specs", "paged_pool_specs", "param_specs",
           "pipelined_forward", "pipelined_value_and_grad", "prefill",
           "prefill_with_prefix", "prefix_kv_specs", "resolve_device",
           "sample_decode", "sample_token_rows", "serving_param_specs",
           "serving_shardings", "shard_kv_pool", "shard_params",
           "synthetic_batch", "tp_bounds"]

_MATRICES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
#: The sequence-parallel attention impls (over the bound ``sp`` axis).
SP_IMPLS = ("ring", "ring_zigzag", "ring_reference", "ulysses")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 2048
    max_seq: int = 1024
    n_experts: int = 0  # 0/1 = dense MLP
    # MoE dispatch: "switch" = sparse capacity-factor token dispatch
    # (ops/moe.py; each token computes ONE expert); "dense" = every
    # expert, combined with the routing one-hot (the exact oracle, and
    # the per-step decode dispatch); "dropless" = grouped products, exact
    # at one expert's work a token (the prefill dispatch).
    moe_impl: str = "switch"
    # Per-expert capacity multiplier for switch dispatch: each expert
    # accepts ceil(cf * T / E) tokens a step; overflow tokens pass
    # through the residual only.
    capacity_factor: float = 2.0
    # Switch dispatch mechanism: "sort" or "cumsum" (identical outputs,
    # gradients and drops).
    moe_dispatch: str = "sort"
    # Model-level expert parallelism: the mesh axis the switch dispatch's
    # experts are spread over (the bound mesh's, ``parallel.bind``; None =
    # one device).  The parameters stay whole on every rank: each rank's
    # loss runs its resident experts, slice ``[e*E_loc, (e+1)*E_loc)`` of
    # the expert stacks (rank e of ep), and the tokens ride one
    # all_to_all each way.
    moe_axis: Optional[str] = None
    # Switch load-balancing loss coefficient: loss_fn adds
    # coeff * sum over layers of E * sum_e frac_e * pbar_e when > 0.
    moe_aux_coeff: float = 0.0
    # Grouped-query attention: K/V heads (0 = n_heads, i.e. MHA).
    n_kv_heads: int = 0
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    # "reference" = O(S^2) softmax attention; "flash" = kernels K1-K3.
    # Sequence parallelism over the bound mesh's ``sp`` axis
    # (``parallel.bind(make_mesh(MeshSpec(sp=P)))``; each rank holds its
    # sequence shard of the batch): "ring" = ring attention, its chunks
    # through K1-K3; "ring_zigzag" = the ring with the zigzag layout, which
    # balances the causal work (feed batches permuted by
    # ``ops.attention.zigzag_perm``); "ring_reference" = the ring with the
    # masked f32 chunk math; "ulysses" = all-to-all resharding to a head
    # subset over the whole sequence, then K1-K3.  Prefill runs K1 over
    # the whole prompt for all four.
    attention_impl: str = "reference"
    # Rematerialisation: recompute each layer's activations in the
    # backward (the JAX ``_remat``); "full" saves only the layer input,
    # "dots" also the projections' matmul outputs.
    remat: bool = False
    remat_policy: str = "full"

    def __post_init__(self):
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}; "
                             "expected 'full' or 'dots'")
        if self.attention_impl not in ("reference", "flash") + SP_IMPLS:
            raise ValueError(
                f"unknown attention_impl {self.attention_impl!r}; expected "
                "'reference', 'flash', 'ring', 'ring_reference' or 'ulysses'")
        if self.d_model % self.n_heads:
            raise ValueError("d_model must be a multiple of n_heads")
        if self.n_heads % self.kv_heads:
            raise ValueError("n_heads must be a multiple of n_kv_heads")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads


# --- parameters --------------------------------------------------------------


def init_params(cfg: TransformerConfig, *, seed: int = 0, device=None,
                param_dtype: torch.dtype = None) -> Dict:
    """Random parameters in the JAX package's layout (``init_params``),
    drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``
    (the numbers differ from ``jax.random``'s; :func:`~horovod_tpu_torch.
    models.convert.params_from_jax` carries the JAX package's own).

    Matrices are held in ``param_dtype``, by default ``cfg.dtype``
    (serving); training passes ``torch.float32`` for f32 master
    parameters, as the JAX package keeps.  With ``n_experts > 1`` the
    MLP is a stack of experts: ``router (L, D, E)``, always f32, and
    ``w_gate`` / ``w_up (L, E, D, F)``, ``w_down (L, E, F, D)``."""
    device = resolve_device(device)
    param_dtype = param_dtype or cfg.dtype
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    D, H, Dh, Fd, L, V = (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
                          cfg.n_layers, cfg.vocab_size)

    def normal(shape, scale, dtype=None):
        x = torch.randn(shape, generator=g, device=device,
                        dtype=torch.float32)
        return (x * scale).to(dtype or param_dtype)

    s_d, s_f = 1.0 / math.sqrt(D), 1.0 / math.sqrt(Fd)
    ones = dict(device=device, dtype=torch.float32)
    embed = normal((V, D), 1.0)
    layers = {
        "ln1": torch.ones((L, D), **ones),
        "ln2": torch.ones((L, D), **ones),
        "wq": normal((L, D, H, Dh), s_d),
        "wk": normal((L, D, cfg.kv_heads, Dh), s_d),
        "wv": normal((L, D, cfg.kv_heads, Dh), s_d),
        "wo": normal((L, H, Dh, D), s_d),
    }
    E = cfg.n_experts
    if E > 1:
        layers.update(router=normal((L, D, E), s_d, torch.float32),
                      w_gate=normal((L, E, D, Fd), s_d),
                      w_up=normal((L, E, D, Fd), s_d),
                      w_down=normal((L, E, Fd, D), s_f))
    else:
        layers.update(w_gate=normal((L, D, Fd), s_d),
                      w_up=normal((L, D, Fd), s_d),
                      w_down=normal((L, Fd, D), s_f))
    return {"embed": embed, "layers": layers,
            "ln_f": torch.ones((D,), **ones), "head": normal((D, V), s_d)}


def param_specs(cfg: TransformerConfig) -> Dict:
    """GSPMD sharding rules, JAX's entry for entry: tp shards heads, ffn
    and vocab, fsdp the d_model dimension of the weights (ZeRO-3), pp the
    stacked layer axis, ep the experts."""
    layers = {
        "ln1": P("pp", None),
        "ln2": P("pp", None),
        "wq": P("pp", "fsdp", "tp", None),
        "wk": P("pp", "fsdp", "tp", None),
        "wv": P("pp", "fsdp", "tp", None),
        "wo": P("pp", "tp", None, "fsdp"),
    }
    if cfg.n_experts > 1:
        layers.update(
            router=P("pp", None, None),
            w_gate=P("pp", "ep", "fsdp", "tp"),
            w_up=P("pp", "ep", "fsdp", "tp"),
            w_down=P("pp", "ep", "tp", "fsdp"),
        )
    else:
        layers.update(
            w_gate=P("pp", "fsdp", "tp"),
            w_up=P("pp", "fsdp", "tp"),
            w_down=P("pp", "tp", "fsdp"),
        )
    return {
        "embed": P("tp", "fsdp"),
        "layers": layers,
        "ln_f": P(None),
        "head": P("fsdp", "tp"),
    }


def batch_specs() -> Dict:
    """Activations: batch over dp (and fsdp), sequence over sp."""
    return {"tokens": P(("dp", "fsdp"), "sp"),
            "targets": P(("dp", "fsdp"), "sp")}


def _layer(params: Dict, l: int) -> Dict:
    return {k: v[l] for k, v in params["layers"].items()}


def _layers(params: Dict):
    """Every layer's parameter dict, from one ``unbind`` per stacked
    parameter: its gradient is one stack, not a full-size zero tensor
    per layer as indexing each layer would give.  A stack that a GSPMD
    placement shards over pp is gathered first (:func:`_unshard_pp`)."""
    names = list(params["layers"])
    per_name = [_unshard_pp(params["layers"][n]).unbind(0) for n in names]
    return [dict(zip(names, vals)) for vals in zip(*per_name)]


# --- forward pieces ----------------------------------------------------------


def _rmsnorm(x, scale):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6) * scale).to(x.dtype)


def _rope(q, k, theta: float, positions=None):
    """Rotary embedding over the head dim of ``(B, S, H, Dh)`` q and k,
    split into halves (not interleaved pairs), f32 angles.
    ``positions``: None = ``0..S-1``; else ``(B, S)`` per-row
    positions."""
    B, S, H, Dh = q.shape
    half = Dh // 2
    dev = q.device
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=dev) / half))
    pos = (positions.float() if positions is not None
           else torch.arange(S, dtype=torch.float32, device=dev))
    ang = pos[..., None] * freqs  # (S, half) or (B, S, half)
    if ang.dim() == 2:
        ang = ang[None]
    cos = torch.cos(ang)[:, :, None, :]  # (1 | B, S, 1, half)
    sin = torch.sin(ang)[:, :, None, :]

    def rot(x):
        # x (bf16) times f32 cos/sin promotes to f32, as in JAX.
        x1, x2 = x[..., :half], x[..., half:]
        xr1 = x1 * cos - x2 * sin
        xr2 = x2 * cos + x1 * sin
        return torch.cat([xr1, xr2], dim=-1).to(x.dtype)

    return rot(q), rot(k)


def _qkv_proj(x, p, cfg: TransformerConfig, positions=None):
    """Per-head Q/K/V with RoPE -> head-major ``(B, H, S, Dh)`` /
    ``(B, H_kv, S, Dh)``."""
    dt = cfg.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    q, k = _rope(q, k, cfg.rope_theta, positions=positions)
    return (q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous())


def _out_proj(oh, p, cfg: TransformerConfig):
    o = oh.transpose(1, 2).to(cfg.dtype)  # (B, S, H, Dh)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"].to(cfg.dtype))


def _dense_mlp(x, p, cfg: TransformerConfig):
    dt = cfg.dtype
    g = torch.einsum("bsd,df->bsf", x, p["w_gate"].to(dt))
    u = torch.einsum("bsd,df->bsf", x, p["w_up"].to(dt))
    return torch.einsum("bsf,fd->bsd", F.silu(g) * u, p["w_down"].to(dt))


def _moe_mlp_dense(x, p, cfg: TransformerConfig, return_aux: bool = False):
    """Top-1 MoE, dense dispatch: routing probabilities from the router
    cast to ``cfg.dtype`` (as JAX's), every expert evaluated, combined
    with the routing one-hot.  Exact and dropless: the oracle of the
    sparse dispatches, and the per-step decode dispatch."""
    dt, E = cfg.dtype, cfg.n_experts
    B, S, D = x.shape
    logits = torch.einsum("bsd,de->bse", x, p["router"].to(dt))
    probs = torch.softmax(logits.float(), dim=-1)
    top = torch.argmax(probs, dim=-1)
    gate = probs.amax(dim=-1)
    onehot = moe._onehot(top, E, dt)
    # Every expert on every token, batched over the experts: (E, B*S, .)
    # products that read each expert's weights in place.
    xt = x.reshape(1, B * S, D)
    g = torch.matmul(xt, p["w_gate"].to(dt))
    u = torch.matmul(xt, p["w_up"].to(dt))
    y = torch.matmul(F.silu(g) * u, p["w_down"].to(dt))
    y = torch.einsum("etd,te->td", y, onehot.reshape(B * S, E))
    y = y.reshape(B, S, D) * gate[..., None].to(dt)
    if not return_aux:
        return y
    frac = onehot.float().reshape(-1, E).mean(0)
    pbar = probs.reshape(-1, E).mean(0)
    return y, E * torch.sum(frac * pbar)


def _moe_mlp(x, p, cfg: TransformerConfig, impl: Optional[str] = None,
             return_aux: bool = False, ep=None):
    """Mixture-of-experts FFN; ``impl`` overrides ``cfg.moe_impl``:
    "switch" (training), "dense" (per-step decode), "dropless"
    (prefill; it trains too).  ``return_aux`` also returns the layer's
    balance loss, which dropless does not give: it raises there, with
    JAX's message.  ``ep`` (:func:`_ep_axis`): the switch dispatch runs
    this rank's resident experts over the ``moe_axis`` group; dense and
    dropless take no axis, as in JAX."""
    impl = impl or cfg.moe_impl
    if isinstance(x, DTensor):
        return _replicated_moe(x, p, cfg, impl, return_aux)
    if impl == "dense":
        return _moe_mlp_dense(x, p, cfg, return_aux=return_aux)
    dt = cfg.dtype
    if impl == "dropless":
        if return_aux:
            raise ValueError(
                "moe_impl='dropless' is the serving dispatch — train with "
                "'switch' (+ moe_aux_coeff) for the balance loss")
        return moe.dropless_moe(x, p["router"], p["w_gate"].to(dt),
                                p["w_up"].to(dt), p["w_down"].to(dt))
    if impl != "switch":
        raise ValueError(f"unknown moe_impl {impl!r}; "
                         "expected 'switch', 'dense', or 'dropless'")
    group, experts = None, [p[n] for n in ("w_gate", "w_up", "w_down")]
    if ep is not None:  # the resident slice of the whole stacks
        group, e, n = ep
        e_loc = cfg.n_experts // n
        experts = [w.narrow(0, e * e_loc, e_loc) for w in experts]
    return moe.switch_moe(
        x, p["router"], *(w.to(dt) for w in experts),
        capacity_factor=cfg.capacity_factor, group=group,
        return_aux=return_aux, dispatch=cfg.moe_dispatch)


def _mlp_block(x, p, cfg: TransformerConfig, moe_impl: Optional[str] = None,
               return_aux: bool = False, ep=None):
    """Residual MLP half of a layer, shared by forward, prefill and the
    decode steps.  MoE prefill runs the dropless dispatch and decode the
    dense one, so forward and decode agree exactly when switch drops no
    token (``capacity_factor >= n_experts``).  ``return_aux`` also
    returns the MoE balance loss (0 for a dense MLP)."""
    m = _rmsnorm(x, p["ln2"])
    if cfg.n_experts > 1:
        out = _moe_mlp(m, p, cfg, impl=moe_impl, return_aux=return_aux,
                       ep=ep)
        if return_aux:
            return x + out[0], out[1]
        return x + out
    y = x + _dense_mlp(m, p, cfg)
    if return_aux:
        return y, torch.zeros((), dtype=torch.float32, device=x.device)
    return y


def _lm_head(y, ln_f, head, cfg: TransformerConfig):
    """Final RMSNorm + vocabulary projection -> f32 logits."""
    return torch.einsum("bsd,dv->bsv", _rmsnorm(y, ln_f),
                        head.to(cfg.dtype)).float()


def _embed(params, tokens, cfg: TransformerConfig, active=None):
    if isinstance(params["embed"], DTensor):
        return _sharded_embed(params["embed"].to(cfg.dtype), tokens)
    x = params["embed"].to(cfg.dtype)[tokens.long()]
    if active is not None:
        x = torch.where(active[:, None], x, torch.zeros_like(x))
    return x


# --- DTensor parameters (spmd.make_gspmd_train_step) -------------------------
#
# With parameters placed by param_specs the training forward and loss run
# on DTensors, and DTensor inserts the collectives.  Four pieces do not go
# through its operators: the flash kernels (ctypes launches on plain
# tensors: under local_map, on batch rows and heads), the switch MoE
# (JAX's GSPMD sets the capacity from the global token count: every rank
# dispatches every token), and, when tp shards the vocabulary, the
# embedding and the loss (DTensor's masked lookup over a sharded
# vocabulary fails; these are explicit vocabulary-parallel forms, and
# the embedding looks up locally without tp too).


def _tp_sharded(t) -> bool:
    """True for a DTensor over a mesh with a ``tp`` axis of size > 1 (the
    compact mesh holds only such axes)."""
    return isinstance(t, DTensor) and "tp" in t.device_mesh.mesh_dim_names


def _placed(t, mesh):
    """``t`` as a DTensor over ``mesh`` (a plain tensor: replicated)."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _vocab_slice(mesh, V: int):
    """(first row, rows) of this rank's vocabulary shard over tp."""
    rows = V // mesh.size(mesh.mesh_dim_names.index("tp"))
    return mesh.get_local_rank("tp") * rows, rows


class _TPSum(torch.autograd.Function):
    """The sum over the tp group in the forward, the identity in the
    backward: the sum is replicated over tp and feeds one loss, so each
    rank's part takes that loss's gradient whole."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _sharded_embed(table, tokens):
    """``table[tokens]`` on a DTensor table, looked up on each rank's own
    tokens by the plain lookup's local ops.  With the vocabulary sharded
    over tp, each tp rank looks up the ids in its rows and zeros the
    others; the lookup is the sum over tp (a ``Partial`` placement,
    reduced when first needed).  The table's gradient is partial over
    the axes that split the tokens."""
    mesh = table.device_mesh
    names = mesh.mesh_dim_names
    tokens = _placed(tokens, mesh)
    tp = "tp" in names
    start, rows = _vocab_slice(mesh, table.shape[0]) if tp else (0, 0)

    def body(tab, tok):
        if not tp:
            return tab[tok.long()]
        t = tok.long() - start
        x = tab[t.clamp(0, rows - 1)]
        inside = (t >= 0) & (t < rows)
        return torch.where(inside[..., None], x, torch.zeros_like(x))

    tok_pl = tokens.placements
    tab_pl = [Shard(0) if a == "tp" else Replicate() for a in names]
    grad_pl = [Shard(0) if a == "tp" else
               Partial() if isinstance(p, Shard) else Replicate()
               for a, p in zip(names, tok_pl)]
    out_pl = [Partial() if a == "tp" else p for a, p in zip(names, tok_pl)]
    return local_map(body, out_placements=out_pl,
                     in_placements=(tab_pl, tok_pl),
                     in_grad_placements=(grad_pl, tok_pl), device_mesh=mesh,
                     redistribute_inputs=True)(table, tokens)


def _vocab_parallel_xent_sum(logits, targets):
    """:func:`_xent_sum` with the vocabulary sharded over tp: the max, the
    sum of ``exp`` and the gold logit (picked on the rank that holds it)
    are each reduced over tp; differentiable, with the max held
    constant (the log-sum-exp does not depend on it)."""
    mesh = logits.device_mesh
    names = mesh.mesh_dim_names
    group = mesh.get_group("tp")
    targets = _placed(targets, mesh)
    start, rows = _vocab_slice(mesh, logits.shape[-1])

    def body(lg, tg):
        m = lg.detach().amax(dim=-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        se = _TPSum.apply(torch.exp(lg - m[..., None]).sum(dim=-1), group)
        t = tg.long() - start
        gold = torch.gather(lg, -1, t.clamp(0, rows - 1)[..., None])[..., 0]
        inside = (t >= 0) & (t < rows)
        gold = _TPSum.apply(torch.where(inside, gold,
                                        torch.zeros_like(gold)), group)
        return (m + torch.log(se) - gold).sum()

    tg_pl = targets.placements
    lg_pl = [Shard(logits.dim() - 1) if a == "tp" else p
             for a, p in zip(names, tg_pl)]
    out_pl = [Partial() if isinstance(p, Shard) else Replicate()
              for p in tg_pl]
    return local_map(body, out_placements=out_pl,
                     in_placements=(lg_pl, tg_pl), device_mesh=mesh,
                     redistribute_inputs=True)(logits, targets)


def _unshard_pp(t):
    """A DTensor layer stack sharded over pp (``param_specs``' dim 0)
    redistributed to replicated over pp, its other placements kept:
    JAX's GSPMD gathers the pp-sharded stack on use, and DTensor cannot
    ``unbind`` a sharded dimension.  Anything else as it is."""
    if not isinstance(t, DTensor) or "pp" not in t.device_mesh.mesh_dim_names:
        return t
    i = t.device_mesh.mesh_dim_names.index("pp")
    placements = list(t.placements)
    placements[i] = Replicate()
    return t.redistribute(t.device_mesh, placements)


def _local_flash(q, k, v):
    """K1-K3 on DTensor q/k/v ``(B, H, S, D)``: under ``local_map``, each
    rank's batch rows (over every axis but tp and sp) and heads (over tp),
    the sequence gathered over sp."""
    mesh = q.device_mesh
    pl = [Shard(1) if a == "tp" else Replicate() if a == "sp" else Shard(0)
          for a in mesh.mesh_dim_names]

    def body(q, k, v):  # a head shard of a (B, H, S, D) is a strided view
        return attn.flash_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous(), True)

    return local_map(body, out_placements=pl, in_placements=(pl, pl, pl),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def _replicated_moe(x, p, cfg: TransformerConfig, impl, return_aux: bool):
    """The MoE block on DTensors: JAX's global function, every token
    dispatched by every rank (the capacity is set by the global token
    count), on the tokens gathered over the data axes and the experts
    gathered over ep, fsdp and tp."""
    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim
    names = ("router", "w_gate", "w_up", "w_down")

    def body(x, *weights):
        return _moe_mlp(x, dict(zip(names, weights)), cfg, impl=impl,
                        return_aux=return_aux)

    return local_map(body, out_placements=(rep, rep) if return_aux else rep,
                     in_placements=(rep,) * 5, device_mesh=mesh,
                     redistribute_inputs=True)(x, *(p[n] for n in names))


# --- training forward and loss ----------------------------------------------


def _sp_axis(cfg: TransformerConfig):
    """``(group, index, size)`` of the bound mesh's ``sp`` axis for a
    sequence-parallel impl (``NameError`` when none is bound), else
    None.  Read once by the caller of the layers: a rematerialised
    layer's recompute runs in the autograd engine's thread, which does
    not see the binding."""
    if cfg.attention_impl not in SP_IMPLS:
        return None
    return (meshes.axis_group("sp"), meshes.axis_index("sp"),
            meshes.axis_size("sp"))


def _ep_axis(cfg: TransformerConfig):
    """``(group, index, size)`` of the bound mesh's ``cfg.moe_axis`` when
    the training dispatch is the switch one over experts (``NameError``
    when the axis is not bound), else None.  Read once by the caller of
    the layers, as :func:`_sp_axis`."""
    if cfg.moe_axis is None or cfg.n_experts <= 1 or \
            cfg.moe_impl != "switch":
        return None
    return (meshes.axis_group(cfg.moe_axis), meshes.axis_index(cfg.moe_axis),
            meshes.axis_size(cfg.moe_axis))


def _attention(x, p, cfg: TransformerConfig, sp=None, prefill=False):
    """Causal attention of the layer -> ``(output, K, V)``, K/V
    unexpanded and post-RoPE (prefill fills its cache with them).
    ``flash`` runs K1 forward and K2/K3 backward on CUDA, with GQA mapped
    in the kernels (no expanded K/V copy); ``reference`` expands K/V and
    differentiates the plain softmax.  The sequence-parallel impls take
    ``sp`` (:func:`_sp_axis`): ``x`` is this rank's sequence shard, its
    RoPE positions ``index * S + 0..S-1`` (the zigzag layout's for
    ``ring_zigzag``).  ``prefill`` attends the whole prompt with K1, as
    the JAX package's ``_attention_prefill`` does for every impl but
    ``reference``."""
    impl = cfg.attention_impl
    if prefill and impl in SP_IMPLS:
        impl = "flash"
    positions = None
    if impl in SP_IMPLS:
        group, index, size = sp
        S = x.shape[1]
        if impl == "ring_zigzag":
            positions = attn._zigzag_positions(S, index, size, x.device)
        else:
            positions = index * S + torch.arange(S, dtype=torch.float32,
                                                 device=x.device)
    qh, kh, vh = _qkv_proj(x, p, cfg, positions=positions)
    if impl == "flash" and isinstance(qh, DTensor):
        oh = _local_flash(qh, kh, vh)
    elif impl == "flash":
        oh = attn.flash_attention(qh, kh, vh, True)
    elif impl == "reference":
        # The query heads of this call: a tp shard holds H / tp of them.
        oh = attn.reference_attention(
            qh, attn.expand_kv(kh, qh.shape[1]),
            attn.expand_kv(vh, qh.shape[1]), causal=True)
    elif impl == "ring":
        oh = attn.ring_attention(qh, kh, vh, group=group, causal=True)
    elif impl == "ring_zigzag":
        oh = attn.zigzag_ring_attention(qh, kh, vh, group=group)
    elif impl == "ring_reference":
        oh = attn.ring_attention(qh, kh, vh, group=group, causal=True,
                                 impl="reference")
    else:
        oh = attn.ulysses_attention(qh, kh, vh, group=group, causal=True)
    return _out_proj(oh, p, cfg), kh, vh


def _layer_body(x, p, cfg: TransformerConfig, return_aux: bool = False,
                sp=None, ep=None):
    x = x + _attention(_rmsnorm(x, p["ln1"]), p, cfg, sp)[0]
    return _mlp_block(x, p, cfg, return_aux=return_aux, ep=ep)


def _dots_policy(ctx, op, *args, **kwargs):
    """``dots`` remat: save the outputs of matrix products with no batch
    dimension — ``aten.mm`` / ``aten.addmm``, and ``aten.bmm`` over a
    batch of one, which is how ``einsum`` runs the projections
    (``bsd,dhk->bshk``) — and recompute everything else: the attention
    scores' batched ``bmm``, the switch MoE's expert products (a
    ``bmm`` over E > 1 experts, a batched dot in JAX too) and the flash
    ``autograd.Function`` (a JAX ``pallas_call`` is no saveable dot
    either).  The counterpart of
    ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``."""
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default) or (
            op is aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_layer(x, p, cfg: TransformerConfig, return_aux: bool = False,
                 sp=None, ep=None):
    """One layer under ``torch.utils.checkpoint`` (the JAX ``_remat``):
    its backward reruns the forward (K1 launches again, into a fresh
    buffer), saving what the policy says.  The layer draws no random
    numbers, so no RNG state is stashed (a CUDA graph capture could not
    read it)."""
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return checkpoint(_layer_body, x, p, cfg, return_aux, sp, ep,
                      use_reentrant=False, preserve_rng_state=False, **kw)


def forward(params: Dict, tokens, cfg: TransformerConfig,
            return_aux: bool = False):
    """Logits ``(B, S, V)`` f32 for next-token prediction; ``tokens``
    ``(B, S)`` integer.  With ``cfg.remat`` each layer is
    rematerialised (:func:`_remat_layer`).  ``return_aux`` also returns
    the sum over layers of the MoE balance loss (0 for a dense model).
    A sequence-parallel impl reads the bound ``sp`` axis here
    (:func:`_sp_axis`): ``tokens`` are this rank's sequence shard; so
    does ``moe_axis`` its axis (:func:`_ep_axis`)."""
    sp, ep = _sp_axis(cfg), _ep_axis(cfg)
    x = _embed(params, tokens, cfg)
    layer = _remat_layer if cfg.remat else _layer_body
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in _layers(params):
        if return_aux:
            x, a = layer(x, p, cfg, True, sp, ep)
            aux = aux + a
        else:
            x = layer(x, p, cfg, False, sp, ep)
    logits = _lm_head(x, params["ln_f"], params["head"], cfg)
    return (logits, aux) if return_aux else logits


def _xent_sum(logits, targets):
    """Sum of next-token cross-entropy over all positions."""
    if _tp_sharded(logits):
        return _vocab_parallel_xent_sum(logits, targets)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return (logz - gold).sum()


def loss_fn(params: Dict, batch: Dict, cfg: TransformerConfig):
    """Mean next-token cross-entropy; ``batch = {tokens, targets}``.
    With ``cfg.moe_aux_coeff > 0`` on an MoE config, plus ``coeff *`` the
    sum over layers of the Switch balance loss."""
    if cfg.n_experts > 1 and cfg.moe_aux_coeff > 0.0:
        logits, aux = forward(params, batch["tokens"], cfg, return_aux=True)
        xent = _xent_sum(logits, batch["targets"]) / batch["targets"].numel()
        return xent + cfg.moe_aux_coeff * aux
    logits = forward(params, batch["tokens"], cfg)
    return _xent_sum(logits, batch["targets"]) / batch["targets"].numel()


@torch.no_grad()
def expert_load(params: Dict, tokens, cfg: TransformerConfig):
    """``(n_layers, n_experts)`` f32: the fraction of tokens whose top-1
    route (f32 router) lands on each expert, on the activations entering
    each MoE block of a forward pass over ``tokens``.  Rows sum to 1;
    uniform rows mean a balanced router."""
    if cfg.n_experts <= 1:
        raise ValueError("expert_load needs an MoE config (n_experts > 1)")
    sp, ep = _sp_axis(cfg), _ep_axis(cfg)
    x = _embed(params, tokens, cfg)
    fracs = []
    for p in _layers(params):
        att = x + _attention(_rmsnorm(x, p["ln1"]), p, cfg, sp)[0]
        m = _rmsnorm(att, p["ln2"])
        logits = m.float().reshape(-1, cfg.d_model) @ p["router"].float()
        fracs.append(moe._onehot(torch.argmax(logits, dim=-1),
                                 cfg.n_experts, torch.float32).mean(0))
        x = _mlp_block(att, p, cfg, ep=ep)
    return torch.stack(fracs)


def synthetic_batch(seed: int, cfg: TransformerConfig, batch: int,
                    seq: int = None, *, device=None) -> Dict:
    """Random tokens from a ``torch.Generator`` seeded with ``seed``, and
    their next-token targets ``roll(tokens, -1)`` (``synthetic_batch``)."""
    device = resolve_device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq or cfg.max_seq),
                           generator=g, device=device)
    return {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}


# --- pipeline parallelism over the bound ``pp`` axis -------------------------


def _pipeline_stage_setup(cfg: TransformerConfig, P_: int, batch: int,
                          n_microbatches: Optional[int],
                          return_aux: bool = False):
    """Shared pipeline plumbing (every schedule): the divisibility checks
    (JAX's texts), the microbatch count, the layers a stage, and the
    stage function over a stage's (or a chunk's) stacked layers, with
    the bound ``sp`` and ``moe_axis`` axes read here, once, as
    :func:`forward` reads them; with ``return_aux`` it returns the
    stage's MoE balance-loss sum too."""
    if cfg.n_layers % P_:
        raise ValueError(
            f"n_layers={cfg.n_layers} must divide over {P_} pipeline stages")
    per_stage = cfg.n_layers // P_
    M = n_microbatches or P_
    if batch % M:
        raise ValueError(f"batch {batch} must divide into {M} microbatches")
    sp, ep = _sp_axis(cfg), _ep_axis(cfg)
    layer = _remat_layer if cfg.remat else _layer_body

    def stage_fn(stack, x):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for p in _layers({"layers": stack}):
            if return_aux:
                x, a = layer(x, p, cfg, True, sp, ep)
                aux = aux + a
            else:
                x = layer(x, p, cfg, False, sp, ep)
        return (x, aux) if return_aux else x

    return M, per_stage, stage_fn


def _stage_layers(params: Dict, first: int, n: int) -> Dict:
    """Layers ``[first, first + n)`` of the stacks, as views."""
    return {k: v.narrow(0, first, n) for k, v in params["layers"].items()}


def pipelined_forward(params: Dict, tokens, cfg: TransformerConfig, *,
                      n_microbatches: Optional[int] = None,
                      return_aux: bool = False):
    """:func:`forward` with the layer stack run as a GPipe pipeline over
    the bound mesh's ``pp`` axis (``parallel.bind``): rank ``s`` of the
    axis runs layers ``[s * L/P, (s + 1) * L/P)`` on ``n_microbatches``
    (default P) microbatches (:func:`~horovod_tpu_torch.parallel.
    pipeline.pipeline_apply`); the parameters and ``tokens`` are the
    same on every rank of the axis.  The logits are :func:`forward`'s.

    ``return_aux`` also returns THIS stage's MoE balance-loss sum (its
    sum over the axis is :func:`forward`'s aux).  Differentiable, each
    rank taking its own stage's share of the layer gradients (and stage
    0 the embedding's); :func:`pipelined_value_and_grad` is the training
    entry."""
    group, s = meshes.axis_group("pp"), meshes.axis_index("pp")
    B = tokens.shape[0]
    M, per, stage_fn = _pipeline_stage_setup(
        cfg, meshes.axis_size("pp"), B, n_microbatches, return_aux)
    x = _embed(params, tokens, cfg)
    mb = x.reshape(M, B // M, *x.shape[1:])
    out = _pl.pipeline_apply(stage_fn, _stage_layers(params, s * per, per),
                             mb, group=group, stage_aux=return_aux)
    if return_aux:
        out, aux_local = out
    logits = _lm_head(out.reshape(x.shape), params["ln_f"], params["head"],
                      cfg)
    return (logits, aux_local) if return_aux else logits


def pipelined_value_and_grad(params: Dict, batch: Dict,
                             cfg: TransformerConfig, *,
                             n_microbatches: Optional[int] = None,
                             schedule: str = "gpipe", n_virtual: int = 2):
    """The loss and EXACT full-parameter gradients of the model trained
    as a pipeline over the bound mesh's ``pp`` axis: ``(loss, grads)``,
    ``grads`` a dict shaped as ``params``, the same on every rank of the
    axis; the parameters and the batch are the same on every rank of it
    (the batch is this rank's shard over the other axes: its sequence
    shard under ``sp``, its rows under ``ep``).  ``loss`` is
    :func:`loss_fn`'s, its aux term per microbatch (the dispatch group
    the switch routing sees, averaged over the M groups: equal to
    :func:`loss_fn`'s at ``n_microbatches=1``).

    ``schedule``: ``"gpipe"``, ``"1f1b"`` (memory flat in M) or
    ``"interleaved"`` (``n_virtual`` chunks a stage, laid round-robin:
    chunk ``c`` of stage ``s`` is global chunk ``c * P + s``), as
    :func:`~horovod_tpu_torch.parallel.pipeline.pipeline_value_and_grad`
    runs them on the embedded microbatches, the final norm and the head
    as the loss's parameters and the input gradients returned.  Each
    gradient has one owning stage: the layer gradients are gathered from
    their stages over pp, the final norm's and the head's come from the
    last stage, and the embedding's is stage 0's input gradients added
    into the token rows.  JAX's ``_varying_value_and_grad`` makes the
    same ownership explicit for shard_map's varying types; here each
    stage's backward is local and the exchange over pp is the sum.

    With ``moe_axis`` the parameters stay whole on every rank and each
    ep rank's gradient of an expert stack is zero outside its resident
    slice, so the average over ep (``DistributedOptimizer(axis_name=
    "ep")``) equals JAX's reassembly of the resident pieces."""
    st = _pl._Stages.of_group(meshes.axis_group("pp"))
    return _pipelined_value_and_grad(params, batch, cfg, st,
                                     n_microbatches=n_microbatches,
                                     schedule=schedule, n_virtual=n_virtual)


def _pipelined_value_and_grad(params: Dict, batch: Dict,
                              cfg: TransformerConfig, st, *,
                              n_microbatches: Optional[int] = None,
                              schedule: str = "gpipe", n_virtual: int = 2):
    """:func:`pipelined_value_and_grad` over the stages ``st`` holds (a
    ``parallel.pipeline._Stages``: one stage of the pp group, or every
    stage of a virtual pipeline in this process)."""
    if schedule not in _pl._SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    P_ = st.P
    tokens, targets = batch["tokens"], batch["targets"]
    B, S = tokens.shape
    aux_on = cfg.n_experts > 1 and cfg.moe_aux_coeff > 0.0
    M, _, stage_fn = _pipeline_stage_setup(cfg, P_, B, n_microbatches,
                                           aux_on)
    v = 1
    if schedule == "interleaved":
        v = int(n_virtual)
        if cfg.n_layers % (v * P_):
            raise ValueError(
                f"n_layers={cfg.n_layers} must divide over "
                f"{v} virtual x {P_} stages")
    n = cfg.n_layers // (v * P_)  # layers a chunk
    n_tok = B * S
    with torch.no_grad():
        x = _embed(params, tokens, cfg)
    xs = x.reshape(M, B // M, S, cfg.d_model)
    ts = targets.reshape(M, B // M, S)

    def loss_fn(lp, y, tgt):
        logits = _lm_head(y, lp["ln_f"], lp["head"], cfg)
        return _xent_sum(logits, tgt) / n_tok  # microbatch losses sum to mean

    chunks = [[_stage_layers(params, (c * P_ + s) * n, n) for c in range(v)]
              for s in st.held]
    res = _pl._run(st, stage_fn, chunks, xs, ts, loss_fn, schedule=schedule,
                   lp={"ln_f": params["ln_f"], "head": params["head"]},
                   aux_w=cfg.moe_aux_coeff / M if aux_on else None,
                   input_grad=True, v=v)
    loss = st.sum([r[0] for r in res])

    # Layers: each chunk's gradient from its stage, in global chunk order.
    names = list(params["layers"])
    layer_grads = {}
    for j, name in enumerate(names):
        mine = []
        for (_, cgrads, _, _), cs in zip(res, chunks):
            mine.append(torch.stack([
                torch.zeros_like(c[name]) if g is None or g[j] is None
                else g[j] for g, c in zip(cgrads, cs)]))
        full = torch.stack(st.gather(mine))  # (P, v, n, ...)
        layer_grads[name] = full.transpose(0, 1).reshape(
            params["layers"][name].shape)
    # The final norm and the head: the last stage's.
    lpg = [r[2] for r in res]
    out = {}
    for j, name in enumerate(("ln_f", "head")):
        out[name] = st.broadcast([None if g is None else g[j] for g in lpg],
                                 P_ - 1, params[name])[0]
    # The embedding: stage 0's input gradients, into the token rows.
    xg = [None if r[3] is None else torch.stack(r[3]) for r in res]
    gx = st.broadcast(xg, 0, xs)[0]
    embed = torch.zeros(params["embed"].shape, dtype=cfg.dtype,
                        device=gx.device).index_add_(
        0, tokens.reshape(-1).long(), gx.reshape(n_tok, cfg.d_model))
    return loss, {"embed": embed.to(params["embed"].dtype),
                  "layers": layer_grads, "ln_f": out["ln_f"],
                  "head": out["head"]}


# --- tensor-parallel serving -------------------------------------------------
#
# Megatron-style tp over the serving path (JAX's serving_param_specs and
# GSPMD): attention heads and the MLP hidden dimension split over tp, the
# embedding and the LM head at the vocabulary, norms replicated, KV caches
# and page pools split by kv head.  A process holds some of the shards
# (:class:`TPShards`: one in the real form, one process a tp rank; all of
# them in the virtual form, which has no group) and runs every local
# shard's heads and hidden slice; the row-parallel partials (``wo``,
# ``w_down``) and the vocabulary-masked embedding are summed in f32 in
# shard order, then over the group, and rounded once to ``cfg.dtype``;
# the vocabulary-sharded f32 logits are gathered, so every rank samples
# the same token from the same logits.  A sharded cache or pool holds a
# list (one tensor a local shard, each its own contiguous storage) where
# an unsharded one holds a tensor; ``pos`` is shared.


def serving_param_specs(cfg: TransformerConfig, axes=("tp",)) -> Dict:
    """:func:`param_specs` with every mesh axis but ``axes`` replicated
    (JAX's ``serving_param_specs``): heads, the MLP hidden dimension and
    the vocabulary over tp, everything else replicated."""
    def keep(tree):
        if isinstance(tree, dict):
            return {k: keep(v) for k, v in tree.items()}
        return P(*[a if a in axes else None for a in tree])

    return keep(param_specs(cfg))


def cache_specs() -> Dict:
    """KV-cache specs ``(L, B, H_kv, T, Dh)``: the kv-head dimension over
    tp (also the layout of a prefill's output block), ``pos``
    replicated."""
    return {"k": P(None, None, "tp", None, None),
            "v": P(None, None, "tp", None, None),
            "pos": P()}


def paged_pool_specs(quantized: bool = False) -> Dict:
    """Page-pool specs ``(L, P, H_kv, page, Dh)``: pages split by kv head,
    never by page id, so page tables, grants, refcounts and copy-on-write
    stay host data; int8 scales ``(L, P, H_kv, page)`` ride the same
    split; ``pos`` replicated."""
    specs = {"k": P(None, None, "tp", None, None),
             "v": P(None, None, "tp", None, None),
             "pos": P()}
    if quantized:
        specs["k_scale"] = P(None, None, "tp", None)
        specs["v_scale"] = P(None, None, "tp", None)
    return specs


def paged_kernel_specs(quantized: bool = False):
    """K4's operand and result specs under tp, ``(q, k_pool, v_pool[,
    k_scale, v_scale], table, limit)`` / ``(o, lse)``: the kernel's grid is
    per (slot, kv head) with no traffic across heads, so every operand
    splits at its kv-head dimension and the table and limits stay
    replicated."""
    head = P(None, "tp", None, None)
    scale = P(None, "tp", None)
    in_specs = (head, head, head)
    if quantized:
        in_specs = in_specs + (scale, scale)
    return in_specs + (P(), P()), (head, P(None, "tp", None))


def prefix_kv_specs():
    """A gathered prefix block ``(L, H_kv, n * page, Dh)``: kv heads over
    tp, as the pool it was gathered from."""
    return P(None, "tp", None, None)


def serving_shardings(mesh, cfg: TransformerConfig):
    """``(param shardings, cache shardings)``: :class:`~horovod_tpu_torch.
    parallel.sharding.NamedSharding` trees of :func:`serving_param_specs`
    and :func:`cache_specs` over a tp ``mesh``."""
    from horovod_tpu_torch.parallel.sharding import named_shardings

    return (named_shardings(mesh, serving_param_specs(cfg)),
            named_shardings(mesh, cache_specs()))


def tp_bounds(n: int, tp: int):
    """The ``tp + 1`` bounds of a dimension of ``n`` split over tp, as even
    as integers allow (GSPMD pads instead; the sums are the same)."""
    return [(i * n) // tp for i in range(tp + 1)]


class TPShards:
    """The tensor-parallel shards of a model's parameters that this
    process holds (:func:`shard_params`).

    ``shards``: parameter dicts in the package layout, each cut to one
    shard by :func:`serving_param_specs`; ``index``: the shard number of
    each (``(rank,)`` in the real form, ``0..tp-1`` in the virtual one);
    ``group``: the process group over the tp ranks, None when this
    process holds every shard.  :meth:`reduce` and :meth:`gather` are the
    collectives of the sharded body; with a group of one shard a rank
    they are one ``all_reduce`` and one ``all_gather`` each."""

    def __init__(self, shards, index, tp: int, vocab_size: int, group=None):
        self.shards = list(shards)
        self.index = tuple(index)
        self.tp = tp
        self.group = group
        if group is not None and len(self.shards) != 1:
            raise ValueError("a tp rank in a group holds one shard")
        b = tp_bounds(vocab_size, tp)
        self.vocab_bounds = [(b[i], b[i + 1]) for i in range(tp)]

    def reduce(self, parts, dtype):
        """The sum of row-parallel partials: in f32, local shards in
        order, then over the group, rounded once to ``dtype``."""
        s = parts[0].float()
        for p in parts[1:]:
            s = s + p.float()
        if self.group is not None:
            s = s.contiguous()
            dist.all_reduce(s, group=self.group)
        return s.to(dtype)

    def gather(self, parts):
        """Vocabulary-sharded logits ``(..., V_shard)`` -> ``(..., V)`` in
        shard order, on every rank."""
        if self.group is None:
            return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
        x = parts[0]
        width = max(hi - lo for lo, hi in self.vocab_bounds)
        if x.shape[-1] < width:
            x = F.pad(x, (0, width - x.shape[-1]))
        bufs = [torch.empty_like(x) for _ in range(self.tp)]
        dist.all_gather(bufs, x.contiguous(), group=self.group)
        return torch.cat([b[..., :hi - lo] for b, (lo, hi)
                          in zip(bufs, self.vocab_bounds)], dim=-1)

    def embed(self, tokens, dtype, active=None):
        """The vocabulary-parallel lookup: each shard looks up the ids in
        its rows and zeros the others (and inactive rows), summed."""
        parts = []
        for sh, i in zip(self.shards, self.index):
            lo, hi = self.vocab_bounds[i]
            t = tokens.long() - lo
            inside = (t >= 0) & (t < hi - lo)
            if active is not None:
                inside = inside & active.reshape(
                    active.shape + (1,) * (t.dim() - active.dim()))
            x = sh["embed"].to(dtype)[t.clamp(0, hi - lo - 1)]
            parts.append(torch.where(inside[..., None], x,
                                     torch.zeros_like(x)))
        return self.reduce(parts, dtype)


def _cut(t, spec, tp: int, i: int):
    """Shard ``i`` of tp of ``t`` by ``spec`` in storage of its own; a
    replicated leaf as it is."""
    for d, a in enumerate(spec):
        if a == "tp":
            b = tp_bounds(t.shape[d], tp)
            return t.narrow(d, b[i], b[i + 1] - b[i]).clone(
                memory_format=torch.contiguous_format)
    return t


def shard_params(params: Dict, sharding, cfg: TransformerConfig) -> TPShards:
    """The local shards of ``params`` on a serving ``sharding``
    (:class:`~horovod_tpu_torch.serving.sharding.ServingSharding`: its
    ``tp``, the ``index`` of the shards this process holds and the tp
    ``group``), cut by :func:`serving_param_specs`, each leaf contiguous
    (K1 and K4 read them in place)."""
    specs = serving_param_specs(cfg)

    def one(i):
        def walk(tree, spec):
            if isinstance(tree, dict):
                return {k: walk(v, spec[k]) for k, v in tree.items()}
            return _cut(tree, spec, sharding.tp, i)
        return walk(params, specs)

    return TPShards([one(i) for i in sharding.index], sharding.index,
                    sharding.tp, cfg.vocab_size, sharding.group)


def shard_kv_pool(pool: Dict, sharding) -> Dict:
    """A whole paged pool cut to the local shards of ``sharding`` by
    :func:`paged_pool_specs` (payload and int8 scales by kv head, each
    shard contiguous; ``pos`` shared)."""
    specs = paged_pool_specs("k_scale" in pool)
    return {k: (v if k == "pos" else
                [_cut(v, specs[k], sharding.tp, i) for i in sharding.index])
            for k, v in pool.items()}


def _tp(params):
    """``(shard dicts, TPShards or None)``: a sharded model's local
    shards, or a whole model as its one shard."""
    if isinstance(params, TPShards):
        return params.shards, params
    return [params], None


def _tp_sum(parts, tp, dtype):
    return parts[0] if tp is None else tp.reduce(parts, dtype)


def _local(store: Dict, n: int):
    """A cache or pool dict as ``n`` per-shard dicts (a list-valued entry
    is sharded, a tensor shared)."""
    return [{k: (v[i] if isinstance(v, list) else v)
             for k, v in store.items()} for i in range(n)]


def _embed_tp(params, tokens, cfg: TransformerConfig, active=None):
    if isinstance(params, TPShards):
        return params.embed(tokens, cfg.dtype, active)
    return _embed(params, tokens, cfg, active)


def _mlp_block_tp(x, ps, tp, cfg: TransformerConfig, moe_impl: str):
    """:func:`_mlp_block` over the local shards ``ps``: each shard's MLP
    on its hidden slice (an MoE's expert FFNs split the same way, the
    router replicated), the partials reduced."""
    if tp is None:
        return _mlp_block(x, ps[0], cfg, moe_impl=moe_impl)
    m = _rmsnorm(x, ps[0]["ln2"])
    parts = [_moe_mlp(m, p, cfg, impl=moe_impl) if cfg.n_experts > 1
             else _dense_mlp(m, p, cfg) for p in ps]
    return x + tp.reduce(parts, x.dtype)


def _lm_head_tp(y, params, cfg: TransformerConfig):
    shards, tp = _tp(params)
    if tp is None:
        return _lm_head(y, params["ln_f"], params["head"], cfg)
    return tp.gather([_lm_head(y, s["ln_f"], s["head"], cfg)
                      for s in shards])


# --- prefill + the contiguous-cache oracle -----------------------------------


def init_cache(cfg: TransformerConfig, batch: int, max_len: int = 0, *,
               device=None, params=None) -> Dict:
    """KV cache ``(L, B, H_kv, T, Dh)`` in ``cfg.dtype`` and a scalar
    position (a Python int, the write position of the next token).  For
    :class:`TPShards` ``params``, ``k`` and ``v`` are lists: one tensor a
    local shard, at the shard's kv heads."""
    device = resolve_device(device)
    T = max_len or cfg.max_seq

    def zeros(hkv):
        return torch.zeros((cfg.n_layers, batch, hkv, T, cfg.head_dim),
                           dtype=cfg.dtype, device=device)

    if isinstance(params, TPShards):
        heads = [s["layers"]["wk"].shape[2] for s in params.shards]
        return {"k": [zeros(h) for h in heads],
                "v": [zeros(h) for h in heads], "pos": 0}
    return {"k": zeros(cfg.kv_heads), "v": zeros(cfg.kv_heads), "pos": 0}




@torch.no_grad()
def prefill(params: Dict, prompt, cache: Dict, cfg: TransformerConfig, *,
            moe_impl: str = "dropless", true_len=None):
    """Fill a FRESH cache with a ``(B, S0)`` prompt in one forward pass;
    returns ``(last-position logits (B, V), cache)``.  The cache's first
    ``S0`` positions are written in place.

    ``true_len`` supports bucketed prefill: prompts right-padded to
    ``S0`` with their real lengths, a scalar or a ``(B,)`` tensor —
    logits come from position ``true_len - 1`` of each row and ``pos``
    becomes ``true_len``.  Causality keeps the padding out of the
    logits; the junk K/V it leaves past ``true_len`` is never read.

    ``moe_impl``: the MoE dispatch of an MoE config, by default
    ``"dropless"`` (G1 on CUDA), whose rows do not depend on the other
    rows, padding included."""
    if not isinstance(cache["pos"], int) or cache["pos"] != 0:
        raise ValueError("prefill requires a fresh cache (pos == 0)")
    B, S0 = prompt.shape
    shards, tp = _tp(params)
    caches = _local(cache, len(shards))
    if S0 > caches[0]["k"].shape[3]:
        raise ValueError(
            f"prompt ({S0} tokens) exceeds cache capacity "
            f"({caches[0]['k'].shape[3]}); init_cache with a larger "
            "max_len")
    x = _embed_tp(params, prompt, cfg)
    for l in range(cfg.n_layers):
        ps = [_layer(s, l) for s in shards]
        xn = _rmsnorm(x, ps[0]["ln1"])
        hs = []
        for p, c in zip(ps, caches):
            h, kh, vh = _attention(xn, p, cfg, prefill=True)
            c["k"][l, :, :, :S0] = kh
            c["v"][l, :, :, :S0] = vh
            hs.append(h)
        x = _mlp_block_tp(x + _tp_sum(hs, tp, x.dtype), ps, tp, cfg,
                          moe_impl)
    if true_len is None:
        last = x[:, -1:]
        new_pos = S0
    else:
        tl = torch.as_tensor(true_len, dtype=torch.long, device=x.device)
        idx = (tl - 1).expand(B) if tl.dim() == 0 else tl - 1
        last = x[torch.arange(B, device=x.device), idx][:, None]
        new_pos = int(tl) if tl.dim() == 0 else tl.to(torch.int32)
    logits = _lm_head_tp(last, params, cfg)
    cache["pos"] = new_pos
    return logits[:, 0], cache


def _prefix_attend_reference(qh, kh, vh, pk, pv, p0):
    """The JAX package's grouped attention of :func:`prefill_with_prefix`:
    ``(K, H, S0, Dh)`` queries against ``concat(prefix, suffix)`` with the
    concatenated mask (prefix columns ``< p0`` visible, the rest never;
    the suffix causal), products of the K/V dtype accumulated in f32,
    masked scores ``-1e30``."""
    K, H, S0, Dh = qh.shape
    Hkv, P0 = pk.shape[0], pk.shape[1]
    dev = qh.device
    k_full = torch.cat([pk[None].expand(K, Hkv, P0, Dh), kh], dim=2)
    v_full = torch.cat([pv[None].expand(K, Hkv, P0, Dh), vh], dim=2)
    pre_vis = (torch.arange(P0, device=dev) < p0)[None, :].expand(S0, P0)
    rows = torch.arange(S0, device=dev)
    mask = torch.cat([pre_vis, rows[None, :] <= rows[:, None]], dim=1)
    qg = qh.reshape(K, Hkv, H // Hkv, S0, Dh)
    s = torch.einsum("bkgsd,bktd->bkgst", qg.to(k_full.dtype).float(),
                     k_full.float()) / math.sqrt(Dh)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    w = _softmax(s)
    o = torch.einsum("bkgst,bktd->bkgsd", w.to(v_full.dtype).float(),
                     v_full.float())
    return o.reshape(K, H, S0, Dh)


@torch.no_grad()
def prefill_with_prefix(params: Dict, suffix, prefix_k, prefix_v,
                        prefix_len, cfg: TransformerConfig, *, true_len,
                        moe_impl: str = "dropless"):
    """Prefill a ``(K, S0)`` suffix whose first ``prefix_len`` logical
    positions already exist as cached K/V: the prefix-sharing prefill
    (a registered prefix is prefilled once, and a request that starts
    with it runs only its suffix), and every chunk of a chunked prompt
    after the first (the landed chunks are its prefix).

    ``prefix_k`` / ``prefix_v``: ``(L, H_kv, P0, Dh)`` with ``P0 >=
    prefix_len``, shared by every row; positions ``>= prefix_len`` are
    junk (page tails, NULL padding pages) and are never attended.
    ``prefix_len``: an int or a 0-dim integer tensor on the suffix's
    device, never read back to the host, so a CUDA graph captured once
    serves every prefix length that fits ``P0``.  ``true_len``: ``(K,)``
    real suffix lengths (rows right-padded to ``S0``).  Suffix queries
    take RoPE positions ``prefix_len + i`` and attend the prefix and
    their causal span of the suffix.  Returns ``(last-real-position
    logits (K, V), {"k": (L, K, H_kv, S0, Dh), "v": ..., "pos":
    prefix_len + true_len})``, the contract of ``prefill_with_prefix`` in
    the JAX package.  ``moe_impl`` as :func:`prefill`'s.

    ``attention_impl="flash"`` (and every sequence-parallel impl, as
    in :func:`prefill`) attends through K1 over one ``(K, H_kv,
    P0 + S0, Dh)`` buffer a layer: the padded prefix, with the suffix
    K/V copied in at ``prefix_len + arange(S0)`` (``index_copy_``), and
    ``shift = -prefix_len`` as a device scalar.  Row ``i`` sees column
    ``j`` iff ``j <= prefix_len + i``: the prefix and the causal
    suffix.  The suffix overwrites the junk at ``[prefix_len, P0)``, and
    the junk past ``prefix_len + S0`` lies beyond every row's diagonal;
    K1 maps the kv heads itself (on CPU tensors its plain version).
    ``reference`` runs the JAX package's grouped einsum.  The prefix is
    cast to the suffix K/V's dtype (an int8 pool arrives dequantized to
    f32)."""
    K, S0 = suffix.shape
    dev = suffix.device
    p0 = torch.as_tensor(prefix_len, dtype=torch.long, device=dev)
    tl = torch.as_tensor(true_len, dtype=torch.long, device=dev).reshape(-1)
    positions = p0 + torch.arange(S0, device=dev)
    shift = (-p0).to(torch.int32)
    shards, tp = _tp(params)
    pre = _local({"k": prefix_k, "v": prefix_v}, len(shards))
    x = _embed_tp(params, suffix, cfg)
    ks, vs = [[] for _ in shards], [[] for _ in shards]
    for l in range(cfg.n_layers):
        ps = [_layer(s, l) for s in shards]
        xn = _rmsnorm(x, ps[0]["ln1"])
        outs = []
        for i, (p, pr) in enumerate(zip(ps, pre)):
            qh, kh, vh = _qkv_proj(xn, p, cfg, positions=positions)
            pk, pv = pr["k"][l].to(kh.dtype), pr["v"][l].to(vh.dtype)
            if cfg.attention_impl != "reference":
                Hkv, P0, Dh = pk.shape
                k_full = torch.cat([pk[None].expand(K, Hkv, P0, Dh), kh],
                                   dim=2)
                v_full = torch.cat([pv[None].expand(K, Hkv, P0, Dh), vh],
                                   dim=2)
                k_full.index_copy_(2, positions, kh)
                v_full.index_copy_(2, positions, vh)
                oh, _ = attn.flash_attention_shifted(qh, k_full, v_full,
                                                     shift)
            else:
                oh = _prefix_attend_reference(qh, kh, vh, pk, pv, p0)
            ks[i].append(kh)
            vs[i].append(vh)
            outs.append(_out_proj(oh, p, cfg))
        x = _mlp_block_tp(x + _tp_sum(outs, tp, x.dtype), ps, tp, cfg,
                          moe_impl)
    last = x[torch.arange(K, device=dev), tl - 1][:, None]
    logits = _lm_head_tp(last, params, cfg)
    k, v = [torch.stack(a) for a in ks], [torch.stack(a) for a in vs]
    if tp is None:
        k, v = k[0], v[0]
    return logits[:, 0], {"k": k, "v": v, "pos": p0 + tl}


def _cache_attend(qh, k_cache, v_cache, mask):
    """One query token per row against the full cache: products of the
    stored dtype accumulated in f32, GQA by grouping the queries.
    ``mask`` broadcasts to ``(B, H_kv, G, T)``; returns f32
    ``(B, H, 1, Dh)``."""
    B, H, _, Dh = qh.shape
    Hkv = k_cache.shape[1]
    qg = qh.reshape(B, Hkv, H // Hkv, Dh)
    s = torch.einsum("bkgd,bktd->bkgt", qg.to(k_cache.dtype).float(),
                     k_cache.float()) / math.sqrt(Dh)
    s = torch.where(mask, s, torch.full_like(s, attn.NEG_INF))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,bktd->bkgd", w.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, H, 1, Dh)


def _attention_decode(x, p, cfg: TransformerConfig, k_cache, v_cache,
                      pos: int):
    """Write this position's K/V at ``pos`` (in place), attend q over
    positions ``<= pos``."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    qh, k_t, v_t = _qkv_proj(x, p, cfg, positions=positions)
    k_cache[:, :, pos] = k_t[:, :, 0]
    v_cache[:, :, pos] = v_t[:, :, 0]
    T = k_cache.shape[2]
    mask = torch.arange(T, device=x.device) <= pos
    o = _cache_attend(qh, k_cache, v_cache, mask)
    return _out_proj(o.to(cfg.dtype), p, cfg)


@torch.no_grad()
def decode_step(params: Dict, tokens_t, cache: Dict,
                cfg: TransformerConfig):
    """One autoregressive step at the cache's scalar position:
    ``tokens_t`` (B,) -> ``(logits (B, V) f32, cache)``, cache updated in
    place."""
    pos = int(cache["pos"])
    shards, tp = _tp(params)
    caches = _local(cache, len(shards))
    T_cache = caches[0]["k"].shape[3]
    if pos >= T_cache:
        raise ValueError(
            f"decode_step past cache capacity (pos {pos} >= "
            f"{T_cache}); init_cache with a larger max_len")
    x = _embed_tp(params, tokens_t, cfg)[:, None]
    for l in range(cfg.n_layers):
        ps = [_layer(s, l) for s in shards]
        xn = _rmsnorm(x, ps[0]["ln1"])
        hs = [_attention_decode(xn, p, cfg, c["k"][l], c["v"][l], pos)
              for p, c in zip(ps, caches)]
        x = _mlp_block_tp(x + _tp_sum(hs, tp, x.dtype), ps, tp, cfg,
                          "dense")
    logits = _lm_head_tp(x, params, cfg)
    cache["pos"] = pos + 1
    return logits[:, 0], cache


def _attention_decode_slots(x, p, cfg: TransformerConfig, k_cache, v_cache,
                            pos):
    """Per-slot one-token attention against ONE layer's slot cache
    ``(S, H_kv, T, Dh)``: row ``b`` writes its K/V at ``pos[b]`` (one
    ``index_put_``, one position a row, in place) and attends positions
    ``<= pos[b]``.  A write past the cache lands at ``T - 1``, where the
    JAX package's ``dynamic_update_slice`` clamps it: only a slot that is
    retiring (the overlapped pipeline's tick in flight) or inactive gets
    there, and nothing it writes is attended before it is rewritten."""
    S = x.shape[0]
    T = k_cache.shape[2]
    qh, k_t, v_t = _qkv_proj(x, p, cfg, positions=pos[:, None])
    rows = torch.arange(S, device=x.device)
    at = pos.long().clamp(0, T - 1)
    k_cache[rows, :, at] = k_t[:, :, 0].to(k_cache.dtype)
    v_cache[rows, :, at] = v_t[:, :, 0].to(v_cache.dtype)
    mask = torch.arange(T, device=x.device)[None, :] <= pos[:, None]
    o = _cache_attend(qh, k_cache, v_cache, mask[:, None, None, :])
    return _out_proj(o.to(cfg.dtype), p, cfg)


@torch.no_grad()
def decode_step_slots(params: Dict, tokens_t, cache: Dict,
                      cfg: TransformerConfig, active, *,
                      check_capacity: bool = True):
    """One continuous-batching decode tick over a SLOT cache
    (:func:`~horovod_tpu_torch.serving.cache.init_slot_cache`: ``k``/``v``
    ``(L, S, H_kv, T, Dh)``, per-slot ``pos`` ``(S,)`` int32).

    ``tokens_t`` ``(S,)``: each slot's last emitted token; ``active``
    ``(S,)`` bool.  Returns ``logits (S, V)`` f32; the cache (K/V and
    ``pos``, which keeps its storage) is updated in place and also
    returned.  Inactive rows compute on zeros and keep their position;
    their K/V still lands at their stale position, which is harmless:
    a slot writes position ``p`` in the tick that first attends it, so
    whatever a previous tenant left there is overwritten first.  Row
    ``s`` of the logits is :func:`decode_step`'s for the same request
    decoded alone at ``pos[s]``.

    ``check_capacity`` raises when an active slot's position is past the
    cache (it reads the device on the host); a captured tick passes
    False, as :func:`decode_step_paged`'s does."""
    pos = cache["pos"]
    T_cache = cache["k"].shape[3]
    if check_capacity:
        over = active & (pos >= T_cache)
        if bool(over.any()):
            raise ValueError(
                f"decode_step_slots past cache capacity (slots "
                f"{torch.nonzero(over).flatten().tolist()} at pos >= "
                f"{T_cache}); init_slot_cache with a larger max_len")
    x = _embed(params, tokens_t, cfg, active)[:, None]
    for l in range(cfg.n_layers):
        p = _layer(params, l)
        h = _attention_decode_slots(_rmsnorm(x, p["ln1"]), p, cfg,
                                    cache["k"][l], cache["v"][l], pos)
        x = _mlp_block(x + h, p, cfg, moe_impl="dense")
    logits = _lm_head(x, params["ln_f"], params["head"], cfg)
    pos.add_(active.to(pos.dtype))
    return logits[:, 0], cache


def _softmax(x):
    """``jax.nn.softmax``'s arithmetic: ``exp(x - max) / sum``."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


@torch.no_grad()
def sample_token_rows(logits, temperature, top_k, top_p, rng, positions,
                      rows, *, margins: bool = False):
    """Pick one token per row with every sampling parameter as data: the
    serving tick's per-slot sampler and the math :func:`sample_decode`
    is defined by (``sample_token_rows`` of the JAX package).

    ``logits`` ``(R, V)`` f32.  ``temperature`` ``(R,)`` f32: ``<= 0`` is
    the greedy argmax of the raw logits.  ``top_k`` ``(R,)`` integer:
    ``> 0`` keeps the k largest scaled logits (the k-th value from a full
    descending sort, so k is data; ties with it stay).  ``top_p`` ``(R,)``
    f32: nucleus sampling after top-k — keep the smallest
    probability-sorted set whose mass reaches ``top_p``, ties at its
    threshold included (0 or >= 1 is off).  ``rng`` ``(R, 2)`` int64
    keys (:mod:`~horovod_tpu_torch.ops.threefry`), ``positions`` and
    ``rows`` ``(R,)`` integer: row ``r`` draws with
    ``fold_in(fold_in(rng[r], positions[r]), rows[r])``, so a key depends
    on the token's absolute position and never on how generation was
    sliced.  Returns int64 ``(R,)`` tokens; with ``margins=True`` also
    each pick's top-2 gap ``(R,)`` f32 of the scores it took the argmax
    of (raw logits for greedy rows, the filtered and perturbed scores
    for sampled rows), which tells a near-tie from a disagreement.

    Every operation is a tensor operation with no host sync: the tick
    captured as a CUDA graph runs it."""
    V = logits.shape[-1]
    sampled_row = temperature > 0.0
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / torch.where(sampled_row, temperature,
                                  torch.ones_like(temperature))[:, None]
    srt = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(srt, 1, (top_k.long().clamp(1, V) - 1)[:, None])
    scaled = scaled.masked_fill((top_k > 0)[:, None] & (scaled < kth),
                                float("-inf"))
    probs = _softmax(scaled)
    ps = torch.sort(probs, dim=-1, descending=True).values
    csum = torch.cumsum(ps, dim=-1)
    # Sorted index i is in the nucleus iff the mass before it is still
    # under top_p (index 0 always is); the smallest kept probability is
    # the threshold, so threshold ties stay in.
    keep = (csum - ps) < top_p[:, None]
    thr = ps.masked_fill(~keep, float("inf")).amin(dim=-1, keepdim=True)
    p_on = (top_p > 0.0) & (top_p < 1.0)
    scaled = scaled.masked_fill(p_on[:, None] & (probs < thr),
                                float("-inf"))
    keys = threefry.fold_in(threefry.fold_in(rng, positions), rows)
    perturbed = threefry.gumbel(keys, (V,)) + scaled
    tok = torch.where(sampled_row, torch.argmax(perturbed, dim=-1), greedy)
    if not margins:
        return tok
    top2 = torch.topk(torch.where(sampled_row[:, None], perturbed, logits),
                      2, dim=-1).values
    return tok, top2[:, 0] - top2[:, 1]


def _key_rows(rng, rows: int, device):
    """``(rows, 2)`` int64 keys from one raw key (2 uint32 words: a
    sequence, numpy array or tensor)."""
    if isinstance(rng, torch.Tensor):
        key = rng.to(device=device, dtype=torch.int64)
    else:
        key = torch.as_tensor(np.asarray(rng).astype(np.int64),
                              device=device)
    return key.reshape(1, 2).expand(rows, 2)


@torch.no_grad()
def sample_decode(params: Dict, prompt, steps: int, cfg: TransformerConfig,
                  *, rng, temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 0.0, margins: bool = False):
    """Extend a ``(B, S0)`` prompt by ``steps`` sampled tokens ->
    ``(B, steps)`` int64: one prefill, then :func:`decode_step`s, each
    pick by :func:`sample_token_rows` with every parameter broadcast to a
    column — the per-request oracle of the serving engine's per-slot
    sampling.  ``temperature=0`` is greedy (:func:`greedy_decode`).

    ``rng`` is a raw key (``sampling.seed_key(seed)``, or JAX's
    ``np.asarray(jax.random.PRNGKey(seed))``).  Token ``i`` of row ``b``
    (position ``S0 + i``) draws from ``fold_in(fold_in(rng, S0 + i),
    b)``, so ``sample_decode(prompt + emitted, rng)`` continues exactly
    the stream an interrupted call would have produced.

    ``margins=True`` also returns each pick's top-2 gap ``(B, steps)``
    f32 (:func:`sample_token_rows`)."""
    B, S0 = prompt.shape
    dev = prompt.device
    cache = init_cache(cfg, B, S0 + steps, device=dev, params=params)
    logits, cache = prefill(params, prompt, cache, cfg)
    temp = torch.full((B,), float(temperature), dtype=torch.float32,
                      device=dev)
    tk = torch.full((B,), int(top_k), dtype=torch.int64, device=dev)
    tp = torch.full((B,), float(top_p), dtype=torch.float32, device=dev)
    keys = _key_rows(rng, B, dev)
    rows = torch.arange(B, device=dev)
    toks, gaps = [], []
    for i in range(steps):
        pos = torch.full((B,), S0 + i, dtype=torch.int64, device=dev)
        tok, gap = sample_token_rows(logits, temp, tk, tp, keys, pos, rows,
                                     margins=True)
        toks.append(tok)
        gaps.append(gap)
        if i + 1 < steps:
            logits, cache = decode_step(params, tok, cache, cfg)
    out = torch.stack(toks, dim=1)
    return (out, torch.stack(gaps, dim=1)) if margins else out


def greedy_decode(params: Dict, prompt, steps: int, cfg: TransformerConfig,
                  *, margins: bool = False):
    """Extend a ``(B, S0)`` prompt by ``steps`` greedy tokens ->
    ``(B, steps)`` int64: :func:`sample_decode` at temperature 0, the
    per-request oracle for the serving engine.  ``margins=True`` also
    returns each pick's top-2 logit gap ``(B, steps)`` f32, which tells a
    near-tie (where another summation order may pick the other token)
    from a real disagreement."""
    return sample_decode(params, prompt, steps, cfg, rng=(0, 0),
                         temperature=0.0, margins=margins)


# --- paged KV cache ----------------------------------------------------------


_KV_QUANT_EPS = 1e-8


def kv_quantize(x):
    """Symmetric per-vector int8 quantization over the trailing dim ->
    ``(q int8, scale f32)``.  ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = amax.clamp_min(_KV_QUANT_EPS) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def kv_dequantize(q, scale, dtype):
    """Inverse of :func:`kv_quantize`: f32 multiply, then one cast (the
    kernel's load does the same — ``paged_attention.DEQUANT_COMPUTE``)."""
    return pa._dequant(q, scale, dtype)


def _gather_pages(pool_l, table):
    """``(P, H_kv, page, Dh)`` through ``(S, max_pages)`` ->
    ``(S, H_kv, max_pages * page, Dh)`` in logical order."""
    S, max_pages = table.shape
    _, Hkv, ps, Dh = pool_l.shape
    g = pool_l[table.long()]
    return g.movedim(1, 2).reshape(S, Hkv, max_pages * ps, Dh)


def _gather_scales(scale_l, table):
    S, max_pages = table.shape
    _, Hkv, ps = scale_l.shape
    g = scale_l[table.long()]
    return g.movedim(1, 2).reshape(S, Hkv, max_pages * ps)


def _attention_decode_paged(x, p, cfg: TransformerConfig, k_pool, v_pool,
                            k_scale, v_scale, table, pos, active,
                            kernel: bool):
    """Per-slot one-token attention against ONE layer's paged pool.

    Row ``s`` writes its K/V at logical position ``pos[s]``, i.e. page
    ``table[s, pos // page]`` offset ``pos % page`` — in place — then
    attends positions ``<= pos[s]``.  Inactive rows write to physical
    page 0, the NULL page: several of them share that target, and
    ``index_put_`` with duplicate indices leaves an unspecified winner —
    harmless only because no slot ever attends page 0 (its table maps
    real pages below its position, and the kernel's limit is 0 for
    inactive rows).  Active rows never collide: the host allocator gives
    every active slot a private write page.

    ``kernel=True`` attends through :func:`~horovod_tpu_torch.ops.
    paged_attention.paged_attend` (kernel K4 on CUDA); ``False`` gathers
    the logical cache, dequantizes and attends with the plain path."""
    S = x.shape[0]
    max_pages = table.shape[1]
    ps = k_pool.shape[2]
    qh, k_t, v_t = _qkv_proj(x, p, cfg, positions=pos[:, None])
    k_t1, v_t1 = k_t[:, :, 0], v_t[:, :, 0]       # (S, H_kv, Dh)
    rows = torch.arange(S, device=x.device)
    idx = torch.clamp(pos // ps, 0, max_pages - 1).long()
    phys = torch.where(active, table[rows, idx].long(),
                       torch.zeros_like(idx))
    off = (pos % ps).long()
    if k_scale is not None:
        qk, sk = kv_quantize(k_t1)
        qv, sv = kv_quantize(v_t1)
        k_pool[phys, :, off] = qk
        v_pool[phys, :, off] = qv
        k_scale[phys, :, off] = sk
        v_scale[phys, :, off] = sv
    else:
        k_pool[phys, :, off] = k_t1.to(k_pool.dtype)
        v_pool[phys, :, off] = v_t1.to(v_pool.dtype)
    B, H, _, Dh = qh.shape
    if kernel:
        # attend positions <= pos <=> logical < pos + 1; 0 for inactive
        # rows, whose NULL-page writes must never be attended.
        limit = torch.where(active, pos + 1, torch.zeros_like(pos))
        Hkv = k_pool.shape[1]
        qg = qh.reshape(B, Hkv, H // Hkv, Dh)
        o, _ = pa.paged_attend(qg, k_pool, v_pool, k_scale, v_scale, table,
                               limit.to(torch.int32), compute_dtype=cfg.dtype)
        o = o.reshape(B, H, 1, Dh)
    else:
        if k_scale is not None:
            kg = kv_dequantize(_gather_pages(k_pool, table),
                               _gather_scales(k_scale, table), cfg.dtype)
            vg = kv_dequantize(_gather_pages(v_pool, table),
                               _gather_scales(v_scale, table), cfg.dtype)
        else:
            kg = _gather_pages(k_pool, table)
            vg = _gather_pages(v_pool, table)
        T = max_pages * ps
        mask = torch.arange(T, device=x.device)[None, :] <= pos[:, None]
        o = _cache_attend(qh, kg, vg, mask[:, None, None, :])
    return _out_proj(o.to(cfg.dtype), p, cfg)


@torch.no_grad()
def decode_step_paged(params: Dict, tokens_t, pool: Dict, table,
                      cfg: TransformerConfig, active, *, kernel=False,
                      check_capacity: bool = True):
    """One continuous-batching decode tick over a PAGED KV cache.

    ``pool``: ``k``/``v`` ``(L, P, H_kv, page, Dh)`` (plus
    ``k_scale``/``v_scale`` ``(L, P, H_kv, page)`` for int8 storage) and
    per-slot ``pos`` ``(S,)`` int32; ``table``: ``(S, max_pages)`` int32
    page ids; ``active``: ``(S,)`` bool.  Returns ``logits (S, V)`` f32;
    the pool (payload, scales and ``pos``) is updated in place — ``pos``
    keeps its storage — and also returned.  Inactive rows compute on
    zeros and keep their position.

    ``check_capacity`` raises when an active slot's position is past its
    table; the check reads the device on the host.  The serving engine
    passes False: its host mirror of the positions has already proved
    capacity, and the tick must stay free of host syncs (for the
    overlapped pipeline and for CUDA-graph capture)."""
    pos = pool["pos"]
    shards, tp = _tp(params)
    pools = _local(pool, len(shards))
    T_cap = table.shape[1] * pools[0]["k"].shape[3]
    if check_capacity:
        over = active & (pos >= T_cap)
        if bool(over.any()):
            raise ValueError(
                f"decode_step_paged past table capacity (slots "
                f"{torch.nonzero(over).flatten().tolist()} at pos >= "
                f"{T_cap}); init_page_pool with more pages per slot")
    x = _embed_tp(params, tokens_t, cfg, active)[:, None]
    quantized = "k_scale" in pool
    for l in range(cfg.n_layers):
        ps = [_layer(s, l) for s in shards]
        xn = _rmsnorm(x, ps[0]["ln1"])
        hs = [_attention_decode_paged(
            xn, p, cfg, sp["k"][l], sp["v"][l],
            sp["k_scale"][l] if quantized else None,
            sp["v_scale"][l] if quantized else None,
            table, pos, active, kernel) for p, sp in zip(ps, pools)]
        x = _mlp_block_tp(x + _tp_sum(hs, tp, x.dtype), ps, tp, cfg,
                          "dense")
    logits = _lm_head_tp(x, params, cfg)
    pos.add_(active.to(pos.dtype))
    return logits[:, 0], pool


# --- speculative decoding: draft and verify ---------------------------------
#
# Leviathan et al., "Fast Inference from Transformers via Speculative
# Decoding": draft k cheap tokens, verify them in one batched target
# forward, accept the agreeing prefix plus the target's own next token.
# Under greedy decoding the emitted tokens are always the target's argmax
# continuations, so the draft moves only how many tokens a tick emits.


@torch.no_grad()
def draft_propose_paged(params: Dict, tokens_t, pool: Dict, table,
                        cfg: TransformerConfig, active, k: int, *,
                        kernel=False):
    """``k`` greedy draft tokens a slot from a (shallow) draft model:
    ``k + 1`` :func:`decode_step_paged` calls, each fed the previous
    one's argmax, so the draft writes its own K/V for every token it
    proposes (the last call lands the last draft's K/V; its logits are
    dropped).  The draft pool's ``pos`` advances by ``k + 1`` in place;
    the caller sets it back to the verified position, and the rejected
    tail's K/V is overwritten before it is ever attended.  No capacity
    check (the tick must not sync): a position past the table writes the
    last table entry's page, the draft's own, which only moves
    acceptance.  Returns ``(drafts (S, k) int64, pool)``."""
    tok, drafts = tokens_t, []
    for _ in range(k + 1):
        logits, pool = decode_step_paged(params, tok, pool, table, cfg,
                                         active, kernel=kernel,
                                         check_capacity=False)
        tok = torch.argmax(logits, dim=-1)
        drafts.append(tok)
    return torch.stack(drafts[:k], dim=1), pool


@torch.no_grad()
def ngram_propose(hist, pos, k: int):
    """``k`` draft tokens a slot by prompt lookup (n-gram
    self-speculation, no second model): the tokens that followed the most
    recent earlier occurrence of the slot's last bigram in its committed
    history.

    ``hist`` ``(S, T)``, position ``pos[s]`` holding slot ``s``'s last
    committed token.  The copy is gated to committed positions (``<=
    pos``); past them, and for a slot with no earlier match (or fewer
    than two committed tokens), the last token is repeated.  Tensor
    operations only, no data-dependent shape."""
    S, T = hist.shape
    dev = hist.device
    rows = torch.arange(S, device=dev)
    p = pos.long()
    last = hist[rows, p.clamp(0, T - 1)]
    prev = hist[rows, (p - 1).clamp(0, T - 1)]
    iota = torch.arange(T, device=dev)[None, :]
    nxt = torch.cat([hist[:, 1:], torch.zeros_like(hist[:, :1])], dim=1)
    match = ((hist == prev[:, None]) & (nxt == last[:, None])
             & (iota + 1 < p[:, None]))
    idx = torch.where(match, iota, torch.full_like(iota, -1)).amax(dim=1)
    gidx = (idx + 2)[:, None] + torch.arange(k, device=dev)[None, :]
    drafts = torch.gather(hist, 1, gidx.clamp(0, T - 1))
    ok = (idx >= 0)[:, None] & (gidx <= p[:, None])
    return torch.where(ok, drafts, last[:, None])


@torch.no_grad()
def decode_verify_paged(params: Dict, window, pool: Dict, table,
                        cfg: TransformerConfig, active, spec_on=None,
                        sample=None, *, kernel=False):
    """One W-position verify forward over a paged cache: the target half
    of a speculative tick.

    ``window`` ``(S, W)``: column 0 is each slot's last committed token,
    columns 1..W-1 its drafts.  Query offset ``j`` (logical position
    ``pos[s] + j``) attends the slot's committed positions ``< pos[s]``
    through its page table and window offsets ``<= j``.  The window's
    K/V is rounded through the pool's storage first (a cast, or int8
    quantize then dequantize), so each position sees what the one-token
    tick would read back from the pool.

    ``t = argmax`` per position is the target's greedy continuation;
    ``acc[s]`` is the length of the agreeing draft prefix (``window[s,
    1 + i] == t[s, i]``), a ``cumprod`` sum with no host sync, so a slot
    emits ``t[s, 0..acc[s]]``.  ``spec_on`` ``(S,)`` bool forces ``acc``
    to 0 where False (the per-request opt-out).  ``sample`` —
    ``(temperature, top_k, top_p, keys)`` columns
    (:func:`sample_token_rows`) — replaces offset 0 of rows with
    ``temperature > 0`` by the sampled pick at key position ``pos + 1``
    and forces their ``acc`` to 0, so a mixed batch shares the tick and
    sampled streams stay those of :func:`sample_decode`.  Inactive rows
    get ``acc`` 0 and keep their position.

    The pool is updated in place (payload, scales and ``pos``, which
    keeps its storage): window offset ``j`` lands at ``pos + j`` only if
    the row is active, ``j <= acc`` and ``pos + j`` lies within the
    table; every other write goes to physical page 0, the NULL page
    (``index_put_`` leaves an arbitrary winner among duplicate targets,
    harmless because nothing attends page 0).  ``pos`` advances by
    ``acc + 1`` for active rows.  Returns ``(t (S, W) int64, max logit
    (S, W) f32, acc (S,) int64, pool)``.

    ``kernel=True`` attends the committed pages through
    :func:`~horovod_tpu_torch.ops.paged_attention.paged_attend` (K4 on
    CUDA) with the ``G * W`` query rows of each kv head in (G, W) order
    and ``limit = pos`` (0 for inactive rows), adds a dense causal pass
    over the window, and merges the two by log-sum-exp; ``False``
    gathers the pages and applies one mask."""
    pos = pool["pos"]
    S, W = window.shape
    dev = window.device
    shards, tp = _tp(params)
    pools = _local(pool, len(shards))
    max_pages = table.shape[1]
    ps = pools[0]["k"].shape[3]
    T_cap = max_pages * ps
    quantized = "k_scale" in pool
    storage = pools[0]["k"].dtype
    p0 = pos.long()
    x = _embed_tp(params, window, cfg)                     # (S, W, D)
    x = torch.where(active[:, None, None], x, torch.zeros_like(x))
    jw = torch.arange(W, device=dev)
    positions = p0[:, None] + jw[None, :]
    win_vis = jw[None, :] <= jw[:, None]                   # (W, W): col <= row
    if kernel:
        climit = torch.where(active, pos, torch.zeros_like(pos)).to(
            torch.int32)
    else:
        cache_vis = (torch.arange(T_cap, device=dev)[None, :]
                     < p0[:, None])                        # (S, T)
        mask = torch.cat([cache_vis[:, None, :].expand(S, W, T_cap),
                          win_vis[None].expand(S, W, W)], dim=2)
        mask = mask[:, None, None]                         # (S,1,1,W,T+W)
    ys = [[] for _ in shards]
    for l in range(cfg.n_layers):
        lps = [_layer(s, l) for s in shards]
        xn = _rmsnorm(x, lps[0]["ln1"])
        outs = []
        for p, sp, y in zip(lps, pools, ys):
            k_c, v_c = sp["k"][l], sp["v"][l]
            ks_c = sp["k_scale"][l] if quantized else None
            vs_c = sp["v_scale"][l] if quantized else None
            qh, kh, vh = _qkv_proj(xn, p, cfg, positions=positions)
            # This shard's heads: H / tp query heads over H_kv / tp.
            H, Hkv, Dh = qh.shape[1], kh.shape[1], qh.shape[3]
            G = H // Hkv
            if quantized:
                qk, sk = kv_quantize(kh)
                qv, sv = kv_quantize(vh)
                kh_a = kv_dequantize(qk, sk, cfg.dtype)
                vh_a = kv_dequantize(qv, sv, cfg.dtype)
                y.append((qk, sk, qv, sv))
            else:
                kh_a, vh_a = kh.to(storage), vh.to(storage)
                y.append((kh_a, vh_a))
            qg = qh.reshape(S, Hkv, G, W, Dh)
            if kernel:
                o_c, lse_c = pa.paged_attend(
                    qg.reshape(S, Hkv, G * W, Dh), k_c, v_c, ks_c, vs_c,
                    table, climit, compute_dtype=cfg.dtype)
                o_c = o_c.reshape(S, Hkv, G, W, Dh)
                lse_c = lse_c.reshape(S, Hkv, G, W)
                # The window's own causal attention, unnormalized beside
                # its log-sum-exp (the diagonal is always visible: lw >= 1).
                sw = torch.einsum("bkgsd,bktd->bkgst",
                                  qg.to(kh_a.dtype).float(),
                                  kh_a.float()) / math.sqrt(Dh)
                sw = torch.where(win_vis, sw, torch.full_like(sw, -1e30))
                mw = sw.amax(dim=-1)
                pw = torch.exp(sw - mw[..., None])
                lw = pw.sum(dim=-1)
                o_w = torch.einsum("bkgst,bktd->bkgsd",
                                   pw.to(vh_a.dtype).float(),
                                   vh_a.float()) / lw[..., None]
                lse_w = mw + torch.log(lw)
                # Cross-source merge; a_c is exactly 0 for a row with no
                # committed context (lse_c = NEG_INF).
                m = torch.maximum(lse_c, lse_w)
                a_c = torch.exp(lse_c - m)
                a_w = torch.exp(lse_w - m)
                o = ((a_c[..., None] * o_c + a_w[..., None] * o_w)
                     / (a_c + a_w)[..., None])
            else:
                if quantized:
                    kg = kv_dequantize(_gather_pages(k_c, table),
                                       _gather_scales(ks_c, table),
                                       cfg.dtype)
                    vg = kv_dequantize(_gather_pages(v_c, table),
                                       _gather_scales(vs_c, table),
                                       cfg.dtype)
                else:
                    kg = _gather_pages(k_c, table)
                    vg = _gather_pages(v_c, table)
                k_full = torch.cat([kg, kh_a], dim=2)      # (S,Hkv,T+W,Dh)
                v_full = torch.cat([vg, vh_a], dim=2)
                sc = torch.einsum("bkgsd,bktd->bkgst",
                                  qg.to(k_full.dtype).float(),
                                  k_full.float()) / math.sqrt(Dh)
                sc = torch.where(mask, sc, torch.full_like(sc, -1e30))
                w = _softmax(sc)
                o = torch.einsum("bkgst,bktd->bkgsd",
                                 w.to(v_full.dtype).float(), v_full.float())
            outs.append(_out_proj(o.reshape(S, H, W, Dh).to(cfg.dtype), p,
                                  cfg))
        x = _mlp_block_tp(x + _tp_sum(outs, tp, x.dtype), lps, tp, cfg,
                          "dense")
    logits = _lm_head_tp(x, params, cfg)  # (S, W, V)
    t = torch.argmax(logits, dim=-1)
    mx = logits.amax(dim=-1)
    match = (window[:, 1:].long() == t[:, :-1]).long()
    acc = torch.cumprod(match, dim=1).sum(dim=1)
    if spec_on is not None:
        acc = torch.where(spec_on, acc, torch.zeros_like(acc))
    if sample is not None:
        temp, s_tk, s_tp, s_key = sample
        s0 = sample_token_rows(logits[:, 0], temp, s_tk, s_tp, s_key, p0 + 1,
                               torch.zeros_like(p0))
        sampled = temp > 0.0
        t = torch.cat([torch.where(sampled, s0, t[:, 0])[:, None], t[:, 1:]],
                      dim=1)
        acc = torch.where(sampled, torch.zeros_like(acc), acc)
    acc = torch.where(active, acc, torch.zeros_like(acc))

    # Accepted-only scatter: offset j lands at pos + j through the table
    # iff the row is active, j <= acc and pos + j < T_cap; the rest (the
    # rejected tail, inactive rows, positions past the table) goes to
    # the NULL page.
    wpos = positions
    ok = (active[:, None] & (jw[None, :] <= acc[:, None]) & (wpos < T_cap))
    idxp = (wpos // ps).clamp(0, max_pages - 1)
    phys = torch.where(ok, torch.gather(table.long(), 1, idxp),
                       torch.zeros_like(idxp))
    off = wpos % ps
    # Per layer (S, H_kv, W, ...) stacked to (L, ...), laid out (S, W, L,
    # H_kv, ...) as the indexed result of pool[:, phys, :, off].
    names = ((("k", 0), ("k_scale", 1), ("v", 2), ("v_scale", 3))
             if quantized else (("k", 0), ("v", 1)))
    for sp, y in zip(pools, ys):
        for name, i in names:
            vals = torch.stack([e[i] for e in y])
            perm = (1, 3, 0, 2, 4) if vals.dim() == 5 else (1, 3, 0, 2)
            sp[name][:, phys, :, off] = vals.permute(*perm)
    pos.add_(torch.where(active, acc + 1, torch.zeros_like(acc)).to(pos.dtype))
    return t, mx, acc, pool
