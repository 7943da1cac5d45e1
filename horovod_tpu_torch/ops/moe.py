"""Mixture-of-experts dispatch: Switch-style top-1 with a capacity
factor, and the dropless grouped-product dispatch.

Counterpart of ``horovod_tpu/ops/moe.py``, the same functions with the
same arguments, except that ``axis_name`` (a mesh axis under
``shard_map``) becomes ``group``, a ``torch.distributed`` process group
or None:

* :func:`switch_moe`: route each token to its top-1 expert (f32 router),
  each expert takes at most ``cap = ceil(capacity_factor * T / E)``
  tokens in arrival order, the rest are dropped (gate 0: only the
  residual passes).  Static shapes throughout — the dispatch buffer is
  ``(E, cap, D)`` — so a CUDA graph captures it.  With a group of size
  ``ep > 1`` the buffer rides one ``all_to_all_single`` each way (through
  ``torch.distributed.nn.functional``, so gradients flow back as
  ``lax.all_to_all``'s VJP does) and each rank runs only its resident
  experts.  Two dispatches with identical outputs, gradients and drops:
  ``"sort"`` (stable argsort + row gathers) and ``"cumsum"`` (the
  one-hot running position, the oracle).
* :func:`dropless_moe`: sort the tokens by expert and run the three
  expert products as grouped products (:func:`~horovod_tpu_torch.ops.
  grouped_matmul.grouped_matmul`, kernel G1 on CUDA) over offsets built
  on the device with ``searchsorted``: exact, nothing dropped, one
  expert's work a token.  The prefill's dispatch, and a training one
  (as in JAX, without the balance loss): on CUDA its backward runs G1
  with W read transposed for the inputs and G2 for the weights.

Nothing here reads the device on the host (no ``bincount``,
``nonzero``, boolean-mask indexing or ``.item()``), so both dispatches
run inside a captured train step or admission graph.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from horovod_tpu_torch.ops.grouped_matmul import (MAX_GROUPS,
                                                  group_offsets,
                                                  grouped_matmul)

__all__ = ["capacity", "dropless_moe", "switch_moe"]


def capacity(T: int, n_experts: int, capacity_factor: float) -> int:
    """Per-expert token capacity: ``ceil(cf * T / E)`` clamped to [1, T]."""
    cap = int(math.ceil(capacity_factor * T / n_experts))
    return max(1, min(cap, T))


def _onehot(idx, n: int, dtype):
    """``F.one_hot`` without its host-side range check (a device read
    that a CUDA graph capture refuses)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _cumsum_dispatch(xt, e_star, E: int, cap: int):
    """The original dispatch: f32 one-hot running-position cumsum and a
    row scatter into the ``(E, cap + 1, D)`` buffer (dropped tokens land
    in the scratch slot ``cap``).  Kept as the oracle."""
    T, D = xt.shape
    onehot = _onehot(e_star, E, torch.float32)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1).to(torch.int64) - 1
    keep = pos < cap
    slot = torch.where(keep, pos, torch.full_like(pos, cap))
    buf = xt.new_zeros((E, cap + 1, D)).index_put((e_star, slot), xt)
    frac = onehot.mean(dim=0)
    return buf[:, :cap], slot, keep, frac


def _sort_dispatch(xt, e_star, E: int, cap: int):
    """Sort dispatch: a stable argsort by expert (arrival order kept
    within an expert, so drops match the cumsum oracle exactly), then
    the ``(E, cap, D)`` buffer by one row gather (row ``(e, c)`` is
    sorted token ``starts[e] + c``) and each token's slot by a 1-D
    scatter."""
    T, D = xt.shape
    order = torch.argsort(e_star, stable=True)
    es = e_star[order]
    eye = torch.arange(E, dtype=es.dtype, device=es.device)
    starts = torch.searchsorted(es, eye)
    counts = torch.searchsorted(es, eye, right=True) - starts
    pos_sorted = torch.arange(T, device=es.device) - starts[es]
    xs = xt[order]
    c = torch.arange(cap, device=es.device)
    rowidx = (starts[:, None] + c[None]).clamp(0, T - 1)
    rowvalid = c[None] < counts[:, None]
    buf = torch.where(rowvalid[..., None], xs[rowidx],
                      torch.zeros((), dtype=xt.dtype, device=xt.device))
    slot = torch.zeros_like(pos_sorted).scatter(0, order, pos_sorted)
    keep = slot < cap
    frac = counts.to(torch.float32) / T
    return buf, torch.where(keep, slot, torch.full_like(slot, cap)), keep, \
        frac


def _all_to_all(t, group):
    """``all_to_all_single`` over ``group`` with equal splits along dim
    0, differentiable (its backward is the reverse exchange)."""
    from torch.distributed.nn.functional import all_to_all_single

    t = t.contiguous()
    return all_to_all_single(torch.empty_like(t), t, group=group)


def _route(xt, router):
    """f32 router logits -> ``(probs, top-1 expert, its probability)``."""
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)
    return probs, torch.argmax(probs, dim=-1), probs.amax(dim=-1)


def switch_moe(x, router, w_gate, w_up, w_down, *,
               capacity_factor: float = 2.0, group=None,
               return_aux: bool = False, dispatch: str = "sort"):
    """Top-1 expert-parallel MoE FFN (``switch_moe``).

    ``x (..., D)``; ``router (D, E)`` replicated, E the global experts;
    ``w_gate``, ``w_up`` ``(E_local, D, F)`` and ``w_down (E_local, F,
    D)``, this rank's resident experts (the whole stack when ``group`` is
    None); ``group``: the process group the experts are sharded over
    (``ep = group.size()``), or None for one device.  Returns ``y`` shaped
    like ``x``, or ``(y, aux)`` with ``return_aux``: the Switch balance
    loss ``E * Σ_e frac_e · pbar_e``, ``frac`` counted before the
    drops."""
    lead, D = x.shape[:-1], x.shape[-1]
    xt = x.reshape(-1, D)
    T = xt.shape[0]
    ep = group.size() if group is not None else 1
    E_loc = w_gate.shape[0]
    E = E_loc * ep
    if router.shape[1] != E:
        raise ValueError(
            f"router routes over {router.shape[1]} experts but the expert "
            f"stack provides {E_loc} local x {ep} devices = {E} "
            "(sharded weights outside shard_map, or axis_name missing?)")
    if dispatch not in ("sort", "cumsum"):
        raise ValueError(f"unknown dispatch {dispatch!r}; "
                         "expected 'sort' or 'cumsum'")
    dt = x.dtype
    probs, e_star, gate = _route(xt, router)
    cap = capacity(T, E, capacity_factor)
    dispatch_fn = _sort_dispatch if dispatch == "sort" else _cumsum_dispatch
    buf, slot, keep, frac = dispatch_fn(xt, e_star, E, cap)
    gate = torch.where(keep, gate, torch.zeros_like(gate))

    if ep > 1:
        # Chunk e of (ep * E_loc, cap, D) goes to rank e // E_loc; after
        # the exchange block i holds rank i's tokens for MY experts.
        recv = _all_to_all(buf, group)
        toks = (recv.reshape(ep, E_loc, cap, D).transpose(0, 1)
                .reshape(E_loc, ep * cap, D))
    else:
        toks = buf

    # Resident experts only: batched products over the local expert axis.
    g = torch.bmm(toks, w_gate.to(dt))
    u = torch.bmm(toks, w_up.to(dt))
    out = torch.bmm(F.silu(g) * u, w_down.to(dt))

    if ep > 1:
        # Back to each token's owner, in global expert-major order.
        out = (out.reshape(E_loc, ep, cap, D).transpose(0, 1)
               .reshape(E, cap, D))
        out = _all_to_all(out, group)

    y = out[e_star, slot.clamp(max=cap - 1)]  # dropped tokens: gate 0
    y = (y * gate[:, None].to(dt)).reshape(*lead, D)
    if not return_aux:
        return y
    aux = E * torch.sum(frac * probs.mean(dim=0))
    return y, aux


def dropless_moe(x, router, w_gate, w_up, w_down):
    """Top-1 MoE FFN, dropless, by grouped products (``dropless_moe``):
    sort the tokens by expert (stable), build the group offsets on the
    device, run the gate, up and down products as
    :func:`~horovod_tpu_torch.ops.grouped_matmul.grouped_matmul` (G1 on
    CUDA, SiLU · up between them), unsort, scale by the gate.  Exact —
    equal to the dense dispatch, nothing dropped — at one expert's work a
    token.  ``x (..., D)``, ``router (D, E)`` (routing in f32),
    ``w_gate``/``w_up (E, D, F)``, ``w_down (E, F, D)`` in x's dtype.
    Differentiable in every argument, with no host read (a train step
    captures it)."""
    lead, D = x.shape[:-1], x.shape[-1]
    xt = x.reshape(-1, D)
    E = router.shape[1]
    if E > MAX_GROUPS:
        raise ValueError(f"dropless_moe takes at most {MAX_GROUPS} experts, "
                         f"got {E}")
    dt = x.dtype
    _, e_star, gate = _route(xt, router)
    order = torch.argsort(e_star, stable=True)
    xs = xt[order]
    offsets = group_offsets(e_star[order], E)
    g = grouped_matmul(xs, w_gate.to(dt), offsets)
    u = grouped_matmul(xs, w_up.to(dt), offsets)
    y_s = grouped_matmul(F.silu(g) * u, w_down.to(dt), offsets)
    inv = torch.argsort(order)  # the unsort permutation
    y = y_s[inv] * gate[:, None].to(dt)
    return y.reshape(*lead, D)
