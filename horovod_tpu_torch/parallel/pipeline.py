"""Pipeline parallelism: microbatched stages over the ranks of a process
group (the ``pp`` axis).

Counterpart of ``horovod_tpu/parallel/pipeline.py``, the same functions
with the same arguments, except that ``axis_name`` (a ``shard_map``
axis) becomes ``group``, the ``pp`` process group (the sequence
parallel functions take theirs the same way):

* :func:`pipeline_apply` / :func:`interleaved_apply`: the GPipe and the
  interleaved (virtual-stage) forward.  Rank ``s`` of the group owns
  stage ``s``; activations move one stage right a tick.
* :func:`pipeline_value_and_grad`: the total loss and THIS stage's
  gradients under ``"gpipe"``, ``"1f1b"`` or ``"interleaved"``, with
  ``loss_params``, ``return_input_grads`` and ``aux_weight`` as in JAX.
* :func:`stack_to_chunks` / :func:`stack_to_stages`: slice a stacked
  ``(n_layers, ...)`` tree into a stage's chunks or stages.

Where JAX writes one ``lax.scan`` over ticks and lets autodiff reverse it,
the port runs a tick loop in Python and writes the reverse by hand: a
stage keeps its own local autograd graph per microbatch (or, in 1F1B,
its input, and replays the stage), and the cotangents move one stage
left a tick by an explicit exchange.  Autograd never spans an exchange:
a fill or drain tick runs no stage (JAX computes it on zeros and masks
the result), so a node of the exchange would be missing from some
ranks' graphs and their peers' reverse shift would wait forever.  Every
rank still makes every tick's exchange, in the same order (zeros where
its stage is idle), so the point-to-point calls always pair up; the
values and gradients are JAX's.

The exchange is one ``batch_isend_irecv`` a tick (the forward
activation to rank ``s + 1``, and in 1F1B the cotangent to ``s - 1`` in
the same batch, around the ring as ``lax.ppermute``); at P = 1 it is the
identity and makes no call.  Gradient ownership follows JAX's: a stage
returns its own parameters' gradients, the loss parameters' on the last
stage (zeros elsewhere), the input gradients on stage 0 (zeros
elsewhere), and the loss summed over the stages on every rank (gathered
and added in stage order, so that it does not depend on the backend's
reduction order).

:func:`_virtual_pipeline` runs every stage of a P-stage pipeline in one
process, the exchange a rotation of a list: what the ring's
``_virtual_ring`` is to ``ring_attention``.  One card runs the P > 1
schedules this way, and the tests hold it to the gloo pipeline bit for
bit.
"""

from __future__ import annotations

from typing import Callable, List

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

__all__ = ["interleaved_apply", "pipeline_apply", "pipeline_value_and_grad",
           "stack_to_chunks", "stack_to_stages"]

_SCHEDULES = ("gpipe", "1f1b", "interleaved")


# --- the stages a process holds, and their exchange --------------------------


class _Stages:
    """The stages this process holds and how they talk: one stage of a
    process group (:meth:`of_group`), or all P stages of a virtual
    pipeline (:meth:`virtual`).  Every method takes and returns one entry
    a held stage, in the order of ``held``."""

    def __init__(self, P: int, held: List[int], group):
        self.P, self.held, self.group = P, held, group

    @classmethod
    def of_group(cls, group) -> "_Stages":
        return cls(dist.get_world_size(group), [dist.get_rank(group)], group)

    @classmethod
    def virtual(cls, P: int) -> "_Stages":
        return cls(P, list(range(P)), None)

    def _peer(self, step: int) -> int:
        r = self.held[0]
        return dist.get_global_rank(self.group, (r + step) % self.P)

    def exchange(self, right, left, like):
        """Stage ``s`` receives what ``s - 1`` sent right and what ``s + 1``
        sent left (around the ring); ``right``/``left`` None for no
        exchange that way.  An idle stage's entry may be None: a real
        stage sends zeros shaped as ``like`` in its place."""
        if self.group is None:
            return (None if right is None else right[-1:] + right[:-1],
                    None if left is None else left[1:] + left[:1])
        if self.P == 1:
            return right, left
        zeros = None
        ops, got = [], []
        for ts, step, tag in ((right, 1, 0), (left, -1, 1)):
            if ts is None:
                got.append(None)
                continue
            t = ts[0]
            if t is None:
                zeros = torch.zeros_like(like) if zeros is None else zeros
                t = zeros
            recv = torch.empty_like(like)
            ops.append(dist.P2POp(dist.isend, t.contiguous(),
                                  self._peer(step), self.group, tag=tag))
            ops.append(dist.P2POp(dist.irecv, recv, self._peer(-step),
                                  self.group, tag=tag))
            got.append([recv])
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return got[0], got[1]

    def broadcast(self, ts, src: int, like):
        """Every held stage gets stage ``src``'s tensor."""
        if self.group is None:
            return [ts[src]] * self.P
        if self.P == 1:
            return ts
        t = ts[0] if self.held[0] == src else torch.empty_like(like)
        dist.broadcast(t, dist.get_global_rank(self.group, src),
                       group=self.group)
        return [t]

    def gather(self, ts):
        """Every stage's tensor (equal shapes), in stage order."""
        if self.group is None or self.P == 1:
            return list(ts)
        parts = [torch.empty_like(ts[0]) for _ in range(self.P)]
        dist.all_gather(parts, ts[0].contiguous(), group=self.group)
        return parts

    def sum(self, ts):
        """The sum over the stages of a scalar each, added in stage
        order (the same bits however many stages a process holds)."""
        parts = self.gather([t.reshape(1) for t in ts])
        total = parts[0]
        for t in parts[1:]:
            total = total + t
        return total.reshape(())


# --- the forward and reverse waves -------------------------------------------


def _chunk_of(k: int, v: int, P: int):
    """Local step ``k`` of a stage -> ``(chunk, microbatch)``: Megatron's
    interleaved order, microbatches in groups of P (``v = 1``: GPipe,
    microbatch ``k``)."""
    within = k % (v * P)
    return within // P, (k // (v * P)) * P + within % P


def _leaves(tree):
    """``tree``'s tensors as new leaves that require grad (no copy)."""
    return pytree.tree_map(lambda t: t.detach().requires_grad_(), tree)


def _add(acc, gs):
    """Accumulate a list of gradients (None: no contribution)."""
    if acc is None:
        return list(gs)
    return [a if g is None else g if a is None else a + g
            for a, g in zip(acc, gs)]


def _grads(outs, gouts, inputs):
    """``torch.autograd.grad`` of ``outs`` against cotangents ``gouts``;
    an input the outputs do not reach gets None."""
    return torch.autograd.grad(outs, inputs, gouts, allow_unused=True)


class _Forward:
    """The forward wave of GPipe (``v = 1``) and of the interleaved
    schedule (``v > 1``): ``M * v + P - 1`` ticks; at tick ``t`` stage
    ``s`` runs local step ``k = t - s`` (chunk and microbatch by
    :func:`_chunk_of`) on the fresh microbatch (stage 0, chunk 0) or on
    what its left neighbour sent last tick.  With ``keep``, each step's
    input is a leaf and its local graph is kept for :meth:`backward`."""

    def __init__(self, st, stage_fn, chunks, mbs, v, aux, keep, input_grad):
        self.st, self.v = st, v
        self.M, self.like = mbs.shape[0], mbs[0]
        P, M = st.P, self.M
        n = len(st.held)
        self.chunks = [[_leaves(c) for c in cs] for cs in chunks] if keep \
            else chunks
        self.outs = [None] * M  # the last stage's, by microbatch
        self.aux_sum = [torch.zeros((), dtype=torch.float32,
                                    device=mbs.device) for _ in range(n)]
        self.recs = [{} for _ in range(n)]
        bufs = [None] * n
        T = M * v + P - 1
        for t in range(T):
            ys = []
            for i, s in enumerate(st.held):
                k = t - s
                if not 0 <= k < M * v:
                    ys.append(None)
                    continue
                c, m = _chunk_of(k, v, P)
                fresh = s == 0 and c == 0
                x = mbs[m] if fresh else bufs[i]
                if keep:
                    x = x.detach().requires_grad_(input_grad or not fresh)
                with torch.set_grad_enabled(keep):
                    out = stage_fn(self.chunks[i][c], x)
                y, a = out if aux else (out, None)
                if aux:
                    self.aux_sum[i] = self.aux_sum[i] + a.detach()
                if keep:
                    self.recs[i][k] = (x, y, a)
                if s == P - 1 and c == v - 1:
                    self.outs[m] = y.detach()
                ys.append(y.detach())
            if t < T - 1:
                bufs, _ = st.exchange(ys, None, self.like)

    def backward(self, grad_outs, g_aux):
        """The reverse wave: ticks in reverse, stage ``s`` backpropagates
        local step ``t - s`` from the cotangent its right neighbour sent
        (or, for the last chunk, ``grad_outs[m]``), plus ``g_aux`` for the
        step's aux; the input's cotangent goes left.  Returns, per held
        stage, its chunks' gradients (lists in ``pytree`` leaf order) and
        the input gradients by microbatch (stage 0's, None elsewhere)."""
        st, v, M = self.st, self.v, self.M
        P, n = st.P, len(st.held)
        gacc = [[None] * v for _ in range(n)]
        xg = [None] * M
        gin = [None] * n
        T = M * v + P - 1
        for t in reversed(range(T)):
            gxs = []
            for i, s in enumerate(st.held):
                k = t - s
                if not 0 <= k < M * v:
                    gxs.append(None)
                    continue
                c, m = _chunk_of(k, v, P)
                x, y, a = self.recs[i].pop(k)
                gy = grad_outs[m] if (s == P - 1 and c == v - 1) else gin[i]
                outs, gouts = [y], [torch.zeros_like(y) if gy is None else gy]
                if a is not None and g_aux is not None:
                    outs.append(a)
                    gouts.append(g_aux)
                leaves = pytree.tree_leaves(self.chunks[i][c])
                inputs = leaves + ([x] if x.requires_grad else [])
                gs = _grads(outs, gouts, inputs)
                gacc[i][c] = _add(gacc[i][c], gs[:len(leaves)])
                gx = gs[len(leaves)] if x.requires_grad else None
                if s == 0 and c == 0:
                    xg[m] = gx
                    gx = None
                gxs.append(gx)
            if t > 0:
                _, gin = st.exchange(None, gxs, self.like)
        return gacc, xg


def _one_f_one_b(st, stage_fn, chunks, mbs, targets, loss_fn, lp, aux_w,
                 input_grad):
    """JAX's 1F1B in one loop of ``M + 2P - 2`` ticks: at tick ``t`` stage
    ``s`` runs the forward of microbatch ``t - s`` without a graph (the
    last stage skips it: its output would go nowhere) and keeps its input
    in a ring of ``R = min(2P - 1, M)``, and the backward of microbatch
    ``t - (2P - 2 - s)``: the stage replayed with a graph from the kept
    input, backpropagated from the cotangent its right neighbour sent
    (the last stage: from its own loss) plus ``aux_w`` for the aux.  One
    exchange a tick carries both waves.  Returns per held stage
    ``(contribution to the loss, chunk gradients, loss-parameter
    gradients (last stage) or None, input gradients (stage 0) or
    None)``."""
    P, M = st.P, mbs.shape[0]
    R, T = min(2 * P - 1, M), M + 2 * P - 2
    n = len(st.held)
    aux = aux_w is not None
    leaves = [_leaves(cs[0]) for cs in chunks]
    lp_leaves = _leaves(lp) if lp is not None else None
    ring = [[None] * R for _ in range(n)]
    dev = mbs.device
    gacc = [None] * n
    lpacc, lacc = None, torch.zeros((), dtype=torch.float32, device=dev)
    auxacc = [torch.zeros((), dtype=torch.float32, device=dev)
              for _ in range(n)]
    xg = [None] * M
    fwd_in, bwd_in = [None] * n, [None] * n
    g_aux = (torch.tensor(float(aux_w), dtype=torch.float32, device=dev)
             if aux else None)
    for t in range(T):
        ys, gxs = [], []
        for i, s in enumerate(st.held):
            m_f = t - s
            y = None
            if 0 <= m_f < M:
                x_in = mbs[m_f] if s == 0 else fwd_in[i]
                ring[i][m_f % R] = x_in
                if s < P - 1:
                    with torch.no_grad():
                        out = stage_fn(chunks[i][0], x_in)
                    y = out[0] if aux else out
            ys.append(y)
            m_b = t - (2 * P - 2 - s)
            gx = None
            if 0 <= m_b < M:
                x_b = ring[i][m_b % R].detach().requires_grad_(
                    s > 0 or input_grad)
                ps = pytree.tree_leaves(leaves[i])
                extra = []
                with torch.enable_grad():
                    out = stage_fn(leaves[i], x_b)
                    y_b, a_b = out if aux else (out, None)
                    if s == P - 1:
                        loss_b = loss_fn(lp_leaves, y_b, targets[m_b])
                        outs, gouts = [loss_b], [torch.ones_like(loss_b)]
                        extra = (pytree.tree_leaves(lp_leaves)
                                 if lp is not None else [])
                        lacc = lacc + loss_b.detach()
                    else:
                        outs, gouts = [y_b], [bwd_in[i]]
                    if aux:
                        outs.append(a_b)
                        gouts.append(g_aux)
                        auxacc[i] = auxacc[i] + a_b.detach()
                inputs = ps + extra + ([x_b] if x_b.requires_grad else [])
                gs = _grads(outs, gouts, inputs)
                gacc[i] = _add(gacc[i], gs[:len(ps)])
                if extra:
                    lpacc = _add(lpacc, gs[len(ps):len(ps) + len(extra)])
                if x_b.requires_grad:
                    gx = gs[-1]
                if s == 0:
                    xg[m_b] = gx
                    gx = None
            gxs.append(gx)
        if t < T - 1:
            fwd_in, bwd_in = st.exchange(ys, gxs, mbs[0])
    return _results(st, lacc, g_aux, auxacc, [[g] for g in gacc], lpacc,
                    xg if input_grad else None)


def _results(st, lacc, g_aux, aux_sums, gaccs, lpacc, xg):
    """Per held stage ``(its contribution to the loss: the microbatch
    losses on the last stage, plus its own aux sum times the weight; its
    chunks' gradients; the loss parameters' gradients, the last stage's,
    else None; the input gradients, stage 0's, else None)``."""
    res = []
    for i, s in enumerate(st.held):
        contrib = lacc if s == st.P - 1 else torch.zeros_like(lacc)
        if g_aux is not None:
            contrib = contrib + g_aux * aux_sums[i]
        res.append((contrib, gaccs[i], lpacc if s == st.P - 1 else None,
                    xg if s == 0 else None))
    return res


def _gpipe_or_interleaved(st, stage_fn, chunks, mbs, targets, loss_fn, lp,
                          aux_w, input_grad, v):
    """GPipe (``v = 1``) or the interleaved schedule: the forward wave
    with graphs kept, the loss of each microbatch on the last stage as
    its output arrives in order, then the reverse wave.  Returns what
    :func:`_one_f_one_b` returns."""
    M, dev = mbs.shape[0], mbs.device
    fw = _Forward(st, stage_fn, chunks, mbs, v, aux_w is not None, True,
                  input_grad)
    lacc = torch.zeros((), dtype=torch.float32, device=dev)
    lpacc, gy = None, [None] * M
    if st.P - 1 in st.held:
        lp_leaves = _leaves(lp) if lp is not None else None
        extra = pytree.tree_leaves(lp_leaves) if lp is not None else []
        for m in range(M):
            y = fw.outs[m].requires_grad_()
            with torch.enable_grad():
                loss_m = loss_fn(lp_leaves, y, targets[m])
            gs = _grads([loss_m], [torch.ones_like(loss_m)], extra + [y])
            lpacc = _add(lpacc, gs[:-1]) if extra else None
            gy[m] = gs[-1]
            lacc = lacc + loss_m.detach()
    g_aux = (torch.tensor(float(aux_w), dtype=torch.float32, device=dev)
             if aux_w is not None else None)
    gacc, xg = fw.backward(gy, g_aux)
    return _results(st, lacc, g_aux, fw.aux_sum, gacc, lpacc,
                    xg if input_grad else None)


def _check_interleaved(M: int, P: int, v: int) -> None:
    if v < 1:
        raise ValueError(f"n_virtual must be >= 1, got {v}")
    if M % P:
        raise ValueError(
            f"interleaved schedule needs n_microbatches ({M}) divisible by "
            f"the pipeline width ({P}) — microbatches run in groups of P")


def _run(st, stage_fn, chunks, mbs, targets, loss_fn, *, schedule, lp,
         aux_w, input_grad, v):
    """One schedule on the held stages; ``chunks`` per held stage, a
    list of its chunks' parameter trees (one but for ``interleaved``);
    ``loss_fn(lp, y, target)``.  See :func:`_one_f_one_b` for the
    result."""
    if schedule not in _SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    if schedule == "1f1b":
        return _one_f_one_b(st, stage_fn, chunks, mbs, targets, loss_fn, lp,
                            aux_w, input_grad)
    if schedule == "interleaved":
        _check_interleaved(mbs.shape[0], st.P, v)
    return _gpipe_or_interleaved(st, stage_fn, chunks, mbs, targets, loss_fn,
                                 lp, aux_w, input_grad,
                                 v if schedule == "interleaved" else 1)


def _chunks(stage_params, schedule: str, v: int):
    """A stage's parameters -> the list of its chunks' trees (the leading
    ``n_virtual`` axis split for ``interleaved``)."""
    if schedule != "interleaved":
        return [stage_params]
    return [pytree.tree_map(lambda t: t[c], stage_params) for c in range(v)]


def _value_and_grad(st, stage_fn, stage_params, microbatches, targets,
                    loss_fn, *, schedule, loss_params, return_input_grads,
                    aux_weight, n_virtual):
    """:func:`pipeline_value_and_grad` for every held stage
    (``stage_params`` a list, one tree a held stage) -> a list of its
    results."""
    v = int(n_virtual)
    has_lp = loss_params is not None

    def lf(lp, y, t):
        return loss_fn(lp, y, t) if has_lp else loss_fn(y, t)

    res = _run(st, stage_fn, [_chunks(p, schedule, v) for p in stage_params],
               microbatches, targets, lf, schedule=schedule, lp=loss_params,
               aux_w=aux_weight, input_grad=return_input_grads, v=v)
    loss = st.sum([r[0] for r in res])
    out = []
    for p, (_, cgrads, lpg, xg) in zip(stage_params, res):
        chunk_trees = _chunks(p, schedule, v)
        trees = [pytree.tree_unflatten(
            [torch.zeros_like(t) if g is None else g for g, t in zip(
                gs or [None] * len(pytree.tree_leaves(c)),
                pytree.tree_leaves(c))],
            pytree.tree_structure(c)) for gs, c in zip(cgrads, chunk_trees)]
        grads = (pytree.tree_map(lambda *cs: torch.stack(cs), *trees)
                 if schedule == "interleaved" else trees[0])
        if not has_lp and not return_input_grads:
            out.append((loss, grads))
            continue
        extras = {}
        if has_lp:
            extras["loss_param_grads"] = (
                pytree.tree_map(torch.zeros_like, loss_params) if lpg is None
                else pytree.tree_unflatten(lpg,
                                           pytree.tree_structure(loss_params)))
        if return_input_grads:
            extras["input_grads"] = (torch.zeros_like(microbatches)
                                     if xg is None else torch.stack(xg))
        out.append((loss, grads, extras))
    return out


# --- the public functions ----------------------------------------------------


class _ApplyFn(torch.autograd.Function):
    """:func:`pipeline_apply` / :func:`interleaved_apply` as one autograd
    node: the forward wave in ``forward``, the reverse wave in
    ``backward``.  The output is the last stage's, broadcast to every
    stage; its backward takes each stage's own cotangent only (the last
    stage's reaches the stages, as the cotangent of JAX's replicated
    output does), so every rank must backpropagate through it, as every
    rank's exchange waits on its neighbours'."""

    @staticmethod
    def forward(ctx, st, stage_fn, treedef, schedule, v, aux, mbs, *flat):
        params = pytree.tree_unflatten(list(flat), treedef)
        keep = any(ctx.needs_input_grad[6:])
        fw = _Forward(st, stage_fn, [_chunks(params, schedule, v)], mbs, v,
                      aux, keep, ctx.needs_input_grad[6])
        last = st.held[0] == st.P - 1
        out = st.broadcast([torch.stack(fw.outs) if last else None],
                           st.P - 1, mbs)[0]
        ctx.fw, ctx.stacked, ctx.n = fw, schedule == "interleaved", len(flat)
        if aux:
            return out, fw.aux_sum[0]
        return out

    @staticmethod
    def backward(ctx, g_out, g_aux=None):
        fw = ctx.fw
        st = fw.st
        last = st.held[0] == st.P - 1
        gacc, xg = fw.backward(list(g_out.unbind(0)) if last
                               else [None] * fw.M, g_aux)
        per_chunk = [[torch.zeros_like(t) if g is None else g for g, t in
                      zip(gs or [None] * ctx.n,
                          pytree.tree_leaves(fw.chunks[0][c]))]
                     for c, gs in enumerate(gacc[0])]
        flat = ([torch.stack(gs) for gs in zip(*per_chunk)] if ctx.stacked
                else per_chunk[0])
        gmbs = None
        if ctx.needs_input_grad[6]:
            gmbs = (torch.stack(xg) if st.held[0] == 0
                    else torch.zeros_like(g_out))
        del ctx.fw
        return (None, None, None, None, None, None, gmbs, *flat)


def pipeline_apply(stage_fn: Callable, stage_params, microbatches, *,
                   group, stage_aux: bool = False):
    """Run ``microbatches`` through the P pipeline stages of ``group``.

    ``stage_fn(stage_params, x) -> y`` applies THIS rank's stage (rank
    ``s`` of the group owns stage ``s``) to one microbatch and preserves
    its shape; with ``stage_aux`` it returns ``(y, aux)``, a scalar
    side-loss summed over this stage's real microbatches.
    ``microbatches``: ``(M, mb, ...)``, the same on every rank of the
    group.  Returns ``(M, mb, ...)``, the LAST stage's outputs, on every
    rank; with ``stage_aux``, ``(outputs, aux_local)``, this stage's aux
    sum (summed over the group, the total).

    Differentiable in ``stage_params`` and ``microbatches`` (one
    autograd node whose backward runs the reverse schedule): each rank
    gets its own stage's parameter gradients, and stage 0 the input
    gradients (zeros elsewhere).  The outputs' cotangent is taken on the
    last stage, the aux's on each stage; every rank of the group must
    backpropagate through the result."""
    return _apply(_Stages.of_group(group), stage_fn, stage_params,
                  microbatches, "gpipe", 1, stage_aux)


def _apply(st, stage_fn, params, microbatches, schedule, v, aux):
    flat, treedef = pytree.tree_flatten(params)
    return _ApplyFn.apply(st, stage_fn, treedef, schedule, v, aux,
                          microbatches, *flat)


def interleaved_apply(stage_fn: Callable, chunk_params, microbatches, *,
                      group, n_virtual: int, stage_aux: bool = False):
    """The forward of the INTERLEAVED (virtual-stage) pipeline: the layer
    stack splits into ``n_virtual * P`` chunks laid round-robin on the P
    stages (chunk ``j`` on stage ``j % P``), so the fill and drain bubble
    shrinks to chunk ticks: ``(P - 1) / (M * v + P - 1)``.  Microbatches
    run in groups of P (``M % P == 0``): stage ``s``'s local step ``k``
    runs chunk ``(k mod vP) // P`` on microbatch ``(k // vP) * P + k mod
    P``, and every hand-off lands one tick later on the right neighbour.

    ``chunk_params``: this stage's chunks stacked on a leading
    ``n_virtual`` axis (chunk ``c`` is global chunk ``c * P + s``;
    :func:`stack_to_chunks`).  Otherwise as :func:`pipeline_apply`,
    differentiable the same way."""
    v = int(n_virtual)
    st = _Stages.of_group(group)
    _check_interleaved(microbatches.shape[0], st.P, v)
    return _apply(st, stage_fn, chunk_params, microbatches, "interleaved",
                  v, stage_aux)


def pipeline_value_and_grad(stage_fn: Callable, stage_params, microbatches,
                            targets, loss_fn: Callable, *, group,
                            schedule: str = "gpipe", loss_params=None,
                            return_input_grads: bool = False,
                            aux_weight=None, n_virtual: int = 2):
    """A microbatched pipeline training step on THIS rank's stage: the
    total loss and this stage's parameter gradients.

    ``stage_fn`` and ``microbatches`` as :func:`pipeline_apply`;
    ``targets``: ``(M, ...)`` per-microbatch targets; ``loss_fn(y,
    target) -> scalar`` (``loss_fn(loss_params, y, target)`` with
    ``loss_params``), summed over the microbatches.  ``schedule``:

    * ``"gpipe"``: the forward of every microbatch, then the reverse;
      memory grows with M (each microbatch's graph is kept).
    * ``"1f1b"``: one loop of ``M + 2P - 2`` ticks, a forward and a
      backward wave; each stage keeps at most ``min(2P - 1, M)`` stage
      inputs and replays the stage at its backward, so memory does not
      grow with M.
    * ``"interleaved"``: ``stage_params`` stacked on a leading
      ``n_virtual`` axis, ``stage_fn`` applying one chunk
      (:func:`interleaved_apply`'s schedule, then its reverse).

    ``loss_params``: the loss's own parameters; their gradients land on
    the last stage (zeros elsewhere).  ``return_input_grads``: also
    ``d loss / d microbatches`` on stage 0 (zeros elsewhere).
    ``aux_weight``: ``stage_fn`` returns ``(y, aux)`` and the loss
    becomes ``sum(loss_fn) + aux_weight * sum(aux)`` over every stage and
    microbatch (in 1F1B the aux rides the backward's replay).

    Returns ``(loss, stage_grads)``, the loss the same on every rank, or
    ``(loss, stage_grads, extras)`` with ``loss_param_grads`` and/or
    ``input_grads``.  Sum a gradient that two stages share over the
    group outside."""
    return _value_and_grad(
        _Stages.of_group(group), stage_fn, [stage_params], microbatches,
        targets, loss_fn, schedule=schedule, loss_params=loss_params,
        return_input_grads=return_input_grads, aux_weight=aux_weight,
        n_virtual=n_virtual)[0]


def _virtual_pipeline(stage_fn: Callable, stage_params: list, microbatches,
                      targets, loss_fn: Callable, *, schedule: str = "gpipe",
                      loss_params=None, return_input_grads: bool = False,
                      aux_weight=None, n_virtual: int = 2) -> list:
    """Every stage of a ``P = len(stage_params)``-stage pipeline in this
    process, the exchange a rotation of a list -> each stage's
    :func:`pipeline_value_and_grad` result, equal bit for bit to what
    rank ``s`` of a P-rank group returns."""
    return _value_and_grad(
        _Stages.virtual(len(stage_params)), stage_fn, list(stage_params),
        microbatches, targets, loss_fn, schedule=schedule,
        loss_params=loss_params, return_input_grads=return_input_grads,
        aux_weight=aux_weight, n_virtual=n_virtual)


def stack_to_chunks(stacked, n_stages: int, n_virtual: int,
                    stage_index: int):
    """Slice a ``(n_layers, ...)`` stacked tree into stage
    ``stage_index``'s ``(n_virtual, layers_per_chunk, ...)`` interleaved
    chunks (chunk ``c`` is global chunk ``c * n_stages + stage_index``)."""
    L = n_stages * n_virtual

    def slice_chunks(leaf):
        n = leaf.shape[0]
        if n % L:
            raise ValueError(
                f"{n} layers do not divide into {L} interleaved chunks")
        per = n // L
        return torch.stack([leaf.narrow(0, (c * n_stages + stage_index) * per,
                                        per) for c in range(n_virtual)])

    return pytree.tree_map(slice_chunks, stacked)


def stack_to_stages(stacked, n_stages: int):
    """Reshape a ``(n_layers, ...)`` stacked tree to ``(n_stages,
    n_layers / n_stages, ...)``: stage ``s`` takes row ``s``."""
    def reshape(leaf):
        n = leaf.shape[0]
        if n % n_stages:
            raise ValueError(
                f"{n} layers do not divide into {n_stages} pipeline stages")
        return leaf.reshape(n_stages, n // n_stages, *leaf.shape[1:])

    return pytree.tree_map(reshape, stacked)
