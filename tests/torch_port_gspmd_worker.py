"""The GSPMD worker of ``tests/test_torch_port_gspmd.py``: imports only
the port.

    python tests/torch_port_gspmd_worker.py pod|single IN.npz OUT_DIR

``pod``: a rank of the four-rank job that ``launch_job`` starts (hosts
``localhost-a:2`` and ``localhost-b:2``); ``single``: a one-process job.
Every case's results go to ``OUT_DIR/<mode>.<rank>.npz``; the test holds
them against JAX.  The process group rendezvouses through a file store
in ``OUT_DIR`` (``basics.init(init_method=...)``).
"""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

torch.set_num_threads(1)

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch import checkpoint, optim, parallel, spmd  # noqa: E402
from horovod_tpu_torch.data import DataLoader  # noqa: E402
from horovod_tpu_torch.models import params_from_jax  # noqa: E402
from horovod_tpu_torch.models import transformer as T  # noqa: E402
from horovod_tpu_torch.parallel import P, NamedSharding  # noqa: E402
from horovod_tpu_torch.parallel import sharding as SH  # noqa: E402

MODE, INP, OUT = sys.argv[1], sys.argv[2], sys.argv[3]
D = np.load(INP)
SPEC = json.loads(str(D["spec"]))
RES = {}


def put(key, value):
    if torch.is_tensor(value):
        value = value.detach().float().numpy().copy()
    RES[key] = np.asarray(value)


def error(fn):
    try:
        fn()
    except (ValueError, NameError, NotImplementedError,
            hvd.NotInitializedError) as e:
        return f"{type(e).__name__}: {e}"
    return ""


def cfg(name, impl="reference"):
    return T.TransformerConfig(**SPEC["configs"][name], dtype=torch.float32,
                               attention_impl=impl)


def params(name):
    """The JAX package's weights of config ``name``, f32 on the CPU."""
    tree = {"layers": {}}
    pre = f"p{name}."
    for key in D.files:
        if key.startswith(pre):
            k = key[len(pre):]
            if k.startswith("layers."):
                tree["layers"][k[len("layers."):]] = D[key]
            else:
                tree[k] = D[key]
    return params_from_jax(tree, cfg(name), device="cpu",
                           param_dtype=torch.float32)


def batches(case):
    return [{k: torch.from_numpy(D[f"{case}.{k}.{i}"]).long()
             for k in ("tokens", "targets")}
            for i in range(SPEC["steps"][case])]


def mesh_of(axes):
    return parallel.make_mesh(parallel.MeshSpec(**axes), device="cpu")


def placed(name, mesh, zeros=False):
    """Config ``name``'s weights as DTensors placed by ``param_specs``,
    requiring grad (zeros: the restore templates)."""
    p = params(name)
    if zeros:
        p = SH.tree_map(torch.zeros_like, p)
    p = SH.distribute(p, SH.named_shardings(mesh,
                                            T.param_specs(cfg(name))))
    for _, t in optim.named_parameters(p):
        t.requires_grad_()
    return p


def make_opt(kind, p):
    ts = [t for _, t in optim.named_parameters(p)]
    lr = SPEC["lr"][kind]
    if kind == "sgd":
        return torch.optim.SGD(ts, lr=lr)
    if kind == "adam":
        return torch.optim.Adam(ts, lr=lr)
    return torch.optim.AdamW(ts, lr=lr, weight_decay=1e-4)


def gspmd(name, mesh, p, kind, impl="reference"):
    c = cfg(name, impl)
    opt = make_opt(kind, p)
    step = spmd.make_gspmd_train_step(
        lambda p, b: T.loss_fn(p, b, c), opt, mesh=mesh,
        param_spec=T.param_specs(c), batch_spec=T.batch_specs())
    return step, opt


def adam_template(opt):
    """``opt.state_dict()`` with zero moments (DTensors of the parameters'
    placements) and step 0, for a restore to load into."""
    sd = opt.state_dict()
    ps = [t for g in opt.param_groups for t in g["params"]]
    sd["state"] = {i: {"step": torch.zeros(()),
                       "exp_avg": torch.zeros_like(t),
                       "exp_avg_sq": torch.zeros_like(t)}
                   for i, t in enumerate(ps)}
    return sd


def put_state(prefix, p, opt):
    """The full parameters and Adam moments (collective: every rank)."""
    for n, t in optim.named_parameters(p):
        put(f"{prefix}.param.{n}", SH.full(t))
        for m in ("exp_avg", "exp_avg_sq"):
            put(f"{prefix}.{m}.{n}", SH.full(opt.state[t][m]))


def local_bytes(p, opt):
    """This rank's bytes of parameters and optimizer state."""
    def nbytes(t):
        t = t.to_local() if isinstance(t, DTensor) else t
        return t.numel() * t.element_size()

    n = sum(nbytes(t) for _, t in optim.named_parameters(p))
    for state in opt.state.values():
        n += sum(nbytes(v) for v in state.values() if torch.is_tensor(v))
    return n


def train_case(case, name, axes, kind, impl="reference"):
    """A GSPMD run of ``case``'s batches over ``axes``: its losses and
    the full parameters after."""
    mesh = mesh_of(axes)
    p = placed(name, mesh)
    step, opt = gspmd(name, mesh, p, kind, impl)
    put(f"{case}.losses", [float(step(p, b))
                           for b in batches(case.split("_")[0])])
    for n, t in optim.named_parameters(p):
        put(f"{case}.param.{n}", SH.full(t))
    return p, opt


def pod():
    r = hvd.rank()
    # (f) the basics meshes and the specs' placement.
    put("mesh", hvd.mesh().mesh)
    put("mesh.names", list(hvd.mesh().mesh_dim_names))
    hier = hvd.hierarchical_mesh()
    put("hier", hier.mesh)
    put("hier.names", list(hier.mesh_dim_names))
    put("axis_name", hvd.axis_name())
    x = torch.arange(8 * 4, dtype=torch.float32).reshape(8, 4)
    meshes = {"flat": hvd.mesh(), "hier": hier,
              "dp_fsdp": mesh_of({"dp": 2, "fsdp": 2})}
    for i, (m, spec) in enumerate(SPEC["placements"]):
        sh = NamedSharding(meshes[m], P(*[tuple(e) if isinstance(e, list)
                                          else e for e in spec]))
        put(f"placement.{i}", sh.place(x).to_local())
    put("error.spec", error(lambda: hvd.sharding_for(P("foo"))))
    put("error.order", error(lambda: NamedSharding(
        hier, P(("local", "cross")))))
    put("sharding_for", [str(hvd.sharding_for(P(hvd.AXIS)).placements),
                         str(hvd.sharding_for(P(None, (hvd.CROSS_AXIS,
                                                       hvd.LOCAL_AXIS)),
                                              hierarchical=True)
                             .placements)])
    # pp > 1 and ep > 1: the layer stack sharded over pp and the expert
    # stacks over ep, each gathered on use; (a)'s and (c)'s batches.
    train_case("a_pp", "A", {"dp": 2, "pp": 2}, "sgd")
    train_case("c_ep", "C", {"dp": 2, "ep": 2}, "sgd")
    # (e) worker_index under spmd.run.
    put("error.unbound", error(lambda: hvd.worker_index()))
    out = spmd.run(lambda: hvd.worker_index()[None], in_specs=(),
                   out_specs=P(hvd.AXIS))
    put("worker_index", SH.full(out))
    out = spmd.run(lambda: torch.stack([hvd.worker_index(hvd.CROSS_AXIS),
                                        hvd.worker_index(hvd.LOCAL_AXIS)])
                   [None], in_specs=(),
                   out_specs=P((hvd.CROSS_AXIS, hvd.LOCAL_AXIS)), mesh=hier)
    put("worker_index.hier", SH.full(out))
    # spmd.shard: a plain argument split by its spec, a DTensor
    # redistributed, the output wrapped by its out-spec.
    f = spmd.shard(lambda a, b: (a * 10 + b.sum(), a.shape[0] * 0 + b),
                   in_specs=(P(hvd.AXIS), P()),
                   out_specs=(P(hvd.AXIS), P(hvd.AXIS)))
    a, b = f(x, spmd.init_replicated(torch.ones(3)))
    put("shard.a", SH.full(a))
    put("shard.b", SH.full(b))
    put("shard_batch", spmd.shard_batch({"x": x})["x"].to_local())
    # (g) the DataLoader's pod mode.
    data = {k: D[f"loader.{k}"] for k in ("tokens", "targets")}
    for m in ("dp_tp", "dp_fsdp"):
        sh = NamedSharding(mesh_of(SPEC["loader_meshes"][m]),
                           T.batch_specs()["tokens"])
        loader = DataLoader(data, SPEC["loader_batch"], seed=7, prefetch=1,
                            sharding=sh)
        put(f"loader.{m}.len", len(loader))
        for i, b in zip(range(2), loader):
            put(f"loader.{m}.{i}.local", b["tokens"].to_local())
            put(f"loader.{m}.{i}.full", SH.full(b["tokens"]))
            put(f"loader.{m}.{i}.targets", SH.full(b["targets"]))
    # The loader's DTensor batch fed to the GSPMD step, against the same
    # global batch given plain.
    mesh = sh.mesh
    for feed in ("loader", "plain"):
        p = placed("A", mesh)
        step, _ = gspmd("A", mesh, p, "sgd")
        b = next(iter(DataLoader(data, SPEC["loader_batch"], seed=7,
                                 sharding=sh)))
        if feed == "plain":
            b = {k: SH.full(v) for k, v in b.items()}
        put(f"loader.step.{feed}", float(step(p, b)))
    sh = NamedSharding(mesh_of({"dp": 2, "sp": 2}),
                       T.batch_specs()["tokens"])
    put("error.loader", error(lambda: DataLoader(
        data, SPEC["loader_batch"], sharding=sh)))
    # (a), (c): the GSPMD step against JAX's.
    train_case("a", "A", {"dp": 2, "tp": 2}, "sgd")
    train_case("a_flash", "A", {"dp": 2, "tp": 2}, "sgd", impl="flash")
    train_case("c", "C", {"sp": 2, "tp": 2}, "sgd")
    # (b) fsdp 2 x tp 2 with Adam, its bytes against dp 2 x tp 2's.
    p, opt = train_case("b", "A", {"fsdp": 2, "tp": 2}, "adam")
    put("b.bytes", local_bytes(p, opt))
    # (h) the pod checkpoint, written at dp 2 x tp 2 after step 1 (the
    # Adam run that gives (b) its dp 2 x tp 2 bytes).
    mesh = mesh_of({"dp": 2, "tp": 2})
    p = placed("A", mesh)
    step, opt = gspmd("A", mesh, p, "adam")
    bs = batches("b")
    losses = [float(step(p, bs[0]))]
    path = os.path.join(SPEC["ckpt"], "pod")
    checkpoint.save(path, {"params": p, "opt": opt.state_dict(), "step": 1})
    put_state("saved", p, opt)
    losses.append(float(step(p, bs[1])))
    put("h.losses", losses)
    put("h.bytes", local_bytes(p, opt))
    put("h.spans", checkpoint._spans_processes({"p": p}))
    # Same job, same layout: restored into the live tensors, the step
    # replays.
    back = checkpoint.restore(path, {"params": p, "opt": opt.state_dict(),
                                     "step": 0})
    opt.load_state_dict(back["opt"])
    put("h.same.step", back["step"])
    put("h.same.replay", float(step(p, bs[1])))
    # Another layout: fsdp 2 x tp 2, from zeros.
    mesh = mesh_of({"fsdp": 2, "tp": 2})
    p = placed("A", mesh, zeros=True)
    step, opt = gspmd("A", mesh, p, "adam")
    back = checkpoint.restore(path, {"params": p, "opt": adam_template(opt),
                                     "step": 0})
    opt.load_state_dict(back["opt"])
    put_state("h.fsdp", p, opt)
    put("h.resumed.fsdp", float(step(p, bs[1])))
    # CheckpointManager in pod mode: every rank writes, rank 0 renames.
    mgr = checkpoint.CheckpointManager(os.path.join(SPEC["ckpt"], "mgr"))
    mgr.save(3, {"params": p})
    q = placed("A", mesh, zeros=True)
    got, back = mgr.restore_latest({"params": q})
    put("h.mgr", [got, mgr.all_steps()[0]])
    put("h.mgr.equal", all(torch.equal(SH.full(a), SH.full(b))
                           for (_, a), (_, b) in zip(
                               optim.named_parameters(p),
                               optim.named_parameters(back["params"]))))
    return r


def single():
    for name in ("mesh", "hierarchical_mesh", "axis_name"):
        put(f"error.uninit.{name}", error(getattr(hvd, name)))
    put("error.uninit.sharding_for", error(lambda: hvd.sharding_for(P())))
    put("error.uninit.worker_index", error(hvd.worker_index))
    hvd.init(device="cpu", init_method=f"file://{OUT}/store.single")
    # The environment names two hosts for one rank: not homogeneous.
    put("hier_is_none", hvd.hierarchical_mesh() is None)
    put("error.hier", error(lambda: hvd.sharding_for(P(), hierarchical=True)))
    # (d) size 1: make_gspmd_train_step against make_train_step.
    mesh = mesh_of({})
    for impl in ("reference", "flash"):
        c = cfg("A", impl)
        plain = params("A")
        named = optim.named_parameters(plain)
        for _, t in named:
            t.requires_grad_()
        ref = spmd.make_train_step(lambda p, b: T.loss_fn(p, b, c),
                                   make_opt("adamw", plain))
        p = placed("A", mesh)
        step, _ = gspmd("A", mesh, p, "adamw", impl)
        bs = batches("a")
        put(f"d.{impl}.ref", [float(ref(plain, b)) for b in bs])
        put(f"d.{impl}.gspmd", [float(step(p, b)) for b in bs])
        put(f"d.{impl}.equal", all(
            torch.equal(a.detach(), SH.full(b).detach()) for (_, a), (_, b)
            in zip(named, optim.named_parameters(p))))
    # (h) the four ranks' checkpoint restored in one process.
    p = placed("A", mesh, zeros=True)
    step, opt = gspmd("A", mesh, p, "adam")
    back = checkpoint.restore(os.path.join(SPEC["ckpt"], "pod"),
                              {"params": p, "opt": adam_template(opt),
                               "step": 0})
    opt.load_state_dict(back["opt"])
    put_state("h.single", p, opt)
    put("h.resumed.single", float(step(p, batches("b")[1])))
    # save_async in pod mode (a DTensor tree), read back.
    path = os.path.join(SPEC["ckpt"], "async")
    checkpoint.save_async(path, {"params": p}).wait()
    q = placed("A", mesh, zeros=True)
    back = checkpoint.restore(path, {"params": q})
    put("async.equal", all(torch.equal(SH.full(a), SH.full(b))
                           for (_, a), (_, b) in zip(
                               optim.named_parameters(p),
                               optim.named_parameters(back["params"]))))
    return 0


def main():
    if MODE == "pod":
        hvd.init(device="cpu", init_method=f"file://{OUT}/store.pod")
        r = pod()
    else:
        r = single()
    # Every rank past its last collective before any tears down.
    dist.barrier()
    hvd.shutdown()
    np.savez(os.path.join(OUT, f"{MODE}.{r}.npz"), **RES)


main()
