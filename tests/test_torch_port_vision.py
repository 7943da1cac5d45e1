"""horovod_tpu_torch's vision models and MLP against the JAX package's.

The flax models (``horovod_tpu/models/resnet.py``, ``inception.py``) and
the port's get the same variables — flax's own, loaded through
``vision_from_flax`` — and the same seeded numpy inputs.  The blocks'
zero-initialised last BatchNorm scales are set to U(0.1, 0.3) first, so
that the residual branches take part in the forward and the gradients,
and the running statistics are randomised for the eval-mode checks.

Tolerances, each relative to the largest magnitude of the tensor compared:

* f32, 1e-4 (``F32``): XLA and PyTorch sum in different orders.
* f32 gradients of a whole ResNet in train mode, 1e-3 (``F32_TRAIN_GRAD``).
  Train mode normalises with the batch's statistics, and the backward
  through a BatchNorm over few values amplifies the rounding of the
  forward (measured 1.2e-4 for ResNet-50 at 64×64, batch 2); where a
  pre-activation lies within that rounding of zero, the two packages'
  relus disagree on it, and a gradient summed over few positions then
  differs by a whole position's share (4e-2 at 64×64, batch 4; with
  SiLU for relu in both packages the same case agrees to 1.6e-4).  At
  32×32 and batch 2 the last stage normalises 2 values a channel and the
  two packages' f32 logits differ by up to 1e-2.  So train mode is held
  at 64×64 and batch 2; eval mode, which normalises with the running
  statistics, at 32×32 and 1e-4; and each residual block alone, where no
  relu decision is near its edge, at 1e-5 (``BLOCK``).  The batch
  statistics after a step are held at 1e-5 (``STATS``).
* bf16, 5e-2 (``BF16``): each op rounds to bf16 (step 2^-8 = 3.9e-3 of a
  value), at places that differ between XLA's fusions and PyTorch.

Each test runs on the CPU in one thread.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from horovod_tpu.models import inception as JI
from horovod_tpu.models import mlp as JM
from horovod_tpu.models import resnet as JR
from horovod_tpu_torch import basics, optim, spmd
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import inception as I
from horovod_tpu_torch.models import mlp as M
from horovod_tpu_torch.models import resnet as R
from horovod_tpu_torch.models import vision_from_flax, vision_layers

F32, F32_TRAIN_GRAD, BLOCK, BF16, STATS = 1e-4, 1e-3, 1e-5, 5e-2, 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want, tol, what=""):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: relative error {err:.3e} > {tol:.0e}"


def _variables(jmodel, x, seed=0):
    """flax's own variables, the zero-initialised scales set nonzero and
    the running statistics randomised, as numpy."""
    v = jax.jit(jmodel.init, static_argnames="train")(
        jax.random.PRNGKey(seed), jnp.asarray(x), train=True)
    rng = np.random.RandomState(seed + 7)

    def params(path, a):
        a = np.asarray(a, np.float32)
        if path[-1].key == "scale" and not a.any():
            return rng.uniform(0.1, 0.3, a.shape).astype(np.float32)
        return a

    def stats(path, a):
        if path[-1].key == "mean":
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)

    return {"params": jax.tree_util.tree_map_with_path(params, v["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(
                stats, v["batch_stats"])}


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _port_leaves(model):
    """flax path -> (the port's tensor, its module kind)."""
    out = {}
    for name, mod in model.named_modules():
        for attr, (col, leaf) in convert._LEAVES.get(type(mod), {}).items():
            out[(col,) + tuple(name.split(".")) + (leaf,)] = (
                getattr(mod, attr), type(mod))
    return out


def _flat(tree, col):
    return {(col,) + tuple(p.key for p in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _flax_run(jmodel, v, x, y, train, jit=True):
    """flax logits, loss, parameter gradients and (train) new stats;
    ``jit=False`` runs flax op by op."""
    def loss_fn(p):
        if train:
            logits, new = jmodel.apply(
                {"params": p, "batch_stats": v["batch_stats"]},
                jnp.asarray(x), train=True, mutable=["batch_stats"])
        else:
            logits = jmodel.apply({"params": p,
                                   "batch_stats": v["batch_stats"]},
                                  jnp.asarray(x), train=False)
            new = {"batch_stats": v["batch_stats"]}
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()
        return loss, (logits, new["batch_stats"])

    grad_fn = jax.value_and_grad(loss_fn, has_aux=True)
    (loss, (logits, stats)), grads = (jax.jit(grad_fn) if jit
                                      else grad_fn)(v["params"])
    return logits, loss, _flat(grads, "params"), _flat(stats, "batch_stats")


def _port_run(model, x, y, train):
    model.train(train)
    model.zero_grad(set_to_none=True)
    logits = model(_nchw(x))
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    return logits, loss


def _check_against_flax(jmodel, v, model, x, y, train, tol, grad_tol,
                        stats_tol, jit=True):
    """Logits, loss, every gradient (by path) and, in train mode, the
    batch statistics after the forward, against flax."""
    logits_j, loss_j, grads_j, stats_j = _flax_run(jmodel, v, x, y, train,
                                                   jit)
    logits_t, loss_t = _port_run(model, x, y, train)
    _close(logits_t, logits_j, tol, "logits")
    _close(loss_t, loss_j, tol, "loss")
    leaves = _port_leaves(model)
    assert {k for k in leaves if k[0] == "params"} == set(grads_j)
    for key, g in grads_j.items() if grad_tol is not None else ():
        t, kind = leaves[key]
        _close(t.grad, convert._flax_layout(g, kind), grad_tol,
               "/".join(key))
    for key, s in stats_j.items():
        _close(leaves[key][0], s, stats_tol, "/".join(key))


def _images(size, batch, seed=0, classes=10):
    rng = np.random.RandomState(seed)
    return (rng.rand(batch, size, size, 3).astype(np.float32),
            rng.randint(0, classes, (batch,)).astype(np.int64))


# --- ResNet -------------------------------------------------------------------


def _resnet_pair(name, stem, x, jdtype=jnp.float32, tdtype=torch.float32):
    jmodel = JR.MODELS[name](num_classes=10, num_filters=8, dtype=jdtype,
                             stem=stem)
    v = _variables(jmodel, x)
    model = R.create(name, 10, tdtype, stem, num_filters=8, device="cpu")
    vision_from_flax(v, model, device="cpu")
    return jmodel, v, model


@pytest.mark.parametrize("stem", ["conv7", "s2d"])
@pytest.mark.parametrize("name", ["ResNet18", "ResNet50"])
def test_resnet_train_mode_matches_flax(name, stem):
    """Train mode at 64×64, batch 2: logits, loss, every gradient, and the
    batch statistics the forward moved."""
    x, y = _images(64, 2)
    jmodel, v, model = _resnet_pair(name, stem, x)
    _check_against_flax(jmodel, v, model, x, y, True, F32, F32_TRAIN_GRAD,
                        STATS)


@pytest.mark.parametrize("stem", ["conv7", "s2d"])
@pytest.mark.parametrize("name", ["ResNet18", "ResNet50"])
def test_resnet_eval_mode_matches_flax(name, stem):
    """Eval mode at 32×32, batch 2, on randomised running statistics,
    which it must use and leave as they are."""
    x, y = _images(32, 2)
    jmodel, v, model = _resnet_pair(name, stem, x)
    _check_against_flax(jmodel, v, model, x, y, False, F32, F32, 0.0)


@pytest.mark.parametrize("stem", ["conv7", "s2d"])
def test_resnet50_bf16_matches_flax(stem):
    """bf16 compute over f32 parameters in both.  Eval mode at 32×32:
    logits, loss and every gradient.  Train mode at 64×64: logits, loss
    and the batch statistics; its gradients are not held, because bf16
    rounding moves pre-activations across the relu's edge and the
    backward through BatchNorms over few values amplifies it (measured:
    the two packages' train-mode bf16 gradients differ by up to their own
    size).  flax runs op by op here, rounding each op's result to bf16
    as PyTorch's eager ops do; jitted, XLA keeps f32 inside its fusions
    and the eval-mode gradients differ by up to 8e-2."""
    for train, size in ((False, 32), (True, 64)):
        x, y = _images(size, 2)
        jmodel, v, model = _resnet_pair("ResNet50", stem, x, jnp.bfloat16,
                                        torch.bfloat16)
        _check_against_flax(jmodel, v, model, x, y, train, BF16,
                            None if train else BF16, BF16, jit=False)


@pytest.mark.parametrize("size,stride,cin", [(8, 1, 32), (8, 2, 16),
                                             (7, 2, 16), (4, 2, 32)])
@pytest.mark.parametrize("block", ["ResNetBlock", "BottleneckBlock"])
def test_residual_block_matches_flax(block, size, stride, cin):
    """One residual block, train mode, batch 4 (v1.5: the stride on the
    3×3; ``conv_proj``/``norm_proj`` where the shape changes): output,
    the input's gradient and every parameter's gradient of ``sum(out *
    w)``, and the moved statistics, f32 within 1e-5."""
    from functools import partial

    import flax.linen as fnn

    rng = np.random.RandomState(2)
    x = rng.randn(4, size, size, cin).astype(np.float32)
    conv = partial(fnn.Conv, use_bias=False, dtype=jnp.float32)
    norm = partial(fnn.BatchNorm, use_running_average=False, momentum=0.9,
                   epsilon=1e-5, dtype=jnp.float32)
    jblock = getattr(JR, block)(8, conv=conv, norm=norm, act=fnn.relu,
                                strides=(stride, stride))

    class Wrap:
        init = staticmethod(lambda rng, x, train=True: jblock.init(rng, x))

    v = _variables(Wrap, x)

    def f(p, x):
        return jblock.apply({"params": p, "batch_stats": v["batch_stats"]},
                            x, mutable=["batch_stats"])

    out_j, new = f(v["params"], jnp.asarray(x))
    w = rng.randn(*out_j.shape).astype(np.float32)
    gp, gx = jax.grad(lambda p, x: jnp.sum(f(p, x)[0] * w), argnums=(0, 1))(
        v["params"], jnp.asarray(x))
    tblock = getattr(R, block)(cin, 8, stride, torch.float32)
    vision_from_flax(v, tblock, device="cpu")
    tx = _nchw(x).requires_grad_()
    out_t = tblock(tx)
    (out_t * _nchw(w)).sum().backward()
    _close(out_t.permute(0, 2, 3, 1), out_j, BLOCK, "out")
    _close(tx.grad.permute(0, 2, 3, 1), gx, BLOCK, "dx")
    leaves = _port_leaves(tblock)
    for key, g in _flat(gp, "params").items():
        t, kind = leaves[key]
        _close(t.grad, convert._flax_layout(g, kind), BLOCK, "/".join(key))
    for key, s in _flat(new["batch_stats"], "batch_stats").items():
        _close(leaves[key][0], s, STATS, "/".join(key))


def test_space_to_depth_channel_order():
    """The s2d stem's 4C channels in the JAX NHWC order (dy, dx, c): the
    port's conv on its space-to-depth input equals flax's conv on the JAX
    reshape, bit for bit in the input it sees."""
    x, _ = _images(8, 2)
    B, H, W, C = x.shape
    want = x.reshape(B, H // 2, 2, W // 2, 2, C).transpose(
        0, 1, 3, 2, 4, 5).reshape(B, H // 2, W // 2, 4 * C)
    model = R.create("ResNet18", 10, torch.float32, "s2d", num_filters=8,
                     device="cpu")
    seen = {}
    model.conv_init.register_forward_pre_hook(
        lambda m, args: seen.setdefault("x", args[0]))
    model.eval()
    model(_nchw(x))
    np.testing.assert_array_equal(seen["x"].permute(0, 2, 3, 1).numpy(),
                                  want)


@pytest.mark.parametrize("size", [7, 8])
@pytest.mark.parametrize("kernel,strides", [(3, 2), (1, 2), (3, 1), (4, 1)])
def test_conv_same_padding_matches_flax(size, kernel, strides):
    """flax "SAME" padding, asymmetric where the stride is 2 on an even
    input (and for an even kernel), exact at f32 within 1e-5."""
    import flax.linen as fnn

    rng = np.random.RandomState(0)
    x = rng.randn(2, size, size, 5).astype(np.float32)
    jconv = fnn.Conv(6, (kernel, kernel), (strides, strides), use_bias=False,
                     dtype=jnp.float32)
    v = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jconv.apply(v, jnp.asarray(x)))
    conv = vision_layers.Conv(5, 6, kernel, strides, dtype=torch.float32)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(convert._flax_layout(
            np.asarray(v["params"]["kernel"]), vision_layers.Conv).copy()))
    got = conv(_nchw(x)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_matches_flax(dtype):
    """One BatchNorm, train then eval: the output, and the running
    statistics moved by the biased batch variance (not the unbiased one
    ``torch.nn.BatchNorm2d`` uses), f32 within 1e-5; bf16 input within
    one bf16 step of the output."""
    import flax.linen as fnn

    rng = np.random.RandomState(0)
    x = (rng.randn(4, 3, 3, 6) * 2 + 1).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-5, dtype=jdt)
    v = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x, jdt))
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.randn(6).astype(np.float32)
    v = {"params": {"scale": scale, "bias": bias},
         "batch_stats": v["batch_stats"]}
    want, new = jbn.apply(v, jnp.asarray(x, jdt), mutable=["batch_stats"])
    bn = vision_layers.BatchNorm(6, eps=1e-5)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    got = bn(_nchw(x).to(tdt))
    assert got.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    _close(got.permute(0, 2, 3, 1), np.asarray(want, np.float32), tol, "y")
    _close(bn.running_mean, new["batch_stats"]["mean"], 1e-5, "mean")
    _close(bn.running_var, new["batch_stats"]["var"], 1e-5, "var")
    jeval = fnn.BatchNorm(use_running_average=True, momentum=0.9,
                          epsilon=1e-5, dtype=jdt)
    want = jeval.apply({"params": v["params"], "batch_stats":
                        new["batch_stats"]}, jnp.asarray(x, jdt))
    bn.eval()
    _close(bn(_nchw(x).to(tdt)).permute(0, 2, 3, 1),
           np.asarray(want, np.float32), tol, "eval y")


# --- Inception ----------------------------------------------------------------


class _Wrap:
    """A flax Inception block as a model of ``(x, train)``."""

    def __init__(self, block):
        self.block = block

    def init(self, rng, x, train=True):
        return self.block.clone(train=train).init(rng, x)

    def apply(self, variables, x, train=True, mutable=()):
        return self.block.clone(train=train).apply(variables, x,
                                                   mutable=mutable or False)


_BLOCKS = {
    "A": (lambda: JI.InceptionA(8, dtype=jnp.float32),
          lambda: I.InceptionA(16, 8, dtype=torch.float32), 16, 5),
    "B": (lambda: JI.InceptionB(dtype=jnp.float32),
          lambda: I.InceptionB(16, dtype=torch.float32), 16, 7),
    "C": (lambda: JI.InceptionC(12, dtype=jnp.float32),
          lambda: I.InceptionC(16, 12, dtype=torch.float32), 16, 5),
    "D": (lambda: JI.InceptionD(dtype=jnp.float32),
          lambda: I.InceptionD(16, dtype=torch.float32), 16, 7),
    "E": (lambda: JI.InceptionE(dtype=jnp.float32),
          lambda: I.InceptionE(16, dtype=torch.float32), 16, 3),
}


@pytest.mark.parametrize("kind", sorted(_BLOCKS))
def test_inception_block_matches_flax(kind):
    """Each mixed block alone, train mode, batch 2 at a small grid: its
    output and every gradient of ``sum(out * w)``, and the batch
    statistics it moved."""
    make_j, make_t, cin, size = _BLOCKS[kind]
    rng = np.random.RandomState(1)
    x = rng.rand(2, size, size, cin).astype(np.float32)
    jblock = make_j()
    v = _variables(_Wrap(jblock), x)
    block = make_t()
    vision_from_flax(v, block, device="cpu")
    out_j, new = jblock.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    w = rng.randn(*out_j.shape).astype(np.float32)
    grads = jax.grad(lambda p: jnp.sum(jblock.apply(
        {"params": p, "batch_stats": v["batch_stats"]}, jnp.asarray(x),
        mutable=["batch_stats"])[0] * w))(v["params"])
    block.train()
    out_t = block(_nchw(x))
    (out_t * _nchw(w)).sum().backward()
    _close(out_t.permute(0, 2, 3, 1), out_j, F32, f"Inception{kind}")
    leaves = _port_leaves(block)
    for key, g in _flat(grads, "params").items():
        t, k = leaves[key]
        _close(t.grad, convert._flax_layout(g, k), F32, "/".join(key))
    for key, s in _flat(new["batch_stats"], "batch_stats").items():
        _close(leaves[key][0], s, STATS, "/".join(key))


def test_inception_v3_forward_matches_flax():
    """The whole InceptionV3 (1000 classes) at 75×75, batch 1: eval- and
    train-mode logits (flax jitted, as ``init_variables`` is)."""
    x, _ = _images(75, 1)
    jmodel = JI.InceptionV3(num_classes=1000, dtype=jnp.float32)
    v = _variables(jmodel, x)
    model = I.create(dtype=torch.float32, device="cpu")
    vision_from_flax(v, model, device="cpu")
    apply = jax.jit(lambda v, x, train: jmodel.apply(
        v, x, train=train, mutable=["batch_stats"])[0],
        static_argnames="train")
    for train in (False, True):
        model.train(train)
        with torch.no_grad():
            _close(model(_nchw(x)), apply(v, jnp.asarray(x), train), F32,
                   f"train={train}")


# --- MLP ----------------------------------------------------------------------


def _mlp_pair(sizes, seed=0):
    jp = JM.init_params(jax.random.PRNGKey(seed), sizes)
    tp = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in jp.items()}
    return jp, tp


def test_mlp_forward_loss_accuracy_and_grads():
    """The counterpart of ``tests/test_models.py::TestMLP::
    test_forward_and_loss``, held to the JAX functions: f32 within 1e-5."""
    jp, tp = _mlp_pair((16, 8, 4))
    rng = np.random.RandomState(0)
    x = rng.randn(5, 16).astype(np.float32)
    y = rng.randint(0, 4, (5,))
    logits = M.forward(tp, torch.from_numpy(x))
    assert logits.shape == (5, 4)
    np.testing.assert_allclose(logits.numpy(), JM.forward(jp, x),
                               atol=1e-5, rtol=1e-5)
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    acc = M.accuracy(tp, batch)
    assert 0.0 <= float(acc) <= 1.0
    assert float(acc) == pytest.approx(float(JM.accuracy(jp, (x, y))))
    for t in tp.values():
        t.requires_grad_()
    loss = M.loss_fn(tp, batch)
    loss.backward()
    loss_j, grads = jax.value_and_grad(JM.loss_fn)(jp, (x, y))
    assert loss.item() == pytest.approx(float(loss_j), rel=1e-5)
    for k, g in grads.items():
        np.testing.assert_allclose(tp[k].grad.numpy(), g, atol=1e-5,
                                   rtol=1e-5)


@pytest.fixture()
def size_one():
    basics.init(device="cpu")
    yield
    basics.shutdown()


def test_mlp_trains_with_distributed_optimizer(size_one):
    """The counterpart of ``TestMLP::test_trains_with_distributed_optimizer``
    (Adam 0.01, 40 steps, the loss below half its start), each step's
    loss equal to the JAX run's from the same parameters within 1e-4."""
    import horovod_tpu as jhvd
    from horovod_tpu import spmd as jspmd

    jp, tp = _mlp_pair((8, 16, 2))
    rng = np.random.RandomState(0)
    x = rng.randn(64, 8).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.int32)
    jopt = jhvd.DistributedOptimizer(optax.adam(0.01))
    jstep = jspmd.make_train_step(JM.loss_fn, jopt)
    jst = jopt.init(jp)
    for t in tp.values():
        t.requires_grad_()
    opt = optim.DistributedOptimizer(torch.optim.Adam(tp.values(), lr=0.01))
    step = spmd.make_train_step(M.loss_fn, opt)
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    losses = []
    for _ in range(40):
        jp, jst, jloss = jstep(jp, jst, (x, y))
        losses.append(float(step(tp, batch)))
        assert losses[-1] == pytest.approx(float(jloss), rel=1e-4, abs=1e-6)
    assert losses[-1] < losses[0] * 0.5


# --- the train step -----------------------------------------------------------


def test_three_sgd_steps_match_optax(size_one):
    """Three SGD steps (momentum 0.9) of ResNet-18 through
    ``make_train_step`` on a size-1 gloo group, against
    ``optax.sgd(lr, momentum=0.9)`` on flax's gradients and batch
    statistics: losses, every parameter and every statistic after the
    third step (f32, 64×64, batch 2)."""
    lr = 0.05
    x, y = _images(64, 2)
    jmodel, v, model = _resnet_pair("ResNet18", "conv7", x)
    opt = optim.DistributedOptimizer(torch.optim.SGD(
        model.parameters(), lr=lr, momentum=0.9))
    step = spmd.make_train_step(
        lambda m, b: torch.nn.functional.cross_entropy(m(b["images"]),
                                                       b["labels"]), opt)
    model.train()
    tx = optax.sgd(lr, momentum=0.9)
    params, stats = v["params"], v["batch_stats"]
    state = tx.init(params)
    batch = {"images": _nchw(x), "labels": torch.from_numpy(y)}

    def jloss(p, s):
        logits, new = jmodel.apply({"params": p, "batch_stats": s},
                                   jnp.asarray(x), train=True,
                                   mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean(), new["batch_stats"]

    for _ in range(3):
        (loss_j, stats), g = jax.value_and_grad(jloss, has_aux=True)(
            params, stats)
        upd, state = tx.update(g, state, params)
        params = optax.apply_updates(params, upd)
        _close(step(model, batch), loss_j, F32, "loss")
    leaves = _port_leaves(model)
    for key, want in {**_flat(params, "params"),
                      **_flat(stats, "batch_stats")}.items():
        t, kind = leaves[key]
        _close(t, convert._flax_layout(want, kind), F32, "/".join(key))


# --- the converter and the device rule ----------------------------------------


def test_vision_from_flax_rejects_a_bad_tree():
    x, _ = _images(32, 1)
    jmodel = JR.MODELS["ResNet18"](num_classes=10, num_filters=8,
                                   dtype=jnp.float32)
    v = _variables(jmodel, x)
    model = R.create("ResNet18", 10, torch.float32, num_filters=8,
                     device="cpu")
    missing = {"params": dict(v["params"]), "batch_stats": v["batch_stats"]}
    del missing["params"]["head"]
    extra = {"params": dict(v["params"], extra={"kernel": np.zeros(3)}),
             "batch_stats": v["batch_stats"]}
    no_stats = {"params": v["params"]}
    other_stem = R.create("ResNet18", 10, torch.float32, "s2d",
                          num_filters=8, device="cpu")
    wide = R.create("ResNet18", 10, torch.float32, num_filters=16,
                    device="cpu")
    for tree, target, match in ((missing, model, "missing"),
                                (extra, model, "extra"),
                                (no_stats, model, "missing"),
                                (dict(v, cache={}), model, "extra"),
                                (v, other_stem, "shape"),
                                (v, wide, "shape")):
        with pytest.raises(ValueError, match=match):
            vision_from_flax(tree, target, device="cpu")
    vision_from_flax(v, model, device="cpu")


def test_entry_points_follow_the_device_rule(monkeypatch):
    """Without CUDA and without ``device="cpu"``, every new entry point
    raises; with ``device="cpu"`` each runs on the CPU."""
    from horovod_tpu_torch.data import DataLoader

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arrays = {"x": np.zeros((4, 2), np.float32)}
    model = R.create("ResNet18", 10, num_filters=8, device="cpu")
    for call in (lambda: R.create("ResNet18", 10, num_filters=8),
                 lambda: I.create(),
                 lambda: vision_layers.init_variables(model),
                 lambda: M.init_params((4, 2)),
                 lambda: vision_from_flax({}, model),
                 lambda: DataLoader(arrays, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert next(model.parameters()).device.type == "cpu"
    assert M.init_params((4, 2), device="cpu")["w0"].device.type == "cpu"
    assert vision_layers.init_variables(model, 1, device="cpu") is model
    batch = next(iter(DataLoader(arrays, 2, device="cpu")))
    assert batch["x"].device.type == "cpu"
