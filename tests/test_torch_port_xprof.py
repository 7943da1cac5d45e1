"""horovod_tpu_torch.obs.xprof and obs.training_step on the CPU.

The FLOP count of ``introspect`` against the analytic count of a matrix
product, forward and backward; the live MFU gauge through
``training_step``; and the analytic decode cost against the JAX
package's ``transformer_flops_per_token`` on the same parameters.
Exact equality (counts are integers; the gauge is one division)."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as JT
from horovod_tpu.obs import xprof as jxprof
from horovod_tpu_torch import obs
from horovod_tpu_torch.models import params_from_jax
from horovod_tpu_torch.models import transformer as T
from horovod_tpu_torch.obs import xprof


@pytest.fixture()
def disarmed():
    xprof.set_training_cost(None)
    yield
    xprof.set_training_cost(None)


def test_introspect_counts_a_matmul_forward_and_backward():
    a = torch.randn(8, 16, requires_grad=True)
    b = torch.randn(16, 4, requires_grad=True)

    def step(a, b):
        loss = (a @ b).sum()
        loss.backward()
        return loss

    loss, report = xprof.introspect(step, a, b, fn="mm", device="cpu")
    # forward 2·8·16·4; backward: da = g·bᵀ and db = aᵀ·g, each as much.
    assert report.flops == 3 * 2 * 8 * 16 * 4
    assert report.peak_mem_bytes is None and report.fn == "mm"
    assert torch.equal(loss, (a @ b).sum()) and a.grad is not None
    gauge = obs.default_registry().get("flops")
    assert gauge.labels(fn="mm").value == report.flops


def test_peak_and_mfu_on_the_cpu(monkeypatch):
    assert xprof.chip_peak_flops("cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert xprof.chip_peak_flops() is None
    assert xprof.mfu(1e12, 1.0) is None
    assert xprof.mfu(1e12, 2.0, peak=1e12) == 0.5
    assert xprof.mfu(1e12, 0.0, peak=1e12) is None
    assert xprof.PEAK_FLOPS_BY_KIND["NVIDIA H100 80GB HBM3"] == 989e12


def test_training_step_sets_the_live_mfu(disarmed):
    m = obs.training_metrics()
    steps = m.steps.value
    with obs.training_step("idle"):
        pass
    assert m.steps.value == steps + 1
    assert xprof.training_cost() == (None, None)
    xprof.set_training_cost(1e9, peak=1e12)
    assert xprof.training_cost() == (1e9, 1e12)
    with obs.training_step("timed"):
        time.sleep(0.01)
    dt = m.last_step.value
    assert m.steps.value == steps + 2 and dt >= 0.01
    assert m.mfu.value == pytest.approx(1e9 / dt / 1e12, rel=1e-12)


def test_transformer_flops_per_token_matches_jax():
    jcfg = JT.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                                n_layers=2, d_ff=64, max_seq=16,
                                dtype=jnp.float32)
    tcfg = T.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                               n_layers=2, d_ff=64, max_seq=16,
                               dtype=torch.float32)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    assert xprof.matmul_param_count(tp) == jxprof.matmul_param_count(jp)
    assert xprof.transformer_flops_per_token(tp) == \
        jxprof.transformer_flops_per_token(jp)
