"""``correct`` comes out false for the control and for each fault a cell can
have, at sizes the CPU holds: a run driven with the program broken
underneath, and the fp8 control against the configuration's limits.

The faults of a training cell: a step that leaves its state unchanged, and
half of each batch left out with the mean taken over the rest; on more
than one rank, the exchange between them left out; for ResNet, a step
that leaves one kind of leaf unchanged (BatchNorm's running statistics, or
its scales and shifts).  (No token or answer that a training step hands
out to alter.)"""

import json
import subprocess
import sys

import pytest

from perfbench import check
from perfbench.tests import tiny

UNCHANGED = """
def breaker(program):
    run = program.step

    def step(i):
        saved = [(t, t.detach().clone()) for _, t in program.state()]
        loss = run(i)
        with torch.no_grad():
            for t, s in saved:
                t.copy_(s)
        return loss

    program.step = step
"""
HALF_BATCH = """
def breaker(program):
    program.batches = [{k: v[:len(v) // 2] for k, v in b.items()}
                       for b in program.batches]
"""

FROZEN = """
def breaker(program):
    run = program.step
    stats = ("running_mean", "running_var")

    def frozen(name, t):
        return {rule}

    def step(i):
        saved = [(t, t.detach().clone()) for n, t in program.state()
                 if frozen(n, t)]
        loss = run(i)
        with torch.no_grad():
            for t, s in saved:
                t.copy_(s)
        return loss

    program.step = step
"""
#: ResNet's leaves a fault leaves unmoved -> (rule, their kinds in
#: ``check``).
KINDS = {
    "running_stats": ("name.endswith(stats)", ["mean", "var"]),
    "norm_scale_shift": ("t.dim() == 1 and not name.endswith(stats) and "
                         "not name.startswith('head')", ["bn_w", "bn_b"]),
}
EXCHANGE = """
def breaker(program):
    import torch.distributed as dist

    class Done:
        def wait(self, *a, **k):
            return True

        def is_completed(self):
            return True

    dist.all_reduce = lambda t, *a, **k: Done() if k.get("async_op") \
        else None
"""


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny.make_copy(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("cell", sorted(tiny.TINY))
def test_a_broken_step_is_not_correct(copy, cell, fault):
    out = tiny.run_cell(copy, cell, breaker={"unchanged": UNCHANGED,
                                             "half_batch": HALF_BATCH}[fault])
    assert out["correct"] is False, out["checks"]
    if fault == "unchanged":
        numbers = out["readings"]["numbers"]
        assert numbers["change"] == pytest.approx(1.0)
        assert numbers["change_median"] >= 0.5


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("cell", ["tiny.resnet.captured", "tiny.resnet.hooks"])
def test_a_kind_left_unmoved_is_not_correct(copy, cell, kind):
    rule, kinds = KINDS[kind]
    out = tiny.run_cell(copy, cell, breaker=FROZEN.format(rule=rule))
    assert out["correct"] is False, out["checks"]
    numbers = out["readings"]["numbers"]
    for k in kinds:
        assert numbers[f"change.{k}"] == pytest.approx(1.0)
        assert numbers[f"change_median.{k}"] >= 0.5


@pytest.mark.parametrize("cell", ["tiny.resnet.captured", "tiny.lm.train"])
def test_the_exchange_left_out_is_not_correct(copy, cell):
    out = tiny.run_ranks(copy, cell, 2, breaker=EXCHANGE)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell", ["tiny.resnet.captured", "tiny.lm.train"])
def test_the_fp8_control_is_not_correct(copy, cell):
    code = f"""
import json, torch
torch.set_num_threads(2)
from perfbench import calibrate
calibrate.readings({cell!r}, [], [2147483907], device="cpu",
                   emit=lambda r: print(json.dumps(r)))
"""
    p = subprocess.run([sys.executable, "-c", code], cwd=copy,
                       env=tiny.env(copy), capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    recs = {r["kind"]: r for r in map(json.loads, p.stdout.splitlines())}
    from perfbench.run import load_cell

    _, _, config, _ = load_cell(cell, copy)
    for kind in ("control", "half_batch"):
        ok, checks = check.verdict(recs[kind], config["correct_limits"])
        assert not ok, (kind, checks)
