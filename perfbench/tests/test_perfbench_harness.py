"""The harness on the CPU: cells, traffic and metrics found by name; no
result without a card; no JAX loaded; statistics over the whole window.
Everything that times the card runs there only (``perfbench.run``)."""

import ast
import json
import subprocess
import sys
import time

import pytest
import torch

from perfbench import trace, window
from perfbench.tests import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "horovod_tpu"}


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny.make_copy(tmp_path_factory.mktemp("bench"))


ADDED_PATH = """
LOSS_OVER = "rank"


def make(target, inner, loss_fn, named, spans):
    from horovod_tpu_torch import optim

    opt = optim.DistributedOptimizer(inner, named_parameters=named)
    spans["added"] = [0.0, 0]

    def step(b):
        opt.zero_grad()
        loss = loss_fn(target, b)
        loss.backward()
        opt.step()
        spans["added"][1] += 1
        return loss.detach()

    return opt, step
"""


def test_new_files_are_found_with_no_other_edit(copy, tmp_path):
    """A configuration, a traffic mix, a training path and a per-layer
    metric added as new files, and named in BENCHMARK.json, run with no
    edit to any file of the harness."""
    import shutil

    new = tiny.make_copy(tmp_path)
    config = json.loads((new / "perfbench/configs/tiny.lm.train.json")
                        .read_text())
    config["num_hidden_layers"] = 3
    (new / "perfbench/configs/added.json").write_text(json.dumps(config))
    (new / "perfbench/traffic/added.s32.json").write_text(json.dumps(
        {"path": "added_eager", "batch": 1, "seq": 32, "pool": 2,
         "warmup_steps": 1, "trace_steps": 2}))
    (new / "perfbench/metrics/steps_seen.added.py").write_text(
        "def read(ctx):\n    return float(ctx.window.steps)\n")
    (new / "perfbench/paths/added_eager.py").write_text(ADDED_PATH)
    bench = json.loads((new / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "added", "source": "tiny",
                             "file": "perfbench/configs/added.json",
                             "reduced": [], "why": "t"})
    bench["workloads"].append({"name": "added.s32", "config": "added",
                               "traffic": "added.s32", "chips": 1,
                               "why": "t"})
    for m in bench["end_to_end"]:
        if m["name"] == "step_ms_p95":
            m["workloads"].append("added.s32")
    bench["per_layer"].append({"name": "steps_seen.added", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "train step", "moves": "step_ms_p95",
                               "workloads": ["added.s32"]})
    (new / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p.relative_to(new): p.read_bytes()
              for p in (new / "perfbench").rglob("*.py")}
    traced = tiny.run_cell(new, "added.s32", trace=True)
    plain = tiny.run_cell(new, "added.s32")
    assert traced["metrics"]["steps_seen.added"]["value"] >= 1
    assert traced["metrics"]["steps_seen.added"]["unit"] == "steps"
    assert set(plain["metrics"]) == {"setup_s", "step_ms_p95"}
    assert plain["attempted"] >= 1 and plain["failed"] == 0
    assert set(traced["checks"]) == set(config["correct_limits"])
    assert set(traced["readings"]["numbers"]) == {
        "loss", "grad", "change", "grad_median", "change_median"}
    assert traced["correct"] is True, traced["checks"]
    after = {p.relative_to(new): p.read_bytes()
             for p in (new / "perfbench").rglob("*.py")}
    assert {k: v for k, v in after.items() if k in before} == before
    shutil.rmtree(new / "perfbench")


@pytest.mark.parametrize("cell", ["tiny.resnet.hooks", "tiny.lm.train"])
def test_a_cell_runs_on_two_ranks(copy, cell):
    """A cell on more cards runs one process a rank: every rank the same
    window, rank 0's comparison, the device reading of both."""
    out = tiny.run_ranks(copy, cell, 2, trace=True)
    assert out["correct"] is True, out["checks"]
    assert out["device"]["count"] == 2 and out["attempted"] >= 1
    assert not out["forbidden_modules"]


def test_every_metric_has_a_reader():
    """Each metric is read by its own file, or by the file of its name's
    part before the first dot."""
    from perfbench import run

    assert run.metric_file("idle_share.lm").name == "idle_share.py"
    assert run.metric_file("mfu.lm").name == "mfu.lm.py"
    bench = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert run.metric_file(m["name"]).exists(), m["name"]


def test_no_card_no_result(copy):
    p = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload",
         "resnet50.captured.b384", "--seed", "2147483901", "--seconds", "1",
         "--trace", "0"], cwd=copy, env=tiny.env(copy), capture_output=True,
        text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_no_result_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and perfbench/ cannot run."""
    import shutil

    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(tiny.REPO / "perfbench", tmp_path / "perfbench")
    p = subprocess.run(
        [sys.executable, "-c", "from perfbench import run; "
         "run.run_cell('resnet50.captured.b384', 1, 0.1, False, "
         "device='cpu')"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env={**tiny.env(tmp_path),
                          "PYTHONPATH": str(tmp_path)})
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "horovod_tpu_torch" in p.stderr


@pytest.mark.parametrize("cell", sorted(tiny.TINY))
def test_a_run_loads_no_jax(copy, cell):
    out = tiny.run_cell(copy, cell, trace=True)
    assert not FORBIDDEN & set(out["modules"])
    assert "horovod_tpu_torch" in out["modules"]
    # Every per-layer metric whose reader finds something on the CPU.
    want = {"resnet": {"step_wait_ms.hooks", "fusion_ratio.hooks"}
            if "hooks" in cell else set(), "lm": set()}
    assert want["lm" if ".lm." in cell else "resnet"] <= set(out["metrics"])


def test_the_references_import_nothing_of_the_program():
    root = tiny.REPO / "perfbench" / "reference"
    for path in root.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] in {"torch", "math", "typing",
                                           "__future__", "perfbench"}, \
                    (path.name, n)
    code = ("import sys\nimport perfbench.reference.resnet, "
            "perfbench.reference.decoder, perfbench.reference.optim, "
            "perfbench.reference.precision\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=tiny.REPO,
                       capture_output=True, text=True, timeout=300)
    loaded = set(ast.literal_eval(p.stdout.strip()))
    assert not (FORBIDDEN | {"horovod_tpu_torch"}) & loaded


def _sleepy(ms, stall_at=None, stall_ms=0):
    def step(i):
        time.sleep((stall_ms if i == stall_at else ms) / 1e3)
        return torch.zeros(())
    return step


def test_statistics_cover_the_whole_window():
    clock = window.HostClock()
    steady = window.run_window(_sleepy(20), 0.25, clock, {"img": 8})
    stalled = window.run_window(_sleepy(20, stall_at=3, stall_ms=250), 0.25,
                                clock, {"img": 8})
    assert stalled.rate("img") < 0.75 * steady.rate("img")
    assert stalled.step_ms_p95() > 2 * steady.step_ms_p95()
    assert steady.rate("tokens") is None
    assert stalled.steps * 8 / stalled.seconds == stalled.rate("img")


def test_a_non_finite_loss_counts_as_failed():
    def step(i):
        return torch.tensor(float("nan") if i == 1 else 1.0)
    w = window.run_window(step, 0.05, window.HostClock(), {"img": 1})
    assert w.nonfinite == 1


def test_p95_interpolates():
    assert window.p95(list(range(1, 21))) == pytest.approx(19.05)
    assert window.p95([5.0]) == 5.0


def test_trace_reduction():
    st = trace.TraceStats(
        kernels=[("a", 0.0, 1.0), ("batch_norm_x", 0.5, 2.0),
                 ("b", 3.0, 4.0)],
        host=[("outer", -1.0, 5.0), ("inner", 2.1, 2.9)], window_s=5.0,
        steps=1)
    assert st.busy_s == 3.0 and st.span_s == 4.0
    assert st.idle_share() == pytest.approx(40.0)
    assert st.seconds_matching("batch_norm") == (1.5, 1)
    bd = st.breakdown()
    assert bd["idle_gaps"] == [["inner", 1.0]]
    assert bd["device_ops"][0] == ["batch_norm_x", 1.5]
