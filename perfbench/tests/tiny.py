"""A copy of the benchmark with cells small enough for the CPU, and a way to
run one of its cells there (the harness's look for a card skipped)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

#: Cell -> (configuration it copies, its sizes, traffic).  The ResNet is
#: cut to one block a stage at 64x64 (BatchNorm still sees 64 values a
#: channel in the last stage); the decoder to d 128, one head of 64 per
#: kv head pair.
TINY = {
    "tiny.resnet.captured": ("resnet50", {
        "stage_sizes": [1, 1, 1, 1], "num_filters": 16, "num_classes": 10,
        "image_size": 64}, {"path": "captured", "batch": 16}),
    "tiny.resnet.hooks": ("resnet50", {
        "stage_sizes": [1, 1, 1, 1], "num_filters": 16, "num_classes": 10,
        "image_size": 64}, {"path": "hooks", "batch": 16}),
    "tiny.lm.train": ("mistral7b-l8", {
        "hidden_size": 128, "num_attention_heads": 2,
        "num_key_value_heads": 1, "intermediate_size": 256,
        "num_hidden_layers": 2, "vocab_size": 256},
        {"path": "captured", "batch": 2, "seq": 64}),
}
#: Which full-size cell's metrics each tiny cell reports.
LIKE = {"tiny.resnet.captured": "resnet50.captured.b384",
        "tiny.resnet.hooks": "resnet50.hooks.b512",
        "tiny.lm.train": "mistral7b-l8.train.s4096"}


def make_copy(dest: Path) -> Path:
    """``dest`` with ``BENCHMARK.json`` and ``perfbench/``, the tiny cells
    added as new files and entries."""
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(REPO / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    for cell, (base, sizes, traffic) in TINY.items():
        config = json.loads((REPO / "perfbench" / "configs" /
                             f"{base}.json").read_text())
        config.update(sizes)
        (dest / "perfbench" / "configs" / f"{cell}.json").write_text(
            json.dumps(config))
        (dest / "perfbench" / "traffic" / f"{cell}.json").write_text(
            json.dumps({**traffic, "pool": 4, "warmup_steps": 1,
                        "trace_steps": 2}))
        bench["configs"].append({"name": cell, "source": "tiny",
                                 "file": f"perfbench/configs/{cell}.json",
                                 "reduced": [], "why": "CPU tests"})
        bench["workloads"].append({"name": cell, "config": cell,
                                   "traffic": cell, "chips": 1,
                                   "why": "CPU tests"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if LIKE[cell] in m.get("workloads", []):
                m["workloads"].append(cell)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


def env(copy: Path) -> dict:
    e = dict(os.environ)
    e["PYTHONPATH"] = os.pathsep.join([str(copy), str(REPO)])
    e["CUDA_VISIBLE_DEVICES"] = ""
    return e


def _code(cell: str, seed: int, seconds: float, trace: bool, breaker: str,
          extra: str) -> str:
    return f"""
import json, sys, torch
torch.set_num_threads(2)
from perfbench import run
{breaker or 'breaker = None'}
{extra}
out = run.run_cell({cell!r}, {seed}, {seconds}, {trace}, device="cpu",
                   breaker=breaker)
out["modules"] = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps(out))
"""


def run_cell(copy: Path, cell: str, *, seed: int = 2147483901,
             seconds: float = 0.5, trace: bool = False, breaker: str = "",
             extra: str = "") -> dict:
    """One run of ``cell`` on the CPU in a fresh interpreter -> its result,
    and the top-level names of every module it loaded
    (``result["modules"]``).  ``breaker``: Python source of a function
    ``breaker(program)`` that breaks the program after it is built."""
    p = subprocess.run(
        [sys.executable, "-c", _code(cell, seed, seconds, trace, breaker,
                                     extra)],
        cwd=copy, env=env(copy), capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def run_ranks(copy: Path, cell: str, world: int, *, seed: int = 2147483911,
              seconds: float = 0.5, trace: bool = False,
              breaker: str = "") -> dict:
    """One run of ``cell`` on the CPU over ``world`` ranks (gloo), launched
    and merged as ``perfbench.run`` does for a cell on more cards."""
    from perfbench import ranks

    return ranks.merge(ranks.launch(
        [sys.executable, "-c", _code(cell, seed, seconds, trace, breaker,
                                     "")], world, cwd=copy, env=env(copy)))
