"""``python -m horovod_tpu_torch.bench`` on the CPU at a tiny size.

Each test runs the bench as a user does, in a subprocess: ResNet-18 at
32×32, batch 2, one batch an iteration, two iterations.  The numbers are
the CPU's and say nothing of the card; the tests hold the JSON line's
keys and that it measured something."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
TINY = ["--model", "ResNet18", "--image-size", "32", "--batch-size", "2",
        "--num-warmup-batches", "1", "--num-batches-per-iter", "1",
        "--num-iters", "2"]
KEYS = {"metric", "value", "unit", "vs_baseline", "stddev95", "mfu",
        "tflops_per_sec", "flops_per_img", "peak_mem_bytes", "chip",
        "power_limit_w", "captured"}
LOADER_KEYS = {"dataloader_fed_img_per_sec", "dataloader_overhead_pct",
               "host_to_device_bound_img_per_sec",
               "dataloader_efficiency_vs_ceiling_pct"}


def _bench(*args, cuda_visible=None):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    if cuda_visible is not None:
        env["CUDA_VISIBLE_DEVICES"] = cuda_visible
    return subprocess.run([sys.executable, "-m", "horovod_tpu_torch.bench",
                           *args], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=300)


def _line(out):
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, out.stdout
    return json.loads(lines[0])


def test_cpu_bench_prints_one_json_line():
    res = _line(_bench("--device", "cpu", *TINY))
    assert KEYS <= set(res) and not LOADER_KEYS & set(res)
    assert res["value"] > 0 and res["unit"] == "img/sec/chip"
    assert res["chip"] == "cpu" and res["captured"] is False
    # ResNet-18 at 32×32: 3 × 2 × 37 M multiply-adds an image.
    assert 1.5e8 < res["flops_per_img"] < 3e8
    assert res["mfu"] is None and res["peak_mem_bytes"] is None


def test_input_pipeline_adds_the_loader_keys():
    res = _line(_bench("--device", "cpu", "--input-pipeline", *TINY))
    assert KEYS | LOADER_KEYS <= set(res)
    assert res["dataloader_fed_img_per_sec"] > 0
    assert res["host_to_device_bound_img_per_sec"] > 0


def test_no_cuda_and_no_device_exits_nonzero():
    out = _bench(*TINY, cuda_visible="")
    assert out.returncode != 0 and not out.stdout.strip()
    assert "no CUDA device" in out.stderr
