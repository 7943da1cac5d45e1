"""Synthetic ResNet-50 training benchmark on the card, the counterpart of
the JAX package's ``bench.py`` and its protocol (the reference's
``examples/tensorflow2_synthetic_benchmark.py``): a fixed synthetic batch
on the device, 10 warm-up batches, 10 iterations of 10 batches, images
a second a card.

    python -m horovod_tpu_torch.bench [--model ResNet50] [--batch-size 384]
        [--input-pipeline] [--fp16-allreduce] [--stem conv7|s2d]
        [--device cpu]

It runs on CUDA unless ``--device cpu`` is given; with neither a card
nor ``--device`` it exits non-zero.  It prints one JSON line:
``metric``, ``value`` (the median img/s a card), ``unit``,
``vs_baseline`` (against :data:`REFERENCE_IMG_PER_SEC_PER_ACCEL`),
``stddev95``, ``mfu``, ``tflops_per_sec``, ``flops_per_img`` (the
FLOP count of :func:`~horovod_tpu_torch.obs.xprof.introspect`: matrix
products and convolutions, forward and backward — not XLA's count, which
also holds BatchNorm and the optimizer), ``peak_mem_bytes`` (the peak
allocation from the first step on), ``chip``, ``power_limit_w``, ``captured`` (the step
replays a CUDA graph), ``training_mfu_live``; with
``--input-pipeline`` also the loader-fed A/B in the same process:
``dataloader_fed_img_per_sec``, ``dataloader_overhead_pct``,
``host_to_device_bound_img_per_sec`` (the same copies without compute)
and ``dataloader_efficiency_vs_ceiling_pct``.

The step is ``DistributedOptimizer(SGD(lr=0.01 · size, momentum=0.9))``
over the mean softmax cross-entropy, through ``spmd.make_train_step``,
which captures it on CUDA after its warm-up (cuDNN's autotuning,
``cudnn.benchmark``, runs in those eager steps).  The JAX bench's CPU
clamp and watchdog are not ported: on the CPU this runs what it is
asked to.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

# ResNet-101 at 1656.82 img/s over 16 Pascal GPUs (the reference's
# docs/benchmarks.rst:29-43), the per-GPU yardstick the JAX bench uses.
REFERENCE_IMG_PER_SEC_PER_ACCEL = 1656.82 / 16


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m horovod_tpu_torch.bench")
    ap.add_argument("--model", default="ResNet50")
    ap.add_argument("--batch-size", type=int, default=384)
    ap.add_argument("--num-warmup-batches", type=int, default=10)
    ap.add_argument("--num-batches-per-iter", type=int, default=10)
    ap.add_argument("--num-iters", type=int, default=10)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--fp16-allreduce", action="store_true",
                    help="reduce the gradients in bf16 (Compression.bf16)")
    ap.add_argument("--stem", default="conv7", choices=["conv7", "s2d"],
                    help="ResNet stem: the 7x7/2 conv, or a 2x2 "
                         "space-to-depth then a 4x4 conv")
    ap.add_argument("--input-pipeline", action="store_true",
                    help="also feed the step from host memory through "
                         "horovod_tpu_torch.data.DataLoader, interleaved "
                         "with the synthetic iterations")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: CUDA)")
    args = ap.parse_args(argv)
    if args.model == "InceptionV3" and args.image_size == 224:
        args.image_size = 299  # Inception's native resolution
    return args


def create_model(name: str, stem: str = "conv7", *, seed: int = 0,
                 device=None) -> torch.nn.Module:
    """A bench model (a ResNet or InceptionV3, 1000 classes, bf16) in
    train mode."""
    from horovod_tpu_torch.models import inception, resnet

    if name == "InceptionV3":
        model = inception.create(name, 1000, seed=seed, device=device)
    else:
        model = resnet.create(name, 1000, stem=stem, seed=seed,
                              device=device)
    return model.train()


def make_step(model: torch.nn.Module, *, fp16_allreduce: bool = False):
    """The bench's train step: ``step(model, {"images", "labels"})`` ->
    the mean cross-entropy averaged over the ranks."""
    from horovod_tpu_torch import basics, optim, spmd
    from horovod_tpu_torch.ops.compression import Compression

    opt = optim.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01 * basics.size(),
                        momentum=0.9),
        compression=Compression.bf16 if fp16_allreduce
        else Compression.none)
    return spmd.make_train_step(
        lambda m, b: F.cross_entropy(m(b["images"]), b["labels"]), opt)


def synthetic_batch(batch: int, image_size: int, *, seed: int = 0,
                    device=None) -> dict:
    """A fixed random batch on the device: bf16 images in
    ``channels_last`` and int64 labels in [0, 1000)."""
    from horovod_tpu_torch.basics import resolve_device

    device = resolve_device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    images = torch.rand((batch, 3, image_size, image_size), generator=g,
                        device=device).to(torch.bfloat16)
    return {"images": images.contiguous(memory_format=torch.channels_last),
            "labels": torch.randint(0, 1000, (batch,), generator=g,
                                    device=device)}


def host_epoch(rows: int, image_size: int, seed: int = 0) -> dict:
    """``rows`` host images (bf16, an NHWC array viewed as NCHW, so in
    ``channels_last``) and labels, for the loader-fed A/B."""
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.random(
        (rows, image_size, image_size, 3), dtype=np.float32)).to(
            torch.bfloat16).permute(0, 3, 1, 2)
    return {"images": images,
            "labels": torch.from_numpy(rng.integers(0, 1000, (rows,)))}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def link_bound(host: dict, batch: int, device: torch.device) -> float:
    """img/s of the host→device copies alone: the host batches, pinned
    beforehand, copied one after another with no compute."""
    staged = [host["images"][s:s + batch].pin_memory()
              if device.type == "cuda" else host["images"][s:s + batch]
              for s in range(0, len(host["images"]) - batch + 1, batch)]
    _sync(device)
    t0 = time.perf_counter()
    for t in staged:
        t.to(device, non_blocking=True)
    _sync(device)
    return batch * len(staged) / (time.perf_counter() - t0)


def measure(run: Callable, model: torch.nn.Module, batch: dict, *,
            warmup: int = 10, per_iter: int = 10, iters: int = 10,
            loader=None, device=None) -> dict:
    """The JAX bench's ``_measure`` protocol for ``run(model, batch) ->
    loss``: the first warm-up batch counted by ``xprof.introspect``, the
    rest of ``max(warmup // per_iter, 1) · per_iter`` warm-up batches,
    then ``iters`` timed iterations of ``per_iter`` batches, each closed
    by reading the loss (and, with a ``loader``, followed by one epoch fed
    through it).  The peak memory is the device's peak allocation over
    the whole run, from the first warm-up batch: a captured step's graph
    holds its activations in a private pool whose blocks count as
    allocated only while the capture allocates them, so the peak of its
    eager warm-up steps and its capture is the step's working set.

    Returns ``img_per_sec`` (one a timed iteration), ``fed_img_per_sec``,
    ``losses`` (on the synthetic batch: the first batch's, the warm-up's
    last and each iteration's last), ``fed_losses`` (each fed epoch's
    last), ``step_flops`` and ``peak_mem_bytes``."""
    from horovod_tpu_torch import obs
    from horovod_tpu_torch.obs import xprof

    device = torch.device(device) if device is not None else \
        batch["labels"].device
    size = len(batch["labels"])
    loss, report = xprof.introspect(run, model, batch, device=device,
                                    fn="bench_train_step")
    losses = [float(loss)]
    n_warm = max(warmup // per_iter, 1) * per_iter
    for _ in range(n_warm - 1):
        loss = run(model, batch)
    if n_warm > 1:
        losses.append(float(loss))
    xprof.set_training_cost(report.flops * per_iter
                            if report.flops else None)
    img_s, fed, fed_losses = [], [], []
    for _ in range(iters):
        t0 = time.perf_counter()
        with obs.training_step("bench_iter"):
            for _ in range(per_iter):
                loss = run(model, batch)
            losses.append(float(loss))
        img_s.append(size * per_iter / (time.perf_counter() - t0))
        if loader is None:
            continue
        t0 = time.perf_counter()
        n = 0
        for b in loader:
            loss = run(model, b)
            n += len(b["labels"])
        fed_losses.append(float(loss))
        fed.append(n / (time.perf_counter() - t0))
    peak = (float(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else None)
    return {"img_per_sec": img_s, "fed_img_per_sec": fed,
            "losses": losses, "fed_losses": fed_losses,
            "step_flops": report.flops,
            "peak_mem_bytes": peak}


def power_limit_w(device: torch.device) -> Optional[float]:
    """The card's power limit in watts as ``nvidia-smi`` reports it, or
    None (the CPU, no ``nvidia-smi``)."""
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i",
             str(device.index or 0)], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def summarize(res: dict, *, batch_size: int, peak: Optional[float]) -> dict:
    """img/s median and ±1.96σ, MFU and TFLOP/s of :func:`measure`'s
    result."""
    med = statistics.median(res["img_per_sec"])
    fpi = res["step_flops"] / batch_size if res["step_flops"] else None
    return {
        "value": med,
        "vs_baseline": med / REFERENCE_IMG_PER_SEC_PER_ACCEL,
        "stddev95": 1.96 * float(np.std(res["img_per_sec"])),
        "mfu": med * fpi / peak if fpi and peak else None,
        "tflops_per_sec": med * fpi / 1e12 if fpi else None,
        "flops_per_img": fpi,
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        print("horovod_tpu_torch.bench: no CUDA device; pass --device cpu "
              "to run on the CPU", file=sys.stderr)
        return 2
    from horovod_tpu_torch import basics, obs
    from horovod_tpu_torch.data import DataLoader
    from horovod_tpu_torch.obs import xprof

    basics.init(device=args.device)
    try:
        device = basics.device()
        if device.type == "cuda":
            torch.backends.cudnn.benchmark = True
        model = create_model(args.model, args.stem, seed=42, device=device)
        step = make_step(model, fp16_allreduce=args.fp16_allreduce)
        batch = synthetic_batch(args.batch_size, args.image_size,
                                device=device)
        loader = host = None
        if args.input_pipeline:
            host = host_epoch(args.batch_size * args.num_batches_per_iter,
                              args.image_size)
            loader = DataLoader(host, args.batch_size, shuffle=False,
                                shard=False, prefetch=2, device=device)
        res = measure(step, model, batch, warmup=args.num_warmup_batches,
                      per_iter=args.num_batches_per_iter,
                      iters=args.num_iters, loader=loader, device=device)
        peak = xprof.chip_peak_flops(device)
        result = {
            "metric": f"{args.model} synthetic train throughput per chip "
            f"(batch {args.batch_size}/chip, {basics.size()} chip(s))",
            "unit": "img/sec/chip",
            **summarize(res, batch_size=args.batch_size, peak=peak),
            "peak_mem_bytes": res["peak_mem_bytes"],
            "chip": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "power_limit_w": power_limit_w(device),
            "captured": step.replays > 0,
            "training_mfu_live": obs.training_metrics().mfu.value or None,
        }
        if res["fed_img_per_sec"]:
            med, fed = result["value"], statistics.median(
                res["fed_img_per_sec"])
            bound = link_bound(host, args.batch_size, device)
            result.update({
                "dataloader_fed_img_per_sec": fed,
                "dataloader_overhead_pct": 100 * (1 - fed / med),
                "host_to_device_bound_img_per_sec": bound,
                "dataloader_efficiency_vs_ceiling_pct":
                    100 * fed / min(med, bound),
            })
    finally:
        basics.shutdown()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
