"""Shared CUDA plumbing for the hand-written Hopper kernels.

The counterpart of ``horovod_tpu/ops/_pallas_util.py``.  Every kernel in
this package (:mod:`~horovod_tpu_torch.ops.attention`: ``flash_fwd.cu``
and ``flash_bwd.cu``; :mod:`~horovod_tpu_torch.ops.paged_attention`:
``paged_attention.cu``; :mod:`~horovod_tpu_torch.ops.grouped_matmul`:
``grouped_matmul.cu``) is CUDA C++ under
``ops/csrc/`` with a plain C entry point, built by ``nvcc`` for
``sm_90a`` into a shared library and called through ``ctypes`` — no
PyTorch headers, so a build takes seconds, not minutes.

* The build happens at FIRST USE, never at import (the CPU test suite
  imports every module on a machine with no ``nvcc``), into
  ``build/kernels/`` at the repository root; a library is rebuilt when
  its source, or any shared header ``csrc/*.cuh``, is newer.
  :func:`build_all` starts one ``nvcc`` per source at once.
* Every pointer and the stream cross as ``ctypes.c_void_p`` (a bare
  Python int would be cut to 32 bits); the stream is PyTorch's current
  one, so a kernel orders with the surrounding tensor code and never
  synchronises.
* Every C entry point returns ``cudaGetLastError()`` after its launch;
  :func:`check` raises on anything but 0.  A refused launch (too much
  shared memory, a bad grid) never runs and a later synchronise would
  not report it.

``NEG_INF`` is the shared finite mask value, with the JAX package's
semantics: ``exp(NEG_INF - x) == 0`` for any real ``x``, and a fully
masked row reports ``NEG_INF`` as its logsumexp.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

__all__ = ["NEG_INF", "build_all", "check", "count", "library", "ptr",
           "stream"]

NEG_INF = -1e30  # finite mask value: exp(NEG_INF - anything_real) == 0

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# -Xptxas -v: ptxas reports each kernel's registers, shared memory and
# spills in the compiler output that build_all returns.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
            "kernels of horovod_tpu_torch are built from source at first "
            "use and need the CUDA toolkit")
    return found


def _stale(name: str) -> bool:
    """True when ``lib<name>.so`` is missing or older than ``<name>.cu``
    or any shared header under ``csrc/`` (a header edit must rebuild
    every library, not leave the old one loaded)."""
    so = BUILD_DIR / f"lib{name}.so"
    if not so.exists():
        return True
    built = so.stat().st_mtime
    return any(src.stat().st_mtime > built
               for src in [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")])


def _start(name: str):
    """Start one ``nvcc`` into a temporary file beside the library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp


def _finish(name: str, out: str, rc: int, tmp: Path) -> str:
    if rc != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {rc}):\n{out}")
    # Atomic: a concurrent loader sees the old library or the new one.
    os.replace(tmp, BUILD_DIR / f"lib{name}.so")
    return out


def build_all(names: Iterable[str] = None) -> Dict[str, str]:
    """Build every stale kernel library, one ``nvcc`` per source, all
    started together.  Returns each built source's compiler output."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with _lock:
        started = {n: _start(n) for n in names if _stale(n)}
        # Reap every nvcc before reporting any failure.
        done = {}
        for n, (proc, tmp) in started.items():
            out, _ = proc.communicate()
            done[n] = (out, proc.returncode, tmp)
        return {n: _finish(n, *d) for n, d in done.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if it is
    missing or older than its sources."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
            _libs[name] = lib
    return lib


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def count(by_dtype: dict, dtype: torch.dtype) -> None:
    """One more launch in a wrapper's counter by dtype name ("float32",
    "bfloat16", "int8"): each dtype runs its own kernel functions."""
    name = str(dtype).removeprefix("torch.")
    by_dtype[name] = by_dtype.get(name, 0) + 1


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise unless a C entry point returned cudaSuccess (0).  Every
    library exports ``hvd_error_string`` (``cudaGetErrorString``)."""
    if rc != 0:
        lib.hvd_error_string.restype = ctypes.c_char_p
        lib.hvd_error_string.argtypes = [ctypes.c_int]
        msg = lib.hvd_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
