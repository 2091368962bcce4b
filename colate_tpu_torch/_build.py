"""Builds and loads the hand-written CUDA kernels at first use.

Each source under ``csrc/`` is compiled by ``nvcc`` into a shared library
with a plain C interface and loaded with ctypes.  The library lands in
``colate_tpu_torch/_build/`` under a name keyed by a hash of the source
and the flags, so an edited source is rebuilt and an unchanged one is
reused.  A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "_build")

# sm_90a: Hopper.  No --use_fast_math: the EM stopping rule compares f64
# sums of expf/expm1f/logf terms against a 1e-7 ratio.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class Built:
    """A loaded kernel library with what its build reported."""

    def __init__(self, lib: ctypes.CDLL, path: str, seconds: float, log: str):
        self.lib = lib
        self.path = path
        self.seconds = seconds  # 0.0 when an earlier build was reused
        self.log = log


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels need it")


def build(source: str) -> Built:
    """Compile ``csrc/<source>`` (if not already built) and load it."""
    src = os.path.join(_HERE, "csrc", source)
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    so = os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = r.stdout + r.stderr
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({r.returncode}) building {source}:\n{log}"
            )
        os.replace(tmp, so)  # atomic: a concurrent build loads a whole file
    return Built(ctypes.CDLL(so), so, seconds, log)
