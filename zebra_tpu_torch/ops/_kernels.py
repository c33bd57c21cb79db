"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled by
``nvcc`` into ``zebra_tpu_torch/_build/<name>-<hash>.so`` at first use, then
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds). The
file name carries a hash of the source and of every shared header
``csrc/*.cuh``, so an edited kernel or header rebuilds; two sources build at
once when loaded from two threads. Nothing
here runs at import time: the CPU-only test machines import every module.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_name_locks: dict[str, threading.Lock] = {}
_libs: dict[str, ctypes.CDLL] = {}
#: compiler output (``-Xptxas -v``: registers, shared memory, spills) per kernel
BUILD_LOG: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin)")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed.
    Raises if the source does not compile."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        if name in _libs:
            return _libs[name]
        src = os.path.join(CSRC, f"{name}.cu")
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in [src, *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))]:
            with open(path, "rb") as f:
                h.update(f.read())
        digest = h.hexdigest()[:16]
        out = os.path.join(BUILD_DIR, f"{name}-{digest}.so")
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.tmp.{os.getpid()}"
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp, src],
                capture_output=True, text=True, check=False,
            )
            BUILD_LOG[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{BUILD_LOG[name]}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(out)
        _libs[name] = lib
        return lib
