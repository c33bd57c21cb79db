"""ctypes loader for the native pair-quantisation kernel (``zebra_quant.cpp``,
the port's copy of the JAX package's).

Built with ``g++`` at first use into ``zebra_tpu_torch/_build/``: ``-O3
-march=native`` first (the ``fmaf`` must be a hardware FMA to be fast; it is
correctly rounded either way), plain ``-O2`` as the portable retry. The file
name carries a hash of the source, the flags and the host's resolved
``-march``, so a build for one CPU is never loaded on another. Without a
toolchain :func:`get_lib` returns None and ``index/ivf.quantise_pair_host``
takes its numpy path, which is bitwise the same. Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "zebra_quant.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_FLAGS = (["-O3", "-march=native"], ["-O2"])

_lock = threading.Lock()
_lib = None
_tried = False
#: the flags the loaded library was built with (None: not loaded)
BUILT_WITH: list[str] | None = None


def _native_arch() -> str:
    """What ``-march=native`` resolves to on this host ("" if unknown)."""
    try:
        out = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                             capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return ""
    for line in out.splitlines():
        parts = line.split()
        if len(parts) == 2 and parts[0] == "-march=":
            return parts[1]
    return ""


def _build() -> tuple[str, list[str]] | None:
    with open(_SRC, "rb") as f:
        src = f.read()
    arch = _native_arch()
    for extra in _FLAGS:
        key = hashlib.sha256(src + " ".join(extra).encode() + arch.encode()).hexdigest()[:16]
        out = os.path.join(BUILD_DIR, f"libzebra_quant-{key}.so")
        if os.path.exists(out):
            return out, extra
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.tmp.{os.getpid()}"
        try:
            subprocess.run(["g++", *extra, "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp],
                           check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            continue
        os.replace(tmp, out)
        return out, extra
    return None


def get_lib():
    """The loaded CDLL, or None when no toolchain can build it."""
    global _lib, _tried, BUILT_WITH
    with _lock:
        if _tried:
            return _lib
        _tried = True
        built = _build()
        if built is None:
            return None
        lib = ctypes.CDLL(built[0])
        lib.zq_quantise_pair.restype = ctypes.c_int
        lib.zq_quantise_pair.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ]
        _lib, BUILT_WITH = lib, built[1]
        return _lib


def available() -> bool:
    return get_lib() is not None


def quantise_pair(x32: np.ndarray, threads: int = 0):
    """``(v8, r8, scale, rscale)`` of contiguous f32 rows ``[n, d]`` by the
    native kernel (``threads`` <= 0: one per core), or None without it."""
    lib = get_lib()
    if lib is None:
        return None
    if x32.dtype != np.float32 or x32.ndim != 2 or not x32.flags.c_contiguous:
        raise ValueError("quantise_pair takes C-contiguous float32 rows [n, d]")
    n, d = x32.shape
    v8 = np.empty((n, d), np.int8)
    r8 = np.empty((n, d), np.int8)
    scale = np.empty((n,), np.float32)
    rscale = np.empty((n,), np.float32)
    lib.zq_quantise_pair(x32.ctypes.data, n, d, v8.ctypes.data, r8.ctypes.data,
                         scale.ctypes.data, rscale.ctypes.data, int(threads))
    return v8, r8, scale, rscale
