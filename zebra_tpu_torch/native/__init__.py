"""Host C++ components of the torch port, built with ``g++`` at first use
(the port's own copies of the JAX package's ``native/`` sources).

This module loads the store library (``zebra_store.cpp``: the packed blob
log and the flat 16-byte-key id map); ``native/quant.py`` loads the pair
quantiser. Both build through :func:`build_library` into the ignored
``zebra_tpu_torch/_build/``, under a file name keyed on a hash of the source
and the flags, never next to the source. Without a toolchain (or without
zlib for the store) :func:`get_lib` returns None, :func:`available` is
False and every consumer takes its pure-Python path: the per-file document
store and a dict id map. Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "zebra_store.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")

_lock = threading.Lock()
_lib = None
_tried = False


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


def build_library(src: str, stem: str, flag_sets, link=()) -> tuple[str, list[str]] | None:
    """``(path of lib<stem>-<hash>.so, the flags it was built with)``: the
    first of ``flag_sets`` that compiles ``src`` (linked with ``link``), or
    None when none does. The hash covers the source, the flags, the link
    arguments and, for ``-march=native``, what it resolves to here, so a
    build for one CPU is never loaded on another. An existing build is
    reused; a new one is written under a per-process name and renamed."""
    with open(src, "rb") as f:
        text = f.read()
    for extra in flag_sets:
        arch = _native_arch() if "-march=native" in extra else ""
        key = hashlib.sha256(text + " ".join([*extra, *link]).encode()
                             + arch.encode()).hexdigest()[:16]
        out = os.path.join(BUILD_DIR, f"lib{stem}-{key}.so")
        if os.path.exists(out):
            return out, list(extra)
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.tmp.{os.getpid()}"
        try:
            subprocess.run(["g++", *extra, "-shared", "-fPIC", "-std=c++17", src, *link,
                            "-o", tmp], check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            continue
        os.replace(tmp, out)
        return out, list(extra)
    return None


def get_lib():
    """The loaded store library, or None when it cannot be built."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        built = build_library(_SRC, "zebra_store", (["-O2"],), link=("-lz",))
        if built is None:
            return None
        lib = ctypes.CDLL(built[0])
        c_key = ctypes.c_char_p
        for name, res, args in (
            ("zs_open", ctypes.c_void_p, [ctypes.c_char_p]),
            ("zs_put", ctypes.c_int,
             [ctypes.c_void_p, c_key, ctypes.c_char_p, ctypes.c_uint32, ctypes.c_int]),
            ("zs_get_len", ctypes.c_int64, [ctypes.c_void_p, c_key]),
            ("zs_get", ctypes.c_int64,
             [ctypes.c_void_p, c_key, ctypes.c_char_p, ctypes.c_uint32]),
            ("zs_del", ctypes.c_int, [ctypes.c_void_p, c_key]),
            ("zs_flush", ctypes.c_int, [ctypes.c_void_p]),
            ("zs_count", ctypes.c_int64, [ctypes.c_void_p]),
            ("zs_compact", ctypes.c_int, [ctypes.c_void_p]),
            ("zs_close", None, [ctypes.c_void_p]),
            ("zim_new", ctypes.c_void_p, [ctypes.c_uint64]),
            ("zim_free", None, [ctypes.c_void_p]),
            ("zim_put", ctypes.c_int, [ctypes.c_void_p, c_key, ctypes.c_int64]),
            ("zim_get", ctypes.c_int64, [ctypes.c_void_p, c_key]),
            ("zim_del", ctypes.c_int, [ctypes.c_void_p, c_key]),
            ("zim_size", ctypes.c_int64, [ctypes.c_void_p]),
            ("zim_put_many", ctypes.c_int,
             [ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_uint64]),
            ("zim_get_many", ctypes.c_int,
             [ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_uint64]),
        ):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        _lib = lib
        return _lib


def available() -> bool:
    """True when the store library builds and loads here."""
    return get_lib() is not None


def _require():
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native store library unavailable (g++ or zlib missing)")
    return lib


class NativeBlobStore:
    """Packed append-only blob log ``<directory>/blobs.log`` (see
    ``zebra_store.cpp``): records ``ZBL1`` | key | flags | lengths | CRC32 |
    payload, zlib level 1 where it shrinks the payload, tombstones on delete,
    a torn tail dropped on open, ``compact`` rewriting the live records."""

    def __init__(self, directory: str):
        self._lib = _require()
        self._h = self._lib.zs_open(directory.encode())
        if not self._h:
            raise RuntimeError(f"failed to open blob log in {directory}")

    def put(self, key: bytes, data: bytes, compress: bool = True) -> None:
        assert len(key) == 16
        if self._lib.zs_put(self._h, key, data, len(data), 1 if compress else 0) != 0:
            raise IOError("blob append failed")

    def get(self, key: bytes) -> bytes | None:
        n = self._lib.zs_get_len(self._h, key)
        if n < 0:
            return None
        buf = ctypes.create_string_buffer(max(int(n), 1))
        got = self._lib.zs_get(self._h, key, buf, max(int(n), 1))
        return None if got < 0 else buf.raw[:got]

    def delete(self, key: bytes) -> None:
        self._lib.zs_del(self._h, key)

    def flush(self) -> None:
        self._lib.zs_flush(self._h)

    def compact(self) -> None:
        self._lib.zs_compact(self._h)

    def __len__(self) -> int:
        return int(self._lib.zs_count(self._h))

    def close(self) -> None:
        if self._h:
            self._lib.zs_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeIdMap:
    """Flat open-addressing 16-byte-key -> int64 map (24 B an entry)."""

    def __init__(self, initial_cap: int = 1024):
        self._lib = _require()
        self._h = self._lib.zim_new(initial_cap)

    def put(self, key: bytes, value: int) -> None:
        self._lib.zim_put(self._h, key, value)

    def get(self, key: bytes) -> int | None:
        v = self._lib.zim_get(self._h, key)
        return None if v < 0 else int(v)

    def delete(self, key: bytes) -> bool:
        return self._lib.zim_del(self._h, key) == 0

    def put_many(self, keys: bytes, values) -> None:
        """``keys``: concatenated 16-byte ids; ``values``: int64 array."""
        v = np.ascontiguousarray(values, dtype=np.int64)
        self._lib.zim_put_many(self._h, keys, v.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                               len(keys) // 16)

    def get_many(self, keys: bytes) -> np.ndarray:
        """int64 values of the concatenated 16-byte ``keys`` (-1 where absent)."""
        out = np.empty(len(keys) // 16, dtype=np.int64)
        self._lib.zim_get_many(self._h, keys, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                               len(out))
        return out

    def __len__(self) -> int:
        return int(self._lib.zim_size(self._h))

    def __del__(self):
        try:
            if self._h:
                self._lib.zim_free(self._h)
                self._h = None
        except Exception:
            pass
