"""Small host-side helpers (the framework-free subset of ``zebra_tpu/utils.py``)."""

from __future__ import annotations

import os
import secrets
import threading
import time


def next_pow2(n: int) -> int:
    n = max(1, int(n))
    return 1 << (n - 1).bit_length()


def make_data(n: int, dim: int, seed: int = 0, n_clusters: int | None = None):
    """Clustered Gaussians ``[n, dim]`` f32, the data regime ANN recall
    targets describe: ``max(64, n // 100)`` centres, sigma 0.15. The same
    bytes as the JAX package's ``bench.make_data`` for the same arguments
    (one numpy generator, the same draws in the same order)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_clusters = n_clusters or max(64, n // 100)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    out = np.empty((n, dim), dtype=np.float32)
    step = 200_000
    for s in range(0, n, step):
        e = min(n, s + step)
        assign = rng.integers(0, n_clusters, e - s)
        out[s:e] = centers[assign] + 0.15 * rng.standard_normal((e - s, dim)).astype(np.float32)
    return out


def device_sync() -> None:
    """Wait for every queued kernel on the current CUDA device (no-op
    without CUDA). Timing code calls it before reading a host clock."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Stopwatch:
    """Wall-clock timer for the CLI's reports."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def pretty(self) -> str:
        s = self.elapsed()
        if s < 1e-3:
            return f"{s * 1e6:.0f}µs"
        if s < 1:
            return f"{s * 1e3:.1f}ms"
        if s < 60:
            return f"{s:.2f}s"
        m, sec = divmod(s, 60.0)
        return f"{int(m)}m {sec:.1f}s"


def uuid7_bytes() -> bytes:
    """Time-ordered 16-byte id (UUIDv7 layout), as ``zebra_tpu.utils``."""
    ms = time.time_ns() // 1_000_000
    rand = secrets.token_bytes(10)
    b = bytearray(16)
    b[0:6] = ms.to_bytes(6, "big")
    b[6] = 0x70 | (rand[0] & 0x0F)
    b[7] = rand[1]
    b[8] = 0x80 | (rand[2] & 0x3F)
    b[9:16] = rand[3:10]
    return bytes(b)


def uuid7_batch(n: int) -> list[bytes]:
    """Vectorised :func:`uuid7_bytes`, MONOTONE within the batch: the 12-bit
    rand_a field carries a sequence counter that overflows into the
    millisecond timestamp every 4096 ids, so byte order equals insert order."""
    import numpy as np

    if n <= 0:
        return []
    ms = time.time_ns() // 1_000_000
    seq = np.arange(n, dtype=np.int64)
    ms_i = ms + (seq >> 12)
    ctr = (seq & 0xFFF).astype(np.uint16)
    arr = np.empty((n, 16), dtype=np.uint8)
    for b in range(6):  # big-endian 48-bit ms per row
        arr[:, b] = ((ms_i >> (8 * (5 - b))) & 0xFF).astype(np.uint8)
    rand = np.frombuffer(secrets.token_bytes(8 * n), dtype=np.uint8).reshape(n, 8)
    arr[:, 6] = 0x70 | (ctr >> 8).astype(np.uint8)
    arr[:, 7] = (ctr & 0xFF).astype(np.uint8)
    arr[:, 8] = 0x80 | (rand[:, 0] & 0x3F)
    arr[:, 9:16] = rand[:, 1:8]
    flat = arr.tobytes()
    return [flat[i * 16 : (i + 1) * 16] for i in range(n)]


def uuid_hex(b: bytes) -> str:
    return b.hex()


def fsync_write(path: str, data: bytes) -> None:
    """Write + flush + fsync, then an atomic rename and a directory fsync."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dfd = os.open(os.path.dirname(os.path.abspath(path)) or ".", os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


class RWLock:
    """Reader-writer lock: queries share, mutations exclude.

    Writers are re-entrant and preferred over new readers; a thread holding
    the write lock may enter read sections (treated as nested writes).
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer: int | None = None
        self._depth = 0
        self._waiting_writers = 0

    def acquire_read(self) -> None:
        me = threading.get_ident()
        with self._cond:
            if self._writer == me:  # nested under our own write lock
                self._depth += 1
                return
            while self._writer is not None or self._waiting_writers:
                self._cond.wait()
            self._readers += 1

    def release_read(self) -> None:
        with self._cond:
            if self._writer == threading.get_ident():
                self._depth -= 1
                return
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self) -> None:
        me = threading.get_ident()
        with self._cond:
            if self._writer == me:
                self._depth += 1
                return
            self._waiting_writers += 1
            try:
                while self._writer is not None or self._readers:
                    self._cond.wait()
            finally:
                self._waiting_writers -= 1
            self._writer = me
            self._depth = 1

    def release_write(self) -> None:
        with self._cond:
            self._depth -= 1
            if self._depth == 0:
                self._writer = None
                self._cond.notify_all()

    def read(self):
        return _LockCtx(self.acquire_read, self.release_read)

    def write(self):
        return _LockCtx(self.acquire_write, self.release_write)


class _LockCtx:
    __slots__ = ("_enter", "_exit")

    def __init__(self, enter, exit):
        self._enter = enter
        self._exit = exit

    def __enter__(self):
        self._enter()

    def __exit__(self, *exc):
        self._exit()
