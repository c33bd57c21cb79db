"""Append-only mutation log: O(batch) crash durability between snapshots.

A copy of ``zebra_tpu/storage/deltalog.py`` (numpy only, so both packages
read and write the same log); bf16 records convert with numpy bit
operations instead of ``ml_dtypes``.

The reference gets per-upsert durability for free from its LSM engine —
every ``insert`` fsyncs a fjall partition append (``src/database/index/
lsh.rs:87-89``). Our index snapshot is a single multi-GB array blob, so
re-snapshotting per mutation would be O(database); instead ``durability=
"full"`` appends each mutation here (O(batch), one fsync) and the database
replays the tail on open:

  open(): load last snapshot -> replay log records in order
  save(): write full snapshot -> reset the log

Record layout (little-endian):
  [magic u32][type u8][payload_len u64][crc32(payload) u32][payload]
Types: 1 = insert (n u32, dim u32, ids n*16B, vectors n*dim f32),
       2 = remove (n u32, ids n*16B),
       3 = insert-bf16 (same as 1 with vectors as bf16 bit patterns —
           half the log bytes; exact for bf16-slab databases, whose stored
           values are bf16-rounded anyway),
       4 = insert-q8 (n u32, dim u32, ids n*16B, v8 n*dim i8, r8 n*dim i8,
           scale n f32, rscale n f32 — the host-quantised pair the refined
           int8 tier ships on the wire AND stores: replay feeds the pair
           back through the quantised wire, so recovery is bitwise the
           crash-free slab at ~half the f32 log volume).
A torn tail (short read / CRC mismatch — e.g. crash mid-append) ends replay
and is truncated away, exactly like the native blob log's recovery
(``zebra_tpu/native/zebra_store.cpp``).

Replay is idempotent: the database filters already-present ids on insert and
remove of missing ids is a no-op — so a crash between snapshot write and log
reset only causes redundant (skipped) work, never corruption.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_MAGIC = 0x5A444C31  # "ZDL1"
_HDR = struct.Struct("<IBQI")  # magic, type, payload_len, crc32

INSERT = 1
REMOVE = 2
INSERT_BF16 = 3
INSERT_Q8 = 4


def _f32_to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 -> bf16 bit patterns, round to nearest even; every NaN becomes the
    quiet NaN of its sign (0x7FC0 / 0xFFC0), as ``ml_dtypes`` converts."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    rounded = (u + (np.uint32(0x7FFF) + ((u >> 16) & 1))) >> 16
    nan = np.isnan(u.view(np.float32))
    return np.where(nan, ((u >> 16) & 0x8000) | 0x7FC0, rounded).astype(np.uint16)


class DeltaLog:
    """Fsync-per-append mutation log for one database."""

    def __init__(self, path: str):
        self.path = path
        self._f = None

    # -- append ----------------------------------------------------------------

    def _file(self):
        if self._f is None or self._f.closed:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._f = open(self.path, "ab")
        return self._f

    def _append(self, rtype: int, payload: bytes) -> None:
        f = self._file()
        f.write(_HDR.pack(_MAGIC, rtype, len(payload), zlib.crc32(payload)))
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())

    def append_insert(
        self, ids: list[bytes], vectors: np.ndarray, bf16: bool = False
    ) -> None:
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        n, dim = vectors.shape
        if bf16:
            body = _f32_to_bf16_bits(vectors).tobytes()
            rtype = INSERT_BF16
        else:
            body = vectors.tobytes()
            rtype = INSERT
        payload = struct.pack("<II", n, dim) + b"".join(ids) + body
        self._append(rtype, payload)

    def append_insert_q8(
        self, ids: list[bytes], v8: np.ndarray, r8: np.ndarray,
        scale: np.ndarray, rscale: np.ndarray,
    ) -> None:
        n, dim = v8.shape
        payload = (
            struct.pack("<II", n, dim)
            + b"".join(ids)
            + np.ascontiguousarray(v8, dtype=np.int8).tobytes()
            + np.ascontiguousarray(r8, dtype=np.int8).tobytes()
            + np.ascontiguousarray(scale, dtype=np.float32).tobytes()
            + np.ascontiguousarray(rscale, dtype=np.float32).tobytes()
        )
        self._append(INSERT_Q8, payload)

    def append_remove(self, ids: list[bytes]) -> None:
        if not ids:
            return
        payload = struct.pack("<II", len(ids), 0) + b"".join(ids)
        self._append(REMOVE, payload)

    # -- replay ------------------------------------------------------------------

    def replay(self):
        """Yield ``("insert", ids, vectors)`` / ``("remove", ids, None)`` /
        ``("insert_q8", ids, (v8, r8, scale, rscale))`` in append order;
        truncates a torn tail in place."""
        if not os.path.exists(self.path):
            return
        good_end = 0
        with open(self.path, "rb") as f:
            data = f.read()
        off = 0
        records = []
        while off + _HDR.size <= len(data):
            magic, rtype, plen, crc = _HDR.unpack_from(data, off)
            if magic != _MAGIC or off + _HDR.size + plen > len(data):
                break
            payload = data[off + _HDR.size : off + _HDR.size + plen]
            if zlib.crc32(payload) != crc:
                break
            off += _HDR.size + plen
            good_end = off
            records.append((rtype, payload))
        if good_end < len(data):
            self.close()
            with open(self.path, "r+b") as f:
                f.truncate(good_end)
                f.flush()
                os.fsync(f.fileno())
        for rtype, payload in records:
            n, dim = struct.unpack_from("<II", payload)
            ids = [bytes(payload[8 + 16 * i : 24 + 16 * i]) for i in range(n)]
            if rtype == INSERT:
                vecs = np.frombuffer(payload, dtype=np.float32, offset=8 + 16 * n)
                yield "insert", ids, vecs.reshape(n, dim).copy()
            elif rtype == INSERT_BF16:
                bits = np.frombuffer(payload, dtype=np.uint16, offset=8 + 16 * n)
                vecs = (bits.astype(np.uint32) << 16).view(np.float32)
                yield "insert", ids, vecs.reshape(n, dim).copy()
            elif rtype == INSERT_Q8:
                off = 8 + 16 * n
                v8 = np.frombuffer(payload, np.int8, n * dim, off).reshape(n, dim)
                off += n * dim
                r8 = np.frombuffer(payload, np.int8, n * dim, off).reshape(n, dim)
                off += n * dim
                scale = np.frombuffer(payload, np.float32, n, off)
                rscale = np.frombuffer(payload, np.float32, n, off + 4 * n)
                yield "insert_q8", ids, (
                    v8.copy(), r8.copy(), scale.copy(), rscale.copy()
                )
            else:
                yield "remove", ids, None

    # -- lifecycle ----------------------------------------------------------------

    def size(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def reset(self) -> None:
        """Empty the log (after a successful full snapshot)."""
        self.close()
        if os.path.exists(self.path):
            with open(self.path, "r+b") as f:
                f.truncate(0)
                f.flush()
                os.fsync(f.fileno())

    def truncate_prefix(self, offset: int) -> None:
        """Drop the first ``offset`` bytes (now covered by a snapshot),
        keeping the tail — the background log fold's commit step: mutations
        appended WHILE the fold streamed its capture to disk land past
        ``offset`` and must survive (round-3 verdict #7). ``offset`` must be
        a record boundary (a ``size()`` taken while appends were excluded).

        Crash-safe: the tail is written to a sibling file, fsync'd, then
        atomically renamed over the log. A crash before the rename leaves
        the full log (replay is idempotent — records before ``offset`` are
        already in the snapshot and re-apply as no-ops)."""
        if offset <= 0:
            return
        self.close()
        if not os.path.exists(self.path) or offset >= os.path.getsize(self.path):
            self.reset()
            return
        tmp = self.path + ".fold"
        with open(self.path, "rb") as src, open(tmp, "wb") as dst:
            src.seek(offset)
            while True:
                chunk = src.read(1 << 24)
                if not chunk:
                    break
                dst.write(chunk)
            dst.flush()
            os.fsync(dst.fileno())
        os.replace(tmp, self.path)
        dirfd = os.open(os.path.dirname(self.path) or ".", os.O_RDONLY)
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)

    def close(self) -> None:
        if self._f is not None and not self._f.closed:
            self._f.close()
        self._f = None
