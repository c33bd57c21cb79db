"""Host orchestration shared by index backends (port of the subset of
``zebra_tpu/index/base.py`` the facade uses).

Owns id <-> slot maps, insert batching, result formatting and the snapshot
format (``index.json`` meta + ``arrays.npz``, the same files the JAX package
writes). Inserts run span by span with no pipelining yet (ROADMAP.md queue 1,
pipelined staging).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from zebra_tpu_torch.config import IndexOptions
from zebra_tpu_torch.utils import fsync_write, next_pow2, uuid7_batch

#: insert span width (vectors per device insert)
BATCH = 65536

_ZERO_ID = b"\x00" * 16


def default_device() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


class SlotIdArena:
    """slot -> 16-byte id in one ``np.uint8 [cap, 16]`` array; the all-zero
    row means an empty or dead slot."""

    __slots__ = ("_arr", "_hi")

    def __init__(self, cap: int = 0):
        self._arr = np.zeros((next_pow2(max(cap, 16)), 16), np.uint8)
        #: 1 + highest slot ever written (the logical arena length)
        self._hi = 0

    def _ensure(self, top: int) -> None:
        if top > self._arr.shape[0]:
            new = np.zeros((next_pow2(top), 16), np.uint8)
            new[: self._hi] = self._arr[: self._hi]
            self._arr = new
        if top > self._hi:
            self._hi = top

    def set_many(self, slots: np.ndarray, ids: list[bytes]) -> None:
        if not len(ids):
            return
        slots = np.asarray(slots, dtype=np.int64)
        self._ensure(int(slots.max()) + 1)
        self._arr[slots] = np.frombuffer(b"".join(ids), np.uint8).reshape(-1, 16)

    def clear_slot(self, slot: int) -> None:
        if slot < self._hi:
            self._arr[slot] = 0

    def take_list(self, slots: np.ndarray) -> list[bytes]:
        flat = self._arr[np.asarray(slots, dtype=np.int64)].tobytes()
        return [flat[o : o + 16] for o in range(0, len(flat), 16)]

    def bulk_bytes(self, slots: np.ndarray) -> bytes:
        return self._arr[np.asarray(slots, dtype=np.int64)].tobytes()

    def live_slots(self) -> np.ndarray:
        """Ascending slots holding a non-empty id."""
        return np.nonzero(self._arr[: self._hi].any(axis=1))[0]

    def to_array(self) -> np.ndarray:
        return self._arr[: self._hi]

    @classmethod
    def from_array(cls, arr: np.ndarray) -> "SlotIdArena":
        a = cls(arr.shape[0])
        a._arr[: arr.shape[0]] = arr
        a._hi = arr.shape[0]
        return a


class IdSlotMap:
    """id (16 bytes) -> slot (the JAX package's dict path; its native C++
    table is not ported)."""

    def __init__(self):
        self._dict: dict[bytes, int] = {}

    def __len__(self) -> int:
        return len(self._dict)

    def __contains__(self, key: bytes) -> bool:
        return key in self._dict

    def put_many(self, ids: list[bytes], slots) -> None:
        self._dict.update(zip(ids, np.asarray(slots).tolist()))

    def pop(self, key: bytes, default=None):
        return self._dict.pop(key, default)


class BaseVectorIndex:
    """Host-side index facade: id maps, batching, persistence.

    Subclasses implement ``_fresh_state``, ``_stage_span``,
    ``_insert_batch_dev``, ``_resolve_failed``, ``_delete_slots_device``,
    ``_query_device``, ``_snapshot_arrays`` and ``_restore_arrays``.
    """

    _BACKEND: str | None = None

    def __init__(self, dim: int, metric: str = "cosine", options: IndexOptions | None = None,
                 metric_power: float = 3.0, device: str | torch.device | None = None):
        self.dim = int(dim)
        self.metric = metric
        self.metric_power = float(metric_power)
        self.device = torch.device(device or default_device())
        options = options or IndexOptions()
        #: what the caller asked for — snapshots persist it, so every opening
        #: process re-resolves the re-rank for its own device
        self._given_rerank = options.rerank
        self.options = options.concrete(self.dim, index_type=self._BACKEND,
                                        device=self.device.type)
        self.state = None
        self._slot_ids = SlotIdArena()
        self._id_to_slot = IdSlotMap()
        self._built_n = 0
        self._rng = np.random.default_rng(self.options.seed)
        #: host-quantised parts row-aligned with the current add() (WAL replay)
        self._prequant = None
        #: per-span write-ahead hook of the current add(): ``wal_cb(span,
        #: parts)``, called after the span is quantised and before its insert
        self._wal_cb = None
        self._span_rows = None

    # -- introspection --------------------------------------------------------

    def __len__(self) -> int:
        return len(self._id_to_slot)

    def __contains__(self, doc_id: bytes) -> bool:
        return doc_id in self._id_to_slot

    def no_vectors(self) -> bool:
        return len(self._id_to_slot) == 0

    # -- insert ---------------------------------------------------------------

    def add(self, vectors: np.ndarray, ids: list[bytes] | None = None, prequant=None,
            wal_cb=None, span_rows: int | None = None) -> list[bytes]:
        """Insert vectors; returns their ids (the first call builds).

        ``prequant``: host-quantised ``(v8, r8, scale, rscale)`` row-aligned
        with ``vectors`` (WAL replay feeds the logged codes back unchanged).
        ``wal_cb``: per-span write-ahead hook. ``span_rows``: span width
        (None = :data:`BATCH`).
        """
        vectors = np.asarray(vectors)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        if vectors.shape[-1] != self.dim:
            raise ValueError(f"expected dim {self.dim}, got {vectors.shape[-1]}")
        n = vectors.shape[0]
        if n == 0:
            return []
        if ids is None:
            ids = uuid7_batch(n)
        else:
            if len(ids) != n:
                raise ValueError("ids/vectors length mismatch")
            seen = set()
            for i in ids:
                if not isinstance(i, (bytes, bytearray)) or len(i) != 16:
                    raise ValueError("ids must be 16-byte bytes values")
                if i == _ZERO_ID:
                    raise ValueError("the all-zero id is reserved")
                if i in seen or i in self._id_to_slot:
                    raise ValueError(f"duplicate id: {bytes(i).hex()}")
                seen.add(bytes(i))
        self._prequant = prequant
        self._wal_cb = wal_cb
        self._span_rows = span_rows
        try:
            if self.state is None:
                self._built_n = n
                if self._cold_build(vectors, ids):
                    return ids
                self.state = self._fresh_state(n, vectors)
            self._insert_batches(vectors, ids)
            return ids
        finally:
            self._prequant = None
            self._wal_cb = None
            self._span_rows = None

    def _cold_build(self, vectors, ids) -> bool:
        """First-build hook: return True when the build and insert completed
        here; False to take the generic path."""
        return False

    def _spans(self, n: int) -> list[tuple[int, int]]:
        w = int(self._span_rows) if self._span_rows else BATCH
        return [(s, min(n - s, w)) for s in range(0, n, w)]

    def _insert_batches(self, vectors, ids: list[bytes], staged=None) -> None:
        """Stage and insert span by span; ``staged`` optionally holds spans
        already staged (cold build)."""
        for i, span in enumerate(self._spans(vectors.shape[0])):
            start, count = span
            batch = staged[i] if staged is not None and i < len(staged) else None
            if batch is None:
                batch = self._stage_span(vectors, span)
            slots = self._insert_batch_dev(batch)
            failed = slots < 0
            if failed.any():
                rows = np.asarray(vectors[start : start + count][failed], np.float32)
                slots[failed] = self._resolve_failed(rows)
            self._register_slots(ids[start : start + count], slots)

    def _register_slots(self, ids: list[bytes], slots: np.ndarray) -> None:
        self._slot_ids.set_many(slots, ids)
        self._id_to_slot.put_many(ids, slots)

    # -- delete / clear ---------------------------------------------------------

    def remove(self, ids: list[bytes]) -> list[bytes]:
        """Tombstone ids; returns those actually removed."""
        if self.state is None:
            return []
        slots, removed = [], []
        for i in ids:
            s = self._id_to_slot.pop(i, None)
            if s is not None:
                slots.append(s)
                self._slot_ids.clear_slot(s)
                removed.append(i)
        if slots:
            self._delete_slots_device(np.asarray(slots, np.int64))
        return removed

    def clear(self) -> None:
        self.state = None
        self._slot_ids = SlotIdArena()
        self._id_to_slot = IdSlotMap()
        self._built_n = 0

    # -- search -----------------------------------------------------------------

    def search(self, queries: np.ndarray, k: int, exact: bool = False):
        """Per-query ``[(id, distance), ...]`` sorted ascending."""
        if self.state is None or not self._id_to_slot:
            q = np.asarray(queries)
            return [[] for _ in range(1 if q.ndim == 1 else q.shape[0])]
        return self._format_results(*self.search_arrays(queries, k, exact=exact))

    def search_arrays(self, queries: np.ndarray, k: int, exact: bool = False):
        """``(dists [B, k] f32, slots [B, k] int64, valid [B, k])`` as numpy."""
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        qt = torch.from_numpy(np.ascontiguousarray(q)).to(self.device)
        if self.options.query_wire_is_bf16():
            qt = qt.to(torch.bfloat16).float()  # the half-width query wire's rounding
        d, s, v = self._query_device(qt, k, exact)
        return d.cpu().numpy(), s.cpu().numpy(), v.cpu().numpy()

    def _format_results(self, dists, slots, valid):
        """(dists, slots, valid) -> per-query [(id, distance), ...] with one
        vectorised arena gather for the whole batch."""
        B, k = dists.shape
        flat = self._slot_ids.bulk_bytes(np.clip(slots, 0, None).ravel())
        idl = np.frombuffer(flat, dtype="V16").tolist()
        dl = dists.tolist()
        if valid.all():
            return [list(zip(idl[b * k : (b + 1) * k], dl[b])) for b in range(B)]
        vl = valid.tolist()
        return [
            [(idl[b * k + j], dl[b][j]) for j in range(k) if vl[b][j]]
            for b in range(B)
        ]

    # -- persistence --------------------------------------------------------------

    def save(self, directory: str) -> None:
        """Snapshot to ``directory``: ``index.json`` + ``arrays.npz`` (fsync'd)."""
        from zebra_tpu_torch.storage.snapshots import write_npz_streamed

        os.makedirs(directory, exist_ok=True)
        options = dataclasses.replace(self.options, rerank=self._given_rerank)
        meta = {
            "dim": self.dim,
            "metric": self.metric,
            "metric_power": self.metric_power,
            "options": options.to_json(),
            "built_n": self._built_n,
            "has_state": self.state is not None,
            "backend": type(self).__name__,
            "snapshot_format": "npz",
        }
        fsync_write(os.path.join(directory, "index.json"), json.dumps(meta).encode())
        if self.state is not None:
            arrays = {"slot_ids": self._slot_ids.to_array().copy(), **self._snapshot_arrays()}
            write_npz_streamed(os.path.join(directory, "arrays.npz"), arrays)

    @classmethod
    def load(cls, directory: str, device=None):
        from zebra_tpu_torch.storage.snapshots import open_snapshot_arrays

        with open(os.path.join(directory, "index.json"), "rb") as f:
            meta = json.loads(f.read())
        idx = cls(dim=meta["dim"], metric=meta["metric"],
                  options=IndexOptions.from_json(meta["options"]),
                  metric_power=meta.get("metric_power", 3.0), device=device)
        idx._built_n = meta.get("built_n", 0)
        if not meta.get("has_state"):
            return idx
        with open_snapshot_arrays(directory, meta) as z:
            idx._restore_arrays(z)
            ids_arr = np.array(z["slot_ids"])
        valid = idx.state.valid.cpu().numpy()
        # scrub ids saved for tombstoned slots (non-empty id == live)
        has_id = ids_arr.any(axis=1)
        vpad = np.zeros(ids_arr.shape[0], dtype=bool)
        vpad[: len(valid)] = valid[: ids_arr.shape[0]]
        ids_arr[has_id & ~vpad] = 0
        idx._slot_ids = SlotIdArena.from_array(ids_arr)
        live = idx._slot_ids.live_slots()
        idx._id_to_slot.put_many(idx._slot_ids.take_list(live), live)
        return idx
