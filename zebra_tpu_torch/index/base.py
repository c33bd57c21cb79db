"""Host orchestration shared by index backends (port of the subset of
``zebra_tpu/index/base.py`` the facade uses).

Owns id <-> slot maps, the pipelined insert, the pipelined query surface
(``search_submit`` / ``search_collect`` / ``search_stream``), result
formatting, deduplication, the rebuild logic (a backend's
``_rebuild_reason`` checked after every add and remove: a bare index
rebuilds inline, one under ``defer_rebuild`` records the reason for its
owner's background retrain), the shadow protocol of that retrain
(``_clone_empty`` ... ``_adopt``), snapshot captures (``snapshot_capture``,
``write_capture``) and the snapshot format (``index.json`` meta +
``arrays.npz``, the same files the JAX package writes).

Where the JAX package relies on asynchronous dispatch, the port orders its
copies with CUDA streams and events: host data goes through pinned buffers
and ``non_blocking`` copies on a side stream for each direction, the device
work stays on the current stream (every mutation and every kernel launch
runs there, so a query queued before a mutation reads the state before it),
and the current stream waits on a copy's event only where it consumes the
copy. On CPU tensors the same code runs with synchronous copies and no
pinning.

JAX updates the state functionally (an insert donates the old buffers); the
port writes it in place. So every capture a background worker takes under
the read lock is a COPY queued on the current stream before the lock is
released (a gather, ``clone``): the next in-place write can only be queued
after the write lock is taken, so the device runs it after the copy. A
slice would be a view and would read later writes.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os

import numpy as np
import torch

from zebra_tpu_torch.config import IndexOptions
from zebra_tpu_torch.ops import distances as D
from zebra_tpu_torch.profiling import timed
from zebra_tpu_torch.storage import snapshots as _snap
from zebra_tpu_torch.storage.snapshots import DEVICE_MEMBERS, member_nbytes
from zebra_tpu_torch.utils import fsync_write, next_pow2, uuid7_batch

#: insert span width (vectors per device insert)
BATCH = 65536
#: smallest padded span the JAX package stages (slab reservations follow it)
_MIN_BATCH = 256

_ZERO_ID = b"\x00" * 16
#: pinned host buffers an index stages insert spans through, reused in turn
_RING_SLOTS = 3
#: byte alignment of the parts packed into one staging buffer
_ALIGN = 16
#: what saving an orbax snapshot raises: orbax checkpoints are a JAX-library
#: format (``zebra_tpu/storage/orbax_snap.py``) the port neither reads nor
#: writes; the JAX package raises an ImportError that names the npz format
#: where orbax is missing
ORBAX_UNAVAILABLE = (
    "snapshot_format='orbax' requires the optional dependency orbax-checkpoint, "
    "which the torch port does not use (a JAX-library format); use the default "
    "snapshot_format='npz' otherwise"
)
#: device bytes ``snapshot_capture(clone=True)`` may copy; past it the
#: capture is refused (``cloned: False``) and the fold streams chunks
_CLONE_HBM_BUDGET = 4 << 30


def default_device() -> str:
    """The device an index lives on when the caller names none: the CUDA
    card. Raises when there is none, rather than running on the CPU
    unasked."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the card unless asked "
            "otherwise; pass device='cpu' for a CPU run"
        )
    return "cuda"


@dataclasses.dataclass
class Staged:
    """One span or query batch on the device: its tensor (or tuple of
    tensors) and the event of the copy that fills it (None for a CPU tensor
    or a slice of device rows). Consumers call ``BaseVectorIndex._ready``."""

    parts: object
    event: object = None


class PinnedRing:
    """A few pinned host buffers handed out in turn. A buffer is handed out
    again only after the copy that last read it has completed (its event),
    so the pinned memory of a long insert stays at a few spans."""

    def __init__(self, slots: int = _RING_SLOTS):
        self._bufs: list = [None] * slots
        self._events: list = [None] * slots
        self._next = 0

    def take(self, nbytes: int) -> tuple[torch.Tensor, int]:
        """``(pinned uint8 buffer of nbytes, its ring index)``; blocks until
        the buffer's previous copy has completed."""
        i = self._next
        self._next = (i + 1) % len(self._bufs)
        if self._events[i] is not None:
            self._events[i].synchronize()
            self._events[i] = None
        if self._bufs[i] is None or self._bufs[i].numel() < nbytes:
            self._bufs[i] = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        return self._bufs[i][:nbytes], i

    def done(self, i: int, event) -> None:
        """The copy reading buffer ``i`` was queued; ``event`` follows it."""
        self._events[i] = event


def _layout(parts) -> tuple[list[int], int]:
    """Byte offsets of ``[(shape, dtype), ...]`` packed into one buffer, each
    aligned to :data:`_ALIGN`, and the buffer's size."""
    offs, o = [], 0
    for shape, dt in parts:
        offs.append(o)
        o += -(-math.prod(shape) * dt.itemsize // _ALIGN) * _ALIGN
    return offs, max(o, _ALIGN)


def _views(buf: torch.Tensor, parts, offs) -> list[torch.Tensor]:
    """Typed views of the parts laid out in the uint8 buffer ``buf``."""
    return [buf[o : o + math.prod(shape) * dt.itemsize].view(dt).view(shape)
            for (shape, dt), o in zip(parts, offs)]


def _pack_results(d: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``(dists f32, slots, valid)`` as ONE ``[B, 2k]`` int32 tensor, so a
    query batch comes back in one device -> host copy: the distance bits
    beside the slots, -1 where invalid (the JAX package's ``_pack_results``)."""
    bits = d.float().contiguous().view(torch.int32)
    return torch.cat([bits, torch.where(v, s, -1).to(torch.int32)], 1)


def _unpack_results(packed: np.ndarray, nq: int, k: int):
    """``(dists [nq, k] f32, slots [nq, k] int64, valid [nq, k])`` of a
    packed readback, copied out of it."""
    d = np.ascontiguousarray(packed[:nq, :k]).view(np.float32)
    s = packed[:nq, k : 2 * k].astype(np.int64)
    return d, s, s >= 0


def read_meta(directory: str) -> dict:
    """A snapshot's ``index.json``."""
    with open(os.path.join(directory, "index.json"), "rb") as f:
        return json.loads(f.read())


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

    def get(self, slot: int) -> bytes:
        """Id at ``slot`` (b"" for an empty, dead or out-of-range slot)."""
        if slot < 0 or slot >= self._hi:
            return b""
        raw = self._arr[slot].tobytes()
        return b"" if raw == _ZERO_ID else raw

    def take_list(self, slots: np.ndarray) -> list[bytes]:
        flat = self._arr[np.asarray(slots, dtype=np.int64)].tobytes()
        return [flat[o : o + 16] for o in range(0, len(flat), 16)]

    def rows(self, slots: np.ndarray) -> np.ndarray:
        """``[m, 16]`` uint8 id rows of an int slot array."""
        return self._arr[np.asarray(slots, dtype=np.int64)]

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
    """id (16 bytes) -> slot, backed by the native C++ open-addressing table
    when it builds (24 B an entry, bulk puts; ``native/zebra_store.cpp``),
    with a plain dict otherwise, as in the JAX package. Iteration is not
    offered: the live set is always recoverable from ``_slot_ids``."""

    def __init__(self):
        from zebra_tpu_torch import native

        self._native = native.NativeIdMap(4096) if native.available() else None
        self._dict: dict[bytes, int] | None = None if self._native is not None else {}

    def __len__(self) -> int:
        return len(self._native) if self._native is not None else len(self._dict)

    def __contains__(self, key: bytes) -> bool:
        return self.get(key) is not None

    def get(self, key: bytes):
        if self._native is not None:
            return self._native.get(bytes(key))
        return self._dict.get(key)

    def put_many(self, ids: list[bytes], slots) -> None:
        if self._native is not None:
            self._native.put_many(b"".join(ids), np.asarray(slots))
        else:
            self._dict.update(zip(ids, np.asarray(slots).tolist()))

    def pop(self, key: bytes, default=None):
        if self._native is None:
            return self._dict.pop(key, default)
        v = self._native.get(bytes(key))
        if v is None:
            return default
        self._native.delete(bytes(key))
        return v


def slab_to_np(vectors: torch.Tensor) -> np.ndarray:
    """Snapshot encoding of a slab: bf16 as raw uint16 bit patterns, any
    other type as f32."""
    if vectors.dtype == torch.bfloat16:
        return _snap._to_np(vectors)
    return vectors.detach().float().cpu().numpy()


def slab_from_np(arr: np.ndarray, dtype, device="cpu") -> torch.Tensor:
    """Inverse of :func:`slab_to_np` on ``device`` (f32 snapshots of a bf16
    slab too)."""
    return _snap.slab_from_np(arr, device, dtype)


class BaseVectorIndex:
    """Host-side index facade: id maps, batching, persistence.

    Subclasses implement ``_fresh_state``, ``_insert_batch_dev`` (slots as a
    device tensor, or as a host array where the host knows them),
    ``_resolve_failed``, ``_delete_slots_device``, ``_query_device``,
    ``_snapshot_arrays`` and ``_restore_arrays``; the array wire
    (``_stage_span``), ``_take_rows``, ``_row_hashes``, ``_valid_by_slot`` and
    ``_live_order_ids`` may be replaced (the sharded index does); the rebuild policy hooks
    (``_rebuild_reason``, ``_pre_rebuild``, ``_reset_alloc_mirrors``) and the
    snapshot meta hooks (``_meta_extra``, ``_apply_meta_extra``,
    ``_after_restore``) are optional.
    """

    _BACKEND: str | None = None

    def __init__(self, dim: int, metric: str = "cosine", options: IndexOptions | None = None,
                 metric_power: float = 3.0, device: str | torch.device | None = None):
        D.check_metric(metric)
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
        #: stored (device) width — a backend may pad it for kernel layout
        self._dev_dim = self.dim
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
        #: (host -> device, device -> host) copy streams, made at first use
        self._copy_streams = None
        #: pinned buffers of the insert pipeline, made at first use
        self._ring = None
        #: True: a mutation that finds a rebuild reason records it in
        #: ``_rebuild_wanted`` for the owner's background retrain (the
        #: Database facade sets it) instead of rebuilding inline
        self.defer_rebuild = False
        #: pending rebuild reason under ``defer_rebuild`` (None = none)
        self._rebuild_wanted: str | None = None
        #: bumped whenever slot -> row meaning changes wholesale (rebuild,
        #: adopt, clear); chunked captures and retrains abort on a change
        self._struct_gen = 0

    # -- introspection --------------------------------------------------------

    def __len__(self) -> int:
        return len(self._id_to_slot)

    def __contains__(self, doc_id: bytes) -> bool:
        return doc_id in self._id_to_slot

    def no_vectors(self) -> bool:
        return len(self._id_to_slot) == 0

    def no_tables(self) -> bool:
        return self.state is None

    def is_empty(self) -> bool:
        return self.no_vectors() or self.no_tables()

    def ids(self) -> list[bytes]:
        """All live ids, in slot order."""
        return self._slot_ids.take_list(self._slot_ids.live_slots())

    def stats(self) -> dict:
        if self.state is None:
            return {"vectors": 0, "built": False}
        return {"vectors": len(self._id_to_slot), "built": True}

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
                    self._maybe_rebuild()
                    return ids
                with timed("insert.coldstate", items=n):
                    self.state = self._fresh_state(n, vectors)
            self._before_batches(n)
            self._insert_batches(vectors, ids)
            self._maybe_rebuild()
            return ids
        finally:
            self._prequant = None
            self._wal_cb = None
            self._span_rows = None

    def _cold_build(self, vectors, ids) -> bool:
        """First-build hook: return True when the build and insert completed
        here; False to take the generic path."""
        return False

    def _before_batches(self, n: int) -> None:
        """Reserve capacity for an incoming run of ``n`` rows (optional)."""

    def _pad_dim(self, arr: np.ndarray) -> np.ndarray:
        """Host rows zero-padded to the stored width (f32)."""
        if arr.shape[-1] == self._dev_dim:
            return arr
        out = np.zeros((*arr.shape[:-1], self._dev_dim), dtype=np.float32)
        out[..., : arr.shape[-1]] = arr
        return out

    @property
    def dtype(self) -> torch.dtype:
        """The slab's element type."""
        return {"int8": torch.int8, "bfloat16": torch.bfloat16}.get(self.options.dtype,
                                                                     torch.float32)

    @property
    def _wire_dtype(self) -> torch.dtype:
        """Host -> device staging type of an array wire: bf16 for a bf16 slab
        and for plain int8 (quantised on the device from the bf16 rows), f32
        otherwise. Refined int8 reports f32 (as the JAX package does); its
        wire is host-quantised (``IVFIndex._quant_wire``)."""
        o = self.options
        if o.dtype == "bfloat16" or (o.dtype == "int8" and not o.refine_enabled()):
            return torch.bfloat16
        return torch.float32

    @property
    def _wal_codec(self) -> str:
        """Write-ahead record encoding: "bf16" where the wire is bf16 (lossless
        for what the index stores), else exact "f32"."""
        return "bf16" if self._wire_dtype == torch.bfloat16 else "f32"

    @property
    def _wire_row_bytes(self) -> int:
        """Host -> device bytes per staged row."""
        return self._dev_dim * self._wire_dtype.itemsize

    # -- staging ------------------------------------------------------------------

    def _streams(self):
        """The (host -> device, device -> host) side streams of the index's
        copies."""
        if self._copy_streams is None:
            self._copy_streams = (torch.cuda.Stream(self.device), torch.cuda.Stream(self.device))
        return self._copy_streams

    def _ship(self, parts, fill, ring: bool = False) -> Staged:
        """Fill one host buffer laid out as ``parts`` (``[(shape, dtype),
        ...]``; ``fill(views)`` writes the host data) and ship it to the
        device. On the card the buffer is pinned (from the index's
        :class:`PinnedRing` when ``ring``, else a fresh one), its copy runs
        ``non_blocking`` on the host -> device stream and the result carries
        the copy's event; the device buffer is recorded on the current
        stream, which consumes it, so the allocator keeps it until that
        stream's work is done. On the CPU the host buffer is the result."""
        offs, nbytes = _layout(parts)
        if self.device.type != "cuda":
            buf = torch.empty(nbytes, dtype=torch.uint8)
            views = _views(buf, parts, offs)
            fill(views)
            return Staged(views[0] if len(parts) == 1 else tuple(views))
        if ring:
            if self._ring is None:
                self._ring = PinnedRing()
            host, slot = self._ring.take(nbytes)
        else:
            host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        fill(_views(host, parts, offs))
        h2d = self._streams()[0]
        with torch.cuda.stream(h2d):
            dev = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
            dev.copy_(host, non_blocking=True)
            event = torch.cuda.Event()
            event.record(h2d)
        if ring:
            self._ring.done(slot, event)
        dev.record_stream(torch.cuda.current_stream(self.device))
        views = _views(dev, parts, offs)
        return Staged(views[0] if len(parts) == 1 else tuple(views), event)

    def _ready(self, staged: Staged):
        """The staged tensors, with the current stream ordered after their
        copy (the host does not wait) and recorded on it, so the allocator
        keeps their memory until the work queued here has read it also when
        the consuming thread's stream is not the one current at
        :meth:`_ship`."""
        if staged.event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(staged.event)
            parts = staged.parts if isinstance(staged.parts, tuple) else (staged.parts,)
            for t in parts:
                t.record_stream(stream)
        return staged.parts

    def _download(self, t):
        """Queue a copy of device tensor ``t`` into a fresh pinned buffer on
        the device -> host stream, after the work queued so far on the
        current stream. The handle holds ``t`` until :meth:`_fetch` (the
        allocator must not hand its memory to other work before the copy
        has read it). Host arrays and CPU tensors pass through."""
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            return (t, None, None)
        d2h = self._streams()[1]
        d2h.wait_stream(torch.cuda.current_stream(self.device))
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        with torch.cuda.stream(d2h):
            host.copy_(t, non_blocking=True)
            event = torch.cuda.Event()
            event.record(d2h)
        # a handle dropped before its fetch frees ``t``: the allocator must
        # not hand the block to other work while the copy still reads it
        t.record_stream(d2h)
        return (host, event, t)

    @staticmethod
    def _fetch(handle) -> np.ndarray:
        """Wait for a :meth:`_download` and return its host array (the
        caller copies out what it keeps: the pinned buffer is reused once
        the handle is dropped)."""
        host, event, _ = handle
        if event is not None:
            event.synchronize()
        return host.numpy() if isinstance(host, torch.Tensor) else np.asarray(host)

    def _stage_span(self, vectors, span) -> Staged:
        """One span on the device at the stored width: a slice of a device
        source (a rebuild's rows), or host rows zero-padded, cast to the wire
        type on the host and shipped through the pinned ring. A host span's
        f32 / bf16 write-ahead record is written after its copy is queued
        (the fsync overlaps the copy) and before its insert."""
        start, count = span
        if isinstance(vectors, torch.Tensor):
            return Staged(vectors[start : start + count])
        staged = self._ship_rows(vectors[start : start + count], self._wire_dtype, ring=True)
        if self._wal_cb is not None:
            self._wal_cb(span, None)
        return staged

    def _ship_rows(self, rows, dtype: torch.dtype, ring: bool = False) -> Staged:
        """Host rows zero-padded to the stored width, cast to ``dtype`` on
        the host and shipped (:meth:`_ship`)."""
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        if rows.ndim == 1:
            rows = rows[None, :]
        n, d = rows.shape

        def fill(views):
            out = views[0]
            out[:, :d].copy_(torch.from_numpy(rows))
            if self._dev_dim > d:
                out[:, d:].zero_()

        return self._ship([((n, self._dev_dim), dtype)], fill, ring)

    def _span_width(self) -> int:
        return int(self._span_rows) if self._span_rows else BATCH

    def _spans(self, n: int) -> list[tuple[int, int]]:
        w = self._span_width()
        return [(s, min(n - s, w)) for s in range(0, n, w)]

    def _insert_batches(self, vectors, ids: list[bytes], prestaged=None) -> None:
        """Pipelined insert (``zebra_tpu/index/base.py:692-752``): span t+1
        is staged while span t's insert runs on the device, and slots are
        read back two spans behind, so host work, copies and device work
        overlap. ``vectors`` is a host array or a device tensor already at
        the stored width (a rebuild's source); ``prestaged`` optionally holds
        spans already staged (the cold build's window; None entries are
        staged here)."""
        spans = self._spans(vectors.shape[0])

        def stage(i):
            if prestaged is not None and prestaged[i] is not None:
                return prestaged[i]
            with timed("insert.stage", items=spans[i][1]):
                return self._stage_span(vectors, spans[i])

        def resolve(span, handle):
            start, count = span
            with timed("insert.resolve", items=count):
                slots = self._fetch(handle)[:count].astype(np.int64)
            failed = slots < 0
            if failed.any():
                rows = np.asarray(vectors[start : start + count][failed], np.float32)
                slots[failed] = self._resolve_failed(rows)
            self._register_slots(ids[start : start + count], slots)

        inflight = []
        nxt = stage(0)
        for i, span in enumerate(spans):
            cur = nxt
            if i + 1 < len(spans):
                nxt = stage(i + 1)  # its copy overlaps this span's insert
            with timed("insert.dispatch", items=span[1]):
                inflight.append((span, self._download(self._insert_batch_dev(cur))))
            if prestaged is not None:
                prestaged[i] = None  # the staged span's memory goes with its insert
            if len(inflight) > 2:
                resolve(*inflight.pop(0))
        for item in inflight:
            resolve(*item)

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
            self._maybe_rebuild()
        return removed

    def deduplicate(self) -> list[bytes]:
        """Remove exact duplicate vectors, keeping the smallest id of each
        group; returns the removed ids."""
        return self.remove(self.find_duplicates())

    def find_duplicates(self) -> list[bytes]:
        """Ids of exact duplicate vectors (all but the smallest id of each
        group), without mutating, so that the facade can log the removal
        first (``zebra_tpu/index/base.py:776-816``). Rows hash on the device
        (two 32-bit keys a row, 8 bytes read back instead of the slab); only
        colliding groups gather their stored values for the host to confirm."""
        if self.state is None or not self._id_to_slot:
            return []
        slots = self._slot_ids.live_slots()
        keys = self._row_hashes(slots).astype(np.int64)
        keys = (keys[:, 0] << 32) ^ (keys[:, 1] & 0xFFFFFFFF)
        order = np.argsort(keys, kind="stable")  # slots ascending within ties
        ks = keys[order]
        group_start = np.concatenate([[True], ks[1:] != ks[:-1]])
        gid = np.cumsum(group_start) - 1
        in_collision = np.bincount(gid)[gid] > 1
        if not in_collision.any():
            return []
        sus = slots[order[in_collision]]  # ascending within each hash group
        sus_rows = self._take_rows(sus).float().cpu().numpy()
        view = np.ascontiguousarray(sus_rows).view(np.uint32).reshape(len(sus), -1)
        _, inv = np.unique(view, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        # the smallest id of each exact group stays: independent of the slot
        # layout and, uuid7 ids being monotone, the earliest inserted
        idrows = self._slot_ids.rows(sus)
        hi = np.ascontiguousarray(idrows[:, :8]).view(">u8")[:, 0]
        lo = np.ascontiguousarray(idrows[:, 8:]).view(">u8")[:, 0]
        order2 = np.lexsort((lo, hi, inv))  # group-major, id-minor
        inv_sorted = inv[order2]
        first = np.concatenate([[True], inv_sorted[1:] != inv_sorted[:-1]])
        return self._slot_ids.take_list(sus[order2[~first]])

    def _row_hashes(self, slots: np.ndarray) -> np.ndarray:
        """``[m, 2]`` int32 hashes of the stored rows at ``slots`` (computed
        on the device for the whole slab, read back as 8 bytes a row)."""
        from zebra_tpu_torch.ops.rowhash import row_hashes

        return row_hashes(self.state.vectors).cpu().numpy()[slots]

    def _take_rows(self, slots: np.ndarray) -> torch.Tensor:
        """Device gather of slab rows as stored values (int8 backends
        dequantise: codes without their scales do not compare across rows)."""
        return self.state.vectors[torch.as_tensor(np.asarray(slots, np.int64),
                                                  device=self.state.vectors.device)]

    def clear(self) -> None:
        self.state = None
        self._slot_ids = SlotIdArena()
        self._id_to_slot = IdSlotMap()
        self._built_n = 0
        self._rebuild_wanted = None
        self._struct_gen += 1

    # -- rebuild ----------------------------------------------------------------

    def _maybe_rebuild(self) -> None:
        """Growth / compaction policy after a mutation
        (``zebra_tpu/index/base.py:356-371``): the backend's
        :meth:`_rebuild_reason` names why; under ``defer_rebuild`` the
        reason is recorded for the owner's background retrain, else the
        rebuild runs inline when :meth:`_rebuild_admissible` lets it."""
        reason = self._rebuild_reason()
        if not reason:
            return
        if self.defer_rebuild:
            self._rebuild_wanted = reason
            return
        if self._rebuild_admissible(reason):
            self.rebuild(reason)

    def _rebuild_reason(self) -> str | None:
        """Why a rebuild is warranted right now (None = it isn't)."""
        return None

    def _rebuild_admissible(self, reason: str) -> bool:
        """Resource gate of an INLINE rebuild (a backend may refuse one whose
        transient would not fit the device)."""
        return True

    def _pre_rebuild(self, reason: str | None) -> None:
        """Policy hook run before a rebuild captures the live rows."""

    def _reset_alloc_mirrors(self) -> None:
        """Zero host-side slot-allocation mirrors (subclass hook)."""

    def rebuild(self, reason: str | None = None) -> None:
        """Re-place every live vector into fresh structures sized to the
        current population (compacts tombstones;
        ``zebra_tpu/index/base.py:382-416``), in the reference's order:
        capture (the live rows gathered on the device as stored values; the
        slab never goes through the host), free the old state, build the new
        one (trained on the captured rows), ingest the rows. Peak memory is
        the old state plus the live rows, then the live rows plus the new
        state (what ``_rebuild_peak_bytes`` counts)."""
        self._wal_cb = None  # re-inserted rows are already logged
        self._pre_rebuild(reason)
        with timed("rebuild.capture"):
            order, ids = self._live_order_ids()
            data = self._gather_live(order) if len(order) else None
        n = len(ids)
        self.state = None  # free the old structures before the new ones
        with timed("rebuild.state", items=n):
            self._shadow_begin(n, data)
        self._slot_ids = SlotIdArena()
        self._id_to_slot = IdSlotMap()
        self._reset_alloc_mirrors()
        self._rebuild_wanted = None
        self._struct_gen += 1  # slot -> row meaning changed wholesale
        if n:
            self._shadow_ingest(data, ids)

    # -- background retrain hooks (``zebra_tpu/index/base.py:418-502``) ----------
    #
    # The owner's retrain worker builds a SHADOW index with no lock held
    # (readers keep the live state) and swaps it in with _adopt under a
    # brief write lock:
    #   shadow = idx._clone_empty(); idx._prepare_shadow(shadow, reason)
    #   order, ids = idx._live_order_ids()            # under the read lock
    #   sample = idx._gather_live(order_subset)       # under the read lock
    #   shadow._shadow_begin(len(ids), sample)        # train, no lock
    #   for chunk: idx._gather_live(...) -> shadow._shadow_ingest(...)
    #   idx._adopt(shadow)                            # under the write lock
    # Each gather is a copy queued on the current stream under the read
    # lock, so it runs before any later in-place write (module docstring).

    #: extra instance fields _adopt copies beyond the base serving set
    _ADOPT_EXTRA: tuple = ()

    def _clone_empty(self):
        """A fresh empty index of this one's configuration on its device
        (with the re-rank the caller gave, so the stored width is the same)."""
        return type(self)(dim=self.dim, metric=self.metric,
                          options=dataclasses.replace(self.options, rerank=self._given_rerank),
                          metric_power=self.metric_power, device=self.device)

    def _prepare_shadow(self, shadow, reason: str | None) -> None:
        """Carry rebuild-policy state onto a shadow (subclass hook)."""

    def _live_order_ids(self):
        """(ascending live slots, their ids) — capture under a read lock."""
        order = self._slot_ids.live_slots()
        return order, self._slot_ids.take_list(order)

    def _gather_live(self, order) -> torch.Tensor:
        """Stored values of the rows at slots ``order`` (a device gather,
        i.e. a copy: call under a read lock)."""
        return self._take_rows(np.asarray(order, np.int64))

    def _train_sample_target(self, n: int) -> int:
        """Rows of training data :meth:`_shadow_begin` wants for ~n vectors."""
        return min(n, 65536)

    def _shadow_begin(self, n_total: int, sample) -> None:
        """Train and allocate fresh state sized for ``n_total`` vectors from
        the (possibly subsampled) device rows ``sample``."""
        self._built_n = max(n_total, 1)
        self.state = self._fresh_state(max(n_total, 1), sample)

    def _shadow_ingest(self, data, ids: list[bytes]) -> None:
        """Insert captured device rows into the fresh state."""
        self._before_batches(len(ids))
        self._insert_batches(data, ids)

    def _retrain_bg_peak_bytes(self, n_live: int, chunk_rows: int) -> int:
        """Device bytes a background retrain adds beside the serving state
        (0 = no concern)."""
        return 0

    def _state_hbm_bytes(self) -> int:
        """Device bytes of the serving state."""
        if self.state is None:
            return 0
        return sum(t.numel() * t.element_size() for t in vars(self.state).values()
                   if isinstance(t, torch.Tensor))

    def _adopt(self, shadow) -> None:
        """Swap the shadow's structures in as the serving state (call under
        the write lock; no device work)."""
        for f in ("state", "_slot_ids", "_id_to_slot", "_built_n") + self._ADOPT_EXTRA:
            setattr(self, f, getattr(shadow, f))
        self._rebuild_wanted = None
        self._struct_gen += 1

    def warm_serving_shapes(self, shapes) -> int:
        """The JAX package compiles the shadow's query program here before
        the swap; PyTorch compiles nothing ahead, so nothing is warmed."""
        return 0

    # -- search -----------------------------------------------------------------

    def search(self, queries: np.ndarray, k: int, exact: bool = False):
        """Per-query ``[(id, distance), ...]`` sorted ascending."""
        if self.state is None or not self._id_to_slot:
            q = np.asarray(queries)
            return [[] for _ in range(1 if q.ndim == 1 else q.shape[0])]
        return self._format_results(*self.search_arrays(queries, k, exact=exact))

    def search_arrays(self, queries: np.ndarray, k: int, exact: bool = False):
        """``(dists [B, k] f32, slots [B, k] int64, valid [B, k])`` as numpy."""
        return self.search_collect(self.search_submit(queries, k, exact))

    def search_submit(self, queries: np.ndarray, k: int, exact: bool = False):
        """Queue one query batch without waiting for it; returns a token for
        :meth:`search_collect`.

        The queries are padded and cast to the query wire on the host (bf16
        where ``query_wire_is_bf16``, as the JAX package ships them, else
        f32), staged through a pinned buffer and copied on the host -> device
        stream; the device query runs on the current stream after that copy,
        and its results, packed into one ``[B, 2k]`` int32 tensor, are copied
        into the token's own pinned buffer on the device -> host stream. On
        IVF nothing here waits for the device; LSH reads two values back
        mid-query (its candidate width and its re-rank's last step). The
        token holds the device tensors its copies read and the slot -> id
        map the query was answered from. Mutations between submit and
        collect run on the current stream after the queued query, so the
        token answers from the state as it was at submit, and
        :meth:`format_collect` names its slots with that map even when a
        rebuild or a retrain's swap replaced the index's map meanwhile."""
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        wire = torch.bfloat16 if self.options.query_wire_is_bf16() else torch.float32
        qt = self._ready(self._ship_rows(q, wire)).float()
        packed = _pack_results(*self._query_device(qt, k, exact))
        return self._download(packed), q.shape[0], k, self._slot_ids

    def search_collect(self, token):
        """Resolve a :meth:`search_submit` token into ``(dists [B, k], slots
        [B, k] int64, valid [B, k])``: one wait for its readback. Tokens may
        be collected in any order."""
        handle, nq, k, _ = token
        return _unpack_results(self._fetch(handle), nq, k)

    def format_collect(self, token):
        """:meth:`search`-formatted results of a :meth:`search_submit`
        token, its slots named by the slot -> id map it was answered from."""
        return self._format_results(*self.search_collect(token), arena=token[3])

    def search_stream(self, batches, k: int, exact: bool = False):
        """Yields :meth:`search`-formatted results per input batch, keeping
        one batch in flight: batch t+1 is submitted before batch t is
        collected, so its upload and device work overlap t's readback and
        formatting."""
        pending = None
        for batch in batches:
            tok = self.search_submit(batch, k, exact)
            if pending is not None:
                yield self.format_collect(pending)
            pending = tok
        if pending is not None:
            yield self.format_collect(pending)

    def _format_results(self, dists, slots, valid, arena: SlotIdArena | None = None):
        """(dists, slots, valid) -> per-query [(id, distance), ...] with one
        vectorised gather of ``arena`` (the index's map by default) for the
        whole batch."""
        B, k = dists.shape
        flat = (arena or self._slot_ids).bulk_bytes(np.clip(slots, 0, None).ravel())
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
        self.write_capture(directory, self.snapshot_capture())

    def snapshot_capture(self, clone: bool = False) -> dict:
        """A capture of the index for :meth:`write_capture`
        (``zebra_tpu/index/base.py:989-1047``): the meta, the host slot -> id
        map copied, and the state's tensors by reference, or with ``clone``
        as device copies (queued on the current stream: take the capture
        under at least the read lock, and the next in-place write runs after
        the copies). A cloned capture can be written with no lock held. A
        clone past ``_CLONE_HBM_BUDGET`` bytes is refused: ``cloned`` is
        then False and the tensors are the live ones."""
        options = dataclasses.replace(self.options, rerank=self._given_rerank)
        fmt = self.options.snapshot_format
        meta = {
            "dim": self.dim,
            "metric": self.metric,
            "metric_power": self.metric_power,
            "options": options.to_json(),
            "built_n": self._built_n,
            "has_state": self.state is not None,
            "backend": type(self).__name__,
            "snapshot_format": fmt,
            **self._meta_extra(),
        }
        arrays, cloned = None, True
        if self.state is not None:
            arrays = {"slot_ids": self._slot_ids.to_array().copy(), **self._snapshot_arrays()}
            if clone:
                dev = {k: v for k, v in arrays.items() if isinstance(v, DEVICE_MEMBERS)}
                if sum(member_nbytes(v) for v in dev.values()) <= _CLONE_HBM_BUDGET:
                    arrays.update({k: v.clone() for k, v in dev.items()})
                else:
                    cloned = False
        return {"meta": meta, "fmt": fmt, "arrays": arrays, "cloned": cloned}

    def write_capture(self, directory: str, cap: dict) -> None:
        """Write a :meth:`snapshot_capture` to ``directory`` (fsync'd; the
        arrays streamed in bounded chunks). Needs no lock for a cloned
        capture; a fetch raising ``CaptureAborted`` leaves no arrays file."""
        from zebra_tpu_torch.storage.snapshots import write_npz_streamed

        os.makedirs(directory, exist_ok=True)
        fsync_write(os.path.join(directory, "index.json"), json.dumps(cap["meta"]).encode())
        if cap["arrays"] is None:
            return
        if cap["fmt"] == "orbax":
            # the JAX package raises here where orbax is not installed
            # (``zebra_tpu/storage/orbax_snap.py:42-49``); the port never has it
            raise ImportError(ORBAX_UNAVAILABLE)
        write_npz_streamed(os.path.join(directory, "arrays.npz"), cap["arrays"])

    @classmethod
    def load(cls, directory: str, device=None):
        meta = read_meta(directory)
        idx = cls._construct_for_load(meta, device=device)
        idx._load_state(directory, meta)
        return idx

    @classmethod
    def _construct_for_load(cls, meta: dict, **ctor_kw):
        return cls(dim=meta["dim"], metric=meta["metric"],
                   options=IndexOptions.from_json(meta["options"]),
                   metric_power=meta.get("metric_power", 3.0), **ctor_kw)

    def _load_state(self, directory: str, meta: dict) -> None:
        """Restore a snapshot's state and maps into this fresh index."""
        from zebra_tpu_torch.storage.snapshots import open_snapshot_arrays

        self._built_n = meta.get("built_n", 0)
        self._apply_meta_extra(meta)
        if not meta.get("has_state"):
            return
        with open_snapshot_arrays(directory, meta) as z:
            self._restore_arrays(z)
            ids_arr = np.array(z["slot_ids"])
        valid = self._valid_by_slot()
        # scrub ids saved for tombstoned slots (non-empty id == live)
        has_id = ids_arr.any(axis=1)
        vpad = np.zeros(ids_arr.shape[0], dtype=bool)
        vpad[: len(valid)] = valid[: ids_arr.shape[0]]
        ids_arr[has_id & ~vpad] = 0
        self._slot_ids = SlotIdArena.from_array(ids_arr)
        live = self._slot_ids.live_slots()
        self._id_to_slot.put_many(self._slot_ids.take_list(live), live)
        self._after_restore()

    def _valid_by_slot(self) -> np.ndarray:
        """Liveness of the stored rows indexed by slot (load's id scrub)."""
        return self.state.valid.cpu().numpy()

    def _meta_extra(self) -> dict:
        """Extra snapshot metadata (subclass hook)."""
        return {}

    def _apply_meta_extra(self, meta: dict) -> None:
        """Restore :meth:`_meta_extra` fields on load (subclass hook)."""

    def _after_restore(self) -> None:
        """Post-load host-mirror fixups (subclass hook)."""
