"""Database facade of the torch port (port of ``zebra_tpu/db.py``): index,
embedding model, document blobs and manifest.

The same manifest (``<path>``), index snapshot (``<path>.d/index/``),
write-ahead log (``<path>.d/delta.log``) and document store
(``<path>.d/<uuid hex>/``: the native packed blob log, or one compressed file
per document) as the JAX package, so a database written by one package opens
in the other. With ``durability="full"`` (the default) an insert stores its
documents' blobs first, then logs every span as an fsync'd record before the
index mutation runs (q8 for the refined int8 tier, bf16 where the wire is
bf16 — the bf16 slab and plain int8 —, f32 otherwise); every remove is logged
before it tombstones and then drops the removed ids' blobs; ``open`` replays
the log onto the last snapshot (idempotent by id). ``query_stream`` keeps one
batch in flight (each submit under the read lock, collects lock-free);
``deduplicate`` finds exact duplicates, logs their removal, then removes
them and their blobs; ``stats`` holds the facade's stage timers. The
embedding model runs on the database's device (``models.get_model``).

Two background workers keep a growing database the shape it was built for,
as the JAX package's facade does (``zebra_tpu/db.py:394-816``):

* the log fold: once the log outgrows ``_fold_threshold`` (at least
  ``_fold_floor``, 256 MiB), a thread captures the index under the read lock
  (device copies, or chunks copied under brief read locks past the clone
  budget), streams it to disk with no lock held, then under the write lock
  swaps the snapshot in and drops the log prefix it covers;
* the retrain: the index defers its rebuilds (``defer_rebuild``); a thread
  builds a shadow index from chunked captures of the live rows with no lock
  held, replays the mutations journaled meanwhile, and swaps it in with
  ``_adopt`` under the write lock. A "-critical" reason blocks the mutating
  call (with no lock held) until the rebalance lands.

Both run their device work on the current stream of their thread (the
device's default stream, as every caller's), so the card runs a capture
before any in-place write queued after it. ``wait_for_fold`` and
``wait_for_retrain`` join them; ``close`` and process exit drain them.

``DatabaseConfig(shards=S)`` with S > 1 holds a
``parallel.sharded.ShardedIndex`` (``zebra_tpu/db.py:34-63``): with
``device=None`` one CUDA card per shard (fewer cards raise, as the JAX
package does on fewer chips), with an explicit ``device`` every shard on
that one device; the same log records (the sharded index ships rows on the
array wire: bf16 records for the bf16 slab and plain int8, f32 otherwise)
and the same workers.
"""

from __future__ import annotations

import atexit
import functools
import json
import logging
import os
import shutil
import threading
import time
import weakref

import numpy as np
import torch

from zebra_tpu_torch.config import DatabaseConfig
from zebra_tpu_torch.index import load_index, make_index
from zebra_tpu_torch.models.base import get_model
from zebra_tpu_torch.profiling import Stats, timed
from zebra_tpu_torch.storage.blobs import make_document_store
from zebra_tpu_torch.storage.deltalog import DeltaLog
from zebra_tpu_torch.storage.snapshots import (DEVICE_MEMBERS, CaptureAborted, ChunkedSource,
                                               _member_meta, _to_np)
from zebra_tpu_torch.utils import (RWLock, device_readback_mbs, fsync_write, uuid7_batch,
                                   uuid7_bytes, uuid_hex)

logger = logging.getLogger(__name__)

_FORMAT_VERSION = 1
#: rows per write-lock hold of a warm insert (queued readers interleave)
_INSERT_LOCK_BLOCK = 131072
#: replay rate of the log at open, MB/s (the fold policy's exchange rate)
_REPLAY_MBS = 32.0
#: the longest any wait of the facade on its own workers blocks, seconds
_WORKER_WAIT_S = 3600.0

#: databases whose background workers may be running (weak: a collected
#: database's daemon threads hold only work the log already covers)
_LIVE_DBS: "weakref.WeakSet" = weakref.WeakSet()


@atexit.register
def _drain_background_workers() -> None:
    """Join the fold and retrain threads before the interpreter tears down
    (a daemon thread killed inside a CUDA call can abort the process). The
    generation bumps make a chunked fold and a retrain stop at their next
    chunk; the log already holds whatever they would have folded in."""
    for db in list(_LIVE_DBS):
        try:
            db._retrain_gen += 1
            db._save_gen += 1
            db.wait_for_retrain(timeout=600)
            db.wait_for_fold(timeout=600)
        except Exception:
            logger.exception("draining a database's background workers at exit")


def _make_index(config: DatabaseConfig, device=None):
    """The index of ``config``: sharded over ``config.shards`` when above 1."""
    if config.shards > 1:
        from zebra_tpu_torch.parallel.sharded import ShardedIndex

        return ShardedIndex(dim=config.dim, metric=config.metric, options=config.index,
                            metric_power=config.metric_power, shards=config.shards,
                            device=device)
    return make_index(config.dim, config.metric, config.index, config.metric_power,
                      device=device)


def _load_index(config: DatabaseConfig, directory: str, device=None):
    if config.shards > 1:
        from zebra_tpu_torch.parallel.sharded import ShardedIndex

        return ShardedIndex.load(directory, device=device)
    return load_index(directory, device=device)


class Database:
    """An embedded vector database with document payloads."""

    def __init__(self, config: DatabaseConfig, path: str, index=None,
                 uuid: bytes | None = None, device=None, codec: str | None = None,
                 blob_backend: str | None = None):
        self.config = config
        self.path = path
        self.uuid = uuid or uuid7_bytes()
        self.index = index if index is not None else _make_index(config, device)
        #: where the embedding model runs (None: the card)
        self.device = device
        self._blob_backend = blob_backend
        self._blob_codec = codec
        self._docs = make_document_store(self._docs_dir(), backend=blob_backend, codec=codec)
        self._delta = DeltaLog(os.path.join(self._data_dir(), "delta.log"))
        #: per-database operation counters (insert / query timings and rates)
        self.stats = Stats()
        #: queries share, mutations exclude
        self._lock = RWLock()
        # -- the background log fold
        self._fold_thread = None
        #: bumped by every save (and clear): a fold whose capture predates
        #: it discards its commit
        self._save_gen = 0
        #: folds committed
        self._fold_count = 0
        #: fold trigger floor, bytes of log
        self._fold_floor = 256 * 1024 * 1024
        # -- the background retrain
        self.index.defer_rebuild = True
        self._retrain_thread = None
        #: at most one retrain builds at a time (the critical drain may run
        #: the worker on the mutating thread while a background one exists)
        self._retrain_mutex = threading.Lock()
        #: mutations to replay onto the shadow; non-None while one builds
        self._retrain_journal: list | None = None
        #: bumped by clear_database: a retrain in flight drops its swap
        self._retrain_gen = 0
        #: retrains committed, started, and drained on a mutating thread
        self._retrain_count = 0
        self._retrain_started = 0
        self._retrain_drains = 0
        #: (reason, live rows, seconds) of each committed retrain
        self._retrain_log: list[tuple[str, int, float]] = []
        #: set while the index reports a "-critical" reason: the next
        #: mutation boundary (no lock held) blocks on the rebalance
        self._retrain_critical = False
        #: live rows at the last retrain skipped for its memory (it waits
        #: for the index to grow 25% before trying again)
        self._retrain_skip_n = 0
        _LIVE_DBS.add(self)

    # -- paths ------------------------------------------------------------------

    def _data_dir(self) -> str:
        return f"{self.path}.d"

    def _index_dir(self) -> str:
        return os.path.join(self._data_dir(), "index")

    def _docs_dir(self) -> str:
        return os.path.join(self._data_dir(), uuid_hex(self.uuid))

    # -- lifecycle -----------------------------------------------------------------

    @classmethod
    def create(cls, path: str, config: DatabaseConfig, device=None) -> "Database":
        db = cls(config, path, device=device)
        db.save()
        return db

    @classmethod
    def open(cls, path: str, device=None) -> "Database":
        with open(path, "rb") as f:
            manifest = json.loads(f.read())
        if manifest.get("format") != _FORMAT_VERSION:
            raise ValueError(f"unsupported database format: {manifest.get('format')}")
        config = DatabaseConfig.from_json(manifest["config"])
        index_dir = os.path.join(f"{path}.d", "index")
        index = None
        if os.path.exists(os.path.join(index_dir, "index.json")):
            index = _load_index(config, index_dir, device=device)
        backend = manifest.get("blob_backend")
        if backend is None:  # a manifest without it: inferred from the codec
            backend = "packed" if manifest.get("codec") == "packed-zlib" else "files"
        db = cls(config, path, index=index, uuid=bytes.fromhex(manifest["uuid"]),
                 device=device, codec=None if backend == "packed" else manifest.get("codec"),
                 blob_backend=backend)
        db._replay_delta()
        db._maybe_retrain()  # the replay may have left a rebuild wanted
        return db

    @classmethod
    def open_or_create(cls, path: str, config: DatabaseConfig | None = None,
                       device=None) -> "Database":
        """Open if the manifest parses, else create fresh."""
        try:
            return cls.open(path, device=device)
        except Exception:
            if config is None:
                raise
            return cls.create(path, config, device=device)

    def _replay_delta(self) -> None:
        """Apply the log tail onto the loaded snapshot (ids already present
        are skipped; removes of absent ids are no-ops, and their blobs are
        dropped again: a crash between the record and the blob removal
        leaves them)."""
        for op, ids, vecs in self._delta.replay():
            if op == "remove":
                self.index.remove(ids)
                self._docs.remove_many(ids)
                continue
            fresh = [j for j, i in enumerate(ids) if i not in self.index]
            if not fresh:
                continue
            f = np.asarray(fresh)
            fids = [ids[j] for j in fresh]
            if op == "insert_q8":
                # the logged codes go back through the quantised wire
                # unchanged: recovery is bitwise the crash-free slab
                v8, r8, sc, rs = (p[f] for p in vecs)
                recon = v8.astype(np.float32) * sc[:, None] + r8.astype(np.float32) * rs[:, None]
                self.index.add(recon, ids=fids, prequant=(v8, r8, sc, rs))
            else:
                self.index.add(np.asarray(vecs)[f], ids=fids)

    def save(self, path: str | None = None) -> None:
        """Persist manifest + index snapshot; a save to another path copies
        the blobs there, a save to the database's own path then empties the
        log (the snapshot covers it) and supersedes any fold in flight."""
        with self._lock.write():
            self._save_locked(path or self.path)

    def _save_locked(self, target: str) -> None:
        self._save_gen += 1
        os.makedirs(f"{target}.d", exist_ok=True)
        if target != self.path and os.path.isdir(self._docs_dir()):
            dst = os.path.join(f"{target}.d", uuid_hex(self.uuid))
            if os.path.abspath(dst) != os.path.abspath(self._docs_dir()):
                shutil.copytree(self._docs_dir(), dst, dirs_exist_ok=True)
        self.index.save(os.path.join(f"{target}.d", "index"))
        self._write_manifest(target)
        if target == self.path:
            self._delta.reset()

    def _write_manifest(self, target: str) -> None:
        codec = self._docs.codec
        manifest = {
            "format": _FORMAT_VERSION,
            "uuid": uuid_hex(self.uuid),
            "codec": codec,
            "blob_backend": "packed" if codec == "packed-zlib" else "files",
            "config": self.config.to_json(),
        }
        fsync_write(target, json.dumps(manifest, indent=2).encode())

    def close(self) -> None:
        """Persist everything and release the log's and the packed blob
        store's file handles (the store reopens on its next access). The
        background workers are joined first, with no lock held (they take
        brief locks)."""
        self.wait_for_retrain()
        self.wait_for_fold()
        with self._lock.write():
            self._save_locked(self.path)
            self._delta.close()
            self._docs.close()

    def __enter__(self) -> "Database":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def clear_database(self) -> None:
        """Delete the manifest, the snapshot, the log and every blob. The
        document store is closed before the data directory goes and a fresh
        one is made after: the packed log's open handle would otherwise
        append to a deleted file."""
        with self._lock.write():
            self._retrain_gen += 1  # a retrain in flight drops its swap
            self._save_gen += 1  # and a fold its commit
            self.index.clear()
            self._docs.clear()
            self._delta.close()
            try:
                os.remove(self.path)
            except FileNotFoundError:
                pass
            shutil.rmtree(self._data_dir(), ignore_errors=True)
            self._docs = make_document_store(self._docs_dir(), backend=self._blob_backend,
                                             codec=self._blob_codec)

    # -- model --------------------------------------------------------------------

    @property
    def model(self):
        if not self.config.model:
            raise ValueError("this database has no embedding model configured")
        return get_model(self.config.model, device=self.device)

    def model_status(self) -> dict:
        """Embedding-path health: ``{"model", "semantic", "degradations"}``
        (a named model may have fallen back to the hashing tokenizer or
        random-init weights; the CLI prints this)."""
        if not self.config.model:
            return {"model": None, "semantic": False,
                    "degradations": ["vectors-only database (no model)"]}
        st = dict(self.model.status())
        st["model"] = self.config.model
        return st

    # -- CRUD ----------------------------------------------------------------------

    def _wal_callback(self, ids: list[bytes], vectors: np.ndarray):
        """Per-span write-ahead hook for ``index.add``: the span's record is
        appended and fsync'd before the span's insert runs. A quantised wire
        (refined int8) hands over its q8 parts; an array wire logs the span's
        rows in the index's ``_wal_codec``: bf16 where the wire is bf16
        (lossless for what it stores), else exact f32."""
        if self.config.durability != "full":
            return None
        bf16 = self.index._wal_codec == "bf16"

        def cb(span, parts):
            start, count = span
            sids = ids[start : start + count]
            with timed("insert.wal", items=count, stats=self.stats):
                if parts is not None:
                    self._delta.append_insert_q8(sids, *parts)
                else:
                    self._delta.append_insert(sids, vectors[start : start + count], bf16=bf16)

        return cb

    @staticmethod
    def _insert_span_rows(n: int) -> int | None:
        """Span width of one insert: the JAX package's (16384-row spans for
        mid-size calls, full BATCH spans otherwise), so both log and place
        the same spans."""
        from zebra_tpu_torch.index.base import BATCH

        if n <= 8192 or n >= 4 * BATCH:
            return None
        return 16384

    def _insert_blocks(self, v: np.ndarray, ids: list[bytes], documents=None) -> None:
        """The shared insert body (``zebra_tpu/db.py:975-1001``):
        write-locked per block of :data:`_INSERT_LOCK_BLOCK` rows (a cold
        build holds one lock); within a block the blobs first, then the
        per-span fsync'd log records inside the index's pipeline, then the
        index, then the manifest."""
        n = v.shape[0]
        w = n if (self.index.state is None or n <= _INSERT_LOCK_BLOCK) else _INSERT_LOCK_BLOCK
        for s in range(0, n, w):
            e = min(n, s + w)
            bids, bv = ids[s:e], v[s:e]
            with self._lock.write(), timed("insert", items=e - s, stats=self.stats):
                if documents is not None:
                    with timed("insert.blobs", items=e - s, stats=self.stats):
                        self._docs.save_many(bids, documents[s:e])
                with timed("insert.index", items=e - s, stats=self.stats):
                    self.index.add(bv, ids=bids, wal_cb=self._wal_callback(bids, bv),
                                   span_rows=self._insert_span_rows(e - s))
                self._journal("insert", bids, bv)
                self._post_mutation()
            self._drain_critical_retrain()  # no lock held here

    def insert_vectors(self, vectors: np.ndarray) -> list[bytes]:
        """Vector-only insert; returns the new ids."""
        v = np.asarray(vectors, dtype=np.float32)
        if v.ndim == 1:
            v = v[None, :]
        if not v.shape[0]:
            return []
        ids = uuid7_batch(v.shape[0])
        self._insert_blocks(v, ids)
        return ids

    def insert_documents(self, documents: list[bytes]) -> list[bytes]:
        """Embed and insert documents; returns the new ids."""
        with timed("insert.embed", items=len(documents), stats=self.stats):
            embeddings = self.model.embed_documents(documents)
        return self.insert_records(embeddings, documents)

    def insert_records(self, embeddings: np.ndarray, documents: list[bytes]) -> list[bytes]:
        """Insert embedding / document pairs. With durability="full" the
        blobs go first (an orphan blob after a crash is unreachable, never
        inconsistent), then the fsync'd log record, then the index."""
        embeddings = np.asarray(embeddings, dtype=np.float32)
        if embeddings.ndim == 1:
            embeddings = embeddings[None, :]
        if len(documents) != embeddings.shape[0]:
            raise ValueError("embeddings/documents length mismatch")
        if not len(documents):
            return []
        ids = uuid7_batch(embeddings.shape[0])
        self._insert_blocks(embeddings, ids, documents=list(documents))
        return ids

    def _log_remove(self, ids: list[bytes]) -> None:
        """Write-ahead remove record. Replaying a remove that never ran (a
        crash before the index mutation) redoes it."""
        if self.config.durability == "full" and ids:
            self._delta.append_remove(ids)

    def remove(self, ids: list[bytes]) -> None:
        """Remove records: log the ids present, tombstone them, then drop
        their blobs."""
        with self._lock.write():
            present = [i for i in ids if i in self.index]
            self._log_remove(present)
            removed = self.index.remove(present)
            self._journal("remove", removed)
            self._docs.remove_many(removed)
            self._post_mutation()
        self._drain_critical_retrain()

    def deduplicate(self) -> None:
        """Drop exact duplicate vectors and their blobs, keeping the smallest
        id of each group. The duplicates are found without mutating
        (``index.find_duplicates``), so the removal is logged first, like any
        other remove."""
        with self._lock.write():
            dup = self.index.find_duplicates()
            self._log_remove(dup)
            removed = self.index.remove(dup)
            self._journal("remove", removed)
            self._docs.remove_many(removed)
            self._post_mutation()
        self._drain_critical_retrain()

    # -- background workers (``zebra_tpu/db.py:348-816``) ---------------------------

    def _post_mutation(self) -> None:
        """Manifest refresh, then the fold and retrain policies (call under
        the write lock)."""
        self._write_manifest(self.path)
        if self.config.durability == "full":
            self._maybe_checkpoint()
        self._maybe_retrain()

    def _start_worker(self, target, name: str) -> threading.Thread:
        """Start a worker thread whose device work goes to the stream current
        in the calling (mutating) thread, so the card orders the worker's
        captures with the mutations queued around them (None on the CPU:
        no stream)."""
        dev = self.index.device
        stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None

        def run():
            with torch.cuda.stream(stream):
                target()

        t = threading.Thread(target=run, name=name, daemon=True)
        t.start()
        return t

    # the fold

    def _maybe_checkpoint(self) -> None:
        """Start the background fold once the log is past the floor and past
        :meth:`_fold_threshold` (both O(1): no probe under the write lock)."""
        log_bytes = self._delta.size()
        if log_bytes >= self._fold_floor and log_bytes > self._fold_threshold():
            self._start_fold()

    def _fold_threshold(self, allow_measure: bool = False) -> int:
        """The fold trigger in log bytes: the floor, the last snapshot's
        bytes, and the log a fold's device -> host readback of that snapshot
        would save at open (replay runs at ~``_REPLAY_MBS``), whichever is
        largest. ``allow_measure`` lets the one-time readback probe run (the
        fold thread passes it; the mutating path, under the write lock,
        never does, and leaves the term out while unmeasured)."""
        try:
            snap_bytes = os.path.getsize(os.path.join(self._index_dir(), "arrays.npz"))
        except OSError:
            snap_bytes = 0
        threshold = max(self._fold_floor, snap_bytes)
        if snap_bytes:
            mbs = device_readback_mbs(measure=allow_measure)
            if mbs is not None:
                threshold = max(threshold, int(snap_bytes / (mbs * 1e6) * _REPLAY_MBS * 1e6))
        return threshold

    def _start_fold(self) -> None:
        """Start the fold thread (a no-op while one runs)."""
        if self._fold_thread is not None and self._fold_thread.is_alive():
            return
        self._fold_thread = self._start_worker(self._fold_worker, "zebra-fold")

    def wait_for_warm(self, timeout: float | None = None) -> None:
        """Returns at once: the JAX facade waits here for its background
        compile of the served query shapes, and the port compiles no query
        program ahead (``BaseVectorIndex.warm_serving_shapes``)."""

    def wait_for_fold(self, timeout: float | None = _WORKER_WAIT_S) -> None:
        """Block until a fold in flight finishes (call with no lock held)."""
        t = self._fold_thread
        if t is not None and t.is_alive():
            t.join(timeout)

    def _fold_worker(self) -> None:
        tmp = self._index_dir() + ".fold"
        try:
            # mutations landing while a fold streams grow the log again:
            # fold until it is under the threshold
            while self._fold_once(tmp):
                if self._delta.size() <= self._fold_threshold(allow_measure=True):
                    return
        except Exception:  # the serving path keeps running; the log is intact
            logger.exception("background log fold failed (will retry later)")
            shutil.rmtree(tmp, ignore_errors=True)

    def _fold_once(self, tmp: str) -> bool:
        """One capture -> stream -> commit cycle; True when it committed."""
        with self._lock.read():
            # appends happen under the write lock: this size is a record
            # boundary, and the capture is consistent with it
            offset = self._delta.size()
            gen = self._save_gen
            sgen = self.index._struct_gen
            cap = self.index.snapshot_capture(clone=True)
        if not cap["cloned"]:
            cap = self._fold_chunked_capture(cap, gen, sgen)
        shutil.rmtree(tmp, ignore_errors=True)
        try:
            self.index.write_capture(tmp, cap)  # the slow part: no lock held
        except CaptureAborted:
            logger.info("chunked fold aborted mid-stream; will retry")
            shutil.rmtree(tmp, ignore_errors=True)
            return False
        with self._lock.write():
            if self._save_gen != gen:  # an explicit save superseded it
                shutil.rmtree(tmp, ignore_errors=True)
                return False
            idx_dir = self._index_dir()
            os.makedirs(idx_dir, exist_ok=True)
            # arrays first, meta second: a crash between leaves the old meta
            # and the untruncated log, whose replay is idempotent
            for name in ("arrays.npz", "index.json"):
                src = os.path.join(tmp, name)
                if os.path.exists(src):
                    os.replace(src, os.path.join(idx_dir, name))
            shutil.rmtree(tmp, ignore_errors=True)
            self._delta.truncate_prefix(offset)
            self._write_manifest(self.path)
            self._fold_count += 1
            logger.info("background fold: snapshot swapped, %d log bytes dropped", offset)
        return True

    def _fold_chunked_capture(self, cap: dict, gen: int, sgen: int) -> dict:
        """A capture whose clone the budget refused, with each state tensor
        replaced by a :class:`ChunkedSource` (``zebra_tpu/db.py:545-589``):
        each chunk is copied on the device under a brief read lock and read
        back with no lock held. Chunks from different lock windows may
        straddle mutations, so the snapshot is fuzzy; the log suffix past
        the capture's offset repairs it on replay (inserts are skipped by
        id, removes of absent ids are no-ops, a slot is reused only
        after a rebuild). A rebuild or swap (``_struct_gen``), a save
        (``_save_gen``) or a reallocated member aborts the fetch."""
        arrays = dict(cap["arrays"])
        for name, v in arrays.items():
            if isinstance(v, DEVICE_MEMBERS):
                shape, dtype = _member_meta(v)
                arrays[name] = ChunkedSource(shape, dtype, functools.partial(
                    self._fold_fetch_chunk, name, tuple(v.shape), gen, sgen))
        return {**cap, "arrays": arrays, "cloned": True, "chunked": True}

    def _fold_fetch_chunk(self, name: str, shape: tuple, gen: int, sgen: int, s: int, e: int):
        """One chunk of a fuzzy capture: rows ``[s:e)`` of member ``name``
        copied under the read lock (a copy, not a view: the state is
        written in place), read back with no lock held."""
        with self._lock.read():
            if self._save_gen != gen or self.index._struct_gen != sgen:
                raise CaptureAborted(f"generation moved under {name}")
            arr = self.index._snapshot_arrays().get(name)
            if arr is None or tuple(arr.shape) != shape:
                raise CaptureAborted(f"{name} was reallocated mid-capture")
            chunk = arr.clone() if arr.dim() == 0 else arr[s:e].clone()
        return _to_np(chunk)

    # the retrain

    #: rows of each capture chunk of the shadow build (and the transient unit
    #: of its memory admission)
    _RETRAIN_CHUNK = 262144
    #: catch-up ends once one journal drain is at most this many rows: the
    #: replay under the swap lock is then O(batch), not O(backlog)
    _RETRAIN_TAIL_ROWS = 16384

    def _maybe_retrain(self) -> None:
        """Start the background retrain when the index wants one (a no-op
        while one runs, or after a skip for memory until the index grew
        25%). A "-critical" reason also arms the backpressure flag."""
        reason = self.index._rebuild_wanted
        if not reason:
            return
        if reason.endswith("-critical"):
            self._retrain_critical = True
        if self._retrain_skip_n and len(self.index) < 1.25 * self._retrain_skip_n:
            return
        if self._retrain_thread is not None and self._retrain_thread.is_alive():
            return
        self._retrain_started += 1
        self._retrain_thread = self._start_worker(self._retrain_worker, "zebra-retrain")

    def _drain_critical_retrain(self) -> None:
        """Backpressure at the spare's cliff (call with no lock held): the
        mutating thread waits for the rebalance, and runs the retrain itself
        when none is in flight, instead of growing the spare without bound.
        Queries keep being served meanwhile: the retrain takes brief locks."""
        if not self._retrain_critical:
            return
        self._retrain_drains += 1
        for _ in range(3):
            t = self._retrain_thread
            if t is not None and t.is_alive():
                t.join(timeout=_WORKER_WAIT_S)
            if not self.index._rebuild_wanted or self._retrain_skip_n:
                break
            logger.warning("critical spare pressure: running the retrain on the mutating "
                           "thread (backpressure; queries keep serving)")
            self._retrain_worker()
        self._retrain_critical = False

    def wait_for_retrain(self, timeout: float | None = _WORKER_WAIT_S) -> None:
        """Block until a retrain in flight finishes (call with no lock held)."""
        t = self._retrain_thread
        if t is not None and t.is_alive():
            t.join(timeout)

    def _journal(self, op: str, ids: list[bytes], vectors=None) -> None:
        """Record one index mutation for the shadow (call under the write
        lock, which orders it against the capture)."""
        j = self._retrain_journal
        if j is not None and ids:
            j.append((op, list(ids), vectors))

    @staticmethod
    def _apply_journal(shadow, batch: list) -> int:
        """Replay journaled mutations onto the shadow, in order; returns the
        rows they carried."""
        rows = 0
        for op, ids, vecs in batch:
            if op == "insert":
                shadow.add(np.asarray(vecs, np.float32), ids=ids)
            else:
                shadow.remove(ids)
            rows += len(ids)
        return rows

    def _retrain_worker(self) -> None:
        try:
            with self._retrain_mutex:
                self._retrain_once()
        except Exception:  # the serving path keeps running on its state
            logger.exception("background retrain failed (serving state unchanged)")
        finally:
            with self._lock.write():
                self._retrain_journal = None

    def _retrain_once(self) -> None:
        """One shadow retrain (``zebra_tpu/db.py:705-816``): capture the
        live slots and ids, train the shadow on a sample of their rows and
        ingest them in chunks (each gathered under a brief read lock, the
        rest with no lock held), replay the journal off-lock until one
        drain is small, then replay the tail and adopt the shadow under the
        write lock. ``clear_database`` (``_retrain_gen``) or a direct
        ``index.rebuild()`` (``_struct_gen``) aborts the swap."""
        from zebra_tpu_torch.index import ivf_host

        idx = self.index
        with self._lock.read():
            reason = idx._rebuild_wanted
            if not reason:
                return
            gen = self._retrain_gen
            sgen = idx._struct_gen
            order, ids = idx._live_order_ids()
            self._retrain_journal = []
        n = len(ids)
        if n == 0:
            idx._rebuild_wanted = None
            return
        # memory admission: halve the capture chunk until the transient fits
        # the budget; when even 32768 rows do not, skip until the index grew
        chunk = self._RETRAIN_CHUNK
        if idx._retrain_bg_peak_bytes(n, chunk):
            budget = ivf_host._STAGE_HBM_BUDGET
            live = idx._state_hbm_bytes()
            while live + idx._retrain_bg_peak_bytes(n, chunk) > budget and chunk > 32768:
                chunk //= 2
            if live + idx._retrain_bg_peak_bytes(n, chunk) > budget:
                logger.warning("background retrain skipped at %d live rows: the shadow's "
                               "transient exceeds the budget even at chunk=%d", n, chunk)
                self._retrain_skip_n = n
                return
        self._retrain_skip_n = 0
        t0 = time.perf_counter()
        shadow = idx._clone_empty()
        shadow.defer_rebuild = False
        shadow._paced_train = True
        idx._prepare_shadow(shadow, reason)
        target = idx._train_sample_target(n)
        if target < n:
            rng = np.random.default_rng(idx.options.seed + 17)
            sample_order = order[np.sort(rng.choice(n, size=target, replace=False))]
        else:
            sample_order = order
        with timed("retrain.capture", items=len(sample_order)), self._lock.read():
            if self._retrain_gen != gen or idx._struct_gen != sgen:
                return
            sample = idx._gather_live(sample_order)
        with timed("retrain.state", items=n):
            shadow._shadow_begin(n, sample)
        del sample
        for c in range(0, n, chunk):
            with timed("retrain.capture", items=min(chunk, n - c)), self._lock.read():
                if self._retrain_gen != gen or idx._struct_gen != sgen:
                    return
                data_c = idx._gather_live(order[c : c + chunk])
            with timed("retrain.ingest", items=min(chunk, n - c)):
                shadow._shadow_ingest(data_c, ids[c : c + chunk])
            del data_c
        shadow.warm_serving_shapes(())
        # catch-up rounds off-lock; eight bound a writer that outruns them,
        # after which the swap lock takes what landed in the last round
        with timed("retrain.catchup"):
            for _ in range(8):
                with self._lock.read():
                    batch, self._retrain_journal = self._retrain_journal, []
                if self._apply_journal(shadow, batch) <= self._RETRAIN_TAIL_ROWS:
                    break
        with timed("retrain.swap"), self._lock.write():
            if self._retrain_gen != gen or idx._struct_gen != sgen:
                self._retrain_journal = None
                return
            self._apply_journal(shadow, self._retrain_journal)
            self._retrain_journal = None
            idx._adopt(shadow)
            self._retrain_count += 1
            self._retrain_log.append((reason, n, time.perf_counter() - t0))
        logger.info("background retrain (%s): %d rows re-placed in %.1fs (%d retrains)",
                    reason, n, time.perf_counter() - t0, self._retrain_count)

    def query(self, vectors: np.ndarray, number_of_results: int = 10,
              with_documents: bool = False):
        """Per-query ``[(id, distance), ...]`` (with ``with_documents``,
        ``(id, distance, document or None)``), nearest first."""
        if self.index.no_vectors():
            v = np.asarray(vectors)
            return [[] for _ in range(1 if v.ndim == 1 else v.shape[0])]
        with self._lock.read():
            results = self.index.search(np.asarray(vectors, dtype=np.float32), number_of_results)
            if not with_documents:
                return results
            out = []
            for row in results:
                docs = self._docs.read_many([i for i, _ in row])
                out.append([(i, d, docs.get(i)) for i, d in row])
        return out

    def query_documents(self, documents: list[bytes],
                        number_of_results: int = 1) -> dict[int, dict[bytes, bytes]]:
        """Embed the queries and fetch the neighbours' documents:
        ``{query index: {id: document}}``."""
        if self.index.no_vectors():
            return {}
        with timed("query.embed", items=len(documents), stats=self.stats):
            queries = self.model.embed_documents(documents)
        return self.query_vectors(queries, number_of_results)

    def query_vectors(self, vectors: np.ndarray,
                      number_of_results: int = 1) -> dict[int, dict[bytes, bytes]]:
        """ANN query and blob fetch: ``{query index: {id: document}}``."""
        if self.index.no_vectors():
            return {}
        v = np.asarray(vectors, dtype=np.float32)
        nq = 1 if v.ndim == 1 else v.shape[0]
        with self._lock.read(), timed("query", items=nq, stats=self.stats):
            results = self.index.search(v, number_of_results)
            return {qi: self._docs.read_many([i for i, _ in row])
                    for qi, row in enumerate(results)}

    def query_stream(self, batches, number_of_results: int = 10):
        """Pipelined per-batch queries: yields one :meth:`query`-shaped list
        per input batch with one batch in flight, so batch t's readback and
        formatting overlap batch t+1's upload and device work.

        Each submit takes the shared read lock; collects run lock-free. A
        mutation between them is queued on the device after the submitted
        query, which therefore answers from the state before it (ids of
        slots removed meanwhile come back as the all-zero id, as in the JAX
        package); its slots are named by the slot -> id map it was answered
        from, also across a retrain's swap (``index.format_collect``)."""
        pending = None
        for batch in batches:
            b = np.asarray(batch, dtype=np.float32)
            nq = 1 if b.ndim == 1 else b.shape[0]
            if self.index.no_vectors():
                if pending is not None:
                    yield self.index.format_collect(pending)
                    pending = None
                yield [[] for _ in range(nq)]
                continue
            with self._lock.read(), timed("query", items=nq, stats=self.stats):
                tok = self.index.search_submit(b, number_of_results)
            if pending is not None:
                yield self.index.format_collect(pending)
            pending = tok
        if pending is not None:
            yield self.index.format_collect(pending)

    def __len__(self) -> int:
        return len(self.index)
