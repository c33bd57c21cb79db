"""Database facade of the torch port (port of ``zebra_tpu/db.py``, vectors
only so far).

The same manifest (``<path>``), index snapshot (``<path>.d/index/``) and
write-ahead log (``<path>.d/delta.log``) as the JAX package, so a database
written by one package opens in the other. With ``durability="full"`` (the
default) every insert span is logged as an fsync'd record BEFORE the index
mutation runs (q8 for the refined int8 tier, bf16 where the wire is bf16 — the
bf16 slab and plain int8 —, f32 otherwise), and every remove is logged before
it tombstones; ``open`` replays the log onto the last snapshot (idempotent by
id). ``query_stream`` keeps one batch in flight (each submit under the read
lock, collects lock-free); ``deduplicate`` finds exact duplicates, logs their
removal, then removes them; ``stats`` holds the facade's stage timers.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP.md
entry, queue 1): documents and blobs with their embedding models and
``model_status`` (item 4), the background log fold and retrain workers
(item 8), and the CLI.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np

from zebra_tpu_torch.config import DatabaseConfig
from zebra_tpu_torch.index import load_index, make_index
from zebra_tpu_torch.profiling import Stats, timed
from zebra_tpu_torch.storage.deltalog import DeltaLog
from zebra_tpu_torch.utils import RWLock, fsync_write, uuid7_batch, uuid7_bytes, uuid_hex

_FORMAT_VERSION = 1
#: rows per write-lock hold of a warm insert (queued readers interleave)
_INSERT_LOCK_BLOCK = 131072


def _not_ported(what: str, entry: str):
    raise NotImplementedError(f"{what} is not ported to the torch package yet ({entry})")


class Database:
    """An embedded vector database (vectors only so far)."""

    def __init__(self, config: DatabaseConfig, path: str, index=None,
                 uuid: bytes | None = None, device=None, blobs: dict | None = None):
        if config.shards > 1:
            _not_ported("sharding (shards > 1)", "ROADMAP.md queue 1, sharding")
        self.config = config
        self.path = path
        self.uuid = uuid or uuid7_bytes()
        self.index = index if index is not None else make_index(
            config.dim, config.metric, config.index, config.metric_power, device=device)
        #: manifest blob-store fields, kept as written so the JAX package
        #: reopens its own document store (the port writes no documents)
        self._blobs = blobs or {"codec": "zlib", "blob_backend": "files"}
        self._delta = DeltaLog(os.path.join(self._data_dir(), "delta.log"))
        #: per-database operation counters (insert / query timings and rates)
        self.stats = Stats()
        #: queries share, mutations exclude
        self._lock = RWLock()

    # -- paths ------------------------------------------------------------------

    def _data_dir(self) -> str:
        return f"{self.path}.d"

    def _index_dir(self) -> str:
        return os.path.join(self._data_dir(), "index")

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
            index = load_index(index_dir, device=device)
        blobs = {key: manifest[key] for key in ("codec", "blob_backend") if key in manifest}
        db = cls(config, path, index=index, uuid=bytes.fromhex(manifest["uuid"]),
                 device=device, blobs=blobs)
        db._replay_delta()
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
        are skipped; removes of absent ids are no-ops)."""
        for op, ids, vecs in self._delta.replay():
            if op == "remove":
                self.index.remove(ids)
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
        """Persist manifest + index snapshot; a save to the database's own
        path then empties the log (the snapshot covers it)."""
        target = path or self.path
        with self._lock.write():
            os.makedirs(f"{target}.d", exist_ok=True)
            self.index.save(os.path.join(f"{target}.d", "index"))
            self._write_manifest(target)
            if target == self.path:
                self._delta.reset()

    def _write_manifest(self, target: str) -> None:
        manifest = {
            "format": _FORMAT_VERSION,
            "uuid": uuid_hex(self.uuid),
            **self._blobs,
            "config": self.config.to_json(),
        }
        fsync_write(target, json.dumps(manifest, indent=2).encode())

    def close(self) -> None:
        """Persist everything and release the log's file handle."""
        with self._lock.write():
            self.save()
            self._delta.close()

    def __enter__(self) -> "Database":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def clear_database(self) -> None:
        """Delete the manifest, the snapshot and the log."""
        with self._lock.write():
            self.index.clear()
            self._delta.close()
            try:
                os.remove(self.path)
            except FileNotFoundError:
                pass
            shutil.rmtree(self._data_dir(), ignore_errors=True)

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

    def _insert_blocks(self, v: np.ndarray, ids: list[bytes]) -> None:
        """The shared insert body (``zebra_tpu/db.py:975-1013``, without the
        blob stage): write-locked per block of :data:`_INSERT_LOCK_BLOCK`
        rows (a cold build holds one lock), per-span fsync'd log records
        inside the index's pipeline, then the manifest."""
        n = v.shape[0]
        w = n if (self.index.state is None or n <= _INSERT_LOCK_BLOCK) else _INSERT_LOCK_BLOCK
        for s in range(0, n, w):
            e = min(n, s + w)
            bids, bv = ids[s:e], v[s:e]
            with self._lock.write(), timed("insert", items=e - s, stats=self.stats):
                with timed("insert.index", items=e - s, stats=self.stats):
                    self.index.add(bv, ids=bids, wal_cb=self._wal_callback(bids, bv),
                                   span_rows=self._insert_span_rows(e - s))
                self._write_manifest(self.path)

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

    def _log_remove(self, ids: list[bytes]) -> None:
        """Write-ahead remove record. Replaying a remove that never ran (a
        crash before the index mutation) redoes it."""
        if self.config.durability == "full" and ids:
            self._delta.append_remove(ids)

    def remove(self, ids: list[bytes]) -> None:
        """Remove records: log the ids present, then tombstone them."""
        with self._lock.write():
            present = [i for i in ids if i in self.index]
            self._log_remove(present)
            self.index.remove(present)
            self._write_manifest(self.path)

    def deduplicate(self) -> None:
        """Drop exact duplicate vectors, keeping the smallest id of each
        group. The duplicates are found without mutating
        (``index.find_duplicates``), so the removal is logged first, like any
        other remove."""
        with self._lock.write():
            dup = self.index.find_duplicates()
            self._log_remove(dup)
            self.index.remove(dup)
            self._write_manifest(self.path)

    def query(self, vectors: np.ndarray, number_of_results: int = 10,
              with_documents: bool = False):
        """Per-query ``[(id, distance), ...]``, nearest first."""
        if with_documents:
            _not_ported("with_documents", "ROADMAP.md queue 1, item 4: documents and blobs")
        if self.index.no_vectors():
            v = np.asarray(vectors)
            return [[] for _ in range(1 if v.ndim == 1 else v.shape[0])]
        with self._lock.read():
            return self.index.search(np.asarray(vectors, dtype=np.float32), number_of_results)

    def query_stream(self, batches, number_of_results: int = 10):
        """Pipelined per-batch queries: yields one :meth:`query`-shaped list
        per input batch with one batch in flight, so batch t's readback and
        formatting overlap batch t+1's upload and device work.

        Each submit takes the shared read lock; collects run lock-free. A
        mutation between them is queued on the device after the submitted
        query, which therefore answers from the state before it (ids of
        slots removed meanwhile come back as the all-zero id, as in the JAX
        package)."""
        pending = None
        for batch in batches:
            b = np.asarray(batch, dtype=np.float32)
            nq = 1 if b.ndim == 1 else b.shape[0]
            if self.index.no_vectors():
                if pending is not None:
                    yield self.index._format_results(*self.index.search_collect(pending))
                    pending = None
                yield [[] for _ in range(nq)]
                continue
            with self._lock.read(), timed("query", items=nq, stats=self.stats):
                tok = self.index.search_submit(b, number_of_results)
            if pending is not None:
                yield self.index._format_results(*self.index.search_collect(pending))
            pending = tok
        if pending is not None:
            yield self.index._format_results(*self.index.search_collect(pending))

    def __len__(self) -> int:
        return len(self.index)

    # -- not ported yet ------------------------------------------------------------------

    def insert_documents(self, documents):
        _not_ported("insert_documents", "ROADMAP.md queue 1, item 4: documents and blobs")

    def insert_records(self, embeddings, documents):
        _not_ported("insert_records", "ROADMAP.md queue 1, item 4: documents and blobs")

    def query_documents(self, documents, number_of_results: int = 1):
        _not_ported("query_documents", "ROADMAP.md queue 1, item 4: documents and blobs")

    def query_vectors(self, vectors, number_of_results: int = 1):
        _not_ported("query_vectors", "ROADMAP.md queue 1, item 4: documents and blobs")

    def model_status(self) -> dict:
        _not_ported("model_status", "ROADMAP.md queue 1, item 4: documents, blobs and the hash model")

    @property
    def model(self):
        _not_ported("embedding models", "ROADMAP.md queue 1, item 4 (the hash model) and "
                    "item 9 (the towers)")
