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

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP.md
entry, queue 1): the image and audio towers (item 9) and the background log
fold and retrain workers (item 8).
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np

from zebra_tpu_torch.config import DatabaseConfig
from zebra_tpu_torch.index import load_index, make_index
from zebra_tpu_torch.models.base import get_model
from zebra_tpu_torch.profiling import Stats, timed
from zebra_tpu_torch.storage.blobs import make_document_store
from zebra_tpu_torch.storage.deltalog import DeltaLog
from zebra_tpu_torch.utils import RWLock, fsync_write, uuid7_batch, uuid7_bytes, uuid_hex

_FORMAT_VERSION = 1
#: rows per write-lock hold of a warm insert (queued readers interleave)
_INSERT_LOCK_BLOCK = 131072


def _not_ported(what: str, entry: str):
    raise NotImplementedError(f"{what} is not ported to the torch package yet ({entry})")


class Database:
    """An embedded vector database with document payloads."""

    def __init__(self, config: DatabaseConfig, path: str, index=None,
                 uuid: bytes | None = None, device=None, codec: str | None = None,
                 blob_backend: str | None = None):
        if config.shards > 1:
            _not_ported("sharding (shards > 1)", "ROADMAP.md queue 1, sharding")
        self.config = config
        self.path = path
        self.uuid = uuid or uuid7_bytes()
        self.index = index if index is not None else make_index(
            config.dim, config.metric, config.index, config.metric_power, device=device)
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
            index = load_index(index_dir, device=device)
        backend = manifest.get("blob_backend")
        if backend is None:  # a manifest without it: inferred from the codec
            backend = "packed" if manifest.get("codec") == "packed-zlib" else "files"
        db = cls(config, path, index=index, uuid=bytes.fromhex(manifest["uuid"]),
                 device=device, codec=None if backend == "packed" else manifest.get("codec"),
                 blob_backend=backend)
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
        log (the snapshot covers it)."""
        target = path or self.path
        with self._lock.write():
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
        store's file handles (the store reopens on its next access)."""
        with self._lock.write():
            self.save()
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
            self._docs.remove_many(self.index.remove(present))
            self._write_manifest(self.path)

    def deduplicate(self) -> None:
        """Drop exact duplicate vectors and their blobs, keeping the smallest
        id of each group. The duplicates are found without mutating
        (``index.find_duplicates``), so the removal is logged first, like any
        other remove."""
        with self._lock.write():
            dup = self.index.find_duplicates()
            self._log_remove(dup)
            self._docs.remove_many(self.index.remove(dup))
            self._write_manifest(self.path)

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
