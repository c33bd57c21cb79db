"""Compressed document blob stores (the port of ``zebra_tpu/storage/blobs.py``).

Two backends with one API (``save_many`` / ``read_many`` / ``remove_many`` /
``clear``), the same on-disk layouts as the JAX package's, so a store written
by one package reads in the other:

- :class:`DocumentStore`: one compressed file per document,
  ``{id.hex()}.lz4`` when ``lz4.frame`` imports and ``{id.hex()}.z`` (zlib
  level 1) otherwise; each file fsync'd, written by a thread pool.
- :class:`PackedDocumentStore`: every document in the native packed blob log
  (``native/zebra_store.cpp``: one file, one fsync a batch).

:func:`make_document_store` picks one: an explicit backend wins, then the
packed log when the native library builds, then the per-file store.
"""

from __future__ import annotations

import os
import shutil
import zlib
from concurrent.futures import ThreadPoolExecutor

from zebra_tpu_torch import native

try:  # optional, absent from the base image
    import lz4.frame as _lz4  # type: ignore

    _HAVE_LZ4 = True
except ImportError:
    _lz4 = None
    _HAVE_LZ4 = False

_WORKERS = min(32, (os.cpu_count() or 8))


class DocumentStore:
    """Directory of compressed document blobs keyed by vector id."""

    def __init__(self, directory: str, codec: str | None = None):
        self.directory = directory
        if codec is None:
            codec = "lz4" if _HAVE_LZ4 else "zlib"
        if codec == "lz4" and not _HAVE_LZ4:
            raise RuntimeError("store was written with lz4 but lz4 is unavailable")
        self.codec = codec
        self.ext = "lz4" if codec == "lz4" else "z"

    def _path(self, doc_id: bytes) -> str:
        return os.path.join(self.directory, f"{doc_id.hex()}.{self.ext}")

    def _compress(self, data: bytes) -> bytes:
        return _lz4.compress(data) if self.codec == "lz4" else zlib.compress(data, level=1)

    def _decompress(self, data: bytes) -> bytes:
        return _lz4.decompress(data) if self.codec == "lz4" else zlib.decompress(data)

    def save_many(self, ids: list[bytes], docs: list[bytes]) -> None:
        """Compressed writes on a thread pool, each file fsync'd."""
        os.makedirs(self.directory, exist_ok=True)

        def write(pair):
            doc_id, doc = pair
            with open(self._path(doc_id), "wb") as f:
                f.write(self._compress(doc))
                f.flush()
                os.fsync(f.fileno())

        with ThreadPoolExecutor(max_workers=_WORKERS) as ex:
            list(ex.map(write, zip(ids, docs)))

    def read_many(self, ids: list[bytes]) -> dict[bytes, bytes]:
        """``{id: document}`` of the ids whose blob exists (missing ones are
        left out)."""

        def read(doc_id):
            try:
                with open(self._path(doc_id), "rb") as f:
                    return doc_id, self._decompress(f.read())
            except FileNotFoundError:
                return doc_id, None

        with ThreadPoolExecutor(max_workers=_WORKERS) as ex:
            out = dict(ex.map(read, ids))
        return {k: v for k, v in out.items() if v is not None}

    def remove_many(self, ids: list[bytes]) -> None:
        for doc_id in ids:
            try:
                os.remove(self._path(doc_id))
            except FileNotFoundError:
                pass

    def close(self) -> None:
        """Nothing to release: every file is closed after its write."""

    def clear(self) -> None:
        if not os.path.isdir(self.directory):
            return
        for name in os.listdir(self.directory):
            try:
                os.remove(os.path.join(self.directory, name))
            except OSError:
                pass
        try:
            os.rmdir(self.directory)
        except OSError:
            pass


class PackedDocumentStore:
    """Documents in the native packed blob log (one file, one fsync a batch);
    the same API as :class:`DocumentStore`."""

    codec = "packed-zlib"

    def __init__(self, directory: str):
        self.directory = directory
        # opened lazily, so that constructing a store (right after
        # ``clear_database``) does not recreate the directory before the
        # first write
        self._store = None

    def _log(self, create: bool = False) -> native.NativeBlobStore | None:
        """The open log; opened here if its directory exists (or, with
        ``create``, made). A closed store reopens on its next access."""
        if self._store is None and (create or os.path.isdir(self.directory)):
            os.makedirs(self.directory, exist_ok=True)
            self._store = native.NativeBlobStore(self.directory)
        return self._store

    def save_many(self, ids: list[bytes], docs: list[bytes]) -> None:
        store = self._log(create=True)
        for doc_id, doc in zip(ids, docs):
            store.put(doc_id, doc)
        store.flush()

    def read_many(self, ids: list[bytes]) -> dict[bytes, bytes]:
        store = self._log()
        if store is None:
            return {}
        out = {}
        for doc_id in ids:
            doc = store.get(doc_id)
            if doc is not None:
                out[doc_id] = doc
        return out

    def remove_many(self, ids: list[bytes]) -> None:
        store = self._log()
        if store is None:
            return
        for doc_id in ids:
            store.delete(doc_id)
        store.flush()

    def compact(self) -> None:
        """Rewrite the log with its live records only, reclaiming the bytes
        of removed documents."""
        store = self._log()
        if store is not None:
            store.compact()

    def close(self) -> None:
        """Release the log's file handle, keeping its data (it reopens on
        the next access)."""
        if self._store is not None:
            self._store.close()
            self._store = None

    def clear(self) -> None:
        """Close the log, then delete it: writing through a handle of a
        removed file would append to a deleted inode."""
        self.close()
        shutil.rmtree(self.directory, ignore_errors=True)


def make_document_store(directory: str, backend: str | None = None, codec: str | None = None):
    """Pick a blob backend: explicit > native packed log > per-file."""
    if backend == "files":
        return DocumentStore(directory, codec=codec)
    if backend == "packed" or native.available():
        return PackedDocumentStore(directory)
    return DocumentStore(directory, codec=codec)
