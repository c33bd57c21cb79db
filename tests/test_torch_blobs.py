"""The port's native blob log, id map and document stores against the JAX
package's (``zebra_tpu/native``, ``zebra_tpu/storage/blobs.py``): the same
puts give the same log bytes, and every store written by one package reads
in the other."""

import os

import numpy as np
import pytest

from zebra_tpu import native as JN
from zebra_tpu.storage import blobs as JB
from zebra_tpu_torch import native as TN
from zebra_tpu_torch.index.base import IdSlotMap
from zebra_tpu_torch.storage import blobs as TB


def _docs(seed, n=40):
    """Seeded keys and payloads: compressible text, incompressible bytes,
    an empty one."""
    rng = np.random.default_rng(seed)
    keys = [rng.bytes(16) for _ in range(n)]
    docs = [(f"document {i} " * int(rng.integers(1, 50))).encode() if i % 3 else rng.bytes(
        int(rng.integers(0, 300))) for i in range(n)]
    docs[0] = b""
    return keys, docs


def _log(d):
    with open(os.path.join(d, "blobs.log"), "rb") as f:
        return f.read()


def test_both_libraries_build():
    assert TN.available() and JN.available()
    assert TN.get_lib() is not JN.get_lib()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_logs_cross_open(tmp_path, writer):
    """Puts, an overwrite and deletes through one package; the other reads
    the log back, and the same calls through both give identical bytes."""
    keys, docs = _docs(1)
    logs = {}
    for name, mod in (("port", TN), ("jax", JN)):
        d = str(tmp_path / name)
        s = mod.NativeBlobStore(d)
        for k, v in zip(keys, docs):
            s.put(k, v)
        s.put(keys[5], b"overwritten")
        s.put(keys[6], docs[6], compress=False)
        for k in keys[30:]:
            s.delete(k)
        s.flush()
        s.close()
        logs[name] = _log(d)
    assert logs["port"] == logs["jax"]
    reader = (JN if writer == "port" else TN).NativeBlobStore(str(tmp_path / writer))
    assert len(reader) == 30
    assert reader.get(keys[5]) == b"overwritten"
    assert all(reader.get(k) == v for k, v in zip(keys[6:30], docs[6:30]))
    assert all(reader.get(k) is None for k in keys[30:])
    reader.close()


def test_truncated_tail_is_dropped(tmp_path):
    d = str(tmp_path / "log")
    s = TN.NativeBlobStore(d)
    k1, k2 = b"\x0a" * 16, b"\x0b" * 16
    s.put(k1, b"intact record")
    s.put(k2, b"this one gets torn")
    s.close()
    path = os.path.join(d, "blobs.log")
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 7)
    s2 = TN.NativeBlobStore(d)
    assert s2.get(k1) == b"intact record"
    assert s2.get(k2) is None
    s2.put(k2, b"rewritten")  # appends start at the clean boundary
    assert s2.get(k2) == b"rewritten"
    s2.close()
    j = JN.NativeBlobStore(d)
    assert j.get(k1) == b"intact record" and j.get(k2) == b"rewritten"
    j.close()


def test_overwrite_last_wins_and_compact_reclaims(tmp_path):
    d = str(tmp_path / "log")
    s = TN.NativeBlobStore(d)
    k = b"\x09" * 16
    s.put(k, b"first")
    s.put(k, b"second")
    assert s.get(k) == b"second" and len(s) == 1
    big = np.random.default_rng(2).bytes(50_000)
    keys = [bytes([i]) + b"\x01" * 15 for i in range(1, 11)]
    for key in keys:
        s.put(key, big)
    for key in keys[:9]:
        s.delete(key)
    s.flush()
    before = os.path.getsize(os.path.join(d, "blobs.log"))
    s.compact()
    after = os.path.getsize(os.path.join(d, "blobs.log"))
    assert after < before / 2
    assert s.get(keys[9]) == big and s.get(k) == b"second"
    s.close()
    j = JN.NativeBlobStore(d)
    assert len(j) == 2 and j.get(keys[9]) == big and j.get(k) == b"second"
    j.close()


def test_id_map_matches_jax():
    """Bulk put/get, single puts, deletes and put/delete churn of distinct
    keys give the JAX map's answers."""
    rng = np.random.default_rng(3)
    keys = [rng.bytes(16) for _ in range(3000)]
    flat = b"".join(keys)
    vals = rng.integers(0, 1 << 40, 3000)
    maps = [TN.NativeIdMap(64), JN.NativeIdMap(64)]
    for m in maps:
        m.put_many(flat, vals)
        for i in range(0, 3000, 7):
            m.put(keys[i], i)
        for i in range(0, 3000, 5):
            m.delete(keys[i])
        for i in range(20_000):  # churn: tombstones must not saturate
            k = (i + 7).to_bytes(16, "little")
            m.put(k, i)
            m.delete(k)
    (t, j) = maps
    assert len(t) == len(j) == 3000 - 600
    np.testing.assert_array_equal(t.get_many(flat), j.get_many(flat))
    missing = b"".join(rng.bytes(16) for _ in range(100))
    assert (t.get_many(missing) == -1).all()
    assert [t.get(k) for k in keys[:50]] == [j.get(k) for k in keys[:50]]


@pytest.mark.parametrize("native", [True, False])
def test_id_slot_map_paths_agree(native, monkeypatch):
    """``IdSlotMap`` on the native table and on the dict answers alike."""
    if not native:
        monkeypatch.setattr(TN, "available", lambda: False)
    m = IdSlotMap()
    assert (m._native is not None) == native
    rng = np.random.default_rng(4)
    keys = [rng.bytes(16) for _ in range(500)]
    m.put_many(keys, np.arange(500, dtype=np.int64) * 3)
    assert len(m) == 500 and keys[10] in m and rng.bytes(16) not in m
    assert m.get(keys[7]) == 21 and m.pop(keys[7]) == 21 and m.pop(keys[7], -5) == -5
    assert keys[7] not in m and len(m) == 499


@pytest.mark.parametrize("backend", ["files", "packed"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_document_stores_cross_read(tmp_path, backend, writer):
    keys, docs = _docs(5)
    d = str(tmp_path / "docs")
    w = (TB if writer == "port" else JB).make_document_store(d, backend=backend)
    w.save_many(keys, docs)
    w.remove_many(keys[:4])
    r = (JB if writer == "port" else TB).make_document_store(d, backend=backend,
                                                            codec=w.codec if backend == "files"
                                                            else None)
    assert r.codec == w.codec == ("packed-zlib" if backend == "packed" else "zlib")
    got = r.read_many(keys + [b"\x00" * 16])
    assert got == dict(zip(keys[4:], docs[4:]))
    r.clear()
    assert not os.path.exists(d)


def test_per_file_layout_is_the_jax_packages(tmp_path):
    keys, docs = _docs(6, n=5)
    t, j = TB.DocumentStore(str(tmp_path / "t")), JB.DocumentStore(str(tmp_path / "j"))
    t.save_many(keys, docs)
    j.save_many(keys, docs)
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j")) == sorted(f"{k.hex()}.z" for k in keys)
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()


def test_make_document_store_choice(tmp_path, monkeypatch):
    d = str(tmp_path / "x")
    assert isinstance(TB.make_document_store(d), TB.PackedDocumentStore)
    assert isinstance(TB.make_document_store(d, backend="files"), TB.DocumentStore)
    monkeypatch.setattr(TN, "available", lambda: False)
    assert isinstance(TB.make_document_store(d), TB.DocumentStore)
    assert isinstance(TB.make_document_store(d, backend="packed"), TB.PackedDocumentStore)
    if not TB._HAVE_LZ4:
        with pytest.raises(RuntimeError, match="lz4"):
            TB.DocumentStore(d, codec="lz4")


def test_packed_store_is_lazy_and_reopens(tmp_path):
    """Construction creates nothing; ``close`` keeps the data and the next
    access reopens; ``clear`` closes before it removes, and a store made
    afterwards writes to a fresh log."""
    d = str(tmp_path / "p")
    s = TB.PackedDocumentStore(d)
    assert not os.path.exists(d) and s.read_many([b"\x01" * 16]) == {}
    s.save_many([b"\x01" * 16], [b"one"])
    s.close()
    assert s.read_many([b"\x01" * 16]) == {b"\x01" * 16: b"one"}
    s.clear()
    assert not os.path.exists(d)
    s2 = TB.PackedDocumentStore(d)
    s2.save_many([b"\x02" * 16], [b"two"])
    assert TB.PackedDocumentStore(d).read_many([b"\x01" * 16, b"\x02" * 16]) == {
        b"\x02" * 16: b"two"}


def test_build_lands_in_the_build_directory():
    """The store library is built under ``zebra_tpu_torch/_build`` with the
    source's hash in its name, never beside the source."""
    native_dir = os.path.dirname(TN.__file__)
    assert not [f for f in os.listdir(native_dir) if f.endswith(".so")]
    built = [f for f in os.listdir(TN.BUILD_DIR) if f.startswith("libzebra_store-")]
    assert built and all(f.endswith(".so") for f in built)
