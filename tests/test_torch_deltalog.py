"""The port's delta log against the JAX package's: ``tests/test_deltalog.py``
held on the port, with the log written by one package and replayed by the
other where the format is at stake (torn tail, corrupt CRC, record types),
and the port's own bf16 bit conversion (the JAX package uses ``ml_dtypes``)
held to ``ml_dtypes`` bit for bit."""

from __future__ import annotations

import os
import struct

import ml_dtypes
import numpy as np
import pytest
from hypothesis import example, given, settings
from hypothesis import strategies as st

import zebra_tpu_torch as T
from zebra_tpu.config import DatabaseConfig as ZConfig
from zebra_tpu.config import IndexOptions as ZOptions
from zebra_tpu.db import Database as ZDatabase
from zebra_tpu.storage import deltalog as ZL
from zebra_tpu_torch.storage import deltalog as TL

LOGS = {"jax": ZL.DeltaLog, "port": TL.DeltaLog}
PAIRS = [("jax", "port"), ("port", "jax"), ("port", "port")]


def _cfg(**kw):
    kw.setdefault("dim", 16)
    kw.setdefault("metric", "sql2")
    return T.DatabaseConfig(index=T.IndexOptions(seed=0), **kw)


def _vecs(rng, n, dim=16):
    return rng.standard_normal((n, dim)).astype(np.float32)


def _open(path):
    return T.Database.open(path, device="cpu")


def _create(path, cfg):
    return T.Database.create(path, cfg, device="cpu")


def _same_ops(a, b):
    assert [(op, ids) for op, ids, _ in a] == [(op, ids) for op, ids, _ in b]
    for (_, _, x), (_, _, y) in zip(a, b):
        if x is None:
            assert y is None
        else:
            np.testing.assert_array_equal(x, y)


# -- the log itself, written by one package and read by the other --------------


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_log_roundtrip(tmp_path, rng, writer, reader):
    log = LOGS[writer](str(tmp_path / "d.log"))
    ids = [bytes([i + 1]) + bytes(15) for i in range(5)]
    v = _vecs(rng, 5)
    log.append_insert(ids, v)
    log.append_insert(ids[:2], v[:2], bf16=True)
    log.append_remove(ids[:2])
    log.close()
    ops = list(LOGS[reader](log.path).replay())
    assert [op for op, *_ in ops] == ["insert", "insert", "remove"] and ops[0][1] == ids
    np.testing.assert_array_equal(ops[0][2], v)
    np.testing.assert_array_equal(ops[1][2], v[:2].astype(ml_dtypes.bfloat16).astype(np.float32))
    assert ops[2][1] == ids[:2]
    _same_ops(ops, list(LOGS[writer](log.path).replay()))
    log = LOGS[reader](log.path)
    log.reset()
    assert list(log.replay()) == [] and log.size() == 0


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_log_torn_tail_truncated(tmp_path, rng, writer, reader):
    log = LOGS[writer](str(tmp_path / "d.log"))
    ids = [bytes([1]) + bytes(15)]
    log.append_insert(ids, _vecs(rng, 1))
    log.append_insert([bytes([2]) + bytes(15)], _vecs(rng, 1))
    log.close()
    size = os.path.getsize(log.path)
    with open(log.path, "r+b") as f:  # torn write: cut the last record short
        f.truncate(size - 7)
    other = LOGS[reader](log.path)
    ops = list(other.replay())
    assert len(ops) == 1 and ops[0][1] == ids
    assert os.path.getsize(log.path) < size - 7  # tail removed
    # appends after the recovery replay cleanly, in either package
    other.append_remove(ids)
    other.close()
    for cls in LOGS.values():
        assert [op for op, *_ in cls(log.path).replay()] == ["insert", "remove"]


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_log_corrupt_crc_stops_replay(tmp_path, rng, writer, reader):
    log = LOGS[writer](str(tmp_path / "d.log"))
    log.append_insert([bytes([1]) + bytes(15)], _vecs(rng, 1))
    log.append_insert([bytes([2]) + bytes(15)], _vecs(rng, 1))
    log.close()
    with open(log.path, "r+b") as f:  # flip a payload byte of record 2
        f.seek(os.path.getsize(log.path) - 3)
        f.write(b"\xff")
    ops = list(LOGS[reader](log.path).replay())
    assert len(ops) == 1 and ops[0][1] == [bytes([1]) + bytes(15)]


# -- the facade: durability="full" ---------------------------------------------


def test_crash_reopen_replays_inserts(tmp_path, rng):
    path = str(tmp_path / "db.zebra")
    db = _create(path, _cfg(durability="full"))
    v = _vecs(rng, 50)
    docs = [f"doc{i}".encode() for i in range(50)]
    ids = db.insert_records(v, docs)
    db2 = _open(path)  # no save: the log alone carries the rows
    assert len(db2) == 50
    out = db2.query_vectors(v[:5], number_of_results=1)
    for qi in range(5):
        assert out[qi] == {ids[qi]: docs[qi]}


def test_crash_reopen_replays_removes(tmp_path, rng):
    path = str(tmp_path / "db.zebra")
    db = _create(path, _cfg(durability="full"))
    v = _vecs(rng, 30)
    ids = db.insert_records(v, [b"x"] * 30)
    db.save()
    db.remove(ids[:10])  # logged only
    db2 = _open(path)
    assert len(db2) == 20
    gone = set(ids[:10])
    for row in db2.query(v[:10], number_of_results=1):
        assert row and row[0][0] not in gone


def test_save_resets_log_and_replay_is_idempotent(tmp_path, rng):
    path = str(tmp_path / "db.zebra")
    db = _create(path, _cfg(durability="full"))
    v = _vecs(rng, 20)
    ids = db.insert_records(v, [b"d"] * 20)
    db.save()
    assert db._delta.size() == 0
    # a crash between the snapshot and the log reset: a record whose ids the
    # snapshot already holds
    db._delta.append_insert(ids[:5], v[:5])
    db._delta.close()
    db2 = _open(path)
    assert len(db2) == 20


def test_explicit_durability_writes_no_log(tmp_path, rng):
    path = str(tmp_path / "db.zebra")
    db = _create(path, _cfg(durability="explicit"))
    db.insert_records(_vecs(rng, 10), [b"d"] * 10)
    assert db._delta.size() == 0
    assert len(_open(path)) == 0  # not durable without save()


def test_clear_database_drops_log(tmp_path, rng):
    path = str(tmp_path / "db.zebra")
    db = _create(path, _cfg(durability="full"))
    db.insert_records(_vecs(rng, 10), [b"d"] * 10)
    assert db._delta.size() > 0
    db.clear_database()
    assert db._delta.size() == 0
    db.save()
    assert len(_open(path)) == 0


def test_mixed_ops_replay_order(tmp_path, rng):
    path = str(tmp_path / "db.zebra")
    db = _create(path, _cfg(durability="full"))
    v = _vecs(rng, 40)
    ids = db.insert_records(v[:20], [b"a"] * 20)
    db.remove(ids[:5])
    ids2 = db.insert_records(v[20:], [b"b"] * 20)
    db.remove([ids2[0], ids[6]])
    db2 = _open(path)
    assert len(db2) == 33
    assert ids[7] in db2.index and ids2[1] in db2.index
    assert ids[0] not in db2.index and ids2[0] not in db2.index


def test_bf16_log_records_halve_and_replay(tmp_path, rng):
    log = TL.DeltaLog(str(tmp_path / "b.log"))
    ids = [bytes([i + 1]) + bytes(15) for i in range(8)]
    v = _vecs(rng, 8)
    log.append_insert(ids, v, bf16=True)
    size_bf16 = log.size()
    log.reset()
    log.append_insert(ids, v, bf16=False)
    assert size_bf16 < log.size()
    log.reset()
    log.append_insert(ids, v, bf16=True)
    (op, got_ids, got_v), = list(log.replay())
    assert op == "insert" and got_ids == ids
    np.testing.assert_array_equal(got_v, v.astype(ml_dtypes.bfloat16).astype(np.float32))


def test_bf16_database_crash_replay(tmp_path, rng):
    path = str(tmp_path / "db.zebra")
    cfg = T.DatabaseConfig(dim=16, metric="sql2", durability="full",
                           index=T.IndexOptions(seed=0, index_type="ivf", dtype="bfloat16"))
    db = _create(path, cfg)
    v = _vecs(rng, 40)
    ids = db.insert_records(v, [b"d"] * 40)
    db2 = _open(path)
    assert len(db2) == 40
    for i, row in enumerate(db2.query(v[:5], number_of_results=1)):
        assert row[0][0] == ids[i]


def _first_rtype(path):
    with open(path, "rb") as f:
        magic, rtype, _, _ = TL._HDR.unpack(f.read(TL._HDR.size))
    assert magic == TL._MAGIC
    return rtype


def test_log_dtype_follows_index_wire(tmp_path, rng):
    """Both packages log the same record type for each tier (int8 slabs
    bf16, refined int8 the q8 pair, f32 slabs f32), and the port's replay
    of its own log is lossless."""
    assert (TL.INSERT, TL.INSERT_BF16, TL.INSERT_Q8, TL._MAGIC, TL._HDR.format) == (
        ZL.INSERT, ZL.INSERT_BF16, ZL.INSERT_Q8, ZL._MAGIC, ZL._HDR.format)
    v = _vecs(rng, 12)
    for dtype, refine, want in (("int8", 0, TL.INSERT_BF16), ("int8", 4, TL.INSERT_Q8),
                                ("float32", 0, TL.INSERT), ("bfloat16", 0, TL.INSERT_BF16)):
        opts = dict(seed=0, index_type="ivf", dtype=dtype, refine=refine)
        path = str(tmp_path / f"{dtype}{refine}.zebra")
        db = _create(path, T.DatabaseConfig(dim=16, metric="sql2", durability="full",
                                            index=T.IndexOptions(**opts)))
        ids = db.insert_vectors(v)
        assert _first_rtype(db._delta.path) == want, (dtype, refine)
        jpath = str(tmp_path / f"j{dtype}{refine}.zebra")
        jdb = ZDatabase.create(jpath, ZConfig(dim=16, metric="sql2", durability="full",
                                              index=ZOptions(**opts)))
        jdb.insert_vectors(v)
        assert _first_rtype(jdb._delta.path) == want, (dtype, refine)
        jdb._delta.close()
        db2 = _open(path)  # crash-reopen replays losslessly
        assert len(db2) == 12
        for i, row in enumerate(db2.query(v[:4], number_of_results=1)):
            assert row[0][0] == ids[i]
        db2._delta.close()
        db._delta.close()


# -- the port's bf16 bit conversion against ml_dtypes --------------------------

_SPECIAL = [
    0x00000000, 0x80000000,  # +-0
    0x7F800000, 0xFF800000,  # +-inf
    0x00000001, 0x807FFFFF, 0x00008000, 0x80018000,  # subnormals, ties at the boundary
    0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F8000,  # the largest finites round up to inf
    0x7FC00000, 0xFFC00001, 0x7FE12345,  # quiet NaN of both signs, with payloads
    0x7F800001, 0xFF810000, 0x7FA00000, 0xFFBFFFFF,  # signalling NaN of both signs
    0x3F808000, 0x3F818000,  # round-to-nearest-even ties, down and up
]


@settings(max_examples=60, deadline=None)
@given(bits=st.lists(st.integers(0, 2**32 - 1), min_size=1, max_size=64))
@example(bits=_SPECIAL)
def test_bf16_bits_match_ml_dtypes(bits):
    x = np.array(bits, dtype=np.uint32).view(np.float32)
    with np.errstate(invalid="ignore"):
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(TL._f32_to_bf16_bits(x), want)


def test_bf16_records_match_the_jax_packages_bytes(tmp_path):
    """Every bf16 bit pattern decodes as ``ml_dtypes`` decodes it, and a
    record of the specials is byte for byte the JAX package's."""
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    ids = [bytes([1]) + bytes(15)]
    logs = {}
    for name, cls in LOGS.items():
        path = str(tmp_path / f"{name}.log")
        log = cls(path)
        x = np.array(_SPECIAL, dtype=np.uint32).view(np.float32)[None]
        with np.errstate(invalid="ignore"):
            log.append_insert(ids, x, bf16=True)
        log.close()
        logs[name] = open(path, "rb").read()
    assert logs["port"] == logs["jax"]
    payload = struct.pack("<II", 1, 1 << 16) + ids[0] + bits.tobytes()
    path = str(tmp_path / "all.log")
    ZL.DeltaLog(path)._append(ZL.INSERT_BF16, payload)
    (_, _, got), = list(TL.DeltaLog(path).replay())
    want = bits.view(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want[None].view(np.uint32))
