"""The torch port's ``Database`` facade on the CPU, and databases crossing
between the two packages: a database written by one opens in the other and
answers the same top-10 (ids equal, distances within 1e-4: both score the
same stored int8 + residual reconstruction in f32)."""

import os
import subprocess
import sys

import numpy as np
import pytest

import zebra_tpu as Z
import zebra_tpu_torch as T

N, DIM = 4096, 128
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _data(seed=0, n=N + 64):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((40, DIM)).astype(np.float32)
    x = centers[rng.integers(0, 40, n)] + 0.15 * rng.standard_normal((n, DIM)).astype(np.float32)
    return x[:N], x[N:]


def assert_same_results(a, b):
    assert [[i for i, _ in row] for row in a] == [[i for i, _ in row] for row in b]
    np.testing.assert_allclose([[d for _, d in row] for row in a],
                               [[d for _, d in row] for row in b], rtol=1e-4, atol=1e-4)


def test_facade_create_insert_query_remove_save_open(tmp_path):
    base, queries = _data()
    path = str(tmp_path / "t.zebra")
    db = T.Database.create(path, T.DatabaseConfig(dim=DIM))
    assert db.index.options.rerank == "eager"  # resolved for the CPU
    ids = db.insert_vectors(base)
    assert len(db) == N
    top1 = db.query(base[:200], 1)
    assert [row[0][0] for row in top1] == ids[:200]
    exact = db.index.search(base[:20], 1, exact=True)  # the whole-slab scan
    assert [row[0][0] for row in exact] == ids[:20]
    gone = ids[:50]
    db.remove(gone + [b"\x01" * 16])  # an unknown id is ignored
    assert len(db) == N - 50
    assert not {i for row in db.query(base[:50], 10) for i, _ in row} & set(gone)
    want = db.query(queries, 10)
    db.save()
    again = T.Database.open(path)
    assert len(again) == N - 50
    assert_same_results(again.query(queries, 10), want)
    again.clear_database()
    assert not os.path.exists(path) and not os.path.exists(path + ".d")


def test_jax_written_database_opens_in_the_port(tmp_path):
    base, queries = _data(1)
    path = str(tmp_path / "j.zebra")
    jdb = Z.Database.create(path, Z.DatabaseConfig(dim=DIM))
    ids = jdb.insert_vectors(base)
    jdb.remove(ids[:20])
    want = jdb.query(queries, 10)
    jdb.close()
    tdb = T.Database.open(path)
    assert len(tdb) == N - 20
    assert_same_results(tdb.query(queries, 10), want)


def test_port_written_database_opens_in_jax(tmp_path):
    base, queries = _data(2)
    path = str(tmp_path / "p.zebra")
    tdb = T.Database.create(path, T.DatabaseConfig(dim=DIM))
    ids = tdb.insert_vectors(base)
    tdb.remove(ids[:20])
    want = tdb.query(queries, 10)
    tdb.close()
    jdb = Z.Database.open(path)
    assert len(jdb) == N - 20
    assert_same_results(jdb.query(queries, 10), want)
    jdb.close()


def test_wal_replays_on_open_in_both_packages(tmp_path):
    """Inserts and a remove that were never saved come back from the
    write-ahead log — in the port, and in the JAX package reading the
    port's q8 records (and the reverse)."""
    base, queries = _data(3)
    path = str(tmp_path / "w.zebra")
    tdb = T.Database.create(path, T.DatabaseConfig(dim=DIM))
    ids = tdb.insert_vectors(base)
    tdb.remove(ids[:10])
    want = tdb.query(queries, 10)
    assert os.path.getsize(path + ".d/delta.log") > N * 2 * DIM  # logged, not saved
    replayed = T.Database.open(path)
    assert len(replayed) == N - 10
    assert_same_results(replayed.query(queries, 10), want)
    jdb = Z.Database.open(path)
    assert len(jdb) == N - 10
    assert_same_results(jdb.query(queries, 10), want)

    path2 = str(tmp_path / "w2.zebra")
    jdb2 = Z.Database.create(path2, Z.DatabaseConfig(dim=DIM))
    jids = jdb2.insert_vectors(base)
    jdb2.remove(jids[-5:])
    want2 = jdb2.query(queries, 10)
    tdb2 = T.Database.open(path2)
    assert len(tdb2) == N - 5
    assert_same_results(tdb2.query(queries, 10), want2)


def test_import_leaves_jax_out():
    code = "import sys, zebra_tpu_torch; sys.exit(1 if 'jax' in sys.modules else 0)"
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_unported_surfaces_raise(tmp_path):
    db = T.Database.create(str(tmp_path / "u.zebra"), T.DatabaseConfig(dim=8))
    for call in (lambda: db.insert_documents([b"x"]), lambda: db.deduplicate(),
                 lambda: db.query_documents([b"x"]), lambda: db.model):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.Database.create(str(tmp_path / "f.zebra"),
                          T.DatabaseConfig(dim=8, index=T.IndexOptions(index_type="flat")))

