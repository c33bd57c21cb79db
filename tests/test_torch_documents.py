"""The port's document path on the CPU against the JAX package: the verify
skill's ``hash-64`` drive, document databases crossing between the packages
(both blob backends), the insert's write-ahead order (blobs, then the log
record, then the index), blobs dropped with their ids, and the lifecycle
(clear then insert, reopen, save to a new path)."""

import json
import os

import numpy as np
import pytest

import zebra_tpu as Z
import zebra_tpu_torch as T
from zebra_tpu_torch import defaults as TD
from zebra_tpu_torch.models.base import get_model

DIM = 64


def _docs(seed, n):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(500)]
    return [" ".join(rng.choice(words, int(rng.integers(3, 20)))).encode() + b" #%d" % i
            for i in range(n)]


def _cfg(pkg, dim=DIM):
    return pkg.DatabaseConfig(dim=dim, metric="cosine", model=f"hash-{dim}")


def _open(pkg, path):
    return T.Database.open(path, device="cpu") if pkg is T else Z.Database.open(path)


def _create(pkg, path, backend):
    """A fresh documents database of ``pkg`` with the given blob backend."""
    if pkg is T:
        db = T.Database(_cfg(T), path, device="cpu", blob_backend=backend)
    else:
        db = Z.Database(_cfg(Z), path, blob_backend=backend)
    db.save()
    return db


def test_skill_drive_hash64(tmp_path):
    """The library drive of the verify skill, on the port."""
    cfg = T.DatabaseConfig(dim=64, metric="cosine", model="hash-64")
    path = str(tmp_path / "demo.zebra")
    db = T.Database.open_or_create(path, cfg, device="cpu")
    assert db._docs.codec == "packed-zlib"
    ids = db.insert_documents([b"doc one", b"doc two"])
    res = db.query_documents([b"doc one"], number_of_results=3)
    assert res[0][ids[0]] == b"doc one"
    rows = db.query(db.model.embed_documents([b"doc one"]), 2, with_documents=True)
    assert rows[0][0][0] == ids[0] and rows[0][0][2] == b"doc one" and abs(rows[0][0][1]) < 1e-5
    assert db.model is get_model("hash-64", device="cpu")
    assert db.model_status() == {"semantic": False, "degradations": [], "model": "hash-64"}
    db.remove([ids[0]])
    db.deduplicate()
    db2 = T.Database.open(path, device="cpu")
    assert len(db2) == 1 and db2.query_documents([b"doc two"], 1) == {0: {ids[1]: b"doc two"}}
    db2.clear_database()
    assert not os.path.exists(path) and not os.path.exists(path + ".d")


@pytest.mark.parametrize("backend", ["packed", "files"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_document_databases_cross_open(tmp_path, backend, writer):
    """Written (inserted, removed, saved, then more inserts left in the log)
    by one package, opened by both: the same ``query_documents`` answers and
    blobs, and the manifest's blob fields the writer's."""
    w, r = (T, Z) if writer == "port" else (Z, T)
    path = str(tmp_path / "x.zebra")
    docs = _docs(1, 300)
    db = _create(w, path, backend)
    ids = db.insert_documents(docs[:250])
    db.remove(ids[:10])
    db.save()
    ids += db.insert_documents(docs[250:])  # replayed from the log on open
    with open(path) as f:
        manifest = json.load(f)
    assert manifest["blob_backend"] == backend
    assert manifest["codec"] == ("packed-zlib" if backend == "packed" else "zlib")
    queries = docs[:20] + docs[240:260]
    mine, theirs = _open(w, path), _open(r, path)
    assert len(mine) == len(theirs) == 290
    want = mine.query_documents(queries, 3)
    assert theirs.query_documents(queries, 3) == want
    assert all(want[q][ids[q + (0 if q < 20 else 220)]] == queries[q]
               for q in range(10, 40))
    assert theirs._docs.read_many(ids) == dict(zip(ids[10:], docs[10:]))


def test_insert_writes_blobs_then_the_log_then_the_index(tmp_path, monkeypatch):
    """One ``insert_documents``: the blob stage, then the fsync'd log record,
    then the index mutation (the JAX package's documented order)."""
    db = T.Database.create(str(tmp_path / "o.zebra"), _cfg(T), device="cpu")
    order = []

    def spy(obj, name, tag):
        fn = getattr(obj, name)

        def wrapped(*a, **k):
            order.append(tag)
            return fn(*a, **k)

        monkeypatch.setattr(obj, name, wrapped)

    spy(db._docs, "save_many", "blobs")
    spy(db._delta, "append_insert", "log")
    spy(db._delta, "append_insert_q8", "log")
    spy(db.index, "_insert_batch_dev", "index")
    db.insert_documents(_docs(2, 50))
    assert order == ["blobs", "log", "index"]
    assert {"insert", "insert.embed", "insert.blobs", "insert.index", "insert.wal"} <= set(
        db.stats.summary())
    db.query_documents(_docs(2, 3), 1)
    assert {"query", "query.embed"} <= set(db.stats.summary())


def test_a_logged_insert_survives_without_a_save(tmp_path):
    path = str(tmp_path / "l.zebra")
    docs = _docs(3, 40)
    db = T.Database.create(path, _cfg(T), device="cpu")
    ids = db.insert_documents(docs)
    again = T.Database.open(path, device="cpu")  # no save: the log replays
    assert again.query_documents(docs[:5], 1) == {q: {ids[q]: docs[q]} for q in range(5)}


@pytest.mark.parametrize("backend", ["packed", "files"])
def test_remove_and_deduplicate_drop_the_blobs(tmp_path, backend):
    path = str(tmp_path / "r.zebra")
    docs = _docs(4, 60)
    db = _create(T, path, backend)
    ids = db.insert_documents(docs)
    copies = db.insert_documents(docs[:15])  # equal bytes, equal vectors
    db.remove(ids[40:45] + [b"\x07" * 16])
    assert db._docs.read_many(ids[40:45]) == {}
    db.deduplicate()
    assert len(db) == 55 and db._docs.read_many(copies) == {}
    kept = [i for i in ids if i not in ids[40:45]]
    assert db._docs.read_many(kept) == {i: d for i, d in zip(ids, docs) if i in kept}
    reopened = T.Database.open(path, device="cpu")  # the removes replay too
    assert reopened._docs.read_many(copies + ids[40:45]) == {}
    assert len(reopened) == 55


@pytest.mark.parametrize("backend", ["packed", "files"])
def test_clear_then_insert_then_reopen(tmp_path, backend):
    """The store is closed before the directory goes: documents inserted
    after a clear are there after a reopen."""
    path = str(tmp_path / "c.zebra")
    db = _create(T, path, backend)
    db.insert_documents(_docs(5, 20))
    db.clear_database()
    assert not os.path.exists(path + ".d")
    fresh = _docs(6, 10)
    ids = db.insert_documents(fresh)
    db.save()
    again = T.Database.open(path, device="cpu")
    assert len(again) == 10
    assert again.query_documents(fresh, 1) == {q: {ids[q]: fresh[q]} for q in range(10)}


def test_save_to_a_new_path_copies_the_blobs(tmp_path):
    docs = _docs(7, 30)
    db = T.Database.create(str(tmp_path / "a.zebra"), _cfg(T), device="cpu")
    ids = db.insert_documents(docs)
    other = str(tmp_path / "b.zebra")
    db.save(other)
    copy = T.Database.open(other, device="cpu")
    assert copy.query_documents(docs[:4], 1) == {q: {ids[q]: docs[q]} for q in range(4)}
    db.close()
    assert db.query_documents(docs[:2], 1) == {q: {ids[q]: docs[q]} for q in range(2)}


def test_manifest_backends(tmp_path):
    """A manifest the port wrote before it stored documents (per-file, zlib)
    keeps its backend; one without ``blob_backend`` is inferred from its
    codec."""
    path = str(tmp_path / "m.zebra")
    db = T.Database.create(path, _cfg(T), device="cpu")
    db.insert_documents(_docs(8, 5))
    db.save()
    with open(path) as f:
        manifest = json.load(f)
    assert (manifest["codec"], manifest["blob_backend"]) == ("packed-zlib", "packed")
    del manifest["blob_backend"]
    with open(path, "w") as f:
        json.dump(manifest, f)
    assert T.Database.open(path, device="cpu")._docs.codec == "packed-zlib"
    old = str(tmp_path / "old.zebra")
    T.Database(_cfg(T), old, device="cpu", codec="zlib", blob_backend="files").save()
    again = T.Database.open(old, device="cpu")
    assert again._docs.codec == "zlib" and again._blob_backend == "files"


def test_vectors_only_and_argument_checks(tmp_path):
    db = T.Database.create(str(tmp_path / "v.zebra"), T.DatabaseConfig(dim=8), device="cpu")
    assert db.model_status() == {"model": None, "semantic": False,
                                 "degradations": ["vectors-only database (no model)"]}
    with pytest.raises(ValueError, match="no embedding model"):
        db.model
    assert db.query_documents([b"x"]) == {} and db.query_vectors(np.zeros(8)) == {}
    with pytest.raises(ValueError, match="length mismatch"):
        db.insert_records(np.zeros((2, 8), np.float32), [b"one"])
    assert db.insert_records(np.zeros((0, 8), np.float32), []) == []
    ids = db.insert_records(np.eye(8, dtype=np.float32)[:3], [b"a", b"b", b"c"])
    assert db.query_vectors(np.eye(8, dtype=np.float32)[1], 1) == {0: {ids[1]: b"b"}}
    assert db.query(np.eye(8, dtype=np.float32)[2], 1, with_documents=True) == [
        [(ids[2], 0.0, b"c")]]


def test_tied_centroids_place_rows_where_their_queries_probe(tmp_path):
    """Below 128 cells a row's placement breaks equal scores toward the
    lowest cell, as the JAX package's ``lax.top_k`` and both packages' exact
    probe selection do: with fewer distinct rows than cells (duplicated
    centroids) every row is found by its own query."""
    import jax.numpy as jnp
    import torch

    from zebra_tpu.index import ivf as ZV
    from zebra_tpu_torch.index import ivf as TV

    eye = np.eye(8, dtype=np.float32)
    cents = eye[[2, 1, 0, 1, 1, 1, 2, 1]]
    for metric in ("cosine", "sql2"):
        got = TV._cell_choice(torch.from_numpy(eye[:3]), torch.from_numpy(cents), metric, 4)
        want = ZV._cell_choice(jnp.asarray(eye[:3]), jnp.asarray(cents), metric, 4)
        assert np.array_equal(got.numpy(), np.asarray(want))
    db = T.Database(T.DatabaseConfig(dim=8), str(tmp_path / "e.zebra"), device="cpu")
    ids = db.insert_records(eye[:3], [b"a", b"b", b"c"])
    assert db.query_vectors(eye[:3], 1) == {q: {ids[q]: b"abc"[q : q + 1]} for q in range(3)}


def test_crowded_queries_keep_their_nearest_cell():
    """Probe selection's stage 1 (K >= 128) orders equal bf16 scores by
    their unrounded value: a query whose nearest centroid shares its bf16
    score with more than 2P others still probes that centroid (an inserted
    document then finds itself). The data is crowded so that it does: most
    queries' nearest cell ties with others after the rounding."""
    import torch

    from zebra_tpu_torch.index import ivf as TV

    g = torch.Generator().manual_seed(0)
    base = torch.randn(64, generator=g)
    cents = base / base.norm() + 0.008 * torch.randn(512, 64, generator=g)
    q = cents[torch.randint(0, 512, (2000,), generator=g)] + 2e-4 * torch.randn(2000, 64,
                                                                              generator=g)
    st = TV.empty_state(cents, 16, 64, dtype=torch.float32, refine=False)
    nearest = torch.argmin(torch.cdist(q.double(), cents.double()), 1)
    cb, cn2 = TV.probe_operands(st)
    rounded = (2.0 * (q.to(torch.bfloat16).float() @ cb.float().T) - cn2).to(torch.bfloat16)
    ties = (rounded == rounded.gather(1, nearest[:, None])).sum(1)
    assert int((ties > 4).sum()) > 200  # more ties than the 2P = 4 candidates hold
    probes = TV.select_probes(st, q, 2, "sql2")
    assert bool((probes == nearest[:, None]).any(1).all())


def test_defaults_are_the_jax_packages():
    from zebra_tpu import defaults as ZD

    for name in ("text_config", "image_config", "audio_config"):
        assert getattr(TD, name)().to_json() == getattr(ZD, name)().to_json()
    assert T.text_db is TD.text_db and T.defaults is TD
    assert {"DefaultTextDatabase", "DefaultImageDatabase", "DefaultAudioDatabase", "text_db",
            "image_db", "audio_db", "defaults"} <= set(T.__all__)


def test_default_databases_pass_their_device(tmp_path):
    """The image and audio defaults put the index and the tower on the
    device they are given (the towers' answers: ``tests/test_torch_media.py``)."""
    db = TD.DefaultImageDatabase.open_or_create(str(tmp_path / "i.zebra"), device="cpu")
    assert db.index.device.type == "cpu" and db.config.model == "vit-base-patch16-224"
    assert db.model.device.type == "cpu" and db.model.batch_size == 32
    audio = TD.audio_db(str(tmp_path / "a.zebra"), device="cpu")
    assert audio.model.device.type == "cpu" and audio.model.batch_size == 16
    status = audio.model_status()
    assert status["model"] == "vit-audio" and not status["semantic"]
    assert any("random-init ViT" in d for d in status["degradations"])
