"""The torch port's ``Database`` facade on the CPU (``device="cpu"``: the
port runs on the card unless asked), and databases crossing between the two
packages: a database written by one opens in the other and answers the same
top-10 (ids equal, distances within 1e-4: both score the same stored values
in f32) — at the library defaults (``refine="scan"``), on the gather-refine
tier (``refine=4``, with and without ``rerank="pallas2"``, which both
packages run as their plain re-rank on a CPU), and on the array-wire tiers:
bf16 (``IndexOptions.tier("balanced")``), f32 and plain int8."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import zebra_tpu as Z
import zebra_tpu_torch as T

N, DIM = 4096, 128
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _data(seed=0, n=N + 64):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((40, DIM)).astype(np.float32)
    x = centers[rng.integers(0, 40, n)] + 0.15 * rng.standard_normal((n, DIM)).astype(np.float32)
    return x[:N], x[N:]


def assert_same_results(a, b, ties=False):
    """The same ids in the same order, distances within 1e-4. ``ties``: the
    array-wire tiers store values, and neighbours 1e-7 apart (or equal) may
    swap ranks between two f32 sums taken in another order, or between two
    placements; there every id both lists hold must carry the same distance,
    and the distances rank by rank agree as before."""
    if ties:
        for ra, rb in zip(a, b):
            db = dict(rb)
            np.testing.assert_allclose([d for i, d in ra if i in db],
                                       [db[i] for i, _ in ra if i in db], rtol=1e-4, atol=1e-4)
    else:
        assert [[i for i, _ in row] for row in a] == [[i for i, _ in row] for row in b]
    np.testing.assert_allclose([[d for _, d in row] for row in a],
                               [[d for _, d in row] for row in b], rtol=1e-4, atol=1e-4)


def test_facade_create_insert_query_remove_save_open(tmp_path):
    base, queries = _data()
    path = str(tmp_path / "t.zebra")
    db = T.Database.create(path, T.DatabaseConfig(dim=DIM), device="cpu")
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
    again = T.Database.open(path, device="cpu")
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
    tdb = T.Database.open(path, device="cpu")
    assert len(tdb) == N - 20
    assert_same_results(tdb.query(queries, 10), want)


def test_port_written_database_opens_in_jax(tmp_path):
    base, queries = _data(2)
    path = str(tmp_path / "p.zebra")
    tdb = T.Database.create(path, T.DatabaseConfig(dim=DIM), device="cpu")
    ids = tdb.insert_vectors(base)
    tdb.remove(ids[:20])
    want = tdb.query(queries, 10)
    tdb.close()
    jdb = Z.Database.open(path)
    assert len(jdb) == N - 20
    assert_same_results(jdb.query(queries, 10), want)
    jdb.close()


#: the tier preset IndexOptions.tier("balanced"), spelled as options
BALANCED = dict(dtype="bfloat16", refine=0, num_probes=4)
TIERS = [dict(refine=4), dict(refine=4, rerank="pallas2"), BALANCED,
         dict(dtype="float32", refine=0), dict(dtype="int8", refine=0)]
TIER_IDS = ["refine4", "refine4-pallas2", "balanced", "f32", "int8"]


@pytest.mark.parametrize("options", TIERS, ids=TIER_IDS)
def test_jax_written_refine_database_opens_in_the_port(tmp_path, options):
    base, queries = _data(4)
    path = str(tmp_path / "jr.zebra")
    jdb = Z.Database.create(path, Z.DatabaseConfig(dim=DIM, index=Z.IndexOptions(**options)))
    ids = jdb.insert_vectors(base)
    jdb.remove(ids[:20])
    want = jdb.query(queries, 10)
    jdb.close()
    tdb = T.Database.open(path, device="cpu")
    assert len(tdb) == N - 20
    assert tdb.index.options.refine == options["refine"] and tdb.index.options.rerank == "eager"
    assert_same_results(tdb.query(queries, 10), want, ties="dtype" in options)
    # the manifest keeps the user's word through a save by the port
    tdb.insert_vectors(queries[:8])
    tdb.save()
    tdb.close()
    with open(path) as f:
        assert json.load(f)["config"]["index"]["rerank"] == options.get("rerank", "auto")
    assert T.Database.open(path, device="cpu").config.index.rerank == options.get("rerank", "auto")


@pytest.mark.parametrize("options", TIERS, ids=TIER_IDS)
def test_port_written_refine_database_opens_in_jax(tmp_path, options):
    base, queries = _data(5)
    path = str(tmp_path / "pr.zebra")
    tdb = T.Database.create(path, T.DatabaseConfig(dim=DIM, index=T.IndexOptions(**options)),
                            device="cpu")
    ids = tdb.insert_vectors(base)
    tdb.remove(ids[:20])
    want = tdb.query(queries, 10)
    # a row finds itself at distance ~0; plain int8 stores it to ~8 bits, so
    # its cosine distance to the bf16 query is ~2e-5 (the other tiers keep
    # >= 15 bits, or the value itself)
    self_tol = 1e-3 if options.get("dtype") == "int8" else 1e-5
    assert tdb.query(base[100:150], 1) == [[(i, pytest.approx(0.0, abs=self_tol))]
                                           for i in ids[100:150]]
    tdb.close()
    jdb = Z.Database.open(path)
    assert len(jdb) == N - 20
    assert jdb.config.index.refine == options["refine"]
    assert jdb.config.index.rerank == options.get("rerank", "auto")
    assert_same_results(jdb.query(queries, 10), want, ties="dtype" in options)
    jdb.close()


@pytest.mark.parametrize("rerank", ["pallas", "pallas2"])
def test_explicit_pallas_rerank_pads_the_stored_width(tmp_path, rerank):
    """An explicit "pallas*" stores IVF rows at the next multiple of 128
    columns in the JAX package; the port keeps that layout, so a 64-dim
    database crosses in both directions (snapshot and log)."""
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((20, 64)).astype(np.float32)
    x = centers[rng.integers(0, 20, 2080)] + 0.15 * rng.standard_normal((2080, 64)).astype(np.float32)
    base, queries = x[:2048], x[2048:]
    opts = dict(refine=4, rerank=rerank)
    jpath, tpath = str(tmp_path / "j.zebra"), str(tmp_path / "t.zebra")
    jdb = Z.Database.create(jpath, Z.DatabaseConfig(dim=64, index=Z.IndexOptions(**opts)))
    jdb.insert_vectors(base)
    jdb.save()
    jdb.insert_vectors(queries[:4])  # logged, not saved
    want = jdb.query(queries, 10)
    tdb = T.Database.open(jpath, device="cpu")
    assert tdb.index.state.dim == 128 and len(tdb) == 2052
    assert_same_results(tdb.query(queries, 10), want)
    assert_same_results(tdb.index.search(queries, 10, exact=True),
                        jdb.index.search(queries, 10, exact=True))
    tdb = T.Database.create(tpath, T.DatabaseConfig(dim=64, index=T.IndexOptions(**opts)),
                            device="cpu")
    tdb.insert_vectors(base)
    tdb.save()
    tdb.insert_vectors(queries[:4])
    want = tdb.query(queries, 10)
    jdb = Z.Database.open(tpath)
    assert jdb.index.state.vectors.shape[1] == 128 and len(jdb) == 2052
    assert_same_results(jdb.query(queries, 10), want)


def test_refine_wal_replays_in_both_packages(tmp_path):
    """The q8 record is the same under refine=4: an unsaved database comes
    back from the log in either package."""
    base, queries = _data(6)
    path = str(tmp_path / "rw.zebra")
    cfg = T.DatabaseConfig(dim=DIM, index=T.IndexOptions(refine=4, rerank="pallas2"))
    tdb = T.Database.create(path, cfg, device="cpu")
    ids = tdb.insert_vectors(base)
    tdb.remove(ids[:10])
    want = tdb.query(queries, 10)
    replayed = T.Database.open(path, device="cpu")
    assert len(replayed) == N - 10
    assert_same_results(replayed.query(queries, 10), want)
    jdb = Z.Database.open(path)
    assert len(jdb) == N - 10
    assert_same_results(jdb.query(queries, 10), want)


def _stored(index, ids):
    """Each id's stored slab row (codes or values, and any scales), by id:
    what a replay must reproduce bitwise wherever it places the row."""
    slots = torch.as_tensor([index._id_to_slot.get(i) for i in ids])
    st = index.state
    return [a[slots] for a in (st.vectors, st.scales, st.residual, st.rscales) if a is not None]


@pytest.mark.parametrize("options", [{}, BALANCED, dict(dtype="float32", refine=0),
                                     dict(dtype="int8", refine=0)],
                         ids=["defaults", "balanced", "f32", "int8"])
def test_wal_replays_on_open_in_both_packages(tmp_path, options):
    """Inserts and a remove that were never saved come back from the
    write-ahead log — in the port, and in the JAX package reading the
    port's records (and the reverse): q8 at the defaults, bf16 on the bf16
    and plain int8 tiers, f32 on the f32 tier. The port's replay stores
    every row bitwise as the crash-free run did (plain int8 re-quantises the
    logged bf16 rows to the same codes)."""
    base, queries = _data(3)
    path = str(tmp_path / "w.zebra")
    tdb = T.Database.create(path, T.DatabaseConfig(dim=DIM, index=T.IndexOptions(**options)),
                            device="cpu")
    assert tdb.index._wal_codec == {"bfloat16": "bf16", "float32": "f32",
                                    "int8": "bf16"}.get(options.get("dtype"), "q8")
    ids = tdb.insert_vectors(base)
    tdb.remove(ids[:10])
    want = tdb.query(queries, 10)
    assert os.path.getsize(path + ".d/delta.log") > N * 2 * DIM  # logged, not saved
    replayed = T.Database.open(path, device="cpu")
    assert len(replayed) == N - 10
    assert_same_results(replayed.query(queries, 10), want, ties="dtype" in options)
    for a, b in zip(_stored(replayed.index, ids[10:]), _stored(tdb.index, ids[10:])):
        assert torch.equal(a, b)
    jdb = Z.Database.open(path)
    assert len(jdb) == N - 10
    assert_same_results(jdb.query(queries, 10), want, ties="dtype" in options)

    path2 = str(tmp_path / "w2.zebra")
    jdb2 = Z.Database.create(path2, Z.DatabaseConfig(dim=DIM, index=Z.IndexOptions(**options)))
    jids = jdb2.insert_vectors(base)
    jdb2.remove(jids[-5:])
    want2 = jdb2.query(queries, 10)
    tdb2 = T.Database.open(path2, device="cpu")
    assert len(tdb2) == N - 5
    assert_same_results(tdb2.query(queries, 10), want2, ties="dtype" in options)


def test_import_leaves_jax_out():
    """Every module of the port imports without JAX and without the JAX
    package (whose ``__init__`` imports JAX)."""
    mods = ["zebra_tpu_torch", "zebra_tpu_torch.models.text", "zebra_tpu_torch.models.fetch",
            "zebra_tpu_torch.models.hfload", "zebra_tpu_torch.models.wordpiece",
            "zebra_tpu_torch.cli", "zebra_tpu_torch.defaults", "zebra_tpu_torch.storage.blobs",
            "zebra_tpu_torch.native", "zebra_tpu_torch.native.quant"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'zebra_tpu.'))"
            " or m == 'zebra_tpu']\n"
            "sys.exit(f'imported {bad}' if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_balanced_tier_on_the_cpu(tmp_path):
    """``IndexOptions.tier("balanced")`` through the facade: a bf16 slab with
    no scales, bf16 records in the log and a snapshot whose slab is uint16
    bit patterns with no scales or residual member (the JAX package's
    contract)."""
    opts = T.IndexOptions.tier("balanced")
    assert opts == T.IndexOptions(**BALANCED)
    base, queries = _data(8)
    path = str(tmp_path / "b.zebra")
    db = T.Database.create(path, T.DatabaseConfig(dim=DIM, index=opts), device="cpu")
    ids = db.insert_vectors(base)
    idx = db.index
    assert idx.state.vectors.dtype == torch.bfloat16 and idx.state.scales is None
    assert idx._wal_codec == "bf16" and idx._wire_row_bytes == 2 * DIM
    assert idx.options.resolved_probes() == 4
    assert [row[0][0] for row in db.query(base[:100], 1)] == ids[:100]
    db.remove(ids[:5])
    want = db.query(queries, 10)
    db.save()
    with np.load(path + ".d/index/arrays.npz") as z:
        assert z["vectors"].dtype == np.uint16
        assert not {"scales", "residual", "rscales"} & set(z.files)
    again = T.Database.open(path, device="cpu")
    assert again.index.state.vectors.dtype == torch.bfloat16
    assert torch.equal(again.index.state.vectors, idx.state.vectors)
    assert_same_results(again.query(queries, 10), want)


def test_construction_needs_a_device_without_cuda(tmp_path, monkeypatch):
    """With no CUDA device, an index or database built without a device
    raises and names the CPU opt-in, rather than running on the CPU."""
    from zebra_tpu_torch.index.ivf_host import IVFIndex

    path = str(tmp_path / "d.zebra")
    T.Database.create(path, T.DatabaseConfig(dim=8), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: T.Database.create(str(tmp_path / "e.zebra"), T.DatabaseConfig(dim=8)),
                 lambda: T.Database.open(path), lambda: IVFIndex(dim=8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert T.Database.open(path, device="cpu").index.device.type == "cpu"


def test_unported_surfaces_raise(tmp_path):
    """The document surfaces work on the port (``tests/test_torch_documents.py``
    holds them to the JAX package), and so do the image and audio towers and
    the flat index now (``tests/test_torch_media.py``, ``tests/test_torch_flat.py``);
    what is left unported raises naming its ROADMAP entry: sharding."""
    import io
    import wave

    from PIL import Image

    db = T.Database.create(str(tmp_path / "u.zebra"),
                           T.DatabaseConfig(dim=8, model="hash-8"), device="cpu")
    ids = db.insert_documents([b"x", b"y"])
    assert db.insert_records(np.eye(8, dtype=np.float32)[:1], [b"z"])
    assert db.query_documents([b"x"]) == {0: {ids[0]: b"x"}}
    assert db.query_vectors(db.model.embed(b"y"))[0] == {ids[1]: b"y"}
    assert db.query(db.model.embed(b"x"), 1, with_documents=True)[0][0][2] == b"x"
    assert db.model_status()["model"] == "hash-8"
    png, clip = io.BytesIO(), io.BytesIO()
    Image.fromarray(np.arange(48 * 64 * 3, dtype=np.uint8).reshape(48, 64, 3)).save(png, "PNG")
    with wave.open(clip, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.sin(np.arange(8000) / 9.0) * 9000).astype("<i2").tobytes())
    for name, doc in (("vit-base-patch16-224", png.getvalue()), ("vit-audio", clip.getvalue())):
        media = T.Database.create(str(tmp_path / f"{name}.zebra"),
                                  T.DatabaseConfig(dim=768, model=name), device="cpu")
        assert media.model.name == name and media.model_status()["model"] == name
        (mid,) = media.insert_documents([doc])
        assert media.query_documents([doc]) == {0: {mid: doc}}
    flat = T.Database.create(str(tmp_path / "f.zebra"),
                             T.DatabaseConfig(dim=8, index=T.IndexOptions(index_type="flat")),
                             device="cpu")
    fids = flat.insert_vectors(np.eye(8, dtype=np.float32))
    assert flat.query(np.eye(8, dtype=np.float32)[5], 1)[0][0][0] == fids[5]
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, sharding"):
        T.Database.create(str(tmp_path / "s.zebra"), T.DatabaseConfig(dim=8, shards=2),
                          device="cpu")
