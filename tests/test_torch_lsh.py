"""The port's ``LSHIndex`` and LSH databases against the JAX package's, on
the CPU.

Plane draws are injected: the port's :func:`zebra_tpu_torch.index.lsh.plane_draws`
is replaced by the JAX draws of the same seed, and both packages take their
seeds from the same numpy ``_rng`` sequence, so both build the same tables
(up to hash bits at rounding level, which these inputs do not hit). Results
must agree: ids equal, distances within rtol = atol = 2e-3 (the JAX tests'
own tolerance). Databases cross between the packages both ways, through
snapshots and through the f32 write-ahead log.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zebra_tpu as Z
import zebra_tpu_torch as T
from zebra_tpu.index import buckets as JB
from zebra_tpu.index.lsh import LSHIndex as JLSH
from zebra_tpu_torch.index import buckets as TB
from zebra_tpu_torch.index import lsh as TL


def jax_plane_draws(seed, mode, num_tables, bits, n, width):
    key = jax.random.PRNGKey(seed)
    if mode == "data":
        k_pairs, k_fb = jax.random.split(key)
        return (np.array(jax.random.randint(k_pairs, (num_tables, bits, 2), 0, n)),
                np.array(jax.random.normal(k_fb, (num_tables, bits, width), dtype=jnp.float32)))
    return np.array(jax.random.normal(key, (num_tables, bits, width), dtype=jnp.float32))


@pytest.fixture(autouse=True)
def jax_draws(monkeypatch):
    monkeypatch.setattr(TL, "plane_draws", jax_plane_draws)


def _blobs(seed, n, d, centers=30, spread=0.3):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, d)).astype(np.float32)
    return c[rng.integers(0, centers, n)] + spread * rng.standard_normal((n, d)).astype(np.float32)


def _ids(n, start=0):
    return [int(i + 1).to_bytes(16, "big") for i in range(start, start + n)]


def _pair(dim=48, metric="cosine", **opts):
    opts = {"index_type": "lsh", "num_tables": 6, "num_probes": 4, **opts}
    j = JLSH(dim=dim, metric=metric, options=Z.IndexOptions(**opts))
    t = TL.LSHIndex(dim=dim, metric=metric, options=T.IndexOptions(**opts), device="cpu")
    return j, t


def assert_same_search(j, t, q, k=10, exact=False):
    a, b = j.search(q, k, exact=exact), t.search(q, k, exact=exact)
    assert [[i for i, _ in row] for row in b] == [[i for i, _ in row] for row in a]
    np.testing.assert_allclose([[d for _, d in row] for row in b],
                               [[d for _, d in row] for row in a], rtol=2e-3, atol=2e-3)


def assert_same_index(j, t):
    js, ts = j.stats(), t.stats()
    assert {key: ts[key] for key in js} == js
    assert (t._cap_boost, t._built_n, t._next_slot) == (j._cap_boost, j._built_n, j._next_slot)
    for f in ("buckets", "counts", "valid", "next_slot", "overflow"):
        np.testing.assert_array_equal(getattr(t.state, f).numpy(),
                                      np.asarray(getattr(j.state, f)), err_msg=f)
    np.testing.assert_allclose(t.state.planes.numpy(), np.asarray(j.state.planes),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_add_search_remove_match_jax(metric):
    x = _blobs(0, 1500, 48, centers=200, spread=0.5)
    j, t = _pair(metric=metric)
    ids = _ids(1500)
    j.add(x, ids=list(ids))
    t.add(x, ids=list(ids))
    assert_same_index(j, t)
    q = x[::50] + 0.05
    assert_same_search(j, t, q)
    assert_same_search(j, t, q, exact=True)
    gone = ids[::7]
    assert t.remove(gone + [b"\x09" * 16]) == j.remove(gone + [b"\x09" * 16])
    assert_same_index(j, t)
    assert_same_search(j, t, q)
    assert not {i for row in t.search(x[::7], 10) for i, _ in row} & set(gone)


def test_growth_rebuild_matches_jax():
    x = _blobs(1, 1800, 32, centers=100, spread=0.5)
    j, t = _pair(dim=32)
    for s, e in ((0, 400), (400, 1800)):  # 1800 > 4 x 400 live: "growth"
        j.add(x[s:e], ids=_ids(e - s, s))
        t.add(x[s:e], ids=_ids(e - s, s))
    assert t._built_n == 1800 and t.state.slab_capacity == 4096
    assert_same_index(j, t)
    assert_same_search(j, t, x[::40] + 0.05)


def test_tombstone_rebuild_matches_jax():
    x = _blobs(2, 1000, 32, centers=100, spread=0.5)
    j, t = _pair(dim=32)
    ids = _ids(1000)
    j.add(x, ids=list(ids))
    t.add(x, ids=list(ids))
    j.remove(ids[:600])  # 600 of 1000 used slots dead: "tombstones"
    t.remove(ids[:600])
    assert t._next_slot == 400 and len(t) == 400
    assert_same_index(j, t)
    assert_same_search(j, t, x[600::20] + 0.05)


def test_overflow_capacity_rebuild_matches_jax():
    """Fixed 4-bit codes over tight clusters: only deeper buckets help, so
    the overflow rebuild doubles the capacity boost until drops fall
    under 2% (or the boost reaches 64)."""
    x = _blobs(3, 1200, 24, centers=12, spread=0.1)
    j, t = _pair(dim=24, bits=4, bucket_capacity=8)
    j.add(x, ids=_ids(1200))
    t.add(x, ids=_ids(1200))
    assert t._cap_boost > 1 and t.state.bucket_capacity == 8 * t._cap_boost
    assert_same_index(j, t)
    assert_same_search(j, t, x[::30] + 0.01)


def test_hot_bucket_estimate_boosts_depth_before_build():
    """At >= 65,536 rows the build hashes a strided sample first and
    deepens buckets for hot codes (one plane re-sample when the bit budget
    shrinks) — the path the 1M-row configuration takes."""
    x = _blobs(4, 65536, 8, centers=64, spread=0.05)
    j, t = _pair(dim=8, num_tables=2, num_probes=2)
    j.add(x, ids=_ids(65536))
    t.add(x, ids=_ids(65536))
    assert t._cap_boost > 1
    assert_same_index(j, t)
    assert_same_search(j, t, x[::4096] + 0.01)


@pytest.mark.parametrize("max_candidates", [0, -1, -2])
def test_deep_buckets_compact_without_dropping_candidates(max_candidates):
    """Past a probe width of 65,536 the port compacts losslessly whatever
    value <= 0 the option holds: with every row a candidate here (one bit,
    both codes probed), its answers are the exact scan's. A negative option
    means no compaction in the JAX package too, whose answers then equal
    the port's; at an explicit width of 1024 both keep the same candidates."""
    x = _blobs(9, 70000, 8, centers=4000, spread=0.3)
    j, t = _pair(dim=8, num_tables=2, num_probes=2, bits=1, bucket_capacity=70000,
                 max_candidates=max_candidates)
    j.add(x, ids=_ids(70000))
    t.add(x, ids=_ids(70000))
    assert int(t.state.overflow) == 0  # every row sits in both tables
    assert t._candidate_width(2) == (0, True)
    q = x[::3500] + 0.01
    assert_same_search(j, t, q, exact=True)
    exact = [[i for i, _ in row] for row in t.search(q, 10, exact=True)]
    assert [[i for i, _ in row] for row in t.search(q, 10)] == exact
    if max_candidates < 0:
        assert_same_search(j, t, q)
    (gd, gs, gv), (wd, ws, wv) = (
        TB.query(t.state, torch.from_numpy(q), 10, num_probes=2, rerank="cuda",
                 max_candidates=1024),
        JB.query(j.state, jnp.asarray(q), 10, num_probes=2, rerank="xla",
                 max_candidates=1024))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("max_candidates", [-1, -2])
def test_negative_max_candidates_match_jax(max_candidates):
    """Values <= 0 mean no compaction in both packages."""
    x = _blobs(14, 1500, 32, centers=150, spread=0.5)
    j, t = _pair(dim=32, max_candidates=max_candidates)
    j.add(x, ids=_ids(1500))
    t.add(x, ids=_ids(1500))
    assert t._candidate_width(4) == (0, False)
    assert_same_search(j, t, x[::50] + 0.05)


def test_pallas_rerank_pads_the_stored_width():
    x = _blobs(5, 400, 48)
    j, t = _pair(rerank="pallas")
    assert j._dev_dim == t._dev_dim == 1024
    j.add(x, ids=_ids(400))
    t.add(x, ids=_ids(400))
    assert t.state.vectors.shape == (4096, 1024) and t.state.planes.shape[-1] == 1024
    assert_same_index(j, t)
    q = x[:8] + 0.01
    assert_same_search(j, t, q, k=5)
    # the kernel route (its plain version on the CPU) reads 48 of 1024 columns
    qp = torch.nn.functional.pad(torch.from_numpy(q), (0, 1024 - 48))
    eager = TB.query(t.state, qp, 5, num_probes=4, rerank="eager")
    kernel = TB.query(t.state, qp, 5, num_probes=4, rerank="cuda", dim=48)
    assert torch.equal(eager[1], kernel[1]) and torch.equal(eager[2], kernel[2])
    torch.testing.assert_close(eager[0], kernel[0], rtol=2e-3, atol=2e-3)


def test_bf16_slab_matches_jax():
    x = _blobs(6, 800, 32, centers=80, spread=0.5)
    j, t = _pair(dim=32, dtype="bfloat16")
    j.add(x, ids=_ids(800))
    t.add(x, ids=_ids(800))
    assert t.state.vectors.dtype == torch.bfloat16 and t._wal_codec == "bf16"
    assert_same_index(j, t)
    assert_same_search(j, t, x[::40] + 0.05)


def test_reopen_restores_the_allocator_and_boost(tmp_path):
    """The boost and the next free slot survive save and load, and adds
    after a reopen continue where the saved index stopped: the reopened
    index ends equal to one that never closed."""
    x = _blobs(7, 1200, 24, centers=12, spread=0.1)
    _, boosted = _pair(dim=24, bits=4, bucket_capacity=8)
    boosted.add(x, ids=_ids(1200))
    boosted.save(str(tmp_path / "b"))
    again = TL.LSHIndex.load(str(tmp_path / "b"), device="cpu")
    assert (again._next_slot, again._cap_boost) == (1200, boosted._cap_boost) and again._cap_boost > 1
    y = _blobs(8, 1200, 24, centers=600, spread=0.5)
    _, t = _pair(dim=24, bucket_capacity=64)
    t.add(y[:1000], ids=_ids(1000))
    t.save(str(tmp_path / "t"))
    again = TL.LSHIndex.load(str(tmp_path / "t"), device="cpu")
    for ix in (t, again):
        ix.add(y[1000:], ids=_ids(200, 1000))
        assert ix._rebuild_reason() is None
    assert len(again) == 1200 and again._next_slot == t._next_slot == 1200
    for f in ("buckets", "counts", "vectors", "valid"):
        assert torch.equal(getattr(again.state, f), getattr(t.state, f)), f
    assert again.search(y[::50], 5) == t.search(y[::50], 5)


def test_int8_and_flat_are_refused(tmp_path):
    """Int8 stays refused on LSH; flat (an LSHIndex whose query is the exact
    scan) is created and queried."""
    with pytest.raises(ValueError, match="ivf backend only"):
        TL.LSHIndex(dim=8, options=T.IndexOptions(index_type="lsh", dtype="int8"), device="cpu")
    db = T.Database.create(str(tmp_path / "f.zebra"),
                           T.DatabaseConfig(dim=8, index=T.IndexOptions(index_type="flat")),
                           device="cpu")
    assert isinstance(db.index, TL.LSHIndex) and db.index.options.index_type == "flat"
    ids = db.insert_vectors(np.eye(8, dtype=np.float32))
    assert [row[0][0] for row in db.query(np.eye(8, dtype=np.float32)[2:4], 1)] == ids[2:4]


# -- databases crossing between the packages ---------------------------------

DIM = 64


def _cfg(pkg, **opts):
    """Deep enough buckets that no rebuild triggers: the JAX facade defers
    rebuilds to a background worker, the port runs them inline."""
    return pkg.DatabaseConfig(dim=DIM, index=pkg.IndexOptions(index_type="lsh",
                                                               bucket_capacity=256, **opts))


def _cpu(pkg):
    """The port runs on the card unless asked; the JAX package takes no device."""
    return {"device": "cpu"} if pkg is T else {}


def _data(seed):
    x = _blobs(seed, 2064, DIM, centers=2064, spread=0.6)
    return x[:2000], x[2000:]


def _ranked(rows):
    return [[i for i, _ in row] for row in rows], [[d for _, d in row] for row in rows]


def assert_same_results(a, b):
    (ia, da), (ib, db) = _ranked(a), _ranked(b)
    assert ia == ib
    np.testing.assert_allclose(da, db, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("opts", [{}, {"rerank": "pallas"}, {"dtype": "bfloat16"}])
def test_jax_written_lsh_database_opens_in_the_port(tmp_path, opts):
    base, queries = _data(10)
    path = str(tmp_path / "j.zebra")
    jdb = Z.Database.create(path, _cfg(Z, **opts))
    ids = jdb.insert_vectors(base)
    jdb.remove(ids[:30])
    assert jdb.index._rebuild_reason() is None
    want = jdb.query(queries, 10)
    jdb.close()
    tdb = T.Database.open(path, device="cpu")
    assert len(tdb) == 1970 and tdb.index._dev_dim == (1024 if opts.get("rerank") else DIM)
    assert_same_results(tdb.query(queries, 10), want)


@pytest.mark.parametrize("opts", [{}, {"rerank": "pallas"}, {"dtype": "bfloat16"}])
def test_port_written_lsh_database_opens_in_jax(tmp_path, opts):
    base, queries = _data(11)
    path = str(tmp_path / "p.zebra")
    tdb = T.Database.create(path, _cfg(T, **opts), device="cpu")
    ids = tdb.insert_vectors(base)
    tdb.remove(ids[:30])
    want = tdb.query(queries, 10)
    tdb.close()
    jdb = Z.Database.open(path)
    assert len(jdb) == 1970
    assert_same_results(jdb.query(queries, 10), want)
    jdb.close()


def test_f32_wal_tail_replays_in_both_directions(tmp_path):
    """A snapshot plus unsaved inserts and removes: each package replays the
    other's f32 records onto the snapshot's tables."""
    base, queries = _data(12)
    for writer, reader in ((T, Z), (Z, T)):
        path = str(tmp_path / f"{writer.__name__}.zebra")
        db = writer.Database.create(path, _cfg(writer), **_cpu(writer))
        ids = db.insert_vectors(base[:1500])
        db.save()
        ids += db.insert_vectors(base[1500:])  # logged only
        db.remove(ids[1490:1520])
        assert os.path.getsize(path + ".d/delta.log") > 500 * DIM * 4  # f32 records
        want = db.query(queries, 10)
        again = reader.Database.open(path, **_cpu(reader))
        assert len(again) == 1970
        assert_same_results(again.query(queries, 10), want)
        for d in (db, again):
            getattr(d, "_delta").close()


def test_wal_replays_from_scratch_in_both_directions(tmp_path):
    """Nothing saved but the empty index: replay rebuilds the tables from the
    log, drawing the same planes (injected draws) in either package."""
    base, queries = _data(13)
    for writer, reader in ((T, Z), (Z, T)):
        path = str(tmp_path / f"s{writer.__name__}.zebra")
        db = writer.Database.create(path, _cfg(writer), **_cpu(writer))
        ids = db.insert_vectors(base)
        db.remove(ids[:10])
        want = db.query(queries, 10)
        again = reader.Database.open(path, **_cpu(reader))
        assert len(again) == 1990
        assert_same_results(again.query(queries, 10), want)
        for d in (db, again):
            getattr(d, "_delta").close()
