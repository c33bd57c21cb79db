"""Index basics on the port: the cases of ``tests/test_index.py`` on the
port's ``LSHIndex`` (id validation, empty indexes, removes of unknown ids,
adds after a reload, k wider than the candidate chunks, recall, metrics,
persistence), and the surface the port gained to match the JAX package
(``ids``, ``no_tables`` / ``is_empty``, ``ivf.num_valid``, the functional
state API of ``index/__init__``, ``Database.wait_for_warm``, the orbax
option), each held against the JAX package on the same inputs."""

from __future__ import annotations

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zebra_tpu as Z
import zebra_tpu_torch as T
from zebra_tpu.ops.distances import pairwise
from zebra_tpu_torch.config import IndexOptions
from zebra_tpu_torch.index.lsh import LSHIndex


def make_index(dim=32, metric="cosine", **kw):
    defaults = dict(num_tables=8, num_probes=8, seed=0)
    defaults.update(kw)
    return LSHIndex(dim=dim, metric=metric, options=IndexOptions(**defaults), device="cpu")


def brute_force_ids(data, ids, q, k, metric):
    d = np.asarray(pairwise(q, data, metric=metric))
    return [[ids[j] for j in row] for row in np.argsort(d, axis=1)[:, :k]]


def clustered(rng, n, dim, n_clusters=64, spread=0.15):
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    assign = rng.integers(0, n_clusters, n)
    return (centers[assign] + spread * rng.standard_normal((n, dim))).astype(np.float32)


# -- tests/test_index.py on the port -------------------------------------------


def test_insert_then_query_returns_inserted(rng):
    idx = make_index()
    data = rng.standard_normal((200, 32)).astype(np.float32)
    ids = idx.add(data)
    assert len(ids) == 200 and len(set(ids)) == 200
    for i, row in enumerate(idx.search(data[:10], k=1)):
        assert row and row[0][0] == ids[i] and row[0][1] < 1e-4


def test_distances_sorted_ascending(rng):
    idx = make_index()
    idx.add(rng.standard_normal((300, 32)).astype(np.float32))
    for row in idx.search(rng.standard_normal((5, 32)).astype(np.float32), k=10):
        d = [x[1] for x in row]
        assert d == sorted(d)


def test_remove_excludes_from_results(rng):
    idx = make_index()
    data = rng.standard_normal((100, 32)).astype(np.float32)
    ids = idx.add(data)
    assert set(idx.remove(ids[:50])) == set(ids[:50])
    surviving = set(ids[50:])
    for row in idx.search(data[:50], k=5):
        assert all(rid in surviving for rid, _ in row)
    assert len(idx) == 50


def test_remove_unknown_ids_noop(rng):
    idx = make_index()
    idx.add(rng.standard_normal((20, 32)).astype(np.float32))
    assert idx.remove([b"\x00" * 16]) == []
    assert len(idx) == 20


def test_deduplicate(rng):
    idx = make_index()
    data = rng.standard_normal((50, 32)).astype(np.float32)
    idx.add(np.concatenate([data, data[:20]], axis=0))
    assert len(idx.deduplicate()) == 20
    assert len(idx) == 50
    for row in idx.search(data[:5], k=1):
        assert row[0][1] < 1e-4


def test_clear_and_rebuild(rng):
    idx = make_index()
    idx.add(rng.standard_normal((64, 32)).astype(np.float32))
    idx.clear()
    assert idx.is_empty() and idx.no_tables() and len(idx) == 0
    assert idx.search(rng.standard_normal((2, 32)).astype(np.float32), 3) == [[], []]
    assert len(idx.add(rng.standard_normal((64, 32)).astype(np.float32))) == 64
    assert not idx.is_empty()


@pytest.mark.parametrize("metric", ["cosine", "sql2"])
def test_recall_vs_brute_force(rng, metric):
    n, dim, nq, k = 4000, 64, 50, 10
    data = clustered(rng, n, dim)
    q = data[rng.permutation(n)[:nq]] + 0.05 * rng.standard_normal((nq, dim)).astype(np.float32)
    idx = make_index(dim=dim, metric=metric, num_tables=15, num_probes=12)
    ids = idx.add(data)
    truth = brute_force_ids(data, ids, q, k, metric)
    hits = sum(len({i for i, _ in row} & set(t)) for row, t in zip(idx.search(q, k=k), truth))
    assert hits / (k * nq) >= 0.9


@pytest.mark.parametrize("metric", ["manhattan", "chebyshev", "l4"])
def test_non_mxu_metrics_through_index(rng, metric):
    n, dim, k = 400, 24, 5
    data = rng.standard_normal((n, dim)).astype(np.float32)
    idx = make_index(dim=dim, metric=metric, num_tables=10, num_probes=10)
    ids = idx.add(data)
    q = data[:4] + 0.01 * rng.standard_normal((4, dim)).astype(np.float32)
    d = np.asarray(pairwise(q, data, metric=metric))
    for b, row in enumerate(idx.search(q, k=k)):
        assert row[0][0] == ids[b]
        assert [x[1] for x in row] == sorted(x[1] for x in row)
        for rid, rdist in row:
            np.testing.assert_allclose(rdist, d[b, ids.index(rid)], rtol=1e-4, atol=1e-4)


def test_exact_search_matches_brute_force(rng):
    data = rng.standard_normal((500, 16)).astype(np.float32)
    idx = make_index(dim=16)
    ids = idx.add(data)
    q = rng.standard_normal((3, 16)).astype(np.float32)
    truth = brute_force_ids(data, ids, q, 5, "cosine")
    assert [[i for i, _ in row] for row in idx.search(q, k=5, exact=True)] == truth


def test_incremental_insert_after_build(rng):
    idx = make_index()
    idx.add(rng.standard_normal((100, 32)).astype(np.float32))
    b = rng.standard_normal((100, 32)).astype(np.float32)
    ids_b = idx.add(b)
    for i, row in enumerate(idx.search(b[:10], k=1)):
        assert row[0][0] == ids_b[i]


def test_slab_growth_and_rebuild(rng):
    idx = make_index(slab_capacity=0)
    for _ in range(6):
        idx.add(rng.standard_normal((500, 32)).astype(np.float32))
    assert len(idx) == 3000
    assert idx.search(rng.standard_normal((32,)).astype(np.float32), k=5)[0]


def test_save_load_roundtrip(rng, tmp_path):
    idx = make_index()
    data = rng.standard_normal((150, 32)).astype(np.float32)
    ids = idx.add(data)
    idx.remove(ids[:10])
    idx.save(str(tmp_path / "idx"))
    idx2 = LSHIndex.load(str(tmp_path / "idx"), device="cpu")
    assert len(idx2) == 140
    r1, r2 = idx.search(data[10:20], k=3), idx2.search(data[10:20], k=3)
    assert [[i for i, _ in row] for row in r1] == [[i for i, _ in row] for row in r2]


def test_add_after_reload_does_not_clobber(rng, tmp_path):
    """``load`` restores the host bump allocator, so new adds do not
    overwrite the reopened index's slots."""
    idx = make_index()
    a = rng.standard_normal((80, 32)).astype(np.float32)
    ids_a = idx.add(a)
    idx.save(str(tmp_path / "r"))
    idx2 = LSHIndex.load(str(tmp_path / "r"), device="cpu")
    assert idx2._next_slot == idx._next_slot
    b = rng.standard_normal((40, 32)).astype(np.float32)
    ids_b = idx2.add(b)
    for probe, want in ((a[:5], ids_a[:5]), (b[:5], ids_b[:5])):
        for i, row in enumerate(idx2.search(probe, k=1)):
            assert row[0][0] == want[i] and row[0][1] < 1e-3
    st = idx2.stats()
    assert st["used_slots"] == 120 and st["tombstones"] == 0


def test_empty_index_queries(rng):
    idx = make_index()
    assert idx.search(rng.standard_normal((3, 32)).astype(np.float32), 5) == [[], [], []]
    assert idx.no_vectors() and idx.is_empty() and idx.no_tables() and idx.ids() == []


def test_user_supplied_id_validation(rng):
    """The snapshot format's contract: ids are 16 bytes, non-zero, unique."""
    idx = make_index(dim=8)
    v = rng.standard_normal((3, 8)).astype(np.float32)
    with pytest.raises(ValueError, match="16-byte"):
        idx.add(v, ids=[b"short", b"x" * 16, b"y" * 16])
    with pytest.raises(ValueError, match="reserved"):
        idx.add(v, ids=[b"\x00" * 16, b"x" * 16, b"y" * 16])
    with pytest.raises(ValueError, match="duplicate"):
        idx.add(v, ids=[b"x" * 16, b"x" * 16, b"y" * 16])
    ok = [bytes([i] * 16) for i in (1, 2, 3)]
    idx.add(v, ids=ok)
    with pytest.raises(ValueError, match="duplicate"):
        idx.add(v[:1], ids=ok[:1])  # an id already stored
    assert len(idx) == 3


def test_lsh_k_wider_than_candidate_chunks(rng):
    idx = make_index()
    data = rng.standard_normal((300, 32)).astype(np.float32)
    ids = idx.add(data)
    for i, row in enumerate(idx.search(data[:4], k=64)):
        assert row and row[0][0] == ids[i]
        assert len({r for r, _ in row}) == len(row)
    assert all(len(row) == 300 for row in idx.search(data[:2], k=512, exact=True))


# -- the surface the port gained, against the JAX package ----------------------


@pytest.mark.parametrize("index_type", ["ivf", "lsh"])
def test_ids_and_emptiness_match_jax(rng, index_type):
    """``ids()`` lists the live ids in slot order and ``no_tables`` /
    ``is_empty`` follow the state, as in the JAX package: by position the
    same ids, and on LSH (bump-allocated slots) in the same order. IVF
    places rows by cell, and the packages' k-means draws differ."""
    opts = dict(index_type=index_type, seed=0)
    t = T.make_index(16, options=T.IndexOptions(**opts), device="cpu")
    j = Z.make_index(16, options=Z.IndexOptions(**opts))
    for idx in (t, j):
        assert idx.no_tables() and idx.is_empty() and idx.ids() == []
    data = rng.standard_normal((60, 16)).astype(np.float32)
    tids, jids = t.add(data), j.add(data)
    t.remove(tids[5:20])
    j.remove(jids[5:20])
    pos_t = {i: p for p, i in enumerate(tids)}
    pos_j = {i: p for p, i in enumerate(jids)}
    got, want = [pos_t[i] for i in t.ids()], [pos_j[i] for i in j.ids()]
    assert got == want if index_type == "lsh" else sorted(got) == sorted(want)
    assert set(t.ids()) == set(tids[:5] + tids[20:])
    slots = [t._id_to_slot.get(i) for i in t.ids()]
    assert slots == sorted(slots)
    assert not t.no_tables() and not t.is_empty() and not j.is_empty()
    assert t.stats()["vectors"] == j.stats()["vectors"] == 45


def test_slot_arena_and_slab_encoding_match_jax():
    from zebra_tpu.index import base as JB
    from zebra_tpu_torch.index import base as TB

    ids = [bytes([i + 1]) * 16 for i in range(4)]
    arenas = (TB.SlotIdArena(), JB.SlotIdArena())
    for a in arenas:
        a.set_many(np.array([0, 2, 5, 6]), ids)
        a.clear_slot(5)
    assert [arenas[0].get(s) for s in range(-1, 9)] == [arenas[1].get(s) for s in range(-1, 9)]
    x = np.random.default_rng(3).standard_normal((5, 8)).astype(np.float32)
    for tdt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        enc = TB.slab_to_np(torch.from_numpy(x).to(tdt))
        want = JB.slab_to_np(jnp.asarray(x).astype(jdt))
        assert enc.dtype == want.dtype
        np.testing.assert_array_equal(enc, want)
        back = TB.slab_from_np(enc, tdt)
        assert back.dtype == tdt
        np.testing.assert_array_equal(back.float().numpy(),
                                      np.asarray(JB.slab_from_np(want, jdt).astype(jnp.float32)))


def test_num_valid_is_a_device_scalar(rng):
    from zebra_tpu.index import ivf as JV
    from zebra_tpu_torch.index import ivf as TV

    t = T.make_index(16, device="cpu")
    j = Z.make_index(16)
    data = rng.standard_normal((50, 16)).astype(np.float32)
    t.remove(t.add(data)[:7])
    j.remove(j.add(data)[:7])
    got = TV.num_valid(t.state)
    assert isinstance(got, torch.Tensor) and got.dim() == 0 and got.device == t.state.valid.device
    assert int(got) == int(JV.num_valid(j.state)) == 43


def test_functional_state_api_matches_jax(rng):
    """``index.{empty_state, insert, delete_slots, query, brute_force}``
    with the JAX package's signatures, on one set of planes: the same
    slots, tables and answers."""
    from zebra_tpu import index as ZI
    from zebra_tpu_torch import index as TI

    T_, b, D = 4, 3, 16
    planes = rng.standard_normal((T_, b, D)).astype(np.float32)
    consts = np.zeros((T_, b), np.float32)
    x = rng.standard_normal((24, D)).astype(np.float32)
    js = ZI.empty_state(jnp.asarray(planes), jnp.asarray(consts), 16, 64)
    ts = TI.empty_state(torch.from_numpy(planes), torch.from_numpy(consts), 16, 64)
    assert isinstance(ts, TI.IndexState)
    js, jslots = ZI.insert(js, jnp.asarray(x), jnp.int32(20))
    ts, tslots = TI.insert(ts, torch.from_numpy(x), 20)
    np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))
    js = ZI.delete_slots(js, jnp.asarray([3, -1, 7], jnp.int32))
    ts = TI.delete_slots(ts, torch.tensor([3, -1, 7]))
    for f in ("buckets", "counts", "valid", "next_slot", "overflow"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), f)
    q = x[:6] + 0.01
    for name in ("query", "brute_force"):
        jd, jsl, jv = getattr(ZI, name)(js, jnp.asarray(q), 5, metric="sql2")
        td, tsl, tv = getattr(TI, name)(ts, torch.from_numpy(q), 5, metric="sql2")
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(np.where(tv.numpy(), tsl.numpy(), -1),
                                      np.where(np.asarray(jv), np.asarray(jsl), -1))
        np.testing.assert_allclose(np.where(tv.numpy(), td.numpy(), 0),
                                   np.where(np.asarray(jv), np.asarray(jd), 0),
                                   rtol=2e-3, atol=2e-3)


def test_wait_for_warm_returns_at_once(tmp_path):
    db = T.Database.create(str(tmp_path / "w.zebra"), T.DatabaseConfig(dim=8), device="cpu")
    db.insert_vectors(np.eye(8, dtype=np.float32))
    assert db.wait_for_warm() is None and db.wait_for_warm(timeout=0.0) is None
    db.close()


@pytest.mark.parametrize("package", ["jax", "port"])
def test_orbax_snapshot_format_raises_at_save(tmp_path, monkeypatch, package):
    """``snapshot_format="orbax"`` raises an ImportError at save that names
    the npz format, in the JAX package where orbax is missing (hidden here)
    and in the port, which never writes orbax; no npz is written under the
    orbax option. An empty index writes its meta alone in both."""
    monkeypatch.setitem(sys.modules, "orbax", None)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    pkg, kw = (Z, {}) if package == "jax" else (T, {"device": "cpu"})
    idx = pkg.make_index(8, options=pkg.IndexOptions(snapshot_format="orbax"), **kw)
    idx.save(str(tmp_path / "empty"))
    assert sorted(p.name for p in (tmp_path / "empty").iterdir()) == ["index.json"]
    idx.add(np.eye(8, dtype=np.float32))
    with pytest.raises(ImportError, match=r"snapshot_format='orbax' requires the optional "
                                          r"dependency orbax-checkpoint.*snapshot_format='npz'"):
        idx.save(str(tmp_path / "s"))
    assert not (tmp_path / "s" / "arrays.npz").exists()
