"""The port's sharded index (``zebra_tpu_torch.parallel``) against the JAX
package's (``zebra_tpu.parallel.sharded``) on the CPU.

The JAX side runs on the conftest's 8 virtual CPU devices; the port's mesh is
``torch.device("cpu")`` repeated S times. A sharded snapshot crosses between
the packages both ways at every slab tier (refined int8, plain int8, bf16,
flat, LSH): the same top-10 (distances within 2e-3), the same global slots
for further adds, the same ids removed and deduplicated, the same exact
results after a reshard on load. The facade with ``shards=2``: the log's
replay by either package (a JAX-written log replayed by the port too), a
growth retrain with the JAX package's reasons and shapes (k-means injected:
the packages' random streams differ).
"""

import numpy as np
import pytest
import torch

import zebra_tpu as Z
import zebra_tpu_torch as T
from zebra_tpu.config import IndexOptions as JO
from zebra_tpu.parallel.sharded import ShardedIndex as JS
from zebra_tpu_torch.config import IndexOptions as TO
from zebra_tpu_torch.parallel import Mesh, make_mesh, shard_axis_size
from zebra_tpu_torch.parallel import sharded as TSH
from zebra_tpu_torch.parallel.sharded import ShardedIndex as TS
from zebra_tpu_torch.parallel.sharded import ShardedLSHIndex

CPU = torch.device("cpu")
DIM = 128
#: the tiers of a sharded index, as IndexOptions keywords (LSH at a fixed
#: code width: a rebuild would redraw planes from each package's own stream;
#: IVF cells deep enough that no cell overflows, where the packages'
#: fallbacks differ: ``test_full_cells_fall_back_in_nearest_order``)
TIERS = {
    "refined": dict(cluster_capacity=64),
    "int8": dict(dtype="int8", refine=0, cluster_capacity=64),
    "bf16": dict(dtype="bfloat16", cluster_capacity=64),
    "flat": dict(index_type="flat"),
    "lsh": dict(index_type="lsh", num_tables=8, num_probes=8, bits=6),
}


def _data(seed, n, dim=DIM, clusters=16, sigma=0.15):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((clusters, dim)).astype(np.float32)
    return c[rng.integers(0, clusters, n)] + sigma * rng.standard_normal((n, dim)).astype(np.float32)


def _ids(tag: int, n: int) -> list[bytes]:
    return [bytes([tag, i % 256, i // 256]) + bytes(13) for i in range(n)]


def _top(rows):
    return [[i for i, _ in r] for r in rows]


def assert_same(a, b, tol=2e-3):
    assert _top(a) == _top(b)
    np.testing.assert_allclose([[d for _, d in r] for r in a], [[d for _, d in r] for r in b],
                               rtol=tol, atol=tol)


def _slots(idx, ids):
    return [idx._id_to_slot.get(i) for i in ids]


def test_mesh_surface(tmp_path, monkeypatch):
    mesh = make_mesh(4, [CPU] * 8)
    assert mesh.shape == {"shard": 4} and shard_axis_size(mesh) == 4
    assert mesh == make_mesh(4, ["cpu"] * 4) and hash(mesh) == hash(make_mesh(4, ["cpu"] * 4))
    assert ShardedLSHIndex is TS
    with pytest.raises(ValueError, match="only 2 devices"):
        make_mesh(4, [CPU] * 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS(dim=8, shards=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.Database.create(str(tmp_path / "u.zebra"), T.DatabaseConfig(dim=8, shards=2))
    # one card and four shards with device=None: refused, as on one chip
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="4 shards but only 1 devices"):
        TS(dim=8, shards=4)
    idx = TS(dim=8, shards=4, device="cpu")
    assert idx.shards == 4 and idx.shard_devices == [CPU] * 4 and idx.options.rerank == "eager"
    assert TS(dim=8, mesh=Mesh([CPU, CPU], ("shard",))).shards == 2


def _in_nearest_cells(idx, rows, ids) -> bool:
    """Every row in its nearest cell of its shard (IVF; True for LSH and
    flat, which have no cells): where no cell overflowed, the JAX package's
    jittered fallbacks and the port's nearest-order ones place alike."""
    from zebra_tpu_torch.index import ivf as V

    if not idx._ivf:
        return True
    for r, g in zip(rows, _slots(idx, ids)):
        st = idx.state[g % idx.shards]
        cell = (g // idx.shards) // st.cluster_capacity
        near = V._cell_choice(torch.from_numpy(r[None]), st.centroids, idx._cell_metric, 1)
        if int(near[0, 0]) != cell:
            return False
    return True


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_jax_written_sharded_index_opens_in_the_port(tmp_path, tier):
    rows_all = _data(0, 664, clusters=64)
    x, more, q = rows_all[:400], rows_all[400:632], rows_all[632:]
    j = JS(DIM, "cosine", JO(seed=0, **TIERS[tier]), shards=4)
    j.add(x, ids=_ids(1, 400))
    j.save(str(tmp_path / "j"))
    t = TS.load(str(tmp_path / "j"), device="cpu")
    assert t.shards == 4 and len(t) == 400 and t.stats() == j.stats()
    assert_same(t.search(q, 10), j.search(q, 10))
    # the same further adds (25 of them copies of stored rows; 257 rows:
    # the first add's padded span), none overflowing a cell, land in the
    # same global slots
    mids = _ids(2, 232) + _ids(3, 25)
    rows = np.concatenate([more, x[1:26]])
    j.add(rows, ids=list(mids))
    t.add(rows, ids=list(mids))
    assert _in_nearest_cells(t, rows, mids)
    assert _slots(t, mids) == _slots(j, mids) and t._built_n == j._built_n == 400
    # remove and deduplicate take the same ids
    gone = _ids(1, 400)[::7]
    assert t.remove(gone) == j.remove(gone)
    dj, dt = j.deduplicate(), t.deduplicate()
    assert dt == dj and len(dt) == 25 - len(set(range(1, 26)) & set(range(0, 400, 7)))
    assert_same(t.search(q, 10), j.search(q, 10))
    # a reshard on load (4 -> 2) answers the exact search as the index did
    t.save(str(tmp_path / "t"))
    r_t = TS.load(str(tmp_path / "t"), shards=2, device="cpu")
    assert r_t.shards == 2 and len(r_t) == len(j) and r_t._built_n == len(j)
    assert_same(r_t.search(q, 5, exact=True), t.search(q, 5, exact=True), tol=1e-5)


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_port_written_sharded_index_opens_in_jax(tmp_path, tier):
    rows_all = _data(3, 532, clusters=64)
    x, more, q = rows_all[:400], rows_all[400:500], rows_all[500:]
    t = TS(DIM, "cosine", TO(seed=0, **TIERS[tier]), shards=4, device="cpu")
    t.add(x, ids=_ids(1, 400))
    t.save(str(tmp_path / "t"))
    j = JS.load(str(tmp_path / "t"))
    assert j.shards == 4 and len(j) == 400 and j.stats() == t.stats()
    assert_same(j.search(q, 10), t.search(q, 10))
    mids = _ids(2, 100)
    j.add(more, ids=list(mids))
    t.add(more, ids=list(mids))
    assert _in_nearest_cells(t, more, mids) and _slots(j, mids) == _slots(t, mids)
    gone = mids[::5]
    assert j.remove(gone) == t.remove(gone)
    assert_same(j.search(q, 10), t.search(q, 10))


def test_sharded_exact_matches_single_device_and_lsh_recall():
    from zebra_tpu_torch.index.lsh import LSHIndex

    x, q = _data(6, 2000, dim=32, clusters=32, sigma=0.1), _data(7, 20, dim=32, clusters=32)
    ids = _ids(4, 2000)
    opts = dict(index_type="lsh", num_tables=15, num_probes=12, seed=0)
    sharded = TS(32, "cosine", TO(**opts), shards=8, device="cpu")
    single = LSHIndex(32, "cosine", TO(**opts), device="cpu")
    sharded.add(x, ids=list(ids))
    single.add(x, ids=list(ids))
    assert_same(sharded.search(q, 5, exact=True), single.search(q, 5, exact=True), tol=1e-5)
    approx, exact = sharded.search(q, 10), sharded.search(q, 10, exact=True)
    hits = sum(len(set(a) & set(e)) for a, e in zip(_top(approx), _top(exact)))
    assert hits / 200 >= 0.9


def _inject_kmeans(monkeypatch, cents):
    """Both packages' per-shard k-means (and its paced form) return the
    leading rows of ``cents``."""
    import jax.numpy as jnp
    import zebra_tpu.ops.kmeans as JK

    for name in ("kmeans", "kmeans_paced"):
        monkeypatch.setattr(JK, name, lambda *a, k, **kw: (jnp.asarray(cents[:k]), None))
        monkeypatch.setattr(TSH, name,
                            lambda *a, **kw: (torch.from_numpy(cents[: a[2]].copy()), None))


def test_merge_keeps_the_lower_shard_first_on_ties():
    """Equal distances from two shards: the lower shard's slot first, as the
    JAX package's all-gathered ``[B, S*k]`` merge orders them."""
    d = torch.tensor([[0.5, 1.0]])
    parts = [(d, torch.tensor([[4, 8]]), torch.tensor([[True, True]])),
             (d, torch.tensor([[1, 5]]), torch.tensor([[True, False]]))]
    md, mg, mv = TSH.merge_partials(parts, 3, CPU)
    assert mg.tolist() == [[4, 1, 8]] and md.tolist() == [[0.5, 0.5, 1.0]]
    assert mv.tolist() == [[True, True, True]]


def test_spare_growth_places_as_jax(monkeypatch):
    """Saturated clusters overflow every shard's spare: both packages grow
    the spares and re-split the rows the same way."""
    rng = np.random.default_rng(8)
    x = (np.ones((400, 16), np.float32) + 0.001 * rng.standard_normal((400, 16))).astype(np.float32)
    kw = dict(index_type="ivf", seed=0, num_probes=8, num_clusters=4, cluster_capacity=16,
              spill=2, spare_capacity=32)
    j = JS(16, "cosine", JO(**kw), shards=2)
    t = TS(16, "cosine", TO(**kw), shards=2, device="cpu")
    _inject_kmeans(monkeypatch, np.asarray(rng.standard_normal((4, 16)), np.float32))
    ids = _ids(5, 400)
    j.add(x, ids=list(ids))
    t.add(x, ids=list(ids))
    assert len(t) == 400 and _slots(t, ids) == _slots(j, ids)
    assert t.stats() == j.stats() and t.stats()["spare_used"] > 32
    assert all(row and row[0][1] < 1e-4 for row in t.search(x[:20], 1))


def test_full_cells_fall_back_in_nearest_order():
    """Where a cell is full, the JAX package sends each row to its 2nd or
    its 3rd nearest cell by a per-row jitter (``ivf.insert``'s default, its
    parity held by ``tests/test_torch_ivf.py``); the sharded index's insert
    (``jitter=False``) takes the 2nd first, a cell that a P=2 query of the
    row itself probes."""
    from zebra_tpu_torch.index import ivf as V

    rng = np.random.default_rng(16)
    cents = rng.standard_normal((8, 16)).astype(np.float32)
    x = torch.from_numpy((cents[0] + 0.01 * rng.standard_normal((64, 16))).astype(np.float32))
    placed = {}
    for jitter in (True, False):
        st = V.empty_state(torch.from_numpy(cents), 32, 64, dtype=torch.float32)
        slots = V.insert(st, x, spill=8, metric="sql2", jitter=jitter)
        placed[jitter] = (slots // 32).tolist()
    order = V._cell_choice(x, torch.from_numpy(cents), "sql2", 8)
    second = order[:, 1].tolist()
    assert placed[False][:32] == placed[True][:32] == [0] * 32
    assert placed[False][32:] == second[32:]
    assert placed[True][32:] != second[32:]  # some rows went to their 3rd


def test_pallas_words_need_aligned_dims():
    for Idx, O in ((JS, JO), (TS, TO)):
        kw = {} if Idx is JS else {"device": "cpu"}
        with pytest.raises(ValueError, match="128"):
            Idx(dim=48, options=O(rerank="pallas"), shards=2, **kw)
        with pytest.raises(ValueError, match="1024"):
            Idx(dim=48, options=O(index_type="lsh", rerank="pallas"), shards=2, **kw)
    assert TS(dim=128, options=TO(rerank="pallas2"), shards=2, device="cpu")._dev_dim == 128


def test_reshard_chunked_readd(tmp_path):
    """More live rows than one re-add chunk (4096 at 16 dimensions): every id
    survives the 8 -> 2 reshard, and the rows find themselves."""
    rng = np.random.default_rng(9)
    n = 9000
    x = rng.standard_normal((n, 16)).astype(np.float32)
    ix = TS(16, "sql2", TO(seed=3, num_probes=8), shards=8, device="cpu")
    ids = ix.add(x)
    ix.remove(ids[::100])
    ix.save(str(tmp_path / "c"))
    loaded = TS.load(str(tmp_path / "c"), shards=2, device="cpu")
    assert loaded.shards == 2 and len(loaded) == n - len(ids[::100])
    hits = sum(r[0][0] == ids[1000 + i] for i, r in enumerate(loaded.search(x[1000:1100], 1)))
    assert hits >= 95


def _facade(mod, path, shards=2, opts=None, **kw):
    cfg = mod.DatabaseConfig(dim=32, metric="cosine", shards=shards,
                             index=mod.IndexOptions(seed=0, **(opts or {})))
    return mod.Database.create(path, cfg, **kw)


def test_facade_log_replays_in_both_packages(tmp_path):
    """A sharded facade logs every insert and remove (f32 records for the
    refined tier's array wire, as the JAX facade writes them); after a
    crash (no save) the port and the JAX package each replay the log onto
    the snapshot and answer as the live index did. The JAX facade's own
    inserts and removes, logged the same way, replay in the port."""
    x, q = _data(10, 1800, dim=32), _data(11, 16, dim=32)
    path = str(tmp_path / "w.zebra")
    db = _facade(T, path, opts={"cluster_capacity": 256}, device="cpu")
    assert db.index._wal_codec == "f32" and db.index.shards == 2
    ids = db.insert_vectors(x[:1000])
    db.save()
    ids += db.insert_vectors(x[1000:1500])
    assert _in_nearest_cells(db.index, x[1000:1500], ids[1000:])  # no fallback taken
    db.remove(ids[::9])
    want = db.query(q, 10)
    assert db._delta.size() > 0
    port = T.Database.open(path, device="cpu")
    assert len(port) == len(db) and port.index.shards == 2
    assert_same(port.query(q, 10), want, tol=1e-5)
    jax_db = Z.Database.open(path)
    assert len(jax_db) == len(db) and jax_db.index.shards == 2
    assert_same(jax_db.query(q, 10), want)
    jax_db.save()
    jids = jax_db.insert_vectors(x[1500:])
    jax_db.remove(jids[::5])
    want = jax_db.query(q, 10)
    port = T.Database.open(path, device="cpu")
    assert len(port) == len(jax_db) and port.index._built_n == jax_db.index._built_n
    assert_same(port.query(q, 10), want)
    assert port.index.stats() == jax_db.index.stats()


def test_growth_retrain_matches_jax(tmp_path, monkeypatch):
    """400 rows, then 1300 through both facades (shards=2, the retrain
    waited for, k-means injected): the growth retrain fires at the same
    call in both, and each step has the JAX package's shape but for the
    cells: a port shard holds as many cells as an unsharded index of all
    the rows (their capacity sized for the shard's rows, so the slab is the
    same size), where the JAX package sizes them for the shard's rows; a
    row whose probed cells are full goes to the spare."""
    from zebra_tpu_torch.index.ivf_host import resolved_capacity, resolved_clusters

    x = _data(12, 1700, dim=32, clusters=24, sigma=0.2)
    _inject_kmeans(monkeypatch, x[np.random.default_rng(13).choice(1700, 64, replace=False)] + 0.01)
    # the cells, and the spare that takes a row whose probed cells are full
    # (the JAX package spills it to up to 8 cells first), are the port's own
    cells = ("clusters_per_shard", "cluster_capacity", "spare_used")
    keys = ("vectors", "slab_capacity_per_shard", "used_slots", "tombstones") + cells
    steps = {}
    for name, mod, kw in (("jax", Z, {}), ("port", T, {"device": "cpu"})):
        db = _facade(mod, str(tmp_path / f"{name}.zebra"), **kw)
        db._fold_floor = 1 << 30
        reasons, once = [], db._retrain_once

        def spy(db=db, reasons=reasons, once=once):
            reasons.append(db.index._rebuild_wanted)
            return once()

        db._retrain_once = spy
        got = []
        for s, e in ((0, 400), (400, 1700)):
            db.insert_vectors(x[s:e])
            db.wait_for_retrain(timeout=120)
            st = db.index.stats()
            got.append(({k: st[k] for k in keys}, db._retrain_count, tuple(reasons),
                        db.index._built_n))
        steps[name] = got
        db.close()
    opts = TO(seed=0)
    for (p, *rest), (j, *jrest) in zip(steps["port"], steps["jax"]):
        assert rest == jrest
        assert {k: p[k] for k in keys if k not in cells} == {k: j[k] for k in keys if k not in cells}
        built = rest[2]
        k_port, k_jax = resolved_clusters(opts, built), resolved_clusters(opts, -(-built // 2))
        assert (p["clusters_per_shard"], j["clusters_per_shard"]) == (k_port, k_jax)
        assert p["cluster_capacity"] == resolved_capacity(opts, -(-built // 2), k_port, dim=32)
    assert steps["port"][-1][2] == ("growth",) and steps["port"][-1][0]["clusters_per_shard"] == 32


def test_fold_streams_the_shards_by_chunks(tmp_path, monkeypatch):
    """The log fold of a sharded facade: its cloned capture, and (with the
    clone budget at 0) the chunked capture, write the stacked snapshot; the
    reopened database answers as the live one."""
    from zebra_tpu_torch.index import base as TB

    x, q = _data(14, 1200, dim=32), _data(15, 8, dim=32)
    for budget in (TB._CLONE_HBM_BUDGET, 0):
        monkeypatch.setattr(TB, "_CLONE_HBM_BUDGET", budget)
        path = str(tmp_path / f"f{budget}.zebra")
        db = _facade(T, path, device="cpu")
        db.insert_vectors(x[:600])
        db.save()
        db._fold_floor = 1
        monkeypatch.setattr(db, "_fold_threshold", lambda allow_measure=False: 1)
        db.insert_vectors(x[600:])
        db.wait_for_fold(timeout=120)
        assert db._fold_count >= 1
        want = db.query(q, 10)
        reopened = T.Database.open(path, device="cpu")
        assert_same(reopened.query(q, 10), want, tol=1e-6)
        db.close()
