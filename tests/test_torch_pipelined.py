"""The torch port's pipelined surfaces on the CPU (``device="cpu"``): the
query pipeline (``search_submit`` / ``search_collect`` / ``search_stream``,
``Database.query_stream``) and the pipelined insert.

The contract is the JAX package's (``tests/test_pipelined.py``, whose five
cases run here on the port): pipelining reorders host waits, never the
math. So ``search_stream`` returns what per-batch ``search`` returns, a
multi-span insert stores what the same spans added one call at a time
store (bitwise), and against the JAX package the same ids come back with
distances within 1e-4 (both score the same stored values in f32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zebra_tpu as Z
import zebra_tpu_torch as T
from zebra_tpu.index import base as JB
from zebra_tpu.index.ivf_host import IVFIndex as JIndex
from zebra_tpu_torch.index import base as TB
from zebra_tpu_torch.index import make_index
from zebra_tpu_torch.index.ivf_host import IVFIndex as TIndex


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _db(path, dim, **index):
    return T.Database.create(str(path), T.DatabaseConfig(
        dim=dim, metric="sql2", index=T.IndexOptions(**index)), device="cpu")


# -- the five cases of tests/test_pipelined.py, on the port ----------------------


@pytest.mark.parametrize("index_type", ["ivf", "lsh"])
def test_search_stream_matches_search(rng, index_type):
    pts = rng.standard_normal((600, 32)).astype(np.float32)
    idx = make_index(dim=32, metric="sql2", options=T.IndexOptions(index_type=index_type, seed=0),
                     device="cpu")
    idx.add(pts)
    batches = [pts[i * 50 : (i + 1) * 50] + 0.01 for i in range(4)]
    expect = [idx.search(b, k=5) for b in batches]
    got = list(idx.search_stream(batches, k=5))
    assert got == expect


def test_search_submit_collect_overlap(rng):
    """Two submits may be in flight; collects resolve in any order."""
    pts = rng.standard_normal((400, 16)).astype(np.float32)
    idx = make_index(dim=16, options=T.IndexOptions(index_type="ivf", seed=0), device="cpu")
    idx.add(pts)
    t1 = idx.search_submit(pts[:10], 3)
    t2 = idx.search_submit(pts[10:20], 3)
    d2, s2, v2 = idx.search_collect(t2)
    d1, s1, v1 = idx.search_collect(t1)
    ds, ss, vs = idx.search_arrays(pts[:20], 3)
    assert np.allclose(np.concatenate([d1, d2]), ds, rtol=1e-5)
    assert np.array_equal(np.concatenate([s1, s2]), ss)
    assert ss.dtype == np.int64 and np.array_equal(np.concatenate([v1, v2]), vs)


def test_query_stream_matches_query(tmp_path, rng):
    pts = rng.standard_normal((300, 24)).astype(np.float32)
    db = _db(tmp_path / "p.zebra", 24, index_type="ivf", seed=0)
    db.insert_vectors(pts)
    batches = [pts[:40], pts[40:80], pts[80:120]]
    expect = [db.query(b, number_of_results=4) for b in batches]
    got = list(db.query_stream(batches, number_of_results=4))
    assert got == expect
    timer = db.stats.summary()["query"]  # the submits, under the read lock
    assert (timer["calls"], timer["items"]) == (3, 120)
    db.close()


def test_query_stream_empty_db(tmp_path, rng):
    db = T.Database.create(str(tmp_path / "e.zebra"), T.DatabaseConfig(dim=8, metric="sql2"),
                           device="cpu")
    out = list(db.query_stream([rng.standard_normal((3, 8))], 2))
    assert out == [[[], [], []]]
    db.close()


def test_query_stream_mutation_between_batches(tmp_path, rng):
    """A mutation between submit and collect must not change the in-flight
    batch's answer."""
    pts = rng.standard_normal((200, 16)).astype(np.float32)
    db = _db(tmp_path / "m.zebra", 16, index_type="ivf", seed=0)
    db.insert_vectors(pts)
    expect_first = db.query(pts[:10], number_of_results=3)

    def gen():
        yield pts[:10]
        # the first batch is in flight; mutate before it is collected
        db.insert_vectors(rng.standard_normal((50, 16)).astype(np.float32))
        yield pts[10:20]

    got = list(db.query_stream(gen(), number_of_results=3))
    assert got[0] == expect_first
    assert len(got) == 2 and got[1]
    db.close()


# -- the port against the JAX package ---------------------------------------------


@pytest.mark.parametrize("options", [{}, dict(index_type="lsh")], ids=["ivf", "lsh"])
def test_search_stream_matches_jax_on_a_jax_written_database(tmp_path, rng, options):
    """A database written by the JAX package, opened by the port: the port's
    ``search_stream`` and ``query_stream`` give the JAX package's ids, batch
    for batch, with distances within 1e-4."""
    centers = rng.standard_normal((20, 64)).astype(np.float32)
    pts = centers[rng.integers(0, 20, 1500)] + 0.2 * rng.standard_normal((1500, 64)).astype(
        np.float32)
    path = str(tmp_path / "j.zebra")
    jdb = Z.Database.create(path, Z.DatabaseConfig(dim=64, index=Z.IndexOptions(**options)))
    jdb.insert_vectors(pts)
    jdb.save()
    batches = [pts[i * 100 : (i + 1) * 100] + 0.01 for i in range(3)]
    want = list(jdb.index.search_stream(batches, 10))
    want_db = list(jdb.query_stream(batches, 10))
    tdb = T.Database.open(path, device="cpu")
    got = list(tdb.index.search_stream(batches, 10))
    assert list(tdb.query_stream(batches, 10)) == got
    assert want_db == want and len(got) == len(want)
    for g, w in zip(got, want):
        for rg, rw in zip(g, w):
            assert_same_or_tied(rg, rw)


def assert_same_or_tied(got, want, tol=1e-4):
    """One query's ``[(id, distance), ...]`` lists: rank by rank the same
    distances within ``tol``; the same ids, except that neighbours closer
    than the two packages' f32 rounding may swap ranks or, at the last
    rank, be exchanged for a tied one."""
    np.testing.assert_allclose([d for _, d in got], [d for _, d in want], rtol=tol, atol=tol)
    dg, dw = dict(got), dict(want)
    for i in dg.keys() & dw.keys():
        assert abs(dg[i] - dw[i]) <= tol * (1 + abs(dw[i]))
    last = want[-1][1]
    for i in dg.keys() ^ dw.keys():
        assert abs(dg.get(i, dw.get(i)) - last) <= tol * (1 + abs(last))
    swapped = [j for j, ((a, _), (b, _)) in enumerate(zip(got, want)) if a != b]
    for j in swapped:
        assert abs(got[j][1] - want[j][1]) <= tol * (1 + abs(want[j][1]))


def test_packed_readback_matches_jax(rng):
    """One ``[B, 2k]`` int32 readback: distance bits beside the slots, -1
    where invalid; unpacked to f32 distances, int64 slots and validity. The
    packed bits equal the JAX package's ``_pack_results``, special values
    included."""
    d = rng.standard_normal((6, 5)).astype(np.float32)
    d[0, 0], d[1, 1], d[2, 2], d[3, 3] = np.inf, -0.0, np.float32(1e-42), np.nan
    s = rng.integers(0, 1 << 30, (6, 5)).astype(np.int32)
    v = rng.random((6, 5)) > 0.3
    want = np.asarray(JB._pack_results(d, s, v))
    got = TB._pack_results(torch.from_numpy(d), torch.from_numpy(s).long(), torch.from_numpy(v))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    gd, gs, gv = TB._unpack_results(got.numpy(), 4, 5)
    jd, js, jv = JB._unpack_results(want, 4, 5)
    assert np.array_equal(gd.view(np.uint32), jd.view(np.uint32))
    assert gs.dtype == np.int64 and np.array_equal(gs, js) and np.array_equal(gv, jv)
    assert np.array_equal(gv, v[:4]) and (gs[~gv] == -1).all()


# -- the pipelined insert ---------------------------------------------------------


TIERS = {"scan": {}, "balanced": dict(dtype="bfloat16", refine=0, num_probes=4),
         "f32": dict(dtype="float32", refine=0), "int8": dict(dtype="int8", refine=0)}


def _state_arrays(st):
    return {name: getattr(st, name) for name in
            ("counts", "vectors", "norms", "valid", "overflow", "scales", "residual", "rscales")
            if getattr(st, name) is not None}


@pytest.mark.parametrize("tier", list(TIERS))
def test_multi_span_insert_equals_one_span_per_call(rng, tier):
    """A warm insert of several spans in one ``add`` (span t+1 staged while
    span t inserts, slots read back two spans behind) stores bitwise what
    the same spans store added one call at a time: slots, codes, scales,
    norms and counts."""
    x = rng.standard_normal((3000, 48)).astype(np.float32)
    ids = [bytes([1 + i // 250, 1 + i % 250]) + b"\x05" * 14 for i in range(3000)]
    opts = T.IndexOptions(num_clusters=16, seed=3, **TIERS[tier])
    one, per = (TIndex(dim=48, options=opts, device="cpu") for _ in range(2))
    for idx in (one, per):
        idx.add(x[:1000], ids=ids[:1000])
    one.add(x[1000:], ids=ids[1000:], span_rows=256)
    for s in range(1000, 3000, 256):
        per.add(x[s : s + 256], ids=ids[s : s + 256])
    a, b = _state_arrays(one.state), _state_arrays(per.state)
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), name
    assert len(one._id_to_slot) == len(per._id_to_slot) == len(ids)
    assert all(one._id_to_slot.get(i) == per._id_to_slot.get(i) for i in ids)
    assert (one._used_slots, one._spare_used) == (per._used_slots, per._spare_used)


@pytest.mark.parametrize("tier", ["4", "balanced"])
def test_pipelined_spare_growth_matches_jax(rng, monkeypatch, tier):
    """Spans that overflow a full spare inside one pipelined ``add``: both
    packages resolve slots two spans behind, grow the spare and retry the
    rows it could not take, so they store the same state and slots (both
    defer the rebuild their policy then asks for, as under the facade)."""
    x = rng.standard_normal((600, 32)).astype(np.float32)
    cents = x[rng.choice(600, 4, replace=False)] + 0.01
    monkeypatch.setattr(JIndex, "_train_centroids",
                        lambda self, k, data: jnp.asarray(cents[:k]))
    monkeypatch.setattr(TIndex, "_train_centroids",
                        lambda self, k, data: torch.from_numpy(cents[:k].copy()))
    ids = [bytes([1 + i // 250, 1 + i % 250]) + b"\x0b" * 14 for i in range(600)]
    kw = dict(num_clusters=4, cluster_capacity=32, spare_capacity=64,
              **(dict(refine=4) if tier == "4" else TIERS["balanced"]))
    jix = JIndex(dim=32, options=Z.IndexOptions(**kw))
    jix.defer_rebuild = True
    tix = TIndex(dim=32, options=T.IndexOptions(**kw), device="cpu")
    tix.defer_rebuild = True
    jix.add(x[:100], ids=ids[:100])
    tix.add(x[:100], ids=ids[:100])
    jix.add(x[100:], ids=ids[100:], span_rows=100)
    tix.add(x[100:], ids=ids[100:], span_rows=100)
    assert tix.state.spare_capacity > 64 and len(tix) == 600
    for name, t in _state_arrays(tix.state).items():
        j = np.asarray(getattr(jix.state, name))
        if t.dtype == torch.bfloat16:
            t, j = t.view(torch.int16), j.view(np.int16)
        if name == "norms":  # f32 sums taken in another order
            np.testing.assert_allclose(t.numpy(), j, rtol=1e-6)
        else:
            np.testing.assert_array_equal(t.numpy(), j, err_msg=name)
    assert all(tix._id_to_slot.get(i) == jix._id_to_slot.get(i) for i in ids)


def test_insert_timers_and_wal_order(tmp_path, rng, monkeypatch):
    """Each span's log record is appended after its copy is queued and
    before its insert is dispatched (the JAX order), and the pipeline's
    stages are timed."""
    from zebra_tpu_torch.profiling import GLOBAL_STATS

    events = []
    # a spare that takes the whole second insert: no spare-growth retry
    db = _db(tmp_path / "w.zebra", 16, index_type="ivf", seed=0, spare_capacity=65536)
    db.insert_vectors(rng.standard_normal((300, 16)).astype(np.float32))
    idx = db.index
    for name in ("_ship", "_insert_batch_dev"):
        orig = getattr(idx, name)
        monkeypatch.setattr(idx, name, lambda *a, _o=orig, _n=name, **k: (events.append(_n),
                                                                         _o(*a, **k))[1])
    append = db._delta.append_insert_q8
    monkeypatch.setattr(db._delta, "append_insert_q8",
                        lambda *a: (events.append("wal"), append(*a))[1])
    GLOBAL_STATS.ops.clear()
    db.insert_vectors(rng.standard_normal((40000, 16)).astype(np.float32))  # 16384-row spans
    assert events == ["_ship", "wal", "_ship", "wal", "_insert_batch_dev", "_ship", "wal",
                      "_insert_batch_dev", "_insert_batch_dev"]
    stages = GLOBAL_STATS.summary()
    assert {n: stages[n]["calls"] for n in ("insert.stage", "insert.quant", "insert.dispatch",
                                            "insert.resolve")} == dict.fromkeys(
        ("insert.stage", "insert.quant", "insert.dispatch", "insert.resolve"), 3)
    assert stages["insert.resolve"]["items"] == 40000
    assert db.stats.summary()["insert.wal"]["calls"] == 4  # the first insert's one span too


def test_query_streams_beside_a_writer(tmp_path, rng):
    """Readers streaming queries while a writer inserts and removes (more
    threads than cores, a short switch interval): every batch answers from a
    consistent state — each reader's own rows find themselves first — and
    nothing raises."""
    import sys
    import threading

    pts = rng.standard_normal((1000, 16)).astype(np.float32)
    db = _db(tmp_path / "c.zebra", 16, index_type="ivf", seed=0)
    ids = db.insert_vectors(pts)
    errors, interval = [], sys.getswitchinterval()

    def reader(t):
        try:
            rows = pts[t * 50 : (t + 1) * 50]
            for got in db.query_stream([rows[:25], rows[25:]] * 3, 3):
                assert len(got) == 25 and all(len(r) == 3 for r in got)
            for got, want in zip(db.query_stream([rows], 1), [ids[t * 50 : (t + 1) * 50]]):
                assert [r[0][0] for r in got] == want
        except Exception as e:  # the main thread reports it
            errors.append(e)

    def writer():
        try:
            for _ in range(4):
                new = db.insert_vectors(10.0 + rng.standard_normal((64, 16)).astype(np.float32))
                db.remove(new[:32])
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=reader, args=(t,)) for t in range(12)]
    threads.append(threading.Thread(target=writer))
    sys.setswitchinterval(1e-5)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads) and not errors, errors
    assert len(db) == 1000 + 4 * 32
