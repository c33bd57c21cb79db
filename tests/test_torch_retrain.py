"""Background retrains of the port's Database facade (the twin of
``tests/test_retrain.py``), on the CPU.

Under the facade the index defers its rebuilds; a worker thread builds a
SHADOW index from chunked captures with no lock held, replays the mutations
journaled meanwhile and swaps it in under a brief write lock. A crash at any
point, the swap included (which never touches disk), recovers from the
snapshot and the log. Unlike the reference's growth test, these tests order
the retrain thread with ``wait_for_retrain`` or an event before asserting what
it built, so none of them races it.
"""

import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zebra_tpu as Z
import zebra_tpu_torch as T
from zebra_tpu.index.ivf_host import IVFIndex as JIndex
from zebra_tpu_torch.index import ivf_host as TH

import growth_parity

#: the longest any test waits on a worker thread, seconds
WAIT = 120


@pytest.fixture
def rng():
    return np.random.default_rng(5)


def _mkdb(tmp_path, name="r.zebra", **kw):
    cfg = T.DatabaseConfig(dim=16, metric="sql2", durability="full",
                           index=T.IndexOptions(index_type="ivf", seed=0), **kw)
    db = T.Database.create(str(tmp_path / name), cfg, device="cpu")
    db._fold_floor = 1 << 30  # retrains alone
    return db


def _rows(rng, n, d=16):
    return rng.standard_normal((n, d)).astype(np.float32)


def _joined(db):
    db.wait_for_retrain(timeout=WAIT)
    t = db._retrain_thread
    assert t is None or not t.is_alive()


def test_growth_retrain_runs_in_background(tmp_path, rng):
    """The fourth insert of 200 rows passes 4x the built size: the mutating
    call returns with the retrain wanted, a worker thread builds and swaps
    it (waited for before the next insert), the next insert lands on the
    adopted state."""
    db = _mkdb(tmp_path)
    threads = []
    orig = TH.IVFIndex._shadow_begin

    def spy(self, n, sample):
        threads.append(threading.current_thread().name)
        return orig(self, n, sample)

    TH.IVFIndex._shadow_begin = spy
    try:
        ids = db.insert_vectors(_rows(rng, 200))
        assert db.index._built_n == 200
        for _ in range(5):
            ids += db.insert_vectors(_rows(rng, 200))
            _joined(db)
    finally:
        TH.IVFIndex._shadow_begin = orig
    assert threads == ["zebra-retrain"]
    assert db._retrain_started == db._retrain_count == 1
    assert [r for r, _, _ in db._retrain_log] == ["growth"]
    assert db.index._rebuild_wanted is None
    assert db.index._built_n == 1000 and len(db.index) == 1200
    assert all(i in db.index for i in ids)
    db.close()


def _inject_centroids(monkeypatch, cents):
    monkeypatch.setattr(JIndex, "_train_centroids", lambda self, k, data: jnp.asarray(cents[:k]))
    monkeypatch.setattr(TH.IVFIndex, "_train_centroids",
                        lambda self, k, data: torch.from_numpy(cents[:k].copy()))


def _drive_both(tmp_path, x, queries, bounds, picks):
    return {key: growth_parity.drive(mod, str(tmp_path / f"{key}.zebra"), x, queries, bounds,
                                     picks, **kw)
            for key, mod, kw in (("jax", Z, {}), ("port", T, dict(device="cpu")))}


def _shapes(drive):
    keys = ("live", "K", "C", "spare_used", "spare_capacity", "retrains", "reasons")
    return [{k: step[k] for k in keys} for step in drive["steps"]]


def test_growth_matches_jax(tmp_path, monkeypatch):
    """Fault B: 500 rows, then 10 inserts of 2000, through both packages'
    facades (``tests/growth_parity.py``'s drive; centroids injected, each
    retrain waited for): the same reason at each step (a growth retrain,
    then the spare-critical ones of phase 13's drive) and the same shape
    after it, ending at K=256 with an empty spare (the port had stayed at K=8
    with nearly every row in the spare); recall@10 of 128 held-out queries
    and the self-retrieval of 128 rows just inserted and of 128 of all
    within 2 of the 128 picks after every call."""
    x = np.random.default_rng(0).standard_normal((20628, 64)).astype(np.float32)
    x, queries = x[:20500], x[20500:]
    _inject_centroids(monkeypatch, x[np.random.default_rng(1).choice(20500, 256, replace=False)]
                      + 0.01)
    bounds = [(0, 500)] + [(500 + 2000 * i, 2500 + 2000 * i) for i in range(10)]
    got = _drive_both(tmp_path, x, queries, bounds, 128)
    assert _shapes(got["port"]) == _shapes(got["jax"])
    assert got["port"]["final"] == got["jax"]["final"]
    reasons = got["port"]["reasons"]
    assert reasons[0] == "growth" and "spare-critical" in reasons
    assert got["port"]["final"]["reason_left"] is None
    steps = got["port"]["steps"]
    assert (steps[-1]["K"], steps[-1]["spare_used"], steps[-1]["live"]) == (256, 0, 20500)
    for p, j in zip(steps, got["jax"]["steps"]):
        assert all(abs(p[m] - j[m]) <= 2 / 128 for m in ("recall", "fresh", "self")), (p, j)


def test_tombstone_retrain_compacts(tmp_path, rng):
    db = _mkdb(tmp_path)
    v = _rows(rng, 600)
    ids = db.insert_vectors(v)
    _joined(db)
    before = db._retrain_count
    db.remove(ids[:500])  # 83% tombstones -> a compaction retrain
    _joined(db)
    assert db._retrain_count > before and db._retrain_log[-1][0] == "tombstones"
    assert db.index.stats()["tombstones"] == 0
    res = db.query(v[500:520], 1)
    assert [r[0][0] for r in res] == ids[500:520]
    db.close()


def _hold_ingest(monkeypatch, action):
    """Run ``action`` once, on the retrain thread, inside the shadow's first
    ingest (no lock held there)."""
    fired = {}
    orig = TH.IVFIndex._shadow_ingest

    def hook(self, data, ids):
        if not fired:
            fired["out"] = action()
        return orig(self, data, ids)

    monkeypatch.setattr(TH.IVFIndex, "_shadow_ingest", hook)
    return fired


def test_mutations_during_retrain_replayed(tmp_path, rng, monkeypatch):
    """Inserts and removes landing while the shadow builds are journaled and
    replayed onto it before the swap: nothing lost, nothing resurrected."""
    db = _mkdb(tmp_path)
    seeded = db.insert_vectors(_rows(rng, 200))

    def mutate():
        ins = db.insert_vectors(_rows(rng, 32))
        db.remove(seeded[:8])
        return ins

    fired = _hold_ingest(monkeypatch, mutate)
    for _ in range(5):
        db.insert_vectors(_rows(rng, 200))
        _joined(db)
    assert fired, "retrain never ran"
    assert db._retrain_count >= 1
    assert all(i in db.index for i in fired["out"])
    assert all(i not in db.index for i in seeded[:8])
    assert len(db) == 1200 + 32 - 8
    db.close()


def test_clear_during_retrain_aborts_swap(tmp_path, rng, monkeypatch):
    db = _mkdb(tmp_path)
    db.insert_vectors(_rows(rng, 200))
    fired = _hold_ingest(monkeypatch, db.clear_database)
    for _ in range(4):
        db.insert_vectors(_rows(rng, 200))
    _joined(db)
    assert fired, "retrain never raced the clear"
    assert db._retrain_count == 0 and len(db.index) == 0
    db.close()


def test_retrain_worker_crash_leaves_serving_state(tmp_path, rng, monkeypatch):
    """A retrain that dies mid-build leaves the database serving its state;
    the next trigger retries and succeeds."""
    db = _mkdb(tmp_path)
    ids = db.insert_vectors(_rows(rng, 200))
    boom = {"n": 0}

    def explode(self, data, ids_):
        boom["n"] += 1
        raise RuntimeError("injected retrain crash")

    monkeypatch.setattr(TH.IVFIndex, "_shadow_ingest", explode)
    for _ in range(5):
        ids += db.insert_vectors(_rows(rng, 200))
        _joined(db)
    monkeypatch.undo()
    assert boom["n"] >= 1 and db._retrain_count == 0
    assert db._retrain_journal is None
    assert len(db.index) == 1200 and all(i in db.index for i in ids)
    db.insert_vectors(_rows(rng, 8))
    _joined(db)
    assert db._retrain_count == 1
    db.close()


def test_crash_across_retrain_swap_recovers(tmp_path, rng):
    """The swap never touches disk: reopening after it without a close
    recovers every row and every remove from the snapshot and the log."""
    db = _mkdb(tmp_path)
    ids = db.insert_vectors(_rows(rng, 200))
    for _ in range(5):
        ids += db.insert_vectors(_rows(rng, 200))
        _joined(db)
    assert db._retrain_count >= 1
    db.remove(ids[:50])
    db2 = T.Database.open(db.path, device="cpu")
    assert len(db2.index) == 1150
    assert all(i not in db2.index for i in ids[:50])
    assert all(i in db2.index for i in ids[50:])
    db2.close()
    db.close()


def test_hbm_budget_skip_defers_until_growth(tmp_path, rng, monkeypatch):
    """A shadow whose transient does not fit the budget is skipped (serving
    state untouched) and not retried until the index grew 25%."""
    db = _mkdb(tmp_path)
    ids = db.insert_vectors(_rows(rng, 200))
    monkeypatch.setattr(TH, "_STAGE_HBM_BUDGET", 1)
    for _ in range(5):
        ids += db.insert_vectors(_rows(rng, 200))
        _joined(db)
    assert db._retrain_count == 0 and db._retrain_skip_n == 1000
    assert db._retrain_started == 1  # 1200 < 1.25 x 1000: no retry
    assert all(i in db.index for i in ids)
    monkeypatch.setattr(TH, "_STAGE_HBM_BUDGET", 12 << 30)
    db.insert_vectors(_rows(rng, 200))  # 1400 >= 1250
    _joined(db)
    assert db._retrain_count == 1 and db._retrain_skip_n == 0
    db.close()


def test_critical_pressure_drains_on_mutating_thread(tmp_path, rng, monkeypatch):
    """A "-critical" reason is backpressure: the mutating call itself waits
    (no lock held) until the rebalance landed."""
    db = _mkdb(tmp_path)
    ids = db.insert_vectors(_rows(rng, 800))
    monkeypatch.setattr(db.index, "_rebuild_reason", lambda: "spare-critical")
    ids += db.insert_vectors(_rows(rng, 100))
    assert db._retrain_drains >= 1 and db._retrain_count >= 1
    assert db.index._rebuild_wanted is None and not db._retrain_critical
    assert all(i in db.index for i in ids[::37])
    monkeypatch.undo()
    db.close()


def test_submitted_query_keeps_its_ids_across_the_swap(tmp_path, rng):
    """A token submitted before a retrain's swap is named by the slot -> id
    map it was answered from (the swap reassigns every slot)."""
    db = _mkdb(tmp_path)
    v = _rows(rng, 600)
    db.insert_vectors(v)
    _joined(db)
    want = db.query(v[:40], 5)
    tok = db.index.search_submit(v[:40], 5)
    db.index._rebuild_wanted = "test"
    db._retrain_worker()
    assert db._retrain_count == 1 and db.index._struct_gen >= 1
    assert db.index.format_collect(tok) == want
    db.close()


def test_lsh_rebuilds_in_the_background(tmp_path, rng, monkeypatch):
    """Under the facade LSH's rebuilds leave the mutating call for the
    shadow retrain; a bare index still rebuilds inline. An
    "overflow-capacity" reason carries the doubled bucket depth over."""
    cfg = T.DatabaseConfig(dim=16, metric="sql2",
                           index=T.IndexOptions(index_type="lsh", seed=0))
    db = T.Database.create(str(tmp_path / "l.zebra"), cfg, device="cpu")
    inline = []
    orig = type(db.index).rebuild

    def spy(self, reason=None):
        if self is db.index or self is bare:  # not the shadow, which rebuilds inline
            inline.append(reason)
            return None
        return orig(self, reason)

    bare = None
    monkeypatch.setattr(type(db.index), "rebuild", spy)
    ids = db.insert_vectors(_rows(rng, 200))
    for _ in range(4):
        ids += db.insert_vectors(_rows(rng, 200))
        _joined(db)
    assert not inline and db._retrain_count >= 1
    assert len(db) == 1000 and all(i in db.index for i in ids)
    shadow = db.index._clone_empty()
    db.index._prepare_shadow(shadow, "overflow-capacity")
    assert shadow._cap_boost == 2 * db.index._cap_boost
    bare = type(db.index)(dim=16, metric="sql2", options=cfg.index, device="cpu")
    bare.add(_rows(rng, 100))
    bare.add(_rows(rng, 500))
    assert inline
    db.close()


def test_reopen_replay_kicks_the_retrain(tmp_path, rng):
    """A log replayed at open that leaves a rebuild wanted starts it."""
    db = _mkdb(tmp_path)
    db.insert_vectors(_rows(rng, 200))
    db.save()
    db.index.defer_rebuild = True
    db._retrain_skip_n = 10 ** 9  # this process retrains nothing
    for _ in range(4):
        db.insert_vectors(_rows(rng, 200))
    db2 = T.Database.open(db.path, device="cpu")
    _joined(db2)
    assert db2._retrain_count == 1 and db2.index._built_n == 1000 and len(db2) == 1000
    db2.close()


def test_exit_drain_stops_a_running_retrain(tmp_path, rng, monkeypatch):
    """The exit hook bumps the generations, so a retrain in flight drops its
    swap at its next chunk, and joins it."""
    from zebra_tpu_torch import db as DBM

    db = _mkdb(tmp_path)
    db.insert_vectors(_rows(rng, 200))
    go, entered = threading.Event(), threading.Event()
    orig = TH.IVFIndex._shadow_begin

    def held(self, n, sample):
        entered.set()
        assert go.wait(WAIT)
        return orig(self, n, sample)

    monkeypatch.setattr(TH.IVFIndex, "_shadow_begin", held)
    for _ in range(4):
        db.insert_vectors(_rows(rng, 200))
    assert entered.wait(WAIT)
    threading.Timer(0.05, go.set).start()
    DBM._drain_background_workers()
    assert not db._retrain_thread.is_alive()
    assert db._retrain_count == 0 and len(db) == 1000
    db.close()
    assert os.path.exists(db.path)
