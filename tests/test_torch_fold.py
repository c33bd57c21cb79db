"""The background log fold of the port's Database facade (the twin of
``tests/test_fold.py``), on the CPU, and databases grown, retrained and
folded by one package opened in the other.

Once the log outgrows the fold threshold a worker thread captures the index
(device copies under the read lock, or past the clone budget chunks copied
under brief read locks), streams it to disk with no lock held, swaps it in
and drops exactly the log prefix it covers; a crash at any point recovers
the whole database.
"""

import os
import threading

import numpy as np
import pytest

import zebra_tpu as Z
import zebra_tpu_torch as T
from zebra_tpu_torch.index import base as TB
from zebra_tpu_torch.storage.snapshots import CaptureAborted, ChunkedSource, write_npz_streamed

#: the longest any test waits on a worker thread, seconds
WAIT = 120


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _mkdb(tmp_path, floor=1 << 12, name="f.zebra"):
    db = T.Database.create(str(tmp_path / name), T.DatabaseConfig(
        dim=16, metric="sql2", durability="full",
        index=T.IndexOptions(index_type="ivf", seed=0)), device="cpu")
    db._fold_floor = floor
    return db


def _rows(rng, n, d=16):
    return rng.standard_normal((n, d)).astype(np.float32)


def _pin_threshold(monkeypatch, db):
    """The fold mechanism alone: the trigger is the floor (with the real
    policy a snapshot outweighing the log rightly stops the folds)."""
    monkeypatch.setattr(type(db), "_fold_threshold",
                        lambda self, allow_measure=False: self._fold_floor)


def _joined(db):
    db.wait_for_fold(timeout=WAIT)
    db.wait_for_retrain(timeout=WAIT)
    for t in (db._fold_thread, db._retrain_thread):
        assert t is None or not t.is_alive()


def test_background_fold_truncates_and_recovers(tmp_path, rng, monkeypatch):
    db = _mkdb(tmp_path)
    _pin_threshold(monkeypatch, db)
    all_ids = []
    for _ in range(6):
        all_ids += db.insert_vectors(_rows(rng, 200))
        _joined(db)
    assert db._fold_count >= 1
    assert db._delta.size() <= db._fold_floor
    db2 = T.Database.open(db.path, device="cpu")  # a crash: no close, no save
    assert len(db2.index) == len(all_ids) and all(i in db2.index for i in all_ids)
    db2.close()


def test_fold_policy_follows_the_snapshot(tmp_path, rng):
    """Unpinned: the first fold triggers at the floor; the threshold then
    grows to the snapshot's bytes (never below the floor)."""
    db = _mkdb(tmp_path)
    assert db._fold_threshold() == db._fold_floor  # no snapshot arrays yet
    db.insert_vectors(_rows(rng, 600))
    _joined(db)
    assert db._fold_count == 1
    snap = os.path.getsize(os.path.join(db._index_dir(), "arrays.npz"))
    assert db._fold_threshold() == max(db._fold_floor, snap)
    assert db._fold_threshold(allow_measure=True) >= max(db._fold_floor, snap)
    db.close()


def test_mutations_during_fold_survive(tmp_path, rng, monkeypatch):
    """Rows inserted while the fold streams its capture land past the fold's
    offset and survive the truncation."""
    db = _mkdb(tmp_path)
    during = []
    orig = type(db.index).write_capture

    def slow_write(self, directory, cap):
        if not during:  # on the fold thread, no lock held
            during.extend(db.insert_vectors(_rows(rng, 32)))
        return orig(self, directory, cap)

    monkeypatch.setattr(type(db.index), "write_capture", slow_write)
    for _ in range(6):
        db.insert_vectors(_rows(rng, 200))
        _joined(db)
    assert during, "fold never ran"
    db2 = T.Database.open(db.path, device="cpu")
    assert all(i in db2.index for i in during)
    db2.close()


def test_fold_capture_is_a_copy(tmp_path, rng):
    """The port writes the state in place, so a capture streamed with no lock
    held must be a copy: inserts and removes after a clone=True capture do
    not reach it (the JAX package's donation hazard, the port's aliasing
    one). Past the clone budget the capture is refused."""
    db = _mkdb(tmp_path, floor=1 << 30)
    ids = db.insert_vectors(_rows(rng, 300))
    with db._lock.read():
        cap = db.index.snapshot_capture(clone=True)
    assert cap["cloned"] is True
    db.insert_vectors(_rows(rng, 32))
    db.remove(ids[:10])
    tmp = db._index_dir() + ".fold"
    db.index.write_capture(tmp, cap)
    loaded = type(db.index).load(tmp, device="cpu")
    assert len(loaded) == 300 and all(i in loaded for i in ids[:10])
    old = TB._CLONE_HBM_BUDGET
    try:
        TB._CLONE_HBM_BUDGET = 0
        assert db.index.snapshot_capture(clone=True)["cloned"] is False
    finally:
        TB._CLONE_HBM_BUDGET = old
    db.close()


def test_crash_between_arrays_and_meta_swap(tmp_path, rng):
    """A crash mid-commit (new arrays.npz, old index.json, log untruncated):
    the replay is idempotent and recovery exact."""
    db = _mkdb(tmp_path, floor=1 << 30)
    ids = db.insert_vectors(_rows(rng, 300))
    db.save()
    ids += db.insert_vectors(_rows(rng, 300))
    cap = db.index.snapshot_capture()
    tmp = db._index_dir() + ".fold"
    db.index.write_capture(tmp, cap)
    os.replace(os.path.join(tmp, "arrays.npz"), os.path.join(db._index_dir(), "arrays.npz"))
    db2 = T.Database.open(db.path, device="cpu")
    assert len(db2.index) == len(ids) and all(i in db2.index for i in ids)
    db2.close()


def test_explicit_save_supersedes_fold(tmp_path, rng, monkeypatch):
    """A save racing the fold's stream invalidates the fold's commit."""
    db = _mkdb(tmp_path)
    seen = {}
    orig = type(db.index).write_capture

    def racing_write(self, directory, cap):
        if directory.endswith(".fold") and "saved" not in seen:
            seen["saved"] = True
            seen["extra"] = db.insert_vectors(_rows(rng, 16))
            db.save()
        return orig(self, directory, cap)

    monkeypatch.setattr(type(db.index), "write_capture", racing_write)
    for _ in range(6):
        db.insert_vectors(_rows(rng, 200))
        _joined(db)
    assert seen.get("saved"), "fold never raced the save"
    assert not os.path.exists(db._index_dir() + ".fold")
    db2 = T.Database.open(db.path, device="cpu")
    assert all(i in db2.index for i in seen["extra"])
    db2.close()


def _chunked(monkeypatch, db):
    """Every clone refused: the fold streams chunks."""
    monkeypatch.setattr(TB, "_CLONE_HBM_BUDGET", 0)
    _pin_threshold(monkeypatch, db)


def test_chunked_fold_never_takes_the_write_lock_to_stream(tmp_path, rng, monkeypatch):
    """Past the clone budget the fold streams chunks under brief read locks:
    the fold thread takes the write lock only to commit."""
    db = _mkdb(tmp_path)
    _chunked(monkeypatch, db)
    writes, fetches = [], []
    orig_write, orig_fetch = db._lock.acquire_write, type(db)._fold_fetch_chunk

    def spy_write():
        writes.append(threading.current_thread().name)
        orig_write()

    def spy_fetch(self, *a):
        fetches.append(1)
        return orig_fetch(self, *a)

    monkeypatch.setattr(db._lock, "acquire_write", spy_write)
    monkeypatch.setattr(type(db), "_fold_fetch_chunk", spy_fetch)
    all_ids = []
    for _ in range(6):
        all_ids += db.insert_vectors(_rows(rng, 200))
        _joined(db)
    assert db._fold_count >= 1 and fetches
    assert writes.count("zebra-fold") == db._fold_count
    assert db._delta.size() <= db._fold_floor
    db2 = T.Database.open(db.path, device="cpu")
    assert len(db2.index) == len(all_ids) and all(i in db2.index for i in all_ids)
    db2.close()


def test_chunked_fold_fuzzy_mutations_repaired_by_replay(tmp_path, rng, monkeypatch):
    """Mutations between chunk fetches make the snapshot a fuzzy mixture;
    the untruncated log suffix repairs it exactly."""
    db = _mkdb(tmp_path)
    _chunked(monkeypatch, db)
    state = {"during": [], "removed": None}
    orig = type(db)._fold_fetch_chunk

    def mutating_fetch(self, *a):
        out = orig(self, *a)
        if not state["during"]:  # on the fold thread, no lock held
            state["during"] = db.insert_vectors(_rows(rng, 32))
            state["removed"] = state["keep"][0]
            db.remove([state["removed"]])
        return out

    monkeypatch.setattr(type(db), "_fold_fetch_chunk", mutating_fetch)
    state["keep"] = db.insert_vectors(_rows(rng, 300))
    for _ in range(6):
        db.insert_vectors(_rows(rng, 200))
        _joined(db)
    assert state["during"], "chunked fold never ran"
    db2 = T.Database.open(db.path, device="cpu")
    assert all(i in db2.index for i in state["during"])
    assert state["removed"] not in db2.index
    assert all(i in db2.index for i in state["keep"][1:])
    db2.close()


def test_chunked_fold_aborts_on_struct_change(tmp_path, rng, monkeypatch):
    """A rebuild mid-stream changes every slot's meaning: the fold aborts,
    commits nothing, and recovery is exact."""
    db = _mkdb(tmp_path)
    _chunked(monkeypatch, db)
    fired = {}
    orig = type(db)._fold_fetch_chunk

    def rebuilding_fetch(self, *a):
        out = orig(self, *a)
        if "rebuilt" not in fired:
            fired["rebuilt"] = True
            with db._lock.write():
                db.index.rebuild("test")
        return out

    monkeypatch.setattr(type(db), "_fold_fetch_chunk", rebuilding_fetch)
    ids = db.insert_vectors(_rows(rng, 300))
    for _ in range(6):
        ids += db.insert_vectors(_rows(rng, 200))
        _joined(db)
    assert fired.get("rebuilt"), "chunked fold never raced the rebuild"
    assert not os.path.exists(db._index_dir() + ".fold")
    db2 = T.Database.open(db.path, device="cpu")
    assert len(db2.index) == len(ids)
    db2.close()


def test_aborted_stream_leaves_no_file(tmp_path):
    """A chunk fetch that raises ``CaptureAborted`` leaves no arrays file."""
    path = str(tmp_path / "a.npz")

    def fetch(s, e):
        if s:
            raise CaptureAborted("moved")
        return np.zeros((e - s, 4), np.float32)

    src = ChunkedSource((1 << 23, 4), np.float32, fetch)
    with pytest.raises(CaptureAborted):
        write_npz_streamed(path, {"a": np.arange(3), "b": src})
    assert os.listdir(tmp_path) == []


def test_chunked_capture_writes_the_same_bytes(tmp_path, rng, monkeypatch):
    """A chunked capture of a quiet database writes the bytes a cloned one
    writes, in the JAX package's format."""
    db = _mkdb(tmp_path, floor=1 << 30)
    db.insert_vectors(_rows(rng, 500))
    _joined(db)
    with db._lock.read():
        cap = db.index.snapshot_capture(clone=True)
        gen, sgen = db._save_gen, db.index._struct_gen
    db.index.write_capture(str(tmp_path / "clone"), cap)
    db.index.write_capture(str(tmp_path / "chunk"), db._fold_chunked_capture(cap, gen, sgen))
    a, b = (np.load(tmp_path / d / "arrays.npz") for d in ("clone", "chunk"))
    assert sorted(a.files) == sorted(b.files)
    for f in a.files:
        np.testing.assert_array_equal(a[f], b[f])
    db.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_grown_retrained_folded_database_opens_in_the_other_package(tmp_path, writer, monkeypatch):
    """A database one package grew (a growth retrain), folded (snapshot plus
    a log tail) and left without a close opens in the other package with
    the same live ids and the same query answers."""
    x = np.random.default_rng(3).standard_normal((3200, 32)).astype(np.float32)
    mods = {"jax": (Z, {}), "port": (T, dict(device="cpu"))}
    mod, kw = mods[writer]
    cfg = mod.DatabaseConfig(dim=32, metric="sql2",
                             index=mod.IndexOptions(index_type="ivf", seed=0))
    db = mod.Database.create(str(tmp_path / "x.zebra"), cfg, **kw)
    db._fold_floor = 1 << 12
    monkeypatch.setattr(type(db), "_fold_threshold",
                        lambda self, allow_measure=False: self._fold_floor)
    ids = db.insert_vectors(x[:400])
    for s in range(400, 3200, 700):
        ids += db.insert_vectors(x[s : s + 700])
        db.wait_for_retrain(timeout=WAIT)
        db.wait_for_fold(timeout=WAIT)
    db.remove(ids[:20])
    db.wait_for_fold(timeout=WAIT)
    assert db._retrain_count >= 1 and db._fold_count >= 1 and db._delta.size() > 0
    want = db.query(x[100:140], 5)
    other, okw = mods["port" if writer == "jax" else "jax"]
    db2 = other.Database.open(db.path, **okw)
    assert len(db2) == 3180 and all(i not in db2.index for i in ids[:20])
    got = db2.query(x[100:140], 5)
    assert [[i for i, _ in r] for r in got] == [[i for i, _ in r] for r in want]
    np.testing.assert_allclose([[d for _, d in r] for r in got],
                               [[d for _, d in r] for r in want], rtol=1e-4, atol=1e-4)
    db2.wait_for_retrain(timeout=WAIT)
    db2.close()
