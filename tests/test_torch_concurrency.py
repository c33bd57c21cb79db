"""Concurrent readers and writers on the port's Database facade while its
background retrain and log fold run (the twin of ``tests/test_concurrency.py``),
on the CPU."""

import sys
import threading

import numpy as np

import zebra_tpu_torch as T

#: the longest any thread of these tests may take, seconds
WAIT = 300


def test_concurrent_insert_query_remove_with_workers(tmp_path, rng, monkeypatch):
    """Three writers, three readers and a remover against a database whose
    inserts trigger growth retrains and whose log folds at a tiny floor:
    no thread fails, the counts add up, every surviving id is present, and
    no query that started after a remove returned names the removed id."""
    db = T.Database.create(str(tmp_path / "c.zebra"), T.DatabaseConfig(
        dim=24, metric="cosine", index=T.IndexOptions(seed=0)), device="cpu")
    db._fold_floor = 1 << 14
    monkeypatch.setattr(type(db), "_fold_threshold",
                        lambda self, allow_measure=False: self._fold_floor)
    seed = rng.standard_normal((100, 24)).astype(np.float32)
    db.insert_vectors(seed)
    errors: list[BaseException] = []
    lock = threading.Lock()
    inserted: list[bytes] = []
    removed: set[bytes] = set()
    rows = {t: np.random.default_rng(t).standard_normal((8, 40, 24)).astype(np.float32)
            for t in range(3)}

    def guard(fn):
        def run(*a):
            try:
                fn(*a)
            except BaseException as e:  # noqa: BLE001 — reported by the test
                errors.append(e)
        return run

    @guard
    def writer(t):
        for i in range(8):
            ids = db.insert_vectors(rows[t][i])
            with lock:
                inserted.extend(ids)

    @guard
    def reader(t):
        for i in range(12):
            with lock:
                gone = set(removed)
            res = db.query(seed[(t * 12 + i) % 100 : (t * 12 + i) % 100 + 4], 5)
            assert len(res) == 4 and all(len(r) == 5 for r in res)
            assert not gone & {i for r in res for i, _ in r}
            stream = list(db.query_stream([seed[:3], seed[3:6]], 5))
            assert not gone & {i for b in stream for r in b for i, _ in r}

    @guard
    def remover():
        for _ in range(6):
            with lock:
                victims = inserted[:15]
                del inserted[:15]
            if victims:
                db.remove(victims)
                with lock:
                    removed.update(victims)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = ([threading.Thread(target=writer, args=(t,)) for t in range(3)]
                   + [threading.Thread(target=reader, args=(t,)) for t in range(3)]
                   + [threading.Thread(target=remover)])
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    db.wait_for_retrain(timeout=WAIT)
    db.wait_for_fold(timeout=WAIT)
    assert not errors, errors
    assert db._retrain_count >= 1 and db._fold_count >= 1
    assert len(db) == 100 + 3 * 8 * 40 - len(removed)
    assert all(i in db.index for i in inserted) and not any(i in db.index for i in removed)
    db2 = T.Database.open(db.path, device="cpu")
    assert len(db2) == len(db) and not any(i in db2.index for i in removed)
    db2.close()
    db.close()


def test_queries_share_the_read_lock_during_a_retrain(tmp_path, rng):
    """Queries answer while a retrain builds: the retrain holds only brief
    locks, so a query sent while the shadow trains completes before the
    shadow is released."""
    db = T.Database.create(str(tmp_path / "q.zebra"), T.DatabaseConfig(
        dim=16, metric="sql2", index=T.IndexOptions(seed=0)), device="cpu")
    v = rng.standard_normal((200, 16)).astype(np.float32)
    db.insert_vectors(v)
    entered, release = threading.Event(), threading.Event()
    cls = type(db.index)
    orig = cls._shadow_begin

    def held(self, n, sample):
        entered.set()
        assert release.wait(WAIT)
        return orig(self, n, sample)

    cls._shadow_begin = held
    try:
        for _ in range(4):
            db.insert_vectors(rng.standard_normal((200, 16)).astype(np.float32))
        assert entered.wait(WAIT)
        res = db.query(v[:8], 3)  # would deadlock if the retrain held a lock
        assert len(res) == 8 and all(len(r) == 3 for r in res)
        release.set()
        db.wait_for_retrain(timeout=WAIT)
    finally:
        cls._shadow_begin = orig
        release.set()
    assert db._retrain_count == 1
    db.close()
