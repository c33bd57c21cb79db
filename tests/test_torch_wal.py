"""Write-ahead ordering of the port against the JAX package: the seven crash
points of ``tests/test_wal.py``, each run on both packages.

Each case raises at a stage boundary of a mutation (the same monkeypatched
members, which the port has under the same names), then reopens without
``close``. The JAX suite's assertions are held on both packages, and both
must come back with the same outcome by insertion position: the length,
which of the known and of the new rows are live, and the exact top-1 of the
probes (ids are uuid7 and differ between the packages, so rows are named by
position). Every case runs on the default IVF tier (q8 log records) and on
LSH (f32 records).
"""

from __future__ import annotations

import numpy as np
import pytest

import zebra_tpu_torch as T
from zebra_tpu.config import DatabaseConfig as ZConfig
from zebra_tpu.config import IndexOptions as ZOptions
from zebra_tpu.db import Database as ZDatabase

PACKAGES = {
    "jax": (ZDatabase, ZConfig, ZOptions, {}),
    "port": (T.Database, T.DatabaseConfig, T.IndexOptions, {"device": "cpu"}),
}
TIERS = {"ivf": {}, "lsh": {"index_type": "lsh"}}
DIM = 16


class _Boom(RuntimeError):
    pass


class Run:
    """One package's database for one case: the seed rows inserted with
    documents and saved, so the log starts empty (``tests/test_wal.py``'s
    ``_mkdb``)."""

    def __init__(self, pkg, tier, tmp_path, n=40):
        self.Database, Config, Options, self.kw = PACKAGES[pkg]
        cfg = Config(dim=DIM, metric="sql2", durability="full",
                     index=Options(seed=0, **TIERS[tier]))
        self.rng = np.random.default_rng(42)
        self.db = self.Database.create(str(tmp_path / f"{pkg}.zebra"), cfg, **self.kw)
        self.data = self.rng.standard_normal((n, DIM)).astype(np.float32)
        self.ids = self.db.insert_records(self.data, [f"doc {i}".encode() for i in range(n)])
        self.db.save()

    def reopen(self):
        """A crash: no ``close`` or ``save``; reopen from snapshot + log."""
        self.db._delta.close()
        return self.Database.open(self.db.path, **self.kw)

    def outcome(self, db2, new=None, known=()):
        """What the reopened database holds, by insertion position: its
        length, the liveness of the seed rows and of ``known`` ids, which
        rows of ``new`` (whose ids the crashed call never returned) are
        live, and the exact top-1 of the first seed rows and of ``new``."""
        # the index is read under the facade's read lock: a background
        # retrain that the replay started may swap it in meanwhile
        with db2._lock.read():
            return self._outcome(db2, new, known)

    def _outcome(self, db2, new, known):
        known = list(self.ids) + list(known)
        pos = {i: ("known", j) for j, i in enumerate(known)}
        out = {"len": len(db2), "live": [i in db2.index for i in known]}
        probes = self.data[:3]
        if new is not None:
            live = []
            for j, row in enumerate(db2.index.search(new, k=1, exact=True)):
                hit = bool(row) and row[0][0] not in pos and row[0][1] < 1e-3
                live.append(hit)
                if hit:
                    pos[row[0][0]] = ("new", j)
            out["new_live"] = live
            probes = np.concatenate([probes, new])
        out["top1"] = [pos.get(row[0][0], "unknown") if row else None
                       for row in db2.index.search(probes, k=1, exact=True)]
        return out


def _crash_after(monkeypatch, obj, method, exc=_Boom):
    real = getattr(obj, method)

    def wrapper(*a, **k):
        real(*a, **k)
        raise exc()

    monkeypatch.setattr(obj, method, wrapper)


# -- the seven cases: each drives one package and returns its outcome ----------


def crash_after_blobs_before_log(r: Run, mp):
    """Blobs written, log not appended: the insert never happened."""
    new = r.rng.standard_normal((5, DIM)).astype(np.float32)
    _crash_after(mp, r.db._docs, "save_many")
    with pytest.raises(_Boom):
        r.db.insert_records(new, [b"x"] * 5)
    db2 = r.reopen()
    assert len(db2) == len(r.ids)
    res = db2.query(r.data[:3], 1)
    assert all(row and row[0][0] == r.ids[i] for i, row in enumerate(res))
    return r.outcome(db2, new)


def crash_after_log_before_index(r: Run, mp):
    """Log appended (through the shared record writer), index not mutated:
    replay applies the insert, documents included."""
    new = r.rng.standard_normal((5, DIM)).astype(np.float32)
    _crash_after(mp, r.db._delta, "_append")
    with pytest.raises(_Boom):
        r.db.insert_records(new, [f"n{j}".encode() for j in range(5)])
    db2 = r.reopen()
    assert len(db2) == len(r.ids) + 5
    res = db2.query(new, 1, with_documents=True)
    assert {row[0][2] for row in res} == {f"n{j}".encode() for j in range(5)}
    return r.outcome(db2, new)


def crash_after_index_before_manifest(r: Run, mp):
    """Everything durable but the manifest rewrite: reopen is complete."""
    new = r.rng.standard_normal((5, DIM)).astype(np.float32)
    _crash_after(mp, r.db.index, "add")
    with pytest.raises(_Boom):
        r.db.insert_records(new, [b"y"] * 5)
    db2 = r.reopen()
    assert len(db2) == len(r.ids) + 5
    return r.outcome(db2, new)


def crash_between_spans_replays_logged_prefix(r: Run, mp):
    """Per-span log records: a crash after the second span's record
    recovers exactly the two logged 16-row spans."""
    mp.setattr(r.db, "_insert_span_rows", lambda n: 16)
    new = r.rng.standard_normal((40, DIM)).astype(np.float32)
    calls = {"n": 0}
    real = r.db._delta._append

    def flaky(*a, **k):
        real(*a, **k)
        calls["n"] += 1
        if calls["n"] == 2:
            raise _Boom()

    mp.setattr(r.db._delta, "_append", flaky)
    with pytest.raises(_Boom):
        r.db.insert_vectors(new)
    db2 = r.reopen()
    assert len(db2) == len(r.ids) + 32
    res = db2.query(new[:32], 1)
    assert all(row and row[0][1] < 1e-3 for row in res)
    got = r.outcome(db2, new)
    assert got["new_live"] == [True] * 32 + [False] * 8  # a prefix of whole spans
    return got


def crash_remove_after_log(r: Run, mp):
    """Remove logged but not applied: replay redoes it, index and blobs."""
    victims = r.ids[:7]
    _crash_after(mp, r.db._delta, "append_remove")
    with pytest.raises(_Boom):
        r.db.remove(victims)
    db2 = r.reopen()
    assert len(db2) == len(r.ids) - 7
    assert all(v not in db2.index for v in victims)
    assert db2._docs.read_many(victims) == {}
    return r.outcome(db2)


def crash_remove_before_log(r: Run, mp):
    """Crash before the remove record: nothing removed, nothing lost."""

    def boom(*a, **k):
        raise _Boom()

    mp.setattr(r.db._delta, "append_remove", boom)
    with pytest.raises(_Boom):
        r.db.remove(r.ids[:7])
    db2 = r.reopen()
    assert len(db2) == len(r.ids)
    assert all(v in db2.index for v in r.ids[:7])
    return r.outcome(db2)


def crash_during_dedup_is_replayed(r: Run, mp):
    """The dedup removal is logged like any remove, so a crash after the
    log redoes it on open (the earliest copy of each pair stays)."""
    dups = r.db.insert_records(r.data[:6], [b"dup"] * 6)
    r.db.save()
    _crash_after(mp, r.db._delta, "append_remove")
    with pytest.raises(_Boom):
        r.db.deduplicate()
    db2 = r.reopen()
    assert len(db2) == len(r.ids)
    assert not db2.index.find_duplicates()
    return r.outcome(db2, known=dups)


CASES = [crash_after_blobs_before_log, crash_after_log_before_index,
         crash_after_index_before_manifest, crash_between_spans_replays_logged_prefix,
         crash_remove_after_log, crash_remove_before_log, crash_during_dedup_is_replayed]


@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_crash_point_matches_the_jax_package(tmp_path, monkeypatch, case, tier):
    got = {}
    for pkg in ("jax", "port"):
        with monkeypatch.context() as mp:
            got[pkg] = case(Run(pkg, tier, tmp_path), mp)
    assert got["port"] == got["jax"]
