"""Property-based CRUD sequences (hypothesis) on the port, against a dict
model and against the JAX package: ``tests/test_property.py``'s four tests.

Each drawn sequence goes through the port's index and the model, and the
JAX test's invariants are asserted after every step. The same sequence also
goes through the JAX package's index, which must hold the same live set by
insertion position and answer the same exact top-1 after every step (ids
are uuid7 and differ between the packages, so rows are named by position).
The examples per test are fewer than the JAX file's, for the test's time.
"""

from __future__ import annotations

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import zebra_tpu_torch as T
from zebra_tpu.config import DatabaseConfig as ZConfig
from zebra_tpu.config import IndexOptions as ZOptions
from zebra_tpu.db import Database as ZDatabase
from zebra_tpu.index import load_index as z_load_index
from zebra_tpu.index import make_index as z_make_index
from zebra_tpu_torch.parallel.sharded import ShardedIndex

DIM = 12


def _vec(rng, tag: int) -> np.ndarray:
    r = np.random.default_rng(tag)
    return r.standard_normal(DIM).astype(np.float32)


class Twin:
    """Positions of the rows added to both packages: ``port[i]`` and
    ``jax[i]`` are the ids of the i-th row added."""

    def __init__(self):
        self.port: list[bytes] = []
        self.jax: list[bytes] = []
        self.pos_port: dict[bytes, int] = {}
        self.pos_jax: dict[bytes, int] = {}

    def add(self, pids, jids):
        assert len(pids) == len(jids)
        for p, j in zip(pids, jids):
            self.pos_port[p] = self.pos_jax[j] = len(self.port)
            self.port.append(p)
            self.jax.append(j)

    def jax_of(self, pids):
        return [self.jax[self.pos_port[p]] for p in pids]

    def same_live(self, tidx, jidx):
        assert [p in tidx for p in self.port] == [j in jidx for j in self.jax]

    def same_top1(self, tres, jres):
        assert [self.pos_port[r[0][0]] if r else None for r in tres] == \
            [self.pos_jax[r[0][0]] if r else None for r in jres]


ops_strategy = st.lists(
    st.one_of(
        st.tuples(st.just("add"), st.integers(1, 12)),
        st.tuples(st.just("remove"), st.integers(0, 30)),
        st.tuples(st.just("dedup"), st.just(0)),
        st.tuples(st.just("reload"), st.just(0)),
    ),
    min_size=1,
    max_size=8,
)


@pytest.mark.parametrize("index_type", ["lsh", "ivf"])
@settings(max_examples=5, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(ops=ops_strategy, seed=st.integers(0, 2**16))
def test_crud_sequences_match_model(tmp_path_factory, index_type, ops, seed):
    rng = np.random.default_rng(seed)
    opts = dict(index_type=index_type, seed=0, num_probes=8)
    idx = T.make_index(DIM, metric="sql2", options=T.IndexOptions(**opts), device="cpu")
    jdx = z_make_index(DIM, metric="sql2", options=ZOptions(**opts))
    twin = Twin()
    model: dict[bytes, int] = {}  # port id -> vector tag
    next_tag = seed * 1000 + 1

    for op, arg in ops:
        if op == "add":
            tags = list(range(next_tag, next_tag + arg))
            next_tag += arg
            vecs = np.stack([_vec(rng, t) for t in tags])
            ids = idx.add(vecs)
            twin.add(ids, jdx.add(vecs))
            model.update(zip(ids, tags))
        elif op == "remove":
            live = sorted(model)
            kill = live[: arg % (len(live) + 1)]
            removed = idx.remove(list(kill) + [b"\xff" * 16])  # an unknown id too
            assert sorted(removed) == sorted(kill)
            jkill = twin.jax_of(kill)
            assert sorted(jdx.remove(jkill + [b"\xff" * 16])) == sorted(jkill)
            for i in kill:
                del model[i]
        elif op == "dedup":
            # the vectors are tag-unique, so dedup removes nothing
            assert idx.deduplicate() == [] and jdx.deduplicate() == []
        elif op == "reload":
            d = tmp_path_factory.mktemp("ix")
            idx.save(str(d / "port"))
            idx = T.load_index(str(d / "port"), device="cpu")
            jdx.save(str(d / "jax"))
            jdx = z_load_index(str(d / "jax"))

        assert len(idx) == len(model) == len(jdx)
        for i in model:
            assert i in idx
        twin.same_live(idx, jdx)
        if model:
            # the stored vector itself comes back first (the default IVF tier
            # stores int8 + residual: a self distance of ~2e-6 at DIM=12)
            probe_ids = sorted(model)[:3]
            queries = np.stack([_vec(rng, model[i]) for i in probe_ids])
            res = idx.search(queries, k=1, exact=True)
            for want, row in zip(probe_ids, res):
                assert row and row[0][0] == want and row[0][1] < 1e-4
            twin.same_top1(res, jdx.search(queries, k=1, exact=True))


@settings(max_examples=3, deadline=None)
@given(n=st.integers(2, 40), dup_every=st.integers(2, 5), seed=st.integers(0, 2**16))
def test_dedup_keeps_exactly_one_of_each(n, dup_every, seed):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, DIM)).astype(np.float32)
    dups = base[::dup_every]
    rows = np.concatenate([base, dups])
    idx = T.make_index(DIM, options=T.IndexOptions(index_type="ivf", seed=0), device="cpu")
    jdx = z_make_index(DIM, options=ZOptions(index_type="ivf", seed=0))
    twin = Twin()
    twin.add(idx.add(rows), jdx.add(rows))
    removed = idx.deduplicate()
    assert len(removed) == len(dups)
    assert len(idx) == n
    assert idx.deduplicate() == []  # idempotent
    assert sorted(twin.pos_port[i] for i in removed) == \
        sorted(twin.pos_jax[i] for i in jdx.deduplicate())


@settings(max_examples=3, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(
    ops=st.lists(
        st.one_of(
            st.tuples(st.just("insert"), st.integers(1, 16)),
            st.tuples(st.just("remove"), st.integers(1, 8)),
            st.tuples(st.just("dedup"), st.just(0)),
            st.tuples(st.just("reopen"), st.just(0)),
            st.tuples(st.just("save"), st.just(0)),
        ),
        min_size=2,
        max_size=6,
    ),
    seed=st.integers(0, 2**16),
)
def test_sharded_facade_crud_interleavings(tmp_path_factory, ops, seed):
    """Random CRUD interleavings through the ``Database`` facade with 4
    shards (every shard on the CPU): blobs, the write-ahead log, id maps
    and the sharded index stay consistent across close / reopen, and the
    JAX facade on the same sequence holds the same documents."""
    d = tmp_path_factory.mktemp("sfac")
    kw = dict(dim=12, metric="sql2", model="hash-12", shards=4, durability="full")
    iopts = dict(seed=1, kmeans_iters=2, kmeans_balance_rounds=1)
    db = T.Database.open_or_create(str(d / "port.zebra"),
                                   T.DatabaseConfig(index=T.IndexOptions(**iopts), **kw),
                                   device="cpu")
    jdb = ZDatabase.open_or_create(str(d / "jax.zebra"), ZConfig(index=ZOptions(**iopts), **kw))
    live: dict[bytes, bytes] = {}  # port id -> document
    twin = Twin()
    tag = seed * 10_000
    try:
        for op, arg in ops:
            if op == "insert":
                docs = [f"doc-{tag + i}".encode() for i in range(arg)]
                tag += arg
                ids = db.insert_documents(docs)
                assert len(ids) == len(docs)
                twin.add(ids, jdb.insert_documents(docs))
                live.update(zip(ids, docs))
            elif op == "remove" and live:
                victims = sorted(live)[:arg]
                db.remove(victims + [b"\xfe" * 16])  # an unknown id is a no-op
                jdb.remove(twin.jax_of(victims) + [b"\xfe" * 16])
                for v in victims:
                    live.pop(v)
            elif op == "dedup":
                db.deduplicate()  # tag-unique documents: removes nothing
                jdb.deduplicate()
            elif op == "save":
                db.save()
                jdb.save()
            elif op == "reopen":
                db.close()
                db = T.Database.open(db.path, device="cpu")
                jdb.close()
                jdb = ZDatabase.open(jdb.path)
            assert len(db) == len(live) == len(jdb)
            twin.same_live(db.index, jdb.index)
        if live:
            probe = sorted(live)[:8]
            res = db.query_documents([live[i] for i in probe], number_of_results=1)
            jres = jdb.query_documents([live[i] for i in probe], number_of_results=1)
            for qi, want in enumerate(probe):
                assert list(res[qi].keys()) == [want]
                assert res[qi][want] == live[want]
                assert [twin.pos_jax[j] for j in jres[qi]] == [twin.pos_port[want]]
    finally:
        db.close()
        jdb.close()


@settings(max_examples=3, deadline=None)
@given(
    ops=st.lists(
        st.one_of(
            st.tuples(st.just("add"), st.integers(1, 24)),
            st.tuples(st.just("remove"), st.integers(1, 12)),
            st.tuples(st.just("dedup"), st.just(0)),
            st.tuples(st.just("reload"), st.just(0)),
        ),
        min_size=2,
        max_size=6,
    ),
    seed=st.integers(0, 2**16),
)
def test_sharded_crud_interleavings(tmp_path_factory, ops, seed):
    """Random CRUD interleavings on the sharded index (8 shards, every one
    on the CPU) keep the live set exact, as the JAX package's on its 8-way
    CPU mesh does, by insertion position."""
    from zebra_tpu.parallel.sharded import ShardedIndex as ZShardedIndex

    rng = np.random.default_rng(seed)
    dim = 12
    iopts = dict(seed=1, kmeans_iters=2, kmeans_balance_rounds=1)
    idx = ShardedIndex(dim=dim, metric="sql2", options=T.IndexOptions(**iopts), shards=8,
                       device="cpu")
    jdx = ZShardedIndex(dim=dim, metric="sql2", options=ZOptions(**iopts), shards=8)
    live: dict[bytes, np.ndarray] = {}
    twin = Twin()
    tag = 0
    tmp = tmp_path_factory.mktemp("sprop")
    for op, arg in ops:
        if op == "add":
            # tag-unique vectors, so dedup is a no-op
            vecs = np.zeros((arg, dim), np.float32)
            vecs[:, 0] = np.arange(tag, tag + arg)
            vecs[:, 1:] = rng.standard_normal((arg, dim - 1)).astype(np.float32)
            tag += arg
            ids = idx.add(vecs)
            twin.add(ids, jdx.add(vecs))
            live.update(zip(ids, vecs))
        elif op == "remove" and live:
            victims = list(live)[:arg]
            assert sorted(idx.remove(victims)) == sorted(victims)
            jv = twin.jax_of(victims)
            assert sorted(jdx.remove(jv)) == sorted(jv)
            for v in victims:
                live.pop(v)
        elif op == "dedup":
            assert idx.deduplicate() == [] and jdx.deduplicate() == []
        elif op == "reload":
            d = str(tmp / f"s{tag}")
            idx.save(d + "p")
            idx = ShardedIndex.load(d + "p", device="cpu")
            jdx.save(d + "j")
            jdx = ZShardedIndex.load(d + "j")
        assert len(idx) == len(live) == len(jdx)
        twin.same_live(idx, jdx)
    if live:
        items = list(live.items())[:16]
        q = np.stack([v for _, v in items])
        res = idx.search(q, k=1)
        for (i, _v), row in zip(items, res):
            assert row and row[0][0] == i
        twin.same_top1(res, jdx.search(q, k=1))
