"""Parity of the port's LSH bucket ops (``zebra_tpu_torch.index.buckets``)
and its plain re-rank (``ops.lsh_rerank.lsh_rerank_reference``) with the JAX
package's, on the CPU.

The bucket tests hash integer-valued rows against integer-valued planes with
half-integer offsets: every activation is exact in f32 and never zero, so
both packages compute the same codes bitwise and the tables must come out
exactly equal — reservoir overflow and duplicate scatter targets included.
Distances agree within rtol = atol = 2e-3, the JAX tests' own tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zebra_tpu.ops.pallas_rerank as JPR
from zebra_tpu.index import buckets as JB
from zebra_tpu.ops.distances import pairwise
from zebra_tpu_torch.index import buckets as TB
from zebra_tpu_torch.ops import lsh_rerank as TR

FIELDS = ("planes", "consts", "buckets", "counts", "vectors", "norms", "valid",
          "next_slot", "overflow")
T, BITS, DIM = 5, 6, 32


def _t(a):
    return torch.from_numpy(np.array(a))


def to_port(st) -> TB.LSHState:
    return TB.state_from_numpy({f: np.asarray(getattr(st, f)) for f in FIELDS})


def assert_state_equal(tst: TB.LSHState, jst):
    for f in FIELDS:
        np.testing.assert_array_equal(
            getattr(tst, f).float().numpy() if f == "vectors" else getattr(tst, f).numpy(),
            np.asarray(getattr(jst, f)).astype(np.float32) if f == "vectors"
            else np.asarray(getattr(jst, f)), err_msg=f)


def _int_rows(rng, n, d=DIM):
    return rng.integers(-4, 5, (n, d)).astype(np.float32)


def _states(rng, C=4, S=4096, dtype="float32"):
    planes = rng.integers(-3, 4, (T, BITS, DIM)).astype(np.float32)
    consts = (rng.integers(-6, 6, (T, BITS)) + 0.5).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jst = JB.empty_state(jnp.asarray(planes), jnp.asarray(consts), C, S, dtype=jdt)
    tst = TB.empty_state(_t(planes), _t(consts), C, S, dtype=tdt)
    return jst, tst


def _insert_both(jst, tst, x):
    jst, jslots = JB.insert(jst, jnp.asarray(x), jnp.int32(x.shape[0]))
    tslots = TB.insert(tst, _t(x))
    np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))
    return jst


def _built(rng, C=4, batches=(700, 900, 500, 64), dtype="float32"):
    jst, tst = _states(rng, C, dtype=dtype)
    for n in batches:
        jst = _insert_both(jst, tst, _int_rows(rng, n))
    return jst, tst


def test_mix32_matches_jax(rng):
    x = np.concatenate([rng.integers(-2**31, 2**31, 4096), [0, -1, 2**31 - 1, -2**31]])
    want = np.asarray(JB._mix32(jnp.asarray(x.astype(np.int32))))
    got = TB._mix32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("C", [2, 4, 64])  # 64: nothing overflows
def test_insert_batches_match_jax_exactly(rng, C):
    jst, tst = _built(rng, C)
    assert_state_equal(tst, jst)
    if C < 64:
        assert int(tst.overflow) > 0  # the reservoir path ran


def test_insert_bf16_slab_matches_jax(rng):
    jst, tst = _built(rng, 4, batches=(300, 300), dtype="bfloat16")
    assert tst.vectors.dtype == torch.bfloat16
    assert_state_equal(tst, jst)


def test_append_duplicate_targets_keep_the_last_entry():
    """Entries of one batch that overflow into the same (code, position)
    resolve as the JAX package's in-order scatter: the last one wins."""
    buckets = torch.full((1, 2, 2), -1, dtype=torch.int32)
    counts = torch.zeros((1, 2), dtype=torch.int32)
    n = 400
    codes = torch.zeros((n, 1), dtype=torch.int64)
    TB._append(buckets, counts, codes, torch.arange(n))
    jb, jc, _ = JB._append_one_table(jnp.full((2, 2), -1, jnp.int32), jnp.zeros(2, jnp.int32),
                                     jnp.zeros(n, jnp.int32), jnp.arange(n, dtype=jnp.int32),
                                     jnp.int32(1))
    np.testing.assert_array_equal(buckets[0].numpy(), np.asarray(jb))
    np.testing.assert_array_equal(counts[0].numpy(), np.asarray(jc))


def test_delete_slots_match_jax(rng):
    jst, tst = _built(rng)
    dead = np.array([-1, 0, 5, 5, 17, 2100, 3000, -7, 10**6], np.int32)
    jst = JB.delete_slots(jst, jnp.asarray(dead))
    TB.delete_slots(tst, _t(dead))
    assert_state_equal(tst, jst)
    assert TB.num_valid(tst) == int(JB.num_valid(jst))


@pytest.mark.parametrize("max_candidates", [0, 37, 100000])
@pytest.mark.parametrize("num_probes", [1, 4])
def test_candidates_match_jax(rng, max_candidates, num_probes):
    jst, tst = _built(rng, C=8)
    jst = JB.delete_slots(jst, jnp.asarray(np.arange(0, 2000, 3, dtype=np.int32)))
    TB.delete_slots(tst, _t(np.arange(0, 2000, 3)))
    q = _int_rows(rng, 24)
    jc, jv = JB._candidates(jst, jnp.asarray(q), num_probes, max_candidates)
    tc, tv = TB._candidates(tst, _t(q), num_probes, max_candidates)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_lossless_compaction_drops_no_candidate(rng):
    """``lossless`` cuts each row to the batch's widest live set rounded up
    to 1024: the JAX package's compaction at that width, holding every live
    candidate, so the query answers as the untruncated JAX query."""
    jst, tst = _built(rng, C=128)
    q = _int_rows(rng, 24)
    tc, tv = TB._candidates(tst, _t(q), 2, lossless=True)
    full_c, full_v = (np.asarray(a) for a in JB._candidates(jst, jnp.asarray(q), 2, 0))
    assert tc.shape[1] == 1024 < full_c.shape[1]
    jc, jv = JB._candidates(jst, jnp.asarray(q), 2, 1024)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for b in range(len(q)):
        assert sorted(tc[b][tv[b]].tolist()) == sorted(full_c[b][full_v[b]].tolist())
    want = JB.query(jst, jnp.asarray(q), 10, num_probes=2, rerank="xla")
    for route in ("eager", "cuda"):
        _assert_query_equal(TB.query(tst, _t(q), 10, num_probes=2, rerank=route,
                                     lossless=True), want)


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = JPR.pallas_rerank
    monkeypatch.setattr(JPR, "pallas_rerank", lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


def _assert_query_equal(got, want):
    (gd, gs, gv), (wd, ws, wv) = got, want
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("metric", ["cosine", "l2", "sql2"])
def test_query_eager_matches_jax_xla(rng, metric):
    jst, tst = _built(rng, C=8)
    q = _int_rows(rng, 16) + 0.25
    for k, mc in ((10, 0), (3, 40), (300, 0)):  # k wider than a candidate chunk too
        want = JB.query(jst, jnp.asarray(q), k, metric=metric, num_probes=4, rerank="xla",
                        max_candidates=mc)
        got = TB.query(tst, _t(q), k, metric=metric, num_probes=4, rerank="eager",
                       max_candidates=mc)
        _assert_query_equal(got, want)


@pytest.mark.parametrize("metric", ["cosine", "sql2"])
def test_query_kernel_route_matches_jax_pallas(rng, metric, interpret_pallas):
    """``rerank="cuda"`` on CPU tensors runs the kernel's plain version; it
    must match the JAX package's Pallas route (interpret mode)."""
    jst, tst = _built(rng, C=8, batches=(400, 300))
    q = _int_rows(rng, 6) + 0.25
    want = JB.query(jst, jnp.asarray(q), 7, metric=metric, num_probes=3, rerank="pallas")
    launches = TR.LAUNCHES
    got = TB.query(tst, _t(q), 7, metric=metric, num_probes=3, rerank="cuda")
    assert TR.LAUNCHES == launches  # CPU tensors never launch the kernel
    _assert_query_equal(got, want)


def test_query_splits_large_batches_without_changing_results(rng, monkeypatch):
    jst, tst = _built(rng, C=8)
    q = _t(_int_rows(rng, 50) + 0.25)
    whole = TB.query(tst, q, 5, num_probes=4)
    monkeypatch.setattr(TB, "_query_chunk_rows", lambda *a, **kw: 7)
    for route in ("eager", "cuda"):
        parts = TB.query(tst, q, 5, num_probes=4, rerank=route)
        for a, b in zip(parts, whole):
            assert torch.equal(a, b) if a.dtype != torch.float32 else torch.allclose(a, b)


def test_brute_force_matches_jax(rng):
    jst, tst = _built(rng, C=8)
    q = _int_rows(rng, 12) + 0.1
    want = JB.brute_force(jst, jnp.asarray(q), 10)
    _assert_query_equal(TB.brute_force(tst, _t(q), 10), want)


# -- the plain re-rank against the Pallas kernel (interpret mode), on the
#    shapes of tests/test_pallas_rerank.py ------------------------------------

S, D, B, C, K = 512, 128, 4, 256, 5


def _rerank_inputs(rng, width=D):
    vectors = np.zeros((S, width), np.float32)
    vectors[:, :D] = rng.standard_normal((S, D))
    q = rng.standard_normal((B, D)).astype(np.float32)
    cand = rng.integers(0, S, (B, C)).astype(np.int32)
    cand[0, :10] = -1
    for b in range(B):  # dedup within rows so ties are unambiguous
        _, first = np.unique(cand[b], return_index=True)
        mask = np.zeros(C, bool)
        mask[first] = True
        cand[b, ~mask] = -1
    norms = (vectors ** 2).sum(1)[np.clip(cand, 0, S - 1)].astype(np.float32)
    valid = (cand >= 0).astype(np.float32)
    return vectors, q, cand, norms, valid


@pytest.mark.parametrize("metric", ["cosine", "sql2", "l2"])
def test_reference_matches_pallas_interpret(rng, metric):
    vectors, q, cand, norms, valid = _rerank_inputs(rng)
    wd, wp = JPR.pallas_rerank(jnp.asarray(vectors), jnp.asarray(q), jnp.asarray(cand),
                               jnp.asarray(norms), jnp.asarray(valid), metric=metric, k=K,
                               interpret=True)
    gd, gp = TR.lsh_rerank(_t(vectors), _t(q), _t(cand), _t(norms), _t(valid), metric, K)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=2e-3, atol=2e-3)
    for b in range(B):  # and the brute-force oracle of test_pallas_rerank.py
        dist = np.array(pairwise(q[b : b + 1], vectors[np.clip(cand[b], 0, S - 1)],
                                 metric=metric))[0]
        dist[valid[b] == 0] = np.inf
        assert set(gp[b].tolist()) == set(np.argsort(dist)[:K].tolist())


def test_reference_reads_only_the_query_width_of_a_wider_slab(rng):
    """A slab stored 256 wide (zero pad columns) with 128-wide queries gives
    Pallas's answer over the padded queries."""
    vectors, q, cand, norms, valid = _rerank_inputs(rng, width=256)
    qpad = np.zeros((B, 256), np.float32)
    qpad[:, :D] = q
    wd, wp = JPR.pallas_rerank(jnp.asarray(vectors), jnp.asarray(qpad), jnp.asarray(cand),
                               jnp.asarray(norms), jnp.asarray(valid), k=K, interpret=True)
    gd, gp = TR.lsh_rerank_reference(_t(vectors), _t(q), _t(cand), _t(norms), _t(valid), k=K)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=2e-3, atol=2e-3)


def test_reference_underfull_and_zero_norm(rng):
    vectors = rng.standard_normal((S, D)).astype(np.float32)
    vectors[9] = 0.0  # zero-norm row: cosine distance 1
    q = rng.standard_normal((2, D)).astype(np.float32)
    cand = np.full((2, 256), -1, np.int32)
    cand[0, :3] = [5, 9, 100]
    norms = (vectors ** 2).sum(1)[np.clip(cand, 0, S - 1)].astype(np.float32)
    valid = (cand >= 0).astype(np.float32)
    wd, wp = JPR.pallas_rerank(jnp.asarray(vectors), jnp.asarray(q), jnp.asarray(cand),
                               jnp.asarray(norms), jnp.asarray(valid), k=K, interpret=True)
    gd, gp = TR.lsh_rerank_reference(_t(vectors), _t(q), _t(cand), _t(norms), _t(valid), k=K)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=2e-3, atol=2e-3)
    assert (gp[0, 3:] == -1).all() and (gp[1] == -1).all() and torch.isinf(gd[1]).all()
    assert 1.0 in gd[0, :3].tolist()


def test_reference_takes_fewer_candidates_than_k(rng):
    vectors, q, cand, norms, valid = _rerank_inputs(rng)
    gd, gp = TR.lsh_rerank_reference(_t(vectors), _t(q), _t(cand[:, :3]), _t(norms[:, :3]),
                                     _t(valid[:, :3]), k=8)
    assert gp.shape == (B, 8) and (gp[:, 3:] == -1).all() and torch.isinf(gd[:, 3:]).all()
