"""The slab-major form of the LSH candidate re-rank, on the CPU.

The CUDA source (``zebra_tpu_torch/csrc/lsh_rerank_slab.cu``) runs on the
card only; what surrounds its arithmetic is reached here through
``lsh_rerank_slab_emulation``: query groups x slab chunks, 3xTF32 dots,
membership from the sorted candidate rows, per-chunk top-k by (distance,
slot), the merge and the position search. Inputs come from a numpy seed.

Tolerances: the emulation against the plain version, positions bitwise and
distances within 1e-6 absolute (unit-scale rows: a 3xTF32 dot is within
~1e-7 of the f32 one; l2 on its square); both against the Pallas kernel in interpret mode
within rtol = atol = 2e-3, the JAX tests' own tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zebra_tpu.ops.pallas_rerank as JPR
from zebra_tpu_torch.index import buckets as TB
from zebra_tpu_torch.ops import lsh_rerank as TR

S, OCCUPIED, D, B, M = 640, 512, 128, 6, 256
ZERO_ROW, TWIN_A, TWIN_B = 9, 20, 300


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, pads, width=D):
    """Sorted candidate rows over a slab whose rows 20 and 300 are equal and
    whose row 9 is zero. ``pads="head"``: rows sorted as a whole, -1 first,
    masked duplicates and dead rows in place (an uncompacted probe set);
    ``pads="tail"``: valid slots first, -1 after (a compacted one, with a
    masked duplicate kept before its valid twin). Query 0 holds nothing
    valid, query 1 three rows, the others ~100 with the equal pair."""
    rng = np.random.default_rng(seed)
    vectors = np.zeros((S, width), np.float32)
    vectors[:, :D] = rng.standard_normal((S, D)) / np.sqrt(D)
    vectors[ZERO_ROW] = 0.0
    vectors[TWIN_B] = vectors[TWIN_A]
    q = (rng.standard_normal((B, D)) / np.sqrt(D)).astype(np.float32)
    q[3] = vectors[TWIN_A, :D] + 0.01 * q[3]  # the equal pair leads query 3
    cand = np.full((B, M), -1, np.int32)
    valid = np.zeros((B, M), np.float32)
    for b in range(B):
        n = 3 if b == 1 else 100
        slots = rng.choice(OCCUPIED, n, replace=False)
        if b >= 2:
            slots = np.union1d(slots, [ZERO_ROW, TWIN_A, TWIN_B, 0, OCCUPIED - 1])
        slots = np.sort(slots)
        dead = rng.random(slots.size) < 0.1  # tombstoned rows
        dead[np.isin(slots, [ZERO_ROW, TWIN_A, TWIN_B])] = False
        dup = np.sort(rng.choice(slots, min(5, slots.size), replace=False))
        if pads == "head":  # the first of a run is the valid one, as buckets._candidates
            row = np.sort(np.concatenate([slots, dup]))
            ok = np.ones(row.size, bool)
            ok[1:] = row[1:] != row[:-1]
            ok &= ~np.isin(row, slots[dead])
            cand[b, M - row.size:] = row
            valid[b, M - row.size:] = ok
        else:  # a masked copy stands BEFORE the valid entry of one slot
            row = np.sort(np.concatenate([slots[~dead], dup[:1]]))
            ok = np.ones(row.size, bool)
            ok[:-1] = row[:-1] != row[1:]
            cand[b, : row.size] = row
            valid[b, : row.size] = ok
    valid[0] = 0.0
    norms = (vectors ** 2).sum(1)[np.clip(cand, 0, S - 1)].astype(np.float32)
    return vectors, q, cand, norms, valid


@pytest.mark.parametrize("tiling", [dict(), dict(query_group=4, tile_rows=32, n_sm=8)],
                         ids=["one-group", "groups-and-chunks"])
@pytest.mark.parametrize("pads", ["head", "tail"])
@pytest.mark.parametrize("k", [10, 128])
@pytest.mark.parametrize("metric", ["cosine", "l2", "sql2"])
def test_emulation_matches_plain_version(metric, k, pads, tiling):
    args = [_t(a) for a in _inputs(1, pads)]
    wd, wp = TR.lsh_rerank_reference(*args, metric=metric, k=k)
    gd, gp = TR.lsh_rerank_slab_emulation(*args, metric=metric, k=k, occupied=OCCUPIED, **tiling)
    assert torch.equal(gp, wp)
    found = wp >= 0
    # l2 is held on its square: query 3 sits 0.01 from the equal pair, where
    # the root turns a dot's 1e-7 into 5e-6
    p = 2 if metric == "l2" else 1
    np.testing.assert_allclose(gd[found].numpy() ** p, wd[found].numpy() ** p, rtol=0, atol=1e-6)
    assert torch.isinf(gd[~found]).all()
    # the cases the inputs were built to hold
    assert (wp[0] == -1).all() and int((wp[1] >= 0).sum()) == 3
    slots = torch.gather(args[2], 1, wp.clamp(min=0))
    assert slots[3, 0] == TWIN_A and slots[3, 1] == TWIN_B and wd[3, 0] == wd[3, 1]
    if k == 128:
        zero = (slots == ZERO_ROW) & found
        assert zero[2:].any(1).all()
        if metric == "cosine":
            assert (gd[zero] == 1.0).all()


def test_emulation_takes_a_bf16_slab():
    """bf16 rows are exact in TF32: their lo part is zero and two of the
    three passes carry the product."""
    vectors, q, cand, norms, valid = (_t(a) for a in _inputs(6, "head"))
    vectors = vectors.to(torch.bfloat16)
    assert not TR.split_tf32(vectors)[1].any()
    norms = (vectors.float() ** 2).sum(1)[cand.clamp(0, S - 1).long()]
    wd, wp = TR.lsh_rerank_reference(vectors, q, cand, norms, valid, k=10)
    gd, gp = TR.lsh_rerank_slab_emulation(vectors, q, cand, norms, valid, k=10,
                                          occupied=OCCUPIED, query_group=4, tile_rows=32, n_sm=8)
    assert torch.equal(gp, wp)
    np.testing.assert_allclose(gd.numpy(), wd.numpy(), rtol=0, atol=1e-6)


def test_emulation_reads_only_the_query_width_of_a_wider_slab():
    wide = [_t(a) for a in _inputs(2, "tail", width=256)]
    wide[0][:, D:] = 7.0  # columns past the query's width must not count
    wide[3] = (wide[0][:, :D] ** 2).sum(1)[wide[2].clamp(0, S - 1).long()]
    wd, wp = TR.lsh_rerank_reference(*wide, k=10)
    gd, gp = TR.lsh_rerank_slab_emulation(*wide, k=10, occupied=OCCUPIED, query_group=4,
                                          tile_rows=32, n_sm=8)
    assert torch.equal(gp, wp)
    np.testing.assert_allclose(gd.numpy(), wd.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("pads", ["head", "tail"])
@pytest.mark.parametrize("metric", ["cosine", "l2", "sql2"])
def test_emulation_matches_pallas_interpret(metric, pads):
    vectors, q, cand, norms, valid = _inputs(3, pads)
    wd, wp = JPR.pallas_rerank(jnp.asarray(vectors), jnp.asarray(q), jnp.asarray(cand),
                               jnp.asarray(norms), jnp.asarray(valid), metric=metric, k=10,
                               interpret=True)
    gd, gp = TR.lsh_rerank_slab_emulation(_t(vectors), _t(q), _t(cand), _t(norms), _t(valid),
                                          metric=metric, k=10, occupied=OCCUPIED,
                                          query_group=4, tile_rows=32, n_sm=8)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=2e-3, atol=2e-3)


def test_split_tf32_three_passes_reach_f32_and_one_pass_does_not():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((64, 768)).astype(np.float32)
    x = rng.standard_normal((256, 768)).astype(np.float32)
    (qh, ql), (xh, xl) = TR.split_tf32(_t(q)), TR.split_tf32(_t(x))
    for part in (qh, ql, xh, xl):  # TF32: the low 13 mantissa bits are clear
        assert not (part.view(torch.int32) & 0x1FFF).any()
    exact = q.astype(np.float64) @ x.astype(np.float64).T
    qh, ql, xh, xl = (p.double().numpy() for p in (qh, ql, xh, xl))
    bound = 2.0 ** -20 * np.linalg.norm(q, axis=1)[:, None] * np.linalg.norm(x, axis=1)[None, :]
    three = qh @ xh.T + qh @ xl.T + ql @ xh.T
    assert (np.abs(three - exact) <= bound).all()
    assert (np.abs(qh @ xh.T - exact) > bound).mean() > 0.5  # one pass is another result


@pytest.mark.parametrize("args,want", [
    ((True, torch.float32, 10, 312_320, 1_000_000), True),
    ((True, torch.float32, 128, 62_500, 1_000_000), True),   # M = occupied / 16
    ((True, torch.float32, 10, 62_499, 1_000_000), False),   # just under the share
    ((True, torch.float32, 10, 3000, 1_000_000), False),     # an uncompacted T*P*C
    ((False, torch.float32, 10, 312_320, 1_000_000), False),  # unsorted rows
    ((True, torch.bfloat16, 10, 312_320, 1_000_000), True),   # bf16 slab: two passes
    ((True, torch.int8, 10, 312_320, 1_000_000), False),
    ((True, torch.float32, 129, 312_320, 1_000_000), False),
    ((True, torch.float32, 10, 256, 0), False),              # nothing stored
    ((True, torch.float32, 10, 1, 16), True),
])
def test_dispatch_rule(args, want):
    assert TR.takes_slab_form(*args) is want


@pytest.mark.parametrize("B,occupied,n_sm", [(256, 1_000_000, 132), (1024, 1_000_000, 132),
                                             (1, 16, 132), (20_000, 999_900, 132),
                                             (300, 130, 132), (384, 2_097_152, 108)])
def test_slab_grid_covers_the_occupied_rows_and_fills_the_card_once(B, occupied, n_sm):
    chunks, per_chunk = TR.slab_grid(B, occupied, n_sm)
    ntiles = -(-occupied // TR.TILE_ROWS)
    groups = -(-B // TR.QUERY_GROUP)
    assert chunks * per_chunk >= ntiles > (chunks - 1) * per_chunk  # covered, none empty
    assert groups * chunks <= max(n_sm, groups)


@pytest.mark.parametrize("route", ["uncompacted", "lossless", "cut"])
def test_bucket_query_is_the_same_through_the_slab_decomposition(route, monkeypatch):
    """``buckets.query`` promises sorted rows (``sorted_slots=True``): routed
    through the slab decomposition its answers are those of the plain
    version, whichever way the candidates were compacted."""
    rng = np.random.default_rng(5)
    T, bits, dim, n = 4, 4, 32, 600
    planes = rng.standard_normal((T, bits, dim)).astype(np.float32)
    st = TB.empty_state(_t(planes), torch.zeros((T, bits)), 16, 1024)
    x = rng.standard_normal((n, dim)).astype(np.float32)
    TB.insert(st, _t(x))
    TB.delete_slots(st, torch.arange(0, n, 7))
    q = _t(x[rng.choice(n, 9, replace=False)] + 0.05 * rng.standard_normal((9, dim)).astype(np.float32))
    kw = dict(uncompacted={}, lossless={"lossless": True}, cut={"max_candidates": 40})[route]
    want = TB.query(st, q, 10, num_probes=4, rerank="cuda", occupied=n, **kw)
    seen = []

    def routed(vectors, q, cand, norms, valid, metric="cosine", k=10, sorted_slots=False,
               occupied=None):
        seen.append((sorted_slots, occupied))
        return TR.lsh_rerank_slab_emulation(vectors, q, cand, norms, valid, metric, k,
                                            occupied=occupied, query_group=4, tile_rows=32,
                                            n_sm=8)

    monkeypatch.setattr(TR, "lsh_rerank", routed)
    got = TB.query(st, q, 10, num_probes=4, rerank="cuda", occupied=n, **kw)
    assert seen == [(True, n)]
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    np.testing.assert_allclose(got[0][got[2]].numpy(), want[0][want[2]].numpy(), rtol=0, atol=1e-6)
    assert int(want[2].sum()) > 40
