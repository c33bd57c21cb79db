"""The cluster-major form's augmented-slab epilogue (kernel 3) and its f32
product (kernels 1 and 2 on f32 slabs), on the CPU: the plain-torch
decomposition of ``ops/ivf_cluster.py`` (work items, a product per item, the
scatter, the selection) against the per-query plain versions and against the
JAX package's Pallas kernels in interpret mode; the selection's sentinel and
ties; the route for the new slab types; and the wrappers on CPU tensors.

Tolerances, those of ``tests/test_torch_cluster_rerank.py``: integer outputs
and validity exact; where the decomposition sums a split product in another
order than the other side, positions agree on >= 0.97 of the results and
distances to rtol/atol 2e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zebra_tpu.ops.pallas_ivf as PI
from zebra_tpu.index import ivf as JV
from zebra_tpu.ops import experimental_ivf as PX
from zebra_tpu_torch.ops import experimental_ivf as TX
from zebra_tpu_torch.ops import ivf_cluster as IC
from zebra_tpu_torch.ops import ivf_rerank as TR
from zebra_tpu_torch.ops import lsh_rerank as LR

from test_torch_cluster_rerank import _close, _emulated, _random_state
from test_torch_experimental_ivf import _port_state, _state, _t
from test_torch_kernel_ref import interp_kernel  # noqa: F401  (fixture)

METRICS = ["cosine", "l2", "sql2"]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
K, C, D, B = 32, 16, 64, 24


def _aug_case(metric, dtype, seed=0):
    """An augmented slab of K blocks of C rows (JAX's ``augment_slab``: the
    same bytes on both sides) with a tenth of the rows tombstoned, cluster 0
    all dead, and in cluster 3 a row with a large dot against query 1 next to
    a dead row with a larger one; the queries and their probes: query 0 probes
    only cluster 0, the others probe the hot cluster 5 first and query 1
    probes cluster 3."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((K * C, D)).astype(np.float32)
    q = rng.standard_normal((B, D)).astype(np.float32)
    valid = rng.random(K * C) > 0.1
    valid[:C] = False
    v[3 * C + 4] = 40.0 * q[1]  # l2 / sql2: -2q.v ~ -80 |q|^2
    v[3 * C + 5] = 80.0 * q[1]
    valid[3 * C + 4], valid[3 * C + 5] = True, False
    vj = jnp.asarray(v).astype(JDT[dtype])
    norms = jnp.sum(vj.astype(jnp.float32) ** 2, axis=1)
    aug = PX.augment_slab(vj, norms, jnp.asarray(valid), metric)
    probes = rng.integers(1, K, (B, 4)).astype(np.int32)
    probes[0] = 0
    probes[1:, 0] = 5
    probes[1, 1] = 3
    return aug, q, probes


def _emulated_aug(aug, w, probes, k, exact, nq=IC.ITEM_QUERIES):
    round_q = not exact and aug.dtype == torch.bfloat16
    dist = IC.cluster_scores_emulation(IC.AugSlab(aug, C), w, probes, round_q=round_q, nq=nq)
    assert not bool(torch.isnan(dist).any()), "every entry of the buffer is written"
    return IC.select_reference(dist, probes, C, k, positions=True)


def _hold(got, want, overlap=0.97):
    (d, p), (rd, rp) = got, want
    v, rv = p >= 0, rp >= 0
    np.testing.assert_array_equal(v.numpy(), rv.numpy())
    assert bool(torch.isinf(d[~v]).all())
    assert float((p == rp).float().mean()) >= overlap
    np.testing.assert_allclose(d[v].numpy(), rd[rv].numpy(), rtol=2e-3, atol=2e-3)


# -- kernel 3: the aug epilogue ---------------------------------------------------


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_aug_emulation_matches_pallas_and_plain_version(dtype, metric, exact):
    aug, q, probes = _aug_case(metric, dtype)
    taug = _t(aug)
    w = TX.aug_query(torch.from_numpy(q), metric)
    for P in (2, 4):
        pr = torch.from_numpy(probes[:, :P]).long()
        for k in (10, P * C):
            got = _emulated_aug(taug, w, pr, k, exact)
            _hold(got, TX.rerank_aug_raw_reference(taug, C, w, pr, k, exact))
            assert not bool((got[1][0] >= 0).any())  # query 0: only dead rows
            assert not bool((got[1][1] == C + 5).any())  # the dead row: never
            if metric == "cosine":  # the large row, first (pos = p*C + r)
                assert int(got[1][1, 0]) == C + 4
            if k == P * C:  # every live row, the large one too
                assert bool((got[1][1] == C + 4).any())
            assert bool(torch.isfinite(got[0][got[1] >= 0]).all())
            # the Pallas kernel in interpret mode at k=10 (on an f32 slab
            # ``exact`` makes no difference: one of them)
            if P == 4 and k == 10 and (exact or dtype == "bfloat16"):
                jd, jp = PX.pallas_ivf_rerank_aug(aug, C, PX.aug_query(jnp.asarray(q), metric),
                                                  jnp.asarray(probes), k=k, exact=exact,
                                                  interpret=True)
                _hold(got, (_t(jd), _t(jp).long()))


@pytest.mark.parametrize("nq", [4, 8])
def test_aug_emulation_is_the_scoring_kernels_plain_version(nq):
    """The per-item buffer equals the per-pair one (``score_reference`` on an
    AugSlab): BIG on every dead row, the same dots elsewhere."""
    aug, q, probes = _aug_case("sql2", "float32", seed=1)
    taug = _t(aug)
    w = TX.aug_query(torch.from_numpy(q), "sql2")
    pr = torch.from_numpy(probes).long()
    a = IC.score_reference(IC.AugSlab(taug, C), w, pr)
    b = IC.cluster_scores_emulation(IC.AugSlab(taug, C), w, pr, nq=nq)
    dead = taug[:, D].float() >= TX.PEN
    rows = TR.probe_rows(pr, C)
    assert bool((a[dead[rows]] == TR.BIG).all()) and bool((b[dead[rows]] == TR.BIG).all())
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)


def test_aug_sentinel_survives_every_sum_order():
    """A dead row carries PEN in lane D and the query 1 there: in 3xTF32 on
    an f32 slab (hi*hi, hi*lo, lo*hi, lo cut to TF32) and in bf16 parts, each
    chunk's partial sums taken in any order, the dot stays >= BIG and finite
    beside a body dot of -1e30 .. 1e30."""
    pen = torch.tensor([TX.PEN])
    hi, lo = LR.split_tf32(pen)
    one_hi, one_lo = LR.split_tf32(torch.ones(1))
    assert float(hi) < 3.4028e38 and float(one_lo) == 0.0
    tail = [hi * one_hi, hi * one_lo, lo * one_hi]  # the aug chunk's three products
    bf = pen.to(torch.bfloat16).float()
    assert float(bf) >= TR.BIG
    for body in (-1e30, -1e6, 0.0, 1e6, 1e30):
        for parts in (tail, [bf]):
            for order in (parts, parts[::-1]):
                chunk = torch.zeros(1)
                for x in order:
                    chunk = chunk + x
                for total in (torch.tensor([body]) + chunk, chunk + torch.tensor([body])):
                    assert bool(torch.isfinite(total).all()) and float(total) >= TR.BIG


# -- kernels 1 and 2: the f32 product ------------------------------------------------


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("P", [2, 3])
def test_f32_emulation_matches_probe_rerank_plain_version(metric, P):
    st = _random_state(refine=False, dtype=torch.float32)
    g = torch.Generator().manual_seed(P)
    q = torch.randn(40, st.dim, generator=g)
    probes = torch.randint(0, st.num_clusters, (40, P), generator=g)
    probes[0] = 0  # nothing live
    probes[1:20, 0] = 7  # a hot cluster, split over items
    for k in (10, P * st.cluster_capacity):
        got = _emulated(st, q, probes, k, metric, round_q=False)
        _close(got, TR.ivf_rerank_reference(st, q, probes, k, metric), q, metric)
        _close(got, TX.ivf_rerank_wave_reference(st, q, probes, k, metric), q, metric)
        assert not bool(got[2][0].any())


@pytest.mark.parametrize("wave,metric", [(False, m) for m in METRICS] + [(True, "l2")])
def test_f32_emulation_matches_pallas(rng, interp_kernel, metric, wave):
    """Kernel 1's f32 form over the three metrics (and kernel 2's, which
    multiplies an f32 slab by the unrounded query in the same product, at
    one) against the Pallas kernels in interpret mode."""
    st, q = _state(rng, "float32", n=512, K=8, C=96, d=64)
    k = 40 if wave else 10
    probes = JV.select_probes(st, jnp.asarray(q), 4 if wave else 3, metric).astype(jnp.int32)
    if wave:
        jd, js, jv = PI.ivf_rerank(st, jnp.asarray(q), probes, k, metric=metric, wave=2)
    else:
        jd, js, jv = PI.ivf_rerank(st, jnp.asarray(q), probes, k, metric=metric,
                                   dots="highest", fetch="block")
    td, ts, tv = _emulated(_port_state(st), torch.from_numpy(q), _t(probes).long(), k,
                           metric, round_q=False, nq=8)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert np.mean(ts.numpy() == np.asarray(js)) >= 0.97
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=2e-3, atol=2e-3)


# -- the selection ----------------------------------------------------------------


def test_select_reference_maps_big_to_missing_and_orders_ties():
    big = TR.BIG
    dist = torch.tensor([[2.0, big, -1.0, 2.0, 3.1e38, -1.0, float("inf"), 2.0],
                         [big] * 8])
    probes = torch.tensor([[9, 4], [0, 1]])
    d, p = IC.select_reference(dist, probes, 4, 6, positions=True)
    assert d[0].tolist()[:5] == [-1.0, -1.0, 2.0, 2.0, 2.0]
    assert p[0].tolist() == [2, 5, 0, 3, 7, -1]  # ties by position; >= BIG missing
    assert bool(torch.isinf(d[0, 5])) and p[1].tolist() == [-1] * 6
    d, s = IC.select_reference(dist, probes, 4, 6)  # slots: probe * C + row
    assert s[0].tolist() == [9 * 4 + 2, 4 * 4 + 1, 9 * 4 + 0, 9 * 4 + 3, 4 * 4 + 3, -1]


# -- the route and the wrappers on the CPU ------------------------------------------------


def test_route_rule_for_f32_and_aug_slabs():
    for dtype in (torch.bfloat16, torch.float32):
        slab = IC.AugSlab(torch.zeros((0, 896), dtype=dtype), 128)
        B = -(-IC.MIN_PAIR_COLUMNS[("aug", dtype)] // (4 * 896))  # at the aug slab's threshold
        assert slab.takes_cluster_form(B, 4, 10, False)
        assert not slab.takes_cluster_form(B // 2, 4, 10, False)
        assert not IC.AugSlab(slab.vectors, 120).takes_cluster_form(B, 4, 10, False)  # C % 16
        assert not slab.takes_cluster_form(B, 17, 10, False)  # P*C > 2048
        assert not slab.takes_cluster_form(B, 4, 129, False)  # k
    assert IC.AugSlab(torch.zeros((0, 896), dtype=torch.bfloat16), 128).takes_cluster_form(
        10**6, 4, 10, True)
    int8 = IC.AugSlab(torch.zeros((0, 896), dtype=torch.int8), 128)
    assert not int8.takes_cluster_form(10**6, 4, 10, False)  # no int8 aug slab
    with pytest.raises(ValueError, match="f32 or bf16"):
        IC.score_aug(int8, torch.zeros((1, 896)), torch.zeros((1, 4), dtype=torch.int32), False)
    # f32 rows stage two TF32 parts of 4 bytes a column
    assert IC.query_parts_count(torch.float32, False) == IC.F32_PARTS == 2
    assert IC.query_bytes(768, torch.float32, 2) == 2 * (4 * 768 + 32)
    assert IC.fits_smem(896, torch.float32, 2) and not IC.fits_smem(8192, torch.float32, 2)
    assert IC.fits_cluster_form(4, 768, 128, torch.float32, 10)
    assert IC.AugSlab(torch.zeros(100, 32), 16).num_clusters == 7


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """With the route pinned to the cluster-major form, CPU tensors still
    take the plain versions and count no launch."""
    monkeypatch.setattr(IC, "MIN_PAIR_COLUMNS", {k: 0 for k in IC.MIN_PAIR_COLUMNS})
    aug, q, probes = _aug_case("l2", "float32")
    taug, qt, pr = _t(aug), torch.from_numpy(q), torch.from_numpy(probes).long()
    before, by_form = TX.LAUNCHES_AUG, dict(TX.LAUNCHES_AUG_BY_FORM)
    got = TX.ivf_rerank_aug(taug, C, qt, pr, 10, "l2")
    want = TX.ivf_rerank_aug_reference(taug, C, qt, pr, 10, "l2")
    assert TX.LAUNCHES_AUG == before and TX.LAUNCHES_AUG_BY_FORM == by_form
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    st = _random_state(refine=False, dtype=torch.float32)
    q = torch.randn(8, st.dim)
    p2 = torch.randint(0, st.num_clusters, (8, 2))
    before, wave = TR.LAUNCHES, TX.LAUNCHES_WAVE
    got = TR.ivf_rerank(st, q, p2, 10)
    assert all(torch.equal(a, b) for a, b in zip(got, TR.ivf_rerank_reference(st, q, p2, 10)))
    got = TX.ivf_rerank_wave(st, q, p2, 10)
    assert all(torch.equal(a, b) for a, b in
               zip(got, TX.ivf_rerank_wave_reference(st, q, p2, 10)))
    assert TR.LAUNCHES == before and TX.LAUNCHES_WAVE == wave
