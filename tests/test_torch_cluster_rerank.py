"""The cluster-major form of the IVF probe re-ranks (``ops/ivf_cluster.py``)
on the CPU: the work-item builder, the decomposition in plain torch (items,
a product per item, the scatter to ``[B, P*C]``, the selection) against the
per-query plain versions and, through them, against the JAX package's
Pallas kernels in interpret mode; the route between the two forms; and
probe selection's cached bf16 operands.

Tolerances. The emulation and the per-query plain version score the same
rows with the same f32-exact products (bf16 query parts against int8 codes
or bf16 values), summed in another order: slots are held equal and
distances to rtol/atol 1e-5 (scaled by ``|q|^2 + |x|^2`` for l2 / sql2,
whose rounding is relative to that sum). Against the Pallas kernels the
bounds of ``tests/test_pallas_ivf.py``: validity equal, slots on >= 0.97 of
positions, distances to rtol/atol 2e-3.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zebra_tpu.ops.pallas_ivf as PI
import zebra_tpu_torch as T
from zebra_tpu.index import ivf as JV
from zebra_tpu_torch.index import ivf as TV
from zebra_tpu_torch.ops import experimental_ivf as TX
from zebra_tpu_torch.ops import ivf_cluster as IC
from zebra_tpu_torch.ops import ivf_rerank as TR

from test_torch_experimental_ivf import _port_state, _state, _t
from test_torch_kernel_ref import interp_kernel  # noqa: F401  (fixture)

METRICS = ["cosine", "l2", "sql2"]


def _pairs(items):
    return sorted(p for _, ps in items for p in ps)


def _random_state(seed=0, K=40, C=32, D=64, G=64, dtype=torch.int8, refine=True):
    """A random state with ragged counts, tombstones, an all-tombstoned
    cluster (0) and an empty one (1)."""
    g = torch.Generator().manual_seed(seed)
    st = TV.empty_state(torch.randn(K, D, generator=g), C, G, dtype=torch.int8, refine=refine)
    S = K * C + G
    st.vectors.copy_(torch.randint(-127, 128, (S, D), generator=g, dtype=torch.int8))
    if refine:
        st.residual.copy_(torch.randint(-127, 128, (S, D), generator=g, dtype=torch.int8))
        st.rscales.copy_(st.scales / 127.0)
    st.scales.copy_(0.01 + 0.04 * torch.rand(S, generator=g))
    counts = torch.randint(0, C + 1, (K,), generator=g, dtype=torch.int32)
    counts[0], counts[1] = C, 0
    st.counts[:K] = counts
    row = torch.arange(K * C)
    live = (row % C) < counts.repeat_interleave(C)
    live &= torch.rand(K * C, generator=g) > 0.1
    live[:C] = False
    st.valid[: K * C] = live
    x = st.vectors.float() * st.scales[:, None]
    if refine:
        x = x + st.residual.float() * st.rscales[:, None]
    if dtype != torch.int8:
        st = dataclasses.replace(st, vectors=x.to(dtype), scales=None)
        x = st.vectors.float()
    st.norms.copy_((x * x).sum(-1))
    return st


def _close(got, want, q, metric):
    (d, s, v), (rd, rs, rv) = got, want
    assert torch.equal(v, rv) and torch.equal(s, rs)
    scale = 1.0 if metric == "cosine" else 2 * float((q * q).sum(-1).max())
    d, rd = d[v], rd[rv]
    if metric == "l2":
        d, rd = d * d, rd * rd
    torch.testing.assert_close(d, rd, rtol=1e-5, atol=1e-5 * scale)


def _emulated(st, q, probes, k, metric, round_q, scan_residual=True, nq=IC.ITEM_QUERIES):
    dist = IC.cluster_scores_emulation(st, q, probes, metric, round_q, scan_residual, nq)
    assert not bool(torch.isnan(dist).any()), "every entry of the buffer is written"
    d, s = IC.select_reference(dist, probes, st.cluster_capacity, k)
    return d, s, s >= 0


# -- the work-item builder ---------------------------------------------------------


@pytest.mark.parametrize("P", [1, 2, 3, 4])
@pytest.mark.parametrize("nq", [8, 16])
def test_work_items_cover_every_pair_once(P, nq):
    g = torch.Generator().manual_seed(P)
    B, K = 57, 23
    probes = torch.randint(0, K, (B, P), generator=g)
    order, cs, starts = IC.work_items(probes, K, nq)
    items = IC.items_on_host(order, cs, starts, P, nq)
    assert _pairs(items) == [(b, p) for b in range(B) for p in range(P)]
    n = B * P
    assert len(items) <= IC.item_grid(n, nq, K)
    assert starts.tolist() == sorted(starts.tolist())
    for c, pairs in items:
        assert 1 <= len(pairs) <= nq
        assert all(int(probes[b, p]) == c for b, p in pairs)
        assert pairs == sorted(pairs)  # the stable sort keeps pair order within a cluster
    # every item but the last of its cluster's run is full
    runs = {}
    for c, pairs in items:
        runs.setdefault(c, []).append(len(pairs))
    assert all(all(m == nq for m in sizes[:-1]) for sizes in runs.values())


def test_work_items_split_a_hot_cluster():
    B, P, nq = 100, 3, 16
    probes = torch.full((B, P), 5)
    probes[:, 1] = torch.arange(B) % 7 + 10
    items = IC.items_on_host(*IC.work_items(probes, 20, nq), P, nq)
    hot = [pairs for c, pairs in items if c == 5]
    assert [len(p) for p in hot] == [16] * 12 + [8]
    assert _pairs([(5, p) for p in hot]) == [(b, p) for b in range(B) for p in (0, 2)]


def test_work_items_of_an_empty_batch():
    order, cs, starts = IC.work_items(torch.zeros((0, 3), dtype=torch.int64), 16)
    assert order.numel() == cs.numel() == starts.numel() == 0
    st = _random_state()
    dist = IC.cluster_scores_emulation(st, torch.zeros((0, st.dim)),
                                       torch.zeros((0, 3), dtype=torch.int64))
    assert tuple(dist.shape) == (0, 3 * st.cluster_capacity)


def test_a_probe_repeated_within_a_query():
    """Both copies of a repeated probe are scored at their own positions;
    the selection keeps the lower position first, as the plain version."""
    st = _random_state()
    g = torch.Generator().manual_seed(3)
    q = torch.randn(12, st.dim, generator=g)
    probes = torch.randint(2, st.num_clusters, (12, 3), generator=g)
    probes[:, 2] = probes[:, 0]
    items = IC.items_on_host(*IC.work_items(probes, st.num_clusters, 4), 3, 4)
    assert _pairs(items) == [(b, p) for b in range(12) for p in range(3)]
    got = _emulated(st, q, probes, 10, "cosine", round_q=False, nq=4)
    want = TR.ivf_rerank_reference(st, q, probes, 10, "cosine")
    _close(got, want, q, "cosine")
    C = st.cluster_capacity
    dist = IC.cluster_scores_emulation(st, q, probes, "cosine", nq=4)
    assert torch.equal(dist[:, :C], dist[:, 2 * C :])


# -- the decomposition against the per-query plain versions --------------------------


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("form", ["int8+residual", "int8", "bf16"])
@pytest.mark.parametrize("P", [2, 3])
def test_emulation_matches_probe_rerank_plain_version(metric, form, P):
    st = _random_state(refine=form == "int8+residual",
                       dtype=torch.bfloat16 if form == "bf16" else torch.int8)
    g = torch.Generator().manual_seed(P)
    q = torch.randn(40, st.dim, generator=g)
    probes = torch.randint(0, st.num_clusters, (40, P), generator=g)
    probes[0] = 0  # nothing live
    probes[1:20, 0] = 7  # a hot cluster, split over items
    for k in (10, 128):
        got = _emulated(st, q, probes, k, metric, round_q=False)
        want = TR.ivf_rerank_reference(st, q, probes, k, metric)
        _close(got, want, q, metric)
        assert not bool(got[2][0].any())


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_emulation_matches_wave_plain_version(metric, dtype):
    st = _random_state(refine=False, dtype=dtype)
    g = torch.Generator().manual_seed(11)
    q = torch.randn(40, st.dim, generator=g)
    probes = torch.randint(0, st.num_clusters, (40, 3), generator=g)
    probes[:, 1] = 9  # every query probes one cluster
    for k in (10, 40):
        got = _emulated(st, q, probes, k, metric, round_q=True, nq=8)
        want = TX.ivf_rerank_wave_reference(st, q, probes, k, metric)
        _close(got, want, TX._wave_query(st, q), metric)


def test_query_parts_sum_to_the_query():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4096, generator=g) * 10.0 ** torch.randint(-3, 4, (4096,), generator=g)
    hi, mid, lo = IC.query_parts(x, round_q=False)
    for p in (hi, mid, lo):
        assert torch.equal(p, p.to(torch.bfloat16).float())
    assert torch.equal(hi + mid + lo, x)
    assert torch.equal(IC.query_parts(x, round_q=True)[0], hi)


@pytest.mark.parametrize("round_q", [False, True])
def test_query_digits_rebuild_the_query(round_q):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(64, 96, generator=g) * 10.0 ** torch.randint(-3, 4, (64, 1), generator=g)
    x[3] = 0.0
    digits, unit = IC.query_digits(x, round_q)
    assert len(digits) == IC.DIGITS
    for d in digits:
        assert torch.equal(d, d.round()) and float(d.abs().max()) <= 64
    xr = x.to(torch.bfloat16).float() if round_q else x
    amax = xr.abs().amax(-1, keepdim=True)
    assert bool(((amax / unit < 64) & (amax / unit >= 32) | (amax == 0)).all())
    back = sum(d * unit / 128.0 ** k for k, d in enumerate(digits))
    assert bool(((back - xr).abs() <= unit * 2.0 ** -22).all())
    if round_q:  # bf16 entries within 2^12 of the row's largest are exact
        big = xr.abs() >= amax * 2.0 ** -12
        assert torch.equal(back[big], xr[big])


def test_select_reference_orders_ties_by_position():
    C = 4
    dist = torch.tensor([[3.0, 1.0, float("inf"), 1.0, 2.0, 1.0, 0.5, 3.0e38],
                         [float("inf")] * 8])
    probes = torch.tensor([[5, 2], [0, 1]])
    d, s = IC.select_reference(dist, probes, C, 6)
    assert d[0].tolist() == [0.5, 1.0, 1.0, 1.0, 2.0, 3.0]
    assert s[0].tolist() == [2 * C + 2, 5 * C + 1, 5 * C + 3, 2 * C + 1, 2 * C + 0, 5 * C + 0]
    assert s[1].tolist() == [-1] * 6 and bool(torch.isinf(d[1]).all())
    d, s = IC.select_reference(dist, probes, C, 10)  # wider than P*C
    assert s.shape == (2, 10) and s[0].tolist()[6:] == [-1] * 4


# -- through the plain versions, to the JAX package's kernels -------------------------


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("kind", ["pair", "bfloat16"])
def test_emulation_matches_pallas_probe_rerank(rng, interp_kernel, metric, kind):
    st, q = _state(rng, kind, C=96)
    probes = JV.select_probes(st, jnp.asarray(q), 3, metric).astype(jnp.int32)
    jd, js, jv = PI.ivf_rerank(st, jnp.asarray(q), probes, 10, metric=metric,
                               dots="highest", fetch="block", scan_residual=True)
    td, ts, tv = _emulated(_port_state(st), torch.from_numpy(q), _t(probes).long(), 10,
                           metric, round_q=False, nq=8)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert np.mean(ts.numpy() == np.asarray(js)) >= 0.97
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("kind", ["int8", "bfloat16"])
def test_emulation_matches_pallas_wave(rng, interp_kernel, metric, kind):
    st, q = _state(rng, kind, C=96)
    probes = JV.select_probes(st, jnp.asarray(q), 4, metric).astype(jnp.int32)
    jd, js, jv = PI.ivf_rerank(st, jnp.asarray(q), probes, 40, metric=metric, wave=2)
    td, ts, tv = _emulated(_port_state(st), torch.from_numpy(q), _t(probes).long(), 40,
                           metric, round_q=True, nq=8)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert np.mean(ts.numpy() == np.asarray(js)) >= 0.97
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=2e-3, atol=2e-3)


# -- the route ------------------------------------------------------------------------


def test_route_rule():
    for dtype in (torch.int8, torch.bfloat16, torch.float32):
        B = -(-IC.MIN_PAIR_COLUMNS[dtype] // (4 * 768))  # at the slab type's threshold
        assert IC.takes_cluster_form(B, 4, 768, 128, dtype, 10)
        assert IC.takes_cluster_form(B, 4, 768, 128, dtype, 40, round_q=True)
        assert not IC.takes_cluster_form(B // 2, 4, 768, 128, dtype, 10)  # small batch
        assert not IC.takes_cluster_form(B, 4, 100, 128, dtype, 10)  # D % 16
        assert not IC.takes_cluster_form(B, 4, 768, 120, dtype, 10)  # C % 16
        assert not IC.takes_cluster_form(B, 17, 768, 128, dtype, 10)  # P*C > 2048
        assert not IC.takes_cluster_form(B, 4, 768, 128, dtype, 129)  # k
    # the bf16 form needs the larger batch
    assert IC.MIN_PAIR_COLUMNS[torch.bfloat16] > IC.MIN_PAIR_COLUMNS[torch.int8]
    # f32 slabs take the cluster-major form too (3xTF32), from their own threshold
    assert IC.takes_cluster_form(10**6, 4, 768, 128, torch.float32, 10)
    assert not IC.takes_cluster_form(10**6, 4, 768, 128, torch.float16, 10)  # no f16 form
    # a D whose staged query rows do not fit in shared memory
    assert IC.fits_smem(768, torch.int8, IC.DIGITS)
    assert IC.fits_smem(4096, torch.bfloat16, 1)
    assert not IC.fits_smem(8192, torch.bfloat16, 3)
    assert not IC.fits_cluster_form(4, 8192, 128, torch.bfloat16, 10)
    assert IC.fits_cluster_form(4, 8192, 128, torch.bfloat16, 10, round_q=True)
    # the padded width decides, not D itself
    assert IC.padded_dim(784) == 832 and IC.padded_dim(768) == 768
    assert IC.item_grid(100, 8, 5) == 17 and IC.item_grid(10, 8, 1000) == 10


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """CPU tensors take the plain version whatever the route says."""
    monkeypatch.setattr(IC, "MIN_PAIR_COLUMNS", {torch.int8: 0, torch.bfloat16: 0})
    st = _random_state()
    q = torch.randn(8, st.dim)
    probes = torch.randint(0, st.num_clusters, (8, 2))
    before, by_form = TR.LAUNCHES, dict(TR.LAUNCHES_BY_FORM)
    got = TR.ivf_rerank(st, q, probes, 10)
    want = TR.ivf_rerank_reference(st, q, probes, 10)
    assert TR.LAUNCHES == before and TR.LAUNCHES_BY_FORM == by_form
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_launch_counts_by_form():
    by_form = {}
    TR.count_launch(by_form, torch.int8, True, cluster=True)
    TR.count_launch(by_form, torch.int8, True, cluster=True)
    TR.count_launch(by_form, torch.bfloat16, False, cluster=False)
    assert by_form == {"int8+residual/cluster": 2, "bf16/query": 1}


def test_query_chunk_rows_count_the_distance_buffer():
    st = _random_state()
    assert (TV._query_chunk_rows(st, 10**9, 10, False, probes=4)
            < TV._query_chunk_rows(st, 10**9, 10, False))


# -- probe selection's cached operands ------------------------------------------------


def test_probe_operands_are_cached_and_follow_the_centroids():
    st = _random_state()
    cb, cn2 = TV.probe_operands(st)
    assert torch.equal(cb, st.centroids.to(torch.bfloat16))
    assert torch.equal(cn2, (st.centroids * st.centroids).sum(-1))
    again = TV.probe_operands(st)
    assert again[0] is cb and again[1] is cn2
    st.centroids = st.centroids * 2.0  # a new centroids tensor
    cb2, _ = TV.probe_operands(st)
    assert cb2 is not cb and torch.equal(cb2, st.centroids.to(torch.bfloat16))
    grown = TV.grow_spare(st)  # the same centroids: the cache rides along
    assert TV.probe_operands(grown)[0] is cb2


def _blobs(seed, n, d):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((24, d)).astype(np.float32)
    return centers[rng.integers(0, 24, n)] + 0.2 * rng.standard_normal((n, d)).astype(np.float32)


def test_probe_cache_renewed_by_cold_build_and_load(tmp_path):
    x = _blobs(5, 3000, 32)
    opts = T.IndexOptions(num_clusters=128, cluster_capacity=64)
    path = str(tmp_path / "c.zebra")
    db = T.Database.create(path, T.DatabaseConfig(dim=32, index=opts), device="cpu")
    db.insert_vectors(x)
    first = db.query(x[:20], 5)
    st = db.index.state
    assert st.probe_cache is not None and st.probe_cache[0] is st.centroids
    cached = st.probe_cache[1]
    db.save()
    again = T.Database.open(path, device="cpu")
    assert again.index.state.probe_cache is None
    assert again.query(x[:20], 5) == first
    st2 = again.index.state
    assert st2.probe_cache[0] is st2.centroids and st2.probe_cache[1] is not cached
    assert torch.equal(st2.probe_cache[1], st2.centroids.to(torch.bfloat16))
    # a new cold build trains new centroids: the next query recasts them
    again.clear_database()
    again.insert_vectors(x[::-1].copy())
    st3 = again.index.state
    assert st3 is not st2 and st3.probe_cache is None
    again.query(x[:5], 5)
    assert torch.equal(st3.probe_cache[1], st3.centroids.to(torch.bfloat16))


def _chip_smoke():
    """The repository root's ``chip_smoke`` module (its stage-1 witness)."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    return chip_smoke


def _crowded_query(metric, K=128, D=64, tries=200):
    """A unit query and K centroids whose exact nearest (returned) scores
    above four rivals by 2e-5 in cosine, while the bf16 rounding of the
    operands puts those four above it, strictly even after the scores' own
    rounding to bf16; the other centroids lie far. sql2 uses centroids of
    norm 0.02 at cosine 0.01, so that the scores sit near 0 where bf16 is
    fine. The first seed that gives such a case."""
    chip_smoke = _chip_smoke()
    for seed in range(tries):
        rng = np.random.default_rng(seed)
        q = rng.standard_normal(D)
        q /= np.linalg.norm(q)
        r, at = (1.0, 0.01) if metric == "cosine" else (0.02, 0.01)
        cos = np.full(K, -0.5)
        cos[:5] = at + 1e-5 * rng.standard_normal(5)
        cos[0] = cos[:5].max() + 2e-5
        u = rng.standard_normal((K, D))
        u -= np.outer(u @ q, q)
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        c = r * (cos[:, None] * q[None] + np.sqrt(1 - cos[:, None] ** 2) * u)
        perm = rng.permutation(K)
        q, c, own = q.astype(np.float32), c[perm].astype(np.float32), int(np.argsort(perm)[0])
        st = TV.empty_state(torch.from_numpy(c), 16, 64, dtype=torch.float32, refine=False)
        exact = TV.select_probes(st, torch.from_numpy(q[None]), 1, metric, probe_sel="f32")
        above, ref_above, _ = chip_smoke.stage1_witness(torch, st, torch.from_numpy(q), own,
                                                        metric)
        if int(exact[0, 0]) == own and above >= 4 and ref_above >= 4:
            return q, c, own, st
    raise AssertionError("no crowded query found")


@pytest.mark.parametrize("metric", ["cosine", "sql2"])
def test_stage_one_rounding_drops_the_nearest_cell_in_both_packages(metric):
    """Fault C's cause: a crowded query whose nearest centroid the bf16
    rounding of stage 1's operands puts below 2P = 4 others. ``chip_smoke``'s
    exact witness says so, and both packages' ``select_probes`` (P=2, two
    stages) leave that cell out; a query at a centroid keeps its own."""
    chip_smoke = _chip_smoke()
    q, c, own, st = _crowded_query(metric)
    jst = JV.empty_state(jnp.asarray(c), 16, 0, dtype=jnp.float32)
    jp = np.asarray(JV.select_probes(jst, jnp.asarray(q[None]), 2, metric))
    tp = TV.select_probes(st, torch.from_numpy(q[None]), 2, metric)
    assert own not in jp[0].tolist() and own not in tp[0].tolist()
    assert own not in TV.probe_candidates(st, torch.from_numpy(q[None]), 4, metric)[0].tolist()
    near = torch.from_numpy(c[own] / np.linalg.norm(c[own]))
    assert chip_smoke.stage1_witness(torch, st, near, own, metric)[0] < 4
    assert own in TV.select_probes(st, near[None], 2, metric)[0].tolist()


def test_select_probes_on_cpu_keeps_the_emulated_stage_one():
    """On the CPU stage 1 multiplies the bf16 operands in f32 and selects on
    the bf16 scores; the probes equal an exact-f32 top-P wherever the f32
    rescore sees them (stage 2 keeps the true top P of the 2P survivors)."""
    st = _random_state(K=256, C=16, D=64)
    g = torch.Generator().manual_seed(2)
    q = torch.randn(64, st.dim, generator=g)
    probes = TV.select_probes(st, q, 3, "cosine")
    exact = TV.select_probes(st, q, 3, "cosine", probe_sel="f32")
    assert probes.shape == (64, 3)
    assert float((probes.sort(1).values == exact.sort(1).values).float().mean()) >= 0.95


@pytest.mark.parametrize("round_q", [False, True])
def test_score_reference_is_the_emulated_buffer(round_q):
    """The scoring kernel's two plain versions, per pair and per item, give
    the same buffer: +inf on the same entries, the distances to the stated
    tolerance."""
    st = _random_state(refine=not round_q)
    g = torch.Generator().manual_seed(4)
    q = torch.randn(30, st.dim, generator=g)
    probes = torch.randint(0, st.num_clusters, (30, 3), generator=g)
    a = IC.score_reference(st, q, probes, "cosine", round_q, scan_residual=not round_q)
    b = IC.cluster_scores_emulation(st, q, probes, "cosine", round_q, not round_q)
    assert torch.equal(torch.isinf(a), torch.isinf(b))
    live = ~torch.isinf(a)
    torch.testing.assert_close(a[live], b[live], rtol=1e-5, atol=1e-5)
