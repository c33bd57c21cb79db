"""Parity of the port's IVF device ops (``zebra_tpu_torch.index.ivf``) with
the JAX package's, on the CPU, on states carried over from JAX.

Placement and stored state must be bitwise equal (``norms`` to rtol 1e-6:
the same f32 squares, summed in another order); query slots equal, distances
to rtol 1e-5. The tiers without a residual (bf16, f32, plain int8; rows on
the array wire, cast or quantised by ``ivf.insert``) are held to the same
state bounds; their queries to equal slots or, where a slot differs, an
f64-verified tie, and distances to rtol/atol 2e-3. The gather-refine query (``refine_k``) is held to the same
bounds on the eager route; on the wave route (``rerank="pallas2"`` in
interpret mode against the port's ``"cuda2"`` through the wave plain
version) slots agree on >= 0.97 of positions and distances to 1e-4 of the
``|q|^2 + |x|^2`` scale: both sides invert a coarse distance built from f32
sums taken in another order, and a swapped near-tie among the 40 kept
candidates can change the tail of the top 10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zebra_tpu.config import IndexOptions as JOptions
from zebra_tpu.index import ivf as JV
from zebra_tpu.index.ivf_host import IVFIndex as JIndex
from zebra_tpu_torch.config import IndexOptions as TOptions
from zebra_tpu_torch.index import ivf as TV
from zebra_tpu_torch.index.ivf_host import IVFIndex as TIndex
from zebra_tpu_torch.ops import ivf_rerank as TR

from test_torch_kernel_ref import interp_kernel  # noqa: F401  (fixture)

FIELDS = ("centroids", "counts", "vectors", "norms", "valid", "overflow", "scales",
          "residual", "rscales")


def to_port(st) -> TV.IVFState:
    arrays = {f: np.asarray(getattr(st, f)) for f in FIELDS if getattr(st, f) is not None}
    arrays["ccap"] = st.ccap
    return TV.state_from_numpy(arrays)


def _host(a) -> np.ndarray:
    """A state member (torch or JAX) as numpy, bf16 widened to f32."""
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def assert_state_equal(tst: TV.IVFState, jst):
    assert tst.vectors.element_size() == np.asarray(jst.vectors).dtype.itemsize
    for f in ("counts", "vectors", "residual", "scales", "rscales", "valid", "overflow"):
        t, j = getattr(tst, f), getattr(jst, f)
        assert (t is None) == (j is None), f
        if t is not None:
            np.testing.assert_array_equal(_host(t), _host(j), err_msg=f)
    np.testing.assert_allclose(tst.norms.numpy(), np.asarray(jst.norms), rtol=1e-6)


def assert_dists_close(metric, got, want, q):
    """cosine: rtol 1e-5. l2 / sql2 are |q|^2 + |x|^2 - 2<q,x>: f32 rounding
    of those terms (another summation order) is ~1e-5 of |q|^2 + |x|^2, not
    of the small difference, so compare squared distances to that scale."""
    got, want = np.asarray(got), np.asarray(want)
    if metric == "cosine":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        return
    if metric == "l2":
        got, want = got * got, want * want
    scale = 2 * float((np.asarray(q) ** 2).sum(-1).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


def _blobs(rng, n, d=128, centers=24, spread=0.3):
    c = rng.standard_normal((centers, d)).astype(np.float32)
    return c[rng.integers(0, centers, n)] + spread * rng.standard_normal((n, d)).astype(np.float32)


#: the tiers without a residual: (JAX slab type, torch slab type, wire type)
PLAIN = {"bf16": (jnp.bfloat16, torch.bfloat16, torch.bfloat16),
         "f32": (jnp.float32, torch.float32, torch.float32),
         "int8": (jnp.int8, torch.int8, torch.bfloat16)}


def _plain_insert(jst, tst, x, tier, spill=8, metric="cosine"):
    """The same rows through both packages' ``ivf.insert``, as the array wire
    delivers them (bf16-rounded for the bf16 and plain int8 tiers)."""
    wire = PLAIN[tier][2]
    xt = torch.from_numpy(x).to(wire)
    xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16 if wire == torch.bfloat16
                                                  else jnp.float32)
    jst, jslots = JV.insert(jst, xj, jnp.int32(x.shape[0]), spill=spill, metric=metric)
    return jst, np.asarray(jslots), TV.insert(tst, xt, spill=spill, metric=metric).numpy()


def _built_plain(rng, tier, K=16, C=32, G=256, n=900, d=128, tomb=60):
    """A JAX state of a tier without a residual, after two inserts that spill,
    use the spare and drop rows; plus tombstones. Returns (jax_state, data)."""
    x = _blobs(rng, n, d)
    cents = x[rng.choice(n, K, replace=False)] + 0.01
    jst = JV.empty_state(jnp.asarray(cents), C, G, dtype=PLAIN[tier][0])
    tst = to_port(jst)
    slots = []
    for part in (x[: n // 2], x[n // 2 :]):
        jst, js, _ = _plain_insert(jst, tst, part, tier)
        slots.append(js)
    live = np.concatenate(slots)
    live = live[live >= 0]
    jst = JV.delete_slots(jst, jnp.asarray(live[:tomb].astype(np.int32)))
    return jst, x


def _jax_insert(st, x, spill=8, metric="cosine"):
    v8, r8, sc, rs = JV.quantise_pair_host(x)
    qs = np.stack([sc, rs], axis=1)
    st, slots = JV.insert_quant(st, jnp.asarray(v8), jnp.asarray(r8), jnp.asarray(qs),
                                jnp.int32(x.shape[0]), spill=spill, metric=metric)
    return st, np.asarray(slots), (v8, r8, qs)


def _port_insert(st, parts, spill=8, metric="cosine"):
    v8, r8, qs = (torch.from_numpy(np.ascontiguousarray(a)) for a in parts)
    return TV.insert_quant(st, v8, r8, qs, spill=spill, metric=metric).numpy()


def _built(rng, K=16, C=32, G=256, n=900, d=128, metric="cosine", tomb=60):
    """A JAX state (int8 + residual) after two inserts that spill, use the
    spare and drop rows; plus tombstones. Returns (jax_state, data, slots)."""
    x = _blobs(rng, n, d)
    cents = x[rng.choice(n, K, replace=False)] + 0.01
    st = JV.empty_state(jnp.asarray(cents), C, G, dtype=jnp.int8, refine=True)
    st, s1, _ = _jax_insert(st, x[: n // 2], metric=metric)
    st, s2, _ = _jax_insert(st, x[n // 2 :], metric=metric)
    slots = np.concatenate([s1, s2])
    live = slots[slots >= 0]
    st = JV.delete_slots(st, jnp.asarray(live[:tomb].astype(np.int32)))
    return st, x, slots


def test_segmented_ranks_match_jax(rng):
    c = rng.integers(0, 7, 300).astype(np.int32)
    c[::11] = 2**30  # OOB rows, as placement marks them
    want = np.asarray(JV._segmented_ranks(jnp.asarray(c)))
    got = TV._segmented_ranks(torch.from_numpy(c).long()).numpy()
    np.testing.assert_array_equal(got, want)


def test_jitter_hash_matches_jax_bit_for_bit():
    """int32 wrap-around, logical shift and lax.rem (torch.fmod) of the
    placement jitter, at indices where the products overflow."""
    import jax

    n = 70000
    h = jnp.arange(n, dtype=jnp.int32) * jnp.int32(-1640531527)
    h = jnp.bitwise_xor(h, jax.lax.shift_right_logical(h, 16)) * jnp.int32(-2048144789)
    for A in (2, 3, 8):
        want = np.asarray(jax.lax.rem(jnp.abs(h), jnp.int32(max(min(2, A - 1), 1))))
        np.testing.assert_array_equal(TV._jitter(n, A, "cpu").numpy(), want)


def test_quantise_pair_host_matches_jax_bitwise(rng):
    x = rng.standard_normal((1000, 96)).astype(np.float32) * 3
    x[5] = 0.0  # all-zero row: scale 1
    for a, b in zip(TV.quantise_pair_host(x, span=256), JV.quantise_pair_host(x)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("metric", ["cosine", "sql2"])
def test_insert_quant_matches_jax(rng, metric):
    """Spill, spare and drops included: K*C + G = 768 rows for 900 inserts."""
    x = _blobs(rng, 900)
    cents = x[rng.choice(900, 16, replace=False)] + 0.01
    jst = JV.empty_state(jnp.asarray(cents), 32, 256, dtype=jnp.int8, refine=True)
    tst = to_port(jst)
    for part in (x[:450], x[450:]):
        jst, jslots, parts = _jax_insert(jst, part, metric=metric)
        tslots = _port_insert(tst, parts, metric=metric)
        np.testing.assert_array_equal(tslots, jslots)
    assert int(jst.overflow) > 0 and int(jst.counts[-1]) == 256
    assert_state_equal(tst, jst)


@pytest.mark.parametrize("tier", list(PLAIN))
@pytest.mark.parametrize("metric", ["cosine", "sql2"])
def test_insert_matches_jax(rng, metric, tier):
    """``ivf.insert`` on the tiers without a residual, on the same injected
    centroids: slots, counts, the stored rows or codes and scales exactly,
    norms of the stored values to rtol 1e-6. Spill, spare and drops
    included (K*C + G = 768 rows for 900 inserts). Under sql2 one row is
    all zero (scale 1 on int8); under cosine such a row ties with every cell,
    and the two packages' top-k break that tie differently."""
    x = _blobs(rng, 900)
    if metric == "sql2":
        x[7] = 0.0
    cents = x[rng.choice(900, 16, replace=False)] + 0.01
    jst = JV.empty_state(jnp.asarray(cents), 32, 256, dtype=PLAIN[tier][0])
    tst = to_port(jst)
    assert tst.vectors.dtype == PLAIN[tier][1] and tst.residual is None
    slots = []
    for part in (x[:450], x[450:]):
        jst, jslots, tslots = _plain_insert(jst, tst, part, tier, metric=metric)
        np.testing.assert_array_equal(tslots, jslots)
        slots.append(tslots)
    assert int(jst.overflow) > 0 and int(jst.counts[-1]) == 256
    assert_state_equal(tst, jst)
    if metric == "sql2":
        zero = int(slots[0][7])
        assert zero >= 0 and not bool(tst.vectors[zero].any()) and float(tst.norms[zero]) == 0
        assert tst.scales is None or float(tst.scales[zero]) == 1.0


def test_grow_spare_and_delete_match_jax(rng):
    jst, _, slots = _built(rng)
    tst = to_port(jst)
    jst = JV.grow_spare(jst)
    tst = TV.grow_spare(tst)
    dead = slots[slots >= 0][100:140].astype(np.int32)
    jst = JV.delete_slots(jst, jnp.asarray(np.concatenate([dead, [-1, -1]])))
    TV.delete_slots(tst, torch.from_numpy(np.concatenate([dead, [-1, -1]])))
    assert tst.spare_capacity == jst.spare_capacity == 256 + 1024
    assert_state_equal(tst, jst)


@pytest.mark.parametrize("K,P", [(16, 3), (128, 4)])
def test_select_probes_matches_jax(rng, K, P):
    """K=16: one f32 scoring pass; K=128: the two-stage bf16 + f32 path."""
    x = _blobs(rng, 2048, centers=40)
    cents = x[rng.choice(2048, K, replace=False)] + 0.01
    jst = JV.empty_state(jnp.asarray(cents), 32, 0, dtype=jnp.int8, refine=True)
    q = x[:64] + 0.05 * rng.standard_normal((64, 128)).astype(np.float32)
    for metric in ("cosine", "sql2"):
        want = np.asarray(JV.select_probes(jst, jnp.asarray(q), P, metric))
        got = TV.select_probes(to_port(jst), torch.from_numpy(q), P, metric).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("metric", ["cosine", "l2", "sql2"])
@pytest.mark.parametrize("k", [10, 40])  # 40 > C: per-probe selection narrower than k
def test_eager_query_matches_jax(rng, metric, k):
    jst, x, _ = _built(rng, metric="cosine")
    tst = to_port(jst)
    q = x[::30] + 0.05 * rng.standard_normal((30, 128)).astype(np.float32)
    jd, js, jv = JV.query(jst, jnp.asarray(q), k, metric=metric, num_probes=3,
                          rerank="xla", refine_scan=True)
    td, ts, tv = TV.query(tst, torch.from_numpy(q), k, metric=metric, num_probes=3,
                          rerank="eager", refine_scan=True)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert_dists_close(metric, td.numpy(), jd, q)


def assert_slots_or_ties(metric, got, want, tst, q, tol=1e-5):
    """Equal slots, or at each differing rank two picks whose distances to
    the query, recomputed in f64 from the stored values, are within ``tol``
    of the metric's scale (1 for cosine, |q|^2 + |x|^2 for l2 / sql2, both
    compared squared): a near-tie ranked by f32 sums taken in another order."""
    got, want = np.asarray(got), np.asarray(want)
    b, r = np.nonzero(got != want)
    if not len(b):
        return
    x = tst.vectors.double()
    if tst.scales is not None:
        x = x * tst.scales.double()[:, None]
    q64 = torch.from_numpy(np.asarray(q, np.float64))

    def d64(slots):
        v, qq = x[torch.from_numpy(slots)], q64[torch.from_numpy(b)]
        dot, n2, qn2 = (v * qq).sum(-1), (v * v).sum(-1), (qq * qq).sum(-1)
        if metric == "cosine":
            return (1.0 - dot / torch.sqrt(torch.clamp(qn2 * n2, min=1e-30))).numpy(), 1.0
        return torch.clamp(qn2 + n2 - 2.0 * dot, min=0.0).numpy(), (qn2 + n2).numpy()

    (dg, scale), (dw, _) = d64(got[b, r]), d64(want[b, r])
    assert (np.abs(dg - dw) <= tol * scale).all(), f"{len(b)} differing ranks are not ties"


@pytest.mark.parametrize("tier", list(PLAIN))
@pytest.mark.parametrize("metric", ["cosine", "l2", "sql2"])
@pytest.mark.parametrize("k", [10, 128])  # 128 > C: per-probe selection narrower than k
def test_plain_tier_query_matches_jax(rng, k, metric, tier):
    """The tiers without a residual at P=4, the spare in use: the eager
    route, and the probe kernel's route (its plain version on the CPU),
    against the JAX package's XLA branch; and the exact scan
    (``brute_force``, norms from the stored values) against its twin."""
    jst, x = _built_plain(rng, tier)
    assert int(jst.counts[-1]) > 0
    tst = to_port(jst)
    q = x[::30] + 0.05 * rng.standard_normal((30, 128)).astype(np.float32)
    jd, js, jv = JV.query(jst, jnp.asarray(q), k, metric=metric, num_probes=4, rerank="xla")
    for rerank in ("eager", "cuda"):
        td, ts, tv = TV.query(tst, torch.from_numpy(q), k, metric=metric, num_probes=4,
                              rerank=rerank)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert_slots_or_ties(metric, ts.numpy(), js, tst, q)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=2e-3, atol=2e-3)
    jd, js, _ = JV.brute_force(jst, jnp.asarray(q), k, metric=metric)
    td, ts, _ = TV.brute_force(tst, torch.from_numpy(q), k, metric=metric)
    assert_slots_or_ties(metric, ts.numpy(), js, tst, q)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=2e-3, atol=2e-3)


def test_cuda_rerank_route_on_cpu_matches_eager(rng):
    """rerank="cuda" with CPU tensors takes the kernel's plain version; it
    must give the eager path's answer (the spare merge included)."""
    jst, x, _ = _built(rng)
    tst = to_port(jst)
    q = torch.from_numpy(x[::40] + 0.05 * rng.standard_normal((23, 128)).astype(np.float32))
    before = TR.LAUNCHES
    a = TV.query(tst, q, 10, num_probes=3, rerank="cuda", refine_scan=True)
    b = TV.query(tst, q, 10, num_probes=3, rerank="eager", refine_scan=True)
    assert TR.LAUNCHES == before  # no kernel runs for CPU tensors
    np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())
    np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), rtol=1e-5, atol=1e-6)


def test_large_k_takes_the_counted_eager_path(rng):
    jst, x, _ = _built(rng)
    tst = to_port(jst)
    q = torch.from_numpy(x[:4])
    before = TV.EAGER_LARGE_K
    d, s, v = TV.query(tst, q, 130, num_probes=16, rerank="cuda", refine_scan=True)
    assert TV.EAGER_LARGE_K == before + 1 and d.shape == (4, 130)


def test_query_batches_in_chunks(rng, monkeypatch):
    jst, x, _ = _built(rng)
    tst = to_port(jst)
    q = torch.from_numpy(x[:50])
    whole = TV.query(tst, q, 10, num_probes=3, refine_scan=True)
    monkeypatch.setattr(TV, "_query_chunk_rows", lambda *a, **k: 16)
    parts = TV.query(tst, q, 10, num_probes=3, refine_scan=True)
    np.testing.assert_array_equal(whole[1].numpy(), parts[1].numpy())
    np.testing.assert_allclose(whole[0].numpy(), parts[0].numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("metric", ["cosine", "sql2"])
def test_brute_force_matches_jax(rng, metric):
    jst, x, _ = _built(rng)
    q = x[:16] + 0.1
    jd, js, jv = JV.brute_force(jst, jnp.asarray(q), 10, metric=metric)
    td, ts, tv = TV.brute_force(to_port(jst), torch.from_numpy(q), 10, metric=metric)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert_dists_close(metric, td.numpy(), jd, q)


def _refine_k(k):
    return TOptions(refine=4).refine_k(k)


@pytest.mark.parametrize("metric", ["cosine", "l2", "sql2"])
@pytest.mark.parametrize("k", [10, 40])  # refine_k 40, and 160 (wider than a kernel's 128)
def test_refine_query_matches_jax(rng, metric, k):
    """Oversampled coarse scan, spare merge at the oversampled width (the
    spare is full here), then the gather-refine pass — the eager route
    against the JAX package's XLA branch."""
    jst, x, _ = _built(rng, metric="cosine")
    assert int(jst.counts[-1]) > 0
    tst = to_port(jst)
    q = x[::30] + 0.05 * rng.standard_normal((30, 128)).astype(np.float32)
    rk = _refine_k(k)
    jd, js, jv = JV.query(jst, jnp.asarray(q), k, metric=metric, num_probes=3,
                          rerank="xla", refine_k=rk)
    td, ts, tv = TV.query(tst, torch.from_numpy(q), k, metric=metric, num_probes=3,
                          rerank="eager", refine_k=rk)
    assert td.shape == (30, k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert_dists_close(metric, td.numpy(), jd, q)


@pytest.mark.parametrize("metric", ["cosine", "l2", "sql2"])
def test_refine_topk_matches_jax(rng, metric):
    """The refine pass alone, fed the same oversampled candidates."""
    jst, x, _ = _built(rng)
    q = x[:16] + 0.05 * rng.standard_normal((16, 128)).astype(np.float32)
    cand = JV.query(jst, jnp.asarray(q), 40, metric=metric, num_probes=3, rerank="xla")
    jd, js, jv = JV._refine_topk(jst, jnp.asarray(q), *cand, 10, metric, 3.0)
    td, ts, tv = TV._refine_topk(to_port(jst), torch.from_numpy(q),
                                 *(torch.from_numpy(np.asarray(a).copy()) for a in cand),
                                 10, metric)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy().astype(np.int32), np.asarray(js))
    assert_dists_close(metric, td.numpy(), jd, q)


@pytest.mark.parametrize("scan_res", [False, True])
def test_merge_spare_scores_the_residual_only_in_scan_mode(rng, scan_res):
    jst, x, _ = _built(rng)
    q = x[:16] + 0.1
    B, k = 16, 12
    empty = (np.full((B, k), np.inf, np.float32), np.full((B, k), -1, np.int32),
             np.zeros((B, k), bool))
    jd, js, jv = JV._merge_spare(jst, jnp.asarray(q), *(jnp.asarray(a) for a in empty), k,
                                 "sql2", 3.0, scan_res=scan_res)
    td, ts, tv = TV._merge_spare(to_port(jst), torch.from_numpy(q),
                                 *(torch.from_numpy(a).long() if a.dtype == np.int32
                                   else torch.from_numpy(a) for a in empty), k, "sql2", scan_res)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert_dists_close("sql2", td.numpy(), jd, q)
    assert (ts >= jst.num_clusters * jst.ccap).all()  # spare rows only


@pytest.mark.parametrize("metric", ["cosine", "l2", "sql2"])
@pytest.mark.parametrize("k", [10, 40])  # refine_k 160 takes the eager route on both sides
def test_refine_query_wave_route_matches_pallas2(rng, interp_kernel, metric, k):
    jst, x, _ = _built(rng, metric="cosine")
    tst = to_port(jst)
    q = x[::30] + 0.05 * rng.standard_normal((30, 128)).astype(np.float32)
    rk = _refine_k(k)
    jd, js, jv = JV.query(jst, jnp.asarray(q), k, metric=metric, num_probes=4,
                          rerank="pallas2", refine_k=rk)
    large = TV.EAGER_LARGE_K
    td, ts, tv = TV.query(tst, torch.from_numpy(q), k, metric=metric, num_probes=4,
                          rerank="cuda2", refine_k=rk)
    assert TV.EAGER_LARGE_K == large + (rk > 128)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    same = ts.numpy() == np.asarray(js)
    assert same.mean() >= 0.97, f"slot agreement {same.mean()}"
    got, want = td.numpy()[same], np.asarray(jd)[same]
    if metric == "l2":
        got, want = got * got, want * want
    scale = 1.0 if metric == "cosine" else 2 * float((q ** 2).sum(-1).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("metric", ["cosine", "l2", "sql2"])
def test_wave_route_inverts_with_the_unrounded_norm(rng, metric):
    """The wave stage forms the coarse distance from the bf16-ROUNDED query,
    the refine pass inverts it with the unrounded |q|^2 (the reference's
    behaviour, reproduced). Against the eager route, which never rounds, the
    refined distances therefore differ by the rounding of the coarse dot:
    bf16 keeps 8 bits, so ~2^-9 of |q||x| — held here to 2e-3 of the
    |q|^2 + |x|^2 scale, three orders above the f32 bound of the other tests."""
    jst, x, _ = _built(rng)
    tst = to_port(jst)
    q = torch.from_numpy(x[::30] + 0.05 * rng.standard_normal((30, 128)).astype(np.float32))
    a = TV.query(tst, q, 10, metric=metric, num_probes=4, rerank="cuda2", refine_k=40)
    b = TV.query(tst, q, 10, metric=metric, num_probes=4, rerank="eager", refine_k=40)
    assert torch.equal(a[2], b[2])
    same = a[1] == b[1]
    assert float(same.float().mean()) >= 0.9
    got, want = a[0][same], b[0][same]
    if metric == "l2":
        got, want = got * got, want * want
    scale = 1.0 if metric == "cosine" else 2 * float((q * q).sum(-1).max())
    torch.testing.assert_close(got, want, rtol=0, atol=2e-3 * scale)


def test_refine_on_the_probe_kernel_route_scans_the_coarse_slab(rng):
    """rerank="cuda" under refine=N: the probe kernel's plain version scores
    the coarse slab alone (``scan_residual=False``) — the eager route's answer."""
    jst, x, _ = _built(rng)
    tst = to_port(jst)
    q = torch.from_numpy(x[::40] + 0.05 * rng.standard_normal((23, 128)).astype(np.float32))
    a = TV.query(tst, q, 10, num_probes=3, rerank="cuda", refine_k=40)
    b = TV.query(tst, q, 10, num_probes=3, rerank="eager", refine_k=40)
    np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())
    np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), rtol=1e-5, atol=1e-6)
    probes = TV.select_probes(tst, q, 3, "cosine")
    coarse = TR.ivf_rerank(tst, q, probes, 10, scan_residual=False)
    full = TR.ivf_rerank(tst, q, probes, 10)
    assert not torch.equal(coarse[0], full[0])


def test_scan_mode_overrides_refine_k_and_the_wave_route(rng):
    """refine_scan zeroes refine_k, and "cuda2" has no scan form: it takes
    the probe kernel's route, residual included."""
    jst, x, _ = _built(rng)
    tst = to_port(jst)
    q = torch.from_numpy(x[:8])
    a = TV.query(tst, q, 10, num_probes=3, rerank="cuda2", refine_k=40, refine_scan=True)
    b = TV.query(tst, q, 10, num_probes=3, rerank="cuda", refine_scan=True)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_refine_query_batches_in_chunks(rng, monkeypatch):
    jst, x, _ = _built(rng)
    tst = to_port(jst)
    # the [B, kk, D] residual gather counts against the per-pass budget
    assert (TV._query_chunk_rows(tst, 10**9, 10, False, kk=40)
            < TV._query_chunk_rows(tst, 10**9, 10, False))
    q = torch.from_numpy(x[:50])
    whole = TV.query(tst, q, 10, num_probes=3, refine_k=40)
    monkeypatch.setattr(TV, "_query_chunk_rows", lambda *a, **k: 16)
    parts = TV.query(tst, q, 10, num_probes=3, refine_k=40)
    np.testing.assert_array_equal(whole[1].numpy(), parts[1].numpy())
    np.testing.assert_allclose(whole[0].numpy(), parts[0].numpy(), rtol=1e-6, atol=1e-7)


# -- the host index ----------------------------------------------------------------


#: every IVF slab tier: refined int8 (q8 wire) and the array-wire tiers
TIERS = {"4": dict(refine=4), "2": dict(refine=2), "scan": dict(refine="scan"),
         "balanced": dict(dtype="bfloat16", refine=0, num_probes=4),
         "f32": dict(dtype="float32", refine=0), "int8": dict(dtype="int8", refine=0)}


@pytest.mark.parametrize("refine", list(TIERS))
@pytest.mark.parametrize("rerank", ["auto", "pallas2"])
def test_ivfindex_matches_jax(rng, monkeypatch, refine, rerank):
    """The same rows, ids and (injected) centroids through both packages'
    ``IVFIndex``, on every tier: the same stored state and ids, distances
    within the f32 bound. On the array-wire tiers a differing rank must be
    an f64-verified tie of the query as the index takes it (bf16-rounded
    where the query wire is bf16): their rows are values, and two f32 sums
    taken in another order can swap neighbours closer than their rounding."""
    x = _blobs(rng, 3000)
    q = x[::100] + 0.05 * rng.standard_normal((30, 128)).astype(np.float32)
    cents = x[rng.choice(3000, 64, replace=False)] + 0.01
    monkeypatch.setattr(JIndex, "_train_centroids", lambda self, k, data: jnp.asarray(cents[:k]))
    monkeypatch.setattr(TIndex, "_train_centroids",
                        lambda self, k, data: torch.from_numpy(cents[:k].copy()))
    ids = [bytes([1 + i // 250, 1 + i % 250]) + b"\x07" * 14 for i in range(3000)]
    kw = dict(TIERS[refine], rerank=rerank, num_clusters=64)
    jix = JIndex(dim=128, options=JOptions(**kw))
    tix = TIndex(dim=128, options=TOptions(**kw), device="cpu")
    jix.add(x, ids=list(ids))
    tix.add(x, ids=list(ids))
    jix.remove(ids[:25])
    tix.remove(ids[:25])
    assert_state_equal(tix.state, jix.state)
    qq = torch.from_numpy(q)
    if tix.options.query_wire_is_bf16():
        qq = qq.to(torch.bfloat16).float()
    for k in (10, 33):
        want, got = jix.search(q, k), tix.search(q, k)
        if TIERS[refine]["refine"]:  # the q8 tiers: ids exactly
            assert [[i for i, _ in r] for r in got] == [[i for i, _ in r] for r in want]
        else:
            js, ts = jix.search_arrays(q, k)[1], tix.search_arrays(q, k)[1]
            assert_slots_or_ties(tix.metric, ts, js, tix.state, qq.numpy())
        np.testing.assert_allclose([[d for _, d in r] for r in got],
                                   [[d for _, d in r] for r in want], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("tier", ["4", "balanced", "f32", "int8"])
def test_spare_growth_retry_matches_jax(rng, monkeypatch, tier):
    """A spare too small for the batch, in both packages on the same
    (injected) centroids: the rows it could not take are retried after the
    spare grows, as the JAX package retries them (refined int8 re-quantises
    the f32 rows; the array-wire tiers insert the f32 rows themselves), so
    both store the same state. 208 rows fill the 4 x 32 cluster rows and
    overflow the 64-row spare by 16. The JAX index defers the rebuild its
    policy then asks for, as under its facade: a rebuild re-inserts the
    stored rows, and the port has no rebuild policy yet."""
    x = _blobs(rng, 208)
    cents = x[rng.choice(208, 4, replace=False)] + 0.01
    monkeypatch.setattr(JIndex, "_train_centroids", lambda self, k, data: jnp.asarray(cents[:k]))
    monkeypatch.setattr(TIndex, "_train_centroids",
                        lambda self, k, data: torch.from_numpy(cents[:k].copy()))
    ids = [bytes([1, 1 + i]) + b"\x09" * 14 for i in range(208)]
    kw = dict(TIERS[tier], num_clusters=4, cluster_capacity=32, spare_capacity=64)
    jix = JIndex(dim=128, options=JOptions(**kw))
    jix.defer_rebuild = True
    tix = TIndex(dim=128, options=TOptions(**kw), device="cpu")
    jix.add(x, ids=list(ids))
    tix.add(x, ids=list(ids))
    st = tix.state
    # overflow counts the rows the first attempt dropped; every row is placed
    assert (st.spare_capacity, int(st.overflow), len(tix)) == (64 + 1024, 16, 208)
    assert (jix.state.spare_capacity, int(jix.state.overflow)) == (64 + 1024, 16)
    assert_state_equal(st, jix.state)
    assert all(tix._id_to_slot.get(i) == jix._id_to_slot.get(i) for i in ids)


def test_ivfindex_rejects_what_jax_rejects():
    for options, exc in ((dict(dtype="bfloat16", refine=4), ValueError),
                         (dict(dtype="float32", refine="scan"), ValueError),
                         (dict(refine=-1), ValueError),
                         (dict(refine="gather"), ValueError)):
        with pytest.raises(exc, match="refine"):
            JIndex(dim=16, options=JOptions(**options))
        with pytest.raises(exc, match="refine"):
            TIndex(dim=16, options=TOptions(**options), device="cpu")
    # and constructs where it constructs, with the same slab type and wire
    for options in (dict(dtype="int8", refine=0), dict(dtype="bfloat16"),
                    dict(dtype="float32"), dict(refine=4), dict()):
        jix = JIndex(dim=16, options=JOptions(**options))
        tix = TIndex(dim=16, options=TOptions(**options), device="cpu")
        assert str(tix.dtype) == f"torch.{np.dtype(jix.dtype).name}"
        assert (tix._wal_codec, tix._wire_row_bytes) == (jix._wal_codec, jix._wire_row_bytes)


@pytest.mark.parametrize("stored", ["auto", "xla", "pallas", "pallas2"])
@pytest.mark.parametrize("refine", [4, "scan"])
def test_resolved_rerank(stored, refine):
    """By device: everything is "eager" on the CPU; on a CUDA device a stored
    "pallas2" resolves to the wave kernel's route (scan or not: the query
    falls to the probe kernel in scan mode), every other value to "cuda".
    The resolved word is never the stored one."""
    opts = TOptions(rerank=stored, refine=refine)
    assert opts.resolved_rerank(768, "ivf", "cpu") == "eager"
    assert opts.resolved_rerank(768, "ivf", "cuda") == ("cuda2" if stored == "pallas2" else "cuda")
    assert opts.resolved_rerank(768, "ivf", "cuda:1") == opts.resolved_rerank(768, "ivf", "cuda")
    assert opts.resolved_rerank(768, "lsh", "cuda") == "cuda"
    assert opts.concrete(768, "ivf", "cuda").rerank in ("cuda", "cuda2")
    assert TOptions.from_json(opts.to_json()).rerank == stored
