"""Parity of the torch port's ops with the JAX package's, on the CPU.

The same seeded numpy inputs go through ``zebra_tpu.ops`` (CPU JAX) and
``zebra_tpu_torch.ops`` (CPU torch). Integer outputs must be equal;
distances agree to rtol 1e-5 (float32, summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zebra_tpu.ops import distances as JD
from zebra_tpu.ops import kmeans as JK
from zebra_tpu.ops import scan as JS
from zebra_tpu.ops import topk as JT
from zebra_tpu_torch.ops import distances as TD
from zebra_tpu_torch.ops import kmeans as TKM
from zebra_tpu_torch.ops import scan as TS
from zebra_tpu_torch.ops import topk as TT

RTOL = 1e-5  # f32 distances, another summation order


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _dists_with_ties(rng, B, W):
    # values on a coarse grid so equal distances are common
    return (rng.integers(0, 40, (B, W)) / 8.0).astype(np.float32)


@pytest.mark.parametrize("k", [1, 7, 16])
def test_masked_topk_matches_jax(rng, k):
    d = _dists_with_ties(rng, 12, 40)
    d[0, 3] = np.nan
    valid = rng.random((12, 40)) > 0.3
    valid[1] = False  # a row with nothing valid
    ids = rng.integers(0, 10_000, (12, 40)).astype(np.int32)
    jd, ji, jv = JT.masked_topk(jnp.asarray(d), jnp.asarray(valid), jnp.asarray(ids), k)
    td, ti, tv = TT.masked_topk(_t(d), _t(valid), _t(ids).long(), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL)


def test_merge_topk_matches_jax(rng):
    k = 8
    parts = []
    for _ in range(2):
        d = np.sort(_dists_with_ties(rng, 6, k), axis=1)
        v = rng.random((6, k)) > 0.2
        i = np.where(v, rng.integers(0, 500, (6, k)), -1).astype(np.int32)
        parts.append((d, i, v))
    (da, ia, va), (db, ib, vb) = parts
    j = JT.merge_topk(*map(jnp.asarray, (da, ia, va, db, ib, vb)), k)
    t = TT.merge_topk(_t(da), _t(ia).long(), _t(va), _t(db), _t(ib).long(), _t(vb), k)
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), rtol=RTOL)


@pytest.mark.parametrize("metric", ["cosine", "l2", "sql2"])
def test_mxu_parts_match_jax(rng, metric):
    dot = rng.standard_normal((5, 9)).astype(np.float32)
    qn2 = (rng.random((5, 1)) * 4).astype(np.float32)
    xn2 = (rng.random((1, 9)) * 4).astype(np.float32)
    xn2[0, 2] = 0.0  # zero norm: cosine pinned at 1, inverse dot 0
    if metric != "cosine":
        dot = 0.1 * dot  # keep |q|^2 + |x|^2 - 2 dot > 0 for the round trip
    jd = JD.mxu_from_parts(metric, jnp.asarray(dot), jnp.asarray(qn2), jnp.asarray(xn2))
    td = TD.mxu_from_parts(metric, _t(dot), _t(qn2), _t(xn2))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL, atol=1e-6)
    ji = JD.mxu_invert_parts(metric, jd, jnp.asarray(qn2), jnp.asarray(xn2))
    ti = TD.mxu_invert_parts(metric, td, _t(qn2), _t(xn2))
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("metric", ["cosine", "l2", "sql2"])
def test_pairwise_matches_jax(rng, metric):
    q = rng.standard_normal((6, 32)).astype(np.float32)
    x = rng.standard_normal((20, 32)).astype(np.float32)
    jd = JD.pairwise(jnp.asarray(q), jnp.asarray(x), metric=metric)
    td = TD.pairwise(_t(q), _t(x), metric=metric)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL, atol=1e-5)


def _int8_slab(rng, S, D):
    v8 = rng.integers(-127, 128, (S, D)).astype(np.int8)
    r8 = rng.integers(-127, 128, (S, D)).astype(np.int8)
    sc = (0.01 + 0.04 * rng.random(S)).astype(np.float32)
    rs = (sc / 127).astype(np.float32)
    x = v8.astype(np.float32) * sc[:, None] + r8.astype(np.float32) * rs[:, None]
    return v8, r8, sc, rs, (x * x).sum(-1).astype(np.float32)


@pytest.mark.parametrize("metric", ["cosine", "l2", "sql2"])
@pytest.mark.parametrize("window", [None, (1024, 512)])
def test_exact_scan_residual_matches_jax(rng, metric, window):
    S, D, k = 2048, 64, 10
    v8, r8, sc, rs, n2 = _int8_slab(rng, S, D)
    valid = rng.random(S) > 0.2
    q = rng.standard_normal((8, D)).astype(np.float32)
    w = {} if window is None else dict(w_start=window[0], w_len=window[1])
    j = JS.exact_scan(
        jnp.asarray(v8), jnp.asarray(valid), jnp.asarray(q), k, metric=metric, chunk=256,
        scales=jnp.asarray(sc), norms=jnp.asarray(n2), residual=jnp.asarray(r8),
        rscales=jnp.asarray(rs), **w,
    )
    t = TS.exact_scan(
        _t(v8), _t(valid), _t(q), k, metric=metric, chunk=256, scales=_t(sc),
        norms=_t(n2), residual=_t(r8), rscales=_t(rs), **w,
    )
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), rtol=RTOL, atol=1e-6)


def test_exact_scan_float_slab_matches_jax(rng):
    x = rng.standard_normal((600, 48)).astype(np.float32)  # 600: ragged chunk rule
    valid = rng.random(600) > 0.1
    q = rng.standard_normal((5, 48)).astype(np.float32)
    j = JS.exact_scan(jnp.asarray(x), jnp.asarray(valid), jnp.asarray(q), 12, chunk=256)
    t = TS.exact_scan(_t(x), _t(valid), _t(q), 12, chunk=256)
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), rtol=RTOL, atol=1e-6)


def _blobs(rng, n=2048, d=32, centers=64, spread=0.05):
    # more blobs than centroids: cell boundaries fall in the empty space
    # between blobs, so no row sits near an assignment tie
    c = 3.0 * rng.standard_normal((centers, d)).astype(np.float32)
    return c[rng.integers(0, centers, n)] + spread * rng.standard_normal((n, d)).astype(np.float32)


def _jax_draws(key, n, n_valid, k, iters, rounds):
    k_init, k_reseed, k_split = jax.random.split(key, 3)
    nv = max(n_valid, 1)
    init = jax.random.randint(k_init, (k,), 0, n) % nv
    reseed = jax.random.randint(k_reseed, (iters + 2 * rounds, k), 0, n) % nv
    split = jax.random.randint(k_split, (rounds, max(k // 8, 1)), 0, n) % nv
    return [torch.from_numpy(np.asarray(a).astype(np.int64)) for a in (init, reseed, split)]


@pytest.mark.parametrize("rounds", [0, 2])
def test_kmeans_matches_jax_with_injected_draws(rng, rounds):
    """Same draws, same Lloyd/balance procedure: centroids agree to rtol
    1e-4 (sums accumulate in another order) on well-separated blobs."""
    data = _blobs(rng)
    n, k, iters = data.shape[0], 16, 5
    key = jax.random.PRNGKey(3)
    jc, jn = JK.kmeans(key, jnp.asarray(data), jnp.int32(n), k=k, iters=iters,
                       chunk=512, balance_rounds=rounds)
    init, reseed, split = _jax_draws(key, n, n, k, iters, rounds)
    tc, tn = TKM.kmeans(_t(data), n, k, iters=iters, chunk=512, balance_rounds=rounds,
                        init_idx=init, reseed_idx=reseed, split_idx=split)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-5)
    ja = JK.assign_clusters(jnp.asarray(data), jc, chunk=512)
    ta = TKM.assign_clusters(_t(data), tc, chunk=512)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


def test_kmeans_draws_from_generator_are_reproducible(rng):
    data = _t(_blobs(rng, n=512))
    a = TKM.kmeans(data, 512, 8, iters=3, generator=torch.Generator().manual_seed(1))
    b = TKM.kmeans(data, 512, 8, iters=3, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    assert int(a[1].sum()) == 512
