"""Parity of the port's IVF device ops (``zebra_tpu_torch.index.ivf``) with
the JAX package's, on the CPU, on states carried over from JAX.

Placement and stored state must be bitwise equal (``norms`` to rtol 1e-6:
the same f32 squares, summed in another order); query slots equal, distances
to rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zebra_tpu.index import ivf as JV
from zebra_tpu_torch.index import ivf as TV
from zebra_tpu_torch.ops import ivf_rerank as TR

FIELDS = ("centroids", "counts", "vectors", "norms", "valid", "overflow", "scales",
          "residual", "rscales")


def to_port(st) -> TV.IVFState:
    arrays = {f: np.asarray(getattr(st, f)) for f in FIELDS if getattr(st, f) is not None}
    arrays["ccap"] = st.ccap
    return TV.state_from_numpy(arrays)


def assert_state_equal(tst: TV.IVFState, jst):
    for f in ("counts", "vectors", "residual", "scales", "rscales", "valid", "overflow"):
        np.testing.assert_array_equal(getattr(tst, f).numpy(), np.asarray(getattr(jst, f)), err_msg=f)
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


def test_refine_n_states_raise(rng):
    jst, x, _ = _built(rng)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TV.query(to_port(jst), torch.from_numpy(x[:2]), 10, refine_scan=False)
