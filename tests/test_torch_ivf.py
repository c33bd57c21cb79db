"""Parity of the port's IVF device ops (``zebra_tpu_torch.index.ivf``) with
the JAX package's, on the CPU, on states carried over from JAX.

Placement and stored state must be bitwise equal (``norms`` to rtol 1e-6:
the same f32 squares, summed in another order); query slots equal, distances
to rtol 1e-5. The gather-refine query (``refine_k``) is held to the same
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


@pytest.mark.parametrize("refine", [4, 2, "scan"])
@pytest.mark.parametrize("rerank", ["auto", "pallas2"])
def test_ivfindex_matches_jax(rng, monkeypatch, refine, rerank):
    """The same rows, ids and (injected) centroids through both packages'
    ``IVFIndex``: the same ids, distances within the f32 bound."""
    x = _blobs(rng, 3000)
    q = x[::100] + 0.05 * rng.standard_normal((30, 128)).astype(np.float32)
    cents = x[rng.choice(3000, 64, replace=False)] + 0.01
    monkeypatch.setattr(JIndex, "_train_centroids", lambda self, k, data: jnp.asarray(cents[:k]))
    monkeypatch.setattr(TIndex, "_train_centroids",
                        lambda self, k, data: torch.from_numpy(cents[:k].copy()))
    ids = [bytes([1 + i // 250, 1 + i % 250]) + b"\x07" * 14 for i in range(3000)]
    kw = dict(refine=refine, rerank=rerank, num_clusters=64)
    jix = JIndex(dim=128, options=JOptions(**kw))
    tix = TIndex(dim=128, options=TOptions(**kw), device="cpu")
    jix.add(x, ids=list(ids))
    tix.add(x, ids=list(ids))
    jix.remove(ids[:25])
    tix.remove(ids[:25])
    assert_state_equal(tix.state, jix.state)
    for k in (10, 33):
        want, got = jix.search(q, k), tix.search(q, k)
        assert [[i for i, _ in r] for r in got] == [[i for i, _ in r] for r in want]
        np.testing.assert_allclose([[d for _, d in r] for r in got],
                                   [[d for _, d in r] for r in want], rtol=1e-4, atol=1e-5)


def test_ivfindex_rejects_what_jax_rejects():
    for options, exc in ((dict(dtype="bfloat16", refine=4), ValueError),
                         (dict(dtype="float32", refine="scan"), ValueError),
                         (dict(refine=-1), ValueError),
                         (dict(refine="gather"), ValueError)):
        with pytest.raises(exc, match="refine"):
            JIndex(dim=16, options=JOptions(**options))
        with pytest.raises(exc, match="refine"):
            TIndex(dim=16, options=TOptions(**options), device="cpu")
    # tiers the JAX package has and the port does not yet
    for options in (dict(dtype="int8", refine=0), dict(dtype="bfloat16"),
                    dict(dtype="float32")):
        JIndex(dim=16, options=JOptions(**options))
        with pytest.raises(NotImplementedError, match="queue 1, item 3"):
            TIndex(dim=16, options=TOptions(**options), device="cpu")


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
