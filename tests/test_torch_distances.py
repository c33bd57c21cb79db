"""The port's twelve distance metrics against the JAX package's, on the CPU.

The same seeded numpy inputs (with zero rows, equal rows and negative
values) go through ``zebra_tpu.ops.distances`` and
``zebra_tpu_torch.ops.distances``, through ``pairwise`` and ``rowwise``:
distances agree to rtol 1e-5, atol 1e-6 (f32 sums taken in another order;
l3's cube root is ``pow(s, 1/3)`` in the port, ``cbrt`` in JAX), hamming
bitwise. :func:`metric64` is a float64 reference of every metric that the
flat and elementwise index tests use to verify ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zebra_tpu.ops import distances as JD
from zebra_tpu.ops import scan as JS
from zebra_tpu_torch.ops import distances as TD
from zebra_tpu_torch.ops import scan as TS

ELEMENTWISE = ("chebyshev", "canberra", "braycurtis", "manhattan", "l3", "l4", "hamming",
               "minkowski", "p_norm")
RTOL, ATOL = 1e-5, 1e-6


def metric64(metric: str, q, x, power: float = 3.0) -> np.ndarray:
    """``[Q, C]`` float64 distances of f32 rows ``q [Q, D]`` and ``x [C, D]``."""
    q = np.asarray(q, np.float32)
    x = np.asarray(x, np.float32)
    if metric == "hamming":
        bits = (q.view(np.int32)[:, None, :] ^ x.view(np.int32)[None, :, :]) & 0xFF
        return np.unpackbits(bits.astype(np.uint8)[..., None], axis=-1).sum((-1, -2)).astype(
            np.float64)
    a, b = q.astype(np.float64)[:, None, :], x.astype(np.float64)[None, :, :]
    if metric in TD.MXU_METRICS:
        dot = (a * b).sum(-1)
        qn2, xn2 = (a * a).sum(-1), (b * b).sum(-1)
        if metric == "cosine":
            den = np.sqrt(qn2 * xn2)
            return 1.0 - np.where(den > 0, dot / np.maximum(den, 1e-300), 0.0)
        d2 = np.maximum(qn2 + xn2 - 2.0 * dot, 0.0)
        return d2 if metric == "sql2" else np.sqrt(d2)
    d = np.abs(a - b)
    if metric == "chebyshev":
        return d.max(-1)
    if metric == "canberra":
        den = np.abs(a) + np.abs(b)
        return np.where(den > 0, d / np.where(den > 0, den, 1.0), 0.0).sum(-1)
    if metric == "braycurtis":
        num, den = d.sum(-1), np.abs(a + b).sum(-1)
        return np.where(den > 0, num / np.where(den > 0, den, 1.0), 0.0)
    if metric == "manhattan":
        return d.sum(-1)
    if metric == "l3":
        return np.cbrt((d ** 3).sum(-1))
    if metric == "l4":
        return ((d ** 4).sum(-1)) ** 0.25
    if metric == "minkowski":
        return ((d ** power).sum(-1)) ** (1.0 / power)
    if metric == "p_norm":
        return (d ** power).sum(-1)
    raise ValueError(metric)


def _rows(rng, n, d=24):
    """Rows with a zero row, two equal rows and negative values."""
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[0] = 0.0
    x[2] = x[1]
    x[3, : d // 2] = 0.0  # zero terms beside non-zero ones (canberra's guard)
    return x


def _pair(rng):
    q, x = _rows(rng, 6), _rows(rng, 20)
    q[4] = x[1]  # a query equal to a row: every metric's zero
    return q, x


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_metric_close(metric, got, want):
    if metric == "hamming":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("power", [3.0, 1.5])
@pytest.mark.parametrize("metric", TD.METRICS)
def test_pairwise_matches_jax(rng, metric, power):
    q, x = _pair(rng)
    want = np.asarray(JD.pairwise(jnp.asarray(q), jnp.asarray(x), metric=metric, power=power))
    got = TD.pairwise(_t(q), _t(x), metric=metric, power=power).numpy()
    assert got.dtype == np.float32 and got.shape == (6, 20)
    _assert_metric_close(metric, got, want)
    np.testing.assert_allclose(got, metric64(metric, q, x, power), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("metric", TD.METRICS)
def test_rowwise_matches_jax(rng, metric):
    q, x = _pair(rng)
    xb = np.stack([np.roll(x, i, axis=0)[:9] for i in range(q.shape[0])])  # [B, C, D]
    want = np.asarray(JD.rowwise(jnp.asarray(q), jnp.asarray(xb), metric=metric, power=2.5))
    got = TD.rowwise(_t(q), _t(xb), metric=metric, power=2.5).numpy()
    _assert_metric_close(metric, got, want)


def test_the_twelve_metrics_and_the_gram_three():
    assert set(TD.METRICS) == set(JD.METRICS) and len(TD.METRICS) == 12
    assert TD.MXU_METRICS == JD.MXU_METRICS
    for m in TD.METRICS:
        TD.check_metric(m)
    with pytest.raises(ValueError, match="unknown metric"):
        TD.check_metric("dot")
    with pytest.raises(ValueError, match="unknown matmul precision"):
        TD.pairwise(torch.zeros(1, 4), torch.zeros(2, 4), precision="bf16")


@pytest.mark.parametrize("metric", ["cosine", "l2", "sql2"])
def test_default_precision_is_f32_on_the_cpu(rng, metric):
    q, x = _pair(rng)
    hi = TD.pairwise(_t(q), _t(x), metric=metric)
    assert torch.equal(TD.pairwise(_t(q), _t(x), metric=metric, precision="default"), hi)
    want = JD.pairwise(jnp.asarray(q), jnp.asarray(x), metric=metric, precision="default")
    np.testing.assert_allclose(hi.numpy(), np.asarray(want), rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("metric", ELEMENTWISE)
def test_chunked_pairwise_equals_one_pass(rng, monkeypatch, metric):
    """Query and row chunks (here 7 pairs of 24 columns a chunk) give the
    one-pass matrix: each pair's reduction is the same, up to the last bit
    of an elementwise pow that the CPU vectorises by tensor size."""
    q, x = _rows(rng, 9), _rows(rng, 30)
    whole = TD.pairwise(_t(q), _t(x), metric=metric)
    monkeypatch.setattr(TD, "ELEMENTWISE_BYTES", 7 * 4 * 24)
    np.testing.assert_allclose(TD.pairwise(_t(q), _t(x), metric=metric).numpy(), whole.numpy(),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("metric", ELEMENTWISE)
def test_exact_scan_matches_jax(rng, metric):
    x = _rows(rng, 1024, d=16)
    valid = rng.random(1024) > 0.2
    q = x[::97] + 0.01 * rng.standard_normal((11, 16)).astype(np.float32)
    jd, js, jv = JS.exact_scan(jnp.asarray(x), jnp.asarray(valid), jnp.asarray(q), 10,
                               metric=metric, power=2.0, chunk=256)
    td, ts, tv = TS.exact_scan(_t(x), _t(valid), _t(q), 10, metric=metric, power=2.0, chunk=256)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    _assert_metric_close(metric, td.numpy(), np.asarray(jd))
    d64 = metric64(metric, q, x, 2.0)
    got, want = ts.numpy(), np.asarray(js)
    b, r = np.nonzero(got != want)
    assert np.allclose(d64[b, got[b, r]], d64[b, want[b, r]], rtol=1e-5, atol=1e-6)
