"""The IVF re-rank kernel's plain torch version against the JAX package's
Pallas kernel (run in interpret mode on the CPU, as
``tests/test_pallas_ivf.py`` runs it) and against its XLA branch.

Tolerances: ``dots="bf16x2f"`` (split-query bf16 dots) vs the Pallas kernel
with the same dots — rtol/atol 2e-3 and slot overlap >= 0.97, the bounds of
``tests/test_pallas_ivf.py`` for split dots; ``dots="highest"`` (f32 dots)
vs the JAX XLA branch — rtol/atol 1e-4 and equal slots.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zebra_tpu.ops.pallas_ivf as PI
from zebra_tpu.index import ivf as JV
from zebra_tpu_torch.index import ivf as TV
from zebra_tpu_torch.ops import ivf_rerank as TR

FIELDS = ("centroids", "counts", "vectors", "norms", "valid", "overflow", "scales",
          "residual", "rscales")


@pytest.fixture
def interp_kernel(monkeypatch):
    orig = PI.pallas_ivf_rerank

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(PI, "pallas_ivf_rerank", interp)


def to_port(st) -> TV.IVFState:
    arrays = {f: np.asarray(getattr(st, f)) for f in FIELDS if getattr(st, f) is not None}
    arrays["ccap"] = st.ccap
    return TV.state_from_numpy(arrays)


def _state(rng, n=1024, K=16, C=96, d=128, spare=0, tomb=40):
    """int8 + residual JAX state on clustered data, with tombstones; the
    blocks are ragged (counts < C)."""
    centers = rng.standard_normal((8, d)).astype(np.float32)
    x = centers[rng.integers(0, 8, n)] + 0.1 * rng.standard_normal((n, d)).astype(np.float32)
    cents = x[rng.choice(n, K, replace=False)] + 0.01
    st = JV.empty_state(jnp.asarray(cents), C, spare, dtype=jnp.int8, refine=True)
    v8, r8, sc, rs = JV.quantise_pair_host(x)
    st, slots = JV.insert_quant(st, jnp.asarray(v8), jnp.asarray(r8),
                                jnp.asarray(np.stack([sc, rs], 1)), jnp.int32(n),
                                spill=8, metric="cosine")
    slots = np.asarray(slots)
    st = JV.delete_slots(st, jnp.asarray(slots[:tomb].astype(np.int32)))
    return st, x


def _queries(rng, x, B=32):
    return (x[:B] + 0.02 * rng.standard_normal((B, x.shape[1]))).astype(np.float32)


def test_split_bf16_matches_jax_bitwise(rng):
    x = (rng.standard_normal(4096) * 10.0 ** rng.integers(-3, 4, 4096)).astype(np.float32)
    jh, jl = PI._split_bf16(jnp.asarray(x))
    th, tl = TR._split_bf16(torch.from_numpy(x))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh.astype(jnp.float32)))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl.astype(jnp.float32)))


@pytest.mark.parametrize("metric", ["cosine", "l2", "sql2"])
def test_reference_bf16x2f_matches_pallas_interpret(rng, interp_kernel, metric):
    st, x = _state(rng)
    q = _queries(rng, x)
    probes = JV.select_probes(st, jnp.asarray(q), 4, metric).astype(jnp.int32)
    jd, js, jv = PI.ivf_rerank(st, jnp.asarray(q), probes, 10, metric=metric,
                               dots="bf16x2f", fetch="block", scan_residual=True)
    td, ts, tv = TR.ivf_rerank_reference(
        to_port(st), torch.from_numpy(q), torch.from_numpy(np.asarray(probes)), 10,
        metric, dots="bf16x2f")
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    overlap = np.mean(ts.numpy() == np.asarray(js))
    assert overlap >= 0.97, f"slot overlap {overlap}"
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("metric", ["cosine", "l2", "sql2"])
def test_reference_highest_matches_xla_branch(rng, metric):
    st, x = _state(rng)
    q = _queries(rng, x)
    jd, js, jv = JV.query(st, jnp.asarray(q), 10, metric=metric, num_probes=4,
                          rerank="xla", refine_scan=True)
    probes = np.asarray(JV.select_probes(st, jnp.asarray(q), 4, metric))
    td, ts, tv = TR.ivf_rerank_reference(to_port(st), torch.from_numpy(q),
                                         torch.from_numpy(probes), 10, metric)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-4)


def test_reference_highest_matches_pallas_highest(rng, interp_kernel):
    st, x = _state(rng)
    q = _queries(rng, x, B=16)
    probes = JV.select_probes(st, jnp.asarray(q), 3, "cosine").astype(jnp.int32)  # odd P
    jd, js, jv = PI.ivf_rerank(st, jnp.asarray(q), probes, 10, dots="highest",
                               fetch="block", scan_residual=True)
    td, ts, tv = TR.ivf_rerank_reference(to_port(st), torch.from_numpy(q),
                                         torch.from_numpy(np.asarray(probes)), 10)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-4)


def test_underfull_tail_is_missing(rng):
    """Fewer live candidates than k (and k wider than P*C): the tail is
    +inf / -1 / invalid."""
    st, x = _state(rng, n=3, K=2, C=4, tomb=0)
    tst = to_port(st)
    q = torch.from_numpy(x[:2])
    d, s, v = TR.ivf_rerank_reference(tst, q, torch.tensor([[0, 1], [1, 0]]), 10)
    assert v[:, :3].all() and not v[:, 3:].any()
    assert (s[:, 3:] == -1).all() and torch.isinf(d[:, 3:]).all()


def test_adapter_on_cpu_is_the_plain_version(rng):
    st, x = _state(rng)
    tst = to_port(st)
    q = torch.from_numpy(_queries(rng, x))
    probes = TV.select_probes(tst, q, 4, "cosine")
    before = TR.LAUNCHES
    got = TR.ivf_rerank(tst, q, probes, 10)
    want = TR.ivf_rerank_reference(tst, q, probes, 10, dots="highest")
    assert TR.LAUNCHES == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_kernel_refuses_slab_forms_it_lacks():
    """f32/bf16 slabs are not a form the CUDA kernel takes: it raises (and
    never hands the work to the plain version)."""
    st = TV.empty_state(torch.zeros(4, 16), 8, 0, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TR._launch(st, torch.zeros(2, 16), torch.zeros(2, 2, dtype=torch.int64), 5, "cosine")

