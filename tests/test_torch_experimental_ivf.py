"""The port's one-slab wave re-rank and augmented-slab re-rank
(``zebra_tpu_torch.ops.experimental_ivf``) against their JAX twins
(``zebra_tpu.ops.experimental_ivf``), on the CPU: the plain torch versions
against the Pallas kernels run in interpret mode, as
``tests/test_pallas_ivf.py`` runs them.

Tolerances. Kernel vs plain version: validity equal; slots equal on >= 0.97
of positions and distances to rtol/atol 2e-3, the bounds of
``tests/test_pallas_ivf.py`` — both sides take f32 sums, in another order,
over the same bf16-exact products, so near-equal distances may swap ranks.
``augment_slab`` is bitwise on f32 slabs for l2 / sql2 (the body is the row
itself) and within two ulps of f32, one of bf16, on the cosine body: XLA and
torch round ``rsqrt`` differently in the last place, and the product
``row * rsqrt(norm)`` is then rounded again.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zebra_tpu.ops.pallas_ivf as PI
from zebra_tpu.index import ivf as JV
from zebra_tpu.ops import experimental_ivf as PX
from zebra_tpu_torch.index import ivf as TV
from zebra_tpu_torch.ops import experimental_ivf as TX
from zebra_tpu_torch.utils import make_data

from test_torch_kernel_ref import interp_kernel, to_port  # noqa: F401  (fixture)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}
METRICS = ["cosine", "l2", "sql2"]


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy has no bf16: widen exactly, narrow in torch
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _port_state(st) -> TV.IVFState:
    """``to_port`` for any slab type (numpy cannot carry bf16 to torch)."""
    tst = to_port(st.replace(vectors=st.vectors.astype(jnp.float32))
                  if st.vectors.dtype == jnp.bfloat16 else st)
    if st.vectors.dtype == jnp.bfloat16:
        tst.vectors = tst.vectors.to(torch.bfloat16)
    return tst


def _data(rng, n=1024, d=128):
    centers = rng.standard_normal((8, d)).astype(np.float32)
    return centers[rng.integers(0, 8, n)] + 0.1 * rng.standard_normal((n, d)).astype(np.float32)


def _state(rng, kind, n=1024, K=16, C=160, d=128, tomb=40):
    """A JAX state with tombstones and ragged blocks. ``kind``: "pair" = the
    host-quantised int8 + residual state of the database tier; "int8",
    "bfloat16", "float32" = one slab filled by ``ivf.insert``."""
    x = _data(rng, n, d)
    cents = jnp.asarray(x[rng.choice(n, K, replace=False)] + 0.01)
    if kind == "pair":
        st = JV.empty_state(cents, C, 0, dtype=jnp.int8, refine=True)
        v8, r8, sc, rs = JV.quantise_pair_host(x)
        st, slots = JV.insert_quant(st, jnp.asarray(v8), jnp.asarray(r8),
                                    jnp.asarray(np.stack([sc, rs], 1)), jnp.int32(n),
                                    spill=8, metric="cosine")
    else:
        st = JV.empty_state(cents, C, 0, dtype=JDT[kind])
        st, slots = JV.insert(st, jnp.asarray(x), jnp.int32(n))
    st = JV.delete_slots(st, jnp.asarray(np.asarray(slots)[:tomb].astype(np.int32)))
    B = min(32, n)
    q = (x[:B] + 0.02 * rng.standard_normal((B, d))).astype(np.float32)
    return st, q


def test_make_data_is_the_bench_generator():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import bench

    np.testing.assert_array_equal(make_data(5000, 32, seed=3), bench.make_data(5000, 32, seed=3))


# -- kernel 2 ---------------------------------------------------------------------


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("kind", ["pair", "int8", "bfloat16", "float32"])
@pytest.mark.parametrize("k,P", [(10, 4), (40, 3)])  # odd P: the TPU adapter pads a masked probe
def test_wave_reference_matches_pallas_interpret(rng, interp_kernel, metric, kind, k, P):
    st, q = _state(rng, kind)
    probes = JV.select_probes(st, jnp.asarray(q), P, metric).astype(jnp.int32)
    jd, js, jv = PI.ivf_rerank(st, jnp.asarray(q), probes, k, metric=metric, wave=2)
    td, ts, tv = TX.ivf_rerank_wave(_port_state(st), torch.from_numpy(q),
                                    _t(probes), k, metric)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    overlap = np.mean(ts.numpy() == np.asarray(js))
    assert overlap >= 0.97, f"slot overlap {overlap}"
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=2e-3, atol=2e-3)


def test_wave_underfull_tail_is_missing(rng, interp_kernel):
    """Fewer live rows than k: the tail is +inf / -1 / invalid on both sides."""
    st, q = _state(rng, "pair", n=3, K=2, C=8, tomb=0)
    probes = jnp.asarray([[0, 1], [1, 0]], jnp.int32)
    jd, js, jv = PI.ivf_rerank(st, jnp.asarray(q[:2]), probes, 10, wave=2)
    d, s, v = TX.ivf_rerank_wave(_port_state(st), torch.from_numpy(q[:2]), _t(probes), 10)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert v[:, :3].all() and not v[:, 3:].any()
    assert (s[:, 3:] == -1).all() and torch.isinf(d[:, 3:]).all()
    # k wider than P*C: the plain version pads the tail
    d, s, v = TX.ivf_rerank_wave(_port_state(st), torch.from_numpy(q[:2]), _t(probes), 20)
    assert d.shape == (2, 20) and int(v.sum()) == 6


def test_wave_rounds_the_query_and_its_norm(rng):
    """On a reduced slab the plain version scores the bf16-ROUNDED query and
    takes |q|^2 from it; on an f32 slab the query is untouched."""
    st, q = _state(rng, "pair")
    tst = _port_state(st)
    probes = TV.select_probes(tst, torch.from_numpy(q), 4, "sql2")
    qr = torch.from_numpy(q).to(torch.bfloat16).float()
    assert not torch.equal(qr, torch.from_numpy(q))
    a = TX.ivf_rerank_wave_reference(tst, torch.from_numpy(q), probes, 10, "sql2")
    b = TX.ivf_rerank_wave_reference(tst, qr, probes, 10, "sql2")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    before = TX.LAUNCHES_WAVE
    c = TX.ivf_rerank_wave(tst, torch.from_numpy(q), probes, 10, "sql2")
    assert TX.LAUNCHES_WAVE == before  # CPU tensors never launch
    assert torch.equal(a[0], c[0]) and torch.equal(a[1], c[1])


def test_wave_launch_refuses_what_the_kernel_lacks():
    st = TV.empty_state(torch.zeros(4, 16), 8, 0, dtype=torch.float16)
    q, pr = torch.zeros(2, 16), torch.zeros(2, 2, dtype=torch.int64)
    with pytest.raises(ValueError, match="int8, bf16 or f32"):
        TX._launch_wave(st, q, pr, 5, "cosine")
    st = TV.empty_state(torch.zeros(4, 16), 8, 0, dtype=torch.float32)
    with pytest.raises(ValueError, match="k <= 128"):
        TX._launch_wave(st, q, pr, 129, "cosine")
    with pytest.raises(ValueError, match="shared memory"):
        TX._launch_wave(TV.empty_state(torch.zeros(4, 16), 40000, 0), q, pr, 5, "cosine")


# -- kernel 3 ---------------------------------------------------------------------


def _ulp_close(got: torch.Tensor, want, dtype: str):
    """Equal within two units in the last place of f32 (2^-22 relative) or
    one of bf16 (2^-7 relative)."""
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=2.0 ** -22 if dtype == "float32" else 2.0 ** -7,
                               atol=1e-38)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_augment_slab_matches_jax(rng, metric, dtype):
    st, _ = _state(rng, dtype)
    want = PX.augment_slab(st.vectors, st.norms, st.valid, metric)
    tst = _port_state(st)
    got = TX.augment_slab(tst.vectors, tst.norms, tst.valid, metric, chunk=1000)
    assert got.dtype == tst.vectors.dtype and tuple(got.shape) == tuple(want.shape)
    D = st.dim
    # the penalty lane, the zero lanes and the split norm are exact
    np.testing.assert_array_equal(got[:, D:].float().numpy(),
                                  np.asarray(want[:, D:].astype(jnp.float32)))
    assert float(got[:, D].float().max()) >= PI.BIG  # PEN survives the slab's rounding
    if metric != "cosine" and dtype == "float32":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        _ulp_close(got[:, :D], want[:, :D], dtype)


def test_augment_slab_zero_norm_row(rng):
    """A live all-zero row: the cosine body is 0 * rsqrt(1e-30) = 0 on both
    sides, and its distance comes out 1 like the JAX function's."""
    st, q = _state(rng, "float32")
    slot = int(np.flatnonzero(np.asarray(st.valid))[0])
    st = st.replace(vectors=st.vectors.at[slot].set(0.0), norms=st.norms.at[slot].set(0.0))
    tst = _port_state(st)
    want = PX.augment_slab(st.vectors, st.norms, st.valid, "cosine")
    got = TX.augment_slab(tst.vectors, tst.norms, tst.valid, "cosine")
    np.testing.assert_array_equal(got[slot].numpy(), np.asarray(want[slot]))
    probes = jnp.asarray([[slot // st.ccap, 0]] * 2, jnp.int32)
    jd, js, _ = PX.ivf_rerank_aug(want, st.ccap, jnp.asarray(q[:2]), probes, 128,
                                  interpret=True)
    td, ts, _ = TX.ivf_rerank_aug(got, st.ccap, torch.from_numpy(q[:2]), _t(probes), 128)
    hit = np.asarray(js) == slot
    assert hit.any() and np.array_equal(ts.numpy() == slot, hit)
    np.testing.assert_allclose(td.numpy()[hit], 1.0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(jd)[hit], 1.0, atol=1e-6)


@pytest.mark.parametrize("metric", METRICS)
def test_aug_query_and_post_match_jax(rng, metric):
    """f32 elementwise maps; the cosine scale sums |q|^2 in another order
    (rtol 1e-6)."""
    q = rng.standard_normal((16, 96)).astype(np.float32)
    q[3] = 0.0
    np.testing.assert_allclose(TX.aug_query(torch.from_numpy(q), metric).numpy(),
                               np.asarray(PX.aug_query(jnp.asarray(q), metric)), rtol=1e-6)
    raw = rng.standard_normal((16, 10)).astype(np.float32) * 5
    np.testing.assert_allclose(
        TX.aug_post(torch.from_numpy(raw), torch.from_numpy(q), metric).numpy(),
        np.asarray(PX.aug_post(jnp.asarray(raw), jnp.asarray(q), metric)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("exact", [True, False])
def test_aug_reference_matches_pallas_interpret(rng, metric, dtype, exact):
    """Both sides rank the SAME augmented slab (the JAX one, carried over)."""
    st, q = _state(rng, dtype)
    probes = JV.select_probes(st, jnp.asarray(q), 4, metric).astype(jnp.int32)
    aug = PX.augment_slab(st.vectors, st.norms, st.valid, metric)
    jd, js, jv = PX.ivf_rerank_aug(aug, st.ccap, jnp.asarray(q), probes, 10, metric=metric,
                                   exact=exact, interpret=True)
    before = TX.LAUNCHES_AUG
    td, ts, tv = TX.ivf_rerank_aug(_t(aug), st.ccap, torch.from_numpy(q), _t(probes), 10,
                                   metric, exact=exact)
    assert TX.LAUNCHES_AUG == before  # CPU tensors never launch
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    overlap = np.mean(ts.numpy() == np.asarray(js))
    assert overlap >= 0.97, f"slot overlap {overlap}"
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=2e-3, atol=2e-3)


def test_aug_underfull_and_dead_rows(rng):
    """Fewer live rows than k, and a dead row with a LARGE norm under sql2:
    its PEN plus the norm lanes must still clamp to BIG (never selected, no
    inf or NaN leaking into the results)."""
    cents = jnp.asarray(rng.standard_normal((8, 128)).astype(np.float32))
    st = JV.empty_state(cents, cluster_capacity=16)
    data = rng.standard_normal((3, 128)).astype(np.float32)
    data[2] *= 1e17  # |v|^2 ~ 1e36
    st, slots = JV.insert(st, jnp.asarray(np.pad(data, ((0, 5), (0, 0)))), jnp.int32(3))
    st = JV.delete_slots(st, jnp.asarray(np.asarray(slots)[2:3].astype(np.int32)))
    q = jnp.asarray(data[:2])
    probes = jnp.tile(jnp.arange(8, dtype=jnp.int32), (2, 1))
    for metric in ("cosine", "sql2"):
        aug = PX.augment_slab(st.vectors, st.norms, st.valid, metric)
        jd, js, jv = PX.ivf_rerank_aug(aug, st.ccap, q, probes, 10, metric=metric,
                                       interpret=True)
        tst = _port_state(st)
        taug = TX.augment_slab(tst.vectors, tst.norms, tst.valid, metric)
        _ulp_close(taug, aug, "float32")
        d, s, v = TX.ivf_rerank_aug(taug, st.ccap, torch.from_numpy(np.asarray(q)),
                                    _t(probes), 10, metric)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        assert v[:, :2].all() and not v[:, 2:].any()
        assert (s[:, 2:] == -1).all() and torch.isinf(d[:, 2:]).all()
        assert torch.isfinite(d[:, :2]).all()


def test_aug_refuses_odd_probes_and_other_types(rng):
    aug = torch.zeros((64, 16 + TX.AUG))
    q, pr = torch.zeros(2, 16), torch.zeros((2, 3), dtype=torch.int64)
    with pytest.raises(ValueError, match="even"):
        TX.ivf_rerank_aug(aug, 8, q, pr, 5)
    with pytest.raises(ValueError, match="f32 or bf16"):
        TX.ivf_rerank_aug(aug.to(torch.int8), 8, q, pr[:, :2], 5)
    with pytest.raises(ValueError, match="f32 or bf16"):
        TX.augment_slab(aug.to(torch.int8), torch.zeros(64), torch.ones(64, dtype=torch.bool))
    with pytest.raises(ValueError, match="k <= 128"):
        TX._launch_aug(aug, 8, torch.zeros(2, 16 + TX.AUG), pr[:, :2], 129, True)
