"""Parity of the port's hashing (``zebra_tpu_torch.ops.hashing``) with the
JAX package's, on the CPU, from the same seeded numpy inputs.

Codes and probe sets are equal except for bits whose activation is within
1e-5 of zero (both hash in f32, summed in another order). Planes built from
injected JAX draws agree within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zebra_tpu.ops import hashing as JH
from zebra_tpu_torch.ops import hashing as TH

ACT_TOL = 1e-5


def _jax_planes(seed, T, b, D):
    p, c = JH.sample_planes_random(jax.random.PRNGKey(seed), T, b, D)
    return np.asarray(p), np.asarray(c)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_hash_activations_match_jax(rng):
    x = rng.standard_normal((512, 64)).astype(np.float32)
    planes, _ = _jax_planes(0, 4, 12, 64)
    consts = rng.standard_normal((4, 12)).astype(np.float32)
    want = np.asarray(JH.hash_activations(jnp.asarray(x), jnp.asarray(planes), jnp.asarray(consts)))
    got = TH.hash_activations(_t(x), _t(planes), _t(consts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T,b,D", [(6, 10, 64), (3, 16, 128), (1, 1, 8)])
def test_hash_codes_match_jax_away_from_zero(rng, T, b, D):
    x = rng.standard_normal((1024, D)).astype(np.float32)
    planes, consts = _jax_planes(1, T, b, D)
    want = np.asarray(JH.hash_codes(jnp.asarray(x), jnp.asarray(planes), jnp.asarray(consts)))
    got = TH.hash_codes(_t(x), _t(planes), _t(consts)).numpy()
    acts = np.asarray(JH.hash_activations(jnp.asarray(x), jnp.asarray(planes), jnp.asarray(consts)))
    near = (np.abs(acts) < ACT_TOL).any(-1)  # [n, T]: a bit at rounding level
    np.testing.assert_array_equal(got[~near], want[~near])
    assert got.dtype == np.int64 and got.min() >= 0 and got.max() < 2**b


def test_pack_signs_matches_jax_exactly(rng):
    acts = rng.standard_normal((64, 5, 16)).astype(np.float32)
    acts[0, 0, :4] = 0.0  # >= 0 packs as 1
    want = np.asarray(JH.pack_signs(jnp.asarray(acts)))
    np.testing.assert_array_equal(TH.pack_signs(_t(acts)).numpy(), want)


@pytest.mark.parametrize("num_probes", [1, 2, 8, 10, 16])
def test_multiprobe_matches_jax(rng, num_probes):
    acts = rng.standard_normal((128, 6, 12)).astype(np.float32)
    acts[1, 2, :] = 0.25  # equal margins: stable order on both sides
    want = np.asarray(JH.multiprobe(jnp.asarray(acts), num_probes))
    got = TH.multiprobe(_t(acts), num_probes).numpy()
    np.testing.assert_array_equal(got, want)


def test_multiprobe_narrow_codes_and_bad_width(rng):
    acts = rng.standard_normal((16, 2, 3)).astype(np.float32)  # b < largest probe bit
    want = np.asarray(JH.multiprobe(jnp.asarray(acts), 16))
    np.testing.assert_array_equal(TH.multiprobe(_t(acts), 16).numpy(), want)
    for bad in (0, TH.MAX_PROBES + 1):
        with pytest.raises(ValueError):
            TH.multiprobe(_t(acts), bad)


def _jax_data_draws(seed, T, b, n, width):
    k_pairs, k_fb = jax.random.split(jax.random.PRNGKey(seed))
    pairs = np.array(jax.random.randint(k_pairs, (T, b, 2), 0, n))
    fallback = np.array(jax.random.normal(k_fb, (T, b, width), dtype=jnp.float32))
    return pairs, fallback


@pytest.mark.parametrize("distinct", [3, 500])  # 3 rows: many degenerate pairs
def test_sample_planes_data_matches_jax_with_injected_draws(rng, distinct):
    T, b, D, n = 5, 9, 32, 500
    base = rng.standard_normal((distinct, D)).astype(np.float32)
    data = base[rng.integers(0, distinct, n)]
    wp, wc = JH.sample_planes_data(jax.random.PRNGKey(7), T, b, jnp.asarray(data))
    draws = _jax_data_draws(7, T, b, n, D)
    gp, gc = TH.sample_planes_data(T, b, _t(data), draws=draws)
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=1e-6, atol=1e-6)


def test_sample_planes_data_padded_width_matches_jax_on_padded_rows(rng):
    """Pairs gathered at the logical width and zero-padded equal JAX's
    planes over rows stored padded (an explicit "pallas" LSH slab)."""
    T, b, D, W, n = 3, 6, 24, 64, 200
    data = rng.standard_normal((n, D)).astype(np.float32)
    data[5] = data[6]  # some pairs may coincide
    padded = np.zeros((n, W), np.float32)
    padded[:, :D] = data
    wp, wc = JH.sample_planes_data(jax.random.PRNGKey(3), T, b, jnp.asarray(padded))
    gp, gc = TH.sample_planes_data(T, b, _t(data), draws=_jax_data_draws(3, T, b, n, W), width=W)
    assert gp.shape == (T, b, W)
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=1e-6, atol=1e-6)


def test_sample_planes_random_matches_jax_with_injected_normals():
    T, b, D = 4, 11, 48
    key = jax.random.PRNGKey(5)
    wp, wc = JH.sample_planes_random(key, T, b, D)
    normals = np.array(jax.random.normal(key, (T, b, D), dtype=jnp.float32))
    gp, gc = TH.sample_planes_random(T, b, D, normals=normals)
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


def test_generator_draws_are_reproducible(rng):
    data = _t(rng.standard_normal((100, 16)).astype(np.float32))
    a = TH.sample_planes_data(3, 8, data, generator=torch.Generator().manual_seed(9))
    b = TH.sample_planes_data(3, 8, data, generator=torch.Generator().manual_seed(9))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    p, _ = TH.sample_planes_random(3, 8, 16, generator=torch.Generator().manual_seed(9))
    torch.testing.assert_close(torch.linalg.vector_norm(p, dim=-1), torch.ones(3, 8))
