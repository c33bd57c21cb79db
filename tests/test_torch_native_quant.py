"""The port's native pair quantiser (``zebra_tpu_torch/native/zebra_quant.cpp``,
built with ``g++`` at first use) against its numpy path and against the JAX
package's ``quantise_pair_host``: codes and scales bitwise, on zero rows,
+-127 boundary ties and values near the f32 extremes; and the q8 log
records the refined tier writes, byte for byte the JAX package's."""

import numpy as np
import pytest

import zebra_tpu as Z
import zebra_tpu_torch as T
from zebra_tpu import db as JDB
from zebra_tpu.index import ivf as JV
from zebra_tpu_torch import db as TDB
from zebra_tpu_torch.index import ivf as TV
from zebra_tpu_torch.native import quant as NQ


def _edge_rows(rng, d):
    """Random rows plus the hard ones: all zero, exact ties at the rounding
    boundaries of the codes (x / scale = k + 0.5, +-126.5, +-127), values
    near the f32 maximum and tiny normal values."""
    x = rng.standard_normal((200, d)).astype(np.float32)
    x[0] = 0.0
    tie = np.resize(np.array([127.0, -126.5, 126.5, 0.5, -0.5, 1.5, -2.5, 3.5], np.float32), d)
    x[1] = tie  # absmax 127: scale 1, so x / scale are the ties themselves
    x[2] = tie * np.float32(2.0 ** -20)
    x[3] = np.resize(np.array([3.3e38, -3.3e38, 1.0e38, -2.0], np.float32), d)
    x[4] = np.float32(1e-30) * rng.standard_normal(d).astype(np.float32)
    x[5, :] = -7.0  # every entry at the negative bound
    x[6] = np.where(np.arange(d) % 2, np.float32(1.0), np.float32(-1.0))
    return x


def _bits(a):
    return a.view(np.uint32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("d", [1, 7, 128, 768])
def test_native_matches_numpy_and_jax_bitwise(d):
    assert NQ.available(), "g++ builds the native quantiser wherever the tests run"
    x = _edge_rows(np.random.default_rng(d), d)
    native = NQ.quantise_pair(np.ascontiguousarray(x))
    with np.errstate(all="ignore"):
        numpy_ = TV.quantise_pair_numpy(x, span=64)
        jax_ = JV.quantise_pair_host(x)
    for a, b, c in zip(native, numpy_, jax_):
        assert a.dtype == b.dtype == c.dtype and a.shape == b.shape == c.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))
        np.testing.assert_array_equal(_bits(a), _bits(c))
    assert NQ.BUILT_WITH in (["-O3", "-march=native"], ["-O2"])


@pytest.mark.parametrize("n", [1, 63, 64, 1000])
def test_threads_do_not_change_the_codes(n):
    """Row blocks split over threads (and the one-thread path below 64 rows)
    give the same bits."""
    x = np.random.default_rng(n).standard_normal((n, 96)).astype(np.float32)
    one = NQ.quantise_pair(x, threads=1)
    for threads in (0, 3, 8):
        for a, b in zip(one, NQ.quantise_pair(x, threads=threads)):
            np.testing.assert_array_equal(_bits(a), _bits(b))


def test_dispatch_and_fallback(monkeypatch):
    """``quantise_pair_host`` takes the native kernel where it built, as the
    JAX package dispatches, and the numpy path without a toolchain; both
    give the same bits and are counted by path."""
    x = np.random.default_rng(3).standard_normal((300, 40)).astype(np.float32)
    calls = dict(TV.QUANT_CALLS)
    native = TV.quantise_pair_host(x)
    assert TV.QUANT_CALLS["native"] == calls["native"] + 1
    monkeypatch.setattr(NQ, "get_lib", lambda: None)
    fallback = TV.quantise_pair_host(x)
    assert TV.QUANT_CALLS["numpy"] == calls["numpy"] + 1
    for a, b in zip(native, fallback):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    monkeypatch.undo()
    with pytest.raises(ValueError, match="float32"):
        NQ.quantise_pair(x.astype(np.float64))


def test_q8_log_records_match_jax_byte_for_byte(tmp_path, monkeypatch):
    """The refined tier's write-ahead records (host-quantised pair and
    scales, one per span) are the JAX package's bytes for the same ids and
    rows, across several spans."""
    x = np.random.default_rng(5).standard_normal((20000, 32)).astype(np.float32)
    ids = [bytes([1 + i // 250, 1 + i % 250]) + b"\x0d" * 14 for i in range(20000)]
    monkeypatch.setattr(JDB, "uuid7_batch", lambda n: ids[:n])
    monkeypatch.setattr(TDB, "uuid7_batch", lambda n: ids[:n])
    logs = []
    for pkg, kw in ((Z, {}), (T, dict(device="cpu"))):
        path = str(tmp_path / f"{pkg.__name__}.zebra")
        db = pkg.Database.create(path, pkg.DatabaseConfig(dim=32), **kw)
        db.insert_vectors(x)  # 16384-row spans: two records
        with open(path + ".d/delta.log", "rb") as f:
            logs.append(f.read())
    assert len(logs[0]) > 20000 * 2 * 32 and logs[0] == logs[1]
