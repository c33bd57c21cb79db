"""The torch port on a CUDA card: the hand-written kernel against its plain
version, and the facade's main path through it.

Imports neither JAX nor the JAX package, so it runs where only torch is
installed. Every test needs a card and skips without one; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance for kernel vs plain: f32 dots summed in another order. Cosine
distances agree to rtol/atol 1e-4; l2 / sql2 are |q|^2 + |x|^2 - 2<q,x>, whose
rounding is ~1e-5 of |q|^2 + |x|^2 rather than of the small difference, so
squared distances agree to 1e-5 of that scale. On clustered data at k=128
neighbours sit within that rounding of each other, so slots agree on >= 99%
of positions (near-ties may swap), and validity exactly.
"""

import numpy as np
import pytest
import torch

import zebra_tpu_torch as T
from zebra_tpu_torch.index import ivf as TV
from zebra_tpu_torch.ops import ivf_rerank as TR

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _blobs(seed, n, d):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((24, d)).astype(np.float32)
    return centers[rng.integers(0, 24, n)] + 0.2 * rng.standard_normal((n, d)).astype(np.float32)


def _state(device, d, n=3000, K=32, C=128, seed=0):
    """An int8 + residual state built by the port's own insert, with ragged
    blocks, tombstones and one fully tombstoned cluster."""
    x = _blobs(seed, n, d)
    g = torch.Generator().manual_seed(seed)
    cents = torch.from_numpy(x[torch.randperm(n, generator=g)[:K].numpy()]).to(device)
    st = TV.empty_state(cents, C, 1024, dtype=torch.int8, refine=True)
    v8, r8, sc, rs = TV.quantise_pair_host(x)
    parts = [torch.from_numpy(a).to(device) for a in (v8, r8, np.stack([sc, rs], 1))]
    slots = TV.insert_quant(st, *parts, spill=8, metric="cosine")
    TV.delete_slots(st, slots[::9])
    st.valid[:C] = False
    return st, x


def _check(got, want, q, metric):
    (d, s, v), (rd, rs, rv) = got, want
    assert torch.equal(v, rv)
    assert bool((s[~v] == -1).all()) and bool(torch.isinf(d[~v]).all())
    assert float((s == rs).float().mean()) >= 0.99
    d, rd = d[v], rd[rv]
    if metric == "cosine":
        torch.testing.assert_close(d, rd, rtol=1e-4, atol=1e-4)
        return
    if metric == "l2":
        d, rd = d * d, rd * rd
    scale = 2 * float((q * q).sum(-1).max())
    torch.testing.assert_close(d, rd, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("metric", ["cosine", "l2", "sql2"])
@pytest.mark.parametrize("d", [768, 100, 1536])  # int4 path, byte path, 3 chunks/lane
def test_kernel_matches_plain_version(cuda, metric, d):
    st, x = _state(cuda, d)
    q = torch.from_numpy(x[:256] + 0.05).to(cuda)
    probes = TV.select_probes(st, q, 3, metric)
    probes[0, 0] = 0  # the fully tombstoned cluster
    for k in (10, 128):
        before = TR.LAUNCHES
        got = TR.ivf_rerank(st, q, probes, k, metric)
        assert TR.LAUNCHES == before + 1
        _check(got, TR.ivf_rerank_reference(st, q, probes, k, metric), q, metric)


def test_kernel_refuses_what_it_does_not_take(cuda):
    st, x = _state(cuda, 64)
    q = torch.from_numpy(x[:4]).to(cuda)
    probes = TV.select_probes(st, q, 2, "cosine")
    with pytest.raises(ValueError, match="k <= 128"):
        TR.ivf_rerank(st, q, probes, 129)
    with pytest.raises(ValueError, match="shared"):
        TR.ivf_rerank(st, q, probes.repeat(1, 500), 10)


def test_query_cuda_matches_eager_on_the_card(cuda):
    st, x = _state(cuda, 256)
    q = torch.from_numpy(x[::10]).to(cuda)
    a = TV.query(st, q, 10, num_probes=2, rerank="cuda", refine_scan=True)
    b = TV.query(st, q, 10, num_probes=2, rerank="eager", refine_scan=True)
    _check(a, b, q, "cosine")


def test_facade_goes_through_the_kernel(cuda, tmp_path):
    x = _blobs(7, 4096, 128)
    db = T.Database.create(str(tmp_path / "g.zebra"), T.DatabaseConfig(dim=128))
    assert db.index.options.rerank == "cuda"
    ids = db.insert_vectors(x)
    before = TR.LAUNCHES
    top1 = db.query(x[:100], 1)
    assert TR.LAUNCHES > before
    assert [row[0][0] for row in top1] == ids[:100]
    db.remove(ids[:10])
    db.save()
    again = T.Database.open(str(tmp_path / "g.zebra"))
    assert len(again) == 4086
    assert [row[0][0] for row in again.query(x[10:100], 1)] == ids[10:100]
