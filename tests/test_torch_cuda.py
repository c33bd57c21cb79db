"""The torch port on a CUDA card: the hand-written kernels (IVF probe
re-rank in its int8 + residual, plain int8, bf16 and f32 slab forms, LSH
candidate re-rank in its gather and slab-major forms, one-slab wave re-rank,
augmented-slab re-rank, and the cluster-major form of the three IVF
re-ranks: int8, bf16 and f32 slabs, augmented bf16 and f32 slabs)
against their plain versions, the facade's paths through them, and the
BGE-small text tower against the CPU tower, with no device given (the card
is the default).

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

import dataclasses

import numpy as np
import pytest
import torch

import zebra_tpu_torch as T
from zebra_tpu_torch.index import ivf as TV
from zebra_tpu_torch.ops import experimental_ivf as TX
from zebra_tpu_torch.ops import ivf_cluster as IC
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


def _check(got, want, q, metric, rtol=0.0):
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
    torch.testing.assert_close(d, rd, rtol=rtol, atol=1e-5 * scale)


def _route(B, P, st, k, round_q=False):
    return "cluster" if IC.takes_cluster_form(B, P, st.dim, st.cluster_capacity,
                                              st.vectors.dtype, k, round_q) else "query"


def _pin(monkeypatch, form):
    """Pin the route: "cluster" takes every shape the cluster-major form
    fits, "query" none, "auto" leaves the rule."""
    if form != "auto":
        value = 0 if form == "cluster" else 1 << 62
        monkeypatch.setattr(IC, "MIN_PAIR_COLUMNS", {k: value for k in IC.MIN_PAIR_COLUMNS})


@pytest.mark.parametrize("form", ["query", "auto"])
@pytest.mark.parametrize("metric", ["cosine", "l2", "sql2"])
@pytest.mark.parametrize("d", [768, 100, 1536])  # int4 path, byte path, 3 chunks/lane
def test_kernel_matches_plain_version(cuda, metric, d, form, monkeypatch):
    _pin(monkeypatch, form)
    st, x = _state(cuda, d)
    q = torch.from_numpy(x[:256] + 0.05).to(cuda)
    probes = TV.select_probes(st, q, 3, metric)
    probes[0, 0] = 0  # the fully tombstoned cluster
    want_form = "query" if form == "query" else _route(256, 3, st, 10)
    for k in (10, 128):
        before, by_form = TR.LAUNCHES, dict(TR.LAUNCHES_BY_FORM)
        got = TR.ivf_rerank(st, q, probes, k, metric)
        assert TR.LAUNCHES == before + 1
        key = f"int8+residual/{want_form}"
        assert TR.LAUNCHES_BY_FORM == {**by_form, key: by_form.get(key, 0) + 1}
        _check(got, TR.ivf_rerank_reference(st, q, probes, k, metric), q, metric)


def _plain_slab(st, dtype):
    """The int8 + residual state ``st`` as a state of one slab without a
    residual: int8 codes with their scales (plain int8), or the
    reconstruction cast to bf16 / f32; norms of what the slab stores."""
    if dtype == torch.int8:
        x = st.vectors.float() * st.scales[:, None]
        return dataclasses.replace(st, norms=(x * x).sum(-1), residual=None, rscales=None)
    vec = (st.vectors.float() * st.scales[:, None]
           + st.residual.float() * st.rscales[:, None]).to(dtype)
    return dataclasses.replace(st, vectors=vec, norms=(vec.float() ** 2).sum(-1),
                               scales=None, residual=None, rscales=None)


@pytest.mark.parametrize("metric", ["cosine", "l2", "sql2"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8])
@pytest.mark.parametrize("d", [768, 101])  # 16-byte chunks (f32: 6 a lane), element path
def test_kernel_slab_forms_match_plain_version(cuda, metric, dtype, d):
    """The forms without a residual: bf16 and f32 slabs (no scales) and
    plain int8 (scales, no residual)."""
    st, x = _state(cuda, d)
    st = _plain_slab(st, dtype)
    q = torch.from_numpy(x[:256] + 0.05).to(cuda)
    probes = TV.select_probes(st, q, 4, metric)
    probes[0, 0] = 0  # the fully tombstoned cluster
    form = {torch.bfloat16: "bf16", torch.float32: "f32", torch.int8: "int8"}[dtype]
    form += "/" + _route(256, 4, st, 10)
    for k in (10, 128):
        before, by_form = TR.LAUNCHES, dict(TR.LAUNCHES_BY_FORM)
        got = TR.ivf_rerank(st, q, probes, k, metric)
        assert TR.LAUNCHES == before + 1
        assert TR.LAUNCHES_BY_FORM == {**by_form, form: by_form.get(form, 0) + 1}
        _check(got, TR.ivf_rerank_reference(st, q, probes, k, metric), q, metric)


def test_kernel_refuses_what_it_does_not_take(cuda):
    st, x = _state(cuda, 64)
    q = torch.from_numpy(x[:4]).to(cuda)
    probes = TV.select_probes(st, q, 2, "cosine")
    with pytest.raises(ValueError, match="k <= 128"):
        TR.ivf_rerank(st, q, probes, 129)
    with pytest.raises(ValueError, match="shared"):
        TR.ivf_rerank(st, q, probes.repeat(1, 500), 10)
    with pytest.raises(ValueError, match="scales"):
        TR.ivf_rerank(dataclasses.replace(st, scales=None), q, probes, 10)
    with pytest.raises(NotImplementedError, match="float16"):
        TR.ivf_rerank(dataclasses.replace(_plain_slab(st, torch.float32),
                                          vectors=st.vectors.half()), q, probes, 10)


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


TIERS = {"balanced": T.IndexOptions.tier("balanced"), "f32": T.IndexOptions(dtype="float32"),
         "int8": T.IndexOptions(dtype="int8", refine=0)}


@pytest.mark.parametrize("tier", list(TIERS))
def test_plain_tiers_go_through_the_kernel(cuda, tmp_path, tier):
    """The bf16 ("balanced"), f32 and plain int8 tiers through the facade
    with no device given: every query launches the probe kernel; removes,
    a save, a reopen and the replay of an unsaved insert hold."""
    x = _blobs(11, 4096, 128)
    path = str(tmp_path / "p.zebra")
    db = T.Database.create(path, T.DatabaseConfig(dim=128, index=TIERS[tier]))
    assert db.index.device.type == "cuda" and db.index.options.rerank == "cuda"
    ids = db.insert_vectors(x[:4000])
    before, by_form = TR.LAUNCHES, dict(TR.LAUNCHES_BY_FORM)
    top1 = db.query(x[:100], 1)
    assert TR.LAUNCHES > before
    slab = {"balanced": "bf16"}.get(tier, tier)
    grown = sum(n - by_form.get(key, 0) for key, n in TR.LAUNCHES_BY_FORM.items()
                if key.split("/")[0] == slab)
    assert grown == TR.LAUNCHES - before
    assert [row[0][0] for row in top1] == ids[:100]
    db.remove(ids[:10])
    db.save()
    ids += db.insert_vectors(x[4000:])  # logged, not saved
    want = db.query(x[10:200], 10)
    again = T.Database.open(path)
    assert len(again) == 4086 and again.index.state.vectors.dtype == db.index.state.vectors.dtype
    assert again.query(x[10:200], 10) == want


# -- kernel 4: the LSH candidate re-rank (csrc/lsh_rerank.cu) -------------------


def _lsh_inputs(device, S, W, D, B, M, dtype, seed=0):
    """A slab of clustered rows (zero columns past D), candidates with -1
    pads, masked duplicates, one zero-norm row and one all-invalid query."""
    g = torch.Generator(device=device).manual_seed(seed)
    vec = torch.zeros((S, W), device=device)
    centers = torch.randn((64, D), generator=g, device=device)
    pick = torch.randint(0, 64, (S,), generator=g, device=device)
    vec[:, :D] = centers[pick] + 0.2 * torch.randn((S, D), generator=g, device=device)
    vec[7] = 0.0
    vec = vec.to(dtype)
    norms_all = (vec.float() ** 2).sum(-1)
    cand = torch.randint(0, S, (B, M), generator=g, device=device, dtype=torch.int32)
    cand[:, ::11] = -1
    cand[1, :5] = 7  # the zero-norm row, repeated
    srt = torch.sort(cand, dim=1).values
    dup = torch.zeros_like(srt, dtype=torch.bool)
    dup[:, 1:] = srt[:, 1:] == srt[:, :-1]
    valid = ((srt >= 0) & ~dup).float()
    valid[0] = 0.0  # nothing valid at all
    norms = norms_all[torch.clamp(srt, 0, S - 1).long()]
    q = (centers[pick[:B]] + 0.1 * torch.randn((B, D), generator=g, device=device)).float()
    return vec, q.contiguous(), srt.contiguous(), norms, valid


@pytest.mark.parametrize("metric", ["cosine", "l2", "sql2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("W,D", [(768, 768), (1024, 768), (100, 100)])  # vector, stride, element path
def test_lsh_kernel_matches_plain_version(cuda, metric, dtype, W, D):
    from zebra_tpu_torch.ops import lsh_rerank as LR

    for M in (3000, 5000):  # two and three candidate tiles, the last ragged
        vec, q, cand, norms, valid = _lsh_inputs(cuda, 20000, W, D, 48, M, dtype)
        for k in (10, 128):
            before = LR.LAUNCHES
            gd, gp = LR.lsh_rerank(vec, q, cand, norms, valid, metric, k)
            assert LR.LAUNCHES == before + 1
            wd, wp = LR.lsh_rerank_reference(vec, q, cand, norms, valid, metric, k)
            gv, wv = gp >= 0, wp >= 0
            assert torch.equal(gv, wv) and not bool(gv[0].any())
            assert bool(torch.isinf(gd[~gv]).all())
            assert float((gp == wp).float().mean()) >= 0.99
            _check((gd, gp, gv), (wd, wp, wv), q, metric)


def _compacted(cand, norms, valid):
    """The valid entries of sorted rows moved to the front in their order,
    -1 pads after (the layout ``buckets._candidates`` compacts to)."""
    order = torch.sort(1.0 - valid, dim=1, stable=True).indices
    ok = torch.gather(valid, 1, order)
    cand = torch.where(ok > 0, torch.gather(cand, 1, order), torch.full_like(cand, -1))
    return cand.contiguous(), torch.gather(norms, 1, order).contiguous(), ok.contiguous()


@pytest.mark.parametrize("metric", ["cosine", "l2", "sql2"])
@pytest.mark.parametrize("W,D", [(768, 768), (1024, 768), (102, 102)])  # cp.async, stride, plain loads
@pytest.mark.parametrize("B", [48, 200])  # one ragged query group; two, the second ragged
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lsh_slab_form_matches_plain_version_and_gather_form(cuda, metric, W, D, B, dtype):
    """Sorted rows wide enough for the slab-major form: both forms against
    the plain version. 20000 rows end mid-tile (20000 = 156 * 128 + 32)."""
    from zebra_tpu_torch.ops import lsh_rerank as LR

    S = 20000
    vec, q, cand, norms, valid = _lsh_inputs(cuda, S, W, D, B, 3000, dtype)
    for args, occupied in (((cand, norms, valid), None),
                           (_compacted(cand, norms, valid), S - 100)):
        if occupied is not None:  # no valid slot at or past `occupied`
            args[2][args[0] >= occupied] = 0.0
        for k in (10, 128):
            assert LR.takes_slab_form(True, vec.dtype, k, 3000, occupied or S)
            total, slab = LR.LAUNCHES, LR.LAUNCHES_SLAB
            sd, sp = LR.lsh_rerank(vec, q, *args, metric, k, sorted_slots=True, occupied=occupied)
            assert (LR.LAUNCHES, LR.LAUNCHES_SLAB) == (total + 1, slab + 1)
            gd, gp = LR.lsh_rerank(vec, q, *args, metric, k)
            assert (LR.LAUNCHES, LR.LAUNCHES_SLAB) == (total + 2, slab + 1)
            wd, wp = LR.lsh_rerank_reference(vec, q, *args, metric, k)
            wv = wp >= 0
            for d, p in ((sd, sp), (gd, gp)):
                assert torch.equal(p >= 0, wv) and not bool((p[0] >= 0).any())
                assert bool(torch.isinf(d[~wv]).all())
                _check((d, p, p >= 0), (wd, wp, wv), q, metric)


def test_lsh_slab_form_takes_a_single_candidate_column(cuda):
    from zebra_tpu_torch.ops import lsh_rerank as LR

    vec, q, _, _, _ = _lsh_inputs(cuda, 16, 64, 64, 5, 4, torch.float32)
    cand = torch.tensor([[3], [-1], [15], [0], [7]], dtype=torch.int32, device=cuda)
    valid = torch.tensor([[1.0], [0.0], [1.0], [0.0], [1.0]], device=cuda)
    norms = (vec ** 2).sum(-1)[cand.clamp(min=0).long()]
    slab = LR.LAUNCHES_SLAB
    gd, gp = LR.lsh_rerank(vec, q, cand, norms, valid, "cosine", 3, sorted_slots=True)
    assert LR.LAUNCHES_SLAB == slab + 1
    wd, wp = LR.lsh_rerank_reference(vec, q, cand, norms, valid, "cosine", 3)
    assert torch.equal(gp, wp) and gp[:, 0].tolist() == [0, -1, 0, -1, 0]
    torch.testing.assert_close(gd, wd, rtol=1e-4, atol=1e-4)  # row 7 is zero: distance 1


def test_lsh_kernel_refuses_what_it_does_not_take(cuda):
    from zebra_tpu_torch.ops import lsh_rerank as LR

    vec, q, cand, norms, valid = _lsh_inputs(cuda, 1000, 64, 64, 4, 300, torch.float32)
    with pytest.raises(ValueError, match="k <= 128"):
        LR.lsh_rerank(vec, q, cand, norms, valid, k=129)
    with pytest.raises(ValueError, match="int32"):
        LR.lsh_rerank(vec, q, cand.long(), norms, valid)
    with pytest.raises(ValueError, match="contiguous"):
        LR.lsh_rerank(vec, q, cand.T.contiguous().T, norms, valid)
    with pytest.raises(ValueError, match="f32 or bf16"):
        LR.lsh_rerank(vec.half(), q, cand, norms, valid)
    with pytest.raises(ValueError, match="occupied"):
        LR.lsh_rerank(vec, q, cand, norms, valid, sorted_slots=True, occupied=1001)


def test_lsh_query_cuda_matches_eager_on_the_card(cuda):
    from zebra_tpu_torch.index import buckets as TB
    from zebra_tpu_torch.index.lsh import LSHIndex

    x = _blobs(3, 6000, 128)
    ix = LSHIndex(dim=128, options=T.IndexOptions(index_type="lsh"), device=cuda)
    ix.add(x)
    q = torch.from_numpy(x[::60] + 0.05).to(cuda)
    for k in (10, 128):
        a = TB.query(ix.state, q, k, num_probes=10, rerank="cuda")
        b = TB.query(ix.state, q, k, num_probes=10, rerank="eager")
        _check(a, b, q, "cosine")
    large = TB.EAGER_LARGE_K
    TB.query(ix.state, q, 129, num_probes=10, rerank="cuda")  # wider k: eager, counted
    assert TB.EAGER_LARGE_K == large + 1


def test_lsh_facade_goes_through_the_kernel(cuda, tmp_path):
    from zebra_tpu_torch.ops import lsh_rerank as LR

    x = _blobs(8, 4096, 128)
    path = str(tmp_path / "l.zebra")
    db = T.Database.create(path, T.DatabaseConfig(dim=128, index=T.IndexOptions(index_type="lsh")))
    assert db.index.options.rerank == "cuda"
    ids = db.insert_vectors(x)
    before = LR.LAUNCHES
    top1 = db.query(x[:100], 1)
    assert LR.LAUNCHES > before
    assert [row[0][0] for row in top1] == ids[:100]
    db.remove(ids[:10])
    db.save()
    again = T.Database.open(path)
    assert len(again) == 4086
    assert [row[0][0] for row in again.query(x[10:100], 1)] == ids[10:100]


# -- kernel 2: the one-slab wave re-rank (csrc/ivf_rerank_wave.cu) --------------


def _one_slab(st, dtype):
    """The int8 + residual state ``st`` as a one-slab state of ``dtype``
    (int8 keeps the pair: the wave re-rank never reads the residual)."""
    if dtype == torch.int8:
        return st
    vec = (st.vectors.float() * st.scales[:, None]
           + st.residual.float() * st.rscales[:, None]).to(dtype)
    return dataclasses.replace(st, vectors=vec, norms=(vec.float() ** 2).sum(-1),
                               scales=None, residual=None, rscales=None)


@pytest.mark.parametrize("form", ["query", "auto"])
@pytest.mark.parametrize("metric", ["cosine", "l2", "sql2"])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [768, 100])  # 16-byte chunks, element path
def test_wave_kernel_matches_plain_version(cuda, metric, dtype, d, form, monkeypatch):
    _pin(monkeypatch, form)
    st, x = _state(cuda, d)
    st = _one_slab(st, dtype)
    q = torch.from_numpy(x[:256] + 0.05).to(cuda)
    probes = TV.select_probes(st, q, 3, metric)  # odd P: no padding is needed
    probes[0, 0] = 0  # the fully tombstoned cluster
    slab = {torch.bfloat16: "bf16", torch.float32: "f32", torch.int8: "int8"}[dtype]
    key = slab + "/" + ("query" if form == "query"
                        else _route(256, 3, st, 10, round_q=dtype != torch.float32))
    for k in (10, 40, 128):
        before, by_form = TX.LAUNCHES_WAVE, dict(TX.LAUNCHES_WAVE_BY_FORM)
        got = TX.ivf_rerank_wave(st, q, probes, k, metric)
        assert TX.LAUNCHES_WAVE == before + 1
        assert TX.LAUNCHES_WAVE_BY_FORM == {**by_form, key: by_form.get(key, 0) + 1}
        _check(got, TX.ivf_rerank_wave_reference(st, q, probes, k, metric), q, metric)


def test_wave_kernel_refuses_what_it_does_not_take(cuda):
    st, x = _state(cuda, 64)
    q = torch.from_numpy(x[:4]).to(cuda)
    probes = TV.select_probes(st, q, 2, "cosine")
    with pytest.raises(ValueError, match="k <= 128"):
        TX.ivf_rerank_wave(st, q, probes, 129)
    with pytest.raises(ValueError, match="shared"):
        TX.ivf_rerank_wave(st, q, probes.repeat(1, 500), 10)
    with pytest.raises(ValueError, match="scales"):
        TX.ivf_rerank_wave(dataclasses.replace(st, scales=None), q, probes, 10)


@pytest.mark.parametrize("k", [10, 33])  # kk = 40 -> the kernel; kk = 132 -> eager
def test_refine_query_cuda2_matches_its_plain_route(cuda, k, monkeypatch):
    """refine=N through the wave kernel against the same route through the
    kernel's plain version (the eager route scores an unrounded query, so it
    is no yardstick here: the refine pass inverts whatever the coarse stage
    gave it)."""
    st, x = _state(cuda, 256)
    q = torch.from_numpy(x[::10]).to(cuda)
    kk = max(4 * k, k + 16)
    wave, probe, large = TX.LAUNCHES_WAVE, TR.LAUNCHES, TV.EAGER_LARGE_K
    a = TV.query(st, q, k, num_probes=4, rerank="cuda2", refine_k=kk)
    assert TR.LAUNCHES == probe
    assert (TX.LAUNCHES_WAVE > wave) == (kk <= 128)
    assert TV.EAGER_LARGE_K == large + (kk > 128)
    # scan mode has no wave form: "cuda2" runs the probe kernel there
    TV.query(st, q, k, num_probes=4, rerank="cuda2", refine_k=kk, refine_scan=True)
    assert TR.LAUNCHES == probe + 1
    monkeypatch.setattr(TX, "ivf_rerank_wave", TX.ivf_rerank_wave_reference)
    b = TV.query(st, q, k, num_probes=4, rerank="cuda2", refine_k=kk)
    _check(a, b, q, "cosine")


def test_refine_facade_goes_through_the_wave_kernel(cuda, tmp_path):
    x = _blobs(9, 4096, 128)
    path = str(tmp_path / "r.zebra")
    cfg = T.DatabaseConfig(dim=128, index=T.IndexOptions(refine=4, rerank="pallas2"))
    db = T.Database.create(path, cfg)
    assert db.index.options.rerank == "cuda2"
    ids = db.insert_vectors(x)
    wave, probe = TX.LAUNCHES_WAVE, TR.LAUNCHES
    top1 = db.query(x[:100], 1)
    assert TX.LAUNCHES_WAVE > wave and TR.LAUNCHES == probe
    assert [row[0][0] for row in top1] == ids[:100]
    db.remove(ids[:10])
    db.save()
    again = T.Database.open(path)
    assert again.config.index.rerank == "pallas2"  # the manifest keeps the user's word
    assert len(again) == 4086
    assert [row[0][0] for row in again.query(x[10:100], 1)] == ids[10:100]


# -- kernels 1 and 2, cluster-major form (csrc/ivf_rerank_cluster.cu) -----------


CLUSTER_FORMS = ["int8+residual", "int8", "bf16", "f32", "wave int8", "wave bf16", "wave f32"]


def _cluster_case(cuda, kind, d=768):
    """A state of the form ``kind`` and its call / plain version pair."""
    st, x = _state(cuda, d)
    dtype = {"int8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32}.get(
        kind.split()[-1])
    if kind.startswith("wave"):
        st = _one_slab(st, dtype)
        return st, x, (lambda *a, **kw: TX.ivf_rerank_wave(*a, **kw),
                       TX.ivf_rerank_wave_reference, dtype != torch.float32)
    if dtype is not None:
        st = _plain_slab(st, dtype)
    return st, x, (lambda *a, **kw: TR.ivf_rerank(*a, **kw), TR.ivf_rerank_reference, False)


@pytest.mark.parametrize("metric", ["cosine", "l2", "sql2"])
@pytest.mark.parametrize("kind", CLUSTER_FORMS)
@pytest.mark.parametrize("d", [768, 784, 128])  # whole chunks; a padded last chunk; one step
def test_cluster_form_matches_plain_version(cuda, metric, kind, d, monkeypatch):
    """The route pinned to the cluster-major form: P = 1..4 (repeated probes
    included), a hot cluster that every query probes, the fully tombstoned
    cluster, k up to 128."""
    _pin(monkeypatch, "cluster")
    st, x, (call, ref, _) = _cluster_case(cuda, kind, d)
    mod, count = (TX, "LAUNCHES_WAVE") if kind.startswith("wave") else (TR, "LAUNCHES")
    by_form = getattr(mod, count + "_BY_FORM")
    q = torch.from_numpy(x[:300] + 0.05).to(cuda)
    for P in (1, 2, 3, 4):
        probes = TV.select_probes(st, q, P, metric)
        probes[0] = 0  # only the fully tombstoned cluster
        probes[1:, 0] = 5  # a hot cluster, split over many work items
        if P > 2:
            probes[2:50, 2] = probes[2:50, 1]  # a probe repeated within a query
        for k in (10, 40, 128):
            before = sum(n for f, n in by_form.items() if f.endswith("/cluster"))
            got = call(st, q, probes, k, metric)
            assert sum(n for f, n in by_form.items() if f.endswith("/cluster")) == before + 1
            assert not bool(got[2][0].any())
            _check(got, ref(st, q, probes, k, metric), q, metric)


@pytest.mark.parametrize("kind", CLUSTER_FORMS)
def test_cluster_kernels_match_their_plain_versions(cuda, kind):
    """The items kernel against the plain work-item builder (equal), the
    scoring kernel's buffer against its plain version, and the selection
    kernel against its own on that buffer (equal)."""
    st, x, (_, _, round_q) = _cluster_case(cuda, kind)
    q = torch.from_numpy(x[:200] + 0.05).to(cuda)
    probes = TV.select_probes(st, q, 4, "sql2").to(torch.int32)
    probes[:100, 0] = 5  # a hot cluster
    for nq in (8, 16):
        got = IC.items(probes, st.num_clusters, nq)
        want = IC.work_items(probes, st.num_clusters, nq)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    residual = kind == "int8+residual"
    dist = IC.score(st, q, probes, "sql2", round_q, residual)
    want = IC.score_reference(st, q, probes, "sql2", round_q, residual)
    live = ~torch.isinf(want)
    assert torch.equal(live, ~torch.isinf(dist))
    scale = 2 * float((q * q).sum(-1).max())
    torch.testing.assert_close(dist[live], want[live], rtol=0, atol=1e-5 * scale)
    for k in (1, 10, 40, 128):
        got = IC.select(dist, probes, st.cluster_capacity, k)
        ref = IC.select_reference(dist, probes, st.cluster_capacity, k)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_cluster_form_leaves_what_it_does_not_take(cuda, monkeypatch):
    """With the route pinned to the cluster-major form, shapes it does not
    fit (D % 16; an f32 slab probed over P*C > 2048 rows) still run the
    per-query kernel."""
    _pin(monkeypatch, "cluster")
    for d, dtype, P in ((100, torch.int8, 2), (128, torch.float32, 17)):
        st, x = _state(cuda, d)
        if dtype == torch.float32:
            st = _plain_slab(st, dtype)
        q = torch.from_numpy(x[:64]).to(cuda)
        probes = TV.select_probes(st, q, P, "cosine")
        before, by_form = TR.LAUNCHES, dict(TR.LAUNCHES_BY_FORM)
        got = TR.ivf_rerank(st, q, probes, 10)
        grown = {f: n - by_form.get(f, 0) for f, n in TR.LAUNCHES_BY_FORM.items()
                 if n != by_form.get(f, 0)}
        assert TR.LAUNCHES == before + 1 and list(grown)[0].endswith("/query")
        _check(got, TR.ivf_rerank_reference(st, q, probes, 10), q, "cosine")


TIER_CONFIGS = {"defaults": T.IndexOptions(), "refine": T.IndexOptions(refine=4, rerank="pallas2"),
                "balanced": T.IndexOptions.tier("balanced"),
                "f32": T.IndexOptions(dtype="float32")}


@pytest.mark.parametrize("tier", list(TIER_CONFIGS))
def test_facade_tiers_take_the_cluster_form(cuda, tmp_path, tier, monkeypatch):
    """Each IVF tier through the facade at a batch the route sends to the
    cluster-major form: every re-rank launch is of that form, and the
    answers hold against the same queries through the per-query form."""
    x = _blobs(13, 6000, 128)
    db = T.Database.create(str(tmp_path / "t.zebra"),
                           T.DatabaseConfig(dim=128, index=TIER_CONFIGS[tier]))
    db.insert_vectors(x)
    P = db.index.options.resolved_probes()
    dtype = db.index.state.vectors.dtype
    B = -(-IC.MIN_PAIR_COLUMNS[dtype] // (P * IC.padded_dim(128)))
    qs = np.resize(x, (B, 128))  # the stored rows, over and over
    mod, count = (TX, "LAUNCHES_WAVE") if tier == "refine" else (TR, "LAUNCHES")
    by_form = getattr(mod, count + "_BY_FORM")
    before, forms = getattr(mod, count), dict(by_form)
    _, got, _ = db.index.search_arrays(qs, 10)
    n = getattr(mod, count) - before
    assert n > 0
    assert sum(v - forms.get(k, 0) for k, v in by_form.items() if k.endswith("/cluster")) == n
    _pin(monkeypatch, "query")  # every batch to the per-query form
    _, want, _ = db.index.search_arrays(qs, 10)
    assert float((got[:, 0] == want[:, 0]).mean()) >= 0.999
    assert float((got == want).mean()) >= 0.99


# -- kernel 3: the augmented-slab re-rank (csrc/ivf_rerank_aug.cu) --------------


@pytest.mark.parametrize("metric", ["cosine", "l2", "sql2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("d", [768, 100])  # 16-byte chunks; element path for bf16
def test_aug_kernel_matches_plain_version(cuda, metric, dtype, exact, d):
    st, x = _state(cuda, d)
    st = _one_slab(st, dtype)
    aug = TX.augment_slab(st.vectors, st.norms, st.valid, metric)
    assert aug.shape == (st.slab_capacity, d + TX.AUG) and aug.dtype == dtype
    q = torch.from_numpy(x[:256] + 0.05).to(cuda)
    probes = TV.select_probes(st, q, 4, metric)
    probes[0] = 0  # only the fully tombstoned cluster: nothing valid
    C = st.cluster_capacity
    for k in (10, 128):
        before = TX.LAUNCHES_AUG
        got = TX.ivf_rerank_aug(aug, C, q, probes, k, metric, exact=exact)
        assert TX.LAUNCHES_AUG == before + 1
        assert not bool(got[2][0].any())
        _check(got, TX.ivf_rerank_aug_reference(aug, C, q, probes, k, metric, exact=exact),
               q, metric)


def test_aug_kernel_refuses_what_it_does_not_take(cuda):
    st, x = _state(cuda, 64)
    aug = TX.augment_slab(_one_slab(st, torch.float32).vectors, st.norms, st.valid)
    q = torch.from_numpy(x[:4]).to(cuda)
    probes = TV.select_probes(st, q, 2, "cosine")
    with pytest.raises(ValueError, match="even"):
        TX.ivf_rerank_aug(aug, st.cluster_capacity, q, probes[:, :1], 10)
    with pytest.raises(ValueError, match="k <= 128"):
        TX.ivf_rerank_aug(aug, st.cluster_capacity, q, probes, 129)
    with pytest.raises(ValueError, match="f32 or bf16"):
        TX.ivf_rerank_aug(aug.half(), st.cluster_capacity, q, probes, 10)


#: relative tolerance of the aug tests' l2 / sql2 distances, on top of the
#: usual atol: it decides only at the planted row of :func:`_aug_sentinel`
#: (|d| ~ 1e6, where two f32 sum orders differ by ~3e-7 of it)
AUG_RTOL = 2e-6


def _aug_sentinel(st, x, q, metric):
    """``st``'s augmented slab with, in cluster 3, a live row with a large
    dot against query 1 (l2 / sql2: -2 q.v large and negative) next to a dead
    row with a larger one; query 1 probes cluster 3."""
    C = st.cluster_capacity
    st.vectors[3 * C + 4] = (40.0 * q[1]).to(st.vectors.dtype)
    st.vectors[3 * C + 5] = (80.0 * q[1]).to(st.vectors.dtype)
    st.valid[3 * C + 4], st.valid[3 * C + 5] = True, False
    st.norms.copy_((st.vectors.float() ** 2).sum(-1))
    return TX.augment_slab(st.vectors, st.norms, st.valid, metric)


@pytest.mark.parametrize("metric", ["cosine", "l2", "sql2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("d", [768, 128])  # the main path's width; one step a tile
def test_aug_cluster_form_matches_plain_version(cuda, metric, dtype, exact, d, monkeypatch):
    """Kernel 3's cluster-major form, the route pinned to it: P = 2 and 4, a
    hot cluster, the fully tombstoned cluster, k up to 128, and the sentinel
    case (a dead row beside a row with a large dot is never returned)."""
    _pin(monkeypatch, "cluster")
    st, x = _state(cuda, d)
    st = _one_slab(st, dtype)
    q = torch.from_numpy(x[:300] + 0.05).to(cuda)
    aug = _aug_sentinel(st, x, q, metric)
    C = st.cluster_capacity
    for P in (2, 4):
        probes = TV.select_probes(st, q, P, metric)
        probes[0] = 0  # only the fully tombstoned cluster
        probes[2:, 0] = 5  # a hot cluster
        probes[1, 0] = 3
        for k in (10, 40, 128):
            before, by_form = TX.LAUNCHES_AUG, dict(TX.LAUNCHES_AUG_BY_FORM)
            got = TX.ivf_rerank_aug(aug, C, q, probes, k, metric, exact=exact)
            key = ("f32" if dtype == torch.float32 else "bf16") + "/cluster"
            assert TX.LAUNCHES_AUG == before + 1
            assert TX.LAUNCHES_AUG_BY_FORM == {**by_form, key: by_form.get(key, 0) + 1}
            assert not bool(got[2][0].any())
            assert not bool((got[1][1] == 3 * C + 5).any())  # the dead row
            assert bool(torch.isfinite(got[0][got[2]]).all())
            if metric == "cosine":
                assert int(got[1][1, 0]) == 3 * C + 4
            # the large row's l2 / sql2 distance (~1e6) is held to f32 rounding
            # of its own size (rtol); every other distance to the usual atol
            _check(got, TX.ivf_rerank_aug_reference(aug, C, q, probes, k, metric, exact=exact),
                   q, metric, rtol=AUG_RTOL)


@pytest.mark.parametrize("dtype,round_q", [(torch.float32, False), (torch.bfloat16, False),
                                            (torch.bfloat16, True)])
def test_aug_cluster_kernels_match_their_plain_versions(cuda, dtype, round_q):
    """The scoring kernel's aug buffer against its plain version (BIG on the
    same entries, the raw dots within the tolerance) and the selection
    kernel's positions against its own on that buffer (equal). An f32 slab
    multiplies the f32 query either way (exact=False rounds it to f32)."""
    st, x = _state(cuda, 768)
    st = _one_slab(st, dtype)
    q = torch.from_numpy(x[:200] + 0.05).to(cuda)
    aug = _aug_sentinel(st, x, q, "sql2")
    C = st.cluster_capacity
    w = TX.aug_query(q, "sql2").contiguous()
    probes = TV.select_probes(st, q, 4, "sql2").to(torch.int32)
    probes[:100, 0] = 5  # a hot cluster
    probes[1, 0] = 3
    slab = IC.AugSlab(aug, C)
    dist = IC.score_aug(slab, w, probes, round_q)
    want = IC.score_reference(slab, w, probes, round_q=round_q)
    big = want >= TR.BIG
    assert torch.equal(big, dist >= TR.BIG) and bool((dist[big] == TR.BIG).all())
    scale = 2 * float((q * q).sum(-1).max())
    torch.testing.assert_close(dist[~big], want[~big], rtol=AUG_RTOL, atol=1e-5 * scale)
    for k in (1, 10, 40, 128):
        got = IC.select(dist, probes, C, k, positions=True)
        ref = IC.select_reference(dist, probes, C, k, positions=True)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


# -- the pipelined surfaces on the card: pinned buffers, side streams ----------


def _ivf_index(cuda, x, **options):
    from zebra_tpu_torch.index.ivf_host import IVFIndex

    idx = IVFIndex(dim=x.shape[1], options=T.IndexOptions(seed=0, **options))
    assert idx.device.type == "cuda"
    idx.add(x)
    return idx


def test_submits_collect_out_of_order_on_the_card(cuda):
    """Two batches in flight, each with its own pinned readback buffer,
    collected in the other order: each equals its own synchronous answer."""
    x = _blobs(21, 6000, 128)
    idx = _ivf_index(cuda, x)
    a, b = x[:3000] + 0.01, x[3000:] - 0.01
    want_a, want_b = idx.search_arrays(a, 10), idx.search_arrays(b, 10)
    ta, tb = idx.search_submit(a, 10), idx.search_submit(b, 10)
    for got, want in ((idx.search_collect(tb), want_b), (idx.search_collect(ta), want_a)):
        assert np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2])
        assert np.array_equal(got[0].view(np.uint32), want[0].view(np.uint32))


@pytest.mark.parametrize("tier", ["scan", "balanced"])
def test_mutations_between_submit_and_collect(cuda, tier):
    """An insert that overflows the spare (so the spare grows: new slab
    tensors), a remove of rows the batch finds, and a second insert, all
    between submit and collect: the collect answers from the state at
    submit, bitwise."""
    x = _blobs(22, 4000, 128)
    opts = dict(num_clusters=16, cluster_capacity=256, spare_capacity=1024)
    if tier == "balanced":
        opts.update(dtype="bfloat16", refine=0, num_probes=4)
    idx = _ivf_index(cuda, x, **opts)
    q = np.resize(x, (16384, 128)) + 0.01
    want = idx.search_arrays(q, 10)
    spare = idx.state.spare_capacity
    tok = idx.search_submit(q, 10)
    idx.add(_blobs(23, 3000, 128) + 3.0)  # far from every centroid's cell room
    idx.remove(idx._slot_ids.take_list(np.unique(want[1][:50, :3])))
    idx.add(_blobs(24, 500, 128))
    got = idx.search_collect(tok)
    assert idx.state.spare_capacity > spare
    assert np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2])
    assert np.array_equal(got[0].view(np.uint32), want[0].view(np.uint32))
    assert not np.array_equal(idx.search_arrays(q[:50], 10)[1], want[1][:50])


@pytest.mark.parametrize("tier", ["scan", "balanced", "f32"])
def test_pipelined_insert_equals_span_per_call_on_the_card(cuda, tier, monkeypatch):
    """Spans staged through the pinned ring on the copy stream while earlier
    spans insert, slots read back two spans behind: the state is bitwise
    that of the same spans added one call at a time (both indexes on the
    same centroids)."""
    from zebra_tpu_torch.index.ivf_host import IVFIndex

    opts = {"scan": {}, "balanced": dict(dtype="bfloat16", refine=0),
            "f32": dict(dtype="float32", refine=0)}[tier]
    x = _blobs(25, 20000, 128)
    cents = torch.from_numpy(x[:32] + 0.01).to(cuda)
    monkeypatch.setattr(IVFIndex, "_train_centroids", lambda self, k, data: cents[:k].clone())
    ids = [bytes([1 + i // 250, 1 + i % 250]) + b"\x03" * 14 for i in range(20000)]
    # a spare that takes every row the cells cannot: no row waits for a retry
    one, per = (_ivf_index(cuda, x[:4000], num_clusters=32, spare_capacity=32768, **opts)
                for _ in range(2))
    one.add(x[4000:], ids=ids[4000:], span_rows=2048)
    for s in range(4000, 20000, 2048):
        per.add(x[s : s + 2048], ids=ids[s : s + 2048])
    for name in ("counts", "vectors", "norms", "valid", "overflow", "scales", "residual",
                 "rscales"):
        a, b = getattr(one.state, name), getattr(per.state, name)
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b)), name
    assert all(one._id_to_slot.get(i) == per._id_to_slot.get(i) for i in ids[4000:])
    assert one._spare_used == per._spare_used


def test_bf16_query_wire_host_cast_equals_device_rounding(cuda):
    """The bf16 query wire casts on the host and ships bf16: the same bits
    as shipping f32 and rounding on the card, and so the same answers."""
    q = _blobs(26, 4096, 128) * 3.7
    q[0, :4] = [0.0, -0.0, 1e-40, 3.0e38]
    host = torch.from_numpy(q).to(torch.bfloat16).to(cuda)
    dev = torch.from_numpy(q).to(cuda).to(torch.bfloat16)
    assert torch.equal(host.view(torch.int16), dev.view(torch.int16))
    x = _blobs(27, 6000, 128)
    idx = _ivf_index(cuda, x, dtype="bfloat16", refine=0, num_probes=4)
    assert idx.options.query_wire_is_bf16()
    got = idx.search_arrays(q[1:], 10)
    want = idx._query_device(torch.from_numpy(q[1:]).to(cuda).to(torch.bfloat16).float(), 10,
                             False)
    assert np.array_equal(got[1], torch.where(want[2], want[1], -1).cpu().numpy())
    assert np.array_equal(got[0].view(np.uint32), want[0].cpu().numpy().view(np.uint32))


def test_ivf_submit_and_insert_do_not_sync(cuda):
    """On IVF a submit and a span's insert queue their work without a host
    sync (PyTorch's sync debug mode raises on one), so the host reaches the
    collect while the card works."""
    x = _blobs(28, 6000, 128)
    idx = _ivf_index(cuda, x)
    q = np.resize(x, (16384, 128)) + 0.01
    want = idx.search_arrays(q, 10)  # warm: allocator, pinned buffers, libraries
    staged = idx._ship_quant(TV.quantise_pair_host(_blobs(29, 500, 128)))
    torch.cuda.set_sync_debug_mode("error")
    try:
        tok = idx.search_submit(q, 10)
        slots = idx._insert_batch_dev(staged)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert slots.is_cuda and bool((slots >= 0).all())
    got = idx.search_collect(tok)
    assert np.array_equal(got[1], want[1])


def test_text_tower_on_the_card_matches_the_cpu_tower(cuda, tmp_path):
    """BGE-small at full width on the card (no device given) against the CPU
    tower with the same weights, within 1e-4 on the unit vectors; the same
    document at two batch positions and in two batch sizes gives bitwise the
    same vector; a document database answers through it."""
    from zebra_tpu_torch.models import text as MT

    card, host = MT.BGESmallEn15(), MT.BGESmallEn15(device="cpu")
    assert card.device.type == "cuda"
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(3000)]
    docs = [" ".join(rng.choice(words, int(rng.integers(8, 61)))).encode() for i in range(130)]
    got, want = card.embed_documents(docs), host.embed_documents(docs)
    assert float(np.abs(got - want).max()) <= 1e-4
    for v in (card.embed_documents(docs[70:71])[0], card.embed_documents(docs[40:100])[30]):
        assert np.array_equal(v.view(np.uint32), got[70].view(np.uint32))
    db = T.defaults.text_db(str(tmp_path / "t.zebra"))
    ids = db.insert_documents(docs)
    assert db.query_documents(docs[:8], 1) == {q: {ids[q]: docs[q]} for q in range(8)}
