"""The flat tier and the elementwise metrics on every backend of the port,
against the JAX package, on the CPU.

Flat is an ``LSHIndex`` whose every query is the exact scan, in both
packages. Ids must be equal, except where two picks at a rank are ties of
the f32 sums (their float64 distances agree to 1e-5 of the metric's scale);
distances within 1e-5. A flat database written by the JAX package opens in
the port and answers the same. IVF with an elementwise metric places rows by
sql2 exactly as the JAX package does (the stored state is equal) and
answers as above; so does LSH, whose plane draws are the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zebra_tpu as Z
import zebra_tpu_torch as T
from zebra_tpu.config import IndexOptions as JOptions
from zebra_tpu.index.ivf_host import IVFIndex as JIVF
from zebra_tpu.index.lsh import LSHIndex as JLSH
from zebra_tpu_torch.config import IndexOptions as TOptions
from zebra_tpu_torch.index.ivf_host import IVFIndex as TIVF
from zebra_tpu_torch.index.lsh import LSHIndex as TLSH

from test_torch_distances import ELEMENTWISE, metric64
from test_torch_ivf import assert_state_equal
from test_torch_lsh import jax_draws  # noqa: F401  (fixture: the JAX plane draws)

TIE_TOL = 1e-5


def _ids(n, start=0):
    return [int(i + 1).to_bytes(16, "big") for i in range(start, start + n)]


def _scale(metric, q, rows):
    """The size an f32 sum's rounding is relative to: 1 for cosine, the
    squared norms for l2 / sql2, the distance itself for the rest."""
    if metric == "cosine":
        return 1.0
    if metric in ("l2", "sql2"):
        return float((q.astype(np.float64) ** 2).sum() + (rows.astype(np.float64) ** 2).sum(-1).max())
    return None


def assert_same_or_ties(got, want, q, row_of, metric, power=3.0):
    """``got``/``want``: ``search`` rows ``[(id, dist), ...]`` per query;
    ``row_of``: id -> stored f32 row. Equal ids, or float64 ties at each
    differing rank; distances within 1e-5 (of the metric's scale)."""
    for b, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w)
        gi, wi = [i for i, _ in g], [i for i, _ in w]
        scale = _scale(metric, q[b], np.stack([row_of[i] for i in gi + wi])) if gi else 1.0
        for r in np.nonzero([a != c for a, c in zip(gi, wi)])[0]:
            d = metric64(metric, q[b : b + 1], np.stack([row_of[gi[r]], row_of[wi[r]]]), power)[0]
            assert abs(d[0] - d[1]) <= TIE_TOL * (scale or max(abs(d).max(), 1.0)), (b, r, d)
        gd, wd = np.array([x for _, x in g]), np.array([x for _, x in w])
        if metric in ("l2", "sql2"):
            if metric == "l2":
                gd, wd = gd * gd, wd * wd
            np.testing.assert_allclose(gd, wd, rtol=0, atol=TIE_TOL * scale)
        else:
            np.testing.assert_allclose(gd, wd, rtol=TIE_TOL, atol=TIE_TOL)


def _flat_pair(dim, metric="cosine", power=3.0, **opts):
    opts = {"index_type": "flat", "seed": 0, **opts}
    return (JLSH(dim=dim, metric=metric, options=JOptions(**opts), metric_power=power),
            TLSH(dim=dim, metric=metric, options=TOptions(**opts), metric_power=power,
                 device="cpu"))


@pytest.mark.parametrize("metric", ("cosine", "l2", "sql2") + ELEMENTWISE)
def test_flat_exact_results(rng, metric):
    """``tests/test_flat.py::test_flat_exact_results`` on both packages, for
    every metric: ids as the exact order of ``pairwise``, equal across the
    packages up to ties."""
    data = rng.standard_normal((500, 32)).astype(np.float32)
    data[7] = data[3]  # an exact duplicate: a tie in every metric
    j, t = _flat_pair(32, metric, power=2.5)
    ids = _ids(500)
    j.add(data, ids=list(ids))
    t.add(data, ids=list(ids))
    q = rng.standard_normal((7, 32)).astype(np.float32)
    q[0] = data[3]
    want, got = j.search(q, k=5), t.search(q, k=5)
    row_of = dict(zip(ids, data))
    assert_same_or_ties(got, want, q, row_of, metric, 2.5)
    d = metric64(metric, q, data, 2.5)
    for b, row in enumerate(got):  # the exact order, up to f32 ties
        assert np.allclose(np.sort(d[b])[:5], [d[b][ids.index(i)] for i, _ in row],
                           rtol=TIE_TOL, atol=TIE_TOL)


def test_flat_churn_no_rebuild_loop(rng):
    j, t = _flat_pair(16)
    for n in range(5):
        x = rng.standard_normal((200, 16)).astype(np.float32)
        ids = _ids(200, 200 * n)
        assert t.add(x, ids=list(ids)) == j.add(x, ids=list(ids))
        assert t.remove(ids[:50]) == j.remove(ids[:50])
        assert t._rebuild_reason() == j._rebuild_reason()
    assert len(t) == len(j) == 5 * 150
    q = rng.standard_normal((16,)).astype(np.float32)
    assert t.search(q, 3)[0] and [i for i, _ in t.search(q, 3)[0]] == [
        i for i, _ in j.search(q, 3)[0]]


def test_flat_approx_topk(rng):
    """``approx_topk`` is accepted; the port's selection stays exact, so it
    answers as the exact flat index (the JAX package's approximate answer
    agrees with it as its own test requires)."""
    data = rng.standard_normal((2000, 32)).astype(np.float32)
    ids = _ids(2000)
    j, approx = _flat_pair(32, approx_topk=True)
    _, exact = _flat_pair(32)
    for ix in (j, approx, exact):
        ix.add(data, ids=list(ids))
    q = data[:16] + 0.01 * rng.standard_normal((16, 32)).astype(np.float32)
    ra, re = approx.search(q, 10), exact.search(q, 10)
    assert [[i for i, _ in r] for r in ra] == [[i for i, _ in r] for r in re]
    assert ra[0][0][0] == ids[0]
    agree = np.mean([len({i for i, _ in a} & {i for i, _ in b}) / 10
                     for a, b in zip(j.search(q, 10), ra)])
    assert agree >= 0.9


@pytest.mark.parametrize("metric", ["cosine", "sql2"])
def test_flat_default_precision(rng, metric):
    """``exact_precision="default"`` is f32 on the CPU (as JAX's DEFAULT on
    the CPU): the same answers as "highest"."""
    data = rng.standard_normal((600, 24)).astype(np.float32)
    q = rng.standard_normal((9, 24)).astype(np.float32)
    _, hi = _flat_pair(24, metric)
    _, lo = _flat_pair(24, metric, exact_precision="default")
    assert T.IndexOptions.tier("exact", exact_precision="default").exact_precision == "default"
    for ix in (hi, lo):
        ix.add(data, ids=_ids(600))
    assert lo.search(q, 10) == hi.search(q, 10)


def test_exact_tier_is_flat():
    jo, to = Z.IndexOptions.tier("exact"), T.IndexOptions.tier("exact")
    assert to.to_json() == jo.to_json() and to.index_type == "flat"
    ix = T.index.make_index(8, options=to, device="cpu")
    assert isinstance(ix, TLSH) and ix.options.dtype == "float32"


def test_flat_database_roundtrip(tmp_path):
    """``tests/test_flat.py::test_flat_database_roundtrip`` on the port, then
    the same documents through the JAX package: equal answers."""
    docs = [f"d{i}".encode() for i in range(40)]
    out = {}
    for pkg, kw in ((T, {"device": "cpu"}), (Z, {})):
        cfg = pkg.DatabaseConfig(dim=16, metric="l2", model="hash-16",
                                 index=pkg.IndexOptions(index_type="flat"))
        path = str(tmp_path / f"{pkg.__name__}.zebra")
        db = pkg.Database.create(path, cfg, **kw)
        db.insert_documents(docs)
        db.close()
        db2 = pkg.Database.open(path, **kw)
        assert db2.config.index.index_type == "flat"
        res = db2.query_documents([docs[3], docs[30]], 1)
        assert docs[3] in res[0].values() and docs[30] in res[1].values()
        out[pkg] = [sorted(v.values()) for v in db2.query_documents(docs[:8], 3).values()]
    assert out[T] == out[Z]


@pytest.mark.parametrize("metric", ["cosine", "manhattan", "minkowski"])
def test_jax_written_flat_database_opens_in_the_port(tmp_path, rng, metric):
    base = rng.standard_normal((1500, 48)).astype(np.float32)
    queries = base[::150] + 0.05 * rng.standard_normal((10, 48)).astype(np.float32)
    path = str(tmp_path / "j.zebra")
    cfg = Z.DatabaseConfig(dim=48, metric=metric, metric_power=2.5,
                           index=Z.IndexOptions.tier("exact"))
    jdb = Z.Database.create(path, cfg)
    ids = jdb.insert_vectors(base)
    jdb.remove(ids[:40])
    want = jdb.query(queries, 10)
    jdb.save()
    jdb.close()
    tdb = T.Database.open(path, device="cpu")
    assert tdb.config.index.index_type == "flat" and len(tdb) == 1460
    assert tdb.index.options.exact_precision == "highest"
    row_of = dict(zip(ids, base))
    assert_same_or_ties(tdb.query(queries, 10), want, queries, row_of, metric, 2.5)
    more = tdb.insert_vectors(queries)  # the reopened index takes inserts
    assert [r[0][0] for r in tdb.query(queries, 1)] == more


#: IVF tiers the elementwise metrics run on: int8 + residual in scan mode,
#: refine=4 (the elementwise refine re-scores both slabs) and the f32 slab
IVF_TIERS = {"scan": dict(refine="scan"), "4": dict(refine=4),
             "f32": dict(dtype="float32", refine=0)}


def _ivf_pair(rng, monkeypatch, metric, tier):
    x = rng.standard_normal((24, 64)).astype(np.float32)
    x = x[rng.integers(0, 24, 2000)] + 0.3 * rng.standard_normal((2000, 64)).astype(np.float32)
    cents = x[rng.choice(2000, 32, replace=False)] + 0.01
    monkeypatch.setattr(JIVF, "_train_centroids", lambda self, k, data: jnp.asarray(cents[:k]))
    monkeypatch.setattr(TIVF, "_train_centroids",
                        lambda self, k, data: torch.from_numpy(cents[:k].copy()))
    kw = dict(num_clusters=32, **IVF_TIERS[tier])
    j = JIVF(dim=64, metric=metric, options=JOptions(**kw), metric_power=2.5)
    t = TIVF(dim=64, metric=metric, options=TOptions(**kw), metric_power=2.5, device="cpu")
    return j, t, x


# every metric on the library's default tier (scan mode), two through the
# refine pass and two more on the f32 slab. hamming reads the low byte of each
# f32 bit pattern, and XLA on the CPU dequantises an int8 + residual row with
# fused multiply-adds where eager torch rounds each product: a quarter of the
# reconstructed values differ in their last bit, so hamming of those rows
# differs by design; it runs on the f32 slab
IVF_CASES = ([(m, "scan") for m in ELEMENTWISE if m != "hamming"]
             + [("manhattan", "4"), ("canberra", "4"), ("hamming", "f32"),
                ("chebyshev", "f32"), ("minkowski", "f32")])


@pytest.mark.parametrize("metric,tier", IVF_CASES)
def test_ivf_elementwise_matches_jax(rng, monkeypatch, metric, tier):
    """IVF with an elementwise metric: placement by sql2 equal to the JAX
    package's (the stored state is equal), top-10 equal up to ties of the
    stored values; exact scans likewise."""
    j, t, x = _ivf_pair(rng, monkeypatch, metric, tier)
    assert t._cell_metric == "sql2"
    ids = _ids(2000)
    j.add(x, ids=list(ids))
    t.add(x, ids=list(ids))
    j.remove(ids[:30])
    t.remove(ids[:30])
    assert_state_equal(t.state, j.state)
    st = t.state
    stored = st.vectors.double()
    if st.scales is not None:
        stored = (stored * st.scales.double()[:, None]
                  + st.residual.double() * st.rscales.double()[:, None])
    stored = stored.float().numpy()
    row_of = {i: stored[t._id_to_slot.get(i)] for i in ids[30:]}
    q = x[::100] + 0.05 * rng.standard_normal((20, 64)).astype(np.float32)
    for exact in (False, True):
        assert_same_or_ties(t.search(q, 10, exact=exact), j.search(q, 10, exact=exact), q,
                            row_of, metric, 2.5)


@pytest.mark.parametrize("metric", ELEMENTWISE)
def test_lsh_elementwise_matches_jax(rng, metric):
    """LSH on the JAX plane draws: the same tables, and the eager re-rank of
    the same candidates answers as the JAX package's, up to ties."""
    x = rng.standard_normal((200, 48)).astype(np.float32)
    x = x[rng.integers(0, 200, 1500)] + 0.5 * rng.standard_normal((1500, 48)).astype(np.float32)
    opts = {"index_type": "lsh", "num_tables": 6, "num_probes": 4}
    j = JLSH(dim=48, metric=metric, options=Z.IndexOptions(**opts), metric_power=2.5)
    t = TLSH(dim=48, metric=metric, options=T.IndexOptions(**opts), metric_power=2.5,
             device="cpu")
    ids = _ids(1500)
    j.add(x, ids=list(ids))
    t.add(x, ids=list(ids))
    np.testing.assert_array_equal(t.state.buckets.numpy(), np.asarray(j.state.buckets))
    q = x[::50] + 0.05
    row_of = dict(zip(ids, x))
    for exact in (False, True):
        assert_same_or_ties(t.search(q, 10, exact=exact), j.search(q, 10, exact=exact), q,
                            row_of, metric, 2.5)
