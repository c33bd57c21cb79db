"""The port's IVF rebuild policy against the JAX package's, on the CPU.

The same rows, ids and (injected) centroids go through both packages'
``IVFIndex``: the device-sourced insert into a residual-bearing state
(bitwise the JAX function's codes and the host mirror ``quantise_pair_host``),
``rebuild()`` on every slab tier (it keeps every live row: before the policy
was ported, the refined int8 tier raised on the re-insert and was left empty),
the reason each mutation's policy names (growth, tombstones, a spare flood,
spare-critical, the memory skip) and the state after each rebuild: integer
and stored state bitwise, norms to rtol 1e-6, as in ``test_torch_ivf.py``.
``kmeans_paced`` is held to the JAX function with the JAX draws injected.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zebra_tpu.config import IndexOptions as JOptions
from zebra_tpu.index import ivf as JV
from zebra_tpu.index import ivf_host as JH
from zebra_tpu.ops import kmeans as JK
from zebra_tpu_torch.config import IndexOptions as TOptions
from zebra_tpu_torch.index import ivf as TV
from zebra_tpu_torch.index import ivf_host as TH
from zebra_tpu_torch.ops import kmeans as TKM

from test_torch_ivf import assert_state_equal, to_port

#: every IVF slab tier: refined int8 in both query modes and the array-wire tiers
TIERS = {"scan": {}, "4": dict(refine=4), "balanced": dict(dtype="bfloat16", refine=0),
         "f32": dict(dtype="float32", refine=0), "int8": dict(dtype="int8", refine=0)}


def _ids(n: int, tag: int) -> list[bytes]:
    return [bytes([tag, 1 + i // 250, 1 + i % 250]) + b"\x05" * 13 for i in range(n)]


def _inject(monkeypatch, cents: np.ndarray) -> None:
    """Both packages train to the leading k rows of ``cents``."""
    monkeypatch.setattr(JH.IVFIndex, "_train_centroids",
                        lambda self, k, data: jnp.asarray(cents[:k]))
    monkeypatch.setattr(TH.IVFIndex, "_train_centroids",
                        lambda self, k, data: torch.from_numpy(cents[:k].copy()))


def _pair(dim: int, **kw):
    return (JH.IVFIndex(dim=dim, metric="sql2", options=JOptions(seed=0, **kw)),
            TH.IVFIndex(dim=dim, metric="sql2", options=TOptions(seed=0, **kw), device="cpu"))


def _spy_rebuilds(monkeypatch) -> dict:
    """Record the reason of every rebuild either package runs."""
    seen = {"jax": [], "port": []}
    for key, cls in (("jax", JH.IVFIndex), ("port", TH.IVFIndex)):
        orig = cls.rebuild

        def spy(self, reason=None, _orig=orig, _log=seen[key]):
            _log.append(reason)
            return _orig(self, reason)

        monkeypatch.setattr(cls, "rebuild", spy)
    return seen


@pytest.mark.parametrize("metric", ["cosine", "sql2"])
def test_device_residual_insert_matches_jax_and_host(rng, metric):
    """``ivf.insert`` on a residual-bearing state quantises the pair on the
    device: the same slots and state as the JAX function, and at each placed
    slot the codes and scales of ``quantise_pair_host``."""
    x = (rng.standard_normal((600, 64)) * rng.uniform(0.1, 4.0, (600, 1))).astype(np.float32)
    x[7] = 0.0  # an all-zero row keeps scale 1
    cents = x[rng.choice(600, 16, replace=False)] + 0.01
    jst = JV.empty_state(jnp.asarray(cents), 32, 256, dtype=jnp.int8, refine=True)
    tst = to_port(jst)
    jst, jslots = JV.insert(jst, jnp.asarray(x), jnp.int32(600), spill=4, metric=metric)
    tslots = TV.insert(tst, torch.from_numpy(x), spill=4, metric=metric)
    np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))
    assert_state_equal(tst, jst)
    v8, r8, sc, rs = TV.quantise_pair_host(x)
    s = tslots.numpy()
    ok = s >= 0  # rows the full spare dropped hold no slot
    assert ok.sum() > 500
    np.testing.assert_array_equal(tst.vectors[s[ok]].numpy(), v8[ok])
    np.testing.assert_array_equal(tst.residual[s[ok]].numpy(), r8[ok])
    np.testing.assert_array_equal(tst.scales[s[ok]].numpy(), sc[ok])
    np.testing.assert_array_equal(tst.rscales[s[ok]].numpy(), rs[ok])


@pytest.mark.parametrize("tier", list(TIERS))
def test_rebuild_keeps_every_row(rng, monkeypatch, tier):
    """Fault A: ``rebuild()`` of 6000 x 64 rows keeps all 6000 on every tier,
    in the state the JAX package rebuilds (centroids injected), answering
    as it does."""
    x = rng.standard_normal((6000, 64)).astype(np.float32)
    _inject(monkeypatch, x[rng.choice(6000, 128, replace=False)] + 0.01)
    jix, tix = _pair(64, **TIERS[tier])
    ids = _ids(6000, 1)
    jix.add(x, ids=list(ids))
    tix.add(x, ids=list(ids))
    jix.rebuild("test")
    tix.rebuild("test")
    assert len(tix) == len(jix) == 6000
    assert tix._struct_gen == 1 and tix._rebuild_wanted is None
    assert_state_equal(tix.state, jix.state)
    assert all(tix._id_to_slot.get(i) == jix._id_to_slot.get(i) for i in ids[::97])
    q = x[::60]
    assert [[i for i, _ in r] for r in tix.search(q, 3)] == [[i for i, _ in r] for r in jix.search(q, 3)]


def test_growth_rebuilds_match_jax(rng, monkeypatch):
    """A bare index growing past 4x its built size rebuilds inline, at the
    same adds, for the same reason and into the same state as the JAX one."""
    x = rng.standard_normal((2200, 16)).astype(np.float32)
    _inject(monkeypatch, x[rng.choice(2200, 64, replace=False)] + 0.01)
    seen = _spy_rebuilds(monkeypatch)
    jix, tix = _pair(16, num_probes=8)
    ids = _ids(2200, 2)
    spans = [(0, 200)] + [(200 + 400 * i, 600 + 400 * i) for i in range(5)]
    for s, e in spans:
        jix.add(x[s:e], ids=ids[s:e])
        tix.add(x[s:e], ids=ids[s:e])
        assert seen["port"] == seen["jax"]
        assert (tix._built_n, tix._used_slots, tix._spare_used) == (
            jix._built_n, jix._used_slots, jix._spare_used)
        assert_state_equal(tix.state, jix.state)
    assert seen["port"] == ["growth"] and tix.state.num_clusters == 16
    assert len(tix) == 2200


def test_tombstone_compaction_matches_jax(rng, monkeypatch):
    x = rng.standard_normal((600, 16)).astype(np.float32)
    _inject(monkeypatch, x[rng.choice(600, 16, replace=False)] + 0.01)
    seen = _spy_rebuilds(monkeypatch)
    jix, tix = _pair(16)
    ids = _ids(600, 3)
    jix.add(x, ids=list(ids))
    tix.add(x, ids=list(ids))
    jix.remove(ids[:400])
    tix.remove(ids[:400])
    assert seen["port"] == seen["jax"] == ["tombstones"]
    assert tix.stats()["tombstones"] == 0 and len(tix) == 200
    assert_state_equal(tix.state, jix.state)
    hits = tix.search(x[400:420], 1)
    assert [r[0][0] for r in hits] == ids[400:420]


def test_spare_flood_matches_jax(rng, monkeypatch):
    """A wave that floods the spare of a tiny index (K=8) fires the policy on
    the spare's occupancy; both packages rebuild for the same reasons and
    end in the same state with the spare drained."""
    x = rng.standard_normal((8128, 16)).astype(np.float32)
    _inject(monkeypatch, x[rng.choice(8128, 256, replace=False)] + 0.01)
    seen = _spy_rebuilds(monkeypatch)
    jix, tix = _pair(16, num_probes=8)
    ids = _ids(8128, 4)
    for s, e in ((0, 128), (128, 8128)):
        jix.add(x[s:e], ids=ids[s:e])
        tix.add(x[s:e], ids=ids[s:e])
    assert seen["port"] == seen["jax"] and seen["port"]
    assert tix.state.num_clusters > 8 and len(tix) == 8128
    assert tix.stats()["spare_used"] <= max(0.125 * len(tix), 4096)
    assert_state_equal(tix.state, jix.state)


def test_spare_critical_reason_matches_jax(rng):
    x = rng.standard_normal((600, 16)).astype(np.float32)
    jix, tix = _pair(16)
    jix.add(x)
    tix.add(x)
    assert tix._rebuild_reason() is None and jix._rebuild_reason() is None
    for ix in (jix, tix):
        ix._spare_used = int(0.95 * ix.state.spare_capacity)
    assert tix._rebuild_reason() == jix._rebuild_reason() == "spare-critical"
    for ix in (jix, tix):  # a spare grown past 4x its sizing is critical too
        ix._spare_used = 0
        ix.state = JV.grow_spare(ix.state) if ix is jix else TV.grow_spare(ix.state)
        ix.state = JV.grow_spare(ix.state) if ix is jix else TV.grow_spare(ix.state)
    assert tix.state.spare_capacity == jix.state.spare_capacity
    assert tix._rebuild_reason() == jix._rebuild_reason()


def test_memory_skip_matches_jax(rng, monkeypatch):
    """A rebuild whose transient exceeds the budget is skipped inline (the
    tombstones stay masked, answers stay right) and resumes once the budget
    allows it, in both packages."""
    x = rng.standard_normal((600, 16)).astype(np.float32)
    ids = _ids(600, 5)
    jix, tix = _pair(16)
    jix.add(x, ids=list(ids))
    tix.add(x, ids=list(ids))
    seen = _spy_rebuilds(monkeypatch)
    monkeypatch.setattr(JH, "_STAGE_HBM_BUDGET", 0)
    monkeypatch.setattr(TH, "_STAGE_HBM_BUDGET", 0)
    jix.remove(ids[:400])
    tix.remove(ids[:400])
    assert not seen["port"] and not seen["jax"]
    assert tix._rebuild_skip_warned and jix._rebuild_skip_warned
    assert tix._rebuild_peak_bytes(200) == jix._rebuild_peak_bytes(200)
    hits = tix.search(x[400:420], 1)
    assert [r[0][0] for r in hits] == ids[400:420]
    monkeypatch.setattr(JH, "_STAGE_HBM_BUDGET", 12 << 30)
    monkeypatch.setattr(TH, "_STAGE_HBM_BUDGET", 12 << 30)
    jix.remove(ids[400:500])
    tix.remove(ids[400:500])
    assert seen["port"] == seen["jax"] == ["tombstones"]


@pytest.mark.parametrize("tier", ["scan", "balanced"])
def test_retrain_budget_terms_match_jax(tier):
    """The sizes the retrain's memory admission adds up, at 1M x 768."""
    jix, tix = _pair(768, **TIERS[tier])
    x = np.random.default_rng(0).standard_normal((300, 768)).astype(np.float32)
    jix.add(x)
    tix.add(x)
    for n, chunk in ((1_000_000, 262144), (300, 32768)):
        assert tix._retrain_bg_peak_bytes(n, chunk) == jix._retrain_bg_peak_bytes(n, chunk)
        assert tix._train_sample_target(n) == jix._train_sample_target(n)
        assert tix._rebuild_peak_bytes(n) == jix._rebuild_peak_bytes(n)
    assert tix._state_hbm_bytes() == jix._state_hbm_bytes()


@pytest.mark.parametrize("rounds", [0, 2])
def test_kmeans_paced_matches_jax(rng, rounds):
    """``kmeans_paced`` with the draws of the JAX function's plan: the same
    counts, centroids to rtol 1e-4 (sums in another order), bitwise the
    port's one-shot ``kmeans`` on the same draws, and one pacer call per
    Lloyd pass and per balance round."""
    centers = rng.standard_normal((8, 16)).astype(np.float32) * 4
    data = np.concatenate([c + 0.1 * rng.standard_normal((64, 16)) for c in centers]
                          ).astype(np.float32)
    n, k, iters = data.shape[0], 8, 6
    key = jax.random.PRNGKey(3)
    calls = []
    jc, jn = JK.kmeans_paced(key, jnp.asarray(data), jnp.int32(n), k=k, iters=iters,
                             chunk=128, balance_rounds=rounds, pacer=lambda c: c)
    draws = JK._paced_plan(key, n, jnp.int32(n), k, iters + 2 * rounds, max(k // 8, 1), rounds)
    init, reseed, split = (torch.from_numpy(np.array(d)) for d in draws)
    tc, tn = TKM.kmeans_paced(torch.from_numpy(data), n, k, iters=iters, chunk=128,
                              balance_rounds=rounds, init_idx=init, reseed_idx=reseed,
                              split_idx=split, pacer=calls.append)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-5)
    assert len(calls) == iters + rounds
    oc, on = TKM.kmeans(torch.from_numpy(data), n, k, iters=iters, chunk=128,
                        balance_rounds=rounds, init_idx=init, reseed_idx=reseed, split_idx=split)
    torch.testing.assert_close(tc, oc, rtol=0, atol=0)
    torch.testing.assert_close(tn, on, rtol=0, atol=0)


def test_shadow_trains_paced(rng, monkeypatch):
    """A shadow flagged ``_paced_train`` trains with ``kmeans_paced``."""
    used = []
    monkeypatch.setattr(TH, "kmeans_paced", lambda *a, **k: used.append(1) or TKM.kmeans(*a, **k))
    _, tix = _pair(16)
    tix.add(rng.standard_normal((300, 16)).astype(np.float32))
    shadow = tix._clone_empty()
    shadow._paced_train = True
    order, ids = tix._live_order_ids()
    shadow._shadow_begin(len(ids), tix._gather_live(order))
    shadow._shadow_ingest(tix._gather_live(order), ids)
    assert used and len(shadow) == 300
