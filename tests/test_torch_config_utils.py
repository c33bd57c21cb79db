"""The port's config and utils (``tests/test_config_utils.py``): the JSON
round trips, unknown fields, uuid7 layout and batch uniqueness,
``fsync_write`` atomicity, auto tier resolution, the tier presets, the query
wire policy and the HBM-aware capacity, each against the JAX package on the
same inputs where it computes a value."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from zebra_tpu import config as ZC
from zebra_tpu.index import ivf_host as ZH
from zebra_tpu_torch.config import DatabaseConfig, IndexOptions
from zebra_tpu_torch.index import ivf_host as TH
from zebra_tpu_torch.utils import fsync_write, next_pow2, uuid7_batch, uuid7_bytes


def test_index_options_json_roundtrip():
    kw = dict(num_tables=7, bits=9, num_probes=3, dtype="bfloat16", plane_mode="random",
              index_type="flat", rerank="pallas")
    o = IndexOptions(**kw)
    assert IndexOptions.from_json(json.loads(json.dumps(o.to_json()))) == o
    assert o.to_json() == ZC.IndexOptions(**kw).to_json()  # the same manifest words


def test_database_config_roundtrip():
    kw = dict(dim=123, metric="minkowski", metric_power=4.0, model="hash-123", shards=4)
    c = DatabaseConfig(index=IndexOptions(num_tables=3), **kw)
    assert DatabaseConfig.loads(c.dumps()) == c
    j = ZC.DatabaseConfig(index=ZC.IndexOptions(num_tables=3), **kw)
    assert DatabaseConfig.loads(j.dumps()) == c  # a JAX manifest reads in the port
    assert ZC.DatabaseConfig.loads(c.dumps()) == j  # and the reverse


def test_config_ignores_unknown_fields():
    d = DatabaseConfig(dim=8).to_json()
    d["future_field"] = 42
    d["index"]["other_future"] = "x"
    assert DatabaseConfig.from_json(d).dim == 8


def test_resolved_bits_monotone():
    o, j = IndexOptions(), ZC.IndexOptions()
    sizes = (10, 100, 10_000, 1_000_000, 10**9)
    bits = [o.resolved_bits(n) for n in sizes]
    assert bits == sorted(bits) == [j.resolved_bits(n) for n in sizes]
    # capped by the table budget, not by a fixed 16
    per_bucket = o.num_tables * (o.resolved_bucket_capacity() + 1) * 4
    assert per_bucket * 2 ** bits[-1] <= IndexOptions.TABLE_HBM_BUDGET
    assert IndexOptions.TABLE_HBM_BUDGET == ZC.IndexOptions.TABLE_HBM_BUDGET
    assert IndexOptions(bits=7).resolved_bits(10**9) == 7


def test_next_pow2():
    assert [next_pow2(x) for x in (1, 2, 3, 1024, 1025)] == [1, 2, 4, 1024, 2048]


def test_uuid7_layout_and_ordering():
    a, b = uuid7_bytes(), uuid7_bytes()
    assert len(a) == 16 and a != b
    assert a[6] >> 4 == 7  # version nibble
    assert a[8] >> 6 == 0b10  # variant
    assert a[:6] <= b[:6]  # time-ordered prefix


def test_fsync_write_atomic(tmp_path):
    p = str(tmp_path / "f.bin")
    fsync_write(p, b"one")
    fsync_write(p, b"two")
    with open(p, "rb") as f:
        assert f.read() == b"two"
    assert not [x for x in os.listdir(tmp_path) if ".tmp" in x]


def test_metric_power_flows_to_results(rng):
    from zebra_tpu.ops.distances import pairwise
    from zebra_tpu_torch.index.lsh import LSHIndex

    data = rng.standard_normal((100, 16)).astype(np.float32)
    q = rng.standard_normal((2, 16)).astype(np.float32)
    for power in (3.0, 4.0):
        idx = LSHIndex(dim=16, metric="minkowski", metric_power=power,
                       options=IndexOptions(num_tables=6, seed=0), device="cpu")
        ids = idx.add(data)
        res = idx.search(q, k=3, exact=True)
        d = np.asarray(pairwise(q, data, metric="minkowski", power=power))
        for b, row in enumerate(res):
            assert [i for i, _ in row] == [ids[j] for j in np.argsort(d[b])[:3]]


def test_uuid7_batch_format_and_uniqueness():
    ids = uuid7_batch(5000)
    assert len(ids) == 5000 and len(set(ids)) == 5000
    assert ids == sorted(ids)  # monotone within a batch: byte order is insert order
    for i in ids[:50]:
        assert len(i) == 16 and i[6] >> 4 == 0x7 and i[8] >> 6 == 0b10
    one = uuid7_bytes()
    assert one[6] >> 4 == 0x7 and one[8] >> 6 == 0b10
    assert uuid7_batch(0) == []


def test_auto_tier_resolution():
    """The bare defaults resolve at index construction, for the backend
    class built and the device it is on; the manifest keeps "auto". On the
    CPU the port's re-rank resolves to "eager" where the JAX package's
    resolves to "xla" (each package's CPU word)."""
    from zebra_tpu_torch.index import make_index
    from zebra_tpu_torch.index.lsh import LSHIndex

    opts = IndexOptions()
    assert (opts.dtype, opts.refine, opts.rerank) == ("auto", "auto", "auto")
    idx = make_index(dim=256, options=opts, device="cpu")
    want = ZC.IndexOptions().concrete(256)
    assert (idx.options.dtype, idx.options.refine) == (want.dtype, want.refine) == ("int8", "scan")
    assert idx.options.rerank == "eager" and want.rerank == "xla"
    assert idx.options.resolved_probes() == want.resolved_probes() == 2
    # a directly constructed LSHIndex resolves for what it is
    lsh = LSHIndex(dim=16, options=IndexOptions(num_tables=4), device="cpu")
    assert lsh.options.dtype == "float32" and lsh.options.refine == 0
    assert DatabaseConfig.loads(DatabaseConfig(dim=768).dumps()).index.dtype == "auto"
    ex = IndexOptions(dtype="bfloat16", refine=0, rerank="eager")
    assert ex.concrete(768) is ex


def test_tier_presets():
    for name, kw in (("fast", {}), ("balanced", {"num_probes": 8}), ("exact", {})):
        assert IndexOptions.tier(name, **kw).to_json() == ZC.IndexOptions.tier(name, **kw).to_json()
    fast = IndexOptions.tier("fast")
    assert (fast.dtype, fast.refine) == ("int8", "scan")
    bal = IndexOptions.tier("balanced", num_probes=8)
    assert bal.dtype == "bfloat16" and bal.num_probes == 8
    exact = IndexOptions.tier("exact")
    assert exact.index_type == "flat" and exact.dtype == "float32"
    with pytest.raises(ValueError, match="unknown tier"):
        IndexOptions.tier("warp")


@pytest.mark.parametrize("kw,want", [
    (dict(index_type="ivf", dtype="int8", refine="scan"), False),
    (dict(index_type="ivf", dtype="int8", refine=0), True),
    (dict(dtype="bfloat16"), True),
    (dict(dtype="float32"), False),
    (dict(index_type="ivf", dtype="int8", refine="scan", query_wire="bfloat16"), True),
    (dict(dtype="bfloat16", query_wire="float32"), False),
])
def test_query_wire_policy(kw, want):
    """auto: bf16 for reduced slabs except refined int8; bfloat16 forces it;
    float32 never."""
    assert IndexOptions(**kw).query_wire_is_bf16() == ZC.IndexOptions(**kw).query_wire_is_bf16() \
        == want


def test_resolved_capacity_hbm_aware():
    """The default cell capacity steps its padding multiplier down at scale
    so the slab fits the stage budget; the 1M x 768 sizing is unchanged.
    The port's sizing takes the same inputs to the same integers (its
    ``budget`` argument, for shards that share a card, left at the
    default)."""
    o = IndexOptions(index_type="ivf").concrete(768, index_type="ivf")
    j = ZC.IndexOptions(index_type="ivf").concrete(768, index_type="ivf")
    assert TH._STAGE_HBM_BUDGET == ZH._STAGE_HBM_BUDGET
    k1 = TH.resolved_clusters(o, 1_000_000)
    assert k1 == ZH.resolved_clusters(j, 1_000_000)
    assert TH.resolved_capacity(o, 1_000_000, k1, dim=768) == 128
    k4 = TH.resolved_clusters(o, 4_000_000)
    c4 = TH.resolved_capacity(o, 4_000_000, k4, dim=768)
    assert c4 == ZH.resolved_capacity(j, 4_000_000, k4, dim=768)
    assert TH.resolved_spare(o, 4_000_000) == ZH.resolved_spare(j, 4_000_000)
    assert TH._slot_hbm_bytes(o, 768) == ZH._slot_hbm_bytes(j, 768)
    slab = (k4 * c4 + TH.resolved_spare(o, 4_000_000)) * TH._slot_hbm_bytes(o, 768)
    assert slab <= 0.85 * TH._STAGE_HBM_BUDGET
    assert c4 * k4 >= 1.2 * 4_000_000  # real headroom over the mean load
    # dim unknown: the legacy 2x-mean sizing; an explicit capacity always wins
    assert TH.resolved_capacity(o, 4_000_000, k4) > c4
    assert TH.resolved_capacity(o, 4_000_000, k4) == ZH.resolved_capacity(j, 4_000_000, k4)
    o2 = IndexOptions(index_type="ivf", cluster_capacity=64)
    assert TH.resolved_capacity(o2, 4_000_000, k4, dim=768) == 64
