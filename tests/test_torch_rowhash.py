"""Row hashing and deduplication on the port (``ops/rowhash.py``,
``find_duplicates`` / ``deduplicate``) against the JAX package: the hashes
bitwise on f32, bf16 and int8 slabs with negative entries, the same ids
found with planted duplicates on every IVF tier and on LSH, and a
``Database.deduplicate`` that was never saved replaying from ``delta.log``
on reopen, in both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zebra_tpu as Z
import zebra_tpu_torch as T
from zebra_tpu.index import make_index as jax_make_index
from zebra_tpu.ops.rowhash import row_hashes as jax_row_hashes
from zebra_tpu_torch.index import make_index
from zebra_tpu_torch.ops import rowhash as RH


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("width", [1, 5, 130, 768])
def test_row_hashes_match_jax_bitwise(dtype, width, monkeypatch):
    """Two 32-bit keys a row, bitwise the JAX package's: int32 products that
    wrap, logical right shifts, the column salt and the XOR fold; rows in
    several chunks."""
    monkeypatch.setattr(RH, "_CHUNK_ROWS", 7)
    rng = np.random.default_rng(width)
    x = (rng.standard_normal((40, width)) * 50).astype(np.float32)
    x[0] = 0.0
    x[1] = -x[2]
    if dtype == "int8":
        host = np.clip(np.rint(x), -127, 127).astype(np.int8)
        jx, tx = jnp.asarray(host), torch.from_numpy(host)
    elif dtype == "bfloat16":
        jx = jnp.asarray(x).astype(jnp.bfloat16)
        tx = torch.from_numpy(x).to(torch.bfloat16)
        assert np.array_equal(np.asarray(jx).view(np.uint16), tx.view(torch.int16).numpy().view(
            np.uint16))
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    want = np.asarray(jax_row_hashes(jx))
    got = RH.row_hashes(tx)
    assert got.dtype == torch.int32 and got.shape == (40, 2)
    np.testing.assert_array_equal(got.numpy(), want)


TIERS = {"scan": {}, "4": dict(refine=4), "balanced": dict(dtype="bfloat16", refine=0),
         "f32": dict(dtype="float32", refine=0), "int8": dict(dtype="int8", refine=0),
         "lsh": dict(index_type="lsh"), "lsh-bf16": dict(index_type="lsh", dtype="bfloat16")}


@pytest.mark.parametrize("tier", list(TIERS))
def test_find_duplicates_matches_jax(tier):
    """Planted exact copies (some of them inserted before their original, so
    the kept id is the smallest, not the first slot) and a near copy one ulp
    away: both packages name the same ids, and ``deduplicate`` removes
    exactly those."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1200, 64)).astype(np.float32)
    src = rng.choice(1000, 60, replace=False)
    x[1000:1060] = x[src]
    x[1060:1120] = x[src[:60]]  # a third copy of each
    x[1120] = np.nextafter(x[5], np.float32(np.inf))
    ids = [bytes([1 + (i * 7919) % 250, 1 + i // 250]) + b"\x0e" * 14 for i in range(1200)]
    jix = jax_make_index(dim=64, options=Z.IndexOptions(seed=0, **TIERS[tier]))
    tix = make_index(dim=64, options=T.IndexOptions(seed=0, **TIERS[tier]), device="cpu")
    jix.add(x, ids=list(ids))
    tix.add(x, ids=list(ids))
    want = jix.find_duplicates()
    got = tix.find_duplicates()
    assert got == want and len(got) >= 120
    groups = {}
    for i, row in zip(ids, x):
        groups.setdefault(row.tobytes(), []).append(i)
    planted = {i for g in groups.values() if len(g) > 1 for i in sorted(g)[1:]}
    assert planted <= set(got)  # quantised tiers may also merge the near copy
    assert tix.deduplicate() == got and len(tix) == 1200 - len(got)
    assert tix.find_duplicates() == []


def test_deduplicate_replays_from_the_log(tmp_path):
    """``Database.deduplicate`` logs the removal before it runs; a database
    closed without a save replays inserts and removal on reopen, in the port
    and in the JAX package."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((500, 32)).astype(np.float32)
    x[400:450] = x[:50]
    path = str(tmp_path / "d.zebra")
    db = T.Database.create(path, T.DatabaseConfig(dim=32), device="cpu")
    ids = db.insert_vectors(x)
    db.deduplicate()
    assert len(db) == 450 and not set(ids[400:450]) & {i for r in db.query(x[:50], 5)
                                                      for i, _ in r}
    want = db.query(x[:100], 5)
    del db  # no save: the snapshot is the empty one create() wrote
    again = T.Database.open(path, device="cpu")
    assert len(again) == 450 and again.query(x[:100], 5) == want
    assert [r[0][0] for r in want] == ids[:100]  # the smallest id of each group stays
    jdb = Z.Database.open(path)  # trains its own centroids on replay
    found = jdb.query(x[:100], 5)
    assert len(jdb) == 450 and [r[0][0] for r in found] == ids[:100]
    assert not set(ids[400:450]) & {i for r in found for i, _ in r}
