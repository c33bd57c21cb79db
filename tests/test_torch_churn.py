"""CRUD churn on the port: interleaved insert / delete / query
(``tests/test_churn.py``) on ``LSHIndex`` and on ``ShardedLSHIndex`` over 8
shards (every one on the CPU), and churn that triggers compaction."""

from __future__ import annotations

import numpy as np
import pytest

from zebra_tpu_torch.config import IndexOptions
from zebra_tpu_torch.index.lsh import LSHIndex
from zebra_tpu_torch.parallel.sharded import ShardedLSHIndex


@pytest.mark.parametrize("cls,kw", [(LSHIndex, {}), (ShardedLSHIndex, {"shards": 8})],
                         ids=["LSHIndex", "ShardedLSHIndex"])
def test_churn_interleaved(rng, cls, kw):
    dim = 32
    idx = cls(dim=dim, metric="cosine",
              options=IndexOptions(num_tables=8, num_probes=8, seed=0), device="cpu", **kw)
    live: dict[bytes, np.ndarray] = {}
    for round_i in range(6):
        batch = rng.standard_normal((300, dim)).astype(np.float32)
        ids = idx.add(batch)
        live.update(zip(ids, batch))
        # delete a random third of everything live
        all_ids = list(live)
        kill = [all_ids[j] for j in rng.permutation(len(all_ids))[: len(all_ids) // 3]]
        removed = idx.remove(kill)
        assert set(removed) == set(kill)
        for i in kill:
            del live[i]
        assert len(idx) == len(live)

        # queries return only live ids, and each live row finds itself
        probe_ids = [all_ids[j] for j in rng.permutation(len(all_ids))[:10]
                     if all_ids[j] in live]
        if probe_ids:
            res = idx.search(np.stack([live[i] for i in probe_ids]), k=5)
            for qi, row in enumerate(res):
                assert row, f"round {round_i}: query returned nothing"
                returned = [i for i, _ in row]
                assert all(i in live for i in returned)
                assert returned[0] == probe_ids[qi]


def test_churn_triggers_compaction(rng):
    idx = LSHIndex(dim=16, metric="cosine",
                   options=IndexOptions(num_tables=4, num_probes=4, seed=0), device="cpu")
    ids = idx.add(rng.standard_normal((1000, 16)).astype(np.float32))
    # deleting 90% takes the tombstone share past the compaction threshold
    idx.remove(ids[:900])
    st = idx.stats()
    assert st["tombstones"] < 0.5 * st["used_slots"], f"compaction did not run: {st}"
    assert len(idx) == 100
    keep = rng.standard_normal((16,)).astype(np.float32)
    assert isinstance(idx.search(keep, 3)[0], list)
