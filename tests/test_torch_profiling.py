"""The port's profiling layer (``zebra_tpu_torch/profiling.py``): the timers
and counters of the JAX package's ``profiling.py``, ``torch.profiler``
annotations and captures, and the same stage names recorded in the same
places as the JAX package for the same ``insert_vectors`` call."""

import numpy as np
import pytest

import zebra_tpu as Z
import zebra_tpu_torch as T
from zebra_tpu import profiling as JP
from zebra_tpu.index import base as JBASE
from zebra_tpu.index import ivf_host as JHOST
from zebra_tpu_torch import profiling as TP
from zebra_tpu_torch.index import base as TBASE
from zebra_tpu_torch.index import ivf_host as THOST
from zebra_tpu_torch.index.lsh import LSHIndex


def test_timed_records():
    s = TP.Stats()
    with TP.timed("op", items=10, stats=s):
        pass
    with TP.timed("op", items=5, stats=s):
        pass
    summary = s.summary()
    assert summary["op"]["calls"] == 2 and summary["op"]["items"] == 15
    assert summary["op"]["seconds"] >= 0
    assert TP.OpStats(calls=1, seconds=2.0, items=10).rate() == 5.0


def test_database_records_stats(tmp_path):
    db = T.Database.create(str(tmp_path / "s.zebra"), T.DatabaseConfig(dim=16), device="cpu")
    x = np.random.default_rng(0).standard_normal((30, 16)).astype(np.float32)
    db.insert_vectors(x)
    list(db.query_stream([x[:3], x[3:5]], 1))
    s = db.stats.summary()
    assert s["insert"]["items"] == 30 and s["insert.index"]["calls"] == 1
    assert s["query"]["calls"] == 2 and s["query"]["items"] == 5


def test_query_plan_stats():
    from zebra_tpu.index.lsh import LSHIndex as JLSH

    x = np.random.default_rng(1).standard_normal((50, 8)).astype(np.float32)
    for cls, kw, opts, prof in ((JLSH, {}, Z.IndexOptions, JP),
                                (LSHIndex, dict(device="cpu"), T.IndexOptions, TP)):
        idx = cls(dim=8, options=opts(num_tables=4, bits=5, seed=0), **kw)
        idx.add(x)
        plan = prof.query_plan_stats(idx.state, num_probes=6)
        assert plan == {"tables": 4, "probes_per_table": 6, "buckets_probed": 24,
                        "max_candidates": 24 * idx.state.bucket_capacity,
                        "bits": idx.state.bits, "bucket_rows": 32}


def test_device_trace_and_capture(tmp_path):
    """``device_trace`` is a ``record_function`` region; ``capture_trace``
    writes a Chrome trace holding it."""
    import torch

    with TP.capture_trace(str(tmp_path / "tr")) as prof:
        with TP.device_trace("zebra-region"):
            torch.ones(8).sum()
    names = {e.key for e in prof.key_averages()}
    assert "zebra-region" in names
    with open(tmp_path / "tr" / "trace.json") as f:
        assert "zebra-region" in f.read()
    with TP.device_trace("no-capture"):
        pass


def _stage_names(pkg, prof, path, x, batches, options, **kw):
    """Names the global collector and the database's stats record over the
    inserts of ``batches`` (row counts) into a fresh database."""
    prof.GLOBAL_STATS.ops.clear()
    db = pkg.Database.create(path, pkg.DatabaseConfig(dim=x.shape[1],
                                                      index=pkg.IndexOptions(**options)), **kw)
    s = 0
    for n in batches:
        db.insert_vectors(x[s : s + n])
        s += n
    names = set(prof.GLOBAL_STATS.ops), set(db.stats.ops)
    if hasattr(db, "wait_for_retrain"):  # the JAX package's background worker
        db.wait_for_retrain()
    db.close()
    return names


#: (index options, rows of each insert_vectors call); spans of 256 rows
CASES = {"scan": ({}, (300, 1000)), "balanced": (dict(dtype="bfloat16", refine=0), (300, 1000)),
         "lsh": (dict(index_type="lsh"), (300, 1000)),
         "cold-build": ({}, (2048, 600)), "cold-window": ({}, (2048,))}


@pytest.mark.parametrize("case", list(CASES))
def test_stage_names_match_jax(tmp_path, monkeypatch, case):
    """The same ``insert_vectors`` calls record the same stage names in both
    packages: a warm insert of several spans after a small first build, and
    the cold build with its prestage window ("cold-window" cuts the
    device-memory budget so that the window holds 2 of its 8 spans and the
    rest are staged live). The span width is cut to 256 rows in both, so
    that a CPU run reaches several spans and the cold build."""
    options, batches = CASES[case]
    for mod in (JBASE, JHOST, TBASE, THOST):
        monkeypatch.setattr(mod, "BATCH", 256)
    if case == "cold-window":
        for mod in (JHOST, THOST):
            monkeypatch.setattr(mod, "_STAGE_HBM_BUDGET", 1)
    x = np.random.default_rng(2).standard_normal((sum(batches), 24)).astype(np.float32)
    want = _stage_names(Z, JP, str(tmp_path / "j.zebra"), x, batches, options)
    got = _stage_names(T, TP, str(tmp_path / "t.zebra"), x, batches, options, device="cpu")
    # a rebuild's stages depend on when each package's policy fires and on
    # whether it runs inline or on the facade's retrain thread (whose stages
    # the port times as retrain.*, the JAX package not at all)
    insert_stages = [{n for n in names if not n.startswith(("rebuild.", "retrain."))}
                     for names in (got[0], want[0])]
    assert insert_stages[0] == insert_stages[1]
    assert got[1] == want[1]
    assert {"insert", "insert.index", "insert.wal"} <= got[1]
    assert {"insert.stage", "insert.dispatch", "insert.resolve"} <= got[0]
    if case.startswith("cold"):
        assert {"ivf.prestage", "ivf.train", "ivf.insert_batches"} <= got[0]
