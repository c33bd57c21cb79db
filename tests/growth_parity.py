"""Phase 13's growing database through either package's facade, on the CPU.

``chip_smoke.py`` phase 13 fills a database at the library defaults in 16
calls and cannot run the JAX package beside it on the card. This drive runs
the same calls through ``zebra_tpu`` or ``zebra_tpu_torch`` on the CPU at a
reduced width, so the two packages' growth can be read side by side: the
reason of every retrain, the shape after each call, and how the index
answers as grown. After every call it waits for the retrain, so both
packages are read at the same step.

    JAX_PLATFORMS=cpu python tests/growth_parity.py --package jax  > jax.jsonl
    JAX_PLATFORMS=cpu python tests/growth_parity.py --package port > port.jsonl

prints one JSON object per call and one for the end (defaults: phase 13's
rows and calls, 1,000,000 of ``make_data(1_016_384, 64, seed=0)`` in 16
calls, 16,384 held out; ``--dim 768 --calls-run 3`` stops phase 13's
own rows at the first retrain). ``tests/test_torch_retrain.py`` runs
``drive`` at a small size.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

#: phase 13's rows, held-out queries and calls, and the picks of each reading
ROWS, HELD_OUT, CALLS, PICKS = 1_000_000, 16_384, 16, 1024


def _top_ids(rows):
    return [[i for i, _ in r] for r in rows]


def quality(db, base, ids, queries, fresh_from: int, fresh_to: int, picks: int) -> dict:
    """recall@10 of ``picks`` held-out queries against the index's exact
    scan, and the top-1 self-retrieval of ``picks`` rows just inserted
    (``base[fresh_from:fresh_to]``) and of ``picks`` rows of all so far."""
    q = queries[:picks]
    approx = _top_ids(db.query(q, 10))
    exact = _top_ids(db.index.search(q, 10, exact=True))
    recall = float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(approx, exact)]))

    def own(pick):
        return float(np.mean([r[0][0] == ids[i] for r, i in zip(db.query(base[pick], 1), pick)]))

    return {"recall": recall,
            "fresh": own(np.linspace(fresh_from, fresh_to - 1, picks).astype(np.int64)),
            "self": own(np.linspace(0, fresh_to - 1, picks).astype(np.int64))}


def drive(mod, path: str, base: np.ndarray, queries: np.ndarray, bounds, picks: int = 0,
          out=None, **create_kw) -> dict:
    """Insert ``base[s:e]`` for each ``(s, e)`` of ``bounds`` through
    ``mod.Database`` (``create_kw`` passed to ``create``), waiting for the
    retrain after each call. Returns ``{"reasons": [...], "steps": [...],
    "final": {...}}``: the reason each retrain started with, and per call the
    live rows, K, C, the spare's use and capacity and the retrains committed
    (with ``picks`` > 0 also ``quality``'s readings); each step is also
    written to ``out`` as a JSON line when given."""
    db = mod.Database.create(path, mod.DatabaseConfig(dim=base.shape[1]), **create_kw)
    reasons: list = []
    once = db._retrain_once

    def spy():
        reasons.append(db.index._rebuild_wanted)
        return once()

    db._retrain_once = spy
    ids: list = []
    steps = []
    try:
        for s, e in bounds:
            t0 = time.perf_counter()
            ids += db.insert_vectors(base[s:e])
            db.wait_for_retrain(timeout=3600)
            st = db.index.stats()
            step = {"live": len(db), "K": st["clusters"], "C": st["cluster_capacity"],
                    "spare_used": st["spare_used"], "spare_capacity": st["spare_capacity"],
                    "retrains": db._retrain_count, "reasons": list(reasons),
                    "seconds": round(time.perf_counter() - t0, 3)}
            if picks:
                step.update(quality(db, base, ids, queries, s, e, picks))
            steps.append(step)
            if out is not None:
                print(json.dumps(step), file=out, flush=True)
        final = {"reason_left": db.index._rebuild_reason(), "reasons": reasons,
                 "missing": sum(i not in db.index for i in ids)}
    finally:
        db.close()
    return {"reasons": reasons, "steps": steps, "final": final}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("jax", "port"), required=True)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--calls-run", type=int, default=CALLS,
                    help="stop after this many of the calls")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from zebra_tpu_torch.utils import make_data  # the JAX package's bench.make_data bytes

    if args.package == "jax":
        import zebra_tpu as mod

        kw = {}
    else:
        import zebra_tpu_torch as mod

        kw = {"device": "cpu"}
    data = make_data(ROWS + HELD_OUT, args.dim, seed=0)
    base, queries = data[:ROWS], data[ROWS:]
    step = ROWS // CALLS
    bounds = [(c * step, (c + 1) * step) for c in range(args.calls_run)]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rec = drive(mod, os.path.join(tmp, "g.zebra"), base, queries, bounds, PICKS,
                    out=sys.stdout, **kw)
        rec["final"]["seconds"] = round(time.perf_counter() - t0, 1)
    print(json.dumps({"package": args.package, "rows": ROWS, "dim": args.dim,
                      **rec["final"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
