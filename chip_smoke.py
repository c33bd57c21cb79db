#!/usr/bin/env python3
"""Drive the torch port of zebra-tpu once on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):

1. the card (``nvidia-smi`` name and power limit); CUDA must be available
   and TF32 off;
2. build every kernel of the main path from ``zebra_tpu_torch/csrc``;
3. kernel parity at the main path's shapes (D=768, C=128, P=2, k=10 and
   k=128, B=1024; ragged counts, tombstones, an all-invalid probe) against
   the plain torch version, and both timed at B=16384;
4. the main path at the library defaults: ``Database.create`` with
   ``DatabaseConfig(dim=768)``, ``insert_vectors`` of 1M rows, ``query`` in
   batches of 1024, recall@10 against the exact scan, self-retrieval,
   ``remove``, ``save`` and reopen — and the kernel's launch count over it.

The second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

N_ROWS = 1_000_000
DIM = 768
N_QUERIES = 16384
SEED = 0
#: kernel-vs-plain tolerance: f32 dots summed in another order
RTOL = ATOL = 1e-4
MIN_SLOT_AGREEMENT = 0.999
MIN_RECALL = 0.95


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def synthetic_state(torch, V, device, K=16384, C=128, G=65536, D=DIM, seed=SEED):
    """A random int8 + residual IVF state at the main path's sizing, with
    ragged counts, tombstones, an all-tombstoned cluster (0), an empty
    cluster (1) and one zero-norm row."""
    g = torch.Generator(device=device).manual_seed(seed)
    S = K * C + G
    st = V.empty_state(torch.zeros((K, D), device=device), C, G, dtype=torch.int8, refine=True)
    st.vectors.copy_(torch.randint(-127, 128, (S, D), generator=g, device=device, dtype=torch.int8))
    st.residual.copy_(torch.randint(-127, 128, (S, D), generator=g, device=device, dtype=torch.int8))
    st.scales.copy_(0.01 + 0.04 * torch.rand(S, generator=g, device=device))
    st.rscales.copy_(st.scales / 127.0)
    counts = torch.randint(0, C + 1, (K,), generator=g, device=device, dtype=torch.int32)
    counts[0], counts[1], counts[2] = C, 0, C // 2
    st.counts[:K] = counts
    row = torch.arange(K * C, device=device)
    live = (row % C) < counts.repeat_interleave(C)
    live &= torch.rand(K * C, generator=g, device=device) > 0.1  # tombstones
    live[:C] = False  # cluster 0: every row tombstoned
    live[2 * C] = True
    st.valid[: K * C] = live
    st.vectors[2 * C], st.residual[2 * C] = 0, 0  # a zero-norm row
    for s in range(0, S, 65536):
        x = (st.vectors[s : s + 65536].float() * st.scales[s : s + 65536, None]
             + st.residual[s : s + 65536].float() * st.rscales[s : s + 65536, None])
        st.norms[s : s + 65536] = (x * x).sum(-1)
    return st


def synthetic_probes(torch, device, B, K, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    p0 = torch.randint(0, K, (B,), generator=g, device=device)
    p1 = (p0 + torch.randint(1, K, (B,), generator=g, device=device)) % K
    probes = torch.stack([p0, p1], 1)
    probes[0] = torch.tensor([0, 1], device=device)  # nothing valid at all
    probes[1, 1] = 0  # one all-invalid probe
    probes[2, 0] = 2  # the zero-norm row's cluster
    return probes


def compare(torch, got, want):
    """(slot agreement, max |dist err|) of kernel vs plain; raises on a
    validity mismatch or a distance outside the tolerance."""
    (dg, sg, vg), (dw, sw, vw) = got, want
    check(torch.equal(vg, vw), "kernel and plain disagree on which results are valid")
    check(bool(torch.isinf(dg[~vg]).all()) and bool((sg[~vg] == -1).all()),
          "missing results must be +inf / -1")
    agree = float((sg == sw).float().mean())
    err = float((dg[vg] - dw[vw]).abs().max()) if bool(vg.any()) else 0.0
    check(bool(torch.allclose(dg[vg], dw[vw], rtol=RTOL, atol=ATOL)),
          f"distances differ beyond rtol=atol={RTOL}: max abs err {err}")
    return agree, err


def time_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_parity(torch, V, R, device, B=1024, B_time=N_QUERIES):
    """Phase 3: kernel vs plain version at the main path's shapes."""
    st = synthetic_state(torch, V, device)
    K = st.num_clusters
    g = torch.Generator(device=device).manual_seed(SEED + 1)
    q = torch.randn((B, st.dim), generator=g, device=device)
    probes = synthetic_probes(torch, device, B, K, SEED + 2)
    worst_agree, worst_err = 1.0, 0.0
    for metric, k in (("cosine", 10), ("l2", 10), ("sql2", 10), ("cosine", 128)):
        got = R.ivf_rerank(st, q, probes, k, metric)
        want = R.ivf_rerank_reference(st, q, probes, k, metric, dots="highest")
        agree, err = compare(torch, got, want)
        print(f"parity: {metric} k={k} B={B}: slot agreement {agree:.6f}, "
              f"max abs err {err:.3g}, valid results {int(got[2].sum())}")
        check(agree >= MIN_SLOT_AGREEMENT, f"slot agreement {agree} < {MIN_SLOT_AGREEMENT}")
        check(not bool(got[2][0].any()), "query 0 probes only invalid rows")
        worst_agree, worst_err = min(worst_agree, agree), max(worst_err, err)
    qt = torch.randn((B_time, st.dim), generator=g, device=device)
    pt = synthetic_probes(torch, device, B_time, K, SEED + 3)
    ms = time_ms(torch, lambda: R.ivf_rerank(st, qt, pt, 10, "cosine"), 20)
    plain_ms = time_ms(torch, lambda: R.ivf_rerank_reference(st, qt, pt, 10, "cosine"), 3)
    fill = float(st.valid[: K * st.cluster_capacity].float().mean())
    print(f"timing: ivf_rerank B={B_time} P=2 C=128 D={st.dim} k=10 (live fill {fill:.3f}): "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    del st
    torch.cuda.empty_cache()
    return {"max_abs_err": worst_err, "slot_agreement": worst_agree, "ms": ms,
            "plain_ms": plain_ms}


def main_path(torch, zt, V, R, tmp, n=N_ROWS, dim=DIM, n_queries=N_QUERIES, seed=SEED):
    """Phase 4: the library defaults through the facade. Returns the kernel
    launch count of the run."""
    import numpy as np
    from bench import make_data
    from zebra_tpu_torch.utils import device_sync

    data = make_data(n + n_queries, dim, seed)
    base, queries = data[:n], data[n:]
    path = os.path.join(tmp, "smoke.zebra")
    R.LAUNCHES = 0
    V.EAGER_LARGE_K = 0
    t0 = time.perf_counter()
    db = zt.Database.create(path, zt.DatabaseConfig(dim=dim))
    ids = db.insert_vectors(base)
    device_sync()
    build_s = time.perf_counter() - t0
    st = db.index.stats()
    print(f"insert: {n} x {dim} in {build_s:.2f} s = {n / build_s:.0f} rows/s "
          f"(durability={db.config.durability}, rerank={db.index.options.rerank}, "
          f"clusters={st['clusters']}, C={st['cluster_capacity']}, "
          f"spare={st['spare_capacity']}, spare_used={st['spare_used']}, "
          f"max load={st['max_cluster_load']}, overflow={st['overflow']})")
    check(len(db) == n and st["overflow"] == 0, "rows lost on insert")

    before = R.LAUNCHES
    t0 = time.perf_counter()
    results = []
    for s in range(0, n_queries, 1024):
        results += db.query(queries[s : s + 1024], 10)
    qs = time.perf_counter() - t0
    print(f"query: {n_queries} queries via db.query in batches of 1024: "
          f"{n_queries / qs:.0f} QPS (facade, results formatted)")
    check(R.LAUNCHES > before, "db.query did not launch the kernel")
    check(all(len(r) == 10 and all(np.isfinite(d) for _, d in r) for r in results),
          "every query must return 10 finite results")

    qt = torch.from_numpy(queries[:1024]).to(db.index.device)
    _, approx, _ = db.index.search_arrays(queries[:1024], 10)
    _, exact, _ = V.brute_force(db.index.state, qt, 10, metric=db.index.metric)
    exact = exact.cpu().numpy()
    recall = float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(approx, exact)]))
    print(f"recall@10: {recall:.4f} over 1024 held-out queries (vs the exact scan "
          f"of the stored reconstruction)")
    check(recall >= MIN_RECALL, f"recall@10 {recall} < {MIN_RECALL}")

    pick = np.linspace(0, n - 1, 256).astype(np.int64)
    hits = db.query(base[pick], 1)
    self_rate = float(np.mean([h[0][0] == ids[i] for h, i in zip(hits, pick)]))
    print(f"self-retrieval: {self_rate:.4f} over 256 inserted rows")
    check(self_rate == 1.0, "an inserted row did not retrieve itself")

    gone = ids[1000:1100]
    db.remove(gone)
    back = {i for row in db.query(base[1000:1100], 10) for i, _ in row} & set(gone)
    print(f"remove: 100 ids removed, {len(back)} came back")
    check(not back and len(db) == n - 100, "a removed id came back")

    probe_q = queries[:1024]
    want = [[i for i, _ in row] for row in db.query(probe_q, 10)]
    t0 = time.perf_counter()
    db.save()
    save_s = time.perf_counter() - t0
    del db
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    db = zt.Database.open(path)
    open_s = time.perf_counter() - t0
    got = [[i for i, _ in row] for row in db.query(probe_q, 10)]
    print(f"save {save_s:.2f} s, open {open_s:.2f} s: same top-10 ids after reopen: {got == want}")
    check(got == want and len(db) == n - 100, "reopened database answers differently")

    big = queries[:n_queries]
    db.index.search_arrays(big, 10)  # warm
    t0 = time.perf_counter()
    for _ in range(3):
        db.index.search_arrays(big, 10)  # returns host arrays: synchronised
    dev_qps = 3 * n_queries / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    db.query(big, 10)
    facade_qps = n_queries / (time.perf_counter() - t0)
    print(f"query: batch {n_queries}: {dev_qps:.0f} QPS (index.search_arrays, "
          f"device synchronised), {facade_qps:.0f} QPS (db.query, results formatted)")
    launches = R.LAUNCHES
    print(f"launches: ivf_rerank {launches} over the main path; eager large-k "
          f"fallbacks {V.EAGER_LARGE_K}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script runs "
              "on a CUDA card only", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import zebra_tpu_torch as zt
        from zebra_tpu_torch.index import ivf as V
        from zebra_tpu_torch.ops import _kernels
        from zebra_tpu_torch.ops import ivf_rerank as R
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run from the repository root",
              file=sys.stderr)
        return 1

    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    print(smi[0])
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls must stay off")
    device = torch.device("cuda", 0)

    # phase 2: build
    t0 = time.perf_counter()
    _kernels.load("ivf_rerank")
    print(f"build: ivf_rerank in {time.perf_counter() - t0:.2f} s")
    for line in _kernels.BUILD_LOG.get("ivf_rerank", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")

    # phase 3: kernel parity and timing
    rec = kernel_parity(torch, V, R, device)

    # phase 4: the main path
    tmp = tempfile.mkdtemp(prefix="zebra_smoke_")
    try:
        launches = main_path(torch, zt, V, R, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(launches > 0, "the main path never launched ivf_rerank")

    print(json.dumps({"kernels": [{
        "name": "ivf_rerank",
        "route": "cuda",
        "source": "zebra_tpu_torch/csrc/ivf_rerank.cu",
        "replaces": "zebra_tpu/ops/pallas_ivf.py:72",
        "launches": launches,
        "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"],
        "plain_ms": rec["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
