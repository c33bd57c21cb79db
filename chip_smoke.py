#!/usr/bin/env python3
"""Drive the torch port of zebra-tpu once on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):

1. the card (``nvidia-smi`` name and power limit); CUDA must be available
   and TF32 off;
2. build every kernel of the two paths from ``zebra_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together);
3. IVF kernel parity at its main path's shapes (D=768, C=128, P=2, k=10 and
   k=128, B=1024; ragged counts, tombstones, an all-invalid probe) against
   the plain torch version, and both timed at B=16384;
4. the IVF path at the library defaults: ``Database.create`` with
   ``DatabaseConfig(dim=768)``, ``insert_vectors`` of 1M rows, ``query`` in
   batches of 1024, recall@10 against the exact scan, self-retrieval,
   ``remove``, ``save`` and reopen — and the kernel's launch count over it;
5. LSH kernel parity (D=768, B=1024, candidate widths 3000 and 65,536, k=10
   and k=128, three metrics, f32 and bf16 slabs; -1 pads, masked duplicates,
   an all-invalid query, a zero-norm row) against the plain torch version,
   and both timed at B=16384 at both widths;
6. the LSH path at its library defaults: ``DatabaseConfig(dim=768,
   index=IndexOptions(index_type="lsh"))``, ``insert_vectors`` of the same 1M
   rows, ``query`` in batches of 1024, recall@10 against the exact scan,
   self-retrieval, ``remove``, ``save`` and reopen, ``search_arrays`` at
   batch 16384, the kernel's launch count over it; then, on the path's own
   candidates of 1024 held-out queries (deep buckets are compacted
   losslessly, see ``index/lsh.py``), the kernel against its plain version
   at k=10 and k=128, both timed, the stages of one device query timed by
   CUDA events, and the LSH search beside the exact scan.

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
from concurrent.futures import ThreadPoolExecutor

N_ROWS = 1_000_000
DIM = 768
N_QUERIES = 16384
SEED = 0
#: kernel-vs-plain tolerance: f32 dots summed in another order
RTOL = ATOL = 1e-4
MIN_SLOT_AGREEMENT = 0.999
#: where kernel and plain pick different candidates at a rank, the two
#: picks' distances recomputed in f64 must agree within this (relative to
#: 1 + |d|): a swap of near-equal distances by f32 summation order
TIE_TOL = 1e-5
MIN_RECALL = 0.95
#: LSH guards, not targets: a broken bucket scatter measured 0.48 on the TPU
MIN_LSH_RECALL = 0.85
MIN_LSH_SELF = 0.99


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


def tie_gap(torch, vectors, q, cand, norms, got_pos, want_pos, metric):
    """(ranks where kernel and plain pick different candidates, the largest
    gap between the two picks' distances recomputed in f64, relative to
    1 + |d|); raises if a gap exceeds TIE_TOL."""
    b, r = torch.nonzero(got_pos != want_pos, as_tuple=True)
    if b.numel() == 0:
        return 0, 0.0
    qq = q[b].double()
    qn2 = (qq * qq).sum(-1)

    def d64(pos):
        p = pos[b, r]
        dot = (vectors[cand[b, p].long(), : q.shape[1]].double() * qq).sum(-1)
        n2 = norms[b, p].double()
        if metric == "cosine":
            return 1.0 - dot / torch.sqrt(torch.clamp(qn2 * n2, min=1e-30))
        d2 = torch.clamp(qn2 + n2 - 2.0 * dot, min=0.0)
        return torch.sqrt(d2) if metric == "l2" else d2

    dg, dw = d64(got_pos), d64(want_pos)
    gap = float(((dg - dw).abs() / (1.0 + dw.abs())).max())
    check(gap <= TIE_TOL, f"kernel and plain pick candidates {gap} apart (> {TIE_TOL}): "
          "not a tie")
    return b.numel(), gap


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


def main_path(torch, zt, V, R, tmp, base, queries):
    """Phase 4: the library defaults through the facade. Returns the kernel
    launch count of the run."""
    import numpy as np
    from zebra_tpu_torch.utils import device_sync

    (n, dim), n_queries = base.shape, queries.shape[0]
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


def lsh_candidates(torch, device, S, B, M, seed):
    """Synthetic LSH candidates ``(cand int32, valid f32)`` ``[B, M]``.
    M=3000 has the shape of an uncompacted probe set: sorted random slots
    with -1 pads and masked duplicates (~90% valid). Wider sets have the
    compacted shape: 1..8192 valid slots first (a masked duplicate among
    them), -1 after. Query 0 has nothing valid; query 1 holds slot 7."""
    g = torch.Generator(device=device).manual_seed(seed)
    cand = torch.randint(0, S, (B, M), generator=g, device=device, dtype=torch.int32)
    col = torch.arange(M, device=device)
    if M <= 4096:
        cand[:, ::11] = -1
        cand[:, 1::13] = cand[:, 2::13][:, : cand[:, 1::13].shape[1]]  # duplicates
        cand = torch.sort(cand, dim=1).values
        valid = cand >= 0
        valid[:, 1:] &= cand[:, 1:] != cand[:, :-1]
    else:
        live = torch.randint(1, 8193, (B, 1), generator=g, device=device)
        cand[:, 1] = cand[:, 0]
        valid = col[None, :] < live
        valid[:, 1] = False
        cand = torch.where(valid | (col[None, :] == 1), cand, torch.full_like(cand, -1))
    cand[1, 0], valid[1, 0] = 7, True
    valid[0] = False
    return cand.contiguous(), valid.float().contiguous()


def lsh_kernel_parity(torch, LR, device, S=2 * 1024 * 1024, D=DIM, B=1024, B_time=N_QUERIES):
    """Phase 5: kernel 4 against its plain version on a slab of the main
    path's size (2M x 768; slot 7 a zero row), at both candidate widths."""
    g = torch.Generator(device=device).manual_seed(SEED + 4)
    slab = torch.randn((S, D), generator=g, device=device)
    slab[7] = 0.0
    q = torch.randn((B_time, D), generator=g, device=device)
    worst_agree, worst_err, times = 1.0, 0.0, {}
    for M in (3000, 65536):
        cand, valid = lsh_candidates(torch, device, S, B_time, M, SEED + M)
        idx = torch.clamp(cand, 0, S - 1).long()
        for dtype in (torch.float32, torch.bfloat16):
            vec = slab if dtype == torch.float32 else slab.to(dtype)
            norms = (vec.float() ** 2).sum(-1)[idx]
            args = (vec, q[:B], cand[:B], norms[:B].contiguous(), valid[:B])
            for metric in ("cosine", "l2", "sql2"):
                for k in (10, 128):
                    gd, gp = LR.lsh_rerank(*args, metric=metric, k=k)
                    wd, wp = LR.lsh_rerank_reference(*args, metric=metric, k=k)
                    agree, err = compare(torch, (gd, gp, gp >= 0), (wd, wp, wp >= 0))
                    check(agree >= MIN_SLOT_AGREEMENT,
                          f"position agreement {agree} < {MIN_SLOT_AGREEMENT}")
                    check(not bool((gp[0] >= 0).any()), "query 0 has no valid candidate")
                    worst_agree, worst_err = min(worst_agree, agree), max(worst_err, err)
            print(f"parity: lsh_rerank M={M} {str(dtype)[6:]} slab, 3 metrics x k=10/128, "
                  f"B={B}: worst position agreement {worst_agree:.6f}, "
                  f"max abs err {worst_err:.3g}")
            if dtype == torch.float32:
                full = (slab, q, cand, norms, valid)
                ms = time_ms(torch, lambda: LR.lsh_rerank(*full, k=10), 5 if M <= 4096 else 2)
                plain_ms = time_ms(torch, lambda: LR.lsh_rerank_reference(*full, k=10), 1)
                n_valid = float(valid.sum())
                bound = (B_time * M * 4 + n_valid * (8 + D * 4)) / 3.35e12 * 1e3
                print(f"timing: lsh_rerank B={B_time} M={M} D={D} f32 k=10 "
                      f"({n_valid / B_time:.0f} valid candidates per query): kernel "
                      f"{ms:.3f} ms, plain {plain_ms:.3f} ms; bytes bound at 3.35 TB/s "
                      f"{bound:.3f} ms")
                times[M] = (ms, plain_ms)
            del vec, norms, args
        del cand, valid, idx
    del slab, q
    torch.cuda.empty_cache()
    return {"max_abs_err": worst_err, "times": times}


def lsh_path(torch, zt, TB, LR, tmp, base, queries):
    """Phase 6: the LSH library defaults through the facade. Returns the
    kernel launch count of the run, and the kernel's max abs error against
    its plain version and both times on the path's own candidates of 1024
    held-out queries."""
    import numpy as np
    from zebra_tpu_torch.utils import device_sync

    (n, dim), n_queries = base.shape, queries.shape[0]
    path = os.path.join(tmp, "lsh.zebra")
    cfg = zt.DatabaseConfig(dim=dim, index=zt.IndexOptions(index_type="lsh"))
    LR.LAUNCHES = 0
    TB.EAGER_LARGE_K = 0
    t0 = time.perf_counter()
    db = zt.Database.create(path, cfg)
    ids = db.insert_vectors(base)
    device_sync()
    build_s = time.perf_counter() - t0
    idx = db.index
    st = idx.stats()
    probes = idx.options.resolved_probes()
    full = st["tables"] * probes * st["bucket_capacity"]
    mc, lossless = idx._candidate_width(probes)
    width = "lossless compaction" if lossless else (mc or "all")
    print(f"lsh insert: {n} x {dim} in {build_s:.2f} s = {n / build_s:.0f} rows/s "
          f"(durability={db.config.durability}, rerank={idx.options.rerank}, "
          f"tables={st['tables']}, bits={st['bits']}, bucket capacity="
          f"{st['bucket_capacity']} (cap_boost {st['cap_boost']}), probes={probes}, "
          f"candidate width: {width} of T*P*C={full}, slab={st['slab_capacity']}, "
          f"overflow={st['overflow']})")
    check(len(db) == n and idx.options.rerank == "cuda", "LSH insert lost rows or rerank")
    qt = torch.from_numpy(queries[:1024]).to(idx.device)
    t0 = time.perf_counter()
    cand, cand_valid = TB._candidates(idx.state, qt, probes, mc, lossless)
    device_sync()
    cand_s = time.perf_counter() - t0
    live = cand_valid.sum(1).float()
    print(f"lsh candidates: {float(live.mean()):.0f} valid of {cand.shape[1]} per query "
          f"(min {int(live.min())}, max {int(live.max())}; 1024 held-out queries; "
          f"candidate stage {cand_s * 1e3:.1f} ms)")
    del cand, cand_valid

    t0 = time.perf_counter()
    results = []
    for s in range(0, n_queries, 1024):
        results += db.query(queries[s : s + 1024], 10)
    qs = time.perf_counter() - t0
    print(f"lsh query: {n_queries} queries via db.query in batches of 1024: "
          f"{n_queries / qs:.0f} QPS (facade, results formatted)")
    check(LR.LAUNCHES > 0, "db.query did not launch lsh_rerank")
    check(all(len(r) == 10 and all(np.isfinite(d) for _, d in r) for r in results),
          "every LSH query must return 10 finite results")

    _, approx, _ = idx.search_arrays(queries[:1024], 10)
    _, exact, _ = TB.brute_force(idx.state, qt, 10, metric=idx.metric)
    exact = exact.cpu().numpy()
    recall = float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(approx, exact)]))
    print(f"lsh recall@10: {recall:.4f} over 1024 held-out queries (vs the exact f32 scan "
          f"of the stored slab)")
    check(recall >= MIN_LSH_RECALL, f"LSH recall@10 {recall} < {MIN_LSH_RECALL}")

    pick = np.linspace(0, n - 1, 256).astype(np.int64)
    hits = db.query(base[pick], 1)
    missed = [int(i) for h, i in zip(hits, pick) if not h or h[0][0] != ids[i]]
    self_rate = 1.0 - len(missed) / len(pick)
    held = [int((idx.state.buckets == idx._id_to_slot._dict[ids[i]]).any(-1).any(-1).sum())
            for i in missed]
    print(f"lsh self-retrieval: {self_rate:.4f} over 256 inserted rows; overflow "
          f"{st['overflow']} bucket entries displaced; the missed rows sit in "
          f"{held} of {st['tables']} tables")
    check(self_rate >= MIN_LSH_SELF, f"LSH self-retrieval {self_rate} < {MIN_LSH_SELF}")

    gone = ids[1000:1100]
    db.remove(gone)
    back = {i for row in db.query(base[1000:1100], 10) for i, _ in row} & set(gone)
    print(f"lsh remove: 100 ids removed, {len(back)} came back")
    check(not back and len(db) == n - 100, "a removed id came back")

    probe_q = queries[:1024]
    want = [[i for i, _ in row] for row in db.query(probe_q, 10)]
    t0 = time.perf_counter()
    db.save()
    save_s = time.perf_counter() - t0
    del db, idx
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    db = zt.Database.open(path)
    open_s = time.perf_counter() - t0
    got = [[i for i, _ in row] for row in db.query(probe_q, 10)]
    print(f"lsh save {save_s:.2f} s, open {open_s:.2f} s: same top-10 ids after reopen: "
          f"{got == want}")
    check(got == want and len(db) == n - 100, "reopened LSH database answers differently")

    big = queries[:n_queries]
    db.index.search_arrays(big, 10)  # warm
    t0 = time.perf_counter()
    for _ in range(3):
        db.index.search_arrays(big, 10)  # returns host arrays: synchronised
    dev_qps = 3 * n_queries / (time.perf_counter() - t0)
    print(f"lsh query: batch {n_queries}: {dev_qps:.0f} QPS (index.search_arrays, "
          f"device synchronised)")
    launches, large_k = LR.LAUNCHES, TB.EAGER_LARGE_K
    print(f"launches: lsh_rerank {launches} over the LSH path; eager large-k "
          f"fallbacks {large_k}")
    check(launches > 0 and large_k == 0, "the LSH path must run through lsh_rerank")

    # the path's own candidates of the 1024 held-out queries (these launches
    # come after the count was read): the kernel against its plain version,
    # then the stages of one device query and the exact scan, by CUDA events
    idx = db.index
    state, S = idx.state, idx.state.slab_capacity
    mc, lossless = idx._candidate_width(probes)
    full = state.num_tables * probes * state.bucket_capacity
    cand, cvalid = TB._candidates(state, qt, probes, mc, lossless)

    def prepare():
        c = cand.int().contiguous()
        return c, state.norms[torch.clamp(c, 0, S - 1).long()], cvalid.float()

    c, norms, valid = prepare()
    args = (state.vectors, qt, c, norms, valid)
    # clustered data: hundreds of candidates sit at nearly one distance, so
    # f32 summation order swaps some of them; every differing rank must be
    # such a tie
    worst_err = 0.0
    for k in (10, 128):
        gd, gp = LR.lsh_rerank(*args, metric=idx.metric, k=k)
        wd, wp = LR.lsh_rerank_reference(*args, metric=idx.metric, k=k)
        agree, err = compare(torch, (gd, gp, gp >= 0), (wd, wp, wp >= 0))
        swaps, gap = tie_gap(torch, state.vectors, qt, c, norms, gp, wp, idx.metric)
        print(f"parity: lsh_rerank on the path's candidates, k={k}: position agreement "
              f"{agree:.6f}, max abs err {err:.3g}, valid results {int((gp >= 0).sum())}; "
              f"{swaps} differing ranks, all ties (largest f64 gap {gap:.3g} <= {TIE_TOL})")
        worst_err = max(worst_err, err)
        del gd, gp, wd, wp
    ms = time_ms(torch, lambda: LR.lsh_rerank(*args, k=10), 5)
    plain_ms = time_ms(torch, lambda: LR.lsh_rerank_reference(*args, k=10), 1)
    n_valid = float(valid.sum())
    B = c.shape[0]
    bound = (c.numel() * 4 + n_valid * (8 + dim * 4)) / 3.35e12 * 1e3
    print(f"timing: lsh_rerank on the path's candidates, B={B} M={c.shape[1]} "
          f"({n_valid / B:.0f} valid per query): kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms; bytes bound at 3.35 TB/s {bound:.3f} ms")
    del args, c, norms, valid, cand, cvalid
    torch.cuda.empty_cache()
    cand_ms = time_ms(torch, lambda: TB._candidates(state, qt, probes, mc, lossless), 2)
    cand, cvalid = TB._candidates(state, qt, probes, mc, lossless)
    prep_ms = time_ms(torch, prepare, 3)
    del cand, cvalid
    torch.cuda.empty_cache()
    passes = -(-B // TB._query_chunk_rows(state, B, full, eager=False))
    query_ms = time_ms(torch, lambda: idx._query_device(qt, 10, exact=False), 2)
    exact_ms = time_ms(torch, lambda: idx._query_device(qt, 10, exact=True), 2)
    print(f"lsh stages, {B} queries, one device query ({passes} passes of the free-memory "
          f"split): whole {query_ms:.3f} ms; candidate stage on all {B} at once "
          f"{cand_ms:.3f} ms, candidate casts and norm gather {prep_ms:.3f} ms, kernel "
          f"{ms:.3f} ms; exact scan (buckets.brute_force) {exact_ms:.3f} ms")
    t0 = time.perf_counter()
    idx.search_arrays(queries[:B], 10)
    lsh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.search_arrays(queries[:B], 10, exact=True)
    exact_s = time.perf_counter() - t0
    print(f"lsh vs exact, {B} queries through index.search_arrays: LSH {lsh_s * 1e3:.1f} ms, "
          f"exact scan {exact_s * 1e3:.1f} ms (host clock, synchronised)")
    del db, idx, state
    torch.cuda.empty_cache()
    return launches, worst_err, ms, plain_ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script runs "
              "on a CUDA card only", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import zebra_tpu_torch as zt
        from bench import make_data
        from zebra_tpu_torch.index import buckets as TB
        from zebra_tpu_torch.index import ivf as V
        from zebra_tpu_torch.ops import _kernels
        from zebra_tpu_torch.ops import ivf_rerank as R
        from zebra_tpu_torch.ops import lsh_rerank as LR
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

    # phase 2: build, one nvcc per kernel, all at once
    kernels = ("ivf_rerank", "lsh_rerank")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(_kernels.load, kernels))
    print(f"build: {', '.join(kernels)} in {time.perf_counter() - t0:.2f} s")
    for name in kernels:
        for line in _kernels.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    # phase 3: IVF kernel parity and timing
    rec = kernel_parity(torch, V, R, device)

    t0 = time.perf_counter()
    data = make_data(N_ROWS + N_QUERIES, DIM, SEED)
    base, queries = data[:N_ROWS], data[N_ROWS:]
    print(f"data: {N_ROWS} + {N_QUERIES} x {DIM} (bench.make_data, seed {SEED}) in "
          f"{time.perf_counter() - t0:.2f} s")

    # phase 4: the IVF path
    tmp = tempfile.mkdtemp(prefix="zebra_smoke_")
    try:
        launches = main_path(torch, zt, V, R, tmp, base, queries)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(launches > 0, "the main path never launched ivf_rerank")

    # phase 5: LSH kernel parity and timing
    lsh_rec = lsh_kernel_parity(torch, LR, device)

    # phase 6: the LSH path
    tmp = tempfile.mkdtemp(prefix="zebra_smoke_lsh_")
    try:
        lsh_launches, path_err, lsh_ms, lsh_plain_ms = lsh_path(
            torch, zt, TB, LR, tmp, base, queries)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    print(json.dumps({"kernels": [{
        "name": "ivf_rerank",
        "route": "cuda",
        "source": "zebra_tpu_torch/csrc/ivf_rerank.cu",
        "replaces": "zebra_tpu/ops/pallas_ivf.py:72",
        "launches": launches,
        "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"],
        "plain_ms": rec["plain_ms"],
    }, {
        "name": "lsh_rerank",
        "route": "cuda",
        "source": "zebra_tpu_torch/csrc/lsh_rerank.cu",
        "replaces": "zebra_tpu/ops/pallas_rerank.py:48",
        "launches": lsh_launches,
        "max_abs_err": max(lsh_rec["max_abs_err"], path_err),
        "ms": lsh_ms,
        "plain_ms": lsh_plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
