"""Time the host path of ONE checkout on the IVF defaults at 1M x 768: the
durable insert (with its stage split where the checkout has stage timers)
and the query surfaces at batches of 1024 and 16384, for comparing two
checkouts on one card.

Run it from the root of each checkout in turn, within one job on one card
(parent, change, change, parent), and read the lines side by side:

    python zebra_tpu_torch/tools/ab_pipeline.py LABEL [--trace DIR]

The checkout timed is the current directory's ``zebra_tpu_torch``, so one
copy of this file can time a checkout that predates it: ``cd ../parent &&
python ../change/zebra_tpu_torch/tools/ab_pipeline.py parent``. Surfaces a
checkout lacks (the pipelined ``search_stream`` / ``query_stream``, the
stage timers) are reported as absent. Data: ``utils.make_data(1_016_384,
768, seed=0)``, the first 1M rows inserted through ``insert_vectors``
(``durability="full"``), the last 16,384 the queries. QPS are host-clock
figures with host arrays in and results out (``search_arrays``: arrays;
the others: formatted results), ``db.query`` and ``query_stream`` timed in
turns (query, stream, stream, query), each after a full garbage
collection; the device query is a CUDA-event mean of ``_query_device`` on
queries already on the card. Where the checkout has the pipelined surface
it also times ``_format_results`` of one batch of 16384 with Python's
cyclic garbage collector on and paused, and prints the host operations
of one ``search_submit`` by ``torch.profiler`` (self CPU time; with
``--trace DIR`` also the Chrome trace of three ``search_arrays`` calls,
shapes recorded, as ``DIR/<LABEL>.json``), and times a 50.3 MB pinned
allocation freed and taken again. The last line is one JSON object of every
number.
"""

import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())

N_ROWS, DIM, N_QUERIES = 1_000_000, 768, 16384


def _qps(fn, n_queries: int, reps: int, warm: bool = True) -> float:
    if warm:
        fn()
    gc.collect()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return reps * n_queries / (time.perf_counter() - t0)


def _turns(a, b, n_queries: int, reps: int) -> tuple[list[float], list[float]]:
    """QPS of ``a`` and ``b`` in turns a, b, b, a (``b`` None: a twice)."""
    a()  # warm
    if b:
        b()
    ta = [_qps(a, n_queries, reps, warm=False)]
    tb = [_qps(b, n_queries, reps, warm=False) for _ in range(2)] if b else []
    ta.append(_qps(a, n_queries, reps, warm=False))
    return ta, tb


def main(label: str, trace_dir: str | None = None) -> int:
    import torch

    import zebra_tpu_torch as zt
    from zebra_tpu_torch.utils import device_sync, make_data

    if not torch.cuda.is_available():
        print("ab_pipeline: needs a CUDA card", file=sys.stderr)
        return 1
    pipelined = importlib.util.find_spec("zebra_tpu_torch.profiling") is not None
    data = make_data(N_ROWS + N_QUERIES, DIM, 0)
    base, queries = data[:N_ROWS], data[N_ROWS:]
    tmp = tempfile.mkdtemp(prefix="zebra_ab_pipeline_")
    out = {"label": label, "pipelined": pipelined}
    try:
        if pipelined:
            from zebra_tpu_torch import profiling as P

            P.GLOBAL_STATS.ops.clear()
        t0 = time.perf_counter()
        db = zt.Database.create(os.path.join(tmp, "ab.zebra"), zt.DatabaseConfig(dim=DIM))
        db.insert_vectors(base)
        device_sync()
        out["insert_s"] = time.perf_counter() - t0
        print(f"{label} insert: {N_ROWS} x {DIM} durable in {out['insert_s']:.3f} s")
        if pipelined:
            out["stages"] = {name: st["seconds"] for src in (db.stats, P.GLOBAL_STATS)
                             for name, st in src.summary().items()}
            print(f"{label} insert stages (s, host clock): " + ", ".join(
                f"{k} {v:.3f}" for k, v in out["stages"].items()))
        idx = db.index
        small = [queries[s : s + 1024] for s in range(0, N_QUERIES, 1024)]
        qt = torch.from_numpy(queries).to(idx.device)
        idx._query_device(qt, 10, False)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            idx._query_device(qt, 10, False)
        end.record()
        end.synchronize()
        out["device_query_ms"] = start.elapsed_time(end) / 10
        del qt
        out["search_arrays_qps"] = _qps(lambda: idx.search_arrays(queries, 10), N_QUERIES, 5)
        big = [queries] * 4

        def query_big():
            for b in big:
                db.query(b, 10)

        def query_small():
            for b in small:
                db.query(b, 10)

        def drain(it):
            for _ in it:
                pass

        stream_big = (lambda: drain(db.query_stream(big, 10))) if pipelined else None
        stream_small = (lambda: drain(db.query_stream(small, 10))) if pipelined else None
        out["query_qps_16384"], out["query_stream_qps_16384"] = _turns(
            query_big, stream_big, 4 * N_QUERIES, 1)
        out["query_qps_1024"], out["query_stream_qps_1024"] = _turns(
            query_small, stream_small, N_QUERIES, 2)
        if pipelined:
            out["search_stream_qps"] = _qps(lambda: drain(idx.search_stream(big, 10)),
                                            4 * N_QUERIES, 2)
            res = idx.search_arrays(queries, 10)
            t0 = time.perf_counter()
            idx._format_results(*res)
            out["format_ms_gc_on"] = (time.perf_counter() - t0) * 1e3
            gc.disable()
            try:
                t0 = time.perf_counter()
                idx._format_results(*res)
                out["format_ms_gc_paused"] = (time.perf_counter() - t0) * 1e3
            finally:
                gc.enable()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                idx.search_collect(idx.search_submit(queries, 10))
            print(f"{label} host operations of one search_submit + search_collect at batch "
                  f"{N_QUERIES} (torch.profiler, self CPU time):")
            print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=15))
            if trace_dir:
                acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
                with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
                    for _ in range(3):
                        idx.search_arrays(queries, 10)
                os.makedirs(trace_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(trace_dir, f"{label}.json"))
            t0 = time.perf_counter()
            for _ in range(10):
                torch.empty(queries.shape, dtype=torch.float32, pin_memory=True)
            out["pinned_alloc_ms"] = (time.perf_counter() - t0) * 100
            print(f"{label} a pinned buffer of {queries.nbytes / 1e6:.1f} MB taken and freed: "
                  f"{out['pinned_alloc_ms']:.3f} ms (mean of 10, host clock)")

        def fmt(v):
            return "absent" if not v else "/".join(f"{x:.0f}" for x in v)

        print(f"{label} query at batch {N_QUERIES}: device query {out['device_query_ms']:.3f} ms "
              f"(CUDA events); search_arrays {out['search_arrays_qps']:.0f} QPS; in turns "
              f"db.query {fmt(out['query_qps_16384'][:1])}, query_stream "
              f"{fmt(out['query_stream_qps_16384'])}, db.query {fmt(out['query_qps_16384'][1:])}"
              f"; search_stream {out.get('search_stream_qps', 'absent')}; _format_results "
              f"{out.get('format_ms_gc_on', 'absent')} ms, "
              f"{out.get('format_ms_gc_paused', 'absent')} ms with the collector paused")
        print(f"{label} query at batch 1024: in turns db.query {fmt(out['query_qps_1024'][:1])}, "
              f"query_stream {fmt(out['query_stream_qps_1024'])}, db.query "
              f"{fmt(out['query_qps_1024'][1:])}")
        del db, idx
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    trace = args[args.index("--trace") + 1] if "--trace" in args else None
    sys.exit(main(args[0] if args and args[0] != "--trace" else "run", trace))
