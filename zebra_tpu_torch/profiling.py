"""Tracing, timing and per-operation statistics (port of
``zebra_tpu/profiling.py``).

Lightweight timing context managers feeding per-database and global stage
tables, ``torch.profiler`` annotations and captures for device timelines,
and the LSH query-plan estimate. The stage names are the JAX package's, in
the same places, so the two packages' stage tables read alike.
"""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass, field

logger = logging.getLogger("zebra_tpu_torch")


@dataclass
class OpStats:
    """Running counters for one operation kind."""

    calls: int = 0
    seconds: float = 0.0
    items: int = 0

    def rate(self) -> float:
        return self.items / self.seconds if self.seconds else 0.0


@dataclass
class Stats:
    """Per-database operation counters (attach via ``Database.stats``)."""

    ops: dict[str, OpStats] = field(default_factory=dict)

    def record(self, name: str, seconds: float, items: int = 0) -> None:
        s = self.ops.setdefault(name, OpStats())
        s.calls += 1
        s.seconds += seconds
        s.items += items

    def summary(self) -> dict[str, dict]:
        return {
            k: {"calls": v.calls, "seconds": round(v.seconds, 4),
                "items": v.items, "items_per_sec": round(v.rate(), 1)}
            for k, v in sorted(self.ops.items())
        }


GLOBAL_STATS = Stats()


@contextlib.contextmanager
def timed(name: str, items: int = 0, stats: Stats | None = None):
    """Time a block on the host clock; records into ``stats`` (default: the
    global collector) and logs at DEBUG. Device work the block only queues
    is not waited for: a stage that ends in a readback carries its wait."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        (stats or GLOBAL_STATS).record(name, dt, items)
        logger.debug("%s: %.3fms (%d items)", name, dt * 1e3, items)


@contextlib.contextmanager
def device_trace(name: str):
    """Annotate a region in the ``torch.profiler`` timeline (near-zero cost
    when no trace is being captured)."""
    import torch

    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def capture_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the enclosed block (host, and
    the card's kernels and copies where CUDA is available) and write it to
    ``log_dir`` as a Chrome trace (``trace.json``). Yields the profiler, so
    a caller can also read ``key_averages()``."""
    import os

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def query_plan_stats(state, num_probes: int) -> dict:
    """Static per-query work estimate for an LSH state's shape: the 'buckets
    probed / candidates scanned' observability knob."""
    T = state.num_tables
    cap = state.bucket_capacity
    return {
        "tables": T,
        "probes_per_table": num_probes,
        "buckets_probed": T * num_probes,
        "max_candidates": T * num_probes * cap,
        "bits": state.bits,
        "bucket_rows": state.num_rows,
    }
