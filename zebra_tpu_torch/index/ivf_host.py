"""Host orchestration of the IVF backend (port of ``zebra_tpu/index/ivf_host.py``).

Sizing (the same formulas, so a database sizes identically in both
packages), the cold build (train k-means on a sample of the leading spans,
then allocate, then insert), the two wires, spare growth on overflow, the
device query and the snapshot arrays. Every slab tier of the JAX package:

* refined int8 (int8 coarse slab + int8 residual) ships host-quantised
  ``(v8, r8, [scale, rscale])`` (the q8 wire and WAL record), in both query
  modes: ``refine="scan"`` — the library default, the residual streamed
  through the probe kernel — and ``refine=N``, an oversampled scan of the
  coarse slab alone followed by the gather-refine pass (``ivf._refine_topk``);
* the bf16 slab (``IndexOptions.tier("balanced")``), the f32 slab and plain
  int8 (``refine=0``) ship rows on the base's array wire (bf16, f32 and bf16
  respectively) and ``ivf.insert`` casts or quantises them on the device.

Inserts run through the base's pipeline: on the quantised wire each span is
quantised on the host by the native kernel (``native/zebra_quant.cpp``, the
numpy emulation where no toolchain built it), shipped through the pinned
ring, logged while its copy is in flight, and inserted without a host sync
(``ivf._write_plan``). The cold build stages an HBM-budgeted window of spans
before it trains.

The rebuild policy (``zebra_tpu/index/ivf_host.py:693-823``): after every
mutation :meth:`IVFIndex._rebuild_reason` names, in this order,
"spare-critical" (the spare nearly full, or grown past 4x its sizing),
"growth" (live rows past 4x the built size), "tombstones" (above half the
allocated slots) and "spare-pressure". A bare index rebuilds inline when the
transient fits ``_STAGE_HBM_BUDGET``; under the Database facade the reason
goes to its background retrain, which trains the shadow with
``kmeans_paced`` and ingests captured rows through ``ivf.insert`` (on the
refined tier its device quantisation of the pair).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from zebra_tpu_torch.config import IndexOptions
from zebra_tpu_torch.index import ivf as V
from zebra_tpu_torch.index.base import BATCH, BaseVectorIndex, Staged
from zebra_tpu_torch.ops import distances as D
from zebra_tpu_torch.ops.kmeans import kmeans, kmeans_paced
from zebra_tpu_torch.profiling import timed
from zebra_tpu_torch.utils import next_pow2

logger = logging.getLogger(__name__)

#: device-memory budget of the capacity sizing and of the cold build's
#: prestage window (the JAX package's 16 GB-chip figure, kept so both
#: packages size a database identically; at 1M x 768 it binds neither: the
#: window holds every span)
_STAGE_HBM_BUDGET = 12 << 30
#: retrain when live vectors outgrow the built size by this factor
_REBUILD_GROWTH = 4.0
#: compact when tombstones exceed this fraction of allocated slots
_COMPACT_TOMBSTONES = 0.5
#: spare-growth retries per batch before giving up
_MAX_GROWS = 8


def resolved_clusters(options: IndexOptions, n: int) -> int:
    """Partition count for ~n vectors: ~n/64 per cell, power of two."""
    if options.num_clusters > 0:
        return options.num_clusters
    return int(min(next_pow2(max(n // 64, 8)), 131072, next_pow2(max(n // 4, 8))))


def _slot_hbm_bytes(options: IndexOptions, dim: int) -> int:
    """Device bytes one slab slot costs (scales/norms/valid lumped as 13 B)."""
    if options.dtype == "int8":
        per = dim * (2 if options.refine_enabled() else 1)
    elif options.dtype == "bfloat16":
        per = 2 * dim
    else:
        per = 4 * dim
    return per + 13


def resolved_capacity(options: IndexOptions, n: int, k: int, dim: int = 0,
                      budget: int = _STAGE_HBM_BUDGET) -> int:
    """Per-cluster block width: 2x the mean load rounded up to 32 rows (16
    for f32/bf16), stepping the multiplier down to 1.25x until the slab fits
    85% of ``budget`` (``_STAGE_HBM_BUDGET``; a sharded index whose shards
    share a device passes each its share)."""
    unit = 32 if options.dtype == "int8" else 16
    if options.cluster_capacity > 0:
        return options.cluster_capacity
    mean = -(-n // k)

    def rup(x: float) -> int:
        return max(-(-int(x) // unit) * unit, unit)

    if dim <= 0:
        return rup(2 * mean)
    spare = resolved_spare(options, n)
    budget = int(0.85 * budget)
    per = _slot_hbm_bytes(options, dim)
    cap = unit
    for mult in (2.0, 1.75, 1.5, 1.375, 1.25):
        cap = rup(mult * mean)
        if (k * cap + spare) * per <= budget:
            return cap
    return cap


def resolved_spare(options: IndexOptions, n: int) -> int:
    """Shared overflow-region rows (~6% of n, power of two)."""
    if options.spare_capacity > 0:
        return options.spare_capacity
    return next_pow2(max(n // 16, 1024))


def stored_rows(st: V.IVFState, slots: np.ndarray) -> torch.Tensor:
    """Stored values of slab rows (``zebra_tpu/index/ivf_host.py:869-885``):
    refined int8 reconstructs in f32 (a bf16 copy would round its ~15-bit
    values back to 8 bits), plain int8 dequantises in bf16, bf16 and f32
    slabs give their rows."""
    idx = torch.as_tensor(np.asarray(slots, np.int64), device=st.vectors.device)
    rows = st.vectors[idx]
    if st.residual is not None:
        return (rows.float() * st.scales[idx][:, None]
                + st.residual[idx].float() * st.rscales[idx][:, None])
    if st.scales is not None:
        return rows.to(torch.bfloat16) * st.scales[idx][:, None].to(torch.bfloat16)
    return rows


class IVFIndex(BaseVectorIndex):
    """Single-device IVF index: learned partitions, cluster-contiguous slab."""

    _BACKEND = "ivf"

    def __init__(self, dim: int, metric: str = "cosine", options: IndexOptions | None = None,
                 metric_power: float = 3.0, device=None):
        super().__init__(dim, metric, options, metric_power, device)
        r = self.options.refine
        if not (r == "scan" or (isinstance(r, int) and r >= 0)):
            raise ValueError(f"refine must be a non-negative int or 'scan', got {r!r}")
        if self.options.refine_enabled() and self.options.dtype != "int8":
            raise ValueError(
                "refine stores an int8 quantisation residual and needs "
                "dtype='int8' (f32/bf16 slabs have no residual to refine)"
            )
        # an explicit "pallas" / "pallas2" stores rows at the next multiple of
        # 128 columns (the JAX package's DMA lane unit), zero-padded: kept so
        # that snapshots of such a database open in either package
        if self._given_rerank in ("pallas", "pallas2"):
            self._dev_dim = -(-self.dim // 128) * 128
        self.state: V.IVFState | None = None
        #: host mirrors of slot occupancy (a non-empty spare costs no sync;
        #: the rebuild policy reads no device count)
        self._used_slots = 0
        self._spare_used = 0
        #: True on a background retrain's shadow: k-means runs one pass at a
        #: time (``kmeans_paced``), so queries queued meanwhile wait ~a pass
        self._paced_train = False
        #: an inline rebuild was refused for its memory (warned once)
        self._rebuild_skip_warned = False

    @property
    def _cell_metric(self) -> str:
        """The metric that places rows in cells; it must be the query's probe
        metric (``ivf.query`` selects by sql2 for an elementwise metric)."""
        return self.metric if self.metric in D.MXU_METRICS else "sql2"

    @property
    def _quant_wire(self) -> bool:
        """Refined int8 quantises on the host and ships the int8 pair and its
        scales; every other tier ships rows on the base's array wire."""
        return self.options.refine_enabled() and self.options.dtype == "int8"

    @property
    def _wal_codec(self) -> str:
        return "q8" if self._quant_wire else super()._wal_codec

    @property
    def _wire_row_bytes(self) -> int:
        if self._quant_wire:
            return 2 * self._dev_dim + 8  # the int8 pair and two f32 scales
        return super()._wire_row_bytes

    # -- build --------------------------------------------------------------------

    def _train_centroids(self, k: int, data) -> torch.Tensor:
        """k-means centroids from ``data`` (host array or device tensor),
        subsampled to ``max(kmeans_sample, 4k)`` rows; random normal
        centroids when there is nothing to train on."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(self._rng.integers(0, 2**31 - 1)))
        if data is None or data.shape[0] < 2:
            cents = torch.randn((k, self._dev_dim), generator=gen, device=self.device)
            cents[:, self.dim :] = 0.0
            return cents
        rows = data.shape[0]
        sample_n = min(rows, max(self.options.kmeans_sample, 4 * k))
        idx = None
        if sample_n < rows:
            idx = np.sort(self._rng.choice(rows, size=sample_n, replace=False))
        if isinstance(data, torch.Tensor):
            sample = data if idx is None else data[torch.as_tensor(idx, device=data.device)]
        else:
            host = self._pad_dim(np.asarray(data, np.float32))
            sample = torch.from_numpy(np.ascontiguousarray(
                host if idx is None else host[idx])).to(self.device)
        # the [chunk, K] distance tile stays ~1 GB
        chunk = 65536 if k <= 32768 else max(2048, (1 << 28) // k)
        cents, _ = (kmeans_paced if self._paced_train else kmeans)(
            sample, sample_n, k, iters=self.options.kmeans_iters, chunk=chunk,
            balance_rounds=self.options.kmeans_balance_rounds, generator=gen,
        )
        return cents

    def _fresh_state(self, n_hint: int, data) -> V.IVFState:
        k = resolved_clusters(self.options, n_hint)
        cents = self._train_centroids(k, data)
        return V.empty_state(
            cents, resolved_capacity(self.options, n_hint, k, dim=self._dev_dim),
            resolved_spare(self.options, n_hint), dtype=self.dtype,
            refine=self.options.refine_enabled(),
        )

    def _cold_build(self, vectors, ids) -> bool:
        """Bulk first build (``zebra_tpu/index/ivf_host.py:461-549``): stage
        and log an HBM-budgeted window of the leading spans, train k-means on
        the leading rows of the first ``train_len`` of them (the JAX
        package's sample, see :meth:`_staged_rows`), THEN allocate the slab,
        then insert every span (the staged ones unchanged, the rest staged
        live by the pipeline)."""
        n = vectors.shape[0]
        if isinstance(vectors, torch.Tensor) or n < 2 * BATCH:
            return False
        spans = self._spans(n)
        nb = len(spans)
        k = resolved_clusters(self.options, n)
        cap = resolved_capacity(self.options, n, k, dim=self._dev_dim)
        spare = resolved_spare(self.options, n)
        # the window holds as many spans as fit beside the slab about to be
        # allocated (every span at 1M x 768)
        slots = k * cap + spare
        slab_bytes = slots * self._dev_dim * self.dtype.itemsize
        slab_bytes += slots * 9 + k * self._dev_dim * 4  # norms/valid/scales + centroids
        if self._quant_wire:
            slab_bytes += slots * (self._dev_dim + 4)  # residual + rscales
        batch_bytes = next_pow2(max(spans[0][1], 1)) * self._wire_row_bytes
        budget = max(_STAGE_HBM_BUDGET - slab_bytes, 2 * batch_bytes)
        window = int(min(nb, max(budget // batch_bytes, 2)))
        target = max(self.options.kmeans_sample, 4 * k)
        need = -(-target // max(spans[0][1], 1))
        train_len = max(min(4, window), min(window, need))
        per = max(min(target // train_len, spans[0][1]), 1)
        staged: list = [None] * nb
        with timed("ivf.prestage", items=sum(spans[i][1] for i in range(window))):
            for i in range(window):
                staged[i] = self._stage_span(vectors, spans[i])
        sample = torch.cat([self._staged_rows(staged[i], min(per, spans[i][1]))
                            for i in range(train_len)])
        with timed("ivf.train", items=int(sample.shape[0])):
            cents = self._train_centroids(k, sample)
            if cents.is_cuda:
                torch.cuda.current_stream(self.device).synchronize()
        del sample
        self.state = V.empty_state(cents, cap, spare, dtype=self.dtype,
                                   refine=self.options.refine_enabled())
        with timed("ivf.insert_batches", items=n):
            self._insert_batches(vectors, ids, prestaged=staged)
        return True

    # -- insert ---------------------------------------------------------------------

    def _staged_rows(self, staged: Staged, rows: int) -> torch.Tensor:
        """The leading ``rows`` of one staged span as k-means sample rows: the
        array wire's rows as shipped (bf16 or f32), or the quantised wire's
        coarse reconstruction rounded to bf16 (int8 -> bf16 casts are exact;
        the product rounds)."""
        parts = self._ready(staged)
        if isinstance(parts, tuple):
            v8, _r8, qs = parts
            return v8[:rows].to(torch.bfloat16) * qs[:rows, 0, None].to(torch.bfloat16)
        return parts[:rows]

    def _stage_span(self, vectors, span) -> Staged:
        """Quantised wire: quantise one span on the host (or slice the
        caller's pre-quantised parts — WAL replay), ship ``(v8, r8, [scale,
        rscale])`` through the pinned ring, and write its q8 WAL record while
        the copy is in flight (fsync'd before the span's insert is
        dispatched). The other tiers take the base's array wire."""
        if not self._quant_wire or isinstance(vectors, torch.Tensor):
            return super()._stage_span(vectors, span)
        start, count = span
        if self._prequant is not None:
            parts = tuple(p[start : start + count] for p in self._prequant)
        else:
            with timed("insert.quant", items=count):
                parts = V.quantise_pair_host(np.asarray(vectors[start : start + count], np.float32))
        staged = self._ship_quant(parts, ring=True)
        if self._wal_cb is not None:
            self._wal_cb(span, parts)
        return staged

    def _ship_quant(self, parts, ring: bool = False) -> Staged:
        """Host-quantised ``(v8, r8, scale, rscale)`` shipped as one buffer
        and seen on the device as ``(v8, r8, [scale, rscale])``, the codes
        zero-padded to the stored width (the WAL record holds them
        unpadded)."""
        v8, r8, sc, rs = parts
        n, d = v8.shape
        W = self._dev_dim

        def fill(views):
            v, r, qs = views
            for dst, src in ((v, v8), (r, r8)):
                dst[:, :d].copy_(torch.from_numpy(np.ascontiguousarray(src)))
                if W > d:
                    dst[:, d:].zero_()
            qs[:, 0].copy_(torch.from_numpy(np.ascontiguousarray(sc, np.float32)))
            qs[:, 1].copy_(torch.from_numpy(np.ascontiguousarray(rs, np.float32)))

        return self._ship([((n, W), torch.int8), ((n, W), torch.int8),
                           ((n, 2), torch.float32)], fill, ring)

    def _insert_batch_dev(self, staged: Staged) -> torch.Tensor:
        """One device insert, queued on the current stream after the span's
        copy; returns the slots as a device tensor (the pipeline reads them
        back two spans behind)."""
        batch = self._ready(staged)
        kw = dict(spill=self.options.spill, metric=self._cell_metric)
        if isinstance(batch, tuple):  # the quantised wire
            return V.insert_quant(self.state, *batch, **kw)
        return V.insert(self.state, batch, **kw)

    def _retry_batch(self, rows: np.ndarray):
        """Rows of a spare-growth retry, as the JAX package stages them
        (``zebra_tpu/index/ivf_host.py:650-669``): refined int8 re-quantises
        the same f32 rows, which reproduces the logged q8 codes bitwise; the
        array-wire tiers insert the f32 rows themselves, not their wire
        values (for plain int8 that quantises values other than those its
        bf16 WAL record holds: ROADMAP.md queue 3)."""
        if self._quant_wire:
            return self._ship_quant(V.quantise_pair_host(rows))
        return self._ship_rows(rows, torch.float32)

    def _resolve_failed(self, rows: np.ndarray) -> np.ndarray:
        """Rows the spare could not take: double the spare (slot numbering
        unchanged) and retry."""
        out = np.full(rows.shape[0], -1, dtype=np.int64)
        pending = np.arange(rows.shape[0])
        for _ in range(_MAX_GROWS):
            logger.info("ivf: %d vectors overflow into a grown spare (%d -> %d rows)",
                        len(pending), self.state.spare_capacity, 2 * self.state.spare_capacity)
            self.state = V.grow_spare(self.state)
            slots = self._insert_batch_dev(self._retry_batch(rows[pending])).cpu().numpy()
            out[pending] = slots
            pending = pending[slots < 0]
            if not len(pending):
                return out
        raise RuntimeError("ivf insert could not place batch after spare growth")

    def _register_slots(self, ids, slots) -> None:
        super()._register_slots(ids, slots)
        # tombstones never free a slot, so the occupancy mirrors are exact
        self._used_slots += len(slots)
        self._spare_used += int(np.sum(np.asarray(slots) >= self.state.spare_start))

    def clear(self) -> None:
        super().clear()
        self._used_slots = 0
        self._spare_used = 0

    # -- rebuild policy -----------------------------------------------------------------

    _ADOPT_EXTRA = ("_used_slots", "_spare_used")

    def _rebuilt_slab_bytes(self, n_live: int) -> tuple[int, int]:
        """(bytes per captured row, bytes of the slab a rebuild sizes for
        ``n_live`` rows): a refined int8 capture is the f32 reconstruction,
        a plain int8 one bf16, the others the slab's type."""
        d = self._dev_dim
        item = self.dtype.itemsize
        refined = self.state is not None and self.state.residual is not None
        copy_item = (4 if refined else 2) if self.dtype == torch.int8 else item
        n = max(n_live, 1)
        k = resolved_clusters(self.options, n)
        slots = (k * resolved_capacity(self.options, n, k, dim=d)
                 + resolved_spare(self.options, n))
        new_slab = slots * (d * item + 9) + k * d * 4
        if refined:
            new_slab += slots * (d + 4)
        return d * copy_item, new_slab

    def _rebuild_peak_bytes(self, n_live: int) -> int:
        """Worst-case device transient of an inline :meth:`rebuild` at
        ``n_live`` rows: max(old slab + live copy, live copy + new slab)."""
        row, new_slab = self._rebuilt_slab_bytes(n_live)
        live_copy = n_live * row
        st = self.state
        old_slab = sum(t.numel() * t.element_size()
                       for t in (st.vectors, st.norms, st.residual, st.rscales) if t is not None)
        return max(old_slab + live_copy, live_copy + new_slab)

    def _rebuild_reason(self) -> str | None:
        """The JAX package's four tiers, first match wins: "spare-critical"
        (the spare over 90% full, or grown past 4x its sizing for the live
        rows — the facade then blocks the mutating call until the retrain
        lands), "growth" (live rows past 4x ``_built_n``), "tombstones"
        (over half the allocated slots dead) and "spare-pressure" (the
        spare over 3/4 full, or holding more than max(n/8, 4096) rows)."""
        n_live = len(self._id_to_slot)
        if n_live == 0 or self.state is None:
            return None
        spare_cap = self.state.spare_capacity
        if (self._spare_used > 0.9 * max(spare_cap, 1)
                or spare_cap > 4 * resolved_spare(self.options, n_live)):
            return "spare-critical"
        if n_live > _REBUILD_GROWTH * max(self._built_n, 1):
            return "growth"
        used = self._used_slots
        if used - n_live > _COMPACT_TOMBSTONES * max(used, 1):
            return "tombstones"
        if (self._spare_used > 0.75 * max(spare_cap, 1)
                or self._spare_used > max(0.125 * n_live, 4096)):
            return "spare-pressure"
        return None

    def _rebuild_admissible(self, reason: str) -> bool:
        """An inline rebuild whose transient would not fit
        ``_STAGE_HBM_BUDGET`` is skipped (queries stay correct: tombstones
        are masked and the spare is scanned); warned once per episode."""
        n_live = len(self._id_to_slot)
        peak = self._rebuild_peak_bytes(n_live)
        if peak > _STAGE_HBM_BUDGET:
            if not self._rebuild_skip_warned:
                logger.warning("ivf: skipping auto-rebuild at %d live rows — the rebuild "
                               "transient (%.1f GB) exceeds the budget (%.1f GB)",
                               n_live, peak / 2**30, _STAGE_HBM_BUDGET / 2**30)
                self._rebuild_skip_warned = True
            return False
        self._rebuild_skip_warned = False
        return True

    def _pre_rebuild(self, reason: str | None) -> None:
        logger.info("ivf rebuild (%s): %d live vectors", reason, len(self._id_to_slot))

    def _reset_alloc_mirrors(self) -> None:
        self._used_slots = 0
        self._spare_used = 0

    def _train_sample_target(self, n: int) -> int:
        k = resolved_clusters(self.options, max(n, 1))
        return min(n, max(self.options.kmeans_sample, 4 * k))

    def _retrain_bg_peak_bytes(self, n_live: int, chunk_rows: int) -> int:
        """Device bytes a background retrain adds beside the serving state:
        the new slab, one capture chunk and the k-means sample."""
        row, new_slab = self._rebuilt_slab_bytes(n_live)
        return new_slab + (chunk_rows + self._train_sample_target(n_live)) * row

    # -- delete / search ----------------------------------------------------------------

    def _delete_slots_device(self, slots: np.ndarray) -> None:
        V.delete_slots(self.state, torch.from_numpy(slots).to(self.device))

    def _query_device(self, q: torch.Tensor, k: int, exact: bool):
        """Device search. ``exact`` scans the whole slab at ``exact_precision``
        (``approx_topk`` is accepted and selection stays exact; its wider scan
        chunk is kept, so ties break as in the JAX package)."""
        if q.shape[1] != self._dev_dim:
            q = torch.nn.functional.pad(q, (0, self._dev_dim - self.dim))
        if exact:
            return V.brute_force(self.state, q, k, metric=self.metric, power=self.metric_power,
                                 precision=self.options.exact_precision,
                                 chunk=131072 if self.options.approx_topk else 8192)
        return V.query(
            self.state, q, k, metric=self.metric, power=self.metric_power,
            num_probes=self.options.resolved_probes(), rerank=self.options.rerank,
            probe_sel=self.options.probe_sel, refine_k=self.options.refine_k(k),
            refine_scan=self.options.refine_is_scan(), spare_used=self._spare_used > 0,
        )

    def _take_rows(self, slots: np.ndarray) -> torch.Tensor:
        return stored_rows(self.state, slots)

    # -- persistence ---------------------------------------------------------------------

    def _snapshot_arrays(self) -> dict:
        """The state's members; a tier without scales or a residual writes
        none of those (as the JAX package does)."""
        st = self.state
        arrays = {
            "centroids": st.centroids,
            "counts": st.counts,
            "vectors": st.vectors,
            "norms": st.norms,
            "valid": st.valid,
            "overflow": st.overflow,
            "ccap": np.asarray(st.cluster_capacity, dtype=np.int32),
            "scales": st.scales,
            "residual": st.residual,
            "rscales": st.rscales,
        }
        return {name: a for name, a in arrays.items() if a is not None}

    def _restore_arrays(self, z) -> None:
        self.state = V.state_from_numpy(z, device=self.device)
        counts = self.state.counts.cpu().numpy()
        self._used_slots = int(counts.sum())
        self._spare_used = int(counts[-1])

    def stats(self) -> dict:
        if self.state is None:
            return {"vectors": 0, "built": False}
        st = self.state
        counts = st.counts.cpu().numpy()
        used = int(counts.sum())
        return {
            "vectors": len(self._id_to_slot),
            "built": True,
            "clusters": st.num_clusters,
            "cluster_capacity": st.cluster_capacity,
            "spare_capacity": st.spare_capacity,
            "spare_used": int(counts[-1]),
            "slab_capacity": st.slab_capacity,
            "used_slots": used,
            "max_cluster_load": int(counts[:-1].max()),
            "overflow": int(st.overflow),
            "tombstones": used - len(self._id_to_slot),
        }
