"""Host orchestration of the IVF backend (port of ``zebra_tpu/index/ivf_host.py``).

Sizing (the same formulas, so a database sizes identically in both
packages), the cold build (train k-means on a coarse sample of the leading
spans, then allocate, then insert), the host-quantised q8 wire, spare growth
on overflow, the device query and the snapshot arrays. The port carries the
refined-int8 tier only (int8 coarse slab + int8 residual streamed through the
probe kernel, ``refine="scan"`` — the library default); the f32/bf16 tiers,
``refine=N`` and the rebuild/compaction/retrain policy are not ported yet
(ROADMAP.md queue 1).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from zebra_tpu_torch.config import IndexOptions
from zebra_tpu_torch.index import ivf as V
from zebra_tpu_torch.index.base import BATCH, BaseVectorIndex
from zebra_tpu_torch.ops import distances as D
from zebra_tpu_torch.ops.kmeans import kmeans
from zebra_tpu_torch.utils import next_pow2

logger = logging.getLogger(__name__)

#: device-memory budget of the capacity sizing (the JAX package's 16 GB-chip
#: figure, kept so both packages size a database identically; it does not
#: bind at 1M x 768)
_STAGE_HBM_BUDGET = 12 << 30
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


def resolved_capacity(options: IndexOptions, n: int, k: int, dim: int = 0) -> int:
    """Per-cluster block width: 2x the mean load rounded up to 32 rows (16
    for f32/bf16), stepping the multiplier down to 1.25x until the slab fits
    85% of ``_STAGE_HBM_BUDGET``."""
    unit = 32 if options.dtype == "int8" else 16
    if options.cluster_capacity > 0:
        return options.cluster_capacity
    mean = -(-n // k)

    def rup(x: float) -> int:
        return max(-(-int(x) // unit) * unit, unit)

    if dim <= 0:
        return rup(2 * mean)
    spare = resolved_spare(options, n)
    budget = int(0.85 * _STAGE_HBM_BUDGET)
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


class IVFIndex(BaseVectorIndex):
    """Single-device IVF index: learned partitions, cluster-contiguous slab."""

    _BACKEND = "ivf"

    def __init__(self, dim: int, metric: str = "cosine", options: IndexOptions | None = None,
                 metric_power: float = 3.0, device=None):
        super().__init__(dim, metric, options, metric_power, device)
        D.check_metric(metric)
        if self.options.dtype != "int8" or self.options.resolved_refine() != "scan":
            raise NotImplementedError(
                f"the torch port carries the int8 + residual-scan tier only "
                f"(dtype={self.options.dtype!r}, refine={self.options.refine!r}); "
                "the f32/bf16 tiers and refine=N are ROADMAP.md queue 1"
            )
        self.state: V.IVFState | None = None
        #: host mirrors of slot occupancy (a non-empty spare costs no sync)
        self._used_slots = 0
        self._spare_used = 0

    # -- build --------------------------------------------------------------------

    def _train_centroids(self, k: int, data) -> torch.Tensor:
        """k-means centroids from ``data`` (host array or device tensor),
        subsampled to ``max(kmeans_sample, 4k)`` rows; random normal
        centroids when there is nothing to train on."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(self._rng.integers(0, 2**31 - 1)))
        if data is None or data.shape[0] < 2:
            return torch.randn((k, self.dim), generator=gen, device=self.device)
        rows = data.shape[0]
        sample_n = min(rows, max(self.options.kmeans_sample, 4 * k))
        idx = None
        if sample_n < rows:
            idx = np.sort(self._rng.choice(rows, size=sample_n, replace=False))
        if isinstance(data, torch.Tensor):
            sample = data if idx is None else data[torch.as_tensor(idx, device=data.device)]
        else:
            host = np.asarray(data, np.float32)
            sample = torch.from_numpy(np.ascontiguousarray(
                host if idx is None else host[idx])).to(self.device)
        # the [chunk, K] distance tile stays ~1 GB
        chunk = 65536 if k <= 32768 else max(2048, (1 << 28) // k)
        cents, _ = kmeans(
            sample, sample_n, k, iters=self.options.kmeans_iters, chunk=chunk,
            balance_rounds=self.options.kmeans_balance_rounds, generator=gen,
        )
        return cents

    def _fresh_state(self, n_hint: int, data) -> V.IVFState:
        k = resolved_clusters(self.options, n_hint)
        cents = self._train_centroids(k, data)
        return V.empty_state(
            cents, resolved_capacity(self.options, n_hint, k, dim=self.dim),
            resolved_spare(self.options, n_hint), dtype=torch.int8, refine=True,
        )

    def _cold_build(self, vectors, ids) -> bool:
        """Bulk first build: quantise + log the leading spans, train k-means
        on their coarse bf16 reconstruction (the JAX package's sample: the
        first ``per`` rows of each of ``train_len`` spans), THEN allocate the
        slab, then insert every span (the staged ones unchanged)."""
        n = vectors.shape[0]
        if n < 2 * BATCH:
            return False
        spans = self._spans(n)
        k = resolved_clusters(self.options, n)
        target = max(self.options.kmeans_sample, 4 * k)
        need = -(-target // max(spans[0][1], 1))
        train_len = max(min(4, len(spans)), min(len(spans), need))
        per = max(min(target // train_len, spans[0][1]), 1)
        staged = [self._stage_span(vectors, spans[i]) for i in range(train_len)]
        sample = torch.cat([
            # int8 -> bf16 casts are exact; the product rounds to bf16
            v8[: min(per, sp[1])].to(torch.bfloat16)
            * qs[: min(per, sp[1]), 0, None].to(torch.bfloat16)
            for (v8, _r8, qs), sp in zip(staged, spans)
        ])
        cents = self._train_centroids(k, sample)
        del sample
        self.state = V.empty_state(
            cents, resolved_capacity(self.options, n, k, dim=self.dim),
            resolved_spare(self.options, n), dtype=torch.int8, refine=True,
        )
        self._insert_batches(vectors, ids, staged=staged)
        return True

    # -- insert ---------------------------------------------------------------------

    def _stage_span(self, vectors, span):
        """Quantise one span on the host (or slice the caller's pre-quantised
        parts — WAL replay), write its q8 WAL record (fsync'd before the
        insert runs), and ship ``(v8, r8, [scale, rscale])`` to the device."""
        start, count = span
        if self._prequant is not None:
            parts = tuple(p[start : start + count] for p in self._prequant)
        else:
            parts = V.quantise_pair_host(np.asarray(vectors[start : start + count], np.float32))
        if self._wal_cb is not None:
            self._wal_cb(span, parts)
        v8, r8, sc, rs = parts
        qs = np.stack([sc, rs], axis=1).astype(np.float32)
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                     for a in (v8, r8, qs))

    def _insert_batch_dev(self, batch) -> np.ndarray:
        # cells are chosen with the query's probe metric (the two must agree)
        slots = V.insert_quant(self.state, *batch, spill=self.options.spill,
                               metric=self.metric)
        return slots.cpu().numpy()

    def _resolve_failed(self, rows: np.ndarray) -> np.ndarray:
        """Rows the spare could not take: double the spare (slot numbering
        unchanged) and retry. Re-quantising the same f32 rows reproduces the
        logged codes bitwise."""
        out = np.full(rows.shape[0], -1, dtype=np.int64)
        pending = np.arange(rows.shape[0])
        for _ in range(_MAX_GROWS):
            logger.info("ivf: %d vectors overflow into a grown spare (%d -> %d rows)",
                        len(pending), self.state.spare_capacity, 2 * self.state.spare_capacity)
            self.state = V.grow_spare(self.state)
            v8, r8, sc, rs = V.quantise_pair_host(rows[pending])
            batch = tuple(torch.from_numpy(a).to(self.device)
                          for a in (v8, r8, np.stack([sc, rs], axis=1)))
            slots = self._insert_batch_dev(batch)
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

    # -- delete / search ----------------------------------------------------------------

    def _delete_slots_device(self, slots: np.ndarray) -> None:
        V.delete_slots(self.state, torch.from_numpy(slots).to(self.device))

    def _query_device(self, q: torch.Tensor, k: int, exact: bool):
        """Device search. ``exact`` scans the whole slab (always full f32:
        ``exact_precision`` and ``approx_topk`` only ever trade accuracy away
        on the JAX package)."""
        if exact:
            return V.brute_force(self.state, q, k, metric=self.metric)
        return V.query(
            self.state, q, k, metric=self.metric,
            num_probes=self.options.resolved_probes(), rerank=self.options.rerank,
            probe_sel=self.options.probe_sel, refine_scan=True,
            spare_used=self._spare_used > 0,
        )

    # -- persistence ---------------------------------------------------------------------

    def _snapshot_arrays(self) -> dict:
        st = self.state
        return {
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
