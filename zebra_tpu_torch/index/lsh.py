"""Host orchestration of the LSH bucket-table backend (port of
``zebra_tpu/index/lsh.py``).

What is LSH-specific on top of :mod:`zebra_tpu_torch.index.base`:
hyperplane sampling, the bump-allocated slab with a host mirror of the next
free slot (no device read per insert), the build-time hot-bucket estimate
that deepens buckets before allocation, the overflow / growth / tombstone
rebuild policy with its background-retrain hooks (a bare index rebuilds
inline; under the Database facade the rebuild leaves the write lock for the
facade's shadow retrain, carrying the doubled bucket depth of an
"overflow-capacity" reason onto the shadow), and the stored width padded for
an explicit ``rerank="pallas"`` (the JAX package's TPU DMA tiling — kept so
that snapshots open in both packages).

Random draws: the numpy ``_rng`` sequence is the JAX package's (one seed per
plane sample), and each seed feeds :func:`plane_draws`, which the parity
tests replace with the JAX draws of the same seed.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from zebra_tpu_torch.config import IndexOptions
from zebra_tpu_torch.index import buckets as B
from zebra_tpu_torch.index.base import _MIN_BATCH, BaseVectorIndex, Staged
from zebra_tpu_torch.ops import hashing as H
from zebra_tpu_torch.profiling import timed
from zebra_tpu_torch.utils import next_pow2

logger = logging.getLogger(__name__)

_MIN_SLAB = 4096
#: rebuild when live vectors outgrow the built size by this factor
_REBUILD_GROWTH = 4.0
#: rebuild when bucket-append drops exceed this fraction of live vectors
_REBUILD_OVERFLOW = 0.02
#: compact when tombstones exceed this fraction of allocated slots
_COMPACT_TOMBSTONES = 0.5
#: rows of the strided sample hashed by the hot-bucket estimate
_HOT_SAMPLE = 65536


def plane_draws(seed: int, mode: str, num_tables: int, bits: int, n: int, width: int):
    """The random draws of one plane sample, from a CPU ``torch.Generator``
    seeded with ``seed``: ``(pairs [T, b, 2], fallback normals [T, b,
    width])`` for "data" planes over ``n`` rows, raw normals ``[T, b,
    width]`` for "random" planes."""
    g = torch.Generator().manual_seed(seed)
    if mode == "data":
        return (torch.randint(0, n, (num_tables, bits, 2), generator=g),
                torch.randn((num_tables, bits, width), generator=g))
    return torch.randn((num_tables, bits, width), generator=g)


class LSHIndex(BaseVectorIndex):
    """Single-device ANN index: LSH bucket tables + host id maps."""

    _BACKEND = "lsh"

    def __init__(self, dim: int, metric: str = "cosine", options: IndexOptions | None = None,
                 metric_power: float = 3.0, device=None):
        super().__init__(dim, metric, options, metric_power, device)
        if self.options.dtype == "int8":
            raise ValueError(
                "dtype='int8' is supported by the ivf backend only (the "
                "quantised slab needs per-row scales the bucket layout "
                "doesn't carry); use dtype='bfloat16' or index_type='ivf'"
            )
        # An explicit "pallas" re-rank stores rows padded to the TPU kernel's
        # DMA unit (1024 f32 / 2048 bf16 columns; zero columns change no
        # distance). Keyed on what the user gave, so a snapshot opens with
        # the same stored width in either package.
        if self._given_rerank == "pallas":
            unit = 2048 if self.options.dtype == "bfloat16" else 1024
            self._dev_dim = -(-self.dim // unit) * unit
        self.state: B.LSHState | None = None
        #: host mirror of state.next_slot (slots are a bump allocator)
        self._next_slot = 0
        #: bucket-capacity multiplier: set by the build-time hot-bucket
        #: estimate, doubled by overflow-driven rebuilds
        self._cap_boost = 1

    # -- build ----------------------------------------------------------------------

    def _sample_planes(self, bits: int, data=None):
        seed = int(self._rng.integers(0, 2**31 - 1))
        T = self.options.num_tables
        if self.options.plane_mode == "data" and data is not None and data.shape[0] >= 2:
            if not isinstance(data, torch.Tensor):  # host rows: gather the pairs there
                data = torch.from_numpy(np.ascontiguousarray(data, dtype=np.float32))
            draws = plane_draws(seed, "data", T, bits, data.shape[0], self._dev_dim)
            planes, consts = H.sample_planes_data(T, bits, data, draws=draws, width=self._dev_dim)
            return planes.to(self.device), consts.to(self.device)
        normals = plane_draws(seed, "random", T, bits, 0, self.dim)
        planes, consts = H.sample_planes_random(T, bits, self.dim, normals=normals)
        if self._dev_dim != self.dim:
            planes = torch.nn.functional.pad(planes, (0, self._dev_dim - self.dim))
        return planes.to(self.device), consts.to(self.device)

    def _fresh_state(self, n_hint: int, data) -> B.LSHState:
        cap0 = self.options.resolved_bucket_capacity()
        cap = cap0 * self._cap_boost
        bits = self.options.resolved_bits(n_hint, capacity=cap)
        slab = next_pow2(max(self.options.slab_capacity, 2 * n_hint, _MIN_SLAB))
        planes, consts = self._sample_planes(bits, data)
        if data is not None and self._cap_boost == 1 and n_hint >= 16 * _MIN_SLAB:
            # adaptive depth, sized before allocation: tightly clustered data
            # collapses whole clusters onto single codes, so hash a sample and
            # deepen buckets for the hot codes in one step (the reference
            # never drops entries either: its leaves split, lsh.rs:250-267)
            est = self._estimate_hot_load(planes, consts, data, n_hint)
            want = int(1.25 * est)
            if want > cap:
                self._cap_boost = min(-(-want // cap0), 1024)
                cap = cap0 * self._cap_boost
                nb = self.options.resolved_bits(n_hint, capacity=cap)
                if nb != bits:  # deeper buckets shrink the bit budget
                    bits = nb
                    planes, consts = self._sample_planes(bits, data)
                logger.info("lsh: sample predicts hot-bucket load ~%d at %d rows; "
                            "pre-boosting bucket depth to %d (bits %d)", est, n_hint, cap, bits)
        self._next_slot = 0
        return B.empty_state(planes, consts, cap, slab, dtype=self.dtype)

    def _estimate_hot_load(self, planes, consts, data, n_hint: int) -> int:
        """Predicted max bucket load at ``n_hint`` rows from one hashed
        strided sample (<= 65536 rows). Only buckets with >= 8 sample hits
        extrapolate: near-uniform data keeps its max at noise level."""
        stride = max(data.shape[0] // _HOT_SAMPLE, 1)
        if isinstance(data, torch.Tensor):  # rebuild: rows already stored-width
            xs = data[::stride][:_HOT_SAMPLE].float()
        else:
            x = np.ascontiguousarray(np.asarray(data, np.float32)[::stride][:_HOT_SAMPLE])
            xs = torch.from_numpy(self._pad_dim(x)).to(self.device)
        codes = H.hash_codes(xs, planes, consts)  # [s, T]
        hot = 0
        for t in range(codes.shape[1]):
            m = int(torch.bincount(codes[:, t]).max()) if codes.shape[0] else 0
            if m >= 8:
                hot = max(hot, m)
        return int(hot * (n_hint / max(codes.shape[0], 1)))

    # -- insert -----------------------------------------------------------------------

    def _before_batches(self, n: int) -> None:
        # the JAX package stages the last span padded to a power of two and
        # reserves room for the pad; the same reservation keeps both slabs
        # the same size
        w = self._span_width()
        last = n % w or n
        pad_tail = next_pow2(max(min(last, w), _MIN_BATCH)) - min(last, w)
        self._ensure_slab(n + pad_tail)

    def _ensure_slab(self, incoming: int) -> None:
        st = self.state
        need = self._next_slot + incoming
        if need <= st.slab_capacity:
            return
        cap = st.slab_capacity
        new_cap = next_pow2(max(2 * cap, need))

        def grow(t):
            out = torch.zeros((new_cap, *t.shape[1:]), dtype=t.dtype, device=t.device)
            out[:cap] = t
            return out

        with timed("insert.grow", items=need):
            st.vectors, st.norms, st.valid = grow(st.vectors), grow(st.norms), grow(st.valid)

    def _insert_batch_dev(self, staged: Staged) -> np.ndarray:
        """One device insert after the span's copy. The slots are known on
        the host (a bump allocator), so nothing is read back; the insert
        itself reads its bucket-scatter width back (``buckets._append``)."""
        batch = self._ready(staged)
        count = batch.shape[0]
        B.insert(self.state, batch, start=self._next_slot)
        # slots are next_slot .. next_slot+count-1 by construction
        slots = np.arange(self._next_slot, self._next_slot + count)
        self._next_slot += count
        return slots

    # -- rebuild ------------------------------------------------------------------------

    def _rebuild_reason(self) -> str | None:
        st = self.state
        n_live = len(self._id_to_slot)
        if n_live == 0 or st is None:
            return None
        if n_live > _REBUILD_GROWTH * max(self._built_n, 1):
            return "growth"
        # dropped bucket entries justify a rebuild only where a lever
        # exists: wider codes while the table budget allows, then doubled
        # bucket depth (bounded at 64x: tight clusters would re-overflow);
        # flat's vestigial tables are never queried
        overflow = int(st.overflow)  # one scalar read per mutation
        if self.options.index_type != "flat" and overflow > _REBUILD_OVERFLOW * n_live:
            if self.options.resolved_bits(n_live, capacity=st.bucket_capacity) > st.bits:
                return "overflow-bits"
            if self._cap_boost < 64:
                return "overflow-capacity"
        used = self._next_slot
        if used - n_live > _COMPACT_TOMBSTONES * max(used, 1):
            return "tombstones"
        return None

    def _pre_rebuild(self, reason: str | None) -> None:
        if reason == "overflow-capacity":
            self._cap_boost *= 2
        logger.info("rebuild (%s): %d live vectors (used=%d, overflow=%s, cap_boost=%d)",
                    reason, len(self._id_to_slot), self._next_slot,
                    int(self.state.overflow) if self.state is not None else 0, self._cap_boost)

    _ADOPT_EXTRA = ("_next_slot", "_cap_boost")

    def _prepare_shadow(self, shadow, reason: str | None) -> None:
        shadow._cap_boost = self._cap_boost * (2 if reason == "overflow-capacity" else 1)

    def _retrain_bg_peak_bytes(self, n_live: int, chunk_rows: int) -> int:
        """Device bytes a background retrain adds beside the serving state:
        the shadow's slab and bucket tables plus one f32 capture chunk."""
        cap = self.options.resolved_bucket_capacity() * self._cap_boost
        bits = self.options.resolved_bits(n_live, capacity=cap)
        slab = next_pow2(max(self.options.slab_capacity, 2 * n_live, _MIN_SLAB))
        slab_b = slab * (self._dev_dim * self.dtype.itemsize + 5)  # vectors + norms + valid
        tables_b = max(self.options.num_tables, 1) * (1 << bits) * (cap + 1) * 4
        return slab_b + tables_b + chunk_rows * self._dev_dim * 4

    def _reset_alloc_mirrors(self) -> None:
        self._next_slot = 0

    def _meta_extra(self) -> dict:
        return {"cap_boost": self._cap_boost}

    def _apply_meta_extra(self, meta: dict) -> None:
        self._cap_boost = int(meta.get("cap_boost", 1))

    # -- delete / search ------------------------------------------------------------------

    def _delete_slots_device(self, slots: np.ndarray) -> None:
        B.delete_slots(self.state, torch.from_numpy(slots).to(self.device))

    def _candidate_width(self, probes: int) -> tuple[int, bool]:
        """``(max_candidates, lossless)`` of a query: the option (values
        <= 0 mean no compaction, as in the JAX package), or — for buckets
        deepened past a full probe width of 65,536 — lossless compaction to
        the batch's widest live set. The JAX package cuts to 65,536 here
        (``zebra_tpu/index/lsh.py:293-301``),
        on the premise that the unique candidates are fewer. At 1M x 768
        clustered rows with auto depth (capacity 6280) every query had more
        than 65,536, and keeping the lowest 65,536 slots cut recall@10 to
        0.33 (NVIDIA H100 80GB HBM3, 700 W power limit); lossless
        compaction gives the untruncated query's answers."""
        mc = max(self.options.max_candidates, 0)
        full = self.state.num_tables * probes * self.state.bucket_capacity
        return mc, mc == 0 and full > 65536

    def _query_device(self, q: torch.Tensor, k: int, exact: bool):
        """Device search on queries padded to the stored width. ``exact``,
        and every query of a flat index, scans the whole slab at
        ``exact_precision`` (``approx_topk`` is accepted and selection stays
        exact; its wider scan chunk is kept, so ties break as in the JAX
        package)."""
        if q.shape[1] != self._dev_dim:
            q = torch.nn.functional.pad(q, (0, self._dev_dim - self.dim))
        if exact or self.options.index_type == "flat":
            return B.brute_force(self.state, q, k, metric=self.metric, power=self.metric_power,
                                 precision=self.options.exact_precision,
                                 chunk=131072 if self.options.approx_topk else 8192)
        probes = self.options.resolved_probes()
        mc, lossless = self._candidate_width(probes)
        return B.query(self.state, q, k, metric=self.metric, power=self.metric_power,
                       num_probes=probes,
                       rerank=self.options.rerank, max_candidates=mc, lossless=lossless,
                       dim=self.dim, occupied=self._next_slot)

    # -- persistence -------------------------------------------------------------------------

    def _snapshot_arrays(self) -> dict:
        st = self.state
        return {
            "planes": st.planes,
            "consts": st.consts,
            "buckets": st.buckets,
            "counts": st.counts,
            "vectors": st.vectors,
            "norms": st.norms,
            "valid": st.valid,
            "next_slot": st.next_slot,
            "overflow": st.overflow,
        }

    def _restore_arrays(self, z) -> None:
        self.state = B.state_from_numpy(z, device=self.device, dtype=self.dtype)

    def _after_restore(self) -> None:
        # the bump-allocator mirror: adds after a reopen must not overwrite
        # slots from 0
        self._next_slot = int(self.state.next_slot)

    def stats(self) -> dict:
        if self.state is None:
            return {"vectors": 0, "built": False}
        st = self.state
        return {
            "vectors": len(self._id_to_slot),
            "built": True,
            "tables": st.num_tables,
            "bits": st.bits,
            "bucket_capacity": st.bucket_capacity,
            "cap_boost": self._cap_boost,
            "slab_capacity": st.slab_capacity,
            "used_slots": self._next_slot,
            "overflow": int(st.overflow),
            "tombstones": self._next_slot - len(self._id_to_slot),
        }
