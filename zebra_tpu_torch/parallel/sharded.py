"""Mesh-sharded index (port of ``zebra_tpu/parallel/sharded.py``).

Every shard owns an independent slice of the database: its own partitions
(IVF centroids, or LSH planes and bucket tables) and its slab, held as one
``ivf.IVFState`` / ``buckets.LSHState`` per mesh device — the states the
single-device index runs, queried by the same ``ivf.query`` /
``buckets.query`` / ``brute_force`` (on the card: kernel 1 or kernel 4 per
shard). The JAX package stacks them into one ``[S, ...]`` state sharded over
its mesh; the port stacks them only in a snapshot, so the files are the same.

Inserts split each span block-wise over the shards as the JAX package's
``_block3`` does: the span is padded to ``next_pow2(max(count, 256))`` rows,
shard s takes the ``bs = padded / S`` rows from ``s * bs`` (the real ones
among them). Global slots interleave as ``g = local_slot * S + shard``, so a
row lands in the same shard and slot in both packages. A query runs on every
shard; the partial top-k ``[S, B, k]`` come to the first mesh device, which
stands in for the all-gather, and merge in the JAX package's order
(``[B, S*k]`` shard-major per query), so equal distances keep the lower
shard first. When every shard sits on one device, the shards' work is queued
on that device's current stream in turn; on several devices a copy to the
first device is ordered after the shard's work by PyTorch's cross-device
copy. Nothing waits on the host per shard.

Where the JAX package's IVF sizing loses rows, the port departs from it
(ROADMAP.md queue 3): its shards hold their rows in one shared set of the
cells an unsharded index would have, a full cell's rows fall back in nearest
order within the cells their own query probes (then to the spare, of which a
query scans the filled prefix), and rebuilds re-insert the live rows in a
seeded random order. The
snapshots, the insert split and the merge stay the JAX package's.

The host layer is the single index's (``index/base.py``): id maps, the
pipelined insert, dedup, the rebuild and shadow protocol, snapshots. What is
sharded lives here: the sizing and training, the split insert and its host
mirrors, the merge, reshard-on-load.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from zebra_tpu_torch.config import IndexOptions
from zebra_tpu_torch.index import buckets as B
from zebra_tpu_torch.index import ivf as V
from zebra_tpu_torch.index import lsh as L
from zebra_tpu_torch.index.base import _MIN_BATCH, BATCH, BaseVectorIndex, SlotIdArena, read_meta
from zebra_tpu_torch.index.ivf_host import (_STAGE_HBM_BUDGET, resolved_capacity,
                                            resolved_clusters, resolved_spare, stored_rows)
from zebra_tpu_torch.ops import distances as D
from zebra_tpu_torch.ops import hashing as H
from zebra_tpu_torch.ops import topk as TK
from zebra_tpu_torch.ops.kmeans import kmeans, kmeans_paced
from zebra_tpu_torch.parallel.mesh import SHARD_AXIS, make_mesh, normalize_device
from zebra_tpu_torch.storage.snapshots import StackedSource
from zebra_tpu_torch.utils import next_pow2

logger = logging.getLogger(__name__)

#: smallest per-shard LSH slab (``zebra_tpu/parallel/sharded.py:56``)
_MIN_SLAB = 2048
#: spare-growth retries per batch before giving up
_MAX_GROWS = 8


def merge_partials(parts, k: int, device):
    """Merged top-k of per-shard partials ``[(dists, global slots, valid)]``
    (each ``[B, k]``) on ``device``: shard-major per query, as the JAX
    package's ``_merge_gathered`` lays out its all-gathered ``[S, B, k]``."""
    d = torch.stack([p[0].to(device) for p in parts], 1).flatten(1)
    g = torch.stack([p[1].to(device) for p in parts], 1).flatten(1)
    v = torch.stack([p[2].to(device) for p in parts], 1).flatten(1)
    return TK.masked_topk(d, v, g, k)


class ShardedIndex(BaseVectorIndex):
    """Drop-in index whose state is partitioned over a mesh: IVF at every
    tier, flat (LSH states, every query the exact scan) and LSH, by
    ``options.index_type``.

    Placement: ``mesh`` names the devices; else ``device`` (one device holds
    every shard, e.g. ``"cpu"`` or ``"cuda"``); else ``make_mesh(shards)``:
    one CUDA card per shard, which raises when there are fewer cards.
    """

    def __init__(self, dim: int, metric: str = "cosine", options: IndexOptions | None = None,
                 metric_power: float = 3.0, shards: int | None = None, mesh=None, device=None):
        if mesh is None:
            mesh = make_mesh(shards, None if device is None else [device] * (shards or 1))
        devices = [normalize_device(d) for d in mesh.devices.flat]
        if len({d.type for d in devices}) > 1:
            raise ValueError("a sharded index's devices must all be of one type")
        super().__init__(dim, metric, options, metric_power, device=devices[0])
        if self.options.dtype == "int8" and self.options.index_type != "ivf":
            raise ValueError("dtype='int8' is supported by the ivf backend only")
        if self.options.refine_enabled() and self.options.dtype != "int8":
            raise ValueError(
                "refine stores an int8 quantisation residual and needs "
                "dtype='int8' (f32/bf16 slabs have no residual to refine)"
            )
        if self._given_rerank in ("pallas", "pallas2"):
            # the JAX package's kernels need aligned stored dims (IVF: 128
            # lanes; LSH's flat-slab kernel: 1024 f32 / 2048 bf16) and its
            # sharded state carries no dim padding: the same refusal here,
            # so a configuration both packages accept stores the same width
            if self.options.index_type == "ivf":
                unit = 128
            else:
                unit = 2048 if self.options.dtype == "bfloat16" else 1024
            if self.dim % unit:
                raise ValueError(
                    f"sharded rerank='pallas' needs dim % {unit} == 0 "
                    f"(got {self.dim}); use rerank='xla' or pad the embeddings"
                )
        self.mesh = mesh
        self.shards = mesh.shape[SHARD_AXIS]
        #: the device of each shard's state, in shard order
        self.shard_devices = devices
        self._ivf = self.options.index_type == "ivf"
        self.state: list | None = None  # one IVFState / LSHState per shard
        #: per-shard bump-allocator mirrors (LSH, flat)
        self._next_slots: list[int] = [0] * self.shards
        #: IVF occupancy mirrors, kept from the resolved insert slots
        self._used_slots = 0
        self._spare_used = np.zeros(self.shards, dtype=np.int64)
        self._kc = 0  # per-shard K * C: the spare region starts here
        #: True on a background retrain's shadow (``kmeans_paced``)
        self._paced_train = False

    # -- geometry ----------------------------------------------------------------

    @property
    def _cell_metric(self) -> str:
        """The metric that places rows in cells: the query's probe metric."""
        return self.metric if self.metric in D.MXU_METRICS else "sql2"

    @property
    def _spill(self) -> int:
        """Cells a row may take before the spare: at most the P a query of
        the row itself probes (a row past them could not find itself; the
        spare is always scanned). S shards of one index's cells hold 1/S of
        each cell's rows, and at 1M x 768 over 4 shards ~1 row in 10^4 found
        its two nearest cells full (32 rows deep)."""
        return min(self.options.spill, self.options.resolved_probes())

    def _share(self) -> int:
        """Shards on the busiest device (their slabs share its memory)."""
        return max(self.shard_devices.count(d) for d in self.shard_devices)

    def _split(self, count: int) -> list[tuple[int, int]]:
        """``(first row, rows)`` of each shard's block of a ``count``-row
        span: the JAX package's ``_block3`` of the span padded to
        ``next_pow2(max(count, 256))`` rows."""
        bs = -(-next_pow2(max(count, _MIN_BATCH)) // self.shards)
        return [(s * bs, min(max(count - s * bs, 0), bs)) for s in range(self.shards)]

    def _by_shard(self, slots: np.ndarray):
        """``[(shard, positions in slots, local slots)]`` of global slots."""
        g = np.asarray(slots, dtype=np.int64)
        out = []
        for s in range(self.shards):
            pos = np.nonzero(g % self.shards == s)[0]
            if len(pos):
                out.append((s, pos, g[pos] // self.shards))
        return out

    def _valid_by_slot(self) -> np.ndarray:
        """``[S, cap]`` liveness flattened in global-slot order (``l*S + s``)."""
        return np.stack([st.valid.cpu().numpy() for st in self.state]).T.reshape(-1)

    def _state_hbm_bytes(self) -> int:
        if self.state is None:
            return 0
        return sum(t.numel() * t.element_size() for st in self.state
                   for t in vars(st).values() if isinstance(t, torch.Tensor))

    # -- fresh state -------------------------------------------------------------

    def _fresh_state(self, n_hint: int, data) -> list:
        """Per-shard states for ``ceil(n_hint / S)`` rows each.

        LSH and flat: each shard samples its planes from the s-th contiguous
        slice of ``data`` (host rows or device rows), as the JAX package
        does. The JAX package cuts the slices at multiples of ``ceil(n_hint
        / S)``, which a training sample shorter than ``n_hint`` does not
        reach (ROADMAP.md queue 3); here the slices divide ``data`` itself,
        the same cut for a build from every row.

        IVF departs from the JAX package's per-shard partitions (ROADMAP.md
        queue 3): one k-means over a sample of ``data`` trains the cells an
        unsharded index of ``n_hint`` rows would have, and every shard holds
        its rows in those cells (the capacity and the spare sized for its
        own rows, so the slab is as large as the JAX package's). Sized for
        its own rows (K=4096 a shard for 1M rows over 4), a shard of
        clustered data holds more natural clusters than cells, cells fill,
        rows spill past the P=2 cells their own query probes: at 1M x 768
        over 4 shards the JAX rule read recall@10 0.9004 and self-retrieval
        0.9199 (NVIDIA H100 80GB HBM3, 700 W). Inserts take a full cell's
        fallbacks in nearest order (``ivf.insert(jitter=False)``) and only
        among the cells a query of the row probes, then the spare
        (``_spill``), for the same reason."""
        S = self.shards
        per = -(-max(int(n_hint), 1) // S)
        if self._ivf:
            states = self._fresh_ivf(max(int(n_hint), 1), per, data)
            self._kc = states[0].num_clusters * states[0].cluster_capacity
        else:
            m = 0 if data is None else data.shape[0]
            step = -(-m // S) if m else 0
            slices = [None if data is None or min(s * step, m) >= min((s + 1) * step, m)
                      else data[s * step : min((s + 1) * step, m)] for s in range(S)]
            states = [self._fresh_shard_lsh(per, sl, dev)
                      for sl, dev in zip(slices, self.shard_devices)]
        self._next_slots = [0] * S
        self._used_slots = 0
        self._spare_used = np.zeros(S, dtype=np.int64)
        return states

    def _fresh_ivf(self, n: int, per: int, data) -> list:
        """The shards' IVF states: ``resolved_clusters(n)`` centroids trained
        once on the first device (from ``max(kmeans_sample, 4K)`` rows of
        ``data``, as a single index samples), each shard a copy of them with
        the capacity and spare of ``per`` rows."""
        o = self.options
        dev = self.device
        K = resolved_clusters(o, n)
        C = resolved_capacity(o, per, K, dim=self._dev_dim,
                              budget=_STAGE_HBM_BUDGET // self._share())
        G = resolved_spare(o, per)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(self._rng.integers(0, 2**31 - 1)))
        if data is None or data.shape[0] < 2:
            cents = torch.randn((K, self._dev_dim), generator=gen, device=dev)
        else:
            rows = data.shape[0]
            sample_n = min(rows, max(o.kmeans_sample, 4 * K))
            idx = None
            if sample_n < rows:
                idx = np.sort(self._rng.choice(rows, size=sample_n, replace=False))
            if isinstance(data, torch.Tensor):
                sample = data if idx is None else data[torch.as_tensor(idx, device=data.device)]
                sample = sample.to(dev)
            else:
                host = np.asarray(data, np.float32)
                sample = torch.from_numpy(np.ascontiguousarray(
                    host if idx is None else host[idx])).to(dev)
            chunk = 65536 if K <= 32768 else max(2048, (1 << 28) // K)
            cents, _ = (kmeans_paced if self._paced_train else kmeans)(
                sample, sample_n, K, iters=o.kmeans_iters, chunk=chunk,
                balance_rounds=o.kmeans_balance_rounds, generator=gen,
            )
            del sample
        return [V.empty_state(cents.to(d, copy=True), C, G, dtype=self.dtype,
                              refine=o.refine_enabled()) for d in self.shard_devices]

    def _fresh_shard_lsh(self, per: int, data, dev: torch.device) -> B.LSHState:
        o = self.options
        bits = o.resolved_bits(per)
        cap = o.resolved_bucket_capacity()
        slab = next_pow2(max(o.slab_capacity // max(self.shards, 1), 2 * per, _MIN_SLAB))
        seed = int(self._rng.integers(0, 2**31 - 1))
        T = o.num_tables
        if o.plane_mode == "data" and data is not None and data.shape[0] >= 2:
            if not isinstance(data, torch.Tensor):
                data = torch.from_numpy(np.ascontiguousarray(data, dtype=np.float32))
            draws = L.plane_draws(seed, "data", T, bits, data.shape[0], self._dev_dim)
            planes, consts = H.sample_planes_data(T, bits, data.float(), draws=draws,
                                                  width=self._dev_dim)
        else:
            normals = L.plane_draws(seed, "random", T, bits, 0, self.dim)
            planes, consts = H.sample_planes_random(T, bits, self.dim, normals=normals)
        return B.empty_state(planes.to(dev), consts.to(dev), cap, slab, dtype=self.dtype)

    # -- insert ------------------------------------------------------------------

    def _per_shard_rows(self, n: int) -> int:
        """Most rows one shard receives from an ``n``-row add (the JAX
        package reserves by full spans)."""
        total = 0
        for s in range(0, n, BATCH):
            padded = next_pow2(max(min(n - s, BATCH), _MIN_BATCH))
            total += -(-padded // self.shards)
        return total

    def _before_batches(self, n: int) -> None:
        if not self._ivf:  # IVF places by cluster; the spare takes overflow
            self._ensure_slab(self._per_shard_rows(n))

    def _ensure_slab(self, per_shard_incoming: int) -> None:
        cap = self.state[0].slab_capacity
        need = max(self._next_slots) + per_shard_incoming
        if need <= cap:
            return
        new_cap = next_pow2(max(2 * cap, need))

        def grow(t):
            out = torch.zeros((new_cap, *t.shape[1:]), dtype=t.dtype, device=t.device)
            out[:cap] = t
            return out

        for st in self.state:
            st.vectors, st.norms, st.valid = grow(st.vectors), grow(st.norms), grow(st.valid)

    def _insert_batch_dev(self, staged):
        """One span into the shards, each block after the span's copy on its
        shard's device. IVF returns the global slots as a device tensor (-1
        where a spare was full: the pipeline retries those); LSH and flat
        know theirs on the host (bump allocators)."""
        batch = self._ready(staged)
        count = batch.shape[0]
        S = self.shards
        if self._ivf:
            out = []
            for s, ((lo, nv), st) in enumerate(zip(self._split(count), self.state)):
                if nv:
                    local = V.insert(st, batch[lo : lo + nv].to(st.device),
                                     spill=self._spill, metric=self._cell_metric,
                                     jitter=False)
                    out.append(torch.where(local >= 0, local * S + s, -1).to(self.device))
            return torch.cat(out)
        slots = np.empty(count, dtype=np.int64)
        for s, ((lo, nv), st) in enumerate(zip(self._split(count), self.state)):
            if nv:
                base = self._next_slots[s]
                B.insert(st, batch[lo : lo + nv].to(st.device), start=base)
                slots[lo : lo + nv] = (base + np.arange(nv)) * S + s
                self._next_slots[s] = base + nv
        return slots

    def _resolve_failed(self, rows: np.ndarray) -> np.ndarray:
        """IVF rows some shard's spare could not take: double every shard's
        spare (slots unchanged) and insert them again as a new span (LSH
        slots are never negative: its slab is reserved before the insert)."""
        out = np.full(rows.shape[0], -1, dtype=np.int64)
        pending = np.arange(rows.shape[0])
        for _ in range(_MAX_GROWS):
            logger.info("sharded ivf: %d vectors overflow into grown spares", len(pending))
            self.state = [V.grow_spare(st) for st in self.state]
            staged = self._ship_rows(rows[pending], self._wire_dtype)
            slots = self._insert_batch_dev(staged).cpu().numpy()
            out[pending] = slots
            pending = pending[slots < 0]
            if not len(pending):
                return out
        raise RuntimeError("sharded ivf insert could not place batch")

    def _register_slots(self, ids, slots) -> None:
        super()._register_slots(ids, slots)
        if self._ivf:
            sl = np.asarray(slots, dtype=np.int64)
            self._used_slots += len(sl)
            spare = sl // self.shards >= self._kc
            if spare.any():
                np.add.at(self._spare_used, (sl % self.shards)[spare], 1)

    # -- growth / rebuild (``zebra_tpu/parallel/sharded.py:617-686``) -------------

    _ADOPT_EXTRA = ("_next_slots", "_used_slots", "_spare_used", "_kc")

    def _clone_empty(self):
        import dataclasses

        return type(self)(dim=self.dim, metric=self.metric,
                          options=dataclasses.replace(self.options, rerank=self._given_rerank),
                          metric_power=self.metric_power, mesh=self.mesh)

    def _rebuild_reason(self) -> str | None:
        n_live = len(self._id_to_slot)
        if n_live == 0 or self.state is None:
            return None
        if n_live > 4.0 * max(self._built_n, 1):
            return "growth"
        if self._ivf:
            used = self._used_slots
            spare_cap = self.state[0].slab_capacity - self._kc
            if self._spare_used.max() > 0.9 * max(spare_cap, 1):
                return "spare-critical"
            if (used - n_live) > 0.5 * max(used, 1):
                return "tombstones"
            per_shard_live = max(n_live // max(self.shards, 1), 1)
            if (self._spare_used.max() > 0.75 * max(spare_cap, 1)
                    or self._spare_used.max() > max(0.125 * per_shard_live, 4096)):
                return "spare-pressure"
            return None
        # one readback of every shard's overflow counter
        overflow = int(torch.stack([st.overflow.to(self.device) for st in self.state]).sum())
        used = sum(self._next_slots)
        if (self.options.index_type != "flat" and overflow > 0.02 * n_live
                and self.options.resolved_bits(max(1, n_live // self.shards))
                > self.state[0].bits):
            return "overflow-bits"
        if used - n_live > 0.5 * max(used, 1):
            return "tombstones"
        return None

    def _live_order_ids(self):
        """The live slots and their ids in a seeded random order, which a
        rebuild, a retrain and a reshard re-insert: in slot order (cell
        order) the block split would hand each shard whole regions of the
        space, where every shard's cells are sized for an even share of
        each cell's rows (ROADMAP.md queue 3)."""
        order = self._slot_ids.live_slots()
        order = order[np.random.default_rng(self.options.seed + 29).permutation(len(order))]
        return order, self._slot_ids.take_list(order)

    def _train_sample_target(self, n: int) -> int:
        """Rows a retrain trains on: a single index's sample for IVF (its
        one k-means serves every shard), the JAX package's 65,536 for LSH."""
        if self._ivf:
            k = resolved_clusters(self.options, max(n, 1))
            return min(n, max(self.options.kmeans_sample, 4 * k))
        return super()._train_sample_target(n)

    def _pre_rebuild(self, reason: str | None) -> None:
        logger.info("sharded rebuild (%s): %d live vectors", reason, len(self._id_to_slot))

    def _reset_alloc_mirrors(self) -> None:
        self._next_slots = [0] * self.shards
        self._used_slots = 0
        self._spare_used = np.zeros(self.shards, dtype=np.int64)

    def clear(self) -> None:
        super().clear()
        self._reset_alloc_mirrors()

    # -- delete / search -----------------------------------------------------------

    def _delete_slots_device(self, slots: np.ndarray) -> None:
        delete = V.delete_slots if self._ivf else B.delete_slots
        for s, _, local in self._by_shard(slots[slots >= 0]):
            st = self.state[s]
            delete(st, torch.from_numpy(local).to(st.device))

    def _shard_rows(self, st, local: np.ndarray) -> torch.Tensor:
        if self._ivf:
            return stored_rows(st, local)
        return st.vectors[torch.as_tensor(local, device=st.device)]

    def _take_rows(self, slots: np.ndarray) -> torch.Tensor:
        """Stored values of the rows at global ``slots`` in their order (IVF
        dequantised as the single index's), gathered per shard onto the
        first device."""
        g = np.asarray(slots, dtype=np.int64)
        parts = [(pos, self._shard_rows(self.state[s], local)) for s, pos, local in self._by_shard(g)]
        if not parts:
            return self._shard_rows(self.state[0], g[:0]).to(self.device)
        out = torch.empty((len(g), parts[0][1].shape[1]), dtype=parts[0][1].dtype,
                          device=self.device)
        for pos, rows in parts:
            out[torch.from_numpy(pos).to(self.device)] = rows.to(self.device)
        return out

    def _row_hashes(self, slots: np.ndarray) -> np.ndarray:
        from zebra_tpu_torch.ops.rowhash import row_hashes

        g = np.asarray(slots, dtype=np.int64)
        per = np.stack([row_hashes(st.vectors).cpu().numpy() for st in self.state])
        return per[g % self.shards, g // self.shards]

    def _candidate_width(self, st: B.LSHState, probes: int) -> tuple[int, bool]:
        """``LSHIndex._candidate_width`` for one shard's tables."""
        mc = max(self.options.max_candidates, 0)
        full = st.num_tables * probes * st.bucket_capacity
        return mc, mc == 0 and full > 65536

    def _query_device(self, q: torch.Tensor, k: int, exact: bool):
        """Every shard's top-k of ``q``, merged on the first device."""
        return merge_partials(self._partials(q, k, exact), k, self.device)

    def _partials(self, q: torch.Tensor, k: int, exact: bool) -> list:
        """Each shard's ``(dists, global slots, valid)`` top-k of ``q`` on its
        device, its re-rank resolved for that device (the kernels on the
        card, the plain versions on the CPU)."""
        o = self.options
        if o.index_type == "flat":
            exact = True
        S = self.shards
        parts = []
        for s, st in enumerate(self.state):
            qs = q.to(st.device)
            if exact:
                bf = V.brute_force if self._ivf else B.brute_force
                d, sl, v = bf(st, qs, k, metric=self.metric, power=self.metric_power,
                              chunk=65536 if o.approx_topk else 8192,
                              precision=o.exact_precision)
            elif self._ivf:
                d, sl, v = V.query(
                    st, qs, k, metric=self.metric, power=self.metric_power,
                    num_probes=o.resolved_probes(), rerank=o.rerank, probe_sel=o.probe_sel,
                    refine_k=o.refine_k(k), refine_scan=o.refine_is_scan(),
                    spare_rows=int(self._spare_used[s]),
                )
            else:
                probes = o.resolved_probes()
                mc, lossless = self._candidate_width(st, probes)
                d, sl, v = B.query(st, qs, k, metric=self.metric, power=self.metric_power,
                                   num_probes=probes, rerank=o.rerank, max_candidates=mc,
                                   lossless=lossless, dim=self.dim,
                                   occupied=self._next_slots[s])
            parts.append((d, torch.where(v, sl * S + s, -1), v))
        return parts

    # -- persistence ---------------------------------------------------------------

    def _meta_extra(self) -> dict:
        return {"shards": self.shards, "sharded": True}

    def _snapshot_arrays(self) -> dict:
        """The JAX package's stacked members: ``[S, ...]`` per state field
        (the 0-d counters stacked on the first device), ``ccap`` a scalar."""
        names = (("centroids", "counts", "vectors", "norms", "valid", "overflow", "scales",
                  "residual", "rscales") if self._ivf else
                 ("planes", "consts", "buckets", "counts", "vectors", "norms", "valid",
                  "next_slot", "overflow"))
        out = {}
        for name in names:
            parts = [getattr(st, name) for st in self.state]
            if parts[0] is None:
                continue
            out[name] = (torch.stack([p.to(self.device) for p in parts]) if parts[0].dim() == 0
                         else StackedSource(parts))
            if name == "overflow" and self._ivf:
                out["ccap"] = np.asarray(self.state[0].cluster_capacity, dtype=np.int32)
        return out

    def _restore_arrays(self, z) -> None:
        """Per-shard states from the stacked members (each shard's rows read
        out of the memmap onto its device); the host mirrors from ``counts``
        and ``next_slot``."""
        names = (("centroids", "counts", "vectors", "norms", "valid", "overflow", "scales",
                  "residual", "rscales") if self._ivf else
                 ("planes", "consts", "buckets", "counts", "vectors", "norms", "valid",
                  "next_slot", "overflow"))
        members = {n: z[n] for n in names if n in z}
        states = []
        for s, dev in enumerate(self.shard_devices):
            arrays = {n: m[s] for n, m in members.items()}
            if self._ivf:
                arrays["ccap"] = z["ccap"]
                states.append(V.state_from_numpy(arrays, device=dev))
            else:
                states.append(B.state_from_numpy(arrays, device=dev, dtype=self.dtype))
        self.state = states
        if self._ivf:
            counts = np.asarray(members["counts"])  # [S, K+1]
            self._kc = states[0].num_clusters * states[0].cluster_capacity
            self._used_slots = int(counts.sum())
            self._spare_used = counts[:, -1].astype(np.int64).copy()
        else:
            self._next_slots = [int(v) for v in np.asarray(members["next_slot"]).reshape(-1)]

    @classmethod
    def load(cls, directory: str, mesh=None, shards: int | None = None, device=None):
        """Open a snapshot. The target shard count is ``mesh``'s, else
        ``shards``, else the saved count on an explicit ``device`` (which
        holds every shard), else the saved count capped at the visible CUDA
        cards. When it differs from the saved count, the live rows re-shard:
        one k-means over them, then a chunked re-add."""
        meta = read_meta(directory)
        saved = meta["shards"]
        if mesh is not None:
            target = mesh.shape[SHARD_AXIS]
        elif shards is not None:
            target = shards
        elif device is not None:
            target = saved
        else:
            target = min(saved, torch.cuda.device_count() if torch.cuda.is_available() else 0)
        if target != saved and meta.get("has_state"):
            return cls._load_resharded(directory, meta, mesh, target, device)
        idx = cls._construct_for_load(meta, mesh=mesh, shards=target, device=device)
        idx._load_state(directory, meta)
        return idx

    @classmethod
    def _load_resharded(cls, directory, meta, mesh, target, device):
        """Rebuild over ``target`` shards from the snapshot's bytes
        (``zebra_tpu/parallel/sharded.py:850-911``): the live rows,
        dequantised from memmap views, one k-means for the whole live count,
        then a re-add of ``CHUNK_BYTES`` of f32 rows at a time, in a seeded
        random order where the JAX package keeps global-slot order."""
        from zebra_tpu_torch.storage.snapshots import CHUNK_BYTES, open_snapshot_arrays

        idx = cls._construct_for_load(meta, mesh=mesh, shards=target, device=device)
        S_old = meta["shards"]
        with open_snapshot_arrays(directory, meta) as z:
            vectors = z["vectors"]  # [S_old, cap, D] memmap (uint16 bits if bf16)
            valid = z["valid"]
            arena = SlotIdArena.from_array(np.array(z["slot_ids"]))
            scales = z["scales"] if "scales" in z else None
            residual = z["residual"] if "residual" in z else None
            rscales = z["rscales"] if "rscales" in z else None

            live = arena.live_slots()
            live = live[np.asarray(valid[live % S_old, live // S_old])]
            n_live = len(live)
            if not n_live:
                return idx

            def take_rows(slots) -> np.ndarray:
                sh, lo = slots % S_old, slots // S_old
                rows = np.asarray(vectors[sh, lo])
                if rows.dtype == np.uint16:  # bf16 bit patterns
                    return torch.from_numpy(rows.view(np.int16)).view(torch.bfloat16).float().numpy()
                if rows.dtype == np.int8:
                    out = rows.astype(np.float32) * np.asarray(scales[sh, lo])[:, None]
                    if residual is not None:
                        out = out + (np.asarray(residual[sh, lo]).astype(np.float32)
                                     * np.asarray(rscales[sh, lo])[:, None])
                    return out
                return np.ascontiguousarray(rows, dtype=np.float32)

            sample_n = min(n_live, idx.options.kmeans_sample)
            sample = live if sample_n == n_live else np.sort(
                idx._rng.choice(live, size=sample_n, replace=False))
            idx.state = idx._fresh_state(n_live, take_rows(sample))
            idx._built_n = n_live
            # re-added in a seeded random order (``_live_order_ids``), each
            # chunk read from the memmap in slot order
            live = live[np.random.default_rng(idx.options.seed + 29).permutation(n_live)]
            rows_per_chunk = max(4096, CHUNK_BYTES // max(idx.dim * 4, 1))
            for s in range(0, n_live, rows_per_chunk):
                chunk = live[s : s + rows_per_chunk]
                by_slot = np.argsort(chunk)
                rows = np.empty((len(chunk), idx.dim), np.float32)
                rows[by_slot] = take_rows(chunk[by_slot])
                idx.add(rows, ids=arena.take_list(chunk))
        return idx

    # -- maintenance stats -----------------------------------------------------------

    def stats(self) -> dict:
        if self.state is None:
            return {"vectors": 0, "built": False, "shards": self.shards}
        st = self.state[0]
        overflow = int(torch.stack([s.overflow.to(self.device) for s in self.state]).sum())
        if self._ivf:
            return {
                "vectors": len(self._id_to_slot),
                "built": True,
                "shards": self.shards,
                "clusters_per_shard": st.num_clusters,
                "cluster_capacity": st.cluster_capacity,
                "slab_capacity_per_shard": st.slab_capacity,
                "used_slots": self._used_slots,
                "spare_used": int(self._spare_used.sum()),
                "overflow": overflow,
                "tombstones": self._used_slots - len(self._id_to_slot),
            }
        return {
            "vectors": len(self._id_to_slot),
            "built": True,
            "shards": self.shards,
            "tables": st.num_tables,
            "bits": st.bits,
            "bucket_capacity": st.bucket_capacity,
            "slab_capacity_per_shard": st.slab_capacity,
            "used_slots": sum(self._next_slots),
            "overflow": overflow,
        }


#: the JAX package's name for the class (it served only LSH at first)
ShardedLSHIndex = ShardedIndex
