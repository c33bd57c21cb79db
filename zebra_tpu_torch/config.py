"""Configuration dataclasses.

A copy of ``zebra_tpu/config.py`` (framework-free, so both packages read and
write the same manifests); only :meth:`IndexOptions.resolved_rerank` differs,
resolving by the torch device the index lives on.

The reference fixes dimension/metric/model at the *type* level
(``src/database/core.rs:55-64``) and exposes two runtime index knobs,
``max_node_size=5`` / ``num_trees=15`` (``src/database/index/lsh.rs:124-138``).
Here everything is one runtime config persisted in the database manifest; the
tree knobs map onto their hash-table analogues:

- ``num_trees``        -> ``num_tables``  (one hash table per tree)
- tree depth           -> ``bits`` per hash code (root-to-leaf sign decisions
                          become one packed b-bit code; ``bits="auto"`` picks
                          ``ceil(log2(n / max_node_size))`` at build time, the
                          same adaptive depth the recursive splitting reaches)
- ``max_node_size``    -> expected bucket load (drives the auto bit count);
                          ``bucket_capacity`` is the physical slot count per
                          bucket (kept larger to absorb Poisson tails)
- sibling backtracking -> ``num_probes`` multi-probe queries
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, ClassVar


@dataclass(frozen=True)
class IndexOptions:
    """Tuning knobs of the LSH bucket index.

    Reference analogue: ``LSHIndexOptions{max_node_size: 5, num_trees: 15}``
    (``src/database/index/lsh.rs:131-138``).
    """

    #: "ivf" (the default flagship) = learned k-means partitions over a
    #: cluster-contiguous slab — probes are block reads, the fastest ANN
    #: path on TPU (see index/ivf.py; measured 1M x 768 bf16 on one v5e:
    #: 267.8k QPS @ recall@10 0.9984 vs ~12k for lsh); "lsh" = bucketed ANN
    #: (reference-parity opt-in, ``lsh.rs:131-138`` semantics); "flat" =
    #: exact brute-force scan on the MXU — recall 1.0 and, below a few
    #: million vectors, FASTER than the gather-based LSH path on TPU
    #: (batched matmul beats random HBM gathers).
    index_type: str = "ivf"
    num_tables: int = 15
    #: target mean bucket load; reference leaf capacity ``max_node_size=5``.
    max_node_size: int = 5
    #: hash code width; 0 = auto (chosen from data size at first build).
    bits: int = 0
    #: physical slots per bucket row; 0 = auto (4x max_node_size, min 16).
    bucket_capacity: int = 0
    #: probe width at query time; 0 = auto per backend. ivf: clusters probed
    #: (4 = the measured v5e headline point, recall@10 0.9984 at 1M x 768).
    #: lsh: buckets probed per table (10 keeps the candidate width within one
    #: re-rank chunk (2048) — crossing it halves QPS; 1 = exact-code only).
    num_probes: int = 0
    #: re-rank width after dedup-compaction; <= 0 = no compaction (gather
    #: every probed bucket entry — measured faster on v5e unless memory-bound).
    max_candidates: int = 0
    #: re-rank backend: "auto" (the default — resolves to "pallas" for IVF
    #: indexes on a TPU backend whose dim is already a 128-lane multiple, so
    #: the kernel never pads; "xla" everywhere else — the rule under which
    #: every measured headline was recorded), "xla" (any metric) or "pallas"
    #: (fused kernel, cosine/l2/sql2 on TPU; results verified identical).
    #: Explicit "pallas" pads stored dims up to the next 128 multiple for
    #: its DMAs (LSH's flat-slab kernel pads to 1024-f32 multiples).
    rerank: str = "auto"
    #: matmul precision for EXACT (flat / brute-force) scans: "highest" =
    #: full f32 (6 MXU passes), "default" = bf16-grade passes (~6x faster,
    #: ~0.5% distance error — usually fine for ranking).
    exact_precision: str = "highest"
    #: use lax.approx_max_k in flat scans (TPU-native partial top-k reduction:
    #: measured 1M x 768 per chip: 8.5k QPS at 0.997 top-10 agreement with
    #: exact, or 32k QPS combined with exact_precision="default" at ~0.92).
    approx_topk: bool = False
    #: initial vector-slab capacity; 0 = auto.
    slab_capacity: int = 0
    # -- ivf backend knobs ---------------------------------------------------
    #: number of k-means partitions; 0 = auto (~n/64 cells, power of two —
    #: see ivf_host.resolved_clusters for why not the classic ~4*sqrt(n)).
    num_clusters: int = 0
    #: slab rows reserved per cluster; 0 = auto (2x mean load, multiple of 16).
    cluster_capacity: int = 0
    #: shared spare-region rows (always-scanned overflow heap for vectors
    #: whose spill targets are all full); 0 = auto (~n/16, power of two).
    spare_capacity: int = 0
    #: nearest-centroid fallbacks when a cluster is full before the host
    #: grows capacity (FAISS-style spill; vectors are never dropped).
    spill: int = 8
    #: Lloyd iterations for centroid training.
    kmeans_iters: int = 8
    #: split-heavy balance rounds after Lloyd (2 settle iterations each) —
    #: bounds the max cell load, which caps IVF spill/spare pressure.
    kmeans_balance_rounds: int = 6
    #: max training-sample rows for k-means (subsampled from the build data).
    kmeans_sample: int = 262144
    #: IVF wave-kernel dot precision: "auto" = fused split-query bf16 dot
    #: ("bf16x2f": qhi/qlo ride as two lhs ROWS of ONE MXU issue) on
    #: reduced-precision slabs (bf16/int8 — per-pass products are exact
    #: there; 332.9k vs 319.5k QPS for the 2-issue "bf16x2" and ~+29% over
    #: the 6-pass f32 "highest", top-10 overlap 0.9999;
    #: bench_results/r3_sweep_fused_dots.json, tools/abl_aux.py) and
    #: "bf16x3f" on f32 slabs (3-term split of both operands fused to 2
    #: issues — the dropped qlo*blo term is below f32 rounding; the x3
    #: baseline measured 219.5k vs 212.4k at identical true-f32 recall
    #: 1.0, r3_ann_f32_p4_x3.json). Explicit: "highest" (exact 6-pass f32)
    #: | "bf16x3[f]" | "bf16x2[f]" | "bf16" (1-pass, bf16-rounded query
    #: wire — fastest, ~0.998 overlap).
    rerank_dots: str = "auto"
    #: IVF probe selection: "auto"/"fast" = 1-pass bf16 centroid score +
    #: bf16 approx top-2P + exact f32 rescore of the survivors (measured
    #: ~0.45ms vs ~1.2ms per 1024-batch, MORE faithful than the direct f32
    #: approx top-P it replaces — tools/abl_centroid.py); "f32" = the
    #: single-stage 3-pass-f32 path.
    probe_sel: str = "auto"
    #: query staging dtype: "auto" ships queries as bf16 whenever the slab
    #: itself is reduced-precision (bf16/int8) — halves the host->device
    #: bytes of every search, which BOUNDS facade QPS on PCIe/tunnel links;
    #: scoring still runs in f32 from the shipped values. "float32" ships
    #: exact queries regardless. "bfloat16" FORCES the half-width wire even
    #: on the refined-int8 tier ("auto" keeps f32 there: the refine pass
    #: re-ranks at ~15-bit stored precision, which an 8-bit-mantissa query
    #: would cap — measure the recall cost vs the 2x upload saving on your
    #: link before flipping; ``bench.py --query-wire bfloat16``).
    query_wire: str = "auto"
    #: slab / compute dtype: "auto" (the default — "int8" for the IVF
    #: flagship, whose residual-refine tier [see ``refine``] stores ~15-bit
    #: reconstructions at 2 B/elem and IS the measured headline:
    #: 602.6k QPS @ true-f32 recall 0.9922 at 1M x 768 on one v5e,
    #: r3_ann_int8_scan_p2.json; "float32" for lsh/flat, whose parity/exact
    #: contracts want exact slabs), "float32", "bfloat16" (hash & re-rank in
    #: f32), or "int8" (ivf only: symmetric per-row quantised slab + f32
    #: scales — halves HBM probe traffic again vs bf16; distances dequantise
    #: after the MXU dot, norms/scales describe the stored values exactly).
    dtype: str = "auto"
    #: int8 residual refinement (ivf + dtype="int8" only): 0 = off; N > 1
    #: stores a SECOND int8 slab holding each row's quantisation residual
    #: (reconstruction scale*v8 + rscale*r8 ~ 15 mantissa bits, better than
    #: bf16) and re-ranks an N*k-oversampled candidate set against it at
    #: query time. The probe scan still reads only the 1-byte coarse slab —
    #: int8 scan bandwidth with ~f32-grade TRUE recall (plain int8 slabs
    #: measure ~0.954 true-f32 recall at 1M x 768; the known limitation this
    #: closes). Costs 1 byte/element extra HBM (total 2B/elem — the same as
    #: bf16) plus a [B, N*k, D] int8 gather + two skinny dots per query.
    #: ``refine="scan"`` instead STREAMS the residual slab through the probe
    #: kernel alongside the coarse slab — every scanned row scores against
    #: the full ~15-bit reconstruction (int8 -> bf16 casts are exact), so
    #: there is no oversample cutoff and no per-candidate gather pass at
    #: all; probe traffic is 2 bytes/element (= a bf16 slab's) with BETTER
    #: than bf16 precision. Prefer "scan" when probes dominate query time
    #: (large batches), an integer oversample when gathers are cheaper than
    #: doubling probe bytes (small k, few probes).
    #: Refine-built indexes quantise on the HOST and ship the int8 pair +
    #: scales (~2 B/elem — bf16-tier wire bytes at full stored precision);
    #: their queries still ship f32 (the refine re-rank deserves exact
    #: queries and query wire bytes are negligible).
    #: "auto" (the default) resolves to "scan" whenever the slab dtype
    #: resolves to int8 (the measured headline tier), else 0.
    refine: int | str = "auto"
    #: "data" samples hyperplanes as bisectors of random stored-vector pairs
    #: (the reference's scheme, ``lsh.rs:221-230``); "random" uses Gaussian
    #: projections. "data" generally matches reference recall on clustered data.
    plane_mode: str = "data"
    #: snapshot container: "npz" (default — ONE streamed, np.load-compatible
    #: file with bounded host memory; storage/snapshots.py) or "orbax"
    #: (optional orbax/tensorstore checkpoint directory — multi-host-capable:
    #: each host writes only the mesh shards it owns; storage/orbax_snap.py).
    #: The format is recorded in the snapshot's index.json, so load()
    #: dispatches automatically whichever knob the opening process has.
    snapshot_format: str = "npz"
    seed: int = 0

    @classmethod
    def tier(cls, name: str, **overrides) -> "IndexOptions":
        """First-class named presets (round-3 verdict #2).

        - "fast": the measured TPU headline — IVF, int8 coarse + int8
          residual streamed through the probe kernel (2 B/elem probe
          traffic, ~15-bit stored precision; 602.6k QPS @ true-f32 recall
          0.9922 at 1M x 768 on one v5e chip, r3_ann_int8_scan_p2.json).
          Identical to the bare defaults — spelled out for code that wants
          to SAY which tier it means.
        - "balanced": IVF bf16 slab at P=4 — in-slab recall 1.0 / truth
          0.9891 (r3_ann_bf16_p4_tiles.json, 540.9k QPS), for users who
          want no quantisation below bf16 anywhere.
        - "exact": flat f32 brute-force scan on the MXU — recall 1.0 by
          construction, full-precision distances ("highest" 6-pass f32).

        ``overrides`` are applied on top (e.g. ``tier("fast", num_probes=4)``).
        """
        presets = {
            "fast": dict(index_type="ivf", dtype="int8", refine="scan"),
            "balanced": dict(index_type="ivf", dtype="bfloat16", refine=0,
                             num_probes=4),
            "exact": dict(index_type="flat", dtype="float32", refine=0,
                          exact_precision="highest"),
        }
        if name not in presets:
            raise ValueError(
                f"unknown tier {name!r}: pick from {sorted(presets)}"
            )
        return cls(**{**presets[name], **overrides})

    #: HBM budget for the bucket tables ([T, 2^b, C] int32 slots + [T, 2^b]
    #: counts) — the auto bit width grows until the tables would exceed it.
    #: 2GB rides alongside a 1M x 768 f32 slab (3GB) on a 16GB chip with
    #: room for query transients; at the measured parity config (T=10,
    #: C=20) it admits b=21 (1.76GB), where the round-4 16-bit hard cap
    #: stopped at 0.2% of that and silently dropped 75% of placements at
    #: 1M rows (round-4 verdict #4). ClassVar: policy, not a manifest field.
    TABLE_HBM_BUDGET: "ClassVar[int]" = 2 << 30

    def resolved_bits(self, n: int, capacity: int | None = None) -> int:
        """Hash code width for ~n vectors. ``capacity`` = physical bucket
        slot count if the caller boosted it past
        :meth:`resolved_bucket_capacity` (wider buckets shrink the bit
        budget — the two levers trade off inside one table allocation)."""
        if self.index_type == "flat":
            return 1  # vestigial tiny tables; flat queries scan the slab
        if self.bits > 0:
            return self.bits
        import math

        target = max(1, self.max_node_size)
        b = math.ceil(math.log2(max(n, 2) / target)) if n > target else 1
        cap = capacity or self.resolved_bucket_capacity()
        per_bucket = max(self.num_tables, 1) * (cap + 1) * 4
        b_budget = int(
            math.floor(math.log2(max(self.TABLE_HBM_BUDGET // per_bucket, 2)))
        )
        return int(min(max(b, 1), max(b_budget, 1), 22))

    def resolved_dtype(self, index_type: str | None = None) -> str:
        """Concrete slab dtype ("auto" resolves per backend — deterministic,
        no platform dependence, so snapshots stay portable): the IVF
        flagship gets the measured headline tier's int8 (+ residual — see
        :meth:`resolved_refine`); lsh keeps the reference-parity f32 slab
        and flat keeps exact f32. ``index_type`` overrides the options
        field — a backend constructed DIRECTLY (not via ``make_index``)
        resolves for what it actually is."""
        if self.dtype != "auto":
            return self.dtype
        t = index_type or self.index_type
        return "int8" if t == "ivf" else "float32"

    def resolved_refine(self, index_type: str | None = None) -> int | str:
        """Concrete refine flavour: "auto" = "scan" whenever the slab
        resolves to int8 on IVF (the headline tier: the residual slab
        streams through the probe kernel — 2 B/elem probe traffic at ~15-bit
        effective precision), else off."""
        if self.refine != "auto":
            return self.refine
        t = index_type or self.index_type
        if t == "ivf" and self.resolved_dtype(t) == "int8":
            return "scan"
        return 0

    def resolved_rerank(self, dim: int, index_type: str | None = None,
                        device: str = "cpu") -> str:
        """Concrete re-rank backend for a ``dim``-wide index whose state
        lives on ``device``. On a CUDA device: "cuda2" for IVF with a stored
        "pallas2" (the one-slab wave kernel ``csrc/ivf_rerank_wave.cu``, as
        "pallas2" selects the JAX package's wave-2 kernel; scan mode has no
        wave form and runs the probe kernel, see ``ivf.query``), else "cuda"
        (the kernel of the index type: ``csrc/ivf_rerank.cu`` for IVF,
        ``csrc/lsh_rerank.cu`` for LSH). Everywhere else "eager" (the plain
        torch re-rank, the JAX package's "xla" path, which is also what it
        maps every "pallas*" to on a CPU). "auto", "pallas" and "xla" all
        name a re-rank of the same semantics. Neither "cuda" nor "cuda2" is
        ever stored: manifests keep persisting what the user wrote, so each
        opening process re-resolves for its own device (an explicit LSH
        "pallas" still pads the stored width, see ``index/lsh.py``)."""
        del dim  # the kernels take any stored width
        t = index_type or self.index_type
        if t not in ("ivf", "lsh") or not str(device).startswith("cuda"):
            return "eager"
        return "cuda2" if t == "ivf" and self.rerank == "pallas2" else "cuda"

    def concrete(self, dim: int, index_type: str | None = None,
                 device: str = "cpu") -> "IndexOptions":
        """This options set with every "auto" tier knob resolved for one
        index instance (called once at index construction — everything
        downstream reads concrete values). ``index_type`` names the actual
        backend class doing the resolving (see :meth:`resolved_dtype`)."""
        import dataclasses as _dc

        dtype = self.resolved_dtype(index_type)
        refine = self.resolved_refine(index_type)
        rerank = self.resolved_rerank(dim, index_type, device)
        if (dtype, refine, rerank) == (self.dtype, self.refine, self.rerank):
            return self
        return _dc.replace(self, dtype=dtype, refine=refine, rerank=rerank)

    def refine_enabled(self) -> bool:
        """True when any residual-refine flavour is on (int factor or "scan")."""
        r = self.resolved_refine()
        if r == "scan":
            return True
        return isinstance(r, int) and r > 0

    def refine_is_scan(self) -> bool:
        return self.resolved_refine() == "scan"

    def query_wire_is_bf16(self) -> bool:
        """One place for the query staging dtype policy (the search path,
        the shape pre-warm, and the bench stage table must all agree):
        "bfloat16" forces the half-width wire; "auto" uses it for every
        reduced-precision slab EXCEPT refined int8: the measured flip
        (``r5_ann_qwire_bf16.json``, 1M x 768) keeps recall@10 IDENTICAL
        (0.9977) and halves the upload that dominates slow-link serving
        batches, but bf16 query rounding adds ~4e-4 relative distance
        error — 10x the ~15-bit slab's own — so the tier's default keeps
        exact distances and wire-bound deployments opt in with
        ``query_wire="bfloat16"``."""
        if self.query_wire == "bfloat16":
            return True
        return (
            self.query_wire == "auto"
            and self.dtype != "float32"
            and not (self.dtype == "int8" and self.refine_enabled())
        )

    def refine_k(self, k: int) -> int:
        """Oversampled candidate width of the gather-refine pass (0 = off /
        scan mode, which needs no oversample)."""
        if not self.refine_enabled() or self.refine_is_scan():
            return 0
        return int(min(max(self.resolved_refine() * k, k + 16), 1024))

    def resolved_probes(self) -> int:
        if self.num_probes > 0:
            return self.num_probes
        if self.index_type == "ivf":
            # refine="scan" scores every probed row at ~15-bit effective
            # precision, so its truth recall at P=2 (0.9922 at 1M x 768)
            # already exceeds the bf16 P=4 tier's (0.9891) — the auto
            # default spends the saved bandwidth on throughput
            # (r3_sweep_int8_scan.json).
            return 2 if self.refine_is_scan() else 4
        return 10

    def resolved_bucket_capacity(self) -> int:
        if self.index_type == "flat":
            return 1
        if self.bucket_capacity > 0:
            return self.bucket_capacity
        return max(16, 4 * self.max_node_size)

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "IndexOptions":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass(frozen=True)
class DatabaseConfig:
    """Full database configuration, persisted in the manifest.

    Mirrors the reference's ``DatabaseInner{uuid, model, metric,
    index_options}`` (``src/database/core.rs:19-29``); dimension is data here,
    not a const-generic.
    """

    dim: int
    metric: str = "cosine"
    #: registered embedding-model name ("" = vectors-only database).
    model: str = ""
    #: power parameter for minkowski / p_norm metrics (``distance.rs:162-190``).
    metric_power: float = 3.0
    index: IndexOptions = field(default_factory=IndexOptions)
    #: number of mesh shards the index is distributed over (1 = single device).
    shards: int = 1
    #: crash-durability of CRUD ops: "full" appends every mutation to an
    #: fsync'd delta log replayed on open (O(batch) — the reference's
    #: per-upsert LSM sync, lsh.rs:87-89, at the same cost class; the log
    #: folds into a real snapshot on save() or when it outgrows one),
    #: "explicit" persists blobs+manifest per op but index state only on
    #: save()/close.
    durability: str = "full"

    def to_json(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["index"] = self.index.to_json()
        return d

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "DatabaseConfig":
        d = dict(d)
        idx = d.pop("index", {})
        known = {f.name for f in dataclasses.fields(cls)} - {"index"}
        return cls(index=IndexOptions.from_json(idx), **{k: v for k, v in d.items() if k in known})

    def dumps(self) -> str:
        return json.dumps(self.to_json(), indent=2, sort_keys=True)

    @classmethod
    def loads(cls, s: str) -> "DatabaseConfig":
        return cls.from_json(json.loads(s))
