"""Device ops of the IVF index (port of ``zebra_tpu/index/ivf.py``).

K learned centroids partition a cluster-contiguous slab: cluster c owns rows
``[c*C, (c+1)*C)`` and fills them as a prefix; rows whose ``spill`` nearest
cells are all full land in a shared spare region at the slab tail, which
every query scans. Queries score all centroids, probe the P nearest blocks,
re-rank exactly and merge the spare.

JAX donates the state to each mutating jit and gets a new one back; the port
updates the state's tensors IN PLACE (``index_copy_`` on the placed rows), so
a mutation costs no second slab. Mutations and queries are ordered by the
facade's RW lock and by running on one CUDA stream.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from zebra_tpu_torch.ops import distances as D
from zebra_tpu_torch.ops import topk as TK
from zebra_tpu_torch.ops.rowhash import _wrap32
from zebra_tpu_torch.storage.snapshots import slab_from_np

#: f32 reciprocal of 127 — int8 quantisation multiplies by it (as the JAX
#: package does on host and device, which keeps the two bitwise equal)
_INV127 = np.float32(1.0 / 127.0)
#: rows quantised per host pass: bounds the f64 temporaries of the FMA
#: emulation (~6 GB for 1M x 768 at once)
QUANT_SPAN = 65536
#: score-tile elements of the insert-time cell choice ([rows, K] f32)
_CHOICE_TILE_ELEMS = 1 << 28
#: eager block re-ranks taken because k exceeded the kernel's MAX_K
EAGER_LARGE_K = 0
#: host pair quantisations by path: the native kernel or the numpy emulation
QUANT_CALLS = {"native": 0, "numpy": 0}


@dataclasses.dataclass
class IVFState:
    """All device tensors of one IVF shard (fields as ``zebra_tpu``'s)."""

    centroids: torch.Tensor  # [K, D] f32
    counts: torch.Tensor  # [K+1] int32 allocated rows per cluster; [K] = spare
    vectors: torch.Tensor  # [K*C + G, D] slab: cluster blocks then the spare
    norms: torch.Tensor  # [K*C + G] f32 squared norms of the stored values
    valid: torch.Tensor  # [K*C + G] bool liveness
    overflow: torch.Tensor  # [] int32 rows dropped with the spare full
    scales: torch.Tensor | None = None  # [K*C + G] f32 (int8 slabs)
    residual: torch.Tensor | None = None  # [K*C + G, D] int8 (refined int8)
    rscales: torch.Tensor | None = None  # [K*C + G] f32
    ccap: int = 0  # cluster block width C
    #: (centroids, bf16 centroids, |c|^2) for select_probes, see probe_operands
    probe_cache: tuple | None = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def num_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def cluster_capacity(self) -> int:
        return self.ccap

    @property
    def spare_capacity(self) -> int:
        return self.vectors.shape[0] - self.num_clusters * self.ccap

    @property
    def spare_start(self) -> int:
        return self.num_clusters * self.ccap

    @property
    def slab_capacity(self) -> int:
        return self.vectors.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vectors.device


def empty_state(centroids: torch.Tensor, cluster_capacity: int, spare_capacity: int = 0,
                dtype=torch.float32, refine: bool = False) -> IVFState:
    """Fresh state on the centroids' device; ``refine`` (int8 only) adds the
    residual slab."""
    K, dim = centroids.shape
    S = K * cluster_capacity + spare_capacity
    dev = centroids.device
    int8 = dtype == torch.int8
    with_res = refine and int8
    f32 = dict(dtype=torch.float32, device=dev)
    return IVFState(
        centroids=centroids.float(),
        counts=torch.zeros((K + 1,), dtype=torch.int32, device=dev),
        vectors=torch.zeros((S, dim), dtype=dtype, device=dev),
        norms=torch.zeros((S,), **f32),
        valid=torch.zeros((S,), dtype=torch.bool, device=dev),
        overflow=torch.zeros((), dtype=torch.int32, device=dev),
        scales=torch.ones((S,), **f32) if int8 else None,
        residual=torch.zeros((S, dim), dtype=torch.int8, device=dev) if with_res else None,
        rscales=torch.ones((S,), **f32) if with_res else None,
        ccap=cluster_capacity,
    )


def state_from_numpy(arrays, device="cpu") -> IVFState:
    """An :class:`IVFState` from numpy arrays named as its fields — a JAX
    state's leaves, or the members of an index snapshot (a bf16 slab arrives
    as uint16 bit patterns or as ``ml_dtypes`` bf16; members a tier lacks are
    absent)."""

    def t(name):
        if name not in arrays:
            return None
        return torch.from_numpy(np.array(arrays[name])).to(device)

    return IVFState(
        centroids=t("centroids").float(), counts=t("counts").int(),
        vectors=slab_from_np(arrays["vectors"], device), norms=t("norms"),
        valid=t("valid").bool(), overflow=t("overflow").int(), scales=t("scales"),
        residual=t("residual"), rscales=t("rscales"), ccap=int(np.asarray(arrays["ccap"])),
    )


def _segmented_ranks(c: torch.Tensor) -> torch.Tensor:
    """Rank of each entry among equal-valued entries of ``c``, in original
    order (stable sort + segment-start running max + inverse scatter)."""
    n = c.shape[0]
    order = torch.argsort(c, stable=True)
    cs = c[order]
    ar = torch.arange(n, device=c.device)
    is_start = torch.ones(n, dtype=torch.bool, device=c.device)
    is_start[1:] = cs[1:] != cs[:-1]
    seg_start = torch.cummax(torch.where(is_start, ar, torch.zeros_like(ar)), 0).values
    ranks = torch.empty_like(ar)
    ranks[order] = ar - seg_start
    return ranks


def _cell_choice(x32: torch.Tensor, centroids: torch.Tensor, metric: str, A: int) -> torch.Tensor:
    """Per-row top-``A`` nearest cells ``[n, A]`` (insert placement), in row
    tiles of ~``_CHOICE_TILE_ELEMS`` scores. Exact top-k (``approx_max_k`` is
    exact on the JAX package's CPU backend too). Below 128 cells, where the
    JAX package takes ``lax.top_k``, equal scores go to the lowest cell, as
    probe selection's exact pass sends them: a row placed in one of several
    equal centroids (a database with fewer distinct rows than cells) then
    lands in the cell its own query probes."""
    K = centroids.shape[0]
    cn2 = (centroids * centroids).sum(-1)
    cn = torch.sqrt(cn2)
    rows = max(256, _CHOICE_TILE_ELEMS // K)
    out = []
    for s in range(0, x32.shape[0], rows):
        dot = x32[s : s + rows] @ centroids.T
        if metric == "cosine":
            # per-row |x| is constant in the argmax — centroid norms only
            score = dot / torch.clamp(cn, min=1e-30)[None, :]
        else:  # sql2 geometry (|x|^2 constant per row)
            score = -(cn2[None, :] - 2.0 * dot)
        out.append(TK.smallest_k(-score, A)[1] if K < 128 else torch.topk(score, A, dim=1).indices)
    return torch.cat(out)


def _jitter(n: int, A: int, device) -> torch.Tensor:
    """Per-row fallback rotation ``r0`` of the JAX placement (ivf.py:234-236):
    int32 wrap-around products, a LOGICAL right shift and ``lax.rem``
    (truncated, sign of the dividend: ``torch.fmod``), computed in int64."""
    h = _wrap32(torch.arange(n, dtype=torch.int64, device=device) * -1640531527)
    h = _wrap32((h ^ ((h & 0xFFFFFFFF) >> 16)) * -2048144789)
    return torch.fmod(_wrap32(torch.abs(h)), max(min(2, A - 1), 1))


def _place_rows(state: IVFState, x32: torch.Tensor, spill: int, metric: str,
                jitter: bool = True):
    """Slab slot per row: nearest cell with room, ``spill`` jittered
    fallbacks (``jitter=False``: the fallbacks in nearest order), then the
    shared spare region.

    Returns ``(slots [n] int64 (-1 = dropped), counts [K+1] int32, dropped)``.
    """
    n = x32.shape[0]
    dev = x32.device
    K, C = state.num_clusters, state.cluster_capacity
    A = min(spill, K)
    choice = _cell_choice(x32, state.centroids, metric, A)
    slots = torch.full((n,), -1, dtype=torch.int64, device=dev)
    counts = state.counts.clone()
    assigned = torch.zeros(n, dtype=torch.bool, device=dev)
    ar = torch.arange(n, device=dev)
    # attempt 0 is the nearest cell; fallbacks rotate by a per-row jitter so
    # one saturated blob splits over several neighbours
    r0 = _jitter(n, A, dev) if jitter else torch.zeros(n, dtype=torch.int64, device=dev)
    oob = torch.full((n,), 2**30, dtype=torch.int64, device=dev)
    for a in range(A):
        if a == 0 or A == 1:
            cand = choice[:, a]
        else:
            cand = choice[ar, 1 + torch.fmod(r0 + (a - 1), A - 1)]
        c = torch.where(assigned, oob, cand)
        rank = _segmented_ranks(c)
        pos = counts[torch.clamp(c, 0, K - 1)].long() + rank
        ok = ~assigned & (pos < C)
        slots = torch.where(ok, c * C + pos, slots)
        # rows not placed this round add 0 (no boolean compaction: no sync)
        counts.index_add_(0, torch.where(ok, c, 0), ok.to(torch.int32))
        assigned |= ok
    # final round: the rest goes to the shared spare region
    G = state.spare_capacity
    spare_pos = counts[K].long() + torch.cumsum((~assigned).long(), 0) - 1
    spare_ok = ~assigned & (spare_pos < G)
    slots = torch.where(spare_ok, K * C + spare_pos, slots)
    counts[K] += spare_ok.sum().int()
    dropped = (slots < 0).sum().int()
    return slots, counts, dropped


def quantise_pair_host(x: np.ndarray, span: int = QUANT_SPAN):
    """Host int8 + residual quantisation, ``(v8, r8, scale, rscale)``,
    bitwise the JAX package's ``quantise_pair_host``.

    The native kernel (``native/zebra_quant.cpp``, hardware ``fmaf``) where
    ``g++`` built it, as the JAX package dispatches; else
    :func:`quantise_pair_numpy` per ``span`` rows. :data:`QUANT_CALLS`
    counts the calls by path."""
    from zebra_tpu_torch.native import quant as NQ

    x32 = np.ascontiguousarray(x, dtype=np.float32)
    if x32.ndim == 2:
        parts = NQ.quantise_pair(x32)
        if parts is not None:
            QUANT_CALLS["native"] += 1
            return parts
    QUANT_CALLS["numpy"] += 1
    return quantise_pair_numpy(x32, span)


def quantise_pair_numpy(x: np.ndarray, span: int = QUANT_SPAN):
    """The fallback of :func:`quantise_pair_host` for hosts without a
    toolchain: :func:`quantise_pair_device` on CPU tensors (the JAX
    package's ``_quantise_pair_numpy``, bitwise), run per ``span`` rows."""
    x32 = np.ascontiguousarray(x, dtype=np.float32)
    n, d = x32.shape
    out = (np.empty((n, d), np.int8), np.empty((n, d), np.int8),
           np.empty((n,), np.float32), np.empty((n,), np.float32))
    for s in range(0, n, span):
        for dst, part in zip(out, quantise_pair_device(torch.from_numpy(x32[s : s + span]))):
            dst[s : s + span] = part.numpy()
    return out


def _write_plan(slots: torch.Tensor):
    """How an insert writes its placed rows without a host sync (the JAX
    package scatters with ``mode="drop"``; a boolean compaction ``slots[ok]``
    would read the placed count back). Every row writes: a placed row its
    own values to its slot, a dropped row (slot -1) the first placed row's
    values to that row's slot again, so duplicate targets carry equal values
    and the bits are those of writing the placed rows alone. With no row
    placed, every row rewrites slot 0 with what it holds.

    Returns ``(target [n], source row [n], any row placed [1] bool)``
    (``index_select`` with a one-element index: indexing by a 0-d tensor
    reads it on the host)."""
    ok = slots >= 0
    first = torch.argmax(ok.to(torch.int32)).reshape(1)  # the first placed row (0: none)
    placed = ok.index_select(0, first)
    target = torch.where(ok, slots, torch.where(placed, slots.index_select(0, first), 0))
    source = torch.where(ok, torch.arange(slots.shape[0], device=slots.device), first)
    return target, source, placed


def _put_rows(dst: torch.Tensor, plan, values: torch.Tensor) -> None:
    """``dst[slots[ok]] = values[ok]`` in place, by a :func:`_write_plan`."""
    target, source, placed = plan
    rows = values[source]
    placed = placed.reshape((1,) * rows.dim())
    dst.index_copy_(0, target, torch.where(placed, rows, dst[target]))


def quantise_pair_device(x32: torch.Tensor):
    """The int8 + residual quantisation of :func:`quantise_pair_host` on the
    rows' own device: ``(v8, r8, scale, rscale)``, bitwise the host mirror
    and the JAX package's device branch (``zebra_tpu/index/ivf.py:299-323``).
    The residual ``x - v8*scale`` takes one f32 rounding (the FMA the JAX
    package's compiler contracts it into): the f64 product and difference
    are exact, so the single cast back is that rounding."""
    one = torch.ones((), dtype=torch.float32, device=x32.device)
    absmax = x32.abs().amax(-1)
    scale = torch.where(absmax > 0, absmax * float(_INV127), one)
    v8 = torch.clamp(torch.round(x32 / scale[:, None]), -127, 127).to(torch.int8)
    res = (x32.double() - v8.double() * scale.double()[:, None]).float()
    rabs = res.abs().amax(-1)
    rscale = torch.where(rabs > 0, rabs * float(_INV127), one)
    r8 = torch.clamp(torch.round(res / rscale[:, None]), -127, 127).to(torch.int8)
    return v8, r8, scale, rscale


def insert(state: IVFState, x: torch.Tensor, spill: int = 4, metric: str = "sql2",
           jitter: bool = True) -> torch.Tensor:
    """Insert a batch of rows (f32, or bf16 from the half-width wire) in
    place (``zebra_tpu/index/ivf.py:266-340``).

    An int8 slab stores the per-row symmetric quantisation, ``scale = absmax
    / 127`` (1 for an all-zero row) and codes ``round(x / scale)`` (half to
    even) clipped to +-127; a residual-bearing state also stores the int8
    quantisation of the error (:func:`quantise_pair_device`: a rebuild's
    captured rows, a retrain's capture chunks); a bf16 / f32 slab stores the
    cast. Placement uses the rows as given; ``norms`` hold the squared norm
    of the STORED value (dequantised, reconstructed or rounded), so re-rank
    distances are exact w.r.t. the slab.

    ``jitter=False`` takes a full cell's fallbacks in nearest order (the
    sharded index's placement, ``parallel/sharded.py``).

    Returns slots ``[n]`` int64 (-1 = dropped: the spare was full too).
    """
    x32 = x.float()
    slots, counts, dropped = _place_rows(state, x32, spill, metric, jitter)
    plan = _write_plan(slots)
    if state.residual is not None:
        xd, r8, scale, rscale = quantise_pair_device(x32)
        xs32 = xd.float() * scale[:, None] + r8.float() * rscale[:, None]
        _put_rows(state.scales, plan, scale)
        _put_rows(state.residual, plan, r8)
        _put_rows(state.rscales, plan, rscale)
    elif state.vectors.dtype == torch.int8:
        absmax = x32.abs().amax(-1)
        scale = torch.where(absmax > 0, absmax * float(_INV127), torch.ones_like(absmax))
        xd = torch.clamp(torch.round(x32 / scale[:, None]), -127, 127).to(torch.int8)
        xs32 = xd.float() * scale[:, None]
        _put_rows(state.scales, plan, scale)
    else:
        xd = x32.to(state.vectors.dtype)
        xs32 = xd.float()
    state.counts = counts
    _put_rows(state.vectors, plan, xd)
    _put_rows(state.norms, plan, (xs32 * xs32).sum(-1))
    _put_rows(state.valid, plan, torch.ones_like(slots, dtype=torch.bool))
    state.overflow += dropped
    return slots


def insert_quant(state: IVFState, v8: torch.Tensor, r8: torch.Tensor,
                 qscales: torch.Tensor, spill: int = 4, metric: str = "sql2") -> torch.Tensor:
    """Insert a host-quantised batch into a residual-bearing int8 state, in
    place. ``qscales`` is ``[n, 2]`` (scale, rscale). Codes are stored
    unchanged (the WAL record and the slab stay bitwise equal); placement and
    norms use the reconstruction ``v8*scale + r8*rscale``.

    Returns slots ``[n]`` int64 (-1 = dropped: the spare was full too).
    """
    scale, rscale = qscales[:, 0], qscales[:, 1]
    x32 = v8.float() * scale[:, None] + r8.float() * rscale[:, None]
    slots, counts, dropped = _place_rows(state, x32, spill, metric)
    plan = _write_plan(slots)
    state.counts = counts
    _put_rows(state.vectors, plan, v8)
    _put_rows(state.residual, plan, r8)
    _put_rows(state.norms, plan, (x32 * x32).sum(-1))
    _put_rows(state.scales, plan, scale)
    _put_rows(state.rscales, plan, rscale)
    _put_rows(state.valid, plan, torch.ones_like(slots, dtype=torch.bool))
    state.overflow += dropped
    return slots


def grow_spare(state: IVFState) -> IVFState:
    """The state with its spare region doubled (zero rows appended at the
    tail; slot numbering unchanged)."""
    g = max(state.spare_capacity, 1024)

    def pad(t, value=0):
        if t is None:
            return None
        tail = torch.full((g, *t.shape[1:]), value, dtype=t.dtype, device=t.device)
        return torch.cat([t, tail])

    return dataclasses.replace(
        state, vectors=pad(state.vectors), norms=pad(state.norms),
        valid=pad(state.valid, False), scales=pad(state.scales, 1.0),
        residual=pad(state.residual), rscales=pad(state.rscales, 1.0),
    )


def delete_slots(state: IVFState, slots: torch.Tensor) -> None:
    """Tombstone slab slots in place (negative entries ignored); cluster
    counts keep their allocated width."""
    s = slots[slots >= 0].long()
    state.valid[s] = False


def probe_operands(state: IVFState):
    """``(bf16 centroids, |c|^2 in f32)`` of the state's centroids, cast once
    and cached on the state. A state that replaces its ``centroids`` tensor
    (every cold build and ``load`` makes a new state) recomputes them; the
    centroids are never updated in place."""
    cache = state.probe_cache
    if cache is None or cache[0] is not state.centroids:
        cents = state.centroids
        cache = (cents, cents.to(torch.bfloat16), (cents * cents).sum(-1))
        state.probe_cache = cache
    return cache[1], cache[2]


def select_probes(state: IVFState, q32: torch.Tensor, P: int, sel_metric: str,
                  probe_sel: str = "auto") -> torch.Tensor:
    """The ``P`` nearest clusters per query, ``[B, P]`` int64.

    "auto"/"fast" with K >= 128 and 2P < K: stage 1 ranks the scores of
    bf16-rounded q and centroids (f32 accumulation) and keeps 2P; stage 2
    rescores those in f32 and keeps P. Otherwise one f32 scoring pass. On the
    card stage 1's product is one bf16 tensor-core GEMM with an f32
    accumulator and f32 output (``torch.mm(..., out_dtype=float32)``, as the
    reference's bf16 MXU pass); the CPU, which has no kernel for it,
    multiplies the bf16 operands in f32 (the products are exact either way;
    only the order of accumulation differs). The reference rounds the scores
    to bf16 and leaves the order among equal ones to ``approx_max_k``; here
    ``torch.topk`` runs on the unrounded f32 scores, which is the same order
    with equal bf16 scores broken by their f32 value. Broken by anything
    else, a crowded query (several centroids within one bf16 step of its
    nearest) could lose its own nearest cell from the 2P candidates, and an
    inserted row then misses itself (ROADMAP.md queue 3).
    """
    K = state.num_clusters
    if probe_sel in ("auto", "fast") and K >= 128 and 2 * P < K:
        return rescore_probes(state, q32, probe_candidates(state, q32, 2 * P, sel_metric), P,
                              sel_metric)
    _, probes = TK.smallest_k(D.pairwise(q32, state.centroids, metric=sel_metric), P)
    return probes


def probe_candidates(state: IVFState, q32: torch.Tensor, n: int, sel_metric: str,
                     emulate: bool | None = None) -> torch.Tensor:
    """Stage 1 of :func:`select_probes`: the ``n`` best clusters per query by
    the f32 scores of the bf16-rounded operands, ``[B, n]`` int64.
    ``emulate`` (default: on the CPU) multiplies the bf16 operands in f32 on
    the CUDA cores instead of the one bf16 GEMM with an f32 accumulator (the
    plain version of the card's stage 1)."""
    cb, cn2 = probe_operands(state)
    qb = q32.to(torch.bfloat16)
    if emulate is None:
        emulate = not qb.is_cuda
    if emulate:
        dot = qb.float() @ cb.float().T
    else:
        dot = torch.mm(qb, cb.T, out_dtype=torch.float32)
    if sel_metric == "cosine":
        s = dot * torch.rsqrt(torch.clamp(cn2, min=1e-30))[None, :]
    else:  # l2 / sql2: same argmax ordering
        s = 2.0 * dot - cn2[None, :]
    return torch.topk(s, n, dim=1).indices


def rescore_probes(state: IVFState, q32: torch.Tensor, cand: torch.Tensor, P: int,
                   sel_metric: str) -> torch.Tensor:
    """Stage 2 of :func:`select_probes`: the ``P`` best of the candidate
    clusters ``cand [B, n]`` by exact f32 scores."""
    cents = state.centroids
    _, cn2 = probe_operands(state)
    dots = torch.einsum("bd,bpd->bp", q32, cents[cand])
    cn2c = cn2[cand]
    if sel_metric == "cosine":
        fs = dots * torch.rsqrt(torch.clamp(cn2c, min=1e-30))
    else:
        fs = 2.0 * dots - cn2c
    _, ix = TK.smallest_k(-fs, P)
    return torch.gather(cand, 1, ix)


def _query_chunk_rows(state: IVFState, B: int, k: int, eager: bool, kk: int = 0,
                      probes: int = 0, elementwise: bool = False) -> int:
    """Queries per pass, bounding the per-pass transients: the [B, K] score
    pair (8 B/row/cluster), the cluster-major re-rank's [B, P*C] f32 distance
    buffer and its sorted pairs and work items (~64 B a probe), under refine
    (``kk`` > k) the [B, kk, D] int8 residual gather and its f32 dot operand
    (3*kk*D bytes a row, the JAX package's slack) and, on the eager path, one
    probe's [B, C, D] gather in f32 plus its residual (an elementwise metric
    holds a few more [B, C, D] f32 intermediates: 24 bytes an element in
    all, which keeps each at or under a sixth of the budget). The JAX package
    hard-codes a budget for a 16 GB TPU; here it is a quarter of the device's
    free memory (``torch.cuda.mem_get_info``), or 1 GiB on the CPU."""
    kk = max(kk, k)
    per_row = state.num_clusters * 8 + 64 * kk + probes * (state.cluster_capacity * 4 + 64)
    if kk != k:
        per_row += 3 * kk * state.dim
    if eager:
        per_row += state.cluster_capacity * state.dim * (24 if elementwise else 12)
    dev = state.device
    budget = torch.cuda.mem_get_info(dev)[0] // 4 if dev.type == "cuda" else 1 << 30
    return max(1, min(B, budget // per_row))


def query(state: IVFState, q: torch.Tensor, k: int, metric: str = "cosine",
          num_probes: int = 8, rerank: str = "eager", probe_sel: str = "auto",
          refine_k: int = 0, refine_scan: bool = False, spare_used: bool | None = None,
          spare_rows: int | None = None,
          power: float = 3.0):
    """Approximate top-k: score centroids -> top-P blocks -> exact re-rank ->
    spare merge -> refine.

    Residual-bearing states have two modes. ``refine_scan`` scores every
    probed row against the int8 + residual reconstruction (and overrides
    ``refine_k``). Otherwise the probe scan reads the coarse slab alone and
    keeps ``refine_k`` (> k) candidates, which :func:`_refine_topk` re-scores
    against the reconstruction down to ``k``.

    ``rerank="cuda"`` takes the probe kernel (:func:`ivf_rerank.ivf_rerank`);
    ``"cuda2"`` takes the one-slab wave kernel
    (:func:`experimental_ivf.ivf_rerank_wave`), except in scan mode, which
    it has no form for and which falls to the probe kernel. Either needs the
    scanned width (``refine_k`` or k) <= 128; a wider one takes the eager
    block path and is counted in :data:`EAGER_LARGE_K`. The nine elementwise
    metrics never take a kernel: their cells are chosen by sql2 (as the
    insert placed them) and their blocks re-ranked on the eager path;
    ``power`` is minkowski's and p_norm's exponent. ``spare_used`` is the
    caller's host mirror of a non-empty spare (None: read ``counts[-1]``, a
    sync); ``spare_rows``, where given, the mirror of the spare's filled
    prefix, which is then all the spare merge scans (the same answers: the
    rest of the region holds no valid row).

    Returns ``(dists [B, k], slots [B, k] int64, valid [B, k])``.
    """
    global EAGER_LARGE_K
    B = q.shape[0]
    P = min(num_probes, state.num_clusters)
    scan_res = refine_scan and state.residual is not None
    if scan_res:
        refine_k = 0
    kk = refine_k if (state.residual is not None and refine_k > k) else k
    if spare_rows is not None:
        spare_used = spare_rows > 0
    elif spare_used is None:
        spare_used = bool(state.counts[-1] > 0)
    mxu = metric in D.MXU_METRICS
    use_kernel = rerank in ("cuda", "cuda2") and mxu and kk <= 128
    if rerank in ("cuda", "cuda2") and mxu and not use_kernel:
        EAGER_LARGE_K += 1
    step = _query_chunk_rows(state, B, k, eager=not use_kernel, kk=kk, probes=P,
                             elementwise=not mxu)
    sel_metric = metric if mxu else "sql2"
    outs = []
    for s in range(0, B, step):
        q32 = q[s : s + step].float()
        probes = select_probes(state, q32, P, sel_metric, probe_sel)
        if not use_kernel:
            res = _block_rerank(state, q32, probes, kk, metric, scan_res, power)
        elif rerank == "cuda2" and not scan_res:
            from zebra_tpu_torch.ops.experimental_ivf import ivf_rerank_wave

            res = ivf_rerank_wave(state, q32, probes, kk, metric)
        else:
            from zebra_tpu_torch.ops.ivf_rerank import ivf_rerank

            res = ivf_rerank(state, q32, probes, kk, metric, scan_residual=scan_res)
        if spare_used:
            res = _merge_spare(state, q32, *res, kk, metric, scan_res, power, spare_rows)
        outs.append(_refine_topk(state, q32, *res, k, metric, power))
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _block_rerank(state: IVFState, q32, probes, k: int, metric: str, scan_res: bool,
                  power: float = 3.0):
    """Eager re-rank (the JAX package's XLA branch, ivf.py:700-768): per
    probe, gather the ``[B, C, D]`` block, take full-f32 dots (dequantised
    after the dot, plus the residual term in scan mode), select, merge. An
    elementwise metric scores the block's reconstructed f32 rows instead."""
    B = q32.shape[0]
    C = state.cluster_capacity
    dev = q32.device
    qn2 = (q32 * q32).sum(-1)[:, None]
    col = torch.arange(C, device=dev)
    dk = torch.full((B, k), float("inf"), device=dev)
    ik = torch.full((B, k), -1, dtype=torch.int64, device=dev)
    vk = torch.zeros((B, k), dtype=torch.bool, device=dev)
    for p in range(probes.shape[1]):
        rows = probes[:, p, None] * C + col  # [B, C]
        if metric in D.MXU_METRICS:
            dots = torch.einsum("bd,bcd->bc", q32, state.vectors[rows].float())
            if state.scales is not None:
                dots = dots * state.scales[rows]
            if scan_res:
                lo = torch.einsum("bd,bcd->bc", q32, state.residual[rows].float())
                dots = dots + state.rscales[rows] * lo
            d = D.mxu_from_parts(metric, dots, qn2, state.norms[rows])
        else:
            vf = state.vectors[rows].float()
            if state.scales is not None:
                vf = vf * state.scales[rows][..., None]
            if scan_res:
                vf = vf + state.residual[rows].float() * state.rscales[rows][..., None]
            d = D.rowwise(q32, vf, metric=metric, power=power)
        td, ti, tv = TK.masked_topk(d, state.valid[rows], rows, min(k, C))
        dk, ik, vk = TK.merge_topk(dk, ik, vk, td, ti, tv, k)
    return dk, ik, vk


def _refine_topk(state: IVFState, q32, dk, ik, vk, k: int, metric: str, power: float = 3.0):
    """Exact re-rank of an oversampled candidate set on the residual pair
    (the JAX package's ``_refine_topk``, ivf.py:771-817).

    With value = s*v8 + r*r8, ``dot(q, value) = s*dot(q, v8) + r*dot(q, r8)``.
    The coarse term is recovered by INVERTING the coarse distance with
    ``state.norms`` (every producer of ``dk`` built it from those norms), so
    the pass is one ``[B, kk, D]`` int8 residual gather and one batched f32
    dot. ``|q|^2`` here is the unrounded query's, also where the wave kernel
    formed ``dk`` from the bf16-rounded one: the reference's behaviour, kept.
    An elementwise metric has no inverse: it gathers both int8 slabs and
    scores the f32 reconstruction. No-op without a residual or when the set
    is already k wide.
    """
    if state.residual is None or dk.shape[1] <= k:
        return dk, ik, vk
    idx = torch.where(vk, ik, torch.zeros_like(ik))
    if metric in D.MXU_METRICS:
        qn2 = (q32 * q32).sum(-1)[:, None]
        n2 = state.norms[idx]  # refined |value|^2 (insert contract)
        hi = D.mxu_invert_parts(metric, dk, qn2, n2)
        lo = torch.einsum("bd,bkd->bk", q32, state.residual[idx].float())
        d = D.mxu_from_parts(metric, hi + lo * state.rscales[idx], qn2, n2)
    else:
        vf = (state.vectors[idx].float() * state.scales[idx][..., None]
              + state.residual[idx].float() * state.rscales[idx][..., None])
        d = D.rowwise(q32, vf, metric=metric, power=power)
    inf = torch.full_like(d, float("inf"))
    return TK.masked_topk(torch.where(vk, d, inf), vk, ik, k)


def _merge_spare(state: IVFState, q32, dk, ik, vk, k: int, metric: str,
                 scan_res: bool = False, power: float = 3.0, rows: int | None = None):
    """Fold the shared spare region into partial top-k results (a windowed
    exact scan of ``[spare_start, spare_start + G)``, or of its first
    ``rows``, the filled prefix, where the caller knows it). The residual is scored
    only in scan mode; under refine=N the spare rows get the coarse distance
    like every probed row (against ``state.norms`` either way) and
    :func:`_refine_topk` fixes them up with the rest."""
    from zebra_tpu_torch.ops.scan import exact_scan

    G = state.spare_capacity if rows is None else min(rows, state.spare_capacity)
    if G == 0:
        return dk, ik, vk
    td, ti, tv = exact_scan(
        state.vectors, state.valid, q32, min(k, G), metric=metric, power=power, chunk=65536,
        scales=state.scales,
        norms=state.norms if state.residual is not None else None,
        residual=state.residual if scan_res else None,
        rscales=state.rscales if scan_res else None,
        w_start=state.spare_start, w_len=G,
    )
    return TK.merge_topk(dk, ik, vk, td, ti, tv, k)


def brute_force(state: IVFState, q: torch.Tensor, k: int, metric: str = "cosine",
                power: float = 3.0, chunk: int = 8192, precision: str = "highest"):
    """Exact top-k over the whole slab, scoring the stored reconstruction
    (both slabs for refined int8): the recall oracle."""
    from zebra_tpu_torch.ops.scan import exact_scan

    return exact_scan(
        state.vectors, state.valid, q, k, metric=metric, power=power, chunk=chunk,
        precision=precision,
        scales=state.scales,
        norms=state.norms if state.residual is not None else None,
        residual=state.residual, rscales=state.rscales,
    )


def num_valid(state: IVFState) -> torch.Tensor:
    """Live slots of the state: a 0-d int32 tensor on its device (no host
    read), as the JAX package returns a 0-d array."""
    return state.valid.sum(dtype=torch.int32)
