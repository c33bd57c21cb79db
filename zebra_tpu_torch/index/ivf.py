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
    state's leaves, or the members of an index snapshot."""

    def t(name):
        if name not in arrays:
            return None
        return torch.from_numpy(np.array(arrays[name])).to(device)

    return IVFState(
        centroids=t("centroids").float(), counts=t("counts").int(),
        vectors=t("vectors"), norms=t("norms"), valid=t("valid").bool(),
        overflow=t("overflow").int(), scales=t("scales"), residual=t("residual"),
        rscales=t("rscales"), ccap=int(np.asarray(arrays["ccap"])),
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
    exact on the JAX package's CPU backend too)."""
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
        out.append(torch.topk(score, A, dim=1).indices)
    return torch.cat(out)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value with the same low 32 bits (two's complement)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2**31, x - 2**32, x)


def _jitter(n: int, A: int, device) -> torch.Tensor:
    """Per-row fallback rotation ``r0`` of the JAX placement (ivf.py:234-236):
    int32 wrap-around products, a LOGICAL right shift and ``lax.rem``
    (truncated, sign of the dividend: ``torch.fmod``), computed in int64."""
    h = _wrap32(torch.arange(n, dtype=torch.int64, device=device) * -1640531527)
    h = _wrap32((h ^ ((h & 0xFFFFFFFF) >> 16)) * -2048144789)
    return torch.fmod(_wrap32(torch.abs(h)), max(min(2, A - 1), 1))


def _place_rows(state: IVFState, x32: torch.Tensor, spill: int, metric: str):
    """Slab slot per row: nearest cell with room, ``spill`` jittered
    fallbacks, then the shared spare region.

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
    r0 = _jitter(n, A, dev)
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
        counts.index_add_(0, c[ok], torch.ones_like(c[ok], dtype=torch.int32))
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
    """Host int8 + residual quantisation, ``(v8, r8, scale, rscale)``.

    Bitwise the JAX package's ``_quantise_pair_numpy`` (the f64 emulation of
    the device path's FMA residual), run per ``span`` rows."""
    x32 = np.ascontiguousarray(x, dtype=np.float32)
    n, d = x32.shape
    v8 = np.empty((n, d), np.int8)
    r8 = np.empty((n, d), np.int8)
    scale = np.empty((n,), np.float32)
    rscale = np.empty((n,), np.float32)
    one = np.float32(1.0)
    for s in range(0, n, span):
        xs = x32[s : s + span]
        absmax = np.max(np.abs(xs), axis=-1)
        sc = np.where(absmax > 0, absmax * _INV127, one).astype(np.float32)
        v = np.clip(np.rint(xs / sc[:, None]), -127, 127).astype(np.int8)
        # x - v*scale with ONE f32 rounding (the device FMA): the f64 product
        # and difference are exact, so the single cast is the fused rounding
        res = (xs.astype(np.float64)
               - v.astype(np.float64) * sc.astype(np.float64)[:, None]).astype(np.float32)
        rabs = np.max(np.abs(res), axis=-1)
        rs = np.where(rabs > 0, rabs * _INV127, one).astype(np.float32)
        v8[s : s + span] = v
        r8[s : s + span] = np.clip(np.rint(res / rs[:, None]), -127, 127).astype(np.int8)
        scale[s : s + span] = sc
        rscale[s : s + span] = rs
    return v8, r8, scale, rscale


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
    ok = slots >= 0
    w = slots[ok]
    state.counts = counts
    state.vectors.index_copy_(0, w, v8[ok])
    state.residual.index_copy_(0, w, r8[ok])
    state.norms.index_copy_(0, w, (x32 * x32).sum(-1)[ok])
    state.scales.index_copy_(0, w, scale[ok].contiguous())
    state.rscales.index_copy_(0, w, rscale[ok].contiguous())
    state.valid[w] = True
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


def select_probes(state: IVFState, q32: torch.Tensor, P: int, sel_metric: str,
                  probe_sel: str = "auto") -> torch.Tensor:
    """The ``P`` nearest clusters per query, ``[B, P]`` int64.

    "auto"/"fast" with K >= 128 and 2P < K: stage 1 ranks bf16-ROUNDED scores
    built from bf16-rounded q and centroids with f32 accumulation (emulated:
    round the operands, f32 matmul, round the scores) and keeps 2P; stage 2
    rescores those in f32 and keeps P. Otherwise one f32 scoring pass.
    Stage 1 uses ``torch.topk``: its tie order among equal bf16 scores is
    unspecified, as ``approx_max_k``'s is.
    """
    K = state.num_clusters
    cents = state.centroids
    if probe_sel in ("auto", "fast") and K >= 128 and 2 * P < K:
        dot = q32.to(torch.bfloat16).float() @ cents.to(torch.bfloat16).float().T
        cn2 = (cents * cents).sum(-1)
        if sel_metric == "cosine":
            s = dot * torch.rsqrt(torch.clamp(cn2, min=1e-30))[None, :]
        else:  # l2 / sql2: same argmax ordering
            s = 2.0 * dot - cn2[None, :]
        cand = torch.topk(s.to(torch.bfloat16).float(), 2 * P, dim=1).indices
        dots = torch.einsum("bd,bpd->bp", q32, cents[cand])
        cn2c = cn2[cand]
        if sel_metric == "cosine":
            fs = dots * torch.rsqrt(torch.clamp(cn2c, min=1e-30))
        else:
            fs = 2.0 * dots - cn2c
        _, ix = TK.smallest_k(-fs, P)
        return torch.gather(cand, 1, ix)
    _, probes = TK.smallest_k(D.pairwise(q32, cents, metric=sel_metric), P)
    return probes


def _query_chunk_rows(state: IVFState, B: int, k: int, eager: bool) -> int:
    """Queries per pass, bounding the per-pass transients: the [B, K] score
    pair (8 B/row/cluster) and, on the eager path, one probe's [B, C, D]
    gather in f32 plus its residual. The JAX package hard-codes a budget for
    a 16 GB TPU; here it is a quarter of the device's free memory
    (``torch.cuda.mem_get_info``), or 1 GiB on the CPU."""
    per_row = state.num_clusters * 8 + 64 * k
    if eager:
        per_row += state.cluster_capacity * state.dim * 12
    dev = state.device
    budget = torch.cuda.mem_get_info(dev)[0] // 4 if dev.type == "cuda" else 1 << 30
    return max(1, min(B, budget // per_row))


def query(state: IVFState, q: torch.Tensor, k: int, metric: str = "cosine",
          num_probes: int = 8, rerank: str = "eager", probe_sel: str = "auto",
          refine_scan: bool = False, spare_used: bool | None = None):
    """Approximate top-k: score centroids -> top-P blocks -> exact re-rank ->
    spare merge.

    ``rerank="cuda"`` takes the probe kernel (:func:`ivf_rerank.ivf_rerank`)
    for k <= 128; a wider k takes the eager block path and is counted in
    :data:`EAGER_LARGE_K`. ``refine_scan`` scores the residual reconstruction
    (the only residual mode the port has). ``spare_used`` is the caller's
    host mirror of a non-empty spare (None: read ``counts[-1]``, a sync).

    Returns ``(dists [B, k], slots [B, k] int64, valid [B, k])``.
    """
    global EAGER_LARGE_K
    D.check_metric(metric)
    if state.residual is not None and not refine_scan:
        raise NotImplementedError(
            "refine=N (the oversampled _refine_topk pass) is not ported yet; "
            "use refine='scan' (ROADMAP.md queue 1)"
        )
    B = q.shape[0]
    P = min(num_probes, state.num_clusters)
    if spare_used is None:
        spare_used = bool(state.counts[-1] > 0)
    use_kernel = rerank == "cuda" and k <= 128
    if rerank == "cuda" and not use_kernel:
        EAGER_LARGE_K += 1
    step = _query_chunk_rows(state, B, k, eager=not use_kernel)
    outs = []
    for s in range(0, B, step):
        q32 = q[s : s + step].float()
        probes = select_probes(state, q32, P, metric, probe_sel)
        if use_kernel:
            from zebra_tpu_torch.ops.ivf_rerank import ivf_rerank

            res = ivf_rerank(state, q32, probes, k, metric)
        else:
            res = _block_rerank(state, q32, probes, k, metric)
        if spare_used:
            res = _merge_spare(state, q32, *res, k, metric)
        outs.append(res)
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _block_rerank(state: IVFState, q32, probes, k: int, metric: str):
    """Eager re-rank (the JAX package's XLA branch, ivf.py:700-768): per
    probe, gather the ``[B, C, D]`` block, take full-f32 dots (dequantised
    after the dot, plus the residual term), select, merge."""
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
        dots = torch.einsum("bd,bcd->bc", q32, state.vectors[rows].float())
        if state.scales is not None:
            dots = dots * state.scales[rows]
        if state.residual is not None:
            lo = torch.einsum("bd,bcd->bc", q32, state.residual[rows].float())
            dots = dots + state.rscales[rows] * lo
        d = D.mxu_from_parts(metric, dots, qn2, state.norms[rows])
        td, ti, tv = TK.masked_topk(d, state.valid[rows], rows, min(k, C))
        dk, ik, vk = TK.merge_topk(dk, ik, vk, td, ti, tv, k)
    return dk, ik, vk


def _merge_spare(state: IVFState, q32, dk, ik, vk, k: int, metric: str):
    """Fold the shared spare region into partial top-k results (a windowed
    exact scan of ``[spare_start, spare_start + G)``)."""
    from zebra_tpu_torch.ops.scan import exact_scan

    G = state.spare_capacity
    if G == 0:
        return dk, ik, vk
    td, ti, tv = exact_scan(
        state.vectors, state.valid, q32, min(k, G), metric=metric, chunk=65536,
        scales=state.scales,
        norms=state.norms if state.residual is not None else None,
        residual=state.residual, rscales=state.rscales,
        w_start=state.spare_start, w_len=G,
    )
    return TK.merge_topk(dk, ik, vk, td, ti, tv, k)


def brute_force(state: IVFState, q: torch.Tensor, k: int, metric: str = "cosine",
                chunk: int = 8192):
    """Exact top-k over the whole slab, scoring the stored reconstruction
    (both slabs for refined int8): the recall oracle."""
    from zebra_tpu_torch.ops.scan import exact_scan

    return exact_scan(
        state.vectors, state.valid, q, k, metric=metric, chunk=chunk,
        scales=state.scales,
        norms=state.norms if state.residual is not None else None,
        residual=state.residual, rscales=state.rscales,
    )
