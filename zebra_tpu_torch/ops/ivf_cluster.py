"""The cluster-major form of the IVF probe re-ranks (kernels 1, 2 and 3).

``ivf_rerank.ivf_rerank`` (the port of ``pallas_ivf._kernel_factory``),
``experimental_ivf.ivf_rerank_wave`` (of ``_kernel_factory_v2``) and
``experimental_ivf.rerank_aug_raw`` (of ``_kernel_factory_v3``, on an
augmented slab) each have a per-query CUDA kernel that reads every probed
block once per query that probes it. This module is their second form on the
card, shared by all three:

* the batch's ``B*P`` (query, probe) pairs are sorted by the cluster they
  probe (a stable library sort) and cut into work items of at most ``nq``
  pairs of one cluster, so a hot cluster spreads over several items
  (:func:`work_items` in plain torch; the items kernel on the card);
* ``csrc/ivf_rerank_cluster.cu`` scores each item's block once for all its
  queries on the tensor cores into a ``[B, P*C]`` distance buffer (each pair's
  own place, +inf where a row is not live; on an augmented slab the raw dot
  of every row, clamped to ``BIG``), then selects per query (:func:`aug_rerank`
  returns positions on the flat probe axis, as kernel 3 does);
* :func:`takes_cluster_form` is the route between the two forms, from host
  integers alone (``tools/ivf_crossover.py`` measures where the forms cross);
* :func:`cluster_scores_emulation` is the decomposition in plain torch (the
  items, a product per item, the scatter), and :func:`select_reference` the
  plain selection, so that everything but the CUDA is reached by the CPU
  tests. The plain version of the whole is the per-query one of each
  wrapper (``ivf_rerank_reference``, ``ivf_rerank_wave_reference``,
  ``rerank_aug_raw_reference``).

The wrappers count its launches by form (``LAUNCHES_BY_FORM``,
``LAUNCHES_WAVE_BY_FORM``, ``LAUNCHES_AUG_BY_FORM``).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from zebra_tpu_torch.ops import topk as TK
from zebra_tpu_torch.ops.ivf_rerank import (_METRIC_CODE, BIG, _ptr, distance_from_parts,
                                            probe_distances, probe_rows, ref_chunk)

#: columns the scoring kernel reads per step; D is padded up to it
CHUNK = 64
#: queries per work item: one tile of 8 of the tensor-core product (the
#: path's blocks are probed by ~2-4 queries of a batch of 16384)
ITEM_QUERIES = 8
#: int8 digits of the query on an int8 slab (``query_digits``), and those
#: the residual's product takes
DIGITS = 4
RES_DIGITS = 3
#: TF32 parts of the query on an f32 slab (hi, lo: 3xTF32)
F32_PARTS = 2
#: widest probe axis P*C the selection kernel holds (a warp per query)
MAX_ENTRIES = 2048
#: the route: the cluster-major form from this many (query, probe) pairs
#: times padded columns on, by slab type (kernels 1 and 2), and by ("aug",
#: slab type) for the augmented slab (:meth:`AugSlab.takes_cluster_form`).
#: tools/ivf_crossover.py on one H100 (PERF.md): on int8 slabs it lost a
#: case at 4096 pairs of 768 columns and won every case from 8192; on bf16
#: slabs it lost at 16384 and won from 32768 (batch 16384 at P=2, 8192 at
#: P=4); on f32 slabs it lost at 16384 and won from 32768 (kernel 1; kernel
#: 2, which shares the key, lost at 8192 and won from 16384); on aug slabs
#: (896 columns) it lost at 8192 pairs (bf16) and 4096 (f32) and won every
#: case from 16384 and 8192. Below, its fixed costs (the pairs' sort, the
#: launches, the staging) outweigh the re-reads it saves
MIN_PAIR_COLUMNS = {torch.int8: 8192 * 768, torch.bfloat16: 32768 * 768,
                    torch.float32: 32768 * 768, ("aug", torch.bfloat16): 16384 * 896,
                    ("aug", torch.float32): 8192 * 896}
#: dynamic shared memory a block may use on sm_90 (227 KB), less the
#: scoring kernel's static arrays
_MAX_DYN_SMEM = 232448 - 32 * 12
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_AUG_DTYPES = (torch.float32, torch.bfloat16)


def padded_dim(D: int) -> int:
    """D rounded up to the scoring kernel's chunk."""
    return -(-D // CHUNK) * CHUNK


def query_parts_count(dtype, round_q: bool) -> int:
    """Staged rows of one query: :data:`DIGITS` int8 digits on an int8 slab,
    :data:`F32_PARTS` TF32 parts on an f32 slab, one bf16 part (``round_q``)
    or three on a bf16 slab."""
    if dtype == torch.int8:
        return DIGITS
    if dtype == torch.float32:
        return F32_PARTS
    return 1 if round_q else 3


def query_bytes(D: int, dtype, parts: int) -> int:
    """Bytes of one staged query, as the kernel lays it out: :data:`DIGITS`
    int8 digit rows on an int8 slab, ``parts`` bf16 rows on a bf16 slab or
    f32 rows on an f32 slab, each padded as ``query_row_bytes`` pads it."""
    if dtype == torch.int8:
        return DIGITS * (padded_dim(D) + 16)
    if dtype == torch.float32:
        return parts * (4 * padded_dim(D) + 32)
    return parts * (2 * padded_dim(D) + 64)


#: bytes of a scoring block's four per-warp rings: ``kDepth`` = 3 steps of
#: 256 bytes of each of a tile's 16 rows (``kSub`` chunks of ``kPieces``
#: 16-byte pieces a lane, 8 pieces in all, whatever the slab type)
_RING_BYTES = 4 * 3 * 8 * 32 * 16


def fits_smem(D: int, dtype, parts: int) -> bool:
    """Whether a scoring block's dynamic shared memory, as the kernel lays
    it out (the rings, then :data:`ITEM_QUERIES` staged queries of
    :func:`query_bytes`), fits."""
    return _RING_BYTES + ITEM_QUERIES * query_bytes(D, dtype, parts) <= _MAX_DYN_SMEM


def fits_cluster_form(P: int, D: int, C: int, dtype, k: int, round_q: bool = False) -> bool:
    """Whether the cluster-major form takes these shapes at all: int8, bf16
    or f32 slabs, D and C multiples of 16, ``0 < k <= 128``, a probe axis the
    selection warp holds (``P*C <= 2048``) and the staged query parts in
    shared memory."""
    return (dtype in _DTYPE_CODE and D > 0 and D % 16 == 0 and C > 0 and C % 16 == 0
            and 0 < k <= 128 and P * C <= MAX_ENTRIES
            and fits_smem(D, dtype, query_parts_count(dtype, round_q)))


def _route(B: int, P: int, D: int, C: int, dtype, k: int, round_q: bool, key) -> bool:
    return (fits_cluster_form(P, D, C, dtype, k, round_q)
            and B * P * padded_dim(D) >= MIN_PAIR_COLUMNS[key])


def takes_cluster_form(B: int, P: int, D: int, C: int, dtype, k: int,
                       round_q: bool = False) -> bool:
    """The route between the two forms on the card, from host integers:
    shapes the cluster-major form fits (:func:`fits_cluster_form`) with at
    least :data:`MIN_PAIR_COLUMNS` pairs times padded columns for the slab
    type take it; everything else (small batches, shapes it does not fit)
    takes the per-query form. An augmented slab has its own route
    (:meth:`AugSlab.takes_cluster_form`)."""
    return _route(B, P, D, C, dtype, k, round_q, dtype)


def sort_pairs(probes: torch.Tensor, num_clusters: int):
    """The batch's ``B*P`` probes sorted stably by cluster: ``(sorted
    clusters, pair ids b*P + p)``; 16-bit keys (half the radix passes) where
    the cluster ids fit."""
    key = torch.int16 if num_clusters <= 32767 else torch.int32
    return torch.sort(probes.reshape(-1).to(key), stable=True)


def item_grid(n: int, nq: int, num_clusters: int) -> int:
    """The most work items ``n`` pairs over ``num_clusters`` clusters can
    make: a run of m pairs makes ceil(m / nq) <= m // nq + 1."""
    return min(n, n // nq + min(n, num_clusters))


def work_items(probes: torch.Tensor, num_clusters: int, nq: int = ITEM_QUERIES):
    """The batch's pairs grouped by cluster, in plain torch on the probes'
    device (the items kernel's plain version).

    Returns ``(order, sorted_c, item_start)``: ``order [B*P]`` the flattened
    pair ids ``b*P + p`` sorted stably by cluster (int64), ``sorted_c`` their
    clusters (int32), and ``item_start`` (int32, ascending) the sorted
    position of each work item's first pair: an item is the next ``nq`` (or
    fewer) pairs of one cluster.
    """
    n = probes.numel()
    dev = probes.device
    cs, order = sort_pairs(probes, num_clusters)
    cs = cs.to(torch.int32)
    if not n:
        return order, cs, torch.zeros(0, dtype=torch.int32, device=dev)
    ar = torch.arange(n, device=dev)
    # a pair opens an item at every nq-th place of its cluster's run
    first = (ar - torch.searchsorted(cs, cs)) % nq == 0
    return order, cs, ar[first].to(torch.int32)


def items_on_host(order, sorted_c, item_start, P: int, nq: int = ITEM_QUERIES):
    """The work items as host lists ``[(cluster, [(b, p), ...]), ...]``, read
    as the scoring kernel reads them (for tests and the emulation)."""
    order, cs = order.tolist(), sorted_c.tolist()
    out = []
    for s in item_start.tolist():
        j = s
        while j < len(cs) and j - s < nq and cs[j] == cs[s]:
            j += 1
        out.append((cs[s], [divmod(order[i], P) for i in range(s, j)]))
    return out


def query_parts(q32: torch.Tensor, round_q: bool) -> list[torch.Tensor]:
    """The query as the scoring kernel multiplies it, as f32 tensors of
    bf16 values: one part rounded to bf16 (``round_q``), or three whose sum
    is the f32 query exactly (hi, mid, lo, each rounded to nearest)."""
    hi = q32.to(torch.bfloat16).float()
    if round_q:
        return [hi]
    mid = (q32 - hi).to(torch.bfloat16).float()
    return [hi, mid, (q32 - hi - mid).to(torch.bfloat16).float()]


def query_digits(q32: torch.Tensor, round_q: bool):
    """The query as the scoring kernel multiplies an int8 slab: ``(digits,
    unit)`` with ``q ~= unit * (d0 + d1/2^7 + d2/2^14 + d3/2^21)``, each digit
    an integer tensor of values in [-64, 64] (as f32) and ``unit [B, 1]`` =
    ``2^(e-6)``, e the binary exponent of the row's max |q| (1 for a zero
    row). The error is under ``unit * 2^-22``: exact to f32's 24 bits at the
    row's largest entries. ``round_q`` takes the bf16-rounded query."""
    x = q32.float().to(torch.bfloat16).float() if round_q else q32.float()
    amax = x.abs().amax(-1, keepdim=True)
    unit = torch.where(amax > 0, torch.exp2(torch.frexp(amax).exponent.float() - 6.0),
                       torch.ones_like(amax))
    r = x / unit
    digits = []
    for _ in range(DIGITS):
        d = torch.round(r)
        digits.append(d)
        r = (r - d) * 128.0
    return digits, unit


def _digit_dot(digits, x: torch.Tensor) -> torch.Tensor:
    """``sum_k (d_k @ x.T) / 128^k``, smallest first, as the kernel combines
    its exact int32 sums (each product sum is an integer below 2^24, exact in
    f32)."""
    v = torch.zeros((), device=x.device)
    for d in reversed(digits):
        v = v / 128.0 + d @ x.T
    return v


@dataclasses.dataclass
class AugSlab:
    """An augmented slab ``[S, D + AUG]`` (``experimental_ivf.augment_slab``,
    bf16 or f32) as the cluster-major form reads it: blocks of
    ``cluster_capacity`` rows, every row read (its liveness and norm are in
    its lanes)."""
    vectors: torch.Tensor
    cluster_capacity: int

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def num_clusters(self) -> int:
        return -(-self.vectors.shape[0] // self.cluster_capacity)

    def takes_cluster_form(self, B: int, P: int, k: int, round_q: bool) -> bool:
        """The route of kernel 3: as :func:`takes_cluster_form`, from the
        ``("aug", slab type)`` entry of :data:`MIN_PAIR_COLUMNS`."""
        dtype = self.vectors.dtype
        return (dtype in _AUG_DTYPES and _route(B, P, self.dim, self.cluster_capacity, dtype,
                                                 k, round_q, ("aug", dtype)))


def cluster_scores_emulation(state, q32: torch.Tensor, probes: torch.Tensor,
                             metric: str = "cosine", round_q: bool = False,
                             scan_residual: bool = True, nq: int = ITEM_QUERIES):
    """The scoring kernel's output ``[B, P*C]`` in plain torch: the work
    items of :func:`work_items`, each block's ``[C, D]`` rows multiplied with
    its queries (``[nq, D] x [D, C]`` per bf16 part of :func:`query_parts`
    on a bf16 slab; per int8 digit of :func:`query_digits` on an int8 slab,
    the residual with the first :data:`RES_DIGITS`; the f32 query as it is on
    an f32 slab, as the per-query plain version multiplies it), dequantised
    after the dot, the distance from the stored norm, +inf where a row is not
    live, scattered to each pair's place. On an :class:`AugSlab` (``q32`` the
    transformed query w, ``round_q`` its bf16 rounding) the aug epilogue:
    the raw dot of every row, ``min(d, BIG)`` (a NaN comes out BIG, as
    ``fminf`` gives it)."""
    C = state.cluster_capacity
    B, P = probes.shape
    dist = torch.full((B, P * C), float("nan"), device=q32.device)
    aug = isinstance(state, AugSlab)
    int8 = state.vectors.dtype == torch.int8
    qr = q32.float().to(torch.bfloat16).float() if round_q else q32.float()
    qn2 = (qr * qr).sum(-1)
    if int8:
        digits, unit = query_digits(q32, round_q)
    elif state.vectors.dtype == torch.float32:
        parts = [qr]
    else:
        parts = query_parts(q32.float(), round_q)
    res = None if aug or not scan_residual else state.residual
    counts = None if aug else state.counts.tolist()
    col = torch.arange(C, device=q32.device)
    for c, pairs in items_on_host(*work_items(probes, state.num_clusters, nq), P, nq):
        rows = c * C + col
        bs = torch.tensor([b for b, _ in pairs], device=q32.device)
        x = state.vectors[rows].float()
        if not int8:
            dot = sum(p[bs] @ x.T for p in parts)
        else:  # dequantised after the dot
            dot = _digit_dot([d[bs] for d in digits], x) * unit[bs] * state.scales[rows]
            if res is not None:
                r = _digit_dot([d[bs] for d in digits[:RES_DIGITS]], res[rows].float())
                dot = dot + r * unit[bs] * state.rscales[rows]
        if aug:
            d = torch.where(dot < BIG, dot, torch.full_like(dot, BIG))
        else:
            d = distance_from_parts(metric, dot, qn2[bs, None], state.norms[rows])
            live = state.valid[rows] & (col < min(max(counts[c], 0), C))
            d = torch.where(live, d, torch.full_like(d, float("inf")))
        for i, (b, p) in enumerate(pairs):
            dist[b, p * C : (p + 1) * C] = d[i]
    return dist


def score_reference(state, q32: torch.Tensor, probes: torch.Tensor, metric: str = "cosine",
                    round_q: bool = False, scan_residual: bool = True) -> torch.Tensor:
    """The scoring kernel's plain version: ``[B, P*C]`` distances of every
    pair's rows (``ivf_rerank.probe_distances`` with the f32 query, or the
    bf16-rounded one with ``round_q``), +inf where a row is not live. On an
    :class:`AugSlab`: the raw dots of ``rerank_aug_raw_reference``, clamped
    to BIG."""
    B, P = probes.shape
    C = state.cluster_capacity
    qq = q32.float().to(torch.bfloat16).float() if round_q else q32.float()
    step = ref_chunk(P, C, state.dim)
    if isinstance(state, AugSlab):
        out = [torch.einsum("bd,bcd->bc", qq[s : s + step],
                            state.vectors[probe_rows(probes[s : s + step].long(), C)].float())
               for s in range(0, B, step)]
        d = torch.cat(out) if out else torch.zeros((0, P * C), device=q32.device)
        return torch.where(d < BIG, d, torch.full_like(d, BIG))
    out = [probe_distances(state, qq[s : s + step], probes[s : s + step], metric,
                           scan_residual=scan_residual) for s in range(0, B, step)]
    d = torch.cat(out) if out else torch.zeros((0, P * C), device=q32.device)
    return torch.where(d < BIG, d, torch.full_like(d, float("inf")))


def select_reference(dist: torch.Tensor, probes: torch.Tensor, C: int, k: int,
                     positions: bool = False):
    """The selection kernel in plain torch: each query's ``k`` smallest of
    ``dist [B, P*C]`` (entries >= BIG missing; ties to the lowest position)
    as ``(dists, slots) [B, k]``, (+inf, -1) past its live entries;
    ``positions``: positions on the flat ``[P*C]`` axis instead of slots (the
    aug form)."""
    kk = min(k, dist.shape[1])
    vals, pos = TK.smallest_k(dist, kk)
    ok = vals < BIG
    slot = pos if positions else torch.gather(probes.long(), 1, pos // C) * C + pos % C
    d = torch.where(ok, vals, torch.full_like(vals, float("inf")))
    s = torch.where(ok, slot, torch.full_like(slot, -1))
    if kk < k:
        B = dist.shape[0]
        d = torch.cat([d, torch.full((B, k - kk), float("inf"), device=d.device)], 1)
        s = torch.cat([s, torch.full((B, k - kk), -1, dtype=s.dtype, device=s.device)], 1)
    return d, s


def items(probes: torch.Tensor, num_clusters: int, nq: int = ITEM_QUERIES):
    """The items kernel alone (the card's :func:`work_items`): ``(order,
    sorted_c, item_start)`` with the item starts ascending, for holding it
    against its plain version; the scoring launch runs it inside."""
    from zebra_tpu_torch.ops import _kernels

    n = probes.numel()
    cs, order = sort_pairs(probes, num_clusters)
    grid = item_grid(n, nq, num_clusters)
    scratch = torch.empty(n + grid + 1, dtype=torch.int32, device=probes.device)
    fn = _kernels.load("ivf_rerank_cluster").zt_ivf_cluster_items
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int] + [
        ctypes.c_void_p] * 4
    err = fn(_ptr(cs), cs.element_size(), n, nq, _ptr(scratch), _ptr(scratch[n:]),
             _ptr(scratch[n + grid :]),
             ctypes.c_void_p(torch.cuda.current_stream(probes.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"ivf_rerank_cluster items kernel launch failed: cudaError {err}")
    count = int(scratch[n + grid])
    return order, scratch[:n], torch.sort(scratch[n : n + count]).values


def _launch_score(vec: torch.Tensor, q: torch.Tensor, probes: torch.Tensor, C: int,
                  num_clusters: int, round_q: bool, aug: bool, metric_code: int = 0,
                  res=None, side=(None,) * 5) -> torch.Tensor:
    """The items, staging and scoring kernels on slab ``vec`` (``side``: the
    counts, scales, residual scales, norms and valid of kernels 1 and 2)."""
    from zebra_tpu_torch.ops import _kernels

    B, P = probes.shape
    D = vec.shape[1]
    parts = query_parts_count(vec.dtype, round_q)
    if not fits_smem(D, vec.dtype, parts):
        raise ValueError(f"a {D}-wide query does not fit the cluster-major form's shared memory")
    if vec.data_ptr() % 16 or (res is not None and res.data_ptr() % 16):
        raise ValueError("the cluster-major form reads 16-byte aligned slabs")
    n = B * P
    cs, order = sort_pairs(probes, num_clusters)
    grid = item_grid(n, ITEM_QUERIES, num_clusters)
    dev = q.device
    dist = torch.empty((B, P * C), dtype=torch.float32, device=dev)
    # scratch: the queries staged once each (digits or parts); |q|^2 and the
    # digits' unit per query; sorted clusters, item starts and their count
    staged = torch.empty(B * query_bytes(D, vec.dtype, parts), dtype=torch.uint8, device=dev)
    qn2 = torch.empty(2 * B, dtype=torch.float32, device=dev)
    scratch = torch.empty(n + grid + 1, dtype=torch.int32, device=dev)
    fn = _kernels.load("ivf_rerank_cluster").zt_ivf_cluster_score
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] + [ctypes.c_int]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    counts, scales, rscales, norms, valid = side
    err = fn(
        _ptr(q), _ptr(staged), _ptr(qn2), _ptr(qn2[B:]), B, _ptr(cs), cs.element_size(),
        _ptr(order), _ptr(scratch), _ptr(scratch[n:]), _ptr(scratch[n + grid :]), grid, n,
        _ptr(counts), _ptr(vec), _DTYPE_CODE[vec.dtype], _ptr(res), _ptr(scales),
        _ptr(rscales), _ptr(norms), _ptr(valid), _ptr(dist), P, C, D, metric_code,
        int(round_q), int(aug), ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"ivf_rerank_cluster scoring kernel launch failed: cudaError {err}")
    return dist


def score(state, q: torch.Tensor, probes: torch.Tensor, metric: str, round_q: bool,
          scan_residual: bool):
    """Launch the scoring kernel of kernels 1 and 2 (with the items and
    staging kernels before it): the ``[B, P*C]`` distance buffer. ``q`` is
    contiguous f32 ``[B, D]``, ``probes`` ``[B, P]`` on the card; the caller
    has checked the state."""
    res = state.residual if scan_residual else None
    side = (state.counts, state.scales, state.rscales if res is not None else None,
            state.norms, state.valid)
    return _launch_score(state.vectors, q, probes, state.cluster_capacity, state.num_clusters,
                         round_q, False, _METRIC_CODE[metric], res, side)


def score_aug(slab: AugSlab, w: torch.Tensor, probes: torch.Tensor, round_q: bool):
    """Launch the scoring kernel with the aug epilogue on an :class:`AugSlab`:
    the ``[B, P*C]`` raw dots of the contiguous f32 transformed query ``w``
    (``round_q``: rounded to bf16) with every probed row, clamped to BIG."""
    if slab.vectors.dtype not in _AUG_DTYPES:
        raise ValueError(f"augmented slabs are f32 or bf16, got {slab.vectors.dtype}")
    return _launch_score(slab.vectors, w, probes, slab.cluster_capacity, slab.num_clusters,
                         round_q, True)


def select(dist: torch.Tensor, probes: torch.Tensor, C: int, k: int, positions: bool = False):
    """Launch the selection kernel on a distance buffer: ``(dists, slots)
    [B, k]`` (``positions``: positions on the flat ``[P*C]`` axis)."""
    from zebra_tpu_torch.ops import _kernels

    B, n = dist.shape
    P = probes.shape[1]
    if n != P * C or n > MAX_ENTRIES or not 0 < k <= 128:
        raise ValueError(f"the selection kernel takes P*C <= {MAX_ENTRIES} and 0 < k <= 128")
    out_d = torch.empty((B, k), dtype=torch.float32, device=dist.device)
    out_s = torch.empty((B, k), dtype=torch.int64, device=dist.device)
    fn = _kernels.load("ivf_rerank_cluster").zt_ivf_cluster_select
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    err = fn(_ptr(dist), _ptr(None if positions else probes), B, P, C, k, _ptr(out_d),
             _ptr(out_s), ctypes.c_void_p(torch.cuda.current_stream(dist.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"ivf_rerank_cluster selection kernel launch failed: cudaError {err}")
    return out_d, out_s


def cluster_rerank(state, q: torch.Tensor, probes: torch.Tensor, k: int, metric: str,
                   round_q: bool, scan_residual: bool):
    """The cluster-major form: the pairs' sort, the items, staging and
    scoring kernels, then the selection kernel. Returns ``(dists [B, k],
    slots [B, k], valid [B, k])``."""
    pr = probes.to(torch.int32).contiguous()
    dist = score(state, q, pr, metric, round_q, scan_residual)
    out_d, out_s = select(dist, pr, state.cluster_capacity, k)
    return out_d, out_s, out_s >= 0


def aug_rerank(slab: AugSlab, w: torch.Tensor, probes: torch.Tensor, k: int, round_q: bool):
    """The cluster-major form of kernel 3 on an augmented slab: ``(d_raw
    [B, k], pos [B, k])`` as ``rerank_aug_raw`` returns them. ``w`` is the
    contiguous f32 transformed query; ``round_q`` rounds it to bf16 (the
    one-pass form on a bf16 slab)."""
    pr = probes.to(torch.int32).contiguous()
    dist = score_aug(slab, w, pr, round_q)
    return select(dist, pr, slab.cluster_capacity, k, positions=True)
