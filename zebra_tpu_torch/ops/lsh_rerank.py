"""LSH candidate re-rank: the port of ``zebra_tpu/ops/pallas_rerank.py``.

What lives here:

* :func:`lsh_rerank` — the wrapper ``buckets.query`` calls, with the contract
  of ``pallas_rerank.pallas_rerank``: per query, gather its M candidate rows
  by slab slot, take full-f32 dots, build cosine / l2 / sql2 from the stored
  squared norms, mask invalid candidates and return the top-k as
  ``(dists [B, k], pos [B, k])`` — positions into the candidate axis, with
  +inf / -1 where fewer than k candidates are valid.
* :func:`lsh_rerank_reference` — the plain torch version (the CPU path, and
  what ``chip_smoke.py`` holds both kernel forms against on the card).
* two CUDA forms of the kernel, chosen by :func:`takes_slab_form` from host
  integers: the gather form ``csrc/lsh_rerank.cu`` (a block per query, a
  warp per candidate row) for sparse or unsorted candidates, and the
  slab-major form ``csrc/lsh_rerank_slab.cu`` (query groups x slab chunks on
  the tensor cores, ``wgmma`` in 3xTF32 — two passes for a bf16 slab, whose
  rows are exact in TF32 — then a merge kernel) for sorted
  rows that hold a large share of the occupied slab. :data:`LAUNCHES` counts
  both, :data:`LAUNCHES_SLAB` the slab form alone.
* :func:`lsh_rerank_slab_emulation` and :func:`split_tf32` — the slab form's
  decomposition in plain torch, so that everything but the CUDA itself is
  reached by the CPU tests.

The slab may be wider than the query (a stored width padded for the TPU's
DMA tiling): both versions read only the query's ``D`` leading columns of
each row. CPU tensors take the plain version; CUDA tensors launch the kernel
or raise — there is no fallback on the card.
"""

from __future__ import annotations

import ctypes

import torch

from zebra_tpu_torch.ops import topk as TK

#: kernel launches since the last reset (the main-path proof in chip_smoke.py)
LAUNCHES = 0
#: of those, launches of the slab-major form
LAUNCHES_SLAB = 0
#: masked-candidate sentinel (pallas_rerank.BIG)
BIG = 3.0e38
#: widest top-k the kernel returns (pallas_rerank.OUT_K)
MAX_K = 128
_METRIC_CODE = {"cosine": 0, "l2": 1, "sql2": 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: f32 elements of one gather chunk of the plain version (1 GiB)
_REF_GATHER_ELEMS = 1 << 28
#: queries per block and slab rows per tile of the slab-major form
QUERY_GROUP = 128
TILE_ROWS = 128
#: the slab-major form is taken when M * SLAB_SHARE >= occupied slab rows
SLAB_SHARE = 16


def _distances(metric: str, dot, qn2, n2):
    """Distances as the kernels build them (``pallas_rerank.py:113-123``)
    from dots, the queries' ``|q|^2`` and the rows' stored squared norms."""
    if metric == "cosine":
        d = 1.0 - dot * torch.rsqrt(torch.clamp(qn2 * n2, min=1e-30))
        return torch.where(n2 * qn2 > 0, d, torch.ones_like(d))
    d2 = torch.clamp(qn2 + n2 - 2.0 * dot, min=0.0)
    return torch.sqrt(d2) if metric == "l2" else d2


def lsh_rerank_reference(vectors: torch.Tensor, q: torch.Tensor, cand: torch.Tensor,
                         cand_norms: torch.Tensor, cand_valid: torch.Tensor,
                         metric: str = "cosine", k: int = 10):
    """Plain torch re-rank, in chunks of queries whose ``[b, M, D]`` f32
    gather stays near 1 GiB: gather, einsum, distances as the kernel builds
    them (``pallas_rerank.py:113-123``), then the stable smallest-k (ties to
    the lowest candidate position)."""
    B, M = cand.shape
    D = q.shape[1]
    S = vectors.shape[0]
    dev = q.device
    kk = min(k, M)
    step = max(1, _REF_GATHER_ELEMS // max(M * D, 1))
    out_d, out_p = [], []
    for s in range(0, B, step):
        qq = q[s : s + step].float()
        idx = torch.clamp(cand[s : s + step].long(), 0, S - 1)
        dot = torch.einsum("bd,bmd->bm", qq, vectors[idx, :D].float())
        d = _distances(metric, dot, (qq * qq).sum(-1, keepdim=True), cand_norms[s : s + step])
        d = torch.where(cand_valid[s : s + step] > 0, d, torch.full_like(d, BIG))
        vals, pos = TK.smallest_k(d, kk)
        ok = vals < BIG
        out_d.append(torch.where(ok, vals, torch.full_like(vals, float("inf"))))
        out_p.append(torch.where(ok, pos, torch.full_like(pos, -1)))
    dk = torch.cat(out_d) if out_d else torch.zeros((0, kk), device=dev)
    pk = torch.cat(out_p) if out_p else torch.zeros((0, kk), dtype=torch.int64, device=dev)
    if kk < k:  # fewer candidates than k: pad the tail as missing
        dk = torch.cat([dk, torch.full((B, k - kk), float("inf"), device=dev)], 1)
        pk = torch.cat([pk, torch.full((B, k - kk), -1, dtype=torch.int64, device=dev)], 1)
    return dk, pk


def takes_slab_form(sorted_slots: bool, dtype: torch.dtype, k: int, M: int,
                    occupied: int) -> bool:
    """The dispatch rule of the card's two kernel forms, from host integers
    alone: sorted rows of an f32 or bf16 slab, ``k <= 128``, and a row width
    of at least 1/16 of the occupied slab rows take the slab-major form (a
    dense product over the occupied slab; at a lower density it would do
    many times the needed work). Everything else takes the gather form."""
    return (bool(sorted_slots) and dtype in _DTYPE_CODE and 0 < k <= MAX_K
            and occupied > 0 and M * SLAB_SHARE >= occupied)


def slab_grid(B: int, occupied: int, n_sm: int, query_group: int = QUERY_GROUP,
              tile_rows: int = TILE_ROWS) -> tuple[int, int]:
    """``(slab chunks, tiles per chunk)`` of the slab-major form: the
    ``ceil(B / 128)`` query groups times the chunks fill ``n_sm`` blocks once
    (a chunk is at least one tile of 128 rows; no chunk is empty)."""
    groups = -(-B // query_group)
    ntiles = -(-occupied // tile_rows)
    want = min(max(1, n_sm // groups), ntiles)
    per_chunk = -(-ntiles // want)
    return -(-ntiles // per_chunk), per_chunk


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` of f32 ``x``, by bit mask as the slab-major kernel does
    it: ``hi`` is ``x`` rounded to TF32 (10 mantissa bits, half away from
    zero), ``lo`` the remainder ``x - hi`` cut to TF32 (the tensor core
    ignores an operand's low 13 bits). ``hi*hi + hi*lo + lo*hi`` of two
    split operands is the 3xTF32 product the kernel sums."""
    x = x.float().contiguous()
    hi = ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    return hi, ((x - hi).view(torch.int32) & ~0x1FFF).view(torch.float32)


def lsh_rerank_slab_emulation(vectors, q, cand, cand_norms, cand_valid, metric: str = "cosine",
                              k: int = 10, occupied: int | None = None, n_sm: int = 132,
                              query_group: int = QUERY_GROUP, tile_rows: int = TILE_ROWS):
    """The slab-major kernel's decomposition in plain torch, for candidate
    rows whose valid entries ascend strictly by slot: query groups x slab
    chunks -> 3xTF32 dots of every (query, row) pair -> membership mask from
    the candidate rows -> per-chunk top-k by (distance, slot) -> merge by
    (distance, slot) -> each winner's position by a search in its row.
    ``query_group`` and ``tile_rows`` shrink the tiling for small tests."""
    B, M = cand.shape
    D = q.shape[1]
    S = vectors.shape[0]
    dev = q.device
    occupied = S if occupied is None else occupied
    if B == 0 or occupied == 0:
        return (torch.full((B, k), float("inf"), device=dev),
                torch.full((B, k), -1, dtype=torch.int64, device=dev))
    per_chunk = slab_grid(B, occupied, n_sm, query_group, tile_rows)[1]
    q32 = q.float()
    qn2 = (q32 * q32).sum(-1, keepdim=True)
    ok = cand_valid > 0
    slot = cand.long()
    rows_b = torch.arange(B, device=dev)[:, None].expand(B, M)
    part_d, part_s = [], []
    for lo in range(0, occupied, per_chunk * tile_rows):
        hi = min(lo + per_chunk * tile_rows, occupied)
        held = ok & (slot >= lo) & (slot < hi)
        mask = torch.zeros((B, hi - lo), dtype=torch.bool, device=dev)
        mask[rows_b[held], slot[held] - lo] = True
        n2 = torch.zeros((hi - lo,), device=dev)
        n2[slot[held] - lo] = cand_norms[held]
        xh, xl = (t.double() for t in split_tf32(vectors[lo:hi, :D]))
        d = torch.empty((B, hi - lo), device=dev)
        for g in range(0, B, query_group):
            qh, ql = (t.double() for t in split_tf32(q32[g : g + query_group]))
            dot = ((ql @ xh.T + qh @ xl.T) + qh @ xh.T).float()
            d[g : g + query_group] = _distances(metric, dot, qn2[g : g + query_group], n2)
        d = torch.where(mask, d, torch.full_like(d, BIG))
        # columns ascend by slot, so the stable smallest-k breaks ties by slot
        vals, idx = TK.smallest_k(d, min(k, hi - lo))
        part_d.append(vals)
        part_s.append(idx + lo)
    # chunks ascend by slot too: the same stable selection merges them
    all_d, all_s = torch.cat(part_d, 1), torch.cat(part_s, 1)
    kk = min(k, all_d.shape[1])
    vals, at = TK.smallest_k(all_d, kk)
    won = torch.gather(all_s, 1, at)
    # negative pads at a row's tail (a compacted row) search as +inf; at its
    # head (a row sorted as a whole) as they are
    tail_pads = (cand[:, :1] >= 0) & (cand[:, -1:] < 0)
    key = torch.where(tail_pads & (cand < 0), torch.full_like(slot, 2**31 - 1), slot)
    pos = torch.clamp(torch.searchsorted(key, won.contiguous()), max=M - 1)
    while True:  # a masked duplicate may stand before the slot's valid entry
        nxt = torch.clamp(pos + 1, max=M - 1)
        step = (~torch.gather(ok, 1, pos)) & (torch.gather(slot, 1, nxt) == won) & (nxt > pos)
        if not bool(step.any()):
            break
        pos = torch.where(step, nxt, pos)
    found = vals < BIG
    dk = torch.where(found, vals, torch.full_like(vals, float("inf")))
    pk = torch.where(found, pos, torch.full_like(pos, -1))
    if kk < k:
        dk = torch.cat([dk, torch.full((B, k - kk), float("inf"), device=dev)], 1)
        pk = torch.cat([pk, torch.full((B, k - kk), -1, dtype=torch.int64, device=dev)], 1)
    return dk, pk


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _launch(vectors, q, cand, cand_norms, cand_valid, metric: str, k: int,
            sorted_slots: bool, occupied: int | None):
    """Launch one of the two kernel forms on the current stream (raises on
    any input the kernels do not take, and when a launch fails)."""
    global LAUNCHES, LAUNCHES_SLAB
    from zebra_tpu_torch.ops import _kernels

    if vectors.dtype not in _DTYPE_CODE:
        raise ValueError(f"the CUDA re-rank takes f32 or bf16 slabs, got {vectors.dtype}")
    if metric not in _METRIC_CODE:
        raise ValueError(f"the CUDA re-rank takes {tuple(_METRIC_CODE)}, got {metric!r}")
    if not 0 < k <= MAX_K:
        raise ValueError(f"the CUDA re-rank takes 0 < k <= {MAX_K}, got {k}")
    if vectors.dim() != 2 or q.dim() != 2 or cand.dim() != 2:
        raise ValueError("vectors, q and cand must be 2-D")
    S, W = vectors.shape
    B, D = q.shape
    M = cand.shape[1]
    if D > W:
        raise ValueError(f"query width {D} exceeds the slab's stored width {W}")
    if cand.shape[0] != B or M < 1:
        raise ValueError(f"cand must be [{B}, M >= 1], got {tuple(cand.shape)}")
    for name, t, dt in (("q", q, torch.float32), ("cand", cand, torch.int32),
                        ("cand_norms", cand_norms, torch.float32),
                        ("cand_valid", cand_valid, torch.float32)):
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
    for name, t in (("cand_norms", cand_norms), ("cand_valid", cand_valid)):
        if tuple(t.shape) != (B, M):
            raise ValueError(f"{name} must be [{B}, {M}], got {tuple(t.shape)}")
    dev = q.device
    for t in (vectors, q, cand, cand_norms, cand_valid):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("lsh_rerank inputs must be contiguous on one CUDA device")
    occupied = S if occupied is None else occupied
    if not 0 <= occupied <= S:
        raise ValueError(f"occupied must lie in [0, {S}], got {occupied}")
    out_d = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_p = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B == 0:
        return out_d, out_p.long()
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    code = _METRIC_CODE[metric]
    if takes_slab_form(sorted_slots, vectors.dtype, k, M, occupied):
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        nchunks, per_chunk = slab_grid(B, occupied, n_sm)
        part_d = torch.empty((B, nchunks, k), dtype=torch.float32, device=dev)
        part_s = torch.empty((B, nchunks, k), dtype=torch.int32, device=dev)
        qsplit = torch.empty((2, B, D), dtype=torch.float32, device=dev)  # TF32 hi, lo of q
        fn = _kernels.load("lsh_rerank_slab").zt_lsh_rerank_slab
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 4
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
                       + [ctypes.c_void_p] * 5)
        err = fn(_ptr(vectors), _DTYPE_CODE[vectors.dtype], S, W, _ptr(q), _ptr(qsplit), D,
                 _ptr(cand), _ptr(cand_norms),
                 _ptr(cand_valid), B, M, k, code, occupied, nchunks, per_chunk,
                 _ptr(part_d), _ptr(part_s), _ptr(out_d), _ptr(out_p), stream)
        if err != 0:
            raise RuntimeError(f"lsh_rerank_slab kernel launch failed: cudaError {err}")
        LAUNCHES_SLAB += 1
    else:
        fn = _kernels.load("lsh_rerank").zt_lsh_rerank
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
                       + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3)
        err = fn(_ptr(vectors), _DTYPE_CODE[vectors.dtype], S, W, _ptr(q), D,
                 _ptr(cand), _ptr(cand_norms), _ptr(cand_valid), B, M, k, code,
                 _ptr(out_d), _ptr(out_p), stream)
        if err != 0:
            raise RuntimeError(f"lsh_rerank kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out_d, out_p.long()


def lsh_rerank(vectors: torch.Tensor, q: torch.Tensor, cand: torch.Tensor,
               cand_norms: torch.Tensor, cand_valid: torch.Tensor,
               metric: str = "cosine", k: int = 10, sorted_slots: bool = False,
               occupied: int | None = None):
    """Top-k of each query over its candidate slab rows.

    Args:
      vectors: ``[S, W]`` f32 or bf16 slab.
      q: ``[B, D]`` f32 queries, ``D <= W``.
      cand: ``[B, M]`` int32 candidate slots (any M >= 1; -1 allowed where
        ``cand_valid`` is 0).
      cand_norms: ``[B, M]`` f32 squared norms of the candidates.
      cand_valid: ``[B, M]`` f32, 1.0 live / 0.0 masked.
      k: top-k (<= 128 on the card).
      sorted_slots: the caller's promise that in every row the valid entries
        ascend strictly by slot — the row is non-decreasing as a whole
        (negative pads at its head), or its non-negative entries are a
        non-decreasing prefix and only negative pads follow — and that a
        slot carries the same norm in every row. It changes no result
        (ties to the lowest position are then ties to the lowest slot); on
        the card it lets :func:`takes_slab_form` pick the slab-major kernel.
      occupied: with ``sorted_slots``, a host integer bounding the valid
        slots from above (the bump allocator's next free slot); default S.

    Returns ``(dists [B, k] f32, pos [B, k] int64)``; ``pos`` indexes the
    candidate axis, -1 (distance +inf) where fewer than k are valid.
    CPU tensors take :func:`lsh_rerank_reference`; CUDA tensors launch a
    kernel or raise.
    """
    if q.is_cuda:
        return _launch(vectors, q, cand, cand_norms, cand_valid, metric, k,
                       sorted_slots, occupied)
    return lsh_rerank_reference(vectors, q, cand, cand_norms, cand_valid, metric, k)
