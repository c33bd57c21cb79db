"""LSH candidate re-rank: the port of ``zebra_tpu/ops/pallas_rerank.py``.

Three things live here:

* :func:`lsh_rerank` — the wrapper ``buckets.query`` calls, with the contract
  of ``pallas_rerank.pallas_rerank``: per query, gather its M candidate rows
  by slab slot, take full-f32 dots, build cosine / l2 / sql2 from the stored
  squared norms, mask invalid candidates and return the top-k as
  ``(dists [B, k], pos [B, k])`` — positions into the candidate axis, with
  +inf / -1 where fewer than k candidates are valid.
* :func:`lsh_rerank_reference` — the plain torch version (the CPU path, and
  what ``chip_smoke.py`` holds the kernel against on the card).
* the CUDA launch of ``csrc/lsh_rerank.cu``, counted in :data:`LAUNCHES`.

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
#: masked-candidate sentinel (pallas_rerank.BIG)
BIG = 3.0e38
#: widest top-k the kernel returns (pallas_rerank.OUT_K)
MAX_K = 128
_METRIC_CODE = {"cosine": 0, "l2": 1, "sql2": 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: f32 elements of one gather chunk of the plain version (1 GiB)
_REF_GATHER_ELEMS = 1 << 28


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
        n2 = cand_norms[s : s + step]
        qn2 = (qq * qq).sum(-1, keepdim=True)
        if metric == "cosine":
            d = 1.0 - dot * torch.rsqrt(torch.clamp(qn2 * n2, min=1e-30))
            d = torch.where(n2 * qn2 > 0, d, torch.ones_like(d))
        else:
            d2 = torch.clamp(qn2 + n2 - 2.0 * dot, min=0.0)
            d = torch.sqrt(d2) if metric == "l2" else d2
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


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _launch(vectors, q, cand, cand_norms, cand_valid, metric: str, k: int):
    """Launch ``csrc/lsh_rerank.cu`` on the current stream (raises on any
    input the kernel does not take, and when the launch fails)."""
    global LAUNCHES
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
    out_d = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_p = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B == 0:
        return out_d, out_p.long()
    lib = _kernels.load("lsh_rerank")
    fn = lib.zt_lsh_rerank
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(
        _ptr(vectors), _DTYPE_CODE[vectors.dtype], S, W, _ptr(q), D,
        _ptr(cand), _ptr(cand_norms), _ptr(cand_valid), B, M, k, _METRIC_CODE[metric],
        _ptr(out_d), _ptr(out_p), ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"lsh_rerank kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out_d, out_p.long()


def lsh_rerank(vectors: torch.Tensor, q: torch.Tensor, cand: torch.Tensor,
               cand_norms: torch.Tensor, cand_valid: torch.Tensor,
               metric: str = "cosine", k: int = 10):
    """Top-k of each query over its candidate slab rows.

    Args:
      vectors: ``[S, W]`` f32 or bf16 slab.
      q: ``[B, D]`` f32 queries, ``D <= W``.
      cand: ``[B, M]`` int32 candidate slots (any M >= 1; -1 allowed where
        ``cand_valid`` is 0).
      cand_norms: ``[B, M]`` f32 squared norms of the candidates.
      cand_valid: ``[B, M]`` f32, 1.0 live / 0.0 masked.
      k: top-k (<= 128 on the card).

    Returns ``(dists [B, k] f32, pos [B, k] int64)``; ``pos`` indexes the
    candidate axis, -1 (distance +inf) where fewer than k are valid.
    CPU tensors take :func:`lsh_rerank_reference`; CUDA tensors launch the
    kernel or raise.
    """
    if q.is_cuda:
        return _launch(vectors, q, cand, cand_norms, cand_valid, metric, k)
    return lsh_rerank_reference(vectors, q, cand, cand_norms, cand_valid, metric, k)
