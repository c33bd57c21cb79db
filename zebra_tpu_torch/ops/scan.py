"""Exact top-k scan over a vector slab (port of ``zebra_tpu/ops/scan.py``).

A Python loop over slab chunks replaces ``lax.scan``: each chunk is
dequantised (scales, plus the residual reconstruction when given), scored
against the whole query batch (one matmul for the Gram-expansion metrics at
``precision``, the chunked elementwise form of ``distances.pairwise`` for the
other nine), reduced to its top-k and merged into the running result. It is
the flat index's query, the IVF spare merge and the brute-force recall oracle
(``ivf.brute_force``). JAX's ``approx`` flag (``lax.approx_max_k``) is
accepted and has no counterpart: selection is always exact.
"""

from __future__ import annotations

import torch

from zebra_tpu_torch.ops import distances as D
from zebra_tpu_torch.ops import topk as TK


def _chunk_rows(S: int, chunk: int) -> int:
    """The JAX package's chunk rule (a divisor of S, at most ``chunk``), so
    chunk boundaries — and with them tie order — match."""
    chunk = min(chunk, S)
    if S % chunk != 0:
        chunk = S & -S if S & -S < chunk else chunk
        while S % chunk != 0:
            chunk //= 2
    return chunk


def exact_scan(
    vectors: torch.Tensor,
    valid: torch.Tensor,
    q: torch.Tensor,
    k: int,
    metric: str = "cosine",
    power: float = 3.0,
    chunk: int = 8192,
    precision: str = "highest",
    approx: bool = False,
    scales: torch.Tensor | None = None,
    norms: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    rscales: torch.Tensor | None = None,
    w_start: int = 0,
    w_len: int | None = None,
):
    """Exact top-k of ``q`` [B, D] over slab rows ``[w_start, w_start+w_len)``.

    ``scales`` dequantise an int8 slab; ``residual``/``rscales`` add the
    second-stage reconstruction ``scales*vectors + rscales*residual``;
    ``norms`` (required with a residual) are the squared norms of what the
    slab stores; the elementwise metrics ignore them and score the
    reconstructed rows. ``power`` is minkowski's and p_norm's exponent;
    ``precision`` that of the Gram metrics' matmul ("highest": full f32;
    "default": bf16 operands with an f32 accumulator on the card, f32 on the
    CPU); ``approx`` is accepted for the JAX package's signature and changes
    nothing. Returned slot ids are absolute.

    Returns ``(dists [B, k], slots [B, k], valid [B, k])``.
    """
    del approx  # selection is always exact
    D.check_metric(metric)
    S = vectors.shape[0] if w_len is None else w_len
    B = q.shape[0]
    dev = q.device
    chunk = _chunk_rows(S, chunk)
    kb = min(k, chunk)
    q32 = q.float()
    qn2 = (q32 * q32).sum(-1)[:, None]
    dk = torch.full((B, k), float("inf"), device=dev)
    ik = torch.full((B, k), -1, dtype=torch.int64, device=dev)
    vk = torch.zeros((B, k), dtype=torch.bool, device=dev)
    for start in range(w_start, w_start + S, chunk):
        end = start + chunk
        vecs = vectors[start:end].float()
        if scales is not None:  # int8 slab: dequantise the chunk
            vecs = vecs * scales[start:end, None]
            if residual is not None:
                vecs = vecs + residual[start:end].float() * rscales[start:end, None]
        if metric in D.MXU_METRICS:
            dots = D.dot_pairwise(q32, vecs, precision)
            xn2 = norms[start:end] if norms is not None else (vecs * vecs).sum(-1)
            d = D.mxu_from_parts(metric, dots, qn2, xn2[None, :])
        else:
            d = D.pairwise(q32, vecs, metric=metric, power=power)
        sl = torch.arange(start, end, device=dev).expand(B, -1)
        vl = valid[start:end].expand(B, -1)
        td, ti, tv = TK.masked_topk(d, vl, sl, kb)
        dk, ik, vk = TK.merge_topk(dk, ik, vk, td, ti, tv, k)
    return dk, ik, vk
