"""Masked top-k and partial top-k merging (port of ``zebra_tpu/ops/topk.py``).

``lax.top_k`` breaks ties toward the lowest index; ``torch.topk`` promises no
tie order. Selection here is a STABLE ascending sort on distance, so equal
distances keep index order — the JAX package's tie rule, which merged partial
results (earlier chunk first) rely on.
"""

from __future__ import annotations

import torch


def smallest_k(d: torch.Tensor, k: int):
    """``(values, positions)`` of the ``k`` smallest entries per row of a
    NaN-free ``[B, W]`` tensor, ascending; ties go to the lowest position."""
    vals, idx = torch.sort(d, dim=1, stable=True)
    return vals[:, :k], idx[:, :k]


def masked_topk(dists: torch.Tensor, valid: torch.Tensor, ids: torch.Tensor, k: int):
    """Smallest-k selection under a validity mask.

    Returns ``(top_dists [B, k], top_ids [B, k], top_valid [B, k])``; invalid
    entries have distance +inf and id -1.
    """
    inf = torch.full_like(dists, float("inf"))
    d = torch.where(valid, dists, inf)
    d = torch.where(torch.isnan(d), inf, d)
    top_d, idx = smallest_k(d, k)
    top_i = torch.gather(ids, 1, idx)
    top_v = torch.gather(valid, 1, idx)
    top_i = torch.where(top_v, top_i, torch.full_like(top_i, -1))
    return top_d, top_i, top_v


def merge_topk(d_a, i_a, v_a, d_b, i_b, v_b, k: int):
    """Merge two partial top-k results (associative; ties keep ``a`` first)."""
    return masked_topk(
        torch.cat([d_a, d_b], dim=1),
        torch.cat([v_a, v_b], dim=1),
        torch.cat([i_a, i_b], dim=1),
        k,
    )
