"""Batched distance metrics: the three Gram-expansion ("MXU") metrics.

Port of the cosine / l2 / sql2 half of ``zebra_tpu/ops/distances.py``. Dots
run in full float32: ``torch.backends.cuda.matmul.allow_tf32`` stays False
(the JAX package's ``Precision.HIGHEST``); the port never enables TF32. The
nine elementwise metrics (chebyshev, canberra, braycurtis, manhattan, l3, l4,
hamming, minkowski, p_norm) are not ported yet (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import torch

#: Metrics whose pairwise form is a single matmul (Gram expansion).
MXU_METRICS = ("cosine", "sql2", "l2")

_EPS = 1e-30


def check_metric(metric: str) -> None:
    if metric not in MXU_METRICS:
        raise NotImplementedError(
            f"metric {metric!r} is not ported yet: the torch port has "
            f"{MXU_METRICS} (ROADMAP.md queue 1, elementwise metrics)"
        )


def _cosine_from_parts(dot, qn2, xn2):
    den = torch.sqrt(torch.clamp(qn2, min=0.0)) * torch.sqrt(torch.clamp(xn2, min=0.0))
    sim = torch.where(den > 0, dot / torch.clamp(den, min=_EPS), torch.zeros_like(dot))
    # zero-norm operand => similarity 0 => distance 1
    return 1.0 - sim


def mxu_from_parts(metric: str, dot, qn2, xn2):
    """Distance from ``dot`` [..., C], squared query norms ``qn2``
    (broadcastable) and squared candidate norms ``xn2``."""
    if metric == "cosine":
        return _cosine_from_parts(dot, qn2, xn2)
    d2 = torch.clamp(qn2 + xn2 - 2.0 * dot, min=0.0)
    return d2 if metric == "sql2" else torch.sqrt(d2)


def mxu_invert_parts(metric: str, d, qn2, xn2):
    """Inverse of :func:`mxu_from_parts`: the dot behind a distance (zero-norm
    rows give dot 0, consistent with the forward map's pinned cosine 1)."""
    if metric == "cosine":
        return (1.0 - d) * torch.sqrt(torch.clamp(qn2 * xn2, min=0.0))
    d2 = d * d if metric == "l2" else d
    return 0.5 * (qn2 + xn2 - d2)


def pairwise(q: torch.Tensor, x: torch.Tensor, metric: str = "cosine") -> torch.Tensor:
    """``[Q, C]`` float32 distances between query rows and candidate rows."""
    check_metric(metric)
    q32, x32 = q.float(), x.float()
    dot = q32 @ x32.T
    qn2 = (q32 * q32).sum(-1)[:, None]
    xn2 = (x32 * x32).sum(-1)[None, :]
    return mxu_from_parts(metric, dot, qn2, xn2)
