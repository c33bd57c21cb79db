"""Batched distance metrics (port of ``zebra_tpu/ops/distances.py``).

Twelve metrics: the three Gram-expansion ("MXU") metrics cosine / l2 / sql2,
whose pairwise form is one matmul, and nine elementwise reductions of
``a - b`` (chebyshev, canberra, braycurtis, manhattan, l3, l4, hamming,
minkowski(power), p_norm(power)). ``pairwise`` gives a ``[Q, C]`` matrix,
``rowwise`` per-query candidate distances ``[B, C]``.

Dots run in full float32 at ``precision="highest"`` (and "high"):
``torch.backends.cuda.matmul.allow_tf32`` stays False, the JAX package's
``Precision.HIGHEST``; the port never enables TF32. ``precision="default"``
is the TPU's DEFAULT: on the card the operands are rounded to bf16 and
multiplied on the tensor cores with an f32 accumulator; on the CPU it stays
f32, as JAX's DEFAULT does on the CPU.

Eager torch materialises the ``[Q, C, D]`` difference that XLA fuses into its
reduction, so the elementwise pairwise form walks query and row chunks that
keep that intermediate at or under :data:`ELEMENTWISE_BYTES`. Chunking
changes no result: each pair's reduction over D is the same.
"""

from __future__ import annotations

import torch

#: Metrics whose pairwise form is a single matmul (Gram expansion).
MXU_METRICS = ("cosine", "sql2", "l2")

_EPS = 1e-30

#: the largest ``[q, c, D]`` f32 intermediate of one elementwise chunk
ELEMENTWISE_BYTES = 1 << 30

_PRECISIONS = ("highest", "high", "default")


def _chebyshev(a, b):
    return torch.amax(torch.abs(a - b), dim=-1)


def _canberra(a, b):
    # sum |a-b| / (|a| + |b|); terms with a zero denominator add 0
    num = torch.abs(a - b)
    den = torch.abs(a) + torch.abs(b)
    return torch.where(den > 0, num / torch.clamp(den, min=_EPS), 0.0).sum(-1)


def _braycurtis(a, b):
    num = torch.abs(a - b).sum(-1)
    den = torch.abs(a + b).sum(-1)
    return torch.where(den > 0, num / torch.clamp(den, min=_EPS), 0.0)


def _manhattan(a, b):
    return torch.abs(a - b).sum(-1)


def _l3(a, b):
    # torch has no cbrt: the cube root as pow(s, 1/3) of the non-negative sum
    # (within an ulp or two of jnp.cbrt)
    d = torch.abs(a - b)
    return torch.pow((d * d * d).sum(-1), 1.0 / 3.0)


def _l4(a, b):
    d = a - b
    d2 = d * d
    return torch.sqrt(torch.sqrt((d2 * d2).sum(-1)))


def _minkowski(a, b, power: float):
    d = torch.abs(a - b)
    return torch.pow(torch.pow(d, power).sum(-1), 1.0 / power)


def _p_norm(a, b, power: float):
    # the reference's ``minkowski_p``: sum |a-b|^p without the 1/p root
    return torch.pow(torch.abs(a - b), power).sum(-1)


def _hamming(a, b):
    # the reference's semantics: popcount of the LOW BYTE of the XOR of the
    # f32 bit patterns, summed (an 8-bit popcount in int32 arithmetic)
    x = (a.float().contiguous().view(torch.int32) ^ b.float().contiguous().view(torch.int32)) & 0xFF
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    x = (x + (x >> 4)) & 0x0F
    return x.sum(-1).float()


_ELEMENTWISE = {
    "chebyshev": _chebyshev,
    "canberra": _canberra,
    "braycurtis": _braycurtis,
    "manhattan": _manhattan,
    "l3": _l3,
    "l4": _l4,
    "hamming": _hamming,
}
_POWERED = {"minkowski": _minkowski, "p_norm": _p_norm}

#: All supported metric names.
METRICS = MXU_METRICS + tuple(_ELEMENTWISE) + tuple(_POWERED)


def check_metric(metric: str) -> None:
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; choose from {METRICS}")


def _check_precision(precision: str) -> None:
    if precision not in _PRECISIONS:
        raise ValueError(f"unknown matmul precision {precision!r}; choose from "
                         f"{sorted(_PRECISIONS)}")


def _elementwise_fn(metric: str, power: float):
    if metric in _POWERED:
        fn = _POWERED[metric]
        return lambda a, b: fn(a, b, power)
    return _ELEMENTWISE[metric]


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


def dot_pairwise(q32: torch.Tensor, x32: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """``[Q, C]`` f32 dots of f32 rows at ``precision``: "default" on the card
    is one bf16-operand GEMM with an f32 accumulator and f32 output."""
    _check_precision(precision)
    if precision == "default" and q32.is_cuda:
        return torch.mm(q32.to(torch.bfloat16), x32.to(torch.bfloat16).T, out_dtype=torch.float32)
    return q32 @ x32.T


def _dot_rowwise(q32, x32, precision):
    _check_precision(precision)
    if precision == "default" and q32.is_cuda:  # bf16 products, f32 sums
        q32, x32 = q32.to(torch.bfloat16).float(), x32.to(torch.bfloat16).float()
    return torch.einsum("bd,bcd->bc", q32, x32)


def _elementwise_pairwise(fn, q, x):
    """``fn`` over every (query, row) pair in chunks whose ``[q, c, D]``
    difference stays within :data:`ELEMENTWISE_BYTES`."""
    Q, C, Dd = q.shape[0], x.shape[0], q.shape[1]
    pairs = max(1, ELEMENTWISE_BYTES // (4 * max(Dd, 1)))
    if Q * C <= pairs:
        return fn(q[:, None, :], x[None, :, :])
    cc = min(C, pairs)
    qc = max(1, min(Q, pairs // cc))
    out = torch.empty((Q, C), dtype=torch.float32, device=q.device)
    for s in range(0, Q, qc):
        for c in range(0, C, cc):
            out[s : s + qc, c : c + cc] = fn(q[s : s + qc, None, :], x[None, c : c + cc, :])
    return out


def pairwise(q: torch.Tensor, x: torch.Tensor, metric: str = "cosine", power: float = 3.0,
             precision: str = "highest") -> torch.Tensor:
    """``[Q, C]`` float32 distances between query rows ``q [Q, D]`` and
    candidate rows ``x [C, D]``; ``power`` is minkowski's and p_norm's
    exponent."""
    check_metric(metric)
    q32, x32 = q.float(), x.float()
    if metric in MXU_METRICS:
        dot = dot_pairwise(q32, x32, precision)
        qn2 = (q32 * q32).sum(-1)[:, None]
        xn2 = (x32 * x32).sum(-1)[None, :]
        return mxu_from_parts(metric, dot, qn2, xn2)
    return _elementwise_pairwise(_elementwise_fn(metric, power), q32, x32)


def rowwise(q: torch.Tensor, x: torch.Tensor, metric: str = "cosine", power: float = 3.0,
            precision: str = "highest") -> torch.Tensor:
    """Per-query candidate distances: ``q [B, D]`` against ``x [B, C, D]``
    gives ``[B, C]`` float32 (the re-rank workhorse; the caller bounds the
    candidate block)."""
    check_metric(metric)
    q32, x32 = q.float(), x.float()
    if metric in MXU_METRICS:
        dot = _dot_rowwise(q32, x32, precision)
        qn2 = (q32 * q32).sum(-1)[:, None]
        xn2 = (x32 * x32).sum(-1)
        return mxu_from_parts(metric, dot, qn2, xn2)
    return _elementwise_fn(metric, power)(q32[:, None, :], x32)
