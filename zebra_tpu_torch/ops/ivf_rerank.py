"""IVF probe re-rank: the port of ``zebra_tpu/ops/pallas_ivf.py``.

Three things live here:

* :func:`ivf_rerank` — the adapter ``ivf.query`` calls, with the contract of
  ``pallas_ivf.ivf_rerank`` in all its slab forms (int8 with scales, with or
  without the residual scan; bf16 and f32 without scales): per query, the
  top-k over its P probed cluster blocks, as ``(dists, slots, valid)`` with
  +inf / -1 / False for missing results.
* :func:`ivf_rerank_reference` — the plain torch version (CPU oracle, and
  what ``chip_smoke.py`` holds the kernel against on the card).
* the CUDA launch, in one of two forms chosen by
  ``ivf_cluster.takes_cluster_form``: the per-query kernel
  ``csrc/ivf_rerank.cu`` (every slab form), or the cluster-major form
  ``csrc/ivf_rerank_cluster.cu`` (int8 with or without the residual, bf16,
  f32; ``ops/ivf_cluster.py``), counted in :data:`LAUNCHES` and, by slab and
  kernel form, in :data:`LAUNCHES_BY_FORM`.

Routing: a CPU query runs the plain version (``dots="highest"``, the grade
the kernels compute); a CUDA query launches a kernel or raises — there is
no fallback on the card.
"""

from __future__ import annotations

import ctypes

import torch

from zebra_tpu_torch.ops import topk as TK

#: kernel launches since the last reset (the main-path proof in chip_smoke.py)
LAUNCHES = 0
#: the same launches by "<slab form>/<kernel form>": slab forms
#: "int8+residual", "int8", "bf16", "f32"; kernel forms "query" (per-query
#: kernel) and "cluster" (cluster-major form)
LAUNCHES_BY_FORM: dict[str, int] = {}
#: masked-candidate sentinel (pallas_ivf.BIG); rows at or above it are invalid
BIG = 3.0e38
#: widest top-k the kernel returns (pallas_ivf.OUT_K); wider k takes the
#: eager block path in ivf.query
MAX_K = 128
#: dynamic shared memory one block may use on sm_90 (227 KB)
MAX_SMEM = 232448
_METRIC_CODE = {"cosine": 0, "l2": 1, "sql2": 2}
#: slab element types of the kernels' C entry points
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_FORM_NAME = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8"}
#: most queries per chunk of a plain version (~0.8 GB of f32 gather at P=2,
#: C=128, D=768)
_REF_QCHUNK = 1024


def _split_bf16(x32: torch.Tensor):
    """``x ~= hi + lo`` with both halves bf16-exact, returned as f32:
    ``hi`` masks the low 16 mantissa bits (the bit-mask split of
    ``pallas_ivf._split_bf16``, not a cast round trip), ``lo`` is the
    bf16-rounded remainder."""
    hi = (x32.contiguous().view(torch.int32) & -65536).view(torch.float32)
    lo = (x32 - hi).to(torch.bfloat16).float()
    return hi, lo


def count_launch(by_form: dict, slab_dtype, residual: bool, cluster: bool) -> None:
    """Add one launch to ``by_form`` under ``"<slab form>/<kernel form>"``."""
    form = (_FORM_NAME[slab_dtype] + ("+residual" if residual else "")
            + ("/cluster" if cluster else "/query"))
    by_form[form] = by_form.get(form, 0) + 1


def ref_chunk(P: int, C: int, D: int) -> int:
    """Queries per pass of a plain version: one ``[b, P*C, D]`` f32 gather
    stays near 1 GiB."""
    return max(1, min(_REF_QCHUNK, (1 << 28) // max(P * C * D, 1)))


def probe_rows(pr: torch.Tensor, C: int) -> torch.Tensor:
    """Slab rows ``[b, P*C]`` of the probed blocks ``pr [b, P]``, in the
    flattened probe-axis order the kernels select over."""
    col = torch.arange(C, device=pr.device)
    return (pr[:, :, None] * C + col).reshape(pr.shape[0], -1)


def select_slots(d: torch.Tensor, pr: torch.Tensor, C: int, kk: int):
    """The ``kk`` smallest of ``d [b, P*C]`` (ties to the lowest position)
    as ``(dists, slots)``; entries at or above :data:`BIG` are missing
    (+inf, -1)."""
    vals, pos = TK.smallest_k(d, kk)
    ok = vals < BIG
    slot = torch.gather(pr, 1, pos // C) * C + pos % C
    return (torch.where(ok, vals, torch.full_like(vals, float("inf"))),
            torch.where(ok, slot, torch.full_like(slot, -1)))


def collect(out_d, out_s, B: int, k: int, kk: int, dev):
    """Per-chunk results joined into ``(dists, slots, valid) [B, k]``; with
    fewer candidates than k (``kk < k``) the tail is padded as missing."""
    dk = torch.cat(out_d) if out_d else torch.zeros((0, kk), device=dev)
    sk = torch.cat(out_s) if out_s else torch.zeros((0, kk), dtype=torch.int64, device=dev)
    if kk < k:
        dk = torch.cat([dk, torch.full((B, k - kk), float("inf"), device=dev)], 1)
        sk = torch.cat([sk, torch.full((B, k - kk), -1, dtype=torch.int64, device=dev)], 1)
    return dk, sk, sk >= 0


def distance_from_parts(metric: str, dot, qn2, n2):
    """The kernels' distance from ``dot``, ``|q|^2`` and the stored ``|x|^2``
    (``pallas_ivf.py:410-416``, ``experimental_ivf.py:134-140``): the rsqrt form of cosine, pinned to 1 on a
    zero norm."""
    if metric == "cosine":
        d = 1.0 - dot * torch.rsqrt(torch.clamp(qn2 * n2, min=1e-30))
        return torch.where(n2 * qn2 > 0, d, torch.ones_like(d))
    d2 = torch.clamp(qn2 + n2 - 2.0 * dot, min=0.0)
    return torch.sqrt(d2) if metric == "l2" else d2


def ivf_rerank_reference(state, q32: torch.Tensor, probes: torch.Tensor, k: int,
                         metric: str = "cosine", dots: str = "highest",
                         scan_residual: bool = True):
    """Plain torch re-rank of the probed blocks (in chunks of queries, so a
    large batch never materialises its whole ``[B, P*C, D]`` gather).

    ``scan_residual``: score the int8 + residual reconstruction when the
    state has a residual slab; False scores the coarse slab alone (the
    oversampled scan of refine=N).

    ``dots``: "highest" = f32 dots; "bf16x2f" = the Pallas kernel's default
    for reduced slabs — the coarse dot takes the split query ``q_hi + q_lo``
    and the residual dot only ``q_hi`` (``pallas_ivf.py:238-251``).
    """
    if dots not in ("highest", "bf16x2f"):
        raise ValueError(f"dots must be 'highest' or 'bf16x2f', got {dots!r}")
    C = state.cluster_capacity
    B, P = probes.shape
    kk = min(k, P * C)
    step = ref_chunk(P, C, state.dim)
    out_d, out_s = [], []
    for s in range(0, B, step):
        pr = probes[s : s + step].long()
        d = probe_distances(state, q32[s : s + step], pr, metric, dots, scan_residual)
        dk, sk = select_slots(d, pr, C, kk)
        out_d.append(dk)
        out_s.append(sk)
    return collect(out_d, out_s, B, k, kk, q32.device)


def probe_distances(state, q32: torch.Tensor, pr: torch.Tensor, metric: str = "cosine",
                    dots: str = "highest", scan_residual: bool = True) -> torch.Tensor:
    """The distances ``[b, P*C]`` of queries ``q32 [b, D]`` to every row of
    their probed blocks ``pr [b, P]``, in flattened probe-axis order, BIG
    where a row is not live (:func:`ivf_rerank_reference` without the
    selection; ``dots`` and ``scan_residual`` as there)."""
    C = state.cluster_capacity
    qq = q32.float()
    rows = probe_rows(pr.long(), C)
    qa, qb = (qq, None) if dots == "highest" else _split_bf16(qq)

    def bdot(slab):
        x = slab[rows].float()
        d = torch.einsum("bd,bcd->bc", qa, x)
        return d, x

    hi, x8 = bdot(state.vectors)
    if qb is not None:
        hi = hi + torch.einsum("bd,bcd->bc", qb, x8)
    del x8
    dot = hi
    if state.scales is not None:
        dot = hi * state.scales[rows]
    if scan_residual and state.residual is not None:
        lo, _ = bdot(state.residual)
        dot = dot + lo * state.rscales[rows]
    qn2 = (qq * qq).sum(-1, keepdim=True)
    d = distance_from_parts(metric, dot, qn2, state.norms[rows])
    return torch.where(state.valid[rows], d, torch.full_like(d, BIG))


def check_launch(k: int, P: int, C: int, width: int) -> None:
    """Raise unless a probe re-rank kernel can take ``k`` and hold one query
    of ``width`` floats plus its ``P*C`` distances in shared memory."""
    if not 0 < k <= MAX_K:
        raise ValueError(f"the CUDA re-rank takes 0 < k <= {MAX_K}, got {k}")
    smem = 4 * (-(-width // 4) * 4 + P * C)
    if smem > MAX_SMEM:
        raise ValueError(
            f"P*C={P * C} candidates and a row width of {width} need {smem} bytes of "
            f"shared memory per block; at most {MAX_SMEM} fit"
        )


def _ptr(t: torch.Tensor | None):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _launch(state, q32: torch.Tensor, probes: torch.Tensor, k: int, metric: str,
            scan_residual: bool = True):
    """Launch ``csrc/ivf_rerank.cu``, or the cluster-major form where
    ``ivf_cluster.takes_cluster_form`` takes the shape, on the current
    stream (raises on any input the kernels do not take, and when a launch
    fails)."""
    global LAUNCHES
    from zebra_tpu_torch.ops import _kernels
    from zebra_tpu_torch.ops import ivf_cluster

    vec = state.vectors
    if vec.dtype not in _DTYPE_CODE:
        raise NotImplementedError(
            f"the CUDA re-rank has int8, bf16 and f32 slab forms; a {vec.dtype} slab has none"
        )
    if (vec.dtype == torch.int8) != (state.scales is not None):
        raise ValueError("an int8 slab needs scales, and only an int8 slab has them")
    res = state.residual if scan_residual else None
    if res is not None and vec.dtype != torch.int8:
        raise ValueError("a residual slab rides only on an int8 slab")
    if metric not in _METRIC_CODE:
        raise ValueError(f"the CUDA re-rank takes {tuple(_METRIC_CODE)}, got {metric!r}")
    B, P = probes.shape
    C, D = state.cluster_capacity, state.dim
    if tuple(q32.shape) != (B, D):
        raise ValueError(f"queries must be [{B}, {D}] for probes {tuple(probes.shape)}, "
                         f"got {tuple(q32.shape)}")
    check_launch(k, P, C, D)
    dev = q32.device
    tensors = [vec, state.scales, state.norms, state.valid, state.counts]
    if res is not None:
        tensors += [res, state.rscales]
    for t in tensors:
        if t is not None and (t.device != dev or not t.is_contiguous()):
            raise ValueError("IVF state tensors must be contiguous on the query's device")
    if state.counts.dtype != torch.int32 or state.valid.dtype != torch.bool:
        raise ValueError("counts must be int32 and valid bool")
    q = q32.float().contiguous()
    pr = probes.to(torch.int32).contiguous()
    out_d = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_s = torch.empty((B, k), dtype=torch.int64, device=dev)
    if B == 0:
        return out_d, out_s, out_s >= 0
    if ivf_cluster.takes_cluster_form(B, P, D, C, vec.dtype, k):
        res_out = ivf_cluster.cluster_rerank(state, q, pr, k, metric, round_q=False,
                                             scan_residual=res is not None)
        LAUNCHES += 1
        count_launch(LAUNCHES_BY_FORM, vec.dtype, res is not None, cluster=True)
        return res_out
    lib = _kernels.load("ivf_rerank")
    fn = lib.zt_ivf_rerank
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 7
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(
        _ptr(q), _ptr(pr), _ptr(state.counts), _ptr(vec), _DTYPE_CODE[vec.dtype], _ptr(res),
        _ptr(state.scales), _ptr(state.rscales if res is not None else None),
        _ptr(state.norms), _ptr(state.valid), _ptr(out_d), _ptr(out_s),
        B, P, C, D, k, _METRIC_CODE[metric], ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"ivf_rerank kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    count_launch(LAUNCHES_BY_FORM, vec.dtype, res is not None, cluster=False)
    return out_d, out_s, out_s >= 0


def ivf_rerank(state, q32: torch.Tensor, probes: torch.Tensor, k: int,
               metric: str = "cosine", scan_residual: bool = True):
    """Top-k of each query over its probed cluster blocks.

    ``scan_residual`` (``refine="scan"``) scores the full reconstruction when
    the state carries a residual slab; False scores the coarse slab alone.
    Returns ``(dists [B, k], slots [B, k], valid [B, k])``. CPU tensors take
    :func:`ivf_rerank_reference`; CUDA tensors launch a kernel or raise (the
    per-query kernel or the cluster-major form, by
    ``ivf_cluster.takes_cluster_form``).
    """
    if q32.is_cuda:
        return _launch(state, q32, probes, k, metric, scan_residual)
    return ivf_rerank_reference(state, q32, probes, k, metric, dots="highest",
                                scan_residual=scan_residual)
