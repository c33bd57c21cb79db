"""The one-slab wave re-rank and the augmented-slab re-rank: the port of
``zebra_tpu/ops/experimental_ivf.py``.

Two surfaces, each a plain torch version beside the launch of a hand-written
CUDA kernel; CPU tensors take the plain version, CUDA tensors launch the
kernel or raise (no fallback on the card):

* :func:`ivf_rerank_wave` — the twin of ``pallas_ivf.ivf_rerank(..., wave=2)``,
  i.e. of ``experimental_ivf._kernel_factory_v2``: the coarse stage of the
  gather-refine query (``refine=N`` with ``rerank="pallas2"``), a re-rank of
  ONE slab with a bf16-rounded query on int8 / bf16 slabs. Kernels: the
  per-query ``csrc/ivf_rerank_wave.cu``, or the cluster-major form
  ``csrc/ivf_rerank_cluster.cu`` (int8, bf16 and f32 slabs;
  ``ops/ivf_cluster.py``) where ``ivf_cluster.takes_cluster_form`` takes the
  shape; counted in :data:`LAUNCHES_WAVE` and by form in
  :data:`LAUNCHES_WAVE_BY_FORM`.
* :func:`augment_slab`, :func:`aug_query`, :func:`aug_post`,
  :func:`rerank_aug_raw` and the adapter :func:`ivf_rerank_aug` — the twins
  of the functions of those names in ``experimental_ivf.py``
  (``rerank_aug_raw`` is ``pallas_ivf_rerank_aug``, i.e.
  ``_kernel_factory_v3``): rows carry their norm and liveness in
  :data:`AUG` extra lanes, so a re-rank is one dot per row and nothing else.
  No database tier stores an augmented slab; the surface is ops-level, as in
  the JAX package. Kernels: the per-query ``csrc/ivf_rerank_aug.cu``, or the
  cluster-major form ``csrc/ivf_rerank_cluster.cu`` (bf16 and f32 slabs;
  ``ivf_cluster.aug_rerank``) where ``ivf_cluster.AugSlab.takes_cluster_form``
  takes the shape; counted in :data:`LAUNCHES_AUG` and by form in
  :data:`LAUNCHES_AUG_BY_FORM`.
"""

from __future__ import annotations

import ctypes

import torch

from zebra_tpu_torch.ops import topk as TK
from zebra_tpu_torch.ops.ivf_rerank import (_DTYPE_CODE, _METRIC_CODE, BIG, _ptr, check_launch,
                                            collect, count_launch, probe_distances,
                                            probe_rows, ref_chunk, select_slots)

#: launches of the wave re-rank (either kernel form) since the last reset
LAUNCHES_WAVE = 0
#: the same launches by "<slab form>/<kernel form>" (``ivf_rerank.count_launch``)
LAUNCHES_WAVE_BY_FORM: dict[str, int] = {}
#: launches of the aug re-rank (either kernel form) since the last reset
LAUNCHES_AUG = 0
#: the same launches by "<slab form>/<kernel form>" (``ivf_rerank.count_launch``)
LAUNCHES_AUG_BY_FORM: dict[str, int] = {}
#: augmentation lanes appended to the stored dim (``pallas_ivf.AUG``)
AUG = 128
#: dead-row penalty stored in lane D of an augmented row — chosen so that BOTH
#: its f32 value and its bf16 ROUNDING stay >= BIG after the dot
#: (bf16(3.2e38) = 3.20e38 > BIG; a 3.0e38 constant would round DOWN below BIG
#: in bf16 and dead rows would leak through the sentinel clamp)
PEN = 3.2e38


# -- the one-slab wave re-rank (kernel 2) -----------------------------------------


def _wave_query(state, q32: torch.Tensor) -> torch.Tensor:
    """The query as the kernel multiplies it: rounded to bf16 on int8 / bf16
    slabs, where every product is then exact in f32 (``pallas_ivf.py:553-558``),
    unchanged on f32 slabs."""
    if state.vectors.dtype == torch.float32:
        return q32.float()
    return q32.to(torch.bfloat16).float()


def ivf_rerank_wave_reference(state, q32: torch.Tensor, probes: torch.Tensor, k: int,
                              metric: str = "cosine"):
    """Plain torch version of :func:`ivf_rerank_wave` (in chunks of queries).

    Scores ``state.vectors`` only — a residual slab is never read — with
    the rounded query of :func:`_wave_query`, f32 accumulation, int8 dots
    scaled after the dot, and ``|q|^2`` taken from the ROUNDED query
    (``experimental_ivf.py:64-66``).
    """
    C = state.cluster_capacity
    B, P = probes.shape
    kk = min(k, P * C)
    step = ref_chunk(P, C, state.dim)
    out_d, out_s = [], []
    for s in range(0, B, step):
        pr = probes[s : s + step].long()
        d = probe_distances(state, _wave_query(state, q32[s : s + step]), pr, metric,
                            scan_residual=False)
        dk, sk = select_slots(d, pr, C, kk)
        out_d.append(dk)
        out_s.append(sk)
    return collect(out_d, out_s, B, k, kk, q32.device)


def _launch_wave(state, q32: torch.Tensor, probes: torch.Tensor, k: int, metric: str):
    """Launch ``csrc/ivf_rerank_wave.cu``, or the cluster-major form where
    ``ivf_cluster.takes_cluster_form`` takes the shape, on the current
    stream (raises on any input the kernels do not take, and when a launch
    fails)."""
    global LAUNCHES_WAVE
    from zebra_tpu_torch.ops import _kernels
    from zebra_tpu_torch.ops import ivf_cluster

    vec = state.vectors
    if vec.dtype not in _DTYPE_CODE:
        raise ValueError(f"the wave re-rank takes int8, bf16 or f32 slabs, got {vec.dtype}")
    if (vec.dtype == torch.int8) != (state.scales is not None):
        raise ValueError("an int8 slab needs scales, and only an int8 slab has them")
    if metric not in _METRIC_CODE:
        raise ValueError(f"the wave re-rank takes {tuple(_METRIC_CODE)}, got {metric!r}")
    B, P = probes.shape
    C, D = state.cluster_capacity, state.dim
    if tuple(q32.shape) != (B, D):
        raise ValueError(f"queries must be [{B}, {D}] for probes {tuple(probes.shape)}, "
                         f"got {tuple(q32.shape)}")
    check_launch(k, P, C, D)
    dev = q32.device
    for t in (vec, state.norms, state.valid, state.counts, state.scales):
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
    round_q = vec.dtype != torch.float32
    if ivf_cluster.takes_cluster_form(B, P, D, C, vec.dtype, k, round_q):
        res = ivf_cluster.cluster_rerank(state, q, pr, k, metric, round_q=round_q,
                                         scan_residual=False)
        LAUNCHES_WAVE += 1
        count_launch(LAUNCHES_WAVE_BY_FORM, vec.dtype, False, cluster=True)
        return res
    fn = _kernels.load("ivf_rerank_wave").zt_ivf_rerank_wave
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    err = fn(
        _ptr(q), _ptr(pr), _ptr(state.counts), _ptr(vec), _DTYPE_CODE[vec.dtype],
        _ptr(state.scales), _ptr(state.norms), _ptr(state.valid), _ptr(out_d), _ptr(out_s),
        B, P, C, D, k, _METRIC_CODE[metric], int(round_q),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"ivf_rerank_wave kernel launch failed: cudaError {err}")
    LAUNCHES_WAVE += 1
    count_launch(LAUNCHES_WAVE_BY_FORM, vec.dtype, False, cluster=False)
    return out_d, out_s, out_s >= 0


def ivf_rerank_wave(state, q32: torch.Tensor, probes: torch.Tensor, k: int,
                    metric: str = "cosine"):
    """Top-k of each query over its probed blocks of the coarse slab alone
    (the contract of ``pallas_ivf.ivf_rerank(..., wave=2)``).

    Returns ``(dists [B, k], slots [B, k], valid [B, k])`` with +inf / -1 /
    False for missing results. Any probe count is taken (the TPU kernel's
    even-P padding adds only masked rows). CPU tensors take
    :func:`ivf_rerank_wave_reference`; CUDA tensors launch a kernel or raise
    (the per-query kernel or the cluster-major form, by
    ``ivf_cluster.takes_cluster_form``).
    """
    if q32.is_cuda:
        return _launch_wave(state, q32, probes, k, metric)
    return ivf_rerank_wave_reference(state, q32, probes, k, metric)


# -- the augmented-slab re-rank (kernel 3) ------------------------------------------


def _check_aug_dtype(dtype) -> None:
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"augmented slabs are f32 or bf16, got {dtype}")


def augment_slab(vectors: torch.Tensor, norms: torch.Tensor, valid: torch.Tensor,
                 metric: str = "cosine", chunk: int = 65536) -> torch.Tensor:
    """The augmented slab ``[S, D + AUG]`` of an f32 / bf16 slab
    (``experimental_ivf.augment_slab``), built ``chunk`` rows at a time.

    Lane layout of the AUG tail: lane 0 = dead-row penalty (0 live,
    :data:`PEN` dead or empty), lanes 1-2 = the squared norm split as
    ``hi + lo`` (``hi`` = the norm rounded to the slab's type, ``lo`` the f32
    remainder, so a bf16 slab keeps ~16 mantissa bits of it; both zero for
    cosine, whose body rows are L2-NORMALISED), the rest zero.
    """
    _check_aug_dtype(vectors.dtype)
    S, D = vectors.shape
    dt = vectors.dtype
    out = torch.zeros((S, D + AUG), dtype=dt, device=vectors.device)
    for s in range(0, S, chunk):
        e = min(S, s + chunk)
        n = norms[s:e].float()
        body = vectors[s:e].float()
        if metric == "cosine":
            body = body * torch.rsqrt(torch.clamp(n, min=1e-30))[:, None]
        else:
            nhi = n.to(dt).float()
            out[s:e, D + 1] = nhi.to(dt)
            out[s:e, D + 2] = (n - nhi).to(dt)
        out[s:e, :D] = body.to(dt)
        out[s:e, D] = torch.where(valid[s:e], 0.0, PEN).to(dt)
    return out


def aug_query(q32: torch.Tensor, metric: str = "cosine") -> torch.Tensor:
    """Queries pre-transformed for the aug kernel, ``[B, D] -> [B, D + AUG]``
    (``experimental_ivf.aug_query``): cosine ``[-q/|q|, 1, 1, 1, 0...]`` (the
    dot gives ``-cos + penalty``), l2 / sql2 ``[-2q, 1, 1, 1, 0...]`` (the dot
    gives ``|v|^2 - 2 q.v + penalty``; ``|q|^2`` is added after selection)."""
    B = q32.shape[0]
    if metric == "cosine":
        qn2 = (q32 * q32).sum(1)
        wq = -q32 * torch.rsqrt(torch.clamp(qn2, min=1e-30))[:, None]
    else:
        wq = -2.0 * q32
    aug = torch.zeros((B, AUG), dtype=torch.float32, device=q32.device)
    aug[:, 0:3] = 1.0
    return torch.cat([wq, aug], dim=1)


def aug_post(d_raw: torch.Tensor, q32: torch.Tensor, metric: str) -> torch.Tensor:
    """Raw kernel values back to true distances (valid entries only;
    ``experimental_ivf.aug_post``)."""
    if metric == "cosine":
        return 1.0 + d_raw
    qn2 = (q32 * q32).sum(1)[:, None]
    d2 = torch.clamp(qn2 + d_raw, min=0.0)
    return torch.sqrt(d2) if metric == "l2" else d2


def _aug_w(vectors_aug: torch.Tensor, w: torch.Tensor, exact: bool) -> torch.Tensor:
    """``w`` as the kernel multiplies it: f32 when ``exact``, else rounded to
    the slab's type (``experimental_ivf.py:329``)."""
    return w.float() if exact else w.to(vectors_aug.dtype).float()


def rerank_aug_raw_reference(vectors_aug: torch.Tensor, C: int, w: torch.Tensor,
                             probes: torch.Tensor, k: int, exact: bool = True):
    """Plain torch version of :func:`rerank_aug_raw` (in chunks of queries):
    one f32-accumulated dot per probed row, ``min(d, BIG)``, the stable
    smallest-k. All ``D + AUG`` stored lanes are read."""
    B, P = probes.shape
    Da = vectors_aug.shape[1]
    kk = min(k, P * C)
    ww = _aug_w(vectors_aug, w, exact)
    step = ref_chunk(P, C, Da)
    out_d, out_p = [], []
    for s in range(0, B, step):
        rows = probe_rows(probes[s : s + step].long(), C)
        d = torch.einsum("bd,bcd->bc", ww[s : s + step], vectors_aug[rows].float())
        d = torch.clamp(d, max=BIG)
        vals, pos = TK.smallest_k(d, kk)
        ok = vals < BIG
        out_d.append(torch.where(ok, vals, torch.full_like(vals, float("inf"))))
        out_p.append(torch.where(ok, pos, torch.full_like(pos, -1)))
    d, p, _ = collect(out_d, out_p, B, k, kk, w.device)
    return d, p


def _launch_aug(vectors_aug: torch.Tensor, C: int, w: torch.Tensor, probes: torch.Tensor,
                k: int, exact: bool):
    """Launch ``csrc/ivf_rerank_aug.cu``, or the cluster-major form where
    ``ivf_cluster.AugSlab.takes_cluster_form`` takes the shape, on the
    current stream (raises on any input the kernels do not take, and when a
    launch fails)."""
    global LAUNCHES_AUG
    from zebra_tpu_torch.ops import _kernels
    from zebra_tpu_torch.ops import ivf_cluster

    B, P = probes.shape
    Da = vectors_aug.shape[1]
    if tuple(w.shape) != (B, Da):
        raise ValueError(f"w must be [{B}, {Da}] for probes {tuple(probes.shape)}, "
                         f"got {tuple(w.shape)}")
    check_launch(k, P, C, Da)
    dev = w.device
    if vectors_aug.device != dev or not vectors_aug.is_contiguous():
        raise ValueError("the augmented slab must be contiguous on the query's device")
    wf = w.float().contiguous()
    pr = probes.to(torch.int32).contiguous()
    out_d = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_p = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B == 0:
        return out_d, out_p.long()
    round_w = not exact and vectors_aug.dtype == torch.bfloat16
    slab = ivf_cluster.AugSlab(vectors_aug, C)
    if slab.takes_cluster_form(B, P, k, round_w):
        res = ivf_cluster.aug_rerank(slab, wf, pr, k, round_w)
        LAUNCHES_AUG += 1
        count_launch(LAUNCHES_AUG_BY_FORM, vectors_aug.dtype, False, cluster=True)
        return res
    fn = _kernels.load("ivf_rerank_aug").zt_ivf_rerank_aug
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    err = fn(
        _ptr(wf), _ptr(pr), _ptr(vectors_aug), _DTYPE_CODE[vectors_aug.dtype], _ptr(out_d),
        _ptr(out_p), B, P, C, Da, k, int(round_w),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"ivf_rerank_aug kernel launch failed: cudaError {err}")
    LAUNCHES_AUG += 1
    count_launch(LAUNCHES_AUG_BY_FORM, vectors_aug.dtype, False, cluster=False)
    return out_d, out_p.long()


def rerank_aug_raw(vectors_aug: torch.Tensor, C: int, w: torch.Tensor, probes: torch.Tensor,
                   k: int = 10, exact: bool = True):
    """Aux-free re-rank over an augmented slab (the contract of
    ``experimental_ivf.pallas_ivf_rerank_aug``).

    ``vectors_aug`` is ``[K*C + G, D + AUG]``, ``w`` ``[B, D + AUG]`` the
    pre-transformed queries, ``probes`` ``[B, P]`` cluster ids with P even.
    ``exact``: f32 ``w`` against rows widened to f32; otherwise ``w`` is
    rounded to the slab's type first. Returns ``(d_raw [B, k], pos [B, k])``,
    ``pos`` on the flat ``[P*C]`` probe axis, (+inf, -1) where fewer than k
    live rows exist. CPU tensors take :func:`rerank_aug_raw_reference`; CUDA
    tensors launch a kernel or raise (the per-query kernel or the
    cluster-major form, by ``ivf_cluster.AugSlab.takes_cluster_form``).
    """
    _check_aug_dtype(vectors_aug.dtype)
    if probes.shape[1] % 2:
        raise ValueError("aug re-rank probes must be even (probe one more real cluster)")
    if w.is_cuda:
        return _launch_aug(vectors_aug, C, w, probes, k, exact)
    return rerank_aug_raw_reference(vectors_aug, C, w, probes, k, exact)


def _aug_adapter(raw, vectors_aug, C, q32, probes, k, metric, exact):
    if metric not in _METRIC_CODE:
        raise ValueError(f"the aug re-rank takes {tuple(_METRIC_CODE)}, got {metric!r}")
    P = probes.shape[1]
    d_raw, pos = raw(vectors_aug, C, aug_query(q32.float(), metric), probes, k, exact)
    valid = pos >= 0
    posc = torch.clamp(pos, 0, P * C - 1)
    cl = torch.gather(probes.long(), 1, posc // C)
    slots = torch.where(valid, cl * C + posc % C, torch.full_like(posc, -1))
    inf = torch.full_like(d_raw, float("inf"))
    return torch.where(valid, aug_post(d_raw, q32.float(), metric), inf), slots, valid


def ivf_rerank_aug(vectors_aug: torch.Tensor, C: int, q32: torch.Tensor, probes: torch.Tensor,
                   k: int, metric: str = "cosine", exact: bool = True):
    """Adapter of the aug re-rank (``experimental_ivf.ivf_rerank_aug``):
    transform the queries, run :func:`rerank_aug_raw`, map the flat
    probe-axis positions back to slab slots and the raw values to distances.
    ``probes`` must have an EVEN width of REAL cluster ids. Returns
    ``(dists, slots, valid) [B, k]``."""
    return _aug_adapter(rerank_aug_raw, vectors_aug, C, q32, probes, k, metric, exact)


def ivf_rerank_aug_reference(vectors_aug: torch.Tensor, C: int, q32: torch.Tensor,
                             probes: torch.Tensor, k: int, metric: str = "cosine",
                             exact: bool = True):
    """:func:`ivf_rerank_aug` through the plain version on any device."""
    return _aug_adapter(rerank_aug_raw_reference, vectors_aug, C, q32, probes, k, metric, exact)
