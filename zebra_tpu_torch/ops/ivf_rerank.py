"""IVF probe re-rank: the port of ``zebra_tpu/ops/pallas_ivf.py``.

Three things live here:

* :func:`ivf_rerank` — the adapter ``ivf.query`` calls, with the contract of
  ``pallas_ivf.ivf_rerank`` (residual-scan form): per query, the top-k over
  its P probed cluster blocks, as ``(dists, slots, valid)`` with +inf / -1 /
  False for missing results.
* :func:`ivf_rerank_reference` — the plain torch version (CPU oracle, and
  what ``chip_smoke.py`` holds the kernel against on the card).
* the CUDA launch of ``csrc/ivf_rerank.cu``, counted in :data:`LAUNCHES`.

Routing: a CPU query runs the plain version (``dots="highest"``, the grade
the kernel computes); a CUDA query launches the kernel or raises — there is
no fallback on the card.
"""

from __future__ import annotations

import ctypes

import torch

from zebra_tpu_torch.ops import topk as TK

#: kernel launches since the last reset (the main-path proof in chip_smoke.py)
LAUNCHES = 0
#: masked-candidate sentinel (pallas_ivf.BIG); rows at or above it are invalid
BIG = 3.0e38
#: widest top-k the kernel returns (pallas_ivf.OUT_K); wider k takes the
#: eager block path in ivf.query
MAX_K = 128
#: dynamic shared memory one block may use on sm_90 (227 KB)
MAX_SMEM = 232448
_METRIC_CODE = {"cosine": 0, "l2": 1, "sql2": 2}
#: queries per chunk of the plain version (~0.8 GB of f32 gather at P=2,
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


def ivf_rerank_reference(state, q32: torch.Tensor, probes: torch.Tensor, k: int,
                         metric: str = "cosine", dots: str = "highest"):
    """Plain torch re-rank of the probed blocks (in chunks of
    :data:`_REF_QCHUNK` queries, so a large batch never materialises its
    whole ``[B, P*C, D]`` gather).

    ``dots``: "highest" = f32 dots; "bf16x2f" = the Pallas kernel's default
    for reduced slabs — the coarse dot takes the split query ``q_hi + q_lo``
    and the residual dot only ``q_hi`` (``pallas_ivf.py:238-251``).
    """
    if dots not in ("highest", "bf16x2f"):
        raise ValueError(f"dots must be 'highest' or 'bf16x2f', got {dots!r}")
    C = state.cluster_capacity
    B, P = probes.shape
    dev = q32.device
    col = torch.arange(C, device=dev)
    kk = min(k, P * C)
    out_d, out_s = [], []
    for s in range(0, B, _REF_QCHUNK):
        pr = probes[s : s + _REF_QCHUNK].long()
        qq = q32[s : s + _REF_QCHUNK].float()
        rows = (pr[:, :, None] * C + col).reshape(pr.shape[0], P * C)
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
        if state.residual is not None:
            lo, _ = bdot(state.residual)
            dot = dot + lo * state.rscales[rows]
        n2 = state.norms[rows]
        qn2 = (qq * qq).sum(-1, keepdim=True)
        if metric == "cosine":
            d = 1.0 - dot * torch.rsqrt(torch.clamp(qn2 * n2, min=1e-30))
            d = torch.where(n2 * qn2 > 0, d, torch.ones_like(d))
        else:
            d2 = torch.clamp(qn2 + n2 - 2.0 * dot, min=0.0)
            d = torch.sqrt(d2) if metric == "l2" else d2
        d = torch.where(state.valid[rows], d, torch.full_like(d, BIG))
        vals, pos = TK.smallest_k(d, kk)
        ok = vals < BIG
        slot = torch.gather(pr, 1, pos // C) * C + pos % C
        out_d.append(torch.where(ok, vals, torch.full_like(vals, float("inf"))))
        out_s.append(torch.where(ok, slot, torch.full_like(slot, -1)))
    dk = torch.cat(out_d) if out_d else torch.zeros((0, kk), device=dev)
    sk = torch.cat(out_s) if out_s else torch.zeros((0, kk), dtype=torch.int64, device=dev)
    if kk < k:  # fewer candidates than k: pad the tail as missing
        dk = torch.cat([dk, torch.full((B, k - kk), float("inf"), device=dev)], 1)
        sk = torch.cat([sk, torch.full((B, k - kk), -1, dtype=torch.int64, device=dev)], 1)
    return dk, sk, sk >= 0


def _ptr(t: torch.Tensor | None):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _launch(state, q32: torch.Tensor, probes: torch.Tensor, k: int, metric: str):
    """Launch ``csrc/ivf_rerank.cu`` on the current stream (raises on any
    input the kernel does not take, and when the launch fails)."""
    global LAUNCHES
    from zebra_tpu_torch.ops import _kernels

    if state.vectors.dtype != torch.int8 or state.scales is None:
        raise NotImplementedError(
            f"the CUDA re-rank takes int8 slabs; {state.vectors.dtype} slabs "
            "are not ported yet (ROADMAP.md queue 2: the kernel's f32/bf16 slab forms)"
        )
    if metric not in _METRIC_CODE:
        raise ValueError(f"the CUDA re-rank takes {tuple(_METRIC_CODE)}, got {metric!r}")
    if not 0 < k <= MAX_K:
        raise ValueError(f"the CUDA re-rank takes 0 < k <= {MAX_K}, got {k}")
    B, P = probes.shape
    C, D = state.cluster_capacity, state.dim
    if tuple(q32.shape) != (B, D):
        raise ValueError(f"queries must be [{B}, {D}] for probes {tuple(probes.shape)}, "
                         f"got {tuple(q32.shape)}")
    smem = 4 * (D + P * C)
    if smem > MAX_SMEM:
        raise ValueError(
            f"P*C={P * C} candidates and D={D} need {smem} bytes of shared "
            f"memory per block; at most {MAX_SMEM} fit"
        )
    dev = q32.device
    res = state.residual
    tensors = [state.vectors, state.scales, state.norms, state.valid, state.counts]
    if res is not None:
        tensors += [res, state.rscales]
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("IVF state tensors must be contiguous on the query's device")
    if state.counts.dtype != torch.int32 or state.valid.dtype != torch.bool:
        raise ValueError("counts must be int32 and valid bool")
    q = q32.float().contiguous()
    pr = probes.to(torch.int32).contiguous()
    out_d = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_s = torch.empty((B, k), dtype=torch.int64, device=dev)
    if B == 0:
        return out_d, out_s, out_s >= 0
    lib = _kernels.load("ivf_rerank")
    fn = lib.zt_ivf_rerank
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(
        _ptr(q), _ptr(pr), _ptr(state.counts), _ptr(state.vectors), _ptr(res),
        _ptr(state.scales), _ptr(state.rscales if res is not None else None),
        _ptr(state.norms), _ptr(state.valid), _ptr(out_d), _ptr(out_s),
        B, P, C, D, k, _METRIC_CODE[metric], ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"ivf_rerank kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out_d, out_s, out_s >= 0


def ivf_rerank(state, q32: torch.Tensor, probes: torch.Tensor, k: int,
               metric: str = "cosine"):
    """Top-k of each query over its probed cluster blocks.

    Scores the full reconstruction when the state carries a residual slab
    (``refine="scan"``). Returns ``(dists [B, k], slots [B, k], valid [B, k])``.
    CPU tensors take :func:`ivf_rerank_reference`; CUDA tensors launch the
    kernel or raise.
    """
    if q32.is_cuda:
        return _launch(state, q32, probes, k, metric)
    return ivf_rerank_reference(state, q32, probes, k, metric, dots="highest")
