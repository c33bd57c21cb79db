"""Device ops of the LSH bucket-table index (port of
``zebra_tpu/index/buckets.py``).

The reference's forest of binary space-partitioning trees
(``src/database/index/lsh.rs``) as T hash tables:

  tree                      -> one table (row axis ``T``)
  root-to-leaf sign path    -> packed b-bit code (``ops/hashing.py``)
  leaf node                 -> fixed-capacity bucket row of slab slots
  per-vector tree insert    -> sort-by-code segmented append, reservoir
                               sampling once a bucket is full
  delete                    -> tombstone bit in ``valid``
  sibling backtracking      -> multi-probe bucket gather
  candidate union + re-rank -> sort-dedup + exact distances + top-k

JAX donates the state to each mutating jit and gets a new one back; the port
updates the state's tensors IN PLACE, so an insert costs no second slab.
Every sort whose order decides a result is stable (``jnp.argsort`` is), and
the bucket scatter resolves duplicate targets explicitly (the last entry in
sorted order wins, as XLA's in-order CPU scatter does), so the CPU and the
card build the same tables.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from zebra_tpu_torch.ops import distances as D
from zebra_tpu_torch.ops import hashing as H
from zebra_tpu_torch.ops.rowhash import _mix32, _wrap32
from zebra_tpu_torch.ops import topk as TK
from zebra_tpu_torch.storage.snapshots import slab_from_np

#: out-of-range sentinel (buckets.OOB): dropped scatter targets, pad keys
OOB = 2**30
#: eager re-ranks taken on the card because k exceeded the kernel's MAX_K
EAGER_LARGE_K = 0
#: per-candidate bytes of the candidate stage (gather, sort values and
#: indices, masks, compaction keys, the kernel's pre-gathered norms/validity)
_CAND_BYTES = 64


@dataclasses.dataclass
class LSHState:
    """All device tensors of one LSH index (fields as ``zebra_tpu``'s
    ``IndexState``)."""

    planes: torch.Tensor  # [T, b, W] f32 hyperplane normals
    consts: torch.Tensor  # [T, b] f32 hyperplane offsets
    buckets: torch.Tensor  # [T, R, C] int32 slab slots, -1 = empty
    counts: torch.Tensor  # [T, R] int32 true occupancy (not clipped at C)
    vectors: torch.Tensor  # [S, W] f32 or bf16 slab (W = stored width)
    norms: torch.Tensor  # [S] f32 squared norms of the stored values
    valid: torch.Tensor  # [S] bool liveness
    next_slot: torch.Tensor  # [] int32 bump allocator
    overflow: torch.Tensor  # [] int32 bucket entries dropped or displaced

    @property
    def num_tables(self) -> int:
        return self.buckets.shape[0]

    @property
    def bits(self) -> int:
        return self.planes.shape[1]

    @property
    def num_rows(self) -> int:
        return self.buckets.shape[1]

    @property
    def bucket_capacity(self) -> int:
        return self.buckets.shape[2]

    @property
    def slab_capacity(self) -> int:
        return self.vectors.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vectors.device


#: the JAX package's name of the state
IndexState = LSHState


def empty_state(planes: torch.Tensor, consts: torch.Tensor, bucket_capacity: int,
                slab_capacity: int, dtype=torch.float32) -> LSHState:
    """Fresh state on the planes' device."""
    T, b, dim = planes.shape
    dev = planes.device
    i32 = dict(dtype=torch.int32, device=dev)
    return LSHState(
        planes=planes.float(),
        consts=consts.float(),
        buckets=torch.full((T, 1 << b, bucket_capacity), -1, **i32),
        counts=torch.zeros((T, 1 << b), **i32),
        vectors=torch.zeros((slab_capacity, dim), dtype=dtype, device=dev),
        norms=torch.zeros((slab_capacity,), dtype=torch.float32, device=dev),
        valid=torch.zeros((slab_capacity,), dtype=torch.bool, device=dev),
        next_slot=torch.zeros((), **i32),
        overflow=torch.zeros((), **i32),
    )


def state_from_numpy(arrays, device="cpu", dtype=None) -> LSHState:
    """An :class:`LSHState` from numpy arrays named as its fields — a JAX
    state's leaves, or the members of an index snapshot (a bf16 slab arrives
    as uint16 bit patterns; ``dtype`` names the slab type)."""

    def t(name):
        return torch.from_numpy(np.array(arrays[name])).to(device)

    vectors = slab_from_np(arrays["vectors"], device, dtype)
    return LSHState(
        planes=t("planes").float(), consts=t("consts").float(), buckets=t("buckets").int(),
        counts=t("counts").int(), vectors=vectors, norms=t("norms").float(),
        valid=t("valid").bool(), next_slot=t("next_slot").int().reshape(()),
        overflow=t("overflow").int().reshape(()),
    )


# ---------------------------------------------------------------------------
# Insert
# ---------------------------------------------------------------------------


def _append(buckets: torch.Tensor, counts: torch.Tensor, codes: torch.Tensor,
            slots: torch.Tensor) -> int:
    """Append a batch to every table at once, in place; returns the number of
    entries that found their bucket full (the overflow increment).

    ``codes`` ``[n, T]``, ``slots`` ``[n]`` int64. Per table this is
    ``buckets._append_one_table``: a stable sort by code gives each entry
    its rank among equal codes; the entry's true occupancy index ``seen``
    is the bucket's count plus that rank; entries with ``seen < C`` append,
    later ones replace a slot chosen by a per-(table, slot) hash with
    probability C/(seen+1) (reservoir sampling). Tables are folded into one
    key ``t*R + code``, so one sort serves all T tables.
    """
    T, R, C = buckets.shape
    n = codes.shape[0]
    dev = codes.device
    table = torch.arange(T, device=dev)
    key = (table[None, :] * R + codes).T.reshape(-1)  # [T*n], table-major
    slot = slots.repeat(T)
    salt = (table + 1).repeat_interleave(n)
    order = torch.sort(key, stable=True).indices
    c, s, salt = key[order], slot[order], salt[order]
    ar = torch.arange(c.shape[0], device=dev)
    is_start = torch.ones_like(c, dtype=torch.bool)
    is_start[1:] = c[1:] != c[:-1]
    seg_start = torch.cummax(torch.where(is_start, ar, torch.zeros_like(ar)), 0).values
    flat_counts = counts.view(-1)
    seen = flat_counts[c].long() + (ar - seg_start)
    h = _mix32(_wrap32(s + _wrap32(salt * -1640531527)))  # 0x9e3779b9
    # lax.rem is truncated (torch.fmod); abs(INT_MIN) stays negative in int32
    u = torch.fmod(_wrap32(h.abs()), torch.clamp(seen + 1, min=1))
    pos = torch.where(seen < C, seen, torch.where(u < C, u, torch.full_like(u, OOB)))
    pos = torch.where(pos < 0, pos + C, pos)  # jnp index normalisation
    keep = (pos >= 0) & (pos < C)
    target = c[keep] * C + pos[keep]
    src = s[keep]
    # duplicate targets: the last in sorted order wins (XLA's CPU scatter
    # applies updates in order; CUDA index_put_ promises no order)
    t_order = torch.sort(target, stable=True).indices
    ts = target[t_order]
    last = torch.ones_like(ts, dtype=torch.bool)
    last[:-1] = ts[1:] != ts[:-1]
    buckets.view(-1)[ts[last]] = src[t_order][last].int()
    flat_counts.index_add_(0, c, torch.ones_like(c, dtype=torch.int32))
    return (seen >= C).sum()


def insert(state: LSHState, x: torch.Tensor, start: int | None = None) -> torch.Tensor:
    """Insert the rows of ``x`` ``[n, W]`` at slab slots ``start ..
    start+n-1`` (default: ``state.next_slot``, a device read), in place.

    Norms are those of the STORED (possibly bf16-rounded) values, and the
    codes hash the staged values, as the JAX package's. Returns the slots
    ``[n]`` int64.
    """
    n = x.shape[0]
    if start is None:
        start = int(state.next_slot)
    if start + n > state.slab_capacity:
        raise ValueError(f"slab full: {start} + {n} > {state.slab_capacity}")
    dev = state.device
    xd = x.to(state.vectors.dtype)
    state.vectors[start : start + n] = xd
    xs32 = xd.float()
    state.norms[start : start + n] = (xs32 * xs32).sum(-1)
    state.valid[start : start + n] = True
    slots = torch.arange(start, start + n, device=dev)
    codes = H.hash_codes(x, state.planes, state.consts)  # [n, T]
    ovf = _append(state.buckets, state.counts, codes, slots)
    state.next_slot += n
    state.overflow += ovf.int()
    return slots


# ---------------------------------------------------------------------------
# Delete (tombstone)
# ---------------------------------------------------------------------------


def delete_slots(state: LSHState, slots: torch.Tensor) -> None:
    """Tombstone slab slots in place (negative and out-of-range entries are
    ignored). Bucket rows keep the stale slots; queries mask them."""
    s = slots.long()
    s = s[(s >= 0) & (s < state.slab_capacity)]
    state.valid[s] = False


# ---------------------------------------------------------------------------
# Query
# ---------------------------------------------------------------------------


def _chunked_rerank(state: LSHState, q: torch.Tensor, cand: torch.Tensor,
                    cand_valid: torch.Tensor, k: int, metric: str, chunk: int = 2048,
                    power: float = 3.0):
    """Eager re-rank (the JAX package's "xla" path): gather candidate rows
    chunk by chunk, full-f32 dots and distances from stored norms (an
    elementwise metric: ``distances.rowwise`` of the gathered rows), running
    top-k. Any k. Returns ``(dists, slots, valid)`` ``[B, k]``."""
    B, M = cand.shape
    dev = q.device
    chunk = min(chunk, max(256, (2**31) // max(B * state.dim, 1)))
    q32 = q.float()
    qn2 = (q32 * q32).sum(-1)[:, None]
    dk = torch.full((B, k), float("inf"), device=dev)
    ik = torch.full((B, k), -1, dtype=torch.int64, device=dev)
    vk = torch.zeros((B, k), dtype=torch.bool, device=dev)
    S = state.slab_capacity
    for s in range(0, M, chunk):
        sl = cand[:, s : s + chunk].long()
        idx = torch.clamp(sl, 0, S - 1)
        if metric in D.MXU_METRICS:
            dot = torch.einsum("bd,bcd->bc", q32, state.vectors[idx].float())
            d = D.mxu_from_parts(metric, dot, qn2, state.norms[idx])
        else:
            d = D.rowwise(q32, state.vectors[idx], metric=metric, power=power)
        td, ti, tv = TK.masked_topk(d, cand_valid[:, s : s + chunk], sl, min(k, sl.shape[1]))
        dk, ik, vk = TK.merge_topk(dk, ik, vk, td, ti, tv, k)
    return dk, ik, vk


def _candidates(state: LSHState, q: torch.Tensor, num_probes: int, max_candidates: int = 0,
                lossless: bool = False):
    """Hash queries, gather the multiprobe bucket rows ``[B, T*P*C]``,
    sort-dedup across tables and mask dead or empty slots.

    With ``0 < max_candidates < T*P*C`` the live survivors are compacted to
    the front in candidate order and the row is cut to that width (the
    JAX package's stable argsort on validity; here a scatter to each
    survivor's running count, which places the same entries).
    ``lossless=True`` cuts instead to the batch's widest live set rounded
    up to a multiple of 1024 (one device read), so no survivor is dropped.

    Returns ``(cand [B, M] int32, cand_valid [B, M] bool)``.
    """
    acts = H.hash_activations(q, state.planes, state.consts)
    probes = H.multiprobe(acts, num_probes)  # [B, T, P]
    T = state.num_tables
    B = q.shape[0]
    t_idx = torch.arange(T, device=q.device)[None, :, None]
    cand = state.buckets[t_idx, probes].reshape(B, -1)
    cand = torch.sort(cand, dim=1).values
    dup = torch.zeros_like(cand, dtype=torch.bool)
    dup[:, 1:] = cand[:, 1:] == cand[:, :-1]
    S = state.slab_capacity
    in_slab = (cand >= 0) & (cand < S)
    live = state.valid[torch.clamp(cand, 0, S - 1).long()]
    cand_valid = in_slab & live & ~dup
    if lossless:
        widest = int(cand_valid.sum(1).max()) if B else 0
        max_candidates = -(-max(widest, 1) // 1024) * 1024
    if 0 < max_candidates < cand.shape[1]:
        M = max_candidates
        rank = torch.cumsum(cand_valid, dim=1) - 1
        keep = cand_valid & (rank < M)
        out = torch.full((B, M + 1), -1, dtype=cand.dtype, device=q.device)
        out.scatter_(1, torch.where(keep, rank, torch.full_like(rank, M)),
                     torch.where(keep, cand, torch.full_like(cand, -1)))
        out = out[:, :M]
        return out, out >= 0
    return cand, cand_valid


def _query_chunk_rows(state: LSHState, B: int, width: int, eager: bool,
                      elementwise: bool = False) -> int:
    """Queries per pass, bounding the candidate stage's ``[B, T*P*C]``
    transients and, on the eager path, one chunk's ``[B, 2048, W]`` f32
    gather (an elementwise metric holds a few more intermediates of that
    size: 24 bytes an element in all). The JAX package splits by a fixed 5
    GB; here the budget is a quarter of the device's free memory
    (``torch.cuda.mem_get_info``), or 1 GiB on the CPU. The split changes no
    result: queries are independent."""
    per_row = width * _CAND_BYTES
    if eager:
        per_row += 2048 * state.dim * (24 if elementwise else 8)
    dev = state.device
    budget = torch.cuda.mem_get_info(dev)[0] // 4 if dev.type == "cuda" else 1 << 30
    return max(1, min(B, budget // per_row))


def query(state: LSHState, q: torch.Tensor, k: int, metric: str = "cosine",
          num_probes: int = 8, rerank: str = "eager", max_candidates: int = 0,
          lossless: bool = False, dim: int | None = None, occupied: int | None = None,
          power: float = 3.0):
    """Approximate top-k: hash -> multi-probe gather -> dedup -> exact
    re-rank + top-k.

    ``q`` is ``[B, W]`` (zero-padded to the stored width). ``rerank="cuda"``
    takes :func:`lsh_rerank.lsh_rerank` (the CUDA kernel for card tensors,
    its plain version for CPU tensors) for k <= 128, reading only the first
    ``dim`` (default W) columns of each row; a wider k takes the eager path
    and is counted in :data:`EAGER_LARGE_K`. The nine elementwise metrics
    always take the eager path (``power``: minkowski's and p_norm's
    exponent). ``max_candidates <= 0`` keeps
    every probed entry; ``lossless`` compacts without dropping any.
    ``occupied`` is the host's count of allocated slab slots (slots are a
    bump allocator, so every stored slot lies below it; default: the slab's
    capacity): with the rows' sorted order, which :func:`_candidates`
    guarantees, it lets the wrapper choose its kernel form without a device
    read.

    Returns ``(dists [B, k], slots [B, k] int64, valid [B, k])``; missing
    results are +inf / -1 / False.
    """
    global EAGER_LARGE_K
    from zebra_tpu_torch.ops import lsh_rerank as LR

    full = state.num_tables * num_probes * state.bucket_capacity
    if max_candidates <= 0:
        max_candidates = full
    mxu = metric in D.MXU_METRICS
    use_kernel = rerank == "cuda" and mxu and k <= LR.MAX_K
    if rerank == "cuda" and mxu and not use_kernel:
        EAGER_LARGE_K += 1
    dim = dim or state.dim
    B = q.shape[0]
    step = _query_chunk_rows(state, B, full, eager=not use_kernel, elementwise=not mxu)
    S = state.slab_capacity
    outs = []
    for s in range(0, B, step):
        qc = q[s : s + step].float()
        cand, cand_valid = _candidates(state, qc, num_probes, max_candidates, lossless)
        if not use_kernel:
            outs.append(_chunked_rerank(state, qc, cand, cand_valid, k, metric, power=power))
            continue
        norms = state.norms[torch.clamp(cand, 0, S - 1).long()]
        d, pos = LR.lsh_rerank(state.vectors, qc[:, :dim].contiguous(), cand.int().contiguous(),
                               norms, cand_valid.float(), metric=metric, k=k,
                               sorted_slots=True, occupied=occupied)
        valid = pos >= 0
        slots = torch.gather(cand, 1, torch.clamp(pos, 0, cand.shape[1] - 1).long()).long()
        outs.append((d, torch.where(valid, slots, torch.full_like(slots, -1)), valid))
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def brute_force(state: LSHState, q: torch.Tensor, k: int, metric: str = "cosine",
                power: float = 3.0, chunk: int = 8192, precision: str = "highest"):
    """Exact top-k over the whole slab (the flat index's query and the recall
    oracle); ``precision`` as in :func:`zebra_tpu_torch.ops.scan.exact_scan`."""
    from zebra_tpu_torch.ops.scan import exact_scan

    return exact_scan(state.vectors, state.valid, q, k, metric=metric, power=power,
                      chunk=chunk, precision=precision)


def num_valid(state: LSHState) -> int:
    return int(state.valid.sum())
