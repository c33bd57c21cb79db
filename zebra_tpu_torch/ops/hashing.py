"""Random-hyperplane hashing (port of ``zebra_tpu/ops/hashing.py``).

Every table of the forest hashes in one matmul:

  acts[n, T, b]  = x @ planes^T + consts      (f32 matmul, TF32 off)
  codes[n, T]    = bit-pack of (acts >= 0)    (b <= 16 bits per table)

``multiprobe`` flips the lowest-|margin| sign bits of each (query, table)
code, the reference's backtracking into the sibling subtree
(``src/database/index/lsh.rs:340-345``). Hyperplanes are either Gaussian
through the origin or the reference's data-dependent bisectors of random
stored-vector pairs (``lsh.rs:221-230``).

JAX draws the random parts from a key inside the jitted function; here they
come from a ``torch.Generator`` or, in the parity tests, are injected
(``draws``) as JAX computed them. JAX hashes at its backend's default matmul
precision (f32 on the CPU); the port always hashes in full f32, so codes can
differ only in bits whose activation is at rounding level.
"""

from __future__ import annotations

import torch

MAX_BITS = 16

# Static multiprobe perturbation schedule: subsets of the margin-sorted bit
# positions (0 = smallest |margin|). Index 0 is the unperturbed code.
PROBE_SETS: tuple[tuple[int, ...], ...] = (
    (),
    (0,),
    (1,),
    (0, 1),
    (2,),
    (0, 2),
    (1, 2),
    (3,),
    (0, 1, 2),
    (0, 3),
    (1, 3),
    (4,),
    (0, 1, 3),
    (2, 3),
    (0, 4),
    (5,),
)
MAX_PROBES = len(PROBE_SETS)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def sample_planes_random(num_tables: int, bits: int, dim: int,
                         generator: torch.Generator | None = None, normals=None):
    """Gaussian hyperplanes through the origin: ``planes [T, b, dim]`` f32
    (unit rows) and ``consts [T, b]`` zeros. ``normals`` injects the raw
    ``[T, b, dim]`` draw."""
    if normals is None:
        normals = torch.randn((num_tables, bits, dim), generator=generator)
    planes = _unit(torch.as_tensor(normals).float())
    return planes, torch.zeros((num_tables, bits), dtype=torch.float32, device=planes.device)


def sample_planes_data(num_tables: int, bits: int, data: torch.Tensor,
                       generator: torch.Generator | None = None, draws=None,
                       width: int | None = None):
    """Data-dependent hyperplanes: perpendicular bisectors of random pairs of
    rows of ``data`` ``[n, D]`` (n >= 2), computed on ``data``'s device.

    ``draws`` injects ``(pairs [T, b, 2] int, fallback [T, b, width] f32
    raw normals)``; otherwise both come from ``generator`` (on the CPU).
    Rows are zero-padded to ``width`` (default D) before use — the stored
    width of a padded slab. Degenerate pairs (a == b) take the normalised
    fallback plane through the pair's midpoint, so no bit is constant.
    """
    n, dim = data.shape
    width = width or dim
    if draws is None:
        pairs = torch.randint(0, n, (num_tables, bits, 2), generator=generator)
        fallback = torch.randn((num_tables, bits, width), generator=generator)
    else:
        pairs, fallback = draws
    dev = data.device
    pairs = torch.as_tensor(pairs).to(dev).long()
    fallback = torch.as_tensor(fallback).to(dev).float()

    def rows(i):
        r = data[i.reshape(-1)].float().reshape(num_tables, bits, dim)
        return torch.nn.functional.pad(r, (0, width - dim)) if width > dim else r

    a, b = rows(pairs[..., 0]), rows(pairs[..., 1])
    coeff = b - a
    norm = torch.linalg.vector_norm(coeff, dim=-1, keepdim=True)
    coeff = torch.where(norm > 1e-12, coeff / torch.clamp(norm, min=1e-30), _unit(fallback))
    mid = 0.5 * (a + b)
    consts = -(coeff * mid).sum(-1)
    return coeff, consts


def hash_activations(x: torch.Tensor, planes: torch.Tensor, consts: torch.Tensor) -> torch.Tensor:
    """Signed distances ``[n, T, b]`` f32 of every row of ``x`` ``[n, D]`` to
    every hyperplane of every table (``planes [T, b, D]``, ``consts [T, b]``)."""
    T, b, D = planes.shape
    acts = x.float() @ planes.reshape(T * b, D).T
    return acts.reshape(x.shape[0], T, b) + consts[None]


def pack_signs(acts: torch.Tensor) -> torch.Tensor:
    """Sign bits of ``[n, T, b]`` activations packed into ``[n, T]`` int64
    codes (bit j = plane j)."""
    b = acts.shape[-1]
    weights = 1 << torch.arange(b, dtype=torch.int64, device=acts.device)
    return ((acts >= 0).long() * weights).sum(-1)


def hash_codes(x: torch.Tensor, planes: torch.Tensor, consts: torch.Tensor) -> torch.Tensor:
    """``[n, T]`` int64 bucket codes of the rows of ``x``."""
    return pack_signs(hash_activations(x, planes, consts))


def multiprobe(acts: torch.Tensor, num_probes: int) -> torch.Tensor:
    """Multi-probe codes ``[B, T, num_probes]`` int64 of query activations
    ``[B, T, b]``; probe 0 is the base code, probe p flips the bits of
    ``PROBE_SETS[p]`` in |margin| order (stable: equal margins keep bit
    order, as ``jnp.argsort``)."""
    if not 1 <= num_probes <= MAX_PROBES:
        raise ValueError(f"num_probes must be in [1, {MAX_PROBES}]")
    codes = pack_signs(acts)
    if num_probes == 1:
        return codes[..., None]
    b = acts.shape[-1]
    order = torch.sort(acts.abs(), dim=-1, stable=True).indices  # [B, T, b]
    masks = []
    for s in PROBE_SETS[:num_probes]:
        m = torch.zeros_like(codes)
        for j in s:
            if j < b:
                m = m | (1 << order[..., j])
        masks.append(m)
    return codes[..., None] ^ torch.stack(masks, dim=-1)
