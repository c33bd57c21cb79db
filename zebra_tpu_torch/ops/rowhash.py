"""Device hashing of slab rows for deduplication (port of
``zebra_tpu/ops/rowhash.py``).

The reference deduplicates by hashing each vector's f32 bit patterns on the
host. Reading a multi-GB slab back for that is slow, so the device computes
two independent 32-bit mixes per row (an effective 64-bit key) and ships only
``[S] x 8`` bytes; the host then confirms colliding groups only, by gathering
those few rows.

torch has no logical right shift on int32 and no XOR reduction, and its
int32 products need not wrap: the mixes run on int64 tensors holding int32
values (``_wrap32`` after each product, shifts on the low 32 bits), rows in
chunks to bound the int64 temporaries, and the XOR fold is a halving tree
(XOR is associative and commutative, so the order does not matter).
"""

from __future__ import annotations

import torch

#: rows hashed per pass: bounds the [rows, D] int64 temporaries
_CHUNK_ROWS = 32768


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value with the same low 32 bits (two's complement)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2**31, x - 2**32, x)


def _mix32(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """The JAX package's int32 murmur3-finalizer mixer (xor-seeded), on int64
    tensors holding int32 values: wrap-around products, LOGICAL right
    shifts."""
    x = _wrap32(x ^ seed)
    x = _wrap32(x ^ ((x & 0xFFFFFFFF) >> 16))
    x = _wrap32(x * -2048144789)  # 0x85ebca6b
    x = _wrap32(x ^ ((x & 0xFFFFFFFF) >> 13))
    x = _wrap32(x * -1028477387)  # 0xc2b2ae35
    return _wrap32(x ^ ((x & 0xFFFFFFFF) >> 16))


def _xor_fold(x: torch.Tensor) -> torch.Tensor:
    """XOR of each row's entries, ``[n, w] -> [n]``."""
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        y = x[:, :h] ^ x[:, h : 2 * h]
        x = torch.cat([y, x[:, 2 * h :]], 1) if x.shape[1] % 2 else y
    return x[:, 0] if x.shape[1] else torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)


def _row_bits(rows: torch.Tensor) -> torch.Tensor:
    """The stored bits of each element as an int32 value (in int64): bf16
    patterns sign-extended from int16, int8 codes as they are, f32 patterns."""
    if rows.dtype == torch.bfloat16:
        return rows.view(torch.int16).to(torch.int64)
    if rows.dtype == torch.int8:
        return rows.to(torch.int64)
    return rows.float().contiguous().view(torch.int32).to(torch.int64)


def row_hashes(vectors: torch.Tensor) -> torch.Tensor:
    """``[S, 2]`` int32: two independent bit-pattern hashes per slab row.

    Hashes the raw stored bits (bf16 slabs their bf16 patterns; int8 slabs
    their codes, without the per-row scales, so equal-code rows with other
    scales collide and the caller confirms on dequantised values), with a
    column-position salt so that permuted rows differ."""
    S, W = vectors.shape
    out = torch.empty((S, 2), dtype=torch.int32, device=vectors.device)
    col = torch.arange(W, dtype=torch.int64, device=vectors.device)[None, :]
    salt = _wrap32(col * -1640531527)  # 0x9e3779b9
    for s in range(0, S, _CHUNK_ROWS):
        salted = _wrap32(_row_bits(vectors[s : s + _CHUNK_ROWS]) + salt)
        for j, seed in enumerate((0x243F6A88, 0x13198A2E)):
            out[s : s + _CHUNK_ROWS, j] = _xor_fold(_mix32(salted, seed)).to(torch.int32)
    return out
