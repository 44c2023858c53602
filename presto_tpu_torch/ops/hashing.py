"""Vectorized key hashing: the uint32 hash that partitions rows.

Torch port of ``presto_tpu/ops/hashing.py`` (the reference hashes each key
column with a murmur3-style finalizer and combines the columns,
``operator/join/PagesHash.java:225-241``): the murmur3 32-bit finalizer
over the two 32-bit halves of each int64 key.  The hash is bit-identical
to the JAX package's.

torch has no unsigned 32-bit multiply on every backend, so each uint32
value travels in an int64 tensor in ``[0, 2^32)``: every add and xor is
masked back to 32 bits, a right shift acts on a non-negative value (so it
is logical), and a multiply by a 32-bit constant is split into its two
16-bit halves so that no int64 product overflows.
"""

from __future__ import annotations

from typing import Sequence

import torch

MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) and a 32-bit constant c: each
    partial product stays under 2^48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 finalizer over values in [0, 2^32) (int64 in/out)."""
    x = x.to(torch.int64) & MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hash_i64(k: torch.Tensor) -> torch.Tensor:
    """uint32 hash (in an int64 tensor) of an int64 (or narrower) key."""
    k = k.to(torch.int64)
    lo = k & MASK32
    hi = (k >> 32) & MASK32
    return mix32(lo ^ ((mix32(hi) + _GOLDEN) & MASK32))


def hash_keys(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Combined uint32 hash (in an int64 tensor) over the key columns."""
    h = hash_i64(keys[0])
    for k in keys[1:]:
        h = mix32((h + _GOLDEN + hash_i64(k)) & MASK32)
    return h


def hash_strings(packs: Sequence[torch.Tensor],
                 lengths: torch.Tensor) -> torch.Tensor:
    """uint32 hash of each string over its own big-endian 8-byte packs
    (``ops/sort.bytes_sort_keys``; ceil(length / 8) of them, at least
    one): ``hash_keys`` of those packs, so that a string hashes the same
    at any column width and in any dictionary."""
    h = hash_i64(packs[0])
    for j, k in enumerate(packs[1:], 1):
        h = torch.where(lengths > 8 * j,
                        mix32((h + _GOLDEN + hash_i64(k)) & MASK32), h)
    return h
