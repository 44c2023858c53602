"""Int128 arithmetic over paired int64 tensors (hi, lo).

Torch port of ``presto_tpu/ops/int128.py``: a DECIMAL(p>18) column stores
its unscaled value as ``values[N, 2]`` = (hi word signed, lo word as a
64-bit pattern), two's complement (the reference's
``spi/block/Int128ArrayBlock.java``).

Torch has no general uint64 arithmetic, so unsigned helpers work on int64
bit patterns: flipping the sign bit turns signed compares into unsigned
ones, a masked arithmetic shift is a logical shift, and int64 add, sub,
mul and left shift wrap — exactly two's-complement multiword arithmetic.

Rounding matches Trino: HALF_UP = round half away from zero
(``Decimals.java``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

I64Pair = Tuple[torch.Tensor, torch.Tensor]

SIGN = -2**63
M32 = 0xFFFFFFFF


def _i64(x, like: torch.Tensor = None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64)
    return torch.tensor(x, dtype=torch.int64,
                        device=None if like is None else like.device)


def ult(a, b):
    """Unsigned < over int64 bit patterns."""
    return (a ^ SIGN) < (b ^ SIGN)


def uge(a, b):
    return ~ult(a, b)


def lshr(x, k: int):
    """Logical (zero-fill) right shift of an int64 bit pattern by a static
    0 <= k < 64."""
    if k == 0:
        return x
    return (x >> k) & ((1 << (64 - k)) - 1)


def from_i64(x) -> I64Pair:
    x = _i64(x)
    return x >> 63, x  # sign extension


def pack(hi, lo) -> torch.Tensor:
    """(hi, lo) → values tensor [..., 2] (column storage layout)."""
    return torch.stack([_i64(hi), _i64(lo)], dim=-1)


def unpack(v: torch.Tensor) -> I64Pair:
    return v[..., 0], v[..., 1]


def add(ahi, alo, bhi, blo) -> I64Pair:
    lo = alo + blo  # wrapping
    carry = ult(lo, alo).to(torch.int64)
    return ahi + bhi + carry, lo


def neg(hi, lo) -> I64Pair:
    return ~hi + (lo == 0).to(torch.int64), -lo


def sub(ahi, alo, bhi, blo) -> I64Pair:
    return add(ahi, alo, *neg(bhi, blo))


def shl(hi, lo, k: int) -> I64Pair:
    """Left shift by a static 0 <= k < 64."""
    if k == 0:
        return hi, lo
    return (hi << k) | lshr(lo, 64 - k), lo << k


def abs128(hi, lo) -> I64Pair:
    n = hi < 0
    nhi, nlo = neg(hi, lo)
    return torch.where(n, nhi, hi), torch.where(n, nlo, lo)


def eq(ahi, alo, bhi, blo):
    return (ahi == bhi) & (alo == blo)


def lt(ahi, alo, bhi, blo):
    """Signed int128 <."""
    return (ahi < bhi) | ((ahi == bhi) & ult(alo, blo))


def cmp(op: str, ahi, alo, bhi, blo):
    if op == "=":
        return eq(ahi, alo, bhi, blo)
    if op == "<>":
        return ~eq(ahi, alo, bhi, blo)
    if op == "<":
        return lt(ahi, alo, bhi, blo)
    if op == ">":
        return lt(bhi, blo, ahi, alo)
    if op == "<=":
        return ~lt(bhi, blo, ahi, alo)
    if op == ">=":
        return ~lt(ahi, alo, bhi, blo)
    raise ValueError(op)


def umul64(a, b) -> I64Pair:
    """Full 64×64→128 product of unsigned bit patterns (32-bit limbs)."""
    a0, a1 = a & M32, lshr(a, 32)
    b0, b1 = b & M32, lshr(b, 32)
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = lshr(p00, 32) + (p01 & M32) + (p10 & M32)  # <= 3*(2^32-1): exact
    lo = (p00 & M32) | (mid << 32)
    hi = p11 + lshr(p01, 32) + lshr(p10, 32) + lshr(mid, 32)
    return hi, lo


def mul_i64(ahi, alo, m) -> I64Pair:
    """(signed int128) × (signed int64), low 128 bits (wrapping — callers
    guarantee the true product fits DECIMAL(38)).

    a = ahi·2^64 + u(alo) exactly (two's complement), m = u(m) − 2^64·[m<0],
    so mod 2^128: hi = umul_hi(alo,m) + ahi·m − [m<0]·alo."""
    m = _i64(m, alo).expand_as(alo)
    hi_c, lo = umul64(alo, m)
    hi = hi_c + ahi * m - torch.where(m < 0, alo, 0)
    return hi, lo


def mul(ahi, alo, bhi, blo) -> I64Pair:
    """int128 × int128, low 128 bits (wrapping).

    a·b = (ahi·2^64 + u(alo))(bhi·2^64 + u(blo)); mod 2^128 the cross terms
    reduce to wrapping int64 products (x·u(y) ≡ x·y mod 2^64)."""
    hi_c, lo = umul64(alo, blo)
    hi = hi_c + ahi * blo + alo * bhi
    return hi, lo


def udivmod(nhi, nlo, dhi, dlo):
    """Unsigned 128/128 long division (bit-serial shift-subtract, 128
    rounds with a static bit index — used on group-count-sized tensors).
    Returns (q_hi, q_lo, r_hi, r_lo).  Divisor must be nonzero."""
    qh = torch.zeros_like(nhi)
    ql = torch.zeros_like(nhi)
    rh = torch.zeros_like(nhi)
    rl = torch.zeros_like(nhi)
    for k in range(127, -1, -1):
        bit = lshr(nhi, k - 64) & 1 if k >= 64 else lshr(nlo, k) & 1
        rh = (rh << 1) | lshr(rl, 63)
        rl = (rl << 1) | bit
        ge = uge(rh, dhi) & ((rh != dhi) | uge(rl, dlo))
        rh2, rl2 = sub(rh, rl, dhi, dlo)
        rh = torch.where(ge, rh2, rh)
        rl = torch.where(ge, rl2, rl)
        g = ge.to(torch.int64)
        if k >= 64:
            qh = qh | (g << (k - 64))
        else:
            ql = ql | (g << k)
    return qh, ql, rh, rl


def div_round_half_up(nhi, nlo, dhi, dlo) -> I64Pair:
    """Signed int128 / int128, rounded half away from zero
    (``Decimals.java`` HALF_UP).  Divisor zero → caller masks validity
    (we substitute 1 to keep the kernel total)."""
    dz = eq(dhi, dlo, torch.zeros_like(dhi), torch.zeros_like(dlo))
    dhi = torch.where(dz, 0, dhi)
    dlo = torch.where(dz, 1, dlo)
    s = (nhi < 0) ^ (dhi < 0)
    nh, nl = abs128(nhi, nlo)
    dh, dl = abs128(dhi, dlo)
    qh, ql, rh, rl = udivmod(nh, nl, dh, dl)
    r2h, r2l = shl(rh, rl, 1)
    up = uge(r2h, dh) & ((r2h != dh) | uge(r2l, dl))
    qh, ql = add(qh, ql, torch.zeros_like(qh), up.to(torch.int64))
    nqh, nql = neg(qh, ql)
    return torch.where(s, nqh, qh), torch.where(s, nql, ql)


POW10 = [10**i for i in range(19)]


def rescale(hi, lo, from_scale: int, to_scale: int) -> I64Pair:
    """Decimal rescale in int128; scale-down is HALF_UP."""
    if to_scale == from_scale:
        return hi, lo
    k = abs(to_scale - from_scale)
    while k > 18:
        hi, lo = rescale(hi, lo, 0, 18 if to_scale > from_scale else -18)
        k -= 18
    if to_scale > from_scale:
        return mul_i64(hi, lo, POW10[k])
    return div_round_half_up(hi, lo,
                             *from_i64(torch.full_like(hi, POW10[k])))


# ------------------------------------------------- segment / global sums

def seg_sum128_from_i64(values, group, mask, capacity):
    """Σ int64 addends per group, exact in int128: 32-bit limb split, two
    int64 segment sums (safe for <2^31 rows/group), recombine.
    Returns (hi[capacity], lo[capacity])."""
    from . import agg as A
    v = _i64(values)
    lo_limb = v & M32              # [0, 2^32)
    hi_limb = v >> 32              # signed
    L = A.seg_sum(lo_limb, group, mask, capacity, torch.int64)
    H = A.seg_sum(hi_limb, group, mask, capacity, torch.int64)
    return add(*shl(*from_i64(H), 32), *from_i64(L))


def seg_sum128_from_i128(vals2d, group, mask, capacity):
    """Σ int128 addends ([N,2]) per group: four 32-bit limb sums."""
    from . import agg as A
    hi, lo = unpack(vals2d)
    S = [A.seg_sum(x, group, mask, capacity, torch.int64)
         for x in (lo & M32, lshr(lo, 32), hi & M32, hi >> 32)]
    r = from_i64(S[0])
    r = add(*r, *shl(*from_i64(S[1]), 32))
    # limb-2/3 contributions live entirely in the hi word (wrapping)
    hi_part = S[2] + (S[3] << 32)
    return add(*r, hi_part, torch.zeros_like(hi_part))


def g_sum128_from_i64(values, mask):
    v = torch.where(mask, _i64(values), 0)
    L = (v & M32).sum()
    H = (v >> 32).sum()
    return add(*shl(*from_i64(H), 32), *from_i64(L))


def g_sum128_from_i128(vals2d, mask):
    hi, lo = unpack(vals2d)
    S = [torch.where(mask, x, 0).sum() for x in
         (lo & M32, lshr(lo, 32), hi & M32, hi >> 32)]
    r = from_i64(S[0])
    r = add(*r, *shl(*from_i64(S[1]), 32))
    hi_part = S[2] + (S[3] << 32)
    return add(*r, hi_part, torch.zeros_like(hi_part))


# ------------------------------------------------- host conversion

def to_host_ints(values2d) -> np.ndarray:
    """[N,2] host array → 1-D object array of exact python ints."""
    a = np.asarray(values2d)
    hi = a[..., 0].astype(object)
    lo = a[..., 1].astype(object)
    lo_u = np.where(a[..., 1] < 0, lo + 2**64, lo)
    return hi * 2**64 + lo_u
