"""Dense HyperLogLog sketches as device register tensors.

Torch port of ``presto_tpu/ops/hll.py``, the mergeable state of
``approx_distinct`` (the reference's
``operator/aggregation/ApproximateCountDistinctAggregation.java``, backed by
airlift-stats HLL): int8 registers, ``[m]`` for a global aggregate and
``[capacity, m]`` per group, built with one scatter-max
(``scatter_reduce_(..., "amax")``), merged with an elementwise max, and
estimated with the bias-corrected harmonic mean, linear counting for the
small range and the 32-bit large-range correction.  The registers are
the JAX package's, bit for bit.

``m = 2048`` registers (p = 11) gives the reference's default standard
error, 1.04/sqrt(2048) ≈ 2.3 %.
"""

from __future__ import annotations

import torch

P_DEFAULT = 11
M_DEFAULT = 1 << P_DEFAULT


def bit_length32(w: torch.Tensor) -> torch.Tensor:
    """Bits needed for each value of ``w`` in [0, 2^32) (0 for 0): a
    five-step binary search over shifts, exact for every word (torch has
    no count-leading-zeros)."""
    n = torch.zeros_like(w)
    for s in (16, 8, 4, 2, 1):
        big = w >= (1 << s)
        w = torch.where(big, w >> s, w)
        n = n + big.to(w.dtype) * s
    return n + (w > 0).to(w.dtype)


def _index_rho(h: torch.Tensor, p: int):
    """Register index (the low p bits of the uint32 hash ``h``, an int64
    tensor) and the rank of the first set bit of the rest, in
    [1, 33 - p]: ``clz32(h >> p) - p + 1``, so a zero word ranks 33 - p."""
    idx = h & ((1 << p) - 1)
    clz = 32 - bit_length32(h >> p)
    return idx, (clz - p + 1).to(torch.int8)


def global_state(h: torch.Tensor, mask: torch.Tensor,
                 p: int = P_DEFAULT) -> torch.Tensor:
    """Registers [m] int8 of the masked rows' hashes."""
    m = 1 << p
    idx, rho = _index_rho(h, p)
    out = torch.zeros((m + 1,), dtype=torch.int8, device=h.device)
    out.scatter_reduce_(0, torch.where(mask, idx, m), rho, reduce="amax")
    return out[:m]


def group_state(h: torch.Tensor, slot: torch.Tensor, mask: torch.Tensor,
                capacity: int, p: int = P_DEFAULT) -> torch.Tensor:
    """Per-group registers [capacity, m] int8 (one scatter-max); ``slot``
    is each row's group (-1: none)."""
    m = 1 << p
    idx, rho = _index_rho(h, p)
    ok = mask & (slot >= 0)
    tgt = torch.where(ok, slot.to(torch.int64) * m + idx, capacity * m)
    out = torch.zeros((capacity * m + 1,), dtype=torch.int8, device=h.device)
    out.scatter_reduce_(0, tgt, rho, reduce="amax")
    return out[:capacity * m].reshape(capacity, m)


def merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """HLL union: elementwise register max."""
    return torch.maximum(a, b)


def seg_merge(states: torch.Tensor, slot: torch.Tensor, mask: torch.Tensor,
              capacity: int) -> torch.Tensor:
    """Per-row register vectors [n, m] merged into [capacity, m] by group
    slot (the FINAL step's state ⊕ state)."""
    n, m = states.shape
    tgt = torch.where(mask & (slot >= 0), slot.to(torch.int64), capacity)
    out = torch.zeros((capacity + 1, m), dtype=torch.int8,
                      device=states.device)
    out.scatter_reduce_(0, tgt[:, None].expand(n, m), states, reduce="amax")
    return out[:capacity]


def estimate(regs: torch.Tensor) -> torch.Tensor:
    """Registers [..., m] → distinct-count estimate (int64, rounded half to
    even as ``jnp.round``).  Every 2^-reg term and their sum are exact in
    float64, so the sum does not depend on the order of the additions."""
    m = regs.shape[-1]
    alpha = 0.7213 / (1.0 + 1.079 / m)
    s = torch.exp2(-regs.to(torch.float64)).sum(-1)
    e = alpha * m * m / s
    zeros = (regs == 0).to(torch.int32).sum(-1)
    lc = m * torch.log(m / zeros.clamp_min(1).to(torch.float64))
    est = torch.where((e <= 2.5 * m) & (zeros > 0), lc, e)
    two32 = 2.0 ** 32
    est = torch.where(est > two32 / 30.0,
                      -two32 * torch.log1p(-est / two32), est)
    return torch.round(est).to(torch.int64)

