"""Grouped/global aggregation kernels: masked segment reductions.

Torch port of ``presto_tpu/ops/agg.py`` (the reference's accumulator
framework, ``operator/aggregation/AccumulatorCompiler.java``).  Only the
``scatter`` strategy is kept: the JAX package's ``bcast`` and ``sort``
strategies exist because colliding scatters serialise on the TPU.  They
serialise on CUDA too: an int64 ``index_add_`` of TPC-H Q1's 60 M rows
into 4 of 64 slots took about 35 ms a call on an H100, some 150 times
what its bytes need.  So every int64 segment sum, count, minimum and
maximum goes to ``cuda_kernels.seg_reduce``, which combines colliding
rows in each warp and, for few slots, in each block's shared memory
before it touches global memory (its plain version on the CPU).  Float
sums and the extremes of other types stay on ``index_add_`` /
``scatter_reduce_``, whose rows that are masked out, or whose group id
lies outside ``[0, capacity)``, go to one spare slot past the end that is
then cut off (JAX's ``.at[].add(mode="drop")``).  Bitwise AND/OR have no
scatter combiner in torch: the grouped ones scan sorted runs by
doubling, the global ones reduce by halving.
"""

from __future__ import annotations

import torch

from . import cuda_kernels as CK

I64_MAX = 2**63 - 1
I64_MIN = -(2**63)


def _scatter_idx(group: torch.Tensor, mask: torch.Tensor, capacity: int):
    """Group ids with masked-out and out-of-range rows sent to the spare
    slot ``capacity``."""
    ok = mask & (group >= 0) & (group < capacity)
    return torch.where(ok, group.to(torch.int64), capacity)


def seg_sum(values, group, mask, capacity, dtype=None):
    dtype = dtype or values.dtype
    if dtype == torch.int64 and not values.is_floating_point():
        return CK.seg_reduce(values.to(torch.int64).contiguous(),
                             group.contiguous(), mask.contiguous(), capacity)
    out = torch.zeros((capacity + 1,), dtype=dtype, device=values.device)
    out.index_add_(0, _scatter_idx(group, mask, capacity), values.to(dtype))
    return out[:capacity]


def seg_count(group, mask, capacity):
    return CK.seg_reduce(None, group.contiguous(), mask.contiguous(),
                         capacity)


def _seg_extreme(values, group, mask, capacity, reduce: str):
    """Per-group minimum (``amin``) or maximum (``amax``); a group with no
    row keeps the dtype's own extreme.  int64 values go to ``seg_reduce``,
    others to a colliding ``scatter_reduce_``."""
    if values.dtype == torch.int64:
        return CK.seg_reduce(values.contiguous(), group.contiguous(),
                             mask.contiguous(), capacity, reduce[1:])
    if values.is_floating_point():
        init = float("inf") if reduce == "amin" else float("-inf")
    else:
        info = torch.iinfo(values.dtype)
        init = info.max if reduce == "amin" else info.min
    out = torch.full((capacity + 1,), init, dtype=values.dtype,
                     device=values.device)
    out.scatter_reduce_(0, _scatter_idx(group, mask, capacity), values,
                        reduce=reduce)
    return out[:capacity]


def seg_min(values, group, mask, capacity):
    return _seg_extreme(values, group, mask, capacity, "amin")


def seg_max(values, group, mask, capacity):
    return _seg_extreme(values, group, mask, capacity, "amax")


def seg_any(flags, group, mask, capacity):
    """Per group: does any masked-in row have its flag set (a count of
    those rows, compared with 0)."""
    return seg_count(group, mask & flags, capacity) > 0


def _seg_bitreduce(values, group, mask, capacity, init: int, op):
    """Segmented bitwise AND/OR.  torch has no bitwise ``scatter_reduce_``,
    so the rows are sorted by group once and a Hillis-Steele scan by
    doubling runs over the sorted values, ``v[i] = op(v[i], v[i - 2^k])``
    where both lie in one group's run; after ceil(log2 N) elementwise
    steps each run's last element holds its group's value, and those
    land in their slots with distinct indices.  Chosen over 64 bit
    planes of ``seg_count`` (64 colliding scatters over every row) and
    sized by the row count, so no host read is needed."""
    g = _scatter_idx(group, mask, capacity)
    order = torch.sort(g).indices
    sg = g[order]
    v = torch.where(sg < capacity, values[order].to(torch.int64), init)
    n = v.shape[0]
    k = 1
    while k < n:
        same = sg[k:] == sg[:-k]
        v = torch.cat([v[:k], torch.where(same, op(v[k:], v[:-k]), v[k:])])
        k *= 2
    last = torch.ones_like(sg, dtype=torch.bool)
    last[:-1] = sg[1:] != sg[:-1]
    out = torch.full((capacity + 1,), init, dtype=torch.int64,
                     device=values.device)
    out[torch.where(last, sg, capacity)] = torch.where(last, v, init)
    return out[:capacity]


def seg_bitand(values, group, mask, capacity):
    """Per-group bitwise AND (-1 for a group with no row)."""
    return _seg_bitreduce(values, group, mask, capacity, -1,
                          torch.bitwise_and)


def seg_bitor(values, group, mask, capacity):
    """Per-group bitwise OR (0 for a group with no row)."""
    return _seg_bitreduce(values, group, mask, capacity, 0, torch.bitwise_or)


# --- global (no group-by) variants: one-slot reductions ---

def g_sum(values, mask, dtype=None):
    """Σ values where mask.  A 1-D integer input with an int64 result goes
    to the ``masked_sum`` kernel (exactly JAX's dispatch in ``agg.g_sum``,
    without the TPU's block-size and VMEM guards)."""
    dtype = dtype or values.dtype
    if (values.dim() == 1 and not values.is_floating_point()
            and values.dtype != torch.bool and dtype == torch.int64):
        return CK.masked_sum(values.to(torch.int64), mask)
    return torch.where(mask, values, 0).to(dtype).sum()


def g_count(mask):
    return mask.to(torch.int64).sum()


def _g_bitreduce(values, mask, init: int, op):
    """Bitwise reduction of the masked-in values by halving: pairs
    combine until one value is left, ceil(log2 N) elementwise steps."""
    v = torch.where(mask, values.to(torch.int64), init)
    v = torch.cat([v, v.new_full((1,), init)])  # never empty
    while v.shape[0] > 1:
        if v.shape[0] % 2:
            v = torch.cat([v, v.new_full((1,), init)])
        v = op(v[0::2], v[1::2])
    return v.reshape(())


def g_bitand(values, mask):
    return _g_bitreduce(values, mask, -1, torch.bitwise_and)


def g_bitor(values, mask):
    return _g_bitreduce(values, mask, 0, torch.bitwise_or)


def g_min(values, mask):
    """Minimum of values where mask: integers as int64 (I64_MAX when
    none), floats as float64 (+inf when none)."""
    if values.is_floating_point():
        return torch.where(mask, values.to(torch.float64), float("inf")).min()
    return torch.where(mask, values.to(torch.int64), I64_MAX).min()


def g_max(values, mask):
    """Maximum of values where mask: integers as int64 (I64_MIN when
    none), floats as float64 (-inf when none)."""
    if values.is_floating_point():
        return torch.where(mask, values.to(torch.float64),
                           float("-inf")).max()
    return torch.where(mask, values.to(torch.int64), I64_MIN).max()
