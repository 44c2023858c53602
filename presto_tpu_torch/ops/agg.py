"""Grouped/global aggregation kernels: masked segment reductions.

Torch port of ``presto_tpu/ops/agg.py`` (the reference's accumulator
framework, ``operator/aggregation/AccumulatorCompiler.java``).  Only the
``scatter`` strategy is kept: the JAX package's ``bcast`` and ``sort``
strategies exist because colliding scatters serialise on the TPU, while
an integer ``index_add_`` on CUDA is exact and fast.  Rows that are masked
out, or whose group id lies outside ``[0, capacity)``, go to one spare slot
past the end that is then cut off (JAX's ``.at[].add(mode="drop")``).
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
    out = torch.zeros((capacity + 1,), dtype=dtype, device=values.device)
    out.index_add_(0, _scatter_idx(group, mask, capacity), values.to(dtype))
    return out[:capacity]


def seg_count(group, mask, capacity):
    out = torch.zeros((capacity + 1,), dtype=torch.int64, device=group.device)
    ones = torch.ones(group.shape, dtype=torch.int64, device=group.device)
    out.index_add_(0, _scatter_idx(group, mask, capacity), ones)
    return out[:capacity]


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


def g_min(values, mask):
    """Minimum of integer values where mask (int64; I64_MAX when none)."""
    return torch.where(mask, values.to(torch.int64), I64_MAX).min()


def g_max(values, mask):
    """Maximum of integer values where mask (int64; I64_MIN when none)."""
    return torch.where(mask, values.to(torch.int64), I64_MIN).max()
