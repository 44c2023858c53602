"""Mergeable quantile sketch: per-group bottom-k priority sampling.

Torch port of ``presto_tpu/ops/quantile.py``, bit for bit.  The
reference's approx_percentile carries a qdigest/tdigest state
(``operator/aggregation/ApproximateLongPercentileAggregations.java``,
airlift qdigest).  Here the state is a BOTTOM-K SAMPLE: every row gets a
uniform hash priority (``hashing.hash_keys`` of its value bits and its row
index); a group's state is the k rows of smallest priority.  Merging two
states is exact (bottom-k of the union = bottom-k of the concatenation),
so the state crosses the partial → final exchange like a sum.  Quantile
error is O(1/sqrt(k)); a group of at most k rows is sampled whole and its
estimate is the exact nearest rank.

Only the multi-rank aggregation (``parallel/distributed.py``) reaches
this module: the single-device and streamed answers stay exact.

Layouts: values [capacity, k] in the argument's dtype, priorities
[capacity, k] int64 (``P_EMPTY`` = no entry), counts [capacity] int64.
"""

from __future__ import annotations

import torch

from .hashing import hash_keys
from .hashtable import run_bounds
from .sort import argsort_multi

P_EMPTY = 2**62   # priority of an empty entry
DEFAULT_K = 8192


def k_for(capacity: int) -> int:
    """Sample size bounded so that the state stays near 64 MB per
    aggregate."""
    return max(256, min(DEFAULT_K, (1 << 22) // max(capacity, 1)))


def select_bottom_k(values: torch.Tensor, prio: torch.Tensor,
                    slot: torch.Tensor, mask: torch.Tensor,
                    capacity: int, k: int):
    """Each group's k entries of smallest priority: one stable sort by
    (group, priority), each run's first k kept.  Returns (values
    [capacity, k], priorities [capacity, k], counts [capacity])."""
    n = values.shape[0]
    dev = values.device
    live = mask & (slot >= 0)
    gkey = torch.where(live, slot.to(torch.int32), capacity)
    pr = torch.where(live, prio.to(torch.int64), P_EMPTY)
    perm = argsort_multi([(gkey, False), (pr, False)])
    gk, ps, vs = gkey[perm], pr[perm], values[perm]
    valid = gk < capacity
    newrun = valid & torch.cat([torch.ones((min(n, 1),), dtype=torch.bool,
                                           device=dev), gk[1:] != gk[:-1]])
    lo, hi = run_bounds(gk, newrun, valid, capacity)
    pos = torch.arange(n, dtype=torch.int32, device=dev) \
        - lo[gk.to(torch.int64).clamp(max=capacity - 1)]
    keep = valid & (pos < k)
    g = torch.where(keep, gk, capacity).to(torch.int64)
    p = pos.clamp(0, k - 1).to(torch.int64)
    vals_m = torch.zeros((capacity + 1, k), dtype=values.dtype, device=dev)
    prio_m = torch.full((capacity + 1, k), P_EMPTY, dtype=torch.int64,
                        device=dev)
    vals_m[g, p] = vs
    prio_m[g, p] = ps
    vals_m[capacity] = 0
    prio_m[capacity] = P_EMPTY
    return vals_m[:capacity], prio_m[:capacity], (hi - lo).to(torch.int64)


def group_state(values: torch.Tensor, slot: torch.Tensor,
                mask: torch.Tensor, capacity: int, k: int):
    """PARTIAL step: fresh priorities from (value bits, row index)."""
    n = values.shape[0]
    bits = (values.to(torch.float64).contiguous().view(torch.int64)
            if values.is_floating_point() else values.to(torch.int64))
    prio = hash_keys([bits, torch.arange(n, dtype=torch.int64,
                                         device=values.device)])
    return select_bottom_k(values, prio, slot, mask, capacity, k)


def merge_states(vals: torch.Tensor, prio: torch.Tensor, cnt: torch.Tensor,
                 slot: torch.Tensor, mask: torch.Tensor, capacity: int):
    """FINAL step: rows carry [k]-entry partial states; their entries,
    flattened, are selected again per destination group.  Counts sum."""
    from . import agg as A
    r, k = vals.shape
    ev = vals.reshape(r * k)
    ep = prio.reshape(r * k)
    es = torch.repeat_interleave(slot, k)
    em = torch.repeat_interleave(mask, k) & (ep < P_EMPTY)
    mv, mp, _ = select_bottom_k(ev, ep, es, em, capacity, k)
    mc = A.seg_sum(cnt, slot, mask, capacity, torch.int64)
    return mv, mp, mc


def estimate(vals: torch.Tensor, prio: torch.Tensor, cnt: torch.Tensor,
             q: float):
    """Nearest-rank quantile of each group's sample (the exact path's
    rule when the sample covers the whole group).  Returns (estimate,
    whether the group had a row)."""
    k = vals.shape[1]
    big = float("inf") if vals.is_floating_point() \
        else torch.iinfo(vals.dtype).max
    ns = cnt.clamp(max=k)
    sv = torch.sort(torch.where(prio < P_EMPTY, vals,
                                torch.full_like(vals, big)), dim=1).values
    idx = (torch.ceil(q * ns.to(torch.float64)).to(torch.int64)
           - 1).clamp(0, k - 1)
    return torch.gather(sv, 1, idx[:, None])[:, 0], ns > 0
