"""Window-function kernels: rank family, offsets, framed aggregates.

Torch port of ``presto_tpu/ops/window.py``.  The reference's
``operator/WindowOperator.java`` accumulates rows into a PagesIndex, sorts
per partition, then frames row by row (``operator/window/``).  Here the
whole table is ONE sort by (partition, order) keys and every window
function is a vectorised prefix computation over the sorted order, which
the caller scatters back to input order:

- partition boundaries  → flag vector + running "segment start" index
- row_number            → position − partition start + 1
- rank                  → peer-run start − partition start + 1
- dense_rank            → prefix count of peer-run boundaries
- lead/lag              → shifted gather with boundary nulls
- running/total sum,cnt → prefix sums minus partition-start prefix
- running min/max       → one cummax over (partition ordinal, value rank)

Every function takes and returns tensors of sorted positions; none reads
a value on the host, so a window adds no device→host sync.
"""

from __future__ import annotations

import math
from typing import List

import torch

from . import agg as A


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=like.device)


def _changes(k: torch.Tensor) -> torch.Tensor:
    """True at 0 and wherever ``k`` differs from the position before."""
    return torch.cat([torch.ones((1,), dtype=torch.bool, device=k.device),
                      k[1:] != k[:-1]])


def _rev_cummin(x: torch.Tensor) -> torch.Tensor:
    """Suffix minimum: min of ``x[i:]`` at each ``i``."""
    return torch.flip(torch.cummin(torch.flip(x, [0]), 0).values, [0])


def make_boundaries(sorted_keys: List[torch.Tensor], n_partition_keys: int,
                    mask: torch.Tensor):
    """(part_start[i], peer_start[i]) indices for each sorted position.

    A row starts a new partition when any partition key differs from the
    previous row; it starts a new peer run when any (partition or order)
    key differs.  A row also starts a partition where ``mask`` changes:
    masked-out rows sort last but keep their keys, and must not join or
    extend the last real partition (the JAX function ignores ``mask``)."""
    n = mask.shape[0]
    idx = _arange(n, mask)
    part_change = _changes(mask)
    peer_change = part_change.clone()
    for j, k in enumerate(sorted_keys):
        diff = _changes(k)
        if j < n_partition_keys:
            part_change = part_change | diff
        peer_change = peer_change | diff
    part_start = torch.cummax(torch.where(part_change, idx, -1), 0).values
    peer_start = torch.cummax(torch.where(peer_change, idx, -1), 0).values
    return part_start, peer_start


def row_number(part_start: torch.Tensor) -> torch.Tensor:
    return _arange(part_start.shape[0], part_start) - part_start + 1


def rank(part_start: torch.Tensor, peer_start: torch.Tensor) -> torch.Tensor:
    return peer_start - part_start + 1


def dense_rank(part_start: torch.Tensor,
               peer_start: torch.Tensor) -> torch.Tensor:
    idx = _arange(part_start.shape[0], part_start)
    new_peer = (peer_start == idx).to(torch.int64)
    cs = torch.cumsum(new_peer, 0)
    # dense rank = peers seen in this partition up to here
    ps = part_start.clamp_min(0)
    return cs - (cs[ps] - new_peer[ps])


def peer_ends(peer_start: torch.Tensor) -> torch.Tensor:
    """For each sorted position, the last index of its peer run."""
    n = peer_start.shape[0]
    idx = _arange(n, peer_start)
    is_last = torch.cat([peer_start[1:] != peer_start[:-1],
                         torch.ones((1,), dtype=torch.bool,
                                    device=peer_start.device)])
    return _rev_cummin(torch.where(is_last, idx, n - 1))


def partition_counts(part_start: torch.Tensor) -> torch.Tensor:
    """Rows in each position's partition (part_end - part_start + 1)."""
    return peer_ends(part_start) - part_start + 1


def percent_rank(part_start, peer_start) -> torch.Tensor:
    cnt = partition_counts(part_start)
    rk = rank(part_start, peer_start)
    return torch.where(cnt > 1, (rk - 1).to(torch.float64)
                       / (cnt - 1).clamp_min(1), 0.0)


def cume_dist(part_start, peer_start) -> torch.Tensor:
    cnt = partition_counts(part_start)
    pe = peer_ends(peer_start)
    return (pe - part_start + 1).to(torch.float64) / cnt.clamp_min(1)


def ntile(part_start, n: int) -> torch.Tensor:
    """Equal-height buckets; first (count mod n) buckets one row larger."""
    cnt = partition_counts(part_start)
    rn0 = row_number(part_start) - 1
    nn = cnt.clamp_min(1).clamp_max(n)
    small = cnt // nn
    big = cnt % nn
    boundary = big * (small + 1)
    return torch.where(
        rn0 < boundary,
        rn0 // (small + 1).clamp_min(1) + 1,
        big + (rn0 - boundary) // small.clamp_min(1) + 1)


def shift_in_partition(values: torch.Tensor, part_start: torch.Tensor,
                       offset: int):
    """lead(+k)/lag(-k): value at position i+offset if same partition,
    else invalid.  Returns (values, valid)."""
    n = values.shape[0]
    src = _arange(n, part_start) + offset
    inb = (src >= 0) & (src < n)
    src_c = src.clamp(0, max(n - 1, 0))
    same = part_start[src_c] == part_start
    return values[src_c], inb & same


def _acc(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked values in their accumulator type (float64 or int64)."""
    acc = torch.float64 if values.is_floating_point() else torch.int64
    return torch.where(mask, values, 0).to(acc)


def running_sum(values: torch.Tensor, part_start: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """sum over rows from partition start to current row (RANGE/ROWS
    UNBOUNDED PRECEDING → CURRENT ROW; the caller gathers at the peer-run
    end for the default frame)."""
    cs = torch.cumsum(_acc(values, mask), 0)
    before = torch.where(part_start > 0, cs[(part_start - 1).clamp_min(0)], 0)
    return cs - before


def frame_bounds(part_start: torch.Tensor, frame):
    """Clamped [lo, hi] sorted-position bounds of a ROWS frame per row."""
    idx = _arange(part_start.shape[0], part_start)
    part_end = peer_ends(part_start)

    def edge(spec):
        which, k = spec
        if which == "unbounded_preceding":
            return part_start
        if which == "unbounded_following":
            return part_end
        if which == "current":
            return idx
        if which == "preceding":
            return idx - k
        if which == "following":
            return idx + k
        raise ValueError(which)

    lo = torch.maximum(edge(frame[1]), part_start)
    hi = torch.minimum(edge(frame[2]), part_end)
    return lo, hi


def _first_geq(sorted_vals: torch.Tensor, lo0: torch.Tensor,
               hi0: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-row vectorised binary search: first index j in [lo0, hi0] with
    sorted_vals[j] >= target (hi0+1 if none).  sorted_vals must be
    non-decreasing inside each [lo0, hi0] range."""
    n = sorted_vals.shape[0]
    lo = lo0
    hi = hi0 + 1
    steps = max(1, math.ceil(math.log2(max(n, 2)))) + 1
    for _ in range(steps):
        mid = (lo + hi) // 2
        mid_c = mid.clamp(0, max(n - 1, 0))
        geq = (sorted_vals[mid_c] >= target) & (mid < hi)
        hi = torch.where(geq, mid, hi)
        lo = torch.where(geq | (lo >= hi), lo, torch.minimum(mid + 1, hi))
    return lo


def range_frame_bounds(part_start: torch.Tensor, peer_start: torch.Tensor,
                       order_vals: torch.Tensor, frame, descending: bool):
    """[lo, hi] sorted-position bounds of a RANGE (value-offset) frame.

    The reference's RANGE framing (``operator/window/FrameInfo.java`` +
    PagesWindowIndex value comparisons) as per-row binary searches over
    the partition's sorted order values: k PRECEDING/FOLLOWING are value
    offsets from the current row's order key, CURRENT ROW spans the peer
    run.  A descending order key is negated so one ascending search serves
    both directions."""
    part_end = peer_ends(part_start)
    v = (-order_vals if descending else order_vals).to(torch.int64)
    pe = peer_ends(peer_start)

    def edge(spec, is_start):
        which, k = spec
        if which == "unbounded_preceding":
            return part_start
        if which == "unbounded_following":
            return part_end
        if which == "current":
            return peer_start if is_start else pe
        target = v + (-k if which == "preceding" else k)
        if is_start:  # first position with value >= target
            return _first_geq(v, part_start, part_end, target)
        # last position with value <= target = (first > target) - 1
        return _first_geq(v, part_start, part_end, target + 1) - 1

    lo = torch.maximum(edge(frame[1], True), part_start)
    hi = torch.minimum(edge(frame[2], False), part_end)
    return lo, hi


def groups_frame_bounds(part_start: torch.Tensor, peer_start: torch.Tensor,
                        frame):
    """[lo, hi] sorted-position bounds of a GROUPS frame.

    GROUPS offsets count PEER GROUPS (reference ``GroupsFraming``): ``k
    PRECEDING`` starts at the first row of the k-th group before the
    current row's group; CURRENT ROW spans the whole peer group.  Frames
    whose start group lies past the partition's last group (or end before
    its first) come out empty (lo > hi)."""
    n = part_start.shape[0]
    idx = _arange(n, part_start)
    part_end = peer_ends(part_start)
    pe = peer_ends(peer_start)
    new_peer = peer_start == idx
    gid = torch.cumsum(new_peer.to(torch.int64), 0) - 1   # global group id
    # first / last position of each peer group (slot n takes the rest)
    tgt_idx = torch.where(new_peer, gid, n)
    gsp = torch.zeros((n + 1,), dtype=torch.int64, device=idx.device)
    gep = torch.zeros((n + 1,), dtype=torch.int64, device=idx.device)
    gsp[tgt_idx] = idx
    gep[tgt_idx] = pe
    first_gid = gid[part_start.clamp_min(0)]
    last_gid = gid[part_end]

    def edge(spec, is_start):
        which, k = spec
        if which == "unbounded_preceding":
            return part_start
        if which == "unbounded_following":
            return part_end
        if which == "current":
            return peer_start if is_start else pe
        tgt = gid + (-k if which == "preceding" else k)
        g = torch.minimum(torch.maximum(tgt, first_gid), last_gid)
        if is_start:
            return torch.where(tgt > last_gid, part_end + 1, gsp[g])
        return torch.where(tgt < first_gid, part_start - 1, gep[g])

    lo = torch.maximum(edge(frame[1], True), part_start)
    hi = torch.minimum(edge(frame[2], False), part_end)
    return lo, hi


def _nonnull_positions(valid: torch.Tensor):
    """(count of non-null rows at or before i, table of the r-th non-null
    row's position; slot n is a spare)."""
    n = valid.shape[0]
    idx = _arange(n, valid)
    cnt = torch.cumsum(valid.to(torch.int64), 0)
    nzpos = torch.zeros((n + 1,), dtype=torch.int64, device=valid.device)
    nzpos[torch.where(valid, cnt - 1, n)] = idx
    return cnt, nzpos


def kth_nonnull_shift(values: torch.Tensor, valid: torch.Tensor,
                      part_start: torch.Tensor, offset: int):
    """lead/lag IGNORE NULLS: the |offset|-th NON-NULL value after
    (offset>0) / before (offset<0) each sorted position, same partition.
    Returns (values, found)."""
    n = values.shape[0]
    cnt, nzpos = _nonnull_positions(valid)
    before_part = torch.where(part_start > 0,
                              cnt[(part_start - 1).clamp_min(0)], 0)
    if offset < 0:                                    # lag: k-th before
        tgt = cnt - valid.to(torch.int64) + offset
        found = tgt >= before_part
    else:                                             # lead: k-th after
        tgt = cnt + offset - 1
        found = tgt <= cnt[peer_ends(part_start)] - 1
    pos = nzpos[tgt.clamp(0, n)]
    return values[pos.clamp(0, max(n - 1, 0))], found


def nth_nonnull(valid: torch.Tensor, part_start: torch.Tensor,
                frame_end: torch.Tensor, k: int):
    """nth_value IGNORE NULLS: position of the k-th NON-NULL row counted
    from the partition start, found when it lies at or before
    ``frame_end`` (the JAX package computes this inline in
    ``_window_traced``).  Returns (pos, found)."""
    n = valid.shape[0]
    cnt, nzpos = _nonnull_positions(valid)
    before_part = torch.where(part_start > 0,
                              cnt[(part_start - 1).clamp_min(0)], 0)
    tgt = before_part + k - 1
    pos = nzpos[tgt.clamp(0, n)]
    return pos, (tgt < cnt[frame_end]) & (pos <= frame_end)


def nonnull_frame_edge(valid: torch.Tensor, lo: torch.Tensor,
                       hi: torch.Tensor, first: bool):
    """Position of the first (or last) NON-NULL row inside [lo, hi]
    (first_value/last_value IGNORE NULLS).  Returns (pos, found)."""
    n = valid.shape[0]
    idx = _arange(n, valid)
    if first:
        nxt = _rev_cummin(torch.where(valid, idx, n))  # next non-null ≥ i
        pos = nxt[lo.clamp(0, max(n - 1, 0))]
        return pos, (pos <= hi) & (lo <= hi)
    prv = torch.cummax(torch.where(valid, idx, -1), 0).values
    pos = prv[hi.clamp(0, max(n - 1, 0))]
    return pos, (pos >= lo) & (lo <= hi)


def framed_sum(values: torch.Tensor, mask: torch.Tensor,
               lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """sum over sorted positions [lo, hi] via prefix sums (exact: clamped
    bounds never cross partition edges)."""
    cs = torch.cumsum(_acc(values, mask), 0)
    hi_c = hi.clamp(0, max(values.shape[0] - 1, 0))
    upper = torch.where(hi >= lo, cs[hi_c], 0)
    lower = torch.where((hi >= lo) & (lo > 0), cs[(lo - 1).clamp_min(0)], 0)
    return upper - lower


def segmented_cummin(values: torch.Tensor, part_start: torch.Tensor,
                     maximum: bool = False) -> torch.Tensor:
    """Running min/max from each partition start, in one pass over all
    partitions (the JAX function is an associative scan).

    Each value becomes its position ``r`` in one stable sort of all the
    values; position ``i`` of partition ordinal ``p`` gets the key
    ``p*n + r`` (for a minimum ``p*n + (n-1-r)``).  Partition ordinals
    rise along the rows, so one plain cummax of the keys never carries a
    value across a partition start, and ``key - p*n`` gives back the
    running extreme's place in the sort.  No shape depends on the data."""
    n = values.shape[0]
    if n == 0:
        return values
    idx = _arange(n, values)
    part = torch.cumsum((part_start == idx).to(torch.int64), 0) - 1
    svals, order = torch.sort(values, stable=True)
    r = torch.empty_like(idx)
    r[order] = idx
    if not maximum:
        r = n - 1 - r
    best = torch.cummax(part * n + r, 0).values - part * n
    return svals[best if maximum else n - 1 - best]


def partition_total(values: torch.Tensor, part_start: torch.Tensor,
                    mask: torch.Tensor, func: str = "sum") -> torch.Tensor:
    """Full-partition aggregate broadcast to each row (a segment reduce
    keyed on part_start, which is unique per partition)."""
    n = values.shape[0]
    seg = part_start
    if func == "sum":
        acc = torch.float64 if values.is_floating_point() else torch.int64
        tot = A.seg_sum(values, seg, mask, n, acc)
    elif func == "min":
        tot = A.seg_min(values, seg, mask, n)
    elif func == "max":
        tot = A.seg_max(values, seg, mask, n)
    elif func == "count":
        tot = A.seg_count(seg, mask, n)
    else:
        raise NotImplementedError(func)
    return tot[seg]
