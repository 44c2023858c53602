"""Sort-based group/join tables over tensors.

Torch port of ``presto_tpu/ops/hashtable.py`` (the reference's
``operator/join/PagesHash.java`` and
``operator/MultiChannelGroupByHash.java``):

- ``insert`` (group ids): stable lexicographic sort of the key columns
  (valid rows first), run-boundary detection, prefix sum → DENSE group ids
  in [0, G).
- ``build`` (join table): the same sort; the sorted order is the CSR layout
  (rows of one key are contiguous, in row order, because the sort is
  stable).
- ``lookup``: lower bound of each probe in the sorted key columns, then an
  exact-equality check.  A single-int64-key table goes to the
  ``sorted_probe`` kernel; composite keys keep the plain lexicographic
  search or the merge.

"Slots" are dense run ids in [0, capacity): ``owner[g]`` is the lowest row
id of group g (EMPTY beyond G), ``slot_of_row[i]`` its group id (-1 for a
masked-out row).
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch

from . import cuda_kernels as CK

EMPTY = 2**31 - 1  # slot-owner sentinel: no row claimed
I64_MAX = 2**63 - 1


class HashTable(NamedTuple):
    """Device join table: dense key-runs over a sorted row permutation."""

    owner: torch.Tensor      # int32 [capacity]: lowest row id per run, EMPTY beyond
    keys: List[torch.Tensor]  # build key columns [N] (original row order)
    slot_of_row: torch.Tensor  # int32 [N]: run id of each masked-in row, -1 else
    counts: torch.Tensor     # int32 [capacity]: rows per run
    offsets: torch.Tensor    # int32 [capacity]: CSR start per run
    rows_csr: torch.Tensor   # int64 [N]: build row ids grouped by run (sorted perm)
    sorted_keys: List[torch.Tensor]  # key columns in sorted order [N]
    run_of_pos: torch.Tensor  # int32 [N]: run id at each sorted position
    n_valid: torch.Tensor    # int64 scalar: count of masked-in build rows

    @property
    def capacity(self) -> int:
        return self.owner.shape[0]


def _first_true(n: int, device) -> torch.Tensor:
    flag = torch.zeros((n,), dtype=torch.bool, device=device)
    flag[:1] = True
    return flag


def _changes(k: torch.Tensor) -> torch.Tensor:
    """bool [N]: position 0, and every position whose value differs from
    the one before it."""
    return torch.cat([_first_true(min(k.shape[0], 1), k.device),
                      k[1:] != k[:-1]])


def _sort_rows(keys: Sequence[torch.Tensor], mask: torch.Tensor):
    """Stable sort: valid rows first, then lexicographic by key columns
    (a chain of stable sorts, least significant key first).  Returns
    (valid_sorted, keys_sorted, perm)."""
    n = keys[0].shape[0]
    perm = torch.arange(n, device=mask.device)
    for k in reversed([(~mask).to(torch.int8), *keys]):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return mask[perm], [k[perm] for k in keys], perm


def _run_starts(keys_sorted: Sequence[torch.Tensor], mask_sorted):
    """bool [N]: position starts a new (valid) key run."""
    diff = _first_true(mask_sorted.shape[0], mask_sorted.device)
    for k in keys_sorted:
        diff = diff | _changes(k)
    return mask_sorted & diff


def run_bounds(gid_sorted: torch.Tensor, newrun: torch.Tensor,
               valid_sorted: torch.Tensor, capacity: int):
    """(starts, ends) int32 [capacity] of each dense-id run in a sorted id
    tensor; zero-length beyond the last id.  Scatter at run boundaries;
    every other position writes the spare slot ``capacity``, which is cut
    off."""
    n = gid_sorted.shape[0]
    dev = gid_sorted.device
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    is_end = valid_sorted & torch.cat(
        [newrun[1:] | ~valid_sorted[1:],
         torch.ones((min(n, 1),), dtype=torch.bool, device=dev)])
    gid_cl = gid_sorted.to(torch.int64).clamp(max=capacity)
    s_idx = torch.where(newrun, gid_cl, capacity)
    e_idx = torch.where(is_end, gid_cl, capacity)
    starts = torch.zeros((capacity + 1,), dtype=torch.int32, device=dev)
    ends = torch.zeros((capacity + 1,), dtype=torch.int32, device=dev)
    starts.scatter_(0, s_idx, pos)
    ends.scatter_(0, e_idx, pos + 1)
    return starts[:capacity], ends[:capacity]


def _dense_ids(keys, mask, capacity):
    """Shared front half of insert/build: sort, runs, dense ids."""
    n = keys[0].shape[0]
    sm, ks, perm = _sort_rows(keys, mask)
    newrun = _run_starts(ks, sm)
    gid_sorted = torch.cumsum(newrun.to(torch.int32), 0,
                              dtype=torch.int32) - 1
    total = newrun.to(torch.int64).sum()
    slot_of_row = torch.empty((n,), dtype=torch.int32, device=mask.device)
    slot_of_row.scatter_(0, perm, torch.where(sm, gid_sorted, -1))
    return sm, ks, perm, newrun, gid_sorted, total, slot_of_row


def insert(keys: Sequence[torch.Tensor], mask: torch.Tensor, capacity: int):
    """Assign one dense id per distinct key (sort → runs → prefix sum).

    Returns (owner[capacity], slot_of_row[N], overflow): ``owner[g]`` is
    the lowest row id holding group ``g``'s key (EMPTY if unused);
    ``slot_of_row[i]`` is row i's group id (-1 for masked-out rows);
    ``overflow`` (a bool tensor) is set when more than ``capacity``
    distinct keys exist, and the caller retries with a larger capacity.
    """
    dev = mask.device
    n = keys[0].shape[0]
    if n == 0:
        return (torch.full((capacity,), EMPTY, dtype=torch.int32, device=dev),
                torch.zeros((0,), dtype=torch.int32, device=dev),
                torch.tensor(False, device=dev))
    sm, _, perm, newrun, gid_sorted, total, slot_of_row = _dense_ids(
        keys, mask, capacity)
    starts, _ = run_bounds(gid_sorted, newrun, sm, capacity)
    owner = torch.where(torch.arange(capacity, device=dev) < total,
                        perm[starts.to(torch.int64)].to(torch.int32), EMPTY)
    return owner, slot_of_row, total > capacity


def _lex_search(sorted_keys: Sequence[torch.Tensor],
                probe_keys: Sequence[torch.Tensor],
                n_valid) -> torch.Tensor:
    """First sorted position in [0, n_valid) whose key tuple >= probe
    (vectorised lexicographic binary search; log2(N) gather rounds)."""
    n = sorted_keys[0].shape[0]
    p = probe_keys[0].shape[0]
    dev = probe_keys[0].device
    lo = torch.zeros((p,), dtype=torch.int64, device=dev)
    hi = torch.as_tensor(n_valid, device=dev).to(torch.int64).expand(p).clone()
    for _ in range(max(n.bit_length(), 1)):
        mid = (lo + hi) >> 1
        midc = mid.clamp(max=n - 1)
        lt = torch.zeros((p,), dtype=torch.bool, device=dev)
        eq = torch.ones((p,), dtype=torch.bool, device=dev)
        for sk, pk in zip(sorted_keys, probe_keys):
            sv = sk[midc]
            pv = pk.to(sv.dtype)
            lt = lt | (eq & (sv < pv))
            eq = eq & (sv == pv)
        go = lo < hi
        lo = torch.where(go & lt, mid + 1, lo)
        hi = torch.where(go & ~lt, mid, hi)
    return lo


def _merged_lower_bound(sorted_cols: Sequence[torch.Tensor],
                        probe_cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """Lower-bound positions of probes in a sorted table via ONE stable
    sort of the concatenation (probe rows first, so ties resolve to the
    left).  For each probe at merged position p, its position in the
    table is p minus the number of probes at or before p."""
    nb = probe_cols[0].shape[0]
    cols = [torch.cat([p.to(s.dtype), s]) for p, s in
            zip(probe_cols, sorted_cols)]
    n = cols[0].shape[0]
    dev = cols[0].device
    perm = torch.arange(n, device=dev)
    for c in reversed(cols):
        perm = perm[torch.sort(c[perm], stable=True).indices]
    cnt_b = torch.cumsum((perm < nb).to(torch.int64), 0)
    inv = torch.empty((n,), dtype=torch.int64, device=dev)
    inv.scatter_(0, perm, torch.arange(n, device=dev))
    p = inv[:nb]
    return p - cnt_b[p] + 1


def lookup(table: HashTable, probe_keys: Sequence[torch.Tensor],
           probe_mask: torch.Tensor):
    """Find each probe key's run id in a built table (sorted lower bound +
    exact-equality verification).  Returns int32 [P], -1 = absent."""
    n = table.sorted_keys[0].shape[0]
    nb = probe_keys[0].shape[0]
    dev = probe_mask.device
    if n == 0:
        return torch.full((nb,), -1, dtype=torch.int32, device=dev)
    probes = [k.to(torch.int64) for k in probe_keys]
    if len(probes) == 1 and len(table.sorted_keys) == 1:
        # single int64 key: the sorted_probe kernel
        pos = CK.sorted_probe(table.sorted_keys[0].contiguous(),
                              probes[0].contiguous(),
                              table.n_valid).to(torch.int64)
    elif nb * 32 < n:
        # few probes, big table: log(n) gather rounds beat a merge sort
        pos = _lex_search(table.sorted_keys, probes, table.n_valid)
    else:
        # the merge is exact only over a fully sorted column: build() keeps
        # invalid tail keys at +MAX, so [0, n) is sorted
        pos = _merged_lower_bound(table.sorted_keys, probes)
    posc = pos.clamp(max=n - 1)
    eq = pos < table.n_valid
    for sk, pk in zip(table.sorted_keys, probes):
        eq = eq & (sk[posc] == pk)
    slot = torch.where(probe_mask & eq, table.run_of_pos[posc], -1)
    return slot.to(torch.int32)


def build(keys: Sequence[torch.Tensor], mask: torch.Tensor,
          capacity: int) -> HashTable:
    """Build a join table: one stable sort gives runs AND the CSR layout
    (replaces ``PagesHash`` + ``ArrayPositionLinks``)."""
    dev = mask.device
    keys64 = [k.to(torch.int64) for k in keys]
    sm, raw_sorted, perm, newrun, gid_sorted, total, slot_of_row = \
        _dense_ids(keys64, mask, capacity)
    # invalid tail keys → +MAX sentinel so the full column is globally
    # sorted (probe lower bounds that land in the tail map to run -1)
    sorted_keys = [torch.where(sm, k, I64_MAX) for k in raw_sorted]
    starts, ends = run_bounds(gid_sorted, newrun, sm, capacity)
    in_range = torch.arange(capacity, device=dev) < total
    owner = torch.where(in_range, perm[starts.to(torch.int64)].to(torch.int32),
                        EMPTY)
    counts = torch.where(in_range, ends - starts, 0)
    run_of_pos = torch.where(sm, gid_sorted, -1).to(torch.int32)
    return HashTable(owner, keys64, slot_of_row, counts, starts, perm,
                     sorted_keys, run_of_pos, sm.to(torch.int64).sum())


def probe_unique(table: HashTable, probe_keys: Sequence[torch.Tensor],
                 probe_mask: torch.Tensor):
    """Probe assuming build keys are unique (PK side of a FK join).
    Returns build_row[P] int32 with -1 = no match."""
    slot = lookup(table, probe_keys, probe_mask)
    hit = table.owner[slot.clamp_min(0).to(torch.int64)]
    return torch.where(slot >= 0, hit, -1)


def probe_counts(table: HashTable, probe_keys: Sequence[torch.Tensor],
                 probe_mask: torch.Tensor):
    """Per-probe-row match count (for two-pass expanding joins)."""
    slot = lookup(table, probe_keys, probe_mask)
    cnt = torch.where(slot >= 0,
                      table.counts[slot.clamp_min(0).to(torch.int64)], 0)
    return slot, cnt.to(torch.int32)


def next_pow2(n: int) -> int:
    c = 1
    while c < n:
        c <<= 1
    return c


def capacity_for(n_keys: int, load: float = 0.5) -> int:
    """Power-of-2 capacity bound on distinct keys (kept ≥ 2× the estimate
    so under-estimates rarely trip the overflow retry)."""
    return max(8, next_pow2(int(n_keys / load) + 1))
