"""Slice-at-a-time streaming aggregation: a table bigger than the card.

Torch port of ``presto_tpu/exec/streaming.py``, the grouped-lifespan shape
of the reference (``execution/SqlTaskExecution.java:225``
SchedulingLifespanManager): the scan is read in ranges of split units
(``DataSource.scan_slice``, never cached), each slice goes through the
filters and projections into PARTIAL aggregation states
(``parallel/distributed.py``), and only the groups' states stay on the
device, merged eagerly every 8 slices.  The device holds O(slice + groups),
never the table.

A streamable plan is an aggregation over Filter/Project over one scan of
a connector table, every aggregate with a mergeable state (not
approx_percentile, min_by/max_by or a nested-value aggregate) and none
DISTINCT, grouped or global (one group, present over no rows); a HAVING filter, projections, a sort and a limit above it run
on the merged result.  Any other plan (a join below the aggregation, a
memory table) gets None and the caller runs it whole (``run_sql``): a
rule on the plan's shape, not a fallback.  A filter on the table's
monotone key (``MONOTONE_KEYS``) prunes the units read
(``pruned_unit_range``, the connector-pushdown role of
``ConnectorMetadata.applyFilter``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..data.column import DICT
from ..ops import hashtable as HT
from ..parallel import distributed as D
from ..sql import ir
from ..sql.planner import domains as DOM
from . import physical as PH
from .columns import Chunk, DCol, Dictionary
from .expreval import refuse_row_numbering
from .plan import (PhysFilter, PhysHashAggregate, PhysLimit, PhysMaterial,
                   PhysOp, PhysProject, PhysScan, PhysSort)

EAGER_MERGE = 8  # partial chunks kept before they merge into one


def find_streamable_agg(plan: PhysOp
                        ) -> Optional[Tuple[List[PhysOp], PhysHashAggregate,
                                            PhysScan]]:
    """(the nodes above the aggregation, the aggregation, its scan) when
    the plan is [Sort|Limit|Project|Filter]* → Agg → [Filter|Project]* →
    Scan with mergeable aggregates, else None."""
    above: List[PhysOp] = []
    node = plan
    while isinstance(node, (PhysSort, PhysLimit, PhysProject, PhysFilter)):
        above.append(node)
        node = node.children()[0]
    if not isinstance(node, PhysHashAggregate):
        return None
    agg = node
    if any(s.distinct or s.func not in D.STATE_FUNCS for s in agg.aggs):
        return None
    below = agg.child
    while isinstance(below, (PhysFilter, PhysProject)):
        below = below.children()[0]
    if not isinstance(below, PhysScan):
        return None
    return above, agg, below


# tables whose named key grows with the generator's unit order: the
# split-pruning targets (``TpchMetadata``'s orderkey/custkey orderings)
MONOTONE_KEYS = {"orders": "o_orderkey", "lineitem": "l_orderkey",
                 "customer": "c_custkey", "part": "p_partkey",
                 "supplier": "s_suppkey"}


def pruned_unit_range(agg_child: PhysOp, scan: PhysScan,
                      total_units: int) -> Tuple[int, int]:
    """(first unit, units) covering the domain the scan's filters prove
    for the table's monotone key (TupleDomain-driven split pruning,
    reference ``DomainTranslator`` + ``ConnectorMetadata.applyFilter``)."""
    keycol = MONOTONE_KEYS.get(scan.table)
    if keycol is None:
        return 0, total_units
    name = scan.alias_prefix + keycol
    dom = DOM.ALL
    node = agg_child
    while isinstance(node, (PhysFilter, PhysProject)):
        if isinstance(node, PhysFilter):
            d = DOM.extract(node.predicate).get(name)
            if d is not None:
                dom = dom.intersect(d)
        elif not any(n == name and isinstance(e, ir.ColumnRef)
                     and e.name == name for n, e in node.projections):
            # above this projection the key is not the column itself: the
            # constraints gathered so far do not hold for it
            dom = DOM.ALL
        node = node.children()[0]
    if dom.is_all:
        return 0, total_units
    if dom.none:
        return 0, 0
    if scan.table in ("orders", "lineitem"):
        # invert dbgen's sparse orderkey (8 keys used of each 32)
        def inv(k):
            k = int(k)
            return (k >> 5) * 8 + min(k & 31, 7)
        lo = 0 if dom.lo is None else max(inv(dom.lo) - 1, 0)
        hi = total_units if dom.hi is None \
            else min(inv(dom.hi) + 1, total_units)
    else:  # dense 1-based keys: key = unit + 1
        lo = 0 if dom.lo is None else max(int(dom.lo) - 1, 0)
        hi = total_units if dom.hi is None else min(int(dom.hi), total_units)
    return lo, max(hi - lo, 0)


def _evaluated(agg: PhysHashAggregate) -> List[ir.Expr]:
    """The expressions evaluated over each slice: the aggregation's and
    those of the Filter/Project chain below it."""
    out = [e for _, e in agg.groups] + [x for s in agg.aggs
                                        for x in (s.arg, s.arg2)
                                        if x is not None]
    node = agg.child
    while isinstance(node, (PhysFilter, PhysProject)):
        out += ([node.predicate] if isinstance(node, PhysFilter)
                else [e for _, e in node.projections])
        node = node.child
    return out


def _substitute_scan(node: PhysOp, chunk: Chunk) -> PhysOp:
    """A copy of the Filter/Project chain ``node`` over ``chunk``."""
    if isinstance(node, PhysScan):
        return PhysMaterial(chunk)
    return dataclasses.replace(node, child=_substitute_scan(node.child,
                                                            chunk))


def _slices(ds, scan: PhysScan, lo: int, end: int, slice_rows: int):
    """The scan's columns, ``slice_rows`` split units at a time."""
    for first in range(lo, end, slice_rows):
        sl = ds.scan_slice(scan.table, sorted(set(scan.columns)), first,
                           min(slice_rows, end - first))
        yield Chunk({scan.alias_prefix + k: v for k, v in sl.cols.items()},
                    sl.mask)


def _finish(above: List[PhysOp], out: Chunk, ctx: PH.ExecContext):
    from .runner import materialize
    for node in reversed(above):
        out = PH.execute(dataclasses.replace(node, child=PhysMaterial(out)),
                         ctx)
    return materialize(out, ctx)


def run_streaming_agg(ds, plan: PhysOp, ctx: PH.ExecContext,
                      slice_rows: int = 1 << 22):
    """Run an eligible aggregation plan slice by slice and return the host
    Table; None when the plan is not streamable."""
    found = find_streamable_agg(plan)
    if found is None:
        return None
    above, agg, scan = found
    hit = ds.catalog.resolve(scan.table)
    if hit is None or hit[0].name == "memory":
        return None  # a memory table is host data already: run it whole
    total = ds.split_units(scan.table)
    if total == 0:
        return None
    lo, cnt = (pruned_unit_range(agg.child, scan, total)
               if hit[0].name == "tpch" else (0, total))
    if cnt == 0:
        # a provably empty domain: one unit still goes through the real
        # filter, so that empty aggregates come out as they should
        lo, cnt = 0, min(total, 1)
    refuse_row_numbering(_evaluated(agg), "a streamed scan")
    slices = _slices(ds, scan, lo, lo + cnt, max(int(slice_rows), 1))
    partials: List[Chunk] = []
    specs = None
    for sl in slices:
        pre = PH.execute(_substitute_scan(agg.child, sl), ctx)
        part, specs = _partial(agg, pre, ctx)
        partials.append(part)
        if len(partials) >= EAGER_MERGE:
            # merged eagerly: the states stay bounded by the groups
            partials = [_merge_states_only(agg, _cat(partials), specs, ctx)]
    cat = _cat(partials)
    merged, = _grow(ctx, lambda cap: D.merge_agg_states(agg, cat, specs, cap),
                    _capacity(ctx, cat, agg.ndv_hint))
    return _finish(above, PH._maybe_compact(merged, ctx), ctx)


def _cat(chunks: List[Chunk]) -> Chunk:
    """The slices' partial rows in one chunk; a string column that is
    DICT in every slice stays DICT over the union of their dictionaries,
    so that a min/max state still merges by string."""
    if len(chunks) == 1:
        return chunks[0]
    cols = [dict(ch.cols) for ch in chunks]
    for name in chunks[0].cols:
        parts = [c[name] for c in cols]
        if all(p.kind == DICT for p in parts) and any(
                p.dictionary is not parts[0].dictionary for p in parts):
            for c, p in zip(cols, _one_dictionary(parts)):
                c[name] = p
    return PH.concat_chunks([Chunk(c, ch.mask)
                             for c, ch in zip(cols, chunks)])


def _one_dictionary(parts: List[DCol]) -> List[DCol]:
    """DICT columns recoded over the sorted union of their dictionaries
    (host tables; dictionaries are small)."""
    union = np.unique(np.concatenate([
        np.asarray(p.dictionary.strings, dtype=str) for p in parts]))
    shared = Dictionary(union.astype(object))
    out = []
    for p in parts:
        remap = torch.from_numpy(np.searchsorted(union, np.asarray(
            p.dictionary.strings, dtype=str)).astype(np.int32)).to(
                p.values.device)
        codes = remap[p.values.to(torch.int64)] if remap.numel() else p.values
        out.append(DCol(p.dtype, DICT, codes, validity=p.validity,
                        dictionary=shared))
    return out


def _capacity(ctx, chunk: Chunk, hint: int) -> int:
    """A group capacity for ``chunk``: no more groups than live rows (one
    host read), nor than the planner's estimate."""
    live = PH._sync_int(ctx, chunk.mask.sum())
    return max(64, HT.capacity_for(min(hint, live + 1)))


def _grow(ctx, step, capacity: int) -> tuple:
    """``step(capacity)`` → (results..., overflow), the capacity doubled
    until the group table does not overflow (each check one host read);
    returns the results."""
    while True:
        *out, overflow = step(capacity)
        if overflow is None or not PH._sync_int(ctx, overflow):
            return tuple(out)
        capacity *= 2


def _live(chunk: Chunk, ctx) -> Chunk:
    """``chunk`` compacted to its live rows (its groups)."""
    return PH._compact(chunk, max(PH._sync_int(ctx, chunk.mask.sum()), 1))


def _partial(agg: PhysHashAggregate, pre: Chunk, ctx):
    """One slice's PARTIAL states, compacted to its live groups, and
    their [(state column, merge function)].  A global aggregation's
    slice has one group, its one row, and no host read."""
    if not agg.groups:
        part, specs, _ = D.partial_agg_states(agg, pre, 1)
        return part, specs
    part, specs = _grow(ctx, lambda cap: D.partial_agg_states(agg, pre, cap),
                        _capacity(ctx, pre, agg.ndv_hint))
    return _live(part, ctx), specs


def _merge_states_only(agg: PhysHashAggregate, partials: Chunk, specs,
                       ctx) -> Chunk:
    """Duplicate groups' states combined, not finalized (the reference's
    INTERMEDIATE step), compacted to the live groups."""
    def step(cap):
        owner, slot, overflow = D.group_partials(agg, partials, cap)
        gvalid = owner != HT.EMPTY
        rep = owner.clamp(max=max(partials.n_rows - 1, 0))
        cols = {name: partials.cols[name].take(rep, valid=gvalid)
                for name, _ in agg.groups}
        for sname, sfunc in specs:
            cols[sname] = D.merge_state(sfunc, partials.cols[sname],
                                        partials, slot, cap, gvalid)
        return Chunk(cols, gvalid), overflow

    out, = _grow(ctx, step, _capacity(ctx, partials, agg.ndv_hint))
    return _live(out, ctx)
