"""Physical operators, executed one at a time on torch tensors.

Torch port of the operator-at-a-time path of ``presto_tpu/exec/physical.py``
(``execute`` → ``_execute_node``; the reference's operator/driver engine,
``operator/Operator.java:21``).  Each operator consumes whole Chunks and
produces one; selection is a row mask, and where an output size depends on
the data (compaction, group capacity, join table size) the host reads one
scalar from the device — each such read is counted in
``ExecContext.host_syncs``.

Operators ↔ reference:
- PhysScan            ← TableScanOperator + TPC-H connector page source
- PhysFilter/Project  ← FilterAndProjectOperator
- PhysHashAggregate   ← HashAggregationOperator
- PhysHashJoin        ← HashBuilderOperator + LookupJoinOperator (unique
                        build side: inner/left/semi/anti)
- PhysSort/Limit      ← OrderByOperator / Limit

Not ported yet (they raise ``NotImplementedError``): expanding, mark and
full joins, windows, MATCH_RECOGNIZE, UNION, UNNEST, GROUPING SETS, scalar
subqueries, DISTINCT and nested-value aggregates, and the
partition-at-a-time memory tiers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..data import types as T
from ..data.column import PLAIN, DICT, BYTES
from ..ops import agg as A
from ..ops import hashtable as HT
from ..ops import int128 as I128
from ..ops import sort as SORT
from .columns import Chunk, DCol
from .expreval import eval_expr, eval_predicate
from .plan import (AggSpec, PhysFilter, PhysHashAggregate, PhysHashJoin,
                   PhysLimit, PhysOp, PhysProject, PhysScan,
                   PhysSort, _agg_output_type)

SEG_DIRECT_CAP = 512  # largest key domain grouped by its composite code
COMPACT_THRESHOLD = 0.25  # compact a chunk when selectivity falls below
MIN_ROWS_FOR_COMPACTION = 1 << 14


@dataclass
class ExecContext:
    datasource: object                      # DataSource
    host_syncs: int = 0                     # device→host scalar reads


def _sync_int(ctx: ExecContext, t: torch.Tensor) -> int:
    """Read one device scalar on the host (waits for the device)."""
    ctx.host_syncs += 1
    return int(t.item())


def execute(plan: PhysOp, ctx: ExecContext) -> Chunk:
    if isinstance(plan, PhysScan):
        return ctx.datasource.scan(plan.table, plan.columns, plan.alias_prefix)
    if isinstance(plan, PhysFilter):
        child = execute(plan.child, ctx)
        mask = eval_predicate(plan.predicate, child) & child.mask
        return _maybe_compact(Chunk(child.cols, mask), ctx)
    if isinstance(plan, PhysProject):
        child = execute(plan.child, ctx)
        cols = {name: eval_expr(e, child) for name, e in plan.projections}
        return Chunk(cols, child.mask)
    if isinstance(plan, PhysHashAggregate):
        return _exec_agg(plan, ctx)
    if isinstance(plan, PhysHashJoin):
        return _exec_join(plan, ctx)
    if isinstance(plan, PhysSort):
        out = _sort(execute(plan.child, ctx), plan.keys)
        return out if plan.limit is None else _exec_limit(out, plan.limit)
    if isinstance(plan, PhysLimit):
        return _exec_limit(execute(plan.child, ctx), plan.n)
    raise NotImplementedError(f"{type(plan).__name__} on the torch path")


# ---------------------------------------------------------------- row shape

def _compact(chunk: Chunk, rows: int) -> Chunk:
    """Gather masked-in rows to the front (in order) and keep ``rows``."""
    perm = torch.sort((~chunk.mask).to(torch.int8), stable=True).indices[:rows]
    cols = {n: c.take(perm) for n, c in chunk.cols.items()}
    return Chunk(cols, chunk.mask[perm])


def _maybe_compact(chunk: Chunk, ctx: ExecContext) -> Chunk:
    n = chunk.n_rows
    if n < MIN_ROWS_FOR_COMPACTION:
        return chunk
    count = _sync_int(ctx, chunk.mask.sum())
    if count > n * COMPACT_THRESHOLD:
        return chunk
    return _compact(chunk, max(count, 1))


def _exec_limit(child: Chunk, n: int) -> Chunk:
    # valid only over mask-compacted rows: limit follows a sort, which
    # moves the valid rows to the front
    if n >= child.n_rows:
        return child
    cols = {name: DCol(c.dtype, c.kind, c.values[:n],
                       None if c.lengths is None else c.lengths[:n],
                       None if c.validity is None else c.validity[:n],
                       c.dictionary)
            for name, c in child.cols.items()}
    return Chunk(cols, child.mask[:n])


# ---------------------------------------------------------------- keys

def _col_keys(c: DCol) -> List[torch.Tensor]:
    """One column's key tensors: its int64 values, or both words of a long
    decimal."""
    if c.kind == BYTES:
        raise NotImplementedError("byte-string keys on the torch path")
    if c.values.dim() == 2:
        return [w.contiguous() for w in I128.unpack(c.values)]
    return [c.values.to(torch.int64)]


def _key_arrays(chunk: Chunk, exprs: Sequence) -> List[torch.Tensor]:
    """Key expressions → int64 tensors (join-equality semantics: validity
    does NOT participate — callers' masks handle NULL keys)."""
    return [k for e in exprs for k in _col_keys(eval_expr(e, chunk))]


def _group_key_arrays(chunk: Chunk, exprs: Sequence) -> List[torch.Tensor]:
    """Key tensors with SQL GROUP BY null semantics: a nullable key adds its
    validity bit as a key and zeroes the value where invalid, so all NULLs
    form ONE group distinct from every real value."""
    out: List[torch.Tensor] = []
    for e in exprs:
        c = eval_expr(e, chunk)
        keys = _col_keys(c)
        if c.validity is not None:
            out.append(c.validity.to(torch.int64))
            keys = [torch.where(c.validity, k, 0) for k in keys]
        out.extend(keys)
    return out


def _direct_group_ids(chunk: Chunk, exprs, capacity: int):
    """Perfect-hash group ids for statically small key domains.

    When every group key is a dictionary-coded string or a boolean, the
    group id is the composite code — no sort, no table (the
    ``BigintGroupByHash`` small-domain specialisation).  Returns None when
    any key's domain is unknown or the product exceeds the capacity."""
    cols, sizes = [], []
    for e in exprs:
        c = eval_expr(e, chunk)
        if c.kind == DICT:
            sizes.append(max(len(c.dictionary), 1))
        elif isinstance(c.dtype, T.BooleanType):
            sizes.append(2)
        else:
            return None
        cols.append(c.values.to(torch.int64))
    prod = 1
    for s in sizes:
        prod *= s
    if prod > capacity or prod > SEG_DIRECT_CAP:
        return None
    n = chunk.n_rows
    dev = chunk.mask.device
    gid = torch.zeros((n,), dtype=torch.int64, device=dev)
    for c, s in zip(cols, sizes):
        gid = gid * s + c.clamp(0, s - 1)
    # lowest row id of each composite code (spare slot `prod` takes the
    # masked-out rows)
    first = torch.full((prod + 1,), n, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, torch.where(chunk.mask, gid, prod),
                          torch.arange(n, device=dev), reduce="amin")
    first = first[:prod]
    owner = torch.full((capacity,), HT.EMPTY, dtype=torch.int32, device=dev)
    owner[:prod] = torch.where(first < n, first, HT.EMPTY).to(torch.int32)
    slot_of_row = torch.where(chunk.mask, gid, -1).to(torch.int32)
    return owner, slot_of_row, None


def _insert(chunk: Chunk, exprs, capacity: int):
    direct = _direct_group_ids(chunk, exprs, capacity)
    if direct is not None:
        return direct
    return HT.insert(_group_key_arrays(chunk, exprs), chunk.mask, capacity)


# ---------------------------------------------------------------- sort

def _sort_key_arrays(chunk: Chunk, keys) -> List[Tuple[torch.Tensor, bool]]:
    """Sort-key exprs → (integer tensor, descending) pairs.  NULL keys
    sort after every value (Trino: NULLS LAST ascending, NULLS FIRST
    descending) by replacing them with +max before the complement."""
    karrs: List[Tuple[torch.Tensor, bool]] = []
    for e, desc in keys:
        c = eval_expr(e, chunk)
        if c.kind == DICT:
            # order by string value: host-computed rank of each code
            rank = np.argsort(np.argsort(
                [str(s) for s in c.dictionary.strings], kind="stable"))
            p = torch.from_numpy(rank).to(c.values.device)[
                c.values.to(torch.int64)]
        elif c.kind == PLAIN and c.values.dim() == 1 \
                and not c.values.is_floating_point():
            p = c.values
        else:
            raise NotImplementedError(f"ORDER BY a {c.kind} {c.dtype} column")
        if c.validity is not None:
            p = torch.where(c.validity, p.to(torch.int64), SORT.I64_MAX)
        karrs.append((p, desc))
    return karrs


def _sort(chunk: Chunk, keys) -> Chunk:
    perm = SORT.argsort_multi(_sort_key_arrays(chunk, keys), chunk.mask)
    cols = {n: c.take(perm) for n, c in chunk.cols.items()}
    return Chunk(cols, chunk.mask[perm])


# ---------------------------------------------------------------- aggregation

def _exec_agg(plan: PhysHashAggregate, ctx: ExecContext) -> Chunk:
    child = execute(plan.child, ctx)
    for spec in plan.aggs:
        if spec.distinct:
            raise NotImplementedError("DISTINCT aggregates on the torch path")
    if not plan.groups:
        return _exec_global_agg(plan, child)
    group_exprs = tuple(e for _, e in plan.groups)
    # group count can't exceed the live row count: a host read keeps every
    # [capacity]-shaped tensor proportional to the data, not the estimate
    live = _sync_int(ctx, child.mask.sum())
    capacity = max(64, HT.capacity_for(min(plan.ndv_hint, live + 1)))
    while True:
        owner, slot, overflow = _insert(child, group_exprs, capacity)
        if overflow is None or not _sync_int(ctx, overflow):
            break
        capacity *= 2
    gvalid = owner != HT.EMPTY
    rep = torch.clamp(owner.to(torch.int64), max=max(child.n_rows - 1, 0))
    out: Dict[str, DCol] = {}
    for name, e in plan.groups:
        out[name] = eval_expr(e, child).take(rep, valid=gvalid)
    for spec in plan.aggs:
        out[spec.name] = _agg_col(spec, child, slot, capacity, gvalid)
    return _maybe_compact(Chunk(out, gvalid), ctx)


def _seg_sum128(vals, slot, vmask, capacity):
    """Exact int128 segment sum of int64 or packed-int128 addends."""
    if vals.dim() == 2:
        return I128.seg_sum128_from_i128(vals, slot, vmask, capacity)
    return I128.seg_sum128_from_i64(vals, slot, vmask, capacity)


def _g_sum128(vals, mask):
    if vals.dim() == 2:
        return I128.g_sum128_from_i128(vals, mask)
    return I128.g_sum128_from_i64(vals, mask)


def _agg_col(spec: AggSpec, chunk: Chunk, slot, capacity, gvalid) -> DCol:
    mask = chunk.mask & (slot >= 0)
    if spec.func == "count_star":
        return DCol(T.BIGINT, PLAIN, A.seg_count(slot, mask, capacity),
                    validity=gvalid)
    c = eval_expr(spec.arg, chunk)
    vmask = mask & c.valid_or_true()
    vals = c.values
    ot = _agg_output_type(spec)
    if spec.func == "count":
        return DCol(T.BIGINT, PLAIN, A.seg_count(slot, vmask, capacity),
                    validity=gvalid)
    if spec.func == "sum" and (T.is_long_decimal(ot) or ot == T.BIGINT):
        nonempty = A.seg_count(slot, vmask, capacity) > 0
        if T.is_long_decimal(ot):
            # DECIMAL sums accumulate in int128 like the reference
            # (LongDecimalWithOverflowState)
            v = I128.pack(*_seg_sum128(vals, slot, vmask, capacity))
        else:
            v = A.seg_sum(vals, slot, vmask, capacity, torch.int64)
        return DCol(ot, PLAIN, v, validity=gvalid & nonempty)
    if spec.func == "avg" and T.is_decimal(c.dtype):
        cnt = A.seg_count(slot, vmask, capacity)
        hi, lo = _seg_sum128(vals, slot, vmask, capacity)
        qhi, qlo = I128.div_round_half_up(
            hi, lo, *I128.from_i64(cnt.clamp_min(1)))
        v = I128.pack(qhi, qlo) if T.is_long_decimal(ot) else qlo
        return DCol(ot, PLAIN, v, validity=gvalid & (cnt > 0))
    raise NotImplementedError(
        f"grouped {spec.func}({c.dtype}) on the torch path")


def _exec_global_agg(plan: PhysHashAggregate, chunk: Chunk) -> Chunk:
    out: Dict[str, DCol] = {}
    for spec in plan.aggs:
        if spec.func == "count_star":
            out[spec.name] = DCol(T.BIGINT, PLAIN,
                                  A.g_count(chunk.mask).reshape(1))
            continue
        c = eval_expr(spec.arg, chunk)
        m = chunk.mask & c.valid_or_true()
        ot = _agg_output_type(spec)
        if spec.func == "count":
            out[spec.name] = DCol(T.BIGINT, PLAIN, A.g_count(m).reshape(1))
        elif spec.func == "sum" and T.is_long_decimal(ot):
            out[spec.name] = DCol(ot, PLAIN,
                                  I128.pack(*_g_sum128(c.values, m))
                                  .reshape(1, 2),
                                  validity=(A.g_count(m) > 0).reshape(1))
        elif spec.func == "sum" and ot == T.BIGINT:
            out[spec.name] = DCol(ot, PLAIN,
                                  A.g_sum(c.values, m, torch.int64).reshape(1),
                                  validity=(A.g_count(m) > 0).reshape(1))
        else:
            raise NotImplementedError(
                f"global {spec.func}({c.dtype}) on the torch path")
    return Chunk(out, torch.ones((1,), dtype=torch.bool,
                                 device=chunk.mask.device))


# ---------------------------------------------------------------- joins

def _exec_join(plan: PhysHashJoin, ctx: ExecContext) -> Chunk:
    if plan.kind not in ("inner", "left", "semi", "anti") \
            or not plan.unique_build or plan.filter is not None:
        raise NotImplementedError(
            f"{plan.kind} join (unique build={plan.unique_build}, residual "
            f"filter={plan.filter is not None}) on the torch path")
    build = execute(plan.build, ctx)
    probe = execute(plan.probe, ctx)
    build_count = _sync_int(ctx, build.mask.sum())
    table = HT.build(_key_arrays(build, plan.build_keys), build.mask,
                     HT.capacity_for(max(build_count, 1)))
    probe = _dynamic_filter(plan, probe, build, ctx)
    match = HT.probe_unique(table, _key_arrays(probe, plan.probe_keys),
                            probe.mask)
    found = match >= 0
    if plan.kind == "semi":
        out = Chunk(dict(probe.cols), probe.mask & found)
    elif plan.kind == "anti":
        out = Chunk(dict(probe.cols), probe.mask & ~found)
    else:
        cols = dict(probe.cols)
        for out_name, bcol in plan.build_payload:
            cols[out_name] = build.cols[bcol].take(match, valid=found)
        out = Chunk(cols, probe.mask & found if plan.kind == "inner"
                    else probe.mask)
    return _maybe_compact(out, ctx)


def _dynamic_filter(plan: PhysHashJoin, probe: Chunk, build: Chunk,
                    ctx: ExecContext) -> Chunk:
    """Dynamic filtering (reference: ``DynamicFilterSourceOperator``):
    narrow the probe side to the build keys' [min, max] before probing."""
    if plan.kind not in ("inner", "semi") or not plan.probe_keys:
        return probe  # anti/left joins must keep unmatched probe rows
    if probe.n_rows < MIN_ROWS_FOR_COMPACTION:
        return probe  # not worth the extra pass on small probes
    pkc = eval_expr(plan.probe_keys[0], probe)
    bkc = eval_expr(plan.build_keys[0], build)
    if pkc.kind != PLAIN or bkc.kind != PLAIN or pkc.values.dim() != 1 \
            or bkc.values.dim() != 1:
        return probe
    bmask = build.mask & bkc.valid_or_true()
    bv = bkc.values.to(torch.int64)
    pv = pkc.values.to(torch.int64)
    mask = probe.mask & (pv >= A.g_min(bv, bmask)) & (pv <= A.g_max(bv, bmask))
    return _maybe_compact(Chunk(probe.cols, mask), ctx)

