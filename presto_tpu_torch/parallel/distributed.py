"""Mergeable aggregation states: the PARTIAL → FINAL split.

Torch port of the aggregation-state half of
``presto_tpu/parallel/distributed.py`` (``partial_agg_states``,
``merge_agg_states``, ``_partial_states``, ``_finalize_agg``): the
reference's accumulator INTERMEDIATE states
(``operator/aggregation/AccumulatorCompiler.java``).  A PARTIAL step
groups one input and keeps, per group, a state that merges exactly: a
count and a sum add, min and max take their extreme (of a string: by
its rank in the dictionary the slices share), ``arbitrary`` keeps
its first row, the variance family keeps its moment sums and
``approx_distinct`` its HLL registers (merged by an elementwise max).  A
FINAL step groups the partial rows again, merges each state and
finalizes.  The slice-at-a-time streaming aggregation
(``exec/streaming.py``) consumes them today.

The mesh, the exchanges and the multi-device runner are slice 5 and not
ported: this module holds the states only.  An aggregate the port does
not compute yet (``approx_percentile``, ``checksum``, ``bool_*``,
``bitwise_*_agg``, ``geometric_mean``, the ``corr`` family, ``min_by``,
...) raises ``NotImplementedError`` naming it, as the operators do, and so
does a DISTINCT aggregate, whose state does not merge.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..data import types as T
from ..data.column import DICT, PLAIN
from ..exec import physical as PH
from ..exec.columns import Chunk, DCol
from ..exec.expreval import as_double, eval_expr
from ..exec.plan import (VARIANCE_FUNCS, AggSpec, PhysHashAggregate,
                         _agg_output_type)
from ..ops import agg as A
from ..ops import hashing as HASH
from ..ops import hashtable as HT
from ..ops import hll as HLL
from ..ops import int128 as I128
from ..sql import ir

# aggregates with a mergeable state in this package
STATE_FUNCS = frozenset({"count", "count_star", "sum", "avg", "min", "max",
                         "arbitrary", "any_value", "approx_distinct"}
                        | VARIANCE_FUNCS)


def partial_agg_states(plan: PhysHashAggregate, child: Chunk,
                       capacity: int):
    """PARTIAL step: ``child`` grouped by the plan's keys into at most
    ``capacity`` groups, with every aggregate's state columns.  Returns
    (the partial chunk, its [(state column, merge function)], the group
    table's overflow flag: a tensor, or None when it cannot overflow)."""
    for spec in plan.aggs:
        _check(spec)
    group_exprs = tuple(e for _, e in plan.groups)
    owner, slot, overflow = PH._insert(child, group_exprs, capacity)
    gvalid = owner != HT.EMPTY
    rep = owner.to(torch.int64).clamp(max=max(child.n_rows - 1, 0))
    cols: Dict[str, DCol] = {name: eval_expr(e, child).take(rep, valid=gvalid)
                             for name, e in plan.groups}
    specs: List[Tuple[str, str]] = []
    for spec in plan.aggs:
        for sname, sfunc, scol in _partial_states(spec, child, slot,
                                                  capacity, gvalid):
            cols[sname] = scol
            specs.append((sname, sfunc))
    return Chunk(cols, gvalid), specs, overflow


def group_partials(plan: PhysHashAggregate, partials: Chunk, capacity: int):
    """The partial rows grouped again by the plan's group columns:
    (owner, slot, overflow) as ``physical._insert`` gives them."""
    keys = tuple(ir.ColumnRef(n, e.dtype) for n, e in plan.groups)
    return PH._insert(partials, keys, capacity)


def merge_state(sfunc: str, c: DCol, partials: Chunk, slot, capacity: int,
                gvalid) -> DCol:
    """One state column of the partial rows merged per group by its
    merge function; a group whose partial states are all NULL stays
    NULL."""
    m = partials.mask & (slot >= 0) & c.valid_or_true()
    nonempty = A.seg_count(slot, m, capacity) > 0
    if sfunc == "arb":
        ridx = torch.arange(partials.n_rows, dtype=torch.int64,
                            device=slot.device)
        widx = A.seg_min(ridx, slot, m, capacity)
        return c.take(widx.clamp(max=max(partials.n_rows - 1, 0)),
                      valid=gvalid & nonempty)
    v = c.values
    if c.kind == DICT:
        # min/max states of strings merge by string: the partial rows'
        # ranks in their (shared) dictionary
        f = A.seg_min if sfunc == "min" else A.seg_max
        return PH.dict_extreme(c, lambda r: f(r, slot, m, capacity),
                               gvalid & nonempty, c.dtype)
    if c.kind != PLAIN:
        raise NotImplementedError(
            f"merge of {sfunc} states in a {c.kind} column")
    if sfunc == "hll":
        out = HLL.seg_merge(v, slot, m, capacity)
    elif sfunc == "sum":
        out = (I128.pack(*I128.seg_sum128_from_i128(v, slot, m, capacity))
               if v.dim() == 2 else
               A.seg_sum(v, slot, m, capacity,
                         torch.float64 if v.is_floating_point()
                         else torch.int64))
    elif v.dim() == 2:
        f = I128.seg_min128 if sfunc == "min" else I128.seg_max128
        out = I128.pack(*f(v, slot, m, capacity))
    else:
        out = (A.seg_min if sfunc == "min" else A.seg_max)(v, slot, m,
                                                            capacity)
    return DCol(c.dtype, c.kind, out, validity=gvalid & nonempty,
                dictionary=c.dictionary)


def merge_agg_states(plan: PhysHashAggregate, partials: Chunk, state_specs,
                     capacity: int):
    """FINAL step over accumulated partial rows: group them again, merge
    each state, finalize every aggregate.  Returns (chunk, overflow)."""
    owner, slot, overflow = group_partials(plan, partials, capacity)
    gvalid = owner != HT.EMPTY
    rep = owner.to(torch.int64).clamp(max=max(partials.n_rows - 1, 0))
    cols: Dict[str, DCol] = {name: partials.cols[name].take(rep, valid=gvalid)
                             for name, _ in plan.groups}
    merged = {sname: merge_state(sfunc, partials.cols[sname], partials, slot,
                                 capacity, gvalid)
              for sname, sfunc in state_specs}
    for spec in plan.aggs:
        cols[spec.name] = _finalize_agg(spec, merged, gvalid)
    return Chunk(cols, gvalid), overflow


def _check(spec: AggSpec) -> None:
    if spec.distinct:
        raise NotImplementedError(
            f"{spec.func}(DISTINCT) has no mergeable state")
    if spec.func not in STATE_FUNCS:
        raise NotImplementedError(f"{spec.func} states on the torch path")


def _partial_states(spec: AggSpec, chunk: Chunk, slot, capacity, gvalid):
    """(state name, merge function, DCol) triples of one aggregate's
    PARTIAL state, the same sums, extremes and registers the one-shot
    aggregate (``physical._agg_col``) reduces."""
    _check(spec)
    mask = chunk.mask & (slot >= 0)
    if spec.func == "count_star":
        return [(f"{spec.name}#cnt", "sum", DCol(
            T.BIGINT, PLAIN, A.seg_count(slot, mask, capacity),
            validity=gvalid))]
    c = eval_expr(spec.arg, chunk)
    if spec.func not in PH.KEEPS_ZONE:
        PH.refuse_zoned(c, f"the {spec.func} state")
    vmask = mask & c.valid_or_true()
    cnt = A.seg_count(slot, vmask, capacity)
    count = (f"{spec.name}#cnt", "sum",
             DCol(T.BIGINT, PLAIN, cnt, validity=gvalid))
    if spec.func == "count":
        return [count]
    if spec.func == "approx_distinct":
        regs = HLL.group_state(HASH.hash_keys(PH._col_keys(c)), slot, vmask,
                               capacity)
        return [(f"{spec.name}#hll", "hll",
                 DCol(T.BIGINT, PLAIN, regs, validity=gvalid))]
    if spec.func in ("arbitrary", "any_value"):
        ridx = torch.arange(chunk.n_rows, dtype=torch.int64,
                            device=slot.device)
        widx = A.seg_min(ridx, slot, vmask, capacity)
        return [(f"{spec.name}#arb", "arb",
                 c.take(widx.clamp(max=max(chunk.n_rows - 1, 0)),
                        valid=gvalid & (cnt > 0)))]
    if spec.func in ("min", "max") and c.kind == DICT:
        f = A.seg_min if spec.func == "min" else A.seg_max
        return [(f"{spec.name}#{spec.func}", spec.func, PH.dict_extreme(
            c, lambda r: f(r, slot, vmask, capacity), gvalid & (cnt > 0),
            c.dtype))]
    vals = c.values
    if c.kind != PLAIN or vals.dtype == torch.bool:
        raise NotImplementedError(
            f"grouped {spec.func}({c.dtype}, {c.kind}) on the torch path")
    if spec.func in VARIANCE_FUNCS:
        fv = as_double(c)
        return [(f"{spec.name}#s1", "sum", DCol(
                    T.DOUBLE, PLAIN, A.seg_sum(fv, slot, vmask, capacity),
                    validity=gvalid)),
                (f"{spec.name}#s2", "sum", DCol(
                    T.DOUBLE, PLAIN, A.seg_sum(fv * fv, slot, vmask,
                                               capacity), validity=gvalid)),
                count]
    if spec.func in ("min", "max"):
        if vals.dim() == 2:
            f = I128.seg_min128 if spec.func == "min" else I128.seg_max128
            v = I128.pack(*f(vals, slot, vmask, capacity))
        else:
            v = (A.seg_min if spec.func == "min" else A.seg_max)(
                vals, slot, vmask, capacity)
        return [(f"{spec.name}#{spec.func}", spec.func,
                 DCol(c.dtype, PLAIN, v, validity=gvalid & (cnt > 0)))]
    # sum and avg: the int128 sum of a decimal, the float64 sum of a
    # DOUBLE, the int64 sum of an integer
    ot = _agg_output_type(spec)
    if T.is_decimal(c.dtype):
        s = I128.pack(*PH._seg_sum128(vals, slot, vmask, capacity))
        st = T.decimal(38, c.dtype.scale)
    elif vals.is_floating_point():
        s = A.seg_sum(vals, slot, vmask, capacity, torch.float64)
        st = T.DOUBLE
    else:
        if spec.func == "sum" and ot != T.BIGINT:
            raise NotImplementedError(
                f"grouped sum({c.dtype}) on the torch path")
        s = A.seg_sum(vals, slot, vmask, capacity, torch.int64)
        st = T.BIGINT
    out = [(f"{spec.name}#sum", "sum",
            DCol(st, PLAIN, s, validity=gvalid & (cnt > 0)))]
    return out + [count] if spec.func == "avg" else out


def _finalize_agg(spec: AggSpec, merged: Dict[str, DCol], gvalid) -> DCol:
    """One aggregate's output column from its merged states, as the
    one-shot aggregate computes it."""
    ot = _agg_output_type(spec)
    name = spec.name
    if spec.func in ("count", "count_star"):
        c = merged[f"{name}#cnt"]
        return DCol(T.BIGINT, PLAIN, c.values, validity=gvalid)
    if spec.func == "approx_distinct":
        return DCol(T.BIGINT, PLAIN,
                    HLL.estimate(merged[f"{name}#hll"].values),
                    validity=gvalid)
    if spec.func in ("arbitrary", "any_value"):
        return merged[f"{name}#arb"]
    if spec.func in VARIANCE_FUNCS:
        cnt = merged[f"{name}#cnt"].values
        v = PH._variance(spec.func, merged[f"{name}#s1"].values,
                         merged[f"{name}#s2"].values, cnt)
        return DCol(T.DOUBLE, PLAIN, v, validity=gvalid & (
            cnt >= (1 if spec.func.endswith("_pop") else 2)))
    if spec.func in ("min", "max"):
        c = merged[f"{name}#{spec.func}"]
        return DCol(ot, c.kind, c.values, validity=c.validity,
                    dictionary=c.dictionary)
    s = merged[f"{name}#sum"]
    if spec.func == "sum":
        return DCol(ot, PLAIN, s.values, validity=s.validity)
    cnt = merged[f"{name}#cnt"].values  # avg
    if T.is_decimal(spec.arg.dtype):
        qhi, qlo = I128.div_round_half_up(
            *I128.unpack(s.values), *I128.from_i64(cnt.clamp_min(1)))
        v = I128.pack(qhi, qlo) if T.is_long_decimal(ot) else qlo
    else:
        v = s.values.to(torch.float64) / cnt.clamp_min(1)
    return DCol(ot, PLAIN, v, validity=gvalid & (cnt > 0))
