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

The corr family keeps its moment sums (float64, and exact int128 ones
for int64 arguments, ``physical.corr_moments``), ``checksum`` its wrapping
int64 sum, ``geometric_mean`` its sums of logarithms, ``bool_and`` and
``bool_or`` a 0/1 merged by min and max, and the bitwise aggregates
their value merged by AND and OR, each beside its count.

The mesh, the exchanges and the multi-device runner are slice 5 and not
ported: this module holds the states only.  ``approx_percentile``,
``min_by``, ``max_by`` and the nested-value aggregates (array_agg,
map_agg, histogram, min(x, n)/max(x, n)) have no state here (nor in the
JAX package's streaming), so they raise ``NotImplementedError`` naming
them and a streamed plan holding them runs whole; so does a DISTINCT
aggregate,
whose state does not merge.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..data import types as T
from ..data.column import DICT, PLAIN
from ..exec import physical as PH
from ..exec.columns import Chunk, DCol
from ..exec.expreval import as_double, eval_expr
from ..exec.plan import (CORR_FUNCS, VARIANCE_FUNCS, AggSpec,
                         PhysHashAggregate, _agg_output_type)
from ..ops import agg as A
from ..ops import hashtable as HT
from ..ops import hll as HLL
from ..ops import int128 as I128
from ..sql import ir

# aggregates with a mergeable state in this package
STATE_FUNCS = frozenset({"count", "count_star", "sum", "avg", "min", "max",
                         "arbitrary", "any_value", "approx_distinct",
                         "checksum", "geometric_mean", "bool_and", "bool_or",
                         "bitwise_and_agg", "bitwise_or_agg"}
                        | VARIANCE_FUNCS | CORR_FUNCS)


def partial_agg_states(plan: PhysHashAggregate, child: Chunk,
                       capacity: int):
    """PARTIAL step: ``child`` grouped by the plan's keys into at most
    ``capacity`` groups, with every aggregate's state columns.  Returns
    (the partial chunk, its [(state column, merge function)], the group
    table's overflow flag: a tensor, or None when it cannot overflow)."""
    for spec in plan.aggs:
        _check(spec)
    cols: Dict[str, DCol] = {}
    if plan.groups:
        group_exprs = tuple(e for _, e in plan.groups)
        owner, slot, overflow = PH._insert(child, group_exprs, capacity)
        gvalid = owner != HT.EMPTY
        rep = owner.to(torch.int64).clamp(max=max(child.n_rows - 1, 0))
        cols = {name: eval_expr(e, child).take(rep, valid=gvalid)
                for name, e in plan.groups}
        R = PH.Groups(slot, capacity, gvalid)
    else:  # one group, present even over no rows: the global forms
        R, overflow = PH.Whole(child.n_rows, child.mask.device), None
    specs: List[Tuple[str, str]] = []
    for spec in plan.aggs:
        for sname, sfunc, scol in _partial_states(spec, child, R):
            cols[sname] = scol
            specs.append((sname, sfunc))
    return Chunk(cols, R.gvalid), specs, overflow


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
    elif sfunc in ("band", "bor"):
        out = (A.seg_bitand if sfunc == "band" else A.seg_bitor)(
            v, slot, m, capacity)
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


def _partial_states(spec: AggSpec, chunk: Chunk, R: PH.Groups):
    """(state name, merge function, DCol) triples of one aggregate's
    PARTIAL state, the same sums, extremes and registers the one-shot
    aggregate (``physical._agg_col``) reduces, by ``R``'s reductions."""
    _check(spec)
    slot, capacity, gvalid = R.slot, R.capacity, R.gvalid
    mask = chunk.mask & (slot >= 0)
    if spec.func == "count_star":
        return [(f"{spec.name}#cnt", "sum", DCol(
            T.BIGINT, PLAIN, R.count(mask), validity=gvalid))]
    c = eval_expr(spec.arg, chunk)
    if spec.func not in PH.KEEPS_ZONE:
        PH.refuse_zoned(c, f"the {spec.func} state")
    vmask = mask & c.valid_or_true()
    cnt = R.count(vmask)
    count = (f"{spec.name}#cnt", "sum",
             DCol(T.BIGINT, PLAIN, cnt, validity=gvalid))
    if spec.func == "count":
        return [count]
    if spec.func == "approx_distinct":
        regs = HLL.group_state(PH.value_hash(c), slot, vmask, capacity)
        return [(f"{spec.name}#hll", "hll",
                 DCol(T.BIGINT, PLAIN, regs, validity=gvalid))]
    if spec.func in ("arbitrary", "any_value"):
        ridx = torch.arange(chunk.n_rows, dtype=torch.int64,
                            device=slot.device)
        widx = R.min(ridx, vmask)
        return [(f"{spec.name}#arb", "arb",
                 c.take(widx.clamp(max=max(chunk.n_rows - 1, 0)),
                        valid=gvalid & (cnt > 0)))]
    if spec.func in PH.MORE_FUNCS:
        return _more_states(spec, c, chunk, vmask, R, count)
    if spec.func in ("min", "max") and c.kind == DICT:
        f = R.min if spec.func == "min" else R.max
        return [(f"{spec.name}#{spec.func}", spec.func, PH.dict_extreme(
            c, lambda r: f(r, vmask), gvalid & (cnt > 0), c.dtype))]
    vals = c.values
    if c.kind != PLAIN or vals.dtype == torch.bool:
        raise NotImplementedError(
            f"grouped {spec.func}({c.dtype}, {c.kind}) on the torch path")
    if spec.func in VARIANCE_FUNCS:
        fv = as_double(c)
        return [(f"{spec.name}#s1", "sum", DCol(
                    T.DOUBLE, PLAIN, R.sum(fv, vmask, torch.float64),
                    validity=gvalid)),
                (f"{spec.name}#s2", "sum", DCol(
                    T.DOUBLE, PLAIN, R.sum(fv * fv, vmask, torch.float64),
                    validity=gvalid)),
                count]
    if spec.func in ("min", "max"):
        if vals.dim() == 2:
            f = I128.seg_min128 if spec.func == "min" else I128.seg_max128
            v = I128.pack(*f(vals, slot, vmask, capacity))
        else:
            v = (R.min if spec.func == "min" else R.max)(vals, vmask)
        return [(f"{spec.name}#{spec.func}", spec.func,
                 DCol(c.dtype, PLAIN, v, validity=gvalid & (cnt > 0)))]
    # sum and avg: the int128 sum of a decimal, the float64 sum of a
    # DOUBLE, the int64 sum of an integer (a global one ``masked_sum``'s)
    ot = _agg_output_type(spec)
    if T.is_decimal(c.dtype):
        s = I128.pack(*PH._seg_sum128(vals, slot, vmask, capacity))
        st = T.decimal(38, c.dtype.scale)
    elif vals.is_floating_point():
        s = R.sum(vals, vmask, torch.float64)
        st = T.DOUBLE
    else:
        if spec.func == "sum" and ot != T.BIGINT:
            raise NotImplementedError(
                f"grouped sum({c.dtype}) on the torch path")
        s = R.sum(vals, vmask, torch.int64)
        st = T.BIGINT
    out = [(f"{spec.name}#sum", "sum",
            DCol(st, PLAIN, s, validity=gvalid & (cnt > 0)))]
    return out + [count] if spec.func == "avg" else out


def _more_states(spec: AggSpec, c: DCol, chunk: Chunk, vmask,
                 R: PH.Groups, count):
    """The states of the aggregates ``physical._agg_more`` computes (all
    of ``MORE_FUNCS`` but approx_percentile, min_by and max_by, which
    ``_check`` refuses), each beside the count of its rows."""
    name, f = spec.name, spec.func

    def state(tag, merge, dtype, v):
        return (f"{name}#{tag}", merge, DCol(dtype, PLAIN, v,
                                             validity=R.gvalid))

    def sums(named):  # float64 sums, and packed int128 ones
        return [state(t, "sum", T.DOUBLE if v.dim() == 1
                      else T.decimal(38, 0), v) for t, v in named.items()]
    if f in CORR_FUNCS:
        return sums(PH.corr_moments(spec, c, chunk, vmask, R))
    if f == "checksum":
        v = state("sum", "sum", T.BIGINT,
                  R.sum(PH.checksum_terms(c), vmask, torch.int64))
    elif c.kind != PLAIN:
        raise NotImplementedError(f"the {f} state of a {c.kind} column")
    elif f == "geometric_mean":
        return sums(PH.log_sums(c, vmask, R)) + [count]
    elif c.values.dim() == 2:
        raise NotImplementedError(f"the {f} state of a {c.dtype} column")
    elif f in ("bool_and", "bool_or"):
        # AND merges as the min over {0, 1}, OR as the max; a group with
        # no row in this part has a NULL state that the merge skips
        b = c.values.to(torch.bool)
        v = (~R.any(~b, vmask)) if f == "bool_and" else R.any(b, vmask)
        return [(f"{name}#b", "min" if f == "bool_and" else "max",
                 DCol(T.BIGINT, PLAIN, v.to(torch.int64),
                      validity=R.gvalid & (R.count(vmask) > 0))), count]
    else:  # bitwise_and_agg / bitwise_or_agg: an empty part holds the
        # operation's identity
        band = f == "bitwise_and_agg"
        v = state("b", "band" if band else "bor", T.BIGINT,
                  (R.bitand if band else R.bitor)(c.values, vmask))
    return [v, count]


def _finalize_more(spec: AggSpec, merged: Dict[str, DCol], gvalid) -> DCol:
    """A ``MORE_FUNCS`` aggregate from its merged states."""
    name, f = spec.name, spec.func
    if f in CORR_FUNCS:
        v, ok = PH.corr_finalize(spec, {
            t: merged[f"{name}#{t}"].values
            for t in PH.CORR_FLOAT + PH.CORR_EXACT
            if f"{name}#{t}" in merged})
        return DCol(T.DOUBLE, PLAIN, v, validity=gvalid & ok)
    cnt = merged[f"{name}#cnt"].values
    if f == "checksum":
        v = merged[f"{name}#sum"].values
    elif f == "geometric_mean":
        v = PH.geometric_mean({t: merged[f"{name}#{t}"].values
                               for t in ("slog", "qlog")}, cnt)
    elif f in ("bool_and", "bool_or"):
        v = merged[f"{name}#b"].values.to(torch.bool)
    else:
        v = merged[f"{name}#b"].values
    return DCol(_agg_output_type(spec), PLAIN, v, validity=gvalid & (cnt > 0))


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
    if spec.func in PH.MORE_FUNCS:
        return _finalize_more(spec, merged, gvalid)
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
