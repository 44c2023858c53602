"""Multi-rank execution on ``torch.distributed``, and the mergeable
aggregation states it shares with the streamed aggregation.

Torch port of ``presto_tpu/parallel/distributed.py``: the reference's
distributed stack (``execution/scheduler/SqlQueryScheduler.java``, the
HTTP exchange of ``operator/ExchangeClient.java`` and
``PartitionedOutputOperator.java``, ``sql/planner/optimizations/
AddExchanges.java``) as SPMD over a process group.  Every rank is one
process holding one device (``cuda:LOCAL_RANK``, or the CPU when the
caller asks for it): NCCL on the card, gloo on the CPU.

- Tables are row-sharded: a rank scans its own split of each table
  (``ShardSource``; the connector's ``splits(table, world)[rank]``, the
  JAX package's ``_unit_ranges``), cached across queries.
- ``execute_distributed`` walks the physical plan once, as the JAX
  package's ``execute_traced`` does, tracking whether each intermediate
  is *replicated* (the same on every rank) or *sharded*, and runs the
  port's own operators (``exec/physical.py``) on each rank's rows.
- An exchange first swaps its per-destination row counts
  (``all_to_all_single`` of an int64 tensor, one host read), then moves
  every column of the chunk in one ``all_to_all_single`` of a byte
  matrix with exact splits, so no capacity is estimated and nothing
  overflows.  Before a chunk leaves its rank, the ranks agree on its
  layout (``_agree``: one ``all_gather_object``): the widest BYTES,
  ARRAY and MAP width, every string dictionary (the sorted union, codes
  recoded, so string ranks keep their order), present validities.
  FIXED_BROADCAST is ``allgather_chunk``; FIXED_HASH is ``repartition``
  (destination ``hash_keys(keys) % world``, the JAX package's device
  index) and its skew-aware form (``detect_heavy_hashes``,
  ``repartition_skew``, ``gather_compact``).
- Joins take their ``dist_type`` from ``sql/planner/distribution.py``:
  REPLICATED gathers the build, PARTITIONED routes both sides (heavy
  probe keys round-robin, their build rows replicated).  Aggregation is
  PARTIAL → route by group keys → FINAL over the states below; a DISTINCT,
  order-statistic or nested aggregate routes whole groups instead, and a
  global one merges gathered one-row partials (one with no state gathers
  its rows).  A
  sort below ``TOPN_PARTIAL_LIMIT`` rows is a partial TopN; a larger one
  is range-partitioned on splitters from a gathered sample, so the
  rank-major concatenation is the order.
- ``DistributedRunner`` plans (``prune(optimize(...))`` then
  ``add_exchanges``) and runs a statement on every rank in lockstep;
  every rank returns the whole result.

The JAX package's ``TraceCtx`` capacities, per-site multipliers and
overflow retry, ``_try_chain_walk_join_agg``, ``_chain_walk_exists``,
``_shrink_traced`` and the ``jax.Array`` plumbing (``_put_shard``,
``_assemble_shards``, ``_get_shard_map``) are not ported: they exist
because traced shapes are static, and exact sizes make them unneeded
with the same answers.  FULL JOIN and MATCH_RECOGNIZE raise
``NotImplementedError``, as in the JAX package; so do ``uuid()`` and
``unique_id()`` over several ranks (each rank would number its rows
from 0).

The states: a PARTIAL step groups one input and keeps, per group, a
state that merges exactly (the reference's accumulator INTERMEDIATE
states, ``operator/aggregation/AccumulatorCompiler.java``): a count and a
sum add, min and max take their extreme (of a string: by its rank in
the dictionary the parts share), ``arbitrary`` keeps its first row, the
variance family keeps its moment sums, ``approx_distinct`` its HLL
registers (merged by an elementwise max), the corr family its moment
sums (float64, and exact int128 ones for int64 arguments,
``physical.corr_moments``), ``checksum`` its wrapping int64 sum,
``geometric_mean`` its sums of logarithms, ``bool_and``/``bool_or`` a
0/1 merged by min and max, and the bitwise aggregates their value merged
by AND and OR, each beside its count.  A FINAL step groups the partial
rows again, merges each state and finalizes.  On several ranks only,
``approx_percentile`` keeps a bottom-k sample (``ops/quantile.py``).  The
streamed aggregation (``exec/streaming.py``) consumes the same states;
there ``approx_percentile``, ``min_by``, ``max_by``, the nested-value
aggregates and DISTINCT have no state and raise ``NotImplementedError``
naming them, so a streamed plan holding them runs whole and exact.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..data import types as T
from ..data.column import ARRAY, BYTES, DICT, MAP, PLAIN
from ..data.table import Table
from ..exec import physical as PH
from ..exec.columns import Chunk, DCol, Dictionary
from ..exec.datasource import DataSource
from ..exec.expreval import as_double, eval_expr, refuse_row_numbering
from ..exec.plan import (CORR_FUNCS, VARIANCE_FUNCS, AggSpec, PhysConcat,
                         PhysFilter, PhysGroupId, PhysHashAggregate,
                         PhysHashJoin, PhysLimit, PhysMaterial, PhysOp,
                         PhysProject, PhysScalarBind, PhysScan, PhysSort,
                         PhysUnnest, PhysWindow, _agg_output_type)
from ..exec.runner import resolve_device
from ..ops import agg as A
from ..ops import hashtable as HT
from ..ops import hll as HLL
from ..ops import int128 as I128
from ..ops import quantile as Q
from ..ops import sort as SORT
from ..ops.hashing import hash_keys
from ..sql import ir
from ..utils.tracing import host_read

# aggregates with a mergeable state in this package
STATE_FUNCS = frozenset({"count", "count_star", "sum", "avg", "min", "max",
                         "arbitrary", "any_value", "approx_distinct",
                         "checksum", "geometric_mean", "bool_and", "bool_or",
                         "bitwise_and_agg", "bitwise_or_agg"}
                        | VARIANCE_FUNCS | CORR_FUNCS)


def partial_agg_states(plan: PhysHashAggregate, child: Chunk,
                       capacity: int, sketch_k: Optional[int] = None):
    """PARTIAL step: ``child`` grouped by the plan's keys into at most
    ``capacity`` groups, with every aggregate's state columns.  Returns
    (the partial chunk, its [(state column, merge function)], the group
    table's overflow flag: a tensor, or None when it cannot overflow).
    With ``sketch_k``, approx_percentile keeps a bottom-k sample of that
    many entries (``ops/quantile.py``; the multi-rank path only)."""
    for spec in plan.aggs:
        _check(spec, sketch_k)
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
        for sname, sfunc, scol in _partial_states(spec, child, R, sketch_k):
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
    merged = {}
    for sname, sfunc in state_specs:
        if sfunc == "qsample":
            merged.update(_merge_sample(sname, partials, slot, capacity,
                                        gvalid))
        elif sfunc != "qsample_aux":  # merged beside its "qsample"
            merged[sname] = merge_state(sfunc, partials.cols[sname],
                                        partials, slot, capacity, gvalid)
    for spec in plan.aggs:
        cols[spec.name] = _finalize_agg(spec, merged, gvalid)
    return Chunk(cols, gvalid), overflow


def _merge_sample(sname: str, partials: Chunk, slot, capacity: int,
                  gvalid) -> Dict[str, DCol]:
    """approx_percentile's three sample columns (values ``#qv``,
    priorities ``#qp``, counts ``#qn``) merged per group: each group's
    entries selected again, its counts summed."""
    base = sname[:-3]
    c = partials.cols[sname]
    m = partials.mask & (slot >= 0) & c.valid_or_true()
    mv, mp, mc = Q.merge_states(c.values, partials.cols[base + "#qp"].values,
                                partials.cols[base + "#qn"].values, slot, m,
                                capacity)
    valid = gvalid & (mc > 0)
    return {sname: DCol(c.dtype, PLAIN, mv, validity=valid),
            base + "#qp": DCol(T.BIGINT, PLAIN, mp, validity=valid),
            base + "#qn": DCol(T.BIGINT, PLAIN, mc, validity=valid)}


def sketchable(spec: AggSpec) -> bool:
    """Whether approx_percentile of ``spec``'s argument can keep a sample
    state: a one-word value (an integer, date, short decimal, DOUBLE)."""
    t = spec.arg.dtype
    return not (T.is_string(t) or T.is_long_decimal(t) or T.is_timestamp_tz(t)
                or isinstance(t, (T.BooleanType, T.ArrayType, T.MapType)))


def _check(spec: AggSpec, sketch_k: Optional[int] = None) -> None:
    if spec.distinct:
        raise NotImplementedError(
            f"{spec.func}(DISTINCT) has no mergeable state")
    if spec.func == "approx_percentile" and sketch_k and sketchable(spec):
        return
    if spec.func not in STATE_FUNCS:
        raise NotImplementedError(f"{spec.func} states on the torch path")


def _partial_states(spec: AggSpec, chunk: Chunk, R: PH.Groups,
                    sketch_k: Optional[int] = None):
    """(state name, merge function, DCol) triples of one aggregate's
    PARTIAL state, the same sums, extremes and registers the one-shot
    aggregate (``physical._agg_col``) reduces, by ``R``'s reductions."""
    _check(spec, sketch_k)
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
    if spec.func == "approx_percentile":
        # the bottom-k priority sample: its merge is exact, so the
        # sketch crosses the exchange like a sum
        qv, qp, qn = Q.group_state(c.values, slot, vmask, capacity,
                                   sketch_k)
        return [(f"{spec.name}#qv", "qsample",
                 DCol(c.dtype, PLAIN, qv, validity=gvalid)),
                (f"{spec.name}#qp", "qsample_aux",
                 DCol(T.BIGINT, PLAIN, qp, validity=gvalid)),
                (f"{spec.name}#qn", "qsample_aux",
                 DCol(T.BIGINT, PLAIN, qn, validity=gvalid))]
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
    if spec.func == "approx_percentile":
        v, ok = Q.estimate(merged[f"{name}#qv"].values,
                           merged[f"{name}#qp"].values,
                           merged[f"{name}#qn"].values, spec.param)
        return DCol(ot, PLAIN, v, validity=gvalid & ok)
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


# ---------------------------------------------------------------- the world

@dataclass
class Mesh:
    """This rank's view of the world (the JAX package's 1-D mesh ``d``):
    its process group, rank, world size and device."""

    group: object
    rank: int
    world: int
    device: torch.device


def make_mesh(device=None, group=None) -> Mesh:
    """The world of an initialized process group (``group``, or the
    default one): this rank's device is ``cuda:LOCAL_RANK`` unless the
    caller passes ``device`` (``"cpu"`` in the tests).  NCCL serves a
    card and gloo the CPU; any other pairing raises, so that nothing
    quietly falls back."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized "
                           "(parallel/multihost.init_multihost)")
    rank = dist.get_rank(group)
    world = dist.get_world_size(group)
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}"
    dev = resolve_device(device)
    backend = dist.get_backend(group)
    want = "nccl" if dev.type == "cuda" else "gloo"
    if backend != want:
        raise RuntimeError(f"a {dev.type} rank needs the {want} backend, "
                           f"not {backend}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(group, rank, world, dev)


@dataclass
class DistContext(PH.ExecContext):
    """An ``ExecContext`` with the rank's world and what its exchanges
    cost: collectives called, bytes this rank sent, and each join's
    build rows on this rank."""

    mesh: Mesh = None
    collectives: int = 0
    bytes_exchanged: int = 0
    build_rows: list = field(default_factory=list)


_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def _gather_equal(ctx: DistContext, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (one shape on every rank), rank-major:
    ``[world * t.shape[0], ...]``."""
    m = ctx.mesh
    out = torch.empty((m.world * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    _gather_single(out, t.contiguous(), group=m.group)
    ctx.collectives += 1
    ctx.bytes_exchanged += t.numel() * t.element_size()
    return out


def _gather_objects(ctx: DistContext, obj) -> list:
    """Every rank's host object, by rank (one host read)."""
    out = [None] * ctx.mesh.world
    with host_read(ctx):
        dist.all_gather_object(out, obj, group=ctx.mesh.group)
    ctx.collectives += 1
    return out


def _swap_counts(ctx: DistContext, send: torch.Tensor):
    """The rows this rank sends to each rank (int64 [world]) swapped for
    the rows it receives: (send list, receive list), one host read."""
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=ctx.mesh.group)
    ctx.collectives += 1
    with host_read(ctx):
        both = torch.cat([send, recv]).tolist()
    w = ctx.mesh.world
    return both[:w], both[w:]


# ---------------------------------------------------------------- layouts

_FIELDS = ("values", "lengths", "validity", "values2")


def _signature(c: DCol):
    """What the ranks must agree on before a column crosses: its layout,
    its width (BYTES, ARRAY, MAP) and its dictionaries' strings."""
    wide = c.kind in (BYTES, ARRAY, MAP)
    return (c.kind, c.values.dim(), str(c.values.dtype),
            int(c.values.shape[1]) if wide else -1,
            tuple(getattr(c, f) is not None for f in _FIELDS),
            None if c.dictionary is None
            else tuple(str(x) for x in c.dictionary.strings),
            None if c.dictionary2 is None
            else tuple(str(x) for x in c.dictionary2.strings))


def _recode(codes: torch.Tensor, local, union: np.ndarray) -> torch.Tensor:
    """Codes into ``local``'s strings → codes into the sorted ``union``."""
    if len(local) == 0:
        return torch.zeros_like(codes)
    table = np.searchsorted(union, np.asarray(local, dtype=str))
    t = torch.from_numpy(table.astype(np.int64)).to(codes.device)
    return t[codes.to(torch.int64).clamp(0, len(local) - 1)].to(codes.dtype)


def _agree(ctx: DistContext, chunk: Chunk) -> Chunk:
    """``chunk`` on the layout every rank shares, before its rows cross
    ranks: the widest width of each BYTES, ARRAY and MAP column (padded
    with zeros), a validity wherever any rank has one, and each string
    dictionary as the sorted union of every rank's (codes recoded, so
    the order of strings by rank holds).  One ``all_gather_object``;
    nothing to agree on with one rank."""
    if ctx.mesh.world == 1 or not chunk.cols:
        return chunk
    names = list(chunk.cols)
    sigs = _gather_objects(ctx, [_signature(chunk.cols[n]) for n in names])
    cols = {}
    for i, name in enumerate(names):
        c = chunk.cols[name]
        mine = sigs[ctx.mesh.rank][i]
        every = [s[i] for s in sigs]
        if all(s == mine for s in every):
            cols[name] = c
            continue
        layouts = {s[:3] + (s[4][1], s[4][3]) for s in every}
        if len(layouts) > 1:  # a validity may differ, nothing else
            raise NotImplementedError(
                f"ranks hold column {name!r} in different layouts: "
                f"{sorted(layouts)}")
        vals, vals2 = c.values, c.values2
        width = max(s[3] for s in every)
        if width > mine[3]:
            vals = torch.nn.functional.pad(vals, (0, width - mine[3]))
            if vals2 is not None:
                vals2 = torch.nn.functional.pad(vals2, (0, width - mine[3]))
        validity = c.validity
        if validity is None and any(s[4][2] for s in every):
            validity = c.valid_or_true()
        d, d2 = c.dictionary, c.dictionary2
        if mine[5] is not None and any(s[5] != mine[5] for s in every):
            union = np.unique(np.concatenate(
                [np.asarray(s[5], dtype=str) for s in every]))
            vals = _recode(vals, mine[5], union)
            d = Dictionary(union.astype(object))
        if mine[6] is not None and any(s[6] != mine[6] for s in every):
            union = np.unique(np.concatenate(
                [np.asarray(s[6], dtype=str) for s in every]))
            vals2 = _recode(vals2, mine[6], union)
            d2 = Dictionary(union.astype(object))
        cols[name] = DCol(c.dtype, c.kind, vals, c.lengths, validity, d,
                          vals2, d2)
    return Chunk(cols, chunk.mask)


def _pack(chunk: Chunk, rows: torch.Tensor):
    """The chunk's ``rows`` as one byte matrix ``[len(rows), B]`` (every
    tensor of every column, row by row) and the layout that unpacks it."""
    n = int(rows.shape[0])
    parts, layout = [], []
    for name, c in chunk.cols.items():
        for f in _FIELDS:
            t = getattr(c, f)
            if t is None:
                continue
            shape = tuple(t.shape[1:])
            per_row = int(np.prod(shape)) if shape else 1
            b = t[rows].contiguous().reshape(n, per_row).view(torch.uint8)
            parts.append(b)
            layout.append((name, f, t.dtype, shape, int(b.shape[1])))
    if not parts:
        return torch.zeros((n, 0), dtype=torch.uint8,
                           device=chunk.mask.device), layout
    return torch.cat(parts, dim=1), layout


def _unpack(buf: torch.Tensor, layout, like: Chunk) -> Chunk:
    """A byte matrix of ``_pack``'s layout → a chunk of live rows with
    ``like``'s column metadata; no rows come back as one masked-out row
    of zeros, a shape every operator takes."""
    live = torch.ones((buf.shape[0],), dtype=torch.bool, device=buf.device)
    if buf.shape[0] == 0:
        buf = buf.new_zeros((1, buf.shape[1]))
        live = torch.zeros((1,), dtype=torch.bool, device=buf.device)
    n = int(buf.shape[0])
    got: Dict[str, dict] = {}
    off = 0
    for name, f, dtype, shape, nb in layout:
        part = buf.new_empty((n, nb)).copy_(buf[:, off:off + nb])
        t = part.view(dtype).reshape((n,) + shape)
        got.setdefault(name, {})[f] = t
        off += nb
    cols = {}
    for name, c in like.cols.items():
        g = got[name]
        cols[name] = DCol(c.dtype, c.kind, g["values"], g.get("lengths"),
                          g.get("validity"), c.dictionary, g.get("values2"),
                          c.dictionary2)
    return Chunk(cols, live)


def _live_rows(chunk: Chunk, count: int) -> torch.Tensor:
    """The indices of the chunk's ``count`` live rows, in order."""
    return torch.sort((~chunk.mask).to(torch.int8),
                      stable=True).indices[:count]


# ---------------------------------------------------------------- exchanges

def allgather_chunk(ctx: DistContext, chunk: Chunk) -> Chunk:
    """FIXED_BROADCAST: every rank's live rows on every rank, rank-major
    (each rank's rows in their order).  The live counts are gathered
    first (one host read); the rows travel padded to the largest."""
    chunk = _agree(ctx, chunk)
    m = ctx.mesh
    counts = _gather_equal(ctx, chunk.mask.sum().reshape(1).to(torch.int64))
    with host_read(ctx):
        counts = counts.tolist()
    top = max(counts)
    rows = _live_rows(chunk, counts[m.rank])
    buf, layout = _pack(chunk, rows)
    if top > counts[m.rank]:
        buf = torch.cat([buf, buf.new_zeros((top - counts[m.rank],
                                             buf.shape[1]))])
    every = _gather_equal(ctx, buf)
    dev = every.device
    keep = torch.cat([torch.arange(c, device=dev) + r * top
                      for r, c in enumerate(counts)])
    return _unpack(every[keep], layout, chunk)


def _route(ctx: DistContext, chunk: Chunk, dest: torch.Tensor) -> Chunk:
    """Each live row to rank ``dest`` (a chunk on the agreed layout):
    rows stably ordered by destination, the counts swapped, then the
    rows in one ``all_to_all_single`` with exact splits.  The received
    rows come source-rank-major, each source's in its order."""
    w = ctx.mesh.world
    d = torch.where(chunk.mask, dest.to(torch.int64), w)
    order = torch.sort(d, stable=True).indices
    send = torch.bincount(d, minlength=w + 1)[:w]
    send_n, recv_n = _swap_counts(ctx, send)
    buf, layout = _pack(chunk, order[:sum(send_n)])
    out = buf.new_empty((sum(recv_n), buf.shape[1]))
    dist.all_to_all_single(out, buf, recv_n, send_n, group=ctx.mesh.group)
    ctx.collectives += 1
    ctx.bytes_exchanged += buf.numel()
    return _unpack(out, layout, chunk)


def route_chunk(ctx: DistContext, chunk: Chunk,
                dest: torch.Tensor) -> Chunk:
    """Exchange rows to explicit destination ranks (``dest`` in [0,
    world); masked rows stay behind): the shared core of the FIXED_HASH
    and range exchanges.  Sizes are exact, so nothing overflows."""
    return _route(ctx, _agree(ctx, chunk), dest)


def repartition(ctx: DistContext, chunk: Chunk,
                keys: Sequence[torch.Tensor]) -> Chunk:
    """FIXED_HASH: each row to rank ``hash_keys(keys) % world``, the JAX
    package's device index for the same keys (the reference's
    ``PartitionedOutputOperator.java:411`` page partitioner)."""
    return route_chunk(ctx, chunk, hash_keys(keys) % ctx.mesh.world)


# A FIXED_HASH exchange sends every row of one key to one rank, so a heavy
# key (one customer owning a tenth of lineitem) lands on one rank.  The
# exchange is skew-aware: heavy key hashes are found in a gathered sample,
# their probe rows go round-robin and their (few) build rows to every rank
# -- the broadcast-skew join.

SKEW_K = 8          # most heavy hash values tracked per exchange
SKEW_SAMPLE = 256   # key-hash samples per rank
HASH_SENTINEL = 0xFFFFFFFF


def detect_heavy_hashes(ctx: DistContext, h: torch.Tensor,
                        mask: torch.Tensor, k: int = SKEW_K) -> torch.Tensor:
    """The top-k overrepresented key hashes, the same on every rank and
    equal to the JAX package's for the same rows: up to SKEW_SAMPLE
    strided samples per rank are gathered and sorted, and a hash whose
    run reaches half a rank's fair share of them (``max(4, total //
    (2 * world))``) is heavy.  Returns int64 [k], padded with
    HASH_SENTINEL; heavier first, a tie by the smaller hash."""
    n = h.shape[0]
    dev = h.device
    s = min(SKEW_SAMPLE, n)
    step = max(n // max(s, 1), 1) | 1  # odd: never aliases deflate's % world
    buf = torch.full((SKEW_SAMPLE + 1,), HASH_SENTINEL, dtype=torch.int64,
                     device=dev)
    if s:
        idx = (torch.arange(s, device=dev) * step) % n
        buf[:s] = torch.where(mask[idx], h[idx].to(torch.int64),
                              HASH_SENTINEL)
    buf[SKEW_SAMPLE] = s
    every = _gather_equal(ctx, buf).reshape(ctx.mesh.world, SKEW_SAMPLE + 1)
    total = every[:, SKEW_SAMPLE].sum()
    sg = torch.sort(every[:, :SKEW_SAMPLE].reshape(-1)).values
    counts = (torch.searchsorted(sg, sg, right=True)
              - torch.searchsorted(sg, sg))
    is_start = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                          sg[1:] != sg[:-1]])
    thresh = torch.clamp(total // (2 * ctx.mesh.world), min=4)
    cand = torch.where(is_start & (sg != HASH_SENTINEL) & (counts >= thresh),
                       counts, 0)
    top = torch.sort(cand, descending=True, stable=True)
    topv, topi = top.values[:k], top.indices[:k]
    return torch.where(topv > 0, sg[topi], HASH_SENTINEL)


def _hash_in(h: torch.Tensor, heavy: torch.Tensor) -> torch.Tensor:
    return ((h.to(torch.int64)[:, None] == heavy[None, :])
            & (heavy != HASH_SENTINEL)[None, :]).any(dim=1)


def repartition_skew(ctx: DistContext, chunk: Chunk,
                     keys: Sequence[torch.Tensor],
                     heavy: torch.Tensor) -> Chunk:
    """FIXED_HASH with heavy-key splitting: a row of a heavy hash goes
    round-robin (offset by this rank, so destinations interleave), any
    other to ``hash % world``.  Only for a consumer that tolerates a key
    on several ranks: a join's probe side whose heavy build rows are on
    every rank."""
    w = ctx.mesh.world
    h = hash_keys(keys)
    hot = _hash_in(h, heavy)
    rr = (torch.cumsum(hot.to(torch.int64), 0) - 1 + ctx.mesh.rank) % w
    return route_chunk(ctx, chunk, torch.where(hot, rr, h % w))


def gather_compact(ctx: DistContext, chunk: Chunk,
                   sel: torch.Tensor) -> Chunk:
    """The selected live rows of every rank on every rank (the broadcast
    half of the skew join); exact sizes, so no cap."""
    return allgather_chunk(ctx, Chunk(chunk.cols, chunk.mask & sel))


def block_deflate_chunk(ctx: DistContext, chunk: Chunk) -> Chunk:
    """Replicated → sharded, order-preserving: rank k keeps the k-th
    contiguous block of rows, so the rank-major concatenation is the
    replicated chunk's order."""
    m = ctx.mesh
    n = chunk.n_rows
    per = -(-n // m.world)
    i = torch.arange(n, device=chunk.mask.device)
    return Chunk(chunk.cols, chunk.mask & (i >= m.rank * per)
                 & (i < (m.rank + 1) * per))


def sharded_limit(ctx: DistContext, chunk: Chunk, n: int) -> Chunk:
    """LIMIT over a sharded chunk without gathering it: rows rank
    globally in rank-major mask order (one gather of the live counts,
    read on the device)."""
    counts = _gather_equal(ctx, chunk.mask.sum().reshape(1).to(torch.int64))
    before = counts[:ctx.mesh.rank].sum()
    rank = torch.cumsum(chunk.mask.to(torch.int64), 0) - 1 + before
    return Chunk(chunk.cols, chunk.mask & (rank < n))


def deflate_chunk(ctx: DistContext, chunk: Chunk) -> Chunk:
    """Replicated → sharded: rank r keeps the rows whose index is r modulo
    the world (routing a replicated chunk as it is would send world
    copies of every row)."""
    m = ctx.mesh
    mine = torch.arange(chunk.n_rows, device=chunk.mask.device) \
        % m.world == m.rank
    return Chunk(chunk.cols, chunk.mask & mine)


def _route_keys(cols: Sequence[DCol], nulls_together: bool):
    """Routing key tensors of key columns, equal for equal values whatever
    a rank's dictionaries or widths: a string's ``value_hash`` (its own
    bytes), else ``physical._col_keys``.  With ``nulls_together`` (GROUP
    BY, PARTITION BY), a nullable key adds its validity and zeroes its
    NULL rows, so all NULLs route to one rank."""
    out: List[torch.Tensor] = []
    for c in cols:
        keys = ([PH.value_hash(c)] if c.kind in (DICT, BYTES)
                else PH._col_keys(c))
        if nulls_together and c.validity is not None:
            out.append(c.validity.to(torch.int64))
            keys = [torch.where(c.validity, k, 0) for k in keys]
        out.extend(keys)
    return out


def _group_route_keys(chunk: Chunk, exprs) -> List[torch.Tensor]:
    return _route_keys([eval_expr(e, chunk) for e in exprs], True)


# ---------------------------------------------------------------- the walk

def _local(plan: PhysOp, ctx: DistContext, **inputs) -> Chunk:
    """``plan``'s own operator (``physical.execute``) over chunks already
    on this rank, given by child field name."""
    return PH.execute(dataclasses.replace(
        plan, **{f: PhysMaterial(c) for f, c in inputs.items()}), ctx)


def _node_exprs(plan: PhysOp):
    if isinstance(plan, PhysFilter):
        return [plan.predicate]
    if isinstance(plan, PhysProject):
        return [e for _, e in plan.projections]
    if isinstance(plan, PhysHashAggregate):
        return [e for _, e in plan.groups] + [
            x for s in plan.aggs for x in (s.arg, s.arg2) if x is not None]
    if isinstance(plan, PhysHashJoin):
        return list(plan.probe_keys + plan.build_keys) + (
            [plan.filter] if plan.filter is not None else [])
    if isinstance(plan, PhysSort):
        return [e for e, _ in plan.keys]
    if isinstance(plan, PhysWindow):
        return list(plan.partition) + [e for e, _ in plan.order] + [
            s.arg for s in plan.functions if s.arg is not None]
    if isinstance(plan, (PhysGroupId,)):
        return [e for _, e in plan.keys]
    if isinstance(plan, PhysUnnest):
        return list(plan.exprs)
    return []


def execute_distributed(plan: PhysOp, ctx: DistContext):
    """Run ``plan`` on this rank: returns (chunk, replicated).
    ``replicated`` says the chunk is the same on every rank (so an
    exchange never gathers it twice: the role of ActualProperties in
    ``AddExchanges.java``); otherwise it is this rank's shard."""
    if ctx.mesh.world > 1:
        refuse_row_numbering(_node_exprs(plan), "a multi-rank plan")
    if isinstance(plan, PhysScan):
        return ctx.datasource.scan(plan.table, plan.columns,
                                   plan.alias_prefix), False
    if isinstance(plan, PhysMaterial):
        return plan.chunk, True
    if isinstance(plan, (PhysFilter, PhysProject, PhysGroupId, PhysUnnest)):
        child, rep = execute_distributed(plan.child, ctx)
        return _local(plan, ctx, child=child), rep  # row-local
    if isinstance(plan, PhysHashJoin):
        return _dist_join(plan, ctx)
    if isinstance(plan, PhysHashAggregate):
        return _dist_agg(plan, ctx)
    if isinstance(plan, PhysSort):
        return _dist_sort(plan, ctx)
    if isinstance(plan, PhysLimit):
        child, rep = execute_distributed(plan.child, ctx)
        if rep:
            return PH._exec_limit(child, plan.n), True
        return sharded_limit(ctx, child, plan.n), False
    if isinstance(plan, PhysConcat):
        parts = [execute_distributed(c, ctx) for c in plan.inputs]
        reps = {r for _, r in parts}
        if len(reps) > 1:
            # a mixed UNION: each replicated branch deflated, so every
            # branch is sharded (a UNION's output is unordered)
            parts = [(deflate_chunk(ctx, c) if r else c, False)
                     for c, r in parts]
        return PH.concat_chunks([c for c, _ in parts]), parts[0][1]
    if isinstance(plan, PhysWindow):
        child, rep = execute_distributed(plan.child, ctx)
        if not rep and plan.partition:
            # partitions are independent: routed by their keys, each
            # computed on one rank
            routed = repartition(ctx, child,
                                 _group_route_keys(child, plan.partition))
            return PH.window(routed, plan), False
        return PH.window(child if rep else allgather_chunk(ctx, child),
                         plan), True
    if isinstance(plan, PhysScalarBind):
        child, rep = execute_distributed(plan.child, ctx)
        subs = []
        for name, sub in plan.bindings:
            sc, srep = execute_distributed(sub, ctx)
            subs.append((name, PhysMaterial(
                sc if srep else allgather_chunk(ctx, sc))))
        return PH._exec_scalar_bind(dataclasses.replace(
            plan, child=PhysMaterial(child), bindings=tuple(subs)), ctx), rep
    raise NotImplementedError(
        f"distributed execution of {type(plan).__name__}")


def _dynamic_filter(ctx: DistContext, plan: PhysHashJoin, probe: Chunk,
                    build: Chunk) -> Chunk:
    """Before a PARTITIONED exchange, narrow an inner or semi join's probe
    to the build keys' global [min, max] (one gather of every rank's
    pair, read on the device): rows that cannot match never travel
    (reference: ``DynamicFilterSourceOperator``)."""
    if plan.kind not in ("inner", "semi") or len(plan.probe_keys) != 1:
        return probe
    pk = eval_expr(plan.probe_keys[0], probe)
    bk = eval_expr(plan.build_keys[0], build)
    if pk.kind != PLAIN or bk.kind != PLAIN or pk.values.dim() != 1 \
            or bk.values.dim() != 1 or pk.values.is_floating_point() \
            or bk.values.is_floating_point():
        return probe
    bmask = build.mask & bk.valid_or_true()
    bv = bk.values.to(torch.int64)
    pair = torch.stack([A.g_min(bv, bmask), -A.g_max(bv, bmask).clamp(
        min=-A.I64_MAX)])
    lo_hi = _gather_equal(ctx, pair).reshape(ctx.mesh.world, 2).amin(0)
    pv = pk.values.to(torch.int64)
    return Chunk(probe.cols, probe.mask & (pv >= lo_hi[0])
                 & (pv <= -lo_hi[1]))


def _exchange_join_inputs(ctx: DistContext, plan: PhysHashJoin,
                          probe: Chunk, prep: bool, build: Chunk,
                          brep: bool):
    """The join's exchange: REPLICATED gathers the build side;
    PARTITIONED routes both sides by the join keys, so that the build
    and probe rows of a key meet on one rank (AddExchanges'
    partitionedExchange), heavy probe keys split round-robin with their
    build rows on every rank (sound for every join kind: a split probe
    row meets each build row of its key exactly once).  Returns (probe,
    build, output replicated)."""
    if plan.dist_type != "partitioned" or brep:
        return probe, build if brep else allgather_chunk(ctx, build), prep
    if prep:
        probe = deflate_chunk(ctx, probe)
    probe = _dynamic_filter(ctx, plan, probe, build)
    pkeys = _route_keys([eval_expr(e, probe) for e in plan.probe_keys],
                        False)
    bkeys = _route_keys([eval_expr(e, build) for e in plan.build_keys],
                        False)
    heavy = detect_heavy_hashes(ctx, hash_keys(pkeys), probe.mask)
    if not PH._sync_int(ctx, (heavy != HASH_SENTINEL).sum()):
        return (repartition(ctx, probe, pkeys),
                repartition(ctx, build, bkeys), False)
    probe = repartition_skew(ctx, probe, pkeys, heavy)
    hot = _hash_in(hash_keys(bkeys), heavy)
    cold = repartition(ctx, Chunk(build.cols, build.mask & ~hot), bkeys)
    return probe, PH.concat_chunks([cold, gather_compact(ctx, build, hot)]), \
        False


def _dist_join(plan: PhysHashJoin, ctx: DistContext):
    probe, prep = execute_distributed(plan.probe, ctx)
    build, brep = execute_distributed(plan.build, ctx)
    if plan.kind == "full":
        # a rank's unmatched build rows are the query's only under a key
        # partitioning; kept out, as in the JAX package
        raise NotImplementedError("distributed FULL JOIN")
    probe, build, rep = _exchange_join_inputs(ctx, plan, probe, prep, build,
                                              brep)
    ctx.build_rows.append(build.n_rows)
    if plan.kind != "mark":
        return _local(plan, ctx, probe=probe, build=build), rep
    # a mark join's NULL build keys set its has-null flag; under a
    # partitioned exchange they live on one rank, so the flag is OR-ed
    # across ranks
    pk, bk = PH._join_key_arrays(plan, probe, build)
    nn, has_null = PH.mark_build_nn(plan, build)
    if plan.dist_type == "partitioned" and not brep:
        has_null = _gather_equal(
            ctx, has_null.reshape(1).to(torch.int64)).any()
    capacity = HT.capacity_for(max(PH._sync_int(ctx, build.mask.sum()), 1))
    return PH._join_mark(plan, probe, pk, HT.build(bk, nn, capacity),
                         has_null), rep


# aggregates whose state is no mergeable value: every row of a group must
# land on one rank (FIXED_HASH by group keys, as DISTINCT does);
# approx_percentile also goes whole above _QSKETCH_MAX_NDV groups, where
# its [groups, k] sample state would dwarf the data
_WHOLE_GROUP_FUNCS = frozenset({"min_by", "max_by", "min_n", "max_n"})
_QSKETCH_MAX_NDV = 4096


def _needs_whole_group(spec: AggSpec, ndv_hint: int) -> bool:
    if spec.distinct or spec.func in _WHOLE_GROUP_FUNCS \
            or spec.func in PH.NESTED_AGGS:
        return True
    if spec.func == "approx_percentile":
        return ndv_hint > _QSKETCH_MAX_NDV or not sketchable(spec)
    return spec.func not in STATE_FUNCS


def _global_gathers(spec: AggSpec) -> bool:
    """A global aggregate with no mergeable state (DISTINCT, the order
    statistics, the nested packs) needs all its rows together."""
    return spec.distinct or spec.func not in STATE_FUNCS


def _dist_agg(plan: PhysHashAggregate, ctx: DistContext):
    child, rep = execute_distributed(plan.child, ctx)
    if rep:
        return _local(plan, ctx, child=child), True
    if not plan.groups:
        if any(_global_gathers(s) for s in plan.aggs):
            return _local(plan, ctx, child=allgather_chunk(ctx, child)), True
        return _global_partial_final(plan, child, ctx), True
    if any(_needs_whole_group(s, plan.ndv_hint) for s in plan.aggs):
        routed = repartition(ctx, child, _group_route_keys(
            child, [e for _, e in plan.groups]))
        return _local(plan, ctx, child=routed), False
    return _partial_final(plan, child, ctx), False


def _grown(ctx: DistContext, step, rows: int, ndv_hint: int):
    """``step(capacity)``'s result at the least capacity whose group
    table does not overflow: from the hint, bounded by the rows, doubled
    on each overflow (each check a host read)."""
    capacity = max(64, HT.capacity_for(min(ndv_hint, rows + 1)))
    while True:
        out = step(capacity)
        if out[-1] is None or not PH._sync_int(ctx, out[-1]):
            return out
        capacity *= 2


def _partial_final(plan: PhysHashAggregate, child: Chunk,
                   ctx: DistContext) -> Chunk:
    """PARTIAL states on each rank, routed by group keys (the
    reference's partitioned exchange between PARTIAL and FINAL,
    ``PushPartialAggregationThroughExchange``), merged on the rank that
    owns the group.  The result stays sharded."""
    k = Q.k_for(HT.capacity_for(max(plan.ndv_hint, 1)))  # same on every rank
    live = PH._sync_int(ctx, child.mask.sum())
    partial, specs, _ = _grown(
        ctx, lambda cap: partial_agg_states(plan, child, cap, k), live,
        plan.ndv_hint)
    gkeys = [partial.cols[n] for n, _ in plan.groups]
    routed = repartition(ctx, partial, _route_keys(gkeys, True))
    out, _ = _grown(ctx, lambda cap: merge_agg_states(plan, routed, specs,
                                                      cap),
                    routed.n_rows, plan.ndv_hint)
    return PH._maybe_compact(out, ctx)


def _global_partial_final(plan: PhysHashAggregate, child: Chunk,
                          ctx: DistContext) -> Chunk:
    """A global aggregation: one-row partials on each rank, gathered
    everywhere and merged (the JAX package's ``_traced_global_agg``);
    an integer sum's partial is ``masked_sum``'s."""
    partial, specs, _ = partial_agg_states(plan, child, 1)
    rows = allgather_chunk(ctx, partial)
    dev = rows.mask.device
    slot = torch.zeros((rows.n_rows,), dtype=torch.int32, device=dev)
    one = torch.ones((1,), dtype=torch.bool, device=dev)
    merged = {s: merge_state(f, rows.cols[s], rows, slot, 1, one)
              for s, f in specs}
    return Chunk({spec.name: _finalize_agg(spec, merged, one)
                  for spec in plan.aggs}, one)


# below this limit a sort of a sharded input is a partial TopN (k rows
# per rank merged); above it, a sample-based range partitioning
TOPN_PARTIAL_LIMIT = 1 << 16
SORT_SAMPLE = 128  # key samples per rank for a range sort's splitters


def _dist_sort(plan: PhysSort, ctx: DistContext):
    child, rep = execute_distributed(plan.child, ctx)
    if rep:
        return _local(plan, ctx, child=child), True
    if plan.limit is not None and plan.limit <= TOPN_PARTIAL_LIMIT:
        # sort and limit below the exchange, merge k * world rows
        # (``CreatePartialTopN``, ``operator/TopNOperator.java:37``)
        top = _local(plan, ctx, child=child)
        return _local(plan, ctx, child=allgather_chunk(ctx, top)), True
    return _range_sort(plan, child, ctx), False


def _range_sort(plan: PhysSort, child: Chunk, ctx: DistContext) -> Chunk:
    """A full sort of a sharded input: every rank computes the same
    splitters from a gathered sample of the sort keys (a global row id,
    rank-major, breaks ties, so runs of equal keys still spread), routes
    each row to the rank owning its key range and sorts there; the
    rank-major concatenation is the global order and stays sharded
    (reference: ``docs/admin/dist-sort.rst``)."""
    m = ctx.mesh
    chunk = _agree(ctx, child)  # one dictionary order, one byte width
    n = chunk.n_rows
    dev = chunk.mask.device
    normed = [torch.where(chunk.mask, ~a.to(torch.int64) if desc
                          else a.to(torch.int64), SORT.I64_MAX)
              for a, desc in PH._sort_key_arrays(chunk, plan.keys)]
    normed.append(torch.arange(n, dtype=torch.int64, device=dev)
                  + (m.rank << 40))
    sample = torch.full((SORT_SAMPLE, len(normed)), SORT.I64_MAX,
                        dtype=torch.int64, device=dev)
    if n:
        idx = (torch.arange(SORT_SAMPLE, device=dev)
               * max(n // SORT_SAMPLE, 1)) % n
        sample = torch.stack([a[idx] for a in normed], dim=1)
    every = _gather_equal(ctx, sample)
    order = SORT.argsort_multi([(every[:, j], False)
                                for j in range(len(normed))])
    total = every.shape[0]
    dest = torch.zeros((n,), dtype=torch.int64, device=dev)
    for i in range(1, m.world):
        pivot = every[order[(i * total) // m.world]]
        dest += PH._lex_ge(normed, list(pivot)).to(torch.int64)
    out = PH._sort(_route(ctx, chunk, dest), plan.keys)
    if plan.limit is not None:
        out = sharded_limit(ctx, out, plan.limit)
    return out


# ---------------------------------------------------------------- the runner

_WHOLE_TABLES = ("region", "nation")  # generated whole, split by rows


class ShardSource(DataSource):
    """A rank's data source: of each table it scans, caches and accounts
    only its split, ``splits(table, world)[rank]`` of the connector (the
    JAX package's ``_unit_ranges``; partsupp in units of 4), read in
    bounded slices when ``ingest_slice_rows`` is set."""

    def __init__(self, scale_factor: float, device, rank: int, world: int,
                 device_budget_bytes: Optional[int] = None,
                 ingest_slice_rows: Optional[int] = None):
        super().__init__(scale_factor, device, device_budget_bytes,
                         ingest_slice_rows)
        self.rank, self.world = rank, world

    def _split(self, table: str):
        conn, tbl = self._resolve(table)
        return conn.split_manager.splits(tbl, self.world)[self.rank]

    def _read(self, table: str, columns, first: int, count: int) -> dict:
        if table not in _WHOLE_TABLES:
            return super()._read(table, columns, first, count)
        host = super()._read(table, columns, 0, None)
        return {n: c.slice(first, count) for n, c in host.items()}


class DistributedRunner:
    """Runs a statement on every rank of the world in lockstep: each rank
    holds its shard of every table, the plan's exchanges are collectives,
    and each rank returns the whole result (the JAX package's
    ``DistributedRunner``; the reference's coordinator and worker tasks
    collapse into SPMD).  Every rank must call ``run_sql`` with the same
    statements in the same order.

    ``broadcast_row_limit``: a join whose build estimate exceeds it is
    PARTITIONED; ``device_budget_bytes`` and ``ingest_slice_rows`` size
    the rank's pool and its bounded ingest (``exec/datasource.py``);
    ``group`` and ``device`` pick the process group and this rank's
    device (``make_mesh``)."""

    def __init__(self, scale_factor: float = 0.01,
                 broadcast_row_limit: float = 1 << 20,
                 device_budget_bytes: Optional[int] = None,
                 ingest_slice_rows: Optional[int] = None,
                 group=None, device=None):
        self.mesh = make_mesh(device, group)
        self.sf = scale_factor
        self.broadcast_row_limit = broadcast_row_limit
        self.datasource = ShardSource(scale_factor, self.mesh.device,
                                      self.mesh.rank, self.mesh.world,
                                      device_budget_bytes,
                                      ingest_slice_rows)
        self.pool = self.datasource.pool
        self._plan_cache: dict = {}
        self.last_host_syncs = 0       # device → host reads, last statement
        self.last_collectives = 0      # collectives called
        self.last_bytes_exchanged = 0  # bytes this rank sent
        # per-rank build rows of each join of the last statement (the JAX
        # package's static build allocation, ``last_trace_stats``)
        self.last_trace_stats: Optional[dict] = None

    @property
    def ingest_slices(self) -> int:
        """Connector reads of this rank's splits so far."""
        return self.datasource.ingest_slices

    def plan_sql(self, sql: str):
        """(``add_exchanges(prune(optimize(plan)))``, the planner's
        shredded ROW outputs), cached by statement."""
        hit = self._plan_cache.get(sql)
        if hit is None:
            from ..sql.parser import parse
            from ..sql.planner.distribution import add_exchanges
            from ..sql.planner.planner import Planner
            from ..sql.planner.pruning import prune
            from ..sql.planner.rules import optimize
            ds = self.datasource
            planner = Planner(ds.sf, extra_tables=ds.extra_schemas(),
                              extra_stats=ds.extra_stats(),
                              extra_rows=ds.row_fields)
            plan = prune(optimize(planner.plan(parse(sql))), None)
            hit = self._plan_cache[sql] = (
                add_exchanges(plan, self.broadcast_row_limit),
                planner.row_outputs)
        return hit

    def run_physical(self, plan: PhysOp, rows=None) -> Table:
        """Run ``plan`` on this rank; a sharded root is gathered
        rank-major, so every rank materializes the whole result."""
        from ..exec.runner import materialize
        ctx = DistContext(self.datasource, pool=self.pool, mesh=self.mesh)
        out, rep = execute_distributed(plan, ctx)
        if not rep:
            out = allgather_chunk(ctx, out)
        table = materialize(out, ctx, rows)
        self.last_host_syncs = ctx.host_syncs
        self.last_collectives = ctx.collectives
        self.last_bytes_exchanged = ctx.bytes_exchanged
        self.last_trace_stats = {"build_rows": list(ctx.build_rows)}
        return table

    def run_sql(self, sql: str) -> Table:
        plan, rows = self.plan_sql(sql)
        return self.run_physical(plan, rows)
