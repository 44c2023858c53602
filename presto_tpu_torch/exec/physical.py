"""Physical operators, executed one at a time on torch tensors.

Torch port of the operator-at-a-time path of ``presto_tpu/exec/physical.py``
(``execute`` → ``_execute_node``; the reference's operator/driver engine,
``operator/Operator.java:21``).  Each operator consumes whole Chunks and
produces one; selection is a row mask, and where an output size depends on
the data (compaction, group capacity, join table size) the host reads one
scalar from the device — each such read is counted in
``ExecContext.host_syncs`` through ``utils/tracing.host_read``.

Operators ↔ reference:
- PhysScan            ← TableScanOperator + TPC-H / TPC-DS page source
- PhysFilter/Project  ← FilterAndProjectOperator
- PhysHashAggregate   ← HashAggregationOperator
- PhysHashJoin        ← HashBuilderOperator + LookupJoinOperator: unique
                        and expanding builds, inner/left/semi/anti/mark/
                        full, residual filters
- PhysSort/Limit      ← OrderByOperator / Limit
- PhysScalarBind      ← uncorrelated scalar subquery (EnforceSingleRow +
                        join): one host read per binding
- PhysConcat          ← UNION ALL (the union's LocalExchange): layouts
                        harmonised column by column
- PhysWindow          ← WindowOperator + operator/window/: one sort by
                        (partition, order) keys, prefix computations
                        (``ops/window.py``), scattered back to input order
- PhysGroupId         ← GroupIdOperator: each row once per grouping set
- PhysMaterial        ← a chunk already on the device (a streamed slice,
                        merged aggregation states)

The memory tiers: when a join's, aggregation's or sort's working set
(three times its inputs' bytes) passes the pool's remaining budget
(``ExecContext.pool``), the operator runs one partition at a time, k of
them (a power of two, 2-64, from the overshoot), and concatenates the
partitions' outputs (``ExecContext.spill_partitions`` counts them): a
join and an aggregation split rows by the high bits of the key hash
(``ops/hashing.py``), so every key lives in one partition; a sort splits
by sampled range splitters, so the partitions' concatenation is the
order.  The reference spills to disk (``GenericPartitioningSpiller``,
``SpillableHashAggregationBuilder``, ``OrderByOperator``'s sorted runs);
here the input stays on the device and only the partition in flight is
gathered (one stable sort by partition id, one host read of the k
counts).  Mark, full and right joins stay in memory, as in the JAX
package.

Aggregates: count, sum, avg (a DOUBLE for integer and DOUBLE inputs),
the variance family (the JAX package's one-pass formula), min/max of
integers, dates, decimals and DOUBLEs, arbitrary, approx_distinct (HLL
registers, ``ops/hll.py``), count(DISTINCT x) through a second dedup
pass over (group, value) pairs, and ``MORE_FUNCS`` (``_agg_more``, one
code path for grouped and global by ``Groups``/``Whole``): bool_and/or,
bitwise_and/or_agg, checksum, geometric_mean, the corr family, min_by/
max_by and approx_percentile (exact).  A DOUBLE key
(group, join, sort) is its order-preserving int64 image.  A NULL sort key
(ORDER BY and a window's ORDER BY) sorts after every value in both
directions, Trino's default (the JAX package puts it first under DESC,
and its windows order NULLs by whatever value their slots hold).

Join keys compare by value: two DICT keys over different dictionaries
compare their ranks in the sorted union of both, and a string key beside
a BYTES key compares byte packs of one width (the JAX package compares
the codes of different dictionaries).

MATCH_RECOGNIZE (``_exec_match_recognize``) sorts once by (partition,
order) and runs the pattern's DFA over every start row in lockstep
(``ops/pattern.py``).

Nested values: UNNEST (``_exec_unnest``) expands each row once per element
of its longest argument (one host read of the total); array_agg, map_agg,
histogram and min(x, n)/max(x, n) (``_agg_nested``, grouped and global by
``Groups``/``Whole``) pack each group's values into ``[groups, widest]``
(one host read of the width); UNION ALL, joins, LIMIT and GROUPING SETS
carry ARRAY and MAP columns, padded and recoded over one dictionary where
they meet.  An ARRAY or MAP as a group, join, DISTINCT or sort key
raises.

Not ported yet (they raise ``NotImplementedError`` naming the operator or
aggregate): DISTINCT on any aggregate but count.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..data import types as T
from ..data.column import PLAIN, DICT, BYTES, ARRAY, MAP
from ..ops import arrays as AR
from ..ops import agg as A
from ..ops import decimal as DEC
from ..ops import hashing as HASH
from ..ops import hashtable as HT
from ..ops import hll as HLL
from ..ops import int128 as I128
from ..ops import pattern as PT
from ..ops import sort as SORT
from ..ops import window as W
from ..sql import ir
from ..utils.memory import chunk_bytes, col_bytes
from ..utils.tracing import count_reads, host_read, span
from .columns import Chunk, DCol, Dictionary
from .expreval import (_element, _host_strings, _pad_bytes, _rank_in,
                       as_double, dcol_to_bytes, dictionary_bytes, eval_expr,
                       eval_predicate, nested_layouts, refuse_row_numbering,
                       shifted_name)
from .plan import (CORR_FUNCS, VARIANCE_FUNCS, AggSpec, PhysConcat,
                   PhysFilter, PhysGroupId, PhysHashAggregate, PhysHashJoin,
                   PhysLimit, PhysMatchRecognize, PhysMaterial, PhysOp,
                   PhysProject, PhysScalarBind, PhysScan, PhysSort,
                   PhysUnnest, PhysWindow, WindowSpec,
                   _agg_output_type, _scale_of)

SEG_DIRECT_CAP = 512  # largest key domain grouped by its composite code
COMPACT_THRESHOLD = 0.25  # compact a chunk when selectivity falls below
MIN_ROWS_FOR_COMPACTION = 1 << 14
MAX_PARTITIONS = 64  # most partitions one operator splits into
HASH_BLOCK = 1 << 20  # rows hashed at a time for a partition id
SPLITTER_SAMPLE = 4096  # rows sampled for a partitioned sort's splitters


@dataclass
class ExecContext:
    datasource: object                      # DataSource
    host_syncs: int = 0                     # device→host scalar reads
    collect_stats: bool = False             # EXPLAIN ANALYZE mode
    node_stats: Dict[int, dict] = field(default_factory=dict)
    # the pool whose remaining budget sends a join, aggregation or sort
    # to its partition-at-a-time tier (None: always in memory), and the
    # partitions such operators ran
    pool: object = None                     # utils.memory.MemoryPool
    spill_partitions: int = 0

    def __post_init__(self):
        # the reads of expression evaluation, which has no context at
        # hand, count on the newest context of the thread
        count_reads(self)


def _sync_int(ctx: ExecContext, t: torch.Tensor) -> int:
    """Read one device scalar on the host (waits for the device)."""
    with host_read(ctx):
        return int(t.item())


def execute(plan: PhysOp, ctx: ExecContext) -> Chunk:
    """Run ``plan`` as the span ``op:<Operator>`` (``utils/tracing.py``);
    with ``ctx.collect_stats`` (EXPLAIN ANALYZE) also record each node's
    rows, output bytes, and its wall time with and without its children
    (``tree_ms``, ``wall_ms``), fenced by ``torch.cuda.synchronize`` on a
    card (the reference's OperationTimer, ``operator/Driver.java:388`` →
    OperatorStats).  Off, it adds no fence and no host read."""
    with span(plan.op_span):
        if not ctx.collect_stats:
            return _execute_node(plan, ctx)
        device = ctx.datasource.device

        def fence():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        fence()
        t0 = time.perf_counter()
        out = _execute_node(plan, ctx)
        fence()
        wall = (time.perf_counter() - t0) * 1e3
        rows = _sync_int(ctx, out.mask.sum())
        nbytes = sum(col_bytes(c) for c in out.cols.values()) + \
            out.mask.numel()
        self_ms = wall - sum(ctx.node_stats.get(id(c), {}).get("tree_ms", 0.0)
                             for c in plan.children())
        ctx.node_stats[id(plan)] = {"rows": rows,
                                    "wall_ms": max(self_ms, 0.0),
                                    "tree_ms": wall, "bytes": nbytes}
        return out


def _execute_node(plan: PhysOp, ctx: ExecContext) -> Chunk:
    if isinstance(plan, PhysScan):
        return ctx.datasource.scan(plan.table, plan.columns, plan.alias_prefix)
    if isinstance(plan, PhysMaterial):
        return plan.chunk
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
        return _exec_sort(plan, ctx)
    if isinstance(plan, PhysLimit):
        return _exec_limit(execute(plan.child, ctx), plan.n)
    if isinstance(plan, PhysScalarBind):
        return _exec_scalar_bind(plan, ctx)
    if isinstance(plan, PhysConcat):
        return concat_chunks([execute(c, ctx) for c in plan.inputs])
    if isinstance(plan, PhysWindow):
        return window(execute(plan.child, ctx), plan)
    if isinstance(plan, PhysGroupId):
        return _groupid(execute(plan.child, ctx), plan.keys, plan.sets,
                        plan.gid_name)
    if isinstance(plan, PhysMatchRecognize):
        return _exec_match_recognize(plan, ctx)
    if isinstance(plan, PhysUnnest):
        return _exec_unnest(plan, ctx)
    raise NotImplementedError(f"{type(plan).__name__} on the torch path")


# ---------------------------------------------------------------- row shape

# aggregates whose result is no value of their argument (a count, a
# sketch) or is one of its rows gathered whole, offsets included
KEEPS_ZONE = ("count", "count_star", "approx_distinct", "arbitrary",
              "any_value", "min_by", "max_by", "approx_percentile")


def refuse_zoned(c: DCol, what: str) -> None:
    """Raise where an operator would rebuild a TIMESTAMP WITH TIME ZONE
    column from its instants alone, dropping the offsets."""
    if c.values2 is not None:
        raise NotImplementedError(f"{what} of a {c.dtype} column")


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
                       c.dictionary,
                       None if c.values2 is None else c.values2[:n],
                       c.dictionary2)
            for name, c in child.cols.items()}
    return Chunk(cols, child.mask[:n])


def _exec_scalar_bind(plan: PhysScalarBind, ctx: ExecContext) -> Chunk:
    """Each binding's subquery result, read on the host once (its live
    row count, then the first live row's validity and value words in the
    same tensor) and broadcast as a column of the child: NULL when the
    subquery returns no row, an error when it returns more than one."""
    child = execute(plan.child, ctx)
    n = child.n_rows
    dev = child.mask.device
    cols = dict(child.cols)
    for name, sub in plan.bindings:
        sc = execute(sub, ctx)
        if len(sc.cols) != 1:
            raise ValueError(f"scalar subquery {name} returns "
                             f"{len(sc.cols)} columns, not one")
        (c,) = sc.cols.values()
        refuse_zoned(c, "a scalar subquery")
        if c.kind != PLAIN:
            raise NotImplementedError(
                f"scalar subquery of a {c.kind} {c.dtype} column")
        width = 2 if c.values.dim() == 2 else 1
        shape = (n, 2) if width == 2 else (n,)
        dtype = c.values.dtype if c.values.is_floating_point() \
            else torch.int64
        if sc.n_rows:
            first = sc.mask.to(torch.uint8).argmax().reshape(1)
            row = c.take(first)
            # a DOUBLE travels as its bits in the int64 word
            bits = row.values.reshape(-1).to(dtype).view(torch.int64)
            word = torch.cat([sc.mask.sum().reshape(1),
                              row.valid_or_true().to(torch.int64), bits])
            with host_read(ctx):
                word = word.tolist()
        else:
            word = [0]
        if word[0] > 1:
            raise ValueError(f"scalar subquery {name} returned {word[0]} "
                             "rows: it must return at most one")
        if word[0] == 0 or not word[1]:
            vals = torch.zeros(shape, dtype=dtype, device=dev)
            valid = torch.zeros((n,), dtype=torch.bool, device=dev)
        else:
            vals = torch.tensor(word[2:], dtype=torch.int64,
                                device=dev).view(dtype).expand(
                                    n, width).reshape(shape)
            valid = None
        cols[name] = DCol(c.dtype, PLAIN, vals.contiguous(), validity=valid)
    return Chunk(cols, child.mask)


# ---------------------------------------------------------------- keys

def _col_keys(c: DCol) -> List[torch.Tensor]:
    """One column's int64 key tensors: the big-endian packs of a BYTES
    column, both words of a long decimal, the order-preserving bits of a
    DOUBLE, else its values; an ARRAY or MAP raises."""
    _refuse_nested_key(c)
    if c.kind == BYTES:
        return SORT.bytes_sort_keys(c.values, c.lengths)
    if c.values.dim() == 2:
        return [w.contiguous() for w in I128.unpack(c.values)]
    if c.values.is_floating_point():
        return [SORT.f64_sort_key(c.values)]
    return [c.values.to(torch.int64)]


def _refuse_nested_key(c: DCol) -> None:
    if c.kind in (ARRAY, MAP):
        raise NotImplementedError(
            f"an {c.dtype} value as a group, join, DISTINCT or sort key")


def _group_key_arrays(chunk: Chunk, exprs: Sequence) -> List[torch.Tensor]:
    """Key tensors with SQL GROUP BY null semantics: a nullable key adds its
    validity bit as a key and zeroes every key tensor where invalid, so all
    NULLs form ONE group distinct from every real value."""
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
    # lowest row id of each composite code (I64_MAX >= n where none)
    first = A.seg_min(torch.arange(n, device=dev), gid, chunk.mask, prod)
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

def dict_order(c: DCol) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rank of each code, code of each rank) of a DICT column: where its
    dictionary's strings fall in sorted order, as host-built tables on
    the column's device."""
    order = np.argsort(np.array([str(x) for x in c.dictionary.strings],
                                dtype=str), kind="stable").astype(np.int64)
    rank = np.empty_like(order)
    rank[order] = np.arange(order.shape[0])
    if order.shape[0] == 0:
        order = np.zeros(1, np.int64)
    dev = c.values.device
    return torch.from_numpy(rank).to(dev), torch.from_numpy(order).to(dev)


def dict_extreme(c: DCol, reduce, validity, dtype) -> DCol:
    """min or max of a DICT column by string value: each code's rank in
    the sorted dictionary, reduced by ``reduce`` (ranks → the best rank
    of each output row), then mapped back to its code (the JAX package
    reduces the codes themselves)."""
    rank, code = dict_order(c)
    best = reduce(rank[c.values.to(torch.int64)])
    codes = code[best.clamp(0, code.shape[0] - 1)].to(c.values.dtype)
    return DCol(dtype, DICT, codes, validity=validity,
                dictionary=c.dictionary)


def _value_packs(c: DCol) -> List[torch.Tensor]:
    """Integer tensors, most significant first, that order a column's rows
    by value: the packs of a BYTES column, the (hi signed, lo unsigned)
    words of a long decimal, a DICT code's rank among its dictionary's
    strings, a DOUBLE's order-preserving bits, else the values; an ARRAY
    or MAP raises."""
    _refuse_nested_key(c)
    if c.kind == BYTES:
        return SORT.bytes_sort_keys(c.values, c.lengths)
    if c.values.dim() == 2:
        return I128.sort_keys(*I128.unpack(c.values))
    if c.kind == DICT:
        return [dict_order(c)[0][c.values.to(torch.int64)]]
    if c.values.is_floating_point():
        return [SORT.f64_sort_key(c.values)]
    return [c.values]


def _sort_key_arrays(chunk: Chunk, keys) -> List[Tuple[torch.Tensor, bool]]:
    """Sort-key exprs → (integer tensor, descending) pairs; a BYTES key
    gives one pair per 8-byte pack, a long decimal two (``sort_keys``).
    A nullable key is led by its NULL flag, ascending, and its packs are
    zeroed where NULL: NULLs sort after every value in both directions
    and are peers of each other (Trino's default, NULLS LAST)."""
    karrs: List[Tuple[torch.Tensor, bool]] = []
    for e, desc in keys:
        c = eval_expr(e, chunk)
        packs = _value_packs(c)
        if c.validity is not None:
            karrs.append(((~c.validity).to(torch.int8), False))
            packs = [torch.where(c.validity, p, 0) for p in packs]
        karrs.extend((p, desc) for p in packs)
    return karrs


def _sort(chunk: Chunk, keys) -> Chunk:
    perm = SORT.argsort_multi(_sort_key_arrays(chunk, keys), chunk.mask)
    cols = {n: c.take(perm) for n, c in chunk.cols.items()}
    return Chunk(cols, chunk.mask[perm])


def _exec_sort(plan: PhysSort, ctx: ExecContext) -> Chunk:
    child = execute(plan.child, ctx)
    k = _tier_partitions(ctx, 3 * chunk_bytes(child))
    out = (_sort(child, plan.keys) if k == 1
           else _exec_sort_partitioned(plan, child, ctx, k))
    return out if plan.limit is None else _exec_limit(out, plan.limit)


def _lex_ge(arrays: List[torch.Tensor], pivot: List[torch.Tensor]):
    """Row-wise lexicographic (arrays) >= (pivot scalars)."""
    ge = torch.ones_like(arrays[0], dtype=torch.bool)
    out = torch.zeros_like(ge)
    for a, p in zip(arrays, pivot):
        out = out | (ge & (a > p))
        ge = ge & (a == p)
    return out | ge


def _sort_partition_ids(chunk: Chunk, keys, k: int) -> torch.Tensor:
    """Range-partition ids (0..k-1, int16) from splitters sampled over this
    package's own sort keys (``_sort_key_arrays``: a NULL flag leading a
    nullable key, DICT string ranks), each made ascending (a descending
    key complemented) and followed by the row index, so that runs of
    equal keys split deterministically.  Partition p holds the rows
    between splitters p and p + 1, so the partitions in order are the
    sorted order, NULLs last in both directions."""
    n = chunk.n_rows
    normed = []
    for a, desc in _sort_key_arrays(chunk, keys):
        a = a.to(torch.int64)
        normed.append(torch.where(chunk.mask, ~a if desc else a,
                                  SORT.I64_MAX))
    normed.append(torch.arange(n, dtype=torch.int64, device=chunk.mask.device))
    s = min(SPLITTER_SAMPLE, n)
    idx = (torch.arange(s, device=chunk.mask.device)
           * max(n // max(s, 1), 1)) % n
    samples = [a[idx] for a in normed]
    order = SORT.argsort_multi([(g, False) for g in samples])
    part = torch.zeros((n,), dtype=torch.int16, device=chunk.mask.device)
    for i in range(1, k):
        pos = order[(i * s) // k]
        part += _lex_ge(normed, [g[pos] for g in samples]).to(torch.int16)
    return part


def _exec_sort_partitioned(plan: PhysSort, child: Chunk, ctx: ExecContext,
                           k: int) -> Chunk:
    """Sort under the budget: range partitions, each compacted and sorted
    alone, concatenated in order (the reference spills sorted runs and
    merges them, ``operator/OrderByOperator.java`` +
    ``util/MergeSortedPages``; range partitions need no merge)."""
    refuse_row_numbering([e for e, _ in plan.keys], "a partitioned sort")
    part = _sort_partition_ids(child, plan.keys, k)
    ctx.spill_partitions += k
    outs = [_sort(sub, plan.keys) for sub in
            _partition_rows(child, part, k, ctx) if sub is not None]
    return concat_chunks(outs) if outs else _no_rows(child)


# ---------------------------------------------------------------- windows

def _unsort(res: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Values at sorted positions → input row order."""
    out = torch.empty_like(res)
    out[perm] = res
    return out


def window(chunk: Chunk, plan: PhysWindow) -> Chunk:
    """Every window function of one (PARTITION BY, ORDER BY) spec: one
    stable sort by the partition keys (NULLs one partition, as in GROUP
    BY) and the order keys (as in ORDER BY: NULLs last), the functions over
    the sorted positions (``ops/window.py``), each result scattered back
    to input order.  Nothing is sized from the data: no host sync."""
    n = chunk.n_rows
    pk = [(k, False) for k in _group_key_arrays(chunk, plan.partition)]
    keys = pk + _sort_key_arrays(chunk, plan.order) or [(torch.zeros(
        (n,), dtype=torch.int64, device=chunk.mask.device), False)]
    perm = SORT.argsort_multi(keys, chunk.mask)
    smask = chunk.mask[perm]
    part_start, peer_start = W.make_boundaries(
        [k[perm] for k, _ in keys], len(pk), smask)
    pe = W.peer_ends(peer_start)  # default frame end: the peer run's last
    cols = dict(chunk.cols)
    for spec in plan.functions:
        cols[spec.name] = _window_function(spec, chunk, plan, perm, smask,
                                           part_start, peer_start, pe)
    return Chunk(cols, chunk.mask)


def _window_function(spec: WindowSpec, chunk: Chunk, plan: PhysWindow,
                     perm, smask, part_start, peer_start, pe) -> DCol:
    """One window function's column, in input row order (the JAX
    package's ``_window_traced`` loop body); ``pe`` is each sorted
    position's peer-run end."""
    n = chunk.n_rows
    f = spec.func
    if f in ("row_number", "rank", "dense_rank", "ntile"):
        res = (W.row_number(part_start) if f == "row_number" else
               W.rank(part_start, peer_start) if f == "rank" else
               W.dense_rank(part_start, peer_start) if f == "dense_rank"
               else W.ntile(part_start, spec.offset))
        return DCol(T.BIGINT, PLAIN, _unsort(res, perm))
    if f in ("percent_rank", "cume_dist"):
        res = (W.percent_rank if f == "percent_rank" else W.cume_dist)(
            part_start, peer_start)
        return DCol(T.DOUBLE, PLAIN, _unsort(res, perm))
    if f in ("lead", "lag", "first_value", "last_value", "nth_value"):
        # the source row's sorted position, gathered whole from the
        # column: one path for every layout
        c = eval_expr(spec.arg, chunk)
        v = c.valid_or_true()[perm] & smask
        pos_of = torch.arange(n, dtype=torch.int64, device=perm.device)
        if f in ("lead", "lag"):
            off = spec.offset if f == "lead" else -spec.offset
            pos, valid = (W.kth_nonnull_shift(pos_of, v, part_start, off)
                          if spec.ignore_nulls else
                          W.shift_in_partition(pos_of, part_start, off))
        elif f == "nth_value":
            if spec.ignore_nulls:
                pos, valid = W.nth_nonnull(v, part_start, pe, spec.offset)
            else:
                pos = part_start + spec.offset - 1
                valid = pos <= pe
        elif spec.ignore_nulls:
            pos, valid = W.nonnull_frame_edge(v, part_start, pe,
                                              f == "first_value")
        else:
            pos = part_start if f == "first_value" else pe
            valid = torch.ones_like(smask)
        src = perm[pos.clamp(0, max(n - 1, 0))]
        return c.take(_unsort(src, perm), valid=_unsort(valid, perm))
    if f not in ("sum", "count", "min", "max", "avg", "count_star"):
        raise NotImplementedError(f"window function {f}")
    vmask = smask
    if f != "count_star":
        c = eval_expr(spec.arg, chunk)
        if f != "count":
            refuse_zoned(c, f"window {f}")
        vmask = smask & c.valid_or_true()[perm]
    if f in ("count", "count_star"):
        vals, adt = None, T.BIGINT
    elif c.kind != PLAIN or c.values.dtype == torch.bool:
        raise NotImplementedError(
            f"window {f}({c.dtype}, {c.kind}) on the torch path")
    elif c.values.dim() == 2:
        # a long decimal folds to DOUBLE, as in the JAX package and the
        # planner's typing (Trino keeps decimal(38, s))
        vals = I128.to_f64(*I128.unpack(c.values))[perm] \
            / 10 ** _scale_of(c.dtype)
        adt = T.DOUBLE
    else:
        vals = c.values[perm]
        vals = vals.to(torch.float64 if vals.is_floating_point()
                       else torch.int64)
        adt = c.dtype
    ones = vmask.to(torch.int64)
    if spec.frame is not None:
        lo, hi = _frame_lo_hi(spec.frame, chunk, plan, perm, part_start,
                              peer_start)
        cnt = W.framed_sum(ones, smask, lo, hi)
    elif plan.order:
        # default frame: RANGE UNBOUNDED PRECEDING → CURRENT ROW, peers
        # included → the running value gathered at the peer run's end
        cnt = W.running_sum(ones, part_start, smask)[pe]
    else:
        cnt = W.partition_total(ones, part_start, vmask, "count")
    if f in ("count", "count_star"):
        return DCol(T.BIGINT, PLAIN, _unsort(cnt, perm))
    valid = _unsort(cnt > 0, perm)
    if f in ("min", "max"):
        mx = f == "max"
        if vals.is_floating_point():
            sentinel = float("-inf") if mx else float("inf")
        else:
            sentinel = A.I64_MIN if mx else A.I64_MAX
        if spec.frame is not None and spec.frame[1][0] != \
                "unbounded_preceding":
            raise NotImplementedError(
                "min/max frames must start UNBOUNDED PRECEDING")
        if spec.frame is not None or plan.order:
            run = W.segmented_cummin(torch.where(vmask, vals, sentinel),
                                     part_start, maximum=mx)
            res = run[hi.clamp(0, max(n - 1, 0))] if spec.frame is not None \
                else run[pe]
        else:
            res = W.partition_total(vals, part_start, vmask, f)
        if c.values.dim() == 1:
            res = res.to(c.values.dtype)
        return DCol(adt, PLAIN, _unsort(res, perm), validity=valid)
    if spec.frame is not None:
        tot = W.framed_sum(vals, vmask, lo, hi)
    elif plan.order:
        tot = W.running_sum(vals, part_start, vmask)[pe]
    else:
        tot = W.partition_total(vals, part_start, vmask, "sum")
    if f == "avg":
        res = (tot / cnt.clamp_min(1) if isinstance(adt, T.DoubleType)
               else DEC.div_round_half_up(tot, cnt.clamp_min(1)))
        return DCol(adt, PLAIN, _unsort(res, perm), validity=valid)
    if isinstance(adt, T.DoubleType):
        ot = T.DOUBLE
    elif T.is_decimal(adt):
        # int64 accumulator, as in the JAX package; decimal(38, s) is
        # two words in this package
        ot = T.decimal(38, _scale_of(adt))
        tot = I128.pack(*I128.from_i64(tot))
    else:
        ot = T.BIGINT
    return DCol(ot, PLAIN, _unsort(tot, perm), validity=valid)


def _frame_lo_hi(frame, chunk: Chunk, plan: PhysWindow, perm, part_start,
                 peer_start):
    """[lo, hi] sorted-position bounds of an explicit ROWS, GROUPS or
    RANGE frame."""
    if frame[0] == "rows":
        return W.frame_bounds(part_start, frame)
    if frame[0] == "groups":
        if not plan.order:
            raise ValueError("GROUPS frame requires ORDER BY")
        return W.groups_frame_bounds(part_start, peer_start, frame)
    # RANGE: CURRENT ROW spans the peer run; value offsets need the
    # single integer-valued ORDER BY key
    offsets = {frame[1][0], frame[2][0]} & {"preceding", "following"}
    if not offsets:
        return W.range_frame_bounds(part_start, peer_start,
                                    torch.zeros_like(part_start), frame,
                                    False)
    if len(plan.order) != 1:
        raise NotImplementedError(
            "RANGE frames require exactly one ORDER BY key")
    oexpr, desc = plan.order[0]
    oc = eval_expr(oexpr, chunk)
    if oc.kind != PLAIN or oc.values.dim() != 1 \
            or oc.values.is_floating_point() or oc.values.dtype == torch.bool:
        raise NotImplementedError(
            "RANGE frames require an integer-valued order key")
    if oc.validity is not None:
        raise NotImplementedError(
            "RANGE value offsets over a nullable order key")
    scale = 10 ** _scale_of(oc.dtype) if T.is_decimal(oc.dtype) else 1

    def scaled(spec):
        which, k = spec
        return (which, None if k is None else int(k) * scale)

    return W.range_frame_bounds(part_start, peer_start, oc.values[perm],
                                (frame[0], scaled(frame[1]),
                                 scaled(frame[2])), desc)


# ---------------------------------------------------------------- row patterns

def _exec_match_recognize(plan: PhysMatchRecognize,
                          ctx: ExecContext) -> Chunk:
    """MATCH_RECOGNIZE, ONE ROW or ALL ROWS PER MATCH, AFTER MATCH SKIP
    PAST LAST ROW (the JAX package's ``_exec_match_recognize``): one
    stable sort by the partition keys (NULLs one partition, as in GROUP
    BY) and the order keys (as in ORDER BY), the PREV/NEXT columns (NULL
    across a partition's edge), each DEFINE predicate one bit of a row's
    code, the DFA over every start and the skips (``ops/pattern.py``),
    then the measures over the sorted rows.  ``match_number()`` counts
    the matches of each partition from 1 (the JAX package counts them
    across the whole input).  Host reads: the compaction, the pattern's
    early stops and partition count, the window check."""
    child = _maybe_compact(execute(plan.child, ctx), ctx)
    n = child.n_rows
    dev = child.mask.device
    pk = [(k, False) for k in _group_key_arrays(child, plan.partition)]
    keys = pk + _sort_key_arrays(child, plan.order) or [(torch.zeros(
        (n,), dtype=torch.int64, device=dev), False)]
    perm = SORT.argsort_multi(keys, child.mask)
    smask = child.mask[perm]
    part_start, _ = W.make_boundaries([k[perm] for k, _ in keys], len(pk),
                                      smask)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    cols = {name: c.take(perm) for name, c in child.cols.items()}
    for _, pred in plan.defines:
        for sub in ir.walk(pred):
            name = isinstance(sub, ir.Shifted) and shifted_name(sub)
            if name and name not in cols:
                src = idx + sub.offset
                at = src.clamp(0, max(n - 1, 0))
                cols[name] = cols[sub.arg.name].take(at, valid=(
                    (src >= 0) & (src < n) & smask[at]
                    & (part_start[at] == part_start)))
    rows = Chunk(cols, smask)
    code = torch.zeros((n,), dtype=torch.int32, device=dev)
    for i, (_, pred) in enumerate(plan.defines):
        hit = eval_predicate(pred, rows) & smask
        code = code | (hit.to(torch.int32) << i)
    code = torch.where(smask, code, -1)
    compiled = PT.compile_pattern(plan.pattern, [s for s, _ in plan.defines])

    def read(t):
        return _sync_int(ctx, t)
    new_part = part_start == idx
    mlen = PT.match_lengths(code, new_part, compiled, plan.window, read)
    sel = PT.select_matches(mlen, smask, new_part, read)
    if read((sel & (mlen >= plan.window)).any()):
        raise NotImplementedError(
            f"match exceeds the {plan.window}-row window bound")
    taken = torch.cumsum(sel.to(torch.int64), 0)
    # the matches before each row's partition, subtracted
    mno = taken - (taken - sel.to(torch.int64))[part_start]
    mlen = mlen.to(torch.int64)
    out = {pe.name: cols[pe.name] for pe in plan.partition}
    if plan.all_rows:
        # ALL ROWS PER MATCH: a row belongs to the latest match started at
        # or before it that still covers it; RUNNING measures (count =
        # rows so far, last = the current row)
        s_r = torch.cummax(torch.where(sel, idx, -1), 0).values
        s_c = s_r.clamp(0, max(n - 1, 0))
        keep = ((s_r >= 0) & (idx < s_r + mlen[s_c])
                & (part_start[s_c] == part_start) & smask)
        for mname, func, arg in plan.measures:
            if func == "count":
                out[mname] = DCol(T.BIGINT, PLAIN, idx - s_r + 1)
            elif func == "match_number":
                out[mname] = DCol(T.BIGINT, PLAIN, mno[s_c])
            elif func == "first":
                out[mname] = eval_expr(arg, rows).take(s_c, valid=keep)
            else:
                out[mname] = eval_expr(arg, rows)
        for name in plan.passthrough:
            out[name] = cols[name]
        return _maybe_compact(Chunk(out, keep), ctx)
    last = (idx + mlen - 1).clamp(0, max(n - 1, 0))
    for mname, func, arg in plan.measures:
        if func == "count":
            out[mname] = DCol(T.BIGINT, PLAIN, mlen)
        elif func == "match_number":
            out[mname] = DCol(T.BIGINT, PLAIN, mno)
        elif func == "first":
            out[mname] = eval_expr(arg, rows)
        else:
            out[mname] = eval_expr(arg, rows).take(last, valid=sel)
    return _maybe_compact(Chunk(out, sel & smask), ctx)


# ---------------------------------------------------------------- grouping sets

def _groupid(chunk: Chunk, keys, sets, gid_name: str) -> Chunk:
    """GROUPING SETS row expansion: output row ``r*S + j`` is input row
    ``r`` under grouping set ``j``.  A key column's copy is NULL where set
    ``j`` leaves the key out; ``gid_name`` carries the set ordinal.  The
    output is ``S`` times the input and no shape depends on the data."""
    n, s = chunk.n_rows, len(sets)
    dev = chunk.mask.device
    rep = torch.arange(n, device=dev).repeat_interleave(s)
    setid = torch.arange(s, device=dev).repeat(n)
    copies = Chunk({name: c.take(rep) for name, c in chunk.cols.items()},
                   chunk.mask[rep])
    cols = dict(copies.cols)
    member = torch.tensor(sets, dtype=torch.bool, device=dev).reshape(s, -1)
    for ki, (out_name, e) in enumerate(keys):
        # over the copies: a key that is a column shares their tensors
        kc = eval_expr(e, copies)
        part = member[setid, ki]
        cols[out_name] = DCol(kc.dtype, kc.kind, kc.values, kc.lengths,
                              part if kc.validity is None
                              else kc.validity & part, kc.dictionary,
                              kc.values2, kc.dictionary2)
    cols[gid_name] = DCol(T.BIGINT, PLAIN, setid.to(torch.int64))
    return Chunk(cols, copies.mask)


# ---------------------------------------------------------------- memory tiers

def _tier_partitions(ctx: ExecContext, need: int) -> int:
    """1 when ``need`` bytes of working set fit the pool's remaining
    budget (or there is no budget), else the power of two of partitions,
    2 to MAX_PARTITIONS, that brings one partition's share under it."""
    pool = ctx.pool
    if pool is None or pool.budget is None:
        return 1
    avail = max(pool.budget - pool.used, 1)
    if need <= avail:
        return 1
    return min(max(2, HT.next_pow2(-(-need // avail))), MAX_PARTITIONS)


def _hash_partition(keys: List[torch.Tensor], k: int) -> torch.Tensor:
    """Partition id in [0, k) of each row, int16: the high bits of the
    keys' uint32 hash, independent of the low bits a table might use.
    Hashed HASH_BLOCK rows at a time, so that the hash's int64
    temporaries never span the whole input."""
    shift = 32 - max(k.bit_length() - 1, 1)
    n = keys[0].shape[0]
    return torch.cat([
        (HASH.hash_keys([x[i:i + HASH_BLOCK] for x in keys]) >> shift).to(
            torch.int16) for i in range(0, max(n, 1), HASH_BLOCK)])


def _partition_rows(chunk: Chunk, part: torch.Tensor, k: int,
                    ctx: ExecContext):
    """The live rows of each partition 0..k-1 in turn, each compacted in
    row order (None for an empty one): one stable sort by the int16
    partition id and one host read of the k counts, a partition gathered
    only when its turn comes."""
    pid = torch.where(chunk.mask, part, k)
    del part  # the ids live on only in the order and the sizes
    order = torch.sort(pid, stable=True).indices
    sizes = torch.bincount(pid, minlength=k + 1)[:k]
    with host_read(ctx):
        sizes = sizes.tolist()
    del pid
    start = 0
    for size in sizes:
        idx = order[start:start + size]
        start += size
        yield None if size == 0 else Chunk(
            {n: c.take(idx) for n, c in chunk.cols.items()},
            torch.ones((size,), dtype=torch.bool, device=order.device))


def _no_rows(chunk: Chunk) -> Chunk:
    """A one-row chunk of ``chunk``'s columns with its row masked out (an
    operator's input when a partitioned run leaves nothing)."""
    if chunk.n_rows == 0:
        return chunk
    zero = torch.zeros((1,), dtype=torch.int64, device=chunk.mask.device)
    return Chunk({n: c.take(zero) for n, c in chunk.cols.items()},
                 torch.zeros((1,), dtype=torch.bool, device=zero.device))


# ---------------------------------------------------------------- aggregation

def _exec_agg(plan: PhysHashAggregate, ctx: ExecContext) -> Chunk:
    child = execute(plan.child, ctx)
    for spec in plan.aggs:
        if spec.distinct and spec.func != "count":
            raise NotImplementedError(
                f"{spec.func}(DISTINCT) on the torch path")
    if not plan.groups:
        return _exec_global_agg(plan, child, ctx)
    k = _tier_partitions(ctx, 3 * chunk_bytes(child))
    if k > 1:
        return _exec_agg_partitioned(plan, child, ctx, k)
    return _agg_core(plan, child, ctx)


def _exec_agg_partitioned(plan: PhysHashAggregate, child: Chunk,
                          ctx: ExecContext, k: int) -> Chunk:
    """Aggregation under the budget: rows split by the high bits of the
    group-key hash, so each group lives in one partition and the
    partitions' results concatenate with no merge (the reference's
    ``SpillableHashAggregationBuilder`` spills by group hash and merges;
    here the merge is designed away)."""
    refuse_row_numbering([e for _, e in plan.groups]
                         + [x for s in plan.aggs for x in (s.arg, s.arg2)
                            if x is not None], "a partitioned aggregation")
    part = _hash_partition(_group_key_arrays(
        child, tuple(e for _, e in plan.groups)), k)
    ctx.spill_partitions += k
    outs = [_agg_core(plan, sub, ctx) for sub in
            _partition_rows(child, part, k, ctx) if sub is not None]
    return concat_chunks(outs) if outs else _agg_core(plan, _no_rows(child),
                                                       ctx)


def _agg_core(plan: PhysHashAggregate, child: Chunk,
              ctx: ExecContext) -> Chunk:
    """The in-memory grouped aggregation of ``child``."""
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
        out[spec.name] = (
            _agg_distinct(spec, child, slot, capacity, gvalid, ctx)
            if spec.distinct else
            _agg_col(spec, child, slot, capacity, gvalid, ctx))
    return _maybe_compact(Chunk(out, gvalid), ctx)


def _agg_distinct(spec: AggSpec, chunk: Chunk, slot, capacity, gvalid,
                  ctx: ExecContext) -> DCol:
    """count(DISTINCT x) per group: a second dedup pass over the (group,
    x) pairs, then a count of the distinct pairs per group.  Each overflow
    check of the pair table is a host read."""
    c = eval_expr(spec.arg, chunk)
    pair_mask = chunk.mask & (slot >= 0) & c.valid_or_true()
    pkeys = [slot.to(torch.int64)] + _col_keys(c)
    pair_cap = capacity
    while True:
        owner2, _, overflow = HT.insert(pkeys, pair_mask, pair_cap)
        if not _sync_int(ctx, overflow):
            break
        pair_cap *= 2
    rep_valid = owner2 != HT.EMPTY
    rep = owner2.to(torch.int64).clamp(0, max(chunk.n_rows - 1, 0))
    rep_group = torch.where(rep_valid, slot[rep], -1)
    return DCol(T.BIGINT, PLAIN, A.seg_count(rep_group, rep_valid, capacity),
                validity=gvalid)


def _variance(func: str, s1, s2, cnt):
    """The JAX package's one-pass variance from the sum ``s1``, the sum of
    squares ``s2`` and the count (it cancels when the mean is large
    against the spread; Welford's update would not), its square root for
    the stddev family."""
    cntf = cnt.to(torch.float64)
    den = (cntf if func.endswith("_pop") else cntf - 1).clamp_min(1.0)
    var = ((s2 - s1 * s1 / cntf.clamp_min(1.0)) / den).clamp_min(0.0)
    return var if "var" in func else torch.sqrt(var)


def _seg_sum128(vals, slot, vmask, capacity):
    """Exact int128 segment sum of int64 or packed-int128 addends."""
    if vals.dim() == 2:
        return I128.seg_sum128_from_i128(vals, slot, vmask, capacity)
    return I128.seg_sum128_from_i64(vals, slot, vmask, capacity)


def _g_sum128(vals, mask):
    if vals.dim() == 2:
        return I128.g_sum128_from_i128(vals, mask)
    return I128.g_sum128_from_i64(vals, mask)


GOLDEN64 = 0x9E3779B97F4A7C15 - (1 << 64)  # checksum's multiplier, int64

# aggregates computed once for both forms by ``_agg_more``
MORE_FUNCS = frozenset({"bool_and", "bool_or", "bitwise_and_agg",
                        "bitwise_or_agg", "checksum", "geometric_mean",
                        "min_by", "max_by", "approx_percentile"} | CORR_FUNCS)


class Groups:
    """The grouped aggregation's reductions: rows into ``capacity`` slots
    by ``slot``; ``of_row`` reads each row's group's value back."""

    def __init__(self, slot, capacity: int, gvalid):
        self.slot, self.capacity, self.gvalid = slot, capacity, gvalid

    def count(self, m):
        return A.seg_count(self.slot, m, self.capacity)

    def sum(self, v, m, dtype):
        return A.seg_sum(v, self.slot, m, self.capacity, dtype)

    def min(self, v, m):
        return A.seg_min(v, self.slot, m, self.capacity)

    def max(self, v, m):
        return A.seg_max(v, self.slot, m, self.capacity)

    def any(self, flags, m):
        return A.seg_any(flags, self.slot, m, self.capacity)

    def bitand(self, v, m):
        return A.seg_bitand(v, self.slot, m, self.capacity)

    def bitor(self, v, m):
        return A.seg_bitor(v, self.slot, m, self.capacity)

    def sum128(self, v, m):
        """Exact int128 sums of int64 or packed-int128 addends, packed."""
        return I128.pack(*_seg_sum128(v, self.slot, m, self.capacity))

    def of_row(self, per_group):
        return per_group[self.slot.clamp(min=0).to(torch.int64)]


class Whole(Groups):
    """The same reductions over every row into one slot, by the global
    aggregation's one-slot forms (``g_sum`` of int64 is ``masked_sum``'s
    dispatch)."""

    def __init__(self, n: int, device):
        super().__init__(torch.zeros((n,), dtype=torch.int64, device=device),
                         1, torch.ones((1,), dtype=torch.bool, device=device))

    def count(self, m):
        return A.g_count(m).reshape(1)

    def sum(self, v, m, dtype):
        return A.g_sum(v, m, dtype).reshape(1)

    def min(self, v, m):
        return A.g_min(v, m).reshape(1)

    def max(self, v, m):
        return A.g_max(v, m).reshape(1)

    def any(self, flags, m):
        return (flags & m).any().reshape(1)

    def bitand(self, v, m):
        return A.g_bitand(v, m).reshape(1)

    def bitor(self, v, m):
        return A.g_bitor(v, m).reshape(1)

    def sum128(self, v, m):
        return I128.pack(*(w.reshape(1) for w in _g_sum128(v, m)))

    def of_row(self, per_group):
        return per_group


def value_hash(c: DCol) -> torch.Tensor:
    """Each row's uint32 hash by value, for checksum and approx_distinct:
    a string over its own bytes (``hash_strings``; a DICT entry hashed
    once and gathered by code), so that slices, partitions and chunks
    whose dictionaries or widths differ agree; else the key tensors
    (``_col_keys``: a DOUBLE's order-preserving bits)."""
    if c.kind == DICT:
        mat, lens = dictionary_bytes(c)
        return HASH.hash_strings(SORT.bytes_sort_keys(mat, lens),
                                 lens)[c.values.to(torch.int64)]
    if c.kind == BYTES:
        return HASH.hash_strings(SORT.bytes_sort_keys(c.values, c.lengths),
                                 c.lengths)
    return HASH.hash_keys(_col_keys(c))


def checksum_terms(c: DCol) -> torch.Tensor:
    """Each row's checksum contribution: its ``value_hash`` plus one,
    times the 64-bit golden ratio, wrapping in int64; summed, the JAX
    package's order-independent checksum (which hashes a string's
    dictionary code or its padded packs instead)."""
    return (value_hash(c) + 1) * GOLDEN64


# the corr family's moment sums: float64 (``n`` and the one-pass sums)
# for every argument, and exact int128 ones (``e*``) when both arguments
# are int64 values (integers, short decimals)
CORR_FLOAT = ("n", "sx", "sy", "sxy", "sxx", "syy")
CORR_EXACT = ("ex", "ey", "exy", "exx", "eyy")
_EXACT_LIMIT = 2.0 ** 120  # any |int128| the exact finalize forms stays below


def corr_moments(spec: AggSpec, c: DCol, chunk: Chunk, vmask,
                 R: Groups) -> Dict[str, torch.Tensor]:
    """The moment sums over the rows where both arguments are non-NULL, y
    the first argument and x the second: ``CORR_FLOAT`` (n as float64),
    and ``CORR_EXACT`` (packed int128, in the arguments' unscaled units)
    when both are int64 values."""
    x = eval_expr(spec.arg2, chunk)
    refuse_zoned(x, spec.func)
    if c.kind != PLAIN or x.kind != PLAIN:
        raise NotImplementedError(f"{spec.func} of a string column")
    both = vmask & x.valid_or_true()
    yf, xf = as_double(c), as_double(x)
    out = dict(zip(CORR_FLOAT, [R.count(both).to(torch.float64)] + [
        R.sum(v, both, torch.float64)
        for v in (xf, yf, xf * yf, xf * xf, yf * yf)]))
    if _exact_corr(c) and _exact_corr(x):
        X, Y = x.values.to(torch.int64), c.values.to(torch.int64)

        def prod(a, b):  # exact: |a b| < 2^126
            return I128.pack(*I128.mul(*I128.from_i64(a), *I128.from_i64(b)))
        out.update(zip(CORR_EXACT, [R.sum128(v, both) for v in (
            X, Y, prod(X, Y), prod(X, X), prod(Y, Y))]))
    return out


LOG_UNIT = 2.0 ** 52  # fixed-point unit of geometric_mean's exact log sum


def log_sums(c: DCol, vmask, R: Groups) -> Dict[str, torch.Tensor]:
    """geometric_mean's sums of ln x: ``slog`` in float64 (it carries a
    -inf, +inf or NaN), and ``qlog``, each finite ln x rounded to a
    multiple of 2^-52 (|ln x| < 746, so under 2^62) and summed exactly in
    int128: the mean of the logs comes out to about an ulp, in any
    order, sliced or not."""
    ln = torch.log(as_double(c))
    q = torch.where(torch.isfinite(ln), torch.round(ln * LOG_UNIT), 0.0)
    return {"slog": R.sum(ln, vmask, torch.float64),
            "qlog": R.sum128(q.to(torch.int64), vmask)}


def geometric_mean(m: Dict[str, torch.Tensor], cnt) -> torch.Tensor:
    """``exp(Σ ln x / n)`` from ``log_sums``: the exact sum where every
    logarithm was finite, else the float one (0 after a zero, NaN after
    a negative)."""
    nf = cnt.clamp_min(1).to(torch.float64)
    exact = I128.to_f64(*I128.unpack(m["qlog"])) / LOG_UNIT
    return torch.exp(torch.where(torch.isfinite(m["slog"]), exact,
                                 m["slog"]) / nf)


def _exact_corr(c: DCol) -> bool:
    return (c.values.dim() == 1 and not c.values.is_floating_point()
            and c.values.dtype != torch.bool)


def corr_finalize(spec: AggSpec, m: Dict[str, torch.Tensor]):
    """(value, validity) of a corr-family aggregate from its moment sums:
    the JAX package's one-pass formulas (``_corr_finalize``) over the
    float64 sums, and, where the exact sums are there and every product
    below stays under 2^120, the same functions of the exactly centred
    int128 sums (n Σxx - (Σx)^2, ...), rounded once each, so that a
    result that cancels (an intercept near 0) is exact to a few ulps."""
    func = spec.func
    n, sx, sy, sxy, sxx, syy = (m[k] for k in CORR_FLOAT)
    nf = n.clamp_min(1.0)
    dxy = sxy - sx * sy / nf
    dxx = sxx - sx * sx / nf
    dyy = syy - sy * sy / nf
    if func in ("covar_pop", "covar_samp"):
        div = nf if func == "covar_pop" else (n - 1.0).clamp_min(1.0)
        v, ok = dxy / div, n >= (1 if func == "covar_pop" else 2)
    elif func == "corr":
        den = torch.sqrt((dxx * dyy).clamp_min(0.0))
        v, ok = dxy / den.clamp_min(1e-300), (n >= 1) & (den > 0)
    else:
        slope = dxy / dxx.clamp_min(1e-300)
        ok = (n >= 1) & (dxx > 0)
        v = slope if func == "regr_slope" else (sy - slope * sx) / nf
    if "ex" not in m:
        return v, ok
    a, b = _scale_of(spec.arg2.dtype), _scale_of(spec.arg.dtype)
    ex, ey, exy, exx, eyy = (I128.unpack(m[k]) for k in CORR_EXACT)
    n64 = n.to(torch.int64)

    def centred(s2, s, t):  # n Σst - Σs Σt
        return I128.sub(*I128.mul_i64(*s2, n64), *I128.mul(*s, *t))
    f = I128.to_f64
    cxy, cxx, cyy = (centred(exy, ex, ey), centred(exx, ex, ex),
                     centred(eyy, ey, ey))
    # the guard, from the float sums in unscaled units
    ux, uy = sx * 10.0 ** a, sy * 10.0 ** b
    uxx, uyy, uxy = sxx * 10.0 ** (2 * a), syy * 10.0 ** (2 * b), \
        sxy * 10.0 ** (a + b)
    fits = ((nf * uxx < _EXACT_LIMIT) & (nf * uyy < _EXACT_LIMIT)
            & (ux * ux < _EXACT_LIMIT) & (uy * uy < _EXACT_LIMIT)
            & ((uy * uxx).abs() + (ux * uxy).abs() < _EXACT_LIMIT))
    if func in ("covar_pop", "covar_samp"):
        div = nf * (nf if func == "covar_pop" else (n - 1.0).clamp_min(1.0))
        ev, eok = f(*cxy) / div / 10.0 ** (a + b), ok
    elif func == "corr":
        den = torch.sqrt(f(*cxx) * f(*cyy))
        ev, eok = f(*cxy) / den.clamp_min(1e-300), (n >= 1) & (den > 0)
    else:
        fxx = f(*cxx)
        eok = (n >= 1) & (fxx > 0)
        if func == "regr_slope":
            ev = f(*cxy) / fxx.clamp_min(1e-300) * 10.0 ** (a - b)
        else:  # (Σy Σxx - Σx Σxy) / (n Σxx - (Σx)^2)
            num = I128.sub(*I128.mul(*ey, *exx), *I128.mul(*ex, *exy))
            ev = f(*num) / fxx.clamp_min(1e-300) / 10.0 ** b
    return torch.where(fits, ev, v), torch.where(fits, eok, ok)


def _by_key(spec: AggSpec, chunk: Chunk):
    """min_by/max_by's ordering key as (int64 order image, validity): a
    DICT key's string rank, a DOUBLE's order-preserving bits; a key that
    is no single integer (BYTES, a long decimal) raises."""
    k = eval_expr(spec.arg2, chunk)
    if k.kind == BYTES or k.values.dim() == 2:
        raise NotImplementedError(
            f"{spec.func} keyed by a {k.kind} {k.dtype} column on the "
            "torch path")
    return _value_packs(k)[0].to(torch.int64), k.valid_or_true()


def _agg_more(spec: AggSpec, c: DCol, chunk: Chunk, mask, R: Groups) -> DCol:
    """One of ``MORE_FUNCS`` over the rows in ``mask``, grouped or global
    by ``R``.  min_by/max_by: among the rows whose key is not NULL, the
    lowest row id attaining its group's key extreme (the extreme from
    the dtype-extreme ``seg_min``/``seg_max``, no winner → NULL), its
    value gathered whole.  approx_percentile: exact nearest rank,
    ``ceil(q n) - 1``, from one sort by (group, value).  geometric_mean:
    ``exp(Σ ln x / n)``, unclamped (0 for a zero, NaN for a negative),
    the logarithms summed exactly in fixed point (``log_sums``)."""
    f = spec.func
    n = chunk.n_rows
    vmask = mask & c.valid_or_true()
    if f in ("min_by", "max_by"):
        img, kvalid = _by_key(spec, chunk)
        kmask = mask & kvalid
        ext = (R.min if f == "min_by" else R.max)(img, kmask)
        win = kmask & (img == R.of_row(ext))
        ridx = torch.arange(n, dtype=torch.int64, device=mask.device)
        return c.take(R.min(ridx, win).clamp(max=max(n - 1, 0)),
                      valid=R.gvalid & (R.count(win) > 0))
    if f == "approx_percentile":
        slotk = torch.where(vmask, R.slot.to(torch.int64), R.capacity)
        perm = SORT.argsort_multi([(slotk, False)] + [
            (p, False) for p in _value_packs(c)])
        cnt = R.count(vmask)
        nth = torch.minimum(
            (torch.ceil(spec.param * cnt.to(torch.float64)).to(torch.int64)
             - 1).clamp_min(0), (cnt - 1).clamp_min(0))
        pos = torch.cumsum(cnt, 0) - cnt + nth
        return c.take(perm[pos.clamp(max=max(n - 1, 0))],
                      valid=R.gvalid & (cnt > 0))
    if f in CORR_FUNCS:
        v, ok = corr_finalize(spec, corr_moments(spec, c, chunk, vmask, R))
        return DCol(T.DOUBLE, PLAIN, v, validity=R.gvalid & ok)
    ok = R.count(vmask) > 0
    if f == "checksum":
        v = R.sum(checksum_terms(c), vmask, torch.int64)
    elif c.kind != PLAIN:
        raise NotImplementedError(
            f"{f}({c.dtype}, {c.kind}) on the torch path")
    elif f == "geometric_mean":
        v = geometric_mean(log_sums(c, vmask, R), R.count(vmask))
    elif c.values.dim() == 2:
        raise NotImplementedError(f"{f}({c.dtype}) on the torch path")
    elif f == "bool_and":
        v = ~R.any(~c.values.to(torch.bool), vmask)
    elif f == "bool_or":
        v = R.any(c.values.to(torch.bool), vmask)
    else:  # bitwise_and_agg / bitwise_or_agg
        if c.values.is_floating_point():
            raise NotImplementedError(f"{f}({c.dtype}) on the torch path")
        v = (R.bitand if f == "bitwise_and_agg" else R.bitor)(c.values, vmask)
    return DCol(_agg_output_type(spec), PLAIN, v, validity=R.gvalid & ok)


def _agg_col(spec: AggSpec, chunk: Chunk, slot, capacity, gvalid,
             ctx: ExecContext) -> DCol:
    mask = chunk.mask & (slot >= 0)
    if spec.func == "count_star":
        return DCol(T.BIGINT, PLAIN, A.seg_count(slot, mask, capacity),
                    validity=gvalid)
    c = eval_expr(spec.arg, chunk)
    if spec.func not in KEEPS_ZONE:
        refuse_zoned(c, spec.func)
    if spec.func in MORE_FUNCS:
        return _agg_more(spec, c, chunk, mask, Groups(slot, capacity, gvalid))
    if spec.func in NESTED_AGGS:
        return _agg_nested(spec, c, chunk, mask,
                           Groups(slot, capacity, gvalid), ctx)
    if c.kind in (ARRAY, MAP) and spec.func not in ("count", "arbitrary",
                                                    "any_value"):
        raise NotImplementedError(
            f"grouped {spec.func}({c.dtype}) on the torch path")
    vmask = mask & c.valid_or_true()
    vals = c.values
    ot = _agg_output_type(spec)
    if spec.func == "count":
        return DCol(T.BIGINT, PLAIN, A.seg_count(slot, vmask, capacity),
                    validity=gvalid)
    if spec.func == "approx_distinct":
        regs = HLL.group_state(value_hash(c), slot, vmask,
                               capacity)
        return DCol(T.BIGINT, PLAIN, HLL.estimate(regs), validity=gvalid)
    dbl = isinstance(c.dtype, T.DoubleType)
    if spec.func == "sum" and (T.is_long_decimal(ot) or ot == T.BIGINT
                               or dbl):
        nonempty = A.seg_count(slot, vmask, capacity) > 0
        if T.is_long_decimal(ot):
            # DECIMAL sums accumulate in int128 like the reference
            # (LongDecimalWithOverflowState)
            v = I128.pack(*_seg_sum128(vals, slot, vmask, capacity))
        else:
            v = A.seg_sum(vals, slot, vmask, capacity,
                          torch.float64 if dbl else torch.int64)
        return DCol(ot, PLAIN, v, validity=gvalid & nonempty)
    if spec.func == "avg" and c.kind == PLAIN and vals.dtype != torch.bool:
        cnt = A.seg_count(slot, vmask, capacity)
        if T.is_decimal(c.dtype):
            hi, lo = _seg_sum128(vals, slot, vmask, capacity)
            qhi, qlo = I128.div_round_half_up(
                hi, lo, *I128.from_i64(cnt.clamp_min(1)))
            v = I128.pack(qhi, qlo) if T.is_long_decimal(ot) else qlo
        else:  # a DOUBLE: the float64 or exact int64 sum over the count
            s = A.seg_sum(vals, slot, vmask, capacity,
                          torch.float64 if dbl else torch.int64)
            v = s.to(torch.float64) / cnt.clamp_min(1)
        return DCol(ot, PLAIN, v, validity=gvalid & (cnt > 0))
    if spec.func in VARIANCE_FUNCS and c.kind == PLAIN:
        fv = as_double(c)
        cnt = A.seg_count(slot, vmask, capacity)
        v = _variance(spec.func, A.seg_sum(fv, slot, vmask, capacity),
                      A.seg_sum(fv * fv, slot, vmask, capacity), cnt)
        return DCol(T.DOUBLE, PLAIN, v, validity=gvalid & (
            cnt >= (1 if spec.func.endswith("_pop") else 2)))
    if spec.func in ("arbitrary", "any_value"):
        # lowest row id of each group, gathered whole: one code path for
        # every layout (DICT codes, BYTES matrix + lengths, long decimals)
        n = chunk.n_rows
        ridx = torch.arange(n, dtype=torch.int64, device=slot.device)
        widx = A.seg_min(ridx, slot, vmask, capacity)
        nonempty = A.seg_count(slot, vmask, capacity) > 0
        return c.take(widx.clamp(max=max(n - 1, 0)), valid=gvalid & nonempty)
    if spec.func in ("min", "max") and c.kind == DICT:
        f = A.seg_min if spec.func == "min" else A.seg_max
        return dict_extreme(c, lambda r: f(r, slot, vmask, capacity),
                            gvalid & (A.seg_count(slot, vmask, capacity) > 0),
                            ot)
    if spec.func in ("min", "max") and c.kind == PLAIN \
            and vals.dtype != torch.bool:
        valid = gvalid & (A.seg_count(slot, vmask, capacity) > 0)
        if vals.dim() == 2:
            f = I128.seg_min128 if spec.func == "min" else I128.seg_max128
            return DCol(ot, PLAIN, I128.pack(*f(vals, slot, vmask, capacity)),
                        validity=valid)
        f = A.seg_min if spec.func == "min" else A.seg_max
        return DCol(ot, PLAIN, f(vals, slot, vmask, capacity), validity=valid)
    raise NotImplementedError(
        f"grouped {spec.func}({c.dtype}, {c.kind}) on the torch path")


def _exec_global_agg(plan: PhysHashAggregate, chunk: Chunk,
                     ctx: ExecContext) -> Chunk:
    out: Dict[str, DCol] = {}
    whole = None
    for spec in plan.aggs:
        if spec.func == "count_star":
            out[spec.name] = DCol(T.BIGINT, PLAIN,
                                  A.g_count(chunk.mask).reshape(1))
            continue
        c = eval_expr(spec.arg, chunk)
        if spec.func not in KEEPS_ZONE:
            refuse_zoned(c, spec.func)
        m = chunk.mask & c.valid_or_true()
        ot = _agg_output_type(spec)
        nonempty = (A.g_count(m) > 0).reshape(1)
        if spec.distinct:
            # one dense id per distinct value: no more ids than rows
            owner, _, _ = HT.insert(_col_keys(c), m, max(chunk.n_rows, 1))
            v = (owner != HT.EMPTY).to(torch.int64).sum().reshape(1)
            out[spec.name] = DCol(T.BIGINT, PLAIN, v)
            continue
        if spec.func == "count":
            out[spec.name] = DCol(T.BIGINT, PLAIN, A.g_count(m).reshape(1))
            continue
        if spec.func in MORE_FUNCS or spec.func in NESTED_AGGS:
            whole = whole or Whole(chunk.n_rows, chunk.mask.device)
            out[spec.name] = (_agg_more(spec, c, chunk, chunk.mask, whole)
                              if spec.func in MORE_FUNCS else _agg_nested(
                                  spec, c, chunk, chunk.mask, whole, ctx))
            continue
        if spec.func in ("arbitrary", "any_value"):
            # the first row with a value, gathered whole (any layout)
            ridx = torch.arange(chunk.n_rows, dtype=torch.int64,
                                device=m.device)
            first = A.g_min(ridx, m).reshape(1)
            out[spec.name] = c.take(first.clamp(max=max(chunk.n_rows - 1, 0)),
                                    valid=nonempty)
            continue
        if spec.func == "approx_distinct":
            regs = HLL.global_state(value_hash(c), m)
            out[spec.name] = DCol(T.BIGINT, PLAIN,
                                  HLL.estimate(regs).reshape(1))
            continue
        if spec.func in ("min", "max") and c.kind == DICT:
            f = A.g_min if spec.func == "min" else A.g_max
            out[spec.name] = dict_extreme(c, lambda r: f(r, m).reshape(1),
                                          nonempty, ot)
            continue
        if c.kind != PLAIN or c.values.dtype == torch.bool:
            raise NotImplementedError(
                f"global {spec.func}({c.dtype}, {c.kind}) on the torch path")
        dbl = isinstance(c.dtype, T.DoubleType)
        if spec.func == "sum" and T.is_long_decimal(ot):
            v = I128.pack(*_g_sum128(c.values, m)).reshape(1, 2)
        elif spec.func == "sum" and (ot == T.BIGINT or dbl):
            v = A.g_sum(c.values, m,
                        torch.float64 if dbl else torch.int64).reshape(1)
        elif spec.func == "avg" and T.is_decimal(c.dtype):
            # the int128 sum over the count, HALF_UP
            cnt = A.g_count(m).clamp_min(1).reshape(1)
            hi, lo = _g_sum128(c.values, m)
            qhi, qlo = I128.div_round_half_up(
                hi.reshape(1), lo.reshape(1), *I128.from_i64(cnt))
            v = I128.pack(qhi, qlo) if T.is_long_decimal(ot) else qlo
        elif spec.func == "avg":  # a DOUBLE
            s = A.g_sum(c.values, m, torch.float64 if dbl else torch.int64)
            v = (s.to(torch.float64) / A.g_count(m).clamp_min(1)).reshape(1)
        elif spec.func in VARIANCE_FUNCS:
            fv = as_double(c)
            cnt = A.g_count(m)
            v = _variance(spec.func, A.g_sum(fv, m), A.g_sum(fv * fv, m),
                          cnt).reshape(1)
            nonempty = (cnt >= (1 if spec.func.endswith("_pop")
                                else 2)).reshape(1)
        elif spec.func in ("min", "max") and c.values.dim() == 2:
            f = I128.g_min128 if spec.func == "min" else I128.g_max128
            v = I128.pack(*f(c.values, m)).reshape(1, 2)
        elif spec.func in ("min", "max"):
            f = A.g_min if spec.func == "min" else A.g_max
            v = f(c.values, m).to(c.values.dtype).reshape(1)
        else:
            raise NotImplementedError(
                f"global {spec.func}({c.dtype}) on the torch path")
        out[spec.name] = DCol(ot, PLAIN, v, validity=nonempty)
    return Chunk(out, torch.ones((1,), dtype=torch.bool,
                                 device=chunk.mask.device))


# ---------------------------------------------------------------- nested values

# aggregates whose result is an ARRAY or a MAP (``_agg_nested``)
NESTED_AGGS = frozenset({"array_agg", "map_agg", "histogram", "min_n",
                         "max_n"})


def _scalar(c: DCol) -> DCol:
    """A BYTES column as DICT over its distinct strings (host-decoded), so
    that its values can be elements of an ARRAY or MAP; other layouts as
    they are."""
    if c.kind != BYTES:
        return c
    strs, codes = _host_strings(c)
    return DCol(c.dtype, DICT, codes.to(torch.int32), validity=c.validity,
                dictionary=Dictionary(np.array(strs, dtype=object)))


def _elements(c: DCol, what: str) -> torch.Tensor:
    """The values of a column that can be elements: integers, dates,
    short decimals, DOUBLEs, booleans and DICT codes."""
    if c.kind not in (PLAIN, DICT) or c.values.dim() == 2 \
            or c.values2 is not None:
        raise NotImplementedError(
            f"{what} of a {c.kind} {c.dtype} column on the torch path")
    return c.values


def _pack(values, R: "Groups", keep, pos, counts, ctx) -> Tuple:
    """([capacity, width] values of each group's kept rows at their
    positions, width): the width, the largest group, is one host read."""
    width = _sync_int(ctx, counts.max()) if counts.numel() else 0
    return AR.group_pack(values, R.slot, pos, keep, R.capacity, width)


def _first_pairs(R: "Groups", c: DCol, vmask):
    """The distinct (group, value) pairs of the rows in ``vmask``: (the
    lowest row of each pair, in row order; its pair's row count)."""
    n = c.n_rows
    if n == 0:
        none = torch.zeros((0,), dtype=torch.int64, device=vmask.device)
        return none, none, none.to(torch.bool)
    cap = n  # no more pairs than rows: the insert cannot overflow
    owner, pslot, _ = HT.insert([R.slot.to(torch.int64)] + _col_keys(c),
                                vmask, cap)
    cnt = A.seg_count(pslot, vmask, cap)
    used = owner != HT.EMPTY
    order = torch.sort(torch.where(used, owner.to(torch.int64), n)).indices
    rows = owner.to(torch.int64)[order]
    return rows, cnt[order], used[order]


def _agg_nested(spec: AggSpec, c: DCol, chunk: Chunk, mask, R: "Groups",
                ctx: ExecContext) -> DCol:
    """array_agg, map_agg, histogram, min(x, n) and max(x, n), grouped or
    global by ``R``.  NULL inputs are left out, as in the JAX package
    (this layout has no NULL element); a group with none left is NULL, as
    Trino's are; a NULL map_agg value raises (one host read).  array_agg
    keeps row order; map_agg keeps the first value of a repeated key
    (Trino's) and histogram counts each distinct value,
    both in the order the keys first appear; min(x, n)/max(x, n) take the
    n least (greatest) values, in that order, strings by string (the JAX
    package orders a DICT column's codes).  The groups' width is one host
    read."""
    f = spec.func
    c = _scalar(c)
    vmask = mask & c.valid_or_true()
    ot = _agg_output_type(spec)
    if f in ("min_n", "max_n"):
        # each row's rank in its group in value order: the rows in value
        # order, then their positions within their groups
        width = int(spec.param)
        perm = SORT.argsort_multi([(p, f == "max_n")
                                   for p in _value_packs(c)])
        ranked, cnt = AR.group_positions(R.slot[perm], vmask[perm],
                                         R.capacity)
        pos = torch.empty_like(ranked)
        pos[perm] = ranked
        keep = vmask & (pos >= 0) & (pos < width)
        vals = AR.group_pack(_elements(c, f), R.slot, pos, keep, R.capacity,
                             width)
        return DCol(ot, ARRAY, vals, cnt.clamp(max=width).to(torch.int32),
                    R.gvalid & (cnt > 0), c.dictionary)
    if f == "array_agg":
        pos, counts = AR.group_positions(R.slot, vmask, R.capacity)
        vals = _pack(_elements(c, f), R, vmask, pos, counts, ctx)
        return DCol(ot, ARRAY, vals, counts.to(torch.int32),
                    R.gvalid & (counts > 0), c.dictionary)
    rows, pair_cnt, used = _first_pairs(R, c, vmask)
    at = rows.clamp(max=max(c.n_rows - 1, 0))
    rslot = torch.where(used, R.slot.to(torch.int64)[at], -1)
    pos, counts = AR.group_positions(rslot, used, R.capacity)
    sub = Groups(rslot, R.capacity, R.gvalid)
    keys = _pack(_elements(c, f)[at], sub, used, pos, counts, ctx)
    if f == "histogram":
        v2, d2 = AR.group_pack(pair_cnt, rslot, pos, used, R.capacity,
                               keys.shape[1]), None
    else:
        v = _scalar(eval_expr(spec.arg2, chunk))
        if v.validity is not None and _sync_int(
                ctx, (vmask & ~v.validity).any()):
            raise NotImplementedError("map_agg of a NULL value (a MAP "
                                      "holds no NULL element here)")
        v2 = AR.group_pack(_elements(v, f)[at], rslot, pos, used,
                           R.capacity, keys.shape[1])
        d2 = v.dictionary
    return DCol(ot, MAP, keys, counts.to(torch.int32),
                R.gvalid & (counts > 0), c.dictionary, v2, d2)


def _at(values: torch.Tensor, row: torch.Tensor,
        pos: torch.Tensor) -> torch.Tensor:
    """``values[row[i], pos[i]]`` of a ``[N, W]`` tensor (0 where W is 0)."""
    if values.shape[1] == 0:
        return torch.zeros(row.shape, dtype=values.dtype,
                           device=values.device)
    return values[row, pos.clamp(0, values.shape[1] - 1)]


def _exec_unnest(plan: PhysUnnest, ctx: ExecContext) -> Chunk:
    """CROSS JOIN UNNEST: each live row repeated once per element of its
    longest argument (zip: a shorter array's elements are NULL past its
    end; a NULL array gives no element), a MAP as key and value columns,
    the 1-based position as the ordinality.  The output is the expanded
    rows only: one host read of their count."""
    child = execute(plan.child, ctx)
    arrs = [eval_expr(e, child) for e in plan.exprs]
    dev = child.mask.device
    for a in arrs:
        if a.kind not in (ARRAY, MAP):
            raise NotImplementedError(f"UNNEST of a {a.kind} {a.dtype}")
    eff = [torch.where(a.valid_or_true(), a.lengths.to(torch.int64), 0)
           for a in arrs]
    reps = torch.where(child.mask, torch.stack(eff).amax(0), 0)
    total = _sync_int(ctx, reps.sum())
    row = torch.repeat_interleave(torch.arange(child.n_rows, device=dev),
                                  reps, output_size=total)
    pos = torch.arange(total, device=dev) - (torch.cumsum(reps, 0)
                                             - reps)[row]
    cols = {nm: c.take(row) for nm, c in child.cols.items()}
    for a, e, outs in zip(arrs, eff, plan.names):
        valid = pos < e[row]
        key = _at(a.values, row, pos)
        if a.kind == MAP:
            cols[outs[0]] = _element(a.dtype.key, key, valid, a.dictionary)
            cols[outs[1]] = _element(a.dtype.value, _at(a.values2, row, pos),
                                     valid, a.dictionary2)
        else:
            cols[outs[0]] = _element(a.dtype.element, key, valid,
                                     a.dictionary)
    if plan.ordinality:
        cols[plan.ordinality] = DCol(T.BIGINT, PLAIN, pos + 1)
    return Chunk(cols, torch.ones((total,), dtype=torch.bool, device=dev))


# ---------------------------------------------------------------- joins

PARTITIONED_KINDS = ("inner", "left", "semi", "anti")


def _exec_join(plan: PhysHashJoin, ctx: ExecContext) -> Chunk:
    build = execute(plan.build, ctx)
    probe = execute(plan.probe, ctx)
    k = 1
    if plan.probe_keys and plan.kind in PARTITIONED_KINDS:
        # the working set: the build's table and CSR links, the probe and
        # its expansion, each about three times its input
        k = _tier_partitions(ctx, 3 * chunk_bytes(build)
                             + 3 * chunk_bytes(probe))
    if k > 1:
        return _exec_join_partitioned(plan, probe, build, ctx, k)
    return _join_core(plan, probe, build, ctx)


def _exec_join_partitioned(plan: PhysHashJoin, probe: Chunk, build: Chunk,
                           ctx: ExecContext, k: int) -> Chunk:
    """Join under the budget: both sides split by the high bits of the
    hash of their value-compared keys (``_join_key_arrays``), one
    partition's build and probe joined at a time, so the table of one
    partition is on the device at once (the reference's spilled join:
    ``spiller/GenericPartitioningSpiller.java``, ``HashBuilderOperator``'s
    SPILLING_INPUT, ``PartitionedConsumption`` replaying the probe).
    Every key lives in one partition, so inner, left, semi and anti
    results concatenate with no merge; a partition with no probe row
    gives none of them a row, nor one with no build row an inner or semi
    join."""
    refuse_row_numbering(plan.probe_keys + plan.build_keys
                         + ((plan.filter,) if plan.filter is not None
                            else ()), "a partitioned join")
    pk, bk = _join_key_arrays(plan, probe, build)
    probes = _partition_rows(probe, _hash_partition(pk, k), k, ctx)
    builds = _partition_rows(build, _hash_partition(bk, k), k, ctx)
    del pk, bk
    ctx.spill_partitions += k
    outs = []
    for sub_p, sub_b in zip(probes, builds):
        if sub_p is None or (sub_b is None
                             and plan.kind in ("inner", "semi")):
            continue
        outs.append(_join_core(plan, sub_p,
                               _no_rows(build) if sub_b is None else sub_b,
                               ctx))
    if not outs:
        return _join_core(plan, _no_rows(probe), _no_rows(build), ctx)
    return concat_chunks(outs)


def _join_key_arrays(plan: PhysHashJoin, probe: Chunk, build: Chunk):
    """The probe's and the build's int64 key tensors, compared by value:
    a DICT key beside a DICT key over another dictionary becomes its
    codes' ranks in the sorted union of both dictionaries (as
    ``expreval`` compares them); a string key beside a BYTES key, or two
    BYTES keys of different widths, become byte packs of one width."""
    pk: List[torch.Tensor] = []
    bk: List[torch.Tensor] = []
    for pe, be in zip(plan.probe_keys, plan.build_keys):
        p, b = eval_expr(pe, probe), eval_expr(be, build)
        if p.kind == DICT and b.kind == DICT \
                and p.dictionary is not b.dictionary:
            union = np.unique(np.concatenate([
                np.asarray(p.dictionary.strings, dtype=str),
                np.asarray(b.dictionary.strings, dtype=str)]))
            pk.append(_rank_in(union, p))
            bk.append(_rank_in(union, b))
            continue
        if BYTES in (p.kind, b.kind):
            p, b = dcol_to_bytes(p), dcol_to_bytes(b)
            w = max(p.values.shape[1], b.values.shape[1])
            pk.extend(SORT.bytes_sort_keys(_pad_bytes(p.values, w),
                                           p.lengths))
            bk.extend(SORT.bytes_sort_keys(_pad_bytes(b.values, w),
                                           b.lengths))
            continue
        pk.extend(_col_keys(p))
        bk.extend(_col_keys(b))
    return pk, bk


def _join_core(plan: PhysHashJoin, probe: Chunk, build: Chunk,
               ctx: ExecContext) -> Chunk:
    build_count = _sync_int(ctx, build.mask.sum())
    capacity = HT.capacity_for(max(build_count, 1))
    pk, bk = _join_key_arrays(plan, probe, build)
    if plan.kind == "mark":
        # NULL build keys never equal anything: they stay out of the table
        # and only set the mark's has-null flag
        nn, has_null = mark_build_nn(plan, build)
        table = HT.build(bk, nn, capacity)
        return _join_mark(plan, probe, pk, table, has_null)
    table = HT.build(bk, build.mask, capacity)
    probe, pk = _dynamic_filter(plan, probe, pk, build, ctx)
    if plan.kind == "full":
        return _join_full(plan, probe, pk, build, bk, table, ctx)
    if plan.unique_build and plan.filter is None \
            and plan.kind in ("inner", "left", "semi", "anti"):
        return _join_unique(plan, probe, pk, build, table, ctx)
    return _join_expand(plan, probe, pk, build, table, ctx)


def _join_unique(plan: PhysHashJoin, probe: Chunk, pk, build: Chunk, table,
                 ctx: ExecContext) -> Chunk:
    """Unique build side (PK of a FK join): one match at most per probe
    row, so the output has the probe's shape."""
    match = HT.probe_unique(table, pk, probe.mask)
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


def _not_null(chunk: Chunk, exprs, mask: torch.Tensor) -> torch.Tensor:
    """``mask``, less the rows where any key expression is NULL."""
    nn = mask
    for e in exprs:
        c = eval_expr(e, chunk)
        if c.validity is not None:
            nn = nn & c.validity
    return nn


def mark_build_nn(plan: PhysHashJoin, build: Chunk):
    """(non-NULL build mask, has-null flag) of a mark join's build side."""
    nn = _not_null(build, plan.build_keys, build.mask)
    return nn, (build.mask & ~nn).any()


def _join_mark(plan: PhysHashJoin, probe: Chunk, pk, table,
               has_null) -> Chunk:
    """MARK semi-join: every probe row stays; the existence bit becomes a
    boolean column (read by OR-composed predicates) with SQL three-valued
    IN: NULL when the probe key is NULL, or when there is no match and the
    build side holds a NULL key."""
    slot, _ = HT.probe_counts(table, pk, probe.mask)
    probe_valid = _not_null(probe, plan.probe_keys,
                            torch.ones_like(probe.mask))
    found = (slot >= 0) & probe_valid
    mark_valid = found | (probe_valid & ~has_null)
    cols = dict(probe.cols)
    cols[plan.mark_name] = DCol(T.BOOLEAN, PLAIN, found, validity=mark_valid)
    return Chunk(cols, probe.mask)


def _join_expand(plan: PhysHashJoin, probe: Chunk, pk, build: Chunk, table,
                 ctx: ExecContext) -> Chunk:
    """Non-unique build side, or a residual filter: count the matches of
    each probe row, read the pair total on the host, then materialise the
    pairs."""
    slot, cnt = HT.probe_counts(table, pk, probe.mask)
    if plan.kind in ("semi", "anti") and plan.filter is None:
        # not null-aware: NOT IN goes through the mark join
        found = slot >= 0
        mask = probe.mask & (found if plan.kind == "semi" else ~found)
        return _maybe_compact(Chunk(dict(probe.cols), mask), ctx)
    left_like = plan.kind in ("left", "full", "semi", "anti")
    eff = torch.where(probe.mask & (cnt == 0), 1, cnt) if left_like else cnt
    total = _sync_int(ctx, torch.where(probe.mask, eff, 0).to(
        torch.int64).sum())
    out_size = max(HT.next_pow2(max(total, 1)), 64)
    return _maybe_compact(
        _join_expand_pairs(plan, probe, build, table, slot, cnt, out_size),
        ctx)


def _join_expand_pairs(plan: PhysHashJoin, probe: Chunk, build: Chunk,
                       table, slot, cnt, out_size: int) -> Chunk:
    """The pairs of an expanding join in an [out_size] chunk (not
    compacted), the residual filter applied: inner keeps the matched pairs
    that pass; semi/anti reduce them to a flag per probe row; left/full
    keep the unmatched probe rows and null-extend a probe row whose
    matches all fail the filter (its first pair, payload made NULL)."""
    left_like = plan.kind in ("left", "full", "semi", "anti")
    probe_row, build_row, valid, matched = HT.expand_matches(
        table, slot, torch.where(probe.mask, cnt, 0), out_size,
        left=left_like, probe_mask=probe.mask)
    cols = {n: c.take(probe_row, valid=valid) for n, c in probe.cols.items()}
    for out_name, bcol in plan.build_payload:
        cols[out_name] = build.cols[bcol].take(build_row, valid=matched)
    pairs = Chunk(cols, valid)
    if plan.filter is not None:
        keep_pair = eval_predicate(plan.filter, pairs) & matched
    else:
        keep_pair = valid & matched
    if plan.kind in ("semi", "anti", "left", "full"):
        n_probe = probe.n_rows
        hit = torch.zeros((n_probe + 1,), dtype=torch.bool,
                          device=valid.device)
        hit[torch.where(keep_pair, probe_row, n_probe)] = True
        hit = hit[:n_probe]
    if plan.kind in ("semi", "anti"):
        mask = probe.mask & (hit if plan.kind == "semi" else ~hit)
        return Chunk(dict(probe.cols), mask)
    if plan.kind not in ("left", "full"):
        return Chunk(pairs.cols, keep_pair)
    first_pair = torch.cat([torch.ones((1,), dtype=torch.bool,
                                       device=valid.device),
                            probe_row[1:] != probe_row[:-1]])
    null_extend = (valid & matched & first_pair
                   & ~hit[probe_row.clamp(max=max(n_probe - 1, 0))])
    mask = keep_pair | (valid & ~matched) | null_extend
    if plan.filter is None:
        return Chunk(pairs.cols, mask)
    cols = dict(pairs.cols)
    for name in {o for o, _ in plan.build_payload}:
        c = cols[name]
        cols[name] = DCol(c.dtype, c.kind, c.values, c.lengths,
                          c.valid_or_true() & ~null_extend, c.dictionary,
                          c.values2, c.dictionary2)
    return Chunk(cols, mask)


def _full_join_tail(plan: PhysHashJoin, probe: Chunk, pk, build: Chunk, bk,
                    ctx: ExecContext) -> Chunk:
    """The build rows a FULL join did not match, probe columns NULL: a
    reverse probe of the build keys into a table over the non-NULL probe
    keys."""
    pnn = _not_null(probe, plan.probe_keys, probe.mask)
    pcap = HT.capacity_for(max(_sync_int(ctx, probe.mask.sum()), 1))
    ptable = HT.build(pk, pnn, pcap)
    slot, _ = HT.probe_counts(ptable, bk, build.mask)
    bnn = _not_null(build, plan.build_keys, build.mask)
    unmatched = build.mask & ~((slot >= 0) & bnn)
    nb = build.n_rows
    dev = build.mask.device
    zeros = torch.zeros((nb,), dtype=torch.int64, device=dev)
    never = torch.zeros((nb,), dtype=torch.bool, device=dev)
    cols = {n: c.take(zeros, valid=never) for n, c in probe.cols.items()}
    for out_name, bcol in plan.build_payload:
        cols[out_name] = build.cols[bcol]
    return Chunk(cols, unmatched)


def _join_full(plan: PhysHashJoin, probe: Chunk, pk, build: Chunk, bk,
               table, ctx: ExecContext) -> Chunk:
    """FULL OUTER join: the probe-outer expansion, then the unmatched
    build rows with NULL probe columns."""
    if plan.filter is not None:
        raise NotImplementedError("FULL JOIN with residual filter")
    pairs = _join_expand(plan, probe, pk, build, table, ctx)
    return concat_chunks([pairs, _full_join_tail(plan, probe, pk, build, bk,
                                                 ctx)])


def _concat_validity(cols: List[DCol]):
    if all(c.validity is None for c in cols):
        return None
    return torch.cat([c.valid_or_true() for c in cols])


def concat_chunks(chunks: List[Chunk]) -> Chunk:
    """Vertical concat (UNION ALL, a FULL join's two parts), harmonising
    each column's layouts as the JAX package does: DICT over one
    dictionary keeps its codes; DICT over different dictionaries, or
    beside BYTES (a string NULL literal is one), goes to BYTES padded to
    the widest; int64 beside long-decimal words widens to ``[n, 2]``; a
    zoned timestamp's offsets concatenate, 0 (the session zone, UTC) for
    a part that has none; ARRAY and MAP columns pad to the widest and
    recode their string elements over one dictionary (the JAX package
    cannot concatenate arrays of different widths)."""
    out: Dict[str, DCol] = {}
    for name in chunks[0].cols:
        cols = [ch.cols[name] for ch in chunks]
        kinds = {c.kind for c in cols}
        if kinds == {DICT} and all(c.dictionary is cols[0].dictionary
                                   for c in cols):
            out[name] = DCol(cols[0].dtype, DICT,
                             torch.cat([c.values for c in cols]), None,
                             _concat_validity(cols), cols[0].dictionary)
        elif kinds <= {DICT, BYTES}:
            cols = [dcol_to_bytes(c) for c in cols]
            w = max(c.values.shape[1] for c in cols)
            out[name] = DCol(cols[0].dtype, BYTES, torch.cat([
                torch.nn.functional.pad(c.values, (0, w - c.values.shape[1]))
                for c in cols]), torch.cat([c.lengths for c in cols]),
                _concat_validity(cols))
        elif kinds == {PLAIN}:
            wide = next((c for c in cols if c.values.dim() == 2), cols[0])
            if wide.values.dim() == 2:
                vals = [c.values if c.values.dim() == 2 else
                        I128.pack(*I128.from_i64(c.values.to(torch.int64)))
                        for c in cols]
            else:
                vals = [c.values for c in cols]
            v2 = None
            if any(c.values2 is not None for c in cols):
                v2 = torch.cat([torch.zeros((c.n_rows,), dtype=torch.int32,
                                            device=c.values.device)
                                if c.values2 is None else c.values2
                                for c in cols])
            out[name] = DCol(wide.dtype, PLAIN, torch.cat(vals), None,
                             _concat_validity(cols), values2=v2)
        elif kinds in ({ARRAY}, {MAP}):
            rt = cols[0].dtype
            vals, vals2, d, d2 = nested_layouts(cols, rt)
            out[name] = DCol(rt, cols[0].kind, torch.cat(vals), torch.cat(
                [c.lengths.to(torch.int32) for c in cols]),
                _concat_validity(cols), d,
                None if vals2 is None else torch.cat(vals2), d2)
        else:
            raise NotImplementedError(
                f"concat of {sorted(kinds)} columns {name!r}")
    return Chunk(out, torch.cat([ch.mask for ch in chunks]))


def _dynamic_filter(plan: PhysHashJoin, probe: Chunk, pk, build: Chunk,
                    ctx: ExecContext):
    """Dynamic filtering (reference: ``DynamicFilterSourceOperator``):
    narrow the probe side to the build keys' [min, max] before probing.
    Returns the probe and its key tensors (recomputed when the probe was
    compacted)."""
    if plan.kind not in ("inner", "semi") or not plan.probe_keys:
        return probe, pk  # anti/left joins must keep unmatched probe rows
    if probe.n_rows < MIN_ROWS_FOR_COMPACTION:
        return probe, pk  # not worth the extra pass on small probes
    pkc = eval_expr(plan.probe_keys[0], probe)
    bkc = eval_expr(plan.build_keys[0], build)
    if pkc.kind != PLAIN or bkc.kind != PLAIN or pkc.values.dim() != 1 \
            or bkc.values.dim() != 1 or pkc.values.is_floating_point() \
            or bkc.values.is_floating_point():
        return probe, pk
    bmask = build.mask & bkc.valid_or_true()
    bv = bkc.values.to(torch.int64)
    pv = pkc.values.to(torch.int64)
    mask = probe.mask & (pv >= A.g_min(bv, bmask)) & (pv <= A.g_max(bv, bmask))
    out = _maybe_compact(Chunk(probe.cols, mask), ctx)
    if out.n_rows == probe.n_rows:
        return out, pk
    return out, _join_key_arrays(plan, out, build)[0]

