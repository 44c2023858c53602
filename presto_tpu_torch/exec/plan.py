"""Plan nodes: the physical plan the planner emits and the executor runs.

The jax-free half of ``presto_tpu/exec/physical.py`` (its plan-node
dataclasses and the aggregate output typing the planner reads), kept here
so the planner, rules and pruning passes import no device code.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from ..data import types as T
from ..sql import ir


def _scale_of(t: T.DataType) -> int:
    return t.scale if T.is_decimal(t) else 0


# ---------------------------------------------------------------- plan nodes

@dataclass
class PhysOp:
    op_span = "op:Op"  # the node's span: op: and its class less "Phys"

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        cls.op_span = "op:" + cls.__name__.removeprefix("Phys")

    def children(self) -> Sequence["PhysOp"]:
        return ()


@dataclass
class PhysScan(PhysOp):
    table: str
    columns: Tuple[str, ...]
    alias_prefix: str = ""  # rename columns on scan (self-join disambiguation)


@dataclass
class PhysFilter(PhysOp):
    child: PhysOp
    predicate: ir.Expr

    def children(self):
        return (self.child,)


@dataclass
class PhysProject(PhysOp):
    child: PhysOp
    projections: Tuple[Tuple[str, ir.Expr], ...]  # output = exactly these

    def children(self):
        return (self.child,)


@dataclass(frozen=True)
class AggSpec:
    name: str
    func: str                       # sum|count|count_star|min|max|avg|min_by|…
    arg: Optional[ir.Expr] = None
    distinct: bool = False
    arg2: Optional[ir.Expr] = None  # ordering key for min_by/max_by
    param: Optional[float] = None   # percentile for approx_percentile


@dataclass
class PhysHashAggregate(PhysOp):
    child: PhysOp
    groups: Tuple[Tuple[str, ir.Expr], ...]
    aggs: Tuple[AggSpec, ...]
    ndv_hint: int = 1024
    # True when the hint derives from exact key statistics over an
    # UNFILTERED input (e.g. GROUP BY a primary key with no WHERE): the
    # traced path then allocates the hint directly instead of starting
    # optimistic and paying a guaranteed overflow-retry recompile
    ndv_reliable: bool = False

    def children(self):
        return (self.child,)


@dataclass
class PhysMaterial(PhysOp):
    """An already-materialized chunk as a leaf (streaming slices, stage
    results fed back into a residual plan)."""

    chunk: object  # Chunk

    def children(self):
        return ()


@dataclass
class PhysHashJoin(PhysOp):
    probe: PhysOp
    build: PhysOp
    probe_keys: Tuple[ir.Expr, ...]
    build_keys: Tuple[ir.Expr, ...]
    kind: str = "inner"             # inner | left | semi | anti | mark
    unique_build: bool = True       # build keys unique (PK side)
    # kind == "mark": existence bit emitted as this boolean output column
    # instead of filtering (reference: SemiJoinNode's semiJoinOutput)
    mark_name: str = ""
    build_payload: Tuple[Tuple[str, str], ...] = ()  # (out_name, build_col)
    filter: Optional[ir.Expr] = None  # non-equi residual over probe+payload
    build_est: float = -1.0         # planner's build-side row estimate (CBO)
    probe_est: float = -1.0         # planner's probe-side row estimate
    # static BUFFER bound of the build subtree (filters only mask rows in
    # traced programs, so broadcast memory follows the unfiltered scan
    # cardinality, not the selectivity-discounted estimate)
    build_cap_est: float = -1.0
    # planner's estimate of LIVE output rows (selectivity-discounted):
    # the traced path compacts the output buffer down to ~this capacity
    # when it is far below the probe buffer, so downstream sorts/groups
    # run over the surviving rows, not the padded scan shape (the
    # reference streams probe pages so its downstream operators never
    # see dead rows; one compaction pass is the whole-program analogue)
    out_est: float = -1.0
    # distribution (reference: JoinNode.DistributionType, set by the
    # add_exchanges pass — sql/planner/distribution.py):
    dist_type: str = "replicated"   # replicated | partitioned

    def children(self):
        return (self.probe, self.build)


@dataclass
class PhysSort(PhysOp):
    child: PhysOp
    keys: Tuple[Tuple[ir.Expr, bool], ...]  # (expr, descending)
    limit: Optional[int] = None

    def children(self):
        return (self.child,)


@dataclass
class PhysLimit(PhysOp):
    child: PhysOp
    n: int

    def children(self):
        return (self.child,)


@dataclass(frozen=True)
class WindowSpec:
    name: str                        # output column
    func: str                        # row_number|rank|dense_rank|lead|lag|
    #                                  first_value|sum|count|min|max|avg
    arg: Optional[ir.Expr] = None
    offset: int = 1                  # lead/lag distance
    frame: Optional[tuple] = None    # ("rows"|"range"|"groups", lo, hi)
    ignore_nulls: bool = False       # lead/lag/first/last/nth


@dataclass
class PhysMatchRecognize(PhysOp):
    """Row-pattern recognition, ONE ROW PER MATCH / SKIP PAST LAST ROW.

    Replaces ``operator/window/PatternRecognitionPartition.java``'s
    per-row backtracking: DEFINE predicates evaluate vectorized into a
    per-row bitmask, the pattern's DFA advances for every candidate start
    in lockstep (``ops/pattern.py``), skip resolution is one while_loop."""

    child: PhysOp
    partition: Tuple[ir.Expr, ...]
    order: Tuple[Tuple[ir.Expr, bool], ...]
    # (output name, func, arg): func ∈ first|last|count|match_number
    measures: Tuple[Tuple[str, str, Optional[ir.Expr]], ...]
    pattern: object                  # ops.pattern AST
    defines: Tuple[Tuple[str, ir.Expr], ...]
    window: int = 256                # max rows per match (static bound)
    # ALL ROWS PER MATCH: emit every matched row (RUNNING measure
    # semantics), not just one row per match
    all_rows: bool = False
    # pass-through columns for ALL ROWS (all source columns)
    passthrough: Tuple[str, ...] = ()

    def children(self):
        return (self.child,)


@dataclass
class PhysWindow(PhysOp):
    """Window functions over (PARTITION BY, ORDER BY) specs.

    Replaces ``operator/WindowOperator.java`` + ``operator/window/``: one
    global sort by (partition, order) keys, vectorized prefix computations,
    scatter back to input order (no per-partition row loop)."""

    child: PhysOp
    partition: Tuple[ir.Expr, ...]
    order: Tuple[Tuple[ir.Expr, bool], ...]
    functions: Tuple[WindowSpec, ...]

    def children(self):
        return (self.child,)


@dataclass
class PhysConcat(PhysOp):
    """Vertical concatenation (UNION ALL).  Reference: UnionNode →
    LocalExchange merging of sources."""

    inputs: Tuple[PhysOp, ...]

    def children(self):
        return self.inputs


@dataclass
class PhysGroupId(PhysOp):
    """GROUPING SETS row expansion (reference:
    ``operator/GroupIdOperator.java``): each input row replicates once per
    grouping set; grouping-set key columns are NULLed where the set does
    not contain them; ``gid_name`` carries the set ordinal.  ONE scan of
    the input feeds every grouping set (the round-3 plan-level
    flatten+UNION re-scanned the input per set).  TPU shape: a static
    N×S tile + per-copy validity masks — no per-row loop."""

    child: PhysOp
    keys: Tuple[Tuple[str, ir.Expr], ...]   # (out_name, key expr)
    sets: Tuple[Tuple[bool, ...], ...]      # per set: key participation
    gid_name: str = "$groupid"

    def children(self):
        return (self.child,)


@dataclass
class PhysUnnest(PhysOp):
    """Lateral array/map expansion (reference:
    ``operator/unnest/UnnestOperator.java:47``).  TPU shape: the output is
    a static ``N×W`` grid (W = array capacity), masked by element validity
    — no per-row cursor, one gather per column."""

    child: PhysOp
    exprs: Tuple[ir.Expr, ...]
    # output column names per expr: 1 name for arrays, 2 for maps
    names: Tuple[Tuple[str, ...], ...]
    ordinality: Optional[str] = None   # WITH ORDINALITY output name

    def children(self):
        return (self.child,)


@dataclass
class PhysScalarBind(PhysOp):
    """Bind single-row subplan results as broadcast columns of the child."""

    child: PhysOp
    bindings: Tuple[Tuple[str, "PhysOp"], ...]

    def children(self):
        return (self.child,) + tuple(p for _, p in self.bindings)


VARIANCE_FUNCS = {"stddev", "stddev_samp", "stddev_pop", "variance",
                  "var_samp", "var_pop"}

# two-argument moment aggregates (reference: operator/aggregation/
# CorrelationAggregation, CovarianceAggregation, RegrSlope/Intercept)
CORR_FUNCS = {"corr", "covar_samp", "covar_pop", "regr_slope",
              "regr_intercept"}


def _agg_output_type(spec: AggSpec) -> T.DataType:
    if spec.func in ("count", "count_star", "approx_distinct",
                     "checksum", "bitwise_and_agg", "bitwise_or_agg"):
        return T.BIGINT
    if spec.func == "geometric_mean":
        return T.DOUBLE
    if spec.func in ("min_n", "max_n"):
        return T.array(spec.arg.dtype)
    if spec.func in VARIANCE_FUNCS or spec.func in CORR_FUNCS:
        return T.DOUBLE
    if spec.func in ("bool_and", "bool_or"):
        return T.BOOLEAN
    at = spec.arg.dtype
    if spec.func in ("min_by", "max_by", "approx_percentile"):
        return at  # value argument's type
    if spec.func == "array_agg":
        return T.array(at)
    if spec.func == "map_agg":
        return T.map_(at, spec.arg2.dtype)
    if spec.func == "histogram":
        return T.map_(at, T.BIGINT)
    if spec.func == "sum":
        if isinstance(at, T.DoubleType):
            return T.DOUBLE
        return T.decimal(38, _scale_of(at)) if T.is_decimal(at) else T.BIGINT
    if spec.func == "avg":
        return at if T.is_decimal(at) else T.DOUBLE
    return at  # min/max/arbitrary
