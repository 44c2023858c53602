"""Iterative rule-based plan optimizer.

The architecture of the reference's ``sql/planner/iterative/IterativeOptimizer.java:57``
+ ``Memo.java:64`` + the ``iterative/rule/`` library, scaled to this engine's
plan vocabulary: each ``Rule`` declares a root *pattern* (a PhysOp class plus
an optional guard, the trino-matching analogue) and a ``apply`` that returns a
replacement subtree or None.  The optimizer explores the tree bottom-up and
re-fires rules at any node whose subtree changed, until no rule matches or the
iteration budget runs out (the reference's timeout analogue).  The Memo role —
avoid re-exploring unchanged subtrees — is played by an identity set of
fixpointed nodes: rules must return NEW nodes, never mutate in place.

Default rule set (reference rule each re-implements):

- MergeFilters                (``iterative/rule/MergeFilters.java``)
- RemoveTrivialFilters        (``RemoveTrivialFilters.java``)
- MergeLimits                 (``MergeLimits.java``)
- MergeLimitWithSort          (``MergeLimitWithSort.java``: Limit+Sort → TopN)
- MergeLimitOverProjectWithSort (PushLimitThroughProject then TopN)
- InlineProjections           (``InlineProjections.java``)
- PushFilterThroughProject    (the local step of ``PredicatePushDown``)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Type

from ...exec import plan as P
from .. import ir


# --------------------------------------------------------------- expression
# rewriting helpers shared by projection-related rules

def substitute(expr: ir.Expr, mapping: Dict[str, ir.Expr]) -> ir.Expr:
    """Replace ColumnRefs by expressions (pure, type-preserving)."""
    if isinstance(expr, ir.ColumnRef):
        return mapping.get(expr.name, expr)
    if isinstance(expr, ir.Case):  # whens is a tuple of pairs, not children
        return ir.Case(
            tuple((substitute(c, mapping), substitute(v, mapping))
                  for c, v in expr.whens),
            None if expr.default is None
            else substitute(expr.default, mapping),
            expr._dtype)
    kids = expr.children()
    if not kids:
        return expr
    new_kids = [substitute(k, mapping) for k in kids]
    if all(a is b for a, b in zip(kids, new_kids)):
        return expr
    # rebuild via dataclass fields (Expr nodes are frozen dataclasses whose
    # Expr-typed fields are exactly children(), in field order)
    repl = {}
    i = 0
    for f in dataclasses.fields(expr):
        v = getattr(expr, f.name)
        if isinstance(v, ir.Expr):
            repl[f.name] = new_kids[i]
            i += 1
        elif isinstance(v, tuple) and v and all(
                isinstance(x, ir.Expr) for x in v):
            repl[f.name] = tuple(new_kids[i:i + len(v)])
            i += len(v)
    return dataclasses.replace(expr, **repl)


def _expr_size(e: ir.Expr) -> int:
    return 1 + sum(_expr_size(k) for k in e.children())


def _is_true(e: ir.Expr) -> bool:
    return isinstance(e, ir.Literal) and e.value is True


# ------------------------------------------------------------------ patterns

class Pattern:
    """Root-node pattern: a PhysOp class + optional guard predicate
    (trino-matching's ``Pattern.typeOf(X).matching(...)``)."""

    def __init__(self, op_class: Type[P.PhysOp],
                 guard: Optional[Callable[[P.PhysOp], bool]] = None):
        self.op_class = op_class
        self.guard = guard

    def matches(self, node: P.PhysOp) -> bool:
        return isinstance(node, self.op_class) and (
            self.guard is None or self.guard(node))


class Rule:
    """One rewrite: fires where ``pattern`` matches; ``apply`` returns the
    replacement subtree (NEW nodes; child subtrees may be reused) or None."""

    pattern: Pattern

    @property
    def name(self) -> str:
        return type(self).__name__

    def apply(self, node: P.PhysOp) -> Optional[P.PhysOp]:
        raise NotImplementedError


# -------------------------------------------------------------------- rules

class MergeFilters(Rule):
    pattern = Pattern(P.PhysFilter,
                      lambda n: isinstance(n.child, P.PhysFilter))

    def apply(self, node):
        inner = node.child
        return P.PhysFilter(inner.child,
                            ir.and_(inner.predicate, node.predicate))


class RemoveTrivialFilters(Rule):
    pattern = Pattern(P.PhysFilter, lambda n: _is_true(n.predicate))

    def apply(self, node):
        return node.child


class MergeLimits(Rule):
    pattern = Pattern(P.PhysLimit,
                      lambda n: isinstance(n.child, P.PhysLimit))

    def apply(self, node):
        return P.PhysLimit(node.child.child, min(node.n, node.child.n))


class MergeLimitWithSort(Rule):
    """Limit(n) over Sort → TopN: the sort keeps only n rows (bounded-heap
    semantics of ``operator/TopNOperator.java`` — here sort+slice with the
    distributed path doing per-device top-k + merge)."""

    pattern = Pattern(P.PhysLimit, lambda n: isinstance(n.child, P.PhysSort))

    def apply(self, node):
        s = node.child
        lim = node.n if s.limit is None else min(node.n, s.limit)
        if s.limit == lim:
            return s
        return P.PhysSort(s.child, s.keys, limit=lim)


class MergeLimitOverProjectWithSort(Rule):
    """Limit over Project over Sort → Project over TopN
    (``PushLimitThroughProject`` + ``MergeLimitWithSort``)."""

    pattern = Pattern(P.PhysLimit,
                      lambda n: isinstance(n.child, P.PhysProject)
                      and isinstance(n.child.child, P.PhysSort))

    def apply(self, node):
        proj = node.child
        s = proj.child
        lim = node.n if s.limit is None else min(node.n, s.limit)
        return P.PhysProject(P.PhysSort(s.child, s.keys, limit=lim),
                             proj.projections)


class InlineProjections(Rule):
    """Project(Project) → one Project with inner expressions inlined —
    unless inlining would duplicate a non-trivial inner expression
    (the reference rule's same cost guard)."""

    pattern = Pattern(P.PhysProject,
                      lambda n: isinstance(n.child, P.PhysProject))

    def apply(self, node):
        inner = node.child
        mapping = dict(inner.projections)
        uses: Dict[str, int] = {}
        for _, e in node.projections:
            for sub in ir.walk(e):  # count every occurrence, not per-expr
                if isinstance(sub, ir.ColumnRef):
                    uses[sub.name] = uses.get(sub.name, 0) + 1
        for name, e in inner.projections:
            if uses.get(name, 0) > 1 and _expr_size(e) > 1:
                return None  # would duplicate work
        new = tuple((n, substitute(e, mapping)) for n, e in node.projections)
        return P.PhysProject(inner.child, new)


class PushFilterThroughProject(Rule):
    """Filter(Project) → Project(Filter): substitute projected expressions
    into the predicate so the filter can keep sinking toward the scan (the
    local step of ``PredicatePushDown``).  Guarded against duplicating
    expensive projections into the predicate."""

    pattern = Pattern(P.PhysFilter,
                      lambda n: isinstance(n.child, P.PhysProject))

    def apply(self, node):
        proj = node.child
        mapping = dict(proj.projections)
        refs = ir.referenced_columns(node.predicate)
        if any(_expr_size(mapping.get(r, ir.Literal(0, None))) > 3
               for r in refs):
            return None
        pred = substitute(node.predicate, mapping)
        return P.PhysProject(P.PhysFilter(proj.child, pred),
                             proj.projections)


# ----------------------------------------------------------- schema helper

def output_columns(node: P.PhysOp) -> Optional[frozenset]:
    """Output column names of a physical subtree (None = unknown — rules
    relying on this must then stay conservative)."""
    if isinstance(node, P.PhysScan):
        return frozenset(node.alias_prefix + c for c in node.columns)
    if isinstance(node, (P.PhysFilter, P.PhysLimit, P.PhysSort)):
        return output_columns(node.child)
    if isinstance(node, P.PhysProject):
        return frozenset(n for n, _ in node.projections)
    if isinstance(node, P.PhysHashAggregate):
        return frozenset([n for n, _ in node.groups]
                         + [s.name for s in node.aggs])
    if isinstance(node, P.PhysHashJoin):
        probe = output_columns(node.probe)
        if probe is None:
            return None
        if node.kind in ("semi", "anti"):
            return probe
        return probe | {o for o, _ in node.build_payload}
    return None


def conjuncts(e: ir.Expr) -> List[ir.Expr]:
    if isinstance(e, ir.Logical) and e.op == "and":
        return list(e.args)
    return [e]


# ---------------------------------------------------- join rules (CBO-lite)

class PushFilterThroughJoin(Rule):
    """Filter(Join) → Join with conjuncts sunk into the matching side — the
    join step of the reference's ``PredicatePushDown``.  Probe-side
    conjuncts push for every join kind (probe rows filter before or after
    identically); build-side conjuncts push only for INNER joins (for LEFT
    they would also drop null-extended probe rows)."""

    pattern = Pattern(P.PhysFilter,
                      lambda n: isinstance(n.child, P.PhysHashJoin))

    def apply(self, node):
        j = node.child
        probe_cols = output_columns(j.probe)
        if probe_cols is None:
            return None
        payload = dict(j.build_payload)  # out_name → build col
        to_probe, to_build, kept = [], [], []
        for c in conjuncts(node.predicate):
            refs = set(ir.referenced_columns(c))
            if refs <= probe_cols and j.kind != "full":
                # FULL: removing a probe row pre-join would resurface its
                # build partners null-extended — semantics change
                to_probe.append(c)
            elif j.kind == "inner" and refs <= set(payload):
                mapping = {r.name: ir.ColumnRef(payload[r.name], r.dtype)
                           for r in ir.walk(c)
                           if isinstance(r, ir.ColumnRef)}
                to_build.append(substitute(c, mapping))
            else:
                kept.append(c)
        if not to_probe and not to_build:
            return None
        probe = (P.PhysFilter(j.probe, ir.and_(*to_probe))
                 if to_probe else j.probe)
        build = (P.PhysFilter(j.build, ir.and_(*to_build))
                 if to_build else j.build)
        out = dataclasses.replace(j, probe=probe, build=build)
        if kept:
            out = P.PhysFilter(out, ir.and_(*kept))
        return out


class FlipJoinToSmallerBuild(Rule):
    """Inner join whose build side is estimated ≥2× the probe side flips,
    hashing the smaller relation — the size heuristic of the reference's
    CBO (``iterative/rule/ReorderJoins.java`` /
    ``DetermineJoinDistributionType``'s size comparison), driven by the
    generator statistics the planner stamps as ``build_est``/``probe_est``.

    Guarded so the output schema is provably unchanged: the old build's
    columns must be exactly its payload outputs (no renames), so after the
    flip the join emits the same column set."""

    pattern = Pattern(
        P.PhysHashJoin,
        lambda n: (n.kind == "inner" and not n.unique_build
                   and n.build_est > 0 and n.probe_est > 0
                   and n.build_est >= 2 * n.probe_est
                   and all(o == b for o, b in n.build_payload)))

    def apply(self, node):
        bcols = output_columns(node.build)
        pcols = output_columns(node.probe)
        if bcols is None or pcols is None:
            return None
        if bcols != frozenset(o for o, _ in node.build_payload):
            return None
        return dataclasses.replace(
            node,
            probe=node.build, build=node.probe,
            probe_keys=node.build_keys, build_keys=node.probe_keys,
            unique_build=False,
            build_payload=tuple((c, c) for c in sorted(pcols)),
            build_est=node.probe_est, probe_est=node.build_est,
            build_cap_est=-1.0)


def _constant_keys(keys) -> bool:
    return all(isinstance(k, ir.Literal) for k in keys)


class DetermineJoinDistributionType(Rule):
    """Stamp REPLICATED vs PARTITIONED from the build-size estimate — the
    reference's ``DetermineJoinDistributionType`` size-based AUTOMATIC
    policy (``join_max_broadcast_table_size``), as a rule with the
    generator-stats cost hook.  Constant-key (cross) joins stay REPLICATED:
    hashing a constant would route every row to one device."""

    def __init__(self, broadcast_row_limit: float):
        self.broadcast_row_limit = broadcast_row_limit
        # memory follows the build's static BUFFER bound (build_cap_est —
        # filters only mask rows inside traced programs), falling back to
        # the row estimate when the planner didn't stamp one
        self.pattern = Pattern(
            P.PhysHashJoin,
            lambda n: (n.dist_type != "partitioned"
                       and max(n.build_cap_est, n.build_est)
                       > self.broadcast_row_limit
                       and not _constant_keys(n.build_keys)))

    def apply(self, node):
        return dataclasses.replace(node, dist_type="partitioned")


DEFAULT_RULES: Tuple[Rule, ...] = (
    MergeFilters(),
    RemoveTrivialFilters(),
    MergeLimits(),
    MergeLimitWithSort(),
    MergeLimitOverProjectWithSort(),
    InlineProjections(),
    PushFilterThroughProject(),
    PushFilterThroughJoin(),
    FlipJoinToSmallerBuild(),
)


# --------------------------------------------------------------- the engine

_CHILD_FIELDS = {
    P.PhysFilter: ("child",),
    P.PhysProject: ("child",),
    P.PhysHashAggregate: ("child",),
    P.PhysSort: ("child",),
    P.PhysLimit: ("child",),
    P.PhysWindow: ("child",),
    P.PhysUnnest: ("child",),
    P.PhysGroupId: ("child",),
    P.PhysHashJoin: ("probe", "build"),
}


class IterativeOptimizer:
    """Bottom-up fixpoint rewriter (``IterativeOptimizer.exploreGroup``)."""

    def __init__(self, rules: Iterable[Rule] = DEFAULT_RULES,
                 budget: int = 10_000):
        self.rules = list(rules)
        self.budget = budget
        self.applied: List[str] = []  # rule-name trace (EXPLAIN-able)

    def optimize(self, plan: P.PhysOp) -> P.PhysOp:
        self._done: set = set()  # ids of fixpointed nodes (the Memo role)
        self._fuel = self.budget
        self.applied = []
        return self._explore(plan)

    def _explore(self, node: P.PhysOp) -> P.PhysOp:
        if id(node) in self._done:
            return node
        node = self._explore_children(node)
        progress = True
        while progress and self._fuel > 0:
            progress = False
            for rule in self.rules:
                if not rule.pattern.matches(node):
                    continue
                out = rule.apply(node)
                if out is None or out is node:
                    continue
                self._fuel -= 1
                self.applied.append(rule.name)
                node = self._explore_children(out)
                progress = True
                break
        self._done.add(id(node))
        return node

    def _explore_children(self, node: P.PhysOp) -> P.PhysOp:
        fields = _CHILD_FIELDS.get(type(node))
        if fields:
            repl = {}
            for f in fields:
                old = getattr(node, f)
                new = self._explore(old)
                if new is not old:
                    repl[f] = new
            if repl:
                node = dataclasses.replace(node, **repl)
            return node
        if isinstance(node, P.PhysConcat):
            return P.PhysConcat(tuple(self._explore(c) for c in node.inputs))
        if isinstance(node, P.PhysScalarBind):
            return P.PhysScalarBind(
                self._explore(node.child),
                tuple((n, self._explore(p)) for n, p in node.bindings))
        return node  # leaf


def optimize(plan: P.PhysOp,
             rules: Iterable[Rule] = DEFAULT_RULES,
             trace: Optional[List[str]] = None) -> P.PhysOp:
    opt = IterativeOptimizer(rules)
    out = opt.optimize(plan)
    if trace is not None:
        trace.extend(opt.applied)
    return out
