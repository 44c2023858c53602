"""SQL planner: analyzed AST → physical plan.

Condenses the reference's analyzer + logical planner + key optimizer rules
(``sql/analyzer/StatementAnalyzer.java``, ``sql/planner/LogicalPlanner.java:195``,
``planner/iterative/rule/``) into one pass that emits the TPU physical plan:

- scope/name resolution (accepts both spec column names ``l_shipdate`` and
  the reference connector's stripped names ``l.shipdate``)
- predicate decomposition + pushdown (``PredicatePushDown``), common-conjunct
  extraction from OR arms (``ExtractCommonPredicatesExpressionRewriter`` —
  what makes Q19's join key visible)
- greedy stats-guided join ordering with PK-side build selection
  (``ReorderJoins`` + ``DetermineJoinDistributionType`` reduced to heuristics)
- subquery decorrelation (``TransformCorrelatedScalarAggregation``,
  ``TransformExistsApplyToCorrelatedJoin`` equivalents):
  EXISTS/NOT EXISTS → semi/anti join (+ residual non-equi filter),
  IN (subquery) → semi join, correlated scalar aggregate → group-by + join,
  uncorrelated scalar → ScalarBind
- aggregate extraction (partial/final split happens later, at the
  distributed fragmenter level)
"""

from __future__ import annotations

import datetime as dt
from dataclasses import dataclass, field as dfield
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ...data import types as T
from ...exec import plan as P
from ...tpch import schema as SCH
from .. import ast
from .. import ir

AGG_FUNCS = {"sum", "avg", "count", "min", "max", "stddev", "stddev_samp",
             "stddev_pop", "variance", "var_samp", "var_pop", "bool_and",
             "bool_or", "approx_distinct", "arbitrary", "any_value",
             "min_by", "max_by", "approx_percentile",
             "corr", "covar_samp", "covar_pop", "regr_slope",
             "regr_intercept", "array_agg", "map_agg", "histogram",
             "checksum", "geometric_mean", "bitwise_and_agg",
             "bitwise_or_agg"}
EPOCH = dt.date(1970, 1, 1)


def _days(iso: str) -> int:
    return (dt.date.fromisoformat(iso) - EPOCH).days


def _timestamp_micros(text: str) -> int:
    t = text.strip()
    if " " in t:
        d = dt.datetime.fromisoformat(t)
    else:
        d = dt.datetime.combine(dt.date.fromisoformat(t), dt.time())
    if d.tzinfo is not None:
        raise ValueError("zoned literal — use _timestamp_tz_parts")
    return int((d - dt.datetime(1970, 1, 1)).total_seconds() * 1_000_000)


def _timestamp_tz_parts(text: str):
    """``'2020-06-10 15:30:00 +05:30'`` → (utc_micros, offset_minutes),
    or None when the literal carries no zone.  Literal zones are fixed
    offsets (reference: ``spi/TimeZoneKey`` resolves names to offsets;
    named IANA zones need per-instant DST rules — see at_timezone)."""
    t = text.strip()
    if " " not in t:
        return None
    # python's fromisoformat accepts '+05:30' only without the space
    head, _, tail = t.rpartition(" ")
    if tail and tail[0] in "+-" and ":" in tail:
        t = head + tail
    d = dt.datetime.fromisoformat(t)
    if d.tzinfo is None:
        return None
    off_min = int(d.utcoffset().total_seconds() // 60)
    utc = d.astimezone(dt.timezone.utc).replace(tzinfo=None)
    us = int((utc - dt.datetime(1970, 1, 1)).total_seconds() * 1_000_000)
    return us, off_min


def _add_interval(d: dt.date, n: int, unit: str) -> dt.date:
    if unit == "day":
        return d + dt.timedelta(days=n)
    if unit == "month":
        m = d.month - 1 + n
        y = d.year + m // 12
        return dt.date(y, m % 12 + 1, min(d.day, 28) if d.day > 28 else d.day)
    if unit == "year":
        return dt.date(d.year + n, d.month, d.day)
    raise ValueError(unit)


# ---------------------------------------------------------------- scopes

@dataclass
class _PreResolved(ast.Node):
    """AST shim carrying an already-resolved IR expression — lets the
    post-aggregation resolver hand pre-resolved argument exprs back
    through the scalar-function machinery."""
    expr: object


@dataclass
class Scope:
    # (alias_or_None, column_name) -> (physical_name, dtype)
    entries: Dict[Tuple[Optional[str], str], Tuple[str, T.DataType]] = dfield(
        default_factory=dict)

    def add(self, alias: Optional[str], name: str, phys: str, dtype):
        self.entries[(alias, name)] = (phys, dtype)
        self.entries.setdefault((None, name), (phys, dtype))

    def resolve(self, parts: Tuple[str, ...]):
        if len(parts) == 1:
            return self.entries.get((None, parts[0]))
        if len(parts) == 2:
            # alias.column first, then row-field dereference r.x of a
            # SHREDDED row column stored under the dotted physical name
            return (self.entries.get((parts[0], parts[1]))
                    or self.entries.get((None, f"{parts[0]}.{parts[1]}")))
        if len(parts) == 3:
            # alias.row.field
            return (self.entries.get((parts[0], f"{parts[1]}.{parts[2]}"))
                    or self.entries.get((None, ".".join(parts))))
        return None

    def row_group(self, name: str):
        """Field entries of a shredded row column ``name`` (dotted
        physical columns ``name.x``), in insertion order."""
        out = []
        seen = set()
        for (a, n), (phys, dt) in self.entries.items():
            if a is None and n.startswith(name + ".") and "." not in \
                    n[len(name) + 1:] and phys not in seen:
                seen.add(phys)
                out.append((n[len(name) + 1:], phys, dt))
        return out

    def merged(self, other: "Scope") -> "Scope":
        s = Scope(dict(self.entries))
        for k, v in other.entries.items():
            if k in s.entries and k[0] is None:
                continue  # ambiguous unqualified name: first wins; qualified ok
            s.entries[k] = v
        return s

    def output_names(self) -> List[str]:
        seen = []
        for (a, n), (phys, _) in self.entries.items():
            if phys not in seen:
                seen.append(phys)
        return seen


@dataclass
class Rel:
    plan: P.PhysOp
    scope: Scope
    columns: Set[str]
    unique_keys: List[frozenset] = dfield(default_factory=list)
    est: float = 1e6
    # unfiltered cardinality of the relation (scan rows); 0 = unknown.
    # est/base is the retained fraction — a PK–FK join keeps that
    # fraction of probe rows (the CBO's join-selectivity estimate,
    # reference: ``cost/JoinStatsRule``)
    base: float = 0.0


# ---------------------------------------------------------------- planner

class Planner:
    def __init__(self, scale_factor: float, extra_tables=None,
                 extra_stats=None, warnings=None):
        self.sf = scale_factor
        self.warnings = warnings      # WarningCollector | None
        self.counter = 0
        self.used_prefixes: Set[str] = set()
        self.ctes: Dict[str, ast.Select] = {}
        # non-tpch connector tables: name → [(col, type)]
        self.extra_tables: Dict[str, list] = extra_tables or {}
        # physical column name → (table, base_col, scan_instance_id) when
        # the column is a verbatim passthrough of an unmodified tpch
        # base-table scan, or None when the name has been (re)defined by
        # any other producer (memory table, computed projection, set op).
        # Consulted by the functional-dependency group-key pruning in
        # apply_aggregation — name-prefix inference alone mis-fired on
        # memory/CTAS tables that merely reuse tpch column names, and the
        # instance id keeps self-joins re-exported through one subquery
        # from mixing two scans of the same table into one FD group.
        self._base_prov: Dict[str, Optional[Tuple[str, str, int]]] = {}
        # every physical column name defined by a scan so far — a second
        # unaliased scan reusing a name gets a disambiguating prefix
        self._defined_phys: Set[str] = set()
        # name → (row_count, primary_key) from connector metadata (the
        # ConnectorMetadata.getTableStatistics seam)
        self.extra_stats: Dict[str, tuple] = extra_stats or {}

    def fresh(self, base: str) -> str:
        self.counter += 1
        return f"${base}{self.counter}"

    def _register_prov(self, phys: str,
                       prov: Optional[Tuple[str, str, int]]):
        """Record (or conflict-poison) base-table provenance for a
        physical column name.  A name defined twice with differing
        provenance is poisoned to None — FD pruning then never fires
        on it (conservative, always sound)."""
        prev = self._base_prov.get(phys, prov)
        self._base_prov[phys] = prov if prev == prov else None

    # aggregation-resolution state is per-SELECT; nested subquery planning
    # saves and restores it (fixes HAVING subqueries clobbering outer state)
    _AGG_ATTRS = ("_agg_specs", "_agg_map", "_cur_scope", "_cur_outer",
                  "_group_map", "_post_scope")

    def _save_agg_state(self):
        return {a: getattr(self, a, None) for a in self._AGG_ATTRS}

    def _restore_agg_state(self, s):
        for a in self._AGG_ATTRS:
            setattr(self, a, s[a])

    # ---- entry ----

    def plan(self, query) -> P.PhysOp:
        rel = self.plan_query(query, outer=None)
        return rel.plan

    @staticmethod
    def _desugar_ordinals(q: ast.Select) -> None:
        """GROUP BY 1 / ORDER BY 2: bare integer literals are output
        ordinals (reference: StatementAnalyzer ordinal resolution).
        Idempotent in-place rewrite (CTE ASTs replan per reference)."""
        def item(n):
            if not (1 <= n <= len(q.items)) or \
                    isinstance(q.items[n - 1].expr, ast.Star):
                raise KeyError(f"ordinal {n} out of select-list range")
            return q.items[n - 1]

        q.group_by = [
            (item(int(g.text)).expr
             if isinstance(g, ast.NumberLit) and g.text.isdigit() else g)
            for g in q.group_by]
        for oi in q.order_by:
            e = oi.expr
            if isinstance(e, ast.NumberLit) and e.text.isdigit():
                it = item(int(e.text))
                oi.expr = (ast.Ident((it.alias,)) if it.alias
                           else it.expr)

    def plan_query(self, q, outer) -> Rel:
        if isinstance(q, ast.Select):
            self._desugar_ordinals(q)
        if isinstance(q, ast.SetOp):
            return self.plan_setop(q, outer)
        if isinstance(q, ast.Select) and q.group_by and \
                isinstance(q.group_by[0], ast.GroupingSets):
            return self.plan_grouping_sets(q, outer)
        return self.plan_select(q, outer)

    def plan_grouping_sets(self, q: ast.Select, outer) -> Rel:
        """GROUPING SETS / ROLLUP / CUBE via a native GroupId expansion:
        the input plans ONCE, each row replicates per grouping set with
        non-participating keys NULLed, and a single aggregation keyed on
        (set ordinal, keys) produces every set's groups (reference:
        ``operator/GroupIdOperator.java`` + ``QueryPlanner`` grouping-set
        lowering; the round-3 UNION-per-set rewrite re-scanned the input
        once per set)."""
        gs = q.group_by[0]
        assert len(q.group_by) == 1, "grouping sets mixed with plain keys"
        # WITH clauses register here too: plan_query dispatches grouping
        # sets BEFORE plan_select's CTE registration runs
        saved_ctes = dict(self.ctes)
        for name, cq in q.with_ctes:
            self.ctes[name] = cq
        try:
            return self._plan_grouping_sets_body(q, gs, outer)
        finally:
            self.ctes = saved_ctes

    def _plan_grouping_sets_body(self, q: ast.Select, gs, outer) -> Rel:
        cur = self._plan_from_where(q, outer)

        all_keys = _flatten_sets(gs)
        key_irs = [self.resolve(k, cur.scope, outer) for k in all_keys]
        sets = tuple(tuple(any(k == m for m in keyset) for k in all_keys)
                     for keyset in gs.sets)
        gid = self.fresh("groupid")
        keys = []
        self._pre_group_aliases = {}
        for ke in key_irs:
            name = self.fresh("gkey")
            keys.append((name, ke))
            self._pre_group_aliases[ke] = (name, ke.dtype)
            cur.scope.add(None, name, name, ke.dtype)
            cur.columns.add(name)
        cur.plan = P.PhysGroupId(cur.plan, tuple(keys), sets, gid)
        cur.scope.add(None, gid, gid, T.BIGINT)
        cur.columns.add(gid)
        cur.est = cur.est * len(sets)
        # grouping() resolution context: (gid column, original key IRs,
        # per-set participation)
        self._grouping_ctx = (gid, key_irs, sets)

        q2 = ast.Select(q.items, q.from_, None,
                        [ast.Ident((gid,))] +
                        [ast.Ident((n,)) for n, _ in keys],
                        q.having, q.order_by, q.limit, q.distinct,
                        q.with_ctes)
        try:
            out = self._plan_select_rest(cur, q2, outer)
        finally:
            self._pre_group_aliases = {}
            self._grouping_ctx = None
        # drop the internal gid column from the outputs (it is a group
        # key, so step 6 projected it only if an item referenced it)
        return out

    def plan_setop(self, q: ast.SetOp, outer) -> Rel:
        """UNION [ALL] / INTERSECT / EXCEPT (reference: UnionNode +
        SetOperationNodeTranslator — distinct set ops lower to aggregation
        and semi/anti joins)."""
        left = self.plan_query(q.left, outer)
        right = self.plan_query(q.right, outer)
        lnames = _output_order(left.plan)
        rnames = _output_order(right.plan)
        assert len(lnames) == len(rnames), "set operands differ in arity"
        # align right outputs positionally to left names/types
        projections = []
        for ln, rn in zip(lnames, rnames):
            lt = left.scope.resolve((ln,))[1]
            rt = right.scope.resolve((rn,))[1]
            e: ir.Expr = ir.ColumnRef(rn, rt)
            if T.is_decimal(lt) and T.is_decimal(rt) and lt.scale != rt.scale:
                e = ir.Cast(e, lt)
            projections.append((ln, e))
        right_plan = P.PhysProject(right.plan, tuple(projections))

        scope = Scope()
        for ln in lnames:
            scope.add(None, ln, ln, left.scope.resolve((ln,))[1])
            self._base_prov[ln] = None  # mixed-branch values: no FD
        types = {ln: left.scope.resolve((ln,))[1] for ln in lnames}
        gb = tuple((n, ir.ColumnRef(n, types[n])) for n in lnames)

        if q.op == "union":
            plan = P.PhysConcat((left.plan, right_plan))
            if not q.all:
                plan = P.PhysHashAggregate(plan, gb, (), ndv_hint=4096)
        elif q.op in ("intersect", "except"):
            # distinct semantics: dedup left, then semi/anti join right
            dl = P.PhysHashAggregate(left.plan, gb, (), ndv_hint=4096)
            plan = P.PhysHashJoin(
                dl, right_plan,
                tuple(ir.ColumnRef(n, types[n]) for n in lnames),
                tuple(ir.ColumnRef(n, types[n]) for n in lnames),
                kind="semi" if q.op == "intersect" else "anti",
                unique_build=False, build_est=right.est,
                probe_est=left.est)
        else:
            raise NotImplementedError(q.op)
        out = Rel(plan, scope, set(lnames), [frozenset(lnames)],
                  left.est + right.est)
        if q.order_by:
            keys = []
            for oi in q.order_by:
                if isinstance(oi.expr, ast.NumberLit):
                    n = lnames[int(oi.expr.text) - 1]
                    keys.append((ir.ColumnRef(n, types[n]), oi.descending))
                else:
                    keys.append((self.resolve(oi.expr, scope, None),
                                 oi.descending))
            out.plan = P.PhysSort(out.plan, tuple(keys), q.limit)
        elif q.limit is not None:
            out.plan = P.PhysSort(out.plan, ((ir.lit_bigint(0), False),),
                                  q.limit)
        return out

    # ---- relations ----

    def plan_table(self, ref: ast.TableRef) -> Rel:
        name = ref.catalog_parts[-1].lower()
        if name in self.ctes:
            sub = self.plan_query(self.ctes[name], outer=None)
            return self._aliased_subquery(sub, ref.alias or name)
        if name in self.extra_tables:
            return self._plan_memory_table(ref, name)
        if name not in SCH.TABLE_SCHEMAS:
            raise KeyError(f"unknown table {name}")
        prefix = ""
        if ref.alias and ref.alias != name:
            prefix = ref.alias + "__"
        while prefix and prefix in self.used_prefixes:
            prefix += "x"
        if prefix:
            self.used_prefixes.add(prefix)
        scope = Scope()
        cols = set()
        strip = SCH.COLUMN_PREFIXES[name]
        alias = ref.alias or name
        self.counter += 1
        scan_id = self.counter if prefix else 0  # unaliased scans share id
        for cname, ctype in SCH.TABLE_SCHEMAS[name]:
            phys = prefix + cname
            cols.add(phys)
            self._defined_phys.add(phys)
            self._register_prov(phys, (name, cname, scan_id))
            scope.add(alias, cname, phys, ctype)
            if cname.startswith(strip):
                scope.add(alias, cname[len(strip):], phys, ctype)
        plan = P.PhysScan(name, tuple(c for c, _ in SCH.TABLE_SCHEMAS[name]),
                          alias_prefix=prefix)
        uk = [frozenset(prefix + k for k in SCH.PRIMARY_KEYS[name])]
        est = SCH.CATALOG.row_count(SCH.TableHandle(name, self.sf))
        return Rel(plan, scope, cols, uk, est, base=est)

    def _plan_unnest(self, r: "ast.UnnestRef", base: Rel) -> Rel:
        """CROSS JOIN UNNEST(...) over the preceding relation (reference:
        ``sql/planner/RelationPlanner.visitUnnest`` + UnnestNode)."""
        exprs = [self.resolve(e, base.scope, None) for e in r.exprs]
        names: List[Tuple[str, ...]] = []
        scope = Scope(dict(base.scope.entries))
        cols = set(base.columns)
        ai = 0
        aliases = list(r.col_aliases)
        for e in exprs:
            if T.is_map(e.dtype):
                outs = []
                for which, dt in (("key", e.dtype.key),
                                  ("value", e.dtype.value)):
                    nm = aliases[ai] if ai < len(aliases) else which
                    ai += 1
                    phys = self.fresh(nm)
                    scope.add(r.alias, nm, phys, dt)
                    cols.add(phys)
                    outs.append(phys)
                names.append(tuple(outs))
            else:
                assert T.is_array(e.dtype), f"UNNEST over {e.dtype}"
                nm = aliases[ai] if ai < len(aliases) else f"col{ai + 1}"
                ai += 1
                phys = self.fresh(nm)
                scope.add(r.alias, nm, phys, e.dtype.element)
                cols.add(phys)
                names.append((phys,))
        ord_phys = None
        if r.ordinality:
            nm = aliases[ai] if ai < len(aliases) else "ordinality"
            ord_phys = self.fresh(nm)
            scope.add(r.alias, nm, ord_phys, T.BIGINT)
            cols.add(ord_phys)
        plan = P.PhysUnnest(base.plan, tuple(exprs), tuple(names), ord_phys)
        return Rel(plan, scope, cols, [], est=base.est * 4)

    def plan_match_recognize(self, r: "ast.MatchRecognizeRef") -> Rel:
        """FROM t MATCH_RECOGNIZE (...) → PhysMatchRecognize Rel.

        Output scope: PARTITION BY columns (under their names) + measure
        names.  Reference: ``sql/tree/PatternRecognitionRelation`` analyzed
        by ``StatementAnalyzer.visitPatternRecognitionRelation``."""
        from ..ir import Shifted  # noqa: F401 (resolution target)
        base = self.plan_table(r.source)
        scope = base.scope
        parts = []
        for e in r.partition_by:
            pe = self.resolve(e, scope, None)
            assert isinstance(pe, ir.ColumnRef), \
                "MATCH_RECOGNIZE PARTITION BY must be plain columns"
            parts.append(pe)
        order = tuple((self.resolve(it.expr, scope, None), it.descending)
                      for it in r.order_by)
        # pattern symbols: any symbol without a DEFINE matches every row
        from ...ops import pattern as PT

        def syms(node, out):
            if isinstance(node, PT.Sym):
                out.append(node.name)
            elif isinstance(node, PT.Seq):
                for p in node.parts:
                    syms(p, out)
            elif isinstance(node, PT.Alt):
                for p in node.options:
                    syms(p, out)
            elif isinstance(node, PT.Quant):
                syms(node.arg, out)
        pat_syms: list = []
        syms(r.pattern, pat_syms)
        defined = {s for s, _ in r.defines}
        self._mr_symbols = set(pat_syms) | defined
        try:
            defines = [(s, self.resolve(p, scope, None))
                       for s, p in r.defines]
            for s in dict.fromkeys(pat_syms):       # stable order
                if s not in defined:
                    defines.append((s, ir.Literal(True, T.BOOLEAN)))
            measures = []
            out_scope = Scope()
            out_cols = set()
            alias = r.alias
            for pe, e in zip(parts, r.partition_by):
                public = e.parts[-1] if isinstance(e, ast.Ident) else pe.name
                out_scope.add(alias, public, pe.name, pe.dtype)
                out_cols.add(pe.name)
            for expr, mname in r.measures:
                if isinstance(expr, ast.FuncCall) and expr.name in (
                        "first", "last") and len(expr.args) == 1:
                    arg = self.resolve(expr.args[0], scope, None)
                    measures.append((mname, expr.name, arg))
                    dtype = arg.dtype
                elif isinstance(expr, ast.FuncCall) \
                        and expr.name == "count":
                    measures.append((mname, "count", None))
                    dtype = T.BIGINT
                elif isinstance(expr, ast.FuncCall) \
                        and expr.name == "match_number":
                    measures.append((mname, "match_number", None))
                    dtype = T.BIGINT
                else:
                    # plain expression: FINAL LAST semantics (value at the
                    # match's last row — Trino's default for ONE ROW PER
                    # MATCH measures without navigation)
                    arg = self.resolve(expr, scope, None)
                    measures.append((mname, "last", arg))
                    dtype = arg.dtype
                out_scope.add(alias, mname, mname, dtype)
                out_cols.add(mname)
        finally:
            self._mr_symbols = None
        passthrough = ()
        if r.all_rows:
            # ALL ROWS PER MATCH: every source column passes through
            # alongside the (running) measures — reference:
            # ``PatternRecognitionRelation.RowsPerMatch.ALL_SHOW_EMPTY``
            # family (we implement the default ALL ROWS semantics)
            seen = set(out_cols)
            pt = []
            for (a, nm), (phys, dt) in list(scope.entries.items()):
                if phys not in seen:
                    seen.add(phys)
                    pt.append(phys)
                out_scope.add(alias, nm, phys, dt)
                out_cols.add(phys)
            passthrough = tuple(pt)
        plan = P.PhysMatchRecognize(
            base.plan, tuple(parts), order, tuple(measures), r.pattern,
            tuple(defines), all_rows=r.all_rows, passthrough=passthrough)
        return Rel(plan, out_scope, out_cols, [], base.est)

    def _plan_memory_table(self, ref: ast.TableRef, name: str) -> Rel:
        """Scan of a writable memory-catalog table (plugin/trino-memory)."""
        cols_types = self.extra_tables[name]
        prefix = ""
        if ref.alias and ref.alias != name:
            prefix = ref.alias + "__"
            while prefix in self.used_prefixes:
                prefix += "x"
            self.used_prefixes.add(prefix)
        alias = ref.alias or name
        if not prefix and any(cname in self._defined_phys
                              for cname, _ in cols_types):
            # an unaliased extra-catalog scan whose column names collide
            # with an earlier scan in this query: without disambiguation
            # the equi-join predicate would resolve both sides to ONE
            # physical column and the join degenerates to a cross join
            prefix = alias + "__"
            while prefix in self.used_prefixes:
                prefix += "x"
            self.used_prefixes.add(prefix)
        scope = Scope()
        cols = set()
        for cname, ctype in cols_types:
            phys = prefix + cname
            cols.add(phys)
            self._defined_phys.add(phys)
            self._base_prov[phys] = None  # not a tpch base column
            scope.add(alias, cname, phys, ctype)
        plan = P.PhysScan(name, tuple(c for c, _ in cols_types),
                          alias_prefix=prefix)
        rows, pkey = self.extra_stats.get(name, (10_000.0, ()))
        uk = [frozenset(prefix + k for k in pkey)] if pkey else []
        return Rel(plan, scope, cols, uk, float(rows), base=float(rows))

    def _aliased_subquery(self, sub: Rel, alias: str) -> Rel:
        """Rename subquery outputs into an alias-prefixed namespace."""
        prefix = alias + "__"
        while prefix in self.used_prefixes:
            prefix += "x"
        self.used_prefixes.add(prefix)
        scope = Scope()
        projections = []
        cols = set()
        rename: Dict[str, str] = {}
        for (a, cname), (phys, ctype) in list(sub.scope.entries.items()):
            if phys not in rename:
                rename[phys] = prefix + phys.split("__")[-1]
                projections.append(
                    (rename[phys], ir.ColumnRef(phys, ctype)))
                cols.add(rename[phys])
                # passthrough of a base column keeps its provenance (a
                # derived table re-exporting scan columns verbatim is
                # still FD-sound); anything else is poisoned
                self._register_prov(rename[phys],
                                    self._base_prov.get(phys))
            scope.add(alias, cname, rename[phys], ctype)
        plan = P.PhysProject(sub.plan, tuple(projections))
        uk = [frozenset(rename.get(c, c) for c in k) for k in sub.unique_keys
              if all(c in rename for c in k)]
        return Rel(plan, scope, cols, uk, sub.est)

    # ---- expression resolution ----

    def resolve(self, node: ast.Node, scope: Scope,
                outer: Optional[Scope] = None) -> ir.Expr:
        r = self._resolve(node, scope, outer)
        return r

    # MATCH_RECOGNIZE define/measure resolution context: symbol names whose
    # qualifier strips to the source row, enabling PREV/NEXT navigation
    _mr_symbols: Optional[set] = None

    def _resolve(self, node, scope, outer) -> ir.Expr:
        if isinstance(node, _PreResolved):
            return node.expr
        if isinstance(node, ast.Ident):
            if node.parts == ("null",):
                return ir.Literal(None, T.BIGINT)
            if self._mr_symbols and len(node.parts) == 2 \
                    and node.parts[0] in self._mr_symbols:
                node = ast.Ident((node.parts[1],))  # B.x → current row's x
            hit = scope.resolve(node.parts)
            if hit:
                return ir.ColumnRef(hit[0], hit[1])
            # bare reference to a SHREDDED row column: re-assemble a
            # plan-time RowValue over its field columns
            grp = scope.row_group(node.parts[-1]) if len(node.parts) <= 2 \
                else []
            if grp:
                return ir.RowValue(tuple(
                    (f, ir.ColumnRef(phys, dt)) for f, phys, dt in grp))
            if outer is not None:
                hit = outer.resolve(node.parts)
                if hit:
                    return ir.ColumnRef(hit[0], hit[1], outer=True)
            if len(node.parts) == 1 and node.parts[0] in (
                    "current_date", "current_timestamp",
                    "localtimestamp"):
                # SQL's paren-less niladic datetime functions
                return self._resolve_scalar_func(
                    ast.FuncCall(node.parts[0], ()), scope, outer)
            raise KeyError(f"cannot resolve column {'.'.join(node.parts)}")
        if isinstance(node, ast.NumberLit):
            text = node.text
            if "." in text or "e" in text or "E" in text:
                if "e" in text.lower():
                    raise NotImplementedError("float literals")
                intpart, frac = (text.split(".") + [""])[:2]
                scale = len(frac)
                unscaled = int((intpart or "0") + frac)
                return ir.lit_decimal(unscaled, scale)
            return ir.lit_bigint(int(text))
        if isinstance(node, ast.StringLit):
            return ir.lit_string(node.value)
        if isinstance(node, ast.DateLit):
            return ir.lit_date(_days(node.value))
        if isinstance(node, ast.TimestampLit):
            tz = _timestamp_tz_parts(node.value)
            if tz is not None:
                return ir.Literal(tz, T.TIMESTAMP_TZ)
            micros = _timestamp_micros(node.value)
            return ir.Literal(micros, T.TIMESTAMP)
        if isinstance(node, ast.IntervalLit):
            # first-class interval value (reference:
            # ``spi/type/IntervalDayTimeType``/``IntervalYearMonthType``)
            if node.unit in ("year", "month"):
                months = node.value * (12 if node.unit == "year" else 1)
                return ir.Literal(months, T.INTERVAL_YEAR_MONTH)
            per = {"day": 86_400_000_000, "week": 7 * 86_400_000_000,
                   "hour": 3_600_000_000, "minute": 60_000_000,
                   "second": 1_000_000}[node.unit]
            return ir.Literal(node.value * per, T.INTERVAL_DAY_TIME)
        if isinstance(node, ast.BinaryOp):
            if node.op in ("and", "or"):
                l = self._resolve(node.left, scope, outer)
                r = self._resolve(node.right, scope, outer)
                return ir.and_(l, r) if node.op == "and" else ir.or_(l, r)
            if node.op in ("=", "<>", "<", "<=", ">", ">="):
                lrow = (isinstance(node.left, ast.FuncCall)
                        and node.left.name == "row")
                rrow = (isinstance(node.right, ast.FuncCall)
                        and node.right.name == "row")
                if lrow and rrow:
                    # ROW comparison decomposes at plan time (reference:
                    # ``RowComparisonOperators`` — fieldwise/lexicographic)
                    ls = [self._resolve(a, scope, outer)
                          for a in node.left.args]
                    rs = [self._resolve(a, scope, outer)
                          for a in node.right.args]
                    assert len(ls) == len(rs), "row arity mismatch"
                    return _row_compare(node.op, ls, rs)
                l = self._resolve(node.left, scope, outer)
                r = self._resolve(node.right, scope, outer)
                if isinstance(l, ir.RowValue) or isinstance(r, ir.RowValue):
                    assert isinstance(l, ir.RowValue) and \
                        isinstance(r, ir.RowValue), "row vs scalar compare"
                    assert len(l.fields) == len(r.fields), \
                        "row arity mismatch"
                    return _row_compare(node.op,
                                        [e for _, e in l.fields],
                                        [e for _, e in r.fields])
                return ir.Compare(node.op, l, r)
            if node.op in ("+", "-"):
                # date ± interval: literal dates fold at plan time; date/
                # timestamp COLUMNS lower to date_add (reference:
                # ``DateTimeOperators`` registers ±interval per type)
                if isinstance(node.right, ast.IntervalLit):
                    l = self._resolve(node.left, scope, outer)
                    sign = 1 if node.op == "+" else -1
                    if isinstance(l, ir.Literal) and isinstance(l.dtype, T.DateType):
                        d = EPOCH + dt.timedelta(days=int(l.value))
                        d2 = _add_interval(d, sign * node.right.value,
                                           node.right.unit)
                        return ir.lit_date((d2 - EPOCH).days)
                    if isinstance(l.dtype, (T.DateType, T.TimestampType)):
                        unit = node.right.unit
                        return ir.Func(
                            "date_add",
                            (ir.lit_string(unit),
                             ir.lit_bigint(sign * node.right.value), l),
                            l.dtype)
                l = self._resolve(node.left, scope, outer)
                r = self._resolve(node.right, scope, outer)
                return ir.arith(node.op, l, r)
            if node.op in ("*", "/"):
                l = self._resolve(node.left, scope, outer)
                r = self._resolve(node.right, scope, outer)
                return ir.arith(node.op, l, r)
            if node.op == "||":
                l = self._resolve(node.left, scope, outer)
                r = self._resolve(node.right, scope, outer)
                la = sum((a.dtype.length or 64) for a in (l, r)
                         if T.is_string(a.dtype))
                return ir.Func("concat", (l, r), T.varchar(la or 128))
            raise NotImplementedError(f"op {node.op}")
        if isinstance(node, ast.UnaryOp):
            if node.op == "-":
                a = self._resolve(node.arg, scope, outer)
                if isinstance(a, ir.Literal):
                    return ir.Literal(-a.value, a.dtype)
                return ir.Negate(a)
            if node.op == "not":
                return ir.Not(self._resolve(node.arg, scope, outer))
        if isinstance(node, ast.BetweenExpr):
            b = ir.Between(self._resolve(node.arg, scope, outer),
                           self._resolve(node.lo, scope, outer),
                           self._resolve(node.hi, scope, outer))
            return ir.Not(b) if node.negated else b
        if isinstance(node, ast.LikeExpr):
            return ir.Like(self._resolve(node.arg, scope, outer),
                           node.pattern, node.negated)
        if isinstance(node, ast.InListExpr):
            if isinstance(node.arg, ast.FuncCall) and \
                    node.arg.name == "row":
                # tuple IN: (a,b) IN ((1,2),...) -> OR of per-tuple ANDs
                arms = []
                for v in node.values:
                    assert isinstance(v, ast.FuncCall) and v.name == "row", \
                        "tuple IN requires tuple values"
                    comps = [ir.Compare(
                        "=", self._resolve(a, scope, outer),
                        self._resolve(b, scope, outer))
                        for a, b in zip(node.arg.args, v.args)]
                    arms.append(ir.and_(*comps))
                e = ir.or_(*arms)
                return ir.Not(e) if node.negated else e
            vals = []
            for v in node.values:
                rv = self._resolve(v, scope, outer)
                assert isinstance(rv, ir.Literal), "IN list must be literals"
                vals.append(rv.value)
            e = ir.InList(self._resolve(node.arg, scope, outer), tuple(vals))
            return ir.Not(e) if node.negated else e
        if isinstance(node, ast.CaseExpr):
            whens = tuple(
                (self._resolve(c, scope, outer), self._resolve(v, scope, outer))
                for c, v in node.whens)
            default = (self._resolve(node.default, scope, outer)
                       if node.default is not None else None)
            # bare NULL branches adopt the type of the non-null branches
            # (SQL: NULL is untyped until coerced)
            branch_vals = [v for _, v in whens] + (
                [default] if default is not None else [])
            typed = [v.dtype for v in branch_vals
                     if not (isinstance(v, ir.Literal) and v.value is None)]
            if typed:
                rt = typed[0]
                for d in typed[1:]:
                    rt = T.common_super_type(rt, d)
                retype = {id(v) for v in branch_vals
                          if isinstance(v, ir.Literal) and v.value is None}
                if retype:
                    whens = tuple(
                        (c, ir.Literal(None, rt) if id(v) in retype else v)
                        for c, v in whens)
                    if default is not None and id(default) in retype:
                        default = ir.Literal(None, rt)
            else:
                rt = branch_vals[0].dtype
            return ir.Case(whens, default, rt)
        if isinstance(node, ast.ExtractExpr):
            what = node.what.lower()
            arg = self._resolve(node.arg, scope, outer)
            if what == "year":
                return ir.ExtractYear(arg)
            fn = {"month": "month", "day": "day", "hour": "hour",
                  "minute": "minute", "second": "second", "quarter":
                  "quarter", "week": "week", "dow": "day_of_week",
                  "day_of_week": "day_of_week", "doy": "day_of_year",
                  "day_of_year": "day_of_year",
                  "year_of_week": "year_of_week", "yow": "year_of_week",
                  "millisecond": "millisecond"}.get(what)
            assert fn is not None, f"extract({what})"
            return ir.Func(fn, (arg,), T.BIGINT)
        if isinstance(node, ast.SubstringExpr):
            arg = self._resolve(node.arg, scope, outer)
            start = self._resolve(node.start, scope, outer)
            assert isinstance(start, ir.Literal)
            if node.length is None:
                assert isinstance(arg.dtype, (T.VarcharType, T.CharType))
                size = (arg.dtype.length or 64) - int(start.value) + 1
            else:
                ln = self._resolve(node.length, scope, outer)
                assert isinstance(ln, ir.Literal)
                size = int(ln.value)
            return ir.Substring(arg, int(start.value), size)
        if isinstance(node, ast.CastExpr):
            arg = self._resolve(node.arg, scope, outer)
            to = _parse_type(node.type_name)
            if T.is_row(to):
                # CAST(row(...) AS ROW(a t1, b t2)): NAME the fields and
                # cast each (``RowToRowCast``) — stays a plan-time value
                assert isinstance(arg, ir.RowValue), \
                    f"cast to row from {arg.dtype}"
                assert len(arg.fields) == len(to.fields), \
                    "row cast arity mismatch"
                return ir.RowValue(tuple(
                    (fn, e if e.dtype == ft else ir.Cast(e, ft))
                    for (fn, ft), (_, e) in zip(to.fields, arg.fields)))
            if isinstance(arg, ir.RowValue):
                raise NotImplementedError(f"cast row to {to}")
            return ir.Cast(arg, to)
        if isinstance(node, ast.IsNullExpr):
            return ir.IsNull(self._resolve(node.arg, scope, outer),
                             node.negated)
        if isinstance(node, ast.TypedNull):
            inner = self._resolve(node.of, scope, outer)
            return ir.Literal(None, inner.dtype)
        if isinstance(node, ast.WindowExpr):
            wm = getattr(self, "_window_map", None)
            if wm is not None and id(node) in wm:
                return wm[id(node)]
            raise ValueError("window expression outside planned scope")
        if isinstance(node, ast.ScalarSubquery):
            sm = getattr(self, "_scalar_map", None)
            if sm is not None and id(node) in sm:
                return sm[id(node)]
            raise NotImplementedError(
                "scalar subquery in this position")
        if isinstance(node, ast.ArrayLit):
            items = tuple(self._resolve(a, scope, outer) for a in node.items)
            et = T.BIGINT
            if items:
                et = items[0].dtype
                for a in items[1:]:
                    et = T.common_super_type(et, a.dtype)
            return ir.Func("array_pack", items, T.array(et))
        if isinstance(node, ast.Subscript):
            base = self._resolve(node.base, scope, outer)
            idx = self._resolve(node.index, scope, outer)
            if isinstance(base, ir.RowValue):
                # r[n]: 1-based field ordinal, static (``RowFieldReference``)
                assert isinstance(idx, ir.Literal), \
                    "row subscript must be a literal ordinal"
                return base.fields[int(idx.value) - 1][1]
            if T.is_map(base.dtype):
                return ir.Func("map_element_at", (base, idx),
                               base.dtype.value)
            assert T.is_array(base.dtype), f"subscript on {base.dtype}"
            return ir.Func("element_at", (base, idx), base.dtype.element)
        if isinstance(node, ast.FuncCall):
            if self._mr_symbols is not None and node.name in ("prev",
                                                             "next"):
                col = self._resolve(node.args[0], scope, outer)
                k = 1
                if len(node.args) > 1:
                    lit = self._resolve(node.args[1], scope, outer)
                    assert isinstance(lit, ir.Literal), \
                        "PREV/NEXT offset must be a literal"
                    k = int(lit.value)
                return ir.Shifted(col, -k if node.name == "prev" else k)
            return self._resolve_scalar_func(node, scope, outer)
        raise NotImplementedError(type(node).__name__)

    def _resolve_scalar_func(self, node: ast.FuncCall, scope, outer) -> ir.Expr:
        """Scalar function resolution + result typing (the role of
        ``metadata/FunctionRegistry.java`` resolution)."""
        name = node.name
        args = tuple(self._resolve(a, scope, outer) for a in node.args)
        if name == "row":
            # anonymous row constructor — fields named positionally
            # until a CAST(... AS ROW(a t, ...)) names them
            return ir.RowValue(tuple((f"f{i}", e)
                                     for i, e in enumerate(args)))
        if name in ("abs", "upper", "lower", "nullif"):
            return ir.Func(name, args, args[0].dtype)
        if name == "mod":
            return ir.Func(name, args, T.BIGINT)
        if name == "unique_id":
            return ir.Func(name, args, T.BIGINT)
        if name == "length":
            return ir.Func(name, args, T.BIGINT)
        if name in ("month", "day"):
            return ir.Func(name, args, T.BIGINT)
        if name in ("at_timezone", "with_timezone"):
            # e AT TIME ZONE z / with_timezone(ts, z): same instant,
            # new presentation offset (``scalar/AtTimeZone.java``)
            p = (args[0].dtype.precision
                 if T.is_timestamp_tz(args[0].dtype) else 3)
            return ir.Func("at_timezone", args,
                           T.TimestampTzType(precision=min(p, 6)))
        if name == "year":
            return ir.ExtractYear(args[0])
        if name in ("sqrt", "exp", "ln", "log10", "log2", "log", "cbrt",
                    "power", "pow", "atan2", "sin", "cos", "tan", "asin",
                    "acos", "atan", "sinh", "cosh", "tanh", "degrees",
                    "radians", "truncate", "to_unixtime"):
            return ir.Func(name, args, T.DOUBLE)
        if name in ("pi", "e", "infinity", "nan"):
            return ir.Func(name, args, T.DOUBLE)
        if name in ("is_nan", "is_finite", "is_infinite"):
            return ir.Func(name, args, T.BOOLEAN)
        if name in ("ceil", "ceiling", "floor"):
            at = args[0].dtype
            rt = T.DOUBLE if isinstance(at, T.DoubleType) else (
                T.decimal(at.precision, 0) if T.is_decimal(at) else T.BIGINT)
            return ir.Func(name, args, rt)
        if name == "sign":
            at = args[0].dtype
            rt = T.DOUBLE if isinstance(at, T.DoubleType) else (
                T.decimal(1, 0) if T.is_decimal(at) else T.BIGINT)
            return ir.Func(name, args, rt)
        if name in ("width_bucket", "bitwise_and", "bitwise_or",
                    "bitwise_xor", "bitwise_not", "bit_count",
                    "bitwise_left_shift", "bitwise_right_shift",
                    "bitwise_right_shift_arithmetic", "hour", "minute",
                    "second", "millisecond", "year_of_week", "yow"):
            return ir.Func(name, args, T.BIGINT)
        if name == "last_day_of_month":
            return ir.Func(name, args, T.DATE)
        if name == "from_unixtime":
            return ir.Func(name, args, T.TimestampType(precision=3))
        if name == "concat_ws":
            la = sum((a.dtype.length or 64) for a in args[1:]
                     if T.is_string(a.dtype))
            seps = (len(args) - 2) * (args[0].dtype.length or 8)
            return ir.Func(name, args, T.varchar(la + max(seps, 0)))
        if name == "typeof":
            return ir.Literal(str(args[0].dtype), T.VARCHAR)
        if name == "uuid":
            return ir.Func(name, args, T.varchar(36))
        if name == "format":
            return ir.Func(name, args, T.VARCHAR)
        if name in ("date_parse", "parse_datetime"):
            return ir.Func(name, args, T.TimestampType())
        if name in ("levenshtein_distance", "hamming_distance"):
            return ir.Func(name, args, T.BIGINT)
        if name in ("current_date", "now", "current_timestamp",
                    "localtimestamp"):
            # constant within a query (reference: SQL session time) —
            # bound ONCE per plan; cached plans freeze it (documented)
            import datetime as _dtm
            if not hasattr(self, "_session_now"):
                self._session_now = _dtm.datetime.now(_dtm.timezone.utc)
            now = self._session_now
            if name == "current_date":
                days = (now.date() - _dtm.date(1970, 1, 1)).days
                return ir.Literal(days, T.DATE)
            us = int(now.timestamp() * 1e6)
            return ir.Literal(us, T.TimestampType())
        if name == "slice":
            return ir.Func(name, args, args[0].dtype)
        if name == "repeat":
            return ir.Func(name, args, T.array(args[0].dtype))
        if name == "array_join":
            return ir.Func(name, args, T.VARCHAR)
        if name == "arrays_overlap":
            return ir.Func(name, args, T.BOOLEAN)
        if name in ("array_except", "array_intersect", "array_union"):
            return ir.Func(name, args, args[0].dtype)
        if name == "round":
            d = 0
            if len(args) > 1:
                assert isinstance(args[1], ir.Literal)
                d = int(args[1].value)
            return ir.Func("round", args[:1], T.decimal(38, d))
        if name == "if":
            # if(cond, a[, b]) is CASE sugar (reference:
            # ``ConditionalFunctions``/parser desugaring)
            cond = self._resolve(node.args[0], scope, outer)
            a = self._resolve(node.args[1], scope, outer)
            b = (self._resolve(node.args[2], scope, outer)
                 if len(node.args) > 2 else ir.Literal(None, a.dtype))
            rt = a.dtype
            if not (isinstance(b, ir.Literal) and b.value is None):
                rt = T.common_super_type(a.dtype, b.dtype)
            return ir.Case(((cond, a),), b, rt)
        if name in ("ifnull", "nvl"):
            args2 = tuple(self._resolve(a, scope, outer)
                          for a in node.args)
            rt = args2[0].dtype
            for a in args2[1:]:
                rt = T.common_super_type(rt, a.dtype)
            return ir.Func("coalesce", args2, rt)
        if name in ("coalesce", "greatest", "least"):
            rt = args[0].dtype
            for a in args[1:]:
                rt = T.common_super_type(rt, a.dtype)
            return ir.Func(name, args, rt)
        if name == "concat":
            la = sum((a.dtype.length or 64) for a in args
                     if T.is_string(a.dtype))
            return ir.Func(name, args, T.varchar(la))
        if name in ("regexp_like", "starts_with", "ends_with"):
            return ir.Func(name, args, T.BOOLEAN)
        if name in ("regexp_extract", "regexp_replace", "replace", "trim",
                    "ltrim", "rtrim", "reverse", "split_part", "chr",
                    "json_extract_scalar", "json_query", "lpad", "rpad",
                    "translate", "to_hex", "from_hex", "to_base64",
                    "from_base64", "url_extract_protocol",
                    "url_extract_host", "url_extract_path",
                    "url_extract_query", "url_encode", "url_decode",
                    "normalize_space"):
            return ir.Func(name, args, T.VARCHAR)
        if name == "url_extract_port":
            return ir.Func(name, args, T.BIGINT)
        if name in ("strpos", "position", "codepoint", "day_of_week",
                    "dow", "day_of_year", "doy", "quarter", "week",
                    "date_diff"):
            return ir.Func(name, args, T.BIGINT)
        if name == "split":
            return ir.Func(name, args, T.array(T.VARCHAR))
        if name in ("date_format", "format_datetime"):
            return ir.Func(name, args, T.VARCHAR)
        if name == "date_trunc":
            return ir.Func(name, args, args[1].dtype)
        if name == "date_add":
            return ir.Func(name, args, args[2].dtype)
        if name == "cardinality":
            return ir.Func(name, args, T.BIGINT)
        if name == "element_at":
            bt = args[0].dtype
            if T.is_map(bt):
                return ir.Func("map_element_at", args, bt.value)
            assert T.is_array(bt), f"element_at on {bt}"
            return ir.Func(name, args, bt.element)
        if name == "contains":
            return ir.Func(name, args, T.BOOLEAN)
        if name == "array_position":
            return ir.Func(name, args, T.BIGINT)
        if name in ("array_min", "array_max"):
            return ir.Func(name, args, args[0].dtype.element)
        if name in ("array_sort", "array_distinct"):
            return ir.Func(name, args, args[0].dtype)
        if name == "sequence":
            for a in args:
                assert isinstance(a, ir.Literal), \
                    "sequence bounds must be literals (static capacity)"
            return ir.Func(name, args, T.array(T.BIGINT))
        if name == "map":
            ka, va = args
            assert T.is_array(ka.dtype) and T.is_array(va.dtype)
            return ir.Func("map_pack", args,
                           T.map_(ka.dtype.element, va.dtype.element))
        if name == "map_keys":
            return ir.Func(name, args, T.array(args[0].dtype.key))
        if name == "map_values":
            return ir.Func(name, args, T.array(args[0].dtype.value))
        if name in ("substr", "substring"):
            start = args[1]
            assert isinstance(start, ir.Literal)
            if len(args) > 2:
                assert isinstance(args[2], ir.Literal)
                size = int(args[2].value)
            else:
                size = (args[0].dtype.length or 64) - int(start.value) + 1
            return ir.Substring(args[0], int(start.value), size)
        raise NotImplementedError(f"function {name}")

    # ---- conjunct utilities ----

    @staticmethod
    def split_and(node: Optional[ast.Node]) -> List[ast.Node]:
        if node is None:
            return []
        if isinstance(node, ast.BinaryOp) and node.op == "and":
            return Planner.split_and(node.left) + Planner.split_and(node.right)
        return [node]

    @staticmethod
    def _contains_subquery(node: ast.Node) -> bool:
        if isinstance(node, (ast.InSubquery, ast.ExistsExpr, ast.ScalarSubquery)):
            return True
        for attr in ("left", "right", "arg", "lo", "hi"):
            c = getattr(node, attr, None)
            if isinstance(c, ast.Node) and Planner._contains_subquery(c):
                return True
        if isinstance(node, ast.CaseExpr):
            return any(Planner._contains_subquery(x)
                       for c, v in node.whens for x in (c, v))
        return False

    # ---- select planning ----

    def plan_select(self, q: ast.Select, outer: Optional[Scope]) -> Rel:
        saved_ctes = dict(self.ctes)
        saved_agg = self._save_agg_state()  # keep enclosing SELECT's state
        for name, cq in q.with_ctes:
            self.ctes[name] = cq
        try:
            rel = self._plan_select_body(q, outer)
        finally:
            self.ctes = saved_ctes
            self._restore_agg_state(saved_agg)
        return rel

    def _plan_from_where(self, q: ast.Select, outer: Optional[Scope]) -> Rel:
        """Steps 1–4 of SELECT planning: FROM relations, WHERE split,
        join tree, outer joins, subquery conjuncts.  Shared by the plain
        SELECT path and the GROUPING SETS path (which must plan the body
        ONCE and expand it through PhysGroupId)."""
        # 1. FROM → base relations (+ structured outer joins)
        rels: List[Rel] = []
        left_specs: List[Tuple[int, Rel, List[ast.Node], str]] = []
        on_conjuncts: List[ast.Node] = []

        def add_relation(r: ast.Node):
            if isinstance(r, ast.TableRef):
                rels.append(self.plan_table(r))
            elif isinstance(r, ast.MatchRecognizeRef):
                rels.append(self.plan_match_recognize(r))
            elif isinstance(r, ast.SubqueryRef):
                sub = self.plan_query(r.query, outer=None)
                rels.append(self._aliased_subquery(sub, r.alias))
            elif isinstance(r, ast.UnnestRef):
                # lateral: array exprs resolve against the preceding
                # relation, which the unnest node wraps
                assert rels, "UNNEST requires a preceding relation"
                base = rels.pop()
                rels.append(self._plan_unnest(r, base))
            elif isinstance(r, ast.JoinRef):
                if r.kind in ("inner", "cross"):
                    add_relation(r.left)
                    add_relation(r.right)
                    if r.on is not None:
                        on_conjuncts.extend(self.split_and(r.on))
                elif r.kind in ("left", "right", "full"):
                    l, rr = (r.right, r.left) if r.kind == "right" \
                        else (r.left, r.right)
                    add_relation(l)
                    left_idx = len(rels) - 1
                    if isinstance(rr, ast.TableRef):
                        right_rel = self.plan_table(rr)
                    elif isinstance(rr, ast.SubqueryRef):
                        right_rel = self._aliased_subquery(
                            self.plan_select(rr.query, outer=None), rr.alias)
                    else:
                        raise NotImplementedError("nested join right side")
                    left_specs.append(
                        (left_idx, right_rel, self.split_and(r.on),
                         "full" if r.kind == "full" else "left"))
                else:
                    raise NotImplementedError(r.kind)
            else:
                raise NotImplementedError(type(r).__name__)

        for r in q.from_:
            add_relation(r)
        if not rels:
            raise NotImplementedError("SELECT without FROM")

        full_scope = rels[0].scope
        for r in rels[1:]:
            full_scope = full_scope.merged(r.scope)
        for _, rr, _, _ in left_specs:
            full_scope = full_scope.merged(rr.scope)

        # 2. WHERE conjuncts: subquery vs plain
        where_cons = self.split_and(q.where) + on_conjuncts
        plain_ast = [c for c in where_cons if not self._contains_subquery(c)]
        subq_ast = [c for c in where_cons if self._contains_subquery(c)]

        plain = [self.resolve(c, full_scope, outer) for c in plain_ast]

        # conjuncts referencing LEFT JOIN right sides apply AFTER the join
        # (SQL semantics: WHERE over the joined relation; null rows fail)
        base_cols = set()
        for r in rels:
            base_cols |= r.columns
        now, deferred = [], []
        for c in plain:
            (now if set(ir.referenced_columns(c)) <= base_cols
             else deferred).append(c)

        # 3. inner join tree
        cur = self.build_join_tree(rels, now)

        # 3b. structured LEFT/FULL JOINs, then deferred conjuncts
        for left_idx, right_rel, on, jkind in left_specs:
            cur = self.apply_left_join(cur, right_rel, on, outer,
                                       kind=jkind)
            full_scope = cur.scope
        for c in deferred:
            cur.plan = P.PhysFilter(cur.plan, c)

        # 4. subquery conjuncts
        for c in subq_ast:
            cur = self.apply_subquery_conjunct(cur, c, outer)
        return cur

    def _plan_select_body(self, q: ast.Select, outer: Optional[Scope]) -> Rel:
        cur = self._plan_from_where(q, outer)
        return self._plan_select_rest(cur, q, outer)

    def _plan_select_rest(self, cur: Rel, q: ast.Select,
                          outer: Optional[Scope]) -> Rel:
        # 5 (precheck). aggregation presence decides WHERE windows plan:
        # SQL evaluates window functions over the AGGREGATED rows
        # (reference: QueryPlanner plans window() after aggregate()), so
        # with GROUP BY the window pass runs after step 5 below
        has_aggs = any(self._ast_has_agg(it.expr) for it in q.items) \
            or (q.having is not None) or bool(q.group_by)

        # 4b. window functions (after joins/filters, before aggregation
        # when there is none; reference: WindowOperator planning in
        # LocalExecutionPlanner)
        if not has_aggs:
            cur = self.apply_windows(cur, q, outer)

        # 4c. scalar subqueries in the SELECT list → broadcast bindings
        cur = self.apply_select_scalars(cur, q)

        if has_aggs:
            cur, post_scope = self.apply_aggregation(cur, q, outer)
            cur = self.apply_windows(cur, q, outer, post_agg=True,
                                     post_scope=post_scope)
        else:
            post_scope = cur.scope

        # 6. select outputs
        items: List[Tuple[str, ir.Expr]] = []
        for i, it in enumerate(q.items):
            if isinstance(it.expr, ast.Star):
                # expand distinct physical outputs
                seen = set()
                for (a, nme), (phys, dtype) in cur.scope.entries.items():
                    if phys not in seen:
                        seen.add(phys)
                        items.append((phys, ir.ColumnRef(phys, dtype)))
                continue
            if has_aggs:
                e = self.resolve_post_agg(it.expr, post_scope)
            else:
                e = self.resolve(it.expr, post_scope, outer)
            name = it.alias or self._derived_name(it.expr, i)
            if isinstance(e, ir.RowValue):
                # SHRED: one physical column per field, dotted name —
                # re-assembled into a ROW value at the client edge
                # (see ``data/column.py`` ROW kind)
                for fld, fe in e.fields:
                    items.append((f"{name}.{fld}", fe))
                continue
            # duplicate output names get positional suffixes (columns are
            # dict-keyed; both copies are still produced)
            if any(n == name for n, _ in items):
                k = 2
                while any(n == f"{name}_{k}" for n, _ in items):
                    k += 1
                name = f"{name}_{k}"
            # output naming: a pure column rename transfers base-table
            # provenance; a computed expression poisons the output name
            if name != getattr(e, "name", None):
                self._register_prov(
                    name, self._base_prov.get(e.name)
                    if isinstance(e, ir.ColumnRef) else None)
            items.append((name, e))

        proj = P.PhysProject(cur.plan, tuple(items))
        out_scope = Scope()
        for name, e in items:
            out_scope.add(None, name, name, e.dtype)
        out = Rel(proj, out_scope, {n for n, _ in items},
                  cur.unique_keys if not q.distinct else
                  [frozenset(n for n, _ in items)], cur.est)

        # 7. distinct
        if q.distinct:
            gb = tuple((n, ir.ColumnRef(n, e.dtype)) for n, e in items)
            out.plan = P.PhysHashAggregate(out.plan, gb, (), ndv_hint=4096)

        # 8. order/limit (sort keys may reference non-output columns —
        # carried as hidden projection columns, dropped after the sort)
        if q.order_by:
            keys = []
            hidden = []
            out_names = {n for n, _ in items}
            for oi in q.order_by:
                e = self._resolve_order(oi.expr, out_scope, post_scope, items)
                for ref in ir.referenced_columns(e):
                    if ref not in out_names and \
                            all(h != ref for h in hidden):
                        hidden.append(ref)
                keys.append((e, oi.descending))
            if hidden:
                if q.distinct:
                    raise NotImplementedError(
                        "SELECT DISTINCT with ORDER BY on hidden columns")
                src_scope = post_scope
                extra = []
                for h in hidden:
                    hit = src_scope.resolve((h,))
                    if hit is None:
                        # h is already a PHYSICAL column id (e.g. an
                        # aliased-subquery output referenced only in
                        # ORDER BY): find the entry carrying it
                        for (_, _nm), (phys, dt) in \
                                src_scope.entries.items():
                            if phys == h:
                                hit = (phys, dt)
                                break
                    if hit is None:
                        raise KeyError(f"order key column {h}")
                    extra.append((h, ir.ColumnRef(hit[0], hit[1])))
                proj2 = P.PhysProject(cur.plan, tuple(items) + tuple(extra))
                sorted_plan = P.PhysSort(proj2, tuple(keys), q.limit)
                out.plan = P.PhysProject(
                    sorted_plan,
                    tuple((n, ir.ColumnRef(n, e.dtype)) for n, e in items))
            else:
                out.plan = P.PhysSort(out.plan, tuple(keys), q.limit)
        elif q.limit is not None:
            # static-slice limit requires front-compacted rows
            out.plan = P.PhysSort(
                out.plan, ((ir.lit_bigint(0), False),), q.limit)
        return out

    def _resolve_order(self, node, out_scope, post_scope, items):
        if isinstance(node, ast.NumberLit):
            idx = int(node.text) - 1
            name, e = items[idx]
            return ir.ColumnRef(name, e.dtype)
        try:
            return self.resolve(node, out_scope, None)
        except (KeyError, ValueError):
            pass
        return self.resolve_post_agg(node, post_scope) \
            if post_scope is not out_scope else self.resolve(node, post_scope, None)

    def _derived_name(self, node: ast.Node, i: int) -> str:
        if isinstance(node, ast.Ident):
            return node.parts[-1]
        return f"_col{i}"

    # ---- window functions ----

    @staticmethod
    def _collect_windows(node, out):
        if isinstance(node, ast.WindowExpr):
            out.append(node)
            return
        for attr in ("left", "right", "arg", "lo", "hi", "default"):
            c = getattr(node, attr, None)
            if isinstance(c, ast.Node):
                Planner._collect_windows(c, out)
        if isinstance(node, ast.CaseExpr):
            for c, v in node.whens:
                Planner._collect_windows(c, out)
                Planner._collect_windows(v, out)
        if isinstance(node, ast.FuncCall):
            for a in node.args:
                if isinstance(a, ast.Node):
                    Planner._collect_windows(a, out)

    def apply_windows(self, cur: Rel, q: ast.Select, outer,
                      post_agg: bool = False, post_scope=None) -> Rel:
        wins: List[ast.WindowExpr] = []
        for it in q.items:
            if not isinstance(it.expr, ast.Star):
                self._collect_windows(it.expr, wins)
        for oi in q.order_by:
            self._collect_windows(oi.expr, wins)
        if not wins:
            return cur

        if post_agg:
            # window over the aggregation output: args/partition/order
            # resolve against the post-agg scope (group keys + $agg
            # columns); the PhysWindow node sits above the aggregate
            def res(e):
                return self.resolve_post_agg(e, post_scope)

            def scope_add(name, dtype):
                post_scope.add(None, name, name, dtype)
                cur.scope.add(None, name, name, dtype)
        else:
            def res(e):
                return self.resolve(e, cur.scope, outer)

            def scope_add(name, dtype):
                cur.scope.add(None, name, name, dtype)

        self._window_map = {}
        by_spec: Dict[tuple, List[ast.WindowExpr]] = {}
        for w in wins:
            pkey = tuple(res(p) for p in w.partition_by)
            okey = tuple((res(o.expr), o.descending) for o in w.order_by)
            by_spec.setdefault((pkey, okey), []).append(w)
        for (pkey, okey), ws in by_spec.items():
            specs = []
            for w in ws:
                fname = w.func.name
                arg = None
                offset = 1
                if fname in ("lead", "lag"):
                    arg = res(w.func.args[0])
                    if len(w.func.args) > 1:
                        off = res(w.func.args[1])
                        assert isinstance(off, ir.Literal)
                        offset = int(off.value)
                    dtype = arg.dtype
                elif fname == "count" and (not w.func.args or isinstance(
                        w.func.args[0], ast.Star)):
                    fname = "count_star"
                    dtype = T.BIGINT
                elif fname in ("sum", "count", "min", "max", "avg",
                               "first_value"):
                    arg = res(w.func.args[0])
                    if fname == "count":
                        dtype = T.BIGINT
                    elif fname == "sum":
                        if T.is_long_decimal(arg.dtype) or isinstance(
                                arg.dtype, T.DoubleType):
                            # int128 inputs fold to double in the window
                            # kernels (see _exec_window long-decimal note)
                            dtype = T.DOUBLE
                        elif T.is_decimal(arg.dtype):
                            dtype = T.decimal(38, arg.dtype.scale)
                        else:
                            dtype = T.BIGINT
                    elif fname == "avg" and (T.is_long_decimal(arg.dtype)
                                             or isinstance(arg.dtype,
                                                           T.DoubleType)):
                        dtype = T.DOUBLE
                    else:
                        dtype = arg.dtype
                elif fname in ("row_number", "rank", "dense_rank"):
                    dtype = T.BIGINT
                elif fname in ("percent_rank", "cume_dist"):
                    dtype = T.DOUBLE
                elif fname == "ntile":
                    nlit = res(w.func.args[0])
                    assert isinstance(nlit, ir.Literal)
                    offset = int(nlit.value)
                    dtype = T.BIGINT
                elif fname in ("last_value", "nth_value"):
                    arg = res(w.func.args[0])
                    if fname == "nth_value":
                        klit = res(w.func.args[1])
                        assert isinstance(klit, ir.Literal)
                        offset = int(klit.value)
                    dtype = arg.dtype
                else:
                    raise NotImplementedError(f"window function {fname}")
                name = self.fresh("win")
                frame = None
                if w.frame is not None:
                    frame = (w.frame.kind, tuple(w.frame.start),
                             tuple(w.frame.end))
                specs.append(P.WindowSpec(name, fname, arg, offset, frame,
                                          ignore_nulls=w.ignore_nulls))
                self._window_map[id(w)] = ir.ColumnRef(name, dtype)
                scope_add(name, dtype)
                cur.columns.add(name)
            cur.plan = P.PhysWindow(cur.plan, pkey, okey, tuple(specs))
        return cur

    # ---- scalar subqueries in SELECT items ----

    @staticmethod
    def _collect_scalar_subqueries(node, out):
        if isinstance(node, ast.ScalarSubquery):
            out.append(node)
            return
        for attr in ("left", "right", "arg", "lo", "hi", "default"):
            c = getattr(node, attr, None)
            if isinstance(c, ast.Node):
                Planner._collect_scalar_subqueries(c, out)
        if isinstance(node, ast.CaseExpr):
            for c, v in node.whens:
                Planner._collect_scalar_subqueries(c, out)
                Planner._collect_scalar_subqueries(v, out)
        if isinstance(node, ast.FuncCall):
            for a in node.args:
                if isinstance(a, ast.Node):
                    Planner._collect_scalar_subqueries(a, out)

    def apply_select_scalars(self, cur: Rel, q: ast.Select) -> Rel:
        subs: List[ast.ScalarSubquery] = []
        for it in q.items:
            if not isinstance(it.expr, ast.Star):
                self._collect_scalar_subqueries(it.expr, subs)
        if not subs:
            return cur
        self._scalar_map = getattr(self, "_scalar_map", {})
        bindings = []
        for sq in subs:
            sub = self.plan_query(sq.query, outer=None)
            (scol,) = list(sub.columns)
            dtype = sub.scope.resolve((scol,))[1]
            name = self.fresh("scalar")
            bindings.append((name, sub.plan))
            self._scalar_map[id(sq)] = ir.ColumnRef(name, dtype)
            cur.scope.add(None, name, name, dtype)
            cur.columns.add(name)
        cur.plan = P.PhysScalarBind(cur.plan, tuple(bindings))
        return cur

    # ---- aggregation ----

    def _ast_has_agg(self, node) -> bool:
        if isinstance(node, ast.WindowExpr):
            return False  # window functions are not aggregates
        if isinstance(node, ast.FuncCall) and node.name in AGG_FUNCS:
            return True
        for attr in ("left", "right", "arg", "lo", "hi", "start", "length",
                     "default"):
            c = getattr(node, attr, None)
            if isinstance(c, ast.Node) and self._ast_has_agg(c):
                return True
        if isinstance(node, ast.CaseExpr):
            return any(self._ast_has_agg(x)
                       for c, v in node.whens for x in (c, v))
        if isinstance(node, ast.FuncCall):
            return any(self._ast_has_agg(a) for a in node.args
                       if isinstance(a, ast.Node))
        return False

    def apply_aggregation(self, cur: Rel, q: ast.Select,
                          outer: Optional[Scope]):
        scope = cur.scope
        groups: List[Tuple[str, ir.Expr]] = []
        group_map: Dict[ir.Expr, Tuple[str, T.DataType]] = {}
        for i, g in enumerate(q.group_by):
            e = self.resolve(g, scope, outer)
            if isinstance(e, ir.ColumnRef):
                name = e.name
            else:
                name = self.fresh("g")
            groups.append((name, e))
            group_map[e] = (name, e.dtype)

        # functional-dependency pruning: group keys that are non-PK
        # columns of a base table whose FULL primary key is also in the
        # group list are constant per group — hash/sort only the PK and
        # emit the dependents via arbitrary() (Q10 groups by c_custkey +
        # SIX dependent customer columns incl. three wide varchars; the
        # sort-based grouping kernel would otherwise carry ~40 int32
        # sort operands).  Reference: dependent-key pruning in modern
        # optimizers; sound because the equi-join preserves the base
        # row's values.
        dependents: List[Tuple[str, ir.Expr]] = []
        if len(groups) > 1 and not getattr(self, "_grouping_ctx", None):
            # provenance-gated: a key participates only when its physical
            # column provably passes through unmodified from ONE tpch
            # base-table scan instance (tracked by _register_prov; poisoned
            # for memory tables, computed outputs, set ops, or conflicting
            # definitions) — name-prefix matching alone returned wrong
            # GROUP BY results on CTAS tables reusing tpch column names
            by_tbl: Dict[Tuple[str, int], list] = {}
            for name, e in groups:
                if isinstance(e, ir.ColumnRef):
                    prov = self._base_prov.get(e.name)
                    if prov is not None:
                        tbl, base, scan_id = prov
                        by_tbl.setdefault((tbl, scan_id), []).append(
                            (name, e, base))
            prune_names = set()
            for (tbl, _sid), cols in by_tbl.items():
                pk = set(SCH.PRIMARY_KEYS.get(tbl, ()))
                have = {base for _, _, base in cols}
                if pk and pk <= have:
                    prune_names |= {nm for nm, _, base in cols
                                    if base not in pk}
            if prune_names:
                dependents = [(nm, e) for nm, e in groups
                              if nm in prune_names]
                groups = [(nm, e) for nm, e in groups
                          if nm not in prune_names]

        self._agg_specs: List[P.AggSpec] = []
        self._agg_map: Dict[Tuple, str] = {}
        self._cur_scope = scope
        self._cur_outer = outer
        # GROUPING SETS pre-registers original-key-expr → GroupId key
        # column aliases so select items spelling the original key
        # resolve to the NULLed per-set copy
        group_map.update(getattr(self, "_pre_group_aliases", {}))
        self._group_map = group_map

        for name, e in dependents:
            self._agg_specs.append(P.AggSpec(name, "arbitrary", e, False))
            self._agg_map[("arbitrary", e, False, None, None)] = name

        # pre-resolve select/having/order to collect aggregates
        post_scope = Scope()
        for name, e in groups:
            post_scope.add(None, name, name, e.dtype)
        for name, e in dependents:
            post_scope.add(None, name, name, e.dtype)
        self._post_scope = post_scope

        for it in q.items:
            if not isinstance(it.expr, ast.Star):
                self.resolve_post_agg(it.expr, post_scope)
        if q.having is not None:
            for c in self.split_and(q.having):
                if not self._contains_subquery(c):
                    self.resolve_post_agg(c, post_scope)
                else:
                    self._collect_aggs_only(c, post_scope)
        for oi in q.order_by:
            try:
                self.resolve_post_agg(oi.expr, post_scope)
            except (KeyError, ValueError):
                pass

        ndv = 1
        for _, e in groups:
            ndv *= self._ndv_of(e)
        raw_ndv = ndv
        ndv = int(min(max(ndv, 16), max(cur.est, 16)))
        # reliable when the stats weren't capped by a selectivity-
        # discounted estimate (unfiltered input): GROUP BY l_orderkey
        # over the whole table really does have ndv(l_orderkey) groups
        reliable = (cur.base > 0 and cur.est >= cur.base * 0.999
                    and raw_ndv == ndv)

        plan = P.PhysHashAggregate(cur.plan, tuple(groups),
                                   tuple(self._agg_specs), ndv_hint=ndv,
                                   ndv_reliable=reliable)
        uk = [frozenset(n for n, _ in groups)] if groups else []
        rel = Rel(plan, post_scope, {n for n, _ in post_scope.output_names()
                                     } if False else set(post_scope.output_names()),
                  uk, float(ndv))

        # HAVING (plain parts now; subquery parts via scalar bind)
        if q.having is not None:
            for c in self.split_and(q.having):
                if self._contains_subquery(c):
                    rel = self.apply_subquery_conjunct(rel, c, outer,
                                                      post_agg=True)
                else:
                    pred = self.resolve_post_agg(c, post_scope)
                    rel.plan = P.PhysFilter(rel.plan, pred)
        return rel, post_scope

    def _ndv_of(self, e: ir.Expr) -> int:
        if isinstance(e, ir.ColumnRef):
            base = e.name.split("__")[-1]
            for tbl, cols in SCH.TABLE_SCHEMAS.items():
                if any(c == base for c, _ in cols):
                    return SCH.ndv_estimate(tbl, base, self.sf)
        return 64

    def _collect_aggs_only(self, node, post_scope):
        """Collect aggregates from a having-conjunct containing subqueries."""
        if isinstance(node, ast.FuncCall) and node.name in AGG_FUNCS:
            self._agg_ref(node)
            return
        if isinstance(node, (ast.InSubquery, ast.ExistsExpr, ast.ScalarSubquery)):
            return
        for attr in ("left", "right", "arg", "lo", "hi"):
            c = getattr(node, attr, None)
            if isinstance(c, ast.Node):
                self._collect_aggs_only(c, post_scope)

    def _agg_ref(self, node: ast.FuncCall) -> ir.ColumnRef:
        arg2, param = None, None
        if node.name == "count" and (not node.args or
                                     isinstance(node.args[0], ast.Star)):
            key = ("count_star", None, False, None, None)
            arg = None
        elif node.name == "approx_distinct":
            # dense HyperLogLog sketch state (ops/hll.py) — mergeable
            # registers, so distributed execution stays partial→final
            # (reference: ApproximateCountDistinctAggregation)
            arg = self.resolve(node.args[0], self._cur_scope, self._cur_outer)
            key = ("approx_distinct", arg, False, None, None)
            node = ast.FuncCall("approx_distinct", node.args, False)
        elif node.name in ("min_by", "max_by", "corr", "covar_samp",
                           "covar_pop", "regr_slope", "regr_intercept",
                           "map_agg"):
            arg = self.resolve(node.args[0], self._cur_scope, self._cur_outer)
            arg2 = self.resolve(node.args[1], self._cur_scope,
                                self._cur_outer)
            key = (node.name, arg, False, arg2, None)
        elif node.name == "approx_percentile":
            arg = self.resolve(node.args[0], self._cur_scope, self._cur_outer)
            p = self.resolve(node.args[1], self._cur_scope, self._cur_outer)
            if not isinstance(p, ir.Literal):
                raise NotImplementedError(
                    "approx_percentile requires a literal percentile")
            pv = p.value
            if T.is_decimal(p.dtype):
                pv = pv / 10 ** p.dtype.scale
            param = float(pv)
            key = (node.name, arg, False, None, param)
        elif node.name in ("min", "max") and len(node.args) == 2:
            # min(x, n)/max(x, n): the n smallest/largest as an array
            # (reference: ``operator/aggregation/MinMaxNAggregations``)
            arg = self.resolve(node.args[0], self._cur_scope, self._cur_outer)
            nlit = self.resolve(node.args[1], self._cur_scope,
                                self._cur_outer)
            assert isinstance(nlit, ir.Literal), "min/max N must be literal"
            param = int(nlit.value)
            fname = node.name + "_n"
            key = (fname, arg, False, None, param)
            node = ast.FuncCall(fname, node.args, False)
        else:
            arg = self.resolve(node.args[0], self._cur_scope, self._cur_outer)
            key = (node.name, arg, node.distinct, None, None)
        if key not in self._agg_map:
            name = self.fresh("agg")
            func = node.name if arg is not None else "count_star"
            spec = P.AggSpec(name, func, arg, node.distinct,
                             arg2=arg2, param=param)
            self._agg_specs.append(spec)
            self._agg_map[key] = name
            self._post_scope.add(None, name, name,
                                 P._agg_output_type(spec))
        name = self._agg_map[key]
        return ir.ColumnRef(name, self._post_scope.resolve((name,))[1])

    def resolve_post_agg(self, node: ast.Node, post_scope: Scope) -> ir.Expr:
        if isinstance(node, ast.ScalarSubquery):
            sm = getattr(self, "_scalar_map", None)
            if sm is not None and id(node) in sm:
                return sm[id(node)]
            raise NotImplementedError(
                "post-aggregation expression ScalarSubquery")
        if isinstance(node, ast.WindowExpr):
            wm = getattr(self, "_window_map", None)
            if wm is not None and id(node) in wm:
                return wm[id(node)]
            # aggregate-collection phase (apply_aggregation pre-resolves
            # select items BEFORE the post-agg window pass runs): register
            # any aggregates inside the window spec, return a placeholder
            # — the window pass maps this node before outputs resolve
            for p in node.partition_by:
                self.resolve_post_agg(p, post_scope)
            for o in node.order_by:
                self.resolve_post_agg(o.expr, post_scope)
            for a in node.func.args:
                if not isinstance(a, ast.Star):
                    self.resolve_post_agg(a, post_scope)
            return ir.Literal(0, T.BIGINT)
        if isinstance(node, ast.TypedNull):
            inner = self.resolve(node.of, self._cur_scope, self._cur_outer)
            return ir.Literal(None, inner.dtype)
        if isinstance(node, ast.FuncCall) and node.name == "grouping":
            # grouping(e1..ek): bitmask with bit i set when e_i is NOT in
            # the current row's grouping set (reference:
            # ``io.trino.operator.scalar.GroupingOperationFunction``);
            # decodes statically from the GroupId ordinal column
            ctx = getattr(self, "_grouping_ctx", None)
            assert ctx is not None, "grouping() outside GROUPING SETS"
            gid, key_irs, sets = ctx
            arg_irs = [self.resolve(a, self._cur_scope, self._cur_outer)
                       for a in node.args]
            idxs = [key_irs.index(a) for a in arg_irs]
            gid_ref = ir.ColumnRef(gid, T.BIGINT)
            whens = []
            for j, st in enumerate(sets):
                mask = 0
                for bit, ki in enumerate(idxs):
                    if not st[ki]:
                        mask |= 1 << (len(idxs) - 1 - bit)
                whens.append((
                    ir.Compare("=", gid_ref, ir.Literal(j, T.BIGINT)),
                    ir.Literal(mask, T.BIGINT)))
            return ir.Case(tuple(whens), ir.Literal(0, T.BIGINT), T.BIGINT)
        if isinstance(node, ast.FuncCall) and node.name in AGG_FUNCS:
            return self._agg_ref(node)
        # the whole expression may be a GROUP BY expression (e.g. grouping
        # by a CASE and selecting the same CASE)
        if not isinstance(node, (ast.NumberLit, ast.StringLit, ast.DateLit,
                                 ast.Ident)):
            try:
                e = self.resolve(node, self._cur_scope, self._cur_outer)
                if e in self._group_map:
                    gname, gd = self._group_map[e]
                    return ir.ColumnRef(gname, gd)
            except Exception:  # noqa: BLE001 - contains aggs/unresolvables
                pass
        if isinstance(node, ast.Ident):
            hit = post_scope.resolve(node.parts)
            if hit:
                return ir.ColumnRef(hit[0], hit[1])
            # maybe a group expression spelled as a column of the input
            e = self.resolve(node, self._cur_scope, self._cur_outer)
            if e in self._group_map:
                n, d = self._group_map[e]
                return ir.ColumnRef(n, d)
            raise KeyError(f"{'.'.join(node.parts)} not in GROUP BY output")
        # literals resolve as usual
        if isinstance(node, (ast.NumberLit, ast.StringLit, ast.DateLit)):
            return self.resolve(node, post_scope, None)
        # structural recursion via a shallow copy trick
        if isinstance(node, ast.BinaryOp):
            l = self.resolve_post_agg(node.left, post_scope)
            r = self.resolve_post_agg(node.right, post_scope)
            if node.op in ("and", "or"):
                return ir.and_(l, r) if node.op == "and" else ir.or_(l, r)
            if node.op in ("=", "<>", "<", "<=", ">", ">="):
                return ir.Compare(node.op, l, r)
            return ir.arith(node.op, l, r)
        if isinstance(node, ast.UnaryOp):
            a = self.resolve_post_agg(node.arg, post_scope)
            return ir.Not(a) if node.op == "not" else ir.Negate(a)
        if isinstance(node, ast.CaseExpr):
            whens = tuple((self.resolve_post_agg(c, post_scope),
                           self.resolve_post_agg(v, post_scope))
                          for c, v in node.whens)
            default = (self.resolve_post_agg(node.default, post_scope)
                       if node.default is not None else None)
            rt = whens[0][1].dtype
            for _, v in whens[1:]:
                rt = T.common_super_type(rt, v.dtype)
            if default is not None:
                rt = T.common_super_type(rt, default.dtype)
            return ir.Case(whens, default, rt)
        if isinstance(node, ast.BetweenExpr):
            e = ir.Between(self.resolve_post_agg(node.arg, post_scope),
                           self.resolve_post_agg(node.lo, post_scope),
                           self.resolve_post_agg(node.hi, post_scope))
            return ir.Not(e) if node.negated else e
        if isinstance(node, ast.CastExpr):
            a = self.resolve_post_agg(node.arg, post_scope)
            return ir.Cast(a, _parse_type(node.type_name))
        if isinstance(node, ast.FuncCall):
            # scalar function over post-agg exprs (e.g. SELECT
            # substr(group_key, 1, 20), round(sum(x)/count(y), 2)):
            # resolve the args in the post-agg scope, then hand the call
            # through the normal scalar machinery via _PreResolved shims
            args = tuple(
                a if isinstance(a, ast.Star)
                else _PreResolved(self.resolve_post_agg(a, post_scope))
                for a in node.args)
            return self._resolve_scalar_func(
                ast.FuncCall(node.name, args), self._cur_scope,
                self._cur_outer)
        # fall back: group expression spelled structurally
        e = self.resolve(node, self._cur_scope, self._cur_outer)
        if e in self._group_map:
            n, d = self._group_map[e]
            return ir.ColumnRef(n, d)
        raise NotImplementedError(
            f"post-aggregation expression {type(node).__name__}")

    # ---- join ordering ----

    def build_join_tree(self, rels: List[Rel], conjuncts: List[ir.Expr]) -> Rel:
        if len(rels) == 1 and not conjuncts:
            return rels[0]

        # hoist conjuncts common to all OR arms (exposes Q19's join keys)
        extra: List[ir.Expr] = []
        for c in conjuncts:
            if isinstance(c, ir.Logical) and c.op == "or":
                arm_sets = [set(self._split_ir_and(a)) for a in c.args]
                common = set.intersection(*arm_sets) if arm_sets else set()
                extra.extend(common)
        conjuncts = conjuncts + extra

        comps = [Rel(r.plan, r.scope, set(r.columns), list(r.unique_keys),
                     r.est, base=r.base) for r in rels]
        pending: List[ir.Expr] = []

        # single-rel pushdown
        for c in conjuncts:
            refs = set(ir.referenced_columns(c))
            hit = [i for i, r in enumerate(comps) if refs & r.columns]
            if len(hit) == 1 and refs <= comps[hit[0]].columns:
                comps[hit[0]].plan = P.PhysFilter(comps[hit[0]].plan, c)
                comps[hit[0]].est *= self.selectivity(c)
            else:
                pending.append(c)

        def comp_of(col: str) -> Optional[int]:
            for i, r in enumerate(comps):
                if col in r.columns:
                    return i
            return None

        # cost-based join ORDER via dynamic programming over connected
        # sub-plans (the memo role of the reference's ReorderJoins +
        # CostComparator: every connected split of every connected subset
        # is costed with the same est model the greedy merge applies;
        # Cout = sum of intermediate cardinalities).  Falls back to the
        # greedy min-build edge pick on cross joins or >10 relations.
        dp_order = self._dp_join_order(comps, pending)
        comp_sets: List[frozenset] = [frozenset([i])
                                      for i in range(len(comps))]

        while len(comps) > 1:
            # find equi edges between current components
            edges: Dict[Tuple[int, int], List[Tuple[ir.Expr, ir.Expr]]] = {}
            for c in pending:
                pair = self._equi_pair(c, comp_of)
                if pair is None:
                    continue
                (ci, le), (cj, re_) = pair
                if ci == cj:
                    continue
                a, b = (ci, cj) if ci < cj else (cj, ci)
                l, r = (le, re_) if ci < cj else (re_, le)
                edges.setdefault((a, b), []).append((l, r))
            if not edges:
                # cross join (NestedLoopJoinOperator analogue): expand join
                # on a constant key — build side = smallest component
                if self.warnings is not None:
                    self.warnings.add(
                        "CROSS_JOIN",
                        "query contains a cross join (no equi-join "
                        "predicate connects all relations)")
                order = sorted(range(len(comps)),
                               key=lambda i: comps[i].est)
                comps = [comps[i] for i in order]
                comp_sets = [comp_sets[i] for i in order]
                dp_order = None  # cross join: stay greedy
                small, big = comps[0], comps[1]
                payload = tuple((c, c) for c in sorted(small.columns))
                plan = P.PhysHashJoin(
                    big.plan, small.plan,
                    (ir.lit_bigint(0),), (ir.lit_bigint(0),),
                    kind="inner", unique_build=False, build_payload=payload,
                    build_est=small.est, probe_est=big.est)
                merged = Rel(plan, big.scope.merged(small.scope),
                             big.columns | small.columns,
                             [bu | su for bu in big.unique_keys
                              for su in small.unique_keys],
                             big.est * max(small.est, 1))
                new_pending = []
                for c in pending:
                    refs = set(ir.referenced_columns(c))
                    if refs <= merged.columns:
                        merged.plan = P.PhysFilter(merged.plan, c)
                        merged.est *= self.selectivity(c)
                    else:
                        new_pending.append(c)
                pending = new_pending
                comp_sets = [comp_sets[0] | comp_sets[1]] + comp_sets[2:]
                comps = [merged] + comps[2:]
                continue
            # pick the DP-ordered merge when available, else the edge
            # whose smaller side is smallest (build small first)
            pick = None
            if dp_order:
                s1, s2 = dp_order[0]
                ia = next((i for i, s in enumerate(comp_sets)
                           if s == s1), None)
                ib = next((i for i, s in enumerate(comp_sets)
                           if s == s2), None)
                if ia is not None and ib is not None:
                    key = (ia, ib) if ia < ib else (ib, ia)
                    if key in edges:
                        pick = key
                        dp_order = dp_order[1:]
            if pick is None:
                dp_order = None   # desynced: stay greedy from here on
                pick = min(
                    edges,
                    key=lambda k: min(comps[k[0]].est, comps[k[1]].est))
            (a, b), keys = pick, edges[pick]
            def orient(probe_i, build_i):
                probe, build = comps[probe_i], comps[build_i]
                pk, bk = [], []
                for l, r in keys:
                    if set(ir.referenced_columns(l)) <= probe.columns:
                        pk.append(l)
                        bk.append(r)
                    else:
                        pk.append(r)
                        bk.append(l)
                bset = frozenset(c for e in bk
                                 for c in ir.referenced_columns(e))
                unique = any(u <= bset for u in build.unique_keys)
                return probe, build, pk, bk, unique

            # prefer the orientation whose build side has unique keys
            # (PK side builds — keeps probes static-shape and lets the
            # distributed path broadcast; DetermineJoinDistributionType +
            # JoinNode flipping in the reference)
            small_first = (a, b) if comps[a].est >= comps[b].est else (b, a)
            probe, build, pk, bk, unique = orient(*small_first)
            if not unique:
                p2, b2, pk2, bk2, u2 = orient(*reversed(small_first))
                if u2:
                    probe, build, pk, bk, unique = p2, b2, pk2, bk2, u2
                    probe_i, build_i = tuple(reversed(small_first))
                else:
                    probe_i, build_i = small_first
            else:
                probe_i, build_i = small_first
            payload = tuple((c, c) for c in sorted(build.columns))
            plan = P.PhysHashJoin(
                probe.plan, build.plan, tuple(pk), tuple(bk),
                kind="inner", unique_build=unique, build_payload=payload,
                build_est=build.est, probe_est=probe.est,
                build_cap_est=max(build.base, build.est))
            # PK–FK joins retain the build side's surviving key fraction
            # of probe rows (JoinStatsRule-style selectivity)
            frac = 1.0
            if unique and build.base > 0:
                frac = min(1.0, build.est / build.base)
            est = max(probe.est * frac if unique else probe.est * 4, 16.0)
            plan.out_est = est
            merged = Rel(plan, probe.scope.merged(build.scope),
                         probe.columns | build.columns,
                         probe.unique_keys if unique else [
                             pu | bu for pu in probe.unique_keys
                             for bu in build.unique_keys],
                         est, base=probe.base)
            # drop used equi conjuncts, apply now-complete filters
            used = set()
            for l, r in keys:
                used.add(self._mk_eq(l, r))
                used.add(self._mk_eq(r, l))
            new_pending = []
            for c in pending:
                if c in used:
                    continue
                refs = set(ir.referenced_columns(c))
                if refs <= merged.columns:
                    merged.plan = P.PhysFilter(merged.plan, c)
                    merged.est *= self.selectivity(c)
                else:
                    new_pending.append(c)
            pending = new_pending
            merged_set = comp_sets[probe_i] | comp_sets[build_i]
            comp_sets = [s for i, s in enumerate(comp_sets)
                         if i not in (probe_i, build_i)] + [merged_set]
            comps = [r for i, r in enumerate(comps)
                     if i not in (probe_i, build_i)] + [merged]

        out = comps[0]
        for c in pending:
            out.plan = P.PhysFilter(out.plan, c)
        return out

    @staticmethod
    def _split_ir_and(e: ir.Expr) -> List[ir.Expr]:
        if isinstance(e, ir.Logical) and e.op == "and":
            out = []
            for a in e.args:
                out.extend(Planner._split_ir_and(a))
            return out
        return [e]

    @staticmethod
    def _mk_eq(l, r):
        return ir.Compare("=", l, r)

    def _dp_join_order(self, comps: List[Rel], pending: List[ir.Expr]
                       ) -> Optional[List[Tuple[frozenset, frozenset]]]:
        """Bottom-up merge order minimizing Cout (sum of intermediate
        cardinalities) — the memo-based ReorderJoins analogue.  Each DP
        state carries the SAME (est, base, unique_keys) the greedy merge
        would compute, so the chosen order replays exactly through the
        existing merge machinery.  Returns None (fall back to greedy) on
        cross joins, >10 relations, or a disconnected join graph."""
        n = len(comps)
        if n < 3 or n > 10:
            return None

        # equi conjuncts as (left_refs, right_refs) over relation indices
        def rels_of(refs) -> Optional[frozenset]:
            out = set()
            for col in refs:
                hit = next((i for i, r in enumerate(comps)
                            if col in r.columns), None)
                if hit is None:
                    return None
                out.add(hit)
            return frozenset(out)

        equi = []      # (rels_l, rels_r, build_refs_l, build_refs_r)
        other = []     # (rels, selectivity)
        for c in pending:
            if isinstance(c, ir.Compare) and c.op == "=":
                lr = rels_of(ir.referenced_columns(c.left))
                rr = rels_of(ir.referenced_columns(c.right))
                if lr and rr and len(lr) == 1 and len(rr) == 1 \
                        and lr != rr:
                    equi.append((lr, rr,
                                 frozenset(ir.referenced_columns(c.left)),
                                 frozenset(ir.referenced_columns(c.right))))
                    continue
            refs = rels_of(ir.referenced_columns(c))
            if refs:
                other.append((refs, self.selectivity(c)))
        if not equi:
            return None

        # DP state per subset: (cost, est, base, unique_keys, split)
        init = {}
        for i, r in enumerate(comps):
            init[frozenset([i])] = (0.0, r.est, r.base,
                                    [frozenset(u) for u in r.unique_keys],
                                    None)
        best = dict(init)
        full = frozenset(range(n))

        def link_cols(s1: frozenset, s2: frozenset):
            """(probe_keyrefs, build_keyrefs) joining s1(probe)→s2(build);
            None if no equi edge."""
            pk, bk = set(), set()
            for lr, rr, lcols, rcols in equi:
                if lr <= s1 and rr <= s2:
                    pk |= lcols
                    bk |= rcols
                elif rr <= s1 and lr <= s2:
                    pk |= rcols
                    bk |= lcols
            return (pk, bk) if bk else None

        def join_state(st_p, st_b, bk_cols, s_all):
            _, pest, pbase, puk, _ = st_p
            _, best_, bbase, buk, _ = st_b
            unique = any(u <= bk_cols for u in buk)
            frac = 1.0
            if unique and bbase > 0:
                frac = min(1.0, best_ / bbase)
            est = max(pest * frac if unique else pest * 4, 16.0)
            uk = puk if unique else [pu | bu for pu in puk for bu in buk]
            return est, pbase, uk, unique

        # enumerate subsets by popcount; split into connected halves
        subsets = sorted((frozenset(
            i for i in range(n) if m >> i & 1) for m in range(1, 1 << n)),
            key=len)
        filt_done: dict = {}
        for s in subsets:
            if len(s) < 2:
                continue
            bestv = None
            members = sorted(s)
            # iterate proper submasks containing the lowest member (each
            # unordered split once)
            rest = members[1:]
            for m in range(1 << len(rest)):
                s1 = frozenset([members[0]] + [rest[i]
                               for i in range(len(rest)) if m >> i & 1])
                s2 = s - s1
                if not s2 or s1 not in best or s2 not in best:
                    continue
                for p, b in ((s1, s2), (s2, s1)):
                    # replay the greedy orientation rule: probe = larger
                    # est side unless uniqueness prefers the flip
                    link = link_cols(p, b)
                    if link is None:
                        continue
                    st_p, st_b = best[p], best[b]
                    if st_p[1] < st_b[1]:
                        continue  # orientation handled by the (b, p) pass
                    pkc, bkc = link
                    est, base_, uk, unique = join_state(
                        st_p, st_b, frozenset(bkc), s)
                    if not unique:
                        rlink = link_cols(b, p)
                        if rlink is not None:
                            e2, b2, u2, uq2 = join_state(
                                st_b, st_p, frozenset(rlink[1]), s)
                            if uq2:
                                est, base_, uk = e2, b2, u2
                    # apply newly-covered filter selectivities once
                    sel = 1.0
                    for refs, sv in other:
                        if refs <= s and not (refs <= p or refs <= b):
                            sel *= sv
                    est = max(est * sel, 16.0)
                    cost = st_p[0] + st_b[0] + est
                    if bestv is None or cost < bestv[0]:
                        bestv = (cost, est, base_, uk, (p, b))
            if bestv is not None:
                best[s] = bestv
        if full not in best or best[full][4] is None:
            return None

        order: List[Tuple[frozenset, frozenset]] = []

        def emit(s: frozenset):
            if len(s) == 1:
                return
            split = best[s][4]
            emit(split[0])
            emit(split[1])
            order.append((split[0], split[1]))

        emit(full)
        return order

    def _equi_pair(self, c: ir.Expr, comp_of):
        if not (isinstance(c, ir.Compare) and c.op == "="):
            return None
        lrefs = ir.referenced_columns(c.left)
        rrefs = ir.referenced_columns(c.right)
        if not lrefs or not rrefs:
            return None
        ci = comp_of(lrefs[0])
        cj = comp_of(rrefs[0])
        if ci is None or cj is None:
            return None
        if any(comp_of(x) != ci for x in lrefs) or \
           any(comp_of(x) != cj for x in rrefs):
            return None
        return (ci, c.left), (cj, c.right)

    @staticmethod
    def _selectivity(c: ir.Expr) -> float:
        """Crude structural fallback; prefer the stats-aware instance
        method ``selectivity`` (reference: ``cost/FilterStatsCalculator``)."""
        if isinstance(c, ir.Compare):
            return 0.1 if c.op == "=" else 0.4
        if isinstance(c, (ir.Like, ir.InList)):
            return 0.3
        if isinstance(c, ir.Between):
            return 0.3
        return 0.5

    # column-stats-driven predicate selectivity (the FilterStatsCalculator
    # role: equality → 1/ndv, range → interval fraction of [min,max],
    # reference ``cost/FilterStatsCalculator.java`` + ``ComparisonStatsCalculator``)
    _PREFIX_TABLE = {v: k for k, v in SCH.COLUMN_PREFIXES.items()}

    def _col_stats(self, col: str):
        """(ndv, lo, hi) for a physical column name; lo/hi may be None."""
        pre = col.split("_")[0] + "_"
        table = self._PREFIX_TABLE.get(pre)
        ndv = SCH.ndv_estimate(table or "", col, self.sf) if table else None
        rng = SCH.value_range(col, self.sf)
        return ndv, (rng[0] if rng else None), (rng[1] if rng else None)

    @staticmethod
    def _lit_num(e: ir.Expr):
        if isinstance(e, ir.Literal) and isinstance(e.value, (int, float)):
            return float(e.value)
        return None

    def selectivity(self, c: ir.Expr) -> float:
        if isinstance(c, ir.Logical):
            sels = [self.selectivity(a) for a in c.args]
            if c.op == "and":
                out = 1.0
                for s in sels:
                    out *= s
                return out
            out = 0.0                       # OR: inclusion-exclusion, capped
            for s in sels:
                out = out + s - out * s
            return min(out, 1.0)
        if isinstance(c, ir.Compare):
            cols = list(ir.referenced_columns(c))
            if len(cols) == 1:
                col = cols[0]
                ndv, lo, hi = self._col_stats(col)
                lit = self._lit_num(c.right) if isinstance(
                    c.left, ir.ColumnRef) else self._lit_num(c.left)
                op = c.op
                if lit is None and not isinstance(c.left, ir.ColumnRef):
                    pass
                elif not isinstance(c.left, ir.ColumnRef):
                    # literal OP col → flip
                    op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(
                        op, op)
                if op == "=" and ndv:
                    return max(1.0 / ndv, 1e-9)
                if op == "<>" and ndv:
                    return 1.0 - 1.0 / ndv
                if lit is not None and lo is not None and hi > lo:
                    frac = (lit - lo) / (hi - lo)
                    frac = min(max(frac, 0.0), 1.0)
                    if op in ("<", "<="):
                        return max(frac, 0.01)
                    if op in (">", ">="):
                        return max(1.0 - frac, 0.01)
            return self._selectivity(c)
        if isinstance(c, ir.Between):
            cols = list(ir.referenced_columns(c))
            if len(cols) == 1:
                _, lo, hi = self._col_stats(cols[0])
                a, b = self._lit_num(c.lo), self._lit_num(c.hi)
                if None not in (a, b, lo, hi) and hi > lo:
                    return min(max((b - a) / (hi - lo), 0.005), 1.0)
            return 0.3
        if isinstance(c, ir.InList):
            cols = list(ir.referenced_columns(c))
            if len(cols) == 1:
                ndv, _, _ = self._col_stats(cols[0])
                if ndv:
                    return min(len(c.values) / ndv, 1.0)
            return 0.3
        return self._selectivity(c)

    # ---- outer joins ----

    def apply_left_join(self, cur: Rel, right: Rel,
                        on: List[ast.Node], outer,
                        kind: str = "left") -> Rel:
        scope = cur.scope.merged(right.scope)
        cons = [self.resolve(c, scope, outer) for c in on]
        equi_l, equi_r, residual = [], [], []
        right_filters = []
        for c in cons:
            refs = set(ir.referenced_columns(c))
            if refs <= right.columns:
                right_filters.append(c)
                continue
            if isinstance(c, ir.Compare) and c.op == "=":
                lr = set(ir.referenced_columns(c.left))
                rr = set(ir.referenced_columns(c.right))
                if lr <= cur.columns and rr <= right.columns:
                    equi_l.append(c.left)
                    equi_r.append(c.right)
                    continue
                if rr <= cur.columns and lr <= right.columns:
                    equi_l.append(c.right)
                    equi_r.append(c.left)
                    continue
            residual.append(c)
        if kind == "full" and (residual or right_filters):
            # ON-clause single-side predicates / residuals change FULL
            # join retention semantics — keep the supported surface equi-only
            raise NotImplementedError("FULL JOIN requires pure equi ON")
        rplan = right.plan
        for f in right_filters:
            rplan = P.PhysFilter(rplan, f)
        bset = frozenset(c for e in equi_r for c in ir.referenced_columns(e))
        unique = any(u <= bset for u in right.unique_keys)
        payload = tuple((c, c) for c in sorted(right.columns))
        plan = P.PhysHashJoin(
            cur.plan, rplan, tuple(equi_l), tuple(equi_r), kind=kind,
            unique_build=unique, build_payload=payload,
            filter=ir.and_(*residual) if residual else None,
            build_est=right.est, probe_est=cur.est,
            build_cap_est=max(right.base, right.est),
            out_est=cur.est if unique else -1.0)
        return Rel(plan, scope, cur.columns | right.columns,
                   [], cur.est * (1 if unique else 4)
                   + (right.est if kind == "full" else 0))

    # ---- subquery conjuncts ----

    def apply_subquery_conjunct(self, cur: Rel, c: ast.Node,
                                outer: Optional[Scope],
                                post_agg: bool = False) -> Rel:
        negated = False
        node = c
        while isinstance(node, ast.UnaryOp) and node.op == "not":
            negated = not negated
            node = node.arg

        if isinstance(node, ast.ExistsExpr):
            return self._apply_exists(cur, node.query,
                                      negated ^ node.negated, outer)
        if isinstance(node, ast.InSubquery):
            return self._apply_in(cur, node, negated ^ node.negated, outer,
                                  post_agg)
        if isinstance(node, ast.BinaryOp) and node.op in (
                "=", "<>", "<", "<=", ">", ">="):
            sub_side = None
            if isinstance(node.right, ast.ScalarSubquery):
                sub_side, other, op = node.right, node.left, node.op
            elif isinstance(node.left, ast.ScalarSubquery):
                flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}
                sub_side, other = node.left, node.right
                op = flip.get(node.op, node.op)
            if sub_side is not None:
                rel = self._apply_scalar_compare(
                    cur, other, op, sub_side.query, negated, outer, post_agg)
                return rel
        # scalar subqueries inside arbitrary expressions (e.g. HAVING
        # avg(x) > 0.9 * (select ...)): bind each as a broadcast column
        # (EnforceSingleRow role) and resolve the whole predicate
        subs: List[ast.ScalarSubquery] = []
        self._collect_scalar_subqueries(node, subs)
        if subs and not self._contains_in_or_exists(node):
            self._scalar_map = getattr(self, "_scalar_map", {})
            state = self._save_agg_state()
            bindings = []
            seen_here = set()
            for sq in subs:
                if id(sq) in seen_here:
                    continue  # same node twice within THIS predicate
                # NOTE: a map hit from a PREVIOUS plan of the same AST
                # (a CTE replayed per reference) is stale — its binding
                # lives in another plan instance; always rebind
                seen_here.add(id(sq))
                sub = self.plan_query(sq.query, outer=None)
                scol = _output_order(sub.plan)[0]
                dtype = sub.scope.resolve((scol,))[1]
                name = self.fresh("scalar")
                bindings.append((name, sub.plan))
                self._scalar_map[id(sq)] = ir.ColumnRef(name, dtype)
                cur.scope.add(None, name, name, dtype)
                cur.columns.add(name)
            self._restore_agg_state(state)
            if bindings:
                cur.plan = P.PhysScalarBind(cur.plan, tuple(bindings))
            pred = (self.resolve_post_agg(c, cur.scope) if post_agg
                    else self.resolve(c, cur.scope, outer))
            cur.plan = P.PhysFilter(cur.plan, pred)
            return cur
        # subquery under OR / mixed boolean shape: rewrite each
        # uncorrelated IN/EXISTS arm into a MARK semi-join column
        # (reference: SemiJoinNode's output symbol consumed by a filter,
        # ``sql/planner/QueryPlanner`` subquery planning), then filter on
        # the composed predicate
        cur, new_node = self._mark_subqueries(cur, c)
        pred = (self.resolve_post_agg(new_node, cur.scope) if post_agg
                else self.resolve(new_node, cur.scope, outer))
        cur.plan = P.PhysFilter(cur.plan, pred)
        return cur

    @staticmethod
    def _contains_in_or_exists(node) -> bool:
        if isinstance(node, (ast.InSubquery, ast.ExistsExpr)):
            return True
        for attr in ("left", "right", "arg", "lo", "hi"):
            c = getattr(node, attr, None)
            if isinstance(c, ast.Node) and \
                    Planner._contains_in_or_exists(c):
                return True
        if isinstance(node, ast.FuncCall):
            return any(isinstance(a, ast.Node)
                       and Planner._contains_in_or_exists(a)
                       for a in node.args)
        return False

    def _mark_subqueries(self, cur: Rel, node):
        """Replace uncorrelated InSubquery/Exists nodes anywhere in a
        boolean expression with references to mark-join output columns."""
        if isinstance(node, ast.InSubquery):
            cur, name = self._mark_in(cur, node)
            e: ast.Node = ast.Ident((name,))
            if node.negated:
                e = ast.UnaryOp("not", e)
            return cur, e
        if isinstance(node, ast.ExistsExpr):
            cur, name = self._mark_exists(cur, node.query)
            # EXISTS is 2-valued (never NULL): a NULL correlation key or
            # NULL build keys mean "no match" = FALSE, unlike IN
            false = ast.BinaryOp("=", ast.NumberLit("1"),
                                 ast.NumberLit("0"))
            e = ast.FuncCall("ifnull", (ast.Ident((name,)), false))
            if node.negated:
                e = ast.UnaryOp("not", e)
            return cur, e
        if isinstance(node, ast.BinaryOp):
            cur, left = self._mark_subqueries(cur, node.left)
            cur, right = self._mark_subqueries(cur, node.right)
            return cur, ast.BinaryOp(node.op, left, right)
        if isinstance(node, ast.UnaryOp):
            cur, arg = self._mark_subqueries(cur, node.arg)
            return cur, ast.UnaryOp(node.op, arg)
        return cur, node

    def _mark_in(self, cur: Rel, node: ast.InSubquery):
        arg = self.resolve(node.arg, cur.scope, None)
        sub = self.plan_select(node.query, outer=None)
        out_names = list(sub.columns)
        assert len(out_names) == 1, "IN subquery must produce one column"
        (out_name,) = out_names
        dtype = sub.scope.resolve((out_name,))[1]
        mark = self.fresh("mark")
        plan = P.PhysHashJoin(
            cur.plan, sub.plan, (arg,),
            (ir.ColumnRef(out_name, dtype),), kind="mark",
            unique_build=False, mark_name=mark,
            build_est=sub.est, probe_est=cur.est,
            build_cap_est=max(sub.base, sub.est))
        scope = cur.scope.merged(Scope())
        scope.add(None, mark, mark, T.BOOLEAN)
        return Rel(plan, scope, cur.columns | {mark}, cur.unique_keys,
                   cur.est), mark

    def _mark_exists(self, cur: Rel, q: ast.Select):
        """EXISTS as a mark column.  Correlated arms probe on their
        equi-correlation keys (the reference plans these as SemiJoinNode
        outputs consumed by the OR filter, ``sql/planner/QueryPlanner``);
        uncorrelated arms degrade to a constant-key join against the
        subquery's row set."""
        parts = SubqueryParts(self, q, cur.scope)
        inner = self.build_join_tree(parts.rels, parts.inner_conjuncts)
        for c in parts.extra_subqueries:
            inner = self.apply_subquery_conjunct(inner, c,
                                                 parts.scope_for_inner)
        if parts.corr_other:
            raise NotImplementedError(
                "non-equi correlated EXISTS under OR")
        if parts.corr_eq:
            probe_keys = tuple(self._strip_outer(o)
                               for o, _ in parts.corr_eq)
            build_keys = tuple(i for _, i in parts.corr_eq)
        else:
            one = ir.Literal(1, T.BIGINT)
            probe_keys, build_keys = (one,), (one,)
        mark = self.fresh("mark")
        plan = P.PhysHashJoin(
            cur.plan, inner.plan, probe_keys, build_keys, kind="mark",
            unique_build=False, mark_name=mark,
            build_est=inner.est, probe_est=cur.est,
            build_cap_est=max(inner.base, inner.est))
        scope = cur.scope.merged(Scope())
        scope.add(None, mark, mark, T.BOOLEAN)
        return Rel(plan, scope, cur.columns | {mark}, cur.unique_keys,
                   cur.est), mark

    def _subquery_correlation(self, q: ast.Select, cur_scope: Scope):
        """Plan a subquery's FROM + split conjuncts by correlation."""
        sub = SubqueryParts(self, q, cur_scope)
        return sub

    def _apply_exists(self, cur: Rel, q: ast.Select, negated: bool,
                      outer) -> Rel:
        parts = SubqueryParts(self, q, cur.scope)
        inner = self.build_join_tree(parts.rels, parts.inner_conjuncts)
        for c in parts.extra_subqueries:
            inner = self.apply_subquery_conjunct(inner, c, parts.scope_for_inner)
        probe_keys = tuple(o for o, _ in parts.corr_eq)
        build_keys = tuple(i for _, i in parts.corr_eq)
        residual = None
        payload: Tuple[Tuple[str, str], ...] = ()
        if parts.corr_other:
            residual = ir.and_(*[self._strip_outer(c) for c in parts.corr_other])
            pay_cols = set(ir.referenced_columns(residual)) & inner.columns
            payload = tuple((p, p) for p in sorted(pay_cols))
        plan = P.PhysHashJoin(
            cur.plan, inner.plan,
            tuple(self._strip_outer(k) for k in probe_keys),
            build_keys, kind="anti" if negated else "semi",
            unique_build=False, build_payload=payload, filter=residual,
            build_est=inner.est, probe_est=cur.est, out_est=cur.est)
        return Rel(plan, cur.scope, cur.columns, cur.unique_keys, cur.est)

    def _apply_in(self, cur: Rel, node: ast.InSubquery, negated: bool,
                  outer, post_agg: bool) -> Rel:
        def res(e):
            return (self.resolve_post_agg(e, cur.scope) if post_agg
                    else self.resolve(e, cur.scope, outer))

        if isinstance(node.arg, ast.FuncCall) and node.arg.name == "row":
            # multi-column IN: (a, b) IN (select x, y ...) — the semi
            # join probes on every component key
            args = tuple(res(a) for a in node.arg.args)
        else:
            args = (res(node.arg),)
        sub = self.plan_select(node.query, outer=None)
        out_names = _output_order(sub.plan)
        assert len(out_names) == len(args), \
            "IN subquery arity must match the probe tuple"
        build_keys = tuple(
            ir.ColumnRef(n, sub.scope.resolve((n,))[1])
            for n in out_names)
        plan = P.PhysHashJoin(
            cur.plan, sub.plan, args, build_keys,
            kind="anti" if negated else "semi", unique_build=False,
            build_est=sub.est, probe_est=cur.est,
            build_cap_est=max(sub.base, sub.est), out_est=cur.est)
        return Rel(plan, cur.scope, cur.columns, cur.unique_keys, cur.est)

    def _apply_scalar_compare(self, cur: Rel, other: ast.Node, op: str,
                              q: ast.Select, negated: bool, outer,
                              post_agg: bool) -> Rel:
        # resolve the outer operand FIRST: planning the subquery below may
        # re-enter apply_aggregation and clobber this planner's agg state
        oth = (self.resolve_post_agg(other, cur.scope) if post_agg
               else self.resolve(other, cur.scope, outer))
        parts = SubqueryParts(self, q, cur.scope)
        if not parts.corr_eq and not parts.corr_other:
            # uncorrelated scalar → bind as broadcast column
            sub = self.plan_select(q, outer=None)
            name = self.fresh("scalar")
            (scol,) = list(sub.columns)
            dtype = sub.scope.resolve((scol,))[1]
            bind = P.PhysScalarBind(cur.plan, ((name, sub.plan),))
            pred = ir.Compare(op, oth, ir.ColumnRef(name, dtype))
            if negated:
                pred = ir.Not(pred)
            plan = P.PhysFilter(bind, pred)
            return Rel(plan, cur.scope, cur.columns, cur.unique_keys, cur.est)

        assert not parts.corr_other, "non-equi correlated scalar subquery"
        # correlated scalar aggregate → group by correlation keys + join
        inner = self.build_join_tree(parts.rels, parts.inner_conjuncts)
        for c in parts.extra_subqueries:
            inner = self.apply_subquery_conjunct(inner, c, parts.scope_for_inner)
        # build aggregate over the subquery's single select item
        assert len(q.items) == 1
        self._agg_specs = []
        self._agg_map = {}
        self._cur_scope = inner.scope
        self._cur_outer = None
        self._group_map = {}
        groups = []
        post_scope = Scope()
        self._post_scope = post_scope
        for i, (o, inner_key) in enumerate(parts.corr_eq):
            assert isinstance(inner_key, ir.ColumnRef), "non-column corr key"
            groups.append((inner_key.name, inner_key))
            post_scope.add(None, inner_key.name, inner_key.name,
                           inner_key.dtype)
            self._group_map[inner_key] = (inner_key.name, inner_key.dtype)
        val_expr = self.resolve_post_agg(q.items[0].expr, post_scope)
        val_name = self.fresh("sq")
        agg = P.PhysHashAggregate(
            inner.plan, tuple(groups), tuple(self._agg_specs),
            ndv_hint=int(min(inner.est, 1 << 20)))
        proj = P.PhysProject(agg, tuple(
            [(n, ir.ColumnRef(n, e.dtype)) for n, e in groups]
            + [(val_name, val_expr)]))
        probe_keys = tuple(self._strip_outer(o) for o, _ in parts.corr_eq)
        build_keys = tuple(ir.ColumnRef(n, e.dtype) for n, e in groups)
        payload = ((val_name, val_name),)
        join = P.PhysHashJoin(cur.plan, proj, probe_keys, build_keys,
                              kind="inner", unique_build=True,
                              build_payload=payload,
                              build_est=min(inner.est, float(1 << 20)),
                              probe_est=cur.est)
        pred = ir.Compare(op, oth, ir.ColumnRef(val_name, val_expr.dtype))
        if negated:
            pred = ir.Not(pred)
        plan = P.PhysFilter(join, pred)
        return Rel(plan, cur.scope, cur.columns | {val_name},
                   cur.unique_keys, cur.est)

    def _strip_outer(self, e: ir.Expr) -> ir.Expr:
        if isinstance(e, ir.ColumnRef):
            return ir.ColumnRef(e.name, e._dtype, False)
        if isinstance(e, ir.Compare):
            return ir.Compare(e.op, self._strip_outer(e.left),
                              self._strip_outer(e.right))
        if isinstance(e, ir.Logical):
            return ir.Logical(e.op, tuple(self._strip_outer(a) for a in e.args))
        if isinstance(e, ir.Not):
            return ir.Not(self._strip_outer(e.arg))
        if isinstance(e, ir.Arith):
            return ir.Arith(e.op, self._strip_outer(e.left),
                            self._strip_outer(e.right), e._dtype)
        return e


class SubqueryParts:
    """Planned FROM + conjunct classification for a (possibly correlated)
    subquery: inner conjuncts, correlated equalities, other correlated
    predicates, and nested subquery conjuncts."""

    def __init__(self, planner: Planner, q: ast.Select, outer_scope: Scope):
        assert not q.group_by and q.having is None, \
            "correlated subquery with GROUP BY unsupported"
        self.rels: List[Rel] = []
        on_cons: List[ast.Node] = []

        def add(r):
            if isinstance(r, ast.TableRef):
                self.rels.append(planner.plan_table(r))
            elif isinstance(r, ast.SubqueryRef):
                sub = planner.plan_query(r.query, outer=None)
                self.rels.append(planner._aliased_subquery(sub, r.alias))
            elif isinstance(r, ast.JoinRef) and r.kind in ("inner", "cross"):
                add(r.left)
                add(r.right)
                if r.on is not None:
                    on_cons.extend(planner.split_and(r.on))
            else:
                raise NotImplementedError

        for r in q.from_:
            add(r)
        scope = self.rels[0].scope
        for r in self.rels[1:]:
            scope = scope.merged(r.scope)
        self.scope_for_inner = scope

        cons = planner.split_and(q.where) + on_cons
        self.extra_subqueries = [c for c in cons
                                 if planner._contains_subquery(c)]
        plain = [c for c in cons if not planner._contains_subquery(c)]

        self.inner_conjuncts: List[ir.Expr] = []
        self.corr_eq: List[Tuple[ir.Expr, ir.ColumnRef]] = []  # (outer, inner)
        self.corr_other: List[ir.Expr] = []
        for c in plain:
            e = planner.resolve(c, scope, outer_scope)
            outs = [x for x in ir.walk(e)
                    if isinstance(x, ir.ColumnRef) and x.outer]
            if not outs:
                self.inner_conjuncts.append(e)
                continue
            if isinstance(e, ir.Compare) and e.op == "=":
                lo = isinstance(e.left, ir.ColumnRef) and e.left.outer
                ro = isinstance(e.right, ir.ColumnRef) and e.right.outer
                if lo and not any(isinstance(x, ir.ColumnRef) and x.outer
                                  for x in ir.walk(e.right)):
                    self.corr_eq.append((e.left, e.right))
                    continue
                if ro and not any(isinstance(x, ir.ColumnRef) and x.outer
                                  for x in ir.walk(e.left)):
                    self.corr_eq.append((e.right, e.left))
                    continue
            self.corr_other.append(e)


def _output_order(plan: P.PhysOp) -> List[str]:
    """Ordered output column names of a planned SELECT."""
    if isinstance(plan, P.PhysProject):
        return [n for n, _ in plan.projections]
    if isinstance(plan, P.PhysHashAggregate):
        return [n for n, _ in plan.groups] + [s.name for s in plan.aggs]
    if isinstance(plan, (P.PhysFilter, P.PhysSort, P.PhysLimit)):
        return _output_order(plan.child)
    if isinstance(plan, P.PhysHashJoin):
        return _output_order(plan.probe)
    if isinstance(plan, P.PhysConcat):
        return _output_order(plan.inputs[0])
    raise NotImplementedError(
        f"output order of {type(plan).__name__}")


def _flatten_sets(gs: ast.GroupingSets):
    out = []
    for keys in gs.sets:
        for k in keys:
            if not any(k == o for o in out):
                out.append(k)
    return out


def _row_compare(op: str, ls, rs) -> ir.Expr:
    """Fieldwise/lexicographic ROW comparison decomposition."""
    if op == "=":
        return ir.and_(*[ir.Compare("=", a, b) for a, b in zip(ls, rs)])
    if op == "<>":
        return ir.or_(*[ir.Compare("<>", a, b) for a, b in zip(ls, rs)])
    strict = op.rstrip("=")          # "<" or ">"
    out = None
    # build right-to-left: last field uses the original op (incl. =)
    for i in range(len(ls) - 1, -1, -1):
        this_op = op if i == len(ls) - 1 else strict
        cmp_i = ir.Compare(this_op, ls[i], rs[i])
        if out is None:
            out = cmp_i
        else:
            out = ir.or_(cmp_i if i == len(ls) - 1 else
                         ir.Compare(strict, ls[i], rs[i]),
                         ir.and_(ir.Compare("=", ls[i], rs[i]), out))
    return out


def _split_commas(s: str):
    """Split on top-level commas (nested parens stay intact)."""
    out, depth, start = [], 0, 0
    for i, ch in enumerate(s):
        depth += ch == "("
        depth -= ch == ")"
        if ch == "," and depth == 0:
            out.append(s[start:i])
            start = i + 1
    out.append(s[start:])
    return out


def _parse_type(name: str) -> T.DataType:
    name = name.lower()
    if name in ("bigint", "integer", "int"):
        return T.BIGINT
    if name == "double":
        return T.DOUBLE
    if name == "date":
        return T.DATE
    if name.startswith("timestamp"):
        tz = name.endswith("with time zone")
        if "(" in name:
            p = int(name[name.index("(") + 1:name.index(")")])
            return (T.TimestampTzType(precision=min(p, 6)) if tz
                    else T.TimestampType(precision=min(p, 6)))
        return T.TIMESTAMP_TZ if tz else T.TIMESTAMP
    if name.replace(" ", "") in ("intervaldaytosecond", "intervalday"):
        return T.INTERVAL_DAY_TIME
    if name.replace(" ", "") in ("intervalyeartomonth", "intervalyear",
                                 "intervalmonth"):
        return T.INTERVAL_YEAR_MONTH
    if name.startswith("decimal"):
        if "(" in name:
            inner = name[name.index("(") + 1:-1]
            p, s = (inner.split(",") + ["0"])[:2]
            return T.decimal(int(p), int(s))
        return T.decimal(38, 0)
    if name.startswith("varchar") or name.startswith("char"):
        return T.varchar()
    if name == "boolean":
        return T.BOOLEAN
    if name in ("real", "float"):
        return T.DOUBLE
    if name in ("smallint", "tinyint"):
        return T.BIGINT
    if name.startswith("row(") and name.endswith(")"):
        fields = []
        for part in _split_commas(name[4:-1]):
            fname, _, ftype = part.strip().partition(" ")
            fields.append((fname, _parse_type(ftype.strip())))
        return T.RowType(tuple(fields))
    if name.startswith("array(") and name.endswith(")"):
        return T.ArrayType(_parse_type(name[6:-1]))
    if name.startswith("map(") and name.endswith(")"):
        inner = name[4:-1]
        depth, split = 0, None
        for i, ch in enumerate(inner):
            depth += ch == "("
            depth -= ch == ")"
            if ch == "," and depth == 0:
                split = i
                break
        if split is not None:
            return T.MapType(_parse_type(inner[:split]),
                             _parse_type(inner[split + 1:]))
    raise NotImplementedError(f"type {name}")
