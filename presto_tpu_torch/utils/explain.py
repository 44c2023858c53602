"""Plan printing: EXPLAIN / EXPLAIN ANALYZE.

The analogue of the reference's ``sql/planner/planprinter/PlanPrinter`` +
``ExplainAnalyzeOperator``: renders the physical plan tree with per-node
detail; with stats, annotates each node with rows/time from the last run.

Torch port of ``presto_tpu/utils/explain.py``: it walks the node classes
of ``presto_tpu_torch/exec/plan.py``.  The port has no fused path, so a
node's ANALYZE note is always the operator path's (rows, self wall time
fenced on the card, output bytes), never a fused fragment's.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..exec import plan as P
from ..sql import ir


def _expr_str(e: ir.Expr) -> str:
    if isinstance(e, ir.ColumnRef):
        return e.name
    if isinstance(e, ir.Literal):
        return repr(e.value)
    if isinstance(e, ir.Arith):
        return f"({_expr_str(e.left)} {e.op} {_expr_str(e.right)})"
    if isinstance(e, ir.Compare):
        return f"({_expr_str(e.left)} {e.op} {_expr_str(e.right)})"
    if isinstance(e, ir.Logical):
        return f" {e.op.upper()} ".join(_expr_str(a) for a in e.args)
    if isinstance(e, ir.Not):
        return f"NOT ({_expr_str(e.arg)})"
    if isinstance(e, ir.Like):
        return (f"{_expr_str(e.arg)} {'NOT ' if e.negated else ''}"
                f"LIKE '{e.pattern}'")
    if isinstance(e, ir.InList):
        return (f"{_expr_str(e.arg)} IN ("
                + ", ".join(ir.literal_text(v) for v in e.values) + ")")
    if isinstance(e, ir.Between):
        return (f"{_expr_str(e.arg)} BETWEEN {_expr_str(e.lo)} "
                f"AND {_expr_str(e.hi)}")
    if isinstance(e, ir.Case):
        return "CASE ..."
    if isinstance(e, ir.ExtractYear):
        return f"year({_expr_str(e.arg)})"
    if isinstance(e, ir.Substring):
        return f"substr({_expr_str(e.arg)},{e.start},{e.size})"
    if isinstance(e, ir.Cast):
        return f"CAST({_expr_str(e.arg)} AS {e.dtype})"
    if isinstance(e, ir.Negate):
        return f"-{_expr_str(e.arg)}"
    if isinstance(e, ir.IsNull):
        return f"{_expr_str(e.arg)} IS {'NOT ' if e.negated else ''}NULL"
    return type(e).__name__


def _node_label(p: P.PhysOp) -> str:
    if isinstance(p, P.PhysScan):
        return (f"TableScan[{p.table}] columns="
                f"[{', '.join(p.columns)}]"
                + (f" as {p.alias_prefix[:-2]}" if p.alias_prefix else ""))
    if isinstance(p, P.PhysFilter):
        return f"Filter[{_expr_str(p.predicate)}]"
    if isinstance(p, P.PhysProject):
        return ("Project[" + ", ".join(
            n if isinstance(e, ir.ColumnRef) and e.name == n
            else f"{n} := {_expr_str(e)}" for n, e in p.projections) + "]")
    if isinstance(p, P.PhysGroupId):
        sets = ", ".join(
            "(" + ", ".join(n for (n, _), on in zip(p.keys, st) if on)
            + ")" for st in p.sets)
        return f"GroupId[{sets}] gid={p.gid_name}"
    if isinstance(p, P.PhysHashAggregate):
        aggs = ", ".join(
            f"{s.name} := {s.func}"
            + (f"({'DISTINCT ' if s.distinct else ''}"
               f"{_expr_str(s.arg) if s.arg is not None else '*'})")
            for s in p.aggs)
        keys = ", ".join(n for n, _ in p.groups)
        return f"HashAggregate[keys=({keys}) {aggs}] ndv_hint={p.ndv_hint}"
    if isinstance(p, P.PhysHashJoin):
        keys = ", ".join(f"{_expr_str(a)} = {_expr_str(b)}"
                         for a, b in zip(p.probe_keys, p.build_keys))
        extra = "" if p.filter is None else f" filter={_expr_str(p.filter)}"
        dist = "REPLICATED" if p.unique_build else "EXPAND"
        return f"{p.kind.title()}Join[{keys}]{extra} build={dist}"
    if isinstance(p, P.PhysSort):
        keys = ", ".join(f"{_expr_str(e)}{' DESC' if d else ''}"
                         for e, d in p.keys)
        lim = f" limit={p.limit}" if p.limit is not None else ""
        return f"Sort[{keys}]{lim}"
    if isinstance(p, P.PhysLimit):
        return f"Limit[{p.n}]"
    if isinstance(p, P.PhysScalarBind):
        return ("ScalarBind[" + ", ".join(n for n, _ in p.bindings) + "]")
    if isinstance(p, P.PhysMatchRecognize):
        return ("MatchRecognize[" + ", ".join(s for s, _ in p.defines)
                + "] measures=["
                + ", ".join(m for m, _, _ in p.measures) + "]")
    return type(p).__name__


def explain(plan: P.PhysOp, stats: Optional[Dict[int, dict]] = None) -> str:
    """Render the plan tree; ``stats`` (by id(node)) adds ANALYZE columns."""
    lines = []

    def walk(p: P.PhysOp, depth: int):
        note = ""
        if stats and id(p) in stats:
            s = stats[id(p)]
            note = (f"   {{rows: {s['rows']}, wall: {s['wall_ms']:.3f}ms, "
                    f"mem: {s['bytes'] / 1e6:.1f}MB}}")
        lines.append("    " * depth + "- " + _node_label(p) + note)
        for c in p.children():
            walk(c, depth + 1)

    walk(plan, 0)
    return "\n".join(lines)
