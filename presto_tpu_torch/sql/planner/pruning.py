"""Column pruning over physical plans.

The role of the reference's ``PruneUnreferencedOutputs`` +
``PruneTableScanColumns`` optimizer rules: walk the plan top-down computing
the required column set, trim scan lists, projections, and join payloads.
Because generation is per-column, a pruned scan never materializes unused
columns at all.
"""

from __future__ import annotations

from typing import Optional, Set

from ...exec import plan as P
from .. import ir


def _refs(*exprs) -> Set[str]:
    out: Set[str] = set()
    for e in exprs:
        if e is None:
            continue
        out.update(ir.referenced_columns(e))
    return out


def prune(plan: P.PhysOp, required: Optional[Set[str]] = None) -> P.PhysOp:
    """Mutates the plan in place; ``required=None`` keeps all outputs."""
    if isinstance(plan, P.PhysScan):
        if required is not None:
            pfx = plan.alias_prefix
            keep = []
            for c in plan.columns:
                if pfx + c in required:
                    keep.append(c)
            plan.columns = tuple(keep) or plan.columns[:1]
        return plan
    if isinstance(plan, P.PhysFilter):
        child_req = None if required is None else \
            set(required) | _refs(plan.predicate)
        prune(plan.child, child_req)
        return plan
    if isinstance(plan, P.PhysProject):
        if required is not None:
            kept = tuple((n, e) for n, e in plan.projections if n in required)
            plan.projections = kept or plan.projections[:1]
        prune(plan.child, _refs(*(e for _, e in plan.projections)))
        return plan
    if isinstance(plan, P.PhysHashAggregate):
        if required is not None:
            plan.aggs = tuple(s for s in plan.aggs if s.name in required) \
                or plan.aggs
        child_req = _refs(*(e for _, e in plan.groups),
                          *(s.arg for s in plan.aggs),
                          *(s.arg2 for s in plan.aggs))
        # an empty set is meaningful (count(*) needs no columns): the scan
        # keeps one narrow column to carry the row count
        prune(plan.child, child_req)
        return plan
    if isinstance(plan, P.PhysHashJoin):
        filt = _refs(plan.filter)
        if required is not None:
            plan.build_payload = tuple(
                (o, b) for o, b in plan.build_payload
                if o in required or o in filt)
        payload_outs = {o for o, _ in plan.build_payload}
        probe_req = None if required is None else (
            (set(required) - payload_outs) | _refs(*plan.probe_keys) | filt)
        build_req = (_refs(*plan.build_keys)
                     | {b for _, b in plan.build_payload} | filt)
        prune(plan.probe, probe_req)
        prune(plan.build, build_req)
        return plan
    if isinstance(plan, P.PhysSort):
        child_req = None if required is None else \
            set(required) | _refs(*(e for e, _ in plan.keys))
        prune(plan.child, child_req)
        return plan
    if isinstance(plan, P.PhysLimit):
        prune(plan.child, required)
        return plan
    if isinstance(plan, P.PhysWindow):
        produced = {s.name for s in plan.functions}
        child_req = None if required is None else (
            (set(required) - produced)
            | _refs(*plan.partition, *(e for e, _ in plan.order),
                    *(s.arg for s in plan.functions)))
        prune(plan.child, child_req)
        return plan
    if isinstance(plan, P.PhysConcat):
        for c in plan.inputs:
            prune(c, None)  # inputs are pre-projected to exact outputs
        return plan
    if isinstance(plan, P.PhysMatchRecognize):
        if plan.passthrough and required is not None:
            # ALL ROWS pass-through columns narrow to what consumers need
            plan.passthrough = tuple(n for n in plan.passthrough
                                     if n in required)
        child_req = _refs(
            *plan.partition, *(e for e, _ in plan.order),
            *(p for _, p in plan.defines),
            *(a for _, _, a in plan.measures if a is not None))             | set(plan.passthrough)
        # Shifted wraps a ColumnRef; referenced_columns reaches it via
        # children(), so child_req already contains navigation sources
        prune(plan.child, child_req or None)
        return plan
    if isinstance(plan, P.PhysGroupId):
        produced = {n for n, _ in plan.keys} | {plan.gid_name}
        child_req = None if required is None else (
            (set(required) - produced)
            | _refs(*(e for _, e in plan.keys)))
        prune(plan.child, child_req)
        return plan
    if isinstance(plan, P.PhysUnnest):
        produced = {n for outs in plan.names for n in outs}
        if plan.ordinality:
            produced.add(plan.ordinality)
        child_req = None if required is None else (
            (set(required) - produced) | _refs(*plan.exprs))
        prune(plan.child, child_req)
        return plan
    if isinstance(plan, P.PhysScalarBind):
        bound = {n for n, _ in plan.bindings}
        child_req = None if required is None else set(required) - bound
        prune(plan.child, child_req)
        for _, sub in plan.bindings:
            prune(sub, None)
        return plan
    raise NotImplementedError(type(plan).__name__)
