"""TupleDomain: predicate → provable per-column value domains.

The analogue of the reference's ``sql/planner/DomainTranslator.java`` +
``spi/predicate/`` (TupleDomain / Domain / ValueSet / Range): extract from
a predicate the constraints it PROVES about individual columns, losing
information conservatively (anything not provable becomes "all values").

Used for:
- static scan-range (split) pruning over monotone generator keys
  (``exec/datasource.py``): `l_orderkey between a and b` scans only the
  covering unit range, the connector-pushdown role of
  ``ConnectorMetadata.applyFilter``
- dynamic filtering: build-side domains narrow probe masks (min/max AND
  discrete in-sets — ``DynamicFilterSourceOperator``'s two shapes)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from .. import ir


@dataclass(frozen=True)
class Domain:
    """Allowed values of one column: [lo, hi] interval ∧ optional discrete
    set.  None bound = unbounded.  ``none`` marks a provably-empty domain."""

    lo: Optional[float] = None          # inclusive
    hi: Optional[float] = None          # inclusive
    in_set: Optional[frozenset] = None  # discrete allowed values
    none: bool = False                  # contradiction (e.g. x<1 and x>2)

    def intersect(self, o: "Domain") -> "Domain":
        lo = self.lo if o.lo is None else (
            o.lo if self.lo is None else max(self.lo, o.lo))
        hi = self.hi if o.hi is None else (
            o.hi if self.hi is None else min(self.hi, o.hi))
        s = self.in_set if o.in_set is None else (
            o.in_set if self.in_set is None else self.in_set & o.in_set)
        none = (self.none or o.none
                or (lo is not None and hi is not None and lo > hi)
                or (s is not None and not s))
        return Domain(lo, hi, s, none)

    def union(self, o: "Domain") -> "Domain":
        if self.none:
            return o
        if o.none:
            return self
        lo = None if self.lo is None or o.lo is None \
            else min(self.lo, o.lo)
        hi = None if self.hi is None or o.hi is None \
            else max(self.hi, o.hi)
        s = None if self.in_set is None or o.in_set is None \
            else self.in_set | o.in_set
        return Domain(lo, hi, s)

    @property
    def is_all(self) -> bool:
        return (self.lo is None and self.hi is None
                and self.in_set is None and not self.none)


ALL = Domain()


def _lit(e: ir.Expr):
    if isinstance(e, ir.Literal) and isinstance(e.value, (int, float)):
        return e.value
    return None


def extract(pred: Optional[ir.Expr]) -> Dict[str, Domain]:
    """Predicate → {column: Domain} for every column it provably
    constrains (conjunctive-normal extraction; OR branches merge with
    per-column union, columns missing from either branch drop out)."""
    if pred is None:
        return {}
    if isinstance(pred, ir.Logical):
        if pred.op == "and":
            out: Dict[str, Domain] = {}
            for a in pred.args:
                for col, d in extract(a).items():
                    out[col] = out.get(col, ALL).intersect(d)
            return out
        # or: only columns constrained by EVERY branch stay constrained
        branches = [extract(a) for a in pred.args]
        out = {}
        common = set.intersection(*(set(b) for b in branches)) \
            if branches else set()
        for col in common:
            d = branches[0][col]
            for b in branches[1:]:
                d = d.union(b[col])
            out[col] = d
        return out
    if isinstance(pred, ir.Compare) and isinstance(pred.left, ir.ColumnRef):
        v = _lit(pred.right)
        if v is None:
            return {}
        col = pred.left.name
        return {
            "=": {col: Domain(v, v, frozenset([v]))},
            "<": {col: Domain(hi=v - 1 if isinstance(v, int) else v)},
            "<=": {col: Domain(hi=v)},
            ">": {col: Domain(lo=v + 1 if isinstance(v, int) else v)},
            ">=": {col: Domain(lo=v)},
        }.get(pred.op, {})
    if isinstance(pred, ir.Compare) and isinstance(pred.right, ir.ColumnRef):
        v = _lit(pred.left)
        if v is None:
            return {}
        flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "="}
        if pred.op not in flip:
            return {}
        return extract(ir.Compare(flip[pred.op], pred.right, pred.left))
    if isinstance(pred, ir.Between) and isinstance(pred.arg, ir.ColumnRef):
        lo, hi = _lit(pred.lo), _lit(pred.hi)
        if lo is None or hi is None:
            return {}
        return {pred.arg.name: Domain(lo, hi)}
    if isinstance(pred, ir.InList) and isinstance(pred.arg, ir.ColumnRef):
        vals = [v for v in pred.values if isinstance(v, (int, float))]
        if len(vals) != len(pred.values) or not vals:
            return {}
        return {pred.arg.name: Domain(min(vals), max(vals),
                                      frozenset(vals))}
    return {}


def row_range_for(domain: Domain, key_lo: int, key_hi: int,
                  n_rows: int) -> Optional[Tuple[int, int]]:
    """Map a domain over a MONOTONE dense-ish key column spanning
    [key_lo, key_hi] across n_rows to a covering (first_row, count)
    row-range — the split-pruning step (TpchSplitManager part semantics).
    Returns None when nothing can be pruned."""
    if domain.is_all or domain.none or n_rows <= 0:
        return None if not domain.none else (0, 0)
    lo = key_lo if domain.lo is None else max(domain.lo, key_lo)
    hi = key_hi if domain.hi is None else min(domain.hi, key_hi)
    if lo > hi:
        return (0, 0)
    # covering range with ±1-row margins (integer math; the caller's
    # filter still runs per row, so a superset is always safe)
    denom = max(key_hi - key_lo + 1, 1)
    first = max(int((lo - key_lo) * n_rows) // denom - 1, 0)
    last = min(-(-int((hi - key_lo + 1) * n_rows) // denom) + 1, n_rows)
    return (first, max(last - first, 0))
