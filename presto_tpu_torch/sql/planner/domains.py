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

import math
from dataclasses import dataclass
from fractions import Fraction
from typing import Dict, Optional, Tuple

from .. import ir


@dataclass(frozen=True)
class Domain:
    """Allowed values of one column, in the units it stores (a decimal's
    unscaled integers): [lo, hi] interval ∧ optional discrete set.  None
    bound = unbounded.  ``none`` marks a provably-empty domain."""

    lo: Optional[int] = None            # inclusive
    hi: Optional[int] = None            # inclusive
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


def _units(e: ir.Expr, col: ir.ColumnRef) -> Optional[Fraction]:
    """A literal's value in ``col``'s units (``ir.in_column_units``);
    None for anything else, or where those units are unknown."""
    if isinstance(e, ir.Literal):
        return ir.in_column_units(e, col.dtype)
    return None


def _bound(op: str, x: Fraction) -> Domain:
    """``col op x`` as a domain of the column's integer units: a lower
    bound rounds up, an upper bound rounds down, and ``=`` with a value
    the column cannot hold is empty."""
    if op == "=":
        if x.denominator != 1:
            return Domain(none=True)
        v = int(x)
        return Domain(v, v, frozenset([v]))
    if op == "<":
        return Domain(hi=math.ceil(x) - 1)
    if op == "<=":
        return Domain(hi=math.floor(x))
    if op == ">":
        return Domain(lo=math.floor(x) + 1)
    return Domain(lo=math.ceil(x))  # >=


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
        x = _units(pred.right, pred.left)
        if x is None or pred.op not in ("=", "<", "<=", ">", ">="):
            return {}
        return {pred.left.name: _bound(pred.op, x)}
    if isinstance(pred, ir.Compare) and isinstance(pred.right, ir.ColumnRef):
        flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "="}
        if pred.op not in flip:
            return {}
        return extract(ir.Compare(flip[pred.op], pred.right, pred.left))
    if isinstance(pred, ir.Between) and isinstance(pred.arg, ir.ColumnRef):
        lo, hi = _units(pred.lo, pred.arg), _units(pred.hi, pred.arg)
        if lo is None or hi is None:
            return {}
        return {pred.arg.name: _bound(">=", lo).intersect(_bound("<=", hi))}
    if isinstance(pred, ir.InList) and isinstance(pred.arg, ir.ColumnRef):
        # a NULL in the list matches no row: only the other values count
        xs = [_units(v, pred.arg) for v in pred.values
              if v.value is not None]
        if not xs or any(x is None for x in xs):
            return {}
        vals = [int(x) for x in xs if x.denominator == 1]
        if not vals:
            return {pred.arg.name: Domain(none=True)}
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
