"""Typed row-expression IR — the input language of the kernel compiler.

The analogue of the reference's post-analysis RowExpression IR
(``core/trino-main/.../sql/relational/`` — ``CallExpression``,
``InputReferenceExpression``, ``ConstantExpression``): a small, typed,
immutable expression tree that the executor traces straight into fused XLA
ops (where the reference generates JVM bytecode per query,
``sql/gen/ExpressionCompiler.java``).

Decimal typing follows Trino's exact-decimal operator rules
(``spi/type/DecimalType.java``/``Decimals.java``): add/sub align to
max scale, multiply adds scales, divide keeps ``max(s1, s2)`` and rounds
HALF_UP.  Literals carry unscaled int64 values for decimal/date types.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction
from typing import List, Optional, Sequence, Tuple

from ..data import types as T


@dataclass(frozen=True)
class Expr:
    def children(self) -> Sequence["Expr"]:
        return ()

    @property
    def dtype(self) -> T.DataType:
        raise NotImplementedError


@dataclass(frozen=True)
class ColumnRef(Expr):
    name: str
    _dtype: T.DataType
    outer: bool = False  # marks correlated references during subquery analysis

    @property
    def dtype(self):
        return self._dtype

    def __str__(self):
        return self.name


@dataclass(frozen=True)
class Literal(Expr):
    value: object  # int (unscaled for decimal, days for date), str, bool, None
    _dtype: T.DataType

    @property
    def dtype(self):
        return self._dtype

    def __str__(self):
        return f"{self.value}:{self._dtype}"


@dataclass(frozen=True)
class Arith(Expr):
    op: str  # + - * /
    left: Expr
    right: Expr
    _dtype: T.DataType

    def children(self):
        return (self.left, self.right)

    @property
    def dtype(self):
        return self._dtype


@dataclass(frozen=True)
class Negate(Expr):
    arg: Expr

    def children(self):
        return (self.arg,)

    @property
    def dtype(self):
        return self.arg.dtype


@dataclass(frozen=True)
class Compare(Expr):
    op: str  # = <> < <= > >=
    left: Expr
    right: Expr

    def children(self):
        return (self.left, self.right)

    @property
    def dtype(self):
        return T.BOOLEAN


@dataclass(frozen=True)
class Logical(Expr):
    op: str  # and | or
    args: Tuple[Expr, ...]

    def children(self):
        return self.args

    @property
    def dtype(self):
        return T.BOOLEAN


@dataclass(frozen=True)
class Shifted(Expr):
    """PREV/NEXT navigation inside MATCH_RECOGNIZE DEFINE predicates:
    the referenced column's value ``offset`` rows away in the sorted
    partition (NULL across partition boundaries).  Materialized by the
    pattern kernel before predicate evaluation — never reaches
    eval_expr directly."""

    arg: Expr                       # ColumnRef
    offset: int                     # -k = PREV(x, k); +k = NEXT(x, k)

    def children(self):
        return (self.arg,)

    @property
    def dtype(self):
        return self.arg.dtype


@dataclass(frozen=True)
class Not(Expr):
    arg: Expr

    def children(self):
        return (self.arg,)

    @property
    def dtype(self):
        return T.BOOLEAN


@dataclass(frozen=True)
class Like(Expr):
    arg: Expr
    pattern: str
    negated: bool = False

    def children(self):
        return (self.arg,)

    @property
    def dtype(self):
        return T.BOOLEAN


@dataclass(frozen=True)
class InList(Expr):
    """``arg IN (values)``: each value a typed literal, so that a decimal
    keeps its scale and a NULL is known as one."""
    arg: Expr
    values: Tuple[Literal, ...]

    def children(self):
        return (self.arg,)

    @property
    def dtype(self):
        return T.BOOLEAN


@dataclass(frozen=True)
class Between(Expr):
    arg: Expr
    lo: Expr
    hi: Expr

    def children(self):
        return (self.arg, self.lo, self.hi)

    @property
    def dtype(self):
        return T.BOOLEAN


@dataclass(frozen=True)
class Case(Expr):
    whens: Tuple[Tuple[Expr, Expr], ...]
    default: Optional[Expr]
    _dtype: T.DataType

    def children(self):
        out = []
        for c, v in self.whens:
            out += [c, v]
        if self.default is not None:
            out.append(self.default)
        return tuple(out)

    @property
    def dtype(self):
        return self._dtype


@dataclass(frozen=True)
class Cast(Expr):
    arg: Expr
    _dtype: T.DataType

    def children(self):
        return (self.arg,)

    @property
    def dtype(self):
        return self._dtype


@dataclass(frozen=True)
class ExtractYear(Expr):
    arg: Expr

    def children(self):
        return (self.arg,)

    @property
    def dtype(self):
        return T.BIGINT


@dataclass(frozen=True)
class Substring(Expr):
    arg: Expr
    start: int  # 1-based, literal (TPC-H only needs literal offsets)
    size: int

    def children(self):
        return (self.arg,)

    @property
    def dtype(self):
        return T.varchar(self.size)


@dataclass(frozen=True)
class Func(Expr):
    """Generic scalar function call (reference: resolved CallExpression
    against the function registry, ``metadata/FunctionRegistry.java``)."""

    name: str
    args: Tuple[Expr, ...]
    _dtype: T.DataType

    def children(self):
        return self.args

    @property
    def dtype(self):
        return self._dtype


@dataclass(frozen=True)
class RowValue(Expr):
    """Plan-time row value: named field expressions.  Never reaches the
    executor — the planner SHREDS row-typed select items into per-field
    physical columns (``name.field``) and decomposes row comparisons /
    field dereferences / subscripts before lowering (the TPU analogue of
    ``spi/block/RowBlock`` + ``RowComparisonOperators``)."""

    fields: Tuple[Tuple[str, Expr], ...]

    def children(self):
        return tuple(e for _, e in self.fields)

    @property
    def dtype(self):
        return T.RowType(tuple((n, e.dtype) for n, e in self.fields))

    def field(self, name: str) -> Expr:
        for n, e in self.fields:
            if n == name:
                return e
        raise KeyError(f"row has no field {name}")


@dataclass(frozen=True)
class IsNull(Expr):
    arg: Expr
    negated: bool = False

    def children(self):
        return (self.arg,)

    @property
    def dtype(self):
        return T.BOOLEAN


# ---------------------------------------------------------------- type rules

def arith_type(op: str, lt: T.DataType, rt: T.DataType) -> T.DataType:
    """Result type of an arithmetic op (Trino DecimalOperators rules)."""
    if isinstance(lt, T.DoubleType) or isinstance(rt, T.DoubleType):
        return T.DOUBLE
    if isinstance(lt, T.DateType) or isinstance(rt, T.DateType):
        return T.DATE  # date ± interval-days
    ld = lt if T.is_decimal(lt) else None
    rd = rt if T.is_decimal(rt) else None
    if ld is None and rd is None:
        return T.BIGINT
    ls = ld.scale if ld else 0
    rs = rd.scale if rd else 0
    if op in ("+", "-"):
        return T.decimal(38, max(ls, rs))
    if op == "*":
        return T.decimal(38, ls + rs)
    if op == "/":
        return T.decimal(38, max(ls, rs))
    raise ValueError(op)


def arith(op: str, left: Expr, right: Expr) -> Arith:
    return Arith(op, left, right, arith_type(op, left.dtype, right.dtype))


def and_(*args: Expr) -> Expr:
    flat: List[Expr] = []
    for a in args:
        if isinstance(a, Logical) and a.op == "and":
            flat.extend(a.args)
        else:
            flat.append(a)
    return flat[0] if len(flat) == 1 else Logical("and", tuple(flat))


def or_(*args: Expr) -> Expr:
    flat: List[Expr] = []
    for a in args:
        if isinstance(a, Logical) and a.op == "or":
            flat.extend(a.args)
        else:
            flat.append(a)
    return flat[0] if len(flat) == 1 else Logical("or", tuple(flat))


def lit_bigint(v: int) -> Literal:
    return Literal(int(v), T.BIGINT)


def lit_decimal(unscaled: int, scale: int = 2, precision: int = 15) -> Literal:
    return Literal(int(unscaled), T.decimal(precision, scale))


def lit_date(days: int) -> Literal:
    return Literal(int(days), T.DATE)


def lit_string(s: str) -> Literal:
    return Literal(s, T.varchar(len(s)))


def in_column_units(lit: Literal, to: T.DataType) -> Optional[Fraction]:
    """A non-NULL literal's value in the units a column of type ``to``
    stores: a decimal's unscaled integer at the column's scale, an
    integer, days of a date, micros of a timestamp.  Exact, so it is not
    an integer where the column cannot hold the value (``1.5`` for a
    BIGINT column).  None where the units are unknown: a NULL, a string
    or a boolean, a DOUBLE literal or column, or a date or timestamp
    against a column of another type (a DOUBLE literal would compare in
    float64, as ``=`` does, not exactly)."""
    t, v = lit.dtype, lit.value
    if v is None or isinstance(v, (str, bool)):
        return None
    timed = (T.DateType, T.TimestampType)
    if isinstance(to, timed) or isinstance(t, timed):
        return Fraction(int(v)) if isinstance(t, timed) \
            and type(t) is type(to) else None
    if not (T.is_integral(to) or T.is_decimal(to)):
        return None
    if not (T.is_integral(t) or T.is_decimal(t)):
        return None
    x = Fraction(int(v), 10 ** (t.scale if T.is_decimal(t) else 0))
    return x * 10 ** (to.scale if T.is_decimal(to) else 0)


def literal_text(lit: Literal) -> str:
    """A literal as SQL writes it: a decimal with its point (``1.5``, not
    its unscaled ``15``), a string quoted, a date ISO, NULL."""
    t, v = lit.dtype, lit.value
    if v is None:
        return "NULL"
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    if T.is_decimal(t) and t.scale:
        sign, digits = ("-" if v < 0 else ""), str(abs(int(v)))
        digits = digits.rjust(t.scale + 1, "0")
        return f"{sign}{digits[:-t.scale]}.{digits[-t.scale:]}"
    if isinstance(t, T.DateType):
        import datetime as dt
        return "DATE '" + (dt.date(1970, 1, 1)
                           + dt.timedelta(days=int(v))).isoformat() + "'"
    return repr(v)


def walk(expr: Expr):
    yield expr
    for c in expr.children():
        yield from walk(c)


def referenced_columns(expr: Expr) -> List[str]:
    return sorted({e.name for e in walk(expr) if isinstance(e, ColumnRef)})
