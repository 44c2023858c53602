"""Expression IR → tensor operations (the slice of ``presto_tpu/exec/
expreval.py`` that the 22 TPC-H queries reach).

Evaluation is eager: each IR node becomes a few torch operations on the
chunk's device.  Layout-aware as in the reference engine:

- DICT columns evaluate string predicates on the (tiny) host dictionary
  and gather through the codes (``DictionaryAwarePageProjection``).
- BYTES columns (``[N, W]`` uint8 + lengths) evaluate LIKE, IN and
  substring as byte-matrix operations (``ops/strings.py``).
- Decimals are int64 unscaled; DECIMAL(p>18) values are (hi, lo) int64
  word pairs ``[N, 2]`` (``ops/int128.py``), aligned and rounded per
  Trino's rules.

Null semantics: every value carries optional validity; comparisons are
null-poisoning; AND/OR are 3-valued; filters drop null predicates.

What TPC-H does not reach is not ported yet and raises
``NotImplementedError``: DOUBLE arithmetic, NULL/boolean/string literals
outside a dictionary compare, IS NULL, negation, scalar functions, nested
types, LIKE with '_' on a BYTES column, substring of a dictionary column,
IN over other than dictionary, BYTES, integer and date columns, and
EXTRACT of a zoned timestamp.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data import types as T
from ..data.column import PLAIN, DICT, BYTES
from ..ops import decimal as D
from ..ops import int128 as I128
from ..ops import strings as S
from ..sql import ir
from .columns import Chunk, DCol
from .plan import _scale_of


def _is_i128(col: DCol) -> bool:
    """Long-decimal column: values [N,2] = (hi, lo) int64 words."""
    return col.kind == PLAIN and col.values.dim() == 2 \
        and T.is_decimal(col.dtype)


def _col_i128(col: DCol, to_scale: Optional[int] = None):
    """Column → (hi, lo) words, optionally rescaled."""
    if _is_i128(col):
        hi, lo = I128.unpack(col.values)
    else:
        hi, lo = I128.from_i64(col.values.to(torch.int64))
    if to_scale is not None:
        hi, lo = I128.rescale(hi, lo, _scale_of(col.dtype), to_scale)
    return hi, lo


def _and_validity(*vs: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    out = None
    for v in vs:
        if v is None:
            continue
        out = v if out is None else (out & v)
    return out


def _dict_predicate(col: DCol, host_pred) -> torch.Tensor:
    """Evaluate a python string predicate over the dictionary, map by code."""
    table = np.array([bool(host_pred(s)) for s in col.dictionary.strings],
                     dtype=bool)
    return torch.from_numpy(table).to(col.values.device)[
        col.values.to(torch.int64)]


def eval_expr(expr: ir.Expr, chunk: Chunk) -> DCol:
    n = chunk.n_rows
    dev = chunk.mask.device

    if isinstance(expr, ir.ColumnRef):
        return chunk.cols[expr.name]

    if isinstance(expr, ir.Literal):
        v = expr.value
        if not isinstance(v, int) or isinstance(v, bool) \
                or not -2**63 <= v < 2**63:
            raise NotImplementedError(f"{expr.dtype} literal {v!r}")
        return DCol(expr.dtype, PLAIN, torch.full((n,), v, dtype=torch.int64,
                                                  device=dev))

    if isinstance(expr, ir.Cast):
        return _cast(eval_expr(expr.arg, chunk), expr.dtype)

    if isinstance(expr, ir.Arith):
        return _arith(expr, chunk)

    if isinstance(expr, ir.Compare):
        return _compare(expr, chunk)

    if isinstance(expr, ir.Logical):
        vals, valids = [], []
        for a in expr.args:
            c = eval_expr(a, chunk)
            vals.append(c.values.to(torch.bool))
            valids.append(c.valid_or_true())
        v = torch.stack(vals, 0)
        ok = torch.stack(valids, 0)
        if expr.op == "and":
            any_false = (~v & ok).any(0)
            all_true_known = (v | ~ok).all(0) & ok.all(0)
            value = torch.where(any_false, False, v.all(0))
            valid = any_false | all_true_known
        else:
            any_true = (v & ok).any(0)
            value = any_true
            valid = any_true | ok.all(0)
        return DCol(T.BOOLEAN, PLAIN, value, validity=valid)

    if isinstance(expr, ir.Not):
        a = eval_expr(expr.arg, chunk)
        return DCol(T.BOOLEAN, PLAIN, ~a.values.to(torch.bool),
                    validity=a.validity)

    if isinstance(expr, ir.Like):
        col = eval_expr(expr.arg, chunk)
        if col.kind == DICT:
            pat = expr.pattern
            m = _dict_predicate(col, lambda s, p=pat: _host_like(s, p))
        elif col.kind == BYTES:
            m = S.like(col.values, col.lengths, expr.pattern)
        else:
            raise NotImplementedError(f"LIKE on a {col.kind} column")
        if expr.negated:
            m = ~m
        return DCol(T.BOOLEAN, PLAIN, m, validity=col.validity)

    if isinstance(expr, ir.InList):
        return _in_list(expr, chunk)

    if isinstance(expr, ir.Between):
        lo = ir.Compare(">=", expr.arg, expr.lo)
        hi = ir.Compare("<=", expr.arg, expr.hi)
        return eval_expr(ir.and_(lo, hi), chunk)

    if isinstance(expr, ir.Case):
        return _eval_case(expr, chunk)

    if isinstance(expr, ir.ExtractYear):
        col = eval_expr(expr.arg, chunk)
        return DCol(T.BIGINT, PLAIN, year_from_days(_to_days(col)),
                    validity=col.validity)

    if isinstance(expr, ir.Substring):
        col = eval_expr(expr.arg, chunk)
        if col.kind != BYTES:
            raise NotImplementedError(f"substring of a {col.kind} column")
        v, lens = S.substring(col.values, col.lengths, expr.start, expr.size)
        return DCol(expr.dtype, BYTES, v, lens, col.validity)

    raise NotImplementedError(type(expr).__name__)


def _in_list(expr: ir.InList, chunk: Chunk) -> DCol:
    """``x IN (literals)``: a dictionary predicate, or an OR of equalities
    (byte strings, integers, dates)."""
    col = eval_expr(expr.arg, chunk)
    if col.kind == DICT:
        vals = set(expr.values)
        m = _dict_predicate(col, lambda s: s in vals)
    elif col.kind == BYTES:
        m = torch.zeros((chunk.n_rows,), dtype=torch.bool,
                        device=col.values.device)
        for v in expr.values:
            m = m | S.eq_literal(col.values, col.lengths, v)
    elif col.kind == PLAIN and col.values.dim() == 1 and (
            T.is_integral(col.dtype) or isinstance(col.dtype, T.DateType)):
        m = torch.zeros((chunk.n_rows,), dtype=torch.bool,
                        device=col.values.device)
        for v in expr.values:
            m = m | (col.values == int(v))
    else:
        raise NotImplementedError(f"IN over a {col.kind} {col.dtype} column")
    return DCol(T.BOOLEAN, PLAIN, m, validity=col.validity)


def year_from_days(days: torch.Tensor) -> torch.Tensor:
    """Civil year of days since 1970-01-01 (Hinnant's civil_from_days);
    every division floors, so days before the epoch are right too."""
    def fdiv(a, b):
        return torch.div(a, b, rounding_mode="floor")

    z = days.to(torch.int64) + 719468
    era = fdiv(z, 146097)
    doe = z - era * 146097
    yoe = fdiv(doe - fdiv(doe, 1460) + fdiv(doe, 36524) - fdiv(doe, 146096),
               365)
    doy = doe - (365 * yoe + fdiv(yoe, 4) - fdiv(yoe, 100))
    mp = fdiv(5 * doy + 2, 153)  # month index from March
    # January and February (mp 10, 11) close the civil year that began
    # the March before
    return yoe + era * 400 + (mp >= 10).to(torch.int64)


def _to_days(col: DCol) -> torch.Tensor:
    """date → days; timestamp (micros) → days, floored."""
    if T.is_timestamp_tz(col.dtype):
        raise NotImplementedError("EXTRACT of a TIMESTAMP WITH TIME ZONE")
    v = col.values.to(torch.int64)
    if isinstance(col.dtype, T.TimestampType):
        return torch.div(v, 86_400_000_000, rounding_mode="floor")
    return v


def _eval_case(expr: ir.Case, chunk: Chunk) -> DCol:
    """Searched CASE over integer and decimal branches (long-decimal results
    promote every branch to (hi, lo) words)."""
    rt = expr.dtype
    if not (T.is_decimal(rt) or T.is_integral(rt)):
        raise NotImplementedError(f"CASE returning {rt}")
    n = chunk.n_rows
    out = None
    valid = None
    taken = torch.zeros((n,), dtype=torch.bool, device=chunk.mask.device)
    rs = _scale_of(rt)
    i128 = T.is_long_decimal(rt)

    def branch_vals(v: DCol):
        return I128.pack(*_col_i128(v, rs)) if i128 else v.values

    def branch(e):
        return _rescale_col(eval_expr(e, chunk), rs)

    for cond, val in expr.whens:
        c = eval_expr(cond, chunk)
        cm = c.values.to(torch.bool) & c.valid_or_true() & ~taken
        v = branch(val)
        vv = branch_vals(v)
        cmv = cm[:, None] if vv.dim() == 2 else cm
        if out is None:
            out = torch.where(cmv, vv, 0)
            valid = torch.where(cm, v.valid_or_true(), False)
        else:
            out = torch.where(cmv, vv, out)
            valid = torch.where(cm, v.valid_or_true(), valid)
        taken = taken | cm
    if expr.default is not None:
        d = branch(expr.default)
        dv = branch_vals(d)
        tkv = taken[:, None] if dv.dim() == 2 else taken
        out = torch.where(tkv, out, dv)
        valid = torch.where(taken, valid, d.valid_or_true())
    else:
        valid = torch.where(taken, valid, False)
    return DCol(rt, PLAIN, out, validity=valid)


def _host_like(s: str, pattern: str) -> bool:
    """SQL LIKE of one string: '%' matches any run of characters, '_'
    exactly one (Trino's semantics; the JAX package's dictionary LIKE
    matches '_' only as itself)."""
    import re
    rx = "".join(".*" if ch == "%" else "." if ch == "_" else re.escape(ch)
                 for ch in pattern)
    return re.fullmatch(rx, s, re.S) is not None


def _cast(col: DCol, to: T.DataType) -> DCol:
    """Casts between integer and decimal types (rescaled HALF_UP)."""
    if col.dtype == to:
        return col
    if col.kind != PLAIN or not (T.is_decimal(to) or T.is_integral(to)) \
            or not (T.is_decimal(col.dtype) or T.is_integral(col.dtype)):
        raise NotImplementedError(f"cast {col.dtype} -> {to}")
    fs, ts = _scale_of(col.dtype), _scale_of(to)
    if _is_i128(col) or T.is_long_decimal(to):
        hi, lo = _col_i128(col, ts)
        if T.is_long_decimal(to):
            return DCol(to, PLAIN, I128.pack(hi, lo), validity=col.validity)
        return DCol(to, PLAIN, lo, validity=col.validity)  # fits int64
    return DCol(to, PLAIN, D.rescale(col.values.to(torch.int64), fs, ts),
                validity=col.validity)


def _rescale_col(col: DCol, to_scale: int) -> DCol:
    fs = _scale_of(col.dtype)
    if fs == to_scale or col.kind != PLAIN:
        return col
    if _is_i128(col):
        hi, lo = I128.rescale(*I128.unpack(col.values), fs, to_scale)
        return DCol(T.decimal(38, to_scale), PLAIN, I128.pack(hi, lo),
                    validity=col.validity)
    return DCol(T.decimal(18, to_scale), PLAIN,
                D.rescale(col.values.to(torch.int64), fs, to_scale),
                validity=col.validity)


def _arith(expr: ir.Arith, chunk: Chunk) -> DCol:
    lt, rt = expr.left.dtype, expr.right.dtype
    l = eval_expr(expr.left, chunk)
    r = eval_expr(expr.right, chunk)
    valid = _and_validity(l.validity, r.validity)
    rs = _scale_of(expr.dtype)
    if any(isinstance(x, T.DoubleType) for x in (expr.dtype, lt, rt)):
        raise NotImplementedError("DOUBLE arithmetic on the torch path")
    if _is_i128(l) or _is_i128(r) or T.is_long_decimal(expr.dtype):
        # DECIMAL(p>18) results are real int128 values (a short×short
        # product typed long would silently wrap in int64)
        return _arith_i128(expr, l, r, valid, rs)
    lv = l.values.to(torch.int64)
    rv = r.values.to(torch.int64)
    if expr.op in ("+", "-"):
        lv = D.rescale(lv, _scale_of(lt), rs)
        rv = D.rescale(rv, _scale_of(rt), rs)
        out = lv + rv if expr.op == "+" else lv - rv
    elif expr.op == "*":
        out = lv * rv  # scales add: unscaled product is exact
    elif expr.op == "/":
        out = D.decimal_div(lv, _scale_of(lt), rv, _scale_of(rt), rs)
        valid = _and_validity(valid, rv != 0)
    else:
        raise ValueError(expr.op)
    return DCol(expr.dtype, PLAIN, out, validity=valid)


def _arith_i128(expr: ir.Arith, l: DCol, r: DCol, valid, rs: int) -> DCol:
    """Long-decimal arithmetic in paired-int64 words
    (reference: ``spi/type/DecimalOperators`` over Int128)."""
    ls, rrs = _scale_of(l.dtype), _scale_of(r.dtype)
    if expr.op in ("+", "-"):
        a = _col_i128(l, rs)
        b = _col_i128(r, rs)
        out = I128.add(*a, *b) if expr.op == "+" else I128.sub(*a, *b)
    elif expr.op == "*":
        out = I128.mul(*_col_i128(l), *_col_i128(r))  # scales add
    elif expr.op == "/":
        # rescale numerator by 10^(rs + s_r - s_l), divide HALF_UP
        shift = rs + rrs - ls
        nhi, nlo = _col_i128(l)
        if shift > 0:
            nhi, nlo = I128.rescale(nhi, nlo, 0, shift)
        elif shift < 0:
            nhi, nlo = I128.rescale(nhi, nlo, -shift, 0)
        dhi, dlo = _col_i128(r)
        out = I128.div_round_half_up(nhi, nlo, dhi, dlo)
        valid = _and_validity(valid, ~I128.eq(dhi, dlo,
                                              torch.zeros_like(dhi),
                                              torch.zeros_like(dlo)))
    else:
        raise ValueError(expr.op)
    if T.is_long_decimal(expr.dtype):
        return DCol(expr.dtype, PLAIN, I128.pack(*out), validity=valid)
    return DCol(expr.dtype, PLAIN, out[1], validity=valid)  # fits int64


def _compare(expr: ir.Compare, chunk: Chunk) -> DCol:
    l = eval_expr(expr.left, chunk)
    if l.kind == DICT and isinstance(expr.right, ir.Literal) \
            and isinstance(expr.right.value, str):
        lit, op = expr.right.value, expr.op
        m = _dict_predicate(l, lambda s: _cmp_str(op, s, lit))
        return DCol(T.BOOLEAN, PLAIN, m, validity=l.validity)
    r = eval_expr(expr.right, chunk)
    if l.kind != PLAIN or r.kind != PLAIN or any(
            isinstance(c.dtype, T.DoubleType) for c in (l, r)):
        raise NotImplementedError(
            f"compare {l.kind} {l.dtype} with {r.kind} {r.dtype}")
    valid = _and_validity(l.validity, r.validity)
    # integer/date/decimal: align scales
    ls, rs = _scale_of(l.dtype), _scale_of(r.dtype)
    s = max(ls, rs)
    if _is_i128(l) or _is_i128(r):
        m = I128.cmp(expr.op, *_col_i128(l, s), *_col_i128(r, s))
        return DCol(T.BOOLEAN, PLAIN, m, validity=valid)
    lv = D.rescale(l.values.to(torch.int64), ls, s)
    rv = D.rescale(r.values.to(torch.int64), rs, s)
    return DCol(T.BOOLEAN, PLAIN, _int_cmp(expr.op, lv, rv), validity=valid)


def _int_cmp(op: str, a, b):
    if op == "=":
        return a == b
    if op == "<>":
        return a != b
    if op == "<":
        return a < b
    if op == "<=":
        return a <= b
    if op == ">":
        return a > b
    if op == ">=":
        return a >= b
    raise ValueError(op)


def _cmp_str(op: str, a: str, b: str) -> bool:
    if op == "=":
        return a == b
    if op == "<>":
        return a != b
    if op == "<":
        return a < b
    if op == "<=":
        return a <= b
    if op == ">":
        return a > b
    if op == ">=":
        return a >= b
    raise ValueError(op)


def eval_predicate(expr: ir.Expr, chunk: Chunk) -> torch.Tensor:
    """Filter semantics: null predicate → row dropped."""
    c = eval_expr(expr, chunk)
    return c.values.to(torch.bool) & c.valid_or_true()
