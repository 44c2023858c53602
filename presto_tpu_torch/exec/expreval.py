"""Expression IR → tensor operations (the slice of ``presto_tpu/exec/
expreval.py`` that TPC-H Q1, Q6, Q14 and integer sums reach).

Evaluation is eager: each IR node becomes a few torch operations on the
chunk's device.  Layout-aware as in the reference engine:

- DICT columns evaluate string predicates on the (tiny) host dictionary
  and gather through the codes (``DictionaryAwarePageProjection``).
- Decimals are int64 unscaled; DECIMAL(p>18) values are (hi, lo) int64
  word pairs ``[N, 2]`` (``ops/int128.py``), aligned and rounded per
  Trino's rules.

Null semantics: every value carries optional validity; comparisons are
null-poisoning; AND/OR are 3-valued; filters drop null predicates.

What the four requests do not reach is not ported yet and raises
``NotImplementedError``: DOUBLE arithmetic, byte-string (BYTES) columns,
NULL/boolean/string literals, IN, IS NULL, negation, scalar functions and
nested types.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data import types as T
from ..data.column import PLAIN, DICT
from ..ops import decimal as D
from ..ops import int128 as I128
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
        if col.kind != DICT:
            raise NotImplementedError(f"LIKE on a {col.kind} column")
        pat = expr.pattern
        m = _dict_predicate(col, lambda s, p=pat: _host_like(s, p))
        if expr.negated:
            m = ~m
        return DCol(T.BOOLEAN, PLAIN, m, validity=col.validity)

    if isinstance(expr, ir.Between):
        lo = ir.Compare(">=", expr.arg, expr.lo)
        hi = ir.Compare("<=", expr.arg, expr.hi)
        return eval_expr(ir.and_(lo, hi), chunk)

    if isinstance(expr, ir.Case):
        return _eval_case(expr, chunk)

    raise NotImplementedError(type(expr).__name__)


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
    import re
    rx = "^" + ".*".join(re.escape(p) for p in pattern.split("%")) + "$"
    return re.match(rx, s, re.S) is not None


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
