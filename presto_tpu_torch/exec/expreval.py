"""Expression IR → tensor operations (the slice of ``presto_tpu/exec/
expreval.py`` that the TPC-H and TPC-DS queries and the reference's
scalar batteries reach).

Evaluation is eager: each IR node becomes a few torch operations on the
chunk's device.  Layout-aware as in the reference engine:

- DICT columns evaluate string predicates and transforms (substring,
  upper) on the (tiny) host dictionary and gather through the codes
  (``DictionaryAwarePageProjection``).
- BYTES columns (``[N, W]`` uint8 + lengths) evaluate LIKE, IN,
  substring, upper, concat and equality as byte-matrix operations
  (``ops/strings.py``); a string literal is a broadcast BYTES column.
- Decimals are int64 unscaled; DECIMAL(p>18) values are (hi, lo) int64
  word pairs ``[N, 2]`` (``ops/int128.py``), aligned and rounded per
  Trino's rules.  DOUBLE is a PLAIN float64 column.

Null semantics: every value carries optional validity; comparisons are
null-poisoning; AND/OR are 3-valued; filters drop null predicates; a
typed NULL literal is a column of its type's layout with no valid row.

IN lists compare typed literals in the column's own units (a decimal
literal at the column's scale; one it cannot hold matches nothing).  The
math and bitwise scalars are elementwise torch in float64 and int64.
String functions run on the byte matrix where they are per-row and
fixed-width, else over each distinct string on the host; date and time
functions are int64 day and microsecond arithmetic; a TIMESTAMP WITH
TIME ZONE is its UTC instant plus a per-row offset (``DCol.values2``).

ARRAY and MAP values are ``[N, W]`` tensors with lengths (``columns.py``);
the array and map functions, ``split`` and a nested CASE or COALESCE
work on them row by row (``ops/arrays.py``), string elements compared
and ordered by their strings.

Not ported yet (they raise ``NotImplementedError``): LIKE with '_' on a
BYTES column; ordered compares of BYTES columns; casts other than among
numeric types, among string types, among date and timestamp types and
between nested types of such elements; named time zones; string
functions of an ARRAY (``reverse``, ``concat``).
"""

from __future__ import annotations

import base64
import datetime as dt
import json
import math
import re
from typing import Optional, Tuple
from urllib.parse import quote_plus, unquote_plus, urlsplit

import numpy as np
import torch

from ..data import types as T
from ..data.column import PLAIN, DICT, BYTES, ARRAY, MAP
from ..ops import arrays as AR
from ..ops import decimal as D
from ..ops import int128 as I128
from ..ops import sort as SORT
from ..ops import strings as S
from ..sql import ir
from ..utils.tracing import host_read
from .columns import Chunk, DCol, Dictionary
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


def shifted_name(e: ir.Shifted) -> str:
    """The column under which MATCH_RECOGNIZE materialises a PREV/NEXT
    reference before its DEFINE predicates evaluate."""
    return f"#sh{e.offset}_{e.arg.name}"


def eval_expr(expr: ir.Expr, chunk: Chunk) -> DCol:
    n = chunk.n_rows
    dev = chunk.mask.device

    if isinstance(expr, ir.ColumnRef):
        return chunk.cols[expr.name]

    if isinstance(expr, ir.Shifted):  # materialised by MATCH_RECOGNIZE
        return chunk.cols[shifted_name(expr)]

    if isinstance(expr, ir.Literal):
        return _literal(expr, n, dev)

    if isinstance(expr, ir.Cast):
        if isinstance(expr.arg, ir.Literal) and expr.arg.value is None:
            # CAST(NULL AS t): a NULL in t's own layout
            return _literal(ir.Literal(None, expr.dtype), n, dev)
        return _cast(eval_expr(expr.arg, chunk), expr.dtype)

    if isinstance(expr, ir.Negate):
        a = eval_expr(expr.arg, chunk)
        v = I128.pack(*I128.neg(*I128.unpack(a.values))) if _is_i128(a) \
            else -a.values
        return DCol(a.dtype, PLAIN, v, validity=a.validity)

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
        if col.kind == DICT:
            a = expr.start - 1
            b = None if expr.size is None else a + expr.size
            return _host_map(col, lambda s: s[a:b], expr.dtype)
        if col.kind != BYTES:
            raise NotImplementedError(f"substring of a {col.kind} column")
        v, lens = S.substring(col.values, col.lengths, expr.start, expr.size)
        return DCol(expr.dtype, BYTES, v, lens, col.validity)

    if isinstance(expr, ir.IsNull):
        col = eval_expr(expr.arg, chunk)
        if col.validity is None:
            isnull = torch.zeros((n,), dtype=torch.bool, device=dev)
        else:
            isnull = ~col.validity
        return DCol(T.BOOLEAN, PLAIN, ~isnull if expr.negated else isnull)

    if isinstance(expr, ir.Func):
        return _eval_func(expr, chunk)

    raise NotImplementedError(type(expr).__name__)


def _literal(expr: ir.Literal, n: int, dev) -> DCol:
    """A literal broadcast to ``n`` rows: a string as a BYTES column, a
    zoned timestamp as its (UTC instant, offset) pair, a NULL of any type
    as a column of its type's layout with no valid row (a long decimal's
    is ``[n, 2]``)."""
    t, v = expr.dtype, expr.value
    if T.is_timestamp_tz(t):
        us, off = (0, 0) if v is None else v  # (utc_micros, offset_minutes)
        return DCol(t, PLAIN, torch.full((n,), int(us), dtype=torch.int64,
                                         device=dev),
                    validity=None if v is not None else torch.zeros(
                        (n,), dtype=torch.bool, device=dev),
                    values2=torch.full((n,), int(off), dtype=torch.int32,
                                       device=dev))
    if v is None and isinstance(t, (T.ArrayType, T.MapType)):
        return _nested_null(t, n, dev)
    if not isinstance(v, (type(None), str, bool, int, float)):
        raise NotImplementedError(f"{t} literal {v!r}")
    if v is None:
        never = torch.zeros((n,), dtype=torch.bool, device=dev)
        if T.is_string(t):
            return DCol(t, BYTES, torch.zeros((n, 1), dtype=torch.uint8,
                                              device=dev),
                        torch.zeros((n,), dtype=torch.int32, device=dev),
                        never)
        shape = (n, 2) if T.is_long_decimal(t) else (n,)
        dtype = (torch.bool if isinstance(t, T.BooleanType) else
                 torch.float64 if isinstance(t, T.DoubleType) else
                 torch.int64)
        return DCol(t, PLAIN, torch.zeros(shape, dtype=dtype, device=dev),
                    validity=never)
    if T.is_string(t):
        b = v.encode("ascii")
        row = torch.tensor(list(b.ljust(max(len(b), 1), b"\0")),
                           dtype=torch.uint8, device=dev)
        return DCol(t, BYTES, row.expand(n, row.shape[0]),
                    torch.full((n,), len(b), dtype=torch.int32, device=dev))
    if isinstance(t, T.BooleanType):
        return DCol(t, PLAIN, torch.full((n,), bool(v), dtype=torch.bool,
                                         device=dev))
    if isinstance(t, T.DoubleType):
        return DCol(t, PLAIN, torch.full((n,), float(v), dtype=torch.float64,
                                         device=dev))
    v = int(v)
    if not -2**63 <= v < 2**63:  # long-decimal literal: (hi, lo) words
        lo = v % (1 << 64)
        words = torch.tensor([v >> 64, lo - (1 << 64) if lo >= 1 << 63
                              else lo], dtype=torch.int64, device=dev)
        return DCol(t if T.is_long_decimal(t) else T.decimal(38, 0), PLAIN,
                    words.expand(n, 2))
    return DCol(t, PLAIN, torch.full((n,), v, dtype=torch.int64, device=dev))


def dcol_to_bytes(c: DCol) -> DCol:
    """A DICT column decoded into a BYTES column (the dictionary's strings
    as a host-built byte matrix, gathered by code)."""
    if c.kind == BYTES:
        return c
    if c.kind != DICT:
        raise NotImplementedError(f"{c.kind} {c.dtype} as a string column")
    mat, lens = dictionary_bytes(c)
    codes = c.values.to(torch.int64)
    return DCol(c.dtype, BYTES, mat[codes], lens[codes], c.validity)


def dictionary_bytes(c: DCol) -> Tuple[torch.Tensor, torch.Tensor]:
    """(byte matrix, lengths) of a DICT column's dictionary entries, built
    on the host, on the column's device (one zero row when empty)."""
    strs = [str(s).encode("ascii") for s in c.dictionary.strings]
    w = max([len(b) for b in strs] + [1])
    mat = np.zeros((max(len(strs), 1), w), np.uint8)
    lens = np.zeros(max(len(strs), 1), np.int32)
    for i, b in enumerate(strs):
        mat[i, :len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    dev = c.values.device
    return torch.from_numpy(mat).to(dev), torch.from_numpy(lens).to(dev)


def _pad_bytes(v: torch.Tensor, w: int) -> torch.Tensor:
    return torch.nn.functional.pad(v, (0, w - v.shape[1])) \
        if v.shape[1] < w else v


def _in_list(expr: ir.InList, chunk: Chunk) -> DCol:
    """``x IN (literals)``: a dictionary predicate, or an OR of equalities
    compared in the column's own units, as ``=`` compares (a literal the
    column's type cannot hold matches nothing: the JAX package compares
    unscaled values).  A NULL in the list makes every row that matches no
    value NULL, so ``NOT IN (..., NULL)`` keeps no row."""
    col = eval_expr(expr.arg, chunk)
    lits = [v for v in expr.values if v.value is not None]
    dev = col.values.device
    none = torch.zeros((chunk.n_rows,), dtype=torch.bool, device=dev)
    if col.kind == DICT:
        vals = {v.value for v in lits if isinstance(v.value, str)}
        m = _dict_predicate(col, lambda s: s in vals)
    elif col.kind == BYTES:
        m = none
        for v in lits:
            m = m | S.eq_literal(col.values, col.lengths, v.value)
    elif col.kind == PLAIN and isinstance(col.dtype, T.DoubleType):
        m = none
        for v in lits:
            m = m | (col.values == _literal_double(v))
    elif col.kind == PLAIN and isinstance(col.dtype, T.BooleanType):
        m = none
        for v in lits:
            m = m | (col.values == bool(v.value))
    elif col.kind == PLAIN:
        m = none
        for v in lits:
            x = ir.in_column_units(v, col.dtype)
            if x is None:
                raise NotImplementedError(
                    f"IN over a {col.dtype} column with a {v.dtype} value")
            if x.denominator != 1:
                continue  # not a value of the column's type
            m = m | _eq_int(col, int(x))
    else:
        raise NotImplementedError(f"IN over a {col.kind} {col.dtype} column")
    validity = col.validity
    if len(lits) < len(expr.values):
        validity = _and_validity(validity, m)
    return DCol(T.BOOLEAN, PLAIN, m, validity=validity)


def _literal_double(v: ir.Literal) -> float:
    """A numeric literal as float64 (a decimal's value, not its unscaled
    integer)."""
    if T.is_decimal(v.dtype):
        return int(v.value) / 10 ** v.dtype.scale
    return float(v.value)


def _eq_int(col: DCol, x: int) -> torch.Tensor:
    """``col == x`` for an integer, date or decimal column and an integer
    in its units; a long decimal compares (hi, lo) words, and a value
    outside the column's storage matches nothing."""
    if _is_i128(col):
        if not -2**127 <= x < 2**127:
            return torch.zeros((col.n_rows,), dtype=torch.bool,
                               device=col.values.device)
        hi, lo = I128.unpack(col.values)
        lw = x % (1 << 64)
        return (hi == (x >> 64)) & (lo == (lw - (1 << 64) if lw >= 1 << 63
                                           else lw))
    info = torch.iinfo(col.values.dtype)
    if not info.min <= x <= info.max:
        return torch.zeros((col.n_rows,), dtype=torch.bool,
                           device=col.values.device)
    return col.values == x


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def civil_from_days(days: torch.Tensor):
    """(year, month, day) of days since 1970-01-01 (Hinnant's
    civil_from_days); every division floors, so days before the epoch
    are right too."""
    z = days.to(torch.int64) + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)  # month index from March
    day = doy - _fdiv(153 * mp + 2, 5) + 1
    month = torch.where(mp < 10, mp + 3, mp - 9)
    # January and February close the civil year that began the March before
    return yoe + era * 400 + (month <= 2).to(torch.int64), month, day


def days_from_civil(y, m, d) -> torch.Tensor:
    """Days since 1970-01-01 of (year, month, day) (Hinnant's inverse)."""
    y = y - (m <= 2).to(torch.int64)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def year_from_days(days: torch.Tensor) -> torch.Tensor:
    """Civil year of days since 1970-01-01."""
    return civil_from_days(days)[0]


def _eval_func(expr: ir.Func, chunk: Chunk) -> DCol:
    """Scalar functions (reference: ``operator/scalar/``): those of
    ``_FUNCS`` over their evaluated arguments, and the argument-less ones
    of ``_NULLARY`` over the chunk's rows; any other raises
    ``NotImplementedError`` with its name."""
    name = expr.name
    if name in _NULLARY:
        return _NULLARY[name](expr, chunk)
    if name == "array_pack" and not expr.args:  # ARRAY[]
        return _array(expr.dtype, torch.zeros(
            (chunk.n_rows, 0), dtype=_torch_dtype(expr.dtype.element),
            device=chunk.mask.device), torch.zeros(
                (chunk.n_rows,), device=chunk.mask.device), None)
    if name not in _FUNCS:
        raise NotImplementedError(f"scalar function {name}")
    return _FUNCS[name](expr, [eval_expr(a, chunk) for a in expr.args])


def _abs(expr, args) -> DCol:
    (a,) = args
    v = I128.pack(*I128.abs128(*I128.unpack(a.values))) if _is_i128(a) \
        else a.values.abs()
    return DCol(a.dtype, PLAIN, v, validity=a.validity)


def _round(expr, args) -> DCol:
    """round(x[, d]) to ``d`` places, typed decimal(38, d) by the planner.
    A DOUBLE rounds its scaled value half away from zero, as Trino's
    ``MathFunctions.round`` does (the JAX package rounds half to even); a
    decimal rescales HALF_UP."""
    (a,) = args
    ts = _scale_of(expr.dtype)
    if isinstance(a.dtype, T.DoubleType):
        x = a.values * float(10 ** ts)
        v = (torch.sign(x) * torch.floor(x.abs() + 0.5)).to(torch.int64)
    elif _is_i128(a):
        v = I128.pack(*I128.rescale(*I128.unpack(a.values),
                                    _scale_of(a.dtype), ts))
    else:
        v = D.rescale(a.values.to(torch.int64), _scale_of(a.dtype), ts)
    return DCol(expr.dtype, PLAIN, v, validity=a.validity)


def _coalesce(expr, args) -> DCol:
    """The first non-NULL argument of each row.  String arguments go to
    BYTES, padded to the widest; decimals rescale to the result's scale,
    and one long-decimal argument widens every one to (hi, lo) words; a
    zoned result takes each row's offset with its value (the JAX package
    drops the offsets); ARRAY and MAP arguments go to one layout
    (``nested_layouts``)."""
    rt = expr.dtype
    if isinstance(rt, (T.ArrayType, T.MapType)):
        vals, vals2, d, d2 = nested_layouts(args, rt)
        out, out2, ln = vals[-1], None if vals2 is None else vals2[-1], \
            args[-1].lengths
        for i in range(len(args) - 2, -1, -1):
            ok = args[i].valid_or_true()
            out = torch.where(ok[:, None], vals[i], out)
            if out2 is not None:
                out2 = torch.where(ok[:, None], vals2[i], out2)
            ln = torch.where(ok, args[i].lengths, ln)
        return DCol(rt, args[0].kind, out, ln.to(torch.int32),
                    _or_validity([a.validity for a in args]), d, out2, d2)
    if T.is_string(rt):
        cols = [dcol_to_bytes(a) for a in args]
        w = max(c.values.shape[1] for c in cols)
        vals, lens = _pad_bytes(cols[-1].values, w), cols[-1].lengths
        for c in reversed(cols[:-1]):
            ok = c.valid_or_true()
            vals = torch.where(ok[:, None], _pad_bytes(c.values, w), vals)
            lens = torch.where(ok, c.lengths, lens)
        valid = _or_validity([c.validity for c in cols])
        return DCol(rt, BYTES, vals, lens, valid)
    if isinstance(rt, T.DoubleType):
        vals = [as_double(a) for a in args]
    else:
        cols = [_rescale_col(a, _scale_of(rt)) if T.is_decimal(rt) else a
                for a in args]
        if any(_is_i128(c) for c in cols):
            vals = [I128.pack(*_col_i128(c)) for c in cols]
        else:
            vals = [c.values for c in cols]
    out = vals[-1]
    zoned = T.is_timestamp_tz(rt)
    offs = _offsets(args[-1]) if zoned else None
    for a, v in zip(reversed(args[:-1]), reversed(vals[:-1])):
        ok = a.valid_or_true()
        out = torch.where(ok[:, None] if v.dim() == 2 else ok, v, out)
        if zoned:
            offs = torch.where(ok, _offsets(a), offs)
    return DCol(rt, PLAIN, out,
                validity=_or_validity([a.validity for a in args]),
                values2=offs)


def _offsets(c: DCol) -> torch.Tensor:
    """A timestamp column's int32 offsets (0, UTC, for a plain one)."""
    if c.values2 is not None:
        return c.values2
    return torch.zeros((c.n_rows,), dtype=torch.int32,
                       device=c.values.device)


def _or_validity(vs) -> Optional[torch.Tensor]:
    """Valid where any is (None = every row valid)."""
    if any(v is None for v in vs):
        return None
    out = vs[0]
    for v in vs[1:]:
        out = out | v
    return out


def _upper_lower(expr, args) -> DCol:
    """``upper`` / ``lower`` of ASCII letters: a DICT column through its
    host dictionary, a BYTES column on the device."""
    (a,) = args
    up = expr.name == "upper"
    if a.kind == DICT:
        return _host_map(a, str.upper if up else str.lower, a.dtype)
    if a.kind != BYTES:
        raise NotImplementedError(f"{expr.name} of a {a.kind} column")
    v = a.values
    first, delta = ("a", -32) if up else ("A", 32)
    hit = (v >= ord(first)) & (v <= ord(first) + 25)
    return DCol(a.dtype, BYTES, torch.where(hit, v + delta, v), a.lengths,
                a.validity)


def _length(expr, args) -> DCol:
    """Characters of a string: a DICT column's lengths from its host
    dictionary, gathered by code; a BYTES column's lengths."""
    (a,) = args
    if a.kind == DICT:
        lens = np.array([len(str(x)) for x in a.dictionary.strings],
                        dtype=np.int64)
        v = torch.from_numpy(lens).to(a.values.device)[
            a.values.to(torch.int64)]
    elif a.kind == BYTES:
        v = a.lengths.to(torch.int64)
    else:
        raise NotImplementedError(f"length of a {a.kind} column")
    return DCol(T.BIGINT, PLAIN, v, validity=a.validity)


def _concat(expr, args) -> DCol:
    """String concatenation as a byte matrix: byte k of a row is byte k of
    the first string below its length, else byte k - len of the second."""
    out = dcol_to_bytes(args[0])
    for b in map(dcol_to_bytes, args[1:]):
        wa, wb = out.values.shape[1], b.values.shape[1]
        la = out.lengths.to(torch.int64)[:, None]
        k = torch.arange(wa + wb, device=la.device)[None, :]
        j = k - la
        from_b = torch.gather(b.values, 1, j.clamp(0, wb - 1))
        in_b = (j >= 0) & (j < b.lengths.to(torch.int64)[:, None])
        vals = torch.where(k < la, _pad_bytes(out.values, wa + wb),
                           torch.where(in_b, from_b, 0))
        out = DCol(expr.dtype, BYTES, vals.to(torch.uint8),
                   out.lengths + b.lengths,
                   _and_validity(out.validity, b.validity))
    return out


def _mod(expr, args) -> DCol:
    """mod(a, b), truncated toward zero as Java's ``%`` is: integers give
    a BIGINT; decimals are taken at the larger scale (the planner types
    the result as Trino does); DOUBLE is ``fmod``.  A zero divisor gives
    NULL, as the JAX package's validity does (which also takes a
    decimal's unscaled value and types the result BIGINT)."""
    a, b = args
    rt = expr.dtype
    if isinstance(rt, T.DoubleType):
        x, y = as_double(a), as_double(b)
        nz = y != 0
        v = torch.fmod(x, torch.where(nz, y, 1.0))
    elif _is_i128(a) or _is_i128(b) or T.is_long_decimal(rt):
        s = _scale_of(rt)
        nh, nl = _col_i128(a, s)
        dh, dl = _col_i128(b, s)
        nz = ~I128.eq(dh, dl, torch.zeros_like(dh), torch.zeros_like(dl))
        _, _, rh, rl = I128.udivmod(*I128.abs128(nh, nl), *I128.abs128(
            dh, torch.where(nz, dl, 1)))
        mh, ml = I128.neg(rh, rl)
        rh, rl = torch.where(nh < 0, mh, rh), torch.where(nh < 0, ml, rl)
        v = I128.pack(rh, rl) if T.is_long_decimal(rt) else rl
    else:
        s = _scale_of(rt)
        x = D.rescale(a.values.to(torch.int64), _scale_of(a.dtype), s)
        y = D.rescale(b.values.to(torch.int64), _scale_of(b.dtype), s)
        nz = y != 0
        v = torch.fmod(x, torch.where(nz, y, 1))
    return DCol(rt, PLAIN, v,
                validity=_and_validity(a.validity, b.validity, nz))


def _greatest_least(expr, args) -> DCol:
    """``greatest`` / ``least`` in the result's type: DOUBLE as float64,
    decimals at the result's scale (long ones as (hi, lo) words),
    integers and dates as they are.  NULL where any argument is (the
    JAX package rescales every argument as int64, DOUBLE too)."""
    rt = expr.dtype
    big = expr.name == "greatest"
    valid = _and_validity(*(a.validity for a in args))
    if isinstance(rt, T.DoubleType):
        out = as_double(args[0])
        for a in args[1:]:
            out = (torch.maximum if big else torch.minimum)(out, as_double(a))
        return DCol(rt, PLAIN, out, validity=valid)
    if not (T.is_decimal(rt) or T.is_integral(rt)
            or isinstance(rt, T.DateType)):
        raise NotImplementedError(f"{expr.name} of {rt}")
    s = _scale_of(rt)
    if T.is_long_decimal(rt) or any(_is_i128(a) for a in args):
        hi, lo = _col_i128(args[0], s)
        for a in args[1:]:
            h, l = _col_i128(a, s)
            take = I128.lt(hi, lo, h, l) if big else I128.lt(h, l, hi, lo)
            hi, lo = torch.where(take, h, hi), torch.where(take, l, lo)
        out = I128.pack(hi, lo) if T.is_long_decimal(rt) else lo
        return DCol(rt, PLAIN, out, validity=valid)
    out = D.rescale(args[0].values.to(torch.int64), _scale_of(args[0].dtype),
                    s)
    for a in args[1:]:
        v = D.rescale(a.values.to(torch.int64), _scale_of(a.dtype), s)
        out = torch.maximum(out, v) if big else torch.minimum(out, v)
    if isinstance(rt, T.DateType):
        out = out.to(torch.int32)
    return DCol(rt, PLAIN, out, validity=valid)


# ------------------------------------------------ math and bitwise scalars
# (reference: ``MathFunctions.java``, ``BitwiseFunctions.java``; the JAX
# package's ``_eval_math_func``): elementwise torch, no kernel of their own

def _double_fn(f, dtype=T.DOUBLE):
    """A one-argument function of a number's float64 value (a DOUBLE, or
    a BOOLEAN for the ``is_nan`` family)."""
    def run(expr, args) -> DCol:
        (a,) = args
        return DCol(dtype, PLAIN, f(as_double(a)), validity=a.validity)
    return run


def _double_fn2(f):
    """A two-argument function of two numbers' float64 values."""
    def run(expr, args) -> DCol:
        a, b = args
        return DCol(T.DOUBLE, PLAIN, f(as_double(a), as_double(b)),
                    validity=_and_validity(a.validity, b.validity))
    return run


def cbrt(x: torch.Tensor) -> torch.Tensor:
    """Cube root (torch has none): ``|x| ** (1/3)`` with x's sign, then one
    Newton step, which brings it within an ulp or two of the correctly
    rounded root; 0, infinities and NaN pass through."""
    y = torch.sign(x) * x.abs().pow(1.0 / 3.0)
    ok = (y != 0) & torch.isfinite(y)
    y2 = torch.where(ok, y * y, 1.0)
    return torch.where(ok, y - (y * y2 - x) / (3.0 * y2), y)


def _sqrt(expr, args) -> DCol:
    """Square root; NULL for a negative value (the JAX package's rule;
    Trino returns NaN)."""
    (a,) = args
    v = as_double(a)
    ok = v >= 0
    return DCol(T.DOUBLE, PLAIN, torch.sqrt(torch.where(ok, v, 0.0)),
                validity=_and_validity(a.validity, ok))


_LOGS = {"ln": torch.log, "log10": torch.log10, "log2": torch.log2}


def _log(expr, args) -> DCol:
    """``ln``, ``log10``, ``log2`` and ``log(base, x)``; NULL where x or
    the base is not positive, or the base is 1 (the JAX package's rule;
    Trino returns NaN or -Infinity)."""
    if expr.name == "log":
        b, a = args
        vb, va = as_double(b), as_double(a)
        ok = (va > 0) & (vb > 0) & (vb != 1.0)
        out = torch.log(torch.where(va > 0, va, 1.0)) \
            / torch.log(torch.where(ok, vb, 2.0))
        return DCol(T.DOUBLE, PLAIN, out,
                    validity=_and_validity(a.validity, b.validity, ok))
    (a,) = args
    v = as_double(a)
    return DCol(T.DOUBLE, PLAIN, _LOGS[expr.name](torch.where(v > 0, v, 1.0)),
                validity=_and_validity(a.validity, v > 0))


def _ceil_floor(expr, args) -> DCol:
    """``ceil`` / ``ceiling`` / ``floor``: a DOUBLE stays DOUBLE, a
    decimal becomes ``decimal(p, 0)`` (its unscaled value divided by
    10^s, rounded up or down), an integer is itself."""
    (a,) = args
    up = expr.name != "floor"
    if isinstance(a.dtype, T.DoubleType):
        f = torch.ceil if up else torch.floor
        return DCol(T.DOUBLE, PLAIN, f(a.values), validity=a.validity)
    s = _scale_of(a.dtype)
    if _is_i128(a):
        # HALF_UP to scale 0, then one step where that went the wrong way
        hi, lo = I128.unpack(a.values)
        qh, ql = I128.rescale(hi, lo, s, 0)
        bh, bl = I128.rescale(qh, ql, 0, s)
        fix = I128.lt(bh, bl, hi, lo) if up else I128.lt(hi, lo, bh, bl)
        step = torch.where(fix, 1 if up else -1, 0)
        qh, ql = I128.add(qh, ql, step >> 63, step)
        v = I128.pack(qh, ql) if T.is_long_decimal(expr.dtype) else ql
        return DCol(expr.dtype, PLAIN, v, validity=a.validity)
    v = a.values.to(torch.int64)
    if s:
        p = 10 ** s
        v = _fdiv(v + (p - 1), p) if up else _fdiv(v, p)
    return DCol(expr.dtype, PLAIN, v, validity=a.validity)


def _sign(expr, args) -> DCol:
    """-1, 0 or 1 in the planner's type (DOUBLE, ``decimal(1, 0)`` or
    BIGINT); a DOUBLE NaN stays NaN (``torch.sign`` gives 0)."""
    (a,) = args
    if isinstance(a.dtype, T.DoubleType):
        x = a.values
        return DCol(T.DOUBLE, PLAIN, torch.where(torch.isnan(x), x,
                                                 torch.sign(x)),
                    validity=a.validity)
    if _is_i128(a):
        hi, lo = I128.unpack(a.values)
        v = torch.where(hi < 0, -1, ((hi != 0) | (lo != 0)).to(torch.int64))
    else:
        v = torch.sign(a.values.to(torch.int64))
    return DCol(expr.dtype, PLAIN, v, validity=a.validity)


def _width_bucket(expr, args) -> DCol:
    """width_bucket(x, lo, hi, k): the 1-based bucket of x among k equal
    buckets of [lo, hi), 0 below and k + 1 above (the JAX package's
    arithmetic)."""
    x, lo, hi, k = (as_double(a) for a in args)
    frac = (x - lo) / torch.where(hi != lo, hi - lo, 1.0)
    b = torch.clamp(torch.floor(frac * k).to(torch.int64) + 1, min=0)
    b = torch.minimum(b, k.to(torch.int64) + 1)
    return DCol(T.BIGINT, PLAIN, b,
                validity=_and_validity(*(a.validity for a in args)))


def _i64(a: DCol) -> torch.Tensor:
    return a.values.to(torch.int64)


_BITWISE = {"bitwise_and": torch.bitwise_and, "bitwise_or": torch.bitwise_or,
            "bitwise_xor": torch.bitwise_xor}


def _bitwise2(expr, args) -> DCol:
    a, b = args
    return DCol(T.BIGINT, PLAIN, _BITWISE[expr.name](_i64(a), _i64(b)),
                validity=_and_validity(a.validity, b.validity))


def _bitwise_not(expr, args) -> DCol:
    (a,) = args
    return DCol(T.BIGINT, PLAIN, ~_i64(a), validity=a.validity)


def popcount64(v: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64's 64-bit pattern (torch has no popcount):
    the SWAR sum of bit pairs, nibbles and bytes.  Each mask clears the
    sign bit before anything reads it, so the arithmetic right shifts act
    as logical ones, and the byte sums' product wraps as uint64 would."""
    v = v - ((v >> 1) & 0x5555555555555555)
    v = (v & 0x3333333333333333) + ((v >> 2) & 0x3333333333333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F0F0F0F0F
    return (v * 0x0101010101010101) >> 56


def _bit_count(expr, args) -> DCol:
    """bit_count(x[, bits]): set bits of x's two's complement in ``bits``
    bits (a literal, 64 by default)."""
    a = args[0]
    bits = 64
    if len(args) > 1:
        if not isinstance(expr.args[1], ir.Literal):
            raise NotImplementedError("bit_count with a non-literal width")
        bits = int(expr.args[1].value)
    v = _i64(a)
    if bits < 64:
        v = v & ((1 << bits) - 1)
    return DCol(T.BIGINT, PLAIN, popcount64(v), validity=a.validity)


def _shift(expr, args) -> DCol:
    """The three shifts of a BIGINT, the count clamped to 0-63 as in the
    JAX package.  The logical right shift moves one place and clears the
    sign bit, after which the arithmetic shift fills with zeros."""
    a, b = args
    v = _i64(a)
    k = _i64(b).clamp(0, 63)
    if expr.name == "bitwise_left_shift":
        out = v << k
    elif expr.name == "bitwise_right_shift_arithmetic":
        out = v >> k
    else:
        out = torch.where(k == 0, v, ((v >> 1) & (2**63 - 1))
                          >> (k - 1).clamp_min(0))
    return DCol(T.BIGINT, PLAIN, out,
                validity=_and_validity(a.validity, b.validity))


# ------------------------------------------------ dates, times and zones
# (reference: ``DateTimeFunctions.java``, ``AtTimeZone``,
# ``TimestampWithTimeZoneOperators``).  Days and microseconds are int64
# arithmetic on the device; a TIMESTAMP WITH TIME ZONE keeps its UTC
# instant in ``values`` and its offset in ``values2``.  Field extraction
# and formatting read the wall time in the value's zone; compares,
# ``to_unixtime`` and the day and week spans of ``date_diff`` read the
# instant; ``date_trunc`` and ``date_add`` step the wall time and keep
# the offset.

US_PER_DAY = 86_400_000_000
US_PER_MINUTE = 60_000_000
_ZONE_OFFSET = re.compile(r"([+-])(\d{1,2})(?::?(\d{2}))?")


def _zone_offset_minutes(z: str) -> int:
    """A fixed-offset zone → minutes east of UTC: ``UTC``, ``Z``,
    ``GMT``, ``+05:30``, ``-08``.  A named IANA zone raises: its offset
    depends on the instant (the reference resolves it through
    ``spi/TimeZoneKey`` and the zone's rules)."""
    z = z.strip()
    if z.upper() in ("UTC", "Z", "GMT"):
        return 0
    m = _ZONE_OFFSET.fullmatch(z)
    if m is None:
        raise NotImplementedError(f"named time zone {z!r} (fixed offsets "
                                  "only)")
    sign, hh, mm = m.groups()
    return (-1 if sign == "-" else 1) * (int(hh) * 60 + int(mm or 0))


def _offset_micros(col: DCol) -> torch.Tensor:
    """A timestamp column's offsets in microseconds."""
    return _offsets(col).to(torch.int64) * US_PER_MINUTE


def _micros(col: DCol) -> torch.Tensor:
    """The wall time of a date, timestamp or zoned column in microseconds
    (a date at midnight; a zoned value in its own zone, as the reference's
    ``TimestampWithTimeZoneToTimestampCast`` reads it)."""
    v = col.values.to(torch.int64)
    if T.is_timestamp_tz(col.dtype):
        return v + _offset_micros(col)
    if isinstance(col.dtype, T.TimestampType):
        return v
    if isinstance(col.dtype, T.DateType):
        return v * US_PER_DAY
    raise NotImplementedError(f"time field of a {col.dtype} column")


def _instant(col: DCol) -> torch.Tensor:
    """Microseconds since the epoch of a timestamp's instant (a plain
    timestamp is in the session zone, UTC; a date at its midnight)."""
    if isinstance(col.dtype, T.DateType):
        return col.values.to(torch.int64) * US_PER_DAY
    return col.values.to(torch.int64)


def _to_days(col: DCol) -> torch.Tensor:
    """A date's days; a timestamp's wall-time day, floored."""
    if isinstance(col.dtype, T.DateType):
        return col.values.to(torch.int64)
    return _fdiv(_micros(col), US_PER_DAY)


def _zoned(to: T.DataType, wall: torch.Tensor, col: DCol,
           validity=None) -> DCol:
    """A result of ``to``: a plain timestamp, or for a zoned ``col`` the
    instant of ``wall`` in ``col``'s zones with its offsets kept."""
    if T.is_timestamp_tz(col.dtype):
        return DCol(to, PLAIN, wall - _offset_micros(col), validity=validity,
                    values2=col.values2)
    return DCol(to, PLAIN, wall, validity=validity)


def _is_datetime(t: T.DataType) -> bool:
    return isinstance(t, (T.DateType, T.TimestampType, T.TimestampTzType))


def _cast_datetime(col: DCol, to: T.DataType) -> DCol:
    """Casts among DATE, TIMESTAMP(p) and TIMESTAMP(p) WITH TIME ZONE.  A
    precision cast keeps the microseconds (rendering truncates, as in
    the JAX package); zoned → plain reads the wall time, zoned → zoned
    keeps instant and offsets (the JAX package resets the offset to 0),
    plain → zoned takes the session zone, UTC."""
    if T.is_timestamp_tz(to):
        return DCol(to, PLAIN, _instant(col), validity=col.validity,
                    values2=_offsets(col))
    if isinstance(to, T.TimestampType):
        return DCol(to, PLAIN, _micros(col), validity=col.validity)
    return DCol(to, PLAIN, _to_days(col).to(torch.int32),
                validity=col.validity)


def _date_field(expr, args) -> DCol:
    """``month``, ``day``, ``quarter``, ``day_of_week``, ``day_of_year``,
    and ISO ``week`` / ``year_of_week`` (the week of the Thursday), read
    from the wall-time day."""
    (a,) = args
    days = _to_days(a)
    name = expr.name
    dow = (days + 3) % 7 + 1  # ISO: Monday is 1
    if name in ("week", "year_of_week", "yow"):
        thursday = days + (4 - dow)
        y = civil_from_days(thursday)[0]
        if name == "week":
            jan1 = days_from_civil(y, torch.ones_like(y), torch.ones_like(y))
            v = _fdiv(thursday - jan1, 7) + 1
        else:
            v = y
    elif name in ("day_of_week", "dow"):
        v = dow
    else:
        y, m, d = civil_from_days(days)
        if name == "month":
            v = m
        elif name == "day":
            v = d
        elif name == "quarter":
            v = _fdiv(m + 2, 3)
        else:  # day_of_year / doy
            one = torch.ones_like(y)
            v = days - days_from_civil(y, one, one) + 1
    return DCol(T.BIGINT, PLAIN, v, validity=a.validity)


_TIME_FIELDS = {"hour": (3_600_000_000, 24), "minute": (60_000_000, 60),
                "second": (1_000_000, 60), "millisecond": (1_000, 1000)}


def _time_field(expr, args) -> DCol:
    """``hour``, ``minute``, ``second``, ``millisecond`` of the wall time
    (a date is at midnight)."""
    (a,) = args
    us = _micros(a)
    div, mod = _TIME_FIELDS[expr.name]
    tod = us - _fdiv(us, US_PER_DAY) * US_PER_DAY
    return DCol(T.BIGINT, PLAIN, _fdiv(tod, div) % mod, validity=a.validity)


def _month_length(y: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    one = torch.ones_like(y)
    return days_from_civil(torch.where(m == 12, y + 1, y),
                           torch.where(m == 12, 1, m + 1), one) \
        - days_from_civil(y, m, one)


def _last_day_of_month(expr, args) -> DCol:
    (a,) = args
    y, m, _ = civil_from_days(_to_days(a))
    v = days_from_civil(y, m, torch.ones_like(y)) + _month_length(y, m) - 1
    return DCol(T.DATE, PLAIN, v.to(torch.int32), validity=a.validity)


def _from_unixtime(expr, args) -> DCol:
    """Seconds (a number) → a timestamp, its microseconds truncated
    toward zero as the JAX package's conversion does."""
    (a,) = args
    return DCol(expr.dtype, PLAIN, (as_double(a) * 1e6).to(torch.int64),
                validity=a.validity)


def _to_unixtime(expr, args) -> DCol:
    """Seconds since the epoch of the instant (a zoned value is not
    shifted by its offset; the JAX package shifts it)."""
    (a,) = args
    v = a.values.to(torch.float64)
    v = v * 86400.0 if isinstance(a.dtype, T.DateType) else v / 1e6
    return DCol(T.DOUBLE, PLAIN, v, validity=a.validity)


def _at_timezone(expr, args) -> DCol:
    """``x AT TIME ZONE z``: the same instant shown at ``z``'s offset (a
    plain timestamp is an instant in the session zone, UTC)."""
    a = args[0]
    if not isinstance(a.dtype, (T.TimestampType, T.TimestampTzType)):
        raise NotImplementedError(f"AT TIME ZONE of a {a.dtype} value")
    off = _zone_offset_minutes(_lit_str(expr, 1, "zone"))
    us = a.values.to(torch.int64)
    return DCol(expr.dtype, PLAIN, us, validity=a.validity,
                values2=torch.full(us.shape, off, dtype=torch.int32,
                                   device=us.device))


def _unit(expr) -> str:
    return _lit_str(expr, 0, "unit").lower()


def _trunc_days(days: torch.Tensor, unit: str) -> torch.Tensor:
    if unit == "day":
        return days
    if unit == "week":
        return days - (days + 3) % 7
    y, m, _ = civil_from_days(days)
    one = torch.ones_like(y)
    if unit == "month":
        return days_from_civil(y, m, one)
    if unit == "quarter":
        return days_from_civil(y, _fdiv(m - 1, 3) * 3 + 1, one)
    if unit == "year":
        return days_from_civil(y, one, one)
    raise NotImplementedError(f"date_trunc unit {unit}")


_TRUNC_MICROS = {"second": 1_000_000, "minute": 60_000_000,
                 "hour": 3_600_000_000, "day": US_PER_DAY}


def _date_trunc(expr, args) -> DCol:
    """``date_trunc(unit, x)``: a zoned value is truncated in its own
    zone and keeps its offset (the JAX package truncates the wall time
    and stores it as the instant)."""
    unit, a = _unit(expr), args[1]
    if isinstance(a.dtype, T.DateType):
        return DCol(T.DATE, PLAIN,
                    _trunc_days(_to_days(a), unit).to(torch.int32),
                    validity=a.validity)
    us = _micros(a)
    if unit in _TRUNC_MICROS:
        step = _TRUNC_MICROS[unit]
        wall = _fdiv(us, step) * step
    else:
        wall = _trunc_days(_fdiv(us, US_PER_DAY), unit) * US_PER_DAY
    return _zoned(a.dtype, wall, a, a.validity)


def _add_months(days: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``days`` moved ``k`` calendar months, the day clamped to the
    target month's length."""
    y, m, d = civil_from_days(days)
    months = y * 12 + (m - 1) + k
    ny, nm = _fdiv(months, 12), months % 12 + 1
    return days_from_civil(ny, nm, torch.minimum(d, _month_length(ny, nm)))


_ADD_DAYS = {"day": 1, "week": 7}
_ADD_MONTHS = {"month": 1, "quarter": 3, "year": 12}
_ADD_MICROS = {"millisecond": 1_000, "second": 1_000_000,
               "minute": 60_000_000, "hour": 3_600_000_000}


def _date_add(expr, args) -> DCol:
    """``date_add(unit, k, x)``: days and weeks, and months, quarters
    and years with the day clamped to the target month's length; a
    timestamp keeps its time of day (the JAX package returns its day as
    a DATE) and also takes the sub-day units."""
    unit = _unit(expr)
    k, a = args[1].values.to(torch.int64), args[2]
    dated = isinstance(a.dtype, T.DateType)
    if unit not in _ADD_DAYS and unit not in _ADD_MONTHS and (
            dated or unit not in _ADD_MICROS):
        raise NotImplementedError(f"date_add unit {unit}")
    us = _micros(a)  # the wall time: a day or month step keeps its clock
    if unit in _ADD_MICROS:
        wall = us + k * _ADD_MICROS[unit]
    else:
        days = _fdiv(us, US_PER_DAY)
        moved = days + k * _ADD_DAYS[unit] if unit in _ADD_DAYS \
            else _add_months(days, k * _ADD_MONTHS[unit])
        wall = us + (moved - days) * US_PER_DAY
    valid = _and_validity(args[1].validity, a.validity)
    if dated:
        return DCol(T.DATE, PLAIN, _fdiv(wall, US_PER_DAY).to(torch.int32),
                    validity=valid)
    return _zoned(a.dtype, wall, a, valid)


def _leap(y: torch.Tensor) -> torch.Tensor:
    return (y % 4 == 0) & ((y % 100 != 0) | (y % 400 == 0))


def _whole_months(late: torch.Tensor, early: torch.Tensor) -> torch.Tensor:
    """Whole calendar months from wall time ``early`` to ``late`` (>=),
    Joda's ``BasicMonthOfYearDateTimeField.getDifferenceAsLong``: on the
    last day of ``late``'s month, a later day of ``early``'s month counts
    as that last day."""
    dl, de = _fdiv(late, US_PER_DAY), _fdiv(early, US_PER_DAY)
    yl, ml, dml = civil_from_days(dl)
    ye, me, dme = civil_from_days(de)
    last = dml == _month_length(yl, ml)
    dme = torch.where(last & (dme > dml), dml, dme)
    rem_l = (dml - 1) * US_PER_DAY + (late - dl * US_PER_DAY)
    rem_e = (dme - 1) * US_PER_DAY + (early - de * US_PER_DAY)
    return (yl - ye) * 12 + ml - me - (rem_l < rem_e).to(torch.int64)


_FEB_29 = 59 * US_PER_DAY  # offset of Feb 29 in a leap year


def _whole_years(late: torch.Tensor, early: torch.Tensor) -> torch.Tensor:
    """Whole years from ``early`` to ``late`` (>=), Joda's
    ``BasicGJChronology.getYearDifference``: a Feb 29 or later offset in
    one of a leap and a common year is balanced by a day."""
    yl = civil_from_days(_fdiv(late, US_PER_DAY))[0]
    ye = civil_from_days(_fdiv(early, US_PER_DAY))[0]
    one = torch.ones_like(yl)
    rem_l = late - days_from_civil(yl, one, one) * US_PER_DAY
    rem_e = early - days_from_civil(ye, one, one) * US_PER_DAY
    past = rem_e >= _FEB_29
    rem_e = torch.where(past & _leap(ye) & ~_leap(yl), rem_e - US_PER_DAY,
                        rem_e)
    rem_l = torch.where(past & ~_leap(ye) & (rem_l >= _FEB_29) & _leap(yl),
                        rem_l - US_PER_DAY, rem_l)
    return yl - ye - (rem_l < rem_e).to(torch.int64)


def _date_diff(expr, args) -> DCol:
    """``date_diff(unit, a, b)``: whole units from ``a`` to ``b``, as
    Trino's Joda fields count them.  Days and weeks are the elapsed
    instant truncated toward zero; months, quarters and years compare
    calendar fields of the wall times in ``a``'s zone.  A negative span
    is the negation of the positive one (the JAX package floors, and
    counts days between wall-time dates).  Sub-day units raise, as in
    the JAX package."""
    unit = _unit(expr)
    a, b = args[1], args[2]
    shift = _offset_micros(a)  # both read in a's zone
    ua, ub = _instant(a) + shift, _instant(b) + shift
    span = ub - ua
    if unit in ("day", "week"):
        step = US_PER_DAY * (7 if unit == "week" else 1)
        v = torch.div(span, step, rounding_mode="trunc")
    elif unit in ("month", "quarter", "year"):
        late, early = torch.maximum(ua, ub), torch.minimum(ua, ub)
        whole = _whole_years(late, early) if unit == "year" \
            else _whole_months(late, early)
        if unit == "quarter":
            whole = _fdiv(whole, 3)
        v = torch.where(span < 0, -whole, whole)
    else:
        raise NotImplementedError(f"date_diff unit {unit}")
    return DCol(T.BIGINT, PLAIN, v,
                validity=_and_validity(a.validity, b.validity))


_MYSQL_FORMAT = {"%Y": "%Y", "%y": "%y", "%m": "%m", "%d": "%d",
                 "%H": "%H", "%i": "%M", "%s": "%S", "%W": "%A",
                 "%a": "%a", "%M": "%B", "%j": "%j", "%%": "%%"}
_MYSQL_PARSE = {"%i": "%M", "%s": "%S", "%M": "%B", "%W": "%A"}
_JODA = {"yyyy": "%Y", "MM": "%m", "dd": "%d", "HH": "%H", "mm": "%M",
         "ss": "%S"}


def _strftime_format(name: str, fmt: str, parse: bool) -> str:
    """A ``date_format`` / ``date_parse`` (MySQL specifiers) or
    ``format_datetime`` / ``parse_datetime`` (a Joda subset) pattern as
    a ``strftime`` pattern, token by token."""
    if name in ("date_format", "date_parse"):
        table = _MYSQL_PARSE if parse else _MYSQL_FORMAT
        return re.sub(r"%.", lambda m: table.get(m.group(0), m.group(0)),
                      fmt)
    return re.sub(r"yyyy|MM|dd|HH|mm|ss", lambda m: _JODA[m.group(0)], fmt)


_EPOCH = dt.datetime(1970, 1, 1)
_ONE_MICRO = dt.timedelta(microseconds=1)


def _date_format(expr, args) -> DCol:
    """``date_format`` / ``format_datetime``: each distinct wall time
    (of the valid rows) formatted on the host, a DICT column over the
    distinct strings."""
    a = args[0]
    fmt = _strftime_format(expr.name, _lit_str(expr, 1, "format"), False)
    day = isinstance(a.dtype, T.DateType)
    v = _to_days(a) if day else _micros(a)
    uniq, codes = torch.unique(torch.where(a.valid_or_true(), v, 0),
                               return_inverse=True)
    unit = dt.timedelta(days=1) if day else dt.timedelta(microseconds=1)
    with host_read():
        units = uniq.tolist()
    strs = [(_EPOCH + unit * u).strftime(fmt) for u in units]
    return _dict_result(strs, codes, a.validity, T.VARCHAR)


def _date_parse(expr, args) -> DCol:
    """``date_parse`` / ``parse_datetime``: each distinct string of the
    valid rows parsed on the host, exact to the microsecond."""
    a = args[0]
    fmt = _strftime_format(expr.name, _lit_str(expr, 1, "format"), True)
    strs, codes = _host_strings(a)
    live = torch.zeros((len(strs),), dtype=torch.bool)
    seen = codes[a.valid_or_true()]
    with host_read():
        seen = seen.cpu()
    live[seen] = True
    us = [(dt.datetime.strptime(s, fmt) - _EPOCH) // _ONE_MICRO if ok else 0
          for s, ok in zip(strs, live.tolist())]
    table = torch.tensor(us, dtype=torch.int64, device=codes.device)
    return DCol(expr.dtype, PLAIN, table[codes] if len(us) else
                torch.zeros_like(codes), validity=a.validity)



# ------------------------------------------------ string functions
# (reference: ``StringFunctions.java``, ``JoniRegexpFunctions.java``,
# ``JsonFunctions.java``, ``UrlFunctions.java``, ``VarbinaryFunctions``).
# A DICT column maps its host dictionary.  A BYTES column stays a byte
# matrix on the device for the per-row, fixed-width functions (the trim
# family, ``reverse``, ``lpad``/``rpad``, ``starts_with``/``ends_with``,
# ``strpos``, ``codepoint``, ``chr``); the others decode its rows on the
# host, map each distinct string once and return a DICT column.  Bytes
# past a row's length are zero in every BYTES result.  ASCII only, and
# Python's ``re`` in place of Joni, as in the JAX package.

def _lit_str(expr: ir.Func, i: int, what: str) -> str:
    a = expr.args[i]
    if not (isinstance(a, ir.Literal) and isinstance(a.value, str)):
        raise NotImplementedError(f"{expr.name} with a non-literal {what}")
    return a.value


def _lit_int(expr: ir.Func, i: int, what: str) -> int:
    a = expr.args[i]
    if not (isinstance(a, ir.Literal) and isinstance(a.value, int)
            and not isinstance(a.value, bool)):
        raise NotImplementedError(f"{expr.name} with a non-literal {what}")
    return a.value


def _host_strings(col: DCol):
    """A string column's distinct strings on the host and each row's
    index among them (an int64 tensor on the column's device): a DICT
    column's dictionary and codes, or a BYTES column's rows decoded."""
    if col.kind == DICT:
        return ([str(s) for s in col.dictionary.strings],
                col.values.to(torch.int64))
    if col.kind != BYTES:
        raise NotImplementedError(f"string function of a {col.kind} "
                                  f"{col.dtype} column")
    with host_read():
        vals = np.ascontiguousarray(col.values.cpu().numpy())
    with host_read():
        lengths = col.lengths.cpu().tolist()
    w = vals.shape[1]
    raw = vals.tobytes()
    index: dict = {}
    rows = [index.setdefault(raw[i * w:i * w + ln], len(index))
            for i, ln in enumerate(lengths)]
    return ([b.decode("ascii") for b in index],
            torch.tensor(rows, dtype=torch.int64, device=col.values.device))


def _dict_result(strs, codes: torch.Tensor, validity, dtype) -> DCol:
    """Strings (None for NULL) indexed by ``codes`` as a DICT column over
    their sorted distinct values; NULL where the row's string is None."""
    null = np.array([s is None for s in strs], dtype=bool)
    mapped = np.array(["" if s is None else s for s in strs], dtype=object)
    uniq, remap = np.unique(mapped.astype(str), return_inverse=True)
    dev = codes.device
    if null.any():
        validity = _and_validity(validity,
                                 ~torch.from_numpy(null).to(dev)[codes])
    if len(uniq) == len(strs) and (remap == np.arange(len(strs))).all():
        out = codes.to(torch.int32)
    else:
        out = torch.from_numpy(remap.astype(np.int32)).to(dev)[codes]
    return DCol(dtype, DICT, out, validity=validity,
                dictionary=Dictionary(uniq.astype(object)))


def _host_map(col: DCol, f, out_dtype) -> DCol:
    """``f`` (string → string, or None for NULL) over a string column's
    distinct strings, a DICT column."""
    strs, codes = _host_strings(col)
    return _dict_result([f(s) for s in strs], codes, col.validity, out_dtype)


def _host_scalar(col: DCol, f, out_dtype, np_dtype) -> DCol:
    """``f`` (string → bool or int) over a string column's distinct
    strings, gathered by row."""
    strs, codes = _host_strings(col)
    table = torch.from_numpy(np.array([f(s) for s in strs] or [0],
                                      dtype=np_dtype)).to(codes.device)
    return DCol(out_dtype, PLAIN, table[codes], validity=col.validity)


def _need_bytes(col: DCol, name: str) -> None:
    if col.kind != BYTES:
        raise NotImplementedError(f"{name} of a {col.kind} {col.dtype} "
                                  "column")


def _gather_bytes(v: torch.Tensor, src: torch.Tensor, lens: torch.Tensor,
                  pos: torch.Tensor) -> torch.Tensor:
    """Byte ``src[r, k]`` of each row ``r`` for ``k`` below the row's new
    length ``lens``, zero past it."""
    got = torch.gather(v, 1, src.clamp(0, v.shape[1] - 1))
    return torch.where(pos[None, :] < lens[:, None], got, 0).to(torch.uint8)


def _is_space(v: torch.Tensor) -> torch.Tensor:
    """Bytes Python's ``str.strip`` removes from ASCII text (as Java's
    ``Character.isWhitespace``): tab to carriage return, the four
    separators 28-31, and space."""
    return (v == 32) | ((v >= 9) & (v <= 13)) | ((v >= 28) & (v <= 31))


_STRIP = {"trim": str.strip, "ltrim": str.lstrip, "rtrim": str.rstrip}


def _trim(expr, args) -> DCol:
    (a,) = args
    name = expr.name
    if a.kind == DICT:
        return _host_map(a, _STRIP[name], expr.dtype)
    _need_bytes(a, name)
    v, lens = a.values, a.lengths.to(torch.int64)
    w = v.shape[1]
    pos = torch.arange(w, device=v.device)
    keep = (pos[None, :] < lens[:, None]) & ~_is_space(v)
    some = keep.any(1)
    k8 = keep.to(torch.uint8)
    start = torch.zeros_like(lens) if name == "rtrim" else \
        torch.where(some, k8.argmax(1), lens)
    end = lens if name == "ltrim" else \
        torch.where(some, w - k8.flip(1).argmax(1), 0)
    new = (end - start).clamp_min(0)
    out = _gather_bytes(v, start[:, None] + pos[None, :], new, pos)
    return DCol(expr.dtype, BYTES, out, new.to(torch.int32), a.validity)


def _reverse(expr, args) -> DCol:
    (a,) = args
    if a.kind == DICT:
        return _host_map(a, lambda s: s[::-1], expr.dtype)
    _need_bytes(a, "reverse")
    lens = a.lengths.to(torch.int64)
    pos = torch.arange(a.values.shape[1], device=lens.device)
    out = _gather_bytes(a.values, lens[:, None] - 1 - pos[None, :], lens,
                        pos)
    return DCol(expr.dtype, BYTES, out, a.lengths, a.validity)


def _pad(expr, args) -> DCol:
    """``lpad`` / ``rpad(s, size[, pad])``: ``s`` cut to ``size``, or
    filled to it with ``pad`` repeated (an empty pad leaves ``s`` as it
    is, as in the JAX package)."""
    a = args[0]
    left = expr.name == "lpad"
    size = _lit_int(expr, 1, "length")
    if size < 0:
        raise ValueError(f"{expr.name} target length {size} is negative")
    pad = _lit_str(expr, 2, "pad") if len(expr.args) > 2 else " "
    if a.kind == DICT:
        def host(s):
            if len(s) >= size or not pad:
                return s[:size]
            fill = (pad * size)[:size - len(s)]
            return fill + s if left else s + fill
        return _host_map(a, host, expr.dtype)
    _need_bytes(a, expr.name)
    lens = a.lengths.to(torch.int64)
    kept = lens.clamp(max=size)
    fill = (size - kept) if pad else torch.zeros_like(kept)
    new = kept + fill
    pos = torch.arange(max(size, 1), device=lens.device)[None, :]
    p = torch.tensor(list(pad.encode("ascii")) or [0], dtype=torch.uint8,
                     device=a.values.device)
    if left:
        src, fill_at = pos - fill[:, None], pos % len(p)
        from_pad = pos < fill[:, None]
    else:
        src, fill_at = pos.expand(lens.shape[0], -1), \
            (pos - kept[:, None]) % len(p)
        from_pad = pos >= kept[:, None]
    s = torch.gather(a.values, 1, src.clamp(0, a.values.shape[1] - 1))
    out = torch.where(from_pad, p[fill_at], s)
    out = torch.where(pos < new[:, None], out, 0).to(torch.uint8)
    return DCol(expr.dtype, BYTES, out, new.to(torch.int32), a.validity)


def _starts_ends(expr, args) -> DCol:
    """``starts_with`` / ``ends_with`` a literal: a fixed-width compare of
    the first or last bytes of a BYTES row."""
    a = args[0]
    lit = _lit_str(expr, 1, "prefix")
    start = expr.name == "starts_with"
    if a.kind == DICT:
        f = str.startswith if start else str.endswith
        return DCol(T.BOOLEAN, PLAIN, _dict_predicate(a, lambda s: f(s, lit)),
                    validity=a.validity)
    _need_bytes(a, expr.name)
    n, w = a.values.shape
    k = len(lit)
    lens = a.lengths.to(torch.int64)
    dev = a.values.device
    if k == 0:
        v = torch.ones((n,), dtype=torch.bool, device=dev)
    elif k > w:
        v = torch.zeros((n,), dtype=torch.bool, device=dev)
    else:
        pat = torch.tensor(list(lit.encode("ascii")), dtype=torch.uint8,
                           device=dev)
        if start:
            part = a.values[:, :k]
        else:
            src = (lens - k)[:, None] + torch.arange(k, device=dev)[None, :]
            part = torch.gather(a.values, 1, src.clamp(0, w - 1))
        v = (lens >= k) & (part == pat).all(1)
    return DCol(T.BOOLEAN, PLAIN, v, validity=a.validity)


def _strpos(expr, args) -> DCol:
    """1-based offset of a literal's first occurrence, 0 if none (1 for
    the empty string)."""
    a = args[0]
    sub = _lit_str(expr, 1, "substring")
    if a.kind == DICT:
        return _host_scalar(a, lambda s: s.find(sub) + 1, T.BIGINT, np.int64)
    _need_bytes(a, expr.name)
    return DCol(T.BIGINT, PLAIN, S.strpos(a.values, a.lengths, sub),
                validity=a.validity)


def _codepoint(expr, args) -> DCol:
    """The first character's code (0 for the empty string, as in the JAX
    package)."""
    (a,) = args
    if a.kind == DICT:
        return _host_scalar(a, lambda s: ord(s[0]) if s else 0, T.BIGINT,
                            np.int64)
    _need_bytes(a, "codepoint")
    v = torch.where(a.lengths > 0, a.values[:, 0].to(torch.int64), 0)
    return DCol(T.BIGINT, PLAIN, v, validity=a.validity)


def _chr(expr, args) -> DCol:
    """A one-byte string of the code's low byte (the JAX package's
    ``uint8`` conversion)."""
    (a,) = args
    v = (a.values.to(torch.int64) & 0xFF).to(torch.uint8)[:, None]
    return DCol(expr.dtype, BYTES, v, torch.ones(
        (v.shape[0],), dtype=torch.int32, device=v.device), a.validity)


def _translate_table(frm: str, to: str) -> dict:
    """Trino's ``translate``: the first occurrence of a character in
    ``frm`` decides it; one past the end of ``to`` is deleted."""
    table: dict = {}
    for i, c in enumerate(frm):
        table.setdefault(ord(c), to[i] if i < len(to) else None)
    return table


def _split_part(s: str, delim: str, idx: int) -> Optional[str]:
    parts = s.split(delim)
    return parts[idx - 1] if idx <= len(parts) else None


def _json_scalar(s: str, steps) -> Optional[str]:
    """The scalar at a JSONPath, or None (NULL) where the path is
    missing, JSON null, an object or an array, or the text is no JSON."""
    try:
        v = json.loads(s)
        for st in steps:
            v = v[int(st)] if isinstance(v, list) else v[st]
    except (ValueError, KeyError, IndexError, TypeError):
        return None
    if v is None or isinstance(v, (dict, list)):
        return None
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


def _url_part(part: str):
    def run(s: str) -> str:
        u = urlsplit(s)
        return {"protocol": u.scheme, "host": u.hostname or "",
                "path": u.path, "query": u.query}[part]
    return run


def _url_port(s: str) -> int:
    try:
        p = urlsplit(s).port
    except ValueError:
        return -1
    return -1 if p is None else p


def _host_string_fn(expr: ir.Func):
    """The host function of a string → string scalar, its literal
    arguments bound."""
    name = expr.name
    if name == "replace":
        frm = _lit_str(expr, 1, "search")
        to = _lit_str(expr, 2, "replacement") if len(expr.args) > 2 else ""
        return lambda s: s.replace(frm, to)
    if name == "translate":
        table = _translate_table(_lit_str(expr, 1, "from"),
                                 _lit_str(expr, 2, "to"))
        return lambda s: s.translate(table)
    if name == "split_part":
        delim = _lit_str(expr, 1, "delimiter")
        idx = _lit_int(expr, 2, "index")
        if idx <= 0:
            raise ValueError(f"split_part index {idx} must be greater "
                             "than zero")
        return lambda s: _split_part(s, delim, idx)
    if name == "regexp_extract":
        pat = re.compile(_lit_str(expr, 1, "pattern"))
        g = _lit_int(expr, 2, "group") if len(expr.args) > 2 else 0

        def extract(s):
            m = pat.search(s)
            return None if m is None else m.group(g)
        return extract
    if name == "regexp_replace":
        pat = re.compile(_lit_str(expr, 1, "pattern"))
        repl = _lit_str(expr, 2, "replacement") if len(expr.args) > 2 else ""
        repl = re.sub(r"\$(\d+)", r"\\\1", repl)  # SQL's $1 → Python's \1
        return lambda s: pat.sub(repl, s)
    if name == "json_extract_scalar":
        path = _lit_str(expr, 1, "path")
        if not path.startswith("$"):
            raise ValueError(f"JSONPath {path!r} must start with $")
        steps = [p for p in re.split(r"\.|\[|\]", path[1:]) if p]
        return lambda s: _json_scalar(s, steps)
    if name.startswith("url_extract_"):
        return _url_part(name[len("url_extract_"):])
    return _HOST_STRING[name]


_HOST_STRING = {
    "to_hex": lambda s: s.encode("ascii", "replace").hex().upper(),
    "from_hex": lambda s: bytes.fromhex(s).decode("ascii", "replace"),
    "to_base64": lambda s: base64.b64encode(
        s.encode("ascii", "replace")).decode(),
    "from_base64": lambda s: base64.b64decode(s).decode("ascii", "replace"),
    "url_encode": quote_plus, "url_decode": unquote_plus,
    "normalize_space": lambda s: " ".join(s.split())}


def _host_string(expr, args) -> DCol:
    return _host_map(args[0], _host_string_fn(expr), expr.dtype)


def _regexp_like(expr, args) -> DCol:
    pat = re.compile(_lit_str(expr, 1, "pattern"))
    return _host_scalar(args[0], lambda s: pat.search(s) is not None,
                        T.BOOLEAN, np.bool_)


def _url_extract_port(expr, args) -> DCol:
    out = _host_scalar(args[0], _url_port, T.BIGINT, np.int64)
    return DCol(T.BIGINT, PLAIN, out.values,
                validity=_and_validity(out.validity, out.values >= 0))


def _row_values(col: DCol) -> list:
    """Each row's Python value: strings, ints, floats, a decimal's value
    as a float, a date as ``datetime.date`` (the JAX package's
    ``_col_py_values``)."""
    if col.kind != PLAIN:
        strs, codes = _host_strings(col)
        with host_read():
            codes = codes.tolist()
        return [strs[c] for c in codes]
    if _is_i128(col):
        raise NotImplementedError(f"a {col.dtype} value as text")
    with host_read():
        vals = col.values.cpu().tolist()
    s = _scale_of(col.dtype)
    if T.is_decimal(col.dtype) and s:
        return [v / 10 ** s for v in vals]
    if isinstance(col.dtype, T.DateType):
        return [dt.date(1970, 1, 1) + dt.timedelta(days=v) for v in vals]
    return vals


def _rows_result(strs, validity, dtype, dev) -> DCol:
    return _dict_result(strs, torch.arange(len(strs), dtype=torch.int64,
                                           device=dev), validity, dtype)


def _concat_ws(expr, args) -> DCol:
    """``concat_ws(sep, x...)``: the non-NULL arguments joined, as Trino
    skips NULLs (the JAX package makes the row NULL)."""
    sep = _lit_str(expr, 0, "separator")
    n = args[0].n_rows
    vals = [_row_values(c) for c in args[1:]]
    oks = []
    for c in args[1:]:
        with host_read():
            oks.append(c.valid_or_true().cpu().tolist())
    strs = [sep.join(str(v) for v, ok in zip(row, okr) if ok)
            for row, okr in zip(zip(*vals), zip(*oks))] if vals else [""] * n
    return _rows_result(strs, None, expr.dtype, args[0].values.device)


def _format(expr, args) -> DCol:
    """``format(fmt, x...)`` through Python's ``%`` (the JAX package's
    subset of Java's ``String.format``); NULL where an argument is."""
    fmt = _lit_str(expr, 0, "format")
    vals = [_row_values(a) for a in args[1:]]
    strs = [fmt % r for r in zip(*vals)] if vals else [fmt] * args[0].n_rows
    return _rows_result(strs,
                        _and_validity(*(a.validity for a in args[1:])),
                        expr.dtype, args[0].values.device)


def _levenshtein(a: str, b: str) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def _distance(expr, args) -> DCol:
    """``levenshtein_distance`` and ``hamming_distance`` row by row on
    the host; a Hamming distance of unequal lengths is NULL (the JAX
    package's rule; Trino fails)."""
    a, b = args
    pairs = list(zip(_row_values(a), _row_values(b)))
    dev = a.values.device
    valid = _and_validity(a.validity, b.validity)
    if expr.name == "hamming_distance":
        same = [len(x) == len(y) for x, y in pairs]
        out = [sum(p != q for p, q in zip(x, y)) if ok else 0
               for (x, y), ok in zip(pairs, same)]
        valid = _and_validity(valid, torch.tensor(same, dtype=torch.bool,
                                                  device=dev))
    else:
        out = [_levenshtein(x, y) for x, y in pairs]
    return DCol(T.BIGINT, PLAIN, torch.tensor(out, dtype=torch.int64,
                                              device=dev), validity=valid)


# ------------------------------------------------ row-numbering functions

ROW_NUMBERING = ("unique_id", "uuid")


def refuse_row_numbering(exprs, where: str) -> None:
    """Raise ``NotImplementedError`` when one of ``exprs`` calls a
    row-numbering function: evaluated over each of several chunks (the
    slices of a streamed scan, the partitions of an operator), it would
    number every chunk's rows from 0 again."""
    for x in exprs:
        for e in ir.walk(x):
            if isinstance(e, ir.Func) and e.name in ROW_NUMBERING:
                raise NotImplementedError(f"{e.name}() under {where}")


def _unique_id(expr, chunk: Chunk) -> DCol:
    """An int64 unique across the chunk's rows: the row ordinal, as the
    JAX package numbers each chunk (its shard in the high bits)."""
    return DCol(T.BIGINT, PLAIN, torch.arange(
        chunk.n_rows, dtype=torch.int64, device=chunk.mask.device))


def _uuid(expr, chunk: Chunk) -> DCol:
    """A version-4-shaped UUID string per row from the JAX package's
    deterministic splitmix64 stream over the row ordinal (the same
    strings as the JAX package); a DICT column of the host-formatted
    strings."""
    from ..tpcds.generator import _mix
    rows = np.arange(chunk.n_rows, dtype=np.uint64)
    strs = []
    for h, l in zip(_mix(rows, 0x75756964).tolist(),
                    _mix(rows, 0x75756932).tolist()):
        x = f"{h:016x}{l:016x}"
        strs.append(f"{x[:8]}-{x[8:12]}-4{x[13:16]}-a{x[17:20]}-{x[20:32]}")
    uniq, codes = np.unique(np.array(strs, dtype=str), return_inverse=True)
    return DCol(expr.dtype, DICT,
                torch.from_numpy(codes.astype(np.int32)).to(chunk.mask.device),
                dictionary=Dictionary(uniq.astype(object)))


# ---------------------------------------------------------------- nested values
#
# ARRAY and MAP columns (``columns.py``): string elements are codes into
# the column's dictionary, and every comparison or ordering between
# string elements goes through their strings: two operands over
# different dictionaries are recoded into the sorted union of both, and
# an order is the strings' order (the JAX package compares and sorts the
# codes of different dictionaries).  Per-row work is ``ops/arrays.py``
# over the elements' int64 keys (``_elem_keys``).

def _strs(d: Optional[Dictionary]) -> list:
    return [] if d is None else [str(s) for s in d.strings]


def _union(*parts: list) -> Tuple[np.ndarray, list]:
    """The sorted distinct strings of ``parts`` and, for each part, the
    position of each of its strings there."""
    union = np.unique(np.array([s for p in parts for s in p], dtype=str))
    return union, [np.searchsorted(union, np.array(p, dtype=str)).astype(
        np.int64) for p in parts]


def _table(a: np.ndarray, dev) -> torch.Tensor:
    """A host lookup table on ``dev`` (one 0 entry when empty, so that a
    gather of padding codes stays in range)."""
    return torch.from_numpy(a if a.shape[0] else np.zeros(1, a.dtype)).to(dev)


def _string_arg(expr: ir.Func, i: int, col: DCol):
    """(distinct strings, each row's index among them) of string argument
    ``i``; a literal is one string, not a broadcast byte matrix."""
    a = expr.args[i]
    if isinstance(a, ir.Literal) and isinstance(a.value, str):
        return [a.value], torch.zeros((col.n_rows,), dtype=torch.int64,
                                      device=col.values.device)
    return _host_strings(col)


def _elem_keys(values: torch.Tensor, d: Optional[Dictionary],
               et: T.DataType) -> torch.Tensor:
    """int64 keys of ``[N, W]`` elements by value: a string's position
    among its dictionary's sorted distinct strings, a DOUBLE's
    order-preserving bits, else the value."""
    if T.is_string(et):
        _, (rank,) = _union(_strs(d))
        return _table(rank, values.device)[values.to(torch.int64)]
    if values.is_floating_point():
        return SORT.f64_sort_key(values.contiguous())
    return values.to(torch.int64)


def _numeric_keys(va: torch.Tensor, ta: T.DataType, vb: torch.Tensor,
                  tb: T.DataType):
    """Two numeric operands' values as comparable int64 keys: DOUBLE
    against anything in float64 bits, else at the larger decimal scale."""
    if isinstance(ta, T.DoubleType) or isinstance(tb, T.DoubleType):
        def f(v, t):
            s = _scale_of(t)
            v = v.to(torch.float64)
            return SORT.f64_sort_key((v / float(10 ** s) if s else v)
                                     .contiguous())
        return f(va, ta), f(vb, tb)
    s = max(_scale_of(ta), _scale_of(tb))
    return (D.rescale(va.to(torch.int64), _scale_of(ta), s),
            D.rescale(vb.to(torch.int64), _scale_of(tb), s))


def _probe_keys(expr: ir.Func, values: torch.Tensor, d, et: T.DataType,
                x: DCol):
    """(keys [N, W] of ``values``, keys [N] of argument 1) comparable by
    value: strings as positions in the sorted union of both sides'
    strings, numbers as ``_numeric_keys``."""
    if T.is_string(et):
        xs, xc = _string_arg(expr, 1, x)
        _, (ra, rx) = _union(_strs(d), xs)
        dev = values.device
        return _table(ra, dev)[values.to(torch.int64)], _table(rx, dev)[xc]
    if x.kind != PLAIN or _is_i128(x):
        raise NotImplementedError(f"{expr.name} of a {x.kind} {x.dtype}")
    ka, kx = _numeric_keys(values, et, x.values[:, None], x.dtype)
    return ka, kx[:, 0]


def _pair(a: DCol, b: DCol):
    """Two ARRAY operands as (keys of a, keys of b, a's values, b's
    values as a's element type, their dictionary): string elements
    recoded into the sorted union of both dictionaries (its positions are
    both the keys and the new codes), numbers compared at a common
    scale."""
    ea, eb = a.dtype.element, b.dtype.element
    dev = a.values.device
    if T.is_string(ea) or T.is_string(eb):
        union, (ra, rb) = _union(_strs(a.dictionary), _strs(b.dictionary))
        ka = _table(ra, dev)[a.values.to(torch.int64)]
        kb = _table(rb, dev)[b.values.to(torch.int64)]
        return ka, kb, ka.to(torch.int32), kb.to(torch.int32), \
            Dictionary(union.astype(object))
    ka, kb = _numeric_keys(a.values, ea, b.values, eb)
    return ka, kb, a.values, _cast_elements(b.values, eb, ea), None


def _array(dtype, values, lengths, validity, d=None) -> DCol:
    return DCol(dtype, ARRAY, values, lengths.to(torch.int32), validity, d)


def _element(dtype, values, validity, d) -> DCol:
    """One element per row as a scalar column (DICT over ``d`` for a
    string element)."""
    if T.is_string(dtype):
        return DCol(dtype, DICT, values.to(torch.int32), validity=validity,
                    dictionary=d or Dictionary(np.array([""], dtype=object)))
    return DCol(dtype, PLAIN, values, validity=validity)


def _need_nested(expr, a: DCol, kinds=(ARRAY, MAP)) -> None:
    if a.kind not in kinds:
        raise NotImplementedError(f"{expr.name} of a {a.kind} {a.dtype}")


def _array_pack(expr, args) -> DCol:
    """``ARRAY[e1, ...]``: the arguments side by side; string elements
    coded over the sorted union of the arguments' strings, numbers at the
    element type's scale (int64, a long-decimal type's too).  A row with
    a NULL argument is a NULL array, as in the JAX package."""
    et = expr.dtype.element
    dev, n = args[0].values.device, args[0].n_rows
    validity = _and_validity(*(a.validity for a in args))
    if T.is_string(et):
        parts = [_string_arg(expr, i, a) for i, a in enumerate(args)]
        union, ranks = _union(*(p[0] for p in parts))
        cols = [_table(r, dev)[c].to(torch.int32)
                for r, (_, c) in zip(ranks, parts)]
        return _array(expr.dtype, torch.stack(cols, 1),
                      torch.full((n,), len(args), device=dev), validity,
                      Dictionary(union.astype(object)))
    cols = []
    for a in args:
        if a.kind != PLAIN or _is_i128(a):
            raise NotImplementedError(f"ARRAY of {a.kind} {a.dtype}")
        if isinstance(et, T.DoubleType):
            cols.append(as_double(a))
        elif T.is_decimal(et):
            cols.append(D.rescale(a.values.to(torch.int64),
                                  _scale_of(a.dtype), _scale_of(et)))
        else:
            cols.append(a.values.to(_torch_dtype(et)))
    return _array(expr.dtype, torch.stack(cols, 1),
                  torch.full((n,), len(args), device=dev), validity)


def _torch_dtype(t: T.DataType) -> torch.dtype:
    """The tensor dtype of a scalar type's values (a string: its codes)."""
    if T.is_string(t):
        return torch.int32
    return {np.int64: torch.int64, np.int32: torch.int32,
            np.bool_: torch.bool, np.float64: torch.float64}[t.np_dtype]


def _map_pack(expr, args) -> DCol:
    """``MAP(ARRAY[k...], ARRAY[v...])``: keys and values padded to one
    width, each over its own dictionary."""
    k, v = args
    _need_nested(expr, k, (ARRAY,))
    _need_nested(expr, v, (ARRAY,))
    w = max(k.values.shape[1], v.values.shape[1])
    return DCol(expr.dtype, MAP, AR.pad_width(k.values, w),
                torch.minimum(k.lengths, v.lengths).to(torch.int32),
                _and_validity(k.validity, v.validity), k.dictionary,
                AR.pad_width(v.values, w), v.dictionary)


def _sequence(expr, args) -> DCol:
    """``sequence(lo, hi[, step])`` of integer literals."""
    lo, hi = _lit_int(expr, 0, "bound"), _lit_int(expr, 1, "bound")
    step = _lit_int(expr, 2, "step") if len(expr.args) > 2 else 1
    if step == 0:
        raise ValueError("sequence step must not be 0")
    w = max((hi - lo) // step + 1, 0)
    n = args[0].n_rows
    dev = args[0].values.device
    row = lo + torch.arange(w, dtype=torch.int64, device=dev) * step
    return _array(expr.dtype, row[None, :].expand(n, w).contiguous(),
                  torch.full((n,), w, device=dev), None)


def _cardinality(expr, args) -> DCol:
    a = args[0]
    _need_nested(expr, a)
    return DCol(T.BIGINT, PLAIN, a.lengths.to(torch.int64),
                validity=a.validity)


def _element_at(expr, args) -> DCol:
    """``element_at(array, i)`` and ``array[i]``: 1-based, a negative
    ``i`` from the end; NULL outside the array."""
    a, idx = args
    _need_nested(expr, a, (ARRAY,))
    i = idx.values.to(torch.int64)
    ln = a.lengths.to(torch.int64)
    pos = torch.where(i > 0, i - 1, ln + i)
    ok = (pos >= 0) & (pos < ln)
    v = AR.take_rows(a.values, pos[:, None])[:, 0]
    return _element(expr.dtype, v, _and_validity(a.validity, idx.validity,
                                                 ok), a.dictionary)


def _map_element_at(expr, args) -> DCol:
    """``element_at(map, key)`` and ``map[key]``: the value at the first
    key equal to the probe by value (a string key through the strings of
    both sides), NULL when none is."""
    m, x = args
    _need_nested(expr, m, (MAP,))
    kk, kx = _probe_keys(expr, m.values, m.dictionary, m.dtype.key, x)
    eq = (kk == kx[:, None]) & AR.pos_grid(m.values.shape[1], m.lengths)
    found = eq.any(1)
    pos = eq.to(torch.int8).argmax(1) if eq.shape[1] else \
        torch.zeros((m.n_rows,), dtype=torch.int64, device=eq.device)
    v = AR.take_rows(m.values2, pos[:, None])[:, 0]
    return _element(expr.dtype, v, _and_validity(m.validity, x.validity,
                                                 found), m.dictionary2)


def _contains_position(expr, args) -> DCol:
    """``contains(array, x)`` and ``array_position(array, x)`` (1-based,
    0 when absent), by value."""
    a, x = args
    _need_nested(expr, a, (ARRAY,))
    ka, kx = _probe_keys(expr, a.values, a.dictionary, a.dtype.element, x)
    eq = (ka == kx[:, None]) & AR.pos_grid(a.values.shape[1], a.lengths)
    valid = _and_validity(a.validity, x.validity)
    if expr.name == "contains":
        return DCol(T.BOOLEAN, PLAIN, eq.any(1), validity=valid)
    pos = torch.where(eq.any(1), eq.to(torch.int8).argmax(1) + 1, 0) \
        if eq.shape[1] else torch.zeros((a.n_rows,), dtype=torch.int64,
                                        device=eq.device)
    return DCol(T.BIGINT, PLAIN, pos.to(torch.int64), validity=valid)


def _array_min_max(expr, args) -> DCol:
    """The least (greatest) element by value, a string by its string
    (the JAX package returns a string element's least code); NULL for an
    empty array."""
    a = args[0]
    _need_nested(expr, a, (ARRAY,))
    k = _elem_keys(a.values, a.dictionary, a.dtype.element)
    pos = AR.extreme_pos(k, a.lengths, expr.name == "array_max")
    v = AR.take_rows(a.values, pos[:, None])[:, 0]
    return _element(expr.dtype, v, _and_validity(a.validity, a.lengths > 0),
                    a.dictionary)


def _reorder(a: DCol, pos: torch.Tensor, lengths, dtype=None) -> DCol:
    return _array(dtype or a.dtype, AR.take_rows(a.values, pos), lengths,
                  a.validity, a.dictionary)


def _array_sort(expr, args) -> DCol:
    """Each row's elements in ascending order of value (strings by
    string; the JAX package sorts a string array's codes)."""
    a = args[0]
    _need_nested(expr, a, (ARRAY,))
    k = _elem_keys(a.values, a.dictionary, a.dtype.element)
    return _reorder(a, AR.sort_order(k, a.lengths), a.lengths)


def _array_distinct(expr, args) -> DCol:
    """Each row's distinct elements, the first occurrence of each in
    order (Trino; the JAX package returns them sorted)."""
    a = args[0]
    _need_nested(expr, a, (ARRAY,))
    pos, ln = AR.distinct_order(
        _elem_keys(a.values, a.dictionary, a.dtype.element), a.lengths)
    return _reorder(a, pos, ln)


def _map_keys_values(expr, args) -> DCol:
    m = args[0]
    _need_nested(expr, m, (MAP,))
    if expr.name == "map_keys":
        return _array(expr.dtype, m.values, m.lengths, m.validity,
                      m.dictionary)
    return _array(expr.dtype, m.values2, m.lengths, m.validity,
                  m.dictionary2)


def _slice(expr, args) -> DCol:
    """``slice(array, start, length)`` with literal bounds; a negative
    start (from the end) raises, as the JAX package refuses it."""
    a = args[0]
    _need_nested(expr, a, (ARRAY,))
    start = _lit_int(expr, 1, "start")
    ln = max(_lit_int(expr, 2, "length"), 0)
    if start < 0:
        raise NotImplementedError("slice with a negative start")
    if start == 0:
        raise ValueError("SQL array indices start at 1")
    vals = a.values[:, start - 1:start - 1 + ln]
    lengths = (a.lengths.to(torch.int64) - (start - 1)).clamp(0, ln)
    return _array(expr.dtype, vals, lengths, a.validity, a.dictionary)


def _repeat(expr, args) -> DCol:
    """``repeat(x, k)``, ``k`` a literal: ``k`` copies of x."""
    x = args[0]
    k = max(_lit_int(expr, 1, "count"), 0)
    n, dev = x.n_rows, x.values.device
    if T.is_string(x.dtype):
        strs, codes = _string_arg(expr, 0, x)
        union, (rank,) = _union(strs)
        v, d = _table(rank, dev)[codes].to(torch.int32), \
            Dictionary(union.astype(object))
    elif x.kind == PLAIN and not _is_i128(x):
        v, d = x.values, None
    else:
        raise NotImplementedError(f"repeat of a {x.kind} {x.dtype}")
    return _array(expr.dtype, v[:, None].expand(n, k).contiguous(),
                  torch.full((n,), k, device=dev), x.validity, d)


def _distinct_arrays(a: DCol):
    """(the distinct arrays of ``a``'s rows as host lists of Python
    values, each row's index among them): one ``torch.unique`` over the
    rows, padding zeroed, then only the distinct rows decoded."""
    v = AR.zero_padding(a.values, a.lengths)
    bits = v.contiguous().view(torch.int64) \
        if v.dtype == torch.float64 else v.to(torch.int64)
    rows = torch.cat([a.lengths.to(torch.int64)[:, None], bits], 1)
    if rows.shape[0] == 0:
        return [], torch.zeros((0,), dtype=torch.int64, device=v.device)
    uniq, inv = torch.unique(rows, dim=0, return_inverse=True)
    with host_read():
        host = uniq.cpu().numpy()
    et = a.dtype.element
    strs = np.array(_strs(a.dictionary), dtype=object)
    out = []
    for row in host:
        e = row[1:1 + row[0]]
        if T.is_string(et):
            out.append(strs[e].tolist())
        elif v.dtype == torch.float64:
            out.append(e.view(np.float64).tolist())
        elif v.dtype == torch.bool:
            out.append([bool(x) for x in e])
        else:
            out.append(e.tolist())
    return out, inv


def _array_join(expr, args) -> DCol:
    """``array_join(array, sep)``: the elements' text joined (decimals as
    their value, as in the JAX package), over the distinct arrays."""
    a = args[0]
    _need_nested(expr, a, (ARRAY,))
    sep = _lit_str(expr, 1, "separator")
    rows, inv = _distinct_arrays(a)
    s = _scale_of(a.dtype.element)
    strs = [sep.join(str(e / 10 ** s if s else e) for e in r) for r in rows]
    return _dict_result(strs, inv, a.validity, expr.dtype)


def _arrays_overlap(expr, args) -> DCol:
    a, b = args
    _need_nested(expr, a, (ARRAY,))
    _need_nested(expr, b, (ARRAY,))
    ka, kb, *_ = _pair(a, b)
    _, member = AR.member_mask(ka, a.lengths, kb, b.lengths)
    return DCol(T.BOOLEAN, PLAIN, member.any(1),
                validity=_and_validity(a.validity, b.validity))


def _array_set_op(expr, args) -> DCol:
    """``array_except``/``array_intersect``: a's distinct elements not in
    (in) b, in a's order; ``array_union``: a's distinct elements, then
    b's not in a.  Elements compare by value: strings through the union
    of both dictionaries (the JAX package compares their codes)."""
    a, b = args
    _need_nested(expr, a, (ARRAY,))
    _need_nested(expr, b, (ARRAY,))
    ka, kb, va, vb, d = _pair(a, b)
    ina, in_b = AR.member_mask(ka, a.lengths, kb, b.lengths)
    first = AR.first_occurrence(ka, ina)
    valid = _and_validity(a.validity, b.validity)
    if expr.name != "array_union":
        keep = first & (in_b if expr.name == "array_intersect" else ~in_b)
        pos, ln = AR.compact_order(keep)
        return _array(expr.dtype, AR.take_rows(va, pos), ln, valid, d)
    inb_w, b_in_a = AR.member_mask(kb, b.lengths, ka, a.lengths)
    keep = torch.cat([first, AR.first_occurrence(kb, inb_w) & ~b_in_a], 1)
    pos, ln = AR.compact_order(keep)
    return _array(expr.dtype, AR.take_rows(torch.cat([va, vb], 1), pos), ln,
                  valid, d)


def _split(expr, args) -> DCol:
    """``split(s, delim)``, a literal delimiter.  A byte-matrix column split
    on a one-byte delimiter is cut on the device and its words interned
    by one ``torch.unique`` (only the distinct words go to the host);
    otherwise each distinct string is split on the host.  The parts are
    codes over their distinct values."""
    if len(args) != 2:
        raise NotImplementedError("split with a limit")
    delim = _lit_str(expr, 1, "delimiter")
    if not delim:
        raise NotImplementedError("split on an empty delimiter")
    a = args[0]
    if a.kind == BYTES and len(delim) == 1 and a.values.shape[1]:
        return _split_bytes(expr, a, ord(delim))
    strs, codes = _host_strings(a)
    parts = [s.split(delim) for s in strs]
    union = sorted({p for ps in parts for p in ps})
    code_of = {p: i for i, p in enumerate(union)}
    lens = np.array([len(ps) for ps in parts], np.int64)
    w = int(lens.max()) if lens.shape[0] else 0
    table = np.zeros((max(len(parts), 1), w), np.int32)
    flat = np.array([code_of[p] for ps in parts for p in ps], np.int32)
    rows = np.repeat(np.arange(len(parts)), lens)
    table[rows, np.arange(flat.shape[0]) - np.repeat(
        np.cumsum(lens) - lens, lens)] = flat
    dev = codes.device
    return _array(expr.dtype, _table(table, dev)[codes],
                  _table(lens, dev)[codes], a.validity,
                  Dictionary(np.array(union, dtype=object)))


def _split_bytes(expr, a: DCol, delim: int) -> DCol:
    """``split`` of a BYTES column on the byte ``delim``: each row's
    delimiter positions in order (one stable sort of the row), each
    word's (row, ordinal, start, length), the words' byte packs made
    distinct by ``torch.unique`` (their codes), and the rows' codes
    scattered into ``[N, most words]``.  Three host reads of sizes and
    one of the distinct words."""
    v, ln = a.values, a.lengths.to(torch.int64)
    n, w = v.shape
    dev = v.device
    isd = (v == delim) & AR.pos_grid(w, ln)
    nd = isd.sum(1)
    nwords = nd + 1
    dpos = torch.sort((~isd).to(torch.int8), dim=1, stable=True).indices
    total, most = 0, 0
    if n:
        with host_read():
            total, most = torch.stack([nwords.sum(), nwords.max()]).tolist()
    row = torch.repeat_interleave(torch.arange(n, device=dev), nwords,
                                  output_size=total)
    k = torch.arange(total, device=dev) - (torch.cumsum(nwords, 0)
                                           - nwords)[row]
    start = torch.where(k == 0, 0, dpos[row, (k - 1).clamp(0, w - 1)] + 1)
    end = torch.where(k == nd[row], ln[row], dpos[row, k.clamp(0, w - 1)])
    wlen = end - start
    wmax = 1
    if total:
        with host_read():
            wmax = max(int(wlen.max()), 1)
    j = torch.arange(wmax, device=dev)
    mat = torch.where(j[None, :] < wlen[:, None],
                      v[row[:, None], (start[:, None] + j).clamp(max=w - 1)],
                      0)
    key = torch.stack(SORT.bytes_sort_keys(mat, wlen) + [wlen], 1)
    uniq, inv = torch.unique(key, dim=0, return_inverse=True)
    with host_read():
        host = uniq.cpu().numpy()
    words = [host[i, :-1].astype(">i8").tobytes()[:host[i, -1]].decode(
        "ascii") for i in range(host.shape[0])]
    out = torch.zeros((n * most,), dtype=torch.int32, device=dev)
    out[row * most + k] = inv.to(torch.int32)
    return _array(expr.dtype, out.reshape(n, most), nwords, a.validity,
                  Dictionary(np.array(words, dtype=object)))


def _nested_null(t: T.DataType, n: int, dev) -> DCol:
    """A NULL ARRAY or MAP of ``n`` rows: zero-width, no valid row."""
    key = t.element if isinstance(t, T.ArrayType) else t.key
    z = torch.zeros((n, 0), dtype=_torch_dtype(key), device=dev)
    never = torch.zeros((n,), dtype=torch.bool, device=dev)
    if isinstance(t, T.ArrayType):
        return _array(t, z, torch.zeros((n,), device=dev), never)
    return DCol(t, MAP, z, torch.zeros((n,), dtype=torch.int32, device=dev),
                never, None, torch.zeros((n, 0), dtype=_torch_dtype(t.value),
                                         device=dev))


def _cast_elements(values: torch.Tensor, frm: T.DataType, to: T.DataType):
    """Nested elements from type ``frm`` to ``to``: strings keep their
    codes, numbers convert as scalars do."""
    if frm == to or (T.is_string(frm) and T.is_string(to)):
        return values
    if T.is_decimal(frm) and T.is_decimal(to):  # elements are int64
        return D.rescale(values.to(torch.int64), frm.scale, to.scale)
    if T.is_string(frm) or T.is_string(to) or T.is_long_decimal(to):
        raise NotImplementedError(f"cast of elements {frm} -> {to}")
    c = _cast(DCol(frm, PLAIN, values.reshape(-1)), to).values
    return c.reshape(values.shape)


def _cast_nested(col: DCol, to: T.DataType) -> DCol:
    if col.kind == ARRAY and isinstance(to, T.ArrayType):
        return _array(to, _cast_elements(col.values, col.dtype.element,
                                         to.element), col.lengths,
                      col.validity, col.dictionary)
    if col.kind == MAP and isinstance(to, T.MapType):
        return DCol(to, MAP, _cast_elements(col.values, col.dtype.key,
                                            to.key), col.lengths,
                    col.validity, col.dictionary,
                    _cast_elements(col.values2, col.dtype.value, to.value),
                    col.dictionary2)
    raise NotImplementedError(f"cast {col.dtype} -> {to}")


def nested_layouts(cols, rt: T.DataType):
    """ARRAY or MAP columns of type ``rt`` on one layout: (values,
    values2 or None, dictionary, dictionary2), the values padded to the
    widest column and their string elements recoded into the sorted union
    of the columns' dictionaries (keys and map values apart)."""
    cols = [c if c.dtype == rt else _cast_nested(c, rt) for c in cols]
    is_map = isinstance(rt, T.MapType)
    w = max(c.values.shape[1] for c in cols)
    dev = cols[0].values.device

    def unify(get_v, get_d, et):
        if not T.is_string(et):
            dt = _torch_dtype(et)
            return [AR.pad_width(get_v(c).to(dt), w) for c in cols], None
        union, ranks = _union(*(_strs(get_d(c)) for c in cols))
        return [AR.pad_width(_table(r, dev)[get_v(c).to(torch.int64)].to(
            torch.int32), w) for r, c in zip(ranks, cols)], \
            Dictionary(union.astype(object))

    vals, d = unify(lambda c: c.values, lambda c: c.dictionary,
                    rt.key if is_map else rt.element)
    if not is_map:
        return vals, None, d, None
    vals2, d2 = unify(lambda c: c.values2, lambda c: c.dictionary2, rt.value)
    return vals, vals2, d, d2


def _eval_case_nested(expr: ir.Case, chunk: Chunk) -> DCol:
    """Searched CASE with an ARRAY or MAP result: the branches on one
    layout (``nested_layouts``), merged row by row (values, lengths,
    validity together)."""
    rt = expr.dtype
    branches = [(eval_predicate(c, chunk), eval_expr(v, chunk))
                for c, v in expr.whens]
    default = (eval_expr(expr.default, chunk) if expr.default is not None
               else _nested_null(rt, chunk.n_rows, chunk.mask.device))
    cols = [default] + [b for _, b in branches]
    vals, vals2, d, d2 = nested_layouts(cols, rt)
    out, out2 = vals[0], None if vals2 is None else vals2[0]
    ln, valid = default.lengths, default.valid_or_true()
    for i in range(len(branches), 0, -1):  # the first true WHEN wins
        cm, c = branches[i - 1][0], cols[i]
        out = torch.where(cm[:, None], vals[i], out)
        if out2 is not None:
            out2 = torch.where(cm[:, None], vals2[i], out2)
        ln = torch.where(cm, c.lengths, ln)
        valid = torch.where(cm, c.valid_or_true(), valid)
    return DCol(rt, MAP if out2 is not None else ARRAY, out,
                ln.to(torch.int32), valid, d, out2, d2)


def _constant(c: float):
    def run(expr, chunk: Chunk) -> DCol:
        return DCol(T.DOUBLE, PLAIN, torch.full(
            (chunk.n_rows,), c, dtype=torch.float64, device=chunk.mask.device))
    return run


_FUNCS = {"abs": _abs, "round": _round, "coalesce": _coalesce,
          "upper": _upper_lower, "lower": _upper_lower, "length": _length,
          "concat": _concat, "mod": _mod,
          "greatest": _greatest_least, "least": _greatest_least,
          "sqrt": _sqrt, "cbrt": _double_fn(cbrt),
          "exp": _double_fn(torch.exp), "sin": _double_fn(torch.sin),
          "cos": _double_fn(torch.cos), "tan": _double_fn(torch.tan),
          "asin": _double_fn(torch.asin), "acos": _double_fn(torch.acos),
          "atan": _double_fn(torch.atan), "sinh": _double_fn(torch.sinh),
          "cosh": _double_fn(torch.cosh), "tanh": _double_fn(torch.tanh),
          "degrees": _double_fn(torch.rad2deg),
          "radians": _double_fn(torch.deg2rad),
          "truncate": _double_fn(torch.trunc),
          "ln": _log, "log10": _log, "log2": _log, "log": _log,
          "power": _double_fn2(torch.pow), "pow": _double_fn2(torch.pow),
          "atan2": _double_fn2(torch.atan2),
          "ceil": _ceil_floor, "ceiling": _ceil_floor, "floor": _ceil_floor,
          "sign": _sign, "width_bucket": _width_bucket,
          "is_nan": _double_fn(torch.isnan, T.BOOLEAN),
          "is_finite": _double_fn(torch.isfinite, T.BOOLEAN),
          "is_infinite": _double_fn(torch.isinf, T.BOOLEAN),
          "bitwise_and": _bitwise2, "bitwise_or": _bitwise2,
          "bitwise_xor": _bitwise2, "bitwise_not": _bitwise_not,
          "bit_count": _bit_count, "bitwise_left_shift": _shift,
          "bitwise_right_shift": _shift,
          "bitwise_right_shift_arithmetic": _shift,
          # dates, times and zones
          "month": _date_field, "day": _date_field, "quarter": _date_field,
          "week": _date_field, "year_of_week": _date_field,
          "yow": _date_field, "day_of_week": _date_field,
          "dow": _date_field, "day_of_year": _date_field,
          "doy": _date_field, "hour": _time_field, "minute": _time_field,
          "second": _time_field, "millisecond": _time_field,
          "last_day_of_month": _last_day_of_month,
          "from_unixtime": _from_unixtime, "to_unixtime": _to_unixtime,
          "at_timezone": _at_timezone, "date_trunc": _date_trunc,
          "date_add": _date_add, "date_diff": _date_diff,
          "date_format": _date_format, "format_datetime": _date_format,
          "date_parse": _date_parse, "parse_datetime": _date_parse,
          # strings
          "trim": _trim, "ltrim": _trim, "rtrim": _trim,
          "reverse": _reverse, "lpad": _pad, "rpad": _pad,
          "starts_with": _starts_ends, "ends_with": _starts_ends,
          "strpos": _strpos, "position": _strpos, "codepoint": _codepoint,
          "chr": _chr, "regexp_like": _regexp_like,
          "url_extract_port": _url_extract_port, "concat_ws": _concat_ws,
          "format": _format, "levenshtein_distance": _distance,
          "hamming_distance": _distance,
          # nested values
          "array_pack": _array_pack, "map_pack": _map_pack,
          "sequence": _sequence, "cardinality": _cardinality,
          "element_at": _element_at, "map_element_at": _map_element_at,
          "contains": _contains_position,
          "array_position": _contains_position,
          "array_min": _array_min_max, "array_max": _array_min_max,
          "array_sort": _array_sort, "array_distinct": _array_distinct,
          "map_keys": _map_keys_values, "map_values": _map_keys_values,
          "slice": _slice, "repeat": _repeat, "array_join": _array_join,
          "arrays_overlap": _arrays_overlap,
          "array_except": _array_set_op, "array_intersect": _array_set_op,
          "array_union": _array_set_op, "split": _split,
          **{name: _host_string for name in (
              "replace", "translate", "split_part", "regexp_extract",
              "regexp_replace", "json_extract_scalar", "to_hex",
              "from_hex", "to_base64", "from_base64", "url_encode",
              "url_decode", "normalize_space", "url_extract_protocol",
              "url_extract_host", "url_extract_path",
              "url_extract_query")}}

# functions of no argument, evaluated over the chunk's rows
_NULLARY = {"unique_id": _unique_id, "uuid": _uuid,
            "pi": _constant(math.pi), "e": _constant(math.e),
            "infinity": _constant(math.inf), "nan": _constant(math.nan)}

def _eval_case(expr: ir.Case, chunk: Chunk) -> DCol:
    """Searched CASE over integer, date, decimal and DOUBLE branches
    (long-decimal results promote every branch to (hi, lo) words; DOUBLE
    results take each branch as float64, decimals divided by their
    scale)."""
    rt = expr.dtype
    dbl = isinstance(rt, T.DoubleType)
    if T.is_string(rt):
        return _eval_case_strings(expr, chunk)
    if isinstance(rt, (T.ArrayType, T.MapType)):
        return _eval_case_nested(expr, chunk)
    if not (T.is_decimal(rt) or T.is_integral(rt) or dbl
            or isinstance(rt, T.DateType)):
        raise NotImplementedError(f"CASE returning {rt}")
    n = chunk.n_rows
    out = None
    valid = None
    taken = torch.zeros((n,), dtype=torch.bool, device=chunk.mask.device)
    rs = _scale_of(rt)
    i128 = T.is_long_decimal(rt)

    def branch_vals(v: DCol):
        if i128:
            return I128.pack(*_col_i128(v, rs))
        return as_double(v) if dbl else v.values

    def branch(e):
        v = eval_expr(e, chunk)
        return v if dbl else _rescale_col(v, rs)

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


def _eval_case_strings(expr: ir.Case, chunk: Chunk) -> DCol:
    """Searched CASE with a string result: every branch as BYTES, padded
    to the widest, chosen row by row."""
    n = chunk.n_rows
    dev = chunk.mask.device
    branches = [(eval_predicate(c, chunk), dcol_to_bytes(eval_expr(v, chunk)))
                for c, v in expr.whens]
    default = (dcol_to_bytes(eval_expr(expr.default, chunk))
               if expr.default is not None else
               _literal(ir.Literal(None, expr.dtype), n, dev))
    w = max(b.values.shape[1] for _, b in branches + [(None, default)])
    vals = _pad_bytes(default.values, w)
    lens = default.lengths
    valid = default.valid_or_true()
    for cm, b in reversed(branches):  # the first true WHEN wins
        vals = torch.where(cm[:, None], _pad_bytes(b.values, w), vals)
        lens = torch.where(cm, b.lengths, lens)
        valid = torch.where(cm, b.valid_or_true(), valid)
    return DCol(expr.dtype, BYTES, vals, lens, valid)


def _host_like(s: str, pattern: str) -> bool:
    """SQL LIKE of one string: '%' matches any run of characters, '_'
    exactly one (Trino's semantics; the JAX package's dictionary LIKE
    matches '_' only as itself)."""
    import re
    rx = "".join(".*" if ch == "%" else "." if ch == "_" else re.escape(ch)
                 for ch in pattern)
    return re.fullmatch(rx, s, re.S) is not None


def as_double(col: DCol) -> torch.Tensor:
    """A numeric column's float64 values: decimals divide out their scale,
    long decimals fold their (hi, lo) words first."""
    if _is_i128(col):
        v = I128.to_f64(*I128.unpack(col.values))
    else:
        v = col.values.to(torch.float64)
    s = _scale_of(col.dtype)
    return v / float(10 ** s) if s else v


def _cast(col: DCol, to: T.DataType) -> DCol:
    """Casts between integer, decimal and DOUBLE types (decimal rescales
    HALF_UP), between string types (the layout kept) and among date and
    timestamp types (``_cast_datetime``)."""
    if col.dtype == to:
        return col
    if col.kind in (ARRAY, MAP):
        return _cast_nested(col, to)
    if T.is_string(to) and T.is_string(col.dtype):
        return DCol(to, col.kind, col.values, col.lengths, col.validity,
                    col.dictionary)
    if _is_datetime(to) and _is_datetime(col.dtype):
        return _cast_datetime(col, to)
    numeric = (T.is_decimal(col.dtype) or T.is_integral(col.dtype)) \
        and col.kind == PLAIN
    if numeric and isinstance(to, T.DoubleType):
        return DCol(to, PLAIN, as_double(col), validity=col.validity)
    if not numeric or not (T.is_decimal(to) or T.is_integral(to)):
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


_FLOAT_OPS = {"+": torch.add, "-": torch.sub, "*": torch.mul}


def _arith(expr: ir.Arith, chunk: Chunk) -> DCol:
    lt, rt = expr.left.dtype, expr.right.dtype
    l = eval_expr(expr.left, chunk)
    r = eval_expr(expr.right, chunk)
    valid = _and_validity(l.validity, r.validity)
    rs = _scale_of(expr.dtype)
    if any(isinstance(x, T.DoubleType) for x in (expr.dtype, lt, rt)):
        # DOUBLE arithmetic in float64 (the decimal path would drop the
        # fraction); x / 0 is NULL, as in the JAX package
        lv, rv = as_double(l), as_double(r)
        if expr.op == "/":
            out = lv / torch.where(rv != 0, rv, 1.0)
            valid = _and_validity(valid, rv != 0)
        elif expr.op in _FLOAT_OPS:
            out = _FLOAT_OPS[expr.op](lv, rv)
        else:
            raise ValueError(expr.op)
        return DCol(T.DOUBLE, PLAIN, out, validity=valid)
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


_FLIP = {"=": "=", "<>": "<>", "<": ">", "<=": ">=", ">": "<", ">=": "<="}


def _compare(expr: ir.Compare, chunk: Chunk) -> DCol:
    left, right, op = expr.left, expr.right, expr.op
    if isinstance(left, ir.Literal) and isinstance(left.value, str):
        left, right, op = right, left, _FLIP[op]
    l = eval_expr(left, chunk)
    if l.kind == DICT and isinstance(right, ir.Literal) \
            and isinstance(right.value, str):
        lit = right.value
        m = _dict_predicate(l, lambda s: _cmp_str(op, s, lit))
        return DCol(T.BOOLEAN, PLAIN, m, validity=l.validity)
    r = eval_expr(right, chunk)
    valid = _and_validity(l.validity, r.validity)
    if l.kind != PLAIN or r.kind != PLAIN:
        return DCol(T.BOOLEAN, PLAIN, _compare_strings(op, l, r),
                    validity=valid)
    if any(isinstance(c.dtype, T.DoubleType) for c in (l, r)):
        # DOUBLE against an integer or decimal: compared in float64
        return DCol(T.BOOLEAN, PLAIN, _int_cmp(op, as_double(l),
                                               as_double(r)), validity=valid)
    # integer/date/decimal: align scales
    ls, rs = _scale_of(l.dtype), _scale_of(r.dtype)
    s = max(ls, rs)
    if _is_i128(l) or _is_i128(r):
        m = I128.cmp(op, *_col_i128(l, s), *_col_i128(r, s))
        return DCol(T.BOOLEAN, PLAIN, m, validity=valid)
    lv = D.rescale(l.values.to(torch.int64), ls, s)
    rv = D.rescale(r.values.to(torch.int64), rs, s)
    return DCol(T.BOOLEAN, PLAIN, _int_cmp(op, lv, rv), validity=valid)


def _compare_strings(op: str, l: DCol, r: DCol) -> torch.Tensor:
    """A string column against a string column, by value.  Two DICT
    columns compare the ranks of their codes in the sorted union of both
    dictionaries (host-built tables, the dictionaries being small), so
    two dictionaries in different orders still match by string; any
    other pair is decoded to BYTES and compared with ``=`` / ``<>``
    (the JAX package compares codes of different dictionaries, and
    refuses ordered byte compares)."""
    if l.kind == DICT and r.kind == DICT:
        union = np.unique(np.concatenate([
            np.asarray(l.dictionary.strings, dtype=str),
            np.asarray(r.dictionary.strings, dtype=str)]))
        return _int_cmp(op, _rank_in(union, l), _rank_in(union, r))
    if op not in ("=", "<>"):
        raise NotImplementedError(f"ordered compare {l.kind} {op} {r.kind}")
    a, b = dcol_to_bytes(l), dcol_to_bytes(r)
    w = max(a.values.shape[1], b.values.shape[1])
    eq = (_pad_bytes(a.values, w) == _pad_bytes(b.values, w)).all(1) \
        & (a.lengths == b.lengths)
    return eq if op == "=" else ~eq


def _rank_in(union: np.ndarray, c: DCol) -> torch.Tensor:
    """Each DICT code's string as its position in the sorted ``union``."""
    table = np.searchsorted(union, np.asarray(c.dictionary.strings,
                                              dtype=str))
    return torch.from_numpy(table.astype(np.int64)).to(c.values.device)[
        c.values.to(torch.int64)]


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
