"""The port's dates, times and TIMESTAMP WITH TIME ZONE against the JAX
package, Python's ``datetime`` and Trino's documented semantics, on the
CPU at SF0.01.

- every DATETIME entry of ``tests/test_function_matrix.py``, the date
  tests of ``tests/test_functions.py`` and the eleven tests of
  ``tests/test_timestamp_tz.py``, run through the port's ``LocalRunner``;
- each function through both packages' ``eval_expr`` over the same
  seeded columns (days from -25,000 to 50,000, microsecond timestamps
  from 1900 to 2100, offsets from -12:00 to +14:00): integers and strings
  equal, NULLs in the same rows;
- where the port does not copy a JAX package fault (the floored
  ``date_diff``, the localized ``to_unixtime`` and ``date_trunc``, the
  zoned cast that drops the offset, the timestamp literal a microsecond
  short, the zoned literal that needs a space, ``date_add`` of a
  timestamp that drops its time), Python's ``datetime`` decides, and the
  JAX package's differing value is asserted beside it;
- zoned values carried through GROUP BY, joins, UNION ALL and LIMIT, and
  refused by an aggregate that would drop their offsets;
- ``date_diff('hour', ..)`` and named zones still raising;
- the card's ``strings_dates`` statements (``tools/np_tpch_oracle.py``)
  against their oracle and the JAX package's run.
"""

import calendar
import datetime as dt
import functools
import inspect
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_function_matrix as FM
import test_functions as TF
import test_timestamp_tz as TZ
from presto_tpu.data import types as JT
from presto_tpu.exec import columns as JC
from presto_tpu.exec import expreval as JE
from presto_tpu.sql import ir as JIR
from presto_tpu.sql.planner import planner as JP
from presto_tpu_torch.client import cli as TCLI
from presto_tpu_torch.data import types as T
from presto_tpu_torch.exec import columns as TC
from presto_tpu_torch.exec import expreval as TE
from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.sql import ir
from presto_tpu_torch.sql.planner import planner as TP

SF = 0.01
EPOCH = dt.datetime(1970, 1, 1)
US = dt.timedelta(microseconds=1)


@functools.lru_cache(maxsize=None)
def port() -> LocalRunner:
    return LocalRunner(scale_factor=SF, device="cpu")


def _one(expr: str):
    return port().run_sql(
        f"select {expr} v from region limit 1").to_pydict()["v"][0]


# ------------------------------------------------------ the SQL batteries

@pytest.mark.parametrize("sql,want", FM.DATETIME,
                         ids=[s for s, _ in FM.DATETIME])
def test_function_matrix_entry(sql, want):
    FM._run_batch(port(), [(sql, want)])


def test_date_parts():
    TF.test_date_parts(port())


@pytest.mark.parametrize("name", ["test_date_functions", "test_date_format"])
def test_scalar_breadth(name):
    getattr(TF.TestScalarBreadth(), name)(port())


def test_interval_types_and_timestamp_precision(monkeypatch):
    """The reference test, rendering through the port's ``cli._fmt``."""
    import presto_tpu.client.cli as jax_cli
    monkeypatch.setattr(jax_cli, "_fmt", TCLI._fmt)
    TF.test_interval_types_and_timestamp_precision(port())


TZ_TESTS = sorted(n for n, f in inspect.getmembers(TZ, inspect.isfunction)
                  if n.startswith("test_"))


@pytest.mark.parametrize("name", TZ_TESTS)
def test_timestamp_tz(name):
    getattr(TZ, name)(port())


def test_timestamp_tz_battery_is_whole():
    assert len(TZ_TESTS) == 11


# ------------------------------------------------------ against the JAX
# package's evaluator, over the same seeded columns

N = 500
LO_US = (dt.datetime(1900, 1, 1) - EPOCH) // US
HI_US = (dt.datetime(2100, 12, 31) - EPOCH) // US
EDGE_DAYS = [0, -1, 1, 59, 789, 10956, 11016, 11017, -25000, 49999,
             (dt.date(2024, 2, 29) - dt.date(1970, 1, 1)).days,
             (dt.date(2023, 12, 31) - dt.date(1970, 1, 1)).days]


@functools.lru_cache(maxsize=None)
def _data(seed: int = 11) -> dict:
    rng = np.random.default_rng(seed)
    days = np.concatenate([rng.integers(-25000, 50000, N - len(EDGE_DAYS)),
                           EDGE_DAYS]).astype(np.int32)
    us = np.concatenate([rng.integers(LO_US, HI_US, N - 4),
                         [0, -1, 86_399_999_999, -86_400_000_001]])
    return {"d": days, "d2": rng.permutation(days),
            "t": us.astype(np.int64),
            "t2": rng.integers(LO_US, HI_US, N).astype(np.int64),
            "off": rng.integers(-720, 841, N).astype(np.int32),
            "off2": rng.integers(-720, 841, N).astype(np.int32),
            "k": rng.integers(-30, 30, N).astype(np.int64),
            "x": rng.uniform(-3e9, 4e9, N),
            "null": rng.random(N) < 0.1}


def _types(mod):
    return {"d": mod.DATE, "d2": mod.DATE, "t": mod.TIMESTAMP,
            "t2": mod.TIMESTAMP, "z": mod.TimestampTzType(precision=6),
            "z2": mod.TimestampTzType(precision=6), "k": mod.BIGINT,
            "x": mod.DOUBLE}


def _chunk(mod, cmod, arr):
    """Both packages' chunk of the seeded columns: ``z``/``z2`` are ``t``
    /``t2`` zoned at ``off``/``off2``; ``d``, ``t`` and ``z`` have NULLs."""
    data, ty = _data(), _types(mod)
    valid = arr(~data["null"])
    cols = {}
    for c in ("d", "d2", "t", "t2", "k", "x"):
        cols[c] = cmod.DCol(ty[c], "plain", arr(data[c]), validity=valid
                            if c in ("d", "t") else None)
    for z, t, o in (("z", "t", "off"), ("z2", "t2", "off2")):
        cols[z] = cmod.DCol(ty[z], "plain", arr(data[t]),
                            validity=valid if z == "z" else None,
                            values2=arr(data[o]))
    return cmod.Chunk(cols, arr(np.ones(N, bool)))


def _eval(build):
    """``build(ir module, types module)`` → an expression, through both
    evaluators: ((values, validity, values2) of JAX, of the port)."""
    def run(mod, irm, cmod, arr, ev):
        out = ev(build(irm, mod), _chunk(mod, cmod, arr))
        valid = np.ones(N, bool) if out.validity is None \
            else np.asarray(out.validity).astype(bool)
        if out.kind == "dict":
            vals = np.array([str(out.dictionary.strings[c])
                             for c in np.asarray(out.values)], dtype=object)
        else:
            vals = np.asarray(out.values)
        v2 = None if out.values2 is None else np.asarray(out.values2)
        return vals, valid, v2

    return (run(JT, JIR, JC, jnp.asarray, JE.eval_expr),
            run(T, ir, TC, torch.from_numpy, TE.eval_expr))


def _func(name, cols, rtype, lits=()):
    def build(irm, mod):
        ty = _types(mod)
        refs = tuple(irm.Literal(v, mod.VARCHAR) for v in lits)
        refs += tuple(irm.ColumnRef(c, ty[c]) for c in cols)
        return irm.Func(name, refs, rtype(mod))
    return build


BIG = (lambda m: m.BIGINT)
FIELDS = ("month", "day", "quarter", "week", "year_of_week", "day_of_week",
          "day_of_year", "hour", "minute", "second", "millisecond")
EQUAL = {f"{f}({c})": _func(f, (c,), BIG) for f in FIELDS
         for c in ("d", "t", "z")}
EQUAL.update({
    "last_day_of_month(t)": _func("last_day_of_month", ("t",),
                                  lambda m: m.DATE),
    "last_day_of_month(z)": _func("last_day_of_month", ("z",),
                                  lambda m: m.DATE),
    "to_unixtime(d)": _func("to_unixtime", ("d",), lambda m: m.DOUBLE),
    "to_unixtime(t)": _func("to_unixtime", ("t",), lambda m: m.DOUBLE),
    "from_unixtime(x)": _func("from_unixtime", ("x",),
                              lambda m: m.TimestampType(precision=3)),
    "date_diff(day, d, d2)": _func("date_diff", ("d", "d2"), BIG, ("day",)),
})
for c, zone in (("t", "+05:45"), ("z", "-03:30")):
    EQUAL[f"at_timezone({c})"] = (lambda c, zone: lambda irm, mod: irm.Func(
        "at_timezone", (irm.ColumnRef(c, _types(mod)[c]),
                        irm.Literal(zone, mod.VARCHAR)),
        mod.TimestampTzType(precision=6)))(c, zone)
for unit in ("day", "week", "month", "quarter", "year"):
    EQUAL[f"date_trunc({unit}, d)"] = _func("date_trunc", ("d",),
                                           lambda m: m.DATE, (unit,))
for unit in ("second", "minute", "hour", "day", "week", "month", "year"):
    EQUAL[f"date_trunc({unit}, t)"] = _func("date_trunc", ("t",),
                                           lambda m: m.TIMESTAMP, (unit,))
for unit in ("day", "week", "month", "year"):
    EQUAL[f"date_add({unit}, k, d)"] = (
        lambda u: lambda irm, mod: irm.Func("date_add", (
            irm.Literal(u, mod.VARCHAR), irm.ColumnRef("k", mod.BIGINT),
            irm.ColumnRef("d", mod.DATE)), mod.DATE))(unit)
for fmt in ("%Y-%m-%d %W %j %a %M", "%y/%m/%d %H:%i:%s"):
    for c in ("d", "t", "z"):
        EQUAL[f"date_format({c}, {fmt})"] = (
            lambda c, fmt: lambda irm, mod: irm.Func("date_format", (
                irm.ColumnRef(c, _types(mod)[c]),
                irm.Literal(fmt, mod.VARCHAR)), mod.VARCHAR))(c, fmt)
EQUAL["format_datetime(t)"] = lambda irm, mod: irm.Func(
    "format_datetime", (irm.ColumnRef("t", mod.TIMESTAMP),
                        irm.Literal("yyyy/MM/dd HH:mm:ss", mod.VARCHAR)),
    mod.VARCHAR)
for src, to in (("d", "t"), ("d", "z"), ("t", "d"), ("t", "t3"),
                ("t", "z"), ("z", "t"), ("z", "d")):
    EQUAL[f"cast({src} as {to})"] = (lambda src, to: lambda irm, mod: (
        irm.Cast(irm.ColumnRef(src, _types(mod)[src]), {
            "t": mod.TIMESTAMP, "d": mod.DATE,
            "t3": mod.TimestampType(precision=3),
            "z": mod.TimestampTzType(precision=6)}[to])))(src, to)
EQUAL["year(z)"] = lambda irm, mod: irm.ExtractYear(
    irm.ColumnRef("z", _types(mod)["z"]))


@pytest.mark.parametrize("case", EQUAL)
def test_function_equals_jax(case):
    (jv, jok, j2), (tv, tok, t2) = _eval(EQUAL[case])
    assert np.array_equal(jok, tok)
    assert np.array_equal(jv[jok], tv[tok])
    assert (j2 is None) == (t2 is None)
    if j2 is not None:
        assert np.array_equal(j2[jok], t2[tok])


def test_date_parse_is_exact_where_the_jax_package_is_a_microsecond_off():
    """``date_parse`` of formatted timestamps gives back each one exactly;
    the JAX package's float conversion is 1 µs short on some rows."""
    data = _data()
    text = [(EPOCH + int(u) * US).strftime("%Y-%m-%d %H:%M:%S.%f")
            for u in data["t2"]]

    def build(irm, mod):
        return irm.Func("date_parse", (irm.ColumnRef("s", mod.VARCHAR),
                                       irm.Literal("%Y-%m-%d %H:%i:%s.%f",
                                                   mod.VARCHAR)),
                        mod.TIMESTAMP)

    def run(mod, irm, cmod, arr, ev):
        uniq = sorted(set(text))
        pos = {s: i for i, s in enumerate(uniq)}
        col = cmod.DCol(mod.VARCHAR, "dict", arr(np.array(
            [pos[s] for s in text], np.int32)),
            dictionary=cmod.Dictionary(np.array(uniq, dtype=object)))
        return np.asarray(ev(build(irm, mod), cmod.Chunk(
            {"s": col}, arr(np.ones(N, bool)))).values)

    jv = run(JT, JIR, JC, jnp.asarray, JE.eval_expr)
    tv = run(T, ir, TC, torch.from_numpy, TE.eval_expr)
    assert np.array_equal(tv, data["t2"])
    assert (np.abs(jv - tv) <= 1).all() and (jv != tv).any()


# ------------------------------------------------------ Python decides
# where the port does not copy the JAX package

def _py_dt(us: int) -> dt.datetime:
    return EPOCH + int(us) * US


def _py_add_months(t: dt.datetime, k: int) -> dt.datetime:
    y, m = divmod(t.month - 1 + k, 12)
    y += t.year
    return t.replace(year=y, month=m + 1,
                     day=min(t.day, calendar.monthrange(y, m + 1)[1]))


def _py_whole(a: dt.datetime, b: dt.datetime, months: int) -> int:
    """Trino's (Joda's) whole months or years from ``a`` to ``b``: the
    most steps ``k`` with ``a`` + ``k`` steps (the day clamped to the
    month's length) not after ``b``; from a later ``a``, the negation."""
    if b < a:
        return -_py_whole(b, a, months)
    k = ((b.year - a.year) * 12 + b.month - a.month) // months + 1
    while _py_add_months(a, k * months) > b:
        k -= 1
    return k


def _trunc_div(a: int, b: int) -> int:
    q = abs(a) // b
    return q if a >= 0 else -q


def _py_date_diff(unit: str, a: dt.datetime, b: dt.datetime) -> int:
    if unit in ("day", "week"):
        return _trunc_div((b - a) // US, 86_400_000_000 * (
            7 if unit == "week" else 1))
    if unit == "quarter":
        return _trunc_div(_py_whole(a, b, 1), 3)
    return _py_whole(a, b, 12 if unit == "year" else 1)


def _days_dt(d) -> dt.datetime:
    return EPOCH + dt.timedelta(days=int(d))


@pytest.mark.parametrize("unit", ["day", "week", "month", "quarter", "year"])
@pytest.mark.parametrize("cols", [("d", "d2"), ("t", "t2"), ("z", "z2")])
def test_date_diff_against_python(unit, cols):
    """Whole units from a to b as Trino counts them (days and weeks of
    elapsed time truncated toward zero, months and years by Joda's field
    rules in a's zone).  On dates with a span that is not negative the
    JAX package agrees, except for a later date on its month's last day
    (months) or an earlier date on Feb 29 (years)."""
    data = _data()
    if unit == "quarter":  # the JAX package raises: Python alone decides
        out = TE.eval_expr(_func("date_diff", cols, BIG, (unit,))(ir, T),
                           _chunk(T, TC, torch.from_numpy))
        tv, tok = out.values.numpy(), out.valid_or_true().numpy()
    else:
        (jv, jok, _), (tv, tok, _) = _eval(_func("date_diff", cols, BIG,
                                                 (unit,)))
        assert np.array_equal(jok, tok)
    if cols[0] == "d":
        a = [_days_dt(x) for x in data["d"]]
        b = [_days_dt(x) for x in data["d2"]]
    else:
        shift = (data["off"].astype(np.int64) * 60_000_000
                 if cols[0] == "z" else np.zeros(N, np.int64))
        a = [_py_dt(x) for x in data["t"] + shift]
        b = [_py_dt(x) for x in data["t2"] + shift]
    want = np.array([_py_date_diff(unit, x, y) for x, y in zip(a, b)])
    assert np.array_equal(tv[tok], want[tok])
    if cols[0] != "d" or unit == "quarter":
        return
    later = [max(x, y) for x, y in zip(a, b)]
    earlier = [min(x, y) for x, y in zip(a, b)]
    clamp = np.array([
        y.day == calendar.monthrange(y.year, y.month)[1] and x.day > y.day
        for x, y in zip(earlier, later)])
    feb29 = np.array([x.month == 2 and x.day == 29 for x in earlier])
    agree = tok & (data["d2"] >= data["d"])
    if unit == "month":
        agree &= ~clamp
    if unit == "year":
        agree &= ~feb29
    assert np.array_equal(jv[agree], tv[agree])


@pytest.mark.parametrize("unit,a,b,trino,jax", [
    ("month", "2024-03-15", "2024-01-20", -1, -2),
    ("week", "2024-01-10", "2024-01-01", -1, -2),
    ("year", "2024-03-15", "2023-06-20", 0, -1),
    ("month", "2024-01-31", "2024-02-29", 1, 0),
    ("year", "2024-02-29", "2025-02-28", 1, 0),
])
def test_date_diff_fault_not_copied(unit, a, b, trino, jax):
    assert _one(f"date_diff('{unit}', date '{a}', date '{b}')") == trino
    days = [(dt.date.fromisoformat(x) - dt.date(1970, 1, 1)).days
            for x in (a, b)]
    out = JE.eval_expr(JIR.Func("date_diff", (
        JIR.Literal(unit, JT.VARCHAR), JIR.Literal(days[0], JT.DATE),
        JIR.Literal(days[1], JT.DATE)), JT.BIGINT),
        JC.Chunk({}, jnp.ones((1,), jnp.bool_)))
    assert int(out.values[0]) == jax


def test_zoned_instant_functions_against_python():
    """``to_unixtime`` reads a zoned value's instant, ``date_trunc``
    truncates its wall time and keeps its offset, a zoned → zoned cast
    keeps both; the JAX package shifts the first two by the offset and
    resets the third's offset to 0."""
    data = _data()
    off = data["off"].astype(np.int64) * 60_000_000
    (jv, _, _), (tv, tok, _) = _eval(_func("to_unixtime", ("z",),
                                           lambda m: m.DOUBLE))
    assert np.array_equal(tv, data["t"] / 1e6)
    assert np.array_equal(jv, (data["t"] + off) / 1e6)
    for unit, step in (("hour", 3_600_000_000), ("day", 86_400_000_000)):
        (jv, _, j2), (tv, tok, t2) = _eval(_func(
            "date_trunc", ("z",), lambda m: m.TimestampTzType(precision=6),
            (unit,)))
        wall = data["t"] + off
        assert np.array_equal(tv, wall // step * step - off)
        assert np.array_equal(t2, data["off"]) and j2 is None
        assert np.array_equal(jv, wall // step * step)
    (jv, _, j2), (tv, _, t2) = _eval(lambda irm, mod: irm.Cast(
        irm.ColumnRef("z", _types(mod)["z"]), mod.TimestampTzType(3)))
    assert np.array_equal(tv, data["t"]) and np.array_equal(t2, data["off"])
    assert np.array_equal(jv, data["t"]) and not j2.any()


@pytest.mark.parametrize("unit", ["day", "week", "month", "quarter", "year",
                                  "hour", "minute", "second",
                                  "millisecond"])
@pytest.mark.parametrize("col", ["t", "z", "d"])
def test_date_add_against_python(unit, col):
    """A timestamp keeps its time of day, a zoned one its offset (the JAX
    package returns the day as a DATE and knows no quarter nor sub-day
    unit); a date takes the day to year units."""
    data = _data()
    build = (lambda irm, mod: irm.Func("date_add", (
        irm.Literal(unit, mod.VARCHAR), irm.ColumnRef("k", mod.BIGINT),
        irm.ColumnRef(col, _types(mod)[col])), _types(mod)[col]))
    if col == "d" and unit in ("hour", "minute", "second", "millisecond"):
        with pytest.raises(NotImplementedError, match="date_add unit"):
            TE.eval_expr(build(ir, T), _chunk(T, TC, torch.from_numpy))
        return
    out = TE.eval_expr(build(ir, T), _chunk(T, TC, torch.from_numpy))
    off = data["off"].astype(np.int64) * 60_000_000 if col == "z" else 0
    base = (data["d"].astype(np.int64) * 86_400_000_000 if col == "d"
            else data["t"] + off)
    step = {"day": 1, "week": 7}.get(unit)
    sub = {"hour": 3600e6, "minute": 60e6, "second": 1e6,
           "millisecond": 1e3}.get(unit)
    want = []
    for u, k in zip(base.tolist(), data["k"].tolist()):
        t = _py_dt(u)
        if step:
            t += dt.timedelta(days=k * step)
        elif sub:
            t += int(k * sub) * US
        else:
            t = _py_add_months(t, k * {"month": 1, "quarter": 3,
                                       "year": 12}[unit])
        want.append((t - EPOCH) // US)
    want = np.array(want) - off
    got = out.values.numpy().astype(np.int64)
    if col == "d":
        assert out.dtype == T.DATE
        got = got * 86_400_000_000
    assert np.array_equal(got, want)
    if col == "z":
        assert np.array_equal(out.values2.numpy(), data["off"])


def test_date_add_of_a_timestamp_keeps_its_time():
    t = _one("date_add('day', 1, timestamp '2020-01-31 10:11:12.5')")
    assert t == (dt.datetime(2020, 2, 1, 10, 11, 12, 500000) - EPOCH) // US
    assert _one("hour(timestamp '2020-01-31 10:00:00' + interval '1' month)"
                ) == 10


# ------------------------------------------------------ literals

def _instants(seed: int, n: int):
    rng = np.random.default_rng(seed)
    us = rng.integers(LO_US, HI_US, n).tolist() + [0, -1, 1]
    return [_py_dt(u) for u in us]


@pytest.mark.parametrize("batch", range(10))
def test_timestamp_literals_are_exact_to_the_microsecond(batch):
    """Seeded instants from 1900 to 2100 written as literals: the stored
    micros, ``millisecond``, ``second`` and ``to_unixtime`` x 1e6 equal
    Python's ``datetime``."""
    ts = _instants(100 + batch, 30)
    items = []
    for i, t in enumerate(ts):
        lit = f"timestamp '{t.isoformat(' ')}'"
        items += [f"{lit} t{i}", f"millisecond({lit}) m{i}",
                  f"second({lit}) s{i}", f"to_unixtime({lit}) u{i}"]
    got = port().run_sql(f"select {', '.join(items)} from region limit 1"
                         ).to_pydict()
    for i, t in enumerate(ts):
        micros = (t - EPOCH) // US
        assert got[f"t{i}"] == [micros], t
        assert got[f"m{i}"] == [t.microsecond // 1000]
        assert got[f"s{i}"] == [t.second]
        assert round(got[f"u{i}"][0] * 1e6) == micros


def test_timestamp_literal_fault_not_copied():
    """``int(total_seconds() * 1e6)`` stores this instant 1 µs short (the
    JAX package's planner); about one instant in a hundred is."""
    text = "2004-07-05 17:04:31.702026"
    assert TP._timestamp_micros(text) == 1089047071702026
    assert JP._timestamp_micros(text) == 1089047071702025
    assert _one(f"timestamp '{text}'") == 1089047071702026
    assert round(_one(f"to_unixtime(timestamp '{text}') * 1000000")) == \
        1089047071702026
    short = sum(JP._timestamp_micros(t.isoformat(" ")) != (t - EPOCH) // US
                for t in _instants(7, 2000))
    assert short > 0 and all(
        TP._timestamp_micros(t.isoformat(" ")) == (t - EPOCH) // US
        for t in _instants(7, 2000))


@pytest.mark.parametrize("text", ["2020-06-10T15:30:00+05:30",
                                  "2020-06-10 15:30:00+05:30",
                                  "2020-06-10 15:30:00 +05:30",
                                  "2020-06-10 15:30:00 +0530"])
def test_zoned_literal_parses_whatever_separates_the_offset(text):
    want = ((dt.datetime(2020, 6, 10, 10, 0) - EPOCH) // US, 330)
    assert TP._timestamp_tz_parts(text) == want
    assert _one(f"timestamp '{text}'") == "2020-06-10 15:30:00.000 +05:30"
    if "T" in text:  # the JAX package's parse needs a space
        assert JP._timestamp_tz_parts(text) is None
        with pytest.raises(ValueError):
            JP._timestamp_micros(text)


def test_utc_literal_is_offset_zero():
    assert TP._timestamp_tz_parts("2020-06-10 15:30:00 UTC") == (
        (dt.datetime(2020, 6, 10, 15, 30) - EPOCH) // US, 0)


@pytest.mark.parametrize("sql", [
    "timestamp '2020-06-10 15:30:00 America/New_York'",
    "timestamp '2020-06-10 15:30:00' at time zone 'Europe/Paris'",
])
def test_named_zone_raises_naming_it(sql):
    with pytest.raises(NotImplementedError, match="named time zone"):
        _one(sql)


def test_sub_day_date_diff_still_raises():
    with pytest.raises(NotImplementedError, match="date_diff unit hour"):
        _one("date_diff('hour', timestamp '2020-01-01 00:00:00', "
             "timestamp '2020-01-02 00:00:00')")


# ------------------------------------------------------ C.5's timezone
# faults, through the port's SQL and the JAX package's evaluator

def _jax_eval(expr):
    return JE.eval_expr(expr, JC.Chunk({}, jnp.ones((1,), jnp.bool_)))


def test_zoned_cast_keeps_the_offset():
    """``hour`` of a zoned value cast to another zoned precision is its
    wall-clock hour (the JAX package's cast resets the offset: 4)."""
    assert _one("hour(cast(timestamp '2024-01-01 10:00:00 +05:30' "
                "as timestamp(6) with time zone))") == 10
    us = (dt.datetime(2024, 1, 1, 4, 30) - EPOCH) // US
    out = _jax_eval(JIR.Func("hour", (JIR.Cast(
        JIR.Literal((us, 330), JT.TIMESTAMP_TZ),
        JT.TimestampTzType(precision=6)),), JT.BIGINT))
    assert int(out.values[0]) == 4


def test_to_unixtime_of_a_zoned_value_is_its_instant():
    assert _one("to_unixtime(timestamp '1970-01-02 00:00:00 +01:00')") \
        == 82800.0
    out = _jax_eval(JIR.Func("to_unixtime", (JIR.Literal(
        (82_800_000_000, 60), JT.TIMESTAMP_TZ),), JT.DOUBLE))
    assert float(out.values[0]) == 86400.0


def test_date_trunc_of_a_zoned_value_stays_zoned():
    assert _one("date_trunc('day', timestamp '2020-06-10 23:30:00 +05:30')"
                ) == "2020-06-10 00:00:00.000 +05:30"
    us = (dt.datetime(2020, 6, 10, 18, 0) - EPOCH) // US
    out = _jax_eval(JIR.Func("date_trunc", (
        JIR.Literal("day", JT.VARCHAR),
        JIR.Literal((us, 330), JT.TIMESTAMP_TZ)), JT.TIMESTAMP_TZ))
    assert int(out.values[0]) == \
        (dt.datetime(2020, 6, 10) - EPOCH) // US and out.values2 is None


# ------------------------------------------------------ zoned values in
# operators

def test_zoned_values_through_group_by_join_and_union():
    got = port().run_sql(
        "select z, count(*) c from (select cast(o_orderdate as timestamp) "
        "at time zone '+05:30' z from orders where o_orderkey < 100) x "
        "group by z order by z limit 2").to_pydict()
    o = port().run_sql("select o_orderdate d from orders where o_orderkey "
                       "< 100 order by 1").to_pydict()["d"]
    first = sorted(set(o))[:2]
    assert got["z"] == [(dt.datetime(1970, 1, 1, 5, 30)
                         + dt.timedelta(days=d)).strftime(
                             "%Y-%m-%d %H:%M:%S.000 +05:30") for d in first]
    assert got["c"] == [o.count(d) for d in first]
    got = port().run_sql(
        "select n_name, z from nation left join (select r_regionkey k, "
        "timestamp '2020-01-01 00:00:00 -08:00' z from region "
        "where r_regionkey = 0) r on n_regionkey = r.k "
        "order by n_nationkey limit 3").to_pydict()
    assert got["z"] == ["2020-01-01 00:00:00.000 -08:00", None, None]


@pytest.mark.parametrize("agg", ["min(z)", "max(z)"])
def test_an_aggregate_that_drops_offsets_raises(agg):
    with pytest.raises(NotImplementedError, match="time zone"):
        port().run_sql(f"select {agg} m from (select timestamp "
                       "'2020-01-01 00:00:00 +01:00' z from region) x")


# ------------------------------------------------------ the slice as a
# whole: the card's ``strings_dates`` statements at SF0.01

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import np_tpch_oracle as NO  # noqa: E402


@functools.lru_cache(maxsize=None)
def ref():
    from presto_tpu.exec.runner import LocalRunner as JaxRunner
    return JaxRunner(scale_factor=SF)


@functools.lru_cache(maxsize=None)
def _slice_oracle() -> dict:
    return NO.strings_dates(NO.Tables(port().datasource))


# the JAX package's result where it differs on purpose: '' for a
# split_part past the end, floored negative spans, a zoned instant
# shifted by its offset; None where it raises (a host function over a
# byte-matrix column inside its jitted operators)
JAX_DIFFERS = {"split_part_null": {"c": [0]},
               "date_diff_join": {"d": [3644696], "m": [-178888],
                                  "w": [-678595]},
               "zoned": {"h": [5], "u": [694195200.0], "c": [15000]},
               "bytes_trim_strpos": None, "bytes_pad_prefix": None,
               "bytes_regexp": None, "trunc_format": None}


@pytest.mark.parametrize("name", NO.STRINGS_DATES)
def test_strings_dates_statement(name):
    """Each statement through the port equals the numpy/Python oracle the
    card holds it to, and the JAX package's run where that agrees."""
    sql = NO.STRINGS_DATES[name]
    got = {c: col.to_pylist() for c, col in port().run_sql(sql).columns.items()}
    assert got == _slice_oracle()[name]
    if name in JAX_DIFFERS and JAX_DIFFERS[name] is None:
        with pytest.raises(NotImplementedError):
            ref().run_sql(sql)
        return
    jax = {c: col.to_pylist() for c, col in ref().run_sql(sql).columns.items()}
    assert jax == JAX_DIFFERS.get(name, got)
