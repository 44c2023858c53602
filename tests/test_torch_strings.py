"""The port's string and date expressions, scalar subqueries and global
and DISTINCT aggregates against the JAX package, exactly (tolerance 0).

Ops are fed the same seeded numpy inputs: ``strings.like``,
``eq_literal`` and ``substring`` over byte matrices with garbage past each
row's length, ``year_from_days`` and the int128 extremes.  LIKE is also
held to a character loop written here.  Aggregates and scalar subqueries
run as small SQL over the SF0.01 tables through both packages' ``run_sql``
from runners cached per module, one statement per test.
"""

import datetime as dt

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpch_oracle as O
from presto_tpu.exec import expreval as JE
from presto_tpu.exec.runner import LocalRunner as JaxRunner
from presto_tpu.ops import int128 as JI
from presto_tpu.ops import strings as JS
from presto_tpu_torch.exec import expreval as TE
from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.ops import cuda_kernels as CK
from presto_tpu_torch.ops import int128 as TI
from presto_tpu_torch.ops import strings as TS

SF = 0.01
WIDTHS = (1, 7, 8, 9, 55, 79)
I64_MIN, I64_MAX = -2**63, 2**63 - 1


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def like_oracle(s: str, pattern: str) -> bool:
    """SQL LIKE by a character loop: ``ok[j]`` says the pattern read so
    far matches ``s[:j]``; '%' matches any run, '_' one character."""
    ok = [True] + [False] * len(s)
    for ch in pattern:
        if ch == "%":
            for j in range(1, len(s) + 1):
                ok[j] = ok[j] or ok[j - 1]
        else:
            ok = [False] + [ok[j - 1] and (ch == "_" or s[j - 1] == ch)
                            for j in range(1, len(s) + 1)]
    return ok[len(s)]


def byte_rows(width: int, rows: int = 300, seed: int = 0):
    """[rows, width] bytes over a small alphabet (so segments repeat and
    overlap), lengths 0..width with zeros, and garbage from the same
    alphabet past each length (a read past it would find false hits)."""
    rng = np.random.default_rng(seed + width)
    alphabet = np.frombuffer(b"aaabx", dtype=np.uint8)
    vals = rng.choice(alphabet, size=(rows, width)).astype(np.uint8)
    lens = rng.integers(0, width + 1, size=rows).astype(np.int32)
    lens[::11] = 0
    lens[1::13] = width
    return vals, lens


def strings_of(vals, lens):
    return [bytes(v[:k]).decode("ascii") for v, k in zip(vals, lens)]


# ---------------------------------------------------------------- strings

LIKE_PATTERNS = {
    "prefix": "ab%",
    "suffix": "%ab",
    "infix": "%ab%",
    "segments": "%a%b%x%",
    "anchored_segments": "a%b%ab",
    "anchored_overlap": "a%a",
    "overlapping_repeats": "%aa%aab",
    "repeats_anchored": "ab%ba%ab",
    "longer_than_w": "%" + "ab" * 40 + "%",
    "empty": "",
    "all_percent": "%",
    "all_percent_repeated": "%%%",
    "exact": "aab",
    "infix_overlap": "%aba%",
}


@pytest.mark.parametrize("pattern", LIKE_PATTERNS.values(),
                         ids=LIKE_PATTERNS.keys())
def test_like_equals_jax(pattern):
    for width in WIDTHS:
        vals, lens = byte_rows(width)
        want = np.asarray(JS.like(jnp.asarray(vals), jnp.asarray(lens),
                                  pattern))
        got = TS.like(t(vals), t(lens), pattern).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"W={width}")
        assert got.tolist() == [like_oracle(s, pattern)
                                for s in strings_of(vals, lens)]


@pytest.mark.parametrize("width", WIDTHS)
def test_eq_literal_and_substring_equal_jax(width):
    vals, lens = byte_rows(width, seed=1)
    strs = strings_of(vals, lens)
    for lit in {"", "a", "ab", "aab", "x" * (width + 1), strs[3], strs[5]}:
        want = np.asarray(JS.eq_literal(jnp.asarray(vals),
                                        jnp.asarray(lens), lit))
        got = TS.eq_literal(t(vals), t(lens), lit).numpy()
        np.testing.assert_array_equal(got, want, err_msg=repr(lit))
        assert got.tolist() == [s == lit for s in strs]
    for start, size in {(1, 1), (1, 2), (2, 3), (1, width), (width, 2),
                        (width + 2, 3)}:
        wv, wl = JS.substring(jnp.asarray(vals), jnp.asarray(lens), start,
                              size)
        gv, gl = TS.substring(t(vals), t(lens), start, size)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
        assert strings_of(gv.numpy(), gl.numpy()) == [
            s[start - 1:start - 1 + size] for s in strs]


# ---------------------------------------------------------------- dates

def test_year_from_days_equals_jax():
    """Every day in [-800,000, 800,000] (about 220 BCE to 4160 CE) and
    each Feb 28 / Feb 29 / Mar 1 of 1899-2101, against the JAX function
    and numpy's calendar."""
    epoch = dt.date(1970, 1, 1)
    edges = [(dt.date(y, 3, 1) - epoch).days + d for y in range(1899, 2102)
             for d in (-2, -1, 0)]
    days = np.concatenate([np.arange(-800_000, 800_001),
                           np.array(edges)]).astype(np.int64)
    got = TE.year_from_days(t(days)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(JE.year_from_days(jnp.asarray(days))))
    np.testing.assert_array_equal(
        got, days.astype("datetime64[D]").astype("datetime64[Y]")
        .astype(np.int64) + 1970)


# ---------------------------------------------------------------- int128

def _extreme_cases(rng):
    """Words with many ties on the hi word (so the lo word decides) and lo
    words on every sign boundary (unsigned order)."""
    edge = np.array([0, 1, -1, I64_MIN, I64_MAX, I64_MIN + 1, 2**32],
                    dtype=np.int64)
    hi = rng.choice(edge[:4], size=500)
    lo = np.concatenate([edge, rng.integers(I64_MIN, I64_MAX, size=493,
                                            dtype=np.int64)])
    return np.stack([hi, lo], axis=1)


@pytest.mark.parametrize("mask", ["random", "one", "empty", "all"])
@pytest.mark.parametrize("func", ["min", "max"])
def test_g_min_max128_equal_jax(func, mask):
    rng = np.random.default_rng(len(mask))
    vals = _extreme_cases(rng)
    m = {"random": rng.random(500) < 0.3,
         "one": np.arange(500) == 17,
         "empty": np.zeros(500, dtype=bool),
         "all": np.ones(500, dtype=bool)}[mask]
    jf, tf = (JI.g_min128, TI.g_min128) if func == "min" else \
        (JI.g_max128, TI.g_max128)
    want = [int(np.asarray(w)) for w in jf(jnp.asarray(vals),
                                           jnp.asarray(m))]
    got = [int(g) for g in tf(t(vals), t(m))]
    assert got == want
    if m.any():
        ints = [int(h) * 2**64 + (int(lo) % 2**64) for h, lo in vals[m]]
        best = min(ints) if func == "min" else max(ints)
        assert got[0] * 2**64 + got[1] % 2**64 == best


# ---------------------------------------------------------------- SQL

@pytest.fixture(scope="module")
def port():
    return LocalRunner(scale_factor=SF, device="cpu")


@pytest.fixture(scope="module")
def ref():
    return JaxRunner(scale_factor=SF)


def _cols(table):
    return {name: col.to_pylist() for name, col in table.columns.items()}


def _same(got, want):
    assert list(got.columns) == list(want.columns)
    for c in got.columns:
        assert str(got.columns[c].dtype) == str(want.columns[c].dtype), c
    assert _cols(got) == _cols(want)
    return _cols(got)


SQL = {
    "avg_short_decimal": (
        "select avg(c_acctbal) as a, avg(c_acctbal * 2) as b from customer"),
    "avg_long_decimal": (
        "select avg(l_extendedprice * l_quantity) as a from lineitem "
        "where l_shipdate < date '1993-01-01'"),
    "min_max_ints_dates": (
        "select min(o_orderdate) as lo, max(o_orderdate) as hi, "
        "min(o_custkey) as c, max(o_shippriority) as s, "
        "max(o_totalprice) as p from orders"),
    "min_max_long_decimal": (
        "select min(l_extendedprice * (l_discount - l_tax)) as lo, "
        "max(l_extendedprice * (l_discount - l_tax)) as hi from lineitem"),
    "empty_input": (
        "select min(o_orderdate) as lo, max(o_totalprice) as hi, "
        "avg(o_totalprice) as a, count(distinct o_custkey) as d "
        "from orders where o_orderkey < 0"),
    "global_count_distinct": (
        "select count(distinct o_custkey) as c, "
        "count(distinct o_orderpriority) as p, count(*) as n from orders"),
    "global_count_distinct_bytes": (
        "select count(distinct substring(c_phone from 1 for 2)) as c "
        "from customer"),
    "grouped_count_distinct_dict_key": (
        "select o_orderpriority, count(distinct o_custkey) as c from orders "
        "group by o_orderpriority order by o_orderpriority"),
    # 19 groups, thousands of (group, value) pairs: the pair table
    # overflows its first capacities
    "grouped_count_distinct_int_key": (
        "select l_suppkey, count(distinct l_partkey) as c, count(*) as n, "
        "sum(l_quantity) as q from lineitem where l_suppkey < 20 "
        "group by l_suppkey order by l_suppkey"),
    "grouped_count_distinct_nulls": (
        "select c_nationkey, count(distinct o_orderpriority) as c, "
        "count(o_orderkey) as n from customer left join orders "
        "on c_custkey = o_custkey and o_totalprice > 400000 "
        "group by c_nationkey order by c_nationkey"),
    "scalar_no_row_short_decimal": (
        "select c_custkey, (select c_acctbal from customer "
        "where c_custkey = -1) as x from customer where c_custkey < 4"),
    "scalar_no_row_long_decimal": (
        "select c_custkey, (select l_extendedprice * l_quantity from "
        "lineitem where l_orderkey = -1) as x from customer "
        "where c_custkey < 4"),
    "scalar_long_decimal": (
        "select count(*) as c from lineitem where l_extendedprice * "
        "l_quantity > (select avg(l_extendedprice * l_quantity) "
        "from lineitem)"),
    "scalar_date": (
        "select o_orderkey, (select max(o_orderdate) from orders) as m "
        "from orders where o_orderkey < 10"),
}


@pytest.mark.parametrize("name", SQL)
def test_sql_equals_jax_engine(port, ref, name):
    CK.reset_launches()
    got = _same(port.run_sql(SQL[name]), ref.run_sql(SQL[name]))
    assert CK.LAUNCHES == dict.fromkeys(CK.SOURCES, 0)
    if name.startswith("scalar_no_row"):
        assert got["x"] == [None] * 3


def test_scalar_subquery_of_two_rows_raises(port):
    with pytest.raises(ValueError, match="returned 2 rows"):
        port.run_sql("select c_custkey from customer where c_acctbal > "
                     "(select c_acctbal from customer where c_custkey < 3)")


def test_scalar_subquery_of_a_null_value_compares_null(port):
    """A global max over no row is one row holding NULL, and a compare
    with NULL keeps no row (the JAX package binds the value words without
    their validity and keeps every row here)."""
    got = port.run_sql("select count(*) as c from orders where o_totalprice "
                       "> (select max(o_totalprice) from orders "
                       "where o_orderkey < 0)")
    assert _cols(got) == {"c": [0]}


@pytest.mark.parametrize("pattern", [
    "STANDARD_POLISHED%",   # 69 rows at SF0.01
    "STANDARD _POLISHED%",  # would match only if '_' matched nothing
    "%_BRASS", "PROMO%", "_____ PLATED %", "%COPPER_"])
def test_dict_like_underscore_matches_one_character(port, pattern):
    """LIKE on a dictionary column (``p_type``) with Trino's '_'."""
    got = _cols(port.run_sql("select count(*) as c from part "
                             f"where p_type like '{pattern}'"))["c"][0]
    want = sum(like_oracle(s, pattern) for s in O.load("part", SF).p_type)
    assert got == want
    if pattern == "STANDARD_POLISHED%":
        assert got == 69
    if pattern == "STANDARD _POLISHED%":
        assert got == 0
