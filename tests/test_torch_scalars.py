"""The port's IN lists, scalar functions and string min/max against
SQLite, Python oracles and the JAX package, on the CPU at SF0.01.

- the SQLite batteries the JAX package passes: all 23 queries of
  ``tests/test_sqlite_diff.py`` and the 120 seeded queries of
  ``tests/test_fuzz_sqlite.py`` (seed 20260817, in six chunks drawn from
  the one generator stream), with those modules' data and comparisons;
- the MISC, MATH and BITWISE entries of ``tests/test_function_matrix.py``
  (one case per expression, the matrix's own values and tolerance) and
  ``tests/test_functions.py::test_scalar_functions``;
- the three IN-list faults the port no longer shares with the JAX
  package (a literal's scale dropped, in the filter and in streamed split
  pruning; a NULL in the list), each against SQLite or Python;
- grouped, global, partitioned and streamed min/max of a dictionary
  column, by string, against pandas;
- ``unique_id`` unique, refused over slices and partitions, ``uuid``
  equal to the JAX package;
- each math and bitwise function over the same seeded numpy columns
  through both packages' expression evaluators: integer results exactly,
  DOUBLE results within ``ULPS`` units in the last place (torch's and
  XLA's CPU libm differ there), NULLs and NaNs in the same rows.
"""

import functools
import math
import random
import sqlite3
from decimal import ROUND_DOWN, Decimal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_function_matrix as FM
import test_functions as TF
import test_fuzz_sqlite as FZ
import test_sqlite_diff as SD
import tpch_oracle as O
from presto_tpu.data import types as JT
from presto_tpu.exec import columns as JC
from presto_tpu.exec import expreval as JE
from presto_tpu.exec.runner import LocalRunner as JaxRunner
from presto_tpu.sql import ir as JIR
from presto_tpu_torch.data import types as T
from presto_tpu_torch.exec import columns as TC
from presto_tpu_torch.exec import expreval as TE
from presto_tpu_torch.exec import streaming as ST
from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.sql import ir
from presto_tpu_torch.sql.planner import domains as DOM

SF = 0.01
FUZZ_SEED = 20260817
FUZZ_CHUNKS = 6
ULPS = 4  # DOUBLE results: units in the last place allowed against JAX


@functools.lru_cache(maxsize=None)
def port() -> LocalRunner:
    return LocalRunner(scale_factor=SF, device="cpu")


@functools.lru_cache(maxsize=None)
def ref() -> JaxRunner:
    return JaxRunner(scale_factor=SF)


@functools.lru_cache(maxsize=None)
def sqlite(value_space: bool) -> sqlite3.Connection:
    """The TPC-H tables in SQLite: decimals as unscaled integers (the
    SQLite-diff battery's encoding) or as their values (the fuzzer's)."""
    conn = sqlite3.connect(":memory:", check_same_thread=False)
    conn.execute("PRAGMA case_sensitive_like = ON")
    for t in ("region", "nation", "supplier", "customer", "orders"):
        df = O.load(t, SF)
        conn.execute(f"CREATE TABLE {t} ("
                     + ", ".join(f'"{c}"' for c in df.columns) + ")")

        def enc(c, v):
            if isinstance(v, (int, np.integer)):
                if value_space and c in FZ.DEC_COLS:
                    return int(v) / 10 ** FZ.DEC_COLS[c]
                return int(v)
            return v
        conn.executemany(
            f"INSERT INTO {t} VALUES ({', '.join('?' * len(df.columns))})",
            [tuple(enc(c, v) for c, v in zip(df.columns, row))
             for row in df.itertuples(index=False)])
    conn.commit()
    return conn


def _rows(table) -> list:
    d = table.to_pydict()
    return list(zip(*[d[n] for n in table.names])) if table.names else []


# ------------------------------------------------------ SQLite batteries

@pytest.mark.parametrize("sql", SD.QUERIES)
def test_sqlite_diff_battery(sql):
    got = _rows(port().run_sql(SD.ENGINE_REWRITE.get(sql, sql)))
    want = sqlite(False).execute(sql).fetchall()
    assert SD._norm(got) == SD._norm(want), sql


def _fuzz_queries() -> list:
    gen = FZ.Gen(random.Random(FUZZ_SEED))
    return [gen.query() for _ in range(FZ.N_QUERIES)]


FUZZ = _fuzz_queries()


def _fuzz_rows(table) -> list:
    """The fuzzer's decoding of a result: decimals divided by their
    scale."""
    cols = []
    for n in table.names:
        col = table.columns[n]
        vals = col.to_pylist()
        if T.is_decimal(col.dtype):
            vals = [None if v is None else v / 10 ** col.dtype.scale
                    for v in vals]
        cols.append(vals)
    return list(zip(*cols)) if table.names else []


@pytest.mark.parametrize("chunk", range(FUZZ_CHUNKS))
def test_fuzz_battery(chunk):
    db = sqlite(True)
    per = -(-len(FUZZ) // FUZZ_CHUNKS)
    failures = []
    for sql in FUZZ[chunk * per:(chunk + 1) * per]:
        try:
            want = db.execute(sql).fetchall()
        except sqlite3.Error:
            continue  # as the fuzzer does: SQLite rejects it
        got = _fuzz_rows(port().run_sql(sql))
        if FZ._norm(got) != FZ._norm(want):
            failures.append(sql)
    assert not failures, failures


def test_fuzz_chunks_cover_the_stream():
    assert len(FUZZ) == 120 and len(set(FUZZ)) > 100
    assert any(" in (" in q and "acctbal" in q for q in FUZZ)


# ------------------------------------------------------ function matrix

MATRIX = {f"{k}:{sql}": (sql, exp) for k, cases in
          (("misc", FM.MISC), ("math", FM.MATH), ("bitwise", FM.BITWISE))
          for sql, exp in cases}


@pytest.mark.parametrize("case", MATRIX)
def test_function_matrix_entry(case):
    FM._run_batch(port(), [MATRIX[case]])


def test_scalar_function_assertions():
    TF.test_scalar_functions(port())


# ------------------------------------------------------ IN-list faults

def _count(sql: str) -> int:
    return port().run_sql(sql).row_count


def test_in_list_keeps_a_decimal_literal_scale():
    """``c_nationkey in (1.0)`` is ``= 1`` (the JAX package matched
    nation 10); ``in (1.5)`` matches nothing (it matched nation 15);
    ``o_orderkey in (1.0, 2.0)`` finds orders 1 and 2 (it found none)."""
    c = O.load("customer", SF)
    assert _count("select c_custkey from customer "
                  "where c_nationkey in (1.0)") == int(
                      (c.c_nationkey == 1).sum()) == 64
    assert _count("select c_custkey from customer "
                  "where c_nationkey in (1.5, 2.50)") == 0
    got = port().run_sql("select o_orderkey from orders "
                         "where o_orderkey in (1.0, 2.0) order by 1")
    assert got.to_pydict() == {"o_orderkey": [1, 2]}


@pytest.mark.parametrize("sql", [
    "select c_custkey from customer where c_acctbal in (9894.23, 3404.57)",
    "select c_custkey from customer where c_acctbal in (989423, 1, 2.5)",
    "select c_custkey from customer where c_acctbal in (9894.230, -991.53)",
    "select c_custkey from customer where c_acctbal not in (9894.23) "
    "and c_custkey < 50",
    "select o_orderkey from orders "
    "where o_totalprice in (210337.24, 87516.51)",
])
def test_in_list_over_a_decimal_column_equals_sqlite(sql):
    got = _fuzz_rows(port().run_sql(sql))
    want = sqlite(True).execute(sql).fetchall()
    assert FZ._norm(got) == FZ._norm(want) and (want or "989423" in sql)


@pytest.mark.parametrize("sql", [
    "select c_custkey from customer where c_mktsegment not in "
    "('BUILDING', null)",
    "select c_custkey from customer where c_mktsegment in ('BUILDING', null)",
    "select c_custkey from customer where c_nationkey in (1, null)",
    "select c_custkey from customer where c_nationkey not in (1, null)",
    "select c_custkey, c_nationkey in (1, null) b from customer "
    "where c_custkey < 30",
    "select c_custkey from customer where c_acctbal not in (1.5, null)",
    "select c_custkey from customer where c_name not in "
    "('Customer#000000001', null)",
])
def test_a_null_in_the_list_is_three_valued(sql):
    """A NULL in the list makes every non-match NULL: NOT IN (..., NULL)
    keeps no row (the JAX package kept 1,213, or raised on ``int(None)``
    for an integer column)."""
    got = port().run_sql(sql)
    want = sqlite(True).execute(sql).fetchall()
    assert FZ._norm(_fuzz_rows(got)) == FZ._norm(want)
    if "not in" in sql:
        assert got.row_count == 0


def test_streamed_pruning_rounds_a_decimal_bound():
    """Split pruning takes ``o_orderkey >= 100.5`` as keys >= 101 (the
    JAX package's bound, the unscaled 1005, pruned keys 101-1004)."""
    r = port()
    for sql in ("select count(*) c, sum(o_custkey) s from orders "
                "where o_orderkey >= 100.5",
                "select count(*) c, sum(o_custkey) s from orders "
                "where o_orderkey < 1000.5 and o_orderkey > 3.5",
                "select count(*) c, sum(o_custkey) s from orders "
                "where o_orderkey between 99.5 and 200.25",
                "select count(*) c from orders where o_orderkey = 7.5",
                "select count(*) c from orders "
                "where o_orderkey in (7.5, 32.0)"):
        streamed = r.run_sql_streaming(sql, slice_rows=1000)
        assert r.last_streamed
        assert streamed.to_pydict() == r.run_sql(sql).to_pydict(), sql
    assert streamed.to_pydict() == {"c": [1]}
    o = O.load("orders", SF)
    assert r.run_sql_streaming(
        "select count(*) c from orders where o_orderkey >= 100.5",
        slice_rows=1000).to_pydict() == {
            "c": [int((o.o_orderkey >= 101).sum())]} == {"c": [14972]}


def _col(name, dtype):
    return ir.ColumnRef(name, dtype)


@pytest.mark.parametrize("pred, want", [
    (ir.Compare(">=", _col("k", T.BIGINT), ir.lit_decimal(1005, 1)),
     DOM.Domain(lo=101)),
    (ir.Compare(">", _col("k", T.BIGINT), ir.lit_decimal(1005, 1)),
     DOM.Domain(lo=101)),
    (ir.Compare(">", _col("k", T.BIGINT), ir.lit_decimal(1000, 1)),
     DOM.Domain(lo=101)),
    (ir.Compare("<", _col("k", T.BIGINT), ir.lit_decimal(-1005, 1)),
     DOM.Domain(hi=-101)),
    (ir.Compare("<=", _col("k", T.BIGINT), ir.lit_decimal(-1005, 1)),
     DOM.Domain(hi=-101)),
    (ir.Compare("=", _col("k", T.BIGINT), ir.lit_decimal(15, 1)),
     DOM.Domain(none=True)),
    (ir.Compare("<=", ir.lit_decimal(15, 1), _col("k", T.BIGINT)),
     DOM.Domain(lo=2)),
    (ir.Compare(">=", _col("m", T.decimal(12, 2)), ir.lit_decimal(15, 1)),
     DOM.Domain(lo=150)),
    (ir.Compare("<", _col("m", T.decimal(12, 2)), ir.lit_decimal(15005, 3)),
     DOM.Domain(hi=1500)),
    (ir.Between(_col("k", T.BIGINT), ir.lit_decimal(5, 1),
                ir.lit_decimal(25, 1)), DOM.Domain(1, 2)),
    (ir.InList(_col("k", T.BIGINT), (ir.lit_decimal(15, 1),
                                     ir.Literal(None, T.BIGINT))),
     DOM.Domain(none=True)),
    (ir.InList(_col("k", T.BIGINT), (ir.lit_decimal(20, 1), ir.lit_bigint(7),
                                     ir.Literal(None, T.BIGINT))),
     DOM.Domain(2, 7, frozenset({2, 7}))),
])
def test_domains_are_in_the_column_units(pred, want):
    (name,) = ir.referenced_columns(pred)
    assert DOM.extract(pred) == {name: want}


def test_no_domain_where_the_units_are_unknown():
    d = _col("d", T.DOUBLE)
    assert DOM.extract(ir.Compare(">=", d, ir.lit_decimal(15, 1))) == {}
    assert DOM.extract(ir.InList(_col("k", T.BIGINT),
                                 (ir.lit_string("x"),))) == {}


def test_explain_prints_in_values_as_written():
    plan = port().run_sql(
        "explain select c_custkey from customer where c_acctbal in "
        "(1.5, -0.05, 2) and c_mktsegment in ('A''B', null)").to_pydict()
    text = "\n".join(plan["Query Plan"])
    assert "c_acctbal IN (1.5, -0.05, 2)" in text
    assert "c_mktsegment IN ('A''B', NULL)" in text


# ------------------------------------------------------ scalar functions

@pytest.mark.parametrize("sql, want", [
    ("select mod(c_acctbal, 7) m from customer where c_custkey <= 40", None),
    ("select mod(c_acctbal, -2.5) m from customer where c_custkey <= 40",
     None),
    ("select mod(c_custkey, 0) m from customer where c_custkey <= 3",
     [None] * 3),
])
def test_mod_truncates_at_the_larger_scale(sql, want):
    """Decimal mod at the larger scale, truncated toward zero, typed
    ``decimal(min(p1-s1, p2-s2) + s, s)`` (the JAX package took the
    unscaled value and typed it BIGINT); a zero divisor gives NULL."""
    got = port().run_sql(sql)
    col = got.columns["m"]
    if want is not None:
        assert col.to_pylist() == want
        return
    c = O.load("customer", SF).sort_values("c_custkey")
    c = c[c.c_custkey <= 40]
    den = Decimal(7) if ", 7)" in sql else Decimal("-2.5")
    exp = []
    for v in c.c_acctbal:
        x = Decimal(int(v)) / 100
        q = (x / den).to_integral_value(rounding=ROUND_DOWN)
        exp.append(int((x - q * den) * 100))
    assert col.dtype == T.decimal(15, 2)  # c_acctbal is decimal(15, 2)
    assert sorted(col.to_pylist()) == sorted(exp)


@pytest.mark.parametrize("sql", [
    "select nullif(n_name, 'CHINA') x from nation",
    "select nullif(n_regionkey, 0) x from nation",
    "select nullif(s_acctbal, 4032.68) x from supplier",
    "select nullif(n_name, n_name) x from nation",
    "select greatest(s_acctbal, 0, s_nationkey * 100) g, "
    "least(s_acctbal, -10.5, s_suppkey) l from supplier",
    "select greatest(n_nationkey, n_regionkey * 6, 11) g, "
    "least(n_nationkey, 5) l from nation",
    "select length(n_name) a, lower(n_name) b, length(r_comment) c, "
    "lower(r_comment) d from nation, region where n_regionkey = r_regionkey",
    "select upper(c_name) u, lower(c_name) l, length(c_name) n "
    "from customer where c_custkey < 20",
])
def test_string_and_null_functions_equal_sqlite(sql):
    got = _fuzz_rows(port().run_sql(sql))
    want = sqlite(True).execute(sql.replace("greatest", "max").replace(
        "least", "min")).fetchall()
    assert FZ._norm(got) == FZ._norm(want)


def test_nullif_and_greatest_of_doubles():
    """DOUBLE arguments compare as float64 (the JAX package rescaled them
    as int64)."""
    got = port().run_sql(
        "select nullif(cast(n_nationkey as double) / 4, 0.5) a, "
        "greatest(cast(n_nationkey as double) / 3, 2.5) g, "
        "least(cast(n_nationkey as double) / 3, 2.5) l "
        "from nation order by n_nationkey").to_pydict()
    k = range(25)
    assert got["a"] == [None if x / 4 == 0.5 else x / 4 for x in k]
    assert got["g"] == [max(x / 3, 2.5) for x in k]
    assert got["l"] == [min(x / 3, 2.5) for x in k]


def test_unique_id_is_unique_and_never_renumbered_by_slices_or_partitions():
    """Ids number the rows of the chunk they are evaluated over; where the
    rows would come in several chunks (slices, an operator's partitions),
    the query raises instead of repeating ids."""
    r = port()
    n = O.load("lineitem", SF).shape[0]
    assert r.run_sql("select count(distinct unique_id()) c, count(*) n "
                     "from lineitem").to_pydict() == {"c": [n], "n": [n]}
    with pytest.raises(NotImplementedError, match="streamed scan"):
        r.run_sql_streaming("select count(*) n, min(unique_id()) a, "
                            "max(unique_id()) b from lineitem",
                            slice_rows=1500)
    b = LocalRunner(scale_factor=SF, device="cpu",
                    device_budget_bytes=200 << 10)
    # numbered below the partitioned aggregation: every id once
    got = b.run_sql("select k, count(*) c from (select unique_id() k "
                    "from orders) t group by k having count(*) > 1")
    assert b.last_spill_partitions > 0 and got.row_count == 0
    with pytest.raises(NotImplementedError, match="partitioned aggregation"):
        b.run_sql("select o_orderkey, count(*) c from orders "
                  "group by o_orderkey, unique_id()")


def test_uuid_equals_the_jax_package():
    sql = "select n_nationkey, uuid() u from nation"
    got, want = port().run_sql(sql).to_pydict(), ref().run_sql(sql).to_pydict()
    assert got == want
    assert len(set(got["u"])) == 25 and all(len(u) == 36 for u in got["u"])


def test_typeof_if_ifnull_reach_ported_code():
    got = port().run_sql(
        "select typeof(c_acctbal) t, if(c_acctbal > 0, c_name, 'neg') i, "
        "ifnull(nullif(c_nationkey, 1), -1) f from customer "
        "where c_custkey < 6 order by c_custkey").to_pydict()
    c = O.load("customer", SF).sort_values("c_custkey").head(5)
    assert got["t"] == ["decimal(15,2)"] * 5
    assert got["i"] == [n if a > 0 else "neg"
                        for n, a in zip(c.c_name, c.c_acctbal)]
    assert got["f"] == [-1 if k == 1 else int(k) for k in c.c_nationkey]


# ------------------------------------------------------ string min/max

DICT_MINMAX = ("select l_returnflag, min(l_shipmode) a, max(l_shipmode) b, "
               "min(l_shipinstruct) c, max(l_shipinstruct) d "
               "from lineitem where l_quantity < 4 group by l_returnflag "
               "order by l_returnflag")


def _dict_minmax_oracle():
    li = O.load("lineitem", SF)
    li = li[li.l_quantity < 400]
    g = li.groupby("l_returnflag").agg(
        a=("l_shipmode", "min"), b=("l_shipmode", "max"),
        c=("l_shipinstruct", "min"), d=("l_shipinstruct", "max"))
    return {"l_returnflag": list(g.index),
            **{k: list(g[k]) for k in "abcd"}}


@pytest.mark.parametrize("path", ["grouped", "partitioned", "streamed"])
def test_dict_min_max_by_string(path):
    """By string, not by code (the JAX package reduces codes, and its
    int32 start value wraps: ``max(c_mktsegment)`` was HOUSEHOLD in
    every nation)."""
    want = _dict_minmax_oracle()
    if path == "partitioned":
        r = LocalRunner(scale_factor=SF, device="cpu",
                        device_budget_bytes=600 << 10)
        assert r.run_sql(DICT_MINMAX).to_pydict() == want
        assert r.last_spill_partitions > 0
    elif path == "streamed":
        r = port()
        assert r.run_sql_streaming(DICT_MINMAX,
                                   slice_rows=1500).to_pydict() == want
        assert r.last_streamed
    else:
        assert port().run_sql(DICT_MINMAX).to_pydict() == want


def test_dict_min_max_by_nation_and_globally():
    got = port().run_sql(
        "select c_nationkey, min(c_mktsegment) a, max(c_mktsegment) b "
        "from customer group by c_nationkey order by c_nationkey")
    c = O.load("customer", SF)
    g = c.groupby("c_nationkey").agg(a=("c_mktsegment", "min"),
                                     b=("c_mktsegment", "max"))
    assert got.to_pydict() == {"c_nationkey": [int(x) for x in g.index],
                               "a": list(g.a), "b": list(g.b)}
    r = port()
    sql = ("select min(o_orderpriority) a, max(o_orderpriority) b, "
           "min(o_orderstatus) c from orders where o_orderkey > 100")
    o = O.load("orders", SF)
    o = o[o.o_orderkey > 100]
    want = {"a": [o.o_orderpriority.min()], "b": [o.o_orderpriority.max()],
            "c": [o.o_orderstatus.min()]}
    assert r.run_sql(sql).to_pydict() == want
    assert r.run_sql_streaming(sql, slice_rows=1000).to_pydict() == want
    assert r.run_sql("select min(o_orderstatus) c from orders "
                     "where o_orderkey < 0").to_pydict() == {"c": [None]}


def test_streamed_states_over_different_dictionaries_merge_by_string():
    """Slices whose dictionaries differ concatenate over their union, so
    the merged min/max is by string."""
    def part(strings, codes, groups):
        return TC.Chunk({
            "g": TC.DCol(T.BIGINT, "plain", torch.tensor(groups)),
            "s": TC.DCol(T.VARCHAR, "dict",
                         torch.tensor(codes, dtype=torch.int32),
                         dictionary=TC.Dictionary(np.array(strings,
                                                           dtype=object)))},
            torch.ones(len(codes), dtype=torch.bool))
    cat = ST._cat([part(["z", "b"], [0, 1, 0], [1, 1, 2]),
                   part(["c", "a", "y"], [2, 1, 0], [1, 2, 2])])
    s = cat.cols["s"]
    assert s.kind == "dict"
    assert [s.dictionary[i] for i in s.values.tolist()] == \
        ["z", "b", "z", "y", "a", "c"]
    assert list(s.dictionary.strings) == ["a", "b", "c", "y", "z"]


def test_bytes_min_max_still_raises():
    with pytest.raises(NotImplementedError, match="bytes"):
        port().run_sql("select o_orderpriority, min(o_clerk) c from orders "
                       "group by o_orderpriority")


# ------------------------------------------------------ math and bitwise
# against the JAX package's evaluator, on the same seeded numpy columns

def _double_column(rng, n=600):
    x = np.concatenate([
        rng.normal(0, 3, n), rng.normal(0, 1e6, n // 4),
        rng.uniform(-1.2, 1.2, n // 4),
        [0.0, -0.0, 1.0, -1.0, 0.5, 27.0, -8.0, 1e-300, 1e300, -1e300,
         math.inf, -math.inf, math.nan, math.pi, 710.0, -745.0]])
    return x.astype(np.float64)


def _int_column(rng, n=600):
    edge = [0, 1, -1, 255, -16, 2**62, -2**62, 2**63 - 1, -2**63, 12, 10]
    return np.concatenate([rng.integers(-2**63, 2**63 - 1, n,
                                        dtype=np.int64),
                           rng.integers(-300, 300, n), edge]).astype(np.int64)


def _columns(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    x = _double_column(rng)
    n = x.shape[0]
    y = _double_column(np.random.default_rng(seed + 1))[:n]
    i = _int_column(rng)[:n]
    j = _int_column(np.random.default_rng(seed + 2))[:n]
    k = rng.integers(-5, 70, n).astype(np.int64)
    d = rng.integers(-10**9, 10**9, n).astype(np.int64)  # decimal(12, 2)
    nulls = rng.random(n) < 0.1
    return {"x": x, "y": y, "i": i, "j": j, "k": k, "d": d, "null": nulls}


_TYPES = {"x": "DOUBLE", "y": "DOUBLE", "i": "BIGINT", "j": "BIGINT",
          "k": "BIGINT", "d": "decimal"}


def _both(name: str, cols, rtype: str, lits=()):
    """``name(cols..., lits...)`` through the JAX package's and the port's
    evaluators over the same numpy columns (column ``x`` NULL where
    ``null`` is set); (JAX values, JAX validity, port values, port
    validity) as numpy."""
    data = _columns(7)
    n = data["x"].shape[0]

    def typ(mod, t):
        return {"DOUBLE": mod.DOUBLE, "BIGINT": mod.BIGINT,
                "decimal": mod.decimal(12, 2), "d0": mod.decimal(10, 0),
                "BOOLEAN": mod.BOOLEAN}[t]

    def run(mod, irm, cmod, arr, ev):
        refs = tuple(irm.ColumnRef(c, typ(mod, _TYPES[c])) for c in cols)
        refs += tuple(irm.Literal(v, typ(mod, "BIGINT")) for v in lits)
        chunk = cmod.Chunk({c: cmod.DCol(
            typ(mod, _TYPES[c]), "plain", arr(data[c]),
            validity=arr(~data["null"]) if c == "x" else None)
            for c in cols}, arr(np.ones(n, bool)))
        out = ev(irm.Func(name, refs, typ(mod, rtype)), chunk)
        valid = np.ones(n, bool) if out.validity is None \
            else np.asarray(out.validity)
        return np.asarray(out.values), valid

    jv, jok = run(JT, JIR, JC, jnp.asarray, JE.eval_expr)
    tv, tok = run(T, ir, TC, torch.from_numpy, TE.eval_expr)
    return jv, jok, tv, tok


def _within_ulps(a, b, ulps):
    """Equal (NaN to NaN, an infinity to itself) or within ``ulps`` units
    in the last place of the larger."""
    with np.errstate(invalid="ignore"):
        tol = ulps * np.spacing(np.maximum(np.abs(a), np.abs(b)))
        return (a == b) | (np.isnan(a) & np.isnan(b)) | (np.abs(a - b) <= tol)


DOUBLE_FUNCS = {
    "sqrt": ("x",), "cbrt": ("x",), "exp": ("x",), "ln": ("x",),
    "log10": ("x",), "log2": ("x",), "log": ("y", "x"), "power": ("x", "y"),
    "pow": ("y", "x"), "atan2": ("x", "y"), "sin": ("x",), "cos": ("x",),
    "tan": ("x",), "asin": ("x",), "acos": ("x",), "atan": ("x",),
    "sinh": ("x",), "cosh": ("x",), "tanh": ("x",), "degrees": ("x",),
    "radians": ("x",), "truncate": ("x",), "ceil": ("x",),
    "floor": ("x",), "sign": ("x",), "sqrt_of_decimal": ("d",),
    "ln_of_decimal": ("d",), "exp_of_int": ("k",),
}


# numpy's (the platform libm's) function of the same float64 inputs
NUMPY = {"sqrt": np.sqrt, "cbrt": np.cbrt, "exp": np.exp, "ln": np.log,
         "log10": np.log10, "log2": np.log2,
         "log": lambda b, x: np.log(x) / np.log(b), "power": np.power,
         "pow": np.power, "atan2": np.arctan2, "sin": np.sin, "cos": np.cos,
         "tan": np.tan, "asin": np.arcsin, "acos": np.arccos,
         "atan": np.arctan, "sinh": np.sinh, "cosh": np.cosh,
         "tanh": np.tanh, "degrees": np.degrees, "radians": np.radians,
         "truncate": np.trunc, "ceil": np.ceil, "floor": np.floor,
         "sign": np.sign}


@pytest.mark.parametrize("func", DOUBLE_FUNCS)
def test_double_function_equals_jax(func):
    """Within ``ULPS`` of the JAX package, NULLs and NaNs in the same
    rows; where the JAX package's result is itself more than ``ULPS``
    from numpy's libm (XLA's CPU ``cbrt`` at 1e+-300, ``sinh``/``cosh``
    near overflow: 14-308 ulps), within ``ULPS`` of numpy's instead."""
    name = func.split("_of_")[0]
    cols = DOUBLE_FUNCS[func]
    jv, jok, tv, tok = _both(name, cols, "DOUBLE")
    assert np.array_equal(jok, tok)
    data = _columns(7)
    scale = {"d": 100.0}
    with np.errstate(all="ignore"):
        want = NUMPY[name](*(data[c].astype(np.float64) / scale.get(c, 1.0)
                             for c in cols))
    jax_off = ~_within_ulps(jv, want, ULPS)
    ok = np.where(jax_off, _within_ulps(tv, want, ULPS),
                  _within_ulps(tv, jv, ULPS))
    assert ok[tok].all(), (jv[tok & ~ok][:5], tv[tok & ~ok][:5])
    assert jax_off[tok].sum() <= 8


INT_FUNCS = {
    "bitwise_and": (("i", "j"), "BIGINT"),
    "bitwise_or": (("i", "j"), "BIGINT"),
    "bitwise_xor": (("i", "j"), "BIGINT"), "bitwise_not": (("i",), "BIGINT"),
    "bit_count": (("i",), "BIGINT"),
    "bitwise_left_shift": (("i", "k"), "BIGINT"),
    "bitwise_right_shift": (("i", "k"), "BIGINT"),
    "bitwise_right_shift_arithmetic": (("i", "k"), "BIGINT"),
    "sign": (("i",), "BIGINT"),
    "ceil": (("d",), "d0"), "floor": (("d",), "d0"),
    "greatest": (("i", "j", "k"), "BIGINT"), "least": (("i", "k"), "BIGINT"),
    "is_nan": (("x",), "BOOLEAN"), "is_finite": (("x",), "BOOLEAN"),
    "is_infinite": (("x",), "BOOLEAN"),
}


@pytest.mark.parametrize("func", INT_FUNCS)
def test_integer_function_equals_jax(func):
    cols, rtype = INT_FUNCS[func]
    jv, jok, tv, tok = _both(func, cols, rtype)
    assert np.array_equal(jok, tok)
    assert np.array_equal(jv[jok], tv[tok])


def test_mod_of_integers():
    """Truncated toward zero, against Python (and the JAX package where
    the divisor is positive: for a negative one it takes the quotient's
    sign from the dividend alone, so ``mod(5, -2)`` is 9 there)."""
    jv, jok, tv, tok = _both("mod", ("i", "k"), "BIGINT")
    data = _columns(7)
    i, k = data["i"], data["k"]
    assert np.array_equal(tok, k != 0)
    want = [int(math.copysign(1, a)) * (abs(int(a)) % abs(int(b)))
            for a, b in zip(i[k != 0], k[k != 0])]
    assert tv[tok].tolist() == want
    pos = k > 0
    assert np.array_equal(jv[pos], tv[pos])


def test_width_bucket_against_exact_arithmetic():
    """Against Trino's definition in exact fractions: the JAX package's
    XLA division puts ``width_bucket(1400, 3, 1400, 25)`` in bucket 25
    (1400 is the upper bound: bucket 26)."""
    from fractions import Fraction
    sql = ("select c_custkey k, c_acctbal x, "
           "width_bucket(c_acctbal, -900.0, 9000.5, 7) a, "
           "width_bucket(c_custkey, 3, 1400, 25) b from customer")
    got = port().run_sql(sql).to_pydict()

    def bucket(x, lo, hi, n):
        b = math.floor((x - lo) * n / (hi - lo)) + 1
        return min(max(b, 0), n + 1)
    assert got["a"] == [bucket(Fraction(x, 100), Fraction(-900),
                               Fraction(90005, 10), 7) for x in got["x"]]
    assert got["b"] == [bucket(k, 3, 1400, 25) for k in got["k"]]
    assert set(got["a"]) == set(range(9)) and 26 in got["b"]


@pytest.mark.parametrize("bits", [2, 8, 32, 63, 64])
def test_bit_count_of_a_width_equals_jax(bits):
    jv, jok, tv, tok = _both("bit_count", ("i",), "BIGINT", lits=(bits,))
    assert np.array_equal(jv, tv)
    i = _columns(7)["i"]
    assert tv.tolist() == [bin(int(v) & ((1 << bits) - 1)).count("1")
                           for v in i]


def test_shifts_and_popcount_against_python():
    i, k = _columns(7)["i"], _columns(7)["k"]
    t = torch.from_numpy
    assert TE.popcount64(t(i)).tolist() == [
        bin(int(v) & (2**64 - 1)).count("1") for v in i]
    chunk = TC.Chunk({"i": TC.DCol(T.BIGINT, "plain", t(i)),
                      "k": TC.DCol(T.BIGINT, "plain", t(k))},
                     torch.ones(i.shape[0], dtype=torch.bool))
    refs = (ir.ColumnRef("i", T.BIGINT), ir.ColumnRef("k", T.BIGINT))
    kk = np.clip(k, 0, 63)

    def signed(v):
        v &= 2**64 - 1
        return v - 2**64 if v >= 2**63 else v
    for name, f in (("bitwise_left_shift", lambda a, s: signed(a << s)),
                    ("bitwise_right_shift",
                     lambda a, s: signed((a & (2**64 - 1)) >> s)),
                    ("bitwise_right_shift_arithmetic", lambda a, s: a >> s)):
        got = TE.eval_expr(ir.Func(name, refs, T.BIGINT), chunk).values
        assert got.tolist() == [f(int(a), int(s)) for a, s in zip(i, kk)]


def test_cbrt_is_within_an_ulp_of_the_true_root():
    x = _double_column(np.random.default_rng(11))
    x = x[np.isfinite(x)]
    got = TE.cbrt(torch.from_numpy(x)).numpy()
    want = np.cbrt(x)
    assert _within_ulps(got, want, 1).all()


def test_long_decimal_ceil_floor_sign_mod():
    """The (hi, lo) word paths, against Python integers."""
    from presto_tpu_torch.ops import int128 as I128
    rng = random.Random(5)
    vals = [rng.randrange(-10**35, 10**35) for _ in range(200)]
    vals += [0, 5, -5, 10**21, -10**21, 1]
    words = torch.from_numpy(I128.from_host_ints(vals))
    chunk = TC.Chunk({"v": TC.DCol(T.decimal(38, 4), "plain", words)},
                     torch.ones(len(vals), dtype=torch.bool))
    ref_v = ir.ColumnRef("v", T.decimal(38, 4))

    def run(name, args, rt):
        out = TE.eval_expr(ir.Func(name, args, rt), chunk)
        return [int(x) for x in I128.to_host_ints(out.values.numpy())] \
            if out.values.dim() == 2 else out.values.tolist()
    assert run("floor", (ref_v,), T.decimal(38, 0)) == \
        [v // 10**4 for v in vals]
    assert run("ceil", (ref_v,), T.decimal(38, 0)) == \
        [-((-v) // 10**4) for v in vals]
    assert run("sign", (ref_v,), T.decimal(1, 0)) == \
        [(v > 0) - (v < 0) for v in vals]
    m = ir.lit_decimal(-70001, 2)  # -700.01: mod at scale 4
    assert run("mod", (ref_v, m), T.decimal(38, 4)) == [
        abs(v) % 7000100 * (1 if v >= 0 else -1) for v in vals]
