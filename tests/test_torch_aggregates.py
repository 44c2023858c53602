"""The port's remaining aggregates on the CPU at SF0.01: bool_and/or,
bitwise_and/or_agg, checksum, geometric_mean, the corr family,
min_by/max_by and approx_percentile, grouped and global, with their
streamed states.

- ``ops/agg.py``'s new reductions against the JAX package's over seeded
  numpy inputs, groups with no rows included;
- each aggregate over orders, lineitem and customer columns (integer,
  decimal, DOUBLE, DATE, DICT, BYTES and nullable arguments) through both
  packages' ``run_sql``, each statement once: integers, booleans,
  checksums and percentiles exactly, DOUBLEs to 1e-9 relative;
- ``tests/test_functions.py``'s aggregate tests with their own checks
  (the ``min(x, n)``/``max(x, n)`` columns left out: nested values);
- the JAX package's faults the port does not copy, each held to pandas
  or Python with the JAX package's value asserted beside it: grouped
  min_by/max_by with a DATE or DICT key, geometric_mean's clamp; and
  where the port orders or hashes by value (a DICT percentile by string,
  a DOUBLE checksum by its bits);
- a budget small enough to partition, and the streamed path (PARTIAL
  states per slice, then FINAL), equal to the free path; PARTIAL then
  FINAL over three parts equals the one-shot aggregate for every new
  state.
"""

import functools
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_functions as TF
import tpch_oracle as O
from presto_tpu.exec.runner import LocalRunner as JaxRunner
from presto_tpu.ops import agg as JA
from presto_tpu_torch.data import types as T
from presto_tpu_torch.data.column import Column
from presto_tpu_torch.exec import physical as PH
from presto_tpu_torch.exec import plan as P
from presto_tpu_torch.exec.columns import Chunk, from_host
from presto_tpu_torch.exec.runner import LocalRunner, materialize
from presto_tpu_torch.ops import agg as TA
from presto_tpu_torch.ops import hashing as HASH
from presto_tpu_torch.parallel import distributed as D
from presto_tpu_torch.sql import ir

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import np_tpch_oracle as NO  # noqa: E402

SF = 0.01
REL = 1e-9          # DOUBLE results against the JAX package
STATE_REL = 1e-12   # DOUBLE results, PARTIAL → FINAL against one-shot
LAST_ORDER = 60000  # the last o_orderkey at SF0.01


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's CPU ops on one thread while this module runs: beside the
    other test workers, each on its own cores, a pool of threads per
    worker spins and slows the whole run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def port() -> LocalRunner:
    return LocalRunner(scale_factor=SF, device="cpu")


@functools.lru_cache(maxsize=None)
def ref() -> JaxRunner:
    return JaxRunner(scale_factor=SF)


def _cols(table) -> dict:
    return {name: col.to_pylist() for name, col in table.columns.items()}


def _close(a, b, rel) -> bool:
    if a is None or b is None or not isinstance(a, float):
        return a == b
    return (math.isnan(a) and math.isnan(b)) or math.isclose(
        a, b, rel_tol=rel, abs_tol=0.0) or a == b


def _same(got: dict, want: dict, rel=REL) -> None:
    assert list(got) == list(want)
    for c in got:
        assert len(got[c]) == len(want[c]), c
        bad = [(x, y) for x, y in zip(got[c], want[c])
               if not _close(x, y, rel)]
        assert not bad, (c, bad[:3])


# ---------------------------------------------------------------- ops

def _seg_inputs(seed: int, n: int = 600, groups: int = 40):
    """Seeded values over the whole int64 range, group ids with -1 and
    ids past ``groups`` (dropped) and ids never drawn (empty groups)."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)
    vals[::7] = rng.integers(0, 16, len(vals[::7]))
    group = rng.integers(-1, groups + 4, n).astype(np.int32)
    group[np.isin(group, (3, 11, 17))] = 5  # groups 3, 11, 17: no row
    mask = rng.random(n) > 0.2
    mask[group == 9] = False  # group 9: rows, all masked out
    return vals, group, mask, groups


@pytest.mark.parametrize("op", ["bitand", "bitor"])
def test_seg_bitwise_equals_jax(op):
    vals, group, mask, cap = _seg_inputs(1)
    got = getattr(TA, f"seg_{op}")(torch.from_numpy(vals),
                                   torch.from_numpy(group),
                                   torch.from_numpy(mask), cap).numpy()
    # one compiled program: op by op, the scan compiles each step apart
    want = np.asarray(jax.jit(getattr(JA, f"seg_{op}"), static_argnums=3)(
        jnp.asarray(vals), jnp.asarray(group), jnp.asarray(mask), cap))
    np.testing.assert_array_equal(got, want)
    ident = -1 if op == "bitand" else 0
    assert (got[[3, 9, 11, 17]] == ident).all()
    f = np.bitwise_and if op == "bitand" else np.bitwise_or
    assert got[5] == f.reduce(vals[(group == 5) & mask])


def test_seg_any_equals_jax():
    vals, group, mask, cap = _seg_inputs(2)
    flags = (vals & 3) == 0
    got = TA.seg_any(torch.from_numpy(flags), torch.from_numpy(group),
                     torch.from_numpy(mask), cap).numpy()
    want = np.asarray(JA.seg_any(jnp.asarray(flags), jnp.asarray(group),
                                 jnp.asarray(mask), cap))
    np.testing.assert_array_equal(got, want)
    assert not got[[3, 9, 11, 17]].any()


@pytest.mark.parametrize("n", [0, 1, 2, 3, 1000, 1025])
@pytest.mark.parametrize("op", ["bitand", "bitor"])
def test_g_bitwise_equals_jax(op, n):
    vals, _, mask, _ = _seg_inputs(3, max(n, 1))
    vals, mask = vals[:n], mask[:n]
    got = int(getattr(TA, f"g_{op}")(torch.from_numpy(vals),
                                     torch.from_numpy(mask)))
    if n:
        want = int(getattr(JA, f"g_{op}")(jnp.asarray(vals),
                                          jnp.asarray(mask)))
        assert got == want
    assert got == (np.bitwise_and if op == "bitand" else np.bitwise_or
                   ).reduce(vals[mask], initial=-1 if op == "bitand" else 0)


def test_checksum_hash_is_the_oracles():
    """``tools/np_tpch_oracle.py``'s numpy checksum terms equal the
    port's on seeded int64 keys."""
    rng = np.random.default_rng(4)
    keys = rng.integers(-2**63, 2**63 - 1, 5000, dtype=np.int64)
    keys[:4] = (0, -1, 2**63 - 1, -2**63)
    got = PH.checksum_terms(PH.DCol(T.BIGINT, "plain",
                                    torch.from_numpy(keys))).numpy()
    np.testing.assert_array_equal(NO.checksum_terms(keys), got)
    np.testing.assert_array_equal(NO.hash_i64(keys),
                                  HASH.hash_i64(torch.from_numpy(keys)))
    assert NO.checksum(keys) == int(got.sum())


@pytest.mark.parametrize("layout", ["dict", "bytes", "wide_bytes"])
def test_string_hash_is_the_oracles(layout):
    """The numpy string hash equals the port's ``value_hash`` of seeded
    strings (lengths 0-29, across pack edges) as a DICT, as BYTES and as
    BYTES padded wider: one hash per string, whatever the layout."""
    rng = np.random.default_rng(5)
    strs = ["".join(chr(97 + x) for x in rng.integers(0, 26, k))
            for k in rng.integers(0, 30, 400)] + ["", "a" * 8, "a" * 9]
    uniq = np.array(sorted(set(strs)), dtype=object)
    codes = np.searchsorted(uniq.astype(str), np.array(strs, dtype=str))
    c = from_host(Column(T.varchar(40), codes.astype(np.int32),
                         np.ones(len(strs), bool), "dict",
                         dictionary=uniq), "cpu")
    if layout != "dict":
        c = PH.dcol_to_bytes(c)
    if layout == "wide_bytes":
        c = PH.DCol(c.dtype, c.kind, torch.nn.functional.pad(
            c.values, (0, 13)), c.lengths, c.validity)
    np.testing.assert_array_equal(PH.value_hash(c),
                                  NO.hash_strings(strs).astype(np.int64))


# ---------------------------------------------------------------- SQL

ORDERS = ("bool_and(o_totalprice > 100000) ba, "
          "bool_or(o_shippriority = 1) bo, bitwise_and_agg(o_custkey) ban, "
          "bitwise_or_agg(o_custkey) bor, "
          "checksum(o_orderkey) ck, checksum(o_orderdate) ckd, "
          "checksum(o_totalprice) ckp, geometric_mean(o_totalprice) gm, "
          "corr(o_totalprice, o_custkey) c, "
          "covar_samp(o_totalprice, o_custkey) cs, "
          "covar_pop(o_totalprice, o_custkey) cp, "
          "regr_slope(o_totalprice, o_custkey) rs, "
          "regr_intercept(o_totalprice, o_custkey) ri, "
          "min_by(o_orderkey, o_totalprice) mnk, "
          "max_by(o_clerk, o_totalprice) mxc, "
          "min_by(o_orderdate, o_custkey) mnd, "
          "approx_percentile(o_totalprice, 0.5) p50, "
          "approx_percentile(o_orderdate, 0.9) p90, "
          "approx_percentile(o_orderkey, 0.1) p10, "
          "approx_percentile(cast(o_totalprice as double), 0.3) pdb, "
          "min_by(o_orderdate, cast(o_totalprice as double)) mnb, "
          "geometric_mean(cast(o_custkey as double)) gmd")
LINEITEM = ("bool_and(l_shipdate < l_receiptdate) ba, "
            "bool_or(l_discount > 0.09) bo, "
            "bitwise_and_agg(l_partkey) ban, bitwise_or_agg(l_suppkey) bor, "
            "checksum(l_quantity) ckq, geometric_mean(l_quantity) gq, "
            "geometric_mean(l_extendedprice) ge, "
            "corr(cast(l_extendedprice as double), l_quantity) c, "
            "regr_slope(l_extendedprice, l_discount) rs, "
            "covar_pop(l_quantity, l_tax) cp, "
            "min_by(l_orderkey, cast(l_extendedprice as double)) mnk, "
            "max_by(l_shipdate, l_extendedprice) mxd, "
            "max_by(l_comment, l_partkey) mxc, "
            "approx_percentile(cast(l_extendedprice as double), 0.5) pd, "
            "approx_percentile(l_quantity, 0.75) pq, "
            "approx_percentile(l_shipdate, 0.25) ps")
# every argument NULL in nation 1's group: each aggregate NULL there;
# the CASE arguments NULL in some rows of every group
BY_NATION = ("checksum(nullif(c_nationkey, 1)) ck, "
             "bool_and(nullif(c_nationkey, 1) > 3) ba, "
             "bool_or(nullif(c_nationkey, 1) > 20) bo, "
             "bitwise_or_agg(nullif(c_nationkey, 1)) bor, "
             "bitwise_and_agg(nullif(c_nationkey, 1)) ban, "
             "geometric_mean(nullif(c_nationkey, 1) + 1) gm, "
             "corr(nullif(c_nationkey, 1), c_acctbal) c, "
             "min_by(c_custkey, nullif(c_nationkey, 1)) mnk, "
             "max_by(nullif(c_nationkey, 1), c_custkey) mxv, "
             "approx_percentile(nullif(c_nationkey, 1), 0.5) p, "
             "checksum(case when c_acctbal > 0 then c_custkey end) ckc, "
             "approx_percentile(case when c_acctbal > 0 then c_acctbal end, "
             "0.5) pc, "
             "min_by(c_name, case when c_acctbal > 0 then c_acctbal end) mnn")
CUSTOMER = ("bitwise_and_agg(c_nationkey) ban, "
            "bitwise_or_agg(c_nationkey) bor, checksum(c_acctbal) ck, "
            "corr(c_acctbal, c_nationkey) c, "
            "covar_samp(c_acctbal, c_custkey) cs, "
            "min_by(c_name, c_acctbal) mnn, max_by(c_custkey, c_acctbal) mxk, "
            "approx_percentile(c_acctbal, 0.5) p, bool_and(c_acctbal > 0) ba, "
            "bool_or(c_acctbal > 9990) bo, "
            "regr_intercept(c_acctbal, c_nationkey) ri")
STATEMENTS = {
    "orders_grouped": f"select o_orderpriority, {ORDERS} from orders "
                      "group by o_orderpriority order by o_orderpriority",
    "orders_global": f"select {ORDERS} from orders",
    "lineitem_grouped": f"select l_returnflag, l_linestatus, {LINEITEM} "
                        "from lineitem group by 1, 2 order by 1, 2",

    "customer_grouped": f"select c_mktsegment, {CUSTOMER} from customer "
                        "group by 1 order by 1",
    "customer_global": f"select {CUSTOMER} from customer",
    "customer_by_nation": f"select c_nationkey, {BY_NATION} from customer "
                          "group by 1 order by 1",
}


@pytest.mark.parametrize("name", list(STATEMENTS))
def test_statement_equals_jax(name):
    sql = STATEMENTS[name]
    got = port().run_sql(sql)
    want = ref().run_sql(sql)
    for c in got.columns:
        assert str(got.columns[c].dtype) == str(want.columns[c].dtype), c
    _same(_cols(got), _cols(want))
    if name == "customer_by_nation":
        row = _cols(got)
        assert row["c_nationkey"][1] == 1
        assert all(row[c][1] is None for c in row
                   if c not in ("c_nationkey", "ckc", "pc", "mnn"))


TF_CHECKS = ["test_extended_aggregates", "test_min_by_max_by",
             "test_min_by_global", "test_approx_percentile",
             "test_approx_percentile_global", "test_corr_family",
             "test_scalar_functions", "test_date_parts",
             "test_grouping_sets", "test_show_stats_and_global_distinct"]


@pytest.mark.parametrize("name", TF_CHECKS)
def test_functions_checks(name):
    """``tests/test_functions.py``'s test, its own checks, run through
    the port."""
    getattr(TF, name)(port())


def test_checksum_bitwise_geomean():
    """``test_functions.test_minn_maxn_checksum_bitwise_geomean``'s checks
    less its ``min(x, n)``/``max(x, n)`` columns (nested values: not in
    the port yet)."""
    o = O.load("orders", SF)
    t = port().run_sql(
        "select o_orderpriority p, bitwise_and_agg(o_custkey) ba, "
        "bitwise_or_agg(o_custkey) bo, checksum(o_orderkey) ck, "
        "geometric_mean(o_shippriority + 1) gm "
        "from orders group by o_orderpriority order by p").to_pandas()
    for row in t.itertuples():
        grp = o[o.o_orderpriority == row.p]
        assert row.ba == int(np.bitwise_and.reduce(grp.o_custkey.values))
        assert row.bo == int(np.bitwise_or.reduce(grp.o_custkey.values))
        assert abs(row.gm - 1.0) < 1e-9
    t2 = port().run_sql(
        "select o_orderpriority p, checksum(o_orderkey) ck from orders "
        "group by o_orderpriority order by p").to_pandas()
    assert t.ck.tolist() == t2.ck.tolist()
    g = port().run_sql("select bitwise_or_agg(o_custkey) bo "
                       "from orders").to_pandas()
    assert g.bo.iloc[0] == int(np.bitwise_or.reduce(o.o_custkey.values))


# ---------------------------------------------------------------- faults

def _first_at_extreme(df, by: str, key, value: str, fn):
    """{group: value of the first row (table order) whose key is the
    group's extreme}, the key a Series over ``df``'s rows."""
    out = {}
    for g, part in df.groupby(by):
        k = key.loc[part.index]
        out[g] = int(part.loc[k[k == fn(k)].index[0], value])
    return out


MIN_BY_FAULTS = {
    "date_key": ("select o_orderpriority, min_by(o_orderkey, o_orderdate) a, "
                 "max_by(o_orderkey, o_orderdate) b from orders group by 1",
                 lambda o: o, "o_orderdate"),
    "date_key_filtered": ("select o_orderpriority, "
                          "min_by(o_orderkey, o_orderdate) a, "
                          "max_by(o_orderkey, o_orderdate) b from orders "
                          "where o_orderkey < 100 group by 1",
                          lambda o: o[o.o_orderkey < 100], "o_orderdate"),
    "dict_key": ("select o_orderpriority, "
                 "min_by(o_orderkey, o_orderstatus) a, "
                 "max_by(o_orderkey, o_orderstatus) b from orders group by 1",
                 lambda o: o, "o_orderstatus"),
}


@pytest.mark.parametrize("case", list(MIN_BY_FAULTS))
def test_min_by_fault_not_copied(case):
    """Grouped min_by/max_by with an int32 (DATE) or DICT key: the JAX
    package starts seg_min/seg_max at a wrapped -1/0 and returns the
    table's last key, 60000, in every group; the port returns the key of
    the first row attaining the group's extreme (a string key by its
    string)."""
    sql, rows, key = MIN_BY_FAULTS[case]
    df = rows(O.load("orders", SF))
    want_a = _first_at_extreme(df, "o_orderpriority", df[key], "o_orderkey",
                               lambda k: k.min())
    want_b = _first_at_extreme(df, "o_orderpriority", df[key], "o_orderkey",
                               lambda k: k.max())
    got = _cols(port().run_sql(sql))
    assert dict(zip(got["o_orderpriority"], got["a"])) == want_a
    assert dict(zip(got["o_orderpriority"], got["b"])) == want_b
    assert LAST_ORDER not in got["a"]
    jax = _cols(ref().run_sql(sql))
    assert set(jax["a"]) == {LAST_ORDER}  # the JAX package's fault


GEOMEAN_FAULTS = {
    "zeros": ("select geometric_mean(o_shippriority) g from orders",
              0.0, 1e-300),
    "negatives": ("select geometric_mean(c_acctbal) g from customer",
                  math.nan, 1.197e-22),
}


@pytest.mark.parametrize("case", list(GEOMEAN_FAULTS))
def test_geometric_mean_fault_not_copied(case):
    """geometric_mean is exp(Σ ln x / n), as Trino's: 0 when a value is 0
    (ln 0 = -inf), NaN when one is negative; the JAX package clamps
    ``log(max(x, 1e-300))``."""
    sql, want, jax_value = GEOMEAN_FAULTS[case]
    (got,) = _cols(port().run_sql(sql))["g"]
    assert (math.isnan(got) if math.isnan(want) else got == want)
    (jax,) = _cols(ref().run_sql(sql))["g"]
    assert math.isclose(jax, jax_value, rel_tol=1e-3)


def test_corr_family_of_decimals_is_exact():
    """The corr family of two decimals from exact int128 moment sums: the
    intercept of price on quantity (small beside the mean price) to 2 ulps
    of the rational answer; the JAX package's one-pass float formula is
    1e-12 off there."""
    from fractions import Fraction
    sql = ("select l_returnflag, regr_intercept(l_extendedprice, "
           "l_quantity) ri, regr_slope(l_extendedprice, l_quantity) rs, "
           "corr(l_extendedprice, l_quantity) c from lineitem group by 1 "
           "order by 1")
    li = O.load("lineitem", SF)
    got, jax = _cols(port().run_sql(sql)), _cols(ref().run_sql(sql))
    jax_err = []
    for i, g in enumerate(got["l_returnflag"]):
        part = li[li.l_returnflag == g]
        x, y = part.l_quantity.to_numpy(), part.l_extendedprice.to_numpy()
        n, sx, sy = len(x), int(x.sum()), int(y.sum())
        sxx, sxy = int((x * x).sum()), int((x * y).sum())
        dxx = n * sxx - sx * sx
        ri = float(Fraction(sy * sxx - sx * sxy, dxx * 100))
        rs = float(Fraction(n * sxy - sx * sy, dxx))
        assert math.isclose(got["ri"][i], ri, rel_tol=4.5e-16)
        assert math.isclose(got["rs"][i], rs, rel_tol=4.5e-16)
        jax_err.append(abs(jax["ri"][i] - ri) / abs(ri))
    assert max(jax_err) > 1e-12


def test_geometric_mean_of_a_long_decimal():
    """A decimal(38, 2) argument (which the JAX package cannot take)
    against numpy."""
    o = O.load("lineitem", SF)
    (got,) = _cols(port().run_sql(
        "select geometric_mean(l_tax + 0.01) g from lineitem"))["g"]
    want = math.exp(math.fsum(np.log((o.l_tax + 1) / 100.0)) / len(o))
    assert math.isclose(got, want, rel_tol=1e-9)


def test_dict_percentile_orders_by_string():
    """approx_percentile of a DICT column orders by string (the port's
    rule for DICT min/max); the JAX package orders by dictionary code."""
    sql = ("select o_orderpriority, approx_percentile(o_orderstatus, 0.5) s "
           "from orders group by 1 order by 1")
    o = O.load("orders", SF)
    want = {}
    for g, part in o.groupby("o_orderpriority"):
        v = sorted(part.o_orderstatus)
        want[g] = v[max(math.ceil(0.5 * len(v)) - 1, 0)]
    got = _cols(port().run_sql(sql))
    assert dict(zip(got["o_orderpriority"], got["s"])) == want
    assert set(_cols(ref().run_sql(sql))["s"]) == {"F"}  # by code


def test_checksum_of_double_hashes_its_bits():
    """A DOUBLE's checksum hashes its order-preserving bits, so 0.25 and
    0.5 differ; the JAX package truncates a DOUBLE to an integer first,
    so both checksum as 0."""
    sql = ("select checksum(cast(n_nationkey as double) / 4) c from nation "
           "where n_nationkey in (1, 2)")
    (got,) = _cols(port().run_sql(sql))["c"]
    bits = np.array([0.25, 0.5]).view(np.int64)
    img = np.where(bits < 0, bits ^ (2**63 - 1), bits)
    terms = PH.checksum_terms(PH.DCol(T.BIGINT, "plain",
                                      torch.from_numpy(img)))
    assert got == int(terms.sum())
    (jax,) = _cols(ref().run_sql(sql))["c"]
    zero = PH.checksum_terms(PH.DCol(T.BIGINT, "plain",
                                     torch.zeros(2, dtype=torch.int64)))
    assert jax == int(zero.sum()) != got


def _split2(s: str):
    """``split_part(s, ' ', 2)``: NULL past the last field."""
    parts = s.split(" ")
    return parts[1] if len(parts) > 1 else None


# string checksums: base DICT and BYTES columns and a host-mapped DICT
# (``split_part``: each chunk's own dictionary of its distinct results)
STRING_SQL = ("select o_orderpriority, checksum(o_orderstatus) s, "
              "checksum(o_clerk) c, checksum(o_comment) m, "
              "checksum(split_part(o_comment, ' ', 2)) p, "
              "approx_distinct(split_part(o_comment, ' ', 2)) d "
              "from orders group by 1 order by 1")


def test_string_checksum_hashes_the_string():
    """A string's checksum hashes its own bytes (numpy's
    ``np_tpch_oracle.hash_strings``), whatever its layout; the JAX
    package hashes a DICT's code and a BYTES value's padded packs."""
    o = O.load("orders", SF)
    got = _cols(port().run_sql(STRING_SQL))
    for i, g in enumerate(got["o_orderpriority"]):
        part = o[o.o_orderpriority == g]
        split = [v for v in map(_split2, part.o_comment) if v is not None]
        assert got["s"][i] == NO.checksum(strings=part.o_orderstatus)
        assert got["c"][i] == NO.checksum(strings=part.o_clerk)
        assert got["m"][i] == NO.checksum(strings=part.o_comment)
        assert got["p"][i] == NO.checksum(strings=split)
    jax = _cols(ref().run_sql("select o_orderpriority, "
                              "checksum(o_orderstatus) s from orders "
                              "group by 1 order by 1"))
    assert jax["s"] != got["s"]


@pytest.mark.parametrize("path", ["streamed", "budgeted"])
def test_string_checksum_over_slices_and_partitions(path):
    """Slices and hash partitions each hold their own dictionary of
    ``split_part``'s results; the checksum and approx_distinct of those
    strings equal the whole run's."""
    if path == "streamed":
        r = port()
        got = _cols(r.run_sql_streaming(STRING_SQL, slice_rows=5000))
        assert r.last_streamed
    else:
        # the budget holds o_comment (1.23 MB), not the working set
        r = LocalRunner(scale_factor=SF, device="cpu",
                        device_budget_bytes=3 << 19)
        got = _cols(r.run_sql(STRING_SQL))
        assert r.last_spill_partitions > 1
    assert got == _cols(port().run_sql(STRING_SQL))


@pytest.mark.parametrize("key", ["c_name",
                                 "cast(c_acctbal as decimal(38, 2))"])
@pytest.mark.parametrize("func", ["min_by", "max_by"])
def test_min_by_unported_key_raises(func, key):
    sql = f"select c_mktsegment, {func}(c_custkey, {key}) k from customer " \
          "group by 1"
    with pytest.raises(NotImplementedError, match=func):
        port().run_sql(sql)
    with pytest.raises(NotImplementedError, match=func):
        port().run_sql(f"select {func}(c_custkey, {key}) k from customer")


def test_weighted_percentile_raises():
    """approx_percentile(x, w, p) weights x; the JAX package's planner
    reads the weight as the percentile (2: the largest value).  The port
    raises for the weighted form and for a percentile outside [0, 1]."""
    with pytest.raises(NotImplementedError, match="weight"):
        port().run_sql("select approx_percentile(n_nationkey, 2, 0.5) p "
                       "from nation")
    with pytest.raises(ValueError, match="between 0 and 1"):
        port().run_sql("select approx_percentile(n_nationkey, 2) p "
                       "from nation")
    assert _cols(ref().run_sql("select approx_percentile(n_nationkey, 2, "
                               "0.5) p from nation"))["p"] == [24]


# ---------------------------------------------------------------- tiers

# each budget holds the statement's widest column, not its working set
BUDGETED = {"orders_grouped": 512 << 10, "customer_grouped": 200 << 10}


@pytest.mark.parametrize("name", list(BUDGETED))
def test_budgeted_equals_free(name):
    """Under a budget small enough to partition, the grouped aggregates
    run one hash partition of the group keys at a time, equal."""
    r = LocalRunner(scale_factor=SF, device="cpu",
                    device_budget_bytes=BUDGETED[name])
    got = _cols(r.run_sql(STATEMENTS[name]))
    assert r.last_spill_partitions > 1
    _same(got, _cols(port().run_sql(STATEMENTS[name])), 1e-12)


STREAMED = {
    "bool_bits_checksum": ("select l_returnflag, l_linestatus, "
                           "bool_and(l_quantity < 5000) a, "
                           "bool_or(l_discount > 0.09) b, "
                           "bitwise_and_agg(l_partkey) c, "
                           "bitwise_or_agg(l_partkey) d, "
                           "checksum(l_orderkey) e, "
                           "count(*) n from lineitem group by 1, 2 "
                           "order by 1, 2", True),
    "moments": ("select l_returnflag, corr(l_extendedprice, l_quantity) c, "
                "covar_samp(l_extendedprice, l_quantity) cs, "
                "covar_pop(l_extendedprice, l_quantity) cp, "
                "regr_slope(l_extendedprice, l_quantity) rs, "
                "regr_intercept(l_extendedprice, l_quantity) ri, "
                "geometric_mean(l_quantity) g from lineitem group by 1 "
                "order by 1", True),
    "global_bits": ("select checksum(l_orderkey) c, "
                    "bool_and(l_quantity > 0) b, "
                    "bool_or(l_tax > 0.07) o, bitwise_or_agg(l_suppkey) s "
                    "from lineitem where l_shipmode = 'AIR'", True),
    # a global aggregation streams through the same states as one group
    "global_moments": ("select corr(l_extendedprice, l_quantity) c, "
                       "regr_intercept(l_extendedprice, l_quantity) ri, "
                       "geometric_mean(l_quantity) g, stddev(l_tax) sd, "
                       "approx_distinct(split_part(l_comment, ' ', 1)) ad, "
                       "max(l_shipdate) m from lineitem", True),
    # test_functions.test_moment_aggs_distribute_partial_final's SQL: the
    # JAX package runs it partial -> final across a mesh
    "moment_aggs_partial_final": ("select o_orderpriority, "
                                  "stddev(o_totalprice) sd, "
                                  "var_pop(o_totalprice) vp, "
                                  "corr(o_totalprice, o_custkey) c, "
                                  "bool_and(o_totalprice > 0) ba, "
                                  "bool_or(o_shippriority = 1) bo "
                                  "from orders group by o_orderpriority "
                                  "order by o_orderpriority", True),
    "percentile_runs_whole": ("select o_orderpriority, "
                              "approx_percentile(o_totalprice, 0.5) p, "
                              "min_by(o_orderkey, o_totalprice) k "
                              "from orders group by 1 order by 1", False),
}


@pytest.mark.parametrize("name", list(STREAMED))
def test_streamed_equals_run_sql(name):
    """Slice by slice (PARTIAL states, merged eagerly, FINAL) equals the
    whole run; approx_percentile and min_by have no state, so their plan
    runs whole."""
    sql, streamed = STREAMED[name]
    r = port()
    got = _cols(r.run_sql_streaming(sql, slice_rows=5000))  # 3 slices
    assert r.last_streamed is streamed
    _same(got, _cols(r.run_sql(sql)), REL)


# ------------------------------------------------------ the slice as a
# whole: the card's ``aggregates_patterns`` statements at SF0.01

@functools.lru_cache(maxsize=None)
def _slice_oracle() -> dict:
    return NO.aggregates_patterns(NO.Tables(port().datasource))


@pytest.mark.parametrize("name", NO.AGGREGATES_PATTERNS)
def test_chip_statement_equals_its_oracle(name):
    """Each statement the card runs equals the numpy/Python oracle it is
    held to there: exactly, DOUBLEs to 1e-12 relative (the corr family
    of int64 arguments and geometric_mean's logarithms sum exactly); a
    streamed one also through ``run_sql_streaming``."""
    sql = NO.AGGREGATES_PATTERNS[name]
    want = _slice_oracle()[name]
    runs = [port().run_sql(sql)]
    if name in NO.AGGREGATES_STREAMED:
        runs.append(port().run_sql_streaming(sql, slice_rows=5000))
        assert port().last_streamed
    for table in runs:
        _same(_cols(table), want, 1e-12)


# ---------------------------------------------------------------- states

N_ROWS = 900
PARTS = (0, 250, 600, N_ROWS)  # three slices, PARTIAL each


@functools.lru_cache(maxsize=None)
def _inputs():
    """Seeded columns: 13 group keys and a NULL group, int64 and DOUBLE
    values with NULLs, a bool, a positive decimal, a DICT column and
    small integers; some rows masked out."""
    rng = np.random.default_rng(20261018)
    n = N_ROWS
    cols = {
        "g": Column(T.BIGINT, rng.integers(0, 13, n).astype(np.int64),
                    rng.random(n) > 0.1),
        "i": Column(T.BIGINT, rng.integers(-2**62, 2**62, n).astype(np.int64),
                    rng.random(n) > 0.1),
        "x": Column(T.DOUBLE, rng.normal(3.0, 2.0, n), rng.random(n) > 0.1),
        "y": Column(T.DOUBLE, rng.normal(-1.0, 5.0, n), rng.random(n) > 0.1),
        "p": Column(T.decimal(12, 2), rng.integers(1, 10**6, n).astype(
            np.int64), rng.random(n) > 0.1),
        "b": Column(T.BOOLEAN, rng.random(n) > 0.3, rng.random(n) > 0.1),
        "s": Column(T.varchar(8), rng.integers(0, 4, n).astype(np.int32),
                    rng.random(n) > 0.1, "dict",
                    dictionary=np.array(["ant", "bee", "cat", "dog"],
                                        dtype=object)),
    }
    mask = rng.random(n) > 0.05
    # small integers, a few negative: the exact corr path, and a
    # geometric_mean that is NaN in some groups
    cols["q"] = Column(T.INTEGER, rng.integers(-1, 40, n).astype(np.int32),
                       rng.random(n) > 0.1)
    return cols, mask


def _chunk(lo: int, hi: int) -> Chunk:
    cols, mask = _inputs()
    out = {}
    for name, c in cols.items():
        part = Column(c.dtype, c.values[lo:hi], c.validity[lo:hi], c.kind,
                      dictionary=c.dictionary)
        out[name] = from_host(part, "cpu")
    return Chunk(out, torch.from_numpy(mask[lo:hi]))


def _ref(name: str) -> ir.ColumnRef:
    return ir.ColumnRef(name, _inputs()[0][name].dtype)


STATE_CASES = [("corr", "y", "x"), ("covar_samp", "x", "p"),
               ("covar_pop", "y", "i"), ("regr_slope", "y", "x"),
               ("regr_intercept", "p", "x"), ("checksum", "i", None),
               ("checksum", "s", None), ("checksum", "x", None),
               ("geometric_mean", "p", None), ("geometric_mean", "y", None),
               ("bitwise_and_agg", "i", None), ("bitwise_or_agg", "i", None),
               ("bool_and", "b", None), ("bool_or", "b", None),
               ("regr_intercept", "p", "q"), ("covar_samp", "q", "p"),
               ("corr", "q", "i"), ("geometric_mean", "q", None)]


@pytest.mark.parametrize("func,arg,arg2", STATE_CASES,
                         ids=[f"{f}_{a}" for f, a, _ in STATE_CASES])
def test_partial_final_equals_one_shot(func, arg, arg2):
    spec = P.AggSpec("a", func, _ref(arg),
                     arg2=None if arg2 is None else _ref(arg2))
    plan = P.PhysHashAggregate(None, (("g", _ref("g")),), (spec,), 64)
    ctx = PH.ExecContext(None)
    one_shot = PH.execute(P.PhysHashAggregate(
        P.PhysMaterial(_chunk(0, N_ROWS)), plan.groups, plan.aggs, 64), ctx)
    parts, specs = [], None
    for lo, hi in zip(PARTS, PARTS[1:]):
        part, specs, overflow = D.partial_agg_states(plan, _chunk(lo, hi), 64)
        assert overflow is None or not bool(overflow)
        parts.append(part)
    merged, _ = D.merge_agg_states(plan, PH.concat_chunks(parts), specs, 64)
    got = _cols(materialize(merged, ctx))
    want = _cols(materialize(one_shot, ctx))
    got, want = (dict(sorted(zip(c["g"], c["a"]), key=repr))
                 for c in (got, want))
    assert got.keys() == want.keys() and len(got) == 14  # and the NULL group
    for k in want:
        assert _close(got[k], want[k], STATE_REL), (k, got[k], want[k])
    assert any(v is not None for v in got.values())
