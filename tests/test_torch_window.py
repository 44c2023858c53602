"""Windows and GROUPING SETS in ``presto_tpu_torch`` on the CPU.

- Every function of ``presto_tpu_torch/ops/window.py`` against its
  namesake in ``presto_tpu/ops/window.py`` on the same seeded numpy
  inputs: sorted keys with runs of peers, single-row partitions and
  partitions with no valid value, and ROWS / RANGE / GROUPS frames with
  preceding and following offsets.  Integers are compared exactly,
  DOUBLE values to 1e-9 relative.
- The SQL of ``tests/test_window.py`` and ``tests/test_grouping_sets.py``
  (ROLLUP with ``grouping()``, CUBE on one runner, a window over an
  aggregate), plus the window functions no TPC-DS query calls, through
  both packages' ``run_sql`` at SF0.01, tolerance 0, one JAX query per
  test.
- Where the port departs from the JAX package on purpose, an oracle holds
  it: a NULL order key sorts after every value in both directions, in a
  window and in ORDER BY (SQLite with an explicit ``NULLS LAST``); rows
  that are masked out never join the last partition (a Python oracle);
  a window sum of a negative long decimal (Python ``decimal``).
- ``PhysWindow`` and ``PhysGroupId`` read nothing on the host.
"""

import sqlite3
from decimal import Decimal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu.exec.runner import LocalRunner as JaxRunner
from presto_tpu.ops import window as JW
from presto_tpu_torch.data import types as TT
from presto_tpu_torch.exec import columns as TC
from presto_tpu_torch.exec import physical as TP
from presto_tpu_torch.exec import plan as TPL
from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.ops import window as TW
from presto_tpu_torch.sql import ir

SF = 0.01
REL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port():
    return LocalRunner(scale_factor=SF, device="cpu")


@pytest.fixture(scope="module")
def ref():
    return JaxRunner(scale_factor=SF)


def t(a):
    return torch.from_numpy(np.array(a))


def j(a):
    return jnp.asarray(a)


def same(got, want):
    """A torch result (tensor or tuple) equal to the JAX one: exact for
    integers and booleans, 1e-9 relative for floats."""
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            same(g, w)
        return
    g, w = got.numpy(), np.asarray(want)
    assert g.shape == w.shape
    if g.dtype.kind == "f":
        np.testing.assert_allclose(g, w, rtol=REL, atol=0)
    else:
        np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64))


# ---------------------------------------------------------------- ops

SIZES = (1, 2, 9, 64, 300)


def _layout(n: int, desc: bool = False) -> dict:
    """Sorted (partition, order) keys of ``n`` rows: partitions of 1-13
    rows (many of one row), order keys with runs of peers (descending
    within each partition when ``desc``), integer and float values, a
    validity with one partition all NULL, and the boundaries."""
    rng = np.random.default_rng(n + 1000 * desc)
    sizes = []
    while sum(sizes) < n:
        sizes.append(int(rng.choice([1, 1, 2, 3, 5, 8, 13])))
    sizes[-1] -= sum(sizes) - n
    part = np.repeat(np.arange(len(sizes)), sizes).astype(np.int64)
    order = np.concatenate([np.cumsum(rng.integers(0, 3, s))
                            for s in sizes]).astype(np.int64)
    if desc:
        order = np.concatenate([o[::-1] for o in np.split(
            order, np.cumsum(sizes)[:-1])])
    valid = rng.random(n) < 0.7
    valid[part == part[n // 2]] = False   # a partition with no valid value
    mask = np.ones(n, bool)
    jps, jpe = JW.make_boundaries([j(part), j(order)], 1, j(mask))
    return dict(part=part, order=order, mask=mask, valid=valid,
                ints=rng.integers(-1000, 1000, n).astype(np.int64),
                floats=rng.normal(0, 100, n),
                ps=np.asarray(jps), peer=np.asarray(jpe))


@pytest.fixture(scope="module", params=SIZES)
def lay(request):
    return _layout(request.param)


ROWS_FRAMES = [
    ("rows", ("unbounded_preceding", None), ("current", None)),
    ("rows", ("preceding", 2), ("following", 1)),
    ("rows", ("following", 1), ("following", 3)),
    ("rows", ("preceding", 3), ("preceding", 1)),
    ("rows", ("current", None), ("unbounded_following", None)),
]
RANGE_FRAMES = [
    ("range", ("preceding", 2), ("current", None)),
    ("range", ("preceding", 1), ("following", 1)),
    ("range", ("following", 1), ("following", 3)),
    ("range", ("current", None), ("unbounded_following", None)),
]
GROUPS_FRAMES = [
    ("groups", ("preceding", 1), ("current", None)),
    ("groups", ("current", None), ("following", 2)),
    ("groups", ("following", 1), ("following", 2)),
    ("groups", ("preceding", 2), ("preceding", 1)),
    ("groups", ("unbounded_preceding", None), ("following", 1)),
]


def test_make_boundaries_equal_jax(lay):
    got = TW.make_boundaries([t(lay["part"]), t(lay["order"])], 1,
                             t(lay["mask"]))
    same(got, (lay["ps"], lay["peer"]))
    assert (got[0].numpy() >= 0).all()


@pytest.mark.parametrize("fn", ["row_number", "peer_ends",
                                "partition_counts"])
def test_one_index_functions_equal_jax(lay, fn):
    idx = lay["peer"] if fn == "peer_ends" else lay["ps"]
    same(getattr(TW, fn)(t(idx)), getattr(JW, fn)(j(idx)))


@pytest.mark.parametrize("fn", ["rank", "dense_rank", "percent_rank",
                                "cume_dist"])
def test_rank_family_equal_jax(lay, fn):
    same(getattr(TW, fn)(t(lay["ps"]), t(lay["peer"])),
         getattr(JW, fn)(j(lay["ps"]), j(lay["peer"])))


@pytest.mark.parametrize("k", [1, 3, 7])
def test_ntile_equals_jax(lay, k):
    same(TW.ntile(t(lay["ps"]), k), JW.ntile(j(lay["ps"]), jnp.int64(k)))


@pytest.mark.parametrize("offset", [-2, -1, 1, 3])
def test_shifts_equal_jax(lay, offset):
    v, ok = TW.shift_in_partition(t(lay["ints"]), t(lay["ps"]), offset)
    wv, wok = JW.shift_in_partition(j(lay["ints"]), j(lay["ps"]), offset)
    same((v, ok), (wv, wok))
    v, ok = TW.kth_nonnull_shift(t(lay["ints"]), t(lay["valid"]),
                                 t(lay["ps"]), offset)
    wv, wok = JW.kth_nonnull_shift(j(lay["ints"]), j(lay["valid"]),
                                   j(lay["ps"]), offset)
    same(ok, wok)
    # a value nobody finds comes from a spare slot: compare the found
    np.testing.assert_array_equal(v.numpy()[ok.numpy()],
                                  np.asarray(wv)[np.asarray(wok)])


@pytest.mark.parametrize("values", ["ints", "floats"])
def test_running_and_total_sums_equal_jax(lay, values):
    v, m, ps = lay[values], lay["valid"], lay["ps"]
    same(TW.running_sum(t(v), t(ps), t(m)), JW.running_sum(j(v), j(ps), j(m)))
    cnt = np.asarray(JW.partition_total(j(v), j(ps), j(m), "count"))
    for func in ("sum", "count", "min", "max"):
        got = TW.partition_total(t(v), t(ps), t(m), func)
        want = JW.partition_total(j(v), j(ps), j(m), func)
        if func in ("min", "max"):  # a partition with no value: no result
            got, want = got[t(cnt > 0)], np.asarray(want)[cnt > 0]
        same(got, want)


@pytest.mark.parametrize("values", ["ints", "floats"])
@pytest.mark.parametrize("maximum", [False, True])
def test_segmented_cummin_equals_jax(lay, values, maximum):
    v, ps = lay[values], lay["ps"]
    same(TW.segmented_cummin(t(v), t(ps), maximum),
         JW.segmented_cummin(j(v), j(ps), maximum))


@pytest.mark.parametrize("frame", ROWS_FRAMES, ids=str)
def test_rows_frames_equal_jax(lay, frame):
    lo, hi = TW.frame_bounds(t(lay["ps"]), frame)
    same((lo, hi), JW.frame_bounds(j(lay["ps"]), frame))
    for v in (lay["ints"], lay["floats"]):
        same(TW.framed_sum(t(v), t(lay["valid"]), lo, hi),
             JW.framed_sum(j(v), j(lay["valid"]), j(lo.numpy()),
                           j(hi.numpy())))
    for first in (True, False):
        pos, ok = TW.nonnull_frame_edge(t(lay["valid"]), lo, hi, first)
        wpos, wok = JW.nonnull_frame_edge(j(lay["valid"]), j(lo.numpy()),
                                          j(hi.numpy()), first)
        same((pos, ok), (wpos, wok))


@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("frame", RANGE_FRAMES, ids=str)
def test_range_frames_equal_jax(frame, desc):
    for n in SIZES:
        lay = _layout(n, desc)
        got = TW.range_frame_bounds(t(lay["ps"]), t(lay["peer"]),
                                    t(lay["order"]), frame, desc)
        same(got, JW.range_frame_bounds(j(lay["ps"]), j(lay["peer"]),
                                        j(lay["order"]), frame, desc))


@pytest.mark.parametrize("frame", GROUPS_FRAMES, ids=str)
def test_groups_frames_equal_jax(lay, frame):
    got = TW.groups_frame_bounds(t(lay["ps"]), t(lay["peer"]), frame)
    same(got, JW.groups_frame_bounds(j(lay["ps"]), j(lay["peer"]), frame))


def test_first_geq_equals_jax(lay):
    rng = np.random.default_rng(len(lay["ps"]))
    pe = np.asarray(JW.peer_ends(j(lay["ps"])))
    target = lay["order"] + rng.integers(-3, 4, len(pe))
    got = TW._first_geq(t(lay["order"]), t(lay["ps"]), t(pe), t(target))
    same(got, JW._first_geq(j(lay["order"]), j(lay["ps"]), j(pe),
                            j(target)))


@pytest.mark.parametrize("k", [1, 2, 4])
def test_nth_nonnull_equals_the_jax_inline_code(lay, k):
    """nth_value IGNORE NULLS, which ``_window_traced`` computes inline:
    the same steps on the JAX side."""
    v, ps = lay["valid"], lay["ps"]
    pe = np.asarray(JW.peer_ends(j(lay["peer"])))
    pos, ok = TW.nth_nonnull(t(v), t(ps), t(pe), k)
    n = len(v)
    cnt = np.cumsum(v)
    before = np.where(ps > 0, cnt[np.maximum(ps - 1, 0)], 0)
    tgt = before + k - 1
    nz = np.nonzero(v)[0]
    want_pos = np.where(tgt < len(nz), nz[np.clip(tgt, 0, max(len(nz) - 1,
                                                              0))]
                        if len(nz) else 0, n)
    want_ok = (tgt < cnt[pe]) & (want_pos <= pe)
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    np.testing.assert_array_equal(pos.numpy()[want_ok], want_pos[want_ok])


# ---------------------------------------------------------------- SQL

WINDOW_SQL = {
    # tests/test_window.py, each with an ORDER BY on a unique key so that
    # the two engines' rows compare in order
    "row_number_rank": """
    select o_custkey, o_orderdate, o_totalprice,
      row_number() over (partition by o_custkey order by o_orderdate, o_orderkey) as rn,
      rank() over (partition by o_custkey order by o_orderdate) as rk,
      dense_rank() over (partition by o_custkey order by o_orderdate) as drk
    from orders where o_custkey <= 50 order by o_custkey, rn""",
    "partition_total_and_running_sum": """
    select o_orderkey, o_custkey, o_totalprice,
      sum(o_totalprice) over (partition by o_custkey) as cust_total,
      count(*) over (partition by o_custkey) as cust_orders,
      sum(o_totalprice) over (partition by o_custkey order by o_orderkey) as run
    from orders where o_custkey <= 20 order by o_orderkey""",
    "lead_lag_first": """
    select o_orderkey, o_custkey,
      lag(o_orderkey) over (partition by o_custkey order by o_orderkey) as prev_o,
      lead(o_orderkey) over (partition by o_custkey order by o_orderkey) as next_o,
      first_value(o_orderkey) over (partition by o_custkey order by o_orderkey) as first_o
    from orders where o_custkey <= 20 order by o_orderkey""",
    "rows_frames": """
    select o_orderkey, o_custkey, o_totalprice,
      sum(o_totalprice) over (partition by o_custkey order by o_orderkey
         rows between 1 preceding and current row) s2,
      min(o_totalprice) over (partition by o_custkey order by o_orderkey) mn,
      max(o_totalprice) over (partition by o_custkey order by o_orderkey
         rows between unbounded preceding and current row) mx
    from orders where o_custkey <= 15 order by o_orderkey""",
    "range_frames_value_offsets": """
    select o_orderkey, o_custkey, o_orderdate, o_totalprice,
      sum(o_totalprice) over (partition by o_custkey order by o_orderdate
         range between 90 preceding and current row) s_back,
      count(*) over (partition by o_custkey order by o_orderdate
         range between 30 preceding and 30 following) c_win,
      sum(o_totalprice) over (partition by o_custkey order by o_orderdate desc
         range between 90 preceding and current row) s_desc
    from orders where o_custkey <= 40 order by o_orderkey""",
    "range_current_row_includes_peers": """
    select o_orderkey, o_orderpriority, o_totalprice,
      sum(o_totalprice) over (order by o_orderpriority
         range between current row and current row) peers_sum
    from orders where o_custkey <= 10 order by o_orderkey""",
    "groups_frame": """
    select o_orderkey, o_custkey, o_orderpriority, o_totalprice,
      sum(o_totalprice) over (partition by o_custkey
         order by o_orderpriority
         groups between 1 preceding and current row) g1,
      count(*) over (partition by o_custkey order by o_orderpriority
         groups between current row and 1 following) g2
    from orders where o_custkey <= 30 order by o_orderkey""",
    # ``nullif(x, 0)`` of the original, written as the CASE the port's
    # planner rewrites it to
    "ignore_nulls": """
    select o_orderkey,
      lag(case when o_shippriority = 0 then null else o_shippriority end)
        ignore nulls over (partition by o_custkey order by o_orderkey) ln,
      lag(case when o_totalprice = 0 then null else o_totalprice end)
        ignore nulls over (partition by o_custkey order by o_orderkey) lp,
      first_value(case when o_totalprice = 0 then null else o_totalprice
        end) ignore nulls over (partition by o_custkey order by o_orderkey) fv
    from orders where o_custkey <= 40 order by o_orderkey""",
    # tests/test_grouping_sets.py
    "rollup_values": """
    select l_returnflag f, l_linestatus s, sum(l_quantity) q,
      grouping(l_returnflag, l_linestatus) g
    from lineitem group by rollup(l_returnflag, l_linestatus)
    order by g, f, s""",
    "cube": """
    select o_orderstatus s, o_orderpriority p, count(*) c
    from orders group by cube(o_orderstatus, o_orderpriority)
    order by s, p""",
    "window_over_agg_partitioned": """
    select o_orderstatus st, o_orderpriority p, count(*) c,
      sum(count(*)) over (partition by o_orderstatus) tot
    from orders group by o_orderstatus, o_orderpriority
    order by st, p""",
    # the window functions no TPC-DS query calls
    "rank_family_and_values": """
    select o_orderkey, o_custkey,
      percent_rank() over (partition by o_custkey order by o_orderdate) pr,
      cume_dist() over (partition by o_custkey order by o_orderdate) cd,
      ntile(3) over (partition by o_custkey order by o_orderdate) nt,
      last_value(o_orderkey) over (partition by o_custkey order by o_orderdate) lv,
      nth_value(o_totalprice, 2) over (partition by o_custkey order by o_orderdate) nv,
      lead(o_orderdate, 2) over (partition by o_custkey order by o_orderdate) ld
    from orders where o_custkey <= 60 order by o_orderkey""",
    "partition_aggregates": """
    select o_orderkey,
      avg(o_totalprice) over (partition by o_orderpriority) a,
      min(o_orderdate) over (partition by o_orderpriority) mn,
      max(o_totalprice) over (partition by o_orderpriority) mx,
      count(o_clerk) over (partition by o_orderpriority) c,
      avg(o_totalprice) over (partition by o_orderpriority order by o_orderkey
        rows between 2 preceding and 2 following) ma,
      sum(o_shippriority) over (partition by o_orderpriority, o_orderstatus) s,
      sum(cast(o_totalprice as double)) over (partition by o_orderstatus) d
    from orders where o_orderkey < 3000 order by o_orderkey""",
    "window_over_a_string_order_key": """
    select c_custkey, c_mktsegment,
      rank() over (partition by c_mktsegment order by c_name desc) r,
      row_number() over (partition by c_nationkey order by c_phone) rn,
      first_value(c_custkey) over (partition by c_mktsegment order by c_acctbal) fv
    from customer where c_custkey < 400 order by c_custkey""",
}


@pytest.mark.parametrize("name", sorted(WINDOW_SQL))
def test_window_sql_equals_jax_engine(port, ref, name):
    got, want = port.run_sql(WINDOW_SQL[name]), ref.run_sql(WINDOW_SQL[name])
    assert list(got.columns) == list(want.columns)
    for c in got.columns:
        assert str(got.columns[c].dtype) == str(want.columns[c].dtype), c
        g, w = got.columns[c].to_pylist(), want.columns[c].to_pylist()
        if c in ("pr", "cd", "d"):  # DOUBLE
            np.testing.assert_allclose(np.array(g, float), np.array(w, float),
                                       rtol=REL, atol=0, err_msg=c)
        else:
            assert g == w, c
    assert got.row_count > 0


# ------------------------------------------------ divergences, oracles

NULL_KEY = """select o_orderkey, k, rank() over (order by k{d}) rk
from (select case when o_custkey > 700 then o_custkey end k, o_orderkey
      from orders where o_orderkey < 100) t"""


def _orders_db(port):
    host = port.datasource.read_host("orders", ("o_orderkey", "o_custkey"))
    conn = sqlite3.connect(":memory:")
    conn.execute("create table orders (o_orderkey, o_custkey)")
    conn.executemany("insert into orders values (?, ?)", zip(
        host["o_orderkey"].to_pylist(), host["o_custkey"].to_pylist()))
    return conn


def _rows(table):
    return list(zip(*(table.columns[n].to_pylist() for n in table.names)))


@pytest.mark.parametrize("d", ["", " desc"])
def test_window_ranks_a_null_order_key_last(port, d):
    """A NULL order key ranks after every value in both directions, as in
    Trino (the JAX package ranks the NULL rows 1, ascending)."""
    got = sorted(_rows(port.run_sql(NULL_KEY.format(d=d))))
    conn = _orders_db(port)
    want = sorted(conn.execute(NULL_KEY.format(d=d + " nulls last")))
    assert got == want
    non_null = sum(1 for _, k, _ in got if k is not None)
    assert {rk for _, k, rk in got if k is None} == {non_null + 1}
    assert 0 < non_null < len(got)


@pytest.mark.parametrize("d", ["", " desc"])
def test_order_by_puts_a_null_key_last(port, d):
    """ORDER BY puts NULLs last in both directions (the JAX package puts
    them first under DESC), in row order against SQLite."""
    sql = ("select o_orderkey, k from (select case when o_custkey > 700 "
           "then o_custkey end k, o_orderkey from orders where o_orderkey "
           "< 300) t order by k{d}, o_orderkey")
    got = _rows(port.run_sql(sql.format(d=d)))
    want = _orders_db(port).execute(sql.format(d=d + " nulls last")).fetchall()
    assert got == want
    assert got[-1][1] is None and got[0][1] is not None


def _masked_chunk():
    """Seven live rows in partitions 1, 2 and 3, then three masked-out
    rows that share the last partition's key."""
    k = np.array([3, 1, 2, 1, 3, 2, 3, 3, 3, 3], np.int64)
    o = np.array([5, 2, 1, 1, 4, 1, 4, 0, 9, 4], np.int64)
    x = np.array([30, 10, 20, 11, 31, 21, 32, 90, 91, 92], np.int64)
    mask = np.array([True] * 7 + [False] * 3)
    cols = {n: TC.DCol(TT.BIGINT, "plain", t(v))
            for n, v in (("k", k), ("o", o), ("x", x))}
    return TC.Chunk(cols, t(mask)), k[:7], o[:7], x[:7]


def _ref(name):
    return ir.ColumnRef(name, TT.BIGINT)


def test_masked_out_rows_never_join_the_last_partition():
    chunk, k, o, x = _masked_chunk()
    whole = (("rows", ("unbounded_preceding", None),
              ("unbounded_following", None)))
    specs = (
        TPL.WindowSpec("cnt", "count_star"),
        TPL.WindowSpec("rn", "row_number"),
        TPL.WindowSpec("rk", "rank"),
        TPL.WindowSpec("pr", "percent_rank"),
        TPL.WindowSpec("cd", "cume_dist"),
        TPL.WindowSpec("nt", "ntile", offset=2),
        TPL.WindowSpec("sm", "sum", _ref("x"), frame=whole),
        TPL.WindowSpec("mx", "max", _ref("x"), frame=whole),
        TPL.WindowSpec("lv", "last_value", _ref("x")),
        TPL.WindowSpec("ld", "lead", _ref("x")),
    )
    out = TP.window(chunk, TPL.PhysWindow(None, (_ref("k"),),
                                          ((_ref("o"), False),), specs))
    got = {s.name: out.cols[s.name].values[:7].tolist() for s in specs}
    valid = {s.name: out.cols[s.name].valid_or_true()[:7].tolist()
             for s in specs}
    for i in range(7):
        part = sorted(range(7), key=lambda r: (o[r], r))
        part = [r for r in part if k[r] == k[i]]
        m = len(part)
        peers_before = sum(1 for r in part if o[r] < o[i])
        peers_upto = sum(1 for r in part if o[r] <= o[i])
        pos = part.index(i)
        assert got["cnt"][i] == peers_upto  # default frame: up to peers
        assert got["rn"][i] == pos + 1
        assert got["rk"][i] == peers_before + 1
        assert got["pr"][i] == (peers_before / (m - 1) if m > 1 else 0.0)
        assert got["cd"][i] == peers_upto / m
        assert got["nt"][i] == (1 if pos < (m + 1) // 2 else 2)
        assert got["sm"][i] == sum(x[r] for r in part)
        assert got["mx"][i] == max(x[r] for r in part)
        last_peer = max((r for r in part if o[r] == o[i]), key=part.index)
        assert got["lv"][i] == x[last_peer]
        assert valid["ld"][i] == (pos + 1 < m)
        if pos + 1 < m:
            assert got["ld"][i] == x[part[pos + 1]]


def test_window_sum_of_a_negative_long_decimal(port):
    """A window sum or avg of a long decimal is a DOUBLE (as in the JAX
    package), near the exact value: the JAX package's fold of the two
    words adds 2^64 to the low word as a float, which loses a small
    negative value (-1588469.76 for -1588495.85 here)."""
    sql = ("select o_orderkey, o_orderstatus, sum(cast(o_totalprice as "
           "decimal(38,2)) * -1) over (partition by o_orderstatus) s, "
           "avg(cast(o_totalprice as decimal(38,2)) - 200000) over "
           "(partition by o_orderstatus) a from orders where o_orderkey < 40 "
           "order by o_orderkey")
    got = port.run_sql(sql)
    assert str(got.columns["s"].dtype) == "double"
    host = port.datasource.read_host(
        "orders", ("o_orderkey", "o_orderstatus", "o_totalprice"))
    rows = [(k, st, Decimal(p) / 100) for k, st, p in zip(
        *(host[c].to_pylist() for c in
          ("o_orderkey", "o_orderstatus", "o_totalprice"))) if k < 40]
    for k, st, s, a in zip(*(got.columns[c].to_pylist()
                             for c in ("o_orderkey", "o_orderstatus", "s",
                                       "a"))):
        part = [p for _, s2, p in rows if s2 == st]
        assert s == pytest.approx(float(-sum(part)), rel=1e-12)
        assert a == pytest.approx(float(sum(p - 200000 for p in part)
                                        / len(part)), rel=1e-12)
    assert min(got.columns["s"].to_pylist()) < -1e6


def test_value_functions_over_string_columns(port):
    """first_value and lag gather a BYTES or DICT column whole (the JAX
    package gathers only one-word values), against the host columns."""
    got = port.run_sql(
        "select c_custkey, first_value(c_name) over (partition by "
        "c_mktsegment order by c_acctbal, c_custkey) fv, lag(c_mktsegment) "
        "over (partition by c_nationkey order by c_custkey) lg "
        "from customer where c_custkey < 400 order by c_custkey")
    names = ("c_custkey", "c_name", "c_mktsegment", "c_nationkey",
             "c_acctbal")
    host = port.datasource.read_host("customer", names)
    rows = [r for r in zip(*(host[c].to_pylist() for c in names))
            if r[0] < 400]
    want_fv, want_lg = [], []
    for key, _, seg, nat, _ in sorted(rows):
        first = min((r for r in rows if r[2] == seg),
                    key=lambda r: (r[4], r[0]))
        want_fv.append(first[1])
        prev = [r for r in rows if r[3] == nat and r[0] < key]
        want_lg.append(max(prev)[2] if prev else None)
    assert got.columns["fv"].to_pylist() == want_fv
    assert got.columns["lg"].to_pylist() == want_lg
    assert {got.columns[c].kind for c in ("fv", "lg")} == {"bytes", "dict"}


def _find(plan, cls):
    if isinstance(plan, cls):
        return plan
    for c in plan.children():
        hit = _find(c, cls)
        if hit is not None:
            return hit
    return None


@pytest.mark.parametrize("name, cls", [
    ("row_number_rank", TPL.PhysWindow),
    ("range_frames_value_offsets", TPL.PhysWindow),
    ("rollup_values", TPL.PhysGroupId),
    ("cube", TPL.PhysGroupId)])
def test_window_and_groupid_read_nothing_on_the_host(port, name, cls):
    node = _find(port.plan_sql(WINDOW_SQL[name]), cls)
    assert node is not None
    counts = []
    for plan in (node.child, node):
        ctx = TP.ExecContext(port.datasource)
        out = TP.execute(plan, ctx)
        counts.append(ctx.host_syncs)
    assert counts[0] == counts[1]
    assert out.n_rows > 0
