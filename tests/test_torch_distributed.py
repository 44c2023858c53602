"""The port's multi-rank execution (``presto_tpu_torch/parallel/distributed.py``)
held to the port's single-device runner and to the JAX package.

Every case of ``tests/test_distributed.py`` runs through the port: worlds
of CPU ranks (gloo, ``device="cpu"``, one torch thread each), each rank a
process of ``python -m presto_tpu_torch.parallel.worker``, at SF0.01.  A
world runs once per session (``torch_dist_ranks.cached_world``) and its
statements' results are compared here:

- against ``LocalRunner(device="cpu")``, which the other ``test_torch_*``
  files hold to the JAX package: all 22 TPC-H queries PARTITIONED
  (``broadcast_row_limit=3000``), Q1/3/7/13/17/18/20/21 REPLICATED,
  smaller per-rank builds under PARTITIONED for Q3/5/9/18, TopN, the
  range-partitioned sort, the partitioned window, the nested aggregates,
  the UNNEST round trip, a mark join under OR, the moment families and
  bools merged from their states (grouped and global), the percentile
  sketch forced on (groups within its sample, exactly; groups eight
  times its sample, at a stated rank tolerance), cached shards and
  bounded ingest; one batch at world 3, which catches routing that
  assumes a power of two;
- against the JAX package's ``DistributedRunner`` on a 4-device mesh of
  the conftest's 8 virtual CPU devices, at the same limit, for Q3, Q13,
  Q18 and the order-statistics statements.

Tolerance: 0 (integers, decimals, strings, dates bit for bit, row order
wherever the statement orders), except DOUBLE values, whose sums run in
another order over several ranks: 1e-12 relative.
"""

import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.parallel.worker import table_values
from presto_tpu_torch.tpch.queries import QUERIES

SF = 0.01
REL = 1e-12  # DOUBLE values: the merge order differs from one device's

ORDER_STAT_SQL = """
 select o_orderpriority p, min_by(o_orderkey, o_totalprice) mnk,
        max_by(o_orderkey, o_totalprice) mxk,
        approx_percentile(o_totalprice, 0.5) med,
        stddev(o_totalprice) sd, bool_or(o_shippriority = 1) bo
 from orders group by o_orderpriority order by o_orderpriority
"""

GLOBAL_STAT_SQL = """
 select min_by(o_orderkey, o_totalprice) mnk,
        approx_percentile(o_totalprice, 0.25) q1, variance(o_totalprice) v
 from orders
"""

# the moment families and bools through their merged states, grouped and
# global (one-row partials gathered, no rows)
MOMENT_AGGS = ("variance(o_totalprice) v, stddev_pop(o_totalprice) sp, "
               "corr(o_totalprice, o_custkey) c, "
               "regr_slope(o_totalprice, o_custkey) rs, "
               "geometric_mean(o_totalprice) gm, "
               "bool_and(o_shippriority = 0) ba, "
               "bool_or(o_orderstatus = 'P') bo")
MOMENTS = {"moments": f"select o_orderpriority p, {MOMENT_AGGS} from orders "
                      "group by o_orderpriority",
           "global_moments": f"select {MOMENT_AGGS} from orders"}

RANGE_SORT_SQL = ("select l_orderkey, l_extendedprice from lineitem "
                  "order by l_extendedprice desc, l_orderkey")
WINDOW_SQL = ("select o_custkey, o_orderkey, rank() over "
              "(partition by o_custkey order by o_totalprice desc) r "
              "from orders")
NESTED_SQL = [
    "select n_regionkey, array_agg(n_nationkey) a from nation "
    "group by n_regionkey",
    "select n_regionkey, map_agg(n_name, n_nationkey) m from nation "
    "group by n_regionkey",
    "select histogram(o_orderpriority) h from orders",
    "select array_agg(r_regionkey) a from region",
    "select o_orderpriority, array_agg(o_shippriority) a from orders "
    "group by o_orderpriority",
]
UNNEST_SQL = ("select t.e from (select n_regionkey k, "
              "array_agg(n_nationkey) a from nation group by n_regionkey) s "
              "cross join unnest(s.a) as t(e)")
MARK_SQL = ("select count(*) c from customer "
            "where c_nationkey = 0 or c_custkey in "
            "(select o_custkey from orders where o_totalprice > 400000)")
SKETCH_SQL = ("select o_custkey k, approx_percentile(o_totalprice, 0.5) med "
              "from orders group by o_custkey")
# groups of about 8,500 rows against a forced sample of SKETCH_K entries
SKETCH_K = 1024
SKETCH_Q = (0.1, 0.5, 0.9)
SKETCH_BIG_SQL = ("select l_shipmode m, " + ", ".join(
    f"approx_percentile(l_extendedprice, {q}) p{i}"
    for i, q in enumerate(SKETCH_Q))
    + ", approx_percentile(l_quantity, 0.5) q from lineitem "
    "group by l_shipmode")
BIGINT_SUM_SQL = ("select sum(l_orderkey) s, count(*) c from lineitem "
                  "where l_shipdate <= date '1998-09-02'")
# where the JAX package's multi-device path raises, the port's raises too
RAISES = {
    "full_join": ("select count(*) c from nation n full join region r "
                  "on n.n_regionkey = r.r_regionkey", "FULL JOIN"),
    "match_recognize": ("select c, mlen from orders match_recognize ("
                        "partition by o_custkey order by o_orderkey "
                        "measures o_custkey as c, count(*) as mlen "
                        "one row per match after match skip past last row "
                        "pattern (d+ u+) "
                        "define d as o_totalprice < prev(o_totalprice), "
                        "u as o_totalprice > prev(o_totalprice))",
                        "PhysMatchRecognize"),
    "uuid": ("select count(distinct uuid()) c from nation", "uuid"),
}
BROADCAST = [1, 3, 7, 13, 17, 18, 20, 21]
SHRINK = [3, 5, 9, 18]
TOPN = [2, 3, 10, 18, 21]
CACHE_SQL = [QUERIES[6], QUERIES[6], QUERIES[1], QUERIES[1], QUERIES[6]]
WORLD3 = {f"q{q}": QUERIES[q] for q in (1, 3, 5, 9, 13, 18, 21)}
WORLD3.update(order_stat=ORDER_STAT_SQL, range_sort=RANGE_SORT_SQL,
              window=WINDOW_SQL, nested=NESTED_SQL[1], mark=MARK_SQL)

RUNNERS = {"part": {"broadcast_row_limit": 3000},
           "bcast": {"broadcast_row_limit": 1 << 40},
           "tiny": {"broadcast_row_limit": 1000}}


def _sql(name, runner, sql, **kw):
    return dict(name=name, runner=runner, sql=sql, **kw)


QUERY_SPEC = {"runners": RUNNERS, "jobs": (
    [_sql(f"part{q}", "part", QUERIES[q]) for q in range(1, 23)]
    + [_sql(f"bcast{q}", "bcast", QUERIES[q])
       for q in sorted(set(BROADCAST) | set(SHRINK))]
    + [_sql(f"tiny{q}", "tiny", QUERIES[q]) for q in SHRINK])}

SHAPE_SPEC = {"runners": RUNNERS, "jobs": (
    [_sql("order_stat", "part", ORDER_STAT_SQL),
     _sql("global_stat", "part", GLOBAL_STAT_SQL),
     _sql("range_sort", "part", RANGE_SORT_SQL),
     _sql("window", "part", WINDOW_SQL),
     _sql("unnest", "part", UNNEST_SQL),
     _sql("mark", "part", MARK_SQL),
     _sql("mark_bcast", "bcast", MARK_SQL),
     _sql("bigint_sum", "part", BIGINT_SUM_SQL)]
    + [_sql(k, "part", s) for k, s in MOMENTS.items()]
    + [_sql(f"nested{i}", "part", s) for i, s in enumerate(NESTED_SQL)]
    + [_sql(k, "part", s, catch=True) for k, (s, _) in RAISES.items()]
    + [{"name": "sketch", "call": "tests.torch_dist_ranks:sketch",
        "args": {"sql": SKETCH_SQL}},
       {"name": "sketch_big", "call": "tests.torch_dist_ranks:sketch",
        "args": {"sql": SKETCH_BIG_SQL, "k": SKETCH_K}},
       {"name": "cache", "call": "tests.torch_dist_ranks:shard_cache",
        "args": {"statements": CACHE_SQL}},
       {"name": "ingest", "call": "tests.torch_dist_ranks:bounded_ingest",
        "args": {"slice_rows": 1000}}])}

WORLD3_SPEC = {"runners": RUNNERS, "jobs": [
    _sql(k, "part", s) for k, s in WORLD3.items()]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="session")
def world_root(tmp_path_factory):
    return R.shared_root(tmp_path_factory)


def _results(world_root, name, world, spec):
    data = R.cached_world(world_root, name, world, spec)
    assert data["world"] == world
    return {r["name"]: r for r in data["results"]}


@pytest.fixture
def queries(world_root):
    return _results(world_root, "queries4", 4, QUERY_SPEC)


@pytest.fixture
def shapes(world_root):
    return _results(world_root, "shapes4", 4, SHAPE_SPEC)


@pytest.fixture
def world3(world_root):
    return _results(world_root, "world3", 3, WORLD3_SPEC)


@pytest.fixture(scope="module")
def local():
    return LocalRunner(scale_factor=SF, device="cpu")


def _coarse(v):
    if isinstance(v, float):
        return float(f"{v:.9g}")
    if isinstance(v, list):
        return [_coarse(x) for x in v]
    return v


def _close(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return a == b or abs(a - b) <= REL * max(abs(a), abs(b)) \
            or (a != a and b != b)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(map(_close, a, b))
    return a == b and type(a) is type(b)


def _rows(values: dict, ordered: bool):
    rows = list(zip(*values.values()))
    return rows if ordered else sorted(
        rows, key=lambda r: repr(tuple(_coarse(v) for v in r)))


def assert_same(got: dict, want: dict, ordered: bool = False, what=""):
    """``got`` equals ``want`` ({column: values}): names, then rows (sorted
    unless ``ordered``), DOUBLEs to REL."""
    assert list(got) == list(want), what
    g, w = _rows(got, ordered), _rows(want, ordered)
    assert len(g) == len(w), f"{what}: {len(g)} rows, want {len(w)}"
    bad = [(a, b) for a, b in zip(g, w) if not _close(list(a), list(b))]
    assert not bad, f"{what}: {len(bad)} rows differ, first {bad[0]}"


def _want(local, sql):
    return table_values(local.run_sql(sql))


@pytest.mark.parametrize("qid", range(1, 23))
def test_distributed_matches_local(qid, queries, local):
    rec = queries[f"part{qid}"]
    assert_same(rec["values"], _want(local, QUERIES[qid]), what=f"Q{qid}")
    assert rec["collectives"] > 0 and rec["host_syncs"] > 0


@pytest.mark.parametrize("qid", BROADCAST)
def test_distributed_broadcast_matches_local(qid, queries, local):
    assert_same(queries[f"bcast{qid}"]["values"],
                _want(local, QUERIES[qid]), what=f"Q{qid}")


@pytest.mark.parametrize("qid", SHRINK)
def test_partitioned_join_shrinks_build_memory(qid, queries, local):
    """A PARTITIONED build holds about 1/world of the build rows on each
    rank, against every row under broadcast."""
    part, bcast = queries[f"tiny{qid}"], queries[f"bcast{qid}"]
    assert_same(part["values"], _want(local, QUERIES[qid]), what=f"Q{qid}")
    assert max(part["build_rows"]) * 2 <= max(bcast["build_rows"]), (
        f"Q{qid}: partitioned build {part['build_rows']} rows vs "
        f"broadcast {bcast['build_rows']}")


def test_distributed_order_statistics(shapes, local):
    """min_by/max_by/approx_percentile/stddev/bool_or grouped (min_by
    routes whole groups, so every aggregate of the statement is computed
    on the rank that owns its group) and min_by/approx_percentile/variance
    global (min_by and approx_percentile have no state, so the rows are
    gathered)."""
    for name, sql in (("order_stat", ORDER_STAT_SQL),
                      ("global_stat", GLOBAL_STAT_SQL)):
        assert_same(shapes[name]["values"], _want(local, sql), what=name)


@pytest.mark.parametrize("name", sorted(MOMENTS))
def test_distributed_moments_merge_states(name, shapes, local):
    """Variance, stddev, the corr family, geometric_mean and the bools
    merge their states across the ranks, grouped and global: DOUBLEs to
    REL.  The global one exchanges one-row partials, never the rows."""
    rec = shapes[name]
    assert_same(rec["values"], _want(local, MOMENTS[name]), what=name)
    if name == "global_moments":
        assert rec["bytes_exchanged"] < 4096, rec["bytes_exchanged"]


@pytest.mark.parametrize("qid", TOPN)
def test_distributed_topn_partial_sort(qid, queries, local):
    """A TopN sorts and limits on each rank below the exchange
    (CreatePartialTopN): the order equals the local path's."""
    assert_same(queries[f"part{qid}"]["values"], _want(local, QUERIES[qid]),
                ordered=True, what=f"Q{qid}")


def test_distributed_range_partitioned_sort(shapes, local):
    """A full sort with no limit is range-partitioned: the rank-major
    concatenation is the global order."""
    rec = shapes["range_sort"]
    assert rec["rows"] > 50000
    assert_same(rec["values"], _want(local, RANGE_SORT_SQL), ordered=True)


def test_distributed_window_partitioned(shapes, local):
    assert_same(shapes["window"]["values"], _want(local, WINDOW_SQL))


def _canon_nested(values: dict) -> dict:
    return {k: sorted(repr(sorted(x, key=repr) if isinstance(x, list)
                           else x) for x in v) for k, v in values.items()}


@pytest.mark.parametrize("i", range(len(NESTED_SQL)))
def test_distributed_nested_aggregates(i, shapes, local):
    """ARRAY and MAP columns cross the exchanges ([N, W] values, lengths, a
    MAP's values2, their dictionaries agreed)."""
    got = _canon_nested(shapes[f"nested{i}"]["values"])
    assert got == _canon_nested(_want(local, NESTED_SQL[i])), NESTED_SQL[i]


def test_distributed_unnest_roundtrip(shapes, local):
    assert sorted(shapes["unnest"]["values"]["e"]) == sorted(
        _want(local, UNNEST_SQL)["e"])


def test_distributed_mark_join_in_under_or(shapes, local):
    """IN under OR (a mark join) PARTITIONED, its has-null flag OR-ed over
    the ranks, and REPLICATED."""
    want = _want(local, MARK_SQL)
    assert shapes["mark"]["values"] == want
    assert shapes["mark_bcast"]["values"] == want


def test_distributed_bigint_sum(shapes, local):
    """A global BIGINT sum: one-row partials (``masked_sum``'s on a card)
    gathered and merged."""
    assert shapes["bigint_sum"]["values"] == _want(local, BIGINT_SUM_SQL)


def _sketch_ranks(rec):
    """Every rank's result of a ``sketch`` job (the same whole result on
    each), after checking that each rank merged samples."""
    ranks = rec["ranks"]
    assert all(r["merges"] > 0 for r in ranks), "the sketch never merged"
    assert all(r["values"] == ranks[0]["values"] for r in ranks)
    return ranks[0]["values"]


def test_distributed_percentile_sketch_vs_oracle(shapes, local):
    """The bottom-k sketch (``ops/quantile.py``) at high group cardinality:
    every grouped approx_percentile forced onto it, its sample states
    merged across the ranks.  The JAX package's test allows one rank
    position on 1% of the groups; here every group (at most 34 rows, k
    is 256 at least) is sampled whole, so the estimate is the exact
    nearest rank that the local runner computes: tolerance 0."""
    got = _sketch_ranks(shapes["sketch"])
    assert_same(got, _want(local, SKETCH_SQL))


def _rank_gap(vals, v, q) -> float:
    """How far, as a fraction of the group, the positions holding ``v``
    in the sorted ``vals`` lie from the nearest rank ceil(q n)."""
    n = len(vals)
    lo = int(np.searchsorted(vals, v, "left")) + 1
    hi = int(np.searchsorted(vals, v, "right"))
    assert lo <= hi, f"{v} is no value of the group"
    want = max(int(np.ceil(q * n)), 1)
    return max(lo - want, want - hi, 0) / n


def test_distributed_percentile_sketch_large_groups(shapes, local):
    """Seven groups of about 8,500 rows, sample size forced to SKETCH_K:
    each estimate is a value of its group whose rank lies within
    eps = sqrt(ln(2/1e-6) / (2 k)) = 0.084 of q, the DKW bound on a
    k-row sample's distribution at confidence 1 - 1e-6."""
    got = _sketch_ranks(shapes["sketch_big"])
    rows = _want(local, "select l_shipmode, l_extendedprice, l_quantity "
                        "from lineitem")
    eps = np.sqrt(np.log(2 / 1e-6) / (2 * SKETCH_K))
    by_mode = {}
    for m, p, q in zip(*rows.values()):
        by_mode.setdefault(m, ([], []))
        by_mode[m][0].append(p)
        by_mode[m][1].append(q)
    assert sorted(got["m"]) == sorted(by_mode)
    for i, m in enumerate(got["m"]):
        price, qty = (np.sort(np.asarray(c)) for c in by_mode[m])
        assert len(price) > 8 * SKETCH_K
        gaps = [_rank_gap(price, got[f"p{j}"][i], q)
                for j, q in enumerate(SKETCH_Q)]
        gaps.append(_rank_gap(qty, got["q"][i], 0.5))
        assert max(gaps) <= eps, (m, gaps)


def test_sharded_tables_cached_across_queries(shapes):
    """Consecutive statements over the same tables read each shard once;
    a wider column set reads only the new columns; the pool accounts the
    resident shard bytes (on every rank)."""
    for per_rank in shapes["cache"]["ranks"]:
        slices = [s for s, _ in per_rank]
        assert slices[0] > 0
        assert slices[1] == slices[0], "Q6 read its shard again"
        assert slices[2] >= slices[1]
        assert slices[4] == slices[3] == slices[2], "tables read again"
        assert per_rank[-1][1] > 0


def test_sharded_ingest_bounded_slices(shapes):
    """``ingest_slice_rows=1000``: each rank reads its 3,750 orders in at
    least four slices (at least 16 over the world)."""
    ranks = shapes["ingest"]["ranks"]
    assert all(count == 15000 for count, _ in ranks)
    assert all(s >= 4 for _, s in ranks)
    assert sum(s for _, s in ranks) >= 16


@pytest.mark.parametrize("name", sorted(RAISES))
def test_unported_shapes_raise(name, shapes):
    """FULL JOIN and MATCH_RECOGNIZE raise naming the node, as in the JAX
    package's multi-device path; uuid() over several ranks raises (each
    rank would number its rows from 0)."""
    err = shapes[name].get("error", "")
    assert err.startswith("NotImplementedError") and RAISES[name][1] in err


@pytest.mark.parametrize("name", sorted(WORLD3))
def test_world_of_three(name, world3, local):
    """Three ranks: hash routing by ``% 3``, range splitters at thirds."""
    ordered = name in ("q1", "q3", "q18", "q21", "range_sort", "order_stat")
    assert_same(world3[name]["values"], _want(local, WORLD3[name]),
                ordered=ordered, what=name)


# ---- the slice as a whole against the JAX package's DistributedRunner

JAX_CASES = {"q3": QUERIES[3], "q13": QUERIES[13], "q18": QUERIES[18],
             "order_stat": ORDER_STAT_SQL, "global_stat": GLOBAL_STAT_SQL}


@pytest.fixture(scope="module")
def jax_dist():
    from presto_tpu.parallel import distributed as JD
    return JD.DistributedRunner(JD.make_mesh(4), SF, broadcast_row_limit=3000)


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_distributed_equals_jax(name, jax_dist, queries, shapes):
    """4 ranks of the port against the JAX package's 4-device mesh, the
    same broadcast limit: sorted rows, DOUBLEs to REL."""
    t = jax_dist.run_sql(JAX_CASES[name])
    want = table_values(t)
    port = queries if name.startswith("q") else shapes
    got = port[f"part{name[1:]}" if name.startswith("q") else name]
    assert_same(got["values"], want, what=name)
