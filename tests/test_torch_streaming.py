"""The port's streaming aggregation, bounded ingest and PARTIAL → FINAL
aggregation states against the JAX package, exactly (tolerance 0).

- every test of ``tests/test_streaming.py``, ported: Q1 and Q6 streamed
  equal the standard path; lineitem is never cached; many groups across
  many slices (the eager 8-way merge); joins and DISTINCT are not
  streamed (``last_streamed`` False); bounded ingest; the pool's LRU;
  a budget that evicts and regenerates; split pruning.  Each streamed
  result is also held to the JAX package's ``run_sql_streaming``;
- ``parallel/distributed.partial_agg_states`` over three slices, then
  ``merge_agg_states``, equals the one-shot aggregate and the JAX
  package's states for every aggregate the port computes, long decimals
  and a NULL group included; an aggregate without a state
  (approx_percentile, min_by, max_by) raises ``NotImplementedError``
  naming it.  The DOUBLE inputs are
  multiples of 1/8 under 2^17, so every float sum is exact in any order
  and the comparison can be exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu.data import types as JT
from presto_tpu.data.column import Column as JColumn
from presto_tpu.exec import columns as JC
from presto_tpu.exec import physical as JPH
from presto_tpu.exec.datasource import DataSource as JaxSource
from presto_tpu.exec.runner import LocalRunner as JaxRunner
from presto_tpu.exec.runner import materialize as jax_materialize
from presto_tpu.parallel import distributed as JD
from presto_tpu.sql import ir as JIR
from presto_tpu.tpch.queries import QUERIES
from presto_tpu_torch.data import types as T
from presto_tpu_torch.data.column import Column
from presto_tpu_torch.exec import physical as PH
from presto_tpu_torch.exec import plan as P
from presto_tpu_torch.exec.columns import Chunk, from_host
from presto_tpu_torch.exec.datasource import DataSource
from presto_tpu_torch.exec.runner import LocalRunner, materialize
from presto_tpu_torch.exec.streaming import find_streamable_agg
from presto_tpu_torch.parallel import distributed as D
from presto_tpu_torch.sql import ir
from presto_tpu_torch.utils.memory import MemoryBudgetExceeded, MemoryPool

SF = 0.01
HIGH_NDV = ("select l_orderkey, sum(l_quantity) as q, count(*) as c "
            "from lineitem group by l_orderkey order by l_orderkey limit 50")
PRUNED = ("select o_orderpriority, count(*) c, sum(o_totalprice) s "
          "from orders where o_orderkey between 1000 and 2000 "
          "group by o_orderpriority")
GROUPED_HLL = ("select l_returnflag, approx_distinct(l_partkey) a, "
               "count(*) c, max(l_extendedprice) hi "
               "from lineitem group by l_returnflag order by l_returnflag")
DATE_EXTREMES = ("select l_linestatus, min(l_shipdate) lo, "
                 "max(l_commitdate) hi from lineitem group by l_linestatus "
                 "order by l_linestatus")
BIGINT_SUM = "select sum(l_orderkey) s, count(*) c from lineitem"


def _cols(table):
    return {name: col.to_pylist() for name, col in table.columns.items()}


def _bag(table):
    return sorted(map(repr, zip(*_cols(table).values())))


@pytest.fixture(scope="module")
def runner():
    return LocalRunner(scale_factor=SF, device="cpu")


@pytest.fixture(scope="module")
def ref():
    return JaxRunner(scale_factor=SF)


# ---------------------------------------------------------------- streaming

@pytest.mark.parametrize("sql,slice_rows", [
    (QUERIES[1], 7500), (QUERIES[6], 5000), (BIGINT_SUM, 4000),
    (GROUPED_HLL, 5000)], ids=["q1", "q6", "bigint_sum", "approx_distinct"])
def test_streaming_matches_standard(runner, ref, sql, slice_rows):
    want = _cols(runner.run_sql(sql))
    got = _cols(runner.run_sql_streaming(sql, slice_rows=slice_rows))
    assert runner.last_streamed
    assert got == want
    assert got == _cols(ref.run_sql_streaming(sql, slice_rows=slice_rows))


def test_streamed_date_extremes(runner):
    """min and max of a DATE streamed equal the standard path and numpy
    over the generated columns.  Not held to the JAX package: its grouped
    min of a DATE is -1 in every group, streamed or not."""
    got = _cols(runner.run_sql_streaming(DATE_EXTREMES, slice_rows=1000))
    assert runner.last_streamed
    assert got == _cols(runner.run_sql(DATE_EXTREMES))
    host = runner.datasource.read_host(
        "lineitem", ("l_linestatus", "l_shipdate", "l_commitdate"))
    status = np.asarray(host["l_linestatus"].to_pylist())
    ship = np.asarray(host["l_shipdate"].values)
    commit = np.asarray(host["l_commitdate"].values)
    assert got == {"l_linestatus": ["F", "O"],
                   "lo": [int(ship[status == s].min()) for s in "FO"],
                   "hi": [int(commit[status == s].max()) for s in "FO"]}


def test_streaming_never_materializes_table():
    """The streamed scan goes through ``scan_slice``: nothing of lineitem
    is in the device cache afterwards, and the slices are counted."""
    fresh = LocalRunner(scale_factor=SF, device="cpu")
    fresh.run_sql_streaming(QUERIES[6], slice_rows=10000)
    assert fresh.last_streamed
    assert not any(t == "lineitem" for (t, _) in fresh.datasource._cols)
    assert fresh.datasource.ingest_slices == 2  # 15,000 orders / 10,000
    assert dict(fresh.metrics.snapshot())["datasource.ingest_slices"] == 2


def test_streaming_group_by_high_ndv(runner, ref):
    """15,000 groups over 5 slices of 3,000 orders, then 8-way merges of
    ... a 2-slice run too (no eager merge)."""
    want = _cols(runner.run_sql(HIGH_NDV))
    for slice_rows in (1000, 3000):
        got = _cols(runner.run_sql_streaming(HIGH_NDV, slice_rows=slice_rows))
        assert runner.last_streamed
        assert got == want
    assert got == _cols(ref.run_sql_streaming(HIGH_NDV, slice_rows=3000))


def test_streaming_fallback_for_joins(runner, ref):
    """A join below the aggregation: not streamable, answered by
    ``run_sql``."""
    assert find_streamable_agg(runner.plan_sql(QUERIES[14])) is None
    got = _cols(runner.run_sql_streaming(QUERIES[14]))
    assert not runner.last_streamed
    assert got == _cols(runner.run_sql(QUERIES[14]))
    assert got == _cols(ref.run_sql_streaming(QUERIES[14]))


def test_streaming_fallback_for_distinct(runner, ref):
    sql = "select count(distinct l_suppkey) as d from lineitem"
    assert find_streamable_agg(runner.plan_sql(sql)) is None
    got = _cols(runner.run_sql_streaming(sql))
    assert not runner.last_streamed
    assert got == _cols(ref.run_sql_streaming(sql))


def test_chunked_ingest_bounded_slices():
    """Upload in bounded slices of order units: 15,000 / 2,000 = 8 reads,
    the same columns as one read and as the JAX package's, a DICT
    column's slices sharing one dictionary."""
    cols = ["l_quantity", "l_orderkey", "l_returnflag"]
    ds = DataSource(SF, "cpu", ingest_slice_rows=2000)
    chunk = ds.scan("lineitem", cols)
    assert ds.ingest_slices == 8
    whole = DataSource(SF, "cpu").scan("lineitem", cols)
    jax = JaxSource(SF, ingest_slice_rows=2000).scan("lineitem", cols)
    for c in cols:
        np.testing.assert_array_equal(chunk.cols[c].values.numpy(),
                                      whole.cols[c].values.numpy())
        np.testing.assert_array_equal(chunk.cols[c].values.numpy(),
                                      np.asarray(jax.cols[c].values))
    assert list(chunk.cols["l_returnflag"].dictionary.strings) == \
        list(whole.cols["l_returnflag"].dictionary.strings)


def test_memory_pool_lru_revocation():
    pool = MemoryPool(budget_bytes=100)
    dropped = []
    pool.reserve("a", 60, revoke=lambda: dropped.append("a"))
    pool.reserve("b", 30, revoke=lambda: dropped.append("b"))
    pool.touch("a")  # b is now LRU
    pool.reserve("c", 30, revoke=lambda: dropped.append("c"))
    assert dropped == ["b"], "LRU entry revoked first, and only as needed"
    assert pool.used <= 100


def test_memory_pool_exhausted_raises():
    pool = MemoryPool(budget_bytes=10)
    pool.reserve("pinned", 8)  # not revocable
    with pytest.raises(MemoryBudgetExceeded):
        pool.reserve("big", 5)


def test_datasource_budget_evicts_and_regenerates():
    """A tight budget evicts cached columns; a later scan regenerates
    them, the same values."""
    ds = DataSource(SF, "cpu", device_budget_bytes=2 << 20)
    q1 = ds.scan("lineitem", ["l_quantity"]).cols["l_quantity"].values.clone()
    for c in ("l_extendedprice", "l_discount", "l_tax", "l_partkey"):
        ds.scan("lineitem", [c])  # 480,000 bytes each
    ds.scan("orders", ["o_totalprice"])
    assert ("lineitem", "l_quantity") not in ds._cols
    again = ds.scan("lineitem", ["l_quantity"]).cols["l_quantity"].values
    np.testing.assert_array_equal(again.numpy(), q1.numpy())
    assert ds.pool.budget == 2 << 20
    assert ds.pool.used <= ds.pool.budget


def test_query_under_memory_budget(runner, ref):
    want = _cols(runner.run_sql(QUERIES[6]))
    tight = LocalRunner(scale_factor=SF, device="cpu")
    tight.datasource.pool.budget = 4 << 20
    assert _cols(tight.run_sql(QUERIES[6])) == want
    assert want == _cols(ref.run_sql(QUERIES[6]))


def test_streaming_split_pruning(runner, ref):
    """A filter on the monotone o_orderkey prunes the unit range: keys
    1000..2000 cover about 250 of the 15,000 order units, at most 3
    slices of 500 (30 unpruned)."""
    want = _bag(runner.run_sql(PRUNED))
    pruned = LocalRunner(scale_factor=SF, device="cpu")
    got = pruned.run_sql_streaming(PRUNED, slice_rows=500)
    assert pruned.last_streamed
    assert _bag(got) == want
    assert pruned.datasource.ingest_slices <= 3
    assert _bag(got) == _bag(ref.run_sql_streaming(PRUNED, slice_rows=500))


def test_streaming_needs_a_card_by_default():
    """Without a card the runner refuses to start: nothing streams on the
    CPU unless the caller asks for it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalRunner(scale_factor=SF, device_budget_bytes=1 << 30)


# ---------------------------------------------------------------- states

N_ROWS = 3000
SLICES = (0, 700, 1900, N_ROWS)


def _inputs():
    """Seeded columns: a nullable BIGINT group key (13 values and NULL),
    BIGINT, short and long decimals, dyadic DOUBLEs, small BIGINTs (their
    squares' sums exact in float64), dates and a DICT string, each
    nullable; one row in twenty masked out."""
    rng = np.random.default_rng(11)
    n = N_ROWS
    big = [int(x) * 10**18 + int(y) for x, y in zip(
        rng.integers(-10**12, 10**12, n), rng.integers(0, 10**18, n))]
    words = np.array([[v >> 64, (v & (2**64 - 1)) - (
        2**64 if v & (1 << 63) else 0)] for v in big], np.int64)
    return {
        "g": (rng.integers(0, 13, n).astype(np.int64), ("BIGINT",)),
        "b": (rng.integers(-10**12, 10**12, n).astype(np.int64),
              ("BIGINT",)),
        "sd": (rng.integers(-10**9, 10**9, n).astype(np.int64),
               ("decimal", 12, 2)),
        "ld": (words, ("decimal", 38, 2)),
        "d": (rng.integers(-2**20, 2**20, n).astype(np.float64) / 8,
              ("DOUBLE",)),
        "i": (rng.integers(-4096, 4096, n).astype(np.int64), ("BIGINT",)),
        "dt": (rng.integers(8000, 11000, n).astype(np.int32), ("DATE",)),
        "s": (rng.integers(0, 4, n).astype(np.int32), ("varchar", 8)),
    }, {c: rng.random(n) > 0.1 for c in ("g", "b", "sd", "ld", "d", "i",
                                         "dt", "s")}, rng.random(n) > 0.05


DICTIONARY = np.array(["ant", "bee", "cat", "dog"], dtype=object)


def _type(types, spec):
    """("BIGINT",) → ``types.BIGINT``; ("decimal", 12, 2) →
    ``types.decimal(12, 2)``, in either package's ``data.types``."""
    v = getattr(types, spec[0])
    return v(*spec[1:]) if len(spec) > 1 else v


def _chunk(pkg: str, lo: int, hi: int):
    """Rows [lo, hi) of the inputs as the port's (``pkg == "torch"``) or
    the JAX package's chunk."""
    vals, valid, mask = _inputs()
    types, column = (T, Column) if pkg == "torch" else (JT, JColumn)
    cols = {}
    for name, (v, tname) in vals.items():
        dtype = _type(types, tname)
        kw = {"dictionary": DICTIONARY} if name == "s" else {}
        col = column(dtype, v[lo:hi], valid[name][lo:hi],
                     "dict" if name == "s" else "plain", **kw)
        cols[name] = (from_host(col, "cpu") if pkg == "torch"
                      else JC.from_host(col))
    m = mask[lo:hi]
    if pkg == "torch":
        return Chunk(cols, torch.from_numpy(m))
    return JC.Chunk(cols, jnp.asarray(m))


STATE_CASES = [("count", "b"), ("count_star", None), ("sum", "b"),
               ("sum", "sd"), ("sum", "ld"), ("sum", "d"), ("avg", "b"),
               ("avg", "sd"), ("avg", "ld"), ("avg", "d"), ("min", "b"),
               ("max", "b"), ("min", "ld"), ("max", "ld"), ("min", "dt"),
               ("max", "dt"), ("min", "d"), ("max", "d"),
               ("arbitrary", "s"), ("any_value", "b"), ("var_samp", "d"),
               ("var_pop", "d"), ("variance", "i"), ("stddev", "d"),
               ("stddev_samp", "i"), ("stddev_pop", "d"),
               ("approx_distinct", "b")]


def _plan(pkg: str, func: str, arg):
    """An aggregation of one aggregate grouped by ``g`` over a leaf."""
    vals, _, _ = _inputs()
    if pkg == "torch":
        types, mod, phys = T, ir, P
    else:
        types, mod, phys = JT, JIR, JPH

    def ref(name):
        return mod.ColumnRef(name, _type(types, vals[name][1]))
    spec = phys.AggSpec("a", func, None if arg is None else ref(arg))
    return phys.PhysHashAggregate(None, (("g", ref("g")),), (spec,), 64)


def _by_group(table) -> dict:
    c = _cols(table)
    return dict(zip(c["g"], c["a"]))


@pytest.mark.parametrize("func,arg", STATE_CASES,
                         ids=[f"{f}_{a}" for f, a in STATE_CASES])
def test_partial_merge_equals_one_shot_and_jax(func, arg):
    plan = _plan("torch", func, arg)
    ctx = PH.ExecContext(None)
    one_shot = PH.execute(P.PhysHashAggregate(
        P.PhysMaterial(_chunk("torch", 0, N_ROWS)), plan.groups, plan.aggs,
        64), ctx)
    parts, specs = [], None
    for lo, hi in zip(SLICES, SLICES[1:]):
        part, specs, overflow = D.partial_agg_states(
            plan, _chunk("torch", lo, hi), 64)
        assert overflow is None or not bool(overflow)
        parts.append(part)
    merged, _ = D.merge_agg_states(plan, PH.concat_chunks(parts), specs, 64)
    got = _by_group(materialize(merged, ctx))
    assert got == _by_group(materialize(one_shot, ctx))
    assert None in got and len(got) == 14  # the NULL group and 13 keys
    if (func, arg) == ("min", "dt"):
        # the JAX package's grouped min of a DATE is -1 in every group:
        # held to numpy instead
        vals, valid, mask = _inputs()
        keep = mask & valid["dt"]
        g = np.where(valid["g"], vals["g"][0], -1)
        assert got == {None if k < 0 else int(k): int(
            vals["dt"][0][keep & (g == k)].min()) for k in np.unique(g)}
        return
    jplan = _plan("jax", func, arg)
    jparts = []
    for lo, hi in zip(SLICES, SLICES[1:]):
        part, jspecs, _ = JD.partial_agg_states(jplan, _chunk("jax", lo, hi),
                                                64)
        jparts.append(part)
    jmerged, _ = JD.merge_agg_states(jplan, JPH.concat_chunks(jparts),
                                     jspecs, 64)
    want = _by_group(jax_materialize(jmerged))
    if func.startswith("stddev"):
        # torch's float64 sqrt on the CPU is not correctly rounded (one
        # input in about a hundred comes back one ulp off; a CUDA sqrt
        # is): the moment states are exact, so the square roots are held
        # to one ulp here
        assert got.keys() == want.keys()
        np.testing.assert_array_max_ulp(
            np.array([got[k] for k in want]), np.array(list(want.values())),
            maxulp=1)
        return
    assert got == want


@pytest.mark.parametrize("func", ["approx_percentile", "min_by", "max_by"])
def test_unported_aggregate_state_raises(func):
    plan = _plan("torch", func, "b")
    with pytest.raises(NotImplementedError, match=func):
        D.partial_agg_states(plan, _chunk("torch", 0, 100), 64)


def test_distinct_has_no_state():
    plan = _plan("torch", "count", "b")
    plan.aggs = (P.AggSpec("a", "count", plan.aggs[0].arg, distinct=True),)
    with pytest.raises(NotImplementedError, match="DISTINCT"):
        D.partial_agg_states(plan, _chunk("torch", 0, 100), 64)
