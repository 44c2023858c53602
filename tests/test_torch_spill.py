"""The port's memory tiers and approx_distinct against the JAX package,
exactly (tolerance 0).

- ``ops/hashing.hash_keys`` and the HLL registers of ``ops/hll.py`` bit
  for bit, on the same numpy inputs;
- ``approx_distinct`` grouped and global through ``run_sql``
  (``tests/test_hll.py``'s two statements);
- the partition-at-a-time join, aggregation and sort under a tight
  ``device_budget_bytes`` (``tests/test_spill.py``'s four join shapes, its
  ORDER BY and TPC-H Q18): each equals the port's free path and the JAX
  package's operator path (``run_sql(..., fused=False)``, whose own tiers
  engage under the same budget), as multisets where the query does not
  order and row for row where it does; ``last_spill_partitions`` is at
  least 2 under the budget and 0 without it;
- a nullable ORDER BY key DESC under the budget, NULLs last as on the
  port's free path (the JAX package puts them first);
- a join of two DICT keys over different dictionaries, under the budget.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu.exec.runner import LocalRunner as JaxRunner
from presto_tpu.ops import hashing as JH
from presto_tpu.ops import hll as JL
from presto_tpu.tpch.queries import QUERIES
from presto_tpu_torch.data import types as T
from presto_tpu_torch.data.column import DICT, Column
from presto_tpu_torch.data.table import Table
from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.ops import hashing as TH
from presto_tpu_torch.ops import hll as TL

SF = 0.01
TIGHT = 600 << 10       # under the joins' working sets, over every column
Q18_TIGHT = 6_000_000   # under Q18's working sets
I64_MIN, I64_MAX = -2**63, 2**63 - 1

JOIN_SQL = """
 select c.c_nationkey, count(o.o_orderkey) c, sum(o.o_totalprice) s
 from customer c join orders o on c.c_custkey = o.o_custkey
 group by c.c_nationkey
"""
EXPAND_SQL = """
 select o_orderpriority, count(*) c from orders o, customer c
 where o.o_custkey = c.c_custkey and c.c_nationkey < 7
 group by o_orderpriority
"""
LEFT_SQL = """
 select c.c_custkey, count(o.o_orderkey) c from customer c
 left join orders o on c.c_custkey = o.o_custkey
 where c.c_custkey <= 200 group by c.c_custkey
"""
SEMI_SQL = """
 select count(*) from customer c where exists (
   select * from orders o where o.o_custkey = c.c_custkey
   and o.o_totalprice > 1000.00)
"""
SORT_SQL = """
 select o_orderkey, o_totalprice from orders
 where o_custkey <= 600 order by o_totalprice desc, o_orderkey
"""
# a nullable sort key: customers whose orders all fail the join filter
# get a NULL o_totalprice
NULL_DESC_SQL = """
 select c_custkey, o_orderkey, o_totalprice from customer
 left join orders on c_custkey = o_custkey and o_totalprice > 300000
 where c_custkey < 400 order by o_totalprice desc, c_custkey
"""
# (sql, budget, ordered)
BUDGETED = {"inner": (JOIN_SQL, TIGHT, False),
            "expanding": (EXPAND_SQL, TIGHT, False),
            "left": (LEFT_SQL, TIGHT, False),
            "semi": (SEMI_SQL, TIGHT, False),
            "order_by": (SORT_SQL, TIGHT, True),
            "q18": (QUERIES[18], Q18_TIGHT, True)}
HLL_SQL = {
    "global": "select approx_distinct(o_custkey) ad, "
              "count(distinct o_custkey) cd from orders",
    "grouped": "select o_orderpriority, approx_distinct(o_custkey) ad "
               "from orders group by o_orderpriority order by o_orderpriority"}


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cols(table):
    return {name: col.to_pylist() for name, col in table.columns.items()}


def _rows(table, ordered: bool):
    rows = list(zip(*_cols(table).values()))
    return rows if ordered else sorted(map(repr, rows))


@pytest.fixture(scope="module")
def free():
    return LocalRunner(scale_factor=SF, device="cpu")


@pytest.fixture(scope="module")
def tight():
    return {b: LocalRunner(scale_factor=SF, device="cpu",
                           device_budget_bytes=b)
            for b in (TIGHT, Q18_TIGHT)}


@pytest.fixture(scope="module")
def ref():
    return {b: JaxRunner(scale_factor=SF, device_budget_bytes=b)
            for b in (TIGHT, Q18_TIGHT)}


# ---------------------------------------------------------------- hashing

def _edge_keys(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    edge = np.array([0, 1, -1, I64_MIN, I64_MAX, 2**32 - 1, 2**32,
                     2**32 + 1, -(2**32) - 1, -(2**32) + 1], np.int64)
    return np.concatenate([edge, rng.integers(I64_MIN, I64_MAX, size=4000,
                                              dtype=np.int64)])


@pytest.mark.parametrize("ncols", [1, 2, 3])
def test_hash_keys_equal_jax(ncols):
    """Every int64 edge value (0, ±1, int64 min/max, 2^32 ± 1) and a
    seeded draw, one to three key columns: the same uint32 hash."""
    cols = [np.roll(_edge_keys(ncols), i) for i in range(ncols)]
    want = np.asarray(JH.hash_keys([jnp.asarray(c) for c in cols]))
    got = TH.hash_keys([t(c) for c in cols]).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert got.min() >= 0 and got.max() < 2**32


def test_hll_rank_of_every_bit_length():
    """The register rank of a word of each bit length 0..21 (p = 11), the
    zero word included (33 - p), equals the JAX package's ``clz``."""
    h = np.array([0] + [1 << (11 + b) for b in range(21)]
                 + [(1 << 32) - 1], np.int64)
    _, want = JL._index_rho(jnp.asarray(h.astype(np.uint32)), 11)
    _, got = TL._index_rho(t(h), 11)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[0]) == 33 - 11


@pytest.mark.parametrize("n", [0, 1, 100, 5000, 200_000])
def test_hll_states_equal_jax(n):
    """global_state, group_state (7 groups, some rows without one),
    seg_merge of per-row register vectors, merge and estimate: the same
    int8 registers and the same int64 estimate."""
    rng = np.random.default_rng(n)
    vals = rng.integers(0, max(n // 3, 1), size=n, dtype=np.int64) * 7919
    mask = rng.random(n) < 0.9
    slot = rng.integers(-1, 7, size=n).astype(np.int32)
    jh = JH.hash_keys([jnp.asarray(vals)])
    th = TH.hash_keys([t(vals)])
    jg = JL.global_state(jh, jnp.asarray(mask))
    tg = TL.global_state(th, t(mask))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert int(TL.estimate(tg)) == int(JL.estimate(jg))
    jgr = JL.group_state(jh, jnp.asarray(slot), jnp.asarray(mask), 8)
    tgr = TL.group_state(th, t(slot), t(mask), 8)
    np.testing.assert_array_equal(tgr.numpy(), np.asarray(jgr))
    np.testing.assert_array_equal(TL.estimate(tgr).numpy(),
                                  np.asarray(JL.estimate(jgr)))
    # the FINAL step: the 8 group vectors merged into 3 groups
    mslot = np.array([0, 1, 2, 0, 1, 2, -1, 0], np.int32)
    mmask = np.array([1, 1, 1, 1, 0, 1, 1, 1], bool)
    jm = JL.seg_merge(jgr, jnp.asarray(mslot), jnp.asarray(mmask), 3)
    tm = TL.seg_merge(tgr, t(mslot), t(mmask), 3)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(TL.merge(tgr[0], tgr[1]).numpy(),
                                  np.asarray(JL.merge(jgr[0], jgr[1])))


@pytest.mark.parametrize("name", sorted(HLL_SQL))
def test_approx_distinct_sql_equals_jax(free, ref, name):
    """``approx_distinct`` through ``run_sql``, global and grouped: the
    JAX package's estimates exactly, within 5 % of the exact count."""
    sql = HLL_SQL[name]
    got = _cols(free.run_sql(sql))
    assert got == _cols(ref[TIGHT].run_sql(sql, fused=False))
    if name == "global":
        assert abs(got["ad"][0] - got["cd"][0]) <= 0.05 * got["cd"][0] + 2


# ---------------------------------------------------------------- tiers

@pytest.mark.parametrize("name", sorted(BUDGETED))
def test_budgeted_equals_free_and_jax(free, tight, ref, name):
    sql, budget, ordered = BUDGETED[name]
    want = free.run_sql(sql)
    assert free.last_spill_partitions == 0
    got = tight[budget].run_sql(sql)
    assert tight[budget].last_spill_partitions >= 2, \
        "the budget should have sent an operator to its partitioned tier"
    assert _rows(got, ordered) == _rows(want, ordered)
    jax_rows = _rows(ref[budget].run_sql(sql, fused=False), ordered)
    assert _rows(got, ordered) == jax_rows


def test_sort_alone_partitions(tight):
    """The ORDER BY's own tier: its range partitions, concatenated, are
    the order (a sort of 6,011 rows over a 600 KB budget)."""
    r = tight[TIGHT]
    plan = r.plan_sql(SORT_SQL)
    from presto_tpu_torch.exec import physical as PH
    ctx = PH.ExecContext(r.datasource, pool=r.datasource.pool)
    child = PH.execute(plan.child, ctx)
    assert ctx.spill_partitions == 0
    k = PH._tier_partitions(ctx, 3 * PH.chunk_bytes(child))
    assert k >= 2
    got = PH._exec_sort_partitioned(plan, child, ctx, k)
    want = PH._sort(child, plan.keys)
    assert ctx.spill_partitions == k
    keep = want.mask.numpy()
    for name, c in want.cols.items():
        np.testing.assert_array_equal(got.cols[name].values.numpy(),
                                      c.values.numpy()[keep])


def test_nullable_desc_sort_under_budget(free):
    """A nullable key DESC: NULLs after every value, row for row as on the
    free path (Trino's NULLS LAST)."""
    want = _cols(free.run_sql(NULL_DESC_SQL))
    for budget in (200_000, 400_000):
        r = LocalRunner(scale_factor=SF, device="cpu",
                        device_budget_bytes=budget)
        got = _cols(r.run_sql(NULL_DESC_SQL))
        assert r.last_spill_partitions >= 2
        assert got == want
    prices = want["o_totalprice"]
    nulls = prices.index(None)
    assert nulls > 0 and all(p is None for p in prices[nulls:])
    assert prices[:nulls] == sorted(prices[:nulls], reverse=True)


# the memory table's dictionary orders the priorities backwards and holds
# a string no order has; w names the row
_PRIORITIES = np.array(["5-LOW", "4-NOT SPECIFIED", "3-MEDIUM", "2-HIGH",
                        "1-URGENT", "ZZZ"], dtype=object)
_CODES = np.array([0, 1, 2, 5, 4, 0], np.int32)
DICT_JOIN_SQL = ("select o_orderpriority, w, count(*) n from orders, pr "
                 "where o_orderpriority = p group by 1, 2")


def _with_priorities(r):
    r.datasource.create_table("pr", Table({
        "p": Column(T.varchar(15), _CODES, None, DICT,
                    dictionary=_PRIORITIES),
        "w": Column(T.BIGINT, np.arange(6, dtype=np.int64))}))
    return r


def test_join_of_different_dictionaries_under_budget(free):
    """DICT keys over two dictionaries in different orders join by string
    on the free path and under the budget, whose partitions hash the
    keys' ranks in the union of both dictionaries.  Held to a Python
    join of the same rows (the JAX package joins their codes)."""
    want_counts = dict(zip(*_cols(free.run_sql(
        "select o_orderpriority, count(*) n from orders group by 1")
    ).values()))
    strings = _PRIORITIES[_CODES]
    want = sorted((s, w, want_counts[s]) for w, s in enumerate(strings)
                  if s in want_counts)
    plain = _with_priorities(LocalRunner(scale_factor=SF, device="cpu"))
    assert sorted(zip(*_cols(plain.run_sql(DICT_JOIN_SQL)).values())) == want
    r = _with_priorities(LocalRunner(scale_factor=SF, device="cpu",
                                     device_budget_bytes=200_000))
    got = sorted(zip(*_cols(r.run_sql(DICT_JOIN_SQL)).values()))
    assert r.last_spill_partitions >= 2
    assert got == want
