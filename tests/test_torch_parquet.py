"""``tests/test_parquet.py``'s five cases through the port's copy of the
Parquet connector (``presto_tpu_torch/connector/parquet.py``), attached
with ``datasource.register``: each statement's answer is held to the same
pandas oracle as the reference's test, and to the JAX package's answer
over the same files at tolerance 0 (names, types, values in row order)."""

import datetime as dt
import decimal

import numpy as np
import pytest
import torch

pa = pytest.importorskip("pyarrow")
import pyarrow.parquet as pq  # noqa: E402

from presto_tpu.connector.parquet import parquet_connector as jax_parquet  # noqa: E402
from presto_tpu.exec.runner import LocalRunner as JaxRunner  # noqa: E402
from presto_tpu_torch.connector.parquet import parquet_connector  # noqa: E402
from presto_tpu_torch.exec.runner import LocalRunner  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pq_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("pqcat")
    n = 5000
    rng = np.random.default_rng(7)
    sales = pa.table({
        "sale_id": pa.array(np.arange(n, dtype=np.int64)),
        "cust_id": pa.array(rng.integers(0, 500, n).astype(np.int64)),
        "amount": pa.array(
            [decimal.Decimal(int(v)) / 100
             for v in rng.integers(100, 100000, n)],
            type=pa.decimal128(10, 2)),
        "rate": pa.array(rng.random(n)),
        "sold_day": pa.array([dt.date(2024, 1, 1) + dt.timedelta(days=int(v))
                              for v in rng.integers(0, 300, n)]),
        "region": pa.array(
            [["north", "south", "east", "west"][v]
             for v in rng.integers(0, 4, n)]),
        "flag": pa.array((rng.random(n) < 0.5)),
    })
    # multiple row groups so split/row-group pruning is exercised
    pq.write_table(sales, d / "pq_sales.parquet", row_group_size=1024)
    cust = pa.table({
        "cust_id": pa.array(np.arange(500, dtype=np.int64)),
        "cust_name": pa.array([f"customer#{k}" for k in range(500)]),
    })
    pq.write_table(cust, d / "pq_cust.parquet")
    return d


@pytest.fixture(scope="module")
def runner(pq_dir):
    r = LocalRunner(scale_factor=0.01, device="cpu")
    r.datasource.register(parquet_connector(str(pq_dir)))
    return r


@pytest.fixture(scope="module")
def ref(pq_dir):
    r = JaxRunner(scale_factor=0.01)
    r.datasource.register(jax_parquet(str(pq_dir)))
    return r


def _cols(table):
    return {name: col.to_pylist() for name, col in table.columns.items()}


def run_both(runner, ref, sql):
    """The port's table, after holding it to the JAX package's."""
    got, want = runner.run_sql(sql), ref.run_sql(sql)
    assert list(got.columns) == list(want.columns)
    for c in got.columns:
        assert str(got.columns[c].dtype) == str(want.columns[c].dtype), c
    assert _cols(got) == _cols(want)
    return got.to_pandas()


def test_show_and_count(runner, ref):
    tables = runner.run_sql("show tables").to_pandas()
    names = tables.iloc[:, 0].tolist()
    assert "pq_sales" in names and "pq_cust" in names
    c = run_both(runner, ref, "select count(*) c from pq_sales")
    assert int(c.c[0]) == 5000


def test_aggregate_group_filter(runner, ref, pq_dir):
    got = run_both(
        runner, ref,
        "select region, count(*) c, sum(amount) s from pq_sales "
        "where flag group by region order by region")
    # oracle: pandas over the same files
    df = pq.read_table(pq_dir / "pq_sales.parquet").to_pandas()
    df["amount"] = df.amount.astype(float)
    exp = (df[df.flag].groupby("region")
           .agg(c=("sale_id", "size"), s=("amount", "sum")).reset_index()
           .sort_values("region"))
    assert got.region.tolist() == exp.region.tolist()
    assert got.c.tolist() == exp.c.tolist()
    # engine sums exact cents
    np.testing.assert_allclose(
        [v / 100 for v in got.s.tolist()], exp.s.tolist(), rtol=1e-9)


def test_join_parquet_tables(runner, ref, pq_dir):
    got = run_both(
        runner, ref,
        "select cust_name, sum(amount) s from pq_sales, pq_cust "
        "where pq_sales.cust_id = pq_cust.cust_id and rate > 0.5 "
        "group by cust_name order by s desc limit 5")
    s = pq.read_table(pq_dir / "pq_sales.parquet").to_pandas()
    c = pq.read_table(pq_dir / "pq_cust.parquet").to_pandas()
    s["amount"] = s.amount.astype(float)
    j = s[s.rate > 0.5].merge(c, on="cust_id")
    exp = (j.groupby("cust_name").amount.sum()
           .sort_values(ascending=False).head(5))
    np.testing.assert_allclose(
        [v / 100 for v in got.s.tolist()], exp.tolist(), rtol=1e-9)


def test_dates_and_ranges(runner, ref):
    got = run_both(
        runner, ref,
        "select min(sold_day) mn, max(sold_day) mx from pq_sales "
        "where sold_day >= date '2024-06-01'")
    assert got.mn[0] >= (dt.date(2024, 6, 1) - dt.date(1970, 1, 1)).days


def test_join_with_tpch_catalog(runner, ref):
    # cross-catalog join: parquet table against the tpch generator
    got = run_both(
        runner, ref,
        "select count(*) c from pq_cust, region "
        "where pq_cust.cust_id = r_regionkey")
    assert int(got.c[0]) == 5
