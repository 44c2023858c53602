"""``tests/test_multihost.py``'s two tests through the port: two rank
processes of ``python -m presto_tpu_torch.parallel.worker`` meeting at a
TCP coordinator on localhost (gloo, the CPU), rank 0's results diffed
against the port's ``LocalRunner(device="cpu")``: Q1, Q3, Q6, Q13 (scan
sharding, the FIXED_HASH exchange across the process boundary,
partial → final aggregation, an expanding join, the range sort) and the
general statements (an expanding join with materialized output, a cross
join, a UNION).  Both tests read one world, run once per session."""

import pytest
import torch

import torch_dist_ranks as R
from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.parallel.worker import table_values
from presto_tpu_torch.tpch.queries import QUERIES

QIDS = [1, 3, 6, 13]
GENERAL = [
    "select o_orderpriority, count(*) c from orders o, customer c "
    "where o.o_custkey = c.c_custkey and c.c_nationkey < 5 "
    "group by o_orderpriority",
    "select count(*) from nation, region",
    "select n_regionkey from nation union "
    "select r_regionkey from region",
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="session")
def world_root(tmp_path_factory):
    return R.shared_root(tmp_path_factory)


SPEC = {"sf": 0.01, "jobs": (
    [{"name": f"q{q:02d}", "sql": QUERIES[q]} for q in QIDS]
    + [{"name": f"sql{i}", "sql": s} for i, s in enumerate(GENERAL)])}


@pytest.fixture
def cluster(world_root):
    data = R.cached_world(world_root, "multihost2", 2, SPEC)
    assert data["world"] == 2 and data["backend"] == "gloo"
    return {r["name"]: r for r in data["results"]}


@pytest.fixture(scope="module")
def local():
    return LocalRunner(scale_factor=0.01, device="cpu")


def _rows(values):
    return sorted(map(repr, zip(*values.values())))


def test_multiprocess_bitexact(cluster, local):
    for q in QIDS:
        rec = cluster[f"q{q:02d}"]
        want = table_values(local.run_sql(QUERIES[q]))
        assert rec["rows"] == len(next(iter(want.values()))), q
        assert _rows(rec["values"]) == _rows(want), q


def test_multiprocess_general_sql(cluster, local):
    for i, sql in enumerate(GENERAL):
        assert _rows(cluster[f"sql{i}"]["values"]) == _rows(
            table_values(local.run_sql(sql))), sql
