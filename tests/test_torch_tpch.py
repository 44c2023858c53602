"""The torch port end to end on the CPU: TPC-H Q1, Q6, Q14 and a BIGINT sum
through ``presto_tpu_torch``'s ``LocalRunner.run_sql`` against the JAX
package's runner and the pandas oracle, exactly (tolerance 0: every value
on this path is an integer, a scaled decimal or a date).

The JAX reference runs only these few queries at SF0.01, in this one
file, to keep its compiled programs few.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpch_oracle as O
from presto_tpu.exec.runner import LocalRunner as JaxRunner
from presto_tpu.tpch import generator as JG
from presto_tpu.tpch.queries import QUERIES
from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.ops import cuda_kernels as CK
from presto_tpu_torch.tpch import generator as TG

SF = 0.01
BIGINT_SUM = ("SELECT sum(l_orderkey) AS s, count(*) AS c FROM lineitem "
              "WHERE l_shipdate <= DATE '1998-09-02'")
REQUESTS = {"q1": QUERIES[1], "q6": QUERIES[6], "q14": QUERIES[14],
            "bigint_sum": BIGINT_SUM}
# the slice's other operators and expressions, held to the JAX engine:
# NOT/OR/BETWEEN, a cast to a long decimal, grouped count and integer sum;
# CASE without ELSE, NOT LIKE, a join with a filtered build side;
# ORDER BY integer keys descending with LIMIT
EXTRA = {
    "not_or_cast_grouped": (
        "select l_returnflag, count(l_orderkey) as c, sum(l_orderkey) as s, "
        "sum(cast(l_quantity as decimal(20,3))) as q from lineitem "
        "where not (l_shipdate < date '1995-01-01') "
        "or l_discount between 0.02 and 0.03 "
        "group by l_returnflag order by l_returnflag"),
    "case_null_not_like_join": (
        "select sum(case when p_type not like '%BRASS' "
        "then l_extendedprice end) as s, count(*) as c "
        "from lineitem, part where l_partkey = p_partkey and p_size < 10"),
    "order_desc_limit": (
        "select l_orderkey, l_linenumber, l_quantity from lineitem "
        "where l_shipdate < date '1992-01-10' "
        "order by l_orderkey desc, l_linenumber limit 5"),
}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def results():
    """Each request through both engines, once per module."""
    CK.reset_launches()
    port = LocalRunner(scale_factor=SF, device="cpu")
    ref = JaxRunner(scale_factor=SF)
    out = {k: (port.run_sql(q), ref.run_sql(q))
           for k, q in {**REQUESTS, **EXTRA}.items()}
    assert CK.LAUNCHES == {"masked_sum": 0, "sorted_probe": 0}
    return out


def _cols(table):
    return {name: col.to_pylist() for name, col in table.columns.items()}


@pytest.mark.parametrize("name", sorted(REQUESTS) + sorted(EXTRA))
def test_request_equals_jax_engine(results, name):
    got, want = results[name]
    assert list(got.columns) == list(want.columns)
    assert _cols(got) == _cols(want)
    for c in got.columns:
        assert str(got.columns[c].dtype) == str(want.columns[c].dtype)


def test_q1_equals_oracle(results):
    got = _cols(results["q1"][0])
    want = O.q1(SF)
    assert len(want) == len(got["l_returnflag"]) == 4
    for col in want.columns:
        assert got[col] == [v.item() if hasattr(v, "item") else v
                            for v in want[col]], col


def test_q6_equals_oracle(results):
    assert _cols(results["q6"][0])["revenue"] == [O.q6(SF)]


def test_q14_equals_oracle(results):
    assert _cols(results["q14"][0])["promo_revenue"] == [O.q14(SF)]


def test_bigint_sum_equals_numpy(results):
    li = JG.generate("lineitem", SF)
    keep = np.asarray(li.columns["l_shipdate"].values) <= O.days("1998-09-02")
    okey = np.asarray(li.columns["l_orderkey"].values)
    assert _cols(results["bigint_sum"][0]) == {
        "s": [int(okey[keep].sum())], "c": [int(keep.sum())]}


@pytest.mark.parametrize("table,columns", [
    ("lineitem", ("l_orderkey", "l_partkey", "l_quantity", "l_extendedprice",
                  "l_discount", "l_tax", "l_returnflag", "l_linestatus",
                  "l_shipdate")),
    ("part", ("p_partkey", "p_type")),
])
def test_generator_bit_identical(table, columns):
    """The port's copy of the generator gives the JAX package's columns."""
    a, b = JG.generate(table, SF), TG.generate(table, SF)
    assert a.row_count == b.row_count
    for c in columns:
        ca, cb = a.columns[c], b.columns[c]
        assert ca.kind == cb.kind and str(ca.dtype) == str(cb.dtype)
        np.testing.assert_array_equal(np.asarray(ca.values),
                                      np.asarray(cb.values), err_msg=c)
        if ca.dictionary is not None:
            assert list(ca.dictionary) == list(cb.dictionary)


def test_runner_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalRunner(scale_factor=SF)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalRunner(scale_factor=SF, device="cuda")


def test_unported_expression_raises():
    """Outside the slice the port refuses; it does not answer wrongly."""
    r = LocalRunner(scale_factor=SF, device="cpu")
    with pytest.raises(NotImplementedError):
        r.run_sql("select sum(l_quantity * 1.5e0) as d from lineitem")


def test_runner_counts_host_syncs():
    r = LocalRunner(scale_factor=SF, device="cpu")
    r.run_sql(QUERIES[6])
    assert r.last_host_syncs > 0


_ISOLATION = """
import sys
from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.tpch.queries import QUERIES
t = LocalRunner(scale_factor=0.01, device="cpu").run_sql(QUERIES[6])
assert t.row_count == 1
bad = sorted(m for m in sys.modules
             if m.split(".")[0].startswith("jax") or m == "presto_tpu"
             or m.startswith("presto_tpu."))
print("BAD=" + ",".join(bad))
"""

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax|from\s+jax|import\s+presto_tpu(\.|\s|$)"
    r"|from\s+presto_tpu(\.|\s))", re.M)


def test_port_imports_neither_jax_nor_reference():
    """Running Q6 through the port loads no jax and no presto_tpu module,
    and no port source (nor its chip scripts) imports them."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _ISOLATION], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "BAD=\n" in proc.stdout, proc.stdout
    sources = [os.path.join(ROOT, "chip_smoke.py"),
               os.path.join(ROOT, "tools", "torch_query_profile.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "presto_tpu_torch")):
        sources += [os.path.join(d, f) for f in files if f.endswith(".py")]
    offenders = []
    for path in sources:
        with open(path) as f:
            if _FORBIDDEN.search(f.read()):
                offenders.append(os.path.relpath(path, ROOT))
    assert not offenders, offenders
    assert len(sources) > 20
