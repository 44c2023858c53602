"""The benchmark's tables and reference, held to the program's generator,
to ``tools/np_tpch_oracle.py`` and to the program itself on the CPU."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from conftest import BENCH, ROOT, tiny_cell
from harness import params as P
from harness.compare import compare
from reference import oracle, tpch_gen

SF = 0.01
STATEMENTS = json.load(open(os.path.join(BENCH, "reference",
                                         "tpch_queries.json")))
QUERIES = list(range(1, 23))
SEEDS = [0, 1, 7, 99, 12345, 2**31 - 1, 2**31, 2**31 + 17, 2**32 + 5,
         3000000001, 3100000002, 4294967295]


@pytest.fixture(scope="module")
def host():
    return tpch_gen.generate(SF, "cpu")


@pytest.fixture(scope="module")
def runner(host):
    from presto_tpu_torch.exec.runner import LocalRunner
    r = LocalRunner(scale_factor=SF, device="cpu")
    tiny_cell().connector().attach(r, host)
    return r


@pytest.mark.parametrize("table", list(tpch_gen.GENERATORS))
def test_tables_equal_the_program_generator(host, table):
    from presto_tpu_torch.tpch import generator as PG
    want = PG.generate(table, SF, columns=list(host[table]))
    for name, hc in host[table].items():
        col = want.columns[name]
        assert col.kind == hc.kind, name
        assert np.asarray(col.values).dtype == hc.values.dtype, name
        assert np.array_equal(np.asarray(col.values), hc.values), name
        if hc.kind == "bytes":
            assert np.array_equal(np.asarray(col.lengths), hc.lengths), name
        if hc.kind == "dict":
            assert list(col.dictionary) == hc.dictionary, name


def test_templates_under_validation_values_are_the_program_text():
    from presto_tpu_torch.tpch.queries import QUERIES as TEXT
    for q in QUERIES:
        st = STATEMENTS["queries"][str(q)]
        assert P.render(st["sql"], st["params"], st["validation"]) == \
            TEXT[q].strip(), q


@pytest.mark.parametrize("q", QUERIES)
def test_reference_equals_np_oracle_at_validation_values(host, q):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import np_tpch_oracle as NO
    from presto_tpu_torch.exec.runner import LocalRunner
    ds = LocalRunner(scale_factor=SF, device="cpu").datasource
    want = NO.QUERIES[f"q{q}"](NO.Tables(ds))
    want = {k: [x.item() if hasattr(x, "item") else x for x in v]
            for k, v in want.items()}
    got = oracle.QUERIES[q](oracle.Tables(host),
                            STATEMENTS["queries"][str(q)]["validation"])
    assert got == want


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_equals_the_program_on_cpu(host, runner, seed):
    drawn = P.draw_statements(STATEMENTS, SF, seed)
    t = oracle.Tables(host)
    for q in QUERIES:
        sql, values = drawn[str(q)]
        table = runner.run_sql(sql)
        data = table.to_pydict()
        cols = list(data)
        rows = list(zip(*[data[c] for c in cols]))
        want_cols, want = oracle.answer(t, q, values)
        assert cols == want_cols, (q, values)
        why = compare(rows, want, want_cols,
                      STATEMENTS["queries"][str(q)]["order"])
        assert why is None, (q, values, why)


def test_plans_through_the_connector_equal_the_program_connector(runner):
    from presto_tpu_torch.exec.runner import LocalRunner
    own = LocalRunner(scale_factor=SF, device="cpu")
    for q in QUERIES:
        st = STATEMENTS["queries"][str(q)]
        sql = P.render(st["sql"], st["params"], st["validation"])
        assert repr(runner.plan_sql(sql)) == repr(own.plan_sql(sql)), q


def test_parameters_follow_the_seed_and_the_rules():
    a = P.draw_statements(STATEMENTS, 1.0, 2**31 + 5)
    assert a == P.draw_statements(STATEMENTS, 1.0, 2**31 + 5)
    assert a != P.draw_statements(STATEMENTS, 1.0, 2**31 + 6)
    for seed in SEEDS:
        v = {q: x[1] for q, x in P.draw_statements(STATEMENTS, 10.0,
                                                   seed).items()}
        assert 60 <= v["1"]["DELTA"] <= 120
        assert len(set(v["7"]["NATION"])) == 2
        assert v["8"]["REGION"] == STATEMENTS["lists"]["NATION_REGION"][
            v["8"]["NATION"]]
        assert v["11"]["FRACTION"] == [7, 100]  # 0.0001 / SF10
        assert len(set(v["16"]["SIZE"])) == 8
        assert 312 <= v["18"]["QUANTITY"] <= 315
        assert len(set(v["22"]["I"])) == 7
        assert all(10 <= i <= 34 for i in v["22"]["I"])
        assert "1993-01-01" <= v["4"]["DATE"] <= "1997-10-01"


@pytest.mark.cuda
def test_tables_on_the_card_equal_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    cpu = tpch_gen.generate(SF, "cpu")
    card = tpch_gen.generate(SF, "cuda")
    for t, cols in cpu.items():
        for c, hc in cols.items():
            assert np.array_equal(hc.values, card[t][c].values), (t, c)
