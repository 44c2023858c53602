"""The comparison that decides ``correct`` fails what it should.

The control (the reference with every decimal sum and division in
float64, put in the program's place) is judged wrong; and a run whose
timed path is broken underneath (an answer altered where it is made,
half of the input left out, a statement that returns the state of the
one before) comes out with ``correct`` false, while the same run unbroken
comes out true. On the CPU: the control at SF1 (below it Q1's sums stay
under 2^53 and float64 can get them right), the faults at SF0.01."""

import json
import os

import pytest

from conftest import BENCH, tiny_cell
from harness import bench
from harness import params as P
from harness.compare import compare
from reference import oracle, tpch_gen

STATEMENTS = json.load(open(os.path.join(BENCH, "reference",
                                         "tpch_queries.json")))


@pytest.fixture(scope="module")
def host_sf1():
    return tpch_gen.generate(1.0, "cpu")


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_is_not_correct(host_sf1, seed):
    drawn = P.draw_statements(STATEMENTS, 1.0, seed)
    exact = oracle.Tables(host_sf1)
    low = oracle.Tables(host_sf1, low_precision=True)
    wrong = []
    for q in ("1", "14", "8", "22"):  # the decimal sums and divisions
        cols, want = oracle.answer(exact, int(q), drawn[q][1])
        got_cols, got = oracle.answer(low, int(q), drawn[q][1])
        if got_cols != cols or compare(got, want, cols,
                                       STATEMENTS["queries"][q]["order"]):
            wrong.append(q)
    assert wrong, "the float64 control passed the exact comparison"


def _run(seed=5, seconds=0.5, log=lambda s: None):
    return bench.run(tiny_cell(), seed, seconds, False, "cpu",
                     bench.process_start_s(), log)


def test_the_sound_run_is_correct():
    res = _run()
    assert res["correct"] and res["attempted"] > 0
    assert res["check"]["wrong_statements"]["value"] == 0


def test_the_seeds_own_parameters_are_answered_and_compared():
    lines = []
    seed = 2**31 + 9
    _run(seed=seed, log=lines.append)
    own = len(json.load(open(os.path.join(
        BENCH, "traffic", "power.json")))["parameter_pool"])
    drawn = P.draw_statements(STATEMENTS, 0.01, seed)
    compared = [x for x in lines if x.startswith(f"reference q") and
                f" set {own}:" in x]
    assert len(compared) == 22
    assert any(json.dumps(drawn["1"][1]) in x for x in lines
               if x.startswith("the seed's own set"))


def test_tables_that_differ_from_the_configuration_stop_the_run():
    cell = tiny_cell()
    cell.config["tables"] = dict(cell.config["tables"], lineitem=59770)
    with pytest.raises(ValueError, match="the configuration states"):
        bench.run(cell, 5, 0.1, False, "cpu", bench.process_start_s())


@pytest.mark.parametrize("config", ["tpch-sf1", "tpch-sf10"])
def test_each_configuration_states_the_tables_it_runs(config):
    conf = json.load(open(os.path.join(BENCH, "configs", f"{config}.json")))
    assert tpch_gen.row_counts(conf["scale_factor"]) == conf["tables"]


def test_an_answer_altered_where_it_is_made_is_not_correct(monkeypatch):
    from presto_tpu_torch.client import api
    fetch = api.Cursor.fetchall

    def altered(self):
        rows = fetch(self)
        if rows and isinstance(rows[0][-1], int):
            rows[0] = rows[0][:-1] + (rows[0][-1] + 1,)
        return rows
    monkeypatch.setattr(api.Cursor, "fetchall", altered)
    res = _run()
    assert not res["correct"]
    assert res["check"]["wrong_statements"]["value"] > 0


def test_half_of_the_input_left_out_is_not_correct(monkeypatch):
    connector = tiny_cell().connector()
    read = connector.HostTablesConnector.read

    def half(self, table, columns, first_row, row_count):
        out = read(self, table, columns, first_row, row_count)
        if table == "lineitem":
            n = next(iter(out.values())).row_count
            out = {c: col.slice(0, n // 2) for c, col in out.items()}
        return out
    monkeypatch.setattr(connector.HostTablesConnector, "read", half)
    res = _run()
    assert not res["correct"]
    assert res["check"]["wrong_statements"]["value"] > 0


def test_a_statement_that_returns_the_state_before_is_not_correct(
        monkeypatch):
    from presto_tpu_torch.client import api
    fetch = api.Cursor.fetchall
    last = {}

    def stale(self):
        rows = fetch(self)
        before, last["rows"] = last.get("rows"), rows
        return before if before is not None else rows
    monkeypatch.setattr(api.Cursor, "fetchall", stale)
    res = _run()
    assert not res["correct"]
