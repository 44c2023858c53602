"""The four readers of the program's spans (``sync_wait_ms``,
``operator_self_ms``, ``int128_div_ms``, ``result_rows_ms``) on a
fabricated store of span totals: each per statement, each None on an
empty store, from a program without the tracer, and on the CPU's
untraced run."""

import sys

import pytest

from conftest import ROOT
from harness import spec

READERS = ("sync_wait_ms", "operator_self_ms", "int128_div_ms",
           "result_rows_ms")
MS = 1_000_000  # ns
# name -> (count, inclusive ns, self ns) over 4 statements
STORE = {
    "statement": (4, 400 * MS, 8 * MS),
    "op:HashJoin": (6, 200 * MS, 30 * MS),
    "op:Project": (8, 120 * MS, 10 * MS),
    "op:Scan": (8, 4 * MS, 4 * MS),
    "host_read": (80, 60 * MS, 60 * MS),
    "int128_div": (3, 90 * MS, 90 * MS),
    "result_rows": (8, 40 * MS, 24 * MS),
    "plan": (1, 12 * MS, 12 * MS),
}
WANT = {"sync_wait_ms": 15.0, "operator_self_ms": 11.0,
        "int128_div_ms": 22.5, "result_rows_ms": 6.0}


def reader(name):
    return spec.load_cell("tpch-sf1.power", root=ROOT).reader(name)


@pytest.mark.parametrize("name", READERS)
def test_reader_divides_by_statements(name):
    assert reader(name).value(STORE) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", READERS)
def test_reader_of_an_empty_store_is_none(name):
    assert reader(name).value({}) is None
    assert reader(name).value({"host_read": (3, MS, MS)}) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_the_tracer(name, monkeypatch):
    from presto_tpu_torch.utils import tracing
    monkeypatch.setattr(tracing, "totals", lambda: dict(STORE))
    assert reader(name).read({}) == pytest.approx(WANT[name])
    monkeypatch.setattr(tracing, "totals", dict)
    assert reader(name).read({}) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_of_a_program_without_spans_is_none(name, monkeypatch):
    import presto_tpu_torch.utils as utils
    from presto_tpu_torch.utils import tracing
    monkeypatch.setattr(tracing, "totals", lambda: dict(STORE))
    monkeypatch.delattr(utils, "tracing")
    monkeypatch.setitem(sys.modules, "presto_tpu_torch.utils.tracing", None)
    assert reader(name).read({}) is None
