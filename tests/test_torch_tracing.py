"""The port's spans (``presto_tpu_torch/utils/tracing.py``) on the CPU at
``tiny``: under a CPU ``torch.profiler`` session TPC-H Q1 through the
cursor records one ``statement`` span with the query's id, one
``op:<Operator>`` span per plan node nested as the plan is, as many
``host_read`` spans as the statement's host syncs, its int128 divisions
and result rows, self times that are never negative, and a profiler
event for every span.  With no profiler a statement records nothing and
every span is one shared null context.  Besides: ``SHOW METRICS`` lists
the totals, expression evaluation's reads are counted, two threads'
statements do not mix, a dropped connection's runner is collected, and
a statement's elapsed time does not follow the wall clock."""

import gc
import math
import threading
import time
import weakref
from collections import Counter

import pytest
from torch.profiler import ProfilerActivity, profile

from presto_tpu_torch.client.api import connect
from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.tpch.queries import QUERIES
from presto_tpu_torch.utils import tracing
from presto_tpu_torch.utils.metrics import REGISTRY


def traced(fn):
    """(fn's result, the names of the profiler's events) with ``fn`` run
    under a CPU profiler session."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, {e.name for e in prof.events()}


@pytest.fixture(scope="module")
def q1():
    conn = connect(device="cpu")
    cur = conn.cursor()
    cur.execute(QUERIES[1])  # data, plan and ingest outside the trace
    before = tracing.totals()
    _, events = traced(lambda: cur.execute(QUERIES[1]))
    sid, records = tracing.statements()[-1]
    return {"cursor": cur, "runner": conn._runner, "sid": sid,
            "records": records, "events": events, "before": before,
            "after": tracing.totals()}


def test_one_statement_span_carries_the_query_id(q1):
    roots = [r for r in q1["records"] if r[3] == "statement"]
    assert len(roots) == 1
    assert q1["sid"] == q1["cursor"].last_query.query_id
    assert roots[0][2] is None
    assert {r[0] for r in q1["records"]} == {q1["sid"]}


def test_op_spans_follow_the_plan_tree(q1):
    plan = q1["runner"]._cached_plan(QUERIES[1])
    ops = [r for r in q1["records"] if r[3].startswith("op:")]
    root = next(r for r in q1["records"] if r[3] == "statement")
    below = Counter()

    def match(node, rec):
        assert rec[3] == "op:" + type(node).__name__[len("Phys"):]
        kids = sorted((r for r in ops if r[2] == rec[1]), key=lambda r: r[4])
        assert sorted(r[3] for r in kids) == \
            sorted(c.op_span for c in node.children())
        below[rec[1]] += 1
        for c in node.children():
            hit = next(r for r in kids
                       if r[3] == c.op_span and not below[r[1]])
            match(c, hit)

    (top,) = [r for r in ops if r[2] not in {o[1] for o in ops}]
    assert top[2] == root[1]
    match(plan, top)
    assert sum(below.values()) == len(ops)


def test_host_read_spans_equal_host_syncs(q1):
    reads = [r for r in q1["records"] if r[3] == "host_read"]
    assert len(reads) == q1["runner"].last_host_syncs > 0


def test_int128_division_and_result_rows_are_spanned(q1):
    names = Counter(r[3] for r in q1["records"])
    assert names["int128_div"] >= 1
    assert names["result_rows"] >= 1
    by_id = {r[1]: r for r in q1["records"]}
    for r in q1["records"]:
        if r[3] == "int128_div":  # the outermost division only
            p = r[2]
            while p is not None:
                assert by_id[p][3] != "int128_div"
                p = by_id[p][2]


def test_self_times_are_never_negative(q1):
    recs = q1["records"]
    for r in recs:
        child = sum(c[5] - c[4] for c in recs if c[2] == r[1])
        assert r[5] - r[4] - child >= 0, r
    for name, (count, incl, own) in q1["after"].items():
        b = q1["before"].get(name, (0, 0, 0))
        assert own - b[2] >= 0 and incl - b[1] >= own - b[2], name


def test_every_span_is_a_profiler_event(q1):
    assert {r[3] for r in q1["records"]} <= q1["events"]
    assert not any(r[3].startswith("stmt:") for r in q1["records"])


def test_untraced_statement_records_nothing():
    conn = connect(device="cpu")
    conn.execute("select count(*) c from nation")
    before, ring = tracing.totals(), tracing.statements()
    conn.execute("select count(*) c from nation")
    LocalRunner(device="cpu").run_sql("select count(*) c from region")
    assert tracing.totals() == before
    assert tracing.statements() == ring
    assert tracing.span("host_read") is tracing.span("host_read")
    assert tracing.span("op:Scan") is tracing.span("op:Scan")
    assert tracing.statement("q_1") is tracing.statement()


def test_show_metrics_lists_span_totals():
    conn = connect(device="cpu")
    traced(lambda: conn.execute("select count(*) c from nation"))
    names = dict(conn.execute("show metrics").fetchall())
    assert names["span.statement.count"] >= 1
    assert names["span.statement.ms"] > 0
    assert names["span.op:Scan.count"] >= 1


def test_runner_called_directly_opens_the_statement():
    r = LocalRunner(device="cpu")
    r.run_sql("select count(*) c from nation")
    traced(lambda: r.run_sql("select count(*) c from nation"))
    sid, recs = tracing.statements()[-1]
    assert sid.startswith("s_")
    assert Counter(x[3] for x in recs)["statement"] == 1
    assert sum(x[3] == "host_read" for x in recs) == r.last_host_syncs


def test_expression_reads_are_counted():
    """date_format reads its distinct days on the host, in expression
    evaluation, which has no execution context at hand: one read more
    than the same statement grouped by the date itself, and every read
    spanned."""
    r = LocalRunner(device="cpu")
    syncs = []
    for key in ("date_format(o_orderdate, '%Y-%m')", "o_orderdate"):
        sql = f"select {key} d, count(*) c from orders group by 1"
        r.run_sql(sql)
        traced(lambda: r.run_sql(sql))
        _, recs = tracing.statements()[-1]
        syncs.append(r.last_host_syncs)
        assert sum(x[3] == "host_read" for x in recs) == r.last_host_syncs
    assert syncs[0] > syncs[1]


def test_threads_do_not_mix():
    conns = [connect(device="cpu") for _ in range(2)]
    sqls = ["select count(*) c from nation", "select count(*) c from region"]
    for c, s in zip(conns, sqls):
        c.execute(s)
    curs = [c.cursor() for c in conns]

    def both():
        threads = [threading.Thread(target=cur.execute, args=(s,))
                   for cur, s in zip(curs, sqls)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    traced(both)
    ids = {cur.last_query.query_id for cur in curs}
    ring = {sid: recs for sid, recs in tracing.statements() if sid in ids}
    assert set(ring) == ids
    for sid, recs in ring.items():
        own = {x[1] for x in recs}
        assert {x[0] for x in recs} == {sid}
        assert all(x[2] is None or x[2] in own for x in recs)
        assert sum(x[3] == "statement" for x in recs) == 1


def test_dropped_connection_frees_its_runner():
    conn = connect(device="cpu")
    conn.execute("select count(*) c from nation")
    runner = weakref.ref(conn._runner)
    del conn
    gc.collect()
    assert runner() is None
    assert math.isnan(dict(REGISTRY.snapshot())["datasource.pool_used_bytes"])


def test_elapsed_time_is_monotonic(monkeypatch):
    """A wall clock stepped back mid-statement leaves elapsed_s >= 0."""
    conn = connect(device="cpu")
    conn.execute("select count(*) c from nation")
    steps = iter(range(10**6, 0, -1000))
    monkeypatch.setattr(time, "time", lambda: float(next(steps)))
    cur = conn.execute("select count(*) c from nation")
    assert cur.last_query.elapsed_s >= 0
