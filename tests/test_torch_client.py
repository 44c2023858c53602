"""The port's client edge on the CPU at ``tiny``: the DB-API connection and
cursor, the CLI's formatting, the memory catalog (CTAS, INSERT, DELETE,
UPDATE, DROP, SHOW), EXPLAIN, access control, warnings, metrics, events
and the blackhole connector.

Each statement of ``SCRIPT`` runs, in order, through the JAX package's
``connect`` and the port's ``connect(device="cpu")``; its description and
rows (or its error) must be equal, tolerance 0, and EXPLAIN ANALYZE's
per-node rows equal.  Where the port diverges from the JAX package on
purpose it is held to a Python oracle instead: a rolled-back write is not
visible, a dotted alias stays one plain column, a NULL string keeps its
NULL through INSERT, UPDATE keeps a column's type, a long-decimal column
can be written and read back, a completed event carries its row count,
and DELETE, UPDATE and DROP pass the access check.
"""

import re

import pytest
import torch

from presto_tpu_torch.client import cli
from presto_tpu_torch.client.api import QueryState, connect
from presto_tpu_torch.connector import blackhole_connector
from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.utils.errors import classify
from presto_tpu_torch.utils.memory import MemoryBudgetExceeded
from presto_tpu_torch.utils.security import (AccessDeniedError,
                                             RuleBasedAccessControl)

SF = 0.01
# (name, sql, params): run in this order through both engines
SCRIPT = [
    ("roundtrip", "select n_name, n_regionkey from nation "
                  "order by n_nationkey limit 3", ()),
    ("fetch_modes", "select n_nationkey from nation order by 1", ()),
    ("params", "select n_name from nation where n_name = ?", ("FRANCE",)),
    ("failed", "select nonexistent_col from nation", ()),
    ("ctas", "create table t1 as select n_nationkey k, n_regionkey r, "
             "n_name nm from nation", ()),
    ("insert", "insert into t1 select r_regionkey, r_regionkey, r_name "
               "from region", ()),
    ("delete", "delete from t1 where r = 1", ()),
    ("update", "update t1 set r = r + 100, k = k * 2 where r >= 3", ()),
    ("select_written", "select k, r, nm from t1 order by k, nm", ()),
    ("show_stats", "show stats for t1", ()),
    ("show_tables", "show tables", ()),
    ("dml_on_tpch_refused", "delete from nation where n_nationkey = 0", ()),
    ("cross_join", "select count(*) c from region, nation", ()),
    ("explain", "explain select n_name, count(*) c from nation, region "
                "where n_regionkey = r_regionkey and r_name = 'ASIA' "
                "group by n_name order by n_name", ()),
    ("explain_analyze", "explain analyze select n_name, count(*) c "
                        "from nation, region where n_regionkey = r_regionkey "
                        "and r_name = 'ASIA' group by n_name "
                        "order by n_name", ()),
    ("drop", "drop table t1", ()),
    ("select_dropped", "select * from t1", ()),
]


def _run(conn, sql, params) -> dict:
    cur = conn.cursor()
    try:
        cur.execute(sql, params)
    except Exception as e:  # noqa: BLE001 — the error is the result
        return {"error": f"{type(e).__name__}: {e}",
                "state": cur.last_query.state.value,
                "query_error": cur.last_query.error}
    out = {"description": cur.description,
           "warnings": cur.warnings, "rowcount": cur.rowcount,
           "state": cur.last_query.state.value}
    if sql.startswith("explain analyze"):
        # the plan and its per-node rows; the times are each engine's own
        nodes = [r[0] for r in cur.fetchall()
                 if r[0].lstrip().startswith("- ")]
        out["rows"] = [re.sub(r"\s+\{.*\}$", "", n) for n in nodes]
        # the column's width follows the annotations' text
        out["description"] = [d[0] for d in cur.description]
        out["node_rows"] = [int(re.search(r"rows: (\d+)", n).group(1))
                            for n in nodes]
    elif sql.startswith("select n_nationkey"):
        out["rows"] = [cur.fetchone(), cur.fetchmany(2), cur.fetchall(),
                       cur.fetchone()]
    else:
        out["rows"] = cur.fetchall()
    return out


@pytest.fixture(scope="module")
def script_results():
    from presto_tpu.client.api import connect as jax_connect
    port, ref = connect(scale_factor=SF, device="cpu"), \
        jax_connect(scale_factor=SF)
    return {name: (_run(port, sql, params), _run(ref, sql, params))
            for name, sql, params in SCRIPT}


@pytest.mark.parametrize("name", [s[0] for s in SCRIPT])
def test_statement_equals_jax_engine(script_results, name):
    got, want = script_results[name]
    assert got == want


def test_script_covers_the_surfaces(script_results):
    """The script's results are the ones the surfaces promise (so the
    parity above is not between two equal failures)."""
    r = {k: v[0] for k, v in script_results.items()}
    assert r["roundtrip"]["rows"][0] == ("ALGERIA", 0)
    assert [d[0] for d in r["roundtrip"]["description"]] == \
        ["n_name", "n_regionkey"]
    assert r["fetch_modes"]["rows"][:2] == [(0,), [(1,), (2,)]]
    assert len(r["fetch_modes"]["rows"][2]) == 22
    assert r["fetch_modes"]["rows"][3] is None
    assert r["params"]["rows"] == [("FRANCE",)]
    assert r["failed"]["state"] == "FAILED"
    assert "nonexistent_col" in r["failed"]["query_error"]
    assert r["ctas"]["rows"] == [(25,)] and r["insert"]["rows"] == [(5,)]
    assert r["delete"]["rows"] == [(6,)] and r["update"]["rows"] == [(12,)]
    assert len(r["select_written"]["rows"]) == 24
    assert "ValueError" in r["dml_on_tpch_refused"]["error"]
    assert any(w["warningCode"] == "CROSS_JOIN"
               for w in r["cross_join"]["warnings"])
    assert r["explain_analyze"]["node_rows"] == [5, 5, 5, 5, 25, 1, 5]
    assert "unknown table t1" in r["select_dropped"]["error"]


# ---------------------------------------------------------------- port only

@pytest.fixture(scope="module")
def conn():
    return connect(scale_factor=SF, device="cpu")


def test_connect_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        connect(scale_factor=SF)


def test_rolled_back_update_is_not_visible(conn):
    """Divergence: the JAX package answers 500 after the rollback (its
    scan cache keeps the rolled-back columns); Trino answers 10."""
    conn.execute("create table rb as select r_regionkey k, r_regionkey x "
                 "from region")
    assert conn.execute("select sum(x) from rb").fetchall() == [(10,)]
    conn.begin()
    conn.execute("update rb set x = 100")
    assert conn.execute("select sum(x) from rb").fetchall() == [(500,)]
    conn.rollback()
    assert conn.execute("select sum(x) from rb").fetchall() == [(10,)]
    conn.begin()
    conn.execute("update rb set x = x + 1")
    conn.commit()
    assert conn.execute("select sum(x) from rb").fetchall() == [(15,)]
    conn.execute("drop table rb")


def test_transaction_ctas_rollback_and_commit(conn):
    conn.begin()
    conn.execute("create table txt1 as select 1 x from region limit 1")
    assert conn.execute("select count(*) c from txt1").fetchall() == [(1,)]
    conn.rollback()
    with pytest.raises(KeyError, match="unknown table txt1"):
        conn.execute("select count(*) from txt1")
    conn.begin()
    conn.execute("create table txt2 as select 2 x from region limit 1")
    conn.commit()
    assert conn.execute("select x from txt2").fetchall() == [(2,)]
    conn.execute("drop table txt2")


def test_drop_frees_the_pool(conn):
    """A write drops the table's cached device columns and their pool
    reservations (the JAX package keeps the reservations), so after DROP
    the pool holds what it held before the CTAS."""
    ds = conn._runner.datasource
    conn.execute("select count(*) c from nation where n_regionkey > 0")
    before = ds.pool.used
    conn.execute("create table pooled as select n_nationkey k, n_name nm "
                 "from nation where n_regionkey > 0")
    conn.execute("select sum(k) s, count(nm) c from pooled").fetchall()
    assert ds.pool.used > before
    conn.execute("insert into pooled select n_nationkey, n_name from nation")
    assert ds.pool.used == before
    assert ds.table_rows("pooled") == 20 + 25
    conn.execute("select sum(k) s, count(nm) c from pooled").fetchall()
    assert ds.pool.used > before
    conn.execute("drop table pooled")
    assert ds.pool.used == before
    assert not [k for k in ds._cols if k[0] == "pooled"]


def test_dotted_alias_stays_one_column(conn):
    """Divergence: the JAX package folds ``"a.b"`` into a ROW column
    ``a``; the port (and Trino) return a plain column named ``a.b``."""
    cur = conn.execute('select r_regionkey as "a.b", r_name from region '
                       'order by 1')
    assert [d[0] for d in cur.description] == ["a.b", "r_name"]
    assert [r[0] for r in cur.fetchall()] == [0, 1, 2, 3, 4]


def test_insert_keeps_a_null_string(conn):
    """Divergence: the JAX package's INSERT turns a NULL string into ''."""
    conn.execute("create table ns as select r_name nm from region")
    conn.execute("insert into ns select cast(null as varchar(25)) "
                 "from region where r_regionkey = 0")
    assert conn.execute("select count(*) c, count(nm) n from ns"
                        ).fetchall() == [(6, 5)]
    conn.execute("drop table ns")


def test_update_keeps_the_column_type(conn):
    """Divergence: in the JAX package ``set d = 0`` turns a decimal(15,2)
    column into decimal(21,2), whose host values it then cannot scan."""
    conn.execute("create table ud as select l_orderkey k, l_discount d, "
                 "l_quantity q from lineitem where l_orderkey < 40")
    rows = conn.execute("select k, d, q from ud").fetchall()
    want = sorted((k, 0 if q >= 4000 else d) for k, d, q in rows)
    assert conn.execute("update ud set d = 0 where q >= 40").fetchall() == \
        [(sum(q >= 4000 for _, _, q in rows),)]
    cur = conn.execute("select k, d from ud order by k, d")
    assert cur.description[1][1] == "decimal(15,2)"
    assert cur.fetchall() == want
    conn.execute("drop table ud")


def test_long_decimal_column_round_trips(conn):
    """A decimal(38,4) sum stored by CTAS scans back exactly (its host
    values are python ints; the JAX package cannot upload them)."""
    q = ("select l_returnflag f, sum(l_extendedprice * l_discount) s "
         "from lineitem group by l_returnflag")
    want = sorted(conn.execute(q).fetchall())
    conn.execute(f"create table ld as {q}")
    cur = conn.execute("select f, s from ld order by f")
    assert cur.description[1][1] == "decimal(38,4)"
    assert cur.fetchall() == want
    assert conn.execute("select sum(s) t from ld").fetchall() == \
        [(sum(s for _, s in want),)]
    conn.execute("update ld set s = s + 1 where f = 'A'")
    assert conn.execute("select s from ld where f = 'A'").fetchall() == \
        [(want[0][1] + 10**4,)]
    conn.execute("drop table ld")


def test_ctas_does_not_shadow_a_tpch_table(conn):
    with pytest.raises(ValueError, match="already exists in catalog tpch"):
        conn.execute("create table nation as select 1 x from region")


def test_update_through_an_unported_function_is_not_supported(conn):
    conn.execute("create table up as select r_regionkey x from region")
    with pytest.raises(NotImplementedError) as ei:
        conn.execute("update up set x = cardinality(reverse("
                     "split('a,b', ',')))")
    assert classify(ei.value)[1] == "NOT_SUPPORTED"
    conn.execute("drop table up")


def test_config_has_no_kernel_or_fused_switch():
    """The port's config is the session's schema and user: no engine
    settings, no session properties (nothing reads them), so no kernel
    or fused switch either."""
    import dataclasses
    from presto_tpu_torch.utils import config
    assert not hasattr(config, "EngineConfig")
    assert [f.name for f in dataclasses.fields(config.Session)] == \
        ["schema", "user"]
    with pytest.raises(TypeError):
        connect(scale_factor=SF, device="cpu", config=object())


@pytest.mark.parametrize("sql,params,want", [
    ("select ? a, ? b from region", ("it's", "?"), [("it's", "?")]),
    ("select '?' q, ? a from region", ("x'?'y",), [("?", "x'?'y")]),
    ("select ? a, ? b, ? c from region", (7, None, True),
     [(7, None, True)]),
])
def test_parameters_are_sql_literals(conn, sql, params, want):
    """A string parameter is one literal, whatever quotes or ``?`` it
    holds, and only a ``?`` outside the SQL's own literals takes a
    parameter (the JAX package pastes the string between quotes and
    replaces the text's first ``?`` once per parameter)."""
    cur = conn.cursor().execute(sql + " where r_regionkey = ?",
                                params + (0,))
    assert cur.fetchall() == want


@pytest.mark.parametrize("params", [("a",), ("a", "b", "c")])
def test_parameter_count_must_match(conn, params):
    with pytest.raises(ValueError, match="placeholders"):
        conn.cursor().execute("select ? a, ? b from region", params)


def test_plan_cache_keeps_the_current_catalog_version_only(conn):
    """Every write moves the catalog version; the plans of older versions
    go, so a long-lived connection's cache does not grow with its
    writes."""
    runner = conn._runner
    for i in range(3):
        conn.execute(f"create table pc{i} as select r_regionkey x "
                     "from region")
        conn.execute(f"select sum(x) s from pc{i}")
        conn.execute("select count(*) c from nation")
        assert len(runner._plan_cache) == 2
        conn.execute(f"drop table pc{i}")
    conn.execute("select count(*) c from nation")
    assert list(runner._plan_cache) == ["select count(*) c from nation"]
    assert runner._plan_version == runner.datasource.catalog.version


def test_error_taxonomy_classifies_card_oom():
    assert classify(torch.OutOfMemoryError("CUDA out of memory"))[1] == \
        "EXCEEDED_LOCAL_MEMORY_LIMIT"
    assert classify(MemoryBudgetExceeded("x"))[1] == \
        "EXCEEDED_LOCAL_MEMORY_LIMIT"
    assert classify(SyntaxError("expected select"))[1] == "SYNTAX_ERROR"
    assert classify(KeyError("unknown table x"))[1] == "TABLE_NOT_FOUND"


@pytest.mark.parametrize("rule,sql", [
    ({"denied_tables": {"orders"}}, "select count(*) from orders"),
    ({"denied_columns": {"customer": {"c_acctbal"}}},
     "select sum(c_acctbal) from customer"),
    ({"read_only": True}, "create table w as select 1 x from region"),
])
def test_access_control_denies(rule, sql):
    r = LocalRunner(scale_factor=SF, device="cpu",
                    access_control=RuleBasedAccessControl(**rule))
    with pytest.raises(AccessDeniedError):
        r.run_sql(sql)
    # what the rule does not name still runs
    assert r.run_sql("select count(*) c from region").to_pydict() == \
        {"c": [5]}


def test_read_only_blocks_every_write():
    """DELETE, UPDATE and DROP pass the access check too (the JAX package
    checks only CTAS and INSERT)."""
    acl = RuleBasedAccessControl()
    r = LocalRunner(scale_factor=SF, device="cpu", access_control=acl)
    r.run_sql("create table ro as select r_regionkey x from region")
    acl.read_only = True
    for sql in ("delete from ro", "update ro set x = 1", "drop table ro",
                "insert into ro select 1 from region"):
        with pytest.raises(AccessDeniedError):
            r.run_sql(sql)
    assert r.run_sql("select count(*) c from ro").to_pydict() == {"c": [5]}


def test_cached_plan_reports_its_own_warnings(conn):
    cross = "select count(*) c from region r1, region r2"
    assert conn.execute(cross).warnings[0]["warningCode"] == "CROSS_JOIN"
    assert conn.execute("select count(*) c from region").warnings == []
    assert conn.execute(cross).warnings[0]["warningCode"] == "CROSS_JOIN"


def test_metrics_queryable(conn):
    conn.execute("select count(*) c from region")
    m = dict(conn.execute("show metrics").fetchall())
    assert m["queries.planned"] > 0
    assert "uptime_s" in m and "datasource.pool_used_bytes" in m


def test_events_reach_listeners(conn):
    created, completed = [], []
    conn.events.on_query_created(created.append)
    conn.events.on_query_completed(completed.append)
    conn.execute("select count(*) c from region")
    with pytest.raises(KeyError):
        conn.execute("select * from nowhere")
    assert [e.sql for e in created][-2:] == [
        "select count(*) c from region", "select * from nowhere"]
    assert [(e.state, e.rows) for e in completed][-2:] == [
        ("FINISHED", 1), ("FAILED", 0)]
    assert "unknown table nowhere" in completed[-1].error


def test_query_history(conn):
    conn.execute("select n_name from nation where n_nationkey = 7")
    info = conn.queries()[-1]
    assert info.state is QueryState.FINISHED and info.rows == 1


def test_blackhole_connector():
    r = LocalRunner(scale_factor=SF, device="cpu")
    bh = blackhole_connector()
    r.datasource.register(bh)
    t = r.run_sql("select r_regionkey k, r_name n from region")
    bh.page_sink.create_table("sink1", t)
    assert bh.metadata.rows_swallowed == 5
    assert "sink1" in bh.metadata.list_tables()
    assert r.run_sql("select count(*) c from sink1").to_pydict() == {"c": [0]}


# ---------------------------------------------------------------- CLI

_ROWS = [(1, 123456, 9131, None, "x"), (-2, -5, 0, 0.5, "yy")]
_TYPES = ["bigint", "decimal(12,2)", "date", "double", "varchar(3)"]


def test_cli_format_equals_jax():
    from presto_tpu.client import cli as jax_cli
    names = ["a", "b", "c", "d", "e"]
    assert cli.format_table(names, _ROWS, types=_TYPES) == \
        jax_cli.format_table(names, _ROWS, types=_TYPES)
    assert cli.format_table(names, _ROWS * 3, max_rows=4, types=_TYPES) == \
        jax_cli.format_table(names, _ROWS * 3, max_rows=4, types=_TYPES)
    for v, t in [(1234, "decimal(10,3)"), (-7, "decimal(5,2)"),
                 (1_000_000, "timestamp(3)"), (90_061_000_000,
                                               "interval day to second"),
                 (14, "interval year to month"), (None, "date")]:
        assert cli._fmt(v, t) == jax_cli._fmt(v, t)


def test_cli_execute(capsys):
    assert cli.main(["--device", "cpu", "-e", "select o_orderdate, "
                     "o_totalprice from orders order by o_orderkey "
                     "limit 2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].split() == ["o_orderdate", "|", "o_totalprice"]
    assert re.match(r"\d{4}-\d\d-\d\d\s+\|\s+\d+\.\d\d$", out[2].strip())
    assert out[-1].startswith("(2 rows in ")
    assert cli.main(["--device", "cpu", "-e", "select nope from region"]) \
        == 1
    assert "cannot resolve column nope" in capsys.readouterr().err


def test_cli_without_a_card_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["-e", "select 1 x from region"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
