"""The port's HTTP statement protocol on the CPU at ``tiny``:
``POST /v1/statement``, ``nextUri`` paging, logical value rendering, the
error taxonomy, query list and info, DML, stats, the session header,
warnings, resource groups, ``/ui``, the shared secret, gzip and the trace
token.

The statements of ``PARITY`` go, in order, to the JAX package's
``StatementServer`` and to the port's; every response body of every page
must be equal (tolerance 0) once the ids, URIs and timings are taken out.
The rest is held to Python oracles, among them the one divergence: the
port compares the bearer secret in constant time.
"""

import gzip
import json
import threading
import urllib.error
import urllib.request

import pytest

from presto_tpu_torch.client.api import connect
from presto_tpu_torch.client.server import (PAGE_ROWS, HttpClient,
                                            StatementServer)
from presto_tpu_torch.parallel.resource_groups import (ResourceGroup,
                                                       ResourceGroupManager)

SF = 0.01
# (name, sql, headers), sent in this order to both servers
PARITY = [
    ("simple", "select n_name, n_nationkey from nation "
               "order by n_nationkey limit 3", {}),
    ("paging", f"select o_orderkey, o_custkey from orders "
               f"order by o_orderkey limit {2 * PAGE_ROWS + 500}", {}),
    ("rendering", "select o_orderdate, o_totalprice, o_orderpriority, "
                  "o_shippriority from orders order by o_orderkey limit 5",
     {}),
    ("table_not_found", "select * from no_such_table_xyz", {}),
    ("syntax_error", "selec 1 from nation", {}),
    ("session_header", "select r_regionkey from region order by 1 limit 2",
     {"X-Trino-Session": "no_such_property=1"}),
    ("cross_join_warning", "select count(*) c from region, nation", {}),
    ("dml_ctas", "create table http_t as "
                 "select n_nationkey k, n_regionkey r from nation", {}),
    ("dml_delete", "delete from http_t where r = 0", {}),
    ("dml_update", "update http_t set k = k + 1000 where r = 1", {}),
    ("dml_read", "select count(*) c, sum(k) s from http_t", {}),
    ("dml_drop", "drop table http_t", {}),
]
_TIMING = ("elapsedTimeMillis", "peakMemoryBytes")


def _post(url, sql, headers=None):
    req = urllib.request.Request(f"{url}/v1/statement", data=sql.encode(),
                                 headers=headers or {}, method="POST")
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read())


def _pages(url, sql, headers=None) -> list:
    """Every response body of one statement, first POST to last page."""
    bodies = [_post(url, sql, headers)]
    while "nextUri" in bodies[-1]:
        with urllib.request.urlopen(bodies[-1]["nextUri"]) as r:
            bodies.append(json.loads(r.read()))
    return bodies


def _strip(body: dict) -> dict:
    """A body without its ids, URIs and timings."""
    out = {k: v for k, v in body.items()
           if k not in ("id", "infoUri", "nextUri")}
    out["stats"] = {k: v for k, v in body["stats"].items()
                    if k not in _TIMING}
    out["has_next"] = "nextUri" in body
    return out


@pytest.fixture(scope="module")
def server():
    srv = StatementServer(connect(scale_factor=SF, device="cpu"))
    yield srv
    srv.close()


@pytest.fixture(scope="module")
def parity(server):
    from presto_tpu.client.api import connect as jax_connect
    from presto_tpu.client.server import StatementServer as JaxServer
    ref = JaxServer(jax_connect(scale_factor=SF))
    try:
        return {name: ([_strip(b) for b in _pages(server.url, sql, hdr)],
                       [_strip(b) for b in _pages(ref.url, sql, hdr)])
                for name, sql, hdr in PARITY}
    finally:
        ref.close()


@pytest.mark.parametrize("name", [p[0] for p in PARITY])
def test_response_bodies_equal_jax_server(parity, name):
    got, want = parity[name]
    assert got == want


def test_parity_results_are_the_protocols(parity):
    """What the compared bodies hold (so the parity above is not between
    two equal failures)."""
    r = {k: v[0] for k, v in parity.items()}
    assert r["simple"][1]["data"] == [["ALGERIA", 0], ["ARGENTINA", 1],
                                      ["BRAZIL", 2]]
    assert [len(b.get("data", [])) for b in r["paging"]] == \
        [0, PAGE_ROWS, PAGE_ROWS, 500]
    assert [c["type"] for c in r["rendering"][0]["columns"]] == \
        ["date", "decimal(15,2)", "varchar(15)", "bigint"]
    date, price, prio, ship = r["rendering"][1]["data"][0]
    assert len(date.split("-")) == 3 and "." in price
    assert isinstance(prio, str) and isinstance(ship, int)
    for name, err in (("table_not_found", "TABLE_NOT_FOUND"),
                      ("syntax_error", "SYNTAX_ERROR")):
        assert r[name][0]["error"]["errorName"] == err
        assert r[name][0]["stats"]["state"] == "FAILED"
    assert r["session_header"][0]["error"]["message"] == \
        "KeyError: \"unknown session property 'no_such_property'\""
    assert r["cross_join_warning"][0]["warnings"][0]["warningCode"] == \
        "CROSS_JOIN"
    assert [b["data"] for b in (r["dml_delete"][1], r["dml_update"][1],
                                r["dml_read"][1])] == \
        [[[5]], [[5]], [[20, 300 - (0 + 5 + 14 + 15 + 16) + 5 * 1000]]]


def test_http_client_pages_and_errors(server):
    cli = HttpClient(server.url)
    cols, rows = cli.execute(f"select o_orderkey from orders "
                             f"order by o_orderkey limit {3 * PAGE_ROWS}")
    assert [c["name"] for c in cols] == ["o_orderkey"]
    assert len(rows) == 3 * PAGE_ROWS and rows[0] == [1]
    with pytest.raises(RuntimeError, match="unknown table"):
        cli.execute("select * from nowhere")
    # the server still answers after a failure
    assert cli.execute("select count(*) c from nation")[1] == [[25]]


def test_not_supported_through_the_protocol(server):
    body = _post(server.url,
                 "select reverse(split(r_name, 'A')) m from region")
    assert body["error"]["errorName"] == "NOT_SUPPORTED"
    assert body["error"]["errorType"] == "USER_ERROR"


def test_query_list_and_info(server):
    HttpClient(server.url).execute("select 1 x from region limit 1")
    _post(server.url, "select * from nowhere_else")
    with urllib.request.urlopen(f"{server.url}/v1/query") as r:
        states = {q["state"] for q in json.loads(r.read())}
    assert {"FINISHED", "FAILED"} <= states
    with urllib.request.urlopen(f"{server.url}/v1/info") as r:
        assert json.loads(r.read())["coordinator"] is True


def test_stats_and_peak_memory(server):
    body = _post(server.url, "select count(*) c from nation")
    st = body["stats"]
    assert st["state"] == "FINISHED" and st["scheduled"] is True
    assert st["progressPercentage"] == 100.0
    ds = server.connection._runner.datasource
    assert 0 < st["peakMemoryBytes"] == ds.pool.peak


def test_peak_memory_is_the_statements(server):
    """``peakMemoryBytes`` is the pool's peak while the statement ran: after
    a CTAS is dropped, a statement over cached columns reports what stays
    reserved, not the pool's peak of the CTAS."""
    ds = server.connection._runner.datasource
    _post(server.url, "select count(*) c from customer")
    cli = HttpClient(server.url)
    cli.execute("create table peak_t as select c_custkey, c_acctbal "
                "from customer")
    cli.execute("select sum(c_acctbal) s from peak_t")
    high = ds.pool.peak
    cli.execute("drop table peak_t")
    st = _post(server.url, "select count(*) c from customer")["stats"]
    assert 0 < st["peakMemoryBytes"] == ds.pool.used < high


@pytest.mark.parametrize("prop", ["join_distribution_type=BROADCAST",
                                  "hash_partition_count=4",
                                  "query_max_run_time_s=1"])
def test_session_property_the_port_does_not_read_fails(server, prop):
    """The port acts on no session property, so one sent in the header
    fails the statement rather than being ignored (the JAX package accepts
    these three and acts on none of them)."""
    body = _post(server.url, "select count(*) c from region",
                 {"X-Trino-Session": prop})
    assert body["stats"]["state"] == "FAILED"
    assert body["error"]["errorName"] == "GENERIC_USER_ERROR"
    assert repr(prop.split("=")[0]) in body["error"]["message"]
    assert HttpClient(server.url).execute(
        "select count(*) c from region")[1] == [[5]]


def test_explain_analyze_over_http(server):
    _, rows = HttpClient(server.url).execute(
        "explain analyze select n_regionkey, count(*) c from nation "
        "group by n_regionkey order by 1")
    lines = [r[0] for r in rows]
    nodes = [ln for ln in lines if ln.lstrip().startswith("- ")]
    assert nodes and all("rows: " in ln and "ms" in ln for ln in nodes)
    assert "{rows: 5," in nodes[0]
    assert any(ln.startswith("analyze: ") for ln in lines)


def test_resource_groups_admit_concurrent_clients():
    mgr = ResourceGroupManager(
        [ResourceGroup("g", hard_concurrency_limit=1, max_queued=64)],
        [("*", "g")])
    srv = StatementServer(connect(scale_factor=SF, device="cpu"),
                          resource_groups=mgr)
    try:
        sqls = ["select count(*) c from region",
                "select sum(n_nationkey) s from nation",
                "select count(*) c from nation, region "
                "where n_regionkey = r_regionkey"]
        results, errors = [], []

        def client():
            try:
                cli = HttpClient(srv.url)
                results.append([cli.execute(q)[1] for q in sqls])
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        threads = [threading.Thread(target=client) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        assert results == [[[[5]], [[300]], [[25]]]] * 4
        with urllib.request.urlopen(f"{srv.url}/v1/resourceGroup") as r:
            info = json.loads(r.read())
        assert info[0]["name"] == "g" and info[0]["admitted"] == 12
        assert info[0]["running"] == 0 and info[0]["queued"] == 0
    finally:
        srv.close()


def test_web_ui(server):
    HttpClient(server.url).execute("select count(*) c from region")
    with urllib.request.urlopen(server.url + "/ui") as resp:
        body = resp.read().decode()
    assert "presto_tpu coordinator" in body
    assert "FINISHED" in body and "count(*)" in body


@pytest.mark.parametrize("token,code", [
    (None, 401), ("s3cr3u", 401), ("s3cr", 401), ("s3cr3t-", 401),
    ("", 401), ("s3cr3t", 200)])
def test_shared_secret(token, code):
    """The secret is compared with ``hmac.compare_digest``: a wrong secret
    of the right length, a prefix and an extension are all refused."""
    srv = StatementServer(connect(scale_factor=SF, device="cpu"),
                          shared_secret="s3cr3t")
    try:
        cli = HttpClient(srv.url, token=token)
        if code == 401:
            with pytest.raises(urllib.error.HTTPError) as ei:
                cli.execute("select 1 as x from region limit 1")
            assert ei.value.code == 401
        else:
            assert cli.execute("select 1 as x from region limit 1")[1] == \
                [[1]]
    finally:
        srv.close()


def test_gzip_negotiation():
    srv = StatementServer(connect(scale_factor=SF, device="cpu"),
                          compress=True)
    try:
        first = _post(srv.url, "select o_orderkey from orders "
                               "order by o_orderkey limit 2000")
        req = urllib.request.Request(first["nextUri"],
                                     headers={"Accept-Encoding": "gzip"})
        with urllib.request.urlopen(req) as r:
            assert r.headers["Content-Encoding"] == "gzip"
            page = json.loads(gzip.decompress(r.read()))
        assert page["data"][:2] == [[1], [2]]
        _, rows = HttpClient(srv.url, accept_gzip=True).execute(
            "select o_orderkey from orders order by o_orderkey limit 2000")
        assert len(rows) == 2000
        # a client that does not accept gzip gets plain JSON
        assert HttpClient(srv.url).execute(
            "select count(*) c from nation")[1] == [[25]]
    finally:
        srv.close()


def test_trace_token_roundtrip(server):
    out = _post(server.url, "select count(*) c from region",
                {"X-Trace-Token": "tok-42"})
    assert out["traceToken"] == "tok-42"
    with urllib.request.urlopen(out["nextUri"]) as r:
        assert json.loads(r.read())["traceToken"] == "tok-42"


def test_delete_acknowledges(server):
    req = urllib.request.Request(f"{server.url}/v1/statement/executing/x/0",
                                 method="DELETE")
    with urllib.request.urlopen(req) as r:
        assert r.status == 204


@pytest.mark.parametrize("policy", ["fair", "weighted_fair", "weighted",
                                    "query_priority"])
def test_resource_group_admission_equals_jax(policy):
    """The port's copy of the group tree admits queued statements in the
    JAX package's order under each scheduling policy, and rejects a full
    queue the same way."""
    import time
    from presto_tpu.parallel import resource_groups as JR
    from presto_tpu_torch.parallel import resource_groups as PR

    def scenario(R):
        mgr = R.ResourceGroupManager(
            [R.ResourceGroup("root", hard_concurrency_limit=1, max_queued=4,
                             scheduling_policy=policy),
             R.ResourceGroup("a", parent="root", weight=3, max_queued=2),
             R.ResourceGroup("b", parent="root", weight=1, max_queued=2)],
            [("ua", "a"), ("*", "b")])
        admitted, threads = [], []
        first = mgr.acquire("ua")

        def queued(user, priority):
            with mgr.acquire(user, timeout_s=5, priority=priority):
                admitted.append(user + str(priority))

        for user, prio in (("ub", 1), ("ua", 0), ("ub", 5), ("ua", 2)):
            threads.append(threading.Thread(target=queued,
                                            args=(user, prio)))
            threads[-1].start()
            time.sleep(0.05)
        with pytest.raises(R.QueryQueueFullError):
            mgr.acquire("ua")
        first.__exit__(None, None, None)
        for t in threads:
            t.join(5)
        return admitted, [{k: v for k, v in g.items() if k != "cpuSeconds"}
                          for g in mgr.info()]

    got, want = scenario(PR), scenario(JR)
    assert got == want
    assert len(got[0]) == 4 and got[1][1]["rejected"] == 1
