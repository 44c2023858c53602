"""REST statement protocol: server + minimal HTTP client.

The analogue of the reference's client protocol surface
(``dispatcher/QueuedStatementResource.java:176`` ``POST /v1/statement`` →
QueryResults JSON ``{id, columns, data, nextUri, stats, error}``; the client
polls ``nextUri`` until absent — ``client/trino-client/.../
StatementClientV1.java:323`` ``advance()``).  Single-process: behind the HTTP
surface is one Connection (a ``LocalRunner`` on one device); results are
paged out of memory token-by-token like
``server/protocol/ExecutingStatementResource.java``.

Intentionally loopback-oriented (no TLS; an optional shared-secret bearer
token).

Torch port of ``presto_tpu/client/server.py``.  Statements run on the
HTTP server's handler threads, one at a time behind ``_lock``; a kernel
launch takes the calling thread's current CUDA stream, and EXPLAIN
ANALYZE's fences (``torch.cuda.synchronize``) wait for every stream of
the card, so a statement's fences cover its launches.  The bearer secret
is compared in constant time (``hmac.compare_digest``; the JAX package
uses ``==``).  ``peakMemoryBytes`` is the pool's peak while the statement
ran.  The ``X-Trino-Session`` header is parsed, but the port has no
session property, so a statement that sets one fails.
"""

from __future__ import annotations

import hmac
import itertools
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from .cli import _fmt, nested_items

PAGE_ROWS = 1000

_ids = itertools.count(1)


def _json_value(v, dtype: str):
    """Wire rendering per type (the reference sends logical JSON values:
    dates/timestamps/decimals as strings, numbers as numbers; an ARRAY as
    a JSON array, a MAP as an object keyed by its keys' text, a ROW as an
    array of its field values, as Trino's protocol does; the JAX package
    sends a nested value through ``int``, which raises)."""
    if v is None:
        return None
    nested = nested_items(v, dtype)
    if nested is not None:
        kind, items = nested
        if kind != "map":
            return [_json_value(x, t) for _, x, t in items]
        out = {}
        for (k, kt), x, t in items:
            key = _json_value(k, kt)
            out[key if isinstance(key, str) else json.dumps(key)] = \
                _json_value(x, t)
        return out
    if dtype in ("date", "timestamp") or dtype.startswith("decimal("):
        return _fmt(v, dtype)
    if dtype == "boolean":
        return bool(v)
    if dtype == "double":
        return float(v)
    if dtype.startswith(("varchar", "char")):
        return str(v)
    return int(v)


class _QueryResult:
    def __init__(self, query_id: str, sql: str, trace_token=None):
        self.id = query_id
        self.sql = sql
        self.trace_token = trace_token   # X-Trino-Trace-Token analogue
        self.warnings: List[dict] = []
        self.state = "QUEUED"
        self.columns: List[Dict[str, str]] = []
        self.rows: List[List[Any]] = []
        self.error: Optional[str] = None
        self.error_code: Optional[tuple] = None  # (code, name, type)
        self.created = time.time()
        self.elapsed_s = 0.0
        self.peak_memory_bytes = 0


class StatementServer:
    """Serves the statement protocol for one engine Connection."""

    def __init__(self, connection, host: str = "127.0.0.1", port: int = 0,
                 resource_groups=None, shared_secret: Optional[str] = None,
                 compress: bool = False):
        self.connection = connection
        self._queries: Dict[str, _QueryResult] = {}
        self._lock = threading.Lock()        # engine is single-controller
        # optional admission control (parallel/resource_groups.py —
        # the DispatchManager + InternalResourceGroup role)
        self.resource_groups = resource_groups
        # internal-communication auth (reference:
        # ``server/security/InternalAuthenticationManager`` — shared-secret
        # bearer auth on every internal request; TLS is terminated in
        # front of the loopback server in this deployment shape)
        self.shared_secret = shared_secret
        # response compression flag (the exchange-compression analogue:
        # reference compresses exchange pages with LZ4,
        # ``FeaturesConfig.isExchangeCompressionEnabled``; the port has no
        # exchange, so the only wire worth compressing is this client
        # edge — gzip, stdlib)
        self.compress = compress
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                if server.compress and len(body) > 256 and "gzip" in \
                        self.headers.get("Accept-Encoding", ""):
                    import gzip as _gz
                    body = _gz.compress(body, compresslevel=1)
                    self.send_header("Content-Encoding", "gzip")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _authorized(self) -> bool:
                if server.shared_secret is None:
                    return True
                tok = self.headers.get("Authorization", "")
                return hmac.compare_digest(
                    tok.encode(), f"Bearer {server.shared_secret}".encode())

            def do_POST(self):
                if not self._authorized():
                    return self._send({"error": "unauthorized"}, 401)
                if self.path.rstrip("/") != "/v1/statement":
                    return self._send({"error": "not found"}, 404)
                n = int(self.headers.get("Content-Length", 0))
                sql = self.rfile.read(n).decode()
                user = self.headers.get("X-Trino-User", "presto")
                # session properties via header (reference:
                # client/ProtocolHeaders.java X-Trino-Session k=v,k=v)
                props = {}
                hdr = self.headers.get("X-Trino-Session", "")
                for kv in hdr.split(","):
                    if "=" in kv:
                        k, v = kv.split("=", 1)
                        props[k.strip()] = v.strip()
                trace = self.headers.get("X-Trace-Token")
                q = server._execute(sql, user, props, trace_token=trace)
                # first hop mirrors the queued→executing redirect: no data
                self._send(server._results(q, token=0, data=False))

            def do_GET(self):
                if not self._authorized():
                    return self._send({"error": "unauthorized"}, 401)
                parts = self.path.strip("/").split("/")
                if self.path.rstrip("/") in ("", "/ui"):
                    # Web UI (the reference's query overview page,
                    # ``core/trino-web-ui``): server-rendered — query
                    # list + states + timings over the same JSON the
                    # protocol exposes
                    body = server._ui_html().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if parts[:2] == ["v1", "info"]:
                    return self._send({"nodeVersion":
                                       {"version": "presto-tpu-torch"},
                                       "coordinator": True,
                                       "starting": False})
                if len(parts) >= 2 and parts[0] == "v1" \
                        and parts[1].lower() == "resourcegroup":
                    rg = server.resource_groups
                    return self._send([] if rg is None else rg.info())
                if parts[:2] == ["v1", "query"] and len(parts) == 2:
                    return self._send([{
                        "queryId": q.id, "state": q.state,
                        "query": q.sql, "elapsedSeconds": q.elapsed_s,
                    } for q in server._queries.values()])
                if (len(parts) == 5 and parts[:3] ==
                        ["v1", "statement", "executing"]):
                    qid, token = parts[3], int(parts[4])
                    q = server._queries.get(qid)
                    if q is None:
                        return self._send({"error": "unknown query"}, 404)
                    return self._send(server._results(q, token, data=True))
                self._send({"error": "not found"}, 404)

            def do_DELETE(self):
                # cancellation: queries run synchronously, so this only
                # acknowledges (reference allows best-effort cancel)
                self.send_response(204)
                self.end_headers()

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()

    # -- protocol bodies --------------------------------------------------

    def _execute(self, sql: str, user: str,
                 session_props: Optional[dict] = None,
                 trace_token: Optional[str] = None) -> _QueryResult:
        q = _QueryResult(f"q_{next(_ids)}", sql, trace_token=trace_token)
        self._queries[q.id] = q
        t0 = time.monotonic()
        slot = None
        if self.resource_groups is not None:
            from ..utils.errors import classify
            try:
                slot = self.resource_groups.acquire(user)
            except Exception as e:  # noqa: BLE001 — queue full / timeout
                q.state = "FAILED"
                q.error = f"{type(e).__name__}: {e}"
                q.error_code = classify(e)
                q.elapsed_s = time.monotonic() - t0
                return q
        try:
            return self._execute_admitted(q, sql, session_props, t0)
        finally:
            if slot is not None:
                slot.__exit__(None, None, None)

    def _execute_admitted(self, q, sql, session_props, t0) -> _QueryResult:
        pool = self.connection._runner.datasource.pool
        with self._lock:
            pool.reset_peak()  # the peak of this statement alone
            try:
                for k in session_props or {}:
                    # the port reads no session property: one it would
                    # ignore fails the statement (the JAX package's error)
                    raise KeyError(f"unknown session property {k!r}")
                cur = self.connection.execute(sql)
                types = [d[1] for d in cur.description or []]
                q.columns = [{"name": d[0], "type": d[1]}
                             for d in cur.description or []]
                q.rows = [[_json_value(v, t) for v, t in zip(row, types)]
                          for row in cur.fetchall()]
                q.state = "FINISHED"
                q.warnings = cur.warnings
                q.peak_memory_bytes = pool.peak
            except Exception as e:  # noqa: BLE001 - surfaced via protocol
                from ..utils.errors import classify
                q.state = "FAILED"
                q.error = f"{type(e).__name__}: {e}"
                q.error_code = classify(e)
        q.elapsed_s = time.monotonic() - t0
        return q

    def _ui_html(self) -> str:
        import html as _h
        rows = []
        for q in sorted(self._queries.values(), key=lambda x: x.created,
                        reverse=True):
            color = {"FINISHED": "#2e7d32", "FAILED": "#c62828"}.get(
                q.state, "#f9a825")
            err = f"<div class=err>{_h.escape(q.error)}</div>" if q.error \
                else ""
            rows.append(
                f"<tr><td>{q.id}</td>"
                f"<td><span style='color:{color}'>{q.state}</span></td>"
                f"<td>{q.elapsed_s * 1000:.0f} ms</td>"
                f"<td>{len(q.rows)}</td>"
                f"<td>{q.peak_memory_bytes // 1024} KiB</td>"
                f"<td><code>{_h.escape(q.sql[:200])}</code>{err}</td></tr>")
        rg = ""
        if self.resource_groups is not None:
            items = "".join(
                f"<li>{_h.escape(str(g))}</li>"
                for g in self.resource_groups.info())
            rg = f"<h2>Resource groups</h2><ul>{items}</ul>"
        return (
            "<!doctype html><html><head><title>presto_tpu_torch</title>"
            "<style>"
            "body{font-family:monospace;margin:2em}table{border-collapse:"
            "collapse}td,th{border:1px solid #ccc;padding:4px 8px;"
            "text-align:left}.err{color:#c62828;font-size:smaller}"
            "</style></head><body><h1>presto_tpu coordinator</h1>"
            f"<p>{len(self._queries)} queries this session</p>"
            "<table><tr><th>query</th><th>state</th><th>elapsed</th>"
            "<th>rows</th><th>peak mem</th><th>sql</th></tr>"
            + "".join(rows) + "</table>" + rg + "</body></html>")

    def _results(self, q: _QueryResult, token: int, data: bool) -> dict:
        done = q.state in ("FINISHED", "FAILED")
        out: dict = {
            "id": q.id,
            "infoUri": f"{self.url}/v1/query/{q.id}",
            # progress stats (reference: StatementStats built from
            # QueryStats — state/elapsed/rows/bytes/memory/progress)
            "stats": {"state": q.state,
                      "queued": q.state == "QUEUED",
                      "scheduled": done,
                      "elapsedTimeMillis": int(q.elapsed_s * 1000),
                      "processedRows": len(q.rows),
                      "peakMemoryBytes": q.peak_memory_bytes,
                      "progressPercentage": 100.0 if done else 0.0},
        }
        if q.warnings:
            out["warnings"] = q.warnings
        if q.trace_token is not None:
            # trace-token propagation (reference:
            # ``server/GenerateTraceTokenRequestFilter.java`` threads a
            # token through every request of one query)
            out["traceToken"] = q.trace_token
        if q.error is not None:
            code, name, etype = q.error_code or (65536,
                                                 "GENERIC_INTERNAL_ERROR",
                                                 "INTERNAL_ERROR")
            out["error"] = {"message": q.error, "errorCode": code,
                            "errorName": name, "errorType": etype}
            return out
        if q.columns:
            out["columns"] = q.columns
        if data:
            page = q.rows[token * PAGE_ROWS:(token + 1) * PAGE_ROWS]
            if page:
                out["data"] = page
            if (token + 1) * PAGE_ROWS < len(q.rows):
                out["nextUri"] = (f"{self.url}/v1/statement/executing/"
                                  f"{q.id}/{token + 1}")
        else:
            out["nextUri"] = (f"{self.url}/v1/statement/executing/"
                              f"{q.id}/{token}")
        return out


class HttpClient:
    """Minimal StatementClientV1 analogue: POST then follow nextUri."""

    def __init__(self, base_url: str, user: str = "presto",
                 token: Optional[str] = None, accept_gzip: bool = False):
        self.base_url = base_url.rstrip("/")
        self.user = user
        self.token = token            # shared-secret bearer auth
        self.accept_gzip = accept_gzip

    def _headers(self) -> dict:
        h = {"X-Trino-User": self.user}
        if self.token is not None:
            h["Authorization"] = f"Bearer {self.token}"
        if self.accept_gzip:
            h["Accept-Encoding"] = "gzip"
        return h

    def _read(self, resp):
        raw = resp.read()
        if resp.headers.get("Content-Encoding") == "gzip":
            import gzip as _gz
            raw = _gz.decompress(raw)
        return json.loads(raw)

    def execute(self, sql: str) -> Tuple[List[dict], List[list]]:
        import urllib.request
        req = urllib.request.Request(
            f"{self.base_url}/v1/statement", data=sql.encode(),
            headers=self._headers(), method="POST")
        with urllib.request.urlopen(req) as resp:
            body = self._read(resp)
        columns: List[dict] = []
        rows: List[list] = []
        while True:
            if "error" in body:
                raise RuntimeError(body["error"]["message"])
            columns = body.get("columns", columns)
            rows.extend(body.get("data", []))
            nxt = body.get("nextUri")
            if nxt is None:
                return columns, rows
            req = urllib.request.Request(nxt, headers=self._headers())
            with urllib.request.urlopen(req) as resp:
                body = self._read(resp)
