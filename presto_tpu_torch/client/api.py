"""Client API: DB-API 2.0-style connections + cursors.

The single-process analogue of the reference's client stack
(``client/trino-client`` StatementClientV1 + ``client/trino-jdbc``): a
Connection binds a Session (schema and user); Cursors execute
SQL and iterate row tuples.  Query state moves through the same lifecycle
states as the reference's FSM (``execution/QueryState.java``).

Torch port of ``presto_tpu/client/api.py``.  ``connect`` takes
``device=``: ``None`` runs on ``cuda`` and raises without a card
(``exec.runner.resolve_device``); only ``device="cpu"`` runs on the CPU.
A transaction's begin and end swap the memory catalog through
``DataSource.swap_memory``, so a rollback also drops the device columns
cached from the tables the transaction wrote (the JAX package keeps them,
and a rolled-back UPDATE stays visible there).
"""

from __future__ import annotations

import enum
import itertools
import re
import time
from dataclasses import dataclass, field
from typing import Any, Iterator, List, Optional, Sequence, Tuple

from ..exec.runner import LocalRunner
from ..utils.config import Session
from ..utils.events import (EventListenerManager, QueryCompletedEvent,
                            QueryCreatedEvent)
from ..utils.tracing import span, statement


class QueryState(enum.Enum):
    QUEUED = "QUEUED"
    PLANNING = "PLANNING"
    RUNNING = "RUNNING"
    FINISHED = "FINISHED"
    FAILED = "FAILED"


_query_ids = itertools.count(1)


@dataclass
class QueryInfo:
    query_id: str
    sql: str
    state: QueryState = QueryState.QUEUED
    error: Optional[str] = None
    elapsed_s: float = 0.0
    rows: int = 0


_PLACEHOLDER = re.compile(r"'(?:[^']|'')*'|\?")


def _literal(p: Any) -> str:
    if p is None:
        return "NULL"
    if isinstance(p, bool):
        return "TRUE" if p else "FALSE"
    if isinstance(p, str):
        return "'" + p.replace("'", "''") + "'"
    return repr(p)


def _bind(sql: str, params: Sequence[Any]) -> str:
    """``sql`` with each ``?`` outside a string literal replaced, in one
    pass, by the next parameter as a SQL literal (a quote in a string
    doubled).  The JAX package replaces the first ``?`` of the text once
    per parameter and quotes a string as it is, so a quote in a value
    breaks out of its literal and a ``?`` in a value takes the next
    parameter."""
    vals, used = list(params), 0

    def sub(m):
        nonlocal used
        if m.group(0) != "?":
            return m.group(0)  # a literal of the SQL text itself
        if used == len(vals):
            raise ValueError(f"{len(vals)} parameters for more '?' "
                             "placeholders")
        used += 1
        return _literal(vals[used - 1])

    out = _PLACEHOLDER.sub(sub, sql)
    if used != len(vals):
        raise ValueError(f"{len(vals)} parameters for {used} '?' "
                         "placeholders")
    return out


class Cursor:
    def __init__(self, conn: "Connection"):
        self.conn = conn
        self.description: Optional[List[Tuple]] = None
        self.rowcount = -1
        self._rows: List[Tuple] = []
        self._pos = 0
        self.last_query: Optional[QueryInfo] = None

    def execute(self, sql: str, params: Sequence[Any] = ()) -> "Cursor":
        if params:
            sql = _bind(sql, params)
        info = QueryInfo(f"q_{next(_query_ids)}", sql)
        self.last_query = info
        self.conn._queries.append(info)
        with statement(info.query_id):
            self._run(info)
        return self

    def _run(self, info: QueryInfo) -> None:
        sql = info.sql
        self.conn.events.query_created(QueryCreatedEvent(
            info.query_id, sql, self.conn.session.user))
        t0 = time.monotonic()
        try:
            info.state = QueryState.PLANNING
            table = self.conn._runner.run_sql(sql)
            info.state = QueryState.FINISHED
            info.rows = table.row_count
        except Exception as e:  # noqa: BLE001 - surface engine errors
            info.state = QueryState.FAILED
            info.error = f"{type(e).__name__}: {e}"
            raise
        finally:
            # the completed event carries the row count (the JAX package
            # sends it before counting, so always 0)
            info.elapsed_s = time.monotonic() - t0
            self.conn.events.query_completed(QueryCompletedEvent(
                info.query_id, sql, self.conn.session.user,
                info.state.value, info.elapsed_s, info.rows, info.error))
        with span("result_rows"):
            data = table.to_pydict()
            names = list(data.keys())
            self._rows = list(zip(*[data[n] for n in names])) if names else []
        # planning/execution warnings (reference: WarningCollector on the
        # query; surfaced in QueryResults.warnings)
        self.warnings = self.conn._runner.last_warnings.as_dicts()
        self.description = [(n, str(table.columns[n].dtype),
                             None, None, None, None, None)
                            for n in names]
        self._pos = 0
        self.rowcount = len(self._rows)

    def fetchone(self) -> Optional[Tuple]:
        if self._pos >= len(self._rows):
            return None
        row = self._rows[self._pos]
        self._pos += 1
        return row

    def fetchmany(self, size: int = 1000) -> List[Tuple]:
        out = self._rows[self._pos:self._pos + size]
        self._pos += len(out)
        return out

    def fetchall(self) -> List[Tuple]:
        out = self._rows[self._pos:]
        self._pos = len(self._rows)
        return out

    def __iter__(self) -> Iterator[Tuple]:
        while True:
            r = self.fetchone()
            if r is None:
                return
            yield r

    def close(self):
        self._rows = []


class Connection:
    def __init__(self, schema: str = "tiny",
                 scale_factor: Optional[float] = None,
                 session: Optional[Session] = None, device=None,
                 access_control=None):
        self.session = session or Session(schema=schema)
        self._runner = LocalRunner(schema=self.session.schema,
                                   scale_factor=scale_factor, device=device,
                                   access_control=access_control)
        self._queries: List[QueryInfo] = []
        self.events = EventListenerManager()
        self._txn = None
        self._tm = None
        self._pre_txn_tables = None

    def cursor(self) -> Cursor:
        return Cursor(self)

    def execute(self, sql: str) -> Cursor:
        return self.cursor().execute(sql)

    # -- explicit transactions (reference: InMemoryTransactionManager;
    # autocommit per statement unless begun).  Reads inside an open
    # transaction observe the memory-catalog snapshot pinned at begin();
    # writes buffer in the transaction and publish atomically at commit.
    def begin(self):
        from ..utils.transactions import TransactionManager
        assert self._txn is None, "transaction already open"
        if self._tm is None:
            self._tm = TransactionManager(self._runner.datasource)
        self._txn = self._tm.begin()
        ds = self._runner.datasource
        self._pre_txn_tables = ds.memory
        ds.swap_memory(dict(self._txn.tables()))
        return self._txn

    def commit(self):
        assert self._txn is not None, "no open transaction"
        txn, self._txn = self._txn, None
        ds = self._runner.datasource
        # session-buffered DDL became the connection's memory dict; diff
        # it against the snapshot into the transaction's write set
        for name, t in ds.memory.items():
            if self._pre_txn_tables.get(name) is not t:
                txn.create_table(name, t)
        for name in set(self._pre_txn_tables) - set(ds.memory):
            txn.drop_table(name)
        self._restore(ds)
        txn.commit()
        self._tm.finish(txn.id)

    def rollback(self):
        assert self._txn is not None, "no open transaction"
        txn, self._txn = self._txn, None
        self._restore(self._runner.datasource)
        txn.rollback()
        self._tm.finish(txn.id)

    def _restore(self, ds):
        # back to the snapshot of begin(); every table the transaction
        # wrote loses its cached device columns
        ds.swap_memory(self._pre_txn_tables)

    def queries(self) -> List[QueryInfo]:
        """Query history (the ``/v1/query`` QueryResource analogue)."""
        return list(self._queries)

    def close(self):
        pass


def connect(schema: str = "tiny", scale_factor: Optional[float] = None,
            device=None, **kw) -> Connection:
    return Connection(schema=schema, scale_factor=scale_factor,
                      device=device, **kw)
