"""Transactions — the ``InMemoryTransactionManager`` analogue.

The reference runs every query in a transaction (autocommit unless the
session opened one explicitly); isolation for the memory connector is
snapshot-by-immutability: a transaction observes the table versions that
existed when it began, and its writes become visible atomically at
commit (``transaction/InMemoryTransactionManager.java`` +
the memory connector's append-only page lists).

Here tables are already immutable ``Table`` snapshots, so a transaction
is literally a pinned ``{name: Table}`` dict: reads inside the
transaction resolve against the pin; buffered writes replace the pin
locally and publish to the shared catalog on ``commit()`` (discarded on
``rollback()``).  Autocommit = a transaction per statement, which is the
engine's default behavior without this object.

A copy of ``presto_tpu/utils/transactions.py``.  The port's connection
swaps the memory catalog through ``DataSource.swap_memory``, which also
drops the device columns of every table a rolled-back transaction wrote.
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict, Optional

_txn_ids = itertools.count(1)


class Transaction:
    def __init__(self, datasource):
        self.id = f"txn_{next(_txn_ids)}"
        self._ds = datasource
        # pinned snapshot: the memory catalog as of BEGIN
        self._snapshot: Dict[str, object] = dict(datasource.memory)
        self._writes: Dict[str, Optional[object]] = {}  # None = dropped
        self._state = "active"

    # -- reads: the engine resolves tables through this view
    def table(self, name: str):
        if name in self._writes:
            t = self._writes[name]
            if t is None:
                raise KeyError(name)
            return t
        return self._snapshot[name]

    def tables(self) -> Dict[str, object]:
        out = dict(self._snapshot)
        for k, v in self._writes.items():
            if v is None:
                out.pop(k, None)
            else:
                out[k] = v
        return out

    # -- buffered writes
    def create_table(self, name: str, table) -> None:
        assert self._state == "active"
        self._writes[name] = table

    def drop_table(self, name: str) -> None:
        assert self._state == "active"
        self._writes[name] = None

    # -- lifecycle
    def commit(self) -> None:
        assert self._state == "active", self._state
        for name, t in self._writes.items():
            if t is None:
                if name in self._ds.memory:
                    self._ds.drop_table(name)
            else:
                self._ds.create_table(name, t)
        self._state = "committed"

    def rollback(self) -> None:
        assert self._state == "active", self._state
        self._writes.clear()
        self._state = "rolled back"


class TransactionManager:
    """Per-runner transaction registry (autocommit unless begun)."""

    def __init__(self, datasource):
        self._ds = datasource
        self._lock = threading.Lock()
        self._active: Dict[str, Transaction] = {}

    def begin(self) -> Transaction:
        t = Transaction(self._ds)
        with self._lock:
            self._active[t.id] = t
        return t

    def get(self, txn_id: str) -> Transaction:
        return self._active[txn_id]

    def finish(self, txn_id: str) -> None:
        with self._lock:
            self._active.pop(txn_id, None)
