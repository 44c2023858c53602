"""The program's DB-API edge, the entry of an embedded engine:
``presto_tpu_torch.client.api.connect(...)``, one cursor per client,
``cursor.execute(sql)`` then ``fetchall()``.

All clients share one connection and so one engine. The engine is
single-controller (its HTTP server serializes statements the same way),
so a statement holds the connection's lock from ``execute`` to its last
row; a client's latency counts its wait for the lock.
"""

from __future__ import annotations

import threading

from presto_tpu_torch.client.api import connect


class Client:
    def __init__(self, conn, lock: threading.Lock):
        self.cursor = conn.cursor()
        self.runner = conn._runner
        self.lock = lock

    def execute(self, sql: str):
        """(column names, rows, the statement's host syncs)."""
        with self.lock:
            self.cursor.execute(sql)
            rows = self.cursor.fetchall()
            return ([d[0] for d in self.cursor.description], rows,
                    self.runner.last_host_syncs)


class Session:
    def __init__(self, sf: float, device, attach, clients: int):
        self.conn = connect(scale_factor=sf, device=device)
        attach(self.conn._runner)
        lock = threading.Lock()
        self.clients = [Client(self.conn, lock) for _ in range(clients)]

    def close(self):
        self.clients = []
        self.conn = None


def open(sf: float, device, attach, clients: int) -> Session:  # noqa: A001
    return Session(sf, device, attach, clients)
