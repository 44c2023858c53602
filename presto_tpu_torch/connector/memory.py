"""Writable in-memory connector (reference: ``plugin/trino-memory``).

Tables are host ``Table`` snapshots; every write replaces the snapshot
(immutable-pages model — the reference's memory connector also appends
whole pages and serves immutable reads).

A copy of ``presto_tpu/connector/memory.py`` (it imports no jax).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data import types as T
from ..data.column import Column
from ..data.table import Table
from .spi import Connector, Split


class MemoryConnector:
    """Metadata + splits + source + sink in one object (each protocol is
    satisfied by a subset of its methods)."""

    def __init__(self, on_change=None):
        self.tables: Dict[str, Table] = {}
        self._on_change = on_change or (lambda: None)

    # -- metadata
    def list_tables(self) -> List[str]:
        return list(self.tables)

    def columns(self, table: str) -> List[Tuple[str, T.DataType]]:
        t = self.tables[table]
        return [(name, col.dtype) for name, col in t.columns.items()]

    def row_count(self, table: str) -> int:
        return self.tables[table].row_count

    def primary_key(self, table: str) -> Tuple[str, ...]:
        return ()

    def column_ndv(self, table: str, column: str) -> Optional[int]:
        return None

    def column_range(self, table: str, column: str):
        return None

    # -- splits
    def splits(self, table: str, n_splits: int) -> List[Split]:
        total = self.tables[table].row_count
        per = (total + n_splits - 1) // n_splits
        return [Split(table, min(k * per, total),
                      min(per, total - min(k * per, total)))
                for k in range(n_splits)]

    # -- page source
    def read(self, table: str, columns: Sequence[str], first_row: int,
             row_count: int) -> Dict[str, Column]:
        t = self.tables[table]
        out = {}
        for c in columns:
            col = t.columns[c]
            out[c] = col if (first_row == 0
                             and row_count >= t.row_count) else \
                col.slice(first_row, row_count)
        return out

    # -- page sink
    def create_table(self, name: str, columns: Dict[str, Column]) -> None:
        self.tables[name] = columns if isinstance(columns, Table) \
            else Table(dict(columns))
        self._on_change()

    def insert(self, name: str, columns: Dict[str, Column]) -> None:
        from ..exec.datasource import _concat_host_cols
        base = self.tables[name]
        src = columns if isinstance(columns, Table) else Table(dict(columns))
        assert len(base.names) == len(src.names), \
            "INSERT column count mismatch"
        merged = {}
        for cname, sname in zip(base.names, src.names):   # positional
            merged[cname] = _concat_host_cols(base.columns[cname],
                                              src.columns[sname])
        self.tables[name] = Table(merged)
        self._on_change()

    def drop_table(self, name: str) -> None:
        del self.tables[name]
        self._on_change()


def memory_connector(on_change=None) -> Connector:
    m = MemoryConnector(on_change)
    return Connector("memory", m, m, m, page_sink=m,
                     splittable=False)
