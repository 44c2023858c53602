"""Blackhole connector (reference: ``plugin/trino-blackhole``).

A null sink for write-path benchmarking and tests: CREATE/INSERT are
accepted and discarded (only the schema is remembered), reads return
zero rows.  Registered like any other connector through the SPI.

A copy of ``presto_tpu/connector/blackhole.py`` (it imports no jax).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data import types as T
from ..data.column import Column
from .spi import Connector, Split


class BlackholeConnector:
    def __init__(self):
        self.schemas: Dict[str, List[Tuple[str, T.DataType]]] = {}
        self.rows_swallowed = 0      # observability: writes counted

    # -- metadata
    def list_tables(self) -> List[str]:
        return list(self.schemas)

    def columns(self, table: str) -> List[Tuple[str, T.DataType]]:
        return list(self.schemas[table])

    def row_count(self, table: str) -> int:
        return 0

    def primary_key(self, table: str) -> Tuple[str, ...]:
        return ()

    def column_ndv(self, table: str, column: str) -> Optional[int]:
        return 0

    def column_range(self, table: str, column: str):
        return None

    # -- splits / source: always empty
    def splits(self, table: str, n_splits: int) -> List[Split]:
        return [Split(table, 0, 0) for _ in range(n_splits)]

    def read(self, table: str, columns: Sequence[str], first_row: int,
             row_count: int) -> Dict[str, Column]:
        out = {}
        for c, t in self.schemas[table]:
            if c in columns:
                dt = np.dtype(getattr(t, "np_dtype", np.int64))
                out[c] = Column(t, np.zeros(0, dt))
        return out

    # -- sink: swallow
    def create_table(self, name: str, columns) -> None:
        cols = columns.columns if hasattr(columns, "columns") else columns
        self.schemas[name] = [(n, c.dtype) for n, c in cols.items()]
        self.rows_swallowed += next(iter(cols.values())).row_count \
            if cols else 0

    def insert(self, name: str, columns) -> None:
        cols = columns.columns if hasattr(columns, "columns") else columns
        self.rows_swallowed += next(iter(cols.values())).row_count \
            if cols else 0

    def drop_table(self, name: str) -> None:
        self.schemas.pop(name, None)


def blackhole_connector() -> Connector:
    b = BlackholeConnector()
    return Connector("blackhole", b, b, b, page_sink=b, splittable=False)
