"""TPC-DS connector through the formal SPI (reference:
``plugin/trino-tpcds``).

The generator is spec-shaped (deterministic hash-mix streams with the spec
schemas/row counts) rather than dsdgen-bit-faithful; correctness of the
engine on TPC-DS shapes is established by SQLite differential tests, not by
comparing to dsdgen output.  Generated host tables are cached per (table);
reads slice the cache so splits cost O(slice).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..data import types as T
from ..data.column import Column
from ..tpcds import generator as G
from ..tpcds import schema as S
from .spi import Connector, Split


class TpcdsConnector:
    def __init__(self, sf: float):
        self.sf = sf
        self._cache: Dict[str, object] = {}

    def _table(self, name: str):
        if name not in self._cache:
            self._cache[name] = G.generate(name, self.sf)
        return self._cache[name]

    # -- metadata
    def list_tables(self) -> List[str]:
        return list(S.TABLE_SCHEMAS)

    def columns(self, table: str) -> List[Tuple[str, T.DataType]]:
        return list(S.TABLE_SCHEMAS[table])

    def row_count(self, table: str) -> int:
        return S.row_count(table, self.sf)

    def primary_key(self, table: str) -> Tuple[str, ...]:
        return S.PRIMARY_KEYS.get(table, ())

    def column_ndv(self, table: str, column: str) -> Optional[int]:
        return None

    def column_range(self, table: str, column: str):
        return None

    # -- splits
    def splits(self, table: str, n_splits: int) -> List[Split]:
        total = self.row_count(table)
        per = (total + n_splits - 1) // n_splits
        return [Split(table, min(k * per, total),
                      min(per, total - min(k * per, total)))
                for k in range(n_splits)]

    # -- page source
    def read(self, table: str, columns: Sequence[str], first_row: int,
             row_count: int) -> Dict[str, Column]:
        t = self._table(table)
        full = first_row == 0 and row_count >= t.row_count
        return {c: (t.columns[c] if full
                    else t.columns[c].slice(first_row, row_count))
                for c in columns}


def tpcds_connector(sf: float) -> Connector:
    c = TpcdsConnector(sf)
    return Connector("tpcds", c, c, c)
