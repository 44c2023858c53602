"""The benchmark's tables as a connector under the program's SPI.

It serves the host columns that ``reference/tpch_gen.py`` made (the same
arrays the reference reads) to the program's data source, which ingests
and caches them as it does any connector's. It is registered under the
catalog name ``tpch`` (``DataSource.register``), in place of the
program's generating connector, so the planner resolves and costs the
tables exactly as the TPC-H tables it knows: the spec's row counts and
primary keys, the same unique builds, the same plans. A column the
generator did not make (no query reads it) raises.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from presto_tpu_torch.connector.spi import Connector, Split
from presto_tpu_torch.data.column import (Column, bytes_column, dict_column,
                                          plain_column)
from presto_tpu_torch.tpch import schema as SCH


def _column(dtype, hc) -> Column:
    if hc.kind == "plain":
        return plain_column(dtype, hc.values)
    if hc.kind == "dict":
        return dict_column(dtype, hc.values, hc.dictionary)
    return bytes_column(dtype, values=hc.values, lengths=hc.lengths)


class HostTablesConnector:
    """Metadata, splits and page source over ``{table: {column:
    HostColumn}}``; one split per table, the whole table."""

    def __init__(self, host: Dict[str, dict]):
        self.host = host
        self.rows = {t: next(iter(cols.values())).rows
                     for t, cols in host.items()}
        self._cols: Dict[Tuple[str, str], Column] = {}

    def list_tables(self) -> List[str]:
        return list(self.host)

    def columns(self, table: str):
        return list(SCH.TABLE_SCHEMAS[table])

    def row_count(self, table: str) -> int:
        return self.rows[table]

    def primary_key(self, table: str):
        return SCH.PRIMARY_KEYS.get(table, ())

    def column_ndv(self, table: str, column: str):
        return None

    def column_range(self, table: str, column: str):
        return None

    def splits(self, table: str, n_splits: int) -> List[Split]:
        total = self.rows[table]
        per = (total + n_splits - 1) // n_splits
        return [Split(table, min(k * per, total),
                      min(per, total - min(k * per, total)))
                for k in range(n_splits)]

    def read(self, table: str, columns: Sequence[str], first_row: int,
             row_count: int) -> Dict[str, Column]:
        out = {}
        for c in columns:
            key = (table, c)
            if key not in self._cols:
                if c not in self.host[table]:
                    raise KeyError(f"{table}.{c} is not generated: no "
                                   "benchmark statement reads it")
                dtype = dict(SCH.TABLE_SCHEMAS[table])[c]
                self._cols[key] = _column(dtype, self.host[table][c])
            col = self._cols[key]
            whole = first_row == 0 and row_count >= self.rows[table]
            out[c] = col if whole else col.slice(first_row, row_count)
        return out


def host_tables_connector(host: Dict[str, dict]) -> Connector:
    c = HostTablesConnector(host)
    return Connector("tpch", c, c, c)


def attach(runner, host: Dict[str, dict]) -> None:
    """Put the benchmark's tables in ``runner``'s data source."""
    runner.datasource.register(host_tables_connector(host))

