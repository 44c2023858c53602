"""TPC-H connector through the formal SPI.

Wraps the deterministic skip-ahead generator (``presto_tpu/tpch/generator``)
in the same interface shape the reference's ``plugin/trino-tpch`` exposes:
``TpchMetadata`` (schemas + bundled statistics), ``TpchSplitManager``
(partNumber/totalParts row slices), ``TpchRecordSet`` (columnar cursor).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..data import types as T
from ..data.column import Column
from ..tpch import generator
from ..tpch import schema as SCH
from .spi import Connector, Split


class _TpchMetadata:
    def __init__(self, sf: float):
        self.sf = sf

    def list_tables(self) -> List[str]:
        return list(SCH.TABLE_SCHEMAS)

    def columns(self, table: str) -> List[Tuple[str, T.DataType]]:
        return list(SCH.TABLE_SCHEMAS[table])

    def row_count(self, table: str) -> int:
        return SCH.CATALOG.row_count(SCH.TableHandle(table, self.sf))

    def primary_key(self, table: str) -> Tuple[str, ...]:
        return SCH.PRIMARY_KEYS.get(table, ())

    def column_ndv(self, table: str, column: str) -> Optional[int]:
        return SCH.ndv_estimate(table, column, self.sf)

    def column_range(self, table: str, column: str
                     ) -> Optional[Tuple[float, float]]:
        return SCH.value_range(column, self.sf)


class _TpchSplitManager:
    """Row-range splits aligned to generation units (partsupp generates 4
    rows per part, so slices align to 4 — reference
    ``TpchSplitManager.java:55`` slices by (partNumber, totalParts))."""

    def __init__(self, sf: float):
        self.sf = sf

    def splits(self, table: str, n_splits: int) -> List[Split]:
        total = generator.total_unit_rows(table, self.sf)
        unit = 4 if table == "partsupp" else 1
        per = ((total // unit + n_splits - 1) // n_splits) * unit
        out = []
        for k in range(n_splits):
            first = min(k * per, total)
            count = min(per, total - first)
            out.append(Split(table, first, count))
        return out


class _TpchPageSource:
    def __init__(self, sf: float):
        self.sf = sf

    def read(self, table: str, columns: Sequence[str], first_row: int,
             row_count: int) -> Dict[str, Column]:
        t = generator.generate(table, self.sf, columns=list(columns),
                               first_row=first_row, n_rows=row_count)
        return dict(t.columns)


def tpch_connector(sf: float) -> Connector:
    return Connector("tpch", _TpchMetadata(sf), _TpchSplitManager(sf),
                     _TpchPageSource(sf))
