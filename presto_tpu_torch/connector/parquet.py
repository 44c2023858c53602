"""Parquet ingestion connector: a directory of ``.parquet`` files served
as a read-only catalog through the connector SPI.

Reference: ``lib/trino-parquet`` + ``plugin/trino-hive``'s
``ParquetPageSource`` — there, a native column-decoder stack; here the
host-side decode rides pyarrow (the seam and the columnar ingest path
are the point: files → pruned host columns → device upload through the
same ``DataSource.scan``/PageSource machinery every other catalog uses).

File-level metadata supplies the CBO inputs: exact row counts and
per-column min/max from the parquet footer statistics
(``ConnectorMetadata.getTableStatistics`` role).

Type mapping (arrow → engine):
  int8/16/32/64, uint*          → BIGINT
  float16/32/64                 → DOUBLE
  decimal128(p, s)              → DECIMAL(p, s) (scaled int64 for p<=18)
  bool                          → BOOLEAN
  date32/date64                 → DATE (epoch days)
  timestamp[*]                  → TIMESTAMP (micros)
  string/large_string           → DICT (low cardinality) or BYTES
  dictionary<string>            → DICT

Torch port's copy of ``presto_tpu/connector/parquet.py`` (jax-free;
pyarrow is imported inside the functions, and the card's machine has
none, so the connector is for CPU runs).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data import types as T
from ..data.column import BYTES, Column, bytes_column, dict_column
from .spi import Connector, Split

# strings with ndv <= this fraction of rows encode as DICT (engine
# string kernels are dictionary-first)
_DICT_NDV_FRACTION = 0.5


def _arrow_to_dtype(at) -> T.DataType:
    import pyarrow as pa
    if pa.types.is_boolean(at):
        return T.BOOLEAN
    if pa.types.is_integer(at):
        return T.BIGINT
    if pa.types.is_floating(at):
        return T.DOUBLE
    if pa.types.is_decimal(at):
        return T.decimal(at.precision, at.scale)
    if pa.types.is_date(at):
        return T.DATE
    if pa.types.is_timestamp(at):
        return T.TimestampType()
    if pa.types.is_string(at) or pa.types.is_large_string(at) \
            or pa.types.is_dictionary(at):
        return T.VARCHAR
    raise NotImplementedError(f"parquet type {at}")


def _column_from_arrow(arr, dtype: T.DataType) -> Column:
    """One arrow ChunkedArray/Array → engine host Column."""
    import pyarrow as pa
    import pyarrow.compute as pc
    if hasattr(arr, "combine_chunks"):
        arr = arr.combine_chunks()
    n = len(arr)
    validity = None
    if arr.null_count:
        validity = np.asarray(pc.is_valid(arr))
    if T.is_string(dtype):
        ndv = len(pc.unique(arr))
        strs = arr.to_pylist()
        strs = ["" if s is None else str(s) for s in strs]
        width = max((len(s) for s in strs), default=1) or 1
        if ndv <= max(16, int(n * _DICT_NDV_FRACTION)):
            uniq, codes = np.unique(np.array(strs, dtype=str),
                                    return_inverse=True)
            return dict_column(T.varchar(width), codes.astype(np.int32),
                               uniq.astype(object), validity=validity)
        return bytes_column(T.varchar(width), strs, validity=validity)
    if isinstance(dtype, T.DecimalType):
        if dtype.precision <= 18:
            vals = np.array(
                [0 if v is None else int(v.scaleb(dtype.scale))
                 for v in arr.to_pylist()], np.int64)
        else:
            raise NotImplementedError("decimal precision > 18 ingest")
        return Column(dtype, vals, validity=validity)
    if isinstance(dtype, T.TimestampType):
        us = arr.cast(pa.timestamp("us"))
        vals = np.asarray(us.cast(pa.int64()).fill_null(0))
        return Column(dtype, vals.astype(np.int64), validity=validity)
    if isinstance(dtype, T.DateType):
        days = arr.cast(pa.date32()).cast(pa.int32()).fill_null(0)
        return Column(dtype, np.asarray(days).astype(np.int64),
                      validity=validity)
    if isinstance(dtype, T.BooleanType):
        vals = np.asarray(arr.cast(pa.int8()).fill_null(0)) != 0
        return Column(dtype, vals, validity=validity)
    if isinstance(dtype, T.DoubleType):
        vals = np.asarray(arr.cast(pa.float64()).fill_null(0.0))
        return Column(dtype, vals.astype(np.float64), validity=validity)
    vals = np.asarray(arr.cast(pa.int64()).fill_null(0)).astype(np.int64)
    return Column(T.BIGINT, vals, validity=validity)


class ParquetConnector:
    """Read-only catalog over ``<directory>/*.parquet`` (table name =
    file stem).  Footer metadata is read once; column data decodes
    lazily per (table, columns, row-range) request with row-group
    pruning, so a scan touches only the row groups its split covers."""

    def __init__(self, directory: str):
        import pyarrow.parquet as pq
        self.directory = directory
        self._files: Dict[str, str] = {}
        self._meta: Dict[str, object] = {}
        self._schema: Dict[str, List[Tuple[str, T.DataType]]] = {}
        for fn in sorted(os.listdir(directory)):
            if not fn.endswith(".parquet"):
                continue
            name = os.path.splitext(fn)[0].lower()
            path = os.path.join(directory, fn)
            self._files[name] = path
            pf = pq.ParquetFile(path)
            self._meta[name] = pf.metadata
            self._schema[name] = [
                (f.name.lower(), _arrow_to_dtype(f.type))
                for f in pf.schema_arrow]

    # -- metadata
    def list_tables(self) -> List[str]:
        return list(self._files)

    def columns(self, table: str) -> List[Tuple[str, T.DataType]]:
        return self._schema[table]

    def row_count(self, table: str) -> int:
        return self._meta[table].num_rows

    def primary_key(self, table: str) -> Tuple[str, ...]:
        return ()

    def column_ndv(self, table: str, column: str) -> Optional[int]:
        return None

    def column_range(self, table: str, column: str
                     ) -> Optional[Tuple[float, float]]:
        """min/max across row-group footer statistics (the parquet
        metadata the reference's readers use for predicate pushdown)."""
        md = self._meta[table]
        idx = None
        for i in range(md.num_columns):
            if md.row_group(0).column(i).path_in_schema.lower() == column:
                idx = i
                break
        if idx is None:
            return None
        lo, hi = None, None
        for rg in range(md.num_row_groups):
            st = md.row_group(rg).column(idx).statistics
            if st is None or not st.has_min_max:
                return None
            mn, mx = st.min, st.max
            if not isinstance(mn, (int, float)):
                return None
            lo = mn if lo is None else min(lo, mn)
            hi = mx if hi is None else max(hi, mx)
        return None if lo is None else (float(lo), float(hi))

    # -- splits
    def splits(self, table: str, n_splits: int) -> List[Split]:
        total = self.row_count(table)
        per = (total + n_splits - 1) // n_splits
        return [Split(table, min(k * per, total),
                      min(per, total - min(k * per, total)))
                for k in range(n_splits)]

    # -- page source (row-group pruned, column pruned)
    def read(self, table: str, columns: Sequence[str], first_row: int,
             row_count: int) -> Dict[str, Column]:
        import pyarrow.parquet as pq
        pf = pq.ParquetFile(self._files[table])
        md = self._meta[table]
        # row groups overlapping [first_row, first_row + row_count)
        groups, base = [], 0
        lo, hi = first_row, first_row + row_count
        rg_first = 0
        for rg in range(md.num_row_groups):
            nr = md.row_group(rg).num_rows
            if base < hi and base + nr > lo:
                if not groups:
                    rg_first = base
                groups.append(rg)
            base += nr
        name_map = {f.name.lower(): f.name for f in pf.schema_arrow}
        tbl = pf.read_row_groups(
            groups or [0], columns=[name_map[c] for c in columns])
        out: Dict[str, Column] = {}
        a, b = lo - rg_first, hi - rg_first
        for c in columns:
            dtype = dict(self._schema[table])[c]
            col = _column_from_arrow(tbl.column(name_map[c]), dtype)
            if a > 0 or b < len(tbl):
                col = col.slice(a, b - a)
            out[c] = col
        return out


def parquet_connector(directory: str) -> Connector:
    c = ParquetConnector(directory)
    return Connector(name="parquet", metadata=c, split_manager=c,
                     page_source=c, page_sink=None, splittable=True)
