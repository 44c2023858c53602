"""Scan layer: connector SPI → cached device Chunks.

Torch port of ``presto_tpu/exec/datasource.py``: resolves tables through
the ``CatalogManager`` (the TPC-H connector, the writable memory
connector, and any connector ``register`` attaches, such as TPC-DS's),
reads host columns through the connector's page source with column
pruning, and keeps a device-resident column cache on the data source's
``device`` (scans of hot tables cost no host→device transfer after first
touch).  The cache's byte budget is a revocable memory pool: cached
columns drop back to the host tier (and are regenerated on the next
touch) when the budget would be exceeded.  The same pool's remaining
budget decides when an operator runs one partition at a time
(``exec/physical.py``).

Ingest is bounded: with ``ingest_slice_rows`` a table is read and
uploaded in slices of that many of the connector's split units (orders
for lineitem), so the host holds one slice at a time, not the table
(the reference's page-at-a-time cursor, ``TpchRecordSet.cursor():86``).
``scan_slice`` reads one uncached row range for the streaming
aggregation.  ``ingest_slices`` counts every connector read.  A DICT
column's dictionary is interned per (table, column) while its strings
stay the same, so the slices of one column share one ``Dictionary``.

Writes (CTAS, INSERT, the rebuilds of UPDATE and DELETE, DROP) store host
``Table`` snapshots in the memory connector; each bumps
``catalog.version`` (the runner's plan cache key), drops the table's
cached device columns and frees their pool reservations, so the next scan
uploads the new snapshot.  A ROW column is stored shredded, one dotted
column per field (``payload.v``), as in the JAX package; ``row_fields``
keeps which columns those are, so that ``SELECT *`` folds them back and
a column merely named with a dot stays one column.

Reference: ``operator/ScanFilterAndProjectOperator.java:67`` consumes a
``ConnectorPageSource``; here the same seam feeds device ingest.
"""

from __future__ import annotations

from typing import Dict, Optional, Set, Tuple

import numpy as np
import torch

from ..connector import CatalogManager, memory_connector, tpch_connector
from ..data.column import PLAIN, ROW, Column, bytes_column
from ..data.table import Table
from ..utils.memory import MemoryPool, col_bytes
from .columns import Chunk, DCol, Dictionary, from_host


def default_budget_bytes(device: torch.device) -> Optional[int]:
    """Usable bytes on ``device`` when the caller names no budget: 90% of
    what the card reports free when the data source starts; None
    (unbounded) on the CPU, so the memory tiers stay off there unless a
    budget is passed."""
    if device.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(device)
    return int(free * 0.9)


class DataSource:
    def __init__(self, scale_factor: float, device: torch.device,
                 device_budget_bytes: Optional[int] = None,
                 ingest_slice_rows: Optional[int] = None):
        self.sf = scale_factor
        self.device = torch.device(device)
        self._cols: Dict[Tuple[str, str], DCol] = {}
        self._dicts: Dict[Tuple[str, str], Dictionary] = {}
        self.catalog = CatalogManager()
        self.catalog.register(tpch_connector(scale_factor))
        self.catalog.register(memory_connector(self._bump))
        self.pool = MemoryPool(default_budget_bytes(self.device)
                               if device_budget_bytes is None
                               else device_budget_bytes)
        self.ingest_slice_rows = ingest_slice_rows
        self.ingest_slices = 0  # connector reads (slices) so far
        # memory table → its columns that hold a shredded ROW's fields
        self.row_fields: Dict[str, Set[str]] = {}

    @property
    def memory(self) -> Dict[str, Table]:
        """The memory connector's ``{name: Table}`` (whatever dict a
        transaction has swapped in)."""
        return self.catalog.get("memory").metadata.tables

    def _bump(self) -> None:
        self.catalog.version += 1

    def register(self, connector) -> None:
        """Attach another connector (``PluginManager.loadPlugins``).  Its
        tables shadow same-named ones (TPC-DS's ``customer`` hides
        TPC-H's), so their cached columns go."""
        self.catalog.register(connector)
        tables = set(connector.metadata.list_tables())
        for key in [k for k in self._cols if k[0] in tables]:
            del self._cols[key]
            self.pool.free(key)

    def extra_schemas(self) -> Dict[str, list]:
        """Schemas of every table of a connector other than tpch (the
        planner's ``extra_tables``)."""
        return {t: conn.metadata.columns(t)
                for conn in self.catalog.connectors() if conn.name != "tpch"
                for t in conn.metadata.list_tables()}

    def extra_stats(self) -> Dict[str, tuple]:
        """{table: (row_count, primary_key)} of the same tables (the
        planner's ``extra_stats``, from the SPI's metadata)."""
        return {t: (conn.metadata.row_count(t), conn.metadata.primary_key(t))
                for conn in self.catalog.connectors() if conn.name != "tpch"
                for t in conn.metadata.list_tables()}

    def memory_schema(self, name: str):
        return [(c, col.dtype) for c, col in self.memory[name].columns.items()]

    def _drop_cached(self, name: str) -> None:
        """Forget ``name``'s device columns and their pool reservations."""
        for key in [k for k in self._cols if k[0] == name]:
            del self._cols[key]
            self.pool.free(key)

    def _check_writable_name(self, name: str) -> None:
        hit = self.catalog.resolve(name)
        if hit is not None and hit[0].name != "memory":
            raise ValueError(f"table '{name}' already exists in catalog "
                             f"{hit[0].name}")

    @staticmethod
    def _shred_rows(table: Table) -> Tuple[Table, Set[str]]:
        """(``table`` with each ROW column stored as one dotted column per
        field, ``r.x``: the device never sees a struct; the dotted names
        of those fields)."""
        out, fields = {}, set()
        for cname, col in table.columns.items():
            if col.kind == ROW:
                for f, child in col.children:
                    out[f"{cname}.{f}"] = child
                    fields.add(f"{cname}.{f}")
            else:
                out[cname] = col
        return (Table(out) if fields else table), fields

    def create_table(self, name: str, table: Table) -> None:
        self._check_writable_name(name)
        table, self.row_fields[name] = self._shred_rows(table)
        self.catalog.get("memory").page_sink.create_table(name, table)
        self._drop_cached(name)

    def insert_into(self, name: str, table: Table) -> None:
        table, fields = self._shred_rows(table)
        self.catalog.get("memory").page_sink.insert(name, table)
        self.row_fields[name] = self.row_fields.get(name, set()) | fields
        self._drop_cached(name)

    def drop_table(self, name: str) -> None:
        self.catalog.get("memory").page_sink.drop_table(name)
        self.row_fields.pop(name, None)
        self._drop_cached(name)

    def swap_memory(self, tables: Dict[str, Table]) -> None:
        """Make ``tables`` the memory catalog (a transaction's begin and
        end): every table whose snapshot differs between the two dicts
        loses its cached device columns, and the version moves."""
        mem = self.catalog.get("memory").metadata
        old, mem.tables = mem.tables, tables
        for name in set(old) | set(tables):
            if old.get(name) is not tables.get(name):
                self._drop_cached(name)
        self._bump()

    def table_rows(self, table: str) -> int:
        hit = self.catalog.resolve(table)
        if hit is None:
            raise KeyError(f"unknown table {table}")
        return hit[0].metadata.row_count(hit[1])

    def _resolve(self, table: str):
        hit = self.catalog.resolve(table)
        if hit is None:
            raise KeyError(f"unknown table {table}")
        return hit

    def split_units(self, table: str) -> int:
        """The table's size in its connector's split units (orders for
        lineitem): the unit of ``scan_slice`` and ``ingest_slice_rows``."""
        conn, tbl = self._resolve(table)
        return conn.split_manager.splits(tbl, 1)[0].row_count

    def read_host(self, table: str, columns) -> dict:
        """Host columns of the whole ``table``, as the connector's page
        source returns them."""
        conn, tbl = self._resolve(table)
        split = conn.split_manager.splits(tbl, 1)[0]
        return conn.page_source.read(tbl, list(columns), split.first_row,
                                     split.row_count)

    def _upload(self, table: str, name: str, col) -> DCol:
        """A host column → the device, its dictionary interned."""
        dc = from_host(col, self.device)
        if dc.dictionary is not None:
            key = (table, name)
            known = self._dicts.get(key)
            if known is not None and np.array_equal(known.strings,
                                                    dc.dictionary.strings):
                dc.dictionary = known
            else:
                self._dicts[key] = dc.dictionary
        return dc

    def _split(self, table: str):
        """The split of ``table`` this data source holds: the whole table
        (a rank's data source holds its row range,
        ``parallel/distributed.ShardSource``)."""
        conn, tbl = self._resolve(table)
        return conn.split_manager.splits(tbl, 1)[0]

    def _read(self, table: str, columns, first: int, count: int) -> dict:
        """One ingest slice: the page source's host columns for ``count``
        split units from ``first`` (it may return more than ``columns``)."""
        conn, tbl = self._resolve(table)
        self.ingest_slices += 1
        return conn.page_source.read(tbl, list(columns), first, count)

    def _ingest(self, table: str, columns) -> Dict[str, DCol]:
        """The split's (``_split``) ``columns`` (and any other the page source
        returns with them) on the device, read and uploaded in slices of
        ``ingest_slice_rows`` split units (one read when it is None): the
        host holds one slice at a time.  The slices of a DICT column share
        its interned dictionary, so they stay DICT end to end."""
        from .physical import concat_chunks
        split = self._split(table)
        first, count = split.first_row, split.row_count
        step = self.ingest_slice_rows or count
        parts = []  # an empty table is one read of no rows
        for lo in range(first, first + max(count, 1), max(step, 1)):
            host = self._read(table, columns, lo,
                              min(step, first + count - lo))
            cols = {n: self._upload(table, n, c) for n, c in host.items()}
            parts.append(Chunk(cols, self._live(cols)))
        return parts[0].cols if len(parts) == 1 else \
            concat_chunks(parts).cols

    def scan(self, table: str, columns, alias_prefix: str = "") -> Chunk:
        missing = [c for c in columns if (table, c) not in self._cols]
        fresh = self._ingest(table, missing) if missing else {}
        for name, dc in fresh.items():
            self._cache_col(table, name, dc)
        for c in columns:
            self.pool.touch((table, c))  # LRU refresh
        cols = {}
        for c in columns:
            dc = fresh.get(c) or self._cols.get((table, c))
            if dc is None:  # budget evicted it while caching siblings
                dc = self._ingest(table, [c])[c]
            cols[alias_prefix + c] = dc
        return Chunk(cols, self._live(cols))

    def scan_slice(self, table: str, columns, first: int,
                   count: int) -> Chunk:
        """``count`` split units of ``table`` from ``first``, read (one
        ingest slice) and uploaded, not cached: the bounded ingest and
        the streaming aggregation read a table this way."""
        host = self._read(table, columns, first, count)
        cols = {n: self._upload(table, n, host[n]) for n in columns}
        return Chunk(cols, self._live(cols))

    def _live(self, cols: Dict[str, DCol]) -> torch.Tensor:
        """An all-true row mask as long as ``cols``."""
        n = next(iter(cols.values())).n_rows
        return torch.ones((n,), dtype=torch.bool, device=self.device)

    def _cache_col(self, table: str, name: str, dc: DCol) -> None:
        key = (table, name)
        self._cols[key] = dc
        self.pool.reserve(key, col_bytes(dc),
                          revoke=lambda k=key: self._cols.pop(k, None))


def _concat_host_cols(a: Column, b: Column) -> Column:
    """Rows of ``b`` after those of ``a`` (INSERT): PLAIN stays PLAIN,
    strings go through Python and come back BYTES with their NULLs (the
    JAX package's copy turns a NULL string into '')."""
    if a.kind == PLAIN and b.kind == PLAIN:
        return Column(a.dtype, np.concatenate(
            [np.asarray(a.values), np.asarray(b.values)]),
            _cat_validity(a, b), PLAIN)
    vals = a.to_pylist() + b.to_pylist()
    return bytes_column(a.dtype, [v if v is not None else "" for v in vals],
                        validity=_cat_validity(a, b))


def _cat_validity(a: Column, b: Column):
    if a.validity is None and b.validity is None:
        return None
    va = np.ones(a.row_count, bool) if a.validity is None \
        else np.asarray(a.validity)
    vb = np.ones(b.row_count, bool) if b.validity is None \
        else np.asarray(b.validity)
    return np.concatenate([va, vb])
