"""Scan layer: connector SPI → cached device Chunks.

Torch port of ``presto_tpu/exec/datasource.py``: resolves tables through
the ``CatalogManager`` (the TPC-H connector, the writable memory
connector, and any connector ``register`` attaches, such as TPC-DS's),
reads host columns through the connector's page source with column
pruning, and keeps a device-resident column cache on the data source's
``device`` (scans of hot tables cost no host→device transfer after first
touch).  The cache's byte budget is a revocable memory pool: cached
columns drop back to the host tier (and are regenerated on the next
touch) when the budget would be exceeded.

Writes (CTAS, INSERT, the rebuilds of UPDATE and DELETE, DROP) store host
``Table`` snapshots in the memory connector; each bumps
``catalog.version`` (the runner's plan cache key), drops the table's
cached device columns and frees their pool reservations, so the next scan
uploads the new snapshot.  ROW columns are not shredded on write as in
the JAX package: the port refuses them past the scan.

Reference: ``operator/ScanFilterAndProjectOperator.java:67`` consumes a
``ConnectorPageSource``; here the same seam feeds device ingest.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..connector import CatalogManager, memory_connector, tpch_connector
from ..data.column import PLAIN, Column, bytes_column
from ..data.table import Table
from ..utils.memory import MemoryPool, col_bytes
from .columns import Chunk, DCol, from_host


def device_budget_bytes(device: torch.device) -> Optional[int]:
    """Usable bytes for the scan cache on ``device``: 90% of what the card
    reports free when the data source starts; None (unbounded) on the CPU."""
    if device.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(device)
    return int(free * 0.9)


class DataSource:
    def __init__(self, scale_factor: float, device: torch.device):
        self.sf = scale_factor
        self.device = torch.device(device)
        self._cols: Dict[Tuple[str, str], DCol] = {}
        self.catalog = CatalogManager()
        self.catalog.register(tpch_connector(scale_factor))
        self.catalog.register(memory_connector(self._bump))
        self.pool = MemoryPool(device_budget_bytes(self.device))

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

    def create_table(self, name: str, table: Table) -> None:
        self._check_writable_name(name)
        self.catalog.get("memory").page_sink.create_table(name, table)
        self._drop_cached(name)

    def insert_into(self, name: str, table: Table) -> None:
        self.catalog.get("memory").page_sink.insert(name, table)
        self._drop_cached(name)

    def drop_table(self, name: str) -> None:
        self.catalog.get("memory").page_sink.drop_table(name)
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

    def read_host(self, table: str, columns) -> dict:
        """Host columns of the whole ``table``, as the connector's page
        source returns them."""
        hit = self.catalog.resolve(table)
        if hit is None:
            raise KeyError(f"unknown table {table}")
        conn, tbl = hit
        split = conn.split_manager.splits(tbl, 1)[0]
        return conn.page_source.read(tbl, list(columns), split.first_row,
                                     split.row_count)

    def scan(self, table: str, columns, alias_prefix: str = "") -> Chunk:
        missing = [c for c in columns if (table, c) not in self._cols]
        fresh: Dict[str, DCol] = {}
        if missing:
            fresh = {n: from_host(c, self.device)
                     for n, c in self.read_host(table, missing).items()}
        for name, dc in fresh.items():
            self._cache_col(table, name, dc)
        for c in columns:
            self.pool.touch((table, c))  # LRU refresh
        cols = {}
        for c in columns:
            dc = fresh.get(c) or self._cols.get((table, c))
            if dc is None:  # budget evicted it while caching siblings
                dc = from_host(self.read_host(table, [c])[c], self.device)
            cols[alias_prefix + c] = dc
        n = next(iter(cols.values())).n_rows
        return Chunk(cols, torch.ones((n,), dtype=torch.bool,
                                      device=self.device))

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
