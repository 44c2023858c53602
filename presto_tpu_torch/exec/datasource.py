"""Scan layer: connector SPI → cached device Chunks.

Torch port of ``presto_tpu/exec/datasource.py``: resolves tables through
the ``CatalogManager`` (the TPC-H connector, and any connector
``register`` attaches, such as TPC-DS's), reads host columns through
the connector's page source with column pruning, and keeps a
device-resident column cache on the data source's ``device`` (scans of hot
tables cost no host→device transfer after first touch).  The cache's byte
budget is a revocable memory pool: cached columns drop back to the host
tier (and are regenerated on the next touch) when the budget would be
exceeded.

Reference: ``operator/ScanFilterAndProjectOperator.java:67`` consumes a
``ConnectorPageSource``; here the same seam feeds device ingest.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..connector import CatalogManager, tpch_connector
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
        self.pool = MemoryPool(device_budget_bytes(self.device))

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
