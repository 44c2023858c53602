"""Connector SPI: the formal seam between the engine and data sources.

TPU-first re-design of the reference's connector interfaces
(``core/trino-spi/src/main/java/io/trino/spi/connector/`` — 80 interfaces,
of which five matter for an engine without external storage formats):

- ``ConnectorMetadata``   (reference ``ConnectorMetadata.java``): table
  discovery, schemas, and the statistics the CBO consumes
  (``getTableStatistics`` → our ndv/range hooks).
- ``ConnectorSplitManager`` (reference ``ConnectorSplitManager.java`` +
  ``TpchSplitManager.java:55``): row-range splits.  On TPU, a split is a
  deterministic row range of a generated/stored table — placement is
  computed (device index), never negotiated.
- ``ConnectorPageSource``  (reference ``ConnectorPageSourceProvider``):
  columnar reads.  Returns host ``Column``s ready for ``from_host``
  device upload; column pruning is mandatory (generation is per-column).
- ``ConnectorPageSink``    (reference ``ConnectorPageSinkProvider``):
  writes (CTAS/INSERT/DELETE).  Optional — read-only connectors leave it
  None.
- ``Connector``            (reference ``Connector.java``): the bundle
  a catalog registers.

Unlike the reference there is no transaction handle threading: tables are
immutable snapshots versioned by ``CatalogManager.version`` (DDL bumps it,
plan caches key on it), which is the autocommit-visibility model the
reference's ``InMemoryTransactionManager`` provides for memory catalogs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Protocol, Sequence, Tuple

from ..data import types as T
from ..data.column import Column


@dataclass(frozen=True)
class Split:
    """A deterministic row-range slice of one table (reference:
    ``TpchSplit`` partNumber/totalParts → here explicit rows)."""
    table: str
    first_row: int
    row_count: int


class ConnectorMetadata(Protocol):
    def list_tables(self) -> List[str]: ...

    def columns(self, table: str) -> List[Tuple[str, T.DataType]]: ...

    def row_count(self, table: str) -> int:
        """Exact or estimated cardinality (drives planner estimates)."""
        ...

    def primary_key(self, table: str) -> Tuple[str, ...]:
        """Unique key for join build-side uniqueness detection; () if
        none."""
        ...

    def column_ndv(self, table: str, column: str) -> Optional[int]:
        """Distinct-count estimate (CBO); None = unknown."""
        ...

    def column_range(self, table: str, column: str
                     ) -> Optional[Tuple[float, float]]:
        """(lo, hi) bounds in physical units (CBO range selectivity);
        None = unknown."""
        ...


class ConnectorSplitManager(Protocol):
    def splits(self, table: str, n_splits: int) -> List[Split]: ...


class ConnectorPageSource(Protocol):
    def read(self, table: str, columns: Sequence[str], first_row: int,
             row_count: int) -> Dict[str, Column]:
        """Columnar read of a row range; must honor column pruning."""
        ...


class ConnectorPageSink(Protocol):
    def create_table(self, name: str, columns: Dict[str, Column]) -> None: ...

    def insert(self, name: str, columns: Dict[str, Column]) -> None: ...

    def drop_table(self, name: str) -> None: ...


@dataclass
class Connector:
    name: str
    metadata: ConnectorMetadata
    split_manager: ConnectorSplitManager
    page_source: ConnectorPageSource
    page_sink: Optional[ConnectorPageSink] = None   # None = read-only
    # False = every process scans the whole table (small/replicated
    # tables, the memory catalog); True = row-range splits fan out
    splittable: bool = True


class CatalogManager:
    """name → Connector registry (reference: ``metadata/CatalogManager`` +
    ``server/PluginManager.loadPlugins``).  Table names resolve across
    catalogs in registration order; an explicit ``catalog.table`` wins."""

    def __init__(self):
        self._connectors: Dict[str, Connector] = {}
        self.version = 0      # bumped on DDL; plan caches key on this

    def register(self, connector: Connector) -> None:
        self._connectors[connector.name] = connector
        self.version += 1

    def connectors(self) -> List[Connector]:
        return list(self._connectors.values())

    def get(self, name: str) -> Connector:
        return self._connectors[name]

    def resolve(self, table: str) -> Optional[Tuple[Connector, str]]:
        """Find the connector owning ``table`` (or ``catalog.table``).
        Later-registered connectors shadow earlier ones (a session that
        attaches tpcds sees ITS ``customer``), mirroring the old
        memory-catalog-shadows-generator behavior."""
        if "." in table:
            cat, tbl = table.split(".", 1)
            c = self._connectors.get(cat)
            if c is not None and tbl in c.metadata.list_tables():
                return c, tbl
            return None
        for c in reversed(self._connectors.values()):
            if table in c.metadata.list_tables():
                return c, table
        return None
