"""Connector SPI + built-in connectors (reference: ``core/trino-spi/.../
spi/connector/`` + ``plugin/trino-tpch``, ``plugin/trino-memory``,
``plugin/trino-tpcds``, ``plugin/trino-blackhole``)."""

from .spi import (CatalogManager, Connector, ConnectorMetadata,
                  ConnectorPageSink, ConnectorPageSource,
                  ConnectorSplitManager, Split)
from .memory import memory_connector
from .tpch import tpch_connector
from .tpcds import tpcds_connector
from .blackhole import blackhole_connector

__all__ = ["CatalogManager", "Connector", "ConnectorMetadata",
           "ConnectorPageSink", "ConnectorPageSource",
           "ConnectorSplitManager", "Split", "tpch_connector",
           "memory_connector", "tpcds_connector", "blackhole_connector"]
