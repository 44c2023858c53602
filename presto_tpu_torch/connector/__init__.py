"""Connector SPI + the TPC-H connector this package scans through
(reference: ``core/trino-spi/.../spi/connector/`` + ``plugin/trino-tpch``)."""

from .spi import (CatalogManager, Connector, ConnectorMetadata,
                  ConnectorPageSink, ConnectorPageSource,
                  ConnectorSplitManager, Split)
from .tpch import tpch_connector

__all__ = ["CatalogManager", "Connector", "ConnectorMetadata",
           "ConnectorPageSink", "ConnectorPageSource",
           "ConnectorSplitManager", "Split", "tpch_connector"]
