"""Connector SPI + the TPC-H and TPC-DS connectors this package scans
through (reference: ``core/trino-spi/.../spi/connector/`` +
``plugin/trino-tpch``, ``plugin/trino-tpcds``)."""

from .spi import (CatalogManager, Connector, ConnectorMetadata,
                  ConnectorPageSink, ConnectorPageSource,
                  ConnectorSplitManager, Split)
from .tpch import tpch_connector
from .tpcds import tpcds_connector

__all__ = ["CatalogManager", "Connector", "ConnectorMetadata",
           "ConnectorPageSink", "ConnectorPageSource",
           "ConnectorSplitManager", "Split", "tpch_connector",
           "tpcds_connector"]
