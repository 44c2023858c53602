"""TPC-H logical schemas + catalog metadata.

The TPU analogue of the reference's connector metadata for TPC-H
(``plugin/trino-tpch/src/main/java/io/trino/tpch/TpchMetadata.java:97`` —
schemas ``tiny`` (sf0.01), ``sf1``…): named scale-factor schemas over the
eight TPC-H tables, plus generator-derived table statistics for the CBO
(the reference bundles equivalent ground-truth stats JSON at
``plugin/trino-tpch/src/main/resources/tpch/statistics/``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..data import types as T
from . import generator

_D = T.decimal  # decimal(p, s) → int64 unscaled


TABLE_SCHEMAS: Dict[str, List[Tuple[str, T.DataType]]] = {
    "region": [
        ("r_regionkey", T.BIGINT), ("r_name", T.varchar(25)),
        ("r_comment", T.varchar(152)),
    ],
    "nation": [
        ("n_nationkey", T.BIGINT), ("n_name", T.varchar(25)),
        ("n_regionkey", T.BIGINT), ("n_comment", T.varchar(152)),
    ],
    "supplier": [
        ("s_suppkey", T.BIGINT), ("s_name", T.varchar(25)),
        ("s_address", T.varchar(40)), ("s_nationkey", T.BIGINT),
        ("s_phone", T.varchar(15)), ("s_acctbal", _D(15, 2)),
        ("s_comment", T.varchar(101)),
    ],
    "customer": [
        ("c_custkey", T.BIGINT), ("c_name", T.varchar(25)),
        ("c_address", T.varchar(40)), ("c_nationkey", T.BIGINT),
        ("c_phone", T.varchar(15)), ("c_acctbal", _D(15, 2)),
        ("c_mktsegment", T.varchar(10)), ("c_comment", T.varchar(117)),
    ],
    "part": [
        ("p_partkey", T.BIGINT), ("p_name", T.varchar(55)),
        ("p_mfgr", T.varchar(25)), ("p_brand", T.varchar(10)),
        ("p_type", T.varchar(25)), ("p_size", T.BIGINT),
        ("p_container", T.varchar(10)), ("p_retailprice", _D(15, 2)),
        ("p_comment", T.varchar(23)),
    ],
    "partsupp": [
        ("ps_partkey", T.BIGINT), ("ps_suppkey", T.BIGINT),
        ("ps_availqty", T.BIGINT), ("ps_supplycost", _D(15, 2)),
        ("ps_comment", T.varchar(199)),
    ],
    "orders": [
        ("o_orderkey", T.BIGINT), ("o_custkey", T.BIGINT),
        ("o_orderstatus", T.varchar(1)), ("o_totalprice", _D(15, 2)),
        ("o_orderdate", T.DATE), ("o_orderpriority", T.varchar(15)),
        ("o_clerk", T.varchar(15)), ("o_shippriority", T.BIGINT),
        ("o_comment", T.varchar(79)),
    ],
    "lineitem": [
        ("l_orderkey", T.BIGINT), ("l_partkey", T.BIGINT),
        ("l_suppkey", T.BIGINT), ("l_linenumber", T.BIGINT),
        ("l_quantity", _D(15, 2)), ("l_extendedprice", _D(15, 2)),
        ("l_discount", _D(15, 2)), ("l_tax", _D(15, 2)),
        ("l_returnflag", T.varchar(1)), ("l_linestatus", T.varchar(1)),
        ("l_shipdate", T.DATE), ("l_commitdate", T.DATE),
        ("l_receiptdate", T.DATE), ("l_shipinstruct", T.varchar(25)),
        ("l_shipmode", T.varchar(10)), ("l_comment", T.varchar(44)),
    ],
}

# schema name → scale factor (TpchMetadata.java:97-101)
SCHEMAS: Dict[str, float] = {
    "tiny": 0.01, "sf1": 1.0, "sf10": 10.0, "sf100": 100.0, "sf1000": 1000.0,
}


@dataclass(frozen=True)
class TableHandle:
    table: str
    scale_factor: float

    @property
    def row_count(self) -> int:
        return generator.total_unit_rows(self.table, self.scale_factor)


class TpchCatalog:
    """Catalog facade (the analogue of ``metadata/MetadataManager.java``'s
    table resolution for the tpch connector)."""

    def resolve(self, schema: str, table: str) -> TableHandle:
        table = table.lower()
        if schema not in SCHEMAS:
            raise KeyError(f"unknown schema {schema!r} (have {sorted(SCHEMAS)})")
        if table not in TABLE_SCHEMAS:
            raise KeyError(f"unknown table {table!r}")
        return TableHandle(table, SCHEMAS[schema])

    def columns(self, table: str) -> List[Tuple[str, T.DataType]]:
        return TABLE_SCHEMAS[table.lower()]

    def column_type(self, table: str, column: str) -> T.DataType:
        for name, t in TABLE_SCHEMAS[table.lower()]:
            if name == column:
                return t
        raise KeyError(f"{table}.{column}")

    # --- simple generator-derived statistics for the CBO ---

    def row_count(self, handle: TableHandle) -> int:
        base = {
            "region": 5, "nation": 25,
            "supplier": generator.SUPPLIER_BASE,
            "customer": generator.CUSTOMER_BASE,
            "part": generator.PART_BASE,
            "partsupp": generator.PART_BASE * generator.SUPP_PER_PART,
            "orders": generator.ORDERS_BASE,
            "lineitem": int(generator.ORDERS_BASE * 4),  # ≈4 lines/order
        }[handle.table]
        if handle.table in ("region", "nation"):
            return base
        return int(base * handle.scale_factor)


CATALOG = TpchCatalog()

# table-name prefix on physical column names; the analyzer also accepts the
# reference connector's stripped names ("shipdate" for "l_shipdate",
# plugin/trino-tpch/.../TpchMetadata naming)
COLUMN_PREFIXES = {
    "region": "r_", "nation": "n_", "supplier": "s_", "customer": "c_",
    "part": "p_", "partsupp": "ps_", "orders": "o_", "lineitem": "l_",
}

# primary keys (for unique-build join detection)
PRIMARY_KEYS = {
    "region": ("r_regionkey",), "nation": ("n_nationkey",),
    "supplier": ("s_suppkey",), "customer": ("c_custkey",),
    "part": ("p_partkey",), "partsupp": ("ps_partkey", "ps_suppkey"),
    "orders": ("o_orderkey",), "lineitem": ("l_orderkey", "l_linenumber"),
}


def value_range(column: str, sf: float):
    """(lo, hi) value bounds for range-selectivity estimation, in the
    engine's physical units (dates = epoch days, decimals = unscaled ints).
    The reference bundles exactly these bounds per column in
    ``plugin/trino-tpch/src/main/resources/tpch/statistics/sf1.0/*.json``
    (min/max per column); here they follow from the dbgen spec.  Returns
    None when unknown."""
    if column.endswith("date"):
        # dbgen date window 1992-01-01 .. 1998-12-31 (epoch days); receipt/
        # ship dates extend slightly past orderdate but the window is the
        # right scale for range selectivity
        return (8035, 10591)
    if column == "l_quantity":
        return (100, 5000)              # 1.00 .. 50.00 unscaled cents
    if column == "l_discount":
        return (0, 10)                  # 0.00 .. 0.10 at scale 2
    if column == "l_tax":
        return (0, 8)
    if column == "p_size":
        return (1, 50)
    if column == "o_totalprice":
        return (90000, 55500000)
    if column == "l_extendedprice":
        return (90000, 10500000)
    if column.endswith("regionkey"):
        return (0, 4)
    if column.endswith("nationkey"):
        return (0, 24)
    return None


def ndv_estimate(table: str, column: str, sf: float) -> int:
    """Rough distinct-count estimates for capacity hints (the CBO-stat role
    of the bundled ground-truth stats in
    ``plugin/trino-tpch/src/main/resources/tpch/statistics/``)."""
    rows = CATALOG.row_count(TableHandle(table, sf))
    keyish = {
        "l_orderkey": int(1_500_000 * sf), "o_orderkey": int(1_500_000 * sf),
        "l_partkey": int(200_000 * sf), "ps_partkey": int(200_000 * sf),
        "p_partkey": int(200_000 * sf),
        "l_suppkey": int(10_000 * sf), "ps_suppkey": int(10_000 * sf),
        "s_suppkey": int(10_000 * sf),
        "o_custkey": int(100_000 * sf), "c_custkey": int(150_000 * sf),
    }
    if column in keyish:
        return max(keyish[column], 1)
    if column.endswith("nationkey"):
        return 25
    if column.endswith("regionkey"):
        return 5
    if column.endswith("date"):
        return 2600
    if column in ("l_returnflag", "l_linestatus", "o_orderstatus"):
        return 3
    if column in ("l_quantity", "p_size"):
        return 50
    # dbgen categorical distributions (dists.dss cardinalities)
    if column == "c_mktsegment":
        return 5
    if column == "o_orderpriority":
        return 5
    if column == "l_shipmode":
        return 7
    if column == "l_shipinstruct":
        return 4
    if column == "p_brand":
        return 25
    if column == "p_container":
        return 40
    if column == "p_type":
        return 150
    if column == "p_mfgr":
        return 5
    if column in ("n_name",):
        return 25
    if column in ("r_name",):
        return 5
    return max(min(rows, 3000), 1)
