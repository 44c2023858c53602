"""Vectorized, deterministic, split-able TPC-H data generator.

The reference consumes TPC-H data through the external ``io.trino.tpch``
generator (``plugin/trino-tpch/pom.xml:21``; splits sliced as
(partNumber, totalParts) over the generator, ``TpchSplitManager.java:55``).
This module reimplements the *public TPC-H dbgen specification* directly,
with every column drawn from its own skip-ahead LCG stream so any row range
``[first_row, first_row+n)`` of any table generates in O(n) with no prefix
work — the property that makes distributed scans embarrassingly parallel.

Spec-faithful structure:
- sparse order keys     key(i) = ((i>>3)<<5) | (i&7)
- customer mortality    o_custkey never divisible by 3
- partsupp bridge       ps_suppkey = (pk + s*(S/4 + (pk-1)/S)) % S + 1
- retail price formula  (90000 + (pk/10)%20001 + 100*(pk%1000)) cents
- o_totalprice          integer-cent arithmetic: sum(((ep*(100-d))/100)*(100+t)/100)
- date ranges           o_orderdate in [1992-01-01, 1998-08-02], ship/commit/
                        receipt offsets +[1,121]/+[30,90]/+[1,30]
- Q16 supplier comments "Customer ... Complaints/Recommends" rows injected

Money/decimal columns are exact int64 unscaled values (scale 2 = cents),
never floats, so aggregates are bit-exact (Trino models these as exact
decimals, ``core/trino-spi/.../type/DecimalType.java``).
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional

import numpy as np

from ..data import types as T
from ..data.column import Column, plain_column, dict_column, bytes_column
from ..data.table import Table
from . import words, text
from .rng import Stream, bounded_int

MODULUS = 2147483647

# base row counts at SF1 (spec 4.2.5)
SUPPLIER_BASE = 10_000
CUSTOMER_BASE = 150_000
PART_BASE = 200_000
ORDERS_BASE = 1_500_000
CLERKS_PER_SF = 1_000
SUPP_PER_PART = 4


def _seed(table: str, column: str) -> int:
    h = hashlib.md5(f"presto_tpu/{table}/{column}".encode()).digest()
    return (int.from_bytes(h[:8], "little") % (MODULUS - 1)) + 1


def _stream(table: str, column: str, uses_per_row: int = 1) -> Stream:
    return Stream(_seed(table, column), uses_per_row)


def _draw(table, column, n, low, high, first_row=0):
    s = _stream(table, column)
    return bounded_int(s.values(n, 1, first_row), low, high)


def _alnum_lookup() -> np.ndarray:
    chars = ("abcdefghijklmnopqrstuvwxyz"
             "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
             "0123456789,. ")
    # pad to 64 symbols
    chars = (chars + " " * 64)[:64]
    return np.frombuffer(chars.encode("ascii"), dtype=np.uint8)


_ALNUM = _alnum_lookup()


def _keyed_name(prefix: str, keys: np.ndarray, digits: int = 9):
    """Vectorized '%s#%0<digits>d' formatting into a fixed-width byte matrix."""
    n = len(keys)
    p = np.frombuffer(prefix.encode("ascii"), dtype=np.uint8)
    width = len(p) + digits
    out = np.zeros((n, width), dtype=np.uint8)
    out[:, : len(p)] = p
    k = keys.astype(np.int64).copy()
    for d in range(digits):
        out[:, len(p) + digits - 1 - d] = 48 + (k % 10)
        k //= 10
    return out, np.full(n, width, dtype=np.int32)


def _v_string(table, column, n, first_row, min_len=10, max_len=40):
    """Random alphanumeric string column (spec 4.2.2.7 v-string)."""
    s = _stream(table, column, uses_per_row=max_len + 1)
    lengths = bounded_int(s.values(n, 1, first_row), min_len, max_len).astype(np.int32)
    cols = [bounded_int(s.values(n, u + 2, first_row), 0, 63) for u in range(max_len)]
    raw = np.stack(cols, axis=1)
    vals = _ALNUM[raw]
    mask = np.arange(max_len)[None, :] < lengths[:, None]
    vals = np.where(mask, vals, np.uint8(0))
    return vals, lengths


def _phone(table, column, nationkey: np.ndarray, n, first_row):
    """'CC-LLL-LLL-LLLL' with CC = 10 + nationkey (spec 4.2.2.9)."""
    s = _stream(table, column, uses_per_row=3)
    seg1 = bounded_int(s.values(n, 1, first_row), 100, 999)
    seg2 = bounded_int(s.values(n, 2, first_row), 100, 999)
    seg3 = bounded_int(s.values(n, 3, first_row), 1000, 9999)
    cc = 10 + nationkey.astype(np.int64)
    out = np.zeros((n, 15), dtype=np.uint8)

    def put_digits(col, val, ndig):
        v = val.copy()
        for d in range(ndig):
            out[:, col + ndig - 1 - d] = 48 + (v % 10)
            v //= 10

    put_digits(0, cc, 2)
    out[:, 2] = ord("-")
    put_digits(3, seg1, 3)
    out[:, 6] = ord("-")
    put_digits(7, seg2, 3)
    out[:, 10] = ord("-")
    put_digits(11, seg3, 4)
    return out, np.full(n, 15, dtype=np.int32)


def _comment(table, column, n, first_row, min_len, max_len):
    s = _stream(table, column, uses_per_row=2)
    offs = s.values(n, 1, first_row)
    lens = bounded_int(s.values(n, 2, first_row), min_len, max_len)
    return text.substrings(offs, lens, max_len)


def _dict_col(table, column, n, first_row, dictionary: List[str], dtype=None) -> Column:
    codes = _draw(table, column, n, 0, len(dictionary) - 1, first_row).astype(np.int32)
    return dict_column(dtype or T.varchar(), codes, dictionary)


def _money(cents: np.ndarray, precision=15, scale=2) -> Column:
    return plain_column(T.decimal(precision, scale), cents.astype(np.int64))


def retail_price_cents(partkey: np.ndarray) -> np.ndarray:
    pk = partkey.astype(np.int64)
    return 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)


# ---------------------------------------------------------------- region/nation

def gen_region(**_) -> Table:
    keys = np.array([r[0] for r in words.REGIONS], dtype=np.int64)
    names = [r[1] for r in words.REGIONS]
    vals, lens = _comment("region", "comment", 5, 0, 31, 115)
    return Table({
        "r_regionkey": plain_column(T.BIGINT, keys),
        # dictionary-encoded: 5 fixed names — group keys/pack aggregates
        # fuse into traced programs (BYTES would force eager host paths)
        "r_name": dict_column(T.varchar(25),
                              np.arange(len(names), dtype=np.int32), names),
        "r_comment": bytes_column(T.varchar(152), values=vals, lengths=lens),
    })


def gen_nation(**_) -> Table:
    keys = np.array([x[0] for x in words.NATIONS], dtype=np.int64)
    names = [x[1] for x in words.NATIONS]
    rkeys = np.array([x[2] for x in words.NATIONS], dtype=np.int64)
    vals, lens = _comment("nation", "comment", 25, 0, 31, 114)
    return Table({
        "n_nationkey": plain_column(T.BIGINT, keys),
        "n_name": dict_column(T.varchar(25),
                              np.arange(len(names), dtype=np.int32), names),
        "n_regionkey": plain_column(T.BIGINT, rkeys),
        "n_comment": bytes_column(T.varchar(152), values=vals, lengths=lens),
    })


# ---------------------------------------------------------------- supplier

def gen_supplier(sf: float, first_row: int = 0, n_rows: Optional[int] = None,
                 columns=None) -> Table:
    total = int(SUPPLIER_BASE * sf)
    n = total - first_row if n_rows is None else n_rows
    keys = np.arange(first_row + 1, first_row + n + 1, dtype=np.int64)
    want = set(columns) if columns else None

    out: Dict[str, Column] = {}

    def wanted(c):
        return want is None or c in want

    out["s_suppkey"] = plain_column(T.BIGINT, keys)
    nationkey = _draw("supplier", "nationkey", n, 0, 24, first_row)
    if wanted("s_name"):
        v, l = _keyed_name("Supplier#", keys)
        out["s_name"] = bytes_column(T.varchar(25), values=v, lengths=l)
    if wanted("s_address"):
        v, l = _v_string("supplier", "address", n, first_row)
        out["s_address"] = bytes_column(T.varchar(40), values=v, lengths=l)
    out["s_nationkey"] = plain_column(T.BIGINT, nationkey)
    if wanted("s_phone"):
        v, l = _phone("supplier", "phone", nationkey, n, first_row)
        out["s_phone"] = bytes_column(T.varchar(15), values=v, lengths=l)
    if wanted("s_acctbal"):
        out["s_acctbal"] = _money(_draw("supplier", "acctbal", n, -99999, 999999, first_row))
    if wanted("s_comment"):
        v, l = _comment("supplier", "comment", n, first_row, 25, 100)
        # Q16 fixture rows: "Customer ... Complaints" / "... Recommends"
        # (spec: 5 rows per SF each). Deterministic, split-independent picks.
        interval = max(total // 5, 2)  # ~5 rows per SF at any scale
        complaints = (keys % interval) == (13 % interval)
        recommends = (keys % interval) == (7 % interval)
        for mask, word in ((complaints, b"Complaints"), (recommends, b"Recommends")):
            idx = np.nonzero(mask)[0]
            if len(idx):
                cust = np.frombuffer(b"Customer ", dtype=np.uint8)
                w = np.frombuffer(word, dtype=np.uint8)
                l[idx] = np.maximum(l[idx], len(cust) + len(w) + 5)
                v[idx, : len(cust)] = cust
                for j in idx:
                    v[j, l[j] - len(w): l[j]] = w
        out["s_comment"] = bytes_column(T.varchar(101), values=v, lengths=l)
    t = Table(out)
    return t.select([c for c in t.names if want is None or c in want or c == "s_suppkey"])


# ---------------------------------------------------------------- customer

def gen_customer(sf: float, first_row: int = 0, n_rows: Optional[int] = None,
                 columns=None) -> Table:
    total = int(CUSTOMER_BASE * sf)
    n = total - first_row if n_rows is None else n_rows
    keys = np.arange(first_row + 1, first_row + n + 1, dtype=np.int64)
    want = set(columns) if columns else None

    def wanted(c):
        return want is None or c in want

    out: Dict[str, Column] = {"c_custkey": plain_column(T.BIGINT, keys)}
    nationkey = _draw("customer", "nationkey", n, 0, 24, first_row)
    if wanted("c_name"):
        v, l = _keyed_name("Customer#", keys)
        out["c_name"] = bytes_column(T.varchar(25), values=v, lengths=l)
    if wanted("c_address"):
        v, l = _v_string("customer", "address", n, first_row)
        out["c_address"] = bytes_column(T.varchar(40), values=v, lengths=l)
    out["c_nationkey"] = plain_column(T.BIGINT, nationkey)
    if wanted("c_phone"):
        v, l = _phone("customer", "phone", nationkey, n, first_row)
        out["c_phone"] = bytes_column(T.varchar(15), values=v, lengths=l)
    if wanted("c_acctbal"):
        out["c_acctbal"] = _money(_draw("customer", "acctbal", n, -99999, 999999, first_row))
    if wanted("c_mktsegment"):
        out["c_mktsegment"] = _dict_col("customer", "mktsegment", n, first_row,
                                        words.MARKET_SEGMENTS, T.varchar(10))
    if wanted("c_comment"):
        v, l = _comment("customer", "comment", n, first_row, 29, 116)
        out["c_comment"] = bytes_column(T.varchar(117), values=v, lengths=l)
    t = Table(out)
    return t.select([c for c in t.names if want is None or c in want or c == "c_custkey"])


# ---------------------------------------------------------------- part

def gen_part(sf: float, first_row: int = 0, n_rows: Optional[int] = None,
             columns=None) -> Table:
    total = int(PART_BASE * sf)
    n = total - first_row if n_rows is None else n_rows
    keys = np.arange(first_row + 1, first_row + n + 1, dtype=np.int64)
    want = set(columns) if columns else None

    def wanted(c):
        return want is None or c in want

    out: Dict[str, Column] = {"p_partkey": plain_column(T.BIGINT, keys)}

    if wanted("p_name"):
        # 5 distinct colors of 92 (spec 4.2.3 P_NAME)
        s = _stream("part", "name", uses_per_row=5)
        w = np.stack([bounded_int(s.values(n, u + 1, first_row), 0, 91)
                      for u in range(5)], axis=1)
        for _ in range(8):  # resolve duplicate picks deterministically
            for j in range(1, 5):
                dup = (w[:, j:j + 1] == w[:, :j]).any(axis=1)
                w[dup, j] = (w[dup, j] + 1) % 92
        names = [" ".join(words.COLORS[c] for c in row) for row in w]
        out["p_name"] = bytes_column(T.varchar(55), names)

    mfgr = _draw("part", "mfgr", n, 1, 5, first_row)
    if wanted("p_mfgr"):
        dic = [f"Manufacturer#{i}" for i in range(1, 6)]
        out["p_mfgr"] = dict_column(T.varchar(25), (mfgr - 1).astype(np.int32), dic)
    if wanted("p_brand"):
        b2 = _draw("part", "brand", n, 1, 5, first_row)
        dic = [f"Brand#{m}{i}" for m in range(1, 6) for i in range(1, 6)]
        codes = ((mfgr - 1) * 5 + (b2 - 1)).astype(np.int32)
        out["p_brand"] = dict_column(T.varchar(10), codes, dic)
    if wanted("p_type"):
        out["p_type"] = _dict_col("part", "type", n, first_row, words.PART_TYPES,
                                  T.varchar(25))
    if wanted("p_size"):
        out["p_size"] = plain_column(T.BIGINT, _draw("part", "size", n, 1, 50, first_row))
    if wanted("p_container"):
        out["p_container"] = _dict_col("part", "container", n, first_row,
                                       words.PART_CONTAINERS, T.varchar(10))
    if wanted("p_retailprice"):
        out["p_retailprice"] = _money(retail_price_cents(keys))
    if wanted("p_comment"):
        v, l = _comment("part", "comment", n, first_row, 5, 22)
        out["p_comment"] = bytes_column(T.varchar(23), values=v, lengths=l)
    t = Table(out)
    return t.select([c for c in t.names if want is None or c in want or c == "p_partkey"])


# ---------------------------------------------------------------- partsupp

def bridge_suppkey(partkey: np.ndarray, s: np.ndarray, supplier_count: int) -> np.ndarray:
    """PART_SUPP_BRIDGE (spec 4.2.3 / dbgen build.c)."""
    pk = partkey.astype(np.int64)
    S = np.int64(supplier_count)
    return (pk + s * (S // SUPP_PER_PART + (pk - 1) // S)) % S + 1


def gen_partsupp(sf: float, first_row: int = 0, n_rows: Optional[int] = None,
                 columns=None) -> Table:
    """first_row/n_rows are in *part* units × 4 (rows are grouped by part)."""
    total = int(PART_BASE * sf) * SUPP_PER_PART
    n = total - first_row if n_rows is None else n_rows
    assert first_row % 4 == 0 and n % 4 == 0, "partsupp splits on part boundaries"
    part_first, n_parts = first_row // 4, n // 4
    pk = np.repeat(np.arange(part_first + 1, part_first + n_parts + 1, dtype=np.int64), 4)
    s = np.tile(np.arange(4, dtype=np.int64), n_parts)
    want = set(columns) if columns else None

    def wanted(c):
        return want is None or c in want

    out: Dict[str, Column] = {
        "ps_partkey": plain_column(T.BIGINT, pk),
        "ps_suppkey": plain_column(T.BIGINT,
                                   bridge_suppkey(pk, s, int(SUPPLIER_BASE * sf))),
    }
    if wanted("ps_availqty"):
        out["ps_availqty"] = plain_column(
            T.BIGINT, _draw("partsupp", "availqty", n, 1, 9999, first_row))
    if wanted("ps_supplycost"):
        out["ps_supplycost"] = _money(
            _draw("partsupp", "supplycost", n, 100, 100000, first_row))
    if wanted("ps_comment"):
        v, l = _comment("partsupp", "comment", n, first_row, 49, 198)
        out["ps_comment"] = bytes_column(T.varchar(199), values=v, lengths=l)
    t = Table(out)
    keep = {"ps_partkey", "ps_suppkey"}
    return t.select([c for c in t.names if want is None or c in want or c in keep])


# ---------------------------------------------------------------- orders/lineitem

def sparse_orderkey(index: np.ndarray) -> np.ndarray:
    """mk_sparse: 8 used keys per 32-key block (dbgen build.c)."""
    i = index.astype(np.int64)
    return ((i >> 3) << 5) | (i & 7)


def _order_shared(sf: float, first_order: int, n: int):
    """Draws shared between orders and lineitem generation."""
    idx = np.arange(first_order + 1, first_order + n + 1, dtype=np.int64)
    orderkey = sparse_orderkey(idx)
    counts = bounded_int(_stream("lineitem", "count").values(n, 1, first_order), 1, 7)
    odate = words.START_DAYS + _draw(
        "orders", "orderdate", n, 0, words.ORDER_DATE_MAX_OFFSET, first_order)
    return idx, orderkey, counts.astype(np.int64), odate.astype(np.int32)


def _lineitem_draw(column: str, n_orders: int, first_order: int, low: int, high: int):
    """[n_orders, 7] matrix of per-lineitem draws for one column."""
    s = _stream("lineitem", column, uses_per_row=7)
    return np.stack([bounded_int(s.values(n_orders, u + 1, first_order), low, high)
                     for u in range(7)], axis=1)


def _lineitem_pricing(sf, first_order, n):
    """Per-lineitem [n,7] quantity/partkey/eprice/discount/tax draws."""
    qty = _lineitem_draw("quantity", n, first_order, 1, 50)
    pk = _lineitem_draw("partkey", n, first_order, 1, int(PART_BASE * sf))
    disc = _lineitem_draw("discount", n, first_order, 0, 10)
    tax = _lineitem_draw("tax", n, first_order, 0, 8)
    eprice = qty * retail_price_cents(pk)
    return qty, pk, disc, tax, eprice


def gen_orders(sf: float, first_row: int = 0, n_rows: Optional[int] = None,
               columns=None) -> Table:
    total = int(ORDERS_BASE * sf)
    n = total - first_row if n_rows is None else n_rows
    _, orderkey, counts, odate = _order_shared(sf, first_row, n)
    want = set(columns) if columns else None

    def wanted(c):
        return want is None or c in want

    out: Dict[str, Column] = {"o_orderkey": plain_column(T.BIGINT, orderkey)}

    if wanted("o_custkey"):
        cmax = int(CUSTOMER_BASE * sf)
        ck = _draw("orders", "custkey", n, 1, cmax, first_row)
        ck = np.where(ck % 3 == 0, np.minimum(ck + 1, cmax), ck)
        ck = np.where(ck % 3 == 0, ck - 1, ck)  # only when clamped at max
        out["o_custkey"] = plain_column(T.BIGINT, ck)

    need_lines = wanted("o_orderstatus") or wanted("o_totalprice")
    if need_lines:
        valid = np.arange(7)[None, :] < counts[:, None]
        qty, pk, disc, tax, eprice = _lineitem_pricing(sf, first_row, n)
        sdelta = _lineitem_draw("shipdate", n, first_row, 1, 121)
        shipdate = odate[:, None] + sdelta
        if wanted("o_orderstatus"):
            open_ = (shipdate > words.CURRENT_DAYS) & valid
            all_open = (open_.sum(axis=1) == counts)
            none_open = ~open_.any(axis=1)
            status = np.where(all_open, 0, np.where(none_open, 1, 2)).astype(np.int32)
            out["o_orderstatus"] = dict_column(T.varchar(1), status, ["O", "F", "P"])
        if wanted("o_totalprice"):
            line_total = ((eprice * (100 - disc)) // 100) * (100 + tax) // 100
            out["o_totalprice"] = _money(np.where(valid, line_total, 0).sum(axis=1))

    if wanted("o_orderdate"):
        out["o_orderdate"] = plain_column(T.DATE, odate)
    if wanted("o_orderpriority"):
        out["o_orderpriority"] = _dict_col("orders", "orderpriority", n, first_row,
                                           words.ORDER_PRIORITIES, T.varchar(15))
    if wanted("o_clerk"):
        ck = _draw("orders", "clerk", n, 1, max(int(CLERKS_PER_SF * sf), 1), first_row)
        v, l = _keyed_name("Clerk#", ck)
        out["o_clerk"] = bytes_column(T.varchar(15), values=v, lengths=l)
    if wanted("o_shippriority"):
        out["o_shippriority"] = plain_column(T.BIGINT, np.zeros(n, dtype=np.int64))
    if wanted("o_comment"):
        v, l = _comment("orders", "comment", n, first_row, 19, 78)
        out["o_comment"] = bytes_column(T.varchar(79), values=v, lengths=l)
    t = Table(out)
    return t.select([c for c in t.names if want is None or c in want or c == "o_orderkey"])


def gen_lineitem(sf: float, first_row: int = 0, n_rows: Optional[int] = None,
                 columns=None) -> Table:
    """first_row/n_rows are in *order* units (split = order range)."""
    total_orders = int(ORDERS_BASE * sf)
    n = total_orders - first_row if n_rows is None else n_rows
    _, orderkey, counts, odate = _order_shared(sf, first_row, n)
    valid = np.arange(7)[None, :] < counts[:, None]
    flat = valid.reshape(-1)
    want = set(columns) if columns else None

    def wanted(c):
        return want is None or c in want

    def take(mat):
        return mat.reshape(-1)[flat]

    out: Dict[str, Column] = {
        "l_orderkey": plain_column(T.BIGINT, np.repeat(orderkey, counts)),
    }
    qty = pk = disc = tax = eprice = None
    if wanted("l_partkey") or wanted("l_suppkey") or wanted("l_quantity") \
            or wanted("l_extendedprice") or wanted("l_discount") or wanted("l_tax"):
        qty, pk, disc, tax, eprice = _lineitem_pricing(sf, first_row, n)

    if wanted("l_partkey"):
        out["l_partkey"] = plain_column(T.BIGINT, take(pk))
    if wanted("l_suppkey"):
        s = _lineitem_draw("suppsel", n, first_row, 0, 3)
        out["l_suppkey"] = plain_column(
            T.BIGINT, bridge_suppkey(take(pk), take(s), int(SUPPLIER_BASE * sf)))
    if wanted("l_linenumber"):
        ln = np.tile(np.arange(1, 8, dtype=np.int64), (n, 1))
        out["l_linenumber"] = plain_column(T.BIGINT, take(ln))
    if wanted("l_quantity"):
        out["l_quantity"] = _money(take(qty) * 100)  # decimal(15,2) unscaled
    if wanted("l_extendedprice"):
        out["l_extendedprice"] = _money(take(eprice))
    if wanted("l_discount"):
        out["l_discount"] = _money(take(disc))
    if wanted("l_tax"):
        out["l_tax"] = _money(take(tax))

    sdelta = _lineitem_draw("shipdate", n, first_row, 1, 121)
    shipdate = odate[:, None] + sdelta
    if wanted("l_returnflag") or wanted("l_receiptdate"):
        rdelta = _lineitem_draw("receiptdate", n, first_row, 1, 30)
        receipt = shipdate + rdelta
    if wanted("l_returnflag"):
        ra = _lineitem_draw("returnflag", n, first_row, 0, 1)
        code = np.where(take(receipt) <= words.CURRENT_DAYS, take(ra), 2).astype(np.int32)
        out["l_returnflag"] = dict_column(T.varchar(1), code, ["R", "A", "N"])
    if wanted("l_linestatus"):
        code = (take(shipdate) <= words.CURRENT_DAYS).astype(np.int32)
        out["l_linestatus"] = dict_column(T.varchar(1), code, ["O", "F"])
    if wanted("l_shipdate"):
        out["l_shipdate"] = plain_column(T.DATE, take(shipdate).astype(np.int32))
    if wanted("l_commitdate"):
        cdelta = _lineitem_draw("commitdate", n, first_row, 30, 90)
        out["l_commitdate"] = plain_column(
            T.DATE, (odate[:, None] + cdelta).reshape(-1)[flat].astype(np.int32))
    if wanted("l_receiptdate"):
        out["l_receiptdate"] = plain_column(T.DATE, take(receipt).astype(np.int32))
    if wanted("l_shipinstruct"):
        c = _lineitem_draw("shipinstruct", n, first_row, 0,
                           len(words.SHIP_INSTRUCTIONS) - 1)
        out["l_shipinstruct"] = dict_column(T.varchar(25), take(c).astype(np.int32),
                                            words.SHIP_INSTRUCTIONS)
    if wanted("l_shipmode"):
        c = _lineitem_draw("shipmode", n, first_row, 0, len(words.SHIP_MODES) - 1)
        out["l_shipmode"] = dict_column(T.varchar(10), take(c).astype(np.int32),
                                        words.SHIP_MODES)
    if wanted("l_comment"):
        n_lines = int(flat.sum())
        s = _stream("lineitem", "comment", uses_per_row=14)
        offs = np.stack([s.values(n, u + 1, first_row) for u in range(7)], axis=1)
        lens = np.stack([bounded_int(s.values(n, u + 8, first_row), 10, 43)
                         for u in range(7)], axis=1)
        v, l = text.substrings(take(offs), take(lens), 43)
        out["l_comment"] = bytes_column(T.varchar(44), values=v, lengths=l)
        assert v.shape[0] == n_lines
    t = Table(out)
    return t.select([c for c in t.names if want is None or c in want or c == "l_orderkey"])


# ---------------------------------------------------------------- entry point

GENERATORS = {
    "region": gen_region,
    "nation": gen_nation,
    "supplier": gen_supplier,
    "customer": gen_customer,
    "part": gen_part,
    "partsupp": gen_partsupp,
    "orders": gen_orders,
    "lineitem": gen_lineitem,
}

# split unit per table: how first_row/n_rows are interpreted
ROW_UNITS = {
    "region": 5, "nation": 25,
    "supplier": SUPPLIER_BASE, "customer": CUSTOMER_BASE, "part": PART_BASE,
    "partsupp": PART_BASE * SUPP_PER_PART,
    "orders": ORDERS_BASE, "lineitem": ORDERS_BASE,  # lineitem splits by order
}


def generate(table: str, sf: float = 0.01, columns=None,
             first_row: int = 0, n_rows: Optional[int] = None) -> Table:
    gen = GENERATORS[table]
    if table in ("region", "nation"):
        return gen()
    return gen(sf, first_row=first_row, n_rows=n_rows, columns=columns)


def total_unit_rows(table: str, sf: float) -> int:
    if table in ("region", "nation"):
        return ROW_UNITS[table]
    return int(ROW_UNITS[table] * sf)


def slice_row_count(table: str, sf: float, first_row: int,
                    n_rows: int) -> int:
    """Row count of a generator slice WITHOUT materializing columns.

    Lineitem slices are order-unit ranges with data-dependent fanout
    (1..7 lines per order); every other table is 1 row per unit.  Used by
    multi-process sharding, where each process must know every shard's
    row count (for the common pad capacity) but only generates its own."""
    if table == "lineitem":
        counts = bounded_int(
            _stream("lineitem", "count").values(n_rows, 1, first_row), 1, 7)
        return int(counts.sum())
    return n_rows
