"""The benchmark's TPC-H tables: a frozen copy of the program's generator
(``presto_tpu_torch/tpch/generator.py``), computed in torch.

dbgen's structure with the repository's own streams: every column draws
from its own multiplicative LCG (``seed' = seed * 16807 mod 2^31 - 1``),
so draw ``u`` of row ``i`` is ``seed * 16807^(i * uses + u) mod M``, a
closed form that vectorizes over all rows. Bounded draws use dbgen's
double arithmetic (divide, scale, truncate), which IEEE float64 gives
alike on the CPU and the card. So the tables equal the program's own
generator bit for bit, on either device.

The tables do not depend on the benchmark's seed (as in TPC-H, where only
qgen's seed varies). Only the columns the 22 queries read are made; the
rest (``p_comment``, ``ps_comment``, ``o_clerk``, ``l_comment``) no query
reads, so the program's pruned scans would never upload them.

``generate(sf, device)`` returns ``{table: {column: HostColumn}}`` of
numpy arrays on the host: the same arrays go to the program (through the
harness's connector) and to the reference.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from . import text, words

MODULUS = 2147483647
MULTIPLIER = 16807

SUPPLIER_BASE = 10_000
CUSTOMER_BASE = 150_000
PART_BASE = 200_000
ORDERS_BASE = 1_500_000
SUPP_PER_PART = 4

_ALNUM = np.frombuffer((("abcdefghijklmnopqrstuvwxyz"
                         "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789,. ")
                        + " " * 64)[:64].encode("ascii"), dtype=np.uint8)


@dataclass
class HostColumn:
    """One generated column on the host. ``kind``: ``plain`` (values),
    ``dict`` (int32 codes into ``dictionary``) or ``bytes`` (a uint8
    [N, W] matrix, zero past each row's ``lengths``)."""
    kind: str
    values: np.ndarray
    lengths: Optional[np.ndarray] = None
    dictionary: Optional[List[str]] = None

    @property
    def rows(self) -> int:
        return int(self.values.shape[0])


def _seed(table: str, column: str) -> int:
    h = hashlib.md5(f"presto_tpu/{table}/{column}".encode()).digest()
    return (int.from_bytes(h[:8], "little") % (MODULUS - 1)) + 1


def bounded(raw: torch.Tensor, low: int, high: int) -> torch.Tensor:
    """dbgen UnifInt: ``low + (int)((raw / 2147483647.0) * (high - low + 1))``."""
    return low + ((raw.to(torch.float64) / float(MODULUS))
                  * float(high - low + 1)).to(torch.int64)


class _Gen:
    def __init__(self, sf: float, device: torch.device):
        self.sf = sf
        self.dev = torch.device(device)
        self._powers: Dict[tuple, torch.Tensor] = {}
        self._pool = None

    # ---- streams
    def powers(self, base: int, n: int) -> torch.Tensor:
        """[base^0, ..., base^(n-1)] mod M, by doubling."""
        key = (base, n)
        if key not in self._powers:
            p = torch.ones(1, dtype=torch.int64, device=self.dev)
            while p.numel() < n:
                p = torch.cat([p, (p * pow(base, p.numel(), MODULUS))
                               % MODULUS])
            self._powers[key] = p[:n]
        return self._powers[key]

    def values(self, table: str, column: str, n: int, use: int = 1,
               uses: int = 1) -> torch.Tensor:
        """Draw ``use`` (1-based) of each of ``n`` rows of a stream with
        ``uses`` draws a row."""
        base = (_seed(table, column) * pow(MULTIPLIER, use, MODULUS)) \
            % MODULUS
        return (base * self.powers(pow(MULTIPLIER, uses, MODULUS), n)) \
            % MODULUS

    def matrix(self, table: str, column: str, n: int, uses: int) -> torch.Tensor:
        """[n, uses]: every draw of every row."""
        rows = self.values(table, column, n, 1, uses)
        return (rows[:, None] * self.powers(MULTIPLIER, uses)[None, :]) \
            % MODULUS

    def draw(self, table, column, n, low, high) -> torch.Tensor:
        return bounded(self.values(table, column, n), low, high)

    # ---- column shapes
    def keyed_name(self, prefix: str, keys: torch.Tensor, digits: int = 9):
        p = torch.tensor(list(prefix.encode("ascii")), dtype=torch.uint8,
                         device=self.dev)
        n, width = keys.shape[0], len(prefix) + digits
        out = torch.zeros((n, width), dtype=torch.uint8, device=self.dev)
        out[:, :len(prefix)] = p
        k = keys.clone()
        for d in range(digits):
            out[:, len(prefix) + digits - 1 - d] = (48 + k % 10).to(torch.uint8)
            k = k // 10
        return out, torch.full((n,), width, dtype=torch.int32, device=self.dev)

    def v_string(self, table, column, n, min_len=10, max_len=40):
        m = self.matrix(table, column, n, max_len + 1)
        lengths = bounded(m[:, 0], min_len, max_len).to(torch.int32)
        alnum = torch.from_numpy(_ALNUM.copy()).to(self.dev)
        vals = alnum[bounded(m[:, 1:], 0, 63)]
        mask = torch.arange(max_len, device=self.dev)[None, :] \
            < lengths[:, None]
        return torch.where(mask, vals, torch.zeros_like(vals)), lengths

    def phone(self, table, column, nationkey: torch.Tensor, n):
        m = self.matrix(table, column, n, 3)
        segs = (10 + nationkey, bounded(m[:, 0], 100, 999),
                bounded(m[:, 1], 100, 999), bounded(m[:, 2], 1000, 9999))
        out = torch.zeros((n, 15), dtype=torch.uint8, device=self.dev)
        col = 0
        for seg, ndig in zip(segs, (2, 3, 3, 4)):
            v = seg.clone()
            for d in range(ndig):
                out[:, col + ndig - 1 - d] = (48 + v % 10).to(torch.uint8)
                v = v // 10
            col += ndig
            if col < 15:
                out[:, col] = ord("-")
                col += 1
        return out, torch.full((n,), 15, dtype=torch.int32, device=self.dev)

    def comment(self, table, column, n, min_len, max_len):
        if self._pool is None:
            self._pool = torch.from_numpy(text.get_pool().copy()).to(self.dev)
        m = self.matrix(table, column, n, 2)
        offs = m[:, 0] % (self._pool.numel() - max_len)
        lens = bounded(m[:, 1], min_len, max_len)
        vals = self._pool.unfold(0, max_len, 1)[offs]
        mask = torch.arange(max_len, device=self.dev)[None, :] < lens[:, None]
        return (torch.where(mask, vals, torch.zeros_like(vals)),
                lens.to(torch.int32))

    def dict_codes(self, table, column, n, dictionary) -> torch.Tensor:
        return self.draw(table, column, n, 0, len(dictionary) - 1).to(
            torch.int32)

    def arange_keys(self, n):
        return torch.arange(1, n + 1, dtype=torch.int64, device=self.dev)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _plain(t) -> HostColumn:
    return HostColumn("plain", _host(t))


def _bytes(vals_lens) -> HostColumn:
    v, l = vals_lens
    return HostColumn("bytes", _host(v), _host(l))


def _dict(codes, dictionary) -> HostColumn:
    return HostColumn("dict", _host(codes.to(torch.int32)), None,
                      list(dictionary))


def retail_price_cents(pk: torch.Tensor) -> torch.Tensor:
    return 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)


def bridge_suppkey(pk: torch.Tensor, s: torch.Tensor, supplier_count: int):
    """PART_SUPP_BRIDGE (spec 4.2.3, dbgen build.c)."""
    S = supplier_count
    return (pk + s * (S // SUPP_PER_PART + (pk - 1) // S)) % S + 1


def gen_region(g: _Gen) -> Dict[str, HostColumn]:
    return {
        "r_regionkey": HostColumn("plain", np.array(
            [r[0] for r in words.REGIONS], dtype=np.int64)),
        "r_name": HostColumn("dict", np.arange(5, dtype=np.int32), None,
                             [r[1] for r in words.REGIONS]),
        "r_comment": _bytes(g.comment("region", "comment", 5, 31, 115)),
    }


def gen_nation(g: _Gen) -> Dict[str, HostColumn]:
    return {
        "n_nationkey": HostColumn("plain", np.array(
            [x[0] for x in words.NATIONS], dtype=np.int64)),
        "n_name": HostColumn("dict", np.arange(25, dtype=np.int32), None,
                             [x[1] for x in words.NATIONS]),
        "n_regionkey": HostColumn("plain", np.array(
            [x[2] for x in words.NATIONS], dtype=np.int64)),
        "n_comment": _bytes(g.comment("nation", "comment", 25, 31, 114)),
    }


def gen_supplier(g: _Gen) -> Dict[str, HostColumn]:
    total = int(SUPPLIER_BASE * g.sf)
    keys = g.arange_keys(total)
    nationkey = g.draw("supplier", "nationkey", total, 0, 24)
    v, l = g.comment("supplier", "comment", total, 25, 100)
    v, l = _host(v), _host(l)
    # Q16's rows: "Customer ... Complaints" / "... Recommends", about 5 per SF
    interval = max(total // 5, 2)
    hkeys = np.arange(1, total + 1, dtype=np.int64)
    for rem, word in ((13, b"Complaints"), (7, b"Recommends")):
        cust = np.frombuffer(b"Customer ", dtype=np.uint8)
        w = np.frombuffer(word, dtype=np.uint8)
        for j in np.flatnonzero((hkeys % interval) == (rem % interval)):
            l[j] = max(l[j], len(cust) + len(w) + 5)
            v[j, :len(cust)] = cust
            v[j, l[j] - len(w):l[j]] = w
    return {
        "s_suppkey": _plain(keys),
        "s_name": _bytes(g.keyed_name("Supplier#", keys)),
        "s_address": _bytes(g.v_string("supplier", "address", total)),
        "s_nationkey": _plain(nationkey),
        "s_phone": _bytes(g.phone("supplier", "phone", nationkey, total)),
        "s_acctbal": _plain(g.draw("supplier", "acctbal", total, -99999,
                                   999999)),
        "s_comment": HostColumn("bytes", v, l),
    }


def gen_customer(g: _Gen) -> Dict[str, HostColumn]:
    total = int(CUSTOMER_BASE * g.sf)
    keys = g.arange_keys(total)
    nationkey = g.draw("customer", "nationkey", total, 0, 24)
    return {
        "c_custkey": _plain(keys),
        "c_name": _bytes(g.keyed_name("Customer#", keys)),
        "c_address": _bytes(g.v_string("customer", "address", total)),
        "c_nationkey": _plain(nationkey),
        "c_phone": _bytes(g.phone("customer", "phone", nationkey, total)),
        "c_acctbal": _plain(g.draw("customer", "acctbal", total, -99999,
                                   999999)),
        "c_mktsegment": _dict(g.dict_codes("customer", "mktsegment", total,
                                           words.MARKET_SEGMENTS),
                              words.MARKET_SEGMENTS),
        "c_comment": _bytes(g.comment("customer", "comment", total, 29, 116)),
    }


def _part_names(g: _Gen, n: int):
    """P_NAME: five distinct colors of 92, joined by spaces, as a [n, 55]
    byte matrix."""
    m = g.matrix("part", "name", n, 5)
    w = bounded(m, 0, 91)
    for _ in range(8):  # resolve duplicate picks as the program does
        for j in range(1, 5):
            dup = (w[:, j:j + 1] == w[:, :j]).any(dim=1)
            w[:, j] = torch.where(dup, (w[:, j] + 1) % 92, w[:, j])
    enc = [c.encode("ascii") for c in words.COLORS]
    table = np.zeros((92, 16), dtype=np.uint8)
    for i, b in enumerate(enc):
        table[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
    ctab = torch.from_numpy(table).to(g.dev)
    clen = torch.tensor([len(b) for b in enc], dtype=torch.int64,
                        device=g.dev)
    out = torch.zeros((n, 64 + 16), dtype=torch.uint8, device=g.dev)
    k = torch.arange(16, device=g.dev)[None, :]
    start = torch.zeros(n, dtype=torch.int64, device=g.dev)
    ends = []
    for j in range(5):
        lj = clen[w[:, j]]
        src = torch.where(k < lj[:, None], ctab[w[:, j]],
                          torch.zeros((), dtype=torch.uint8, device=g.dev))
        out.scatter_(1, start[:, None] + k, src)
        ends.append(start + lj)
        start = start + lj + 1
    rows = torch.arange(n, device=g.dev)
    for e in ends[:4]:
        out[rows, e] = ord(" ")
    length = ends[4].to(torch.int32)
    return out[:, :55].contiguous(), length


def gen_part(g: _Gen) -> Dict[str, HostColumn]:
    total = int(PART_BASE * g.sf)
    keys = g.arange_keys(total)
    mfgr = g.draw("part", "mfgr", total, 1, 5)
    b2 = g.draw("part", "brand", total, 1, 5)
    return {
        "p_partkey": _plain(keys),
        "p_name": _bytes(_part_names(g, total)),
        "p_mfgr": _dict(mfgr - 1, [f"Manufacturer#{i}" for i in range(1, 6)]),
        "p_brand": _dict((mfgr - 1) * 5 + (b2 - 1),
                         [f"Brand#{m}{i}" for m in range(1, 6)
                          for i in range(1, 6)]),
        "p_type": _dict(g.dict_codes("part", "type", total, words.PART_TYPES),
                        words.PART_TYPES),
        "p_size": _plain(g.draw("part", "size", total, 1, 50)),
        "p_container": _dict(g.dict_codes("part", "container", total,
                                          words.PART_CONTAINERS),
                             words.PART_CONTAINERS),
        "p_retailprice": _plain(retail_price_cents(keys)),
    }


def gen_partsupp(g: _Gen) -> Dict[str, HostColumn]:
    parts = int(PART_BASE * g.sf)
    n = parts * SUPP_PER_PART
    pk = torch.repeat_interleave(g.arange_keys(parts), SUPP_PER_PART)
    s = torch.arange(SUPP_PER_PART, dtype=torch.int64,
                     device=g.dev).repeat(parts)
    return {
        "ps_partkey": _plain(pk),
        "ps_suppkey": _plain(bridge_suppkey(pk, s,
                                            int(SUPPLIER_BASE * g.sf))),
        "ps_availqty": _plain(g.draw("partsupp", "availqty", n, 1, 9999)),
        "ps_supplycost": _plain(g.draw("partsupp", "supplycost", n, 100,
                                       100000)),
    }


def _order_shared(g: _Gen, n: int):
    idx = g.arange_keys(n)
    orderkey = ((idx >> 3) << 5) | (idx & 7)  # mk_sparse: 8 keys per 32
    counts = bounded(g.values("lineitem", "count", n), 1, 7)
    odate = words.START_DAYS + g.draw("orders", "orderdate", n, 0,
                                      words.ORDER_DATE_MAX_OFFSET)
    return orderkey, counts, odate


def _line_draw(g: _Gen, column: str, n: int, low: int, high: int):
    """[n, 7]: one column's draws for the seven possible lines of each
    order."""
    return bounded(g.matrix("lineitem", column, n, 7), low, high)


def _pricing(g: _Gen, n: int):
    qty = _line_draw(g, "quantity", n, 1, 50)
    pk = _line_draw(g, "partkey", n, 1, int(PART_BASE * g.sf))
    disc = _line_draw(g, "discount", n, 0, 10)
    tax = _line_draw(g, "tax", n, 0, 8)
    return qty, pk, disc, tax, qty * retail_price_cents(pk)


def gen_orders(g: _Gen) -> Dict[str, HostColumn]:
    n = int(ORDERS_BASE * g.sf)
    orderkey, counts, odate = _order_shared(g, n)
    cmax = int(CUSTOMER_BASE * g.sf)
    ck = g.draw("orders", "custkey", n, 1, cmax)
    ck = torch.where(ck % 3 == 0, torch.clamp(ck + 1, max=cmax), ck)
    ck = torch.where(ck % 3 == 0, ck - 1, ck)  # only when clamped at max
    valid = torch.arange(7, device=g.dev)[None, :] < counts[:, None]
    qty, pk, disc, tax, eprice = _pricing(g, n)
    del qty, pk
    shipdate = odate[:, None] + _line_draw(g, "shipdate", n, 1, 121)
    open_ = (shipdate > words.CURRENT_DAYS) & valid
    all_open = open_.sum(dim=1) == counts
    none_open = ~open_.any(dim=1)
    status = torch.where(all_open, 0, torch.where(none_open, 1, 2))
    line_total = ((eprice * (100 - disc)) // 100) * (100 + tax) // 100
    total = torch.where(valid, line_total, 0).sum(dim=1)
    del eprice, disc, tax, shipdate, line_total
    return {
        "o_orderkey": _plain(orderkey),
        "o_custkey": _plain(ck),
        "o_orderstatus": _dict(status, ["O", "F", "P"]),
        "o_totalprice": _plain(total),
        "o_orderdate": _plain(odate.to(torch.int32)),
        "o_orderpriority": _dict(g.dict_codes("orders", "orderpriority", n,
                                              words.ORDER_PRIORITIES),
                                 words.ORDER_PRIORITIES),
        "o_shippriority": _plain(torch.zeros(n, dtype=torch.int64,
                                             device=g.dev)),
        "o_comment": _bytes(g.comment("orders", "comment", n, 19, 78)),
    }


def gen_lineitem(g: _Gen) -> Dict[str, HostColumn]:
    n = int(ORDERS_BASE * g.sf)
    orderkey, counts, odate = _order_shared(g, n)
    flat = (torch.arange(7, device=g.dev)[None, :]
            < counts[:, None]).reshape(-1)

    def take(mat):
        return mat.reshape(-1)[flat]

    out = {"l_orderkey": _plain(torch.repeat_interleave(orderkey, counts))}
    qty, pk, disc, tax, eprice = _pricing(g, n)
    lpk = take(pk)
    out["l_partkey"] = _plain(lpk)
    out["l_suppkey"] = _plain(bridge_suppkey(
        lpk, take(_line_draw(g, "suppsel", n, 0, 3)),
        int(SUPPLIER_BASE * g.sf)))
    del pk, lpk
    out["l_linenumber"] = _plain(take(torch.arange(
        1, 8, dtype=torch.int64, device=g.dev).expand(n, 7)))
    out["l_quantity"] = _plain(take(qty) * 100)  # decimal(15,2) unscaled
    out["l_extendedprice"] = _plain(take(eprice))
    out["l_discount"] = _plain(take(disc))
    out["l_tax"] = _plain(take(tax))
    del qty, eprice, disc, tax
    shipdate = odate[:, None] + _line_draw(g, "shipdate", n, 1, 121)
    receipt = shipdate + _line_draw(g, "receiptdate", n, 1, 30)
    ra = _line_draw(g, "returnflag", n, 0, 1)
    out["l_returnflag"] = _dict(torch.where(
        take(receipt) <= words.CURRENT_DAYS, take(ra), 2), ["R", "A", "N"])
    out["l_linestatus"] = _dict(
        (take(shipdate) <= words.CURRENT_DAYS).to(torch.int32), ["O", "F"])
    out["l_shipdate"] = _plain(take(shipdate).to(torch.int32))
    out["l_commitdate"] = _plain(take(
        odate[:, None] + _line_draw(g, "commitdate", n, 30, 90)).to(
        torch.int32))
    out["l_receiptdate"] = _plain(take(receipt).to(torch.int32))
    del shipdate, receipt, ra
    out["l_shipinstruct"] = _dict(take(_line_draw(
        g, "shipinstruct", n, 0, len(words.SHIP_INSTRUCTIONS) - 1)),
        words.SHIP_INSTRUCTIONS)
    out["l_shipmode"] = _dict(take(_line_draw(
        g, "shipmode", n, 0, len(words.SHIP_MODES) - 1)), words.SHIP_MODES)
    return out


GENERATORS = {"region": gen_region, "nation": gen_nation,
              "supplier": gen_supplier, "customer": gen_customer,
              "part": gen_part, "partsupp": gen_partsupp,
              "orders": gen_orders, "lineitem": gen_lineitem}


def row_counts(sf: float, device="cpu") -> Dict[str, int]:
    """Each table's row count at ``sf``, as ``generate`` makes it, from
    the sizes and lineitem's count stream alone."""
    g = _Gen(sf, device)
    orders = int(ORDERS_BASE * sf)
    lines = bounded(g.values("lineitem", "count", orders), 1, 7)
    return {"region": 5, "nation": 25,
            "supplier": int(SUPPLIER_BASE * sf),
            "customer": int(CUSTOMER_BASE * sf),
            "part": int(PART_BASE * sf),
            "partsupp": int(PART_BASE * sf) * SUPP_PER_PART,
            "orders": orders, "lineitem": int(lines.sum())}


def generate(sf: float, device="cpu",
             tables=tuple(GENERATORS)) -> Dict[str, Dict[str, HostColumn]]:
    """The named tables at scale factor ``sf``, computed on ``device``
    and returned as host columns."""
    g = _Gen(sf, device)
    out = {}
    for name in tables:
        out[name] = GENERATORS[name](g)
        g._powers.clear()
    return out
