"""The plain reference of the 22 TPC-H queries, with their substitution
parameters, over the benchmark's own host tables.

A frozen copy of ``tools/np_tpch_oracle.py`` (its Q1-Q22), changed in
three ways: each query takes the parameters the traffic drew from the
seed (TPC-H clause 2.4) in place of the validation values; it reads the
host columns of ``tpch_gen.generate``, never the program's data source;
and it computes in plain torch, so that at SF10 it can run on the card
after the window (numpy takes minutes there). It imports nothing of the
program.

Decimals stay unscaled integers with exact sums (int64 halves summed
apart, Python ints beyond); a decimal division rounds half away from
zero, as the program's decimals do. LIKE is a search of the byte
matrix; years come from the civil calendar. Each query returns
``{column: [python values]}``, rows in the query's order.

``low_precision=True`` is the control: the same queries with every
decimal sum and division taken in float64 (DOUBLE) and rounded back to
the decimal's scale, the step that would tempt a faster program.
"""

from __future__ import annotations

import datetime as dt
from typing import Dict, List

import numpy as np
import torch

EPOCH = dt.date(1970, 1, 1)


def days(iso: str) -> int:
    return (dt.date.fromisoformat(iso) - EPOCH).days


def add_months(iso: str, months: int) -> int:
    """Days of ``iso`` (a first of a month) plus ``months`` months."""
    d = dt.date.fromisoformat(iso)
    m = d.month - 1 + months
    return (dt.date(d.year + m // 12, m % 12 + 1, d.day) - EPOCH).days


def div_half_up(num: int, den: int) -> int:
    sign = -1 if (num < 0) != (den < 0) else 1
    q, r = divmod(abs(num), abs(den))
    return sign * (q + (2 * r >= abs(den)))


class Tables:
    """The host tables, each column moved to ``device`` once, on first
    use."""

    def __init__(self, host: Dict[str, Dict[str, object]], device="cpu",
                 low_precision: bool = False):
        self.host = host
        self.device = torch.device(device)
        self.low = low_precision
        self._dev: Dict[tuple, torch.Tensor] = {}

    def col(self, table: str, name: str):
        return self.host[table][name]

    def v(self, table: str, name: str) -> torch.Tensor:
        """Values (codes of a dictionary column) on the device."""
        key = (table, name)
        if key not in self._dev:
            self._dev[key] = torch.from_numpy(
                self.col(table, name).values).to(self.device)
        return self._dev[key]

    def bytes(self, table: str, name: str):
        key = (table, name, "lengths")
        if key not in self._dev:
            self._dev[key] = torch.from_numpy(
                self.col(table, name).lengths).to(self.device)
        return self.v(table, name), self._dev[key]

    def where(self, table: str, name: str, pred) -> torch.Tensor:
        """bool per row: ``pred(string)`` of a dictionary column, decided
        once per dictionary entry."""
        c = self.col(table, name)
        hit = torch.tensor([bool(pred(str(x))) for x in c.dictionary],
                           device=self.device)
        return hit[self.v(table, name).long()]

    def strs(self, table: str, name: str, rows) -> List[str]:
        """Python strings of the given rows of a string column."""
        c = self.col(table, name)
        rows = _np(rows)
        if c.kind == "dict":
            return [str(c.dictionary[k]) for k in c.values[rows]]
        vals, lens = c.values[rows], c.lengths[rows]
        return [bytes(vals[i, :lens[i]]).decode("ascii")
                for i in range(rows.shape[0])]

    # ---- decimal arithmetic: exact, or float64 in the control
    def sum(self, a: torch.Tensor) -> int:
        """Σ of an int64 tensor as a Python int."""
        if self.low:
            return int(round(float(a.to(torch.float64).sum())))
        a = a.to(torch.int64)
        return (int((a >> 32).sum()) << 32) + int((a & 0xFFFFFFFF).sum())

    def div(self, num: int, den: int) -> int:
        if self.low:
            return int(round(num / den))
        return div_half_up(num, den)

    def group_sum(self, keys: torch.Tensor, vals: torch.Tensor):
        """(distinct keys ascending, sum of ``vals`` per key)."""
        uk, inv = torch.unique(keys, return_inverse=True)
        if self.low:
            s = torch.zeros(uk.shape[0], dtype=torch.float64,
                            device=keys.device)
            s.index_add_(0, inv, vals.to(torch.float64))
            return uk, torch.round(s).to(torch.int64)
        s = torch.zeros(uk.shape[0], dtype=torch.int64, device=keys.device)
        s.index_add_(0, inv, vals.to(torch.int64))
        return uk, s


def _np(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _py(a) -> list:
    return _np(a).tolist()


def _rows(cols: dict, order) -> dict:
    return {k: [v[i] for i in order] for k, v in cols.items()}


def lookup(keys: torch.Tensor, probe: torch.Tensor):
    """(row of each probe in ``keys``, found) for unique ``keys``."""
    order = torch.argsort(keys, stable=True)
    sk = keys[order]
    pos = torch.searchsorted(sk, probe).clamp(max=max(keys.shape[0] - 1, 0))
    row = order[pos]
    return row, keys[row] == probe


def lexsort(keys) -> torch.Tensor:
    """numpy's ``lexsort``: the last key is the primary one."""
    order = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def pair_key(a: torch.Tensor, b: torch.Tensor, b_max: int) -> torch.Tensor:
    """One int64 per (a, b) pair of non-negative keys, b <= b_max."""
    return a.to(torch.int64) * (b_max + 1) + b


def distinct_per(key: torch.Tensor, other: torch.Tensor):
    """(distinct keys, number of distinct ``other`` values per key)."""
    m = int(other.max()) + 1 if other.shape[0] else 1
    pairs = torch.unique(key * m + other)
    return torch.unique(pairs // m, return_counts=True)


def year(d: torch.Tensor) -> torch.Tensor:
    """Civil year of days since 1970-01-01 (days_from_civil, inverted)."""
    z = d.to(torch.int64) + 719468
    era = torch.div(z, 146097, rounding_mode="floor")
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    month = torch.where(mp < 10, mp + 3, mp - 9)
    return yoe + era * 400 + (month <= 2).to(torch.int64)


def like_in_order(values: torch.Tensor, lengths: torch.Tensor, segs,
                  anchored_start: bool = False, rows: int = 1 << 21):
    """bool per row of a byte matrix: LIKE ``'%seg1%seg2%...%'``, each
    segment found after the end of the one before; ``anchored_start``
    makes it ``'seg1%seg2%...%'``. Rows in blocks, so that the match
    matrix stays small."""
    out = []
    for lo in range(0, values.shape[0], rows):
        v = values[lo:lo + rows].long()
        ln = lengths[lo:lo + rows].long()
        n, w = v.shape
        pos = torch.zeros(n, dtype=torch.int64, device=v.device)
        ok = torch.ones(n, dtype=torch.bool, device=v.device)
        for i, seg in enumerate(segs):
            s = torch.tensor(list(seg.encode("ascii")), dtype=torch.int64,
                             device=v.device)
            L = s.shape[0]
            if L > w:
                ok = torch.zeros_like(ok)
                break
            hit = torch.ones((n, w - L + 1), dtype=torch.bool,
                             device=v.device)
            for k in range(L):
                hit &= v[:, k:w - L + 1 + k] == s[k]
            start = torch.arange(w - L + 1, device=v.device)[None, :]
            hit &= (start >= pos[:, None]) & (start + L <= ln[:, None])
            if anchored_start and i == 0:
                hit &= start == 0
            found = hit.any(dim=1)
            first = torch.argmax(hit.to(torch.int8), dim=1)
            ok &= found
            pos = first + L
        out.append(ok)
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.bool,
                                                  device=values.device)


def nation_key(t: Tables, name: str) -> int:
    rows = torch.nonzero(t.where("nation", "n_name",
                                 lambda s: s == name)).flatten()
    return int(t.v("nation", "n_nationkey")[rows[0]])


def _revenue(t: Tables, rows: torch.Tensor) -> torch.Tensor:
    """l_extendedprice * (1 - l_discount) of lineitem rows, at scale 4."""
    return t.v("lineitem", "l_extendedprice")[rows] * \
        (100 - t.v("lineitem", "l_discount")[rows])


def _flat(mask: torch.Tensor) -> torch.Tensor:
    return torch.nonzero(mask).flatten()


# ---------------------------------------------------------------- queries

def q1(t: Tables, p: dict) -> dict:
    m = t.v("lineitem", "l_shipdate") <= days("1998-12-01") - p["DELTA"]
    rf, ls = t.col("lineitem", "l_returnflag"), t.col("lineitem",
                                                      "l_linestatus")
    rf_d, ls_d = rf.dictionary, ls.dictionary
    gid = t.v("lineitem", "l_returnflag")[m].long() * len(ls_d) \
        + t.v("lineitem", "l_linestatus")[m].long()
    ep, disc = t.v("lineitem", "l_extendedprice")[m], \
        t.v("lineitem", "l_discount")[m]
    disc_price = ep * (100 - disc)
    fields = {"sum_qty": t.v("lineitem", "l_quantity")[m],
              "sum_base_price": ep, "sum_disc_price": disc_price,
              "sum_charge": disc_price * (100 + t.v("lineitem", "l_tax")[m]),
              "disc": disc}
    groups = sorted(torch.unique(gid).tolist(),
                    key=lambda g: (str(rf_d[g // len(ls_d)]),
                                   str(ls_d[g % len(ls_d)])))
    out = {k: [] for k in ("l_returnflag", "l_linestatus", "sum_qty",
                           "sum_base_price", "sum_disc_price", "sum_charge",
                           "avg_qty", "avg_price", "avg_disc", "count_order")}
    for g in groups:
        sel = gid == g
        cnt = int(sel.sum())
        s = {k: t.sum(v[sel]) for k, v in fields.items()}
        out["l_returnflag"].append(str(rf_d[g // len(ls_d)]))
        out["l_linestatus"].append(str(ls_d[g % len(ls_d)]))
        for k in ("sum_qty", "sum_base_price", "sum_disc_price",
                  "sum_charge"):
            out[k].append(s[k])
        out["avg_qty"].append(t.div(s["sum_qty"], cnt))
        out["avg_price"].append(t.div(s["sum_base_price"], cnt))
        out["avg_disc"].append(t.div(s["disc"], cnt))
        out["count_order"].append(cnt)
    return out


def q2(t: Tables, p: dict) -> dict:
    regions = _flat(t.where("region", "r_name", lambda s: s == p["REGION"]))
    rkey = t.v("region", "r_regionkey")[regions]
    nkey = t.v("nation", "n_nationkey")
    in_region = torch.isin(t.v("nation", "n_regionkey"), rkey)
    skey = t.v("supplier", "s_suppkey")
    srow_nation, _ = lookup(nkey, t.v("supplier", "s_nationkey"))
    s_in = in_region[srow_nation]
    ps_part, ps_supp = t.v("partsupp", "ps_partkey"), \
        t.v("partsupp", "ps_suppkey")
    cost = t.v("partsupp", "ps_supplycost")
    srow, sfound = lookup(skey, ps_supp)
    ps_in = sfound & s_in[srow]
    # min(ps_supplycost) over the region's suppliers of each part
    mkeys, mcost = ps_part[ps_in], cost[ps_in]
    order = lexsort((mcost, mkeys))
    sk, sc = mkeys[order], mcost[order]
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    min_part, min_cost = sk[first], sc[first]
    pkey = t.v("part", "p_partkey")
    p_ok = (t.v("part", "p_size") == p["SIZE"]) & t.where(
        "part", "p_type", lambda s: s.endswith(p["TYPE"]))
    prow, _ = lookup(pkey, ps_part)
    mrow, mfound = lookup(min_part, ps_part)
    keep = _flat(ps_in & p_ok[prow] & mfound & (cost == min_cost[mrow]))
    s_r, p_r = srow[keep], prow[keep]
    n_r = srow_nation[s_r]
    cols = {"s_acctbal": _py(t.v("supplier", "s_acctbal")[s_r]),
            "s_name": t.strs("supplier", "s_name", s_r),
            "n_name": t.strs("nation", "n_name", n_r),
            "p_partkey": _py(pkey[p_r]),
            "p_mfgr": t.strs("part", "p_mfgr", p_r),
            "s_address": t.strs("supplier", "s_address", s_r),
            "s_phone": t.strs("supplier", "s_phone", s_r),
            "s_comment": t.strs("supplier", "s_comment", s_r)}
    order = sorted(range(keep.shape[0]), key=lambda i: (
        -cols["s_acctbal"][i], cols["n_name"][i], cols["s_name"][i],
        cols["p_partkey"][i]))[:100]
    return _rows(cols, order)


def q3(t: Tables, p: dict) -> dict:
    cutoff = days(p["DATE"])
    seg = t.where("customer", "c_mktsegment", lambda s: s == p["SEGMENT"])
    crow, _ = lookup(t.v("customer", "c_custkey"), t.v("orders", "o_custkey"))
    o_ok = (t.v("orders", "o_orderdate") < cutoff) & seg[crow]
    okey = t.v("orders", "o_orderkey")
    orow, ofound = lookup(okey, t.v("lineitem", "l_orderkey"))
    li = _flat((t.v("lineitem", "l_shipdate") > cutoff) & ofound
               & o_ok[orow])
    keys, rev = t.group_sum(t.v("lineitem", "l_orderkey")[li],
                            _revenue(t, li))
    grow, _ = lookup(okey, keys)
    date = t.v("orders", "o_orderdate")[grow]
    order = lexsort((date, -rev))[:10]
    return {"l_orderkey": _py(keys[order]), "revenue": _py(rev[order]),
            "o_orderdate": _py(date[order]),
            "o_shippriority": _py(t.v("orders", "o_shippriority")[grow][order])}


def q4(t: Tables, p: dict) -> dict:
    lo, hi = days(p["DATE"]), add_months(p["DATE"], 3)
    late = t.v("lineitem", "l_commitdate") < t.v("lineitem", "l_receiptdate")
    late_orders = torch.unique(t.v("lineitem", "l_orderkey")[late])
    odate = t.v("orders", "o_orderdate")
    o_ok = (odate >= lo) & (odate < hi) & torch.isin(
        t.v("orders", "o_orderkey"), late_orders)
    prio = t.col("orders", "o_orderpriority")
    codes, counts = torch.unique(t.v("orders", "o_orderpriority")[o_ok],
                                 return_counts=True)
    names = [str(prio.dictionary[c]) for c in _py(codes)]
    counts = _py(counts)
    order = sorted(range(len(names)), key=lambda i: names[i])
    return {"o_orderpriority": [names[i] for i in order],
            "order_count": [counts[i] for i in order]}


def q5(t: Tables, p: dict) -> dict:
    lo, hi = days(p["DATE"]), add_months(p["DATE"], 12)
    region = t.where("region", "r_name", lambda s: s == p["REGION"])
    rrow, _ = lookup(t.v("region", "r_regionkey"),
                     t.v("nation", "n_regionkey"))
    n_in = region[rrow]
    nkey = t.v("nation", "n_nationkey")
    s_nation = t.v("supplier", "s_nationkey")
    c_nation = t.v("customer", "c_nationkey")
    srow, _ = lookup(t.v("supplier", "s_suppkey"),
                     t.v("lineitem", "l_suppkey"))
    orow, ofound = lookup(t.v("orders", "o_orderkey"),
                          t.v("lineitem", "l_orderkey"))
    odate = t.v("orders", "o_orderdate")
    crow, _ = lookup(t.v("customer", "c_custkey"), t.v("orders", "o_custkey"))
    ln = s_nation[srow]
    lnrow, _ = lookup(nkey, ln)
    li = _flat(ofound & (odate[orow] >= lo) & (odate[orow] < hi)
               & (c_nation[crow[orow]] == ln) & n_in[lnrow])
    keys, rev = t.group_sum(ln[li], _revenue(t, li))
    nrow, _ = lookup(nkey, keys)
    order = torch.argsort(-rev, stable=True)
    return {"n_name": t.strs("nation", "n_name", nrow[order]),
            "revenue": _py(rev[order])}


def q6(t: Tables, p: dict) -> dict:
    lo = days(p["DATE"])
    hi = add_months(p["DATE"], 12)
    ship, disc = t.v("lineitem", "l_shipdate"), t.v("lineitem", "l_discount")
    m = ((ship >= lo) & (ship < hi) & (disc >= p["DISCOUNT"] - 1)
         & (disc <= p["DISCOUNT"] + 1)
         & (t.v("lineitem", "l_quantity") < p["QUANTITY"] * 100))
    ep = t.v("lineitem", "l_extendedprice")
    return {"revenue": [t.sum(ep[m] * disc[m]) if bool(m.any()) else None]}


def q7(t: Tables, p: dict) -> dict:
    ship = t.v("lineitem", "l_shipdate")
    srow, _ = lookup(t.v("supplier", "s_suppkey"),
                     t.v("lineitem", "l_suppkey"))
    orow, _ = lookup(t.v("orders", "o_orderkey"),
                     t.v("lineitem", "l_orderkey"))
    crow, _ = lookup(t.v("customer", "c_custkey"), t.v("orders", "o_custkey"))
    sn = t.v("supplier", "s_nationkey")[srow]
    cn = t.v("customer", "c_nationkey")[crow[orow]]
    a, b = (nation_key(t, n) for n in p["NATION"])
    li = _flat((ship >= days("1995-01-01")) & (ship <= days("1996-12-31"))
               & (((sn == a) & (cn == b)) | ((sn == b) & (cn == a))))
    yr = year(ship[li])
    keys, rev = t.group_sum(pair_key(sn[li] * 25 + cn[li], yr, 9999),
                            _revenue(t, li))
    nrow, _ = lookup(t.v("nation", "n_nationkey"),
                     torch.arange(25, device=t.device))
    names = t.strs("nation", "n_name", nrow)
    nations, years = _py(keys // 10000), _py(keys % 10000)
    cols = {"supp_nation": [names[n // 25] for n in nations],
            "cust_nation": [names[n % 25] for n in nations],
            "l_year": years, "revenue": _py(rev)}
    order = sorted(range(len(years)), key=lambda i: (
        cols["supp_nation"][i], cols["cust_nation"][i], years[i]))
    return _rows(cols, order)


def q8(t: Tables, p: dict) -> dict:
    p_ok = t.where("part", "p_type", lambda s: s == p["TYPE"])
    prow, _ = lookup(t.v("part", "p_partkey"), t.v("lineitem", "l_partkey"))
    orow, _ = lookup(t.v("orders", "o_orderkey"),
                     t.v("lineitem", "l_orderkey"))
    crow, _ = lookup(t.v("customer", "c_custkey"), t.v("orders", "o_custkey"))
    srow, _ = lookup(t.v("supplier", "s_suppkey"),
                     t.v("lineitem", "l_suppkey"))
    odate = t.v("orders", "o_orderdate")[orow]
    region = _flat(t.where("region", "r_name", lambda s: s == p["REGION"]))
    nrow, _ = lookup(t.v("nation", "n_nationkey"),
                     t.v("customer", "c_nationkey")[crow[orow]])
    in_region = t.v("nation", "n_regionkey")[nrow] == \
        t.v("region", "r_regionkey")[region[0]]
    li = _flat(p_ok[prow] & in_region & (odate >= days("1995-01-01"))
               & (odate <= days("1996-12-31")))
    vol = _revenue(t, li)
    mine = t.v("supplier", "s_nationkey")[srow[li]] == \
        nation_key(t, p["NATION"])
    years, den = t.group_sum(year(odate[li]), vol)
    _, num = t.group_sum(year(odate[li]), torch.where(mine, vol, 0))
    # decimal(38,4) / decimal(38,4) at scale 4, HALF_UP
    return {"o_year": _py(years),
            "mkt_share": [t.div(a * 10**4, b)
                          for a, b in zip(_py(num), _py(den))]}


def q9(t: Tables, p: dict) -> dict:
    pv, pl = t.bytes("part", "p_name")
    colored = like_in_order(pv, pl, (p["COLOR"],))
    lpart, lsupp = t.v("lineitem", "l_partkey"), t.v("lineitem", "l_suppkey")
    prow, _ = lookup(t.v("part", "p_partkey"), lpart)
    li = _flat(colored[prow])
    smax = int(t.v("supplier", "s_suppkey").max())
    psrow, _ = lookup(pair_key(t.v("partsupp", "ps_partkey"),
                               t.v("partsupp", "ps_suppkey"), smax),
                      pair_key(lpart[li], lsupp[li], smax))
    amount = _revenue(t, li) - t.v("partsupp", "ps_supplycost")[psrow] \
        * t.v("lineitem", "l_quantity")[li]
    orow, _ = lookup(t.v("orders", "o_orderkey"),
                     t.v("lineitem", "l_orderkey")[li])
    srow, _ = lookup(t.v("supplier", "s_suppkey"), lsupp[li])
    nation = t.v("supplier", "s_nationkey")[srow]
    keys, profit = t.group_sum(
        pair_key(nation, year(t.v("orders", "o_orderdate")[orow]), 9999),
        amount)
    nrow, _ = lookup(t.v("nation", "n_nationkey"), keys // 10000)
    names = t.strs("nation", "n_name", nrow)
    years = _py(keys % 10000)
    order = sorted(range(len(years)), key=lambda i: (names[i], -years[i]))
    return _rows({"nation": names, "o_year": years,
                  "sum_profit": _py(profit)}, order)


def q10(t: Tables, p: dict) -> dict:
    lo, hi = days(p["DATE"]), add_months(p["DATE"], 3)
    odate = t.v("orders", "o_orderdate")
    orow, ofound = lookup(t.v("orders", "o_orderkey"),
                          t.v("lineitem", "l_orderkey"))
    ret = t.where("lineitem", "l_returnflag", lambda s: s == "R")
    li = _flat(ret & ofound & (odate[orow] >= lo) & (odate[orow] < hi))
    cust = t.v("orders", "o_custkey")[orow[li]]
    keys, rev = t.group_sum(cust, _revenue(t, li))
    order = torch.argsort(-rev, stable=True)[:20]
    crow, _ = lookup(t.v("customer", "c_custkey"), keys[order])
    nrow, _ = lookup(t.v("nation", "n_nationkey"),
                     t.v("customer", "c_nationkey")[crow])
    return {"c_custkey": _py(keys[order]),
            "c_name": t.strs("customer", "c_name", crow),
            "revenue": _py(rev[order]),
            "c_acctbal": _py(t.v("customer", "c_acctbal")[crow]),
            "n_name": t.strs("nation", "n_name", nrow),
            "c_address": t.strs("customer", "c_address", crow),
            "c_phone": t.strs("customer", "c_phone", crow),
            "c_comment": t.strs("customer", "c_comment", crow)}


def q11(t: Tables, p: dict) -> dict:
    srow, _ = lookup(t.v("supplier", "s_suppkey"),
                     t.v("partsupp", "ps_suppkey"))
    rows = _flat(t.v("supplier", "s_nationkey")[srow]
                 == nation_key(t, p["NATION"]))
    v = t.v("partsupp", "ps_supplycost")[rows] \
        * t.v("partsupp", "ps_availqty")[rows]
    total = t.sum(v)
    keys, value = t.group_sum(t.v("partsupp", "ps_partkey")[rows], v)
    # sum (scale 2) > total * FRACTION (scale 2 + FRACTION's scale)
    digits, unscaled = p["FRACTION"]
    keep = _flat(value * 10**digits > total * unscaled)
    order = keep[lexsort((keys[keep], -value[keep]))]
    return {"ps_partkey": _py(keys[order]), "value": _py(value[order])}


def q12(t: Tables, p: dict) -> dict:
    lo, hi = days(p["DATE"]), add_months(p["DATE"], 12)
    commit = t.v("lineitem", "l_commitdate")
    receipt = t.v("lineitem", "l_receiptdate")
    mode = t.col("lineitem", "l_shipmode")
    modes = tuple(p["SHIPMODE"])
    mode_ok = t.where("lineitem", "l_shipmode", lambda s: s in modes)
    li = _flat(mode_ok & (commit < receipt)
               & (t.v("lineitem", "l_shipdate") < commit)
               & (receipt >= lo) & (receipt < hi))
    orow, _ = lookup(t.v("orders", "o_orderkey"),
                     t.v("lineitem", "l_orderkey")[li])
    high = t.where("orders", "o_orderpriority",
                   lambda s: s in ("1-URGENT", "2-HIGH"))[orow]
    codes = t.v("lineitem", "l_shipmode")[li]
    out = {"l_shipmode": [], "high_line_count": [], "low_line_count": []}
    for code in sorted(torch.unique(codes).tolist(),
                       key=lambda c: str(mode.dictionary[c])):
        sel = codes == code
        out["l_shipmode"].append(str(mode.dictionary[code]))
        out["high_line_count"].append(int((sel & high).sum()))
        out["low_line_count"].append(int((sel & ~high).sum()))
    return out


def q13(t: Tables, p: dict) -> dict:
    ov, ol = t.bytes("orders", "o_comment")
    special = like_in_order(ov, ol, (p["WORD1"], p["WORD2"]))
    ckey = t.v("customer", "c_custkey")
    per_cust = torch.bincount(t.v("orders", "o_custkey")[~special],
                              minlength=int(ckey.max()) + 1)
    counts, custdist = torch.unique(per_cust[ckey], return_counts=True)
    order = lexsort((-counts, -custdist))
    return {"c_count": _py(counts[order]), "custdist": _py(custdist[order])}


def q14(t: Tables, p: dict) -> dict:
    lo, hi = days(p["DATE"]), add_months(p["DATE"], 1)
    ship = t.v("lineitem", "l_shipdate")
    m = _flat((ship >= lo) & (ship < hi))
    row, _ = lookup(t.v("part", "p_partkey"), t.v("lineitem", "l_partkey")[m])
    promo = t.where("part", "p_type", lambda s: s.startswith("PROMO"))[row]
    rev = _revenue(t, m)
    # 100.00 * (scale 4) / (scale 4), at scale 6
    return {"promo_revenue": [t.div(
        10000 * t.sum(rev[promo]) * 10**4, t.sum(rev))]}


def q15(t: Tables, p: dict) -> dict:
    lo, hi = days(p["DATE"]), add_months(p["DATE"], 3)
    ship = t.v("lineitem", "l_shipdate")
    li = _flat((ship >= lo) & (ship < hi))
    keys, rev = t.group_sum(t.v("lineitem", "l_suppkey")[li],
                            _revenue(t, li))
    top = _flat(rev == rev.max())  # keys ascending
    srow, _ = lookup(t.v("supplier", "s_suppkey"), keys[top])
    return {"s_suppkey": _py(keys[top]),
            "s_name": t.strs("supplier", "s_name", srow),
            "s_address": t.strs("supplier", "s_address", srow),
            "s_phone": t.strs("supplier", "s_phone", srow),
            "total_revenue": _py(rev[top])}


def q16(t: Tables, p: dict) -> dict:
    sv, sl = t.bytes("supplier", "s_comment")
    complaints = like_in_order(sv, sl, ("Customer", "Complaints"))
    bad = t.v("supplier", "s_suppkey")[complaints]
    size = t.v("part", "p_size")
    sizes = torch.tensor(p["SIZE"], dtype=torch.int64, device=t.device)
    p_ok = (t.where("part", "p_brand", lambda s: s != p["BRAND"])
            & ~t.where("part", "p_type", lambda s: s.startswith(p["TYPE"]))
            & torch.isin(size, sizes))
    supp = t.v("partsupp", "ps_suppkey")
    prow, _ = lookup(t.v("part", "p_partkey"), t.v("partsupp", "ps_partkey"))
    rows = _flat(p_ok[prow] & ~torch.isin(supp, bad))
    brand, ptype = t.col("part", "p_brand"), t.col("part", "p_type")
    smax = int(size.max())
    nt = len(ptype.dictionary)
    group = pair_key(pair_key(t.v("part", "p_brand")[prow[rows]],
                              t.v("part", "p_type")[prow[rows]], nt),
                     size[prow[rows]], smax)
    groups, cnt = distinct_per(group, supp[rows])
    bt, sizes_out = _py(groups // (smax + 1)), _py(groups % (smax + 1))
    cnt = _py(cnt)
    cols = {"p_brand": [str(brand.dictionary[c // (nt + 1)]) for c in bt],
            "p_type": [str(ptype.dictionary[c % (nt + 1)]) for c in bt],
            "p_size": sizes_out, "supplier_cnt": cnt}
    order = sorted(range(len(cnt)), key=lambda i: (
        -cnt[i], cols["p_brand"][i], cols["p_type"][i], sizes_out[i]))
    return _rows(cols, order)


def q17(t: Tables, p: dict) -> dict:
    part = t.v("lineitem", "l_partkey")
    qty = t.v("lineitem", "l_quantity")
    keys, qsum = t.group_sum(part, qty)
    _, qcnt = t.group_sum(part, torch.ones_like(qty))
    if t.low:
        avg = torch.round(qsum.double() / qcnt.double()).to(torch.int64)
    else:  # scale 2, HALF_UP (sums and counts are positive)
        avg = (2 * qsum + qcnt) // (2 * qcnt)
    p_ok = t.where("part", "p_brand", lambda s: s == p["BRAND"]) & t.where(
        "part", "p_container", lambda s: s == p["CONTAINER"])
    prow, pfound = lookup(t.v("part", "p_partkey"), part)
    arow, _ = lookup(keys, part)
    # l_quantity (scale 2) < 0.2 (scale 1) * avg (scale 2), at scale 3
    keep = pfound & p_ok[prow] & (qty * 10 < 2 * avg[arow])
    total = t.sum(t.v("lineitem", "l_extendedprice")[keep])
    # sum (scale 2) / 7.0 (scale 1) at scale 2
    return {"avg_yearly": [t.div(total * 10, 70) if bool(keep.any())
                           else None]}


def q18(t: Tables, p: dict) -> dict:
    threshold = p["QUANTITY"] * 100  # sum(l_quantity) > QUANTITY, unscaled
    lkey = t.v("lineitem", "l_orderkey")
    keys, qsum = t.group_sum(lkey, t.v("lineitem", "l_quantity"))
    big, bsum = keys[qsum > threshold], qsum[qsum > threshold]
    orow, _ = lookup(t.v("orders", "o_orderkey"), big)
    crow, _ = lookup(t.v("customer", "c_custkey"),
                     t.v("orders", "o_custkey")[orow])
    price = t.v("orders", "o_totalprice")[orow]
    date = t.v("orders", "o_orderdate")[orow]
    order = lexsort((date, -price))[:100]
    return {"c_name": t.strs("customer", "c_name", crow[order]),
            "c_custkey": _py(t.v("customer", "c_custkey")[crow][order]),
            "o_orderkey": _py(big[order]), "o_orderdate": _py(date[order]),
            "o_totalprice": _py(price[order]), "_col5": _py(bsum[order])}


def q19(t: Tables, p: dict) -> dict:
    prow, _ = lookup(t.v("part", "p_partkey"), t.v("lineitem", "l_partkey"))
    qty = t.v("lineitem", "l_quantity")
    size = t.v("part", "p_size")[prow]
    base = t.where("lineitem", "l_shipmode",
                   lambda s: s in ("AIR", "AIR REG")) & t.where(
        "lineitem", "l_shipinstruct", lambda s: s == "DELIVER IN PERSON")
    keep = torch.zeros(qty.shape[0], dtype=torch.bool, device=t.device)
    for brand, containers, q_lo, max_size in (
            (p["BRAND"][0], ("SM CASE", "SM BOX", "SM PACK", "SM PKG"),
             p["QUANTITY1"], 5),
            (p["BRAND"][1], ("MED BAG", "MED BOX", "MED PKG", "MED PACK"),
             p["QUANTITY2"], 10),
            (p["BRAND"][2], ("LG CASE", "LG BOX", "LG PACK", "LG PKG"),
             p["QUANTITY3"], 15)):
        part_ok = t.where("part", "p_brand", lambda s: s == brand) \
            & t.where("part", "p_container", lambda s: s in containers)
        keep |= (part_ok[prow] & (qty >= q_lo * 100)
                 & (qty <= (q_lo + 10) * 100) & (size >= 1)
                 & (size <= max_size))
    li = _flat(base & keep)
    return {"revenue": [t.sum(_revenue(t, li)) if li.numel() else None]}


def q20(t: Tables, p: dict) -> dict:
    pv, pl = t.bytes("part", "p_name")
    colored = like_in_order(pv, pl, (p["COLOR"],), anchored_start=True)
    smax = int(t.v("supplier", "s_suppkey").max())
    lo, hi = days(p["DATE"]), add_months(p["DATE"], 12)
    ship = t.v("lineitem", "l_shipdate")
    li = _flat((ship >= lo) & (ship < hi))
    keys, qsum = t.group_sum(pair_key(t.v("lineitem", "l_partkey")[li],
                                      t.v("lineitem", "l_suppkey")[li], smax),
                             t.v("lineitem", "l_quantity")[li])
    ps_part, ps_supp = t.v("partsupp", "ps_partkey"), \
        t.v("partsupp", "ps_suppkey")
    ps = _flat(torch.isin(ps_part, t.v("part", "p_partkey")[colored]))
    qrow, found = lookup(keys, pair_key(ps_part[ps], ps_supp[ps], smax))
    # ps_availqty > 0.5 * sum(l_quantity): at scale 3, availqty * 1000 >
    # 5 * sum (scale 2); no lineitem row gives NULL, which drops the row
    avail = t.v("partsupp", "ps_availqty")[ps]
    supp = torch.unique(ps_supp[ps][found & (avail * 200 > qsum[qrow])])
    srow = _flat(torch.isin(t.v("supplier", "s_suppkey"), supp)
                 & (t.v("supplier", "s_nationkey")
                    == nation_key(t, p["NATION"])))
    names = t.strs("supplier", "s_name", srow)
    order = sorted(range(len(names)), key=lambda i: names[i])
    return _rows({"s_name": names,
                  "s_address": t.strs("supplier", "s_address", srow)},
                 order)


def q21(t: Tables, p: dict) -> dict:
    lkey, lsupp = t.v("lineitem", "l_orderkey"), t.v("lineitem", "l_suppkey")
    late = t.v("lineitem", "l_receiptdate") > t.v("lineitem", "l_commitdate")
    okeys, n_supp = distinct_per(lkey, lsupp)
    lkeys, n_late_supp = distinct_per(lkey[late], lsupp[late])
    status_f = t.where("orders", "o_orderstatus", lambda s: s == "F")
    orow, ofound = lookup(t.v("orders", "o_orderkey"), lkey)
    srow, _ = lookup(t.v("supplier", "s_suppkey"), lsupp)
    nation = t.where("nation", "n_name", lambda s: s == p["NATION"])
    nrow, _ = lookup(t.v("nation", "n_nationkey"),
                     t.v("supplier", "s_nationkey")[srow])
    arow, _ = lookup(okeys, lkey)
    brow, bfound = lookup(lkeys, lkey)
    # exists l2 of another supplier: the order has > 1 supplier; not exists
    # a late l3 of another supplier: l1's supplier is the order's only late
    # one (l1 is late itself)
    keep = (late & ofound & status_f[orow] & nation[nrow]
            & (n_supp[arow] > 1) & bfound & (n_late_supp[brow] == 1))
    supp, cnt = torch.unique(srow[keep], return_counts=True)
    names = t.strs("supplier", "s_name", supp)
    cnt = _py(cnt)
    order = sorted(range(len(cnt)), key=lambda i: (-cnt[i], names[i]))[:100]
    return {"s_name": [names[i] for i in order],
            "numwait": [cnt[i] for i in order]}


def q22(t: Tables, p: dict) -> dict:
    codes = [str(c) for c in p["I"]]
    phone, _ = t.bytes("customer", "c_phone")
    cc = (phone[:, 0].long() - 48) * 10 + (phone[:, 1].long() - 48)
    sel = torch.isin(cc, torch.tensor([int(c) for c in codes],
                                      device=t.device))
    bal = t.v("customer", "c_acctbal")
    pos = sel & (bal > 0)
    avg = t.div(t.sum(bal[pos]), int(pos.sum()))  # scale 2
    has_orders = torch.isin(t.v("customer", "c_custkey"),
                            t.v("orders", "o_custkey"))
    rows = sel & (bal > avg) & ~has_orders
    out = {"cntrycode": [], "numcust": [], "totacctbal": []}
    for code in sorted(set(_py(cc[rows]))):
        r = rows & (cc == code)
        out["cntrycode"].append(f"{code:02d}")
        out["numcust"].append(int(r.sum()))
        out["totacctbal"].append(t.sum(bal[r]))
    return out


QUERIES = {1: q1, 2: q2, 3: q3, 4: q4, 5: q5, 6: q6, 7: q7, 8: q8, 9: q9,
           10: q10, 11: q11, 12: q12, 13: q13, 14: q14, 15: q15, 16: q16,
           17: q17, 18: q18, 19: q19, 20: q20, 21: q21, 22: q22}


def answer(t: Tables, query, params: dict):
    """(column names, rows as tuples) of one query (its number, or the
    statement set's name for it) under ``params``."""
    cols = QUERIES[int(query)](t, params)
    names = list(cols)
    return names, list(zip(*[cols[n] for n in names]))
