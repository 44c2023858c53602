"""All 22 TPC-H queries and a BIGINT sum in numpy, over the host tables
of ``presto_tpu_torch``'s data source (``DataSource.read_host``).

An oracle independent of the engine: no pandas, no torch, no engine code,
only the generated host columns and numpy.  Decimals stay unscaled
integers with exact int64 sums; a division rounds half away from zero, as
the engine's decimals do.  LIKE is Python's own ``str.find`` and
``str.startswith``; years come from numpy's calendar.  Each function
returns the result as the engine's ``{column: col.to_pylist()}``, rows in
the query's order.

    import np_tpch_oracle as NO          # with tools/ on sys.path
    want = NO.oracle(runner.datasource, ("q3", "q18"))

``chip_smoke.py`` holds the port's results on the card to it at SF1 and
its streamed aggregations to the ``STREAMED`` functions at SF10 (sums in
Python ints, ``approx_distinct`` through a numpy copy of the engine's
hash and HLL registers); ``tests/test_torch_joins.py`` holds it to
``tests/tpch_oracle.py`` at SF0.01.
"""

from __future__ import annotations

import datetime as dt
import math

import numpy as np


def days(iso: str) -> int:
    return (dt.date.fromisoformat(iso) - dt.date(1970, 1, 1)).days


def div_half_up(num: int, den: int) -> int:
    sign = -1 if (num < 0) != (den < 0) else 1
    q, r = divmod(abs(num), abs(den))
    return sign * (q + (2 * r >= abs(den)))


class Tables:
    """Host columns read once per (table, column) from a data source."""

    def __init__(self, ds):
        self.ds = ds
        self.cols = {}

    def preload(self, table: str, names) -> None:
        """Read several columns of ``table`` in one pass of the
        generator."""
        missing = [n for n in names if (table, n) not in self.cols]
        if missing:
            for n, c in self.ds.read_host(table, missing).items():
                self.cols[(table, n)] = c

    def col(self, table: str, name: str):
        if (table, name) not in self.cols:
            self.cols[(table, name)] = self.ds.read_host(table, (name,))[name]
        return self.cols[(table, name)]

    def v(self, table: str, name: str) -> np.ndarray:
        """Values (codes of a dictionary column)."""
        return np.asarray(self.col(table, name).values)

    def s(self, table: str, name: str) -> np.ndarray:
        """Python strings of a string column (object array)."""
        return np.array(self.col(table, name).to_pylist(), dtype=object)

    def where(self, table: str, name: str, pred) -> np.ndarray:
        """bool per row: ``pred(string)`` of a dictionary column, decided
        once per dictionary entry."""
        c = self.col(table, name)
        hit = np.array([bool(pred(str(x))) for x in c.dictionary])
        return hit[np.asarray(c.values)]


def exact_sum(a: np.ndarray) -> int:
    """Σ of an int64 array as a Python int: the high and low 32-bit halves
    are summed apart (each partial sum fits int64 under 2^31 rows), so no
    int64 sum can wrap."""
    a = np.asarray(a, np.int64)
    return (int((a >> 32).sum()) << 32) + int((a & 0xFFFFFFFF).sum())


def lookup(keys: np.ndarray, probe: np.ndarray):
    """(row of each probe in ``keys``, found) for unique ``keys``."""
    order = np.argsort(keys, kind="stable")
    pos = np.searchsorted(keys[order], probe)
    pos = np.minimum(pos, max(keys.shape[0] - 1, 0))
    row = order[pos]
    return row, keys[row] == probe


def group_sum(keys: np.ndarray, vals: np.ndarray):
    """(distinct keys ascending, exact int64 sum of ``vals`` per key)."""
    order = np.argsort(keys, kind="stable")
    k = keys[order]
    if k.shape[0] == 0:
        return k, np.zeros(0, np.int64)
    starts = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])
    return k[starts], np.add.reduceat(vals[order].astype(np.int64), starts)


def _rows(cols: dict, order) -> dict:
    return {k: [v[i] for i in order] for k, v in cols.items()}


def _py(a) -> list:
    return [x.item() if hasattr(x, "item") else x for x in a]


def q1(t: Tables) -> dict:
    ship = t.v("lineitem", "l_shipdate")
    m = ship <= days("1998-12-01") - 90
    rf, ls = t.col("lineitem", "l_returnflag"), t.col("lineitem",
                                                      "l_linestatus")
    rf_d, ls_d = rf.dictionary, ls.dictionary
    gid = np.asarray(rf.values)[m].astype(np.int64) * len(ls_d) \
        + np.asarray(ls.values)[m]
    ep, disc = t.v("lineitem", "l_extendedprice")[m], \
        t.v("lineitem", "l_discount")[m]
    disc_price = ep * (100 - disc)
    fields = {"sum_qty": t.v("lineitem", "l_quantity")[m],
              "sum_base_price": ep, "sum_disc_price": disc_price,
              "sum_charge": disc_price * (100 + t.v("lineitem", "l_tax")[m]),
              "disc": disc}
    groups = sorted(np.unique(gid).tolist(),
                    key=lambda g: (str(rf_d[g // len(ls_d)]),
                                   str(ls_d[g % len(ls_d)])))
    out = {k: [] for k in ("l_returnflag", "l_linestatus", "sum_qty",
                           "sum_base_price", "sum_disc_price", "sum_charge",
                           "avg_qty", "avg_price", "avg_disc", "count_order")}
    for g in groups:
        sel = gid == g
        cnt = int(sel.sum())
        s = {k: exact_sum(v[sel]) for k, v in fields.items()}
        out["l_returnflag"].append(str(rf_d[g // len(ls_d)]))
        out["l_linestatus"].append(str(ls_d[g % len(ls_d)]))
        for k in ("sum_qty", "sum_base_price", "sum_disc_price",
                  "sum_charge"):
            out[k].append(s[k])
        out["avg_qty"].append(div_half_up(s["sum_qty"], cnt))
        out["avg_price"].append(div_half_up(s["sum_base_price"], cnt))
        out["avg_disc"].append(div_half_up(s["disc"], cnt))
        out["count_order"].append(cnt)
    return out


def q6(t: Tables) -> dict:
    ship, disc = t.v("lineitem", "l_shipdate"), t.v("lineitem", "l_discount")
    m = ((ship >= days("1994-01-01")) & (ship < days("1995-01-01"))
         & (disc >= 5) & (disc <= 7) & (t.v("lineitem", "l_quantity") < 2400))
    ep = t.v("lineitem", "l_extendedprice")
    return {"revenue": [exact_sum(ep[m] * disc[m])]}


def q14(t: Tables) -> dict:
    ship = t.v("lineitem", "l_shipdate")
    m = (ship >= days("1995-09-01")) & (ship < days("1995-10-01"))
    row, _ = lookup(t.v("part", "p_partkey"), t.v("lineitem", "l_partkey")[m])
    promo = t.where("part", "p_type", lambda s: s.startswith("PROMO"))[row]
    rev = t.v("lineitem", "l_extendedprice")[m] \
        * (100 - t.v("lineitem", "l_discount")[m])
    # 10^8 times an int64 sum: in python ints
    return {"promo_revenue": [div_half_up(
        10000 * int(rev[promo].sum()) * 10**4, int(rev.sum()))]}


def bigint_sum(t: Tables) -> dict:
    m = t.v("lineitem", "l_shipdate") <= days("1998-09-02")
    return {"s": [exact_sum(t.v("lineitem", "l_orderkey")[m])],
            "c": [int(m.sum())]}


def q2(t: Tables) -> dict:
    eur_regions = np.flatnonzero(t.where("region", "r_name",
                                         lambda s: s == "EUROPE"))
    rkey = t.v("region", "r_regionkey")[eur_regions]
    nkey = t.v("nation", "n_nationkey")
    eur_nation = np.isin(t.v("nation", "n_regionkey"), rkey)
    skey = t.v("supplier", "s_suppkey")
    srow_nation, _ = lookup(nkey, t.v("supplier", "s_nationkey"))
    s_eur = eur_nation[srow_nation]
    ps_part, ps_supp = t.v("partsupp", "ps_partkey"), \
        t.v("partsupp", "ps_suppkey")
    cost = t.v("partsupp", "ps_supplycost")
    srow, sfound = lookup(skey, ps_supp)
    ps_eur = sfound & s_eur[srow]
    # min(ps_supplycost) over the European suppliers of each part
    mkeys = ps_part[ps_eur]
    order = np.lexsort((cost[ps_eur], mkeys))
    first = np.r_[True, mkeys[order][1:] != mkeys[order][:-1]]
    min_part, min_cost = mkeys[order][first], cost[ps_eur][order][first]
    pkey = t.v("part", "p_partkey")
    p_ok = (t.v("part", "p_size") == 15) & t.where(
        "part", "p_type", lambda s: s.endswith("BRASS"))
    prow, _ = lookup(pkey, ps_part)
    mrow, mfound = lookup(min_part, ps_part)
    keep = np.flatnonzero(ps_eur & p_ok[prow] & mfound
                          & (cost == min_cost[mrow]))
    s_r, p_r = srow[keep], prow[keep]
    n_r = srow_nation[s_r]
    cols = {"s_acctbal": _py(t.v("supplier", "s_acctbal")[s_r]),
            "s_name": list(t.s("supplier", "s_name")[s_r]),
            "n_name": list(t.s("nation", "n_name")[n_r]),
            "p_partkey": _py(pkey[p_r]),
            "p_mfgr": list(t.s("part", "p_mfgr")[p_r]),
            "s_address": list(t.s("supplier", "s_address")[s_r]),
            "s_phone": list(t.s("supplier", "s_phone")[s_r]),
            "s_comment": list(t.s("supplier", "s_comment")[s_r])}
    order = sorted(range(len(keep)), key=lambda i: (
        -cols["s_acctbal"][i], cols["n_name"][i], cols["s_name"][i],
        cols["p_partkey"][i]))[:100]
    return _rows(cols, order)


def _revenue(t: Tables, rows: np.ndarray) -> np.ndarray:
    """l_extendedprice * (1 - l_discount) of lineitem rows, at scale 4."""
    return t.v("lineitem", "l_extendedprice")[rows] * \
        (100 - t.v("lineitem", "l_discount")[rows])


def q3(t: Tables) -> dict:
    cutoff = days("1995-03-15")
    building = t.where("customer", "c_mktsegment", lambda s: s == "BUILDING")
    crow, _ = lookup(t.v("customer", "c_custkey"), t.v("orders", "o_custkey"))
    o_ok = (t.v("orders", "o_orderdate") < cutoff) & building[crow]
    okey = t.v("orders", "o_orderkey")
    orow, ofound = lookup(okey, t.v("lineitem", "l_orderkey"))
    li = np.flatnonzero((t.v("lineitem", "l_shipdate") > cutoff) & ofound
                        & o_ok[orow])
    keys, rev = group_sum(t.v("lineitem", "l_orderkey")[li], _revenue(t, li))
    grow, _ = lookup(okey, keys)
    date = t.v("orders", "o_orderdate")[grow]
    order = np.lexsort((date, -rev))[:10]
    return {"l_orderkey": _py(keys[order]), "revenue": _py(rev[order]),
            "o_orderdate": _py(date[order]),
            "o_shippriority": _py(t.v("orders", "o_shippriority")[grow][order])}


def q4(t: Tables) -> dict:
    lo, hi = days("1993-07-01"), days("1993-10-01")
    late = t.v("lineitem", "l_commitdate") < t.v("lineitem", "l_receiptdate")
    late_orders = np.unique(t.v("lineitem", "l_orderkey")[late])
    odate = t.v("orders", "o_orderdate")
    o_ok = (odate >= lo) & (odate < hi) & np.isin(t.v("orders", "o_orderkey"),
                                                  late_orders)
    prio = t.col("orders", "o_orderpriority")
    codes, counts = np.unique(np.asarray(prio.values)[o_ok],
                              return_counts=True)
    names = [str(prio.dictionary[c]) for c in codes]
    order = sorted(range(len(names)), key=lambda i: names[i])
    return {"o_orderpriority": [names[i] for i in order],
            "order_count": [int(counts[i]) for i in order]}


def q5(t: Tables) -> dict:
    lo, hi = days("1994-01-01"), days("1995-01-01")
    asia = t.where("region", "r_name", lambda s: s == "ASIA")
    rrow, _ = lookup(t.v("region", "r_regionkey"), t.v("nation", "n_regionkey"))
    n_asia = asia[rrow]
    nkey = t.v("nation", "n_nationkey")
    s_nation = t.v("supplier", "s_nationkey")
    c_nation = t.v("customer", "c_nationkey")
    srow, _ = lookup(t.v("supplier", "s_suppkey"), t.v("lineitem", "l_suppkey"))
    orow, ofound = lookup(t.v("orders", "o_orderkey"),
                          t.v("lineitem", "l_orderkey"))
    odate = t.v("orders", "o_orderdate")
    crow, _ = lookup(t.v("customer", "c_custkey"), t.v("orders", "o_custkey"))
    ln = s_nation[srow]
    lnrow, _ = lookup(nkey, ln)
    li = np.flatnonzero(ofound & (odate[orow] >= lo) & (odate[orow] < hi)
                        & (c_nation[crow[orow]] == ln) & n_asia[lnrow])
    keys, rev = group_sum(ln[li], _revenue(t, li))
    nrow, _ = lookup(nkey, keys)
    names = t.s("nation", "n_name")[nrow]
    order = np.argsort(-rev, kind="stable")
    return {"n_name": list(names[order]), "revenue": _py(rev[order])}


def q10(t: Tables) -> dict:
    lo, hi = days("1993-10-01"), days("1994-01-01")
    odate = t.v("orders", "o_orderdate")
    orow, ofound = lookup(t.v("orders", "o_orderkey"),
                          t.v("lineitem", "l_orderkey"))
    ret = t.where("lineitem", "l_returnflag", lambda s: s == "R")
    li = np.flatnonzero(ret & ofound & (odate[orow] >= lo)
                        & (odate[orow] < hi))
    cust = t.v("orders", "o_custkey")[orow[li]]
    keys, rev = group_sum(cust, _revenue(t, li))
    order = np.argsort(-rev, kind="stable")[:20]
    crow, _ = lookup(t.v("customer", "c_custkey"), keys[order])
    nrow, _ = lookup(t.v("nation", "n_nationkey"),
                     t.v("customer", "c_nationkey")[crow])
    return {"c_custkey": _py(keys[order]),
            "c_name": list(t.s("customer", "c_name")[crow]),
            "revenue": _py(rev[order]),
            "c_acctbal": _py(t.v("customer", "c_acctbal")[crow]),
            "n_name": list(t.s("nation", "n_name")[nrow]),
            "c_address": list(t.s("customer", "c_address")[crow]),
            "c_phone": list(t.s("customer", "c_phone")[crow]),
            "c_comment": list(t.s("customer", "c_comment")[crow])}


def q17(t: Tables) -> dict:
    part = t.v("lineitem", "l_partkey")
    qty = t.v("lineitem", "l_quantity")
    keys, qsum = group_sum(part, qty)
    _, qcnt = group_sum(part, np.ones_like(qty))
    avg = np.array([div_half_up(int(s), int(c)) for s, c in
                    zip(qsum, qcnt)], dtype=np.int64)  # scale 2, HALF_UP
    p_ok = t.where("part", "p_brand", lambda s: s == "Brand#23") & t.where(
        "part", "p_container", lambda s: s == "MED BOX")
    prow, pfound = lookup(t.v("part", "p_partkey"), part)
    arow, _ = lookup(keys, part)
    # l_quantity (scale 2) < 0.2 (scale 1) * avg (scale 2), at scale 3
    keep = pfound & p_ok[prow] & (qty * 10 < 2 * avg[arow])
    total = int(t.v("lineitem", "l_extendedprice")[keep].sum())
    # sum (scale 2) / 7.0 (scale 1) at scale 2
    return {"avg_yearly": [div_half_up(total * 10, 70)]}


def q18(t: Tables, threshold: int = 30000) -> dict:
    """``threshold``: sum(l_quantity) > threshold, unscaled (300.00)."""
    lkey = t.v("lineitem", "l_orderkey")
    keys, qsum = group_sum(lkey, t.v("lineitem", "l_quantity"))
    big, bsum = keys[qsum > threshold], qsum[qsum > threshold]
    orow, _ = lookup(t.v("orders", "o_orderkey"), big)
    crow, _ = lookup(t.v("customer", "c_custkey"), t.v("orders", "o_custkey")[orow])
    price = t.v("orders", "o_totalprice")[orow]
    date = t.v("orders", "o_orderdate")[orow]
    order = np.lexsort((date, -price))[:100]
    return {"c_name": list(t.s("customer", "c_name")[crow][order]),
            "c_custkey": _py(t.v("customer", "c_custkey")[crow][order]),
            "o_orderkey": _py(big[order]), "o_orderdate": _py(date[order]),
            "o_totalprice": _py(price[order]), "_col5": _py(bsum[order])}


def _distinct_per(key: np.ndarray, other: np.ndarray):
    """(distinct keys, number of distinct ``other`` values per key)."""
    m = int(other.max()) + 1 if other.shape[0] else 1
    pairs = np.unique(key * m + other)  # other >= 0, key * m < 2^63
    return np.unique(pairs // m, return_counts=True)


def q21(t: Tables) -> dict:
    lkey, lsupp = t.v("lineitem", "l_orderkey"), t.v("lineitem", "l_suppkey")
    late = t.v("lineitem", "l_receiptdate") > t.v("lineitem", "l_commitdate")
    okeys, n_supp = _distinct_per(lkey, lsupp)
    lkeys, n_late_supp = _distinct_per(lkey[late], lsupp[late])
    status_f = t.where("orders", "o_orderstatus", lambda s: s == "F")
    orow, ofound = lookup(t.v("orders", "o_orderkey"), lkey)
    srow, _ = lookup(t.v("supplier", "s_suppkey"), lsupp)
    saudi = t.where("nation", "n_name", lambda s: s == "SAUDI ARABIA")
    nrow, _ = lookup(t.v("nation", "n_nationkey"),
                     t.v("supplier", "s_nationkey")[srow])
    arow, _ = lookup(okeys, lkey)
    brow, bfound = lookup(lkeys, lkey)
    # exists l2 of another supplier: the order has > 1 supplier; not exists
    # a late l3 of another supplier: l1's supplier is the order's only late
    # one (l1 is late itself)
    keep = (late & ofound & status_f[orow] & saudi[nrow]
            & (n_supp[arow] > 1) & bfound & (n_late_supp[brow] == 1))
    supp, cnt = np.unique(srow[keep], return_counts=True)
    names = t.s("supplier", "s_name")[supp]
    order = sorted(range(len(supp)), key=lambda i: (-cnt[i], names[i]))[:100]
    return {"s_name": [names[i] for i in order],
            "numwait": [int(cnt[i]) for i in order]}


# ------------------------------------------------------------ Q7-Q22

def year(d: np.ndarray) -> np.ndarray:
    """Civil year of days since 1970-01-01 (numpy's calendar)."""
    return d.astype("datetime64[D]").astype("datetime64[Y]").astype(
        np.int64) + 1970


def has_in_order(strings, segs) -> np.ndarray:
    """bool per string: LIKE '%seg1%seg2%...%', each segment found after
    the end of the one before (``str.find``)."""
    def hit(s: str) -> bool:
        pos = 0
        for seg in segs:
            i = s.find(seg, pos)
            if i < 0:
                return False
            pos = i + len(seg)
        return True
    return np.fromiter((hit(s) for s in strings), dtype=bool,
                       count=len(strings))


def nation_key(t: Tables, name: str) -> int:
    (row,) = np.flatnonzero(t.where("nation", "n_name",
                                    lambda s: s == name))
    return int(t.v("nation", "n_nationkey")[row])


def pair_key(a: np.ndarray, b: np.ndarray, b_max: int) -> np.ndarray:
    """One int64 per (a, b) pair of non-negative keys, b <= b_max."""
    return a.astype(np.int64) * (b_max + 1) + b


def q7(t: Tables) -> dict:
    ship = t.v("lineitem", "l_shipdate")
    srow, _ = lookup(t.v("supplier", "s_suppkey"), t.v("lineitem", "l_suppkey"))
    orow, _ = lookup(t.v("orders", "o_orderkey"), t.v("lineitem", "l_orderkey"))
    crow, _ = lookup(t.v("customer", "c_custkey"), t.v("orders", "o_custkey"))
    sn = t.v("supplier", "s_nationkey")[srow]
    cn = t.v("customer", "c_nationkey")[crow[orow]]
    fr, de = nation_key(t, "FRANCE"), nation_key(t, "GERMANY")
    li = np.flatnonzero((ship >= days("1995-01-01"))
                        & (ship <= days("1996-12-31"))
                        & (((sn == fr) & (cn == de)) | ((sn == de) & (cn == fr))))
    yr = year(ship[li])
    keys, rev = group_sum(pair_key(sn[li] * 25 + cn[li], yr, 9999),
                          _revenue(t, li))
    nrow, _ = lookup(t.v("nation", "n_nationkey"), np.arange(25))
    names = t.s("nation", "n_name")[nrow]
    nations, years = keys // 10000, keys % 10000
    cols = {"supp_nation": list(names[nations // 25]),
            "cust_nation": list(names[nations % 25]),
            "l_year": _py(years), "revenue": _py(rev)}
    order = sorted(range(len(keys)), key=lambda i: (
        cols["supp_nation"][i], cols["cust_nation"][i], years[i]))
    return _rows(cols, order)


def q8(t: Tables) -> dict:
    p_ok = t.where("part", "p_type", lambda s: s == "ECONOMY ANODIZED STEEL")
    prow, _ = lookup(t.v("part", "p_partkey"), t.v("lineitem", "l_partkey"))
    orow, _ = lookup(t.v("orders", "o_orderkey"), t.v("lineitem", "l_orderkey"))
    crow, _ = lookup(t.v("customer", "c_custkey"), t.v("orders", "o_custkey"))
    srow, _ = lookup(t.v("supplier", "s_suppkey"), t.v("lineitem", "l_suppkey"))
    odate = t.v("orders", "o_orderdate")[orow]
    (amer,) = np.flatnonzero(t.where("region", "r_name",
                                     lambda s: s == "AMERICA"))
    nrow, _ = lookup(t.v("nation", "n_nationkey"),
                     t.v("customer", "c_nationkey")[crow[orow]])
    in_america = t.v("nation", "n_regionkey")[nrow] == \
        t.v("region", "r_regionkey")[amer]
    li = np.flatnonzero(p_ok[prow] & in_america
                        & (odate >= days("1995-01-01"))
                        & (odate <= days("1996-12-31")))
    vol = _revenue(t, li)
    brazil = t.v("supplier", "s_nationkey")[srow[li]] == \
        nation_key(t, "BRAZIL")
    years, den = group_sum(year(odate[li]), vol)
    _, num = group_sum(year(odate[li]), np.where(brazil, vol, 0))
    # decimal(38,4) / decimal(38,4) at scale 4, HALF_UP
    return {"o_year": _py(years),
            "mkt_share": [div_half_up(int(a) * 10**4, int(b))
                          for a, b in zip(num, den)]}


def q9(t: Tables) -> dict:
    green = has_in_order(t.s("part", "p_name"), ("green",))
    lpart, lsupp = t.v("lineitem", "l_partkey"), t.v("lineitem", "l_suppkey")
    prow, _ = lookup(t.v("part", "p_partkey"), lpart)
    li = np.flatnonzero(green[prow])
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
    keys, profit = group_sum(
        pair_key(nation, year(t.v("orders", "o_orderdate")[orow]), 9999),
        amount)
    nrow, _ = lookup(t.v("nation", "n_nationkey"), keys // 10000)
    names = t.s("nation", "n_name")[nrow]
    years = keys % 10000
    order = sorted(range(len(keys)), key=lambda i: (names[i], -years[i]))
    return _rows({"nation": list(names), "o_year": _py(years),
                  "sum_profit": _py(profit)}, order)


def _german_partsupp(t: Tables):
    """(partsupp rows of German suppliers, ps_supplycost * ps_availqty of
    each at scale 2)."""
    srow, _ = lookup(t.v("supplier", "s_suppkey"), t.v("partsupp", "ps_suppkey"))
    rows = np.flatnonzero(t.v("supplier", "s_nationkey")[srow]
                          == nation_key(t, "GERMANY"))
    return rows, t.v("partsupp", "ps_supplycost")[rows] \
        * t.v("partsupp", "ps_availqty")[rows].astype(np.int64)


def q11(t: Tables) -> dict:
    rows, v = _german_partsupp(t)
    total = int(v.sum())
    keys, value = group_sum(t.v("partsupp", "ps_partkey")[rows], v)
    # sum (scale 2) > total * 0.0001000 (scale 9)
    keep = np.flatnonzero(value * 10**7 > total * 1000)
    order = keep[np.lexsort((keys[keep], -value[keep]))]
    return {"ps_partkey": _py(keys[order]), "value": _py(value[order])}


def q12(t: Tables) -> dict:
    commit = t.v("lineitem", "l_commitdate")
    receipt = t.v("lineitem", "l_receiptdate")
    mode = t.col("lineitem", "l_shipmode")
    mode_ok = t.where("lineitem", "l_shipmode",
                      lambda s: s in ("MAIL", "SHIP"))
    li = np.flatnonzero(mode_ok & (commit < receipt)
                        & (t.v("lineitem", "l_shipdate") < commit)
                        & (receipt >= days("1994-01-01"))
                        & (receipt < days("1995-01-01")))
    orow, _ = lookup(t.v("orders", "o_orderkey"),
                     t.v("lineitem", "l_orderkey")[li])
    high = t.where("orders", "o_orderpriority",
                   lambda s: s in ("1-URGENT", "2-HIGH"))[orow]
    codes = np.asarray(mode.values)[li]
    out = {"l_shipmode": [], "high_line_count": [], "low_line_count": []}
    for code in sorted(np.unique(codes).tolist(),
                       key=lambda c: str(mode.dictionary[c])):
        sel = codes == code
        out["l_shipmode"].append(str(mode.dictionary[code]))
        out["high_line_count"].append(int((sel & high).sum()))
        out["low_line_count"].append(int((sel & ~high).sum()))
    return out


def q13(t: Tables) -> dict:
    special = has_in_order(t.s("orders", "o_comment"),
                           ("special", "requests"))
    ckey = t.v("customer", "c_custkey")
    per_cust = np.bincount(t.v("orders", "o_custkey")[~special],
                           minlength=int(ckey.max()) + 1)
    counts, custdist = np.unique(per_cust[ckey], return_counts=True)
    order = np.lexsort((-counts, -custdist))
    return {"c_count": _py(counts[order]), "custdist": _py(custdist[order])}


def q15(t: Tables) -> dict:
    ship = t.v("lineitem", "l_shipdate")
    li = np.flatnonzero((ship >= days("1996-01-01"))
                        & (ship < days("1996-04-01")))
    keys, rev = group_sum(t.v("lineitem", "l_suppkey")[li], _revenue(t, li))
    top = np.flatnonzero(rev == rev.max())  # keys ascending
    srow, _ = lookup(t.v("supplier", "s_suppkey"), keys[top])
    return {"s_suppkey": _py(keys[top]),
            "s_name": list(t.s("supplier", "s_name")[srow]),
            "s_address": list(t.s("supplier", "s_address")[srow]),
            "s_phone": list(t.s("supplier", "s_phone")[srow]),
            "total_revenue": _py(rev[top])}


def q16(t: Tables) -> dict:
    complaints = has_in_order(t.s("supplier", "s_comment"),
                              ("Customer", "Complaints"))
    bad = t.v("supplier", "s_suppkey")[complaints]
    size = t.v("part", "p_size")
    p_ok = (t.where("part", "p_brand", lambda s: s != "Brand#45")
            & ~t.where("part", "p_type",
                       lambda s: s.startswith("MEDIUM POLISHED"))
            & np.isin(size, (49, 14, 23, 45, 19, 3, 36, 9)))
    supp = t.v("partsupp", "ps_suppkey")
    prow, _ = lookup(t.v("part", "p_partkey"), t.v("partsupp", "ps_partkey"))
    rows = np.flatnonzero(p_ok[prow] & ~np.isin(supp, bad))
    brand, ptype = t.col("part", "p_brand"), t.col("part", "p_type")
    # group = (brand code, type code, size), then distinct suppliers
    group = pair_key(pair_key(np.asarray(brand.values)[prow[rows]],
                              np.asarray(ptype.values)[prow[rows]],
                              len(ptype.dictionary)),
                     size[prow[rows]], int(size.max()))
    groups, cnt = _distinct_per(group, supp[rows])
    bt, sizes = groups // (int(size.max()) + 1), groups % (int(size.max()) + 1)
    nt = len(ptype.dictionary) + 1
    cols = {"p_brand": [str(brand.dictionary[c]) for c in bt // nt],
            "p_type": [str(ptype.dictionary[c]) for c in bt % nt],
            "p_size": _py(sizes), "supplier_cnt": _py(cnt)}
    order = sorted(range(len(groups)), key=lambda i: (
        -cnt[i], cols["p_brand"][i], cols["p_type"][i], sizes[i]))
    return _rows(cols, order)


def q19(t: Tables) -> dict:
    prow, _ = lookup(t.v("part", "p_partkey"), t.v("lineitem", "l_partkey"))
    qty = t.v("lineitem", "l_quantity")
    size = t.v("part", "p_size")[prow]
    base = t.where("lineitem", "l_shipmode",
                   lambda s: s in ("AIR", "AIR REG")) & t.where(
        "lineitem", "l_shipinstruct", lambda s: s == "DELIVER IN PERSON")
    keep = np.zeros(qty.shape[0], dtype=bool)
    for brand, containers, q_lo, max_size in (
            ("Brand#12", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"), 1, 5),
            ("Brand#23", ("MED BAG", "MED BOX", "MED PKG", "MED PACK"), 10,
             10),
            ("Brand#34", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"), 20, 15)):
        part_ok = t.where("part", "p_brand", lambda s: s == brand) \
            & t.where("part", "p_container", lambda s: s in containers)
        keep |= (part_ok[prow] & (qty >= q_lo * 100)
                 & (qty <= (q_lo + 10) * 100) & (size >= 1)
                 & (size <= max_size))
    li = np.flatnonzero(base & keep)
    return {"revenue": [int(_revenue(t, li).sum()) if li.size else None]}


def q20(t: Tables) -> dict:
    forest = np.fromiter((s.startswith("forest")
                          for s in t.s("part", "p_name")), dtype=bool)
    smax = int(t.v("supplier", "s_suppkey").max())
    ship = t.v("lineitem", "l_shipdate")
    li = np.flatnonzero((ship >= days("1994-01-01"))
                        & (ship < days("1995-01-01")))
    keys, qsum = group_sum(pair_key(t.v("lineitem", "l_partkey")[li],
                                    t.v("lineitem", "l_suppkey")[li], smax),
                           t.v("lineitem", "l_quantity")[li])
    ps_part, ps_supp = t.v("partsupp", "ps_partkey"), \
        t.v("partsupp", "ps_suppkey")
    ps = np.flatnonzero(np.isin(ps_part, t.v("part", "p_partkey")[forest]))
    qrow, found = lookup(keys, pair_key(ps_part[ps], ps_supp[ps], smax))
    # ps_availqty > 0.5 * sum(l_quantity): at scale 3, availqty * 1000 >
    # 5 * sum (scale 2); no lineitem row gives NULL, which drops the row
    avail = t.v("partsupp", "ps_availqty")[ps].astype(np.int64)
    supp = np.unique(ps_supp[ps][found & (avail * 200 > qsum[qrow])])
    srow = np.flatnonzero(np.isin(t.v("supplier", "s_suppkey"), supp)
                          & (t.v("supplier", "s_nationkey")
                             == nation_key(t, "CANADA")))
    names = t.s("supplier", "s_name")[srow]
    order = sorted(range(len(srow)), key=lambda i: names[i])
    return _rows({"s_name": list(names),
                  "s_address": list(t.s("supplier", "s_address")[srow])},
                 order)


def q22(t: Tables) -> dict:
    codes = ("13", "31", "23", "29", "30", "18", "17")
    cc = np.array([p[:2] for p in t.s("customer", "c_phone")], dtype=object)
    sel = np.isin(cc, codes)
    bal = t.v("customer", "c_acctbal")
    pos = sel & (bal > 0)
    avg = div_half_up(int(bal[pos].sum()), int(pos.sum()))  # scale 2
    has_orders = np.isin(t.v("customer", "c_custkey"), t.v("orders", "o_custkey"))
    rows = np.flatnonzero(sel & (bal > avg) & ~has_orders)
    out = {"cntrycode": [], "numcust": [], "totacctbal": []}
    for code in sorted(set(cc[rows].tolist())):
        r = rows[cc[rows] == code]
        out["cntrycode"].append(code)
        out["numcust"].append(int(r.size))
        out["totacctbal"].append(int(bal[r].sum()))
    return out


QUERIES = {"q1": q1, "q6": q6, "q14": q14, "bigint_sum": bigint_sum,
           "q2": q2, "q3": q3, "q4": q4, "q5": q5, "q10": q10, "q17": q17,
           "q18": q18, "q21": q21, "q7": q7, "q8": q8, "q9": q9,
           "q11": q11, "q12": q12, "q13": q13, "q15": q15, "q16": q16,
           "q19": q19, "q20": q20, "q22": q22}


# ---------------------------------------------------------------- streamed

def mix32(x: np.ndarray) -> np.ndarray:
    """murmur3 fmix32 over uint32 (numpy's uint32 arithmetic wraps)."""
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    return x


def hash_i64(k: np.ndarray) -> np.ndarray:
    """The engine's uint32 hash of an int64 key (``ops/hashing.py``)."""
    k = np.asarray(k, np.int64)
    lo = (k & 0xFFFFFFFF).astype(np.uint32)
    hi = ((k >> 32) & 0xFFFFFFFF).astype(np.uint32)
    return mix32(lo ^ (mix32(hi) + np.uint32(0x9E3779B9)))


GOLDEN64 = np.uint64(0x9E3779B97F4A7C15)


def hash_strings(strings) -> np.ndarray:
    """The engine's uint32 hash of each ASCII string
    (``ops/hashing.py`` ``hash_strings``): its bytes in big-endian 8-byte
    packs, zero-padded, the first pack hashed and each further pack that
    holds one of its bytes mixed in."""
    raw = [str(x).encode("ascii") for x in strings]
    lens = np.array([len(b) for b in raw], np.int64)
    w = max(int(lens.max(initial=0) + 7) // 8, 1)
    packs = np.array(raw, dtype=f"S{8 * w}").view(">i8").reshape(
        len(raw), w).astype(np.int64)
    h = hash_i64(packs[:, 0])
    for j in range(1, w):
        mixed = mix32(h + np.uint32(0x9E3779B9) + hash_i64(packs[:, j]))
        h = np.where(lens > 8 * j, mixed, h)
    return h


def checksum_terms(k: np.ndarray = None, strings=None) -> np.ndarray:
    """Each int64 key's (or string's) ``checksum`` contribution, as the
    engine forms it (``exec/physical.py`` ``checksum_terms``): (hash + 1)
    times the 64-bit golden ratio, wrapping in int64."""
    h = hash_i64(k) if strings is None else hash_strings(strings)
    return ((h.astype(np.uint64) + np.uint64(1)) * GOLDEN64).view(np.int64)


def wrap64(v: int) -> int:
    """A Python int as the int64 it wraps to."""
    return (v + 2**63) % 2**64 - 2**63


def checksum(k: np.ndarray = None, strings=None) -> int:
    """``checksum`` of int64 keys (or strings): the wrapping int64 sum of
    their terms."""
    return wrap64(exact_sum(checksum_terms(k, strings)))


def hll_estimate(groups: np.ndarray, n_groups: int, keys: np.ndarray,
                 p: int = 11) -> np.ndarray:
    """``approx_distinct`` per group: 2^p int8 registers per group (the
    rank of the first set bit of the hash's high 32 - p bits, a zero word
    ranking 33 - p), then the engine's estimate (``ops/hll.py``)."""
    m = 1 << p
    h = hash_i64(keys).astype(np.int64)
    w = h >> p
    bits = np.zeros_like(w)
    for s in (16, 8, 4, 2, 1):
        big = w >= (1 << s)
        w = np.where(big, w >> s, w)
        bits += big * s
    rho = 32 - (bits + (w > 0)) - p + 1
    regs = np.zeros(n_groups * m, np.int8)
    slot = groups.astype(np.int64) * m + (h & (m - 1))
    for r in range(1, 34 - p):  # ascending ranks: the last write is the max
        regs[slot[rho == r]] = r
    regs = regs.reshape(n_groups, m)
    alpha = 0.7213 / (1.0 + 1.079 / m)
    e = alpha * m * m / np.exp2(-regs.astype(np.float64)).sum(-1)
    zeros = (regs == 0).sum(-1)
    lc = m * np.log(m / np.maximum(zeros, 1).astype(np.float64))
    est = np.where((e <= 2.5 * m) & (zeros > 0), lc, e)
    two32 = 2.0 ** 32
    est = np.where(est > two32 / 30.0, -two32 * np.log1p(-est / two32), est)
    return np.round(est).astype(np.int64)


def lineitem_sum(t: Tables) -> dict:
    """sum(l_orderkey), count(*) over all of lineitem."""
    k = t.v("lineitem", "l_orderkey")
    return {"s": [exact_sum(k)], "c": [int(k.shape[0])]}


def approx_distinct_partkey(t: Tables) -> dict:
    """approx_distinct(l_partkey) per l_returnflag, in flag order."""
    rf = t.col("lineitem", "l_returnflag")
    codes = np.asarray(rf.values).astype(np.int64)
    est = hll_estimate(codes, len(rf.dictionary), t.v("lineitem",
                                                      "l_partkey"))
    present = np.unique(codes)
    order = sorted(present.tolist(), key=lambda c: str(rf.dictionary[c]))
    return {"l_returnflag": [str(rf.dictionary[c]) for c in order],
            "a": [int(est[c]) for c in order]}


def orderkey_groups(t: Tables) -> dict:
    """l_orderkey, sum(l_quantity), count(*) per order, in key order, as
    numpy arrays (15 M groups at SF10)."""
    key = t.v("lineitem", "l_orderkey")
    keys, q = group_sum(key, t.v("lineitem", "l_quantity"))
    _, c = group_sum(key, np.ones(key.shape[0], np.int64))
    return {"l_orderkey": keys, "q": q, "c": c}


def orders_in_keys(t: Tables, lo: int, hi: int) -> dict:
    """o_orderpriority, count(*), sum(o_totalprice) of the orders with
    o_orderkey in [lo, hi], in priority order."""
    m = (t.v("orders", "o_orderkey") >= lo) & (t.v("orders",
                                                   "o_orderkey") <= hi)
    pr = t.col("orders", "o_orderpriority")
    codes = np.asarray(pr.values)[m]
    price = t.v("orders", "o_totalprice")[m]
    order = sorted(np.unique(codes).tolist(),
                   key=lambda c: str(pr.dictionary[c]))
    return {"o_orderpriority": [str(pr.dictionary[c]) for c in order],
            "c": [int((codes == c).sum()) for c in order],
            "s": [exact_sum(price[codes == c]) for c in order]}


def orders_by_price(t: Tables) -> dict:
    """Every order's key and total price, o_totalprice DESC, o_orderkey."""
    k, p = t.v("orders", "o_orderkey"), t.v("orders", "o_totalprice")
    order = np.lexsort((k, -p))
    return {"o_orderkey": k[order], "o_totalprice": p[order]}


def orders_from_key(t: Tables, lo: int) -> dict:
    """count(*), sum(o_custkey) of the orders with o_orderkey >= lo."""
    m = t.v("orders", "o_orderkey") >= lo
    return {"c": [int(m.sum())],
            "s": [exact_sum(t.v("orders", "o_custkey")[m])]}


# ------------------------------------------------------ scalar statements

SCALARS = {
    "in_decimal": "select sum(l_extendedprice) s, count(*) c from lineitem "
                  "where l_discount in (0.05, 0.06)",
    "not_in_null": "select o_orderstatus, count(*) c from orders "
                   "where o_orderpriority not in ('1-URGENT', null) "
                   "or o_orderstatus = 'F' group by o_orderstatus "
                   "order by o_orderstatus",
    "mod": "select sum(mod(o_orderkey, 7)) s, sum(mod(o_totalprice, 100)) t "
           "from orders",
    "nullif": "select count(nullif(o_orderpriority, '1-URGENT')) a, "
              "count(nullif(o_shippriority, 0)) b from orders",
    "greatest_least": "select sum(greatest(l_quantity, 10)) g, "
                      "sum(least(l_tax, l_discount)) l from lineitem",
    "dict_length_lower": "select lower(l_shipmode) m, "
                         "sum(length(l_shipmode)) n, count(*) c "
                         "from lineitem group by lower(l_shipmode) order by m",
    "bytes_length_lower": "select count(*) c, sum(length(c_name)) n "
                          "from customer "
                          "where lower(c_name) like 'customer#0000001%'",
    "dict_min_max": "select l_returnflag, min(l_shipmode) a, "
                    "max(l_shipmode) b, min(l_shipinstruct) c, "
                    "max(l_shipinstruct) d from lineitem "
                    "group by l_returnflag order by l_returnflag",
    "math_agg": "select sum(sqrt(l_quantity)) q, sum(ln(l_extendedprice)) e "
                "from lineitem",
    "bitwise_sum": "select sum(bitwise_and(o_orderkey, 255)) s from orders",
    "in_join": "select count(*) c, sum(l_quantity) q from lineitem, orders "
               "where l_orderkey = o_orderkey and o_orderstatus = 'F' "
               "and l_discount in (0.01, 0.10)",
    "unique_id": "select count(distinct unique_id()) c, count(*) n "
                 "from lineitem",
}
# DOUBLE results, held to 1e-12 relative: the oracle sums exactly
# (``math.fsum``), the engine in its own order
SCALARS_DOUBLE = ("math_agg",)


def _by_code(col, codes: np.ndarray, f) -> dict:
    """{string: f(rows of that string)} over a dictionary column's codes."""
    return {str(col.dictionary[c]): f(codes == c) for c in np.unique(codes)}


def scalars(t: Tables) -> dict:
    """The ``SCALARS`` statements' results: decimals unscaled, integers
    exact, the DOUBLE sums by ``math.fsum``."""
    li, od, cu = "lineitem", "orders", "customer"
    disc = t.v(li, "l_discount")
    ep, qty, tax = (t.v(li, c) for c in ("l_extendedprice", "l_quantity",
                                         "l_tax"))
    okey, price = t.v(od, "o_orderkey"), t.v(od, "o_totalprice")
    out = {}
    m = (disc == 5) | (disc == 6)
    out["in_decimal"] = {"s": [exact_sum(ep[m])], "c": [int(m.sum())]}
    status = t.col(od, "o_orderstatus")
    st = np.array([str(x) for x in status.dictionary])[
        np.asarray(status.values)]
    out["not_in_null"] = {"o_orderstatus": ["F"],
                          "c": [int((st == "F").sum())]}
    out["mod"] = {"s": [exact_sum(okey % 7)], "t": [exact_sum(price % 10000)]}
    urgent = t.where(od, "o_orderpriority", lambda x: x == "1-URGENT")
    out["nullif"] = {"a": [int((~urgent).sum())],
                     "b": [int((t.v(od, "o_shippriority") != 0).sum())]}
    out["greatest_least"] = {"g": [exact_sum(np.maximum(qty, 1000))],
                             "l": [exact_sum(np.minimum(tax, disc))]}
    mode = t.col(li, "l_shipmode")
    mcodes = np.asarray(mode.values)
    cnt = _by_code(mode, mcodes, lambda r: int(r.sum()))
    low = sorted(cnt, key=str.lower)
    out["dict_length_lower"] = {"m": [x.lower() for x in low],
                                "n": [len(x) * cnt[x] for x in low],
                                "c": [cnt[x] for x in low]}
    names = t.s(cu, "c_name")
    hit = [x for x in names if x.lower().startswith("customer#0000001")]
    out["bytes_length_lower"] = {"c": [len(hit)],
                                 "n": [sum(len(x) for x in hit)]}
    rf = t.col(li, "l_returnflag")
    flags = np.array([str(x) for x in rf.dictionary])[np.asarray(rf.values)]
    modes = np.array([str(x) for x in mode.dictionary])[mcodes]
    instr = t.col(li, "l_shipinstruct")
    ins = np.array([str(x) for x in instr.dictionary])[
        np.asarray(instr.values)]
    keys = sorted(set(flags.tolist()))
    out["dict_min_max"] = {
        "l_returnflag": keys,
        "a": [min(set(modes[flags == k].tolist())) for k in keys],
        "b": [max(set(modes[flags == k].tolist())) for k in keys],
        "c": [min(set(ins[flags == k].tolist())) for k in keys],
        "d": [max(set(ins[flags == k].tolist())) for k in keys]}
    out["math_agg"] = {"q": [math.fsum(np.sqrt(qty / 100.0))],
                       "e": [math.fsum(np.log(ep / 100.0))]}
    out["bitwise_sum"] = {"s": [exact_sum(okey & 255)]}
    row, found = lookup(okey, t.v(li, "l_orderkey"))
    m = found & (st[row] == "F") & ((disc == 1) | (disc == 10))
    out["in_join"] = {"c": [int(m.sum())], "q": [exact_sum(qty[m])]}
    n = int(ep.shape[0])
    out["unique_id"] = {"c": [n], "n": [n]}
    return out


def oracle(ds, names=tuple(QUERIES)) -> dict:
    """The named queries' results over ``ds``'s host tables."""
    t = Tables(ds)
    return {name: QUERIES[name](t) for name in names}


# ---------------------------------------------------------------- the wire

def wire(v, sql_type: str):
    """A value as the statement protocol sends it: a date in ISO form, a
    decimal as its scaled string, a DOUBLE as a float, a string as
    itself, any other number as an int; NULL as None."""
    if v is None:
        return None
    if sql_type == "date":
        return (dt.date(1970, 1, 1) + dt.timedelta(days=int(v))).isoformat()
    if sql_type.startswith("decimal("):
        scale = int(sql_type.rstrip(")").split(",")[1])
        q, r = divmod(abs(int(v)), 10 ** scale)
        sign = "-" if int(v) < 0 else ""
        return f"{sign}{q}.{r:0{scale}d}" if scale else f"{sign}{q}"
    if sql_type == "double":
        return float(v)
    if sql_type == "boolean":
        return bool(v)
    if sql_type.startswith(("varchar", "char")):
        return str(v)
    return int(v)


def wire_rows(cols: dict, types) -> list:
    """Rows of ``{column: values}`` as the protocol sends them, ``types``
    the SQL type of each column in order."""
    names = list(cols)
    n = len(cols[names[0]]) if names else 0
    return [[wire(cols[c][i], t) for c, t in zip(names, types)]
            for i in range(n)]


def shipped_on(t: Tables, iso: str) -> dict:
    """l_orderkey, l_linenumber, l_extendedprice of the lineitem rows
    shipped on ``iso``, ordered by the first two."""
    rows = np.flatnonzero(t.v("lineitem", "l_shipdate") == days(iso))
    okey = t.v("lineitem", "l_orderkey")[rows]
    line = t.v("lineitem", "l_linenumber")[rows]
    order = np.lexsort((line, okey))
    return {"l_orderkey": _py(okey[order]), "l_linenumber": _py(line[order]),
            "l_extendedprice": _py(
                t.v("lineitem", "l_extendedprice")[rows][order])}


# ---------------------------------------------------------------- li95

LI95 = ("l_orderkey", "l_partkey", "l_quantity", "l_extendedprice",
        "l_discount", "l_shipdate")
# the SQL types the statements below give their columns (decimals keep
# lineitem's scale 2, dates are days)
LI95_AGG_TYPES = ("bigint", "bigint", "bigint", "decimal(15,2)",
                  "decimal(15,2)", "decimal(15,2)", "date", "date")


class Li95:
    """``chip_smoke.py``'s memory table ``li95`` (six lineitem columns,
    the rows shipped in 1995 or later), kept as numpy arrays beside the
    engine's copy: each write of the script is applied here too."""

    def __init__(self, t: Tables):
        self.t = t
        full = {c: t.v("lineitem", c) for c in LI95}
        m = full["l_shipdate"] >= days("1995-01-01")
        self.cols = {c: v[m] for c, v in full.items()}
        self.rest = {c: v[~m] for c, v in full.items()}

    @property
    def n(self) -> int:
        return int(self.cols["l_orderkey"].shape[0])

    def insert_rest(self) -> int:
        """INSERT of lineitem's rows shipped before 1995."""
        self.cols = {c: np.concatenate([v, self.rest[c]])
                     for c, v in self.cols.items()}
        return int(self.rest["l_orderkey"].shape[0])

    def update_discount(self, quantity_at_least: int) -> int:
        """UPDATE ... SET l_discount = 0 WHERE l_quantity >= q."""
        hit = self.cols["l_quantity"] >= quantity_at_least * 100
        self.cols["l_discount"] = np.where(hit, 0, self.cols["l_discount"])
        return int(hit.sum())

    def delete_shipped_before(self, iso: str) -> int:
        """DELETE ... WHERE l_shipdate < iso."""
        keep = self.cols["l_shipdate"] >= days(iso)
        self.cols = {c: v[keep] for c, v in self.cols.items()}
        return int((~keep).sum())

    def agg_row(self) -> list:
        """count, the sums of the five numbers, min and max ship date."""
        c = self.cols
        sums = [int(c[k].astype(np.int64).sum()) for k in LI95[:5]]
        ship = c["l_shipdate"]
        return [self.n] + sums + [int(ship.min()), int(ship.max())]

    def by_priority(self) -> dict:
        """Joined with orders on the order key, per o_orderpriority: rows
        and the sum of l_quantity, by priority."""
        t = self.t
        row, found = lookup(t.v("orders", "o_orderkey"),
                            self.cols["l_orderkey"])
        prio = t.s("orders", "o_orderpriority")[row[found]]
        qty = self.cols["l_quantity"][found]
        names = sorted(set(prio.tolist()))
        return {"o_orderpriority": names,
                "c": [int((prio == p).sum()) for p in names],
                "q": [int(qty[prio == p].sum()) for p in names]}

    def stats(self) -> list:
        """SHOW STATS rows: column, distinct values, low, high, rows."""
        return [[c, int(np.unique(v).shape[0]), int(v.min()), int(v.max()),
                 self.n] for c, v in self.cols.items()]


# ---------------------------------------------------------------- strings
# and dates: ``chip_smoke.py``'s ``strings_dates`` phase at SF1

STRINGS_DATES = {
    "bytes_trim_strpos": "select sum(length(trim(l_comment))) t, "
                         "sum(strpos(l_comment, 'the')) p from lineitem",
    "bytes_pad_prefix": "select count(*) c, sum(codepoint(reverse(c_phone))) "
                        "s from customer where starts_with(c_phone, '13-') "
                        "and ends_with(rpad(c_name, 20, '*'), '*')",
    "bytes_regexp": "select regexp_extract(p_name, '^[a-z]+') w, count(*) c "
                    "from part where regexp_like(p_name, "
                    "'^[a-m][a-z]* [a-z]*e ') group by 1 "
                    "order by c desc, w limit 10",
    "dict_split_codecs": "select split_part(o_orderpriority, '-', 2) p, "
                         "to_hex(o_orderstatus) h, count(*) c from orders "
                         "group by 1, 2 order by 1, 2",
    "split_part_null": "select count(*) c from orders "
                       "where split_part(o_orderpriority, '-', 3) is null",
    "date_parts": "select quarter(o_orderdate) q, day_of_week(o_orderdate) d, "
                  "count(*) c, sum(o_totalprice) s from orders "
                  "group by 1, 2 order by 1, 2",
    "date_diff_join": "select sum(date_diff('day', o_orderdate, l_shipdate)) "
                      "d, sum(date_diff('month', l_receiptdate, o_orderdate)) "
                      "m, sum(date_diff('week', l_receiptdate, o_orderdate)) "
                      "w from lineitem, orders where l_orderkey = o_orderkey",
    "trunc_format": "select date_format(date_trunc('month', l_shipdate), "
                    "'%Y-%m') m, count(*) c from lineitem group by 1 "
                    "order by 1",
    "iso_week": "select year_of_week(l_shipdate) y, week(l_shipdate) w, "
                "count(*) c from lineitem where l_shipdate between "
                "date '1995-12-25' and date '1996-01-10' group by 1, 2 "
                "order by 1, 2",
    "month_end": "select count(*) c from orders where "
                 "date_add('month', 1, o_orderdate) > "
                 "last_day_of_month(o_orderdate)",
    "zoned": "select hour(cast(o_orderdate as timestamp) at time zone "
             "'+05:30') h, min(to_unixtime(cast(o_orderdate as timestamp) "
             "at time zone '-08:00')) u, count(*) c from orders group by 1",
}


def byte_strings(t: Tables, table: str, name: str) -> np.ndarray:
    """A byte-matrix string column as numpy fixed-width bytes (``S<W>``,
    the zero padding past each row's length dropped)."""
    c = t.col(table, name)
    v = np.ascontiguousarray(c.values, dtype=np.uint8)
    inside = np.arange(v.shape[1])[None, :] < np.asarray(c.lengths)[:, None]
    return np.ascontiguousarray(v * inside).view(f"S{v.shape[1]}").ravel()


def _ymd(days_: np.ndarray):
    """(year, month, day) of days since 1970-01-01 through numpy's
    calendar."""
    d = np.asarray(days_, np.int64).astype("datetime64[D]")
    m = d.astype("datetime64[M]")
    y = m.astype("datetime64[Y]")
    return (y.astype(np.int64) + 1970, (m - y).astype(np.int64) + 1,
            (d - m).astype(np.int64) + 1)


def add_months(days_: np.ndarray, k) -> np.ndarray:
    """Days moved ``k`` calendar months, the day clamped to the target
    month's length (Trino's ``date_add``)."""
    d = np.asarray(days_, np.int64).astype("datetime64[D]")
    month = d.astype("datetime64[M]") + np.asarray(k, np.int64)
    length = ((month + 1).astype("datetime64[D]")
              - month.astype("datetime64[D]")).astype(np.int64)
    day = (d - d.astype("datetime64[M]")).astype(np.int64)
    return (month.astype("datetime64[D]").astype(np.int64)
            + np.minimum(day, length - 1))


def months_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Trino's ``date_diff('month', a, b)`` of dates: the most whole
    months ``k`` with ``a`` moved ``k`` months not after ``b``, negated
    where ``b`` is before ``a``."""
    early, late = np.minimum(a, b), np.maximum(a, b)
    ye, me, _ = _ymd(early)
    yl, ml, _ = _ymd(late)
    k = (yl - ye) * 12 + ml - me
    k = k - (add_months(early, k) > late)
    return np.where(b < a, -k, k)


def strings_dates(t: Tables) -> dict:
    """The ``STRINGS_DATES`` statements' results, by numpy's char and
    calendar functions and Python's ``re`` and ``datetime``."""
    import re
    li, od = "lineitem", "orders"
    out = {}
    com = byte_strings(t, li, "l_comment")
    out["bytes_trim_strpos"] = {
        "t": [int(np.char.str_len(np.char.strip(com)).sum())],
        "p": [int((np.char.find(com, b"the") + 1).sum())]}
    phone = t.s("customer", "c_phone")
    name = t.s("customer", "c_name")
    hit = [p for p, n in zip(phone, name) if p.startswith("13-")
           and (n[:20] + "*" * 20)[:20].endswith("*")]
    out["bytes_pad_prefix"] = {"c": [len(hit)],
                               "s": [sum(ord(p[-1]) for p in hit)]}
    cnt = {}
    for p in t.s("part", "p_name"):
        if re.search(r"^[a-m][a-z]* [a-z]*e ", p):
            w = re.search(r"^[a-z]+", p).group(0)
            cnt[w] = cnt.get(w, 0) + 1
    top = sorted(cnt.items(), key=lambda x: (-x[1], x[0]))[:10]
    out["bytes_regexp"] = {"w": [w for w, _ in top], "c": [c for _, c in top]}
    prio, status = t.s(od, "o_orderpriority"), t.s(od, "o_orderstatus")
    pairs = {}
    for p, s in zip(prio, status):
        key = (p.split("-")[1], s.encode().hex().upper())
        pairs[key] = pairs.get(key, 0) + 1
    keys = sorted(pairs)
    out["dict_split_codecs"] = {"p": [k[0] for k in keys],
                                "h": [k[1] for k in keys],
                                "c": [pairs[k] for k in keys]}
    out["split_part_null"] = {"c": [sum(len(p.split("-")) < 3
                                        for p in prio)]}
    od_date = t.v(od, "o_orderdate").astype(np.int64)
    _, month, _ = _ymd(od_date)
    q = (month - 1) // 3 + 1
    dow = (od_date.astype("datetime64[D]").astype(object))
    dow = np.array([d.isoweekday() for d in dow], np.int64)
    price = t.v(od, "o_totalprice")
    gid = q * 8 + dow
    g, s = group_sum(gid, price)
    c = np.bincount(gid, minlength=int(gid.max()) + 1)[g]
    out["date_parts"] = {"q": _py(g // 8), "d": _py(g % 8), "c": _py(c),
                         "s": [exact_sum(price[gid == x]) for x in g]}
    row, found = lookup(t.v(od, "o_orderkey"), t.v(li, "l_orderkey"))
    odate = od_date[row[found]]
    ship = t.v(li, "l_shipdate").astype(np.int64)[found]
    recv = t.v(li, "l_receiptdate").astype(np.int64)[found]
    span = odate - recv
    out["date_diff_join"] = {
        "d": [exact_sum(ship - odate)],
        "m": [exact_sum(months_between(recv, odate))],
        "w": [exact_sum(np.sign(span) * (np.abs(span) // 7))]}
    ld = t.v(li, "l_shipdate").astype(np.int64)
    mon = np.datetime_as_string(ld.astype("datetime64[D]").astype(
        "datetime64[M]"))
    names, counts = np.unique(mon, return_counts=True)
    out["trunc_format"] = {"m": _py(names), "c": _py(counts)}
    lo, hi = days("1995-12-25"), days("1996-01-10")
    wk = {}
    for d, n in zip(*np.unique(ld[(ld >= lo) & (ld <= hi)],
                               return_counts=True)):
        y, w, _ = (dt.date(1970, 1, 1) + dt.timedelta(days=int(d))
                   ).isocalendar()
        wk[(y, w)] = wk.get((y, w), 0) + int(n)
    keys = sorted(wk)
    out["iso_week"] = {"y": [k[0] for k in keys], "w": [k[1] for k in keys],
                       "c": [wk[k] for k in keys]}
    last = (od_date.astype("datetime64[D]").astype("datetime64[M]") + 1
            ).astype("datetime64[D]").astype(np.int64) - 1
    out["month_end"] = {"c": [int((add_months(od_date, 1) > last).sum())]}
    out["zoned"] = {"h": [5], "u": [float(od_date.min()) * 86400.0],
                    "c": [int(od_date.shape[0])]}
    return out


# ------------------------------------------------ aggregates and patterns
# ``chip_smoke.py``'s ``aggregates_patterns`` phase at SF1

MR_DEFINE = ("partition by o_custkey order by o_orderkey {measures} "
             "{rows} after match skip past last row pattern (d+ u+) "
             "define d as o_totalprice < prev(o_totalprice), "
             "u as o_totalprice > prev(o_totalprice))")
AGGREGATES_PATTERNS = {
    "bool_bits_checksum": "select l_returnflag, l_linestatus, "
                          "bool_and(l_quantity < 50) a, "
                          "bool_or(l_discount > 0.09) b, "
                          "bitwise_and_agg(l_partkey) c, "
                          "bitwise_or_agg(l_partkey) d, "
                          "checksum(l_orderkey) e, count(*) n from lineitem "
                          "group by 1, 2 order by 1, 2",
    # price on quantity: the intercept is small beside the mean price
    # (l_extendedprice = l_quantity * p_retailprice), so it cancels
    "moments": "select l_returnflag, corr(l_extendedprice, l_quantity) c, "
               "covar_samp(l_extendedprice, l_quantity) cs, "
               "covar_pop(l_extendedprice, l_quantity) cp, "
               "regr_slope(l_extendedprice, l_quantity) rs, "
               "regr_intercept(l_extendedprice, l_quantity) ri, "
               "geometric_mean(l_quantity) g from lineitem group by 1 "
               "order by 1",
    "percentiles": "select l_shipmode, approx_percentile(l_extendedprice, "
                   "0.5) p, approx_percentile(l_quantity, 0.9) q "
                   "from lineitem group by 1 order by 1",
    "percentile_global": "select approx_percentile(o_totalprice, 0.5) p, "
                         "approx_percentile(o_orderdate, 0.99) d from orders",
    "min_by_date": "select o_orderpriority, min_by(o_orderkey, o_orderdate) "
                   "a, max_by(o_orderkey, o_orderdate) b from orders "
                   "group by 1 order by 1",
    # the key is unique per lineitem row (l_orderkey * 8 + l_linenumber
    # in its low 26 bits), so no tie decides the winner
    "min_by_join": "select o_orderpriority, min_by(o_totalprice, "
                   "l_partkey * 67108864 + l_orderkey * 8 + l_linenumber) a, "
                   "max_by(l_shipdate, l_partkey * 67108864 + l_orderkey * 8 "
                   "+ l_linenumber) b, count(*) n from lineitem, orders "
                   "where l_orderkey = o_orderkey group by 1 order by 1",
    "global_checksum": "select checksum(l_orderkey) c, "
                       "bool_and(l_shipdate < l_receiptdate) b, "
                       "bitwise_or_agg(l_suppkey) o, "
                       "geometric_mean(l_quantity) g from lineitem",
    "match_one_row": "select count(*) n, sum(mlen) s, max(mno) m, sum(fp) f, "
                     "sum(lp) l from orders match_recognize (" + MR_DEFINE
                     .format(measures="measures match_number() as mno, "
                             "count(*) as mlen, first(o_totalprice) as fp, "
                             "last(o_totalprice) as lp",
                             rows="one row per match"),
    "match_all_rows": "select count(*) n, sum(rcount) s, max(mno) m, "
                      "sum(price) p from orders match_recognize ("
                      + MR_DEFINE.format(
                          measures="measures match_number() as mno, "
                          "count(*) as rcount, o_totalprice as price",
                          rows="all rows per match"),
}
# DOUBLE results, held to a relative tolerance: the oracle computes them
# exactly and rounds once, the engine rounds a few times
AGGREGATES_PATTERNS_DOUBLE = ("moments", "global_checksum")
# the statements ``chip_smoke.py`` also streams, slice by slice
AGGREGATES_STREAMED = ("bool_bits_checksum", "moments")


def _strings(col) -> np.ndarray:
    """A dictionary column's strings per row (numpy unicode)."""
    return np.array([str(x) for x in col.dictionary])[np.asarray(col.values)]


def _nearest_rank(v: np.ndarray, q: float) -> int:
    """approx_percentile's exact nearest rank: the ceil(q n)-th smallest."""
    v = np.sort(v)
    return int(v[max(math.ceil(q * v.shape[0]) - 1, 0)])


def _corr_family(x: np.ndarray, y: np.ndarray, scale: int) -> dict:
    """corr, covar_samp, covar_pop, regr_slope, regr_intercept of y on x,
    two int64 columns of one decimal scale, exactly in rationals over
    exact sums, each rounded once to float64."""
    from fractions import Fraction
    n = x.shape[0]
    sx, sy = exact_sum(x), exact_sum(y)
    sxy, sxx, syy = (exact_sum(a * b) for a, b in ((x, y), (x, x), (y, y)))
    dxy, dxx, dyy = n * sxy - sx * sy, n * sxx - sx * sx, n * syy - sy * sy
    unit = 10 ** scale
    r2 = float(Fraction(dxy * dxy, dxx * dyy))
    return {"c": math.copysign(math.sqrt(r2), dxy),
            "cs": float(Fraction(dxy, n * (n - 1) * unit * unit)),
            "cp": float(Fraction(dxy, n * n * unit * unit)),
            "rs": float(Fraction(dxy, dxx)),
            "ri": float(Fraction(sy * sxx - sx * sxy, dxx * unit))}


def _geometric_mean(v: np.ndarray) -> float:
    return math.exp(math.fsum(np.log(v)) / v.shape[0])


def v_shape_matches(t: Tables):
    """The orders' D+U+ matches per customer (ordered by order key), by
    Python's ``re`` over one string of the rows' letters with a separator
    between customers: D a price below the row before's, U above it, X
    otherwise (a customer's first row: PREV is NULL).  Returns (sorted
    prices, start rows, lengths, the match's number in its customer)."""
    import re
    cust, okey = t.v("orders", "o_custkey"), t.v("orders", "o_orderkey")
    order = np.lexsort((okey, cust))
    c, p = cust[order], t.v("orders", "o_totalprice")[order]
    first = np.ones(c.shape[0], bool)
    first[1:] = c[1:] != c[:-1]
    prev = np.concatenate([[0], p[:-1]])
    letter = np.where(first, "X", np.where(p < prev, "D", np.where(
        p > prev, "U", "X")))
    # a "|" before each customer's first row; string position i + k holds
    # row i, k the customers started at or before it
    parts = np.where(first, np.char.add("|", letter), letter)
    text = "".join(parts.tolist())
    seps = np.cumsum(first)
    pos_row = np.full(len(text), -1, np.int64)
    pos_row[np.arange(c.shape[0]) + seps] = np.arange(c.shape[0])
    starts, lens = [], []
    for m in re.finditer(r"D+U+", text):
        starts.append(pos_row[m.start()])
        lens.append(m.end() - m.start())
    starts, lens = np.array(starts, np.int64), np.array(lens, np.int64)
    # numbered within the customer: the matches before, less those of
    # earlier customers
    cust_of = seps[starts]
    before = np.searchsorted(cust_of, cust_of, side="left")
    mno = np.arange(starts.shape[0]) - before + 1
    return p, starts, lens, mno


def aggregates_patterns(t: Tables) -> dict:
    """The ``AGGREGATES_PATTERNS`` statements' results: integers and
    percentiles exactly, checksums by ``checksum``, min_by/max_by as the
    first row in table order at the key's extreme, the corr family in
    exact rationals, geometric_mean from ``math.fsum`` logarithms."""
    li, od = "lineitem", "orders"
    t.preload(li, ("l_returnflag", "l_linestatus", "l_quantity",
                   "l_discount", "l_partkey", "l_suppkey", "l_orderkey",
                   "l_extendedprice", "l_shipmode", "l_linenumber",
                   "l_shipdate", "l_receiptdate"))
    out = {}
    rf, ls = _strings(t.col(li, "l_returnflag")), _strings(
        t.col(li, "l_linestatus"))
    qty, disc = t.v(li, "l_quantity"), t.v(li, "l_discount")
    pk, sk, lok = (t.v(li, c) for c in ("l_partkey", "l_suppkey",
                                         "l_orderkey"))
    keys = [(a, b) for a in np.unique(rf).tolist()
            for b in np.unique(ls).tolist() if ((rf == a) & (ls == b)).any()]
    cols = {c: [] for c in ("l_returnflag", "l_linestatus", "a", "b", "c",
                            "d", "e", "n")}
    for a, b in keys:
        g = (rf == a) & (ls == b)
        for c, v in zip(cols, (a, b, bool((qty[g] < 5000).all()),
                               bool((disc[g] > 9).any()),
                               int(np.bitwise_and.reduce(pk[g])),
                               int(np.bitwise_or.reduce(pk[g])),
                               checksum(lok[g]), int(g.sum()))):
            cols[c].append(v)
    out["bool_bits_checksum"] = cols
    ep = t.v(li, "l_extendedprice")
    cols = {c: [] for c in ("l_returnflag", "c", "cs", "cp", "rs", "ri",
                            "g")}
    for a in sorted(np.unique(rf).tolist()):
        g = rf == a
        cols["l_returnflag"].append(a)
        for c, v in _corr_family(qty[g], ep[g], 2).items():
            cols[c].append(v)
        cols["g"].append(_geometric_mean(qty[g] / 100.0))
    out["moments"] = cols
    mode = _strings(t.col(li, "l_shipmode"))
    modes = sorted(np.unique(mode).tolist())
    out["percentiles"] = {
        "l_shipmode": modes,
        "p": [_nearest_rank(ep[mode == m], 0.5) for m in modes],
        "q": [_nearest_rank(qty[mode == m], 0.9) for m in modes]}
    okey, date = t.v(od, "o_orderkey"), t.v(od, "o_orderdate")
    price = t.v(od, "o_totalprice")
    out["percentile_global"] = {"p": [_nearest_rank(price, 0.5)],
                                "d": [_nearest_rank(date, 0.99)]}
    prio = _strings(t.col(od, "o_orderpriority"))
    prios = sorted(np.unique(prio).tolist())

    def first_at(g, key, best):
        return int(np.flatnonzero(g & (key == best(key[g])))[0])
    out["min_by_date"] = {
        "o_orderpriority": prios,
        "a": [int(okey[first_at(prio == p, date, np.min)]) for p in prios],
        "b": [int(okey[first_at(prio == p, date, np.max)]) for p in prios]}
    row, found = lookup(okey, lok)
    key = pk * 67108864 + lok * 8 + t.v(li, "l_linenumber")
    lprio = np.where(found, prio[row], "")
    ship = t.v(li, "l_shipdate")
    cols = {"o_orderpriority": prios, "a": [], "b": [], "n": []}
    for p in prios:
        g = found & (lprio == p)
        cols["a"].append(int(price[row[first_at(g, key, np.min)]]))
        cols["b"].append(int(ship[first_at(g, key, np.max)]))
        cols["n"].append(int(g.sum()))
    out["min_by_join"] = cols
    out["global_checksum"] = {
        "c": [checksum(lok)],
        "b": [bool((ship < t.v(li, "l_receiptdate")).all())],
        "o": [int(np.bitwise_or.reduce(sk))],
        "g": [_geometric_mean(qty / 100.0)]}
    p, starts, lens, mno = v_shape_matches(t)
    ends = starts + lens - 1
    out["match_one_row"] = {"n": [int(starts.shape[0])],
                            "s": [int(lens.sum())], "m": [int(mno.max())],
                            "f": [exact_sum(p[starts])],
                            "l": [exact_sum(p[ends])]}
    covered = np.zeros(p.shape[0] + 1, np.int64)
    np.add.at(covered, starts, 1)
    np.add.at(covered, ends + 1, -1)
    inside = np.cumsum(covered)[:-1] > 0
    out["match_all_rows"] = {"n": [int(lens.sum())],
                             "s": [int((lens * (lens + 1) // 2).sum())],
                             "m": [int(mno.max())],
                             "p": [exact_sum(p[inside])]}
    return out


# the ``nested`` phase: ARRAY, MAP and ROW values, UNNEST and the
# nested-value aggregates (``chip_smoke.nested_phase``)
SPLIT_NAME = "split(p_name, ' ')"
NESTED = {
    # 200,000 names into 1,000,000 words at SF1
    "split_unnest": "select w, count(*) c from part cross join unnest("
                    + SPLIT_NAME + ") as t(w) group by w "
                    "order by c desc, w limit 20",
    "unnest_ordinality": "select pos, count(*) c, count(distinct w) d "
                         "from part cross join unnest(" + SPLIT_NAME
                         + ") with ordinality as t(w, pos) group by pos "
                         "order by pos",
    # global BIGINT sums: masked_sum
    "array_sums": "select sum(case when contains(" + SPLIT_NAME
                  + ", 'green') then 1 else 0 end) g, "
                  "sum(cardinality(array_distinct(" + SPLIT_NAME + "))) d, "
                  "sum(array_position(" + SPLIT_NAME + ", 'red')) r "
                  "from part",
    # strings compared and sorted by string across two dictionaries
    "set_ops": "select array_join(array_sort(array_intersect(" + SPLIT_NAME
               + ", array['green', 'red', 'blue'])), ',') s, count(*) c "
               "from part group by 1 order by 1",
    "array_agg_orders": "select o_custkey, "
                        "cardinality(array_agg(o_orderkey)) n, "
                        "element_at(array_sort(array_agg(o_orderkey)), 1) f,"
                        " array_max(array_agg(o_totalprice)) m from orders "
                        "group by o_custkey order by n desc, o_custkey "
                        "limit 20",
    # lineitem ⋈ orders: sorted_probe
    "histogram_join": "select o_orderpriority, histogram(l_shipmode) h "
                      "from lineitem, orders where l_orderkey = o_orderkey "
                      "group by o_orderpriority order by o_orderpriority",
    "top_n": "select l_returnflag, max(l_extendedprice, 3) p, "
             "min(l_shipdate, 2) d, max(l_shipmode, 2) m from lineitem "
             "group by l_returnflag order by l_returnflag",
    "map_agg_region": "select r_name, element_at(map_agg(n_name, "
                      "n_nationkey), 'PERU') p, max(n_name, 2) m "
                      "from nation, region where n_regionkey = r_regionkey "
                      "group by r_name order by r_name",
    "row_fold": "select cast(row(o_orderkey, o_orderpriority) as "
                "row(k bigint, p varchar)) r from orders "
                "where o_orderkey <= 1000 order by o_orderkey",
}


def _top(rows, key, n=None) -> dict:
    """Column lists of ``rows`` (tuples) sorted by ``key``, the first
    ``n``."""
    rows = sorted(rows, key=key)[:n]
    return [list(c) for c in zip(*rows)] if rows else []


def nested(t: Tables) -> dict:
    """The ``NESTED`` statements' results, by Python over the part names'
    words and numpy over the orders and lineitem columns."""
    li, od = "lineitem", "orders"
    out = {}
    words = [str(s).split(" ") for s in t.s("part", "p_name")]
    from collections import Counter
    cnt = Counter(w for ws in words for w in ws)
    w, c = _top(cnt.items(), lambda x: (-x[1], x[0]), 20)
    out["split_unnest"] = {"w": w, "c": c}
    deepest = max(len(ws) for ws in words)
    out["unnest_ordinality"] = {
        "pos": list(range(1, deepest + 1)),
        "c": [sum(len(ws) > i for ws in words) for i in range(deepest)],
        "d": [len({ws[i] for ws in words if len(ws) > i})
              for i in range(deepest)]}
    out["array_sums"] = {
        "g": [sum("green" in ws for ws in words)],
        "d": [sum(len(set(ws)) for ws in words)],
        "r": [sum(ws.index("red") + 1 for ws in words if "red" in ws)]}
    pick = ("green", "red", "blue")
    sets = Counter(",".join(sorted({x for x in ws if x in pick}))
                   for ws in words)
    s, c = _top(sets.items(), lambda x: x[0])
    out["set_ops"] = {"s": s, "c": c}
    t.preload(od, ("o_orderkey", "o_custkey", "o_totalprice",
                   "o_orderpriority"))
    okey, cust = t.v(od, "o_orderkey"), t.v(od, "o_custkey")
    price = t.v(od, "o_totalprice")
    order = np.lexsort((okey, cust))
    cs = cust[order]
    starts = np.flatnonzero(np.r_[True, cs[1:] != cs[:-1]])
    n = np.diff(np.r_[starts, cs.shape[0]])
    first = okey[order][starts]
    top = np.maximum.reduceat(price[order], starts)
    rows = zip(cs[starts].tolist(), n.tolist(), first.tolist(), top.tolist())
    k, n, f, m = _top(rows, lambda x: (-x[1], x[0]), 20)
    out["array_agg_orders"] = {"o_custkey": k, "n": n, "f": f, "m": m}
    t.preload(li, ("l_orderkey", "l_shipmode", "l_returnflag",
                   "l_extendedprice", "l_shipdate"))
    row, found = lookup(okey, t.v(li, "l_orderkey"))
    prio = _strings(t.col(od, "o_orderpriority"))
    mode = _strings(t.col(li, "l_shipmode"))
    lprio = prio[row[found]]
    pairs = Counter(zip(lprio.tolist(), mode[found].tolist()))
    prios = sorted(set(lprio.tolist()))
    out["histogram_join"] = {
        "o_orderpriority": prios,
        "h": [{md: c for (p, md), c in pairs.items() if p == pr}
              for pr in prios]}
    flag = _strings(t.col(li, "l_returnflag"))
    ep, ship = t.v(li, "l_extendedprice"), t.v(li, "l_shipdate")
    flags = sorted(set(flag.tolist()))
    out["top_n"] = {
        "l_returnflag": flags,
        "p": [np.sort(ep[flag == x])[::-1][:3].tolist() for x in flags],
        "d": [np.sort(ship[flag == x])[:2].tolist() for x in flags],
        "m": [sorted(mode[flag == x].tolist(), reverse=True)[:2]
              for x in flags]}
    nname = t.s("nation", "n_name").tolist()
    nkey = t.v("nation", "n_nationkey").tolist()
    nreg = t.v("nation", "n_regionkey").tolist()
    rname = dict(zip(t.v("region", "r_regionkey").tolist(),
                     t.s("region", "r_name").tolist()))
    regions = sorted({rname[r] for r in nreg})
    members = {rg: [(nm, k) for nm, k, r in zip(nname, nkey, nreg)
                    if rname[r] == rg] for rg in regions}
    out["map_agg_region"] = {
        "r_name": regions,
        "p": [dict(members[rg]).get("PERU") for rg in regions],
        "m": [sorted((nm for nm, _ in members[rg]), reverse=True)[:2]
              for rg in regions]}
    low = np.flatnonzero(okey <= 1000)
    low = low[np.argsort(okey[low], kind="stable")]
    out["row_fold"] = {"r": [{"k": int(okey[i]), "p": str(prio[i])}
                             for i in low]}
    return out
