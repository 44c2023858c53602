"""SQLite as the oracle of TPC-DS queries over ``presto_tpu_torch``'s
generated tables.

The tables come from a data source with the TPC-DS connector registered
(``DataSource.read_host``), only the columns the given queries name.  They
go into an in-memory SQLite database in value space: decimals as floats
(v / 10^s), dates as epoch days, strings as ``str``, NULLs as ``None``.
SQLite has no typed date literals, no ``stddev_samp`` and no parenthesised
compound-select operands, so the texts are rewritten (``sqlite_sql``) and
the sample standard deviation is registered as a Python aggregate.

The comparison (``compare``) is the rule of the JAX package's TPC-DS
battery: outside ``FUZZY`` the rows as a multiset, numbers rounded to 4
places; inside it, the same row count and at least 95 % of the rows equal
at 6 significant digits.  ``check`` adds to it the rows tied at a LIMIT
boundary, which SQLite cuts differently from one version to the next.
``same_table`` holds two engines' results to each other in row order,
DOUBLE values to a relative tolerance.

    import sqlite_tpcds_oracle as SO       # with tools/ on sys.path
    db = SO.build_db(runner.datasource, texts)
    SO.check(db, qid, sql, runner.run_sql(sql))

Imports neither ``jax`` nor ``presto_tpu``: ``chip_smoke.py`` and
``tests/test_torch_tpcds.py`` share it.
"""

from __future__ import annotations

import datetime as dt
import math
import re
import sqlite3
from collections import Counter

import numpy as np

DICT, BYTES = "dict", "bytes"


def _raw(col) -> list:
    """A host column as value-space Python values."""
    valid = None if col.validity is None else np.asarray(col.validity)

    def mask(vals):
        if valid is None:
            return list(vals)
        return [v if ok else None for v, ok in zip(vals, valid)]

    if col.kind == DICT:
        return mask([str(col.dictionary[c]) for c in np.asarray(col.values)])
    if col.kind == BYTES:
        return col.to_pylist()
    scale = getattr(col.dtype, "scale", None)
    if scale is not None:
        s = 10 ** scale
        return mask([int(v) / s for v in np.asarray(col.values)])
    return mask([int(v) for v in np.asarray(col.values)])


class _StddevSamp:
    """The sample standard deviation as a SQLite aggregate."""

    def __init__(self):
        self.vals = []

    def step(self, v):
        if v is not None:
            self.vals.append(float(v))

    def finalize(self):
        n = len(self.vals)
        if n < 2:
            return None
        m = sum(self.vals) / n
        return (sum((x - m) ** 2 for x in self.vals) / (n - 1)) ** 0.5


def build_db(ds, texts) -> sqlite3.Connection:
    """An in-memory database of every TPC-DS table, each with only the
    columns that a word of ``texts`` names (SQL texts, rewritten ones
    included), read from the data source ``ds``."""
    from presto_tpu_torch.tpcds import schema as S
    words = set(re.findall(r"[a-z_0-9]+", " ".join(texts).lower()))
    conn = sqlite3.connect(":memory:")
    for t, cols in S.TABLE_SCHEMAS.items():
        names = [c for c, _ in cols if c in words] or [cols[0][0]]
        host = ds.read_host(t, names)
        conn.execute(f"CREATE TABLE {t} ({', '.join(names)})")
        conn.executemany(
            f"INSERT INTO {t} VALUES ({', '.join('?' * len(names))})",
            zip(*[_raw(host[c]) for c in names]))
    conn.commit()
    conn.create_aggregate("stddev_samp", 1, _StddevSamp)
    return conn


def _days(m) -> str:
    y, mo, d = int(m.group(1)), int(m.group(2)), int(m.group(3))
    return str((dt.date(y, mo, d) - dt.date(1970, 1, 1)).days)


def sqlite_sql(qid: int, sql: str) -> str:
    """The text SQLite runs for query ``qid``: its rewrite where it has
    one, ``date 'YYYY-MM-DD'`` as the epoch day."""
    return re.sub(r"date '(\d+)-(\d+)-(\d+)'", _days,
                  SQLITE_REWRITE.get(qid, sql))


def run(conn: sqlite3.Connection, qid: int, sql: str) -> list:
    return conn.execute(sqlite_sql(qid, sql)).fetchall()


def engine_rows(table) -> list:
    """An engine's result Table as value-space rows (decimals as floats)."""
    cols = []
    for n in table.names:
        c = table.columns[n]
        vals = c.to_pylist()
        scale = getattr(c.dtype, "scale", None)
        if scale is not None:
            vals = [None if v is None else v / 10 ** scale for v in vals]
        cols.append(vals)
    return list(zip(*cols)) if cols else []


def _norm_rows(rows) -> list:
    """Rows with every number as a float rounded to 4 places."""
    return [tuple(round(float(v), 4)
                  if isinstance(v, (bool, int, float, np.integer))
                  else v for v in r) for r in rows]


def _norm(rows) -> list:
    return sorted(map(repr, _norm_rows(rows)))


def _canon(rows) -> Counter:
    def c(v):
        if isinstance(v, (int, float, np.integer)):
            return round(float(f"{float(v):.6g}"), 1)
        return v
    return Counter(tuple(c(v) for v in r) for r in rows)


def compare(qid: int, got, want_rows: list, fuzzy=None) -> int:
    """Raise AssertionError unless the engine's Table ``got`` equals
    SQLite's rows under the battery's rule (``fuzzy`` defaults to
    ``qid in FUZZY``); returns the row count."""
    from presto_tpu_torch.tpcds.queries import FUZZY
    got_rows = engine_rows(got)
    if fuzzy is None:
        fuzzy = qid in FUZZY
    if not fuzzy:
        if _norm(got_rows) != _norm(want_rows):
            g, w = _norm(got_rows), _norm(want_rows)
            raise AssertionError(
                f"q{qid}: {len(got_rows)} rows, SQLite {len(want_rows)}; "
                f"first differing: {sorted(set(g) - set(w))[:2]} vs "
                f"{sorted(set(w) - set(g))[:2]}")
        return len(got_rows)
    if len(got_rows) != len(want_rows):
        raise AssertionError(f"q{qid}: {len(got_rows)} rows, SQLite "
                             f"{len(want_rows)}")
    if got_rows:
        cg, ce = _canon(got_rows), _canon(want_rows)
        overlap = sum((cg & ce).values())
        if overlap < max(1, int(0.95 * len(got_rows))):
            raise AssertionError(
                f"q{qid}: {overlap}/{len(got_rows)} rows match; "
                f"{list((cg - ce).items())[:3]} vs "
                f"{list((ce - cg).items())[:3]}")
    return len(got_rows)


_LIMIT = re.compile(r"\s+limit\s+(\d+)\s*$", re.I)


def _order_keys(sql: str, names) -> tuple:
    """(output column positions of the outermost ORDER BY, its LIMIT n),
    or None when the text does not end in ``ORDER BY <items> LIMIT n`` or
    an item is not an output column."""
    limit = _LIMIT.search(sql)
    at = sql.lower().rfind("order by")
    if limit is None or at < 0:
        return None
    keys = []
    for item in sql[at + len("order by"):limit.start()].split(","):
        words = item.split()
        name = words[0].split(".")[-1].lower() if words else ""
        if len(words) > 2 or name not in names or (
                len(words) == 2 and words[1].lower() not in ("asc", "desc")):
            return None
        keys.append(names.index(name))
    return tuple(keys), int(limit.group(1))


def check(conn: sqlite3.Connection, qid: int, sql: str, got) -> dict:
    """``compare`` against SQLite's rows.  Where that fails on a query
    outside ``FUZZY`` that ends in ``ORDER BY <output columns> LIMIT n``,
    the rows may differ only among the ORDER BY values tied at the LIMIT
    boundary, which engines cut differently (SQLite's own versions do):
    then the engine's rows must be a sub-multiset of SQLite's rows
    without the LIMIT, and their ORDER BY values the multiset of SQLite's
    first n rows'.  Returns the row count and whether that tie rule was
    needed."""
    from presto_tpu_torch.tpcds.queries import FUZZY
    try:
        return {"rows": compare(qid, got, run(conn, qid, sql)),
                "tie_at_limit": False}
    except AssertionError:
        keys = None if qid in FUZZY or qid in SQLITE_REWRITE else \
            _order_keys(sql.strip(), [n.lower() for n in got.names])
        if keys is None:
            raise
    cols, n = keys
    full = _norm_rows(run(conn, qid, _LIMIT.sub("", sql.strip())))
    rows = _norm_rows(engine_rows(got))
    extra = Counter(rows) - Counter(full)
    if len(rows) != min(n, len(full)) or extra:
        raise AssertionError(
            f"q{qid}: {len(rows)} rows, not {min(n, len(full))} of "
            f"SQLite's {len(full)} without the LIMIT; not among them: "
            f"{list(extra)[:2]}")
    got_keys = Counter(tuple(r[i] for i in cols) for r in rows)
    want_keys = Counter(tuple(r[i] for i in cols) for r in full[:n])
    if got_keys != want_keys:
        raise AssertionError(
            f"q{qid}: ORDER BY values differ from SQLite's first {n} rows: "
            f"{list(got_keys - want_keys)[:2]} vs "
            f"{list(want_keys - got_keys)[:2]}")
    return {"rows": len(rows), "tie_at_limit": True}



def same_table(got, want, rel: float = 1e-9, label: str = "") -> None:
    """Raise AssertionError unless two engines' result Tables (this
    port's, or the JAX package's) are equal in row order: the same column
    names and types, every value exactly equal, except floats (DOUBLE
    values), held to ``rel`` relative; a NULL equals only a NULL."""
    def close(a, b) -> bool:
        if isinstance(a, float) or isinstance(b, float):
            if a is None or b is None:
                return a is b
            return a == b or math.isclose(a, b, rel_tol=rel, abs_tol=0.0)
        return a == b

    if list(got.columns) != list(want.columns):
        raise AssertionError(f"{label}: columns {list(got.columns)} != "
                             f"{list(want.columns)}")
    for name, col in got.columns.items():
        other = want.columns[name]
        if str(col.dtype) != str(other.dtype):
            raise AssertionError(f"{label}: column {name}: type {col.dtype}"
                                 f" != {other.dtype}")
        g, w = col.to_pylist(), other.to_pylist()
        bad = [(i, a, b) for i, (a, b) in enumerate(zip(g, w))
               if not close(a, b)]
        if len(g) != len(w) or bad:
            raise AssertionError(f"{label}: column {name}: {len(g)} vs "
                                 f"{len(w)} rows, first differences "
                                 f"{bad[:3]}")

# SQLite runs these texts in place of the queries': the same results,
# written in what SQLite accepts (copied from the JAX package's battery)
SQLITE_REWRITE = {
    72: """
select i_item_desc, w_warehouse_name, d1.d_week_seq,
       sum(case when p_promo_sk is null then 1 else 0 end) no_promo,
       sum(case when p_promo_sk is not null then 1 else 0 end) promo,
       count(*) total_cnt
from catalog_sales
  inner join inventory on cs_item_sk = inv_item_sk
  inner join warehouse on w_warehouse_sk = inv_warehouse_sk
  inner join item on i_item_sk = cs_item_sk
  inner join customer_demographics on cs_bill_cdemo_sk = cd_demo_sk
  inner join household_demographics on cs_bill_hdemo_sk = hd_demo_sk
  inner join date_dim d1 on cs_sold_date_sk = d1.d_date_sk
  inner join date_dim d2 on inv_date_sk = d2.d_date_sk
  inner join date_dim d3 on cs_ship_date_sk = d3.d_date_sk
  left join promotion on cs_promo_sk = p_promo_sk
  left join catalog_returns on cr_item_sk = cs_item_sk
    and cr_order_number = cs_order_number
where d1.d_week_seq = d2.d_week_seq
  and inv_quantity_on_hand < cs_quantity
  and d3.d_date > d1.d_date + 5
  and hd_buy_potential = '>10000'
  and d1.d_year = 1999 and cd_marital_status = 'D'
group by i_item_desc, w_warehouse_name, d1.d_week_seq
order by total_cnt desc, i_item_desc, w_warehouse_name, d1.d_week_seq
limit 100
""",
    # SQLite has no ROLLUP and no grouping(): each of these is the
    # union-all expansion of the query's grouping sets, NULLs ordered last
    # with ``x is null, x``
    5: """
with ssr as (
  select s_store_id, sum(sales_price) sales, sum(profit) profit,
         sum(return_amt) returns, sum(net_loss) profit_loss
  from (select ss_store_sk store_sk, ss_sold_date_sk date_sk,
               ss_ext_sales_price sales_price, ss_net_profit profit,
               0.0 return_amt, 0.0 net_loss
        from store_sales
        union all
        select sr_store_sk store_sk, sr_returned_date_sk date_sk,
               0.0 sales_price, 0.0 profit, sr_return_amt return_amt,
               sr_net_loss net_loss
        from store_returns) salesreturns, date_dim, store
  where date_sk = d_date_sk
    and d_date between date '2000-08-23' and date '2000-09-06'
    and store_sk = s_store_sk
  group by s_store_id),
 csr as (
  select cp_catalog_page_id, sum(sales_price) sales, sum(profit) profit,
         sum(return_amt) returns, sum(net_loss) profit_loss
  from (select cs_catalog_page_sk page_sk, cs_sold_date_sk date_sk,
               cs_ext_sales_price sales_price, cs_net_profit profit,
               0.0 return_amt, 0.0 net_loss
        from catalog_sales
        union all
        select cr_catalog_page_sk page_sk, cr_returned_date_sk date_sk,
               0.0 sales_price, 0.0 profit, cr_return_amount return_amt,
               cr_net_loss net_loss
        from catalog_returns) salesreturns, date_dim, catalog_page
  where date_sk = d_date_sk
    and d_date between date '2000-08-23' and date '2000-09-06'
    and page_sk = cp_catalog_page_sk
  group by cp_catalog_page_id),
 wsr as (
  select web_site_id, sum(sales_price) sales, sum(profit) profit,
         sum(return_amt) returns, sum(net_loss) profit_loss
  from (select ws_web_site_sk wsr_web_site_sk, ws_sold_date_sk date_sk,
               ws_ext_sales_price sales_price, ws_net_profit profit,
               0.0 return_amt, 0.0 net_loss
        from web_sales
        union all
        select ws_web_site_sk wsr_web_site_sk,
               wr_returned_date_sk date_sk, 0.0 sales_price, 0.0 profit,
               wr_return_amt return_amt, wr_net_loss net_loss
        from web_returns left join web_sales
             on wr_item_sk = ws_item_sk
             and wr_order_number = ws_order_number) salesreturns,
       date_dim, web_site
  where date_sk = d_date_sk
    and d_date between date '2000-08-23' and date '2000-09-06'
    and wsr_web_site_sk = web_site_sk
  group by web_site_id)
select * from (select channel, id, sum(sales) sales, sum(returns) returns,
       sum(profit) profit
from (select 'store channel' channel, ('store' || s_store_id) id,
             sales, returns, profit - profit_loss profit
      from ssr
      union all
      select 'catalog channel' channel,
             ('catalog_page' || cp_catalog_page_id) id,
             sales, returns, profit - profit_loss profit
      from csr
      union all
      select 'web channel' channel,
             ('web_site' || web_site_id) id,
             sales, returns, profit - profit_loss profit
      from wsr) x
group by channel, id
union all
select channel, null, sum(sales), sum(returns), sum(profit)
from (select 'store channel' channel, ('store' || s_store_id) id, sales, returns, profit - profit_loss profit from ssr
 union all select 'catalog channel', ('catalog_page' || cp_catalog_page_id), sales, returns, profit - profit_loss from csr
 union all select 'web channel', ('web_site' || web_site_id), sales, returns, profit - profit_loss from wsr) x2
group by channel
union all
select null, null, sum(sales), sum(returns), sum(profit)
from (select 'store channel' channel, ('store' || s_store_id) id, sales, returns, profit - profit_loss profit from ssr
 union all select 'catalog channel', ('catalog_page' || cp_catalog_page_id), sales, returns, profit - profit_loss from csr
 union all select 'web channel', ('web_site' || web_site_id), sales, returns, profit - profit_loss from wsr) x3)
order by channel is null, channel, id is null, id
limit 100
""",
    14: """
with cross_items as (
  select i_item_sk ss_item_sk
  from item,
       (select iss.i_brand_id brand_id, iss.i_class_id class_id,
               iss.i_category_id category_id
        from store_sales, item iss, date_dim d1
        where ss_item_sk = iss.i_item_sk
          and ss_sold_date_sk = d1.d_date_sk
          and d1.d_year between 1999 and 2001
        intersect
        select ics.i_brand_id, ics.i_class_id, ics.i_category_id
        from catalog_sales, item ics, date_dim d2
        where cs_item_sk = ics.i_item_sk
          and cs_sold_date_sk = d2.d_date_sk
          and d2.d_year between 1999 and 2001
        intersect
        select iws.i_brand_id, iws.i_class_id, iws.i_category_id
        from web_sales, item iws, date_dim d3
        where ws_item_sk = iws.i_item_sk
          and ws_sold_date_sk = d3.d_date_sk
          and d3.d_year between 1999 and 2001) bcc
  where i_brand_id = brand_id and i_class_id = class_id
    and i_category_id = category_id),
 avg_sales as (
  select avg(quantity * list_price) average_sales
  from (select ss_quantity quantity, ss_list_price list_price
        from store_sales, date_dim
        where ss_sold_date_sk = d_date_sk
          and d_year between 1999 and 2001
        union all
        select cs_quantity quantity, cs_list_price list_price
        from catalog_sales, date_dim
        where cs_sold_date_sk = d_date_sk
          and d_year between 1999 and 2001
        union all
        select ws_quantity quantity, ws_list_price list_price
        from web_sales, date_dim
        where ws_sold_date_sk = d_date_sk
          and d_year between 1999 and 2001) x)
, y as (select 'store' channel, i_brand_id, i_class_id, i_category_id,
             sum(ss_quantity * ss_list_price) sales,
             count(*) number_sales
      from store_sales, item, date_dim
      where ss_item_sk in (select ss_item_sk from cross_items)
        and ss_item_sk = i_item_sk and ss_sold_date_sk = d_date_sk
        and d_year = 2001 and d_moy = 11
      group by i_brand_id, i_class_id, i_category_id
      having sum(ss_quantity * ss_list_price) >
             (select average_sales from avg_sales)
      union all
      select 'catalog' channel, i_brand_id, i_class_id, i_category_id,
             sum(cs_quantity * cs_list_price) sales,
             count(*) number_sales
      from catalog_sales, item, date_dim
      where cs_item_sk in (select ss_item_sk from cross_items)
        and cs_item_sk = i_item_sk and cs_sold_date_sk = d_date_sk
        and d_year = 2001 and d_moy = 11
      group by i_brand_id, i_class_id, i_category_id
      having sum(cs_quantity * cs_list_price) >
             (select average_sales from avg_sales)
      union all
      select 'web' channel, i_brand_id, i_class_id, i_category_id,
             sum(ws_quantity * ws_list_price) sales,
             count(*) number_sales
      from web_sales, item, date_dim
      where ws_item_sk in (select ss_item_sk from cross_items)
        and ws_item_sk = i_item_sk and ws_sold_date_sk = d_date_sk
        and d_year = 2001 and d_moy = 11
      group by i_brand_id, i_class_id, i_category_id
      having sum(ws_quantity * ws_list_price) >
             (select average_sales from avg_sales))
select * from (
select channel, i_brand_id, i_class_id, i_category_id, sum(sales) sum_sales, sum(number_sales) sum_number_sales from y group by channel, i_brand_id, i_class_id, i_category_id
union all
select channel, i_brand_id, i_class_id, null, sum(sales) sum_sales, sum(number_sales) sum_number_sales from y group by channel, i_brand_id, i_class_id
union all
select channel, i_brand_id, null, null, sum(sales) sum_sales, sum(number_sales) sum_number_sales from y group by channel, i_brand_id
union all
select channel, null, null, null, sum(sales) sum_sales, sum(number_sales) sum_number_sales from y group by channel
union all
select null, null, null, null, sum(sales) sum_sales, sum(number_sales) sum_number_sales from y)
order by channel is null, channel, i_brand_id is null, i_brand_id, i_class_id is null, i_class_id, i_category_id is null, i_category_id
limit 100""",
    18: """
with base as (
  select i_item_id, ca_country, ca_state, ca_county,
         cs_quantity q, cs_list_price lp, cs_coupon_amt ca_amt,
         cs_sales_price sp, cs_net_profit np, c_birth_year by_,
         cd1.cd_dep_count dc
  from catalog_sales, customer_demographics cd1,
       customer_demographics cd2, customer, customer_address, date_dim,
       item
  where cs_sold_date_sk = d_date_sk and cs_item_sk = i_item_sk
    and cs_bill_cdemo_sk = cd1.cd_demo_sk
    and cs_bill_customer_sk = c_customer_sk
    and cd1.cd_gender = 'F' and cd1.cd_education_status = 'Unknown'
    and c_current_cdemo_sk = cd2.cd_demo_sk
    and c_current_addr_sk = ca_address_sk
    and c_birth_month in (1, 6, 8, 9, 12, 2)
    and d_year = 1998
    and ca_state in ('MS', 'IN', 'ND', 'OK', 'NM', 'VA', 'MS'))
select * from (
  select i_item_id, ca_country, ca_state, ca_county, avg(q) agg1,
         avg(lp) agg2, avg(ca_amt) agg3, avg(sp) agg4, avg(np) agg5,
         avg(by_) agg6, avg(dc) agg7
  from base group by i_item_id, ca_country, ca_state, ca_county
  union all
  select i_item_id, ca_country, ca_state, null, avg(q), avg(lp),
         avg(ca_amt), avg(sp), avg(np), avg(by_), avg(dc)
  from base group by i_item_id, ca_country, ca_state
  union all
  select i_item_id, ca_country, null, null, avg(q), avg(lp), avg(ca_amt),
         avg(sp), avg(np), avg(by_), avg(dc)
  from base group by i_item_id, ca_country
  union all
  select i_item_id, null, null, null, avg(q), avg(lp), avg(ca_amt),
         avg(sp), avg(np), avg(by_), avg(dc)
  from base group by i_item_id
  union all
  select null, null, null, null, avg(q), avg(lp), avg(ca_amt), avg(sp),
         avg(np), avg(by_), avg(dc)
  from base)
order by ca_country is null, ca_country, ca_state is null, ca_state,
         ca_county is null, ca_county, i_item_id is null, i_item_id
limit 100
""",
    22: """
with base as (
  select i_product_name, i_brand, i_class, i_category,
         inv_quantity_on_hand qoh
  from inventory, date_dim, item
  where inv_date_sk = d_date_sk and inv_item_sk = i_item_sk
    and d_month_seq between 1200 and 1211)
select * from (
  select i_product_name, i_brand, i_class, i_category, avg(qoh) qoh
  from base group by i_product_name, i_brand, i_class, i_category
  union all
  select i_product_name, i_brand, i_class, null, avg(qoh)
  from base group by i_product_name, i_brand, i_class
  union all
  select i_product_name, i_brand, null, null, avg(qoh)
  from base group by i_product_name, i_brand
  union all
  select i_product_name, null, null, null, avg(qoh)
  from base group by i_product_name
  union all
  select null, null, null, null, avg(qoh) from base)
order by qoh, i_product_name is null, i_product_name, i_brand is null,
         i_brand, i_class is null, i_class, i_category is null, i_category
limit 100
""",
    27: """
with base as (
  select i_item_id, s_state, ss_quantity, ss_list_price,
         ss_coupon_amt, ss_sales_price
  from store_sales, customer_demographics, date_dim, store, item
  where ss_sold_date_sk = d_date_sk and ss_item_sk = i_item_sk
    and ss_store_sk = s_store_sk and ss_cdemo_sk = cd_demo_sk
    and cd_gender = 'M' and cd_marital_status = 'S'
    and cd_education_status = 'College' and d_year = 2002)
select * from (
  select i_item_id, s_state, 0 g_state, avg(ss_quantity) agg1,
         avg(ss_list_price) agg2, avg(ss_coupon_amt) agg3,
         avg(ss_sales_price) agg4
  from base group by i_item_id, s_state
  union all
  select i_item_id, null, 1, avg(ss_quantity), avg(ss_list_price),
         avg(ss_coupon_amt), avg(ss_sales_price)
  from base group by i_item_id
  union all
  select null, null, 1, avg(ss_quantity), avg(ss_list_price),
         avg(ss_coupon_amt), avg(ss_sales_price)
  from base)
order by i_item_id is null, i_item_id, s_state is null, s_state
limit 100
""",
    36: """
with base as (
  select ss_net_profit np, ss_ext_sales_price sp, i_category, i_class
  from store_sales, date_dim, item, store
  where d_year = 2001 and d_date_sk = ss_sold_date_sk
    and i_item_sk = ss_item_sk and s_store_sk = ss_store_sk
    and s_state in ('TN', 'KY')),
 lv as (
  select i_category, i_class, 0 loch,
         sum(np) * 1.0 / sum(sp) gm
  from base group by i_category, i_class
  union all
  select i_category, null, 1, sum(np) * 1.0 / sum(sp)
  from base group by i_category
  union all
  select null, null, 2, sum(np) * 1.0 / sum(sp) from base)
select gm gross_margin, i_category, i_class, loch lochierarchy,
       rank() over (
         partition by loch, case when loch = 0 then i_category end
         order by gm asc) rank_within_parent
from lv
order by loch desc, rank_within_parent
limit 100
""",
    67: """with base as (
  select i_category, i_class, i_brand, i_product_name, d_year, d_qoy,
         d_moy, s_store_id,
         coalesce(ss_sales_price * ss_quantity, 0) v
  from store_sales, date_dim, store, item
  where ss_sold_date_sk = d_date_sk and ss_item_sk = i_item_sk
    and ss_store_sk = s_store_sk and d_month_seq between 1200 and 1211
)
select * from (
  select i_category, i_class, i_brand, i_product_name, d_year, d_qoy, d_moy, s_store_id, sumsales,
         rank() over (partition by i_category order by sumsales desc) rk
  from (select i_category, i_class, i_brand, i_product_name, d_year, d_qoy, d_moy, s_store_id, sum(v) sumsales from base group by i_category, i_class, i_brand, i_product_name, d_year, d_qoy, d_moy, s_store_id
union all
select i_category, i_class, i_brand, i_product_name, d_year, d_qoy, d_moy, null, sum(v) sumsales from base group by i_category, i_class, i_brand, i_product_name, d_year, d_qoy, d_moy
union all
select i_category, i_class, i_brand, i_product_name, d_year, d_qoy, null, null, sum(v) sumsales from base group by i_category, i_class, i_brand, i_product_name, d_year, d_qoy
union all
select i_category, i_class, i_brand, i_product_name, d_year, null, null, null, sum(v) sumsales from base group by i_category, i_class, i_brand, i_product_name, d_year
union all
select i_category, i_class, i_brand, i_product_name, null, null, null, null, sum(v) sumsales from base group by i_category, i_class, i_brand, i_product_name
union all
select i_category, i_class, i_brand, null, null, null, null, null, sum(v) sumsales from base group by i_category, i_class, i_brand
union all
select i_category, i_class, null, null, null, null, null, null, sum(v) sumsales from base group by i_category, i_class
union all
select i_category, null, null, null, null, null, null, null, sum(v) sumsales from base group by i_category
union all
select null, null, null, null, null, null, null, null, sum(v) sumsales from base) dw1) dw2
where rk <= 100
order by i_category is null, i_category, i_class is null, i_class, i_brand is null, i_brand, i_product_name is null, i_product_name, d_year is null, d_year, d_qoy is null, d_qoy, d_moy is null, d_moy, s_store_id is null, s_store_id, sumsales, rk
limit 100""",
    70: """
with base as (
  select ss_net_profit np, s_state, s_county
  from store_sales, date_dim d1, store
  where d1.d_month_seq between 1200 and 1211
    and d1.d_date_sk = ss_sold_date_sk and s_store_sk = ss_store_sk
    and s_state in (select s_state
                    from (select s_state s_state,
                                 rank() over (partition by s_state
                                   order by sum(ss_net_profit) desc) ranking
                          from store_sales, store, date_dim
                          where d_month_seq between 1200 and 1211
                            and d_date_sk = ss_sold_date_sk
                            and s_store_sk = ss_store_sk
                          group by s_state) tmp1
                    where ranking <= 5)),
 lv as (
  select sum(np) total_sum, s_state, s_county, 0 lochierarchy, 0 gc
  from base group by s_state, s_county
  union all
  select sum(np), s_state, null, 1, 1 from base group by s_state
  union all
  select sum(np), null, null, 2, 1 from base)
select total_sum, s_state, s_county, lochierarchy,
       rank() over (partition by lochierarchy,
                    case when gc = 0 then s_state end
                    order by total_sum desc) rank_within_parent
from lv
order by lochierarchy desc,
         case when lochierarchy = 0 then s_state end,
         rank_within_parent
limit 100
""",
    77: """
with ss as (
  select s_store_sk, sum(ss_ext_sales_price) sales,
         sum(ss_net_profit) profit
  from store_sales, date_dim, store
  where ss_sold_date_sk = d_date_sk
    and d_date between date '2000-08-23' and date '2000-09-22'
    and ss_store_sk = s_store_sk
  group by s_store_sk),
 sr as (
  select s_store_sk, sum(sr_return_amt) returns,
         sum(sr_net_loss) profit_loss
  from store_returns, date_dim, store
  where sr_returned_date_sk = d_date_sk
    and d_date between date '2000-08-23' and date '2000-09-22'
    and sr_store_sk = s_store_sk
  group by s_store_sk),
 cs as (
  select cs_call_center_sk, sum(cs_ext_sales_price) sales,
         sum(cs_net_profit) profit
  from catalog_sales, date_dim
  where cs_sold_date_sk = d_date_sk
    and d_date between date '2000-08-23' and date '2000-09-22'
  group by cs_call_center_sk),
 cr as (
  select cr_call_center_sk, sum(cr_return_amount) returns,
         sum(cr_net_loss) profit_loss
  from catalog_returns, date_dim
  where cr_returned_date_sk = d_date_sk
    and d_date between date '2000-08-23' and date '2000-09-22'
  group by cr_call_center_sk),
 ws as (
  select wp_web_page_sk, sum(ws_ext_sales_price) sales,
         sum(ws_net_profit) profit
  from web_sales, date_dim, web_page
  where ws_sold_date_sk = d_date_sk
    and d_date between date '2000-08-23' and date '2000-09-22'
    and ws_web_page_sk = wp_web_page_sk
  group by wp_web_page_sk),
 wr as (
  select wp_web_page_sk, sum(wr_return_amt) returns,
         sum(wr_net_loss) profit_loss
  from web_returns, date_dim, web_page
  where wr_returned_date_sk = d_date_sk
    and d_date between date '2000-08-23' and date '2000-09-22'
    and wr_web_page_sk = wp_web_page_sk
  group by wp_web_page_sk)
select * from (select channel, id, sum(sales) sales, sum(returns) returns,
       sum(profit) profit
from (select 'store channel' channel, ss.s_store_sk id, sales,
             coalesce(returns, 0) returns,
             profit - coalesce(profit_loss, 0) profit
      from ss left join sr on ss.s_store_sk = sr.s_store_sk
      union all
      select 'catalog channel' channel, cs_call_center_sk id, sales,
             returns, profit - profit_loss profit
      from cs, cr
      union all
      select 'web channel' channel, ws.wp_web_page_sk id, sales,
             coalesce(returns, 0) returns,
             profit - coalesce(profit_loss, 0) profit
      from ws left join wr on ws.wp_web_page_sk = wr.wp_web_page_sk) x
group by channel, id
union all
select channel, null, sum(sales), sum(returns), sum(profit)
from (select 'store channel' channel, ss.s_store_sk id, sales, coalesce(returns, 0) returns, profit - coalesce(profit_loss, 0) profit from ss left join sr on ss.s_store_sk = sr.s_store_sk
 union all select 'catalog channel', cs_call_center_sk, sales, returns, profit - profit_loss from cs, cr
 union all select 'web channel', ws.wp_web_page_sk, sales, coalesce(returns, 0), profit - coalesce(profit_loss, 0) from ws left join wr on ws.wp_web_page_sk = wr.wp_web_page_sk) x2
group by channel
union all
select null, null, sum(sales), sum(returns), sum(profit)
from (select 'store channel' channel, ss.s_store_sk id, sales, coalesce(returns, 0) returns, profit - coalesce(profit_loss, 0) profit from ss left join sr on ss.s_store_sk = sr.s_store_sk
 union all select 'catalog channel', cs_call_center_sk, sales, returns, profit - profit_loss from cs, cr
 union all select 'web channel', ws.wp_web_page_sk, sales, coalesce(returns, 0), profit - coalesce(profit_loss, 0) from ws left join wr on ws.wp_web_page_sk = wr.wp_web_page_sk) x3)
order by channel is null, channel, id is null, id, sales
limit 100
""",
    80: """
with ssr as (
  select s_store_id store_id, sum(ss_ext_sales_price) sales,
         sum(coalesce(sr_return_amt, 0)) returns,
         sum(ss_net_profit - coalesce(sr_net_loss, 0)) profit
  from store_sales left join store_returns
         on ss_item_sk = sr_item_sk
         and ss_ticket_number = sr_ticket_number,
       date_dim, store, item, promotion
  where ss_sold_date_sk = d_date_sk
    and d_date between date '2000-08-23' and date '2000-09-22'
    and ss_store_sk = s_store_sk and ss_item_sk = i_item_sk
    and i_current_price > 50 and ss_promo_sk = p_promo_sk
    and p_channel_tv = 'N'
  group by s_store_id),
 csr as (
  select cp_catalog_page_id catalog_page_id,
         sum(cs_ext_sales_price) sales,
         sum(coalesce(cr_return_amount, 0)) returns,
         sum(cs_net_profit - coalesce(cr_net_loss, 0)) profit
  from catalog_sales left join catalog_returns
         on cs_item_sk = cr_item_sk
         and cs_order_number = cr_order_number,
       date_dim, catalog_page, item, promotion
  where cs_sold_date_sk = d_date_sk
    and d_date between date '2000-08-23' and date '2000-09-22'
    and cs_catalog_page_sk = cp_catalog_page_sk
    and cs_item_sk = i_item_sk and i_current_price > 50
    and cs_promo_sk = p_promo_sk and p_channel_tv = 'N'
  group by cp_catalog_page_id),
 wsr as (
  select web_site_id, sum(ws_ext_sales_price) sales,
         sum(coalesce(wr_return_amt, 0)) returns,
         sum(ws_net_profit - coalesce(wr_net_loss, 0)) profit
  from web_sales left join web_returns
         on ws_item_sk = wr_item_sk
         and ws_order_number = wr_order_number,
       date_dim, web_site, item, promotion
  where ws_sold_date_sk = d_date_sk
    and d_date between date '2000-08-23' and date '2000-09-22'
    and ws_web_site_sk = web_site_sk
    and ws_item_sk = i_item_sk and i_current_price > 50
    and ws_promo_sk = p_promo_sk and p_channel_tv = 'N'
  group by web_site_id)
select * from (select channel, id, sum(sales) sales, sum(returns) returns,
       sum(profit) profit
from (select 'store channel' channel, ('store' || store_id) id,
             sales, returns, profit
      from ssr
      union all
      select 'catalog channel' channel,
             ('catalog_page' || catalog_page_id) id,
             sales, returns, profit
      from csr
      union all
      select 'web channel' channel, ('web_site' || web_site_id) id,
             sales, returns, profit
      from wsr) x
group by channel, id
union all
select channel, null, sum(sales), sum(returns), sum(profit)
from (select 'store channel' channel, ('store' || store_id) id, sales, returns, profit from ssr
 union all select 'catalog channel', ('catalog_page' || catalog_page_id), sales, returns, profit from csr
 union all select 'web channel', ('web_site' || web_site_id), sales, returns, profit from wsr) x2
group by channel
union all
select null, null, sum(sales), sum(returns), sum(profit)
from (select 'store channel' channel, ('store' || store_id) id, sales, returns, profit from ssr
 union all select 'catalog channel', ('catalog_page' || catalog_page_id), sales, returns, profit from csr
 union all select 'web channel', ('web_site' || web_site_id), sales, returns, profit from wsr) x3)
order by channel is null, channel, id is null, id
limit 100
""",
    86: """
with base as (
  select ws_net_paid np, i_category, i_class
  from web_sales, date_dim d1, item
  where d1.d_month_seq between 1200 and 1211
    and d1.d_date_sk = ws_sold_date_sk and i_item_sk = ws_item_sk),
 lv as (
  select sum(np) total_sum, i_category, i_class, 0 lochierarchy, 0 gc
  from base group by i_category, i_class
  union all
  select sum(np), i_category, null, 1, 1 from base group by i_category
  union all
  select sum(np), null, null, 2, 1 from base)
select total_sum, i_category, i_class, lochierarchy,
       rank() over (partition by lochierarchy,
                    case when gc = 0 then i_category end
                    order by total_sum desc) rank_within_parent
from lv
order by lochierarchy desc,
         case when lochierarchy = 0 then i_category end,
         rank_within_parent
limit 100
""",
    # SQLite rejects parenthesised compound-select operands
    87: """
select count(*) c
from (select distinct c_last_name, c_first_name, d_date
      from store_sales, date_dim, customer
      where store_sales.ss_sold_date_sk = date_dim.d_date_sk
        and store_sales.ss_customer_sk = customer.c_customer_sk
        and d_month_seq between 1200 and 1200 + 11
      except
      select distinct c_last_name, c_first_name, d_date
      from catalog_sales, date_dim, customer
      where catalog_sales.cs_sold_date_sk = date_dim.d_date_sk
        and catalog_sales.cs_bill_customer_sk = customer.c_customer_sk
        and d_month_seq between 1200 and 1200 + 11
      except
      select distinct c_last_name, c_first_name, d_date
      from web_sales, date_dim, customer
      where web_sales.ws_sold_date_sk = date_dim.d_date_sk
        and web_sales.ws_bill_customer_sk = customer.c_customer_sk
        and d_month_seq between 1200 and 1200 + 11) cool_cust
""",
}
