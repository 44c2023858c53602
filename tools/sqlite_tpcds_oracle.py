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
