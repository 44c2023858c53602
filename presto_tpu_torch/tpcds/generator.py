"""Deterministic TPC-DS-shaped data generator (vectorized, 24 tables).

The reference vendors the Teradata Java dsdgen
(``plugin/trino-tpcds`` → io.trino.tpcds); byte-faithful regeneration is
out of scope, so this generator is spec-SHAPED: the same star-schema key
relationships (returns reference their parent sales rows, facts reference
dimension surrogate ranges), realistic domains, deterministic per
(table, sf).  Every column derives from counter-based hashing
(splitmix-style), so generation is order-independent and reproducible —
correctness of query execution over it is established differentially
against SQLite (``tests/test_tpcds.py``).
"""

from __future__ import annotations

import numpy as np

from ..data import types as T
from ..data.column import Column, PLAIN, bytes_column, dict_column
from ..data.table import Table
from . import schema as S

_MASK = np.uint64(0xFFFFFFFFFFFFFFFF)


def _mix(x: np.ndarray, salt: int) -> np.ndarray:
    """splitmix64 over a counter + salt: uniform uint64."""
    stream = np.uint64((salt * 0x9E3779B97F4A7C15) % (1 << 64))
    z = (x.astype(np.uint64) + stream) & _MASK
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9) & _MASK
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB) & _MASK
    return z ^ (z >> np.uint64(31))


def _uni(ids, salt, lo, hi):
    """Uniform int64 in [lo, hi]."""
    span = np.uint64(hi - lo + 1)
    return (lo + (_mix(ids, salt) % span).astype(np.int64)).astype(np.int64)


def _pick(ids, salt, options):
    codes = (_mix(ids, salt) % np.uint64(len(options))).astype(np.int32)
    return codes


_DAY_NAMES = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
              "Friday", "Saturday"]
_MEALS = ["breakfast", "lunch", "dinner", ""]
_CATEGORIES = ["Books", "Children", "Electronics", "Home", "Jewelry",
               "Men", "Music", "Shoes", "Sports", "Women"]
_CLASSES = ["accent", "classical", "dresses", "fiction", "pants",
            "romance", "self-help"]
_EDU = ["Primary", "Secondary", "College", "2 yr Degree", "4 yr Degree",
        "Advanced Degree", "Unknown"]
_STATES = ["TN", "GA", "AL", "SC", "NC", "VA", "KY", "MO"]
_CITIES = ["Midway", "Fairview", "Oakland", "Salem", "Glendale",
           "Riverside", "Centerville", "Greenfield"]
_COUNTIES = ["Williamson County", "Walker County", "Ziebach County",
             "Daviess County", "Barrow County"]
_STREETS = ["Main", "Oak", "Park", "First", "Second", "Elm", "Maple"]
_STYPES = ["St", "Ave", "Blvd", "Ct", "Dr", "Ln", "Way"]
_YN = ["Y", "N"]
_NAMES = ["ought", "able", "pri", "ese", "anti", "cally", "ation", "eing"]
_BUY_POT = [">10000", "5001-10000", "1001-5000", "501-1000", "0-500",
            "Unknown"]
_CREDIT = ["Low Risk", "Good", "High Risk", "Unknown"]
_SALUT = ["Mr.", "Mrs.", "Ms.", "Dr.", "Miss", "Sir"]
_FIRST = ["James", "Mary", "John", "Linda", "Robert", "Susan", "David",
          "Karen", "Paul", "Lisa"]
_LAST = ["Smith", "Johnson", "Brown", "Jones", "Miller", "Davis",
         "Wilson", "Moore", "Taylor", "White"]
_COUNTRY = ["United States"]
_COLORS = ["red", "green", "blue", "white", "black", "yellow", "plum",
           "peach", "ivory", "navy"]
_UNITS = ["Each", "Dozen", "Case", "Box", "Pallet", "Gross"]
_CONTAINERS = ["SM BOX", "LG BOX", "SM CASE", "LG CASE", "SM PACK",
               "LG PACK", "SM DRUM", "LG DRUM"]
_SIZES = ["small", "medium", "large", "extra large", "economy", "N/A",
          "petite"]
_SM_TYPES = ["EXPRESS", "OVERNIGHT", "TWO DAY", "LIBRARY", "REGULAR"]
_SM_CODES = ["AIR", "SURFACE", "SEA"]
_CARRIERS = ["UPS", "FEDEX", "AIRBORNE", "USPS", "DHL", "TBS", "ZHOU",
             "LATVIAN"]
_SHIFTS = ["first", "second", "third"]
_WP_TYPES = ["ad", "bio", "dynamic", "feedback", "general", "order",
             "protected", "welcome"]
_CP_DEPTS = ["DEPARTMENT"]
_LOCATION = ["apartment", "condo", "single family"]

# d_date_sk convention: spec starts at 2415022 (1900-01-01 julian)
DATE_SK0 = 2415022
EPOCH_OFFSET_DAYS = 25567  # days from 1900-01-01 to 1970-01-01
# fact sold-date window 1998-01-01 .. 2002-12-31 (spec's active window)
LO_SK = DATE_SK0 + 35795
HI_SK = DATE_SK0 + 37621


def _sk(n):
    return Column(T.BIGINT, 1 + np.arange(n, dtype=np.int64))


def _bid(prefix, n):
    return bytes_column(T.varchar(16), [f"AAAAAAAA{k:08d}" for k in
                                        range(n)])


def _dec(vals, prec=7):
    return Column(T.decimal(prec, 2), vals.astype(np.int64), None, PLAIN)


def _zip5(ids, salt):
    return bytes_column(
        T.varchar(10), [f"{z:05d}" for z in _uni(ids, salt, 10000, 99999)])


def _dict(dtype_w, ids, salt, pool):
    return dict_column(T.varchar(dtype_w), _pick(ids, salt, pool), pool)


def _address_cols(cols, prefix, ids, n, base_salt):
    """Shared address block (store/call_center/web_site/warehouse/
    customer_address all carry the spec's address fields)."""
    cols[f"{prefix}street_number"] = bytes_column(
        T.varchar(10), [str(v) for v in _uni(ids, base_salt, 1, 999)])
    cols[f"{prefix}street_name"] = _dict(60, ids, base_salt + 1, _STREETS)
    cols[f"{prefix}street_type"] = _dict(15, ids, base_salt + 2, _STYPES)
    cols[f"{prefix}suite_number"] = bytes_column(
        T.varchar(10), [f"Suite {v}" for v in _uni(ids, base_salt + 3,
                                                   0, 99)])
    cols[f"{prefix}city"] = _dict(60, ids, base_salt + 4, _CITIES)
    cols[f"{prefix}county"] = _dict(30, ids, base_salt + 5, _COUNTIES)
    cols[f"{prefix}state"] = _dict(2, ids, base_salt + 6, _STATES)
    cols[f"{prefix}zip"] = _zip5(ids, base_salt + 7)
    cols[f"{prefix}country"] = _dict(20, ids, base_salt + 8, _COUNTRY)
    cols[f"{prefix}gmt_offset"] = Column(
        T.decimal(5, 2), np.where(_mix(ids, base_salt + 9)
                                  % np.uint64(2) == 0, -500, -600)
        .astype(np.int64), None, PLAIN)


def _rec_dates(cols, prefix, n):
    cols[f"{prefix}rec_start_date"] = Column(
        T.DATE, np.full(n, 9862, np.int32))       # 1997-01-01
    cols[f"{prefix}rec_end_date"] = Column(
        T.DATE, np.full(n, 11688, np.int32))      # 2001-12-31


def _sales_money(cols, prefix, ids, base_salt, ship=False):
    """Monetary column block shared by the three sales channels
    (spec pricing g_pricing column set)."""
    qty = _uni(ids, base_salt, 1, 100)
    whole = _uni(ids, base_salt + 1, 100, 10000)      # 1.00..100.00
    mult = _uni(ids, base_salt + 2, 110, 250)         # markup %
    price = whole * mult // 100
    disc_pct = _uni(ids, base_salt + 3, 0, 90)
    sales = price * (100 - disc_pct) // 100
    ext_list = price * qty
    ext_sales = sales * qty
    ext_whole = whole * qty
    ext_disc = ext_list - ext_sales
    tax_pct = _uni(ids, base_salt + 4, 0, 9)
    ext_tax = ext_sales * tax_pct // 100
    coupon = np.where(_mix(ids, base_salt + 5) % np.uint64(10) == 0,
                      ext_sales // 10, 0).astype(np.int64)
    net_paid = ext_sales - coupon
    cols[f"{prefix}quantity"] = Column(T.BIGINT, qty)
    cols[f"{prefix}wholesale_cost"] = _dec(whole)
    cols[f"{prefix}list_price"] = _dec(price)
    cols[f"{prefix}sales_price"] = _dec(sales)
    cols[f"{prefix}ext_discount_amt"] = _dec(ext_disc)
    cols[f"{prefix}ext_sales_price"] = _dec(ext_sales)
    cols[f"{prefix}ext_wholesale_cost"] = _dec(ext_whole)
    cols[f"{prefix}ext_list_price"] = _dec(ext_list)
    cols[f"{prefix}ext_tax"] = _dec(ext_tax)
    cols[f"{prefix}coupon_amt"] = _dec(coupon)
    if ship:
        ship_cost = ext_whole // 2
        cols[f"{prefix}ext_ship_cost"] = _dec(ship_cost)
        cols[f"{prefix}net_paid"] = _dec(net_paid)
        cols[f"{prefix}net_paid_inc_tax"] = _dec(net_paid + ext_tax)
        cols[f"{prefix}net_paid_inc_ship"] = _dec(net_paid + ship_cost)
        cols[f"{prefix}net_paid_inc_ship_tax"] = _dec(
            net_paid + ship_cost + ext_tax)
    else:
        cols[f"{prefix}net_paid"] = _dec(net_paid)
        cols[f"{prefix}net_paid_inc_tax"] = _dec(net_paid + ext_tax)
    cols[f"{prefix}net_profit"] = _dec(net_paid - ext_whole)


def _return_money(cols, prefix, ids, base_salt, amt_name="return_amt",
                  credit_name="store_credit"):
    qty = _uni(ids, base_salt, 1, 20)
    unit = _uni(ids, base_salt + 1, 100, 20000)
    amt = unit * qty
    tax = amt * _uni(ids, base_salt + 2, 0, 9) // 100
    fee = _uni(ids, base_salt + 3, 50, 10000)
    ship = _uni(ids, base_salt + 4, 0, 5000)
    cash = amt // 2
    rev = amt // 4
    credit = amt - cash - rev
    cols[f"{prefix}return_quantity"] = Column(T.BIGINT, qty)
    cols[f"{prefix}{amt_name}"] = _dec(amt)
    cols[f"{prefix}return_tax"] = _dec(tax)
    cols[f"{prefix}return_amt_inc_tax"] = _dec(amt + tax)
    cols[f"{prefix}fee"] = _dec(fee)
    cols[f"{prefix}return_ship_cost"] = _dec(ship)
    cols[f"{prefix}refunded_cash"] = _dec(cash)
    cols[f"{prefix}reversed_charge"] = _dec(rev)
    cols[f"{prefix}{credit_name}"] = _dec(credit)
    cols[f"{prefix}net_loss"] = _dec(fee + ship + amt // 10)


def _fact_item(row_ids, lines, items, salt):
    """Item sk with DISTINCT items inside one ticket/order (dsdgen
    permutes items per order, making (item, ticket) a real key)."""
    ticket = row_ids // np.uint64(lines)
    line = (row_ids % np.uint64(lines)).astype(np.int64)
    base = _uni(ticket, salt, 0, items - 1)
    return ((base + line) % items + 1).astype(np.int64)


def _return_pids(n_ret, n_parent):
    """Distinct parent-row ids for a returns table (sampling WITHOUT
    replacement keeps (item, ticket) unique in returns too — the engine
    plans unique-build joins on the declared keys).  Fixed-seed
    permutation = deterministic per (n_ret, n_parent)."""
    rng = np.random.default_rng(0x5EED + n_parent)
    k = min(n_ret, n_parent)
    pid = np.sort(rng.permutation(n_parent)[:k])
    if n_ret > n_parent:          # degenerate tiny-SF case: wrap
        pid = np.concatenate([pid, pid[: n_ret - n_parent]])
    return pid.astype(np.uint64)


def generate(table: str, sf: float) -> Table:
    n = S.row_count(table, sf)
    ids = np.arange(n, dtype=np.uint64)
    cols: dict = {}

    def fk(name, salt, parent):
        cols[name] = Column(T.BIGINT,
                            _uni(ids, salt, 1, S.row_count(parent, sf)))

    if table == "date_dim":
        days = np.arange(n, dtype=np.int64) - EPOCH_OFFSET_DAYS
        cols["d_date_sk"] = Column(T.BIGINT, DATE_SK0 + np.arange(n))
        cols["d_date_id"] = _bid("d", n)
        cols["d_date"] = Column(T.DATE, days.astype(np.int32))
        # civil calendar pieces (Hinnant, vectorized)
        z = days + 719468
        era = z // 146097
        doe = z - era * 146097
        yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
        y = yoe + era * 400
        doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
        mp = (5 * doy + 2) // 153
        dom = doy - (153 * mp + 2) // 5 + 1
        moy = np.where(mp < 10, mp + 3, mp - 9)
        year = y + (moy <= 2)
        month_seq = (year - 1900) * 12 + moy - 1
        week_seq = (np.arange(n) + 4) // 7 + 1    # 1900-01-01 = Monday
        cols["d_month_seq"] = Column(T.BIGINT, month_seq.astype(np.int64))
        cols["d_week_seq"] = Column(T.BIGINT, week_seq.astype(np.int64))
        cols["d_quarter_seq"] = Column(
            T.BIGINT, ((year - 1900) * 4 + (moy + 2) // 3).astype(np.int64))
        cols["d_year"] = Column(T.BIGINT, year.astype(np.int64))
        dow = ((days % 7) + 7 + 4) % 7  # 1970-01-01 = Thursday = idx 4
        cols["d_dow"] = Column(T.BIGINT, dow.astype(np.int64))
        cols["d_moy"] = Column(T.BIGINT, moy.astype(np.int64))
        cols["d_dom"] = Column(T.BIGINT, dom.astype(np.int64))
        cols["d_qoy"] = Column(T.BIGINT, ((moy + 2) // 3).astype(np.int64))
        cols["d_fy_year"] = cols["d_year"]
        cols["d_fy_quarter_seq"] = cols["d_quarter_seq"]
        cols["d_fy_week_seq"] = cols["d_week_seq"]
        cols["d_day_name"] = dict_column(T.varchar(9), dow.astype(np.int32),
                                         _DAY_NAMES)
        qname = [f"{yy}Q{q}" for yy, q in
                 zip(year, ((moy + 2) // 3))]
        cols["d_quarter_name"] = bytes_column(T.varchar(6), qname)
        cols["d_holiday"] = dict_column(
            T.varchar(1), ((_mix(ids, 3) % np.uint64(50)) == 0)
            .astype(np.int32), ["N", "Y"])
        cols["d_weekend"] = dict_column(
            T.varchar(1), ((dow == 0) | (dow == 6)).astype(np.int32),
            ["N", "Y"])
        cols["d_following_holiday"] = cols["d_holiday"]
        first_dom = DATE_SK0 + np.arange(n) - (dom - 1)
        cols["d_first_dom"] = Column(T.BIGINT, first_dom.astype(np.int64))
        cols["d_last_dom"] = Column(T.BIGINT,
                                    (first_dom + 27).astype(np.int64))
        cols["d_same_day_ly"] = Column(
            T.BIGINT, (DATE_SK0 + np.arange(n) - 365).astype(np.int64))
        cols["d_same_day_lq"] = Column(
            T.BIGINT, (DATE_SK0 + np.arange(n) - 91).astype(np.int64))
        for c in ("d_current_day", "d_current_week", "d_current_month",
                  "d_current_quarter", "d_current_year"):
            cols[c] = dict_column(T.varchar(1),
                                  np.zeros(n, np.int32), ["N", "Y"])
    elif table == "time_dim":
        t = np.arange(n, dtype=np.int64)
        cols["t_time_sk"] = Column(T.BIGINT, t)
        cols["t_time_id"] = _bid("t", n)
        cols["t_time"] = Column(T.BIGINT, t)
        hour = t // 3600
        cols["t_hour"] = Column(T.BIGINT, hour)
        cols["t_minute"] = Column(T.BIGINT, (t // 60) % 60)
        cols["t_second"] = Column(T.BIGINT, t % 60)
        cols["t_am_pm"] = dict_column(
            T.varchar(2), (hour >= 12).astype(np.int32), ["AM", "PM"])
        cols["t_shift"] = dict_column(
            T.varchar(20), np.minimum(hour // 8, 2).astype(np.int32),
            _SHIFTS)
        cols["t_sub_shift"] = cols["t_shift"]
        meal = np.select([(hour >= 6) & (hour <= 9),
                          (hour >= 11) & (hour <= 14),
                          (hour >= 17) & (hour <= 21)],
                         [0, 1, 2], default=3).astype(np.int32)
        cols["t_meal_time"] = dict_column(T.varchar(20), meal, _MEALS)
    elif table == "item":
        cols["i_item_sk"] = _sk(n)
        cols["i_item_id"] = _bid("i", n)
        _rec_dates(cols, "i_", n)
        cols["i_item_desc"] = bytes_column(
            T.varchar(200), [f"item description {k % 997}"
                             for k in range(n)])
        cols["i_current_price"] = _dec(_uni(ids, 16, 99, 9999))
        cols["i_wholesale_cost"] = _dec(_uni(ids, 17, 50, 6000))
        brand_id = _uni(ids, 11, 1, 1000)
        cols["i_brand_id"] = Column(T.BIGINT, brand_id)
        cols["i_brand"] = bytes_column(
            T.varchar(50), [f"brand#{b}" for b in brand_id])
        cls = _pick(ids, 13, _CLASSES)
        cols["i_class_id"] = Column(T.BIGINT, cls.astype(np.int64) + 1)
        cols["i_class"] = dict_column(T.varchar(50), cls, _CLASSES)
        cat = _pick(ids, 12, _CATEGORIES)
        cols["i_category_id"] = Column(T.BIGINT, cat.astype(np.int64) + 1)
        cols["i_category"] = dict_column(T.varchar(50), cat, _CATEGORIES)
        man = _uni(ids, 14, 1, 1000)
        cols["i_manufact_id"] = Column(T.BIGINT, man)
        cols["i_manufact"] = bytes_column(
            T.varchar(50), [f"manufact#{m}" for m in man])
        cols["i_size"] = _dict(20, ids, 18, _SIZES)
        cols["i_formulation"] = bytes_column(
            T.varchar(20), [f"form{v}" for v in _uni(ids, 19, 0, 999)])
        cols["i_color"] = _dict(20, ids, 20, _COLORS)
        cols["i_units"] = _dict(10, ids, 21, _UNITS)
        cols["i_container"] = _dict(10, ids, 22, _CONTAINERS)
        cols["i_manager_id"] = Column(T.BIGINT, _uni(ids, 15, 1, 100))
        cols["i_product_name"] = _dict(50, ids, 23, _NAMES)
    elif table == "store":
        cols["s_store_sk"] = _sk(n)
        cols["s_store_id"] = _bid("s", n)
        _rec_dates(cols, "s_", n)
        cols["s_closed_date_sk"] = Column(
            T.BIGINT, np.zeros(n, np.int64),
            np.zeros(n, bool), PLAIN)                      # all NULL
        cols["s_store_name"] = _dict(50, ids, 21, _NAMES)
        cols["s_number_employees"] = Column(
            T.BIGINT, _uni(ids, 22, 200, 300))
        cols["s_floor_space"] = Column(
            T.BIGINT, _uni(ids, 26, 5_000_000, 10_000_000))
        cols["s_hours"] = _dict(20, ids, 27, ["8AM-4PM", "8AM-12AM",
                                              "8AM-8AM"])
        cols["s_manager"] = _dict(40, ids, 28, _FIRST)
        cols["s_market_id"] = Column(T.BIGINT, _uni(ids, 29, 1, 10))
        cols["s_geography_class"] = _dict(100, ids, 30, ["Unknown"])
        cols["s_market_desc"] = bytes_column(
            T.varchar(100), [f"market {v}" for v in _uni(ids, 31, 0, 99)])
        cols["s_market_manager"] = _dict(40, ids, 32, _LAST)
        cols["s_division_id"] = Column(T.BIGINT, np.ones(n, np.int64))
        cols["s_division_name"] = _dict(50, ids, 33, ["Unknown"])
        cols["s_company_id"] = Column(T.BIGINT, np.ones(n, np.int64))
        cols["s_company_name"] = _dict(50, ids, 34, ["Unknown"])
        _address_cols(cols, "s_", ids, n, 35)
        cols["s_tax_precentage"] = Column(
            T.decimal(5, 2), _uni(ids, 45, 0, 11), None, PLAIN)
    elif table == "call_center":
        cols["cc_call_center_sk"] = _sk(n)
        cols["cc_call_center_id"] = _bid("cc", n)
        _rec_dates(cols, "cc_", n)
        cols["cc_closed_date_sk"] = Column(
            T.BIGINT, np.zeros(n, np.int64), np.zeros(n, bool), PLAIN)
        cols["cc_open_date_sk"] = Column(
            T.BIGINT, _uni(ids, 3, LO_SK - 3650, LO_SK))
        cols["cc_name"] = _dict(50, ids, 4, ["NY Metro", "Mid Atlantic",
                                             "North Midwest", "California",
                                             "Pacific Northwest",
                                             "Southwest"])
        cols["cc_class"] = _dict(50, ids, 5, ["small", "medium", "large"])
        cols["cc_employees"] = Column(T.BIGINT, _uni(ids, 6, 1, 7))
        cols["cc_sq_ft"] = Column(T.BIGINT, _uni(ids, 7, 100, 700))
        cols["cc_hours"] = _dict(20, ids, 8, ["8AM-4PM", "8AM-12AM",
                                              "8AM-8AM"])
        cols["cc_manager"] = _dict(40, ids, 9, _FIRST)
        cols["cc_mkt_id"] = Column(T.BIGINT, _uni(ids, 10, 1, 6))
        cols["cc_mkt_class"] = bytes_column(
            T.varchar(50), [f"class{v}" for v in _uni(ids, 11, 0, 9)])
        cols["cc_mkt_desc"] = bytes_column(
            T.varchar(100), [f"mkt {v}" for v in _uni(ids, 12, 0, 99)])
        cols["cc_market_manager"] = _dict(40, ids, 13, _LAST)
        cols["cc_division"] = Column(T.BIGINT, _uni(ids, 14, 1, 6))
        cols["cc_division_name"] = _dict(50, ids, 15, _NAMES)
        cols["cc_company"] = Column(T.BIGINT, _uni(ids, 16, 1, 6))
        cols["cc_company_name"] = _dict(50, ids, 17, _NAMES)
        _address_cols(cols, "cc_", ids, n, 18)
        cols["cc_tax_percentage"] = Column(
            T.decimal(5, 2), _uni(ids, 30, 0, 11), None, PLAIN)
    elif table == "catalog_page":
        cols["cp_catalog_page_sk"] = _sk(n)
        cols["cp_catalog_page_id"] = _bid("cp", n)
        cols["cp_start_date_sk"] = Column(
            T.BIGINT, _uni(ids, 3, LO_SK - 365, HI_SK - 365))
        cols["cp_end_date_sk"] = Column(
            T.BIGINT, np.asarray(cols["cp_start_date_sk"].values) + 364)
        cols["cp_department"] = _dict(50, ids, 4, _CP_DEPTS)
        cols["cp_catalog_number"] = Column(T.BIGINT, _uni(ids, 5, 1, 109))
        cols["cp_catalog_page_number"] = Column(
            T.BIGINT, _uni(ids, 6, 1, 108))
        cols["cp_description"] = bytes_column(
            T.varchar(100), [f"page desc {v}" for v in
                             _uni(ids, 7, 0, 996)])
        cols["cp_type"] = _dict(100, ids, 8, ["bi-annual", "quarterly",
                                              "monthly"])
    elif table == "web_site":
        cols["web_site_sk"] = _sk(n)
        cols["web_site_id"] = _bid("web", n)
        _rec_dates(cols, "web_", n)
        cols["web_name"] = _dict(50, ids, 3, ["site_0", "site_1", "site_2",
                                              "site_3", "site_4"])
        cols["web_open_date_sk"] = Column(
            T.BIGINT, _uni(ids, 4, LO_SK - 3650, LO_SK))
        cols["web_close_date_sk"] = Column(
            T.BIGINT, np.zeros(n, np.int64), np.zeros(n, bool), PLAIN)
        cols["web_class"] = _dict(50, ids, 5, ["Unknown"])
        cols["web_manager"] = _dict(40, ids, 6, _FIRST)
        cols["web_mkt_id"] = Column(T.BIGINT, _uni(ids, 7, 1, 6))
        cols["web_mkt_class"] = bytes_column(
            T.varchar(50), [f"class{v}" for v in _uni(ids, 8, 0, 9)])
        cols["web_mkt_desc"] = bytes_column(
            T.varchar(100), [f"mkt {v}" for v in _uni(ids, 9, 0, 99)])
        cols["web_market_manager"] = _dict(40, ids, 10, _LAST)
        cols["web_company_id"] = Column(T.BIGINT, _uni(ids, 11, 1, 6))
        cols["web_company_name"] = _dict(50, ids, 12, _NAMES)
        _address_cols(cols, "web_", ids, n, 13)
        cols["web_tax_percentage"] = Column(
            T.decimal(5, 2), _uni(ids, 25, 0, 11), None, PLAIN)
    elif table == "web_page":
        cols["wp_web_page_sk"] = _sk(n)
        cols["wp_web_page_id"] = _bid("wp", n)
        _rec_dates(cols, "wp_", n)
        cols["wp_creation_date_sk"] = Column(
            T.BIGINT, _uni(ids, 3, LO_SK - 3650, LO_SK))
        cols["wp_access_date_sk"] = Column(
            T.BIGINT, _uni(ids, 4, HI_SK - 100, HI_SK))
        cols["wp_autogen_flag"] = _dict(1, ids, 5, _YN)
        fk("wp_customer_sk", 6, "customer")
        cols["wp_url"] = _dict(100, ids, 7, ["http://www.foo.com"])
        cols["wp_type"] = _dict(50, ids, 8, _WP_TYPES)
        cols["wp_char_count"] = Column(T.BIGINT, _uni(ids, 9, 100, 8000))
        cols["wp_link_count"] = Column(T.BIGINT, _uni(ids, 10, 2, 25))
        cols["wp_image_count"] = Column(T.BIGINT, _uni(ids, 11, 1, 7))
        cols["wp_max_ad_count"] = Column(T.BIGINT, _uni(ids, 12, 0, 4))
    elif table == "warehouse":
        cols["w_warehouse_sk"] = _sk(n)
        cols["w_warehouse_id"] = _bid("w", n)
        cols["w_warehouse_name"] = _dict(20, ids, 3, _NAMES)
        cols["w_warehouse_sq_ft"] = Column(
            T.BIGINT, _uni(ids, 4, 50000, 1000000))
        _address_cols(cols, "w_", ids, n, 5)
    elif table == "reason":
        cols["r_reason_sk"] = _sk(n)
        cols["r_reason_id"] = _bid("r", n)
        cols["r_reason_desc"] = bytes_column(
            T.varchar(100), [f"reason {k}" for k in range(n)])
    elif table == "ship_mode":
        cols["sm_ship_mode_sk"] = _sk(n)
        cols["sm_ship_mode_id"] = _bid("sm", n)
        cols["sm_type"] = _dict(30, ids, 3, _SM_TYPES)
        cols["sm_code"] = _dict(10, ids, 4, _SM_CODES)
        cols["sm_carrier"] = _dict(20, ids, 5, _CARRIERS)
        cols["sm_contract"] = bytes_column(
            T.varchar(20), [f"c{v}" for v in _uni(ids, 6, 0, 2**20)])
    elif table == "income_band":
        cols["ib_income_band_sk"] = _sk(n)
        lower = np.arange(n, dtype=np.int64) * 10000
        cols["ib_lower_bound"] = Column(T.BIGINT, lower + 1)
        cols["ib_upper_bound"] = Column(T.BIGINT, lower + 10000)
    elif table == "promotion":
        cols["p_promo_sk"] = _sk(n)
        cols["p_promo_id"] = _bid("p", n)
        cols["p_start_date_sk"] = Column(
            T.BIGINT, _uni(ids, 3, LO_SK, HI_SK - 60))
        cols["p_end_date_sk"] = Column(
            T.BIGINT, np.asarray(cols["p_start_date_sk"].values)
            + _uni(ids, 4, 10, 60))
        fk("p_item_sk", 5, "item")
        cols["p_cost"] = Column(T.decimal(15, 2),
                                np.full(n, 100000, np.int64), None, PLAIN)
        cols["p_response_target"] = Column(T.BIGINT, np.ones(n, np.int64))
        cols["p_promo_name"] = _dict(50, ids, 6, _NAMES)
        for i, name in enumerate(
                ("p_channel_dmail", "p_channel_email", "p_channel_catalog",
                 "p_channel_tv", "p_channel_radio", "p_channel_press",
                 "p_channel_event", "p_channel_demo")):
            cols[name] = _dict(1, ids, 31 + i, _YN)
        cols["p_channel_details"] = bytes_column(
            T.varchar(100), [f"details {v}" for v in _uni(ids, 40, 0, 99)])
        cols["p_purpose"] = _dict(15, ids, 41, ["Unknown"])
        cols["p_discount_active"] = _dict(1, ids, 42, _YN)
    elif table == "customer_demographics":
        # exhaustive cross-product like dsdgen: demo_sk enumerates the
        # combination space
        cols["cd_demo_sk"] = _sk(n)
        cols["cd_gender"] = dict_column(
            T.varchar(1), (ids % np.uint64(2)).astype(np.int32), ["M", "F"])
        cols["cd_marital_status"] = dict_column(
            T.varchar(1), ((ids // np.uint64(2)) % np.uint64(5))
            .astype(np.int32), ["M", "S", "D", "W", "U"])
        cols["cd_education_status"] = dict_column(
            T.varchar(20), ((ids // np.uint64(10)) % np.uint64(7))
            .astype(np.int32), _EDU)
        cols["cd_purchase_estimate"] = Column(
            T.BIGINT, (((ids // np.uint64(70)) % np.uint64(20))
                       .astype(np.int64) + 1) * 500)
        cols["cd_credit_rating"] = dict_column(
            T.varchar(10), ((ids // np.uint64(1400)) % np.uint64(4))
            .astype(np.int32), _CREDIT)
        cols["cd_dep_count"] = Column(
            T.BIGINT, ((ids // np.uint64(5600)) % np.uint64(7))
            .astype(np.int64))
        cols["cd_dep_employed_count"] = Column(
            T.BIGINT, ((ids // np.uint64(39200)) % np.uint64(7))
            .astype(np.int64))
        cols["cd_dep_college_count"] = Column(
            T.BIGINT, ((ids // np.uint64(274400)) % np.uint64(7))
            .astype(np.int64))
    elif table == "household_demographics":
        cols["hd_demo_sk"] = _sk(n)
        cols["hd_income_band_sk"] = Column(
            T.BIGINT, (ids % np.uint64(S.INCOME_BANDS)).astype(np.int64)
            + 1)
        cols["hd_buy_potential"] = _dict(15, ids, 2, _BUY_POT)
        cols["hd_dep_count"] = Column(T.BIGINT, _uni(ids, 41, 0, 9))
        cols["hd_vehicle_count"] = Column(T.BIGINT, _uni(ids, 42, -1, 4))
    elif table == "customer":
        cols["c_customer_sk"] = _sk(n)
        cols["c_customer_id"] = _bid("c", n)
        cols["c_current_cdemo_sk"] = Column(
            T.BIGINT, _uni(ids, 70, 1, S.CDEMO_ROWS))
        cols["c_current_hdemo_sk"] = Column(
            T.BIGINT, _uni(ids, 73, 1, S.HDEMO_ROWS))
        fk("c_current_addr_sk", 71, "customer_address")
        cols["c_first_shipto_date_sk"] = Column(
            T.BIGINT, _uni(ids, 74, LO_SK, HI_SK))
        cols["c_first_sales_date_sk"] = Column(
            T.BIGINT, np.asarray(cols["c_first_shipto_date_sk"].values)
            - 30)
        cols["c_salutation"] = _dict(10, ids, 75, _SALUT)
        cols["c_first_name"] = _dict(20, ids, 76, _FIRST)
        cols["c_last_name"] = _dict(30, ids, 77, _LAST)
        cols["c_preferred_cust_flag"] = _dict(1, ids, 78, _YN)
        cols["c_birth_day"] = Column(T.BIGINT, _uni(ids, 79, 1, 28))
        cols["c_birth_month"] = Column(T.BIGINT, _uni(ids, 80, 1, 12))
        cols["c_birth_year"] = Column(T.BIGINT, _uni(ids, 72, 1924, 1992))
        cols["c_birth_country"] = _dict(20, ids, 81, _COUNTRY)
        cols["c_login"] = bytes_column(
            T.varchar(13), [f"login{k % 1000}" for k in range(n)])
        cols["c_email_address"] = bytes_column(
            T.varchar(50), [f"user{k}@example.com" for k in range(n)])
        cols["c_last_review_date_sk"] = Column(
            T.BIGINT, _uni(ids, 82, HI_SK - 700, HI_SK))
    elif table == "customer_address":
        cols["ca_address_sk"] = _sk(n)
        cols["ca_address_id"] = _bid("ca", n)
        _address_cols(cols, "ca_", ids, n, 81)
        cols["ca_location_type"] = _dict(20, ids, 95, _LOCATION)
    elif table == "inventory":
        # weekly snapshots × item × warehouse (spec join structure)
        items = S.row_count("item", sf)
        warehouses = S.row_count("warehouse", sf)
        # ceil so weeks*items*warehouses >= n: the mixed-radix decode of
        # iw is then injective, keeping (date, item, warehouse) UNIQUE —
        # schema.PRIMARY_KEYS declares the triple as the table PK and
        # unique-build join detection relies on it (ADVICE r4)
        weeks = max(-(-n // max(items * warehouses, 1)), 1)
        iw = ids.astype(np.int64)
        cols["inv_date_sk"] = Column(
            T.BIGINT, LO_SK + (iw % weeks) * 7)
        cols["inv_item_sk"] = Column(
            T.BIGINT, (iw // weeks) % items + 1)
        cols["inv_warehouse_sk"] = Column(
            T.BIGINT, (iw // (weeks * items)) % warehouses + 1)
        cols["inv_quantity_on_hand"] = Column(
            T.BIGINT, _uni(ids, 3, 0, 1000))
    elif table in ("store_sales", "catalog_sales", "web_sales"):
        p = {"store_sales": "ss_", "catalog_sales": "cs_",
             "web_sales": "ws_"}[table]
        cols[f"{p}sold_date_sk"] = Column(
            T.BIGINT, _uni(ids, 51, LO_SK, HI_SK))
        cols[f"{p}sold_time_sk"] = Column(
            T.BIGINT, _uni(ids, 52, 28800, 75600))
        if table != "store_sales":
            cols[f"{p}ship_date_sk"] = Column(
                T.BIGINT, np.asarray(cols[f"{p}sold_date_sk"].values)
                + _uni(ids, 67, 1, 120))
        n_items = S.row_count("item", sf)
        lines = 3 if table == "store_sales" else 4
        cols[f"{p}item_sk"] = Column(T.BIGINT,
                                     _fact_item(ids, lines, n_items, 53))
        if table == "store_sales":
            fk("ss_customer_sk", 66, "customer")
            cols["ss_cdemo_sk"] = Column(
                T.BIGINT, _uni(ids, 54, 1, S.CDEMO_ROWS))
            cols["ss_hdemo_sk"] = Column(
                T.BIGINT, _uni(ids, 55, 1, S.HDEMO_ROWS))
            fk("ss_addr_sk", 68, "customer_address")
            fk("ss_store_sk", 56, "store")
            fk("ss_promo_sk", 57, "promotion")
            cols["ss_ticket_number"] = Column(
                T.BIGINT, 1 + np.arange(n, dtype=np.int64) // 3)
            _sales_money(cols, p, ids, 58, ship=False)
        else:
            fk(f"{p}bill_customer_sk", 66, "customer")
            cols[f"{p}bill_cdemo_sk"] = Column(
                T.BIGINT, _uni(ids, 54, 1, S.CDEMO_ROWS))
            cols[f"{p}bill_hdemo_sk"] = Column(
                T.BIGINT, _uni(ids, 55, 1, S.HDEMO_ROWS))
            fk(f"{p}bill_addr_sk", 68, "customer_address")
            fk(f"{p}ship_customer_sk", 69, "customer")
            cols[f"{p}ship_cdemo_sk"] = Column(
                T.BIGINT, _uni(ids, 70, 1, S.CDEMO_ROWS))
            cols[f"{p}ship_hdemo_sk"] = Column(
                T.BIGINT, _uni(ids, 71, 1, S.HDEMO_ROWS))
            fk(f"{p}ship_addr_sk", 72, "customer_address")
            if table == "catalog_sales":
                fk("cs_call_center_sk", 73, "call_center")
                fk("cs_catalog_page_sk", 74, "catalog_page")
            else:
                fk("ws_web_page_sk", 73, "web_page")
                fk("ws_web_site_sk", 74, "web_site")
            fk(f"{p}ship_mode_sk", 75, "ship_mode")
            fk(f"{p}warehouse_sk", 76, "warehouse")
            fk(f"{p}promo_sk", 57, "promotion")
            cols[f"{p}order_number"] = Column(
                T.BIGINT, 1 + np.arange(n, dtype=np.int64) // 4)
            _sales_money(cols, p, ids, 58, ship=True)
    elif table in ("store_returns", "catalog_returns", "web_returns"):
        parent, pp, p = {
            "store_returns": ("store_sales", "ss_", "sr_"),
            "catalog_returns": ("catalog_sales", "cs_", "cr_"),
            "web_returns": ("web_sales", "ws_", "wr_"),
        }[table]
        np_ = S.row_count(parent, sf)
        # each return references a deterministic parent sale row: item_sk
        # and ticket/order number recompute the parent's value-functions
        # at the sampled parent id (spec: returns join back to sales)
        pid = _return_pids(n, np_)
        sold = _uni(pid, 51, LO_SK, HI_SK)
        cols[f"{p}returned_date_sk" if p != "sr_"
             else "sr_returned_date_sk"] = Column(
            T.BIGINT, sold + _uni(ids, 91, 1, 90))
        if p == "sr_":
            cols["sr_return_time_sk"] = Column(
                T.BIGINT, _uni(ids, 92, 28800, 75600))
        else:
            cols[f"{p}returned_time_sk"] = Column(
                T.BIGINT, _uni(ids, 92, 28800, 75600))
        items = S.row_count("item", sf)
        plines = 3 if p == "sr_" else 4
        cols[f"{p}item_sk"] = Column(T.BIGINT,
                                     _fact_item(pid, plines, items, 53))
        ncust = S.row_count("customer", sf)
        naddr = S.row_count("customer_address", sf)
        if p == "sr_":
            cols["sr_customer_sk"] = Column(
                T.BIGINT, _uni(pid, 66, 1, ncust))
            cols["sr_cdemo_sk"] = Column(
                T.BIGINT, _uni(ids, 93, 1, S.CDEMO_ROWS))
            cols["sr_hdemo_sk"] = Column(
                T.BIGINT, _uni(ids, 94, 1, S.HDEMO_ROWS))
            cols["sr_addr_sk"] = Column(T.BIGINT, _uni(ids, 95, 1, naddr))
            cols["sr_store_sk"] = Column(
                T.BIGINT, _uni(pid, 56, 1, S.row_count("store", sf)))
            cols["sr_reason_sk"] = Column(
                T.BIGINT, _uni(ids, 96, 1, S.row_count("reason", sf)))
            cols["sr_ticket_number"] = Column(
                T.BIGINT, 1 + pid.astype(np.int64) // 3)
            _return_money(cols, p, ids, 97)
        else:
            cols[f"{p}refunded_customer_sk"] = Column(
                T.BIGINT, _uni(pid, 66, 1, ncust))
            cols[f"{p}refunded_cdemo_sk"] = Column(
                T.BIGINT, _uni(ids, 93, 1, S.CDEMO_ROWS))
            cols[f"{p}refunded_hdemo_sk"] = Column(
                T.BIGINT, _uni(ids, 94, 1, S.HDEMO_ROWS))
            cols[f"{p}refunded_addr_sk"] = Column(
                T.BIGINT, _uni(ids, 95, 1, naddr))
            cols[f"{p}returning_customer_sk"] = Column(
                T.BIGINT, _uni(ids, 98, 1, ncust))
            cols[f"{p}returning_cdemo_sk"] = Column(
                T.BIGINT, _uni(ids, 99, 1, S.CDEMO_ROWS))
            cols[f"{p}returning_hdemo_sk"] = Column(
                T.BIGINT, _uni(ids, 100, 1, S.HDEMO_ROWS))
            cols[f"{p}returning_addr_sk"] = Column(
                T.BIGINT, _uni(ids, 101, 1, naddr))
            if p == "cr_":
                cols["cr_call_center_sk"] = Column(
                    T.BIGINT, _uni(pid, 73, 1,
                                   S.row_count("call_center", sf)))
                cols["cr_catalog_page_sk"] = Column(
                    T.BIGINT, _uni(pid, 74, 1,
                                   S.row_count("catalog_page", sf)))
                cols["cr_ship_mode_sk"] = Column(
                    T.BIGINT, _uni(pid, 75, 1,
                                   S.row_count("ship_mode", sf)))
                cols["cr_warehouse_sk"] = Column(
                    T.BIGINT, _uni(pid, 76, 1,
                                   S.row_count("warehouse", sf)))
            else:
                cols["wr_web_page_sk"] = Column(
                    T.BIGINT, _uni(pid, 73, 1,
                                   S.row_count("web_page", sf)))
            cols[f"{p}reason_sk"] = Column(
                T.BIGINT, _uni(ids, 96, 1, S.row_count("reason", sf)))
            cols[f"{p}order_number"] = Column(
                T.BIGINT, 1 + pid.astype(np.int64) // 4)
            if p == "cr_":
                _return_money(cols, p, ids, 97, amt_name="return_amount")
            else:
                _return_money(cols, p, ids, 97,
                              credit_name="account_credit")
    else:
        raise KeyError(table)
    order = [c for c, _ in S.TABLE_SCHEMAS[table]]
    return Table({c: cols[c] for c in order})


def attach(runner, sf: float = 0.1) -> None:
    """Register the TPC-DS connector on a runner's catalog (the
    plugin-loading analogue of ``TpcdsPlugin``).  Tables generate lazily
    on first scan through the connector's page source."""
    from ..connector.tpcds import tpcds_connector
    runner.datasource.register(tpcds_connector(sf))
