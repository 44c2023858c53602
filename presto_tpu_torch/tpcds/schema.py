"""TPC-DS logical schemas — the full 24-table star schema.

The analogue of the reference's ``plugin/trino-tpcds`` metadata
(``TpcdsMetadata.java``/``TpcdsTableName.java``; the reference wraps the
Teradata dsdgen port).  Column names/types follow the TPC-DS v2 spec
(including the spec's own ``s_tax_precentage`` typo).  The generator
(``generator.py``) is deterministic and spec-SHAPED (row counts, key
relationships, domains) but not byte-identical to dsdgen, which is why
correctness is established by the SQLite differential battery over the
generated data rather than by canned answer sets.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..data import types as T

_D = T.decimal
_V = T.varchar
BIGINT, DATE = T.BIGINT, T.DATE

# ---------------------------------------------------------------- schemas

TABLE_SCHEMAS: Dict[str, List[Tuple[str, T.DataType]]] = {
    "date_dim": [
        ("d_date_sk", BIGINT), ("d_date_id", _V(16)), ("d_date", DATE),
        ("d_month_seq", BIGINT), ("d_week_seq", BIGINT),
        ("d_quarter_seq", BIGINT), ("d_year", BIGINT), ("d_dow", BIGINT),
        ("d_moy", BIGINT), ("d_dom", BIGINT), ("d_qoy", BIGINT),
        ("d_fy_year", BIGINT), ("d_fy_quarter_seq", BIGINT),
        ("d_fy_week_seq", BIGINT), ("d_day_name", _V(9)),
        ("d_quarter_name", _V(6)), ("d_holiday", _V(1)),
        ("d_weekend", _V(1)), ("d_following_holiday", _V(1)),
        ("d_first_dom", BIGINT), ("d_last_dom", BIGINT),
        ("d_same_day_ly", BIGINT), ("d_same_day_lq", BIGINT),
        ("d_current_day", _V(1)), ("d_current_week", _V(1)),
        ("d_current_month", _V(1)), ("d_current_quarter", _V(1)),
        ("d_current_year", _V(1)),
    ],
    "time_dim": [
        ("t_time_sk", BIGINT), ("t_time_id", _V(16)), ("t_time", BIGINT),
        ("t_hour", BIGINT), ("t_minute", BIGINT), ("t_second", BIGINT),
        ("t_am_pm", _V(2)), ("t_shift", _V(20)), ("t_sub_shift", _V(20)),
        ("t_meal_time", _V(20)),
    ],
    "item": [
        ("i_item_sk", BIGINT), ("i_item_id", _V(16)),
        ("i_rec_start_date", DATE), ("i_rec_end_date", DATE),
        ("i_item_desc", _V(200)), ("i_current_price", _D(7, 2)),
        ("i_wholesale_cost", _D(7, 2)), ("i_brand_id", BIGINT),
        ("i_brand", _V(50)), ("i_class_id", BIGINT), ("i_class", _V(50)),
        ("i_category_id", BIGINT), ("i_category", _V(50)),
        ("i_manufact_id", BIGINT), ("i_manufact", _V(50)),
        ("i_size", _V(20)), ("i_formulation", _V(20)),
        ("i_color", _V(20)), ("i_units", _V(10)), ("i_container", _V(10)),
        ("i_manager_id", BIGINT), ("i_product_name", _V(50)),
    ],
    "store": [
        ("s_store_sk", BIGINT), ("s_store_id", _V(16)),
        ("s_rec_start_date", DATE), ("s_rec_end_date", DATE),
        ("s_closed_date_sk", BIGINT), ("s_store_name", _V(50)),
        ("s_number_employees", BIGINT), ("s_floor_space", BIGINT),
        ("s_hours", _V(20)), ("s_manager", _V(40)),
        ("s_market_id", BIGINT), ("s_geography_class", _V(100)),
        ("s_market_desc", _V(100)), ("s_market_manager", _V(40)),
        ("s_division_id", BIGINT), ("s_division_name", _V(50)),
        ("s_company_id", BIGINT), ("s_company_name", _V(50)),
        ("s_street_number", _V(10)), ("s_street_name", _V(60)),
        ("s_street_type", _V(15)), ("s_suite_number", _V(10)),
        ("s_city", _V(60)), ("s_county", _V(30)), ("s_state", _V(2)),
        ("s_zip", _V(10)), ("s_country", _V(20)),
        ("s_gmt_offset", _D(5, 2)), ("s_tax_precentage", _D(5, 2)),
    ],
    "call_center": [
        ("cc_call_center_sk", BIGINT), ("cc_call_center_id", _V(16)),
        ("cc_rec_start_date", DATE), ("cc_rec_end_date", DATE),
        ("cc_closed_date_sk", BIGINT), ("cc_open_date_sk", BIGINT),
        ("cc_name", _V(50)), ("cc_class", _V(50)),
        ("cc_employees", BIGINT), ("cc_sq_ft", BIGINT),
        ("cc_hours", _V(20)), ("cc_manager", _V(40)),
        ("cc_mkt_id", BIGINT), ("cc_mkt_class", _V(50)),
        ("cc_mkt_desc", _V(100)), ("cc_market_manager", _V(40)),
        ("cc_division", BIGINT), ("cc_division_name", _V(50)),
        ("cc_company", BIGINT), ("cc_company_name", _V(50)),
        ("cc_street_number", _V(10)), ("cc_street_name", _V(60)),
        ("cc_street_type", _V(15)), ("cc_suite_number", _V(10)),
        ("cc_city", _V(60)), ("cc_county", _V(30)), ("cc_state", _V(2)),
        ("cc_zip", _V(10)), ("cc_country", _V(20)),
        ("cc_gmt_offset", _D(5, 2)), ("cc_tax_percentage", _D(5, 2)),
    ],
    "catalog_page": [
        ("cp_catalog_page_sk", BIGINT), ("cp_catalog_page_id", _V(16)),
        ("cp_start_date_sk", BIGINT), ("cp_end_date_sk", BIGINT),
        ("cp_department", _V(50)), ("cp_catalog_number", BIGINT),
        ("cp_catalog_page_number", BIGINT), ("cp_description", _V(100)),
        ("cp_type", _V(100)),
    ],
    "web_site": [
        ("web_site_sk", BIGINT), ("web_site_id", _V(16)),
        ("web_rec_start_date", DATE), ("web_rec_end_date", DATE),
        ("web_name", _V(50)), ("web_open_date_sk", BIGINT),
        ("web_close_date_sk", BIGINT), ("web_class", _V(50)),
        ("web_manager", _V(40)), ("web_mkt_id", BIGINT),
        ("web_mkt_class", _V(50)), ("web_mkt_desc", _V(100)),
        ("web_market_manager", _V(40)), ("web_company_id", BIGINT),
        ("web_company_name", _V(50)), ("web_street_number", _V(10)),
        ("web_street_name", _V(60)), ("web_street_type", _V(15)),
        ("web_suite_number", _V(10)), ("web_city", _V(60)),
        ("web_county", _V(30)), ("web_state", _V(2)), ("web_zip", _V(10)),
        ("web_country", _V(20)), ("web_gmt_offset", _D(5, 2)),
        ("web_tax_percentage", _D(5, 2)),
    ],
    "web_page": [
        ("wp_web_page_sk", BIGINT), ("wp_web_page_id", _V(16)),
        ("wp_rec_start_date", DATE), ("wp_rec_end_date", DATE),
        ("wp_creation_date_sk", BIGINT), ("wp_access_date_sk", BIGINT),
        ("wp_autogen_flag", _V(1)), ("wp_customer_sk", BIGINT),
        ("wp_url", _V(100)), ("wp_type", _V(50)),
        ("wp_char_count", BIGINT), ("wp_link_count", BIGINT),
        ("wp_image_count", BIGINT), ("wp_max_ad_count", BIGINT),
    ],
    "warehouse": [
        ("w_warehouse_sk", BIGINT), ("w_warehouse_id", _V(16)),
        ("w_warehouse_name", _V(20)), ("w_warehouse_sq_ft", BIGINT),
        ("w_street_number", _V(10)), ("w_street_name", _V(60)),
        ("w_street_type", _V(15)), ("w_suite_number", _V(10)),
        ("w_city", _V(60)), ("w_county", _V(30)), ("w_state", _V(2)),
        ("w_zip", _V(10)), ("w_country", _V(20)),
        ("w_gmt_offset", _D(5, 2)),
    ],
    "reason": [
        ("r_reason_sk", BIGINT), ("r_reason_id", _V(16)),
        ("r_reason_desc", _V(100)),
    ],
    "ship_mode": [
        ("sm_ship_mode_sk", BIGINT), ("sm_ship_mode_id", _V(16)),
        ("sm_type", _V(30)), ("sm_code", _V(10)), ("sm_carrier", _V(20)),
        ("sm_contract", _V(20)),
    ],
    "income_band": [
        ("ib_income_band_sk", BIGINT), ("ib_lower_bound", BIGINT),
        ("ib_upper_bound", BIGINT),
    ],
    "promotion": [
        ("p_promo_sk", BIGINT), ("p_promo_id", _V(16)),
        ("p_start_date_sk", BIGINT), ("p_end_date_sk", BIGINT),
        ("p_item_sk", BIGINT), ("p_cost", _D(15, 2)),
        ("p_response_target", BIGINT), ("p_promo_name", _V(50)),
        ("p_channel_dmail", _V(1)), ("p_channel_email", _V(1)),
        ("p_channel_catalog", _V(1)), ("p_channel_tv", _V(1)),
        ("p_channel_radio", _V(1)), ("p_channel_press", _V(1)),
        ("p_channel_event", _V(1)), ("p_channel_demo", _V(1)),
        ("p_channel_details", _V(100)), ("p_purpose", _V(15)),
        ("p_discount_active", _V(1)),
    ],
    "customer_demographics": [
        ("cd_demo_sk", BIGINT), ("cd_gender", _V(1)),
        ("cd_marital_status", _V(1)), ("cd_education_status", _V(20)),
        ("cd_purchase_estimate", BIGINT), ("cd_credit_rating", _V(10)),
        ("cd_dep_count", BIGINT), ("cd_dep_employed_count", BIGINT),
        ("cd_dep_college_count", BIGINT),
    ],
    "household_demographics": [
        ("hd_demo_sk", BIGINT), ("hd_income_band_sk", BIGINT),
        ("hd_buy_potential", _V(15)), ("hd_dep_count", BIGINT),
        ("hd_vehicle_count", BIGINT),
    ],
    "customer": [
        ("c_customer_sk", BIGINT), ("c_customer_id", _V(16)),
        ("c_current_cdemo_sk", BIGINT), ("c_current_hdemo_sk", BIGINT),
        ("c_current_addr_sk", BIGINT), ("c_first_shipto_date_sk", BIGINT),
        ("c_first_sales_date_sk", BIGINT), ("c_salutation", _V(10)),
        ("c_first_name", _V(20)), ("c_last_name", _V(30)),
        ("c_preferred_cust_flag", _V(1)), ("c_birth_day", BIGINT),
        ("c_birth_month", BIGINT), ("c_birth_year", BIGINT),
        ("c_birth_country", _V(20)), ("c_login", _V(13)),
        ("c_email_address", _V(50)), ("c_last_review_date_sk", BIGINT),
    ],
    "customer_address": [
        ("ca_address_sk", BIGINT), ("ca_address_id", _V(16)),
        ("ca_street_number", _V(10)), ("ca_street_name", _V(60)),
        ("ca_street_type", _V(15)), ("ca_suite_number", _V(10)),
        ("ca_city", _V(60)), ("ca_county", _V(30)), ("ca_state", _V(2)),
        ("ca_zip", _V(10)), ("ca_country", _V(20)),
        ("ca_gmt_offset", _D(5, 2)), ("ca_location_type", _V(20)),
    ],
    "inventory": [
        ("inv_date_sk", BIGINT), ("inv_item_sk", BIGINT),
        ("inv_warehouse_sk", BIGINT), ("inv_quantity_on_hand", BIGINT),
    ],
    "store_sales": [
        ("ss_sold_date_sk", BIGINT), ("ss_sold_time_sk", BIGINT),
        ("ss_item_sk", BIGINT), ("ss_customer_sk", BIGINT),
        ("ss_cdemo_sk", BIGINT), ("ss_hdemo_sk", BIGINT),
        ("ss_addr_sk", BIGINT), ("ss_store_sk", BIGINT),
        ("ss_promo_sk", BIGINT), ("ss_ticket_number", BIGINT),
        ("ss_quantity", BIGINT), ("ss_wholesale_cost", _D(7, 2)),
        ("ss_list_price", _D(7, 2)), ("ss_sales_price", _D(7, 2)),
        ("ss_ext_discount_amt", _D(7, 2)), ("ss_ext_sales_price", _D(7, 2)),
        ("ss_ext_wholesale_cost", _D(7, 2)), ("ss_ext_list_price", _D(7, 2)),
        ("ss_ext_tax", _D(7, 2)), ("ss_coupon_amt", _D(7, 2)),
        ("ss_net_paid", _D(7, 2)), ("ss_net_paid_inc_tax", _D(7, 2)),
        ("ss_net_profit", _D(7, 2)),
    ],
    "store_returns": [
        ("sr_returned_date_sk", BIGINT), ("sr_return_time_sk", BIGINT),
        ("sr_item_sk", BIGINT), ("sr_customer_sk", BIGINT),
        ("sr_cdemo_sk", BIGINT), ("sr_hdemo_sk", BIGINT),
        ("sr_addr_sk", BIGINT), ("sr_store_sk", BIGINT),
        ("sr_reason_sk", BIGINT), ("sr_ticket_number", BIGINT),
        ("sr_return_quantity", BIGINT), ("sr_return_amt", _D(7, 2)),
        ("sr_return_tax", _D(7, 2)), ("sr_return_amt_inc_tax", _D(7, 2)),
        ("sr_fee", _D(7, 2)), ("sr_return_ship_cost", _D(7, 2)),
        ("sr_refunded_cash", _D(7, 2)), ("sr_reversed_charge", _D(7, 2)),
        ("sr_store_credit", _D(7, 2)), ("sr_net_loss", _D(7, 2)),
    ],
    "catalog_sales": [
        ("cs_sold_date_sk", BIGINT), ("cs_sold_time_sk", BIGINT),
        ("cs_ship_date_sk", BIGINT), ("cs_bill_customer_sk", BIGINT),
        ("cs_bill_cdemo_sk", BIGINT), ("cs_bill_hdemo_sk", BIGINT),
        ("cs_bill_addr_sk", BIGINT), ("cs_ship_customer_sk", BIGINT),
        ("cs_ship_cdemo_sk", BIGINT), ("cs_ship_hdemo_sk", BIGINT),
        ("cs_ship_addr_sk", BIGINT), ("cs_call_center_sk", BIGINT),
        ("cs_catalog_page_sk", BIGINT), ("cs_ship_mode_sk", BIGINT),
        ("cs_warehouse_sk", BIGINT), ("cs_item_sk", BIGINT),
        ("cs_promo_sk", BIGINT), ("cs_order_number", BIGINT),
        ("cs_quantity", BIGINT), ("cs_wholesale_cost", _D(7, 2)),
        ("cs_list_price", _D(7, 2)), ("cs_sales_price", _D(7, 2)),
        ("cs_ext_discount_amt", _D(7, 2)), ("cs_ext_sales_price", _D(7, 2)),
        ("cs_ext_wholesale_cost", _D(7, 2)), ("cs_ext_list_price", _D(7, 2)),
        ("cs_ext_tax", _D(7, 2)), ("cs_coupon_amt", _D(7, 2)),
        ("cs_ext_ship_cost", _D(7, 2)), ("cs_net_paid", _D(7, 2)),
        ("cs_net_paid_inc_tax", _D(7, 2)),
        ("cs_net_paid_inc_ship", _D(7, 2)),
        ("cs_net_paid_inc_ship_tax", _D(7, 2)), ("cs_net_profit", _D(7, 2)),
    ],
    "catalog_returns": [
        ("cr_returned_date_sk", BIGINT), ("cr_returned_time_sk", BIGINT),
        ("cr_item_sk", BIGINT), ("cr_refunded_customer_sk", BIGINT),
        ("cr_refunded_cdemo_sk", BIGINT), ("cr_refunded_hdemo_sk", BIGINT),
        ("cr_refunded_addr_sk", BIGINT),
        ("cr_returning_customer_sk", BIGINT),
        ("cr_returning_cdemo_sk", BIGINT),
        ("cr_returning_hdemo_sk", BIGINT),
        ("cr_returning_addr_sk", BIGINT), ("cr_call_center_sk", BIGINT),
        ("cr_catalog_page_sk", BIGINT), ("cr_ship_mode_sk", BIGINT),
        ("cr_warehouse_sk", BIGINT), ("cr_reason_sk", BIGINT),
        ("cr_order_number", BIGINT), ("cr_return_quantity", BIGINT),
        ("cr_return_amount", _D(7, 2)), ("cr_return_tax", _D(7, 2)),
        ("cr_return_amt_inc_tax", _D(7, 2)), ("cr_fee", _D(7, 2)),
        ("cr_return_ship_cost", _D(7, 2)), ("cr_refunded_cash", _D(7, 2)),
        ("cr_reversed_charge", _D(7, 2)), ("cr_store_credit", _D(7, 2)),
        ("cr_net_loss", _D(7, 2)),
    ],
    "web_sales": [
        ("ws_sold_date_sk", BIGINT), ("ws_sold_time_sk", BIGINT),
        ("ws_ship_date_sk", BIGINT), ("ws_item_sk", BIGINT),
        ("ws_bill_customer_sk", BIGINT), ("ws_bill_cdemo_sk", BIGINT),
        ("ws_bill_hdemo_sk", BIGINT), ("ws_bill_addr_sk", BIGINT),
        ("ws_ship_customer_sk", BIGINT), ("ws_ship_cdemo_sk", BIGINT),
        ("ws_ship_hdemo_sk", BIGINT), ("ws_ship_addr_sk", BIGINT),
        ("ws_web_page_sk", BIGINT), ("ws_web_site_sk", BIGINT),
        ("ws_ship_mode_sk", BIGINT), ("ws_warehouse_sk", BIGINT),
        ("ws_promo_sk", BIGINT), ("ws_order_number", BIGINT),
        ("ws_quantity", BIGINT), ("ws_wholesale_cost", _D(7, 2)),
        ("ws_list_price", _D(7, 2)), ("ws_sales_price", _D(7, 2)),
        ("ws_ext_discount_amt", _D(7, 2)), ("ws_ext_sales_price", _D(7, 2)),
        ("ws_ext_wholesale_cost", _D(7, 2)), ("ws_ext_list_price", _D(7, 2)),
        ("ws_ext_tax", _D(7, 2)), ("ws_coupon_amt", _D(7, 2)),
        ("ws_ext_ship_cost", _D(7, 2)), ("ws_net_paid", _D(7, 2)),
        ("ws_net_paid_inc_tax", _D(7, 2)),
        ("ws_net_paid_inc_ship", _D(7, 2)),
        ("ws_net_paid_inc_ship_tax", _D(7, 2)), ("ws_net_profit", _D(7, 2)),
    ],
    "web_returns": [
        ("wr_returned_date_sk", BIGINT), ("wr_returned_time_sk", BIGINT),
        ("wr_item_sk", BIGINT), ("wr_refunded_customer_sk", BIGINT),
        ("wr_refunded_cdemo_sk", BIGINT), ("wr_refunded_hdemo_sk", BIGINT),
        ("wr_refunded_addr_sk", BIGINT),
        ("wr_returning_customer_sk", BIGINT),
        ("wr_returning_cdemo_sk", BIGINT),
        ("wr_returning_hdemo_sk", BIGINT),
        ("wr_returning_addr_sk", BIGINT), ("wr_web_page_sk", BIGINT),
        ("wr_reason_sk", BIGINT), ("wr_order_number", BIGINT),
        ("wr_return_quantity", BIGINT), ("wr_return_amt", _D(7, 2)),
        ("wr_return_tax", _D(7, 2)), ("wr_return_amt_inc_tax", _D(7, 2)),
        ("wr_fee", _D(7, 2)), ("wr_return_ship_cost", _D(7, 2)),
        ("wr_refunded_cash", _D(7, 2)), ("wr_reversed_charge", _D(7, 2)),
        ("wr_account_credit", _D(7, 2)), ("wr_net_loss", _D(7, 2)),
    ],
}

# surrogate primary keys (unique-build join detection; fact tables carry
# composite keys — item_sk + ticket/order — declared where queries join
# on them)
PRIMARY_KEYS: Dict[str, Tuple[str, ...]] = {
    "date_dim": ("d_date_sk",), "time_dim": ("t_time_sk",),
    "item": ("i_item_sk",), "store": ("s_store_sk",),
    "call_center": ("cc_call_center_sk",),
    "catalog_page": ("cp_catalog_page_sk",),
    "web_site": ("web_site_sk",), "web_page": ("wp_web_page_sk",),
    "warehouse": ("w_warehouse_sk",), "reason": ("r_reason_sk",),
    "ship_mode": ("sm_ship_mode_sk",),
    "income_band": ("ib_income_band_sk",),
    "promotion": ("p_promo_sk",),
    "customer_demographics": ("cd_demo_sk",),
    "household_demographics": ("hd_demo_sk",),
    "customer": ("c_customer_sk",),
    "customer_address": ("ca_address_sk",),
    "store_sales": ("ss_item_sk", "ss_ticket_number"),
    "store_returns": ("sr_item_sk", "sr_ticket_number"),
    "catalog_sales": ("cs_item_sk", "cs_order_number"),
    "catalog_returns": ("cr_item_sk", "cr_order_number"),
    "web_sales": ("ws_item_sk", "ws_order_number"),
    "web_returns": ("wr_item_sk", "wr_order_number"),
    "inventory": ("inv_date_sk", "inv_item_sk", "inv_warehouse_sk"),
}

# ------------------------------------------------------------- row counts
# spec scaling (dsdgen): dimensions fixed or sub-linear, facts linear.
# sub-SF1 shrinks proportionally with floors so `tiny` runs stay tiny.

DATE_ROWS = 73049            # 1900-01-01 .. 2100-01-01
TIME_ROWS = 86400
CDEMO_ROWS = 1920800
HDEMO_ROWS = 7200
INCOME_BANDS = 20

_SF1_BASE = {
    "item": 18000, "store": 12, "call_center": 6, "catalog_page": 11718,
    "web_site": 30, "web_page": 60, "warehouse": 5, "reason": 35,
    "ship_mode": 20, "promotion": 300, "customer": 100000,
    "customer_address": 50000, "store_sales": 2880404,
    "store_returns": 287514, "catalog_sales": 1441548,
    "catalog_returns": 144067, "web_sales": 719384, "web_returns": 71763,
    "inventory": 11745000,
}

_FLOORS = {
    "item": 1000, "store": 2, "call_center": 2, "catalog_page": 200,
    "web_site": 2, "web_page": 4, "warehouse": 1, "reason": 10,
    "ship_mode": 20, "promotion": 30, "customer": 1000,
    "customer_address": 500, "store_sales": 1000, "store_returns": 100,
    "catalog_sales": 600, "catalog_returns": 60, "web_sales": 300,
    "web_returns": 30, "inventory": 1000,
}

# dimensions that scale ~sqrt above SF1 (dsdgen steps them; sqrt is the
# right growth shape for shape-faithful planning estimates)
_SQRT_TABLES = {"item", "store", "call_center", "web_site", "web_page",
                "warehouse", "customer", "customer_address"}


def row_count(table: str, sf: float) -> int:
    fixed = {"date_dim": DATE_ROWS, "time_dim": TIME_ROWS,
             "customer_demographics": CDEMO_ROWS,
             "household_demographics": HDEMO_ROWS,
             "income_band": INCOME_BANDS}
    if table in fixed:
        return fixed[table]
    base = _SF1_BASE[table]
    if sf >= 1 and table in _SQRT_TABLES:
        return int(base * max(sf ** 0.5, 1))
    if sf >= 1:
        return int(base * sf)
    return max(int(base * sf), _FLOORS[table])
