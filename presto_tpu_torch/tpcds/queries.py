"""TPC-DS query texts (the subset runnable on the shipped column set).

Adapted from the public TPC-DS specification queries (same shapes the
reference ships in ``plugin/trino-tpcds``); queries whose tables/columns
are outside the generated subset are not included yet.
"""

QUERIES = {
    3: """
select d_year, i_brand_id, i_brand, sum(ss_ext_sales_price) sum_agg
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk and ss_item_sk = i_item_sk
  and i_manufact_id = 128 and d_moy = 11
group by d_year, i_brand_id, i_brand
order by d_year, sum_agg desc, i_brand_id
limit 100
""",
    7: """
select i_item_id, avg(ss_quantity) agg1, avg(ss_list_price) agg2,
       avg(ss_coupon_amt) agg3, avg(ss_sales_price) agg4
from store_sales, customer_demographics, date_dim, item, promotion
where ss_sold_date_sk = d_date_sk and ss_item_sk = i_item_sk
  and ss_cdemo_sk = cd_demo_sk and ss_promo_sk = p_promo_sk
  and cd_gender = 'M' and cd_marital_status = 'S'
  and cd_education_status = 'College'
  and (p_channel_email = 'N' or p_channel_tv = 'N') and d_year = 2000
group by i_item_id
order by i_item_id
limit 100
""",
    19: """
select i_brand_id, i_brand, i_manufact_id, i_manufact,
       sum(ss_ext_sales_price) ext_price
from date_dim, store_sales, item, customer, customer_address, store
where d_date_sk = ss_sold_date_sk and ss_item_sk = i_item_sk
  and i_manager_id = 8 and d_moy = 11 and d_year = 1998
  and ss_customer_sk = c_customer_sk
  and c_current_addr_sk = ca_address_sk
  and substr(ca_zip, 1, 5) <> substr(s_zip, 1, 5)
  and ss_store_sk = s_store_sk
group by i_brand_id, i_brand, i_manufact_id, i_manufact
order by ext_price desc, i_brand, i_brand_id, i_manufact_id, i_manufact
limit 100
""",
    42: """
select d_year, i_category_id, i_category, sum(ss_ext_sales_price) s
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk and ss_item_sk = i_item_sk
  and i_manager_id = 1 and d_moy = 11 and d_year = 2000
group by d_year, i_category_id, i_category
order by s desc, d_year, i_category_id, i_category
limit 100
""",
    52: """
select d_year, i_brand_id brand_id, i_brand brand,
       sum(ss_ext_sales_price) ext_price
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk and ss_item_sk = i_item_sk
  and i_manager_id = 1 and d_moy = 11 and d_year = 2000
group by d_year, i_brand_id, i_brand
order by d_year, ext_price desc, brand_id
limit 100
""",
    55: """
select i_brand_id brand_id, i_brand brand,
       sum(ss_ext_sales_price) ext_price
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk and ss_item_sk = i_item_sk
  and i_manager_id = 28 and d_moy = 11 and d_year = 1999
group by i_brand_id, i_brand
order by ext_price desc, brand_id
limit 100
""",
    96: """
select count(*) cnt
from store_sales, household_demographics, time_dim, store
where ss_sold_time_sk = t_time_sk and ss_hdemo_sk = hd_demo_sk
  and ss_store_sk = s_store_sk
  and t_hour = 20 and t_minute >= 30 and hd_dep_count = 7
  and s_store_name = 'ese'
""",
    13: """
select avg(ss_quantity) q, sum(ss_ext_sales_price) s,
       sum(ss_ext_wholesale_cost) w
from store_sales, store, customer_demographics, household_demographics,
     customer_address, date_dim
where s_store_sk = ss_store_sk and ss_sold_date_sk = d_date_sk
  and d_year = 2001
  and ss_hdemo_sk = hd_demo_sk and ss_cdemo_sk = cd_demo_sk
  and cd_marital_status = 'M' and cd_education_status = 'College'
  and hd_dep_count = 3
  and ss_addr_sk = ca_address_sk and ca_country = 'United States'
  and ca_state in ('TN', 'GA', 'AL')
""",
    15: """
select ca_zip, sum(cs_sales_price) s
from catalog_sales, customer, customer_address, date_dim
where cs_bill_customer_sk = c_customer_sk
  and c_current_addr_sk = ca_address_sk
  and (substr(ca_zip, 1, 5) in ('85669', '86197', '88274', '83405',
                                '86475', '85392', '85460', '80348')
       or ca_state in ('CA', 'WA', 'GA')
       or cs_sales_price > 50)
  and cs_sold_date_sk = d_date_sk and d_qoy = 2 and d_year = 2001
group by ca_zip
order by ca_zip
limit 100
""",
    25: """
select i_item_id, i_item_desc, s_store_id, s_store_name,
       sum(ss_net_profit) store_sales_profit,
       sum(sr_net_loss) store_returns_loss
from store_sales, store_returns, date_dim d1, date_dim d2, store, item
where d1.d_moy = 4 and d1.d_year = 2001
  and d1.d_date_sk = ss_sold_date_sk and i_item_sk = ss_item_sk
  and s_store_sk = ss_store_sk
  and ss_customer_sk = sr_customer_sk and ss_item_sk = sr_item_sk
  and ss_ticket_number = sr_ticket_number
  and sr_returned_date_sk = d2.d_date_sk
  and d2.d_moy between 4 and 10 and d2.d_year = 2001
group by i_item_id, i_item_desc, s_store_id, s_store_name
order by i_item_id, i_item_desc, s_store_id, s_store_name
limit 100
""",
    26: """
select i_item_id, avg(cs_quantity) agg1, avg(cs_list_price) agg2,
       avg(cs_coupon_amt) agg3, avg(cs_sales_price) agg4
from catalog_sales, customer_demographics, date_dim, item, promotion
where cs_sold_date_sk = d_date_sk and cs_item_sk = i_item_sk
  and cs_bill_cdemo_sk = cd_demo_sk and cs_promo_sk = p_promo_sk
  and cd_gender = 'M' and cd_marital_status = 'S'
  and cd_education_status = 'College'
  and (p_channel_email = 'N' or p_channel_event = 'N') and d_year = 2000
group by i_item_id
order by i_item_id
limit 100
""",
    29: """
select i_item_id, i_item_desc, s_store_id, s_store_name,
       sum(ss_quantity) store_sales_quantity,
       sum(sr_return_quantity) store_returns_quantity
from store_sales, store_returns, date_dim d1, date_dim d2, store, item
where d1.d_moy = 9 and d1.d_year = 1999
  and d1.d_date_sk = ss_sold_date_sk and i_item_sk = ss_item_sk
  and s_store_sk = ss_store_sk
  and ss_customer_sk = sr_customer_sk and ss_item_sk = sr_item_sk
  and ss_ticket_number = sr_ticket_number
  and sr_returned_date_sk = d2.d_date_sk
  and d2.d_moy between 9 and 12 and d2.d_year = 1999
group by i_item_id, i_item_desc, s_store_id, s_store_name
order by i_item_id, i_item_desc, s_store_id, s_store_name
limit 100
""",
    37: """
select i_item_id, i_item_desc, i_current_price
from item, inventory, date_dim, catalog_sales
where i_current_price between 20 and 50
  and inv_item_sk = i_item_sk and d_date_sk = inv_date_sk
  and d_year = 1998
  and i_manufact_id in (800, 801, 802, 803)
  and inv_quantity_on_hand between 100 and 500
  and cs_item_sk = i_item_sk
group by i_item_id, i_item_desc, i_current_price
order by i_item_id
limit 100
""",
    40: """
select w_state, i_item_id,
       sum(case when d_date < date '2000-03-11'
           then cs_sales_price - coalesce(cr_refunded_cash, 0)
           else 0 end) sales_before,
       sum(case when d_date >= date '2000-03-11'
           then cs_sales_price - coalesce(cr_refunded_cash, 0)
           else 0 end) sales_after
from catalog_sales
     left join catalog_returns
       on cs_order_number = cr_order_number and cs_item_sk = cr_item_sk,
     warehouse, item, date_dim
where i_current_price between 99 and 1500
  and i_item_sk = cs_item_sk and cs_warehouse_sk = w_warehouse_sk
  and cs_sold_date_sk = d_date_sk
  and d_date between date '2000-02-10' and date '2000-04-10'
group by w_state, i_item_id
order by w_state, i_item_id
limit 100
""",
    43: """
select s_store_name, s_store_id,
       sum(case when d_day_name = 'Sunday' then ss_sales_price
           else null end) sun_sales,
       sum(case when d_day_name = 'Monday' then ss_sales_price
           else null end) mon_sales,
       sum(case when d_day_name = 'Friday' then ss_sales_price
           else null end) fri_sales,
       sum(case when d_day_name = 'Saturday' then ss_sales_price
           else null end) sat_sales
from date_dim, store_sales, store
where d_date_sk = ss_sold_date_sk and s_store_sk = ss_store_sk
  and s_gmt_offset = -5 and d_year = 2000
group by s_store_name, s_store_id
order by s_store_name, s_store_id
limit 100
""",
    45: """
select ca_zip, ca_city, sum(ws_sales_price) s
from web_sales, customer, customer_address, date_dim, item
where ws_bill_customer_sk = c_customer_sk
  and c_current_addr_sk = ca_address_sk
  and ws_item_sk = i_item_sk
  and (substr(ca_zip, 1, 5) in ('85669', '86197', '88274', '83405',
                                '86475', '85392', '85460', '80348')
       or i_item_id in (select i_item_id from item
                        where i_item_sk in (2, 3, 5, 7, 11, 13, 17, 19)))
  and ws_sold_date_sk = d_date_sk and d_qoy = 2 and d_year = 2001
group by ca_zip, ca_city
order by ca_zip, ca_city
limit 100
""",
    50: """
select s_store_name, s_company_id, s_street_number, s_street_name,
       s_street_type, s_suite_number, s_city, s_county, s_state, s_zip,
       sum(case when sr_returned_date_sk - ss_sold_date_sk <= 30
           then 1 else 0 end) days_30,
       sum(case when sr_returned_date_sk - ss_sold_date_sk > 30
            and sr_returned_date_sk - ss_sold_date_sk <= 60
           then 1 else 0 end) days_31_60,
       sum(case when sr_returned_date_sk - ss_sold_date_sk > 60
           then 1 else 0 end) days_over_60
from store_sales, store_returns, store, date_dim d1, date_dim d2
where d2.d_year = 2001 and d2.d_moy = 8
  and ss_ticket_number = sr_ticket_number and ss_item_sk = sr_item_sk
  and ss_sold_date_sk = d1.d_date_sk
  and sr_returned_date_sk = d2.d_date_sk
  and ss_customer_sk = sr_customer_sk and ss_store_sk = s_store_sk
group by s_store_name, s_company_id, s_street_number, s_street_name,
         s_street_type, s_suite_number, s_city, s_county, s_state, s_zip
order by s_store_name, s_company_id
limit 100
""",
    62: """
select substr(w_warehouse_name, 1, 20) wname, sm_type, web_name,
       sum(case when ws_ship_date_sk - ws_sold_date_sk <= 30
           then 1 else 0 end) days_30,
       sum(case when ws_ship_date_sk - ws_sold_date_sk > 30
            and ws_ship_date_sk - ws_sold_date_sk <= 60
           then 1 else 0 end) days_31_60,
       sum(case when ws_ship_date_sk - ws_sold_date_sk > 60
           then 1 else 0 end) days_over_60
from web_sales, warehouse, ship_mode, web_site, date_dim
where d_year = 2001
  and ws_ship_date_sk = d_date_sk
  and ws_warehouse_sk = w_warehouse_sk
  and ws_ship_mode_sk = sm_ship_mode_sk
  and ws_web_site_sk = web_site_sk
group by substr(w_warehouse_name, 1, 20), sm_type, web_name
order by wname, sm_type, web_name
limit 100
""",
    65: """
select s_store_name, i_item_desc, sc.revenue, i_current_price,
       i_wholesale_cost, i_brand
from store, item,
     (select ss_store_sk, avg(revenue) as ave
      from (select ss_store_sk, ss_item_sk, sum(ss_sales_price) as revenue
            from store_sales, date_dim
            where ss_sold_date_sk = d_date_sk and d_year = 2001
            group by ss_store_sk, ss_item_sk) sa
      group by ss_store_sk) sb,
     (select ss_store_sk, ss_item_sk, sum(ss_sales_price) as revenue
      from store_sales, date_dim
      where ss_sold_date_sk = d_date_sk and d_year = 2001
      group by ss_store_sk, ss_item_sk) sc
where sb.ss_store_sk = sc.ss_store_sk
  and sc.revenue <= 0.1 * sb.ave
  and s_store_sk = sc.ss_store_sk and i_item_sk = sc.ss_item_sk
order by s_store_name, i_item_desc, sc.revenue
limit 100
""",
    79: """
select c_last_name, c_first_name, s_city, profit
from (select ss_ticket_number, ss_customer_sk, s_city,
             sum(ss_coupon_amt) amt, sum(ss_net_profit) profit
      from store_sales, date_dim, store, household_demographics
      where ss_sold_date_sk = d_date_sk and ss_store_sk = s_store_sk
        and ss_hdemo_sk = hd_demo_sk
        and (hd_dep_count = 6 or hd_vehicle_count > 2)
        and d_dow = 1 and d_year = 1999
        and s_number_employees between 200 and 295
      group by ss_ticket_number, ss_customer_sk, ss_addr_sk, s_city) ms,
     customer
where ss_customer_sk = c_customer_sk
order by c_last_name, c_first_name, s_city, profit, ss_ticket_number
limit 100
""",
    82: """
select i_item_id, i_item_desc, i_current_price
from item, inventory, date_dim, store_sales
where i_current_price between 30 and 60
  and inv_item_sk = i_item_sk and d_date_sk = inv_date_sk
  and d_year = 1998
  and i_manufact_id in (437, 129, 727, 663)
  and inv_quantity_on_hand between 100 and 500
  and ss_item_sk = i_item_sk
group by i_item_id, i_item_desc, i_current_price
order by i_item_id
limit 100
""",
    88: """
select *
from (select count(*) h8_30_to_9 from store_sales, household_demographics,
      time_dim, store
      where ss_sold_time_sk = t_time_sk and ss_hdemo_sk = hd_demo_sk
        and ss_store_sk = s_store_sk and t_hour = 8 and t_minute >= 30
        and hd_dep_count = 2 and s_store_name = 'ese') s1,
     (select count(*) h9_to_9_30 from store_sales, household_demographics,
      time_dim, store
      where ss_sold_time_sk = t_time_sk and ss_hdemo_sk = hd_demo_sk
        and ss_store_sk = s_store_sk and t_hour = 9 and t_minute < 30
        and hd_dep_count = 2 and s_store_name = 'ese') s2,
     (select count(*) h12_to_12_30 from store_sales,
      household_demographics, time_dim, store
      where ss_sold_time_sk = t_time_sk and ss_hdemo_sk = hd_demo_sk
        and ss_store_sk = s_store_sk and t_hour = 12 and t_minute < 30
        and hd_dep_count = 2 and s_store_name = 'ese') s3
""",
    91: """
select cc_call_center_id, cc_name, cc_manager,
       sum(cr_net_loss) returns_loss
from call_center, catalog_returns, date_dim, customer,
     customer_demographics, household_demographics
where cr_call_center_sk = cc_call_center_sk
  and cr_returned_date_sk = d_date_sk
  and cr_returning_customer_sk = c_customer_sk
  and cd_demo_sk = c_current_cdemo_sk
  and hd_demo_sk = c_current_hdemo_sk
  and d_year = 1998 and d_moy = 11
  and cd_marital_status = 'M' and cd_education_status = 'Unknown'
  and hd_buy_potential like 'Unknown%'
group by cc_call_center_id, cc_name, cc_manager
order by returns_loss desc, cc_call_center_id
limit 100
""",
    93: """
select ss_customer_sk, sum(act_sales) sumsales
from (select ss_item_sk, ss_ticket_number, ss_customer_sk,
             case when sr_return_quantity is not null
                  then (ss_quantity - sr_return_quantity) * ss_sales_price
                  else ss_quantity * ss_sales_price end act_sales
      from store_sales
           left join store_returns
             on sr_item_sk = ss_item_sk
            and sr_ticket_number = ss_ticket_number,
           reason
      where sr_reason_sk = r_reason_sk and r_reason_desc = 'reason 1'
     ) t
group by ss_customer_sk
order by sumsales, ss_customer_sk
limit 100
""",
    99: """
select substr(w_warehouse_name, 1, 20) wname, sm_type, cc_name,
       sum(case when cs_ship_date_sk - cs_sold_date_sk <= 30
           then 1 else 0 end) days_30,
       sum(case when cs_ship_date_sk - cs_sold_date_sk > 30
            and cs_ship_date_sk - cs_sold_date_sk <= 60
           then 1 else 0 end) days_31_60,
       sum(case when cs_ship_date_sk - cs_sold_date_sk > 60
           then 1 else 0 end) days_over_60
from catalog_sales, warehouse, ship_mode, call_center, date_dim
where d_year = 2001
  and cs_ship_date_sk = d_date_sk
  and cs_warehouse_sk = w_warehouse_sk
  and cs_ship_mode_sk = sm_ship_mode_sk
  and cs_call_center_sk = cc_call_center_sk
group by substr(w_warehouse_name, 1, 20), sm_type, cc_name
order by wname, sm_type, cc_name
limit 100
""",
    12: """
select i_item_id, i_item_desc, i_category, i_class, i_current_price,
       sum(ws_ext_sales_price) itemrevenue,
       sum(ws_ext_sales_price) * 100 / sum(sum(ws_ext_sales_price))
           over (partition by i_class) revenueratio
from web_sales, item, date_dim
where ws_item_sk = i_item_sk
  and i_category in ('Sports', 'Books', 'Home')
  and ws_sold_date_sk = d_date_sk
  and d_date between date '1999-02-22' and date '1999-03-24'
group by i_item_id, i_item_desc, i_category, i_class, i_current_price
order by i_category, i_class, i_item_id, i_item_desc, revenueratio
limit 100
""",
    16: """
select count(distinct cs_order_number) order_count,
       sum(cs_ext_ship_cost) total_shipping_cost,
       sum(cs_net_profit) total_net_profit
from catalog_sales cs1, date_dim, customer_address, call_center
where d_date between date '2002-02-01' and date '2002-04-02'
  and cs1.cs_ship_date_sk = d_date_sk
  and cs1.cs_ship_addr_sk = ca_address_sk
  and ca_state = 'GA'
  and cs1.cs_call_center_sk = cc_call_center_sk
  and exists (select 1 from catalog_sales cs2
              where cs1.cs_order_number = cs2.cs_order_number
                and cs1.cs_warehouse_sk <> cs2.cs_warehouse_sk)
  and not exists (select 1 from catalog_returns cr1
                  where cs1.cs_order_number = cr1.cr_order_number)
""",
    20: """
select i_item_id, i_item_desc, i_category, i_class, i_current_price,
       sum(cs_ext_sales_price) itemrevenue,
       sum(cs_ext_sales_price) * 100 / sum(sum(cs_ext_sales_price))
           over (partition by i_class) revenueratio
from catalog_sales, item, date_dim
where cs_item_sk = i_item_sk
  and i_category in ('Sports', 'Books', 'Home')
  and cs_sold_date_sk = d_date_sk
  and d_date between date '1999-02-22' and date '1999-03-24'
group by i_item_id, i_item_desc, i_category, i_class, i_current_price
order by i_category, i_class, i_item_id, i_item_desc, revenueratio
limit 100
""",
    21: """
select w_warehouse_name, i_item_id,
       sum(case when d_date < date '2000-03-11'
           then inv_quantity_on_hand else 0 end) inv_before,
       sum(case when d_date >= date '2000-03-11'
           then inv_quantity_on_hand else 0 end) inv_after
from inventory, warehouse, item, date_dim
where i_current_price between 0.99 and 1.49
  and i_item_sk = inv_item_sk
  and inv_warehouse_sk = w_warehouse_sk
  and inv_date_sk = d_date_sk
  and d_date between date '2000-02-10' and date '2000-04-10'
group by w_warehouse_name, i_item_id
having sum(case when d_date < date '2000-03-11'
           then inv_quantity_on_hand else 0 end) > 0
order by w_warehouse_name, i_item_id
limit 100
""",
    27: """
select i_item_id, s_state, grouping(s_state) g_state,
       avg(ss_quantity) agg1, avg(ss_list_price) agg2,
       avg(ss_coupon_amt) agg3, avg(ss_sales_price) agg4
from store_sales, customer_demographics, date_dim, store, item
where ss_sold_date_sk = d_date_sk
  and ss_item_sk = i_item_sk
  and ss_store_sk = s_store_sk
  and ss_cdemo_sk = cd_demo_sk
  and cd_gender = 'M' and cd_marital_status = 'S'
  and cd_education_status = 'College'
  and d_year = 2002
group by rollup(i_item_id, s_state)
order by i_item_id, s_state
limit 100
""",
    28: """
select b1_lp, b1_cnt, b1_cntd, b2_lp, b2_cnt, b2_cntd,
       b3_lp, b3_cnt, b3_cntd
from (select avg(ss_list_price) b1_lp, count(ss_list_price) b1_cnt,
             count(distinct ss_list_price) b1_cntd
      from store_sales
      where ss_quantity between 0 and 5
        and (ss_list_price between 8 and 8 + 10
             or ss_coupon_amt between 459 and 459 + 1000
             or ss_wholesale_cost between 57 and 57 + 20)) b1,
     (select avg(ss_list_price) b2_lp, count(ss_list_price) b2_cnt,
             count(distinct ss_list_price) b2_cntd
      from store_sales
      where ss_quantity between 6 and 10
        and (ss_list_price between 90 and 90 + 10
             or ss_coupon_amt between 2323 and 2323 + 1000
             or ss_wholesale_cost between 31 and 31 + 20)) b2,
     (select avg(ss_list_price) b3_lp, count(ss_list_price) b3_cnt,
             count(distinct ss_list_price) b3_cntd
      from store_sales
      where ss_quantity between 11 and 15
        and (ss_list_price between 142 and 142 + 10
             or ss_coupon_amt between 12214 and 12214 + 1000
             or ss_wholesale_cost between 79 and 79 + 20)) b3
limit 100
""",
    33: """
with ss as (
  select i_manufact_id, sum(ss_ext_sales_price) total_sales
  from store_sales, date_dim, customer_address, item
  where i_manufact_id in (select i_manufact_id from item
                          where i_category in ('Electronics'))
    and ss_item_sk = i_item_sk and ss_sold_date_sk = d_date_sk
    and d_year = 1998 and d_moy = 5
    and ss_addr_sk = ca_address_sk and ca_gmt_offset = -5
  group by i_manufact_id),
 cs as (
  select i_manufact_id, sum(cs_ext_sales_price) total_sales
  from catalog_sales, date_dim, customer_address, item
  where i_manufact_id in (select i_manufact_id from item
                          where i_category in ('Electronics'))
    and cs_item_sk = i_item_sk and cs_sold_date_sk = d_date_sk
    and d_year = 1998 and d_moy = 5
    and cs_bill_addr_sk = ca_address_sk and ca_gmt_offset = -5
  group by i_manufact_id),
 ws as (
  select i_manufact_id, sum(ws_ext_sales_price) total_sales
  from web_sales, date_dim, customer_address, item
  where i_manufact_id in (select i_manufact_id from item
                          where i_category in ('Electronics'))
    and ws_item_sk = i_item_sk and ws_sold_date_sk = d_date_sk
    and d_year = 1998 and d_moy = 5
    and ws_bill_addr_sk = ca_address_sk and ca_gmt_offset = -5
  group by i_manufact_id)
select i_manufact_id, sum(total_sales) total_sales
from (select i_manufact_id, total_sales from ss
      union all select i_manufact_id, total_sales from cs
      union all select i_manufact_id, total_sales from ws) tmp1
group by i_manufact_id
order by total_sales, i_manufact_id
limit 100
""",
    34: """
select c_last_name, c_first_name, c_salutation,
       c_preferred_cust_flag, ss_ticket_number, cnt
from (select ss_ticket_number, ss_customer_sk, count(*) cnt
      from store_sales, date_dim, store, household_demographics
      where ss_sold_date_sk = d_date_sk
        and ss_store_sk = s_store_sk
        and ss_hdemo_sk = hd_demo_sk
        and (d_dom between 1 and 3 or d_dom between 25 and 28)
        and (hd_buy_potential = '>10000'
             or hd_buy_potential = 'Unknown')
        and hd_vehicle_count > 0
        and d_year in (1999, 2000, 2001)
      group by ss_ticket_number, ss_customer_sk) dn, customer
where ss_customer_sk = c_customer_sk
  and cnt between 15 and 20
order by c_last_name, c_first_name, c_salutation,
         c_preferred_cust_flag desc, ss_ticket_number
limit 100
""",
    38: """
select count(*) c from (
  select distinct c_last_name, c_first_name, d_date
  from store_sales, date_dim, customer
  where store_sales.ss_sold_date_sk = date_dim.d_date_sk
    and store_sales.ss_customer_sk = customer.c_customer_sk
    and d_month_seq between 1200 and 1200 + 11
  intersect
  select distinct c_last_name, c_first_name, d_date
  from catalog_sales, date_dim, customer
  where catalog_sales.cs_sold_date_sk = date_dim.d_date_sk
    and catalog_sales.cs_bill_customer_sk = customer.c_customer_sk
    and d_month_seq between 1200 and 1200 + 11
  intersect
  select distinct c_last_name, c_first_name, d_date
  from web_sales, date_dim, customer
  where web_sales.ws_sold_date_sk = date_dim.d_date_sk
    and web_sales.ws_bill_customer_sk = customer.c_customer_sk
    and d_month_seq between 1200 and 1200 + 11
) hot_cust
limit 100
""",
    41: """
select distinct i_product_name
from item i1
where i_manufact_id between 738 and 738 + 40
  and (select count(*) from item
       where i_manufact = i1.i_manufact
         and ((i_category = 'Women' and i_color in ('powder', 'khaki'))
              or (i_category = 'Men' and i_color in ('brown', 'honeydew'))))
      > 0
order by i_product_name
limit 100
""",
    48: """
select sum(ss_quantity) q
from store_sales, store, customer_demographics,
     customer_address, date_dim
where s_store_sk = ss_store_sk
  and ss_sold_date_sk = d_date_sk and d_year = 2000
  and ss_cdemo_sk = cd_demo_sk
  and ((cd_marital_status = 'M'
        and cd_education_status = '4 yr Degree'
        and ss_sales_price between 100.00 and 150.00)
       or (cd_marital_status = 'D'
           and cd_education_status = '2 yr Degree'
           and ss_sales_price between 50.00 and 100.00)
       or (cd_marital_status = 'S'
           and cd_education_status = 'College'
           and ss_sales_price between 150.00 and 200.00))
  and ss_addr_sk = ca_address_sk and ca_country = 'United States'
  and ((ca_state in ('CO', 'OH', 'TX')
        and ss_net_profit between 0 and 2000)
       or (ca_state in ('OR', 'MN', 'KY')
           and ss_net_profit between 150 and 3000)
       or (ca_state in ('VA', 'CA', 'MS')
           and ss_net_profit between 50 and 25000))
""",
    98: """
select i_item_id, i_item_desc, i_category, i_class, i_current_price,
       sum(ss_ext_sales_price) itemrevenue,
       sum(ss_ext_sales_price) * 100 / sum(sum(ss_ext_sales_price))
           over (partition by i_class) revenueratio
from store_sales, item, date_dim
where ss_item_sk = i_item_sk
  and i_category in ('Sports', 'Books', 'Home')
  and ss_sold_date_sk = d_date_sk
  and d_date between date '1999-02-22' and date '1999-03-24'
group by i_item_id, i_item_desc, i_category, i_class, i_current_price
order by i_category, i_class, i_item_id, i_item_desc, revenueratio
limit 100
""",
    46: """
select c_last_name, c_first_name, ca_city, bought_city,
       ss_ticket_number, amt, profit
from (select ss_ticket_number, ss_customer_sk, ca_city bought_city,
             sum(ss_coupon_amt) amt, sum(ss_net_profit) profit
      from store_sales, date_dim, store, household_demographics,
           customer_address
      where ss_sold_date_sk = d_date_sk
        and ss_store_sk = s_store_sk
        and ss_hdemo_sk = hd_demo_sk
        and ss_addr_sk = ca_address_sk
        and (hd_dep_count = 4 or hd_vehicle_count = 3)
        and d_dow in (6, 0)
        and d_year in (1999, 2000, 2001)
      group by ss_ticket_number, ss_customer_sk, ss_addr_sk, ca_city) dn,
     customer, customer_address current_addr
where ss_customer_sk = c_customer_sk
  and customer.c_current_addr_sk = current_addr.ca_address_sk
  and current_addr.ca_city <> bought_city
order by c_last_name, c_first_name, ca_city, bought_city,
         ss_ticket_number
limit 100
""",
    47: """
with v1 as (
  select i_category, i_brand, s_store_name, s_company_name,
         d_year, d_moy, sum(ss_sales_price) sum_sales,
         avg(sum(ss_sales_price)) over (
           partition by i_category, i_brand, s_store_name,
                        s_company_name, d_year) avg_monthly_sales,
         rank() over (
           partition by i_category, i_brand, s_store_name,
                        s_company_name
           order by d_year, d_moy) rn
  from item, store_sales, date_dim, store
  where ss_item_sk = i_item_sk and ss_sold_date_sk = d_date_sk
    and ss_store_sk = s_store_sk
    and (d_year = 1999
         or (d_year = 1998 and d_moy = 12)
         or (d_year = 2000 and d_moy = 1))
  group by i_category, i_brand, s_store_name, s_company_name,
           d_year, d_moy),
 v2 as (
  select v1.i_category, v1.i_brand, v1.s_store_name,
         v1.s_company_name, v1.d_year, v1.d_moy, v1.avg_monthly_sales,
         v1.sum_sales, v1_lag.sum_sales psum, v1_lead.sum_sales nsum
  from v1, v1 v1_lag, v1 v1_lead
  where v1.i_category = v1_lag.i_category
    and v1.i_category = v1_lead.i_category
    and v1.i_brand = v1_lag.i_brand
    and v1.i_brand = v1_lead.i_brand
    and v1.s_store_name = v1_lag.s_store_name
    and v1.s_store_name = v1_lead.s_store_name
    and v1.s_company_name = v1_lag.s_company_name
    and v1.s_company_name = v1_lead.s_company_name
    and v1.rn = v1_lag.rn + 1
    and v1.rn = v1_lead.rn - 1)
select * from v2
where d_year = 1999
  and avg_monthly_sales > 0
  and abs(sum_sales - avg_monthly_sales) / avg_monthly_sales > 0.1
order by sum_sales - avg_monthly_sales, s_store_name
limit 100
""",
    51: """
with web_v1 as (
  select ws_item_sk item_sk, d_date,
         sum(sum(ws_sales_price)) over (
           partition by ws_item_sk order by d_date
           rows between unbounded preceding and current row) cume_sales
  from web_sales, date_dim
  where ws_sold_date_sk = d_date_sk
    and d_month_seq between 1200 and 1200 + 11
    and ws_item_sk is not null
  group by ws_item_sk, d_date),
 store_v1 as (
  select ss_item_sk item_sk, d_date,
         sum(sum(ss_sales_price)) over (
           partition by ss_item_sk order by d_date
           rows between unbounded preceding and current row) cume_sales
  from store_sales, date_dim
  where ss_sold_date_sk = d_date_sk
    and d_month_seq between 1200 and 1200 + 11
    and ss_item_sk is not null
  group by ss_item_sk, d_date)
select item_sk, d_date, web_sales, store_sales,
       max(web_sales) over (
         partition by item_sk order by d_date
         rows between unbounded preceding and current row) web_cumulative,
       max(store_sales) over (
         partition by item_sk order by d_date
         rows between unbounded preceding and current row) store_cumulative
from (select case when web.item_sk is not null then web.item_sk
                  else store.item_sk end item_sk,
             case when web.d_date is not null then web.d_date
                  else store.d_date end d_date,
             web.cume_sales web_sales, store.cume_sales store_sales
      from web_v1 web left join store_v1 store
        on web.item_sk = store.item_sk and web.d_date = store.d_date) x
order by item_sk, d_date
limit 100
""",
    53: """
select manufact_id, sum_sales, avg_quarterly_sales
from (select i_manufact_id manufact_id,
             sum(ss_sales_price) sum_sales,
             avg(sum(ss_sales_price)) over (
               partition by i_manufact_id) avg_quarterly_sales
      from item, store_sales, date_dim, store
      where ss_item_sk = i_item_sk and ss_sold_date_sk = d_date_sk
        and ss_store_sk = s_store_sk
        and d_month_seq in (1200, 1201, 1202, 1203, 1204, 1205,
                            1206, 1207, 1208, 1209, 1210, 1211)
        and i_category in ('Books', 'Children', 'Electronics')
        and i_class in ('personal', 'portable', 'reference',
                        'self-help')
      group by i_manufact_id, d_qoy) tmp1
where case when avg_quarterly_sales > 0
      then abs(sum_sales - avg_quarterly_sales) / avg_quarterly_sales
      else 0 end > 0.1
order by avg_quarterly_sales, sum_sales, manufact_id
limit 100
""",
    57: """
with v1 as (
  select i_category, i_brand, cc_name, d_year, d_moy,
         sum(cs_sales_price) sum_sales,
         avg(sum(cs_sales_price)) over (
           partition by i_category, i_brand, cc_name, d_year)
           avg_monthly_sales,
         rank() over (
           partition by i_category, i_brand, cc_name
           order by d_year, d_moy) rn
  from item, catalog_sales, date_dim, call_center
  where cs_item_sk = i_item_sk and cs_sold_date_sk = d_date_sk
    and cc_call_center_sk = cs_call_center_sk
    and (d_year = 1999
         or (d_year = 1998 and d_moy = 12)
         or (d_year = 2000 and d_moy = 1))
  group by i_category, i_brand, cc_name, d_year, d_moy),
 v2 as (
  select v1.i_category, v1.i_brand, v1.cc_name, v1.d_year, v1.d_moy,
         v1.avg_monthly_sales, v1.sum_sales,
         v1_lag.sum_sales psum, v1_lead.sum_sales nsum
  from v1, v1 v1_lag, v1 v1_lead
  where v1.i_category = v1_lag.i_category
    and v1.i_category = v1_lead.i_category
    and v1.i_brand = v1_lag.i_brand
    and v1.i_brand = v1_lead.i_brand
    and v1.cc_name = v1_lag.cc_name
    and v1.cc_name = v1_lead.cc_name
    and v1.rn = v1_lag.rn + 1
    and v1.rn = v1_lead.rn - 1)
select * from v2
where d_year = 1999
  and avg_monthly_sales > 0
  and abs(sum_sales - avg_monthly_sales) / avg_monthly_sales > 0.1
order by sum_sales - avg_monthly_sales, cc_name
limit 100
""",
    59: """
with wss as (
  select d_week_seq, ss_store_sk,
         sum(case when d_dow = 0 then ss_sales_price else 0 end)
             sun_sales,
         sum(case when d_dow = 1 then ss_sales_price else 0 end)
             mon_sales,
         sum(case when d_dow = 2 then ss_sales_price else 0 end)
             tue_sales,
         sum(case when d_dow = 3 then ss_sales_price else 0 end)
             wed_sales,
         sum(case when d_dow = 4 then ss_sales_price else 0 end)
             thu_sales,
         sum(case when d_dow = 5 then ss_sales_price else 0 end)
             fri_sales,
         sum(case when d_dow = 6 then ss_sales_price else 0 end)
             sat_sales
  from store_sales, date_dim
  where d_date_sk = ss_sold_date_sk
  group by d_week_seq, ss_store_sk)
select s_store_name s_store_name1, wss.d_week_seq d_week_seq1,
       s_store_id s_store_id1, sun_sales sun_sales1,
       mon_sales mon_sales1, tue_sales tue_sales1,
       wed_sales wed_sales1, thu_sales thu_sales1,
       fri_sales fri_sales1, sat_sales sat_sales1
from wss, store, date_dim d
where d.d_week_seq = wss.d_week_seq
  and ss_store_sk = s_store_sk
  and d_month_seq between 1185 and 1185 + 11
  and d_dom = 1
order by s_store_name1, s_store_id1, d_week_seq1, sun_sales1
limit 100
""",
    60: """
with ss as (
  select i_item_id, sum(ss_ext_sales_price) total_sales
  from store_sales, date_dim, customer_address, item
  where i_item_id in (select i_item_id from item
                      where i_category in ('Music'))
    and ss_item_sk = i_item_sk and ss_sold_date_sk = d_date_sk
    and d_year = 1998 and d_moy = 9
    and ss_addr_sk = ca_address_sk and ca_gmt_offset = -5
  group by i_item_id),
 cs as (
  select i_item_id, sum(cs_ext_sales_price) total_sales
  from catalog_sales, date_dim, customer_address, item
  where i_item_id in (select i_item_id from item
                      where i_category in ('Music'))
    and cs_item_sk = i_item_sk and cs_sold_date_sk = d_date_sk
    and d_year = 1998 and d_moy = 9
    and cs_bill_addr_sk = ca_address_sk and ca_gmt_offset = -5
  group by i_item_id),
 ws as (
  select i_item_id, sum(ws_ext_sales_price) total_sales
  from web_sales, date_dim, customer_address, item
  where i_item_id in (select i_item_id from item
                      where i_category in ('Music'))
    and ws_item_sk = i_item_sk and ws_sold_date_sk = d_date_sk
    and d_year = 1998 and d_moy = 9
    and ws_bill_addr_sk = ca_address_sk and ca_gmt_offset = -5
  group by i_item_id)
select i_item_id, sum(total_sales) total_sales
from (select i_item_id, total_sales from ss
      union all select i_item_id, total_sales from cs
      union all select i_item_id, total_sales from ws) tmp1
group by i_item_id
order by i_item_id, total_sales
limit 100
""",
    61: """
select promotions, total,
       cast(promotions as double) / cast(total as double) * 100 ratio
from (select sum(ss_ext_sales_price) promotions
      from store_sales, store, promotion, date_dim, customer,
           customer_address, item
      where ss_sold_date_sk = d_date_sk
        and ss_store_sk = s_store_sk
        and ss_promo_sk = p_promo_sk
        and ss_customer_sk = c_customer_sk
        and ca_address_sk = c_current_addr_sk
        and ss_item_sk = i_item_sk
        and ca_gmt_offset = -5 and i_category = 'Jewelry'
        and (p_channel_dmail = 'Y' or p_channel_email = 'Y'
             or p_channel_tv = 'Y')
        and s_gmt_offset = -5 and d_year = 1998 and d_moy = 11)
     promotional_sales,
     (select sum(ss_ext_sales_price) total
      from store_sales, store, date_dim, customer,
           customer_address, item
      where ss_sold_date_sk = d_date_sk
        and ss_store_sk = s_store_sk
        and ss_customer_sk = c_customer_sk
        and ca_address_sk = c_current_addr_sk
        and ss_item_sk = i_item_sk
        and ca_gmt_offset = -5 and i_category = 'Jewelry'
        and s_gmt_offset = -5 and d_year = 1998 and d_moy = 11)
     all_sales
order by promotions, total
limit 100
""",
    63: """
select manager_id, sum_sales, avg_monthly_sales
from (select i_manager_id manager_id,
             sum(ss_sales_price) sum_sales,
             avg(sum(ss_sales_price)) over (
               partition by i_manager_id) avg_monthly_sales
      from item, store_sales, date_dim, store
      where ss_item_sk = i_item_sk and ss_sold_date_sk = d_date_sk
        and ss_store_sk = s_store_sk
        and d_month_seq in (1200, 1201, 1202, 1203, 1204, 1205,
                            1206, 1207, 1208, 1209, 1210, 1211)
        and i_category in ('Books', 'Children', 'Electronics')
      group by i_manager_id, d_moy) tmp1
where case when avg_monthly_sales > 0
      then abs(sum_sales - avg_monthly_sales) / avg_monthly_sales
      else 0 end > 0.1
order by manager_id, avg_monthly_sales, sum_sales
limit 100
""",
    68: """
select c_last_name, c_first_name, ca_city, bought_city,
       ss_ticket_number, extended_price, extended_tax, list_price
from (select ss_ticket_number, ss_customer_sk, ca_city bought_city,
             sum(ss_ext_sales_price) extended_price,
             sum(ss_ext_list_price) list_price,
             sum(ss_ext_tax) extended_tax
      from store_sales, date_dim, store, household_demographics,
           customer_address
      where ss_sold_date_sk = d_date_sk
        and ss_store_sk = s_store_sk
        and ss_hdemo_sk = hd_demo_sk
        and ss_addr_sk = ca_address_sk
        and d_dom between 1 and 2
        and (hd_dep_count = 4 or hd_vehicle_count = 3)
        and d_year in (1999, 2000, 2001)
      group by ss_ticket_number, ss_customer_sk, ss_addr_sk,
               ca_city) dn,
     customer, customer_address current_addr
where ss_customer_sk = c_customer_sk
  and customer.c_current_addr_sk = current_addr.ca_address_sk
  and current_addr.ca_city <> bought_city
order by c_last_name, ss_ticket_number
limit 100
""",
    69: """
select cd_gender, cd_marital_status, cd_education_status,
       count(*) cnt1, cd_purchase_estimate, count(*) cnt2,
       cd_credit_rating, count(*) cnt3
from customer c, customer_address ca, customer_demographics
where c.c_current_addr_sk = ca.ca_address_sk
  and ca_state in ('KY', 'GA', 'NM')
  and cd_demo_sk = c.c_current_cdemo_sk
  and exists (select 1 from store_sales, date_dim
              where c.c_customer_sk = ss_customer_sk
                and ss_sold_date_sk = d_date_sk
                and d_year = 2001 and d_moy between 4 and 6)
  and not exists (select 1 from web_sales, date_dim
                  where c.c_customer_sk = ws_bill_customer_sk
                    and ws_sold_date_sk = d_date_sk
                    and d_year = 2001 and d_moy between 4 and 6)
  and not exists (select 1 from catalog_sales, date_dim
                  where c.c_customer_sk = cs_ship_customer_sk
                    and cs_sold_date_sk = d_date_sk
                    and d_year = 2001 and d_moy between 4 and 6)
group by cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate, cd_credit_rating
order by cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate, cd_credit_rating
limit 100
""",
    71: """
select i_brand_id brand_id, i_brand brand, t_hour, t_minute,
       sum(ext_price) ext_price
from item,
     (select ws_ext_sales_price ext_price, ws_sold_date_sk sold_date_sk,
             ws_item_sk sold_item_sk, ws_sold_time_sk time_sk
      from web_sales, date_dim
      where d_date_sk = ws_sold_date_sk
        and d_moy = 11 and d_year = 1999
      union all
      select cs_ext_sales_price ext_price, cs_sold_date_sk sold_date_sk,
             cs_item_sk sold_item_sk, cs_sold_time_sk time_sk
      from catalog_sales, date_dim
      where d_date_sk = cs_sold_date_sk
        and d_moy = 11 and d_year = 1999
      union all
      select ss_ext_sales_price ext_price, ss_sold_date_sk sold_date_sk,
             ss_item_sk sold_item_sk, ss_sold_time_sk time_sk
      from store_sales, date_dim
      where d_date_sk = ss_sold_date_sk
        and d_moy = 11 and d_year = 1999) tmp,
     time_dim
where sold_item_sk = i_item_sk and i_manager_id = 1
  and time_sk = t_time_sk
  and (t_meal_time = 'breakfast' or t_meal_time = 'dinner')
group by i_brand, i_brand_id, t_hour, t_minute
order by ext_price desc, i_brand_id
limit 100
""",
    73: """
select c_last_name, c_first_name, c_salutation,
       c_preferred_cust_flag, ss_ticket_number, cnt
from (select ss_ticket_number, ss_customer_sk, count(*) cnt
      from store_sales, date_dim, store, household_demographics
      where ss_sold_date_sk = d_date_sk
        and ss_store_sk = s_store_sk
        and ss_hdemo_sk = hd_demo_sk
        and d_dom between 1 and 2
        and (hd_buy_potential = '>10000'
             or hd_buy_potential = 'Unknown')
        and hd_vehicle_count > 0
        and d_year in (1999, 2000, 2001)
      group by ss_ticket_number, ss_customer_sk) dj, customer
where ss_customer_sk = c_customer_sk
  and cnt between 1 and 5
order by cnt desc, c_last_name
limit 100
""",
    87: """
select count(*) c
from ((select distinct c_last_name, c_first_name, d_date
       from store_sales, date_dim, customer
       where store_sales.ss_sold_date_sk = date_dim.d_date_sk
         and store_sales.ss_customer_sk = customer.c_customer_sk
         and d_month_seq between 1200 and 1200 + 11)
      except
      (select distinct c_last_name, c_first_name, d_date
       from catalog_sales, date_dim, customer
       where catalog_sales.cs_sold_date_sk = date_dim.d_date_sk
         and catalog_sales.cs_bill_customer_sk = customer.c_customer_sk
         and d_month_seq between 1200 and 1200 + 11)
      except
      (select distinct c_last_name, c_first_name, d_date
       from web_sales, date_dim, customer
       where web_sales.ws_sold_date_sk = date_dim.d_date_sk
         and web_sales.ws_bill_customer_sk = customer.c_customer_sk
         and d_month_seq between 1200 and 1200 + 11)) cool_cust
""",
    89: """
select i_category, i_class, i_brand, s_store_name, s_company_name,
       d_moy, sum_sales, avg_monthly_sales
from (select i_category, i_class, i_brand, s_store_name,
             s_company_name, d_moy, sum(ss_sales_price) sum_sales,
             avg(sum(ss_sales_price)) over (
               partition by i_category, i_brand, s_store_name,
                            s_company_name) avg_monthly_sales
      from item, store_sales, date_dim, store
      where ss_item_sk = i_item_sk and ss_sold_date_sk = d_date_sk
        and ss_store_sk = s_store_sk and d_year = 1999
        and ((i_category in ('Books', 'Electronics', 'Sports')
              and i_class in ('computers', 'stereo', 'football'))
             or (i_category in ('Men', 'Jewelry', 'Women')
                 and i_class in ('shirts', 'birdal', 'dresses')))
      group by i_category, i_class, i_brand, s_store_name,
               s_company_name, d_moy) tmp1
where case when avg_monthly_sales <> 0
      then abs(sum_sales - avg_monthly_sales) / avg_monthly_sales
      else 0 end > 0.1
order by sum_sales - avg_monthly_sales, s_store_name
limit 100
""",
    92: """
select sum(ws_ext_discount_amt) excess_discount_amount
from web_sales, item, date_dim
where i_manufact_id = 350
  and i_item_sk = ws_item_sk
  and d_date between date '2000-01-27' and date '2000-04-26'
  and d_date_sk = ws_sold_date_sk
  and ws_ext_discount_amt > (
    select 1.3 * avg(ws_ext_discount_amt)
    from web_sales, date_dim
    where ws_item_sk = i_item_sk
      and d_date between date '2000-01-27' and date '2000-04-26'
      and d_date_sk = ws_sold_date_sk)
order by excess_discount_amount
limit 100
""",
    94: """
select count(distinct ws_order_number) order_count,
       sum(ws_ext_ship_cost) total_shipping_cost,
       sum(ws_net_profit) total_net_profit
from web_sales ws1, date_dim, customer_address, web_site
where d_date between date '1999-02-01' and date '1999-04-02'
  and ws1.ws_ship_date_sk = d_date_sk
  and ws1.ws_ship_addr_sk = ca_address_sk
  and ca_state = 'IL'
  and ws1.ws_web_site_sk = web_site_sk
  and web_company_name = 'pri'
  and exists (select 1 from web_sales ws2
              where ws1.ws_order_number = ws2.ws_order_number
                and ws1.ws_warehouse_sk <> ws2.ws_warehouse_sk)
  and not exists (select 1 from web_returns wr1
                  where ws1.ws_order_number = wr1.wr_order_number)
""",
    9: """
select case when (select count(*) from store_sales
                  where ss_quantity between 1 and 20) > 409437
            then (select avg(ss_ext_discount_amt) from store_sales
                  where ss_quantity between 1 and 20)
            else (select avg(ss_net_paid) from store_sales
                  where ss_quantity between 1 and 20) end bucket1,
       case when (select count(*) from store_sales
                  where ss_quantity between 21 and 40) > 4595804
            then (select avg(ss_ext_discount_amt) from store_sales
                  where ss_quantity between 21 and 40)
            else (select avg(ss_net_paid) from store_sales
                  where ss_quantity between 21 and 40) end bucket2,
       case when (select count(*) from store_sales
                  where ss_quantity between 41 and 60) > 7887297
            then (select avg(ss_ext_discount_amt) from store_sales
                  where ss_quantity between 41 and 60)
            else (select avg(ss_net_paid) from store_sales
                  where ss_quantity between 41 and 60) end bucket3
from reason
where r_reason_sk = 1
""",
    32: """
select sum(cs_ext_discount_amt) excess_discount_amount
from catalog_sales, item, date_dim
where i_manufact_id = 977
  and i_item_sk = cs_item_sk
  and d_date between date '2000-01-27' and date '2000-04-26'
  and d_date_sk = cs_sold_date_sk
  and cs_ext_discount_amt > (
    select 1.3 * avg(cs_ext_discount_amt)
    from catalog_sales, date_dim
    where cs_item_sk = i_item_sk
      and d_date between date '2000-01-27' and date '2000-04-26'
      and d_date_sk = cs_sold_date_sk)
limit 100
""",
    36: """
select gross_margin, i_category, i_class, lochierarchy, rank_within_parent
from (select cast(sum(ss_net_profit) as double)
             / cast(sum(ss_ext_sales_price) as double) gross_margin,
             i_category, i_class,
             grouping(i_category) + grouping(i_class) lochierarchy,
             rank() over (
               partition by grouping(i_category) + grouping(i_class),
                            case when grouping(i_class) = 0
                                 then i_category end
               order by cast(sum(ss_net_profit) as double)
                        / cast(sum(ss_ext_sales_price) as double) asc)
               rank_within_parent
      from store_sales, date_dim, item, store
      where d_year = 2001
        and d_date_sk = ss_sold_date_sk
        and i_item_sk = ss_item_sk
        and s_store_sk = ss_store_sk
        and s_state in ('TN', 'KY')
      group by rollup(i_category, i_class)) t
order by lochierarchy desc, rank_within_parent
limit 100
""",
    44: """
select asceding.rnk, i1.i_product_name best_performing,
       i2.i_product_name worst_performing
from (select v1.item_sk, rank() over (order by v1.rank_col asc) rnk
      from (select ss_item_sk item_sk, avg(ss_net_profit) rank_col
            from store_sales
            where ss_store_sk = 4
            group by ss_item_sk
            having avg(ss_net_profit) > 0.9 * (
              select avg(ss_net_profit) rank_col from store_sales
              where ss_store_sk = 4 and ss_hdemo_sk is null)) v1) asceding,
     (select v2.item_sk, rank() over (order by v2.rank_col desc) rnk
      from (select ss_item_sk item_sk, avg(ss_net_profit) rank_col
            from store_sales
            where ss_store_sk = 4
            group by ss_item_sk
            having avg(ss_net_profit) > 0.9 * (
              select avg(ss_net_profit) rank_col from store_sales
              where ss_store_sk = 4 and ss_hdemo_sk is null)) v2) descending,
     item i1, item i2
where asceding.rnk = descending.rnk
  and i1.i_item_sk = asceding.item_sk
  and i2.i_item_sk = descending.item_sk
  and asceding.rnk < 11
order by asceding.rnk
limit 100
""",
    58: """
with ss_items as (
  select i_item_id item_id, sum(ss_ext_sales_price) ss_item_rev
  from store_sales, item, date_dim
  where ss_item_sk = i_item_sk
    and d_date in (select d_date from date_dim
                   where d_week_seq = (select d_week_seq from date_dim
                                       where d_date = date '2000-01-03'))
    and ss_sold_date_sk = d_date_sk
  group by i_item_id),
 cs_items as (
  select i_item_id item_id, sum(cs_ext_sales_price) cs_item_rev
  from catalog_sales, item, date_dim
  where cs_item_sk = i_item_sk
    and d_date in (select d_date from date_dim
                   where d_week_seq = (select d_week_seq from date_dim
                                       where d_date = date '2000-01-03'))
    and cs_sold_date_sk = d_date_sk
  group by i_item_id),
 ws_items as (
  select i_item_id item_id, sum(ws_ext_sales_price) ws_item_rev
  from web_sales, item, date_dim
  where ws_item_sk = i_item_sk
    and d_date in (select d_date from date_dim
                   where d_week_seq = (select d_week_seq from date_dim
                                       where d_date = date '2000-01-03'))
    and ws_sold_date_sk = d_date_sk
  group by i_item_id)
select ss_items.item_id, ss_item_rev,
       cs_item_rev, ws_item_rev
from ss_items, cs_items, ws_items
where ss_items.item_id = cs_items.item_id
  and ss_items.item_id = ws_items.item_id
  and ss_item_rev between 0.9 * cs_item_rev and 1.1 * cs_item_rev
  and ss_item_rev between 0.9 * ws_item_rev and 1.1 * ws_item_rev
order by ss_items.item_id, ss_item_rev
limit 100
""",
    84: """
select c_customer_id customer_id,
       c_last_name || ', ' || c_first_name customername
from customer, customer_address, customer_demographics,
     household_demographics, income_band, store_returns
where ca_city = 'Edgewood'
  and c_current_addr_sk = ca_address_sk
  and ib_lower_bound >= 38128
  and ib_upper_bound <= 38128 + 50000
  and ib_income_band_sk = hd_income_band_sk
  and cd_demo_sk = c_current_cdemo_sk
  and hd_demo_sk = c_current_hdemo_sk
  and sr_cdemo_sk = cd_demo_sk
order by c_customer_id
limit 100
""",
    90: """
select cast(amc as double) / cast(pmc as double) am_pm_ratio
from (select count(*) amc from web_sales, household_demographics,
             time_dim, web_page
      where ws_sold_time_sk = time_dim.t_time_sk
        and ws_ship_hdemo_sk = household_demographics.hd_demo_sk
        and ws_web_page_sk = web_page.wp_web_page_sk
        and t_hour between 8 and 9
        and household_demographics.hd_dep_count = 6
        and web_page.wp_char_count between 5000 and 5200) at1,
     (select count(*) pmc from web_sales, household_demographics,
             time_dim, web_page
      where ws_sold_time_sk = time_dim.t_time_sk
        and ws_ship_hdemo_sk = household_demographics.hd_demo_sk
        and ws_web_page_sk = web_page.wp_web_page_sk
        and t_hour between 19 and 20
        and household_demographics.hd_dep_count = 6
        and web_page.wp_char_count between 5000 and 5200) pt
order by am_pm_ratio
limit 100
""",
    91: """
select cc_call_center_id call_center, cc_name call_center_name,
       cc_manager manager, sum(cr_net_loss) returns_loss
from call_center, catalog_returns, date_dim, customer,
     customer_address, customer_demographics, household_demographics
where cr_call_center_sk = cc_call_center_sk
  and cr_returned_date_sk = d_date_sk
  and cr_returning_customer_sk = c_customer_sk
  and cd_demo_sk = c_current_cdemo_sk
  and hd_demo_sk = c_current_hdemo_sk
  and ca_address_sk = c_current_addr_sk
  and d_year = 1998 and d_moy = 11
  and ((cd_marital_status = 'M' and cd_education_status = 'Unknown')
       or (cd_marital_status = 'W'
           and cd_education_status = 'Advanced Degree'))
  and hd_buy_potential like 'Unknown%'
  and ca_gmt_offset = -7
group by cc_call_center_id, cc_name, cc_manager,
         cd_marital_status, cd_education_status
order by returns_loss desc
""",
    95: """
with ws_wh as (
  select ws1.ws_order_number
  from web_sales ws1, web_sales ws2
  where ws1.ws_order_number = ws2.ws_order_number
    and ws1.ws_warehouse_sk <> ws2.ws_warehouse_sk)
select count(distinct ws_order_number) order_count,
       sum(ws_ext_ship_cost) total_shipping_cost,
       sum(ws_net_profit) total_net_profit
from web_sales ws1, date_dim, customer_address, web_site
where d_date between date '1999-02-01' and date '1999-04-02'
  and ws1.ws_ship_date_sk = d_date_sk
  and ws1.ws_ship_addr_sk = ca_address_sk
  and ca_state = 'IL'
  and ws1.ws_web_site_sk = web_site_sk
  and web_company_name = 'pri'
  and ws1.ws_order_number in (select ws_order_number from ws_wh)
  and ws1.ws_order_number in (select wr_order_number
                              from web_returns, ws_wh
                              where wr_order_number = ws_wh.ws_order_number)
""",
    1: """
with customer_total_return as (
  select sr_customer_sk ctr_customer_sk, sr_store_sk ctr_store_sk,
         sum(sr_return_amt) ctr_total_return
  from store_returns, date_dim
  where sr_returned_date_sk = d_date_sk and d_year = 2000
  group by sr_customer_sk, sr_store_sk)
select c_customer_id
from customer_total_return ctr1, store, customer
where ctr1.ctr_total_return >
      (select avg(ctr_total_return) * 1.2 from customer_total_return ctr2
       where ctr1.ctr_store_sk = ctr2.ctr_store_sk)
  and s_store_sk = ctr1.ctr_store_sk and s_state = 'TN'
  and ctr1.ctr_customer_sk = c_customer_sk
order by c_customer_id
limit 100
""",
    2: """
with wscs as (
  select ws_sold_date_sk sold_date_sk, ws_ext_sales_price sales_price
  from web_sales
  union all
  select cs_sold_date_sk sold_date_sk, cs_ext_sales_price sales_price
  from catalog_sales),
 wswscs as (
  select d_week_seq,
    sum(case when d_day_name = 'Sunday' then sales_price else null end) sun_sales,
    sum(case when d_day_name = 'Monday' then sales_price else null end) mon_sales,
    sum(case when d_day_name = 'Tuesday' then sales_price else null end) tue_sales,
    sum(case when d_day_name = 'Wednesday' then sales_price else null end) wed_sales,
    sum(case when d_day_name = 'Thursday' then sales_price else null end) thu_sales,
    sum(case when d_day_name = 'Friday' then sales_price else null end) fri_sales,
    sum(case when d_day_name = 'Saturday' then sales_price else null end) sat_sales
  from wscs, date_dim
  where d_date_sk = sold_date_sk
  group by d_week_seq)
select d_week_seq1, round(sun_sales1 / sun_sales2, 2),
       round(mon_sales1 / mon_sales2, 2), round(tue_sales1 / tue_sales2, 2),
       round(wed_sales1 / wed_sales2, 2), round(thu_sales1 / thu_sales2, 2),
       round(fri_sales1 / fri_sales2, 2), round(sat_sales1 / sat_sales2, 2)
from (select wswscs.d_week_seq d_week_seq1, sun_sales sun_sales1,
             mon_sales mon_sales1, tue_sales tue_sales1,
             wed_sales wed_sales1, thu_sales thu_sales1,
             fri_sales fri_sales1, sat_sales sat_sales1
      from wswscs, date_dim
      where date_dim.d_week_seq = wswscs.d_week_seq and d_year = 2001) y,
     (select wswscs.d_week_seq d_week_seq2, sun_sales sun_sales2,
             mon_sales mon_sales2, tue_sales tue_sales2,
             wed_sales wed_sales2, thu_sales thu_sales2,
             fri_sales fri_sales2, sat_sales sat_sales2
      from wswscs, date_dim
      where date_dim.d_week_seq = wswscs.d_week_seq and d_year = 2002) z
where d_week_seq1 = d_week_seq2 - 53
order by d_week_seq1
""",
    6: """
select a.ca_state state, count(*) cnt
from customer_address a, customer c, store_sales s, date_dim d, item i
where a.ca_address_sk = c.c_current_addr_sk
  and c.c_customer_sk = s.ss_customer_sk
  and s.ss_sold_date_sk = d.d_date_sk
  and s.ss_item_sk = i.i_item_sk
  and d.d_month_seq = (select distinct d_month_seq from date_dim
                       where d_year = 2001 and d_moy = 1)
  and i.i_current_price > (select 1.2 * avg(j.i_current_price)
                           from item j
                           where j.i_category = i.i_category)
group by a.ca_state
having count(*) >= 10
order by cnt, a.ca_state
limit 100
""",
    10: """
select cd_gender, cd_marital_status, cd_education_status, count(*) cnt1,
       cd_purchase_estimate, count(*) cnt2, cd_credit_rating, count(*) cnt3,
       cd_dep_count, count(*) cnt4, cd_dep_employed_count, count(*) cnt5,
       cd_dep_college_count, count(*) cnt6
from customer c, customer_address ca, customer_demographics
where c.c_current_addr_sk = ca.ca_address_sk
  and ca_county in ('Rush County', 'Toole County', 'Jefferson County',
                    'Dona Ana County', 'La Porte County')
  and cd_demo_sk = c.c_current_cdemo_sk
  and exists (select * from store_sales, date_dim
              where c.c_customer_sk = ss_customer_sk
                and ss_sold_date_sk = d_date_sk
                and d_year = 2002 and d_moy between 1 and 4)
  and (exists (select * from web_sales, date_dim
               where c.c_customer_sk = ws_bill_customer_sk
                 and ws_sold_date_sk = d_date_sk
                 and d_year = 2002 and d_moy between 1 and 4)
       or exists (select * from catalog_sales, date_dim
                  where c.c_customer_sk = cs_ship_customer_sk
                    and cs_sold_date_sk = d_date_sk
                    and d_year = 2002 and d_moy between 1 and 4))
group by cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate, cd_credit_rating, cd_dep_count,
         cd_dep_employed_count, cd_dep_college_count
order by cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate, cd_credit_rating, cd_dep_count,
         cd_dep_employed_count, cd_dep_college_count
limit 100
""",
    11: """
with year_total as (
  select c_customer_id customer_id, c_first_name customer_first_name,
         c_last_name customer_last_name,
         c_preferred_cust_flag customer_preferred_cust_flag,
         c_birth_country customer_birth_country,
         c_login customer_login,
         c_email_address customer_email_address,
         d_year dyear,
         sum(ss_ext_list_price - ss_ext_discount_amt) year_total,
         's' sale_type
  from customer, store_sales, date_dim
  where c_customer_sk = ss_customer_sk and ss_sold_date_sk = d_date_sk
  group by c_customer_id, c_first_name, c_last_name, c_preferred_cust_flag,
           c_birth_country, c_login, c_email_address, d_year
  union all
  select c_customer_id customer_id, c_first_name customer_first_name,
         c_last_name customer_last_name,
         c_preferred_cust_flag customer_preferred_cust_flag,
         c_birth_country customer_birth_country,
         c_login customer_login,
         c_email_address customer_email_address,
         d_year dyear,
         sum(ws_ext_list_price - ws_ext_discount_amt) year_total,
         'w' sale_type
  from customer, web_sales, date_dim
  where c_customer_sk = ws_bill_customer_sk and ws_sold_date_sk = d_date_sk
  group by c_customer_id, c_first_name, c_last_name, c_preferred_cust_flag,
           c_birth_country, c_login, c_email_address, d_year)
select t_s_secyear.customer_id, t_s_secyear.customer_first_name,
       t_s_secyear.customer_last_name,
       t_s_secyear.customer_preferred_cust_flag,
       t_s_secyear.customer_birth_country, t_s_secyear.customer_login
from year_total t_s_firstyear, year_total t_s_secyear,
     year_total t_w_firstyear, year_total t_w_secyear
where t_s_secyear.customer_id = t_s_firstyear.customer_id
  and t_s_firstyear.customer_id = t_w_secyear.customer_id
  and t_s_firstyear.customer_id = t_w_firstyear.customer_id
  and t_s_firstyear.sale_type = 's' and t_w_firstyear.sale_type = 'w'
  and t_s_secyear.sale_type = 's' and t_w_secyear.sale_type = 'w'
  and t_s_firstyear.dyear = 2001 and t_s_secyear.dyear = 2002
  and t_w_firstyear.dyear = 2001 and t_w_secyear.dyear = 2002
  and t_s_firstyear.year_total > 0 and t_w_firstyear.year_total > 0
  and (case when t_w_firstyear.year_total > 0
            then cast(t_w_secyear.year_total as double) / t_w_firstyear.year_total
            else 0.0 end) >
      (case when t_s_firstyear.year_total > 0
            then cast(t_s_secyear.year_total as double) / t_s_firstyear.year_total
            else 0.0 end)
order by t_s_secyear.customer_id, t_s_secyear.customer_first_name,
         t_s_secyear.customer_last_name,
         t_s_secyear.customer_preferred_cust_flag
limit 100
""",
    17: """
select i_item_id, i_item_desc, s_state,
       count(ss_quantity) store_sales_quantitycount,
       avg(ss_quantity) store_sales_quantityave,
       stddev_samp(ss_quantity) store_sales_quantitystdev,
       stddev_samp(ss_quantity) / avg(ss_quantity) store_sales_quantitycov,
       count(sr_return_quantity) store_returns_quantitycount,
       avg(sr_return_quantity) store_returns_quantityave,
       stddev_samp(sr_return_quantity) store_returns_quantitystdev,
       stddev_samp(sr_return_quantity) / avg(sr_return_quantity)
         store_returns_quantitycov,
       count(cs_quantity) catalog_sales_quantitycount,
       avg(cs_quantity) catalog_sales_quantityave,
       stddev_samp(cs_quantity) catalog_sales_quantitystdev,
       stddev_samp(cs_quantity) / avg(cs_quantity) catalog_sales_quantitycov
from store_sales, store_returns, catalog_sales, date_dim d1, date_dim d2,
     date_dim d3, store, item
where d1.d_quarter_name = '2001Q1' and d1.d_date_sk = ss_sold_date_sk
  and i_item_sk = ss_item_sk and s_store_sk = ss_store_sk
  and ss_customer_sk = sr_customer_sk and ss_item_sk = sr_item_sk
  and ss_ticket_number = sr_ticket_number
  and sr_returned_date_sk = d2.d_date_sk
  and d2.d_quarter_name in ('2001Q1', '2001Q2', '2001Q3')
  and sr_customer_sk = cs_bill_customer_sk and sr_item_sk = cs_item_sk
  and cs_sold_date_sk = d3.d_date_sk
  and d3.d_quarter_name in ('2001Q1', '2001Q2', '2001Q3')
group by i_item_id, i_item_desc, s_state
order by i_item_id, i_item_desc, s_state
limit 100
""",
    18: """
select i_item_id, ca_country, ca_state, ca_county,
       avg(cast(cs_quantity as decimal(12,2))) agg1,
       avg(cast(cs_list_price as decimal(12,2))) agg2,
       avg(cast(cs_coupon_amt as decimal(12,2))) agg3,
       avg(cast(cs_sales_price as decimal(12,2))) agg4,
       avg(cast(cs_net_profit as decimal(12,2))) agg5,
       avg(cast(c_birth_year as decimal(12,2))) agg6,
       avg(cast(cd1.cd_dep_count as decimal(12,2))) agg7
from catalog_sales, customer_demographics cd1, customer_demographics cd2,
     customer, customer_address, date_dim, item
where cs_sold_date_sk = d_date_sk and cs_item_sk = i_item_sk
  and cs_bill_cdemo_sk = cd1.cd_demo_sk
  and cs_bill_customer_sk = c_customer_sk
  and cd1.cd_gender = 'F' and cd1.cd_education_status = 'Unknown'
  and c_current_cdemo_sk = cd2.cd_demo_sk
  and c_current_addr_sk = ca_address_sk
  and c_birth_month in (1, 6, 8, 9, 12, 2)
  and d_year = 1998
  and ca_state in ('MS', 'IN', 'ND', 'OK', 'NM', 'VA', 'MS')
group by rollup (i_item_id, ca_country, ca_state, ca_county)
order by ca_country, ca_state, ca_county, i_item_id
limit 100
""",
    22: """
select i_product_name, i_brand, i_class, i_category,
       avg(inv_quantity_on_hand) qoh
from inventory, date_dim, item
where inv_date_sk = d_date_sk and inv_item_sk = i_item_sk
  and d_month_seq between 1200 and 1211
group by rollup (i_product_name, i_brand, i_class, i_category)
order by qoh, i_product_name, i_brand, i_class, i_category
limit 100
""",
    25: """
select i_item_id, i_item_desc, s_store_id, s_store_name,
       sum(ss_net_profit) store_sales_profit,
       sum(sr_net_loss) store_returns_loss,
       sum(cs_net_profit) catalog_sales_profit
from store_sales, store_returns, catalog_sales, date_dim d1, date_dim d2,
     date_dim d3, store, item
where d1.d_moy = 4 and d1.d_year = 2001 and d1.d_date_sk = ss_sold_date_sk
  and i_item_sk = ss_item_sk and s_store_sk = ss_store_sk
  and ss_customer_sk = sr_customer_sk and ss_item_sk = sr_item_sk
  and ss_ticket_number = sr_ticket_number
  and sr_returned_date_sk = d2.d_date_sk
  and d2.d_moy between 4 and 10 and d2.d_year = 2001
  and sr_customer_sk = cs_bill_customer_sk and sr_item_sk = cs_item_sk
  and cs_sold_date_sk = d3.d_date_sk
  and d3.d_moy between 4 and 10 and d3.d_year = 2001
group by i_item_id, i_item_desc, s_store_id, s_store_name
order by i_item_id, i_item_desc, s_store_id, s_store_name
limit 100
""",
    29: """
select i_item_id, i_item_desc, s_store_id, s_store_name,
       sum(ss_quantity) store_sales_quantity,
       sum(sr_return_quantity) store_returns_quantity,
       sum(cs_quantity) catalog_sales_quantity
from store_sales, store_returns, catalog_sales, date_dim d1, date_dim d2,
     date_dim d3, store, item
where d1.d_moy = 9 and d1.d_year = 1999 and d1.d_date_sk = ss_sold_date_sk
  and i_item_sk = ss_item_sk and s_store_sk = ss_store_sk
  and ss_customer_sk = sr_customer_sk and ss_item_sk = sr_item_sk
  and ss_ticket_number = sr_ticket_number
  and sr_returned_date_sk = d2.d_date_sk
  and d2.d_moy between 9 and 12 and d2.d_year = 1999
  and sr_customer_sk = cs_bill_customer_sk and sr_item_sk = cs_item_sk
  and cs_sold_date_sk = d3.d_date_sk
  and d3.d_year in (1999, 2000, 2001)
group by i_item_id, i_item_desc, s_store_id, s_store_name
order by i_item_id, i_item_desc, s_store_id, s_store_name
limit 100
""",
    30: """
with customer_total_return as (
  select wr_returning_customer_sk ctr_customer_sk, ca_state ctr_state,
         sum(wr_return_amt) ctr_total_return
  from web_returns, date_dim, customer_address
  where wr_returned_date_sk = d_date_sk and d_year = 2002
    and wr_returning_addr_sk = ca_address_sk
  group by wr_returning_customer_sk, ca_state)
select c_customer_id, c_salutation, c_first_name, c_last_name,
       c_preferred_cust_flag, c_birth_day, c_birth_month, c_birth_year,
       c_birth_country, c_login, c_email_address, c_last_review_date_sk,
       ctr_total_return
from customer_total_return ctr1, customer_address, customer
where ctr1.ctr_total_return >
      (select avg(ctr_total_return) * 1.2 from customer_total_return ctr2
       where ctr1.ctr_state = ctr2.ctr_state)
  and ca_address_sk = c_current_addr_sk and ca_state = 'GA'
  and ctr1.ctr_customer_sk = c_customer_sk
order by c_customer_id, c_salutation, c_first_name, c_last_name,
         c_preferred_cust_flag, c_birth_day, c_birth_month, c_birth_year,
         c_birth_country, c_login, c_email_address, c_last_review_date_sk,
         ctr_total_return
limit 100
""",
    31: """
with ss as (
  select ca_county, d_qoy, d_year, sum(ss_ext_sales_price) store_sales
  from store_sales, date_dim, customer_address
  where ss_sold_date_sk = d_date_sk and ss_addr_sk = ca_address_sk
  group by ca_county, d_qoy, d_year),
 ws as (
  select ca_county, d_qoy, d_year, sum(ws_ext_sales_price) web_sales
  from web_sales, date_dim, customer_address
  where ws_sold_date_sk = d_date_sk and ws_bill_addr_sk = ca_address_sk
  group by ca_county, d_qoy, d_year)
select ss1.ca_county, ss1.d_year,
       ws2.web_sales * 1.0 / ws1.web_sales web_q1_q2_increase,
       ss2.store_sales * 1.0 / ss1.store_sales store_q1_q2_increase,
       ws3.web_sales * 1.0 / ws2.web_sales web_q2_q3_increase,
       ss3.store_sales * 1.0 / ss2.store_sales store_q2_q3_increase
from ss ss1, ss ss2, ss ss3, ws ws1, ws ws2, ws ws3
where ss1.d_qoy = 1 and ss1.d_year = 2000
  and ss1.ca_county = ss2.ca_county and ss2.d_qoy = 2 and ss2.d_year = 2000
  and ss2.ca_county = ss3.ca_county and ss3.d_qoy = 3 and ss3.d_year = 2000
  and ss1.ca_county = ws1.ca_county and ws1.d_qoy = 1 and ws1.d_year = 2000
  and ws1.ca_county = ws2.ca_county and ws2.d_qoy = 2 and ws2.d_year = 2000
  and ws1.ca_county = ws3.ca_county and ws3.d_qoy = 3 and ws3.d_year = 2000
  and (case when ws1.web_sales > 0
            then cast(ws2.web_sales as double) / ws1.web_sales else null end) >
      (case when ss1.store_sales > 0
            then cast(ss2.store_sales as double) / ss1.store_sales else null end)
  and (case when ws2.web_sales > 0
            then cast(ws3.web_sales as double) / ws2.web_sales else null end) >
      (case when ss2.store_sales > 0
            then cast(ss3.store_sales as double) / ss2.store_sales else null end)
order by ss1.ca_county
""",
    35: """
select ca_state, cd_gender, cd_marital_status, cd_dep_count,
       count(*) cnt1, min(cd_dep_count) mn1, max(cd_dep_count) mx1,
       avg(cd_dep_count) av1,
       cd_dep_employed_count, count(*) cnt2,
       min(cd_dep_employed_count) mn2, max(cd_dep_employed_count) mx2,
       avg(cd_dep_employed_count) av2,
       cd_dep_college_count, count(*) cnt3,
       min(cd_dep_college_count) mn3, max(cd_dep_college_count) mx3,
       avg(cd_dep_college_count) av3
from customer c, customer_address ca, customer_demographics
where c.c_current_addr_sk = ca.ca_address_sk
  and cd_demo_sk = c.c_current_cdemo_sk
  and exists (select * from store_sales, date_dim
              where c.c_customer_sk = ss_customer_sk
                and ss_sold_date_sk = d_date_sk
                and d_year = 2002 and d_qoy < 4)
  and (exists (select * from web_sales, date_dim
               where c.c_customer_sk = ws_bill_customer_sk
                 and ws_sold_date_sk = d_date_sk
                 and d_year = 2002 and d_qoy < 4)
       or exists (select * from catalog_sales, date_dim
                  where c.c_customer_sk = cs_ship_customer_sk
                    and cs_sold_date_sk = d_date_sk
                    and d_year = 2002 and d_qoy < 4))
group by ca_state, cd_gender, cd_marital_status, cd_dep_count,
         cd_dep_employed_count, cd_dep_college_count
order by ca_state, cd_gender, cd_marital_status, cd_dep_count,
         cd_dep_employed_count, cd_dep_college_count
limit 100
""",
    39: """
with inv as (
  select w_warehouse_name, w_warehouse_sk, i_item_sk, d_moy, stdev, mean,
         case mean when 0 then null else stdev / mean end cov
  from (select w_warehouse_name, w_warehouse_sk, i_item_sk, d_moy,
               stddev_samp(inv_quantity_on_hand) stdev,
               avg(inv_quantity_on_hand) mean
        from inventory, item, warehouse, date_dim
        where inv_item_sk = i_item_sk and inv_warehouse_sk = w_warehouse_sk
          and inv_date_sk = d_date_sk and d_year = 2001
        group by w_warehouse_name, w_warehouse_sk, i_item_sk, d_moy) foo
  where (case mean when 0 then 0 else stdev / mean end) > 1)
select inv1.w_warehouse_sk wsk1, inv1.i_item_sk isk1, inv1.d_moy moy1,
       inv1.mean mean1, inv1.cov cov1,
       inv2.w_warehouse_sk wsk2, inv2.i_item_sk isk2, inv2.d_moy moy2,
       inv2.mean mean2, inv2.cov cov2
from inv inv1, inv inv2
where inv1.i_item_sk = inv2.i_item_sk
  and inv1.w_warehouse_sk = inv2.w_warehouse_sk
  and inv1.d_moy = 1 and inv2.d_moy = 2 and inv1.cov > 1.5
order by inv1.w_warehouse_sk, inv1.i_item_sk, inv1.d_moy, inv1.mean,
         inv1.cov, inv2.d_moy, inv2.mean, inv2.cov
""",
    74: """
with year_total as (
  select c_customer_id customer_id, c_first_name customer_first_name,
         c_last_name customer_last_name, d_year dyear,
         sum(ss_net_paid) year_total, 's' sale_type
  from customer, store_sales, date_dim
  where c_customer_sk = ss_customer_sk and ss_sold_date_sk = d_date_sk
    and d_year in (2001, 2002)
  group by c_customer_id, c_first_name, c_last_name, d_year
  union all
  select c_customer_id customer_id, c_first_name customer_first_name,
         c_last_name customer_last_name, d_year dyear,
         sum(ws_net_paid) year_total, 'w' sale_type
  from customer, web_sales, date_dim
  where c_customer_sk = ws_bill_customer_sk and ws_sold_date_sk = d_date_sk
    and d_year in (2001, 2002)
  group by c_customer_id, c_first_name, c_last_name, d_year)
select t_s_secyear.customer_id, t_s_secyear.customer_first_name,
       t_s_secyear.customer_last_name
from year_total t_s_firstyear, year_total t_s_secyear,
     year_total t_w_firstyear, year_total t_w_secyear
where t_s_secyear.customer_id = t_s_firstyear.customer_id
  and t_s_firstyear.customer_id = t_w_secyear.customer_id
  and t_s_firstyear.customer_id = t_w_firstyear.customer_id
  and t_s_firstyear.sale_type = 's' and t_w_firstyear.sale_type = 'w'
  and t_s_secyear.sale_type = 's' and t_w_secyear.sale_type = 'w'
  and t_s_firstyear.dyear = 2001 and t_s_secyear.dyear = 2002
  and t_w_firstyear.dyear = 2001 and t_w_secyear.dyear = 2002
  and t_s_firstyear.year_total > 0 and t_w_firstyear.year_total > 0
  and (case when t_w_firstyear.year_total > 0
            then cast(t_w_secyear.year_total as double) / t_w_firstyear.year_total
            else null end) >
      (case when t_s_firstyear.year_total > 0
            then cast(t_s_secyear.year_total as double) / t_s_firstyear.year_total
            else null end)
order by t_s_secyear.customer_id, t_s_secyear.customer_first_name,
         t_s_secyear.customer_last_name
limit 100
""",
    76: """
select channel, col_name, d_year, d_qoy, i_category,
       count(*) sales_cnt, sum(ext_sales_price) sales_amt
from (select 'store' channel, 'ss_store_sk' col_name, d_year, d_qoy,
             i_category, ss_ext_sales_price ext_sales_price
      from store_sales, item, date_dim
      where ss_store_sk is null and ss_sold_date_sk = d_date_sk
        and ss_item_sk = i_item_sk
      union all
      select 'web' channel, 'ws_ship_customer_sk' col_name, d_year, d_qoy,
             i_category, ws_ext_sales_price ext_sales_price
      from web_sales, item, date_dim
      where ws_ship_customer_sk is null and ws_sold_date_sk = d_date_sk
        and ws_item_sk = i_item_sk
      union all
      select 'catalog' channel, 'cs_ship_addr_sk' col_name, d_year, d_qoy,
             i_category, cs_ext_sales_price ext_sales_price
      from catalog_sales, item, date_dim
      where cs_ship_addr_sk is null and cs_sold_date_sk = d_date_sk
        and cs_item_sk = i_item_sk) foo
group by channel, col_name, d_year, d_qoy, i_category
order by channel, col_name, d_year, d_qoy, i_category
limit 100
""",
    81: """
with customer_total_return as (
  select cr_returning_customer_sk ctr_customer_sk, ca_state ctr_state,
         sum(cr_return_amt_inc_tax) ctr_total_return
  from catalog_returns, date_dim, customer_address
  where cr_returned_date_sk = d_date_sk and d_year = 2000
    and cr_returning_addr_sk = ca_address_sk
  group by cr_returning_customer_sk, ca_state)
select c_customer_id, c_salutation, c_first_name, c_last_name,
       ca_street_number, ca_street_name, ca_street_type, ca_suite_number,
       ca_city, ca_county, ca_state, ca_zip, ca_country, ca_gmt_offset,
       ca_location_type, ctr_total_return
from customer_total_return ctr1, customer_address, customer
where ctr1.ctr_total_return >
      (select avg(ctr_total_return) * 1.2 from customer_total_return ctr2
       where ctr1.ctr_state = ctr2.ctr_state)
  and ca_address_sk = c_current_addr_sk and ca_state = 'GA'
  and ctr1.ctr_customer_sk = c_customer_sk
order by c_customer_id, c_salutation, c_first_name, c_last_name,
         ca_street_number, ca_street_name, ca_street_type, ca_suite_number,
         ca_city, ca_county, ca_state, ca_zip, ca_country, ca_gmt_offset,
         ca_location_type, ctr_total_return
limit 100
""",
    83: """
with sr_items as (
  select i_item_id item_id, sum(sr_return_quantity) sr_item_qty
  from store_returns, item, date_dim
  where sr_item_sk = i_item_sk
    and d_date in (select d_date from date_dim
                   where d_week_seq in (select d_week_seq from date_dim
                                        where d_date in (date '2000-06-30',
                                                         date '2000-09-27',
                                                         date '2000-11-17')))
    and sr_returned_date_sk = d_date_sk
  group by i_item_id),
 cr_items as (
  select i_item_id item_id, sum(cr_return_quantity) cr_item_qty
  from catalog_returns, item, date_dim
  where cr_item_sk = i_item_sk
    and d_date in (select d_date from date_dim
                   where d_week_seq in (select d_week_seq from date_dim
                                        where d_date in (date '2000-06-30',
                                                         date '2000-09-27',
                                                         date '2000-11-17')))
    and cr_returned_date_sk = d_date_sk
  group by i_item_id),
 wr_items as (
  select i_item_id item_id, sum(wr_return_quantity) wr_item_qty
  from web_returns, item, date_dim
  where wr_item_sk = i_item_sk
    and d_date in (select d_date from date_dim
                   where d_week_seq in (select d_week_seq from date_dim
                                        where d_date in (date '2000-06-30',
                                                         date '2000-09-27',
                                                         date '2000-11-17')))
    and wr_returned_date_sk = d_date_sk
  group by i_item_id)
select sr_items.item_id, sr_item_qty,
       sr_item_qty * 100.0 / (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0
         sr_dev,
       cr_item_qty,
       cr_item_qty * 100.0 / (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0
         cr_dev,
       wr_item_qty,
       wr_item_qty * 100.0 / (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0
         wr_dev,
       (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0 average
from sr_items, cr_items, wr_items
where sr_items.item_id = cr_items.item_id
  and sr_items.item_id = wr_items.item_id
order by sr_items.item_id, sr_item_qty
limit 100
""",
    85: """
select substr(r_reason_desc, 1, 20) reason, avg(ws_quantity) q,
       avg(wr_refunded_cash) rc, avg(wr_fee) fee
from web_sales, web_returns, web_page, customer_demographics cd1,
     customer_demographics cd2, customer_address, date_dim, reason
where ws_web_page_sk = wp_web_page_sk and ws_item_sk = wr_item_sk
  and ws_order_number = wr_order_number and ws_sold_date_sk = d_date_sk
  and d_year = 2000 and cd1.cd_demo_sk = wr_refunded_cdemo_sk
  and cd2.cd_demo_sk = wr_returning_cdemo_sk
  and ca_address_sk = wr_refunded_addr_sk and r_reason_sk = wr_reason_sk
  and ((cd1.cd_marital_status = 'M'
        and cd1.cd_marital_status = cd2.cd_marital_status
        and cd1.cd_education_status = 'Advanced Degree'
        and cd1.cd_education_status = cd2.cd_education_status
        and ws_sales_price between 100.00 and 150.00)
       or (cd1.cd_marital_status = 'S'
           and cd1.cd_marital_status = cd2.cd_marital_status
           and cd1.cd_education_status = 'College'
           and cd1.cd_education_status = cd2.cd_education_status
           and ws_sales_price between 50.00 and 100.00)
       or (cd1.cd_marital_status = 'W'
           and cd1.cd_marital_status = cd2.cd_marital_status
           and cd1.cd_education_status = '2 yr Degree'
           and cd1.cd_education_status = cd2.cd_education_status
           and ws_sales_price between 150.00 and 200.00))
  and ((ca_country = 'United States'
        and ca_state in ('IN', 'OH', 'NJ')
        and ws_net_profit between 100 and 200)
       or (ca_country = 'United States'
           and ca_state in ('WI', 'CT', 'KY')
           and ws_net_profit between 150 and 300)
       or (ca_country = 'United States'
           and ca_state in ('LA', 'IA', 'AR')
           and ws_net_profit between 50 and 250))
group by r_reason_desc
order by reason, q, rc, fee
limit 100
""",
    86: """
select sum(ws_net_paid) total_sum, i_category, i_class,
       grouping(i_category) + grouping(i_class) lochierarchy,
       rank() over (partition by grouping(i_category) + grouping(i_class),
                    case when grouping(i_class) = 0 then i_category end
                    order by sum(ws_net_paid) desc) rank_within_parent
from web_sales, date_dim d1, item
where d1.d_month_seq between 1200 and 1211
  and d1.d_date_sk = ws_sold_date_sk and i_item_sk = ws_item_sk
group by rollup (i_category, i_class)
order by lochierarchy desc,
         case when lochierarchy = 0 then i_category end,
         rank_within_parent
limit 100
""",
    97: """
with ssci as (
  select ss_customer_sk customer_sk, ss_item_sk item_sk
  from store_sales, date_dim
  where ss_sold_date_sk = d_date_sk and d_month_seq between 1200 and 1211
  group by ss_customer_sk, ss_item_sk),
 csci as (
  select cs_bill_customer_sk customer_sk, cs_item_sk item_sk
  from catalog_sales, date_dim
  where cs_sold_date_sk = d_date_sk and d_month_seq between 1200 and 1211
  group by cs_bill_customer_sk, cs_item_sk)
select sum(case when ssci.customer_sk is not null
                 and csci.customer_sk is null then 1 else 0 end) store_only,
       sum(case when ssci.customer_sk is null
                 and csci.customer_sk is not null then 1 else 0 end)
         catalog_only,
       sum(case when ssci.customer_sk is not null
                 and csci.customer_sk is not null then 1 else 0 end)
         store_and_catalog
from ssci full join csci on ssci.customer_sk = csci.customer_sk
  and ssci.item_sk = csci.item_sk
limit 100
""",
    4: """
with year_total as (
  select c_customer_id customer_id, c_first_name customer_first_name,
         c_last_name customer_last_name,
         c_preferred_cust_flag customer_preferred_cust_flag,
         c_birth_country customer_birth_country, c_login customer_login,
         c_email_address customer_email_address, d_year dyear,
         sum((ss_ext_list_price - ss_ext_wholesale_cost
              - ss_ext_discount_amt + ss_ext_sales_price) / 2) year_total,
         's' sale_type
  from customer, store_sales, date_dim
  where c_customer_sk = ss_customer_sk and ss_sold_date_sk = d_date_sk
  group by c_customer_id, c_first_name, c_last_name, c_preferred_cust_flag,
           c_birth_country, c_login, c_email_address, d_year
  union all
  select c_customer_id customer_id, c_first_name customer_first_name,
         c_last_name customer_last_name,
         c_preferred_cust_flag customer_preferred_cust_flag,
         c_birth_country customer_birth_country, c_login customer_login,
         c_email_address customer_email_address, d_year dyear,
         sum((cs_ext_list_price - cs_ext_wholesale_cost
              - cs_ext_discount_amt + cs_ext_sales_price) / 2) year_total,
         'c' sale_type
  from customer, catalog_sales, date_dim
  where c_customer_sk = cs_bill_customer_sk and cs_sold_date_sk = d_date_sk
  group by c_customer_id, c_first_name, c_last_name, c_preferred_cust_flag,
           c_birth_country, c_login, c_email_address, d_year
  union all
  select c_customer_id customer_id, c_first_name customer_first_name,
         c_last_name customer_last_name,
         c_preferred_cust_flag customer_preferred_cust_flag,
         c_birth_country customer_birth_country, c_login customer_login,
         c_email_address customer_email_address, d_year dyear,
         sum((ws_ext_list_price - ws_ext_wholesale_cost
              - ws_ext_discount_amt + ws_ext_sales_price) / 2) year_total,
         'w' sale_type
  from customer, web_sales, date_dim
  where c_customer_sk = ws_bill_customer_sk and ws_sold_date_sk = d_date_sk
  group by c_customer_id, c_first_name, c_last_name, c_preferred_cust_flag,
           c_birth_country, c_login, c_email_address, d_year)
select t_s_secyear.customer_id, t_s_secyear.customer_first_name,
       t_s_secyear.customer_last_name,
       t_s_secyear.customer_preferred_cust_flag
from year_total t_s_firstyear, year_total t_s_secyear,
     year_total t_c_firstyear, year_total t_c_secyear,
     year_total t_w_firstyear, year_total t_w_secyear
where t_s_secyear.customer_id = t_s_firstyear.customer_id
  and t_s_firstyear.customer_id = t_c_secyear.customer_id
  and t_s_firstyear.customer_id = t_c_firstyear.customer_id
  and t_s_firstyear.customer_id = t_w_firstyear.customer_id
  and t_s_firstyear.customer_id = t_w_secyear.customer_id
  and t_s_firstyear.sale_type = 's' and t_c_firstyear.sale_type = 'c'
  and t_w_firstyear.sale_type = 'w' and t_s_secyear.sale_type = 's'
  and t_c_secyear.sale_type = 'c' and t_w_secyear.sale_type = 'w'
  and t_s_firstyear.dyear = 2001 and t_s_secyear.dyear = 2002
  and t_c_firstyear.dyear = 2001 and t_c_secyear.dyear = 2002
  and t_w_firstyear.dyear = 2001 and t_w_secyear.dyear = 2002
  and t_s_firstyear.year_total > 0 and t_c_firstyear.year_total > 0
  and t_w_firstyear.year_total > 0
  and (case when t_c_firstyear.year_total > 0
            then cast(t_c_secyear.year_total as double) / t_c_firstyear.year_total
            else null end) >
      (case when t_s_firstyear.year_total > 0
            then cast(t_s_secyear.year_total as double) / t_s_firstyear.year_total
            else null end)
  and (case when t_c_firstyear.year_total > 0
            then cast(t_c_secyear.year_total as double) / t_c_firstyear.year_total
            else null end) >
      (case when t_w_firstyear.year_total > 0
            then cast(t_w_secyear.year_total as double) / t_w_firstyear.year_total
            else null end)
order by t_s_secyear.customer_id, t_s_secyear.customer_first_name,
         t_s_secyear.customer_last_name,
         t_s_secyear.customer_preferred_cust_flag
limit 100
""",
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
select channel, id, sum(sales) sales, sum(returns) returns,
       sum(profit) profit
from (select 'store channel' channel, concat('store', s_store_id) id,
             sales, returns, profit - profit_loss profit
      from ssr
      union all
      select 'catalog channel' channel,
             concat('catalog_page', cp_catalog_page_id) id,
             sales, returns, profit - profit_loss profit
      from csr
      union all
      select 'web channel' channel,
             concat('web_site', web_site_id) id,
             sales, returns, profit - profit_loss profit
      from wsr) x
group by rollup (channel, id)
order by channel, id
limit 100
""",
    56: """
with ss as (
  select i_item_id, sum(ss_ext_sales_price) total_sales
  from store_sales, date_dim, customer_address, item
  where i_item_id in (select i_item_id from item
                      where i_color in ('slate', 'blanched', 'burnished'))
    and ss_item_sk = i_item_sk and ss_sold_date_sk = d_date_sk
    and d_year = 2001 and d_moy = 2
    and ss_addr_sk = ca_address_sk and ca_gmt_offset = -5
  group by i_item_id),
 cs as (
  select i_item_id, sum(cs_ext_sales_price) total_sales
  from catalog_sales, date_dim, customer_address, item
  where i_item_id in (select i_item_id from item
                      where i_color in ('slate', 'blanched', 'burnished'))
    and cs_item_sk = i_item_sk and cs_sold_date_sk = d_date_sk
    and d_year = 2001 and d_moy = 2
    and cs_bill_addr_sk = ca_address_sk and ca_gmt_offset = -5
  group by i_item_id),
 ws as (
  select i_item_id, sum(ws_ext_sales_price) total_sales
  from web_sales, date_dim, customer_address, item
  where i_item_id in (select i_item_id from item
                      where i_color in ('slate', 'blanched', 'burnished'))
    and ws_item_sk = i_item_sk and ws_sold_date_sk = d_date_sk
    and d_year = 2001 and d_moy = 2
    and ws_bill_addr_sk = ca_address_sk and ca_gmt_offset = -5
  group by i_item_id)
select i_item_id, sum(total_sales) total_sales
from (select i_item_id, total_sales from ss
      union all select i_item_id, total_sales from cs
      union all select i_item_id, total_sales from ws) tmp1
group by i_item_id
order by total_sales, i_item_id
limit 100
""",
    66: """
select w_warehouse_name, w_warehouse_sq_ft, w_city, w_county, w_state,
       w_country, ship_carriers, dyear,
       sum(jan_sales) jan_sales, sum(feb_sales) feb_sales,
       sum(mar_sales) mar_sales, sum(apr_sales) apr_sales,
       sum(may_sales) may_sales, sum(jun_sales) jun_sales,
       sum(jul_sales) jul_sales, sum(aug_sales) aug_sales,
       sum(sep_sales) sep_sales, sum(oct_sales) oct_sales,
       sum(nov_sales) nov_sales, sum(dec_sales) dec_sales,
       sum(jan_sales * 1.0 / w_warehouse_sq_ft) jan_sales_per_sq_foot,
       sum(feb_sales * 1.0 / w_warehouse_sq_ft) feb_sales_per_sq_foot,
       sum(mar_sales * 1.0 / w_warehouse_sq_ft) mar_sales_per_sq_foot,
       sum(jan_net) jan_net, sum(feb_net) feb_net, sum(mar_net) mar_net,
       sum(apr_net) apr_net, sum(may_net) may_net, sum(jun_net) jun_net,
       sum(jul_net) jul_net, sum(aug_net) aug_net, sum(sep_net) sep_net,
       sum(oct_net) oct_net, sum(nov_net) nov_net, sum(dec_net) dec_net
from (
  select w_warehouse_name, w_warehouse_sq_ft, w_city, w_county, w_state,
         w_country, 'DHL,BARIAN' ship_carriers, d_year dyear,
         sum(case when d_moy = 1 then ws_ext_sales_price * ws_quantity
                  else 0 end) jan_sales,
         sum(case when d_moy = 2 then ws_ext_sales_price * ws_quantity
                  else 0 end) feb_sales,
         sum(case when d_moy = 3 then ws_ext_sales_price * ws_quantity
                  else 0 end) mar_sales,
         sum(case when d_moy = 4 then ws_ext_sales_price * ws_quantity
                  else 0 end) apr_sales,
         sum(case when d_moy = 5 then ws_ext_sales_price * ws_quantity
                  else 0 end) may_sales,
         sum(case when d_moy = 6 then ws_ext_sales_price * ws_quantity
                  else 0 end) jun_sales,
         sum(case when d_moy = 7 then ws_ext_sales_price * ws_quantity
                  else 0 end) jul_sales,
         sum(case when d_moy = 8 then ws_ext_sales_price * ws_quantity
                  else 0 end) aug_sales,
         sum(case when d_moy = 9 then ws_ext_sales_price * ws_quantity
                  else 0 end) sep_sales,
         sum(case when d_moy = 10 then ws_ext_sales_price * ws_quantity
                  else 0 end) oct_sales,
         sum(case when d_moy = 11 then ws_ext_sales_price * ws_quantity
                  else 0 end) nov_sales,
         sum(case when d_moy = 12 then ws_ext_sales_price * ws_quantity
                  else 0 end) dec_sales,
         sum(case when d_moy = 1 then ws_net_paid * ws_quantity
                  else 0 end) jan_net,
         sum(case when d_moy = 2 then ws_net_paid * ws_quantity
                  else 0 end) feb_net,
         sum(case when d_moy = 3 then ws_net_paid * ws_quantity
                  else 0 end) mar_net,
         sum(case when d_moy = 4 then ws_net_paid * ws_quantity
                  else 0 end) apr_net,
         sum(case when d_moy = 5 then ws_net_paid * ws_quantity
                  else 0 end) may_net,
         sum(case when d_moy = 6 then ws_net_paid * ws_quantity
                  else 0 end) jun_net,
         sum(case when d_moy = 7 then ws_net_paid * ws_quantity
                  else 0 end) jul_net,
         sum(case when d_moy = 8 then ws_net_paid * ws_quantity
                  else 0 end) aug_net,
         sum(case when d_moy = 9 then ws_net_paid * ws_quantity
                  else 0 end) sep_net,
         sum(case when d_moy = 10 then ws_net_paid * ws_quantity
                  else 0 end) oct_net,
         sum(case when d_moy = 11 then ws_net_paid * ws_quantity
                  else 0 end) nov_net,
         sum(case when d_moy = 12 then ws_net_paid * ws_quantity
                  else 0 end) dec_net
  from web_sales, warehouse, date_dim, time_dim, ship_mode
  where ws_warehouse_sk = w_warehouse_sk and ws_sold_date_sk = d_date_sk
    and ws_sold_time_sk = t_time_sk and ws_ship_mode_sk = sm_ship_mode_sk
    and d_year = 2001 and t_time between 30838 and 59638
    and sm_carrier in ('DHL', 'BARIAN')
  group by w_warehouse_name, w_warehouse_sq_ft, w_city, w_county, w_state,
           w_country, d_year
  union all
  select w_warehouse_name, w_warehouse_sq_ft, w_city, w_county, w_state,
         w_country, 'DHL,BARIAN' ship_carriers, d_year dyear,
         sum(case when d_moy = 1 then cs_sales_price * cs_quantity
                  else 0 end) jan_sales,
         sum(case when d_moy = 2 then cs_sales_price * cs_quantity
                  else 0 end) feb_sales,
         sum(case when d_moy = 3 then cs_sales_price * cs_quantity
                  else 0 end) mar_sales,
         sum(case when d_moy = 4 then cs_sales_price * cs_quantity
                  else 0 end) apr_sales,
         sum(case when d_moy = 5 then cs_sales_price * cs_quantity
                  else 0 end) may_sales,
         sum(case when d_moy = 6 then cs_sales_price * cs_quantity
                  else 0 end) jun_sales,
         sum(case when d_moy = 7 then cs_sales_price * cs_quantity
                  else 0 end) jul_sales,
         sum(case when d_moy = 8 then cs_sales_price * cs_quantity
                  else 0 end) aug_sales,
         sum(case when d_moy = 9 then cs_sales_price * cs_quantity
                  else 0 end) sep_sales,
         sum(case when d_moy = 10 then cs_sales_price * cs_quantity
                  else 0 end) oct_sales,
         sum(case when d_moy = 11 then cs_sales_price * cs_quantity
                  else 0 end) nov_sales,
         sum(case when d_moy = 12 then cs_sales_price * cs_quantity
                  else 0 end) dec_sales,
         sum(case when d_moy = 1 then cs_net_paid_inc_tax * cs_quantity
                  else 0 end) jan_net,
         sum(case when d_moy = 2 then cs_net_paid_inc_tax * cs_quantity
                  else 0 end) feb_net,
         sum(case when d_moy = 3 then cs_net_paid_inc_tax * cs_quantity
                  else 0 end) mar_net,
         sum(case when d_moy = 4 then cs_net_paid_inc_tax * cs_quantity
                  else 0 end) apr_net,
         sum(case when d_moy = 5 then cs_net_paid_inc_tax * cs_quantity
                  else 0 end) may_net,
         sum(case when d_moy = 6 then cs_net_paid_inc_tax * cs_quantity
                  else 0 end) jun_net,
         sum(case when d_moy = 7 then cs_net_paid_inc_tax * cs_quantity
                  else 0 end) jul_net,
         sum(case when d_moy = 8 then cs_net_paid_inc_tax * cs_quantity
                  else 0 end) aug_net,
         sum(case when d_moy = 9 then cs_net_paid_inc_tax * cs_quantity
                  else 0 end) sep_net,
         sum(case when d_moy = 10 then cs_net_paid_inc_tax * cs_quantity
                  else 0 end) oct_net,
         sum(case when d_moy = 11 then cs_net_paid_inc_tax * cs_quantity
                  else 0 end) nov_net,
         sum(case when d_moy = 12 then cs_net_paid_inc_tax * cs_quantity
                  else 0 end) dec_net
  from catalog_sales, warehouse, date_dim, time_dim, ship_mode
  where cs_warehouse_sk = w_warehouse_sk and cs_sold_date_sk = d_date_sk
    and cs_sold_time_sk = t_time_sk and cs_ship_mode_sk = sm_ship_mode_sk
    and d_year = 2001 and t_time between 30838 and 59638
    and sm_carrier in ('DHL', 'BARIAN')
  group by w_warehouse_name, w_warehouse_sq_ft, w_city, w_county, w_state,
           w_country, d_year) x
group by w_warehouse_name, w_warehouse_sq_ft, w_city, w_county, w_state,
         w_country, ship_carriers, dyear
order by w_warehouse_name
limit 100
""",
    67: """
select * from (
  select i_category, i_class, i_brand, i_product_name, d_year, d_qoy,
         d_moy, s_store_id, sumsales,
         rank() over (partition by i_category
                      order by sumsales desc) rk
  from (select i_category, i_class, i_brand, i_product_name, d_year,
               d_qoy, d_moy, s_store_id,
               sum(coalesce(ss_sales_price * ss_quantity, 0)) sumsales
        from store_sales, date_dim, store, item
        where ss_sold_date_sk = d_date_sk and ss_item_sk = i_item_sk
          and ss_store_sk = s_store_sk
          and d_month_seq between 1200 and 1211
        group by rollup (i_category, i_class, i_brand, i_product_name,
                         d_year, d_qoy, d_moy, s_store_id)) dw1) dw2
where rk <= 100
order by i_category, i_class, i_brand, i_product_name, d_year, d_qoy,
         d_moy, s_store_id, sumsales, rk
limit 100
""",
    70: """
select sum(ss_net_profit) total_sum, s_state, s_county,
       grouping(s_state) + grouping(s_county) lochierarchy,
       rank() over (partition by grouping(s_state) + grouping(s_county),
                    case when grouping(s_county) = 0 then s_state end
                    order by sum(ss_net_profit) desc) rank_within_parent
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
                  where ranking <= 5)
group by rollup (s_state, s_county)
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
select channel, id, sum(sales) sales, sum(returns) returns,
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
group by rollup (channel, id)
order by channel, id, sales
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
select channel, id, sum(sales) sales, sum(returns) returns,
       sum(profit) profit
from (select 'store channel' channel, concat('store', store_id) id,
             sales, returns, profit
      from ssr
      union all
      select 'catalog channel' channel,
             concat('catalog_page', catalog_page_id) id,
             sales, returns, profit
      from csr
      union all
      select 'web channel' channel, concat('web_site', web_site_id) id,
             sales, returns, profit
      from wsr) x
group by rollup (channel, id)
order by channel, id
limit 100
""",
    8: """
select s_store_name, sum(ss_net_profit) profit
from store_sales, date_dim, store,
     (select ca_zip
      from (select substr(ca_zip, 1, 5) ca_zip
            from customer_address
            where substr(ca_zip, 1, 5) in (
      '24128', '57834', '13354', '15734', '78668', '76232', '62878',
      '45375', '63435', '22245', '65084', '49130', '40558', '25733',
      '15798', '87816', '81096', '56458', '35474', '27156', '83926',
      '18840', '28286', '24676', '37930', '77556', '27700', '45266',
      '94627', '62971', '20548', '23470', '47305', '53535', '21337',
      '26231', '50412', '69399', '17879', '51622', '43848', '21195',
      '83921', '15559', '67853', '15126', '16021', '26233', '53268',
      '10567', '91137', '76107', '11101', '59166', '38415', '61265',
      '71954', '15371', '11928', '15455', '98294', '68309', '69913',
      '59402', '58263', '25782', '18119', '35942', '33282', '42029',
      '17920', '98359', '15882', '45721', '60279', '18426', '64544',
      '25631', '43933', '37125', '98235', '10336', '24610', '68101',
      '56240', '40081', '86379', '44165', '33515', '88190', '84093',
      '27068', '99076', '36634', '50308', '28577', '39736', '33786',
      '71286', '26859', '55565', '98569', '70738', '19736', '64457',
      '17183', '28915', '26653', '58058', '89091', '54601', '24206',
      '14328', '55253', '82136', '67897', '56529', '72305', '67473',
      '62377', '22752', '57647', '62496', '41918', '36233', '86284',
      '54917', '22152', '19515', '63837', '18376', '42961', '10144',
      '36495', '58078', '38607', '91110', '64147', '19430', '17043',
      '45200', '63981', '48425', '22351', '30010', '21756', '14922',
      '14663', '77191', '60099', '29741', '36420', '21076', '91393',
      '28810', '96765', '23006', '18799', '49156', '98025', '23932',
      '67467', '30450', '50298', '29178', '89360', '32754', '63089',
      '87501', '87343', '29839', '30903', '81019', '18652', '73273',
      '25989', '20260', '68893', '53179', '30469', '28898', '31671',
      '24996', '18767', '64034', '91068', '51798', '51200', '63193',
      '39516', '72550', '72325', '51211', '23968', '86057', '10390',
      '85816', '45692', '65164', '21309', '18845', '68621', '92712',
      '68880', '90257', '47770', '13955', '70466', '21286', '67875',
      '82636', '36446', '79994', '72823', '40162', '41367', '41766',
      '22437', '58470', '11356', '76638', '68806', '25280', '67301',
      '73650', '86198', '16725', '38935', '13394', '61810', '81312',
      '15146', '71791', '31016', '72013', '37126', '22744', '73134',
      '70372', '30431', '39192', '35850', '56571', '67030', '22461',
      '88424', '88086', '14060', '40604', '19512', '72175', '51649',
      '19505', '24317', '13375', '81426', '18270', '72425', '45748',
      '55307', '53672', '52867', '56575', '39127', '30625', '10445',
      '39972', '74351', '26065', '83849', '42666', '96976', '68786',
      '77721', '68908', '66864', '63792', '51650', '31029', '26689',
      '66708', '11376', '20004', '31880', '96451', '41248', '94898',
      '18383', '60576', '38193', '48583', '13595', '76614', '24671',
      '46820', '82276', '10516', '11634', '45549', '88885', '18842',
      '90225', '18906', '13376', '84935', '78890', '58943', '15765',
      '50016', '69035', '49448', '39371', '41368', '33123', '83144',
      '14089', '94945', '73241', '19769', '47537', '38122', '28587',
      '76698', '22927', '56616', '34425', '96576', '78567', '97789',
      '94983', '79077', '57855', '97189', '46081', '48033', '19849',
      '28488', '28545', '72151', '69952', '43285', '26105', '76231',
      '15723', '25486', '39861', '83933', '75691', '46136', '61547',
      '66162', '25858', '22246', '51949', '27385', '77610', '34322',
      '51061', '68100', '61860', '13695', '44438', '90578', '96888',
      '58048', '99543', '73171', '56691', '64528', '56910', '83444',
      '30122', '68014', '14171', '16807', '83041', '34102', '51103',
      '79777', '17871', '12305', '22685', '94167', '28709', '35258',
      '57665', '71256', '57047', '11489', '31387', '68341', '78451',
      '14867', '25103', '35458', '25003', '54364', '73520', '32213',
      '35576')
            intersect
            select ca_zip
            from (select substr(ca_zip, 1, 5) ca_zip, count(*) cnt
                  from customer_address, customer
                  where ca_address_sk = c_current_addr_sk
                    and c_preferred_cust_flag = 'Y'
                  group by ca_zip
                  having count(*) > 10) a1) a2) v1
where ss_store_sk = s_store_sk and ss_sold_date_sk = d_date_sk
  and d_qoy = 2 and d_year = 1998
  and substr(s_zip, 1, 2) = substr(v1.ca_zip, 1, 2)
group by s_store_name
order by s_store_name
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
select channel, i_brand_id, i_class_id, i_category_id,
       sum(sales) sum_sales, sum(number_sales) sum_number_sales
from (select 'store' channel, i_brand_id, i_class_id, i_category_id,
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
             (select average_sales from avg_sales)) y
group by rollup (channel, i_brand_id, i_class_id, i_category_id)
order by channel, i_brand_id, i_class_id, i_category_id
limit 100
""",
    23: """
with frequent_ss_items as (
  select substr(i_item_desc, 1, 30) itemdesc, i_item_sk item_sk,
         d_date solddate, count(*) cnt
  from store_sales, date_dim, item
  where ss_sold_date_sk = d_date_sk and ss_item_sk = i_item_sk
    and d_year in (2000, 2001, 2002, 2003)
  group by substr(i_item_desc, 1, 30), i_item_sk, d_date
  having count(*) > 4),
 max_store_sales as (
  select max(csales) tpcds_cmax
  from (select c_customer_sk, sum(ss_quantity * ss_sales_price) csales
        from store_sales, customer, date_dim
        where ss_customer_sk = c_customer_sk
          and ss_sold_date_sk = d_date_sk
          and d_year in (2000, 2001, 2002, 2003)
        group by c_customer_sk) x),
 best_ss_customer as (
  select c_customer_sk, sum(ss_quantity * ss_sales_price) ssales
  from store_sales, customer
  where ss_customer_sk = c_customer_sk
  group by c_customer_sk
  having sum(ss_quantity * ss_sales_price) >
         0.5 * (select tpcds_cmax from max_store_sales))
select sum(sales) total
from (select cs_quantity * cs_list_price sales
      from catalog_sales, date_dim
      where d_year = 2000 and d_moy = 2 and cs_sold_date_sk = d_date_sk
        and cs_item_sk in (select item_sk from frequent_ss_items)
        and cs_bill_customer_sk in (select c_customer_sk
                                    from best_ss_customer)
      union all
      select ws_quantity * ws_list_price sales
      from web_sales, date_dim
      where d_year = 2000 and d_moy = 2 and ws_sold_date_sk = d_date_sk
        and ws_item_sk in (select item_sk from frequent_ss_items)
        and ws_bill_customer_sk in (select c_customer_sk
                                    from best_ss_customer)) y
limit 100
""",
    24: """
with ssales as (
  select c_last_name, c_first_name, s_store_name, ca_state, s_state,
         i_color, i_current_price, i_manager_id, i_units, i_size,
         sum(ss_net_paid) netpaid
  from store_sales, store_returns, store, item, customer,
       customer_address
  where ss_ticket_number = sr_ticket_number and ss_item_sk = sr_item_sk
    and ss_customer_sk = c_customer_sk and ss_item_sk = i_item_sk
    and ss_store_sk = s_store_sk
    and c_birth_country = upper(ca_country) and s_zip = ca_zip
    and s_market_id = 8
  group by c_last_name, c_first_name, s_store_name, ca_state, s_state,
           i_color, i_current_price, i_manager_id, i_units, i_size)
select c_last_name, c_first_name, s_store_name, sum(netpaid) paid
from ssales
where i_color = 'pale'
group by c_last_name, c_first_name, s_store_name
having sum(netpaid) > (select 0.05 * avg(netpaid) from ssales)
""",
    49: """
select 'web' channel, web.item, web.return_ratio, web.return_rank,
       web.currency_rank
from (select item, return_ratio, currency_ratio,
             rank() over (order by return_ratio) return_rank,
             rank() over (order by currency_ratio) currency_rank
      from (select ws.ws_item_sk item,
                   sum(coalesce(wr.wr_return_quantity, 0)) * 1.0 /
                   sum(coalesce(ws.ws_quantity, 0)) return_ratio,
                   sum(coalesce(wr.wr_return_amt, 0)) * 1.0 /
                   sum(coalesce(ws.ws_net_paid, 0)) currency_ratio
            from web_sales ws left join web_returns wr
                 on ws.ws_order_number = wr.wr_order_number
                 and ws.ws_item_sk = wr.wr_item_sk, date_dim
            where wr.wr_return_amt > 10000 and ws.ws_net_profit > 1
              and ws.ws_net_paid > 0 and ws.ws_quantity > 0
              and ws_sold_date_sk = d_date_sk
              and d_year = 2001 and d_moy = 12
            group by ws.ws_item_sk) in_web) web
where web.return_rank <= 10 or web.currency_rank <= 10
union
select 'catalog' channel, cat.item, cat.return_ratio, cat.return_rank,
       cat.currency_rank
from (select item, return_ratio, currency_ratio,
             rank() over (order by return_ratio) return_rank,
             rank() over (order by currency_ratio) currency_rank
      from (select cs.cs_item_sk item,
                   sum(coalesce(cr.cr_return_quantity, 0)) * 1.0 /
                   sum(coalesce(cs.cs_quantity, 0)) return_ratio,
                   sum(coalesce(cr.cr_return_amount, 0)) * 1.0 /
                   sum(coalesce(cs.cs_net_paid, 0)) currency_ratio
            from catalog_sales cs left join catalog_returns cr
                 on cs.cs_order_number = cr.cr_order_number
                 and cs.cs_item_sk = cr.cr_item_sk, date_dim
            where cr.cr_return_amount > 10000 and cs.cs_net_profit > 1
              and cs.cs_net_paid > 0 and cs.cs_quantity > 0
              and cs_sold_date_sk = d_date_sk
              and d_year = 2001 and d_moy = 12
            group by cs.cs_item_sk) in_cat) cat
where cat.return_rank <= 10 or cat.currency_rank <= 10
union
select 'store' channel, st.item, st.return_ratio, st.return_rank,
       st.currency_rank
from (select item, return_ratio, currency_ratio,
             rank() over (order by return_ratio) return_rank,
             rank() over (order by currency_ratio) currency_rank
      from (select sts.ss_item_sk item,
                   sum(coalesce(sr.sr_return_quantity, 0)) * 1.0 /
                   sum(coalesce(sts.ss_quantity, 0)) return_ratio,
                   sum(coalesce(sr.sr_return_amt, 0)) * 1.0 /
                   sum(coalesce(sts.ss_net_paid, 0)) currency_ratio
            from store_sales sts left join store_returns sr
                 on sts.ss_ticket_number = sr.sr_ticket_number
                 and sts.ss_item_sk = sr.sr_item_sk, date_dim
            where sr.sr_return_amt > 10000 and sts.ss_net_profit > 1
              and sts.ss_net_paid > 0 and sts.ss_quantity > 0
              and ss_sold_date_sk = d_date_sk
              and d_year = 2001 and d_moy = 12
            group by sts.ss_item_sk) in_store) st
where st.return_rank <= 10 or st.currency_rank <= 10
order by channel, return_rank, currency_rank, item
limit 100
""",
    54: """
with my_customers as (
  select distinct c_customer_sk, c_current_addr_sk
  from (select cs_sold_date_sk sold_date_sk,
               cs_bill_customer_sk customer_sk, cs_item_sk item_sk
        from catalog_sales
        union all
        select ws_sold_date_sk sold_date_sk,
               ws_bill_customer_sk customer_sk, ws_item_sk item_sk
        from web_sales) cs_or_ws_sales, item, date_dim, customer
  where sold_date_sk = d_date_sk and item_sk = i_item_sk
    and i_category = 'Women' and i_class = 'maternity'
    and c_customer_sk = cs_or_ws_sales.customer_sk
    and d_moy = 12 and d_year = 1998),
 my_revenue as (
  select c_customer_sk, sum(ss_ext_sales_price) revenue
  from my_customers, store_sales, customer_address, store, date_dim
  where c_current_addr_sk = ca_address_sk
    and ca_county = s_county and ca_state = s_state
    and ss_sold_date_sk = d_date_sk
    and c_customer_sk = ss_customer_sk
    and d_month_seq between (select distinct d_month_seq + 1
                             from date_dim
                             where d_year = 1998 and d_moy = 12)
                        and (select distinct d_month_seq + 3
                             from date_dim
                             where d_year = 1998 and d_moy = 12)
  group by c_customer_sk),
 segments as (
  select cast(revenue / 50 as integer) segment from my_revenue)
select segment, count(*) num_customers, segment * 50 segment_base
from segments
group by segment
order by segment, num_customers
limit 100
""",
    64: """
with cs_ui as (
  select cs_item_sk, sum(cs_ext_list_price) sale,
         sum(cr_refunded_cash + cr_reversed_charge + cr_store_credit)
           refund
  from catalog_sales, catalog_returns
  where cs_item_sk = cr_item_sk and cs_order_number = cr_order_number
  group by cs_item_sk
  having sum(cs_ext_list_price) >
         2 * sum(cr_refunded_cash + cr_reversed_charge
                 + cr_store_credit)),
 cross_sales as (
  select i_product_name product_name, i_item_sk item_sk,
         s_store_name store_name, s_zip store_zip,
         ad1.ca_street_number b_street_number,
         ad1.ca_street_name b_street_name, ad1.ca_city b_city,
         ad1.ca_zip b_zip, ad2.ca_street_number c_street_number,
         ad2.ca_street_name c_street_name, ad2.ca_city c_city,
         ad2.ca_zip c_zip, d1.d_year syear, d2.d_year fsyear,
         d3.d_year s2year, count(*) cnt, sum(ss_wholesale_cost) s1,
         sum(ss_list_price) s2, sum(ss_coupon_amt) s3
  from store_sales, store_returns, cs_ui, date_dim d1, date_dim d2,
       date_dim d3, store, customer, customer_demographics cd1,
       customer_demographics cd2, promotion,
       household_demographics hd1, household_demographics hd2,
       customer_address ad1, customer_address ad2, income_band ib1,
       income_band ib2, item
  where ss_store_sk = s_store_sk and ss_sold_date_sk = d1.d_date_sk
    and ss_customer_sk = c_customer_sk and ss_cdemo_sk = cd1.cd_demo_sk
    and ss_hdemo_sk = hd1.hd_demo_sk and ss_addr_sk = ad1.ca_address_sk
    and ss_item_sk = i_item_sk and ss_item_sk = sr_item_sk
    and ss_ticket_number = sr_ticket_number
    and ss_item_sk = cs_ui.cs_item_sk
    and c_current_cdemo_sk = cd2.cd_demo_sk
    and c_current_hdemo_sk = hd2.hd_demo_sk
    and c_current_addr_sk = ad2.ca_address_sk
    and c_first_sales_date_sk = d2.d_date_sk
    and c_first_shipto_date_sk = d3.d_date_sk
    and ss_promo_sk = p_promo_sk
    and hd1.hd_income_band_sk = ib1.ib_income_band_sk
    and hd2.hd_income_band_sk = ib2.ib_income_band_sk
    and cd1.cd_marital_status <> cd2.cd_marital_status
    and i_color in ('purple', 'burlywood', 'indian', 'spring',
                    'floral', 'medium')
    and i_current_price between 64 and 74
    and i_current_price between 65 and 79
  group by i_product_name, i_item_sk, s_store_name, s_zip,
           ad1.ca_street_number, ad1.ca_street_name, ad1.ca_city,
           ad1.ca_zip, ad2.ca_street_number, ad2.ca_street_name,
           ad2.ca_city, ad2.ca_zip, d1.d_year, d2.d_year, d3.d_year)
select cs1.product_name, cs1.store_name, cs1.store_zip,
       cs1.b_street_number, cs1.b_street_name, cs1.b_city, cs1.b_zip,
       cs1.c_street_number, cs1.c_street_name, cs1.c_city, cs1.c_zip,
       cs1.syear syear1, cs1.cnt cnt1, cs1.s1 s11, cs1.s2 s21,
       cs1.s3 s31, cs2.s1 s12, cs2.s2 s22, cs2.s3 s32,
       cs2.syear syear2, cs2.cnt cnt2
from cross_sales cs1, cross_sales cs2
where cs1.item_sk = cs2.item_sk and cs1.syear = 1999
  and cs2.syear = 2000 and cs2.cnt <= cs1.cnt
  and cs1.store_name = cs2.store_name
  and cs1.store_zip = cs2.store_zip
order by cs1.product_name, cs1.store_name, cs2.cnt, s11, s21, s31,
         s12, s22
""",
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
  and d3.d_date > d1.d_date + interval '5' day
  and hd_buy_potential = '>10000'
  and d1.d_year = 1999 and cd_marital_status = 'D'
group by i_item_desc, w_warehouse_name, d1.d_week_seq
order by total_cnt desc, i_item_desc, w_warehouse_name, d1.d_week_seq
limit 100
""",
    75: """
with all_sales as (
  select d_year, i_brand_id, i_class_id, i_category_id, i_manufact_id,
         sum(sales_cnt) sales_cnt, sum(sales_amt) sales_amt
  from (select d_year, i_brand_id, i_class_id, i_category_id,
               i_manufact_id,
               cs_quantity - coalesce(cr_return_quantity, 0) sales_cnt,
               cs_ext_sales_price - coalesce(cr_return_amount, 0.0)
                 sales_amt
        from catalog_sales
          inner join item on i_item_sk = cs_item_sk
          inner join date_dim on d_date_sk = cs_sold_date_sk
          left join catalog_returns on cs_order_number = cr_order_number
            and cs_item_sk = cr_item_sk
        where i_category = 'Books'
        union
        select d_year, i_brand_id, i_class_id, i_category_id,
               i_manufact_id,
               ss_quantity - coalesce(sr_return_quantity, 0) sales_cnt,
               ss_ext_sales_price - coalesce(sr_return_amt, 0.0) sales_amt
        from store_sales
          inner join item on i_item_sk = ss_item_sk
          inner join date_dim on d_date_sk = ss_sold_date_sk
          left join store_returns on ss_ticket_number = sr_ticket_number
            and ss_item_sk = sr_item_sk
        where i_category = 'Books'
        union
        select d_year, i_brand_id, i_class_id, i_category_id,
               i_manufact_id,
               ws_quantity - coalesce(wr_return_quantity, 0) sales_cnt,
               ws_ext_sales_price - coalesce(wr_return_amt, 0.0) sales_amt
        from web_sales
          inner join item on i_item_sk = ws_item_sk
          inner join date_dim on d_date_sk = ws_sold_date_sk
          left join web_returns on ws_order_number = wr_order_number
            and ws_item_sk = wr_item_sk
        where i_category = 'Books') sales_detail
  group by d_year, i_brand_id, i_class_id, i_category_id, i_manufact_id)
select prev_yr.d_year prev_year, curr_yr.d_year curr_year,
       curr_yr.i_brand_id, curr_yr.i_class_id, curr_yr.i_category_id,
       curr_yr.i_manufact_id, prev_yr.sales_cnt prev_yr_cnt,
       curr_yr.sales_cnt curr_yr_cnt,
       curr_yr.sales_cnt - prev_yr.sales_cnt sales_cnt_diff,
       curr_yr.sales_amt - prev_yr.sales_amt sales_amt_diff
from all_sales curr_yr, all_sales prev_yr
where curr_yr.i_brand_id = prev_yr.i_brand_id
  and curr_yr.i_class_id = prev_yr.i_class_id
  and curr_yr.i_category_id = prev_yr.i_category_id
  and curr_yr.i_manufact_id = prev_yr.i_manufact_id
  and curr_yr.d_year = 2002 and prev_yr.d_year = 2001
  and cast(curr_yr.sales_cnt as double) / prev_yr.sales_cnt < 0.9
order by sales_cnt_diff, sales_amt_diff
limit 100
""",
    78: """
with ws as (
  select d_year ws_sold_year, ws_item_sk,
         ws_bill_customer_sk ws_customer_sk, sum(ws_quantity) ws_qty,
         sum(ws_wholesale_cost) ws_wc, sum(ws_sales_price) ws_sp
  from web_sales
    left join web_returns on wr_order_number = ws_order_number
      and ws_item_sk = wr_item_sk
    inner join date_dim on ws_sold_date_sk = d_date_sk
  where wr_order_number is null
  group by d_year, ws_item_sk, ws_bill_customer_sk),
 cs as (
  select d_year cs_sold_year, cs_item_sk,
         cs_bill_customer_sk cs_customer_sk, sum(cs_quantity) cs_qty,
         sum(cs_wholesale_cost) cs_wc, sum(cs_sales_price) cs_sp
  from catalog_sales
    left join catalog_returns on cr_order_number = cs_order_number
      and cs_item_sk = cr_item_sk
    inner join date_dim on cs_sold_date_sk = d_date_sk
  where cr_order_number is null
  group by d_year, cs_item_sk, cs_bill_customer_sk),
 ss as (
  select d_year ss_sold_year, ss_item_sk, ss_customer_sk,
         sum(ss_quantity) ss_qty, sum(ss_wholesale_cost) ss_wc,
         sum(ss_sales_price) ss_sp
  from store_sales
    left join store_returns on sr_ticket_number = ss_ticket_number
      and ss_item_sk = sr_item_sk
    inner join date_dim on ss_sold_date_sk = d_date_sk
  where sr_ticket_number is null
  group by d_year, ss_item_sk, ss_customer_sk)
select ss_sold_year, ss_item_sk, ss_customer_sk,
       round(ss_qty * 1.0 / coalesce(ws_qty + cs_qty, 1), 2) ratio,
       ss_qty store_qty, ss_wc store_wholesale_cost,
       ss_sp store_sales_price,
       coalesce(ws_qty, 0) + coalesce(cs_qty, 0) other_chan_qty,
       coalesce(ws_wc, 0) + coalesce(cs_wc, 0)
         other_chan_wholesale_cost,
       coalesce(ws_sp, 0) + coalesce(cs_sp, 0) other_chan_sales_price
from ss
  left join ws on ws_sold_year = ss_sold_year
    and ws_item_sk = ss_item_sk and ws_customer_sk = ss_customer_sk
  left join cs on cs_sold_year = ss_sold_year
    and cs_item_sk = ss_item_sk and cs_customer_sk = ss_customer_sk
where coalesce(ws_qty, 0) > 0 and coalesce(cs_qty, 0) > 0
  and ss_sold_year = 2000
order by ss_sold_year, ss_item_sk, ss_customer_sk, ss_qty desc,
         ss_wc desc, ss_sp desc, other_chan_qty,
         other_chan_wholesale_cost, other_chan_sales_price,
         round(ss_qty * 1.0 / coalesce(ws_qty + cs_qty, 1), 2)
limit 100
""",
}

# queries whose outputs include float-producing aggregates (avg, ratios):
# the differential test compares those columns with a tolerance instead
# of exactly (engine = exact decimal, SQLite = float)
FUZZY = {2, 4, 5, 7, 8, 9, 12, 13, 14, 17, 18, 20, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 35, 36, 39, 44, 47, 49, 53, 54, 57, 61, 63, 64, 65, 66, 70, 75, 76, 77, 78, 80, 81, 83, 85, 86, 89, 90, 92, 98}

# what this package runs: all 99 queries
RUNS = tuple(sorted(QUERIES))
