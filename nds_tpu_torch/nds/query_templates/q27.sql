select i_item_id, s_state, grouping(s_state) g_state,
       avg(ss_quantity) agg1,
       avg(ss_list_price) agg2,
       avg(ss_coupon_amt) agg3,
       avg(ss_sales_price) agg4
from store_sales, customer_demographics, date_dim, store, item
where ss_sold_date_sk = d_date_sk
  and ss_item_sk = i_item_sk
  and ss_store_sk = s_store_sk
  and ss_cdemo_sk = cd_demo_sk
  and cd_gender = '{gender}'
  and cd_marital_status = '{marital}'
  and cd_education_status = '{education}'
  and d_year = {year}
  and s_state in ('{s1}', '{s2}', '{s3}', '{s4}', '{s5}', '{s6}')
group by rollup(i_item_id, s_state)
order by i_item_id, s_state
limit 100
