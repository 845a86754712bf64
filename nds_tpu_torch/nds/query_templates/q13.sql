select avg(ss_quantity) avg_qty,
       avg(ss_ext_sales_price) avg_esp,
       avg(ss_ext_wholesale_cost) avg_ewc,
       sum(ss_ext_wholesale_cost) sum_ewc
from store_sales, store, customer_demographics,
     household_demographics, customer_address, date_dim
where s_store_sk = ss_store_sk
  and ss_sold_date_sk = d_date_sk and d_year = {year}
  and ((ss_hdemo_sk = hd_demo_sk
        and cd_demo_sk = ss_cdemo_sk
        and cd_marital_status = '{ms1}'
        and cd_education_status = '{es1}'
        and ss_sales_price between 100.00 and 150.00
        and hd_dep_count = 3)
    or (ss_hdemo_sk = hd_demo_sk
        and cd_demo_sk = ss_cdemo_sk
        and cd_marital_status = '{ms2}'
        and cd_education_status = '{es2}'
        and ss_sales_price between 50.00 and 100.00
        and hd_dep_count = 1)
    or (ss_hdemo_sk = hd_demo_sk
        and cd_demo_sk = ss_cdemo_sk
        and cd_marital_status = '{ms3}'
        and cd_education_status = '{es3}'
        and ss_sales_price between 150.00 and 200.00
        and hd_dep_count = 1))
  and ((ss_addr_sk = ca_address_sk
        and ca_country = 'United States'
        and ca_state in ('{s1}', '{s2}', '{s3}')
        and ss_net_profit between 100 and 200)
    or (ss_addr_sk = ca_address_sk
        and ca_country = 'United States'
        and ca_state in ('{s4}', '{s5}', '{s6}')
        and ss_net_profit between 150 and 300)
    or (ss_addr_sk = ca_address_sk
        and ca_country = 'United States'
        and ca_state in ('{s7}', '{s8}', '{s9}')
        and ss_net_profit between 50 and 250))
