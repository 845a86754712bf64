select sum(ss_quantity) total_qty
from store_sales, store, customer_demographics,
     customer_address, date_dim
where s_store_sk = ss_store_sk
  and ss_sold_date_sk = d_date_sk and d_year = {year}
  and ((cd_demo_sk = ss_cdemo_sk
        and cd_marital_status = '{ms1}'
        and cd_education_status = '{es1}'
        and ss_sales_price between 100.00 and 150.00)
    or (cd_demo_sk = ss_cdemo_sk
        and cd_marital_status = '{ms2}'
        and cd_education_status = '{es2}'
        and ss_sales_price between 50.00 and 100.00)
    or (cd_demo_sk = ss_cdemo_sk
        and cd_marital_status = '{ms3}'
        and cd_education_status = '{es3}'
        and ss_sales_price between 150.00 and 200.00))
  and ((ss_addr_sk = ca_address_sk
        and ca_country = 'United States'
        and ca_state in ('{s1}', '{s2}', '{s3}')
        and ss_net_profit between 0 and 2000)
    or (ss_addr_sk = ca_address_sk
        and ca_country = 'United States'
        and ca_state in ('{s4}', '{s5}', '{s6}')
        and ss_net_profit between 150 and 3000)
    or (ss_addr_sk = ca_address_sk
        and ca_country = 'United States'
        and ca_state in ('{s7}', '{s8}', '{s9}')
        and ss_net_profit between 50 and 25000))
