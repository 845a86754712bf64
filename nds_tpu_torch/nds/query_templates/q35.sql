select ca_state, cd_gender, cd_marital_status, cd_dep_count,
       count(*) cnt1,
       min(cd_dep_count) agg1, max(cd_dep_count) agg2,
       avg(cd_dep_count) agg3,
       cd_dep_employed_count,
       count(*) cnt2,
       min(cd_dep_employed_count) agg4, max(cd_dep_employed_count) agg5,
       avg(cd_dep_employed_count) agg6,
       cd_dep_college_count,
       count(*) cnt3,
       min(cd_dep_college_count) agg7, max(cd_dep_college_count) agg8,
       avg(cd_dep_college_count) agg9
from customer c, customer_address ca, customer_demographics
where c.c_current_addr_sk = ca.ca_address_sk
  and cd_demo_sk = c.c_current_cdemo_sk
  and exists (select * from store_sales, date_dim
              where c.c_customer_sk = ss_customer_sk
                and ss_sold_date_sk = d_date_sk
                and d_year = {year} and d_qoy < 4)
  and c.c_customer_sk in
      (select cust from
        (select ws_bill_customer_sk cust
         from web_sales, date_dim
         where ws_sold_date_sk = d_date_sk
           and d_year = {year} and d_qoy < 4
         union all
         select cs_ship_customer_sk cust
         from catalog_sales, date_dim
         where cs_sold_date_sk = d_date_sk
           and d_year = {year} and d_qoy < 4) alt)
group by ca_state, cd_gender, cd_marital_status, cd_dep_count,
         cd_dep_employed_count, cd_dep_college_count
order by ca_state, cd_gender, cd_marital_status, cd_dep_count,
         cd_dep_employed_count, cd_dep_college_count
limit 100
