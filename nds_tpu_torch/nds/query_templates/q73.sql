select c_last_name, c_first_name, c_salutation, c_preferred_cust_flag,
       ss_ticket_number, cnt
from (select ss_ticket_number, ss_customer_sk, count(*) cnt
      from store_sales, date_dim, store, household_demographics
      where store_sales.ss_sold_date_sk = date_dim.d_date_sk
        and store_sales.ss_store_sk = store.s_store_sk
        and store_sales.ss_hdemo_sk = household_demographics.hd_demo_sk
        and date_dim.d_dom between 1 and 2
        and (household_demographics.hd_buy_potential = '{bp1}'
             or household_demographics.hd_buy_potential = '{bp2}')
        and household_demographics.hd_vehicle_count > 0
        and date_dim.d_year in ({year}, {year} + 1, {year} + 2)
        and store.s_county in ('{county1}', '{county2}', '{county3}',
                               '{county4}')
      group by ss_ticket_number, ss_customer_sk) dj, customer
where ss_customer_sk = c_customer_sk
  and cnt between 1 and 5
order by cnt desc, c_last_name
limit 1000
