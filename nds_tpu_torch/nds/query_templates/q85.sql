select substring(r_reason_desc, 1, 20) reason, avg(ws_quantity) q,
       avg(wr_refunded_cash) refunded, avg(wr_fee) fee
from web_sales, web_returns, web_page, customer_demographics cd1,
     customer_demographics cd2, customer_address, date_dim, reason
where ws_web_page_sk = wp_web_page_sk
  and ws_item_sk = wr_item_sk
  and ws_order_number = wr_order_number
  and ws_sold_date_sk = d_date_sk
  and d_year = {year}
  and cd1.cd_demo_sk = wr_refunded_cdemo_sk
  and cd2.cd_demo_sk = wr_returning_cdemo_sk
  and ca_address_sk = wr_refunded_addr_sk
  and r_reason_sk = wr_reason_sk
  and ((cd1.cd_marital_status = 'M'
        and cd1.cd_marital_status = cd2.cd_marital_status
        and cd1.cd_education_status = 'Advanced Degree'
        and cd1.cd_education_status = cd2.cd_education_status
        and ws_sales_price between 20.00 and 60.00)
    or (cd1.cd_marital_status = 'S'
        and cd1.cd_marital_status = cd2.cd_marital_status
        and cd1.cd_education_status = 'College'
        and cd1.cd_education_status = cd2.cd_education_status
        and ws_sales_price between 60.00 and 90.00)
    or (cd1.cd_marital_status = 'W'
        and cd1.cd_marital_status = cd2.cd_marital_status
        and cd1.cd_education_status = '2 yr Degree'
        and cd1.cd_education_status = cd2.cd_education_status
        and ws_sales_price between 0.99 and 20.00))
  and ((ca_country = 'United States'
        and ca_state in ('IN', 'OH', 'KY')
        and ws_net_profit between 100 and 20000)
    or (ca_country = 'United States'
        and ca_state in ('WI', 'CA', 'TX')
        and ws_net_profit between 150 and 30000)
    or (ca_country = 'United States'
        and ca_state in ('LA', 'GA', 'MO')
        and ws_net_profit between 50 and 25000))
group by r_reason_desc
order by reason, q, refunded, fee
limit 100
