select sum(ws_ext_discount_amt) as excess_discount_amount
from web_sales, item, date_dim
where i_manufact_id = {manufact}
  and i_item_sk = ws_item_sk
  and d_date between date '{date}' and date '{date}' + interval 90 days
  and d_date_sk = ws_sold_date_sk
  and ws_ext_discount_amt > (select 1.3 * avg(ws_ext_discount_amt)
                             from web_sales ws2, date_dim d2
                             where ws2.ws_item_sk = i_item_sk
                               and d2.d_date between date '{date}' and
                                   date '{date}' + interval 90 days
                               and d2.d_date_sk = ws2.ws_sold_date_sk)
order by sum(ws_ext_discount_amt)
limit 100
