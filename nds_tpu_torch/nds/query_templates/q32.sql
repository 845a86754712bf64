select sum(cs_ext_discount_amt) as excess_discount_amount
from catalog_sales, item, date_dim
where i_manufact_id = {manufact}
  and i_item_sk = cs_item_sk
  and d_date between date '{date}' and date '{date}' + interval 90 days
  and d_date_sk = cs_sold_date_sk
  and cs_ext_discount_amt > (select 1.3 * avg(cs_ext_discount_amt)
                             from catalog_sales cs2, date_dim d2
                             where cs2.cs_item_sk = i_item_sk
                               and d2.d_date between date '{date}' and
                                   date '{date}' + interval 90 days
                               and d2.d_date_sk = cs2.cs_sold_date_sk)
limit 100
