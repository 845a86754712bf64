-- dialect note: the spec's "substr(zip) in (...) OR i_item_id IN
-- (subquery)" disjunct is expressed as a LEFT JOIN against the
-- (tiny, uncorrelated) item-id set + IS NOT NULL, which is the same
-- predicate — the engine plans IN-subqueries only as WHERE conjuncts
select ca_zip, ca_city, sum(ws_sales_price) total_sales
from web_sales, customer, customer_address, date_dim, item
     left outer join
     (select distinct i_item_id hot_item_id from item
      where i_item_sk in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29)) hot
     on (item.i_item_id = hot.hot_item_id)
where ws_bill_customer_sk = c_customer_sk
  and c_current_addr_sk = ca_address_sk
  and ws_item_sk = i_item_sk
  and ws_sold_date_sk = d_date_sk
  and d_qoy = {qoy} and d_year = {year}
  and (substring(ca_zip, 1, 3) in ('100', '102', '103', '105', '108',
                                   '110', '113', '115', '118')
       or hot.hot_item_id is not null)
group by ca_zip, ca_city
order by ca_zip, ca_city
limit 100
