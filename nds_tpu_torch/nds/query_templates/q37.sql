select i_item_id, i_item_desc, i_current_price
from item, inventory, date_dim, catalog_sales
where i_current_price between {price} and {price} + 30
  and inv_item_sk = i_item_sk
  and d_date_sk = inv_date_sk
  and d_date between date '{date}' and date '{date}' + interval 60 days
  and i_manufact_id in ({m1}, {m2}, {m3}, {m4})
  and inv_quantity_on_hand between 100 and 500
  and cs_item_sk = i_item_sk
group by i_item_id, i_item_desc, i_current_price
order by i_item_id
limit 100
