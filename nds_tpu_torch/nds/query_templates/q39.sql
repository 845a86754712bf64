with inv as (
  select w_warehouse_name, w_warehouse_sk, i_item_sk, d_moy, stdev,
         mean,
         case when mean = 0 then null else stdev / mean end cov
  from (select w_warehouse_name, w_warehouse_sk, i_item_sk, d_moy,
               stddev_samp(inv_quantity_on_hand) stdev,
               avg(inv_quantity_on_hand) mean
        from inventory, item, warehouse, date_dim
        where inv_item_sk = i_item_sk
          and inv_warehouse_sk = w_warehouse_sk
          and inv_date_sk = d_date_sk
          and d_year = {year}
        group by w_warehouse_name, w_warehouse_sk, i_item_sk,
                 d_moy) foo
  where case when mean = 0 then 0 else stdev / mean end > 1)
select inv1.w_warehouse_sk wsk1, inv1.i_item_sk isk1, inv1.d_moy dmoy1,
       inv1.mean mean1, inv1.cov cov1, inv2.w_warehouse_sk wsk2,
       inv2.i_item_sk isk2, inv2.d_moy dmoy2, inv2.mean mean2,
       inv2.cov cov2
from inv inv1, inv inv2
where inv1.i_item_sk = inv2.i_item_sk
  and inv1.w_warehouse_sk = inv2.w_warehouse_sk
  and inv1.d_moy = {month}
  and inv2.d_moy = {month} + 1
order by wsk1, isk1, dmoy1, mean1, cov1, dmoy2, mean2, cov2;
with inv as (
  select w_warehouse_name, w_warehouse_sk, i_item_sk, d_moy, stdev,
         mean,
         case when mean = 0 then null else stdev / mean end cov
  from (select w_warehouse_name, w_warehouse_sk, i_item_sk, d_moy,
               stddev_samp(inv_quantity_on_hand) stdev,
               avg(inv_quantity_on_hand) mean
        from inventory, item, warehouse, date_dim
        where inv_item_sk = i_item_sk
          and inv_warehouse_sk = w_warehouse_sk
          and inv_date_sk = d_date_sk
          and d_year = {year}
        group by w_warehouse_name, w_warehouse_sk, i_item_sk,
                 d_moy) foo
  where case when mean = 0 then 0 else stdev / mean end > 1)
select inv1.w_warehouse_sk wsk1, inv1.i_item_sk isk1, inv1.d_moy dmoy1,
       inv1.mean mean1, inv1.cov cov1, inv2.w_warehouse_sk wsk2,
       inv2.i_item_sk isk2, inv2.d_moy dmoy2, inv2.mean mean2,
       inv2.cov cov2
from inv inv1, inv inv2
where inv1.i_item_sk = inv2.i_item_sk
  and inv1.w_warehouse_sk = inv2.w_warehouse_sk
  and inv1.d_moy = {month}
  and inv2.d_moy = {month} + 1
  and inv1.cov > 1.5
order by wsk1, isk1, dmoy1, mean1, cov1, dmoy2, mean2, cov2
;
