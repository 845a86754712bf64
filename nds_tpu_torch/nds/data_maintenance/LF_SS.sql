-- LF_SS: store_sales refresh insert (role of the reference's
-- nds/data_maintenance/LF_SS.sql; TPC-DS spec refresh function LF_SS).
-- Dialect notes vs the reference: staging dates/times are engine-typed
-- (DATE epoch days / integer seconds), so the cast()/substr() hops are
-- unnecessary, and the *_rec_end_date IS NULL current-record filters
-- are expressed as CTEs over the SCD dimensions.
DROP VIEW IF EXISTS ssv;
CREATE TEMP VIEW ssv AS
WITH cur_item AS (SELECT * FROM item WHERE i_rec_end_date IS NULL),
     cur_store AS (SELECT * FROM store WHERE s_rec_end_date IS NULL)
SELECT d_date_sk ss_sold_date_sk,
 t_time_sk ss_sold_time_sk,
 i_item_sk ss_item_sk,
 c_customer_sk ss_customer_sk,
 c_current_cdemo_sk ss_cdemo_sk,
 c_current_hdemo_sk ss_hdemo_sk,
 c_current_addr_sk ss_addr_sk,
 s_store_sk ss_store_sk,
 p_promo_sk ss_promo_sk,
 purc_purchase_id ss_ticket_number,
 plin_quantity ss_quantity,
 i_wholesale_cost ss_wholesale_cost,
 i_current_price ss_list_price,
 plin_sale_price ss_sales_price,
 (i_current_price - plin_sale_price) * plin_quantity ss_ext_discount_amt,
 plin_sale_price * plin_quantity ss_ext_sales_price,
 i_wholesale_cost * plin_quantity ss_ext_wholesale_cost,
 i_current_price * plin_quantity ss_ext_list_price,
 i_current_price * s_tax_precentage ss_ext_tax,
 plin_coupon_amt ss_coupon_amt,
 (plin_sale_price * plin_quantity) - plin_coupon_amt ss_net_paid,
 ((plin_sale_price * plin_quantity) - plin_coupon_amt) * (1 + s_tax_precentage) ss_net_paid_inc_tax,
 ((plin_sale_price * plin_quantity) - plin_coupon_amt) - (plin_quantity * i_wholesale_cost) ss_net_profit
FROM s_purchase
JOIN s_purchase_lineitem ON (purc_purchase_id = plin_purchase_id)
LEFT OUTER JOIN customer ON (purc_customer_id = c_customer_id)
LEFT OUTER JOIN cur_store ON (purc_store_id = s_store_id)
LEFT OUTER JOIN date_dim ON (purc_purchase_date = d_date)
LEFT OUTER JOIN time_dim ON (purc_purchase_time = t_time)
LEFT OUTER JOIN promotion ON (plin_promotion_id = p_promo_id)
LEFT OUTER JOIN cur_item ON (plin_item_id = i_item_id);
INSERT INTO store_sales (SELECT * FROM ssv ORDER BY ss_sold_date_sk);
DROP VIEW ssv;
