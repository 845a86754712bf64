-- LF_WR: web_returns refresh insert (role of the reference's
-- nds/data_maintenance/LF_WR.sql; spec refresh function LF_WR). Same
-- dialect notes as LF_SS.sql.
DROP VIEW IF EXISTS wrv;
CREATE TEMP VIEW wrv AS
WITH cur_item AS (SELECT * FROM item WHERE i_rec_end_date IS NULL),
     cur_wp AS (SELECT * FROM web_page WHERE wp_rec_end_date IS NULL)
SELECT d_date_sk wr_returned_date_sk,
 t_time_sk wr_returned_time_sk,
 i_item_sk wr_item_sk,
 c1.c_customer_sk wr_refunded_customer_sk,
 c1.c_current_cdemo_sk wr_refunded_cdemo_sk,
 c1.c_current_hdemo_sk wr_refunded_hdemo_sk,
 c1.c_current_addr_sk wr_refunded_addr_sk,
 c2.c_customer_sk wr_returning_customer_sk,
 c2.c_current_cdemo_sk wr_returning_cdemo_sk,
 c2.c_current_hdemo_sk wr_returning_hdemo_sk,
 c2.c_current_addr_sk wr_returning_addr_sk,
 wp_web_page_sk wr_web_page_sk,
 r_reason_sk wr_reason_sk,
 wret_order_id wr_order_number,
 wret_return_qty wr_return_quantity,
 wret_return_amt wr_return_amt,
 wret_return_tax wr_return_tax,
 wret_return_amt + wret_return_tax wr_return_amt_inc_tax,
 wret_return_fee wr_fee,
 wret_return_ship_cost wr_return_ship_cost,
 wret_refunded_cash wr_refunded_cash,
 wret_reversed_charge wr_reversed_charge,
 wret_account_credit wr_account_credit,
 wret_return_amt + wret_return_tax + wret_return_fee
  - wret_refunded_cash - wret_reversed_charge - wret_account_credit wr_net_loss
FROM s_web_returns
LEFT OUTER JOIN date_dim ON (wret_return_date = d_date)
LEFT OUTER JOIN time_dim ON (wret_return_time = t_time)
LEFT OUTER JOIN cur_item ON (wret_item_id = i_item_id)
LEFT OUTER JOIN customer c1 ON (wret_refund_customer_id = c1.c_customer_id)
LEFT OUTER JOIN customer c2 ON (wret_return_customer_id = c2.c_customer_id)
LEFT OUTER JOIN reason ON (wret_reason_id = r_reason_id)
LEFT OUTER JOIN cur_wp ON (wret_web_page_id = wp_web_page_id);
INSERT INTO web_returns (SELECT * FROM wrv ORDER BY wr_returned_date_sk);
DROP VIEW wrv;
