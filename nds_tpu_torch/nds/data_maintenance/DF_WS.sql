-- DF_WS: web channel delete (role of the reference's
-- nds/data_maintenance/DF_WS.sql; spec refresh function DF_WS).
DELETE FROM web_returns WHERE wr_order_number IN
  (SELECT DISTINCT ws_order_number FROM web_sales, date_dim
   WHERE ws_sold_date_sk = d_date_sk AND d_date BETWEEN 'DATE1' AND 'DATE2');
DELETE FROM web_sales
 WHERE ws_sold_date_sk >= (SELECT min(d_date_sk) FROM date_dim
                           WHERE d_date BETWEEN 'DATE1' AND 'DATE2')
   AND ws_sold_date_sk <= (SELECT max(d_date_sk) FROM date_dim
                           WHERE d_date BETWEEN 'DATE1' AND 'DATE2');
