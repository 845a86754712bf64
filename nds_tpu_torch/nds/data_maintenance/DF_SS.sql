-- DF_SS: store channel delete (role of the reference's
-- nds/data_maintenance/DF_SS.sql; spec refresh function DF_SS). DATE1
-- and DATE2 are substituted from the generated delete table
-- (`nds/nds_maintenance.py:75-96`).
DELETE FROM store_returns WHERE sr_ticket_number IN
  (SELECT DISTINCT ss_ticket_number FROM store_sales, date_dim
   WHERE ss_sold_date_sk = d_date_sk AND d_date BETWEEN 'DATE1' AND 'DATE2');
DELETE FROM store_sales
 WHERE ss_sold_date_sk >= (SELECT min(d_date_sk) FROM date_dim
                           WHERE d_date BETWEEN 'DATE1' AND 'DATE2')
   AND ss_sold_date_sk <= (SELECT max(d_date_sk) FROM date_dim
                           WHERE d_date BETWEEN 'DATE1' AND 'DATE2');
