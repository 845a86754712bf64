-- DF_CS: catalog channel delete (role of the reference's
-- nds/data_maintenance/DF_CS.sql; spec refresh function DF_CS).
DELETE FROM catalog_returns WHERE cr_order_number IN
  (SELECT DISTINCT cs_order_number FROM catalog_sales, date_dim
   WHERE cs_sold_date_sk = d_date_sk AND d_date BETWEEN 'DATE1' AND 'DATE2');
DELETE FROM catalog_sales
 WHERE cs_sold_date_sk >= (SELECT min(d_date_sk) FROM date_dim
                           WHERE d_date BETWEEN 'DATE1' AND 'DATE2')
   AND cs_sold_date_sk <= (SELECT max(d_date_sk) FROM date_dim
                           WHERE d_date BETWEEN 'DATE1' AND 'DATE2');
