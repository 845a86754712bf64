-- LF_I: inventory refresh insert (role of the reference's
-- nds/data_maintenance/LF_I.sql; spec refresh function LF_I). Same
-- dialect notes as LF_SS.sql.
DROP VIEW IF EXISTS iv;
CREATE TEMP VIEW iv AS
WITH cur_item AS (SELECT * FROM item WHERE i_rec_end_date IS NULL)
SELECT d_date_sk inv_date_sk,
 i_item_sk inv_item_sk,
 w_warehouse_sk inv_warehouse_sk,
 invn_qty_on_hand inv_quantity_on_hand
FROM s_inventory
LEFT OUTER JOIN warehouse ON (invn_warehouse_id = w_warehouse_id)
LEFT OUTER JOIN cur_item ON (invn_item_id = i_item_id)
LEFT OUTER JOIN date_dim ON (d_date = invn_date);
INSERT INTO inventory (SELECT * FROM iv ORDER BY inv_date_sk);
DROP VIEW iv;
