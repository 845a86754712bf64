-- DF_I: inventory delete (role of the reference's
-- nds/data_maintenance/DF_I.sql; spec refresh function DF_I). DATE1 and
-- DATE2 come from the inventory_delete table, which carries a widened
-- window so the weekly snapshots are hit.
DELETE FROM inventory
 WHERE inv_date_sk >= (SELECT min(d_date_sk) FROM date_dim
                       WHERE d_date BETWEEN 'DATE1' AND 'DATE2')
   AND inv_date_sk <= (SELECT max(d_date_sk) FROM date_dim
                       WHERE d_date BETWEEN 'DATE1' AND 'DATE2');
