"""Refresh (update-set) data generator for the NDS data-maintenance phase.

Port copy of ``nds_tpu/datagen/tpcds_refresh.py`` over the port's
generator (``datagen/tpcds.py``): the same arrays for the same (scale,
update, table).

The upstream benchmark gets refresh data from ``dsdgen --update N``
(`nds/nds_gen_data.py:183-244` with ``--update``, moved delete tables
`:119-127`); this is the builtin hermetic counterpart: the 10 s_*
staging tables plus the two delete-window tables, sized by scale factor
and deterministic on (SEED, update, table).

Business-ID consistency contract (what the LF_* refresh functions join
on, `nds/data_maintenance/LF_SS.sql`, `LF_CS.sql`, `LF_I.sql`):
- *_item_id / *_store_id / *_call_center_id / *_web_site_id /
  *_web_page_id reference the CURRENT SCD record of the base dimension
  (ids repeat across the 2-row history; the odd surrogate key is the
  open record with NULL rec_end_date — see ``tpcds._gen_item``);
- *_customer_id / *_warehouse_id / *_promotion_id / ship-mode / reason
  ids cover the full base domain (no SCD);
- catalog lineitems address real (cp_catalog_number,
  cp_catalog_page_number) pairs;
- order/purchase dates land in a per-update window AFTER the base sales
  window (inserts extend history), while the delete tables' [date1,
  date2] windows land INSIDE it (deletes remove base rows) — dsdgen's
  refresh semantics.
- returns staging rows reference EXISTING ticket/order numbers so
  inserted returns join back to sales.

Times are integer seconds-since-midnight (join t_time directly) and
dates are engine DATE epoch days: the builtin generator owns the raw
format, so the reference's ``cast(char AS date)`` / substr-time hops are
unnecessary (see ``nds/schema.py:get_maintenance_schemas``).
"""

from __future__ import annotations

import numpy as np

from nds_tpu_torch.datagen.tpcds import (
    SALES_DATE_HI, SALES_DATE_LO, SEED, _choice, _h, _ids, _uniform,
    sk_to_epoch,
)
from nds_tpu_torch.nds.schema import table_rows

# insert window: one week per update, after the base sales window
_INSERT_BASE = sk_to_epoch(SALES_DATE_HI)
# delete window: 30 days, walking through the base window per update
_BASE_LO = sk_to_epoch(SALES_DATE_LO)
_BASE_DAYS = SALES_DATE_HI - SALES_DATE_LO


def _n_orders(channel_rows: int) -> int:
    """Refresh set size: ~0.1% of the channel's base tickets (>= 8)."""
    return max(channel_rows // 10 // 1000, 8)


def _current_id(h, table: str, sf: float) -> np.ndarray:
    """Business id of a CURRENT (open SCD record) dimension row."""
    n = table_rows(table, sf)
    return _ids("AAAAAAAA", _uniform(h, 1, max((n + 1) // 2, 1)))


def _full_id(h, table: str, sf: float) -> np.ndarray:
    n = table_rows(table, sf)
    return _ids("AAAAAAAA", _uniform(h, 1, max(n, 1)))


def _insert_dates(h, update: int) -> np.ndarray:
    lo = _INSERT_BASE + (update - 1) * 7 + 1
    return _uniform(h, lo, lo + 6)


def _money(h, lo=99, hi=9999) -> np.ndarray:
    return _uniform(h, lo, hi)  # cents (scaled decimal(7,2))


def _orders_lineitems(seed_tag: str, sf: float, update: int,
                      channel_rows: int):
    """Shared order/lineitem shape: order i has (i % 3) + 1 lines.
    Returns (order_ids, per-order hash fn, line order-idx, line#,
    per-line hash fn)."""
    n = _n_orders(channel_rows)
    oidx = np.arange(n, dtype=np.int64)
    # ids disjoint from base ticket/order numbers (which are ~rows/10):
    # park refresh ids in a high block keyed by update number
    base = 1_000_000_000 + (update - 1) * 10_000_000
    order_ids = base + oidx + 1
    lines = (oidx % 3) + 1
    lidx_order = np.repeat(oidx, lines)
    line_no = (np.arange(len(lidx_order), dtype=np.int64)
               - np.repeat(np.cumsum(lines) - lines, lines)) + 1
    oh = lambda k: _h(SEED, seed_tag + f"#u{update}", k, oidx)
    lh = lambda k: _h(SEED, seed_tag + f"#ul{update}", k,
                      np.arange(len(lidx_order), dtype=np.int64))
    return order_ids, oh, lidx_order, line_no, lh


def _gen_purchase_pair(sf: float, update: int):
    rows = table_rows("store_sales", sf)
    ids, oh, lo_idx, line_no, lh = _orders_lineitems(
        "s_purchase", sf, update, rows)
    purchase = {
        "purc_purchase_id": ids.astype(np.int32),
        "purc_store_id": _current_id(oh(1), "store", sf),
        "purc_customer_id": _full_id(oh(2), "customer", sf),
        "purc_purchase_date": _insert_dates(oh(3), update
                                            ).astype(np.int32),
        "purc_purchase_time": _uniform(oh(4), 0, 86399).astype(np.int32),
        "purc_register_id": _uniform(oh(5), 1, 40).astype(np.int32),
        "purc_clerk_id": _uniform(oh(6), 1, 200).astype(np.int32),
        "purc_comment": _choice(oh(7), ["in store purchase",
                                        "holiday purchase",
                                        "regular purchase"]),
    }
    qty = _uniform(lh(3), 1, 100)
    sale = _money(lh(4))
    lineitem = {
        "plin_purchase_id": ids[lo_idx].astype(np.int32),
        "plin_line_number": line_no.astype(np.int32),
        "plin_item_id": _current_id(lh(1), "item", sf),
        "plin_promotion_id": _full_id(lh(2), "promotion", sf),
        "plin_quantity": qty.astype(np.int32),
        "plin_sale_price": sale.astype(np.int64),
        "plin_coupon_amt": np.where(
            lh(5) % np.uint64(100) < np.uint64(15),
            sale * qty // 10, 0).astype(np.int64),
        "plin_comment": _choice(lh(6), ["line comment", "gift wrap",
                                        "no comment"]),
    }
    return purchase, lineitem


def _gen_catalog_pair(sf: float, update: int):
    rows = table_rows("catalog_sales", sf)
    ids, oh, lo_idx, line_no, lh = _orders_lineitems(
        "s_catalog_order", sf, update, rows)
    order = {
        "cord_order_id": ids.astype(np.int32),
        "cord_bill_customer_id": _full_id(oh(1), "customer", sf),
        "cord_ship_customer_id": _full_id(oh(2), "customer", sf),
        "cord_order_date": _insert_dates(oh(3), update).astype(np.int32),
        "cord_order_time": _uniform(oh(4), 0, 86399).astype(np.int32),
        "cord_ship_mode_id": _full_id(oh(5), "ship_mode", sf),
        "cord_call_center_id": _current_id(oh(6), "call_center", sf),
        "cord_order_comments": _choice(oh(7), ["phone order",
                                               "catalog order",
                                               "repeat order"]),
    }
    n_cp = table_rows("catalog_page", sf)
    cp_idx = _uniform(lh(7), 0, max(n_cp - 1, 0))
    qty = _uniform(lh(3), 1, 100)
    sale = _money(lh(4))
    lineitem = {
        "clin_order_id": ids[lo_idx].astype(np.int32),
        "clin_line_number": line_no.astype(np.int32),
        "clin_item_id": _current_id(lh(1), "item", sf),
        "clin_promotion_id": _full_id(lh(2), "promotion", sf),
        "clin_quantity": qty.astype(np.int32),
        "clin_sales_price": sale.astype(np.int64),
        "clin_coupon_amt": np.where(
            lh(5) % np.uint64(100) < np.uint64(15),
            sale * qty // 10, 0).astype(np.int64),
        "clin_warehouse_id": _full_id(lh(6), "warehouse", sf),
        "clin_ship_date": (_insert_dates(lh(8), update) + 3
                           ).astype(np.int32),
        "clin_catalog_number": (cp_idx // 108 + 1).astype(np.int32),
        "clin_catalog_page_number": (cp_idx % 108 + 1).astype(np.int32),
        "clin_ship_cost": _money(lh(9), 0, 2000).astype(np.int64),
    }
    return order, lineitem


def _gen_web_pair(sf: float, update: int):
    rows = table_rows("web_sales", sf)
    ids, oh, lo_idx, line_no, lh = _orders_lineitems(
        "s_web_order", sf, update, rows)
    order = {
        "word_order_id": ids.astype(np.int32),
        "word_bill_customer_id": _full_id(oh(1), "customer", sf),
        "word_ship_customer_id": _full_id(oh(2), "customer", sf),
        "word_order_date": _insert_dates(oh(3), update).astype(np.int32),
        "word_order_time": _uniform(oh(4), 0, 86399).astype(np.int32),
        "word_ship_mode_id": _full_id(oh(5), "ship_mode", sf),
        "word_web_site_id": _current_id(oh(6), "web_site", sf),
        "word_order_comments": _choice(oh(7), ["web order",
                                               "mobile order",
                                               "repeat order"]),
    }
    qty = _uniform(lh(3), 1, 100)
    sale = _money(lh(4))
    lineitem = {
        "wlin_order_id": ids[lo_idx].astype(np.int32),
        "wlin_line_number": line_no.astype(np.int32),
        "wlin_item_id": _current_id(lh(1), "item", sf),
        "wlin_promotion_id": _full_id(lh(2), "promotion", sf),
        "wlin_quantity": qty.astype(np.int32),
        "wlin_sales_price": sale.astype(np.int64),
        "wlin_coupon_amt": np.where(
            lh(5) % np.uint64(100) < np.uint64(15),
            sale * qty // 10, 0).astype(np.int64),
        "wlin_warehouse_id": _full_id(lh(6), "warehouse", sf),
        "wlin_ship_date": (_insert_dates(lh(8), update) + 2
                           ).astype(np.int32),
        "wlin_ship_cost": _money(lh(9), 0, 2000).astype(np.int64),
        "wlin_web_page_id": _current_id(lh(7), "web_page", sf),
    }
    return order, lineitem


def _return_money(h):
    amt = _money(h(10))
    tax = amt * _uniform(h(11), 0, 9) // 100
    fee = _money(h(12), 0, 100)
    ship = _money(h(13), 0, 500)
    refunded = amt * _uniform(h(14), 0, 100) // 100
    reversed_c = (amt - refunded) * _uniform(h(15), 0, 100) // 100
    credit = amt - refunded - reversed_c
    return amt, tax, fee, ship, refunded, reversed_c, credit


def _gen_s_store_returns(sf: float, update: int):
    n = max(_n_orders(table_rows("store_sales", sf)) // 2, 4)
    idx = np.arange(n, dtype=np.int64)
    h = lambda k: _h(SEED, f"s_store_returns#u{update}", k, idx)
    n_tickets = max(table_rows("store_sales", sf) // 10, 1)
    ticket = _uniform(h(1), 1, n_tickets)
    amt, tax, fee, ship, refunded, reversed_c, credit = _return_money(h)
    return {
        "sret_store_id": _current_id(h(2), "store", sf),
        "sret_purchase_id": _ids("", ticket, 16),
        "sret_line_number": _uniform(h(3), 1, 16).astype(np.int32),
        "sret_item_id": _current_id(h(4), "item", sf),
        "sret_customer_id": _full_id(h(5), "customer", sf),
        "sret_return_date": (_insert_dates(h(6), update) + 1
                             ).astype(np.int32),
        "sret_return_time": _uniform(h(7), 0, 86399).astype(np.int32),
        "sret_ticket_number": ticket.astype(np.int64),
        "sret_return_qty": _uniform(h(8), 1, 50).astype(np.int32),
        "sret_return_amt": amt.astype(np.int64),
        "sret_return_tax": tax.astype(np.int64),
        "sret_return_fee": fee.astype(np.int64),
        "sret_return_ship_cost": ship.astype(np.int64),
        "sret_refunded_cash": refunded.astype(np.int64),
        "sret_reversed_charge": reversed_c.astype(np.int64),
        "sret_store_credit": credit.astype(np.int64),
        "sret_reason_id": _full_id(h(9), "reason", sf),
    }


def _gen_s_catalog_returns(sf: float, update: int):
    n = max(_n_orders(table_rows("catalog_sales", sf)) // 2, 4)
    idx = np.arange(n, dtype=np.int64)
    h = lambda k: _h(SEED, f"s_catalog_returns#u{update}", k, idx)
    n_orders = max(table_rows("catalog_sales", sf) // 10, 1)
    order = _uniform(h(1), 1, n_orders)
    amt, tax, fee, ship, refunded, reversed_c, credit = _return_money(h)
    n_cp = table_rows("catalog_page", sf)
    return {
        "cret_call_center_id": _current_id(h(2), "call_center", sf),
        "cret_order_id": order.astype(np.int32),
        "cret_line_number": _uniform(h(3), 1, 16).astype(np.int32),
        "cret_item_id": _current_id(h(4), "item", sf),
        "cret_return_customer_id": _full_id(h(5), "customer", sf),
        "cret_refund_customer_id": _full_id(h(16), "customer", sf),
        "cret_return_date": (_insert_dates(h(6), update) + 1
                             ).astype(np.int32),
        "cret_return_time": _uniform(h(7), 0, 86399).astype(np.int32),
        "cret_return_qty": _uniform(h(8), 1, 50).astype(np.int32),
        "cret_return_amt": amt.astype(np.int64),
        "cret_return_tax": tax.astype(np.int64),
        "cret_return_fee": fee.astype(np.int64),
        "cret_return_ship_cost": ship.astype(np.int64),
        "cret_refunded_cash": refunded.astype(np.int64),
        "cret_reversed_charge": reversed_c.astype(np.int64),
        "cret_merchant_credit": credit.astype(np.int64),
        "cret_reason_id": _full_id(h(9), "reason", sf),
        "cret_shipmode_id": _full_id(h(17), "ship_mode", sf),
        "cret_catalog_page_id": _ids(
            "AAAAAAAA", _uniform(h(18), 1, max(n_cp, 1))),
        "cret_warehouse_id": _full_id(h(19), "warehouse", sf),
    }


def _gen_s_web_returns(sf: float, update: int):
    n = max(_n_orders(table_rows("web_sales", sf)) // 2, 4)
    idx = np.arange(n, dtype=np.int64)
    h = lambda k: _h(SEED, f"s_web_returns#u{update}", k, idx)
    n_orders = max(table_rows("web_sales", sf) // 10, 1)
    order = _uniform(h(1), 1, n_orders)
    amt, tax, fee, ship, refunded, reversed_c, credit = _return_money(h)
    return {
        "wret_web_page_id": _current_id(h(2), "web_page", sf),
        "wret_order_id": order.astype(np.int32),
        "wret_line_number": _uniform(h(3), 1, 16).astype(np.int32),
        "wret_item_id": _current_id(h(4), "item", sf),
        "wret_return_customer_id": _full_id(h(5), "customer", sf),
        "wret_refund_customer_id": _full_id(h(16), "customer", sf),
        "wret_return_date": (_insert_dates(h(6), update) + 1
                             ).astype(np.int32),
        "wret_return_time": _uniform(h(7), 0, 86399).astype(np.int32),
        "wret_return_qty": _uniform(h(8), 1, 50).astype(np.int32),
        "wret_return_amt": amt.astype(np.int64),
        "wret_return_tax": tax.astype(np.int64),
        "wret_return_fee": fee.astype(np.int64),
        "wret_return_ship_cost": ship.astype(np.int64),
        "wret_refunded_cash": refunded.astype(np.int64),
        "wret_reversed_charge": reversed_c.astype(np.int64),
        "wret_account_credit": credit.astype(np.int64),
        "wret_reason_id": _full_id(h(9), "reason", sf),
    }


def _gen_s_inventory(sf: float, update: int):
    n_item = table_rows("item", sf)
    n_wh = table_rows("warehouse", sf)
    n = max(min(n_item * n_wh // 4, 4000), 8)
    idx = np.arange(n, dtype=np.int64)
    h = lambda k: _h(SEED, f"s_inventory#u{update}", k, idx)
    # one refresh snapshot date per update week
    date = np.full(n, _INSERT_BASE + (update - 1) * 7 + 4, dtype=np.int64)
    return {
        "invn_warehouse_id": _full_id(h(1), "warehouse", sf),
        "invn_item_id": _current_id(h(2), "item", sf),
        "invn_date": date.astype(np.int32),
        "invn_qty_on_hand": _uniform(h(3), 0, 1000).astype(np.int32),
    }


def _delete_window(update: int, widen: int = 0):
    start = _BASE_LO + ((update * 89) % max(_BASE_DAYS - 30, 1))
    return start, start + 30 + widen


def _gen_delete(sf: float, update: int):
    d1, d2 = _delete_window(update)
    return {"date1": np.array([d1], dtype=np.int32),
            "date2": np.array([d2], dtype=np.int32)}


def _gen_inventory_delete(sf: float, update: int):
    # inventory snapshots are weekly from the START of the base window
    # and only ~rows/(items*warehouses) weeks exist at small SF, so the
    # window walks the early weeks (and is widened past one week) to
    # guarantee it covers generated snapshots at every scale
    d1 = _BASE_LO + (update - 1) * 21
    return {"date1": np.array([d1], dtype=np.int32),
            "date2": np.array([d1 + 37], dtype=np.int32)}


def gen_refresh_table(table: str, sf: float, update: int = 1
                      ) -> dict[str, np.ndarray]:
    """Refresh arrays for one maintenance table (update >= 1)."""
    if update < 1:
        raise ValueError(f"update must be >= 1, got {update}")
    pairs = {
        "s_purchase": 0, "s_purchase_lineitem": 1,
        "s_catalog_order": 0, "s_catalog_order_lineitem": 1,
        "s_web_order": 0, "s_web_order_lineitem": 1,
    }
    if table in ("s_purchase", "s_purchase_lineitem"):
        return _gen_purchase_pair(sf, update)[pairs[table]]
    if table in ("s_catalog_order", "s_catalog_order_lineitem"):
        return _gen_catalog_pair(sf, update)[pairs[table]]
    if table in ("s_web_order", "s_web_order_lineitem"):
        return _gen_web_pair(sf, update)[pairs[table]]
    fns = {
        "s_store_returns": _gen_s_store_returns,
        "s_catalog_returns": _gen_s_catalog_returns,
        "s_web_returns": _gen_s_web_returns,
        "s_inventory": _gen_s_inventory,
        "delete": _gen_delete,
        "inventory_delete": _gen_inventory_delete,
    }
    fn = fns.get(table)
    if fn is None:
        raise ValueError(f"unknown maintenance table {table!r}")
    return fn(sf, update)
