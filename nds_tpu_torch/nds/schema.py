"""NDS (TPC-DS v3.2) table schemas, engine-typed.

Role of the reference's `nds/nds_schema.py:49-568` (25 source tables as
PySpark StructTypes with a use_decimal toggle, `:43-47`) re-expressed in
engine types: DECIMAL -> scaled int64 (or float64 in floats mode), DATE ->
epoch-day int32, CHAR/VARCHAR -> dictionary codes. Column names/types
follow the public TPC-DS specification (including the spec's own
`s_tax_precentage` spelling); surrogate keys are int32 except the two
documented 64-bit identifiers (ticket/order numbers — reference keeps
them LongType for SF3K+ overflow, `nds/nds_schema.py:328-331`).

PRIMARY_KEYS drive the planner's unique-side join orientation; SIZES are
the dsdgen row-count model used for greedy join ordering.

Port copy of ``nds_tpu/nds/schema.py``: it imports nothing of
``nds_tpu``. ``get_maintenance_schemas`` gives the refresh tables that
``nds/transcode.py --update`` reads.
"""

from __future__ import annotations

from nds_tpu_torch.engine.types import (
    DATE, INT32, INT64, Schema, char, decimal, varchar,
)


def _dec_factory(use_decimal: bool):
    """decimal(p,s) when use_decimal, float64 in the reference's
    --floats mode (`nds/nds_schema.py:43-47`) — one switch shared by the
    source and maintenance schemas."""
    if use_decimal:
        return decimal
    from nds_tpu_torch.engine.types import FLOAT64
    return lambda p, s: FLOAT64


def get_schemas(use_decimal: bool = True) -> dict[str, Schema]:
    """25 source tables. use_decimal=False (the reference's --floats mode)
    swaps decimals for float64."""
    dec = _dec_factory(use_decimal)

    def money():
        return dec(7, 2)

    s: dict[str, Schema] = {}
    s["customer_address"] = Schema.of(
        ("ca_address_sk", INT32), ("ca_address_id", char(16)),
        ("ca_street_number", char(10)), ("ca_street_name", varchar(60)),
        ("ca_street_type", char(15)), ("ca_suite_number", char(10)),
        ("ca_city", varchar(60)), ("ca_county", varchar(30)),
        ("ca_state", char(2)), ("ca_zip", char(10)),
        ("ca_country", varchar(20)), ("ca_gmt_offset", dec(5, 2)),
        ("ca_location_type", char(20)))
    s["customer_demographics"] = Schema.of(
        ("cd_demo_sk", INT32), ("cd_gender", char(1)),
        ("cd_marital_status", char(1)),
        ("cd_education_status", char(20)),
        ("cd_purchase_estimate", INT32), ("cd_credit_rating", char(10)),
        ("cd_dep_count", INT32), ("cd_dep_employed_count", INT32),
        ("cd_dep_college_count", INT32))
    s["date_dim"] = Schema.of(
        ("d_date_sk", INT32), ("d_date_id", char(16)), ("d_date", DATE),
        ("d_month_seq", INT32), ("d_week_seq", INT32),
        ("d_quarter_seq", INT32), ("d_year", INT32), ("d_dow", INT32),
        ("d_moy", INT32), ("d_dom", INT32), ("d_qoy", INT32),
        ("d_fy_year", INT32), ("d_fy_quarter_seq", INT32),
        ("d_fy_week_seq", INT32), ("d_day_name", char(9)),
        ("d_quarter_name", char(6)), ("d_holiday", char(1)),
        ("d_weekend", char(1)), ("d_following_holiday", char(1)),
        ("d_first_dom", INT32), ("d_last_dom", INT32),
        ("d_same_day_ly", INT32), ("d_same_day_lq", INT32),
        ("d_current_day", char(1)), ("d_current_week", char(1)),
        ("d_current_month", char(1)), ("d_current_quarter", char(1)),
        ("d_current_year", char(1)))
    s["warehouse"] = Schema.of(
        ("w_warehouse_sk", INT32), ("w_warehouse_id", char(16)),
        ("w_warehouse_name", varchar(20)), ("w_warehouse_sq_ft", INT32),
        ("w_street_number", char(10)), ("w_street_name", varchar(60)),
        ("w_street_type", char(15)), ("w_suite_number", char(10)),
        ("w_city", varchar(60)), ("w_county", varchar(30)),
        ("w_state", char(2)), ("w_zip", char(10)),
        ("w_country", varchar(20)), ("w_gmt_offset", dec(5, 2)))
    s["ship_mode"] = Schema.of(
        ("sm_ship_mode_sk", INT32), ("sm_ship_mode_id", char(16)),
        ("sm_type", char(30)), ("sm_code", char(10)),
        ("sm_carrier", char(20)), ("sm_contract", char(20)))
    s["time_dim"] = Schema.of(
        ("t_time_sk", INT32), ("t_time_id", char(16)), ("t_time", INT32),
        ("t_hour", INT32), ("t_minute", INT32), ("t_second", INT32),
        ("t_am_pm", char(2)), ("t_shift", char(20)),
        ("t_sub_shift", char(20)), ("t_meal_time", char(20)))
    s["reason"] = Schema.of(
        ("r_reason_sk", INT32), ("r_reason_id", char(16)),
        ("r_reason_desc", char(100)))
    s["income_band"] = Schema.of(
        ("ib_income_band_sk", INT32), ("ib_lower_bound", INT32),
        ("ib_upper_bound", INT32))
    s["item"] = Schema.of(
        ("i_item_sk", INT32), ("i_item_id", char(16)),
        ("i_rec_start_date", DATE), ("i_rec_end_date", DATE),
        ("i_item_desc", varchar(200)), ("i_current_price", money()),
        ("i_wholesale_cost", money()), ("i_brand_id", INT32),
        ("i_brand", char(50)), ("i_class_id", INT32),
        ("i_class", char(50)), ("i_category_id", INT32),
        ("i_category", char(50)), ("i_manufact_id", INT32),
        ("i_manufact", char(50)), ("i_size", char(20)),
        ("i_formulation", char(20)), ("i_color", char(20)),
        ("i_units", char(10)), ("i_container", char(10)),
        ("i_manager_id", INT32), ("i_product_name", char(50)))
    s["store"] = Schema.of(
        ("s_store_sk", INT32), ("s_store_id", char(16)),
        ("s_rec_start_date", DATE), ("s_rec_end_date", DATE),
        ("s_closed_date_sk", INT32), ("s_store_name", varchar(50)),
        ("s_number_employees", INT32), ("s_floor_space", INT32),
        ("s_hours", char(20)), ("s_manager", varchar(40)),
        ("s_market_id", INT32), ("s_geography_class", varchar(100)),
        ("s_market_desc", varchar(100)),
        ("s_market_manager", varchar(40)), ("s_division_id", INT32),
        ("s_division_name", varchar(50)), ("s_company_id", INT32),
        ("s_company_name", varchar(50)),
        ("s_street_number", varchar(10)),
        ("s_street_name", varchar(60)), ("s_street_type", char(15)),
        ("s_suite_number", char(10)), ("s_city", varchar(60)),
        ("s_county", varchar(30)), ("s_state", char(2)),
        ("s_zip", char(10)), ("s_country", varchar(20)),
        ("s_gmt_offset", dec(5, 2)),
        ("s_tax_precentage", dec(5, 2)))  # spec's own spelling
    s["call_center"] = Schema.of(
        ("cc_call_center_sk", INT32), ("cc_call_center_id", char(16)),
        ("cc_rec_start_date", DATE), ("cc_rec_end_date", DATE),
        ("cc_closed_date_sk", INT32), ("cc_open_date_sk", INT32),
        ("cc_name", varchar(50)), ("cc_class", varchar(50)),
        ("cc_employees", INT32), ("cc_sq_ft", INT32),
        ("cc_hours", char(20)), ("cc_manager", varchar(40)),
        ("cc_mkt_id", INT32), ("cc_mkt_class", char(50)),
        ("cc_mkt_desc", varchar(100)),
        ("cc_market_manager", varchar(40)), ("cc_division", INT32),
        ("cc_division_name", varchar(50)), ("cc_company", INT32),
        ("cc_company_name", char(50)), ("cc_street_number", char(10)),
        ("cc_street_name", varchar(60)), ("cc_street_type", char(15)),
        ("cc_suite_number", char(10)), ("cc_city", varchar(60)),
        ("cc_county", varchar(30)), ("cc_state", char(2)),
        ("cc_zip", char(10)), ("cc_country", varchar(20)),
        ("cc_gmt_offset", dec(5, 2)), ("cc_tax_percentage", dec(5, 2)))
    s["customer"] = Schema.of(
        ("c_customer_sk", INT32), ("c_customer_id", char(16)),
        ("c_current_cdemo_sk", INT32), ("c_current_hdemo_sk", INT32),
        ("c_current_addr_sk", INT32), ("c_first_shipto_date_sk", INT32),
        ("c_first_sales_date_sk", INT32), ("c_salutation", char(10)),
        ("c_first_name", char(20)), ("c_last_name", char(30)),
        ("c_preferred_cust_flag", char(1)), ("c_birth_day", INT32),
        ("c_birth_month", INT32), ("c_birth_year", INT32),
        ("c_birth_country", varchar(20)), ("c_login", char(13)),
        ("c_email_address", char(50)), ("c_last_review_date_sk", INT32))
    s["web_site"] = Schema.of(
        ("web_site_sk", INT32), ("web_site_id", char(16)),
        ("web_rec_start_date", DATE), ("web_rec_end_date", DATE),
        ("web_name", varchar(50)), ("web_open_date_sk", INT32),
        ("web_close_date_sk", INT32), ("web_class", varchar(50)),
        ("web_manager", varchar(40)), ("web_mkt_id", INT32),
        ("web_mkt_class", varchar(50)), ("web_mkt_desc", varchar(100)),
        ("web_market_manager", varchar(40)), ("web_company_id", INT32),
        ("web_company_name", char(50)), ("web_street_number", char(10)),
        ("web_street_name", varchar(60)), ("web_street_type", char(15)),
        ("web_suite_number", char(10)), ("web_city", varchar(60)),
        ("web_county", varchar(30)), ("web_state", char(2)),
        ("web_zip", char(10)), ("web_country", varchar(20)),
        ("web_gmt_offset", dec(5, 2)),
        ("web_tax_percentage", dec(5, 2)))
    s["store_returns"] = Schema.of(
        ("sr_returned_date_sk", INT32), ("sr_return_time_sk", INT32),
        ("sr_item_sk", INT32), ("sr_customer_sk", INT32),
        ("sr_cdemo_sk", INT32), ("sr_hdemo_sk", INT32),
        ("sr_addr_sk", INT32), ("sr_store_sk", INT32),
        ("sr_reason_sk", INT32),
        ("sr_ticket_number", INT64),  # 64-bit identifier
        ("sr_return_quantity", INT32), ("sr_return_amt", money()),
        ("sr_return_tax", money()), ("sr_return_amt_inc_tax", money()),
        ("sr_fee", money()), ("sr_return_ship_cost", money()),
        ("sr_refunded_cash", money()), ("sr_reversed_charge", money()),
        ("sr_store_credit", money()), ("sr_net_loss", money()))
    s["household_demographics"] = Schema.of(
        ("hd_demo_sk", INT32), ("hd_income_band_sk", INT32),
        ("hd_buy_potential", char(15)), ("hd_dep_count", INT32),
        ("hd_vehicle_count", INT32))
    s["web_page"] = Schema.of(
        ("wp_web_page_sk", INT32), ("wp_web_page_id", char(16)),
        ("wp_rec_start_date", DATE), ("wp_rec_end_date", DATE),
        ("wp_creation_date_sk", INT32), ("wp_access_date_sk", INT32),
        ("wp_autogen_flag", char(1)), ("wp_customer_sk", INT32),
        ("wp_url", varchar(100)), ("wp_type", char(50)),
        ("wp_char_count", INT32), ("wp_link_count", INT32),
        ("wp_image_count", INT32), ("wp_max_ad_count", INT32))
    s["promotion"] = Schema.of(
        ("p_promo_sk", INT32), ("p_promo_id", char(16)),
        ("p_start_date_sk", INT32), ("p_end_date_sk", INT32),
        ("p_item_sk", INT32), ("p_cost", dec(15, 2)),
        ("p_response_target", INT32), ("p_promo_name", char(50)),
        ("p_channel_dmail", char(1)), ("p_channel_email", char(1)),
        ("p_channel_catalog", char(1)), ("p_channel_tv", char(1)),
        ("p_channel_radio", char(1)), ("p_channel_press", char(1)),
        ("p_channel_event", char(1)), ("p_channel_demo", char(1)),
        ("p_channel_details", varchar(100)), ("p_purpose", char(15)),
        ("p_discount_active", char(1)))
    s["catalog_page"] = Schema.of(
        ("cp_catalog_page_sk", INT32), ("cp_catalog_page_id", char(16)),
        ("cp_start_date_sk", INT32), ("cp_end_date_sk", INT32),
        ("cp_department", varchar(50)), ("cp_catalog_number", INT32),
        ("cp_catalog_page_number", INT32),
        ("cp_description", varchar(100)), ("cp_type", varchar(100)))
    s["inventory"] = Schema.of(
        ("inv_date_sk", INT32), ("inv_item_sk", INT32),
        ("inv_warehouse_sk", INT32), ("inv_quantity_on_hand", INT32))
    s["catalog_returns"] = Schema.of(
        ("cr_returned_date_sk", INT32), ("cr_returned_time_sk", INT32),
        ("cr_item_sk", INT32), ("cr_refunded_customer_sk", INT32),
        ("cr_refunded_cdemo_sk", INT32), ("cr_refunded_hdemo_sk", INT32),
        ("cr_refunded_addr_sk", INT32),
        ("cr_returning_customer_sk", INT32),
        ("cr_returning_cdemo_sk", INT32),
        ("cr_returning_hdemo_sk", INT32),
        ("cr_returning_addr_sk", INT32), ("cr_call_center_sk", INT32),
        ("cr_catalog_page_sk", INT32), ("cr_ship_mode_sk", INT32),
        ("cr_warehouse_sk", INT32), ("cr_reason_sk", INT32),
        ("cr_order_number", INT64), ("cr_return_quantity", INT32),
        ("cr_return_amount", money()), ("cr_return_tax", money()),
        ("cr_return_amt_inc_tax", money()), ("cr_fee", money()),
        ("cr_return_ship_cost", money()), ("cr_refunded_cash", money()),
        ("cr_reversed_charge", money()), ("cr_store_credit", money()),
        ("cr_net_loss", money()))
    s["web_returns"] = Schema.of(
        ("wr_returned_date_sk", INT32), ("wr_returned_time_sk", INT32),
        ("wr_item_sk", INT32), ("wr_refunded_customer_sk", INT32),
        ("wr_refunded_cdemo_sk", INT32), ("wr_refunded_hdemo_sk", INT32),
        ("wr_refunded_addr_sk", INT32),
        ("wr_returning_customer_sk", INT32),
        ("wr_returning_cdemo_sk", INT32),
        ("wr_returning_hdemo_sk", INT32),
        ("wr_returning_addr_sk", INT32), ("wr_web_page_sk", INT32),
        ("wr_reason_sk", INT32), ("wr_order_number", INT64),
        ("wr_return_quantity", INT32), ("wr_return_amt", money()),
        ("wr_return_tax", money()), ("wr_return_amt_inc_tax", money()),
        ("wr_fee", money()), ("wr_return_ship_cost", money()),
        ("wr_refunded_cash", money()), ("wr_reversed_charge", money()),
        ("wr_account_credit", money()), ("wr_net_loss", money()))
    s["web_sales"] = Schema.of(
        ("ws_sold_date_sk", INT32), ("ws_sold_time_sk", INT32),
        ("ws_ship_date_sk", INT32), ("ws_item_sk", INT32),
        ("ws_bill_customer_sk", INT32), ("ws_bill_cdemo_sk", INT32),
        ("ws_bill_hdemo_sk", INT32), ("ws_bill_addr_sk", INT32),
        ("ws_ship_customer_sk", INT32), ("ws_ship_cdemo_sk", INT32),
        ("ws_ship_hdemo_sk", INT32), ("ws_ship_addr_sk", INT32),
        ("ws_web_page_sk", INT32), ("ws_web_site_sk", INT32),
        ("ws_ship_mode_sk", INT32), ("ws_warehouse_sk", INT32),
        ("ws_promo_sk", INT32), ("ws_order_number", INT64),
        ("ws_quantity", INT32), ("ws_wholesale_cost", money()),
        ("ws_list_price", money()), ("ws_sales_price", money()),
        ("ws_ext_discount_amt", money()),
        ("ws_ext_sales_price", money()),
        ("ws_ext_wholesale_cost", money()),
        ("ws_ext_list_price", money()), ("ws_ext_tax", money()),
        ("ws_coupon_amt", money()), ("ws_ext_ship_cost", money()),
        ("ws_net_paid", money()), ("ws_net_paid_inc_tax", money()),
        ("ws_net_paid_inc_ship", money()),
        ("ws_net_paid_inc_ship_tax", money()),
        ("ws_net_profit", money()))
    s["catalog_sales"] = Schema.of(
        ("cs_sold_date_sk", INT32), ("cs_sold_time_sk", INT32),
        ("cs_ship_date_sk", INT32), ("cs_bill_customer_sk", INT32),
        ("cs_bill_cdemo_sk", INT32), ("cs_bill_hdemo_sk", INT32),
        ("cs_bill_addr_sk", INT32), ("cs_ship_customer_sk", INT32),
        ("cs_ship_cdemo_sk", INT32), ("cs_ship_hdemo_sk", INT32),
        ("cs_ship_addr_sk", INT32), ("cs_call_center_sk", INT32),
        ("cs_catalog_page_sk", INT32), ("cs_ship_mode_sk", INT32),
        ("cs_warehouse_sk", INT32), ("cs_item_sk", INT32),
        ("cs_promo_sk", INT32), ("cs_order_number", INT64),
        ("cs_quantity", INT32), ("cs_wholesale_cost", money()),
        ("cs_list_price", money()), ("cs_sales_price", money()),
        ("cs_ext_discount_amt", money()),
        ("cs_ext_sales_price", money()),
        ("cs_ext_wholesale_cost", money()),
        ("cs_ext_list_price", money()), ("cs_ext_tax", money()),
        ("cs_coupon_amt", money()), ("cs_ext_ship_cost", money()),
        ("cs_net_paid", money()), ("cs_net_paid_inc_tax", money()),
        ("cs_net_paid_inc_ship", money()),
        ("cs_net_paid_inc_ship_tax", money()),
        ("cs_net_profit", money()))
    s["store_sales"] = Schema.of(
        ("ss_sold_date_sk", INT32), ("ss_sold_time_sk", INT32),
        ("ss_item_sk", INT32), ("ss_customer_sk", INT32),
        ("ss_cdemo_sk", INT32), ("ss_hdemo_sk", INT32),
        ("ss_addr_sk", INT32), ("ss_store_sk", INT32),
        ("ss_promo_sk", INT32), ("ss_ticket_number", INT64),
        ("ss_quantity", INT32), ("ss_wholesale_cost", money()),
        ("ss_list_price", money()), ("ss_sales_price", money()),
        ("ss_ext_discount_amt", money()),
        ("ss_ext_sales_price", money()),
        ("ss_ext_wholesale_cost", money()),
        ("ss_ext_list_price", money()), ("ss_ext_tax", money()),
        ("ss_coupon_amt", money()), ("ss_net_paid", money()),
        ("ss_net_paid_inc_tax", money()), ("ss_net_profit", money()))
    return s





def get_maintenance_schemas(use_decimal: bool = True) -> dict[str, Schema]:
    """The 12 refresh/staging tables feeding data maintenance
    (role of `nds/nds_schema.py:570-716`, columns per the public TPC-DS
    spec's s_* source schemas). Staging rows carry business IDs (char),
    not surrogate keys — the LF_* refresh functions join them back to
    dimensions. Dates that the refresh SQL compares against date_dim are
    engine DATE (epoch days) rather than char(10): the builtin generator
    owns the raw format, so the reference's ``cast(char as date)`` hop
    is unnecessary here."""
    dec = _dec_factory(use_decimal)

    def money():
        return dec(7, 2)

    s: dict[str, Schema] = {}
    s["s_purchase_lineitem"] = Schema.of(
        ("plin_purchase_id", INT32, False),
        ("plin_line_number", INT32, False),
        ("plin_item_id", char(16)), ("plin_promotion_id", char(16)),
        ("plin_quantity", INT32), ("plin_sale_price", money()),
        ("plin_coupon_amt", money()), ("plin_comment", varchar(100)))
    s["s_purchase"] = Schema.of(
        ("purc_purchase_id", INT32, False), ("purc_store_id", char(16)),
        ("purc_customer_id", char(16)), ("purc_purchase_date", DATE),
        ("purc_purchase_time", INT32), ("purc_register_id", INT32),
        ("purc_clerk_id", INT32), ("purc_comment", char(100)))
    s["s_catalog_order"] = Schema.of(
        ("cord_order_id", INT32, False),
        ("cord_bill_customer_id", char(16)),
        ("cord_ship_customer_id", char(16)),
        ("cord_order_date", DATE), ("cord_order_time", INT32),
        ("cord_ship_mode_id", char(16)),
        ("cord_call_center_id", char(16)),
        ("cord_order_comments", varchar(100)))
    s["s_web_order"] = Schema.of(
        ("word_order_id", INT32, False),
        ("word_bill_customer_id", char(16)),
        ("word_ship_customer_id", char(16)),
        ("word_order_date", DATE), ("word_order_time", INT32),
        ("word_ship_mode_id", char(16)), ("word_web_site_id", char(16)),
        ("word_order_comments", char(100)))
    s["s_catalog_order_lineitem"] = Schema.of(
        ("clin_order_id", INT32, False), ("clin_line_number", INT32, False),
        ("clin_item_id", char(16)), ("clin_promotion_id", char(16)),
        ("clin_quantity", INT32), ("clin_sales_price", money()),
        ("clin_coupon_amt", money()), ("clin_warehouse_id", char(16)),
        ("clin_ship_date", DATE), ("clin_catalog_number", INT32),
        ("clin_catalog_page_number", INT32), ("clin_ship_cost", money()))
    s["s_web_order_lineitem"] = Schema.of(
        ("wlin_order_id", INT32, False), ("wlin_line_number", INT32, False),
        ("wlin_item_id", char(16)), ("wlin_promotion_id", char(16)),
        ("wlin_quantity", INT32), ("wlin_sales_price", money()),
        ("wlin_coupon_amt", money()), ("wlin_warehouse_id", char(16)),
        ("wlin_ship_date", DATE), ("wlin_ship_cost", money()),
        ("wlin_web_page_id", char(16)))
    s["s_store_returns"] = Schema.of(
        ("sret_store_id", char(16)), ("sret_purchase_id", char(16), False),
        ("sret_line_number", INT32, False),
        ("sret_item_id", char(16), False),
        ("sret_customer_id", char(16)), ("sret_return_date", DATE),
        ("sret_return_time", INT32), ("sret_ticket_number", INT64),
        ("sret_return_qty", INT32), ("sret_return_amt", money()),
        ("sret_return_tax", money()), ("sret_return_fee", money()),
        ("sret_return_ship_cost", money()), ("sret_refunded_cash", money()),
        ("sret_reversed_charge", money()), ("sret_store_credit", money()),
        ("sret_reason_id", char(16)))
    s["s_catalog_returns"] = Schema.of(
        ("cret_call_center_id", char(16)), ("cret_order_id", INT32, False),
        ("cret_line_number", INT32, False),
        ("cret_item_id", char(16), False),
        ("cret_return_customer_id", char(16)),
        ("cret_refund_customer_id", char(16)),
        ("cret_return_date", DATE), ("cret_return_time", INT32),
        ("cret_return_qty", INT32), ("cret_return_amt", money()),
        ("cret_return_tax", money()), ("cret_return_fee", money()),
        ("cret_return_ship_cost", money()), ("cret_refunded_cash", money()),
        ("cret_reversed_charge", money()),
        ("cret_merchant_credit", money()), ("cret_reason_id", char(16)),
        ("cret_shipmode_id", char(16)), ("cret_catalog_page_id", char(16)),
        ("cret_warehouse_id", char(16)))
    s["s_web_returns"] = Schema.of(
        ("wret_web_page_id", char(16)), ("wret_order_id", INT32, False),
        ("wret_line_number", INT32, False),
        ("wret_item_id", char(16), False),
        ("wret_return_customer_id", char(16)),
        ("wret_refund_customer_id", char(16)),
        ("wret_return_date", DATE), ("wret_return_time", INT32),
        ("wret_return_qty", INT32), ("wret_return_amt", money()),
        ("wret_return_tax", money()), ("wret_return_fee", money()),
        ("wret_return_ship_cost", money()), ("wret_refunded_cash", money()),
        ("wret_reversed_charge", money()), ("wret_account_credit", money()),
        ("wret_reason_id", char(16)))
    s["s_inventory"] = Schema.of(
        ("invn_warehouse_id", char(16), False),
        ("invn_item_id", char(16), False),
        ("invn_date", DATE, False), ("invn_qty_on_hand", INT32))
    s["delete"] = Schema.of(
        ("date1", DATE, False), ("date2", DATE, False))
    s["inventory_delete"] = Schema.of(
        ("date1", DATE, False), ("date2", DATE, False))
    return s


PRIMARY_KEYS: dict[str, tuple] = {
    "customer_address": ("ca_address_sk",),
    "customer_demographics": ("cd_demo_sk",),
    "date_dim": ("d_date_sk",),
    "warehouse": ("w_warehouse_sk",),
    "ship_mode": ("sm_ship_mode_sk",),
    "time_dim": ("t_time_sk",),
    "reason": ("r_reason_sk",),
    "income_band": ("ib_income_band_sk",),
    "item": ("i_item_sk",),
    "store": ("s_store_sk",),
    "call_center": ("cc_call_center_sk",),
    "customer": ("c_customer_sk",),
    "web_site": ("web_site_sk",),
    "store_returns": ("sr_item_sk", "sr_ticket_number"),
    "household_demographics": ("hd_demo_sk",),
    "web_page": ("wp_web_page_sk",),
    "promotion": ("p_promo_sk",),
    "catalog_page": ("cp_catalog_page_sk",),
    "inventory": ("inv_date_sk", "inv_item_sk", "inv_warehouse_sk"),
    "catalog_returns": ("cr_item_sk", "cr_order_number"),
    "web_returns": ("wr_item_sk", "wr_order_number"),
    "web_sales": ("ws_item_sk", "ws_order_number"),
    "catalog_sales": ("cs_item_sk", "cs_order_number"),
    "store_sales": ("ss_item_sk", "ss_ticket_number"),
}


def table_rows(table: str, sf: float) -> int:
    """dsdgen's row-count scaling model (public spec table 3-2 shapes;
    linear for facts, stepped for dimensions — approximated log-linear
    the way dsdgen scales between published SF points)."""
    import math
    sf = max(sf, 0.01)
    lin = {
        "store_sales": 2_880_404, "store_returns": 287_514,
        "catalog_sales": 1_441_548, "catalog_returns": 144_067,
        "web_sales": 719_384, "web_returns": 71_763,
        "inventory": 11_745_000,
    }
    if table in lin:
        return max(int(lin[table] * sf), 100)
    fixed = {
        "date_dim": 73049, "time_dim": 86400, "ship_mode": 20,
        "income_band": 20, "reason": 35 if sf >= 1 else 35,
    }
    if table in fixed:
        return fixed[table]
    # stepped dimensions: value at SF1 scaled ~ sf^0.5 (dsdgen steps are
    # coarser; sqrt keeps FK densities workable at sub-SF1 test scales)
    sf1 = {
        "customer": 100_000, "customer_address": 50_000,
        "customer_demographics": 1_920_800, "household_demographics": 7200,
        "item": 18_000, "store": 12, "call_center": 6, "web_site": 30,
        "web_page": 60, "promotion": 300, "catalog_page": 11_718,
        "warehouse": 5,
    }
    if table in ("customer_demographics", "household_demographics"):
        return sf1[table]  # fixed cross-product tables
    n = sf1[table]
    if sf >= 1:
        return int(n * max(1.0, math.log2(sf) if table != "customer"
                           else sf ** 0.5))
    return max(int(n * sf ** 0.5), 6)


SIZES = {t: table_rows(t, 1) for t in [
    "store_sales", "store_returns", "catalog_sales", "catalog_returns",
    "web_sales", "web_returns", "inventory", "customer",
    "customer_address", "customer_demographics",
    "household_demographics", "item", "store", "call_center", "web_site",
    "web_page", "promotion", "catalog_page", "warehouse", "date_dim",
    "time_dim", "ship_mode", "income_band", "reason"]}
