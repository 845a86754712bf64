"""NDS-H (TPC-H v3.0.1-derived) table schemas.

Port copy of ``nds_tpu/nds_h/schema.py``: it imports nothing of ``nds_tpu``.

Engine-native equivalent of the reference's PySpark StructType schemas
(`nds-h/nds_h_schema.py:36-148`): 8 tables, money columns DECIMAL(11,2) as
in the reference. The reference appends a trailing ``ignore`` column per
table to swallow dbgen's trailing '|' (`nds-h/nds_h_schema.py:50-61`); here
that is a CSV-reader option (``trailing_delimiter=True``) instead of a
schema entry, so schemas stay semantically clean.

Key domains follow TPC-H: all *key columns are int64 identifiers.
"""

from __future__ import annotations

from nds_tpu_torch.engine.types import (
    DATE, INT32, INT64, Schema, char, decimal, varchar,
)

MONEY = decimal(11, 2)

# Primary keys per table (used by the engine to pick searchsorted PK-FK
# join strategies and by the maintenance/validation layers).
PRIMARY_KEYS = {
    "customer": ["c_custkey"],
    "lineitem": ["l_orderkey", "l_linenumber"],
    "nation": ["n_nationkey"],
    "orders": ["o_orderkey"],
    "part": ["p_partkey"],
    "partsupp": ["ps_partkey", "ps_suppkey"],
    "region": ["r_regionkey"],
    "supplier": ["s_suppkey"],
}


def get_schemas() -> dict[str, Schema]:
    """All 8 TPC-H table schemas, keyed by table name."""
    return {
        "customer": Schema.of(
            ("c_custkey", INT64, False),
            ("c_name", varchar(25), False),
            ("c_address", varchar(40), False),
            ("c_nationkey", INT64, False),
            ("c_phone", char(15), False),
            ("c_acctbal", MONEY, False),
            ("c_mktsegment", char(10), False),
            ("c_comment", varchar(117), False),
        ),
        "lineitem": Schema.of(
            ("l_orderkey", INT64, False),
            ("l_partkey", INT64, False),
            ("l_suppkey", INT64, False),
            ("l_linenumber", INT32, False),
            ("l_quantity", MONEY, False),
            ("l_extendedprice", MONEY, False),
            ("l_discount", MONEY, False),
            ("l_tax", MONEY, False),
            ("l_returnflag", char(1), False),
            ("l_linestatus", char(1), False),
            ("l_shipdate", DATE, False),
            ("l_commitdate", DATE, False),
            ("l_receiptdate", DATE, False),
            ("l_shipinstruct", char(25), False),
            ("l_shipmode", char(10), False),
            ("l_comment", varchar(44), False),
        ),
        "nation": Schema.of(
            ("n_nationkey", INT64, False),
            ("n_name", char(25), False),
            ("n_regionkey", INT64, False),
            ("n_comment", varchar(152), False),
        ),
        "orders": Schema.of(
            ("o_orderkey", INT64, False),
            ("o_custkey", INT64, False),
            ("o_orderstatus", char(1), False),
            ("o_totalprice", MONEY, False),
            ("o_orderdate", DATE, False),
            ("o_orderpriority", char(15), False),
            ("o_clerk", char(15), False),
            ("o_shippriority", INT32, False),
            ("o_comment", varchar(79), False),
        ),
        "part": Schema.of(
            ("p_partkey", INT64, False),
            ("p_name", varchar(55), False),
            ("p_mfgr", char(25), False),
            ("p_brand", char(10), False),
            ("p_type", varchar(25), False),
            ("p_size", INT32, False),
            ("p_container", char(10), False),
            ("p_retailprice", MONEY, False),
            ("p_comment", varchar(23), False),
        ),
        "partsupp": Schema.of(
            ("ps_partkey", INT64, False),
            ("ps_suppkey", INT64, False),
            ("ps_availqty", INT32, False),
            ("ps_supplycost", MONEY, False),
            ("ps_comment", varchar(199), False),
        ),
        "region": Schema.of(
            ("r_regionkey", INT64, False),
            ("r_name", char(25), False),
            ("r_comment", varchar(152), False),
        ),
        "supplier": Schema.of(
            ("s_suppkey", INT64, False),
            ("s_name", char(25), False),
            ("s_address", varchar(40), False),
            ("s_nationkey", INT64, False),
            ("s_phone", char(15), False),
            ("s_acctbal", MONEY, False),
            ("s_comment", varchar(101), False),
        ),
    }


TABLE_NAMES = sorted(get_schemas().keys())
