"""Built-in deterministic TPC-H-like data generator.

Port copy of ``nds_tpu/datagen/tpch.py``: it imports nothing of ``nds_tpu``.

The reference shells out to the TPC-licensed ``dbgen`` tool, downloaded by
the user and patched at build time (`nds-h/nds_h_gen_data.py:90-115`,
`nds-h/tpch-gen/Makefile`). Those tools stay external here too (see
``nds_tpu.datagen.toolwrap``); this module additionally provides what the
reference cannot ship: a hermetic, pure-numpy generator with TPC-H's
documented value distributions (TPC-H v3 spec §4.2, public), so the suite
can be tested and benchmarked end-to-end with zero external downloads.

Chunked generation mirrors dbgen's ``-C parallel -S step`` contract
(`nds-h/nds_h_gen_data.py:90-95`): ``gen_table(table, sf, parallel, step)``
produces exactly the rows of that chunk, deterministically — per-chunk
seeds derive from (seed, table, step) so chunks can be generated on any
host in any order (the reference achieves this with one Hadoop mapper per
chunk, `nds-h/tpch-gen/.../GenTable.java:209-277`; here any process/host
fan-out works).

Correlations the queries depend on are honored:
- l_extendedprice = l_quantity * retailprice(l_partkey) (spec formula);
- o_custkey % 3 != 0, leaving 1/3 of customers order-less (q13/q22);
- l_returnflag/l_linestatus derive from receipt/ship dates vs 1995-06-17;
- o_orderstatus derives from its lineitems' linestatus;
- comments occasionally embed 'special ... requests' (q13) and
  'Customer ... Complaints' (q16) phrases.
"""

from __future__ import annotations

import hashlib

import numpy as np

# --- fixed small tables (public TPC-H spec §4.2.3) -------------------------

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]

# (nation name, region index) in nationkey order 0..24
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
INSTRUCTIONS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONT_S1 = ["SM", "MED", "LG", "JUMBO", "WRAP"]
CONT_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
COLORS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished",
    "chartreuse", "chiffon", "chocolate", "coral", "cornflower", "cornsilk",
    "cream", "cyan", "dark", "deep", "dim", "dodger", "drab", "firebrick",
    "floral", "forest", "frosted", "gainsboro", "ghost", "goldenrod",
    "green", "grey", "honeydew", "hot", "hazel", "indian", "ivory", "khaki",
    "lace", "lavender", "lawn", "lemon", "light", "lime", "linen", "magenta",
    "maroon", "medium", "metallic", "midnight", "mint", "misty", "moccasin",
    "navajo", "navy", "olive", "orange", "orchid", "pale", "papaya", "peach",
    "peru", "pink", "plum", "powder", "puff", "purple", "red", "rose",
    "rosy", "royal", "saddle", "salmon", "sandy", "seashell", "sienna",
    "sky", "slate", "smoke", "snow", "spring", "steel", "tan", "thistle",
    "tomato", "turquoise", "violet", "wheat", "white", "yellow",
]
_WORDS = [
    "furiously", "quickly", "carefully", "blithely", "slyly", "ideas",
    "deposits", "accounts", "packages", "foxes", "pinto", "beans",
    "requests", "instructions", "theodolites", "dependencies", "platelets",
    "excuses", "asymptotes", "somas", "final", "regular", "express", "bold",
    "even", "silent", "pending", "ironic", "dogged", "sleep", "wake",
    "haggle", "nag", "among", "above", "along", "after", "across",
]

# epoch-day helpers ---------------------------------------------------------

_EPOCH = np.datetime64("1970-01-01", "D")


def days(iso: str) -> int:
    """ISO date -> int32 days since epoch."""
    return int((np.datetime64(iso, "D") - _EPOCH).astype(np.int64))

STARTDATE = days("1992-01-01")          # spec: O_ORDERDATE uniform range
ENDDATE_ORDERS = days("1998-08-02")     # STARTDATE .. ENDDATE-151
CURRENTDATE_SPLIT = days("1995-06-17")  # returnflag/linestatus split


def _rng(seed: int, table: str, step: int) -> np.random.Generator:
    h = hashlib.sha256(f"{seed}:{table}:{step}".encode()).digest()
    return np.random.Generator(np.random.Philox(int.from_bytes(h[:8], "little")))


def _chunk_range(total: int, parallel: int, step: int) -> tuple[int, int]:
    """Row range [start, end) for 1-based chunk ``step`` of ``parallel``."""
    if not 1 <= step <= parallel:
        raise ValueError(f"step {step} not in [1, {parallel}]")
    base, rem = divmod(total, parallel)
    start = (step - 1) * base + min(step - 1, rem)
    end = start + base + (1 if step <= rem else 0)
    return start, end


def retailprice_cents(partkey: np.ndarray) -> np.ndarray:
    """Spec formula: (90000 + ((partkey/10) mod 20001) + 100*(partkey mod 1000))."""
    pk = partkey.astype(np.int64)
    return 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)


def _comments(rng: np.random.Generator, n: int, nwords: int,
              phrase: tuple[str, str] | None = None,
              phrase_prob: float = 0.0) -> np.ndarray:
    """Random word-salad comments, optionally embedding 'A ... B' phrases."""
    idx = rng.integers(0, len(_WORDS), size=(n, nwords))
    words = np.array(_WORDS, dtype=object)[idx]
    out = np.array([" ".join(row) for row in words], dtype=object)
    if phrase is not None and phrase_prob > 0:
        hit = rng.random(n) < phrase_prob
        if hit.any():
            mid = np.array(_WORDS, dtype=object)[rng.integers(0, len(_WORDS), hit.sum())]
            out[hit] = [f"{phrase[0]} {m} {phrase[1]}" for m in mid]
    return out


def _phones(rng: np.random.Generator, nationkey: np.ndarray) -> np.ndarray:
    n = len(nationkey)
    a = rng.integers(100, 1000, n)
    b = rng.integers(100, 1000, n)
    c = rng.integers(1000, 10000, n)
    cc = nationkey + 10
    return np.array([f"{cc[i]}-{a[i]}-{b[i]}-{c[i]}" for i in range(n)], dtype=object)


# --- per-table row counts (spec §4.2.5) ------------------------------------

def table_rows(table: str, sf: float) -> int:
    base = {
        "customer": 150_000,
        "orders": 1_500_000,
        "part": 200_000,
        "partsupp": 800_000,
        "supplier": 10_000,
    }
    if table == "nation":
        return 25
    if table == "region":
        return 5
    if table == "lineitem":
        # lineitem rows derive from orders (1-7 lines each); callers get the
        # actual count from gen_table. This is the spec's nominal estimate.
        return int(6_000_000 * sf)
    if table not in base:
        raise KeyError(table)
    # floor supplier at 4 so the partsupp 4-supplier spread keeps distinct
    # (ps_partkey, ps_suppkey) primary keys at degenerate scale factors
    floor = 4 if table == "supplier" else 1
    return max(floor, int(base[table] * sf))


def num_customers(sf: float) -> int:
    return table_rows("customer", sf)


# --- order-side deterministic attributes -----------------------------------

def _order_attrs(seed: int, sf: float, o_start: int, o_end: int):
    """Order attributes for order indices [o_start, o_end) (0-based).

    Deterministic in the order index regardless of chunking, so lineitem
    chunks can re-derive their parent orders' dates and line counts.
    """
    # Per-order randomness comes from splitmix-style integer hashing of the
    # order index (vectorized, reproducible for any slice), not a sequential
    # RNG, so any chunk can derive any order's attributes independently.
    idx = np.arange(o_start, o_end, dtype=np.uint64)

    def h(k: int) -> np.ndarray:
        x = idx + np.uint64((k * 0x9E3779B97F4A7C15) % (1 << 64)) + np.uint64(seed)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))

    ncust = num_customers(sf)
    # ENDDATE_ORDERS is already ENDDATE-151 (latest date leaving room for
    # ship/receipt offsets), so the modulus spans the full order-date range.
    orderdate = STARTDATE + (h(1) % np.uint64(ENDDATE_ORDERS - STARTDATE + 1)).astype(np.int32)
    nlines = 1 + (h(2) % np.uint64(7)).astype(np.int32)
    custkey = 1 + (h(3) % np.uint64(ncust)).astype(np.int64)
    # spec: custkey % 3 != 0 -> shift offenders to a neighbor (never 0)
    bad = custkey % 3 == 0
    custkey = np.where(bad, np.maximum(custkey - 1, 1), custkey)
    custkey = np.where(custkey % 3 == 0, custkey + 1, custkey)
    return orderdate, nlines, custkey, h


def gen_table(table: str, sf: float, parallel: int = 1, step: int = 1,
              seed: int = 0) -> dict[str, np.ndarray]:
    """Generate one chunk of one table as {column: numpy array}.

    Dates are int32 epoch days; decimals are int64 cents-style scaled ints
    (scale matches the schema, i.e. value * 100); strings are object arrays.
    """
    if table == "region":
        rng = _rng(seed, table, step)
        if step != 1:
            return {k: v[:0] for k, v in gen_table("region", sf, 1, 1, seed).items()}
        return {
            "r_regionkey": np.arange(5, dtype=np.int64),
            "r_name": np.array(REGIONS, dtype=object),
            "r_comment": _comments(rng, 5, 8),
        }
    if table == "nation":
        rng = _rng(seed, table, step)
        if step != 1:
            return {k: v[:0] for k, v in gen_table("nation", sf, 1, 1, seed).items()}
        return {
            "n_nationkey": np.arange(25, dtype=np.int64),
            "n_name": np.array([n for n, _ in NATIONS], dtype=object),
            "n_regionkey": np.array([r for _, r in NATIONS], dtype=np.int64),
            "n_comment": _comments(rng, 25, 10),
        }

    if table == "supplier":
        total = table_rows(table, sf)
        start, end = _chunk_range(total, parallel, step)
        n = end - start
        rng = _rng(seed, table, step)
        suppkey = np.arange(start + 1, end + 1, dtype=np.int64)
        nationkey = rng.integers(0, 25, n).astype(np.int64)
        return {
            "s_suppkey": suppkey,
            "s_name": np.array([f"Supplier#{k:09d}" for k in suppkey], dtype=object),
            "s_address": _comments(rng, n, 3),
            "s_nationkey": nationkey,
            "s_phone": _phones(rng, nationkey),
            "s_acctbal": rng.integers(-99999, 999999, n).astype(np.int64),
            # q16: ~0.05% of suppliers carry 'Customer ... Complaints'
            "s_comment": _comments(rng, n, 10, ("Customer", "Complaints"), 0.005),
        }

    if table == "customer":
        total = table_rows(table, sf)
        start, end = _chunk_range(total, parallel, step)
        n = end - start
        rng = _rng(seed, table, step)
        custkey = np.arange(start + 1, end + 1, dtype=np.int64)
        nationkey = rng.integers(0, 25, n).astype(np.int64)
        return {
            "c_custkey": custkey,
            "c_name": np.array([f"Customer#{k:09d}" for k in custkey], dtype=object),
            "c_address": _comments(rng, n, 3),
            "c_nationkey": nationkey,
            "c_phone": _phones(rng, nationkey),
            "c_acctbal": rng.integers(-99999, 999999, n).astype(np.int64),
            "c_mktsegment": np.array(SEGMENTS, dtype=object)[rng.integers(0, 5, n)],
            "c_comment": _comments(rng, n, 12),
        }

    if table == "part":
        total = table_rows(table, sf)
        start, end = _chunk_range(total, parallel, step)
        n = end - start
        rng = _rng(seed, table, step)
        partkey = np.arange(start + 1, end + 1, dtype=np.int64)
        s1 = np.array(TYPE_S1, dtype=object)[rng.integers(0, len(TYPE_S1), n)]
        s2 = np.array(TYPE_S2, dtype=object)[rng.integers(0, len(TYPE_S2), n)]
        s3 = np.array(TYPE_S3, dtype=object)[rng.integers(0, len(TYPE_S3), n)]
        c1 = np.array(CONT_S1, dtype=object)[rng.integers(0, len(CONT_S1), n)]
        c2 = np.array(CONT_S2, dtype=object)[rng.integers(0, len(CONT_S2), n)]
        m = rng.integers(1, 6, n)
        b = rng.integers(1, 6, n)
        colors = np.array(COLORS, dtype=object)
        name_idx = rng.integers(0, len(COLORS), size=(n, 5))
        return {
            "p_partkey": partkey,
            "p_name": np.array([" ".join(colors[r]) for r in name_idx], dtype=object),
            "p_mfgr": np.array([f"Manufacturer#{v}" for v in m], dtype=object),
            "p_brand": np.array([f"Brand#{m[i]}{b[i]}" for i in range(n)], dtype=object),
            "p_type": np.array([f"{s1[i]} {s2[i]} {s3[i]}" for i in range(n)], dtype=object),
            "p_size": rng.integers(1, 51, n).astype(np.int32),
            "p_container": np.array([f"{c1[i]} {c2[i]}" for i in range(n)], dtype=object),
            "p_retailprice": retailprice_cents(partkey),
            "p_comment": _comments(rng, n, 4),
        }

    if table == "partsupp":
        # 4 suppliers per part, deterministic spec-style spread
        nparts = table_rows("part", sf)
        nsupp = table_rows("supplier", sf)
        start, end = _chunk_range(nparts, parallel, step)
        n = end - start
        rng = _rng(seed, table, step)
        partkey = np.repeat(np.arange(start + 1, end + 1, dtype=np.int64), 4)
        j = np.tile(np.arange(4, dtype=np.int64), n)
        suppkey = _supplier_spread(partkey, j, nsupp)
        return {
            "ps_partkey": partkey,
            "ps_suppkey": suppkey,
            "ps_availqty": rng.integers(1, 10000, 4 * n).astype(np.int32),
            "ps_supplycost": rng.integers(100, 100001, 4 * n).astype(np.int64),
            "ps_comment": _comments(rng, 4 * n, 12),
        }

    if table == "orders":
        total = table_rows(table, sf)
        start, end = _chunk_range(total, parallel, step)
        n = end - start
        rng = _rng(seed, table, step)
        orderdate, nlines, custkey, h = _order_attrs(seed, sf, start, end)
        orderkey = np.arange(start + 1, end + 1, dtype=np.int64)
        # orderstatus: F if all lines shipped before split, O if all after,
        # else P. Derive from the same hashes lineitem uses.
        all_f, all_o = _order_status_parts(orderdate, nlines, start, end, seed)
        status = np.where(all_f, "F", np.where(all_o, "O", "P")).astype(object)
        totalprice = _order_totalprice(h, nlines)
        return {
            "o_orderkey": orderkey,
            "o_custkey": custkey,
            "o_orderstatus": status,
            "o_totalprice": totalprice,
            "o_orderdate": orderdate.astype(np.int32),
            "o_orderpriority": np.array(PRIORITIES, dtype=object)[rng.integers(0, 5, n)],
            "o_clerk": np.array(
                [f"Clerk#{v:09d}" for v in rng.integers(1, max(2, int(sf * 1000)) + 1, n)],
                dtype=object),
            "o_shippriority": np.zeros(n, dtype=np.int32),
            "o_comment": _comments(rng, n, 8, ("special", "requests"), 0.01),
        }

    if table == "lineitem":
        # chunked by parent order range so each chunk is self-contained
        n_orders = table_rows("orders", sf)
        o_start, o_end = _chunk_range(n_orders, parallel, step)
        rng = _rng(seed, table, step)
        orderdate, nlines, _custkey, h = _order_attrs(seed, sf, o_start, o_end)
        total_lines = int(nlines.sum())
        okey = np.repeat(np.arange(o_start + 1, o_end + 1, dtype=np.int64), nlines)
        odate = np.repeat(orderdate, nlines)
        # line number within order
        offs = np.concatenate([[0], np.cumsum(nlines)[:-1]])
        linenumber = (np.arange(total_lines, dtype=np.int64)
                      - np.repeat(offs, nlines) + 1).astype(np.int32)
        # per-line randomness: hash on (global order idx, linenumber)
        lidx = np.repeat(np.arange(o_start, o_end, dtype=np.uint64), nlines)

        def lh(k: int) -> np.ndarray:
            return _line_hash(lidx, linenumber.astype(np.uint64), k, seed)

        nparts = table_rows("part", sf)
        nsupp = table_rows("supplier", sf)
        partkey = 1 + (lh(1) % np.uint64(nparts)).astype(np.int64)
        # one of the part's 4 suppliers, same spread as partsupp
        j = (lh(2) % np.uint64(4)).astype(np.int64)
        suppkey = _supplier_spread(partkey, j, nsupp)
        quantity = 1 + (lh(3) % np.uint64(50)).astype(np.int64)
        extprice = quantity * retailprice_cents(partkey)
        discount = (lh(4) % np.uint64(11)).astype(np.int64)          # 0.00-0.10
        tax = (lh(5) % np.uint64(9)).astype(np.int64)                # 0.00-0.08
        shipdate = odate + 1 + (lh(6) % np.uint64(121)).astype(np.int32)
        commitdate = odate + 30 + (lh(7) % np.uint64(61)).astype(np.int32)
        receiptdate = shipdate + 1 + (lh(8) % np.uint64(30)).astype(np.int32)
        returned = receiptdate <= CURRENTDATE_SPLIT
        rf_r = (lh(9) % np.uint64(2)).astype(bool)
        returnflag = np.where(returned, np.where(rf_r, "R", "A"), "N").astype(object)
        linestatus = np.where(shipdate > CURRENTDATE_SPLIT, "O", "F").astype(object)
        return {
            "l_orderkey": okey,
            "l_partkey": partkey,
            "l_suppkey": suppkey,
            "l_linenumber": linenumber,
            "l_quantity": quantity * 100,            # scale-2 cents
            "l_extendedprice": extprice,
            "l_discount": discount,
            "l_tax": tax,
            "l_returnflag": returnflag,
            "l_linestatus": linestatus,
            "l_shipdate": shipdate.astype(np.int32),
            "l_commitdate": commitdate.astype(np.int32),
            "l_receiptdate": receiptdate.astype(np.int32),
            "l_shipinstruct": np.array(INSTRUCTIONS, dtype=object)[
                (lh(10) % np.uint64(4)).astype(np.int64)],
            "l_shipmode": np.array(SHIPMODES, dtype=object)[
                (lh(11) % np.uint64(7)).astype(np.int64)],
            "l_comment": _comments(rng, total_lines, 5),
        }

    raise KeyError(f"unknown TPC-H table {table!r}")


def _supplier_spread(partkey: np.ndarray, j: np.ndarray, nsupp: int) -> np.ndarray:
    """Supplier j (0-3) of a part. Spec §4.2.5.4 spread for realistic supplier
    counts; plain +j at degenerate counts where the spec step can share a
    factor with nsupp and collapse the 4 suppliers together."""
    if nsupp >= 100:
        step = nsupp // 4 + (partkey - 1 + nsupp) // nsupp
        return ((partkey + j * step) % nsupp) + 1
    return ((partkey + j) % nsupp) + 1


def _line_hash(o_idx: np.ndarray, linenumber: np.ndarray, k: int,
               seed: int) -> np.ndarray:
    """The per-lineitem splitmix hash, shared by lineitem gen and
    _order_status_parts so o_orderstatus matches actual line statuses."""
    x = (o_idx * np.uint64(8) + linenumber.astype(np.uint64)
         + np.uint64((k * 0x9E3779B97F4A7C15) % (1 << 64)) + np.uint64(seed))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _order_status_parts(orderdate, nlines, o_start, o_end, seed):
    """Whether all / none of an order's lines have linestatus F.

    Computes each order's actual per-line shipdates with the identical hash
    lineitem generation uses (k=6), so o_orderstatus is exactly consistent
    with the joined lineitem rows (q21 filters o_orderstatus='F').
    """
    idx = np.arange(o_start, o_end, dtype=np.uint64)
    n = len(idx)
    min_ship = np.full(n, np.iinfo(np.int64).max, dtype=np.int64)
    max_ship = np.full(n, np.iinfo(np.int64).min, dtype=np.int64)
    for j in range(1, 8):
        has_line = nlines >= j
        ship = orderdate.astype(np.int64) + 1 + (
            _line_hash(idx, np.full(n, j, dtype=np.uint64), 6, seed)
            % np.uint64(121)).astype(np.int64)
        min_ship = np.where(has_line, np.minimum(min_ship, ship), min_ship)
        max_ship = np.where(has_line, np.maximum(max_ship, ship), max_ship)
    all_f = max_ship <= CURRENTDATE_SPLIT
    all_o = min_ship > CURRENTDATE_SPLIT
    return all_f, all_o


def _order_totalprice(h, nlines):
    """Approximate totalprice from hashed per-line prices (scale-2 int)."""
    # Deterministic but decoupled from exact line sums; queries never join
    # o_totalprice against line sums (only q18 uses it as output).
    base = (h(12) % np.uint64(50_000_000)).astype(np.int64) + 100_000
    return base * nlines.astype(np.int64) // 4
