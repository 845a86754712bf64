"""Built-in deterministic TPC-DS-like data generator.

Counterpart of `nds_tpu_torch.datagen.tpch` for the NDS suite: the reference
drives the TPC-licensed dsdgen via Hadoop-MR
(`nds/tpcds-gen/.../GenTable.java:233-279`); the licensed tool stays
external here too, while this module gives the suite a hermetic generator
with the public spec's schema shapes (TPC-DS v3.2 §3): the star-schema FK
structure, the item brand/class/category hierarchy, the demographic
cross-product dimensions, the 1998-2002 sales calendar, multi-line
tickets/orders, returns as ~10% subsets of sales keyed by
(item, ticket/order), weekly inventory snapshots, and NULLable FK
columns. Distribution *parameters* are public spec §3 facts; value
synthesis is hash-based (splitmix-style), chunk-parallel with the same
(seed, table, step) determinism contract as the TPC-H generator.

Internal consistency is the correctness bar: the differential oracle
compares engine-vs-engine on identical inputs (`nds/nds_validate.py`
compares two runs of the same data), not engine-vs-dsdgen bytes.

Port copy of ``nds_tpu/datagen/tpcds.py``: it imports nothing of
``nds_tpu`` and gives bit-identical tables for every ``sf``.
"""

from __future__ import annotations

import numpy as np

from nds_tpu_torch.nds.schema import table_rows

# ---- public spec §3 value domains -----------------------------------------

CATEGORIES = ["Books", "Children", "Electronics", "Home", "Jewelry",
              "Men", "Music", "Shoes", "Sports", "Women"]
CLASSES_PER_CAT = 16
EDUCATION = ["Primary", "Secondary", "College", "2 yr Degree",
             "4 yr Degree", "Advanced Degree", "Unknown"]
MARITAL = ["S", "M", "D", "W", "U"]
CREDIT = ["Low Risk", "High Risk", "Good", "Unknown"]
BUY_POTENTIAL = ["0-500", "501-1000", "1001-5000", "5001-10000",
                 ">10000", "Unknown"]
GENDERS = ["M", "F"]
STATES = ["AL", "CA", "CO", "FL", "GA", "IL", "IN", "KS", "KY", "LA",
          "MI", "MN", "MO", "MS", "NC", "NE", "NY", "OH", "OK", "PA",
          "SD", "TN", "TX", "VA", "WA", "WI"]
COUNTIES = [f"{w} County" for w in
            ["Williamson", "Walker", "Ziebach", "Franklin", "Bronx",
             "Orange", "Fairfield", "Jackson", "Barrow", "Daviess",
             "Luce", "Richland", "Furnas", "Maverick", "Huron",
             "Kittitas", "Mobile", "Coal", "Lunenburg", "Ferry"]]
CITIES = ["Midway", "Fairview", "Oak Grove", "Five Points", "Oakland",
          "Riverside", "Salem", "Georgetown", "Greenfield", "Liberty",
          "Bethel", "Pleasant Hill", "Lebanon", "Springdale", "Shiloh",
          "Mount Olive", "Glendale", "Marion", "Greenville", "Union"]
STREET_TYPES = ["Street", "Ave", "Blvd", "Way", "Ct", "Dr", "Ln",
                "Pkwy", "Rd", "Cir"]
SHIFT = ["first", "second", "third"]
MEAL = ["breakfast", "lunch", "dinner", ""]
SM_TYPES = ["EXPRESS", "NEXT DAY", "OVERNIGHT", "REGULAR", "LIBRARY"]
SM_CODES = ["AIR", "SURFACE", "SEA"]
SM_CARRIERS = ["UPS", "FEDEX", "AIRBORNE", "USPS", "DHL", "TBS", "ZHOU",
               "ZOUROS", "MSC", "LATVIAN", "DIAMOND", "ALLIANCE",
               "ORIENTAL", "BARIAN", "BOXBUNDLES", "HARMSTORF",
               "PRIVATECARRIER", "GERMA", "RUPEKSA", "GREAT EASTERN"]
COLORS = ["almond", "antique", "aquamarine", "azure", "beige", "bisque",
          "black", "blue", "blush", "brown", "burlywood", "chartreuse",
          "chiffon", "chocolate", "coral", "cornflower", "cream",
          "cyan", "dark", "deep", "dim", "dodger", "drab", "firebrick",
          "floral", "forest", "frosted", "gainsboro", "ghost", "goldenrod",
          "green", "grey", "honeydew", "hot", "indian", "ivory", "khaki",
          "lace", "lavender", "lawn", "lemon", "light", "lime", "linen",
          "magenta", "maroon", "medium", "metallic", "midnight", "mint",
          "misty", "moccasin", "navajo", "navy", "olive", "orange",
          "orchid", "pale", "papaya", "peach", "peru", "pink", "plum",
          "powder", "puff", "purple", "red", "rose", "rosy", "royal",
          "saddle", "salmon", "sandy", "seashell", "sienna", "sky",
          "slate", "smoke", "snow", "spring", "steel", "tan", "thistle",
          "tomato", "turquoise", "violet", "wheat", "white", "yellow"]
UNITS = ["Unknown", "Each", "Dozen", "Case", "Pallet", "Gross", "Lb",
         "Oz", "Ton", "Bunch", "Bundle", "Box", "Carton", "Cup",
         "Dram", "Gram", "N/A", "Pound", "Tbl", "Tsp"]
CONTAINERS = ["Unknown"]
SIZES_DOM = ["small", "medium", "large", "extra large", "economy",
             "N/A", "petite"]
DAY_NAMES = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
             "Friday", "Saturday"]
COUNTRY = "United States"

# d_date_sk convention: julian-style, 2415022 == 1900-01-02 (dsdgen's
# base); date_dim spans 73049 days from 1900-01-02
DATE_SK_BASE = 2415022
EPOCH_1900 = -25567  # 1900-01-02 as days since 1970-01-01 is -25566
DATE_DIM_START_EPOCH = -25566
SALES_DATE_LO = 2450815  # 1998-01-01
SALES_DATE_HI = 2452642  # 2002-12-31


def sk_to_epoch(sk):
    return sk - DATE_SK_BASE + DATE_DIM_START_EPOCH


def epoch_to_sk(d):
    return d - DATE_DIM_START_EPOCH + DATE_SK_BASE


def _stable_base(seed: int, table: str, k: int) -> int:
    import hashlib
    digest = hashlib.md5(f"{seed}/{table}/{k}".encode()).digest()
    return int.from_bytes(digest[:8], "little")


def _h(seed: int, table: str, k: int, idx: np.ndarray) -> np.ndarray:
    """Deterministic uint64 stream #k over row indices (stable across
    processes — python's salted hash() must NOT leak in here, chunks are
    generated by independent workers)."""
    base = np.uint64((_stable_base(seed, table, k)
                      & 0x7FFFFFFFFFFFFFFF) | 1)
    x = idx.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15) + base
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _choice(h: np.ndarray, options: list) -> np.ndarray:
    return np.array(options, dtype=object)[
        (h % np.uint64(len(options))).astype(np.int64)]


def _uniform(h: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Integer uniform in [lo, hi]."""
    return (lo + (h % np.uint64(hi - lo + 1)).astype(np.int64))


def _chunk(total: int, parallel: int, step: int) -> tuple[int, int]:
    per = -(-total // parallel)
    lo = (step - 1) * per
    return lo, min(lo + per, total)


def _ids(prefix: str, sk: np.ndarray, width: int = 16) -> np.ndarray:
    return np.array([f"{prefix}{int(v):0{width - len(prefix)}d}"
                     for v in sk], dtype=object)


def _null_out(arr: np.ndarray, h: np.ndarray, pct: int) -> np.ndarray:
    """~pct% of values become the -1 NULL sentinel (dsdgen's NULLable FK
    sks). Inside the generators the sentinel stays -1 so derived columns
    can branch on it; ``gen_table`` converts sentinels to genuine null
    masks (``col#null`` companion arrays) before handing data to IO, so
    IS NULL / join / aggregate NULL semantics match dsdgen output."""
    mask = (h % np.uint64(100)) < np.uint64(pct)
    out = arr.copy()
    out[mask] = -1
    return out


def _is_sentinel_nullable(name: str) -> bool:
    """Columns whose -1 values are NULL sentinels: surrogate keys (domain
    starts at 1) and the one nulled measure, inv_quantity_on_hand."""
    return name.endswith("_sk") or name == "inv_quantity_on_hand"


SEED = 20260729


def gen_table(table: str, sf: float, parallel: int = 1, step: int = 1,
              seed: int = SEED) -> dict[str, np.ndarray]:
    fn = _GENERATORS.get(table)
    if fn is None:
        raise ValueError(f"unknown TPC-DS table {table!r}")
    total = table_rows(table, sf)
    lo, hi = _chunk(total, parallel, step)
    idx = np.arange(lo, hi, dtype=np.int64)
    out = fn(idx, sf, seed, total)
    # -1 sentinels -> genuine null masks ('<col>#null' companion arrays,
    # True = valid), consumed by io.host_table.from_arrays
    masks = {}
    for name, arr in out.items():
        if (isinstance(arr, np.ndarray) and arr.dtype.kind == "i"
                and _is_sentinel_nullable(name)):
            isnull = arr == -1
            if isnull.any():
                masks[name + "#null"] = ~isnull
                fixed = arr.copy()
                fixed[isnull] = 0
                out[name] = fixed
    out.update(masks)
    return out


# ---- dimensions -----------------------------------------------------------

def _gen_date_dim(idx, sf, seed, total):
    sk = DATE_SK_BASE + idx
    epoch = sk_to_epoch(sk)
    dt = (np.datetime64("1970-01-01", "D") + epoch)
    Y = dt.astype("datetime64[Y]")
    M = dt.astype("datetime64[M]")
    year = Y.astype(np.int64) + 1970
    moy = (M.astype(np.int64) % 12) + 1
    dom = (dt - M).astype(np.int64) + 1
    dow = ((epoch + 4) % 7).astype(np.int64)  # 1970-01-01 = Thursday
    month_seq = (year - 1900) * 12 + moy - 1
    week_seq = ((epoch - DATE_DIM_START_EPOCH) // 7) + 1
    qoy = (moy - 1) // 3 + 1
    quarter_seq = (year - 1900) * 4 + qoy - 1
    month_start_epoch = (M.astype("datetime64[D]")
                         - np.datetime64("1970-01-01", "D")
                         ).astype(np.int64)
    first_dom = epoch_to_sk(month_start_epoch)
    last_dom = first_dom + 27  # approximation, unused by the query set
    holiday = np.where((moy == 12) & (dom == 25), "Y", "N").astype(object)
    weekend = np.where((dow == 0) | (dow == 6), "Y", "N").astype(object)
    return {
        "d_date_sk": sk.astype(np.int32),
        "d_date_id": _ids("AAAAAAAA", sk),
        "d_date": epoch.astype(np.int32),
        "d_month_seq": month_seq.astype(np.int32),
        "d_week_seq": week_seq.astype(np.int32),
        "d_quarter_seq": quarter_seq.astype(np.int32),
        "d_year": year.astype(np.int32),
        "d_dow": dow.astype(np.int32),
        "d_moy": moy.astype(np.int32),
        "d_dom": dom.astype(np.int32),
        "d_qoy": qoy.astype(np.int32),
        "d_fy_year": year.astype(np.int32),
        "d_fy_quarter_seq": quarter_seq.astype(np.int32),
        "d_fy_week_seq": week_seq.astype(np.int32),
        "d_day_name": np.array(DAY_NAMES, dtype=object)[dow],
        "d_quarter_name": np.array(
            [f"{y}Q{q}" for y, q in zip(year, qoy)], dtype=object),
        "d_holiday": holiday,
        "d_weekend": weekend,
        "d_following_holiday": np.roll(holiday, -1),
        "d_first_dom": first_dom.astype(np.int32),
        "d_last_dom": last_dom.astype(np.int32),
        "d_same_day_ly": (sk - 365).astype(np.int32),
        "d_same_day_lq": (sk - 91).astype(np.int32),
        "d_current_day": np.full(len(idx), "N", dtype=object),
        "d_current_week": np.full(len(idx), "N", dtype=object),
        "d_current_month": np.full(len(idx), "N", dtype=object),
        "d_current_quarter": np.full(len(idx), "N", dtype=object),
        "d_current_year": np.full(len(idx), "N", dtype=object),
    }


def _gen_time_dim(idx, sf, seed, total):
    t = idx
    hour = t // 3600
    minute = (t % 3600) // 60
    second = t % 60
    shift = np.array(SHIFT, dtype=object)[
        np.minimum(hour // 8, 2).astype(np.int64)]
    meal = np.where(
        (hour >= 6) & (hour <= 8), "breakfast",
        np.where((hour >= 11) & (hour <= 13), "lunch",
                 np.where((hour >= 17) & (hour <= 19), "dinner", "")))
    return {
        "t_time_sk": t.astype(np.int32),
        "t_time_id": _ids("AAAAAAAA", t),
        "t_time": t.astype(np.int32),
        "t_hour": hour.astype(np.int32),
        "t_minute": minute.astype(np.int32),
        "t_second": second.astype(np.int32),
        "t_am_pm": np.where(hour < 12, "AM", "PM").astype(object),
        "t_shift": shift,
        "t_sub_shift": shift,
        "t_meal_time": meal.astype(object),
    }


def _address_cols(prefix, idx, seed, table):
    h = lambda k: _h(seed, table, k, idx)
    num = _uniform(h(90), 1, 999)
    return {
        f"{prefix}street_number": np.array(
            [str(v) for v in num], dtype=object),
        f"{prefix}street_name": _choice(h(91), CITIES),
        f"{prefix}street_type": _choice(h(92), STREET_TYPES),
        f"{prefix}suite_number": np.array(
            [f"Suite {int(v)}" for v in _uniform(h(93), 0, 99)],
            dtype=object),
        f"{prefix}city": _choice(h(94), CITIES),
        f"{prefix}county": _choice(h(95), COUNTIES),
        f"{prefix}state": _choice(h(96), STATES),
        f"{prefix}zip": np.array(
            [f"{int(v):05d}" for v in _uniform(h(97), 10000, 99999)],
            dtype=object),
        f"{prefix}country": np.full(len(idx), COUNTRY, dtype=object),
        f"{prefix}gmt_offset": (-(_uniform(h(98), 5, 8)) * 100
                                ).astype(np.int64),
    }


def _gen_customer_address(idx, sf, seed, total):
    sk = idx + 1
    out = {"ca_address_sk": sk.astype(np.int32),
           "ca_address_id": _ids("AAAAAAAA", sk)}
    out.update(_address_cols("ca_", idx, seed, "customer_address"))
    out["ca_location_type"] = _choice(
        _h(seed, "customer_address", 99, idx),
        ["apartment", "condo", "single family"])
    return out


def _gen_customer_demographics(idx, sf, seed, total):
    # exact cross product, spec order: gender x marital x education x
    # purchase_estimate x credit x dep x dep_employed x dep_college
    sk = idx + 1
    i = idx
    g = i % 2
    i = i // 2
    m = i % 5
    i = i // 5
    e = i % 7
    i = i // 7
    pe = i % 20
    i = i // 20
    cr = i % 4
    i = i // 4
    dep = i % 7
    i = i // 7
    depe = i % 7
    i = i // 7
    depc = i % 7
    return {
        "cd_demo_sk": sk.astype(np.int32),
        "cd_gender": np.array(GENDERS, dtype=object)[g],
        "cd_marital_status": np.array(MARITAL, dtype=object)[m],
        "cd_education_status": np.array(EDUCATION, dtype=object)[e],
        "cd_purchase_estimate": ((pe + 1) * 500).astype(np.int32),
        "cd_credit_rating": np.array(CREDIT, dtype=object)[cr],
        "cd_dep_count": dep.astype(np.int32),
        "cd_dep_employed_count": depe.astype(np.int32),
        "cd_dep_college_count": depc.astype(np.int32),
    }


def _gen_household_demographics(idx, sf, seed, total):
    sk = idx + 1
    i = idx
    ib = i % 20
    i = i // 20
    bp = i % 6
    i = i // 6
    dep = i % 10
    i = i // 10
    veh = i % 6
    return {
        "hd_demo_sk": sk.astype(np.int32),
        "hd_income_band_sk": (ib + 1).astype(np.int32),
        "hd_buy_potential": np.array(BUY_POTENTIAL, dtype=object)[bp],
        "hd_dep_count": dep.astype(np.int32),
        "hd_vehicle_count": (veh - 1).astype(np.int32),
    }


def _gen_income_band(idx, sf, seed, total):
    sk = idx + 1
    return {
        "ib_income_band_sk": sk.astype(np.int32),
        "ib_lower_bound": (idx * 10000).astype(np.int32),
        "ib_upper_bound": ((idx + 1) * 10000).astype(np.int32),
    }


def _gen_reason(idx, sf, seed, total):
    sk = idx + 1
    reasons = ["Package was damaged", "Stopped working",
               "Did not get it on time", "Not the product that was ordred",
               "Parts missing", "Does not work with a product that I have",
               "Gift exchange", "Did not like the color",
               "Did not like the model", "Did not like the make",
               "Did not fit", "Found a better price in a store",
               "Found a better extended warranty in a store",
               "No service location in my area", "duplicate purchase",
               "its is a boy", "its is a girl", "reason 18", "reason 19",
               "reason 20", "reason 21", "reason 22", "reason 23",
               "reason 24", "reason 25", "reason 26", "reason 27",
               "reason 28", "reason 29", "reason 30", "reason 31",
               "reason 32", "reason 33", "reason 34", "reason 35"]
    return {
        "r_reason_sk": sk.astype(np.int32),
        "r_reason_id": _ids("AAAAAAAA", sk),
        "r_reason_desc": np.array(reasons, dtype=object)[
            idx % len(reasons)],
    }


def _gen_ship_mode(idx, sf, seed, total):
    sk = idx + 1
    return {
        "sm_ship_mode_sk": sk.astype(np.int32),
        "sm_ship_mode_id": _ids("AAAAAAAA", sk),
        "sm_type": np.array(SM_TYPES, dtype=object)[idx % 5],
        "sm_code": np.array(SM_CODES, dtype=object)[idx % 3],
        "sm_carrier": np.array(SM_CARRIERS, dtype=object)[
            idx % len(SM_CARRIERS)],
        "sm_contract": _ids("", idx + 1, 16),
    }


_BRAND_WORDS = ["amalg", "edu pack", "exporti", "importo", "scholar",
                "corp", "brand", "univ", "namel", "maxi"]


def _gen_item(idx, sf, seed, total):
    sk = idx + 1
    h = lambda k: _h(seed, "item", k, idx)
    cat_id = (idx % 10).astype(np.int64)
    class_id = _uniform(h(1), 1, CLASSES_PER_CAT)
    manufact_id = _uniform(h(2), 1, 1000)
    brand_id = cat_id * 1000000 + class_id * 1000 + manufact_id % 1000
    price = _uniform(h(3), 99, 9999)  # cents
    cat = np.array(CATEGORIES, dtype=object)[cat_id]
    return {
        "i_item_sk": sk.astype(np.int32),
        "i_item_id": _ids("AAAAAAAA", (sk + 1) // 2),  # ids repeat (SCD)
        "i_rec_start_date": np.full(len(idx), 10227, dtype=np.int64),
        "i_rec_end_date": np.where(sk % 2 == 0, 11322, 0),
        "i_rec_end_date#null": sk % 2 == 0,
        "i_item_desc": np.array(
            [f"Item description {int(v)} promising results"
             for v in sk], dtype=object),
        "i_current_price": price.astype(np.int64),
        "i_wholesale_cost": (price * 6 // 10).astype(np.int64),
        "i_brand_id": brand_id.astype(np.int32),
        "i_brand": np.array(
            [_BRAND_WORDS[int(c)] + f" #{int(b) % 10 + 1}"
             for c, b in zip(cat_id, brand_id)], dtype=object),
        "i_class_id": class_id.astype(np.int32),
        "i_class": np.array(
            [f"{c.lower()}class{int(k)}" for c, k
             in zip(cat, class_id)], dtype=object),
        "i_category_id": (cat_id + 1).astype(np.int32),
        "i_category": cat,
        "i_manufact_id": manufact_id.astype(np.int32),
        "i_manufact": np.array(
            [f"manufact#{int(v)}" for v in manufact_id], dtype=object),
        "i_size": _choice(h(4), SIZES_DOM),
        "i_formulation": _ids("", _uniform(h(5), 1, 10 ** 9), 20),
        "i_color": _choice(h(6), COLORS),
        "i_units": _choice(h(7), UNITS),
        "i_container": np.full(len(idx), "Unknown", dtype=object),
        "i_manager_id": _uniform(h(8), 1, 100).astype(np.int32),
        "i_product_name": np.array(
            [f"product{int(v)}" for v in sk], dtype=object),
    }


def _gen_customer(idx, sf, seed, total):
    sk = idx + 1
    h = lambda k: _h(seed, "customer", k, idx)
    n_addr = table_rows("customer_address", sf)
    n_cd = table_rows("customer_demographics", sf)
    n_hd = table_rows("household_demographics", sf)
    first = ["James", "Mary", "John", "Patricia", "Robert", "Jennifer",
             "Michael", "Linda", "William", "Elizabeth", "David",
             "Barbara", "Richard", "Susan", "Joseph", "Jessica",
             "Thomas", "Sarah", "Charles", "Karen"]
    last = ["Smith", "Johnson", "Williams", "Brown", "Jones", "Garcia",
            "Miller", "Davis", "Rodriguez", "Martinez", "Hernandez",
            "Lopez", "Gonzalez", "Wilson", "Anderson", "Thomas",
            "Taylor", "Moore", "Jackson", "Martin"]
    bday = _uniform(h(5), 1, 28)
    bmonth = _uniform(h(6), 1, 12)
    byear = _uniform(h(7), 1924, 1992)
    fsales = _uniform(h(8), SALES_DATE_LO - 1460, SALES_DATE_LO + 1000)
    return {
        "c_customer_sk": sk.astype(np.int32),
        "c_customer_id": _ids("AAAAAAAA", sk),
        "c_current_cdemo_sk": _null_out(
            _uniform(h(1), 1, n_cd), h(21), 4).astype(np.int32),
        "c_current_hdemo_sk": _null_out(
            _uniform(h(2), 1, n_hd), h(22), 4).astype(np.int32),
        "c_current_addr_sk": _uniform(h(3), 1, n_addr).astype(np.int32),
        "c_first_shipto_date_sk": (fsales + 30).astype(np.int32),
        "c_first_sales_date_sk": fsales.astype(np.int32),
        "c_salutation": _choice(h(9), ["Mr.", "Mrs.", "Ms.", "Dr.",
                                       "Miss", "Sir"]),
        "c_first_name": _choice(h(10), first),
        "c_last_name": _choice(h(11), last),
        "c_preferred_cust_flag": _choice(h(12), ["Y", "N"]),
        "c_birth_day": bday.astype(np.int32),
        "c_birth_month": bmonth.astype(np.int32),
        "c_birth_year": byear.astype(np.int32),
        "c_birth_country": _choice(
            h(13), ["UNITED STATES", "CANADA", "MEXICO", "GERMANY",
                    "FRANCE", "JAPAN", "CHINA", "BRAZIL", "INDIA",
                    "ITALY", "SPAIN", "NIGERIA", "KENYA", "EGYPT",
                    "PERU", "CHILE", "GREECE", "POLAND", "NORWAY",
                    "TOGO"]),
        "c_login": np.full(len(idx), "", dtype=object),
        "c_email_address": np.array(
            [f"c{int(v)}@example.com" for v in sk], dtype=object),
        "c_last_review_date_sk": _uniform(
            h(14), SALES_DATE_LO, SALES_DATE_HI).astype(np.int32),
    }


def _simple_named_dim(idx, seed, table, prefix, names, with_addr=True,
                      extra=None):
    sk = idx + 1
    h = lambda k: _h(seed, table, k, idx)
    out = {f"{prefix}{k}": v for k, v in (extra or {}).items()}
    return sk, h, out


def _gen_store(idx, sf, seed, total):
    sk = idx + 1
    h = lambda k: _h(seed, "store", k, idx)
    out = {
        "s_store_sk": sk.astype(np.int32),
        "s_store_id": _ids("AAAAAAAA", (sk + 1) // 2),
        "s_rec_start_date": np.full(len(idx), 10227, dtype=np.int64),
        "s_rec_end_date": np.where(sk % 2 == 0, 11322, 0),
        "s_rec_end_date#null": sk % 2 == 0,
        "s_closed_date_sk": _null_out(
            _uniform(h(1), SALES_DATE_LO, SALES_DATE_HI), h(2), 70
        ).astype(np.int32),
        "s_store_name": _choice(h(3), ["ought", "able", "pri", "ese",
                                       "anti", "cally", "ation", "eing",
                                       "bar", "ought"]),
        "s_number_employees": _uniform(h(4), 200, 300).astype(np.int32),
        "s_floor_space": _uniform(h(5), 5000000, 10000000
                                  ).astype(np.int32),
        "s_hours": _choice(h(6), ["8AM-4PM", "8AM-8AM", "8AM-12AM"]),
        "s_manager": _choice(h(7), ["William Ward", "Scott Smith",
                                    "Edwin Adams", "David Thomas",
                                    "Charles Bartley", "Robert Thompson"]),
        "s_market_id": _uniform(h(8), 1, 10).astype(np.int32),
        "s_geography_class": np.full(len(idx), "Unknown", dtype=object),
        "s_market_desc": np.array(
            [f"Market description {int(v)}" for v in sk], dtype=object),
        "s_market_manager": _choice(
            h(9), ["Charles Bartley", "Mark Hightower", "Larry Mccray",
                   "Dean Morrison", "David Thomas"]),
        "s_division_id": np.ones(len(idx), dtype=np.int32),
        "s_division_name": np.full(len(idx), "Unknown", dtype=object),
        "s_company_id": np.ones(len(idx), dtype=np.int32),
        "s_company_name": np.full(len(idx), "Unknown", dtype=object),
    }
    out.update({k.replace("ca_", "s_"): v for k, v in
                _address_cols("ca_", idx, seed, "store").items()})
    out["s_tax_precentage"] = _uniform(h(10), 0, 11).astype(np.int64)
    return out


def _gen_warehouse(idx, sf, seed, total):
    sk = idx + 1
    out = {
        "w_warehouse_sk": sk.astype(np.int32),
        "w_warehouse_id": _ids("AAAAAAAA", sk),
        "w_warehouse_name": _choice(
            _h(seed, "warehouse", 1, idx),
            ["Conventional childr", "Important issues liv",
             "Doors canno", "Bad cards must make.", "Rooms cook "]),
        "w_warehouse_sq_ft": _uniform(
            _h(seed, "warehouse", 2, idx), 50000, 1000000
        ).astype(np.int32),
    }
    out.update({k.replace("ca_", "w_"): v for k, v in
                _address_cols("ca_", idx, seed, "warehouse").items()})
    return out


def _gen_call_center(idx, sf, seed, total):
    sk = idx + 1
    h = lambda k: _h(seed, "call_center", k, idx)
    out = {
        "cc_call_center_sk": sk.astype(np.int32),
        "cc_call_center_id": _ids("AAAAAAAA", (sk + 1) // 2),
        "cc_rec_start_date": np.full(len(idx), 10227, dtype=np.int64),
        "cc_rec_end_date": np.where(sk % 2 == 0, 11322, 0),
        "cc_rec_end_date#null": sk % 2 == 0,
        "cc_closed_date_sk": np.full(len(idx), -1, dtype=np.int32),
        "cc_open_date_sk": _uniform(
            h(1), SALES_DATE_LO - 3000, SALES_DATE_LO).astype(np.int32),
        "cc_name": np.array([f"call center {int(v)}" for v in sk],
                            dtype=object),
        "cc_class": _choice(h(2), ["small", "medium", "large"]),
        "cc_employees": _uniform(h(3), 1, 7).astype(np.int32),
        "cc_sq_ft": _uniform(h(4), 1000, 40000000).astype(np.int32),
        "cc_hours": _choice(h(5), ["8AM-4PM", "8AM-8AM", "8AM-12AM"]),
        "cc_manager": _choice(h(6), ["Bob Belcher", "Felipe Perkins",
                                     "Mark Hightower", "Larry Mccray"]),
        "cc_mkt_id": _uniform(h(7), 1, 6).astype(np.int32),
        "cc_mkt_class": np.full(len(idx), "Unknown", dtype=object),
        "cc_mkt_desc": np.array(
            [f"Call center market {int(v)}" for v in sk], dtype=object),
        "cc_market_manager": _choice(
            h(8), ["Julius Tran", "Gary Colburn", "Evan Zimmerman"]),
        "cc_division": np.ones(len(idx), dtype=np.int32),
        "cc_division_name": np.full(len(idx), "pri", dtype=object),
        "cc_company": np.ones(len(idx), dtype=np.int32),
        "cc_company_name": np.full(len(idx), "Unknown", dtype=object),
    }
    out.update({k.replace("ca_", "cc_"): v for k, v in
                _address_cols("ca_", idx, seed, "call_center").items()})
    out["cc_tax_percentage"] = _uniform(h(9), 0, 11).astype(np.int64)
    return out


def _gen_web_site(idx, sf, seed, total):
    sk = idx + 1
    h = lambda k: _h(seed, "web_site", k, idx)
    out = {
        "web_site_sk": sk.astype(np.int32),
        "web_site_id": _ids("AAAAAAAA", (sk + 1) // 2),
        "web_rec_start_date": np.full(len(idx), 10227, dtype=np.int64),
        "web_rec_end_date": np.where(sk % 2 == 0, 11322, 0),
        "web_rec_end_date#null": sk % 2 == 0,
        "web_name": np.array([f"site_{int(v) % 10}" for v in sk],
                             dtype=object),
        "web_open_date_sk": _uniform(
            h(1), SALES_DATE_LO - 3000, SALES_DATE_LO).astype(np.int32),
        "web_close_date_sk": np.full(len(idx), -1, dtype=np.int32),
        "web_class": np.full(len(idx), "Unknown", dtype=object),
        "web_manager": _choice(h(2), ["Raymond Jacobs", "Ronald Barnes",
                                      "Albert Leung", "Zachery Oneil"]),
        "web_mkt_id": _uniform(h(3), 1, 6).astype(np.int32),
        "web_mkt_class": np.full(len(idx), "Unknown", dtype=object),
        "web_mkt_desc": np.array(
            [f"Web market {int(v)}" for v in sk], dtype=object),
        "web_market_manager": _choice(
            h(4), ["Albert Leung", "Zachery Oneil", "Lawrence Fox"]),
        "web_company_id": np.ones(len(idx), dtype=np.int32),
        "web_company_name": _choice(h(5), ["pri", "able", "ought",
                                           "ation", "bar", "ese"]),
    }
    out.update({k.replace("ca_", "web_"): v for k, v in
                _address_cols("ca_", idx, seed, "web_site").items()})
    out["web_tax_percentage"] = _uniform(h(6), 0, 11).astype(np.int64)
    return out


def _gen_web_page(idx, sf, seed, total):
    sk = idx + 1
    h = lambda k: _h(seed, "web_page", k, idx)
    return {
        "wp_web_page_sk": sk.astype(np.int32),
        "wp_web_page_id": _ids("AAAAAAAA", (sk + 1) // 2),
        "wp_rec_start_date": np.full(len(idx), 10227, dtype=np.int64),
        "wp_rec_end_date": np.where(sk % 2 == 0, 11322, 0),
        "wp_rec_end_date#null": sk % 2 == 0,
        "wp_creation_date_sk": _uniform(
            h(1), SALES_DATE_LO - 1000, SALES_DATE_LO).astype(np.int32),
        "wp_access_date_sk": _uniform(
            h(2), SALES_DATE_HI - 100, SALES_DATE_HI).astype(np.int32),
        "wp_autogen_flag": _choice(h(3), ["Y", "N"]),
        "wp_customer_sk": _null_out(
            _uniform(h(4), 1, max(table_rows("customer", sf), 1)),
            h(5), 70).astype(np.int32),
        "wp_url": np.full(len(idx), "http://www.foo.com", dtype=object),
        "wp_type": _choice(h(6), ["ad", "bio", "dynamic", "feedback",
                                  "general", "order", "protected",
                                  "welcome"]),
        "wp_char_count": _uniform(h(7), 100, 8000).astype(np.int32),
        "wp_link_count": _uniform(h(8), 2, 25).astype(np.int32),
        "wp_image_count": _uniform(h(9), 1, 7).astype(np.int32),
        "wp_max_ad_count": _uniform(h(10), 0, 4).astype(np.int32),
    }


def _gen_promotion(idx, sf, seed, total):
    sk = idx + 1
    h = lambda k: _h(seed, "promotion", k, idx)
    yn = lambda k: _choice(h(k), ["N", "N", "N", "N", "N", "N", "N",
                                  "N", "N", "Y"])
    start = _uniform(h(1), SALES_DATE_LO, SALES_DATE_HI - 60)
    return {
        "p_promo_sk": sk.astype(np.int32),
        "p_promo_id": _ids("AAAAAAAA", sk),
        "p_start_date_sk": start.astype(np.int32),
        "p_end_date_sk": (start + _uniform(h(2), 10, 60)
                          ).astype(np.int32),
        "p_item_sk": _uniform(h(3), 1, max(table_rows("item", sf), 1)
                              ).astype(np.int32),
        "p_cost": np.full(len(idx), 100000, dtype=np.int64),
        "p_response_target": np.ones(len(idx), dtype=np.int32),
        "p_promo_name": _choice(h(4), ["anti", "ought", "able", "pri",
                                       "ese", "cally", "ation", "eing",
                                       "bar"]),
        "p_channel_dmail": yn(5), "p_channel_email": yn(6),
        "p_channel_catalog": yn(7), "p_channel_tv": yn(8),
        "p_channel_radio": yn(9), "p_channel_press": yn(10),
        "p_channel_event": yn(11), "p_channel_demo": yn(12),
        "p_channel_details": np.array(
            [f"promo details {int(v)}" for v in sk], dtype=object),
        "p_purpose": np.full(len(idx), "Unknown", dtype=object),
        "p_discount_active": _choice(h(13), ["N", "Y"]),
    }


def _gen_catalog_page(idx, sf, seed, total):
    sk = idx + 1
    h = lambda k: _h(seed, "catalog_page", k, idx)
    start = _uniform(h(1), SALES_DATE_LO - 1000, SALES_DATE_HI - 100)
    return {
        "cp_catalog_page_sk": sk.astype(np.int32),
        "cp_catalog_page_id": _ids("AAAAAAAA", sk),
        "cp_start_date_sk": start.astype(np.int32),
        "cp_end_date_sk": (start + 90).astype(np.int32),
        "cp_department": np.full(len(idx), "DEPARTMENT", dtype=object),
        "cp_catalog_number": (idx // 108 + 1).astype(np.int32),
        "cp_catalog_page_number": (idx % 108 + 1).astype(np.int32),
        "cp_description": np.array(
            [f"Catalog page description {int(v)}" for v in sk],
            dtype=object),
        "cp_type": _choice(h(2), ["bi-annual", "quarterly", "monthly"]),
    }


def _gen_inventory(idx, sf, seed, total):
    n_item = table_rows("item", sf)
    n_wh = table_rows("warehouse", sf)
    # weekly snapshots over the sales window
    i = idx
    item = i % n_item + 1
    i = i // n_item
    wh = i % n_wh + 1
    week = i // n_wh
    date_sk = SALES_DATE_LO + (week % 261) * 7
    h = _h(seed, "inventory", 1, idx)
    qty = _uniform(h, 0, 1000)
    qty = _null_out(qty, _h(seed, "inventory", 2, idx), 5)
    return {
        "inv_date_sk": date_sk.astype(np.int32),
        "inv_item_sk": item.astype(np.int32),
        "inv_warehouse_sk": wh.astype(np.int32),
        "inv_quantity_on_hand": qty.astype(np.int32),
    }


# ---- fact channels --------------------------------------------------------

# tickets repeat a [4, 8, 12, 16]-line pattern (40 rows / 4 tickets):
# group-size variety with O(1) row -> (ticket, line) indexing, so any
# chunk generates independently
_TICKET_PATTERN = np.array([4, 8, 12, 16])
_PATTERN_ROWS = int(_TICKET_PATTERN.sum())
_PATTERN_STARTS = np.concatenate([[0], np.cumsum(_TICKET_PATTERN)[:-1]])


def _ticket_of(idx):
    block = idx // _PATTERN_ROWS
    off = idx % _PATTERN_ROWS
    within = np.searchsorted(_PATTERN_STARTS, off, side="right") - 1
    ticket = block * 4 + within
    line = off - _PATTERN_STARTS[within]
    return ticket + 1, line + 1


def _sales_money(h, qty):
    """Consistent money ladder (cents): wholesale -> list -> sales ->
    ext_* -> net_*; discounts/coupons derived from hash streams."""
    wholesale = _uniform(h(20), 100, 10000)
    list_p = wholesale * _uniform(h(21), 110, 240) // 100
    disc_pct = _uniform(h(22), 0, 90)
    sales_p = list_p * (100 - disc_pct) // 100
    coupon = np.where(_h_pct(h(23), 15), sales_p * qty // 10, 0)
    ext_disc = (list_p - sales_p) * qty
    ext_sales = sales_p * qty
    ext_whole = wholesale * qty
    ext_list = list_p * qty
    tax_pct = _uniform(h(24), 0, 9)
    ext_tax = (ext_sales - coupon) * tax_pct // 100
    net_paid = ext_sales - coupon
    ship = ext_whole * _uniform(h(25), 0, 20) // 100
    return dict(wholesale=wholesale, list=list_p, sales=sales_p,
                coupon=coupon, ext_disc=ext_disc, ext_sales=ext_sales,
                ext_whole=ext_whole, ext_list=ext_list, ext_tax=ext_tax,
                net_paid=net_paid, ship=ship)


def _h_pct(h, pct):
    return (h % np.uint64(100)) < np.uint64(pct)


def _fact_common(idx, sf, seed, table):
    h = lambda k: _h(seed, table, k, idx)
    ticket, line = _ticket_of(idx)
    # per-ticket attributes come from ticket-indexed hash streams so all
    # lines of a ticket agree (date, customer, store)
    th = lambda k: _h(seed, table + "#t", k, ticket)
    date_sk = _uniform(th(1), SALES_DATE_LO, SALES_DATE_HI)
    time_sk = _uniform(th(2), 0, 86399)
    cust = _uniform(th(3), 1, max(table_rows("customer", sf), 1))
    # items are DISTINCT within a ticket (dsdgen invariant backing the
    # (item, ticket) primary key): per-ticket random base + line offset
    n_item = max(table_rows("item", sf), 1)
    item = (_uniform(th(12), 0, n_item - 1) + line - 1) % n_item + 1
    qty = _uniform(h(5), 1, 100)
    return h, th, ticket, line, date_sk, time_sk, cust, item, qty


def _gen_store_sales(idx, sf, seed, total):
    h, th, ticket, line, date_sk, time_sk, cust, item, qty = \
        _fact_common(idx, sf, seed, "store_sales")
    m = _sales_money(h, qty)
    net_profit = m["net_paid"] - m["ext_whole"]
    return {
        "ss_sold_date_sk": _null_out(date_sk, h(40), 4).astype(np.int32),
        "ss_sold_time_sk": _null_out(time_sk, h(41), 4).astype(np.int32),
        "ss_item_sk": item.astype(np.int32),
        "ss_customer_sk": _null_out(cust, h(42), 4).astype(np.int32),
        "ss_cdemo_sk": _null_out(_uniform(
            th(6), 1, table_rows("customer_demographics", sf)),
            h(43), 4).astype(np.int32),
        "ss_hdemo_sk": _null_out(_uniform(
            th(7), 1, table_rows("household_demographics", sf)),
            h(44), 4).astype(np.int32),
        "ss_addr_sk": _null_out(_uniform(
            th(8), 1, max(table_rows("customer_address", sf), 1)),
            h(45), 4).astype(np.int32),
        "ss_store_sk": _null_out(_uniform(
            th(9), 1, max(table_rows("store", sf), 1)),
            h(46), 4).astype(np.int32),
        "ss_promo_sk": _null_out(_uniform(
            h(10), 1, max(table_rows("promotion", sf), 1)),
            h(47), 4).astype(np.int32),
        "ss_ticket_number": ticket.astype(np.int64),
        "ss_quantity": qty.astype(np.int32),
        "ss_wholesale_cost": m["wholesale"].astype(np.int64),
        "ss_list_price": m["list"].astype(np.int64),
        "ss_sales_price": m["sales"].astype(np.int64),
        "ss_ext_discount_amt": m["ext_disc"].astype(np.int64),
        "ss_ext_sales_price": m["ext_sales"].astype(np.int64),
        "ss_ext_wholesale_cost": m["ext_whole"].astype(np.int64),
        "ss_ext_list_price": m["ext_list"].astype(np.int64),
        "ss_ext_tax": m["ext_tax"].astype(np.int64),
        "ss_coupon_amt": m["coupon"].astype(np.int64),
        "ss_net_paid": m["net_paid"].astype(np.int64),
        "ss_net_paid_inc_tax": (m["net_paid"] + m["ext_tax"]
                                ).astype(np.int64),
        "ss_net_profit": net_profit.astype(np.int64),
    }


def _returns_base(idx, sf, seed, sales_table, ratio):
    """Returns row i corresponds to sales row i*ratio (+jitter): gives the
    (item, ticket) FK back-reference the maintenance/delete flows and
    return-join queries need."""
    sales_total = table_rows(sales_table, sf)
    jitter = (_h(seed, sales_table + "#r", 1, idx)
              % np.uint64(ratio)).astype(np.int64)
    return (idx * ratio + jitter) % max(sales_total, 1)


def _gen_store_returns(idx, sf, seed, total):
    sales_idx = _returns_base(idx, sf, seed, "store_sales", 10)
    s = _gen_store_sales(sales_idx, sf, seed, None)
    h = lambda k: _h(seed, "store_returns", k, idx)
    rdate = np.where(
        s["ss_sold_date_sk"] > 0,
        s["ss_sold_date_sk"] + _uniform(h(1), 1, 90),
        _uniform(h(2), SALES_DATE_LO, SALES_DATE_HI)).astype(np.int64)
    rqty = np.minimum(_uniform(h(3), 1, 100), s["ss_quantity"])
    amt = s["ss_sales_price"].astype(np.int64) * rqty
    tax = amt * _uniform(h(4), 0, 9) // 100
    fee = _uniform(h(5), 50, 10000)
    shipcost = s["ss_wholesale_cost"].astype(np.int64) * rqty // 2
    refunded = amt * _uniform(h(6), 0, 100) // 100
    reversed_ = amt - refunded
    return {
        "sr_returned_date_sk": rdate.astype(np.int32),
        "sr_return_time_sk": _uniform(h(7), 28800, 61200
                                      ).astype(np.int32),
        "sr_item_sk": s["ss_item_sk"],
        "sr_customer_sk": _null_out(
            s["ss_customer_sk"].astype(np.int64), h(8), 4
        ).astype(np.int32),
        "sr_cdemo_sk": s["ss_cdemo_sk"],
        "sr_hdemo_sk": s["ss_hdemo_sk"],
        "sr_addr_sk": s["ss_addr_sk"],
        "sr_store_sk": s["ss_store_sk"],
        "sr_reason_sk": _uniform(h(9), 1, 35).astype(np.int32),
        "sr_ticket_number": s["ss_ticket_number"],
        "sr_return_quantity": rqty.astype(np.int32),
        "sr_return_amt": amt.astype(np.int64),
        "sr_return_tax": tax.astype(np.int64),
        "sr_return_amt_inc_tax": (amt + tax).astype(np.int64),
        "sr_fee": fee.astype(np.int64),
        "sr_return_ship_cost": shipcost.astype(np.int64),
        "sr_refunded_cash": refunded.astype(np.int64),
        "sr_reversed_charge": reversed_.astype(np.int64),
        "sr_store_credit": np.zeros(len(idx), dtype=np.int64),
        "sr_net_loss": (fee + shipcost + tax).astype(np.int64),
    }


def _gen_catalog_sales(idx, sf, seed, total):
    h, th, order, line, date_sk, time_sk, cust, item, qty = \
        _fact_common(idx, sf, seed, "catalog_sales")
    m = _sales_money(h, qty)
    ship_date = date_sk + _uniform(h(30), 2, 120)
    net_profit = m["net_paid"] - m["ext_whole"]
    return {
        "cs_sold_date_sk": _null_out(date_sk, h(40), 4).astype(np.int32),
        "cs_sold_time_sk": time_sk.astype(np.int32),
        "cs_ship_date_sk": _null_out(ship_date, h(41), 4
                                     ).astype(np.int32),
        "cs_bill_customer_sk": cust.astype(np.int32),
        "cs_bill_cdemo_sk": _uniform(
            th(6), 1, table_rows("customer_demographics", sf)
        ).astype(np.int32),
        "cs_bill_hdemo_sk": _uniform(
            th(7), 1, table_rows("household_demographics", sf)
        ).astype(np.int32),
        "cs_bill_addr_sk": _uniform(
            th(8), 1, max(table_rows("customer_address", sf), 1)
        ).astype(np.int32),
        "cs_ship_customer_sk": _null_out(
            _uniform(th(9), 1, max(table_rows("customer", sf), 1)),
            h(42), 4).astype(np.int32),
        "cs_ship_cdemo_sk": _uniform(
            th(10), 1, table_rows("customer_demographics", sf)
        ).astype(np.int32),
        "cs_ship_hdemo_sk": _uniform(
            th(11), 1, table_rows("household_demographics", sf)
        ).astype(np.int32),
        "cs_ship_addr_sk": _uniform(
            th(12), 1, max(table_rows("customer_address", sf), 1)
        ).astype(np.int32),
        "cs_call_center_sk": _null_out(_uniform(
            th(13), 1, max(table_rows("call_center", sf), 1)),
            h(43), 4).astype(np.int32),
        "cs_catalog_page_sk": _uniform(
            h(14), 1, max(table_rows("catalog_page", sf), 1)
        ).astype(np.int32),
        "cs_ship_mode_sk": _uniform(h(15), 1, 20).astype(np.int32),
        "cs_warehouse_sk": _null_out(_uniform(
            h(16), 1, max(table_rows("warehouse", sf), 1)),
            h(44), 4).astype(np.int32),
        "cs_item_sk": item.astype(np.int32),
        "cs_promo_sk": _null_out(_uniform(
            h(17), 1, max(table_rows("promotion", sf), 1)),
            h(45), 4).astype(np.int32),
        "cs_order_number": order.astype(np.int64),
        "cs_quantity": qty.astype(np.int32),
        "cs_wholesale_cost": m["wholesale"].astype(np.int64),
        "cs_list_price": m["list"].astype(np.int64),
        "cs_sales_price": m["sales"].astype(np.int64),
        "cs_ext_discount_amt": m["ext_disc"].astype(np.int64),
        "cs_ext_sales_price": m["ext_sales"].astype(np.int64),
        "cs_ext_wholesale_cost": m["ext_whole"].astype(np.int64),
        "cs_ext_list_price": m["ext_list"].astype(np.int64),
        "cs_ext_tax": m["ext_tax"].astype(np.int64),
        "cs_coupon_amt": m["coupon"].astype(np.int64),
        "cs_ext_ship_cost": m["ship"].astype(np.int64),
        "cs_net_paid": m["net_paid"].astype(np.int64),
        "cs_net_paid_inc_tax": (m["net_paid"] + m["ext_tax"]
                                ).astype(np.int64),
        "cs_net_paid_inc_ship": (m["net_paid"] + m["ship"]
                                 ).astype(np.int64),
        "cs_net_paid_inc_ship_tax": (
            m["net_paid"] + m["ship"] + m["ext_tax"]).astype(np.int64),
        "cs_net_profit": net_profit.astype(np.int64),
    }


def _gen_catalog_returns(idx, sf, seed, total):
    sales_idx = _returns_base(idx, sf, seed, "catalog_sales", 10)
    s = _gen_catalog_sales(sales_idx, sf, seed, None)
    h = lambda k: _h(seed, "catalog_returns", k, idx)
    rdate = np.where(
        s["cs_sold_date_sk"] > 0,
        s["cs_sold_date_sk"].astype(np.int64) + _uniform(h(1), 1, 90),
        _uniform(h(2), SALES_DATE_LO, SALES_DATE_HI))
    rqty = np.minimum(_uniform(h(3), 1, 100), s["cs_quantity"])
    amt = s["cs_sales_price"].astype(np.int64) * rqty
    tax = amt * _uniform(h(4), 0, 9) // 100
    fee = _uniform(h(5), 50, 10000)
    shipcost = s["cs_wholesale_cost"].astype(np.int64) * rqty // 2
    refunded = amt * _uniform(h(6), 0, 100) // 100
    return {
        "cr_returned_date_sk": rdate.astype(np.int32),
        "cr_returned_time_sk": _uniform(h(7), 0, 86399).astype(np.int32),
        "cr_item_sk": s["cs_item_sk"],
        "cr_refunded_customer_sk": s["cs_bill_customer_sk"],
        "cr_refunded_cdemo_sk": s["cs_bill_cdemo_sk"],
        "cr_refunded_hdemo_sk": s["cs_bill_hdemo_sk"],
        "cr_refunded_addr_sk": s["cs_bill_addr_sk"],
        "cr_returning_customer_sk": _null_out(
            s["cs_ship_customer_sk"].astype(np.int64), h(8), 4
        ).astype(np.int32),
        "cr_returning_cdemo_sk": s["cs_ship_cdemo_sk"],
        "cr_returning_hdemo_sk": s["cs_ship_hdemo_sk"],
        "cr_returning_addr_sk": s["cs_ship_addr_sk"],
        "cr_call_center_sk": s["cs_call_center_sk"],
        "cr_catalog_page_sk": s["cs_catalog_page_sk"],
        "cr_ship_mode_sk": s["cs_ship_mode_sk"],
        "cr_warehouse_sk": s["cs_warehouse_sk"],
        "cr_reason_sk": _uniform(h(9), 1, 35).astype(np.int32),
        "cr_order_number": s["cs_order_number"],
        "cr_return_quantity": rqty.astype(np.int32),
        "cr_return_amount": amt.astype(np.int64),
        "cr_return_tax": tax.astype(np.int64),
        "cr_return_amt_inc_tax": (amt + tax).astype(np.int64),
        "cr_fee": fee.astype(np.int64),
        "cr_return_ship_cost": shipcost.astype(np.int64),
        "cr_refunded_cash": refunded.astype(np.int64),
        "cr_reversed_charge": (amt - refunded).astype(np.int64),
        "cr_store_credit": np.zeros(len(idx), dtype=np.int64),
        "cr_net_loss": (fee + shipcost + tax).astype(np.int64),
    }


def _gen_web_sales(idx, sf, seed, total):
    h, th, order, line, date_sk, time_sk, cust, item, qty = \
        _fact_common(idx, sf, seed, "web_sales")
    m = _sales_money(h, qty)
    ship_date = date_sk + _uniform(h(30), 2, 120)
    return {
        "ws_sold_date_sk": _null_out(date_sk, h(40), 4).astype(np.int32),
        "ws_sold_time_sk": time_sk.astype(np.int32),
        "ws_ship_date_sk": ship_date.astype(np.int32),
        "ws_item_sk": item.astype(np.int32),
        "ws_bill_customer_sk": cust.astype(np.int32),
        "ws_bill_cdemo_sk": _uniform(
            th(6), 1, table_rows("customer_demographics", sf)
        ).astype(np.int32),
        "ws_bill_hdemo_sk": _uniform(
            th(7), 1, table_rows("household_demographics", sf)
        ).astype(np.int32),
        "ws_bill_addr_sk": _uniform(
            th(8), 1, max(table_rows("customer_address", sf), 1)
        ).astype(np.int32),
        "ws_ship_customer_sk": _uniform(
            th(9), 1, max(table_rows("customer", sf), 1)
        ).astype(np.int32),
        "ws_ship_cdemo_sk": _uniform(
            th(10), 1, table_rows("customer_demographics", sf)
        ).astype(np.int32),
        "ws_ship_hdemo_sk": _uniform(
            th(11), 1, table_rows("household_demographics", sf)
        ).astype(np.int32),
        "ws_ship_addr_sk": _uniform(
            th(12), 1, max(table_rows("customer_address", sf), 1)
        ).astype(np.int32),
        "ws_web_page_sk": _uniform(
            h(13), 1, max(table_rows("web_page", sf), 1)
        ).astype(np.int32),
        "ws_web_site_sk": _uniform(
            th(14), 1, max(table_rows("web_site", sf), 1)
        ).astype(np.int32),
        "ws_ship_mode_sk": _uniform(h(15), 1, 20).astype(np.int32),
        "ws_warehouse_sk": _uniform(
            h(16), 1, max(table_rows("warehouse", sf), 1)
        ).astype(np.int32),
        "ws_promo_sk": _uniform(
            h(17), 1, max(table_rows("promotion", sf), 1)
        ).astype(np.int32),
        "ws_order_number": order.astype(np.int64),
        "ws_quantity": qty.astype(np.int32),
        "ws_wholesale_cost": m["wholesale"].astype(np.int64),
        "ws_list_price": m["list"].astype(np.int64),
        "ws_sales_price": m["sales"].astype(np.int64),
        "ws_ext_discount_amt": m["ext_disc"].astype(np.int64),
        "ws_ext_sales_price": m["ext_sales"].astype(np.int64),
        "ws_ext_wholesale_cost": m["ext_whole"].astype(np.int64),
        "ws_ext_list_price": m["ext_list"].astype(np.int64),
        "ws_ext_tax": m["ext_tax"].astype(np.int64),
        "ws_coupon_amt": m["coupon"].astype(np.int64),
        "ws_ext_ship_cost": m["ship"].astype(np.int64),
        "ws_net_paid": m["net_paid"].astype(np.int64),
        "ws_net_paid_inc_tax": (m["net_paid"] + m["ext_tax"]
                                ).astype(np.int64),
        "ws_net_paid_inc_ship": (m["net_paid"] + m["ship"]
                                 ).astype(np.int64),
        "ws_net_paid_inc_ship_tax": (
            m["net_paid"] + m["ship"] + m["ext_tax"]).astype(np.int64),
        "ws_net_profit": (m["net_paid"] - m["ext_whole"]
                          ).astype(np.int64),
    }


def _gen_web_returns(idx, sf, seed, total):
    sales_idx = _returns_base(idx, sf, seed, "web_sales", 10)
    s = _gen_web_sales(sales_idx, sf, seed, None)
    h = lambda k: _h(seed, "web_returns", k, idx)
    rdate = np.where(
        s["ws_sold_date_sk"] > 0,
        s["ws_sold_date_sk"].astype(np.int64) + _uniform(h(1), 1, 90),
        _uniform(h(2), SALES_DATE_LO, SALES_DATE_HI))
    rqty = np.minimum(_uniform(h(3), 1, 100), s["ws_quantity"])
    amt = s["ws_sales_price"].astype(np.int64) * rqty
    tax = amt * _uniform(h(4), 0, 9) // 100
    fee = _uniform(h(5), 50, 10000)
    shipcost = s["ws_wholesale_cost"].astype(np.int64) * rqty // 2
    refunded = amt * _uniform(h(6), 0, 100) // 100
    return {
        "wr_returned_date_sk": rdate.astype(np.int32),
        "wr_returned_time_sk": _uniform(h(7), 0, 86399).astype(np.int32),
        "wr_item_sk": s["ws_item_sk"],
        "wr_refunded_customer_sk": _null_out(
            s["ws_bill_customer_sk"].astype(np.int64), h(8), 4
        ).astype(np.int32),
        "wr_refunded_cdemo_sk": s["ws_bill_cdemo_sk"],
        "wr_refunded_hdemo_sk": s["ws_bill_hdemo_sk"],
        "wr_refunded_addr_sk": s["ws_bill_addr_sk"],
        "wr_returning_customer_sk": s["ws_ship_customer_sk"],
        "wr_returning_cdemo_sk": s["ws_ship_cdemo_sk"],
        "wr_returning_hdemo_sk": s["ws_ship_hdemo_sk"],
        "wr_returning_addr_sk": s["ws_ship_addr_sk"],
        "wr_web_page_sk": s["ws_web_page_sk"],
        "wr_reason_sk": _uniform(h(9), 1, 35).astype(np.int32),
        "wr_order_number": s["ws_order_number"],
        "wr_return_quantity": rqty.astype(np.int32),
        "wr_return_amt": amt.astype(np.int64),
        "wr_return_tax": tax.astype(np.int64),
        "wr_return_amt_inc_tax": (amt + tax).astype(np.int64),
        "wr_fee": fee.astype(np.int64),
        "wr_return_ship_cost": shipcost.astype(np.int64),
        "wr_refunded_cash": refunded.astype(np.int64),
        "wr_reversed_charge": (amt - refunded).astype(np.int64),
        "wr_account_credit": np.zeros(len(idx), dtype=np.int64),
        "wr_net_loss": (fee + shipcost + tax).astype(np.int64),
    }


_GENERATORS = {
    "date_dim": _gen_date_dim,
    "time_dim": _gen_time_dim,
    "customer_address": _gen_customer_address,
    "customer_demographics": _gen_customer_demographics,
    "household_demographics": _gen_household_demographics,
    "income_band": _gen_income_band,
    "reason": _gen_reason,
    "ship_mode": _gen_ship_mode,
    "item": _gen_item,
    "customer": _gen_customer,
    "store": _gen_store,
    "warehouse": _gen_warehouse,
    "call_center": _gen_call_center,
    "web_site": _gen_web_site,
    "web_page": _gen_web_page,
    "promotion": _gen_promotion,
    "catalog_page": _gen_catalog_page,
    "inventory": _gen_inventory,
    "store_sales": _gen_store_sales,
    "store_returns": _gen_store_returns,
    "catalog_sales": _gen_catalog_sales,
    "catalog_returns": _gen_catalog_returns,
    "web_sales": _gen_web_sales,
    "web_returns": _gen_web_returns,
}
