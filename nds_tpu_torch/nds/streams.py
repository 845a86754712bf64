"""NDS (TPC-DS) query + stream generation and stream parsing.

Counterpart of the reference's dsqgen wrapper
(`nds/nds_gen_query_stream.py:42-103`): renders query templates with
substitution parameters and emits permuted streams, each query framed by
the dsqgen-style marker the power run parses
(`-- start query N in stream S using template queryNN.tpl`, parsed by
`nds/nds_power.py:50-77`). Two-statement templates (q14/23/24/39 in the
full set) split into _part1/_part2 the same way
(`nds/nds_gen_query_stream.py:91-103`).

Template coverage grows with the engine; TEMPLATES lists what is
implemented so stream generation and the orchestrator agree on the set.

Port copy of ``nds_tpu/nds/streams.py`` (``available_templates``,
``random_params``, ``render_query``, the 99 templates byte for byte, and
the stream files: ``stream_order``, ``generate_query_streams`` and
``parse_query_stream``), plus ``power_units``, the power run's units
as the bench entry times them.
"""

from __future__ import annotations

import os
import random
import re
from collections import OrderedDict

TEMPLATE_DIR = os.path.join(os.path.dirname(__file__), "query_templates")


def available_templates() -> list[int]:
    out = []
    for f in os.listdir(TEMPLATE_DIR):
        m = re.match(r"q(\d+)\.sql$", f)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


# qualification substitution parameters (spec-shaped defaults bound to
# the builtin generator's value domains)
QUALIFICATION: dict[int, dict] = {
    1: {"year": 2000, "state": "TX"},
    3: {"manufact": 128, "month": 11},
    6: {"year": 2001, "month": 1},
    10: {"county1": "Williamson County", "county2": "Walker County",
         "county3": "Ziebach County", "county4": "Franklin County",
         "county5": "Bronx County", "year": 2002, "month": 1},
    12: {"cat1": "Sports", "cat2": "Books", "cat3": "Home",
         "date": "1999-02-22"},
    16: {"date": "2002-02-01", "state": "GA",
         "county": "Williamson County"},
    17: {"year": 2001},
    20: {"cat1": "Sports", "cat2": "Books", "cat3": "Home",
         "date": "1999-02-22"},
    25: {"year": 2001},
    28: {"lp1": 90, "ca1": 459, "wc1": 31,
         "lp2": 142, "ca2": 1000, "wc2": 50,
         "lp3": 66, "ca3": 1500, "wc3": 20,
         "lp4": 135, "ca4": 200, "wc4": 60,
         "lp5": 28, "ca5": 800, "wc5": 40,
         "lp6": 120, "ca6": 600, "wc6": 70},
    29: {"year": 2000},
    32: {"manufact": 320, "date": "1998-03-18"},
    37: {"price": 62, "date": "2000-02-01", "m1": 129, "m2": 270,
         "m3": 821, "m4": 423},
    82: {"price": 62, "date": "2000-05-25", "m1": 129, "m2": 270,
         "m3": 821, "m4": 423},
    92: {"manufact": 350, "date": "2000-01-27"},
    94: {"date": "1999-02-01", "state": "IL", "company": "pri"},
    98: {"cat1": "Sports", "cat2": "Books", "cat3": "Home",
         "date": "1999-02-22"},
    7: {"gender": "M", "marital": "S", "education": "College",
        "year": 2000},
    18: {"gender": "F", "education": "Unknown", "year": 1998,
         "m1": 1, "m2": 6, "m3": 8, "m4": 9, "m5": 12, "m6": 2,
         "s1": "MS", "s2": "IN", "s3": "ND", "s4": "OK", "s5": "NM",
         "s6": "VA", "s7": "MS"},
    21: {"date": "1998-02-01"},
    22: {"dms": 1176},
    27: {"gender": "M", "marital": "S", "education": "College",
         "year": 2000, "s1": "FL", "s2": "IL", "s3": "KY", "s4": "LA",
         "s5": "PA", "s6": "SD"},
    30: {"year": 2002, "state": "GA"},
    33: {"category": "Electronics", "year": 1998, "month": 5,
         "gmt": -5},
    35: {"year": 2002},
    38: {"dms": 1212},
    40: {"date": "2000-03-11"},
    41: {"manufact": 738},
    50: {"year": 2001, "month": 8},
    76: {},
    85: {"year": 2000},
    87: {"dms": 1212},
    4: {"year": 1999},
    8: {"qoy": 2, "year": 1998},
    14: {"year": 1999},
    23: {"year": 1999, "month": 5},
    24: {"market": 5, "c1": "beige", "c2": "azure"},
    39: {"year": 1998, "month": 1},
    64: {"year": 1999, "price": 15,
         "c1": "azure", "c2": "beige", "c3": "black", "c4": "blue",
         "c5": "brown", "c6": "coral"},
    66: {"year": 1999, "time": 30000, "smc1": "UPS", "smc2": "FEDEX"},
    67: {"dms": 1200},
    72: {"bp": ">10000", "ms": "M", "year": 1999},
    75: {"category": "Home", "year": 2000},
    78: {"year": 1999},
    51: {"dms": 1200},
    97: {"dms": 1200},
    34: {"year": 1999, "bp1": ">10000", "bp2": "Unknown",
         "county1": "Barrow County", "county2": "Bronx County",
         "county3": "Maverick County", "county4": "Mobile County",
         "county5": "Orange County", "county6": "Barrow County",
         "county7": "Bronx County", "county8": "Orange County"},
    45: {"qoy": 1, "year": 2000},
    46: {"dep": 5, "veh": 3, "year": 1999, "city1": "Midway",
         "city2": "Bethel"},
    49: {"ramt": 10, "year": 2000, "month": 12},
    54: {"category": "Music", "class": "musicclass5", "month": 4,
         "year": 1999},
    56: {"c1": "azure", "c2": "beige", "c3": "black", "year": 2000,
         "month": 2, "gmt": -5},
    58: {"date": "2000-03-24"},
    60: {"category": "Children", "year": 1999, "month": 9, "gmt": -5},
    81: {"year": 1999, "state": "TX"},
    83: {"date1": "1998-03-20", "date2": "1999-06-14",
         "date3": "2000-11-17"},
    95: {"date": "1999-02-01", "state": "TX", "company": "able"},
    2: {"year": 1998},
    5: {"date": "2000-08-19"},
    11: {"year": 1999},
    31: {"year": 2000},
    59: {"dms": 1200},
    71: {"manager": 1, "month": 12, "year": 1999},
    74: {"year": 1999},
    77: {"date": "2000-08-19"},
    80: {"date": "2000-08-19"},
    36: {"year": 2000, "s1": "FL", "s2": "IL", "s3": "KY", "s4": "LA",
         "s5": "PA", "s6": "SD"},
    44: {"store": 4},
    47: {"year": 2000},
    53: {"dms": 1190},
    57: {"year": 2000},
    63: {"dms": 1190},
    70: {"dms": 1212},
    86: {"dms": 1212},
    89: {"year": 1999},
    9: {"t1": 3000, "t2": 3000, "t3": 3000, "t4": 3000, "t5": 3000},
    13: {"year": 2001, "ms1": "M", "es1": "Advanced Degree",
         "ms2": "S", "es2": "College", "ms3": "W", "es3": "2 yr Degree",
         "s1": "TX", "s2": "OH", "s3": "TX", "s4": "OR", "s5": "NM",
         "s6": "KY", "s7": "VA", "s8": "TX", "s9": "MS"},
    15: {"qoy": 2, "year": 2001},
    19: {"manager": 8, "month": 11, "year": 1998},
    26: {"gender": "M", "marital": "S", "education": "College",
         "year": 2000},
    42: {"month": 11, "year": 2000},
    43: {"gmt": -5, "year": 2000},
    48: {"year": 2000, "ms1": "M", "es1": "4 yr Degree", "ms2": "D",
         "es2": "2 yr Degree", "ms3": "S", "es3": "College",
         "s1": "TX", "s2": "OH", "s3": "TX", "s4": "OR", "s5": "NM",
         "s6": "KY", "s7": "VA", "s8": "TX", "s9": "MS"},
    52: {"month": 11, "year": 2000},
    55: {"manager": 28, "month": 11, "year": 1999},
    61: {"gmt": -5, "category": "Jewelry", "year": 1998},
    62: {"dms": 1200},
    65: {"dms": 1176},
    68: {"dep": 4, "veh": 3, "year": 1999, "city1": "Midway",
         "city2": "Fairview"},
    69: {"s1": "KY", "s2": "GA", "s3": "TX", "year": 2001, "month": 4},
    73: {"year": 1999, "bp1": ">10000", "bp2": "Unknown",
         "county1": "Williamson County", "county2": "Walker County",
         "county3": "Franklin County", "county4": "Ziebach County"},
    79: {"dep": 6, "veh": 2, "year": 1999},
    84: {"city": "Fairview", "income": 38128},
    88: {"d1": 4, "d2": 2, "d3": 0},
    90: {"hour_am": 8, "hour_pm": 19, "dep": 6},
    91: {"year": 1998, "month": 11},
    93: {"reason": "Did not fit"},
    96: {"hour": 20, "dep": 7},
    99: {"dms": 1200},
}


# value domains shared with the builtin generator (datagen/tpcds.py §3
# lists); drawing from these keeps every rebinding inside the data's
# actual domain the way dsqgen's distributions do
_STATES = ["AL", "CA", "CO", "FL", "GA", "IL", "IN", "KS", "KY", "LA",
           "MI", "MN", "MO", "MS", "NC", "NE", "NY", "OH", "OK", "PA",
           "SD", "TN", "TX", "VA", "WA", "WI"]
_COUNTIES = [f"{w} County" for w in
             ["Williamson", "Walker", "Ziebach", "Franklin", "Bronx",
              "Orange", "Fairfield", "Jackson", "Barrow", "Daviess",
              "Luce", "Richland", "Furnas", "Maverick", "Huron",
              "Kittitas", "Mobile", "Coal", "Lunenburg", "Ferry"]]
_CITIES = ["Midway", "Fairview", "Oak Grove", "Five Points", "Oakland",
           "Riverside", "Salem", "Georgetown", "Greenfield", "Liberty",
           "Bethel", "Pleasant Hill", "Lebanon", "Springdale", "Shiloh",
           "Mount Olive", "Glendale", "Marion", "Greenville", "Union"]
_CATEGORIES = ["Books", "Children", "Electronics", "Home", "Jewelry",
               "Men", "Music", "Shoes", "Sports", "Women"]
_EDUCATION = ["Primary", "Secondary", "College", "2 yr Degree",
              "4 yr Degree", "Advanced Degree", "Unknown"]
_MARITAL = ["S", "M", "D", "W", "U"]
_BUY_POTENTIAL = ["0-500", "501-1000", "1001-5000", "5001-10000",
                  ">10000", "Unknown"]
_COLORS = ["almond", "antique", "aquamarine", "azure", "beige", "bisque",
           "black", "blue", "blush", "brown", "burlywood", "chartreuse",
           "chiffon", "chocolate", "coral", "cornflower", "cream",
           "cyan", "dark", "deep", "dim", "dodger", "drab", "firebrick",
           "floral", "forest", "frosted", "gainsboro", "ghost",
           "goldenrod", "green", "grey", "honeydew", "hot", "indian",
           "ivory", "khaki", "lace", "lavender", "lawn", "lemon",
           "light", "lime", "linen", "magenta", "maroon", "medium",
           "metallic", "midnight", "mint", "misty", "moccasin", "navajo",
           "navy", "olive", "orange", "orchid", "pale", "papaya",
           "peach", "peru", "pink", "plum", "powder", "puff", "purple",
           "red", "rose", "rosy", "royal", "saddle", "salmon", "sandy",
           "seashell", "sienna", "sky", "slate", "smoke", "snow",
           "spring", "steel", "tan", "thistle", "tomato", "turquoise",
           "violet", "wheat", "white", "yellow"]
_SM_CARRIERS = ["UPS", "FEDEX", "AIRBORNE", "USPS", "DHL", "TBS",
                "ZHOU", "ZOUROS", "MSC", "LATVIAN", "DIAMOND",
                "ALLIANCE", "ORIENTAL", "BARIAN", "BOXBUNDLES",
                "HARMSTORF", "PRIVATECARRIER", "GERMA", "RUPEKSA",
                "GREAT EASTERN"]
_REASONS = ["Package was damaged", "Stopped working",
            "Did not get it on time", "Not the product that was ordred",
            "Parts missing", "Does not work with a product that I have",
            "Gift exchange", "Did not like the color",
            "Did not like the model", "Did not like the make",
            "Did not fit"]
_WEB_COMPANIES = ["pri", "able", "ought", "ation", "bar", "ese"]
_GMT = [-5, -6, -7, -8]
# sales rows land in 1998-2002 (datagen SALES_DATE_LO/HI); d_month_seq
# = (year-1900)*12 + moy - 1, so the 1998-2002 window is seq 1176-1235
_YEARS = (1998, 2002)
_DMS = (1176, 1224)  # leaves +11 months of headroom for dms..dms+11


def _distinct(rng, pool, k):
    return rng.sample(list(pool), k)


def _date(rng, y_lo=1998, y_hi=2002, m_lo=1, m_hi=12, day=None):
    y = rng.randint(y_lo, y_hi)
    m = rng.randint(m_lo, m_hi)
    d = day if day is not None else rng.randint(1, 28)
    return f"{y:04d}-{m:02d}-{d:02d}"


def random_params(template_number: int, rng, stream: int) -> dict:
    """Per-stream substitution parameters (reference: dsqgen -rngseed
    redraws bindings per stream, `nds/nds_gen_query_stream.py:42-89`, so
    concurrent throughput streams are DISTINCT workloads, not N copies).
    Distributions follow the spec's parameter domains restricted to the
    builtin generator's §3 value lists; templates keep the same keys as
    QUALIFICATION, so a draw is a drop-in replacement."""
    q = template_number
    year = lambda lo=1998, hi=2002: rng.randint(lo, hi)
    dms = lambda: rng.randint(*_DMS)
    manufact = lambda: rng.randint(1, 1000)
    gmt = lambda: rng.choice(_GMT)
    if q == 1:
        return {"year": year(1998, 2000), "state": rng.choice(_STATES)}
    if q == 3:
        return {"manufact": manufact(), "month": rng.randint(11, 12)}
    if q == 6:
        return {"year": year(), "month": rng.randint(1, 8)}
    if q == 10:
        c = _distinct(rng, _COUNTIES, 5)
        return {**{f"county{i}": c[i - 1] for i in range(1, 6)},
                "year": year(1999, 2002), "month": rng.randint(1, 4)}
    if q in (12, 20, 98):
        c = _distinct(rng, _CATEGORIES, 3)
        return {"cat1": c[0], "cat2": c[1], "cat3": c[2],
                "date": _date(rng, 1998, 2002, 1, 7)}
    if q == 16:
        return {"date": _date(rng, 1999, 2002, 1, 12, day=1),
                "state": rng.choice(_STATES),
                "county": rng.choice(_COUNTIES)}
    if q in (17, 25):
        return {"year": year(1998, 2001)}
    if q == 28:
        out = {}
        for i in range(1, 7):
            out[f"lp{i}"] = rng.randint(0, 190)
            out[f"ca{i}"] = rng.randint(0, 2000)
            out[f"wc{i}"] = rng.randint(0, 80)
        return out
    if q == 29:
        return {"year": year(1998, 2000)}
    if q in (32, 92):
        return {"manufact": manufact(), "date": _date(rng)}
    if q in (37, 82):
        ms = _distinct(rng, range(1, 1001), 4)
        return {"price": rng.randint(10, 90), "date": _date(rng),
                **{f"m{i}": ms[i - 1] for i in range(1, 5)}}
    if q in (94, 95):
        return {"date": _date(rng, 1999, 2002, 1, 10, day=1),
                "state": rng.choice(_STATES),
                "company": rng.choice(_WEB_COMPANIES)}
    if q in (7, 26):
        return {"gender": rng.choice("MF"),
                "marital": rng.choice(_MARITAL),
                "education": rng.choice(_EDUCATION), "year": year()}
    if q == 18:
        ms = _distinct(rng, range(1, 13), 6)
        ss = [rng.choice(_STATES) for _ in range(7)]
        return {"gender": rng.choice("MF"),
                "education": rng.choice(_EDUCATION), "year": year(),
                **{f"m{i}": ms[i - 1] for i in range(1, 7)},
                **{f"s{i}": ss[i - 1] for i in range(1, 8)}}
    if q == 21:
        return {"date": _date(rng, 1998, 2002, 1, 12, day=1)}
    if q in (22, 38, 51, 53, 59, 62, 63, 65, 67, 70, 86, 87, 97, 99):
        return {"dms": dms()}
    if q == 24:
        c = _distinct(rng, _COLORS, 2)
        return {"market": rng.randint(1, 10), "c1": c[0], "c2": c[1]}
    if q == 27:
        ss = _distinct(rng, _STATES, 6)
        return {"gender": rng.choice("MF"),
                "marital": rng.choice(_MARITAL),
                "education": rng.choice(_EDUCATION), "year": year(),
                **{f"s{i}": ss[i - 1] for i in range(1, 7)}}
    if q in (30, 81):
        return {"year": year(1999, 2002), "state": rng.choice(_STATES)}
    if q in (33, 56, 60):
        out = {"year": year(), "month": rng.randint(1, 12),
               "gmt": gmt()}
        if q == 56:
            c = _distinct(rng, _COLORS, 3)
            out.update({"c1": c[0], "c2": c[1], "c3": c[2]})
        else:
            out["category"] = rng.choice(_CATEGORIES)
        return out
    if q in (35, 69):
        out = {"year": year(1999, 2002), "month": rng.randint(1, 4)}
        if q == 69:
            ss = _distinct(rng, _STATES, 3)
            out.update({f"s{i}": ss[i - 1] for i in range(1, 4)})
        return out
    if q == 40:
        return {"date": _date(rng)}
    if q == 41:
        return {"manufact": manufact()}
    if q == 50:
        return {"year": year(1999, 2002), "month": rng.randint(8, 10)}
    if q == 85:
        return {"year": year()}
    if q in (4, 11, 74):
        return {"year": year(1998, 2001)}
    if q == 8:
        return {"qoy": rng.randint(1, 2), "year": year()}
    if q == 14:
        return {"year": year(1998, 2000)}
    if q == 23:
        return {"year": year(1998, 2000), "month": rng.randint(1, 7)}
    if q == 39:
        return {"year": year(), "month": rng.randint(1, 11)}
    if q == 64:
        c = _distinct(rng, _COLORS, 6)
        return {"year": year(1998, 2001), "price": rng.randint(0, 85),
                **{f"c{i}": c[i - 1] for i in range(1, 7)}}
    if q == 66:
        sm = _distinct(rng, _SM_CARRIERS, 2)
        return {"year": year(), "time": rng.randint(1, 57600),
                "smc1": sm[0], "smc2": sm[1]}
    if q == 72:
        return {"bp": rng.choice(_BUY_POTENTIAL),
                "ms": rng.choice(_MARITAL), "year": year()}
    if q == 75:
        return {"category": rng.choice(_CATEGORIES),
                "year": year(1998, 2001)}
    if q == 78:
        return {"year": year()}
    if q == 34:
        bp = _distinct(rng, _BUY_POTENTIAL, 2)
        return {"year": year(1998, 2000), "bp1": bp[0], "bp2": bp[1],
                **{f"county{i}": rng.choice(_COUNTIES)
                   for i in range(1, 9)}}
    if q == 45:
        return {"qoy": rng.randint(1, 4), "year": year()}
    if q in (46, 68):
        cities = _distinct(rng, _CITIES, 2)
        return {"dep": rng.randint(0, 9), "veh": rng.randint(-1, 4),
                "year": year(1998, 2000), "city1": cities[0],
                "city2": cities[1]}
    if q == 49:
        return {"ramt": rng.randint(5, 15), "year": year(),
                "month": rng.randint(11, 12)}
    if q == 54:
        cat = rng.choice(_CATEGORIES)
        return {"category": cat,
                "class": f"{cat.lower()}class{rng.randint(1, 16)}",
                "month": rng.randint(1, 7), "year": year()}
    if q == 58:
        return {"date": _date(rng)}
    if q == 83:
        return {"date1": _date(rng), "date2": _date(rng),
                "date3": _date(rng)}
    if q in (2, 31):
        return {"year": year(1998, 2001)}
    if q in (5, 77, 80):
        return {"date": _date(rng)}
    if q == 71:
        return {"manager": rng.randint(1, 100),
                "month": rng.randint(11, 12), "year": year()}
    if q == 36:
        ss = _distinct(rng, _STATES, 6)
        return {"year": year(),
                **{f"s{i}": ss[i - 1] for i in range(1, 7)}}
    if q == 44:
        return {"store": rng.randint(1, 6)}
    if q in (47, 57):
        return {"year": year(1999, 2001)}
    if q == 89:
        return {"year": year()}
    if q == 9:
        return {f"t{i}": rng.randint(1000, 5000) for i in range(1, 6)}
    if q in (13, 48):
        ms = _distinct(rng, _MARITAL, 3)
        es = _distinct(rng, _EDUCATION, 3)
        out = {"year": year(),
               **{f"ms{i}": ms[i - 1] for i in range(1, 4)},
               **{f"es{i}": es[i - 1] for i in range(1, 4)},
               **{f"s{i}": rng.choice(_STATES) for i in range(1, 10)}}
        return out
    if q == 15:
        return {"qoy": rng.randint(1, 4), "year": year()}
    if q in (19, 55):
        return {"manager": rng.randint(1, 100),
                "month": rng.randint(11, 12), "year": year()}
    if q in (42, 52):
        return {"month": rng.randint(11, 12), "year": year()}
    if q == 43:
        return {"gmt": gmt(), "year": year()}
    if q == 61:
        return {"gmt": gmt(), "category": rng.choice(_CATEGORIES),
                "year": year()}
    if q == 73:
        bp = _distinct(rng, _BUY_POTENTIAL, 2)
        c = _distinct(rng, _COUNTIES, 4)
        return {"year": year(1998, 2000), "bp1": bp[0], "bp2": bp[1],
                **{f"county{i}": c[i - 1] for i in range(1, 5)}}
    if q == 79:
        return {"dep": rng.randint(0, 9), "veh": rng.randint(-1, 4),
                "year": year(1998, 2000)}
    if q == 84:
        return {"city": rng.choice(_CITIES),
                "income": rng.randint(0, 70000)}
    if q == 88:
        d = _distinct(rng, range(0, 10), 3)
        return {"d1": d[0], "d2": d[1], "d3": d[2]}
    if q == 90:
        return {"hour_am": rng.randint(6, 12),
                "hour_pm": rng.randint(13, 20), "dep": rng.randint(0, 9)}
    if q == 91:
        return {"year": year(), "month": rng.randint(11, 12)}
    if q == 93:
        return {"reason": rng.choice(_REASONS)}
    if q == 96:
        return {"hour": rng.randint(8, 20), "dep": rng.randint(0, 9)}
    if q == 76:
        return {}
    # any template without an explicit distribution falls back to its
    # qualification bindings (still a valid, spec-shaped draw)
    return dict(QUALIFICATION.get(q, {}))


def render_query(template_number: int, params: dict | None = None) -> str:
    with open(os.path.join(TEMPLATE_DIR, f"q{template_number}.sql")) as f:
        tpl = f.read()
    if params is None:
        params = QUALIFICATION.get(template_number, {})
    return tpl.format(**params)


def stream_order(stream: int, rng_seed: int | None = None,
                 templates: list[int] | None = None) -> list[int]:
    order = list(templates if templates is not None
                 else available_templates())
    if stream == 0:
        return order
    rng = random.Random((rng_seed or 0) * 1000 + stream)
    rng.shuffle(order)
    return order


def generate_query_streams(output_dir: str, streams: int,
                           rng_seed: int | None = None,
                           templates: list[int] | None = None,
                           qualification: bool = True) -> list[str]:
    """Write query_{i}.sql stream files (query_0.sql .. query_N.sql).

    qualification=False redraws every template's substitution parameters
    per stream from a (rng_seed, stream)-seeded generator (dsqgen's
    ``-rngseed``), so throughput streams differ in bindings as well as
    order."""
    os.makedirs(output_dir, exist_ok=True)
    paths = []
    for i in range(streams):
        rng = random.Random((rng_seed or 0) * 7919 + i)
        parts = []
        for qn in stream_order(i, rng_seed, templates):
            params = None if qualification else random_params(qn, rng, i)
            sql = render_query(qn, params)
            parts.append(
                f"-- start query {qn} in stream {i} using template "
                f"query{qn}.tpl\n{sql}\n-- end query {qn} in stream {i} "
                f"using template query{qn}.tpl\n")
        path = os.path.join(output_dir, f"query_{i}.sql")
        with open(path, "w") as f:
            f.write("\n".join(parts))
        paths.append(path)
    return paths


_MARKER_RE = re.compile(
    r"-- start query (\d+) in stream \d+ using template "
    r"query(\d+)\.tpl\n(.*?)-- end query \1 in stream",
    re.DOTALL)


def parse_query_stream(path: str) -> "OrderedDict[str, str]":
    """Stream file -> {query_name: sql}, splitting multi-statement
    templates into _part1/_part2."""
    with open(path) as f:
        stream = f.read()
    queries: "OrderedDict[str, str]" = OrderedDict()
    for _num, tpl, body in _MARKER_RE.findall(stream):
        stmts = [s.strip() for s in body.split(";") if s.strip()]
        if len(stmts) == 1:
            queries[f"query{tpl}"] = stmts[0]
        else:
            for i, s in enumerate(stmts, 1):
                queries[f"query{tpl}_part{i}"] = s
    return queries


def power_units(templates: "list[int] | None" = None) -> list:
    """[(name, [statement]), ...]: one unit per timed statement of the
    power run, as ``bench.py``'s ``_leg_units`` times the NDS leg. A
    two-statement template (q14, q23, q24, q39) gives one unit per
    statement, named ``<n>_part<i>``; the 99 templates give 103 units."""
    units = []
    for qn in (templates if templates is not None
               else available_templates()):
        stmts = [s.strip() for s in render_query(qn).split(";")
                 if s.strip()]
        if len(stmts) == 1:
            units.append((str(qn), stmts))
        else:
            units.extend((f"{qn}_part{i}", [s])
                         for i, s in enumerate(stmts, 1))
    return units
