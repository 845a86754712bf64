"""NDS-H query + stream generation and stream parsing.

Port copy of ``nds_tpu/nds_h/streams.py``: it imports nothing of ``nds_tpu``.

Plays the role of the reference's qgen wrapper
(`nds-h/nds_h_gen_query_stream.py:57-81`): emits either one query
(``template_number``) or N permuted 22-query streams, each query preceded
by the ``-- Template file: N`` marker the power driver parses (the
reference injects that marker into qgen.c at build time,
`nds-h/tpch-gen/Makefile:47`; here it is written directly).

Parameter substitution follows the public TPC-H v3 spec §2.4 per-query
rules; ``qualification=True`` pins the spec's validation values. The
TPC-licensed qgen can still be used instead via
``nds_tpu.datagen.toolwrap``.
"""

from __future__ import annotations

import os
import random
import re
from collections import OrderedDict

from nds_tpu_torch.datagen.tpch import (
    COLORS, NATIONS, REGIONS, SEGMENTS, SHIPMODES, TYPE_S2, TYPE_S3,
)

TEMPLATE_DIR = os.path.join(os.path.dirname(__file__), "query_templates")
NUM_QUERIES = 22

# spec §2.4 qualification (validation) parameter values
QUALIFICATION = {
    1: {"delta": 90},
    2: {"size": 15, "type": "BRASS", "region": "EUROPE"},
    3: {"segment": "BUILDING", "date": "1995-03-15"},
    4: {"date": "1993-07-01"},
    5: {"region": "ASIA", "date": "1994-01-01"},
    6: {"date": "1994-01-01", "discount": "0.06", "quantity": 24},
    7: {"nation1": "FRANCE", "nation2": "GERMANY"},
    8: {"nation": "BRAZIL", "region": "AMERICA", "type": "ECONOMY ANODIZED STEEL"},
    9: {"color": "green"},
    10: {"date": "1993-10-01"},
    11: {"nation": "GERMANY", "fraction": "0.0001"},
    12: {"shipmode1": "MAIL", "shipmode2": "SHIP", "date": "1994-01-01"},
    13: {"word1": "special", "word2": "requests"},
    14: {"date": "1995-09-01"},
    15: {"date": "1996-01-01", "stream": "0"},
    16: {"brand": "Brand#45", "type": "MEDIUM POLISHED",
         "sizes": "49, 14, 23, 45, 19, 3, 36, 9"},
    17: {"brand": "Brand#23", "container": "MED BOX"},
    18: {"quantity": 300},
    19: {"brand1": "Brand#12", "brand2": "Brand#23", "brand3": "Brand#34",
         "quantity1": 1, "quantity2": 10, "quantity3": 20},
    20: {"color": "forest", "date": "1994-01-01", "nation": "CANADA"},
    21: {"nation": "SAUDI ARABIA"},
    22: {"codes": "'13', '31', '23', '29', '30', '18', '17'"},
}


def _rand_date(rng, start_year, end_year, month=1, day=1, month_range=None):
    y = rng.randint(start_year, end_year)
    m = rng.randint(*month_range) if month_range else month
    return f"{y:04d}-{m:02d}-{day:02d}"


def random_params(template_number: int, rng: random.Random, stream: int) -> dict:
    """Spec §2.4 substitution-parameter distributions."""
    q = template_number
    brand = lambda: f"Brand#{rng.randint(1, 5)}{rng.randint(1, 5)}"
    nation = lambda: rng.choice([n for n, _ in NATIONS])
    if q == 1:
        return {"delta": rng.randint(60, 120)}
    if q == 2:
        return {"size": rng.randint(1, 50), "type": rng.choice(TYPE_S3),
                "region": rng.choice(REGIONS)}
    if q == 3:
        return {"segment": rng.choice(SEGMENTS),
                "date": f"1995-03-{rng.randint(1, 31):02d}"}
    if q == 4:
        return {"date": _rand_date(rng, 1993, 1997, month_range=(1, 10))}
    if q == 5:
        return {"region": rng.choice(REGIONS), "date": _rand_date(rng, 1993, 1997)}
    if q == 6:
        return {"date": _rand_date(rng, 1993, 1997),
                "discount": f"0.0{rng.randint(2, 9)}", "quantity": rng.randint(24, 25)}
    if q == 7:
        n1 = nation()
        n2 = nation()
        while n2 == n1:
            n2 = nation()
        return {"nation1": n1, "nation2": n2}
    if q == 8:
        n, r = rng.choice(NATIONS)
        t = f"{rng.choice(['STANDARD','SMALL','MEDIUM','LARGE','ECONOMY','PROMO'])} " \
            f"{rng.choice(TYPE_S2)} {rng.choice(TYPE_S3)}"
        return {"nation": n, "region": REGIONS[r], "type": t}
    if q == 9:
        return {"color": rng.choice(COLORS)}
    if q == 10:
        # spec 2.4.10: first of a month, 1993-02 .. 1995-01 (24 months)
        total = rng.randint(0, 23)
        y, m0 = divmod(total + 1, 12)
        return {"date": f"{1993 + y:04d}-{m0 + 1:02d}-01"}
    if q == 11:
        return {"nation": nation(), "fraction": "0.0001"}
    if q == 12:
        m1 = rng.choice(SHIPMODES)
        m2 = rng.choice([m for m in SHIPMODES if m != m1])
        return {"shipmode1": m1, "shipmode2": m2, "date": _rand_date(rng, 1993, 1997)}
    if q == 13:
        return {"word1": rng.choice(["special", "pending", "unusual", "express"]),
                "word2": rng.choice(["packages", "requests", "accounts", "deposits"])}
    if q == 14:
        return {"date": _rand_date(rng, 1993, 1997, month_range=(1, 12))}
    if q == 15:
        return {"date": _rand_date(rng, 1993, 1997, month_range=(1, 10)),
                "stream": str(stream)}
    if q == 16:
        sizes = rng.sample(range(1, 51), 8)
        t = f"{rng.choice(['STANDARD','SMALL','MEDIUM','LARGE','ECONOMY','PROMO'])} " \
            f"{rng.choice(TYPE_S2)}"
        return {"brand": brand(), "type": t, "sizes": ", ".join(map(str, sizes))}
    if q == 17:
        cont = f"{rng.choice(['SM','MED','LG','JUMBO','WRAP'])} " \
               f"{rng.choice(['CASE','BOX','BAG','JAR','PKG','PACK','CAN','DRUM'])}"
        return {"brand": brand(), "container": cont}
    if q == 18:
        return {"quantity": rng.randint(312, 315)}
    if q == 19:
        return {"brand1": brand(), "brand2": brand(), "brand3": brand(),
                "quantity1": rng.randint(1, 10), "quantity2": rng.randint(10, 20),
                "quantity3": rng.randint(20, 30)}
    if q == 20:
        return {"color": rng.choice(COLORS), "date": _rand_date(rng, 1993, 1997),
                "nation": nation()}
    if q == 21:
        return {"nation": nation()}
    if q == 22:
        codes = rng.sample(range(10, 35), 7)
        return {"codes": ", ".join(f"'{c}'" for c in codes)}
    raise ValueError(f"no such template {q}")


def render_query(template_number: int, params: dict | None = None,
                 stream: int = 0) -> str:
    with open(os.path.join(TEMPLATE_DIR, f"q{template_number}.sql")) as f:
        tpl = f.read()
    if params is None:
        params = dict(QUALIFICATION[template_number])
        if template_number == 15:
            params["stream"] = str(stream)
    return tpl.format(**params)


def statements(template_number: int, sql: str | None = None,
               stream: int = 0) -> list[str]:
    """Executable statements of one query. q15 is the multi-statement
    template (create view; select; drop view — the reference runs the
    three parts separately, `nds-h/nds_h_power.py:78-82`); every other
    query is a single statement."""
    if sql is None:
        sql = render_query(template_number, stream=stream)
    if template_number == 15:
        return [s for s in sql.split(";") if s.strip()]
    return [sql]


def stream_order(stream: int, rng_seed: int | None = None) -> list[int]:
    """Query ordering for one stream. Stream 0 (power run) is sequential,
    as with qgen; throughput streams are seeded permutations."""
    order = list(range(1, NUM_QUERIES + 1))
    if stream == 0:
        return order
    rng = random.Random((rng_seed or 0) * 1000 + stream)
    rng.shuffle(order)
    return order


def generate_query_streams(output_dir: str, streams: int,
                           rng_seed: int | None = None,
                           qualification: bool = True) -> list[str]:
    """Write stream_{i}.sql files (reference layout:
    `nds-h/nds_h_gen_query_stream.py:65-76`)."""
    os.makedirs(output_dir, exist_ok=True)
    paths = []
    for i in range(streams):
        rng = random.Random((rng_seed or 0) * 7919 + i)
        parts = []
        for qn in stream_order(i, rng_seed):
            params = None if qualification else random_params(qn, rng, i)
            sql = render_query(qn, params, stream=i)
            parts.append(f"-- Template file: {qn}\n\n{sql}\n")
        path = os.path.join(output_dir, f"stream_{i}.sql")
        with open(path, "w") as f:
            f.write("\n".join(parts))
        paths.append(path)
    return paths


def generate_single_query(output_dir: str, template_number: int,
                          qualification: bool = True,
                          rng_seed: int | None = None) -> str:
    """Write query_{N}.sql (reference: `nds-h/nds_h_gen_query_stream.py:77-81`)."""
    os.makedirs(output_dir, exist_ok=True)
    rng = random.Random(rng_seed or 0)
    params = None if qualification else random_params(template_number, rng, 0)
    path = os.path.join(output_dir, f"query_{template_number}.sql")
    with open(path, "w") as f:
        f.write(f"-- Template file: {template_number}\n\n"
                + render_query(template_number, params) + "\n")
    return path


_MARKER_RE = re.compile(
    r"-- Template file: (\d+)\n\n(.*?)(?=(?:-- Template file: \d+)|\Z)",
    re.DOTALL)


def parse_query_stream(path: str) -> "OrderedDict[str, str]":
    """Stream file -> OrderedDict of {query_name: sql}.

    Reference-compatible: marker regex and the query15 three-part split
    (create view / select / drop view) follow `nds-h/nds_h_power.py:70-87`,
    so the power driver's loop and reports line up query-for-query.
    """
    with open(path) as f:
        stream = f.read()
    queries: "OrderedDict[str, str]" = OrderedDict()
    for num, body in _MARKER_RE.findall(stream):
        if int(num) == 15:
            stmts = [s.strip() for s in body.split(";") if s.strip()]
            if len(stmts) != 3:
                raise ValueError(
                    f"query15 must have 3 statements, found {len(stmts)}")
            for i, s in enumerate(stmts, 1):
                queries[f"query{num}_part{i}"] = s
        else:
            queries[f"query{num}"] = body.strip().rstrip(";")
    return queries
