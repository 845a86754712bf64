"""The port's raw warehouse IO against the JAX package's (``nds_tpu``).

- ``gen_data``: the port's NDS-H (2 chunks) and NDS (2 chunks) raw files
  are byte for byte the reference's (``dbgen_version`` but its day and
  time of writing).
- ``read_tbl``: the port's reader gives exactly the reference's
  ``HostTable`` for every table of both suites (values, dtypes,
  dictionaries, null masks, NDS's empty fields), and for hand-written
  files with the edge cases of the text format (every null spelling,
  signs, short fractions, empty lines, no final newline).
- A parquet warehouse written by the reference's ``transcode`` loads
  through the port's ``load_warehouse`` into the same tables.
- Result files: either package's ``write_result`` is read by the other's
  ``read_result`` into equal frames, and the two ``result_digest``s
  agree.
- The port's NDS-H power CLI runs the ``raw`` warehouse and the one
  the port's ``transcode`` CLI wrote from it into the same results.
"""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from nds_tpu.engine.cpu_exec import ResultTable as RefResult
from nds_tpu.engine.types import (
    DATE, INT32, INT64, FLOAT64, Schema as RefSchema, decimal as ref_decimal,
    varchar as ref_varchar,
)
from nds_tpu.io import csv_io as ref_csv
from nds_tpu.io import result_io as ref_result
from nds_tpu.nds import gen_data as ref_nds_gen
from nds_tpu.nds.schema import get_schemas as ref_nds_schemas
from nds_tpu.nds_h import gen_data as ref_h_gen
from nds_tpu.nds_h.schema import get_schemas as ref_h_schemas
from nds_tpu_torch.engine import types as T
from nds_tpu_torch.engine.cpu_exec import ResultTable
from nds_tpu_torch.engine.session import Session
from nds_tpu_torch.io import csv_io
from nds_tpu_torch.io import result_io
from nds_tpu_torch.nds import gen_data as nds_gen
from nds_tpu_torch.nds.schema import get_schemas as nds_schemas
from nds_tpu_torch.nds_h import gen_data as h_gen
from nds_tpu_torch.nds_h import power as h_power
from nds_tpu_torch.nds_h.schema import get_schemas as h_schemas
from nds_tpu_torch.utils import power_core

REPO = pathlib.Path(__file__).resolve().parent.parent
SF = 0.01
SUITES = {"nds_h": (h_gen, ref_h_gen, h_schemas, ref_h_schemas),
          "nds": (nds_gen, ref_nds_gen, nds_schemas, ref_nds_schemas)}


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """Both packages' generated raw data of both suites, 2 chunks."""
    root = tmp_path_factory.mktemp("power_io")
    out = {}
    for suite, (port, ref, _s, _r) in SUITES.items():
        p, r = str(root / f"port_{suite}"), str(root / f"ref_{suite}")
        port.generate_data_local(SF, 2, p, workers=2)
        ref.generate_data_local(SF, 2, r, workers=2)
        out[suite] = (p, r)
    return out


def _files(root: str) -> dict:
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.mark.parametrize("suite", list(SUITES))
def test_gen_data_writes_the_reference_bytes(suite, raw):
    port, ref = raw[suite]
    got, exp = _files(port), _files(ref)
    assert sorted(got) == sorted(exp)
    assert len(got) > (8 if suite == "nds_h" else 24)
    for rel in exp:
        g, e = got[rel], exp[rel]
        if rel.startswith("dbgen_version"):
            # the day and time it was written
            when = re.compile(rb"\|\d{4}-\d\d-\d\d\|\d\d:\d\d:\d\d\|")
            g, e = when.sub(b"|T|", g), when.sub(b"|T|", e)
        assert g == e, rel


def _table_paths(root: str, table: str) -> list:
    d = os.path.join(root, table)
    return sorted(os.path.join(d, f) for f in os.listdir(d))


def assert_same_table(got, exp, what: str):
    """The same columns, dtypes, values, dictionaries and null masks."""
    assert list(got.columns) == list(exp.columns), what
    for name in exp.columns:
        g, e = got.columns[name], exp.columns[name]
        w = f"{what}.{name}"
        assert repr(g.dtype) == repr(e.dtype), w
        assert g.values.dtype == e.values.dtype, w
        np.testing.assert_array_equal(g.values, e.values, err_msg=w)
        assert (g.dictionary is None) == (e.dictionary is None), w
        if e.dictionary is not None:
            assert g.dictionary.dtype == e.dictionary.dtype, w
            assert list(g.dictionary) == list(e.dictionary), w
        assert (g.null_mask is None) == (e.null_mask is None), w
        if e.null_mask is not None:
            np.testing.assert_array_equal(g.null_mask, e.null_mask,
                                          err_msg=w)


TABLES = ([("nds_h", t) for t in h_schemas()]
          + [("nds", t) for t in nds_schemas()])


@pytest.mark.parametrize("suite,table", TABLES)
def test_read_tbl_gives_the_reference_table(suite, table, raw):
    _p, _r, schemas, ref_schemas = SUITES[suite]
    paths = _table_paths(raw[suite][0], table)
    exp = ref_csv.read_tbl(paths, table, ref_schemas()[table])
    got = csv_io.read_tbl(paths, table, schemas()[table])
    assert got.nrows == exp.nrows > 0
    assert_same_table(got, exp, table)


def test_nds_empty_fields_are_nulls(raw):
    """dsdgen's NULL convention (an empty field) reads as the reference
    reads it: a null mask in numeric columns."""
    paths = _table_paths(raw["nds"][0], "store_sales")
    got = csv_io.read_tbl(paths, "store_sales", nds_schemas()["store_sales"])
    mask = got.columns["ss_customer_sk"].null_mask
    assert mask is not None and not mask.all()


# the text format's edge cases: every column type with each way a field
# can be written (empty, each null spelling, signs, short fractions)
EDGE_COLUMNS = [("i", "int32"), ("l", "int64"), ("d", "dec"),
                ("w", "wide"), ("t", "date"), ("s", "str"), ("f", "f64")]
EDGE_ROWS = [
    "1|-9000000000|12.50|123456789012.34|1998-12-01|abc|1.5|",
    "|0|-0.07||1970-01-01||-2.25e3|",
    "-7|NULL|7|-1|2000-02-29|NULL|nan|",
    "NA|null|-3.1|0.00|NaN|Zebra|N/A|",
    "2147483647|#N/A|.5|99|n/a| spaced |-0.0|",
    "0|5|-12.|5.5|2024-12-31|é|1e-300|",
]


def _edge_schemas():
    port = {"int32": T.INT32, "int64": T.INT64, "dec": T.decimal(7, 2),
            "wide": T.decimal(17, 2), "date": T.DATE,
            "str": T.varchar(20), "f64": T.FLOAT64}
    ref = {"int32": INT32, "int64": INT64, "dec": ref_decimal(7, 2),
           "wide": ref_decimal(17, 2), "date": DATE,
           "str": ref_varchar(20), "f64": FLOAT64}
    return (T.Schema.of(*[(n, port[k], True) for n, k in EDGE_COLUMNS]),
            RefSchema.of(*[(n, ref[k], True) for n, k in EDGE_COLUMNS]))


@pytest.mark.parametrize("layout", ["plain", "empty_lines", "no_newline",
                                    "two_files"])
def test_read_tbl_edge_cases_match_the_reference(layout, tmp_path):
    body = "\n".join(EDGE_ROWS) + "\n"
    if layout == "empty_lines":
        body = "\n" + body.replace("\n", "\n\n", 2)
    elif layout == "no_newline":
        body = body.rstrip("\n")
    paths = [str(tmp_path / "a.tbl")]
    with open(paths[0], "w") as f:
        f.write(body)
    if layout == "two_files":
        paths.append(str(tmp_path / "b.tbl"))
        with open(paths[1], "w") as f:
            f.write("\n".join(EDGE_ROWS[::-1]) + "\n")
        paths.append(str(tmp_path / "empty.tbl"))
        open(paths[2], "w").close()
    port_schema, ref_schema = _edge_schemas()
    exp = ref_csv.read_tbl(paths, "edge", ref_schema)
    got = csv_io.read_tbl(paths, "edge", port_schema)
    assert got.nrows == exp.nrows >= len(EDGE_ROWS)
    assert_same_table(got, exp, layout)


@pytest.mark.parametrize("row,why", [
    ("1|2|3.456|4|1998-01-01|x|1|", "more decimal places than the scale"),
    ("1|2|3|4|1998-02-30|x|1|", "no such day"),
    ("1x|2|3|4|1998-01-01|x|1|", "not a number"),
    ("1|2|3|4|1998-01-01|x|1|extra|", "a field too many"),
    ("3000000000|2|3|4|1998-01-01|x|1|", "beyond int32"),
])
def test_read_tbl_refuses_what_the_reference_refuses(row, why, tmp_path):
    path = str(tmp_path / "bad.tbl")
    with open(path, "w") as f:
        f.write(EDGE_ROWS[0] + "\n" + row + "\n")
    port_schema, ref_schema = _edge_schemas()
    with pytest.raises(Exception):
        ref_csv.read_tbl([path], "edge", ref_schema)
    with pytest.raises(ValueError):
        csv_io.read_tbl([path], "edge", port_schema)


def test_reference_parquet_warehouse_loads_the_same_tables(raw, tmp_path):
    from nds_tpu.nds_h.transcode import transcode
    from nds_tpu.utils import power_core as ref_power_core
    from nds_tpu.nds_h.power import SUITE as REF_SUITE
    from nds_tpu.engine.session import Session as RefSession
    wh = str(tmp_path / "wh")
    transcode(raw["nds_h"][1], wh, str(tmp_path / "load.txt"))
    port = Session.for_nds_h()
    setup = power_core.load_warehouse(h_power.SUITE, port, wh, "parquet")
    assert sorted(setup) == sorted(h_schemas())
    ref = RefSession.for_nds_h()
    ref_power_core.load_warehouse(REF_SUITE, ref, wh, "parquet")
    for name, table in ref.tables.items():
        assert_same_table(port.tables[name], table, name)
    # and the raw files load into the tables the parquet files hold
    raw_sess = Session.for_nds_h()
    power_core.load_warehouse(h_power.SUITE, raw_sess, raw["nds_h"][0],
                              "raw")
    for name, table in ref.tables.items():
        assert_same_table(raw_sess.tables[name], table, name)


def _results():
    """The same result in both packages' ResultTable: every dtype the
    writer maps, nulls, and a repeated output name."""
    rng = np.random.default_rng(3)
    n = 37
    cols = [rng.integers(-5, 5, n).astype(np.int64),
            rng.integers(-10**6, 10**6, n).astype(np.int64),
            rng.integers(0, 20000, n).astype(np.int32),
            np.array([f"s{v}" for v in rng.integers(0, 9, n)], dtype=object),
            rng.normal(size=n),
            rng.integers(0, 3, n).astype(np.int32)]
    valids = [None, rng.random(n) > 0.2, rng.random(n) > 0.1,
              rng.random(n) > 0.3, None, rng.random(n) > 0.5]
    names = ["k", "amount", "day", "name", "x", "k"]
    port = ResultTable(names, cols, [T.INT64, T.decimal(15, 2), T.DATE,
                                     T.varchar(10), T.FLOAT64, T.INT32],
                       valids)
    ref = RefResult(names, cols, [INT64, ref_decimal(15, 2), DATE,
                                  ref_varchar(10), FLOAT64, INT32], valids)
    return port, ref


def test_result_files_round_trip_between_the_packages(tmp_path):
    port, ref = _results()
    result_io.write_result(port, str(tmp_path / "port"))
    ref_result.write_result(ref, str(tmp_path / "ref"))
    with open(tmp_path / "port" / "part-0.parquet", "rb") as f:
        assert f.read(4) == b"PAR1"
    frames = {(w, r): reader(str(tmp_path / w))
              for w in ("port", "ref")
              for r, reader in (("port", result_io.read_result),
                                ("ref", ref_result.read_result))}
    base = frames[("ref", "ref")]
    assert list(base.columns) == ["k#0", "amount", "day", "name", "x", "k#5"]
    for key, frame in frames.items():
        pd.testing.assert_frame_equal(frame, base, obj=str(key))
    assert result_io.result_digest(port) == ref_result.result_digest(ref)
    assert result_io.result_digest(None) is None


def test_power_cli_runs_a_raw_warehouse_without_pyarrow(raw, tmp_path):
    """The power CLI runs the raw warehouse and the warehouse the port's
    own ``transcode`` CLI wrote from it (the raw reader is pyarrow's, as
    in the reference, so the name's premise, a raw path without pyarrow,
    went with the numpy reader): the same time log and summaries, and
    result files that the two runs agree on."""
    stream = str(tmp_path / "stream.sql")
    from nds_tpu_torch.nds_h.streams import generate_query_streams
    generated = generate_query_streams(str(tmp_path / "streams"), 1)
    os.replace(generated[0], stream)
    wh = str(tmp_path / "wh")
    proc = subprocess.run(
        [sys.executable, "-m", "nds_tpu_torch.nds_h.transcode",
         raw["nds_h"][0], wh, str(tmp_path / "load.txt")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    outs = {}
    for fmt, data in (("raw", raw["nds_h"][0]), ("parquet", wh)):
        tlog = str(tmp_path / f"t_{fmt}.csv")
        jsons, outs[fmt] = tmp_path / f"json_{fmt}", tmp_path / f"out_{fmt}"
        proc = subprocess.run(
            [sys.executable, "-m", "nds_tpu_torch.nds_h.power", data,
             stream, tlog, "--input_format", fmt, "--device", "cpu",
             "--json_summary_folder", str(jsons),
             "--output_prefix", str(outs[fmt]),
             "--query_subset", "query1", "query6"],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        rows = open(tlog).read().splitlines()
        assert [r.split(",")[1] for r in rows[-4:]] == [
            "query1", "query6", "Power Test Time", "Total Time"]
        assert sum(",CreateTempView " in r for r in rows) == 8
        assert len(os.listdir(jsons)) == 2
    for q in ("query1", "query6"):
        pd.testing.assert_frame_equal(
            result_io.read_result(str(outs["parquet"] / q)),
            result_io.read_result(str(outs["raw"] / q)), obj=q)
