"""The port's load phase (``transcode``) against the JAX package's.

Both suites at SF0.01, generated by the port's ``gen_data`` (2 chunks).
The port's ``transcode`` and the reference's run on the same raw files,
once per warehouse format (parquet, orc, json, avro), and:

- the two warehouses hold the same relative file paths, NDS's 30-day
  partition bands and the digest manifests included;
- the reference's ``read_table_fmt`` reads every table of the port's
  warehouse into the table it reads from its own;
- the port's ``load_warehouse`` reads the same tables;
- the port's manifests verify under the reference's
  ``integrity.verify_manifest``;
- the load report parses under both packages' ``loadreport``, and its
  lines are the reference's but for the seconds and the seed.

NDS's options, each against the reference: ``--resume`` (skips the
tables whose manifests verify, refuses other options), ``--no_partition``,
``--floats`` and ``--update`` over the refresh data of the reference's
``gen_data --update``. The power loop's ``io.verify_digests`` key makes a
load refuse a file its manifest does not match.

json and avro encode row by row in Python, so NDS's largest tables at
SF0.01 (about 2 million rows of ``customer_demographics``, ``date_dim``,
``time_dim``, ``inventory`` and ``catalog_sales``) are left out of those
two formats; ``store_sales`` and ``web_sales`` keep their partitions in.
"""

import tests.torch_threads  # noqa: F401  (first: sizes torch's threads)

import os
import re

import pytest

from nds_tpu.io import csv_io as ref_csv
from nds_tpu.io import integrity as ref_integrity
from nds_tpu.nds import gen_data as ref_nds_gen
from nds_tpu.nds import transcode as ref_nds_transcode
from nds_tpu.nds.schema import get_maintenance_schemas as ref_maint_schemas
from nds_tpu.nds.schema import get_schemas as ref_nds_schemas
from nds_tpu.nds_h import transcode as ref_h_transcode
from nds_tpu.nds_h.schema import get_schemas as ref_h_schemas
from nds_tpu.utils import loadreport as ref_loadreport
from nds_tpu_torch.engine.session import Session
from nds_tpu_torch.io import csv_io
from nds_tpu_torch.io import integrity
from nds_tpu_torch.nds import gen_data as nds_gen
from nds_tpu_torch.nds import power as nds_power
from nds_tpu_torch.nds import transcode as nds_transcode
from nds_tpu_torch.nds.schema import get_maintenance_schemas
from nds_tpu_torch.nds_h import gen_data as h_gen
from nds_tpu_torch.nds_h import power as h_power
from nds_tpu_torch.nds_h import transcode as h_transcode
from nds_tpu_torch.utils import loadreport, power_core
from nds_tpu_torch.utils.config import EngineConfig

from tests.test_torch_power_io import assert_same_table

SF = 0.01
FORMATS = ["parquet", "orc", "json", "avro"]
ROW_FORMATS = ("json", "avro")
NDS_LARGE = ("customer_demographics", "date_dim", "time_dim", "inventory",
             "catalog_sales")
SUITES = {
    "nds_h": (h_gen, h_transcode, ref_h_transcode, h_power.SUITE,
              ref_h_schemas),
    "nds": (nds_gen, nds_transcode, ref_nds_transcode, nds_power.SUITE,
            ref_nds_schemas),
}
CASES = [(s, f) for s in SUITES for f in FORMATS]


def _tables(suite: str, fmt: str):
    if suite == "nds" and fmt in ROW_FORMATS:
        return [t for t in ref_nds_schemas() if t not in NDS_LARGE]
    return None


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = tmp_path_factory.mktemp("transcode_raw")
    out = {}
    for suite, (gen, *_rest) in SUITES.items():
        out[suite] = str(root / suite)
        gen.generate_data_local(SF, 2, out[suite], workers=2)
    return out


@pytest.fixture(scope="module")
def warehouses(raw, tmp_path_factory):
    """{(suite, fmt): {"port"|"ref": (warehouse, report)}}, each pair
    transcoded on first use."""
    root = tmp_path_factory.mktemp("transcode_wh")
    made = {}

    def get(suite, fmt):
        if (suite, fmt) not in made:
            _g, port, ref, _s, _r = SUITES[suite]
            pair = {}
            for who, mod in (("port", port), ("ref", ref)):
                wh = str(root / f"{who}_{suite}_{fmt}")
                rep = str(root / f"{who}_{suite}_{fmt}.txt")
                mod.transcode(raw[suite], wh, rep, _tables(suite, fmt),
                              output_format=fmt)
                pair[who] = (wh, rep)
            made[(suite, fmt)] = pair
        return made[(suite, fmt)]
    return get


def _files(root: str) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _dirs, files in os.walk(root) for f in files)


def _table_files(wh: str, table: str, fmt: str) -> list:
    ext = csv_io.FORMAT_EXT[fmt]
    return sorted(os.path.join(d, f)
                  for d, _dirs, files in os.walk(os.path.join(wh, table))
                  for f in files if f.endswith(ext))


def _ref_tables(suite: str, fmt: str, wh: str) -> dict:
    schemas = SUITES[suite][4]()
    names = _tables(suite, fmt) or list(schemas)
    return {t: ref_csv.read_table_fmt(_table_files(wh, t, fmt), t,
                                      schemas[t], fmt) for t in names}


@pytest.mark.parametrize("suite,fmt", CASES)
def test_the_warehouses_hold_the_same_files(suite, fmt, warehouses):
    pair = warehouses(suite, fmt)
    got, exp = _files(pair["port"][0]), _files(pair["ref"][0])
    assert got == exp
    assert sum(f.endswith(integrity.MANIFEST_NAME) for f in got) == len(
        _tables(suite, fmt) or SUITES[suite][4]())
    if suite == "nds":
        assert any(f.startswith("store_sales/ss_sold_date_sk=")
                   for f in got)


@pytest.mark.parametrize("suite,fmt", CASES)
def test_the_reference_reads_the_port_warehouse(suite, fmt, warehouses):
    pair = warehouses(suite, fmt)
    got = _ref_tables(suite, fmt, pair["port"][0])
    exp = _ref_tables(suite, fmt, pair["ref"][0])
    assert list(got) == list(exp)
    for name, table in exp.items():
        assert got[name].nrows == table.nrows
        assert_same_table(got[name], table, f"{fmt}:{name}")


@pytest.mark.parametrize("suite,fmt", CASES)
def test_load_warehouse_reads_the_same_tables(suite, fmt, warehouses):
    pair = warehouses(suite, fmt)
    _g, _p, _r, SUITE, _s = SUITES[suite]
    sess = Session.for_nds_h() if suite == "nds_h" else Session.for_nds()
    setup = power_core.load_warehouse(SUITE, sess, pair["port"][0], fmt,
                                      tables=_tables(suite, fmt))
    exp = _ref_tables(suite, fmt, pair["ref"][0])
    assert sorted(setup) == sorted(exp)
    for name, table in exp.items():
        assert_same_table(sess.tables[name], table, f"{fmt}:{name}")


@pytest.mark.parametrize("suite,fmt", CASES)
def test_the_port_manifests_verify_under_the_reference(suite, fmt,
                                                       warehouses):
    wh = warehouses(suite, fmt)["port"][0]
    names = _tables(suite, fmt) or list(SUITES[suite][4]())
    for name in names:
        assert ref_integrity.verify_manifest(os.path.join(wh, name)), name
        assert integrity.verify_manifest(os.path.join(wh, name)), name


def _report_shape(path: str) -> list:
    with open(path) as f:
        text = f.read()
    text = re.sub(r"\d+\.\d+s", "<s>", text)
    return re.sub(r"RNGSEED used: \d+", "RNGSEED used: <seed>",
                  text).splitlines()


@pytest.mark.parametrize("suite,fmt", CASES)
def test_the_load_report_is_the_reference_report(suite, fmt, warehouses):
    pair = warehouses(suite, fmt)
    rep, ref_rep = pair["port"][1], pair["ref"][1]
    assert _report_shape(rep) == _report_shape(ref_rep)
    assert loadreport.get_load_time(rep) == ref_loadreport.get_load_time(rep)
    assert loadreport.get_load_time(rep) > 0
    assert loadreport.get_rngseed(rep) == ref_loadreport.get_rngseed(rep) > 0
    # the CLI's module re-exports the parsers, as the reference's does
    _g, port, _r, _s, _x = SUITES[suite]
    assert port.get_rngseed(rep) == loadreport.get_rngseed(rep)


# NDS's options, on a few tables: a partitioned fact with NULL partition
# keys, a returns fact, and dimensions with strings and decimals
OPTION_TABLES = ["store_sales", "web_returns", "item", "store"]


def _both(raw_dir, root, tag, **kw):
    """Port and reference transcode of ``raw_dir`` with ``kw``; returns
    {"port"|"ref": (warehouse, report, stdout lines)}."""
    out = {}
    for who, mod in (("port", nds_transcode), ("ref", ref_nds_transcode)):
        wh, rep = str(root / f"{who}_{tag}"), str(root / f"{who}_{tag}.txt")
        out[who] = (wh, rep)
        mod.transcode(raw_dir, wh, rep, **kw)
    return out


def _assert_same_warehouse(pair, schemas, fmt="parquet"):
    port_wh, ref_wh = pair["port"][0], pair["ref"][0]
    assert _files(port_wh) == _files(ref_wh)
    for name, schema in schemas.items():
        if not os.path.isdir(os.path.join(ref_wh, name)):
            continue
        exp = ref_csv.read_table_fmt(_table_files(ref_wh, name, fmt), name,
                                     schema, fmt)
        got = ref_csv.read_table_fmt(_table_files(port_wh, name, fmt), name,
                                     schema, fmt)
        assert_same_table(got, exp, name)


@pytest.mark.parametrize("option", ["no_partition", "floats"])
def test_nds_options_match_the_reference(option, raw, tmp_path):
    kw = ({"partition": False} if option == "no_partition"
          else {"use_decimal": False})
    pair = _both(raw["nds"], tmp_path, option, tables=OPTION_TABLES, **kw)
    _assert_same_warehouse(pair,
                           ref_nds_schemas(use_decimal=option != "floats"))
    files = _files(pair["port"][0])
    partitioned = any("ss_sold_date_sk=" in f for f in files)
    assert partitioned == (option != "no_partition")
    with open(os.path.join(pair["port"][0],
                           "_transcode_options.json")) as f:
        port_opts = f.read()
    with open(os.path.join(pair["ref"][0], "_transcode_options.json")) as f:
        assert port_opts == f.read()


def test_nds_resume_skips_verified_tables_and_refuses_other_options(
        raw, tmp_path, capsys):
    pair = _both(raw["nds"], tmp_path, "resume", tables=OPTION_TABLES)
    # an interrupted load: one table's manifest torn, one table's file
    # changed after its manifest was written
    for who in ("port", "ref"):
        wh = pair[who][0]
        os.remove(os.path.join(wh, "item", integrity.MANIFEST_NAME))
        with open(os.path.join(wh, "store", "part-0.parquet"), "ab") as f:
            f.write(b"torn")
    capsys.readouterr()
    skipped = {}
    for who, mod in (("port", nds_transcode), ("ref", ref_nds_transcode)):
        wh, rep = pair[who]
        timings = mod.transcode(raw["nds"], wh, rep, tables=OPTION_TABLES,
                                resume=True)
        out = capsys.readouterr().out
        skipped[who] = (sorted(re.findall(r"Skipped table (\w+)", out)),
                        sorted(t for t, s in timings.items() if s == 0.0))
    assert skipped["port"] == skipped["ref"]
    assert skipped["port"][0] == ["store_sales", "web_returns"]
    _assert_same_warehouse(pair, ref_nds_schemas())
    for name in OPTION_TABLES:
        assert integrity.verify_manifest(os.path.join(pair["port"][0], name))
    # resuming under other options is refused by both
    for who, mod in (("port", nds_transcode), ("ref", ref_nds_transcode)):
        wh, rep = pair[who]
        with pytest.raises(ValueError, match="different transcode options"):
            mod.transcode(raw["nds"], wh, rep, tables=OPTION_TABLES,
                          resume=True, output_format="orc")


def test_nds_update_transcodes_the_refresh_tables(tmp_path):
    refresh = str(tmp_path / "refresh")
    ref_nds_gen.generate_refresh_data(0.001, 1, refresh)
    for floats in (False, True):
        assert {t: [(f.name, repr(f.dtype), f.nullable) for f in sch]
                for t, sch in get_maintenance_schemas(not floats).items()} == {
            t: [(f.name, repr(f.dtype), f.nullable) for f in sch]
            for t, sch in ref_maint_schemas(not floats).items()}
    pair = _both(refresh, tmp_path, "update", update=True)
    _assert_same_warehouse(pair, ref_maint_schemas())
    assert os.path.isdir(os.path.join(pair["port"][0], "s_purchase"))
    assert _report_shape(pair["port"][1]) == _report_shape(pair["ref"][1])


def test_power_loop_verify_digests_key_refuses_a_changed_file(
        raw, tmp_path, monkeypatch):
    """``io.verify_digests`` turns verification on for the run: a file
    whose digest no longer matches its table's manifest stops the load
    with CorruptArtifact."""
    wh, rep = str(tmp_path / "wh"), str(tmp_path / "load.txt")
    h_transcode.transcode(raw["nds_h"], wh, rep)
    with open(os.path.join(wh, "region", integrity.MANIFEST_NAME)) as f:
        doc = f.read()
    with open(os.path.join(wh, "region", integrity.MANIFEST_NAME), "w") as f:
        f.write(re.sub(r'"[0-9a-f]{64}"', '"' + "0" * 64 + '"', doc))
    integrity.clear_cache()
    monkeypatch.setenv(integrity.VERIFY_ENV, "0")
    sess = Session.for_nds_h()
    power_core.load_warehouse(h_power.SUITE, sess, wh, "parquet",
                              tables=["nation", "region"])
    assert sess.tables["region"].nrows == 5
    from nds_tpu_torch.nds_h.streams import generate_query_streams
    (stream,) = generate_query_streams(str(tmp_path / "streams"), 1)
    config = EngineConfig(overrides={"engine.device": "cpu",
                                     "io.verify_digests": "true"})
    try:
        with pytest.raises(integrity.CorruptArtifact):
            power_core.run_query_stream(
                h_power.SUITE, wh, stream, str(tmp_path / "t.csv"),
                config=config, query_subset=["query6"])
    finally:
        integrity.set_verify(None)
