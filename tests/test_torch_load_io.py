"""The port's load-phase IO against the JAX package's (``nds_tpu``).

Each test runs the port and the reference on the same inputs, mirroring
the reference's own tests:

- the warehouse formats' round trip, the avro container (byte for byte
  the reference's file, nulls through the ``["null", T]`` unions),
  sorted string codes, and ``read_paths_auto`` over mixed formats
  (``tests/test_datagen_io.py``);
- digest manifests: a round trip, a flipped byte raising
  ``CorruptArtifact``, unmanifested files loading unverified, the gate
  off skipping the hashing, ``read_tbl`` and ``read_table_fmt``
  verifying digests, the CRC stamp and the atomic JSON writer
  (``tests/test_resilience.py``); the table cache's digest stamp and its
  columnar encodings in the same manifest;
- the load report's anchored parsing (``tests/test_nds_drivers.py``);
- ``toolwrap`` and ``gen_data``'s ``--dbgen_path``/``--dsdgen_path``
  with fake tool scripts that record their command lines
  (``tests/test_nds_drivers.py``);
- ``from_arrow``'s native string step: a parquet file with NULL strings,
  a column whose chunks have different dictionaries, an empty table,
  non-ASCII strings, a dictionary with a NULL entry and repeated
  entries.
"""

import io
import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from nds_tpu.datagen import tpch as ref_tpch
from nds_tpu.datagen import toolwrap as ref_toolwrap
from nds_tpu.engine import types as RT
from nds_tpu.io import avro_io as ref_avro
from nds_tpu.io import csv_io as ref_csv
from nds_tpu.io import integrity as ref_integrity
from nds_tpu.io.host_table import from_arrays as ref_from_arrays
from nds_tpu.nds import gen_data as ref_nds_gen
from nds_tpu.nds_h.schema import get_schemas as ref_h_schemas
from nds_tpu.utils import loadreport as ref_loadreport
from nds_tpu_torch import columnar
from nds_tpu_torch.datagen import toolwrap
from nds_tpu_torch.engine import types as T
from nds_tpu_torch.io import avro_io, csv_io, integrity, table_cache
from nds_tpu_torch.io.host_table import from_arrays
from nds_tpu_torch.nds import gen_data as nds_gen
from nds_tpu_torch.nds_h import gen_data as h_gen
from nds_tpu_torch.nds_h.schema import get_schemas as h_schemas
from nds_tpu_torch.utils import loadreport
from nds_tpu_torch.utils.report import TaskFailureCollector

from tests.test_torch_power_io import assert_same_table

SF = 0.01
FORMATS = ["parquet", "orc", "json", "avro"]


@pytest.fixture(scope="module")
def orders():
    """TPC-H orders (a quarter at SF0.01) as both packages' tables."""
    arrays = ref_tpch.gen_table("orders", SF, 4, 1)
    return (from_arrays("orders", h_schemas()["orders"], arrays),
            ref_from_arrays("orders", ref_h_schemas()["orders"], arrays))


# --------------------------------------------------------- formats

@pytest.mark.parametrize("fmt", FORMATS)
def test_format_round_trip_matches_the_reference(fmt, orders, tmp_path):
    """Each package reads the other's file into the table it reads from
    its own, and that table is the one written."""
    port, ref = orders
    ext = csv_io.FORMAT_EXT[fmt]
    assert ext == ref_csv.FORMAT_EXT[fmt]
    p, r = str(tmp_path / f"port{ext}"), str(tmp_path / f"ref{ext}")
    csv_io.write_table(port, p, fmt)
    ref_csv.write_table(ref, r, fmt)
    schema, ref_schema = h_schemas()["orders"], ref_h_schemas()["orders"]
    exp = ref_csv.read_table_fmt(r, "orders", ref_schema, fmt)
    assert exp.nrows == port.nrows
    for what, got in (
            ("port<-port", csv_io.read_table_fmt(p, "orders", schema, fmt)),
            ("port<-ref", csv_io.read_table_fmt(r, "orders", schema, fmt)),
            ("ref<-port", ref_csv.read_table_fmt(p, "orders", ref_schema,
                                                 fmt))):
        assert_same_table(got, exp, what)
    assert_same_table(csv_io.read_table_fmt(p, "orders", schema, fmt), port,
                      "written")


def test_write_parquet_round_trip(orders, tmp_path):
    port, _ref = orders
    p = str(tmp_path / "orders.parquet")
    csv_io.write_parquet(port, p)
    back = csv_io.read_parquet(p, "orders", h_schemas()["orders"])
    assert_same_table(back, port, "parquet")


def test_avro_snappy_writes_deflate_audibly(orders, tmp_path):
    port, _ref = orders
    collector = TaskFailureCollector()
    collector.register()
    try:
        csv_io.write_table(port, str(tmp_path / "o.avro"), "avro",
                           compression="snappy")
    finally:
        collector.unregister()
    assert any("deflate" in f for f in collector.failures)
    with pytest.raises(ValueError, match="unsupported avro compression"):
        csv_io.write_table(port, str(tmp_path / "x.avro"), "avro",
                           compression="zstd")
    with pytest.raises(ValueError, match="write_table"):
        csv_io.write_arrow(csv_io.to_arrow(port), str(tmp_path / "y.avro"),
                           "avro")


def _null_schemas():
    return (T.Schema.of(("k", T.INT32, False), ("v", T.decimal(12, 2), True),
                        ("s", T.varchar(10), True)),
            RT.Schema.of(("k", RT.INT32, False),
                         ("v", RT.decimal(12, 2), True),
                         ("s", RT.varchar(10), True)))


@pytest.mark.parametrize("codec", ["null", "deflate"])
def test_avro_container_layout_and_nulls(codec, tmp_path):
    sch, ref_sch = _null_schemas()
    arrays = {
        "k": np.arange(5, dtype=np.int32),
        "v": np.array([100, -205, 0, 9, 7], dtype=np.int64),
        "v#null": np.array([True, True, False, True, False]),
        "s": np.array(["a", "b", "", "d", ""], dtype=object),
        "s#null": np.array([True, True, False, True, False]),
    }
    p, r = str(tmp_path / "port.avro"), str(tmp_path / "ref.avro")
    avro_io.write_avro(from_arrays("t", sch, arrays), p, sch, codec=codec)
    ref_avro.write_avro(ref_from_arrays("t", ref_sch, arrays), r, ref_sch,
                        codec=codec)
    blob = open(p, "rb").read()
    assert blob == open(r, "rb").read()
    assert blob[:4] == b"Obj\x01"
    hdr = io.BytesIO(blob[4:])
    meta = {}
    while (cnt := avro_io._read_long(hdr)) != 0:
        for _ in range(cnt):
            key = avro_io._read_bytes(hdr).decode()
            meta[key] = avro_io._read_bytes(hdr)
    parsed = json.loads(meta["avro.schema"])
    assert meta["avro.codec"] == codec.encode()
    assert [f["name"] for f in parsed["fields"]] == ["k", "v", "s"]
    assert parsed["fields"][1]["type"][1]["logicalType"] == "decimal"
    back = avro_io.read_avro(p, "t", sch)
    assert_same_table(back, ref_avro.read_avro(p, "t", ref_sch), codec)
    assert np.array_equal(back.column("v").null_mask, arrays["v#null"])
    got_s = back.column("s").decode()
    assert [got_s[i] for i in (0, 1, 3)] == ["a", "b", "d"]
    assert got_s[2] is None and got_s[4] is None


def test_string_codes_sorted_like_the_reference(tmp_path):
    arrays = ref_tpch.gen_table("customer", SF, 8, 3)
    port = from_arrays("customer", h_schemas()["customer"], arrays)
    p = str(tmp_path / "c.parquet")
    csv_io.write_parquet(port, p)
    back = csv_io.read_parquet(p, "customer", h_schemas()["customer"])
    exp = ref_csv.read_parquet(p, "customer", ref_h_schemas()["customer"])
    assert_same_table(back, exp, "customer")
    col = back.column("c_mktsegment")
    d = col.dictionary
    assert all(d[i] <= d[i + 1] for i in range(len(d) - 1))
    decoded = col.decode()
    assert list(decoded[np.argsort(col.values, kind="stable")]) == sorted(
        decoded)


def test_read_paths_auto_mixed_formats(tmp_path):
    port_sch = T.Schema.of(("k", T.INT32, False), ("s", T.varchar(8), True))
    ref_sch = RT.Schema.of(("k", RT.INT32, False), ("s", RT.varchar(8), True))
    parts = [{"k": np.arange(3, dtype=np.int32),
              "s": np.array(["x", "y", "z"], dtype=object),
              "s#null": np.array([True, False, True])},
             {"k": np.arange(10, 14, dtype=np.int32),
              "s": np.array(["p", "q", "r", "s"], dtype=object),
              "s#null": np.array([True, True, True, False])}]
    paths = [str(tmp_path / "base.avro"), str(tmp_path / "version.parquet")]
    for arrays, path in zip(parts, paths):
        csv_io.write_table(from_arrays("t", port_sch, arrays), path,
                           os.path.splitext(path)[1][1:])
    got = csv_io.read_paths_auto(paths, "t", port_sch, "avro")
    exp = ref_csv.read_paths_auto(paths, "t", ref_sch, "avro")
    assert_same_table(got, exp, "mixed")
    assert list(got.column("k").values) == [0, 1, 2, 10, 11, 12, 13]
    s = got.column("s").decode()
    assert s[0] == "x" and s[1] is None and s[3] == "p" and s[6] is None
    # one format: read as that format
    one = csv_io.read_paths_auto(paths[1:], "t", port_sch, "avro")
    assert list(one.column("k").values) == [10, 11, 12, 13]


def test_unknown_formats_are_refused(tmp_path):
    schema = h_schemas()["region"]
    with pytest.raises(ValueError, match="unknown input format"):
        csv_io.read_table_fmt([], "region", schema, "csv")
    with pytest.raises(ValueError, match="unknown output format"):
        csv_io.write_arrow(pa.table({"a": [1]}), str(tmp_path / "a.x"),
                           "csv")


# ------------------------------------------------------- integrity

@pytest.fixture
def verify_on():
    integrity.set_verify(True)
    ref_integrity.set_verify(True)
    try:
        yield
    finally:
        integrity.set_verify(None)
        ref_integrity.set_verify(None)


def _table_dir(tmp_path, payload: bytes = b"payload-bytes"):
    d = str(tmp_path / "tbl")
    os.makedirs(os.path.join(d, "c=1"))
    paths = [os.path.join(d, "part-0.parquet"),
             os.path.join(d, "c=1", "part-0.parquet")]
    for p in paths:
        with open(p, "wb") as f:
            f.write(payload)
    return d, paths


def test_manifest_round_trip_then_a_flipped_byte(tmp_path, verify_on):
    d, paths = _table_dir(tmp_path)
    integrity.write_manifest(d)
    with open(os.path.join(d, integrity.MANIFEST_NAME)) as f:
        port_doc = json.load(f)
    ref_integrity.write_manifest(d)
    with open(os.path.join(d, integrity.MANIFEST_NAME)) as f:
        assert json.load(f) == port_doc
    assert sorted(port_doc["files"]) == ["c=1/part-0.parquet",
                                         "part-0.parquet"]
    integrity.verify_paths(paths, "tbl")
    assert integrity.verify_manifest(d)
    with open(paths[1], "r+b") as f:
        f.seek(4)
        f.write(b"X")
    integrity.clear_cache()
    ref_integrity.clear_cache()
    with pytest.raises(integrity.CorruptArtifact) as ei:
        integrity.verify_paths(paths, "tbl")
    assert paths[1] in str(ei.value) and "sha256 expected" in str(ei.value)
    assert ei.value.expected != ei.value.actual
    with pytest.raises(ref_integrity.CorruptArtifact) as ref_ei:
        ref_integrity.verify_paths(paths, "tbl")
    assert str(ei.value) == str(ref_ei.value)
    assert not integrity.verify_manifest(d)
    assert not ref_integrity.verify_manifest(d)


def test_update_manifest_merges(tmp_path):
    d, paths = _table_dir(tmp_path)
    integrity.update_manifest(d, ["part-0.parquet"])
    integrity.update_manifest(d, ["c=1/part-0.parquet"])
    with open(os.path.join(d, integrity.MANIFEST_NAME)) as f:
        got = json.load(f)
    os.remove(os.path.join(d, integrity.MANIFEST_NAME))
    ref_integrity.write_manifest(d)
    with open(os.path.join(d, integrity.MANIFEST_NAME)) as f:
        assert got == json.load(f)


def test_unmanifested_files_load_unverified(tmp_path, verify_on):
    p = str(tmp_path / "legacy.dat")
    with open(p, "wb") as f:
        f.write(b"no manifest anywhere")
    integrity.verify_paths([p], "legacy")
    assert not integrity.verify_manifest(str(tmp_path))


def test_disabled_gate_skips_hashing(tmp_path, monkeypatch):
    d, paths = _table_dir(tmp_path)
    integrity.write_manifest(d)
    with open(paths[0], "wb") as f:
        f.write(b"xyz")
    integrity.clear_cache()
    integrity.set_verify(False)
    try:
        integrity.verify_paths(paths, "tbl")
    finally:
        integrity.set_verify(None)
    # the environment variable is the gate when no override is set
    monkeypatch.setenv(integrity.VERIFY_ENV, "0")
    assert not integrity.verify_enabled()
    integrity.verify_paths(paths, "tbl")
    monkeypatch.setenv(integrity.VERIFY_ENV, "1")
    assert integrity.verify_enabled()
    with pytest.raises(integrity.CorruptArtifact):
        integrity.verify_paths(paths, "tbl")


def test_read_tbl_verifies_digests(tmp_path, verify_on):
    d = str(tmp_path / "t")
    os.makedirs(d)
    p = os.path.join(d, "t_1_1.dat")
    with open(p, "w") as f:
        f.write("1|2|\n3|4|\n")
    integrity.write_manifest(d)
    schema = T.Schema.of(("a", T.INT64, False), ("b", T.INT64, False))
    ref_schema = RT.Schema.of(("a", RT.INT64, False), ("b", RT.INT64, False))
    assert_same_table(csv_io.read_tbl([p], "t", schema),
                      ref_csv.read_tbl([p], "t", ref_schema), "t")
    with open(p, "r+b") as f:
        f.seek(2)
        f.write(b"9")
    integrity.clear_cache()
    ref_integrity.clear_cache()
    with pytest.raises(integrity.CorruptArtifact):
        csv_io.read_tbl([p], "t", schema)
    with pytest.raises(ref_integrity.CorruptArtifact):
        ref_csv.read_tbl([p], "t", ref_schema)


def test_read_table_fmt_verifies_digests(orders, tmp_path, verify_on):
    port, _ref = orders
    d = str(tmp_path / "orders")
    p = os.path.join(d, "part-0.parquet")
    csv_io.write_table(port, p)
    integrity.write_manifest(d)
    schema = h_schemas()["orders"]
    csv_io.read_table_fmt([p], "orders", schema, "parquet")
    with open(os.path.join(d, integrity.MANIFEST_NAME)) as f:
        doc = json.load(f)
    doc["files"]["part-0.parquet"] = "0" * 64
    integrity.write_json_atomic(os.path.join(d, integrity.MANIFEST_NAME), doc)
    integrity.clear_cache()
    with pytest.raises(integrity.CorruptArtifact):
        csv_io.read_table_fmt([p], "orders", schema, "parquet")


def test_crc_stamp_and_check():
    doc = integrity.stamp_crc({"a": 1, "b": [2, 3]})
    assert doc == ref_integrity.stamp_crc({"a": 1, "b": [2, 3]})
    assert integrity.check_crc(doc) and ref_integrity.check_crc(doc)
    tampered = {**doc, "a": 2}
    assert not integrity.check_crc(tampered)
    assert integrity.check_crc({"legacy": "no-crc"})
    assert integrity.json_crc([1, "x"]) == ref_integrity.json_crc([1, "x"])


def test_write_json_atomic_leaves_no_tmp(tmp_path):
    p = str(tmp_path / "x" / "doc.json")
    integrity.write_json_atomic(p, {"k": 1})
    assert json.load(open(p)) == {"k": 1}
    assert os.listdir(os.path.dirname(p)) == ["doc.json"]


def test_table_cache_stamps_and_checks_digests(orders, tmp_path, verify_on):
    port, _ref = orders
    d = str(tmp_path / "cache")
    path = table_cache.save_table(d, port)
    schema = h_schemas()["orders"]
    assert integrity.verify_manifest(d)
    assert ref_integrity.verify_manifest(d)
    assert_same_table(table_cache.load_table(d, "orders", schema), port,
                      "cache")
    with open(path, "r+b") as f:
        f.seek(100)
        byte = f.read(1)
        f.seek(100)
        f.write(bytes([byte[0] ^ 0xFF]))
    integrity.clear_cache()
    with pytest.raises(integrity.CorruptArtifact):
        table_cache.load_table(d, "orders", schema)


def test_table_cache_records_the_columnar_encodings(orders, tmp_path):
    from nds_tpu import columnar as ref_columnar
    from nds_tpu.io import table_cache as ref_cache
    port, ref = orders
    columnar.set_mode("auto")
    ref_columnar.set_mode("auto")
    try:
        d, r = str(tmp_path / "port"), str(tmp_path / "ref")
        table_cache.save_table(d, port)
        ref_cache.save_table(r, ref)
        docs = []
        for root in (d, r):
            with open(os.path.join(root, integrity.MANIFEST_NAME)) as f:
                docs.append(json.load(f)["encodings"])
        assert docs[0] == docs[1] and docs[0]["orders"]["mode"] == "auto"
        specs = columnar.manifest_encodings(d, "orders")
        assert specs == columnar.table_specs(port)
        loaded = table_cache.load_table(d, "orders", h_schemas()["orders"])
        assert_same_table(loaded, port, "cache")
        assert {n: columnar.column_spec(c)
                for n, c in loaded.columns.items()} == specs
        # another mode's manifest is not trusted
        columnar.set_mode("bitpack")
        assert columnar.manifest_encodings(d, "orders") is None
    finally:
        columnar.set_mode(None)
        ref_columnar.set_mode(None)


# ---------------------------------------------------- load report

def test_report_parsing_matches_the_reference(tmp_path):
    good = str(tmp_path / "good.txt")
    with open(good, "w") as f:
        f.write("Total conversion time for 2 tables was 1.250s\n"
                "Time to convert 'a' was 1.0000s\n"
                "Time to convert 'b' was 0.2500s\n\nRNGSEED used: 1712\n")
    assert loadreport.get_load_time(good) == 1.25
    assert loadreport.get_rngseed(good) == 1712
    assert ref_loadreport.get_load_time(good) == 1.25
    assert ref_loadreport.get_rngseed(good) == 1712


def test_drifted_report_raises(tmp_path):
    bad = str(tmp_path / "bad.txt")
    with open(bad, "w") as f:
        f.write("Conversion finished in about 12s maybe\n")
    for mod in (loadreport, ref_loadreport):
        with pytest.raises(ValueError):
            mod.get_load_time(bad)
        with pytest.raises(ValueError):
            mod.get_rngseed(bad)


# ------------------------------------------- external tool wrappers

def _fake_tool(root, name, emit=""):
    """A shell script that records its arguments and environment."""
    tool = root / "tools" / name
    tool.parent.mkdir(parents=True, exist_ok=True)
    rec = root / f"{name}_calls.txt"
    tool.write_text(
        "#!/bin/sh\n"
        f"echo \"$0 $@\" >> {rec}\n"
        f"echo \"DSS_PATH=$DSS_PATH DSS_QUERY=$DSS_QUERY\" >> "
        f"{rec}.env\n" + emit)
    tool.chmod(0o755)
    return str(tool), rec


def _calls(rec):
    return sorted(line.split()[1:]
                  for line in rec.read_text().strip().splitlines())


def _both_record(tmp_path, name, run, emit=""):
    """(port calls, reference calls, port env, reference env) of ``run``
    (called with a module and a fake tool) under each package."""
    out = []
    for who, mod in (("port", toolwrap), ("ref", ref_toolwrap)):
        tool, rec = _fake_tool(tmp_path / who, name, emit)
        run(mod, tool, str(tmp_path / who / "out"))
        env = open(f"{rec}.env").read().replace(str(tmp_path / who), "")
        out.append((_calls(rec), env))
    (port, port_env), (ref, ref_env) = out
    return port, ref, port_env, ref_env


def test_apply_patches_idempotent(tmp_path):
    for who, mod in (("port", toolwrap), ("ref", ref_toolwrap)):
        src = tmp_path / who / "tools"
        src.mkdir(parents=True)
        (src / "a.txt").write_text("line one\nline two\n")
        patches = tmp_path / who / "patches"
        patches.mkdir()
        (patches / "fix.patch").write_text(
            "--- a/a.txt\n+++ b/a.txt\n@@ -1,2 +1,2 @@\n line one\n"
            "-line two\n+line 2\n")
        (patches / "notes.txt").write_text("not a patch")
        assert mod.apply_patches(str(src), str(patches)) == ["fix.patch"]
        assert mod.apply_patches(str(src), str(patches)) == []
        assert (src / "a.txt").read_text() == "line one\nline 2\n"


def test_move_into_table_dirs(tmp_path):
    names = ("store_sales_1_4.dat", "store_sales_2_4.dat", "date_dim.dat",
             "lineitem.tbl.3", "web_site_1_4.dat")
    layouts = []
    for who, mod in (("port", toolwrap), ("ref", ref_toolwrap)):
        d = tmp_path / who
        d.mkdir()
        for f in names:
            (d / f).write_text("x|\n")
        mod._move_into_table_dirs(str(d))
        layouts.append(sorted(os.path.relpath(os.path.join(r, f), d)
                              for r, _dirs, fs in os.walk(d) for f in fs))
    assert layouts[0] == layouts[1]
    assert "store_sales/store_sales_2_4.dat" in layouts[0]
    assert "lineitem/lineitem.tbl.3" in layouts[0]


@pytest.mark.parametrize("parallel,update", [(4, None), (1, 2)])
def test_run_dsdgen_commands(parallel, update, tmp_path):
    def run(mod, tool, out):
        mod.run_dsdgen(tool, scale=10, parallel=parallel, data_dir=out,
                       update=update)
    port, ref, *_env = _both_record(tmp_path, "dsdgen", run,
                                    emit='touch "$4/store_sales_$$.dat"\n')
    strip = [[a.replace(str(tmp_path / w), "") for a in c]
             for w, cs in (("port", port), ("ref", ref)) for c in cs]
    assert strip[:len(port)] == strip[len(port):]
    assert len(port) == parallel
    if parallel == 1:
        assert port[0][-2:] == ["-update", "2"]
        assert "-parallel" not in port[0]
    assert os.path.isdir(tmp_path / "port" / "out" / "store_sales")


def test_run_dbgen_chunks_and_env(tmp_path):
    def run(mod, tool, out):
        mod.run_dbgen(tool, scale=1, parallel=2, data_dir=out)
    port, ref, port_env, ref_env = _both_record(tmp_path, "dbgen", run)
    assert port == ref == [["-s", "1", "-f", "-C", "2", "-S", "1"],
                           ["-s", "1", "-f", "-C", "2", "-S", "2"]]
    assert port_env == ref_env and "DSS_PATH=/out" in port_env


def test_run_dsqgen_and_qgen(tmp_path):
    def dsqgen(mod, tool, out):
        tdir = os.path.join(os.path.dirname(out), "tpl")
        os.makedirs(tdir, exist_ok=True)
        mod.run_dsqgen(tool, tdir, out, scale=100, streams=4,
                       rngseed=19620718)
    port, ref, *_ = _both_record(tmp_path / "dsq", "dsqgen", dsqgen)
    norm = [[a.replace(str(tmp_path / "dsq" / w), "") for a in c]
            for w, cs in (("port", port), ("ref", ref)) for c in cs]
    assert norm[0] == norm[1]
    assert norm[0][-4:] == ["-streams", "4", "-rngseed", "19620718"]

    def qgen(mod, tool, out):
        mod.run_qgen(tool, os.path.join(os.path.dirname(out), "queries"),
                     out, scale=1, streams=2)
    port, ref, port_env, ref_env = _both_record(
        tmp_path / "q", "qgen", qgen, emit='echo "select 1;"\n')
    assert port == ref == [["-s", "1"], ["-s", "1", "-p", "1"]]
    assert port_env == ref_env and "DSS_QUERY=/queries" in port_env
    for i in range(2):
        body = open(tmp_path / "q" / "port" / "out" / f"stream_{i}.sql").read()
        assert "select 1;" in body


def test_fan_out_failure_raises(tmp_path):
    tool = tmp_path / "tools" / "dsdgen"
    tool.parent.mkdir(parents=True)
    tool.write_text("#!/bin/sh\nexit 3\n")
    tool.chmod(0o755)
    with pytest.raises(toolwrap.ToolError, match="3"):
        toolwrap.run_dsdgen(str(tool), scale=1, parallel=2,
                            data_dir=str(tmp_path / "out"))


def test_gen_data_external_tool_paths(tmp_path):
    """``--dbgen_path`` and ``--dsdgen_path`` drive the tools through
    ``toolwrap`` with the reference's command lines and environment, and
    leave the chunk files in per-table directories, the layout
    ``transcode`` reads. (The reference's NDS-H CLI shells out itself and
    leaves dbgen's files flat; the port goes through ``run_dbgen``.)"""
    recs = {}
    emit = 'touch "$DSS_PATH/lineitem.tbl.$7"\n'
    for who in ("port", "ref"):
        dbgen, drec = _fake_tool(tmp_path / who, "dbgen", emit)
        dsdgen, srec = _fake_tool(tmp_path / who, "dsdgen")
        out = str(tmp_path / who / "raw")
        if who == "port":
            h_gen.main(["1", "3", out + "_h", "--dbgen_path", dbgen])
            nds_gen.main(["2", "2", out + "_ds", "--dsdgen_path", dsdgen])
        else:
            ref_toolwrap.run_dbgen(dbgen, 1, 3, out + "_h")
            ref_nds_gen.main(["2", "2", out + "_ds", "--dsdgen_path",
                              dsdgen])
        recs[who] = (
            [[a.replace(str(tmp_path / who), "") for a in c]
             for rec in (drec, srec) for c in _calls(rec)],
            open(f"{drec}.env").read().replace(str(tmp_path / who), ""))
    assert recs["port"] == recs["ref"]
    calls, env = recs["port"]
    assert calls[0] == ["-s", "1", "-f", "-C", "3", "-S", "1"]
    assert calls[3] == ["-scale", "2", "-dir", "/raw_ds", "-force", "Y",
                        "-parallel", "2", "-child", "1"]
    assert "DSS_PATH=/raw_h" in env
    assert sorted(os.listdir(tmp_path / "port" / "raw_h" / "lineitem")) == [
        "lineitem.tbl.1", "lineitem.tbl.2", "lineitem.tbl.3"]


# ------------------------------------------------ from_arrow strings

def _string_schemas():
    return (T.Schema.of(("s", T.varchar(20), True), ("k", T.INT32, True)),
            RT.Schema.of(("s", RT.varchar(20), True), ("k", RT.INT32, True)))


STRINGS = ["b", "é", "a", None, "Zebra", "日本", "a", "😀", "", "ß",
           " x", None, "A"]


def _from_arrow_both(t):
    sch, ref_sch = _string_schemas()
    got = csv_io.from_arrow("t", sch, t)
    exp = ref_csv.from_arrow("t", ref_sch, t)
    assert_same_table(got, exp, "from_arrow")
    return got


def _table(strings, dictionary=False):
    arr = pa.array(strings, type=pa.string())
    if dictionary:
        arr = arr.dictionary_encode()
    return pa.table({"s": arr,
                     "k": pa.array(range(len(strings)), type=pa.int32())})


@pytest.mark.parametrize("dictionary", [False, True])
def test_from_arrow_non_ascii_and_null_strings(dictionary):
    got = _from_arrow_both(_table(STRINGS, dictionary))
    col = got.column("s")
    assert list(col.dictionary) == sorted(col.dictionary)
    decoded = col.decode()
    assert decoded[3] is None and decoded[1] == "é" and decoded[7] == "😀"


def test_from_arrow_parquet_with_null_strings(tmp_path):
    p = str(tmp_path / "s.parquet")
    pq.write_table(_table(STRINGS, dictionary=True), p)
    got = _from_arrow_both(pq.ParquetFile(p).read())
    assert got.column("s").null_mask.sum() == len(STRINGS) - 2


def test_from_arrow_chunks_with_different_dictionaries(tmp_path):
    paths = []
    for i, part in enumerate((["x", "b", None, "b"], ["a", "é", "x", "c"],
                              [None, None])):
        paths.append(str(tmp_path / f"part-{i}.parquet"))
        pq.write_table(_table(part, dictionary=True), paths[-1])
    t = pa.concat_tables([pq.ParquetFile(p).read() for p in paths],
                         promote_options="permissive")
    assert t.column("s").num_chunks == 3
    got = _from_arrow_both(t)
    assert list(got.column("s").decode()) == [
        "x", "b", None, "b", "a", "é", "x", "c", None, None]
    sch, ref_sch = _string_schemas()
    assert_same_table(csv_io.read_parquet(paths, "t", sch),
                      ref_csv.read_parquet(paths, "t", ref_sch), "parquet")


def test_from_arrow_empty_table():
    got = _from_arrow_both(_table([]))
    assert got.nrows == 0 and len(got.column("s").dictionary) == 0
    all_null = _from_arrow_both(_table([None, None]))
    assert all_null.column("s").null_mask.tolist() == [False, False]


def test_from_arrow_dictionary_with_null_and_repeated_entries():
    """Arrow allows a dictionary with a NULL entry and repeated entries;
    the reference sorts them as numpy unicode (a NULL entry as the
    string "None"), stably."""
    dictionary = pa.array(["q", None, "None", "a", "q", "Nonf"])
    indices = pa.array([0, 1, 2, 3, 4, 5, None, 4, 1], type=pa.int32())
    arr = pa.DictionaryArray.from_arrays(indices, dictionary)
    _from_arrow_both(pa.table({"s": arr, "k": pa.array(
        range(len(indices)), type=pa.int32())}))


@pytest.mark.parametrize("large", [False, True])
def test_from_arrow_large_dictionary_sorted_in_buckets(large):
    """A dictionary of 2**16 entries or more is sorted in buckets of its
    first two bytes on a pool of threads: the same table as the
    reference's, over empty, one-byte, shared-prefix, non-ASCII and
    repeated strings, in a plain and a large_string column."""
    rng = np.random.default_rng(7)
    alphabet = np.array(list("aAbz é日😀\x00~"), dtype=object)
    lengths = rng.integers(3, 12, 100_000)
    words = ["".join(rng.choice(alphabet, k)) for k in lengths]
    words += ["", "a", "a\x00", "ab", "é", "é", "the furiously"] * 3
    strings = pa.array(words, type=pa.large_string() if large
                       else pa.string())
    t = pa.table({"s": strings, "k": pa.array(range(len(words)),
                                              type=pa.int32())})
    got = _from_arrow_both(t)
    assert len(got.column("s").dictionary) >= 1 << 16
    assert list(got.column("s").decode()[-7:]) == words[-7:]

