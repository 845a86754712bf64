"""NDS-H Load Test: raw '|'-delimited text -> columnar warehouse.

Port copy of ``nds_tpu/nds_h/transcode.py``, imports rewritten to
``nds_tpu_torch`` (upstream `nds-h/nds_h_transcode.py`, with the report
format of `nds/nds_transcode.py:205-229`): per-table transcode timing,
one ``part-0<ext>`` per table in the chosen format, a digest manifest
per table (``io/integrity.py``), and a plain-text report with per-table
seconds, the total, and the load-end timestamp the orchestrator uses as
the stream RNGSEED (`nds/nds_transcode.py:210-216` ->
`nds/nds_bench.py:60-74`). Strings are written dictionary-encoded, and
their dictionaries are sorted again on read (``io/csv_io.py``).

    python -m nds_tpu_torch.nds_h.transcode raw/ warehouse/ load.txt
"""

from __future__ import annotations

import argparse
import os
import time

from nds_tpu_torch.io import csv_io
from nds_tpu_torch.nds_h.schema import get_schemas


def transcode_table(name, schema, input_dir: str, output_dir: str,
                    compression: str = "snappy",
                    output_format: str = "parquet") -> float:
    t0 = time.perf_counter()
    tdir = os.path.join(input_dir, name)
    if os.path.isdir(tdir):
        from nds_tpu_torch.io.integrity import MANIFEST_NAME
        paths = sorted(os.path.join(tdir, f) for f in os.listdir(tdir)
                       if not f.startswith(".") and f != MANIFEST_NAME)
    else:
        single = os.path.join(input_dir, f"{name}.tbl")
        paths = [single]
    table = csv_io.read_tbl(paths, name, schema)
    ext = csv_io.FORMAT_EXT[output_format]
    out = os.path.join(output_dir, name, f"part-0{ext}")
    csv_io.write_table(table, out, output_format, compression=compression)
    # per-table digest manifest for verified loads (io/integrity.py)
    from nds_tpu_torch.io import integrity
    integrity.write_manifest(os.path.join(output_dir, name))
    return time.perf_counter() - t0


def transcode(input_dir: str, output_dir: str, report_path: str,
              tables: list[str] | None = None,
              compression: str = "snappy",
              output_format: str = "parquet") -> dict:
    schemas = get_schemas()
    if tables:
        unknown = set(tables) - set(schemas)
        if unknown:
            raise ValueError(f"unknown tables: {sorted(unknown)}")
        schemas = {t: schemas[t] for t in tables}
    os.makedirs(output_dir, exist_ok=True)
    timings = {}
    for name, schema in schemas.items():
        timings[name] = transcode_table(
            name, schema, input_dir, output_dir, compression,
            output_format)
        print(f"Time taken: {timings[name]:.3f} s for table {name}")
    load_end = int(time.time())
    report = ["Total conversion time for %d tables was %.3fs" % (
        len(timings), sum(timings.values()))]
    for name, secs in timings.items():
        report.append("Time to convert '%s' was %.4fs" % (name, secs))
    report.append("")
    # the stream-seed contract: RNGSEED = load end timestamp
    report.append(f"RNGSEED used: {load_end}")
    os.makedirs(os.path.dirname(report_path) or ".", exist_ok=True)
    with open(report_path, "w") as f:
        f.write("\n".join(report) + "\n")
    return timings


# anchored report parsing, shared with NDS (`nds/nds_bench.py:60-89`)
from nds_tpu_torch.utils.loadreport import get_load_time, get_rngseed  # noqa: E402,F401


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="NDS-H load test: raw text -> warehouse")
    p.add_argument("input_dir", help="raw data directory (datagen output)")
    p.add_argument("output_dir", help="warehouse directory")
    p.add_argument("report_file", help="load-report text file")
    p.add_argument("--tables", nargs="+", help="subset of tables")
    p.add_argument("--compression", default="snappy")
    p.add_argument("--output_format", default="parquet",
                   choices=["parquet", "orc", "json", "avro"],
                   help="warehouse file format "
                        "(`nds/nds_transcode.py:69-152`; avro via the "
                        "built-in container codec, io/avro_io.py)")
    args = p.parse_args(argv)
    transcode(args.input_dir, args.output_dir, args.report_file,
              args.tables, args.compression,
              output_format=args.output_format)


if __name__ == "__main__":
    main()
