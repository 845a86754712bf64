"""NDS Load Test: raw '|'-delimited text -> columnar warehouse.

Port copy of ``nds_tpu/nds/transcode.py``, imports rewritten to
``nds_tpu_torch`` (upstream `nds/nds_transcode.py:154-229`): per-table
transcode timing, the fact tables' date partitions
(``TABLE_PARTITIONING``, upstream `:45-53`), ``--update`` switching to
the refresh (maintenance) schemas (`:170-176`), a digest manifest per
table (``io/integrity.py``), ``--resume`` over the tables whose
manifests verify, and a plain-text report with per-table seconds, the
total, and the load-end timestamp the orchestrator reads back as the
stream RNGSEED (`nds/nds_transcode.py:210-216` -> `nds/nds_bench.py:60-74`).

A partitioned fact writes one file per 30-day band of its partition
column under ``<table>/<part_col>=<band start>/`` (hive-style, NULL
under ``__HIVE_DEFAULT_PARTITION__``) in place of a Spark
repartition and sort; strings are sorted again on read
(``io/csv_io.py``).

    python -m nds_tpu_torch.nds.transcode raw/ warehouse/ load.txt
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from nds_tpu_torch.io import csv_io
from nds_tpu_torch.nds.schema import get_maintenance_schemas, get_schemas

# fact date-partition columns (`nds/nds_transcode.py:45-53`)
TABLE_PARTITIONING = {
    "catalog_sales": "cs_sold_date_sk",
    "catalog_returns": "cr_returned_date_sk",
    "inventory": "inv_date_sk",
    "store_sales": "ss_sold_date_sk",
    "store_returns": "sr_returned_date_sk",
    "web_sales": "ws_sold_date_sk",
    "web_returns": "wr_returned_date_sk",
}


def _raw_paths(input_dir: str, name: str) -> list[str]:
    from nds_tpu_torch.io.integrity import MANIFEST_NAME
    tdir = os.path.join(input_dir, name)
    if os.path.isdir(tdir):
        return sorted(os.path.join(tdir, f) for f in os.listdir(tdir)
                      if not f.startswith(".") and f != MANIFEST_NAME)
    return [os.path.join(input_dir, f"{name}.dat")]


def transcode_table(name, schema, input_dir: str, output_dir: str,
                    compression: str = "snappy",
                    partition: bool = True,
                    output_format: str = "parquet") -> float:
    t0 = time.perf_counter()
    table = csv_io.read_tbl(_raw_paths(input_dir, name), name, schema)
    ext = csv_io.FORMAT_EXT[output_format]
    part_col = TABLE_PARTITIONING.get(name) if partition else None
    if part_col and table.nrows:
        col = table.column(part_col)
        vals = col.values
        valid = (col.null_mask if col.null_mask is not None
                 else np.ones(len(vals), dtype=bool))
        arrow = csv_io.to_arrow(table)
        # coarse month buckets: one file per ~30-day band keeps file
        # counts sane while preserving partition-prunable layout
        band = np.where(valid, vals // 30, -1)
        for b in np.unique(band):
            sel = np.nonzero(band == b)[0]
            sub = arrow.take(sel)
            label = "__HIVE_DEFAULT_PARTITION__" if b < 0 else str(
                int(b) * 30)
            out = os.path.join(output_dir, name, f"{part_col}={label}",
                               f"part-0{ext}")
            if output_format == "avro":
                # avro writes from the engine schema (write_table), not
                # from a bare arrow table
                csv_io.write_table(
                    csv_io.from_arrow(name, table.schema, sub), out,
                    "avro", compression)
            else:
                csv_io.write_arrow(sub, out, output_format, compression)
    else:
        out = os.path.join(output_dir, name, f"part-0{ext}")
        csv_io.write_table(table, out, output_format,
                           compression=compression)
    # per-table digest manifest: loads can verify every chunk they read
    # back (io/integrity.py)
    from nds_tpu_torch.io import integrity
    integrity.write_manifest(os.path.join(output_dir, name))
    return time.perf_counter() - t0


def transcode(input_dir: str, output_dir: str, report_path: str,
              tables: list[str] | None = None,
              compression: str = "snappy", update: bool = False,
              use_decimal: bool = True, partition: bool = True,
              output_format: str = "parquet",
              resume: bool = False) -> dict:
    schemas = (get_maintenance_schemas(use_decimal) if update
               else get_schemas(use_decimal))
    if tables:
        unknown = set(tables) - set(schemas)
        if unknown:
            raise ValueError(f"unknown tables: {sorted(unknown)}")
        schemas = {t: schemas[t] for t in tables}
    os.makedirs(output_dir, exist_ok=True)
    # options stamp: resuming under DIFFERENT transcode options would
    # silently keep tables built with the old schema/format (their
    # manifests still verify — they hash the old bytes) and yield a
    # mixed warehouse; refuse loudly, like the resume journals'
    # config-digest guard
    from nds_tpu_torch.io import integrity
    opts = {"use_decimal": use_decimal, "compression": compression,
            "partition": partition, "output_format": output_format,
            "update": update}
    opts_path = os.path.join(output_dir, "_transcode_options.json")
    if resume and os.path.exists(opts_path):
        try:
            with open(opts_path) as f:
                prior = json.load(f)
        except (OSError, ValueError):
            prior = None
        if prior is not None and prior != opts:
            raise ValueError(
                f"--resume under different transcode options: "
                f"{opts_path} records {prior}, current run wants "
                f"{opts} — delete the warehouse (or drop --resume) "
                f"to rebuild consistently")
    integrity.write_json_atomic(opts_path, opts)
    timings = {}
    for name, schema in schemas.items():
        if resume:
            # preemption-safe resume: a table whose _manifest.json
            # digests all verify was FULLY transcoded by an earlier
            # incarnation (the manifest is written last, after every
            # data file) — re-transcoding it would burn the load-phase
            # budget re-doing finished work. A missing/torn manifest or
            # any mismatch re-transcodes from scratch.
            if integrity.verify_manifest(os.path.join(output_dir,
                                                      name)):
                timings[name] = 0.0
                print(f"Skipped table {name} (manifest verified, "
                      f"already transcoded)")
                continue
        timings[name] = transcode_table(
            name, schema, input_dir, output_dir, compression, partition,
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


# anchored report parsing, shared with NDS-H (`nds/nds_bench.py:60-89`)
from nds_tpu_torch.utils.loadreport import get_load_time, get_rngseed  # noqa: E402,F401


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="NDS load test: raw text -> warehouse")
    p.add_argument("input_dir", help="raw data directory (datagen output)")
    p.add_argument("output_dir", help="warehouse directory")
    p.add_argument("report_file", help="load-report text file")
    p.add_argument("--tables", nargs="+", help="subset of tables")
    p.add_argument("--update", action="store_true",
                   help="transcode refresh (maintenance) tables instead")
    p.add_argument("--floats", action="store_true",
                   help="double columns instead of decimals")
    p.add_argument("--no_partition", action="store_true",
                   help="disable fact date partitioning")
    p.add_argument("--compression", default="snappy")
    p.add_argument("--output_format", default="parquet",
                   choices=["parquet", "orc", "json", "avro"],
                   help="warehouse file format "
                        "(`nds/nds_transcode.py:69-152`; avro via the "
                        "built-in container codec, io/avro_io.py)")
    p.add_argument("--resume", action="store_true",
                   help="skip tables whose _manifest.json digests "
                        "already verify (an interrupted load resumes "
                        "table by table)")
    args = p.parse_args(argv)
    transcode(args.input_dir, args.output_dir, args.report_file,
              args.tables, args.compression, update=args.update,
              use_decimal=not args.floats,
              partition=not args.no_partition,
              output_format=args.output_format, resume=args.resume)


if __name__ == "__main__":
    main()
