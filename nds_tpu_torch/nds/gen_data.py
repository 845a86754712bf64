"""NDS (TPC-DS) data generation CLI.

Port copy of ``nds_tpu/nds/gen_data.py`` over the port's generator
(``nds_tpu_torch.datagen.tpcds``): the 25 source tables as '|'-delimited
chunk files under per-table directories with dsdgen's chunking contract
(``<table>_<step>_<parallel>.dat``), single files for the fixed
dimensions, ``--range`` regeneration, fanned out over a process pool. It
writes the same bytes as the reference for the same scale, parallelism
and chunk range (``dbgen_version`` records the day and time it ran).

``--dsdgen_path`` runs the external TPC dsdgen binary instead
(``datagen/toolwrap.py``: one process per chunk, the files then moved
into per-table directories). ``--update N`` generates the Nth refresh
data set instead (``generate_refresh_data``: the 12 s_* staging tables
and the delete-date tables from ``datagen/tpcds_refresh.py``), which
the data-maintenance phase (``nds/maintenance.py``) reads.

    python -m nds_tpu_torch.nds.gen_data 1 8 /data/nds/raw
    python -m nds_tpu_torch.nds.gen_data 1 1 /data/nds/refresh1 --update 1
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor

from nds_tpu_torch.datagen import tpcds
from nds_tpu_torch.io.csv_io import write_tbl
from nds_tpu_torch.nds.schema import get_maintenance_schemas, get_schemas

# dsdgen's metadata table dbgen_version has no query schema: generated
# for layout parity, skipped by the power run
SOURCE_TABLES = sorted(get_schemas()) + ["dbgen_version"]
# fixed-cardinality dimensions generated as a single chunk
SINGLE_CHUNK_TABLES = {
    "date_dim", "time_dim", "reason", "income_band", "ship_mode",
    "call_center", "warehouse", "web_site", "web_page", "store",
    "household_demographics", "customer_demographics", "promotion",
    "dbgen_version",
}


def _gen_chunk(table: str, sf: float, parallel: int, step: int,
               out_dir: str, use_decimal: bool = True) -> str:
    if table == "dbgen_version":
        path = os.path.join(out_dir, table, f"{table}.dat")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(f"nds_tpu-builtin-1.0|"
                    f"{time.strftime('%Y-%m-%d')}|"
                    f"{time.strftime('%H:%M:%S')}|"
                    f"-scale {sf:g} -parallel {parallel}|\n")
        return path
    arrays = tpcds.gen_table(table, sf, parallel, step)
    schemas = get_schemas(use_decimal)
    if table in SINGLE_CHUNK_TABLES or parallel == 1:
        path = os.path.join(out_dir, table, f"{table}.dat")
    else:
        path = os.path.join(out_dir, table,
                            f"{table}_{step}_{parallel}.dat")
    write_tbl(arrays, schemas[table], path)
    return path


def _gen_chunk_star(args):
    return _gen_chunk(*args)


def generate_data_local(scale: float, parallel: int, data_dir: str,
                        overwrite: bool = False, table: str | None = None,
                        chunk_range: tuple[int, int] | None = None,
                        workers: int | None = None,
                        use_decimal: bool = True) -> list[str]:
    if os.path.isdir(data_dir) and os.listdir(data_dir) and not overwrite:
        raise SystemExit(
            f"data dir {data_dir!r} is not empty (pass --overwrite_output)")
    os.makedirs(data_dir, exist_ok=True)
    tables = [table] if table else SOURCE_TABLES
    lo, hi = chunk_range or (1, parallel)
    tasks = []
    for t in tables:
        if t in SINGLE_CHUNK_TABLES:
            if lo == 1:  # fixed tables generated once, by chunk 1's owner
                tasks.append((t, scale, 1, 1, data_dir, use_decimal))
            continue
        for step in range(lo, hi + 1):
            tasks.append((t, scale, parallel, step, data_dir, use_decimal))
    # spawned workers: the caller may hold threads (a CUDA context)
    with ProcessPoolExecutor(
            max_workers=workers,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        return list(pool.map(_gen_chunk_star, tasks))


def generate_refresh_data(scale: float, update: int, data_dir: str,
                          overwrite: bool = False,
                          use_decimal: bool = True) -> list[str]:
    """The ``--update`` path: the refresh (s_*) staging tables and the
    delete/inventory_delete date-range tables, written under
    ``data_dir`` like dsdgen update sets
    (`nds/nds_gen_data.py:119-127,183-244` with ``--update``)."""
    if os.path.isdir(data_dir) and os.listdir(data_dir) and not overwrite:
        raise SystemExit(
            f"data dir {data_dir!r} is not empty (pass --overwrite_output)")
    os.makedirs(data_dir, exist_ok=True)
    from nds_tpu_torch.datagen import tpcds_refresh
    paths = []
    for t, schema in get_maintenance_schemas(use_decimal).items():
        arrays = tpcds_refresh.gen_refresh_table(t, scale, update)
        path = os.path.join(data_dir, t, f"{t}.dat")
        write_tbl(arrays, schema, path)
        paths.append(path)
    return paths


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="generate NDS raw data")
    p.add_argument("scale", type=float, help="scale factor")
    p.add_argument("parallel", type=int, help="number of chunks")
    p.add_argument("data_dir", help="output directory")
    p.add_argument("--table", choices=SOURCE_TABLES)
    p.add_argument("--range", dest="chunk_range",
                   help="'first,last' 1-based chunk subrange to (re)generate")
    p.add_argument("--update", type=int,
                   help="generate the Nth refresh dataset instead of the "
                        "base tables")
    p.add_argument("--overwrite_output", action="store_true")
    p.add_argument("--floats", action="store_true",
                   help="double columns instead of decimals")
    p.add_argument("--dsdgen_path",
                   help="use the external TPC dsdgen binary instead of "
                        "the builtin generator")
    p.add_argument("--workers", type=int,
                   help="process-pool size (default: cpu count)")
    args = p.parse_args(argv)
    if args.dsdgen_path:
        from nds_tpu_torch.datagen.toolwrap import run_dsdgen
        run_dsdgen(args.dsdgen_path, int(args.scale), args.parallel,
                   args.data_dir, update=args.update)
        return
    if args.update is not None:
        generate_refresh_data(args.scale, args.update, args.data_dir,
                              args.overwrite_output, not args.floats)
        return
    rng = None
    if args.chunk_range:
        lo, hi = (int(x) for x in args.chunk_range.split(","))
        if not (1 <= lo <= hi <= args.parallel):
            raise SystemExit(f"invalid --range {args.chunk_range!r}")
        rng = (lo, hi)
    generate_data_local(args.scale, args.parallel, args.data_dir,
                        args.overwrite_output, args.table, rng,
                        args.workers, not args.floats)


if __name__ == "__main__":
    main()
