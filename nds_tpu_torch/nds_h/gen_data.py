"""NDS-H data generation CLI.

Port copy of ``nds_tpu/nds_h/gen_data.py`` over the port's generator
(``nds_tpu_torch.datagen.tpch``): the 8 TPC-H tables as '|'-delimited
chunk files under per-table directories, with dbgen's chunking contract
(``parallel`` chunks, ``--range`` to regenerate a subrange) and nation
and region as single files, fanned out over a process pool. It writes
the same bytes as the reference for the same scale, parallelism and
chunk range.

``--dbgen_path`` runs the external TPC dbgen binary instead through
``datagen/toolwrap.run_dbgen``: one process per chunk (``dbgen -s N -f
-C P -S C`` with ``DSS_PATH`` the output directory), the chunk files then
moved into per-table directories, the layout ``transcode`` reads (the
reference's CLI shells out itself and leaves them flat).

    python -m nds_tpu_torch.nds_h.gen_data 1 8 /data/nds_h/raw
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

from nds_tpu_torch.datagen import tpch
from nds_tpu_torch.io.csv_io import write_tbl
from nds_tpu_torch.nds_h.schema import get_schemas

SOURCE_TABLES = ["customer", "lineitem", "nation", "orders", "part",
                 "partsupp", "region", "supplier"]
SINGLE_CHUNK_TABLES = {"nation", "region"}


def _gen_chunk(table: str, sf: float, parallel: int, step: int,
               out_dir: str) -> str:
    arrays = tpch.gen_table(table, sf, parallel, step)
    schemas = get_schemas()
    if table in SINGLE_CHUNK_TABLES or parallel == 1:
        path = os.path.join(out_dir, table, f"{table}.tbl")
    else:
        path = os.path.join(out_dir, table, f"{table}.tbl.{step}")
    write_tbl(arrays, schemas[table], path)
    return path


def _gen_chunk_star(args):
    return _gen_chunk(*args)


def generate_data_local(scale: float, parallel: int, data_dir: str,
                        overwrite: bool = False, table: str | None = None,
                        chunk_range: tuple[int, int] | None = None,
                        workers: int | None = None) -> list[str]:
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
                tasks.append((t, scale, 1, 1, data_dir))
            continue
        for step in range(lo, hi + 1):
            tasks.append((t, scale, parallel, step, data_dir))
    # spawned workers: the caller may hold threads (a CUDA context)
    with ProcessPoolExecutor(
            max_workers=workers,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        return list(pool.map(_gen_chunk_star, tasks))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="generate NDS-H raw data")
    p.add_argument("scale", type=float, help="scale factor")
    p.add_argument("parallel", type=int, help="number of chunks")
    p.add_argument("data_dir", help="output directory")
    p.add_argument("--table", choices=SOURCE_TABLES)
    p.add_argument("--range", dest="chunk_range",
                   help="'first,last' 1-based chunk subrange to (re)generate")
    p.add_argument("--overwrite_output", action="store_true")
    p.add_argument("--dbgen_path",
                   help="use the external TPC dbgen binary instead of the "
                        "builtin generator")
    p.add_argument("--workers", type=int,
                   help="process-pool size (default: cpu count)")
    args = p.parse_args(argv)
    if args.dbgen_path:
        from nds_tpu_torch.datagen.toolwrap import run_dbgen
        run_dbgen(args.dbgen_path, int(args.scale), args.parallel,
                  args.data_dir)
        return
    rng = None
    if args.chunk_range:
        lo, hi = (int(x) for x in args.chunk_range.split(","))
        if not (1 <= lo <= hi <= args.parallel):
            raise SystemExit(f"invalid --range {args.chunk_range!r}")
        rng = (lo, hi)
    generate_data_local(args.scale, args.parallel, args.data_dir,
                        args.overwrite_output, args.table, rng,
                        args.workers)


if __name__ == "__main__":
    main()
