"""NDS-H Power Run CLI.

Port of ``nds_tpu/nds_h/power.py`` over the port's power core
(``nds_tpu_torch/utils/power_core.py``): parse a query stream by its
``-- Template file: N`` markers (q15 runs as three parts: create view,
select, drop view), register the 8 tables, run every query in stream
order recording per-query wall-clock ms (device->host result included),
write the CSV time log and optional per-query JSON summaries, honor
``--allow_failure`` (and the port's ``--allow_recovered``) and the
template/property-file config layers, and
exit non-zero if any query failed.

    python -m nds_tpu_torch.nds_h.power <warehouse> stream_0.sql time.csv \
        [--input_format raw] [--backend gpu|distributed|cpu] \
        [--device cuda|cpu] [--placement device|sharded|cpu]

Every backend runs through the execution pipeline
(``engine/scheduler.py``): ``--backend gpu`` (the default) places each
query on the port's device engine, ``distributed`` on the sharded engine
(a world of one rank without a launch environment:
``parallel/multihost.py``), both on ``--device`` (default ``cuda``, the
card), and a query that runs the card out of memory walks down to the
CPU oracle, which ``--backend cpu`` runs alone; ``--placement`` pins the
placement of every query. Without a card and without ``--device cpu``
the CLI exits non-zero before it loads or writes anything. ``--warmup`` runs each query that many times before the timed
run (q15's view parts are never warmed); at 0, the default, a plan's
first run (eager, then the capture of its CUDA graph) is inside its
timed query.

``--input_format`` is ``parquet`` (the default), ``orc``, ``json`` or
``avro`` for a warehouse written by ``transcode``, or ``raw`` for
``gen_data``'s text; the ``io.verify_digests`` config key verifies each
file against its table's digest manifest before it is parsed.

``--resume`` replays the run dir's query journal
(``<unit>_queries.json`` in ``--json_summary_folder``, else beside the
time log): statements journaled done are not run again, the rest run,
and the resumed run writes ``merged-<unit>.json``. A SIGTERM or SIGINT
drains (the in-flight query finishes, then the CLI exits 75, resumable;
``NDS_TPU_DRAIN_S`` bounds the wait). See ``utils/power_core.py``.

Not ported yet, each with its ROADMAP Queue 1 item: ``--placement
chunked`` (item 6), ``--profile_dir`` and ``--trace`` (item 7,
observability), ``--cache_dir`` and ``--cache_readonly`` (no
counterpart: a CUDA graph does not outlive its process).
"""

from __future__ import annotations

import argparse
import sys

from nds_tpu_torch.device import NoCudaDevice
from nds_tpu_torch.engine.session import Session
from nds_tpu_torch.nds_h import streams
from nds_tpu_torch.nds_h.schema import get_schemas
from nds_tpu_torch.utils import power_core

SUITE = power_core.Suite(
    name="nds_h",
    get_schemas=get_schemas,
    parse_query_stream=streams.parse_query_stream,
    session_for=lambda factory, **kw: Session.for_nds_h(factory),
    raw_ext=".tbl",
    warmup_skip_prefixes=("query15_part",),
)

NOT_PORTED = ("not ported yet: --placement chunked (ROADMAP Queue 1 "
              "item 6), --profile_dir and --trace (item 7), --cache_dir "
              "and --cache_readonly (no counterpart: a CUDA graph does not "
              "outlive its process)")


def add_power_args(p) -> None:
    """The arguments both power CLIs take."""
    p.add_argument("data_dir", help="warehouse directory (transcode "
                   "output, or gen_data output with --input_format raw)")
    p.add_argument("query_stream", help="stream file")
    p.add_argument("time_log", help="output CSV time log path")
    p.add_argument("--backend", choices=list(power_core.BACKENDS),
                   default=None,
                   help="overrides engine.backend from template/property "
                        "files (default gpu: the port's device engine; "
                        "distributed: the sharded engine; cpu: the CPU "
                        "oracle)")
    p.add_argument("--device", default=None,
                   help="the gpu and distributed backends' torch device "
                        "(engine.device; default cuda, the card; cpu runs "
                        "them on the CPU)")
    p.add_argument("--placement", choices=["device", "sharded", "cpu"],
                   default=None,
                   help="pin the initial placement of every query "
                        "(engine.placement.force); default: the "
                        "scheduler's cost model picks per query")
    p.add_argument("--input_format",
                   choices=["parquet", "orc", "json", "avro", "raw"],
                   default="parquet")
    p.add_argument("--extra_time_log",
                   help="write a second copy of the CSV time log here")
    p.add_argument("--json_summary_folder",
                   help="folder for per-query JSON summaries")
    p.add_argument("--output_prefix",
                   help="save each query's result under this directory "
                        "(one parquet file per query)")
    p.add_argument("--warmup", type=int, default=0,
                   help="untimed runs per query before the timed one")
    p.add_argument("--allow_failure", action="store_true",
                   help="exit 0 even when queries failed")
    p.add_argument("--allow_recovered", action="store_true",
                   help="exit 0 where every query completed, some only "
                        "after the engine recovered from a task failure "
                        "(CompletedWithTaskFailures); a failed query "
                        "still exits 1")
    p.add_argument("--query_subset", nargs="+",
                   help="run only these query names")
    p.add_argument("--resume", action="store_true",
                   help="replay the run dir's query journal: statements "
                        "it holds as done are not run again")
    power_core.add_config_args(p)


def run(suite: power_core.Suite, args, config) -> None:
    """Run the stream and exit: 0 if every query completed cleanly (with
    ``--allow_recovered``, completed), or with ``--allow_failure``; 1
    otherwise, and on an uncaught error; 2 without the card asked for
    (before anything is loaded or written); 75 after a drain."""
    try:
        failures = power_core.run_query_stream(
            suite, args.data_dir, args.query_stream, args.time_log,
            config=config, input_format=args.input_format,
            json_summary_folder=args.json_summary_folder,
            output_prefix=args.output_prefix, warmup=args.warmup,
            query_subset=args.query_subset,
            extra_time_log=args.extra_time_log, resume=args.resume,
            recovered_ok=args.allow_recovered)
    except NoCudaDevice as e:
        print(f"[power] {e}", file=sys.stderr)
        sys.exit(2)
    sys.exit(0 if (args.allow_failure or not failures) else 1)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="NDS-H power run on the port's engine; " + NOT_PORTED)
    add_power_args(p)
    args = p.parse_args(argv)
    run(SUITE, args, power_core.config_from_args(args))


if __name__ == "__main__":
    main()
