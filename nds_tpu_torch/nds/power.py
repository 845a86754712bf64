"""NDS Power Run CLI.

Port of ``nds_tpu/nds/power.py`` over the port's power core: parse a
99-query stream by its dsqgen markers (the two-statement templates q14,
q23, q24 and q39 split into parts), register the 24 tables, run every
query in stream order recording per-query wall-clock ms, write the CSV
time log and per-query JSON summaries, honor ``--allow_failure`` and the
template/property-file config layers, and exit non-zero if any query
failed. ``--floats`` reads the money columns as doubles.

    python -m nds_tpu_torch.nds.power <warehouse> query_0.sql time.csv \
        [--input_format raw] [--backend gpu|distributed|cpu] \
        [--device cuda|cpu] [--placement device|sharded|cpu]

The CLI and what is not ported yet are the NDS-H CLI's
(``nds_tpu_torch/nds_h/power.py``).
"""

from __future__ import annotations

import argparse

from nds_tpu_torch.engine.session import Session
from nds_tpu_torch.nds import streams
from nds_tpu_torch.nds.schema import get_schemas
from nds_tpu_torch.nds_h.power import NOT_PORTED, add_power_args, run
from nds_tpu_torch.utils import power_core

SUITE = power_core.Suite(
    name="nds",
    get_schemas=get_schemas,
    parse_query_stream=streams.parse_query_stream,
    session_for=Session.for_nds,
    raw_ext=".dat",
    floats_toggle=True,
)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="NDS power run on the port's engine; " + NOT_PORTED)
    add_power_args(p)
    p.add_argument("--floats", action="store_true",
                   help="schema uses doubles instead of decimals")
    args = p.parse_args(argv)
    config = power_core.config_from_args(args)
    if args.floats:
        config.conf["engine.floats"] = "true"
    run(SUITE, args, config)


if __name__ == "__main__":
    main()
