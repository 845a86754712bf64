"""NDS-H output validation: diff two power runs' saved query outputs.

Port copy of ``nds_tpu/nds_h/validate.py`` over the port's diff core
(``utils/validate_core.py``): per query, row-count check then row-by-row
compare with epsilon on float/decimal columns, the order-insensitive
mode, the NDS-H skips (query15_part1/3 produce no comparable output) and
q18's non-deterministic column. Exit status 0 only if every compared
query matches.

    python -m nds_tpu_torch.nds_h.validate out_cpu out_gpu stream_0.sql \
        --ignore_ordering
"""

from __future__ import annotations

import argparse
import os
import sys

from nds_tpu_torch.nds_h import streams
from nds_tpu_torch.utils.validate_core import compare_results as _compare_core

SKIP_QUERIES = {"query15_part1", "query15_part3"}
# q18: o_orderkey ties at the LIMIT 100 edge make that column's row
# content non-deterministic between engines; positional index 2
SKIP_COLUMNS = {"query18": [2]}


def compare_results(dir1: str, dir2: str, query_name: str,
                    ignore_ordering: bool = True,
                    epsilon: float = 0.00001) -> bool:
    return _compare_core(dir1, dir2, query_name, ignore_ordering,
                         epsilon, skip_columns=SKIP_COLUMNS)


def iterate_queries(dir1: str, dir2: str, stream_path: str,
                    ignore_ordering: bool = True,
                    epsilon: float = 0.00001) -> list[str]:
    """Compare every query in the stream; returns names that mismatched."""
    queries = streams.parse_query_stream(stream_path)
    unmatched = []
    for qname in queries:
        if qname in SKIP_QUERIES:
            print(f"=== Skipping {qname} ===")
            continue
        here1 = os.path.isdir(os.path.join(dir1, qname))
        here2 = os.path.isdir(os.path.join(dir2, qname))
        if not here1 and not here2:
            # subset runs leave most queries without output; loud so a
            # double-crash (both engines failed the query) is visible
            print(f"=== {qname}: no output on either side — "
                  f"not compared ===")
            continue
        if here1 != here2:
            print(f"=== {qname}: output present on only one side ===")
            unmatched.append(qname)
            continue
        ok = compare_results(dir1, dir2, qname, ignore_ordering, epsilon)
        status = "MATCH" if ok else "MISMATCH"
        print(f"=== Comparing Query: {qname} -> {status} ===")
        if not ok:
            unmatched.append(qname)
    if unmatched:
        print(f"Unmatched queries: {unmatched}")
    return unmatched


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="diff saved query outputs from two power runs")
    p.add_argument("dir1", help="first output_prefix (e.g. CPU oracle run)")
    p.add_argument("dir2", help="second output_prefix (e.g. GPU run)")
    p.add_argument("query_stream", help="stream file both runs executed")
    p.add_argument("--epsilon", type=float, default=0.00001)
    p.add_argument("--ignore_ordering", action="store_true")
    args = p.parse_args(argv)
    unmatched = iterate_queries(args.dir1, args.dir2, args.query_stream,
                                args.ignore_ordering, args.epsilon)
    sys.exit(1 if unmatched else 0)


if __name__ == "__main__":
    main()
