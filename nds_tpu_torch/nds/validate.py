"""NDS output validation: diff two power runs' saved query outputs.

Port of ``nds_tpu/nds/validate.py``: the file-based stream validator
(``iterate_queries``, ``update_summary``, ``main``) over the port's diff
core, with the reference validator's carve-outs (q65 skipped: ties at
the LIMIT edge; q67 skipped under floats mode; q78's rounded-ratio
column 3 at rel tol 0.01001), and ``unit_differs``, the same rules for
results held in memory (q65 then compared on its row count alone).

    python -m nds_tpu_torch.nds.validate out_cpu out_gpu query_0.sql \
        --ignore_ordering
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from nds_tpu_torch.nds import streams
from nds_tpu_torch.utils.validate_core import compare_results, frames_equal

SKIP_QUERIES = {"query65"}
FLOATS_SKIP_QUERIES = {"query67"}
# q78 emits a rounded ratio column (positional 3): both engines round a
# near-tie differently, tolerance widened
COLUMN_REL_TOL = {("query78", 3): 0.01001}


def unit_differs(got, exp, unit: str,
                 epsilon: float = 0.00001) -> "str | None":
    """None when a power-run unit's result frame (``unit`` is "7" or
    "14_part1") matches the oracle's under the validator's rules, else a
    one-line reason."""
    qname = "query" + unit.split("_part")[0]
    if qname in SKIP_QUERIES:
        if len(got) != len(exp):
            return f"row count {len(got)} vs {len(exp)}"
        return None
    tols = {col: tol for (q, col), tol in COLUMN_REL_TOL.items()
            if q == qname}
    return frames_equal(got, exp, epsilon, column_rel_tol=tols)


def iterate_queries(dir1: str, dir2: str, stream_path: str,
                    ignore_ordering: bool = True,
                    epsilon: float = 0.00001,
                    floats: bool = False) -> list[str]:
    """Compare every query in the stream; returns names that mismatched."""
    queries = streams.parse_query_stream(stream_path)
    unmatched = []
    for qname in queries:
        base = qname.split("_part")[0]
        if base in SKIP_QUERIES or (floats and base in
                                    FLOATS_SKIP_QUERIES):
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
        ok = compare_results(dir1, dir2, qname, ignore_ordering, epsilon,
                             column_rel_tol=COLUMN_REL_TOL)
        status = "MATCH" if ok else "MISMATCH"
        print(f"=== Comparing Query: {qname} -> {status} ===")
        if not ok:
            unmatched.append(qname)
    if unmatched:
        print(f"Unmatched queries: {unmatched}")
    return unmatched


def update_summary(summary_folder: str, unmatched: list[str]) -> None:
    """Patch queryValidationStatus into each per-query JSON summary."""
    for path in glob.glob(os.path.join(summary_folder, "*.json")):
        with open(path) as f:
            summary = json.load(f)
        qname = summary.get("query")
        if not qname:
            continue
        status = ("NotMatch" if qname in unmatched else "Match")
        summary["queryValidationStatus"] = [status]
        # this rewrites an existing summary in place: write a temporary
        # file and rename it over, so a crash cannot leave half a file
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(summary, f, indent=2)
        os.replace(tmp, path)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="diff saved query outputs from two NDS power runs")
    p.add_argument("dir1", help="first output_prefix (e.g. CPU oracle run)")
    p.add_argument("dir2", help="second output_prefix (e.g. GPU run)")
    p.add_argument("query_stream", help="stream file both runs executed")
    p.add_argument("--epsilon", type=float, default=0.00001)
    p.add_argument("--ignore_ordering", action="store_true")
    p.add_argument("--floats", action="store_true",
                   help="floats-mode run: skip q67 like the reference")
    p.add_argument("--json_summary_folder",
                   help="patch queryValidationStatus into these summaries")
    args = p.parse_args(argv)
    unmatched = iterate_queries(args.dir1, args.dir2, args.query_stream,
                                args.ignore_ordering, args.epsilon,
                                args.floats)
    if args.json_summary_folder:
        update_summary(args.json_summary_folder, unmatched)
    sys.exit(1 if unmatched else 0)


if __name__ == "__main__":
    main()
