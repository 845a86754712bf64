"""NDS rollback CLI.

Port copy of ``nds_tpu/nds/rollback.py``. As `nds/nds_rollback.py:46-51`:
undo data-maintenance mutations by rolling the warehouse's fact tables
back to a timestamp —
there via Iceberg ``rollback_to_timestamp``, here by truncating the
snapshot manifest (``io/snapshots.py``); files written by undone
versions stay on disk but drop out of the live file map.
"""

from __future__ import annotations

import argparse

from nds_tpu_torch.io.snapshots import SnapshotLog
from nds_tpu_torch.nds.maintenance import MUTABLE_TABLES

tables_to_rollback = MUTABLE_TABLES


def rollback(warehouse_dir: str, timestamp: float) -> None:
    log = SnapshotLog(warehouse_dir)
    before = log.entries[-1]["version"] if log.entries else None
    after = log.rollback_to_timestamp(timestamp)
    print(f"rolled back {warehouse_dir}: v{before} -> "
          f"{'baseline' if after is None else f'v{after}'}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="roll the warehouse back to a timestamp")
    p.add_argument("warehouse_dir")
    p.add_argument("--timestamp", type=float, default=None,
                   help="unix seconds; default: before every commit "
                        "(baseline)")
    args = p.parse_args(argv)
    if args.timestamp is None:
        print("no --timestamp given: rolling back to the baseline")
    rollback(args.warehouse_dir,
             args.timestamp if args.timestamp is not None else 0.0)


if __name__ == "__main__":
    main()
