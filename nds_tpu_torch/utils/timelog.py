"""CSV time-log writer.

Port copy of ``nds_tpu/utils/timelog.py``: header and rows match the
reference power-run time log (``application_id``, ``query``,
``time/milliseconds``), with rows for the phase brackets (CreateTempView,
Power Test Time, Total Time), so tooling that parses the reference CSV
parses the port's.
"""

from __future__ import annotations

import csv
import os

HEADER = ["application_id", "query", "time/milliseconds"]


class TimeLog:
    def __init__(self, app_id: str) -> None:
        self.app_id = app_id
        self.rows: list[list] = []

    def add(self, query_name: str, millis: int) -> None:
        self.rows.append([self.app_id, query_name, int(millis)])

    def write(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(HEADER)
            w.writerows(self.rows)

    @staticmethod
    def read(path: str) -> list[tuple[str, str, int]]:
        out = []
        with open(path, newline="") as f:
            r = csv.reader(f)
            header = next(r)
            if header != HEADER:
                raise ValueError(f"unexpected time log header {header!r} in {path}")
            for app_id, query, ms in r:
                out.append((app_id, query, int(ms)))
        return out
