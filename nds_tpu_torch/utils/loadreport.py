"""Load-report parsing shared by both suites' orchestrators.

Port copy of ``nds_tpu/utils/loadreport.py`` (standard library only).
The report is the inter-phase state file of the reference pipeline
(`nds/nds_transcode.py:205-229` writes it; `nds/nds_bench.py:60-89`
reads the load time and RNGSEED back). Parsing is ANCHORED to the
written format — a drifted report raises instead of returning a
silently-wrong number.
"""

from __future__ import annotations

import re

_TOTAL_RE = re.compile(
    r"^Total conversion time for \d+ tables was (?P<secs>[0-9.]+)s\s*$")
_RNGSEED_RE = re.compile(r"^RNGSEED used:\s*(?P<seed>\d+)\s*$")


def get_load_time(report_path: str) -> float:
    """Total load seconds from the report header line (anchored to the
    exact format ``transcode`` writes)."""
    with open(report_path) as f:
        first = f.readline()
    m = _TOTAL_RE.match(first)
    if not m:
        raise ValueError(
            f"load report {report_path} header not recognised: {first!r}")
    return float(m.group("secs"))


def get_rngseed(report_path: str) -> int:
    """The RNGSEED (load-end timestamp) recorded in the report
    (`nds/nds_bench.py:60-74` contract)."""
    with open(report_path) as f:
        for line in f:
            m = _RNGSEED_RE.match(line)
            if m:
                return int(m.group("seed"))
    raise ValueError(f"no RNGSEED in {report_path}")
