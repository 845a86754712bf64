"""Run analysis of the port: the per-query comparison of two timing maps.

Port copy of ``diff_times`` alone from ``nds_tpu/obs/analyze.py``; the
port's ``bench.py`` reads it for its ``per_query`` block. The rest of the
reference's module (run-dir ingestion, time attribution, the regression
gate and its report) waits for ROADMAP Queue 1 item 7.
"""

from __future__ import annotations


def diff_times(base: dict, cur: dict, pct: float = 10.0,
               abs_ms: float = 50.0) -> dict:
    """Core noise-aware comparison over two {name: ms} maps (the same
    code path gates fixture run-dirs in CI and the round bench's
    per-query block). Regression: cur exceeds base by BOTH >pct% and
    >=abs_ms. Symmetric for improvements; everything else is noise."""
    regressions, improvements, noise = [], [], []
    for name in sorted(set(base) & set(cur)):
        b, c = float(base[name]), float(cur[name])
        d = c - b
        entry = {"query": name, "base_ms": round(b, 3),
                 "cur_ms": round(c, 3), "delta_ms": round(d, 3),
                 "pct": round(d / b * 100.0, 2) if b > 0 else None}
        # a zero/negative baseline (clock-skew steady-state, zeroed
        # BASELINE entry) makes the relative test vacuous: any growth
        # past the absolute floor is then a regression, not noise
        if d >= abs_ms and (b <= 0 or c > b * (1 + pct / 100.0)):
            regressions.append(entry)
        elif -d >= abs_ms and b > 0 and c < b * (1 - pct / 100.0):
            improvements.append(entry)
        else:
            noise.append(entry)
    regressions.sort(
        key=lambda e: -(e["pct"] if e["pct"] is not None
                        else float("inf")))
    improvements.sort(key=lambda e: (e["pct"] or 0))
    return {
        "regressions": regressions,
        "improvements": improvements,
        "noise": noise,
        "added": sorted(set(cur) - set(base)),
        "removed": sorted(set(base) - set(cur)),
        "gate": {"pct": pct, "abs_ms": abs_ms},
    }
