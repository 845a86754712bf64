"""Round benchmark of the port: NDS-H (22 queries) + NDS (103 statements,
the 99 TPC-DS templates with q14/q23/q24/q39 split into _part1/_part2)
power runs, the port's device engine on the card vs the CPU oracle.

    python -m nds_tpu_torch.bench                      # on the card
    BENCH_DEVICE=cpu python -m nds_tpu_torch.bench     # on the CPU

Port of the root ``bench.py`` (its lines 1-606). It prints the same
lines with the same keys and metric names: ONE JSON line {"metric",
"value", "unit", "vs_baseline", ...} as the LAST line of stdout, the
combined two-leg power total (``nds+nds_h_power_total``), with the
per-leg metrics (``nds_h_sf*_power_total``, ``nds_sf*_power_total``) in
its "legs" object; the same combined line after every unit, so a
timeout mid-run still leaves the best-known metric on stdout; a
"per_query" block of every completed unit's device seconds plus the
worst-5 regressions vs BASELINE.json's optional "per_query" map
(computed by ``obs/analyze.diff_times``). Each line also carries
``platform`` ("cuda" or "cpu") and ``device`` (the card's name and power
limit as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
gives them; null on the CPU).

Methodology follows the reference power run (bracketed wall-clock around
execute+collect per query, `nds/PysparkBenchReport.py:87-105`): each
unit runs once untimed (planning, the executor's buffers and the
kernels' first launches), then timed on the port's device engine, each
unit ending in the executor's device->host copy and a
``torch.cuda.synchronize()``, then on the CPU oracle as the baseline;
value = device power-run total seconds; vs_baseline = cpu_total /
device_total over completed units (>1 means the device engine wins).

What differs from the root bench:
- ``BENCH_DEVICE`` (default ``cuda``) picks the device; the CPU must be
  asked for (``BENCH_DEVICE=cpu``), and there is no fallback: where
  ``cuda`` is asked and ``torch.cuda.is_available()`` is false, the bench
  runs nothing and exits 4 with a line marked ``stale_device_times`` from
  its own banks of earlier card runs, else 5 with ``device_unreachable``;
- device times are banked only from runs on the card (never CPU
  wall-clocks);
- its data root is a directory of its own, ``.bench_data/nds_tpu_torch/``
  (``BENCH_DATA``), never the root bench's ``.bench_data/``, whose
  ``device_times_*`` banks are TPU times; the root bench's legacy data
  layout (``sf<N>``) is not read;
- there is no XLA cache: the CUDA kernels are built before the first leg
  (so no unit's warm-up pays for ``nvcc``) and their build directory is
  printed;
- the per-unit stderr line carries the port's execute_ms and
  materialize_ms (``obs.query_timings``).

Data persists under the data root and reloads on re-runs (one .npz per
table, ``io/table_cache.py``); CPU-oracle times bank there too
(``BENCH_CPU=fresh`` re-measures). SIGTERM/SIGINT prints the final line
from whatever has completed, pairing device and CPU times over the same
completed units, and exits 0.

Exit codes: 0 a fresh metric; 4 the card is unreachable and the line
holds banked card times (``stale_device_times``); 5 the card is
unreachable and nothing is banked (``device_unreachable``).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

SF_H = float(os.environ.get("BENCH_SF", "1"))
SF_DS = float(os.environ.get("BENCH_NDS_SF", "1"))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_ROOT = os.environ.get(
    "BENCH_DATA", os.path.join(REPO, ".bench_data", "nds_tpu_torch"))
# BASELINE.json's optional "per_query" map ({"leg:qname": seconds})
BASELINE = os.path.join(REPO, "BASELINE.json")
# which legs run (comma list); the NDS-H leg runs first so a budget
# kill still records the historical headline metric
LEGS = os.environ.get("BENCH_LEGS", "nds_h,nds").split(",")
# the device of the timed legs: "cuda" (the default) or "cpu"
DEVICE = os.environ.get("BENCH_DEVICE", "cuda")

# banked per-query results: (leg, qname) -> {"device_s": .., "cpu_s": ..}
# qname is a string: "7", or "14_part1"/"14_part2" for the four
# two-statement TPC-DS templates (103 executable statements per stream,
# reference `nds/nds_gen_query_stream.py:91-103` + `nds_power.py:50-77`)
BANK: dict[tuple, dict] = {}
LEG_TOTALS: dict[str, int] = {}  # leg -> queries_total
# the card's name and power limit (nvidia-smi), set where a card is found
CARD: "str | None" = None
_done = False


def nvidia_smi() -> "str | None":
    """The card's name and power limit as nvidia-smi gives them, or None
    where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def _leg_line(leg: str, metric: str) -> dict:
    paired = {k: r for k, r in BANK.items()
              if k[0] == leg and "device_s" in r and "cpu_s" in r}
    dev = sum(r["device_s"] for r in paired.values())
    cpu = sum(r["cpu_s"] for r in paired.values())
    return {
        "metric": metric,
        "value": round(dev, 4),
        "unit": "s",
        "vs_baseline": round(cpu / dev, 4) if dev else 0.0,
        "queries_completed": len(paired),
        "queries_total": LEG_TOTALS.get(leg, 0),
    }


def _metric_name(leg: str) -> str:
    return (f"nds_h_sf{SF_H:g}_power_total" if leg == "nds_h"
            else f"nds_sf{SF_DS:g}_power_total")


def _per_query_block() -> dict | None:
    """Worst-5 per-query regressions vs BASELINE.json's optional
    ``per_query`` map ({"leg:qname": seconds}), via ``obs/analyze`` —
    plus the current per-query device times, so a bench run is a
    promotable baseline and not an opaque scalar. Never raises: this
    runs inside the SIGTERM path."""
    try:
        cur = {f"{leg}:{qn}": round(r["device_s"], 4)
               for (leg, qn), r in BANK.items() if "device_s" in r}
        if not cur:
            return None
        block: dict = {"times": cur}
        try:
            with open(BASELINE) as f:
                base = json.load(f).get("per_query") or {}
        except (OSError, ValueError):
            base = {}
        if base:
            from nds_tpu_torch.obs.analyze import diff_times
            d = diff_times({q: s * 1000.0 for q, s in base.items()},
                           {q: s * 1000.0 for q, s in cur.items()},
                           pct=10.0, abs_ms=50.0)
            block["baseline_compared"] = (
                len(d["regressions"]) + len(d["improvements"])
                + len(d["noise"]))
            block["worst_regressions"] = d["regressions"][:5]
            block["improvements_n"] = len(d["improvements"])
        return block
    except Exception:  # noqa: BLE001 - metric line must always emit
        return None


def _combined_dict() -> dict:
    legs = {}
    dev = cpu = completed = total = 0
    for leg in LEGS:
        line = _leg_line(leg, _metric_name(leg))
        legs[_metric_name(leg)] = line
        dev += line["value"]
        cpu += line["value"] * line["vs_baseline"]
        completed += line["queries_completed"]
        total += line["queries_total"]
    out = {
        "metric": "nds+nds_h_power_total",
        "value": round(dev, 4),
        "unit": "s",
        "vs_baseline": round(cpu / dev, 4) if dev else 0.0,
        "queries_completed": completed,
        "queries_total": total,
        "legs": legs,
        "platform": DEVICE,
        "device": CARD,
    }
    pq = _per_query_block()
    if pq:
        out["per_query"] = pq
    return out


def _combined_line() -> str:
    return json.dumps(_combined_dict())


def _emit_final() -> None:
    global _done
    if _done:
        return
    _done = True
    print(_combined_line(), flush=True)


def _on_term(signum, frame):
    print(f"[bench] signal {signum}: emitting partial metric "
          f"({len(BANK)} queries banked)", file=sys.stderr, flush=True)
    _emit_final()
    sys.exit(0)


def _load_or_gen(leg: str):
    from nds_tpu_torch.io import table_cache
    from nds_tpu_torch.io.host_table import from_arrays
    if leg == "nds_h":
        from nds_tpu_torch.datagen import tpch as gen
        from nds_tpu_torch.nds_h.schema import get_schemas
        sf = SF_H
    else:
        from nds_tpu_torch.datagen import tpcds as gen
        from nds_tpu_torch.nds.schema import get_schemas
        sf = SF_DS
    schemas = get_schemas()
    data_dir = os.path.join(DATA_ROOT, f"{leg}_sf{sf:g}")
    cached = table_cache.load_tables(data_dir, schemas)
    if cached is not None:
        print(f"[bench] {leg}: loaded SF{sf:g} data from {data_dir}",
              file=sys.stderr, flush=True)
        return cached
    print(f"[bench] {leg}: generating SF{sf:g} data...", file=sys.stderr,
          flush=True)
    tables = {t: from_arrays(t, schemas[t], gen.gen_table(t, sf))
              for t in schemas}
    table_cache.save_tables(data_dir, tables)
    return tables


def _statements(leg: str, qn: int, sql: str) -> list[str]:
    if leg == "nds_h":
        from nds_tpu_torch.nds_h.streams import statements
        return list(statements(qn, sql))
    return [s.strip() for s in sql.split(";") if s.strip()]


def _run_query(session, stmts: list[str], sync: bool = False) -> float:
    """Seconds of the statements, each ending in the executor's
    device->host copy; with ``sync``, then a synchronize of the card."""
    t0 = time.perf_counter()
    for s in stmts:
        session.sql(s)
    if sync:
        import torch
        torch.cuda.synchronize()
    return time.perf_counter() - t0


# -------------------------------------------------- CPU-oracle time bank
#
# The CPU-oracle denominator costs more wall-clock than the device leg
# itself. CPU times are a property of (suite, SF, query, host) only — the
# deterministic generators make the data identical across runs — so they
# bank to DATA_ROOT and reload. BENCH_CPU=fresh forces re-measurement.

def _cpu_bank_path(leg: str) -> str:
    sf = SF_H if leg == "nds_h" else SF_DS
    return os.path.join(DATA_ROOT, f"cpu_times_{leg}_sf{sf:g}.json")


# ------------------------------------------- device-time bank (stale
# fallback): completed per-query device times of runs on the card persist
# here; when no card is reachable at startup the bench emits the banked
# metric labeled "stale_device_times": true, and fails.

def _dev_bank_path(leg: str) -> str:
    sf = SF_H if leg == "nds_h" else SF_DS
    return os.path.join(DATA_ROOT, f"device_times_{leg}_sf{sf:g}.json")


def _rows_fingerprint(tables) -> dict:
    return {t: tb.nrows for t, tb in tables.items()}


_BANK_DEVICE_TIMES = True  # cleared when the timed leg runs on the CPU


def _purge_presplit(times: dict) -> dict:
    """A bank that timed a two-statement template as one combined key
    ('14') beside its part keys would double-count the template in a
    later stale emit — the split times win."""
    for base in [k for k in times
                 if "_part" not in k and f"{k}_part1" in times]:
        del times[base]
    return times


def _save_dev_bank(leg: str, rows: dict) -> None:
    if not _BANK_DEVICE_TIMES:
        return  # never bank CPU wall-clocks as device_s
    path = _dev_bank_path(leg)
    # merge with what's on disk: a partial run must refine, never
    # destroy, the last complete run's banked times (the stale
    # fallback's whole value)
    try:
        with open(path) as f:
            bank = json.load(f)
        if "times" not in bank:  # legacy flat {qname: s} format
            bank = {"rows": None, "times": bank}
    except (OSError, ValueError):
        bank = {"rows": None, "times": {}}
    if bank["rows"] is not None and bank["rows"] != rows:
        bank = {"rows": None, "times": {}}  # data changed: restart bank
    bank["rows"] = rows
    bank["times"].update(
        {qn: r["device_s"] for (lg, qn), r in BANK.items()
         if lg == leg and "device_s" in r})
    _purge_presplit(bank["times"])
    with open(path + ".tmp", "w") as f:
        json.dump(bank, f)
    os.replace(path + ".tmp", path)


def _load_bank_pair(leg: str, dev_path: str, cpu_path: str) -> int:
    """Pair one device bank with its cpu bank into BANK; returns pairs
    added. Fingerprint discipline: when both banks carry a rows
    fingerprint they must match; a device bank without one pairs only
    against same-SF cpu times (same path key) and is labeled by the
    caller."""
    try:
        with open(dev_path) as f:
            dev_bank = json.load(f)
        if "times" not in dev_bank:
            dev_bank = {"rows": None, "times": dev_bank}
    except (OSError, ValueError):
        return 0
    try:
        with open(cpu_path) as f:
            cpu_bank = json.load(f)
    except (OSError, ValueError):
        return 0
    if dev_bank["rows"] is not None \
            and cpu_bank.get("rows") not in (None, dev_bank["rows"]):
        return 0  # regenerated data: refuse the mismatched ratio
    added = 0
    cpu_times = _purge_presplit(dict(cpu_bank.get("times", {})))
    _purge_presplit(dev_bank["times"])
    for qn, ds in dev_bank["times"].items():
        if qn in cpu_times:
            BANK[(leg, qn)] = {"device_s": ds, "cpu_s": cpu_times[qn]}
            added += 1
    return added


def _emit_stale_from_banks() -> bool:
    """Load banked device+cpu times and emit the combined line with an
    explicit staleness marker. Returns False if no banked device leg
    exists (nothing honest to report). Falls back to banks at OTHER
    scale factors when the configured SF has none, relabeling the
    metric accordingly."""
    import glob
    any_pairs = False
    fallback_sf = {}
    for leg in LEGS:
        n = _load_bank_pair(leg, _dev_bank_path(leg), _cpu_bank_path(leg))
        if n == 0:
            # any completed card run at another SF beats silence
            pat = os.path.join(DATA_ROOT, f"device_times_{leg}_sf*.json")
            for dev_path in sorted(glob.glob(pat), reverse=True):
                sf = os.path.basename(dev_path)[
                    len(f"device_times_{leg}_sf"):-len(".json")]
                cpu_path = os.path.join(
                    DATA_ROOT, f"cpu_times_{leg}_sf{sf}.json")
                if _load_bank_pair(leg, dev_path, cpu_path):
                    fallback_sf[leg] = sf
                    break
        any_pairs = any_pairs or any(k[0] == leg for k in BANK)
    if not any_pairs:
        return False
    line = _combined_dict()
    line["stale_device_times"] = True
    if fallback_sf:
        line["stale_fallback_sf"] = fallback_sf
    line["note"] = ("CUDA device unreachable at bench time; values are "
                    "the last completed card run's banked per-query "
                    "times")
    print(json.dumps(line), flush=True)
    return True


def _load_cpu_bank(leg: str, tables) -> dict:
    if os.environ.get("BENCH_CPU", "auto") == "fresh":
        return {}
    try:
        with open(_cpu_bank_path(leg)) as f:
            bank = json.load(f)
    except (OSError, ValueError):
        return {}
    # fingerprint: banked times are only valid for identical data
    rows = {t: tb.nrows for t, tb in tables.items()}
    if bank.get("rows") != rows:
        return {}
    return bank.get("times", {})


def _save_cpu_bank(leg: str, tables, times: dict) -> None:
    path = _cpu_bank_path(leg)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"rows": {t: tb.nrows for t, tb in tables.items()},
                   "times": _purge_presplit(dict(times))}, f)
    os.replace(tmp, path)


# transient failures (a dropped connection, a resource briefly
# unavailable): any failure matching these marks retries instead of
# failing the query
_TRANSIENT = ("brokenpipe", "unexpected eof", "response body closed",
              "connection", "unavailable", "deadline", "transport",
              "remote_compile", "socket")


def _is_transient(exc: BaseException) -> bool:
    s = f"{type(exc).__name__}: {exc}".lower()
    return any(t in s for t in _TRANSIENT)


def _cleanup_views(session, stmts: list[str]) -> None:
    """Best-effort drop of any views a half-completed statement list
    left behind, so a retry can replay CREATE VIEW statements."""
    for s in stmts:
        if s.lstrip().lower().startswith("drop view"):
            try:
                session.sql(s)
            except Exception:  # noqa: BLE001
                pass


def _leg_units(leg: str) -> list:
    """[(qname, [stmt, ...]), ...] — one unit per TIMED query. NDS
    two-statement templates contribute one unit per statement
    (query14_part1/query14_part2 timed separately, the reference's
    `nds_power.py:50-77` contract → 103 NDS units); NDS-H keeps one
    unit per template with q15's create-view/select/drop statements
    timed together."""
    units = []

    def _render(qn, streams):
        # a broken template must cost one unit, not the whole bench
        # (this runs at startup, before any metric can be emitted)
        try:
            return _statements(leg, qn, streams.render_query(qn))
        except Exception as exc:  # noqa: BLE001
            print(f"[bench] {leg} q{qn}: template render failed "
                  f"({type(exc).__name__}: {exc})", file=sys.stderr,
                  flush=True)
            return None

    if leg == "nds_h":
        from nds_tpu_torch.nds_h import streams
        for qn in range(1, 23):
            units.append((str(qn), _render(qn, streams)))
        return units
    from nds_tpu_torch.nds import streams
    qids = streams.available_templates()
    # the root bench's order: the templates of the largest programs run
    # LAST (BENCH_DEFER), so a budget kill still banks the other queries.
    # Pure ordering — every template still runs
    defer = {int(x) for x in os.environ.get(
        "BENCH_DEFER", "39,59,67,78").split(",") if x}
    for qn in ([q for q in qids if q not in defer]
               + [q for q in qids if q in defer]):
        stmts = _render(qn, streams)
        if stmts is None or len(stmts) == 1:
            units.append((str(qn), stmts))
        else:
            for i, s in enumerate(stmts, 1):
                units.append((f"{qn}_part{i}", [s]))
    return units


def _run_leg(leg: str) -> None:
    from nds_tpu_torch import obs
    from nds_tpu_torch.engine.device_exec import make_device_factory
    from nds_tpu_torch.engine.session import Session

    mk = Session.for_nds_h if leg == "nds_h" else Session.for_nds
    units = _leg_units(leg)
    tables = _load_or_gen(leg)
    rows = _rows_fingerprint(tables)
    on_card = DEVICE == "cuda"
    dev = mk(make_device_factory(device=None if on_card else DEVICE))
    cpu = mk()
    for t in tables.values():
        dev.register_table(t)
        cpu.register_table(t)

    cpu_bank = _load_cpu_bank(leg, tables)
    if cpu_bank:
        print(f"[bench] {leg}: {len(cpu_bank)} banked cpu-oracle times "
              f"from {_cpu_bank_path(leg)}", file=sys.stderr, flush=True)

    for qn, stmts in units:
        if stmts is None:  # template failed to render at startup
            continue
        # one broken query must not cost the rest of the run (the
        # reference's --allow_failure mode, `nds/nds_power.py:391-393`)
        try:
            # untimed warmup: planning, uploads and first launches, one
            # execution per statement; a transient failure retries PER
            # STATEMENT (retrying the whole list would replay a
            # succeeded CREATE VIEW and turn the transient into a hard
            # 'view already exists')
            for s in stmts:
                for attempt in range(3):
                    try:
                        dev.sql(s)
                        break
                    except Exception as exc:  # noqa: BLE001
                        if attempt == 2 or not _is_transient(exc):
                            raise
                        print(f"[bench] {leg} q{qn}: transient warm-up "
                              f"error, retrying statement",
                              file=sys.stderr, flush=True)
            # on the card the warm-up captured each plan's graph: its
            # compile_ms (the timed run replays, at 0)
            warm_tm = obs.query_timings(dev._executor_factory(dev.tables))
            # timed run, with transient retry (the whole statement list
            # replays; drops run first so re-created views don't collide)
            for attempt in range(3):
                try:
                    dev_s = _run_query(dev, stmts, sync=on_card)
                    break
                except Exception as exc:  # noqa: BLE001
                    if attempt == 2 or not _is_transient(exc):
                        raise
                    print(f"[bench] {leg} q{qn}: transient error in "
                          f"timed run ({type(exc).__name__}), retrying",
                          file=sys.stderr, flush=True)
                    _cleanup_views(dev, stmts)
            BANK.setdefault((leg, qn), {})["device_s"] = dev_s
            _save_dev_bank(leg, rows)
            # engine-side accounting of the timed run's last statement
            tm = obs.query_timings(dev._executor_factory(dev.tables))
            banked = cpu_bank.get(qn)
            if banked is not None:
                cpu_s = float(banked)
            else:
                cpu_s = _run_query(cpu, stmts)
                cpu_bank[qn] = cpu_s
                _save_cpu_bank(leg, tables, cpu_bank)
            BANK[(leg, qn)]["cpu_s"] = cpu_s
        except Exception as exc:  # noqa: BLE001
            BANK.pop((leg, qn), None)
            print(f"[bench] {leg} q{qn}: FAILED {type(exc).__name__}: "
                  f"{exc}", file=sys.stderr, flush=True)
            continue
        print(f"[bench] {leg} q{qn}: {DEVICE} {dev_s*1000:.0f} ms "
              f"(exec {tm.get('execute_ms', 0):.0f} "
              f"mat {tm.get('materialize_ms', 0):.0f} "
              f"compile {warm_tm.get('compile_ms', 0):.0f}) | "
              f"cpu {cpu_s*1000:.0f} ms"
              f"{' [banked]' if banked is not None else ''}",
              file=sys.stderr, flush=True)
        # the full combined partial (not a leg-scoped line): a hard kill
        # may never run the SIGTERM handler, so the last printed line
        # must already carry every completed leg
        print(_combined_line(), flush=True)


# exit codes for non-fresh metrics: a banked number must be a LOUD
# failure, not a silently emitted line
EXIT_STALE_METRIC = 4        # emitted, but from banked device times
EXIT_NO_METRIC = 5           # device unreachable and no bank either


def main() -> int:
    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, _on_term)
    if DEVICE not in ("cuda", "cpu"):
        print(f"[bench] BENCH_DEVICE={DEVICE!r}: not cuda or cpu",
              file=sys.stderr, flush=True)
        return 2

    # totals for EVERY leg up front, before the device is touched: a kill
    # at any point must still count every leg's queries in queries_total
    # (else a 22/22 nds_h-only partial reads as a complete 125-unit run).
    # NDS counts 103 units (the four two-statement templates split).
    for leg in LEGS:
        LEG_TOTALS[leg] = len(_leg_units(leg))

    import torch
    global _BANK_DEVICE_TIMES, CARD
    _BANK_DEVICE_TIMES = DEVICE == "cuda"
    if DEVICE == "cuda" and not torch.cuda.is_available():
        print("[bench] no CUDA device (torch.cuda.is_available() is "
              "false) — emitting the banked metric of the last completed "
              "card run; nothing runs on the CPU", file=sys.stderr,
              flush=True)
        if _emit_stale_from_banks():
            # the stale line still prints (a labeled partial beats
            # silence for a human reader) but the RUN FAILS: a banked
            # number is never booked as a fresh measurement
            print(f"[bench] exit {EXIT_STALE_METRIC}: stale/banked "
                  f"device times are not a fresh metric",
                  file=sys.stderr, flush=True)
            return EXIT_STALE_METRIC
        print("[bench] no banked card run available either — "
              "no honest metric to emit", file=sys.stderr, flush=True)
        line = _combined_dict()
        line["device_unreachable"] = True
        print(json.dumps(line), flush=True)
        return EXIT_NO_METRIC

    if DEVICE == "cuda":
        CARD = nvidia_smi()
        from nds_tpu_torch.engine import cuda_build
        t0 = time.perf_counter()
        built = cuda_build.build_all()
        for name in cuda_build.SIGNATURES:
            cuda_build.library(name)
        print(f"[bench] kernels: {cuda_build.BUILD_DIR} "
              f"({len(built)} built in {time.perf_counter() - t0:.1f} s)",
              file=sys.stderr, flush=True)
        print(f"[bench] device: {torch.cuda.get_device_name(0)} ({CARD}); "
              f"torch {torch.__version__} cuda {torch.version.cuda}",
              file=sys.stderr, flush=True)
    else:
        print(f"[bench] device: cpu; torch {torch.__version__}",
              file=sys.stderr, flush=True)

    for leg in LEGS:
        _run_leg(leg)

    _emit_final()
    return 0


if __name__ == "__main__":
    sys.exit(main())
