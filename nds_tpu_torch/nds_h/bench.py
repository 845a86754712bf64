"""NDS-H whole-benchmark orchestrator.

Port of ``nds_tpu/nds_h/bench.py``: run the phases in TPC order as
subprocesses of the port's CLIs (crash isolation; state passes through
report files), then compute the composite metric. Phases: data-gen ->
load (transcode) -> stream-gen (RNGSEED = the load's end timestamp) ->
power -> throughput. NDS-H has no data-maintenance phase, so the
composite is the 3-term geometric form of the NDS metric
(``get_perf_metric``). Config comes from a YAML like
``nds_tpu_torch/configs/bench_nds_h.yml``::

    python -m nds_tpu_torch.nds_h.bench bench_nds_h.yml

What changes from the reference:

- ``backend`` defaults to ``gpu`` (the port's device engine), and every
  engine phase (power, throughput) runs on the card unless the YAML
  names ``device: cpu``. ``gen_data`` and ``transcode`` are host work.
- ``throughput_mode`` defaults to ``inprocess`` for ``gpu`` (one
  process, one CUDA context and graph pool for every stream: the
  one-card mode) and to ``subprocess`` otherwise, as in the NDS
  orchestrator; the in-process round runs in this process and releases
  the card's cached memory when it ends.
- The YAML keys ``cache`` and ``metrics_snap`` are refused
  (``NOT_PORTED``), each naming its item.
- The power CLI runs with ``--allow_recovered``: a statement that
  completed after the engine recovered from a task failure
  (``CompletedWithTaskFailures``: a join's doubled-slack retry on the
  card, every result right) does not fail the bench, and the power loop
  prints it. The reference's bench fails there.
- A fresh power phase first removes what an earlier run left at its
  outputs (the time log, the summary folder), so the bench and the
  merged report read only this run's (``fresh_outputs``).

A phase subprocess that fails fails the bench (``CalledProcessError``).
"""

from __future__ import annotations

import argparse
import csv
import gc
import os
import shutil
import subprocess
import sys
import time

import yaml

from nds_tpu_torch.utils.loadreport import get_load_time, get_rngseed
from nds_tpu_torch.utils.timelog import TimeLog

# YAML keys of the reference's configs the port refuses, with the reason
NOT_PORTED = {
    "cache": "no counterpart: the plan cache stores compiled programs "
             "across processes, and a CUDA graph does not outlive its "
             "process (ROADMAP Queue 1 item 18)",
    "metrics_snap": "not ported yet: live metrics snapshots come with "
                    "observability (ROADMAP Queue 1 item 7)",
}


class BenchConfigError(ValueError):
    """The bench YAML names something the port refuses."""


def check_config(cfg: dict) -> None:
    """Refuse the YAML keys the port has no counterpart for yet, before
    any phase runs."""
    bad = [k for k in NOT_PORTED if cfg.get(k)]
    if bad:
        raise BenchConfigError("; ".join(
            f"{k}: {NOT_PORTED[k]}" for k in bad))


def engine_args(cfg: dict) -> list:
    """``--device`` for the engine phases: the YAML's ``device`` (the
    card when absent)."""
    return ["--device", str(cfg["device"])] if cfg.get("device") else []


def throughput_mode(cfg: dict, backend: str) -> str:
    return cfg.get("throughput_mode",
                   "inprocess" if backend == "gpu" else "subprocess")


def release_card() -> None:
    """Give back what an in-process round cached on the card, so the next
    phase's subprocess finds its memory free."""
    gc.collect()
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def analyze_phase(phase_name: str, run_dir: str) -> None:
    """The reference writes ``analysis.json`` and ``report.html`` here;
    the port's per-query attribution comes with observability."""
    print(f"[{phase_name}] run analysis not written: it comes with "
          f"observability (ROADMAP Queue 1 item 7); summaries in "
          f"{run_dir}")


def fresh_outputs(*paths: str) -> None:
    """Remove what an earlier run left at a phase's outputs (files or
    folders), so the bench reads only this run's."""
    for path in paths:
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)


def _run(cmd: list[str]) -> None:
    from nds_tpu_torch.utils.power_core import subprocess_env
    print("+", " ".join(cmd), flush=True)
    subprocess.run(cmd, check=True, env=subprocess_env())


def _run_rc(cmd: list[str]) -> int:
    """Like _run but returns the exit code: the caller tells a resumable
    exit (75, a drain; ``resilience/drain.py``) from a failure."""
    from nds_tpu_torch.utils.power_core import subprocess_env
    print("+", " ".join(cmd), flush=True)
    return subprocess.run(cmd, env=subprocess_env()).returncode


def get_power_time(time_log_path: str) -> float:
    """Power Test Time seconds from a power-run CSV log."""
    for _app, query, ms in TimeLog.read(time_log_path):
        if query == "Power Test Time":
            return ms / 1000.0
    raise ValueError(f"no Power Test Time row in {time_log_path}")


def get_perf_metric(scale: float, num_streams: int, tld: float, tpt: float,
                    ttt: float) -> int:
    """3-term NDS-H composite (the NDS 4-term form without the
    maintenance term)."""
    sq = max(num_streams, 1)
    tld_h = sq * 22 * tld / 3600.0
    tpt_h = sq * 22 * tpt / 3600.0
    ttt_h = ttt / 3600.0
    denom = (tpt_h * ttt_h * tld_h) ** (1.0 / 3.0)
    return int(scale * sq * 22 / denom) if denom > 0 else 0


def run_full_bench(cfg: dict) -> dict:
    check_config(cfg)
    paths = cfg["paths"]
    scale = float(cfg.get("scale_factor", 1))
    parallel = int(cfg.get("parallel", 2))
    num_streams = int(cfg.get("num_streams", 2))
    backend = cfg.get("backend", "gpu")
    raw_dir = paths["raw_data"]
    wh_dir = paths["warehouse"]
    stream_dir = paths["streams"]
    report_dir = paths.get("reports", "bench_reports")
    os.makedirs(report_dir, exist_ok=True)
    load_report = os.path.join(report_dir, "load_report.txt")
    metrics = {}
    skip = cfg.get("skip", {})

    if not skip.get("data_gen", False):
        _run([sys.executable, "-m", "nds_tpu_torch.nds_h.gen_data",
              str(scale), str(parallel), raw_dir, "--overwrite_output"])
    if not skip.get("load_test", False):
        _run([sys.executable, "-m", "nds_tpu_torch.nds_h.transcode",
              raw_dir, wh_dir, load_report])
    metrics["load_time_s"] = tld = get_load_time(load_report)
    rngseed = get_rngseed(load_report)

    if not skip.get("stream_gen", False):
        from nds_tpu_torch.nds_h.streams import generate_query_streams
        generate_query_streams(stream_dir, num_streams + 1,
                               rng_seed=rngseed, qualification=False)

    power_log = os.path.join(report_dir, "power_time.csv")
    if not skip.get("power_test", False):
        json_dir = os.path.join(report_dir, "json")
        fresh_outputs(power_log, json_dir)
        _run([sys.executable, "-m", "nds_tpu_torch.nds_h.power",
              wh_dir, os.path.join(stream_dir, "stream_0.sql"), power_log,
              "--backend", backend, *engine_args(cfg),
              "--json_summary_folder", json_dir, "--allow_recovered"])
    metrics["power_time_s"] = tpt = get_power_time(power_log)

    tstreams = [os.path.join(stream_dir, f"stream_{i}.sql")
                for i in range(1, num_streams + 1)]
    ttt = None
    if not skip.get("throughput_test", False):
        from nds_tpu_torch.nds import throughput as nds_tp
        from nds_tpu_torch.nds_h import throughput as tp
        tdir = os.path.join(report_dir, "throughput")
        device = cfg.get("device")
        if throughput_mode(cfg, backend) == "inprocess":
            from nds_tpu_torch.nds_h.power import SUITE
            try:
                ttt, codes = nds_tp.run_streams_inprocess(
                    wh_dir, tstreams, tdir, backend=backend,
                    device=device, suite=SUITE)
            finally:
                release_card()
        else:
            wd_cfg = cfg.get("watchdog") or {}
            ttt, codes = tp.run_streams(
                wh_dir, tstreams, tdir, backend=backend, device=device,
                stall_s=wd_cfg.get("stall_s"),
                max_restarts=wd_cfg.get("max_restarts"))
        if any(codes):
            raise SystemExit(f"throughput streams failed: {codes}")
    metrics["throughput_time_s"] = ttt

    # no composite without a real throughput term (a made-up Ttt would
    # skew the geometric mean)
    metrics["metric"] = (get_perf_metric(scale, num_streams, tld, tpt, ttt)
                         if ttt is not None else None)
    out_csv = paths.get("metrics_csv", os.path.join(report_dir,
                                                    "metrics.csv"))
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["scale", "streams", "load_s", "power_s",
                    "throughput_s", "metric", "timestamp"])
        w.writerow([scale, num_streams, tld, tpt, ttt, metrics["metric"],
                    int(time.time())])
    print(f"perf metric: {metrics['metric']} (details in {out_csv})")
    return metrics


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="full NDS-H benchmark on the "
                                "port's engine")
    p.add_argument("config", help="bench YAML (like "
                   "nds_tpu_torch/configs/bench_nds_h.yml)")
    args = p.parse_args(argv)
    with open(args.config) as f:
        cfg = yaml.safe_load(f)
    try:
        run_full_bench(cfg)
    except BenchConfigError as e:
        p.error(str(e))


if __name__ == "__main__":
    main()
