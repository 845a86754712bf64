"""NDS whole-benchmark orchestrator.

Port of ``nds_tpu/nds/bench.py``: run the TPC-DS phases as subprocesses
of the port's CLIs in spec order: data-gen (base and one refresh set a
maintenance round) -> load (transcode) -> stream-gen (RNGSEED = the
load's end timestamp) -> power -> throughput 1 -> maintenance 1 ->
throughput 2 -> maintenance 2 -> validate (optional: the maintained
warehouse's engine outputs diffed against a CPU-oracle round through
``nds/validate.py``), then the 4-term composite metric::

    Q   = Sq * 99
    Tpt = Tpower * Sq / 3600 ;  Ttt = (Ttt1 + Ttt2) / 3600
    Tdm = (Tdm1 + Tdm2) / 3600 ; Tld = 0.01 * Sq * Tload / 3600
    metric = int(SF * Q / (Tpt * Ttt * Tdm * Tld) ** (1/4))

Config comes from a YAML like ``nds_tpu_torch/configs/bench_nds.yml``::

    python -m nds_tpu_torch.nds.bench bench_nds.yml [--resume]

Resumability: every completed phase journals its timings to
``bench_state.json`` in the report dir (``resilience/journal.py``'s
``PhaseJournal``); ``--resume`` replays completed phases from the
journal instead of running them again, and also resumes the phase it
reruns (the transcode's verified tables, the power run's journaled
statements, the maintenance round's committed functions). The journal
refuses a changed config. A power or maintenance phase that drained
(exit 75) runs again with ``--resume``, at most ``MAX_PHASE_RESUMES``
times.

What changes from the reference is the NDS-H orchestrator's
(``nds_tpu_torch/nds_h/bench.py``): ``backend`` defaults to ``gpu``,
every engine phase (power, throughput, maintenance, the engine round of
``validate``) runs on the card unless the YAML names ``device: cpu``,
``throughput_mode`` defaults to ``inprocess`` for ``gpu`` (two NDS
stream processes at SF1 on one 80 GB card are not reliable), the keys
``cache`` and ``metrics_snap`` are refused, the engine's power runs
(the power phase, validate's engine round) take ``--allow_recovered``,
a fresh power or validate phase first removes an earlier run's outputs
(``fresh_outputs``), and the post-phase analysis prints one line naming
ROADMAP Queue 1 item 7. A phase subprocess that fails fails the bench.
"""

from __future__ import annotations

import argparse
import csv
import os
import subprocess
import sys
import time

import yaml

from nds_tpu_torch.nds_h.bench import (
    BenchConfigError, _run, _run_rc, analyze_phase, check_config,
    engine_args, fresh_outputs, get_power_time, release_card,
    throughput_mode,
)
from nds_tpu_torch.resilience.journal import PhaseJournal, config_digest
from nds_tpu_torch.utils.loadreport import get_load_time, get_rngseed
from nds_tpu_torch.utils.timelog import TimeLog


# how many drain (exit 75) resumes a power or maintenance phase
# tolerates before the bench gives up
MAX_PHASE_RESUMES = 5


def get_maintenance_time(time_log_path: str) -> float:
    """Tdm seconds from a maintenance CSV log."""
    for _app, query, ms in TimeLog.read(time_log_path):
        if query == "Data Maintenance Time":
            return ms / 1000.0
    raise ValueError(f"no Data Maintenance Time row in {time_log_path}")


def get_stream_range(num_streams: int, first_or_second: int) -> list[int]:
    """Stream numbers per throughput test: 9 streams -> test 1 runs
    [1..4], test 2 runs [5..8]."""
    if first_or_second == 1:
        return list(range(1, num_streams // 2 + 1))
    return list(range(num_streams // 2 + 1, num_streams))


def get_perf_metric(scale: float, num_streams: int, tload: float,
                    tpower: float, ttt1: float, ttt2: float,
                    tdm1: float, tdm2: float) -> int:
    """4-term composite."""
    sq = max(num_streams, 1)
    q = sq * 99
    tpt = (tpower * sq) / 3600.0
    ttt = (ttt1 + ttt2) / 3600.0
    tdm = (tdm1 + tdm2) / 3600.0
    tld = (0.01 * sq * tload) / 3600.0
    denom = (tpt * ttt * tdm * tld) ** (1.0 / 4.0)
    return int(scale * q / denom) if denom > 0 else 0


def _resumable(base_cmd: list, resume: bool, what: str) -> None:
    """Run a phase CLI; on a drain (exit 75) run it again with
    ``--resume``, at most MAX_PHASE_RESUMES times. Any other failure
    fails the bench."""
    from nds_tpu_torch.resilience.drain import EXIT_RESUMABLE
    cmd = base_cmd + (["--resume"] if resume else [])
    resumes = 0
    while True:
        rc = _run_rc(cmd)
        if rc == 0:
            return
        if rc == EXIT_RESUMABLE and resumes < MAX_PHASE_RESUMES:
            resumes += 1
            print(f"== {what} drained (exit {EXIT_RESUMABLE}) — resuming "
                  f"({resumes}/{MAX_PHASE_RESUMES}) ==")
            cmd = base_cmd + ["--resume"]
            continue
        raise subprocess.CalledProcessError(rc, cmd)


def run_full_bench(cfg: dict, resume: bool = False) -> dict:
    check_config(cfg)
    paths = cfg["paths"]
    scale = float(cfg.get("scale_factor", 1))
    parallel = int(cfg.get("parallel", 2))
    # the total stream count is Sq*2+1 in the reference's bench.yml
    # convention: stream 0 powers, halves run the two throughput tests
    num_streams = int(cfg.get("num_streams", 2)) * 2 + 1
    backend = cfg.get("backend", "gpu")
    device = cfg.get("device")
    skip = cfg.get("skip", {})
    raw_dir = paths["raw_data"]
    refresh_base = paths.get("refresh_data",
                             os.path.join(raw_dir, "_refresh"))
    wh_dir = paths["warehouse"]
    stream_dir = paths["streams"]
    report_dir = paths.get("reports", "bench_reports")
    os.makedirs(report_dir, exist_ok=True)
    load_report = os.path.join(report_dir, "load_report.txt")
    metrics: dict = {"scale": scale, "streams": num_streams}

    journal = PhaseJournal(os.path.join(report_dir, "bench_state.json"),
                           config_digest(cfg))
    if resume:
        if journal.load():
            done = sorted(journal.state["phases"])
            print(f"== resuming: journal has {', '.join(done)} ==")
    else:
        # a fresh run must not leave a stale journal a later --resume
        # could splice in
        journal.reset()

    def phase(name, body):
        """Run one phase unless the journal already has it; journal the
        values the composite metric needs on completion. Phase bodies
        honor cfg['skip'] themselves."""
        if resume and journal.done(name):
            print(f"== skipping {name} (journaled) ==")
            return journal.timings(name)
        vals = body()
        journal.complete(name, **vals)
        return vals

    def _data_gen():
        if not skip.get("data_gen", False):
            _run([sys.executable, "-m", "nds_tpu_torch.nds.gen_data",
                  str(scale), str(parallel), raw_dir,
                  "--overwrite_output"])
            # one refresh set a maintenance round (2 a full bench)
            for update in (1, 2):
                _run([sys.executable, "-m", "nds_tpu_torch.nds.gen_data",
                      str(scale), "1", f"{refresh_base}{update}",
                      "--update", str(update), "--overwrite_output"])
        return {}

    def _load_test():
        if not skip.get("load_test", False):
            cmd = [sys.executable, "-m", "nds_tpu_torch.nds.transcode",
                   raw_dir, wh_dir, load_report]
            if resume:
                # an interrupted load resumes table by table: tables
                # whose digests verify are not transcoded again
                cmd.append("--resume")
            _run(cmd)
        return {"load_time_s": get_load_time(load_report),
                "rngseed": get_rngseed(load_report)}

    phase("data_gen", _data_gen)
    load_vals = phase("load_test", _load_test)
    metrics["load_time_s"] = tld = load_vals["load_time_s"]
    rngseed = load_vals["rngseed"]

    def _stream_gen():
        if not skip.get("stream_gen", False):
            from nds_tpu_torch.nds.streams import generate_query_streams
            # the load report's RNGSEED draws every stream's parameter
            # bindings: throughput streams are distinct workloads
            generate_query_streams(stream_dir, num_streams,
                                   rng_seed=rngseed, qualification=False)
        return {}

    phase("stream_gen", _stream_gen)

    power_log = os.path.join(report_dir, "power_time.csv")

    def _power_test():
        if not skip.get("power_test", False):
            # a bench-level --resume also resumes mid-phase: the query
            # journal in the json dir replays finished statements
            json_dir = os.path.join(report_dir, "json")
            if not resume:
                fresh_outputs(power_log, json_dir)
            _resumable([sys.executable, "-m", "nds_tpu_torch.nds.power",
                        wh_dir, os.path.join(stream_dir, "query_0.sql"),
                        power_log, "--backend", backend,
                        *engine_args(cfg), "--json_summary_folder",
                        json_dir, "--allow_recovered"],
                       resume, "power phase")
            analyze_phase("power", os.path.join(report_dir, "json"))
        return {"power_time_s": get_power_time(power_log)}

    metrics["power_time_s"] = tpt = phase(
        "power_test", _power_test)["power_time_s"]

    def _throughput(round_no):
        from nds_tpu_torch.nds import throughput as tp
        streams_n = get_stream_range(num_streams, round_no)
        tstreams = [os.path.join(stream_dir, f"query_{i}.sql")
                    for i in streams_n]
        tdir = os.path.join(report_dir, f"throughput{round_no}")
        if throughput_mode(cfg, backend) == "inprocess":
            try:
                ttt, codes = tp.run_streams_inprocess(
                    wh_dir, tstreams, tdir, backend=backend, device=device)
            finally:
                release_card()
        else:
            # YAML ``watchdog: {stall_s, max_restarts}`` arms subprocess
            # stream supervision
            wd_cfg = cfg.get("watchdog") or {}
            ttt, codes = tp.run_streams(
                wh_dir, tstreams, tdir, backend=backend, device=device,
                stall_s=wd_cfg.get("stall_s"),
                max_restarts=wd_cfg.get("max_restarts"))
        analyze_phase(f"throughput{round_no}", tdir)
        if any(codes):
            raise SystemExit(
                f"throughput {round_no} streams failed: {codes}")
        return {"ttt": ttt}

    def _maintenance(round_no):
        dm_log = os.path.join(report_dir,
                              f"maintenance{round_no}_time.csv")
        # a bench-level --resume also resumes mid-phase: the commit
        # journal in the warehouse replays the refresh functions whose
        # snapshot commits already landed (never applies one twice)
        _resumable([sys.executable, "-m", "nds_tpu_torch.nds.maintenance",
                    wh_dir, f"{refresh_base}{round_no}", dm_log,
                    "--backend", backend, *engine_args(cfg),
                    "--json_summary_folder",
                    os.path.join(report_dir,
                                 f"maintenance{round_no}_json")],
                   resume, f"maintenance {round_no}")
        return {"tdm": get_maintenance_time(dm_log)}

    ttts, tdms = [], []
    for round_no in (1, 2):
        if not skip.get("throughput_test", False):
            ttts.append(phase(f"throughput_{round_no}",
                              lambda r=round_no: _throughput(r))["ttt"])
        if not skip.get("maintenance_test", False):
            tdms.append(phase(f"maintenance_{round_no}",
                              lambda r=round_no: _maintenance(r))["tdm"])
    metrics["throughput_times_s"] = ttts
    metrics["maintenance_times_s"] = tdms

    def _validate():
        """Run the power stream twice on the maintained warehouse, on the
        bench's engine and on the CPU oracle, and diff the saved outputs
        (``nds/validate.py``), which patches ``queryValidationStatus``
        into the engine round's JSON summaries."""
        vcfg = cfg.get("validate") or {}
        stream0 = os.path.join(stream_dir, "query_0.sql")
        vdir = os.path.join(report_dir, "validate")
        jdir = os.path.join(vdir, "json")
        subset = [str(q) for q in (vcfg.get("query_subset") or [])]
        out_engine = os.path.join(vdir, "output_engine")
        out_oracle = os.path.join(vdir, "output_oracle")
        fresh_outputs(vdir)
        for be, outp, tag in ((backend, out_engine, "engine"),
                              ("cpu", out_oracle, "oracle")):
            cmd = [sys.executable, "-m", "nds_tpu_torch.nds.power",
                   wh_dir, stream0,
                   os.path.join(vdir, f"{tag}_time.csv"),
                   "--backend", be, "--output_prefix", outp]
            if tag == "engine":
                cmd += [*engine_args(cfg), "--json_summary_folder", jdir,
                        "--allow_recovered"]
            if subset:
                cmd += ["--query_subset", *subset]
            _run(cmd)
        vcmd = [sys.executable, "-m", "nds_tpu_torch.nds.validate",
                out_engine, out_oracle, stream0, "--ignore_ordering",
                "--json_summary_folder", jdir]
        if vcfg.get("epsilon") is not None:
            vcmd += ["--epsilon", str(vcfg["epsilon"])]
        rc = _run_rc(vcmd)
        if rc and not vcfg.get("allow_failure"):
            raise SystemExit(
                f"validate: engine outputs diverge from the CPU oracle "
                f"(exit {rc}; mismatches listed above)")
        return {"validation_ok": 0 if rc else 1}

    if cfg.get("validate") and not skip.get("validate", False):
        metrics["validation_ok"] = bool(
            phase("validate", _validate)["validation_ok"])

    # all four terms or no composite (a made-up term would skew the
    # geometric mean)
    if len(ttts) == 2 and len(tdms) == 2:
        metrics["metric"] = get_perf_metric(
            scale, num_streams // 2, tld, tpt, ttts[0], ttts[1],
            tdms[0], tdms[1])
    else:
        metrics["metric"] = None
    out_csv = paths.get("metrics_csv",
                        os.path.join(report_dir, "metrics.csv"))
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["scale", "streams", "load_s", "power_s",
                    "throughput1_s", "throughput2_s", "maintenance1_s",
                    "maintenance2_s", "metric", "timestamp"])
        w.writerow([scale, num_streams, tld, tpt,
                    *(ttts or [None, None]), *(tdms or [None, None]),
                    metrics["metric"], int(time.time())])
    print(f"perf metric: {metrics['metric']} (details in {out_csv})")
    return metrics


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="full NDS benchmark on the "
                                "port's engine")
    p.add_argument("config", help="bench YAML (like "
                   "nds_tpu_torch/configs/bench_nds.yml)")
    p.add_argument("--resume", action="store_true",
                   help="replay completed phases from the report dir's "
                        "bench_state.json journal instead of running "
                        "them again")
    args = p.parse_args(argv)
    with open(args.config) as f:
        cfg = yaml.safe_load(f)
    try:
        run_full_bench(cfg, resume=args.resume)
    except BenchConfigError as e:
        p.error(str(e))


if __name__ == "__main__":
    main()
