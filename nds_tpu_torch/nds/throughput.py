"""NDS Throughput Run: N concurrent query streams.

Port of ``nds_tpu/nds/throughput.py``. Two modes:

- **Subprocess streams** (``run_streams``, the default): one plain
  subprocess of the port's power CLI (``python -m
  nds_tpu_torch.nds.power``) per stream, all started together, each with
  its own CUDA context, graph pool and warehouse load (the analog of one
  Spark application a stream). Each writes its time log
  (``<stream>_time.csv``), its per-query summaries (``<stream>_json/``)
  and its output (``<stream>.log``) into the run directory. The
  throughput elapse is max(end) - min(start), rounded up to 0.1 s (the
  reference's Ttt granularity).
- **In-process streams** (``run_streams_inprocess``, ``--in_process``):
  the one-card mode. The warehouse loads once, one Session and one
  execution pipeline serve every stream (one executor, one graph pool),
  and the streams' statements interleave round-robin with
  ``engine.concurrent_tasks`` (default 2) in flight through
  ``Session.sql_async``: a replayed plan's copies to the host overlap the
  next dispatch. Each stream gets its own time log, ``BenchReport``
  summary (``throughput-<stream>-<start>.json``) and query journal
  (``<stream>_queries.json``: status, wall, result digest, placement,
  reschedules and retries of every statement).

On the card each process prints its peak memory and graph pool
(``[memory]``, ``obs/memwatch.process_record``) to stderr.

    python -m nds_tpu_torch.nds.throughput <warehouse> query_1.sql \\
        query_2.sql [--in_process] [--backend gpu|distributed|cpu] \\
        [--device cuda|cpu] [--out_dir DIR] [--output_prefix DIR]

``--output_prefix`` (the port's addition, as the power CLI's) saves each
stream's results under ``<output_prefix>/<stream>``, for the validate
CLI.

Not ported yet: the reference's ``StreamSupervisor`` (heartbeats, a hung
stream killed and restarted from its last completed query,
``throughput_summary.json``), so ``--stall_s`` and ``--max_restarts``,
which the CLI keeps and refuses (ROADMAP Queue 1 item 15), and the
in-process metrics snapshotter (item 7).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import threading
import time

NOT_PORTED = ("not ported yet: supervised streams, --stall_s and "
              "--max_restarts (ROADMAP Queue 1 item 15)")


def _stream_specs(data_dir: str, stream_paths: list[str], out_dir: str,
                  backend: str, input_format: str, allow_failure: bool,
                  module: str, parse_stream, device: "str | None" = None,
                  output_prefix: "str | None" = None) -> list:
    """One spec a stream (shared with NDS-H, which passes its own power
    module and stream parser): its name, the power CLI's command line,
    the stream's statements and its environment. With ``output_prefix``
    each stream saves its results under ``<output_prefix>/<stream>``."""
    from nds_tpu_torch.utils.power_core import subprocess_env
    specs = []
    for sp in stream_paths:
        name = os.path.splitext(os.path.basename(sp))[0]
        cmd = [sys.executable, "-m", module, data_dir, sp,
               os.path.join(out_dir, f"{name}_time.csv"),
               "--backend", backend, "--input_format", input_format,
               "--json_summary_folder",
               os.path.join(out_dir, f"{name}_json")]
        if device is not None:
            cmd += ["--device", device]
        if output_prefix:
            cmd += ["--output_prefix", os.path.join(output_prefix, name)]
        if allow_failure:
            cmd.append("--allow_failure")
        specs.append({"name": name, "cmd": cmd,
                      "queries": list(parse_stream(sp)),
                      "env": subprocess_env()})
    return specs


def launch(specs: list, out_dir: str) -> tuple[float, list[int]]:
    """Start every stream's subprocess at once (output to
    ``<stream>.log``) and wait for all; returns (the elapse, max(end) -
    min(start) in seconds rounded up to 0.1 s, and the exit codes)."""
    os.makedirs(out_dir, exist_ok=True)
    procs, starts, ends, logs = [], [], [None] * len(specs), []
    try:
        for spec in specs:
            log = open(os.path.join(out_dir, f"{spec['name']}.log"), "w")
            logs.append(log)
            starts.append(time.time())
            procs.append(subprocess.Popen(spec["cmd"], env=spec["env"],
                                          stdout=log,
                                          stderr=subprocess.STDOUT))

        def wait(i):
            procs[i].wait()
            ends[i] = time.time()

        waiters = [threading.Thread(target=wait, args=(i,))
                   for i in range(len(procs))]
        for w in waiters:
            w.start()
        for w in waiters:
            w.join()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    codes = [p.returncode for p in procs]
    for spec, rc in zip(specs, codes):
        print(f"stream {spec['name']}: exit {rc}")
    elapse = max(ends) - min(starts)
    # round up to 0.1 s, the reference's Ttt granularity
    return math.ceil(elapse * 10) / 10.0, codes


def run_streams(data_dir: str, stream_paths: list[str], out_dir: str,
                backend: str = "gpu", input_format: str = "parquet",
                allow_failure: bool = False, device: "str | None" = None,
                output_prefix: "str | None" = None
                ) -> tuple[float, list[int]]:
    """One power-run subprocess per stream, started together; returns
    (throughput elapse in seconds, per-stream exit codes)."""
    from nds_tpu_torch.nds.streams import parse_query_stream
    specs = _stream_specs(data_dir, stream_paths, out_dir, backend,
                          input_format, allow_failure,
                          "nds_tpu_torch.nds.power", parse_query_stream,
                          device, output_prefix)
    return launch(specs, out_dir)


def run_streams_inprocess(data_dir: str, stream_paths: list[str],
                          out_dir: str, backend: str = "gpu",
                          input_format: str = "parquet",
                          device: "str | None" = None, suite=None,
                          config=None, output_prefix: "str | None" = None
                          ) -> tuple[float, list[int]]:
    """Multi-stream throughput in one process, the one-card mode: N
    subprocesses each opening the same card would each hold a CUDA
    context and a graph pool of their own. The warehouse loads once, one
    Session serves every stream (shared device buffers; streams differ
    in their parameters, so each still captures its own plans), and the
    statements interleave round-robin so all streams progress together.
    ``suite``: the power CLI's ``Suite`` (NDS by default); with
    ``output_prefix`` each stream saves its results under
    ``<output_prefix>/<stream>``, as the power CLI does. Returns (elapse
    seconds, per-stream failure counts)."""
    from nds_tpu_torch.io.result_io import result_digest, write_result
    from nds_tpu_torch.obs import memwatch
    from nds_tpu_torch.resilience import faults
    from nds_tpu_torch.resilience.journal import QueryJournal, config_digest
    from nds_tpu_torch.resilience.retry import (
        TRANSIENT, RetryPolicy, RetryStats, classify,
    )
    from nds_tpu_torch.utils import power_core
    from nds_tpu_torch.utils.config import EngineConfig
    from nds_tpu_torch.utils.report import BenchReport
    from nds_tpu_torch.utils.timelog import TimeLog
    if suite is None:
        from nds_tpu_torch.nds.power import SUITE as suite

    os.makedirs(out_dir, exist_ok=True)
    # the clock starts before the warehouse load: the subprocess mode's
    # window (max(end) - min(start)) holds each stream's load, and both
    # modes must bill under the same rule
    start = time.time()
    if config is None:
        overrides = {"engine.backend": backend}
        if device is not None:
            overrides["engine.device"] = device
        config = EngineConfig(overrides=overrides)
    policy = RetryPolicy.from_config(config)
    session = power_core.make_session(suite, config)
    pipeline = session._executor_factory(session.tables)
    power_core.load_warehouse(
        suite, session, data_dir, input_format,
        schemas=power_core.suite_schemas(suite, config))
    streams = []
    for sp in stream_paths:
        name = os.path.splitext(os.path.basename(sp))[0]
        # each stream journals every statement as it finishes
        qj = QueryJournal(
            os.path.join(out_dir, f"{name}_queries.json"), phase=name,
            digest=config_digest(config.as_dict()))
        qj.reset()
        streams.append({
            "name": name,
            "queries": list(suite.parse_query_stream(sp).items()),
            "tlog": TimeLog(f"{suite.name}-throughput-{name}"),
            "failures": 0, "statuses": [], "exceptions": [], "qtimes": [],
            "retries": 0, "reschedules": 0, "journal": qj,
        })
    # flatten round-robin, then run with engine.concurrent_tasks queries
    # in flight (the analog of spark.rapids.sql.concurrentGpuTasks)
    interleaved = []
    for k in range(max(len(s["queries"]) for s in streams)):
        for s in streams:
            if k < len(s["queries"]):
                interleaved.append((s, *s["queries"][k]))
    depth = max(config.get_int("engine.concurrent_tasks", 2), 1)
    inflight: list = []

    def _finish_one():
        s, qname, t0, handle, err, extra = inflight.pop(0)
        res = None
        if err is None:
            try:
                # a transient failure surfaces here and runs down the
                # pipeline's ladder on this call
                with faults.context(query=qname, stream=s["name"]):
                    res = handle.result()
                if res is not None and output_prefix:
                    write_result(res, os.path.join(output_prefix,
                                                   s["name"], qname))
            except Exception as exc:  # noqa: BLE001
                err = exc
        # the query's own recovery accounting, which its handle carries
        # (a view's statement or a dispatch failure has none)
        st = getattr(handle, "stats", None)
        sched = getattr(handle, "sched", None) or {}
        retries = extra + (st.retries if st is not None else 0)
        s["retries"] += retries
        s["reschedules"] += int(sched.get("reschedules", 0))
        if err is not None:
            import traceback
            traceback.print_exception(type(err), err, err.__traceback__)
            s["failures"] += 1
            s["exceptions"].append(f"{qname}: {type(err).__name__}: {err}")
            s["statuses"].append("Failed")
        else:
            s["statuses"].append("Completed")
        done = time.time()
        # the dispatch->result bracket: a pipelined query's wait for the
        # card is inherent to a shared card, as a query of a reference
        # throughput stream waits on cluster resources
        wall_ms = int((done - t0) * 1000)
        s["tlog"].add(qname, wall_ms)
        s["qtimes"].append(wall_ms)
        s["first_t0"] = min(s.get("first_t0", t0), t0)
        s["last_done"] = done
        fields = {"retries": retries}
        if sched:
            fields.update(placement=sched.get("placement"),
                          reschedules=int(sched.get("reschedules", 0)))
        s["journal"].record(qname, wall_ms, s["statuses"][-1],
                            result_digest=result_digest(res), **fields)

    for s, qname, sql in interleaved:
        s["journal"].start(qname)
        t0 = time.time()
        handle, err, extra = None, None, 0
        try:
            with faults.context(query=qname, stream=s["name"]):
                handle = session.sql_async(sql)
        except Exception as exc:  # noqa: BLE001
            err = exc
            if classify(exc) == TRANSIENT and policy.max_attempts > 1:
                # a dispatch-time transient never reached the pipeline
                # (the parse and plan window): run it again synchronously
                # under the rest of the budget, the power loop's
                # front-door retry
                st, out = RetryStats(), None
                rerun = policy.with_attempts(policy.max_attempts - 1)
                try:
                    with faults.context(query=qname, stream=s["name"]):
                        out = rerun.call(session.sql, sql, stats=st)
                    err = None
                except Exception as exc2:  # noqa: BLE001
                    err = exc2
                # the rerun went through the pipeline: its retries and
                # reschedules are this query's too
                handle = _Resolved(out, pipeline)
                extra = 1 + st.retries
        inflight.append((s, qname, t0, handle, err, extra))
        while len(inflight) >= depth:
            _finish_one()
    while inflight:
        _finish_one()
    for s in streams:
        # a stream's Power Test Time is its wall window (first dispatch
        # to last result), not the sum of its brackets, which overlap
        ptt = int((s.get("last_done", start) - s.get("first_t0", start))
                  * 1000)
        s["tlog"].add("Power Test Time", ptt)
        s["tlog"].write(os.path.join(out_dir, f"{s['name']}_time.csv"))
        # one BenchReport a stream (the reference's summary, one entry a
        # query): failures carry their exception text
        rep = BenchReport(s["name"], config.as_dict())
        rep.capture_env()
        rep.summary["startTime"] = int(start * 1000)
        rep.summary["queryStatus"] = s["statuses"]
        rep.summary["exceptions"] = s["exceptions"]
        rep.summary["queryTimes"] = s["qtimes"]
        rep.summary["retries"] = s["retries"]
        if s["reschedules"]:
            rep.summary["reschedules"] = s["reschedules"]
        rep.write_summary(prefix="throughput", out_dir=out_dir)
    elapse = math.ceil((time.time() - start) * 10) / 10.0
    mem = memwatch.process_record(pipeline)
    if mem is not None:
        print(f"[memory] {json.dumps(mem)}", file=sys.stderr)
    return elapse, [s["failures"] for s in streams]


class _Resolved:
    """A front-door rerun's result, with the pipeline's stats and
    schedule of that run."""

    def __init__(self, value, pipeline):
        self._value = value
        self.stats = getattr(pipeline, "last_stats", None)
        self.sched = getattr(pipeline, "last_schedule", None)

    def result(self):
        return self._value


def add_throughput_args(p, backend_help: str) -> None:
    """The arguments both throughput CLIs take."""
    from nds_tpu_torch.utils.power_core import BACKENDS
    p.add_argument("data_dir")
    p.add_argument("streams", nargs="+", help="stream files")
    p.add_argument("--out_dir", default="throughput_logs")
    p.add_argument("--backend", choices=list(BACKENDS), default="gpu",
                   help=backend_help)
    p.add_argument("--device", default=None,
                   help="the gpu and distributed backends' torch device "
                        "(default cuda, the card; cpu runs them on the "
                        "CPU)")
    p.add_argument("--input_format",
                   choices=["parquet", "orc", "json", "avro", "raw"],
                   default="parquet")
    p.add_argument("--allow_failure", action="store_true")
    p.add_argument("--output_prefix",
                   help="save each stream's results under "
                        "<output_prefix>/<stream> (one parquet file per "
                        "query, as the power CLI saves them)")
    p.add_argument("--in_process", action="store_true",
                   help="time-share one device inside a single process "
                        "(one CUDA context, one graph pool: the mode for "
                        "several streams on one card)")
    p.add_argument("--stall_s", type=float, default=None,
                   help="refused: " + NOT_PORTED)
    p.add_argument("--max_restarts", type=int, default=None,
                   help="refused: " + NOT_PORTED)


def run_cli(p, args, run_sub, suite) -> None:
    """Run the streams the parsed ``args`` name, print the elapse and
    exit: 1 where a stream failed (unless ``--allow_failure``), 2 for a
    flag that is not ported."""
    if args.stall_s is not None or args.max_restarts is not None:
        p.error(NOT_PORTED)
    if args.in_process:
        elapse, codes = run_streams_inprocess(
            args.data_dir, args.streams, args.out_dir, args.backend,
            args.input_format, device=args.device, suite=suite,
            output_prefix=args.output_prefix)
    else:
        elapse, codes = run_sub(args.data_dir, args.streams, args.out_dir,
                                args.backend, args.input_format,
                                args.allow_failure, device=args.device,
                                output_prefix=args.output_prefix)
    print(f"Throughput Time: {elapse} s over {len(args.streams)} streams")
    sys.exit(1 if any(codes) and not args.allow_failure else 0)


def main(argv=None) -> None:
    from nds_tpu_torch.nds.power import SUITE
    p = argparse.ArgumentParser(description="NDS throughput run on the "
                                "port's engine; " + NOT_PORTED)
    add_throughput_args(p, "engine.backend of every stream (default gpu: "
                        "the port's device engine)")
    args = p.parse_args(argv)
    run_cli(p, args, run_streams, SUITE)


if __name__ == "__main__":
    main()
