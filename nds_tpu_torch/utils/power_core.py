"""Suite-independent power-run core.

Port of ``nds_tpu/utils/power_core.py``, the one copy of the power loop
both suites' power CLIs share: each supplies a ``Suite`` descriptor
(schema getter, stream parser, raw extension) and gets the warehouse
registration with its CreateTempView rows, the timed query loop with
per-query JSON summaries (``BenchReport``) and the CSV time log
(``TimeLog``), the ``--allow_failure`` contract (a failed query never
stops the stream; the CLI's exit code says it), the warmup, and the
session built from an ``EngineConfig`` (template < property file < CLI).

Every backend runs through the execution pipeline
(``engine/scheduler.py``, ``make_pipeline``): ``engine.backend`` picks
the placement universe, ``gpu`` (the default: the device engine, then
the CPU oracle), ``distributed`` (the sharded engine over the
``torch.distributed`` world, then the CPU oracle) or ``cpu`` (the CPU
oracle alone); ``gpu`` and ``distributed`` run on ``engine.device``, the
card unless it is ``cpu``. Per query the pipeline's cost model picks the
placement, a transient failure (out of memory) walks that one query down
the ladder, and the pipeline owns the retry policy (``engine.retry.*``,
``engine.query_deadline_s``); ``engine.placement.force`` (the CLIs'
``--placement``) pins the placement. Parse and plan failures retry
before dispatch under the same policy (``_front_door_retry``). Each
summary records ``retries`` (and ``retry_backoff_s``,
``gave_up_reason``, ``deadline_exceeded`` when set), ``placement`` and
``reschedules`` (and ``ladder`` when it walked). Any other backend
raises: a config never runs on an engine it did not name. On a world of
several ranks every rank runs every query and rank 0 writes.

The loop is synchronous: one ``BenchReport.report_on`` bracket a query,
which ends when the result is on the host and, with ``output_prefix``,
its file is written, as in the reference.

Preemption safety (ROADMAP Queue 1 item 15, the resilience layer): every
statement is start-marked in a per-unit query journal
(``<unit>_queries.json`` in the run dir, ``resilience/journal.py``)
before its dispatch and recorded after its summary lands; a
SIGTERM/SIGINT drains (``resilience/drain.py``: the in-flight query
finishes under ``engine.drain_s``, then the process exits 75); and
``resume=True`` replays journaled statements and restarts at the next
unfinished one, then writes ``merged-<unit>.json``, which bills each
statement once. A supervised stream's later incarnation (unit
``<name>#rN``) resumes implicitly. The loop beats the watchdog
(``resilience/watchdog.py``) at the load, at each dispatch, on each
retry and when each query is done; ``engine.watchdog.stall_s`` or
``NDS_TPU_WATCHDOG`` arm it, and ``NDS_TPU_HEARTBEAT_FILE`` publishes
the beats for a supervisor. Fault points fire in the context
``stream=<NDS_TPU_STREAM>`` where a supervisor named the stream, and
warmups suppress them.

Trimmed from the reference, each with the ROADMAP Queue 1 item that
brings it back:

- ``pipeline_io``'s query-boundary overlap (item 6);
- spans, metrics, costs, telemetry, the ``memory`` block, profiles, the
  fleet wiring, the flight recorder and the metrics snapshotter (item 7);
- the plan-cache hooks (``--cache_dir``): a CUDA graph does not outlive
  its process, so they have no counterpart.
"""

from __future__ import annotations

import json
import os
import sys
import time
from contextlib import nullcontext
from dataclasses import dataclass

from nds_tpu_torch import obs
from nds_tpu_torch.engine.session import Session
from nds_tpu_torch.obs import memwatch
from nds_tpu_torch.resilience import drain, faults, watchdog
from nds_tpu_torch.resilience.journal import QueryJournal, config_digest
from nds_tpu_torch.resilience.retry import (
    DETERMINISTIC, TRANSIENT, RetryPolicy, RetryStats, classify,
)
from nds_tpu_torch.utils.config import EngineConfig
from nds_tpu_torch.utils.report import BenchReport
from nds_tpu_torch.utils.timelog import TimeLog

# the engines a config may name: the device engine, the sharded engine
# and the CPU oracle (engine/scheduler.UNIVERSES)
BACKENDS = ("gpu", "cpu", "distributed")


def _front_door_retry(policy, pipeline, unit, qname, body):
    """Retry the TRANSIENT failures that never reached the pipeline (the
    parse and plan window; the executors' retries and the ladder live in
    ``engine/scheduler.py``) under the same backoff policy; a
    deterministic failure (a planner bug) fails at once. The accounting
    merges into the pipeline's per-query stats, so the summary reports
    one recovery budget."""
    attempts = 0
    front_retries = 0
    front_backoff = 0.0
    start = time.monotonic()

    def _merge(st):
        if st is not None:
            st.retries += front_retries
            st.backoff_s += front_backoff

    while True:
        try:
            out = body()
        except Exception as exc:  # noqa: BLE001 - classified below
            st = getattr(pipeline, "last_stats", None)
            pre_dispatch = (st is not None and st.attempts == 0
                            and not st.gave_up_reason)
            if not pre_dispatch:
                # the pipeline saw this query: its classification and
                # ladder already ran
                _merge(st)
                raise
            attempts += 1
            st.errors.append(f"{type(exc).__name__}: {exc}")
            if classify(exc) != TRANSIENT:
                st.gave_up_reason = DETERMINISTIC
                _merge(st)
                raise
            if attempts >= policy.max_attempts:
                st.gave_up_reason = f"attempts_exhausted({attempts})"
                _merge(st)
                raise
            d = policy.delay_for(front_retries)
            if (policy.deadline_s is not None
                    and time.monotonic() - start + d > policy.deadline_s):
                # the plan window must not back off past the query's
                # wall-clock budget
                st.gave_up_reason = "deadline"
                st.deadline_exceeded = True
                _merge(st)
                raise
            front_retries += 1
            front_backoff += d
            watchdog.beat(unit, query=qname, phase="retry",
                          attempt=attempts)
            if d > 0:
                time.sleep(d)
            continue
        _merge(getattr(pipeline, "last_stats", None))
        return out


@dataclass
class Suite:
    """What a benchmark suite must provide to the shared power loop."""
    name: str                      # "nds" | "nds_h"
    get_schemas: object            # callable(**kw) -> {table: Schema}
    parse_query_stream: object     # callable(path) -> OrderedDict
    session_for: object            # callable(factory, **kw) -> Session
    raw_ext: str = ".tbl"          # dbgen .tbl / dsdgen .dat
    # query names whose warmup is skipped (stateful parts, e.g. q15 view
    # lifecycle in NDS-H)
    warmup_skip_prefixes: tuple = ()
    # suite honors the --floats/engine.floats toggle (NDS decimal vs
    # double schemas)
    floats_toggle: bool = False


def schema_kwargs_for(suite: Suite, config: EngineConfig) -> dict:
    if suite.floats_toggle:
        return {"use_decimal": not config.get_bool("engine.floats")}
    return {}


def suite_schemas(suite: Suite, config: EngineConfig) -> dict:
    """Config-aware schemas: table LOADING must agree with the session
    catalog on decimal-vs-float, or money columns load as scaled ints
    under a float catalog."""
    return suite.get_schemas(**schema_kwargs_for(suite, config))


def prepare_engine(config: EngineConfig) -> None:
    """Engine-wide activation: ``columnar.encode`` and
    ``columnar.dict_union_cap`` (the compressed columnar store; configs
    without the keys defer to ``NDS_TPU_COLUMNAR``)."""
    from nds_tpu_torch import columnar
    columnar.configure_from(config)


def make_session(suite: Suite, config: EngineConfig) -> Session:
    """Session from an EngineConfig: every backend's executor factory is
    the execution pipeline (``engine/scheduler.make_pipeline``; see the
    module's docstring). Raises ``ValueError`` for a backend the port has
    not, and ``NoCudaDevice`` where the card is asked for and there is
    none, before anything is loaded."""
    from nds_tpu_torch.engine.scheduler import make_pipeline
    kwargs = schema_kwargs_for(suite, config)
    pipeline = make_pipeline(config)
    prepare_engine(config)
    return suite.session_for(pipeline, **kwargs)


def platform_of(session: Session) -> str:
    """Where the session's device placements run: the pipeline's device
    type (``cuda``, or ``cpu`` where asked, and for the CPU oracle)."""
    dev = getattr(session._executor_factory, "device", None)
    return "cpu" if dev is None else dev.type


def load_warehouse(suite: Suite, session: Session, data_dir: str,
                   fmt: str = "parquet",
                   tables: list[str] | None = None,
                   schemas: dict | None = None) -> dict:
    """Register every table from a warehouse directory; returns
    {table: seconds} setup timings (the CreateTempView analog). ``fmt``
    is ``raw`` ('|'-delimited text, gen_data's output) or one of
    transcode's formats (``csv_io.FORMAT_EXT``). A versioned warehouse
    (one with a snapshot manifest, ``io/snapshots.py``) reads each
    table's live file map, and a delta lineage replays through
    ``columnar/delta.load_versioned``."""
    from nds_tpu_torch.io import csv_io
    from nds_tpu_torch.io.integrity import MANIFEST_NAME
    from nds_tpu_torch.io.snapshots import MANIFEST, SnapshotLog
    if schemas is None:
        schemas = suite.get_schemas()
    log = (SnapshotLog(data_dir)
           if os.path.exists(os.path.join(data_dir, MANIFEST)) else None)
    timings = {}
    for name, schema in schemas.items():
        if tables is not None and name not in tables:
            continue
        t0 = time.perf_counter()
        tdir = os.path.join(data_dir, name)
        if fmt in csv_io.FORMAT_EXT:
            ext = csv_io.FORMAT_EXT[fmt]
            if log is not None and os.path.isdir(tdir):
                # versioned warehouse: the snapshot manifest names the
                # live files (maintenance commits new versions, always
                # as parquet: formats may mix, so read per extension).
                # Delta lineages (files under <table>/_v<N>/) replay
                # through columnar.delta: base files load normally, then
                # each committed version's segments and bitmask apply in
                # order, rebuilding the writer's content digests and
                # merged-stats encoding specs
                paths = log.current([name]).get(name, [])
                from nds_tpu_torch.columnar import delta
                if delta.has_delta_paths(paths):
                    table = delta.load_versioned(name, schema, paths, fmt)
                else:
                    table = csv_io.read_paths_auto(paths, name, schema,
                                                   fmt)
                session.register_table(table)
                timings[name] = time.perf_counter() - t0
                continue
            if os.path.isdir(tdir):
                # recursive: partitioned tables nest hive-style dirs
                paths = sorted(
                    os.path.join(root, f)
                    for root, _dirs, files in os.walk(tdir)
                    for f in files if f.endswith(ext))
            else:
                paths = [os.path.join(data_dir, f"{name}{ext}")]
            table = csv_io.read_table_fmt(paths, name, schema, fmt)
        elif fmt == "raw":
            if os.path.isdir(tdir):
                # a table's digest manifest is no data
                paths = sorted(
                    os.path.join(tdir, f) for f in os.listdir(tdir)
                    if not f.startswith(".") and f != MANIFEST_NAME)
            else:
                paths = [os.path.join(data_dir, f"{name}{suite.raw_ext}")]
            table = csv_io.read_tbl(paths, name, schema)
        else:
            raise ValueError(f"unknown input format {fmt!r}")
        session.register_table(table)
        timings[name] = time.perf_counter() - t0
    return timings


def run_one_query(session: Session, sql: str, qname: str = "",
                  output_prefix: str | None = None):
    result = session.sql(sql)
    if result is not None and output_prefix:
        from nds_tpu_torch.io.result_io import write_result
        write_result(result, os.path.join(output_prefix, qname))
    return result


def run_query_stream(suite: Suite, data_dir: str, stream_path: str,
                     time_log_path: str,
                     config: EngineConfig | None = None,
                     input_format: str = "parquet",
                     json_summary_folder: str | None = None,
                     output_prefix: str | None = None,
                     warmup: int = 0,
                     query_subset: list[str] | None = None,
                     extra_time_log: str | None = None,
                     resume: bool = False,
                     recovered_ok: bool = False) -> int:
    """The power loop: every query runs regardless of earlier failures
    (``--allow_failure`` only changes the CLI's exit code). Returns the
    number of queries that did not complete cleanly; with
    ``recovered_ok``, only of those that failed (a statement that
    completed after a recovered task failure, ``CompletedWithTaskFailures``,
    then counts as none). The session is made first, so a run asked of a
    card that is not there raises before it loads or writes anything.
    ``resume=True`` replays the unit's query journal and runs only the
    statements it does not hold as done."""
    config = config or EngineConfig()
    progress = {"suite": suite.name, "stream": stream_path,
                "queries_completed": 0, "current_query": None}
    hb = watchdog.HeartbeatFile.from_env(progress)
    if hb:
        hb.start()
    run_dir = json_summary_folder or os.path.dirname(time_log_path) or "."
    wd = (watchdog.Watchdog.from_config(config, run_dir)
          or watchdog.Watchdog.from_env(run_dir))
    if wd:
        wd.start()
    dm = drain.install(drain.drain_seconds(config), run_dir)
    if hb:
        # the force exit skips every finally: flush the beats explicitly
        dm.add_flush_hook(hb.write_once)
    stream_name = os.environ.get(watchdog.STREAM_ENV)
    ctx = (faults.context(stream=stream_name) if stream_name
           else nullcontext())
    try:
        with ctx:
            return _run_query_stream(
                suite, data_dir, stream_path, time_log_path, config,
                input_format, json_summary_folder, output_prefix, warmup,
                query_subset, extra_time_log, progress, resume,
                recovered_ok)
    finally:
        drain.uninstall()
        if wd:
            wd.stop()
        watchdog.clear_unit(stream_name or f"power-{suite.name}")
        if hb:
            progress["current_query"] = None
            hb.stop()


def _run_query_stream(suite, data_dir, stream_path, time_log_path, config,
                      input_format, json_summary_folder, output_prefix,
                      warmup, query_subset, extra_time_log, progress,
                      resume, recovered_ok) -> int:
    from nds_tpu_torch.engine.scheduler import load_policy
    from nds_tpu_torch.io.result_io import result_digest
    if config.get_bool("io.verify_digests"):
        # sticky per process, like the env-var gate it mirrors
        from nds_tpu_torch.io import integrity
        integrity.set_verify(True)
    unit = os.environ.get(watchdog.STREAM_ENV) or f"power-{suite.name}"
    session = make_session(suite, config)
    backend = config.get("engine.backend", "gpu")
    # on a world of several ranks every rank computes every query and
    # rank 0 writes the reports, the time log and the result files
    primary = True
    if backend == "distributed":
        from nds_tpu_torch.parallel.multihost import is_primary
        primary = is_primary()
    run_dir = json_summary_folder or os.path.dirname(time_log_path) or "."
    if not primary:
        json_summary_folder = output_prefix = extra_time_log = None
    # one query journal a unit, named without the restart suffix (every
    # incarnation of one stream shares it). Other ranks load it (their
    # replay decisions must match the primary's) and never write it. A
    # supervisor's later incarnation ('<name>#rN') resumes implicitly:
    # its --query_subset scopes what runs again, and a reset would wipe
    # the first incarnation's records
    jname = unit.split("#")[0]
    if primary:
        os.makedirs(run_dir, exist_ok=True)
    journal = QueryJournal(os.path.join(run_dir, f"{jname}_queries.json"),
                           phase=jname,
                           digest=config_digest(config.as_dict()))
    journal.readonly = not primary
    if resume or "#r" in unit:
        if journal.load():
            inc = journal.begin_incarnation()
            done = sorted(journal.completed())
            print(f"== resuming {jname} (incarnation {inc}): "
                  f"{len(done)} journaled quer"
                  f"{'y' if len(done) == 1 else 'ies'} replayed ==")
    else:
        journal.reset()
    dm = drain.manager()
    if dm is not None:
        # the drain deadline's force exit journals the abandoned
        # in-flight query as not done before the process dies
        dm.add_flush_hook(
            lambda: journal.mark_aborted(progress.get("current_query")))
    app_id = (f"{suite.name}-{platform_of(session)}-{backend}-"
              f"{int(time.time())}")
    tlog = TimeLog(app_id)
    total_start = time.perf_counter()

    # the load retries transient failures under the query policy's
    # shape, without its per-query deadline; a corrupt file
    # (io/integrity.CorruptArtifact) is deterministic and fails at once
    front_policy = RetryPolicy.from_config(config)
    watchdog.beat(unit, phase="load_warehouse")
    lstats = RetryStats()
    load_hold: dict = {}

    def _load_bracket():
        def _load():
            return load_warehouse(suite, session, data_dir, input_format,
                                  schemas=suite_schemas(suite, config))
        try:
            load_hold["setup"] = load_policy(front_policy).call(
                _load, stats=lstats)
        except Exception as exc:  # noqa: BLE001 - re-raised below
            load_hold["error"] = exc
            raise

    load_report = BenchReport("load_warehouse", config.as_dict())
    load_report.report_on(_load_bracket)
    load_report.attach_retry(lstats)
    load_report.attach_degradations()
    if "error" in load_hold:
        if json_summary_folder:
            os.makedirs(json_summary_folder, exist_ok=True)
            load_report.write_summary(prefix=f"power-{app_id}",
                                      out_dir=json_summary_folder)
        raise load_hold["error"]
    for tname, secs in load_hold["setup"].items():
        tlog.add(f"CreateTempView {tname}", int(secs * 1000))

    queries = suite.parse_query_stream(stream_path)
    if query_subset:
        queries = type(queries)(
            (q, s) for q, s in queries.items() if q in query_subset)
    progress["app_id"] = app_id
    progress["queries_total"] = len(queries)
    if json_summary_folder:
        os.makedirs(json_summary_folder, exist_ok=True)
    pipeline = session._executor_factory(session.tables)
    failures = 0
    recovered = []
    replayed_ms = 0.0
    power_start = time.perf_counter()
    for qname, sql in queries.items():
        watchdog.beat(unit, query=qname, phase="dispatch")
        # the drain's checkpoint: once a SIGTERM/SIGINT was seen, stop
        # here with every finished query journaled; --resume starts at
        # this statement
        drain.check_boundary()
        if journal.done(qname):
            # a resumed incarnation replays the journaled outcome (its
            # time log row and failure count) and never runs it again
            e = journal.entry(qname)
            wall = float(e.get("wall_ms") or 0)
            replayed_ms += wall
            tlog.add(qname, int(wall))
            if e.get("status") == "Failed":
                failures += 1
            progress["queries_completed"] += 1
            print(f"====== Replay {qname} (journaled "
                  f"{e.get('status')}, incarnation "
                  f"{e.get('incarnation', 0)}) ======")
            continue
        if warmup and not qname.startswith(suite.warmup_skip_prefixes):
            # warmups must not consume the timed query's fault budget
            with faults.suppress():
                for _ in range(warmup):
                    try:
                        run_one_query(session, sql)
                    except Exception:  # noqa: BLE001 - the timed run reports it
                        break
        progress["current_query"] = qname
        # the start mark before dispatch: a kill -9 mid-query leaves a
        # start with no completion, the evidence that exactly this query
        # was lost
        journal.start(qname)
        report = BenchReport(qname, config.as_dict())
        # a statement that reaches no executor (a view's CREATE/DROP, a
        # parse error) must not inherit the previous query's timings,
        # stats or schedule
        pipeline.reset_query()
        hold: dict = {}

        def _query(_sql=sql, _qname=qname):
            with faults.context(query=_qname):
                hold["result"] = _front_door_retry(
                    front_policy, pipeline, unit, _qname,
                    lambda: run_one_query(session, _sql, _qname,
                                          output_prefix))

        summary = report.report_on(_query)
        timings = obs.query_timings(pipeline)
        if timings:
            # dunder keys are the executor's side channels (the kernels
            # block below), never part of the timings vocabulary
            summary["engineTimings"] = {
                k: round(v, 3) for k, v in timings.items()
                if not k.startswith("__")}
        report.attach_retry(getattr(pipeline, "last_stats", None)
                            or RetryStats())
        report.attach_schedule(getattr(pipeline, "last_schedule", None))
        report.attach_kernels(timings)
        report.attach_incarnation(journal.incarnation)
        rdigest = result_digest(hold.pop("result", None))
        report.attach_result_digest(rdigest)
        report.attach_degradations()
        elapsed_ms = summary["queryTimes"][-1]
        status = summary["queryStatus"][-1]
        if status == "CompletedWithTaskFailures":
            recovered.append(qname)
        if not (report.is_success() or (recovered_ok and status != "Failed")):
            failures += 1
        tlog.add(qname, elapsed_ms)
        progress["queries_completed"] += 1
        watchdog.beat(unit, query=qname, phase="done")
        print(f"====== Run {qname} ======")
        print(f"Time taken: {elapsed_ms} millis for {qname}")
        if json_summary_folder:
            report.write_summary(prefix=f"power-{app_id}",
                                 out_dir=json_summary_folder)
        # journal after the summary landed: resume must never skip a
        # statement whose summary is missing
        journal.record(qname, elapsed_ms, status, result_digest=rdigest)
    progress["current_query"] = None
    # a resumed incarnation bills the replayed queries' journaled walls
    # into the phase total, which then approximates the uninterrupted
    # loop (per-query walls, less the overhead between queries)
    power_ms = int((time.perf_counter() - power_start) * 1000
                   + replayed_ms)
    tlog.add("Power Test Time", power_ms)
    total_ms = int((time.perf_counter() - total_start) * 1000)
    tlog.add("Total Time", total_ms)
    if primary:
        tlog.write(time_log_path)
    if extra_time_log:
        # a second copy of the time log, e.g. on shared storage
        tlog.write(extra_time_log)
    if journal.incarnation > 0 and primary and json_summary_folder:
        # one merged phase report over every incarnation's summaries:
        # each statement billed once, the latest incarnation winning
        from nds_tpu_torch.io.integrity import write_json_atomic
        from nds_tpu_torch.utils.report import (
            load_summaries, merge_incarnations,
        )
        known = set(queries)
        merged = merge_incarnations(
            [s for s in load_summaries(json_summary_folder)
             if s.get("query") in known], phase=jname)
        write_json_atomic(
            os.path.join(json_summary_folder, f"merged-{jname}.json"),
            merged)
    if recovered:
        print(f"{len(recovered)} statement(s) completed after a recovered "
              f"task failure: {', '.join(recovered)}")
    print(f"Power Test Time: {power_ms} millis")
    mem = memwatch.process_record(pipeline)
    if mem is not None:
        # on the card: what the run held, for the throughput streams
        print(f"[memory] {json.dumps(mem)}", file=sys.stderr)
    return failures


def subprocess_env() -> dict:
    """Environment for phase subprocesses (the orchestrators' phases, the
    throughput streams): this checkout importable whatever the caller's
    working directory, ahead of the ambient ``PYTHONPATH``. The
    reference's platform pin has no counterpart: a port CLI runs where
    its ``--device`` says."""
    root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def add_config_args(parser) -> None:
    """The --template/--property_file arguments both power CLIs take."""
    parser.add_argument("--template",
                        help="engine template file (k=v with ${ENV:-default})")
    parser.add_argument("--property_file",
                        help="k=v property file overriding the template")


def config_from_args(args) -> EngineConfig:
    """CLI --backend, --device and --placement > property file >
    template > the defaults (``gpu`` on ``cuda``, the cost model's
    placement)."""
    overrides = {}
    if getattr(args, "backend", None) is not None:
        overrides["engine.backend"] = args.backend
    if getattr(args, "device", None) is not None:
        overrides["engine.device"] = args.device
    if getattr(args, "placement", None) is not None:
        overrides["engine.placement.force"] = args.placement
    return EngineConfig(getattr(args, "template", None),
                        getattr(args, "property_file", None), overrides)
