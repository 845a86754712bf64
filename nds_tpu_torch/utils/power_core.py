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

Trimmed from the reference, each with the ROADMAP Queue 1 item that
brings it back:

- ``pipeline_io``'s query-boundary overlap (item 6);
- spans, metrics, costs, telemetry, the ``memory`` block, profiles, the
  fleet wiring, the flight recorder and the metrics snapshotter (item 7);
- the query journal of the power loop, ``--resume``, the SIGTERM drain,
  the watchdog and fault injection (item 15, the resilience layer);
- ``SnapshotLog`` and delta warehouses (item 5, maintenance);
- the plan-cache hooks (``--cache_dir``): a CUDA graph does not outlive
  its process, so they have no counterpart.
"""

from __future__ import annotations

import json
import os
import sys
import time
from dataclasses import dataclass

from nds_tpu_torch import obs
from nds_tpu_torch.engine.session import Session
from nds_tpu_torch.obs import memwatch
from nds_tpu_torch.resilience import faults
from nds_tpu_torch.resilience.retry import (
    DETERMINISTIC, TRANSIENT, RetryPolicy, RetryStats, classify,
)
from nds_tpu_torch.utils.config import EngineConfig
from nds_tpu_torch.utils.report import BenchReport
from nds_tpu_torch.utils.timelog import TimeLog

# the engines a config may name: the device engine, the sharded engine
# and the CPU oracle (engine/scheduler.UNIVERSES)
BACKENDS = ("gpu", "cpu", "distributed")


def _front_door_retry(policy, pipeline, body):
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
    transcode's formats (``csv_io.FORMAT_EXT``)."""
    from nds_tpu_torch.io import csv_io
    from nds_tpu_torch.io.integrity import MANIFEST_NAME
    if schemas is None:
        schemas = suite.get_schemas()
    timings = {}
    for name, schema in schemas.items():
        if tables is not None and name not in tables:
            continue
        t0 = time.perf_counter()
        tdir = os.path.join(data_dir, name)
        if fmt in csv_io.FORMAT_EXT:
            ext = csv_io.FORMAT_EXT[fmt]
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
                     extra_time_log: str | None = None) -> int:
    """The power loop: every query runs regardless of earlier failures
    (``--allow_failure`` only changes the CLI's exit code). Returns
    the number of queries that did not complete cleanly. The session is
    made first, so a run asked of a card that is not there raises
    before it loads or writes anything."""
    from nds_tpu_torch.engine.scheduler import load_policy
    from nds_tpu_torch.io.result_io import result_digest
    config = config or EngineConfig()
    if config.get_bool("io.verify_digests"):
        # sticky per process, like the env-var gate it mirrors
        from nds_tpu_torch.io import integrity
        integrity.set_verify(True)
    session = make_session(suite, config)
    backend = config.get("engine.backend", "gpu")
    # on a world of several ranks every rank computes every query and
    # rank 0 writes the reports, the time log and the result files
    primary = True
    if backend == "distributed":
        from nds_tpu_torch.parallel.multihost import is_primary
        primary = is_primary()
    if not primary:
        json_summary_folder = output_prefix = extra_time_log = None
    app_id = (f"{suite.name}-{platform_of(session)}-{backend}-"
              f"{int(time.time())}")
    tlog = TimeLog(app_id)
    total_start = time.perf_counter()

    # the load retries transient failures under the query policy's
    # shape, without its per-query deadline; a corrupt file
    # (io/integrity.CorruptArtifact) is deterministic and fails at once
    front_policy = RetryPolicy.from_config(config)
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
    if json_summary_folder:
        os.makedirs(json_summary_folder, exist_ok=True)
    pipeline = session._executor_factory(session.tables)
    failures = 0
    power_start = time.perf_counter()
    for qname, sql in queries.items():
        if warmup and not qname.startswith(suite.warmup_skip_prefixes):
            for _ in range(warmup):
                try:
                    run_one_query(session, sql)
                except Exception:  # noqa: BLE001 - the timed run reports it
                    break
        report = BenchReport(qname, config.as_dict())
        # a statement that reaches no executor (a view's CREATE/DROP, a
        # parse error) must not inherit the previous query's timings,
        # stats or schedule
        pipeline.reset_query()
        hold: dict = {}

        def _query(_sql=sql, _qname=qname):
            with faults.context(query=_qname):
                hold["result"] = _front_door_retry(
                    front_policy, pipeline,
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
        report.attach_result_digest(result_digest(hold.pop("result", None)))
        elapsed_ms = summary["queryTimes"][-1]
        if not report.is_success():
            failures += 1
        tlog.add(qname, elapsed_ms)
        print(f"====== Run {qname} ======")
        print(f"Time taken: {elapsed_ms} millis for {qname}")
        if json_summary_folder:
            report.write_summary(prefix=f"power-{app_id}",
                                 out_dir=json_summary_folder)
    power_ms = int((time.perf_counter() - power_start) * 1000)
    tlog.add("Power Test Time", power_ms)
    total_ms = int((time.perf_counter() - total_start) * 1000)
    tlog.add("Total Time", total_ms)
    if primary:
        tlog.write(time_log_path)
    if extra_time_log:
        # a second copy of the time log, e.g. on shared storage
        tlog.write(extra_time_log)
    print(f"Power Test Time: {power_ms} millis")
    mem = memwatch.process_record(pipeline)
    if mem is not None:
        # on the card: what the run held, for the throughput streams
        print(f"[memory] {json.dumps(mem)}", file=sys.stderr)
    return failures


def subprocess_env() -> dict:
    """Environment for phase subprocesses (the throughput streams): this
    checkout importable whatever the caller's working directory, ahead
    of the ambient ``PYTHONPATH``. The reference's platform pin has no
    counterpart: a port CLI runs where its ``--device`` says."""
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
