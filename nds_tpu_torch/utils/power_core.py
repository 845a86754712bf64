"""Suite-independent power-run core.

Port of ``nds_tpu/utils/power_core.py``, the one copy of the power loop
both suites' power CLIs share: each supplies a ``Suite`` descriptor
(schema getter, stream parser, raw extension) and gets the warehouse
registration with its CreateTempView rows, the timed query loop with
per-query JSON summaries (``BenchReport``) and the CSV time log
(``TimeLog``), the ``--allow_failure`` contract (a failed query never
stops the stream; the CLI's exit code says it), the warmup, and the
session built from an ``EngineConfig`` (template < property file < CLI).

The loop is synchronous: one ``BenchReport.report_on`` bracket a query,
which ends when ``Session.sql`` has returned the result on the host (the
executor's device->host copies are blocking) and, with
``output_prefix``, the result file is written, as in the reference.
``engine.backend`` picks the executor: ``gpu`` (the default) is
``make_device_factory(engine.precision, device=engine.device)``, the
card unless ``engine.device`` is ``cpu``; ``cpu`` is the CPU oracle. Any
other backend raises, the reference's ``tpu`` and ``distributed`` among
them: a config never runs on an engine it did not name.

Trimmed from the reference, each with the ROADMAP Queue 1 item that
brings it back:

- the scheduler's placement and degradation ladder, ``_front_door_retry``
  and ``RetryPolicy``/``RetryStats`` (item 4);
- ``pipeline_io``'s query-boundary overlap (item 6);
- spans, metrics, costs, telemetry, memwatch, profiles, the fleet
  wiring, the flight recorder and the metrics snapshotter (item 7);
- the query journal, ``--resume``, the SIGTERM drain, the watchdog,
  fault injection and digest verification (the resilience layer);
- ``SnapshotLog`` and delta warehouses (item 5, maintenance);
- the plan-cache hooks (``--cache_dir``): a CUDA graph does not outlive
  its process, so they have no counterpart;
- ``subprocess_env``, which the orchestrator uses (item 4's throughput
  phase brings the orchestrator).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

from nds_tpu_torch import obs
from nds_tpu_torch.engine.session import Session
from nds_tpu_torch.utils.config import EngineConfig
from nds_tpu_torch.utils.report import BenchReport
from nds_tpu_torch.utils.timelog import TimeLog

# the engines a config may name: the port's device engine and the oracle
BACKENDS = ("gpu", "cpu")


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
    """Session from an EngineConfig: ``engine.backend`` picks the
    executor factory (see the module's docstring). Raises ``ValueError``
    for a backend the port has not, and ``NoCudaDevice`` where the card
    is asked for and there is none."""
    backend = config.get("engine.backend", "gpu")
    if backend not in BACKENDS:
        raise ValueError(
            f"engine.backend {backend!r} is not one of the port's: 'gpu' "
            f"(the device engine) or 'cpu' (the CPU oracle)")
    kwargs = schema_kwargs_for(suite, config)
    factory = None
    if backend == "gpu":
        from nds_tpu_torch.engine.device_exec import make_device_factory
        factory = make_device_factory(config.get("engine.precision", "f64"),
                                      device=config.get("engine.device",
                                                        "cuda"))
    prepare_engine(config)
    return suite.session_for(factory, **kwargs)


def platform_of(session: Session) -> str:
    """Where the session's queries run: the device factory's device type
    (``cuda``, or ``cpu`` where asked), ``cpu`` for the oracle."""
    dev = getattr(session._executor_factory, "device", None)
    return "cpu" if dev is None else dev.type


def load_warehouse(suite: Suite, session: Session, data_dir: str,
                   fmt: str = "parquet",
                   tables: list[str] | None = None,
                   schemas: dict | None = None) -> dict:
    """Register every table from a warehouse directory; returns
    {table: seconds} setup timings (the CreateTempView analog). ``raw``
    reads '|'-delimited text with numpy; ``parquet`` needs pyarrow."""
    from nds_tpu_torch.io import csv_io
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
                # a table manifest of the reference's transcode is no data
                paths = sorted(
                    os.path.join(tdir, f) for f in os.listdir(tdir)
                    if not f.startswith(".") and f != "_manifest.json")
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
    from nds_tpu_torch.io.result_io import result_digest
    config = config or EngineConfig()
    session = make_session(suite, config)
    backend = config.get("engine.backend", "gpu")
    app_id = (f"{suite.name}-{platform_of(session)}-{backend}-"
              f"{int(time.time())}")
    tlog = TimeLog(app_id)
    total_start = time.perf_counter()

    load_hold: dict = {}

    def _load_bracket():
        try:
            load_hold["setup"] = load_warehouse(
                suite, session, data_dir, input_format,
                schemas=suite_schemas(suite, config))
        except Exception as exc:  # noqa: BLE001 - re-raised below
            load_hold["error"] = exc
            raise

    load_report = BenchReport("load_warehouse", config.as_dict())
    load_report.report_on(_load_bracket)
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
        # parse error) must not inherit the previous query's timings
        executor = session._executor_factory(session.tables)
        if hasattr(executor, "last_timings"):
            executor.last_timings = {}
        hold: dict = {}

        def _query(_sql=sql, _qname=qname):
            hold["result"] = run_one_query(session, _sql, _qname,
                                           output_prefix)

        summary = report.report_on(_query)
        timings = obs.query_timings(executor)
        if timings:
            # dunder keys are the executor's side channels (the kernels
            # block below), never part of the timings vocabulary
            summary["engineTimings"] = {
                k: round(v, 3) for k, v in timings.items()
                if not k.startswith("__")}
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
    tlog.write(time_log_path)
    if extra_time_log:
        # a second copy of the time log, e.g. on shared storage
        tlog.write(extra_time_log)
    print(f"Power Test Time: {power_ms} millis")
    return failures


def add_config_args(parser) -> None:
    """The --template/--property_file arguments both power CLIs take."""
    parser.add_argument("--template",
                        help="engine template file (k=v with ${ENV:-default})")
    parser.add_argument("--property_file",
                        help="k=v property file overriding the template")


def config_from_args(args) -> EngineConfig:
    """CLI --backend and --device > property file > template > the
    defaults (``gpu`` on ``cuda``)."""
    overrides = {}
    if getattr(args, "backend", None) is not None:
        overrides["engine.backend"] = args.backend
    if getattr(args, "device", None) is not None:
        overrides["engine.device"] = args.device
    return EngineConfig(getattr(args, "template", None),
                        getattr(args, "property_file", None), overrides)
