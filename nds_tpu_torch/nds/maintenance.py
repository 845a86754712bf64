"""NDS Data Maintenance CLI.

Port of ``nds_tpu/nds/maintenance.py`` over the port's engine. As the
upstream benchmark's ``nds/nds_maintenance.py``: register the refresh
staging tables (`:270-274`), run the 7 LF_* insert functions and 4 DF_*
delete functions (`INSERT_FUNCS/DELETE_FUNCS:45-58`) with DATE1/DATE2
substituted from the generated delete/inventory_delete tables
(`get_delete_date:60-73`, `replace_date:75-96`), record per-function
times in JSON summaries and the CSV time log, and exit non-zero on
failures.

DML mutates the host warehouse through the engine (``engine/dml.py``)
as DELTAS (``columnar/delta.py``): segments and deleted-row bitmasks
over the immutable base, never a rewrite. Every refresh function
commits its deltas as one snapshot version (``io/snapshots.py``), which
``nds_tpu_torch.nds.rollback`` undoes by truncating the manifest.

Crash safety is the power loop's contract applied to writes: a
write-ahead commit journal (``resilience/journal.py``) START-marks each
function before its DML dispatches and records it only after its
snapshot commit lands, so ``--resume`` replays completed functions from
the journal, recognizes the crash-after-commit window by the committed
version's note, and never applies a refresh function twice. A SIGTERM
drains the in-flight function and exits 75, so the orchestrator
(``nds/bench.py``) runs the phase again with ``--resume``. The fault
points ``dml.apply`` (between the START mark and the commit) and
``store.commit`` (the torn-commit window) inject there.

    python -m nds_tpu_torch.nds.maintenance <warehouse> <refresh_dir> \\
        dm.csv [--backend gpu|distributed|cpu] [--device cuda|cpu] \\
        [--placement device|sharded|cpu] [--json_summary_folder DIR] \\
        [--resume]

Every backend runs through the execution pipeline
(``engine/scheduler.py``), as in the power CLIs: ``--backend gpu`` (the
default; the reference's CLI defaults to the CPU) runs each LF_*
function's SELECT and each DF_* function's subqueries on the port's
device engine on ``--device`` (default ``cuda``, the card); without a
card and without ``--device cpu`` the CLI exits 2 before it loads or
writes anything. A statement that fails fails its function
(``Failed``).

Not ported yet: ``--compact``, whose admission the ``MemoryGovernor``
decides (ROADMAP Queue 1 item 6). ``compact_warehouse`` itself runs
without a governor.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
import uuid

from nds_tpu_torch.device import NoCudaDevice
from nds_tpu_torch.engine.session import Session
from nds_tpu_torch.utils import power_core
from nds_tpu_torch.utils.report import BenchReport
from nds_tpu_torch.utils.timelog import TimeLog

DM_DIR = os.path.join(os.path.dirname(__file__), "data_maintenance")

INSERT_FUNCS = ["LF_CR", "LF_CS", "LF_I", "LF_SR", "LF_SS", "LF_WR",
                "LF_WS"]
DELETE_FUNCS = ["DF_CS", "DF_SS", "DF_WS"]
INVENTORY_DELETE_FUNCS = ["DF_I"]

# fact tables a full maintenance run can mutate -> committed as one
# snapshot version (the rollback set, `nds/nds_rollback.py:37-43`)
MUTABLE_TABLES = ["store_sales", "store_returns", "catalog_sales",
                  "catalog_returns", "web_sales", "web_returns",
                  "inventory"]

NOT_PORTED = ("not ported yet: --compact (ROADMAP Queue 1 item 6, the "
              "MemoryGovernor)")


def get_maintenance_queries(funcs: list[str]) -> dict[str, str]:
    """{function: sql text} from the shipped data_maintenance files
    (`nds/nds_maintenance.py:121-147`)."""
    out = {}
    for f in funcs:
        with open(os.path.join(DM_DIR, f + ".sql")) as fh:
            out[f] = fh.read()
    return out


def get_delete_date(session: Session) -> tuple[str, str, str, str]:
    """(date1, date2, inv_date1, inv_date2) ISO strings read from the
    registered delete/inventory_delete tables
    (`nds/nds_maintenance.py:60-73`)."""
    import numpy as np

    def iso(table, col):
        c = session.tables[table].column(col)
        return str((np.datetime64("1970-01-01", "D")
                    + int(c.values[0])))

    return (iso("delete", "date1"), iso("delete", "date2"),
            iso("inventory_delete", "date1"),
            iso("inventory_delete", "date2"))


def replace_date(sql: str, date1: str, date2: str) -> str:
    """DATE1/DATE2 placeholder substitution
    (`nds/nds_maintenance.py:75-96`)."""
    return sql.replace("DATE1", date1).replace("DATE2", date2)


def statements(sql: str) -> list[str]:
    # strip comment lines BEFORE splitting: headers may contain ';'
    body = "\n".join(ln for ln in sql.splitlines()
                     if not ln.lstrip().startswith("--"))
    return [s.strip() for s in body.split(";") if s.strip()]


def run_dm_query(session: Session, sql: str) -> None:
    for stmt in statements(sql):
        session.sql(stmt)


JOURNAL_NAME = "_maintenance_journal.json"


def journal_path(data_dir: str, refresh_dir: str) -> str:
    """Journal keyed by refresh set: a full bench runs maintenance
    twice (refresh1, refresh2) against ONE warehouse, and round 2 must
    not reuse round 1's records."""
    tag = os.path.basename(os.path.normpath(refresh_dir)) or "refresh"
    return os.path.join(data_dir, JOURNAL_NAME.replace(
        ".json", f".{tag}.json"))


def _commit_function_deltas(data_dir: str, log, session: Session,
                            note: str) -> "int | None":
    """Persist every pending delta artifact (segments, deleted-row
    bitmask) the just-finished refresh function produced and append ONE
    snapshot version referencing them (the atomic commit point). A
    crash before the manifest append leaves unreferenced files the
    reader never visits. Returns the committed version, or None when the
    function mutated nothing."""
    from nds_tpu_torch.columnar import delta
    version = (log.entries[-1]["version"] + 1) if log.entries else 1
    new_rel: dict[str, list] = {}
    for t in MUTABLE_TABLES:
        table = session.tables.get(t)
        if table is None or delta.state_of(table) is None:
            continue
        files = delta.persist_pending(table, log.version_dir(t, version),
                                      note=note)
        if files:
            new_rel[t] = [os.path.relpath(p, data_dir) for p in files]
    if not new_rel:
        return None
    prev = (dict(log.entries[-1]["tables"]) if log.entries else {})
    merged = {}
    for t, rel in new_rel.items():
        base = prev.get(t)
        if base is None:
            base = log.baseline([t]).get(t, [])
        merged[t] = list(base) + rel
    return log.commit(merged, note=note)


def run_maintenance(data_dir: str, refresh_dir: str, time_log_path: str,
                    config=None,
                    json_summary_folder: str | None = None,
                    refresh_format: str = "raw",
                    commit: bool = True,
                    resume: bool = False) -> int:
    """Run all 11 maintenance functions under the write-ahead commit
    journal; returns the failure count. ``resume=True`` replays
    journaled-complete functions (and functions whose snapshot commit
    landed but whose journal record did not: the crash-after-commit
    window, recognized by the committed version's note) and runs only
    the unfinished ones, so no DML is applied twice. The session is made
    first, so a run asked of a card that is not there raises
    (``NoCudaDevice``) before it loads or writes anything."""
    from nds_tpu_torch.io.snapshots import SnapshotLog
    from nds_tpu_torch.nds.schema import get_maintenance_schemas
    from nds_tpu_torch.resilience import drain
    from nds_tpu_torch.resilience.journal import QueryJournal, config_digest
    from nds_tpu_torch.utils.config import EngineConfig
    config = config or EngineConfig()
    suite = _maintenance_suite(config)
    session = power_core.make_session(suite, config)
    # nonce keeps run ids (and therefore snapshot commit notes) unique
    # even when two rounds start within the same second
    app_id = (f"nds-tpu-maintenance-{int(time.time())}-"
              f"{uuid.uuid4().hex[:8]}")
    tlog = TimeLog(app_id)
    run_dir = (json_summary_folder
               or os.path.dirname(time_log_path) or ".")

    journal = QueryJournal(
        journal_path(data_dir, refresh_dir), phase=app_id,
        digest=config_digest({"data_dir": data_dir,
                              "refresh_dir": refresh_dir,
                              "commit": commit}))
    if resume and journal.load():
        inc = journal.begin_incarnation()
        # the run id binds this journal's records to their snapshot
        # notes; a resumed incarnation inherits the original's
        run_id = journal.state.get("phase") or app_id
        print(f"== resuming maintenance (incarnation {inc}): "
              f"{len(journal.completed())} function(s) journaled ==")
    else:
        journal.reset()
        run_id = app_id

    # graceful preemption: SIGTERM/SIGINT drains the in-flight refresh
    # function and exits 75 (resumable); installed only where no outer
    # caller already owns the signal chain
    own_drain = drain.manager() is None
    if own_drain:
        drain.install(drain.drain_seconds(config), run_dir)

    # base warehouse (versioned: committed deltas replay through
    # columnar.delta) + refresh staging tables
    setup = power_core.load_warehouse(
        suite, session, data_dir,
        schemas=power_core.suite_schemas(suite, config))
    use_decimal = not config.get_bool("engine.floats")
    maint_schemas = get_maintenance_schemas(use_decimal)
    setup.update(power_core.load_warehouse(
        suite, session, refresh_dir, refresh_format,
        schemas=maint_schemas))
    for tname, secs in setup.items():
        tlog.add(f"CreateTempView {tname}", int(secs * 1000))

    log = SnapshotLog(data_dir) if commit else None
    date1, date2, inv_date1, inv_date2 = get_delete_date(session)
    queries = get_maintenance_queries(
        INSERT_FUNCS + DELETE_FUNCS + INVENTORY_DELETE_FUNCS)
    if json_summary_folder:
        os.makedirs(json_summary_folder, exist_ok=True)
    failures = 0
    dm_ms = 0
    try:
        for fname, sql in queries.items():
            # function-boundary drain point: a requested drain exits 75
            # here, with every finished function journaled and committed
            drain.check_boundary()
            note = f"maint:{run_id}:{fname}"
            if journal.done(fname):
                entry = journal.entry(fname)
                elapsed_ms = int(entry.get("wall_ms", 0))
                tlog.add(fname, elapsed_ms)
                dm_ms += elapsed_ms
                if not str(entry.get("status", "")).startswith(
                        "Completed"):
                    failures += 1
                print(f"====== {fname} replayed from journal ======")
                continue
            if log is not None and log.has_note(note):
                # the crash came between this function's snapshot commit
                # and its journal record: the mutation is durable (and
                # already loaded from the committed version); record it
                # now, never apply it again
                journal.record(fname, 0.0,
                               "Completed(replayed-from-snapshot)")
                print(f"====== {fname} already committed "
                      f"(v-note {note}) ======")
                continue
            if fname in INVENTORY_DELETE_FUNCS:
                fsql = replace_date(sql, inv_date1, inv_date2)
            elif fname in DELETE_FUNCS:
                fsql = replace_date(sql, date1, date2)
            else:
                fsql = sql
            # START-mark before dispatch: a kill one instruction later
            # still leaves the attempt on disk
            journal.start(fname)
            report = BenchReport(fname, config.as_dict())
            summary = report.report_on(run_dm_query, session, fsql)
            elapsed_ms = summary["queryTimes"][-1]
            tlog.add(fname, elapsed_ms)
            dm_ms += elapsed_ms
            print(f"====== Run {fname} ======")
            print(f"Time taken: {elapsed_ms} millis for {fname}")
            ok = report.is_success()
            if not ok:
                failures += 1
            if ok and log is not None:
                v = _commit_function_deltas(data_dir, log, session, note)
                if v is not None:
                    print(f"committed {fname} deltas as snapshot v{v}")
            # journal record after the commit: completion implies the
            # mutation is durable, so resume can safely skip it
            journal.record(fname, elapsed_ms,
                           "Completed" if ok else "Failed")
            if json_summary_folder:
                report.write_summary(prefix=f"maintenance-{app_id}",
                                     out_dir=json_summary_folder)
    finally:
        if own_drain:
            drain.uninstall()
    tlog.add("Data Maintenance Time", dm_ms)
    tlog.write(time_log_path)
    print(f"Data Maintenance Time: {dm_ms} millis")
    return failures


def _maintenance_suite(config) -> power_core.Suite:
    from nds_tpu_torch.nds.schema import get_schemas
    return power_core.Suite(
        name="nds",
        get_schemas=get_schemas,
        parse_query_stream=None,
        session_for=lambda factory, **kw: Session.for_nds(
            factory, include_maintenance=True, **kw),
        raw_ext=".dat",
        floats_toggle=True,
    )


def compact_warehouse(data_dir: str, session: Session,
                      governor=None, note: str = "compact",
                      tables: "list[str] | None" = None) -> "int | None":
    """Fold each mutated table's delta segments and deleted-row bitmask
    back into full base files and commit them as one snapshot version
    (which rollback undoes like any other). ``governor`` must be None:
    the ``MemoryGovernor`` that admits the fold waits for ROADMAP Queue 1
    item 6. Returns the committed version, or None when nothing was
    compacted."""
    from nds_tpu_torch.columnar import delta
    from nds_tpu_torch.io import csv_io
    from nds_tpu_torch.io.snapshots import SnapshotLog

    if governor is not None:
        raise NotImplementedError(
            "compaction under a MemoryGovernor waits for ROADMAP Queue 1 "
            "item 6")
    targets = []
    for t in (tables or MUTABLE_TABLES):
        table = session.tables.get(t)
        if table is not None and delta.state_of(table) is not None:
            targets.append((t, table))
    if not targets:
        return None

    log = SnapshotLog(data_dir)
    version = (log.entries[-1]["version"] + 1) if log.entries else 1
    new_files = {}
    for t, table in targets:
        pt = delta.physical(table)
        vdir = log.version_dir(t, version)
        path = os.path.join(vdir, "part-0.parquet")
        csv_io.write_parquet(pt, path)
        new_files[t] = [os.path.relpath(path, data_dir)]
        # the in-session table becomes the compacted physical form
        session.register_table(pt)
    v = log.commit(new_files, note=note)
    session.invalidate(tables=[t for t, _ in targets])
    return v


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="NDS data maintenance (LF_*/DF_* refresh functions) "
                    "on the port's engine; " + NOT_PORTED)
    p.add_argument("data_dir", help="warehouse directory (versioned)")
    p.add_argument("refresh_dir",
                   help="refresh dataset directory (gen_data --update)")
    p.add_argument("time_log", help="output CSV time log path")
    p.add_argument("--backend", choices=list(power_core.BACKENDS),
                   default=None,
                   help="overrides engine.backend (default gpu: the "
                        "port's device engine; distributed: the sharded "
                        "engine; cpu: the CPU oracle)")
    p.add_argument("--device", default=None,
                   help="the gpu and distributed backends' torch device "
                        "(engine.device; default cuda, the card)")
    p.add_argument("--placement", choices=["device", "sharded", "cpu"],
                   default=None,
                   help="pin the initial placement of every statement "
                        "(engine.placement.force)")
    p.add_argument("--refresh_format", choices=["raw", "parquet"],
                   default="raw")
    p.add_argument("--json_summary_folder")
    p.add_argument("--no_commit", action="store_true",
                   help="leave the on-disk warehouse untouched")
    p.add_argument("--allow_failure", action="store_true",
                   help="exit 0 even when functions failed")
    p.add_argument("--resume", action="store_true",
                   help="replay the commit journal: skip functions "
                        "whose mutations are already durable")
    p.add_argument("--compact", action="store_true",
                   help="not ported yet (ROADMAP Queue 1 item 6)")
    power_core.add_config_args(p)
    args = p.parse_args(argv)
    if args.compact:
        p.error("--compact is not ported yet: the MemoryGovernor that "
                "admits it comes with ROADMAP Queue 1 item 6")
    config = power_core.config_from_args(args)
    try:
        failures = run_maintenance(
            args.data_dir, args.refresh_dir, args.time_log, config=config,
            json_summary_folder=args.json_summary_folder,
            refresh_format=args.refresh_format, commit=not args.no_commit,
            resume=args.resume)
    except NoCudaDevice as e:
        print(f"[maintenance] {e}", file=sys.stderr)
        sys.exit(2)
    sys.exit(0 if (args.allow_failure or not failures) else 1)


if __name__ == "__main__":
    main()
