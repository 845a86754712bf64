"""The port's resilience layer against the reference's, on the CPU.

- ``resilience/faults.py``: the same schedules parse to equal
  ``FaultSpec`` lists in both packages (bad ones raise in both), and the
  same seeded probability draws fire on the same calls; the fault points
  fire at their sites (``io.read``, ``plan``, ``device.execute``,
  ``stream.query``, ``dml.apply``), a ``hang`` stops until
  ``interrupt_hangs``, ``corrupt`` flips a byte, ``suppress`` and a CUDA
  capture keep a site quiet.
- ``resilience/journal.py``: phase and query journals written by either
  package load in the other; a torn or CRC-tampered journal degrades to
  a warned fresh start in both (and the port's summaries say so in
  ``degradations``); a journal of another config raises
  ``JournalMismatch`` in both.
- ``resilience/watchdog.py``: ``check_once`` reports a stall once, its
  stall report has the reference's keys less the live metrics snapshot,
  which ``omitted`` names; the heartbeat file carries the progress and
  the heartbeats the supervisor folds.
- ``resilience/drain.py``: a drain requested by a signal raises
  ``DrainRequested`` (code 75) at the next boundary; past its deadline
  the flush hooks run (the journal's abort stamp) before the exit 75.
- ``utils/report.merge_incarnations`` equals the reference's on the same
  summaries.
- ``resilience/supervise.py``: a stream that drains (exit 75) resumes
  from its last completed query without charging the restart budget; a
  stream that dies is restarted up to ``max_restarts``.
"""

import tests.torch_threads  # noqa: F401  (first: sizes torch's threads)

import dataclasses
import json
import os
import signal
import sys
import threading
import time

import numpy as np
import pytest

from nds_tpu.resilience import faults as ref_faults
from nds_tpu.resilience import journal as ref_journal
from nds_tpu.resilience import supervise as ref_supervise
from nds_tpu.resilience import watchdog as ref_watchdog
from nds_tpu.utils import report as ref_report
from nds_tpu_torch.resilience import drain, faults, journal, supervise
from nds_tpu_torch.resilience import watchdog
from nds_tpu_torch.utils import report

SCHEDULES = [
    "device.execute:oom@q5",
    "io.read:delay=0.2@*",
    "exchange:fault*3~0.5@query1*",
    "stream.query:hang=90@query7,dml.apply:hang=90@store_sales",
    "store.commit:deterministic*2@*, plan:fault~0.25@q14_part1",
    "io.read:corrupt@customer",
]
BAD_SCHEDULES = ["device.execute:oom", "nosuch:oom@*", "plan:boom@*",
                 "plan:oom@"]


@pytest.fixture(autouse=True)
def _clean():
    yield
    faults.clear()
    ref_faults.clear()
    watchdog.reset()
    ref_watchdog.reset()
    drain.uninstall()


# ------------------------------------------------------------- faults

@pytest.mark.parametrize("text", SCHEDULES)
def test_schedules_parse_to_the_references_specs(text):
    got = [dataclasses.asdict(s) for s in faults.parse_schedule(text)]
    want = [dataclasses.asdict(s) for s in ref_faults.parse_schedule(text)]
    assert got == want


@pytest.mark.parametrize("text", BAD_SCHEDULES)
def test_bad_schedules_raise_in_both(text):
    with pytest.raises(ValueError):
        ref_faults.parse_schedule(text)
    with pytest.raises(ValueError):
        faults.parse_schedule(text)


def _firings(mod, schedule: str, seed: int, calls: int) -> list:
    mod.install(schedule, seed=seed)
    fired = []
    for i in range(calls):
        with mod.context(query=f"query{i % 7}"):
            try:
                mod.fault_point("device.execute", executor="X")
                fired.append(None)
            except mod.InjectedFault as e:
                fired.append((type(e).__name__, e.site, str(e)))
    mod.clear()
    return fired


@pytest.mark.parametrize("seed", [0, 7, 12345])
@pytest.mark.parametrize("schedule", [
    "device.execute:fault*40~0.3@*",
    "device.execute:oom*5~0.6@query3,device.execute:deterministic~0.1@*"])
def test_seeded_draws_fire_as_the_references(schedule, seed):
    got = _firings(faults, schedule, seed, 200)
    want = _firings(ref_faults, schedule, seed, 200)
    assert got == want
    assert any(got) and not all(got)


def test_env_schedule_and_its_seed(monkeypatch):
    monkeypatch.setenv(faults.FAULTS_ENV, "device.execute:fault*50~0.5@*")
    monkeypatch.setenv(faults.SEED_ENV, "3")
    a = _env_firings(faults)
    monkeypatch.setenv(faults.SEED_ENV, "4")
    b = _env_firings(faults)
    assert a != b
    monkeypatch.setenv(faults.SEED_ENV, "3")
    assert _env_firings(faults) == a


def _env_firings(mod) -> list:
    mod.clear()
    out = []
    for _ in range(60):
        try:
            mod.fault_point("device.execute")
            out.append(0)
        except mod.InjectedFault:
            out.append(1)
    return out


def test_suppress_and_capture_keep_a_site_quiet(monkeypatch):
    faults.install("plan:fault*10@*")
    with faults.suppress():
        faults.fault_point("plan")
    monkeypatch.setattr(faults, "_capturing", lambda: True)
    faults.fault_point("plan")
    monkeypatch.setattr(faults, "_capturing", lambda: False)
    with pytest.raises(faults.InjectedTransientFault):
        faults.fault_point("plan")


def test_hang_stops_until_interrupted():
    faults.install("stream.query:hang=30@*")
    done = threading.Event()

    def body():
        faults.fault_point("stream.query")
        done.set()

    t = threading.Thread(target=body)
    t0 = time.monotonic()
    t.start()
    assert not done.wait(0.3)
    faults.interrupt_hangs()
    t.join(5)
    assert done.is_set() and time.monotonic() - t0 < 10


def test_corrupt_flips_a_byte_of_the_first_path(tmp_path):
    p = tmp_path / "t.dat"
    p.write_bytes(bytes(range(10)))
    faults.install("io.read:corrupt@t")
    faults.fault_point("io.read", table="t", paths=[str(p)])
    assert p.read_bytes()[5] == 5 ^ 0xFF


def _nds_raw(tmp_path):
    from nds_tpu_torch.nds import gen_data
    raw = str(tmp_path / "raw")
    gen_data.generate_data_local(0.01, 1, raw, workers=1)
    return raw


def test_sites_fire_where_the_reference_fires_them(tmp_path):
    """``io.read`` in the reader, ``plan`` in the session,
    ``device.execute`` in the executors, ``stream.query`` in the pipeline
    and ``dml.apply`` in the DML, each raising the injected class."""
    from nds_tpu_torch.engine.device_exec import make_device_factory
    from nds_tpu_torch.engine.scheduler import make_pipeline
    from nds_tpu_torch.engine.session import Session
    from nds_tpu_torch.io import csv_io
    from nds_tpu_torch.nds.schema import get_schemas
    from nds_tpu_torch.utils.config import EngineConfig
    raw = _nds_raw(tmp_path)
    schema = get_schemas()["store"]
    path = os.path.join(raw, "store", os.listdir(
        os.path.join(raw, "store"))[0])
    faults.install("io.read:deterministic@store")
    with pytest.raises(faults.InjectedDeterministicFault) as e:
        csv_io.read_tbl([path], "store", schema)
    assert e.value.site == "io.read"
    faults.clear()
    table = csv_io.read_tbl([path], "store", schema)
    sql = "select count(*) c from store"
    for factory, site, scope in (
            (make_device_factory(device="cpu"), "device.execute",
             "DeviceExecutor"),
            (make_pipeline(EngineConfig(overrides={
                "engine.backend": "cpu"})), "device.execute",
             "CpuExecutor"),
            (make_device_factory(device="cpu"), "plan", "*"),
            (make_pipeline(EngineConfig(overrides={
                "engine.device": "cpu"})), "stream.query", "*")):
        sess = Session.for_nds(factory)
        sess.register_table(table)
        faults.install(f"{site}:deterministic@{scope}")
        with pytest.raises(faults.InjectedDeterministicFault) as e:
            sess.sql(sql)
        assert e.value.site == site
        faults.clear()
        assert int(sess.sql(sql).cols[0][0]) == table.nrows
    from nds_tpu_torch.engine import dml
    faults.install("dml.apply:deterministic@store")
    with pytest.raises(faults.InjectedDeterministicFault):
        dml.apply_delete(table, np.ones(table.nrows, bool))


# ------------------------------------------------------------ journals

def _phase_journal(mod, path, digest):
    j = mod.PhaseJournal(path, digest)
    j.reset()
    j.complete("load_test", load_time_s=5.0, rngseed=123)
    j.complete("power_test", power_time_s=2.0)
    return j


def _query_journal(mod, path, digest):
    j = mod.QueryJournal(path, phase="power-nds", digest=digest)
    j.reset()
    for q, w in (("query96", 12.5), ("query7", 40.25)):
        j.start(q)
        j.record(q, w, "Completed", result_digest=f"d-{q}")
    j.start("query93")
    j.mark_aborted("query93")
    return j


@pytest.mark.parametrize("writer,reader", [(ref_journal, journal),
                                           (journal, ref_journal)],
                         ids=["ref-to-port", "port-to-ref"])
def test_journals_load_in_the_other_package(writer, reader, tmp_path):
    digest = writer.config_digest({"scale_factor": 0.01, "x": [1, 2]})
    assert digest == reader.config_digest({"x": [1, 2],
                                           "scale_factor": 0.01})
    pj = str(tmp_path / "bench_state.json")
    _phase_journal(writer, pj, digest)
    got = reader.PhaseJournal(pj, digest)
    assert got.load() is True
    assert got.done("load_test") and not got.done("throughput_1")
    assert got.timings("load_test") == {"load_time_s": 5.0, "rngseed": 123}
    qj = str(tmp_path / "power-nds_queries.json")
    _query_journal(writer, qj, digest)
    q = reader.QueryJournal(qj, phase="power-nds", digest=digest)
    assert q.load() is True
    assert sorted(q.completed()) == ["query7", "query96"]
    assert q.entry("query7")["result_digest"] == "d-query7"
    assert q.entry("query93")["aborted"] == "drain-deadline"
    assert not q.done("query93") and q.starts("query93") == [0]
    assert q.begin_incarnation() == 1
    q.start("query93")
    q.record("query93", 3.0, "Completed")
    again = writer.QueryJournal(qj, phase="power-nds", digest=digest)
    assert again.load() and again.starts("query93") == [0, 1]
    assert "aborted" not in again.entry("query93")
    assert again.incarnation == 1


def _tear(path, how):
    if how == "torn":
        blob = open(path).read()
        with open(path, "w") as f:
            f.write(blob[: len(blob) // 2])
    else:
        state = json.load(open(path))
        assert "crc" in state
        key = "phases" if "phases" in state else "queries"
        state[key]["extra"] = {"timings": {"power_time_s": 9e9},
                               "done": True}
        with open(path, "w") as f:
            json.dump(state, f)


@pytest.mark.parametrize("how", ["torn", "tampered"])
@pytest.mark.parametrize("mod", [ref_journal, journal], ids=["ref", "port"])
def test_a_torn_journal_degrades_to_a_warned_fresh_start(mod, how,
                                                          tmp_path, capsys):
    pj = str(tmp_path / "bench_state.json")
    _phase_journal(mod, pj, "d")
    _tear(pj, how)
    j = mod.PhaseJournal(pj, "d")
    assert j.load() is False and not j.done("load_test")
    qj = str(tmp_path / "q.json")
    _query_journal(mod, qj, "d")
    _tear(qj, how)
    q = mod.QueryJournal(qj, digest="d")
    assert q.load() is False and q.completed() == {}
    assert capsys.readouterr().out.count("torn/corrupt") == 2


def test_the_ports_summaries_report_a_reset(tmp_path, monkeypatch):
    monkeypatch.setattr(journal, "resets_total", 0)
    rep = report.BenchReport("q")
    rep.attach_degradations()
    assert "degradations" not in rep.summary
    qj = str(tmp_path / "q.json")
    _query_journal(journal, qj, "d")
    _tear(qj, "torn")
    journal.QueryJournal(qj, digest="d").load()
    rep.attach_degradations()
    assert rep.summary["degradations"] == {"journal_resets": 1}


@pytest.mark.parametrize("mod", [ref_journal, journal], ids=["ref", "port"])
def test_a_journal_of_another_config_is_refused(mod, tmp_path):
    pj = str(tmp_path / "bench_state.json")
    _phase_journal(mod, pj, "a")
    with pytest.raises(mod.JournalMismatch):
        mod.PhaseJournal(pj, "b").load()
    qj = str(tmp_path / "q.json")
    _query_journal(mod, qj, "a")
    with pytest.raises(mod.JournalMismatch):
        mod.QueryJournal(qj, digest="b").load()


# ------------------------------------------------------------ watchdog

@pytest.mark.parametrize("mod", [ref_watchdog, watchdog],
                         ids=["ref", "port"])
def test_check_once_reports_a_stall_once(mod, tmp_path):
    exits = []
    wd = mod.Watchdog(2.0, action="kill", run_dir=str(tmp_path),
                      _exit=exits.append)
    assert wd.check_once() is None  # nothing beat yet
    mod.beat("power-nds", query="query7", phase="dispatch", attempt=0)
    t = time.monotonic()
    assert wd.check_once(now=t + 1.0) is None
    path = wd.check_once(now=t + 5.0)
    assert path and os.path.basename(path) == "stall-query7.json"
    assert exits == [mod.EXIT_STALLED] == [86]
    assert wd.check_once(now=t + 9.0) is None  # this silence is on disk
    mod.beat("power-nds", query="query7", phase="dispatch", attempt=1)
    assert wd.check_once(now=time.monotonic() + 5.0).endswith(
        "stall-query7-2.json")


def _report_keys(mod, tmp_path) -> set:
    mod.beat("u", query="q1", phase="p")
    wd = mod.Watchdog(1.0, run_dir=str(tmp_path))
    path = wd.check_once(now=time.monotonic() + 5.0)
    mod.reset()
    return set(json.load(open(path)))


def test_stall_report_keys_are_the_references(tmp_path):
    want = _report_keys(ref_watchdog, tmp_path / "ref")
    got = _report_keys(watchdog, tmp_path / "port")
    assert got == (want - {"metrics"}) | {"omitted"}
    assert "item 7" in watchdog.OMITTED["metrics"]


def test_heartbeat_file_feeds_the_supervisors_fold(tmp_path):
    progress = {"queries_completed": 2, "queries_total": 3,
                "current_query": "query93"}
    path = str(tmp_path / "hb.json")
    hb = watchdog.HeartbeatFile(path, 0.05, progress)
    watchdog.beat("stream_1", query="query93", phase="dispatch")
    t0 = time.time()
    hb.start()
    time.sleep(0.2)
    hb.stop()
    st = {"spec": supervise.StreamSpec("stream_1", None, path),
          "launched_at": t0 - 1, "base_completed": 1, "completed": 0}
    supervise.fold_child_snapshot(st)
    assert st["completed"] == 3 and st["inc_total"] == 3
    assert st["saw_heartbeat"] and st["current"] == "query93"
    assert 0 <= st["hb_age"] < 5
    want = dict(st, completed=0)
    ref_supervise.fold_child_snapshot(want)
    assert want["completed"] == st["completed"]


# --------------------------------------------------------------- drain

def test_a_drain_raises_at_the_next_boundary(tmp_path):
    exits = []
    dm = drain.install(5.0, str(tmp_path), _exit=exits.append)
    drain.check_boundary()  # nothing requested: no-op
    os.kill(os.getpid(), signal.SIGTERM)
    time.sleep(0.1)
    assert drain.requested()
    with pytest.raises(drain.DrainRequested) as e:
        drain.check_boundary()
    assert e.value.code == drain.EXIT_RESUMABLE == 75
    assert isinstance(e.value, SystemExit)
    time.sleep(0.2)
    assert exits == []  # the boundary stood the deadline down
    drain.uninstall()
    assert signal.getsignal(signal.SIGTERM) != dm._on_signal


def test_past_the_deadline_the_hooks_run_before_the_exit(tmp_path):
    exits = []
    q = journal.QueryJournal(str(tmp_path / "q.json"), digest="d")
    q.reset()
    q.start("query7")
    dm = drain.install(0.2, str(tmp_path), _exit=exits.append)
    dm.add_flush_hook(lambda: q.mark_aborted("query7"))
    dm._on_signal(signal.SIGTERM, None)
    for _ in range(50):
        if exits:
            break
        time.sleep(0.05)
    assert exits == [75]
    got = journal.QueryJournal(str(tmp_path / "q.json"), digest="d")
    assert got.load() and got.entry("query7")["aborted"] == "drain-deadline"
    assert not got.done("query7")


def test_drain_seconds_follows_config_then_env(monkeypatch):
    from nds_tpu_torch.utils.config import EngineConfig
    monkeypatch.setenv(drain.DRAIN_ENV, "7")
    assert drain.drain_seconds() == 7.0
    assert drain.drain_seconds(EngineConfig(overrides={
        "engine.drain_s": "3"})) == 3.0
    monkeypatch.delenv(drain.DRAIN_ENV)
    assert drain.drain_seconds() == drain.DEFAULT_DRAIN_S == 30.0


# ------------------------------------------------------------ reports

def _summaries(seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(12):
        q = f"query{int(rng.integers(1, 6))}"
        s = {"query": q, "queryStatus": [str(rng.choice(
            ["Completed", "Failed", "CompletedWithTaskFailures"]))],
             "queryTimes": [int(rng.integers(1, 500))],
             "startTime": int(1_000_000 + rng.integers(0, 10_000))}
        if rng.random() < 0.7:
            s["incarnation"] = int(rng.integers(0, 3))
        if rng.random() < 0.8:
            s["result_digest"] = f"{int(rng.integers(0, 1 << 30)):08x}"
        out.append(s)
    out.append({"query": "load_warehouse"})  # no status: not a statement
    return out


@pytest.mark.parametrize("seed", range(6))
def test_merge_incarnations_equals_the_references(seed):
    ss = _summaries(seed)
    assert report.merge_incarnations(ss, phase="power-nds") == \
        ref_report.merge_incarnations(ss, phase="power-nds")


@pytest.mark.parametrize("name", ["power-nds-cpu-gpu-1-query7-2.json",
                                  "power-nds_queries.json",
                                  "merged-power-nds.json",
                                  "bench_state.json", "analysis.json",
                                  "time.csv"])
def test_report_names_are_the_references(name):
    from nds_tpu.obs.analyze import is_report_basename as ref_is
    assert report.is_report_basename(name) == ref_is(name)


# ----------------------------------------------------------- supervise

CHILD = """
import json, os, sys, time
name, log = sys.argv[1], sys.argv[2]
with open(log, "a") as f:
    f.write(json.dumps([os.environ.get("NDS_TPU_STREAM"), sys.argv[3:]])
            + "\\n")
codes = [int(c) for c in os.environ["CHILD_CODES"].split(",")]
n = sum(1 for _ in open(log))
sys.exit(codes[min(n, len(codes)) - 1])
"""


def _specs(tmp_path, codes: str):
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    log = tmp_path / "calls.jsonl"
    env = {**os.environ, "CHILD_CODES": codes}

    def make_cmd(inc, remaining):
        return [sys.executable, str(script), "s1", str(log),
                *(remaining or [])]

    spec = supervise.StreamSpec("s1", make_cmd, str(tmp_path / "hb.json"),
                                queries=["query1", "query2", "query3"],
                                env=env, log_path=str(tmp_path / "s1.log"))
    return [spec], log


def test_a_drained_stream_resumes_without_charging_restarts(tmp_path):
    specs, log = _specs(tmp_path, "75,75,0")
    sup = supervise.StreamSupervisor(specs, str(tmp_path), max_restarts=0)
    _elapse, codes, summary = sup.run()
    assert codes == [0]
    s = summary["streams"]["s1"]
    assert (s["resumes"], s["restarts"], s["exit_codes"]) == (2, 0,
                                                              [75, 75, 0])
    calls = [json.loads(x) for x in open(log)]
    assert [c[0] for c in calls] == ["s1", "s1#r1", "s1#r2"]
    assert json.load(open(tmp_path / supervise.SUMMARY_NAME)) == summary


def test_a_dead_stream_restarts_up_to_its_budget(tmp_path):
    specs, log = _specs(tmp_path, "3,3,3")
    _elapse, codes, summary = supervise.StreamSupervisor(
        specs, str(tmp_path), max_restarts=1).run()
    assert codes == [3]
    s = summary["streams"]["s1"]
    assert (s["restarts"], s["resumes"], s["exit_codes"]) == (1, 0, [3, 3])
    assert s["degraded"] and s["skipped_queries"] == ["query1", "query2",
                                                      "query3"]
    assert "restarts=1" in supervise.describe_summary(summary)


@pytest.mark.parametrize("completed", range(6))
def test_resume_index_equals_the_references(completed):
    qs = ["query1", "query15_part1", "query15_part2", "query15_part3",
          "query16"]
    assert supervise.resume_index(qs, completed) == \
        ref_supervise.resume_index(qs, completed)
