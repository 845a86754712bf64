"""The port's whole-benchmark orchestrators against the reference's.

- The reference's ``TestBenchResume`` cases (``tests/test_resilience.py``)
  against ``nds_tpu_torch/nds/bench.py``, with every phase faked as there
  (a recorder that writes the artifact the orchestrator reads back):
  a resumed run skips every journaled phase, a crash in the second
  throughput round reruns only the tail, a changed config is refused, a
  fresh run resets a stale journal, a torn or CRC-tampered journal
  degrades to a warned fresh start; and a drained phase (exit 75) runs
  again with ``--resume``.
- ``get_perf_metric`` of both suites and ``get_stream_range`` equal the
  reference's on a grid of inputs (integers exactly).
- The YAML keys the port refuses (``cache``, ``metrics_snap``) stop
  either orchestrator before any phase runs, naming their item.
- The engine's power runs take ``--allow_recovered``; a power run that
  exits 1 (a crash, or a failed statement) fails either orchestrator
  whatever an earlier run left in its summary folder, and a fresh power
  phase removes what an earlier run left at its outputs.
- One real NDS-H ``run_full_bench`` at SF0.01 on torch CPU (``device:
  cpu``, one throughput stream, the in-process round): every term is
  positive, the metric is ``get_perf_metric`` of the terms it wrote, and
  ``metrics.csv`` has the reference's columns. Phase subprocesses run with
  ``OMP_NUM_THREADS=1``.
- Under ``-m slow``: the full NDS ``run_full_bench`` at SF0.01 with
  validate, then its resume after the last two phases are deleted.
"""

import tests.torch_threads  # noqa: F401  (first: sizes torch's threads)

import csv
import itertools
import json
import os
import subprocess

import pytest

from nds_tpu.nds import bench as ref_nds_bench
from nds_tpu.nds_h import bench as ref_h_bench
from nds_tpu_torch.nds import bench as nds_bench
from nds_tpu_torch.nds_h import bench as h_bench
from nds_tpu_torch.resilience.journal import JournalMismatch
from nds_tpu_torch.utils.timelog import TimeLog


class TestBenchResume:
    """The reference's cases, on the port's orchestrator."""

    @staticmethod
    def _fake_phases(monkeypatch, calls, power_rcs=None):
        """Replace every subprocess phase with a recorder that writes the
        artifact the orchestrator reads back. ``power_rcs``: the exit
        codes the power phase's runs return, in order (0 after them)."""
        rcs = list(power_rcs or [])

        def fake_run(cmd):
            calls.append(cmd[2])
            mod = cmd[2]
            if mod == "nds_tpu_torch.nds.transcode":
                with open(cmd[5], "w") as f:
                    f.write("Total conversion time for 24 tables was "
                            "5.0s\nRNGSEED used: 123\n")
            elif mod == "nds_tpu_torch.nds.power":
                t = TimeLog("fake")
                t.add("Power Test Time", 2000)
                t.write(cmd[5])
            elif mod == "nds_tpu_torch.nds.maintenance":
                t = TimeLog("fake")
                t.add("Data Maintenance Time", 1500)
                t.write(cmd[5])

        def fake_streams(*a, **kw):
            calls.append("stream_gen")

        def fake_tp(*a, **kw):
            calls.append("throughput")
            return 3.0, [0]

        def fake_run_rc(cmd):
            fake_run(cmd)
            if cmd[2] == "nds_tpu_torch.nds.power" and rcs:
                calls.append(("rc", rcs[0], "--resume" in cmd))
                return rcs.pop(0)
            return 0

        monkeypatch.setattr(nds_bench, "_run", fake_run)
        monkeypatch.setattr(nds_bench, "_run_rc", fake_run_rc)
        import nds_tpu_torch.nds.streams as streams_mod
        import nds_tpu_torch.nds.throughput as tp_mod
        monkeypatch.setattr(streams_mod, "generate_query_streams",
                            fake_streams)
        monkeypatch.setattr(tp_mod, "run_streams", fake_tp)
        monkeypatch.setattr(tp_mod, "run_streams_inprocess", fake_tp)

    def _cfg(self, tmp_path):
        work = tmp_path / "w"
        return {
            "scale_factor": 0.01, "parallel": 2, "num_streams": 1,
            "backend": "cpu",
            "paths": {
                "raw_data": str(work / "raw"),
                "warehouse": str(work / "wh"),
                "streams": str(work / "streams"),
                "reports": str(work / "reports"),
            },
            "skip": {},
        }

    def test_resume_skips_completed_phases(self, tmp_path, monkeypatch):
        calls = []
        self._fake_phases(monkeypatch, calls)
        cfg = self._cfg(tmp_path)
        m1 = nds_bench.run_full_bench(cfg)
        assert m1["metric"] is not None and m1["metric"] > 0
        assert calls
        state = json.load(open(os.path.join(cfg["paths"]["reports"],
                                            "bench_state.json")))
        assert set(state["phases"]) == {
            "data_gen", "load_test", "stream_gen", "power_test",
            "throughput_1", "maintenance_1", "throughput_2",
            "maintenance_2"}
        calls.clear()
        m2 = nds_bench.run_full_bench(cfg, resume=True)
        assert calls == []
        assert m2["metric"] == m1["metric"]

    def test_resume_after_crash_reruns_only_the_tail(self, tmp_path,
                                                     monkeypatch):
        calls = []
        self._fake_phases(monkeypatch, calls)
        cfg = self._cfg(tmp_path)
        m1 = nds_bench.run_full_bench(cfg)
        jpath = os.path.join(cfg["paths"]["reports"], "bench_state.json")
        state = json.load(open(jpath))
        for ph in ("throughput_2", "maintenance_2"):
            del state["phases"][ph]
        state.pop("crc", None)
        with open(jpath, "w") as f:
            json.dump(state, f)
        calls.clear()
        m2 = nds_bench.run_full_bench(cfg, resume=True)
        assert "nds_tpu_torch.nds.transcode" not in calls
        assert "nds_tpu_torch.nds.power" not in calls
        assert calls.count("throughput") == 1
        assert calls.count("nds_tpu_torch.nds.maintenance") == 1
        assert m2["metric"] == m1["metric"]

    def test_resume_refuses_config_drift(self, tmp_path, monkeypatch):
        calls = []
        self._fake_phases(monkeypatch, calls)
        cfg = self._cfg(tmp_path)
        nds_bench.run_full_bench(cfg)
        cfg2 = dict(cfg)
        cfg2["scale_factor"] = 3000
        with pytest.raises(JournalMismatch):
            nds_bench.run_full_bench(cfg2, resume=True)

    def test_fresh_run_resets_stale_journal(self, tmp_path, monkeypatch):
        calls = []
        self._fake_phases(monkeypatch, calls)
        cfg = self._cfg(tmp_path)
        nds_bench.run_full_bench(cfg)
        n = len(calls)
        calls.clear()
        nds_bench.run_full_bench(cfg)
        assert len(calls) == n

    def test_torn_journal_resumes_fresh_with_warning(self, tmp_path,
                                                     monkeypatch, capsys):
        calls = []
        self._fake_phases(monkeypatch, calls)
        cfg = self._cfg(tmp_path)
        m1 = nds_bench.run_full_bench(cfg)
        n_phases = len(calls)
        jpath = os.path.join(cfg["paths"]["reports"], "bench_state.json")
        blob = open(jpath).read()
        with open(jpath, "w") as f:
            f.write(blob[: len(blob) // 2])
        calls.clear()
        m2 = nds_bench.run_full_bench(cfg, resume=True)
        assert "torn/corrupt" in capsys.readouterr().out
        assert len(calls) == n_phases
        assert m2["metric"] == m1["metric"]

    def test_crc_tampered_journal_also_degrades(self, tmp_path,
                                                monkeypatch, capsys):
        calls = []
        self._fake_phases(monkeypatch, calls)
        cfg = self._cfg(tmp_path)
        nds_bench.run_full_bench(cfg)
        jpath = os.path.join(cfg["paths"]["reports"], "bench_state.json")
        state = json.load(open(jpath))
        assert "crc" in state
        state["phases"]["power_test"]["timings"]["power_time_s"] = 9e9
        with open(jpath, "w") as f:
            json.dump(state, f)
        calls.clear()
        nds_bench.run_full_bench(cfg, resume=True)
        assert "torn/corrupt" in capsys.readouterr().out
        assert calls

    def test_a_drained_power_phase_runs_again_with_resume(self, tmp_path,
                                                          monkeypatch):
        calls = []
        self._fake_phases(monkeypatch, calls, power_rcs=[75, 75, 0])
        m = nds_bench.run_full_bench(self._cfg(tmp_path))
        assert [c for c in calls if isinstance(c, tuple)] == [
            ("rc", 75, False), ("rc", 75, True), ("rc", 0, True)]
        assert m["metric"] > 0

    def test_a_failed_power_phase_fails_the_bench(self, tmp_path,
                                                  monkeypatch):
        calls = []
        self._fake_phases(monkeypatch, calls, power_rcs=[3])
        with pytest.raises(subprocess.CalledProcessError):
            nds_bench.run_full_bench(self._cfg(tmp_path))
        assert "throughput" not in calls


# ------------------------------------------------------------- metrics

SCALES = [0.01, 1, 3.5, 100]
STREAMS = [0, 1, 2, 4, 9]
TIMES = [0.0, 0.5, 7.25, 123.0]


@pytest.mark.parametrize("scale,sq", list(itertools.product(SCALES,
                                                            STREAMS)))
def test_nds_h_metric_equals_the_references(scale, sq):
    for tld, tpt, ttt in itertools.product(TIMES, repeat=3):
        got = h_bench.get_perf_metric(scale, sq, tld, tpt, ttt)
        want = ref_h_bench.get_perf_metric(scale, sq, tld, tpt, ttt)
        assert type(got) is type(want) is int
        assert got == want, (tld, tpt, ttt)


@pytest.mark.parametrize("scale,sq", list(itertools.product(SCALES,
                                                            STREAMS)))
def test_nds_metric_equals_the_references(scale, sq):
    for t in itertools.product([0.0, 1.5, 60.0], repeat=6):
        got = nds_bench.get_perf_metric(scale, sq, *t)
        want = ref_nds_bench.get_perf_metric(scale, sq, *t)
        assert type(got) is type(want) is int
        assert got == want, t


@pytest.mark.parametrize("n", range(0, 12))
def test_stream_range_equals_the_references(n):
    for r in (1, 2):
        assert nds_bench.get_stream_range(n, r) == \
            ref_nds_bench.get_stream_range(n, r)


def test_time_readers_equal_the_references(tmp_path):
    t = TimeLog("x")
    t.add("query1", 10)
    t.add("Power Test Time", 2345)
    t.add("Data Maintenance Time", 678)
    p = str(tmp_path / "t.csv")
    t.write(p)
    assert nds_bench.get_power_time(p) == ref_nds_bench.get_power_time(p)
    assert h_bench.get_power_time(p) == ref_h_bench.get_power_time(p)
    assert nds_bench.get_maintenance_time(p) == \
        ref_nds_bench.get_maintenance_time(p)


# ------------------------------------------------------- refused keys

@pytest.mark.parametrize("key,item", [("cache", "item 18"),
                                      ("metrics_snap", "item 7")])
@pytest.mark.parametrize("mod", [nds_bench, h_bench], ids=["nds", "nds_h"])
def test_refused_keys_stop_the_bench_before_any_phase(mod, key, item,
                                                      tmp_path, monkeypatch,
                                                      capsys):
    ran = []
    monkeypatch.setattr(mod, "_run", lambda cmd: ran.append(cmd))
    cfg = TestBenchResume()._cfg(tmp_path)
    cfg[key] = {"dir": str(tmp_path / "x")}
    with pytest.raises(h_bench.BenchConfigError, match=item):
        mod.run_full_bench(cfg)
    assert ran == []
    assert not os.path.exists(cfg["paths"]["reports"])
    path = tmp_path / "cfg.yml"
    path.write_text(json.dumps(cfg))
    with pytest.raises(SystemExit) as e:
        mod.main([str(path)])
    assert e.value.code == 2 and item in capsys.readouterr().err


SUITE_BENCHES = {"nds_h": h_bench, "nds": nds_bench}


def _fake_subprocesses(monkeypatch, power_rc, cmds):
    """Replace every phase subprocess (``subprocess.run``, which both
    orchestrators' ``_run`` and ``_run_rc`` call) with a recorder that
    writes what the orchestrator reads back; a power run exits
    ``power_rc`` and writes its time log only where it exits 0."""
    def run(cmd, check=False, **_kw):
        cmds.append(cmd)
        mod = cmd[2]
        rc = power_rc if mod.endswith(".power") else 0
        if mod.endswith(".transcode"):
            with open(cmd[5], "w") as f:
                f.write("Total conversion time for 24 tables was "
                        "5.0s\nRNGSEED used: 123\n")
        elif mod.endswith((".power", ".maintenance")) and rc == 0:
            os.makedirs(os.path.dirname(cmd[5]), exist_ok=True)
            t = TimeLog("fake")
            t.add("Power Test Time", 2000)
            t.add("Data Maintenance Time", 1500)
            t.write(cmd[5])
        if check and rc:
            raise subprocess.CalledProcessError(rc, cmd)
        return subprocess.CompletedProcess(cmd, rc)

    def fake_tp(*_a, **_kw):
        cmds.append(["throughput"])
        return 3.0, [0]

    import nds_tpu_torch.nds.streams as nds_streams_mod
    import nds_tpu_torch.nds.throughput as nds_tp
    import nds_tpu_torch.nds_h.streams as h_streams_mod
    import nds_tpu_torch.nds_h.throughput as h_tp
    monkeypatch.setattr(subprocess, "run", run)
    for mod in (nds_streams_mod, h_streams_mod):
        monkeypatch.setattr(mod, "generate_query_streams",
                            lambda *a, **kw: None)
    for mod, name in ((nds_tp, "run_streams"), (h_tp, "run_streams"),
                      (nds_tp, "run_streams_inprocess")):
        monkeypatch.setattr(mod, name, fake_tp)


def _stale_power_outputs(cfg) -> str:
    """What an earlier run's power phase left: a summary of a statement
    recovered from a task failure, and a time log. The summary's path."""
    reports = cfg["paths"]["reports"]
    os.makedirs(os.path.join(reports, "json"), exist_ok=True)
    stale = os.path.join(reports, "json", "power-x-query2-1.json")
    with open(stale, "w") as f:
        json.dump({"query": "query2", "startTime": 1,
                   "queryStatus": ["CompletedWithTaskFailures"]}, f)
    t = TimeLog("earlier")
    t.add("Power Test Time", 9000)
    t.write(os.path.join(reports, "power_time.csv"))
    return stale


@pytest.mark.parametrize("suite", list(SUITE_BENCHES))
def test_a_power_run_that_crashed_fails_the_bench(suite, tmp_path,
                                                  monkeypatch):
    """Exit 1 is a crash or a failed statement: it fails the bench even
    where an earlier run's summaries show only recovered statements."""
    cmds = []
    _fake_subprocesses(monkeypatch, 1, cmds)
    cfg = TestBenchResume()._cfg(tmp_path)
    _stale_power_outputs(cfg)
    with pytest.raises(subprocess.CalledProcessError) as e:
        SUITE_BENCHES[suite].run_full_bench(cfg)
    assert e.value.returncode == 1 and e.value.cmd[2].endswith(".power")
    assert ["throughput"] not in cmds


@pytest.mark.parametrize("suite", list(SUITE_BENCHES))
def test_the_engines_power_runs_allow_recovered_statements(suite, tmp_path,
                                                           monkeypatch):
    """Every power run of the bench's engine (the power phase, validate's
    engine round) takes ``--allow_recovered``, none ``--allow_failure``;
    a fresh power phase removes an earlier run's summaries and time log,
    and the metric reads this run's power time."""
    cmds = []
    _fake_subprocesses(monkeypatch, 0, cmds)
    cfg = TestBenchResume()._cfg(tmp_path)
    if suite == "nds":
        cfg["validate"] = {"epsilon": 0.00001}
    stale = _stale_power_outputs(cfg)
    m = SUITE_BENCHES[suite].run_full_bench(cfg)
    assert m["power_time_s"] == 2.0 and not os.path.exists(stale)
    power = [c for c in cmds if len(c) > 2 and c[2].endswith(".power")]
    # the CPU oracle's round of validate writes no summaries
    engine = [c for c in power if "--json_summary_folder" in c]
    assert len(engine) == (2 if suite == "nds" else 1)
    assert all("--allow_recovered" in c for c in engine)
    assert not any("--allow_failure" in c for c in power)


# --------------------------------------------------------- a real bench

def _real_cfg(tmp_path, suite: str, num_streams: int) -> dict:
    work = tmp_path / suite
    cfg = {"scale_factor": 0.01, "parallel": 2,
           "num_streams": num_streams, "device": "cpu",
           "paths": {"raw_data": str(work / "raw"),
                     "warehouse": str(work / "wh"),
                     "streams": str(work / "streams"),
                     "reports": str(work / "reports")}}
    if suite == "nds":
        import chip_smoke
        cfg["paths"]["refresh_data"] = str(work / "refresh")
        # the card's sweep (without q59, whose LIMIT cuts through ties
        # under some of the parameters the load's end time draws)
        cfg["validate"] = {"epsilon": 0.00001,
                           "query_subset": chip_smoke.orch_validate_subset()}
    return cfg


def _metrics_row(cfg) -> dict:
    with open(os.path.join(cfg["paths"]["reports"], "metrics.csv")) as f:
        header, row = list(csv.reader(f))
    return dict(zip(header, row))


def _reference_columns(tmp_path, monkeypatch) -> list:
    """The header the reference's NDS-H orchestrator writes (its phases
    faked)."""
    cfg = _real_cfg(tmp_path / "ref", "nds_h", 1)
    cfg["backend"] = "cpu"

    def fake_run(cmd, backend=None):
        if cmd[2] == "nds_tpu.nds_h.transcode":
            with open(cmd[5], "w") as f:
                f.write("Total conversion time for 8 tables was 1.0s\n"
                        "RNGSEED used: 7\n")
        elif cmd[2] == "nds_tpu.nds_h.power":
            t = TimeLog("fake")
            t.add("Power Test Time", 1000)
            t.write(cmd[5])

    import nds_tpu.nds_h.streams as ref_streams
    import nds_tpu.nds_h.throughput as ref_tp
    monkeypatch.setattr(ref_h_bench, "_run", fake_run)
    monkeypatch.setattr(ref_streams, "generate_query_streams",
                        lambda *a, **k: None)
    monkeypatch.setattr(ref_tp, "run_streams", lambda *a, **k: (1.0, [0]))
    ref_h_bench.run_full_bench(cfg)
    with open(os.path.join(cfg["paths"]["reports"], "metrics.csv")) as f:
        return next(csv.reader(f))


def test_a_real_nds_h_bench_on_torch_cpu(tmp_path, monkeypatch):
    columns = _reference_columns(tmp_path, monkeypatch)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg = _real_cfg(tmp_path, "nds_h", 1)
    m = h_bench.run_full_bench(cfg)
    row = _metrics_row(cfg)
    assert list(row) == columns
    terms = [m["load_time_s"], m["power_time_s"], m["throughput_time_s"]]
    assert all(t > 0 for t in terms)
    assert [float(row[k]) for k in ("load_s", "power_s",
                                    "throughput_s")] == terms
    assert m["metric"] == int(row["metric"]) == h_bench.get_perf_metric(
        0.01, 1, *terms) > 0
    # the in-process round: every statement on the device engine
    j = json.load(open(os.path.join(cfg["paths"]["reports"], "throughput",
                                    "stream_1_queries.json")))
    placed = {(e["status"], e.get("placement"), e.get("reschedules"))
              for q, e in j["queries"].items()
              if not q.startswith(("query15_part1", "query15_part3"))}
    assert placed == {("Completed", "device", 0)}


@pytest.mark.slow
def test_a_real_nds_bench_and_its_resume_on_torch_cpu(tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg = _real_cfg(tmp_path, "nds", 1)
    m = nds_bench.run_full_bench(cfg)
    assert m["metric"] > 0 and m["validation_ok"] is True
    before = _metrics_row(cfg)
    jpath = os.path.join(cfg["paths"]["reports"], "bench_state.json")
    state = json.load(open(jpath))
    assert list(state["phases"])[-2:] == ["maintenance_2", "validate"]
    for ph in ("maintenance_2", "validate"):
        del state["phases"][ph]
    state.pop("crc", None)
    with open(jpath, "w") as f:
        json.dump(state, f)
    m2 = nds_bench.run_full_bench(cfg, resume=True)
    after = _metrics_row(cfg)
    for k in ("load_s", "power_s", "throughput1_s", "throughput2_s",
              "maintenance1_s"):
        assert after[k] == before[k], k
    assert m2["validation_ok"] is True
