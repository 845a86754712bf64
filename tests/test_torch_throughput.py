"""The port's throughput phase and async dispatch, on the CPU.

- ``DeviceExecutor.execute_async``: handles of one plan and of two plans
  in flight, resolved in both orders, equal ``execute``'s results, on the
  CPU executor and on one given a ``PlanGraphs`` runner on the stand-in
  graph class of ``tests/test_torch_plan_graphs.py`` (where a plan's
  later calls replay and return ``_Replayed`` handles); an overflow read
  at ``result()`` after a replay runs the plan again at a doubled slack,
  doubled once where two handles of the plan overflowed; a capture takes
  a new pool once no live graph holds the old one.
- Two NDS-H streams (SF0.01, the port's raw warehouse, stream files from
  the reference's generator) through ``nds/throughput.py``'s machinery:
  ``nds_h.throughput.run_streams`` (one power CLI subprocess a stream)
  and ``run_streams_inprocess`` on torch CPU (``device="cpu"``). Every
  status is ``Completed`` on the ``device`` placement, each stream's
  statements are in the reference's parse order, the elapse is a
  multiple of 0.1 s that covers every stream's Power Test Time, every
  stream's results equal the CPU oracle's under the validate CLI, and
  the in-process per-stream summaries have the keys of the reference's
  ``run_streams_inprocess`` (run on the same streams, backend cpu).
- The NDS-H power CLI with ``--backend distributed`` on one gloo rank (a
  subprocess): every statement placed ``sharded``, its rows equal to
  ``--backend cpu``'s under ``utils/validate_core.py``'s rules (epsilon
  1e-5).
- The throughput CLIs refuse the supervisor's flags with
  ``--in_process``.

Stream subprocesses run with ``OMP_NUM_THREADS=1``: two torch processes
each taking every core slow each other down several times over.
"""

import tests.torch_threads  # noqa: F401  (first: sizes torch's threads)

import json
import math
import os
import pathlib
import subprocess
import sys

import pytest

from nds_tpu.nds import power as ref_nds_power
from nds_tpu.nds import throughput as ref_throughput
from nds_tpu.nds_h import power as ref_h_power
from nds_tpu.nds_h import streams as ref_h_streams
from nds_tpu_torch.datagen import tpch
from nds_tpu_torch.engine import device_exec as dx
from nds_tpu_torch.engine.session import Session
from nds_tpu_torch.io.host_table import from_arrays
from nds_tpu_torch.io.result_io import result_digest
from nds_tpu_torch.nds import throughput
from nds_tpu_torch.nds_h import gen_data as h_gen
from nds_tpu_torch.nds_h import power as h_power
from nds_tpu_torch.nds_h import streams as h_streams
from nds_tpu_torch.nds_h import throughput as h_throughput
from nds_tpu_torch.nds_h import validate as h_validate
from nds_tpu_torch.nds_h.schema import get_schemas
from nds_tpu_torch.utils import power_core
from nds_tpu_torch.utils.config import EngineConfig
from nds_tpu_torch.utils.report import is_report_basename
from nds_tpu_torch.utils.timelog import TimeLog

from tests.test_torch_plan_graphs import StandInGraph

REPO = pathlib.Path(__file__).resolve().parent.parent
SF = 0.01
STREAMS = 2
# summary keys of the reference's in-process streams that the port does
# not write, with the ROADMAP Queue 1 item that brings each back
NOT_YET_PORTED: dict = {}


# -------------------------------------------------------- async dispatch

@pytest.fixture(scope="module")
def tables():
    schemas = get_schemas()
    return {t: from_arrays(t, schemas[t], tpch.gen_table(t, SF))
            for t in schemas}


def _session(tables, graphs: bool):
    sess = Session.for_nds_h(dx.make_device_factory(device="cpu"))
    for t in tables.values():
        sess.register_table(t)
    ex = sess._executor_factory(sess.tables)
    if graphs:
        ex._graphs = dx.PlanGraphs(ex.device, graph_cls=StandInGraph,
                                   new_pool=lambda: ("pool",), stream=None)
    return sess, ex


def _plan(sess, qn: int):
    (sql,) = h_streams.statements(qn)
    return sess.plan(sql)


@pytest.mark.parametrize("graphs", [False, True], ids=["eager", "graphs"])
def test_async_handles_in_flight_equal_execute(tables, graphs):
    sess, ex = _session(tables, graphs)
    p, q = _plan(sess, 3), _plan(sess, 18)
    exp = {id(p): result_digest(ex.execute(p)),
           id(q): result_digest(ex.execute(q))}
    kinds = set()
    for order in ((0, 1), (1, 0)):
        for pair in ((p, p), (p, q)):
            hs = [(plan, ex.execute_async(plan)) for plan in pair]
            kinds.update(type(h).__name__ for _plan, h in hs)
            for j in order:
                plan, h = hs[j]
                assert result_digest(h.result()) == exp[id(plan)]
                # a handle resolves once
                assert result_digest(h.result()) == exp[id(plan)]
    assert kinds == ({"_Replayed"} if graphs else {"_Done"})
    if graphs:
        assert ex._graphs.captures == 2 and ex._graphs.replays == 8
    assert ex.last_timings["__kernels"]


def test_an_overflow_read_at_result_runs_the_plan_again(tables,
                                                        monkeypatch):
    """A replay whose counts show an overflow: ``result()`` drops the
    graph, doubles the plan's slack and runs it eagerly, then captures
    again, with the other handle in flight unaffected."""
    sess, ex = _session(tables, graphs=True)
    p, q = _plan(sess, 3), _plan(sess, 18)
    exp = {id(p): result_digest(ex.execute(p)),
           id(q): result_digest(ex.execute(q))}
    slack = ex._entries[id(p)]["slack"]
    to_host = dx.DeviceExecutor._to_host
    hit = {"n": 0}

    def overflowed(self, row, outs, perm, counts):
        if self._graphs.replays == 1 and not hit["n"]:
            hit["n"] += 1
            return None
        return to_host(self, row, outs, perm, counts)
    monkeypatch.setattr(dx.DeviceExecutor, "_to_host", overflowed)
    hp, hq = ex.execute_async(p), ex.execute_async(q)
    assert result_digest(hq.result()) == exp[id(q)]
    assert result_digest(hp.result()) == exp[id(p)]
    assert ex.last_timings["slack_retries"] == 1
    assert ex._entries[id(p)]["slack"] == 2 * slack
    assert ex._graphs.captures == 3


@pytest.mark.parametrize("order", [(0, 1), (1, 0)])
def test_two_overflowed_handles_of_one_plan_double_its_slack_once(
        tables, monkeypatch, order):
    """Two handles of one plan in flight whose replays both overflow: the
    first resolved drops the graph, doubles the slack and captures again;
    the other, finding the slack moved on since its replay, replays that
    new graph, so the slack doubles once and the plan captures once more,
    in either order of ``result()``."""
    sess, ex = _session(tables, graphs=True)
    p = _plan(sess, 3)
    exp = result_digest(ex.execute(p))
    slack = ex._entries[id(p)]["slack"]
    to_host = dx.DeviceExecutor._to_host
    hit = {"n": 0}

    def overflowed(self, row, outs, perm, counts):
        # the two replays' copies (read at dispatch on the CPU)
        if hit["n"] < 2:
            hit["n"] += 1
            return None
        return to_host(self, row, outs, perm, counts)
    monkeypatch.setattr(dx.DeviceExecutor, "_to_host", overflowed)
    hs = [ex.execute_async(p), ex.execute_async(p)]
    assert hit["n"] == 2
    for j in order:
        assert result_digest(hs[j].result()) == exp
    assert ex._entries[id(p)]["slack"] == 2 * slack
    assert ex._graphs.captures == 2 and ex._graphs.replays == 3


def test_a_capture_takes_a_new_pool_once_no_graph_holds_the_old(tables):
    """Captures share the pool while a live graph holds it; once every
    graph in it is dropped, the next capture takes a new pool (torch's
    pinned-host allocator fails a capture into a pool whose count of
    graphs fell to 0, as the card showed after an out-of-memory)."""
    sess, ex = _session(tables, graphs=True)
    ex._graphs.new_pool = object
    p, q = _plan(sess, 3), _plan(sess, 18)
    ex.execute(p)
    first = ex._graphs.pool
    ex.execute(q)
    assert ex._graphs.pool is first
    assert {g.pool for g in ex._graphs.graphs.values()} == {first}
    ex._graphs.drop(id(p))
    ex._entries.pop(id(p))
    ex.execute(p)  # q's graph still holds the pool
    assert ex._graphs.pool is first
    for key in list(ex._graphs.graphs):
        ex._graphs.drop(key)
    ex._entries.clear()
    exp = result_digest(ex.execute(p))
    assert ex._graphs.pool is not first
    assert [g.pool for g in ex._graphs.graphs.values()] == [
        ex._graphs.pool]
    assert result_digest(ex.execute(p)) == exp


# ------------------------------------------------------ throughput runs

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The port's SF0.01 raw warehouse and 1 + STREAMS stream files from
    the reference's generator; stream 0 runs on the CPU oracle with its
    results saved."""
    root = tmp_path_factory.mktemp("throughput")
    raw = str(root / "raw")
    h_gen.generate_data_local(SF, 2, raw, workers=2)
    paths = ref_h_streams.generate_query_streams(str(root / "streams"),
                                                 1 + STREAMS)
    oracle = str(root / "oracle")
    assert power_core.run_query_stream(
        h_power.SUITE, raw, paths[0], str(root / "oracle.csv"),
        config=EngineConfig(overrides={"engine.backend": "cpu"}),
        input_format="raw", output_prefix=oracle) == 0
    return {"root": root, "raw": raw, "streams": paths[1:],
            "oracle": oracle}


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """Both modes over streams 1 and 2 on torch CPU, each with its
    results saved."""
    env = {"OMP_NUM_THREADS": "1"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    out = {}
    try:
        for mode in ("subprocess", "in_process"):
            d = tmp_path_factory.mktemp(mode)
            run = (h_throughput.run_streams if mode == "subprocess"
                   else _in_process)
            elapse, codes = run(data["raw"], data["streams"], str(d),
                                input_format="raw", device="cpu",
                                output_prefix=str(d / "results"))
            out[mode] = {"dir": d, "elapse": elapse, "codes": codes}
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


def _in_process(*args, **kw):
    return throughput.run_streams_inprocess(*args, suite=h_power.SUITE,
                                            **kw)


def _statements(run: dict, name: str) -> dict:
    """{query: (status, placement, reschedules)} of one stream: its
    per-query summaries (subprocess mode) or its journal (in process)."""
    d = run["dir"]
    if (d / f"{name}_queries.json").exists():
        entries = json.load(open(d / f"{name}_queries.json"))["queries"]
        return {q: (e["status"], e.get("placement"), e.get("reschedules"))
                for q, e in entries.items()}
    out = {}
    for f in os.listdir(d / f"{name}_json"):
        if not is_report_basename(f):
            continue  # the stream's query journal
        s = json.load(open(d / f"{name}_json" / f))
        out[s["query"]] = (s["queryStatus"][-1], s.get("placement"),
                           s.get("reschedules"))
    return out


@pytest.mark.parametrize("mode", ["subprocess", "in_process"])
def test_two_streams_complete_on_the_device_in_the_references_order(
        mode, data, runs, capsys):
    run = runs[mode]
    assert run["codes"] == [0] * STREAMS
    # a multiple of 0.1 s
    assert math.isclose(run["elapse"] * 10, round(run["elapse"] * 10))
    for sp in data["streams"]:
        name = os.path.splitext(os.path.basename(sp))[0]
        rows = [(q, ms) for _a, q, ms in TimeLog.read(
            str(run["dir"] / f"{name}_time.csv"))]
        order = [q for q, _ms in rows if q.startswith("query")]
        assert order == list(ref_h_streams.parse_query_stream(sp)), name
        ptt = dict(rows)["Power Test Time"]
        assert 0 < ptt <= run["elapse"] * 1000, name
        stmts = _statements(run, name)
        assert sorted(stmts) == sorted(order)
        for q, (status, placement, reschedules) in stmts.items():
            assert status == "Completed", (name, q)
            if not q.startswith(("query15_part1", "query15_part3")):
                assert (placement, reschedules) == ("device", 0), (name, q)
        # every result equals the oracle's (stream 0: the same
        # statements, the qualification parameters)
        with pytest.raises(SystemExit) as done:
            h_validate.main([data["oracle"], str(run["dir"] / "results" /
                                                 name), sp,
                             "--ignore_ordering"])
        out = capsys.readouterr().out
        assert done.value.code == 0, out
        assert out.count("-> MATCH ===") == 22, out


def test_in_process_summaries_have_the_reference_keys(data, runs, tmp_path,
                                                      monkeypatch):
    """The reference's ``run_streams_inprocess`` over the same streams
    (its NDS suite swapped for NDS-H; backend cpu): the port's per-stream
    summaries have its keys, less ``NOT_YET_PORTED``, and its statuses."""
    monkeypatch.setattr(ref_nds_power, "SUITE", ref_h_power.SUITE)
    _elapse, fails = ref_throughput.run_streams_inprocess(
        data["raw"], data["streams"], str(tmp_path), backend="cpu",
        input_format="raw")
    assert fails == [0] * STREAMS

    def summaries(d) -> dict:
        out = {}
        for f in os.listdir(d):
            if f.startswith("throughput-") and f.endswith(".json"):
                s = json.load(open(os.path.join(d, f)))
                out[s["query"]] = s
        return out
    ref, port = summaries(tmp_path), summaries(runs["in_process"]["dir"])
    assert sorted(port) == sorted(ref) == ["stream_1", "stream_2"]
    for name, exp in ref.items():
        got = port[name]
        assert set(got) == set(exp) - set(NOT_YET_PORTED), name
        assert set(got["env"]) == set(exp["env"]), name
        assert got["queryStatus"] == exp["queryStatus"], name
        assert got["retries"] == exp["retries"] == 0
        assert len(got["queryTimes"]) == len(exp["queryTimes"])


def test_power_cli_with_the_distributed_backend_on_one_gloo_rank(
        data, tmp_path, capsys):
    sp = data["streams"][0]
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    for k in ("NDS_TPU_COORDINATOR", "NDS_TPU_NUM_PROCESSES"):
        env.pop(k, None)
    jsons = tmp_path / "json"
    proc = subprocess.run(
        [sys.executable, "-m", "nds_tpu_torch.nds_h.power", data["raw"], sp,
         str(tmp_path / "t.csv"), "--input_format", "raw", "--backend",
         "distributed", "--device", "cpu", "--json_summary_folder",
         str(jsons), "--output_prefix", str(tmp_path / "dist")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    cpu_out = str(tmp_path / "cpu")
    assert power_core.run_query_stream(
        h_power.SUITE, data["raw"], sp, str(tmp_path / "cpu.csv"),
        config=EngineConfig(overrides={"engine.backend": "cpu"}),
        input_format="raw", output_prefix=cpu_out) == 0
    with pytest.raises(SystemExit) as done:
        h_validate.main([cpu_out, str(tmp_path / "dist"), sp,
                         "--ignore_ordering"])
    out = capsys.readouterr().out
    assert done.value.code == 0, out
    assert out.count("-> MATCH ===") == 22, out
    placed = set()
    for f in os.listdir(jsons):
        if not is_report_basename(f):
            continue  # the run's query journal
        assert "-cpu-distributed-" in f, f
        s = json.load(open(jsons / f))
        assert s["queryStatus"] == ["Completed"], f
        if "result_digest" in s:
            placed.add((s["placement"], s["reschedules"]))
    assert placed == {("sharded", 0)}


@pytest.mark.parametrize("flag", ["--stall_s", "--max_restarts"])
@pytest.mark.parametrize("cli", [throughput, h_throughput],
                         ids=["nds", "nds_h"])
def test_the_supervisor_flags_are_refused(cli, flag, capsys):
    """The supervisor's flags supervise subprocess streams: beside
    ``--in_process`` (one process) the CLIs refuse them."""
    with pytest.raises(SystemExit) as done:
        cli.main(["wh", "s.sql", "--in_process", flag, "5"])
    assert done.value.code == 2
    assert "nothing to supervise" in capsys.readouterr().err
