"""The port's execution pipeline (``nds_tpu_torch/engine/scheduler.py``)
against the JAX package's (``nds_tpu/engine/scheduler.py``), on the CPU.

- The size estimate (``analysis/plan_verify.estimate_plan``) of every
  NDS-H statement and an NDS subset equals the reference's on the same
  SQL, from the catalog alone and from the SF0.01 tables each package
  generates (bit-identical), with the columnar store off and, for NDS-H,
  under ``auto``.
- ``CostModel.choose`` gives the reference's (placement, reason) when
  both are given the reference's ("device", "chunked", "cpu") universe,
  over budgets and stream thresholds that take every route (fits,
  working set, stream bytes, HWM history); in the port's own universes
  it always returns the fast placement, which the pipeline takes
  without an estimate.
- The reference's ladder, promotion, consensus and surface cases
  (``tests/test_scheduler.py``) on the port with fake executors; where
  a reference walk passes through the chunked rung, the same scenario
  runs on both pipelines and the port's walk is the reference's less
  that rung.
- ``classify``/``is_oom`` on torch's out-of-memory error.
- ``multihost.gather_votes``, ``barrier`` and ``gather_floats`` and the
  pipeline's ``MultihostChannel`` on a world of three gloo ranks.
"""

import tests.torch_threads  # noqa: F401  (first: sizes torch's threads)

import json
import os
import pathlib
import socket
import subprocess
import sys

import pytest
import torch

from nds_tpu.analysis import plan_verify as ref_pv
from nds_tpu.datagen import tpcds as ref_tpcds
from nds_tpu.datagen import tpch as ref_tpch
from nds_tpu.engine import scheduler as ref_sched
from nds_tpu.engine.session import Session as RefSession
from nds_tpu.io.host_table import from_arrays as ref_from_arrays
from nds_tpu.nds import schema as ref_nds_schema
from nds_tpu.nds import streams as ref_nds_streams
from nds_tpu.nds_h import schema as ref_h_schema
from nds_tpu.nds_h import streams as ref_h_streams
from nds_tpu.resilience import faults as ref_faults
from nds_tpu.utils.config import EngineConfig as RefConfig
from nds_tpu_torch import columnar
from nds_tpu_torch.analysis import plan_verify
from nds_tpu_torch.datagen import tpcds, tpch
from nds_tpu_torch.engine import scheduler
from nds_tpu_torch.engine.scheduler import (
    CPU, DEVICE, SHARDED, Consensus, CostModel, ExecutionPipeline,
    NullChannel,
)
from nds_tpu_torch.engine.session import Session
from nds_tpu_torch.io.host_table import from_arrays
from nds_tpu_torch.nds import schema as nds_schema
from nds_tpu_torch.nds_h import schema as h_schema
from nds_tpu_torch.resilience import faults
from nds_tpu_torch.resilience.faults import InjectedOOM
from nds_tpu_torch.resilience.retry import (
    DETERMINISTIC, TRANSIENT, classify, is_oom,
)
from nds_tpu_torch.utils.config import EngineConfig

REPO = pathlib.Path(__file__).resolve().parent.parent
SF = 0.01
# NDS statements over joins, aggregates, windows, set operations, ROLLUP
# and scalar subplans
NDS_SUBSET = ["3", "7", "12", "14", "19", "42", "51", "77", "87", "96"]
REF_UNIVERSE = ("device", "chunked", "cpu")


# ----------------------------------------------------------- the plans

def _planned(ref_sess, sess, sql):
    """Each package's plan of ``sql``; a view's DDL runs on both
    sessions instead (None)."""
    exp = ref_sess.plan(sql)
    if isinstance(exp, tuple):
        ref_sess.sql(sql)
        sess.sql(sql)
        return None
    return exp, sess.plan(sql)


@pytest.fixture(scope="module")
def nds_h():
    """(reference session, port session, [(name, ref plan, port plan)])
    of the 22 NDS-H statements, each session over its own package's
    SF0.01 tables."""
    ref_sess, sess = RefSession.for_nds_h(), Session.for_nds_h()
    for t, schema in ref_h_schema.get_schemas().items():
        ref_sess.register_table(ref_from_arrays(t, schema,
                                                ref_tpch.gen_table(t, SF)))
    for t, schema in h_schema.get_schemas().items():
        sess.register_table(from_arrays(t, schema, tpch.gen_table(t, SF)))
    plans = []
    for qn in range(1, 23):
        for i, sql in enumerate(ref_h_streams.statements(qn)):
            got = _planned(ref_sess, sess, sql)
            if got is not None:
                plans.append((f"q{qn}.{i}", *got))
    return ref_sess, sess, plans


@pytest.fixture(scope="module")
def nds():
    """The same for the NDS subset, over the catalog and the subset's
    SF0.01 tables."""
    ref_sess, sess = RefSession.for_nds(), Session.for_nds()
    plans = []
    for tmpl in NDS_SUBSET:
        stmts = [x.strip() for x in
                 ref_nds_streams.render_query(int(tmpl)).split(";")
                 if x.strip()]
        for i, sql in enumerate(stmts):
            got = _planned(ref_sess, sess, sql)
            if got is not None:
                plans.append((f"q{tmpl}.{i}", *got))
    tables = {t for _n, p, _q in plans for t in _scanned(p)}
    ref_schemas, schemas = (ref_nds_schema.get_schemas(),
                            nds_schema.get_schemas())
    for t in sorted(tables):
        ref_sess.register_table(ref_from_arrays(
            t, ref_schemas[t], ref_tpcds.gen_table(t, SF)))
        sess.register_table(from_arrays(t, schemas[t],
                                        tpcds.gen_table(t, SF)))
    return ref_sess, sess, plans


def _scanned(planned) -> set:
    from nds_tpu.sql import plan as RP
    out = set()
    for root in [planned.root, *planned.scalar_subplans]:
        for node in RP.walk_plan(root):
            if isinstance(node, RP.Scan):
                out.add(node.table)
    return out


def _fields(est) -> dict:
    return {k: getattr(est, k) for k in (
        "rows", "bytes", "widest_table_bytes", "tables", "joins",
        "aggregates", "sorts", "windows")}


@pytest.fixture
def columnar_auto():
    """Both packages' columnar store under ``auto``, then back off."""
    from nds_tpu import columnar as ref_columnar
    ref_columnar.set_mode("auto")
    columnar.set_mode("auto")
    yield
    ref_columnar.set_mode(None)
    columnar.set_mode(None)


@pytest.mark.parametrize("suite", ["nds_h", "nds"])
def test_estimates_equal_the_reference(suite, request):
    ref_sess, sess, plans = request.getfixturevalue(suite)
    assert len(plans) >= (22 if suite == "nds_h" else 10)
    for name, exp_plan, got_plan in plans:
        for tables in (None, "registry"):
            exp = ref_pv.estimate_plan(
                exp_plan, tables=ref_sess.tables if tables else None,
                catalog=ref_sess.catalog)
            got = plan_verify.estimate_plan(
                got_plan, tables=sess.tables if tables else None,
                catalog=sess.catalog)
            assert _fields(got) == _fields(exp), (name, tables)
        assert got.rows > 0 and got.bytes > 0, name


def test_encoded_estimates_equal_the_reference(nds_h, columnar_auto):
    ref_sess, sess, plans = nds_h
    smaller = 0
    for name, exp_plan, got_plan in plans:
        got = {}
        for encoded in (None, False):
            exp = ref_pv.estimate_plan(exp_plan, tables=ref_sess.tables,
                                       encoded=encoded)
            got[encoded] = plan_verify.estimate_plan(
                got_plan, tables=sess.tables, encoded=encoded)
            assert _fields(got[encoded]) == _fields(exp), (name, encoded)
        smaller += got[None].bytes < got[False].bytes
    # the encoded widths are in play
    assert smaller >= 10


# ---------------------------------------------------------- cost model

BUDGETS = [1 << 16, 1 << 20, 1 << 22, 1 << 24, 1 << 30, 1 << 40]


@pytest.mark.parametrize("suite", ["nds_h", "nds"])
def test_cost_model_choices_equal_the_reference(suite, request):
    """Every route of ``choose`` over the reference's universe: fits,
    working set (budgets from 64 KiB up), the stream threshold, and the
    HWM history of a query that went past the budget."""
    ref_sess, sess, plans = request.getfixturevalue(suite)
    routes = set()
    for name, exp_plan, got_plan in plans:
        for budget in BUDGETS:
            for stream_bytes in (0, 1 << 12, 1 << 20):
                ref_cm = ref_sched.CostModel(device_budget=budget,
                                             stream_bytes=stream_bytes)
                cm = CostModel(device_budget=budget,
                               stream_bytes=stream_bytes)
                for hwm in (0, budget + 1):
                    ref_cm.observe(name, hwm)
                    cm.observe(name, hwm)
                    for tables in (None, "registry"):
                        exp = ref_cm.choose(
                            exp_plan, REF_UNIVERSE,
                            tables=ref_sess.tables if tables else None,
                            catalog=ref_sess.catalog, qname=name)
                        got = cm.choose(
                            got_plan, REF_UNIVERSE,
                            tables=sess.tables if tables else None,
                            catalog=sess.catalog, qname=name)
                        assert got == exp, (name, budget, stream_bytes,
                                            hwm, tables)
                        routes.add(got[1].split(":")[0])
                        # the port's own universes have no chunked rung
                        for universe in scheduler.UNIVERSES.values():
                            assert cm.choose(
                                got_plan, universe, catalog=sess.catalog,
                                qname=name)[0] == universe[0]
    assert routes == {"fits", "working-set", "table-exceeds-stream-bytes",
                      "hwm-history"}


def test_universes_are_the_references_less_chunked():
    assert scheduler.UNIVERSES["gpu"] == tuple(
        r for r in ref_sched.UNIVERSES["tpu"] if r != "chunked")
    for backend in ("distributed", "cpu"):
        assert scheduler.UNIVERSES[backend] == tuple(
            r for r in ref_sched.UNIVERSES[backend] if r != "chunked")


# ------------------------------------------------------- fake executors

class FakeExec:
    """Scripted placement executor (the reference test's): raises per
    the schedule, then succeeds; counts its calls."""

    def __init__(self, fails=(), result="ok"):
        self.fails = list(fails)
        self.result = result
        self.calls = 0
        self.chunk_rows = 1 << 20
        self.stream_bytes = 1 << 40
        self.last_timings = {"execute_ms": 1.0}

    def execute(self, planned, key=None):
        self.calls += 1
        if self.fails:
            raise self.fails.pop(0)
        return self.result


class FakeSharded(FakeExec):
    slack_grown = 0

    def grow_slack(self):
        self.slack_grown += 1


def _pipe(backend="gpu", overrides=None, execs=None):
    cfg = EngineConfig(overrides={
        "engine.backend": backend, "engine.device": "cpu",
        "engine.retry.base_delay_s": "0", **(overrides or {})})
    pipe = ExecutionPipeline(backend=backend, config=cfg)
    pipe({})
    pipe._executors.update(execs or {})
    return pipe


_REF_BACKEND = {"gpu": "tpu", "distributed": "distributed", "cpu": "cpu"}


def _ref_pipe(backend="gpu", overrides=None, execs=None):
    cfg = RefConfig(overrides={
        "engine.backend": _REF_BACKEND[backend],
        "engine.retry.base_delay_s": "0", **(overrides or {})})
    pipe = ref_sched.ExecutionPipeline(backend=_REF_BACKEND[backend],
                                       config=cfg)
    pipe({})
    pipe._executors.update(execs or {})
    return pipe


def _oom(port=True):
    cls = InjectedOOM if port else ref_faults.InjectedOOM
    return cls("device.execute", "RESOURCE_EXHAUSTED: test oom")


def _plan(sql="select count(*) c from reason"):
    return Session.for_nds().plan(sql)


def _ref_plan(sql="select count(*) c from reason"):
    return RefSession.for_nds().plan(sql)


def _less_chunked(walk):
    return [r for r in walk if r != "chunked"]


# ----------------------------------------------------------- the ladder

def test_rungs_for_each_start():
    pipe = _pipe()
    ref = _ref_pipe()
    for start in (DEVICE, CPU):
        assert pipe.rungs_for(start) == _less_chunked(ref.rungs_for(start))
    dist = _pipe("distributed")
    assert dist.rungs_for(SHARDED) == _less_chunked(
        _ref_pipe("distributed").rungs_for(SHARDED)) == [SHARDED, CPU]
    assert _pipe("cpu").rungs_for(CPU) == [CPU]


def test_floor_and_fallback_alias():
    # a floor the universe lacks falls to its last rung
    assert _pipe(overrides={"engine.placement.floor": "chunked"}
                 ).rungs_for(DEVICE) == [DEVICE, CPU]
    assert _pipe(overrides={"engine.placement.floor": "device"}
                 ).rungs_for(DEVICE) == [DEVICE]
    pipe = _pipe(overrides={"engine.placement.floor": "device",
                            "engine.fallback": "cpu"})
    assert pipe.rungs_for(DEVICE) == [DEVICE, CPU]


def test_ladder_off_is_single_rung():
    pipe = _pipe(overrides={"engine.placement.ladder": "off"})
    assert pipe.rungs_for(DEVICE) == [DEVICE]


def test_oom_walks_the_ladder_as_the_reference_less_chunked():
    ref = _ref_pipe(execs={"device": FakeExec([_oom(False)]),
                           "chunked": FakeExec([_oom(False)]),
                           "cpu": FakeExec()})
    assert ref.execute(_ref_plan()) == "ok"
    dev, cpu = FakeExec([_oom()]), FakeExec()
    pipe = _pipe(execs={DEVICE: dev, CPU: cpu})
    assert pipe.execute(_plan()) == "ok"
    assert (dev.calls, cpu.calls) == (1, 1)
    assert pipe.last_schedule["ladder"] == _less_chunked(
        ref.last_schedule["ladder"]) == [DEVICE, CPU]
    assert pipe.last_schedule["reschedules"] == 1
    assert pipe.last_schedule["placement"] == ref.last_schedule[
        "placement"] == CPU
    assert pipe.last_stats.retries == ref.last_stats.retries == 0


def test_torch_out_of_memory_walks_to_the_cpu():
    oom = torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 20.00 GiB")
    dev, cpu = FakeExec([oom]), FakeExec()
    pipe = _pipe(execs={DEVICE: dev, CPU: cpu})
    assert pipe.execute(_plan()) == "ok"
    assert pipe.last_schedule["ladder"] == [DEVICE, CPU]
    assert pipe.last_stats.errors == [f"OutOfMemoryError: {oom}"]


def test_generic_transient_retries_same_rung():
    dev = FakeExec([faults.InjectedTransientFault("device.execute",
                                                  "flaky")])
    pipe = _pipe(execs={DEVICE: dev})
    assert pipe.execute(_plan()) == "ok"
    assert dev.calls == 2
    assert pipe.last_stats.retries == 1
    assert pipe.last_schedule["reschedules"] == 0


def test_retry_backoff_is_the_references():
    """Two transient failures at the default base delay: the same
    retries and backoff seconds (seeded jitter) as the reference."""
    cfg = {"engine.retry.base_delay_s": "0.001"}
    pipe = _pipe(overrides=cfg, execs={DEVICE: FakeExec([
        faults.InjectedTransientFault("device.execute", "x")] * 2)})
    ref = _ref_pipe(overrides=cfg, execs={"device": FakeExec([
        ref_faults.InjectedTransientFault("device.execute", "x")] * 2)})
    assert pipe.execute(_plan()) == ref.execute(_ref_plan()) == "ok"
    assert pipe.last_stats.retries == ref.last_stats.retries == 2
    assert pipe.last_stats.backoff_s == ref.last_stats.backoff_s > 0


def test_deterministic_never_walks():
    err = faults.InjectedDeterministicFault("device.execute", "bug")
    dev, cpu = FakeExec([err]), FakeExec()
    pipe = _pipe(execs={DEVICE: dev, CPU: cpu})
    with pytest.raises(faults.InjectedDeterministicFault):
        pipe.execute(_plan())
    assert cpu.calls == 0
    assert pipe.last_stats.gave_up_reason == "deterministic"


def test_oom_at_floor_exhausts_attempts():
    cpu = FakeExec([_oom()] * 4)
    pipe = _pipe("cpu", execs={CPU: cpu})
    with pytest.raises(InjectedOOM):
        pipe.execute(_plan())
    assert cpu.calls == 3
    assert pipe.last_stats.gave_up_reason == "attempts_exhausted(3)"


def test_sharded_overflow_replans_with_grown_slack():
    from nds_tpu_torch.engine.device_exec import DeviceExecError
    sh = FakeSharded([DeviceExecError("exchange overflow persisted")])
    pipe = _pipe("distributed", execs={SHARDED: sh})
    assert pipe.execute(_plan()) == "ok"
    assert sh.slack_grown == 1 and sh.calls == 2
    assert pipe.last_schedule["ladder"] == [SHARDED,
                                            scheduler.SHARDED_REPLAN]
    assert pipe.last_schedule["placement"] == SHARDED


def test_sharded_overflow_persisting_walks_as_the_reference_less_chunked():
    from nds_tpu.engine.device_exec import DeviceExecError as RefError
    from nds_tpu_torch.engine.device_exec import DeviceExecError

    class RefSharded(FakeExec):
        def grow_slack(self):
            pass

    ref = _ref_pipe("distributed", execs={
        "sharded": RefSharded([RefError("exchange overflow persisted")] * 2),
        "chunked": FakeExec([_oom(False)]), "cpu": FakeExec()})
    assert ref.execute(_ref_plan()) == "ok"
    sh, cpu = FakeSharded([DeviceExecError("exchange overflow")] * 2), \
        FakeExec()
    pipe = _pipe("distributed", execs={SHARDED: sh, CPU: cpu})
    assert pipe.execute(_plan()) == "ok"
    assert cpu.calls == 1
    assert pipe.last_schedule["ladder"] == _less_chunked(
        ref.last_schedule["ladder"]) == [SHARDED, scheduler.SHARDED_REPLAN,
                                         CPU]
    assert pipe.last_schedule["placement"] == CPU


# ------------------------------------------- demotion / promotion cycle

def _walk_once(pipe, planned, oom, chunked_oom=None):
    """One query that runs the device out of memory (and, on the
    reference, its chunked rung too), so that it ends on the CPU."""
    pipe._executors["device"] = FakeExec([oom])
    if chunked_oom is not None:
        pipe._executors["chunked"] = FakeExec([chunked_oom])
    pipe._executors.setdefault("cpu", FakeExec())
    pipe.execute(planned)


def test_demotes_after_streak_and_promotes_as_the_reference():
    """The reference's cycle with its chunked rung failing too, so both
    ladders end on the CPU: two walked queries demote the start to cpu,
    two clean ones there promote it back, and the next query records
    ``promoted_back`` and starts on the device, on both pipelines."""
    cfg = {"engine.placement.demote_after": "2",
           "engine.placement.promote_after": "2"}
    pipe, ref = _pipe(overrides=cfg), _ref_pipe(overrides=cfg)
    planned, ref_planned = _plan(), _ref_plan()
    seen = {"port": [], "ref": []}
    for step in range(5):
        for who, p, pl, oom in (("port", pipe, planned, _oom()),
                                ("ref", ref, ref_planned, _oom(False))):
            if step < 2:
                _walk_once(p, pl, oom,
                           None if who == "port" else _oom(False))
            else:
                p._executors["device"] = FakeExec()
                p.execute(pl)
            # the reference's cost model says why the fast placement
            # fits; the port takes it without an estimate
            reason = p.last_schedule.get("reason")
            if who == "ref" and reason.startswith("fits:"):
                reason = "fast"
            seen[who].append((p._demoted_to, p.last_schedule["initial"],
                              reason,
                              p.last_schedule.get("promoted_back"),
                              _less_chunked(p.last_schedule["ladder"])))
    assert seen["port"] == seen["ref"]
    assert [s[0] for s in seen["port"]] == [None, CPU, CPU, None, None]
    assert seen["port"][4][3] is True and seen["port"][4][1] == DEVICE


def test_a_failed_query_counts_toward_the_demotion():
    pipe = _pipe(overrides={"engine.placement.demote_after": "1"},
                 execs={DEVICE: FakeExec([_oom()]),
                        CPU: FakeExec([faults.InjectedDeterministicFault(
                            "device.execute", "bug")])})
    with pytest.raises(faults.InjectedDeterministicFault):
        pipe.execute(_plan())
    assert pipe._demoted_to is None  # deterministic: no walk counted
    pipe._executors[DEVICE] = FakeExec([_oom()] * 3)
    pipe._executors[CPU] = FakeExec([_oom()] * 3)
    with pytest.raises(InjectedOOM):
        pipe.execute(_plan())
    assert pipe._demoted_to == CPU


# ------------------------------------------------------------- consensus

class SimChannel:
    """Simulated multi-rank vote transport: scripted peer votes, or a
    lagging rank that never reports."""

    def __init__(self, peers, world=None, lagging=False):
        self.peers = peers
        self.world = world if world is not None else len(peers) + 1
        self.lagging = lagging
        self.gathers = 0

    def gather(self, vote):
        self.gathers += 1
        if self.lagging:
            return None
        return [vote] + list(self.peers)


def test_consensus_rules():
    assert Consensus(SimChannel([2, 2])).decide(2) == 2
    assert Consensus(SimChannel([0, 0])).decide(2) == 2
    assert Consensus(SimChannel([2, 1])).decide(0) == 2
    ch = SimChannel([], world=3, lagging=True)
    assert Consensus(ch).decide(1) is None and ch.gathers == 1
    assert Consensus(SimChannel([1], world=3)).decide(1) is None
    assert Consensus(NullChannel()).decide(1) == 1


def test_multi_rank_world_has_no_mid_query_ladder():
    dev, cpu = FakeExec([_oom()] * 3), FakeExec()
    pipe = _pipe(execs={DEVICE: dev, CPU: cpu})
    pipe.consensus = Consensus(SimChannel([], world=3, lagging=True))
    with pytest.raises(InjectedOOM):
        pipe.execute(_plan())
    assert pipe.last_schedule["reschedules"] == 0
    assert pipe.last_stats.gave_up_reason == "attempts_exhausted(3)"
    assert cpu.calls == 0
    assert pipe._demoted_to is None


def test_multi_rank_boundary_vote_demotes_as_the_reference():
    """A peer votes for the floor (the reference's rung 2, the port's
    rung 1: the CPU on both): the failed query demotes every rank's
    start to the CPU, where the next query runs."""
    cfg = {"engine.placement.demote_after": "1"}
    ref = _ref_pipe(overrides=cfg, execs={
        "device": FakeExec([_oom(False)] * 3), "chunked": FakeExec(),
        "cpu": FakeExec()})
    ref.consensus = ref_sched.Consensus(SimChannel([2]))
    pipe = _pipe(overrides=cfg, execs={DEVICE: FakeExec([_oom()] * 3),
                                       CPU: FakeExec()})
    pipe.consensus = Consensus(SimChannel([1]))
    with pytest.raises(ref_faults.InjectedOOM):
        ref.execute(_ref_plan())
    with pytest.raises(InjectedOOM):
        pipe.execute(_plan())
    assert pipe._demoted_to == ref._demoted_to == CPU
    pipe.execute(_plan())
    ref.execute(_ref_plan())
    assert pipe.last_schedule["placement"] == ref.last_schedule[
        "placement"] == CPU
    assert pipe._executors[CPU].calls == 1


def test_multi_rank_peer_vote_can_demote_a_healthy_rank():
    pipe = _pipe(execs={DEVICE: FakeExec(), CPU: FakeExec()})
    pipe.consensus = Consensus(SimChannel([1]))
    pipe.execute(_plan())
    assert pipe._demoted_to == CPU


def test_multi_rank_boundary_promotion_requires_unanimity():
    pipe = _pipe(overrides={"engine.placement.demote_after": "1",
                            "engine.placement.promote_after": "1"},
                 execs={DEVICE: FakeExec([_oom()] * 3), CPU: FakeExec()})
    pipe.consensus = Consensus(SimChannel([1]))
    with pytest.raises(InjectedOOM):
        pipe.execute(_plan())
    assert pipe._demoted_to == CPU
    pipe.execute(_plan())
    assert pipe._demoted_to == CPU
    pipe.consensus = Consensus(SimChannel([0]))
    pipe.execute(_plan())
    assert pipe._demoted_to is None
    pipe._executors[DEVICE] = FakeExec()
    pipe.execute(_plan())
    assert pipe.last_schedule.get("promoted_back") is True
    assert pipe.last_schedule["placement"] == DEVICE


# ----------------------------------------------------- pipeline surface

def test_reset_query_clears_stale_state():
    pipe = _pipe(execs={DEVICE: FakeExec()})
    pipe.execute(_plan())
    assert pipe.last_schedule
    pipe.reset_query()
    assert pipe.last_stats.retries == 0
    assert pipe.last_schedule == {}
    assert pipe.last_timings == {}


def test_adopts_executor_timings():
    dev = FakeExec()
    dev.last_timings = {"execute_ms": 42.0}
    pipe = _pipe(execs={DEVICE: dev})
    pipe.execute(_plan())
    assert pipe.last_timings["execute_ms"] == 42.0


def test_rebinding_tables_drops_executors_and_invalidate_keeps_history():
    pipe = _pipe(execs={DEVICE: FakeExec()})
    pipe({"t": object()})
    assert pipe._executors == {}
    pipe._executors[DEVICE] = FakeExec()
    pipe._demoted_to, pipe._reschedule_streak = CPU, 2
    pipe.invalidate()
    assert pipe._executors == {}
    assert (pipe._demoted_to, pipe._reschedule_streak) == (CPU, 2)


def test_forced_placement_wins_and_a_pin_outside_the_universe_raises():
    cpu = FakeExec()
    pipe = _pipe(overrides={"engine.placement.force": "cpu"},
                 execs={CPU: cpu, DEVICE: FakeExec()})
    pipe.execute(_plan())
    assert cpu.calls == 1
    assert pipe.last_schedule["reason"] == "forced"
    for pin in ("chunked", "sharded"):
        with pytest.raises(ValueError, match="placement universe"):
            _pipe(overrides={"engine.placement.force": pin})


def test_query_name_threads_from_faults_context():
    pipe = _pipe(execs={DEVICE: FakeExec([_oom()]), CPU: FakeExec()})
    with faults.context(query="query42"):
        assert faults.current_context()["query"] == "query42"
        pipe.execute(_plan())
    assert faults.current_context() == {}
    assert pipe.last_schedule["reschedules"] == 1
    assert pipe.last_schedule["ladder"] == [DEVICE, CPU]


def test_async_handles_keep_their_own_accounting():
    """An executor without ``execute_async`` runs synchronously inside
    ``execute_async``: each completed handle re-points the pipeline's
    surface at its own query's stats and schedule."""
    pipe = _pipe(execs={DEVICE: FakeExec([_oom()]), CPU: FakeExec()})
    h1 = pipe.execute_async(_plan())
    pipe._executors[DEVICE] = FakeExec()
    h2 = pipe.execute_async(_plan())
    assert h1.result() == "ok"
    assert pipe.last_schedule["ladder"] == [DEVICE, CPU]
    assert h2.result() == "ok"
    assert pipe.last_schedule["ladder"] == [DEVICE]


def test_precision_and_backend_refusals():
    with pytest.raises(ValueError, match="not ported"):
        ExecutionPipeline(backend="gpu", precision="f32")
    with pytest.raises(ValueError, match="unknown engine.precision"):
        ExecutionPipeline(backend="gpu", precision="f16")
    for backend in ("tpu", "chunked"):
        with pytest.raises(ValueError, match="'gpu'"):
            scheduler.make_pipeline(EngineConfig(overrides={
                "engine.backend": backend}))


# ------------------------------------------------ initial placement

@pytest.mark.parametrize("backend", ["gpu", "distributed", "cpu"])
def test_initial_placement_is_the_fast_one_without_an_estimate(
        backend, monkeypatch):
    """No universe of the port has a chunked rung, so the reference's
    cost model would return the fast placement whatever the plan's size:
    the pipeline takes it without estimating the plan, as the reference
    does on such a universe, and records ``fast``."""
    def no_estimate(*_a, **_k):
        raise AssertionError("the pipeline estimated a plan")
    monkeypatch.setattr(plan_verify, "estimate_plan", no_estimate)
    fast = scheduler.UNIVERSES[backend][0]
    ex = FakeSharded() if fast == SHARDED else FakeExec()
    pipe = _pipe(backend, execs={fast: ex})
    pipe._tables["reason"] = type("T", (), {"nrows": 1 << 40})()
    pipe.execute(_plan())
    assert ex.calls == 1
    assert pipe.last_schedule["initial"] == fast
    assert pipe.last_schedule["reason"] == "fast"
    # the reference starts a plan that fits its budget at the same rung
    ref = _ref_pipe(backend, execs={fast: FakeExec()})
    ref.execute(_ref_plan())
    assert ref.last_schedule["initial"] == fast


# ------------------------------------------------- failure classes

def test_torch_out_of_memory_classifies_transient():
    oom = torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total "
        "capacity of 79.10 GiB of which 1.06 GiB is free.")
    assert classify(oom) == TRANSIENT and is_oom(oom)
    assert classify(RuntimeError("exchange overflow persisted")) == TRANSIENT
    assert not is_oom(RuntimeError("exchange overflow persisted"))
    assert classify(ValueError("no such column")) == DETERMINISTIC
    from nds_tpu.resilience import retry as ref_retry
    for exc in (oom, RuntimeError("RESOURCE_EXHAUSTED: x"),
                ValueError("no such column")):
        assert (classify(exc), is_oom(exc)) == (ref_retry.classify(exc),
                                                ref_retry.is_oom(exc))


# ---------------------------------------------------- a gloo world

_RANK = r"""
import json, os, sys
import torch.distributed as dist
from nds_tpu_torch.engine.scheduler import Consensus, MultihostChannel
from nds_tpu_torch.parallel import multihost
rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                          sys.argv[3], sys.argv[4])
one = (multihost.gather_votes(5), multihost.barrier("before"),
       multihost.gather_floats(0.5))
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank)
res = {"one": one,
       "votes": multihost.gather_votes(rank * 10),
       "barrier": multihost.barrier("middle"),
       "floats": multihost.gather_floats(rank + 0.25),
       "consensus": Consensus(MultihostChannel()).decide(rank),
       "world": MultihostChannel().world}
dist.destroy_process_group()
json.dump(res, open(out, "w"))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_multihost_gathers_on_a_gloo_world(tmp_path):
    world, port = 3, _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(world), str(port),
         str(tmp_path / f"r{r}.json")], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    for r in range(world):
        res = json.load(open(tmp_path / f"r{r}.json"))
        # before the world: a world of one, trivially
        assert res["one"] == [[5], True, [0.5]]
        assert res["votes"] == [0, 10, 20]
        assert res["barrier"] is True
        assert res["floats"] == [0.25, 1.25, 2.25]
        assert res["consensus"] == world - 1  # the deepest vote wins
        assert res["world"] == world
