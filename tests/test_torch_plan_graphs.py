"""The port's graph per plan (``nds_tpu_torch/engine/plan_graph.py``) on the CPU.

On the card the executor runs a plan's first call eagerly, captures the
same launches into one ``torch.cuda.CUDAGraph`` and replays it on every
later call. No graph can be captured here, so these tests give a CPU
executor a ``PlanGraphs`` runner whose graph class is a stand-in defined
below: its "capture" is the eager run of the captured function (whose
outputs then serve as the static outputs) and its replay writes nothing.
A replay therefore returns what the capture computed, and a graph that an
invalidation should have dropped returns stale rows. What the runner
keeps beside each graph (host-side results, epoch and launch counts,
pins, the buffers it reads) is the same as on the card.

The NDS-H tables are ``tpch.gen_table`` at SF0.01, bit-identical in both
packages. Rows are held to the JAX ``DeviceExecutor`` on jax CPU (or, for
tables changed under the graphs, to the port's CPU oracle) under
``tests/test_device_engine.py::assert_frames_close``, and the kernel
blocks must be equal.
"""

import tests.torch_threads  # noqa: F401  (first: sizes torch's threads)

import numpy as np
import pytest
import torch

from nds_tpu import cache as ref_plan_cache
from nds_tpu.datagen import tpch as ref_tpch
from nds_tpu.engine.device_exec import make_device_factory as ref_factory
from nds_tpu.engine.session import Session as RefSession
from nds_tpu.io.host_table import from_arrays as ref_from_arrays
from nds_tpu.nds_h.schema import get_schemas as ref_schemas
from nds_tpu_torch.engine import device_exec as dx
from nds_tpu_torch.engine import kernels as KX
from nds_tpu_torch.engine.plan_graph import CaptureError, PlanGraphs
from nds_tpu_torch.engine.session import Session
from nds_tpu_torch.io.host_table import (
    HostColumn, HostTable, from_arrays, from_reference,
)
from nds_tpu_torch.nds_h import streams
from nds_tpu_torch.nds_h.schema import get_schemas
from nds_tpu_torch.parallel.dist_exec import DistributedExecutor

from tests.test_device_engine import assert_frames_close

SF = 0.01


class StandInGraph:
    """``torch.cuda.CUDAGraph``'s interface, for the CPU: nothing is
    recorded, so a replay leaves the static outputs as the capture left
    them."""

    def __init__(self):
        self.state = "new"
        self.replays = 0

    def capture_begin(self, pool=None, capture_error_mode="global"):
        assert self.state == "new" and pool is not None
        self.state = "capturing"

    def capture_end(self):
        assert self.state == "capturing"
        self.state = "captured"

    def replay(self):
        assert self.state == "captured"
        self.replays += 1


def graphed(session) -> dx.DeviceExecutor:
    """The session's CPU executor, given a runner on the stand-in."""
    ex = session._executor_factory(session.tables)
    ex._graphs = PlanGraphs(ex.device, graph_cls=StandInGraph,
                            new_pool=lambda: ("pool",), stream=None)
    return ex


@pytest.fixture(scope="module")
def arrays():
    return {t: ref_tpch.gen_table(t, SF) for t in ref_schemas()}


@pytest.fixture(scope="module")
def ref(arrays):
    schemas = ref_schemas()
    sess = RefSession.for_nds_h(ref_factory())
    for t in schemas:
        sess.register_table(ref_from_arrays(t, schemas[t], arrays[t]))
    return sess


def make_session(arrays):
    schemas = get_schemas()
    sess = Session.for_nds_h(dx.make_device_factory(device="cpu"))
    for t in schemas:
        sess.register_table(from_arrays(t, schemas[t], arrays[t]))
    return sess


@pytest.fixture
def port(arrays):
    return make_session(arrays)


def run(session, qn):
    result = None
    for s in streams.statements(qn):
        r = session.sql(s)
        if r is not None:
            result = r
    return result


def timings(session) -> dict:
    return dict(session._executor_factory(session.tables).last_timings)


def oracle(arrays, qn, tables=None):
    """The port's CPU oracle on the same tables (``tables``: name ->
    HostTable replacing the generated one)."""
    sess = Session.for_nds_h()
    schemas = get_schemas()
    for t in schemas:
        sess.register_table((tables or {}).get(t) or from_arrays(
            t, schemas[t], arrays[t]))
    return run(sess, qn)


def half_table(arrays, name: str):
    """Table ``name`` with only the first half of its rows."""
    n = len(next(iter(arrays[name].values())))
    return from_arrays(name, get_schemas()[name],
                       {c: a[:n // 2] for c, a in arrays[name].items()})


def reading(ex, prefix: str) -> set:
    return {k for k, g in ex._graphs.graphs.items()
            if any(r.startswith(prefix) for r in g.reads)}


@pytest.mark.parametrize("qn", [1, 3, 18, 21])
def test_runs_from_a_graph_match_the_jax_engine(qn, ref, port):
    """Three runs of a query: the first eager then captured, the others
    replays; each run's rows and kernel block equal the JAX engine's, and
    ``compile_ms`` is above 0 on the first call and 0 after, as the
    reference's is."""
    ex = graphed(port)
    ref_ex = ref._executor_factory(ref.tables)
    for i in range(3):
        exp = run(ref, qn)
        exp_t = dict(ref_ex.last_timings)
        got = run(port, qn)
        got_t = timings(port)
        assert_frames_close(got.to_pandas(), exp.to_pandas(), qn)
        assert (got_t.get("__kernels") or {}) == (
            exp_t.get("__kernels") or {})
        assert set(got_t) >= {"compile_ms", "execute_ms", "materialize_ms",
                              "bytes_scanned", "slack_retries"}
        if i == 0:
            assert got_t["compile_ms"] > 0
            if ref_plan_cache.active() is None:
                assert exp_t["compile_ms"] > 0
        else:
            assert got_t["compile_ms"] == 0 == exp_t["compile_ms"]
        assert ex._graphs.captures == 1 and ex._graphs.replays == i
    (g,) = ex._graphs.graphs.values()
    assert g.graph.replays == 2
    assert g.side["kernels"] == got_t["__kernels"] == timings(port)[
        "__kernels"]


@pytest.mark.parametrize("qn", [2, 21])
def test_staged_subplans_each_keep_a_graph(qn, ref, port):
    """A staged statement (cut at a weight of 8): each sub-plan and the
    main plan have a graph of their own; replays give the reference's rows
    while the temps' content is unchanged, and the statement's
    ``compile_ms`` sums the sub-plans'."""
    ex = graphed(port)
    ex.STAGE_WEIGHT = 8
    exp = run(ref, qn)
    for i in range(3):
        got = run(port, qn)
        assert_frames_close(got.to_pandas(), exp.to_pandas(), qn)
        t = timings(port)
        assert t["staged_programs"] >= 1
        assert (t["compile_ms"] > 0) == (i == 0)
    subs = [k for k in ex._graphs.graphs if ex._is_stage_key(k)]
    assert len(subs) == t["staged_programs"]
    assert len(ex._graphs.graphs) == len(subs) + 1
    assert ex._graphs.captures == len(ex._graphs.graphs)
    assert ex._graphs.replays == 2 * ex._graphs.captures


def test_a_staged_temp_whose_content_changes_drops_the_main_graph(
        arrays, port):
    """``_register_staged`` with other content frees the temp's buffers:
    the graphs that read them (the main plan's) go, the sub-plans' stay;
    the next run registers the real result again and captures anew."""
    ex = graphed(port)
    ex.STAGE_WEIGHT = 8
    exp = run(port, 21)
    temp = next(t for _o, split, _m in ex._stage_plans.values()
                for _s, t in split)
    table = ex.tables[temp]
    readers = reading(ex, temp + ".")
    assert readers and all(not ex._is_stage_key(k) for k in readers)
    before = set(ex._graphs.graphs)
    k = max(table.nrows // 2, 1)
    changed = HostTable(temp, table.schema, {
        c: HostColumn(col.dtype, col.values[:k], col.dictionary,
                      None if col.null_mask is None else col.null_mask[:k])
        for c, col in table.columns.items()})
    ex._register_staged(temp, changed)
    assert set(ex._graphs.graphs) == before - readers
    got = run(port, 21)
    assert_frames_close(got.to_pandas(), exp.to_pandas(), 21)
    assert set(ex._graphs.graphs) == before


def test_registering_a_table_again_drops_the_graphs_that_read_it(
        arrays, port):
    """A table registered again between replays: the next run that scans
    it drops the table's device state and exactly the graphs that read
    it, the others replay, and every run gives the oracle's rows on the
    new content."""
    ex = graphed(port)
    keys = {}
    for qn in (1, 3, 18):
        run(port, qn)
        keys[qn] = next(k for k in ex._graphs.graphs if k not in
                        keys.values())
    before = dict(ex._graphs.graphs)
    readers = reading(ex, "customer.")
    assert readers == {keys[3], keys[18]}
    half = half_table(arrays, "customer")
    port.register_table(half)
    for qn in (1, 3, 18):
        got = run(port, qn)
        exp = oracle(arrays, qn, {"customer": half})
        assert_frames_close(got.to_pandas(), exp.to_pandas(), qn)
        if qn == 3:
            # q3's walk found customer registered again
            assert keys[18] not in ex._graphs.graphs
            assert ex._graphs.graphs[keys[1]] is before[keys[1]]
            assert ex._graphs.graphs[keys[3]] is not before[keys[3]]
    assert ex._graphs.captures == 5 and ex._graphs.replays == 1


def test_scan_view_eviction_drops_the_graphs_that_read_the_view(port):
    """A survivor-reduced view evicted by the view bound frees its
    buffers: exactly the graphs that read them go."""
    ex = graphed(port)
    exp = {qn: run(port, qn) for qn in (6, 14)}
    views = [v for v in ex._scan_views.values()
             if isinstance(v, dx._ReducedScan)]
    assert len(views) == 2
    readers = reading(ex, views[0].prefix + ".")
    assert len(readers) == 1
    before = set(ex._graphs.graphs)
    ex.MAX_SCAN_VIEWS = len(ex._scan_views)
    run(port, 12)    # a new view signature evicts the oldest view
    assert views[0] not in ex._scan_views.values()
    assert before - set(ex._graphs.graphs) == readers
    for qn in (6, 14):
        got = run(port, qn)
        assert_frames_close(got.to_pandas(), exp[qn].to_pandas(), qn)


def test_memo_eviction_keeps_the_graph_and_its_pins(port):
    """The dictionary-table memo's FIFO evicting a table that a graph
    reads frees nothing the graph needs: the graph stays and its pins
    hold the table."""
    ex = graphed(port)
    exp = run(port, 9)       # p_name LIKE '%green%': one table
    (key9,) = ex._graphs.graphs
    held = list(ex._dict_tables.values())
    assert len(held) == 1
    ex.DICT_TABLES_MAX = 2
    run(port, 2)             # two tables of its own: evicts q9's
    assert not any(v is held[0] for v in ex._dict_tables.values())
    g = ex._graphs.graphs[key9]
    assert any(p is held[0][1] for p in g.pins)
    got = run(port, 9)
    assert_frames_close(got.to_pandas(), exp.to_pandas(), 9)
    assert ex._graphs.graphs[key9] is g and g.graph.replays == 1


def test_evicting_a_plan_entry_drops_its_graph(port):
    """``_bound_entries``/``_evict_query_state``: the plan entries past
    ``MAX_ENTRIES`` go with their graphs, the others keep theirs."""
    ex = graphed(port)
    ex.MAX_ENTRIES = 2
    run(port, 1)
    (first,) = ex._graphs.graphs
    run(port, 6)
    run(port, 14)
    assert first not in ex._entries and first not in ex._graphs.graphs
    assert set(ex._graphs.graphs) == set(ex._entries)


@pytest.mark.parametrize("cache", ["dict_table", "scan_view",
                                   "scan_buffers"])
def test_a_cache_fill_during_a_capture_raises(cache, port, monkeypatch):
    """A memo, scan-view or buffer miss while a plan is captured raises,
    naming the plan and the cache: the capture fails, it is not run
    eagerly instead."""
    ex = graphed(port)
    # every filtered scan consults the view cache
    ex.REDUCE_MIN_ROWS = 1
    store = {"dict_table": ex._dict_tables, "scan_view": ex._scan_views,
             "scan_buffers": ex._buffers}[cache]
    capture = PlanGraphs.capture

    def emptied(self, *args, **kwargs):
        store.clear()
        return capture(self, *args, **kwargs)
    monkeypatch.setattr(PlanGraphs, "capture", emptied)
    with pytest.raises(CaptureError, match=rf"{cache}.*plan [0-9a-f]{{12}} "
                       r"\(tables .*part"):
        run(port, 9)
    assert not ex._graphs.graphs and ex._graphs.barring is None
    assert not KX.capturing()


def test_uploads_and_lookback_state_raise_inside_a_capture(port,
                                                           monkeypatch):
    """The other fills a capture must not make: an upload of the trace
    (``_host``), a look-back buffer, a kernel library's load."""
    ex = graphed(port)
    monkeypatch.setattr(KX, "_LOOKBACK", {})
    tr = ex._trace(2.0)
    dev = torch.device("cpu")

    def fills():
        with pytest.raises(dx.DeviceExecError, match=r"_host.*plan x"):
            tr._host(np.arange(3))
        with pytest.raises(RuntimeError, match="capture"):
            KX._lookback(dev, 0, "scan", 64)
        with pytest.raises(RuntimeError, match="capture"):
            KX._lib("seg_scan")
        return ()
    ex._graphs.capture("k", None, "plan x", KX.lookback_epochs(), {}, fills)
    assert not KX.capturing() and ex._graphs.barring is None
    assert tr._host(np.arange(3)).tolist() == [0, 1, 2]


def test_replays_count_epochs_and_launches(port, monkeypatch):
    """A replay adds its capture's launches and look-back epochs to the
    host's counts (the capture's own calls are taken back), and resets
    the look-back buffers in place first where its epochs would pass
    ``_EPOCH_HOST``."""
    monkeypatch.setattr(KX, "_LOOKBACK", {})
    monkeypatch.setattr(KX, "_DRAWN", {})
    dev = torch.device("cpu")
    key = (dev, 0, "scan")
    plain = KX.seg_reduce_at_ends

    def counted(*args):
        # what the kernel's launch does on the card, for the counts
        KX.LAUNCHES["seg_reduce_at_ends"] += 1
        KX._lookback(dev, 0, "scan", 64, 2)
        return plain(*args)
    monkeypatch.setattr(KX, "seg_reduce_at_ends", counted)
    ex = graphed(port)
    KX.reset_launches()
    exp = run(port, 1)
    n = KX.LAUNCHES["seg_reduce_at_ends"]
    assert n > 0 and KX._DRAWN[key] == 2 * n == KX._LOOKBACK[key][2]
    (g,) = ex._graphs.graphs.values()
    assert g.launches == {"seg_reduce_at_ends": n}
    assert g.epochs == {key: 2 * n}
    for i in (2, 3):
        got = run(port, 1)
        assert_frames_close(got.to_pandas(), exp.to_pandas(), 1)
        assert KX.LAUNCHES["seg_reduce_at_ends"] == i * n
        assert KX._DRAWN[key] == 2 * i * n == KX._LOOKBACK[key][2]
    buf, ctr, _used, retired = KX._LOOKBACK[key]
    KX._LOOKBACK[key] = (buf, ctr, KX._EPOCH_HOST - 1, retired)
    buf.fill_(7)
    ctr.fill_(9 << 32)
    run(port, 1)
    assert KX._LOOKBACK[key][2] == 2 * n
    assert not bool(buf.any()) and int(ctr) == KX._EPOCH_FIRST
    assert KX._DRAWN[key] == 8 * n
    assert KX.LAUNCHES["seg_reduce_at_ends"] == 4 * n


def test_out_of_memory_resets_the_pool_once_then_raises(arrays, port,
                                                        monkeypatch):
    """An out-of-memory error in a first run while graphs hold the pool
    drops every graph and the pool, then runs once more; a second one
    raises. With no graph held it raises at once."""
    ex = graphed(port)
    run(port, 1)
    assert ex._graphs.graphs
    run_query = dx._Trace.run_query
    fail = {"left": 1}

    def short_of_memory(self, planned):
        if fail["left"]:
            fail["left"] -= 1
            raise torch.cuda.OutOfMemoryError("stand-in: out of memory")
        return run_query(self, planned)
    monkeypatch.setattr(dx._Trace, "run_query", short_of_memory)
    got = run(port, 3)
    assert_frames_close(got.to_pandas(), oracle(arrays, 3).to_pandas(), 3)
    assert ex._graphs.pool_resets == 1
    assert len(ex._graphs.graphs) == 1 and ex._graphs.pool == ("pool",)
    fail["left"] = 2
    with pytest.raises(torch.cuda.OutOfMemoryError):
        run(port, 6)
    assert ex._graphs.pool_resets == 2 and not ex._graphs.graphs
    fail["left"] = 1
    with pytest.raises(torch.cuda.OutOfMemoryError):
        run(port, 6)
    assert ex._graphs.pool_resets == 2


def test_an_overflow_after_a_replay_captures_again(port, monkeypatch):
    """An overflow read after a replay doubles the plan's slack, drops its
    graph and runs eagerly, then captures again (the reference's
    recompile)."""
    ex = graphed(port)
    exp = run(port, 3)
    (key,) = ex._graphs.graphs
    slack = ex._entries[key]["slack"]
    to_host = dx.DeviceExecutor._to_host
    seen = {"replays": 0}

    def overflowed(self, row, outs, perm, counts):
        if self._graphs.replays > seen["replays"]:
            seen["replays"] = self._graphs.replays
            return None
        return to_host(self, row, outs, perm, counts)
    monkeypatch.setattr(dx.DeviceExecutor, "_to_host", overflowed)
    got = run(port, 3)
    assert_frames_close(got.to_pandas(), exp.to_pandas(), 3)
    t = timings(port)
    assert t["slack_retries"] == 1 and t["compile_ms"] > 0
    assert ex._entries[key]["slack"] == 2 * slack
    assert ex._graphs.captures == 2 and ex._graphs.replays == 1


def test_graphs_off_runs_eagerly_from_the_pool_and_fills_nothing(arrays,
                                                                 port):
    """``use_graphs`` off on an executor that holds graphs: a plan with a
    graph runs eagerly (no capture, no replay) and may fill no cache, since
    it allocates from the graphs' pool; a plan without one runs eagerly as
    on an executor without graphs, and captures nothing."""
    ex = graphed(port)
    exp = {qn: run(port, qn) for qn in (3, 9)}
    ex.use_graphs = False
    for qn in (3, 9):
        got = run(port, qn)
        assert_frames_close(got.to_pandas(), exp[qn].to_pandas(), qn)
        assert timings(port)["compile_ms"] == 0
    assert ex._graphs.captures == 2 and ex._graphs.replays == 0
    ex._dict_tables.clear()
    with pytest.raises(dx.DeviceExecError,
                       match=r"dict_table .*plan [0-9a-f]{12} .*graphs' pool"):
        run(port, 9)
    assert ex._graphs.barring is None and not KX._POOL_RUNS[0]
    got = run(port, 14)
    assert_frames_close(got.to_pandas(), oracle(arrays, 14).to_pandas(), 14)
    assert ex._graphs.captures == 2 and len(ex._graphs.graphs) == 2
    ex.use_graphs = True
    assert_frames_close(run(port, 3).to_pandas(), exp[3].to_pandas(), 3)
    assert ex._graphs.replays == 1


def test_only_the_card_gets_a_graph_runner(port):
    """A CPU executor never reaches the graph code, and the distributed
    executor stays eager."""
    assert port._executor_factory(port.tables)._graphs is None
    assert dx.DeviceExecutor.use_graphs
    assert not DistributedExecutor.use_graphs
    ex = dx.DeviceExecutor({}, "cpu")
    assert ex._graphs is None and ex.use_graphs


def test_the_jax_free_tables_round_trip(arrays):
    """The test's two table builders agree (``from_reference`` of the
    reference's table equals the port's ``from_arrays``)."""
    schemas = ref_schemas()
    for t in ("nation", "customer"):
        a = from_reference(ref_from_arrays(t, schemas[t], arrays[t]))
        b = from_arrays(t, get_schemas()[t], arrays[t])
        for c in a.columns:
            assert np.array_equal(a.columns[c].values, b.columns[c].values)
