"""The port's DML (``nds_tpu_torch/engine/dml.py``, ``Session``'s INSERT
and DELETE) against the JAX package's, on NDS SF0.01 tables.

The reference generator's tables go into ``nds_tpu``'s ``Session`` (its
CPU oracle) and, through ``from_reference``, into the port's
``Session.for_nds(make_device_factory(device="cpu"))``, whose DELETE
subqueries and INSERT selects run on the port's device engine. After
each statement the mutated table must equal the reference's: the same
physical arrays, the same deleted-row mask, the same content digest.
Then a SELECT over it on the port's device engine must give the JAX
``DeviceExecutor``'s rows (held as ``tests/test_torch_nds_jax_engine``
holds them) and its ``__kernels`` block. The statements cover INSERT ...
SELECT, DELETE with decimal and DATE literals, IN, NOT IN with and
without a NULL in the subquery, scalar subqueries and rows whose
predicate is NULL.

Also: a DELETE on a dimension joined as an unfiltered presorted build
(the scan's live gate must take the join off the presorted path), an
INSERT that widens a join key's bounds (the dense domain must hold the
new keys), the table-scoped invalidation (an unrelated plan and the
executor's other buffers stay), DML through the execution pipeline
(no stale executor), and a DELETE and an INSERT on two gloo ranks of
the distributed engine, whose sharded live mask gates the sharded scan.
"""

import tests.torch_threads  # noqa: F401  (first: sizes torch's threads)

import os
import pathlib
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

from nds_tpu.columnar import delta as ref_delta
from nds_tpu.datagen import tpcds as ref_tpcds
from nds_tpu.engine.device_exec import make_device_factory as ref_factory
from nds_tpu.engine.session import Session as RefSession
from nds_tpu.io.host_table import from_arrays as ref_from_arrays
from nds_tpu.nds.schema import get_schemas as ref_schemas
from nds_tpu_torch.columnar import delta
from nds_tpu_torch.engine.device_exec import make_device_factory
from nds_tpu_torch.engine.session import Session
from nds_tpu_torch.io.host_table import from_reference
from nds_tpu_torch.nds.schema import get_schemas

from tests import torch_dml_rank
from tests.test_torch_delta import _assert_same_arrays
from tests.test_torch_nds_jax_engine import _assert_same_rows

SF = 0.01
TABLES = ("store_sales", "store_returns", "date_dim", "reason", "item",
          "customer")
REPO = pathlib.Path(__file__).resolve().parent.parent

SALES_BY_YEAR = (
    "select d_year, count(*) c, sum(ss_net_paid) s, "
    "sum(ss_sales_price) p from store_sales join date_dim "
    "on ss_sold_date_sk = d_date_sk group by d_year order by d_year")
RETURNS_BY_REASON = (
    "select r_reason_desc, count(*) c, sum(sr_return_amt) a "
    "from store_returns join reason on sr_reason_sk = r_reason_sk "
    "group by r_reason_desc order by r_reason_desc")
SALES_BY_CUSTOMER = (
    "select ss_customer_sk, count(*) c from store_sales "
    "group by ss_customer_sk order by ss_customer_sk limit 50")

# (case, statements, the table they mutate, the SELECT held to the JAX
# engine afterwards)
CASES = {
    "insert_select": (
        ["insert into store_sales (select * from store_sales "
         "where ss_quantity > 95)"], "store_sales", SALES_BY_YEAR),
    "delete_decimal_literal": (
        ["delete from store_sales where ss_sales_price > 50.00"],
        "store_sales", SALES_BY_YEAR),
    "delete_date_literal": (
        ["delete from date_dim where d_date >= '2000-01-01'"],
        "date_dim", SALES_BY_YEAR),
    "delete_in_subquery": (
        ["delete from store_returns where sr_ticket_number in "
         "(select distinct ss_ticket_number from store_sales, date_dim "
         "where ss_sold_date_sk = d_date_sk and d_date between "
         "'1998-02-01' and '1998-03-01')"],
        "store_returns", RETURNS_BY_REASON),
    "delete_not_in_with_null": (
        # ss_customer_sk has NULLs: NOT IN is never TRUE, nothing goes
        ["delete from store_returns where sr_customer_sk not in "
         "(select ss_customer_sk from store_sales)"],
        "store_returns", RETURNS_BY_REASON),
    "delete_not_in": (
        ["delete from store_returns where sr_reason_sk not in "
         "(select r_reason_sk from reason where r_reason_sk < 20)"],
        "store_returns", RETURNS_BY_REASON),
    "delete_scalar_subqueries": (
        ["delete from store_sales where ss_sold_date_sk >= "
         "(select min(d_date_sk) from date_dim where d_date between "
         "'1998-01-01' and '1998-01-31') and ss_sold_date_sk <= "
         "(select max(d_date_sk) from date_dim where d_date between "
         "'1998-01-01' and '1998-01-31')"],
        "store_sales", SALES_BY_YEAR),
    "delete_null_predicate_rows": (
        # rows with a NULL ss_customer_sk survive: the predicate is NULL
        ["delete from store_sales where ss_customer_sk < 1000000"],
        "store_sales", SALES_BY_CUSTOMER),
    "insert_then_delete": (
        ["insert into store_sales (select * from store_sales "
         "where ss_quantity < 5)",
         "delete from store_sales where ss_quantity between 2 and 3"],
        "store_sales", SALES_BY_YEAR),
}


@pytest.fixture(scope="module")
def ref_tables():
    schemas = ref_schemas()
    return {t: ref_from_arrays(t, schemas[t], ref_tpcds.gen_table(t, SF))
            for t in TABLES}


def _sessions(ref_tables, ref_fac=None, port_fac=None):
    port_schemas = get_schemas()
    ref = RefSession.for_nds(ref_fac)
    port = Session.for_nds(port_fac or make_device_factory(device="cpu"))
    for t, table in ref_tables.items():
        ref.register_table(table)
        port.register_table(from_reference(table, port_schemas))
    return ref, port


def _kernels(session):
    ex = session._executor_factory(session.tables)
    return dict(ex.last_timings.get("__kernels") or {})


def _assert_same_table(port_table, ref_table):
    """The same effective table: physical arrays, deleted-row mask,
    visible rows and content digest."""
    _assert_same_arrays(port_table, ref_table)
    got, want = delta.live_mask(port_table), ref_delta.live_mask(ref_table)
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(got, want)
    assert delta.visible_rows(port_table) == ref_delta.visible_rows(
        ref_table)
    assert delta.delta_report(port_table) == ref_delta.delta_report(
        ref_table)
    assert (delta.state_of(port_table).content_digest()
            == ref_delta.state_of(ref_table).content_digest())


@pytest.mark.parametrize("case", list(CASES))
def test_dml_matches_reference(case, ref_tables):
    stmts, table, select = CASES[case]
    ref, port = _sessions(ref_tables)
    n0 = ref.tables[table].nrows
    for stmt in stmts:
        assert ref.sql(stmt) is None
        assert port.sql(stmt) is None
        _assert_same_table(port.tables[table], ref.tables[table])
    if case == "delete_not_in_with_null":
        assert delta.visible_rows(port.tables[table]) == n0
    elif case.startswith("delete"):
        assert delta.visible_rows(port.tables[table]) < n0
    if case == "delete_null_predicate_rows":
        # every surviving row has a NULL ss_customer_sk
        t = port.tables[table]
        valid = t.columns["ss_customer_sk"].null_mask
        assert not valid[delta.live_mask(t)].any()
    # the SELECT over the mutated table: the JAX DeviceExecutor over
    # the reference's mutated tables, the port's device engine over its
    jax = RefSession.for_nds(ref_factory())
    for t in ref.tables.values():
        jax.register_table(t)
    exp = jax.sql(select).to_pandas()
    got = port.sql(select).to_pandas()
    _assert_same_rows(got, exp, case)
    assert _kernels(port) == _kernels(jax), case
    # the port's CPU oracle honours the deleted-row mask too
    oracle = Session.for_nds()
    for t in port.tables.values():
        oracle.register_table(t)
    _assert_same_rows(oracle.sql(select).to_pandas(), exp, case)


def test_delete_on_a_presorted_build(ref_tables, monkeypatch):
    """With the kernels off (``NDS_TPU_KERNELS=0``) date_dim joins as an
    unfiltered build whose key is sorted: the presorted path. After a
    DELETE on it the live gate leaves deleted rows inside the scan's
    prefix, so the join must sort its build (``join.sortmerge``), as the
    reference does, or it would match deleted rows."""
    monkeypatch.setenv("NDS_TPU_KERNELS", "0")
    sql = ("select count(*) c, sum(ss_quantity) q from store_sales "
           "join date_dim on ss_sold_date_sk = d_date_sk")
    jax_fac = ref_factory()
    ref, port = _sessions(ref_tables, ref_fac=jax_fac)
    exp = ref.sql(sql).to_pandas()
    got = port.sql(sql).to_pandas()
    _assert_same_rows(got, exp, "before")
    assert _kernels(port) == _kernels(ref)
    assert _kernels(port).get("join.presorted") == 1, _kernels(port)
    stmt = "delete from date_dim where d_year = 2000"
    ref.sql(stmt)
    port.sql(stmt)
    _assert_same_table(port.tables["date_dim"], ref.tables["date_dim"])
    exp = ref.sql(sql).to_pandas()
    got = port.sql(sql).to_pandas()
    _assert_same_rows(got, exp, "after")
    assert _kernels(port) == _kernels(ref)
    assert not _kernels(port).get("join.presorted"), _kernels(port)
    oracle = Session.for_nds()
    for t in port.tables.values():
        oracle.register_table(t)
    _assert_same_rows(oracle.sql(sql).to_pandas(), exp, "oracle")
    assert int(got.iloc[0, 0]) < int(
        port.sql("select count(*) from store_sales where "
                 "ss_sold_date_sk is not null").to_pandas().iloc[0, 0])


LEFT_MULTI = (
    "select count(*) c, count(sr_ticket_number) m, sum(sr_return_amt) a, "
    "sum(ss_quantity) q from store_sales left outer join store_returns "
    "on ss_customer_sk = sr_customer_sk where ss_quantity > 50")


def test_left_join_over_a_repeated_left_key(ref_tables):
    """A LEFT JOIN whose left key repeats and whose right key too (the
    LF_* views' shape): every match of every left row, as the CPU
    oracle, where the reference's device engine keeps one left row a
    right row (``_left_multi_join``; its block of further matches
    overflows at the first slack and runs again)."""
    ref, port = _sessions(ref_tables)
    exp = ref.sql(LEFT_MULTI).to_pandas()
    got = port.sql(LEFT_MULTI).to_pandas()
    _assert_same_rows(got, exp, "left multi")
    ex = port._executor_factory(port.tables)
    assert ex.last_timings["slack_retries"] >= 1
    assert not ex.cols_unique("store_sales", ("ss_customer_sk",))
    left = port.sql("select count(*) c from store_sales "
                    "where ss_quantity > 50").to_pandas()
    # more rows than the left side has: left rows matched several times
    assert int(got["c"].iloc[0]) > int(left["c"].iloc[0])


def test_insert_widens_a_join_keys_bounds(ref_tables):
    """An INSERT past a key's old maximum: the bounds the executor held
    for the table go with it, or K1's dense domain would drop the new
    keys. The query ran before the INSERT on the same executor."""
    ref, port = _sessions(ref_tables)
    reason_cols = [f.name for f in get_schemas()["reason"]]
    sel = ", ".join("r_reason_sk + 100" if c == "r_reason_sk" else c
                    for c in reason_cols)
    sr_cols = [f.name for f in get_schemas()["store_returns"]]
    sel_sr = ", ".join("sr_reason_sk + 100" if c == "sr_reason_sk" else c
                       for c in sr_cols)
    before = port.sql(RETURNS_BY_REASON).to_pandas()
    ex = port._executor_factory(port.tables)
    assert ex.col_bounds("reason", "r_reason_sk")[1] < 100
    for stmt in (f"insert into reason (select {sel} from reason)",
                 f"insert into store_returns (select {sel_sr} from "
                 f"store_returns where sr_return_quantity > 50)"):
        ref.sql(stmt)
        port.sql(stmt)
    assert port._executor_factory(port.tables) is ex
    got = port.sql(RETURNS_BY_REASON).to_pandas()
    jax = RefSession.for_nds(ref_factory())
    for t in ref.tables.values():
        jax.register_table(t)
    exp = jax.sql(RETURNS_BY_REASON).to_pandas()
    _assert_same_rows(got, exp, "after insert")
    _assert_same_rows(ref.sql(RETURNS_BY_REASON).to_pandas(), exp, "oracle")
    assert _kernels(port) == _kernels(jax)
    assert int(got["c"].sum()) > int(before["c"].sum())
    assert ex.col_bounds("reason", "r_reason_sk")[1] >= 100


def test_invalidation_is_scoped_to_the_mutated_table(ref_tables):
    """A DELETE drops the plan-cache entries of plans that scan the
    mutated table and that table's device state, nothing else: the
    unrelated plan stays cached (the same plan object, so the same
    executor entry) and so do the other tables' buffers."""
    _ref, port = _sessions(ref_tables)
    unrelated = "select count(*) c from reason where r_reason_sk > 3"
    # unfiltered: a filtered scan would read a reduced view, which the
    # live mask seeds, and carry no gate
    mutated = "select count(*) c, sum(ss_quantity) q from store_sales"
    port.sql(unrelated)
    n0 = int(port.sql(mutated).to_pandas().iloc[0, 0])
    keys = {sql: next(k for k in port._plan_cache if k[0] == sql)
            for sql in (unrelated, mutated)}
    plan_u = port._plan_cache[keys[unrelated]]
    ex = port._executor_factory(port.tables)
    assert ex.col_is_sorted("store_sales", "ss_item_sk") is not None
    reason_bufs = {k: v for k, v in ex._buffers.items()
                   if k.startswith("reason.")}
    assert reason_bufs and any(k.startswith("store_sales.")
                               for k in ex._buffers)
    port.sql("delete from store_sales where ss_quantity > 50")
    assert port._plan_cache.get(keys[unrelated]) is plan_u
    assert keys[mutated] not in port._plan_cache
    assert port._executor_factory(port.tables) is ex
    assert not any(k[0] == "store_sales" for k in ex._bounds)
    assert not any(k.startswith("store_sales.") for k in ex._buffers)
    assert all(ex._buffers.get(k) is v for k, v in reason_bufs.items())
    n1 = int(port.sql(mutated).to_pandas().iloc[0, 0])
    assert n1 < n0
    assert "store_sales.__live" in ex._buffers
    port.sql(unrelated)
    assert port._plan_cache.get(keys[unrelated]) is plan_u


def test_dml_through_the_pipeline_leaves_no_stale_executor(ref_tables):
    """The execution pipeline has no scoped invalidation (as the
    reference's): a DML drops every placement executor, and the next
    query runs on a fresh one over the mutated table."""
    from nds_tpu_torch.engine.scheduler import make_pipeline
    from nds_tpu_torch.utils.config import EngineConfig
    pipe = make_pipeline(EngineConfig(overrides={"engine.device": "cpu"}))
    ref, port = _sessions(ref_tables, port_fac=pipe)
    port.sql(SALES_BY_YEAR)
    old = pipe._executors.get("device")
    assert old is not None
    stmt = ("delete from store_sales where ss_sold_date_sk <= "
            "(select min(d_date_sk) + 400 from date_dim)")
    ref.sql(stmt)
    port.sql(stmt)
    assert pipe.last_schedule["placement"] == "device"
    assert pipe.last_schedule["reschedules"] == 0
    _assert_same_table(port.tables["store_sales"],
                       ref.tables["store_sales"])
    got = port.sql(SALES_BY_YEAR).to_pandas()
    new = pipe._executors.get("device")
    assert new is not None and new is not old
    assert new.tables is port.tables
    _assert_same_rows(got, ref.sql(SALES_BY_YEAR).to_pandas(), "pipeline")


# ------------------------------------------------ two gloo ranks

DIST_WORLD = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_dml_on_the_distributed_engine(ref_tables, tmp_path):
    port_no = _free_port()
    procs, outs = [], []
    for rank in range(DIST_WORLD):
        env = dict(os.environ)
        env.update(NDS_TPU_COORDINATOR=f"127.0.0.1:{port_no}",
                   NDS_TPU_NUM_PROCESSES=str(DIST_WORLD),
                   NDS_TPU_PROCESS_ID=str(rank),
                   NDS_TPU_DIST_TIMEOUT_S="60", OMP_NUM_THREADS="1",
                   PYTHONPATH=str(REPO))
        out = tmp_path / f"rank{rank}.pkl"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "torch_dml_rank.py"),
             str(rank), str(DIST_WORLD), str(out)], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        pytest.fail("the ranks did not finish in 120 s")
    finally:
        for p in procs:
            p.kill()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank}:\n{log[-6000:]}"
    ref = RefSession.for_nds()
    for t in ("store_sales", "date_dim"):
        ref.register_table(ref_tables[t])
    exp_before = ref.sql(torch_dml_rank.SELECT).to_pandas()
    for stmt in torch_dml_rank.STMTS:
        ref.sql(stmt)
    exp_after = ref.sql(torch_dml_rank.SELECT).to_pandas()
    for out in outs:
        with open(out, "rb") as f:
            res = pickle.load(f)
        _assert_same_rows(res["before"], exp_before, "before")
        _assert_same_rows(res["after"], exp_after, "after")
        assert res["live_key"]

