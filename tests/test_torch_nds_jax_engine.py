"""The port's NDS paths against the JAX engine's ``DeviceExecutor``.

One SF0.01 data set is registered in ``nds_tpu``'s
``Session.for_nds(make_device_factory())`` on jax CPU and in the port's
``Session.for_nds(make_device_factory(device="cpu"))`` on torch CPU.
For a subset of the 103 statements that covers every NDS-only path,
each statement's rows must equal the reference's (the same rows in the
same order, exactly but for floats, held to 1e-9 because their sums add
in another order) and its ``__kernels`` block (the kernel each
join, semi-join and grouped min/max used, the staged sub-plans'
included) must be the same:

- q4, q72: partitioned M:N joins (K6);
- q5, q77: staged statements with UNION ALL and ROLLUP unions;
- q12, q51: windows (whole-partition sums; q51's running sum and max
  under a ROWS frame through the segmented scan);
- q38, q87: INTERSECT and EXCEPT under DISTINCT;
- q6: a scalar subplan beside DISTINCT.

The window forms that no NDS statement reaches run over the fact table
of ``tests/test_kernels.py``: whole-partition MIN and MAX (through
``part_reduce_broadcast``) and running aggregates under the default
RANGE frame (through ``last_of_group``) and under a ROWS frame. Those
rows must equal both the reference ``DeviceExecutor``'s and its CPU
oracle's.

All 103 statements against the ``DeviceExecutor`` take minutes of XLA
compiles on the CPU and are marked ``slow``.
"""

import tests.torch_threads  # noqa: F401  (first: sizes torch's threads)

import contextlib

import numpy as np
import pandas as pd
import pytest

from nds_tpu.engine.device_exec import make_device_factory as ref_factory
from nds_tpu_torch.engine import kernels as KX
from nds_tpu_torch.engine import types as T
from nds_tpu_torch.engine.device_exec import make_device_factory
from nds_tpu_torch.engine.session import Session
from nds_tpu_torch.io.host_table import from_arrays
from nds_tpu_torch.nds import streams
from nds_tpu_torch.sql.planner import CatalogInfo

from tests.test_kernels import _build_sessions, _catalog, _data
from tests.test_torch_nds import assert_unit_matches, nds_sessions

UNITS = dict(streams.power_units())
SUBSET = ["4", "72", "5", "77", "12", "51", "38", "87", "6"]


def _kernels(session):
    ex = session._executor_factory(session.tables)
    return dict(ex.last_timings.get("__kernels") or {})


def _run(session, sql):
    res = session.sql(sql).to_pandas()
    return res, _kernels(session)


@contextlib.contextmanager
def _counting(*names):
    """Count the calls the executor makes to these kernel wrappers."""
    calls = {n: 0 for n in names}
    wrapped = {n: getattr(KX, n) for n in names}

    def counter(name):
        def call(*args):
            calls[name] += 1
            return wrapped[name](*args)
        return call

    try:
        for n in names:
            setattr(KX, n, counter(n))
        yield calls
    finally:
        for n, fn in wrapped.items():
            setattr(KX, n, fn)


def _assert_same_rows(got: pd.DataFrame, exp: pd.DataFrame, what: str):
    """The same rows in the same order: integers, decimals, dates and
    strings exactly; floats to rtol/atol 1e-9, since a float sum (a
    cumsum difference, an average) adds in another order in torch than
    in XLA and may differ in its last bits."""
    assert list(got.columns) == list(exp.columns), what
    assert got.shape == exp.shape, what
    for i in range(exp.shape[1]):
        g, e = got.iloc[:, i], exp.iloc[:, i]
        assert list(g.isna()) == list(e.isna()), f"{what} col {i} nulls"
        g, e = g[~g.isna()], e[~e.isna()]
        if g.dtype.kind == "f" or e.dtype.kind == "f":
            np.testing.assert_allclose(g.to_numpy(dtype=float),
                                       e.to_numpy(dtype=float), rtol=1e-9,
                                       atol=1e-9, err_msg=f"{what} col {i}")
        else:
            assert list(g.astype(str)) == list(e.astype(str)), (
                f"{what} col {i}")


@pytest.fixture(scope="module")
def sessions():
    return nds_sessions(ref_factory())


@pytest.mark.parametrize("unit", SUBSET)
def test_statement_matches_jax_engine(unit, sessions):
    ref, port = sessions
    (sql,) = UNITS[unit]
    exp, exp_k = _run(ref, sql)
    got, got_k = _run(port, sql)
    _assert_same_rows(got, exp, f"q{unit}")
    assert got_k == exp_k, f"q{unit}: {got_k} vs reference {exp_k}"


def test_subset_covers_the_nds_paths(sessions):
    """The subset reaches every NDS-only kernel and plan node."""
    _ref, port = sessions
    seen: dict = {}
    with _counting("partitioned_mn_join", "seg_scan") as calls:
        for unit in SUBSET:
            port.sql(UNITS[unit][0])
            for k, v in _kernels(port).items():
                seen[k] = seen.get(k, 0) + v
    assert seen.get("join.partitioned", 0) > 0, seen
    assert all(c > 0 for c in calls.values()), calls


# ------------------------------------------------- window forms

def _port_catalog():
    """The port's copy of tests/test_kernels.py's catalog."""
    ref = _catalog()
    conv = {"int32": T.INT32, "int64": T.INT64, "varchar(10)": T.varchar(10)}
    schemas = {t: T.Schema.of(*[(f.name, conv[repr(f.dtype)], f.nullable)
                                for f in s])
               for t, s in ref.schemas.items()}
    return CatalogInfo(schemas, ref.primary_keys, ref.sizes)


@pytest.fixture(scope="module")
def fact_sessions():
    cpu, dev = _build_sessions()
    cat = _port_catalog()
    data = _data()
    port = Session(cat, make_device_factory(device="cpu"))
    for t in cat.schemas:
        port.register_table(from_arrays(t, cat.schemas[t], data[t]))
    return cpu, dev, port


WINDOW_FORMS = {
    # sql: the K7 wrappers it must go through
    "partition_minmax": (
        "select f_id, min(f_qty) over (partition by f_key) pmn, "
        "max(f_qty) over (partition by f_key) pmx from fact order by f_id",
        ("part_reduce_broadcast",)),
    "partition_minmax_nullable": (
        "select f_id, min(f_val) over (partition by f_dim) pmn, "
        "max(f_val) over (partition by f_tiny) pmx from fact "
        "order by f_id",
        ("part_reduce_broadcast",)),
    "running_sum_range": (
        "select f_id, sum(f_qty) over (partition by f_key order by f_val) "
        "rs, count(f_val) over (partition by f_key order by f_val) rc "
        "from fact order by f_id",
        ("seg_scan", "last_of_group")),
    "running_max_rows": (
        "select f_id, max(f_qty) over (partition by f_tiny order by f_id "
        "rows between unbounded preceding and current row) rm, "
        "min(f_val) over (partition by f_tiny order by f_id rows between "
        "unbounded preceding and current row) rn from fact order by f_id",
        ("seg_scan",)),
}


@pytest.mark.parametrize("form", sorted(WINDOW_FORMS))
def test_window_form_matches_jax_engine(form, fact_sessions):
    cpu, dev, port = fact_sessions
    sql, via = WINDOW_FORMS[form]
    with _counting(*via) as calls:
        got, got_k = _run(port, sql)
    exp, exp_k = _run(dev, sql)
    oracle = cpu.sql(sql).to_pandas()
    _assert_same_rows(got, exp, form)
    _assert_same_rows(got, oracle, form)
    assert got_k == exp_k
    assert all(c > 0 for c in calls.values()), calls
    assert np.isfinite(got.iloc[:, 1:].to_numpy(dtype=float)[
        ~got.iloc[:, 1:].isna().to_numpy()]).all()


@pytest.mark.slow
@pytest.mark.parametrize("unit", list(UNITS))
def test_all_statements_match_jax_engine(unit, sessions):
    ref, port = sessions
    (sql,) = UNITS[unit]
    exp, exp_k = _run(ref, sql)
    got, got_k = _run(port, sql)
    assert_unit_matches(got, exp, unit)
    assert got_k == exp_k, f"q{unit}: {got_k} vs reference {exp_k}"
