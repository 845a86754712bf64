"""The port's NDS (TPC-DS) power run against the CPU oracle of the JAX
package, all 103 statements.

The reference's ``tpcds.gen_table`` data (SF0.01) goes into
``nds_tpu``'s ``Session.for_nds()`` (its ``CpuExecutor``) and, through
``nds_tpu_torch.io.host_table.from_reference`` (bit-identical arrays),
into the port's ``Session.for_nds(make_device_factory(device="cpu"))``
on torch CPU. Each of the 103 statements (the 99 templates, each part
of a two-statement template on its own) must agree under
``tests/test_device_engine.py::assert_frames_close``: exact for integers
and strings, rtol/atol 1e-6 for floats, whose sums the engines
accumulate in other orders. Only the reference validator's own
carve-outs apply (``nds_tpu/nds/validate.py``): q65 is compared on its
row count (ties at the LIMIT edge), and q78's column 3, a rounded
ratio, at rel tol 0.01001. A second run on the port, from its pooled
buffers, memoized dictionary tables and staged splits, must agree too.
"""

import tests.torch_threads  # noqa: F401  (first: sizes torch's threads)

import numpy as np
import pytest

from nds_tpu.datagen import tpcds as ref_tpcds
from nds_tpu.engine.session import Session as RefSession
from nds_tpu.io.host_table import from_arrays
from nds_tpu.nds.schema import get_schemas as ref_schemas
from nds_tpu.nds.validate import COLUMN_REL_TOL, SKIP_QUERIES
from nds_tpu_torch.engine.device_exec import make_device_factory
from nds_tpu_torch.engine.session import Session
from nds_tpu_torch.io.host_table import from_reference
from nds_tpu_torch.nds import streams
from nds_tpu_torch.nds.schema import get_schemas

from tests.test_device_engine import _canon, assert_frames_close

SF = 0.01
UNITS = streams.power_units()


def nds_sessions(ref_factory=None, device="cpu"):
    """(reference session, port session) over one SF0.01 data set; the
    reference runs ``ref_factory``'s executor (its CPU oracle when
    None)."""
    schemas = ref_schemas()
    port_schemas = get_schemas()
    ref = RefSession.for_nds(ref_factory)
    port = Session.for_nds(make_device_factory(device=device))
    for t in schemas:
        table = from_arrays(t, schemas[t], ref_tpcds.gen_table(t, SF))
        ref.register_table(table)
        port.register_table(from_reference(table, port_schemas))
    return ref, port


def assert_unit_matches(got, exp, unit: str):
    """assert_frames_close with the reference validator's carve-outs."""
    qname = "query" + unit.split("_part")[0]
    if qname in SKIP_QUERIES:
        assert got.shape == exp.shape, unit
        return
    tols = {col: tol for (q, col), tol in COLUMN_REL_TOL.items()
            if q == qname}
    if not tols:
        assert_frames_close(got, exp, unit)
        return
    assert got.shape == exp.shape, unit
    got, exp = _canon(got), _canon(exp)
    keep = [i for i in range(exp.shape[1]) if i not in tols]
    assert_frames_close(got.iloc[:, keep], exp.iloc[:, keep], unit)
    for col, tol in tols.items():
        np.testing.assert_allclose(
            got.iloc[:, col].to_numpy(dtype=float),
            exp.iloc[:, col].to_numpy(dtype=float), rtol=tol,
            err_msg=f"{unit} col {col}")


@pytest.fixture(scope="module")
def sessions():
    return nds_sessions()


@pytest.mark.parametrize("unit", [n for n, _ in UNITS])
def test_statement_matches_cpu_oracle(unit, sessions):
    ref, port = sessions
    (sql,) = dict(UNITS)[unit]
    exp = ref.sql(sql).to_pandas()
    got = port.sql(sql).to_pandas()
    assert_unit_matches(got, exp, unit)
    again = port.sql(sql).to_pandas()
    assert_unit_matches(again, exp, unit)


def test_scan_view_bound_holds_the_power_run():
    """Every scan-filter signature of the 103 statements fits the
    executor's scan-view bound at any scale, so a power run never evicts
    a view it needs again (an evicted view is re-filtered on the host
    and uploaded again on its next use)."""
    from nds_tpu_torch.engine.device_exec import DeviceExecutor, _pred_sig
    from nds_tpu_torch.sql import plan as P
    planner = Session.for_nds()
    sigs = set()
    for _unit, (sql,) in UNITS:
        planned = planner.plan(sql)
        for root in [planned.root, *planned.scalar_subplans]:
            for node in P.walk_plan(root):
                if isinstance(node, P.Scan) and node.filters:
                    sigs.add((node.table, "&".join(
                        sorted(_pred_sig(f) for f in node.filters))))
    assert 96 < len(sigs) <= DeviceExecutor.MAX_SCAN_VIEWS


def test_lazy_gathers_equal_eager_gathers():
    """A column gathered through several contexts (a join's indices with
    the validity it clears, a sort's permutation, a limit's head) holds
    what gathering it eagerly at each step gives."""
    import torch
    from nds_tpu_torch.engine.device_exec import DCtx, DVal
    rng = np.random.default_rng(5)
    n = 50
    arr = torch.from_numpy(rng.integers(-9, 9, n))
    valid = torch.from_numpy(rng.random(n) < 0.8)
    ctx = DCtx(n, torch.ones(n, dtype=torch.bool))
    ctx.cols[("t", "a")] = DVal(arr, valid, None, -9, 9)
    ctx.cols[("t", "b")] = DVal(arr * 2, None)
    idx1 = torch.from_numpy(rng.integers(0, n, 70).astype(np.int32))
    clear = torch.from_numpy(rng.random(70) < 0.7)
    idx2 = torch.from_numpy(rng.permutation(70))
    lazy = ctx.gather(idx1, clear_valid=clear).gather(idx2)
    e_arr = arr[idx1.long()][idx2]
    e_valid = (valid[idx1.long()] & clear)[idx2]
    a = lazy.cols[("t", "a")]
    assert (a.lo, a.hi) == (-9, 9)
    head = a.head(30)
    assert torch.equal(head.arr, e_arr[:30])
    assert torch.equal(head.valid, e_valid[:30])
    assert torch.equal(a.arr, e_arr) and torch.equal(a.valid, e_valid)
    b = lazy.cols[("t", "b")]
    assert torch.equal(b.arr, (arr * 2)[idx1.long()][idx2])
    assert torch.equal(b.valid, clear[idx2])


@pytest.mark.parametrize("scale", [0, 2, 4])
def test_decimal_quotients_are_the_oracles_bit_for_bit(scale):
    """The device engine's decimal-to-float conversion (a tensor divisor,
    which the card divides by as the CPU does) gives the CPU oracle's
    quotients bit for bit: NDS q49 ranks ratios of such quotients, and a
    last-bit difference breaks a tie one engine sees."""
    import torch

    from nds_tpu_torch.engine import cpu_exec, device_exec
    from nds_tpu_torch.engine.types import DecimalType
    ints = np.random.default_rng(scale).integers(-10 ** 12, 10 ** 12, 4096)
    t = DecimalType(15, scale)
    got = device_exec._to_float(torch.from_numpy(ints), t, torch.float64)
    want = cpu_exec._to_float(ints, t)
    assert got.dtype == torch.float64
    assert np.array_equal(got.numpy(), want)
