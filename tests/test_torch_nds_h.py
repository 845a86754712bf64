"""The port's NDS-H slice against the JAX engine, all 22 queries.

The same ``tpch.gen_table`` data (SF0.01) goes into ``nds_tpu``'s
``Session.for_nds_h(make_device_factory())`` on jax CPU and, through
``nds_tpu_torch.io.host_table.from_reference`` (bit-identical arrays),
into the port's ``Session.for_nds_h(make_device_factory(device="cpu"))``
on torch CPU. Per query: the rows must agree under
``tests/test_device_engine.py::assert_frames_close`` (exact for
integers and strings, rtol/atol 1e-6 for floats, whose sums the two
engines accumulate in different orders), and the query's kernel block
(which kernel each join, semi-join and grouped min/max actually used)
must equal the reference executor's exactly. A second run on the port,
served from its pooled buffers and memoized dictionary tables, must
agree too.
"""

import tests.torch_threads  # noqa: F401  (first: sizes torch's threads)

import pytest

from nds_tpu.datagen import tpch
from nds_tpu.engine.device_exec import make_device_factory as ref_factory
from nds_tpu.engine.session import Session as RefSession
from nds_tpu.io.host_table import from_arrays
from nds_tpu.nds_h import streams as ref_streams
from nds_tpu.nds_h.schema import get_schemas
from nds_tpu_torch.engine.device_exec import make_device_factory
from nds_tpu_torch.engine.session import Session
from nds_tpu_torch.io.host_table import from_reference
from nds_tpu_torch.nds_h import streams

from tests.test_device_engine import assert_frames_close

SF = 0.01


@pytest.fixture(scope="module")
def sessions():
    schemas = get_schemas()
    ref = RefSession.for_nds_h(ref_factory())
    port = Session.for_nds_h(make_device_factory(device="cpu"))
    for t in schemas:
        table = from_arrays(t, schemas[t], tpch.gen_table(t, SF))
        ref.register_table(table)
        port.register_table(from_reference(table))
    return ref, port


def _run(session, stmts):
    result = None
    for s in stmts:
        r = session.sql(s)
        if r is not None:
            result = r
    ex = session._executor_factory(session.tables)
    return result, dict(ex.last_timings.get("__kernels") or {})


@pytest.mark.parametrize("qn", range(1, 23))
def test_query_matches_jax_engine(qn, sessions):
    ref, port = sessions
    stmts = streams.statements(qn)
    assert stmts == ref_streams.statements(qn)
    exp, exp_kernels = _run(ref, stmts)
    got, got_kernels = _run(port, stmts)
    assert_frames_close(got.to_pandas(), exp.to_pandas(), qn)
    assert got_kernels == exp_kernels, (
        f"q{qn}: kernel block {got_kernels} vs reference {exp_kernels}")
    # a second run reuses the executor's buffers and memoized
    # dictionary tables, as the timed pass of a power run does
    again, again_kernels = _run(port, stmts)
    assert_frames_close(again.to_pandas(), exp.to_pandas(), qn)
    assert again_kernels == exp_kernels
