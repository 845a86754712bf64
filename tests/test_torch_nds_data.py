"""The port's NDS (TPC-DS) data, query text and plans against the JAX
package's.

- ``nds_tpu_torch.datagen.tpcds.gen_table(t, 0.01)`` equals
  ``nds_tpu.datagen.tpcds.gen_table`` array for array, for all 24
  tables: both engines are then fed from one generator.
- ``render_query`` (and ``random_params`` on a seeded generator) gives
  the reference's SQL for all 99 templates.
- The port's planner stamps the same kernel on every Join, SemiJoin and
  Aggregate of each of the 103 power-run statements, node by node in
  walk order, as the reference planner.
"""

import tests.torch_threads  # noqa: F401  (first: sizes torch's threads)

import random

import numpy as np
import pytest

from nds_tpu.datagen import tpcds as ref_tpcds
from nds_tpu.engine.session import Session as RefSession
from nds_tpu.nds import streams as ref_streams
from nds_tpu.nds.schema import get_schemas as ref_schemas
from nds_tpu.sql import plan as RP
from nds_tpu_torch.datagen import tpcds
from nds_tpu_torch.engine.session import Session
from nds_tpu_torch.nds import streams
from nds_tpu_torch.nds.schema import get_schemas
from nds_tpu_torch.sql import plan as P

SF = 0.01


def test_schemas_match_reference():
    ref = ref_schemas()
    port = get_schemas()
    assert list(port) == list(ref)
    for t in ref:
        assert [(f.name, repr(f.dtype), f.nullable) for f in port[t]] == [
            (f.name, repr(f.dtype), f.nullable) for f in ref[t]], t


@pytest.mark.parametrize("table", sorted(ref_schemas()))
def test_gen_table_matches_reference(table):
    exp = ref_tpcds.gen_table(table, SF)
    got = tpcds.gen_table(table, SF)
    assert sorted(got) == sorted(exp)
    for name in exp:
        g, e = np.asarray(got[name]), np.asarray(exp[name])
        assert g.dtype == e.dtype and g.shape == e.shape, name
        np.testing.assert_array_equal(g, e, err_msg=f"{table}.{name}")


@pytest.mark.parametrize("qn", ref_streams.available_templates())
def test_render_query_matches_reference(qn):
    assert streams.render_query(qn) == ref_streams.render_query(qn)
    p_ref = ref_streams.random_params(qn, random.Random(qn), 1)
    p_port = streams.random_params(qn, random.Random(qn), 1)
    assert p_port == p_ref
    assert streams.render_query(qn, p_port) == ref_streams.render_query(
        qn, p_ref)


def test_power_units_are_the_103_statements():
    units = streams.power_units()
    assert len(units) == 103
    assert streams.available_templates() == \
        ref_streams.available_templates()
    parts = sorted(n for n, _ in units if "_part" in n)
    assert parts == ["14_part1", "14_part2", "23_part1", "23_part2",
                     "24_part1", "24_part2", "39_part1", "39_part2"]


def _stamps(planned, plan_mod):
    """(node type, kernel) of every Join/SemiJoin/Aggregate, in walk
    order over the root and the scalar subplans; plus the window, set-op
    and DISTINCT nodes, which carry no stamp."""
    out = []
    for root in [planned.root, *planned.scalar_subplans]:
        for node in plan_mod.walk_plan(root):
            name = type(node).__name__
            if name in ("Join", "SemiJoin", "Aggregate"):
                out.append((name, node.kernel))
            elif name in ("Window", "SetOp", "Distinct"):
                out.append((name, ""))
    return out


@pytest.fixture(scope="module")
def planners():
    return RefSession.for_nds(), Session.for_nds()


@pytest.mark.parametrize("unit", [n for n, _ in streams.power_units()])
def test_plan_stamps_match_reference(unit, planners):
    ref, port = planners
    (sql,) = dict(streams.power_units())[unit]
    exp = _stamps(ref.plan(sql), RP)
    got = _stamps(port.plan(sql), P)
    assert got == exp
    assert got, f"{unit}: no stamped node"
