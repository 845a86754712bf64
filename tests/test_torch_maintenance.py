"""The port's NDS data-maintenance phase against the JAX package's.

On the port's SF0.01 warehouse (``gen_data``, ``transcode``) and refresh
set 1 (``gen_data --update 1``):

- ``gen_refresh_table`` equals the reference's for all 12 refresh
  tables, for updates 1 and 2, and ``gen_data --update`` writes the
  reference's files byte for byte;
- the port's ``run_maintenance`` on the ``gpu`` backend at ``engine.device
  cpu`` (the LF_* selects and DF_* subqueries on the port's device
  engine) and the reference's on the CPU backend, each on its own copy
  of the warehouse, end with 0 failures, the same visible rows in the 7
  ``MUTABLE_TABLES`` (as multisets: the engines may order an INSERT's
  ties apart), the same snapshot manifest (tables, files, version
  count) and the same time-log rows;
- the port's versioned load reads its maintained warehouse to the same
  tables (arrays, deleted-row masks, content digests) as the
  reference's loader reads it;
- ``query96``, ``query7`` and ``query93`` over the maintained warehouse
  give, on the port's device engine, the JAX ``DeviceExecutor``'s rows
  and ``__kernels`` blocks over the same warehouse;
- after the port's rollback the pre-maintenance results come back bit
  for bit, and the CLI's refusals (``--compact``, alone or beside
  ``--resume``; no card) write nothing.
"""

import tests.torch_threads  # noqa: F401  (first: sizes torch's threads)

import os
import shutil

import numpy as np
import pandas as pd
import pytest

from nds_tpu.columnar import delta as ref_delta
from nds_tpu.datagen import tpcds_refresh as ref_refresh
from nds_tpu.engine.device_exec import make_device_factory as ref_factory
from nds_tpu.engine.session import Session as RefSession
from nds_tpu.nds import gen_data as ref_gen
from nds_tpu.nds import maintenance as ref_maintenance
from nds_tpu.nds import power as ref_power
from nds_tpu.utils import power_core as ref_core
from nds_tpu.utils.config import EngineConfig as RefConfig
from nds_tpu_torch.columnar import delta
from nds_tpu_torch.datagen import tpcds_refresh
from nds_tpu_torch.engine.device_exec import make_device_factory
from nds_tpu_torch.engine.session import Session
from nds_tpu_torch.io.snapshots import SnapshotLog
from nds_tpu_torch.nds import gen_data, maintenance, power, rollback
from nds_tpu_torch.nds import streams, transcode
from nds_tpu_torch.nds.schema import get_maintenance_schemas
from nds_tpu_torch.utils import power_core
from nds_tpu_torch.utils.config import EngineConfig
from nds_tpu_torch.utils.timelog import TimeLog

from tests.test_torch_delta import _assert_same_arrays
from tests.test_torch_nds_jax_engine import _assert_same_rows

SF = 0.01
SUBSET = ["96", "7", "93"]
UNITS = dict(streams.power_units([int(q) for q in SUBSET]))


@pytest.mark.parametrize("update", [1, 2])
@pytest.mark.parametrize("table", list(get_maintenance_schemas()))
def test_refresh_table_equals_reference(table, update):
    got = tpcds_refresh.gen_refresh_table(table, SF, update)
    want = ref_refresh.gen_refresh_table(table, SF, update)
    assert list(got) == list(want)
    for col, arr in want.items():
        assert got[col].dtype == arr.dtype, col
        np.testing.assert_array_equal(got[col], arr, err_msg=col)


def test_update_cli_writes_the_reference_files(tmp_path):
    gen_data.main(["0.01", "1", str(tmp_path / "port"), "--update", "2"])
    ref_gen.generate_refresh_data(SF, 2, str(tmp_path / "ref"))
    for t in get_maintenance_schemas():
        name = os.path.join(t, f"{t}.dat")
        with open(tmp_path / "port" / name, "rb") as f, \
                open(tmp_path / "ref" / name, "rb") as g:
            assert f.read() == g.read(), t


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The port's SF0.01 warehouse and refresh set 1; the subset's
    results before maintenance; one maintenance run by each package on
    its own copy."""
    root = tmp_path_factory.mktemp("maint")
    raw, wh = str(root / "raw"), str(root / "wh")
    refresh = str(root / "refresh1")
    gen_data.generate_data_local(SF, 1, raw, workers=1)
    transcode.transcode(raw, wh, str(root / "load.txt"))
    gen_data.generate_refresh_data(SF, 1, refresh)
    out = {"root": root, "refresh": refresh,
           "pre": _subset_results(_port_session(wh))[0]}
    for who, run, cfg in (
            ("port", maintenance.run_maintenance,
             EngineConfig(overrides={"engine.device": "cpu"})),
            ("ref", ref_maintenance.run_maintenance,
             RefConfig(overrides={"engine.backend": "cpu"}))):
        d = str(root / f"wh_{who}")
        shutil.copytree(wh, d)
        tlog = str(root / f"dm_{who}.csv")
        failures = run(d, refresh, tlog, config=cfg,
                       json_summary_folder=str(root / f"json_{who}"))
        out[who] = {"wh": d, "tlog": tlog, "failures": failures,
                    "json": str(root / f"json_{who}")}
    return out


def _port_session(wh):
    sess = Session.for_nds(make_device_factory(device="cpu"))
    power_core.load_warehouse(power.SUITE, sess, wh)
    return sess


def _ref_session(wh, factory=None):
    sess = RefSession.for_nds(factory)
    ref_core.load_warehouse(ref_power.SUITE, sess, wh)
    return sess


def _kernels(session):
    ex = session._executor_factory(session.tables)
    return dict(ex.last_timings.get("__kernels") or {})


def _subset_results(session):
    rows, kernels = {}, {}
    for q in SUBSET:
        (sql,) = UNITS[q]
        rows[q] = session.sql(sql).to_pandas()
        kernels[q] = _kernels(session)
    return rows, kernels


def _visible_frame(table) -> pd.DataFrame:
    """The table's visible rows as a frame sorted on every column: a
    multiset, whatever the physical order."""
    t = table
    live = (delta.live_mask(t) if hasattr(t, "_nds_delta")
            and type(t).__module__.startswith("nds_tpu_torch")
            else ref_delta.live_mask(t))
    cols = {}
    for name, col in t.columns.items():
        vals = col.decode() if col.dictionary is not None else col.values
        vals = pd.Series(vals, dtype=object)
        if col.null_mask is not None:
            vals[~col.null_mask] = None
        cols[name] = vals if live is None else vals[live]
    frame = pd.DataFrame({k: v.reset_index(drop=True)
                          for k, v in cols.items()})
    return frame.sort_values(list(frame.columns), na_position="first",
                             key=lambda s: s.astype(str)).reset_index(
                                 drop=True)


def test_both_runs_complete(data):
    assert data["port"]["failures"] == 0
    assert data["ref"]["failures"] == 0
    names = sorted(os.listdir(data["port"]["json"]))
    assert len(names) == 11


def test_time_log_rows_equal_the_reference(data):
    rows = {who: [q for _a, q, _ms in TimeLog.read(data[who]["tlog"])]
            for who in ("port", "ref")}
    assert rows["port"] == rows["ref"]
    assert sum(q.startswith(("LF_", "DF_")) for q in rows["port"]) == 11
    assert rows["port"][-1] == "Data Maintenance Time"


def test_manifest_equals_the_reference(data):
    port = SnapshotLog(data["port"]["wh"]).entries
    ref = SnapshotLog(data["ref"]["wh"]).entries
    assert len(port) == len(ref) > 0
    assert [e["version"] for e in port] == [e["version"] for e in ref]
    assert [e["tables"] for e in port] == [e["tables"] for e in ref]
    assert [e["note"].rsplit(":", 1)[1] for e in port] == [
        e["note"].rsplit(":", 1)[1] for e in ref]


@pytest.mark.parametrize("table", maintenance.MUTABLE_TABLES)
def test_post_state_equals_the_reference(table, data):
    port = Session.for_nds()
    power_core.load_warehouse(power.SUITE, port, data["port"]["wh"],
                              tables=[table])
    ref = RefSession.for_nds()
    ref_core.load_warehouse(ref_power.SUITE, ref, data["ref"]["wh"],
                            tables=[table])
    got, want = port.tables[table], ref.tables[table]
    assert delta.state_of(got) is not None
    assert delta.visible_rows(got) == ref_delta.visible_rows(want)
    assert delta.delta_report(got) == ref_delta.delta_report(want)
    pd.testing.assert_frame_equal(_visible_frame(got), _visible_frame(want))
    # the reference's loader reads the port's lineage to the same table
    same = RefSession.for_nds()
    ref_core.load_warehouse(ref_power.SUITE, same, data["port"]["wh"],
                            tables=[table])
    _assert_same_arrays(got, same.tables[table])
    assert (delta.state_of(got).content_digest()
            == ref_delta.state_of(same.tables[table]).content_digest())


@pytest.fixture(scope="module")
def maintained(data):
    port = _port_session(data["port"]["wh"])
    jax = _ref_session(data["port"]["wh"], ref_factory())
    return _subset_results(port), _subset_results(jax)


@pytest.mark.parametrize("q", SUBSET)
def test_subset_over_the_maintained_warehouse(q, maintained):
    (rows, kernels), (exp_rows, exp_kernels) = maintained
    _assert_same_rows(rows[q], exp_rows[q], f"q{q}")
    assert kernels[q] == exp_kernels[q], q


def test_rollback_restores_the_pre_maintenance_results(data, tmp_path):
    wh = str(tmp_path / "wh")
    shutil.copytree(data["port"]["wh"], wh)
    rollback.main([wh])
    assert SnapshotLog(wh).entries == []
    after, _k = _subset_results(_port_session(wh))
    for q in SUBSET:
        pd.testing.assert_frame_equal(after[q], data["pre"][q])


@pytest.mark.parametrize("flag", ["--resume", "--compact"])
def test_cli_refuses_what_is_not_ported(flag, data, tmp_path, capsys):
    """``--compact`` is refused, naming its item, alone and beside
    ``--resume`` (which is ported: the refusal is the compaction's)."""
    flags = sorted({flag, "--compact"})
    with pytest.raises(SystemExit) as e:
        maintenance.main([str(tmp_path / "wh"), data["refresh"],
                          str(tmp_path / "dm.csv"), *flags])
    assert e.value.code == 2
    assert "ROADMAP Queue 1 item 6" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "dm.csv")


def test_cli_without_a_card_exits_before_writing(data, tmp_path,
                                                 monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wh = str(tmp_path / "wh")
    shutil.copytree(data["port"]["wh"], wh)
    before = sorted(os.listdir(wh))
    with pytest.raises(SystemExit) as e:
        maintenance.main([wh, data["refresh"], str(tmp_path / "dm.csv")])
    assert e.value.code == 2
    assert sorted(os.listdir(wh)) == before
    assert not os.path.exists(tmp_path / "dm.csv")
