"""The port's bench entry (``nds_tpu_torch/bench.py``) on the CPU.

Held to the root ``bench.py`` (the reference's entry, imported here as
``bench``; it imports no jax at module level): over one seeded bank the
per-leg line, the combined line, the stale line and the ``per_query``
block are the root bench's with ``platform`` and ``device`` added (and
the stale line's note naming the card); ``diff_times`` equals the
reference's; the units and statements of both legs are the root bench's.
Beside them: the table cache reads the reference's files, SIGTERM prints
the combined line and exits 0, no card where ``cuda`` is asked exits 5
(or 4 from a bank) with nothing run, an NDS-H run on the CPU completes
22 of 22 units and banks no device time, and the port's data root is
not the root bench's.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import bench as root_bench
from nds_tpu.obs import analyze as ref_analyze
from nds_tpu_torch import bench as port_bench
from nds_tpu_torch.obs import analyze as port_analyze

REPO = pathlib.Path(__file__).resolve().parent.parent
BOTH = (root_bench, port_bench)
LEGS = ["nds_h", "nds"]
TOTALS = {"nds_h": 22, "nds": 103}
# the keys the port adds to the root bench's combined line
ADDED = ("platform", "device")


def _seeded_bank(seed: int = 5) -> dict:
    """Most units with both times, some with the device time alone."""
    rng = np.random.default_rng(seed)
    bank = {}
    for leg, n in TOTALS.items():
        for q in range(1, n + 1):
            r = rng.random()
            if r < 0.1:
                continue
            entry = {"device_s": float(rng.random() * 2)}
            if r > 0.2:
                entry["cpu_s"] = float(rng.random() * 9)
            bank[(leg, str(q))] = entry
    return bank


@pytest.fixture
def seeded(tmp_path, monkeypatch):
    """Both benches on the same bank, legs, totals and scale factors, their
    baseline a temp BASELINE.json with a per_query map over some of the
    bank's units, their data roots one temp directory."""
    bank = _seeded_bank()
    rng = np.random.default_rng(9)
    base = {f"{leg}:{q}": round(float(r["device_s"] * rng.uniform(0.5, 1.5)),
                                4)
            for (leg, q), r in bank.items() if rng.random() < 0.7}
    base["nds:1000"] = 1.0  # a query the run does not have
    (tmp_path / "BASELINE.json").write_text(json.dumps({"per_query": base}))
    for mod in BOTH:
        monkeypatch.setattr(mod, "BANK", {k: dict(v) for k, v in
                                          bank.items()})
        monkeypatch.setattr(mod, "LEGS", list(LEGS))
        monkeypatch.setattr(mod, "LEG_TOTALS", dict(TOTALS))
        monkeypatch.setattr(mod, "SF_H", 1.0)
        monkeypatch.setattr(mod, "SF_DS", 1.0)
        monkeypatch.setattr(mod, "DATA_ROOT", str(tmp_path))
    monkeypatch.setattr(root_bench, "HERE", str(tmp_path))
    monkeypatch.setattr(port_bench, "BASELINE",
                        str(tmp_path / "BASELINE.json"))
    monkeypatch.setattr(port_bench, "DEVICE", "cuda")
    monkeypatch.setattr(port_bench, "CARD", "NVIDIA H100 80GB HBM3, 700.00 W")
    return tmp_path


def test_root_bench_imports_no_jax():
    code = ("import sys, bench; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib'))]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("leg", LEGS)
def test_leg_line_equals_the_root_bench(seeded, leg):
    name = root_bench._metric_name(leg)
    assert port_bench._metric_name(leg) == name
    assert port_bench._leg_line(leg, name) == root_bench._leg_line(leg, name)


def test_combined_line_equals_the_root_bench(seeded):
    got = port_bench._combined_dict()
    exp = root_bench._combined_dict()
    assert got["platform"] == "cuda"
    assert got["device"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert {k: v for k, v in got.items() if k not in ADDED} == exp
    assert set(got) == set(exp) | set(ADDED)
    # the per_query block compared the baseline, with regressions found
    assert exp["per_query"]["baseline_compared"] > 0
    assert exp["per_query"]["worst_regressions"]
    assert json.loads(port_bench._combined_line()) == got


def test_per_query_block_equals_the_root_bench(seeded):
    assert port_bench._per_query_block() == root_bench._per_query_block()


@pytest.mark.parametrize("where", ["same sf", "another sf"])
def test_stale_line_equals_the_root_bench(seeded, monkeypatch, capsys,
                                          where):
    """Banks of earlier card runs (at the bench's SF, or only at another
    one, read as a fallback) give the root bench's stale line, its note
    naming the CUDA device."""
    rng = np.random.default_rng(3)
    sf = "1" if where == "same sf" else "0.3"
    for leg, n in TOTALS.items():
        times = {str(q): float(rng.random()) for q in range(1, n + 1)}
        cpu = {q: t * 3 for q, t in times.items()}
        (seeded / f"device_times_{leg}_sf{sf}.json").write_text(
            json.dumps({"rows": None, "times": times}))
        (seeded / f"cpu_times_{leg}_sf{sf}.json").write_text(
            json.dumps({"rows": None, "times": cpu}))
    lines = []
    for mod in BOTH:
        monkeypatch.setattr(mod, "BANK", {})
        assert mod._emit_stale_from_banks()
        lines.append(json.loads(capsys.readouterr().out.strip()
                                .splitlines()[-1]))
    exp, got = lines
    assert got["stale_device_times"] is True
    assert ("stale_fallback_sf" in got) == (where == "another sf")
    assert "CUDA device unreachable" in got["note"]
    assert {k: v for k, v in got.items() if k not in ADDED + ("note",)} \
        == {k: v for k, v in exp.items() if k != "note"}


@pytest.mark.parametrize("seed", range(6))
def test_diff_times_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    names = [f"q{i}" for i in range(40)]
    base = {q: float(rng.choice([0.0, -1.0, 10.0, rng.random() * 900]))
            for q in names if rng.random() < 0.8}
    cur = {q: float(rng.random() * 900) for q in names if rng.random() < 0.8}
    pct, abs_ms = float(rng.choice([5.0, 10.0])), float(rng.choice([0, 50]))
    assert port_analyze.diff_times(base, cur, pct, abs_ms) \
        == ref_analyze.diff_times(base, cur, pct, abs_ms)


@pytest.mark.parametrize("leg", LEGS)
def test_leg_units_equal_the_root_bench(leg):
    got = port_bench._leg_units(leg)
    assert got == root_bench._leg_units(leg)
    assert len(got) == TOTALS[leg]
    assert all(stmts for _q, stmts in got)


def _tables(mod_host_table, schemas, gen, sf):
    return {t: mod_host_table.from_arrays(t, schemas[t], gen.gen_table(t, sf))
            for t in ("nation", "region", "supplier", "customer")}


def _assert_tables_equal(got, exp):
    assert set(got) == set(exp)
    for name, t in exp.items():
        g = got[name]
        assert g.name == t.name and list(g.columns) == list(t.columns)
        for c, col in t.columns.items():
            gc = g.columns[c]
            np.testing.assert_array_equal(gc.values, col.values)
            assert (gc.dictionary is None) == (col.dictionary is None)
            if col.dictionary is not None:
                assert list(gc.dictionary) == list(col.dictionary)
            assert (gc.null_mask is None) == (col.null_mask is None)
            if col.null_mask is not None:
                np.testing.assert_array_equal(gc.null_mask, col.null_mask)


def test_table_cache_round_trips_and_reads_the_reference_files(tmp_path):
    from nds_tpu.datagen import tpch as ref_gen
    from nds_tpu.io import host_table as ref_ht
    from nds_tpu.io import table_cache as ref_cache
    from nds_tpu.nds_h.schema import get_schemas as ref_schemas
    from nds_tpu_torch.datagen import tpch as gen
    from nds_tpu_torch.io import host_table
    from nds_tpu_torch.io import table_cache
    from nds_tpu_torch.nds_h.schema import get_schemas

    schemas = get_schemas()
    tables = _tables(host_table, schemas, gen, 0.01)
    table_cache.save_tables(str(tmp_path / "port"), tables)
    part = {t: schemas[t] for t in tables}
    _assert_tables_equal(table_cache.load_tables(str(tmp_path / "port"),
                                                 part), tables)
    # a missing table makes the cache stale
    assert table_cache.load_tables(str(tmp_path / "port"), schemas) is None
    ref = _tables(ref_ht, ref_schemas(), ref_gen, 0.01)
    ref_cache.save_tables(str(tmp_path / "ref"), ref)
    _assert_tables_equal(table_cache.load_tables(str(tmp_path / "ref"),
                                                 part), tables)


def test_sigterm_prints_the_combined_line_and_exits_0(seeded, monkeypatch,
                                                      capsys):
    monkeypatch.setattr(port_bench, "_done", False)
    with pytest.raises(SystemExit) as exc:
        port_bench._on_term(15, None)
    assert exc.value.code == 0
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert line == port_bench._combined_dict()
    assert line["queries_total"] == 125
    assert 0 < line["queries_completed"] < 125
    assert "signal 15" in captured.err


def _run_bench(env_extra: dict, data: pathlib.Path, timeout: int = 240):
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update({"BENCH_DATA": str(data), **env_extra})
    proc = subprocess.run([sys.executable, "-m", "nds_tpu_torch.bench"],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    return proc, (json.loads(lines[-1]) if lines else None)


@pytest.mark.parametrize("banked", [False, True])
def test_no_card_runs_nothing(tmp_path, banked):
    """``BENCH_DEVICE=cuda`` (the default) with no card: exit 5 with
    ``device_unreachable``, or 4 with ``stale_device_times`` from a bank of
    an earlier card run; no data is generated and no unit runs."""
    if banked:
        (tmp_path / "device_times_nds_h_sf1.json").write_text(json.dumps(
            {"rows": None, "times": {"1": 0.5, "2": 0.25}}))
        (tmp_path / "cpu_times_nds_h_sf1.json").write_text(json.dumps(
            {"rows": None, "times": {"1": 2.0, "2": 1.0}}))
    before = sorted(os.listdir(tmp_path))
    # no card, wherever this runs
    proc, line = _run_bench({"CUDA_VISIBLE_DEVICES": ""}, tmp_path)
    assert sorted(os.listdir(tmp_path)) == before
    assert line["platform"] == "cuda" and line["device"] is None
    assert line["queries_total"] == 125
    assert "[bench] nds_h q" not in proc.stderr
    if banked:
        assert proc.returncode == port_bench.EXIT_STALE_METRIC
        assert line["stale_device_times"] is True
        assert line["queries_completed"] == 2
        assert line["value"] == 0.75 and line["vs_baseline"] == 4.0
    else:
        assert proc.returncode == port_bench.EXIT_NO_METRIC
        assert line["device_unreachable"] is True
        assert line["queries_completed"] == 0


def test_nds_h_leg_on_the_cpu_end_to_end(tmp_path):
    proc, line = _run_bench({"BENCH_DEVICE": "cpu", "BENCH_LEGS": "nds_h",
                             "BENCH_SF": "0.01"}, tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert line["metric"] == "nds+nds_h_power_total"
    assert line["queries_completed"] == line["queries_total"] == 22
    assert line["platform"] == "cpu" and line["device"] is None
    leg = line["legs"]["nds_h_sf0.01_power_total"]
    assert leg["queries_completed"] == 22 and leg["value"] > 0
    assert len(line["per_query"]["times"]) == 22
    files = os.listdir(tmp_path)
    assert "cpu_times_nds_h_sf0.01.json" in files
    assert not [f for f in files if f.startswith("device_times_")]
    # every unit printed its partial line, then the final one
    assert len(proc.stdout.strip().splitlines()) == 23


def test_data_roots_are_apart():
    """Without BENCH_DATA the port's data root is its own directory, where
    the root bench's device-time banks (TPU times) are never found."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    code = ("import bench, nds_tpu_torch.bench as p; "
            "print(bench.DATA_ROOT); print(p.DATA_ROOT); "
            "print(bench._dev_bank_path('nds_h')); "
            "print(p._dev_bank_path('nds_h'))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    root, port, root_bank, port_bank = proc.stdout.split()
    assert port != root
    assert os.path.dirname(port_bank) == port
    assert os.path.dirname(root_bank) == root != port
