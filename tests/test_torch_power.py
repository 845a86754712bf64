"""The port's power loop (``nds_tpu_torch/utils/power_core.py``) against
the JAX package's, on the same raw warehouse.

Both packages run stream 0 of a suite from the port's generated SF0.01
raw data: the reference on backend ``tpu`` (jax on the CPU), the port on
backend ``gpu`` with ``engine.device`` ``cpu``. NDS-H runs ``query1``,
q15's three parts and ``query21`` (K4, K3, the view lifecycle); NDS runs
``query96``, ``query7`` and ``query93``. For each suite:

- the time logs have the same rows in the same order (only the times
  differ);
- the summary files are named by the same pattern;
- each summary has the reference's keys but those in ``NOT_YET_PORTED``
  (with the ROADMAP Queue 1 item that brings each back), and no other, and
  the execution pipeline's ``retries``, ``retry_backoff_s``,
  ``placement`` and ``reschedules`` equal the reference's;
- per query the ``kernels`` blocks and the statuses are equal, and the
  port's ``engineTimings`` has compile, execute and materialize times;
- the port's validate CLI and the reference's, over the two runs' result
  files, print MATCH for every compared query and exit 0.

``--placement cpu`` and ``--placement device`` pin every query of an
NDS-H subset on both packages alike. Beside them, on the port alone
(ported from ``tests/test_nds_drivers.py``):
a failing statement never stops the stream (exit 1, 0 with
``--allow_failure``), ``--extra_time_log``, the config layers'
precedence and env substitution; the refusals (a backend the port has
not, ``engine.backend=tpu`` among them, raises; without a card and without ``--device cpu`` the CLI exits
non-zero and writes nothing); and the slack retry: both executors start
q4 (a ``Join.partitioned`` plan) from the same small slack and report
``CompletedWithTaskFailures`` with the same exception text.
"""

import tests.torch_threads  # noqa: F401  (first: sizes torch's threads)

import json
import os
import pathlib
import re
import subprocess
import sys
import types

import pytest

from nds_tpu.engine.device_exec import DeviceExecutor as RefExecutor
from nds_tpu.nds import power as ref_nds_power
from nds_tpu.nds import validate as ref_nds_validate
from nds_tpu.nds_h import power as ref_h_power
from nds_tpu.nds_h import validate as ref_h_validate
from nds_tpu.utils import power_core as ref_core
from nds_tpu.utils.config import EngineConfig as RefConfig
from nds_tpu_torch.engine.device_exec import DeviceExecutor
from nds_tpu_torch.nds import gen_data as nds_gen
from nds_tpu_torch.nds import power as nds_power
from nds_tpu_torch.nds import streams as nds_streams
from nds_tpu_torch.nds import validate as nds_validate
from nds_tpu_torch.nds_h import gen_data as h_gen
from nds_tpu_torch.nds_h import power as h_power
from nds_tpu_torch.nds_h import streams as h_streams
from nds_tpu_torch.nds_h import validate as h_validate
from nds_tpu_torch.utils import power_core
from nds_tpu_torch.utils.config import EngineConfig
from nds_tpu_torch.utils.timelog import TimeLog

REPO = pathlib.Path(__file__).resolve().parent.parent
SF = 0.01
SUBSETS = {
    "nds_h": ["query1", "query15_part1", "query15_part2", "query15_part3",
              "query21"],
    "nds": ["query96", "query7", "query93"],
}
# (port suite, reference suite, port validate, reference validate)
SUITES = {"nds_h": (h_power.SUITE, ref_h_power.SUITE, h_validate,
                    ref_h_validate),
          "nds": (nds_power.SUITE, ref_nds_power.SUITE, nds_validate,
                  ref_nds_validate)}
# summary keys the reference writes and the port does not yet, with the
# ROADMAP Queue 1 item that brings each back
NOT_YET_PORTED = {
    "spans": "item 7 (observability)",
    "metrics": "item 7 (observability)",
    "memory": "item 7 (observability)",
    "cost": "item 7 (observability)",
    "telemetry": "item 7 (observability)",
    "cache": "none: a CUDA graph does not outlive its process",
}
NAME_RE = re.compile(r"^power-(?P<suite>nds_h|nds)-(?P<platform>[a-z]+)-"
                     r"(?P<backend>[a-z]+)-\d+-(?P<query>query\d+(_part\d)?)"
                     r"-\d+\.json$")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The port's SF0.01 raw warehouse (2 chunks) and stream 0 of each
    suite."""
    root = tmp_path_factory.mktemp("power")
    out = {"root": root}
    for suite, gen, streams in (("nds_h", h_gen, h_streams),
                                ("nds", nds_gen, nds_streams)):
        raw = str(root / f"raw_{suite}")
        gen.generate_data_local(SF, 2, raw, workers=2)
        (stream,) = streams.generate_query_streams(
            str(root / f"streams_{suite}"), 1)
        out[suite] = (raw, stream)
    return out


def _port_config(**extra):
    return EngineConfig(overrides={"engine.device": "cpu", **extra})


@pytest.fixture(scope="module", params=list(SUITES))
def runs(request, data):
    """One run of the subset by each package, with time logs, summaries
    and result files."""
    suite = request.param
    port_suite, ref_suite, _pv, _rv = SUITES[suite]
    raw, stream = data[suite]
    out = {"suite": suite, "stream": stream}
    for who, core, st, cfg in (
            ("ref", ref_core, ref_suite,
             RefConfig(overrides={"engine.backend": "tpu"})),
            ("port", power_core, port_suite, _port_config())):
        d = data["root"] / f"{suite}_{who}"
        paths = {"tlog": str(d / "time.csv"), "json": str(d / "json"),
                 "out": str(d / "out")}
        failures = core.run_query_stream(
            st, raw, stream, paths["tlog"], config=cfg, input_format="raw",
            json_summary_folder=paths["json"], output_prefix=paths["out"],
            query_subset=SUBSETS[suite])
        assert failures == 0, who
        paths["summaries"] = _summaries(paths["json"])
        out[who] = paths
    return out


def _summaries(folder: str) -> dict:
    """{file name: summary} of the per-query summaries in a folder."""
    out = {}
    for f in sorted(os.listdir(folder)):
        if NAME_RE.match(f):
            with open(os.path.join(folder, f)) as fh:
                out[f] = json.load(fh)
    return out


def _by_query(run: dict) -> dict:
    return {s["query"]: s for s in run["summaries"].values()}


def test_time_log_has_the_reference_rows(runs):
    got = [q for _a, q, _ms in TimeLog.read(runs["port"]["tlog"])]
    exp = [q for _a, q, _ms in TimeLog.read(runs["ref"]["tlog"])]
    assert got == exp
    assert got[-2:] == ["Power Test Time", "Total Time"]
    port_suite = SUITES[runs["suite"]][0]
    in_stream = port_suite.parse_query_stream(runs["stream"])
    assert [q for q in got if q.startswith("query")] == [
        q for q in in_stream if q in SUBSETS[runs["suite"]]]


def test_summary_files_are_named_as_the_reference_names_them(runs):
    suite = runs["suite"]
    for who, platform, backend in (("ref", "tpu", "tpu"),
                                   ("port", "cpu", "gpu")):
        names = sorted(runs[who]["summaries"])
        assert len(names) == len(SUBSETS[suite]), who
        for name in names:
            m = NAME_RE.match(name)
            assert m["suite"] == suite, name
            assert (m["platform"], m["backend"]) == (platform, backend), name
            assert runs[who]["summaries"][name]["filename"] == name
        assert sorted(NAME_RE.match(n)["query"] for n in names) == sorted(
            SUBSETS[suite])


def test_summary_keys_are_the_reference_keys_less_the_unported(runs):
    ref, port = _by_query(runs["ref"]), _by_query(runs["port"])
    assert sorted(port) == sorted(ref)
    for q, exp in ref.items():
        got = set(port[q])
        assert got == set(exp) - set(NOT_YET_PORTED), q
        assert got <= set(exp), q
        assert set(port[q]["env"]) == set(exp["env"]), q


def test_kernels_status_and_timings_per_query(runs):
    ref, port = _by_query(runs["ref"]), _by_query(runs["port"])
    kernel_queries = 0
    for q, exp in ref.items():
        got = port[q]
        assert got["queryStatus"] == exp["queryStatus"] == ["Completed"], q
        assert got.get("kernels") == exp.get("kernels"), q
        kernel_queries += "kernels" in got
        if "engineTimings" in got:
            for key in ("compile_ms", "execute_ms", "materialize_ms"):
                assert key in got["engineTimings"], (q, key)
        assert got.get("result_digest") is None or len(
            got["result_digest"]) == 16
        conf = got["env"]["engineConf"]
        assert (conf["backend"], conf["device"]) == ("gpu", "cpu"), q
        assert got["env"]["engineVersion"].startswith("torch-"), q
    assert kernel_queries >= 2
    # every statement that returns rows was timed by the device engine
    timed = [q for q, s in port.items() if "result_digest" in s]
    assert timed and all("engineTimings" in port[q] for q in timed)


# the execution pipeline's keys (ROADMAP Queue 1 item 4)
SCHEDULE_KEYS = ("retries", "retry_backoff_s", "placement", "reschedules")


def test_schedule_keys_equal_the_reference(runs):
    """Each summary's retry and placement record equals the reference's:
    ``device`` for every statement that reached an executor, no
    reschedule, no retry."""
    ref, port = _by_query(runs["ref"]), _by_query(runs["port"])
    for q, exp in ref.items():
        assert {k: port[q].get(k) for k in SCHEDULE_KEYS} == {
            k: exp.get(k) for k in SCHEDULE_KEYS}, q
    placed = [s["placement"] for s in port.values() if "placement" in s]
    assert placed and set(placed) == {"device"}


@pytest.mark.parametrize("placement", ["cpu", "device"])
def test_placement_pins_every_query_as_the_reference(placement, data,
                                                     tmp_path):
    """``--placement`` (``engine.placement.force``) on the port's CLI and
    on the reference's loop: the same placement, reason-free record and
    kernel blocks per query (none on the CPU oracle)."""
    raw, stream = data["nds_h"]
    subset = ["query1", "query3"]
    ref_json, port_json = str(tmp_path / "ref"), str(tmp_path / "port")
    assert ref_core.run_query_stream(
        ref_h_power.SUITE, raw, stream, str(tmp_path / "ref.csv"),
        config=RefConfig(overrides={"engine.backend": "tpu",
                                    "engine.placement.force": placement}),
        input_format="raw", json_summary_folder=ref_json,
        query_subset=subset) == 0
    with pytest.raises(SystemExit) as done:
        h_power.main([raw, stream, str(tmp_path / "port.csv"),
                      "--input_format", "raw", "--device", "cpu",
                      "--placement", placement, "--json_summary_folder",
                      port_json, "--query_subset", *subset])
    assert done.value.code == 0
    ref = {s["query"]: s for s in _summaries(ref_json).values()}
    port = {s["query"]: s for s in _summaries(port_json).values()}
    assert sorted(port) == sorted(ref) == subset
    for q, exp in ref.items():
        got = port[q]
        assert got["placement"] == exp["placement"] == placement, q
        assert {k: got.get(k) for k in SCHEDULE_KEYS} == {
            k: exp.get(k) for k in SCHEDULE_KEYS}, q
        assert got.get("kernels") == exp.get("kernels"), q
    # q3's joins stamp kernels on the device engine
    assert any("kernels" in s for s in port.values()) == (
        placement == "device")


@pytest.mark.parametrize("package", ["port", "ref"])
def test_validate_cli_calls_every_query_a_match(package, runs, capsys):
    _ps, _rs, port_validate, ref_validate = SUITES[runs["suite"]]
    validate = port_validate if package == "port" else ref_validate
    with pytest.raises(SystemExit) as done:
        validate.main([runs["ref"]["out"], runs["port"]["out"],
                       runs["stream"], "--ignore_ordering"])
    out = capsys.readouterr().out
    assert done.value.code == 0, out
    compared = [q for q in SUBSETS[runs["suite"]]
                if q not in getattr(validate, "SKIP_QUERIES", set())]
    assert compared
    for q in compared:
        assert f"=== Comparing Query: {q} -> MATCH ===" in out, out


# ----------------------------------------------- the port's CLI alone

def _bad_stream(path: str) -> str:
    """A stream whose first statement does not parse."""
    with open(path, "w") as f:
        f.write("-- Template file: 98\n\nselect broken syntax from "
                "nowhere\n\n-- Template file: 6\n\n"
                + h_streams.render_query(6) + "\n")
    return path


def test_failure_never_aborts_the_stream(data, tmp_path):
    raw, _stream = data["nds_h"]
    bad = _bad_stream(str(tmp_path / "bad.sql"))
    jsons, tlog = str(tmp_path / "json"), str(tmp_path / "t.csv")
    failures = power_core.run_query_stream(
        h_power.SUITE, raw, bad, tlog, config=_port_config(),
        input_format="raw", json_summary_folder=jsons)
    assert failures == 1
    rows = [q for _a, q, _ms in TimeLog.read(tlog)]
    assert "query98" in rows and "query6" in rows  # ran past the failure
    by_query = {s["query"]: s for s in _summaries(jsons).values()}
    assert by_query["query98"]["queryStatus"] == ["Failed"]
    assert by_query["query98"]["exceptions"]
    assert by_query["query6"]["queryStatus"] == ["Completed"]


@pytest.mark.parametrize("allow", [False, True])
def test_exit_code_counts_failures_unless_allowed(allow, data, tmp_path):
    raw, _stream = data["nds_h"]
    bad = _bad_stream(str(tmp_path / "bad.sql"))
    argv = [raw, bad, str(tmp_path / "t.csv"), "--input_format", "raw",
            "--device", "cpu"] + (["--allow_failure"] if allow else [])
    with pytest.raises(SystemExit) as done:
        h_power.main(argv)
    assert done.value.code == (0 if allow else 1)


@pytest.mark.parametrize("case,flag,want", [
    ("recovered", False, 1), ("recovered", True, 0), ("failed", True, 1)])
def test_allow_recovered_passes_only_completed_statements(
        case, flag, want, data, tmp_path, monkeypatch):
    """``--allow_recovered``: q4 at slack 0.0002 completes after one
    slack retry (``CompletedWithTaskFailures``) and exits 0 with the
    flag, 1 without, as the reference's CLI does; a statement that
    failed still exits 1."""
    if case == "recovered":
        monkeypatch.setattr(DeviceExecutor, "DEFAULT_SLACK", 0.0002)
        raw, stream = data["nds"]
        cli = nds_power
        argv = [raw, stream, str(tmp_path / "t.csv"), "--query_subset",
                "query4"]
    else:
        raw, _stream = data["nds_h"]
        cli = h_power
        argv = [raw, _bad_stream(str(tmp_path / "bad.sql")),
                str(tmp_path / "t.csv")]
    argv += ["--input_format", "raw", "--device", "cpu",
             "--json_summary_folder", str(tmp_path / "json")]
    with pytest.raises(SystemExit) as done:
        cli.main(argv + (["--allow_recovered"] if flag else []))
    assert done.value.code == want
    statuses = [s["queryStatus"][-1]
                for s in _summaries(str(tmp_path / "json")).values()]
    assert ("CompletedWithTaskFailures" if case == "recovered"
            else "Failed") in statuses


def test_extra_time_log(data, tmp_path):
    raw, stream = data["nds_h"]
    tlog = str(tmp_path / "t.csv")
    extra = str(tmp_path / "remote" / "t_extra.csv")
    failures = power_core.run_query_stream(
        h_power.SUITE, raw, stream, tlog, config=_port_config(),
        input_format="raw", query_subset=["query6"], extra_time_log=extra)
    assert failures == 0
    assert open(extra).read() == open(tlog).read()


def test_template_and_property_precedence(tmp_path):
    tpl = tmp_path / "t.template"
    tpl.write_text("engine.backend=cpu\nengine.floats=false\n")
    prop = tmp_path / "p.properties"
    prop.write_text("engine.floats=true\n")
    cfg = EngineConfig(str(tpl), str(prop))
    assert cfg.get("engine.backend") == "cpu"
    assert cfg.get_bool("engine.floats") is True
    # the CLI wins over both
    cfg = EngineConfig(str(tpl), str(prop), {"engine.floats": "false"})
    assert cfg.get_bool("engine.floats") is False


def test_env_substitution(tmp_path, monkeypatch):
    tpl = tmp_path / "t.template"
    tpl.write_text("engine.backend=${MY_BACKEND:-cpu}\n")
    monkeypatch.delenv("MY_BACKEND", raising=False)
    assert EngineConfig(str(tpl)).get("engine.backend") == "cpu"
    monkeypatch.setenv("MY_BACKEND", "gpu")
    assert EngineConfig(str(tpl)).get("engine.backend") == "gpu"
    tpl.write_text("engine.device=${NO_SUCH_VARIABLE_SET}\n")
    monkeypatch.delenv("NO_SUCH_VARIABLE_SET", raising=False)
    with pytest.raises(KeyError):
        EngineConfig(str(tpl))


def test_cli_backend_and_device_over_template(tmp_path):
    """A template's engine.backend wins when --backend is absent; an
    explicit --backend or --device overrides it; with no layer setting
    it the defaults, gpu on the card, apply."""
    tpl = tmp_path / "t.template"
    tpl.write_text("engine.backend=cpu\nengine.device=cpu\n")
    args = types.SimpleNamespace(template=str(tpl), property_file=None,
                                 backend=None, device=None)
    assert power_core.config_from_args(args).get("engine.backend") == "cpu"
    args.backend, args.device = "gpu", "cuda"
    cfg = power_core.config_from_args(args)
    assert (cfg.get("engine.backend"), cfg.get("engine.device")) == (
        "gpu", "cuda")
    args = types.SimpleNamespace(template=None, property_file=None,
                                 backend=None, device=None)
    cfg = power_core.config_from_args(args)
    assert (cfg.get("engine.backend"), cfg.get("engine.device")) == (
        "gpu", "cuda")
    assert (EngineConfig().get("engine.backend"),
            EngineConfig().get("engine.device")) == ("gpu", "cuda")


def test_make_session_floats_mode():
    cfg = _port_config(**{"engine.floats": "true"})
    sess = power_core.make_session(nds_power.SUITE, cfg)
    f = sess.catalog.schemas["store_sales"].field("ss_list_price")
    assert f.dtype.name.startswith("float")
    loaded = power_core.suite_schemas(nds_power.SUITE, cfg)
    assert loaded["store_sales"].field(
        "ss_list_price").dtype.name.startswith("float")


@pytest.mark.parametrize("backend", ["tpu", "chunked", "cuda"])
def test_a_backend_the_port_has_not_raises(backend):
    with pytest.raises(ValueError, match="'gpu'"):
        power_core.make_session(
            h_power.SUITE, _port_config(**{"engine.backend": backend}))


def test_cli_without_a_card_exits_before_writing(data, tmp_path):
    raw, stream = data["nds_h"]
    tlog = tmp_path / "t.csv"
    jsons = tmp_path / "json"
    env = tests.torch_threads.subprocess_env(CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "nds_tpu_torch.nds_h.power", raw, stream,
         str(tlog), "--input_format", "raw", "--json_summary_folder",
         str(jsons), "--output_prefix", str(tmp_path / "out")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr, proc.stderr
    assert not tlog.exists() and not jsons.exists()
    assert not (tmp_path / "out").exists()


def test_slack_retry_reports_as_the_reference(data, tmp_path, monkeypatch):
    """q4 at SF0.01: its first partitioned join yields 14 rows from
    50,412 a side, so at slack 0.0002 (a capacity of 10) it overflows
    once and completes at 0.0004."""
    raw, stream = data["nds"]
    monkeypatch.setattr(RefExecutor, "DEFAULT_SLACK", 0.0002)
    monkeypatch.setattr(DeviceExecutor, "DEFAULT_SLACK", 0.0002)
    got = {}
    for who, core, suite, cfg in (
            ("ref", ref_core, ref_nds_power.SUITE,
             RefConfig(overrides={"engine.backend": "tpu"})),
            ("port", power_core, nds_power.SUITE, _port_config())):
        jsons = str(tmp_path / who)
        core.run_query_stream(suite, raw, stream, str(tmp_path / f"{who}.csv"),
                              config=cfg, input_format="raw",
                              json_summary_folder=jsons,
                              query_subset=["query4"])
        (summary,) = _summaries(jsons).values()
        got[who] = summary
    for who in ("ref", "port"):
        assert got[who]["queryStatus"] == ["CompletedWithTaskFailures"], who
        assert "join.partitioned" in got[who]["kernels"], who
    assert got["port"]["exceptions"] == got["ref"]["exceptions"] == [
        "join expansion overflow: retry with slack 0.0004"]
    assert got["port"]["kernels"] == got["ref"]["kernels"]
    assert got["port"]["engineTimings"]["slack_retries"] == 1.0
