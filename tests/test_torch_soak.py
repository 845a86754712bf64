"""Interrupt a real power run of the port, resume it, and prove nothing
was lost and nothing ran twice: ``tools/soak_check.py``'s smoke
scenarios on the port's NDS power CLI, on torch CPU (``--device cpu``),
at SF0.01 over the port's parquet warehouse, through the same functions
``chip_smoke.py --steps soak`` runs on the card:

1. a SIGTERM drain inside a statement wedged by an injected
   ``stream.query`` hang: exit 75, the statement journaled as aborted and
   not done, then ``--resume``;
2. a kill -9 inside a wedged statement, then ``--resume``.

After each the result digests are a clean run's, each statement
completed once (the journal's starts: the victim twice, every other
statement once), ``merged-power-nds.json`` bills each statement once
and no degradation fired. The maintenance kill: SIGKILL inside
``dml.apply`` of ``LF_SS`` after the commit journal's START mark, then
``--resume`` twice: every refresh function applied once, the second
resume a no-op. Every subprocess runs with ``OMP_NUM_THREADS=1``.
"""

import tests.torch_threads  # noqa: F401  (first: sizes torch's threads)

import os
import subprocess
import sys

import pytest

import chip_smoke
from nds_tpu_torch.nds import gen_data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SF = 0.01
THREADS = {"OMP_NUM_THREADS": "1"}


@pytest.fixture(scope="module")
def warehouse(tmp_path_factory):
    """The port's SF0.01 NDS parquet warehouse and refresh set 1."""
    root = tmp_path_factory.mktemp("soak")
    raw, wh = str(root / "raw"), str(root / "wh")
    gen_data.generate_data_local(SF, 2, raw, workers=2)
    proc = subprocess.run(
        [sys.executable, "-m", "nds_tpu_torch.nds.transcode", raw, wh,
         str(root / "load.txt")], cwd=REPO, capture_output=True, text=True,
        env=tests.torch_threads.subprocess_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    refresh = str(root / "refresh1")
    gen_data.generate_refresh_data(SF, 1, refresh)
    return {"root": root, "wh": wh, "refresh": refresh}


def test_drain_and_kill_resume_to_the_clean_results(warehouse, tmp_path):
    rec = chip_smoke.soak_phase(warehouse["wh"], str(tmp_path), "cpu",
                                env_extra=THREADS)
    order = rec["order"]
    assert order == ["query96", "query7", "query93"]
    drained = rec["sigterm-drain"]
    assert drained["interrupted_rc"] == 75
    assert drained["starts"] == {"query96": [0], "query7": [0, 1],
                                 "query93": [1]}
    killed = rec["kill9"]
    assert killed["interrupted_rc"] == -9
    assert killed["starts"] == {"query96": [0], "query7": [0],
                                "query93": [0, 1]}
    # on the CPU every result is bit for bit the clean run's
    assert drained["float_within"] == killed["float_within"] == []


def test_a_killed_maintenance_round_applies_each_function_once(
        warehouse, tmp_path):
    import shutil
    wh = str(tmp_path / "wh")
    shutil.copytree(warehouse["wh"], wh)
    rec = chip_smoke.soak_maintenance_kill(wh, warehouse["refresh"],
                                           str(tmp_path), "cpu",
                                           env_extra=THREADS)
    assert rec["committed_before"] == ["LF_CR", "LF_CS", "LF_I", "LF_SR"]
    assert rec["resume_commits"] == rec["second_resume_commits"] > 0
