"""Package rules of the PyTorch/CUDA port (``nds_tpu_torch``).

- Importing every module of the port loads neither ``jax`` nor any
  ``nds_tpu`` module (checked in a fresh interpreter), and no source of
  the port or ``chip_smoke.py`` imports them.
- The card is the default and is never swapped for the CPU: without a
  CUDA device ``make_device_factory()`` raises, and the kernel loader
  raises instead of handing back the plain versions. A kernel wrapper
  given tensors on a device that is neither the CPU nor CUDA raises.
- The distributed entry points (``nds_tpu_torch/parallel/``) default to
  the card too: without one, ``make_distributed_factory()`` and
  ``make_mesh()`` raise ``NoCudaDevice`` before any world starts, and a
  mesh of more than one rank needs a world that was initialized.
- Integer arithmetic on scaled decimals floors like the reference's on
  negative values (``//`` in rescales and casts, ``%``).
- The modules of each slice are part of the port (the resilience layer
  and the orchestrators since ROADMAP Queue 1 items 15 and 17, with the
  bench YAMLs).
"""

import tests.torch_threads  # noqa: F401  (first: sizes torch's threads)

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "nds_tpu_torch"


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"mods = {_port_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'nds_tpu' or m.startswith('nds_tpu.'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=tests.torch_threads.subprocess_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 20


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("rel", ["nds_tpu_torch", "chip_smoke.py"])
def test_no_source_imports_jax_or_the_jax_package(rel):
    root = REPO / rel
    files = sorted(root.rglob("*.py")) if root.is_dir() else [root]
    assert files
    bad = []
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "nds_tpu"):
                bad.append(f"{f.relative_to(REPO)}: {mod}")
    assert not bad, bad


def test_default_device_is_the_card_and_raises_without_one(monkeypatch):
    from nds_tpu_torch.device import NoCudaDevice, resolve_device
    from nds_tpu_torch.engine.device_exec import make_device_factory
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDevice):
        make_device_factory()
    with pytest.raises(NoCudaDevice):
        resolve_device("cuda")
    assert make_device_factory(device="cpu").device == torch.device("cpu")


def test_parallel_modules_are_part_of_the_port():
    mods = _port_modules()
    for m in ("mesh", "multihost", "exchange", "dist_exec"):
        assert f"nds_tpu_torch.parallel.{m}" in mods


def test_scheduler_and_throughput_modules_are_part_of_the_port():
    """The modules of ROADMAP Queue 1 item 4, which the import check
    above and the source scan cover with the rest."""
    mods = _port_modules()
    for m in ("analysis.plan_verify", "engine.scheduler", "obs.memwatch",
              "resilience.faults", "resilience.retry", "resilience.journal",
              "nds.throughput", "nds_h.throughput"):
        assert f"nds_tpu_torch.{m}" in mods


def test_maintenance_modules_are_part_of_the_port():
    """The modules of ROADMAP Queue 1 item 5 (DML and the maintenance
    phase), which the import check and the source scan cover with the
    rest, and the refresh functions' SQL shipped beside them."""
    mods = _port_modules()
    for m in ("engine.dml", "columnar.delta", "io.snapshots",
              "datagen.tpcds_refresh", "nds.maintenance", "nds.rollback"):
        assert f"nds_tpu_torch.{m}" in mods
    ref = REPO / "nds_tpu" / "nds" / "data_maintenance"
    sql = sorted(p.name for p in (PORT / "nds" / "data_maintenance").glob(
        "*.sql"))
    assert sql == sorted(p.name for p in ref.glob("*.sql"))
    assert len(sql) == 11
    for name in sql:
        assert (PORT / "nds" / "data_maintenance" / name).read_bytes() == (
            ref / name).read_bytes(), name


def test_resilience_and_orchestrator_modules_are_part_of_the_port():
    """The modules of ROADMAP Queue 1 items 15 (the resilience layer) and
    17 (the orchestrators), which the import check and the source scan
    cover with the rest, and the bench YAMLs shipped beside them, which
    name none of the keys the port refuses."""
    import yaml

    from nds_tpu_torch.nds_h.bench import NOT_PORTED
    mods = _port_modules()
    for m in ("resilience.faults", "resilience.journal", "resilience.drain",
              "resilience.watchdog", "resilience.supervise", "nds.bench",
              "nds_h.bench"):
        assert f"nds_tpu_torch.{m}" in mods
    for name in ("bench_nds.yml", "bench_nds_h.yml"):
        cfg = yaml.safe_load((PORT / "configs" / name).read_text())
        assert cfg["backend"] == "gpu" and "device" not in cfg, name
        assert not set(cfg) & set(NOT_PORTED), name
    assert "recursive-include nds_tpu_torch/configs *.yml" in (
        REPO / "MANIFEST.in").read_text()


def test_distributed_entry_points_raise_without_a_card(monkeypatch):
    import torch.distributed as dist

    from nds_tpu_torch.device import NoCudaDevice
    from nds_tpu_torch.parallel.dist_exec import make_distributed_factory
    from nds_tpu_torch.parallel.mesh import make_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    started = dist.is_initialized()
    with pytest.raises(NoCudaDevice):
        make_distributed_factory()
    if not started:
        with pytest.raises(NoCudaDevice):
            make_mesh()
        # a world of several ranks is never started here
        with pytest.raises(ValueError):
            make_mesh(4, device="cpu")
    assert dist.is_initialized() == started


def test_kernel_loader_raises_without_cuda(monkeypatch):
    from nds_tpu_torch.engine import cuda_build
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    for name in cuda_build.SIGNATURES:
        with pytest.raises(cuda_build.CudaBuildError):
            cuda_build.library(name)


def test_wrappers_refuse_other_devices():
    from nds_tpu_torch.engine import kernels as KX
    k = torch.zeros(4, dtype=torch.int32, device="meta")
    ok = torch.zeros(4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        KX.bitmask_semi(k, ok, k, ok, 0, 4)
    with pytest.raises(ValueError):
        KX.direct_lookup_join(k, ok, torch.zeros(4, dtype=torch.int32),
                              torch.zeros(4, dtype=torch.bool), 0, 4)


def test_negative_decimal_floor_div_and_mod_match_reference():
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from nds_tpu.engine import device_exec as ref
    from nds_tpu_torch.engine import device_exec as port
    vals = np.array([-1001, -999, -100, -1, 0, 1, 99, 100, 1001,
                     -123456789], dtype=np.int64)
    t = torch.from_numpy(vals)
    for from_s, to_s in ((2, 0), (4, 2), (2, 1), (0, 2)):
        np.testing.assert_array_equal(
            port._rescale(t, from_s, to_s).numpy(),
            np.asarray(ref._rescale(jnp.asarray(vals), from_s, to_s)))
    for m in (7, -7, 100):
        mod = np.full_like(vals, m)
        np.testing.assert_array_equal(
            port._apply("%", t, torch.from_numpy(mod)).numpy(),
            np.asarray(ref._apply("%", jnp.asarray(vals),
                                  jnp.asarray(mod))))
    days = np.array([-719468, -1, 0, 59, 10957, 19000, 47482],
                    dtype=np.int32)
    for got, exp in zip(port._epoch_days_to_civil(torch.from_numpy(days)),
                        ref._epoch_days_to_civil(jnp.asarray(days))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


def test_from_reference_rejects_a_schema_mismatch():
    from nds_tpu.io.host_table import HostColumn, HostTable
    from nds_tpu.nds_h.schema import get_schemas
    from nds_tpu_torch.io.host_table import from_reference
    schema = get_schemas()["region"]
    cols = {f.name: HostColumn(f.dtype, np.zeros(3, dtype=np.int32))
            for f in schema}
    first = schema.fields[0]
    cols[first.name] = HostColumn(get_schemas()["orders"].fields[-1].dtype,
                                  np.zeros(3, dtype=np.int32))
    with pytest.raises(ValueError):
        from_reference(HostTable("region", schema, cols))
