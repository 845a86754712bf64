"""External TPC tool wrappers: dsdgen/dsqgen (TPC-DS), dbgen/qgen (TPC-H).

Port copy of ``nds_tpu/datagen/toolwrap.py`` (standard library only):
the same command lines, environment and file moves.

The TPC toolkits are licensed and are NOT vendored — the user downloads
them and this module builds/patches/drives them, mirroring the
reference's stance (`nds/tpcds-gen/Makefile:30-38` patches then builds;
`nds/nds_gen_data.py:211-222` shells out per chunk;
`nds/nds_gen_query_stream.py:57-70` drives dsqgen). Hadoop-MR fan-out
(`GenTable.java:188-279`) is replaced by local process fan-out — same
per-(chunk, table) command lines, no cluster dependency.

Patches are applied from a caller-supplied directory (e.g. the
spark-rapids-benchmarks checkout's ``tpcds-gen/patches``); they are not
shipped here for the same licensing reason the tools aren't.
"""

from __future__ import annotations

import os
import subprocess


class ToolError(RuntimeError):
    pass


def apply_patches(tools_dir: str, patches_dir: str) -> list[str]:
    """Apply every .patch in patches_dir to the TPC toolkit source with
    ``patch -p1`` (idempotent: already-applied patches are skipped via
    ``--forward``). Returns the list of applied patch files."""
    applied = []
    for fname in sorted(os.listdir(patches_dir)):
        if not fname.endswith(".patch"):
            continue
        path = os.path.join(patches_dir, fname)
        proc = subprocess.run(
            ["patch", "-p1", "--forward", "-i", path],
            cwd=tools_dir, capture_output=True, text=True)
        if proc.returncode == 0:
            applied.append(fname)
        elif "Reversed (or previously applied)" not in proc.stdout:
            raise ToolError(
                f"patch {fname} failed:\n{proc.stdout}\n{proc.stderr}")
    return applied


def build_tools(tools_dir: str, patches_dir: str | None = None) -> None:
    """Patch (optionally) and ``make`` the toolkit in its tools/ dir."""
    if patches_dir:
        apply_patches(tools_dir, patches_dir)
    make_dir = os.path.join(tools_dir, "tools")
    if not os.path.isdir(make_dir):
        make_dir = tools_dir
    proc = subprocess.run(["make"], cwd=make_dir, capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise ToolError(f"make failed in {make_dir}:\n{proc.stderr[-2000:]}")


def _fan_out(cmds: list[list[str]], cwd: str, env: dict) -> None:
    procs = [subprocess.Popen(c, cwd=cwd, env=env) for c in cmds]
    rcs = [p.wait() for p in procs]
    if any(rcs):
        raise ToolError(f"tool chunks failed: {rcs}")


def run_dsdgen(dsdgen_path: str, scale: int, parallel: int, data_dir: str,
               update: int | None = None) -> None:
    """One dsdgen process per child chunk (the reference mapper command,
    `GenTable.java:233-279`: ``dsdgen -scale N -parallel P -child C``)."""
    os.makedirs(data_dir, exist_ok=True)
    tool_dir = os.path.dirname(os.path.abspath(dsdgen_path))
    env = dict(os.environ)
    cmds = []
    for child in range(1, parallel + 1):
        cmd = [dsdgen_path, "-scale", str(scale), "-dir", data_dir,
               "-force", "Y"]
        if parallel > 1:
            cmd += ["-parallel", str(parallel), "-child", str(child)]
        if update is not None:
            cmd += ["-update", str(update)]
        cmds.append(cmd)
    _fan_out(cmds, tool_dir, env)
    _move_into_table_dirs(data_dir)


def run_dbgen(dbgen_path: str, scale: int, parallel: int,
              data_dir: str) -> None:
    """One dbgen process per chunk (`nds-h/nds_h_gen_data.py:90-95`:
    ``dbgen -s N -C P -S C``)."""
    os.makedirs(data_dir, exist_ok=True)
    tool_dir = os.path.dirname(os.path.abspath(dbgen_path))
    env = dict(os.environ, DSS_PATH=data_dir)
    cmds = []
    for step in range(1, parallel + 1):
        cmd = [dbgen_path, "-s", str(scale), "-f"]
        if parallel > 1:
            cmd += ["-C", str(parallel), "-S", str(step)]
        cmds.append(cmd)
    _fan_out(cmds, tool_dir, env)
    _move_into_table_dirs(data_dir)


def _move_into_table_dirs(data_dir: str) -> None:
    """dsdgen/dbgen drop table_N_M.dat / table.tbl.N files flat; the
    harness layout is one directory per table
    (`nds/nds_gen_data.py:86-117` move step)."""
    for fname in sorted(os.listdir(data_dir)):
        path = os.path.join(data_dir, fname)
        if not os.path.isfile(path):
            continue
        base = fname.split(".")[0]          # table.tbl.3 -> table
        parts = base.split("_")
        while parts and parts[-1].isdigit():  # table_3_8 -> table
            parts.pop()
        table = "_".join(parts)
        if not table:
            continue
        tdir = os.path.join(data_dir, table)
        os.makedirs(tdir, exist_ok=True)
        os.replace(path, os.path.join(tdir, fname))


def run_dsqgen(dsqgen_path: str, template_dir: str, output_dir: str,
               scale: int = 1, streams: int | None = None,
               template: str | None = None,
               dialect: str = "spark",
               rngseed: int | None = None) -> None:
    """Drive dsqgen to emit one query or N permuted streams
    (`nds/nds_gen_query_stream.py:57-88`)."""
    os.makedirs(output_dir, exist_ok=True)
    cmd = [dsqgen_path,
           "-template_dir", template_dir,
           "-input", os.path.join(template_dir, "templates.lst"),
           "-scale", str(scale),
           "-directory", template_dir,
           "-dialect", dialect,
           "-output_dir", output_dir]
    if template:
        cmd += ["-template", template]
    else:
        cmd += ["-streams", str(streams or 1)]
    if rngseed is not None:
        cmd += ["-rngseed", str(rngseed)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise ToolError(f"dsqgen failed:\n{proc.stderr[-2000:]}")


def run_qgen(qgen_path: str, query_dir: str, output_dir: str,
             scale: int = 1, streams: int = 1) -> None:
    """Drive TPC-H qgen per stream with DSS_QUERY pointing at the patched
    query templates (`nds-h/nds_h_gen_query_stream.py:60-81`)."""
    os.makedirs(output_dir, exist_ok=True)
    env = dict(os.environ, DSS_QUERY=query_dir)
    tool_dir = os.path.dirname(os.path.abspath(qgen_path))
    for i in range(streams):
        cmd = [qgen_path, "-s", str(scale)]
        if i:
            cmd += ["-p", str(i)]
        proc = subprocess.run(cmd, env=env, cwd=tool_dir,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise ToolError(f"qgen stream {i} failed:\n{proc.stderr}")
        out = os.path.join(output_dir, f"stream_{i}.sql")
        with open(out, "w") as f:
            f.write(proc.stdout)
