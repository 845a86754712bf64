"""Disk persistence for HostTables (one .npz per table).

Port copy of ``nds_tpu/io/table_cache.py``, imports rewritten to
``nds_tpu_torch``. Lets drivers generate a scale factor once and reuse
it across runs: the port's ``bench.py`` never regenerates data it
already has. A save records the file's digest in the directory's
``_manifest.json`` (``io/integrity.py``) and a load verifies it when
verification is on; under an active columnar mode the same manifest
carries the table's encodings, which a load seeds into the per-column
spec memo. The files are the reference's: a table saved by either
package loads in the other.
"""

from __future__ import annotations

import os

import numpy as np

from nds_tpu_torch.engine.types import Schema
from nds_tpu_torch.io.host_table import HostColumn, HostTable


def save_table(dirpath: str, table: HostTable) -> str:
    os.makedirs(dirpath, exist_ok=True)
    payload: dict[str, np.ndarray] = {}
    for name, col in table.columns.items():
        payload[f"{name}::values"] = col.values
        if col.dictionary is not None:
            payload[f"{name}::dict"] = col.dictionary.astype(str)
        if col.null_mask is not None:
            payload[f"{name}::mask"] = col.null_mask
    path = os.path.join(dirpath, f"{table.name}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **payload)
    os.replace(tmp, path)
    # digest into the cache dir's manifest so reuse across runs detects
    # on-disk rot (io/integrity.py; verification gated on load)
    from nds_tpu_torch.io import integrity
    integrity.update_manifest(dirpath, [f"{table.name}.npz"])
    # columnar encoding metadata rides the same manifest (columnar/):
    # the load-time encoding choice round-trips with the
    # artifact instead of being re-derived on every process start
    from nds_tpu_torch import columnar
    if columnar.enabled():
        columnar.manifest_set_encodings(
            dirpath, table.name,
            columnar.table_specs(table))
        integrity.clear_cache()  # the manifest just changed on disk
    return path


def load_table(dirpath: str, name: str, schema: Schema) -> HostTable | None:
    path = os.path.join(dirpath, f"{name}.npz")
    if not os.path.exists(path):
        return None
    from nds_tpu_torch.io import integrity
    integrity.verify_paths([path], name)
    data = np.load(path, allow_pickle=False)
    cols: dict[str, HostColumn] = {}
    for f in schema:
        key = f"{f.name}::values"
        if key not in data:
            return None  # stale cache with a different schema
        dictionary = None
        if f"{f.name}::dict" in data:
            dictionary = data[f"{f.name}::dict"].astype(object)
        mask = data.get(f"{f.name}::mask")
        cols[f.name] = HostColumn(f.dtype, data[key], dictionary, mask)
    # restore persisted encoding choices (written by save_table under
    # an active columnar mode): seeds the per-column spec memo so the
    # executors encode without re-deriving stats — and stale entries
    # (row-count drift, other mode/version) are rejected per column
    from nds_tpu_torch import columnar
    if columnar.enabled():
        persisted = columnar.manifest_encodings(dirpath, name)
        if persisted:
            for cname, spec in persisted.items():
                if cname in cols:
                    columnar.seed_column_spec(cols[cname], spec)
    return HostTable(name, schema, cols)


def save_tables(dirpath: str, tables: dict[str, HostTable]) -> None:
    for t in tables.values():
        save_table(dirpath, t)


def load_tables(dirpath: str,
                schemas: dict[str, Schema]) -> dict[str, HostTable] | None:
    """Load every table or None if any is missing/stale."""
    out: dict[str, HostTable] = {}
    for name, schema in schemas.items():
        t = load_table(dirpath, name, schema)
        if t is None:
            return None
        out[name] = t
    return out
