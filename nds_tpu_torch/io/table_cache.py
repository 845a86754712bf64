"""Disk persistence for HostTables (one .npz per table).

Port copy of ``nds_tpu/io/table_cache.py``, imports rewritten to
``nds_tpu_torch``. Lets drivers generate a scale factor once and reuse
it across runs: the port's ``bench.py`` never regenerates data it
already has. Two hooks of the reference are trimmed, as the columnar
copies trimmed ``manifest_encodings``:

- the ``io/integrity.py`` digests (a save records the file's digest in
  the directory's manifest, a load verifies it): the port has no
  ``integrity`` module yet, so a file is read as it is;
- the columnar store's manifest (a save under an active mode records the
  table's encodings, a load seeds the per-column spec memo from them):
  the port derives each column's encoding at upload, as the reference
  does when the manifest has none.

The files are the reference's: a table saved by either package loads in
the other.
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
    return path


def load_table(dirpath: str, name: str, schema: Schema) -> HostTable | None:
    path = os.path.join(dirpath, f"{name}.npz")
    if not os.path.exists(path):
        return None
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
