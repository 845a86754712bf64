"""Query-result Parquet IO for differential validation.

Port copy of ``nds_tpu/io/result_io.py``: a power run saves each query's
result as ``<output_prefix>/<query>/part-0.parquet`` and the validators
read two runs' files back. The files are the reference's, column for
column (decimals as float64, dates as date32, strings as strings, a
repeated output name suffixed ``#<position>``), so either package reads
the other's. pyarrow is imported inside the functions that write and
read: a run without ``--output_prefix`` never needs it.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from nds_tpu_torch.engine.cpu_exec import ResultTable
from nds_tpu_torch.engine.types import DateType, DecimalType


def result_to_arrow(result: ResultTable):
    import pyarrow as pa
    arrays = []
    names = []
    for i, (name, arr, dt, valid) in enumerate(zip(
            result.names, result.cols, result.dtypes, result.valids)):
        names.append(f"{name}#{i}" if result.names.count(name) > 1 else name)
        mask = None if valid is None else ~np.asarray(valid)
        if isinstance(dt, DecimalType):
            vals = np.asarray(arr, dtype=np.float64) / 10 ** dt.scale
            arrays.append(pa.array(vals, mask=mask))
        elif isinstance(dt, DateType):
            arrays.append(pa.array(
                np.asarray(arr, dtype=np.int32), type=pa.int32(),
                mask=mask).cast(pa.date32()))
        elif arr.dtype == object:
            arrays.append(pa.array(
                [None if (mask is not None and mask[j]) else str(arr[j])
                 for j in range(len(arr))], type=pa.string()))
        else:
            arrays.append(pa.array(arr, mask=mask))
    return pa.Table.from_arrays(arrays, names=names)


def write_result(result: ResultTable, out_dir: str) -> str:
    import pyarrow.parquet as pq
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "part-0.parquet")
    pq.write_table(result_to_arrow(result), path)
    return path


def result_digest(result) -> str | None:
    """Stable sha256 (hex, 16 chars) over a ResultTable's schema +
    values + null masks: the per-query fingerprint a summary records.
    None for resultless statements or anything that does not quack like
    a ResultTable."""
    if result is None or not hasattr(result, "cols"):
        return None
    h = hashlib.sha256()
    try:
        for name, arr, dt, valid in zip(result.names, result.cols,
                                        result.dtypes, result.valids):
            h.update(f"{name}|{dt}|".encode())
            a = np.asarray(arr)
            if a.dtype == object:
                mask = None if valid is None else ~np.asarray(valid)
                for j in range(len(a)):
                    if mask is not None and mask[j]:
                        h.update(b"\x00N")
                    else:
                        h.update(str(a[j]).encode())
                    h.update(b"\x1f")
            else:
                h.update(np.ascontiguousarray(a).tobytes())
            if valid is not None:
                h.update(np.ascontiguousarray(
                    np.asarray(valid, dtype=np.uint8)).tobytes())
            h.update(b"\x1e")
    except Exception:  # noqa: BLE001 - a digest must never fail a query
        return None
    return h.hexdigest()[:16]


def read_result(out_dir: str):
    """-> pandas DataFrame (dates as date32 -> object, fine for diffing)."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    paths = sorted(os.path.join(out_dir, f) for f in os.listdir(out_dir)
                   if f.endswith(".parquet"))
    return pa.concat_tables([pq.read_table(p) for p in paths]).to_pandas()
