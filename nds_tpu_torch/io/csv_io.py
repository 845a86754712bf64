"""Raw '|'-delimited text IO (dbgen/dsdgen .tbl/.dat format) and the
warehouse formats (parquet, orc, json, avro).

Port copy of ``nds_tpu/io/csv_io.py``, imports rewritten to
``nds_tpu_torch``. The raw reader is the reference's: ``pyarrow.csv``
with the schema's arrow types and a trailing ``_trailing`` column for
dbgen's trailing '|', zero-byte chunks skipped (the fixed tables' empty
chunks), an empty table when no chunk has rows. The chunk files are
read on a pool of threads (pyarrow releases the interpreter's lock),
and their tables concatenated in the order of ``paths``.

``from_arrow`` gives exactly the reference's ``HostTable`` for any arrow
input. Its string step is native: the dictionary of a column (arrow's
own, or from ``dictionary_encode``) is sorted by
``pyarrow.compute.array_sort_indices``, whose binary order of UTF-8 is
code-point order, the order of the reference's numpy unicode sort, and
stable like it. Only the sorted dictionary becomes Python strings, once.
The columns convert on a pool of threads, and a dictionary of 2**16
entries or more sorts in buckets of its first two bytes, in parallel.

``to_arrow`` (the writers' input) gives string columns as plain arrow
strings where the reference gives dictionary arrays: parquet would
repeat an arrow dictionary whole in every row group and in every
partition band's file. Either package reads either file into the same
table.

Reads fire the ``io.read`` fault point (``resilience/faults.py``) with
the call's paths, then verify digests (``io/integrity.py``, gated by
``NDS_TPU_VERIFY_DIGESTS`` or ``io.verify_digests``).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.csv as pacsv
import pyarrow.parquet as pq

from nds_tpu_torch.engine.types import (
    DateType, DecimalType, FloatType, IntType, Schema, StringType,
)
from nds_tpu_torch.io import integrity
from nds_tpu_torch.io.host_table import HostColumn, HostTable, from_arrays
from nds_tpu_torch.resilience import faults, watchdog

_EPOCH = np.datetime64("1970-01-01", "D")
# threads of the chunk reads, the column conversions and the sorts
_THREADS = max(1, min(8, os.cpu_count() or 1))


def _arrow_read_type(dtype) -> pa.DataType:
    if isinstance(dtype, IntType):
        return pa.int64() if dtype.bits == 64 else pa.int32()
    if isinstance(dtype, FloatType):
        return pa.float64() if dtype.bits == 64 else pa.float32()
    if isinstance(dtype, DecimalType):
        return pa.decimal128(max(dtype.precision, 18), dtype.scale)
    if isinstance(dtype, DateType):
        return pa.date32()
    if isinstance(dtype, StringType):
        return pa.string()
    raise TypeError(f"unsupported dtype {dtype}")


def read_tbl(paths: list[str] | str, name: str, schema: Schema,
             trailing_delimiter: bool = True) -> HostTable:
    """Read one table from one or more '|'-delimited files."""
    if isinstance(paths, str):
        paths = [paths]
    faults.fault_point("io.read", table=name, paths=paths)
    # a flipped bit in a raw chunk fails here with CorruptArtifact,
    # instead of loading wrong rows
    integrity.verify_paths(paths, name)
    names = schema.names + (["_trailing"] if trailing_delimiter else [])
    types = {f.name: _arrow_read_type(f.dtype) for f in schema}
    if trailing_delimiter:
        types["_trailing"] = pa.string()

    def read(p):
        # a heartbeat a file: a many-chunk fact read must not look like a
        # hang to the watchdog
        watchdog.beat("engine", phase="io.read", table=name)
        t = pacsv.read_csv(
            p,
            read_options=pacsv.ReadOptions(column_names=names),
            parse_options=pacsv.ParseOptions(delimiter="|"),
            convert_options=pacsv.ConvertOptions(column_types=types),
        )
        return t.drop(["_trailing"]) if trailing_delimiter else t

    # zero-row chunks are legitimate (fixed tables)
    files = [p for p in paths if os.path.getsize(p)]
    if not files:
        empty = pa.table({f.name: pa.array([], type=_arrow_read_type(
            f.dtype)) for f in schema})
        return from_arrow(name, schema, empty)
    with ThreadPoolExecutor(min(_THREADS, len(files))) as pool:
        tables = list(pool.map(read, files))
    return from_arrow(name, schema, pa.concat_tables(tables))


# a dictionary this large is sorted in buckets of its first two bytes,
# the buckets on a pool of threads (arrow's sort releases the lock)
_BUCKETED_SORT_MIN = 1 << 16


def _sort_indices(d: pa.Array) -> np.ndarray:
    """Stable sort indices of a string array without NULL entries, in
    the binary order of UTF-8 (code-point order)."""
    n = len(d)
    data = d.buffers()[2]
    if n < _BUCKETED_SORT_MIN or data is None or not data.size:
        return pc.array_sort_indices(d).to_numpy()
    off_type = np.int64 if pa.types.is_large_string(d.type) else np.int32
    offs = np.frombuffer(d.buffers()[1], dtype=off_type)[
        d.offset:d.offset + n + 1]
    data = np.frombuffer(data, dtype=np.uint8)
    start, length = offs[:-1], np.diff(offs)
    last = len(data) - 1
    # the first two bytes, a missing one as 0: a smaller key is a
    # smaller string, and equal strings share a key
    key = np.where(length > 0, data[np.minimum(start, last)], 0).astype(
        np.uint16) << 8
    key |= np.where(length > 1, data[np.minimum(start + 1, last)], 0)
    by_key = np.argsort(key, kind="stable")
    ends = np.cumsum(np.bincount(key, minlength=1 << 16))
    # about four buckets a thread, each cut at the end of a key's run
    pieces = 4 * _THREADS
    cuts = ends[np.searchsorted(ends, np.arange(1, pieces) * n // pieces)]
    bounds = [0, *np.unique(cuts[cuts < n]).tolist(), n]

    def sort_bucket(lo, hi):
        idx = by_key[lo:hi]
        return idx[pc.array_sort_indices(d.take(pa.array(idx))).to_numpy()]
    with ThreadPoolExecutor(_THREADS) as pool:
        return np.concatenate(list(pool.map(sort_bucket, bounds[:-1],
                                            bounds[1:])))


def _sorted_strings(arr) -> tuple[np.ndarray, np.ndarray]:
    """(int32 codes, sorted object dictionary) of a string column,
    codes in dictionary order: the reference's ``argsort`` of the
    dictionary as numpy unicode, with a NULL slot's code taken from
    arrow's dictionary entry 0 (``fill_null(0)``, then the remap)."""
    if not pa.types.is_dictionary(arr.type):
        arr = arr.dictionary_encode()
    d = arr.dictionary
    raw_codes = arr.indices.fill_null(0).to_numpy(
        zero_copy_only=False).astype(np.int32)
    # a NULL dictionary entry sorts where the reference's str() puts it
    keys = d.fill_null("None") if d.null_count else d
    data = keys.buffers()[2]
    if data is not None and data.size and not np.frombuffer(
            data, dtype=np.uint8).all():
        # numpy's unicode order ignores trailing NULs ("a\x00" == "a")
        keys = pc.utf8_rtrim(keys, characters="\x00")
    order = _sort_indices(keys)
    remap = np.empty(len(d), dtype=np.int32)
    remap[order] = np.arange(len(d), dtype=np.int32)
    codes = remap[raw_codes] if len(d) else raw_codes
    return codes, d.take(pa.array(order)).to_numpy(zero_copy_only=False)


def _host_column(f, arr) -> HostColumn:
    mask = None
    if arr.null_count:
        mask = arr.is_valid().to_numpy(zero_copy_only=False)
    if isinstance(f.dtype, StringType):
        codes, dictionary = _sorted_strings(arr)
        return HostColumn(f.dtype, codes, dictionary, mask)
    if isinstance(f.dtype, DecimalType):
        s = f.dtype.scale
        if f.dtype.precision <= 15:
            # float64 is exact for <= 15 significant digits: vectorized
            as_f = arr.cast(pa.float64()).to_numpy(zero_copy_only=False)
            ints = np.round(np.nan_to_num(as_f) * 10**s).astype(np.int64)
        else:
            ints = np.array(
                [0 if v is None else int(v.scaleb(s))
                 for v in arr.to_pylist()], dtype=np.int64)
        return HostColumn(f.dtype, ints, None, mask)
    if isinstance(f.dtype, DateType):
        d = arr.cast(pa.int32()).fill_null(0)
        return HostColumn(f.dtype, d.to_numpy(zero_copy_only=False), None,
                          mask)
    if isinstance(f.dtype, (IntType, FloatType)):
        return HostColumn(f.dtype,
                          arr.fill_null(0).to_numpy(zero_copy_only=False),
                          None, mask)
    return HostColumn(f.dtype, arr.to_numpy(zero_copy_only=False), None,
                      mask)


def from_arrow(name: str, schema: Schema, t: pa.Table) -> HostTable:
    """Arrow table -> HostTable, carrying arrow validity bitmaps over as
    engine null masks (True = valid). Null slots are filled with 0/"" in
    the value arrays so downstream numpy code never sees NaN. The
    columns convert on a pool of threads."""
    with ThreadPoolExecutor(_THREADS) as pool:
        cols = list(pool.map(
            lambda f: _host_column(f, t.column(f.name).combine_chunks()),
            schema))
    return HostTable(name, schema, dict(zip(schema.names, cols)))


def to_arrow(table: HostTable) -> pa.Table:
    arrays, names = [], []
    for f in table.schema:
        col = table.columns[f.name]
        names.append(f.name)
        # arrow mask convention: True = NULL (inverse of the engine's)
        amask = None if col.null_mask is None else ~col.null_mask
        if col.is_string:
            # plain strings, where the reference writes a dictionary
            # array: parquet repeats an arrow dictionary whole in every
            # row group and every partition band's file
            arrays.append(pa.array(col.dictionary, type=pa.string()).take(
                pa.array(col.values, type=pa.int32(), mask=amask)))
        elif isinstance(f.dtype, DecimalType):
            s = f.dtype.scale
            target = pa.decimal128(max(f.dtype.precision, 18), s)
            if f.dtype.precision <= 15:
                # exact: |value| < 10^15 so float64 round-trips the cents
                as_f = col.values.astype(np.float64) / 10**s
                arrays.append(
                    pa.array(as_f, mask=amask).cast(target, safe=False))
            else:
                from decimal import Decimal
                vals = [Decimal(int(v)).scaleb(-s) for v in col.values]
                if amask is not None:
                    vals = [None if m else v
                            for v, m in zip(vals, amask)]
                arrays.append(pa.array(vals, type=target))
        elif isinstance(f.dtype, DateType):
            arrays.append(pa.array(col.values, type=pa.int32(),
                                   mask=amask).cast(pa.date32()))
        else:
            arrays.append(pa.array(col.values, mask=amask))
    return pa.Table.from_arrays(arrays, names=names)


def write_parquet(table: HostTable, path: str, compression: str = "snappy",
                  row_group_rows: int = 1 << 20) -> None:
    write_arrow(to_arrow(table), path, "parquet", compression,
                row_group_rows)


def read_parquet(paths: list[str] | str, name: str,
                 schema: Schema) -> HostTable:
    if isinstance(paths, str):
        paths = [paths]
    # ParquetFile, not pq.read_table: read_table infers hive
    # partitioning from `col=value` path segments, which collides with
    # the partition column the transcode layout keeps in every file
    tables = [pq.ParquetFile(p).read() for p in paths]
    return from_arrow(name, schema,
                      pa.concat_tables(tables, promote_options="permissive"))


# the warehouse formats (the upstream transcode writes parquet, orc,
# avro and json, `nds/nds_transcode.py:69-152`; avro through the
# container codec of io/avro_io.py)
FORMAT_EXT = {"parquet": ".parquet", "orc": ".orc", "json": ".json",
              "avro": ".avro"}


def write_arrow(t: pa.Table, path: str, fmt: str = "parquet",
                compression: str = "snappy",
                row_group_rows: int = 1 << 20) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if fmt == "parquet":
        pq.write_table(t, path, compression=compression,
                       row_group_size=row_group_rows)
    elif fmt == "orc":
        import pyarrow.orc as paorc
        cols = []
        for i, f in enumerate(t.schema):
            c = t.column(i)
            if pa.types.is_dictionary(f.type):
                c = c.cast(pa.string())
            cols.append(c)
        paorc.write_table(pa.Table.from_arrays(cols,
                                               names=t.column_names),
                          path, compression=compression)
    elif fmt == "json":
        # JSON-lines records, the layout pyarrow.json reads back; dates
        # as ISO strings, decimals as exact decimal strings
        import json as _json
        with open(path, "w") as f:
            for row in t.to_pylist():
                f.write(_json.dumps(row, default=str) + "\n")
    elif fmt == "avro":
        raise ValueError(
            "avro writes go through write_table (HostTable input); "
            "an arrow Table has no engine schema to map from")
    else:
        raise ValueError(f"unknown output format {fmt!r}")


def write_table(table: HostTable, path: str, fmt: str = "parquet",
                compression: str = "snappy") -> None:
    if fmt == "avro":
        from nds_tpu_torch.io import avro_io
        if compression in (None, "none"):
            codec = "null"
        elif compression == "deflate":
            codec = "deflate"
        elif compression == "snappy":
            # the CLI-wide default targets parquet; the container codec
            # has no snappy, so substitute deflate audibly
            from nds_tpu_torch.utils.report import TaskFailureCollector
            TaskFailureCollector.notify(
                "avro: no snappy codec in this environment, writing "
                "deflate instead")
            codec = "deflate"
        else:
            raise ValueError(
                f"unsupported avro compression {compression!r} "
                f"(available: none, deflate)")
        avro_io.write_avro(table, path, table.schema, codec=codec)
        return
    write_arrow(to_arrow(table), path, fmt, compression)


def read_paths_auto(paths: list[str], name: str, schema: Schema,
                    default_fmt: str) -> HostTable:
    """Read warehouse files whose formats may differ per file (a
    warehouse in one format beside parquet files written later).
    Buckets by extension, reads each bucket in its own format, and
    rebuilds one table (string dictionaries re-encode across buckets)."""
    ext_to_fmt = {ext: f for f, ext in FORMAT_EXT.items()}
    groups: dict[str, list[str]] = {}
    for p in paths:
        ext = os.path.splitext(p)[1]
        groups.setdefault(ext_to_fmt.get(ext, default_fmt),
                          []).append(p)
    if len(groups) == 1:
        fmt, ps = next(iter(groups.items()))
        return read_table_fmt(ps, name, schema, fmt)
    parts = [read_table_fmt(ps, name, schema, fmt)
             for fmt, ps in groups.items()]
    arrays: dict[str, np.ndarray] = {}
    for f in schema:
        cols = [t.columns[f.name] for t in parts]
        vals = np.concatenate([c.decode() if c.is_string else c.values
                               for c in cols])
        arrays[f.name] = vals
        if f.nullable:
            arrays[f.name + "#null"] = np.concatenate(
                [c.null_mask if c.null_mask is not None
                 else np.ones(len(c.values), dtype=bool) for c in cols])
    return from_arrays(name, schema, arrays)


def read_table_fmt(paths: list[str] | str, name: str, schema: Schema,
                   fmt: str) -> HostTable:
    """Read a warehouse table written by ``write_table`` in any format.

    When digest verification is on (io/integrity.py), every file is
    re-hashed against its table's ``_manifest.json`` before parsing:
    corruption surfaces as a CorruptArtifact naming the file and both
    digests, never as silently wrong query output."""
    if isinstance(paths, str):
        paths = [paths]
    faults.fault_point("io.read", table=name, fmt=fmt, paths=paths)
    integrity.verify_paths(paths, name)
    if fmt == "parquet":
        return read_parquet(paths, name, schema)
    if fmt == "avro":
        from nds_tpu_torch.io import avro_io
        return avro_io.read_avro(paths, name, schema)
    if fmt == "orc":
        import pyarrow.orc as paorc
        tables = [paorc.read_table(p) for p in paths]
        return from_arrow(name, schema,
                          pa.concat_tables(tables,
                                           promote_options="permissive"))
    if fmt == "json":
        import pyarrow.json as pajson
        # dates and decimals are ISO/decimal STRINGS in the json lines
        # (json has no such types); read as string, cast after
        read_types, casts = {}, {}
        for f in schema:
            t = _arrow_read_type(f.dtype)
            if isinstance(f.dtype, (DateType, DecimalType)):
                read_types[f.name] = pa.string()
                casts[f.name] = t
            else:
                read_types[f.name] = t
        want = pa.schema(read_types)
        tables = []
        for p in paths:
            t = pajson.read_json(
                p, parse_options=pajson.ParseOptions(
                    explicit_schema=want))
            cols = []
            for i, fld in enumerate(t.schema):
                c = t.column(i)
                if fld.name in casts:
                    c = c.cast(casts[fld.name])
                cols.append(c)
            tables.append(pa.Table.from_arrays(
                cols, names=t.column_names))
        return from_arrow(name, schema,
                          pa.concat_tables(tables,
                                           promote_options="permissive"))
    raise ValueError(f"unknown input format {fmt!r}")


def write_tbl(arrays: dict[str, np.ndarray], schema: Schema, path: str,
              trailing_delimiter: bool = True) -> None:
    """Write generator output in dbgen's .tbl text format."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = len(next(iter(arrays.values())))
    cols = []
    for f in schema:
        arr = arrays[f.name]
        if isinstance(f.dtype, DecimalType):
            s = f.dtype.scale
            ints = arr.astype(np.int64)
            sign = np.where(ints < 0, "-", "")
            mag = np.abs(ints)
            vals = [f"{sign[i]}{mag[i] // 10**s}.{mag[i] % 10**s:0{s}d}"
                    for i in range(n)]
        elif isinstance(f.dtype, DateType):
            vals = [str(_EPOCH + int(v)) for v in arr]
        else:
            vals = [str(v) for v in arr]
        valid = arrays.get(f.name + "#null")
        if valid is not None:
            # dsdgen's NULL convention: an empty field
            vals = [v if ok else "" for v, ok in zip(vals, valid)]
        cols.append(vals)
    end = "|\n" if trailing_delimiter else "\n"
    with open(path, "w") as f:
        for row in zip(*cols):
            f.write("|".join(row) + end)
