"""Raw '|'-delimited text IO (dbgen/dsdgen .tbl/.dat format) + Parquet.

Counterpart of ``nds_tpu/io/csv_io.py``. The raw reader, ``read_tbl``,
is rewritten on numpy and the standard library, so that a ``raw``
warehouse loads where pyarrow is absent; it gives exactly the
``HostTable`` the reference's pyarrow reader gives (``pyarrow.csv`` with
an explicit schema and its default conversion options):

- ints as int32 (int64 for 64-bit columns), floats as float64 (float32),
  decimals as int64 scaled by the column's scale, parsed from the digits
  and never through a float, dates as int32 days since 1970-01-01;
- strings as int32 codes into a sorted dictionary of ``str`` (code order
  is byte order, which for UTF-8 is code-point order, as numpy's unicode
  sort in the reference);
- an empty field, or one of pyarrow's null spellings ("NULL", "NA",
  "nan", ...), is NULL in a numeric or date column: a null mask (True =
  valid) and a 0 in the values. In a string column it is the string
  itself, never NULL (pyarrow's ``strings_can_be_null`` is off);
- empty lines are skipped; quoting is not read (the generators write no
  quote characters): a field is its bytes between the delimiters.

``write_tbl`` is the reference's. ``read_parquet`` and ``read_table_fmt``
read parquet through pyarrow, imported inside the function that needs it.

Trimmed from the reference: the ``orc``, ``json`` and ``avro`` formats
and the parquet and table writers (ROADMAP Queue 1, "transcode and the
other warehouse formats"), the digest verification of ``io.integrity``
and the ``faults`` points (the resilience layer, ROADMAP Queue 1).
"""

from __future__ import annotations

import decimal
import os
import re
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from nds_tpu_torch.engine.types import (
    DateType, DecimalType, FloatType, IntType, Schema, StringType,
)
from nds_tpu_torch.io.host_table import HostColumn, HostTable

_EPOCH = np.datetime64("1970-01-01", "D")

# pyarrow.csv's default null spellings: NULL in every column but strings
NULL_VALUES = frozenset(
    s.encode() for s in (
        "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN",
        "-nan", "1.#IND", "1.#QNAN", "N/A", "NA", "NULL", "NaN", "n/a",
        "nan", "null"))

# rows parsed at a time: bounds the (rows x field width) byte matrices
_BLOCK_ROWS = 1 << 20
# bytes of padding around a file's bytes: the widest field read
_PAD = 4096

_PIPE, _NL, _MINUS, _DOT, _ZERO = 124, 10, 45, 46, 48


def _numpy_dtype(dtype) -> np.dtype:
    if isinstance(dtype, IntType):
        return np.dtype(np.int64 if dtype.bits == 64 else np.int32)
    if isinstance(dtype, FloatType):
        return np.dtype(np.float64 if dtype.bits == 64 else np.float32)
    if isinstance(dtype, DecimalType):
        return np.dtype(np.int64)
    if isinstance(dtype, DateType):
        return np.dtype(np.int32)
    raise TypeError(f"unsupported dtype {dtype}")


def _split_fields(data: bytes, nfields: int, path: str):
    """(bytes as uint8, starts, ends) of every field, each (nfields, rows):
    field j of row r is ``buf[starts[j, r]:ends[j, r]]``."""
    if data.startswith(b"\n") or b"\n\n" in data:
        data = b"\n".join(ln for ln in data.split(b"\n") if ln) + b"\n"
    if not data.endswith(b"\n"):
        data += b"\n"
    pad = bytes(_PAD)
    buf = np.frombuffer(pad + data + pad, dtype=np.uint8)
    sep = np.flatnonzero((buf == _PIPE) | (buf == _NL))
    if len(sep) % nfields:
        raise ValueError(f"{path}: the lines do not all have {nfields} "
                         f"fields")
    sep = sep.reshape(-1, nfields)
    kinds = buf[sep]
    if not ((kinds[:, -1] == _NL).all() and (kinds[:, :-1] == _PIPE).all()):
        raise ValueError(f"{path}: the lines do not all have {nfields} "
                         f"fields")
    starts = np.empty_like(sep)
    starts[:, 1:] = sep[:, :-1] + 1
    starts[0, 0] = _PAD
    starts[1:, 0] = sep[:-1, -1] + 1
    # column-major: each column's starts and ends contiguous
    return buf, np.ascontiguousarray(starts.T), np.ascontiguousarray(sep.T)


def _windows(buf, st, en, right: bool):
    """(rows, W) uint8 matrix of each field's bytes, W the widest field's
    length, aligned left (``right`` False) or right; and the matrix of
    which cells are inside the field (the others hold bytes around it).
    ``buf`` is padded by ``_PAD`` bytes at both ends."""
    ln = en - st
    width = max(int(ln.max()), 1) if len(ln) else 1
    if width > _PAD:
        raise ValueError(f"a field of {width} bytes")
    win = np.lib.stride_tricks.sliding_window_view(buf, width)
    cells = win[(en - width) if right else st]
    k = np.arange(width)
    inside = (k >= (width - ln)[:, None]) if right else (k < ln[:, None])
    return cells, inside


def _null_rows(buf, st, en, bad, path, name, parse=None, out=None):
    """NULL rows among ``bad``: those whose field is one of pyarrow's null
    spellings. The others are parsed one by one by ``parse`` into
    ``out``, or raise where there is no ``parse``."""
    nulls = np.zeros(len(st), dtype=bool)
    for r in np.flatnonzero(bad):
        field = buf[st[r]:en[r]].tobytes()
        if field in NULL_VALUES:
            nulls[r] = True
            continue
        value = None if parse is None else parse(field)
        if value is None:
            raise ValueError(f"{path}: column {name!r}: cannot parse "
                             f"{field!r}")
        out[r] = value
    return nulls


_INT_RE = re.compile(rb"-?[0-9]+")
_DEC_RE = re.compile(rb"-?([0-9]+(\.[0-9]*)?|\.[0-9]+)")


def _parse_decimal(buf, st, en, scale, bits: int, path, name):
    """Signed integers (``scale`` None) or decimals ("-12", "3.50") as
    int64, decimals scaled by 10**scale, exactly; and the NULL rows.
    The fields of the generators' form (no dot, or exactly ``scale``
    digits after it) are read by whole-column operations; any other
    field one by one."""
    cells, inside = _windows(buf, st, en, right=True)
    width = cells.shape[1]
    ln = en - st
    digit = cells - np.uint8(_ZERO)
    is_digit = inside & (digit <= 9)
    neg = buf[st] == _MINUS
    # the generators' form: every cell a digit but the sign and, at
    # ``scale`` digits from the end, the dot
    power = np.zeros(width, dtype=np.int64)
    if scale:
        dot = width - 1 - scale
        has_dot = ((cells[:, dot] == _DOT) & inside[:, dot] if dot >= 0
                   else np.zeros(len(st), dtype=bool))
        ndigits = is_digit.sum(axis=1)
        fast = has_dot & (ndigits == ln - neg - 1)
        if dot >= 0:
            power[:dot] = 10 ** np.arange(width - 2, scale - 1, -1)
            power[dot + 1:] = 10 ** np.arange(scale - 1, -1, -1)
    else:
        fast = (ln > neg) & (is_digit.sum(axis=1) == ln - neg)
        power[:] = 10 ** np.arange(width - 1, -1, -1)
    if width - (1 if scale else 0) > 18:
        raise ValueError(f"{path}: column {name!r}: a value exceeds "
                         f"18 digits")
    digits = np.where(is_digit & fast[:, None], digit, np.uint8(0))
    if width <= 15:
        # exact in float64 (every partial sum below 2**53), and BLAS
        vals = (digits.astype(np.float64) @ power.astype(np.float64)
                ).astype(np.int64)
    else:
        vals = digits @ power
    vals = np.where(neg, -vals, vals)

    def parse(field):
        m = (_DEC_RE if scale else _INT_RE).fullmatch(field)
        if m is None:
            return None
        d = decimal.Decimal(field.decode()).scaleb(scale or 0)
        if d != d.to_integral_value() or abs(d) >= 10**18:
            raise ValueError(f"{path}: column {name!r}: cannot hold "
                             f"{field!r} at scale {scale or 0}")
        return int(d)
    nulls = _null_rows(buf, st, en, ~fast, path, name, parse, vals)
    if bits == 32 and ((vals < -2**31) | (vals >= 2**31)).any():
        raise ValueError(f"{path}: column {name!r}: a value exceeds int32")
    return vals, nulls


_MONTH_DAYS = np.array([0, 31, 29, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31])


def _parse_date(buf, st, en, path, name):
    """ISO dates ("1998-12-01") as days since 1970-01-01; NULL rows."""
    ok = (en - st) == 10
    cells = np.lib.stride_tricks.sliding_window_view(buf, 10)[st]
    cells = cells.astype(np.int64) - _ZERO
    digits = cells[:, [0, 1, 2, 3, 5, 6, 8, 9]]
    ok &= ((digits >= 0) & (digits <= 9)).all(axis=1)
    ok &= (cells[:, 4] == _MINUS - _ZERO) & (cells[:, 7] == _MINUS - _ZERO)
    y = digits[:, :4] @ np.array([1000, 100, 10, 1])
    m = digits[:, 4] * 10 + digits[:, 5]
    d = digits[:, 6] * 10 + digits[:, 7]
    leap = (y % 4 == 0) & ((y % 100 != 0) | (y % 400 == 0))
    mdays = _MONTH_DAYS[np.clip(m, 0, 12)] - ((m == 2) & ~leap)
    ok &= (m >= 1) & (m <= 12) & (d >= 1) & (d <= mdays)
    nulls = _null_rows(buf, st, en, ~ok, path, name)
    # days from the civil date (proleptic Gregorian)
    yy = y - (m <= 2)
    era = np.floor_divide(yy, 400)
    yoe = yy - era * 400
    doy = (153 * (m + np.where(m > 2, -3, 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    days = era * 146097 + doe - 719468
    return np.where(nulls, 0, days).astype(np.int32), nulls


def _strings(buf, st, en):
    """Each field's bytes as one fixed-width bytes array."""
    cells, inside = _windows(buf, st, en, right=False)
    cells = np.where(inside, cells, np.uint8(0))
    return np.ascontiguousarray(cells).view(f"S{cells.shape[1]}").ravel()


def _parse_float(buf, st, en, dtype, path, name):
    text = _strings(buf, st, en)
    # pyarrow's null spellings first; every other field must parse
    nulls = np.zeros(len(st), dtype=bool)
    for tok in NULL_VALUES:
        nulls |= text == tok
    vals = np.zeros(len(st), dtype=np.float64)
    try:
        vals[~nulls] = text[~nulls].astype(np.float64)
    except ValueError as e:
        raise ValueError(f"{path}: column {name!r}: {e}") from None
    return vals.astype(dtype), nulls


def _parse_column(f, buf, st, en, path):
    """One column of one file: (values or string bytes, null rows)."""
    dt = f.dtype
    parts, nulls = [], []
    for lo in range(0, len(st), _BLOCK_ROWS):
        s, e = st[lo:lo + _BLOCK_ROWS], en[lo:lo + _BLOCK_ROWS]
        if isinstance(dt, StringType):
            parts.append(_strings(buf, s, e))
            continue
        if isinstance(dt, (IntType, DecimalType)):
            scale = dt.scale if isinstance(dt, DecimalType) else None
            bits = dt.bits if isinstance(dt, IntType) else 64
            v, n = _parse_decimal(buf, s, e, scale, bits, path, f.name)
            v = v.astype(_numpy_dtype(dt))
        elif isinstance(dt, DateType):
            v, n = _parse_date(buf, s, e, path, f.name)
        elif isinstance(dt, FloatType):
            v, n = _parse_float(buf, s, e, _numpy_dtype(dt), path, f.name)
        else:
            raise TypeError(f"unsupported dtype {dt}")
        parts.append(v)
        nulls.append(n)
    return parts, nulls


def _read_file(path: str, nfields: int):
    with open(path, "rb") as fh:
        return _split_fields(fh.read(), nfields, path)


def _column(f, parts: list) -> HostColumn:
    """One column from its parts, file by file."""
    if isinstance(f.dtype, StringType):
        text = (np.concatenate([v for vs, _ in parts for v in vs])
                if parts else np.zeros(0, dtype="S1"))
        uniq, codes = np.unique(text, return_inverse=True)
        dictionary = np.empty(len(uniq), dtype=object)
        dictionary[:] = [u.decode("utf-8") for u in uniq]
        return HostColumn(f.dtype, codes.astype(np.int32), dictionary, None)
    if not parts:
        return HostColumn(f.dtype, np.zeros(0, dtype=_numpy_dtype(f.dtype)))
    vals = np.concatenate([v for vs, _ in parts for v in vs])
    null = np.concatenate([n for _, ns in parts for n in ns])
    return HostColumn(f.dtype, vals, None, ~null if null.any() else None)


def read_tbl(paths: list[str] | str, name: str, schema: Schema,
             trailing_delimiter: bool = True) -> HostTable:
    """Read one table from one or more '|'-delimited files, the files
    and then their columns parsed by a pool of threads (the whole-column
    numpy operations release the interpreter's lock)."""
    if isinstance(paths, str):
        paths = [paths]
    nfields = len(schema) + (1 if trailing_delimiter else 0)
    # zero-row chunks are legitimate (fixed tables)
    files = [p for p in paths if os.path.getsize(p)]
    with ThreadPoolExecutor(max(1, min(8, os.cpu_count() or 1))) as pool:
        split = list(pool.map(lambda p: _read_file(p, nfields), files))
        futures = [[pool.submit(_parse_column, f, buf, st[j], en[j], p)
                    for j, f in enumerate(schema)]
                   for p, (buf, st, en) in zip(files, split)]
        parts = [[fut.result() for fut in row] for row in futures]
        del split, futures
        cols = list(pool.map(
            lambda jf: _column(jf[1], [row[jf[0]] for row in parts]),
            enumerate(schema)))
    return HostTable(name, schema, dict(zip(schema.names, cols)))


def _arrow_read_type(pa, dtype):
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


def from_arrow(name: str, schema: Schema, t) -> HostTable:
    """Arrow table -> HostTable, carrying arrow validity bitmaps over as
    engine null masks (True = valid). Null slots are filled with 0/"" in
    the value arrays so downstream numpy code never sees NaN."""
    import pyarrow as pa
    cols: dict[str, HostColumn] = {}
    for f in schema:
        arr = t.column(f.name).combine_chunks()
        mask = None
        if arr.null_count:
            mask = arr.is_valid().to_numpy(zero_copy_only=False)
        if isinstance(f.dtype, StringType):
            # arrow-native dictionary encode, then remap codes so the
            # dictionary is sorted (code order == lexicographic order);
            # only the (small) dictionary is ever sorted, not the column
            if not pa.types.is_dictionary(arr.type):
                arr = arr.dictionary_encode()
            raw_dict = np.asarray(arr.dictionary.to_pylist(), dtype=object)
            raw_codes = arr.indices.fill_null(0).to_numpy(
                zero_copy_only=False).astype(np.int32)
            order = np.argsort(raw_dict.astype(str), kind="stable")
            remap = np.empty(len(raw_dict), dtype=np.int32)
            remap[order] = np.arange(len(raw_dict), dtype=np.int32)
            codes = remap[raw_codes] if len(raw_dict) else raw_codes
            cols[f.name] = HostColumn(f.dtype, codes, raw_dict[order], mask)
        elif isinstance(f.dtype, DecimalType):
            s = f.dtype.scale
            if f.dtype.precision <= 15:
                # float64 is exact for <= 15 significant digits: vectorized
                as_f = arr.cast(pa.float64()).to_numpy(zero_copy_only=False)
                ints = np.round(np.nan_to_num(as_f) * 10**s).astype(np.int64)
            else:
                ints = np.array(
                    [0 if v is None else int(v.scaleb(s))
                     for v in arr.to_pylist()], dtype=np.int64)
            cols[f.name] = HostColumn(f.dtype, ints, None, mask)
        elif isinstance(f.dtype, DateType):
            d = arr.cast(pa.int32()).fill_null(0)
            cols[f.name] = HostColumn(
                f.dtype, d.to_numpy(zero_copy_only=False), None, mask)
        elif isinstance(f.dtype, (IntType, FloatType)):
            cols[f.name] = HostColumn(
                f.dtype, arr.fill_null(0).to_numpy(zero_copy_only=False),
                None, mask)
        else:
            cols[f.name] = HostColumn(
                f.dtype, arr.to_numpy(zero_copy_only=False), None, mask)
    return HostTable(name, schema, cols)


def read_parquet(paths: list[str] | str, name: str,
                 schema: Schema) -> HostTable:
    import pyarrow as pa
    import pyarrow.parquet as pq
    if isinstance(paths, str):
        paths = [paths]
    # ParquetFile, not pq.read_table: read_table infers hive
    # partitioning from `col=value` path segments, which collides with
    # the partition column the transcode layout keeps in every file
    tables = [pq.ParquetFile(p).read() for p in paths]
    return from_arrow(name, schema,
                      pa.concat_tables(tables, promote_options="permissive"))


# the warehouse formats read here; the reference's orc, json and avro
# wait for the port of transcode
FORMAT_EXT = {"parquet": ".parquet"}


def read_table_fmt(paths: list[str] | str, name: str, schema: Schema,
                   fmt: str) -> HostTable:
    """Read a warehouse table written by the reference's ``write_table``
    (parquet)."""
    if fmt == "parquet":
        return read_parquet(paths, name, schema)
    raise ValueError(f"unknown input format {fmt!r} (the port reads "
                     f"raw and parquet)")


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
