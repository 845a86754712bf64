"""Avro Object Container File writer/reader (numpy and the standard
library).

Port copy of ``nds_tpu/io/avro_io.py``, imports rewritten to
``nds_tpu_torch``: a file written by either package reads in the other.
The upstream transcode writes avro warehouses through spark-avro
(`nds/nds_transcode.py:69-152` with --output_format avro); no avro
package is assumed here, so the container format (Apache Avro spec
1.11.1, "Object Container Files") is implemented directly: magic `Obj\\x01`,
metadata map carrying the JSON schema and codec, 16-byte sync marker,
then length-prefixed record blocks. Codecs: `null` and `deflate`
(zlib, spec's raw-DEFLATE framing) — both readable by any standard
avro implementation.

Type mapping (engine logical types -> avro):
  int8/16/32 -> int        int64 -> long       float32/64 -> float/double
  bool       -> boolean    string -> string
  date       -> int + logicalType:date              (epoch days, as stored)
  decimal(p,s) -> bytes + logicalType:decimal       (big-endian two's
                  complement of the scaled integer, the spec encoding)
Nullable columns are `["null", T]` unions, matching how spark-avro
writes nullable StructFields.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib

import numpy as np

from nds_tpu_torch.engine.types import (
    BoolType, DateType, DecimalType, DType, FloatType, IntType, Schema,
    StringType,
)
from nds_tpu_torch.io.host_table import HostTable, from_arrays

MAGIC = b"Obj\x01"
SYNC = bytes(range(16))  # deterministic marker: files diff stably


# ------------------------------------------------------------ encoding

def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def _write_long(buf: io.BytesIO, n: int) -> None:
    n = _zigzag(int(n))
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            buf.write(bytes((b | 0x80,)))
        else:
            buf.write(bytes((b,)))
            return


def _read_long(buf) -> int:
    shift, acc = 0, 0
    while True:
        b = buf.read(1)[0]
        acc |= (b & 0x7F) << shift
        if not b & 0x80:
            return _unzigzag(acc)
        shift += 7


def _write_bytes(buf: io.BytesIO, b: bytes) -> None:
    _write_long(buf, len(b))
    buf.write(b)


def _read_bytes(buf) -> bytes:
    return buf.read(_read_long(buf))


def _decimal_bytes(v: int) -> bytes:
    """Big-endian two's complement, minimal length (spec decimal)."""
    v = int(v)
    length = max(1, ((v if v >= 0 else ~v).bit_length() + 8) // 8)
    return v.to_bytes(length, "big", signed=True)


def _long_bytes(n: int) -> bytes:
    """Zigzag varint as bytes (the hot writer path)."""
    n = _zigzag(int(n))
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


_LONG0 = _long_bytes(0)
_LONG1 = _long_bytes(1)

# field kind codes for the per-value loops
_K_LONG, _K_DECIMAL, _K_STRING, _K_FLOAT, _K_BOOL = range(5)


def _kind_of(dt: DType) -> int:
    if isinstance(dt, (IntType, DateType)):
        return _K_LONG
    if isinstance(dt, DecimalType):
        return _K_DECIMAL
    if isinstance(dt, StringType):
        return _K_STRING
    if isinstance(dt, FloatType):
        return _K_FLOAT
    if isinstance(dt, BoolType):
        return _K_BOOL
    raise ValueError(f"no avro mapping for {dt!r}")


# ------------------------------------------------------------- schema

def _avro_type(dt: DType) -> object:
    if isinstance(dt, IntType):
        return "long" if dt.bits == 64 else "int"
    if isinstance(dt, FloatType):
        return "double" if dt.bits == 64 else "float"
    if isinstance(dt, BoolType):
        return "boolean"
    if isinstance(dt, StringType):
        return "string"
    if isinstance(dt, DateType):
        return {"type": "int", "logicalType": "date"}
    if isinstance(dt, DecimalType):
        return {"type": "bytes", "logicalType": "decimal",
                "precision": dt.precision, "scale": dt.scale}
    raise ValueError(f"no avro mapping for {dt!r}")


def avro_schema(name: str, schema: Schema) -> dict:
    fields = []
    for f in schema:
        t = _avro_type(f.dtype)
        fields.append({"name": f.name,
                       "type": ["null", t] if f.nullable else t})
    return {"type": "record", "name": name, "fields": fields}


# ------------------------------------------------------------- writer

def write_avro(table: HostTable, path: str, schema: Schema,
               codec: str = "null", block_rows: int = 65536) -> None:
    if codec not in ("null", "deflate"):
        raise ValueError(f"unsupported avro codec {codec!r}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    sch = avro_schema(table.name, schema)
    cols = []
    for f in schema:
        c = table.columns[f.name]
        vals = c.decode() if c.is_string else c.values
        # plain Python lists: per-element numpy scalar boxing dominates
        # the row loop otherwise (avro is row-major, so a columnar
        # vectorization would still interleave per record)
        cols.append((f, vals.tolist() if hasattr(vals, "tolist")
                     else list(vals),
                     None if c.null_mask is None
                     else c.null_mask.tolist()))
    n = table.nrows
    with open(path, "wb") as out:
        out.write(MAGIC)
        header = io.BytesIO()
        _write_long(header, 2)  # metadata map: one block of 2 entries
        _write_bytes(header, b"avro.schema")
        _write_bytes(header, json.dumps(sch).encode())
        _write_bytes(header, b"avro.codec")
        _write_bytes(header, codec.encode())
        _write_long(header, 0)  # end of map
        out.write(header.getvalue())
        out.write(SYNC)
        # per-field integer kind codes keep isinstance dispatch out of
        # the per-value loop (avro is row-major, so values interleave
        # per record and a columnar vectorization can't apply)
        plan = []
        for f, vals, mask in cols:
            plan.append((_kind_of(f.dtype), f.nullable, vals, mask,
                         "<d" if (isinstance(f.dtype, FloatType)
                                  and f.dtype.bits == 64) else "<f"))
        for start in range(0, max(n, 1), block_rows):
            stop = min(start + block_rows, n)
            if stop <= start:
                break
            parts: list[bytes] = []
            add = parts.append
            for i in range(start, stop):
                for kind, nullable, vals, mask, ffmt in plan:
                    null = mask is not None and not mask[i]
                    if nullable:
                        add(_LONG1 if not null else _LONG0)
                        if null:
                            continue
                    v = vals[i]
                    if kind == _K_LONG:
                        add(_long_bytes(v))
                    elif kind == _K_DECIMAL:
                        b = _decimal_bytes(v)
                        add(_long_bytes(len(b)))
                        add(b)
                    elif kind == _K_STRING:
                        b = str(v).encode()
                        add(_long_bytes(len(b)))
                        add(b)
                    elif kind == _K_FLOAT:
                        add(struct.pack(ffmt, float(v)))
                    else:  # _K_BOOL
                        add(b"\x01" if v else b"\x00")
            data = b"".join(parts)
            if codec == "deflate":
                # spec: raw DEFLATE — strip the 2-byte zlib header and
                # 4-byte adler32 trailer
                data = zlib.compress(data)[2:-4]
            head = io.BytesIO()
            _write_long(head, stop - start)
            _write_long(head, len(data))
            out.write(head.getvalue())
            out.write(data)
            out.write(SYNC)


# ------------------------------------------------------------- reader

def read_avro(paths: list[str] | str, name: str,
              schema: Schema) -> HostTable:
    if isinstance(paths, str):
        paths = [paths]
    cols: dict[str, list] = {f.name: [] for f in schema}
    nulls: dict[str, list] = {f.name: [] for f in schema}
    for p in paths:
        _read_one(p, schema, cols, nulls)
    arrays: dict[str, np.ndarray] = {}
    for f in schema:
        vals = cols[f.name]
        if isinstance(f.dtype, StringType):
            arrays[f.name] = np.array(
                [v if v is not None else "" for v in vals], dtype=object)
        elif isinstance(f.dtype, FloatType):
            arrays[f.name] = np.array(
                [v if v is not None else 0.0 for v in vals],
                dtype=np.float64 if f.dtype.bits == 64 else np.float32)
        else:
            dt = (np.int64 if (isinstance(f.dtype, IntType)
                               and f.dtype.bits == 64)
                  or isinstance(f.dtype, DecimalType) else np.int32)
            if isinstance(f.dtype, BoolType):
                dt = np.bool_
            arrays[f.name] = np.array(
                [v if v is not None else 0 for v in vals], dtype=dt)
        if f.nullable:
            arrays[f.name + "#null"] = np.array(nulls[f.name],
                                                dtype=bool)
    return from_arrays(name, schema, arrays)


def _read_one(path: str, schema: Schema, cols, nulls) -> None:
    with open(path, "rb") as f:
        raw = f.read()
    buf = io.BytesIO(raw)
    if buf.read(4) != MAGIC:
        raise ValueError(f"{path}: not an avro container file")
    meta = {}
    while True:
        count = _read_long(buf)
        if count == 0:
            break
        if count < 0:  # spec: negative count is followed by byte size
            _read_long(buf)
            count = -count
        for _ in range(count):
            k = _read_bytes(buf)
            meta[k.decode()] = _read_bytes(buf)
    codec = meta.get("avro.codec", b"null").decode()
    file_schema = json.loads(meta["avro.schema"])
    order = [fl["name"] for fl in file_schema["fields"]]
    by_name = {f.name: f for f in schema}
    if set(order) != set(by_name):
        raise ValueError(
            f"{path}: avro fields {order} do not match schema")
    plan = []
    for fname in order:
        fld = by_name[fname]
        is64 = isinstance(fld.dtype, FloatType) and fld.dtype.bits == 64
        plan.append((_kind_of(fld.dtype), fld.nullable, cols[fname],
                     nulls[fname], 8 if is64 else 4,
                     "<d" if is64 else "<f"))
    sync = buf.read(16)
    while buf.tell() < len(raw):
        nrec = _read_long(buf)
        size = _read_long(buf)
        data = buf.read(size)
        if codec == "deflate":
            data = zlib.decompress(data, wbits=-15)
        elif codec != "null":
            raise ValueError(f"unsupported avro codec {codec!r}")
        if buf.read(16) != sync:
            raise ValueError(f"{path}: sync marker mismatch")
        _decode_block(data, nrec, plan, cols, nulls)


def _decode_block(data: bytes, nrec: int, plan, cols, nulls) -> None:
    """Index-based block decode: no BytesIO.read(1)-per-byte, no
    isinstance per value (the reader hot path — fact tables are tens of
    millions of values)."""
    pos = 0
    unz = _unzigzag
    for _ in range(nrec):
        for kind, nullable, cvals, cnulls, fsize, ffmt in plan:
            if nullable:
                present = data[pos] == 2  # zigzag(1) = 2, single byte
                pos += 1
                cnulls.append(present)
                if not present:
                    cvals.append(None)
                    continue
            if kind == _K_LONG:
                shift = acc = 0
                while True:
                    b = data[pos]
                    pos += 1
                    acc |= (b & 0x7F) << shift
                    if not b & 0x80:
                        break
                    shift += 7
                cvals.append(unz(acc))
            elif kind in (_K_DECIMAL, _K_STRING):
                shift = acc = 0
                while True:
                    b = data[pos]
                    pos += 1
                    acc |= (b & 0x7F) << shift
                    if not b & 0x80:
                        break
                    shift += 7
                ln = unz(acc)
                raw = data[pos:pos + ln]
                pos += ln
                cvals.append(int.from_bytes(raw, "big", signed=True)
                             if kind == _K_DECIMAL else raw.decode())
            elif kind == _K_FLOAT:
                cvals.append(struct.unpack_from(ffmt, data, pos)[0])
                pos += fsize
            else:  # _K_BOOL
                cvals.append(data[pos] == 1)
                pos += 1
