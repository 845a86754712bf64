"""Host-side columnar tables: the staging format between IO and the engine.

Port copy of ``nds_tpu/io/host_table.py``: it imports nothing of ``nds_tpu``.

Everything the device engine touches is numeric. String columns are
dictionary-encoded at load: values live in a host-side sorted dictionary,
devices only see int32 codes. Because the dictionary is sorted, code order
== lexicographic order, so <,>,=,ORDER BY on strings compile to integer
compares on the MXU-friendly path (SURVEY.md §7 "hard parts": strings are
the classic reason SQL engines fall off the accelerator; this encoding
keeps them on it).

The reference has no equivalent layer — Spark DataFrames play this role
(`nds/nds_transcode.py:56-66` reads CSV into Spark). Here the layer is
explicit because the engine is ours.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from nds_tpu_torch.engine.types import (
    DateType, DecimalType, DType, FloatType, IntType, Schema, StringType,
)


@dataclass
class HostColumn:
    """One column: numeric numpy array + optional string dictionary.

    For string columns ``values`` holds int32 codes indexing ``dictionary``
    (sorted unique values, so codes preserve lexicographic order).
    ``null_mask`` is True where the value is valid (None = all valid).
    """

    dtype: DType
    values: np.ndarray
    dictionary: np.ndarray | None = None
    null_mask: np.ndarray | None = None

    @property
    def is_string(self) -> bool:
        return self.dictionary is not None

    @property
    def nbytes(self) -> int:
        """Raw host bytes (values + null mask) — the uncompressed
        width the columnar subsystem (nds_tpu/columnar/) measures its
        encodings against."""
        return int(self.values.nbytes) + (
            0 if self.null_mask is None else int(self.null_mask.nbytes))

    def decode(self) -> np.ndarray:
        """Materialize python-visible values (strings decoded)."""
        if self.is_string:
            out = self.dictionary[np.clip(self.values, 0, len(self.dictionary) - 1)]
            if self.null_mask is not None:
                out = out.copy()
                out[~self.null_mask] = None
            return out
        return self.values


@dataclass
class HostTable:
    name: str
    schema: Schema
    columns: dict[str, HostColumn] = field(default_factory=dict)

    @property
    def nrows(self) -> int:
        if not self.columns:
            return 0
        return len(next(iter(self.columns.values())).values)

    def column(self, name: str) -> HostColumn:
        return self.columns[name]


def encode_strings(values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Sorted-dictionary encode an object array -> (int32 codes, dictionary)."""
    dictionary, codes = np.unique(values.astype(str), return_inverse=True)
    return codes.astype(np.int32), dictionary.astype(object)


def from_arrays(name: str, schema: Schema, arrays: dict[str, np.ndarray]) -> HostTable:
    """Build a HostTable from generator output ({col: numpy array}).

    Numeric/date/decimal columns pass through (decimals already scaled
    int64); object arrays are dictionary-encoded. A companion
    ``"<col>#null"`` boolean array (True = valid) becomes the column's
    null mask — how the TPC-DS generator conveys dsdgen-style NULL FKs.
    """
    cols: dict[str, HostColumn] = {}
    for f in schema:
        arr = arrays[f.name]
        mask = arrays.get(f.name + "#null")
        if mask is not None:
            mask = np.asarray(mask, dtype=bool)
            if mask.all():
                mask = None
        if isinstance(f.dtype, StringType):
            codes, dictionary = encode_strings(arr)
            cols[f.name] = HostColumn(f.dtype, codes, dictionary, mask)
        elif isinstance(f.dtype, DecimalType):
            cols[f.name] = HostColumn(f.dtype, arr.astype(np.int64), None, mask)
        elif isinstance(f.dtype, DateType):
            cols[f.name] = HostColumn(f.dtype, arr.astype(np.int32), None, mask)
        elif isinstance(f.dtype, IntType):
            cols[f.name] = HostColumn(
                f.dtype, arr.astype(f"int{f.dtype.bits}"), None, mask)
        elif isinstance(f.dtype, FloatType):
            cols[f.name] = HostColumn(
                f.dtype, arr.astype(f"float{f.dtype.bits}"), None, mask)
        else:
            cols[f.name] = HostColumn(f.dtype, arr, None, mask)
    return HostTable(name, schema, cols)


def from_reference(table, schemas: "dict | None" = None) -> HostTable:
    """The port's HostTable for a table of the JAX package, taken
    duck-typed (``.name``; per column ``.values``, ``.dictionary``,
    ``.null_mask``) so that the port never imports that package. The
    schema is the port's own for the table's name, from ``schemas``
    (the port's NDS-H schemas by default); column names and dtypes must
    agree with it. The numpy arrays are shared, not copied: both engines
    then read bit-identical data. A mutated reference table carries its
    delta state across (``columnar/delta.py``: the segments, the
    deleted-row bitmask and the merged statistics), so both engines read
    the same mutated table."""
    if schemas is None:
        from nds_tpu_torch.nds_h.schema import get_schemas
        schemas = get_schemas()
    schema = schemas.get(table.name)
    if schema is None:
        raise ValueError(f"no port schema for table {table.name!r}")
    names = [f.name for f in schema]
    if list(table.columns) != names:
        raise ValueError(f"{table.name}: columns {list(table.columns)} "
                         f"!= schema {names}")
    cols: dict[str, HostColumn] = {}
    for f in schema:
        ref = table.columns[f.name]
        if repr(ref.dtype) != repr(f.dtype):
            raise ValueError(f"{table.name}.{f.name}: dtype {ref.dtype!r}"
                             f" != schema {f.dtype!r}")
        dictionary = (None if ref.dictionary is None
                      else np.asarray(ref.dictionary))
        null_mask = (None if ref.null_mask is None
                     else np.asarray(ref.null_mask, dtype=bool))
        cols[f.name] = HostColumn(f.dtype, np.asarray(ref.values),
                                  dictionary, null_mask)
    out = HostTable(table.name, schema, cols)
    ref_state = getattr(table, "_nds_delta", None)
    if ref_state is not None:
        from nds_tpu_torch.columnar import delta
        st = delta.DeltaState(
            base_rows=int(ref_state.base_rows),
            base_digest=str(ref_state.base_digest),
            segments=[delta.Segment(
                seg.seg_id, int(seg.rows), seg.digest,
                None if seg.table is None
                else from_reference(seg.table, schemas),
                bool(seg.persisted)) for seg in ref_state.segments],
            deleted=(None if ref_state.deleted is None
                     else np.asarray(ref_state.deleted, dtype=bool)),
            col_stats={k: dict(v) for k, v in ref_state.col_stats.items()},
            deleted_dirty=bool(ref_state.deleted_dirty))
        setattr(out, delta.ATTR, st)
    return out
