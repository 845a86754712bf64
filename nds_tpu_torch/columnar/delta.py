"""Delta segments + deleted-row bitmasks: writable warehouses over the
immutable encoded store.

Port copy of ``nds_tpu/columnar/delta.py``: it imports nothing of
``nds_tpu``. The TPC maintenance phase (LF_* inserts, DF_* deletes)
mutates tables whose device buffers and captured plan graphs assume
immutable content, so mutation is O(delta):

- **Inserts** land as append-only *segments*: the new rows concatenate
  onto the base arrays (a memcpy, never a decode). String dictionaries
  merge at DICTIONARY size: when the segment's values are already in
  the base dictionary the base codes are untouched; otherwise base
  codes remap through a dict-sized gather. Per-column encoding specs
  re-derive from EXACT merged statistics (``encodings.plan_from_stats``,
  the decision procedure a fresh load runs) without an O(rows) re-scan.

- **Deletes** land as a deleted-row bitmask consulted by every scan
  (the device ``_run_scan`` row gate, the reduced scan views' host keep
  mask, the CPU oracle's context mask). Base columns are never
  gathered, so column objects and their memoized encoding specs survive
  a DF_* round untouched.

- **Digests** are segment-granular: a mutated table's content digest
  (``table_digest``) is a composition of (base digest, ordered segment
  digests, deleted bitmask digest), equal to the reference's for the
  same table and the same operations.

Segments are NORMALIZED through an arrow round-trip at append time so
the in-memory effective table is byte-identical to what a later process
reconstructs from the persisted parquet segments: digests and
merged-stats specs agree across processes by construction.

``persist_pending`` fires the ``store.commit`` fault point
(``resilience/faults.py``) after its files are written, before the
caller's snapshot commit: the torn-commit window. Trimmed from the
reference: the ``obs.metrics`` counters (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import hashlib
import os
import re
from dataclasses import dataclass, field

import numpy as np

from nds_tpu_torch.columnar import encodings
from nds_tpu_torch.io.host_table import HostColumn, HostTable

ATTR = "_nds_delta"

# op-list sidecar committed with every delta version dir; CRC-stamped
# (io/integrity.py) and written BEFORE the snapshot manifest references
# the version, so a torn commit leaves the previous version readable
OPS_NAME = "ops.json"

_VDIR_RE = re.compile(r"(?:^|[\\/])_v(\d+)[\\/]")


# memo of a table's content digest on the table object (the reference's
# ``cache/fingerprint._DIGEST_ATTR``)
_DIGEST_ATTR = "_nds_content_sha256"


def table_digest(table) -> str:
    """Full-content sha256 of a HostTable, memoized on the object (the
    reference's ``cache/fingerprint.table_digest``; DML replaces table
    objects, so a stale memo cannot survive a mutation). A mutated
    table's digest is its delta state's segment-granular composition."""
    memo = getattr(table, _DIGEST_ATTR, None)
    if memo is not None:
        return memo
    st = state_of(table)
    if st is not None:
        digest = st.content_digest()
    else:
        h = hashlib.sha256()
        for name in sorted(table.columns):
            col = table.columns[name]
            h.update(name.encode())
            h.update(repr(col.dtype).encode())
            vals = np.ascontiguousarray(col.values)
            h.update(str(vals.dtype).encode())
            h.update(str(vals.shape).encode())
            h.update(vals)
            if col.null_mask is not None:
                h.update(b"#null")
                h.update(np.ascontiguousarray(col.null_mask))
            if col.dictionary is not None:
                h.update(b"#dict")
                # object arrays have no stable buffer: hash the text form
                # (dictionaries are sorted-unique, so it is deterministic)
                h.update("\x00".join(
                    str(v) for v in col.dictionary).encode())
        digest = h.hexdigest()
    try:
        setattr(table, _DIGEST_ATTR, digest)
    except Exception:  # noqa: BLE001 - slotted table: recompute next time
        pass
    return digest


@dataclass
class Segment:
    """One committed insert: ``rows`` appended under ``seg_id`` with a
    content digest recorded at append time (recomputable from the
    persisted parquet — normalization makes them equal)."""

    seg_id: str
    rows: int
    digest: str
    # the segment table rides along until persisted so maintenance can
    # write exactly the rows that were appended; dropped after persist
    table: "HostTable | None" = None
    persisted: bool = False


@dataclass
class DeltaState:
    """Mutation lineage attached to a HostTable as ``_nds_delta``."""

    base_rows: int
    base_digest: str
    segments: list = field(default_factory=list)
    # True = deleted, over CURRENT physical rows; None = no deletes
    deleted: "np.ndarray | None" = None
    # exact per-column stats for spec merging: {col: {lo, hi, nvalid,
    # runs}} — lo/hi over VALID values (int columns), runs over all
    # physical values (mask-free non-float columns)
    col_stats: dict = field(default_factory=dict)
    # deletes since the last persist (maintenance persists one
    # cumulative mask per function)
    deleted_dirty: bool = False

    def clone(self) -> "DeltaState":
        return DeltaState(self.base_rows, self.base_digest,
                          list(self.segments),
                          None if self.deleted is None
                          else self.deleted,
                          {k: dict(v)
                           for k, v in self.col_stats.items()},
                          self.deleted_dirty)

    # ------------------------------------------------------- digesting

    def deleted_digest(self) -> str:
        if self.deleted is None or not self.deleted.any():
            return "none"
        h = hashlib.sha256()
        h.update(str(len(self.deleted)).encode())
        h.update(np.packbits(self.deleted).tobytes())
        return h.hexdigest()

    def content_digest(self) -> str:
        """Segment-granular content digest: a pure function of (base,
        ordered segments, deleted mask) — ``table_digest`` calls
        this instead of re-hashing the full concatenated arrays."""
        h = hashlib.sha256()
        h.update(b"delta|")
        h.update(self.base_digest.encode())
        for seg in self.segments:
            h.update(f"|seg:{seg.seg_id}:{seg.rows}:"
                     f"{seg.digest}".encode())
        h.update(f"|del:{self.deleted_digest()}".encode())
        return h.hexdigest()

    def deleted_count(self) -> int:
        return 0 if self.deleted is None else int(self.deleted.sum())


# ----------------------------------------------------------- accessors

def state_of(table) -> "DeltaState | None":
    return getattr(table, ATTR, None)


def live_mask(table) -> "np.ndarray | None":
    """Boolean True-=-live mask over physical rows, or None when every
    physical row is visible (the common case every scan fast-paths)."""
    st = state_of(table)
    if st is None or st.deleted is None or not st.deleted.any():
        return None
    return ~st.deleted


def visible_rows(table) -> int:
    """Logical row count: physical rows minus deleted rows (the number
    a COUNT(*) returns; ``table.nrows`` stays physical because buffer
    shapes derive from it)."""
    st = state_of(table)
    return table.nrows - (0 if st is None else st.deleted_count())


def segment_count(table) -> int:
    st = state_of(table)
    return 0 if st is None else len(st.segments)


def delta_report(table) -> "dict | None":
    """Per-table delta block for observability (ndsreport's delta
    column): segment count, appended rows, masked (deleted) rows."""
    st = state_of(table)
    if st is None:
        return None
    return {"segments": len(st.segments),
            "appended_rows": sum(s.rows for s in st.segments),
            "masked_rows": st.deleted_count()}


# -------------------------------------------------------- stats (exact)

def _col_stats(col: HostColumn) -> dict:
    """Exact stats for one column, the merge-able form of what
    ``plan_values`` measures: int bounds over valid values, run count
    over physical values (mask-free non-float columns only)."""
    vals = col.values
    lo = hi = runs = None
    nvalid = len(vals) if col.null_mask is None \
        else int(col.null_mask.sum())
    if np.issubdtype(vals.dtype, np.integer):
        lo, hi = encodings._int_bounds(vals, col.null_mask)
    if col.null_mask is None and not np.issubdtype(vals.dtype,
                                                   np.floating):
        runs = encodings._runs_of(vals)
    return {"lo": lo, "hi": hi, "nvalid": nvalid, "runs": runs}


def _merge_bounds(a: dict, b: dict) -> "tuple":
    """Exact merge of two parts' (lo, hi, nvalid): parts with zero
    valid values contribute nothing (matching ``_int_bounds`` over the
    concatenation)."""
    nvalid = a["nvalid"] + b["nvalid"]
    if a["nvalid"] == 0:
        return b["lo"], b["hi"], nvalid
    if b["nvalid"] == 0:
        return a["lo"], a["hi"], nvalid
    return min(a["lo"], b["lo"]), max(a["hi"], b["hi"]), nvalid


def _merge_runs(base_runs, seg_runs, base_last, seg_first,
                base_rows: int, seg_rows: int):
    """Exact run-count merge: boundary runs fuse when the base's last
    value equals the segment's first."""
    if base_runs is None or seg_runs is None:
        return None
    if base_rows == 0:
        return seg_runs
    if seg_rows == 0:
        return base_runs
    return base_runs + seg_runs - (1 if base_last == seg_first else 0)


# ------------------------------------------------------------- mutation

def _normalize_segment(seg: HostTable) -> HostTable:
    """Arrow round-trip the segment so its bytes (including masked
    slots) equal what a resumed process reads back from the persisted
    parquet — content digests and merged stats then agree across
    incarnations by construction."""
    from nds_tpu_torch.io import csv_io
    return csv_io.from_arrow(seg.name, seg.schema, csv_io.to_arrow(seg))


def _ensure_state(table: HostTable) -> DeltaState:
    st = state_of(table)
    if st is not None:
        return st.clone()
    st = DeltaState(base_rows=table.nrows,
                    base_digest=table_digest(table))
    for name, col in table.columns.items():
        st.col_stats[name] = _col_stats(col)
    return st


def _merge_string_column(base: HostColumn, seg: HostColumn):
    """Merge a dictionary-encoded column without decoding a single
    base row. Returns (values, dictionary, base_remap, seg_remap) —
    remaps are dict-sized monotone gathers (or None when untouched)."""
    base_dict = base.dictionary.astype(str)
    seg_dict = seg.dictionary.astype(str) if seg.dictionary is not None \
        else np.array([], dtype=str)
    pos = np.searchsorted(base_dict, seg_dict)
    pos_c = np.clip(pos, 0, max(len(base_dict) - 1, 0))
    known = len(base_dict) > 0 and bool(
        np.all(base_dict[pos_c] == seg_dict)) if len(seg_dict) else True
    if known:
        # segment values ⊆ base dictionary: base codes byte-identical
        seg_codes = pos_c.astype(np.int32)[seg.values] \
            if len(seg_dict) else seg.values.astype(np.int32)
        values = np.concatenate([base.values, seg_codes])
        return values, base.dictionary, None, \
            pos_c.astype(np.int32) if len(seg_dict) else None
    merged = np.unique(np.concatenate([base_dict, seg_dict]))
    remap_base = np.searchsorted(merged, base_dict).astype(np.int32)
    remap_seg = np.searchsorted(merged, seg_dict).astype(np.int32)
    values = np.concatenate([remap_base[base.values],
                             remap_seg[seg.values]])
    return values, merged.astype(object), remap_base, remap_seg


def append_segment(table: HostTable, seg: HostTable,
                   seg_id: str = "") -> HostTable:
    """New effective HostTable with ``seg``'s rows appended as a delta
    segment: numeric columns concatenate, string dictionaries merge at
    dictionary size, encoding specs re-derive from exact merged stats
    and seed the new columns' memos — no base decode, no np.unique
    over rows, no re-encode of existing device buffers' source."""
    seg = _normalize_segment(seg)
    st = _ensure_state(table)
    seg_digest = table_digest(seg)
    n_old, n_new = table.nrows, seg.nrows
    cols: dict[str, HostColumn] = {}
    for f in table.schema:
        bcol = table.columns[f.name]
        scol = seg.columns[f.name]
        stats = st.col_stats.get(f.name) or _col_stats(bcol)
        seg_stats = _col_stats(scol)
        if bcol.is_string:
            values, dictionary, remap_base, _remap_seg = \
                _merge_string_column(bcol, scol)
            if remap_base is not None and stats["nvalid"] > 0:
                # monotone remap: bounds map through the gather
                stats = dict(stats,
                             lo=int(remap_base[stats["lo"]]),
                             hi=int(remap_base[stats["hi"]]))
            # seg codes changed dictionary space: re-measure the
            # appended slice (O(segment)) in the merged space
            seg_slice = values[n_old:]
            seg_stats = _col_stats(HostColumn(
                scol.dtype, seg_slice, dictionary, scol.null_mask))
        else:
            if scol.values.dtype != bcol.values.dtype:
                scol = HostColumn(scol.dtype,
                                  scol.values.astype(bcol.values.dtype),
                                  None, scol.null_mask)
                seg_stats = _col_stats(scol)
            values = np.concatenate([bcol.values, scol.values])
            dictionary = None
        mask = None
        if bcol.null_mask is not None or scol.null_mask is not None:
            mask = np.concatenate([
                bcol.null_mask if bcol.null_mask is not None
                else np.ones(n_old, dtype=bool),
                scol.null_mask if scol.null_mask is not None
                else np.ones(n_new, dtype=bool)])
            if mask.all():
                mask = None
        lo, hi, nvalid = _merge_bounds(stats, seg_stats)
        runs = None
        if mask is None and not np.issubdtype(values.dtype,
                                              np.floating):
            runs = _merge_runs(
                stats["runs"], seg_stats["runs"],
                values[n_old - 1] if n_old else None,
                values[n_old] if n_new else None, n_old, n_new)
            if runs is None and (stats["runs"] is not None
                                 or n_old == 0):
                runs = encodings._runs_of(values[n_old:]) \
                    if n_old == 0 else None
        merged_stats = {"lo": lo, "hi": hi, "nvalid": nvalid,
                        "runs": runs}
        col = HostColumn(bcol.dtype, values, dictionary, mask)
        spec = encodings.plan_from_stats(
            rows=len(values), dtype=values.dtype.name,
            raw=encodings.raw_nbytes(values, mask),
            lo=lo if np.issubdtype(values.dtype, np.integer) else None,
            hi=hi if np.issubdtype(values.dtype, np.integer) else None,
            runs=runs, has_mask=mask is not None,
            is_string=col.is_string)
        encodings.seed_column_spec(col, spec)
        st.col_stats[f.name] = merged_stats
        cols[f.name] = col
    if st.deleted is not None:
        st.deleted = np.concatenate(
            [st.deleted, np.zeros(n_new, dtype=bool)])
    st.segments.append(Segment(
        seg_id or f"seg-{len(st.segments)}", n_new, seg_digest,
        table=seg))
    out = HostTable(table.name, table.schema, cols)
    setattr(out, ATTR, st)
    return out


def apply_delete(table: HostTable, keep: np.ndarray) -> HostTable:
    """New effective HostTable with rows where ``keep`` is False marked
    deleted. Column objects are SHARED with the input table — their
    arrays, dictionaries and memoized encoding specs survive untouched;
    only the delta bitmask (and therefore the content digest) moves."""
    st = _ensure_state(table)
    dead = ~np.asarray(keep, dtype=bool)
    st.deleted = dead if st.deleted is None else (st.deleted | dead)
    st.deleted_dirty = True
    out = HostTable(table.name, table.schema, dict(table.columns))
    setattr(out, ATTR, st)
    return out


_PHYSICAL_MEMO = "_nds_physical"


def physical(table: HostTable) -> HostTable:
    """Physically materialized copy: deleted rows gathered out, delta
    state dropped (compaction, SPMD sharding — packed words must align
    with the shard layout, so the sharded path materializes first).
    Memoized on the table object."""
    st = state_of(table)
    if st is None:
        return table
    memo = getattr(table, _PHYSICAL_MEMO, None)
    if memo is not None:
        return memo
    mask = live_mask(table)
    if mask is None:
        out = HostTable(table.name, table.schema, dict(table.columns))
    else:
        cols = {}
        for f in table.schema:
            col = table.columns[f.name]
            cols[f.name] = HostColumn(
                col.dtype, col.values[mask], col.dictionary,
                None if col.null_mask is None else col.null_mask[mask])
        out = HostTable(table.name, table.schema, cols)
    try:
        setattr(table, _PHYSICAL_MEMO, out)
    except Exception:  # noqa: BLE001 - slotted table: rebuild next time
        pass
    return out


# ---------------------------------------------------------- persistence

def persist_pending(table: HostTable, version_dir: str,
                    note: str = "") -> "list[str] | None":
    """Write every unpersisted segment (parquet) and, when deletes are
    pending, the cumulative deleted bitmask (npz) into ``version_dir``
    with a CRC-stamped op list + integrity digest manifest. Returns
    the written file paths (ops.json first) or None when nothing is
    pending. The caller commits the returned paths into the snapshot
    manifest — the ATOMIC commit point; a crash before that leaves an
    unreferenced version dir the reader never visits."""
    from nds_tpu_torch.io import csv_io, integrity
    st = state_of(table)
    if st is None:
        return None
    ops, files = [], []
    for i, seg in enumerate(st.segments):
        if seg.persisted:
            continue
        fname = f"delta-{i}.parquet"
        path = os.path.join(version_dir, fname)
        csv_io.write_table(seg.table, path, "parquet")
        ops.append({"kind": "insert", "file": fname,
                    "seg_id": seg.seg_id, "rows": seg.rows,
                    "digest": seg.digest})
        files.append(path)
        seg.persisted = True
        seg.table = None
    if st.deleted_dirty and st.deleted is not None:
        fname = f"mask-{len(st.segments)}.npz"
        path = os.path.join(version_dir, fname)
        os.makedirs(version_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            np.savez(f, packed=np.packbits(st.deleted),
                     rows=np.int64(len(st.deleted)))
        os.replace(tmp, path)
        ops.append({"kind": "delete", "file": fname,
                    "rows": int(len(st.deleted)),
                    "deleted": st.deleted_count(),
                    "digest": st.deleted_digest()})
        files.append(path)
        st.deleted_dirty = False
    if not ops:
        return None
    ops_path = os.path.join(version_dir, OPS_NAME)
    integrity.write_json_atomic(
        ops_path, integrity.stamp_crc(
            {"version": 1, "table": table.name, "note": note,
             "ops": ops}))
    # per-segment digest manifest: delta files get the same re-hash-on-
    # load verification as transcode output (io.verify_digests)
    integrity.write_manifest(version_dir)
    # a fault here models the torn commit: files written, the snapshot
    # manifest never updated, the reader serves the prior version
    from nds_tpu_torch.resilience import faults
    faults.fault_point("store.commit", table=table.name,
                       version_dir=version_dir, note=note)
    return [ops_path] + files


def split_paths(paths) -> "tuple[list, dict]":
    """Partition a snapshot manifest's path list into (base files,
    {version -> version dir}) — delta artifacts live under
    ``<table>/_v<N>/`` and must not reach the format-sniffing reader."""
    base, versions = [], {}
    for p in paths:
        m = _VDIR_RE.search(p)
        if m is None:
            base.append(p)
        else:
            versions.setdefault(int(m.group(1)),
                                os.path.dirname(p))
    return base, versions


def load_versioned(name: str, schema, paths: list,
                   default_fmt: str) -> HostTable:
    """Rebuild the effective table from a snapshot lineage: read the
    base files, then replay each committed version's op list in order
    (inserts re-append their segments — re-deriving the same digests
    and merged-stats specs the writer had — and deletes restore the
    cumulative bitmask). Files re-hash against the version dir's
    digest manifest when io.verify_digests is on; a recorded-vs-
    recomputed segment digest mismatch is a CorruptArtifact."""
    import json

    from nds_tpu_torch.io import csv_io, integrity
    base_paths, versions = split_paths(paths)
    table = csv_io.read_paths_auto(base_paths, name, schema,
                                   default_fmt)
    for v in sorted(versions):
        vdir = versions[v]
        ops_path = os.path.join(vdir, OPS_NAME)
        try:
            with open(ops_path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            raise integrity.CorruptArtifact(
                ops_path, "readable op list", f"unreadable: {e}")
        if not integrity.check_crc(doc):
            raise integrity.CorruptArtifact(
                ops_path, "valid crc", "crc mismatch")
        for op in doc.get("ops", []):
            path = os.path.join(vdir, op["file"])
            integrity.verify_paths([path], name)
            if op["kind"] == "insert":
                seg = csv_io.read_table_fmt(path, name, schema,
                                            "parquet")
                table = append_segment(table, seg,
                                       seg_id=op.get("seg_id", ""))
                st = state_of(table)
                got = st.segments[-1].digest
                if op.get("digest") and got != op["digest"]:
                    raise integrity.CorruptArtifact(
                        path, op["digest"], got)
                st.segments[-1].persisted = True
                st.segments[-1].table = None
            elif op["kind"] == "delete":
                with np.load(path) as z:
                    rows = int(z["rows"])
                    deleted = np.unpackbits(
                        z["packed"])[:rows].astype(bool)
                if rows != table.nrows:
                    raise integrity.CorruptArtifact(
                        path, f"{table.nrows} rows", f"{rows} rows")
                st = _ensure_state(table)
                st.deleted = deleted
                st.deleted_dirty = False
                new = HostTable(table.name, table.schema,
                                dict(table.columns))
                setattr(new, ATTR, st)
                st_digest = st.deleted_digest()
                if op.get("digest") and op["digest"] != st_digest:
                    raise integrity.CorruptArtifact(
                        path, op["digest"], st_digest)
                table = new
    # memoize the composed digest now (cheap; avoids a full re-hash on
    # tables that never mutated in this process)
    table_digest(table)
    return table


def has_delta_paths(paths) -> bool:
    return any(_VDIR_RE.search(p) for p in paths)
