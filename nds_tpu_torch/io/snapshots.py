"""Warehouse snapshot log: a minimal versioned table format.

Port copy of ``nds_tpu/io/snapshots.py`` over the port's
``io/integrity.py``. A torn manifest warns and counts in this module's
``resets_total``, which the BenchReport's ``degradations`` block reads
(the reference's ``snapshot_resets_total`` metric comes with the metrics
registry, ROADMAP Queue 1 item 7).

The upstream benchmark leans on Iceberg snapshots for maintenance rollback
(`nds/nds_rollback.py:46-51` calls
``system.rollback_to_timestamp``); this is the minimal
equivalent: a ``_snapshots.json`` manifest at the warehouse root maps
each committed version to {table: [parquet files]}. Mutations write new
files and append a manifest entry; nothing is rewritten in place, so
rolling back is truncating the manifest (old files remain valid).

The manifest payload is CRC-stamped (io/integrity.py): a torn or
corrupted ``_snapshots.json`` is detected on open and degrades to the
on-disk baseline (version 0) with a warning — committed version files
are never rewritten, so the baseline is always still valid — instead
of crashing the run or silently serving a spliced version map.

Layout:
  warehouse/
    _snapshots.json                  # [{version, timestamp, tables}]
    store_sales/...                  # v0 files (transcode output)
    store_sales/_v1/part-0.parquet   # files written by version 1
"""

from __future__ import annotations

import json
import os
import time

from nds_tpu_torch.io import integrity

# torn manifests read in this process
resets_total = 0

MANIFEST = "_snapshots.json"


def _walk_parquet(tdir: str) -> list[str]:
    return sorted(
        os.path.relpath(os.path.join(root, f), os.path.dirname(tdir))
        for root, dirs, files in os.walk(tdir)
        if not os.path.basename(root).startswith("_v")
        for f in files if f.endswith(".parquet"))


class SnapshotLog:
    def __init__(self, warehouse_dir: str):
        self.dir = warehouse_dir
        self.path = os.path.join(warehouse_dir, MANIFEST)
        self.entries = self._read(self.path)

    @staticmethod
    def _read(path: str) -> list:
        if not os.path.exists(path):
            return []
        try:
            with open(path) as f:
                doc = json.load(f)
        except ValueError:
            doc = None
        if isinstance(doc, list):
            return doc  # legacy unstamped manifest: still trusted
        if isinstance(doc, dict) and integrity.check_crc(doc):
            return doc.get("entries", [])
        # torn/corrupt: committed version files are immutable, so the
        # on-disk baseline (version 0) is always a valid fallback, said
        # aloud so that committed versions reverting to v0 cannot hide
        print(f"WARNING: snapshot manifest {path} is torn/corrupt — "
              f"falling back to the version-0 baseline")
        global resets_total
        resets_total += 1
        return []

    def _write(self) -> None:
        integrity.write_json_atomic(
            self.path,
            integrity.stamp_crc({"version": 1, "entries": self.entries}),
            indent=1)

    def baseline(self, tables: list[str]) -> dict:
        """Version-0 file map discovered from the transcode layout."""
        return {t: _walk_parquet(os.path.join(self.dir, t))
                for t in tables
                if os.path.isdir(os.path.join(self.dir, t))}

    def current(self, tables: list[str]) -> dict:
        """{table: [abs paths]} of the latest committed version (or the
        on-disk baseline when no commits exist)."""
        if self.entries:
            m = self.entries[-1]["tables"]
        else:
            m = self.baseline(tables)
        return {t: [os.path.join(self.dir, p) for p in paths]
                for t, paths in m.items()}

    def commit(self, new_files: dict, note: str = "") -> int:
        """Append a version whose table map is the previous version's
        with ``new_files`` ({table: [rel paths]}) replacing those
        tables' files."""
        base = (dict(self.entries[-1]["tables"]) if self.entries
                else self.baseline(list(new_files)))
        # baseline() above only covers the mutated tables when this is
        # the first commit; fill in every other on-disk table so the
        # manifest is complete
        for t in os.listdir(self.dir):
            tdir = os.path.join(self.dir, t)
            if os.path.isdir(tdir) and t not in base:
                files = _walk_parquet(tdir)
                if files:
                    base[t] = files
        base.update(new_files)
        version = (self.entries[-1]["version"] + 1 if self.entries
                   else 1)
        self.entries.append({"version": version,
                             "timestamp": time.time(),
                             "note": note, "tables": base})
        self._write()
        return version

    def commit_delta(self, table: str, new_rel_paths: list,
                     note: str = "") -> int:
        """Append a version whose file list for ``table`` is the
        previous version's files PLUS ``new_rel_paths`` (delta lineage:
        base files + every committed delta artifact, in commit order —
        the reader replays them ascending). This append IS the atomic
        commit point: until the stamped manifest lands, the delta files
        are unreferenced and the reader serves the prior version."""
        prev = (self.entries[-1]["tables"] if self.entries
                else self.baseline([table]))
        paths = list(prev.get(table, [])) + [
            p for p in new_rel_paths if p not in prev.get(table, [])]
        return self.commit({table: paths}, note=note)

    def has_note(self, note: str) -> bool:
        """True when a committed version carries ``note`` — maintenance
        resume uses this to detect a crash that landed AFTER a refresh
        function's snapshot commit but BEFORE its journal record (the
        function's effects are durable; re-running would double-apply)."""
        return any(e.get("note") == note for e in self.entries)

    def rollback_to_timestamp(self, ts: float) -> int | None:
        """Drop every version committed after ``ts``
        (`nds/nds_rollback.py:46-51` semantics). Returns the surviving
        version number, or None if rolled back to the baseline."""
        self.entries = [e for e in self.entries if e["timestamp"] <= ts]
        self._write()
        return self.entries[-1]["version"] if self.entries else None

    def version_dir(self, table: str, version: int) -> str:
        d = os.path.join(self.dir, table, f"_v{version}")
        os.makedirs(d, exist_ok=True)
        return d
