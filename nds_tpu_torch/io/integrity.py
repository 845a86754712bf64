"""Artifact integrity: per-table digest manifests + CRC-stamped JSON.

Port copy of ``nds_tpu/io/integrity.py`` (standard library only). A
long NDS run reads back what it wrote earlier (transcoded warehouses,
cached .npz tables); a torn write or a flipped bit in any of them must
surface as a loud failure that names the file, never as silently wrong
query output. Two mechanisms:

- **Digest manifests** — ``write_manifest(table_dir)`` records a
  ``_manifest.json`` of ``{relpath: sha256}`` for every data file under
  a table directory (transcode writes one per table; the table cache
  stamps its .npz saves). ``verify_paths(paths, name)`` re-hashes each
  file on load and raises :class:`CorruptArtifact` — naming the file
  and the expected and actual digests — on any mismatch. Files a
  manifest does not cover are skipped, so a warehouse without manifests
  still loads. Gated by ``NDS_TPU_VERIFY_DIGESTS`` (the reference's
  name, so that one setting drives both packages) or the power CLIs'
  ``io.verify_digests``, because hashing a warehouse is not free.
  ``verify_manifest`` answers unconditionally whether finished work can
  be trusted (transcode's ``--resume``).

- **CRC-stamped JSON** — ``stamp_crc``/``check_crc`` embed a crc32 of
  the canonical (sorted-key) JSON encoding into state documents a later
  run trusts, so a torn write is told apart from valid but different
  state. ``write_json_atomic`` is the tmp+rename writer.

Trimmed from the reference: the watchdog heartbeat per hashed file and
the ``corrupt_artifacts_total`` counter in ``verify_paths`` (ROADMAP
Queue 1 items 15 and 7).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import zlib

MANIFEST_NAME = "_manifest.json"
VERIFY_ENV = "NDS_TPU_VERIFY_DIGESTS"

# how many parent directories of a data file are searched for a
# manifest (hive-partitioned facts nest <table>/<col>=<val>/part-N)
_MANIFEST_SEARCH_DEPTH = 3


class CorruptArtifact(RuntimeError):
    """A data file's content no longer matches its recorded digest.

    Deterministic by nature: the bytes on disk are wrong, and reading
    them again cannot help."""

    def __init__(self, path: str, expected: str, actual: str):
        super().__init__(
            f"corrupt artifact {path}: sha256 expected {expected}, "
            f"got {actual}")
        self.path = path
        self.expected = expected
        self.actual = actual


# --------------------------------------------------------- verify gate

_verify_override: bool | None = None


def set_verify(on: bool | None) -> None:
    """Programmatic gate (None = defer to the env var). The power loop
    turns this on when ``io.verify_digests`` is set."""
    global _verify_override
    _verify_override = on


def verify_enabled() -> bool:
    if _verify_override is not None:
        return _verify_override
    return os.environ.get(VERIFY_ENV, "0") == "1"


# ------------------------------------------------------------- digests

def file_digest(path: str) -> str:
    """Streaming sha256 over the file's bytes (hex)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _data_files(table_dir: str) -> list[str]:
    out = []
    for root, _dirs, files in os.walk(table_dir):
        for f in files:
            if (f.startswith(".") or f == MANIFEST_NAME
                    or f.endswith(".tmp")):
                continue
            out.append(os.path.relpath(os.path.join(root, f), table_dir))
    return sorted(out)


def write_manifest(table_dir: str,
                   files: list[str] | None = None) -> str:
    """Record ``{relpath: sha256}`` for every data file under
    ``table_dir`` (or just ``files``, relative paths) into its
    ``_manifest.json``. Returns the manifest path."""
    rels = files if files is not None else _data_files(table_dir)
    digests = {rel: file_digest(os.path.join(table_dir, rel))
               for rel in rels}
    path = os.path.join(table_dir, MANIFEST_NAME)
    write_json_atomic(path, {"version": 1, "files": digests})
    return path


def update_manifest(table_dir: str, files: list[str]) -> str:
    """Merge digests for ``files`` (relpaths) into an existing manifest
    (create it when absent) — the incremental writer for caches that
    save one table at a time."""
    path = os.path.join(table_dir, MANIFEST_NAME)
    doc = _load_manifest(path) or {"version": 1, "files": {}}
    for rel in files:
        doc["files"][rel] = file_digest(os.path.join(table_dir, rel))
    write_json_atomic(path, doc)
    return path


def _load_manifest(path: str) -> dict | None:
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or "files" not in doc:
        return None
    return doc


# manifest docs cached by (dir, mtime_ns): a 25-table warehouse load
# hits each table's manifest once per file, not once per read
_manifest_cache: dict = {}


def _manifest_for(path: str) -> tuple[dict, str] | None:
    """Walk up from a data file looking for the table-level manifest;
    returns (files dict, base dir) or None."""
    d = os.path.dirname(os.path.abspath(path))
    for _ in range(_MANIFEST_SEARCH_DEPTH):
        mpath = os.path.join(d, MANIFEST_NAME)
        try:
            mtime = os.stat(mpath).st_mtime_ns
        except OSError:
            parent = os.path.dirname(d)
            if parent == d:
                return None
            d = parent
            continue
        key = (d, mtime)
        doc = _manifest_cache.get(key)
        if doc is None:
            doc = _load_manifest(mpath)
            if doc is None:
                return None
            _manifest_cache.clear()  # one live entry per dir is enough
            _manifest_cache[key] = doc
        return doc["files"], d
    return None


def verify_manifest(table_dir: str) -> bool:
    """True when ``table_dir`` holds a manifest and EVERY recorded file
    re-hashes to its recorded digest (unconditionally — the verify
    gate does not apply: callers ask this question to decide whether
    finished work can be trusted, e.g. a resumed transcode skipping
    tables the interrupted run already completed). False on a missing/
    unreadable manifest, a missing file, or any digest mismatch."""
    doc = _load_manifest(os.path.join(table_dir, MANIFEST_NAME))
    if doc is None or not doc.get("files"):
        return False
    try:
        for rel, expected in doc["files"].items():
            if file_digest(os.path.join(table_dir, rel)) != expected:
                return False
    except OSError:
        return False
    return True


def clear_cache() -> None:
    """Drop cached manifests (tests that rewrite files in place)."""
    _manifest_cache.clear()


def verify_paths(paths: list[str] | str, name: str = "") -> None:
    """Re-hash each file against the covering manifest; raises
    CorruptArtifact on the first mismatch. No-op when verification is
    disabled; files without a covering manifest entry are skipped
    (legacy warehouses and maintenance-written versions stay loadable).
    """
    if not verify_enabled():
        return
    if isinstance(paths, str):
        paths = [paths]
    for p in paths:
        found = _manifest_for(p)
        if found is None:
            continue
        files, base = found
        rel = os.path.relpath(os.path.abspath(p), base)
        expected = files.get(rel)
        if expected is None:
            continue
        actual = file_digest(p)
        if actual != expected:
            raise CorruptArtifact(p, expected, actual)


# --------------------------------------------------- CRC-stamped JSON

def json_crc(obj) -> str:
    """crc32 (hex) of the canonical sorted-key JSON encoding."""
    blob = json.dumps(obj, sort_keys=True, default=str)
    return f"{zlib.crc32(blob.encode()) & 0xFFFFFFFF:08x}"


def stamp_crc(doc: dict, key: str = "crc") -> dict:
    """Return ``doc`` with a crc32 of its (crc-less) content under
    ``key`` — stamp immediately before writing."""
    body = {k: v for k, v in doc.items() if k != key}
    return {**body, key: json_crc(body)}


def check_crc(doc: dict, key: str = "crc") -> bool:
    """True when the stamp matches (or the doc predates stamping —
    an unstamped doc is not evidence of a torn write)."""
    if not isinstance(doc, dict) or key not in doc:
        return True
    body = {k: v for k, v in doc.items() if k != key}
    return doc[key] == json_crc(body)


def write_json_atomic(path: str, doc, indent: int = 2) -> None:
    """tmp + rename JSON write: a crash mid-write leaves the previous
    complete file, never a torn one; readers never see partial JSON.
    The tmp is pid- AND thread-suffixed: two processes pointed at one
    path each rename a complete file into place, and two threads of one
    process never truncate each other's stream mid-write."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=indent)
    os.replace(tmp, path)
