"""The query journal's write side.

Port of ``config_digest`` and the recording half of ``QueryJournal`` in
``nds_tpu/resilience/journal.py``: the in-process throughput streams
(``nds/throughput.py``) append every finished statement (name, wall ms,
status, result digest, incarnation) to one journal a stream,
``<stream>_queries.json`` in the run directory, so a round leaves a
per-statement record with result digests, not only its stdout. Each
query also records its execution starts, before dispatch. Writes are
atomic (a temporary file and a rename) and the payload is CRC-stamped
(``io/integrity.py``), in the reference's format.

Waiting for ROADMAP Queue 1 item 15 (the resilience layer): the read
side (``load``, ``begin_incarnation``, ``done``, ``entry``), so
``--resume``; ``mark_aborted`` (the drain); ``PhaseJournal`` (the
orchestrators, item 17); the ``journal_resets_total`` counter (item 7).
"""

from __future__ import annotations

import hashlib
import json
import threading
import time

from nds_tpu_torch.io import integrity


def config_digest(cfg: dict) -> str:
    """Stable fingerprint of the bench config (sorted-key JSON)."""
    blob = json.dumps(cfg, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


class QueryJournal:
    """Per-phase, query-granular journal: one file a phase, one entry a
    statement. ``start(name)`` appends the current incarnation to the
    query's ``starts`` before dispatch; ``record(name, ...)`` marks it
    done with its wall clock, final status and result digest.
    Thread-safe."""

    VERSION = 1

    def __init__(self, path: str, phase: str = "",
                 digest: str | None = None):
        self.path = path
        self.phase = phase
        self.digest = digest
        # rank-0-writes: other ranks keep their state in memory
        self.readonly = False
        self._lock = threading.Lock()
        self.state: dict = self._fresh()

    def _fresh(self) -> dict:
        return {"version": self.VERSION, "phase": self.phase,
                "config_digest": self.digest, "incarnation": 0,
                "queries": {}}

    @property
    def incarnation(self) -> int:
        with self._lock:
            return int(self.state.get("incarnation", 0))

    def start(self, name: str) -> None:
        """Mark an execution attempt before dispatch (an atomic write: a
        process killed one instruction later still leaves the start)."""
        with self._lock:
            q = self.state["queries"].setdefault(name, {"starts": []})
            q.setdefault("starts", []).append(
                int(self.state.get("incarnation", 0)))
        self.write()

    def record(self, name: str, wall_ms: float, status: str,
               result_digest: str | None = None, **fields) -> None:
        """Journal a finished statement (Completed or Failed: a failed
        query is a final state of the power-run contract). ``fields``:
        more of the statement's record (the throughput streams add its
        ``placement``, ``reschedules`` and ``retries``)."""
        with self._lock:
            q = self.state["queries"].setdefault(name, {"starts": []})
            q.update({"done": True, "wall_ms": round(float(wall_ms), 3),
                      "status": str(status),
                      "incarnation": int(self.state.get("incarnation", 0)),
                      "ts": time.time()})
            if result_digest:
                q["result_digest"] = result_digest
            q.update(fields)
        self.write()

    def completed(self) -> dict:
        """{name: entry} of every journaled-done statement."""
        with self._lock:
            return {n: dict(e) for n, e in self.state["queries"].items()
                    if e.get("done")}

    def write(self) -> None:
        if self.readonly:
            return
        with self._lock:
            doc = integrity.stamp_crc(
                json.loads(json.dumps(self.state, default=str)))
            # inside the lock: a later snapshot must never be replaced
            # by an earlier one racing it to the rename
            integrity.write_json_atomic(self.path, doc)

    def reset(self) -> None:
        """Fresh-run entry: drop prior state, on disk too."""
        with self._lock:
            self.state = self._fresh()
        self.write()
