"""Phase and query journals: crash-resumable benchmark orchestration.

Port of ``nds_tpu/resilience/journal.py``, in the reference's formats,
so a journal either package writes loads in the other:

- :class:`PhaseJournal`: the orchestrator (``nds/bench.py``) records
  each completed phase, with the timings the composite metric needs,
  into ``bench_state.json``; ``--resume`` replays completed phases from
  the journal instead of running them again.
- :class:`QueryJournal`: the power loop (``utils/power_core.py``), the
  maintenance CLI and the in-process throughput streams append every
  finished statement (name, wall ms, status, result digest,
  incarnation) to a journal a phase, so ``--resume`` on the power CLIs
  restarts mid-phase at the next unfinished statement. Each query also
  records its execution starts per incarnation, which is how the soak
  scenarios prove no query ran twice.

Both journals are guarded by a digest of the driving config: resuming
under a different config refuses loudly (``JournalMismatch``). Writes
are atomic (a temporary file and a rename) and the payload is
CRC-stamped (``io/integrity.py``): a torn or tampered journal is
detected on ``--resume`` and degrades to a fresh run with a warning,
never a crash and never a splice of half-recorded state. Every such
reset counts in ``resets_total``, which the BenchReport's
``degradations`` block reports (``utils/report.py``); the reference's
``journal_resets_total`` metric comes with the metrics registry
(ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time

from nds_tpu_torch.io import integrity

# torn or corrupt journals thrown away in this process
resets_total = 0


def _count_reset() -> None:
    global resets_total
    resets_total += 1


class JournalMismatch(RuntimeError):
    """The on-disk journal belongs to a different bench config."""


def config_digest(cfg: dict) -> str:
    """Stable fingerprint of the bench config (sorted-key JSON)."""
    blob = json.dumps(cfg, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _read_state(path: str, what: str) -> "dict | None":
    """The CRC-checked JSON state at ``path``, or None (warned and
    counted) where it is torn: truncated JSON or a CRC mismatch."""
    try:
        with open(path) as f:
            state = json.load(f)
        torn = not isinstance(state, dict) or not integrity.check_crc(state)
    except ValueError:
        torn, state = True, None
    if torn:
        print(f"WARNING: {what} {path} is torn/corrupt — ignoring it "
              f"and starting fresh")
        _count_reset()
        return None
    state.pop("crc", None)
    return state


class PhaseJournal:
    """Completed-phase record keyed by phase name.

    ``complete(name, **timings)`` journals a finished phase;
    ``done(name)`` / ``timings(name)`` replay it on resume."""

    VERSION = 1

    def __init__(self, path: str, digest: str | None = None):
        self.path = path
        self.digest = digest
        self.state: dict = {"version": self.VERSION,
                            "config_digest": digest, "phases": {}}

    def load(self) -> bool:
        """Read the journal if present; True when prior state exists.
        Raises JournalMismatch when it was written under a different
        config digest. A torn journal is not prior state: warn and
        return False (running phases again is always correct, replaying
        spliced ones never is)."""
        if not os.path.exists(self.path):
            return False
        state = _read_state(self.path, "journal")
        if state is None:
            return False
        recorded = state.get("config_digest")
        if (self.digest is not None and recorded is not None
                and recorded != self.digest):
            raise JournalMismatch(
                f"{self.path} was written for config {recorded}, "
                f"current config is {self.digest} — refusing to splice "
                f"timings across configs (delete it to start over)")
        self.state = state
        self.state.setdefault("phases", {})
        return bool(self.state["phases"])

    def done(self, name: str) -> bool:
        return name in self.state["phases"]

    def timings(self, name: str) -> dict:
        entry = self.state["phases"].get(name, {})
        return dict(entry.get("timings", {}))

    def complete(self, name: str, **timings) -> None:
        self.state["phases"][name] = {
            "completed_at": time.time(),
            "timings": timings,
        }
        self.write()

    def write(self) -> None:
        integrity.write_json_atomic(self.path,
                                    integrity.stamp_crc(self.state))

    def reset(self) -> None:
        """Fresh-run entry: drop any prior state, on disk too (a run
        without resume must not leave a journal a later --resume could
        replay)."""
        self.state = {"version": self.VERSION,
                      "config_digest": self.digest, "phases": {}}
        self.write()


class QueryJournal:
    """Per-phase, query-granular resume journal: one file a phase, one
    entry a statement. ``start(name)`` appends the current incarnation to
    the query's ``starts`` before dispatch (a process killed mid-query
    leaves a start with no completion); ``record(name, ...)`` marks it
    done with its wall clock, final status and result digest. A resumed
    incarnation (``begin_incarnation``) replays ``done`` queries and runs
    only the unfinished ones. Thread-safe: the drain's deadline thread
    may stamp an abort while the main thread is inside a query."""

    VERSION = 1

    def __init__(self, path: str, phase: str = "",
                 digest: str | None = None):
        self.path = path
        self.phase = phase
        self.digest = digest
        # rank-0-writes: other ranks keep their state in memory (their
        # replay decisions must match the primary's)
        self.readonly = False
        self._lock = threading.Lock()
        self.state: dict = self._fresh()

    def _fresh(self) -> dict:
        return {"version": self.VERSION, "phase": self.phase,
                "config_digest": self.digest, "incarnation": 0,
                "queries": {}}

    def _incarnation_locked(self) -> int:
        return int(self.state.get("incarnation", 0))

    @property
    def incarnation(self) -> int:
        with self._lock:
            return self._incarnation_locked()

    def load(self) -> bool:
        """Read prior state, with PhaseJournal.load's contract: a torn
        journal warns, counts and returns False; a journal of a
        different config raises JournalMismatch."""
        if not os.path.exists(self.path):
            return False
        state = _read_state(self.path, "query journal")
        if state is not None and not isinstance(state.get("queries"),
                                                dict):
            print(f"WARNING: query journal {self.path} is torn/corrupt "
                  f"— ignoring it and starting fresh")
            _count_reset()
            state = None
        if state is None:
            return False
        recorded = state.get("config_digest")
        if (self.digest is not None and recorded is not None
                and recorded != self.digest):
            raise JournalMismatch(
                f"{self.path} was written for config {recorded}, "
                f"current config is {self.digest} — refusing to resume "
                f"a different workload (delete it to start over)")
        with self._lock:
            self.state = state
            self.state.setdefault("incarnation", 0)
        return bool(state["queries"])

    def begin_incarnation(self) -> int:
        """A resumed process bumps the incarnation; every start and
        completion it records carries the new number."""
        with self._lock:
            inc = self._incarnation_locked() + 1
            self.state["incarnation"] = inc
        self.write()
        return inc

    # ------------------------------------------------------- recording

    def start(self, name: str) -> None:
        """Mark an execution attempt before dispatch (an atomic write: a
        process killed one instruction later still leaves the start)."""
        with self._lock:
            q = self.state["queries"].setdefault(name, {"starts": []})
            q.setdefault("starts", []).append(self._incarnation_locked())
        self.write()

    def record(self, name: str, wall_ms: float, status: str,
               result_digest: str | None = None, **fields) -> None:
        """Journal a finished statement (Completed or Failed: a failed
        query is a final state of the power-run contract; resume must not
        run it again and change the metric). ``fields``: more of the
        statement's record (the throughput streams add its
        ``placement``, ``reschedules`` and ``retries``)."""
        with self._lock:
            q = self.state["queries"].setdefault(name, {"starts": []})
            q.pop("aborted", None)
            q.update({"done": True, "wall_ms": round(float(wall_ms), 3),
                      "status": str(status),
                      "incarnation": self._incarnation_locked(),
                      "ts": time.time()})
            if result_digest:
                q["result_digest"] = result_digest
            q.update(fields)
        self.write()

    def mark_aborted(self, name: str | None,
                     reason: str = "drain-deadline") -> None:
        """The drain deadline expired with this query in flight: stamp
        it explicitly not done. Safe from any thread; no-op without a
        query."""
        if not name:
            return
        with self._lock:
            q = self.state["queries"].setdefault(name, {"starts": []})
            if q.get("done"):
                return  # finished after all: completion wins
            q["aborted"] = reason
        self.write()

    # --------------------------------------------------------- readout

    def done(self, name: str) -> bool:
        with self._lock:
            return bool(self.state["queries"].get(name, {}).get("done"))

    def entry(self, name: str) -> dict:
        with self._lock:
            return dict(self.state["queries"].get(name, {}))

    def completed(self) -> dict:
        """{name: entry} of every journaled-done statement."""
        with self._lock:
            return {n: dict(e) for n, e in self.state["queries"].items()
                    if e.get("done")}

    def starts(self, name: str) -> list:
        with self._lock:
            return list(self.state["queries"].get(name,
                                                  {}).get("starts", []))

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
