"""Heartbeat watchdog: hang detection for unattended benchmark runs.

Port of ``nds_tpu/resilience/watchdog.py``. A query that hangs (a
wedged collective, a stalled stream process) would otherwise stall the
whole benchmark silently; this module is the control plane of one
process:

- **Heartbeats**: the power loop, the executors, the exchange and the
  pipeline call ``beat(unit, query=..., phase=..., attempt=...)`` at
  their progress points: a timestamped dict store under one lock.
  ``snapshot_heartbeats()`` renders the registry as ``{unit: {age_s,
  query, phase, attempt, count}}``.
- **Heartbeat file** (:class:`HeartbeatFile`,
  ``NDS_TPU_HEARTBEAT_FILE=path[:interval]``): a daemon thread writes
  ``{"ts", "progress", "heartbeats"}`` atomically every ``interval``
  seconds, which is how the parent-side stream supervisor
  (``resilience/supervise.py``) sees a child's liveness. It is the part
  of the reference's metrics snapshot (``NDS_TPU_METRICS_SNAP``) that
  supervision reads; the counters, gauges and histograms beside it come
  with the metrics registry (ROADMAP Queue 1 item 7).
- **Watchdog**: a daemon thread (``engine.watchdog.stall_s`` /
  ``engine.watchdog.action``, or ``NDS_TPU_WATCHDOG=stall_s[:action]``)
  that alarms when the newest beat across all units is older than
  ``stall_s``. On a stall it dumps every thread's stack to
  ``stall-<query>.json`` in the run dir and, with ``action=kill`` (the
  supervised streams' setting), exits the process with
  :data:`EXIT_STALLED` so the supervisor can restart the stream. Each
  stall reports once; a new beat re-arms the alarm. The reference's
  report also embeds the live metrics snapshot and what its stall hooks
  (the flight recorder, the profiler) return: those wait for item 7, and
  the report names the snapshot under ``omitted``.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback

WATCHDOG_ENV = "NDS_TPU_WATCHDOG"
# stream supervisors name each child's unit through this variable (the
# power loop falls back to "power-<suite>"); restarted incarnations get
# a "#rN" suffix so seeded chaos schedules can target one incarnation
STREAM_ENV = "NDS_TPU_STREAM"
HEARTBEAT_FILE_ENV = "NDS_TPU_HEARTBEAT_FILE"
DEFAULT_INTERVAL_S = 5.0

# exit code a kill-action watchdog terminates with: distinguishable
# from query failures (1) and signals (<0) in the supervisor's summary
EXIT_STALLED = 86

# what a stall report leaves out, and the item that brings it
OMITTED = {"metrics": "the live metrics snapshot: ROADMAP Queue 1 item 7 "
                      "(observability)"}

_lock = threading.Lock()
_beats: dict[str, dict] = {}


def beat(unit: str, query: str | None = None, phase: str | None = None,
         attempt: int | None = None, **info) -> None:
    """Publish one monotonic heartbeat for ``unit``. ``count`` grows a
    beat, so watchers can tell a re-read beat from a new one."""
    now = time.monotonic()
    with _lock:
        prev = _beats.get(unit)
        _beats[unit] = {
            "t": now, "query": query, "phase": phase,
            "attempt": attempt,
            "count": (prev["count"] + 1) if prev else 1, **info,
        }


def clear_unit(unit: str) -> None:
    """Drop a finished unit: its last beat must not age into a phantom
    stall."""
    with _lock:
        _beats.pop(unit, None)


def reset() -> None:
    """Drop every unit (tests)."""
    with _lock:
        _beats.clear()


def snapshot_heartbeats() -> dict:
    """{unit: {age_s, query, phase, attempt, count}} at call time."""
    now = time.monotonic()
    with _lock:
        return {
            unit: {**{k: v for k, v in e.items() if k != "t"},
                   "age_s": round(now - e["t"], 3)}
            for unit, e in _beats.items()
        }


def _freshest() -> tuple[str, dict] | None:
    with _lock:
        if not _beats:
            return None
        unit = max(_beats, key=lambda u: _beats[u]["t"])
        return unit, dict(_beats[unit])


def _thread_stacks() -> dict:
    """{thread name: [frame strings]} for every live thread."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for ident, frame in sys._current_frames().items():
        label = names.get(ident, f"thread-{ident}")
        out[label] = [line.rstrip("\n")
                      for line in traceback.format_stack(frame)]
    return out


def dump_stall_report(run_dir: str, unit: str, entry: dict,
                      stall_s: float, action: str) -> str:
    """Write ``stall-<query>.json`` (all-thread stacks and the stalled
    unit's last heartbeat) into ``run_dir``; returns the path. Repeat
    stalls suffix ``-2``, ``-3``..."""
    from nds_tpu_torch.io.integrity import write_json_atomic
    label = str(entry.get("query") or unit or "unknown")
    label = "".join(c if (c.isalnum() or c in "-_.") else "_"
                    for c in label)
    doc = {
        "unit": unit,
        "query": entry.get("query"),
        "phase": entry.get("phase"),
        "attempt": entry.get("attempt"),
        "age_s": round(time.monotonic() - entry["t"], 3),
        "stall_s": stall_s,
        "action": action,
        "ts": time.time(),
        "pid": os.getpid(),
        "heartbeats": snapshot_heartbeats(),
        "threads": _thread_stacks(),
        "omitted": dict(OMITTED),
    }
    os.makedirs(run_dir or ".", exist_ok=True)
    path = os.path.join(run_dir or ".", f"stall-{label}.json")
    n = 1
    while os.path.exists(path):
        n += 1
        path = os.path.join(run_dir or ".", f"stall-{label}-{n}.json")
    write_json_atomic(path, doc)
    return path


class Watchdog:
    """Daemon thread alarming on heartbeat silence.

    ``action``: ``report`` dumps the stall report and keeps watching;
    ``kill`` dumps and then exits with EXIT_STALLED, the behavior for a
    supervised subprocess stream."""

    ACTIONS = ("report", "kill")

    def __init__(self, stall_s: float, action: str = "report",
                 run_dir: str = ".", interval_s: float | None = None,
                 _exit=os._exit):
        if stall_s <= 0:
            raise ValueError("stall_s must be > 0")
        if action not in self.ACTIONS:
            raise ValueError(f"unknown watchdog action {action!r} "
                             f"(known: {', '.join(self.ACTIONS)})")
        self.stall_s = stall_s
        self.action = action
        self.run_dir = run_dir
        self.interval_s = interval_s or max(0.2, stall_s / 4.0)
        self.stall_reports: list[str] = []
        self._exit = _exit
        self._reported_at: float | None = None  # beat time last reported
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @classmethod
    def from_config(cls, config, run_dir: str) -> "Watchdog | None":
        """``engine.watchdog.stall_s`` / ``engine.watchdog.action``
        (None when unconfigured)."""
        v = config.get("engine.watchdog.stall_s")
        if v is None or float(v) <= 0:
            return None
        return cls(float(v), config.get("engine.watchdog.action",
                                        "report"), run_dir)

    @classmethod
    def from_env(cls, run_dir: str) -> "Watchdog | None":
        """``NDS_TPU_WATCHDOG=stall_s[:action]``: how a stream
        supervisor arms its children."""
        spec = os.environ.get(WATCHDOG_ENV)
        if not spec:
            return None
        stall, _sep, action = spec.partition(":")
        return cls(float(stall), action or "report", run_dir)

    def check_once(self, now: float | None = None) -> str | None:
        """One alarm evaluation (the thread loop body; tests drive it
        directly). Returns the stall-report path when a stall was just
        reported, else None."""
        newest = _freshest()
        if newest is None:
            return None
        unit, entry = newest
        now = time.monotonic() if now is None else now
        if now - entry["t"] <= self.stall_s:
            return None
        if self._reported_at == entry["t"]:
            return None  # this silence is already on disk
        self._reported_at = entry["t"]
        path = dump_stall_report(self.run_dir, unit, entry,
                                 self.stall_s, self.action)
        self.stall_reports.append(path)
        print(f"[watchdog] no heartbeat for {now - entry['t']:.1f}s "
              f"(unit={unit} query={entry.get('query')} "
              f"phase={entry.get('phase')}) — report: {path}")
        if self.action == "kill":
            sys.stdout.flush()
            sys.stderr.flush()
            self._exit(EXIT_STALLED)
        return path

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.check_once()
            except Exception as exc:  # noqa: BLE001 - never kill the run
                print(f"[watchdog] check failed: "
                      f"{type(exc).__name__}: {exc}")

    def start(self) -> "Watchdog":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="nds-watchdog", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


def parse_spec(spec: str) -> tuple[str, float]:
    """``path[:interval_s]`` -> (path, interval). A trailing segment that
    does not parse as a number is part of the path."""
    path, sep, tail = spec.rpartition(":")
    if sep:
        try:
            return path, max(0.05, float(tail))
        except ValueError:
            pass
    return spec, DEFAULT_INTERVAL_S


class HeartbeatFile:
    """Daemon thread writing ``{"ts", "progress", "heartbeats"}`` to
    ``path`` every ``interval_s`` (atomically), and once more on
    ``stop()``. ``progress`` is a caller-owned dict the power loop
    mutates in place (``queries_completed``, ``queries_total``,
    ``current_query``)."""

    def __init__(self, path: str, interval_s: float = DEFAULT_INTERVAL_S,
                 progress: dict | None = None):
        self.path = path
        self.interval_s = interval_s
        self.progress = progress if progress is not None else {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._warned = False

    @classmethod
    def from_env(cls, progress: dict | None = None
                 ) -> "HeartbeatFile | None":
        spec = os.environ.get(HEARTBEAT_FILE_ENV)
        if not spec:
            return None
        path, interval = parse_spec(spec)
        return cls(path, interval, progress=progress)

    def write_once(self) -> None:
        from nds_tpu_torch.io.integrity import write_json_atomic
        doc = {"ts": time.time(), "progress": dict(self.progress),
               "heartbeats": snapshot_heartbeats()}
        try:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            write_json_atomic(self.path, doc)
        except OSError as exc:
            if not self._warned:
                self._warned = True
                print(f"[watchdog] heartbeat file {self.path} not "
                      f"written: {exc}")

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.write_once()

    def start(self) -> "HeartbeatFile":
        self.write_once()
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="nds-heartbeat-file", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.write_once()
