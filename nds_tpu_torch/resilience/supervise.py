"""Supervised subprocess stream fleets: liveness, kill, restart-once.

Port of the ``StreamSupervisor`` half of
``nds_tpu/resilience/supervise.py``. The throughput CLIs fan one power
CLI subprocess out a stream; the supervisor watches them:

- **Liveness** comes from each child's heartbeat file
  (``NDS_TPU_HEARTBEAT_FILE``, written by the power loop's
  ``watchdog.HeartbeatFile``): effective heartbeat age = (now - file
  mtime) + the youngest in-file heartbeat age. The file mtime alone is
  not liveness: the writer thread keeps writing while the query loop
  hangs; the heartbeat ages inside are what stop advancing.
- **Kill** is two-layered. Children are armed with
  ``NDS_TPU_WATCHDOG=stall_s:kill``, so a hung but responsive child
  dumps its own stall report and exits ``EXIT_STALLED``; the parent is
  the backstop for a wedged child: past ``2 * stall_s`` of heartbeat
  silence it sends SIGTERM, waits a grace, then SIGKILL, and writes a
  supervisor-side ``stall-<stream>.json``.
- **Restart budget**: a stream that died mid-run restarts at most
  ``max_restarts`` times, from its last completed query (tracked in
  ``<name>_journal.json``, fed by the heartbeat file's progress). The
  restarted incarnation's ``NDS_TPU_STREAM`` is ``<name>#r1``, so seeded
  chaos schedules scoped to ``<name>`` hit only the first incarnation. A
  stream whose heartbeat file shows every query completed is never
  restarted.
- **Resumable exits**: a child that exits 75 (``resilience/drain.py``)
  is relaunched from its last completed query without charging the
  restart budget (counted as ``resumes``, capped by ``max_resumes``).

Exit codes, signals, stalls, restarts and resumes land in
``throughput_summary.json`` (and the returned summary), with
``skipped_queries``, the statements a stream that gave up never ran.

The port's additions: a stream's output goes to its ``log_path``
(``<stream>.log``, as the port's throughput CLIs have always written
it), and the poll interval is 0.1 s, since the elapse is measured at the
poll that sees a stream's exit. ``ReplicaSupervisor`` (the serve fleet's half) comes with
serving (ROADMAP Queue 1 item 9), and the reference's
``stream_*_total`` metrics with the metrics registry (item 7).
"""

from __future__ import annotations

import json
import os
import re
import signal
import subprocess
import time
from dataclasses import dataclass, field
from typing import Callable

from nds_tpu_torch.io.integrity import write_json_atomic
from nds_tpu_torch.resilience.drain import EXIT_RESUMABLE
from nds_tpu_torch.resilience.watchdog import (
    EXIT_STALLED, HEARTBEAT_FILE_ENV, STREAM_ENV, WATCHDOG_ENV,
)

SUMMARY_NAME = "throughput_summary.json"

# multi-statement templates split into query15_part1/2/3-style groups
# whose parts share in-process state (NDS-H q15's CREATE VIEW / SELECT /
# DROP VIEW): a restart must never resume mid-group
_PART_RE = re.compile(r"^(?P<base>.+)_part(?P<n>\d+)$")


def resume_index(queries: list, completed: int) -> int:
    """Where a restarted incarnation should resume: ``completed``,
    snapped back to the start of a split part group when the boundary
    falls mid-group (running a completed part again is idempotent,
    skipping part1's CREATE VIEW fails part2)."""
    i = min(completed, len(queries))
    while 0 < i < len(queries):
        m = _PART_RE.match(str(queries[i]))
        if m and int(m.group("n")) > 1:
            i -= 1
            continue
        break
    return i


@dataclass
class StreamSpec:
    """One supervised stream: how to (re)launch it and what it runs.

    ``make_cmd(incarnation, remaining)`` builds the argv; on restart
    ``remaining`` is the ordered list of query names still to run (the
    caller appends its CLI's ``--query_subset``), ``None`` the full
    stream. ``log_path``: where the child's stdout and stderr go (the
    caller's own when None)."""
    name: str
    make_cmd: Callable
    hb_path: str
    queries: list = field(default_factory=list)
    env: dict | None = None
    log_path: str | None = None


def fold_child_snapshot(st: dict) -> None:
    """Fold a child's latest heartbeat file into its supervisor state:
    the completed-query count and the effective heartbeat age ((now -
    file mtime) + the youngest in-file age)."""
    path = st["spec"].hb_path
    try:
        mtime = os.stat(path).st_mtime
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return  # not written yet, or mid-rename: keep the previous state
    if mtime < st["launched_at"]:
        # a stale file of an earlier incarnation: its ages would kill the
        # fresh restart before its first write
        return
    prog = doc.get("progress") or {}
    done_now = int(prog.get("queries_completed") or 0)
    st["completed"] = st["base_completed"] + done_now
    st["inc_total"] = prog.get("queries_total")
    st["inc_completed"] = done_now
    hbs = doc.get("heartbeats") or {}
    if hbs:
        st["saw_heartbeat"] = True
        youngest = min(h.get("age_s", 0.0) for h in hbs.values())
        st["hb_age"] = (time.time() - mtime) + youngest
        st["current"] = next(
            (h.get("query") for h in hbs.values() if h.get("query")), None)


class StreamSupervisor:
    """Launch, watch, kill, restart once, summarize."""

    def __init__(self, specs: list[StreamSpec], out_dir: str,
                 stall_s: float | None = None, poll_s: float = 0.1,
                 grace_s: float = 5.0, max_restarts: int = 1,
                 startup_grace_s: float | None = None,
                 max_resumes: int = 3):
        self.specs = specs
        self.out_dir = out_dir
        self.stall_s = stall_s
        self.poll_s = poll_s
        self.grace_s = grace_s
        self.max_restarts = max_restarts
        # drain exits (75) relaunch without charging the restart budget,
        # but bounded: an environment that preempts at once forever must
        # not spin
        self.max_resumes = max_resumes
        # before the first heartbeat lands (interpreter, torch import,
        # warehouse load) silence is startup, not a stall
        self.startup_grace_s = (
            startup_grace_s if startup_grace_s is not None
            else max(30.0, 4.0 * (stall_s or 0.0)))

    # ------------------------------------------------------- lifecycle

    def _launch(self, st: dict, remaining: list | None) -> None:
        spec = st["spec"]
        inc = st["incarnation"]
        env = dict(spec.env if spec.env is not None else os.environ)
        env[STREAM_ENV] = (spec.name if inc == 0
                           else f"{spec.name}#r{inc}")
        if self.stall_s:
            # the heartbeat file's interval well inside the stall budget,
            # and the child's own watchdog armed to report and exit
            interval = max(0.2, min(1.0, self.stall_s / 4.0))
            env[HEARTBEAT_FILE_ENV] = f"{spec.hb_path}:{interval}"
            env[WATCHDOG_ENV] = f"{self.stall_s}:kill"
        cmd = spec.make_cmd(inc, remaining)
        if spec.log_path:
            log = open(spec.log_path, "a" if inc else "w")
            try:
                st["proc"] = subprocess.Popen(cmd, env=env, stdout=log,
                                              stderr=subprocess.STDOUT)
            finally:
                log.close()
        else:
            st["proc"] = subprocess.Popen(cmd, env=env)
        st["launched_at"] = time.time()
        st["saw_heartbeat"] = False
        st.pop("hb_age", None)

    def _stalled(self, st: dict, now: float) -> str | None:
        if not self.stall_s:
            return None
        if st["saw_heartbeat"]:
            # the parent is the backstop: the child's own watchdog gets
            # the first stall_s window to report and exit
            age = st.get("hb_age")
            if age is not None and age > 2.0 * self.stall_s:
                return f"heartbeat silent {age:.1f}s"
            return None
        if now - st["launched_at"] > self.startup_grace_s:
            return (f"no heartbeat within "
                    f"{self.startup_grace_s:.0f}s of launch")
        return None

    def _kill(self, st: dict, reason: str) -> None:
        proc = st["proc"]
        proc.terminate()
        try:
            proc.wait(timeout=self.grace_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        self._record_stall(st, reason, source="supervisor")

    def _record_stall(self, st: dict, reason: str, source: str) -> None:
        rec = {"stream": st["spec"].name,
               "incarnation": st["incarnation"],
               "query": st.get("current"),
               "age_s": round(st.get("hb_age") or 0.0, 3),
               "reason": reason, "source": source,
               "ts": time.time()}
        st["stalls"].append(rec)
        write_json_atomic(
            os.path.join(self.out_dir, f"stall-{st['spec'].name}.json"),
            rec)

    def _journal(self, st: dict) -> None:
        # only on change: a long round must not rewrite the files twice a
        # second for nothing
        state = (st["completed"], st["incarnation"], st["restarts"])
        if st.get("journaled") == state:
            return
        st["journaled"] = state
        write_json_atomic(
            os.path.join(self.out_dir, f"{st['spec'].name}_journal.json"),
            {"completed": st["completed"],
             "incarnation": st["incarnation"],
             "restarts": st["restarts"],
             "queries_total": len(st["spec"].queries) or None})

    # ------------------------------------------------------------- run

    def run(self) -> tuple[float, list, dict]:
        """Returns (elapse_s, final exit code per stream, summary). The
        summary is also written to ``<out_dir>/throughput_summary.json``."""
        os.makedirs(self.out_dir, exist_ok=True)
        start = time.time()
        states = []
        try:
            for spec in self.specs:
                st = {"spec": spec, "incarnation": 0, "exit_codes": [],
                      "signals": [], "stalls": [], "restarts": 0,
                      "resumes": 0, "completed": 0, "base_completed": 0,
                      "saw_heartbeat": False, "done": False}
                states.append(st)
                self._launch(st, None)
            self._watch(states)
        finally:
            # an exception here (a KeyboardInterrupt) must not leave
            # stream processes running
            for st in states:
                proc = st.get("proc")
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
        # the throughput elapse is max(child end) - min(start), the
        # reference's Ttt window
        elapse = max((st.get("ended_at", start) for st in states),
                     default=start) - start
        codes = [self._final_code(st) for st in states]
        summary = {
            "elapse_s": round(elapse, 3),
            "stall_s": self.stall_s,
            "streams": {
                st["spec"].name: self._stream_summary(st, code)
                for st, code in zip(states, codes)},
        }
        write_json_atomic(os.path.join(self.out_dir, SUMMARY_NAME),
                          summary)
        return elapse, codes, summary

    def _watch(self, states: list) -> None:
        while any(not st["done"] for st in states):
            time.sleep(self.poll_s)
            now = time.time()
            for st in states:
                if st["done"]:
                    continue
                fold_child_snapshot(st)
                self._journal(st)
                rc = st["proc"].poll()
                if rc is None:
                    reason = self._stalled(st, now)
                    if reason is None:
                        continue
                    self._kill(st, reason)
                    rc = st["proc"].returncode
                fold_child_snapshot(st)  # final progress before deciding
                st["ended_at"] = now
                st["exit_codes"].append(rc)
                if rc is not None and rc < 0:
                    st["signals"].append(-rc)
                if rc == EXIT_STALLED:
                    self._record_stall(st, "child watchdog exit",
                                       source="watchdog")
                if rc == 0 or self._finished_all(st):
                    st["done"] = True
                    continue
                # a drain (exit 75) is a resume, not a failure: relaunch
                # from the last completed query without charging the
                # restart budget
                resumable = (rc == EXIT_RESUMABLE
                             and st["resumes"] < self.max_resumes)
                if not resumable and st["restarts"] >= self.max_restarts:
                    st["done"] = True
                    continue
                if resumable:
                    st["resumes"] += 1
                else:
                    st["restarts"] += 1
                st["incarnation"] += 1
                if st["spec"].queries:
                    start_q = resume_index(st["spec"].queries,
                                           st["completed"])
                    remaining = st["spec"].queries[start_q:]
                else:
                    start_q, remaining = 0, None
                st["base_completed"] = start_q
                st["completed"] = start_q
                print(f"[supervise] restarting {st['spec'].name} "
                      f"(rc={rc}) from query #{start_q}")
                self._launch(st, remaining)

    def _stream_summary(self, st: dict, code: int) -> dict:
        out = {
            "exit_codes": st["exit_codes"],
            "signals": st["signals"],
            "restarts": st["restarts"],
            "resumes": st["resumes"],
            "stalls": st["stalls"],
            "completed": st["completed"],
            "queries_total": len(st["spec"].queries) or None,
            "degraded": bool(st["restarts"] or st["stalls"]
                             or st["resumes"]),
            "final_code": code,
        }
        # a degraded stream that gave up names the statements it never
        # completed
        queries = st["spec"].queries
        if queries and code != 0 and not self._finished_all(st):
            out["skipped_queries"] = [
                str(q) for q in queries[min(st["completed"],
                                            len(queries)):]]
        return out

    @staticmethod
    def _finished_all(st: dict) -> bool:
        """The incarnation's heartbeat file says every query ran: the
        stream finished (possibly with query failures, the reference's
        exit-1 contract), and a restart would run completed work
        again."""
        total = st.get("inc_total")
        return (total is not None
                and st.get("inc_completed", 0) >= total)

    @staticmethod
    def _final_code(st: dict) -> int:
        rc = st["exit_codes"][-1] if st["exit_codes"] else 1
        return 0 if rc == 0 else rc


def _signal_name(num: int) -> str:
    try:
        return signal.Signals(num).name
    except ValueError:
        return f"SIG{num}"


def describe_summary(summary: dict) -> str:
    """One human line a stream for the CLI's output."""
    lines = []
    for name, s in summary.get("streams", {}).items():
        bits = [f"rc={s['final_code']}"]
        if s["restarts"]:
            bits.append(f"restarts={s['restarts']}")
        if s.get("resumes"):
            bits.append(f"resumes={s['resumes']}")
        if s.get("skipped_queries"):
            bits.append(f"skipped={len(s['skipped_queries'])}")
        if s["stalls"]:
            bits.append(f"stalls={len(s['stalls'])}")
        if s["signals"]:
            bits.append("signals="
                        + ",".join(_signal_name(x) for x in s["signals"]))
        if s["degraded"]:
            bits.append("DEGRADED")
        lines.append(f"  {name}: {' '.join(bits)}")
    return "\n".join(lines)
