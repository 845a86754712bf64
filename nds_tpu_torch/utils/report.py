"""Per-query JSON summary reports.

Port of ``redact_env``, ``TaskFailureCollector`` and ``BenchReport`` of
``nds_tpu/utils/report.py``, format-compatible with the reference's
summary dict (env / queryStatus / exceptions / startTime / queryTimes /
query, written as ``{prefix}-{query}-{startTime}.json``):

- ``env`` records ``engineVersion`` ``torch-<version>``, and in
  ``engineConf`` the ``backend`` and ``device`` the run was configured
  with; on ``cuda`` also ``cuda`` (``torch.version.cuda``),
  ``device_name`` and ``device_count``, read only where CUDA is already
  initialized (the reporter never starts a backend, as in the
  reference);
- a query that completed after the engine recovered from a task-level
  failure (the executor's doubled-slack retry) is
  ``CompletedWithTaskFailures``, its reasons in ``exceptions``.

Kept attachments: ``attach_kernels`` (the ``kernels`` block),
``attach_result_digest``, since item 4 (the scheduler) ``attach_retry``
and ``attach_schedule``, and since item 15 (the resilience layer)
``attach_incarnation`` and ``attach_degradations``, with
``merge_incarnations`` (the merged phase report of a resumed run) and
``load_summaries``. Trimmed, each with the ROADMAP
Queue 1 item that brings it back: ``attach_cache`` (no counterpart: a CUDA graph does not
outlive its process); ``attach_profile``, ``attach_flight``,
``attach_memory``, ``attach_cost``, ``attach_telemetry`` and the
``task_failures_total`` counter in ``notify`` (item 7, observability);
``attach_tenant`` and ``attach_replica`` (item 9, serving); the split
bracket ``begin_async``/``end_async`` with ``focus_failures`` (item 6's
boundary overlap).
"""

from __future__ import annotations

import json
import os
import threading
import time
import traceback
from typing import Callable

import torch

_REDACTED_MARKERS = ("TOKEN", "SECRET", "PASSWORD", "KEY", "CREDENTIAL")


def redact_env(env: dict) -> dict:
    """Drop env vars whose *name* suggests a secret (substring match on
    TOKEN, SECRET, PASSWORD, KEY, CREDENTIAL)."""
    return {
        k: v for k, v in env.items()
        if not any(m in k.upper() for m in _REDACTED_MARKERS)
    }


class TaskFailureCollector:
    """In-process listener for recoverable task-level failures.

    Engine internals notify non-fatal anomalies (a join's overflow that
    the executor recovered from by running again at a doubled slack). A
    query that completes with collected failures is reported
    ``CompletedWithTaskFailures``.
    """

    _active: list["TaskFailureCollector"] = []
    # the class-level listener list and each listener's failure store
    # must not race between threads
    _lock = threading.Lock()

    def __init__(self) -> None:
        # ordered UNIQUE reasons; repeats count in _counts so a noisy
        # anomaly is one summary line with a multiplier
        self.failures: list[str] = []
        self._counts: dict[str, int] = {}

    def register(self) -> None:
        with TaskFailureCollector._lock:
            TaskFailureCollector._active.append(self)

    def unregister(self) -> None:
        with TaskFailureCollector._lock:
            if self in TaskFailureCollector._active:
                TaskFailureCollector._active.remove(self)

    def formatted(self) -> list[str]:
        """Unique reasons in first-seen order, deduplicated repeats
        annotated with their count."""
        with TaskFailureCollector._lock:
            return [r if self._counts[r] == 1 else
                    f"{r} (x{self._counts[r]})" for r in self.failures]

    @classmethod
    def notify(cls, reason: str) -> None:
        """Called by engine internals on recoverable task-level
        failures."""
        with cls._lock:
            for listener in cls._active:
                if reason in listener._counts:
                    listener._counts[reason] += 1
                else:
                    listener._counts[reason] = 1
                    listener.failures.append(reason)


class BenchReport:
    """Build and persist one per-query JSON summary."""

    def __init__(self, query_name: str, engine_info: dict | None = None) -> None:
        self.summary = {
            "env": {
                "envVars": {},
                "engineConf": {},
                "engineVersion": None,
            },
            "queryStatus": [],
            "exceptions": [],
            "startTime": None,
            "queryTimes": [],
            "query": query_name,
        }
        self._engine_info = engine_info or {}

    def capture_env(self) -> None:
        self.summary["env"]["envVars"] = redact_env(dict(os.environ))
        conf = dict(self._engine_info)
        self.summary["env"]["engineVersion"] = f"torch-{torch.__version__}"
        conf.setdefault("backend", conf.get("engine.backend", "gpu"))
        device = conf.get("engine.device", "cuda")
        if conf["backend"] == "cpu":
            device = "cpu"
        conf.setdefault("device", device)
        # never initialize CUDA from the reporter: only a context that is
        # already live is asked about the card
        if device.startswith("cuda") and torch.cuda.is_initialized():
            conf.setdefault("cuda", torch.version.cuda)
            conf.setdefault("device_name", torch.cuda.get_device_name())
            conf.setdefault("device_count", torch.cuda.device_count())
        self.summary["env"]["engineConf"] = {str(k): str(v) for k, v in conf.items()}

    def report_on(self, fn: Callable, *args):
        """Run fn(*args), recording status/exception/elapsed-ms.

        Statuses: Completed | CompletedWithTaskFailures | Failed. The
        bracket ends when ``fn`` returns, with its result on the host.
        """
        self.capture_env()
        collector = TaskFailureCollector()
        collector.register()
        start_time = int(time.time() * 1000)
        try:
            fn(*args)
            end_time = int(time.time() * 1000)
            if collector.failures:
                self.summary["queryStatus"].append("CompletedWithTaskFailures")
                self.summary["exceptions"].extend(collector.formatted())
            else:
                self.summary["queryStatus"].append("Completed")
        except Exception as e:
            print("ERROR BEGIN")
            traceback.print_exc()
            print("ERROR END")
            end_time = int(time.time() * 1000)
            self.summary["queryStatus"].append("Failed")
            self.summary["exceptions"].append(str(e))
        finally:
            collector.unregister()
        self.summary["startTime"] = start_time
        self.summary["queryTimes"].append(end_time - start_time)
        return self.summary

    def attach_kernels(self, timings: dict | None) -> None:
        """Record which relational kernels the query's plan used (the
        executor's ``__kernels`` counts in its ``last_timings``) as the
        ``kernels`` block: ``{"join.direct": 2, "semi.bitmask": 4, ...}``.
        Absent for queries with no kernel-lowered operators (pure scans,
        the CPU oracle)."""
        kern = (timings or {}).get("__kernels")
        if kern:
            self.summary["kernels"] = {str(k): int(v)
                                       for k, v in sorted(kern.items())}

    def attach_result_digest(self, digest: str | None) -> None:
        """Record the query result's content fingerprint
        (``io/result_io.result_digest``)."""
        if digest:
            self.summary["result_digest"] = str(digest)

    def attach_incarnation(self, incarnation: int | None) -> None:
        """Record which resume incarnation produced this summary
        (``resilience/journal.QueryJournal``): 0 the original process, a
        resumed one 1, 2, ...; ``merge_incarnations`` keys on it."""
        if incarnation is not None:
            self.summary["incarnation"] = int(incarnation)

    def attach_degradations(self) -> None:
        """Surface torn-state degradations: nonzero journal or snapshot
        resets mean prior on-disk state was thrown away in this process,
        and every summary it could have affected says so."""
        from nds_tpu_torch.io import snapshots
        from nds_tpu_torch.resilience import journal
        block = {}
        for key, n in (("journal_resets", journal.resets_total),
                       ("snapshot_resets", snapshots.resets_total)):
            if n:
                block[key] = int(n)
        if block:
            self.summary["degradations"] = block

    def attach_retry(self, stats) -> None:
        """Record a ``resilience.retry.RetryStats``: ``retries`` always
        (0 says the query needed no recovery), ``retry_backoff_s`` when
        it retried, ``gave_up_reason`` and ``deadline_exceeded`` only
        when set."""
        self.summary["retries"] = stats.retries
        if stats.retries:
            self.summary["retry_backoff_s"] = round(stats.backoff_s, 3)
        if stats.gave_up_reason:
            self.summary["gave_up_reason"] = stats.gave_up_reason
        if stats.deadline_exceeded:
            self.summary["deadline_exceeded"] = True

    def attach_schedule(self, sched: dict | None) -> None:
        """Record the pipeline's scheduling decision
        (``engine/scheduler.py``): ``placement`` (the placement that
        served the query) and ``reschedules`` whenever the pipeline ran
        the query; ``ladder`` (the rungs walked) only when it was
        rescheduled; ``promoted_back`` only on the query where a stream's
        promotion took effect. (The reference's ``governed``, set where
        its memory governor placed the query, comes back with that
        governor, ROADMAP Queue 1 item 6.)"""
        if not sched or "placement" not in sched:
            return
        self.summary["placement"] = sched["placement"]
        self.summary["reschedules"] = int(sched.get("reschedules", 0))
        if sched.get("reschedules"):
            self.summary["ladder"] = list(sched.get("ladder", []))
        if sched.get("promoted_back"):
            self.summary["promoted_back"] = True

    def write_summary(self, prefix: str = "",
                      out_dir: str | None = None) -> str:
        """Write '{prefix}-{query}-{startTime}.json' into ``out_dir``
        when given (the recorded ``filename`` stays bare either way),
        and return the written path."""
        filename = f"{prefix}-{self.summary['query']}-{self.summary['startTime']}.json"
        self.summary["filename"] = filename
        path = (os.path.join(out_dir, filename) if out_dir
                else filename)
        with open(path, "w") as f:
            json.dump(self.summary, f, indent=2)
        return path

    def is_success(self) -> bool:
        return self.summary["queryStatus"] == ["Completed"]


def is_report_basename(name: str) -> bool:
    """Whether a run-dir file name can be a BenchReport summary:
    ``merged-*`` phase reports derive from the per-query summaries, and
    ``*_queries.json`` files and ``bench_state.json`` are journals."""
    return (name.endswith(".json")
            and name not in ("analysis.json", "bench_state.json")
            and not name.startswith("merged-")
            and not name.endswith("_queries.json"))


def load_summaries(run_dir: str) -> list:
    """Every BenchReport JSON under ``run_dir`` (recursive), in
    startTime order; other JSONs are skipped."""
    out = []
    for root, _dirs, files in os.walk(run_dir):
        for fname in sorted(files):
            if not is_report_basename(fname):
                continue
            try:
                with open(os.path.join(root, fname)) as f:
                    obj = json.load(f)
            except (OSError, ValueError):
                continue
            if (isinstance(obj, dict) and "queryStatus" in obj
                    and "query" in obj):
                out.append(obj)
    out.sort(key=lambda s: (s.get("startTime") or 0))
    return out


def merge_incarnations(summaries: list, phase: str = "") -> dict:
    """Merge the per-query BenchReports of every incarnation of a resumed
    phase into one phase report: one entry a statement, where a
    statement reported by more than one incarnation (the window between
    its summary and its journal record) is billed once, by its latest
    (incarnation, startTime) report. The merged wall clock is the sum of
    per-query walls, the one phase total that does not depend on where
    the interruptions fell."""
    best: dict = {}
    for s in summaries:
        if not isinstance(s, dict) or "query" not in s \
                or "queryStatus" not in s:
            continue
        q = str(s["query"])
        key = (int(s.get("incarnation") or 0), s.get("startTime") or 0)
        if q not in best or key > best[q][0]:
            best[q] = (key, s)
    ordered = sorted(best.values(), key=lambda kv: kv[1].get(
        "startTime") or 0)
    merged: dict = {
        "phase": phase,
        "merged": True,
        "incarnations": max((k[0] for k, _s in ordered),
                            default=0) + 1,
        "queries": [s["query"] for _k, s in ordered],
        "queryStatus": [s["queryStatus"][-1] if s.get("queryStatus")
                        else "Failed" for _k, s in ordered],
        "queryTimes": [(s.get("queryTimes") or [0])[-1]
                       for _k, s in ordered],
        "startTime": min((s.get("startTime") or 0
                          for _k, s in ordered), default=0),
    }
    merged["wall_ms_total"] = sum(merged["queryTimes"])
    digests = {s["query"]: s["result_digest"] for _k, s in ordered
               if s.get("result_digest")}
    if digests:
        merged["result_digests"] = digests
    return merged
