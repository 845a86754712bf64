"""Observability of the port: what the bench entry reads.

Port of a part of ``nds_tpu/obs/``. ``query_timings`` is the copy of
``nds_tpu/obs/__init__.py``'s without its span branch: the port's
executors record no query spans yet, so it reads the executor's
``last_timings`` (``DeviceExecutor.execute`` fills it: compile_ms, the
capture of the plan's graph on its first call on the card, execute_ms,
materialize_ms, bytes_scanned, slack_retries, staged_programs and the
``__kernels`` block). ``analyze`` holds ``diff_times`` alone. The rest
of the reference's ``obs/`` (traces, metrics, memory and cost ledgers,
profiles) waits for ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

__all__ = ["query_timings"]


def query_timings(executor) -> dict:
    """Timing breakdown of the executor's last query: a copy of its
    ``last_timings`` dict. Executors without timings (the CPU oracle)
    yield {}."""
    return dict(getattr(executor, "last_timings", None) or {})
