"""Failure classification and the retry policy with backoff and deadlines.

Port of ``nds_tpu/resilience/retry.py``. A device's out-of-memory and
exchange-capacity errors are TRANSIENT (a retry at another placement, a
smaller working set or a doubled slack usually succeeds), while parse,
plan and verify errors are DETERMINISTIC and retrying them only repeats
the stack trace:

- ``classify(exc)`` -> TRANSIENT | DETERMINISTIC. Transient: injected
  transient faults (``resilience.faults``), messages with
  RESOURCE_EXHAUSTED or "out of memory" (torch's
  ``torch.cuda.OutOfMemoryError`` says "CUDA out of memory"), and
  exchange overflow. Everything else is deterministic and never retried.
- ``is_oom(exc)``: device-memory exhaustion by the same fragment.
- ``RetryPolicy``: an attempt cap, exponential backoff with seeded
  jitter, and a per-query wall-clock deadline. The execution pipeline
  (``engine/scheduler.py``) owns it.

Config keys: ``engine.retry.max_attempts``, ``engine.retry.base_delay_s``,
``engine.retry.max_delay_s``, ``engine.retry.jitter``,
``engine.retry.seed``, ``engine.query_deadline_s``. The reference's
metrics counters (``query_retries_total``,
``query_deadline_exceeded_total``) wait for ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

import random
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable

from nds_tpu_torch.resilience import faults as faults_mod

TRANSIENT = "transient"
DETERMINISTIC = "deterministic"


class QueryDeadlineExceeded(RuntimeError):
    """Raised by ``check_deadline()`` when the active deadline scope has
    expired MID-attempt — long-running loop bodies (the chunked
    executor's per-chunk loops, ROADMAP Queue 1 item 6) call it between
    iterations so a deadlined query stops at the next chunk boundary
    instead of finishing a doomed attempt. Deterministic: the wall clock cannot be
    retried back."""


# active per-call deadline, published by RetryPolicy.call so code deep
# inside an attempt can honor it; thread-local because concurrent
# in-process streams carry independent deadlines
_deadline = threading.local()


@contextmanager
def deadline_scope(deadline_s: float | None,
                   clock: Callable[[], float] = time.monotonic,
                   start: float | None = None):
    """Publish an absolute deadline for the block (no-op when
    ``deadline_s`` is None); nests — the innermost scope wins."""
    if deadline_s is None:
        yield
        return
    prev = getattr(_deadline, "v", None)
    _deadline.v = ((start if start is not None else clock())
                   + deadline_s, clock)
    try:
        yield
    finally:
        _deadline.v = prev


def check_deadline() -> None:
    """Raise QueryDeadlineExceeded when the active scope's deadline has
    passed; no-op outside any scope. Cheap enough for per-chunk
    granularity (one thread-local read + one clock read)."""
    v = getattr(_deadline, "v", None)
    if v is not None and v[1]() > v[0]:
        raise QueryDeadlineExceeded(
            "query deadline exceeded mid-attempt "
            "(engine.query_deadline_s)")

# message fragments that mark a transient accelerator/runtime failure
# (the reference's jaxlib says RESOURCE_EXHAUSTED; torch's
# torch.cuda.OutOfMemoryError says "CUDA out of memory"; the exchange
# retry loop raises on persisted overflow)
_TRANSIENT_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "out of memory",
    "Out of memory",
    "exchange overflow",
)


def is_oom(exc: BaseException) -> bool:
    """Device-memory exhaustion specifically: the scheduler steps a
    query down its ladder on these instead of retrying in place."""
    if isinstance(exc, faults_mod.InjectedOOM):
        return True
    msg = str(exc)
    return "RESOURCE_EXHAUSTED" in msg or "ut of memory" in msg


def classify(exc: BaseException) -> str:
    """TRANSIENT (worth retrying) or DETERMINISTIC (never retry).

    Unknown exception types default to DETERMINISTIC: retrying a
    planner bug burns the attempt budget to reach the same stack
    trace, while a mis-classified transient costs one lost retry —
    the conservative direction."""
    if isinstance(exc, faults_mod.InjectedDeterministicFault):
        return DETERMINISTIC
    if isinstance(exc, faults_mod.InjectedTransientFault):
        return TRANSIENT
    if isinstance(exc, QueryDeadlineExceeded):
        return DETERMINISTIC
    from nds_tpu_torch.io.integrity import CorruptArtifact
    if isinstance(exc, CorruptArtifact):
        # re-reading corrupt bytes yields the same corrupt bytes:
        # explicitly deterministic even if a message ever carried a
        # transient marker
        return DETERMINISTIC
    msg = str(exc)
    if any(m in msg for m in _TRANSIENT_MARKERS):
        return TRANSIENT
    return DETERMINISTIC


@dataclass
class RetryStats:
    """Per-call accounting the BenchReport summary picks up
    (``retries`` / ``gave_up_reason`` / ``deadline_exceeded``)."""
    attempts: int = 0
    retries: int = 0
    gave_up_reason: str | None = None
    deadline_exceeded: bool = False
    backoff_s: float = 0.0
    errors: list = field(default_factory=list)


class RetryPolicy:
    """Exponential backoff with seeded jitter, attempt cap, and an
    optional per-call wall-clock deadline.

    Delay for retry *i* (0-based) is
    ``min(base_delay_s * 2**i, max_delay_s)`` plus a deterministic
    jitter fraction drawn from ``seed`` — two runs with the same seed
    back off identically (chaos runs must replay exactly)."""

    def __init__(self, max_attempts: int = 3,
                 base_delay_s: float = 0.05,
                 max_delay_s: float = 2.0,
                 jitter: float = 0.25,
                 deadline_s: float | None = None,
                 seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = max_attempts
        self.base_delay_s = base_delay_s
        self.max_delay_s = max_delay_s
        self.jitter = jitter
        self.deadline_s = deadline_s
        self.seed = seed
        self._sleep = sleep
        self._clock = clock

    @classmethod
    def from_config(cls, config, **kw) -> "RetryPolicy":
        """Build from an EngineConfig (``engine.retry.*`` +
        ``engine.query_deadline_s``)."""
        def _f(key, default):
            v = config.get(key)
            return default if v is None else float(v)
        deadline = _f("engine.query_deadline_s", 0.0)
        return cls(
            max_attempts=config.get_int("engine.retry.max_attempts", 3),
            base_delay_s=_f("engine.retry.base_delay_s", 0.05),
            max_delay_s=_f("engine.retry.max_delay_s", 2.0),
            jitter=_f("engine.retry.jitter", 0.25),
            deadline_s=deadline if deadline > 0 else None,
            seed=config.get_int("engine.retry.seed", 0), **kw)

    def with_attempts(self, max_attempts: int) -> "RetryPolicy":
        """Derived policy with a different attempt budget and every
        other field (sleep/clock injection included) preserved — for
        callers that already spent attempts outside the policy (the
        throughput stream rerun)."""
        return RetryPolicy(
            max_attempts=max_attempts,
            base_delay_s=self.base_delay_s,
            max_delay_s=self.max_delay_s, jitter=self.jitter,
            deadline_s=self.deadline_s, seed=self.seed,
            sleep=self._sleep, clock=self._clock)

    def delay_for(self, retry_index: int) -> float:
        base = min(self.base_delay_s * (2 ** retry_index),
                   self.max_delay_s)
        if base <= 0 or self.jitter <= 0:
            return max(base, 0.0)
        key = f"{self.seed}:{retry_index}"
        return base * (1.0 + self.jitter
                       * random.Random(key.encode()).random())

    def attempts(self):
        """Attempt-index iterator for executor-internal retry loops
        (the exchange slack-doubling / chunk-shrinking shape): yields
        0..max_attempts-1, sleeping the backoff BETWEEN attempts. The
        loop body decides what changes per attempt and raises when the
        budget is spent."""
        for i in range(self.max_attempts):
            if i:
                d = self.delay_for(i - 1)
                if d > 0:
                    self._sleep(d)
            yield i

    def call(self, fn: Callable, *args,
             stats: RetryStats | None = None,
             classify_fn: Callable[[BaseException], str] = classify,
             on_retry: Callable[[BaseException, int], None] | None = None):
        """Run ``fn(*args)`` under the policy; returns its result.

        Transient failures retry with backoff until the attempt cap or
        the deadline; deterministic failures re-raise immediately. The
        final exception always propagates — callers that must swallow
        it (the power loop's report bracket) already do. ``stats``
        (optional, caller-owned) receives the accounting either way;
        a success that still overran the deadline is returned but
        flagged ``deadline_exceeded``, since its wall
        clock already damaged the run it was deadlined for.

        The deadline is also enforced INSIDE an attempt: the call runs
        under ``deadline_scope``, so loop bodies that poll
        ``check_deadline()`` (the chunked executor, between chunks)
        abort mid-attempt with QueryDeadlineExceeded; and a FINAL
        attempt that fails after overrunning the deadline still records
        ``deadline_exceeded`` alongside its ``gave_up_reason`` — the
        overrun happened whether or not the attempt also raised."""
        stats = stats if stats is not None else RetryStats()
        start = self._clock()

        def _overrun() -> bool:
            return (self.deadline_s is not None
                    and self._clock() - start > self.deadline_s)

        def _flag_deadline() -> None:
            stats.deadline_exceeded = True

        with deadline_scope(self.deadline_s, self._clock, start=start):
            while True:
                stats.attempts += 1
                try:
                    result = fn(*args)
                except QueryDeadlineExceeded as exc:
                    # an in-attempt deadline abort IS the deadline
                    # giving up, not a deterministic engine bug
                    stats.errors.append(
                        f"{type(exc).__name__}: {exc}")
                    stats.gave_up_reason = "deadline"
                    _flag_deadline()
                    raise
                except Exception as exc:  # noqa: BLE001 - classified below
                    stats.errors.append(f"{type(exc).__name__}: {exc}")
                    if classify_fn(exc) != TRANSIENT:
                        stats.gave_up_reason = DETERMINISTIC
                        if _overrun():
                            _flag_deadline()
                        raise
                    if stats.attempts >= self.max_attempts:
                        stats.gave_up_reason = (
                            f"attempts_exhausted({stats.attempts})")
                        if _overrun():
                            _flag_deadline()
                        raise
                    d = self.delay_for(stats.retries)
                    if (self.deadline_s is not None
                            and self._clock() - start + d
                            > self.deadline_s):
                        stats.gave_up_reason = "deadline"
                        _flag_deadline()
                        raise
                    stats.retries += 1
                    stats.backoff_s += d
                    if on_retry is not None:
                        on_retry(exc, stats.retries)
                    if d > 0:
                        self._sleep(d)
                    continue
                if _overrun():
                    _flag_deadline()
                return result
