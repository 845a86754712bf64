"""Injected-fault classes and the query context.

Port of the part of ``nds_tpu/resilience/faults.py`` that the retry
classifier (``retry.classify``) and the scheduler read: the three
injected-fault exception classes, which classify as the reference's do,
and the thread-local context (``context``, ``current_context``) by which
the loops publish the current query and stream names, and the scheduler
keys its records on the query name. The fault points themselves
(``fault_point``, the ``NDS_TPU_FAULTS`` schedule, ``suppress``, the
hang and corrupt kinds) and the watchdog wait for ROADMAP Queue 1 item
15: no site of the port fires a fault yet, so a test raises these
classes by hand.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

_ctx = threading.local()


class InjectedFault(RuntimeError):
    """Base class for every injected failure (always carries its site
    so reports and classifiers can tell chaos from organic errors)."""

    def __init__(self, site: str, msg: str):
        super().__init__(msg)
        self.site = site


class InjectedTransientFault(InjectedFault):
    """Injected failure the retry classifier treats as transient."""


class InjectedOOM(InjectedTransientFault):
    """Injected device-memory exhaustion; the message should carry
    RESOURCE_EXHAUSTED or "out of memory", as a real one does."""


class InjectedDeterministicFault(InjectedFault):
    """Injected failure that must never be retried (the planner-bug
    analog)."""


@contextmanager
def context(**kv):
    """Publish call-site context (e.g. the current query name) for the
    block; thread-local, nestable."""
    prev = getattr(_ctx, "d", {})
    _ctx.d = {**prev, **kv}
    try:
        yield
    finally:
        _ctx.d = prev


def current_context() -> dict:
    """Read-only copy of the active thread-local context (the query and
    stream names the loops publish through ``context()``)."""
    return dict(getattr(_ctx, "d", {}))
