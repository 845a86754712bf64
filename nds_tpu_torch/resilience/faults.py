"""Seeded, deterministic fault injection at named sites.

Port of ``nds_tpu/resilience/faults.py``. The engine, parallel and io
layers call ``fault_point(site, **info)`` inline at their hazard points,
and a schedule (the ``NDS_TPU_FAULTS`` variable or a programmatic
``install()``) decides which calls raise, delay, hang or pass through.
Unset, a fault point is one dict lookup and a string compare.

Registered sites (the call sites live inline in the layer they test):

- ``plan``            ``Session.plan`` and a plan served from the
                      session's plan cache
- ``device.execute``  every executor's entry: ``CpuExecutor.execute``
                      and ``DeviceExecutor.execute_async`` (which
                      ``execute`` and the ``DistributedExecutor``
                      inherit). On the card it fires on the host before
                      the dispatch, for an eager first run and for a
                      graph replay alike
- ``exchange``        the distributed all-to-all shuffle
- ``io.read``         warehouse table reads (raw, parquet, orc, json,
                      avro); the call passes ``paths`` so ``corrupt``
                      can bite
- ``stream.query``    every dispatch of the execution pipeline
                      (``engine/scheduler.py``), once an attempt;
                      supervised subprocess streams add
                      ``stream=<name>`` (``<name>#rN`` on restart) to the
                      context
- ``dml.apply``       an insert's segment or a delete's bitmask
                      (``engine/dml.py``)
- ``store.commit``    a delta version written, its snapshot manifest not
                      yet updated (``columnar/delta.py``)

No site fires while the current CUDA stream captures a graph: a capture
never calls Python that sleeps or raises there.

Schedule syntax (comma-separated entries)::

    NDS_TPU_FAULTS="device.execute:oom@q5,io.read:delay=0.2@*"

    entry := site ":" kind ["=" param] ["*" times] ["~" prob] "@" scope

- ``kind``   ``oom`` (raises InjectedOOM, classified transient),
             ``fault`` (generic transient), ``deterministic`` (never
             retried), ``delay`` (sleeps ``param`` seconds), ``hang``
             (an interruptible dead stop of ``param`` seconds:
             ``interrupt_hangs()`` releases every pending hang),
             ``corrupt`` (flips one byte mid-file of the first path in
             the call's ``paths`` context; the file on disk is mutated)
- ``times``  how many matching calls fire (default 1 for raising and
             mutating kinds, unlimited for ``delay``)
- ``prob``   per-match firing probability in [0,1] (default 1), drawn
             from a counter-keyed RNG seeded by ``NDS_TPU_FAULT_SEED``,
             so a chaos run replays exactly from its seed
- ``scope``  fnmatch pattern over the call's context values (the power
             loop publishes the current query name through
             ``context()``); ``q5`` also matches ``query5``, ``*``
             matches everything

The reference's ``faults_injected_total`` metric comes with the metrics
registry (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import fnmatch
import os
import random
import re
import sys
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

FAULTS_ENV = "NDS_TPU_FAULTS"
SEED_ENV = "NDS_TPU_FAULT_SEED"

SITES = ("plan", "device.execute", "exchange", "io.read", "stream.query",
         "dml.apply", "store.commit")


class InjectedFault(RuntimeError):
    """Base class for every injected failure (always carries its site
    so reports and classifiers can tell chaos from organic errors)."""

    def __init__(self, site: str, msg: str):
        super().__init__(msg)
        self.site = site


class InjectedTransientFault(InjectedFault):
    """Injected failure the retry classifier treats as transient."""


class InjectedOOM(InjectedTransientFault):
    """Injected device-memory exhaustion; the message carries
    RESOURCE_EXHAUSTED and "out of memory", as a real one does."""


class InjectedDeterministicFault(InjectedFault):
    """Injected failure that must never be retried (the planner-bug
    analog)."""


_ENTRY_RE = re.compile(
    r"^(?P<site>[a-z_.]+):(?P<kind>[a-z]+)"
    r"(?:=(?P<param>[0-9.]+))?"
    r"(?:\*(?P<times>\d+))?"
    r"(?:~(?P<prob>[0-9.]+))?"
    r"@(?P<scope>.+)$")

_KINDS = ("oom", "fault", "deterministic", "delay", "hang", "corrupt")


@dataclass
class FaultSpec:
    """One parsed schedule entry."""
    site: str
    kind: str
    scope: str
    param: float | None = None
    times: int | None = 1       # None = unlimited
    prob: float = 1.0
    index: int = 0              # position in the schedule (RNG keying)
    fired: int = 0
    matched: int = 0


def parse_schedule(text: str) -> list[FaultSpec]:
    specs: list[FaultSpec] = []
    for i, raw in enumerate(e.strip() for e in text.split(",")):
        if not raw:
            continue
        m = _ENTRY_RE.match(raw)
        if m is None:
            raise ValueError(
                f"bad {FAULTS_ENV} entry {raw!r} (expected "
                f"site:kind[=param][*times][~prob]@scope)")
        site, kind = m.group("site"), m.group("kind")
        if site not in SITES:
            raise ValueError(
                f"unknown fault site {site!r} (known: {', '.join(SITES)})")
        if kind not in _KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r} (known: {', '.join(_KINDS)})")
        times = m.group("times")
        specs.append(FaultSpec(
            site=site, kind=kind, scope=m.group("scope"),
            param=float(m.group("param")) if m.group("param") else None,
            times=(int(times) if times is not None
                   else (None if kind == "delay" else 1)),
            prob=float(m.group("prob")) if m.group("prob") else 1.0,
            index=i))
    return specs


def _scope_matches(scope: str, ctx: dict) -> bool:
    if scope == "*":
        return True
    patterns = [scope]
    # `q5` is the documented shorthand for NDS query names (`query5`)
    m = re.match(r"^q(\d.*)$", scope)
    if m:
        patterns.append("query" + m.group(1))
    return any(fnmatch.fnmatchcase(str(v), p)
               for v in ctx.values() for p in patterns)


@dataclass
class FaultPlan:
    """A parsed schedule bound to a seed; owns firing bookkeeping."""
    specs: list = field(default_factory=list)
    seed: int = 0

    def fire(self, site: str, ctx: dict) -> None:
        for spec in self.specs:
            if spec.site != site or not _scope_matches(spec.scope, ctx):
                continue
            if spec.times is not None and spec.fired >= spec.times:
                continue
            spec.matched += 1
            if spec.prob < 1.0:
                # counter-keyed draw: the same schedule and seed over the
                # same call sequence reproduce bit for bit (bytes seeding
                # is version-stable; a tuple would go through the salted
                # str hash)
                key = f"{self.seed}:{site}:{spec.index}:{spec.matched}"
                if random.Random(key.encode()).random() >= spec.prob:
                    continue
            spec.fired += 1
            self._act(spec, site, ctx)

    @staticmethod
    def _act(spec: FaultSpec, site: str, ctx: dict) -> None:
        where = f"site={site}" + (
            f" query={ctx['query']}" if ctx.get("query") else "")
        if spec.kind == "delay":
            time.sleep(spec.param or 0.0)
            return
        if spec.kind == "hang":
            # dead stop: no heartbeat, no return, as a wedged collective
            # looks from outside. Sliced so interrupt_hangs() can release
            # it, and so a signal handler runs on the main thread
            end = time.monotonic() + (spec.param or 0.0)
            while (time.monotonic() < end
                   and not _hang_interrupt.wait(0.05)):
                pass
            return
        if spec.kind == "corrupt":
            _flip_byte(ctx)
            return
        if spec.kind == "oom":
            raise InjectedOOM(
                site, f"injected RESOURCE_EXHAUSTED: out of memory "
                      f"({where})")
        if spec.kind == "deterministic":
            raise InjectedDeterministicFault(
                site, f"injected deterministic fault ({where})")
        raise InjectedTransientFault(
            site, f"injected transient fault ({where})")


def _flip_byte(ctx: dict) -> None:
    """``corrupt`` kind: XOR one byte in the middle of the first existing
    non-empty file in the call's ``paths`` context. The mutation is real
    and persistent: the next digest verification must catch it."""
    for p in ctx.get("paths") or ():
        try:
            size = os.path.getsize(p)
        except OSError:
            continue
        if size == 0:
            continue
        pos = size // 2
        with open(p, "r+b") as f:
            f.seek(pos)
            b = f.read(1)
            f.seek(pos)
            f.write(bytes([b[0] ^ 0xFF]))
        return
    raise ValueError(
        "corrupt fault fired at a site with no 'paths' context "
        "(register it at io.read, or pass paths=[...])")


# the programmatic plan beats the env-derived one; the env plan caches on
# the (schedule, seed) strings, so a changed seed is a new plan
_installed: FaultPlan | None = None
_env_cache: tuple[tuple | None, FaultPlan | None] = (None, None)
_suppressed = 0
_ctx = threading.local()
_hang_interrupt = threading.Event()


def interrupt_hangs() -> None:
    """Release every in-flight (and future) ``hang`` fault; ``clear()``
    re-arms hangs."""
    _hang_interrupt.set()


def install(schedule: str, seed: int = 0) -> FaultPlan:
    """Activate a schedule programmatically (wins over the env var).
    Returns the plan so callers can inspect firing counts."""
    global _installed
    _installed = FaultPlan(parse_schedule(schedule), seed)
    return _installed


def clear() -> None:
    """Drop the programmatic plan and the env cache (tests); re-arms the
    hang kind after an ``interrupt_hangs()``."""
    global _installed, _env_cache
    _installed = None
    _env_cache = (None, None)
    _hang_interrupt.clear()


def _current_plan() -> FaultPlan | None:
    if _installed is not None:
        return _installed
    global _env_cache
    text = os.environ.get(FAULTS_ENV)
    if not text:
        return None
    key = (text, os.environ.get(SEED_ENV, "0"))
    if key != _env_cache[0]:
        _env_cache = (key, FaultPlan(parse_schedule(text), int(key[1])))
    return _env_cache[1]


@contextmanager
def context(**kv):
    """Publish call-site context (e.g. the current query name) to every
    fault_point fired inside the block; thread-local, nestable."""
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


@contextmanager
def suppress():
    """Disable firing inside the block (warmup passes must not consume a
    timed query's fault budget)."""
    global _suppressed
    _suppressed += 1
    try:
        yield
    finally:
        _suppressed -= 1


def _capturing() -> bool:
    """True while the current CUDA stream captures a graph (torch is
    asked only if something already imported it)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return False
    return torch.cuda.is_current_stream_capturing()


def fault_point(site: str, **info) -> None:
    """Inline injection site: no-op unless an active schedule matches,
    and never inside a CUDA graph capture.

    ``info`` extends the thread-local context for scope matching (e.g.
    ``fault_point("io.read", table=name)``)."""
    plan = _current_plan()
    if plan is None or _suppressed or _capturing():
        return
    plan.fire(site, {**getattr(_ctx, "d", {}), **info})
