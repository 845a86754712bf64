"""Graceful preemption drain: SIGTERM/SIGINT as a scheduling event.

Port of ``nds_tpu/resilience/drain.py``. A preempted run that dies
mid-flight throws away what the query-granular journal
(``resilience/journal.py``) exists to keep; this module turns the kill
signal into a drain:

- **First SIGTERM/SIGINT**: a chaining handler (it keeps the previous
  handler and restores it on uninstall) marks the drain requested and
  arms a deadline thread. The in-flight query keeps running: the power
  loop checks :func:`check_boundary` between statements and exits with
  :data:`EXIT_RESUMABLE` (75, BSD EX_TEMPFAIL) once the query finished,
  its result, summary and journal record written by the normal path.
- **Past the deadline** (``engine.drain_s`` / ``NDS_TPU_DRAIN_S``,
  default 30 s): the in-flight query is abandoned. The registered flush
  hooks run (the power loop journals the query as explicitly not done
  through ``QueryJournal.mark_aborted``) and the process exits 75 at
  once (``os._exit``). The journal already holds every completed query.
- **Repeat signal**: flush hooks run at once and the process exits 75.

Python runs the handler on the main thread, between bytecodes. On the
card a signal that arrives while the host waits on a replay's copies or
on a ``synchronize`` is handled when the wait returns; the deadline
thread does not wait for that.

Exit 75 is the resumable contract: ``StreamSupervisor``
(``resilience/supervise.py``) relaunches a 75-exit stream without
charging its restart budget, and ``nds/bench.py`` runs a 75-exit power
or maintenance phase again with ``--resume``. The reference's flight
dump and trace flush on the signal come with observability (ROADMAP
Queue 1 item 7).
"""

from __future__ import annotations

import os
import signal
import sys
import threading

# BSD EX_TEMPFAIL: "try again later", distinct from query failures (1),
# watchdog stalls (86) and signal deaths (<0)
EXIT_RESUMABLE = 75

DRAIN_ENV = "NDS_TPU_DRAIN_S"
DEFAULT_DRAIN_S = 30.0


class DrainRequested(SystemExit):
    """Raised at a query boundary once a drain was requested: unwinds
    through every ``finally`` and exits the process
    :data:`EXIT_RESUMABLE`."""

    def __init__(self):
        super().__init__(EXIT_RESUMABLE)


class DrainManager:
    """One drain lifecycle: install, observe, enforce the deadline."""

    def __init__(self, drain_s: float = DEFAULT_DRAIN_S,
                 run_dir: str = ".", _exit=os._exit):
        self.drain_s = max(0.1, float(drain_s))
        self.run_dir = run_dir
        self._exit = _exit
        self._requested = threading.Event()
        # set when the loop reached a boundary (or finished): the
        # deadline thread stands down instead of force-exiting
        self._finished = threading.Event()
        self._flush_hooks: list = []
        self._prev: dict = {}
        self._installed = False
        self._signum: int | None = None
        self._timer: threading.Thread | None = None

    # ------------------------------------------------------- lifecycle

    def install(self) -> "DrainManager":
        """Install the chaining handler for SIGTERM and SIGINT (main
        thread only; elsewhere the manager stays inert)."""
        if self._installed:
            return self
        if threading.current_thread() is not threading.main_thread():
            return self
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                self._prev[sig] = signal.getsignal(sig)
                signal.signal(sig, self._on_signal)
            self._installed = True
        except (ValueError, OSError):
            self._prev.clear()
        return self

    def uninstall(self) -> None:
        """Restore the previous handlers (only where ours is still the
        installed one) and stand the deadline thread down."""
        self._finished.set()
        if not self._installed:
            return
        for sig, prev in self._prev.items():
            try:
                if signal.getsignal(sig) == self._on_signal:
                    signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._installed = False

    def add_flush_hook(self, fn) -> None:
        """Register ``fn()`` to run (best-effort, in order) on the
        force-exit path: the state a normal teardown would have flushed
        but ``os._exit`` skips."""
        if fn not in self._flush_hooks:
            self._flush_hooks.append(fn)

    # --------------------------------------------------------- signals

    def _on_signal(self, signum, frame) -> None:
        if self._finished.is_set():
            # the drain is over: behave like the handler we replaced
            self._chain(signum, frame)
            return
        first = not self._requested.is_set()
        self._signum = signum
        self._requested.set()
        if not first:
            self._force_exit("drain-repeat-signal")
            return
        name = getattr(signal.Signals(signum), "name", str(signum))
        print(f"[drain] {name} received — letting the in-flight query "
              f"finish (deadline {self.drain_s:.0f}s), will exit "
              f"{EXIT_RESUMABLE} (resumable)", flush=True)
        t = threading.Thread(target=self._deadline_watch,
                             name="nds-drain-deadline", daemon=True)
        self._timer = t
        t.start()

    def _chain(self, signum, frame) -> None:
        prev = self._prev.get(signum)
        if callable(prev):
            prev(signum, frame)
        elif prev == signal.SIG_DFL:
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)

    def _deadline_watch(self) -> None:
        if self._finished.wait(self.drain_s):
            return  # boundary reached in time: normal teardown flushes
        self._force_exit("drain-deadline")

    def _force_exit(self, reason: str) -> None:
        """Abandon the in-flight query: run the flush hooks (the
        journal's abort stamp first), then exit 75. ``os._exit`` skips
        every ``finally``: what must survive is flushed here."""
        self._finished.set()
        for fn in list(self._flush_hooks):
            try:
                fn()
            except Exception as exc:  # noqa: BLE001 - dying anyway
                print(f"[drain] flush hook failed: "
                      f"{type(exc).__name__}: {exc}")
        print(f"[drain] {reason}: abandoning the in-flight query, "
              f"exiting {EXIT_RESUMABLE} (resumable)")
        sys.stdout.flush()
        sys.stderr.flush()
        self._exit(EXIT_RESUMABLE)

    # -------------------------------------------------------- boundary

    def requested(self) -> bool:
        return self._requested.is_set()

    def check_boundary(self) -> None:
        """Query-boundary checkpoint: once a drain was requested, stand
        the deadline thread down and unwind resumably."""
        if self._requested.is_set():
            self._finished.set()
            raise DrainRequested()


_MANAGER: "DrainManager | None" = None


def drain_seconds(config=None) -> float:
    """``engine.drain_s`` > ``NDS_TPU_DRAIN_S`` > 30 s default."""
    v = config.get("engine.drain_s") if config is not None else None
    if v is None:
        v = os.environ.get(DRAIN_ENV)
    try:
        return float(v) if v is not None else DEFAULT_DRAIN_S
    except (TypeError, ValueError):
        return DEFAULT_DRAIN_S


def install(drain_s: float = DEFAULT_DRAIN_S, run_dir: str = ".",
            _exit=os._exit) -> DrainManager:
    """Install the process-wide drain manager for this run (replacing
    and uninstalling any previous run's)."""
    global _MANAGER
    if _MANAGER is not None:
        _MANAGER.uninstall()
    _MANAGER = DrainManager(drain_s, run_dir, _exit=_exit).install()
    return _MANAGER


def uninstall() -> None:
    global _MANAGER
    if _MANAGER is not None:
        _MANAGER.uninstall()
        _MANAGER = None


def manager() -> "DrainManager | None":
    return _MANAGER


def requested() -> bool:
    return _MANAGER is not None and _MANAGER.requested()


def check_boundary() -> None:
    if _MANAGER is not None:
        _MANAGER.check_boundary()
