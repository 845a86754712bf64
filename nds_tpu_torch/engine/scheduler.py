"""The execution pipeline: placement as a scheduling decision.

Port of ``nds_tpu/engine/scheduler.py`` (ROADMAP Queue 1 item 4), copied,
not subclassed. One pipeline is the Session's executor factory for every
backend and treats the port's executors as *placements*: the device
engine (``engine/device_exec.py``), the sharded engine
(``parallel/dist_exec.py``) and the CPU oracle (``engine/cpu_exec.py``).

- **Initial placement**: the pin (``engine.placement.force``), else the
  stream's sticky demotion, else the fastest placement of the backend's
  universe.
- **Degradation ladder**: a transient failure reschedules that one query
  a rung down instead of demoting the stream: device out of memory ->
  cpu; sharded exchange overflow -> a re-plan at a doubled slack -> cpu.
  Deterministic failures (planner bugs) never walk it. Other transient
  failures retry at the same rung under the retry policy
  (``engine.retry.*``, ``engine.query_deadline_s``) before stepping.
- **Promotion**: repeated walks demote the stream's starting rung;
  ``engine.placement.promote_after`` clean queries there promote it
  back.
- **Consensus**: on a world of several ranks every switch of placement
  is voted (``parallel/multihost.gather_votes``), the deepest demotion
  proposed wins, and every rank switches or none does. A one-rank world
  votes through the one-voter ``NullChannel``, so the code is the same.

The universes (``UNIVERSES``): ``gpu`` is (device, cpu), ``distributed``
is (sharded, cpu), ``cpu`` is (cpu,). The reference's chunked rung
(``engine/chunked_exec.py``) waits for item 6, and with it what only
moves a query to that rung: the cost model's per-query choice (the
plan's size estimate and the per-query device high-water marks against
``engine.placement.device_budget_bytes``, the widest table against
``engine.stream_bytes``), the memory governor (``engine.placement.
governor``) and the per-query chunk tweaks (``chunk_rows`` halving, the
stream threshold, the prefetch depth). In a universe without the chunked
rung the reference's cost model returns the fast placement, as the
pipeline here does; ``CostModel`` stays beside it, the reference's
chooser, which nothing in the pipeline calls until item 6. Also left
for later, each with its item: the watchdog's beat and the
``stream.query`` fault point of each dispatch (item 15), and the
``obs_metrics`` counters (``query_reschedules_total``,
``placement_consensus_total``, ``placement_demotions_total``,
``placement_promotions_total``; item 7).

Config keys: ``engine.placement.force`` pins the initial placement;
``engine.placement.ladder`` (default on) and ``engine.placement.floor``
(default cpu); ``engine.placement.demote_after`` and
``engine.placement.promote_after`` shape the sticky demotion;
``engine.fallback=cpu`` forces the floor to cpu.
"""

from __future__ import annotations

import torch

from nds_tpu_torch.resilience import faults
from nds_tpu_torch.resilience.retry import (
    DETERMINISTIC, QueryDeadlineExceeded, RetryPolicy, RetryStats,
    classify, deadline_scope, is_oom,
)

# placement names, fastest first per backend universe
DEVICE = "device"
SHARDED = "sharded"
CHUNKED = "chunked"
CPU = "cpu"

# sharded pseudo-rung: same placement, slack doubled, plans run again
SHARDED_REPLAN = "sharded+slack"

UNIVERSES = {
    # the reference's (device, chunked, cpu) and (sharded, chunked, cpu)
    # less the chunked rung, which waits for ROADMAP Queue 1 item 6
    "gpu": (DEVICE, CPU),
    "distributed": (SHARDED, CPU),
    "cpu": (CPU,),
}

# the cost model's default budget (the reference's: half of a 16 GiB chip)
DEFAULT_DEVICE_BUDGET = 8 << 30
# estimated bytes inflate by this factor before comparing to the budget
# (intermediates, padding, exchange buffers)
EXPANSION = 2.0

# consecutive ladder-walked queries before the STARTING rung demotes
DEFAULT_DEMOTE_AFTER = 2
# consecutive clean queries at a demoted start before promotion back
DEFAULT_PROMOTE_AFTER = 3

def adaptive_policy(max_attempts: int) -> RetryPolicy:
    """No-sleep retry policy for an executor's own adaptive loops (slack
    doubling): each retry already pays a new run, so backoff would only
    add latency."""
    return RetryPolicy(max_attempts=max_attempts, base_delay_s=0.0)


def load_policy(policy: RetryPolicy) -> RetryPolicy:
    """The warehouse-load variant of a query policy: the same attempts
    and backoff, no per-query deadline (a load is not a query)."""
    return RetryPolicy(
        max_attempts=policy.max_attempts,
        base_delay_s=policy.base_delay_s,
        max_delay_s=policy.max_delay_s, jitter=policy.jitter,
        deadline_s=None, seed=policy.seed)


def is_exchange_overflow(exc: BaseException) -> bool:
    return "exchange overflow" in str(exc)


# ------------------------------------------------------------ consensus

class NullChannel:
    """Single-process world: one voter, trivially unanimous."""

    world = 1

    def gather(self, vote: int) -> "list[int] | None":
        return [vote]


class MultihostChannel:
    """Vote transport over the ``torch.distributed`` world
    (``parallel/multihost.gather_votes``). On a world of several ranks
    the pipeline enters exactly one vote per query, at the query
    boundary, success or failure (``ExecutionPipeline._boundary_vote``),
    so the gathers pair across ranks even when the failure was
    rank-local."""

    def __init__(self):
        import torch.distributed as dist
        self.world = dist.get_world_size()

    def gather(self, vote: int) -> "list[int] | None":
        from nds_tpu_torch.parallel import multihost
        votes = multihost.gather_votes(vote)
        if votes is None:
            from nds_tpu_torch.utils.report import TaskFailureCollector
            TaskFailureCollector.notify(
                "placement consensus allgather failed; keeping placement")
        return votes


class Consensus:
    """All-or-none placement agreement. Votes are rung indices into the
    shared ladder (higher = more demoted); every rank applies the same
    rule to the gathered votes (the deepest demotion wins), so all ranks
    switch together or, when the gather fails, none does."""

    def __init__(self, channel=None):
        self.channel = channel or NullChannel()

    def decide(self, vote: int) -> "int | None":
        votes = self.channel.gather(vote)
        if votes is None or len(votes) < getattr(self.channel, "world", 1):
            return None
        return max(votes)


# ------------------------------------------------------------ cost model

class CostModel:
    """The reference's initial-placement chooser: the plan's static size
    estimate and the device high-water marks observed per query (a query
    that went past the budget last time starts out of core). Only a
    universe with the chunked rung gives it a choice, so the pipeline
    consults it from item 6 on."""

    def __init__(self, device_budget: int = DEFAULT_DEVICE_BUDGET,
                 stream_bytes: int = 0,
                 expansion: float = EXPANSION):
        self.device_budget = device_budget
        self.stream_bytes = stream_bytes
        self.expansion = expansion
        # query name -> observed device HWM bytes (max over runs)
        self.hwm_history: dict[str, int] = {}

    def observe(self, qname: str | None, hwm_bytes: int) -> None:
        if qname and hwm_bytes:
            self.hwm_history[qname] = max(
                self.hwm_history.get(qname, 0), int(hwm_bytes))

    def choose(self, planned, universe: tuple,
               tables: "dict | None" = None, catalog=None,
               qname: "str | None" = None, est=None) -> tuple:
        """-> (placement, reason). Deterministic over identical inputs, so
        every rank of a world computes the same initial placement without
        a vote. ``est``: a plan estimate already computed."""
        from nds_tpu_torch.analysis import plan_verify
        if est is None:
            est = plan_verify.estimate_plan(planned, tables=tables,
                                            catalog=catalog)
        fast = universe[0]
        if CHUNKED in universe and fast != CHUNKED:
            hwm = self.hwm_history.get(qname or "")
            if hwm and hwm > self.device_budget:
                return CHUNKED, f"hwm-history:{hwm}>{self.device_budget}"
            if (self.stream_bytes
                    and est.widest_table_bytes > self.stream_bytes):
                return CHUNKED, (f"table-exceeds-stream-bytes:"
                                 f"{est.widest_table_bytes}")
            # join/sort/window/agg intermediates inflate the working set
            # beyond the raw scans: pad the expansion per operator
            ops = est.joins + est.aggregates + est.sorts + est.windows
            factor = self.expansion * (1.0 + 0.1 * ops)
            if est.bytes * factor > self.device_budget:
                return CHUNKED, (f"working-set:{est.bytes}b"
                                 f"x{factor:.1f}")
        return fast, f"fits:{est.bytes}b"


# ------------------------------------------------------------- pipeline

class _CompletedHandle:
    """Already-finished async handle. It carries the query's own stats,
    schedule and timings, and ``result()`` points the pipeline's
    per-query surface back at them, so interleaved dispatches (the
    in-process throughput streams keep ``engine.concurrent_tasks``
    queries in flight) never read each other's accounting. (The
    reference's query span waits for item 7.)"""

    __slots__ = ("_value", "pipe", "stats", "sched", "timings")

    def __init__(self, value, pipe, stats, sched):
        self._value = value
        self.pipe = pipe
        self.stats = stats
        self.sched = sched
        self.timings = pipe.last_timings

    def result(self):
        self.pipe.last_stats = self.stats
        self.pipe.last_schedule = self.sched
        self.pipe.last_timings = self.timings
        return self._value


class _PipelineHandle:
    """Async handle over a placement executor's own handle: a failure
    surfaces at ``result()``, where the ladder runs it again,
    synchronously, with this query's own stats and schedule."""

    __slots__ = ("pipe", "planned", "key", "inner", "placement",
                 "stats", "sched")

    def __init__(self, pipe, planned, key, inner, placement, stats,
                 sched):
        self.pipe = pipe
        self.planned = planned
        self.key = key
        self.inner = inner
        self.placement = placement
        self.stats = stats
        self.sched = sched

    def result(self):
        pipe = self.pipe
        pipe.last_stats = self.stats
        pipe.last_schedule = self.sched
        try:
            out = self.inner.result()
        except Exception as exc:  # noqa: BLE001 - classified in rerun
            self.stats.attempts += 1
            self.stats.errors.append(f"{type(exc).__name__}: {exc}")
            if classify(exc) != "transient":
                self.stats.gave_up_reason = DETERMINISTIC
                raise
            return pipe._run_ladder(
                self.planned, key=self.key, placement=self.placement,
                stats=self.stats, sched=self.sched, pending=exc)
        self.stats.attempts += 1
        pipe._adopt_executor_state(self.placement)
        self.sched["placement"] = self.placement
        pipe._note_success(rescheduled=False)
        return out


class ExecutionPipeline:
    """The Session executor factory for every backend: owns the placement
    executors, the ladder and the query-level retry policy."""

    def __init__(self, backend: str = "cpu", config=None,
                 mesh=None, precision: str = "f64", device=None,
                 consensus: "Consensus | None" = None):
        self.backend = backend
        self.config = config
        self.mesh = mesh
        if precision not in ("f64", "f32", "bf16"):
            raise ValueError(f"unknown engine.precision {precision!r}")
        if precision != "f64":
            # make_device_factory's rule: the reduced precisions wait for
            # ROADMAP Queue 1 item 10
            raise ValueError(f"engine.precision {precision!r} is not "
                             f"ported to the torch engine; only 'f64' is")
        self.precision = precision
        # the torch device of the device and sharded placements
        # (engine.device, the card by default); the CPU oracle runs on
        # the host whatever it is
        if device is None and config is not None:
            device = config.get("engine.device")
        self.device = torch.device(
            "cpu" if backend == CPU else (device or "cuda"))
        self.universe = UNIVERSES.get(backend, (CPU,))
        self.policy = (RetryPolicy.from_config(config) if config
                       else RetryPolicy())
        self.consensus = consensus or Consensus(
            self._default_channel(backend))
        self.ladder_on = self._cfg("engine.placement.ladder",
                                   "on") not in ("off", "0", "false")
        floor = self._cfg("engine.placement.floor", CPU)
        if self._cfg("engine.fallback") == CPU:
            # legacy alias: the ladder bottoms out on the CPU oracle
            floor = CPU
        self.floor = floor if floor in self.universe else self.universe[-1]
        force = self._cfg("engine.placement.force")
        if force and force not in self.universe:
            # a silently dropped pin would hand the user unpinned numbers
            raise ValueError(
                f"engine.placement.force={force!r} is not in the "
                f"{backend!r} backend's placement universe "
                f"{self.universe}")
        self.forced = force or None
        self.demote_after = self._cfg_int("engine.placement.demote_after",
                                          DEFAULT_DEMOTE_AFTER)
        self.promote_after = self._cfg_int(
            "engine.placement.promote_after", DEFAULT_PROMOTE_AFTER)
        # placement name -> live executor (built lazily; device buffers
        # and graphs persist across queries per placement)
        self._executors: dict = {}
        self._tables: "dict | None" = None
        # sticky stream-level demotion state
        self._demoted_to: "str | None" = None
        self._reschedule_streak = 0
        self._clean_streak = 0
        self._just_promoted = False
        # the executor-compatible surface the power loop resets and reads
        self.last_timings: dict = {}
        self.last_stats = RetryStats()
        self.last_schedule: dict = {}

    # -------------------------------------------------------- plumbing

    @property
    def _multi(self) -> bool:
        """A world of several ranks? Placement then moves only through
        one consensus round per query (``_boundary_vote``)."""
        return getattr(self.consensus.channel, "world", 1) > 1

    def _cfg(self, key: str, default=None):
        return self.config.get(key, default) if self.config else default

    def _cfg_int(self, key: str, default: int) -> int:
        return (self.config.get_int(key, default) if self.config
                else default)

    @staticmethod
    def _default_channel(backend: str):
        # only the distributed backend asks torch.distributed for the
        # world: a CPU phase never touches a process group
        if backend != "distributed":
            return NullChannel()
        import torch.distributed as dist
        if dist.is_initialized() and dist.get_world_size() > 1:
            return MultihostChannel()
        return NullChannel()

    def __call__(self, tables: dict) -> "ExecutionPipeline":
        """Session executor-factory protocol: bind the registry. A new
        registry object drops the built executors."""
        if self._tables is not tables:
            self._tables = tables
            self._executors.clear()
        return self

    def invalidate(self) -> None:
        """Session.invalidate hook: drop every placement executor. The
        demotion state stays: it describes the workload, not the
        tables."""
        self._executors.clear()

    def reset_query(self) -> None:
        """Pre-query reset: a query that fails before dispatch must not
        inherit the previous query's timings, stats or schedule."""
        self.last_timings = {}
        self.last_stats = RetryStats()
        self.last_schedule = {}

    # ------------------------------------------------------- executors

    def _executor(self, placement: str):
        ex = self._executors.get(placement)
        if ex is not None:
            return ex
        tables = self._tables if self._tables is not None else {}
        if placement == CPU:
            from nds_tpu_torch.engine.cpu_exec import CpuExecutor
            ex = CpuExecutor(tables)
        elif placement == DEVICE:
            from nds_tpu_torch.engine.device_exec import DeviceExecutor
            ex = DeviceExecutor(tables, device=self.device)
        elif placement == SHARDED:
            from nds_tpu_torch.parallel.dist_exec import DistributedExecutor
            ex = DistributedExecutor(tables, mesh=self.mesh,
                                     device=self.device)
        elif placement == CHUNKED:
            raise ValueError("the chunked placement is not ported yet "
                             "(ROADMAP Queue 1 item 6)")
        else:
            raise ValueError(f"unknown placement {placement!r}")
        self._executors[placement] = ex
        return ex

    def _adopt_executor_state(self, placement: str) -> None:
        """Forward the serving executor's per-query timings so
        ``obs.query_timings(pipeline)`` and the power loop see them."""
        ex = self._executors.get(placement)
        if ex is None:
            return
        self.last_timings = getattr(ex, "last_timings", {}) or {}

    # ------------------------------------------------------ the ladder

    def rungs_for(self, initial: str) -> list:
        """The rungs of a query starting at ``initial``, cut at the floor.
        On a world of several ranks, one rung: placement moves only
        between queries, through the vote every rank enters."""
        if not self.ladder_on or self._multi:
            return [initial]
        order = list(self.universe)
        try:
            start = order.index(initial)
        except ValueError:
            return [initial]
        rungs = order[start:]
        if self.floor in rungs:
            rungs = rungs[:rungs.index(self.floor) + 1]
        return rungs

    def _initial_placement(self) -> tuple:
        """(placement, reason): the pin, the stream's sticky demotion, or
        the universe's fastest placement (the reference's cost model's
        choice wherever no chunked rung is in the universe)."""
        if self.forced:
            return self.forced, "forced"
        if self._demoted_to:
            return self._demoted_to, "sticky-demotion"
        return self.universe[0], "fast"

    def _schedule(self) -> tuple:
        placement, why = self._initial_placement()
        stats, sched = self._new_schedule(placement, why)
        self.last_stats, self.last_schedule = stats, sched
        return placement, stats, sched

    def execute(self, planned, key: object = None):
        placement, stats, sched = self._schedule()
        return self._run_ladder(planned, key=key, placement=placement,
                                stats=stats, sched=sched)

    def execute_async(self, planned, key: object = None):
        """Async dispatch with the ladder armed at ``result()``: the device
        placement dispatches through its executor's own
        ``execute_async``; a transient failure surfaces at ``result()``
        and runs down the ladder there. Every handle carries its own
        stats and schedule. The CPU, the sharded placement and any
        placement on a world of several ranks run synchronously (the
        boundary vote must fire in dispatch order on every rank; the
        distributed executor runs its collectives eagerly)."""
        placement, stats, sched = self._schedule()
        ex = self._executor(placement)
        dispatch = getattr(ex, "execute_async", None)
        if dispatch is None or placement in (CPU, SHARDED) or self._multi:
            out = self._run_ladder(planned, key=key, placement=placement,
                                   stats=stats, sched=sched)
            return _CompletedHandle(out, self, stats, sched)
        try:
            inner = (dispatch(planned, key) if key is not None
                     else dispatch(planned))
        except Exception as exc:  # noqa: BLE001 - classified in rerun
            stats.attempts += 1
            stats.errors.append(f"{type(exc).__name__}: {exc}")
            if classify(exc) != "transient":
                stats.gave_up_reason = DETERMINISTIC
                raise
            out = self._run_ladder(planned, key=key, placement=placement,
                                   stats=stats, sched=sched, pending=exc)
            return _CompletedHandle(out, self, stats, sched)
        return _PipelineHandle(self, planned, key, inner, placement,
                               stats, sched)

    # ---------------------------------------------------- ladder walk

    def _current_query(self) -> "str | None":
        return faults.current_context().get("query")

    def _new_schedule(self, placement: str, why: str) -> tuple:
        stats = RetryStats()
        sched = {
            "initial": placement, "placement": placement,
            "reason": why, "reschedules": 0, "ladder": [placement],
        }
        if self._just_promoted:
            sched["promoted_back"] = True
            self._just_promoted = False
        return stats, sched

    def _run_ladder(self, planned, key: object = None,
                    placement: str = CPU,
                    stats: "RetryStats | None" = None,
                    sched: "dict | None" = None,
                    pending: "Exception | None" = None):
        """Walk the ladder for one query. Same-rung transients retry under
        the policy's backoff and attempt budget; out of memory and
        exchange overflow step down at once (the same program at the same
        placement cannot help); deterministic failures raise. Every
        switch is a consensus decision. ``pending``: an async dispatch's
        failure, whose spent attempt counts against the same budget."""
        qname = self._current_query()
        stats = stats if stats is not None else self.last_stats
        sched = sched if sched is not None else self.last_schedule
        rungs = self.rungs_for(placement)
        start = self._clock()
        deadline_s = self.policy.deadline_s

        def overrun() -> bool:
            return (deadline_s is not None
                    and self._clock() - start > deadline_s)

        def flag_deadline() -> None:
            stats.deadline_exceeded = True

        try:
            return self._walk(planned, key, rungs, stats, sched, pending,
                              qname, deadline_s, start, overrun,
                              flag_deadline)
        finally:
            ok = sched.pop("_succeeded", False)
            if self._multi:
                # every rank votes exactly once per query, success or
                # failure, so the vote rounds pair across ranks
                self._boundary_vote(failed=not ok)

    def _walk(self, planned, key, rungs, stats, sched, pending, qname,
              deadline_s, start, overrun, flag_deadline):
        with deadline_scope(deadline_s, self._clock, start=start):
            i = 0
            while i < len(rungs):
                rung = rungs[i]
                last_rung = i == len(rungs) - 1
                if pending is not None:
                    exc, pending = pending, None
                else:
                    try:
                        ex = self._executor(rung)
                        out = (ex.execute(planned) if key is None
                               else ex.execute(planned, key))
                    except QueryDeadlineExceeded as exc2:
                        stats.errors.append(
                            f"{type(exc2).__name__}: {exc2}")
                        stats.gave_up_reason = "deadline"
                        flag_deadline()
                        raise
                    except Exception as exc2:  # noqa: BLE001
                        stats.attempts += 1
                        stats.errors.append(
                            f"{type(exc2).__name__}: {exc2}")
                        exc = exc2
                    else:
                        stats.attempts += 1
                        if overrun():
                            flag_deadline()
                        self._adopt_executor_state(rung)
                        sched["placement"] = rung
                        sched["_succeeded"] = True
                        self._note_success(
                            rescheduled=sched["reschedules"] > 0)
                        return out
                # ---- failure handling at this rung
                if classify(exc) != "transient":
                    stats.gave_up_reason = DETERMINISTIC
                    if overrun():
                        flag_deadline()
                    raise exc
                stepping = (not last_rung
                            and (is_oom(exc) or is_exchange_overflow(exc)))
                if stepping:
                    # propose, agree, then act: the slack re-plan changes
                    # executor state every rank must share
                    proposal, replan = self._propose(rungs, i, exc, sched)
                    agreed = self.consensus.decide(proposal)
                    if agreed is None or agreed >= len(rungs):
                        # no agreement: keep placement, fail the query
                        # rather than diverge from the other ranks
                        stats.gave_up_reason = "consensus"
                        self._note_failure()
                        raise exc
                    if agreed == i and replan:
                        self._apply_replan(sched)
                    elif agreed > i:
                        i = agreed
                        self._reschedule(rungs[i], sched, qname)
                    continue
                # generic transient (or out of memory at the floor):
                # same-rung retry under the budget, then a step down if a
                # rung remains, else give up
                if stats.attempts >= self.policy.max_attempts:
                    if not last_rung:
                        proposal, _replan = self._propose(
                            rungs, i, exc, sched, force_step=True)
                        agreed = self.consensus.decide(proposal)
                        if agreed is not None and agreed < len(rungs) \
                                and agreed > i:
                            i = agreed
                            self._reschedule(rungs[i], sched, qname)
                            stats.attempts = 0
                            continue
                    stats.gave_up_reason = (
                        f"attempts_exhausted({stats.attempts})")
                    if overrun():
                        flag_deadline()
                    self._note_failure()
                    raise exc
                d = self.policy.delay_for(stats.retries)
                if (deadline_s is not None
                        and self._clock() - start + d > deadline_s):
                    stats.gave_up_reason = "deadline"
                    flag_deadline()
                    self._note_failure()
                    raise exc
                stats.retries += 1
                stats.backoff_s += d
                if d > 0:
                    self.policy._sleep(d)
        raise RuntimeError("unreachable: ladder exhausted without raise")

    def _clock(self):
        return self.policy._clock()

    def _propose(self, rungs: list, i: int, exc: Exception,
                 sched: dict, force_step: bool = False
                 ) -> "tuple[int, bool]":
        """This rank's vote: (rung index, is a slack re-plan). No side
        effect until the vote agrees; the sharded re-plan is proposed
        once per query, and only for exchange overflow."""
        if (not force_step and rungs[i] == SHARDED
                and is_exchange_overflow(exc)
                and not sched.get("slack_grown")):
            ex = self._executors.get(SHARDED)
            if ex is not None and hasattr(ex, "grow_slack"):
                return i, True  # vote the SAME rung, re-planned
        return i + 1, False

    def _apply_replan(self, sched: dict) -> None:
        """The agreed sharded re-plan: double the base slack and drop the
        plans' state, on every rank together."""
        self._executors[SHARDED].grow_slack()
        sched["slack_grown"] = True
        sched.setdefault("ladder", []).append(SHARDED_REPLAN)
        sched["reschedules"] += 1

    def _reschedule(self, rung: str, sched: dict, qname) -> None:
        if sched.get("ladder", [None])[-1] == rung:
            return  # the slack re-plan already recorded this step
        sched["reschedules"] += 1
        sched["ladder"].append(rung)
        # a failed query's summary names the deepest placement tried
        sched["placement"] = rung
        # not a TaskFailureCollector notification: a reschedule is a
        # scheduling decision, which placement/reschedules/ladder carry
        print(f"RESCHEDULED {qname or 'query'} -> {rung} "
              f"(ladder {'->'.join(sched['ladder'])})")

    # ------------------------------------------- demotion / promotion

    def _note_success(self, rescheduled: bool) -> None:
        if self._multi:
            return  # demotion and promotion run in the boundary vote
        if rescheduled:
            self._clean_streak = 0
            self._reschedule_streak += 1
            if (self._demoted_to is None
                    and self._reschedule_streak >= self.demote_after
                    and self.ladder_on):
                self._switch_start(self.last_schedule.get("placement"))
        else:
            self._reschedule_streak = 0
            if self._demoted_to is not None:
                self._clean_streak += 1
                if self._clean_streak >= self.promote_after:
                    self._promote()

    def _note_failure(self) -> None:
        """A query that exhausted the whole ladder counts toward the
        sticky demotion too."""
        if self._multi:
            return
        self._clean_streak = 0
        self._reschedule_streak += 1
        if (self._demoted_to is None
                and self._reschedule_streak >= self.demote_after
                and self.ladder_on and len(self.universe) > 1):
            self._switch_start(self.floor)

    def _boundary_vote(self, failed: bool) -> None:
        """One consensus round per query on a world of several ranks,
        entered by every rank whatever its own outcome: each votes the
        start rung it wants next, the deepest demotion wins, and every
        rank switches or, on a failed gather, none does."""
        order = list(self.universe)
        cur = order.index(self._demoted_to) if self._demoted_to else 0
        if failed:
            self._clean_streak = 0
            self._reschedule_streak += 1
            want = cur
            if (self.ladder_on and len(order) > 1
                    and self._reschedule_streak >= self.demote_after):
                floor_i = (order.index(self.floor)
                           if self.floor in order else len(order) - 1)
                want = min(cur + 1, floor_i)
        else:
            self._reschedule_streak = 0
            want = cur
            if cur:
                self._clean_streak += 1
                if self._clean_streak >= self.promote_after:
                    want = 0
        agreed = self.consensus.decide(want)
        if agreed is None:
            return  # no agreement: nobody moves
        agreed = min(agreed, len(order) - 1)
        new = None if agreed == 0 else order[agreed]
        if new == self._demoted_to:
            return
        if new is None:
            self._demoted_to = None
            self._reschedule_streak = 0
            self._clean_streak = 0
            self._just_promoted = True
            print("PLACEMENT PROMOTION: stream restored to the cost "
                  "model's placement after clean queries")
        else:
            self._demoted_to = new
            self._clean_streak = 0
            print(f"PLACEMENT DEMOTION: stream now starts at "
                  f"{new!r} (consensus)")

    def _switch_start(self, target: "str | None") -> None:
        if not target or target == self.universe[0]:
            return
        vote = list(self.universe).index(target) \
            if target in self.universe else len(self.universe) - 1
        agreed = self.consensus.decide(vote)
        if agreed is None:
            return
        agreed = min(agreed, len(self.universe) - 1)
        self._demoted_to = self.universe[agreed]
        self._clean_streak = 0
        print(f"PLACEMENT DEMOTION: stream now starts at "
              f"{self._demoted_to!r} after {self._reschedule_streak} "
              f"consecutive rescheduled queries")

    def _promote(self) -> None:
        agreed = self.consensus.decide(0)
        if agreed is None or agreed != 0:
            # some rank still wants the demotion: stay, and try again
            # after the next clean streak
            self._clean_streak = 0
            return
        self._demoted_to = None
        self._reschedule_streak = 0
        self._clean_streak = 0
        self._just_promoted = True
        print("PLACEMENT PROMOTION: stream restored to the cost "
              "model's placement after clean queries")


def make_pipeline(config, backend: "str | None" = None
                  ) -> ExecutionPipeline:
    """The pipeline a Session uses as its executor factory, from an
    EngineConfig: the one construction point ``make_session``
    (``utils/power_core.py``) routes every backend through. The ``gpu``
    and ``distributed`` backends run on ``engine.device`` (``cuda``, the
    card, unless the CPU is asked for) and raise ``NoCudaDevice`` here,
    before anything is loaded, where the card is asked for and there is
    none; ``distributed`` joins the launch environment's world
    (``parallel/multihost``) or starts a world of one."""
    from nds_tpu_torch.device import resolve_device
    backend = backend or config.get("engine.backend", "gpu")
    if backend not in UNIVERSES:
        raise ValueError(
            f"engine.backend {backend!r} is not one of the port's: 'gpu' "
            f"(the device engine), 'distributed' (the sharded engine) or "
            f"'cpu' (the CPU oracle)")
    device = (None if backend == CPU
              else resolve_device(config.get("engine.device", "cuda")))
    mesh = None
    precision = "f64"
    if backend == "gpu" and config.get_bool("engine.floats"):
        precision = config.get("engine.precision", "f64")
    if backend == "distributed":
        from nds_tpu_torch.parallel import multihost
        multihost.maybe_initialize(device)
        shards = config.get_int("engine.mesh.shards", 0)
        mesh = multihost.global_mesh(shards if shards > 1 else None,
                                     device=device)
    return ExecutionPipeline(
        backend=backend, config=config, mesh=mesh, precision=precision,
        device=device)
