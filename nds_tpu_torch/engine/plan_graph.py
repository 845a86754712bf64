"""One CUDA graph per plan: the executor's compile-once program, ported.

Counterparts: ``nds_tpu/engine/device_exec.py:880-945``
(``_compile_or_load``: each plan traced and compiled once into one
static-shape XLA program, its host-side results kept beside it as
``entry["side"]``) and ``:947-1000`` (the compactor's own cached program).
The reference dispatches that program on every later run of the plan.
The port runs a plan eagerly on its first call (that run fills the
executor's memos, scan views, uploads and look-back buffers, and its
result is the one returned), then captures the same launches on the
executor's stream into one ``torch.cuda.CUDAGraph``, compactor included,
and replays the graph on every later call. ``DeviceExecutor`` holds one
``PlanGraphs`` on the card; the CPU runs eagerly and never gets one.

What a replay needs besides the graph (``PlanGraph``):

- **static outputs**: the tensors the capture returned (the result's row
  mask and columns, the compactor's permutation, the counts word), which
  every replay writes again;
- **side**: the host-side results of the trace, which a replay does not
  compute (the output string dictionaries, the ``kernels`` block,
  ``bytes_scanned``);
- **counts**: the look-back epochs and the kernel launches the capture's
  calls recorded. A replay draws the epochs on the card and makes the
  launches with no call of the host, so each replay adds them to
  ``kernels``' counts (after a reset in place where the epochs would
  pass the host's half of the range), and the capture, which ran
  nothing, takes its calls' counts back;
- **pins**: strong references to every tensor the graph reads and does
  not own (scan buffers, memoized dictionary tables), and the buffer keys
  it reads, by which the executor drops exactly the graphs that read what
  it frees.

Every graph of an executor allocates from one memory pool, so later
captures reuse what earlier ones freed; once no live graph was captured
in the pool (all dropped, or the only capture failed), the next capture
takes a new pool, since torch's allocators count a pool's graphs and the
pinned-host allocator fails a capture into a pool whose count fell to 0. A replay overwrites the memory of
the graphs captured after it, so each replay's outputs are read before
another graph replays (the executor copies them to the host at once).
``torch.cuda.graph``'s context manager also synchronizes, collects and
empties the allocator's cache at every capture, which makes the next
eager allocations pay ``cudaMalloc`` again; this runner calls
``capture_begin``/``capture_end`` itself after one synchronize of its
stream. A persistent store of graphs has no counterpart: a CUDA graph
cannot be serialized across processes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc

import torch

from nds_tpu_torch.engine import kernels as KX


class CaptureError(RuntimeError):
    """A plan's launches could not be captured into a graph."""


@dataclasses.dataclass(eq=False)
class PlanGraph:
    """One captured plan: its graph, static outputs, host-side results,
    the counts one replay adds, and what it reads without owning."""
    plan: object
    graph: object
    outputs: tuple
    side: dict
    epochs: dict
    launches: dict
    reads: frozenset
    pins: tuple
    # the memory pool the graph was captured in
    pool: object = None


class _Recording:
    """What one capture reads without owning."""

    def __init__(self, label: str):
        self.label = label
        self.reads: set = set()
        self.pins: list = []


def _diff(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


class PlanGraphs:
    """The capture-and-replay runner of one executor: its own stream, one
    memory pool shared by all its graphs (a ``torch.cuda.MemPool``, which
    holds the pool while no graph does), and a ``PlanGraph`` per plan key.
    ``graph_cls`` and ``new_pool`` default to ``torch.cuda.CUDAGraph`` and
    ``torch.cuda.MemPool``; a test passes stand-ins (with
    ``stream=None``, no stream is entered)."""

    def __init__(self, device, graph_cls=None, new_pool=None,
                 stream="new"):
        self.device = device
        self.graph_cls = graph_cls or torch.cuda.CUDAGraph
        self.new_pool = new_pool or torch.cuda.MemPool
        self.stream = (torch.cuda.Stream(device) if stream == "new"
                       else stream)
        self.pool = None
        self.graphs: dict = {}
        # what the capture in progress reads
        self._rec: "_Recording | None" = None
        # the capture or pool run in progress, which bars cache fills
        self.barring: "str | None" = None
        self.captures = 0
        self.replays = 0
        self.pool_resets = 0
        self.cache_releases = 0

    # ------------------------------------------------------------ stream

    @contextlib.contextmanager
    def on_stream(self):
        """The executor's work on the runner's stream, ordered after what
        the caller's stream enqueued before."""
        if self.stream is None:
            yield
            return
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            yield

    # --------------------------------------------------------- bookkeeping

    def read(self, key: str, tensor) -> None:
        """The capture in progress reads buffer ``key``."""
        if self._rec is not None:
            self._rec.reads.add(key)
            self._rec.pins.append(tensor)

    def pin(self, value) -> None:
        """The capture in progress reads ``value`` (a memoized table)."""
        if self._rec is not None:
            self._rec.pins.append(value)

    def get(self, key) -> "PlanGraph | None":
        return self.graphs.get(key)

    def drop(self, key) -> None:
        self.graphs.pop(key, None)

    def drop_reading(self, prefix: str) -> list:
        """Drop every graph that reads a buffer under ``prefix``; returns
        their keys."""
        gone = [k for k, g in self.graphs.items()
                if any(r.startswith(prefix) for r in g.reads)]
        for k in gone:
            del self.graphs[k]
        return gone

    def reset(self) -> None:
        """Drop every graph and the pool, and hand the pool's memory back
        (``graph_pool_resets``)."""
        self.graphs.clear()
        self.pool = None
        self.pool_resets += 1
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def pool_bytes(self) -> "int | None":
        """Bytes the allocator holds in the graphs' pool (None when no
        pool is held or the snapshot does not tell pools apart)."""
        if self.pool is None or self.device.type != "cuda":
            return None
        segs = torch.cuda.memory_snapshot()
        if segs and "segment_pool_id" not in segs[0]:
            return None
        pid = tuple(self._pool_id())
        return sum(s["total_size"] for s in segs
                   if tuple(s["segment_pool_id"]) == pid)

    # --------------------------------------------------- capture, replay

    def _pool_id(self):
        return getattr(self.pool, "id", self.pool)

    def capture(self, key, plan, label: str, since: dict, side: dict,
                fn) -> PlanGraph:
        """Capture ``fn()`` (which returns the static outputs) for ``plan``
        under ``key``. ``since``: ``kernels.lookback_epochs()`` before the
        plan's eager run just before, whose look-back epochs the capture's
        launches will draw too: they are reserved first, since no buffer
        may be zeroed during the capture. A capture cannot hand the
        allocator's cached blocks back to the card, so one that runs out of
        memory is ended, the cache emptied (``cache_releases``) and the
        capture made once more; a second shortage raises
        ``torch.cuda.OutOfMemoryError`` as it is. A capture that fails
        otherwise raises ``CaptureError`` naming the plan."""
        self.graphs.pop(key, None)
        KX.lookback_reserve(_diff(KX.lookback_epochs(), since))
        for attempt in (0, 1):
            if self.pool is None or not any(
                    g.pool is self.pool for g in self.graphs.values()):
                # a pool that no live graph was captured in takes no more
                # captures: the allocators count a pool's graphs, and
                # torch's pinned-host allocator fails a capture into a pool
                # whose count fell to 0 (after every graph in it, or a
                # failed capture's, was dropped), leaving the stream
                # allocating to that pool; a new pool starts at 0 users
                self.pool = self.new_pool()
            try:
                g = self._capture_once(plan, label, side, fn)
                break
            except torch.cuda.OutOfMemoryError:
                if attempt or self.device.type != "cuda":
                    raise
            # outside the handler, so that the failed capture's tensors
            # are gone
            torch.cuda.empty_cache()
            self.cache_releases += 1
        self.graphs[key] = g
        self.captures += 1
        return g

    def _capture_once(self, plan, label: str, side: dict, fn) -> PlanGraph:
        if self.stream is not None:
            self.stream.synchronize()
        e0, l0 = KX.lookback_epochs(), KX.launch_counts()
        rec = _Recording(label)
        graph = self.graph_cls()
        self._rec, self.barring = rec, f"{label} is captured"
        # no collection of reference cycles mid-capture: freeing a tensor
        # there (a pinned host buffer of a replay's copies among them)
        # would be recorded on, or refused by, the capturing stream
        collecting = gc.isenabled()
        gc.disable()
        try:
            with KX.capture_scope():
                try:
                    graph.capture_begin(pool=self._pool_id(),
                                        capture_error_mode="thread_local")
                except BaseException:
                    self._end_pool()
                    raise
                try:
                    outputs = fn()
                except BaseException:
                    self._abort(graph)
                    raise
                graph.capture_end()
        except torch.cuda.OutOfMemoryError:
            raise
        except Exception as exc:  # noqa: BLE001 - re-raised, naming the plan
            raise CaptureError(f"{label} failed to capture: "
                               f"{type(exc).__name__}: {exc}") from exc
        finally:
            if collecting:
                gc.enable()
            self._rec = self.barring = None
            # the capture's calls launched nothing and drew no epoch
            drawn = _diff(KX.lookback_epochs(), e0)
            launched = _diff(KX.launch_counts(), l0)
            KX.lookback_count(drawn, -1)
            KX.count_launches(launched, -1)
        return PlanGraph(plan, graph, outputs, side, drawn, launched,
                         frozenset(rec.reads), tuple(rec.pins), self.pool)

    def _abort(self, graph) -> None:
        """End a capture that failed. Where the capture was invalidated,
        ``capture_end`` raises before the allocator stops serving the
        stream from the pool, so that is ended here too, and later
        captures take a new pool."""
        try:
            graph.capture_end()
        except RuntimeError:
            self._end_pool()

    def _end_pool(self) -> None:
        """Stop the allocator serving the stream from the pool of a capture
        that failed before its end, and let later captures take a new
        pool."""
        if self.device.type == "cuda":
            with contextlib.suppress(RuntimeError):
                torch._C._cuda_endAllocateToPool(self.device.index or 0,
                                                 self._pool_id())
        self.pool = None

    @contextlib.contextmanager
    def pool_run(self, label: str):
        """An eager run of a plan that has a graph, while the executor's
        graphs are off (``use_graphs``), allocating from the graphs' pool:
        beside the pool it might not fit (a plan's graph holds as much of
        the pool as the plan's eager run takes). Every tensor of the run is
        freed by its end, before any replay writes the pool again, so no
        cache may be made or filled during it."""
        self.barring = f"{label} runs eagerly from the graphs' pool"
        try:
            with KX.capture_scope(pool_run=True), (
                    torch.cuda.use_mem_pool(self.pool)
                    if self.device.type == "cuda"
                    else contextlib.nullcontext()):
                yield
        finally:
            self.barring = None

    def replay(self, g: PlanGraph) -> tuple:
        """Replay ``g`` on the runner's stream, counting its epochs and
        launches; returns its static outputs, to be read before another
        graph replays."""
        KX.lookback_reserve(g.epochs)
        KX.lookback_count(g.epochs)
        KX.count_launches(g.launches)
        g.graph.replay()
        self.replays += 1
        return g.outputs
