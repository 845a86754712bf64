"""Distributed (SPMD) plan executor of the port, over ``torch.distributed``.

Port of ``nds_tpu/parallel/dist_exec.py``. The reference traces one
``shard_map`` program over a device mesh; here every rank of the world
(one process per device: NCCL on the card, gloo on the CPU) runs the
same plan eagerly on its own rows, and the collectives sit where the
reference's do:

- tables at or above ``shard_threshold`` rows are row-sharded: padded
  with zeros to a multiple of the world size, rank ``r`` holds rows
  ``[r * local, (r + 1) * local)`` (``shard_of``); smaller tables, and
  the survivors of a filtered scan of at most ``BROADCAST_ROWS`` rows,
  are replicated;
- a join of two sharded sides repartitions both by join key through the
  hash-partition exchange (``exchange.py``: the ``exchange_pack`` kernel,
  then one all-to-all per column), so matching keys meet on one rank;
  a sharded side against a replicated one joins in place, or is
  gathered (``all_gather_into_tensor``) where the join needs all of it;
- a grouped aggregate over sharded rows exchanges by group key and
  aggregates locally; a global one reduces with ``all_reduce`` (SUM,
  MIN, MAX);
- sorts, limits, DISTINCT, set operations, windows, scalar subplans and
  the root gather their sharded inputs first, so every rank materializes
  the same ``ResultTable`` (rank 0 reports).

Exchange and join overflow is summed per rank and max-reduced over the
world before the host reads it, so every rank takes the same retry at a
doubled slack. Every host decision between two collectives (staging
cuts, scan views, kernel choices, capacities) comes from host tables
every rank holds whole, so the ranks call the same collectives in the
same order. An exchange ships only the columns that some node above the
exchanged one reads (the reference ships every column and XLA drops the
unread ones); the rows, and so every result and kernel block, are the
same.

A table with deleted rows (``columnar/delta.py``) uploads its live mask
in the table's own layout (``_live_host``: sharded tables False-padded
like their columns), and the sharded scan ANDs its slice into the row
gate, as the reference's ``_upload_live`` does.

Left for later slices: the AOT plan-cache hooks, the skew gauge and the
metrics counters and the literal parameterization (``sql.params``) of
the reference.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from nds_tpu_torch.engine import device_exec as dx
from nds_tpu_torch.engine.device_exec import (
    DCtx, DVal, DeviceExecError, _ok, _to_float,
)
from nds_tpu_torch.engine.types import FloatType
from nds_tpu_torch.io.host_table import HostTable
from nds_tpu_torch.parallel.exchange import exchange, exchange_hierarchical
from nds_tpu_torch.parallel.mesh import (
    DATA_AXIS, HOST_AXIS, make_mesh, pad_to_multiple,
)
from nds_tpu_torch.sql import ir
from nds_tpu_torch.sql import plan as P

# tables at or above this row count shard across the world; smaller ones
# replicate (the Spark broadcast threshold analog, but by rows)
DEFAULT_SHARD_THRESHOLD = 8192


def shard_rows(nrows: int, world: int) -> int:
    """Rows each rank holds of a sharded table (its padded length over
    the world size)."""
    return pad_to_multiple(max(nrows, world), world) // world


def shard_of(values: np.ndarray, rank: int, world: int) -> np.ndarray:
    """Rank ``rank``'s rows of a sharded column: the column padded with
    zeros (``False`` for a null mask) to a multiple of ``world``, rows
    ``[rank * local, (rank + 1) * local)``; the reference's ``_upload``
    layout of one device."""
    local = shard_rows(len(values), world)
    part = values[rank * local:(rank + 1) * local]
    if len(part) < local:
        part = np.concatenate(
            [part, np.zeros(local - len(part), dtype=values.dtype)])
    return np.ascontiguousarray(part)


class DistributedExecutor(dx.DeviceExecutor):
    """Session-compatible executor that runs plans SPMD over the ranks of
    a mesh, on ``device`` (the card unless the CPU is asked for). Its
    ``execute`` is the device executor's, so it fires the
    ``device.execute`` fault point with ``executor="DistributedExecutor"``
    as the reference's does."""

    # the sharded path scans raw even under an active columnar mode:
    # packed words and run starts do not follow the shard layout
    COLUMNAR_UPLOAD = False

    # eager on the caller's stream, as before plan graphs: capturing the
    # NCCL collectives of a plan is later work
    use_graphs = False

    # survivor cap for turning a sharded filtered scan into a replicated
    # reduced build side
    BROADCAST_ROWS = 1 << 18

    # plan entries kept (the reference's bound on compiled programs)
    MAX_COMPILED = 24
    MAX_ENTRIES = MAX_COMPILED

    # plans heavier than this split into staged sub-plans, at the
    # reference's cuts for the distributed engine (``NDS_TPU_STAGE_DIST``)
    STAGE_WEIGHT = int(os.environ.get("NDS_TPU_STAGE_DIST", "24"))

    def __init__(self, tables: dict[str, HostTable], mesh=None,
                 n_devices: "int | None" = None,
                 shard_tables: "set[str] | None" = None,
                 shard_threshold: int = DEFAULT_SHARD_THRESHOLD,
                 slack: float = 2.0, device=None):
        super().__init__(tables, device)
        self.mesh = mesh if mesh is not None else make_mesh(
            n_devices, device=self.device)
        self.n_dev = self.mesh.size
        self.rank = self.mesh.rank
        self.mesh_2d = len(self.mesh.shape) == 2
        if self.mesh_2d:
            if self.mesh.axis_names != (HOST_AXIS, DATA_AXIS):
                raise ValueError(
                    f"2-D mesh axes must be ({HOST_AXIS!r}, {DATA_AXIS!r}), "
                    f"got {self.mesh.axis_names}: build it with "
                    f"make_multihost_mesh")
            self.n_hosts, self.n_lanes = self.mesh.shape
        else:
            self.n_hosts, self.n_lanes = 1, self.n_dev
        self._explicit_shard = shard_tables
        self.shard_threshold = shard_threshold
        self.slack = slack

    def _is_sharded(self, table: str) -> bool:
        if self._explicit_shard is not None:
            return table in self._explicit_shard
        return self.tables[table].nrows >= self.shard_threshold

    def grow_slack(self) -> None:
        """Re-plan at a doubled base slack: every plan entry goes, and
        the next run of each plan starts from the new slack. Every rank
        must call it at the same point."""
        self.slack *= 2
        for key in [k for k in self._entries if not self._is_stage_key(k)]:
            self._evict_query_state(key)

    def _trace(self, slack: float) -> "_DistTrace":
        return _DistTrace(self, slack)

    def _encoding_on(self, table: str) -> bool:
        return self.COLUMNAR_UPLOAD and super()._encoding_on(table)

    def _upload(self, key: str, table: str, name: str) -> None:
        if not self._is_sharded(table):
            super()._upload(key, table, name)
            return
        col = self.tables[table].columns[name]
        host = {"": shard_of(col.values, self.rank, self.n_dev)}
        if col.null_mask is not None:
            host["#v"] = shard_of(col.null_mask, self.rank, self.n_dev)
        self._place(key, None, host, 0)

    def _live_host(self, table: str, live: np.ndarray) -> np.ndarray:
        # a sharded table's mask shards with its columns' pad layout
        # (False-padded, so padded slots stay dead)
        if not self._is_sharded(table):
            return live
        return shard_of(live, self.rank, self.n_dev)

    def scan_view(self, node):
        rv = super().scan_view(node)
        if rv is None or not self._is_sharded(node.table):
            return rv
        # a sharded table takes the reduced (replicated) form only when
        # its survivors are broadcast-sized
        if rv.nrows <= self.BROADCAST_ROWS:
            return rv
        # reject for good: the decision is deterministic, and the cached
        # view's host survivor index is O(rows)
        for ck, v in self._scan_views.items():
            if v is rv:
                self._scan_views[ck] = "full"
                break
        return None


def _column_refs(node: P.Node) -> set:
    return {(c.binding, c.name) for e in P.all_exprs(node)
            for c in ir.walk(e) if isinstance(c, ir.ColRef)}


def _addressed(parent: P.Node, child: P.Node) -> set:
    """Columns of ``child``'s context that ``parent`` reads by address
    rather than through an expression."""
    if isinstance(parent, P.DerivedScan):
        return {(child.binding, n) for n, _ in child.output}
    if isinstance(parent, P.StagedScan):
        return {(child.binding, mangled) for _b, _n, mangled, _dt
                in parent.cols}
    if isinstance(parent, (P.SetOp, P.Distinct)):
        return {(child.binding, n) for n, _ in child.output}
    return set()


def needed_above(planned: P.PlannedQuery) -> dict:
    """{id(node): the (binding, name) columns that the nodes above it
    read}: every column an ancestor's expressions name or an ancestor
    reads by address, the query's result columns included. A node shared
    by several parents gets the union of their needs."""
    roots = [planned.root, *planned.scalar_subplans]
    order, seen = [], set()

    def visit(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for c in P.children(node):
            visit(c)
        order.append(node)

    for r in roots:
        visit(r)
    need = {id(n): set() for n in order}
    for r in roots:
        need[id(r)] |= {(r.binding, n) for n, _ in r.output}
    # reversed post-order: every parent before its children
    for node in reversed(order):
        above = need[id(node)] | _column_refs(node)
        for c in P.children(node):
            need[id(c)] |= above | _addressed(node, c)
    return need


class _DistTrace(dx._Trace):
    def __init__(self, ex: DistributedExecutor, slack: float):
        super().__init__(ex, slack)
        self.n_dev = ex.n_dev
        self.world = ex.mesh.world
        self._need: dict = {}

    def total_overflow(self):
        """Join-expansion and exchange overflow, max-reduced over the
        world: the host reads the same count on every rank."""
        return self.world.all_reduce(super().total_overflow(), "max")

    # ------------------------------------------------------------- helpers

    def _kept(self, ctx: DCtx, node: P.Node) -> list:
        """The columns of ``node``'s context that the nodes above read."""
        need = self._need[id(node)]
        return [k for k in ctx.cols if k in need]

    def _replicate(self, ctx: DCtx, node: P.Node) -> DCtx:
        """A sharded context gathered whole on every rank (in rank
        order, the reference's tiled all_gather): the columns that the
        nodes above ``node`` read."""
        if not getattr(ctx, "sharded", False):
            return ctx
        gather = self.world.all_gather
        out = DCtx(ctx.n * self.n_dev, gather(ctx.row))
        for k in self._kept(ctx, node):
            dv = ctx.cols[k]
            valid = None if dv.valid is None else gather(dv.valid)
            out.cols[k] = dv.with_arrays(gather(dv.arr), valid)
        out.sharded = False
        return out

    def _exchange_ctx(self, ctx: DCtx, key, kok, node: P.Node) -> DCtx:
        """Repartition a sharded ctx by an int key: capacity ctx.n *
        slack, rows colocated by key hash."""
        names = self._kept(ctx, node)
        arrays = [ctx.cols[k].arr for k in names]
        valids = [ctx.cols[k].valid for k in names]
        payload = arrays + [v for v in valids if v is not None]
        ok = ctx.row & kok
        if self.ex.mesh_2d:
            mesh = self.ex.mesh
            outs, out_ok, n_over = exchange_hierarchical(
                payload, key, ok, self.ex.n_hosts, self.ex.n_lanes,
                self.slack, mesh.axis(HOST_AXIS), mesh.axis(DATA_AXIS))
        else:
            outs, out_ok, n_over = exchange(
                payload, key, ok, self.n_dev, self.slack,
                self.ex.mesh.axis(DATA_AXIS))
        self._overflows.append(n_over)
        new = DCtx(out_ok.shape[0], out_ok)
        vout = iter(outs[len(names):])
        for k, arr, valid in zip(names, outs, valids):
            new.cols[k] = ctx.cols[k].with_arrays(
                arr, None if valid is None else next(vout))
        new.sharded = True
        return new

    def _key_of(self, ctx: DCtx, exprs) -> tuple:
        """Pack a list of key exprs into one int64 per row (bounds
        required beyond the first key), plus validity."""
        vals = [self.eval(e, ctx) for e in exprs]
        ok = ctx.row
        for v in vals:
            ok = _ok(v, ok)
        if len(vals) == 1:
            return vals[0].arr.to(torch.int64), ok
        parts, widths = [], []
        for v in vals:
            lo, hi = v.lo, v.hi
            if v.sdict is not None:
                lo, hi = 0, max(len(v.sdict) - 1, 0)
            if lo is None or hi is None:
                raise DeviceExecError("cannot pack key without bounds")
            parts.append((v.arr, lo, hi))
            widths.append(max((hi - lo).bit_length(), 1))
        if sum(widths) > 62:
            raise DeviceExecError("distributed key too wide")
        return self._pack(parts, widths), ok

    def _gathered_child(self, node: P.Node, child: P.Node) -> None:
        """Stash a sharded child's context gathered whole, for ``node``'s
        single-rank logic."""
        ctx = self.run(child)
        if getattr(ctx, "sharded", False):
            self.stash(child, self._replicate(ctx, child))
        self._cache.pop(id(node), None)

    # ---------------------------------------------------------- plan nodes

    def _run_scan(self, node: P.Scan) -> DCtx:
        if (not self.ex._is_sharded(node.table)
                or self.ex.scan_view(node) is not None):
            # a replicated table, or a sharded one whose filtered
            # survivors broadcast as a reduced replicated view
            ctx = super()._run_scan(node)
            ctx.sharded = False
            return ctx
        t = self.ex.tables[node.table]
        local = shard_rows(t.nrows, self.n_dev)
        gidx = self.ex.rank * local + self._arange(local, torch.int64)
        row = gidx < t.nrows
        live = self.ex.live_buffer(node.table)
        if live is not None:
            # delta deleted-row bitmask (this rank's slice, padded
            # False): deleted rows leave the shard's row population
            row = row & live
        ctx = DCtx(local, row)
        ctx.sharded = True
        for name, _dt in node.output:
            col = t.columns[name]
            key, bufs = self.ex.scan_buffers(node.table, name)
            lo, hi = self.ex.col_bounds(node.table, name)
            sdict = col.dictionary if col.is_string else None
            ctx.cols[(node.binding, name)] = DVal(
                bufs[key], bufs.get(key + "#v"), sdict, lo, hi)
        for pred in node.filters:
            ctx = self._apply_filter(ctx, pred)
            ctx.sharded = True
        return ctx

    def _run_derivedscan(self, node: P.DerivedScan) -> DCtx:
        ctx = super()._run_derivedscan(node)
        ctx.sharded = getattr(self.run(node.child), "sharded", False)
        return ctx

    def _run_stagedscan(self, node: P.StagedScan) -> DCtx:
        # a staged temp table at or above the threshold shards like any
        # other: its rows stay this rank's shard
        ctx = super()._run_stagedscan(node)
        ctx.sharded = getattr(self.run(node.child), "sharded", False)
        return ctx

    def _run_filter(self, node: P.Filter) -> DCtx:
        child = self.run(node.child)
        ctx = self._apply_filter(child, node.predicate)
        ctx.sharded = getattr(child, "sharded", False)
        return ctx

    def _run_project(self, node: P.Project) -> DCtx:
        child = self.run(node.child)
        ctx = super()._run_project(node)
        ctx.sharded = getattr(child, "sharded", False)
        return ctx

    def _colocate(self, node: P.Join, lctx: DCtx, rctx: DCtx) -> tuple:
        """Both sides of a join exchanged by join key, with keys packed
        pair-aligned (identical logical keys must hash alike). NULL-key
        left rows of a left join travel too, routed by key 0, so that
        they null-extend."""
        lkey, lok, rkey, rok, _span = self._join_key_arrays(
            [self.eval(k, lctx) for k in node.left_keys],
            [self.eval(k, rctx) for k in node.right_keys], lctx, rctx)
        if node.kind == "left":
            lkey = torch.where(lok, lkey, torch.zeros((), dtype=lkey.dtype,
                                                      device=self.dev))
            lctx = self._exchange_ctx(lctx, lkey, lctx.row, node.left)
        else:
            lctx = self._exchange_ctx(lctx, lkey, lok, node.left)
        return lctx, self._exchange_ctx(rctx, rkey, rok, node.right)

    def _run_join(self, node: P.Join) -> DCtx:
        lctx, rctx = self.run(node.left), self.run(node.right)
        ls = getattr(lctx, "sharded", False)
        rs = getattr(rctx, "sharded", False)
        if not node.left_keys:
            return self._cross_replicated(node, lctx, rctx, ls, rs)
        if node.right_unique:
            probe_sharded = ls
            if rs and ls:
                lctx, rctx = self._colocate(node, lctx, rctx)
            elif rs:
                rctx = self._replicate(rctx, node.right)
            out = self._join_cached(node, lctx, rctx)
            out.sharded = probe_sharded
            return out
        # probe side is the right: the left must be visible in full
        if ls and rs:
            # after the exchange every match is rank-local and the
            # exchanged shards are disjoint, so the local expanding join
            # (a left join's unmatched block included) is exact
            lctx, rctx = self._colocate(node, lctx, rctx)
            out = self._join_cached(node, lctx, rctx)
            out.sharded = True
            return out
        if ls:
            lctx = self._replicate(lctx, node.left)
        if rs and node.kind == "left":
            # a replicated left against a sharded right would null-extend
            # a left row matched on another rank: gather the right too
            rctx = self._replicate(rctx, node.right)
            rs = False
        out = self._join_cached(node, lctx, rctx)
        out.sharded = rs
        return out

    def _join_cached(self, node, lctx, rctx):
        """The single-rank join on prepared child contexts."""
        self.stash(node.left, lctx)
        self.stash(node.right, rctx)
        self._cache.pop(id(node), None)
        return super()._run_join(node)

    def _cross_replicated(self, node, lctx, rctx, ls, rs):
        lctx = self._replicate(lctx, node.left) if ls else lctx
        rctx = self._replicate(rctx, node.right) if rs else rctx
        self.stash(node.left, lctx)
        self.stash(node.right, rctx)
        out = self._cross_join(node, lctx, rctx)
        out.sharded = False
        return out

    def _run_semijoin(self, node: P.SemiJoin) -> DCtx:
        lctx, rctx = self.run(node.left), self.run(node.right)
        ls = getattr(lctx, "sharded", False)
        if getattr(rctx, "sharded", False):
            rctx = self._replicate(rctx, node.right)
        self.stash(node.left, lctx)
        self.stash(node.right, rctx)
        self._cache.pop(id(node), None)
        out = super()._run_semijoin(node)
        out.sharded = ls
        return out

    def _run_aggregate(self, node: P.Aggregate) -> DCtx:
        ctx = self.run(node.child)
        if not getattr(ctx, "sharded", False):
            out = super()._run_aggregate(node)
            out.sharded = False
            return out
        if not node.group_keys:
            return self._global_agg_sharded(node, ctx)
        # repartition by group key so that each group is wholly local:
        # the single-rank aggregate is then exact (distinct, avg too)
        try:
            key, _kok = self._key_of(ctx, [e for _, e in node.group_keys])
        except DeviceExecError:
            self._gathered_child(node, node.child)
            out = super()._run_aggregate(node)
            out.sharded = False
            return out
        # NULL group keys route by their (masked) value with the row
        self.stash(node.child,
                   self._exchange_ctx(ctx, key, ctx.row, node.child))
        self._cache.pop(id(node), None)
        out = super()._run_aggregate(node)
        out.sharded = True
        return out

    def _global_agg_sharded(self, node: P.Aggregate, ctx: DCtx) -> DCtx:
        if any(spec.distinct for _, spec in node.aggs):
            self._gathered_child(node, node.child)
            out = super()._run_aggregate(node)
            out.sharded = False
            return out
        out = DCtx(1, self._ones_bool(1))
        out.sharded = False
        for name, spec in node.aggs:
            arr, valid, sdict = self._psum_agg(spec, ctx)
            out.cols[(node.binding, name)] = DVal(arr, valid, sdict)
        return out

    def _psum_agg(self, spec: P.AggSpec, ctx: DCtx):
        reduce = self.world.all_reduce
        dv = None if spec.arg is None else self.eval(spec.arg, ctx)
        if spec.func == "count" and dv is None:
            cnt = reduce(ctx.row.sum(), "sum")
            return cnt.reshape(1).to(torch.int64), self._ones_bool(1), None
        w = _ok(dv, ctx.row)
        cnt = reduce(w.sum(), "sum")
        valid = (cnt > 0).reshape(1)
        if spec.func == "count":
            return cnt.reshape(1).to(torch.int64), self._ones_bool(1), None
        if spec.func == "sum":
            if isinstance(spec.dtype, FloatType):
                s = torch.where(w, dv.arr.to(self.fdt),
                                torch.zeros((), dtype=self.fdt,
                                            device=self.dev)).sum()
            else:
                s = torch.where(w, dv.arr.to(torch.int64),
                                torch.zeros((), dtype=torch.int64,
                                            device=self.dev)).sum()
            return reduce(s, "sum").reshape(1), valid, None
        if spec.func == "avg":
            f = _to_float(dv.arr, spec.arg.dtype, self.fdt)
            s = reduce(torch.where(w, f, torch.zeros((), dtype=self.fdt,
                                                     device=self.dev)).sum(),
                       "sum")
            return (s / cnt.clamp_min(1)).reshape(1), valid, None
        if spec.func in ("min", "max"):
            if dv.arr.dtype.is_floating_point:
                fill = float("inf") if spec.func == "min" else float("-inf")
                masked = torch.where(w, dv.arr, torch.full_like(dv.arr, fill))
            else:
                fill = dx.I64_MAX if spec.func == "min" else dx.I64_MIN
                a64 = dv.arr.to(torch.int64)
                masked = torch.where(w, a64, torch.full_like(a64, fill))
            red = masked.min() if spec.func == "min" else masked.max()
            return reduce(red, spec.func).reshape(1), valid, dv.sdict
        raise DeviceExecError(spec.func)

    def _run_sort(self, node: P.Sort) -> DCtx:
        self._gathered_child(node, node.child)
        out = super()._run_sort(node)
        out.sharded = False
        return out

    def _run_limit(self, node: P.Limit) -> DCtx:
        self._gathered_child(node, node.child)
        out = super()._run_limit(node)
        out.sharded = False
        return out

    def _run_distinct(self, node: P.Distinct) -> DCtx:
        self._gathered_child(node, node.child)
        out = super()._run_distinct(node)
        out.sharded = False
        return out

    def _run_setop(self, node: P.SetOp) -> DCtx:
        for side in (node.left, node.right):
            self._gathered_child(node, side)
        out = super()._run_setop(node)
        out.sharded = False
        return out

    def _run_window(self, node: P.Window) -> DCtx:
        # windows run on small post-aggregation relations: gathered
        self._gathered_child(node, node.child)
        out = super()._run_window(node)
        out.sharded = False
        return out

    def result_ctx(self, node: P.Node) -> DCtx:
        ctx = self._replicate(self.run(node), node)
        self.stash(node, ctx)
        return ctx

    def run_query(self, planned: P.PlannedQuery):
        self._need = needed_above(planned)
        return super().run_query(planned)


def make_distributed_factory(mesh=None, n_devices=None, shard_tables=None,
                             shard_threshold=DEFAULT_SHARD_THRESHOLD,
                             slack: float = 2.0, device=None):
    """Session executor factory for the distributed engine: one
    ``DistributedExecutor`` per table registry, over ``mesh`` (by default
    the 1-D mesh of the initialized world, which must hold ``n_devices``
    ranks; with no world and ``n_devices`` in (None, 1), a world of one).
    ``device=None`` is the card and raises where there is none, before
    any world starts; the CPU must be asked for (``device="cpu"``, gloo)."""
    from nds_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    if mesh is None:
        mesh = make_mesh(n_devices, device=dev)
    holder: dict = {}

    def factory(tables):
        ex = holder.get("ex")
        if ex is None or ex.tables is not tables:
            ex = DistributedExecutor(
                tables, mesh=mesh, shard_tables=shard_tables,
                shard_threshold=shard_threshold, slack=slack, device=dev)
            holder["ex"] = ex
        return ex

    # DML invalidation hooks (Session.invalidate): the wholesale one drops
    # the executor; the scoped one keeps it and drops only the mutated
    # tables' device state and the graphs that read it
    factory.invalidate = holder.clear

    def invalidate_tables(names):
        ex = holder.get("ex")
        if ex is not None:
            ex.invalidate_tables(names)

    factory.invalidate_tables = invalidate_tables
    factory.device = dev
    return factory
