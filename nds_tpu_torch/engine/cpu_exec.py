"""CPU oracle executor: interprets logical plans with numpy/pandas.

Port copy of ``nds_tpu/engine/cpu_exec.py``: it imports nothing of
``nds_tpu``. The memwatch hook and the parameter inlining are trimmed;
``execute`` fires the ``device.execute`` fault point and beats the
watchdog, as the reference's does.

Role: the differential-validation ground truth. The reference's oracle is
the same workload run on CPU Spark, compared row-by-row with epsilon
(`nds/nds_validate.py:48-114`); here the oracle is an independent
interpretation of the same logical plan — separate code path from the
device engine (no jax, no static shapes, no dictionary tricks for
evaluation: strings are materialized), so engine bugs don't cancel out.

Decimals stay scaled int64 through +,-,* and comparisons (exact); division
and AVG go through float64, matching the IR type policy.
"""

from __future__ import annotations

import re

import numpy as np
import pandas as pd

from nds_tpu_torch.engine.types import (
    DateType, DecimalType, DType, FloatType, IntType, StringType,
)
from nds_tpu_torch.io.host_table import HostTable
from nds_tpu_torch.resilience import faults, watchdog
from nds_tpu_torch.sql import ir
from nds_tpu_torch.sql import plan as P


class ExecError(RuntimeError):
    pass


class Context:
    """One relation's materialized columns keyed by (binding, name)."""

    def __init__(self, nrows: int):
        self.nrows = nrows
        self.cols: dict[tuple, np.ndarray] = {}
        self.valid: dict[tuple, np.ndarray | None] = {}

    def put(self, key, arr, valid=None):
        self.cols[key] = arr
        self.valid[key] = valid

    def take(self, idx: np.ndarray, matched: np.ndarray | None = None,
             only_bindings: set | None = None) -> "Context":
        out = Context(len(idx))
        for k, v in self.cols.items():
            if only_bindings is not None and k[0] not in only_bindings:
                continue
            arr = v[idx]
            val = self.valid[k]
            val = val[idx] if val is not None else None
            if matched is not None:
                val = matched if val is None else (val & matched)
            out.put(k, arr, val)
        return out

    def merge(self, other: "Context") -> "Context":
        assert self.nrows == other.nrows
        out = Context(self.nrows)
        out.cols.update(self.cols)
        out.cols.update(other.cols)
        out.valid.update(self.valid)
        out.valid.update(other.valid)
        return out

    def mask(self, m: np.ndarray) -> "Context":
        idx = np.nonzero(m)[0]
        return self.take(idx)


def _scale_of(t: DType) -> int:
    return t.scale if isinstance(t, DecimalType) else 0


def _to_float(arr: np.ndarray, t: DType) -> np.ndarray:
    if isinstance(t, DecimalType):
        return arr.astype(np.float64) / 10**t.scale
    return arr.astype(np.float64)


def _like_to_segments(pattern: str):
    """'%a%b' -> (anchored_start, anchored_end, [segments])."""
    segs = pattern.split("%")
    return (not pattern.startswith("%"), not pattern.endswith("%"),
            [s for s in segs if s])


def like_mask(values: np.ndarray, pattern: str) -> np.ndarray:
    """Vectorized SQL LIKE over a unicode array ('_' not needed by the
    benchmark patterns; falls back to regex if present)."""
    vals = values.astype(str)
    if "_" in pattern:
        rx = re.compile(
            "^" + re.escape(pattern).replace("%", ".*").replace("_", ".")
            + "$", re.DOTALL)
        return np.array([bool(rx.match(v)) for v in vals])
    start_anchor, end_anchor, segs = _like_to_segments(pattern)
    u = np.asarray(vals, dtype=np.str_)
    ok = np.ones(len(u), dtype=bool)
    pos = np.zeros(len(u), dtype=np.int64)
    for i, seg in enumerate(segs):
        if i == 0 and start_anchor:
            found = np.char.startswith(u, seg)
            ok &= found
            pos = np.where(found, len(seg), pos)
        else:
            idx = np.char.find(u, seg)
            # search from current position
            idx2 = np.array([v.find(seg, p) for v, p in zip(vals, pos)])
            found = idx2 >= 0
            ok &= found
            pos = np.where(found, idx2 + len(seg), pos)
    if segs and end_anchor:
        last = segs[-1]
        if len(segs) == 1 and start_anchor:
            ok &= np.char.str_len(u) == len(last)  # exact match
        else:
            ok &= np.char.endswith(u, last)
            # ensure the end match doesn't precede previous segments
    return ok


class CpuExecutor:
    def __init__(self, tables: dict[str, HostTable]):
        self.tables = tables
        self._node_cache: dict[int, Context] = {}
        self.scalars: dict[int, tuple] = {}  # id -> (value, dtype)

    # ----------------------------------------------------------------- API

    def execute(self, planned: P.PlannedQuery):
        # chaos site shared with the device executors: CPU-backend runs
        # exercise the retry and ladder machinery without a card
        faults.fault_point("device.execute", executor="CpuExecutor")
        watchdog.beat("engine", phase="device.execute",
                      executor="CpuExecutor")
        return self._execute_inner(planned)

    def _execute_inner(self, planned: P.PlannedQuery):
        self._node_cache.clear()
        self.scalars.clear()
        for i, sub in enumerate(planned.scalar_subplans):
            ctx = self.run(sub)
            name, dt = sub.output[0]
            arr = ctx.cols[(sub.binding, name)]
            if len(arr) != 1:
                raise ExecError(
                    f"scalar subquery returned {len(arr)} rows")
            valid = ctx.valid[(sub.binding, name)]
            v = None if (valid is not None and not valid[0]) else arr[0]
            self.scalars[i] = (v, dt)
        ctx = self.run(planned.root)
        return self._result(ctx, planned.root, planned.column_names)

    def _result(self, ctx: Context, root: P.Node, names: list[str]):
        b = root.binding
        cols, dtypes = [], []
        for name, dt in root.output:
            arr = ctx.cols[(b, name)]
            cols.append(arr)
            dtypes.append(dt)
        return ResultTable(names, cols, dtypes,
                           [ctx.valid[(b, n)] for n, _ in root.output])

    # --------------------------------------------------------------- nodes

    def run(self, node: P.Node) -> Context:
        nid = id(node)
        if nid in self._node_cache:
            return self._node_cache[nid]
        method = getattr(self, "_run_" + type(node).__name__.lower())
        ctx = method(node)
        # ndslint: waive[NDS101] -- cleared at execute() entry; the running plan pins nodes
        self._node_cache[nid] = ctx
        return ctx

    def _run_scan(self, node: P.Scan) -> Context:
        t = self.tables[node.table]
        ctx = Context(t.nrows)
        for name, _dt in node.output:
            col = t.columns[name]
            arr = col.decode() if col.is_string else col.values
            ctx.put((node.binding, name), np.asarray(arr), col.null_mask)
        from nds_tpu_torch.columnar import delta
        live = delta.live_mask(t)
        if live is not None:
            # delta deleted-row bitmask: DF_*-deleted rows drop out of
            # every scan before any predicate sees them
            ctx = ctx.mask(live)
        for pred in node.filters:
            m, mv = self.eval(pred, ctx)
            m = m.astype(bool)
            if mv is not None:
                m &= mv
            ctx = ctx.mask(m)
        return ctx

    def _run_derivedscan(self, node: P.DerivedScan) -> Context:
        child_ctx = self.run(node.child)
        cb = node.child.binding
        out = Context(child_ctx.nrows)
        for name, _dt in node.child.output:
            out.put((node.binding, name), child_ctx.cols[(cb, name)],
                    child_ctx.valid[(cb, name)])
        return out

    def _run_filter(self, node: P.Filter) -> Context:
        ctx = self.run(node.child)
        m, mv = self.eval(node.predicate, ctx)
        m = m.astype(bool)
        if mv is not None:
            m = m & mv
        return ctx.mask(m)

    def _run_project(self, node: P.Project) -> Context:
        ctx = self.run(node.child)
        out = Context(ctx.nrows)
        for name, e in node.exprs:
            arr, valid = self.eval(e, ctx)
            if np.isscalar(arr) or arr.ndim == 0:
                arr = np.full(ctx.nrows, arr)
            out.put((node.binding, name), arr, valid)
        return out

    def _key_frame(self, ctx: Context, keys: list[ir.IR],
                   side: str = "") -> pd.DataFrame:
        """Join-key frame. NULL keys must never match anything (SQL
        equality semantics; pandas merge would happily pair NaN with
        NaN), so invalid rows get a per-side, per-row unique sentinel."""
        data = {}
        # never-matching sentinel blocks per side, far below any real
        # key domain (keys are sks/dates/codes, all > -2^40)
        base = (np.iinfo(np.int64).min // 4) * (2 if side == "L" else 3)
        for i, k in enumerate(keys):
            arr, valid = self.eval(k, ctx)
            is_obj = (isinstance(arr.dtype, object.__class__)
                      or arr.dtype == object)
            if is_obj:
                arr = arr.astype(str).astype(object)
            if valid is not None and not valid.all():
                bad = np.nonzero(~valid)[0]
                if not is_obj and np.issubdtype(arr.dtype, np.integer):
                    arr = arr.astype(np.int64)
                    arr[bad] = base + bad
                else:
                    arr = arr.astype(object)
                    arr[bad] = [f"__null{side}{j}" for j in bad]
            data[f"k{i}"] = arr
        return pd.DataFrame(data)

    def _run_join(self, node: P.Join) -> Context:
        lctx, rctx = self.run(node.left), self.run(node.right)
        if not node.left_keys:  # cross join
            li = np.repeat(np.arange(lctx.nrows), rctx.nrows)
            ri = np.tile(np.arange(rctx.nrows), lctx.nrows)
            out = lctx.take(li).merge(rctx.take(ri))
            return out
        lk = self._key_frame(lctx, node.left_keys, "L")
        rk = self._key_frame(rctx, node.right_keys, "R")
        lk["_li"] = np.arange(lctx.nrows)
        rk["_ri"] = np.arange(rctx.nrows)
        how = {"left": "left", "full": "outer"}.get(node.kind, "inner")
        m = lk.merge(rk, on=[f"k{i}" for i in range(len(node.left_keys))],
                     how=how)
        if node.kind == "full":
            if node.residual is not None:
                raise ExecError("FULL OUTER residual unsupported")
            lmatched = m["_li"].notna().to_numpy()
            rmatched = m["_ri"].notna().to_numpy()
            li = np.where(lmatched, m["_li"].fillna(0).to_numpy(),
                          0).astype(np.int64)
            ri = np.where(rmatched, m["_ri"].fillna(0).to_numpy(),
                          0).astype(np.int64)
            return lctx.take(li, matched=lmatched).merge(
                rctx.take(ri, matched=rmatched))
        li = m["_li"].to_numpy()
        if node.kind == "left":
            matched = m["_ri"].notna().to_numpy()
            ri = np.where(matched, m["_ri"].fillna(0).to_numpy(), 0).astype(
                np.int64)
            out = lctx.take(li).merge(rctx.take(ri, matched=matched))
            if node.residual is not None:
                rm, rmv = self.eval(node.residual, out)
                rm = rm.astype(bool)
                if rmv is not None:
                    rm &= rmv
                keep_match = matched & rm
                # left join: keep every left row; null out right side where
                # the residual fails, then dedupe to one row per unmatched li
                unmatched_li = np.setdiff1d(li, li[keep_match])
                lidx = np.concatenate([li[keep_match], unmatched_li])
                ridx = np.concatenate(
                    [ri[keep_match], np.zeros(len(unmatched_li), np.int64)])
                mflag = np.concatenate(
                    [np.ones(keep_match.sum(), bool),
                     np.zeros(len(unmatched_li), bool)])
                out = lctx.take(lidx).merge(rctx.take(ridx, matched=mflag))
            return out
        ri = m["_ri"].to_numpy().astype(np.int64)
        out = lctx.take(li).merge(rctx.take(ri))
        if node.residual is not None:
            rm, rmv = self.eval(node.residual, out)
            rm = rm.astype(bool)
            if rmv is not None:
                rm &= rmv
            out = out.mask(rm)
        return out

    def _run_semijoin(self, node: P.SemiJoin) -> Context:
        lctx, rctx = self.run(node.left), self.run(node.right)
        if node.left_keys:
            lk = self._key_frame(lctx, node.left_keys, "L")
            rk = self._key_frame(rctx, node.right_keys, "R")
            lk["_li"] = np.arange(lctx.nrows)
            rk["_ri"] = np.arange(rctx.nrows)
            m = lk.merge(rk, on=[f"k{i}" for i in range(len(node.left_keys))],
                         how="inner")
            li = m["_li"].to_numpy()
            ri = m["_ri"].to_numpy()
        else:
            li = np.repeat(np.arange(lctx.nrows), rctx.nrows)
            ri = np.tile(np.arange(rctx.nrows), lctx.nrows)
        if node.residual is not None:
            combined = lctx.take(li).merge(rctx.take(ri))
            rm, rmv = self.eval(node.residual, combined)
            rm = rm.astype(bool)
            if rmv is not None:
                rm &= rmv
            li = li[rm]
        exists = np.zeros(lctx.nrows, dtype=bool)
        exists[li] = True
        return lctx.mask(~exists if node.anti else exists)

    def _run_aggregate(self, node: P.Aggregate) -> Context:
        ctx = self.run(node.child)
        b = node.binding
        n_keys = len(node.group_keys)
        if n_keys == 0:
            out = Context(1)
            for name, spec in node.aggs:
                v = self._agg_all(spec, ctx)
                if v is None:  # SQL: aggregate over empty input is NULL
                    out.put((b, name), np.zeros(1, dtype=np.int64),
                            np.array([False]))
                else:
                    out.put((b, name), np.array([v]))
            return out
        # SQL GROUP BY: NULL keys form one group and the output key is
        # NULL — grouping must factor in validity, never the raw fill
        # value (ADVICE r1: NULL group corruption)
        keyframes = {}
        keyvals = []
        for i, (kname, kexpr) in enumerate(node.group_keys):
            arr, v = self.eval(kexpr, ctx)
            keyvals.append((arr, v))
            col = arr if arr.dtype != object else arr.astype(str)
            if v is not None:
                fill = col[0] if len(col) else 0
                col = np.where(v, col, fill)
                keyframes[f"k{i}n"] = ~v
            keyframes[f"k{i}"] = col
        df = pd.DataFrame(keyframes)
        if len(df) == 0:
            # this pandas raises on MultiIndex.from_frame of an empty
            # frame; an empty input groups to zero groups either way
            codes, ngroups = np.zeros(0, dtype=np.int64), 0
        else:
            codes, uniques = pd.factorize(
                pd.MultiIndex.from_frame(df) if len(df.columns) > 1
                else df.iloc[:, 0], sort=False)
            ngroups = len(uniques)
        out = Context(ngroups)
        # representative (first-occurrence) row per group for key values
        rev = np.arange(len(codes))[::-1]
        first = np.full(ngroups, -1, dtype=np.int64)
        first[codes[rev]] = rev
        for (kname, _kexpr), (arr, v) in zip(node.group_keys, keyvals):
            out.put((b, kname), arr[first],
                    None if v is None else v[first])
        for name, spec in node.aggs:
            vals, gvalid = self._agg_grouped(spec, ctx, codes, ngroups)
            out.put((b, name), vals, gvalid)
        return out

    def _agg_input(self, spec: P.AggSpec, ctx: Context):
        if spec.arg is None:
            return None, None
        return self.eval(spec.arg, ctx)

    def _agg_all(self, spec: P.AggSpec, ctx: Context):
        arr, valid = self._agg_input(spec, ctx)
        if spec.func == "count":
            if arr is None:
                return ctx.nrows
            n = ctx.nrows if valid is None else int(valid.sum())
            if spec.distinct:
                a = arr if valid is None else arr[valid]
                return len(pd.unique(a))
            return n
        if valid is not None:
            arr = arr[valid]
        if len(arr) == 0:
            return None  # SQL NULL
        if spec.func == "sum":
            return arr.sum()
        if spec.func == "min":
            return arr.min()
        if spec.func == "max":
            return arr.max()
        if spec.func == "avg":
            return _to_float(arr, spec.arg.dtype).mean()
        if spec.func in ("stddev_samp", "stddev"):
            f = _to_float(arr, spec.arg.dtype)
            return np.nan if len(f) < 2 else float(np.std(f, ddof=1))
        raise ExecError(spec.func)

    def _agg_grouped(self, spec: P.AggSpec, ctx: Context,
                     codes: np.ndarray, ngroups: int):
        """-> (values, validity-or-None). A group whose every input is
        NULL aggregates to NULL for sum/min/max/avg (and stddev needs
        two valid rows) — only count stays 0-valued (SQL semantics the
        device engine already implements)."""
        arr, valid = self._agg_input(spec, ctx)
        if spec.func == "count":
            if spec.distinct:
                df = pd.DataFrame({"g": codes, "v": arr.astype(str)
                                   if arr.dtype == object else arr})
                if valid is not None:
                    df = df[valid]
                s = df.groupby("g")["v"].nunique()
                out = np.zeros(ngroups, dtype=np.int64)
                out[s.index.to_numpy()] = s.to_numpy()
                return out, None
            if arr is None:
                return (np.bincount(codes, minlength=ngroups)
                        .astype(np.int64), None)
            m = valid if valid is not None else np.ones(len(arr), bool)
            return (np.bincount(codes[m], minlength=ngroups)
                    .astype(np.int64), None)
        m = valid if valid is not None else None
        vals = arr if m is None else arr[m]
        gcodes = codes if m is None else codes[m]
        nvalid = np.bincount(gcodes, minlength=ngroups)
        gvalid = (None if ngroups and nvalid.min() > 0
                  else nvalid > 0)
        if spec.func == "sum":
            if isinstance(spec.dtype, FloatType):
                return (np.bincount(gcodes,
                                    weights=vals.astype(np.float64),
                                    minlength=ngroups), gvalid)
            # integer/decimal sums accumulate in int64 — exact (the decimal
            # policy this oracle exists to enforce; bincount would round
            # through float64 past 2^53)
            out = np.zeros(ngroups, dtype=np.int64)
            np.add.at(out, gcodes, vals.astype(np.int64))
            return out, gvalid
        if spec.func == "avg":
            f = _to_float(vals, spec.arg.dtype)
            s = np.bincount(gcodes, weights=f, minlength=ngroups)
            c = np.bincount(gcodes, minlength=ngroups)
            with np.errstate(invalid="ignore"):
                return s / np.maximum(c, 1), gvalid
        if spec.func in ("min", "max"):
            df = pd.DataFrame({"g": gcodes, "v": vals})
            s = df.groupby("g")["v"].min() if spec.func == "min" \
                else df.groupby("g")["v"].max()
            out = np.zeros(ngroups, dtype=vals.dtype)
            out[s.index.to_numpy()] = s.to_numpy()
            return out, gvalid
        if spec.func in ("stddev_samp", "stddev"):
            f = _to_float(vals, spec.arg.dtype)
            s = pd.DataFrame({"g": gcodes, "v": f}).groupby("g")["v"].std(
                ddof=1)
            out = np.full(ngroups, np.nan)
            out[s.index.to_numpy()] = s.to_numpy()
            # stddev_samp needs >= 2 valid rows
            two = np.bincount(gcodes, minlength=ngroups) >= 2
            return np.nan_to_num(out), two if not two.all() else None
        raise ExecError(spec.func)

    def _run_window(self, node: P.Window) -> Context:
        """Namespace-extending window evaluation (pandas per spec)."""
        ctx = self.run(node.child)
        out = Context(ctx.nrows)
        out.cols.update(ctx.cols)
        out.valid.update(ctx.valid)
        for name, spec in node.specs:
            arr, valid = self._window_col(spec, ctx)
            out.put((node.binding, name), arr, valid)
        return out

    def _window_col(self, spec: P.WindowSpec, ctx: Context):
        n = ctx.nrows
        # partition codes (validity-aware, like GROUP BY)
        if spec.partition:
            frames = {}
            for i, p in enumerate(spec.partition):
                a, v = self.eval(p, ctx)
                col = a.astype(str) if a.dtype == object else a
                if v is not None:
                    frames[f"p{i}n"] = ~v
                    col = np.where(v, col, col[0] if len(col) else 0)
                frames[f"p{i}"] = col
            pdf = pd.DataFrame(frames)
            if len(pdf) == 0:
                # MultiIndex.from_frame raises on empty frames here
                codes = np.zeros(0, dtype=np.int64)
            else:
                codes, _ = pd.factorize(
                    pd.MultiIndex.from_frame(pdf) if len(pdf.columns) > 1
                    else pdf.iloc[:, 0], sort=False)
        else:
            codes = np.zeros(n, dtype=np.int64)
        # sorted space: partition-major, order-minor (stable); NULL order
        # keys sort per nulls_first (default last), matching the device
        idx = np.arange(n)
        for e, asc, nf in reversed(spec.order):
            a, v = self.eval(e, ctx)
            a2 = a[idx]
            if a2.dtype == object:
                a2 = a2.astype(str)
            key = a2 if asc else _rank_desc(a2)
            idx = idx[np.argsort(key, kind="stable")]
            if v is not None:
                v2 = v[idx]
                rank = np.where(v2, 1, 0) if nf else np.where(v2, 0, 1)
                idx = idx[np.argsort(rank, kind="stable")]
        idx = idx[np.argsort(codes[idx], kind="stable")]
        pc = codes[idx]
        part_start = np.concatenate([[True], pc[1:] != pc[:-1]])
        pos = np.arange(n)
        start_pos = np.maximum.accumulate(np.where(part_start, pos, 0))

        def scatter(res_sorted, valid_sorted=None):
            o = np.empty(n, dtype=np.asarray(res_sorted).dtype)
            o[idx] = res_sorted
            vo = None
            if valid_sorted is not None and not valid_sorted.all():
                vo = np.empty(n, dtype=bool)
                vo[idx] = valid_sorted
            return o, vo

        def order_change(base):
            """OR in order-key (value AND validity) change flags."""
            change = base.copy()
            for e, _asc, _nf in spec.order:
                a, v = self.eval(e, ctx)
                a2 = a[idx]
                if a2.dtype == object:
                    a2 = a2.astype(str)
                if v is not None:
                    v2 = v[idx]
                    a2 = np.where(v2, a2, a2[0] if len(a2) else 0)
                    change |= np.concatenate([[True], v2[1:] != v2[:-1]])
                change |= np.concatenate([[True], a2[1:] != a2[:-1]])
            return change

        if spec.func in ("rank", "dense_rank", "row_number"):
            if spec.func == "row_number":
                return scatter(pos - start_pos + 1)
            change = order_change(part_start)
            if spec.func == "dense_rank":
                c = np.cumsum(change)
                cstart = np.maximum.accumulate(np.where(part_start, c, 0))
                return scatter(c - cstart + 1)
            lastchg = np.maximum.accumulate(np.where(change, pos, 0))
            return scatter(lastchg - start_pos + 1)

        # aggregate windows
        if spec.arg is not None:
            a, v = self.eval(spec.arg, ctx)
            w = np.ones(n, bool) if v is None else v
            vals = a[idx]
            w = w[idx]
        else:  # count(*)
            vals = np.ones(n, dtype=np.int64)
            w = np.ones(n, bool)
        running = bool(spec.order)
        df = pd.DataFrame({"g": pc})
        if spec.func == "count":
            cnt_src = w.astype(np.int64)
            res = (df.assign(v=cnt_src).groupby("g")["v"].cumsum()
                   if running else
                   df.assign(v=cnt_src).groupby("g")["v"].transform("sum"))
            res = res.to_numpy()
            out_valid = None
            cnt = None
        else:
            is_f = vals.dtype.kind == "f"
            fvals = vals.astype(np.float64) if is_f else vals
            if spec.func == "avg":
                fvals = _to_float(vals, spec.arg.dtype)
                is_f = True
            g = df.assign(
                v=np.where(w, fvals, 0 if spec.func in ("sum", "avg")
                           else fvals),
                c=w.astype(np.int64)).groupby("g")
            if running:
                cnt = g["c"].cumsum().to_numpy()
            else:
                cnt = g["c"].transform("sum").to_numpy()
            if spec.func in ("sum", "avg"):
                res = (g["v"].cumsum() if running
                       else g["v"].transform("sum")).to_numpy()
                if spec.func == "avg":
                    with np.errstate(invalid="ignore"):
                        res = res / np.maximum(cnt, 1)
            elif spec.func in ("min", "max"):
                masked = pd.Series(
                    fvals.astype(np.float64)).where(w)
                g2 = pd.DataFrame({"g": pc, "v": masked}).groupby("g")
                if running:
                    res = (g2["v"].cummin() if spec.func == "min"
                           else g2["v"].cummax())
                    # pandas cum* leaves NaN AT null positions instead
                    # of carrying the running extremum forward — ffill
                    # within the partition (SQL: max over rows so far)
                    res = res.groupby(pc).ffill().to_numpy()
                else:
                    res = g2["v"].transform(spec.func).to_numpy()
                res = np.nan_to_num(res)
                if not is_f:
                    res = np.round(res).astype(np.int64)
            else:
                raise ExecError(f"window func {spec.func}")
            out_valid = cnt > 0
        if spec.func == "sum" and not is_f:
            res = np.round(res).astype(np.int64)
        if running and spec.frame is None:
            # SQL default frame with ORDER BY: RANGE ... CURRENT ROW —
            # tie rows (order-key peers) share the value at the peer
            # group's last row
            change = order_change(part_start)
            pg = np.cumsum(change)
            res = pd.DataFrame({"g": pg, "v": res}).groupby(
                "g")["v"].transform("last").to_numpy()
            if out_valid is not None:
                out_valid = pd.DataFrame(
                    {"g": pg, "v": out_valid}).groupby("g")["v"].transform(
                    "last").to_numpy().astype(bool)
        return scatter(res, out_valid)

    def _run_sort(self, node: P.Sort) -> Context:
        ctx = self.run(node.child)
        idx = np.arange(ctx.nrows)
        # stable sort from last key to first; NULL keys per nulls_first
        # (default last), matching the device engine
        for e, asc, nf in reversed(node.keys):
            arr, v = self.eval(e, ctx)
            arr = arr[idx]
            if arr.dtype == object:
                arr = arr.astype(str)
            key = arr if asc else _rank_desc(arr)
            idx = idx[np.argsort(key, kind="stable")]
            if v is not None:
                v2 = v[idx]
                rank = np.where(v2, 1, 0) if nf else np.where(v2, 0, 1)
                idx = idx[np.argsort(rank, kind="stable")]
        return ctx.take(idx)

    def _run_limit(self, node: P.Limit) -> Context:
        ctx = self.run(node.child)
        return ctx.take(np.arange(min(node.count, ctx.nrows)))

    def _run_distinct(self, node: P.Distinct) -> Context:
        ctx = self.run(node.child)
        b = node.binding
        data = {}
        for n, _ in node.output:
            arr = ctx.cols[(b, n)]
            data[n] = arr.astype(str) if arr.dtype == object else arr
            v = ctx.valid[(b, n)]
            if v is not None:  # NULLs compare equal under DISTINCT
                data[n + "#n"] = ~v
                data[n] = np.where(v, data[n], data[n][0] if len(arr) else 0)
        df = pd.DataFrame(data)
        keep = ~df.duplicated().to_numpy()
        return ctx.mask(keep)

    def _setop_frame(self, ctx: Context, node: P.Node) -> pd.DataFrame:
        b = node.binding
        data = {}
        for i, (name, _) in enumerate(node.output):
            arr = ctx.cols[(b, name)]
            v = ctx.valid[(b, name)]
            col = pd.Series(arr.astype(str) if arr.dtype == object else arr)
            if v is not None:
                col = col.mask(~v)
            data[f"c{i}"] = col
        return pd.DataFrame(data)

    def _run_setop(self, node: P.SetOp) -> Context:
        lctx, rctx = self.run(node.left), self.run(node.right)
        lb = node.left.binding
        if node.kind.startswith("union"):
            out = Context(lctx.nrows + rctx.nrows)
            rb = node.right.binding
            for (lname, _), (rname, _) in zip(node.left.output,
                                              node.right.output):
                a = np.concatenate([lctx.cols[(lb, lname)],
                                    rctx.cols[(rb, rname)]])
                lv = lctx.valid[(lb, lname)]
                rv = rctx.valid[(rb, rname)]
                if lv is not None or rv is not None:
                    lv = lv if lv is not None else np.ones(lctx.nrows, bool)
                    rv = rv if rv is not None else np.ones(rctx.nrows, bool)
                    out.put((lb, lname), a, np.concatenate([lv, rv]))
                else:
                    out.put((lb, lname), a)
            return out
        # intersect / except: row-set membership against the right side
        ldf = self._setop_frame(lctx, node.left)
        rdf = self._setop_frame(rctx, node.right)
        rkeys = set(map(tuple, rdf.itertuples(index=False, name=None)))
        in_right = np.array(
            [tuple(row) in rkeys
             for row in ldf.itertuples(index=False, name=None)])
        keep = in_right if node.kind == "intersect" else ~in_right
        return lctx.mask(keep)

    # ---------------------------------------------------------- expressions

    def eval(self, e: ir.IR, ctx: Context):
        """-> (ndarray, valid_mask|None)"""
        if isinstance(e, ir.ColRef):
            return ctx.cols[(e.binding, e.name)], ctx.valid.get(
                (e.binding, e.name))
        if isinstance(e, ir.Lit):
            if e.value is None:  # typed NULL literal: fill value, no valid
                if isinstance(e.dtype, StringType):
                    z = np.full(ctx.nrows, "", dtype=object)
                elif isinstance(e.dtype, FloatType):
                    z = np.zeros(ctx.nrows, dtype=np.float64)
                else:
                    z = np.zeros(ctx.nrows, dtype=np.int64)
                return z, np.zeros(ctx.nrows, dtype=bool)
            return np.full(ctx.nrows, e.value), None
        if isinstance(e, ir.ScalarRef):
            v, _ = self.scalars[e.plan_id]
            if v is None:  # NULL scalar: every comparison fails
                return (np.zeros(ctx.nrows, dtype=np.int64),
                        np.zeros(ctx.nrows, dtype=bool))
            return np.full(ctx.nrows, v), None
        if isinstance(e, ir.Arith):
            return self._eval_arith(e, ctx)
        if isinstance(e, ir.Cmp):
            return self._eval_cmp(e, ctx)
        if isinstance(e, ir.BoolOp):
            arrs = [self.eval(a, ctx) for a in e.args]
            out = arrs[0][0].astype(bool)
            valid = arrs[0][1]
            for a, v in arrs[1:]:
                if e.op == "and":
                    out = out & a.astype(bool)
                else:
                    out = out | a.astype(bool)
                valid = _and_valid(valid, v)
            return out, valid
        if isinstance(e, ir.Not):
            a, v = self.eval(e.operand, ctx)
            return ~a.astype(bool), v
        if isinstance(e, ir.Neg):
            a, v = self.eval(e.operand, ctx)
            return -a, v
        if isinstance(e, ir.CaseIR):
            conds, vals, bvalids = [], [], []
            for c, v in e.whens:
                ca, cv = self.eval(c, ctx)
                va, vv = self.eval(v, ctx)
                conds.append(ca.astype(bool) if cv is None
                             else (ca.astype(bool) & cv))
                vals.append(self._coerce(va, v.dtype, e.dtype))
                bvalids.append(vv)
            if e.else_ is not None:
                ea, ev = self.eval(e.else_, ctx)
                default = self._coerce(ea, e.else_.dtype, e.dtype)
                default_valid = ev
            else:
                # CASE with no ELSE: rows matching no branch are NULL
                if isinstance(e.dtype, FloatType):
                    default = np.zeros(ctx.nrows, dtype=np.float64)
                elif isinstance(e.dtype, StringType):
                    default = np.full(ctx.nrows, "", dtype=object)
                else:
                    default = np.zeros(ctx.nrows, dtype=np.int64)
                default_valid = np.zeros(ctx.nrows, dtype=bool)
            # result validity follows the SELECTED branch's validity
            if default_valid is None and all(v is None for v in bvalids):
                valid = None
            else:
                ones = np.ones(ctx.nrows, dtype=bool)
                valid = ones if default_valid is None else default_valid
                for c, bv in zip(reversed(conds), reversed(bvalids)):
                    valid = np.where(c, ones if bv is None else bv, valid)
            return np.select(conds, vals, default=default), valid
        if isinstance(e, ir.LikeIR):
            a, v = self.eval(e.operand, ctx)
            m = like_mask(a, e.pattern)
            return (~m if e.negated else m), v
        if isinstance(e, ir.InListIR):
            a, v = self.eval(e.operand, ctx)
            vals = e.values
            if isinstance(e.operand.dtype, DecimalType):
                s = e.operand.dtype.scale
                vals = [int(round(float(x) * 10**s)) for x in vals]
            if a.dtype == object:
                a = a.astype(str)
                vals = [str(x) for x in vals]
            m = np.isin(a, np.array(vals))
            return (~m if e.negated else m), v
        if isinstance(e, ir.IsNullIR):
            a, v = self.eval(e.operand, ctx)
            isnull = (np.zeros(len(a), bool) if v is None else ~v)
            return (~isnull if e.negated else isnull), None
        if isinstance(e, ir.ExtractIR):
            a, v = self.eval(e.operand, ctx)
            d = (np.datetime64("1970-01-01", "D")
                 + a.astype(np.int64)).astype("datetime64[D]")
            if e.part == "year":
                out = d.astype("datetime64[Y]").astype(np.int64) + 1970
            elif e.part == "month":
                out = (d.astype("datetime64[M]").astype(np.int64) % 12) + 1
            elif e.part == "day":
                out = (d - d.astype("datetime64[M]")).astype(np.int64) + 1
            else:
                raise ExecError(f"extract {e.part}")
            return out.astype(np.int32), v
        if isinstance(e, ir.StrMapIR):
            a, v = self.eval(e.operand, ctx)
            sa = a.astype(str)
            out = (np.char.upper(sa) if e.op == "upper"
                   else np.char.lower(sa))
            return out.astype(object), v
        if isinstance(e, ir.ConcatIR):
            a, v = self.eval(e.operand, ctx)
            return (np.array([e.prefix + s + e.suffix
                              for s in a.astype(str)], dtype=object), v)
        if isinstance(e, ir.SubstrIR):
            a, v = self.eval(e.operand, ctx)
            sa = a.astype(str)
            if e.start == 1 and e.length is not None:
                return sa.astype(f"<U{e.length}").astype(object), v
            lo = e.start - 1
            hi = None if e.length is None else lo + e.length
            return np.array([s[lo:hi] for s in sa], dtype=object), v
        if isinstance(e, ir.CastIR):
            a, v = self.eval(e.operand, ctx)
            src = e.operand.dtype
            if isinstance(e.dtype, FloatType):
                return _to_float(a, src), v
            if isinstance(e.dtype, IntType):
                if isinstance(src, DecimalType):
                    return (a // 10**src.scale).astype(np.int64), v
                return a.astype(np.int64), v
            if isinstance(e.dtype, StringType):
                return a.astype(str).astype(object), v
            if isinstance(e.dtype, DecimalType):
                s = e.dtype.scale
                if isinstance(src, DecimalType):
                    return _rescale(a, src.scale, s), v
                if isinstance(src, IntType):
                    return a.astype(np.int64) * 10**s, v
                return np.round(a * 10**s).astype(np.int64), v
            raise ExecError(f"cast to {e.dtype}")
        raise ExecError(f"cannot eval {e!r}")

    def _coerce(self, arr, src: DType, dst: DType):
        if repr(src) == repr(dst):
            return arr
        if isinstance(dst, FloatType):
            return _to_float(arr, src)
        if isinstance(dst, DecimalType):
            ss = _scale_of(src)
            return _rescale(np.asarray(arr, dtype=np.int64), ss, dst.scale)
        return arr

    def _eval_arith(self, e: ir.Arith, ctx: Context):
        l, lv = self.eval(e.left, ctx)
        r, rv = self.eval(e.right, ctx)
        valid = _and_valid(lv, rv)
        lt, rt = e.left.dtype, e.right.dtype
        if isinstance(e.dtype, DateType):
            return l + r, valid
        if e.op == "/":
            return _to_float(l, lt) / _to_float(r, rt), valid
        if isinstance(e.dtype, FloatType):
            return _apply(e.op, _to_float(l, lt), _to_float(r, rt)), valid
        if isinstance(e.dtype, DecimalType):
            if e.op == "*":
                return l.astype(np.int64) * r.astype(np.int64), valid
            s = e.dtype.scale
            return _apply(e.op, _rescale(l, _scale_of(lt), s),
                          _rescale(r, _scale_of(rt), s)), valid
        return _apply(e.op, l, r), valid

    def _eval_cmp(self, e: ir.Cmp, ctx: Context):
        l, lv = self.eval(e.left, ctx)
        r, rv = self.eval(e.right, ctx)
        valid = _and_valid(lv, rv)
        lt, rt = e.left.dtype, e.right.dtype
        if isinstance(lt, StringType) or isinstance(rt, StringType):
            l = l.astype(str)
            r = r.astype(str)
        elif isinstance(lt, DecimalType) or isinstance(rt, DecimalType):
            s = max(_scale_of(lt), _scale_of(rt))
            if isinstance(lt, FloatType) or isinstance(rt, FloatType):
                l, r = _to_float(l, lt), _to_float(r, rt)
            else:
                l = _rescale(np.asarray(l, np.int64), _scale_of(lt), s)
                r = _rescale(np.asarray(r, np.int64), _scale_of(rt), s)
        op = {"=": np.equal, "<>": np.not_equal, "<": np.less,
              "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal}
        return op[e.op](l, r), valid


def _apply(op, l, r):
    if op == "+":
        return l + r
    if op == "-":
        return l - r
    if op == "*":
        return l * r
    if op == "%":
        return l % r
    raise ExecError(op)


def _rescale(arr: np.ndarray, from_s: int, to_s: int) -> np.ndarray:
    if from_s == to_s:
        return arr
    if to_s > from_s:
        return arr * 10**(to_s - from_s)
    return arr // 10**(from_s - to_s)


def _and_valid(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def _rank_desc(arr: np.ndarray) -> np.ndarray:
    """Key transform for stable descending sort."""
    if arr.dtype.kind in "iuf":
        return -arr
    # strings: rank by sorted-unique position, negated
    uniq, inv = np.unique(arr, return_inverse=True)
    return -inv


class ResultTable:
    """Final query output: named columns with dtypes; decimals stay scaled
    until formatted."""

    def __init__(self, names, cols, dtypes, valids=None):
        self.names = names
        self.cols = cols
        self.dtypes = dtypes
        self.valids = valids or [None] * len(cols)

    @property
    def nrows(self):
        return len(self.cols[0]) if self.cols else 0

    def to_pandas(self) -> pd.DataFrame:
        # positional build: duplicate output names are legal SQL
        # (q64 selects cs1.syear and cs2.syear)
        series = []
        for name, arr, dt, valid in zip(self.names, self.cols, self.dtypes,
                                        self.valids):
            if isinstance(dt, DecimalType):
                a = arr.astype(np.float64) / 10**dt.scale
            elif isinstance(dt, DateType):
                a = (np.datetime64("1970-01-01", "D")
                     + arr.astype(np.int64)).astype("datetime64[D]")
            else:
                a = arr
            if valid is not None:
                a = pd.array(a)
                a[~valid] = None
            series.append(pd.Series(a))
        df = pd.concat(series, axis=1, ignore_index=True)
        df.columns = self.names
        return df
