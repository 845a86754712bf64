"""Host-staged plan splitting: keep every compiled program small.

The widest TPC-DS plans (q64's 18-relation CTE referenced twice, q72's
11-relation M:N join chain) trace to 25k-55k jaxpr equations in ONE
shard_map program; XLA's compile memory and time grow superlinearly
with program size, and on an 8-device mesh the q64/q72 compiles
exceeded 130 GB host RAM (VERDICT r4 weak #2). On a real pod that bill
moves to the compile service — the program, not the host, is the
problem.

The fix is structural, the same move the reference's engine makes when
Spark materializes a shuffle boundary: CUT the plan at a subtree
boundary, run the subtree as its own program, stage its (compacted)
result on the host as a temp table, and let the remainder scan that
table. Each resulting program is a fraction of the original's
compile cost; a shared CTE body (q64's cross_sales, referenced by both
year channels) is staged ONCE and scanned twice — a runtime win on top
of the compile fix.

Cuts happen at DerivedScan children (CTE/derived-table bodies — single
binding, exact output list) and at Join/SemiJoin inputs (multi-binding:
the staged table carries every column any ancestor references, found by
liveness over `plan.all_exprs` plus the implicit readers). Staging
recurses: an oversized staged subtree is itself split when executed.

Port copy of ``nds_tpu/engine/staging.py``: it imports nothing of
``nds_tpu``, and carries its own copy of the reference's
``cache/fingerprint.plan_digest``, which names the temps. Eager torch
compiles no programs, so the port stages for one reason only: the six
staged NDS statements then run the same sub-plans, with the same
capacities, slack retries and kernel blocks, as the reference.
"""

from __future__ import annotations

from dataclasses import replace as dc_replace

import numpy as np

import dataclasses
import hashlib

from nds_tpu_torch.engine.types import BoolType, DType, Schema
from nds_tpu_torch.io.host_table import HostTable, from_arrays
from nds_tpu_torch.sql import ir
from nds_tpu_torch.sql import plan as P

# subtree weights: cuts only make sense when both halves stay compileable
MIN_CUT_WEIGHT = 6


def canonical(obj) -> str:
    """Deterministic text form of a plan/IR tree (copy of the
    reference's ``cache/fingerprint.canonical``)."""
    if obj is None:
        return "~"
    if isinstance(obj, DType):
        return repr(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        parts = [type(obj).__name__]
        for f in dataclasses.fields(obj):
            parts.append(f"{f.name}={canonical(getattr(obj, f.name))}")
        return "(" + " ".join(parts) + ")"
    if isinstance(obj, (list, tuple)):
        return "[" + ",".join(canonical(x) for x in obj) + "]"
    if isinstance(obj, np.generic):
        return repr(obj.item())
    if isinstance(obj, (str, bytes, bool, int, float)):
        return repr(obj)
    return f"<{type(obj).__name__}:{obj!r}>"


def plan_digest(planned) -> str:
    """Short stable digest of one plan tree (copy of the reference's
    ``cache/fingerprint.plan_digest``): it names the staged temps."""
    return hashlib.sha256(canonical(planned).encode()).hexdigest()[:12]


def stage_temp_name(plan_digest: str, index: int) -> str:
    """Deterministic temp-table name for the index-th cut of a plan.

    The digest (``plan_digest`` of the ORIGINAL plan)
    replaces the old per-executor counter: staged buffer keys embed the
    temp name, so the persistent AOT plan cache can only serve a
    staged main program across processes when identical plans stage
    identically-named temps. Distinct plans yield distinct digests, so
    names stay collision-free within an executor."""
    return f"__stage_{plan_digest}_{index}"


def _uniq_nodes(*roots) -> set:
    seen = set()
    for r in roots:
        for n in P.walk_plan(r):
            seen.add(id(n))
    return seen


def plan_weight(planned: P.PlannedQuery) -> int:
    """Deduplicated plan-node count (shared CTE bodies count once, like
    the trace cache treats them)."""
    return len(_uniq_nodes(planned.root, *planned.scalar_subplans))


def _subtree_weight(node: P.Node) -> int:
    return len(_uniq_nodes(node))


def _col_refs(e) -> "set[tuple[str, str]]":
    return {(x.binding, x.name) for x in ir.walk(e)
            if isinstance(x, ir.ColRef)}


def _exposed(node: P.Node) -> dict:
    """{(binding, name): dtype} the node's runtime context exposes
    upward — mirrors each _run_* method's DCtx construction. This, NOT
    the set of bindings inside the subtree, bounds what a cut can
    stage: bindings are not instance-unique (q14 scans catalog_sales in
    three separate channel subtrees), so outside references must be
    intersected with the cut root's actual exposure."""
    if isinstance(node, P.StagedScan):
        return {(b, n): dt for b, n, _m, dt in node.cols}
    if isinstance(node, (P.Scan, P.DerivedScan, P.Project, P.Aggregate,
                         P.Distinct)):
        return {(node.binding, n): dt for n, dt in node.output}
    if isinstance(node, P.Join):
        d = _exposed(node.left)
        d.update(_exposed(node.right))
        return d
    if isinstance(node, (P.SemiJoin, P.SetOp)):
        return _exposed(node.left)
    if isinstance(node, P.Window):
        d = _exposed(node.child)
        d.update({(node.binding, n): s.dtype for n, s in node.specs})
        return d
    return _exposed(node.child)  # Filter / Sort / Limit passthrough


def _live_cols(planned: P.PlannedQuery, cut: P.Node) -> list:
    """(binding, name, dtype) triples ancestors read from the cut
    subtree: explicit ColRefs in every node OUTSIDE the subtree plus
    implicit whole-output readers (DerivedScan/Distinct/SetOp over the
    cut), intersected with what the cut's root context exposes."""
    if planned.root is cut:
        raise ValueError("cut may not be the plan root")
    inside = _uniq_nodes(cut)
    exposed = _exposed(cut)
    refs = set()

    def note(b, name):
        if (b, name) in exposed:
            refs.add((b, name))

    roots = [planned.root] + list(planned.scalar_subplans)
    for root in roots:
        if id(root) in inside:
            continue
        for node in P.walk_plan(root):
            if id(node) in inside:
                continue
            for e in P.all_exprs(node):
                for b, name in _col_refs(e):
                    note(b, name)
            # implicit whole-output readers
            if isinstance(node, P.DerivedScan) and node.child is cut:
                for name, _dt in cut.output:
                    note(cut.binding, name)
            elif isinstance(node, P.Distinct) and node.child is cut:
                for name, _dt in node.output:
                    note(node.binding, name)
            elif isinstance(node, P.SetOp):
                for side in (node.left, node.right):
                    if side is cut:
                        for name, _dt in side.output:
                            note(side.binding, name)
    # run_query reads the plan root's output columns; when the cut sits
    # under a passthrough root (Limit/Sort/Filter) those come from the
    # cut's exposure
    for name, _dt in planned.root.output:
        note(planned.root.binding, name)
    return sorted((b, n, exposed[(b, n)]) for b, n in refs)


def _candidates(planned: P.PlannedQuery):
    """Cut candidates: DerivedScan children and Join/SemiJoin inputs.
    DerivedScan children come first so ties prefer the clean
    single-binding boundary (and shared CTE bodies dedupe)."""
    derived, joins = [], []
    seen = set()
    for node in P.walk_plan(planned.root):
        if isinstance(node, P.DerivedScan):
            c = node.child
            if id(c) not in seen and not isinstance(c, P.StagedScan):
                seen.add(id(c))
                derived.append(c)
        elif isinstance(node, (P.Join, P.SemiJoin)):
            for c in (node.left, node.right):
                if id(c) not in seen and not isinstance(c, P.StagedScan):
                    seen.add(id(c))
                    joins.append(c)
    return derived + joins


def choose_cut(planned: P.PlannedQuery):
    """The candidate whose weight is closest to half the plan's —
    balanced halves minimize the larger program. None when no cut can
    make progress."""
    total = plan_weight(planned)
    best, best_score = None, None
    for i, cand in enumerate(_candidates(planned)):
        w = _subtree_weight(cand)
        if w < MIN_CUT_WEIGHT or w > total - 4:
            continue
        score = (abs(w - total / 2), i)
        if best_score is None or score < best_score:
            best, best_score = cand, score
    return best


def _mangle(b: str, name: str) -> str:
    return f"{b}__{name}"


def build_stage(planned: P.PlannedQuery, cut: P.Node, temp_name: str):
    """(sub_planned, staged_main_planned).

    sub_planned projects the cut subtree's live columns under mangled
    names; the main plan gets every reference to `cut` replaced by a
    StagedScan of `temp_name` that restores original (binding, name)
    addresses. Scalar subplans are carried into the sub program so
    ScalarRef indices keep their meaning."""
    live = _live_cols(planned, cut)
    if not live:
        raise ValueError("cut subtree has no live outputs")
    exprs = [(_mangle(b, n), ir.ColRef(b, n, dtype=dt))
             for b, n, dt in live]
    sub_root = P.Project(child=cut, exprs=exprs, binding="__stage_out")
    sub = P.PlannedQuery(
        root=sub_root,
        scalar_subplans=list(planned.scalar_subplans),
        column_names=[n for n, _ in exprs])

    scan = P.Scan(table=temp_name, binding=f"__{temp_name}",
                  output=[(_mangle(b, n), dt) for b, n, dt in live])
    staged = P.StagedScan(
        child=scan,
        cols=[(b, n, _mangle(b, n), dt) for b, n, dt in live],
        binding=cut.binding,
        output=list(cut.output))

    main_root = _replace(planned.root, cut, staged, {})
    main = P.PlannedQuery(root=main_root,
                          scalar_subplans=list(planned.scalar_subplans),
                          column_names=list(planned.column_names))
    return sub, main


def _replace(node: P.Node, cut: P.Node, repl: P.Node, memo: dict):
    """Copy-on-write subtree replacement: rebuild only the spine above
    `cut`; untouched subtrees (and shared references) stay shared."""
    if node is cut:
        return repl
    nid = id(node)
    if nid in memo:
        return memo[nid]
    changed = {}
    for attr in ("child", "left", "right"):
        c = getattr(node, attr, None)
        if isinstance(c, P.Node):
            r = _replace(c, cut, repl, memo)
            if r is not c:
                changed[attr] = r
    out = dc_replace(node, **changed) if changed else node
    # ndslint: waive[NDS101] -- memo lives for one _replace() pass over a live plan
    memo[nid] = out
    return out


def result_to_host_table(name: str, rt) -> HostTable:
    """Lossless ResultTable -> HostTable: decimals stay scaled int64,
    dates stay epoch days, strings re-dictionary-encode, null masks
    carry over."""
    fields, arrays = [], {}
    for cname, arr, dt, valid in zip(rt.names, rt.cols, rt.dtypes,
                                     rt.valids):
        dt = dt if dt is not None else BoolType()
        fields.append((cname, dt, valid is not None))
        arrays[cname] = np.asarray(arr)
        if valid is not None:
            arrays[cname + "#null"] = np.asarray(valid, dtype=bool)
    return from_arrays(name, Schema.of(*fields), arrays)
