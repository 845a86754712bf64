"""AST -> logical plan: name resolution, subquery decorrelation, join
ordering, aggregate planning.

Port copy of ``nds_tpu/sql/planner.py``: it imports nothing of ``nds_tpu``. Kernel stamps come from the port's ``engine.kernels``; the tracer/metrics hooks and the literal-parameterization branch (off by default) are trimmed.

The reference leans on Spark Catalyst for all of this; here it is explicit
and tuned to the decision-support shape (SURVEY.md §7): closed-world
queries, star-schema joins, correlated subqueries of the classic TPC
patterns. Decorrelation rules:

- EXISTS / NOT EXISTS     -> SemiJoin/AntiJoin on extracted equi-pairs,
                             other correlated predicates become the join
                             residual (q4, q21, q22)
- expr IN (subquery)      -> SemiJoin on (expr = subquery column) (q18,
                             q20); NOT IN -> anti (q16)
- cmp with correlated
  scalar agg subquery     -> inner Aggregate grouped by correlation keys,
                             joined into the outer join graph; the
                             comparison becomes an ordinary predicate
                             (q2, q17, q20)
- uncorrelated scalar     -> planned separately, bound as ScalarRef at
                             execution (q11, q15, q22)

Common-conjunct hoisting across OR branches recovers the join key from
q19's disjunctive form.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass, field

from nds_tpu_torch.engine.types import (
    BOOL, DATE, FLOAT64, INT32, INT64, DType, DecimalType, FloatType,
    IntType, Schema, StringType, DateType,
)
from nds_tpu_torch.sql import ast, ir
from nds_tpu_torch.sql import plan as P

AGG_FUNCS = {"sum", "avg", "min", "max", "count", "stddev_samp",
             "stddev"}
WINDOW_RANK_FUNCS = {"rank", "dense_rank", "row_number"}

_EPOCH = datetime.date(1970, 1, 1)


DUP_MARK = "#dup"  # internal suffix disambiguating repeated output names


def _dedupe_out_names(pairs: list) -> list:
    """Projection output names must be unique: executor contexts key
    columns by (binding, name), so q64's unaliased `cs1.syear ...
    cs2.syear` select list would silently collapse both outputs onto
    whichever column lands last. Internal names get a #dup suffix ('#'
    cannot appear in a SQL identifier); result display names strip it
    (`_display_name`), keeping the positional ResultTable contract."""
    seen: dict = {}
    out = []
    for n, e in pairs:
        c = seen.get(n, 0)
        seen[n] = c + 1
        out.append((n if c == 0 else f"{n}{DUP_MARK}{c}", e))
    return out


def _display_name(n: str) -> str:
    return n.split(DUP_MARK)[0]


class PlanError(ValueError):
    pass


@dataclass
class CatalogInfo:
    """Schemas plus the planner statistics (PKs for join-strategy choice,
    relative sizes for greedy join ordering)."""
    schemas: dict                      # table -> Schema
    primary_keys: dict = field(default_factory=dict)
    sizes: dict = field(default_factory=dict)   # table -> relative row weight

    def has_table(self, name: str) -> bool:
        return name in self.schemas


def _date_to_days(iso: str) -> int:
    y, m, d = (int(x) for x in iso.split("-"))
    return (datetime.date(y, m, d) - _EPOCH).days


def _add_months(days: int, months: int) -> int:
    d = _EPOCH + datetime.timedelta(days=days)
    total = d.year * 12 + (d.month - 1) + months
    y, m = divmod(total, 12)
    # TPC dates are always day-of-month-safe (day 1 or mid-month)
    return (datetime.date(y, m + 1, d.day) - _EPOCH).days


@dataclass
class Relation:
    binding: str
    node: P.Node
    columns: dict            # name -> DType
    size: float = 1.0        # selectivity-discounted (join ordering)
    unique_on: tuple = ()    # column names this relation is unique on
    phys_size: float = None  # undiscounted row capacity (probe choice)

    def __post_init__(self):
        if self.phys_size is None:
            self.phys_size = self.size


class Scope:
    """One select's name-resolution scope, chained to outer scopes."""

    def __init__(self, parent: "Scope | None" = None):
        self.parent = parent
        self.relations: dict[str, Relation] = {}

    def add(self, rel: Relation):
        if rel.binding in self.relations:
            raise PlanError(f"duplicate binding {rel.binding!r}")
        self.relations[rel.binding] = rel

    def resolve(self, col: ast.Column):
        """-> (ColRef, depth) where depth 0 = local, >0 = correlated."""
        depth = 0
        scope = self
        while scope is not None:
            if col.table:
                rel = scope.relations.get(col.table)
                if rel is not None and col.name in rel.columns:
                    return ir.ColRef(rel.binding, col.name,
                                     rel.columns[col.name]), depth
            else:
                hits = [r for r in scope.relations.values()
                        if col.name in r.columns]
                if len(hits) > 1:
                    raise PlanError(f"ambiguous column {col.name!r}")
                if hits:
                    r = hits[0]
                    return ir.ColRef(r.binding, col.name,
                                     r.columns[col.name]), depth
            scope = scope.parent
            depth += 1
        raise PlanError(f"cannot resolve column {col!r}")


def _flatten_and(e: ast.Expr) -> list[ast.Expr]:
    if isinstance(e, ast.BinOp) and e.op == "and":
        return _flatten_and(e.left) + _flatten_and(e.right)
    return [e]


def _flatten_or(e: ast.Expr) -> list[ast.Expr]:
    if isinstance(e, ast.BinOp) and e.op == "or":
        return _flatten_or(e.left) + _flatten_or(e.right)
    return [e]


def _hoist_common_disjuncts(conjuncts: list[ast.Expr]) -> list[ast.Expr]:
    """(A and X) or (A and Y) -> A and (X or Y). Recovers q19's join key."""
    out: list[ast.Expr] = []
    for c in conjuncts:
        branches = _flatten_or(c)
        if len(branches) < 2:
            out.append(c)
            continue
        branch_sets = [_flatten_and(b) for b in branches]
        common_reprs = set(repr(x) for x in branch_sets[0])
        for bs in branch_sets[1:]:
            common_reprs &= set(repr(x) for x in bs)
        if not common_reprs:
            out.append(c)
            continue
        for x in branch_sets[0]:
            if repr(x) in common_reprs:
                out.append(x)
        rests = []
        for bs in branch_sets:
            rest = [x for x in bs if repr(x) not in common_reprs]
            if not rest:
                rests = []
                break
            acc = rest[0]
            for x in rest[1:]:
                acc = ast.BinOp("and", acc, x)
            rests.append(acc)
        if rests:
            acc = rests[0]
            for x in rests[1:]:
                acc = ast.BinOp("or", acc, x)
            out.append(acc)
    return out


class Planner:
    def __init__(self, catalog: CatalogInfo, views: dict | None = None):
        self.catalog = catalog
        self.views = views if views is not None else {}
        self.scalar_subplans: list[P.Node] = []
        self._binding_counter = 0
        self._views_stack: list[dict] = [{}]

    # ---------------------------------------------------------------- API

    def plan_statement(self, stmt) -> "P.PlannedQuery | tuple":
        """Select -> PlannedQuery; CreateView/DropView -> ('view', ...) action
        the session applies (q15 flow, `nds-h/nds_h_power.py:78-82`)."""
        return self._plan_statement(stmt)

    def _plan_statement(self, stmt) -> "P.PlannedQuery | tuple":
        if isinstance(stmt, ast.CreateView):
            q = self.plan_select(stmt.query, None, {})
            node = q if isinstance(q, P.Node) else q
            if stmt.columns:
                node = self._rename_outputs(node, stmt.columns)
            return ("create_view", stmt.name, node)
        if isinstance(stmt, ast.DropView):
            return ("drop_view", stmt.name,
                    "if_exists" if stmt.if_exists else None)
        if isinstance(stmt, ast.Insert):
            if not self.catalog.has_table(stmt.table):
                raise PlanError(f"unknown insert target {stmt.table!r}")
            root = self.plan_select(stmt.query, None, {})
            target = self.catalog.schemas[stmt.table]
            if len(root.output) != len(target.fields):
                raise PlanError(
                    f"INSERT into {stmt.table}: select produces "
                    f"{len(root.output)} columns, table has "
                    f"{len(target.fields)}")
            names = [_display_name(n) for n, _ in root.output]
            return ("insert", stmt.table, self._annotated(
                P.PlannedQuery(root, self.scalar_subplans, names)))
        if isinstance(stmt, ast.Delete):
            if not self.catalog.has_table(stmt.table):
                raise PlanError(f"unknown delete target {stmt.table!r}")
            return ("delete", stmt.table, stmt.where)
        root = self.plan_select(stmt, None, {})
        names = [_display_name(n) for n, _ in root.output]
        return self._annotated(
            P.PlannedQuery(root, self.scalar_subplans, names))

    def _annotated(self, planned: P.PlannedQuery) -> P.PlannedQuery:
        """Stamp per-node kernel choices (engine/kernels.py) from the
        catalog's size statistics — the same stats the greedy join
        ordering and the scheduler cost model read. The choice lives on
        the plan nodes, so the AOT fingerprint distinguishes it and the
        executors never re-decide per trace."""
        from nds_tpu_torch.engine import kernels
        kernels.annotate(planned, catalog=self.catalog)
        return planned

    # ----------------------------------------------------------- helpers

    def _fresh(self, prefix: str) -> str:
        self._binding_counter += 1
        return f"_{prefix}{self._binding_counter}"

    def _rename_outputs(self, node: P.Node, names: list[str]) -> P.Node:
        out = node.output
        if len(names) != len(out):
            raise PlanError("view column list length mismatch")
        b = self._fresh("v")
        exprs = [(new, ir.ColRef(node.binding, old, t))
                 for new, (old, t) in zip(names, out)]
        return P.Project(node, exprs, b)

    def _table_relation(self, name: str, binding: str,
                        local_views: dict) -> Relation:
        if name in local_views:
            node = local_views[name]
            return self._derived_relation(node, binding)
        if name in self.views:
            node = self.views[name]
            return self._derived_relation(node, binding)
        if not self.catalog.has_table(name):
            raise PlanError(f"unknown table {name!r}")
        schema: Schema = self.catalog.schemas[name]
        scan = P.Scan(name, binding,
                      [(f.name, f.dtype) for f in schema.fields])
        cols = {f.name: f.dtype for f in schema.fields}
        return Relation(binding, scan, cols,
                        size=self.catalog.sizes.get(name, 1000.0),
                        unique_on=tuple(self.catalog.primary_keys.get(name, ())))

    def _derived_relation(self, node: P.Node, binding: str) -> Relation:
        ds = P.DerivedScan(node, binding,
                           [(n, t) for n, t in node.output])
        cols = {n: t for n, t in node.output}
        return Relation(binding, ds, cols, size=10_000.0,
                        unique_on=_unique_key_of(node))

    # ------------------------------------------------------- main planning

    def plan_select(self, sel: ast.Select, outer: "Scope | None",
                    outer_views: dict) -> P.Node:
        local_views = dict(outer_views)
        for name, cte in sel.ctes.items():
            local_views[name] = self.plan_select(cte, outer, local_views)

        node = self._plan_core(sel, outer, local_views)

        for op, rhs in sel.set_ops:
            rnode = self._plan_core(rhs, outer, local_views)
            node = P.SetOp(op, node, rnode)
            if op in ("union", "intersect", "except"):
                node = P.Distinct(node)

        if sel.set_ops and (sel.order_by or sel.limit is not None):
            # over a set-op result, order keys can only name output columns
            node = self._plan_order_limit(node, sel)
        return node

    def _plan_order_limit(self, node: P.Node, sel: ast.Select) -> P.Node:
        # order keys resolve against the projected output by name
        if sel.order_by:
            scope = Scope()
            scope.add(Relation(node.binding, node,
                               {n: t for n, t in node.output}))
            keys = []
            for item in sel.order_by:
                e, depth = self._lower(item.expr, scope, allow_agg=False)
                keys.append((e, item.ascending, item.nulls_first))
            node = P.Sort(node, keys)
        if sel.limit is not None:
            node = P.Limit(node, sel.limit)
        return node

    def _plan_core(self, sel: ast.Select, outer: "Scope | None",
                   local_views: dict) -> P.Node:
        self._views_stack.append(local_views)
        try:
            return self._plan_core_inner(sel, outer, local_views)
        finally:
            self._views_stack.pop()

    def _plan_core_inner(self, sel: ast.Select, outer: "Scope | None",
                         local_views: dict) -> P.Node:
        scope = Scope(outer)
        ordered_rels: list[Relation] = []

        def add_source(src) -> Relation:
            if isinstance(src, ast.TableRef):
                rel = self._table_relation(src.name, src.binding, local_views)
            else:
                inner = self.plan_select(src.query, outer, local_views)
                rel = self._derived_relation(inner, src.alias)
            scope.add(rel)
            ordered_rels.append(rel)
            return rel

        for src in sel.from_tables:
            add_source(src)

        # conjunct classification state
        edges: list[tuple] = []        # (rel_a, key_ir_a, rel_b, key_ir_b)
        residuals: list[ir.IR] = []
        semis: list[P.SemiJoin] = []
        left_joins: list[tuple] = []   # (Relation, equi_pairs, residual)
        late: list[ir.IR] = []         # conjuncts touching left-join rels

        # explicit joins: INNER folds into the comma graph; LEFT is structural
        for jc in sel.joins:
            rel = add_source(jc.table)
            if jc.kind == "inner" or jc.kind == "cross":
                if jc.on is not None:
                    self._classify(_flatten_and(jc.on), scope, edges,
                                   residuals, semis, ordered_rels,
                                   local_views)
            elif jc.kind in ("left", "full"):
                pairs, resid = self._split_on(jc.on, scope, rel)
                if jc.kind == "full" and resid is not None:
                    raise PlanError(
                        "FULL OUTER JOIN supports only equi-conditions")
                left_joins.append((jc.kind, rel, pairs, resid))
                ordered_rels.remove(rel)  # not part of the inner-join graph
            else:
                raise PlanError(f"unsupported join kind {jc.kind}")

        left_bindings = {rel.binding for _k, rel, _p, _r in left_joins}
        has_full = any(k == "full" for k, _r, _p, _res in left_joins)
        if has_full:
            # a FULL join preserves BOTH sides: no WHERE conjunct may be
            # pushed below it (filtering the preserved side pre-join
            # changes which rows null-extend) — everything goes late
            left_bindings = left_bindings | {
                r.binding for r in ordered_rels}
        if sel.where is not None:
            conjuncts = _hoist_common_disjuncts(_flatten_and(sel.where))
            self._classify(conjuncts, scope, edges, residuals, semis,
                           ordered_rels, local_views,
                           external=left_bindings, late=late)

        # rels whose only connections go through a left-join output (q93's
        # `, reason where sr_reason_sk = r_reason_sk`) must join AFTER the
        # left join, or the graph would cross-join them
        deferred: list = []
        edge_bindings = set()
        for ra, _ia, rb, _ib in edges:
            edge_bindings.add(ra.binding if ra is not None else None)
            edge_bindings.add(rb.binding if rb is not None else None)
        for rel in list(ordered_rels):
            if has_full or rel.binding in edge_bindings:
                # under a FULL join every conjunct is late by design;
                # inner rels stay in the graph and late conjuncts become
                # post-join filters
                continue
            if any(rel.binding in self._bindings_of(e) for e in late):
                ordered_rels.remove(rel)
                deferred.append(rel)

        node = self._join_graph(ordered_rels, edges)

        for kind, rel, pairs, resid in left_joins:
            rnames = {p[1].name for p in pairs
                      if isinstance(p[1], ir.ColRef)}
            right_unique = (bool(rel.unique_on)
                            and set(rel.unique_on) <= rnames)
            node = P.Join(kind, node, rel.node,
                          [p[0] for p in pairs], [p[1] for p in pairs],
                          resid, right_unique=right_unique,
                          output=node.output + rel.node.output,
                          binding=node.binding)

        for rel in deferred:
            pairs2, rest = [], []
            for e in late:
                if isinstance(e, ir.Cmp) and e.op == "=":
                    lb = self._bindings_of(e.left)
                    rb = self._bindings_of(e.right)
                    if rb == {rel.binding} and rel.binding not in lb:
                        pairs2.append((e.left, e.right))
                        continue
                    if lb == {rel.binding} and rel.binding not in rb:
                        pairs2.append((e.right, e.left))
                        continue
                rest.append(e)
            late = rest
            rnames = {p[1].name for p in pairs2
                      if isinstance(p[1], ir.ColRef)}
            right_unique = (bool(rel.unique_on)
                            and set(rel.unique_on) <= rnames)
            node = P.Join("inner", node, rel.node,
                          [p[0] for p in pairs2], [p[1] for p in pairs2],
                          None, right_unique=right_unique,
                          output=node.output + rel.node.output,
                          binding=node.binding)
        residuals.extend(late)

        for s in semis:
            s.left = node
            node = s

        if residuals:
            node = P.Filter(node, self._conj(residuals))

        return self._plan_projection(sel, scope, node)

    # --------------------------------------------------- conjunct handling

    def _conj(self, preds: list[ir.IR]) -> ir.IR:
        return preds[0] if len(preds) == 1 else ir.BoolOp("and", preds)

    def _split_on(self, on: ast.Expr | None, scope: Scope, right: Relation):
        """Split a LEFT JOIN ON clause into equi pairs (left_ir, right_ir)
        and a residual over the combined row (q13's o_comment NOT LIKE
        lives in the ON clause, not WHERE)."""
        pairs, resid = [], []
        if on is None:
            return pairs, None
        for c in _flatten_and(on):
            e, _ = self._lower(c, scope, allow_agg=False)
            if (isinstance(e, ir.Cmp) and e.op == "="):
                lb = self._bindings_of(e.left)
                rb = self._bindings_of(e.right)
                if lb == {right.binding} and right.binding not in rb:
                    pairs.append((e.right, e.left))
                    continue
                if rb == {right.binding} and right.binding not in lb:
                    pairs.append((e.left, e.right))
                    continue
            resid.append(e)
        return pairs, (self._conj(resid) if resid else None)

    def _bindings_of(self, e: ir.IR) -> set:
        return {x.binding for x in ir.walk(e) if isinstance(x, ir.ColRef)}

    def _classify(self, conjuncts, scope, edges, residuals, semis,
                  rels, local_views, external: set | None = None,
                  late: list | None = None):
        by_binding = {r.binding: r for r in rels}
        for c in conjuncts:
            handled = self._try_subquery_conjunct(
                c, scope, edges, residuals, semis, rels, local_views,
                by_binding)
            if handled:
                continue
            e, depth = self._lower(c, scope, allow_agg=False)
            if external and (self._bindings_of(e) & external):
                # touches a left-join output: can only apply after the
                # left join is attached
                (late if late is not None else residuals).append(e)
                continue
            bs = self._bindings_of(e) & set(by_binding)
            if (isinstance(e, ir.Cmp) and e.op == "=" and len(bs) == 2):
                lb = self._bindings_of(e.left)
                rb = self._bindings_of(e.right)
                if len(lb) == 1 and len(rb) == 1 and lb != rb:
                    (a,), (b,) = lb, rb
                    if a in by_binding and b in by_binding:
                        edges.append((by_binding[a], e.left,
                                      by_binding[b], e.right))
                        continue
            if len(bs) == 1:
                rel = by_binding[next(iter(bs))]
                if isinstance(rel.node, P.Scan):
                    rel.node.filters.append(e)
                else:
                    rel.node = P.Filter(rel.node, e)
                rel.size *= 0.5
            else:
                residuals.append(e)

    # ------------------------------------------------------- subqueries

    def _try_subquery_conjunct(self, c, scope, edges, residuals, semis,
                               rels, local_views, by_binding) -> bool:
        neg = False
        inner_c = c
        while isinstance(inner_c, ast.UnaryOp) and inner_c.op == "not":
            neg = not neg
            inner_c = inner_c.operand

        if isinstance(inner_c, ast.Exists):
            self._plan_exists(inner_c.query, inner_c.negated ^ neg, scope,
                              semis, local_views)
            return True
        if isinstance(inner_c, ast.InSubquery):
            self._plan_in(inner_c, inner_c.negated ^ neg, scope, semis,
                          local_views)
            return True
        if isinstance(inner_c, ast.BinOp) and inner_c.op in (
                "=", "<>", "<", "<=", ">", ">="):
            for lhs, rhs, op in ((inner_c.left, inner_c.right, inner_c.op),
                                 (inner_c.right, inner_c.left,
                                  _flip(inner_c.op))):
                if isinstance(rhs, ast.ScalarSubquery):
                    if neg:
                        raise PlanError("NOT over scalar comparison "
                                        "unsupported")
                    self._plan_scalar_cmp(lhs, op, rhs.query, scope, edges,
                                          residuals, rels, by_binding,
                                          local_views)
                    return True
        return False

    def _subquery_context(self, sub: ast.Select, scope: Scope,
                          local_views: dict):
        """Plan a subquery's FROM/WHERE with `scope` as outer; returns
        (node, corr_pairs [(outer_ir, inner_ir)], corr_residuals,
        inner_scope)."""
        sub_planner_scope = Scope(scope)
        rels: list[Relation] = []
        for src in sub.from_tables:
            if isinstance(src, ast.TableRef):
                rel = self._table_relation(src.name, src.binding, local_views)
            else:
                inner = self.plan_select(src.query, scope, local_views)
                rel = self._derived_relation(inner, src.alias)
            sub_planner_scope.add(rel)
            rels.append(rel)
        if sub.joins:
            raise PlanError("explicit JOIN inside subquery not supported yet")
        if sub.set_ops:
            # would silently plan only the first branch — template must
            # wrap the union in a derived table instead
            raise PlanError("set operation directly inside IN/EXISTS "
                            "subquery: wrap it in a derived table")

        edges: list[tuple] = []
        residuals: list[ir.IR] = []
        semis: list[P.SemiJoin] = []
        corr_pairs: list[tuple] = []
        corr_resid: list[ir.IR] = []
        by_binding = {r.binding: r for r in rels}
        conjuncts = (_hoist_common_disjuncts(_flatten_and(sub.where))
                     if sub.where is not None else [])
        for c in conjuncts:
            handled = self._try_subquery_conjunct(
                c, sub_planner_scope, edges, residuals, semis, rels,
                local_views, by_binding)
            if handled:
                continue
            e, depth = self._lower(c, sub_planner_scope, allow_agg=False)
            local_bs = self._bindings_of(e) & set(by_binding)
            outer_bs = self._bindings_of(e) - set(by_binding)
            if outer_bs:
                # correlated conjunct: inner_expr = outer_expr becomes a
                # correlation key pair; anything else is a join residual
                if isinstance(e, ir.Cmp) and e.op == "=":
                    lb, rb = (self._bindings_of(e.left),
                              self._bindings_of(e.right))
                    l_local = bool(lb) and lb <= set(by_binding)
                    r_local = bool(rb) and rb <= set(by_binding)
                    l_outer = bool(lb) and not (lb & set(by_binding))
                    r_outer = bool(rb) and not (rb & set(by_binding))
                    if l_local and r_outer:
                        corr_pairs.append((e.right, e.left))
                        continue
                    if r_local and l_outer:
                        corr_pairs.append((e.left, e.right))
                        continue
                corr_resid.append(e)
                continue
            if (isinstance(e, ir.Cmp) and e.op == "=" and len(local_bs) == 2):
                lb = self._bindings_of(e.left)
                rb = self._bindings_of(e.right)
                if len(lb) == 1 and len(rb) == 1 and lb != rb:
                    edges.append((by_binding[next(iter(lb))], e.left,
                                  by_binding[next(iter(rb))], e.right))
                    continue
            if len(local_bs) == 1:
                rel = by_binding[next(iter(local_bs))]
                if isinstance(rel.node, P.Scan):
                    rel.node.filters.append(e)
                else:
                    rel.node = P.Filter(rel.node, e)
                rel.size *= 0.5
            else:
                residuals.append(e)

        node = self._join_graph(rels, edges)
        for s in semis:
            s.left = node
            node = s
        if residuals:
            node = P.Filter(node, self._conj(residuals))
        return node, corr_pairs, corr_resid, sub_planner_scope

    def _plan_exists(self, sub, anti, scope, semis, local_views):
        node, pairs, resid, _ = self._subquery_context(sub, scope,
                                                       local_views)
        if not pairs and not resid:
            raise PlanError("uncorrelated EXISTS not supported")
        semis.append(P.SemiJoin(
            None, node,
            [p[0] for p in pairs], [p[1] for p in pairs],
            self._conj(resid) if resid else None, anti))

    def _plan_in(self, node_ast: ast.InSubquery, anti, scope, semis,
                 local_views):
        sub = node_ast.query
        node, pairs, resid, sub_scope = self._subquery_context(
            sub, scope, local_views)
        if len(sub.items) != 1:
            raise PlanError("IN subquery must select one column")
        has_agg = (bool(sub.group_by) or sub.having is not None
                   or self._contains_agg(sub.items[0].expr))
        if has_agg:
            inner = self._plan_agg_subquery(sub, sub_scope, node)
            item_ir = ir.ColRef(inner.binding, inner.output[0][0],
                                inner.output[0][1])
            node = inner
        else:
            item_ir, _ = self._lower(sub.items[0].expr, sub_scope,
                                     allow_agg=False)
        outer_ir, _ = self._lower(node_ast.expr, scope, allow_agg=False)
        semis.append(P.SemiJoin(
            None, node,
            [outer_ir] + [p[0] for p in pairs],
            [item_ir] + [p[1] for p in pairs],
            self._conj(resid) if resid else None, anti))

    def _plan_agg_subquery(self, sub: ast.Select, sub_scope: Scope,
                           child: P.Node) -> P.Node:
        """Aggregate subquery used by IN (q18's having-stream)."""
        b = self._fresh("aggsub")
        group_keys = []
        for g in sub.group_by:
            e, _ = self._lower(g, sub_scope, allow_agg=False)
            name = e.name if isinstance(e, ir.ColRef) else self._fresh("k")
            group_keys.append((name, e))
        aggs: list[tuple[str, P.AggSpec]] = []

        def lower_with_aggs(e_ast):
            return self._lower(e_ast, sub_scope, allow_agg=True,
                               agg_sink=(aggs, sub_scope))

        item_ir, _ = lower_with_aggs(sub.items[0].expr)
        agg_node = P.Aggregate(child, group_keys, aggs, b)
        having_ir = None
        if sub.having is not None:
            having_ir, _ = lower_with_aggs(sub.having)
        # remap AggRef/group keys onto the aggregate's output columns
        out_node: P.Node = agg_node
        if having_ir is not None:
            out_node = P.Filter(out_node, self._remap_post_agg(
                having_ir, agg_node))
        proj = P.Project(out_node,
                         [("__in__", self._remap_post_agg(item_ir, agg_node))],
                         self._fresh("insub"))
        return proj

    def _plan_scalar_cmp(self, lhs_ast, op, sub, scope, edges, residuals,
                         rels, by_binding, local_views):
        node, pairs, resid, sub_scope = self._subquery_context(
            sub, scope, local_views)
        if resid:
            raise PlanError("non-equi correlation in scalar subquery")
        if len(sub.items) != 1:
            raise PlanError("scalar subquery must select one expression")
        aggs: list[tuple[str, P.AggSpec]] = []
        item_ir, _ = self._lower(sub.items[0].expr, sub_scope, allow_agg=True,
                                 agg_sink=(aggs, sub_scope))
        if not pairs:
            # uncorrelated: planned separately, bound at exec time
            if aggs:
                agg_node = P.Aggregate(node, [], aggs, self._fresh("scal"))
                value = self._remap_post_agg(item_ir, agg_node)
                root = P.Project(agg_node, [("__scalar__", value)],
                                 self._fresh("scalp"))
            else:
                root = P.Project(node, [("__scalar__", item_ir)],
                                 self._fresh("scalp"))
                if sub.distinct:
                    # (select distinct <expr> ...) used as a scalar
                    root = P.Distinct(root)
            sid = len(self.scalar_subplans)
            self.scalar_subplans.append(root)
            sref = ir.ScalarRef(sid, root.output[0][1])
            lhs_ir, _ = self._lower(lhs_ast, scope, allow_agg=False)
            pred = ir.Cmp(op, lhs_ir, sref)
            bs = self._bindings_of(pred) & set(by_binding)
            if len(bs) == 1:
                rel = by_binding[next(iter(bs))]
                if isinstance(rel.node, P.Scan):
                    rel.node.filters.append(pred)
                else:
                    rel.node = P.Filter(rel.node, pred)
            else:
                residuals.append(pred)
            return
        if not aggs:
            raise PlanError("correlated scalar subquery must aggregate")
        # correlated: aggregate grouped by the local half of each pair
        group_keys = []
        for i, (outer_ir, inner_ir) in enumerate(pairs):
            name = (inner_ir.name if isinstance(inner_ir, ir.ColRef)
                    else f"_ck{i}")
            group_keys.append((name, inner_ir))
        agg_node = P.Aggregate(node, group_keys, aggs, self._fresh("corr"))
        value = self._remap_post_agg(item_ir, agg_node)
        proj = P.Project(
            agg_node,
            [(n, ir.ColRef(agg_node.binding, n, t))
             for (n, _), t in zip(group_keys,
                                  [e.dtype for _, e in group_keys])]
            + [("__scalar__", value)],
            self._fresh("corrp"))
        rel = self._derived_relation(proj, proj.binding)
        rel.unique_on = tuple(n for n, _ in group_keys)
        rels.append(rel)
        by_binding[rel.binding] = rel
        for (outer_ir, _), (name, inner_ir) in zip(pairs, group_keys):
            edges.append((None, outer_ir, rel,
                          ir.ColRef(rel.binding, name, inner_ir.dtype)))
        lhs_ir, _ = self._lower(lhs_ast, scope, allow_agg=False)
        pred = ir.Cmp(op, lhs_ir,
                      ir.ColRef(rel.binding, "__scalar__",
                                proj.output[-1][1]))
        if op == "=":
            # equality against the scalar is itself a join edge
            edges.append((None, lhs_ir, rel,
                          ir.ColRef(rel.binding, "__scalar__",
                                    proj.output[-1][1])))
        else:
            residuals.append(pred)

    # ----------------------------------------------------------- join order

    def _join_graph(self, rels: list[Relation], edges: list[tuple]) -> P.Node:
        if not rels:
            raise PlanError("SELECT without FROM is not supported")
        # normalize edges: (binding_a, ir_a, binding_b, ir_b)
        norm = []
        for a, ia, b, ib in edges:
            ba = a.binding if a is not None else next(iter(
                self._bindings_of(ia)))
            bb = b.binding if b is not None else next(iter(
                self._bindings_of(ib)))
            norm.append((ba, ia, bb, ib))
        remaining = {r.binding: r for r in rels}
        # start from the PHYSICALLY largest relation: capacities are
        # static, so a filtered fact still occupies its full buffer —
        # it must be the probe side (discounted size would hand the
        # probe role to an unfiltered mid-size table and force an
        # expanding build over the fact, q12's 2x-capacity M:N trap)
        start = max(rels, key=lambda r: r.phys_size)
        current = start.node
        current_rel = start  # bare relation until the first join lands
        joined = {start.binding}
        del remaining[start.binding]
        pending = list(norm)
        while remaining:
            # candidate relations connected to the joined set
            cand: dict[str, list[tuple]] = {}
            for e in pending:
                ba, ia, bb, ib = e
                if ba in joined and bb in remaining:
                    cand.setdefault(bb, []).append((ia, ib))
                elif bb in joined and ba in remaining:
                    cand.setdefault(ba, []).append((ib, ia))
            if not cand:
                # disconnected: cross join the smallest remaining
                nxt = min(remaining.values(), key=lambda r: r.size)
                keys = ([], [])
                right_unique = False
            else:
                # prefer candidates UNIQUE on their join keys, then by
                # size: a unique build side makes every join a
                # key-preserving gather join on the device engine (no row
                # expansion, static output shape); joining a non-unique
                # side early (q5's customer-via-nationkey edge) would
                # force an expanding join the TPU plan can't bound
                def _uniq(b: str) -> bool:
                    r = remaining[b]
                    names = {k.name for _lk, k in cand[b]
                             if isinstance(k, ir.ColRef)}
                    return bool(r.unique_on) and set(r.unique_on) <= names
                best = min(cand, key=lambda b: (not _uniq(b),
                                                remaining[b].size))
                nxt = remaining[best]
                pairs = cand[best]
                keys = ([p[0] for p in pairs], [p[1] for p in pairs])
                right_unique = _uniq(best)
            build = nxt.node
            # the start-largest heuristic assumes the largest rel is a
            # fact (probe); in dimension-centric blocks (q10:
            # customer_demographics at 1.92M is the biggest rel but IS
            # the unique side of its first edge) that would run the
            # join as an expanding M:N at full capacity. While
            # `current` is still the bare start relation, flip the
            # sides so the unique start becomes the gather build.
            if not right_unique and current_rel is not None:
                snames = {k.name for k in keys[0]
                          if isinstance(k, ir.ColRef)
                          and k.binding == current_rel.binding}
                if (bool(current_rel.unique_on)
                        and set(current_rel.unique_on) <= snames):
                    current = nxt.node
                    build = current_rel.node
                    keys = (keys[1], keys[0])
                    right_unique = True
            current = P.Join("inner", current, build, keys[0], keys[1],
                             None, right_unique,
                             output=current.output + build.output,
                             binding=getattr(current, "binding", ""))
            current_rel = None
            joined.add(nxt.binding)
            del remaining[nxt.binding]
            pending = [e for e in pending
                       if not (e[0] in joined and e[2] in joined)]
        # leftover edges between already-joined rels -> filters
        for ba, ia, bb, ib in pending:
            current = P.Filter(current, ir.Cmp("=", ia, ib))
        return current

    # ------------------------------------------------------- projection/agg

    def _contains_agg(self, e: ast.Expr) -> bool:
        if isinstance(e, ast.FuncCall) and e.name in AGG_FUNCS:
            return True
        if isinstance(e, ast.WindowFunc):
            # a window's inputs may aggregate the enclosing GROUP BY
            # (rank() over (order by sum(x))); the window itself is not
            # an aggregate
            return any(self._contains_agg(a) for a in e.args) or any(
                self._contains_agg(p) for p in e.partition_by) or any(
                self._contains_agg(oi.expr) for oi in e.order_by)
        for v in vars(e).values():
            if isinstance(v, ast.Expr) and self._contains_agg(v):
                return True
            if isinstance(v, list):
                for x in v:
                    if isinstance(x, ast.Expr) and self._contains_agg(x):
                        return True
                    if isinstance(x, tuple):
                        if any(isinstance(y, ast.Expr)
                               and self._contains_agg(y) for y in x):
                            return True
        return False


    def _remap_post_agg(self, e: ir.IR, agg: P.Aggregate) -> ir.IR:
        """Rewrite AggRef -> ColRef(agg.binding, aggname) and group-key
        expressions -> ColRef(agg.binding, keyname)."""
        key_by_repr = {repr(k): (n, k.dtype) for n, k in agg.group_keys}

        def rec(x: ir.IR) -> ir.IR:
            if isinstance(x, ir.AggRef):
                name, spec = agg.aggs[x.index]
                return ir.ColRef(agg.binding, name, spec.dtype)
            if isinstance(x, ir.GroupingRef):
                # plain GROUP BY: every key participates -> constant 0
                return ir.Lit(0, INT32)
            r = repr(x)
            if r in key_by_repr:
                n, t = key_by_repr[r]
                return ir.ColRef(agg.binding, n, t)
            clone = x.__class__(**vars(x))
            for fname, v in vars(clone).items():
                if isinstance(v, ir.IR):
                    setattr(clone, fname, rec(v))
                elif isinstance(v, list):
                    setattr(clone, fname, [
                        tuple(rec(y) if isinstance(y, ir.IR) else y
                              for y in it) if isinstance(it, tuple)
                        else (rec(it) if isinstance(it, ir.IR) else it)
                        for it in v])
            return clone

        return rec(e)

    def _plan_projection(self, sel: ast.Select, scope: Scope,
                         node: P.Node) -> P.Node:
        has_agg = (bool(sel.group_by) or sel.having is not None
                   or any(self._contains_agg(it.expr) for it in sel.items))
        # expand stars
        items: list[ast.SelectItem] = []
        for it in sel.items:
            if isinstance(it.expr, ast.Star):
                for rel in scope.relations.values():
                    if it.expr.table and rel.binding != it.expr.table:
                        continue
                    for cname in rel.columns:
                        items.append(ast.SelectItem(
                            ast.Column(cname, rel.binding), cname))
            else:
                items.append(it)

        if not has_agg:
            wins: list[P.WindowSpec] = []
            exprs = []
            for i, it in enumerate(items):
                e, _ = self._lower(it.expr, scope, allow_agg=False,
                                   win_sink=wins)
                name = it.alias or (e.name if isinstance(e, ir.ColRef)
                                    else f"_c{i}")
                exprs.append((name, e))
            exprs = _dedupe_out_names(exprs)
            post: P.Node = node
            if wins:
                win_node, wremap = self._attach_window(
                    post, wins, lambda x: x)
                post = win_node
                exprs = [(n, wremap(e)) for n, e in exprs]
            proj = P.Project(post, exprs, self._fresh("proj"))
            if sel.distinct:
                out: P.Node = P.Distinct(proj)
                if not sel.set_ops and (sel.order_by
                                        or sel.limit is not None):
                    out = self._plan_order_limit(out, sel)
                return out
            if not sel.set_ops:
                return self._finish_select(proj, sel, scope, None, proj)
            return proj

        # aggregate path
        group_keys = []
        gk_map: dict[str, int] = {}
        for idx, g in enumerate(sel.group_by):
            e, _ = self._lower(g, scope, allow_agg=False)
            name = e.name if isinstance(e, ir.ColRef) else self._fresh("k")
            group_keys.append((name, e))
            gk_map[repr(e)] = idx
        aggs: list[tuple[str, P.AggSpec]] = []
        wins2: list[P.WindowSpec] = []
        lower_kw = dict(agg_sink=(aggs, scope), win_sink=wins2,
                        grouping_keys=gk_map)
        lowered_items = []
        for i, it in enumerate(items):
            e, _ = self._lower(it.expr, scope, allow_agg=True, **lower_kw)
            name = it.alias or (e.name if isinstance(e, ir.ColRef)
                                else f"_c{i}")
            lowered_items.append((name, e))
        lowered_items = _dedupe_out_names(lowered_items)
        having_ir = None
        if sel.having is not None:
            having_ir, _ = self._lower(sel.having, scope, allow_agg=True,
                                       **lower_kw)
        agg_node = None
        if sel.grouping_sets is not None:
            post, remap = self._plan_grouping_sets(
                node, group_keys, aggs, sel.grouping_sets)
        else:
            agg_node = P.Aggregate(node, group_keys, aggs,
                                   self._fresh("agg"))
            post = agg_node
            remap = lambda x: self._remap_post_agg(x, agg_node)  # noqa: E731
        if having_ir is not None:
            post = P.Filter(post, remap(having_ir))
        mapped_items = [(n, remap(e)) for n, e in lowered_items]
        if wins2:
            win_node, wremap = self._attach_window(post, wins2, remap)
            post = win_node
            mapped_items = [(n, wremap(e)) for n, e in mapped_items]
        proj = P.Project(post, mapped_items, self._fresh("proj"))
        if sel.distinct:
            out2: P.Node = P.Distinct(proj)
            if not sel.set_ops and (sel.order_by or sel.limit is not None):
                out2 = self._plan_order_limit(out2, sel)
            return out2
        if not sel.set_ops:
            return self._finish_select(
                proj, sel, scope,
                agg_node if sel.grouping_sets is None else None, proj)
        return proj

    def _attach_window(self, post: P.Node, wins: list, remap):
        """Build a Window node over `post` (specs remapped onto post's
        output namespace); returns (node, WindowRef-resolving remap)."""
        b = self._fresh("win")
        specs = []
        for i, s in enumerate(wins):
            specs.append((f"_win{i}", P.WindowSpec(
                s.func,
                remap(s.arg) if s.arg is not None else None,
                [remap(p) for p in s.partition],
                [(remap(e), asc, nf) for e, asc, nf in s.order],
                s.frame, s.dtype)))
        win_node = P.Window(post, specs, b)

        def wremap(x: ir.IR) -> ir.IR:
            return _replace_refs(x, lambda y: (
                ir.ColRef(b, f"_win{y.index}", y.dtype)
                if isinstance(y, ir.WindowRef) else None))

        return win_node, wremap

    def _plan_grouping_sets(self, child: P.Node, group_keys, aggs, sets):
        """Expand GROUP BY ROLLUP / GROUPING SETS into one Aggregate per
        set over the SHARED child (executors cache the child by node id,
        so it computes once), each projected onto a common column layout
        (rolled-up keys as typed NULLs + __grp markers), unioned ALL.
        Returns (union node, remap fn for item/having expressions)."""
        branches = []
        for S in sets:
            sset = set(S)
            agg_b = P.Aggregate(child, [group_keys[i] for i in S], aggs,
                                self._fresh("agg"))
            exprs: list = []
            for i, (name, e) in enumerate(group_keys):
                if i in sset:
                    exprs.append((name, ir.ColRef(agg_b.binding, name,
                                                  e.dtype)))
                else:
                    exprs.append((name, ir.Lit(None, e.dtype)))
            for i in range(len(group_keys)):
                exprs.append((f"__grp{i}",
                              ir.Lit(0 if i in sset else 1, INT32)))
            for aname, aspec in aggs:
                exprs.append((aname, ir.ColRef(agg_b.binding, aname,
                                               aspec.dtype)))
            branches.append(P.Project(agg_b, exprs, self._fresh("gsb")))
        union: P.Node = branches[0]
        for bnode in branches[1:]:
            union = P.SetOp("union all", union, bnode)
        out_bind = branches[0].binding
        key_by_repr = {repr(e): (n, e.dtype) for n, e in group_keys}

        def remap(x: ir.IR) -> ir.IR:
            def sub(y: ir.IR):
                if isinstance(y, ir.AggRef):
                    name, spec = aggs[y.index]
                    return ir.ColRef(out_bind, name, spec.dtype)
                if isinstance(y, ir.GroupingRef):
                    return ir.ColRef(out_bind, f"__grp{y.key_index}",
                                     INT32)
                r = repr(y)
                if r in key_by_repr:
                    n, t = key_by_repr[r]
                    return ir.ColRef(out_bind, n, t)
                return None
            return _replace_refs(x, sub)

        return union, remap

    def _finish_select(self, out: P.Node, sel: ast.Select, base_scope,
                       agg_node, proj: P.Project) -> P.Node:
        """ORDER BY / LIMIT for a plain (non-distinct, non-setop) select.

        SQL lets ORDER BY reference pre-projection columns and aggregates
        not in the select list (TPC-DS q19/q84/q96 order by base columns
        or bare aggregates). Resolution order: projected output names
        first, then the FROM scope (with agg remapping under GROUP BY);
        scope-resolved keys ride hidden projection columns that a final
        trim Project removes."""
        if not sel.order_by and sel.limit is None:
            return out
        if not sel.order_by:
            return P.Limit(out, sel.limit)
        visible = list(proj.output)
        out_scope = Scope()
        out_scope.add(Relation(proj.binding, proj,
                               {n: t for n, t in proj.output}))
        keys = []
        hidden = 0
        for item in sel.order_by:
            try:
                e, _ = self._lower(item.expr, out_scope, allow_agg=False)
            except PlanError:
                if agg_node is not None:
                    raw, _ = self._lower(item.expr, base_scope,
                                         allow_agg=True,
                                         agg_sink=(agg_node.aggs,
                                                   base_scope))
                    lowered = self._remap_post_agg(raw, agg_node)
                else:
                    lowered, _ = self._lower(item.expr, base_scope,
                                             allow_agg=False)
                name = f"__ord{hidden}"
                hidden += 1
                proj.exprs.append((name, lowered))
                e = ir.ColRef(proj.binding, name, lowered.dtype)
            keys.append((e, item.ascending, item.nulls_first))
        node: P.Node = P.Sort(out, keys)
        if sel.limit is not None:
            node = P.Limit(node, sel.limit)
        if hidden:
            node = P.Project(
                node, [(n, ir.ColRef(proj.binding, n, t))
                       for n, t in visible], self._fresh("trim"))
        return node

    # ------------------------------------------------------------- lowering

    def _lower(self, e: ast.Expr, scope: Scope, allow_agg: bool,
               agg_sink=None, win_sink=None, grouping_keys=None):
        """AST expr -> (ir.IR, max_outer_depth)."""
        depth_seen = [0]

        def rec(x: ast.Expr) -> ir.IR:
            if isinstance(x, ast.WindowFunc):
                if win_sink is None:
                    raise PlanError("window function not allowed here")
                arg_ir = rec(x.args[0]) if x.args else None
                part = [rec(p) for p in x.partition_by]
                order = [(rec(oi.expr), oi.ascending, oi.nulls_first)
                         for oi in x.order_by]
                if x.name in WINDOW_RANK_FUNCS:
                    dt = INT64
                else:
                    dt = ir.agg_type(
                        x.name, arg_ir.dtype if arg_ir is not None
                        else None)
                spec = P.WindowSpec(x.name, arg_ir, part, order,
                                    x.frame, dt)
                sig = (x.name, repr(arg_ir), repr(part), repr(order),
                       x.frame)
                for i, s in enumerate(win_sink):
                    if (s.func, repr(s.arg), repr(s.partition),
                            repr(s.order), s.frame) == sig:
                        return ir.WindowRef(i, s.dtype)
                win_sink.append(spec)
                return ir.WindowRef(len(win_sink) - 1, dt)
            if isinstance(x, ast.Column):
                ref, depth = scope.resolve(x)
                depth_seen[0] = max(depth_seen[0], depth)
                return ref
            if isinstance(x, ast.Literal):
                return self._lower_literal(x)
            if isinstance(x, ast.Interval):
                raise PlanError("bare interval outside date arithmetic")
            if isinstance(x, ast.BinOp):
                if x.op in ("and", "or"):
                    return ir.BoolOp(x.op, [rec(x.left), rec(x.right)])
                if x.op in ("=", "<>", "<", "<=", ">", ">="):
                    lhs, rhs = _coerce_date_cmp(rec(x.left),
                                                rec(x.right))
                    return ir.Cmp(x.op, lhs, rhs)
                # date ± interval folding
                if isinstance(x.right, ast.Interval):
                    base = rec(x.left)
                    iv = x.right
                    sign = 1 if x.op == "+" else -1
                    if isinstance(base, ir.Lit) and isinstance(
                            base.dtype, DateType):
                        if iv.unit == "day":
                            return ir.Lit(base.value + sign * iv.amount, DATE)
                        months = iv.amount * (12 if iv.unit == "year" else 1)
                        return ir.Lit(_add_months(base.value, sign * months),
                                      DATE)
                    if iv.unit == "day":
                        return ir.Arith(x.op, base,
                                        ir.Lit(iv.amount, INT32), DATE)
                    raise PlanError(
                        "month/year interval on non-literal date")
                l, r = rec(x.left), rec(x.right)
                return ir.Arith(x.op, l, r, ir.arith_type(
                    x.op, l.dtype, r.dtype))
            if isinstance(x, ast.UnaryOp):
                if x.op == "not":
                    return ir.Not(rec(x.operand))
                inner = rec(x.operand)
                if isinstance(inner, ir.Lit):
                    return ir.Lit(-inner.value, inner.dtype)
                return ir.Neg(inner, inner.dtype)
            if isinstance(x, ast.FuncCall):
                if x.name in AGG_FUNCS:
                    if not allow_agg or agg_sink is None:
                        raise PlanError(
                            f"aggregate {x.name} not allowed here")
                    aggs, agg_scope = agg_sink
                    if x.star:
                        spec = P.AggSpec("count", None, False, INT64)
                        arg_repr = "*"
                    else:
                        arg_ir, _ = self._lower(x.args[0], agg_scope, False)
                        spec = P.AggSpec(x.name, arg_ir, x.distinct,
                                         ir.agg_type(x.name, arg_ir.dtype))
                        arg_repr = repr(arg_ir)
                    sig = (x.name, arg_repr, x.distinct)
                    for i, (n, s) in enumerate(aggs):
                        if (s.func, repr(s.arg) if s.arg is not None
                                else "*", s.distinct) == sig:
                            return ir.AggRef(i, s.dtype)
                    name = f"_agg{len(aggs)}"
                    aggs.append((name, spec))
                    return ir.AggRef(len(aggs) - 1, spec.dtype)
                if x.name == "grouping":
                    if grouping_keys is None:
                        raise PlanError("grouping() outside GROUP BY "
                                        "ROLLUP/GROUPING SETS")
                    arg_ir = rec(x.args[0])
                    idx = grouping_keys.get(repr(arg_ir))
                    if idx is None:
                        raise PlanError(
                            f"grouping() argument {arg_ir!r} is not a "
                            "group key")
                    return ir.GroupingRef(idx)
                if x.name == "coalesce":
                    args = [rec(a) for a in x.args]
                    dt = args[0].dtype
                    for a in args[1:]:
                        if not isinstance(a, ir.Lit) or a.value is not None:
                            dt = _unify(dt, a.dtype)
                    whens = [(ir.IsNullIR(a, negated=True), a)
                             for a in args[:-1]]
                    return ir.CaseIR(whens, args[-1], dt)
                if x.name in ("upper", "lower"):
                    a = rec(x.args[0])
                    if isinstance(a, ir.Lit) and isinstance(a.value, str):
                        v = (a.value.upper() if x.name == "upper"
                             else a.value.lower())
                        return ir.Lit(v, StringType())
                    return ir.StrMapIR(x.name, a, StringType())
                if x.name == "concat":
                    parts = [rec(a) for a in x.args]
                    lits = [p.value if isinstance(p, ir.Lit) else None
                            for p in parts]
                    cols = [i for i, v in enumerate(lits) if v is None]
                    if not cols:  # all literals: fold
                        return ir.Lit("".join(str(v) for v in lits),
                                      StringType())
                    if len(cols) > 1:
                        raise PlanError(
                            "concat/|| supports one non-literal operand")
                    i = cols[0]
                    pre = "".join(str(v) for v in lits[:i])
                    suf = "".join(str(v) for v in lits[i + 1:])
                    return ir.ConcatIR(pre, parts[i], suf, StringType())
                if x.name == "nullif":
                    a, b = rec(x.args[0]), rec(x.args[1])
                    return ir.CaseIR([(ir.Cmp("=", a, b),
                                       ir.Lit(None, a.dtype))], a, a.dtype)
                if x.name == "round":
                    a = rec(x.args[0])
                    nd = 0
                    if len(x.args) > 1:
                        d = rec(x.args[1])
                        if not isinstance(d, ir.Lit):
                            raise PlanError("round() digits must be "
                                            "literal")
                        nd = int(d.value)
                    return ir.CastIR(a, DecimalType(38, nd))
                if x.name == "abs":
                    a = rec(x.args[0])
                    zero = ir.Lit(0, INT32)
                    return ir.CaseIR(
                        [(ir.Cmp("<", a, zero), ir.Neg(a, a.dtype))], a,
                        a.dtype)
                raise PlanError(f"unknown function {x.name}")
            if isinstance(x, ast.CaseWhen):
                whens = [(rec(c), rec(v)) for c, v in x.whens]
                else_ = rec(x.else_) if x.else_ is not None else None
                dt = whens[0][1].dtype
                for _, v in whens[1:]:
                    dt = _unify(dt, v.dtype)
                if else_ is not None:
                    dt = _unify(dt, else_.dtype)
                return ir.CaseIR(whens, else_, dt)
            if isinstance(x, ast.Between):
                e_ir = rec(x.expr)
                e_lo, lo = _coerce_date_cmp(e_ir, rec(x.low))
                e_hi, hi = _coerce_date_cmp(e_ir, rec(x.high))
                both = ir.BoolOp("and", [ir.Cmp(">=", e_lo, lo),
                                         ir.Cmp("<=", e_hi, hi)])
                return ir.Not(both) if x.negated else both
            if isinstance(x, ast.InList):
                e_ir = rec(x.expr)
                vals = []
                for item in x.items:
                    lit = _fold_const(rec(item))
                    if not isinstance(lit, ir.Lit):
                        raise PlanError("IN list items must be literals")
                    vals.append(lit.value)
                return ir.InListIR(e_ir, vals, x.negated)
            if isinstance(x, ast.Like):
                return ir.LikeIR(rec(x.expr), x.pattern, x.negated)
            if isinstance(x, ast.IsNull):
                return ir.IsNullIR(rec(x.expr), x.negated)
            if isinstance(x, ast.Extract):
                return ir.ExtractIR(x.part, rec(x.operand))
            if isinstance(x, ast.Substring):
                start = rec(x.start)
                length = rec(x.length) if x.length is not None else None
                if not isinstance(start, ir.Lit) or (
                        length is not None and not isinstance(length, ir.Lit)):
                    raise PlanError("SUBSTRING bounds must be literals")
                inner = rec(x.operand)
                return ir.SubstrIR(inner, start.value,
                                   None if length is None else length.value,
                                   StringType())
            if isinstance(x, ast.Cast):
                inner = rec(x.operand)
                t = {"int": INT64, "integer": INT64, "bigint": INT64,
                     "double": FLOAT64, "float": FLOAT64,
                     "decimal": DecimalType(38, 2), "date": DATE,
                     "varchar": StringType(), "char": StringType(),
                     "string": StringType()}.get(x.type_name)
                if t is None:
                    raise PlanError(f"unsupported cast to {x.type_name}")
                if (t is DATE and isinstance(inner, ir.Lit)
                        and isinstance(inner.value, str)):
                    # fold cast('1998-01-01' as date) to a DATE literal
                    # (q21/q40 style date-window arithmetic)
                    return ir.Lit(_date_to_days(inner.value), DATE)
                return ir.CastIR(inner, t)
            if isinstance(x, ast.ScalarSubquery):
                # uncorrelated scalar in a general expression position
                # (q11's HAVING threshold): plan separately, bind ScalarRef
                root = self.plan_select(x.query, scope,
                                        self._views_stack[-1])
                sid = len(self.scalar_subplans)
                self.scalar_subplans.append(root)
                return ir.ScalarRef(sid, root.output[0][1])
            if isinstance(x, (ast.InSubquery, ast.Exists)):
                raise PlanError(
                    "IN/EXISTS subquery in unsupported position (must be "
                    "a WHERE conjunct)")
            raise PlanError(f"cannot lower {x!r}")

        return rec(e), depth_seen[0]

    def _lower_literal(self, x: ast.Literal) -> ir.Lit:
        if x.kind == "int":
            return ir.Lit(x.value, INT32 if abs(x.value) < 2**31 else INT64)
        if x.kind == "decimal":
            s = x.value.split(".")[1] if "." in x.value else ""
            scale = len(s)
            scaled = int(round(float(x.value) * 10**scale))
            return ir.Lit(scaled, DecimalType(38, scale))
        if x.kind == "string":
            return ir.Lit(x.value, StringType())
        if x.kind == "date":
            return ir.Lit(_date_to_days(x.value), DATE)
        if x.kind == "null":
            return ir.Lit(None, BOOL)
        raise PlanError(f"unknown literal kind {x.kind}")


def _coerce_date_cmp(l: ir.IR, r: ir.IR) -> tuple:
    """SQL's implicit string->date cast in comparisons: a string literal
    compared against a DATE expression becomes a DATE literal (the
    reference engine gets this from Spark; the DF_* maintenance SQL and
    ad-hoc 'd_date between ...' predicates rely on it)."""
    from nds_tpu_torch.engine.types import DateType
    if (isinstance(l.dtype, DateType) and isinstance(r, ir.Lit)
            and isinstance(r.dtype, StringType)
            and isinstance(r.value, str)):
        return l, ir.Lit(_date_to_days(r.value), DATE)
    if (isinstance(r.dtype, DateType) and isinstance(l, ir.Lit)
            and isinstance(l.dtype, StringType)
            and isinstance(l.value, str)):
        return ir.Lit(_date_to_days(l.value), DATE), r
    return l, r


def _unique_key_of(node: P.Node) -> tuple:
    """Output column names a derived table is unique on, traced through
    Project/Filter/Sort/Limit wrappers down to an Aggregate's group keys
    (q65's per-store average subquery is Project(Aggregate) — losing the
    key there forces expanding joins the device engine can't bound)."""
    if isinstance(node, P.Aggregate):
        return tuple(n for n, _ in node.group_keys)
    if isinstance(node, P.Distinct):
        return tuple(n for n, _ in node.output)
    if isinstance(node, (P.Filter, P.Sort, P.Limit)):
        return _unique_key_of(node.child)
    if isinstance(node, P.Window):
        # Window extends columns without changing the row set (q51's
        # cumulative sums over grouped CTEs stay unique on group keys)
        return _unique_key_of(node.child)
    if isinstance(node, P.Project):
        inner = _unique_key_of(node.child)
        if not inner:
            return ()
        # a Window child is namespace-EXTENDING: the Project reads key
        # columns under the Window's child binding, window columns under
        # the Window's own binding — accept both
        bindings = {getattr(node.child, "binding", "")}
        if isinstance(node.child, P.Window):
            bindings.add(getattr(node.child.child, "binding", ""))
        mapping = {}
        for name, e in node.exprs:
            if isinstance(e, ir.ColRef) and e.binding in bindings:
                mapping.setdefault(e.name, name)
        out = []
        for k in inner:
            if k not in mapping:
                return ()
            out.append(mapping[k])
        return tuple(out)
    return ()


def _replace_refs(e: ir.IR, sub) -> ir.IR:
    """Structurally clone `e`, replacing any node where sub(node) returns
    non-None (applied pre-order; replaced subtrees are not descended)."""
    if e is None:
        return None
    r = sub(e)
    if r is not None:
        return r
    clone = e.__class__(**vars(e))
    for fname, v in vars(clone).items():
        if isinstance(v, ir.IR):
            setattr(clone, fname, _replace_refs(v, sub))
        elif isinstance(v, list):
            setattr(clone, fname, [
                tuple(_replace_refs(y, sub) if isinstance(y, ir.IR) else y
                      for y in it) if isinstance(it, tuple)
                else (_replace_refs(it, sub) if isinstance(it, ir.IR)
                      else it)
                for it in v])
    return clone


def _fold_const(e: ir.IR) -> ir.IR:
    """Fold integer arithmetic over literals (IN (1999, 1999 + 1, ...))."""
    if isinstance(e, ir.Arith):
        l = _fold_const(e.left)
        r = _fold_const(e.right)
        if (isinstance(l, ir.Lit) and isinstance(r, ir.Lit)
                and isinstance(l.value, int) and isinstance(r.value, int)):
            v = {"+": l.value + r.value, "-": l.value - r.value,
                 "*": l.value * r.value}.get(e.op)
            if v is not None:
                return ir.Lit(v, e.dtype)
    return e


def _flip(op: str) -> str:
    return {"=": "=", "<>": "<>", "<": ">", "<=": ">=",
            ">": "<", ">=": "<="}[op]


def _unify(a: DType, b: DType) -> DType:
    if repr(a) == repr(b):
        return a
    if isinstance(a, FloatType) or isinstance(b, FloatType):
        return FLOAT64
    if isinstance(a, DecimalType) or isinstance(b, DecimalType):
        sa = a.scale if isinstance(a, DecimalType) else 0
        sb = b.scale if isinstance(b, DecimalType) else 0
        return DecimalType(38, max(sa, sb))
    if isinstance(a, IntType) and isinstance(b, IntType):
        return INT64 if max(a.bits, b.bits) > 32 else INT32
    if isinstance(a, StringType) and isinstance(b, StringType):
        return StringType()
    raise PlanError(f"cannot unify {a} and {b}")
