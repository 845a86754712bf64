"""Query session: the engine-side analog of a SparkSession.

Port copy of ``nds_tpu/engine/session.py`` with the later slices' hooks
trimmed: no tracer spans (ROADMAP Queue 1 item 7), no plan verification and no literal parameterization
(``sql.params``, the serving slice). What stays behaves as the
reference does: the table registry, session views (q15), the (SQL
text, views) plan cache, the executor factory that picks the backend
(the CPU oracle, the device engine, or the execution pipeline over
them), ``sql_async``, and DML (INSERT ... SELECT and DELETE through
``engine/dml.py``, landing as deltas) with its table-scoped
invalidation. ``plan`` fires the ``plan`` fault point
(``resilience/faults.py``), and so does a plan the cache serves.
"""

from __future__ import annotations

from nds_tpu_torch.engine.cpu_exec import CpuExecutor, ResultTable
from nds_tpu_torch.io.host_table import HostTable
from nds_tpu_torch.sql import plan as P
from nds_tpu_torch.sql.parser import parse
from nds_tpu_torch.sql.planner import CatalogInfo, Planner

def scan_tables(planned) -> list:
    """Sorted unique table names scanned anywhere in a plan (root and
    scalar sub-plans): the port's copy of the reference's
    ``cache/fingerprint.scan_tables`` (``cache/`` is not ported)."""
    roots = []
    if isinstance(planned, P.PlannedQuery):
        roots = [planned.root, *planned.scalar_subplans]
    elif planned is not None:
        roots = [planned]
    names = set()
    for root in roots:
        for node in P.walk_plan(root):
            if isinstance(node, P.Scan):
                names.add(node.table)
    return sorted(names)


# relative size weights for greedy join ordering (TPC-H row ratios)
TPCH_SIZES = {
    "lineitem": 6_000_000, "orders": 1_500_000, "partsupp": 800_000,
    "part": 200_000, "customer": 150_000, "supplier": 10_000,
    "nation": 25, "region": 5,
}


class Session:
    # bound on the (SQL text, views) -> plan cache
    PLAN_CACHE_MAX = 512

    def __init__(self, catalog: CatalogInfo, executor_factory=None):
        self.catalog = catalog
        self.tables: dict[str, HostTable] = {}
        self.views: dict[str, P.Node] = {}
        self._executor_factory = executor_factory or (
            lambda tables: CpuExecutor(tables))
        # plan cache keyed by (SQL text, view-definition signature):
        # repeated queries reuse the SAME plan object; q15's
        # CREATE/DROP VIEW cycle maps every pass onto one entry, while a
        # re-created view with a different body replans
        self._plan_cache: dict[tuple, object] = {}
        self._view_sql: dict[str, str] = {}

    @classmethod
    def for_nds_h(cls, executor_factory=None) -> "Session":
        from nds_tpu_torch.nds_h.schema import PRIMARY_KEYS, get_schemas
        cat = CatalogInfo(get_schemas(), PRIMARY_KEYS, dict(TPCH_SIZES))
        return cls(cat, executor_factory)

    @classmethod
    def for_nds(cls, executor_factory=None,
                use_decimal: bool = True,
                include_maintenance: bool = False) -> "Session":
        """The NDS (TPC-DS) catalog: the 24 source tables, their primary
        keys and the dsdgen row-count model for join ordering; with
        ``include_maintenance`` also the 12 refresh staging tables the
        LF_*/DF_* functions read. The reference's ``parameterize``
        (literal parameterization) waits for the serving slice."""
        from nds_tpu_torch.nds.schema import (
            PRIMARY_KEYS, SIZES, get_maintenance_schemas, get_schemas,
        )
        schemas = get_schemas(use_decimal)
        keys = dict(PRIMARY_KEYS)
        sizes = dict(SIZES)
        if include_maintenance:
            # the 12 s_*/delete staging tables the LF_*/DF_* refresh
            # functions read (`nds/nds_maintenance.py:270-274` registers
            # them as temp views)
            maint = get_maintenance_schemas(use_decimal)
            schemas = {**schemas, **maint}
            keys.update({"s_purchase": ("purc_purchase_id",),
                         "s_catalog_order": ("cord_order_id",),
                         "s_web_order": ("word_order_id",)})
            sizes.update({t: 100.0 for t in maint})
        cat = CatalogInfo(schemas, keys, sizes)
        return cls(cat, executor_factory)

    def register_table(self, table: HostTable) -> None:
        self.tables[table.name] = table

    def plan(self, sql_text: str):
        from nds_tpu_torch.resilience import faults
        # chaos site: deterministic plan-time faults must fail fast (the
        # retry classifier never retries that class)
        faults.fault_point("plan")
        return self.plan_ast(parse(sql_text))

    def plan_ast(self, stmt):
        return Planner(self.catalog, self.views).plan_statement(stmt)

    def _views_signature(self) -> frozenset:
        return frozenset(self._view_sql.items())

    def invalidate(self, tables=None) -> None:
        """Drop content-derived caches after a table mutation. With
        ``tables=None`` everything goes (a wholesale warehouse swap, such
        as a rollback). With a table-name iterable the eviction is
        scoped: only the plan-cache entries whose plans scan a mutated
        table go, and the executor factory is asked for a scoped
        invalidate (``invalidate_tables``) where it has one, else for
        the wholesale one (the execution pipeline has only that, as the
        reference's)."""
        if tables is None:
            self._plan_cache.clear()
            inv = getattr(self._executor_factory, "invalidate", None)
            if inv is not None:
                inv()
            return
        touched = set(tables)
        for key in [k for k, planned in self._plan_cache.items()
                    if not isinstance(planned, tuple)
                    and touched.intersection(scan_tables(planned))]:
            self._plan_cache.pop(key, None)
        inv_scoped = getattr(self._executor_factory,
                             "invalidate_tables", None)
        if inv_scoped is not None:
            inv_scoped(touched)
        else:
            inv = getattr(self._executor_factory, "invalidate", None)
            if inv is not None:
                inv()

    def _run_dml(self, action: str, name: str, payload) -> None:
        from nds_tpu_torch.engine import dml
        table = self.tables.get(name)
        if table is None:
            raise ValueError(f"DML target {name!r} is not registered")
        if action == "insert":
            executor = self._executor_factory(self.tables)
            result = executor.execute(payload)
            self.tables[name] = dml.append_rows(table, result)
        else:  # delete
            keep = dml.delete_mask(self, table, payload)
            self.tables[name] = dml.apply_delete(table, keep)
        self.invalidate(tables=[name])

    def _planned_for(self, key: tuple, sql_text: str):
        planned = self._plan_cache.get(key)
        if planned is None:
            planned = self.plan(sql_text)
            self._plan_cache[key] = planned
            while len(self._plan_cache) > self.PLAN_CACHE_MAX:
                self._plan_cache.pop(next(iter(self._plan_cache)))
        else:
            from nds_tpu_torch.resilience import faults
            faults.fault_point("plan")
        return planned

    def sql(self, sql_text: str) -> ResultTable | None:
        key = (sql_text, self._views_signature())
        planned = self._planned_for(key, sql_text)
        return self._run_planned(key, sql_text, planned)

    def _run_planned(self, key: tuple, sql_text: str, planned):
        if isinstance(planned, tuple):
            action, name, node = planned
            if action == "create_view":
                if name in self.views:
                    raise ValueError(f"view {name!r} already exists")
                self.views[name] = node
                self._view_sql[name] = sql_text
                return None
            if action == "drop_view":
                if name not in self.views and node != "if_exists":
                    raise ValueError(f"view {name!r} does not exist")
                self.views.pop(name, None)
                self._view_sql.pop(name, None)
                return None
            if action in ("insert", "delete"):
                # never replay a stale DML plan against mutated tables
                self._plan_cache.pop(key, None)
                self._run_dml(action, name, node)
                return None
        executor = self._executor_factory(self.tables)
        return executor.execute(planned)

    def sql_async(self, sql_text: str):
        """Dispatch-without-wait variant of ``sql()``: returns a handle
        with ``.result()``. A SELECT on an executor with ``execute_async``
        (the device engine, the execution pipeline) overlaps with the
        caller's other work (``engine.concurrent_tasks``); everything
        else runs synchronously and returns a completed handle."""
        key = (sql_text, self._views_signature())
        planned = self._planned_for(key, sql_text)
        if not isinstance(planned, tuple):
            executor = self._executor_factory(self.tables)
            dispatch = getattr(executor, "execute_async", None)
            if dispatch is not None:
                return dispatch(planned)
        return _Completed(self._run_planned(key, sql_text, planned))


class _Completed:
    """Already-finished async handle (the CPU oracle, DML, view DDL)."""

    def __init__(self, value):
        self._value = value

    def result(self):
        return self._value
