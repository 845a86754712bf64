"""Query session: the engine-side analog of a SparkSession.

Port copy of ``nds_tpu/engine/session.py`` with the later slices' hooks
trimmed: no fault points, no tracer spans, no plan verification, no DML
(``engine.dml``) and no literal parameterization (``sql.params``).
What stays behaves as the reference does: the
table registry, session views (q15), the (SQL text, views) plan cache
and the executor factory that picks the backend (CPU oracle or the
device engine).
"""

from __future__ import annotations

from nds_tpu_torch.engine.cpu_exec import CpuExecutor, ResultTable
from nds_tpu_torch.io.host_table import HostTable
from nds_tpu_torch.sql import plan as P
from nds_tpu_torch.sql.parser import parse
from nds_tpu_torch.sql.planner import CatalogInfo, Planner

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
                use_decimal: bool = True) -> "Session":
        """The NDS (TPC-DS) catalog: the 24 source tables, their primary
        keys and the dsdgen row-count model for join ordering. The
        reference's ``include_maintenance`` (the refresh staging tables)
        waits for the maintenance slice, and ``parameterize`` (literal
        parameterization) for the serving slice."""
        from nds_tpu_torch.nds.schema import (
            PRIMARY_KEYS, SIZES, get_schemas,
        )
        cat = CatalogInfo(get_schemas(use_decimal), dict(PRIMARY_KEYS),
                          dict(SIZES))
        return cls(cat, executor_factory)

    def register_table(self, table: HostTable) -> None:
        self.tables[table.name] = table

    def plan(self, sql_text: str):
        return self.plan_ast(parse(sql_text))

    def plan_ast(self, stmt):
        return Planner(self.catalog, self.views).plan_statement(stmt)

    def _views_signature(self) -> frozenset:
        return frozenset(self._view_sql.items())

    def invalidate(self) -> None:
        """Drop every content-derived cache after a wholesale table
        swap: the plan cache and the executor the factory holds."""
        self._plan_cache.clear()
        inv = getattr(self._executor_factory, "invalidate", None)
        if inv is not None:
            inv()

    def _planned_for(self, key: tuple, sql_text: str):
        planned = self._plan_cache.get(key)
        if planned is None:
            planned = self.plan(sql_text)
            self._plan_cache[key] = planned
            while len(self._plan_cache) > self.PLAN_CACHE_MAX:
                self._plan_cache.pop(next(iter(self._plan_cache)))
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
            self._plan_cache.pop(key, None)
            raise NotImplementedError(
                f"{action} statements are not ported yet")
        executor = self._executor_factory(self.tables)
        return executor.execute(planned)
