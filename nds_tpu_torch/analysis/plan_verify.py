"""The plan's size estimate, the scheduler's cost-model input.

Port of the estimator of ``nds_tpu/analysis/plan_verify.py``
(``_dtype_width``, ``_scan_bytes``, ``PlanEstimate``, ``estimate_plan``,
reference lines 587-759) over the port's plans, types and columnar store:
per planned statement, the rows and bytes its scans read at the widths
the device engine materializes (ints and floats by width, decimals as
scaled int64, dates as int32 days, strings as int32 dictionary codes;
the encoded widths under an active columnar mode), from the registered
host tables where given, else from the planner catalog's row weights,
and its counts of joins, aggregates, sorts and windows. Pure Python: it
needs no device.

The verifier itself (``_Verifier``, ``verify``, ``assert_valid``, the
exchange and encoding invariants) waits for ROADMAP Queue 1 item 8.
"""

from __future__ import annotations

from dataclasses import dataclass

from nds_tpu_torch.engine.types import (
    DateType, DecimalType, DType, FloatType, IntType, StringType,
)
from nds_tpu_torch.sql import plan as P


def _dtype_width(dt: DType) -> int:
    """Estimated bytes per value as the engine materializes it on
    device: ints by declared width, decimals as scaled int64, dates as
    epoch-day int32, strings as int32 dictionary codes (the dictionary
    itself stays on host and is small next to the column)."""
    if isinstance(dt, IntType):
        return dt.bits // 8
    if isinstance(dt, FloatType):
        return dt.bits // 8
    if isinstance(dt, DecimalType):
        return 8
    if isinstance(dt, DateType):
        return 4
    if isinstance(dt, StringType):
        return 4
    return 8


def _scan_bytes(table, output, nrows: int,
                encoded: "bool | None" = None) -> int:
    """Bytes a device scan of these columns moves. With a real
    HostTable and an active columnar mode (``columnar/``) the
    per-column ENCODED widths apply — so the scheduler cost model and
    the MemoryGovernor's pre-admission budget both see the compressed
    working set (an SF that only fits encoded must not be demoted off
    device on raw arithmetic). ``encoded=False`` forces raw widths —
    the scheduler passes it when costing a placement that uploads raw
    (the sharded SPMD path opts out of columnar upload, so shrinking
    ITS working-set math by the compression ratio would under-admit).
    Catalog-only estimates (and mode off) keep the raw device-width
    formula."""
    cols = getattr(table, "columns", None)
    if cols is not None:
        from nds_tpu_torch import columnar
        if columnar.enabled() and encoded is not False:
            total = 0
            for name, dt in output:
                col = cols.get(name)
                total += (columnar.scan_nbytes(col)
                          if col is not None
                          else _dtype_width(dt) * nrows)
            return total
    return nrows * sum(_dtype_width(dt) for _n, dt in output)


@dataclass
class PlanEstimate:
    """Static size estimate for one planned statement — the cost-model
    input the scheduler (engine/scheduler.py) seeds placement from.
    ``tables`` maps each scanned base table to its (rows, bytes)
    estimate; bytes count only the columns the plan's scans actually
    read, at device materialization widths. Estimates come from real
    HostTables when an executor registry is supplied, else from the
    planner catalog's relative size statistics — both paths need no
    accelerator."""
    rows: int = 0
    bytes: int = 0
    widest_table_bytes: int = 0
    tables: dict = None  # type: ignore[assignment]
    joins: int = 0
    aggregates: int = 0
    sorts: int = 0
    windows: int = 0


def estimate_plan(planned: P.PlannedQuery, tables: "dict | None" = None,
                  catalog=None,
                  encoded: "bool | None" = None) -> PlanEstimate:
    """Scan-level size estimate over every root (scalar subplans
    included). Row counts prefer the executor's registered HostTables
    (exact); the catalog's ``sizes`` statistics (relative row weights)
    are the planning-time fallback. Unknown tables estimate as 0 rows —
    the scheduler treats an all-unknown plan as small, which is the
    conservative direction for placement (the ladder recovers from an
    underestimate; overestimating would pin small queries off-device).
    ``encoded=False`` forces raw scan widths even under an active
    columnar mode (see ``_scan_bytes``)."""
    est = PlanEstimate(tables={})
    if not isinstance(planned, P.PlannedQuery):
        return est
    seen: set = set()
    for root in [planned.root, *planned.scalar_subplans]:
        if not isinstance(root, P.Node):
            continue
        for node in P.walk_plan(root):
            if id(node) in seen:
                continue
            seen.add(id(node))
            if isinstance(node, P.Join):
                est.joins += 1
            elif isinstance(node, P.Aggregate):
                est.aggregates += 1
            elif isinstance(node, P.Sort):
                est.sorts += 1
            elif isinstance(node, P.Window):
                est.windows += 1
            if not isinstance(node, P.Scan):
                continue
            nrows = 0
            t = tables.get(node.table) if tables is not None else None
            if t is not None:
                nrows = t.nrows
            elif catalog is not None:
                nrows = int(catalog.sizes.get(node.table, 0))
            nbytes = _scan_bytes(t, node.output, nrows, encoded)
            rows0, bytes0 = est.tables.get(node.table, (0, 0))
            # one table scanned by several Scan nodes: rows count once,
            # bytes accumulate per scan (each scan uploads its columns)
            est.tables[node.table] = (max(rows0, nrows),
                                      bytes0 + nbytes)
    for nrows, nbytes in est.tables.values():
        est.rows += nrows
        est.bytes += nbytes
        est.widest_table_bytes = max(est.widest_table_bytes, nbytes)
    return est
