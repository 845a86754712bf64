"""Logical plan nodes.

Port copy of ``nds_tpu/sql/plan.py``: it imports nothing of ``nds_tpu``.

The closed-world benchmark workload means plans are fixed per query; the
executor walks this tree. Join nodes carry equi-keys explicitly (the
engine's join strategies key off them) plus an optional residual predicate;
semi/anti joins are first-class because EXISTS/IN decorrelation produces
them (q4/q16/q18/q20/q21/q22).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from nds_tpu_torch.engine.types import DType
from nds_tpu_torch.sql import ir


class Node:
    """Base logical plan node. ``output`` lists (name, dtype) columns; each
    node's output columns are addressable as ColRef(binding, name)."""
    output: list[tuple[str, DType]]
    binding: str


@dataclass
class Scan(Node):
    table: str
    binding: str
    output: list = field(default_factory=list)
    # conjunctive pushed-down predicates over this table's columns
    filters: list = field(default_factory=list)


@dataclass
class DerivedScan(Node):
    """A planned derived table / view / CTE with its own binding."""
    child: "Node" = None
    binding: str = ""
    output: list = field(default_factory=list)


@dataclass
class StagedScan(Node):
    """Scan of a host-staged intermediate (plan splitting,
    engine/staging.py): reads the temp table behind ``child`` (a plain
    Scan with mangled column names) and re-exposes each column under its
    ORIGINAL (binding, name) address so ancestor nodes compile
    unchanged. Created by the executor, never by the planner."""
    child: Scan = None
    # [(orig_binding, orig_name, mangled_name, dtype)]
    cols: list = field(default_factory=list)
    binding: str = ""
    output: list = field(default_factory=list)


@dataclass
class Filter(Node):
    child: Node = None
    predicate: ir.IR = None

    @property
    def output(self):
        return self.child.output

    @property
    def binding(self):
        return self.child.binding


@dataclass
class Project(Node):
    child: Node = None
    exprs: list = field(default_factory=list)   # list[(name, ir.IR)]
    binding: str = ""

    @property
    def output(self):
        return [(n, e.dtype) for n, e in self.exprs]


@dataclass
class Join(Node):
    kind: str = "inner"          # inner|left
    left: Node = None
    right: Node = None
    left_keys: list = field(default_factory=list)    # list[ir.IR]
    right_keys: list = field(default_factory=list)
    residual: Optional[ir.IR] = None  # evaluated over combined columns
    # True when right side is unique on right_keys (PK side): the engine
    # uses the gather join path; otherwise the expanding join path
    right_unique: bool = False
    output: list = field(default_factory=list)
    binding: str = ""
    # kernel choice (engine/kernels.py): stamped by the planner from
    # catalog size estimates; "" = legacy trace heuristics. Lives ON
    # the node so the AOT plan fingerprint distinguishes kernel choices
    kernel: str = ""


@dataclass
class SemiJoin(Node):
    """EXISTS/IN (anti=False) and NOT EXISTS/NOT IN (anti=True).
    Residual may reference both sides (q21's l2.l_suppkey <> l1.l_suppkey)."""
    left: Node = None
    right: Node = None
    left_keys: list = field(default_factory=list)
    right_keys: list = field(default_factory=list)
    residual: Optional[ir.IR] = None
    anti: bool = False
    # kernel choice (engine/kernels.py): "bitmask" membership tables vs
    # "sortmerge" gather machinery; "" = legacy
    kernel: str = ""

    @property
    def output(self):
        return self.left.output

    @property
    def binding(self):
        return self.left.binding


@dataclass
class AggSpec:
    func: str                    # sum|avg|min|max|count
    arg: Optional[ir.IR]         # None for count(*)
    distinct: bool = False
    dtype: DType = None


@dataclass
class Aggregate(Node):
    child: Node = None
    group_keys: list = field(default_factory=list)   # list[(name, ir.IR)]
    aggs: list = field(default_factory=list)         # list[(name, AggSpec)]
    binding: str = ""
    # kernel choice (engine/kernels.py): "segscan" scan-based grouped
    # min/max vs "scatter" segment_min/max; "" = legacy (scatter)
    kernel: str = ""

    @property
    def output(self):
        return ([(n, e.dtype) for n, e in self.group_keys]
                + [(n, a.dtype) for n, a in self.aggs])


@dataclass
class WindowSpec:
    """One window column. frame: None = SQL default (whole partition
    when there is no ORDER BY; RANGE UNBOUNDED PRECEDING..CURRENT ROW —
    running with ties sharing a value — when there is); 'cum' = ROWS
    UNBOUNDED PRECEDING..CURRENT ROW. Ranking funcs ignore frame."""
    func: str                 # rank|dense_rank|row_number|sum|avg|min|max|count
    arg: Optional[ir.IR]
    partition: list = field(default_factory=list)   # list[ir.IR]
    order: list = field(default_factory=list)  # (ir.IR, asc, nulls_first)
    frame: Optional[str] = None
    dtype: DType = None


@dataclass
class Window(Node):
    """Namespace-extending operator: keeps the child's row set and adds
    one column per spec under this node's own binding (a Project above
    reads both namespaces)."""
    child: Node = None
    specs: list = field(default_factory=list)       # list[(name, WindowSpec)]
    binding: str = ""

    @property
    def output(self):
        return [(n, s.dtype) for n, s in self.specs]


@dataclass
class Sort(Node):
    child: Node = None
    keys: list = field(default_factory=list)  # list[(ir.IR, ascending, nulls_first)]

    @property
    def output(self):
        return self.child.output

    @property
    def binding(self):
        return self.child.binding


@dataclass
class Limit(Node):
    child: Node = None
    count: int = 0

    @property
    def output(self):
        return self.child.output

    @property
    def binding(self):
        return self.child.binding


@dataclass
class Distinct(Node):
    child: Node = None

    @property
    def output(self):
        return self.child.output

    @property
    def binding(self):
        return self.child.binding


@dataclass
class SetOp(Node):
    kind: str = "union all"     # union|union all|intersect|except
    left: Node = None
    right: Node = None

    @property
    def output(self):
        return self.left.output

    @property
    def binding(self):
        return self.left.binding


@dataclass
class PlannedQuery:
    """Root of one statement: the plan plus its uncorrelated scalar
    subplans (evaluated first, results bound to ScalarRef ids)."""
    root: Node = None
    scalar_subplans: list = field(default_factory=list)  # list[PlannedQuery-ish Node]
    column_names: list = field(default_factory=list)


def children(node: Node):
    for attr in ("child", "left", "right"):
        c = getattr(node, attr, None)
        if isinstance(c, Node):
            yield c


def walk_plan(node: Node):
    yield node
    for c in children(node):
        yield from walk_plan(c)


def all_exprs(node: Node):
    """Yield every ir.IR expression attached to a single node."""
    if isinstance(node, Scan):
        yield from node.filters
    elif isinstance(node, Filter):
        yield node.predicate
    elif isinstance(node, Project):
        for _, e in node.exprs:
            yield e
    elif isinstance(node, (Join, SemiJoin)):
        yield from node.left_keys
        yield from node.right_keys
        if node.residual is not None:
            yield node.residual
    elif isinstance(node, Aggregate):
        for _, e in node.group_keys:
            yield e
        for _, a in node.aggs:
            if a.arg is not None:
                yield a.arg
    elif isinstance(node, Sort):
        for e, _, _ in node.keys:
            yield e
    elif isinstance(node, Window):
        for _, s in node.specs:
            if s.arg is not None:
                yield s.arg
            yield from s.partition
            for e, _, _ in s.order:
                yield e
