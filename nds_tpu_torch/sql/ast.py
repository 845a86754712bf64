"""SQL AST for the TPC dialect subset.

Port copy of ``nds_tpu/sql/ast.py``: it imports nothing of ``nds_tpu``.

The reference delegates SQL parsing/planning to Spark Catalyst; there is no
Spark here, so the frontend is ours. Coverage target is the closed world of
the benchmark queries (TPC-H 22 + TPC-DS 99 as they land): select lists
with aliases, comma-FROM + explicit JOIN ... ON, derived tables, where /
group by / having / order by / limit, aggregates (incl. DISTINCT), CASE,
EXISTS / IN / scalar subqueries (correlated and not), date/interval
arithmetic, LIKE, EXTRACT, SUBSTRING, CTEs and set operations.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union


# --- expressions -----------------------------------------------------------

class Expr:
    pass


@dataclass
class Column(Expr):
    name: str
    table: Optional[str] = None  # qualifier as written (table name or alias)

    def __repr__(self):
        return f"{self.table}.{self.name}" if self.table else self.name


@dataclass
class Literal(Expr):
    value: object          # int | float-as-Decimal-string | str | None
    kind: str = "auto"     # auto|int|decimal|string|date|interval|null

    def __repr__(self):
        return f"{self.value!r}"


@dataclass
class Interval(Expr):
    amount: int
    unit: str              # day|month|year


@dataclass
class BinOp(Expr):
    op: str                # + - * / and or = <> < <= > >=
    left: Expr
    right: Expr

    def __repr__(self):
        return f"({self.left} {self.op} {self.right})"


@dataclass
class UnaryOp(Expr):
    op: str                # not | -
    operand: Expr


@dataclass
class FuncCall(Expr):
    name: str              # lower-cased
    args: list[Expr] = field(default_factory=list)
    distinct: bool = False
    star: bool = False     # count(*)

    def __repr__(self):
        inner = "*" if self.star else ", ".join(map(repr, self.args))
        d = "distinct " if self.distinct else ""
        return f"{self.name}({d}{inner})"


@dataclass
class CaseWhen(Expr):
    whens: list[tuple[Expr, Expr]]
    else_: Optional[Expr] = None


@dataclass
class Cast(Expr):
    operand: Expr
    type_name: str


@dataclass
class Between(Expr):
    expr: Expr
    low: Expr
    high: Expr
    negated: bool = False


@dataclass
class InList(Expr):
    expr: Expr
    items: list[Expr]
    negated: bool = False


@dataclass
class Like(Expr):
    expr: Expr
    pattern: str
    negated: bool = False


@dataclass
class IsNull(Expr):
    expr: Expr
    negated: bool = False


@dataclass
class Extract(Expr):
    part: str              # year|month|day
    operand: Expr


@dataclass
class Substring(Expr):
    operand: Expr
    start: Expr
    length: Optional[Expr] = None


@dataclass
class ScalarSubquery(Expr):
    query: "Select"


@dataclass
class InSubquery(Expr):
    expr: Expr
    query: "Select"
    negated: bool = False


@dataclass
class Exists(Expr):
    query: "Select"
    negated: bool = False


@dataclass
class WindowFunc(Expr):
    """func(args) OVER (PARTITION BY ... ORDER BY ... [frame]).

    frame: None = default (whole partition for plain aggregates; the
    ranking functions ignore it); 'cum' = ROWS BETWEEN UNBOUNDED
    PRECEDING AND CURRENT ROW (running aggregate, TPC-DS q51)."""
    name: str
    args: list[Expr] = field(default_factory=list)
    partition_by: list[Expr] = field(default_factory=list)
    order_by: list["OrderItem"] = field(default_factory=list)
    frame: Optional[str] = None


@dataclass
class Star(Expr):
    table: Optional[str] = None


# --- relations -------------------------------------------------------------

@dataclass
class TableRef:
    name: str
    alias: Optional[str] = None

    @property
    def binding(self) -> str:
        return self.alias or self.name


@dataclass
class SubqueryRef:
    query: "Select"
    alias: str

    @property
    def binding(self) -> str:
        return self.alias


@dataclass
class JoinClause:
    kind: str              # inner|left|right|full|cross
    table: Union[TableRef, SubqueryRef]
    on: Optional[Expr] = None


@dataclass
class SelectItem:
    expr: Expr
    alias: Optional[str] = None


@dataclass
class OrderItem:
    expr: Expr
    ascending: bool = True
    nulls_first: Optional[bool] = None


@dataclass
class CreateView:
    """CREATE [TEMP] VIEW name [(col, ...)] AS select — q15 part 1
    (`nds-h/nds_h_power.py:78-82` runs the three statements separately)."""
    name: str
    columns: list[str]
    query: "Select"


@dataclass
class DropView:
    name: str
    if_exists: bool = False


@dataclass
class Insert:
    """INSERT INTO table (select ...) — the LF_* refresh functions'
    second statement (`nds/data_maintenance/LF_SS.sql` last line)."""
    table: str
    query: "Select"


@dataclass
class Delete:
    """DELETE FROM table WHERE pred — the DF_* refresh functions
    (`nds/data_maintenance/DF_SS.sql`)."""
    table: str
    where: Optional[Expr]


@dataclass
class Select:
    items: list[SelectItem] = field(default_factory=list)
    distinct: bool = False
    from_tables: list[Union[TableRef, SubqueryRef]] = field(default_factory=list)
    joins: list[JoinClause] = field(default_factory=list)
    where: Optional[Expr] = None
    group_by: list[Expr] = field(default_factory=list)
    # GROUP BY ROLLUP(...) / GROUPING SETS(...): list of grouping sets,
    # each a list of indexes into group_by. None = plain GROUP BY.
    grouping_sets: Optional[list[list[int]]] = None
    having: Optional[Expr] = None
    order_by: list[OrderItem] = field(default_factory=list)
    limit: Optional[int] = None
    # set operations: (op, select) applied left-to-right; op in
    # union|union all|intersect|except
    set_ops: list[tuple[str, "Select"]] = field(default_factory=list)
    # WITH ctes visible to this select (name -> Select)
    ctes: dict = field(default_factory=dict)
