"""Typed expression IR — what the executors actually evaluate.

Port copy of ``nds_tpu/sql/ir.py``: it imports nothing of ``nds_tpu``.

The planner lowers parsed AST expressions into this IR with dtypes
resolved. Design choices are TPU-driven (SURVEY.md §7 "hard parts" #3):

- DECIMAL stays scaled int64 through +,-,* (exact, integer ALU path);
  division and AVG convert to float64 — TPC validation is epsilon-based
  (`nds/nds_validate.py:194-215`), so float division is within contract.
- Dates are epoch-day int32; EXTRACT lowers to integer civil-date math.
- String predicates never touch string data at run time: the planner binds
  them against the column dictionary (LIKE/substring/IN evaluate on the
  host dictionary once, producing code sets), so devices compare int32
  codes only. That binding happens in the engine layer; here LIKE et al.
  remain symbolic.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from nds_tpu_torch.engine.types import (
    BOOL, DATE, DType, FLOAT64, INT32, INT64, DecimalType, IntType,
    FloatType, StringType, DateType, BoolType,
)


class IR:
    dtype: DType


@dataclass
class ColRef(IR):
    binding: str
    name: str
    dtype: DType = None

    def __repr__(self):
        return f"{self.binding}.{self.name}"


@dataclass
class Lit(IR):
    value: object      # python int (scaled for decimals) | str | None | bool
    dtype: DType = None

    def __repr__(self):
        return f"lit({self.value}:{self.dtype})"


@dataclass
class Arith(IR):
    op: str            # + - * / %
    left: IR
    right: IR
    dtype: DType = None


@dataclass
class Cmp(IR):
    op: str            # = <> < <= > >=
    left: IR
    right: IR
    dtype: DType = BOOL


@dataclass
class BoolOp(IR):
    op: str            # and | or
    args: list[IR] = field(default_factory=list)
    dtype: DType = BOOL


@dataclass
class Not(IR):
    operand: IR
    dtype: DType = BOOL


@dataclass
class Neg(IR):
    operand: IR
    dtype: DType = None


@dataclass
class CaseIR(IR):
    whens: list[tuple[IR, IR]] = field(default_factory=list)
    else_: Optional[IR] = None
    dtype: DType = None


@dataclass
class LikeIR(IR):
    operand: IR
    pattern: str
    negated: bool = False
    dtype: DType = BOOL


@dataclass
class InListIR(IR):
    operand: IR
    values: list[object] = field(default_factory=list)  # python values
    negated: bool = False
    dtype: DType = BOOL


@dataclass
class IsNullIR(IR):
    operand: IR
    negated: bool = False
    dtype: DType = BOOL


@dataclass
class ExtractIR(IR):
    part: str
    operand: IR
    dtype: DType = INT32


@dataclass
class SubstrIR(IR):
    operand: IR
    start: int
    length: Optional[int]
    dtype: DType = None


@dataclass
class StrMapIR(IR):
    """upper()/lower(): per-dictionary-entry string transform (device:
    codes untouched, dictionary rewritten + re-sorted)."""
    op: str              # upper | lower
    operand: IR
    dtype: DType = None


@dataclass
class ConcatIR(IR):
    """String concatenation with a LITERAL prefix/suffix (q5's
    'store' || s_store_id ids). Restricted to literal ⊕ column so the
    device engine can implement it as a dictionary transform (codes
    untouched, only the host-side dictionary rewritten)."""
    prefix: str
    operand: IR          # string-typed column expression
    suffix: str
    dtype: DType = None


@dataclass
class CastIR(IR):
    operand: IR
    dtype: DType = None


@dataclass
class AggRef(IR):
    """Reference to aggregate #index of the enclosing Aggregate node."""
    index: int
    dtype: DType = None

    def __repr__(self):
        return f"agg#{self.index}"


@dataclass
class ScalarRef(IR):
    """Result of an uncorrelated scalar subquery, planned separately and
    bound at execution time (plan_id indexes LogicalPlan.scalar_subplans)."""
    plan_id: int
    dtype: DType = None

    def __repr__(self):
        return f"scalar#{self.plan_id}"


@dataclass
class ParamRef(IR):
    """A hoisted query literal (sql/params.py): the VALUE lives in
    ``PlannedQuery.param_values[index]`` (a plain attribute, invisible
    to the plan fingerprint), so same-template queries with different
    literals share one canonical plan — and one compiled program, with
    the literal supplied as a runtime scalar input."""
    index: int
    dtype: DType = None

    def __repr__(self):
        return f"param#{self.index}:{self.dtype}"


@dataclass
class DictParamIR(IR):
    """A hoisted STRING predicate over a dictionary-encoded scan
    column: LIKE pattern, comparison literal, or IN-list, with the
    literal(s) in ``param_values[index]``. The device program takes a
    boolean membership table over the operand's dictionary as a runtime
    input; sql/params.bind_params computes that table on the host per
    request (like_mask / lexicographic compare / isin over the derived
    dictionary). ``table``/``column`` name the base scan column whose
    dictionary the operand's transform chain starts from."""
    operand: IR = None       # ColRef chain (Substr/StrMap/Concat ok)
    table: str = ""
    column: str = ""
    kind: str = "cmp"        # like | cmp | inlist
    op: str = "="            # comparison op (kind == "cmp")
    index: int = 0
    negated: bool = False
    # binder-side transform spec: the operand's string-transform chain
    # RESOLVED through derived-table aliases down to the base scan
    # column, innermost-first, as opaque tuples (("substr", start,
    # length) | ("map", op) | ("concat", prefix, suffix)) —
    # sql/params.derive_dictionary replays it on the host dictionary.
    # A spec, not IR: nothing evaluates it in any row namespace.
    chain: tuple = ()
    dtype: DType = BOOL

    def __repr__(self):
        return (f"dictparam#{self.index}:{self.kind}"
                f"[{self.table}.{self.column}]")


@dataclass
class InListParamIR(IR):
    """A hoisted NUMERIC/date IN-list: ``param_values[index]`` holds the
    value tuple; the device program takes a fixed-width vector input
    (``width`` is part of the plan, so variants with equal list lengths
    share a program)."""
    operand: IR = None
    index: int = 0
    width: int = 0
    negated: bool = False
    dtype: DType = BOOL

    def __repr__(self):
        return f"inparam#{self.index}x{self.width}"


@dataclass
class WindowRef(IR):
    """Reference to window column #index of the enclosing Window node."""
    index: int
    dtype: DType = None

    def __repr__(self):
        return f"win#{self.index}"


@dataclass
class GroupingRef(IR):
    """grouping(<key>) marker: 0 when the key participates in the row's
    grouping set, 1 when rolled up (NULL-filled). Resolved per grouping-
    set branch to a constant column (key_index = index into the select's
    group_by list)."""
    key_index: int
    dtype: DType = INT32

    def __repr__(self):
        return f"grouping#{self.key_index}"


def is_decimal(t: DType) -> bool:
    return isinstance(t, DecimalType)


def common_scale(a: DType, b: DType) -> int:
    sa = a.scale if is_decimal(a) else 0
    sb = b.scale if is_decimal(b) else 0
    return max(sa, sb)


def arith_type(op: str, lt: DType, rt: DType) -> DType:
    """Result dtype of an arithmetic op, per the decimal policy above."""
    if isinstance(lt, DateType) or isinstance(rt, DateType):
        return DATE  # date +/- days
    if op == "/":
        return FLOAT64
    if isinstance(lt, FloatType) or isinstance(rt, FloatType):
        return FLOAT64
    if is_decimal(lt) or is_decimal(rt):
        if op == "*":
            return DecimalType(38, (lt.scale if is_decimal(lt) else 0)
                               + (rt.scale if is_decimal(rt) else 0))
        return DecimalType(38, common_scale(lt, rt))
    if isinstance(lt, IntType) and isinstance(rt, IntType):
        return INT64 if max(lt.bits, rt.bits) > 32 else INT32
    raise TypeError(f"cannot apply {op} to {lt} and {rt}")


def agg_type(func: str, arg_t: DType | None) -> DType:
    if func == "count":
        return INT64
    if func in ("avg", "stddev_samp", "stddev"):
        return FLOAT64
    if func in ("sum", "min", "max"):
        if arg_t is None:
            raise TypeError(f"{func} requires an argument type")
        if isinstance(arg_t, IntType):
            return INT64 if func == "sum" else arg_t
        return arg_t
    raise TypeError(f"unknown aggregate {func}")


def walk(e: IR):
    """Yield e and all IR descendants."""
    yield e
    for f in vars(e).values():
        if isinstance(f, IR):
            yield from walk(f)
        elif isinstance(f, list):
            for x in f:
                if isinstance(x, IR):
                    yield from walk(x)
                elif isinstance(x, tuple):
                    for y in x:
                        if isinstance(y, IR):
                            yield from walk(y)
