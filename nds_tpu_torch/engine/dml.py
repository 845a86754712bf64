"""Host-side DML: INSERT INTO ... SELECT and DELETE FROM ... WHERE.

Port copy of ``nds_tpu/engine/dml.py``: it imports nothing of
``nds_tpu``. The upstream benchmark runs data maintenance through Spark
DML against an Iceberg/Delta warehouse (`nds/nds_maintenance.py:191-268`).
Here the authoritative warehouse is host columnar memory (HostTable)
persisted as parquet, and the engines consume uploaded snapshots, so
DML is:

- INSERT: execute the planned SELECT on the session's engine (the LF_*
  refresh views run as ordinary queries, on the card under the device
  engine), then append the result to the target HostTable;
- DELETE: evaluate the predicate per row on the host with SQL
  three-valued logic (a row is deleted only where the predicate is
  TRUE; NULL keeps the row), running any subqueries through the
  session's executor factory first (on the card under the device
  engine).

Mutations land as DELTAS (``columnar/delta.py``), not rewrites: inserts
append a segment, deletes flip bits in a deleted-row bitmask the scans
consult. The session scopes invalidation to the mutated table. Both
fire the ``dml.apply`` fault point (``resilience/faults.py``) first.
"""

from __future__ import annotations

import numpy as np

from nds_tpu_torch.columnar import delta
from nds_tpu_torch.engine.types import (
    DateType, DecimalType, FloatType, IntType, StringType,
)
from nds_tpu_torch.io.host_table import HostTable, from_arrays
from nds_tpu_torch.resilience import faults
from nds_tpu_torch.sql import ast


class DmlError(ValueError):
    pass


# ------------------------------------------------------------------ insert

def result_to_arrays(result, schema) -> dict:
    """ResultTable -> from_arrays()-shaped dict positionally cast to the
    target schema (INSERT resolves columns by position, like the
    reference's ``insert into T (select * from view)``)."""
    arrays: dict[str, np.ndarray] = {}
    for f, col, dt, valid in zip(schema.fields, result.cols,
                                 result.dtypes, result.valids):
        a = np.asarray(col)
        if isinstance(f.dtype, StringType):
            out = a.astype(object)
        elif isinstance(f.dtype, DecimalType):
            if isinstance(dt, DecimalType):
                # rescale between source/target decimal scales
                shift = f.dtype.scale - dt.scale
                ints = np.asarray(a, dtype=np.int64)
                out = (ints * 10**shift if shift >= 0
                       else ints // 10**(-shift))
            elif isinstance(dt, (IntType, DateType)):
                out = (np.asarray(a, dtype=np.int64)
                       * 10**f.dtype.scale)
            else:
                out = np.round(np.asarray(a, dtype=np.float64)
                               * 10**f.dtype.scale).astype(np.int64)
        elif isinstance(f.dtype, FloatType):
            if isinstance(dt, DecimalType):
                out = np.asarray(a, dtype=np.float64) / 10**dt.scale
            else:
                out = np.asarray(a, dtype=np.float64)
        elif isinstance(f.dtype, (IntType, DateType)):
            if isinstance(dt, DecimalType):
                out = (np.asarray(a, dtype=np.int64)
                       // 10**dt.scale)
            else:
                out = np.asarray(np.nan_to_num(
                    a.astype(np.float64)) if a.dtype.kind == "f" else a,
                    dtype=np.int64)
        else:
            out = a
        arrays[f.name] = out
        if valid is not None:
            arrays[f.name + "#null"] = np.asarray(valid, dtype=bool)
    return arrays


def segment_from_result(table: HostTable, result) -> HostTable:
    """Build the O(result)-sized segment table an INSERT appends —
    encoding only the NEW rows (the base table is never decoded)."""
    return from_arrays(table.name, table.schema,
                       result_to_arrays(result, table.schema))


def append_rows(table: HostTable, result,
                seg_id: str = "") -> HostTable:
    """New effective HostTable with the result's rows appended as a
    delta segment (`columnar/delta.py`): base arrays concatenate
    in-place-free, string dictionaries merge at dictionary size, and
    encoding specs re-derive from exact merged statistics — no
    full-table re-encode."""
    faults.fault_point("dml.apply", table=table.name, action="insert",
                       rows=result.nrows)
    return delta.append_segment(table, segment_from_result(table, result),
                                seg_id=seg_id)


# ------------------------------------------------------------------ delete

def apply_delete(table: HostTable, keep: np.ndarray) -> HostTable:
    """New effective HostTable with non-kept rows marked deleted in the
    delta bitmask — column arrays (and their memoized encoding specs)
    are shared untouched; scans consult the mask."""
    faults.fault_point("dml.apply", table=table.name, action="delete",
                       rows=int((~np.asarray(keep, bool)).sum()))
    return delta.apply_delete(table, keep)


def filter_rows(table: HostTable, keep: np.ndarray) -> HostTable:
    """PHYSICAL row filter (gather): compaction's building block; DML
    itself uses ``apply_delete``'s logical mask."""
    cols = {}
    for f in table.schema:
        col = table.columns[f.name]
        mask = (col.null_mask[keep] if col.null_mask is not None
                else None)
        cols[f.name] = type(col)(col.dtype, col.values[keep],
                                 col.dictionary, mask)
    return HostTable(table.name, table.schema, cols)


def _coerce_pair(lv, lt, rv, rt):
    """Align two comparison operands the way SQL implicitly casts:
    scaled decimals against plain numerics (rescale the plain side),
    DATE against ISO string literals (parse to epoch days). Each side
    is (values, dtype) with dtype None for bare literals."""
    from nds_tpu_torch.sql.planner import _date_to_days

    def to_days(v):
        if isinstance(v, np.ndarray) and v.dtype == object:
            return np.array([_date_to_days(x) for x in v],
                            dtype=np.int64)
        return _date_to_days(v)

    if isinstance(lt, DecimalType) and not isinstance(rt, DecimalType):
        rv = (np.asarray(rv, dtype=np.float64)
              * 10**lt.scale).astype(np.int64)
    elif isinstance(rt, DecimalType) and not isinstance(lt, DecimalType):
        lv = (np.asarray(lv, dtype=np.float64)
              * 10**rt.scale).astype(np.int64)
    elif isinstance(lt, DecimalType) and isinstance(rt, DecimalType):
        if lt.scale != rt.scale:
            s = max(lt.scale, rt.scale)
            lv = np.asarray(lv, np.int64) * 10**(s - lt.scale)
            rv = np.asarray(rv, np.int64) * 10**(s - rt.scale)
    elif isinstance(lt, DateType) and rt is None:
        rv = to_days(rv)
    elif isinstance(rt, DateType) and lt is None:
        lv = to_days(lv)
    return lv, rv


class _PredEval:
    """SQL 3-valued predicate evaluator over a HostTable's columns.
    ``eval`` returns (values, valid, dtype) triples — dtype carries
    decimal scales and DATE-ness into comparisons so literals coerce
    like the planner's `_coerce_date_cmp`/decimal rescaling do.
    Subqueries run through the session's engine first (`DF_SS.sql`
    shapes: IN-subquery and scalar min/max subqueries)."""

    def __init__(self, session, table: HostTable):
        self.session = session
        self.table = table
        self.n = table.nrows

    def _col(self, name: str):
        try:
            col = self.table.columns[name]
        except KeyError:
            raise DmlError(
                f"DELETE predicate references unknown column {name!r}")
        vals = col.decode() if col.is_string else col.values
        valid = (col.null_mask if col.null_mask is not None
                 else np.ones(self.n, dtype=bool))
        return vals, valid, col.dtype

    def _subquery_result(self, sel: ast.Select):
        planned = self.session.plan_ast(sel)
        executor = self.session._executor_factory(self.session.tables)
        return executor.execute(planned)

    def eval(self, e: ast.Expr):
        ones = lambda: np.ones(self.n, dtype=bool)
        if isinstance(e, ast.Column):
            return self._col(e.name)
        if isinstance(e, ast.Literal):
            v = e.value
            if isinstance(v, str):
                arr = np.full(self.n, v, dtype=object)
            else:
                arr = np.full(self.n, v)
            return arr, ones(), None
        if isinstance(e, ast.IsNull):
            _v, valid, _t = self.eval(e.expr)
            out = (valid if e.negated else ~valid)
            return out, ones(), None
        if isinstance(e, ast.UnaryOp) and e.op == "not":
            v, valid, _t = self.eval(e.expr)
            return ~v.astype(bool), valid, None
        if isinstance(e, ast.BinOp):
            return self._binop(e)
        if isinstance(e, ast.Between):
            lo = ast.BinOp(">=", e.expr, e.low)
            hi = ast.BinOp("<=", e.expr, e.high)
            v, valid, _t = self._binop(ast.BinOp("and", lo, hi))
            if e.negated:
                v = ~v
            return v, valid, None
        if isinstance(e, ast.InList):
            v, valid, t = self.eval(e.expr)
            vals = np.asarray([lit.value for lit in e.items])
            vals, v = _coerce_pair(vals, None, v, t)
            out = np.isin(v, vals)
            if e.negated:
                out = ~out
            return out, valid, None
        if isinstance(e, ast.InSubquery):
            v, valid, t = self.eval(e.expr)
            sub = self._subquery_result(e.query)
            if len(sub.cols) != 1:
                raise DmlError("IN subquery must produce one column")
            sv = np.asarray(sub.cols[0])
            svalid = sub.valids[0]
            if svalid is not None:
                sv = sv[svalid]
            v, sv = _coerce_pair(v, t, sv, sub.dtypes[0])
            out = np.isin(v, sv)
            if e.negated:
                # NOT IN with any NULL in the subquery -> never TRUE
                if svalid is not None and not svalid.all():
                    return np.zeros(self.n, dtype=bool), valid, None
                out = ~out
            return out, valid, None
        if isinstance(e, ast.ScalarSubquery):
            sub = self._subquery_result(e.query)
            if sub.nrows != 1 or len(sub.cols) != 1:
                raise DmlError(
                    f"scalar subquery returned {sub.nrows} rows")
            val = np.asarray(sub.cols[0])[0]
            ok = sub.valids[0] is None or bool(sub.valids[0][0])
            return (np.full(self.n, val),
                    np.full(self.n, ok, dtype=bool), sub.dtypes[0])
        raise DmlError(
            f"unsupported DELETE predicate node {type(e).__name__}")

    def _binop(self, e: ast.BinOp):
        op = e.op.lower()
        lv, lval, lt = self.eval(e.left)
        rv, rval, rt = self.eval(e.right)
        if op in ("and", "or"):
            lb, rb = lv.astype(bool), rv.astype(bool)
            if op == "and":
                v = lb & rb
                # NULL AND FALSE = FALSE (valid); NULL AND TRUE = NULL
                valid = (lval & rval) | (lval & ~lb) | (rval & ~rb)
            else:
                v = lb | rb
                valid = (lval & rval) | (lval & lb) | (rval & rb)
            return v, valid, None
        lv, rv = _coerce_pair(lv, lt, rv, rt)
        valid = lval & rval
        cmp = {"=": np.equal, "<>": np.not_equal, "!=": np.not_equal,
               "<": np.less, "<=": np.less_equal, ">": np.greater,
               ">=": np.greater_equal}.get(op)
        if cmp is None:
            raise DmlError(f"unsupported DELETE operator {op!r}")
        return cmp(lv, rv), valid, None


def delete_mask(session, table: HostTable,
                where: ast.Expr | None) -> np.ndarray:
    """True where the row survives the DELETE."""
    if where is None:
        return np.zeros(table.nrows, dtype=bool)
    v, valid, _t = _PredEval(session, table).eval(where)
    # delete iff predicate is TRUE (valid & value); NULL/FALSE keep
    return ~(v.astype(bool) & valid)
