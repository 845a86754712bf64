"""Suite-independent output-diff core.

Port copy of ``nds_tpu/utils/validate_core.py`` (``canon_sort``,
``col_equal`` and the file-reading ``compare_results``, the reference
validator's rules: row-count check, canonical order-insensitive sort,
positional column skips, ``math.isclose`` epsilon on float columns,
per-column tolerance overrides). ``frames_equal`` applies the same rules
to two in-memory frames.
"""

from __future__ import annotations

import math
import os

import pandas as pd

from nds_tpu_torch.io.result_io import read_result


def canon_sort(df: pd.DataFrame) -> pd.DataFrame:
    """Deterministic whole-row sort (floats rounded so epsilon-equal rows
    sort identically on both sides)."""
    if not len(df):
        return df
    keys = {}
    for i, c in enumerate(df.columns):
        col = df.iloc[:, i]
        if col.dtype.kind == "f":
            keys[f"k{i}"] = col.round(4)
        else:
            keys[f"k{i}"] = col.astype(str)
    order = pd.DataFrame(keys).sort_values(list(keys)).index
    return df.loc[order].reset_index(drop=True)


def col_equal(a: pd.Series, b: pd.Series, epsilon: float,
              rel_tol: float | None = None) -> bool:
    na, nb = a.isna().to_numpy(), b.isna().to_numpy()
    if not (na == nb).all():
        return False
    a, b = a[~na], b[~nb]
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        fa = pd.to_numeric(a, errors="coerce").to_numpy(dtype=float)
        fb = pd.to_numeric(b, errors="coerce").to_numpy(dtype=float)
        tol = rel_tol if rel_tol is not None else epsilon
        # abs_tol matters when the true value is exactly 0: backends
        # that reduce in a different order leave ulp-scale residues
        # where the oracle computes a literal 0.0
        return all(math.isclose(x, y, rel_tol=tol, abs_tol=tol)
                   for x, y in zip(fa, fb))
    return list(a.astype(str)) == list(b.astype(str))


def frames_equal(df1: pd.DataFrame, df2: pd.DataFrame,
                 epsilon: float = 0.00001,
                 column_rel_tol: "dict | None" = None,
                 ignore_ordering: bool = True) -> "str | None":
    """None when two result frames match under the validator's rules
    (row count, column count, canonical sort, per-column compare), else
    a one-line reason. ``column_rel_tol`` maps a positional column to a
    relaxed tolerance."""
    if len(df1) != len(df2):
        return f"row count {len(df1)} vs {len(df2)}"
    if df1.shape[1] != df2.shape[1]:
        return f"column count {df1.shape[1]} vs {df2.shape[1]}"
    if ignore_ordering:
        df1, df2 = canon_sort(df1), canon_sort(df2)
    for i in range(df1.shape[1]):
        rel = (column_rel_tol or {}).get(i)
        if not col_equal(df1.iloc[:, i], df2.iloc[:, i], epsilon, rel):
            return f"column {i} ({df1.columns[i]}) differs"
    return None


def compare_results(dir1: str, dir2: str, query_name: str,
                    ignore_ordering: bool = True,
                    epsilon: float = 0.00001,
                    skip_columns: dict | None = None,
                    column_rel_tol: dict | None = None) -> bool:
    """Diff one query's saved outputs. skip_columns maps query name ->
    positional column indexes to drop; column_rel_tol maps (query name,
    column index) -> relaxed tolerance."""
    df1 = read_result(os.path.join(dir1, query_name))
    df2 = read_result(os.path.join(dir2, query_name))
    drop = (skip_columns or {}).get(query_name, [])
    if drop and df1.shape[1] == df2.shape[1]:
        keep = [i for i in range(df1.shape[1]) if i not in drop]
        df1, df2 = df1.iloc[:, keep], df2.iloc[:, keep]
    tols = {i: tol for (q, i), tol in (column_rel_tol or {}).items()
            if q == query_name}
    why = frames_equal(df1, df2, epsilon, tols, ignore_ordering)
    if why is not None:
        print(f"[{query_name}] {why}")
    return why is None
