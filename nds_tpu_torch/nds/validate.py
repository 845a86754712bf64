"""NDS output validation rules, for results held in memory.

Port of the rules of ``nds_tpu/nds/validate.py``: the epsilon compare of
``utils/validate_core.py`` with the reference validator's carve-outs,
q65 compared on its row count only (ties at the LIMIT edge) and q78's
rounded-ratio column 3 at rel tol 0.01001. The file-based stream
validator waits for the slice that ports the result writers.
"""

from __future__ import annotations

from nds_tpu_torch.utils.validate_core import frames_equal

SKIP_QUERIES = {"query65"}
# q78 emits a rounded ratio column (positional 3): both engines round a
# near-tie differently, tolerance widened
COLUMN_REL_TOL = {("query78", 3): 0.01001}


def unit_differs(got, exp, unit: str,
                 epsilon: float = 0.00001) -> "str | None":
    """None when a power-run unit's result frame (``unit`` is "7" or
    "14_part1") matches the oracle's under the validator's rules, else a
    one-line reason."""
    qname = "query" + unit.split("_part")[0]
    if qname in SKIP_QUERIES:
        if len(got) != len(exp):
            return f"row count {len(got)} vs {len(exp)}"
        return None
    tols = {col: tol for (q, col), tol in COLUMN_REL_TOL.items()
            if q == qname}
    return frames_equal(got, exp, epsilon, column_rel_tol=tols)
