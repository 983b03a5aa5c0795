"""Logical size estimates (port of ``estimate_logical_rows`` and
``estimate_logical_bytes`` from ``spark_rapids_tpu/plan/cbo.py``).

They drive the optimizer's build-side swap and the planner's
broadcast-versus-shuffle choice when a build side cannot be sized from
its table. The reference's cost-based optimizer over the tagged plan
(``CostBasedOptimizer``) is not yet ported.
"""

from __future__ import annotations

from typing import Optional

#: the reference's RowCountPlanVisitor selectivity defaults
FILTER_SELECTIVITY = 0.5
AGG_RATIO = 0.1
#: per-row width of a variable-width column
_VAR_WIDTH_BYTES = 24.0


def estimate_logical_rows(plan) -> Optional[float]:
    """Cardinality estimate of a logical subtree; None when nothing in it
    can be sized."""
    name = type(plan).__name__
    children = [estimate_logical_rows(c) for c in plan.children]
    child = children[0] if children else None
    if name == "LocalRelation":
        return float(plan.table.num_rows)
    if name == "DeviceCachedRelation":
        return float(plan.num_rows)
    if name == "FileScan":
        from ..io.parquet import file_scan_rows
        return file_scan_rows(plan.paths)
    if child is None:
        return None
    if name == "Filter":
        return child * FILTER_SELECTIVITY
    if name == "Aggregate":
        return max(1.0, child * AGG_RATIO)
    if name == "Join":
        sized = [c for c in children if c is not None]
        return max(sized) if sized else None
    if name == "Union":
        return float(sum(c for c in children if c is not None))
    if name == "Limit":
        return float(min(plan.n, child))
    return child


def _attr_width(dtype) -> float:
    """The reference's per-type row width, read off the type's name."""
    tname = type(dtype).__name__
    if "Boolean" in tname or "Byte" in tname:
        return 1.0
    if "Short" in tname:
        return 2.0
    if "Int" in tname or "Float" in tname or "Date" in tname:
        return 4.0
    return _VAR_WIDTH_BYTES if ("String" in tname or "Binary" in tname
                                or "Array" in tname or "Map" in tname
                                or "Struct" in tname) else 8.0


def estimate_logical_bytes(plan) -> Optional[float]:
    """Estimated rows × the output schema's row width."""
    rows = estimate_logical_rows(plan)
    if rows is None:
        return None
    row_bytes = sum(_attr_width(a.dtype) for a in plan.output)
    return rows * max(1.0, row_bytes)
