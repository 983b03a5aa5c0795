"""Window specification API, pyspark.sql.Window-shaped (port of
``spark_rapids_tpu/window.py``).

Frames: ROWS frames with Spark's boundary constants, and the three RANGE
frames the reference takes (unbounded preceding to the current row,
unbounded preceding to unbounded following, the current row to unbounded
following). With no frame, a spec with ORDER BY is a RANGE frame from
unbounded preceding to the current row (tied rows share the value); one
without is the whole partition (``execs/window.py`` decides this).
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from .expressions.base import Expression

UNBOUNDED_PRECEDING = -sys.maxsize
UNBOUNDED_FOLLOWING = sys.maxsize
CURRENT_ROW = 0


class WindowSpec:
    def __init__(self, partition_by: Sequence[Expression] = (),
                 order_by: Sequence = (), frame: Optional[tuple] = None,
                 frame_type: str = "rows"):
        self.partition_by = list(partition_by)
        self.order_by = list(order_by)
        self.frame = frame  # (start, end) offsets; None: the default frame
        self.frame_type = frame_type

    def partitionBy(self, *cols) -> "WindowSpec":
        from .session import _col_exprs
        return WindowSpec(_col_exprs(cols), self.order_by, self.frame,
                          self.frame_type)

    def orderBy(self, *cols) -> "WindowSpec":
        from .plan.logical import SortOrder
        from .session import _col_exprs
        orders = [c if isinstance(c, SortOrder)
                  else SortOrder(_col_exprs([c])[0], True) for c in cols]
        return WindowSpec(self.partition_by, orders, self.frame,
                          self.frame_type)

    def rowsBetween(self, start: int, end: int) -> "WindowSpec":
        return WindowSpec(self.partition_by, self.order_by, (start, end),
                          "rows")

    def rangeBetween(self, start: int, end: int) -> "WindowSpec":
        if (start, end) not in ((UNBOUNDED_PRECEDING, CURRENT_ROW),
                                (UNBOUNDED_PRECEDING, UNBOUNDED_FOLLOWING),
                                (CURRENT_ROW, UNBOUNDED_FOLLOWING)):
            raise NotImplementedError(
                "general range frames not yet supported; use rowsBetween")
        return WindowSpec(self.partition_by, self.order_by, (start, end),
                          "range")


class Window:
    unboundedPreceding = UNBOUNDED_PRECEDING
    unboundedFollowing = UNBOUNDED_FOLLOWING
    currentRow = CURRENT_ROW

    @staticmethod
    def partitionBy(*cols) -> WindowSpec:
        return WindowSpec().partitionBy(*cols)

    @staticmethod
    def orderBy(*cols) -> WindowSpec:
        return WindowSpec().orderBy(*cols)


class WindowFunction(Expression):
    """Ranking and offset functions: driven by the window exec, never
    evaluated directly."""

    name = ""

    def __init__(self, *children: Expression):
        self.children = tuple(children)

    def pretty(self) -> str:
        return f"{self.name}({', '.join(c.pretty() for c in self.children)})"


class _IntRank(WindowFunction):
    @property
    def dtype(self):
        from .types import IntegerT
        return IntegerT

    @property
    def nullable(self) -> bool:
        return False


class RowNumber(_IntRank):
    name = "row_number"


class Rank(_IntRank):
    name = "rank"


class DenseRank(_IntRank):
    name = "dense_rank"


class NTile(WindowFunction):
    name = "ntile"

    def __init__(self, n: Expression):
        super().__init__(n)

    @property
    def dtype(self):
        from .types import IntegerT
        return IntegerT


class _Fraction(WindowFunction):
    @property
    def dtype(self):
        from .types import DoubleT
        return DoubleT

    @property
    def nullable(self) -> bool:
        return False


class PercentRank(_Fraction):
    """(rank - 1) / (partition size - 1); 0.0 in a one-row partition."""
    name = "percent_rank"


class CumeDist(_Fraction):
    """The rows ordered at or before the current one (its peers included)
    over the partition's size."""
    name = "cume_dist"


class _Offset(WindowFunction):
    def __init__(self, child: Expression, offset: int = 1,
                 default: Optional[Expression] = None):
        super().__init__(child)
        self.offset = offset
        self.default = default

    @property
    def dtype(self):
        return self.children[0].dtype


class Lead(_Offset):
    name = "lead"


class Lag(_Offset):
    name = "lag"


class WindowExpression(Expression):
    """``fn OVER spec``."""

    def __init__(self, function: Expression, spec: WindowSpec):
        self.children = (function,)
        self.spec = spec

    @property
    def function(self) -> Expression:
        return self.children[0]

    @property
    def dtype(self):
        return self.function.dtype

    @property
    def nullable(self) -> bool:
        return self.function.nullable

    def pretty(self) -> str:
        parts = []
        if self.spec.partition_by:
            parts.append("PARTITION BY " + ", ".join(
                p.pretty() for p in self.spec.partition_by))
        if self.spec.order_by:
            parts.append("ORDER BY " + ", ".join(
                o.pretty() for o in self.spec.order_by))
        return f"{self.function.pretty()} OVER ({' '.join(parts)})"
