"""pyspark.sql.functions-compatible surface (the subset of
``spark_rapids_tpu/functions.py`` that the 22 TPC-H queries of
``benchmarks/tpch.py`` and the 99 TPC-DS queries of
``benchmarks/tpcds.py`` use, with the rest of the variance family and of
the window functions)."""

from __future__ import annotations

from typing import Any

from .expressions import aggregates as _G
from .expressions import conditional as _C
from .expressions import nullexprs as _N
from .expressions.base import Literal, UnresolvedAttribute
from .session import Column, _expr


def col(name: str) -> Column:
    return Column(UnresolvedAttribute(name))


column = col


def lit(value: Any) -> Column:
    return Column(Literal(value))


def _expr_or_col(c):
    return UnresolvedAttribute(c) if isinstance(c, str) else _expr(c)


def sum(c) -> Column:  # noqa: A001
    return Column(_G.Sum(_expr_or_col(c)))


def count(c) -> Column:
    return Column(_G.Count(_expr_or_col(c) if not isinstance(c, str) or c != "*"
                           else Literal(1)))


def count_star() -> Column:
    return Column(_G.Count(Literal(1)))


def like(c, pattern: str) -> Column:
    from .expressions.strings import Like
    return Column(Like(_expr_or_col(c), pattern))


def avg(c) -> Column:
    return Column(_G.Average(_expr_or_col(c)))


mean = avg


def min(c) -> Column:  # noqa: A001
    return Column(_G.Min(_expr_or_col(c)))


def max(c) -> Column:  # noqa: A001
    return Column(_G.Max(_expr_or_col(c)))


class WhenBuilder(Column):
    """``when(cond, value)[.when(...)].otherwise(value)``: a CASE WHEN that
    is null where no branch holds until ``otherwise`` gives its ELSE."""

    def __init__(self, branches):
        self._branches = branches
        super().__init__(_C.CaseWhen(branches))

    def when(self, condition, value) -> "WhenBuilder":
        return WhenBuilder(self._branches + [(_expr(condition),
                                              _expr(value))])

    def otherwise(self, value) -> Column:
        return Column(_C.CaseWhen(self._branches, _expr(value)))


def when(condition, value) -> WhenBuilder:
    return WhenBuilder([(_expr(condition), _expr(value))])


def round(c, scale: int = 0) -> Column:  # noqa: A001
    """HALF_UP rounding to ``scale`` decimal places."""
    from .expressions.mathexprs import Round
    return Column(Round(_expr_or_col(c), Literal(scale)))


def substring(c, pos: int, length: int) -> Column:
    """Spark's 1-based ``substring(str, pos, len)``."""
    from .expressions.strings import Substring
    return Column(Substring(_expr_or_col(c), Literal(pos), Literal(length)))


def coalesce(*cols) -> Column:
    return Column(_N.Coalesce(*[_expr(c) for c in cols]))


def isnull(c) -> Column:
    return Column(_N.IsNull(_expr(c)))


def floor(c) -> Column:
    from .expressions.mathexprs import Floor
    return Column(Floor(_expr_or_col(c)))


def abs(c) -> Column:  # noqa: A001
    from .expressions.arithmetic import Abs
    return Column(Abs(_expr_or_col(c)))


def concat(*cols) -> Column:
    from .expressions.strings import ConcatStr
    return Column(ConcatStr(*[_expr_or_col(c) for c in cols]))


# --- the variance family ---------------------------------------------------

def stddev(c) -> Column:
    return Column(_G.StddevSamp(_expr_or_col(c)))


stddev_samp = stddev


def stddev_pop(c) -> Column:
    return Column(_G.StddevPop(_expr_or_col(c)))


def variance(c) -> Column:
    return Column(_G.VarianceSamp(_expr_or_col(c)))


var_samp = variance


def var_pop(c) -> Column:
    return Column(_G.VariancePop(_expr_or_col(c)))


# --- window functions ------------------------------------------------------

def row_number() -> Column:
    from .window import RowNumber
    return Column(RowNumber())


def rank() -> Column:
    from .window import Rank
    return Column(Rank())


def dense_rank() -> Column:
    from .window import DenseRank
    return Column(DenseRank())


def ntile(n: int) -> Column:
    from .window import NTile
    return Column(NTile(Literal(int(n))))


def percent_rank() -> Column:
    from .window import PercentRank
    return Column(PercentRank())


def cume_dist() -> Column:
    from .window import CumeDist
    return Column(CumeDist())


def lead(c, offset: int = 1, default=None) -> Column:
    from .window import Lead
    d = Literal(default) if default is not None else None
    return Column(Lead(_expr_or_col(c), offset, d))


def lag(c, offset: int = 1, default=None) -> Column:
    from .window import Lag
    d = Literal(default) if default is not None else None
    return Column(Lag(_expr_or_col(c), offset, d))


# --- grouping sets ---------------------------------------------------------

def grouping_id() -> Column:
    from .expressions.generators import GroupingID
    return Column(GroupingID())


def grouping(c) -> Column:
    from .expressions.generators import GroupingExpr
    return Column(GroupingExpr(_expr_or_col(c)))
