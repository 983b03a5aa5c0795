"""pyspark.sql.functions-compatible surface (the subset of
``spark_rapids_tpu/functions.py`` that the 22 TPC-H queries of
``benchmarks/tpch.py`` use)."""

from __future__ import annotations

from typing import Any

from .expressions import aggregates as _G
from .expressions import conditional as _C
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
