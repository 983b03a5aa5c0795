"""pyspark.sql.functions-compatible surface (the subset of
``spark_rapids_tpu/functions.py`` that TPC-H q1, q3, q4, q6, q13 and q18
use)."""

from __future__ import annotations

from typing import Any

from .expressions import aggregates as _G
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
