"""Grouping-set markers (port of ``GroupingID`` and ``GroupingExpr`` from
``spark_rapids_tpu/expressions/generators.py``; the generators themselves,
explode, stack and json_tuple, are not yet ported).

Neither is evaluated: ``GroupedData``'s grouping-sets lowering
(``session.py``) rewrites ``grouping_id()`` to the Expand's ``_gid``
column and ``grouping(k)`` to ``CAST((_gid >> bit) & 1 AS TINYINT)``.
"""

from __future__ import annotations

from ..types import ByteT, DataType, LongT
from .base import Expression, UnaryExpression


class GroupingID(Expression):
    """``grouping_id()``: the bitmask of the grouping columns nulled out in
    the row's grouping set."""

    children = ()

    @property
    def dtype(self) -> DataType:
        return LongT

    @property
    def nullable(self) -> bool:
        return False

    def pretty(self) -> str:
        return "grouping_id()"


class GroupingExpr(UnaryExpression):
    """``grouping(col)``: 1 when ``col`` is nulled out in the row's
    grouping set, else 0."""

    @property
    def dtype(self) -> DataType:
        return ByteT

    @property
    def nullable(self) -> bool:
        return False

    def pretty(self) -> str:
        return f"grouping({self.child.pretty()})"
