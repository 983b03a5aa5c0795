"""Aggregate function declarations (port of the Sum/Count/Min/Max/Average
part of ``spark_rapids_tpu/expressions/aggregates.py``). They are driven by
the aggregate execs, not evaluated directly."""

from __future__ import annotations

from ..types import DataType, DecimalType, DoubleT, IntegralType, LongT
from .base import Expression


class AggregateFunction(Expression):
    """Declarative aggregate; ``update_op`` names its device reduction."""

    update_op: str = ""

    def __init__(self, *children: Expression):
        self.children = tuple(children)

    @property
    def child(self) -> Expression:
        return self.children[0]

    def pretty(self) -> str:
        return f"{type(self).__name__.lower()}({', '.join(c.pretty() for c in self.children)})"


class Sum(AggregateFunction):
    update_op = "sum"

    @property
    def dtype(self) -> DataType:
        ct = self.child.dtype
        if isinstance(ct, IntegralType):
            return LongT
        if isinstance(ct, DecimalType):
            return DecimalType(min(ct.precision + 10, 38), ct.scale)
        return DoubleT


class Count(AggregateFunction):
    update_op = "count"

    @property
    def dtype(self) -> DataType:
        return LongT

    @property
    def nullable(self) -> bool:
        return False


class Min(AggregateFunction):
    update_op = "min"

    @property
    def dtype(self) -> DataType:
        return self.child.dtype


class Max(AggregateFunction):
    update_op = "max"

    @property
    def dtype(self) -> DataType:
        return self.child.dtype


class Average(AggregateFunction):
    update_op = "avg"

    @property
    def dtype(self) -> DataType:
        ct = self.child.dtype
        if isinstance(ct, DecimalType):
            return DecimalType(min(ct.precision + 4, 38), min(ct.scale + 4, 38))
        return DoubleT
