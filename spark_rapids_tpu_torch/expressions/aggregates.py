"""Aggregate function declarations (port of the Sum/Count/Min/Max/Average/
First/Last and variance-family part of
``spark_rapids_tpu/expressions/aggregates.py``). They are driven by the
aggregate execs, not evaluated directly."""

from __future__ import annotations

from ..types import (DataType, DecimalType, DoubleT, IntegralType, LongT,
                     avg_decimal_type, sum_decimal_type)
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
            return sum_decimal_type(ct)
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
            return avg_decimal_type(ct)
        return DoubleT


class First(AggregateFunction):
    """The first value of a group in input order (with ``ignore_nulls``
    the first non-null one)."""
    update_op = "first"

    def __init__(self, child: Expression, ignore_nulls: bool = False):
        super().__init__(child)
        self.ignore_nulls = ignore_nulls

    @property
    def dtype(self) -> DataType:
        return self.child.dtype


class Last(AggregateFunction):
    """The last value of a group in input order (with ``ignore_nulls``
    the last non-null one)."""
    update_op = "last"

    def __init__(self, child: Expression, ignore_nulls: bool = False):
        super().__init__(child)
        self.ignore_nulls = ignore_nulls

    @property
    def dtype(self) -> DataType:
        return self.child.dtype


class StddevBase(AggregateFunction):
    """The variance family over an (n, sum, sumsq) partial state; the
    final step is the reference's ``m2 = sumsq - sum² / n``."""

    @property
    def dtype(self) -> DataType:
        return DoubleT

    @property
    def nullable(self) -> bool:
        return True


class StddevSamp(StddevBase):
    update_op = "stddev_samp"


class StddevPop(StddevBase):
    update_op = "stddev_pop"


class VarianceSamp(StddevBase):
    update_op = "var_samp"


class VariancePop(StddevBase):
    update_op = "var_pop"


#: the variance family's update ops
VARIANCE_OPS = ("stddev_samp", "stddev_pop", "var_samp", "var_pop")
