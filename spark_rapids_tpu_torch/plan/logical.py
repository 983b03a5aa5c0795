"""Logical plan nodes + analysis (attribute resolution, type coercion).

Port of the LocalRelation/Project/Filter/Aggregate part of
``spark_rapids_tpu/plan/logical.py`` with Spark's implicit-cast coercion.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..expressions import arithmetic as A
from ..expressions import predicates as P
from ..expressions.base import (Alias, AttributeReference, Expression,
                                UnresolvedAttribute, output_name)
from ..expressions.cast import Cast
from ..types import (BooleanT, DataType, DecimalType, DoubleT, IntegralType,
                     NullType, NumericType, StringType, numeric_promote)


class LogicalPlan:
    children: Tuple["LogicalPlan", ...] = ()

    @property
    def output(self) -> List[AttributeReference]:
        raise NotImplementedError

    def resolve_name(self, name: str) -> AttributeReference:
        matches = [a for a in self.output if a.name.lower() == name.lower()]
        if not matches:
            raise ValueError(f"cannot resolve column {name!r}; "
                             f"available: {[a.name for a in self.output]}")
        if len(matches) > 1:
            raise ValueError(f"ambiguous column {name!r}")
        return matches[0]


class LocalRelation(LogicalPlan):
    """In-memory host table (a CPU ``TorchColumnarBatch``), optionally
    split into partitions."""

    def __init__(self, table, num_partitions: int = 1):
        self.table = table
        self.num_partitions = num_partitions
        self._output = [AttributeReference(f.name, f.data_type, True)
                        for f in table.schema().fields]

    @property
    def output(self) -> List[AttributeReference]:
        return self._output


class Project(LogicalPlan):
    def __init__(self, exprs: Sequence[Expression], child: LogicalPlan):
        self.children = (child,)
        self.exprs = [_aliased(resolve_expression(e, child)) for e in exprs]
        self._output = [AttributeReference(
            output_name(e), e.dtype, e.nullable,
            expr_id=e.expr_id if isinstance(e, AttributeReference) else None)
            for e in self.exprs]

    @property
    def child(self) -> LogicalPlan:
        return self.children[0]

    @property
    def output(self) -> List[AttributeReference]:
        return self._output


class Filter(LogicalPlan):
    def __init__(self, condition: Expression, child: LogicalPlan):
        self.children = (child,)
        cond = resolve_expression(condition, child)
        if not isinstance(cond.dtype, type(BooleanT)):
            cond = Cast(cond, BooleanT)
        self.condition = cond

    @property
    def child(self) -> LogicalPlan:
        return self.children[0]

    @property
    def output(self) -> List[AttributeReference]:
        return self.child.output


class Aggregate(LogicalPlan):
    """Group-by aggregate; aggregates are Alias(AggregateFunction(...))
    or grouping attributes."""

    def __init__(self, grouping: Sequence[Expression],
                 aggregates: Sequence[Expression], child: LogicalPlan):
        self.children = (child,)
        self.grouping = [resolve_expression(g, child) for g in grouping]
        self.aggregates = [_aliased(resolve_expression(a, child))
                           for a in aggregates]
        self._output = [AttributeReference(output_name(e), e.dtype, e.nullable)
                        for e in list(self.grouping) + list(self.aggregates)]

    @property
    def output(self) -> List[AttributeReference]:
        return self._output


def _aliased(e: Expression) -> Expression:
    if isinstance(e, (Alias, AttributeReference)):
        return e
    return Alias(e, output_name(e))


def resolve_expression(expr: Expression, scope: LogicalPlan) -> Expression:
    def rule(e: Expression):
        if isinstance(e, UnresolvedAttribute):
            return scope.resolve_name(e.name)
        return None

    return coerce_types(expr.transform(rule))


def coerce_types(expr: Expression) -> Expression:
    """Insert implicit casts per Spark's binary-op coercion rules."""

    def rule(e: Expression):
        if isinstance(e, A.Divide):
            l, r = e.children
            lt, rt = l.dtype, r.dtype
            if (isinstance(lt, IntegralType) or isinstance(rt, IntegralType)
                    or lt != rt) and not isinstance(lt, DecimalType) \
                    and not isinstance(rt, DecimalType):
                return A.Divide(_cast_if(l, DoubleT), _cast_if(r, DoubleT))
            return None
        if isinstance(e, (A.Add, A.Subtract, A.Multiply, P.EqualTo,
                          P.LessThan, P.LessThanOrEqual, P.GreaterThan,
                          P.GreaterThanOrEqual)):
            l, r = e.children
            lt, rt = l.dtype, r.dtype
            if lt == rt:
                return None
            common = _common_type(lt, rt)
            if common is None:
                return None
            return e.with_children([_cast_if(l, common), _cast_if(r, common)])
        return None

    return expr.transform(rule)


def _cast_if(e: Expression, to: DataType) -> Expression:
    return e if e.dtype == to else Cast(e, to)


def _common_type(a: DataType, b: DataType) -> Optional[DataType]:
    if a == b:
        return a
    if isinstance(a, NullType):
        return b
    if isinstance(b, NullType):
        return a
    if isinstance(a, NumericType) and isinstance(b, NumericType) \
            and not isinstance(a, DecimalType) and not isinstance(b, DecimalType):
        return numeric_promote(a, b)
    if isinstance(a, StringType) and isinstance(b, NumericType):
        return DoubleT if not isinstance(b, DecimalType) else b
    if isinstance(b, StringType) and isinstance(a, NumericType):
        return DoubleT if not isinstance(a, DecimalType) else a
    return None
