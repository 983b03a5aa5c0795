"""Logical plan nodes + analysis (attribute resolution, type coercion).

Port of the LocalRelation/Project/Filter/Limit/Sort/Aggregate/Join part
of ``spark_rapids_tpu/plan/logical.py`` with Spark's implicit-cast
coercion.
``node_desc`` strings are the reference's, so the optimized logical plan
in ``explain()`` reads the same in both packages.
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

    def tree_string(self, indent: int = 0) -> str:
        lines = ["  " * indent + self.node_desc()]
        for c in self.children:
            lines.append(c.tree_string(indent + 1))
        return "\n".join(lines)

    def node_desc(self) -> str:
        return type(self).__name__


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

    def node_desc(self) -> str:
        return f"LocalRelation[{self.table.num_rows} rows]"


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

    def node_desc(self) -> str:
        return f"Project[{', '.join(e.pretty() for e in self.exprs)}]"


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

    def node_desc(self) -> str:
        return f"Filter[{self.condition.pretty()}]"


class Limit(LogicalPlan):
    def __init__(self, n: int, child: LogicalPlan, offset: int = 0):
        self.children = (child,)
        self.n = n
        self.offset = offset

    @property
    def output(self) -> List[AttributeReference]:
        return self.children[0].output

    def node_desc(self) -> str:
        return f"Limit[{self.n}]"


class SortOrder:
    def __init__(self, child: Expression, ascending: bool = True,
                 nulls_first: Optional[bool] = None):
        self.child = child
        self.ascending = ascending
        # Spark's default: NULLS FIRST for ASC, NULLS LAST for DESC
        self.nulls_first = nulls_first if nulls_first is not None \
            else ascending

    def pretty(self) -> str:
        d = "ASC" if self.ascending else "DESC"
        n = "NULLS FIRST" if self.nulls_first else "NULLS LAST"
        return f"{self.child.pretty()} {d} {n}"


class Sort(LogicalPlan):
    def __init__(self, order: Sequence[SortOrder], global_sort: bool,
                 child: LogicalPlan):
        self.children = (child,)
        self.order = [SortOrder(resolve_expression(o.child, child),
                                o.ascending, o.nulls_first) for o in order]
        self.global_sort = global_sort

    @property
    def output(self) -> List[AttributeReference]:
        return self.children[0].output

    def node_desc(self) -> str:
        return f"Sort[{', '.join(o.pretty() for o in self.order)}]"


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

    def node_desc(self) -> str:
        g = ", ".join(e.pretty() for e in self.grouping)
        a = ", ".join(e.pretty() for e in self.aggregates)
        return f"Aggregate[groupBy=({g}) agg=({a})]"


class Join(LogicalPlan):
    """Equi-join: ``left_keys[i] = right_keys[i]`` for every i, plus an
    optional residual ``condition`` over both sides."""

    def __init__(self, left: LogicalPlan, right: LogicalPlan, join_type: str,
                 left_keys: Sequence[Expression] = (),
                 right_keys: Sequence[Expression] = (),
                 condition: Optional[Expression] = None):
        self.children = (left, right)
        self.join_type = join_type.lower().replace("_", "")
        self.left_keys = [resolve_expression(k, left) for k in left_keys]
        self.right_keys = [resolve_expression(k, right) for k in right_keys]
        self.condition = (resolve_expression(condition,
                                             _JoinScope(left, right))
                          if condition is not None else None)

    @property
    def left(self) -> LogicalPlan:
        return self.children[0]

    @property
    def right(self) -> LogicalPlan:
        return self.children[1]

    @property
    def output(self) -> List[AttributeReference]:
        jt = self.join_type
        if jt in ("inner", "cross"):
            return self.left.output + self.right.output
        if jt in ("leftouter", "left"):
            return self.left.output + [_as_nullable(a)
                                       for a in self.right.output]
        if jt in ("rightouter", "right"):
            return [_as_nullable(a) for a in self.left.output] \
                + self.right.output
        if jt in ("fullouter", "outer", "full"):
            return ([_as_nullable(a) for a in self.left.output]
                    + [_as_nullable(a) for a in self.right.output])
        if jt in ("leftsemi", "semi", "leftanti", "anti"):
            return self.left.output
        raise ValueError(f"unknown join type {self.join_type}")

    def node_desc(self) -> str:
        keys = ", ".join(f"{l.pretty()}={r.pretty()}"
                         for l, r in zip(self.left_keys, self.right_keys))
        return f"Join[{self.join_type}]({keys})"


def _as_nullable(a: AttributeReference) -> AttributeReference:
    return AttributeReference(a.name, a.dtype, True, expr_id=a.expr_id)


class _JoinScope(LogicalPlan):
    """Both sides of a join, for resolving its condition."""

    def __init__(self, left: LogicalPlan, right: LogicalPlan):
        self.children = (left, right)

    @property
    def output(self) -> List[AttributeReference]:
        return self.children[0].output + self.children[1].output


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
