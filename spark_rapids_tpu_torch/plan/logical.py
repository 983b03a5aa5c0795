"""Logical plan nodes + analysis (attribute resolution, type coercion).

Port of the LocalRelation/FileScan/Range/Project/Filter/Limit/Sample/
Sort/Aggregate/Join/Union/WindowOp/Expand/Repartition part of
``spark_rapids_tpu/plan/logical.py`` with Spark's implicit-cast coercion.
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
from ..types import (BooleanT, DataType, DecimalType, DoubleT, DoubleType,
                     IntegralType, LongT, NullType, NumericType, StringType,
                     numeric_promote)


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


class FileScan(LogicalPlan):
    """Lazy file-source relation (reference GpuFileSourceScanExec): parquet,
    orc, csv or json. Without a user schema the columns come from the first
    file (a footer, or a read of a text file), with hive partition columns
    after them."""

    def __init__(self, paths, fmt: str, schema_attrs=None, options=None,
                 num_partitions=None):
        self.paths = list(paths)
        self.fmt = fmt
        self.options = dict(options or {})
        self.num_partitions = num_partitions
        if schema_attrs is None:
            schema_attrs = self._infer_schema()
        self._output = schema_attrs

    def _infer_schema(self):
        from ..io.parquet import read_schema
        from ..types import from_arrow
        sch = read_schema(self.paths[0], self.fmt, self.options)
        attrs = []
        for f in sch:
            try:
                dtype = from_arrow(f.type)
            except NotImplementedError:
                dtype = _Unported(str(f.type))
            attrs.append(AttributeReference(f.name, dtype, True))
        for name, dtype in self.options.get("__partition_cols__", ()):
            attrs.append(AttributeReference(name, dtype, True))
        return attrs

    @property
    def output(self) -> List[AttributeReference]:
        return self._output

    def node_desc(self) -> str:
        return f"FileScan[{self.fmt}, {len(self.paths)} files]"


class Range(LogicalPlan):
    """``session.range`` (reference GpuRangeExec): one non-null bigint
    column ``id``."""

    def __init__(self, start: int, end: int, step: int = 1,
                 num_partitions: int = 1):
        if step == 0:
            raise ValueError("range step must not be 0")
        self.start, self.end, self.step = int(start), int(end), int(step)
        self.num_partitions = num_partitions
        self._output = [AttributeReference("id", LongT, False)]

    @property
    def output(self) -> List[AttributeReference]:
        return self._output

    def node_desc(self) -> str:
        return f"Range({self.start}, {self.end}, step={self.step})"


class _Unported(DataType):
    """A file column's type the port cannot carry (nested types); the
    planner raises if a query reads such a column."""

    def __init__(self, name: str):
        self.name = name

    def simple_string(self) -> str:
        return self.name

    def __eq__(self, other: object) -> bool:
        return isinstance(other, _Unported) and other.name == self.name

    def __hash__(self) -> int:
        return hash(("unported", self.name))


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


class Sample(LogicalPlan):
    """``df.sample`` (reference GpuSampleExec / GpuFastSampleExec,
    basicPhysicalOperators.scala:873,948)."""

    def __init__(self, child: LogicalPlan, fraction: float,
                 with_replacement: bool = False, seed: Optional[int] = None):
        self.children = (child,)
        self.fraction = float(fraction)
        self.with_replacement = bool(with_replacement)
        if seed is None:
            import random
            seed = random.randrange(1 << 31)  # pyspark draws a random seed
        self.seed = int(seed)

    @property
    def output(self) -> List[AttributeReference]:
        return self.children[0].output

    def node_desc(self) -> str:
        r = ", replace" if self.with_replacement else ""
        return f"Sample[{self.fraction}{r}, seed={self.seed}]"


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


class Union(LogicalPlan):
    """UNION ALL by position: the first child's names; each column takes
    its children's wider type (Spark's ``WidenSetOperationTypes``,
    ``types.wider_type``), and a child of another type is projected
    through ``Cast`` to it, so both engines cast alike; nullable where
    any child is."""

    def __init__(self, plans: Sequence[LogicalPlan]):
        from ..types import wider_type
        first = plans[0]
        for p in plans[1:]:
            if len(p.output) != len(first.output):
                raise ValueError("UNION requires same number of columns")
        types = []
        for i, a in enumerate(first.output):
            t = a.dtype
            for p in plans[1:]:
                w = wider_type(t, p.output[i].dtype)
                if w is None:
                    raise ValueError(
                        f"UNION column {i} ({a.name}): no common type of "
                        f"{t.simple_string()} and "
                        f"{p.output[i].dtype.simple_string()}")
                t = w
            types.append(t)
        self.children = tuple(
            p if all(o.dtype == t for o, t in zip(p.output, types))
            else Project([o if o.dtype == t else Alias(Cast(o, t), o.name)
                          for o, t in zip(p.output, types)], p)
            for p in plans)
        self._output = [AttributeReference(
            a.name, t, any(p.output[i].nullable for p in self.children))
            for i, (a, t) in enumerate(zip(first.output, types))]

    @property
    def output(self) -> List[AttributeReference]:
        return self._output


class WindowOp(LogicalPlan):
    """Window evaluation: the child's columns, then one column a window
    expression (``_we<i>``), as Spark extracts them from a Project."""

    def __init__(self, window_exprs, child: LogicalPlan):
        from ..window import WindowExpression, WindowSpec
        self.children = (child,)
        resolved = []
        for we in window_exprs:
            spec = we.spec
            new_spec = WindowSpec(
                [resolve_expression(p, child) for p in spec.partition_by],
                [SortOrder(resolve_expression(o.child, child), o.ascending,
                           o.nulls_first) for o in spec.order_by],
                spec.frame, spec.frame_type)
            resolved.append(WindowExpression(
                resolve_expression(we.function, child), new_spec))
        self.window_exprs = resolved
        self._win_attrs = [AttributeReference(f"_we{i}", w.dtype, w.nullable)
                           for i, w in enumerate(resolved)]

    @property
    def window_attrs(self) -> List[AttributeReference]:
        return self._win_attrs

    @property
    def output(self) -> List[AttributeReference]:
        return self.children[0].output + self._win_attrs

    def node_desc(self) -> str:
        return f"Window[{', '.join(w.pretty() for w in self.window_exprs)}]"


class Expand(LogicalPlan):
    """Grouping sets' row multiplexer (Spark's ExpandExec): each
    projection gives one output row an input row."""

    def __init__(self, projections: Sequence[Sequence[Expression]],
                 output_attrs: Sequence[AttributeReference],
                 child: LogicalPlan, resolve: bool = True):
        self.children = (child,)
        self.projections = [[resolve_expression(e, child) for e in p]
                            if resolve else list(p) for p in projections]
        self._output = list(output_attrs)

    @property
    def output(self) -> List[AttributeReference]:
        return self._output

    def node_desc(self) -> str:
        return f"Expand[{len(self.projections)} projections]"


class Repartition(LogicalPlan):
    """An exchange the user asked for: ``hash`` on keys, ``roundrobin``,
    ``coalesce`` or ``single`` (reference GpuOverrides ``parts``
    registry, GpuOverrides.scala:3876)."""

    def __init__(self, child: LogicalPlan, num_partitions: int,
                 partitioning: str = "roundrobin",
                 keys: Sequence[Expression] = ()):
        self.children = (child,)
        self.num_partitions = num_partitions
        self.partitioning = partitioning
        self.keys = [resolve_expression(k, child) for k in keys]

    @property
    def output(self) -> List[AttributeReference]:
        return self.children[0].output


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
    """Insert implicit casts per Spark's coercion rules: the binary
    operators' common type, the math family's double, ``greatest``/
    ``least``'s common type, the shifts' int distance, and a string (or
    a narrow integer for the shifts) argument cast as Spark casts it."""

    def rule(e: Expression):
        dec = _coerce_decimal(e)
        if dec is not None:
            return dec if dec is not e else None
        if isinstance(e, A.Divide):
            l, r = e.children
            lt, rt = l.dtype, r.dtype
            if (isinstance(lt, IntegralType) or isinstance(rt, IntegralType)
                    or lt != rt) and not isinstance(lt, DecimalType) \
                    and not isinstance(rt, DecimalType):
                return A.Divide(_cast_if(l, DoubleT), _cast_if(r, DoubleT))
            return None
        if isinstance(e, _COMMON_TYPE_BINARY):
            l, r = e.children
            lt, rt = l.dtype, r.dtype
            if lt == rt:
                return None
            common = _common_type(lt, rt)
            if common is None:
                return None
            return e.with_children([_cast_if(l, common), _cast_if(r, common)])
        return _coerce_functions(e)

    return expr.transform(rule)


_DECIMAL_ARITHMETIC = (A.Add, A.Subtract, A.Multiply, A.Divide,
                       A.Remainder, A.Pmod)
_COMPARISONS = (P.EqualTo, P.EqualNullSafe, P.LessThan, P.LessThanOrEqual,
                P.GreaterThan, P.GreaterThanOrEqual)


def _decimal_operand_type(e: Expression) -> DataType:
    """An integral operand beside a decimal as a decimal (Spark's
    DecimalPrecision): a literal takes its own digits (``lit(1)`` is
    decimal(1, 0)), a column its type's (int is decimal(10, 0))."""
    from ..expressions.base import Literal
    from ..types import integral_decimal
    if isinstance(e, Literal) and e.value is not None:
        return DecimalType(max(len(str(abs(int(e.value)))), 1), 0)
    return integral_decimal(e.dtype)


def _coerce_decimal(e: Expression) -> Optional[Expression]:
    """Spark's decimal widening for a binary arithmetic or comparison with
    a decimal side: an integral side widens to a decimal, a float or double
    takes the decimal side to double; a comparison brings both sides to
    the wider decimal. None when neither side is a decimal; ``e`` itself
    when nothing changes."""
    if not isinstance(e, _DECIMAL_ARITHMETIC + _COMPARISONS):
        return None
    l, r = e.children
    lt, rt = l.dtype, r.dtype
    if not (isinstance(lt, DecimalType) or isinstance(rt, DecimalType)):
        return None
    if not (isinstance(lt, (NumericType, NullType))
            and isinstance(rt, (NumericType, NullType))):
        return e  # a string side: the comparison's own rule (none here)
    from ..types import FloatType
    if isinstance(lt, (FloatType, DoubleType)) \
            or isinstance(rt, (FloatType, DoubleType)):
        new = [_cast_if(l, DoubleT), _cast_if(r, DoubleT)]
    else:
        lt2 = _decimal_operand_type(l) if isinstance(lt, IntegralType) \
            else lt
        rt2 = _decimal_operand_type(r) if isinstance(rt, IntegralType) \
            else rt
        if isinstance(lt2, NullType):
            lt2 = rt2
        if isinstance(rt2, NullType):
            rt2 = lt2
        if isinstance(e, _COMPARISONS) and lt2 != rt2:
            from ..types import decimal_wider_type
            lt2 = rt2 = decimal_wider_type(lt2, rt2)
        new = [_cast_if(l, lt2), _cast_if(r, rt2)]
    if all(a is b for a, b in zip(new, e.children)):
        return e
    return e.with_children(new)


_COMMON_TYPE_BINARY = (A.Add, A.Subtract, A.Multiply, A.Remainder, A.Pmod,
                       A.IntegralDivide, P.EqualTo, P.EqualNullSafe,
                       P.LessThan, P.LessThanOrEqual, P.GreaterThan,
                       P.GreaterThanOrEqual)


def _coerce_functions(e: Expression) -> Optional[Expression]:
    """The scalar functions' implicit casts (Spark's
    ImplicitCastInputTypes for them)."""
    from ..expressions import bitwise as BW
    from ..expressions import conditional as CO
    from ..expressions import datetime as DT
    from ..expressions import mathexprs as M
    from ..expressions import nullexprs as N
    from ..types import DateT, IntegerT, TimestampT
    kids = list(e.children)

    def recast(targets):
        new = [k if t is None else _cast_if(k, t)
               for k, t in zip(kids, targets)]
        changed = any(a is not b for a, b in zip(new, kids))
        return e.with_children(new) if changed else None

    def to_double(k):
        return DoubleT if isinstance(k.dtype, (NumericType, StringType)) \
            else None

    if isinstance(e, (M._DoubleUnary, M._LogBase, M._DoubleBinary)):
        return recast([to_double(k) for k in kids])
    if isinstance(e, M.Ceil) and isinstance(kids[0].dtype, StringType):
        return recast([DoubleT])
    if isinstance(e, (CO.Greatest, CO.Least, N.NaNvl, BW.BitwiseAnd,
                      BW.BitwiseOr, BW.BitwiseXor)):
        common = kids[0].dtype
        for k in kids[1:]:
            common = _common_type(common, k.dtype) or common
        return recast([common] * len(kids))
    if isinstance(e, (BW.ShiftLeft, BW.ShiftRight, BW.ShiftRightUnsigned)):
        lt = kids[0].dtype
        narrow = isinstance(lt, IntegralType) and lt.np_dtype.itemsize < 4
        return recast([IntegerT if narrow else None, IntegerT])
    if isinstance(e, (DT.Hour, DT.Minute, DT.Second, DT.DateFormatClass,
                      DT.UnixTimestampFromTs)):
        return recast([TimestampT if isinstance(kids[0].dtype, StringType)
                       else None] + [None] * (len(kids) - 1))
    if isinstance(e, (DT._DateField, DT.LastDay)):
        return recast([DateT if isinstance(kids[0].dtype, StringType)
                       else None])
    if isinstance(e, (DT.DateAdd, DT.AddMonths)):
        return recast([DateT if isinstance(kids[0].dtype, StringType)
                       else None, None])
    if isinstance(e, DT.DateDiff):
        return recast([DateT if isinstance(k.dtype, StringType) else None
                       for k in kids])
    return None


def _cast_if(e: Expression, to: DataType) -> Expression:
    return e if e.dtype == to else Cast(e, to)


def _common_type(a: DataType, b: DataType) -> Optional[DataType]:
    if a == b:
        return a
    if isinstance(a, NullType):
        return b
    if isinstance(b, NullType):
        return a
    if isinstance(a, NumericType) and isinstance(b, NumericType):
        return numeric_promote(a, b)
    if isinstance(a, StringType) and isinstance(b, NumericType):
        return DoubleT if not isinstance(b, DecimalType) else b
    if isinstance(b, StringType) and isinstance(a, NumericType):
        return DoubleT if not isinstance(a, DecimalType) else a
    return None
