"""Conditional expressions: ``If`` and ``CASE WHEN`` (port of ``If`` and
``CaseWhen`` in ``spark_rapids_tpu/expressions/conditional.py``).

Every branch evaluates over the whole batch and the results blend with
``torch.where``, the vectorized engines' norm (the reference does the same
with ``jnp.where``). Spark's nulls: a null condition takes the next branch
(the false side of an ``If``), and rows no branch takes are null when
there is no ``ELSE``.

The result type is the branches' common type (Spark's CaseWhenCoercion),
so ``when(c, 1).otherwise(2.5)`` is a double. The reference keeps the
first branch's type and truncates the others into it; the two agree
whenever the branches share a type, as in every TPC-H query.

String branches: each branch evaluates to offsets + bytes (a literal's
bytes shared by every row), and one ragged gather
(``kernels/strings.concat_columns``, each branch emitting only on the
rows it takes) builds the result, as ``concat`` and a string ``coalesce``
do; nothing is read back to the host.

Host evaluation (``eval_cpu``) blends Arrow arrays with ``if_else`` from
the last branch back, each value cast to the common type first.

``greatest``/``least`` (``Greatest``, ``Least``) fold their arguments of
one type (the planner casts them to the common type): nulls are skipped
(null only where every argument is), and NaN is larger than any other
value, as in Spark. Their host evaluation runs the same fold over CPU
tensors.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..columnar.vector import TorchColumnVector, lane_mask, row_mask
from ..types import (DataType, DecimalType, NullT, NullType, NumericType,
                     StringT, StringType, numeric_promote)
from .base import (_DEFAULT_CTX, Expression, arrow_column, device_parts,
                   eval_cpu_on_host_tensors, make_column)


def _cpu_blend(pairs, else_value, dtype: DataType, table, ctx):
    """Host CASE WHEN: ``pairs`` [(predicate, value)] with the first true
    predicate's value (a null predicate is not true), else ``else_value``
    (None: null)."""
    import pyarrow.compute as pc
    from .base import BooleanT
    n = table.num_rows
    out = arrow_column(None if else_value is None
                       else else_value.eval_cpu(table, ctx), n, dtype)
    for pred, value in reversed(pairs):
        cond = pc.fill_null(arrow_column(pred.eval_cpu(table, ctx), n,
                                         BooleanT), False)
        out = pc.if_else(cond, arrow_column(value.eval_cpu(table, ctx), n,
                                            dtype), out)
    return out


def branch_type(values: Sequence[Expression]) -> DataType:
    """The common type of the branch values: numerics promote to the
    widest (int and double give double), a null literal takes the others'
    type, and otherwise the first branch's type stands."""
    types = [v.dtype for v in values if not isinstance(v.dtype, NullType)]
    if not types:
        return NullT
    out = types[0]
    for t in types[1:]:
        if t != out and isinstance(t, NumericType) \
                and isinstance(out, NumericType):
            out = numeric_promote(out, t)
    return out


def _condition(pred: Expression, batch, ctx) -> torch.Tensor:
    """The rows where the predicate is true (null is not true)."""
    cap, dev = batch.capacity, batch.device
    d, v = device_parts(pred.eval_device(batch, ctx), cap, dev)
    cond = torch.broadcast_to(d, (cap,)).to(torch.bool)
    return cond if v is None else cond & v


def string_branches(pairs, batch, ctx) -> TorchColumnVector:
    """The string result of branches ``pairs`` [(rows taken, value
    expression)]: row i is the value of the branch that takes it, null
    where none does or its value is null."""
    from .strings import concat_columns, string_bytes_bound, string_sides
    mask = row_mask(batch.num_rows, batch.capacity, batch.device)
    values = [v.eval_device(batch, ctx) for _, v in pairs]
    sides = string_sides(values, batch)
    emit = [take & mask & (True if s[3] is None else s[3])
            for (take, _), s in zip(pairs, sides)]
    valid = torch.stack(emit).any(0) if emit else mask & False
    data, offs = concat_columns([s[:3] for s in sides],
                                string_bytes_bound(values, sides, batch),
                                part_emit=emit)
    return TorchColumnVector(StringT, data, valid, batch.num_rows,
                             offsets=offs)


def _value(expr: Expression, dtype: DataType, batch, ctx):
    """A branch value as (data in ``dtype``'s carrier, validity) over the
    capacity."""
    if not dtype.np_dtype and not isinstance(dtype, NullType):
        raise NotImplementedError(
            f"CASE WHEN with {dtype.simple_string()} branches not yet ported")
    cap, dev = batch.capacity, batch.device
    if isinstance(dtype, DecimalType):
        from .decimals import rows_as
        d, v = rows_as(expr.eval_device(batch, ctx), expr.dtype, dtype, cap,
                       dev)
        return d, (row_mask(batch.num_rows, cap, dev) if v is None else v)
    d, v = device_parts(expr.eval_device(batch, ctx), cap, dev)
    carrier = dtype.torch_dtype or torch.bool
    d = torch.broadcast_to(d, (cap,)).to(carrier)
    if v is None:
        v = row_mask(batch.num_rows, cap, dev)
    return d, v


class If(Expression):
    """``if(predicate, true_value, false_value)``."""

    def __init__(self, predicate: Expression, true_value: Expression,
                 false_value: Expression):
        self.children = (predicate, true_value, false_value)

    @property
    def dtype(self) -> DataType:
        return branch_type(self.children[1:])

    @property
    def nullable(self) -> bool:
        return self.children[1].nullable or self.children[2].nullable

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        cond = _condition(self.children[0], batch, ctx)
        dt = self.dtype
        if isinstance(dt, StringType):
            return string_branches([(cond, self.children[1]),
                                    (~cond, self.children[2])], batch, ctx)
        td, tv = _value(self.children[1], dt, batch, ctx)
        fd, fv = _value(self.children[2], dt, batch, ctx)
        mask = row_mask(batch.num_rows, batch.capacity, batch.device)
        return make_column(dt, torch.where(lane_mask(cond, td), td, fd),
                           torch.where(cond, tv, fv) & mask, batch.num_rows)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        c = self.children
        return _cpu_blend([(c[0], c[1])], c[2], self.dtype, table, ctx)

    def pretty(self) -> str:
        c = self.children
        return f"if({c[0].pretty()}, {c[1].pretty()}, {c[2].pretty()})"


class CaseWhen(Expression):
    """``CASE WHEN p1 THEN v1 ... [ELSE e] END``; the children are flat:
    (p1, v1, p2, v2, ...[, e])."""

    def __init__(self, branches: List[Tuple[Expression, Expression]],
                 else_value: Optional[Expression] = None):
        flat: List[Expression] = []
        for p, v in branches:
            flat.extend((p, v))
        if else_value is not None:
            flat.append(else_value)
        self.children = tuple(flat)
        self._n_branches = len(branches)
        self._has_else = else_value is not None

    @property
    def branches(self) -> List[Tuple[Expression, Expression]]:
        return [(self.children[2 * i], self.children[2 * i + 1])
                for i in range(self._n_branches)]

    @property
    def else_value(self) -> Optional[Expression]:
        return self.children[-1] if self._has_else else None

    @property
    def dtype(self) -> DataType:
        values = [v for _, v in self.branches]
        if self._has_else:
            values.append(self.else_value)
        return branch_type(values)

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        cap, dev = batch.capacity, batch.device
        dt = self.dtype
        if isinstance(dt, StringType):
            decided = torch.zeros(cap, dtype=torch.bool, device=dev)
            pairs = []
            for pred, value in self.branches:
                cond = _condition(pred, batch, ctx)
                pairs.append((cond & ~decided, value))
                decided = decided | cond
            if self._has_else:
                pairs.append((~decided, self.else_value))
            return string_branches(pairs, batch, ctx)
        from .decimals import zeros_rows
        data = zeros_rows(cap, dt, dev)
        valid = torch.zeros(cap, dtype=torch.bool, device=dev)
        decided = torch.zeros(cap, dtype=torch.bool, device=dev)
        for pred, value in self.branches:
            cond = _condition(pred, batch, ctx)
            take = cond & ~decided
            vd, vv = _value(value, dt, batch, ctx)
            data = torch.where(lane_mask(take, data), vd, data)
            valid = torch.where(take, vv, valid)
            decided = decided | cond
        if self._has_else:
            ed, ev = _value(self.else_value, dt, batch, ctx)
            data = torch.where(lane_mask(decided, data), data, ed)
            valid = torch.where(decided, valid, ev)
        # no ELSE: the rows no branch took stay null
        mask = row_mask(batch.num_rows, cap, dev)
        return make_column(dt, data, valid & mask, batch.num_rows)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return _cpu_blend(self.branches, self.else_value, self.dtype, table,
                          ctx)

    def pretty(self) -> str:
        parts = [f"WHEN {p.pretty()} THEN {v.pretty()}"
                 for p, v in self.branches]
        if self._has_else:
            parts.append(f"ELSE {self.else_value.pretty()}")
        return "CASE " + " ".join(parts) + " END"


def _nan_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a < b`` with NaN the largest value (Spark's ordering); two-limb
    decimals by their 128-bit order."""
    if a.dim() == 2:
        from .decimals import compare_sign
        return compare_sign(a, b) < 0
    if not a.is_floating_point():
        return a < b
    return (a < b) | (torch.isnan(b) & ~torch.isnan(a))


class _MinMaxOf(Expression):
    """A row-wise fold over the arguments, nulls skipped."""

    def __init__(self, *children: Expression):
        self.children = tuple(children)

    @property
    def dtype(self) -> DataType:
        return branch_type(self.children)

    @property
    def nullable(self) -> bool:
        return all(c.nullable for c in self.children)

    def _better(self, cand: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        dt = self.dtype
        cur = cur_v = None
        for c in self.children:
            d, v = _value(c, dt, batch, ctx)
            if cur is None:
                cur, cur_v = d, v
                continue
            take = v & (~cur_v | self._better(d, cur))
            cur = torch.where(lane_mask(take, cur), d, cur)
            cur_v = cur_v | v
        mask = row_mask(batch.num_rows, batch.capacity, batch.device)
        return make_column(dt, cur, cur_v & mask, batch.num_rows)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return eval_cpu_on_host_tensors(self, table, ctx)


class Greatest(_MinMaxOf):
    """greatest(...): the largest non-null argument; NaN beats all."""

    def _better(self, cand, cur):
        return _nan_lt(cur, cand)


class Least(_MinMaxOf):
    """least(...): the smallest non-null argument; NaN loses to all."""

    def _better(self, cand, cur):
        return _nan_lt(cand, cur)
