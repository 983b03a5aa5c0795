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
whenever the branches share a type, as in every TPC-H query. Branches are
fixed-width; string results are not yet ported.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..columnar.vector import row_mask
from ..types import DataType, NullT, NullType, NumericType, numeric_promote
from .base import _DEFAULT_CTX, Expression, device_parts, make_column


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


def _value(expr: Expression, dtype: DataType, batch, ctx):
    """A branch value as (data in ``dtype``'s carrier, validity) over the
    capacity."""
    if not dtype.np_dtype and not isinstance(dtype, NullType):
        raise NotImplementedError(
            f"CASE WHEN with {dtype.simple_string()} branches not yet ported")
    cap, dev = batch.capacity, batch.device
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
        td, tv = _value(self.children[1], dt, batch, ctx)
        fd, fv = _value(self.children[2], dt, batch, ctx)
        mask = row_mask(batch.num_rows, batch.capacity, batch.device)
        return make_column(dt, torch.where(cond, td, fd),
                           torch.where(cond, tv, fv) & mask, batch.num_rows)

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
        carrier = dt.torch_dtype or torch.bool
        data = torch.zeros(cap, dtype=carrier, device=dev)
        valid = torch.zeros(cap, dtype=torch.bool, device=dev)
        decided = torch.zeros(cap, dtype=torch.bool, device=dev)
        for pred, value in self.branches:
            cond = _condition(pred, batch, ctx)
            take = cond & ~decided
            vd, vv = _value(value, dt, batch, ctx)
            data = torch.where(take, vd, data)
            valid = torch.where(take, vv, valid)
            decided = decided | cond
        if self._has_else:
            ed, ev = _value(self.else_value, dt, batch, ctx)
            data = torch.where(decided, data, ed)
            valid = torch.where(decided, valid, ev)
        # no ELSE: the rows no branch took stay null
        mask = row_mask(batch.num_rows, cap, dev)
        return make_column(dt, data, valid & mask, batch.num_rows)

    def pretty(self) -> str:
        parts = [f"WHEN {p.pretty()} THEN {v.pretty()}"
                 for p, v in self.branches]
        if self._has_else:
            parts.append(f"ELSE {self.else_value.pretty()}")
        return "CASE " + " ".join(parts) + " END"
