"""``IS NULL``, ``IS NOT NULL`` and ``coalesce`` (port of ``IsNull``,
``IsNotNull`` and ``Coalesce`` in
``spark_rapids_tpu/expressions/nullexprs.py``, with their pyarrow host
evaluation). The tests are never null themselves; padding rows read
false."""

from __future__ import annotations

import torch

from ..columnar.vector import TorchColumnVector, TorchScalar, row_mask
from ..types import BooleanT, DataType, StringT, StringType
from .base import (_DEFAULT_CTX, Expression, UnaryExpression, arrow_column,
                   device_parts, is_arrow, make_column)


class _NullTest(UnaryExpression):
    word = "?"

    @property
    def dtype(self) -> DataType:
        return BooleanT

    @property
    def nullable(self) -> bool:
        return False

    def _is_null(self, c, batch) -> torch.Tensor:
        cap, dev = batch.capacity, batch.device
        if isinstance(c, TorchScalar):
            return torch.full((cap,), c.is_null, dtype=torch.bool, device=dev)
        if c.validity is None:
            return torch.zeros(cap, dtype=torch.bool, device=dev)
        return ~c.validity

    def _test(self, is_null: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        c = self.child.eval_device(batch, ctx)
        mask = row_mask(batch.num_rows, batch.capacity, batch.device)
        return make_column(BooleanT, self._test(self._is_null(c, batch))
                           & mask, None, batch.num_rows)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        import pyarrow.compute as pc
        c = self.child.eval_cpu(table, ctx)
        if not is_arrow(c):
            return bool(self._test(torch.tensor([c is None]))[0])
        return getattr(pc, self._arrow_op)(c)

    def pretty(self) -> str:
        return f"{self.child.pretty()} {self.word}"


class IsNull(_NullTest):
    word = "IS NULL"
    _arrow_op = "is_null"

    def _test(self, is_null):
        return is_null


class IsNotNull(_NullTest):
    word = "IS NOT NULL"
    _arrow_op = "is_valid"

    def _test(self, is_null):
        return ~is_null


class Coalesce(Expression):
    """The first non-null argument (reference ``Coalesce``): of the first
    argument's type. Fixed-width arguments blend with ``torch.where``;
    string arguments concatenate with only the chosen side emitting."""

    def __init__(self, *children: Expression):
        self.children = tuple(children)

    @property
    def dtype(self) -> DataType:
        return self.children[0].dtype

    @property
    def nullable(self) -> bool:
        return all(c.nullable for c in self.children)

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        cap, dev = batch.capacity, batch.device
        mask = row_mask(batch.num_rows, cap, dev)
        values = [c.eval_device(batch, ctx) for c in self.children]
        if isinstance(self.dtype, StringType):
            from .strings import (concat_columns, string_bytes_bound,
                                  string_sides)
            sides = string_sides(values, batch)
            taken = torch.zeros(cap, dtype=torch.bool, device=dev)
            emit = []
            for s in sides:
                v = mask if s[3] is None else s[3] & mask
                emit.append(v & ~taken)
                taken = taken | v
            data, offs = concat_columns([s[:3] for s in sides],
                                        string_bytes_bound(values, sides,
                                                           batch), emit)
            return TorchColumnVector(StringT, data, taken, batch.num_rows,
                                     offsets=offs)
        carrier = self.dtype.torch_dtype or torch.bool
        data = torch.zeros(cap, dtype=carrier, device=dev)
        valid = torch.zeros(cap, dtype=torch.bool, device=dev)
        for v in values:
            d, vv = device_parts(v, cap, dev)
            vv = mask if vv is None else vv & mask
            take = vv & ~valid
            data = torch.where(take, torch.broadcast_to(d, (cap,)).to(carrier),
                               data)
            valid = valid | vv
        return make_column(self.dtype, data, valid, batch.num_rows)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        import pyarrow.compute as pc
        vals = [c.eval_cpu(table, ctx) for c in self.children]
        if not any(is_arrow(v) for v in vals):
            return next((v for v in vals if v is not None), None)
        n = table.num_rows
        return pc.coalesce(*[arrow_column(v, n, self.dtype) for v in vals])

    def pretty(self) -> str:
        return f"coalesce({', '.join(c.pretty() for c in self.children)})"
