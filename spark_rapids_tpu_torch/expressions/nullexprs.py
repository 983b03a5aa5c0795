"""``IS NULL`` and ``IS NOT NULL`` (port of ``IsNull`` and ``IsNotNull`` in
``spark_rapids_tpu/expressions/nullexprs.py``): never null themselves;
padding rows read false."""

from __future__ import annotations

import torch

from ..columnar.vector import TorchScalar, row_mask
from ..types import BooleanT, DataType
from .base import _DEFAULT_CTX, UnaryExpression, make_column


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

    def pretty(self) -> str:
        return f"{self.child.pretty()} {self.word}"


class IsNull(_NullTest):
    word = "IS NULL"

    def _test(self, is_null):
        return is_null


class IsNotNull(_NullTest):
    word = "IS NOT NULL"

    def _test(self, is_null):
        return ~is_null
