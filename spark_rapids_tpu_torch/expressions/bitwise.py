"""Bitwise AND and the arithmetic right shift (port of ``BitwiseAnd`` and
``ShiftRight`` from ``spark_rapids_tpu/expressions/bitwise.py``: what the
grouping-sets lowering's ``grouping(k)`` needs; the other bitwise
expressions are not yet ported)."""

from __future__ import annotations

import torch

from ..types import DataType
from .base import BinaryExpression


class _BitwiseBinary(BinaryExpression):
    symbol = "?"

    @property
    def dtype(self) -> DataType:
        return self.left.dtype

    def pretty(self) -> str:
        return f"({self.left.pretty()} {self.symbol} {self.right.pretty()})"


class BitwiseAnd(_BitwiseBinary):
    symbol = "&"

    def _compute(self, ld, rd, ctx, valid):
        return ld & rd.to(ld.dtype)


class ShiftRight(_BitwiseBinary):
    """Arithmetic (sign-extending) right shift; the distance is taken
    modulo the width, as Java does."""
    symbol = ">>"

    def _compute(self, ld, rd, ctx, valid):
        width = ld.element_size() * 8
        dist = rd.to(torch.int64) & (width - 1)
        return ld >> dist.to(ld.dtype)
