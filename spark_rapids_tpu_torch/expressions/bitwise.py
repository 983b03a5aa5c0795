"""Bitwise AND and the arithmetic right shift (port of ``BitwiseAnd`` and
``ShiftRight`` from ``spark_rapids_tpu/expressions/bitwise.py``: what the
grouping-sets lowering's ``grouping(k)`` needs, with their host
evaluation; the other bitwise expressions are not yet ported)."""

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

    def _cpu_compute(self, l, r, ctx):
        import pyarrow.compute as pc
        return pc.bit_wise_and(l, r.cast(l.type, safe=False))


class ShiftRight(_BitwiseBinary):
    """Arithmetic (sign-extending) right shift; the distance is taken
    modulo the width, as Java does."""
    symbol = ">>"

    def _compute(self, ld, rd, ctx, valid):
        width = ld.element_size() * 8
        dist = rd.to(torch.int64) & (width - 1)
        return ld >> dist.to(ld.dtype)

    def _cpu_compute(self, l, r, ctx):
        import numpy as np
        import pyarrow as pa
        ln = np.asarray(l.fill_null(0).to_numpy(zero_copy_only=False))
        rn = np.asarray(r.fill_null(0).to_numpy(zero_copy_only=False))
        dist = (rn.astype(np.int64) & (ln.dtype.itemsize * 8 - 1))
        mask = np.asarray(l.is_null()) | np.asarray(r.is_null())
        return pa.array(ln >> dist.astype(ln.dtype), mask=mask)
