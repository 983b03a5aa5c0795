"""Arithmetic with Spark's non-ANSI semantics: integers wrap (two's
complement, as Java), division by zero is null.

Port of Add/Subtract/Multiply/Divide/Abs from
``spark_rapids_tpu/expressions/arithmetic.py``, with the reference's host
evaluation (``eval_cpu``: pyarrow's unchecked kernels, which wrap as Java
does). ANSI mode's overflow checks are not yet ported: evaluating under
ANSI raises, on either side.
"""

from __future__ import annotations

import torch

from ..columnar.vector import row_mask
from ..types import DataType
from .base import (BinaryExpression, EvalContext, UnaryExpression,
                   combine_validity, device_parts)


def _no_ansi(ctx: EvalContext, what: str) -> None:
    if ctx.ansi:
        raise NotImplementedError(f"ANSI-mode {what} not yet ported")


class BinaryArithmetic(BinaryExpression):
    symbol = "?"

    @property
    def dtype(self) -> DataType:
        return self.left.dtype

    def pretty(self) -> str:
        return f"({self.children[0].pretty()} {self.symbol} {self.children[1].pretty()})"


class Add(BinaryArithmetic):
    symbol = "+"

    def _compute(self, l, r, ctx, valid):
        _no_ansi(ctx, "add")
        return l + r

    def _cpu_compute(self, l, r, ctx):
        import pyarrow.compute as pc
        _no_ansi(ctx, "add")
        return pc.add(l, r)


class Subtract(BinaryArithmetic):
    symbol = "-"

    def _compute(self, l, r, ctx, valid):
        _no_ansi(ctx, "subtract")
        return l - r

    def _cpu_compute(self, l, r, ctx):
        import pyarrow.compute as pc
        _no_ansi(ctx, "subtract")
        return pc.subtract(l, r)


class Multiply(BinaryArithmetic):
    symbol = "*"

    def _compute(self, l, r, ctx, valid):
        _no_ansi(ctx, "multiply")
        return l * r

    def _cpu_compute(self, l, r, ctx):
        import pyarrow.compute as pc
        _no_ansi(ctx, "multiply")
        return pc.multiply(l, r)


class Divide(BinaryArithmetic):
    """Spark `/`: inputs coerced to double; a zero divisor gives null for
    every type (Spark DivModLike semantics, not IEEE)."""
    symbol = "/"

    @property
    def nullable(self) -> bool:
        return True

    def _eval_parts(self, l, r, batch, ctx):
        _no_ansi(ctx, "divide")
        cap, dev = batch.capacity, batch.device
        ld, lv = device_parts(l, cap, dev)
        rd, rv = device_parts(r, cap, dev)
        mask = row_mask(batch.num_rows, cap, dev)
        zero = rd == 0
        safe_r = torch.where(zero, torch.ones((), dtype=rd.dtype, device=dev),
                             rd)
        if rd.dtype.is_floating_point:
            data = ld / safe_r
        else:  # Java integer division truncates toward zero
            data = torch.div(ld, safe_r, rounding_mode="trunc")
        valid = combine_validity(lv, rv, mask, ~zero & mask)
        return data, valid

    def _cpu_compute(self, l, r, ctx):
        import pyarrow as pa
        import pyarrow.compute as pc
        _no_ansi(ctx, "divide")
        zero = pc.fill_null(pc.equal(r, pa.scalar(0, r.type)), False)
        out = pc.divide(l, pc.if_else(zero, pa.scalar(1, r.type), r))
        return pc.if_else(zero, pa.scalar(None, out.type), out)


class Abs(UnaryExpression):
    """``abs(x)``: the smallest integer of its type stays itself (Java's
    two's-complement wrap), as in the reference's non-ANSI path."""

    def _compute(self, d, ctx, valid):
        _no_ansi(ctx, "abs")
        return torch.abs(d)

    def _cpu_compute(self, arr, ctx):
        import pyarrow.compute as pc
        _no_ansi(ctx, "abs")
        return pc.abs(arr)
