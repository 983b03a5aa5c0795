"""``round(x, scale)`` with Spark's HALF_UP (port of ``Round`` in
``spark_rapids_tpu/expressions/mathexprs.py``; ``BRound`` is not yet
ported).

Floats round as the reference's device path computes them, in float64:
``trunc(x * 10^s + 0.5 * sign) / 10^s`` (ties away from zero; NaN and
infinities pass through). Integers keep their value for ``s >= 0``; a
negative scale rounds to a multiple of ``m = 10^-s`` with the half added
away from zero, then divides truncating toward zero, as Java's integer
division does (``round(-14, -1)`` is -10). The reference divides with
``//``, which floors, and so rounds a negative integer that is not a tie
one step further from zero; the two agree on non-negative integers and on
ties.
"""

from __future__ import annotations

import torch

from ..columnar.vector import row_mask
from ..types import DataType
from .base import (_DEFAULT_CTX, Expression, Literal, combine_validity,
                   device_parts, make_column)


class Round(Expression):
    def __init__(self, child: Expression, scale: Expression):
        self.children = (child, scale)

    @property
    def dtype(self) -> DataType:
        return self.children[0].dtype

    def _scale(self) -> int:
        s = self.children[1]
        if not isinstance(s, Literal) or s.value is None:
            raise NotImplementedError(
                "round with a non-literal scale not yet ported")
        return int(s.value)

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        cap, dev = batch.capacity, batch.device
        scale = self._scale()
        d, v = device_parts(self.children[0].eval_device(batch, ctx), cap,
                            dev)
        d = torch.broadcast_to(d, (cap,))
        if d.dtype.is_floating_point:
            m = 10.0 ** scale
            scaled = d.to(torch.float64) * m
            half = torch.where(scaled >= 0, 0.5, -0.5).to(torch.float64)
            data = (torch.trunc(scaled + half) / m).to(d.dtype)
        elif scale >= 0:
            data = d
        elif -scale >= 19:  # every int64 rounds to 0
            data = torch.zeros_like(d)
        else:
            m = 10 ** (-scale)
            x = d.to(torch.int64)
            adj = torch.where(x >= 0, x + m // 2, x - m // 2)
            data = (torch.div(adj, m, rounding_mode="trunc") * m).to(d.dtype)
        valid = combine_validity(v, row_mask(batch.num_rows, cap, dev))
        return make_column(self.dtype, data, valid, batch.num_rows)

    def pretty(self) -> str:
        return (f"round({self.children[0].pretty()}, "
                f"{self.children[1].pretty()})")
