"""Bitwise expressions (port of ``spark_rapids_tpu/expressions/bitwise.py``
with their host evaluation): ``& | ^ ~``, ``bit_count`` and the shifts
``<<``, ``>>`` (arithmetic) and ``>>>`` (Java's logical shift at the
type's width). A shift distance is taken modulo the width, as Java does.

torch has no dependable unsigned arithmetic on CUDA, so ``>>>`` works in
int64: the value's two's-complement bits at its width, masked to that
width, shifted right (a non-negative int64 shifts in zeros), and cast
back with wrap. ``bit_count`` counts set bits the same way.

``bit_count`` gives Spark's answer: Spark widens every integral type to
long before ``Long.bitCount``, so ``bit_count(-1)`` of an int is 64. The
reference counts at the type's own width (32); ROADMAP C-ref.
"""

from __future__ import annotations

import torch

from ..types import DataType, IntegerT
from .base import (_DEFAULT_CTX, BinaryExpression, UnaryExpression,
                   eval_cpu_on_host_tensors)


class _BitwiseBinary(BinaryExpression):
    symbol = "?"

    @property
    def dtype(self) -> DataType:
        return self.left.dtype

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return eval_cpu_on_host_tensors(self, table, ctx)

    def pretty(self) -> str:
        return f"({self.left.pretty()} {self.symbol} {self.right.pretty()})"


class BitwiseAnd(_BitwiseBinary):
    symbol = "&"

    def _compute(self, ld, rd, ctx, valid):
        return ld & rd.to(ld.dtype)


class BitwiseOr(_BitwiseBinary):
    symbol = "|"

    def _compute(self, ld, rd, ctx, valid):
        return ld | rd.to(ld.dtype)


class BitwiseXor(_BitwiseBinary):
    symbol = "^"

    def _compute(self, ld, rd, ctx, valid):
        return ld ^ rd.to(ld.dtype)


class BitwiseNot(UnaryExpression):
    def _compute(self, d, ctx, valid):
        return ~d

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return eval_cpu_on_host_tensors(self, table, ctx)

    def pretty(self) -> str:
        return f"~{self.child.pretty()}"


def popcount64(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64's 64-bit two's complement (SWAR; the
    logical shifts mask off the sign's fill)."""
    x = x.to(torch.int64)
    m1, m2, m4 = 0x5555555555555555, 0x3333333333333333, 0x0F0F0F0F0F0F0F0F
    x = x - ((x >> 1) & m1)
    x = (x & m2) + ((x >> 2) & m2)
    x = (x + (x >> 4)) & m4
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return (x & 0x7F).to(torch.int32)


class BitwiseCount(UnaryExpression):
    """bit_count(x): set bits of x widened to long (Spark's
    ``Long.bitCount``; booleans count 1 for true)."""

    @property
    def dtype(self) -> DataType:
        return IntegerT

    def _compute(self, d, ctx, valid):
        return popcount64(d.to(torch.int64))

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return eval_cpu_on_host_tensors(self, table, ctx)


class _ShiftBase(_BitwiseBinary):
    def _shift(self, ld: torch.Tensor, dist: torch.Tensor, width: int):
        raise NotImplementedError

    def _compute(self, ld, rd, ctx, valid):
        width = ld.element_size() * 8
        dist = rd.to(torch.int64) & (width - 1)
        return self._shift(ld, dist, width)


class ShiftLeft(_ShiftBase):
    symbol = "<<"

    def _shift(self, ld, dist, width):
        return ld << dist.to(ld.dtype)


class ShiftRight(_ShiftBase):
    """Arithmetic (sign-extending) right shift."""
    symbol = ">>"

    def _shift(self, ld, dist, width):
        return ld >> dist.to(ld.dtype)


class ShiftRightUnsigned(_ShiftBase):
    """Java's ``>>>``: a logical right shift at the type's width."""
    symbol = ">>>"

    def _shift(self, ld, dist, width):
        x = ld.to(torch.int64)
        if width == 64:
            # (x >> r) & (2^(64 - r) - 1), r = 0 left alone
            keep = torch.where(dist == 0, torch.full_like(dist, -1),
                               (torch.ones_like(dist) << (64 - dist)) - 1)
            return torch.where(dist == 0, x, (x >> dist) & keep)
        u = x & ((1 << width) - 1)
        return (u >> dist).to(ld.dtype)
