"""Comparisons and boolean predicates with Spark semantics.

Port of ``spark_rapids_tpu/expressions/predicates.py`` (fixed-width
operands): NaN equals NaN and sorts above every other double; AND/OR use
Kleene three-valued logic. String operands compare on the device in
UTF-8 byte order (``strings.py``).
"""

from __future__ import annotations

import torch

from ..columnar.vector import TorchScalar, row_mask
from ..types import BooleanT, DataType, StringType
from .base import (BinaryExpression, UnaryExpression, _DEFAULT_CTX,
                   device_parts, make_column)


def nan_aware_eq(l, r):
    out = l == r
    if l.dtype.is_floating_point:
        out = out | (torch.isnan(l) & torch.isnan(r))
    return out


def nan_aware_lt(l, r):
    if l.dtype.is_floating_point:
        return (~torch.isnan(l) & torch.isnan(r)) | (l < r)
    return l < r


def nan_aware_le(l, r):
    if l.dtype.is_floating_point:
        return torch.isnan(r) | (~torch.isnan(l) & (l <= r))
    return l <= r


class BinaryComparison(BinaryExpression):
    symbol = "?"

    @property
    def dtype(self) -> DataType:
        return BooleanT

    def pretty(self) -> str:
        return f"({self.children[0].pretty()} {self.symbol} {self.children[1].pretty()})"

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        if not isinstance(self.left.dtype, StringType):
            return super().eval_device(batch, ctx)
        from .strings import string_compare
        l = self.left.eval_device(batch, ctx)
        r = self.right.eval_device(batch, ctx)
        if isinstance(l, TorchScalar) and isinstance(r, TorchScalar):
            if l.value is None or r.value is None:
                return TorchScalar(BooleanT, None)
            a, b = l.value.encode(), r.value.encode()
            sign = torch.tensor([(a > b) - (a < b)], dtype=torch.int8)
            return TorchScalar(BooleanT, bool(self._sign_cmp(sign)[0]))
        return string_compare(self, l, r, batch)

    def _compute(self, l, r, ctx, valid):
        return self._device_cmp(l, r)

    def _device_cmp(self, l, r):
        raise NotImplementedError

    def _sign_cmp(self, sign):
        """The comparison from a three-way sign (strings)."""
        raise NotImplementedError


class EqualTo(BinaryComparison):
    symbol = "="

    def _device_cmp(self, l, r):
        return nan_aware_eq(l, r)

    def _sign_cmp(self, sign):
        return sign == 0


class LessThan(BinaryComparison):
    symbol = "<"

    def _device_cmp(self, l, r):
        return nan_aware_lt(l, r)

    def _sign_cmp(self, sign):
        return sign < 0


class LessThanOrEqual(BinaryComparison):
    symbol = "<="

    def _device_cmp(self, l, r):
        return nan_aware_le(l, r)

    def _sign_cmp(self, sign):
        return sign <= 0


class GreaterThan(BinaryComparison):
    symbol = ">"

    def _device_cmp(self, l, r):
        return nan_aware_lt(r, l)

    def _sign_cmp(self, sign):
        return sign > 0


class GreaterThanOrEqual(BinaryComparison):
    symbol = ">="

    def _device_cmp(self, l, r):
        return nan_aware_le(r, l)

    def _sign_cmp(self, sign):
        return sign >= 0


class _Kleene(BinaryExpression):
    """Three-valued AND/OR over boolean operands."""
    word = "?"

    @property
    def dtype(self) -> DataType:
        return BooleanT

    def _eval_parts(self, l, r, batch, ctx):
        cap, dev = batch.capacity, batch.device
        mask = row_mask(batch.num_rows, cap, dev)
        ld, lv = device_parts(l, cap, dev)
        rd, rv = device_parts(r, cap, dev)
        lv = lv if lv is not None else mask
        rv = rv if rv is not None else mask
        lb, rb = ld.to(torch.bool), rd.to(torch.bool)
        data, valid = self._kleene(lb, lv, rb, rv)
        return data & valid, valid & mask

    def pretty(self) -> str:
        return f"({self.children[0].pretty()} {self.word} {self.children[1].pretty()})"


class And(_Kleene):
    """Kleene AND: false AND null = false."""
    word = "AND"

    @staticmethod
    def _kleene(lb, lv, rb, rv):
        valid = (lv & rv) | (lv & ~lb) | (rv & ~rb)
        return lb & rb, valid


class Or(_Kleene):
    """Kleene OR: true OR null = true."""
    word = "OR"

    @staticmethod
    def _kleene(lb, lv, rb, rv):
        valid = (lv & rv) | (lv & lb) | (rv & rb)
        return (lb & lv) | (rb & rv), valid


class Not(UnaryExpression):
    @property
    def dtype(self) -> DataType:
        return BooleanT

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        c = self.child.eval_device(batch, ctx)
        if not hasattr(c, "data"):  # scalar
            return type(c)(BooleanT, None if c.value is None else not c.value)
        return make_column(BooleanT, ~c.data.to(torch.bool), c.validity,
                           c.num_rows)

    def pretty(self) -> str:
        return f"(NOT {self.child.pretty()})"
