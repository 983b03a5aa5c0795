"""Comparisons and boolean predicates with Spark semantics.

Port of ``spark_rapids_tpu/expressions/predicates.py`` (fixed-width
operands): NaN equals NaN and sorts above every other double; AND/OR use
Kleene three-valued logic; ``IN`` lists (``In``, ``InSet``) give Spark's
three-valued result. String operands compare on the device in
UTF-8 byte order (``strings.py``).
"""

from __future__ import annotations

from typing import List

import torch

from ..columnar.vector import TorchScalar, row_mask
from ..types import BooleanT, DataType, StringType
from .base import (BinaryExpression, Expression, UnaryExpression,
                   _DEFAULT_CTX, device_parts, make_column, to_column)


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
        return f"NOT {self.child.pretty()}"


def _in_result(found: torch.Tensor, value_valid: torch.Tensor,
               null_item: torch.Tensor, num_rows: int):
    """Spark's three-valued IN: null for a null value; true on a match;
    else null when the list holds a null, else false."""
    valid = value_valid & (found | ~null_item)
    return make_column(BooleanT, found & valid, valid, num_rows)


class _Evaluated(Expression):
    """An already evaluated column or scalar, as an expression."""

    def __init__(self, result, dtype: DataType):
        self.children = ()
        self._result = result
        self._dtype = dtype

    @property
    def dtype(self) -> DataType:
        return self._dtype

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        return self._result


class In(Expression):
    """``value IN (item, ...)`` with Spark's nulls (reference ``In``): a
    null value gives null; no match with a null in the list gives null.
    A string value compares UTF-8 bytes on the device, item by item, as
    the string comparisons do. The reference never rewrites ``In`` to
    ``InSet`` (Spark's optimizer does past 10 items), so neither does the
    port: ``explain()`` shows the ``IN`` list."""

    def __init__(self, value: Expression, items: List[Expression]):
        self.children = (value, *items)

    @property
    def value(self) -> Expression:
        return self.children[0]

    @property
    def items(self):
        return self.children[1:]

    @property
    def dtype(self) -> DataType:
        return BooleanT

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        cap, dev = batch.capacity, batch.device
        mask = row_mask(batch.num_rows, cap, dev)
        v = self.value.eval_device(batch, ctx)
        if isinstance(v, TorchScalar):
            vv = mask if v.value is not None else torch.zeros_like(mask)
        else:
            vv = v.validity_or_true() & mask
        value = _Evaluated(v, self.value.dtype)  # evaluated once
        found = torch.zeros(cap, dtype=torch.bool, device=dev)
        null_item = torch.zeros(cap, dtype=torch.bool, device=dev)
        for item in self.items:
            eq = to_column(EqualTo(value, item).eval_device(batch, ctx),
                           batch, BooleanT)
            iv = eq.validity_or_true()
            found = found | (eq.data.to(torch.bool) & iv)
            # an invalid comparison over a valid value: a null item
            null_item = null_item | (~iv & vv)
        return _in_result(found, vv, null_item, batch.num_rows)

    def pretty(self) -> str:
        return (f"{self.value.pretty()} IN "
                f"({', '.join(i.pretty() for i in self.items)})")


class InSet(Expression):
    """``value IN <set>`` over a list of Python values (reference
    ``InSet``): one ``torch.isin`` against the set for fixed-width values,
    NaN matching NaN; string values take ``In``'s comparisons."""

    def __init__(self, value: Expression, items):
        self.children = (value,)
        self.items = list(items)
        self._has_null = any(i is None for i in self.items)
        self._non_null = [i for i in self.items if i is not None]

    @property
    def value(self) -> Expression:
        return self.children[0]

    @property
    def dtype(self) -> DataType:
        return BooleanT

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        from .base import Literal
        if isinstance(self.value.dtype, StringType):
            return In(self.value, [Literal(i, self.value.dtype)
                                   for i in self.items]).eval_device(batch,
                                                                    ctx)
        cap, dev = batch.capacity, batch.device
        mask = row_mask(batch.num_rows, cap, dev)
        vd, vv = device_parts(self.value.eval_device(batch, ctx), cap, dev)
        vd = torch.broadcast_to(vd, (cap,))
        vv = mask if vv is None else vv & mask
        found = torch.zeros(cap, dtype=torch.bool, device=dev)
        if self._non_null:
            items = torch.tensor(self._non_null, device=dev).to(vd.dtype)
            found = torch.isin(vd, items)
            if vd.dtype.is_floating_point and any(
                    isinstance(i, float) and i != i for i in self._non_null):
                found = found | torch.isnan(vd)
        null_item = torch.full((cap,), self._has_null, dtype=torch.bool,
                               device=dev)
        return _in_result(found, vv, null_item, batch.num_rows)

    def pretty(self) -> str:
        return f"{self.value.pretty()} INSET {self.items}"
