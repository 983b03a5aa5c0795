"""Comparisons and boolean predicates with Spark semantics.

Port of ``spark_rapids_tpu/expressions/predicates.py`` (fixed-width
operands): NaN equals NaN and sorts above every other double; AND/OR use
Kleene three-valued logic; ``IN`` lists (``In``, ``InSet``) give Spark's
three-valued result. String operands compare on the device in
UTF-8 byte order (``strings.py``). The host evaluation (``eval_cpu``) is
pyarrow's, with Spark's NaN order where a double side holds a NaN (Arrow
compares strings by their bytes, as the device does).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..columnar.vector import TorchScalar, row_mask
from ..types import BooleanT, DataType, DecimalType, StringType
from .decimals import compare_sign
from .base import (BinaryExpression, Expression, UnaryExpression,
                   _DEFAULT_CTX, arrow_column, arrow_numpy, device_parts,
                   is_arrow, make_column, to_column)


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


def decimal_sides(expr, l, r, batch):
    """Two decimal operands of a comparison at their wider type (the
    planner casts them already; an ``IN`` item may differ): (left data,
    right data, validity)."""
    from ..types import decimal_wider_type
    from .base import combine_validity
    from .decimals import rows_as
    lt, rt = expr.left.dtype, expr.right.dtype
    w = lt if lt == rt else decimal_wider_type(lt, rt)
    cap, dev = batch.capacity, batch.device
    ld, lv = rows_as(l, lt, w, cap, dev)
    rd, rv = rows_as(r, rt, w, cap, dev)
    return ld, rd, combine_validity(lv, rv)


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

    @property
    def is_decimal(self) -> bool:
        return isinstance(self.left.dtype, DecimalType) \
            and isinstance(self.right.dtype, DecimalType)

    def _eval_parts(self, l, r, batch, ctx):
        if not self.is_decimal:
            return super()._eval_parts(l, r, batch, ctx)
        from .base import combine_validity
        ld, rd, valid = decimal_sides(self, l, r, batch)
        sign = compare_sign(ld, rd)
        out = self._device_cmp(ld, rd) if sign is None \
            else self._sign_cmp(sign)
        return out, combine_validity(valid, row_mask(batch.num_rows,
                                                     batch.capacity,
                                                     batch.device))

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        if self.is_decimal:
            from .base import eval_cpu_on_host_tensors
            return eval_cpu_on_host_tensors(self, table, ctx)
        return super().eval_cpu(table, ctx)

    def _cpu_compute(self, l, r, ctx):
        import pyarrow as pa
        import pyarrow.compute as pc
        if l.type != r.type:  # a date against its day number, as on the card
            l, r = (x.cast(pa.int32()) if pa.types.is_date32(x.type)
                    else x for x in (l, r))
        if pa.types.is_floating(l.type) or pa.types.is_floating(r.type):
            # Spark's order: NaN equals NaN and sorts above every number
            ln, lm = arrow_numpy(l, len(l), self.left.dtype)
            rn, rm = arrow_numpy(r, len(r), self.right.dtype)
            lt, rt = torch.from_numpy(np.array(ln)), torch.from_numpy(np.array(rn))
            # host tensors (eval_cpu): no device transfer
            out = self._device_cmp(lt, rt).numpy()
            return pa.array(out, mask=(lm | rm) if (lm | rm).any() else None)
        return getattr(pc, self._arrow_op)(l, r)

    def _device_cmp(self, l, r):
        raise NotImplementedError

    def _sign_cmp(self, sign):
        """The comparison from a three-way sign (strings)."""
        raise NotImplementedError


class EqualTo(BinaryComparison):
    _arrow_op = "equal"
    symbol = "="

    def _device_cmp(self, l, r):
        return nan_aware_eq(l, r)

    def _sign_cmp(self, sign):
        return sign == 0


class LessThan(BinaryComparison):
    _arrow_op = "less"
    symbol = "<"

    def _device_cmp(self, l, r):
        return nan_aware_lt(l, r)

    def _sign_cmp(self, sign):
        return sign < 0


class LessThanOrEqual(BinaryComparison):
    _arrow_op = "less_equal"
    symbol = "<="

    def _device_cmp(self, l, r):
        return nan_aware_le(l, r)

    def _sign_cmp(self, sign):
        return sign <= 0


class GreaterThan(BinaryComparison):
    _arrow_op = "greater"
    symbol = ">"

    def _device_cmp(self, l, r):
        return nan_aware_lt(r, l)

    def _sign_cmp(self, sign):
        return sign > 0


class GreaterThanOrEqual(BinaryComparison):
    _arrow_op = "greater_equal"
    symbol = ">="

    def _device_cmp(self, l, r):
        return nan_aware_le(r, l)

    def _sign_cmp(self, sign):
        return sign >= 0


class EqualNullSafe(BinaryComparison):
    """``<=>``: null-safe equality, never null (two nulls are equal, a null
    and a value are not)."""
    symbol = "<=>"

    @property
    def nullable(self) -> bool:
        return False

    @staticmethod
    def _validity(x, capacity: int, mask):
        if isinstance(x, TorchScalar):
            return torch.zeros(capacity, dtype=torch.bool,
                               device=mask.device) if x.value is None \
                else mask
        return mask if x.validity is None else x.validity & mask

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        l = self.left.eval_device(batch, ctx)
        r = self.right.eval_device(batch, ctx)
        if isinstance(l, TorchScalar) and isinstance(r, TorchScalar):
            if l.value is None or r.value is None:
                return TorchScalar(BooleanT, l.value is None
                                   and r.value is None)
            return TorchScalar(BooleanT, bool(l.value == r.value))
        cap, dev = batch.capacity, batch.device
        mask = row_mask(batch.num_rows, cap, dev)
        lv, rv = self._validity(l, cap, mask), self._validity(r, cap, mask)
        if any(isinstance(x, TorchScalar) and x.value is None
               for x in (l, r)):
            eq = torch.zeros(cap, dtype=torch.bool, device=dev)
        elif isinstance(self.left.dtype, StringType):
            from .strings import compare_strings
            eq = compare_strings(l, r, cap, dev)[0] == 0
        elif self.is_decimal:
            ld, rd, _ = decimal_sides(self, l, r, batch)
            sign = compare_sign(ld, rd)
            eq = ld == rd if sign is None else sign == 0
        else:
            ld, _ = device_parts(l, cap, dev)
            rd, _ = device_parts(r, cap, dev)
            eq = nan_aware_eq(ld, rd).expand(cap)
        data = torch.where(lv & rv, eq, lv == rv) & mask
        return make_column(BooleanT, data, None, batch.num_rows)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        import pyarrow as pa
        import pyarrow.compute as pc
        if self.is_decimal:
            from .base import eval_cpu_on_host_tensors
            return eval_cpu_on_host_tensors(self, table, ctx)
        n = table.num_rows
        l = arrow_column(self.left.eval_cpu(table, ctx), n, self.left.dtype)
        r = arrow_column(self.right.eval_cpu(table, ctx), n,
                         self.right.dtype)
        if pa.types.is_floating(l.type) or pa.types.is_floating(r.type):
            ln, lm = arrow_numpy(l, n, self.left.dtype)
            rn, rm = arrow_numpy(r, n, self.right.dtype)
            eq = nan_aware_eq(torch.from_numpy(np.array(ln)),
                              torch.from_numpy(np.array(rn))).numpy()
            return pa.array(np.where(~lm & ~rm, eq, lm == rm))
        if l.type != r.type:  # a date against its day number
            l, r = (x.cast(pa.int32()) if pa.types.is_date32(x.type)
                    else x for x in (l, r))
        eq = pc.equal(l, r)
        both_null = pc.and_(pc.is_null(l), pc.is_null(r))
        return pc.if_else(pc.is_null(eq), both_null, eq)


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

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        import pyarrow.compute as pc
        n = table.num_rows
        l = arrow_column(self.left.eval_cpu(table, ctx), n, BooleanT)
        r = arrow_column(self.right.eval_cpu(table, ctx), n, BooleanT)
        return getattr(pc, self._arrow_op)(l, r)

    def pretty(self) -> str:
        return f"({self.children[0].pretty()} {self.word} {self.children[1].pretty()})"


class And(_Kleene):
    """Kleene AND: false AND null = false."""
    word = "AND"
    _arrow_op = "and_kleene"

    @staticmethod
    def _kleene(lb, lv, rb, rv):
        valid = (lv & rv) | (lv & ~lb) | (rv & ~rb)
        return lb & rb, valid


class Or(_Kleene):
    """Kleene OR: true OR null = true."""
    word = "OR"
    _arrow_op = "or_kleene"

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

    def _cpu_compute(self, arr, ctx):
        import pyarrow.compute as pc
        return pc.invert(arr)

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

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return self._result


def _decimal_item(item: Expression) -> Expression:
    """An ``IN`` item beside a decimal value: a numeric literal as the
    decimal literal of its digits (Spark widens the list to the value's
    decimal type)."""
    import decimal
    from .base import Literal, decimal_literal_type
    if isinstance(item, Literal) and item.value is not None \
            and not isinstance(item.dtype, DecimalType) \
            and isinstance(item.value, (int, float)):
        v = decimal.Decimal(repr(item.value)) \
            if isinstance(item.value, float) else decimal.Decimal(item.value)
        return Literal(v, decimal_literal_type(v))
    return item


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
        if isinstance(self.value.dtype, DecimalType):
            return [_decimal_item(i) for i in self.children[1:]]
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

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        """Spark's three-valued IN over the host rows: the item
        comparisons (``EqualTo``'s, NaN matching NaN) or'd in Kleene
        logic, null for a null value."""
        import pyarrow.compute as pc
        n = table.num_rows
        v = self.value.eval_cpu(table, ctx)
        value = _Evaluated(v, self.value.dtype)
        found = arrow_column(False, n, BooleanT)
        for item in self.items:
            eq = arrow_column(EqualTo(value, item).eval_cpu(table, ctx), n,
                              BooleanT)
            found = pc.or_kleene(found, eq)
        out = pc.if_else(pc.is_null(arrow_column(v, n, self.value.dtype)),
                         arrow_column(None, n, BooleanT), found)
        return out if is_arrow(v) or table is not None else out[0].as_py()

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
        if isinstance(self.value.dtype, DecimalType):
            return In(self.value, [Literal(i) for i in self.items]
                      ).eval_device(batch, ctx)
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

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        from .base import Literal
        if isinstance(self.value.dtype, DecimalType):
            return In(self.value, [Literal(i) for i in self.items]
                      ).eval_cpu(table, ctx)
        return In(self.value, [Literal(i, self.value.dtype)
                               for i in self.items]).eval_cpu(table, ctx)

    def pretty(self) -> str:
        return f"{self.value.pretty()} INSET {self.items}"
