"""Null and NaN handling (port of
``spark_rapids_tpu/expressions/nullexprs.py``, with the host evaluation):
``IS NULL``, ``IS NOT NULL``, ``coalesce``, ``isnan``, ``nanvl``,
``AtLeastNNonNulls`` (``df.na.drop``'s filter; a float NaN counts as
null, as in Spark) and the optimizer's markers ``KnownNotNull``,
``KnownFloatingPointNormalized`` (pass-throughs) and
``NormalizeNaNAndZero`` (every NaN to the canonical NaN, -0.0 to 0.0).
The tests are never null themselves; padding rows read false."""

from __future__ import annotations

import torch

from ..columnar.vector import TorchColumnVector, TorchScalar, lane_mask, row_mask
from ..types import (BooleanT, DataType, DecimalType, FractionalType,
                     StringT, StringType)
from .decimals import rows_as, zeros_rows
from .base import (_DEFAULT_CTX, Expression, UnaryExpression, arrow_column,
                   combine_validity, device_parts, eval_cpu_on_host_tensors,
                   is_arrow, make_column)


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
        dec = isinstance(self.dtype, DecimalType)
        data = zeros_rows(cap, self.dtype, dev)
        valid = torch.zeros(cap, dtype=torch.bool, device=dev)
        for c, v in zip(self.children, values):
            if dec:  # each argument at the result's scale
                d, vv = rows_as(v, c.dtype, self.dtype, cap, dev)
            else:
                d, vv = device_parts(v, cap, dev)
                d = torch.broadcast_to(d, (cap,)).to(carrier)
            vv = mask if vv is None else vv & mask
            take = vv & ~valid
            data = torch.where(lane_mask(take, data), d, data)
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


class IsNaN(UnaryExpression):
    """isnan(x): true for NaN, false otherwise and for null."""

    @property
    def dtype(self) -> DataType:
        return BooleanT

    @property
    def nullable(self) -> bool:
        return False

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        cap, dev = batch.capacity, batch.device
        d, v = device_parts(self.child.eval_device(batch, ctx), cap, dev)
        d = torch.broadcast_to(d, (cap,))
        nan = torch.isnan(d) if d.is_floating_point() else \
            torch.zeros(cap, dtype=torch.bool, device=dev)
        return make_column(BooleanT, nan & combine_validity(
            v, row_mask(batch.num_rows, cap, dev)), None, batch.num_rows)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return eval_cpu_on_host_tensors(self, table, ctx)


class NaNvl(Expression):
    """nanvl(a, b): ``b`` where ``a`` is NaN, else ``a`` (null where the
    value taken is)."""

    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    @property
    def dtype(self) -> DataType:
        return self.children[0].dtype

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        cap, dev = batch.capacity, batch.device
        mask = row_mask(batch.num_rows, cap, dev)
        ad, av = device_parts(self.children[0].eval_device(batch, ctx), cap,
                              dev)
        bd, bv = device_parts(self.children[1].eval_device(batch, ctx), cap,
                              dev)
        ad = torch.broadcast_to(ad, (cap,))
        nan = torch.isnan(ad)
        data = torch.where(nan, torch.broadcast_to(bd, (cap,)).to(ad.dtype),
                           ad)
        av = mask if av is None else av & mask
        bv = mask if bv is None else bv & mask
        return make_column(self.dtype, data, torch.where(nan, bv, av),
                           batch.num_rows)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return eval_cpu_on_host_tensors(self, table, ctx)


class AtLeastNNonNulls(Expression):
    """True where at least ``n`` children are non-null (a float NaN counts
    as null, as in Spark)."""

    def __init__(self, n: int, *children: Expression):
        self.n = int(n)
        self.children = tuple(children)

    @property
    def dtype(self) -> DataType:
        return BooleanT

    @property
    def nullable(self) -> bool:
        return False

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        cap, dev = batch.capacity, batch.device
        mask = row_mask(batch.num_rows, cap, dev)
        count = torch.zeros(cap, dtype=torch.int32, device=dev)
        for c in self.children:
            v = c.eval_device(batch, ctx)
            if isinstance(v, TorchScalar):
                ok = v.value is not None and not (
                    isinstance(v.value, float) and v.value != v.value)
                count = count + int(ok)
                continue
            ok = mask if v.validity is None else v.validity & mask
            if v.offsets is None and v.data.is_floating_point():
                ok = ok & ~torch.isnan(v.data)
            count = count + ok.to(torch.int32)
        return make_column(BooleanT, (count >= self.n) & mask, None,
                           batch.num_rows)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return eval_cpu_on_host_tensors(self, table, ctx)

    def pretty(self) -> str:
        return f"atleastnnonnulls({self.n}, " \
            f"{', '.join(c.pretty() for c in self.children)})"


class _Marker(UnaryExpression):
    """An optimizer's marker: evaluation is the child's."""

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        return self.child.eval_device(batch, ctx)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return self.child.eval_cpu(table, ctx)


class KnownNotNull(_Marker):
    """The child is known non-null: a pass-through (dropping the validity
    would turn a wrongly null row into a zero)."""

    @property
    def nullable(self) -> bool:
        return False

    def pretty(self) -> str:
        return f"knownnotnull({self.child.pretty()})"


class KnownFloatingPointNormalized(_Marker):
    """NaN and -0.0 already normalized: a pass-through."""


def normalize_nan_zero(d: torch.Tensor) -> torch.Tensor:
    """Every NaN to the canonical NaN and -0.0 to 0.0 (a float tensor)."""
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    d = torch.where(d == 0, zero, d)
    return torch.where(torch.isnan(d), torch.full((), float("nan"),
                                                  dtype=d.dtype,
                                                  device=d.device), d)


class NormalizeNaNAndZero(UnaryExpression):
    """Every NaN to the canonical NaN and -0.0 to 0.0, so float keys
    compare by equality."""

    def _compute(self, d, ctx, valid):
        return normalize_nan_zero(d) if d.is_floating_point() else d

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        if not isinstance(self.child.dtype, FractionalType):
            return self.child.eval_cpu(table, ctx)
        return eval_cpu_on_host_tensors(self, table, ctx)
