"""Cast between numeric (and boolean/date) types with Spark's non-ANSI
semantics: integer narrowing wraps like Java, float → integer truncates
toward zero with NaN → 0 and out-of-range values clamped, date → integer
gives the day number, integer/float → double widens.

Port of the numeric part of ``spark_rapids_tpu/expressions/cast.py``
(the reference's device path); string and timestamp casts are not yet
ported. A literal casts by the same rules as a column.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..columnar.vector import TorchScalar, row_mask
from ..types import (BooleanType, DataType, DateType, FractionalType,
                     IntegralType, NullType, NumericType, StringType)
from .base import (_DEFAULT_CTX, Expression, UnaryExpression,
                   combine_validity, device_parts, make_column)

_INT_BOUNDS = {np.dtype(np.int8): (-128, 127),
               np.dtype(np.int16): (-32768, 32767),
               np.dtype(np.int32): (-2**31, 2**31 - 1),
               np.dtype(np.int64): (-2**63, 2**63 - 1)}


def _castable(src: DataType, dst: DataType) -> bool:
    ok = (NumericType, BooleanType, DateType, NullType)
    return isinstance(src, ok) and isinstance(dst, ok) \
        and not isinstance(dst, NullType)


class Cast(UnaryExpression):
    def __init__(self, child: Expression, to_type: DataType,
                 ansi: Optional[bool] = None):
        super().__init__(child)
        self._to = to_type
        self._ansi = ansi

    @property
    def dtype(self) -> DataType:
        return self._to

    @property
    def nullable(self) -> bool:
        return True

    def pretty(self) -> str:
        return f"cast({self.child.pretty()} AS {self._to.simple_string()})"

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        src, dst = self.child.dtype, self._to
        ansi = self._ansi if self._ansi is not None else ctx.ansi
        if ansi:
            raise NotImplementedError("ANSI-mode cast not yet ported")
        if src != dst and not _castable(src, dst):
            raise NotImplementedError(f"cast {src} -> {dst} not yet ported")
        c = self.child.eval_device(batch, ctx)
        if isinstance(c, TorchScalar):
            return TorchScalar(dst, _cast_scalar(c.value, dst))
        if src == dst:
            return c
        cap, dev = batch.capacity, batch.device
        d, v = device_parts(c, cap, dev)
        valid = combine_validity(v, row_mask(batch.num_rows, cap, dev))
        return make_column(dst, _numeric_cast(d, src, dst), valid,
                           batch.num_rows)


def _numeric_cast(d: torch.Tensor, src: DataType, dst: DataType):
    carrier = dst.torch_dtype
    if isinstance(dst, BooleanType):
        return d != 0
    if isinstance(src, FractionalType) and isinstance(dst, IntegralType):
        lo, hi = _INT_BOUNDS[np.dtype(dst.np_dtype)]
        wide = np.dtype(dst.np_dtype).itemsize == 8
        v = torch.trunc(torch.where(torch.isnan(d), torch.zeros_like(d), d))
        # 2**63-1 is not float-representable: exact power-of-two range tests
        hi_f = 2.0 ** 63 if wide else float(hi)
        in_range = (v >= float(lo)) & ((v < hi_f) if wide else (v <= hi_f))
        safe = torch.where(in_range, v, torch.zeros_like(v)).to(carrier)
        return torch.where(v >= hi_f, torch.full_like(safe, hi),
                           torch.where(v < float(lo),
                                       torch.full_like(safe, lo), safe))
    return d.to(carrier)  # integer narrowing wraps like Java


def _cast_scalar(v, dst: DataType):
    if v is None:
        return None
    if isinstance(dst, BooleanType):
        return bool(v)
    if isinstance(dst, (IntegralType, DateType)):
        lo, hi = _INT_BOUNDS[np.dtype(dst.np_dtype)]
        if isinstance(v, float):  # Java (int)/(long): NaN 0, clamped
            return 0 if v != v else int(max(min(v, hi), lo))
        iv = int(v)
        return ((iv - lo) % (hi - lo + 1)) + lo  # java wrap
    if isinstance(dst, FractionalType):
        return float(v)
    if isinstance(dst, StringType):
        raise NotImplementedError("cast to string not yet ported")
    raise NotImplementedError(f"scalar cast to {dst} not yet ported")
