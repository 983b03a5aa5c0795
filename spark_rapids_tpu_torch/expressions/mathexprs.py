"""``round(x, scale)`` with Spark's HALF_UP and ``floor(x)`` (port of
``Round`` and ``Floor`` in ``spark_rapids_tpu/expressions/mathexprs.py``,
with their host evaluation; ``BRound`` and the other math functions are
not yet ported).

Floats round as Spark does: ``BigDecimal.valueOf(x)`` (the shortest
round-trip decimal text, Python's ``repr``) rounded HALF_UP at the scale,
back to a double; NaN and infinities pass through. The reference computes
``trunc(x * 10^s + 0.5 * sign) / 10^s`` in float64, which departs from
Spark near a tie (``round(1.005, 2)`` is 1.0 there, 1.01 in Spark), where
``x * 10^s`` overflows (``round(1e308, 2)``) and past 2^52
(ROADMAP C-ref-19). The port keeps that formula for every row whose
scaled value lies clear of a tie, with a margin far above the float
error, and below 2^52: there it gives Spark's digits. The few other rows
(near a tie, or at 2^52 and past) are read back and rounded exactly
through their decimal text (``_round_decimal_text``); the one host read
a batch is whether any row needs that. Integers keep their value for
``s >= 0``; a
negative scale rounds to a multiple of ``m = 10^-s`` with the half added
away from zero, then divides truncating toward zero, as Java's integer
division does (``round(-14, -1)`` is -10). The reference divides with
``//``, which floors, and so rounds a negative integer that is not a tie
one step further from zero; the two agree on non-negative integers and on
ties.
"""

from __future__ import annotations

import decimal

import numpy as np
import torch

from ..columnar.vector import audited_sync_int, audited_tolist, row_mask
from ..types import DataType, FractionalType, LongT
from .base import (_DEFAULT_CTX, Expression, Literal, UnaryExpression,
                   arrow_numpy, combine_validity, device_parts, is_arrow,
                   make_column)

_TWO52 = 2.0 ** 52


def _round_decimal_text(x: float, scale: int) -> float:
    """Spark's round of one finite double (a float widened to one, as
    Spark does): its shortest decimal text rounded HALF_UP at ``scale``,
    back to the nearest double."""
    d = decimal.Decimal(repr(float(x)))
    if d.as_tuple().exponent >= -scale:  # no digit below the scale
        return float(d) + 0.0
    ctx = decimal.Context(prec=len(d.as_tuple().digits) + abs(scale) + 2,
                          rounding=decimal.ROUND_HALF_UP)
    return float(d.quantize(decimal.Decimal(1).scaleb(-scale),
                            context=ctx)) + 0.0


def round_float_half_up(d: torch.Tensor, scale: int) -> torch.Tensor:
    """Spark's ``round(x, scale)`` of a float tensor on its device: one
    pass for the rows clear of a tie, the others through their decimal
    text on the host."""
    x = d.to(torch.float64)
    if scale >= 0:
        y = x * (10.0 ** scale)
    else:
        y = x / (10.0 ** -scale)
    half = torch.where(y >= 0, 0.5, -0.5).to(torch.float64)
    k = torch.trunc(y + half)
    out = k / (10.0 ** scale) if scale >= 0 else k * (10.0 ** -scale)
    out = out + 0.0  # Spark's BigDecimal has no negative zero
    finite = torch.isfinite(x)
    ay = torch.abs(y)
    # the scaled value's error is a few ulps; rows within far more than
    # that of a tie, or past 2^52 (or overflowed), take the exact route
    near = (torch.abs(ay - torch.floor(ay) - 0.5) <= ay * 2.0 ** -44
            + 2.0 ** -60) | ~(ay < _TWO52)
    slow = finite & near
    out = torch.where(finite, out, x)
    if audited_sync_int(slow.any(), "scalar"):
        idx = torch.nonzero(slow).flatten()
        vals = [_round_decimal_text(v, scale)
                for v in audited_tolist(x[idx], "fetch")]
        out[idx] = torch.tensor(vals, dtype=torch.float64).to(out.device)
    return out.to(d.dtype)


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
        valid = combine_validity(v, row_mask(batch.num_rows, cap, dev))
        if valid is not None:  # null slots stay clear of the host route
            d = torch.where(valid, d, torch.zeros((), dtype=d.dtype,
                                                  device=dev))
        return make_column(self.dtype, _round_tensor(d, scale), valid,
                           batch.num_rows)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        import pyarrow as pa
        from ..types import to_arrow
        scale = self._scale()
        c = self.children[0].eval_cpu(table, ctx)
        n = len(c) if is_arrow(c) else 1
        vals, null = arrow_numpy(c, n, self.dtype)
        # a host tensor (eval_cpu): no device transfer
        out = _round_tensor(torch.from_numpy(np.array(vals)), scale).numpy()
        arr = pa.array(out, type=to_arrow(self.dtype),
                       mask=null if null.any() else None)
        return arr if is_arrow(c) else (None if c is None else
                                        arr[0].as_py())

    def pretty(self) -> str:
        return (f"round({self.children[0].pretty()}, "
                f"{self.children[1].pretty()})")


def _round_tensor(d: torch.Tensor, scale: int) -> torch.Tensor:
    if d.dtype.is_floating_point:
        return round_float_half_up(d, scale)
    if scale >= 0:
        return d
    if -scale >= 19:  # every int64 rounds to 0
        return torch.zeros_like(d)
    m = 10 ** (-scale)
    x = d.to(torch.int64)
    adj = torch.where(x >= 0, x + m // 2, x - m // 2)
    return (torch.div(adj, m, rounding_mode="trunc") * m).to(d.dtype)


_TWO63 = 2.0 ** 63


class Floor(UnaryExpression):
    """``floor(double)`` → bigint with Java's (long) conversion: NaN is 0,
    values past the long range clamp to its ends; integers pass
    through."""

    @property
    def dtype(self) -> DataType:
        return LongT if isinstance(self.child.dtype, FractionalType) \
            else self.child.dtype

    def _compute(self, d, ctx, valid):
        if not d.is_floating_point():
            return d
        v = torch.floor(d.to(torch.float64))
        v = torch.where(torch.isnan(v), 0.0, v)
        in_range = (v > -_TWO63) & (v < _TWO63)
        out = torch.where(in_range, v, 0.0).to(torch.int64)
        out = torch.where(v >= _TWO63, torch.iinfo(torch.int64).max, out)
        return torch.where(v <= -_TWO63, torch.iinfo(torch.int64).min, out)

    def _cpu_compute(self, arr, ctx):
        import pyarrow as pa
        if not pa.types.is_floating(arr.type):
            return arr
        v = np.floor(np.asarray(arr.fill_null(0.0).to_numpy(
            zero_copy_only=False), np.float64))
        with np.errstate(invalid="ignore"):
            out = np.where(np.isnan(v), 0.0, v)
            big = out >= _TWO63
            small = out <= -_TWO63
            res = np.where(big | small, 0.0, out).astype(np.int64)
        res[big] = np.iinfo(np.int64).max
        res[small] = np.iinfo(np.int64).min
        mask = np.asarray(arr.is_null()) if arr.null_count else None
        return pa.array(res, mask=mask)
