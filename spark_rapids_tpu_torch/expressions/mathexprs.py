"""Math expressions (port of ``spark_rapids_tpu/expressions/mathexprs.py``,
with their host evaluation): ``round`` (HALF_UP) and ``bround``
(HALF_EVEN), ``floor`` and ``ceil`` (of a decimal: Spark 3.4's decimal
result types and exact rounding on the unscaled integer,
``decimals.round_decimal`` on the card, ``decimals.round_arr`` in the
host engine), and the double functions: the
``sqrt``/``exp``/trigonometric family (``_DoubleUnary``), the log family
(``_LogBase``, ``Logarithm``; Spark's null for a value at or below the
asymptote), ``pow``, ``atan2``, ``hypot``, ``signum``, ``rint``, ``cot``,
``degrees`` and ``radians``. Their inputs are widened to double (by the
planner's coercion, and again here); host evaluation runs the same torch
code over CPU tensors (``base.eval_cpu_on_host_tensors``).

Where the reference departs from Spark the port gives Spark's answer
(ROADMAP Queue C): ``pow`` keeps Java's NaN for a NaN exponent and for
``(±1) ^ ±inf`` (C's ``pow`` gives 1); ``asinh``, ``acosh`` and ``atanh``
are Spark's own formulas (``log(x + sqrt(x² ± 1))``,
``(log1p(x) - log1p(-x)) / 2``), not C's; ``bround`` of a double is
HALF_EVEN on its decimal text.

Floats round as Spark does: ``BigDecimal.valueOf(x)`` (the shortest
round-trip decimal text, Python's ``repr``) rounded HALF_UP at the scale,
back to a double; NaN and infinities pass through. The reference computes
``trunc(x * 10^s + 0.5 * sign) / 10^s`` in float64, which departs from
Spark near a tie (``round(1.005, 2)`` is 1.0 there, 1.01 in Spark), where
``x * 10^s`` overflows (``round(1e308, 2)``) and past 2^52
(ROADMAP C-ref-19). The port keeps that formula for every row whose
scaled value lies clear of a tie, with a margin far above the float
error, and below 2^52: there it gives Spark's digits (HALF_UP and
HALF_EVEN agree off a tie). The few other rows (near a tie, or at 2^52
and past) are read back and rounded exactly through their decimal text
(``_round_decimal_text``); the one host read a batch is whether any row
needs that. Integers keep their value for ``s >= 0``; a negative scale
rounds to a multiple of ``m = 10^-s``: HALF_UP with the half added away
from zero, then a division truncating toward zero, as Java's integer
division does (``round(-14, -1)`` is -10; the reference divides with
``//``, which floors, and so rounds a negative integer that is not a tie
one step further from zero; the two agree on non-negative integers and
on ties); HALF_EVEN from the floored quotient and its remainder. A scale
that is not a literal raises, as Spark's analyzer refuses it.
"""

from __future__ import annotations

import decimal

import numpy as np
import torch

from ..columnar.vector import audited_sync_int, audited_tolist, row_mask
from ..types import DataType, DoubleT, FractionalType, LongT
from .base import (_DEFAULT_CTX, BinaryExpression, Expression, Literal,
                   UnaryExpression, arrow_numpy, combine_validity,
                   device_parts, eval_cpu_on_host_tensors, is_arrow,
                   make_column)

_TWO52 = 2.0 ** 52


def _round_decimal_text(x: float, scale: int,
                        rounding: str = decimal.ROUND_HALF_UP) -> float:
    """Spark's round of one finite double (a float widened to one, as
    Spark does): its shortest decimal text rounded (HALF_UP, or
    ``rounding``) at ``scale``, back to the nearest double."""
    d = decimal.Decimal(repr(float(x)))
    if d.as_tuple().exponent >= -scale:  # no digit below the scale
        return float(d) + 0.0
    ctx = decimal.Context(prec=len(d.as_tuple().digits) + abs(scale) + 2,
                          rounding=rounding)
    return float(d.quantize(decimal.Decimal(1).scaleb(-scale),
                            context=ctx)) + 0.0


def round_float_half_up(d: torch.Tensor, scale: int,
                        rounding: str = decimal.ROUND_HALF_UP
                        ) -> torch.Tensor:
    """Spark's ``round(x, scale)`` (``bround`` with ROUND_HALF_EVEN) of a
    float tensor on its device: one pass for the rows clear of a tie, the
    others through their decimal text on the host."""
    x = d.to(torch.float64)
    # the power of ten as a tensor: CUDA divides by a Python scalar as a
    # multiply by its reciprocal, an ulp off the quotient on about a tenth
    # of rows, where Spark's BigDecimal → double is correctly rounded
    p10 = torch.full((), 10.0 ** abs(scale), dtype=torch.float64,
                     device=x.device)
    y = x * p10 if scale >= 0 else x / p10
    half = torch.where(y >= 0, 0.5, -0.5).to(torch.float64)
    k = torch.trunc(y + half)
    out = k / p10 if scale >= 0 else k * p10
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
        vals = [_round_decimal_text(v, scale, rounding)
                for v in audited_tolist(x[idx], "fetch")]
        out[idx] = torch.tensor(vals, dtype=torch.float64).to(out.device)
    return out.to(d.dtype)


def _is_decimal(e) -> bool:
    from ..types import DecimalType
    return isinstance(e.dtype, DecimalType)


def _decimal_round_device(expr, batch, ctx, scale: int, mode: str):
    """A decimal child rounded on the card (``decimals.round_decimal``): a
    value past the result's precision is null, under ANSI an error."""
    from . import decimals as DEC
    child, dst = expr.children[0], expr.dtype
    cap, dev = batch.capacity, batch.device
    d, v = device_parts(child.eval_device(batch, ctx), cap, dev)
    d = DEC.broadcast_rows(d, cap, child.dtype)
    valid = combine_validity(v, row_mask(batch.num_rows, cap, dev))
    data, ovf = DEC.round_decimal(d, child.dtype, dst, scale, mode)
    valid = DEC.overflow_check(ovf, valid, ctx.ansi,
                               f"decimal overflow in {expr.fn_name}")
    return make_column(dst, data, valid, batch.num_rows)


def _decimal_round_cpu(expr, table, ctx, scale: int, mode: str):
    """The host engine's decimal rounding: the unscaled Python ints by
    ``decimals.round_arr``, Spark's result type."""
    from . import decimals as DEC
    from .base import ExpressionError, arrow_column
    child, dst = expr.children[0], expr.dtype
    src = child.dtype
    c = child.eval_cpu(table, ctx)
    n = len(c) if is_arrow(c) else 1
    v, ok = DEC.arrow_object(arrow_column(c, n, src))
    k = src.scale - scale
    if k <= 0:
        out = DEC.rescale_arr(v, src.scale, dst.scale)
    else:
        out = DEC.round_arr(v, k, mode, 10 ** max(-scale, 0))
    fits = (np.abs(out) < 10 ** dst.precision).astype(bool)
    if ctx.ansi and (ok & ~fits).any():
        raise ExpressionError(f"decimal overflow in {expr.fn_name}")
    arr = DEC.ints_to_arrow(out, dst, ok & fits)
    return arr if is_arrow(c) else arr[0].as_py()


_DECIMAL_MODES = {decimal.ROUND_HALF_UP: "half_up",
                  decimal.ROUND_HALF_EVEN: "half_even"}


class Round(Expression):
    rounding = decimal.ROUND_HALF_UP
    fn_name = "round"

    def __init__(self, child: Expression, scale: Expression):
        self.children = (child, scale)

    @property
    def dtype(self) -> DataType:
        if _is_decimal(self.children[0]):
            from ..types import round_decimal_type
            return round_decimal_type(self.children[0].dtype, self._scale())
        return self.children[0].dtype

    def _scale(self) -> int:
        s = self.children[1]
        if not isinstance(s, Literal) or s.value is None:
            raise NotImplementedError(
                f"{self.fn_name} with a non-literal scale: Spark's analyzer "
                "refuses it")
        return int(s.value)

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        cap, dev = batch.capacity, batch.device
        scale = self._scale()
        if _is_decimal(self.children[0]):
            return _decimal_round_device(self, batch, ctx, scale,
                                         _DECIMAL_MODES[self.rounding])
        d, v = device_parts(self.children[0].eval_device(batch, ctx), cap,
                            dev)
        d = torch.broadcast_to(d, (cap,))
        valid = combine_validity(v, row_mask(batch.num_rows, cap, dev))
        if valid is not None:  # null slots stay clear of the host route
            d = torch.where(valid, d, torch.zeros((), dtype=d.dtype,
                                                  device=dev))
        return make_column(self.dtype, _round_tensor(d, scale,
                                                     self.rounding), valid,
                           batch.num_rows)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        import pyarrow as pa
        from ..types import to_arrow
        scale = self._scale()
        if _is_decimal(self.children[0]):
            return _decimal_round_cpu(self, table, ctx, scale,
                                      _DECIMAL_MODES[self.rounding])
        c = self.children[0].eval_cpu(table, ctx)
        n = len(c) if is_arrow(c) else 1
        vals, null = arrow_numpy(c, n, self.dtype)
        # a host tensor (eval_cpu): no device transfer
        out = _round_tensor(torch.from_numpy(np.array(vals)), scale,
                            self.rounding).numpy()
        arr = pa.array(out, type=to_arrow(self.dtype),
                       mask=null if null.any() else None)
        return arr if is_arrow(c) else (None if c is None else
                                        arr[0].as_py())

    def pretty(self) -> str:
        return (f"{self.fn_name}({self.children[0].pretty()}, "
                f"{self.children[1].pretty()})")


class BRound(Round):
    """``bround(x, scale)``: HALF_EVEN (banker's) rounding, Spark's
    ``BigDecimal`` semantics as ``Round``'s."""
    rounding = decimal.ROUND_HALF_EVEN
    fn_name = "bround"


def _round_tensor(d: torch.Tensor, scale: int,
                  rounding: str = decimal.ROUND_HALF_UP) -> torch.Tensor:
    if d.dtype.is_floating_point:
        return round_float_half_up(d, scale, rounding)
    if scale >= 0:
        return d
    if -scale >= 19:  # every int64 rounds to 0
        return torch.zeros_like(d)
    m = 10 ** (-scale)
    x = d.to(torch.int64)
    if rounding == decimal.ROUND_HALF_EVEN:
        q = torch.div(x, m, rounding_mode="floor")
        rem = x - q * m  # in [0, m)
        up = (rem > m // 2) | ((rem == m // 2) & (torch.remainder(q, 2) != 0))
        return ((q + up.to(torch.int64)) * m).to(d.dtype)
    adj = torch.where(x >= 0, x + m // 2, x - m // 2)
    return (torch.div(adj, m, rounding_mode="trunc") * m).to(d.dtype)


_TWO63 = 2.0 ** 63


def java_double_to_long(v: torch.Tensor) -> torch.Tensor:
    """Java's ``(long)`` of a double tensor: NaN is 0, values past the
    long range clamp to its ends."""
    v = torch.where(torch.isnan(v), 0.0, v)
    in_range = (v > -_TWO63) & (v < _TWO63)
    out = torch.where(in_range, v, 0.0).to(torch.int64)
    out = torch.where(v >= _TWO63, torch.iinfo(torch.int64).max, out)
    return torch.where(v <= -_TWO63, torch.iinfo(torch.int64).min, out)


class _ToLong(UnaryExpression):
    """``floor``/``ceil``: a double → bigint with Java's (long)
    conversion; integers pass through; a decimal rounds to scale 0 in
    Spark's decimal type (``types.floor_ceil_decimal_type``)."""
    _fn = None
    fn_name = "?"

    @property
    def dtype(self) -> DataType:
        from ..types import DecimalType, floor_ceil_decimal_type
        if isinstance(self.child.dtype, DecimalType):
            return floor_ceil_decimal_type(self.child.dtype)
        return LongT if isinstance(self.child.dtype, FractionalType) \
            else self.child.dtype

    def _compute(self, d, ctx, valid):
        if not d.is_floating_point():
            return d
        return java_double_to_long(type(self)._fn(d.to(torch.float64)))

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        if _is_decimal(self.child):
            return _decimal_round_device(self, batch, ctx, 0, self.fn_name)
        return super().eval_device(batch, ctx)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        if _is_decimal(self.child):
            return _decimal_round_cpu(self, table, ctx, 0, self.fn_name)
        return eval_cpu_on_host_tensors(self, table, ctx)


class Floor(_ToLong):
    _fn = staticmethod(torch.floor)
    fn_name = "floor"


class Ceil(_ToLong):
    _fn = staticmethod(torch.ceil)
    fn_name = "ceil"


# ---------------------------------------------------------------------------
# the double functions
# ---------------------------------------------------------------------------


class _DoubleUnary(UnaryExpression):
    """A unary function of a double that returns a double (null in, null
    out)."""

    @property
    def dtype(self) -> DataType:
        return DoubleT

    def _fn(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _compute(self, d, ctx, valid):
        return self._fn(d.to(torch.float64))

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return eval_cpu_on_host_tensors(self, table, ctx)

    def pretty(self) -> str:
        return f"{type(self).__name__.lower()}({self.child.pretty()})"


def _unary(name: str, fn, doc: str = ""):
    cls = type(name, (_DoubleUnary,), {
        "_fn": lambda self, x: fn(x), "__doc__": doc or f"{name.lower()}(x)",
        "__module__": __name__})
    return cls


def exact_sqrt(x: torch.Tensor) -> torch.Tensor:
    """IEEE's correctly rounded square root (Java's ``Math.sqrt``). The
    card's is; torch's vectorized CPU kernel is off by an ulp on about 1 %
    of doubles, which Spark's asinh and acosh amplify by cancellation, so
    the host takes numpy's (a host tensor: no transfer)."""
    if x.device.type == "cpu":
        import numpy as _np
        return torch.from_numpy(_np.sqrt(x.contiguous().numpy()))
    return torch.sqrt(x)


Sqrt = _unary("Sqrt", exact_sqrt, "sqrt(x): NaN below 0, as Java's")
Cbrt = _unary("Cbrt", lambda x: _cbrt(x), "cbrt(x): the real cube root")
Exp = _unary("Exp", torch.exp)
Expm1 = _unary("Expm1", torch.expm1)
Sin = _unary("Sin", torch.sin)
Cos = _unary("Cos", torch.cos)
Tan = _unary("Tan", torch.tan)
Asin = _unary("Asin", torch.asin)
Acos = _unary("Acos", torch.acos)
Atan = _unary("Atan", torch.atan)
Sinh = _unary("Sinh", torch.sinh)
Cosh = _unary("Cosh", torch.cosh)
Tanh = _unary("Tanh", torch.tanh)
Cot = _unary("Cot", lambda x: 1.0 / torch.tan(x), "cot(x) = 1 / tan(x)")
ToDegrees = _unary("ToDegrees", lambda x: x * 57.29577951308232,
                   "degrees(x): Java's x * (180 / pi)")
ToRadians = _unary("ToRadians", lambda x: x * 0.017453292519943295,
                   "radians(x): Java's x * (pi / 180)")
Rint = _unary("Rint", torch.round,
              "rint(x): the nearest integer, ties to even (Java's rint)")


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """The real cube root (negative for a negative x; NaN and infinities
    pass through), refined by one Newton step from ``|x|^(1/3)``."""
    a = torch.abs(x)
    r = torch.pow(a, 1.0 / 3.0)
    ok = (r > 0) & torch.isfinite(r)
    r = torch.where(ok, r - (r * r * r - a) / (3.0 * r * r), r)
    return torch.copysign(r, x)


def _asinh(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x == float("-inf"), x,
                       torch.log(x + exact_sqrt(x * x + 1.0)))


Asinh = _unary("Asinh", _asinh,
               "asinh(x): Spark's log(x + sqrt(x^2 + 1)), -inf at -inf")
Acosh = _unary("Acosh", lambda x: torch.log(x + exact_sqrt(x * x - 1.0)),
               "acosh(x): Spark's log(x + sqrt(x^2 - 1)), NaN below 1")
Atanh = _unary("Atanh",
               lambda x: 0.5 * (torch.log1p(x) - torch.log1p(-x)),
               "atanh(x): Spark's (log1p(x) - log1p(-x)) / 2")


class Signum(_DoubleUnary):
    """signum(x) as a double: ±1, a zero keeps its sign, NaN stays NaN."""

    def _fn(self, x):
        one = torch.ones((), dtype=x.dtype, device=x.device)
        return torch.where(x > 0, one, torch.where(x < 0, -one, x))

    def pretty(self) -> str:
        return Expression.pretty(self)


class _LogBase(UnaryExpression):
    """Spark's log family: null at or below the asymptote (non-ANSI)."""
    _asymptote = 0.0
    _safe = 1.0

    @property
    def dtype(self) -> DataType:
        return DoubleT

    def _fn(self, x):
        raise NotImplementedError

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        cap, dev = batch.capacity, batch.device
        d, v = device_parts(self.child.eval_device(batch, ctx), cap, dev)
        d = torch.broadcast_to(d, (cap,)).to(torch.float64)
        bad = d <= self._asymptote
        valid = combine_validity(v, ~bad, row_mask(batch.num_rows, cap, dev))
        return make_column(DoubleT, self._fn(torch.where(bad, self._safe, d)),
                           valid, batch.num_rows)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return eval_cpu_on_host_tensors(self, table, ctx)


class Log(_LogBase):
    def _fn(self, x):
        return torch.log(x)


class Log10(_LogBase):
    def _fn(self, x):
        return torch.log10(x)


class Log2(_LogBase):
    def _fn(self, x):
        return torch.log2(x)


class Log1p(_LogBase):
    """log1p(x): null at or below -1."""
    _asymptote = -1.0
    _safe = 0.0

    def _fn(self, x):
        return torch.log1p(x)


class _DoubleBinary(BinaryExpression):
    """A function of two doubles that returns a double."""

    @property
    def dtype(self) -> DataType:
        return DoubleT

    def _fn(self, l, r):
        raise NotImplementedError

    def _compute(self, l, r, ctx, valid):
        return self._fn(l.to(torch.float64), r.to(torch.float64))

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return eval_cpu_on_host_tensors(self, table, ctx)

    def pretty(self) -> str:
        return (f"{type(self).__name__.lower()}({self.left.pretty()}, "
                f"{self.right.pretty()})")


class Pow(_DoubleBinary):
    """pow(x, y) with Java's special cases: NaN for a NaN exponent and for
    (±1) ^ ±inf, where C's pow gives 1."""

    def _fn(self, l, r):
        out = torch.pow(l, r)
        nan = torch.isnan(r) | ((torch.abs(l) == 1.0) & torch.isinf(r))
        return torch.where(nan, float("nan"), out)


class Atan2(_DoubleBinary):
    def _fn(self, l, r):
        return torch.atan2(l, r)

    def pretty(self) -> str:
        return Expression.pretty(self)


class Hypot(_DoubleBinary):
    """hypot(a, b) = sqrt(a² + b²) without intermediate overflow."""

    def _fn(self, l, r):
        return torch.hypot(l, r)


class Logarithm(_DoubleBinary):
    """log(base, x): null when x <= 0 or base <= 0 (Spark's non-ANSI
    null on a domain error)."""

    def _eval_parts(self, l, r, batch, ctx):
        cap, dev = batch.capacity, batch.device
        bd, bv = device_parts(l, cap, dev)
        xd, xv = device_parts(r, cap, dev)
        b = torch.broadcast_to(bd, (cap,)).to(torch.float64)
        x = torch.broadcast_to(xd, (cap,)).to(torch.float64)
        bad = (x <= 0) | (b <= 0)
        valid = combine_validity(bv, xv, ~bad,
                                 row_mask(batch.num_rows, cap, dev))
        data = torch.log(torch.where(bad, 1.0, x)) \
            / torch.log(torch.where(bad, 2.0, b))
        return data, valid

    def pretty(self) -> str:
        return f"log({self.left.pretty()}, {self.right.pretty()})"
