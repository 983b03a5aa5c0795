"""Arithmetic with Spark's semantics (port of
``spark_rapids_tpu/expressions/arithmetic.py``): ``+ - * /``, ``div``
(``IntegralDivide``), ``%`` (``Remainder``, Java's sign: the dividend's),
``pmod``, unary ``-`` and ``+``, ``abs``.

Non-ANSI: integers wrap (two's complement, as Java), and a zero divisor
gives null for every type (Spark's DivModLike, not IEEE). ANSI mode
(``spark.sql.ansi.enabled``) raises ``ExpressionError`` for integral
overflow ("integer overflow in add", ...) and for a zero divisor
("division by zero"), on the card (one host read of "any row bad" a
batch, as the reference's ``_ansi_check``) and on the host with the same
message. Decimal arithmetic under ANSI waits with decimal128 (ROADMAP A6)
and raises.

``Long.MinValue / -1`` traps on x86 and is undefined on CUDA, so a
divisor of -1 is replaced by 1 and the quotient negated with wrap
(``div`` gives MinValue, ``%`` and ``pmod`` give 0, as Java does; ANSI
``div`` raises its overflow).

Host evaluation (``eval_cpu``): ``+ - * / abs`` through pyarrow's
kernels (the checked ones under ANSI), the others through this module's
torch code over CPU tensors (``base.eval_cpu_on_host_tensors``).
"""

from __future__ import annotations

import torch

from ..columnar.vector import audited_sync_int, row_mask
from ..types import DataType, DecimalType, IntegralType, LongT
from .base import (_DEFAULT_CTX, BinaryExpression, EvalContext,
                   ExpressionError, UnaryExpression, combine_validity,
                   device_parts, eval_cpu_on_host_tensors)


def _ansi_check(flag: torch.Tensor, valid, ctx: EvalContext,
                message: str) -> None:
    """Under ANSI, raise ``message`` when any valid row is flagged (one
    host read)."""
    if not ctx.ansi:
        return
    if valid is not None:
        flag = flag & valid
    if audited_sync_int(flag.any(), "scalar"):
        raise ExpressionError(message)


def _no_decimal_ansi(ctx: EvalContext, dtype: DataType) -> None:
    if ctx.ansi and isinstance(dtype, DecimalType):
        raise NotImplementedError(
            "ANSI-mode decimal arithmetic not yet ported (ROADMAP A6, "
            "decimals with decimal128)")


def _arrow_checked(fn_checked, fn, what: str, ctx, dtype, *args):
    """A pyarrow kernel, its checked form under ANSI for integers: an
    overflow raises the device's message."""
    import pyarrow as pa
    _no_decimal_ansi(ctx, dtype)
    if not (ctx.ansi and isinstance(dtype, IntegralType)):
        return fn(*args)
    try:
        return fn_checked(*args)
    except pa.ArrowInvalid as e:
        raise ExpressionError(f"integer overflow in {what}") from e


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
        _no_decimal_ansi(ctx, self.dtype)
        out = l + r
        if ctx.ansi and isinstance(self.dtype, IntegralType):
            _ansi_check(((l ^ out) & (r ^ out)) < 0, valid, ctx,
                        "integer overflow in add")
        return out

    def _cpu_compute(self, l, r, ctx):
        import pyarrow.compute as pc
        return _arrow_checked(pc.add_checked, pc.add, "add", ctx,
                              self.dtype, l, r)


class Subtract(BinaryArithmetic):
    symbol = "-"

    def _compute(self, l, r, ctx, valid):
        _no_decimal_ansi(ctx, self.dtype)
        out = l - r
        if ctx.ansi and isinstance(self.dtype, IntegralType):
            _ansi_check(((l ^ r) & (l ^ out)) < 0, valid, ctx,
                        "integer overflow in subtract")
        return out

    def _cpu_compute(self, l, r, ctx):
        import pyarrow.compute as pc
        return _arrow_checked(pc.subtract_checked, pc.subtract, "subtract",
                              ctx, self.dtype, l, r)


def _mul_overflow(l: torch.Tensor, r: torch.Tensor, out: torch.Tensor
                  ) -> torch.Tensor:
    """Rows whose product wrapped: narrow types against the int64
    product, int64 by dividing back (a divisor of -1 or 0 never divides)."""
    if l.dtype != torch.int64:
        wide = l.to(torch.int64) * r.to(torch.int64)
        return wide != out.to(torch.int64)
    lo = torch.iinfo(torch.int64).min
    r = torch.broadcast_to(r, out.shape)
    l = torch.broadcast_to(l, out.shape)
    safe = torch.where((r == 0) | (r == -1), torch.ones_like(r), r)
    back = torch.div(out, safe, rounding_mode="trunc")
    return torch.where(r == -1, l == lo,
                       torch.where(r == 0, torch.zeros_like(l, dtype=torch.bool),
                                   back != l))


class Multiply(BinaryArithmetic):
    symbol = "*"

    def _compute(self, l, r, ctx, valid):
        _no_decimal_ansi(ctx, self.dtype)
        out = l * r
        if ctx.ansi and isinstance(self.dtype, IntegralType):
            _ansi_check(_mul_overflow(l, r, out), valid, ctx,
                        "integer overflow in multiply")
        return out

    def _cpu_compute(self, l, r, ctx):
        import pyarrow.compute as pc
        return _arrow_checked(pc.multiply_checked, pc.multiply, "multiply",
                              ctx, self.dtype, l, r)


def _div_parts(l, r, batch):
    """(left, right, validity, zero divisor) of a division over the
    batch."""
    cap, dev = batch.capacity, batch.device
    ld, lv = device_parts(l, cap, dev)
    rd, rv = device_parts(r, cap, dev)
    ld = torch.broadcast_to(ld, (cap,))
    rd = torch.broadcast_to(rd, (cap,))
    valid = combine_validity(lv, rv, row_mask(batch.num_rows, cap, dev))
    return ld, rd, valid, rd == 0


def _trunc_div(l: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Java's integer division (toward zero), a divisor of -1 negating
    with wrap; ``r`` holds no zero."""
    safe = torch.where(r == -1, torch.ones_like(r), r)
    q = torch.div(l, safe, rounding_mode="trunc")
    return torch.where(r == -1, -l, q)


def _java_rem(l: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Java's ``%`` (the dividend's sign): ``fmod``; ``r`` holds no zero
    (x % -1 is 0)."""
    if l.is_floating_point():
        return torch.fmod(l, r)
    safe = torch.where(r == -1, torch.ones_like(r), r)
    return torch.fmod(l, safe)


class _DivModLike(BinaryArithmetic):
    """Spark's DivModLike: null (ANSI: an error) for a zero divisor."""

    @property
    def nullable(self) -> bool:
        return True

    def _op(self, l, r, ctx, valid):
        raise NotImplementedError

    def _eval_parts(self, l, r, batch, ctx):
        _no_decimal_ansi(ctx, self.dtype)
        ld, rd, valid, zero = _div_parts(l, r, batch)
        _ansi_check(zero, valid, ctx, "division by zero")
        one = torch.ones((), dtype=rd.dtype, device=rd.device)
        data = self._op(ld, torch.where(zero, one, rd), ctx, valid)
        mask = row_mask(batch.num_rows, batch.capacity, batch.device)
        return data, combine_validity(valid, ~zero & mask)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return eval_cpu_on_host_tensors(self, table, ctx)


class Divide(_DivModLike):
    """Spark `/`: inputs coerced to double; a zero divisor gives null for
    every type."""
    symbol = "/"

    def _op(self, l, r, ctx, valid):
        if r.is_floating_point():
            return l / r
        return _trunc_div(l, r)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return BinaryArithmetic.eval_cpu(self, table, ctx)

    def _cpu_compute(self, l, r, ctx):
        import pyarrow as pa
        import pyarrow.compute as pc
        _no_decimal_ansi(ctx, self.dtype)
        zero = pc.fill_null(pc.equal(r, pa.scalar(0, r.type)), False)
        if ctx.ansi and pc.any(zero).as_py():
            raise ExpressionError("division by zero")
        out = pc.divide(l, pc.if_else(zero, pa.scalar(1, r.type), r))
        return pc.if_else(zero, pa.scalar(None, out.type), out)


class IntegralDivide(_DivModLike):
    """Spark `div`: integral division toward zero, a bigint.
    ``MinValue div -1`` wraps to MinValue (ANSI: overflow)."""
    symbol = "div"

    @property
    def dtype(self) -> DataType:
        return LongT

    def _op(self, l, r, ctx, valid):
        l, r = l.to(torch.int64), r.to(torch.int64)
        _ansi_check((l == torch.iinfo(torch.int64).min) & (r == -1), valid,
                    ctx, "integer overflow in integral divide")
        return _trunc_div(l, r)


class Remainder(_DivModLike):
    """Spark `%`: Java's remainder, of the dividend's sign; a zero divisor
    gives null for floats too (Spark's DivModLike)."""
    symbol = "%"

    def _op(self, l, r, ctx, valid):
        return _java_rem(l, r)


class Pmod(_DivModLike):
    """pmod(a, n): Spark's ``r = a % n; r < 0 ? (r + n) % n : r``, so a
    positive divisor gives a non-negative result."""
    symbol = "pmod"

    def _op(self, l, r, ctx, valid):
        rem = _java_rem(l, r)
        return torch.where(rem < 0, _java_rem(rem + r, r), rem)


_INT_MIN = {torch.int8: -2 ** 7, torch.int16: -2 ** 15,
            torch.int32: -2 ** 31, torch.int64: -2 ** 63}


def _min_check(d: torch.Tensor, valid, ctx: EvalContext, what: str):
    lo = _INT_MIN.get(d.dtype)
    if lo is not None:
        _ansi_check(d == lo, valid, ctx, f"integer overflow in {what}")


class UnaryMinus(UnaryExpression):
    """``-x``: an integer's smallest value wraps to itself (ANSI:
    overflow)."""

    def _compute(self, d, ctx, valid):
        _no_decimal_ansi(ctx, self.dtype)
        _min_check(d, valid, ctx, "negate")
        return -d

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return eval_cpu_on_host_tensors(self, table, ctx)

    def pretty(self) -> str:
        return f"(- {self.child.pretty()})"


class UnaryPositive(UnaryExpression):
    """``+x``: the value itself."""

    def _compute(self, d, ctx, valid):
        return d

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return self.child.eval_cpu(table, ctx)


class Abs(UnaryExpression):
    """``abs(x)``: the smallest integer of its type stays itself (Java's
    two's-complement wrap); ANSI: overflow."""

    def _compute(self, d, ctx, valid):
        _no_decimal_ansi(ctx, self.dtype)
        _min_check(d, valid, ctx, "abs")
        return torch.abs(d)

    def _cpu_compute(self, arr, ctx):
        import pyarrow.compute as pc
        return _arrow_checked(pc.abs_checked, pc.abs, "abs", ctx,
                              self.dtype, arr)
