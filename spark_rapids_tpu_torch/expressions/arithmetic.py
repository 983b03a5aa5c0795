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
message.

Decimals (``expressions/decimals.py``): ``+ - *`` take Spark's result
types (``types.decimal_result_type``) and run on the card, one int64 lane
up to precision 18 and two limbs past it; a result past its precision is
null, or under ANSI an ``ExpressionError`` ("decimal overflow in add", the
same on the host). A product past 10^38 before its rescale is computed on
the host with exact integers (Spark rounds it to 38 digits first), so no
row is null where Spark has a value. ``/``, ``%`` and ``pmod`` of decimals
run on the card too (``decimals.divmod_decimals``: a 128-bit long
division, Spark's two HALF_UP roundings of ``/`` in one test on the
remainder); the rows whose scaled operands pass 2^127 are computed on the
host by the host engine's exact rules, which every other row equals.

``Long.MinValue / -1`` traps on x86 and is undefined on CUDA, so a
divisor of -1 is replaced by 1 and the quotient negated with wrap
(``div`` gives MinValue, ``%`` and ``pmod`` give 0, as Java does; ANSI
``div`` raises its overflow).

Host evaluation (``eval_cpu``): ``+ - * / abs`` through pyarrow's
kernels (the checked ones under ANSI), the others and every decimal
``+ - *`` through this module's torch code over CPU tensors
(``base.eval_cpu_on_host_tensors``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..columnar.vector import audited_sync_int, row_mask
from ..kernels import decimal128 as D
from ..types import (DataType, DecimalType, IntegralType, LongT,
                     decimal_result_type)
from . import decimals as DEC
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


def _arrow_checked(fn_checked, fn, what: str, ctx, dtype, *args):
    """A pyarrow kernel, its checked form under ANSI for integers: an
    overflow raises the device's message."""
    import pyarrow as pa
    if not (ctx.ansi and isinstance(dtype, IntegralType)):
        return fn(*args)
    try:
        return fn_checked(*args)
    except pa.ArrowInvalid as e:
        raise ExpressionError(f"integer overflow in {what}") from e


class BinaryArithmetic(BinaryExpression):
    symbol = "?"
    #: the operator's name in ANSI's overflow message
    what = "?"

    @property
    def is_decimal(self) -> bool:
        return isinstance(self.left.dtype, DecimalType) \
            and isinstance(self.right.dtype, DecimalType)

    @property
    def dtype(self) -> DataType:
        if self.is_decimal:
            return decimal_result_type(self.symbol, self.left.dtype,
                                       self.right.dtype)
        return self.left.dtype

    def pretty(self) -> str:
        return f"({self.children[0].pretty()} {self.symbol} {self.children[1].pretty()})"

    def _eval_parts(self, l, r, batch, ctx):
        if not self.is_decimal:
            return super()._eval_parts(l, r, batch, ctx)
        cap, dev = batch.capacity, batch.device
        lt, rt = self.left.dtype, self.right.dtype
        ld, lv = device_parts(l, cap, dev)
        rd, rv = device_parts(r, cap, dev)
        valid = combine_validity(lv, rv, row_mask(batch.num_rows, cap, dev))
        data, ovf = self._decimal(DEC.broadcast_rows(ld, cap, lt),
                                  DEC.broadcast_rows(rd, cap, rt), ctx, valid)
        return data, DEC.overflow_check(ovf, valid, ctx.ansi,
                                        f"decimal overflow in {self.what}")

    def _decimal(self, l, r, ctx, valid):
        """(result carrier, overflow) of two decimal carriers."""
        raise NotImplementedError(
            DEC.A6_REASON.format(what=type(self).__name__))

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        if self.is_decimal:
            return eval_cpu_on_host_tensors(self, table, ctx)
        return super().eval_cpu(table, ctx)


def _decimal_add_sub(l, r, lt: DecimalType, rt: DecimalType,
                     out: DecimalType, subtract: bool):
    """Spark 3.x's decimal ``+``/``-``: each side cast to the result type
    (HALF_UP where precision loss coarsens the scale), then the exact sum
    checked against the result's precision."""
    a, oa = DEC.change_scale(l, lt, out)
    b, ob = DEC.change_scale(r, rt, out)
    if not out.wide:  # |a|, |b| < 10^(p-1): the sum fits
        return (a - b if subtract else a + b), oa | ob
    ah, al = D.limbs_of(a)
    bh, bl = D.limbs_of(b)
    h, lo, ovf = (D.sub128 if subtract else D.add128)(ah, al, bh, bl)
    ovf = ovf | oa | ob | D.precision_overflow(h, lo, out.precision)
    return D.join(h, lo), ovf


class Add(BinaryArithmetic):
    symbol = "+"
    what = "add"

    def _decimal(self, l, r, ctx, valid):
        return _decimal_add_sub(l, r, self.left.dtype, self.right.dtype,
                                self.dtype, False)

    def _compute(self, l, r, ctx, valid):
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
    what = "subtract"

    def _decimal(self, l, r, ctx, valid):
        return _decimal_add_sub(l, r, self.left.dtype, self.right.dtype,
                                self.dtype, True)

    def _compute(self, l, r, ctx, valid):
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
    what = "multiply"

    def _decimal(self, l, r, ctx, valid):
        """The exact product at scale s1 + s2, rounded HALF_UP to the
        result's scale. Rows whose product reaches 10^38 (two limbs
        overflow, or Spark's 38-digit MathContext would round it) are
        computed on the host with Python integers."""
        lt, rt, out = self.left.dtype, self.right.dtype, self.dtype
        if not out.wide:  # p1 + p2 + 1 <= 18: exact in int64, no rescale
            return l * r, torch.zeros(l.shape[0], dtype=torch.bool,
                                      device=l.device)
        ah, al = D.limbs_of(l)
        bh, bl = D.limbs_of(r)
        h, lo, big = D.mul128(ah, al, bh, bl)
        big = big | D.precision_overflow(h, lo, 38)
        k = lt.scale + rt.scale - out.scale
        if k > 0:
            h, lo = D.rescale_down(h, lo, k)
        ovf = D.precision_overflow(h, lo, out.precision) & ~big
        data = D.join(h, lo)
        idx = DEC.host_rows(big if valid is None else big & valid)
        if idx is not None:
            DEC.host_path(ctx, self, "product past 10^38")
            vals = [DEC.spark_multiply(a, b, lt.scale, rt.scale, out)
                    for a, b in zip(DEC.carrier_ints(l, idx),
                                    DEC.carrier_ints(r, idx))]
            DEC.put_ints(data, idx, [0 if v is None else v for v in vals])
            ovf[idx] = torch.tensor([v is None for v in vals],
                                    device=ovf.device)
        return data, ovf

    def _compute(self, l, r, ctx, valid):
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

    #: the exact host rule of a decimal operand pair
    _decimal_rule = None

    def _op(self, l, r, ctx, valid):
        raise NotImplementedError

    def _eval_parts(self, l, r, batch, ctx):
        if self.is_decimal:
            return self._decimal_device(l, r, batch, ctx)
        ld, rd, valid, zero = _div_parts(l, r, batch)
        _ansi_check(zero, valid, ctx, "division by zero")
        one = torch.ones((), dtype=rd.dtype, device=rd.device)
        data = self._op(ld, torch.where(zero, one, rd), ctx, valid)
        mask = row_mask(batch.num_rows, batch.capacity, batch.device)
        return data, combine_validity(valid, ~zero & mask)

    def _decimal_device(self, l, r, batch, ctx):
        """Two decimals on the card (``decimals.divmod_decimals``); the
        rows whose scaled operands pass 2^127 through the host rule."""
        cap, dev = batch.capacity, batch.device
        lt, rt, out = self.left.dtype, self.right.dtype, self.dtype
        ld, lv = device_parts(l, cap, dev)
        rd, rv = device_parts(r, cap, dev)
        valid = combine_validity(lv, rv, row_mask(batch.num_rows, cap, dev))
        a = DEC.broadcast_rows(ld, cap, lt)
        b = DEC.broadcast_rows(rd, cap, rt)
        zero = (b == 0).all(-1) if b.dim() == 2 else b == 0
        _ansi_check(zero, valid, ctx, "division by zero")
        data, ovf, big = DEC.divmod_decimals(self.symbol, a, b, lt, rt, out)
        idx = DEC.host_rows(big & ~zero if valid is None
                            else big & ~zero & valid)
        if idx is not None:
            DEC.host_path(ctx, self, "operand past 2^127")
            xa = np.empty(len(idx), dtype=object)
            xa[:] = DEC.carrier_ints(a, idx)
            xb = np.empty(len(idx), dtype=object)
            xb[:] = DEC.carrier_ints(b, idx)
            vals, ok = type(self)._decimal_rule(xa, xb, lt.scale, rt.scale,
                                                out)
            DEC.put_ints(data, idx, [int(v) if k else 0
                                     for v, k in zip(vals, ok)])
            ovf[idx] = torch.from_numpy(~ok).to(ovf.device)
        valid = combine_validity(valid, ~zero)
        return data, DEC.overflow_check(ovf, valid, ctx.ansi,
                                        f"decimal overflow in {self.what}")

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        if self.is_decimal:
            return self._decimal_cpu(table, ctx)
        return eval_cpu_on_host_tensors(self, table, ctx)

    def _decimal_cpu(self, table, ctx):
        """The exact host rule over the operands' unscaled integers (a
        zero divisor: null, under ANSI "division by zero"; past the
        result's precision: null, under ANSI an overflow)."""
        from .base import arrow_column, is_arrow
        lt, rt, out = self.left.dtype, self.right.dtype, self.dtype
        l = self.left.eval_cpu(table, ctx)
        r = self.right.eval_cpu(table, ctx)
        scalar = not is_arrow(l) and not is_arrow(r)
        n = 1 if scalar else len(l if is_arrow(l) else r)
        rule = type(self)._decimal_rule
        if rule is None:
            raise NotImplementedError(
                DEC.A6_REASON.format(what=type(self).__name__))
        a, av = DEC.arrow_object(arrow_column(l, n, lt))
        b, bv = DEC.arrow_object(arrow_column(r, n, rt))
        valid = av & bv
        vals, ok = rule(a, b, lt.scale, rt.scale, out)
        if ctx.ansi:
            if (valid & (b == 0).astype(bool)).any():
                raise ExpressionError("division by zero")
            if (valid & (b != 0).astype(bool) & ~ok).any():
                raise ExpressionError(f"decimal overflow in {self.what}")
        arr = DEC.ints_to_arrow(vals, out, ok & valid)
        return arr[0].as_py() if scalar else arr


class Divide(_DivModLike):
    """Spark `/`: inputs coerced to double, or two decimals (Spark's
    decimal quotient); a zero divisor gives null for every type."""
    symbol = "/"
    what = "divide"
    _decimal_rule = staticmethod(DEC.divide_arr)

    def _op(self, l, r, ctx, valid):
        if r.is_floating_point():
            return l / r
        return _trunc_div(l, r)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        if self.is_decimal:
            return self._decimal_cpu(table, ctx)
        return BinaryExpression.eval_cpu(self, table, ctx)

    def _cpu_compute(self, l, r, ctx):
        import pyarrow as pa
        import pyarrow.compute as pc
        zero = pc.fill_null(pc.equal(r, pa.scalar(0, r.type)), False)
        if ctx.ansi and pc.any(zero).as_py():
            raise ExpressionError("division by zero")
        out = pc.divide(l, pc.if_else(zero, pa.scalar(1, r.type), r))
        return pc.if_else(zero, pa.scalar(None, out.type), out)


class IntegralDivide(_DivModLike):
    """Spark `div`: integral division toward zero, a bigint.
    ``MinValue div -1`` wraps to MinValue (ANSI: overflow). Over
    decimals it waits (ROADMAP A6)."""
    symbol = "div"
    what = "integral divide"

    @property
    def dtype(self) -> DataType:
        return LongT

    @property
    def tpu_supported(self) -> bool:
        return not self.is_decimal

    @property
    def tpu_unsupported_reason(self) -> str:
        return DEC.A6_REASON.format(what=type(self).__name__)

    def _op(self, l, r, ctx, valid):
        l, r = l.to(torch.int64), r.to(torch.int64)
        _ansi_check((l == torch.iinfo(torch.int64).min) & (r == -1), valid,
                    ctx, "integer overflow in integral divide")
        return _trunc_div(l, r)


class Remainder(_DivModLike):
    """Spark `%`: Java's remainder, of the dividend's sign; a zero divisor
    gives null for floats too (Spark's DivModLike)."""
    symbol = "%"
    what = "remainder"
    _decimal_rule = staticmethod(DEC.remainder_arr)

    def _op(self, l, r, ctx, valid):
        return _java_rem(l, r)


class Pmod(_DivModLike):
    """pmod(a, n): Spark's ``r = a % n; r < 0 ? (r + n) % n : r``, so a
    positive divisor gives a non-negative result."""
    symbol = "pmod"
    what = "pmod"
    _decimal_rule = staticmethod(DEC.pmod_arr)

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
        if d.dim() == 2:  # |x| < 10^38: no overflow
            return D.join(*D.neg128(d[:, 0], d[:, 1]))
        if isinstance(self.dtype, DecimalType):
            return -d
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
        if d.dim() == 2:
            nh, nl = D.neg128(d[:, 0], d[:, 1])
            neg = d[:, 0] < 0
            return D.join(torch.where(neg, nh, d[:, 0]),
                          torch.where(neg, nl, d[:, 1]))
        if isinstance(self.dtype, DecimalType):
            return torch.abs(d)
        _min_check(d, valid, ctx, "abs")
        return torch.abs(d)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        if isinstance(self.dtype, DecimalType):
            return eval_cpu_on_host_tensors(self, table, ctx)
        return super().eval_cpu(table, ctx)

    def _cpu_compute(self, arr, ctx):
        import pyarrow.compute as pc
        return _arrow_checked(pc.abs_checked, pc.abs, "abs", ctx,
                              self.dtype, arr)
