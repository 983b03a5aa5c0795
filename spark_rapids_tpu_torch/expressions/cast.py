"""Cast with Spark's non-ANSI semantics (port of
``spark_rapids_tpu/expressions/cast.py``).

Between numeric, boolean and date types on the device: integer narrowing
wraps like Java, float → integer truncates toward zero with NaN → 0 and
out-of-range values clamped, date → integer gives the day number,
integer/float → double widens.

To and from strings through the host, as the reference
(``_cast_via_host``), each batch counted in ``strings.hostPath``:

* numeric, boolean, date and timestamp → string in Spark's text: Java's
  ``Double.toString``/``Float.toString`` for floats (``_spark_float_str``),
  ``true``/``false``, ISO dates, timestamps with their fraction trimmed;
* string → integral, fractional, boolean, date and timestamp, null where
  Spark's non-ANSI cast is null.

Timestamps read and write their text in the session zone
(``spark.sql.session.timeZone``, ``tzdb.py``'s tables with java.time's gap
and overlap rules); a text with its own zone or offset keeps it.

The host work is vectorized through pyarrow and numpy where Spark's rules
and Arrow's agree (plain digits, plain decimals, ISO dates, floats in
[1e-3, 1e7)), and a row at a time elsewhere. Where the reference departs
from Spark (an integral parse of "1.5", "1_000" or a value past the type's
range as a literal) the port gives Spark's answer (ROADMAP C-ref-15).
A literal casts by the same rules as a column.

Decimals (``_decimal_cast``), on the card: integral ↔ decimal, decimal ↔
decimal (a finer scale multiplies with an overflow check, a coarser one
rounds HALF_UP), decimal → boolean, decimal → double where the float64
quotient ``unscaled / 10^s`` is correctly rounded (|unscaled| < 2^53,
s <= 22), double → decimal (Spark's ``BigDecimal(Double.toString)``
HALF_UP) for the rows clear of a tie. The other rows of the float casts,
and string ↔ decimal, go through the host (``decimal.hostPath``). A
value past the target's precision is null; under ANSI it raises
``ExpressionError``, the same on the host. ANSI mode waits for the other
casts.

Host evaluation (``eval_cpu``, the host engine) runs the same rules over
the Arrow rows: the string casts' host code as it is, and the numeric
casts' Java conversions (``_numeric_cast``) over CPU tensors read from
the Arrow buffers, so a cast gives the same answer on either side.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np
import torch

from ..columnar.vector import (TorchScalar, audited_sync_int,
                               audited_tolist, lane_mask, row_mask)
from ..types import (BooleanType, DataType, DateType, DecimalType,
                     DoubleType, FloatType, FractionalType, IntegralType,
                     NullType, NumericType, StringType, TimestampType)
from ..tzdb import zone_table
from .base import (_DEFAULT_CTX, Expression, UnaryExpression, arrow_column,
                   arrow_numpy, combine_validity, device_parts, is_arrow,
                   make_column)

_INT_BOUNDS = {np.dtype(np.int8): (-128, 127),
               np.dtype(np.int16): (-32768, 32767),
               np.dtype(np.int32): (-2**31, 2**31 - 1),
               np.dtype(np.int64): (-2**63, 2**63 - 1)}


def _castable(src: DataType, dst: DataType) -> bool:
    ok = (NumericType, BooleanType, DateType, NullType)
    return isinstance(src, ok) and isinstance(dst, ok) \
        and not isinstance(dst, NullType)


def string_castable(src: DataType, dst: DataType) -> bool:
    """A cast to or from a string the port carries."""
    if isinstance(dst, StringType):
        return isinstance(src, (NumericType, BooleanType, DateType,
                                TimestampType, StringType, NullType))
    return isinstance(src, StringType) and isinstance(
        dst, (NumericType, BooleanType, DateType, TimestampType))


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

    def _ansi_on(self, ctx) -> bool:
        return self._ansi if self._ansi is not None else ctx.ansi

    @property
    def is_decimal(self) -> bool:
        src, dst = self.child.dtype, self._to
        return src != dst and (isinstance(src, DecimalType)
                               or isinstance(dst, DecimalType))

    def _check(self, ctx) -> bool:
        """Whether the cast is a string cast; raises where the port has no
        such cast."""
        src, dst = self.child.dtype, self._to
        if self._ansi_on(ctx) and not self.is_decimal:
            raise NotImplementedError(
                "ANSI-mode cast not yet ported (ROADMAP A6, decimals with "
                "decimal128 and the ANSI casts)")
        strings = isinstance(src, StringType) or isinstance(dst, StringType)
        if src != dst and not (string_castable(src, dst) if strings
                               else _castable(src, dst)):
            raise NotImplementedError(f"cast {src} -> {dst} not yet ported")
        return strings

    def _cast_constant(self, v, strings: bool, ctx):
        src, dst = self.child.dtype, self._to
        if strings and src != dst:
            return _cast_scalar_string(v, src, dst, ctx.tz)
        return _cast_scalar(v, dst)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        import pyarrow as pa
        from ..types import to_arrow
        src, dst = self.child.dtype, self._to
        if self.is_decimal:
            return self._decimal_cpu(table, ctx)
        strings = self._check(ctx)
        c = self.child.eval_cpu(table, ctx)
        if not is_arrow(c):
            return self._cast_constant(c, strings, ctx)
        arr = arrow_column(c, len(c), src)
        if src == dst:
            return arr
        if strings:
            return format_to_string(arr, src, ctx.tz) \
                if isinstance(dst, StringType) \
                else parse_string(arr, dst, ctx.tz)
        vals, null = arrow_numpy(arr, len(arr), src)
        out = _numeric_cast(torch.from_numpy(np.array(vals)), src, dst)
        # a host tensor (eval_cpu): no device transfer
        return pa.array(out.numpy(), type=to_arrow(dst),
                        mask=null if null.any() else None)

    def _decimal_cpu(self, table, ctx):
        """A decimal cast on the host: a string side through the text
        rules, the others through the card's code over CPU tensors."""
        from .base import eval_cpu_on_host_tensors
        src, dst = self.child.dtype, self._to
        if not isinstance(src, StringType) \
                and not isinstance(dst, StringType):
            return eval_cpu_on_host_tensors(self, table, ctx)
        c = self.child.eval_cpu(table, ctx)
        if not is_arrow(c):
            return self._decimal_constant(c, ctx)
        return _decimal_string_cast(arrow_column(c, len(c), src), src, dst,
                                    self._ansi_on(ctx))

    def _decimal_constant(self, v, ctx):
        """A literal's decimal cast, by the column rules on one host
        row."""
        import pyarrow as pa
        from ..types import to_arrow
        if v is None:
            return None
        src = self.child.dtype
        arr = pa.array([v], type=to_arrow(src))
        if isinstance(src, StringType) or isinstance(self._to, StringType):
            return _decimal_string_cast(arr, src, self._to,
                                        self._ansi_on(ctx))[0].as_py()
        from .base import host_column
        from ..columnar.batch import TorchColumnarBatch
        from ..columnar.vector import column_to_arrow
        col = host_column(arr, src)
        batch = TorchColumnarBatch([col], 1)
        data, valid = _decimal_cast(col.data, col.validity, src, self._to,
                                    self._ansi_on(ctx), ctx, self, batch)
        out = make_column(self._to, data, valid, 1)
        return column_to_arrow(out, kind=None)[0].as_py()

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        src, dst = self.child.dtype, self._to
        if self.is_decimal:
            c = self.child.eval_device(batch, ctx)
            if isinstance(c, TorchScalar):
                return TorchScalar(dst, self._decimal_constant(c.value, ctx))
            if isinstance(src, StringType) or isinstance(dst, StringType):
                from .strings import column_from_arrow, column_to_arrow
                from .decimals import host_path
                host_path(ctx, self, "string cast")
                out = _decimal_string_cast(column_to_arrow(c), src, dst,
                                           self._ansi_on(ctx))
                return column_from_arrow(out, dst, batch)
            cap, dev = batch.capacity, batch.device
            d, v = device_parts(c, cap, dev)
            valid = combine_validity(v, row_mask(batch.num_rows, cap, dev))
            data, valid = _decimal_cast(d, valid, src, dst,
                                        self._ansi_on(ctx), ctx, self, batch)
            return make_column(dst, data, valid, batch.num_rows)
        strings = self._check(ctx)
        c = self.child.eval_device(batch, ctx)
        if isinstance(c, TorchScalar):
            return TorchScalar(dst, self._cast_constant(c.value, strings,
                                                        ctx))
        if src == dst:
            return c
        if strings:
            from .strings import column_from_arrow, column_to_arrow, host_path
            host_path(ctx, self, "string cast")
            arr = column_to_arrow(c)
            out = format_to_string(arr, src, ctx.tz) \
                if isinstance(dst, StringType) \
                else parse_string(arr, dst, ctx.tz)
            return column_from_arrow(out, dst, batch)
        cap, dev = batch.capacity, batch.device
        d, v = device_parts(c, cap, dev)
        valid = combine_validity(v, row_mask(batch.num_rows, cap, dev))
        return make_column(dst, _numeric_cast(d, src, dst), valid,
                           batch.num_rows)


# ---------------------------------------------------------------------------
# decimal casts (Spark's Cast over DecimalType)
# ---------------------------------------------------------------------------

_TWO53 = 2 ** 53


def _decimal_cast(d: torch.Tensor, valid, src: DataType, dst: DataType,
                  ansi: bool, ctx, expr, batch):
    """(data, validity) of a cast with a decimal side, on ``d``'s device.
    Past the target's range: null, under ANSI ``ExpressionError``."""
    from . import decimals as DEC
    from ..kernels import decimal128 as D
    cap = batch.capacity
    message = f"decimal overflow in cast to {dst.simple_string()}"

    def checked(data, ovf):
        return data, DEC.overflow_check(ovf, valid, ansi, message)

    d = DEC.broadcast_rows(d, cap, src)
    if valid is not None:  # null slots stay clear of the host routes
        d = torch.where(lane_mask(valid, d), d, torch.zeros((), dtype=d.dtype,
                                                          device=d.device))
    if isinstance(dst, DecimalType):
        if isinstance(src, (DecimalType, IntegralType, BooleanType)):
            s = DEC.as_decimal_type(src) if not isinstance(src, BooleanType) \
                else DecimalType(1, 0)
            return checked(*DEC.change_scale(d.to(torch.int64), s, dst))
        if isinstance(src, (FloatType, DoubleType)):
            return _float_to_decimal(d.to(torch.float64), valid, dst, ansi,
                                     ctx, expr, message)
        raise NotImplementedError(f"cast {src} -> {dst} not yet ported")
    # from a decimal
    if isinstance(dst, BooleanType):
        if d.dim() == 2:
            return (d[:, 0] != 0) | (d[:, 1] != 0), valid
        return d != 0, valid
    if isinstance(dst, IntegralType):
        # Spark's Decimal.toLong (truncated toward zero, the low 64 bits)
        # then Java's narrowing; ANSI: past the type's range raises
        h, l = D.limbs_of(d)
        if src.scale:
            h, l = D.rescale_trunc(h, l, src.scale)
        out = l.to(dst.torch_dtype)
        if not ansi:
            return out, valid
        lo, hi = _INT_BOUNDS[np.dtype(dst.np_dtype)]
        return checked(out, (D.cmp128(h, l, *D.const(lo, d.device)) < 0)
                       | (D.cmp128(h, l, *D.const(hi, d.device)) > 0))
    if isinstance(dst, (FloatType, DoubleType)):
        out = _decimal_to_double(d, src, ctx, expr)
        return out.to(dst.torch_dtype), valid
    raise NotImplementedError(f"cast {src} -> {dst} not yet ported")


def _decimal_to_double(d: torch.Tensor, src: DecimalType, ctx, expr
                       ) -> torch.Tensor:
    """``unscaled / 10^s`` in float64, correctly rounded where both are
    exact doubles (|unscaled| < 2^53, s <= 22); the other rows through
    Python's correctly rounded ``float(Decimal)`` on the host."""
    from . import decimals as DEC
    from ..kernels import decimal128 as D
    h, l = D.limbs_of(d)
    small = (h == (l >> 63)) & (l.abs() < _TWO53) & (l != -2 ** 63)
    p10 = torch.full((), 10.0 ** src.scale, dtype=torch.float64,
                     device=d.device)
    out = l.to(torch.float64) / p10
    if src.scale > 22:
        slow = torch.ones_like(small)
    else:
        slow = ~small
    idx = DEC.host_rows(slow)
    if idx is not None:
        DEC.host_path(ctx, expr, "decimal to double")
        vals = [float(D.scaled_decimal(v, src.scale))
                for v in DEC.carrier_ints(d, idx)]
        out[idx] = torch.tensor(vals, dtype=torch.float64).to(out.device)
    return out


def _float_to_decimal(x: torch.Tensor, valid, dst: DecimalType, ansi: bool,
                      ctx, expr, message: str):
    """Spark's ``changePrecision(Decimal(BigDecimal(Double.toString(x))))``
    HALF_UP: x·10^s rounded on the card where it is clear of a tie and
    under 2^52, the other rows through the value's shortest text on the
    host. NaN and infinities are null (ANSI: an error)."""
    from . import decimals as DEC
    from ..kernels import decimal128 as D
    from .base import ExpressionError
    p10 = torch.full((), 10.0 ** dst.scale, dtype=torch.float64,
                     device=x.device)
    finite = torch.isfinite(x)
    y = torch.where(finite, x * p10, torch.zeros((), dtype=torch.float64,
                                                 device=x.device))
    ay = torch.abs(y)
    near = (torch.abs(ay - torch.floor(ay) - 0.5) <= ay * 2.0 ** -44
            + 2.0 ** -60) | ~(ay < 2.0 ** 52)
    k = torch.trunc(y + torch.where(y >= 0, 0.5, -0.5)).to(torch.int64)
    ok_valid = finite if valid is None else valid & finite
    if ansi and audited_sync_int((~finite if valid is None
                                  else valid & ~finite).any(), "scalar"):
        raise ExpressionError(message)
    kh, kl = D.from_int64(k)
    ovf = D.precision_overflow(kh, kl, dst.precision)
    data = DEC.to_carrier(kh, kl, dst) if dst.wide else k
    slow = near & ok_valid
    idx = DEC.host_rows(slow)
    if idx is not None:
        DEC.host_path(ctx, expr, "double to decimal")
        vals = [_double_text_unscaled(v, dst)
                for v in audited_tolist(x[idx], "fetch")]
        DEC.put_ints(data, idx, [0 if v is None else v for v in vals])
        ovf[idx] = torch.tensor([v is None for v in vals], device=ovf.device)
    return data, DEC.overflow_check(ovf, ok_valid, ansi, message)


def _half_up_unscaled(d, dst: DecimalType):
    """A finite ``decimal.Decimal`` HALF_UP at ``dst``'s scale as its
    unscaled int, None past its precision."""
    import decimal
    if d.adjusted() >= dst.precision - dst.scale:
        return None  # integral digits past the type's
    ctx = decimal.Context(prec=100, rounding=decimal.ROUND_HALF_UP)
    q = d.quantize(decimal.Decimal(1).scaleb(-dst.scale), context=ctx)
    u = int(q.scaleb(dst.scale, context=ctx))
    return u if abs(u) < 10 ** dst.precision else None


def _double_text_unscaled(v: float, dst: DecimalType):
    """A double's shortest text (Java's ``Double.toString`` digits) HALF_UP
    at ``dst``'s scale."""
    import decimal
    return _half_up_unscaled(decimal.Decimal(repr(float(v))), dst)


def _parse_spark_decimal(s: str, dst: DecimalType):
    """Spark's string → decimal (the reference's ``_parse_spark_decimal``,
    ``GpuCast`` castStringToDecimal): the trimmed text parsed, HALF_UP to
    the scale; the unscaled value, or None for garbage or past the
    precision."""
    import decimal
    try:
        d = decimal.Decimal(s.strip())
    except decimal.InvalidOperation:
        return None
    return _half_up_unscaled(d, dst) if d.is_finite() else None


def _decimal_string_cast(arr, src: DataType, dst: DataType, ansi: bool):
    """string → decimal by ``_parse_spark_decimal`` (null for garbage or
    overflow; ANSI raises), decimal → string as Java's
    ``BigDecimal.toPlainString`` (the scale's digits kept)."""
    import pyarrow as pa
    from . import decimals as DEC
    from .base import ExpressionError
    if isinstance(dst, StringType):
        vals = DEC.arrow_ints(arr, src)
        from ..kernels.decimal128 import scaled_decimal
        return pa.array([None if v is None else
                         format(scaled_decimal(v, src.scale), "f")
                         for v in vals], pa.string())
    texts = arr.cast(pa.string()).to_pylist() \
        if not pa.types.is_string(arr.type) else arr.to_pylist()
    out = []
    for t in texts:
        v = None if t is None else _parse_spark_decimal(t, dst)
        if v is None and t is not None and ansi:
            raise ExpressionError(
                f"invalid input or overflow in cast to "
                f"{dst.simple_string()}: {t!r}")
        out.append(v)
    return DEC.ints_to_arrow(out, dst)


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
    raise NotImplementedError(f"scalar cast to {dst} not yet ported")


# ---------------------------------------------------------------------------
# casts to and from strings (reference cast.py:189-450), on the host
# ---------------------------------------------------------------------------

_ASCII = re.ASCII


def _cast_scalar_string(v, src: DataType, dst: DataType,
                        tz: Optional[str] = None):
    """A literal's string cast, by the column rules (a date literal is its
    day number, a timestamp its microseconds), in the session zone
    ``tz``."""
    if v is None:
        return None
    import pyarrow as pa
    from ..types import to_arrow
    if isinstance(dst, StringType):
        if isinstance(src, DateType):
            arr = pa.array([v], pa.int32()).cast(pa.date32())
        elif isinstance(src, TimestampType):
            arr = pa.array([v], pa.int64()).cast(pa.timestamp("us"))
        else:
            arr = pa.array([v], type=to_arrow(src))
        return format_to_string(arr, src, tz)[0].as_py()
    out = parse_string(pa.array([v], pa.string()), dst, tz)
    if isinstance(dst, DateType):
        out = out.cast(pa.int32())
    elif isinstance(dst, TimestampType):
        out = out.cast(pa.int64())
    return out[0].as_py()


def format_to_string(arr, src: DataType, tz: Optional[str] = None):
    """Spark's text of each value (reference ``_format_to_string_arrow``):
    Java's shortest round-trip float text, ``true``/``false``, ISO dates,
    timestamps in the session zone ``tz`` with a trimmed fraction."""
    import pyarrow as pa
    import pyarrow.compute as pc
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if isinstance(src, NullType):
        return pa.nulls(len(arr), pa.string())
    if isinstance(src, StringType):
        return arr
    if isinstance(src, BooleanType):
        return pc.if_else(arr, "true", "false")
    if isinstance(src, (IntegralType, DateType)):
        return pc.cast(arr, pa.string())
    if isinstance(src, (FloatType, DoubleType)):
        return _float_strings(arr, isinstance(src, FloatType))
    if isinstance(src, TimestampType):
        return _timestamp_strings(arr, zone_table(tz))
    raise NotImplementedError(f"cast {src} -> string not yet ported")


def _timestamp_strings(arr, db=None):
    """``yyyy-MM-dd HH:mm:ss[.f]`` of each timestamp as a wall time in the
    zone ``db`` (None: UTC), the fraction's trailing zeros trimmed, with
    numpy over the microseconds: no Python ``datetime`` a row."""
    import pyarrow as pa
    us = np.asarray(arr.cast(pa.int64()).fill_null(0).to_numpy(
        zero_copy_only=False), np.int64)
    if db is not None:
        us = db.utc_to_local_np(us)
    secs = np.floor_divide(us, 1_000_000)
    frac = us - secs * 1_000_000
    text = np.char.replace(np.datetime_as_string(
        secs.astype("datetime64[s]"), unit="s"), "T", " ")
    digits = np.char.rstrip(np.char.zfill(frac.astype(str), 6), "0")
    text = np.where(frac != 0, np.char.add(np.char.add(text, "."), digits),
                    text)
    mask = np.asarray(arr.is_null()) if arr.null_count else None
    return pa.array(text.tolist(), pa.string(), mask=mask)  # numpy: no sync


def _float_strings(arr, is_float32: bool):
    """Java's ``Double.toString``/``Float.toString`` of each value, an Arrow
    string array. Values in [1e-3, 1e7) print their shortest round-trip
    digits positionally, which is Arrow's text of them with ".0" where it
    has no point; the others go through ``_spark_float_str`` a value at a
    time."""
    import pyarrow as pa
    import pyarrow.compute as pc
    mag = pc.abs(arr)
    plain = pc.fill_null(pc.and_(pc.greater_equal(mag, 1e-3),
                                 pc.less(mag, 1e7)), True)
    text = pc.cast(arr, pa.string())
    text = pc.if_else(pc.match_substring(text, "."), text,
                      pc.binary_join_element_wise(text, ".0", ""))
    other = np.nonzero(~np.asarray(plain.to_numpy(zero_copy_only=False),
                                   dtype=bool))[0]
    if not other.size:
        return text
    vals = pc.take(arr, pa.array(other)).to_pylist()
    return pc.replace_with_mask(text, pc.invert(plain), pa.array(
        [_spark_float_str(v, is_float32) for v in vals], pa.string()))


def _spark_float_str(v: float, is_float32: bool) -> str:
    """Java ``Double.toString`` / ``Float.toString``: shortest round-trip
    digits; plain decimal form when 1e-3 <= |v| < 1e7, otherwise
    ``d.dddEexp`` with one digit before the point (the reference's
    ``_spark_float_str``)."""
    if np.isnan(v):
        return "NaN"
    if np.isinf(v):
        return "Infinity" if v > 0 else "-Infinity"
    f = float(np.float32(v)) if is_float32 else float(v)
    if f == 0.0:
        return "-0.0" if np.signbit(f) else "0.0"
    s = str(np.float32(v)) if is_float32 else repr(f)
    neg = s.startswith("-")
    if neg:
        s = s[1:]
    if "e" in s or "E" in s:
        mant, _, exp = s.replace("E", "e").partition("e")
        exp10 = int(exp)
    else:
        mant, exp10 = s, 0
    if "." in mant:
        int_part, frac = mant.split(".")
    else:
        int_part, frac = mant, ""
    digits = (int_part + frac).lstrip("0")
    lead_exp = exp10 + len(int_part.lstrip("0")) - 1 if int_part.strip("0") \
        else exp10 - (len(frac) - len(frac.lstrip("0"))) - 1
    digits = digits.rstrip("0") or "0"
    sign = "-" if neg else ""
    if -3 <= lead_exp < 7:
        if lead_exp >= 0:
            ip = digits[:lead_exp + 1].ljust(lead_exp + 1, "0")
            fp = digits[lead_exp + 1:] or "0"
        else:
            ip = "0"
            fp = "0" * (-lead_exp - 1) + digits
        return f"{sign}{ip}.{fp}"
    fp = digits[1:] or "0"
    return f"{sign}{digits[0]}.{fp}E{lead_exp}"


def _spark_to_long(s: str, lo: int, hi: int):
    """Spark's ``UTF8String.toLong`` in a non-ANSI cast: an optional sign,
    digits, and an optional '.' with digits after it (truncated); null on
    anything else or past [lo, hi]."""
    if not s:
        return None
    neg = s[0] == "-"
    i = 1 if s[0] in "+-" else 0
    if i == len(s):
        return None
    whole, _, frac = s[i:].partition(".")
    if not (whole == "" or (whole.isascii() and whole.isdigit())):
        return None
    if frac and not (frac.isascii() and frac.isdigit()):
        return None
    v = int(whole) if whole else 0
    v = -v if neg else v
    return v if lo <= v <= hi else None


def _parse_float(s: str):
    """The reference's string → double rule (Java's ``parseDouble`` plus
    Spark's special literals), null where Java's parse fails."""
    sl = s.lower()
    if sl == "nan":
        return float("nan")
    if sl in ("inf", "infinity", "+inf", "+infinity"):
        return float("inf")
    if sl in ("-inf", "-infinity"):
        return float("-inf")
    if "_" in s or not s.isascii():
        return None  # Python-only syntax: Java rejects it
    if sl and sl[-1] in "df" and len(sl) > 1 \
            and (sl[-2].isdigit() or sl[-2] == "."):
        s = s[:-1]
    try:
        return float(s)
    except ValueError:
        return None


_DATE_RE = re.compile(
    r"^([+-]?\d{1,7})(?:-(\d{1,2})(?:-(\d{1,2})(?:[ T].*)?)?)?$", _ASCII)
_TIME_RE = re.compile(
    r"^([+-]?\d{1,7})(?:-(\d{1,2})(?:-(\d{1,2})"
    r"(?:[ T](\d{1,2})(?::(\d{1,2})(?::(\d{1,2})"
    r"(?:\.(\d{1,9}))?)?)?\s*(.*))?)?)?$", _ASCII)


def _parse_spark_date(s: str):
    """Spark's ``stringToDate``: ``[+-]y{1,7}[-m[-d]]``, anything after the
    day allowed after ' ' or 'T'. A ``datetime.date`` or None."""
    import datetime
    m = _DATE_RE.match(s.strip())
    if not m:
        return None
    y = int(m.group(1))
    mo = int(m.group(2)) if m.group(2) else 1
    d = int(m.group(3)) if m.group(3) else 1
    try:
        return datetime.date(y, mo, d)
    except ValueError:
        return None


def _parse_spark_timestamp(s: str, db=None):
    """Spark's ``stringToTimestamp``: the date as in ``stringToDate``,
    ``[h]h[:[m]m[:[s]s[.f{1,9}]]]`` after ' ' or 'T', an optional zone
    ``Z``/``UTC``/``GMT``/``[+-]h[h][:mm]``; ``epoch``. A text without a
    zone is a wall time in the session zone ``db`` (None: UTC). Epoch
    microseconds or None."""
    import datetime
    s = s.strip()
    if s.lower() == "epoch":
        return 0
    m = _TIME_RE.match(s)
    if not m:
        return None
    y = int(m.group(1))
    mo = int(m.group(2)) if m.group(2) else 1
    d = int(m.group(3)) if m.group(3) else 1
    hh = int(m.group(4)) if m.group(4) else 0
    mi = int(m.group(5)) if m.group(5) else 0
    ss = int(m.group(6)) if m.group(6) else 0
    frac = m.group(7) or ""
    us = int(frac[:6].ljust(6, "0")) if frac else 0
    zone = (m.group(8) or "").strip()
    off_us = 0
    if zone and not re.match(r"^(?:Z|z|UTC|GMT)$", zone):
        zm = re.match(r"^([+-])(\d{1,2})(?::(\d{1,2}))?$", zone, _ASCII)
        if not zm:
            return None
        sign = 1 if zm.group(1) == "+" else -1
        off_us = sign * ((int(zm.group(2)) * 60 + int(zm.group(3) or 0))
                         * 60 * 1_000_000)
    if hh > 23 or mi > 59 or ss > 59:
        return None
    try:
        day = datetime.date(y, mo, d)
    except ValueError:
        return None
    epoch_days = (day - datetime.date(1970, 1, 1)).days
    local = epoch_days * 86_400_000_000 \
        + (hh * 3600 + mi * 60 + ss) * 1_000_000 + us
    if not zone and db is not None:
        return int(db.local_to_utc_np(np.array([local], np.int64))[0])
    return local - off_us


def _fast_then_rows(trimmed, fast_re: str, fast, dummy: str, slow,
                    out_type):
    """Rows matching ``fast_re`` through the vectorized ``fast`` (over the
    whole array, ``dummy`` standing in for the other rows), the rest
    through ``slow`` a row at a time; one Arrow array of ``out_type`` in
    row order."""
    import pyarrow as pa
    import pyarrow.compute as pc
    hit = pc.fill_null(pc.match_substring_regex(trimmed, fast_re), True)
    miss = np.nonzero(~np.asarray(hit.to_numpy(zero_copy_only=False),
                                  dtype=bool))[0]
    if not miss.size:
        return fast(trimmed)
    vals = fast(pc.if_else(hit, trimmed, dummy))
    texts = pc.take(trimmed, pa.array(miss)).to_pylist()
    return pc.replace_with_mask(vals, pc.invert(hit), pa.array(
        [slow(t) for t in texts], out_type))


def parse_string(arr, dst: DataType, tz: Optional[str] = None):
    """Spark's non-ANSI string → ``dst`` (reference
    ``_parse_string_arrow``): surrounding whitespace trimmed, null where
    the text is not a value of ``dst``; a timestamp's text without a zone
    is a wall time in the session zone ``tz``."""
    import pyarrow as pa
    import pyarrow.compute as pc
    from ..types import to_arrow
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    trimmed = pc.utf8_trim_whitespace(arr)
    if isinstance(dst, BooleanType):
        lowered = pc.utf8_lower(trimmed)
        is_t = pc.is_in(lowered, value_set=pa.array(
            ["t", "true", "y", "yes", "1"]))
        is_f = pc.is_in(lowered, value_set=pa.array(
            ["f", "false", "n", "no", "0"]))
        bad = pc.and_(pc.invert(is_t), pc.invert(is_f))
        return pc.if_else(bad, pa.scalar(None, pa.bool_()), is_t)
    if isinstance(dst, IntegralType):
        lo, hi = _INT_BOUNDS[np.dtype(dst.np_dtype)]
        wide = _fast_then_rows(
            trimmed, r"^-?[0-9]{1,18}$",
            lambda a: pc.cast(a, pa.int64()), "0",
            lambda s: _spark_to_long(s, lo, hi), pa.int64())
        out_of_range = pc.or_(pc.less(wide, lo), pc.greater(wide, hi))
        return pc.if_else(out_of_range, pa.scalar(None, pa.int64()),
                          wide).cast(to_arrow(dst))
    if isinstance(dst, (FloatType, DoubleType)):
        wide = _fast_then_rows(
            trimmed, r"^-?([0-9]+\.?[0-9]*|\.[0-9]+)([eE][+-]?[0-9]+)?$",
            lambda a: pc.cast(a, pa.float64()), "0", _parse_float,
            pa.float64())
        return wide.cast(to_arrow(dst), safe=False)
    if isinstance(dst, DateType):
        def iso(a):
            try:
                return pc.cast(a, pa.date32())
            except pa.ArrowInvalid:  # an impossible day: row by row
                return pa.array([None if s is None else _parse_spark_date(s)
                                 for s in a.to_pylist()], pa.date32())
        return _fast_then_rows(trimmed, r"^[0-9]{4}-[0-9]{2}-[0-9]{2}$", iso,
                               "1970-01-01", _parse_spark_date, pa.date32())
    if isinstance(dst, TimestampType):
        db = zone_table(tz)
        vals = [None if s is None else _parse_spark_timestamp(s, db)
                for s in trimmed.to_pylist()]
        return pa.array(vals, type=pa.int64()).cast(pa.timestamp("us"))
    raise NotImplementedError(f"cast string -> {dst} not yet ported")
