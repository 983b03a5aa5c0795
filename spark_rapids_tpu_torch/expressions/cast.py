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
* string → integral, fractional, boolean, date and timestamp (UTC session
  zone), null where Spark's non-ANSI cast is null.

The host work is vectorized through pyarrow and numpy where Spark's rules
and Arrow's agree (plain digits, plain decimals, ISO dates, floats in
[1e-3, 1e7)), and a row at a time elsewhere. Where the reference departs
from Spark (an integral parse of "1.5", "1_000" or a value past the type's
range as a literal) the port gives Spark's answer (ROADMAP C-ref-15).
Decimal string casts wait with ``decimal128``; ANSI mode waits too. A
literal casts by the same rules as a column.

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

from ..columnar.vector import TorchScalar, row_mask
from ..types import (BooleanType, DataType, DateType, DecimalType,
                     DoubleType, FloatType, FractionalType, IntegralType,
                     NullType, NumericType, StringType, TimestampType)
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
    """A cast to or from a string the port carries (not decimals)."""
    if isinstance(src, DecimalType) or isinstance(dst, DecimalType):
        return False
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

    def _check(self, ctx) -> bool:
        """Whether the cast is a string cast; raises where the port has no
        such cast."""
        src, dst = self.child.dtype, self._to
        ansi = self._ansi if self._ansi is not None else ctx.ansi
        if ansi:
            raise NotImplementedError(
                "ANSI-mode cast not yet ported (ROADMAP A6, decimals with "
                "decimal128 and the ANSI casts)")
        strings = isinstance(src, StringType) or isinstance(dst, StringType)
        if src != dst and not (string_castable(src, dst) if strings
                               else _castable(src, dst)):
            raise NotImplementedError(f"cast {src} -> {dst} not yet ported")
        return strings

    def _cast_constant(self, v, strings: bool):
        src, dst = self.child.dtype, self._to
        if strings and src != dst:
            return _cast_scalar_string(v, src, dst)
        return _cast_scalar(v, dst)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        import pyarrow as pa
        from ..types import to_arrow
        src, dst = self.child.dtype, self._to
        strings = self._check(ctx)
        c = self.child.eval_cpu(table, ctx)
        if not is_arrow(c):
            return self._cast_constant(c, strings)
        arr = arrow_column(c, len(c), src)
        if src == dst:
            return arr
        if strings:
            return format_to_string(arr, src) if isinstance(dst, StringType) \
                else parse_string(arr, dst)
        vals, null = arrow_numpy(arr, len(arr), src)
        out = _numeric_cast(torch.from_numpy(np.array(vals)), src, dst)
        # a host tensor (eval_cpu): no device transfer
        return pa.array(out.numpy(), type=to_arrow(dst),
                        mask=null if null.any() else None)

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        src, dst = self.child.dtype, self._to
        strings = self._check(ctx)
        c = self.child.eval_device(batch, ctx)
        if isinstance(c, TorchScalar):
            return TorchScalar(dst, self._cast_constant(c.value, strings))
        if src == dst:
            return c
        if strings:
            from .strings import column_from_arrow, column_to_arrow, host_path
            host_path(ctx, self, "string cast")
            arr = column_to_arrow(c)
            out = format_to_string(arr, src) if isinstance(dst, StringType) \
                else parse_string(arr, dst)
            return column_from_arrow(out, dst, batch)
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
    raise NotImplementedError(f"scalar cast to {dst} not yet ported")


# ---------------------------------------------------------------------------
# casts to and from strings (reference cast.py:189-450), on the host
# ---------------------------------------------------------------------------

_ASCII = re.ASCII


def _cast_scalar_string(v, src: DataType, dst: DataType):
    """A literal's string cast, by the column rules (a date literal is its
    day number, a timestamp its microseconds)."""
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
        return format_to_string(arr, src)[0].as_py()
    out = parse_string(pa.array([v], pa.string()), dst)
    if isinstance(dst, DateType):
        out = out.cast(pa.int32())
    elif isinstance(dst, TimestampType):
        out = out.cast(pa.int64())
    return out[0].as_py()


def format_to_string(arr, src: DataType):
    """Spark's text of each value (reference ``_format_to_string_arrow``):
    Java's shortest round-trip float text, ``true``/``false``, ISO dates,
    timestamps with a trimmed fraction."""
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
        return _timestamp_strings(arr)
    raise NotImplementedError(f"cast {src} -> string not yet ported")


def _timestamp_strings(arr):
    """``y-MM-dd HH:mm:ss[.f]`` of each timestamp (the year unpadded, as
    the reference's ``strftime`` gives it), the fraction's trailing zeros
    trimmed, with numpy over the microseconds: no Python ``datetime`` a
    row."""
    import pyarrow as pa
    us = np.asarray(arr.cast(pa.int64()).fill_null(0).to_numpy(
        zero_copy_only=False), np.int64)
    secs = np.floor_divide(us, 1_000_000)
    frac = us - secs * 1_000_000
    text = np.char.lstrip(np.char.replace(np.datetime_as_string(
        secs.astype("datetime64[s]"), unit="s"), "T", " "), "0")
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


def _parse_spark_timestamp(s: str):
    """Spark's ``stringToTimestamp`` in the UTC session zone: the date as in
    ``stringToDate``, ``[h]h[:[m]m[:[s]s[.f{1,9}]]]`` after ' ' or 'T', an
    optional zone ``Z``/``UTC``/``GMT``/``[+-]h[h][:mm]``; ``epoch``. Epoch
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
    return (epoch_days * 86_400_000_000
            + (hh * 3600 + mi * 60 + ss) * 1_000_000 + us) - off_us


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


def parse_string(arr, dst: DataType):
    """Spark's non-ANSI string → ``dst`` (reference
    ``_parse_string_arrow``): surrounding whitespace trimmed, null where
    the text is not a value of ``dst``."""
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
        vals = [None if s is None else _parse_spark_timestamp(s)
                for s in trimmed.to_pylist()]
        return pa.array(vals, type=pa.int64()).cast(pa.timestamp("us"))
    raise NotImplementedError(f"cast string -> {dst} not yet ported")
