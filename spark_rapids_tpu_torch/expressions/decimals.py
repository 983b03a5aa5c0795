"""Decimal evaluation with Spark's semantics: the helpers the arithmetic,
comparisons, casts and aggregates share.

Spark 3.x's ``DecimalPrecision`` with ``allowPrecisionLoss=true`` (the
default) sets the result types (``types.decimal_result_type``). A value
is its unscaled integer: int64 ``[n]`` up to precision 18, two int64
limbs ``[n, 2]`` past it (``kernels/decimal128.py``). A result past its
precision is null (non-ANSI) or an ``ExpressionError`` (ANSI), the same
message on the card and on the host.

On the card: rescaling (up: a multiply with an overflow check; down:
HALF_UP through ``decimal128.rescale_down``), ``+ - * / % pmod``
(``/``, ``%`` and ``pmod`` by ``decimal128.divmod128``), ``round``,
``bround``, ``floor`` and ``ceil`` (``round_decimal``), comparisons, the
casts between decimals and integers, decimal → double where the float64
quotient is correctly rounded, double → decimal for the rows clear of a
tie. The rest goes to the host a batch at a time, through exact Python
integers, and is counted in ``session.counters["decimal.hostPath"]``
(``decimal.hostPath.<class>.<reason>``): a product past 10^38 before its
rescale, a dividend or divisor that its scaling takes past 2^127, the
float conversions' remaining rows, and the string casts. The host
engine's ``/ % pmod`` and rounding run the exact integer rules below
(``divide_arr``, ``remainder_arr``, ``pmod_arr``, ``round_arr``), which
the card's rows equal.
"""

from __future__ import annotations

import decimal
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..columnar.vector import (audited_sync_int, audited_tolist,
                               decimal_from_arrow, decimal_to_arrow)
from ..kernels import decimal128 as D
from ..types import DataType, DecimalType, IntegralType, integral_decimal

HOST_PATH = "decimal.hostPath"

#: why an operator over a decimal stays off the card
A6_REASON = "decimal {what} not yet ported to the device (ROADMAP A6)"


def host_path(ctx, expr, reason: str) -> None:
    """Count one batch of ``expr`` through the decimal host hop."""
    name = expr if isinstance(expr, str) else type(expr).__name__
    ctx.counters[HOST_PATH] += 1
    ctx.counters[f"{HOST_PATH}.{name}.{reason}"] += 1


def as_decimal_type(dt: DataType) -> DecimalType:
    """A decimal type, or an integral type as the decimal that holds it."""
    return integral_decimal(dt) if isinstance(dt, IntegralType) else dt


# ---------------------------------------------------------------------------
# device helpers
# ---------------------------------------------------------------------------


def broadcast_rows(data: torch.Tensor, cap: int, dtype: DataType):
    """A carrier (or a scalar's) broadcast to ``cap`` rows."""
    wide = isinstance(dtype, DecimalType) and dtype.wide
    return torch.broadcast_to(data, (cap, 2) if wide else (cap,))


def zeros_rows(cap: int, dtype: DataType, device) -> torch.Tensor:
    """A zero carrier of ``cap`` rows of a fixed-width type."""
    wide = isinstance(dtype, DecimalType) and dtype.wide
    return torch.zeros((cap, 2) if wide else (cap,),
                       dtype=dtype.torch_dtype or torch.bool, device=device)


def rows_as(x, src: DataType, dst: DecimalType, cap: int, device):
    """A decimal (or integral, or null) column or scalar as ``dst``'s
    carrier over ``cap`` rows: (data, validity or None); a value past
    ``dst`` is null."""
    from ..types import NullType
    from .base import combine_validity, device_parts
    d, v = device_parts(x, cap, device)
    if isinstance(src, NullType):
        return zeros_rows(cap, dst, device), v
    d = broadcast_rows(d, cap, src)
    src = as_decimal_type(src)
    if src == dst:
        return d, v
    d, ovf = change_scale(d.to(torch.int64), src, dst)
    return d, combine_validity(v, ~ovf)


def to_carrier(h: torch.Tensor, l: torch.Tensor,
               dtype: DecimalType) -> torch.Tensor:
    """(hi, lo) in ``dtype``'s carrier (the low limb up to precision 18:
    the value fits it once its precision is checked)."""
    return D.join(h, l) if dtype.wide else l


def change_scale(data: torch.Tensor, src: DecimalType, dst: DecimalType
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Values of ``src`` as ``dst`` (Spark's ``changePrecision``: a finer
    scale multiplies, a coarser one rounds HALF_UP): (carrier, overflow
    past ``dst``'s precision)."""
    k = dst.scale - src.scale
    if not src.wide and not dst.wide and src.precision + max(k, 0) <= 18:
        x = data
        if k > 0:
            x = x * (10 ** k)
        elif k < 0:
            m = 10 ** (-k)
            half = torch.where(x >= 0, m // 2, -(m // 2))
            x = torch.div(x + half, m, rounding_mode="trunc")
        # HALF_UP can carry into one more digit when the scale drops
        # (9.99 as decimal(2,1) is 10.0)
        if src.precision + k + (k < 0) > dst.precision:
            ovf = torch.abs(x) >= 10 ** dst.precision
        else:
            ovf = torch.zeros_like(x, dtype=torch.bool)
        return x, ovf
    h, l = D.limbs_of(data)
    if k >= 0:
        h, l, ovf = D.rescale_up(h, l, k)
    else:
        h, l = D.rescale_down(h, l, -k)
        ovf = torch.zeros_like(h, dtype=torch.bool)
    ovf = ovf | D.precision_overflow(h, l, dst.precision)
    return to_carrier(h, l, dst), ovf


def compare_sign(l: torch.Tensor, r: torch.Tensor) -> Optional[torch.Tensor]:
    """-1/0/+1 of two two-limb carriers (None for one-lane carriers:
    they compare as they are)."""
    if l.dim() < 2 and r.dim() < 2:
        return None
    lh, ll = D.limbs_of(l)
    rh, rl = D.limbs_of(r)
    return D.cmp128(lh, ll, rh, rl)


def overflow_check(ovf: torch.Tensor, valid, ansi: bool, message: str
                   ) -> Optional[torch.Tensor]:
    """Rows past the result's precision: ANSI raises ``message`` when any
    valid row is one (one host read); else they turn null — the new
    validity."""
    from .base import ExpressionError, combine_validity
    if ansi:
        flag = ovf if valid is None else ovf & valid
        if audited_sync_int(flag.any(), "scalar"):
            raise ExpressionError(message)
        return valid
    return combine_validity(valid, ~ovf)


def host_rows(flag: torch.Tensor) -> Optional[torch.Tensor]:
    """The indices of the flagged rows, or None when there is none (one
    host read)."""
    if not audited_sync_int(flag.any(), "scalar"):
        return None
    return torch.nonzero(flag).flatten()


def carrier_ints(data: torch.Tensor, idx: torch.Tensor) -> List[int]:
    """Python ints of the carrier's rows ``idx`` (one download)."""
    rows = audited_tolist(data[idx], "fetch")
    if data.dim() == 2:
        return [D.limbs_to_int(h, l) for h, l in rows]
    return [int(v) for v in rows]


def put_ints(out: torch.Tensor, idx: torch.Tensor, values: List[int]) -> None:
    """Write Python ints (fitting the carrier) into rows ``idx`` of a
    carrier (one upload)."""
    if out.dim() == 2:
        vals = torch.tensor([D.int_to_limbs(v) for v in values],
                            dtype=torch.int64).reshape(len(values), 2)
    else:
        vals = torch.tensor(values, dtype=torch.int64)
    out[idx] = vals.to(out.device)


def round_decimal(data: torch.Tensor, src: DecimalType, dst: DecimalType,
                  scale: int, mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Values of ``src`` rounded at ``scale`` fraction digits (negative: to
    a multiple of 10^-scale) by ``mode`` (``decimal128.round_pow10``'s),
    in ``dst``'s carrier: (carrier, overflow past ``dst``'s precision).
    One int64 lane when the source has one and the dropped digits fit it,
    else the limbs."""
    k = src.scale - scale  # digits dropped
    if k <= 0:  # nothing to round: the value as it is
        return change_scale(data, src, dst)
    if not src.wide and k <= 18:
        m = 10 ** k
        a = torch.abs(data)
        q = torch.div(a, m, rounding_mode="floor")
        r = a - q * m
        neg = data < 0
        if mode == "half_up":
            up = 2 * r >= m
        elif mode == "half_even":
            up = (2 * r > m) | ((2 * r == m) & ((q & 1) == 1))
        else:
            up = (r != 0) & (neg if mode == "floor" else ~neg)
        q = q + up.to(torch.int64)
        # a negative scale multiplies back: |q| * 10^-scale <= 10^(p - s)
        # + 10^-scale < 2^63 (p <= 18, -scale <= k <= 18)
        v = torch.where(neg, -q, q) * 10 ** max(-scale, 0)
        ovf = torch.abs(v) >= 10 ** dst.precision if dst.precision < 19 \
            else torch.zeros_like(neg)
        return (D.join(*D.from_int64(v)) if dst.wide else v), ovf
    h, l = D.limbs_of(data)
    if k > 38:  # |v| < 10^38: under a tenth of the unit, so 0
        h, l = torch.zeros_like(h), torch.zeros_like(l)
    else:
        h, l = D.round_pow10(h, l, k, mode)
    h, l, ovf = D.rescale_up(h, l, max(-scale, 0))
    ovf = ovf | D.precision_overflow(h, l, dst.precision)
    return to_carrier(h, l, dst), ovf


def _bit_bound(digits: int) -> int:
    """Bits of the largest value under 10^digits (at most 127)."""
    return min((10 ** digits - 1).bit_length(), 127)


def _scaled_magnitude(data: torch.Tensor, k: int):
    """|value| · 10^k of a carrier: (hi, lo, negative, past 2^127)."""
    h, l = D.limbs_of(data)
    mh, ml, neg = D._magnitude(h, l)
    mh, ml, big = D.rescale_up(mh, ml, k)
    return mh, ml, neg, big


def _uge(ah, al, bh, bl, narrow: bool):
    """a >= b of non-negative values (one lane each when ``narrow``)."""
    if narrow:
        return al >= bl
    return ~D._ult128(ah, al, bh, bl)


def divmod_decimals(op: str, a: torch.Tensor, b: torch.Tensor,
                    lt: DecimalType, rt: DecimalType, out: DecimalType):
    """Spark's decimal ``/``, ``%`` or ``pmod`` of two carriers on the
    card: (result carrier, overflow past ``out``'s precision, rows whose
    scaled operands pass 2^127 — the caller's host rows, zero divisors
    already excluded by its validity).

    ``/`` rounds twice in Spark: the quotient at scale 38 HALF_UP, then to
    the result scale s_r HALF_UP. With N = |a|·10^(s_r − s_a + s_b) (or
    the divisor scaled when that exponent is negative), D = |b|, q, r =
    divmod(N, D) and T = 10^(38 − s_r), the two roundings together round
    q up exactly when D − 2r <= floor(D / T) for T >= 10, and when 2r >= D
    for T = 1 (as for T past every D, where floor(D / T) is 0). ``%``
    aligns both sides to max(s_a, s_b) and keeps the dividend's sign;
    ``pmod`` adds the divisor to a negative remainder of a positive
    divisor."""
    if op == "/":
        k = out.scale - lt.scale + rt.scale
        ka, kb = max(k, 0), max(-k, 0)
    else:
        s = max(lt.scale, rt.scale)
        ka, kb = s - lt.scale, s - rt.scale
    nh, nl, a_neg, big_a = _scaled_magnitude(a, ka)
    dh, dl, b_neg, big_b = _scaled_magnitude(b, kb)
    n_bits = _bit_bound(lt.precision + ka)
    d_bits = _bit_bound(rt.precision + kb)
    big = big_a | big_b
    zero = (dh == 0) & (dl == 0)
    bad = big | zero  # computed on dummies: 0 / 1
    nh = torch.where(bad, 0, nh)
    nl = torch.where(bad, 0, nl)
    dh = torch.where(bad, 0, dh)
    dl = torch.where(bad, 1, dl)
    narrow = d_bits <= 62
    qh, ql, rh, rl = D.divmod128(nh, nl, dh, dl, n_bits, d_bits)
    if op == "/":
        t_digits = 38 - out.scale
        eh, el, _ = D.sub128(dh, dl, rh, rl)  # D − r > 0
        if t_digits == 0 or (10 ** t_digits).bit_length() > d_bits:
            # T = 1 (one rounding: 2r >= D), or T past every D
            fh, fl = torch.zeros_like(rh), torch.zeros_like(rl)
        elif narrow:
            fh = torch.zeros_like(rh)
            fl = torch.div(dl, 10 ** t_digits, rounding_mode="floor")
        else:
            fh, fl = D.rescale_trunc(dh, dl, t_digits)
        sh, sl, _ = D.add128(rh, rl, fh, fl)  # r + floor(D / T) < 2^128
        up = _uge(sh, sl, eh, el, narrow)
        vh, vl, _ = D.add128(qh, ql, torch.zeros_like(qh),
                             up.to(torch.int64))
        neg = a_neg != b_neg
    else:
        vh, vl = rh, rl
        if op == "pmod":  # a negative remainder of a positive divisor
            wrap = a_neg & ~b_neg & ((rh != 0) | (rl != 0))
            yh, yl, _ = D.sub128(dh, dl, rh, rl)
            vh, vl = torch.where(wrap, yh, vh), torch.where(wrap, yl, vl)
            neg = a_neg & ~wrap
        else:
            neg = a_neg
    ovf = D.precision_overflow(vh, vl, out.precision)
    nh_, nl_ = D.neg128(vh, vl)
    vh, vl = torch.where(neg, nh_, vh), torch.where(neg, nl_, vl)
    # % and pmod: Spark's type keeps the common scale (its precision,
    # min(p1 - s1, p2 - s2) + s, never passes 38)
    return to_carrier(vh, vl, out), ovf, big


# ---------------------------------------------------------------------------
# exact integer rules (host; Spark's java.math.BigDecimal operations)
# ---------------------------------------------------------------------------


def half_up_div(n: int, d: int) -> int:
    """n / d rounded HALF_UP (ties away from zero), d != 0."""
    q, r = divmod(abs(n), abs(d))
    if 2 * r >= abs(d):
        q += 1
    return q if (n >= 0) == (d > 0) else -q


def rescale_int(v: int, from_scale: int, to_scale: int) -> int:
    """An unscaled value at another scale, HALF_UP when it drops
    digits."""
    k = to_scale - from_scale
    return v * 10 ** k if k >= 0 else half_up_div(v, 10 ** (-k))


def round_significant(v: int, digits: int = 38) -> int:
    """``v`` rounded HALF_UP to ``digits`` significant digits, in units of
    the original last place (Spark's ``MathContext(38, HALF_UP)``)."""
    n = len(str(abs(v)))
    if n <= digits:
        return v
    m = 10 ** (n - digits)
    return half_up_div(v, m) * m


def fits(v: Optional[int], precision: int) -> bool:
    return v is not None and abs(v) < 10 ** precision


def spark_multiply(a: int, b: int, sa: int, sb: int,
                   dst: DecimalType) -> Optional[int]:
    """Spark 3.x's decimal ``*`` (BigDecimal multiply under
    ``MathContext(38, HALF_UP)``) then ``CheckOverflow`` to ``dst``
    (HALF_UP): the unscaled result, or None past its precision."""
    v = rescale_int(round_significant(a * b), sa + sb, dst.scale)
    return v if fits(v, dst.precision) else None


# the same rules over numpy object arrays of Python ints (the host
# engine's ``/``, ``%`` and ``pmod``: one pass an operation, no Python
# loop a row); each returns (values, defined) with ``defined`` False for a
# zero divisor or a value past the precision


def _half_up_div_arr(n: np.ndarray, d: np.ndarray) -> np.ndarray:
    an, ad = np.abs(n), np.abs(d)
    q = an // ad
    r = an - q * ad
    q = q + (2 * r >= ad).astype(object)
    return np.where((n < 0) != (d < 0), -q, q)


def rescale_arr(v: np.ndarray, from_scale: int, to_scale: int):
    """``rescale_int`` over an object array."""
    k = to_scale - from_scale
    return v * 10 ** k if k >= 0 else \
        _half_up_div_arr(v, np.full(len(v), 10 ** (-k), dtype=object))


def _finish_arr(v, zero, dst: DecimalType):
    ok = ~zero & (np.abs(v) < 10 ** dst.precision).astype(bool)
    return np.where(ok, v, 0), ok


def divide_arr(a, b, sa: int, sb: int, dst: DecimalType):
    """Spark 3.x's decimal ``/``: the quotient at scale 38 HALF_UP
    (``BigDecimal.divide(_, MAX_SCALE, HALF_UP)``), then ``CheckOverflow``
    to ``dst`` (HALF_UP)."""
    zero = (b == 0).astype(bool)
    b = np.where(zero, 1, b)
    k = 38 - sa + sb
    q38 = _half_up_div_arr(a * 10 ** k, b) if k >= 0 else \
        _half_up_div_arr(a, b * 10 ** (-k))
    return _finish_arr(rescale_arr(q38, 38, dst.scale), zero, dst)


def _rem_arr(x, y):
    r = np.abs(x) % np.abs(y)
    return np.where(x < 0, -r, r)


def remainder_arr(a, b, sa: int, sb: int, dst: DecimalType):
    """Spark's decimal ``%`` (``BigDecimal.remainder``: the dividend's
    sign) at the operands' common scale."""
    zero = (b == 0).astype(bool)
    s = max(sa, sb)
    x, y = a * 10 ** (s - sa), np.where(zero, 1, b) * 10 ** (s - sb)
    return _finish_arr(rescale_arr(_rem_arr(x, y), s, dst.scale), zero,
                       dst)


def pmod_arr(a, b, sa: int, sb: int, dst: DecimalType):
    """Spark's ``pmod``: ``r = a % n; r < 0 ? (r + n) % n : r``."""
    zero = (b == 0).astype(bool)
    s = max(sa, sb)
    x, y = a * 10 ** (s - sa), np.where(zero, 1, b) * 10 ** (s - sb)
    r = _rem_arr(x, y)
    r = np.where(r < 0, _rem_arr(r + y, y), r)
    return _finish_arr(rescale_arr(r, s, dst.scale), zero, dst)


def round_arr(v, k: int, mode: str, mult: int):
    """``round_decimal``'s rule over an object array of Python ints: ``v``
    / 10^k (k >= 1) rounded by ``mode``, times ``mult``."""
    m = 10 ** k
    a = np.abs(v)
    q, r = a // m, a % m
    neg = (v < 0).astype(bool)
    if mode == "half_up":
        up = (2 * r >= m).astype(bool)
    elif mode == "half_even":
        up = ((2 * r > m) | ((2 * r == m) & (q % 2 == 1))).astype(bool)
    else:
        up = (r != 0).astype(bool) & (neg if mode == "floor" else ~neg)
    q = q + up.astype(object)
    return np.where(neg, -q, q) * mult


# ---------------------------------------------------------------------------
# Arrow ↔ Python ints (host engine)
# ---------------------------------------------------------------------------


def arrow_ints(arr, dtype: DataType) -> List[Optional[int]]:
    """An Arrow decimal (or integral) array's unscaled Python ints, None
    for null."""
    import pyarrow as pa
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if pa.types.is_integer(arr.type):
        return arr.cast(pa.int64()).to_pylist()
    t = DecimalType(arr.type.precision, arr.type.scale)
    vals = decimal_from_arrow(arr, t)
    ints = [D.limbs_to_int(h, l) for h, l in vals.tolist()] if t.wide \
        else vals.tolist()
    if arr.null_count:
        ok = np.asarray(arr.is_valid())
        ints = [v if k else None for v, k in zip(ints, ok)]
    return ints


def finish_sum_avg(fn, v, n, ansi: bool):
    """Spark's decimal ``sum`` (null past p + 10 digits) or ``avg`` (the
    sum over the count as Spark's decimal Divide, cast HALF_UP to
    (p + 4, s + 4)) of ``fn`` from exact sums ``v`` and non-null counts
    ``n`` (object arrays of Python ints): (unscaled values, validity).
    Under ANSI a value past its type raises the card's error."""
    from ..types import decimal_result_type, sum_decimal_type
    from .base import ExpressionError
    sum_t = sum_decimal_type(fn.children[0].dtype)
    seen = (n != 0).astype(bool)
    ok = seen & (np.abs(v) < 10 ** sum_t.precision).astype(bool)
    if fn.update_op == "avg":
        q_t = decimal_result_type("/", sum_t, DecimalType(20, 0))
        q, defined = divide_arr(v, np.where(ok, n, 1), sum_t.scale, 0, q_t)
        v = rescale_arr(q, q_t.scale, fn.dtype.scale)
        ok &= defined & (np.abs(v) < 10 ** fn.dtype.precision).astype(bool)
    if ansi and (seen & ~ok).any():
        raise ExpressionError(f"decimal overflow in {fn.update_op}")
    return v, ok


def arrow_words(arr) -> List[np.ndarray]:
    """An Arrow decimal array's unscaled values as their four 32-bit
    words, low first, the top one signed (0 at nulls), each int64: summed
    in int64 they give exact 128-bit sums under 2^31 rows (the host
    engine's decimal sum; the card's is ``decimal128.segment_words128``)."""
    import pyarrow as pa
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    w = decimal_from_arrow(arr, DecimalType(38, arr.type.scale))
    hi, lo, m = w[:, 0], w[:, 1], np.int64(0xFFFFFFFF)
    return [lo & m, (lo >> 32) & m, hi & m, hi >> 32]


def arrow_object(arr):
    """An Arrow decimal array's unscaled values as a numpy object array
    of Python ints (0 at nulls) and its validity."""
    ints = arrow_ints(arr, None)
    ok = np.array([v is not None for v in ints], np.bool_)
    vals = np.empty(len(ints), dtype=object)
    vals[:] = [0 if v is None else v for v in ints]
    return vals, ok


def ints_to_arrow(ints, dtype: DecimalType, ok=None):
    """Unscaled Python ints (a list with None for null, or an object array
    with its ``ok`` mask; each within ``dtype``'s precision) as an Arrow
    decimal array."""
    if ok is None:
        ok = np.array([v is not None for v in ints], np.bool_)
        ints = np.array([0 if v is None else v for v in ints], dtype=object)
    vals = np.where(ok, ints, 0).astype(object)
    if dtype.wide:
        lo = vals & D._MASK64
        lo = np.where(lo >= 2 ** 63, lo - 2 ** 64, lo).astype(np.int64)
        data = np.stack([(vals >> 64).astype(np.int64), lo], 1) \
            if len(vals) else np.zeros((0, 2), np.int64)
    else:
        data = vals.astype(np.int64)
    return decimal_to_arrow(data, dtype, ok)
