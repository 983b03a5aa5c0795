"""128-bit decimal arithmetic as two int64 limbs (port of
``spark_rapids_tpu/kernels/decimal128.py``).

A decimal past precision 18 is carried as ``[n, 2]`` int64, each row
``(hi, lo)``:

  hi = v >> 64   (signed int64)
  lo = v & mask  (the low 64 bits as an int64 bit pattern)

and every op is int64 math with explicit carries, as in the reference
(torch has no 128-bit integer on either device). Unsigned comparison of
bit patterns uses the sign-flip trick (u(x) < u(y) iff (x^MIN) < (y^MIN)
signed); ``_umul64`` multiplies 32-bit halves.

Beyond the reference's functions (``add128``, ``sub128``, ``mul128``,
``cmp128``, ``precision_overflow``, ``from_int64`` and the host
conversions) the port has two of its own, which its expressions need on
the device:

* ``divmod_small``: 128 ÷ a positive divisor under 2^31 by long division
  over 32-bit digits; ``rescale_down`` (HALF_UP to fewer digits: casts,
  the product's rescale), ``round_pow10`` (HALF_UP, HALF_EVEN, floor or
  ceiling to fewer digits: ``round``, ``bround``, ``floor``, ``ceil``)
  and ``div_half_up`` (``avg``'s quotient at a scale) are built on it;
* ``divmod128``: 128 ÷ 128 bits, unsigned, for ``/``, ``%`` and ``pmod``
  of decimals: long division over k-bit digits when the divisor fits
  63 − k bits (one int64 lane holds the remainder), bit by bit with a
  two-limb remainder past that;
* ``segment_sum128``: a segmented sum of 128-bit values, each value split
  into four 32-bit words summed in int64 by the caller's segment
  reduction (``segment_words128``: partial word sums merge by addition),
  then one carry pass (``carry_words128``). Exact for any segment under
  2^31 rows, and deterministic (integer sums, no atomics).

Eager torch, as the rest of the expression layer: no hand-written kernel
(ROADMAP Queue B admits one once a cell shows these ops leading a query).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

_MIN = -2 ** 63
_MASK64 = (1 << 64) - 1
_MASK32 = 0xFFFFFFFF

# ---------------------------------------------------------------------------
# host-side conversion
# ---------------------------------------------------------------------------

_DEC_CTX = None


def _ctx():
    global _DEC_CTX
    if _DEC_CTX is None:
        import decimal
        _DEC_CTX = decimal.Context(prec=80)  # default prec=28 would ROUND
    return _DEC_CTX


def unscaled_int(value, scale: int) -> int:
    """Decimal/str/int → exact unscaled int at `scale` (no context
    rounding; digits past `scale` are truncated)."""
    import decimal
    d = value if isinstance(value, decimal.Decimal) else decimal.Decimal(value)
    return int(d.scaleb(scale, context=_ctx()))


def scaled_decimal(unscaled: int, scale: int):
    """Exact unscaled int → Decimal at `scale` (no context rounding)."""
    import decimal
    return decimal.Decimal(unscaled).scaleb(-scale, context=_ctx())


def int_to_limbs(v: int) -> Tuple[int, int]:
    """python int → (hi, lo) with lo as a signed-int64 bit pattern."""
    lo = v & _MASK64
    if lo >= 1 << 63:
        lo -= 1 << 64
    return (v >> 64, lo)


def limbs_to_int(hi: int, lo: int) -> int:
    return (int(hi) << 64) | (int(lo) & _MASK64)


def pack(values) -> np.ndarray:
    """iterable of python ints → (n, 2) int64 [hi, lo] array."""
    out = np.zeros((len(values), 2), np.int64)
    for i, v in enumerate(values):
        out[i] = int_to_limbs(int(v))
    return out


def unpack(arr) -> list:
    """(n, 2) int64 [hi, lo] array → python ints."""
    return [limbs_to_int(h, l) for h, l in np.asarray(arr).tolist()]


def limbs_of(data: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of an [n, 2] carrier, or of an [n] int64 carrier widened."""
    if data.dim() == 2:
        return data[..., 0], data[..., 1]
    return from_int64(data)


def join(h: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """(hi, lo) → the [n, 2] carrier."""
    h, l = torch.broadcast_tensors(h, l)
    return torch.stack([h, l], -1)


def const(v: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A python int as 0-d (hi, lo) tensors."""
    h, l = int_to_limbs(v)
    return (torch.tensor(h, dtype=torch.int64, device=device),
            torch.tensor(l, dtype=torch.int64, device=device))


# ---------------------------------------------------------------------------
# limb primitives (the reference's, in torch)
# ---------------------------------------------------------------------------


def _ult(x, y):
    """unsigned x < y on int64 bit patterns."""
    return (x ^ _MIN) < (y ^ _MIN)


def add128(ah, al, bh, bl):
    """(hi, lo) + (hi, lo) with wraparound; returns (hi, lo,
    signed_overflow)."""
    lo = al + bl  # two's-complement wrap == mod 2^64
    carry = _ult(lo, al).to(torch.int64)
    hi = ah + bh + carry
    # signed 128 overflow: same-sign operands, different-sign result
    ovf = ((ah >= 0) == (bh >= 0)) & ((hi >= 0) != (ah >= 0))
    return hi, lo, ovf


def neg128(h, l):
    lo = -l
    hi = ~h + (l == 0).to(torch.int64)
    return hi, lo


def sub128(ah, al, bh, bl):
    nh, nl = neg128(bh, bl)
    return add128(ah, al, nh, nl)


def _umul64(a, b):
    """unsigned 64x64 → (hi64, lo64) via 32-bit halves (int64 bit
    patterns)."""
    a_lo = a & _MASK32
    a_hi = (a >> 32) & _MASK32
    b_lo = b & _MASK32
    b_hi = (b >> 32) & _MASK32
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    mid = ((ll >> 32) & _MASK32) + (lh & _MASK32) + (hl & _MASK32)
    lo = (ll & _MASK32) | (mid << 32)
    hi = hh + ((lh >> 32) & _MASK32) + ((hl >> 32) & _MASK32) + \
        ((mid >> 32) & _MASK32)
    return hi, lo


def _magnitude(h, l):
    neg = h < 0
    nh, nl = neg128(h, l)
    return torch.where(neg, nh, h), torch.where(neg, nl, l), neg


def mul128(ah, al, bh, bl):
    """128x128 → 128 with overflow detection. Sign-magnitude: negate to
    magnitudes, multiply unsigned, re-apply the sign."""
    mah, mal, a_neg = _magnitude(ah, al)
    mbh, mbl, b_neg = _magnitude(bh, bl)
    # |a| = mah*2^64 + u(mal); |b| = mbh*2^64 + u(mbl); magnitudes < 2^127
    # so mah/mbh are non-negative
    p_hi, p_lo = _umul64(mal, mbl)
    c1_hi, c1_lo = _umul64(mal, mbh)
    c2_hi, c2_lo = _umul64(mah, mbl)
    hi = p_hi + c1_lo
    ovf = _ult(hi, p_hi)  # carry out of bit 127 of the magnitude
    hi2 = hi + c2_lo
    ovf = ovf | _ult(hi2, hi)
    ovf = ovf | ((mah != 0) & (mbh != 0)) | (c1_hi != 0) | (c2_hi != 0)
    # magnitude must fit 127 bits (sign bit clear)
    ovf = ovf | (hi2 < 0)
    out_neg = a_neg != b_neg
    nh, nl = neg128(hi2, p_lo)
    rh = torch.where(out_neg, nh, hi2)
    rl = torch.where(out_neg, nl, p_lo)
    return rh, rl, ovf


def cmp128(ah, al, bh, bl):
    """-1 / 0 / +1 like a signed 128-bit compare."""
    lt = (ah < bh) | ((ah == bh) & _ult(al, bl))
    gt = (ah > bh) | ((ah == bh) & _ult(bl, al))
    one = torch.ones((), dtype=torch.int32, device=lt.device)
    return torch.where(lt, -one, torch.where(gt, one, torch.zeros_like(one)))


def abs_exceeds(h, l, bound: int):
    """|value| > bound (python int bound < 2^127), elementwise."""
    bh, bl = int_to_limbs(bound)
    mh, ml, _ = _magnitude(h, l)
    blt = torch.tensor(bl, dtype=torch.int64, device=ml.device)
    return (mh > bh) | ((mh == bh) & _ult(blt, ml))


def from_int64(v):
    """int64 vector → limb pair (sign-extended)."""
    v = v.to(torch.int64)
    return v >> 63, v


def precision_overflow(h, l, precision: int):
    """Spark decimal overflow: |v| >= 10^precision (unscaled)."""
    return abs_exceeds(h, l, 10 ** precision - 1)


# ---------------------------------------------------------------------------
# the port's own: division by a small divisor, rescaling, segmented sums
# ---------------------------------------------------------------------------


def divmod_small(mh, ml, d):
    """Non-negative 128-bit (mh, ml) ÷ d, 0 < d < 2^31 (an int or an int64
    tensor): (quotient hi, lo, remainder), by long division over four
    32-bit digits. Each step divides r·2^32 + digit, under 2^63 since
    r < d < 2^31, so int64 holds it."""
    digits = [(mh >> 32) & _MASK32, mh & _MASK32, (ml >> 32) & _MASK32,
              ml & _MASK32]
    r = torch.zeros_like(mh)
    q = []
    for dig in digits:
        cur = (r << 32) | dig
        qd = torch.div(cur, d, rounding_mode="floor")
        r = cur - qd * d
        q.append(qd)
    return (q[0] << 32) | q[1], (q[2] << 32) | q[3], r


def _pow10_steps(k: int):
    """10^k as factors of at most 10^9 (each under 2^31)."""
    while k > 0:
        step = min(k, 9)
        yield 10 ** step
        k -= step


def rescale_down(h, l, k: int):
    """HALF_UP division by 10^k (k >= 1): Spark's ``changePrecision`` to
    k fewer digits. A tie rounds away from zero, so the magnitude is
    truncated by 10^(k-1), then its last digit decides."""
    mh, ml, neg = _magnitude(h, l)
    for f in _pow10_steps(k - 1):
        mh, ml, _ = divmod_small(mh, ml, f)
    mh, ml, digit = divmod_small(mh, ml, 10)
    up = (digit >= 5).to(torch.int64)
    mh, ml, _ = add128(mh, ml, torch.zeros_like(mh), up)
    nh, nl = neg128(mh, ml)
    return torch.where(neg, nh, mh), torch.where(neg, nl, ml)


def rescale_trunc(h, l, k: int):
    """Division by 10^k toward zero (Spark's ``Decimal.toLong``)."""
    mh, ml, neg = _magnitude(h, l)
    for f in _pow10_steps(k):
        mh, ml, _ = divmod_small(mh, ml, f)
    nh, nl = neg128(mh, ml)
    return torch.where(neg, nh, mh), torch.where(neg, nl, ml)


def rescale_up(h, l, k: int):
    """Multiply by 10^k: (hi, lo, overflow past 2^127)."""
    if k <= 0:
        return h, l, torch.zeros_like(h, dtype=torch.bool)
    ch, cl = const(10 ** k, h.device)
    return mul128(h, l, ch, cl)


def div_half_up(h, l, d, extra: int):
    """HALF_UP((h, l) · 10^extra / d) for an int64 tensor d of positive
    divisors under 2^31 (``avg``'s sum over its count at a finer scale):
    (hi, lo, overflow). The integer quotient first, then the remainder's
    ``extra`` digits by long division in steps of at most nine digits,
    then the last remainder rounds."""
    mh, ml, neg = _magnitude(h, l)
    qh, ql, r = divmod_small(mh, ml, d)
    ovf = torch.zeros_like(neg)
    for f in _pow10_steps(extra):
        t = r * f  # r < 2^31, f <= 10^9: under 2^61
        qd = torch.div(t, d, rounding_mode="floor")
        r = t - qd * d
        fh, fl = const(f, h.device)
        qh, ql, o1 = mul128(qh, ql, fh, fl)
        qh, ql, o2 = add128(qh, ql, torch.zeros_like(qh), qd)
        ovf = ovf | o1 | o2
    up = (2 * r >= d).to(torch.int64)
    qh, ql, o3 = add128(qh, ql, torch.zeros_like(qh), up)
    ovf = ovf | o3 | (qh < 0)
    nh, nl = neg128(qh, ql)
    return torch.where(neg, nh, qh), torch.where(neg, nl, ql), ovf


def round_pow10(h, l, k: int, mode: str):
    """(h, l) / 10^k (k >= 1) rounded to an integer: ``half_up`` (ties
    away from zero, Spark's ``round``), ``half_even`` (``bround``),
    ``floor`` or ``ceil``. The magnitude is truncated by 10^(k-1) in steps
    of at most nine digits (a sticky flag keeps whether any dropped digit
    was non-zero), then its last digit and the flag decide."""
    mh, ml, neg = _magnitude(h, l)
    sticky = torch.zeros_like(neg)
    for f in _pow10_steps(k - 1):
        mh, ml, r = divmod_small(mh, ml, f)
        sticky = sticky | (r != 0)
    mh, ml, digit = divmod_small(mh, ml, 10)
    if mode == "half_up":
        up = digit >= 5
    elif mode == "half_even":
        up = (digit > 5) | ((digit == 5) & (sticky | ((ml & 1) == 1)))
    else:
        inexact = sticky | (digit != 0)
        up = inexact & (neg if mode == "floor" else ~neg)
    mh, ml, _ = add128(mh, ml, torch.zeros_like(mh), up.to(torch.int64))
    nh, nl = neg128(mh, ml)
    return torch.where(neg, nh, mh), torch.where(neg, nl, ml)


# ---------------------------------------------------------------------------
# 128 ÷ 128 bits (unsigned): ``/``, ``%`` and ``pmod`` of decimals
# ---------------------------------------------------------------------------


def _bits_of(h, l, start: int, width: int):
    """Bits [start, start + width) of the non-negative (h, l), width <= 62,
    as an int64."""
    mask = (1 << width) - 1
    if start >= 64:
        return (h >> (start - 64)) & mask
    if start + width <= 64:
        return (l >> start) & mask
    low = (l >> start) & ((1 << (64 - start)) - 1)
    return low | ((h & ((1 << (start + width - 64)) - 1)) << (64 - start))


def _place(qh, ql, v, start: int):
    """(qh, ql) with the non-negative int64 ``v`` (< 2^62) or-ed in at bit
    ``start`` (its bits past 127 dropped: the caller's quotient has
    none)."""
    if start >= 64:
        return qh | (v << (start - 64)), ql
    ql = ql | (v << start)  # the bits past 63 drop out of the low limb
    if start > 0:  # and reach the high limb
        qh = qh | (v >> (64 - start))
    return qh, ql


def _ult128(ah, al, bh, bl):
    """unsigned 128-bit a < b (each limb an unsigned bit pattern)."""
    return _ult(ah, bh) | ((ah == bh) & _ult(al, bl))


def divmod128(nh, nl, dh, dl, n_bits: int = 127, d_bits: int = 127):
    """Unsigned N ÷ D for 0 <= N < 2^n_bits and 0 < D < 2^d_bits (static
    bounds from the operands' types, each at most 127): (quotient hi, lo,
    remainder hi, lo).

    When the divisor fits 62 bits, long division over k-bit digits of N,
    k = 63 − d_bits: each step divides r·2^k + digit (under 2^63, since
    r < D) by D in int64, about eight ops a digit; the first digit, while
    r is 0, takes up to 62 bits. Past 62 bits, restoring division a bit
    at a time with a two-limb remainder (n_bits steps)."""
    zero = torch.zeros_like(nh)
    if d_bits <= 62:
        k = 63 - d_bits
        qh, ql, r = zero, zero, zero
        pos, w = n_bits, min(62, n_bits)  # the first digit: r is 0
        while pos > 0:
            pos -= w
            cur = (r << w) | _bits_of(nh, nl, pos, w)
            qd = torch.div(cur, dl, rounding_mode="floor")
            r = cur - qd * dl
            qh, ql = _place(qh, ql, qd, pos)
            w = min(k, pos)
        return qh, ql, zero, r
    rh, rl, qh, ql = zero, zero, zero, zero
    for i in range(n_bits - 1, -1, -1):
        bit = _bits_of(nh, nl, i, 1)
        rh = (rh << 1) | ((rl >> 63) & 1)
        rl = (rl << 1) | bit
        ge = ~_ult128(rh, rl, dh, dl)
        sh, sl, _ = sub128(rh, rl, dh, dl)
        rh, rl = torch.where(ge, sh, rh), torch.where(ge, sl, rl)
        qh, ql = _place(qh, ql, ge.to(torch.int64), i)
    return qh, ql, rh, rl


def segment_words128(h, l, int_sum: Callable[[torch.Tensor], torch.Tensor]
                     ) -> torch.Tensor:
    """Each 128-bit value's four 32-bit words (low first, the top one
    signed) summed by ``int_sum`` (the caller's exact int64 segment
    reduction): ``[4, segments]`` int64. Word sums of parts add, so
    partial sums merge by addition; exact while all parts together hold
    under 2^31 rows."""
    return torch.stack([int_sum(l & _MASK32), int_sum((l >> 32) & _MASK32),
                        int_sum(h & _MASK32), int_sum(h >> 32)])


def carry_words128(w: torch.Tensor):
    """Summed words (``segment_words128``) as 128-bit values, one carry
    pass: (hi, lo, overflow past 2^127)."""
    out, carry = [], torch.zeros_like(w[0])
    for s in w[:3]:
        t = s + carry
        out.append(t & _MASK32)
        carry = t >> 32
    top = w[3] + carry
    ovf = (top >= 2 ** 31) | (top < -2 ** 31)
    hi = (top << 32) | out[2]
    lo = (out[1] << 32) | out[0]
    return hi, lo, ovf


def segment_sum128(h, l, int_sum: Callable[[torch.Tensor], torch.Tensor]):
    """Sum of 128-bit values by segments (``segment_words128``, then
    ``carry_words128``): (hi, lo, overflow past 2^127). Exact while a
    segment holds under 2^31 rows."""
    return carry_words128(segment_words128(h, l, int_sum))
