"""Date and time expressions (port of
``spark_rapids_tpu/expressions/datetime.py``).

Carriers are Spark's: a date is int32 days since the epoch, a timestamp
int64 microseconds since the epoch in UTC. Fields come from Howard
Hinnant's civil-calendar integer algorithms (``civil_from_days``,
``days_from_civil``: the proleptic Gregorian calendar, floor division, so
days and micros before 1970 land in the right day), elementwise torch on
the batch's device. A timestamp is first moved to the session time zone's
wall clock (``spark.sql.session.timeZone``) through ``tzdb.TimeZoneDB``:
a ``searchsorted`` and a gather on the device. A zone without a TZif file
raises, naming the zone.

Formatting (``date_format``, ``from_unixtime``) of a pattern made only of
the fixed-width tokens ``yyyy MM dd HH mm ss`` and single-byte literals
runs on the card: each row's digits and literal bytes are assembled into
one byte matrix (``_assemble``). Any other pattern (``_pattern_tokens``:
runs of one Java letter, names of days and months, unpadded numbers,
fractions, zone offsets, quoted text), a year outside 1..9999 and every
string parse (``unix_timestamp``/``to_unix_timestamp`` of a string) take
the host hop: the wall-clock micros come down once, the same assembly
(with name tables) formats the column on the host, or pyarrow parses it,
and the batch counts in ``session.counters["datetime.hostPath"]``
(``datetime.hostPath.<class>.<reason>``). A week-based letter (``Y w W u
e c``) raises as in Spark 3. A parse pattern outside
``_java_to_strftime``'s set, or a non-literal pattern, is rejected for
the card when the expression is built, so the override engine keeps its
operator in the host engine and ``explain_fallback()`` names it.

Host evaluation (``eval_cpu``, the host engine's) runs this module's own
tensor code over CPU tensors read from the Arrow rows
(``base.eval_cpu_on_host_tensors``), so the host and the card give the
same answer by construction.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..columnar.vector import (TorchColumnVector, audited_device_get,
                               audited_sync_int, row_mask)
from ..types import (DataType, DateT, DateType, FractionalType, IntegerT,
                     LongT, StringT, StringType, TimestampT, TimestampType)
from .base import (_DEFAULT_CTX, Expression, Literal, UnaryExpression,
                   combine_validity, device_parts, eval_cpu_on_host_tensors,
                   make_column, to_column)

MICROS_PER_DAY = 86_400_000_000
MICROS_PER_SECOND = 1_000_000

HOST_PATH = "datetime.hostPath"


def host_path(ctx, expr, reason: str) -> None:
    """Count one batch of ``expr`` through the datetime host hop:
    ``datetime.hostPath`` and ``datetime.hostPath.<class>.<reason>``."""
    name = type(expr).__name__
    ctx.counters[HOST_PATH] += 1
    ctx.counters[f"{HOST_PATH}.{name}.{reason}"] += 1


def host_path_counts(counters) -> dict:
    """{(class, reason): batches} of the datetime host-path counters."""
    out = {}
    for k, v in counters.items():
        if k.startswith(HOST_PATH + ".") and v:
            name, _, reason = k[len(HOST_PATH) + 1:].partition(".")
            out[(name, reason)] = v
    return out


def _fdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def civil_from_days(z: torch.Tensor):
    """Days since the epoch → (year, month, day) as int64 tensors."""
    z = z.to(torch.int64) + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    return y + (m <= 2).to(torch.int64), m, d


def days_from_civil(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor
                    ) -> torch.Tensor:
    """(year, month, day) → days since the epoch (int64)."""
    m = m.to(torch.int64)
    y = y.to(torch.int64) - (m <= 2).to(torch.int64)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _fdiv(153 * mp + 2, 5) + d.to(torch.int64) - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def session_zone(ctx):
    """The session's zone table, or None for UTC (raises for a zone
    without a TZif file)."""
    from ..tzdb import zone_table
    return zone_table(getattr(ctx, "tz", None))


def local_micros(d: torch.Tensor, dtype: DataType, ctx) -> torch.Tensor:
    """A date or timestamp column's values as wall-clock micros in the
    session zone (a date is its local midnight)."""
    if isinstance(dtype, TimestampType):
        db = session_zone(ctx)
        d = d.to(torch.int64)
        return d if db is None else db.utc_to_local(d)
    return d.to(torch.int64) * MICROS_PER_DAY


def days_of(d: torch.Tensor, dtype: DataType, ctx) -> torch.Tensor:
    """A date or timestamp column as int64 days (a timestamp cast to a
    date in the session zone, as Spark casts it)."""
    if isinstance(dtype, TimestampType):
        return _fdiv(local_micros(d, dtype, ctx), MICROS_PER_DAY)
    return d.to(torch.int64)


# ---------------------------------------------------------------------------
# fields
# ---------------------------------------------------------------------------


class _DateField(UnaryExpression):
    """An int field of a date or timestamp (timestamps in the session
    zone)."""

    @property
    def dtype(self) -> DataType:
        return IntegerT

    def _field(self, days: torch.Tensor, local: torch.Tensor):
        raise NotImplementedError

    def _compute(self, d, ctx, valid):
        local = local_micros(d, self.child.dtype, ctx)
        return self._field(_fdiv(local, MICROS_PER_DAY), local) \
            .to(torch.int32)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return eval_cpu_on_host_tensors(self, table, ctx)

    def pretty(self) -> str:
        return f"{type(self).__name__.lower()}({self.child.pretty()})"


class Year(_DateField):
    def _field(self, days, local):
        return civil_from_days(days)[0]


class Month(_DateField):
    def _field(self, days, local):
        return civil_from_days(days)[1]


class DayOfMonth(_DateField):
    def _field(self, days, local):
        return civil_from_days(days)[2]


class Quarter(_DateField):
    def _field(self, days, local):
        return _fdiv(civil_from_days(days)[1] - 1, 3) + 1


class DayOfWeek(_DateField):
    """1 = Sunday ... 7 = Saturday; 1970-01-01 was a Thursday."""

    def _field(self, days, local):
        return torch.remainder(days + 4, 7) + 1


class WeekDay(_DateField):
    """0 = Monday ... 6 = Sunday."""

    def _field(self, days, local):
        return torch.remainder(days + 3, 7)


class DayOfYear(_DateField):
    def _field(self, days, local):
        y, _, _ = civil_from_days(days)
        one = torch.ones_like(y)
        return days - days_from_civil(y, one, one) + 1


class WeekOfYear(_DateField):
    """ISO 8601 week number: the week of this week's Thursday."""

    def _field(self, days, local):
        thursday = days + (3 - torch.remainder(days + 3, 7))
        y, _, _ = civil_from_days(thursday)
        one = torch.ones_like(y)
        return _fdiv(thursday - days_from_civil(y, one, one), 7) + 1


class _TimeField(_DateField):
    @staticmethod
    def _tod(local):
        return local - _fdiv(local, MICROS_PER_DAY) * MICROS_PER_DAY


class Hour(_TimeField):
    def _field(self, days, local):
        return _fdiv(self._tod(local), 3_600_000_000)


class Minute(_TimeField):
    def _field(self, days, local):
        return torch.remainder(_fdiv(self._tod(local), 60_000_000), 60)


class Second(_TimeField):
    def _field(self, days, local):
        return torch.remainder(_fdiv(self._tod(local), MICROS_PER_SECOND),
                               60)


# ---------------------------------------------------------------------------
# date arithmetic
# ---------------------------------------------------------------------------


def _first_of_next_month(y, m):
    ny = torch.where(m == 12, y + 1, y)
    nm = torch.where(m == 12, torch.ones_like(m), m + 1)
    return days_from_civil(ny, nm, torch.ones_like(nm))


class LastDay(UnaryExpression):
    """The last day of the date's month."""

    @property
    def dtype(self) -> DataType:
        return DateT

    def _compute(self, d, ctx, valid):
        y, m, _ = civil_from_days(days_of(d, self.child.dtype, ctx))
        return (_first_of_next_month(y, m) - 1).to(torch.int32)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return eval_cpu_on_host_tensors(self, table, ctx)


class _DateBinary(Expression):
    """A function of a date and an integer (or a second date): null in,
    null out."""

    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    def _op(self, l, r, ctx):
        raise NotImplementedError

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        cap, dev = batch.capacity, batch.device
        ld, lv = device_parts(self.children[0].eval_device(batch, ctx), cap,
                              dev)
        rd, rv = device_parts(self.children[1].eval_device(batch, ctx), cap,
                              dev)
        l = torch.broadcast_to(ld, (cap,))
        r = torch.broadcast_to(rd, (cap,))
        valid = combine_validity(lv, rv, row_mask(batch.num_rows, cap, dev))
        if valid is not None:  # null slots stay clear of the arithmetic
            l = torch.where(valid, l, torch.zeros((), dtype=l.dtype,
                                                  device=dev))
            r = torch.where(valid, r, torch.zeros((), dtype=r.dtype,
                                                  device=dev))
        return make_column(self.dtype, self._op(l, r, ctx), valid,
                           batch.num_rows)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return eval_cpu_on_host_tensors(self, table, ctx)


class DateAdd(_DateBinary):
    """date_add(date, days) (``negate``: date_sub); int32 arithmetic
    wraps as Spark's."""

    def __init__(self, date: Expression, days: Expression,
                 negate: bool = False):
        super().__init__(date, days)
        self.negate = negate

    @property
    def dtype(self) -> DataType:
        return DateT

    def _op(self, l, r, ctx):
        days = days_of(l, self.children[0].dtype, ctx).to(torch.int32)
        delta = r.to(torch.int32)
        return days - delta if self.negate else days + delta

    def pretty(self) -> str:
        op = "date_sub" if self.negate else "date_add"
        return f"{op}({self.children[0].pretty()}, " \
            f"{self.children[1].pretty()})"


class DateSub(DateAdd):
    """date_sub(date, days)."""

    def __init__(self, date: Expression, days: Expression):
        super().__init__(date, days, negate=True)


class DateDiff(_DateBinary):
    """datediff(end, start) in days."""

    @property
    def dtype(self) -> DataType:
        return IntegerT

    def _op(self, l, r, ctx):
        return (days_of(l, self.children[0].dtype, ctx).to(torch.int32)
                - days_of(r, self.children[1].dtype, ctx).to(torch.int32))


class AddMonths(_DateBinary):
    """add_months(date, n): java.time's ``plusMonths``, the day clamped to
    the target month's last day."""

    @property
    def dtype(self) -> DataType:
        return DateT

    def _op(self, l, r, ctx):
        y, m, d = civil_from_days(days_of(l, self.children[0].dtype, ctx))
        total = y * 12 + (m - 1) + r.to(torch.int64)
        ny, nm = _fdiv(total, 12), torch.remainder(total, 12) + 1
        last = _first_of_next_month(ny, nm) - 1
        nd = torch.minimum(d, civil_from_days(last)[2])
        return days_from_civil(ny, nm, nd).to(torch.int32)


# ---------------------------------------------------------------------------
# epoch conversions
# ---------------------------------------------------------------------------


class UnixTimestampFromTs(UnaryExpression):
    """unix_timestamp(ts): seconds since the epoch (floor)."""

    @property
    def dtype(self) -> DataType:
        return LongT

    def _compute(self, d, ctx, valid):
        return _fdiv(d.to(torch.int64), MICROS_PER_SECOND)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return eval_cpu_on_host_tensors(self, table, ctx)


class ToUnixMicros(UnaryExpression):
    """unix_micros(ts)."""

    @property
    def dtype(self) -> DataType:
        return LongT

    def _compute(self, d, ctx, valid):
        return d.to(torch.int64)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return eval_cpu_on_host_tensors(self, table, ctx)


class _EpochToTimestamp(UnaryExpression):
    """seconds / millis / micros → timestamp. An integral input scales
    (wrapping as the reference's); a fractional one (``timestamp_seconds``
    only) is Spark's ``(long)(x * 10^6)``, null for NaN and infinities."""

    _scale = MICROS_PER_SECOND

    @property
    def dtype(self) -> DataType:
        return TimestampT

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        if not isinstance(self.child.dtype, FractionalType):
            return super().eval_device(batch, ctx)
        from .mathexprs import java_double_to_long
        cap, dev = batch.capacity, batch.device
        d, v = device_parts(self.child.eval_device(batch, ctx), cap, dev)
        x = torch.broadcast_to(d, (cap,)).to(torch.float64)
        valid = combine_validity(v, torch.isfinite(x),
                                 row_mask(batch.num_rows, cap, dev))
        return make_column(TimestampT,
                           java_double_to_long(x * float(self._scale)),
                           valid, batch.num_rows)

    def _compute(self, d, ctx, valid):
        return d.to(torch.int64) * self._scale

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return eval_cpu_on_host_tensors(self, table, ctx)

    def pretty(self) -> str:
        return f"{type(self).__name__.lower()}({self.child.pretty()})"


class SecondsToTimestamp(_EpochToTimestamp):
    _scale = MICROS_PER_SECOND


class MillisToTimestamp(_EpochToTimestamp):
    _scale = 1000


class MicrosToTimestamp(_EpochToTimestamp):
    _scale = 1


# ---------------------------------------------------------------------------
# formatting and parsing
# ---------------------------------------------------------------------------

_STRFTIME = {"yyyy": "%Y", "yy": "%y", "MMM": "%b", "MM": "%m", "dd": "%d",
             "HH": "%H", "mm": "%M", "ss": "%S", "EEEE": "%A", "EEE": "%a",
             "a": "%p"}
_TOKENS = ("yyyy", "EEEE", "MMM", "EEE", "yy", "MM", "dd", "HH", "mm", "ss",
           "a")


def _java_to_strftime(pattern: str) -> str:
    """A Java datetime pattern of the supported set → strftime. Quoted
    literals copy through; any other letter (``SSS``, ``D``, ...) raises
    ValueError, and the expression is kept off the card."""
    out = []
    i = 0
    while i < len(pattern):
        if pattern[i] == "'":
            if pattern.startswith("''", i):
                out.append("'")
                i += 2
                continue
            j = pattern.find("'", i + 1)
            if j < 0:
                raise ValueError("unterminated quote in datetime pattern")
            lit = pattern[i + 1: j]
            out.append(lit.replace("%", "%%") if lit else "'")
            i = j + 1
            continue
        tok = next((t for t in _TOKENS if pattern.startswith(t, i)), None)
        if tok is not None:
            out.append(_STRFTIME[tok])
            i += len(tok)
            continue
        ch = pattern[i]
        if ch.isalpha():
            raise ValueError(f"unsupported datetime pattern token: {ch}")
        out.append("%%" if ch == "%" else ch)
        i += 1
    return "".join(out)


def _pattern_error(fmt) -> Optional[str]:
    """Why the card cannot parse by this pattern argument, or None."""
    if not isinstance(fmt, Literal):
        return "a non-literal datetime pattern runs in the host engine"
    if fmt.value is None:
        return None
    try:
        _java_to_strftime(fmt.value)
    except ValueError as e:
        return f"datetime pattern {fmt.value!r}: {e}"
    return None


#: Spark 3 rejects the week-based letters (``DateTimeFormatterHelper``)
_WEEK_LETTERS = set("YwWuec")
#: the letters the formatter writes: Java's ``DateTimeFormatter`` fields
_FORMAT_LETTERS = set("GyMLdDQqEaHhKkmsSXxZ")
_DEVICE_FIELDS = {"yyyy", "MM", "dd", "HH", "mm", "ss"}
_MONTHS = ["January", "February", "March", "April", "May", "June", "July",
           "August", "September", "October", "November", "December"]
_DAYS = ["Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
         "Saturday", "Sunday"]
_NAMES = {
    "M3": [m[:3] for m in _MONTHS], "M4": _MONTHS,
    "M5": [m[0] for m in _MONTHS],
    "E3": [d[:3] for d in _DAYS], "E4": _DAYS, "E5": [d[0] for d in _DAYS],
    "a": ["AM", "PM"],
    "Q3": ["Q1", "Q2", "Q3", "Q4"],
    "Q4": ["1st quarter", "2nd quarter", "3rd quarter", "4th quarter"],
    "G3": ["AD"], "G4": ["Anno Domini"], "G5": ["A"]}


def _pattern_tokens(pattern: str):
    """A Java datetime pattern as [("f", run) | ("l", bytes)], a run being
    one letter repeated (``"MMMM"``). Quoted text copies through. A
    week-based letter raises ValueError, as Spark 3 does; a letter the
    port does not write (a zone name) raises NotImplementedError."""
    toks = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "'":
            if pattern.startswith("''", i):
                toks.append(("l", b"'"))
                i += 2
                continue
            j = pattern.find("'", i + 1)
            if j < 0:
                raise ValueError("unterminated quote in datetime pattern")
            lit = pattern[i + 1: j]
            toks.append(("l", lit.encode() if lit else b"'"))
            i = j + 1
            continue
        if not ch.isalpha():
            toks.append(("l", ch.encode()))
            i += 1
            continue
        if ch in _WEEK_LETTERS:
            raise ValueError(
                f"All week-based patterns are unsupported since Spark 3.0, "
                f"detected: {ch}, Please use the SQL function EXTRACT "
                "instead")
        if ch not in _FORMAT_LETTERS:
            raise NotImplementedError(
                f"datetime pattern letter {ch!r} not yet ported")
        j = i
        while j < len(pattern) and pattern[j] == ch:
            j += 1
        toks.append(("f", pattern[i:j]))
        i = j
    return toks


def _device_fmt_plan(fmt: Optional[str]):
    """The tokens of a pattern made only of ``yyyy MM dd HH mm ss`` and
    single-byte literals (the card's set, the reference's), else None (the
    host hop formats it)."""
    if fmt is None or "'" in fmt:
        return None
    toks = _pattern_tokens(fmt)
    ok = all((k == "f" and v in _DEVICE_FIELDS) or (k == "l" and len(v) == 1)
             for k, v in toks)
    return toks if ok and toks else None


def _needs_offset(toks) -> bool:
    return any(k == "f" and v[0] in "XxZ" for k, v in toks)


def _digits(v: torch.Tensor, width: int, min_width: int):
    """The decimal digits of non-negative ``v`` in ``width`` bytes, and a
    keep mask dropping leading zeros down to ``min_width`` digits (None
    when every byte stays)."""
    block = torch.stack([(torch.remainder(_fdiv(v, 10 ** (width - 1 - k)),
                                          10) + 48).to(torch.uint8)
                         for k in range(width)], dim=1)
    if min_width >= width:
        return block, None
    keep = torch.stack([v >= 10 ** (width - 1 - k)
                        if k < width - min_width else torch.ones_like(
                            v, dtype=torch.bool) for k in range(width)],
                       dim=1)
    return block, keep


def _named(names, index: torch.Tensor, dev):
    """Each row's name from a table (a byte block and its length mask)."""
    w = max(len(x) for x in names)
    table = torch.tensor([list(x.encode().ljust(w, b"\0")) for x in names],
                         dtype=torch.uint8, device=dev)
    lens = torch.tensor([len(x) for x in names], device=dev)
    keep = torch.arange(w, device=dev)[None, :] < lens[index][:, None]
    return table[index], keep


def _offset_block(off_s: torch.Tensor, letter: str, count: int):
    """A zone offset (seconds east of UTC) in Java's ``X``/``x``/``Z``
    forms of one to three letters: ±HH[mm] (one letter: the minutes only
    when not zero), ±HHMM, ±HH:MM; ``X`` writes Z for zero."""
    if count > 3:
        raise NotImplementedError(
            f"datetime pattern {letter * count!r} not yet ported")
    dev = off_s.device
    neg = off_s < 0
    a = torch.abs(off_s)
    hh, mm = _fdiv(a, 3600), torch.remainder(_fdiv(a, 60), 60)
    sign = torch.where(neg, ord("-"), ord("+")).to(torch.uint8)[:, None]
    parts = [sign, _digits(hh, 2, 2)[0]]
    keeps = [torch.ones_like(sign, dtype=torch.bool),
             torch.ones(a.shape[0], 2, dtype=torch.bool, device=dev)]
    if count == 3 and letter != "Z":
        parts.append(torch.full_like(sign, ord(":")))
        keeps.append(torch.ones_like(sign, dtype=torch.bool))
    parts.append(_digits(mm, 2, 2)[0])
    mkeep = (mm != 0)[:, None].expand(-1, 2) if count == 1 \
        and letter != "Z" else torch.ones(a.shape[0], 2, dtype=torch.bool,
                                          device=dev)
    keeps.append(mkeep)
    block, keep = torch.cat(parts, 1), torch.cat(keeps, 1)
    if letter == "X":  # "Z" alone for a zero offset
        zero = (off_s == 0)[:, None]
        block = torch.where(zero & (torch.arange(block.shape[1],
                                                 device=dev) == 0),
                            torch.full_like(block, ord("Z")), block)
        keep = torch.where(zero, torch.arange(block.shape[1], device=dev)
                           == 0, keep)
    return block, keep


def _field_block(run: str, f: dict, dev):
    """One pattern run's bytes: (block [n, W], keep mask or None)."""
    c, k = run[0], len(run)
    if c == "y":
        if k == 2:
            return _digits(torch.remainder(f["y"], 100), 2, 2)
        return _digits(f["y"], max(k, 4), k)
    if c in "ML":
        if k >= 3:
            return _named(_NAMES[f"M{min(k, 5)}"], f["mo"] - 1, dev)
        return _digits(f["mo"], 2, k)
    if c in "Qq":
        q = _fdiv(f["mo"] - 1, 3)
        if k >= 3:
            return _named(_NAMES[f"Q{min(k, 4)}"], q, dev)
        return _digits(q + 1, 2, k)
    if c == "E":
        return _named(_NAMES[f"E{max(min(k, 5), 3)}"], f["dow"], dev)
    if c == "a":
        return _named(_NAMES["a"], (f["hour"] >= 12).to(torch.int64), dev)
    if c == "G":
        return _named(_NAMES[f"G{max(min(k, 5), 3)}"],
                      torch.zeros_like(f["y"]), dev)
    if c == "S":
        frac = f["frac"]  # micros into the second: the first k digits
        digits = frac * 10 ** (k - 6) if k >= 6 else _fdiv(frac,
                                                          10 ** (6 - k))
        return _digits(digits, k, k)
    if c in "XxZ":
        return _offset_block(f["off"], c, k)
    v = {"d": f["d"], "D": f["doy"], "H": f["hour"],
         "k": torch.where(f["hour"] == 0, 24, f["hour"]),
         "K": torch.remainder(f["hour"], 12),
         "h": torch.where(torch.remainder(f["hour"], 12) == 0, 12,
                          torch.remainder(f["hour"], 12)),
         "m": f["minute"], "s": f["sec"]}[c]
    return _digits(v, 3 if c == "D" else max(k, 2), k)


def _assemble(local: torch.Tensor, valid, n: int, cap: int, toks,
              offset: Optional[torch.Tensor] = None
              ) -> Optional[TorchColumnVector]:
    """Wall-clock micros → the formatted strings: one byte block a token
    (digits, a name from a table, an offset, literal bytes), the blocks
    side by side in a (cap, W) matrix; a field of varying width (an
    unpadded number, a name) masks its unused bytes out. ``offset`` is
    each row's zone offset in micros (for ``X``/``x``/``Z``). None when a
    valid row's year lies outside 1..9999 (Java widens ``yyyy`` there);
    that check is the one host read."""
    dev = local.device
    days = _fdiv(local, MICROS_PER_DAY)
    y, mo, d = civil_from_days(days)
    live = row_mask(n, cap, dev) if valid is None else valid
    if audited_sync_int(((y < 1) | (y > 9999))[live].any(), "scalar"):
        return None
    in_day = local - days * MICROS_PER_DAY
    secs = _fdiv(in_day, MICROS_PER_SECOND)
    f = {"y": y, "mo": mo, "d": d, "hour": _fdiv(secs, 3600),
         "minute": torch.remainder(_fdiv(secs, 60), 60),
         "sec": torch.remainder(secs, 60),
         "frac": in_day - secs * MICROS_PER_SECOND,
         "dow": torch.remainder(days + 3, 7),
         "doy": days - days_from_civil(y, torch.ones_like(mo),
                                       torch.ones_like(d)) + 1,
         "off": (torch.zeros_like(local) if offset is None
                 else _fdiv(offset, MICROS_PER_SECOND))}
    blocks, keeps = [], []
    for kind, v in toks:
        if kind == "l":
            word = torch.tensor(list(v), dtype=torch.uint8, device=dev)
            blocks.append(word.expand(cap, len(v)))
            keeps.append(None)
        else:
            b, k = _field_block(v, f, dev)
            blocks.append(b)
            keeps.append(k)
    mat = torch.cat(blocks, dim=1)[:n]
    width = mat.shape[1]
    if all(k is None for k in keeps):
        chars = mat.reshape(-1)
        offs = (torch.arange(cap + 1, dtype=torch.int64, device=dev)
                .clamp(max=n) * width).to(torch.int32)
        return TorchColumnVector(StringT, chars, valid, n, offsets=offs)
    keep = torch.cat([torch.ones(cap, b.shape[1], dtype=torch.bool,
                                 device=dev) if k is None else k
                      for b, k in zip(blocks, keeps)], dim=1)[:n]
    lens = keep.sum(1)
    offs = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    offs[1:n + 1] = torch.cumsum(lens, 0)
    offs[n + 1:] = offs[n]
    return TorchColumnVector(StringT, mat[keep], valid, n,
                             offsets=offs.to(torch.int32))


def _format_host(local: torch.Tensor, valid, n: int, toks, batch,
                 offset: Optional[torch.Tensor] = None) -> TorchColumnVector:
    """The host hop of a format: the wall-clock micros (and zone offsets)
    down once, the byte assembly on the host, the strings back up. Rows
    whose year lies outside 1..9999 (no Python calendar holds them) are
    null."""
    cap = batch.capacity
    loc, v, off = audited_device_get([local, valid, offset], "fetch")
    out = _assemble(loc, v, n, cap, toks, off)
    if out is None:
        y = civil_from_days(_fdiv(loc, MICROS_PER_DAY))[0]
        ok = (y >= 1) & (y <= 9999)
        v = ok if v is None else v & ok
        out = _assemble(torch.where(ok, loc, torch.zeros_like(loc)), v, n,
                        cap, toks, off)
    return TorchColumnVector(
        StringT, out.data.to(batch.device),
        None if out.validity is None else out.validity.to(batch.device), n,
        offsets=out.offsets.to(batch.device))


def _literal_fmt(e: Expression) -> Optional[str]:
    return e.value if isinstance(e, Literal) else None


class _Formatter(Expression):
    """A timestamp (or seconds, or a date) formatted by a literal Java
    pattern in the session zone."""

    def __init__(self, child: Expression, fmt: Expression):
        self.children = (child, fmt)

    @property
    def tpu_unsupported_reason(self) -> Optional[str]:
        if not isinstance(self.children[1], Literal):
            return "a non-literal datetime pattern runs in the host engine"
        return None

    @property
    def tpu_supported(self) -> bool:
        return self.tpu_unsupported_reason is None

    @property
    def dtype(self) -> DataType:
        return StringT

    def _local(self, d: torch.Tensor, ctx) -> torch.Tensor:
        raise NotImplementedError

    def _offset(self, d: torch.Tensor, local: torch.Tensor, ctx
                ) -> torch.Tensor:
        """Each row's zone offset in micros (local minus UTC)."""
        raise NotImplementedError

    def _eval(self, batch, ctx, count: bool):
        fmt = _literal_fmt(self.children[1])
        if not isinstance(self.children[1], Literal):
            raise NotImplementedError(
                f"{type(self).__name__} with a non-literal pattern runs in "
                "the host engine")
        cap, dev, n = batch.capacity, batch.device, batch.num_rows
        d, v = device_parts(self.children[0].eval_device(batch, ctx), cap,
                            dev)
        d = torch.broadcast_to(d, (cap,))
        valid = combine_validity(v, row_mask(n, cap, dev))
        if fmt is None:
            return TorchColumnVector.from_scalar(None, StringT, n, cap, dev)
        toks = _pattern_tokens(fmt)  # raises for a letter Spark rejects
        if valid is not None:
            d = torch.where(valid, d, torch.zeros((), dtype=d.dtype,
                                                  device=dev))
        local = self._local(d, ctx)
        if _device_fmt_plan(fmt) is not None:
            out = _assemble(local, valid, n, cap, toks)
            if out is not None:
                return out
            reason = "year outside 1..9999"
        else:
            reason = "pattern outside the device set"
        if count:
            host_path(ctx, self, reason)
        offset = self._offset(d, local, ctx) if _needs_offset(toks) \
            else None
        return _format_host(local, valid, n, toks, batch, offset)

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        return self._eval(batch, ctx, count=True)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        if not isinstance(self.children[1], Literal):
            return self._eval_rows(table, ctx)
        return eval_cpu_on_host_tensors(
            self, table, ctx,
            fn=lambda node, batch, c: node._eval(batch, c, count=False))

    def _eval_rows(self, table, ctx):
        """A pattern per row (a non-literal pattern): each row assembled
        on the host by its own pattern."""
        import pyarrow as pa
        from .base import arrow_column, arrow_numpy, is_arrow
        n = table.num_rows
        c = self.children[0].eval_cpu(table, ctx)
        f = self.children[1].eval_cpu(table, ctx)
        vals, null = arrow_numpy(c, n, self.children[0].dtype)
        fmts = arrow_column(f, n, StringT).to_pylist()
        local = self._local(torch.from_numpy(np.array(vals)), ctx)
        out = []
        for i in range(n):
            fmt = fmts[i]
            if fmt is None or null[i]:
                out.append(None)
                continue
            toks = _pattern_tokens(fmt)
            d = torch.from_numpy(np.array(vals[i:i + 1]))
            off = self._offset(d, local[i:i + 1], ctx) \
                if _needs_offset(toks) else None
            col = _assemble(local[i:i + 1], None, 1, 1, toks, off)
            out.append(None if col is None else col.to_pylist(None)[0])
        arr = pa.array(out, pa.string())
        return arr if (is_arrow(c) or is_arrow(f)) else arr[0].as_py()


class FromUnixTime(_Formatter):
    """from_unixtime(seconds, fmt = "yyyy-MM-dd HH:mm:ss") → string in the
    session zone."""

    def __init__(self, sec: Expression, fmt: Optional[Expression] = None):
        super().__init__(sec, fmt if fmt is not None
                         else Literal("yyyy-MM-dd HH:mm:ss"))

    def _local(self, d, ctx):
        micros = d.to(torch.int64) * MICROS_PER_SECOND
        db = session_zone(ctx)
        return micros if db is None else db.utc_to_local(micros)

    def _offset(self, d, local, ctx):
        return local - d.to(torch.int64) * MICROS_PER_SECOND

    def pretty(self) -> str:
        return f"from_unixtime({self.children[0].pretty()}, " \
            f"{self.children[1].pretty()})"


class DateFormatClass(_Formatter):
    """date_format(ts or date, fmt) → string in the session zone."""

    def _local(self, d, ctx):
        return local_micros(d, self.children[0].dtype, ctx)

    def _offset(self, d, local, ctx):
        if isinstance(self.children[0].dtype, TimestampType):
            return local - d.to(torch.int64)
        db = session_zone(ctx)  # a date: its local midnight's offset
        return torch.zeros_like(local) if db is None \
            else local - db.local_to_utc(local)

    def pretty(self) -> str:
        return f"date_format({self.children[0].pretty()}, " \
            f"{self.children[1].pretty()})"


def _parse_host(strings, fmt: str, ctx) -> "np.ndarray":
    """Strings of ``fmt`` (wall clock in the session zone) → (UTC epoch
    seconds, null mask): pyarrow parses the column, the zone table moves
    each wall time to UTC (java.time's gap and overlap rules)."""
    import pyarrow as pa
    import pyarrow.compute as pc
    parsed = pc.strptime(strings, format=_java_to_strftime(fmt), unit="s",
                         error_is_null=True)
    null = np.asarray(parsed.is_null()) if parsed.null_count else \
        np.zeros(len(parsed), np.bool_)
    secs = np.asarray(parsed.cast(pa.int64()).fill_null(0)
                      .to_numpy(zero_copy_only=False), np.int64)
    db = session_zone(ctx)
    if db is not None:
        secs = np.floor_divide(db.local_to_utc_np(secs * MICROS_PER_SECOND),
                               MICROS_PER_SECOND)
    return secs, null


class ToUnixTimestamp(Expression):
    """to_unix_timestamp(string | timestamp | date, fmt) → bigint seconds.
    Timestamps and dates (local midnight) on the device; strings parse in
    the host hop, unparseable rows null."""

    def __init__(self, child: Expression, fmt: Optional[Expression] = None):
        self.children = (child, fmt if fmt is not None
                         else Literal("yyyy-MM-dd HH:mm:ss"))

    @property
    def tpu_unsupported_reason(self) -> Optional[str]:
        """Only a string input reads the pattern."""
        child = self.children[0]
        if _resolved(child) and not isinstance(child.dtype, StringType):
            return None
        return _pattern_error(self.children[1])

    @property
    def tpu_supported(self) -> bool:
        return self.tpu_unsupported_reason is None

    @property
    def dtype(self) -> DataType:
        return LongT

    def _eval(self, batch, ctx, count: bool):
        src = self.children[0]
        cap, dev, n = batch.capacity, batch.device, batch.num_rows
        c = src.eval_device(batch, ctx)
        if isinstance(src.dtype, (TimestampType, DateType)):
            d, v = device_parts(c, cap, dev)
            d = torch.broadcast_to(d, (cap,)).to(torch.int64)
            valid = combine_validity(v, row_mask(n, cap, dev))
            if isinstance(src.dtype, DateType):
                db = session_zone(ctx)
                d = d * MICROS_PER_DAY
                d = d if db is None else db.local_to_utc(d)
            return make_column(LongT, _fdiv(d, MICROS_PER_SECOND), valid, n)
        if not isinstance(self.children[1], Literal):
            raise NotImplementedError(
                f"{type(self).__name__} with a non-literal pattern runs in "
                "the host engine")
        from ..columnar.vector import column_to_arrow
        fmt = _literal_fmt(self.children[1])
        if fmt is None:
            return TorchColumnVector.from_scalar(None, LongT, n, cap, dev)
        if count:
            host_path(ctx, self, "string parse")
        arr = column_to_arrow(to_column(c, batch, StringT))
        secs, null = _parse_host(arr, fmt, ctx)
        vals = np.zeros(cap, np.int64)
        vals[:n] = secs
        ok = np.zeros(cap, np.bool_)
        ok[:n] = ~null
        return make_column(LongT, torch.from_numpy(vals).to(dev),
                           torch.from_numpy(ok).to(dev), n)

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        return self._eval(batch, ctx, count=True)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        if not isinstance(self.children[1], Literal) \
                and isinstance(self.children[0].dtype, StringType):
            return self._eval_rows(table, ctx)
        return eval_cpu_on_host_tensors(
            self, table, ctx,
            fn=lambda node, batch, c: node._eval(batch, c, count=False))

    def _eval_rows(self, table, ctx):
        import pyarrow as pa
        from .base import arrow_column, is_arrow
        n = table.num_rows
        c = self.children[0].eval_cpu(table, ctx)
        f = self.children[1].eval_cpu(table, ctx)
        strs = arrow_column(c, n, StringT)
        fmts = arrow_column(f, n, StringT).to_pylist()
        out = []
        for i in range(n):
            try:
                if fmts[i] is None or not strs[i].is_valid:
                    raise ValueError
                secs, null = _parse_host(strs.slice(i, 1), fmts[i], ctx)
                out.append(None if null[0] else int(secs[0]))
            except ValueError:
                out.append(None)
        arr = pa.array(out, pa.int64())
        return arr if (is_arrow(c) or is_arrow(f)) else arr[0].as_py()

    def pretty(self) -> str:
        return f"to_unix_timestamp({self.children[0].pretty()}, " \
            f"{self.children[1].pretty()})"


def _resolved(e: Expression) -> bool:
    try:
        e.dtype
    except (ValueError, NotImplementedError):
        return False
    return True


class UnixTimestamp(ToUnixTimestamp):
    """unix_timestamp(...): to_unix_timestamp's semantics."""

    def pretty(self) -> str:
        return f"unix_timestamp({self.children[0].pretty()}, " \
            f"{self.children[1].pretty()})"
