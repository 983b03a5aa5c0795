"""Time zone transition tables as tensors (port of
``spark_rapids_tpu/tzdb.py``).

The tables come straight from the system TZif files (RFC 8536): one
sorted vector of transition instants and one of UTC offsets, and a
conversion is a ``torch.searchsorted`` plus a gather on the batch's
device (the reference's GpuTimeZoneDB loads java.time's rules into
device tables the same way). Each device gets one copy of a zone's
tables, made on first use.

Semantics match java.time's resolution (what Spark uses):

* UTC → local: the offset of the interval that holds the instant;
* local → UTC: an ambiguous wall time (a fall-back overlap) takes the
  EARLIER offset; a skipped wall time (a spring-forward gap) resolves with
  the offset before the transition, which moves it forward by the gap.

Past the file's last explicit transition the zone follows its TZif v2+
footer, the POSIX TZ rule (``PST8PDT,M3.2.0,M11.1.0``): its transitions
are generated through 2200 and appended to the table, as java.time's
last rules extend a zone. A "slim" TZif file (explicit transitions only
until the rule takes over) therefore gives the same answers as a "fat"
one. The reference takes the final offset there (ROADMAP C-ref-34).
"""

from __future__ import annotations

import datetime
import os
import re
import struct
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

MICROS = 1_000_000
_TZDIRS = ("/usr/share/zoneinfo", "/usr/lib/zoneinfo", "/etc/zoneinfo")

_UTC_NAMES = {"UTC", "GMT", "Etc/UTC", "Etc/GMT", "Z", "+00:00", "UTC+00:00"}


def is_utc(tz: Optional[str]) -> bool:
    return tz is None or tz in _UTC_NAMES


def _parse_tzif(raw: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """TZif bytes → (transition instants [s] of length n, offsets [s] of
    length n + 1; offsets[0] holds before the first transition), the
    footer's rule appended."""

    def parse_block(buf, off, time_size, time_fmt):
        (isutcnt, isstdcnt, leapcnt, timecnt, typecnt,
         charcnt) = struct.unpack_from(">6I", buf, off + 20)
        p = off + 44
        trans = np.frombuffer(buf, dtype=np.dtype(time_fmt).newbyteorder(">"),
                              count=timecnt, offset=p).astype(np.int64)
        p += timecnt * time_size
        idx = np.frombuffer(buf, dtype=np.uint8, count=timecnt, offset=p)
        p += timecnt
        utoffs = np.empty(typecnt, np.int64)
        for i in range(typecnt):
            utoffs[i] = struct.unpack_from(">iBB", buf, p + 6 * i)[0]
        p += typecnt * 6 + charcnt + leapcnt * (time_size + 4)
        p += isstdcnt + isutcnt
        return trans, idx, utoffs, p

    if raw[:4] != b"TZif":
        raise ValueError("not a TZif file")
    version = raw[4:5]
    trans, idx, utoffs, end = parse_block(raw, 0, 4, np.int32)
    footer = ""
    if version in (b"2", b"3", b"4") and raw[end:end + 4] == b"TZif":
        trans, idx, utoffs, end = parse_block(raw, end, 8, np.int64)
        footer = raw[end:].split(b"\n")[1].decode("ascii", "replace") \
            if raw[end:end + 1] == b"\n" else ""
    if len(trans) == 0:
        offsets = np.array([utoffs[0] if len(utoffs) else 0], np.int64)
    else:
        first = utoffs[idx[0]] if len(idx) else utoffs[0]
        offsets = np.concatenate([[first], utoffs[idx]]).astype(np.int64)
    rule = _posix_rule(footer) if footer else None
    if rule is not None:
        last = int(trans[-1]) if len(trans) else -(1 << 62)
        more = [(t, o) for t, o in _rule_transitions(rule, last)
                if t > last]
        if more:
            trans = np.concatenate([trans, [t for t, _ in more]])
            offsets = np.concatenate([offsets, [o for _, o in more]])
    return trans.astype(np.int64), offsets.astype(np.int64)


_NAME = r"(?:<[^>]*>|[A-Za-z]{3,})"
_OFF = r"[+-]?\d{1,3}(?::\d{1,2}){0,2}"
_WHEN = r"(?:M\d{1,2}\.\d\.\d|J\d{1,3}|\d{1,3})(?:/" + _OFF + ")?"
_RULE_RE = re.compile(rf"^({_NAME})({_OFF})(?:({_NAME})({_OFF})?"
                      rf"(?:,({_WHEN}),({_WHEN}))?)?$")


def _seconds(text: str) -> int:
    sign = -1 if text.startswith("-") else 1
    parts = [int(x) for x in text.lstrip("+-").split(":")]
    parts += [0] * (3 - len(parts))
    return sign * (parts[0] * 3600 + parts[1] * 60 + parts[2])


def _posix_rule(footer: str):
    """A POSIX TZ string → (std UTC offset, dst UTC offset, start, end), the
    rule days as (kind, a, b, c) with their local time of day; None for a
    zone without daylight time or a string this parser does not read."""
    m = _RULE_RE.match(footer.strip())
    if m is None or m.group(3) is None or m.group(5) is None:
        return None
    std = -_seconds(m.group(2))
    dst = -_seconds(m.group(4)) if m.group(4) else std + 3600

    def when(text):
        day, _, at = text.partition("/")
        secs = _seconds(at) if at else 7200
        if day.startswith("M"):
            mo, wk, wd = (int(x) for x in day[1:].split("."))
            return ("M", mo, wk, wd, secs)
        if day.startswith("J"):
            return ("J", int(day[1:]), 0, 0, secs)
        return ("N", int(day), 0, 0, secs)
    return std, dst, when(m.group(5)), when(m.group(6))


def _rule_day(year: int, w) -> datetime.date:
    kind, a, b, c, _ = w
    if kind == "J":  # 1..365, February 29 never counted
        d = datetime.date(year, 1, 1) + datetime.timedelta(days=a - 1)
        leap = year % 4 == 0 and (year % 100 != 0 or year % 400 == 0)
        return d + datetime.timedelta(days=1) if leap and a >= 60 else d
    if kind == "N":  # 0..365
        return datetime.date(year, 1, 1) + datetime.timedelta(days=a)
    first = datetime.date(year, a, 1)  # Mm.w.d: week w (5 = last) of m
    d = first + datetime.timedelta(days=(c - (first.weekday() + 1) % 7) % 7)
    d += datetime.timedelta(weeks=b - 1)
    while d.month != a:
        d -= datetime.timedelta(weeks=1)
    return d


def _rule_transitions(rule, after: int, until_year: int = 2200):
    """(instant [s], offset after it) of the rule's transitions from the
    year of ``after`` through ``until_year``, in order."""
    std, dst, start, end = rule
    epoch = datetime.date(1970, 1, 1)
    first = 1970 if after < 0 else \
        (epoch + datetime.timedelta(seconds=after)).year
    out = []
    for year in range(first, until_year + 1):
        for w, before, now in ((start, std, dst), (end, dst, std)):
            local = (_rule_day(year, w) - epoch).days * 86400 + w[4]
            out.append((local - before, now))
    return sorted(out)


def zone_table(tz: Optional[str]) -> Optional["TimeZoneDB"]:
    """The zone's table, or None for UTC (raises for a zone without a
    TZif file)."""
    return None if is_utc(tz) else TimeZoneDB.require(tz)


class TimeZoneDB:
    """One zone's transition table: numpy on the host, a tensor copy per
    device made on first use."""

    _cache: Dict[str, Optional["TimeZoneDB"]] = {}
    _lock = threading.Lock()

    def __init__(self, name: str, trans_s: np.ndarray, offsets_s: np.ndarray):
        self.name = name
        self.trans_micros = trans_s * MICROS
        self.offsets_micros = offsets_s * MICROS
        if len(trans_s):
            # wall-clock start of interval i >= 1, and end of interval i - 1
            self.local_starts_micros = (trans_s + offsets_s[1:]) * MICROS
            self.prev_local_ends_micros = (trans_s + offsets_s[:-1]) * MICROS
        else:
            self.local_starts_micros = np.zeros(0, np.int64)
            self.prev_local_ends_micros = np.zeros(0, np.int64)
        self._tensors: Dict[str, Tuple[torch.Tensor, ...]] = {}

    @classmethod
    def get(cls, tz: Optional[str]) -> Optional["TimeZoneDB"]:
        """The zone's table (cached); None when no TZif file names it."""
        if tz is None:
            return None
        with cls._lock:
            if tz in cls._cache:
                return cls._cache[tz]
            db = None
            if ".." not in tz.split("/") and not tz.startswith("/"):
                for d in _TZDIRS:
                    p = os.path.join(d, tz)
                    if os.path.isfile(p):
                        try:
                            with open(p, "rb") as f:
                                db = cls(tz, *_parse_tzif(f.read()))
                        except (OSError, ValueError, struct.error):
                            db = None
                        break
            cls._cache[tz] = db
            return db

    @classmethod
    def require(cls, tz: str) -> "TimeZoneDB":
        """The zone's table, or a clear error naming the zone (Spark's
        ZoneRulesException; never silently UTC)."""
        db = cls.get(tz)
        if db is None:
            raise ValueError(
                f"unknown session time zone {tz!r} "
                "(spark.sql.session.timeZone): no TZif file in "
                + ", ".join(_TZDIRS))
        return db

    @classmethod
    def clear_device_tables(cls) -> None:
        """Drop every zone's tensor copies (they are made again on use)."""
        with cls._lock:
            for db in cls._cache.values():
                if db is not None:
                    db._tensors.clear()

    def _on(self, device) -> Tuple[torch.Tensor, ...]:
        key = str(device)
        t = self._tensors.get(key)
        if t is None:
            t = tuple(torch.from_numpy(a.copy()).to(device)
                      for a in (self.trans_micros, self.offsets_micros,
                                self.local_starts_micros,
                                self.prev_local_ends_micros))
            self._tensors[key] = t
        return t

    # ---- tensor conversions (the card, or CPU tensors on the host) ----
    def utc_to_local(self, micros: torch.Tensor) -> torch.Tensor:
        """UTC micros → wall-clock micros in this zone."""
        micros = micros.to(torch.int64)
        if len(self.trans_micros) == 0:
            return micros + int(self.offsets_micros[0])
        trans, offs, _, _ = self._on(micros.device)
        k = torch.searchsorted(trans, micros, right=True)
        return micros + offs[k]

    def local_to_utc(self, local: torch.Tensor) -> torch.Tensor:
        """Wall-clock micros → UTC micros with java.time's gap and overlap
        rules."""
        local = local.to(torch.int64)
        if len(self.trans_micros) == 0:
            return local - int(self.offsets_micros[0])
        _, offs, starts, prev_ends = self._on(local.device)
        k = torch.searchsorted(starts, local, right=True)
        last = len(self.trans_micros) - 1
        # overlap: the wall time also lies in interval k - 1 → earlier offset
        amb = (k >= 1) & (local < prev_ends[(k - 1).clamp(0, last)])
        return local - offs[torch.where(amb, k - 1, k)]

    # ---- host mirrors (numpy) ----
    def utc_to_local_np(self, micros: np.ndarray) -> np.ndarray:
        if len(self.trans_micros) == 0:
            return micros + int(self.offsets_micros[0])
        k = np.searchsorted(self.trans_micros, micros, side="right")
        return micros + self.offsets_micros[k]

    def local_to_utc_np(self, local: np.ndarray) -> np.ndarray:
        if len(self.trans_micros) == 0:
            return local - int(self.offsets_micros[0])
        k = np.searchsorted(self.local_starts_micros, local, side="right")
        amb = (k >= 1) & (local < self.prev_local_ends_micros[
            np.clip(k - 1, 0, len(self.trans_micros) - 1)])
        return local - self.offsets_micros[np.where(amb, k - 1, k)]
