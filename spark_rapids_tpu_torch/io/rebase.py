"""Legacy parquet datetime rebase: hybrid Julian→proleptic Gregorian (a copy
of ``spark_rapids_tpu/io/rebase.py``, numpy only).

Reference: sql-plugin datetimeRebaseUtils.scala + GpuParquetScan.scala:446 —
files written by Spark 2.x (or 3.x in LEGACY mode) store dates/timestamps in
the hybrid Julian+Gregorian calendar; reading them as proleptic Gregorian
without correction silently shifts every value before 1582-10-15 (and some
around calendar-transition edges) by up to 10 days. Spark marks such files
with footer metadata keys `org.apache.spark.legacyDateTime` /
`org.apache.spark.legacyINT96`; the reader detects the marks and rewrites
values per file.

The day conversion: stored epoch-day → Julian Day Number → (if before the
Gregorian adoption JDN 2299161 = 1582-10-15) interpret as a Julian-calendar
(Y,M,D) and re-encode those civil fields as proleptic-Gregorian epoch days
(Howard Hinnant's days_from_civil). Values on/after the adoption date are
identical in both calendars and pass through. Timestamp rebase applies the
day correction to the UTC day component, keeping intra-day micros (the JVM
reference additionally models pre-1883 LMT zone offsets via the session
timezone — documented deviation, see SURVEY 'hard parts').
"""

from __future__ import annotations

from typing import Optional

import numpy as np

_EPOCH_JDN = 2440588          # JDN of 1970-01-01
_GREGORIAN_START_JDN = 2299161  # 1582-10-15 (first Gregorian day)
_GREGORIAN_START_DAYS = _GREGORIAN_START_JDN - _EPOCH_JDN
_US_PER_DAY = 86_400_000_000

LEGACY_DATETIME_KEY = b"org.apache.spark.legacyDateTime"
LEGACY_INT96_KEY = b"org.apache.spark.legacyINT96"


def julian_to_gregorian_days(days: np.ndarray) -> np.ndarray:
    """Vectorized hybrid→proleptic epoch-day rebase (identity on/after
    1582-10-15)."""
    days = np.asarray(days, np.int64)
    old = days < _GREGORIAN_START_DAYS
    if not old.any():
        return days
    jdn = days[old] + _EPOCH_JDN
    # JDN → Julian-calendar civil date (Richards' algorithm, Julian branch)
    c = jdn + 32082
    d = (4 * c + 3) // 1461
    e = c - (1461 * d) // 4
    m = (5 * e + 2) // 153
    day = e - (153 * m + 2) // 5 + 1
    month = m + 3 - 12 * (m // 10)
    year = d - 4800 + m // 10
    # civil fields → proleptic-Gregorian epoch days (days_from_civil)
    y = year - (month <= 2)
    era = np.where(y >= 0, y, y - 399) // 400
    yoe = y - era * 400
    mp = np.where(month > 2, month - 3, month + 9)
    doy = (153 * mp + 2) // 5 + day - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    out = days.copy()
    out[old] = era * 146097 + doe - 719468
    return out


def julian_to_gregorian_micros(micros: np.ndarray) -> np.ndarray:
    """Apply the day rebase to the UTC day component of epoch-micros."""
    micros = np.asarray(micros, np.int64)
    days = np.floor_divide(micros, _US_PER_DAY)
    intra = micros - days * _US_PER_DAY
    return julian_to_gregorian_days(days) * _US_PER_DAY + intra


def needs_rebase(kv_metadata: Optional[dict], mode: str) -> bool:
    """Spark semantics: a file carrying a legacy marker always rebases;
    unmarked files rebase only when the read mode forces LEGACY."""
    if kv_metadata and (LEGACY_DATETIME_KEY in kv_metadata
                       or LEGACY_INT96_KEY in kv_metadata):
        return True
    return str(mode).upper() == "LEGACY"


def rebase_scope(kv_metadata: Optional[dict], mode: str,
                 int96_cols=None, ts_cols=None):
    """(rebase_dates, rebase_timestamps): Spark scopes the two footer
    markers separately (datetimeRebaseUtils.scala) — legacyINT96 covers only
    the INT96-encoded timestamps, legacyDateTime covers dates AND
    non-INT96 timestamps.

    When the file's INT96 column names are known (`int96_cols` + the
    file's timestamp column names `ts_cols`), the second element is the
    exact SET of timestamp columns to rebase, so a legacyDateTime-only
    marker never touches an INT96 column written CORRECTED and vice
    versa. Without that knowledge, it degrades to a bool that
    conservatively covers all timestamps."""
    forced = str(mode).upper() == "LEGACY"
    has_dt = bool(kv_metadata) and LEGACY_DATETIME_KEY in kv_metadata
    has96 = bool(kv_metadata) and LEGACY_INT96_KEY in kv_metadata
    if int96_cols is None or ts_cols is None:
        return (has_dt or forced, has_dt or has96 or forced)
    sel = set()
    for name in ts_cols:
        if name in int96_cols:
            if has96 or forced:
                sel.add(name)
        elif has_dt or forced:
            sel.add(name)
    return (has_dt or forced, sel)


def rebase_table(table, rebase_dates: bool = True,
                 rebase_timestamps=True):
    """Rewrite date32/timestamp columns of an Arrow table from hybrid
    to proleptic values, per-type scoped. `rebase_timestamps` is a bool
    covering every timestamp column, or a set of column names (the
    per-physical-type scoping from rebase_scope). Nested types are left
    untouched (legacy writers of nested datetimes predate the cases this
    models)."""
    import pyarrow as pa

    def ts_selected(name) -> bool:
        if isinstance(rebase_timestamps, bool):
            return rebase_timestamps
        return name in rebase_timestamps

    out_cols = []
    changed = False
    for name, col in zip(table.column_names, table.columns):
        t = col.type
        if pa.types.is_date32(t) and rebase_dates:
            arr = col.combine_chunks() if isinstance(col, pa.ChunkedArray) \
                else col
            vals = np.asarray(arr.cast(pa.int32()).to_numpy(
                zero_copy_only=False), np.int64)
            fixed = julian_to_gregorian_days(vals).astype(np.int32)
            mask = arr.is_valid().to_numpy(zero_copy_only=False) \
                if arr.null_count else None
            out_cols.append(pa.array(fixed, pa.int32(),
                                     mask=~mask if mask is not None
                                     else None).cast(pa.date32()))
            changed = True
        elif pa.types.is_timestamp(t) and ts_selected(name):
            arr = col.combine_chunks() if isinstance(col, pa.ChunkedArray) \
                else col
            us = arr.cast(pa.timestamp("us", tz=t.tz))
            vals = np.asarray(us.cast(pa.int64()).to_numpy(
                zero_copy_only=False), np.int64)
            fixed = julian_to_gregorian_micros(vals)
            mask = arr.is_valid().to_numpy(zero_copy_only=False) \
                if arr.null_count else None
            out_cols.append(pa.array(fixed, pa.int64(),
                                     mask=~mask if mask is not None
                                     else None).cast(
                pa.timestamp("us", tz=t.tz)))
            changed = True
        else:
            out_cols.append(col)
    if not changed:
        return table
    return pa.Table.from_arrays(out_cols, names=table.column_names)
