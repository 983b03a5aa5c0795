"""Date and time on the port held to the reference on the CPU: the zone
tables (``tzdb``), the 25 classes of ``expressions/datetime.py`` and the
session time zone (``spark.sql.session.timeZone``).

Each case runs the same seeded numpy rows through the reference's
``eval_tpu`` (JAX's CPU backend) and ``eval_cpu``, and through the port's
``eval_device`` and ``eval_cpu`` (``device="cpu"``), under UTC and the
zones with the edge cases: America/Los_Angeles (a gap and an overlap inside
the rows), Australia/Lord_Howe (a 30-minute DST), Asia/Kolkata (no DST)
and America/New_York. Integers, dates, timestamps, strings and null masks
are exact; no case here has a float result. One reference run a case and
zone; the tables are small.
"""

import collections
import datetime as dt
import functools
from zoneinfo import ZoneInfo

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu.functions as RF
import spark_rapids_tpu_torch.functions as TF
from spark_rapids_tpu import types as RT
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu.columnar.batch import TpuColumnarBatch
from spark_rapids_tpu.columnar.vector import TpuColumnVector
from spark_rapids_tpu.config import RapidsConf as RefConf
from spark_rapids_tpu.expressions import base as RB
from spark_rapids_tpu.expressions import datetime as RDT
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.tzdb import TimeZoneDB as RefTZ
from spark_rapids_tpu_torch.columnar.batch import TorchColumnarBatch
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.expressions import base as PB
from spark_rapids_tpu_torch.expressions import datetime as PDT
from spark_rapids_tpu_torch.memory.device import TorchDeviceManager
from spark_rapids_tpu_torch.serving.scheduler import QueryScheduler
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.tzdb import TimeZoneDB

TorchDeviceManager.initialize(device="cpu", total_bytes=8 << 30)

ZONES = ["UTC", "America/Los_Angeles", "Australia/Lord_Howe", "Asia/Kolkata",
         "America/New_York"]
UTC = dt.timezone.utc
N = 160


class _Ns:
    def __init__(self, base, dtm):
        self.Lit = base.Literal
        self.Attr = base.AttributeReference
        for k in dir(dtm):
            if not k.startswith("_"):
                setattr(self, k, getattr(dtm, k))


REF = _Ns(RB, RDT)
PORT = _Ns(PB, PDT)


def _la_transition_micros():
    """America/Los_Angeles's transitions 1960-2036 (seconds)."""
    db = TimeZoneDB.get("America/Los_Angeles")
    t = db.trans_micros // 1_000_000
    return t[(t > -315619200) & (t < 2082758400)]


@functools.lru_cache(maxsize=None)
def table() -> pa.Table:
    """Seeded rows: dates 1900-2100 with every 29 February in range,
    timestamps 1960-2036 (one in four within ±2 h of a Los Angeles
    transition, minutes aligned to the gap and overlap), day and month
    deltas, epoch seconds and their days (``dn``: inside the zone
    tables' range, 1960-2036), one row in ten null a column."""
    rng = np.random.default_rng(14)
    lo, hi = (dt.date(1900, 1, 1) - dt.date(1970, 1, 1)).days, \
        (dt.date(2100, 12, 31) - dt.date(1970, 1, 1)).days
    days = rng.integers(lo, hi, N)
    leap = [(dt.date(y, 2, 29) - dt.date(1970, 1, 1)).days
            for y in range(1904, 2100, 4)]
    days[:len(leap)] = leap
    trans = _la_transition_micros()
    secs = rng.integers(-315619200, 2082758400, N)
    near = rng.random(N) < 0.25
    pick = trans[rng.integers(0, len(trans), N)]
    secs = np.where(near, pick + rng.integers(-7200, 7200, N) // 60 * 60,
                    secs)
    micros = secs * 1_000_000 + rng.integers(0, 1_000_000, N)

    def nulls(k):
        return np.random.default_rng(100 + k).random(N) < 0.1

    def arr(v, t, k):
        return pa.array(v, t, mask=nulls(k))

    strs = [dt.datetime.fromtimestamp(int(s), UTC).strftime(
        "%Y-%m-%d %H:%M:%S") for s in secs]
    strs[:4] = ["bogus", "2024-03-10 02:30:00", "2024-11-03 01:30:00",
                "1970-01-01 00:00:00"]
    return pa.table({
        "d": arr(days.astype(np.int32), pa.int32(), 1).cast(pa.date32()),
        "d2": arr(np.roll(days, 7).astype(np.int32), pa.int32(), 2)
        .cast(pa.date32()),
        "ts": arr(micros, pa.int64(), 3).cast(pa.timestamp("us", tz="UTC")),
        "n": arr(rng.integers(-1000, 1000, N).astype(np.int32), pa.int32(),
                 4),
        "m": arr(rng.integers(-60, 60, N).astype(np.int32), pa.int32(), 5),
        "sec": arr(secs, pa.int64(), 6),
        "dn": arr((secs // 86400).astype(np.int32), pa.int32(), 8)
        .cast(pa.date32()),
        "s": arr(strs, pa.string(), 7),
    })


def _attrs(ns, types_mod, tbl):
    return {f.name: ns.Attr(f.name, types_mod.from_arrow(f.type), True,
                            ordinal=i) for i, f in enumerate(tbl.schema)}


def _norm(v):
    if isinstance(v, dt.datetime):
        v = v if v.tzinfo else v.replace(tzinfo=UTC)
        return ("ts", int((v - dt.datetime(1970, 1, 1, tzinfo=UTC))
                          / dt.timedelta(microseconds=1)))
    if isinstance(v, dt.date):
        return ("d", v.toordinal())
    return v


def _rows(x, n):
    if isinstance(x, (pa.Array, pa.ChunkedArray)):
        return [_norm(v) for v in x.to_pylist()]
    return [_norm(x.as_py() if isinstance(x, pa.Scalar) else x)] * n


@functools.lru_cache(maxsize=None)
def reference_rows(case: str, zone: str):
    """(eval_tpu rows, eval_cpu rows) of the reference."""
    tbl = table()
    a = _attrs(REF, RT, tbl)
    expr = CASES[case](REF, a)
    ctx = RB.EvalContext(RefConf({"spark.sql.session.timeZone": zone}))
    cols = [TpuColumnVector.from_arrow(c.combine_chunks())
            for c in tbl.columns]
    batch = TpuColumnarBatch(cols, tbl.num_rows, names=tbl.column_names)
    dev = expr.eval_tpu(batch, ctx)
    dev = dev.to_arrow()[:tbl.num_rows] if hasattr(dev, "to_arrow") \
        else dev.value
    return (_rows(dev, tbl.num_rows),
            _rows(expr.eval_cpu(tbl, ctx), tbl.num_rows))


def port_rows(case: str, zone: str):
    """(eval_device rows, eval_cpu rows, counters) of the port."""
    tbl = table()
    expr = CASES[case](PORT, _attrs(PORT, PT, tbl))
    conf = RapidsConf({"spark.sql.session.timeZone": zone})
    ctx = PB.EvalContext(conf, counters=collections.Counter())
    batch = TorchColumnarBatch.from_arrow(tbl)
    dev = PB.to_column(expr.eval_device(batch, ctx), batch, expr.dtype)
    host = expr.eval_cpu(tbl, PB.EvalContext(conf))
    return ([_norm(v) for v in dev.to_pylist()], _rows(host, N),
            ctx.counters)


CASES = {
    # date fields
    "year_d": lambda M, a: M.Year(a["d"]),
    "month_d": lambda M, a: M.Month(a["d"]),
    "dayofmonth_d": lambda M, a: M.DayOfMonth(a["d"]),
    "quarter_d": lambda M, a: M.Quarter(a["d"]),
    "dayofweek_d": lambda M, a: M.DayOfWeek(a["d"]),
    "weekday_d": lambda M, a: M.WeekDay(a["d"]),
    "dayofyear_d": lambda M, a: M.DayOfYear(a["d"]),
    "weekofyear_d": lambda M, a: M.WeekOfYear(a["d"]),
    "last_day": lambda M, a: M.LastDay(a["d"]),
    # timestamp fields in the session zone
    "year_ts": lambda M, a: M.Year(a["ts"]),
    "month_ts": lambda M, a: M.Month(a["ts"]),
    "dayofmonth_ts": lambda M, a: M.DayOfMonth(a["ts"]),
    "quarter_ts": lambda M, a: M.Quarter(a["ts"]),
    "dayofweek_ts": lambda M, a: M.DayOfWeek(a["ts"]),
    "weekday_ts": lambda M, a: M.WeekDay(a["ts"]),
    "dayofyear_ts": lambda M, a: M.DayOfYear(a["ts"]),
    "weekofyear_ts": lambda M, a: M.WeekOfYear(a["ts"]),
    "hour": lambda M, a: M.Hour(a["ts"]),
    "minute": lambda M, a: M.Minute(a["ts"]),
    "second": lambda M, a: M.Second(a["ts"]),
    # date arithmetic
    "date_add": lambda M, a: M.DateAdd(a["d"], a["n"]),
    "date_add_lit": lambda M, a: M.DateAdd(a["d"], M.Lit(10)),
    "date_sub": lambda M, a: M.DateSub(a["d"], M.Lit(30)),
    "datediff": lambda M, a: M.DateDiff(a["d"], a["d2"]),
    "add_months": lambda M, a: M.AddMonths(a["d"], a["m"]),
    # epoch conversions
    "unix_ts_from_ts": lambda M, a: M.UnixTimestampFromTs(a["ts"]),
    "to_unix_micros": lambda M, a: M.ToUnixMicros(a["ts"]),
    "seconds_to_ts": lambda M, a: M.SecondsToTimestamp(a["sec"]),
    "millis_to_ts": lambda M, a: M.MillisToTimestamp(a["sec"]),
    "micros_to_ts": lambda M, a: M.MicrosToTimestamp(a["sec"]),
    # formatting (device patterns, then host ones)
    "from_unixtime": lambda M, a: M.FromUnixTime(a["sec"]),
    "from_unixtime_slash": lambda M, a: M.FromUnixTime(
        a["sec"], M.Lit("yyyy/MM/dd")),
    "date_format_full": lambda M, a: M.DateFormatClass(
        a["ts"], M.Lit("yyyy-MM-dd HH:mm:ss")),
    "date_format_minutes": lambda M, a: M.DateFormatClass(
        a["ts"], M.Lit("yyyy-MM-dd'T'HH:mm")),
    "date_format_date": lambda M, a: M.DateFormatClass(
        a["d"], M.Lit("dd.MM.yyyy")),
    "date_format_names": lambda M, a: M.DateFormatClass(
        a["ts"], M.Lit("EEEE, dd MMM yy HH a")),
    "from_unixtime_names": lambda M, a: M.FromUnixTime(
        a["sec"], M.Lit("EEE MMM dd HH:mm:ss yyyy")),
    # parsing and to-epoch
    "to_unix_timestamp_str": lambda M, a: M.ToUnixTimestamp(a["s"]),
    "unix_timestamp_ts": lambda M, a: M.UnixTimestamp(a["ts"]),
    # local midnight → UTC: dates inside the zone tables' range
    "to_unix_timestamp_date": lambda M, a: M.ToUnixTimestamp(a["dn"]),
    "unix_timestamp_slash": lambda M, a: M.UnixTimestamp(
        M.FromUnixTime(a["sec"], M.Lit("yyyy/MM/dd HH:mm:ss")),
        M.Lit("yyyy/MM/dd HH:mm:ss")),
}
ZONE_FREE = {"year_d", "month_d", "dayofmonth_d", "quarter_d",
             "dayofweek_d", "weekday_d", "dayofyear_d", "weekofyear_d",
             "last_day", "date_add", "date_add_lit", "date_sub", "datediff",
             "add_months", "unix_ts_from_ts", "to_unix_micros",
             "seconds_to_ts", "millis_to_ts", "micros_to_ts",
             "unix_timestamp_ts", "date_format_date"}
HOST_HOP = {"date_format_names": "pattern outside the device set",
            "date_format_minutes": "pattern outside the device set",
            "from_unixtime_names": "pattern outside the device set",
            "to_unix_timestamp_str": "string parse",
            "unix_timestamp_slash": "string parse"}
PARAMS = [(c, z) for c in sorted(CASES)
          for z in (["UTC", "America/Los_Angeles"] if c in ZONE_FREE
                    else ZONES)]


@pytest.mark.parametrize("case,zone", PARAMS)
def test_datetime_matches_the_reference(case, zone):
    """Exact on both sides; the host hop counted where the class takes
    it, and nowhere else."""
    ref_dev, ref_cpu = reference_rows(case, zone)
    dev, host, counters = port_rows(case, zone)
    assert dev == host
    assert dev == ref_dev, [(i, x, y) for i, (x, y)
                            in enumerate(zip(dev, ref_dev)) if x != y][:5]
    assert dev == ref_cpu
    hops = PDT.host_path_counts(counters)
    if case in HOST_HOP:
        cls = type(CASES[case](PORT, _attrs(PORT, PT, table()))).__name__
        assert hops == {(cls, HOST_HOP[case]): 1}, hops
    else:
        assert not hops, hops


@pytest.mark.parametrize("zone", ZONES[1:])
def test_tzdb_matches_zoneinfo_and_the_reference(zone):
    """UTC → local over 1960-2036 equals zoneinfo's; local → UTC takes the
    earlier offset in an overlap and moves a gap forward, as java.time."""
    db, ref = TimeZoneDB.get(zone), RefTZ.get(zone)
    assert db is not None and ref is not None, f"no TZif file for {zone}"
    rng = np.random.default_rng(7)
    micros = rng.integers(-315619200, 2082758400, 400) * 1_000_000
    import torch
    local = db.utc_to_local(torch.from_numpy(micros)).numpy()
    assert (local == ref.utc_to_local_np(micros)).all()
    assert (local == db.utc_to_local_np(micros)).all()
    zi = ZoneInfo(zone)
    for m, l in zip(micros[:60], local[:60]):
        t = dt.datetime.fromtimestamp(m / 1e6, UTC).astimezone(zi)
        assert l == int((t.replace(tzinfo=None) - dt.datetime(1970, 1, 1))
                        / dt.timedelta(microseconds=1))
    walls = local + rng.integers(-3 * 3600, 3 * 3600, 400) * 1_000_000
    back = db.local_to_utc(torch.from_numpy(walls)).numpy()
    assert (back == ref.local_to_utc_np(walls)).all()
    for w, b in zip(walls[:60], back[:60]):
        naive = dt.datetime(1970, 1, 1) + dt.timedelta(microseconds=int(w))
        want = naive.replace(tzinfo=zi, fold=0).timestamp()
        assert b == int(round(want * 1e6)), (zone, naive)


def test_gap_and_overlap_in_los_angeles():
    """A skipped wall time moves forward by the gap; an ambiguous one
    takes the earlier (daylight) offset."""
    tbl = pa.table({"s": pa.array(["2024-03-10 02:30:00",
                                   "2024-11-03 01:30:00",
                                   "2024-06-01 12:00:00"])})
    ctx = PB.EvalContext(RapidsConf(
        {"spark.sql.session.timeZone": "America/Los_Angeles"}))
    expr = PDT.ToUnixTimestamp(PB.AttributeReference("s", PT.StringT,
                                                     ordinal=0))
    got = expr.eval_device(TorchColumnarBatch.from_arrow(tbl), ctx) \
        .to_pylist()
    assert got == [int(dt.datetime(2024, 3, 10, 10, 30, tzinfo=UTC)
                       .timestamp()),
                   int(dt.datetime(2024, 11, 3, 8, 30, tzinfo=UTC)
                       .timestamp()),
                   int(dt.datetime(2024, 6, 1, 19, 0, tzinfo=UTC)
                       .timestamp())]
    assert expr.eval_cpu(tbl, ctx).to_pylist() == got


def test_unknown_zone_raises_clearly():
    """A zone without a TZif file fails, naming the zone (never UTC)."""
    tbl = table()
    a = _attrs(PORT, PT, tbl)
    ctx = PB.EvalContext(RapidsConf({"spark.sql.session.timeZone":
                                     "Not/AZone"}))
    with pytest.raises(ValueError, match="Not/AZone"):
        PDT.Year(a["ts"]).eval_device(TorchColumnarBatch.from_arrow(tbl),
                                      ctx)
    with pytest.raises(ValueError, match="Not/AZone"):
        PDT.Hour(a["ts"]).eval_cpu(tbl, ctx)


def test_unsupported_patterns_stay_off_the_card():
    """A column pattern is not a literal: the override engine keeps the
    operator on the CPU and names the reason, and the host engine answers.
    ``SSS`` (outside the card's byte set) formats in the host hop with
    Spark's answer (the reference's is null, ROADMAP C-ref-46); the
    parser's pattern set still refuses it."""
    with pytest.raises(ValueError):
        PDT._java_to_strftime("HH:mm:ss.SSS")
    assert PDT._java_to_strftime("yyyy-MM-dd") == "%Y-%m-%d"
    s = TorchSession({}, device="cpu")
    df = s.createDataFrame([{"ts": dt.datetime(2024, 1, 2, 3, 4, 5,
                                               tzinfo=UTC),
                             "f": "yyyy"}])
    q = df.select(TF.date_format("ts", "HH:mm:ss.SSS").alias("a"))
    why = q.explain_fallback()
    assert "DateFormatClass is disabled on TPU" not in why, why
    assert q.collect() == [{"a": "03:04:05.000"}]
    q2 = df.select(TF.date_format(TF.col("ts"), TF.col("f")).alias("a"))
    assert "non-literal datetime pattern" in q2.explain_fallback()
    assert q2.collect() == [{"a": "2024"}]


# ---------------------------------------------------------------------------
# through the session, with the zone in the conf
# ---------------------------------------------------------------------------

BASE = {"spark.rapids.shuffle.mode": "ICI",
        "spark.sql.shuffle.partitions": "4"}


def _sessions(zone):
    conf = dict(BASE, **{"spark.sql.session.timeZone": zone})
    ref = TpuSession(dict(conf, **{"spark.rapids.sql.enabled": "false"}))
    port = TorchSession(dict(conf, **{"spark.rapids.sql.test.enabled":
                                      "true"}), device="cpu")
    return ref, port


def _query_rows():
    tbl = table()
    return [{k: v for k, v in r.items() if k in ("d", "ts", "n")}
            for r in tbl.to_pylist()]


QUERIES = {
    "date_fields": lambda F, df: df.select(
        F.year("d").alias("y"), F.month("d").alias("m"),
        F.dayofmonth("d").alias("dd"), F.quarter("d").alias("q"),
        F.dayofweek("d").alias("dow"), F.weekday("d").alias("wd"),
        F.dayofyear("d").alias("doy"), F.weekofyear("d").alias("woy")),
    "timestamp_fields": lambda F, df: df.select(
        F.year("ts").alias("y"), F.month("ts").alias("m"),
        F.dayofmonth("ts").alias("dd"), F.hour("ts").alias("h"),
        F.minute("ts").alias("mi"), F.second("ts").alias("s")),
    "date_arithmetic": lambda F, df: df.select(
        F.date_add(F.col("d"), F.col("n")).alias("added"),
        F.date_sub(F.col("d"), 30).alias("subbed"),
        F.datediff(F.col("d"), F.date_add(F.col("d"), 10)).alias("dd"),
        F.last_day("d").alias("ld"),
        F.add_months(F.col("d"), F.col("n") % 50).alias("am")),
    "unix_timestamp": lambda F, df: df.select(
        F.unix_timestamp(F.col("ts")).alias("ut")),
    "group_by_year": lambda F, df: df.groupBy(F.year("d").alias("y"))
    .agg(F.count(F.col("d")).alias("c")),
}


@pytest.mark.parametrize("zone", ["America/New_York", "Asia/Kolkata"])
@pytest.mark.parametrize("query", sorted(QUERIES))
def test_session_queries_match_the_reference(query, zone):
    """The shapes of ``tests/test_datetime.py``, with the session zone;
    the port in test mode (every operator on the card)."""
    ref, port = _sessions(zone)
    rows = _query_rows()
    want = QUERIES[query](RF, ref.createDataFrame(rows)).collect()
    got = QUERIES[query](TF, port.createDataFrame(rows)).collect()
    if query == "group_by_year":
        want, got = sorted(map(repr, want)), sorted(map(repr, got))
    assert [{k: _norm(v) for k, v in r.items()} for r in got] == \
        [{k: _norm(v) for k, v in r.items()} for r in want] \
        if query != "group_by_year" else got == want


def test_session_zone_reaches_each_exec_and_the_plan_cache():
    """``conf.set`` of the zone reaches every exec's EvalContext (the
    reference's shape: EST 1:59 then EDT 3:01), and a plan cached under
    one zone is not reused under another."""
    rows = [{"ts": dt.datetime(2024, 3, 10, 6, 59, tzinfo=UTC)},
            {"ts": dt.datetime(2024, 3, 10, 7, 1, tzinfo=UTC)},
            {"ts": None}]
    QueryScheduler.get().plan_cache.clear()
    s = TorchSession(dict(BASE, **{"spark.rapids.sql.test.enabled":
                                   "true"}), device="cpu")
    df = s.createDataFrame(rows)

    def q():
        return df.select(TF.hour("ts").alias("h"),
                         TF.dayofmonth("ts").alias("d")).collect()

    assert [r["h"] for r in q()] == [6, 7, None]
    s.conf.set("spark.sql.session.timeZone", "America/New_York")
    assert [r["h"] for r in q()] == [1, 3, None]
    assert s._last_plan_cache == "miss"
    assert [r["h"] for r in q()] == [1, 3, None]
    assert s._last_plan_cache == "hit"
    s.conf.set("spark.sql.session.timeZone", "Asia/Kolkata")
    assert [r["h"] for r in q()] == [12, 12, None]
    assert s._last_plan_cache == "miss"
    built = TorchSession.builder.config(
        "spark.sql.session.timeZone", "America/New_York").getOrCreate("cpu")
    assert built.conf.get("spark.sql.session.timeZone") == "America/New_York"


@pytest.mark.parametrize("zone", ["America/Los_Angeles",
                                  "Australia/Lord_Howe"])
def test_zone_rule_past_the_last_transition(zone):
    """Past the TZif file's explicit transitions the zone follows its
    footer's POSIX rule (java.time's last rules), as zoneinfo does; the
    reference takes the final offset there (C-ref-34)."""
    import torch
    db, ref, zi = TimeZoneDB.get(zone), RefTZ.get(zone), ZoneInfo(zone)
    instants = [dt.datetime(y, m, 15, 12, tzinfo=UTC)
                for y in (2039, 2040, 2077, 2150) for m in (1, 7)]
    micros = np.array([int(t.timestamp()) * 1_000_000 for t in instants])
    got = db.utc_to_local(torch.from_numpy(micros)).numpy()
    want = [int((t.astimezone(zi).replace(tzinfo=None)
                 - dt.datetime(1970, 1, 1)) / dt.timedelta(microseconds=1))
            for t in instants]
    assert got.tolist() == want
    assert (db.local_to_utc(torch.from_numpy(got)).numpy() == micros).all()
    assert (ref.utc_to_local_np(micros) != got).any()
