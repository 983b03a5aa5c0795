"""Queue C's faults C8-C13: where the port departed from Spark, each now
giving Spark's answer on the port's device path in test mode (every
operator on the card) and in its host engine, exactly. The reference's
answers are recorded beside them where they differ (ROADMAP C-ref-14,
C-ref-45 to C-ref-49).

- C8: a union column takes its sides' wider type (``WidenSetOperationTypes``);
- C9: string <-> timestamp casts read and write the session zone, the
  year padded to four digits;
- C10: ``date_format``/``from_unixtime`` write every DateTimeFormatter
  letter Spark takes, and refuse the week-based ones;
- C11: ``coalesce`` and ``isnull`` read a string as a column name;
- C12: ``lit`` of a ``date`` or ``datetime``;
- C13: a float group or distinct key of -0.0 comes out 0.0."""

import datetime as dt
import decimal
import math

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu.functions as RF
import spark_rapids_tpu_torch.functions as TF
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch.memory.device import TorchDeviceManager
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.window import Window

TorchDeviceManager.initialize(device="cpu", total_bytes=8 << 30)

DEC = decimal.Decimal
UTC = dt.timezone.utc
LA = {"spark.sql.session.timeZone": "America/Los_Angeles"}
ENGINES = ["device", "host"]


def _port(engine: str, **conf) -> TorchSession:
    c = {"spark.rapids.sql.test.enabled": "true"} if engine == "device" \
        else {"spark.rapids.sql.enabled": "false"}
    c.update(conf)
    return TorchSession(c, device="cpu")


def _ref(engine: str, **conf) -> TpuSession:
    return TpuSession({"spark.rapids.sql.enabled": str(
        engine == "device").lower(), **conf})


# ---------------------------------------------------------------------------
# C8: unions
# ---------------------------------------------------------------------------

UNION_CASES = {
    "int-double": (pa.array([1, 2], pa.int32()), pa.array([2.75, 5e9]),
                   pa.float64(), [1.0, 2.0, 2.75, 5e9]),
    "int-bigint": (pa.array([1, 2], pa.int32()),
                   pa.array([2 ** 40], pa.int64()), pa.int64(),
                   [1, 2, 2 ** 40]),
    "decimals": (pa.array([DEC("1.50")], pa.decimal128(12, 2)),
                 pa.array([DEC("1.4999")], pa.decimal128(10, 4)),
                 pa.decimal128(14, 4), [DEC("1.5000"), DEC("1.4999")]),
    "int-decimal": (pa.array([7], pa.int32()),
                    pa.array([DEC("0.25")], pa.decimal128(5, 2)),
                    pa.decimal128(12, 2), [DEC("7.00"), DEC("0.25")]),
    "string-int": (pa.array(["a"]), pa.array([3], pa.int64()),
                   pa.string(), ["a", "3"]),
}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", sorted(UNION_CASES))
def test_c8_union_takes_the_wider_type(case, engine):
    """``x ∪ y`` is typed by Spark's wider type of the two sides, and
    every value survives (the port cut 5e9 to an int before)."""
    left, right, want_t, want = UNION_CASES[case]
    s = _port(engine)
    a = s.createDataFrame(pa.table({"x": left}))
    b = s.createDataFrame(pa.table({"x": right}))
    out = a.union(b).to_arrow()
    assert out.schema.field("x").type == want_t
    assert out.column("x").to_pylist() == want


@pytest.mark.parametrize("engine", ENGINES)
def test_c8_intersect_and_except_widen(engine):
    """intersect and except go through the same union, so 2 (int) meets
    2.0 (double) and nothing else (1.5 and 2.75 were cut to 1 and 2
    before), and 1 survives the except as 1.0."""
    s = _port(engine)
    a = s.createDataFrame(pa.table({"x": pa.array([1, 2], pa.int32())}))
    b = s.createDataFrame(pa.table({"x": pa.array([1.5, 2.0, 2.75])}))
    assert a.intersect(b).collect() == [{"x": 2.0}]
    assert a.subtract(b).collect() == [{"x": 1.0}]


def test_c8_reference_union_fails():
    """C-ref-14: the reference keeps the first side's type and passes the
    other side through uncast, so its collect of int32 ∪ double fails
    (``ArrowInvalid``: the schemas differ) on both of its paths."""
    left, right, _, _ = UNION_CASES["int-double"]
    for engine in ENGINES:
        s = _ref(engine)
        q = s.createDataFrame(pa.table({"x": left})).union(
            s.createDataFrame(pa.table({"x": right})))
        with pytest.raises(pa.ArrowInvalid):
            q.collect()


# ---------------------------------------------------------------------------
# C9: string <-> timestamp casts in the session zone
# ---------------------------------------------------------------------------

T_UTC = dt.datetime(2020, 3, 8, 10, 30, tzinfo=UTC)
TS_TABLE = pa.table({
    "t": pa.array([T_UTC, dt.datetime(2020, 11, 1, 9, 30, tzinfo=UTC),
                   None], pa.timestamp("us", tz="UTC")),
    "s": pa.array(["2020-02-29 12:00:00", "2020-07-01T00:00:00Z",
                   "2020-03-08 02:30:00"])})


@pytest.mark.parametrize("engine", ENGINES)
def test_c9_timestamp_casts_read_the_session_zone(engine):
    """Under America/Los_Angeles: 10:30 UTC writes as 03:30 (PDT), 09:30
    UTC on 2020-11-01 as 01:30 (PST, just past the fall-back); a text
    without a zone is Los Angeles wall time (12:00 PST is 20:00 UTC), one
    with ``Z`` keeps it, one in the spring-forward gap moves on an hour
    (java.time's rule). In UTC the year 1 writes as 0001."""
    got = _port(engine, **LA).createDataFrame(TS_TABLE).select(
        TF.col("t").cast("string").alias("ts"),
        TF.col("s").cast("timestamp").alias("p")).collect()
    assert [g["ts"] for g in got] == ["2020-03-08 03:30:00",
                                      "2020-11-01 01:30:00", None]
    assert [g["p"] for g in got] == [
        dt.datetime(2020, 2, 29, 20, 0, tzinfo=UTC),
        dt.datetime(2020, 7, 1, 0, 0, tzinfo=UTC),
        dt.datetime(2020, 3, 8, 10, 30, tzinfo=UTC)]
    one = pa.table({"t": pa.array([dt.datetime(1, 1, 1, tzinfo=UTC)],
                                  pa.timestamp("us", tz="UTC"))})
    got = _port(engine).createDataFrame(one).select(
        TF.col("t").cast("string").alias("ts")).collect()
    assert got == [{"ts": "0001-01-01 00:00:00"}]


def test_c9_reference_casts_ignore_the_zone():
    """C-ref-45: the reference's casts read and write UTC under any
    session zone, on both of its paths."""
    for engine in ENGINES:
        got = _ref(engine, **LA).createDataFrame(TS_TABLE.slice(0, 1)) \
            .select(RF.col("t").cast("string").alias("ts"),
                    RF.col("s").cast("timestamp").alias("p")).collect()[0]
        assert got["ts"] == "2020-03-08 10:30:00"
        assert got["p"].replace(tzinfo=None) == dt.datetime(2020, 2, 29, 12)


# ---------------------------------------------------------------------------
# C10: date_format's letters
# ---------------------------------------------------------------------------

D_PATTERNS = {"D": "31", "E": "Fri", "MMMM": "January", "y": "2020",
              "hh": "12", "Q": "1", "EEEE": "Friday", "QQQ": "Q1",
              "M/d/yy": "1/31/20", "DDD": "031", "G": "AD", "a": "AM",
              "h:mm a": "12:00 AM", "QQQQ": "1st quarter", "LLL": "Jan"}
T_PATTERNS = {"SSS": "123", "XXX": "Z", "S": "1", "SSSSSS": "123000",
              "HH:mm:ss.SSS": "10:30:00.123", "x": "+00", "Z": "+0000",
              "kk": "10", "K": "10"}


@pytest.mark.parametrize("engine", ENGINES)
def test_c10_date_format_letters(engine):
    """d = 2020-01-31, t = 2020-03-08 10:30:00.123 UTC: each pattern
    gives Spark's text (null before); under Los Angeles ``XXX`` is the
    zone's offset at that instant."""
    pats = list(D_PATTERNS.items()) + list(T_PATTERNS.items())
    df = _port(engine).createDataFrame([{
        "d": dt.date(2020, 1, 31),
        "t": dt.datetime(2020, 3, 8, 10, 30, 0, 123000, tzinfo=UTC)}])
    got = df.select(*[TF.date_format("d" if p in D_PATTERNS else "t",
                                     p).alias(f"c{i}")
                      for i, (p, _) in enumerate(pats)]).collect()[0]
    assert [got[f"c{i}"] for i in range(len(pats))] == [w for _, w in pats]
    la = _port(engine, **LA).createDataFrame(df.to_arrow()).select(
        TF.date_format("t", "yyyy-MM-dd HH:mm XXX").alias("a"),
        TF.from_unixtime(TF.lit(1583663400), "XX").alias("b")).collect()
    assert la == [{"a": "2020-03-08 03:30 -07:00", "b": "-0700"}]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("letter", list("YwWuec"))
def test_c10_week_based_letters_raise(engine, letter):
    """Spark 3 refuses the week-based letters (an error, not nulls)."""
    df = _port(engine).createDataFrame([{"d": dt.date(2020, 1, 31)}])
    with pytest.raises(ValueError, match="week-based"):
        df.select(TF.date_format("d", letter).alias("x")).collect()


def test_c10_reference_gives_null():
    """C-ref-46: the reference's ``date_format`` of ``D`` or ``SSS`` is
    null, on both of its paths."""
    for engine in ENGINES:
        got = _ref(engine).createDataFrame(pa.table({
            "d": pa.array([dt.date(2020, 1, 31)])})).select(
                RF.date_format("d", "D").alias("x")).collect()
        assert got == [{"x": None}]


# ---------------------------------------------------------------------------
# C11: coalesce and isnull of names
# ---------------------------------------------------------------------------

NAMES = pa.table({"a": pa.array([None, "x", None]),
                  "b": pa.array(["y", "z", None])})


@pytest.mark.parametrize("engine", ENGINES)
def test_c11_coalesce_and_isnull_read_column_names(engine):
    """``coalesce("a", "b")`` is the columns' coalesce and ``isnull("a")``
    the column's test (the string was a literal before)."""
    got = _port(engine).createDataFrame(NAMES).select(
        TF.coalesce("a", "b").alias("c"), TF.isnull("a").alias("n"),
        TF.coalesce(TF.col("a"), TF.lit("w")).alias("w")).collect()
    assert got == [{"c": "y", "n": True, "w": "w"},
                   {"c": "x", "n": False, "w": "x"},
                   {"c": None, "n": True, "w": "w"}]


def test_c11_reference_reads_a_literal():
    """C-ref-47: the reference's host engine reads ``coalesce("s", "s")``
    as the literal 's'; its device path raises ``TypeError``."""
    t = pa.table({"s": pa.array(["p", None])})
    got = _ref("host").createDataFrame(t).select(
        RF.coalesce("s", "s").alias("c")).collect()
    assert got == [{"c": "s"}, {"c": "s"}]
    with pytest.raises(TypeError):
        _ref("device").createDataFrame(t).select(
            RF.coalesce("s", "s").alias("c")).collect()


# ---------------------------------------------------------------------------
# C12: date and datetime literals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ENGINES)
def test_c12_date_and_datetime_literals(engine):
    """A ``date`` is a DateType literal; a naive ``datetime`` is a wall
    time in the session zone (as SQL's ``TIMESTAMP '…'``), an aware one
    its instant."""
    df = _port(engine, **LA).createDataFrame(
        [{"d": dt.date(2000, 1, 11)}, {"d": dt.date(1999, 12, 31)}])
    got = df.select(
        TF.datediff(TF.col("d"), TF.lit(dt.date(2000, 1, 1))).alias("dd"),
        (TF.col("d") == TF.lit(dt.date(1999, 12, 31))).alias("eq"),
        TF.lit(dt.datetime(2020, 1, 1, 12, 0)).alias("wall"),
        TF.lit(dt.datetime(2020, 1, 1, 12, 0, tzinfo=UTC)).alias("inst"),
        TF.hour(TF.lit(dt.datetime(2020, 7, 1, 9, 0))).alias("h")).collect()
    assert [g["dd"] for g in got] == [10, -1]
    assert [g["eq"] for g in got] == [False, True]
    assert got[0]["wall"] == dt.datetime(2020, 1, 1, 20, 0, tzinfo=UTC)
    assert got[0]["inst"] == dt.datetime(2020, 1, 1, 12, 0, tzinfo=UTC)
    assert got[0]["h"] == 9


def test_c12_reference_device_path_raises():
    """C-ref-48: the reference's host engine takes the date literal; its
    device path raises ``TypeError``."""
    t = pa.table({"d": pa.array([dt.date(2000, 1, 11)])})
    q = lambda s: s.createDataFrame(t).select(  # noqa: E731
        RF.datediff(RF.col("d"), RF.lit(dt.date(2000, 1, 1))).alias("x"))
    assert q(_ref("host")).collect() == [{"x": 10}]
    with pytest.raises(TypeError):
        q(_ref("device")).collect()


# ---------------------------------------------------------------------------
# C13: -0.0 keys
# ---------------------------------------------------------------------------

FLOATS = pa.table({"f": pa.array([float("nan"), 1.0, -0.0, 0.0, None]),
                   "v": pa.array([1, 2, 3, 4, 5])})


def _signed(rows, key="f"):
    """(sign bit, value or "nan", count) of each row's key, in text order."""
    return sorted((((None, None) if r[key] is None else
                    (math.copysign(1.0, r[key]),
                     "nan" if r[key] != r[key] else r[key]),
                    r.get("count")) for r in rows), key=repr)


@pytest.mark.parametrize("engine", ENGINES)
def test_c13_negative_zero_keys_normalize(engine):
    """``groupBy("f").count()`` and ``distinct`` give the key 0.0 (its
    sign bit clear) with -0.0 and 0.0 in one group; a join key of -0.0
    meets 0.0 and a window partition holds both (Spark normalizes all
    three); a join keeps each side's own value."""
    s = _port(engine)
    df = s.createDataFrame(FLOATS)
    assert _signed(df.groupBy("f").count().collect()) == sorted([
        ((None, None), 1), ((1.0, 0.0), 2), ((1.0, 1.0), 1),
        ((1.0, "nan"), 1)], key=repr)
    assert _signed(df.select("f").distinct().collect()) == sorted([
        ((None, None), None), ((1.0, 0.0), None), ((1.0, 1.0), None),
        ((1.0, "nan"), None)], key=repr)
    zero = s.createDataFrame(pa.table({"z": pa.array([0.0])}))
    j = df.join(zero, df["f"] == zero["z"]).select("v", "f").collect()
    assert sorted((r["v"], math.copysign(1.0, r["f"])) for r in j) == [
        (3, -1.0), (4, 1.0)]
    w = df.select("v", TF.count("v").over(Window.partitionBy("f"))
                  .alias("c")).collect()
    assert sorted((r["v"], r["c"]) for r in w) == [(1, 1), (2, 1), (3, 2),
                                                   (4, 2), (5, 1)]


def test_c13_reference_device_keeps_negative_zero():
    """C-ref-49: the reference's device group-by keeps the key -0.0; its
    host engine gives 0.0."""
    got = {e: {math.copysign(1.0, r["f"]) for r in _ref(e).createDataFrame(
        FLOATS).groupBy("f").count().collect()
        if r["f"] is not None and r["f"] == 0} for e in ENGINES}
    assert got == {"device": {-1.0}, "host": {1.0}}


def test_chip_smoke_phase19_rehearsal():
    """chip_smoke's phase 19 off the card: every C8-C13 check."""
    import chip_smoke
    chip_smoke.fault_paths(TF, TorchSession, device="cpu")


def test_float_group_keys_on_the_card_keep_their_values():
    """The normalization touches only -0.0 and NaN: other float keys come
    out bit for bit."""
    vals = np.array([1.5, -2.25, 3e300, -1e-300, 5e-324], np.float64)
    s = _port("device")
    got = s.createDataFrame(pa.table({"f": pa.array(vals)})).groupBy(
        "f").count().collect()
    assert sorted(r["f"] for r in got) == sorted(vals.tolist())
