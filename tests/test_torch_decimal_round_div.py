"""The rest of decimals on the card: ``round``, ``bround``, ``floor`` and
``ceil`` of a decimal, decimal ``/``, ``%`` and ``pmod`` by a 128-bit long
division, and window aggregates over decimals.

Every answer is held exactly to a Python ``decimal`` oracle (a 100-digit
context), in values and in Spark's result types, on the port's device
path in test mode (every operator on the card) and in its host engine.
The reference departs from Spark for the rounding family (ROADMAP
C-ref-50, C-ref-51): its answers are recorded beside the port's."""

import decimal
import random

import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu_torch.functions as TF
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch.expressions.base import ExpressionError
from spark_rapids_tpu_torch.kernels import decimal128 as D
from spark_rapids_tpu_torch.memory.device import TorchDeviceManager
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.window import Window

TorchDeviceManager.initialize(device="cpu", total_bytes=8 << 30)

DEC = decimal.Decimal
CTX = decimal.Context(prec=100)
ANSI = {"spark.sql.ansi.enabled": "true"}


def _port(device: bool, **conf) -> TorchSession:
    c = {"spark.rapids.sql.test.enabled": "true"} if device \
        else {"spark.rapids.sql.enabled": "false"}
    c.update(conf)
    return TorchSession(c, device="cpu")


def _q(v: DEC, scale: int, rounding=decimal.ROUND_HALF_UP) -> DEC:
    return v.quantize(DEC(1).scaleb(-scale), context=decimal.Context(
        prec=100, rounding=rounding))


# ---------------------------------------------------------------------------
# the 128-bit divmod and the rounding helper against Python ints
# ---------------------------------------------------------------------------

_SPECIAL_D = [1, 2, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 1, 2 ** 63 - 1, 2 ** 63,
              2 ** 63 + 1, 10 ** 37, 10 ** 12 - 1, 2 ** 126 + 3]


@pytest.mark.parametrize("n_bits,d_bits", [
    (90, 40), (62, 62), (127, 62), (64, 31), (127, 63), (127, 127),
    (40, 100), (1, 1)])
def test_divmod128_against_python_ints(n_bits, d_bits):
    """Both paths of ``divmod128`` (k-bit digits while the divisor fits 62
    bits, bit by bit past it), fuzzed over their whole bounds, with the
    divisors 1, 2^31 ± 1, 2^63 ± 1 and 10^37 where they fit."""
    rng = random.Random(n_bits * 1000 + d_bits)
    ds = [d for d in _SPECIAL_D if d < 2 ** d_bits]
    ds += [rng.randrange(1, 2 ** d_bits) for _ in range(300 - len(ds))]
    ns = [rng.randrange(0, 2 ** n_bits) for _ in range(298)] \
        + [0, 2 ** n_bits - 1]
    N, Dv = torch.from_numpy(D.pack(ns)), torch.from_numpy(D.pack(ds))
    qh, ql, rh, rl = D.divmod128(N[:, 0], N[:, 1], Dv[:, 0], Dv[:, 1],
                                 n_bits, d_bits)
    q = D.unpack(D.join(qh, ql).numpy())
    r = D.unpack(D.join(rh, rl).numpy())
    assert list(zip(q, r)) == [divmod(n, d) for n, d in zip(ns, ds)]


@pytest.mark.parametrize("mode,rounding", [
    ("half_up", decimal.ROUND_HALF_UP), ("half_even", decimal.ROUND_HALF_EVEN),
    ("floor", decimal.ROUND_FLOOR), ("ceil", decimal.ROUND_CEILING)])
def test_round_pow10_against_python(mode, rounding):
    """``round_pow10`` over two limbs at every digit count, ties of both
    signs included."""
    rng = random.Random(11)
    vals = [rng.randrange(-10 ** 38 + 1, 10 ** 38) for _ in range(200)]
    vals += [s * (10 ** k * m + 5 * 10 ** (k - 1)) for k in (1, 2, 9, 10, 19)
             for m in (0, 1, 2, 7) for s in (1, -1)] + [0, 1, -1]
    A = torch.from_numpy(D.pack(vals))
    for k in (1, 2, 3, 9, 10, 18, 19, 37, 38):
        got = D.unpack(D.join(*D.round_pow10(A[:, 0], A[:, 1], k,
                                             mode)).numpy())
        want = [int(DEC(v).scaleb(-k, context=CTX).quantize(
            DEC(1), context=decimal.Context(prec=100, rounding=rounding)))
            for v in vals]
        assert got == want, k


# ---------------------------------------------------------------------------
# Spark's result types (Spark 3.4, SPARK-39226), written out for the oracle
# ---------------------------------------------------------------------------


def _round_type(p: int, s: int, to: int):
    if to < 0:
        return min(38, max(p - s + 1, 1 - to)), 0
    return min(38, p - s + 1 + min(s, to)), min(s, to)


def _adjust(p: int, s: int):
    if p <= 38:
        return p, s
    return 38, max(38 - (p - s), min(s, 6))


def _div_type(p1, s1, p2, s2):
    s = max(6, s1 + p2 + 1)
    return _adjust(p1 - s1 + s2 + s, s)


# ---------------------------------------------------------------------------
# queries over decimal(12, 2) and decimal(30, 4)
# ---------------------------------------------------------------------------

TYPES = {"d12": (12, 2), "d30": (30, 4)}
SCALES = (-1, 0, 1, 3)
ROWS = 600


def _table(p: int, s: int, seed: int):
    """``a`` and ``b`` over the type's range, with ties at scales -1, 0, 1
    (a ending in 5, 50, 500 at its last places), zero divisors and nulls;
    a partition key ``g`` and an order key ``o``."""
    rng = random.Random(seed)
    top = 10 ** p - 1
    a, b = [], []
    for i in range(ROWS):
        x = rng.randrange(-top, top + 1) if i % 3 else \
            rng.randrange(-10 ** (s + 4), 10 ** (s + 4))
        if i % 7 in (1, 2, 3):
            unit = 10 ** (s + 1 - (i % 7 - 1))  # ties at -1, 0, 1
            x = (abs(x) // unit * unit + unit // 2) % (top + 1) * \
                (1 if x >= 0 else -1)
        y = rng.randrange(-top, top + 1) if i % 5 else \
            rng.randrange(-10 ** (s + 2), 10 ** (s + 2))
        if i % 31 == 4:
            y = 0
        a.append(None if i % 13 == 6 else DEC(x).scaleb(-s, context=CTX))
        b.append(None if i % 17 == 8 else DEC(y).scaleb(-s, context=CTX))
    return pa.table({
        "a": pa.array(a, pa.decimal128(p, s)),
        "b": pa.array(b, pa.decimal128(p, s)),
        "g": pa.array([i % 5 for i in range(ROWS)], pa.int64()),
        "o": pa.array(list(range(ROWS)), pa.int64())})


def _query(df):
    cols = [TF.col("o")]
    for sc in SCALES:
        tag = str(sc).replace("-", "m")
        cols += [TF.round(TF.col("a"), sc).alias(f"round_{tag}"),
                 TF.bround(TF.col("a"), sc).alias(f"bround_{tag}")]
    cols += [TF.floor(TF.col("a")).alias("floor"),
             TF.ceil(TF.col("a")).alias("ceil"),
             (TF.col("a") / TF.col("b")).alias("div"),
             (TF.col("a") % TF.col("b")).alias("rem"),
             TF.pmod(TF.col("a"), TF.col("b")).alias("pmod")]
    return df.select(*cols)


@pytest.fixture(scope="module")
def runs():
    """One run a table and engine: {(type, engine): (rows, schema)}."""
    out = {}
    for name, (p, s) in TYPES.items():
        tbl = _table(p, s, seed=p)
        for engine in ("device", "host"):
            ses = _port(engine == "device")
            res = _query(ses.createDataFrame(tbl)).to_arrow()
            out[name, engine] = (res.to_pylist(), res.schema,
                                 ses.counters["decimal.hostPath"])
        out[name, "input"] = tbl.to_pylist()
    return out


def _oracle(name: str, row: dict, col: str):
    """(value, (precision, scale)) of one output column by Python
    ``decimal``."""
    p, s = TYPES[name]
    x, y = row["a"], row["b"]
    fn, _, tag = col.partition("_")
    if fn in ("round", "bround"):
        to = -int(tag[1:]) if tag.startswith("m") else int(tag)
        t = _round_type(p, s, to)
        if x is None:
            return None, t
        mode = decimal.ROUND_HALF_UP if fn == "round" \
            else decimal.ROUND_HALF_EVEN
        v = _q(x, to, mode) if to < s else x
        return _q(v, t[1]), t
    if fn in ("floor", "ceil"):
        t = (min(38, p - s + 1), 0)
        mode = decimal.ROUND_FLOOR if fn == "floor" else decimal.ROUND_CEILING
        return (None if x is None else _q(x, 0, mode)), t
    if fn == "div":
        t = _div_type(p, s, p, s)
        if x is None or y is None or y == 0:
            return None, t
        v = _q(_q(CTX.divide(x, y), 38), t[1])
        return (v if abs(v) < DEC(10) ** (t[0] - t[1]) else None), t
    t = (p, s)  # % and pmod of two equal types
    if x is None or y is None or y == 0:
        return None, t
    r = CTX.remainder(x, y)  # the dividend's sign, as Java's
    if fn == "pmod" and r < 0:
        r = CTX.remainder(CTX.add(r, y), y)
    return _q(r, s), t


COLUMNS = [f"{fn}_{str(sc).replace('-', 'm')}" for sc in SCALES
           for fn in ("round", "bround")] + ["floor", "ceil", "div", "rem",
                                             "pmod"]


@pytest.mark.parametrize("engine", ["device", "host"])
@pytest.mark.parametrize("name", sorted(TYPES))
@pytest.mark.parametrize("col", COLUMNS)
def test_rounding_and_division_match_python_decimal(runs, name, engine,
                                                    col):
    """Each function's values and Spark's type over 600 rows with ties,
    zero divisors and nulls; on the card no decimal host hop (every
    scaled operand fits 127 bits)."""
    rows, schema, hops = runs[name, engine]
    got_t = schema.field(col).type
    for r, inp in zip(rows, runs[name, "input"]):
        want, t = _oracle(name, inp, col)
        assert (got_t.precision, got_t.scale) == t
        got = r[col]
        assert got == want, (inp, col, got, want)
        if got is not None:
            assert got.as_tuple().exponent == -t[1]
    assert hops == 0


def test_the_override_engine_keeps_them_on_the_card():
    """No operator of the rounding family or of ``/ % pmod`` over either
    type leaves the card, and test mode admits no host node for them."""
    from spark_rapids_tpu_torch.plan import overrides
    assert not hasattr(overrides, "_HOST_ONLY_DECIMAL")
    for p, s in TYPES.values():
        q = _query(_port(True).createDataFrame(_table(p, s, seed=1)))
        assert "Cpu" not in q.explain_fallback().replace(
            "CpuLocalTableScanExec", "")


def test_division_rounds_twice_as_spark():
    """The second rounding built on purpose: decimal(38, 10) /
    decimal(38, 0) is (38, 10), so T = 10^28 and a divisor of 2·10^28 + 2
    passes it. With remainder 10^28 the quotient at scale 38 lands on a
    tie at scale 10 (2r < D, yet D − 2r <= floor(D / T)): Spark rounds
    up, one rounding would not. A row just past it stays down. And at
    result scale 38 (T = 1): decimal(1, 1) / decimal(36, 0)."""
    d = 2 * 10 ** 28 + 2
    big = pa.table({
        "a": pa.array([DEC(n).scaleb(-10, context=CTX) for n in (
            3 * 10 ** 28 + 2, 3 * 10 ** 28 + 1, -(3 * 10 ** 28 + 2))],
                      pa.decimal128(38, 10)),
        "b": pa.array([DEC(d), DEC(d), DEC(d)], pa.decimal128(38, 0))})
    small = pa.table({
        "a": pa.array([DEC("0.5"), DEC("-0.7"), DEC("0.1")],
                      pa.decimal128(1, 1)),
        "b": pa.array([DEC(3), DEC(7 * 10 ** 35 + 1), DEC(-9)],
                      pa.decimal128(36, 0))})
    for tbl, (p, s) in ((big, (38, 10)), (small, (38, 38))):
        want = [_q(_q(CTX.divide(r["a"], r["b"]), 38), s)
                for r in tbl.to_pylist()]
        for device in (True, False):
            ses = _port(device)
            out = ses.createDataFrame(tbl).select(
                (TF.col("a") / TF.col("b")).alias("q")).to_arrow()
            assert out.schema.field("q").type == pa.decimal128(p, s)
            assert out.column("q").to_pylist() == want
            assert ses.counters["decimal.hostPath"] == 0
    # the first row rounds up only by the second rounding; the second
    # (remainder 10^28 − 1) stays down by both
    for n, up in ((3 * 10 ** 28 + 2, True), (3 * 10 ** 28 + 1, False)):
        exact = CTX.divide(DEC(n).scaleb(-10, context=CTX), DEC(d))
        assert (_q(_q(exact, 38), 10) != _q(exact, 10)) == up


def test_operands_past_2_127_take_the_host_hop():
    """decimal(38, 0) / decimal(38, 0) scales the dividend by 10^6 (past
    2^127 for |a| > 1.7·10^32) and decimal(38, 0) % decimal(38, 38) by
    10^38: those rows go through the exact host rule, counted in
    ``decimal.hostPath``, the others stay on the card; all equal Python
    ``decimal``."""
    a = [DEC(9 * 10 ** 37 + 7), DEC(-12345), DEC(5 * 10 ** 33), DEC(1)]
    b = [DEC(3), DEC(7), DEC(-(10 ** 20)), DEC(0)]
    f = [DEC("0.3"), DEC("-0.0000000000000000000000000000000000007"),
         DEC("0.99"), DEC("0.5")]
    tbl = pa.table({"a": pa.array(a, pa.decimal128(38, 0)),
                    "b": pa.array(b, pa.decimal128(38, 0)),
                    "f": pa.array(f, pa.decimal128(38, 38))})
    want_div = [None if y == 0 else _q(_q(CTX.divide(x, y), 38), 6)
                for x, y in zip(a, b)]
    want_rem = [_q(CTX.remainder(x, y), 38) for x, y in zip(a, f)]
    for device in (True, False):
        ses = _port(device)
        out = ses.createDataFrame(tbl).select(
            (TF.col("a") / TF.col("b")).alias("q"),
            (TF.col("a") % TF.col("f")).alias("r")).to_arrow()
        assert out.schema.field("q").type == pa.decimal128(38, 6)
        assert out.column("q").to_pylist() == [
            v if v is None or abs(v) < DEC(10) ** 32 else None
            for v in want_div]
        assert out.column("r").to_pylist() == want_rem
        if device:
            assert ses.counters[
                "decimal.hostPath.Divide.operand past 2^127"] == 1
            assert ses.counters[
                "decimal.hostPath.Remainder.operand past 2^127"] == 1


@pytest.mark.parametrize("device", [True, False], ids=["device", "host"])
def test_zero_divisors_and_overflow_under_ansi(device):
    """A zero divisor is null, under ANSI "division by zero"; a rounded
    value past its type (decimal(38, 0) rounded to tens) is null, under
    ANSI "decimal overflow in round"."""
    tbl = pa.table({"a": pa.array([DEC(5), DEC(10 ** 38 - 1)],
                                  pa.decimal128(38, 0)),
                    "b": pa.array([DEC(0), DEC(1)], pa.decimal128(38, 0))})
    got = _port(device).createDataFrame(tbl).select(
        (TF.col("a") / TF.col("b")).alias("q"),
        TF.pmod(TF.col("a"), TF.col("b")).alias("m"),
        TF.round(TF.col("a"), -1).alias("r")).collect()
    assert [g["q"] for g in got][0] is None and got[0]["m"] is None
    assert [g["r"] for g in got] == [DEC(10), None]
    for e, msg in ((TF.col("a") / TF.col("b"), "division by zero"),
                   (TF.round(TF.col("a"), -1), "decimal overflow in round")):
        with pytest.raises(ExpressionError, match=msg):
            _port(device, **ANSI).createDataFrame(tbl).select(
                e.alias("x")).collect()


# ---------------------------------------------------------------------------
# windows over decimals
# ---------------------------------------------------------------------------


def _avg_scales(p: int, s: int):
    """(the quotient's scale, avg's type) of Spark's decimal avg: the sum
    (p + 10, s) over the count as decimal(20, 0), then (p + 4, s + 4)."""
    sp = min(38, p + 10)
    return _div_type(sp, s, 20, 0)[1], (min(38, p + 4), min(38, s + 4))


def _window_oracle(rows, p: int, s: int):
    with decimal.localcontext(CTX):
        return _window_rows(rows, p, s)


def _window_rows(rows, p: int, s: int):
    q_s, (ap, as_) = _avg_scales(p, s)
    out = {}
    for g in {r["g"] for r in rows}:
        part = sorted((r for r in rows if r["g"] == g), key=lambda r: r["o"])
        for k, r in enumerate(part):
            run = [x["a"] for x in part[:k + 1] if x["a"] is not None]
            near = [x["a"] for x in part[max(k - 2, 0):k + 2]
                    if x["a"] is not None]
            avg = None
            if near:
                v = _q(_q(_q(CTX.divide(sum(near, DEC(0)), len(near)), 38),
                          q_s), as_)
                avg = v if abs(v) < DEC(10) ** (ap - as_) else None
            out[r["o"]] = {
                "o": r["o"], "s": sum(run, DEC(0)) if run else None,
                "v": avg, "mn": min(run) if run else None,
                "mx": max(near) if near else None, "c": len(run),
                "lg": part[k - 1]["a"] if k else None,
                "ld": part[k + 2]["a"] if k + 2 < len(part) else DEC(0)}
    return [out[o] for o in sorted(out)]


@pytest.mark.parametrize("engine", ["device", "host"])
@pytest.mark.parametrize("name", sorted(TYPES))
def test_window_aggregates_over_decimals(name, engine):
    """sum, avg, min, max, count, lag and lead (with a default) over a
    partitioned, ordered decimal column, a running and a bounded ROWS
    frame, on the card (every operator there) and in the host engine."""
    p, s = TYPES[name]
    tbl = _table(p, s, seed=p + 1)
    run = Window.partitionBy("g").orderBy("o")
    near = run.rowsBetween(-2, 1)
    a = TF.col("a")
    got = _port(engine == "device").createDataFrame(tbl).select(
        "o", TF.sum(a).over(run).alias("s"), TF.avg(a).over(near).alias("v"),
        TF.min(a).over(run).alias("mn"), TF.max(a).over(near).alias("mx"),
        TF.count(a).over(run).alias("c"), TF.lag(a, 1).over(run).alias("lg"),
        TF.lead(a, 2, 0).over(run).alias("ld")).orderBy("o").collect()
    assert got == _window_oracle(tbl.to_pylist(), p, s)


def test_a_decimal128_window_key_stays_off_the_card():
    """A two-limb decimal partition key keeps the window in the host
    engine with its reason (the reference has no device key for it); a
    one-lane one stays on the card."""
    tbl = _table(30, 4, seed=3)
    df = _port(False).createDataFrame(tbl)
    s = TorchSession({}, device="cpu")
    q = s.createDataFrame(tbl).select(TF.sum(TF.col("o")).over(
        Window.partitionBy("a")).alias("x"))
    assert "decimal128 key" in q.explain_fallback()
    assert sorted(r["x"] for r in q.collect()) == sorted(
        r["x"] for r in df.select(TF.sum(TF.col("o")).over(
            Window.partitionBy("a")).alias("x")).collect())


# ---------------------------------------------------------------------------
# the reference's answers (ROADMAP C-ref-50, C-ref-51)
# ---------------------------------------------------------------------------

ISSUE_A = [DEC("0.05"), DEC("1.55"), DEC("-2.45"), None]


def test_rounding_departs_from_the_reference():
    """``round(a, 1)``, ``floor(a)`` and ``ceil(a)`` of decimal(12, 2)
    ``[0.05, 1.55, -2.45, null]``: the port gives Spark's answers on both
    engines. The reference's device path leaves round's values unchanged
    and gives floor/ceil as the unscaled bigints (C-ref-50); its host
    engine rounds to 0.10, 1.60, -2.50 typed decimal(12, 2) and fails
    floor/ceil with ``ArrowInvalid`` (C-ref-51)."""
    import spark_rapids_tpu.functions as RF
    tbl = pa.table({"a": pa.array(ISSUE_A, pa.decimal128(12, 2))})
    for device in (True, False):
        out = _port(device).createDataFrame(tbl).select(
            TF.round("a", 1).alias("r"), TF.floor("a").alias("f"),
            TF.ceil("a").alias("c")).to_arrow()
        assert out.schema.field("r").type == pa.decimal128(12, 1)
        assert out.schema.field("f").type == pa.decimal128(11, 0)
        assert out.column("r").to_pylist() == [DEC("0.1"), DEC("1.6"),
                                               DEC("-2.5"), None]
        assert out.column("f").to_pylist() == [DEC(0), DEC(1), DEC(-3), None]
        assert out.column("c").to_pylist() == [DEC(1), DEC(2), DEC(-2), None]
    dev = TpuSession({"spark.rapids.sql.enabled": "true"}).createDataFrame(tbl)
    assert [r["x"] for r in dev.select(RF.round("a", 1).alias("x"))
            .collect()] == ISSUE_A
    assert [r["x"] for r in dev.select(RF.floor("a").alias("x"))
            .collect()] == [5, 155, -245, None]
    assert [r["x"] for r in dev.select(RF.ceil("a").alias("x"))
            .collect()] == [5, 155, -245, None]
    host = TpuSession({"spark.rapids.sql.enabled": "false"}) \
        .createDataFrame(tbl)
    assert [r["x"] for r in host.select(RF.round("a", 1).alias("x"))
            .collect()] == [DEC("0.10"), DEC("1.60"), DEC("-2.50"), None]
    for fn in (RF.floor, RF.ceil):
        with pytest.raises(pa.ArrowInvalid):
            host.select(fn("a").alias("x")).collect()
