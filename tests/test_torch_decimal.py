"""Decimals in the port: the two carriers (scaled int64 up to precision
18, two int64 limbs past it), the limb math held bit for bit to the
reference's jnp functions, Spark's result types, the arithmetic, casts,
keys, hashes, the scan, the writer and the cache.

The reference departs from Spark for decimal arithmetic (its result type
is the left operand's, ROADMAP C-ref-37 to C-ref-41); the port is held to
Spark (``DecimalPrecision`` with ``allowPrecisionLoss=true``) through
Python ``decimal`` oracles, and to the reference where the two agree
(equal operand types for ``+``/``-``, the limb kernels, decimal64 keys and
hashes)."""

import decimal
import random

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import spark_rapids_tpu_torch.functions as TF
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar.batch import (TorchColumnarBatch,
                                                   compact, gather)
from spark_rapids_tpu_torch.expressions import arithmetic as PA
from spark_rapids_tpu_torch.expressions import decimals as DEC
from spark_rapids_tpu_torch.expressions.base import (AttributeReference,
                                                     EvalContext,
                                                     ExpressionError, Literal)
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.kernels import decimal128 as D
from spark_rapids_tpu_torch.memory.device import TorchDeviceManager
from spark_rapids_tpu_torch.session import TorchSession

TorchDeviceManager.initialize(device="cpu", total_bytes=8 << 30)

DEC_ = decimal.Decimal
BOUND = 10 ** 38 - 1
ANSI = {"spark.sql.ansi.enabled": "true"}


def _port(device: bool = True, **conf) -> TorchSession:
    c = {"spark.rapids.sql.test.enabled": "true"} if device \
        else {"spark.rapids.sql.enabled": "false"}
    c.update(conf)
    return TorchSession(c, device="cpu")


@pytest.fixture(scope="module")
def ref_session():
    return TpuSession({"spark.rapids.sql.enabled": "false"})


def _q(v, scale):
    """A Decimal at ``scale``, HALF_UP (the oracles' rounding)."""
    return DEC_(v).quantize(DEC_(1).scaleb(-scale),
                            context=decimal.Context(
                                prec=100, rounding=decimal.ROUND_HALF_UP))


# ---------------------------------------------------------------------------
# the limb kernels: bit for bit the reference's jnp functions
# ---------------------------------------------------------------------------

_RNG = random.Random(7)
FUZZ_A = [_RNG.randint(-BOUND, BOUND) for _ in range(300)] + \
    [0, 1, -1, BOUND, -BOUND, 2**64, -(2**64), 2**63, -(2**63)]
FUZZ_B = [_RNG.randint(-BOUND, BOUND) for _ in range(300)] + \
    [1, -1, -BOUND, BOUND, 0, -(2**64), 2**64, -(2**63), 2**63]


@pytest.fixture(scope="module")
def fuzz():
    import jax.numpy as jnp
    A, B = D.pack(FUZZ_A), D.pack(FUZZ_B)
    ref = tuple(jnp.asarray(x) for x in (A[:, 0], A[:, 1], B[:, 0],
                                          B[:, 1]))
    port = tuple(torch.from_numpy(np.ascontiguousarray(x))
                 for x in (A[:, 0], A[:, 1], B[:, 0], B[:, 1]))
    return ref, port


@pytest.mark.parametrize("fn", ["add128", "sub128", "mul128", "cmp128",
                                "precision_overflow", "from_int64",
                                "neg128"])
def test_limb_kernels_fuzz(fn, fuzz):
    """The fuzz set of the reference's ``test_limb_kernels_fuzz``: every
    output array equal to the reference's, bit for bit."""
    from spark_rapids_tpu.kernels import decimal128 as RD
    ref, port = fuzz
    if fn == "precision_overflow":
        want = [RD.precision_overflow(ref[0], ref[1], p) for p in (18, 38)]
        got = [D.precision_overflow(port[0], port[1], p) for p in (18, 38)]
    elif fn == "from_int64":
        want, got = RD.from_int64(ref[1]), D.from_int64(port[1])
    elif fn == "neg128":
        want, got = RD.neg128(ref[0], ref[1]), D.neg128(port[0], port[1])
    else:
        want, got = getattr(RD, fn)(*ref), getattr(D, fn)(*port)
    want = want if isinstance(want, (tuple, list)) else (want,)
    got = got if isinstance(got, (tuple, list)) else (got,)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w).astype(np.int64),
                              g.numpy().astype(np.int64))


def test_port_limb_helpers_against_python_ints():
    """The port's own helpers: HALF_UP rescale, truncation, the quotient
    at a scale and the segmented 128-bit sum, against Python ints."""
    vals = FUZZ_A
    A = torch.from_numpy(D.pack(vals))
    h, l = A[:, 0], A[:, 1]
    for k in (1, 2, 9, 10, 19, 37):
        got = D.unpack(D.join(*D.rescale_down(h, l, k)).numpy())
        assert got == [DEC.half_up_div(v, 10 ** k) for v in vals]
        got = D.unpack(D.join(*D.rescale_trunc(h, l, k)).numpy())
        assert got == [abs(v) // 10 ** k * (1 if v >= 0 else -1)
                       for v in vals]
    d = torch.tensor([_RNG.randint(1, 2**31 - 1) for _ in vals])
    for extra in (0, 4, 16):
        qh, ql, ovf = D.div_half_up(h, l, d, extra)
        for g, v, dd, o in zip(D.unpack(D.join(qh, ql).numpy()), vals,
                               d.tolist(), ovf.tolist()):
            want = DEC.half_up_div(v * 10 ** extra, dd)
            assert o == (abs(want) >= 2 ** 127)
            if not o:
                assert g == want
    small = [_RNG.randint(-10**30, 10**30) for _ in range(500)]
    seg = torch.tensor(sorted(_RNG.randrange(7) for _ in small))
    S = torch.from_numpy(D.pack(small))
    sh, sl, so = D.segment_sum128(
        S[:, 0], S[:, 1],
        lambda x: torch.zeros(7, dtype=torch.int64).index_add_(0, seg, x))
    assert not so.any()
    assert D.unpack(D.join(sh, sl).numpy()) == \
        [sum(v for v, g in zip(small, seg.tolist()) if g == i)
         for i in range(7)]


# ---------------------------------------------------------------------------
# decimal(38, 8) columns (the reference test's values)
# ---------------------------------------------------------------------------

VALS_A = [DEC_("12345678901234567890.12345678"),
          DEC_("9" * 30 + ".12345678"), None,
          DEC_("-" + "9" * 30 + ".00000001"), DEC_("0.00000001"),
          DEC_("-0.00000001")]
VALS_B = [DEC_("98765432109876543210.87654321"),
          DEC_("9" * 30 + ".12345678"), DEC_("1.00000000"),
          DEC_("9" * 30 + ".0"), DEC_("-0.00000002"), None]


def _setup(vals_a, vals_b, scale=8):
    t = pa.decimal128(38, scale)
    tbl = pa.table({"a": pa.array(vals_a, t), "b": pa.array(vals_b, t)})
    batch = TorchColumnarBatch.from_arrow(tbl)
    dt = PT.DecimalType(38, scale)
    return (batch, tbl, AttributeReference("a", dt, ordinal=0),
            AttributeReference("b", dt, ordinal=1))


def _spark(op, a, b, out):
    """Spark's decimal + - * of two Decimals into ``out`` (None past its
    precision): exact, a product first rounded to 38 digits, then HALF_UP
    to the result scale."""
    if a is None or b is None:
        return None
    if op is PA.Multiply:
        exact = decimal.Context(prec=100).multiply(a, b)
        ctx = decimal.Context(prec=38, rounding=decimal.ROUND_HALF_UP)
        exact = ctx.plus(exact) if len(exact.as_tuple().digits) > 38 \
            else exact
    else:
        ctx = decimal.Context(prec=100)
        exact = ctx.add(a, b) if op is PA.Add else ctx.subtract(a, b)
    q = _q(exact, out.scale)
    return q if abs(q) < DEC_(10) ** (out.precision - out.scale) else None


@pytest.mark.parametrize("op", [PA.Add, PA.Subtract, PA.Multiply])
def test_decimal38_matches_oracle(op):
    """Two-limb arithmetic on the device path and in the host engine,
    exact against Spark's rule at (38, 8) operands: ``+``/``-`` give
    (38, 7) (39 digits adjusted), ``*`` (38, 6). At (30, 8) operands, where
    no adjustment applies, ``+``/``-`` also equal the reference's answers
    (its type is the left operand's, C-ref-38; the values agree)."""
    batch, tbl, ra, rb = _setup(VALS_A, VALS_B)
    e = op(ra, rb)
    assert e.dtype == (PT.DecimalType(38, 6) if op is PA.Multiply
                       else PT.DecimalType(38, 7))
    want = [_spark(op, a, b, e.dtype) for a, b in zip(VALS_A, VALS_B)]
    got = e.eval_device(batch, EvalContext()).to_pylist()
    assert got == want
    assert e.eval_cpu(tbl).to_pylist() == want
    if op is PA.Multiply:
        return
    from spark_rapids_tpu.expressions import arithmetic as RA
    from spark_rapids_tpu.expressions.base import AttributeReference as RAttr
    from spark_rapids_tpu.types import DecimalType as RDec
    small_a = [v for v in VALS_A if v is None or abs(v) < 10 ** 21]
    small_b = [v for v in VALS_B if v is None or abs(v) < 10 ** 21][
        :len(small_a)]
    t = pa.decimal128(30, 8)
    tbl = pa.table({"a": pa.array(small_a, t), "b": pa.array(small_b, t)})
    batch = TorchColumnarBatch.from_arrow(tbl)
    dt = PT.DecimalType(30, 8)
    e = op(AttributeReference("a", dt, ordinal=0),
           AttributeReference("b", dt, ordinal=1))
    r = getattr(RA, op.__name__)(RAttr("a", RDec(30, 8), ordinal=0),
                                 RAttr("b", RDec(30, 8), ordinal=1))
    want = [_spark(op, a, b, e.dtype) for a, b in zip(small_a, small_b)]
    assert e.eval_device(batch, EvalContext()).to_pylist() == want
    assert r.eval_cpu(tbl).to_pylist() == want


def test_decimal38_overflow_null_and_ansi():
    """Past the result's precision: null; ANSI: ``ExpressionError``, the
    same on the host. The 60-digit product goes through the host's exact
    integers (``decimal.hostPath``)."""
    batch, tbl, ra, rb = _setup([DEC_("9" * 30)], [DEC_("9" * 30)],
                                scale=0)
    e = PA.Multiply(ra, rb)
    ctx = EvalContext()
    assert e.eval_device(batch, ctx).to_pylist() == [None]
    assert ctx.counters["decimal.hostPath"] == 1
    assert e.eval_cpu(tbl).to_pylist() == [None]
    ansi = EvalContext(RapidsConf(ANSI))
    with pytest.raises(ExpressionError, match="decimal overflow"):
        e.eval_device(batch, ansi)
    with pytest.raises(ExpressionError, match="decimal overflow"):
        e.eval_cpu(tbl, ansi)
    add = PA.Add(ra, rb)  # 31 digits: fits
    assert add.eval_device(batch, ansi).to_pylist() == \
        [DEC_("1" + "9" * 29 + "8")]


def test_product_past_2_127_that_fits_after_its_rescale():
    """A product past 2^127 before its rescale that fits after it: Spark
    has a value, so the port has one (the host's exact path)."""
    big = DEC_("9" * 25 + "." + "9" * 13)  # decimal(38, 13)
    batch, tbl, ra, rb = _setup([big], [big], scale=13)
    e = PA.Multiply(ra, rb)
    assert e.dtype == PT.DecimalType(38, 6)
    want = _spark(PA.Multiply, big, big, e.dtype)
    assert want is None  # 50 integral digits: past 38
    small = DEC_("12345678901234.1234567890123")
    batch, tbl, ra, rb = _setup([small], [DEC_("99999999.9999999999999")],
                                scale=13)
    e = PA.Multiply(ra, rb)
    want = _spark(PA.Multiply, small, DEC_("99999999.9999999999999"),
                  e.dtype)
    assert want is not None
    ctx = EvalContext()
    assert e.eval_device(batch, ctx).to_pylist() == [want]
    assert ctx.counters["decimal.hostPath"] == 1
    assert e.eval_cpu(tbl).to_pylist() == [want]


def test_decimal38_scalar_operand():
    batch, tbl, ra, rb = _setup(VALS_A, VALS_B)
    lit = Literal(DEC_("2.00000000"), PT.DecimalType(38, 8))
    for op in (PA.Add, PA.Multiply):
        e = op(ra, lit)
        want = [_spark(op, a, DEC_(2), e.dtype) for a in VALS_A]
        assert e.eval_device(batch, EvalContext()).to_pylist() == want
        assert e.eval_cpu(tbl).to_pylist() == want


def test_decimal128_column_roundtrip_and_batch_ops():
    """Limb columns survive gather, compact, concat and the transfers."""
    batch, tbl, ra, rb = _setup(VALS_A, VALS_B)
    keep = [True, False, True, True, False, True]
    dev = batch.to_device("cpu")
    mask = torch.tensor(keep + [False] * (dev.capacity - 6))
    got = compact(dev, mask).columns[0].to_pylist()
    assert got == [v for v, k in zip(VALS_A, keep) if k]
    idx = torch.tensor([5, 0, 3] + [0] * (dev.capacity - 3))
    g = gather(dev, idx, 3, out_capacity=dev.capacity)
    assert g.columns[0].to_pylist() == [VALS_A[5], VALS_A[0], VALS_A[3]]
    from spark_rapids_tpu_torch.columnar.batch import concat_batches
    both = concat_batches([dev, dev.to_host().to_device("cpu")])
    assert both.columns[1].to_pylist() == VALS_B + VALS_B
    assert both.to_arrow().column("a").to_pylist() == VALS_A + VALS_A


# ---------------------------------------------------------------------------
# Spark's result types
# ---------------------------------------------------------------------------

RESULT_TYPES = [
    ("+", (12, 2), (12, 2), (13, 2)), ("-", (12, 2), (3, 3), (14, 3)),
    ("+", (38, 10), (38, 20), (38, 9)), ("-", (38, 0), (38, 0), (38, 0)),
    ("*", (12, 2), (12, 2), (25, 4)), ("*", (12, 2), (13, 2), (26, 4)),
    ("*", (26, 4), (13, 2), (38, 6)), ("*", (38, 10), (38, 10), (38, 6)),
    ("*", (20, 18), (20, 18), (38, 33)), ("*", (38, 30), (10, 5), (38, 24)),
    ("/", (12, 2), (12, 2), (27, 15)), ("/", (10, 0), (10, 0), (21, 11)),
    ("/", (38, 10), (10, 2), (38, 8)), ("/", (22, 2), (20, 0), (38, 18)),
    ("%", (12, 2), (5, 3), (5, 3)), ("pmod", (12, 2), (12, 4), (12, 4)),
    ("%", (38, 2), (38, 36), (38, 36)),
]


@pytest.mark.parametrize("op,a,b,want", RESULT_TYPES)
def test_result_types(op, a, b, want):
    """Spark's DecimalPrecision (allowPrecisionLoss=true), with the
    38-digit adjustment ``s' = max(38 - intDigits, min(s, 6))``."""
    got = PT.decimal_result_type(op, PT.DecimalType(*a), PT.DecimalType(*b))
    assert (got.precision, got.scale) == want


def test_q1_chain_and_aggregate_types():
    """Q1's chain: 1 - l_discount (13, 2), disc_price (26, 4), charge
    (40, 6) adjusted to (38, 6); the sums (36, 4)/(38, 6); sum and avg of
    (12, 2) are (22, 2) and (16, 6). Also the widening of integral and
    float operands, and of a comparison."""
    d = PT.DecimalType
    one = PT.decimal_result_type("-", d(1, 0), d(12, 2))
    assert one == d(13, 2)
    disc = PT.decimal_result_type("*", d(12, 2), one)
    assert disc == d(26, 4)
    assert PT.decimal_result_type("*", disc, one) == d(38, 6)
    assert PT.sum_decimal_type(disc) == d(36, 4)
    assert PT.sum_decimal_type(d(38, 6)) == d(38, 6)
    assert PT.sum_decimal_type(d(12, 2)) == d(22, 2)
    assert PT.avg_decimal_type(d(12, 2)) == d(16, 6)
    assert PT.decimal_common_type(PT.IntegerT, d(12, 2)) == d(12, 2)
    assert PT.decimal_common_type(PT.LongT, d(12, 2)) == d(22, 2)
    assert PT.decimal_common_type(PT.ByteT, d(3, 3)) == d(6, 3)
    assert PT.decimal_common_type(PT.DoubleT, d(12, 2)) == PT.DoubleT
    assert PT.decimal_wider_type(d(12, 2), d(3, 3)) == d(13, 3)
    s = _port()
    df = s.createDataFrame([(DEC_("0.05"),)], "a decimal(12,2)")
    got = df.select((TF.lit(1) - TF.col("a")).alias("x"),
                    (TF.col("a") * 2).alias("y"),
                    (TF.col("a") + 1.5).alias("z")).schema
    assert [f.data_type for f in got.fields] == \
        [d(13, 2), d(14, 2), PT.DoubleT]


# ---------------------------------------------------------------------------
# the reference's departures (Motivation's table), held to Spark
# ---------------------------------------------------------------------------

AB = [(DEC_("0.05"), DEC_("3.00")), (DEC_("1.50"), DEC_("4.10"))]

DEPARTURES = [
    ("lit1_minus_a", lambda: TF.lit(1) - TF.col("a"), (13, 2),
     [DEC_("0.95"), DEC_("-0.50")]),
    ("a_times_b", lambda: TF.col("a") * TF.col("b"), (25, 4),
     [DEC_("0.1500"), DEC_("6.1500")]),
    ("a_div_b", lambda: TF.col("a") / TF.col("b"), (27, 15),
     [DEC_("0.016666666666667"), DEC_("0.365853658536585")]),
    ("a_plus_lit", lambda: TF.col("a") + TF.lit(DEC_("0.005")), (14, 3),
     [DEC_("0.055"), DEC_("1.505")]),
    ("cast_string", lambda: TF.lit("1.255").cast("decimal(5,2)"), (5, 2),
     [DEC_("1.26"), DEC_("1.26")]),
]


@pytest.mark.parametrize("device", [True, False], ids=["device", "host"])
@pytest.mark.parametrize("name,expr,typ,want", DEPARTURES,
                         ids=[d[0] for d in DEPARTURES])
def test_reference_departures_give_sparks_answer(name, expr, typ, want,
                                                 device):
    """C-ref-37 to C-ref-41: Spark's value and type, exactly, on the
    device path (test mode; ``/`` is the one operator that leaves the
    card) and in the host engine."""
    df = _port(device).createDataFrame(AB, "a decimal(12,2), b decimal(12,2)")
    q = df.select(expr().alias("x"))
    assert q.schema.fields[0].data_type == PT.DecimalType(*typ)
    got = [r["x"] for r in q.collect()]
    assert got == want
    assert [str(v) for v in got] == [str(v) for v in want]  # the scale too


REF_ANSWERS = {
    # the reference's device path (Motivation's table)
    "true": {"lit1_minus_a": [-4, -149],
             "a_times_b": [DEC_("15.00"), DEC_("615.00")],
             "a_div_b": [DEC_("0.00"), DEC_("0.00")],
             "a_plus_lit": [DEC_("0.10"), DEC_("1.55")]},
    # its host engine
    "false": {"lit1_minus_a": [0, 0],
              "a_times_b": [DEC_("0.15"), DEC_("6.15")],
              "a_div_b": "ArrowInvalid", "a_plus_lit": "ArrowInvalid"},
}


@pytest.mark.parametrize("enabled", ["true", "false"],
                         ids=["ref-device", "ref-host"])
def test_reference_answers_recorded(enabled):
    """What the reference gives for Motivation's cases (ROADMAP C-ref-37
    to C-ref-41), on its device path and in its host engine; its string
    → decimal cast raises on both."""
    import spark_rapids_tpu.functions as RF
    s = TpuSession({"spark.rapids.sql.enabled": enabled})
    df = s.createDataFrame(
        pa.table({"a": pa.array([r[0] for r in AB], pa.decimal128(12, 2)),
                  "b": pa.array([r[1] for r in AB], pa.decimal128(12, 2))}))
    cases = {"lit1_minus_a": lambda: RF.lit(1) - RF.col("a"),
             "a_times_b": lambda: RF.col("a") * RF.col("b"),
             "a_div_b": lambda: RF.col("a") / RF.col("b"),
             "a_plus_lit": lambda: RF.col("a") + RF.lit(DEC_("0.005"))}
    for name, fn in cases.items():
        want = REF_ANSWERS[enabled][name]
        q = df.select(fn().alias("x"))
        if isinstance(want, str):
            with pytest.raises(pa.ArrowInvalid):
                q.collect()
        else:
            assert [r["x"] for r in q.collect()] == want
    with pytest.raises(NotImplementedError):
        df.select(RF.lit("1.255").cast("decimal(5,2)").alias("x")).collect()


# ---------------------------------------------------------------------------
# casts
# ---------------------------------------------------------------------------

GOLDEN_STRINGS = ["1.005", "-1.005", "123.454", "123.455", "999.994",
                  "999.995", "1e2", "0.005", "abc", "", None]
GOLDEN_WANT = [DEC_("1.01"), DEC_("-1.01"), DEC_("123.45"), DEC_("123.46"),
               DEC_("999.99"), None, DEC_("100.00"), DEC_("0.01"), None,
               None, None]


@pytest.mark.parametrize("device", [True, False], ids=["device", "host"])
def test_string_to_decimal_golden(device):
    """``test_spark_golden.py::test_string_to_decimal``'s cases, held
    exactly (HALF_UP to the scale, null on overflow and garbage)."""
    s = _port(device)
    df = s.createDataFrame(pa.table({"s": pa.array(GOLDEN_STRINGS,
                                                   pa.string())}))
    got = [r["d"] for r in df.select(TF.col("s").cast("decimal(5,2)")
                                     .alias("d")).collect()]
    assert got == GOLDEN_WANT
    assert [str(v) for v in got if v is not None] == \
        [str(v) for v in GOLDEN_WANT if v is not None]
    if device:
        assert s.counters["decimal.hostPath"] >= 1


CAST_TABLE = pa.table({
    "d": pa.array([DEC_("1.25"), DEC_("-1.25"), DEC_("1.35"), DEC_("-0.05"),
                   None, DEC_("99999.99"), DEC_("-2147483648.99")],
                  pa.decimal128(12, 2)),
    "w": pa.array([DEC_("123456789012345678901234.5"), DEC_("-0.5"),
                   DEC_("0.4"), DEC_("9007199254740993.0"), None,
                   DEC_("-99999999999999999999999999.9"), DEC_("1.5")],
                  pa.decimal128(30, 1)),
    "i": pa.array([7, -3, None, 2**31 - 1, 0, -2**31, 5], pa.int32()),
    "x": pa.array([1.005, 2.675, -0.125, float("nan"), None, 1e20, 0.1]),
    # as many integral digits as the casts below keep: HALF_UP carries
    # some rows into one more digit
    "e": pa.array([DEC_("9999999999.99"), DEC_("-9999999999.95"),
                   DEC_("9999999999.94"), DEC_("9.99"), DEC_("-9.95"),
                   DEC_("9.94"), None], pa.decimal128(12, 2)),
    "f": pa.array([DEC_("9.99"), DEC_("-9.95"), DEC_("9.94"), DEC_("0.05"),
                   None, DEC_("1.00"), DEC_("-1.25")], pa.decimal128(3, 2)),
})


def _decimal_of_float_text(v, p, s):
    if v is None or v != v or v in (float("inf"), float("-inf")):
        return None
    q = _q(DEC_(repr(v)), s)
    return q if abs(q) < DEC_(10) ** (p - s) else None


def _fit(p, s):
    """The oracle of a cast to decimal(p, s): HALF_UP, null past p."""
    return lambda v: None if v is None or abs(_q(v, s)) >= DEC_(10) ** (
        p - s) else _q(v, s)


CASTS = [
    ("d", "decimal(4,1)", lambda v: None if v is None else
     (_q(v, 1) if abs(_q(v, 1)) < 1000 else None)),
    ("d", "decimal(20,5)", lambda v: None if v is None else _q(v, 5)),
    ("w", "decimal(10,0)", lambda v: None if v is None else
     (_q(v, 0) if abs(_q(v, 0)) < 10 ** 10 else None)),
    ("w", "decimal(38,3)", lambda v: None if v is None else _q(v, 3)),
    ("d", "double", lambda v: None if v is None else float(v)),
    ("w", "double", lambda v: None if v is None else float(v)),
    ("d", "int", lambda v: None if v is None else
     ((int(v) + 2**31) % 2**32) - 2**31),
    ("w", "bigint", lambda v: None if v is None else
     ((int(v) + 2**63) % 2**64) - 2**63),
    ("d", "boolean", lambda v: None if v is None else v != 0),
    ("i", "decimal(12,2)", lambda v: None if v is None else _q(v, 2)),
    ("i", "decimal(5,1)", lambda v: None if v is None else
     (_q(v, 1) if abs(v) < 10 ** 4 else None)),
    ("x", "decimal(10,2)", lambda v: _decimal_of_float_text(v, 10, 2)),
    ("x", "decimal(30,20)", lambda v: _decimal_of_float_text(v, 30, 20)),
    ("d", "string", lambda v: None if v is None else format(v, "f")),
    ("e", "decimal(11,1)", _fit(11, 1)),
    ("e", "decimal(2,1)", _fit(2, 1)),
    ("f", "decimal(2,1)", _fit(2, 1)),
    ("w", "decimal(26,0)", _fit(26, 0)),
]


@pytest.mark.parametrize("device", [True, False], ids=["device", "host"])
@pytest.mark.parametrize("col,to,oracle", CASTS,
                         ids=[f"{c}-{t}" for c, t, _ in CASTS])
def test_casts(col, to, oracle, device):
    """Decimal casts each way against their Spark rule: HALF_UP to a
    coarser scale, null past the precision, truncation and Java's wrap to
    integers, the correctly rounded double, a double's shortest text
    HALF_UP (1.005 → 1.01, 2.675 → 2.68)."""
    df = _port(device).createDataFrame(CAST_TABLE)
    got = [r["c"] for r in df.select(TF.col(col).cast(to).alias("c"))
           .collect()]
    want = [oracle(v) for v in CAST_TABLE.column(col).to_pylist()]
    assert got == want


@pytest.mark.parametrize("device", [True, False], ids=["device", "host"])
def test_ansi_cast_overflow_raises(device):
    df = _port(device, **ANSI).createDataFrame(CAST_TABLE)
    with pytest.raises(ExpressionError, match="overflow"):
        df.select(TF.col("d").cast("decimal(4,1)").alias("c")).collect()
    for col, to in (("e", "decimal(11,1)"), ("f", "decimal(2,1)"),
                    ("w", "decimal(26,0)")):
        with pytest.raises(ExpressionError, match="overflow"):
            df.select(TF.col(col).cast(to).alias("c")).collect()
    with pytest.raises(ExpressionError):
        df.select(TF.col("x").cast("decimal(10,2)").alias("c")).collect()
    ok = df.select(TF.col("d").cast("decimal(20,5)").alias("c")).collect()
    assert ok[0]["c"] == DEC_("1.25000")


# ---------------------------------------------------------------------------
# keys and hashes: decimal64 against the reference's answers
# ---------------------------------------------------------------------------

KEYS = pa.table({
    "k": pa.array([DEC_("1.50"), DEC_("-2.25"), None, DEC_("1.50"),
                   DEC_("3.00"), DEC_("-2.25"), DEC_("0.00"), None],
                  pa.decimal128(10, 2)),
    "v": pa.array([1, 2, 3, 4, 5, 6, 7, 8], pa.int64()),
    "w": pa.array([DEC_("1.5"), DEC_("12345678901234567890.5"), None,
                   DEC_("1.5"), DEC_("-3.0"), DEC_("-7"), DEC_("0"),
                   DEC_("-12345678901234567890.5")], pa.decimal128(30, 1)),
})
DIM = pa.table({"k2": pa.array([DEC_("1.50"), DEC_("3.00"), DEC_("9.99")],
                               pa.decimal128(10, 2)),
                "x": pa.array([10, 20, 30], pa.int64())})


def _key_queries(F, df, dim):
    return {
        "group": df.groupBy("k").agg(F.sum(F.col("v")).alias("s"),
                                     F.count(F.col("v")).alias("n"))
        .orderBy("k"),
        "sort": df.orderBy(F.col("k").desc(), F.col("v")).select("k", "v"),
        "join": df.join(dim, df["k"] == dim["k2"]).select("k", "v", "x")
        .orderBy("v"),
    }


#: the unscaled values of ``k``: Spark hashes a decimal up to precision
#: 18 as ``hashLong(unscaled)``, so the reference's hash of this bigint
#: column is Spark's hash of ``k`` (its own has no decimal murmur3)
KEYS_UNSCALED = pa.array([None if v is None else int(v.scaleb(2))
                          for v in KEYS.column("k").to_pylist()], pa.int64())


@pytest.fixture(scope="module")
def ref_key_answers(ref_session):
    """The reference's answers from its host engine; the hashes over the
    unscaled bigint column."""
    import spark_rapids_tpu.functions as RF
    df = ref_session.createDataFrame(KEYS.select(["k", "v"]))
    dim = ref_session.createDataFrame(DIM)
    out = {k: q.collect() for k, q in _key_queries(RF, df, dim).items()}
    u = ref_session.createDataFrame(pa.table({"k": KEYS_UNSCALED,
                                              "v": KEYS.column("v")}))
    out["hash"] = u.select(RF.hash(RF.col("k")).alias("h"),
                           RF.xxhash64(RF.col("k")).alias("x"),
                           RF.hash(RF.col("k"), RF.col("v")).alias("hv")
                           ).collect()
    return out


@pytest.mark.parametrize("device", [True, False], ids=["device", "host"])
@pytest.mark.parametrize("query", ["group", "sort", "join", "hash"])
def test_decimal64_keys_and_hashes_match_reference(query, device,
                                                    ref_key_answers):
    s = _port(device)
    df = s.createDataFrame(KEYS.select(["k", "v"]))
    dim = s.createDataFrame(DIM)
    if query == "hash":
        q = df.select(TF.hash(TF.col("k")).alias("h"),
                      TF.xxhash64(TF.col("k")).alias("x"),
                      TF.hash(TF.col("k"), TF.col("v")).alias("hv"))
    else:
        q = _key_queries(TF, df, dim)[query]
    assert q.collect() == ref_key_answers[query]


def test_shuffle_by_decimal_key_matches_reference(ref_key_answers):
    """The hash exchange partitions a decimal64 key as Spark's
    ``pmod(hashLong(unscaled), n)``: each key's partition is the one the
    reference's own hash of the unscaled value gives."""
    s = _port(True, **{"spark.sql.shuffle.partitions": "3"})
    q = s.createDataFrame(KEYS.select(["k", "v"])).repartition(3, "k")
    want = {}
    for v, r in zip(KEYS.column("k").to_pylist(), ref_key_answers["hash"]):
        if v is not None:
            want[v] = r["h"] % 3
    seen = 0
    for pid, batches in enumerate(q._device_partitions()):
        for b in batches:
            for k in b.columns[0].to_pylist():
                if k is not None:
                    assert want[k] == pid
                    seen += 1
    assert seen == len([v for v in KEYS.column("k").to_pylist()
                        if v is not None])


def _murmur3_bytes(data: bytes, seed: int) -> int:
    """Spark's ``Murmur3_x86_32.hashUnsafeBytes`` (4-byte words, then each
    tail byte as a signed int), in Python."""
    M = 0xFFFFFFFF

    def mix_k(k):
        k = (k * 0xCC9E2D51) & M
        k = ((k << 15) | (k >> 17)) & M
        return (k * 0x1B873593) & M

    def mix_h(h, k):
        h ^= k
        h = ((h << 13) | (h >> 19)) & M
        return (h * 5 + 0xE6546B64) & M

    h = seed & M
    n4 = len(data) // 4 * 4
    for i in range(0, n4, 4):
        h = mix_h(h, mix_k(int.from_bytes(data[i:i + 4], "little")))
    for b in data[n4:]:
        h = mix_h(h, mix_k((b - 256 if b > 127 else b) & M))
    h ^= len(data)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M
    h ^= h >> 16
    return h - (1 << 32) if h >= 1 << 31 else h


@pytest.mark.parametrize("device", [True, False], ids=["device", "host"])
def test_decimal128_hash_is_sparks_bytes_hash(device):
    """Past precision 18 Spark hashes ``BigInteger.toByteArray()`` of the
    unscaled value; two-limb keys group and join in the host engine."""
    s = _port(device)
    df = s.createDataFrame(KEYS.select(["w"]))
    got = [r["h"] for r in df.select(TF.hash(TF.col("w")).alias("h"))
           .collect()]
    want = []
    for v in KEYS.column("w").to_pylist():
        if v is None:
            want.append(42)
            continue
        u = int(v.scaleb(1))
        n = (u.bit_length() if u >= 0 else (~u).bit_length()) // 8 + 1
        want.append(_murmur3_bytes(u.to_bytes(n, "big", signed=True), 42))
    assert got == want


def test_decimal128_keys_run_in_the_host_engine():
    """A two-limb group, sort or join key stays off the card with its
    reason (ROADMAP A6) and runs in the host engine."""
    s = _port(False)
    df = s.createDataFrame(KEYS)
    got = df.groupBy("w").agg(TF.count(TF.col("v")).alias("n")) \
        .orderBy("w").collect()
    ws = sorted({v for v in KEYS.column("w").to_pylist() if v is not None})
    assert [r["w"] for r in got] == [None] + ws
    dev = TorchSession({}, device="cpu")
    q = dev.createDataFrame(KEYS).groupBy("w").agg(
        TF.count(TF.col("v")).alias("n"))
    assert "decimal128 keys not yet ported, ROADMAP A6" in \
        q.explain_fallback()
    assert q.orderBy("w").collect() == got


WIN = pa.table({
    "g": pa.array([1, 1, 1, 1, 2, 2, 3], pa.int64()),
    "o": pa.array([1, 2, 3, 4, 1, 2, 1], pa.int64()),
    "v": pa.array([DEC_("1.00"), DEC_("2.00"), None, DEC_("2.00"),
                   DEC_("5.55"), DEC_("-0.01"), None], pa.decimal128(12, 2)),
    "w": pa.array([DEC_("9" * 37)] * 4 + [DEC_("9" * 38)] * 2 + [DEC_(1)],
                  pa.decimal128(38, 0)),
})


@pytest.mark.parametrize("device", [True, False], ids=["device", "host"])
def test_decimal_window_aggregates(device):
    """Window sum/avg/min/max over decimals, on the card (the window exec's
    decimal frames) and in the host engine: exact frame sums with Spark's
    types, its avg rounding, null past the sum type (group 2's two
    38-digit values), and ANSI's error."""
    from spark_rapids_tpu_torch.window import Window
    s = TorchSession({}, device="cpu") if device else _port(False)
    w = Window.partitionBy("g").orderBy("o")
    q = s.createDataFrame(WIN).select(
        "g", "o", TF.sum(TF.col("v")).over(w).alias("s"),
        TF.avg(TF.col("v")).over(w).alias("a"),
        TF.min(TF.col("v")).over(w).alias("mn"),
        TF.sum(TF.col("w")).over(Window.partitionBy("g")).alias("sw"))
    if device:
        assert "ROADMAP A6" not in q.explain_fallback()
    got = q.orderBy("g", "o").collect()
    rows = WIN.to_pylist()
    want = []
    for r in rows:
        frame = [x for x in rows if x["g"] == r["g"] and x["o"] <= r["o"]]
        vs = [x["v"] for x in frame if x["v"] is not None]
        with decimal.localcontext(decimal.Context(prec=100)):
            total = sum(x["w"] for x in rows if x["g"] == r["g"])
            quot = sum(vs) / len(vs) if vs else None
        want.append({
            "g": r["g"], "o": r["o"], "s": _q(sum(vs), 2) if vs else None,
            "a": _q(_q(quot, 18), 6) if vs else None,
            "mn": min(vs) if vs else None,
            "sw": total if abs(total) < DEC_(10) ** 38 else None})
    assert got == want
    with pytest.raises(ExpressionError, match="decimal overflow in sum"):
        (TorchSession(ANSI, device="cpu") if device
         else _port(False, **ANSI)).createDataFrame(WIN).select(
            TF.sum(TF.col("w")).over(Window.partitionBy("g")).alias("sw")) \
            .collect()


# ---------------------------------------------------------------------------
# scan, writer, cache
# ---------------------------------------------------------------------------

FILE = pa.table({
    "p": pa.array([DEC_(i) / 8 for i in range(-40, 60)] + [None] * 4,
                  pa.decimal128(12, 3)),
    "q": pa.array([DEC_(i * 7919) / 100 for i in range(104)],
                  pa.decimal128(9, 2)),
    "w": pa.array([DEC_("1" * 25) + DEC_(i) / 4 for i in range(104)],
                  pa.decimal128(30, 2)),
    "i": pa.array(np.arange(104), pa.int64()),
})


@pytest.mark.parametrize("as_int", [True, False], ids=["int", "flba"])
def test_parquet_decimals(tmp_path, as_int):
    """INT32/INT64-backed decimals decode on the device as their
    integers; FIXED_LEN_BYTE_ARRAY (pyarrow's default) decodes on the
    host per column, counted in ``fallback_columns``; both equal
    ``pq.read_table``."""
    p = str(tmp_path / "d.parquet")
    pq.write_table(FILE, p, store_decimal_as_integer=as_int,
                   row_group_size=40)
    s = _port(True)
    got = s.read.parquet(p).collect()
    assert got == pq.read_table(p).to_pylist()
    # the wide column is FLBA in both files; the narrow ones only in one
    want_fallback = (1 if as_int else 3) * 3
    assert s.counters["fallback_columns"] == want_fallback
    q = s.read.parquet(p).filter(TF.col("q") > TF.lit(DEC_("20"))) \
        .agg(TF.sum(TF.col("p")).alias("s")).collect()
    rows = [r for r in FILE.to_pylist() if r["q"] > 20]
    exact = decimal.Context(prec=100)
    total = DEC_("0.000")
    for r in rows:
        if r["p"] is not None:
            total = exact.add(total, r["p"])
    assert q == [{"s": total}]


@pytest.mark.parametrize("device", [True, False], ids=["device", "host"])
def test_writer_and_cache_roundtrip(tmp_path, device):
    s = _port(device)
    df = s.createDataFrame(FILE)
    out = str(tmp_path / "w")
    df.write.mode("overwrite").parquet(out)
    back = pq.read_table(out)
    assert back.schema.field("w").type == pa.decimal128(30, 2)
    assert sorted(back.to_pylist(), key=lambda r: r["i"]) == FILE.to_pylist()
    cached = s.createDataFrame(FILE).cache()
    assert cached.count() == 104
    assert cached.orderBy("i").collect() == FILE.to_pylist()
    exact = decimal.Context(prec=100)
    total = DEC_(0)
    for v in FILE.column("w").to_pylist():
        total = exact.add(total, v)
    assert cached.agg(TF.sum(TF.col("w")).alias("s")).collect() == \
        [{"s": total}]


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_spill_roundtrip_of_limb_columns(tier):
    """A batch with [n, 2] columns spilled to the host (or through it to
    disk) and read back byte for byte."""
    from spark_rapids_tpu_torch.memory import spill
    from spark_rapids_tpu_torch.memory.hbm import HbmBudget
    HbmBudget.reset_for_tests(budget_bytes=1 << 30)
    spill.TorchBufferCatalog.reset_for_tests()
    try:
        cat = spill.TorchBufferCatalog.get()
        if tier == "disk":
            cat.host_limit = 1  # the host tier overflows straight to disk
        batch = TorchColumnarBatch.from_arrow(FILE).to_device("cpu")
        snap = [t.clone() for c in batch.columns
                for t in (c.data, c.validity) if t is not None]
        sb = spill.SpillableColumnarBatch(batch)
        del batch
        assert cat.synchronous_spill(1 << 40) > 0
        assert (cat.spilled_to_disk > 0) == (tier == "disk")
        back = sb.get_batch()
        got = [t for c in back.columns for t in (c.data, c.validity)
               if t is not None]
        assert back.columns[2].data.shape == (back.capacity, 2)
        assert all(torch.equal(a, b) for a, b in zip(got, snap))
        assert back.to_arrow().to_pylist() == FILE.to_pylist()
        sb.close()
    finally:
        spill.TorchBufferCatalog.reset_for_tests()
        HbmBudget.reset_for_tests()


def test_python_decimal_rows_and_collect():
    """``createDataFrame`` of Python ``Decimal`` rows (PySpark's
    decimal(38, 18)) and of DDL rows; ``collect()`` gives Decimals at the
    column's scale; ``show`` and ``toPandas`` carry them."""
    s = _port(True)
    df = s.createDataFrame([{"a": DEC_("1.5")}, {"a": None},
                            {"a": DEC_("-2")}])
    assert df.schema.fields[0].data_type == PT.DecimalType(38, 18)
    got = df.collect()
    assert [str(r["a"]) for r in got if r["a"] is not None] == \
        ["1.500000000000000000", "-2.000000000000000000"]
    assert got[1]["a"] is None
    pdf = s.createDataFrame(FILE).toPandas()
    assert list(pdf["q"][:2]) == FILE.column("q").to_pylist()[:2]


@pytest.mark.parametrize("device", [True, False], ids=["device", "host"])
def test_decimal_aggregate_overflow(device):
    """A sum past its type's 38 digits is null, and so is the avg over
    it; min/max/first/last keep the value; under ANSI the card and the
    host engine raise the same error. Group 3's exact sum passes 2^127
    (where Arrow's decimal sum wraps back under 10^38)."""
    big = DEC_("9" * 38)
    t = pa.table({"g": pa.array([1, 1, 2, 2, 3, 3, 3], pa.int64()),
                  "v": pa.array([big, big, big, DEC_(-1), big, big, big],
                                pa.decimal128(38, 0))})
    got = _port(device).createDataFrame(t).groupBy("g").agg(
        TF.sum(TF.col("v")).alias("s"), TF.avg(TF.col("v")).alias("a"),
        TF.max(TF.col("v")).alias("mx"), TF.min(TF.col("v")).alias("mn"),
        TF.first(TF.col("v")).alias("f")).orderBy("g").collect()
    # group 2's sum fits; its avg, (10^38 - 2) / 2 at Spark's (38, 6)
    # quotient, has 44 digits: null
    assert got == [
        {"g": 1, "s": None, "a": None, "mx": big, "mn": big, "f": big},
        {"g": 2, "s": DEC_("9" * 37 + "8"), "a": None, "mx": big,
         "mn": DEC_(-1), "f": big},
        {"g": 3, "s": None, "a": None, "mx": big, "mn": big, "f": big}]
    for fn in ("sum", "avg"):
        with pytest.raises(ExpressionError,
                           match=f"decimal overflow in {fn}"):
            _port(device, **ANSI).createDataFrame(t).groupBy("g").agg(
                getattr(TF, fn)(TF.col("v")).alias("x")).collect()


@pytest.mark.parametrize("device", [True, False], ids=["device", "host"])
def test_decimal_global_aggregate_over_chunks(device):
    """An ungrouped decimal sum/avg/min/max over more than batchSizeRows
    rows merges per-chunk states on the card (``global_chunked_runs``),
    one lane and two limbs, exact against Python's decimals; a sum that
    passes its type only across chunks is null, ANSI an error."""
    rng = np.random.default_rng(15)
    n = 3000
    a = [None if i % 97 == 0 else DEC_(int(x)).scaleb(-2)
         for i, x in enumerate(rng.integers(-10**11, 10**11, n))]
    w = [DEC_(int(x)).scaleb(-3) * 10**18
         for x in rng.integers(-10**15, 10**15, n)]
    t = pa.table({"a": pa.array(a, pa.decimal128(12, 2)),
                  "w": pa.array(w, pa.decimal128(37, 3))})
    conf = {"spark.rapids.sql.batchSizeRows": "1000"}
    s = _port(device, **conf)
    df = s.createDataFrame(t, num_partitions=4)
    got = df.agg(*[getattr(TF, f)(TF.col(c)).alias(f"{f}_{c}")
                   for c in ("a", "w")
                   for f in ("sum", "avg", "min", "max")]).collect()[0]
    for c, vals, (p, sc) in (("a", a, (12, 2)), ("w", w, (37, 3))):
        vs = [v for v in vals if v is not None]
        total = sum(vs)
        assert got[f"sum_{c}"] == _q(total, sc)
        # Spark's avg: HALF_UP at the Divide's scale, 38 less the sum
        # type's integral digits (at least 6), then at s + 4
        quot = decimal.Context(prec=100).divide(total, DEC_(len(vs)))
        q_scale = max(38 - (min(p + 10, 38) - sc), 6)
        assert got[f"avg_{c}"] == _q(_q(quot, q_scale), min(sc + 4, 38))
        assert got[f"min_{c}"] == min(vs) and got[f"max_{c}"] == max(vs)
    if device:
        assert s.counters["global_chunked_runs"] == 1
    # each chunk's sum fits decimal(38, 0); the whole one does not
    big = pa.table({"v": pa.array([DEC_(10) ** 37 * 6] * 8 * 250,
                                  pa.decimal128(38, 0))})
    row = _port(device, **conf).createDataFrame(big, num_partitions=8).agg(
        TF.sum(TF.col("v")).alias("s")).collect()[0]
    assert row["s"] is None
    with pytest.raises(ExpressionError, match="decimal overflow in sum"):
        _port(device, **conf, **ANSI).createDataFrame(
            big, num_partitions=8).agg(TF.sum(TF.col("v")).alias("s")) \
            .collect()


@pytest.mark.parametrize("device", [True, False], ids=["device", "host"])
def test_conditionals_and_null_tests_carry_decimals(device):
    """If/CASE WHEN, coalesce, greatest, IN, IS NULL, negation and abs
    over one-lane and two-limb decimals: Spark's wider types, exact."""
    df = _port(device).createDataFrame(KEYS)
    q = df.select(
        TF.when(TF.col("v") > 3, TF.col("k")).otherwise(TF.col("w"))
        .alias("cw"),
        TF.coalesce(TF.col("w"), TF.col("k")).alias("co"),
        TF.greatest(TF.col("k"), TF.lit(DEC_("2"))).alias("g"),
        TF.col("k").isin(1.5, 3).alias("isin"),
        TF.col("w").isNull().alias("wn"),
        (-TF.col("w")).alias("neg"), TF.abs(TF.col("k")).alias("a"))
    types = [f.data_type for f in q.schema.fields]
    assert types[:3] == [PT.DecimalType(31, 2), PT.DecimalType(30, 1),
                         PT.DecimalType(10, 2)]
    rows = KEYS.to_pylist()
    want = []
    for r in rows:
        k, w, v = r["k"], r["w"], r["v"]
        want.append({
            "cw": None if (k if v > 3 else w) is None
            else _q(k if v > 3 else w, 2),
            "co": w if w is not None else (None if k is None else _q(k, 1)),
            "g": _q(max(k, DEC_(2)), 2) if k is not None else _q(2, 2),
            "isin": None if k is None else k in (DEC_("1.5"), DEC_(3)),
            "wn": w is None, "neg": None if w is None else -w,
            "a": None if k is None else abs(k)})
    got = q.collect()
    assert got == want
    assert [str(r["cw"]) for r in got] == [str(r["cw"]) for r in want]
