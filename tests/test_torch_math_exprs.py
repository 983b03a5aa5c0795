"""The math family, the rest of integral arithmetic with ANSI checks,
bitwise, NaN and null handling and ``greatest``/``least`` of the port held
to the reference on the CPU.

The same seeded numpy rows go through the reference's ``eval_tpu`` (JAX's
CPU backend) and ``eval_cpu`` and through the port's ``eval_device`` and
``eval_cpu`` (``device="cpu"``). Integers, booleans and null masks are
exact; floats match within rtol 1e-12 and atol 1e-15 (for results near
zero), with the same NaN, ±inf and null positions. The port's two sides
are bit-identical (its host evaluation runs the device code on CPU
tensors).

Where the reference departs from Spark the port is held to Spark (a numpy
oracle of Spark's formula) and the reference's answer is recorded: the
case is in ``SPARK`` and the test asserts the reference differs on the
rows named there (ROADMAP Queue C, C-ref-25 to C-ref-31).
"""

import collections
import functools
import math

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu.functions as RF
import spark_rapids_tpu_torch.functions as TF
from spark_rapids_tpu import types as RT
from spark_rapids_tpu.columnar.batch import TpuColumnarBatch
from spark_rapids_tpu.columnar.vector import TpuColumnVector
from spark_rapids_tpu.config import RapidsConf as RefConf
from spark_rapids_tpu.expressions import (arithmetic as RA, base as RB,
                                          bitwise as RBW, conditional as RCO,
                                          mathexprs as RM, nullexprs as RN)
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar.batch import TorchColumnarBatch
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.expressions import (arithmetic as PA, base as PB,
                                                bitwise as PBW,
                                                conditional as PCO,
                                                mathexprs as PM,
                                                nullexprs as PN)
from spark_rapids_tpu_torch.memory.device import TorchDeviceManager
from spark_rapids_tpu_torch.session import TorchSession

TorchDeviceManager.initialize(device="cpu", total_bytes=8 << 30)

RTOL, ATOL = 1e-12, 1e-15
NAN, INF = float("nan"), float("inf")
I32 = (-2 ** 31, 2 ** 31 - 1)
I64 = (-2 ** 63, 2 ** 63 - 1)


class _Ns:
    def __init__(self, base, mods):
        self.Lit = base.Literal
        self.Attr = base.AttributeReference
        for mod in mods:
            for k in dir(mod):
                if not k.startswith("_"):
                    setattr(self, k, getattr(mod, k))


REF = _Ns(RB, (RA, RBW, RCO, RM, RN))
PORT = _Ns(PB, (PA, PBW, PCO, PM, PN))


@functools.lru_cache(maxsize=None)
def table() -> pa.Table:
    """Seeded rows: doubles with NaN, ±0.0, ±inf, subnormals, ties and
    values in [-1, 1]; ints and longs with their ends, -1 and 0; divisors
    with 0 and -1; narrow ints; one row in ten null a column."""
    rng = np.random.default_rng(14)
    n = 96
    special = [NAN, 0.0, -0.0, INF, -INF, 5e-324, -1e-310, 1e-10, -1e-10,
               0.5, -0.5, 1.0, -1.0, 2.675, 1.005, 0.285, 2.5, -2.5, 1e308,
               -1e300, 3.0, 1.5, 0.125, -7.0]
    x = np.concatenate([special, rng.normal(0, 10, 36),
                        rng.uniform(-1, 1, n - 36 - len(special))])
    y_special = [2.0, NAN, INF, -INF, 0.0, 0.5, -3.0, 1.0, 0.5, 1.0, 2.0,
                 NAN, INF]
    y = np.concatenate([y_special, rng.normal(0, 3, n - len(y_special))])
    j = rng.integers(-1000, 1000, n)
    j[:6] = [I32[0], I32[1], 0, -1, 1, -7]
    k = rng.integers(-9, 9, n)
    k[:6] = [-1, 0, 3, -3, 7, -1]
    i = rng.integers(-2 ** 40, 2 ** 40, n)
    i[:6] = [I64[0], I64[1], 0, -1, 1, -7]
    ln = rng.integers(-9, 9, n)
    ln[:6] = [-1, 0, 3, -3, 7, -1]

    def nulls(s):
        m = np.random.default_rng(200 + s).random(n) < 0.1
        m[:6] = False
        return m

    return pa.table({
        "x": pa.array(x, pa.float64(), mask=nulls(1)),
        "y": pa.array(y, pa.float64(), mask=nulls(2)),
        "j": pa.array(j, pa.int32(), mask=nulls(3)),
        "k": pa.array(k, pa.int32(), mask=nulls(4)),
        "i": pa.array(i, pa.int64(), mask=nulls(5)),
        "l": pa.array(ln, pa.int64(), mask=nulls(6)),
        "b8": pa.array(np.resize(np.array([-1, -128, 127, 0, 5], np.int8), n),
                       pa.int8()),
        "f": pa.array(x.astype(np.float32), pa.float32(), mask=nulls(7)),
    })


def _attrs(ns, types_mod, tbl):
    return {f.name: ns.Attr(f.name, types_mod.from_arrow(f.type), True,
                            ordinal=i) for i, f in enumerate(tbl.schema)}


def _rows(x, n):
    if isinstance(x, (pa.Array, pa.ChunkedArray)):
        return x.to_pylist()
    return [x.as_py() if isinstance(x, pa.Scalar) else x] * n


@functools.lru_cache(maxsize=None)
def reference_rows(case: str, ansi: bool = False):
    """(eval_tpu rows, eval_cpu rows) of the reference; a side that raises
    gives its exception (recorded as the departure)."""
    tbl = table()
    expr = CASES[case](REF, _attrs(REF, RT, tbl))
    ctx = RB.EvalContext(RefConf({"spark.sql.ansi.enabled": str(ansi)}))
    cols = [TpuColumnVector.from_arrow(c.combine_chunks())
            for c in tbl.columns]
    batch = TpuColumnarBatch(cols, tbl.num_rows, names=tbl.column_names)
    out = []
    for side in (lambda: expr.eval_tpu(batch, ctx).to_arrow().to_pylist()
                 [:tbl.num_rows],
                 lambda: _rows(expr.eval_cpu(tbl, ctx), tbl.num_rows)):
        try:
            out.append(side())
        except Exception as e:  # noqa: BLE001 — the caller asserts on it
            out.append(e)
    return tuple(out)


def port_rows(case: str, ansi: bool = False):
    tbl = table()
    expr = CASES[case](PORT, _attrs(PORT, PT, tbl))
    ctx = PB.EvalContext(RapidsConf({"spark.sql.ansi.enabled": str(ansi)}),
                         counters=collections.Counter())
    batch = TorchColumnarBatch.from_arrow(tbl)
    dev = PB.to_column(expr.eval_device(batch, ctx), batch, expr.dtype)
    return dev.to_pylist(), _rows(expr.eval_cpu(tbl, ctx), tbl.num_rows)


def _same(x, y) -> bool:
    if x is None or y is None:
        return x is None and y is None
    if isinstance(x, float) or isinstance(y, float):
        x, y = float(x), float(y)
        if math.isnan(x) or math.isnan(y):
            return math.isnan(x) and math.isnan(y)
        if math.isinf(x) or math.isinf(y):
            return x == y
        return abs(x - y) <= ATOL + RTOL * abs(y)
    return x == y and type(x) is type(y)


def _diff(a, b):
    return [i for i, (x, y) in enumerate(zip(a, b)) if not _same(x, y)]


def _java_long(v):
    v = np.where(np.isnan(v), 0.0, v)
    out = np.where(np.abs(v) < 2.0 ** 63, v, 0.0).astype(np.int64)
    out = np.where(v >= 2.0 ** 63, I64[1], out)
    return np.where(v <= -2.0 ** 63, I64[0], out)


#: Spark's unary functions as numpy oracles (Java's Math/StrictMath, and
#: Spark's own formulas for asinh, acosh and atanh)
ORACLE = {
    "Sqrt": np.sqrt, "Cbrt": np.cbrt, "Exp": np.exp, "Expm1": np.expm1,
    "Sin": np.sin, "Cos": np.cos, "Tan": np.tan, "Asin": np.arcsin,
    "Acos": np.arccos, "Atan": np.arctan, "Sinh": np.sinh, "Cosh": np.cosh,
    "Tanh": np.tanh, "Cot": lambda x: 1.0 / np.tan(x),
    "ToDegrees": lambda x: x * 57.29577951308232,
    "ToRadians": lambda x: x * 0.017453292519943295, "Rint": np.rint,
    "Signum": lambda x: np.where(x > 0, 1.0, np.where(x < 0, -1.0, x)),
    "Log": np.log, "Log10": np.log10, "Log2": np.log2, "Log1p": np.log1p,
    "Ceil": lambda x: _java_long(np.ceil(x)),
    "Floor": lambda x: _java_long(np.floor(x)),
    "Asinh": lambda x: np.where(x == -INF, -INF,
                                np.log(x + np.sqrt(x * x + 1.0))),
    "Acosh": lambda x: np.log(x + np.sqrt(x * x - 1.0)),
    "Atanh": lambda x: 0.5 * (np.log1p(x) - np.log1p(-x)),
}
#: the log family's null: at or below the asymptote (not for NaN)
ASYMPTOTE = {"Log": 0.0, "Log10": 0.0, "Log2": 0.0, "Log1p": -1.0}
#: the x rows holding subnormals: the reference's XLA CPU backend flushes
#: them to zero (C-ref-25), so its device rows depart there
SUBNORMAL = {5, 6}
#: Spark's formulas where C's functions differ: a row where the
#: reference's answer departs beyond the tolerance (C-ref-26)
SPARK_FORMULA = {"Asinh": {"x": 19, "j": 0}, "Acosh": {"x": 18, "j": 0},
                 "Atanh": {}}


def _oracle_rows(name: str, col: str):
    vals = table().column(col).to_pylist()
    if col == "j" and name in ("Ceil", "Floor"):
        return vals
    x = np.array([0.0 if v is None else float(v) for v in vals])
    with np.errstate(all="ignore"):
        out = ORACLE[name](x)
    lo = ASYMPTOTE.get(name)
    return [None if v is None or (lo is not None and x[i] <= lo)
            else (int(o) if name in ("Ceil", "Floor") else float(o))
            for i, (v, o) in enumerate(zip(vals, out))]


UNARY_CASES = [(name, col) for name in sorted(ORACLE) for col in ("x", "j")]


def _unary_case(name, col):
    return lambda M, a: getattr(M, name)(a[col])


@pytest.mark.parametrize("name,col", UNARY_CASES)
def test_unary_math_matches_spark_and_the_reference(name, col):
    """The port's device and host rows are identical and match Spark's
    function (numpy) on every row; they match the reference's device rows
    but where it flushes a subnormal to zero or departs from Spark's
    formula, and its host rows but where its host gives a NaN input's log
    null (C-ref-27)."""
    case = f"{name.lower()}_{col}"
    CASES.setdefault(case, _unary_case(name, col))
    dev, host = port_rows(case)
    assert not _diff(dev, host)
    want = _oracle_rows(name, col)
    bad = _diff(dev, want)
    assert not bad, [(i, dev[i], want[i]) for i in bad][:5]
    ref_dev, ref_cpu = reference_rows(case)
    skip = SUBNORMAL if col == "x" else set()
    if name in SPARK_FORMULA:
        row = SPARK_FORMULA[name].get(col)
        if row is not None:
            assert not _same(ref_dev[row], dev[row]), (row, ref_dev[row])
        return
    bad = [i for i in _diff(dev, ref_dev) if i not in skip]
    assert not bad, [(i, dev[i], ref_dev[i]) for i in bad][:5]
    nan_null = {i for i, v in enumerate(table().column(col).to_pylist())
                if v is not None and v != v and name in ASYMPTOTE}
    bad = [i for i in _diff(dev, ref_cpu) if i not in skip | nan_null]
    assert not bad, [(i, dev[i], ref_cpu[i]) for i in bad][:5]
    for i in nan_null:
        assert math.isnan(dev[i]) and ref_cpu[i] is None


CASES = {
    "pow": lambda M, a: M.Pow(a["x"], a["y"]),
    "pow_int": lambda M, a: M.Pow(a["j"], M.Lit(2)),
    "atan2": lambda M, a: M.Atan2(a["x"], a["y"]),
    "hypot": lambda M, a: M.Hypot(a["x"], a["y"]),
    "logarithm": lambda M, a: M.Logarithm(M.Lit(2.0), a["x"]),
    "logarithm_cols": lambda M, a: M.Logarithm(a["y"], a["x"]),
    "bround_0": lambda M, a: M.BRound(a["x"], M.Lit(0)),
    "bround_2": lambda M, a: M.BRound(a["x"], M.Lit(2)),
    "bround_int_neg": lambda M, a: M.BRound(a["i"], M.Lit(-1)),
    # integral arithmetic
    "div_long": lambda M, a: M.IntegralDivide(a["i"], a["l"]),
    "div_int": lambda M, a: M.IntegralDivide(a["j"], a["k"]),
    "rem_long": lambda M, a: M.Remainder(a["i"], a["l"]),
    "rem_int": lambda M, a: M.Remainder(a["j"], a["k"]),
    "rem_double": lambda M, a: M.Remainder(a["x"], a["y"]),
    "pmod_long": lambda M, a: M.Pmod(a["i"], a["l"]),
    "pmod_int_pos": lambda M, a: M.Pmod(a["j"], M.Lit(7)),
    "pmod_double": lambda M, a: M.Pmod(a["x"], M.Lit(3.0)),
    "neg_int": lambda M, a: M.UnaryMinus(a["j"]),
    "neg_long": lambda M, a: M.UnaryMinus(a["i"]),
    "neg_double": lambda M, a: M.UnaryMinus(a["x"]),
    "pos_int": lambda M, a: M.UnaryPositive(a["j"]),
    "abs_long": lambda M, a: M.Abs(a["i"]),
    "add_long": lambda M, a: M.Add(a["i"], a["i"]),
    "divide_double": lambda M, a: M.Divide(a["x"], a["y"]),
    # bitwise
    "or": lambda M, a: M.BitwiseOr(a["i"], a["l"]),
    "xor": lambda M, a: M.BitwiseXor(a["j"], a["k"]),
    "not": lambda M, a: M.BitwiseNot(a["i"]),
    "bit_count_long": lambda M, a: M.BitwiseCount(a["i"]),
    "bit_count_int": lambda M, a: M.BitwiseCount(a["j"]),
    "bit_count_byte": lambda M, a: M.BitwiseCount(a["b8"]),
    "shl_int": lambda M, a: M.ShiftLeft(a["j"], a["k"]),
    "shl_long": lambda M, a: M.ShiftLeft(a["i"], M.Lit(70)),
    "shr_long": lambda M, a: M.ShiftRight(a["i"], a["k"]),
    "shru_long": lambda M, a: M.ShiftRightUnsigned(a["i"], a["k"]),
    "shru_int": lambda M, a: M.ShiftRightUnsigned(a["j"], M.Lit(28)),
    "shru_long_0": lambda M, a: M.ShiftRightUnsigned(a["i"], M.Lit(64)),
    # NaN and nulls
    "isnan": lambda M, a: M.IsNaN(a["x"]),
    "isnan_float": lambda M, a: M.IsNaN(a["f"]),
    "nanvl": lambda M, a: M.NaNvl(a["x"], a["y"]),
    "at_least_0": lambda M, a: M.AtLeastNNonNulls(0, a["x"], a["j"]),
    "at_least_1": lambda M, a: M.AtLeastNNonNulls(1, a["x"], a["j"]),
    "at_least_2": lambda M, a: M.AtLeastNNonNulls(2, a["x"], a["j"]),
    "at_least_3": lambda M, a: M.AtLeastNNonNulls(3, a["x"], a["j"],
                                                  a["f"]),
    "at_least_scalars": lambda M, a: M.AtLeastNNonNulls(
        2, M.Lit(5.0), M.Lit(NAN), M.Lit(None, a["x"].dtype), a["x"]),
    "known_not_null": lambda M, a: M.KnownNotNull(a["x"]),
    "known_normalized": lambda M, a: M.KnownFloatingPointNormalized(a["x"]),
    "normalize": lambda M, a: M.NormalizeNaNAndZero(a["x"]),
    "greatest": lambda M, a: M.Greatest(a["x"], a["y"]),
    "least": lambda M, a: M.Least(a["x"], a["y"]),
    "greatest_ints": lambda M, a: M.Greatest(a["j"], a["k"],
                                             M.Lit(None, a["j"].dtype)),
    "least_longs": lambda M, a: M.Least(a["i"], a["l"]),
}
OTHER_CASES = sorted(CASES)


def _spark_pow():
    x = np.asarray(table().column("x").to_numpy(zero_copy_only=False))
    y = np.asarray(table().column("y").to_numpy(zero_copy_only=False))
    with np.errstate(all="ignore"):
        out = np.power(x, y)
    out = np.where(np.isnan(y) | ((np.abs(x) == 1) & np.isinf(y)), NAN, out)
    return [None if (a is None or b is None) else float(o) for a, b, o in
            zip(table().column("x").to_pylist(),
                table().column("y").to_pylist(), out)]


def _spark_rem_double():
    out = []
    for a, b in zip(table().column("x").to_pylist(),
                    table().column("y").to_pylist()):
        out.append(None if a is None or b is None or b == 0
                   else NAN if math.isinf(a) or math.isnan(a)
                   or math.isnan(b) else math.fmod(a, b))
    return out


def _jrem(p, q):
    """Java's % of two longs (the dividend's sign)."""
    r = abs(p) % abs(q)
    return -r if p < 0 else r


def _spark_pmod_long():
    out = []
    for a, n in zip(table().column("i").to_pylist(),
                    table().column("l").to_pylist()):
        if a is None or n is None or n == 0:
            out.append(None)
            continue
        r = _jrem(a, n)
        out.append(_jrem(((r + n + 2 ** 63) % 2 ** 64) - 2 ** 63, n)
                   if r < 0 else r)
    return out


def _spark_int_op(op, a, b):
    """Java's long ``/`` or ``%`` (a zero divisor null, as Spark)."""
    def rows():
        out = []
        for p, q in zip(table().column(a).to_pylist(),
                        table().column(b).to_pylist()):
            if p is None or q is None or q == 0:
                out.append(None)
            elif op == "rem":
                out.append(_jrem(p, q))
            else:
                v = abs(p) // abs(q) * (1 if (p < 0) == (q < 0) else -1)
                out.append(((v + 2 ** 63) % 2 ** 64) - 2 ** 63)
        return out
    return rows


def _spark_greatest():
    out = []
    for p, q in zip(table().column("x").to_pylist(),
                    table().column("y").to_pylist()):
        vals = [v for v in (p, q) if v is not None]
        out.append(None if not vals else NAN if any(v != v for v in vals)
                   else max(vals))
    return out


def _spark_bit_count(col):
    return lambda: [None if v is None else bin(v & (2 ** 64 - 1)).count("1")
                    for v in table().column(col).to_pylist()]


def _spark_bround(scale):
    import decimal

    def rows():
        out = []
        for v in table().column("x").to_pylist():
            if v is None or not math.isfinite(v):
                out.append(v)
                continue
            d = decimal.Decimal(repr(v))
            q = decimal.Decimal(1).scaleb(-scale)
            out.append(float(d.quantize(q, rounding=decimal.ROUND_HALF_EVEN))
                       + 0.0 if d.as_tuple().exponent < -scale else v)
        return out
    return rows


#: the port gives Spark's answer where the reference departs: case →
#: (Spark's rows, the row where the reference's device departs, the row
#: where its host departs or raises); None: that side equals the port
SPARK = {
    "pow": (_spark_pow, 11, 11),
    "rem_double": (_spark_rem_double, 4, 4),
    "pmod_long": (_spark_pmod_long, 3, 3),
    "bit_count_int": (_spark_bit_count("j"), 3, 3),
    "bit_count_byte": (_spark_bit_count("b8"), 0, 0),
    "bround_2": (_spark_bround(2), 18, 18),
    "div_long": (_spark_int_op("div", "i", "l"), None, 0),
    "rem_long": (_spark_int_op("rem", "i", "l"), None, 0),
    "rem_int": (_spark_int_op("rem", "j", "k"), None, 0),
    "greatest": (_spark_greatest, None, 0),
}
#: cases whose reference host raises (pyarrow: rounding a long past its
#: range, a null literal in max_element_wise); the port equals the
#: reference's device rows
REF_CPU_DEPARTS = {"bround_int_neg", "greatest_ints"}


@pytest.mark.parametrize("case", OTHER_CASES)
def test_scalar_function_matches_the_reference(case):
    """The port's device and host rows are identical; they match the
    reference's device and host rows within the stated tolerance (but on
    the subnormal rows the reference flushes), or Spark's where the
    reference departs (and the departure is recorded)."""
    dev, host = port_rows(case)
    assert not _diff(dev, host) and [type(v) for v in dev] == \
        [type(v) for v in host]
    ref_dev, ref_cpu = reference_rows(case)
    if case in SPARK:
        oracle, dev_row, cpu_row = SPARK[case]
        want = oracle()
        bad = _diff(dev, want)
        assert not bad, [(i, dev[i], want[i]) for i in bad][:5]
    else:
        dev_row = cpu_row = None
    for ref, row in ((ref_dev, dev_row), (ref_cpu, cpu_row)):
        if row is not None:  # the recorded departure
            assert isinstance(ref, Exception) or not _same(ref[row],
                                                           dev[row])
            continue
        if ref is ref_cpu and case in REF_CPU_DEPARTS:
            assert isinstance(ref, Exception)
            continue
        assert not isinstance(ref, Exception), ref
        bad = [i for i in _diff(dev, ref) if i not in SUBNORMAL]
        assert not bad, [(i, dev[i], ref[i]) for i in bad][:5]


def test_departures_named_in_the_roadmap():
    """The smallest inputs of the C-ref entries: bit_count of an int -1 is
    64 (Spark widens to long; the reference counts 32 bits);
    bround(1e308, 2) is 1e308 (the reference's device overflows to inf);
    Long.MinValue div -1 is MinValue and Long.MinValue % -1 is 0 (the
    reference's host: 0 and MinValue); greatest(NaN, 1.0) is NaN (the
    reference's host skips NaN: 1.0); pmod(-7, -3) is -1 (Spark's
    formula; the reference 2); 5.0 % 0.0 is null (the reference NaN);
    pow(1, NaN) is NaN (the reference 1.0); asinh(-1e300) is Spark's
    log(x + sqrt(x² + 1)), +inf (the reference C's -691.5); ceil(4.9e-324)
    is 1 (the reference flushes the subnormal: 0)."""
    t = pa.table({"j": pa.array([-1], pa.int32()),
                  "x": pa.array([2.675]), "a": pa.array([-7], pa.int64()),
                  "n": pa.array([-3], pa.int64()), "z": pa.array([0.0]),
                  "f": pa.array([5.0]), "one": pa.array([1.0]),
                  "nan": pa.array([NAN]), "s": pa.array([-1e300]),
                  "sub": pa.array([5e-324]), "big": pa.array([1e308]),
                  "min": pa.array([I64[0]], pa.int64()),
                  "m1": pa.array([-1], pa.int64())})

    def both(build, host=False):
        """(the port's row, the reference's device row, or its host row
        where ``host``)."""
        port = build(PORT, _attrs(PORT, PT, t))
        ref = build(REF, _attrs(REF, RT, t))
        b = TorchColumnarBatch.from_arrow(t)
        got = PB.to_column(port.eval_device(b, PB.EvalContext()), b,
                           port.dtype).to_pylist()[0]
        if host:
            return got, _rows(ref.eval_cpu(t, RB.EvalContext()), 1)[0]
        rb = TpuColumnarBatch([TpuColumnVector.from_arrow(
            c.combine_chunks()) for c in t.columns], 1, names=t.column_names)
        return got, ref.eval_tpu(rb, RB.EvalContext()).to_arrow() \
            .to_pylist()[0]

    assert both(lambda M, a: M.BitwiseCount(a["j"])) == (64, 32)
    assert both(lambda M, a: M.BRound(a["big"], M.Lit(2))) == (1e308, INF)
    assert both(lambda M, a: M.IntegralDivide(a["min"], a["m1"]),
                host=True) == (I64[0], 0)
    assert both(lambda M, a: M.Remainder(a["min"], a["m1"]),
                host=True) == (0, I64[0])
    got, ref = both(lambda M, a: M.Greatest(a["nan"], a["one"]), host=True)
    assert math.isnan(got) and ref == 1.0
    assert both(lambda M, a: M.Pmod(a["a"], a["n"])) == (-1, 2)
    got, ref = both(lambda M, a: M.Remainder(a["f"], a["z"]))
    assert got is None and math.isnan(ref)
    got, ref = both(lambda M, a: M.Pow(a["one"], a["nan"]))
    assert math.isnan(got) and ref == 1.0
    got, ref = both(lambda M, a: M.Asinh(a["s"]))
    assert got == INF and ref == pytest.approx(-691.4686750787736)
    assert both(lambda M, a: M.Ceil(a["sub"])) == (1, 0)


ANSI_CASES = {
    "add_long": "integer overflow in add",
    "neg_long": "integer overflow in negate",
    "abs_long": "integer overflow in abs",
    "div_long": "division by zero",
    "rem_int": "division by zero",
    "pmod_long": "division by zero",
    "mul_long": "integer overflow in multiply",
    "sub_int": "integer overflow in subtract",
    "div_min": "integer overflow in integral divide",
}
CASES.update({
    "add_long": lambda M, a: M.Add(a["i"], a["i"]),
    "neg_long": lambda M, a: M.UnaryMinus(a["i"]),
    "abs_long": lambda M, a: M.Abs(a["i"]),
    "mul_long": lambda M, a: M.Multiply(a["i"], a["i"]),
    "sub_int": lambda M, a: M.Subtract(a["j"], M.Lit(2, a["j"].dtype)),
    "div_min": lambda M, a: M.IntegralDivide(a["i"], M.Lit(-1, a["i"].dtype)),
})


@pytest.mark.parametrize("case", sorted(ANSI_CASES))
def test_ansi_raises_on_both_sides(case):
    """ANSI mode raises the same message on the card's path and on the
    host, and the reference raises on its device path."""
    msg = ANSI_CASES[case]
    t = table()
    expr = CASES[case](PORT, _attrs(PORT, PT, t))
    ctx = PB.EvalContext(RapidsConf({"spark.sql.ansi.enabled": "true"}))
    with pytest.raises(PB.ExpressionError, match=msg):
        expr.eval_device(TorchColumnarBatch.from_arrow(t), ctx)
    with pytest.raises(PB.ExpressionError, match=msg):
        expr.eval_cpu(t, ctx)
    if case not in ("div_min", "mul_long", "sub_int"):
        assert isinstance(reference_rows(case, ansi=True)[0],
                          RB.ExpressionError)


def test_ansi_passes_rows_that_do_not_overflow():
    """Without an overflow ANSI changes nothing; a zero divisor's row is
    only an error under ANSI."""
    t = pa.table({"a": pa.array([1, -5, None], pa.int64()),
                  "b": pa.array([2, 3, 0], pa.int64())})
    a = _attrs(PORT, PT, t)
    ctx = PB.EvalContext(RapidsConf({"spark.sql.ansi.enabled": "true"}))
    b = TorchColumnarBatch.from_arrow(t)
    for expr, want in ((PA.Add(a["a"], a["b"]), [3, -2, None]),
                       (PA.Multiply(a["a"], a["b"]), [2, -15, None]),
                       (PA.Pmod(a["a"], a["b"]), [1, 1, None]),
                       (PA.UnaryMinus(a["a"]), [-1, 5, None])):
        assert PB.to_column(expr.eval_device(b, ctx), b,
                            expr.dtype).to_pylist() == want
        assert _rows(expr.eval_cpu(t, ctx), 3) == want


BASE = {"spark.rapids.shuffle.mode": "ICI",
        "spark.sql.shuffle.partitions": "4"}


def test_session_query_of_each_family():
    """One query a family through the session in test mode (every
    operator on the card) against the reference's host engine: math,
    integral arithmetic, bitwise, NaN handling and greatest/least, with
    the planner's coercions (ints widened to double, the common type)."""
    rows = [{k: v for k, v in r.items() if k in ("x", "y", "j", "i", "l")}
            for r in table().to_pylist()[6:]]
    ref = TpuSession(dict(BASE, **{"spark.rapids.sql.enabled": "false"}))
    port = TorchSession(dict(BASE, **{"spark.rapids.sql.test.enabled":
                                      "true"}), device="cpu")

    def q(F, s):
        df = s.createDataFrame(rows)
        return df.select(
            F.sqrt("j").alias("sq"), F.exp("x").alias("ex"),
            F.log("x").alias("ln"), F.log(2.0, "x").alias("lb"),
            F.pow("j", 2).alias("pw"), F.atan2("x", "y").alias("at"),
            F.hypot("x", "y").alias("hy"), F.ceil("x").alias("cl"),
            F.degrees("x").alias("dg"), F.pmod("i", F.lit(7)).alias("pm"),
            (F.col("i") % 5).alias("md"), F.negative("j").alias("ng"),
            (-F.col("x")).alias("nx"), F.shiftleft("j", 3).alias("sl"),
            F.shiftright("i", 2).alias("sr"),
            F.bitwise_not("i").alias("bn"),
            F.isnan(F.col("x")).alias("na"),
            F.nanvl(F.col("x"), F.col("y")).alias("nv"),
            F.greatest(F.col("j"), F.col("i")).alias("gr"),
            F.least(F.col("j"), F.col("i")).alias("le"))

    want = q(RF, ref).collect()
    got = q(TF, port).collect()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in g:
            assert _same(g[key], w[key]) or (
                isinstance(w[key], float) and isinstance(g[key], float)
                and math.isnan(w[key]) and math.isnan(g[key])), \
                (key, g[key], w[key])
