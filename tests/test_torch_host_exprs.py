"""The expressions' host evaluation (``eval_cpu``, the host engine's)
held, family by family, to the reference's ``eval_cpu`` and to the port's
own ``eval_device`` on the CPU, over the same Arrow rows.

Where the reference departs from Spark the port is held to Spark and the
reference's answer is recorded (ROADMAP Queue C): C3 (``regexp_replace``'s
Java replacement), C4 (``round`` of a double through its decimal text),
C5 (Java's nested character classes), C-ref-18 (``contains`` of a null
pattern), C-ref-19 to C-ref-21. The three cast switches the host engine
brings back move a cast's operator off the card with the reference's
reason and rows."""

import collections
import decimal
import math

import pyarrow as pa
import pytest

import spark_rapids_tpu.functions as RF
import spark_rapids_tpu_torch.functions as TF
import test_torch_string_exprs as SX
from spark_rapids_tpu import types as RT
from spark_rapids_tpu.expressions import (arithmetic as RA, base as RB,
                                          bitwise as RBW, cast as RC,
                                          conditional as RCO,
                                          hashexprs as RH, mathexprs as RM,
                                          nullexprs as RN,
                                          predicates as RP, regex as RRX)
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar.batch import TorchColumnarBatch
from spark_rapids_tpu_torch.expressions import (arithmetic as PA, base as PB,
                                                bitwise as PBW, cast as PC,
                                                conditional as PCO,
                                                hashexprs as PH,
                                                mathexprs as PM,
                                                nullexprs as PN,
                                                predicates as PP,
                                                regex as PRX)
from spark_rapids_tpu_torch.expressions.base import EvalContext, to_column
from spark_rapids_tpu_torch.memory.device import TorchDeviceManager
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.window import Window as TW

TorchDeviceManager.initialize(device="cpu", total_bytes=8 << 30)

REF_ONLY_OFF = {"spark.rapids.tpu.opjit.fuseStages": "false",
                "spark.rapids.tpu.coalesce.enabled": "false"}

NAN, INF = float("nan"), float("inf")
TABLE = pa.table({
    "i": pa.array([1, -7, None, 2**31 - 1, -2**31, 0, 15, 3, 25, -25],
                  pa.int32()),
    "j": pa.array([2, 0, 5, 1, -1, None, 4, 3, -3, 7], pa.int32()),
    "l": pa.array([10, -1, 2**62, None, 5, 0, -2**63, 99, 6, 1], pa.int64()),
    "d": pa.array([1.005, -0.0, NAN, 2.5, None, -2.675, 1e300, INF, 0.285,
                   -1.5]),
    "e": pa.array([1.005, 0.0, NAN, -2.5, 3.0, None, 0.0, -INF, 1.0, -1.5]),
    "b": pa.array([True, False, None, True, False, None, True, True, False,
                   False]),
    "c": pa.array([None, True, True, False, False, None, True, False, None,
                   True]),
    "s": pa.array(["10", "abc", None, " 2.5 ", "-3", "", "1e3", "x",
                   "2020-01-02", "日本"]),
    "t": pa.array([18000, 0, None, -1, 365, 10957, 1, 2, 3, 4],
                  pa.int32()).cast(pa.date32()),
})
NAMES = TABLE.column_names


class _Ns:
    def __init__(self, base, types, mods):
        self.Lit = base.Literal
        self.AttributeReference = base.AttributeReference
        self.types = types
        for mod in mods:
            for k in dir(mod):
                if not k.startswith("_"):
                    setattr(self, k, getattr(mod, k))


REF = _Ns(RB, RT, (RA, RBW, RC, RCO, RH, RM, RN, RP, RRX))
PORT = _Ns(PB, PT, (PA, PBW, PC, PCO, PH, PM, PN, PP, PRX))


def _attrs(ns, table):
    return {f.name: ns.AttributeReference(f.name,
                                          ns.types.from_arrow(f.type), True,
                                          ordinal=i)
            for i, f in enumerate(table.schema)}


def _pylist(x, n):
    if isinstance(x, (pa.Array, pa.ChunkedArray)):
        return x.to_pylist()
    return [x.as_py() if isinstance(x, pa.Scalar) else x] * n


def port_cpu(build, table=TABLE):
    ctx = EvalContext(counters=collections.Counter())
    return _pylist(build(PORT, _attrs(PORT, table)).eval_cpu(table, ctx),
                   table.num_rows)


def port_device(build, table=TABLE):
    batch = TorchColumnarBatch.from_arrow(table)
    ctx = EvalContext(counters=collections.Counter())
    out = build(PORT, _attrs(PORT, table)).eval_device(batch, ctx)
    return to_column(out, batch).to_pylist()


def ref_cpu(build, table=TABLE):
    return _pylist(build(REF, _attrs(REF, table)).eval_cpu(table),
                   table.num_rows)


def same(a, b) -> bool:
    def eq(x, y):
        if isinstance(x, float) and isinstance(y, float):
            return (x != x and y != y) or x == y
        return x == y and type(x) is type(y)
    return len(a) == len(b) and all(eq(x, y) for x, y in zip(a, b))


def assert_family_case(build, spark=None):
    """The port's host rows equal its device rows on the CPU, and the
    reference's host rows (or ``spark``'s, where the reference departs)."""
    got = port_cpu(build)
    assert same(got, port_device(build)), (got, port_device(build))
    want = ref_cpu(build) if spark is None else spark
    assert same(got, want), (got, want)


ARITHMETIC = {
    "add_int": lambda M, a: M.Add(a["i"], a["j"]),
    "add_wraps": lambda M, a: M.Add(a["i"], M.Lit(1)),
    "subtract_long": lambda M, a: M.Subtract(a["l"], a["l"]),
    "multiply_double": lambda M, a: M.Multiply(a["d"], a["e"]),
    "divide_by_zero": lambda M, a: M.Divide(a["e"], a["d"]),
    "abs_int": lambda M, a: M.Abs(a["i"]),
    "abs_double": lambda M, a: M.Abs(a["d"]),
}
PREDICATES = {
    "eq_nan": lambda M, a: M.EqualTo(a["d"], a["e"]),
    "lt_nan": lambda M, a: M.LessThan(a["d"], a["e"]),
    "le_literal": lambda M, a: M.LessThanOrEqual(a["d"], M.Lit(1.005)),
    "gt_int": lambda M, a: M.GreaterThan(a["i"], a["j"]),
    "ge_string": lambda M, a: M.GreaterThanOrEqual(a["s"], M.Lit("2")),
    "and_kleene": lambda M, a: M.And(a["b"], a["c"]),
    "or_kleene": lambda M, a: M.Or(a["b"], a["c"]),
    "not": lambda M, a: M.Not(a["b"]),
    "in_with_null": lambda M, a: M.In(a["i"], [M.Lit(3), M.Lit(None,
                                                                 a["i"].dtype),
                                                M.Lit(15)]),
    "in_strings": lambda M, a: M.In(a["s"], [M.Lit("x"), M.Lit("-3")]),
    "in_set": lambda M, a: M.InSet(a["l"], [99, 5, 7]),
}
NULLS = {
    "is_null": lambda M, a: M.IsNull(a["s"]),
    "is_not_null": lambda M, a: M.IsNotNull(a["d"]),
    "coalesce": lambda M, a: M.Coalesce(a["i"], a["j"], M.Lit(0)),
    "coalesce_strings": lambda M, a: M.Coalesce(a["s"], M.Lit("none")),
}
CONDITIONAL = {
    "if": lambda M, a: M.If(a["b"], a["i"], a["j"]),
    "case_when_else": lambda M, a: M.CaseWhen(
        [(a["b"], a["s"]), (a["c"], M.Lit("c"))], M.Lit("else")),
    "case_when_no_else": lambda M, a: M.CaseWhen([(a["c"], a["l"])]),
}
MATH = {
    "floor": lambda M, a: M.Floor(a["e"]),
    "round_int": lambda M, a: M.Round(a["i"], M.Lit(1)),
}
BITWISE = {
    "and": lambda M, a: M.BitwiseAnd(a["l"], M.Lit(6, a["l"].dtype)),
    "shift_right": lambda M, a: M.ShiftRight(a["l"], M.Lit(3)),
}
CASTS = {
    "int_to_long": lambda M, a: M.Cast(a["i"], M.types.LongT),
    "long_to_int": lambda M, a: M.Cast(a["l"], M.types.IntegerT),
    "double_to_int": lambda M, a: M.Cast(a["e"], M.types.IntegerT),
    "date_to_int": lambda M, a: M.Cast(a["t"], M.types.IntegerT),
    "bool_to_int": lambda M, a: M.Cast(a["b"], M.types.IntegerT),
    "double_to_string": lambda M, a: M.Cast(a["d"], M.types.StringT),
    "int_to_string": lambda M, a: M.Cast(a["i"], M.types.StringT),
    "date_to_string": lambda M, a: M.Cast(a["t"], M.types.StringT),
    "string_to_double": lambda M, a: M.Cast(a["s"], M.types.DoubleT),
    "string_to_date": lambda M, a: M.Cast(a["s"], M.types.DateT),
}
HASHES = {
    "murmur3_int": lambda M, a: M.Murmur3Hash(a["i"]),
    "murmur3_row": lambda M, a: M.Murmur3Hash(a["l"], a["s"], a["e"],
                                              a["t"], a["b"]),
}


@pytest.mark.parametrize("case", sorted(ARITHMETIC))
def test_arithmetic(case):
    assert_family_case(ARITHMETIC[case])


@pytest.mark.parametrize("case", sorted(PREDICATES))
def test_predicates(case):
    assert_family_case(PREDICATES[case])


@pytest.mark.parametrize("case", sorted(NULLS))
def test_null_expressions(case):
    assert_family_case(NULLS[case])


@pytest.mark.parametrize("case", sorted(CONDITIONAL))
def test_conditional(case):
    assert_family_case(CONDITIONAL[case])


@pytest.mark.parametrize("case", sorted(MATH))
def test_math(case):
    assert_family_case(MATH[case])


@pytest.mark.parametrize("case", sorted(BITWISE))
def test_bitwise(case):
    assert_family_case(BITWISE[case])


@pytest.mark.parametrize("case", sorted(CASTS))
def test_casts(case):
    assert_family_case(CASTS[case])


@pytest.mark.parametrize("case", sorted(HASHES))
def test_murmur3_on_the_host_gives_the_device_bits(case):
    assert_family_case(HASHES[case])


def _string_table(vals):
    return pa.table({"s": pa.array(vals, pa.string())})


@pytest.mark.parametrize("corpus", sorted(SX.CORPORA))
@pytest.mark.parametrize("case", sorted(SX.CASES))
def test_strings(case, corpus):
    t = _string_table(SX.CORPORA[corpus])
    build = lambda M, a: SX.CASES[case](M, a["s"])  # noqa: E731
    got = _pylist(build(SX.PORT, _attrs(PORT, t)).eval_cpu(t), t.num_rows)
    batch = TorchColumnarBatch.from_arrow(t)
    dev = to_column(build(SX.PORT, _attrs(PORT, t)).eval_device(
        batch, EvalContext(counters=collections.Counter())), batch)
    assert same(got, dev.to_pylist())
    want = _pylist(build(SX.REF, _attrs(REF, t)).eval_cpu(t), t.num_rows)
    if case == "hash":  # the reference's eval_cpu has no string hash:
        want = SX._reference_rows(case, SX.CORPORA[corpus])  # its device's
    assert same(got, want), (got, want)


REGEX = {
    "rlike_dfa": lambda M, a: M.RLike(a["s"], r"[a-c]+\d?"),
    "rlike_host": lambda M, a: M.RLike(a["s"], r"(a)\1|b$"),
    "rlike_word": lambda M, a: M.RLike(a["s"], r"\w+@\w+"),
    "replace_literal": lambda M, a: M.RegexpReplace(a["s"], r"\d+", "#"),
    "replace_group": lambda M, a: M.RegexpReplace(a["s"], r"(\w)(\d)",
                                                   "$2$1"),
    "extract_group": lambda M, a: M.RegexpExtract(a["s"], r"(\d+)-(\d+)", 2),
    "extract_whole": lambda M, a: M.RegexpExtract(a["s"], r"[a-z]+", 0),
}


@pytest.mark.parametrize("case", sorted(REGEX))
def test_regex(case):
    import test_torch_regex as RX
    t = _string_table(RX.SUBJECTS)
    assert_family_case_on(REGEX[case], t)


def assert_family_case_on(build, table, spark=None):
    got = port_cpu(build, table)
    assert same(got, port_device(build, table))
    want = ref_cpu(build, table) if spark is None else spark
    assert same(got, want), (got, want)


# ---------------------------------------------------------------------------
# the repaired departures from Spark (ROADMAP Queue C)
# ---------------------------------------------------------------------------


def test_regexp_replace_reads_the_replacement_as_java():
    """C3: ``Matcher.appendReplacement``: ``\\$`` is a literal ``$``,
    ``a\\b`` is ``ab``; ``$10`` with one group is group 1 and a ``0``.
    The reference's host hop hands the text to RE2, which raises on both
    (C-ref-20)."""
    t = _string_table(["l", "hello", None])
    cases = {"\\$": ["$", "he$$o", None], "a\\b": ["ab", "heababo", None],
             "<$1$10>": None}
    for repl, spark in cases.items():
        pat = "(l)" if "$1" in repl else "l"
        build = lambda M, a, p=pat, r=repl: M.RegexpReplace(a["s"], p, r)  # noqa: E731,E501
        if spark is None:
            spark = ["<ll0>", "he<ll0><ll0>o", None]
        assert_family_case_on(build, t, spark)
    from spark_rapids_tpu.columnar.batch import TpuColumnarBatch
    rb = TpuColumnarBatch.from_arrow(t)
    for repl in ("\\$", "a\\b"):
        with pytest.raises(pa.ArrowInvalid):
            RRX.RegexpReplace(_attrs(REF, t)["s"], "l", repl).eval_tpu(rb)


def test_contains_of_a_null_pattern_is_null():
    """C-ref-18: null on every row (Spark); the reference's device path
    raises TypeError and its host path refuses the pattern."""
    t = _string_table(["l", "abc", None])
    build = lambda M, a: M.Contains(a["s"], M.Lit(None, M.types.StringT))  # noqa: E731,E501
    assert port_cpu(build, t) == port_device(build, t) == [None] * 3
    from spark_rapids_tpu.columnar.batch import TpuColumnarBatch
    with pytest.raises(TypeError):
        build(REF, _attrs(REF, t)).eval_tpu(TpuColumnarBatch.from_arrow(t))


def _spark_round(v, scale):
    if v is None or not math.isfinite(v):
        return v
    return float(decimal.Decimal(repr(v)).quantize(
        decimal.Decimal(1).scaleb(-scale), context=decimal.Context(
            prec=400, rounding=decimal.ROUND_HALF_UP))) + 0.0


@pytest.mark.parametrize("scale", [2, 0, -1])
def test_round_of_a_double_follows_its_decimal_text(scale):
    """C4: Spark rounds ``BigDecimal.valueOf(x)`` HALF_UP. The reference's
    device formula gives 1.0 for ``round(1.005, 2)``, inf for
    ``round(1e308, 2)`` and 4503599627370498.0 for ``round(2^52 + 1,
    0)``; its host path raises on 1e308 (C-ref-19)."""
    vals = [1.005, 0.285, 1e308, 4503599627370497.0, -2.675, 0.125, -0.4,
            None, NAN, -INF, 123.456, 45035996273704.961]
    t = pa.table({"x": pa.array(vals)})
    build = lambda M, a: M.Round(a["x"], M.Lit(scale))  # noqa: E731
    assert_family_case_on(build, t, [_spark_round(v, scale) for v in vals])
    if scale == 2:
        got = port_cpu(build, t)
        assert got[:4] == [1.01, 0.29, 1e308, 4503599627370497.0]


def test_round_through_both_engines_of_a_session():
    """The same answers from a query on the card's path and with every
    operator in the host engine."""
    vals = {"x": [1.005, 0.285, 1e308, 4503599627370497.0]}
    out = []
    for conf in ({}, {"spark.rapids.sql.enabled": "false"}):
        df = TorchSession(conf, device="cpu").createDataFrame(pa.table(vals))
        out.append([r["r"] for r in df.select(
            TF.round(TF.col("x"), 2).alias("r")).collect()])
    assert out[0] == out[1] == [1.01, 0.29, 1e308, 4503599627370497.0]


@pytest.mark.parametrize("fn", ["rlike", "extract"])
def test_nested_character_classes_read_as_java(fn):
    """C5: in Java a ``[`` inside a class opens a nested set, unioned:
    ``[[:digit:]]`` is one of ``:digit``; RE2 and the reference read a
    POSIX digit class (C-ref-20)."""
    t = _string_table(["l", "a1b", "t:"])
    if fn == "rlike":
        build = lambda M, a: M.RLike(a["s"], "[[:digit:]]")  # noqa: E731
        spark = [False, False, True]
        assert ref_cpu(build, t) != spark
    else:
        build = lambda M, a: M.RegexpExtract(  # noqa: E731
            a["s"], "([[:digit:]]+)", 1)
        spark = ["", "", "t:"]
    assert_family_case_on(build, t, spark)


# ---------------------------------------------------------------------------
# the restored cast switches
# ---------------------------------------------------------------------------

#: switch → (column, cast types): a timestamp goes back to a string, a
#: type the card carries out of a projection
CAST_SWITCHES = {
    "castFloatToString": ("x", ["string"]),
    "castStringToFloat": ("s", ["double"]),
    "castStringToTimestamp": ("ts", ["timestamp", "string"]),
}


def _casts(F, col, to):
    out = F.col(col)
    for t in to:
        out = out.cast(t)
    return out.alias("c")


@pytest.mark.parametrize("switch", sorted(CAST_SWITCHES))
def test_cast_switch_keeps_the_cast_on_the_host(switch):
    col, to = CAST_SWITCHES[switch]
    key = f"spark.rapids.sql.{switch}.enabled"
    data = pa.table({"x": [1.5, -0.25, 1e20, None],
                     "s": ["1.5", " -2 ", None, "1e3"],
                     "ts": ["2020-01-02 03:04:05", "2021-12-31", None,
                            "1999-01-01 00:00:00.5"]})
    out = []
    for F, s in ((RF, TpuSession(dict(REF_ONLY_OFF, **{key: "false"}))),
                 (TF, TorchSession({key: "false"}, device="cpu"))):
        q = s.createDataFrame(data).select(_casts(F, col, to))
        out.append((q.explain_fallback(), [r["c"] for r in q.collect()]))
    (ref_reasons, ref_rows), (reasons, rows) = out
    assert f"disabled via {key}" in reasons and reasons == ref_reasons
    assert rows == ref_rows
    on_card = TorchSession({}, device="cpu").createDataFrame(data).select(
        _casts(TF, col, to))
    assert "disabled" not in on_card.explain_fallback()
    assert [r["c"] for r in on_card.collect()] == rows


# ---------------------------------------------------------------------------
# the window's host-only functions
# ---------------------------------------------------------------------------


def test_window_sum_of_strings_and_lag_with_a_default_on_the_host():
    """Tagged off the card: a window ``sum``/``avg`` of a string reads its
    strings as doubles (Spark's implicit cast), and ``lag`` of a string
    with a default. The reference keeps the sum on its device window,
    which adds the strings' bytes: 49.0 for "1.5" (C-ref-21)."""
    data = pa.table({"g": ["a", "a", "a", "b", "b"],
                     "o": [1, 2, 3, 1, 2],
                     "v": ["1.5", "x", "2", None, " 4 "]})
    s = TorchSession({}, device="cpu")
    w = TW.partitionBy("g").orderBy("o")
    q = s.createDataFrame(data).select(
        "g", "o", TF.sum("v").over(w).alias("run"),
        TF.avg("v").over(TW.partitionBy("g")).alias("avg"),
        TF.lag("v", 1, "none").over(w).alias("prev"))
    assert "window aggregate Sum of a string" in q.explain_fallback()
    rows = sorted((r["g"], r["o"], r["run"], r["avg"], r["prev"])
                  for r in q.collect())
    assert rows == [("a", 1, 1.5, 1.75, "none"), ("a", 2, 1.5, 1.75, "1.5"),
                    ("a", 3, 3.5, 1.75, "x"), ("b", 1, None, 4.0, "none"),
                    ("b", 2, 4.0, 4.0, None)]
    from spark_rapids_tpu.window import Window as RW
    ref = TpuSession(dict(REF_ONLY_OFF)).createDataFrame(data).select(
        "g", "o", RF.sum("v").over(RW.partitionBy("g").orderBy("o"))
        .alias("run"))
    assert sorted((r["g"], r["o"], r["run"]) for r in ref.collect()) == [
        ("a", 1, 49.0), ("a", 2, 95.0), ("a", 3, 148.0), ("b", 1, None),
        ("b", 2, 50.0)]
