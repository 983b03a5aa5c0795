"""The modules the other 16 TPC-H queries brought into the port, each held
against its JAX reference on seeded inputs: the five new tables byte for
byte; ``Cast``, ``If``/``CaseWhen``, ``In``/``InSet``, ``IsNull``/
``IsNotNull``, ``Round`` and ``Substring`` (the port's ``eval_device`` on
the CPU against the reference's ``eval_tpu``); and the joins without
equi-keys, the broadcast nested loop join and the cartesian product, for
every join type, with and without a condition, with empty sides.

Where the port is Spark-correct and the reference is not (a CASE WHEN
whose branches differ in type, a negative integer rounded to a negative
scale), the case is held against Spark's answer and the reference's is
recorded beside it (ROADMAP, Queue C)."""

import math
import types

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu.functions as RF
import spark_rapids_tpu_torch.functions as TF
from spark_rapids_tpu import datagen as RDG
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import datagen as TDG
from spark_rapids_tpu_torch.session import TorchSession

# ---------------------------------------------------------------------------
# the five new tables
# ---------------------------------------------------------------------------


def _reference_table(name: str, rows: int, parts: int) -> pa.Table:
    n_supp, n_part = max(rows // 100, 1), max(rows // 20, 1)
    spec, n = {"supplier": (RDG.tpch_supplier(n_supp), n_supp),
               "part": (RDG.tpch_part(n_part), n_part),
               "partsupp": (RDG.tpch_partsupp(n_part, n_supp), n_part * 4),
               "nation": (RDG.tpch_nation(), RDG.N_NATIONS),
               "region": (RDG.tpch_region(), RDG.N_REGIONS)}[name]
    return spec.generate(42, n, parts)


@pytest.mark.parametrize("parts", [1, 4])
@pytest.mark.parametrize("rows", [4096, 20_001])
@pytest.mark.parametrize("name", ["supplier", "part", "partsupp", "nation",
                                  "region"])
def test_table_is_the_references_byte_for_byte(name, rows, parts):
    ref = _reference_table(name, rows, parts)
    spec, n, _ = TDG.tpch_specs(rows)[name]
    cols, valid = spec.generate(42, n, parts)
    assert not valid and list(cols) == ref.column_names
    for c in ref.column_names:
        want = ref.column(c).combine_chunks()
        got = cols[c]
        if pa.types.is_string(want.type):
            offs = np.frombuffer(want.buffers()[1], np.int32)[
                want.offset:want.offset + len(want) + 1]
            raw = np.frombuffer(want.buffers()[2], np.uint8)
            assert np.array_equal(got.offsets, offs - offs[0]), c
            assert got.chars.tobytes() == raw[offs[0]:offs[-1]].tobytes(), c
        else:
            arr = want.to_numpy(zero_copy_only=False)
            assert arr.dtype == got.dtype and arr.tobytes() == \
                got.tobytes(), c


def test_tables_follow_the_benchmark_ratios():
    host = TDG.tpch_host_tables(4096, 4)
    assert {k: (len(next(iter(v[0].values()))), v[2])
            for k, v in host.items()} == {
        "lineitem": (4096, 4), "orders": (1024, 4), "customer": (102, 1),
        "supplier": (40, 1), "part": (204, 1), "partsupp": (816, 1),
        "nation": (25, 1), "region": (5, 1)}


# ---------------------------------------------------------------------------
# expressions: the port's eval_device against the reference's eval_tpu
# ---------------------------------------------------------------------------


def _ns(root: str):
    import importlib
    mods = ("types", "expressions.base", "expressions.arithmetic",
            "expressions.cast",
            "expressions.conditional", "expressions.nullexprs",
            "expressions.predicates", "expressions.mathexprs",
            "expressions.strings")
    return types.SimpleNamespace(**{m.split(".")[-1]: importlib.import_module(
        f"{root}.{m}") for m in mods})


REF, PORT = _ns("spark_rapids_tpu"), _ns("spark_rapids_tpu_torch")


def _eval(pkg, table: pa.Table, build):
    """``build(ns, attrs)``'s expression over ``table`` in one package, as
    Python values."""
    ns = REF if pkg == "ref" else PORT
    attrs = [ns.base.AttributeReference(f.name, ns.types.from_arrow(f.type),
                                        True, ordinal=i)
             for i, f in enumerate(table.schema)]
    expr = build(ns, attrs)
    if pkg == "ref":
        from spark_rapids_tpu.columnar.batch import TpuColumnarBatch
        out = expr.eval_tpu(TpuColumnarBatch.from_arrow(table))
        return out.to_arrow().to_pylist()[:table.num_rows]
    from spark_rapids_tpu_torch.columnar.batch import TorchColumnarBatch
    batch = TorchColumnarBatch.from_arrow(table).to_device("cpu")
    return expr.eval_device(batch).to_pylist()


def _same(a, b) -> bool:
    return all((x is None and y is None) or (
        isinstance(x, float) and isinstance(y, float)
        and (x == y and math.copysign(1, x) == math.copysign(1, y)
             or x != x and y != y)) or (x == y and type(x) is type(y))
        for x, y in zip(a, b)) and len(a) == len(b)


def _both(table, build):
    ref, port = _eval("ref", table, build), _eval("port", table, build)
    assert _same(ref, port), (ref, port)
    return port


DOUBLES = pa.array([0.0, -0.0, 1.5, -1.5, 2.9, -2.9, 1e10, -1e10, 3e19,
                    -3e19, float("nan"), float("inf"), float("-inf"), None,
                    2147483647.0, -2147483648.0, 9.2e18])
EDGE = pa.table({
    "d": DOUBLES,
    "i": pa.array([0, -1, 7, -7, 2**31 - 1, -2**31, 365, -365, None, 3,
                   -3, 5, 15, 25, -15, -25, 1], pa.int32()),
    "l": pa.array([0, -1, 2**62, -2**62, 2**53 + 1, None, 10, 11, -11, 5,
                   -5, 15, -15, 2**63 - 1, -2**63, 4, 9], pa.int64()),
    "t": pa.array([8035, 0, -1, 10590, None, 365, 364, -365, -366, 730,
                   1, 2, 3, 4, 5, 6, 7], pa.int32()).cast(pa.date32()),
})


@pytest.mark.parametrize("col,to", [
    ("t", "int"), ("t", "long"), ("i", "double"), ("l", "double"),
    ("d", "int"), ("d", "long"), ("i", "long"), ("l", "int"),
    ("d", "double")])
def test_cast_matches_reference(col, to):
    """Dates to day numbers, widening to double, double to int/long
    (truncation toward zero, NaN 0, overflow clamped), long to int
    (wrapping)."""
    ix = EDGE.column_names.index(col)

    def build(ns, attrs):
        from_string = getattr(ns.types, "type_from_string", None)
        dtype = from_string(to) if from_string else {
            "int": ns.types.IntegerT, "long": ns.types.LongT,
            "double": ns.types.DoubleT}[to]
        return ns.cast.Cast(attrs[ix], dtype)
    _both(EDGE, build)


def test_literal_casts_as_columns_do():
    """A literal double casts to an int as a column does: truncated toward
    zero, NaN 0, out of range clamped."""
    from spark_rapids_tpu_torch.columnar.batch import TorchColumnarBatch
    one = TorchColumnarBatch([], 1)
    got = [PORT.cast.Cast(PORT.base.Literal(v), PORT.types.IntegerT)
           .eval_device(one).value
           for v in (-2.9, 2.9, float("nan"), 3e10, -3e10, float("inf"))]
    assert got == [-2, 2, 0, 2**31 - 1, -2**31, 2**31 - 1]


def test_year_of_date_as_the_queries_compute_it():
    """q7/q8/q9's ``(date.cast("int") / 365).cast("int")``: Spark's double
    division, then truncation toward zero."""
    out = _both(EDGE, lambda ns, a: ns.cast.Cast(ns.arithmetic.Divide(
        ns.cast.Cast(ns.cast.Cast(a[3], ns.types.IntegerT),
                     ns.types.DoubleT), ns.base.Literal(365.0)),
        ns.types.IntegerT))
    assert out[:4] == [22, 0, 0, 29] and out[7:9] == [-1, -1]


COND = pa.table({
    "p": pa.array([True, False, None, True, None, False, True, False]),
    "q": pa.array([False, True, True, None, None, False, True, None]),
    "x": pa.array([1.5, None, 3.0, -4.0, 5.0, 6.0, None, 8.0]),
    "y": pa.array([10.0, 20.0, None, 40.0, 50.0, 60.0, 70.0, None]),
    "n": pa.array([1, 2, 3, None, 5, 6, 7, 8], pa.int32()),
})


@pytest.mark.parametrize("case", ["if", "when-otherwise", "when-when",
                                  "when-no-else", "int-branches"])
def test_conditionals_match_reference(case):
    """Null conditions take the next branch; no ELSE gives null."""
    def build(ns, a):
        C, L = ns.conditional, ns.base.Literal
        if case == "if":
            return C.If(a[0], a[2], a[3])
        if case == "when-otherwise":
            return C.CaseWhen([(a[0], a[2])], L(0.0))
        if case == "when-when":
            return C.CaseWhen([(a[0], a[2]), (a[1], a[3])], L(-1.0))
        if case == "when-no-else":
            return C.CaseWhen([(a[0], a[3]), (a[1], a[2])])
        return C.CaseWhen([(a[0], L(1))], L(0))
    _both(COND, build)


def test_case_when_promotes_mixed_branch_types():
    """``when(p, n).otherwise(2.5)`` is a double (Spark's CaseWhenCoercion);
    the reference keeps the int branch's type and gives 2 for 2.5."""
    def build(ns, a):
        return ns.conditional.CaseWhen([(a[0], a[4])], ns.base.Literal(2.5))
    assert _eval("port", COND, build) == [1.0, 2.5, 2.5, None, 2.5, 2.5,
                                          7.0, 2.5]
    assert _eval("ref", COND, build) == [1, 2, 2, None, 2, 2, 7, 2]
    expr = build(PORT, [PORT.base.AttributeReference(
        f.name, PORT.types.from_arrow(f.type), True, ordinal=i)
        for i, f in enumerate(COND.schema)])
    assert expr.dtype == PORT.types.DoubleT


@pytest.mark.parametrize("col", ["x", "p", "n"])
def test_null_tests_match_reference(col):
    ix = COND.column_names.index(col)
    assert _both(COND, lambda ns, a: ns.nullexprs.IsNull(a[ix])) == \
        [not v for v in _both(COND, lambda ns, a:
                              ns.nullexprs.IsNotNull(a[ix]))]


IN_TABLE = pa.table({
    "v": pa.array([1, 2, None, 4, 5, -1, 7], pa.int64()),
    "f": pa.array([1.0, float("nan"), None, -0.0, 2.5, 3.0, 0.0]),
    "s": pa.array(["04", "27", None, "", "日本", "81", "4"]),
})


@pytest.mark.parametrize("col,items", [
    ("v", [1, 4, 9]), ("v", [1, None, 7]), ("v", [None]), ("v", []),
    ("f", [2.5, float("nan")]), ("f", [0.0, None]),
    ("s", ["04", "81", "日本"]), ("s", ["", None, "27"]), ("s", ["x"])])
def test_in_matches_reference(col, items):
    """Three-valued IN: null value → null; no match with a null item →
    null."""
    ix = IN_TABLE.column_names.index(col)
    _both(IN_TABLE, lambda ns, a: ns.predicates.In(
        a[ix], [ns.base.Literal(i, a[ix].dtype if i is None else None)
                for i in items]))


@pytest.mark.parametrize("col,items", [
    ("v", [1, 4, 9]), ("v", [1, None, 7]), ("f", [2.5, float("nan")]),
    ("s", ["04", "81", None])])
def test_in_set_matches_reference(col, items):
    ix = IN_TABLE.column_names.index(col)
    _both(IN_TABLE, lambda ns, a: ns.predicates.InSet(a[ix], items))


ROUND = pa.table({
    "d": pa.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 1.005, 2.675, -2.675,
                   123.456, -123.456, float("nan"), float("inf"),
                   float("-inf"), None, 0.0, -0.0, 1e300]),
    "i": pa.array([5, 15, 25, 14, 16, 0, 1, 149, 150, 151, 999, 1000,
                   2**31 - 100, 7, None, 50, 45, 44], pa.int32()),
})


@pytest.mark.parametrize("col,scale", [("d", 0), ("d", 2), ("d", 1),
                                       ("d", -1), ("d", -2), ("i", 0),
                                       ("i", 2), ("i", -1), ("i", -2)])
def test_round_matches_reference(col, scale):
    """HALF_UP, ties away from zero; NaN and infinities pass through;
    non-negative integers to negative scales."""
    ix = ROUND.column_names.index(col)
    _both(ROUND, lambda ns, a: ns.mathexprs.Round(a[ix],
                                                  ns.base.Literal(scale)))


def test_round_negative_integers_to_negative_scales():
    """Java's truncating division: round(-14, -1) is -10 and
    round(-150, -1) -150 (Spark); the reference floors ``x - m/2``, so it
    agrees only where that is a multiple of ``m`` (-15, -25)."""
    t = pa.table({"i": pa.array([-14, -15, -16, -25, -149, -150, -151],
                                pa.int64())})

    def build(ns, a):
        return ns.mathexprs.Round(a[0], ns.base.Literal(-1))
    assert _eval("port", t, build) == [-10, -20, -20, -30, -150, -150, -150]
    assert _eval("ref", t, build) == [-20, -20, -30, -30, -160, -160, -160]


def test_round_past_the_int_range_wraps():
    """round(2^31 - 1, -1) is 2^31 + 2 as a long and round(-2^31, -1) is
    -2^31 - 2, which wrap in an int (Spark's ``intValue``); the reference's
    int column cannot hold them."""
    t = pa.table({"i": pa.array([2**31 - 1, -2**31], pa.int32())})
    assert _eval("port", t, lambda ns, a: ns.mathexprs.Round(
        a[0], ns.base.Literal(-1))) == [-2**31 + 2, 2**31 - 2]


SUBSTR = pa.table({"s": pa.array(["hello", "", "ab", None, "0123456789-",
                                  "x", "27-555"])})


@pytest.mark.parametrize("pos,ln", [(1, 2), (0, 3), (2, 100), (-3, 2),
                                    (-10, 4), (-1, 5), (5, 0), (3, -1),
                                    (100, 2), (-100, 200)])
def test_substring_matches_reference(pos, ln):
    _both(SUBSTR, lambda ns, a: ns.strings.Substring(
        a[0], ns.base.Literal(pos), ns.base.Literal(ln)))


def test_substring_over_non_ascii_is_not_yet_ported():
    t = pa.table({"s": pa.array(["日本語", "ab"])})
    with pytest.raises(NotImplementedError, match="not yet ported"):
        _eval("port", t, lambda ns, a: ns.strings.Substring(
            a[0], ns.base.Literal(1), ns.base.Literal(1)))


def test_column_methods_through_the_session():
    """``select`` with ``cast``, ``between``, ``isNull``, ``isNotNull``,
    ``substr``, ``isin`` and ``distinct``, planned and run in both
    packages."""
    rows = [{"k": 3, "x": 1.5, "s": "abc"}, {"k": None, "x": -2.5, "s": "x"},
            {"k": 7, "x": None, "s": None}, {"k": 3, "x": 1.5, "s": "abc"}]
    out = []
    for F, s in ((RF, TpuSession()), (TF, TorchSession(device="cpu"))):
        df = s.createDataFrame(rows)
        q = df.select(F.col("x").cast("int").alias("xi"),
                      F.col("k").between(2, 5).alias("b"),
                      F.col("k").isNull().alias("kn"),
                      F.col("x").isNotNull().alias("xn"),
                      F.col("s").substr(2, 5).alias("ss"),
                      F.col("k").isin(3, None).alias("ki")).distinct()
        out.append(sorted(q.collect(), key=repr))
    assert out[0] == out[1] and len(out[0]) == 3


def test_substring_then_in_through_the_session():
    """q22's ``isin`` over a device substring: a new offsets buffer."""
    rows = [{"p": "04-1"}, {"p": "27-2"}, {"p": "99-3"}, {"p": "0"}]
    out = []
    for F, s in ((RF, TpuSession()), (TF, TorchSession(device="cpu"))):
        df = s.createDataFrame(rows).withColumn(
            "c", F.substring(F.col("p"), 1, 2))
        out.append(df.filter(F.col("c").isin("04", "27", "0")).collect())
    assert out[0] == out[1] == [{"p": "04-1", "c": "04"},
                                {"p": "27-2", "c": "27"},
                                {"p": "0", "c": "0"}]


# ---------------------------------------------------------------------------
# joins without equi-keys
# ---------------------------------------------------------------------------

JOIN_TYPES = ["inner", "cross", "leftouter", "rightouter", "fullouter",
              "leftsemi", "leftanti"]


def _join_sides(F, s, n_l: int, n_r: int, parts: int):
    rng = np.random.default_rng(11)
    left = s.createDataFrame(pa.table({
        "a": pa.array(rng.integers(0, 8, n_l), pa.int64()),
        "x": pa.array([f"l{i}" for i in range(n_l)])}), num_partitions=parts)
    right = s.createDataFrame(pa.table({
        "b": pa.array(rng.integers(0, 8, n_r), pa.int64()),
        "y": pa.array(rng.uniform(0, 1, n_r))}), num_partitions=parts)
    return left, right


def _nested_join(F, s, jt: str, cond: bool, n_l: int, n_r: int,
                 parts: int = 2):
    left, right = _join_sides(F, s, n_l, n_r, parts)
    if not cond:
        return left.crossJoin(right)
    return left.join(right, on=left["a"] < right["b"],
                     how="inner" if jt == "cross" else jt)


def _both_sessions(conf):
    return ((RF, TpuSession(dict(conf))),
            (TF, TorchSession(dict(conf), device="cpu")))


#: (join type, with a condition): the reference joins without a condition
#: only as a cross join
NESTED_CASES = [(jt, True) for jt in JOIN_TYPES] + [("inner", False),
                                                    ("cross", False)]


@pytest.mark.parametrize("sizes", [(9, 7), (0, 5), (6, 0), (0, 0)],
                         ids=["both", "left-empty", "right-empty",
                              "both-empty"])
@pytest.mark.parametrize("jt,cond", NESTED_CASES)
def test_nested_loop_join_matches_reference(jt, cond, sizes):
    """Every join type, each side broadcast whole; the port expands the
    pair grid in blocks of batchSizeRows (5 here) pairs. A right or full
    outer join of an empty left side is every right row null-extended;
    the reference fails to download that batch (its all-null string
    column), so the case is held against those rows instead."""
    conf = {"spark.rapids.sql.batchSizeRows": "5"}
    out = []
    for F, s in _both_sessions(conf):
        q = _nested_join(F, s, jt, cond, *sizes)
        assert "BroadcastNestedLoopJoin" in q.explain()
        if F is RF and jt in ("rightouter", "fullouter") \
                and sizes[0] == 0 and sizes[1]:
            right = _join_sides(F, s, *sizes, 2)[1].collect()
            out.append([dict(a=None, x=None, **r) for r in right])
            continue
        out.append(q.collect())
    assert out[0] == out[1]


@pytest.mark.parametrize("cond", [True, False], ids=["cond", "no-cond"])
@pytest.mark.parametrize("sizes", [(9, 7), (0, 5)], ids=["both", "empty"])
def test_cartesian_product_matches_reference(cond, sizes):
    """An inner or cross join whose right side is past the broadcast
    threshold pairs partitions: output partition k is left partition
    k // 3 with right partition k % 3."""
    conf = {"spark.sql.autoBroadcastJoinThreshold": "1"}
    out = []
    for F, s in _both_sessions(conf):
        q = _nested_join(F, s, "cross", cond, *sizes, parts=3)
        assert "CartesianProduct" in q.explain()
        out.append(q.collect())
    assert out[0] == out[1]
