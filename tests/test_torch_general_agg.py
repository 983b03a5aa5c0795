"""The port's general, sort-based aggregate and its sort held against the
JAX reference on the CPU.

The key encoding, the stable lexicographic sort and the segment
boundaries must equal the reference's exactly; whole queries (Q1, Q6,
min/max with NaN, empty input) run through ``TorchSession`` and
``TpuSession`` with the compiled stage off, and compare rows
order-insensitively: keys and counts exact, float64 within rtol 1e-9.
``orderBy`` output compares in order."""

import functools
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu.functions as RF
import spark_rapids_tpu_torch.functions as TF
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch.session import TorchSession

GENERAL = {"spark.rapids.tpu.agg.compiledStage.enabled": "false"}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# encode → stable sort → segments, against the reference
# ---------------------------------------------------------------------------


def _key_columns(n: int):
    """int32, int64, float64 (NaN, -0.0, 0.0) and bool keys, each with
    nulls (null lanes zeroed, as from Arrow), seed 0."""
    rng = np.random.default_rng(0)
    f = rng.choice([-1.5, -0.0, 0.0, 2.25, np.nan, -np.inf, 7.0], n)
    cols = {
        "int32": rng.integers(-3, 4, n).astype(np.int32),
        "int64": rng.integers(-2**40, 2**40, n // 8 + 1)[
            rng.integers(0, n // 8 + 1, n)].astype(np.int64),
        "float64": f,
        "bool": rng.integers(0, 2, n).astype(bool),
    }
    valid = {k: rng.random(n) > 0.15 for k in cols}
    for k, v in cols.items():
        v[~valid[k]] = 0
    return cols, valid


def _ref_encode(names, cols, valid, n, cap):
    from spark_rapids_tpu.columnar.vector import TpuColumnVector, row_mask
    from spark_rapids_tpu.execs.aggregates import (encode_group_keys,
                                                   lex_sort_permutation,
                                                   segment_boundaries)
    from spark_rapids_tpu.types import (BooleanType, DoubleType, IntegerType,
                                        LongType)
    types = {"int32": IntegerType(), "int64": LongType(),
             "float64": DoubleType(), "bool": BooleanType()}
    vecs = [TpuColumnVector.from_numpy(types[k], cols[k], valid[k], cap)
            for k in names]
    enc = encode_group_keys(vecs, n, cap)
    perm = lex_sort_permutation(enc, n, cap)
    is_new, seg_ids, ng = segment_boundaries(enc, perm, row_mask(n, cap))
    return [np.asarray(a) for a in (perm, is_new, seg_ids)] + [int(ng)]


def _port_encode(names, cols, valid, n, cap):
    from spark_rapids_tpu_torch.columnar.vector import (TorchColumnVector,
                                                        row_mask)
    from spark_rapids_tpu_torch.execs.aggregates import (encode_group_keys,
                                                         lex_sort_permutation,
                                                         segment_boundaries)
    from spark_rapids_tpu_torch.types import (BooleanType, DoubleType,
                                              IntegerType, LongType)
    types = {"int32": IntegerType(), "int64": LongType(),
             "float64": DoubleType(), "bool": BooleanType()}
    vecs = [TorchColumnVector.from_numpy(types[k], cols[k], valid[k], cap)
            for k in names]
    enc = encode_group_keys(vecs, n, cap)
    perm = lex_sort_permutation(enc, n, cap)
    is_new, seg_ids, ng = segment_boundaries(enc, perm,
                                             row_mask(n, cap, "cpu"))
    return [a.numpy() for a in (perm, is_new, seg_ids)] + [int(ng)]


@pytest.mark.parametrize("names", [("int32",), ("int64",), ("float64",),
                                   ("bool",),
                                   ("bool", "float64", "int32", "int64")],
                         ids=lambda ns: "+".join(ns))
def test_group_key_sort_matches_reference_exactly(names):
    n, cap = 1000, 1024
    cols, valid = _key_columns(n)
    want = _ref_encode(names, cols, valid, n, cap)
    got = _port_encode(names, cols, valid, n, cap)
    for w, g, what in zip(want, got, ("perm", "is_new", "seg_ids", "ng")):
        np.testing.assert_array_equal(np.asarray(g).astype(np.int64),
                                      np.asarray(w).astype(np.int64),
                                      err_msg=what)


def test_float_keys_fold_negative_zero_and_nan():
    """-0.0 groups with 0.0 and every NaN with every other NaN."""
    cols = {"k": np.array([0.0, -0.0, np.nan, float("nan"), 1.0, -0.0]),
            "v": np.arange(6, dtype=np.int64)}
    got = TorchSession(GENERAL, device="cpu").createDataFrame(cols) \
        .groupBy("k").agg(TF.sum(TF.col("v")).alias("s"),
                          TF.count("*").alias("n")).collect()
    by = {("nan" if math.isnan(r["k"]) else r["k"]): (r["s"], r["n"])
          for r in got}
    assert by == {0.0: (6, 3), "nan": (5, 2), 1.0: (4, 1)}


# ---------------------------------------------------------------------------
# whole queries through the general path
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lineitem_table(n: int, nulls: bool = False):
    """bench.py's Q1-shaped lineitem columns (seed 42)."""
    rng = np.random.default_rng(42)
    cols = {
        "l_returnflag": np.array(["A", "N", "R"])[rng.integers(0, 3, n)],
        "l_linestatus": np.array(["F", "O"])[rng.integers(0, 2, n)],
        "l_quantity": rng.uniform(1, 50, n),
        "l_extendedprice": rng.uniform(900, 100000, n),
        "l_discount": rng.uniform(0, 0.1, n),
        "l_tax": rng.uniform(0, 0.08, n),
        "l_shipdate": rng.integers(8766, 10957, n).astype(np.int32),
    }
    arrays = {k: pa.array(v) for k, v in cols.items()}
    if nulls:
        for name, every in (("l_returnflag", 7), ("l_quantity", 5),
                            ("l_discount", 11), ("l_extendedprice", 13)):
            mask = np.zeros(n, bool)
            mask[::every] = True
            arrays[name] = pa.array(cols[name], mask=mask)
    return pa.table(arrays)


def _q1(F, df):
    """bench.py's _framework_query."""
    return (df.filter(F.col("l_shipdate") <= 10471)
            .withColumn("disc_price",
                        F.col("l_extendedprice") * (1 - F.col("l_discount")))
            .withColumn("charge",
                        F.col("l_extendedprice") * (1 - F.col("l_discount"))
                        * (1 + F.col("l_tax")))
            .groupBy("l_returnflag", "l_linestatus")
            .agg(F.sum(F.col("l_quantity")).alias("sum_qty"),
                 F.sum(F.col("l_extendedprice")).alias("sum_base_price"),
                 F.sum(F.col("disc_price")).alias("sum_disc_price"),
                 F.sum(F.col("charge")).alias("sum_charge"),
                 F.avg(F.col("l_quantity")).alias("avg_qty"),
                 F.avg(F.col("l_extendedprice")).alias("avg_price"),
                 F.avg(F.col("l_discount")).alias("avg_disc"),
                 F.count(F.col("l_quantity")).alias("count_order")))


def _q6(F, df):
    """bench.py's _framework_q6."""
    return (df.filter((F.col("l_shipdate") >= 8766)
                      & (F.col("l_shipdate") < 9131)
                      & (F.col("l_discount") >= 0.05)
                      & (F.col("l_discount") <= 0.07)
                      & (F.col("l_quantity") < 24))
            .agg(F.sum(F.col("l_extendedprice") * F.col("l_discount"))
                 .alias("revenue")))


def _same(a, b) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        if a is None or b is None:
            return a is b
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return math.isclose(a, b, rel_tol=1e-9)
    return a == b


def _assert_rows_equal(want, got, keys, ordered=False):
    assert len(want) == len(got)
    if not ordered:
        order = lambda r: tuple((r[k] is None, r[k]) for k in keys)  # noqa
        want, got = sorted(want, key=order), sorted(got, key=order)
    for w, g in zip(want, got):
        assert set(w) == set(g)
        for k in w:
            assert _same(w[k], g[k]), (k, w[k], g[k])


_REF_ROWS = {}


def _reference_rows(conf, table, query, cached, parts=1):
    """The reference's rows, once per (conf, table, query) in this module.
    By default the reference runs one partition: its answer does not depend
    on the partitioning, and its multi-partition plan adds a shuffle
    exchange that only costs compile time here."""
    key = (tuple(sorted(conf.items())), id(table), query, parts)
    if key not in _REF_ROWS:
        df = TpuSession(dict(conf)).createDataFrame(table,
                                                    num_partitions=parts)
        _REF_ROWS[key] = query(RF, df.device_cache() if cached else df) \
            .collect()
    return _REF_ROWS[key]


def _both(conf, table, query, parts=1, cached=False, ref_conf=None,
          ref_parts=1):
    """(reference rows, port rows, port session, port plan); the reference
    runs ``ref_conf`` (default: the port's conf) over ``ref_parts``."""
    s = TorchSession(dict(conf), device="cpu")
    port = s.createDataFrame(table, num_partitions=parts)
    q = query(TF, port.device_cache() if cached else port)
    want = _reference_rows(ref_conf or conf, table, query, cached, ref_parts)
    return want, q.collect(), s, q.explain()


@pytest.mark.parametrize("query,n,batch_rows,nulls,parts,cached", [
    ("q1", 4096, 1 << 20, False, 1, True),
    ("q1", 20000, 1 << 20, False, 1, False),
    ("q1", 4096, 1 << 20, True, 1, True),
    ("q1", 4096, 1 << 20, False, 3, False),
    ("q1", 1500, 1000, True, 3, True),
    ("q6", 4096, 1 << 20, False, 1, True),
    ("q6", 20000, 1 << 20, True, 1, False),
    ("q6", 1500, 1000, False, 3, True),
], ids=["q1-4096", "q1-20000", "q1-nulls", "q1-3parts", "q1-ooc-nulls",
        "q6-4096", "q6-20000-nulls", "q6-chunked"])
def test_general_path_matches_reference(query, n, batch_rows, nulls, parts,
                                        cached):
    conf = dict(GENERAL, **{"spark.rapids.sql.batchSizeRows": str(batch_rows)})
    if batch_rows < n:
        # one shuffle partition: the grouped aggregate's hash exchange
        # gathers every row into one reduce partition, past batchSizeRows
        conf["spark.sql.shuffle.partitions"] = "1"
    fn = _q1 if query == "q1" else _q6
    # the out-of-core cases run the reference out of core as well
    want, got, s, plan = _both(conf, _lineitem_table(n, nulls), fn, parts,
                               cached, ref_parts=parts if batch_rows < n
                               else 1)
    assert "TorchHashAggregate" in plan and "TorchCompiledAggStage" not in plan
    keys = ("l_returnflag", "l_linestatus") if query == "q1" else ()
    _assert_rows_equal(want, got, keys)
    # batchSizeRows=1000 under more rows: the grouped aggregate sorts out
    # of core; the global one merges per-chunk states
    assert s.counters["sort_fallback_runs"] == \
        (1 if query == "q1" and batch_rows < n else 0)


@functools.lru_cache(maxsize=None)
def _nan_table(n=500):
    rng = np.random.default_rng(5)
    x = rng.uniform(-10, 10, n)
    x[::17] = np.nan
    k = rng.integers(0, 6, n).astype(np.int32)
    x[k == 4] = np.nan  # group 4: all NaN
    i = rng.integers(-50, 50, n)
    s = pa.array(np.array(["a", "bb", ""])[rng.integers(0, 3, n)],
                 mask=np.arange(n) % 9 == 0)
    return pa.table({"k": k, "x": pa.array(x, mask=np.arange(n) % 23 == 0),
                     "i": i, "d": pa.array(rng.integers(0, 3000, n)
                                           .astype(np.int32), pa.date32()),
                     "s": s})


@pytest.mark.parametrize("grouped,batch_rows", [(True, 1 << 20), (True, 100),
                                                (False, 1 << 20),
                                                (False, 100)],
                         ids=["grouped", "grouped-ooc", "global",
                              "global-chunked"])
def test_min_max_with_nan_match_reference(grouped, batch_rows):
    """Spark's NaN order in min/max, a date min and a string count."""
    conf = dict(GENERAL, **{"spark.rapids.sql.batchSizeRows": str(batch_rows)})

    def query(F, df):
        aggs = (F.min(F.col("x")).alias("lo"), F.max(F.col("x")).alias("hi"),
                F.min(F.col("i")).alias("ilo"), F.max(F.col("i")).alias("ihi"),
                F.min(F.col("d")).alias("dlo"), F.sum(F.col("x")).alias("s"),
                F.count(F.col("s")).alias("ns"))
        return df.groupBy("k").agg(*aggs) if grouped else df.agg(*aggs)

    # held against the reference's in-core rows (its out-of-core run
    # compiles a program a slice shape, which costs more than it tests)
    want, got, _, _ = _both(conf, _nan_table(), query, parts=2, cached=True,
                            ref_conf=GENERAL)
    _assert_rows_equal(want, got, ("k",) if grouped else ())


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "global"])
def test_empty_input_matches_reference(grouped):
    """Nothing passes the filter: a global aggregate gives one row (count
    0, the others null), a grouped one gives none."""

    def query(F, df):
        kept = df.filter(F.col("l_shipdate") < 0)
        aggs = (F.count(F.col("l_quantity")).alias("c"),
                F.sum(F.col("l_quantity")).alias("s"),
                F.min(F.col("l_discount")).alias("m"),
                F.avg(F.col("l_tax")).alias("a"))
        return kept.groupBy("l_returnflag").agg(*aggs) if grouped \
            else kept.agg(*aggs)

    want, got, _, _ = _both(GENERAL, _lineitem_table(300), query)
    if grouped:
        assert got == want == []
    else:
        assert got == want == [{"c": 0, "s": None, "m": None, "a": None}]


# ---------------------------------------------------------------------------
# orderBy
# ---------------------------------------------------------------------------


def _sort_table():
    strs = ["AB", "B", "AA", None, "A", "", "AB", "ZZZZZZZ", "b", "A\x01",
            "AA", None]
    rng = np.random.default_rng(1)
    n = len(strs)
    return pa.table({
        "s": pa.array(strs),
        "x": pa.array(rng.integers(-3, 3, n), mask=np.arange(n) % 5 == 1),
        "f": pa.array([1.5, -0.0, np.nan, 0.0, 2.0, -2.0, 3.0, 1e300, -1e-300,
                       np.nan, 0.0, -7.0], mask=np.arange(n) % 7 == 3),
    })


_ORDERS = {
    "string-then-int": lambda F: ("s", "x"),
    "int-then-string": lambda F: ("x", "s"),
    "float-then-string": lambda F: ("f", "s"),
    "string-desc-int-nulls-last": lambda F: (F.col("s").desc(),
                                             F.col("x").asc_nulls_last()),
    "float-desc-nulls-first": lambda F: (F.col("f").desc_nulls_first(),
                                         "s", "x"),
}


@pytest.mark.parametrize("name", sorted(_ORDERS))
def test_order_by_matches_reference_in_order(name):
    t = _sort_table()
    want = TpuSession().createDataFrame(t).orderBy(*_ORDERS[name](RF)) \
        .collect()
    got = TorchSession(device="cpu").createDataFrame(t, num_partitions=2) \
        .orderBy(*_ORDERS[name](TF)).collect()
    _assert_rows_equal(want, got, (), ordered=True)


def test_order_by_strings_is_lexicographic():
    rows = TorchSession(device="cpu").createDataFrame(
        {"s": np.array(["AB", "B", "AA", "A", "BA", "AAA"], dtype=object)}) \
        .orderBy("s").collect()
    assert [r["s"] for r in rows] == ["A", "AA", "AAA", "AB", "B", "BA"]


def test_out_of_core_order_by_matches_in_core():
    table = _lineitem_table(3000, nulls=True)

    def query(conf):
        return TorchSession(conf, device="cpu").createDataFrame(
            table, num_partitions=3).orderBy(
            TF.col("l_returnflag").desc(), "l_shipdate", "l_quantity") \
            .collect()

    small = query({"spark.rapids.sql.batchSizeRows": "400"})
    _assert_rows_equal(query({}), small, (), ordered=True)


def test_q1_order_by_matches_reference():
    """TPC-H Q1 as written: the aggregate then ORDER BY its keys."""
    table = _lineitem_table(5000)
    want = _q1(RF, TpuSession().createDataFrame(table)).orderBy(
        "l_returnflag", "l_linestatus").collect()
    q = _q1(TF, TorchSession(device="cpu").createDataFrame(table)).orderBy(
        "l_returnflag", "l_linestatus")
    assert "TorchSort" in q.explain()
    _assert_rows_equal(want, q.collect(), (), ordered=True)


# ---------------------------------------------------------------------------
# the device path needs no pyarrow
# ---------------------------------------------------------------------------


def test_device_path_runs_without_pyarrow():
    """Q1 and Q6 on both device paths and an orderBy, in a process where
    importing pyarrow fails."""
    script = textwrap.dedent("""
        import sys
        sys.modules["pyarrow"] = None
        import numpy as np
        import spark_rapids_tpu_torch.functions as F
        from spark_rapids_tpu_torch.session import TorchSession
        rng = np.random.default_rng(0)
        n = 3000
        cols = {"k": np.array([b"A", b"N", b"R"])[rng.integers(0, 3, n)],
                "q": rng.uniform(1, 50, n),
                "d": rng.integers(0, 100, n).astype(np.int32)}
        out = []
        for comp in ("true", "false"):
            s = TorchSession({"spark.rapids.tpu.agg.compiledStage.enabled":
                              comp, "spark.rapids.sql.batchSizeRows": "1000"},
                             device="cpu")
            df = s.createDataFrame(cols, num_partitions=2)
            for d in (df, df.device_cache()):
                out.append(d.groupBy("k").agg(F.sum(F.col("q")).alias("s"))
                           .orderBy("k").collect())
                out.append(d.filter(F.col("d") < 50)
                           .agg(F.count("*").alias("c")).collect())
        assert "pyarrow" not in [m for m in sys.modules
                                 if sys.modules[m] is not None]
        canon = [[{k: round(v, 6) if isinstance(v, float) else v
                   for k, v in r.items()} for r in o] for o in out]
        assert all(o == canon[0] for o in canon[0::2]), out
        assert all(o == canon[1] for o in canon[1::2]), out
        print("ok", len(out))
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "ok 8"
