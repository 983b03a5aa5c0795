"""The DataFrame and session surface of the port held to the reference on
the CPU: range, sample, repartition and coalesce, joins on column names,
dropDuplicates with First/Last, eqNullSafe, DDL schemas, the actions
(count, show, toPandas, to_arrow) and the device handoff
(``to_device_batches``, ``to_device_arrays``).

Each query runs the same seeded input through the reference's host engine
(``TpuSession`` with ``spark.rapids.sql.enabled=false``: pyarrow, no JAX
compile) and through ``TorchSession(device="cpu")`` with the device path
on (test mode: every operator converts) and off. Integers, strings, null
masks, sampled row sets and partition row counts match exactly; floats
within rtol 1e-9 (``asserts._assert_value_equal``, approx). One reference run a
query and table.
"""

import functools
import io
from contextlib import redirect_stdout

import numpy as np
import pyarrow as pa
import pytest
import torch

import chip_smoke
import spark_rapids_tpu.functions as RF
import spark_rapids_tpu_torch.functions as TF
from asserts import _assert_value_equal, _rows_sort_key
from spark_rapids_tpu.execs.base import TaskContext as RefTaskContext
from spark_rapids_tpu.plan.optimizer import optimize_logical as ref_optimize
from spark_rapids_tpu.plan.planner import plan_physical as ref_plan
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.types import parse_ddl as ref_parse_ddl
from spark_rapids_tpu_torch.memory.device import TorchDeviceManager
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.types import parse_ddl

TorchDeviceManager.initialize(device="cpu", total_bytes=8 << 30)

BASE = {"spark.rapids.shuffle.mode": "ICI",
        "spark.sql.shuffle.partitions": "4"}
DEVICE = dict(BASE, **{"spark.rapids.sql.test.enabled": "true"})
HOST = dict(BASE, **{"spark.rapids.sql.enabled": "false"})


@functools.lru_cache(maxsize=None)
def _ref():
    return TpuSession(dict(HOST))


@functools.lru_cache(maxsize=None)
def _port(on_device: bool = True):
    return TorchSession(dict(DEVICE if on_device else HOST), device="cpu")


@functools.lru_cache(maxsize=None)
def _table(n: int = 3000, seed: int = 5) -> pa.Table:
    """Ints with nulls, doubles with NaN and nulls, strings with nulls,
    a small key domain."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 37, n).astype(np.int64)
    x = np.round(rng.uniform(-100, 100, n), 4)
    x[rng.random(n) < 0.02] = np.nan
    return pa.table({
        "k": pa.array(k, mask=rng.random(n) < 0.05),
        "i": pa.array(rng.integers(-1000, 1000, n).astype(np.int32)),
        "x": pa.array(x, mask=rng.random(n) < 0.05),
        "s": pa.array([None if v < 0.07 else f"w{int(v * 97) % 23}"
                       for v in rng.random(n)], pa.string()),
    })


def _frames(build, parts: int = 3):
    """(reference df, port device df, port host df) of ``build(session,
    frame)`` over the seeded table in ``parts`` partitions."""
    t = _table()
    return (build(_ref(), _ref().createDataFrame(t, num_partitions=parts)),
            build(_port(True), _port(True).createDataFrame(
                t, num_partitions=parts)),
            build(_port(False), _port(False).createDataFrame(
                t, num_partitions=parts)))


def _same_rows(got, want, ordered: bool = False) -> None:
    assert len(got) == len(want), (len(got), len(want))
    if not ordered:
        got = sorted(got, key=_rows_sort_key)
        want = sorted(want, key=_rows_sort_key)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_value_equal(w, g, f"row[{i}]", True)


def _check(build, ordered: bool = False, parts: int = 3):
    ref, dev, host = _frames(build, parts)
    want = ref.collect()
    for df in (dev, host):
        _same_rows(df.collect(), want, ordered)
    return want


def _ref_partition_counts(df) -> list:
    """Rows in each output partition of the reference's CPU plan."""
    conf = df.session._rapids_conf()
    plan = ref_plan(ref_optimize(df._plan, conf)[0], conf)
    out = []
    for p in range(plan.num_partitions()):
        ctx = RefTaskContext(p, conf)
        try:
            out.append(sum(t.num_rows for t in plan.execute_partition(p, ctx)))
        finally:
            ctx.complete()
    for node in plan.collect_nodes():
        if hasattr(node, "cleanup_shuffle"):
            node.cleanup_shuffle(conf)
    return out


# --- range -------------------------------------------------------------------

@pytest.mark.parametrize("args", [(0, 1000, 3, 1), (1000, 0, -7, 4),
                                  (5, 6, 1, 3), (10, 10, 1, 2),
                                  (-50, 4000, 11, 4)])
def test_range(args):
    start, end, step, parts = args
    want = _ref().range(start, end, step, numPartitions=parts).select(
        (RF.col("id") * 2).alias("x")).collect()
    for on_device in (True, False):
        s = _port(on_device)
        df = s.range(start, end, step, numPartitions=parts)
        _same_rows(df.select((TF.col("id") * 2).alias("x")).collect(), want,
                   ordered=True)
        assert df.count() == len(want)
    counts = _ref_partition_counts(
        _ref().range(start, end, step, numPartitions=parts))
    dev = _port(True).range(start, end, step, numPartitions=parts)
    assert [sum(b.num_rows for b in p) for p in dev._device_partitions()] \
        == counts
    assert "TorchRange" in dev.explain()


def test_range_single_argument_and_schema():
    df = _port(True).range(5)
    assert df.columns == ["id"] and [r["id"] for r in df.collect()] \
        == list(range(5))
    assert df.schema.fields[0].data_type.simple_string() == "bigint"
    assert not df.schema.fields[0].nullable


# --- sample ------------------------------------------------------------------

@pytest.mark.parametrize("form", ["bernoulli", "replace", "positional"])
def test_sample_rows_equal_reference(form):
    def build(s, df):
        if form == "bernoulli":
            return df.sample(fraction=0.25, seed=11)
        if form == "replace":
            return df.sample(True, 0.5, seed=3)
        return df.sample(0.5, 3)
    want = _check(build, ordered=True)
    assert 0 < len(want) < 3000 * 1.5
    ref, dev, _ = _frames(build)
    # the same rows partition by partition
    assert [sum(b.num_rows for b in p) for p in dev._device_partitions()] \
        == _ref_partition_counts(ref)
    assert "TorchSample" in dev.explain()


def test_sample_uniforms_match_reference_bits():
    from spark_rapids_tpu.execs.sample import _uniform_np as ref_uniform
    from spark_rapids_tpu_torch.execs.sample import (uniform_np,
                                                     uniform_torch)
    for seed, part, start in ((0, 0, 0), (11, 3, 4095), (2**40 + 7, 9,
                                                         2**32 - 5)):
        want = ref_uniform(seed, part, start, 5000)
        np.testing.assert_array_equal(uniform_np(seed, part, start, 5000),
                                      want)
        np.testing.assert_array_equal(
            uniform_torch(seed, part, start, 5000, "cpu").numpy(), want)
        np.testing.assert_array_equal(
            chip_smoke.sample_uniforms(seed, part, start, 5000), want)


def test_sample_fraction_bounds_and_seeds():
    n = 20000
    df = _port(True).createDataFrame({"a": np.arange(n)})
    got = df.sample(fraction=0.1, seed=5).count()
    assert 0.08 * n < got < 0.12 * n
    assert df.sample(fraction=0.1, seed=5).count() == got
    assert df.sample(fraction=0.1, seed=6).count() != got
    r1 = {r["a"] for r in df.sample(0.3).collect()}
    r2 = {r["a"] for r in df.sample(0.3).collect()}
    assert r1 != r2  # an unseeded sample draws its seed


# --- repartition and coalesce ------------------------------------------------

@pytest.mark.parametrize("how", ["roundrobin", "hash", "hash2", "coalesce",
                                 "coalesce_noop", "filtered"])
def test_repartition_partition_counts(how):
    def build(s, df):
        if how == "roundrobin":
            return df.repartition(5)
        if how == "hash":
            return df.repartition(4, "k")
        if how == "hash2":
            return df.repartition(3, "s", "i")
        if how == "coalesce":
            return df.coalesce(2)
        if how == "coalesce_noop":
            return df.coalesce(8)
        # a filter above the exchange moves below it (pushdown)
        fn = RF if isinstance(s, TpuSession) else TF
        return df.repartition(4).filter(fn.col("i") > 0)
    want = _check(build)
    ref, dev, host = _frames(build)
    counts = _ref_partition_counts(ref)
    assert sum(counts) == len(want)
    for df in (dev, host):
        assert [sum(b.num_rows for b in p)
                for p in df._device_partitions()] == counts


def test_repartition_keeps_source_rows():
    t = _table()
    df = _port(True).createDataFrame(t, num_partitions=3)
    _same_rows(df.repartition(7).collect(), df.collect())
    assert "TorchShuffleExchange[roundrobin, n=7]" in \
        df.repartition(7).explain()
    assert df.coalesce(1).explain().count("TorchShuffleExchange") == 1


# --- joins on names ----------------------------------------------------------

def _join_frames(s):
    rng = np.random.default_rng(9)
    a = pa.table({"k": pa.array(rng.integers(0, 30, 400), mask=rng.random(
        400) < 0.05), "j": rng.integers(0, 3, 400), "v": rng.random(400)})
    b = pa.table({"k": np.arange(0, 40, 2), "j": np.arange(20) % 3,
                  "w": [f"r{i}" for i in range(20)]})
    return s.createDataFrame(a, num_partitions=2), \
        s.createDataFrame(b, num_partitions=2)


@pytest.mark.parametrize("how", ["inner", "left", "right", "full",
                                 "leftsemi", "leftanti"])
@pytest.mark.parametrize("on", ["k", ["k", "j"]])
def test_join_on_names(how, on):
    keys = [on] if isinstance(on, str) else on
    ra, rb = _join_frames(_ref())
    cond = None
    for k in keys:
        c = ra[k] == rb[k]
        cond = c if cond is None else cond & c
    # the reference's host engine fails on a join on names of these tables
    # (an IndexError binding its Project over the join), and the reference
    # keeps the left's key for a right or full join (C-ref-22): its
    # condition join's rows, put in Spark's USING form, are the oracle
    t = ra.join(rb, cond, how).to_arrow()
    n_left = len(ra.columns)
    want = []
    for row in zip(*[t.column(i).to_pylist() for i in range(t.num_columns)]):
        left = dict(zip(ra.columns, row[:n_left]))
        if how in ("leftsemi", "leftanti"):
            want.append(left)
            continue
        right = dict(zip(rb.columns, row[n_left:]))
        r = {k: right[k] if how == "right" else
             (right[k] if how == "full" and left[k] is None else left[k])
             for k in keys}
        r.update({c: v for c, v in left.items() if c not in keys})
        r.update({c: v for c, v in right.items() if c not in keys})
        want.append(r)
    for s in (_port(True), _port(False)):
        a, b = _join_frames(s)
        df = a.join(b, on, how)
        _same_rows(df.collect(), want)
        if how in ("leftsemi", "leftanti"):
            assert df.columns == a.columns
        else:
            # Spark's USING order: the keys, then each side's other columns
            assert df.columns == keys + [c for c in a.columns
                                         if c not in keys] + \
                [c for c in b.columns if c not in keys]


def test_join_key_types_widen():
    a = _port(True).createDataFrame({"k": np.arange(5, dtype=np.int32)})
    b = _port(True).createDataFrame({"k": np.arange(3, 8, dtype=np.int64),
                                     "v": np.arange(5.0)})
    assert sorted(r["k"] for r in a.join(b, "k").collect()) == [3, 4]


# --- dropDuplicates, First and Last, eqNullSafe, set operations --------------

def test_drop_duplicates_subset_and_order():
    t = pa.table({"k": [1, 1, 2, 2, 3], "v": ["a", "b", "c", "d", "e"],
                  "w": [10, 11, 12, 13, 14]})
    for s in (_port(True), _port(False), _ref()):
        out = s.createDataFrame(t).dropDuplicates(["k"]).to_arrow()
        assert out.column_names == ["k", "v", "w"]
        assert sorted(map(tuple, (r.values() for r in out.to_pylist()))) \
            == [(1, "a", 10), (2, "c", 12), (3, "e", 14)]


@pytest.mark.parametrize("subset", [["k"], ["s"], ["k", "s"], None])
def test_drop_duplicates_vs_reference(subset):
    # one partition: "first" is then the first row in input order for
    # every engine (across partitions it follows the exchange's order)
    _check(lambda s, df: df.dropDuplicates(subset), parts=1)
    _check(lambda s, df: df.dropDuplicates(subset), parts=3)


@pytest.mark.parametrize("ignore_nulls", [False, True])
@pytest.mark.parametrize("grouped", [True, False])
def test_first_last(ignore_nulls, grouped):
    def build(s, df):
        fn = RF if isinstance(s, TpuSession) else TF
        aggs = [fn.first("s", ignore_nulls).alias("fs"),
                fn.last("s", ignore_nulls).alias("ls"),
                fn.first(fn.col("x"), ignore_nulls).alias("fx"),
                fn.last(fn.col("k"), ignore_nulls).alias("lk"),
                fn.count("i").alias("n")]
        return df.groupBy("k").agg(*aggs) if grouped else df.agg(*aggs)
    _check(build, parts=1)
    _check(build, parts=3)


def test_eq_null_safe():
    def build(s, df):
        fn = RF if isinstance(s, TpuSession) else TF
        c = fn.col
        return df.select(
            c("k").eqNullSafe(7).alias("k7"),
            c("k").eqNullSafe(fn.lit(None)).alias("knull"),
            c("s").eqNullSafe("w3").alias("sw3"),
            c("s").eqNullSafe(c("s")).alias("ss"),
            c("x").eqNullSafe(c("x")).alias("xx"),
            c("x").eqNullSafe(float("nan")).alias("xnan"),
            c("i").eqNullSafe(c("k")).alias("ik"))
    want = _check(build, ordered=True)
    assert all(r["ss"] and r["xx"] for r in want)
    assert not any(v is None for r in want for v in r.values())


def test_intersect_except_null_safe():
    def run(s):
        a = s.createDataFrame(pa.table(
            {"x": [1, 2, 3, None, 2, 2],
             "y": ["a", "b", "c", None, "b", "B"]}))
        b = s.createDataFrame(pa.table(
            {"x": [2, None, 9, 3], "y": ["b", None, "z", "nope"]}))
        return [sorted(map(str, q.collect())) for q in
                (a.intersect(b), a.exceptDistinct(b), a.subtract(b))]
    want = run(_ref())
    assert run(_port(True)) == want and run(_port(False)) == want
    assert "{'x': None, 'y': None}" in want[0]


# --- the DataFrame's other methods -------------------------------------------

@pytest.mark.parametrize("case", ["drop", "renamed", "selectExpr", "col",
                                  "sortWithin", "count", "sum", "avg",
                                  "mean", "min", "max"])
def test_frame_methods(case):
    def build(s, df):
        if case == "drop":
            return df.drop("x", "nope")
        if case == "renamed":
            return df.withColumnRenamed("s", "t")
        if case == "selectExpr":
            return df.selectExpr("s", "k")
        if case == "col":
            return df.select(df.col("i"), df["k"])
        if case == "sortWithin":
            return df.sortWithinPartitions("i", "k")
        g = df.groupBy("k")
        if case == "count":
            return g.count()
        if case in ("min", "max"):
            return getattr(g, case)("i", "s", "x")
        return getattr(g, case)("i", "x")
    want = _check(build, ordered=case == "sortWithin", parts=1)
    ref, dev, _ = _frames(build, 1)
    assert dev.columns == ref.columns and want


def test_actions_count_show_pandas_arrow():
    ref, dev, host = _frames(lambda s, df: df)
    want = ref.to_arrow()
    for df in (dev, host):
        assert df.count() == want.num_rows
        got = df.to_arrow()
        assert got.schema == want.schema
        _same_rows(got.to_pylist(), want.to_pylist(), ordered=True)
        pdf = df.toPandas()
        assert list(pdf.columns) == want.column_names \
            and len(pdf) == want.num_rows
        buf = io.StringIO()
        with redirect_stdout(buf):
            df.select("k", "s").show(3)
        rows = want.slice(0, 3).to_pylist()
        cells = [["null" if r[c] is None else str(r[c]) for c in ("k", "s")]
                 for r in rows]
        w = [max(3, len(c), *(len(r[i]) for r in cells))
             for i, c in enumerate(("k", "s"))]
        sep = "+" + "+".join("-" * x for x in w) + "+"
        lines = [sep, "|" + "|".join(c.rjust(x) for c, x in
                                     zip(("k", "s"), w)) + "|", sep]
        lines += ["|" + "|".join(v.rjust(x) for v, x in zip(r, w)) + "|"
                  for r in cells]
        lines += [sep, "only showing top 3 rows"]
        assert buf.getvalue() == "\n".join(lines) + "\n"
    assert dev.filter(TF.col("i") > 5000).count() == 0


def test_schema_and_ddl():
    for ddl in ("a INT, b STRING", "a: bigint, `b` double",
                "struct<x: tinyint, y: smallint, z: boolean>",
                "d DATE, t TIMESTAMP, m decimal(12, 3), n binary, f float"):
        got, want = parse_ddl(ddl), ref_parse_ddl(ddl)
        assert got.simple_string() == want.simple_string()
        assert [f.name for f in got.fields] == [f.name for f in want.fields]
    with pytest.raises(NotImplementedError, match="A6"):
        parse_ddl("a array<int>")
    df = _port(True).createDataFrame(_table())
    assert df.schema.simple_string() == \
        _ref().createDataFrame(_table()).schema.simple_string()


def test_builder_and_create_forms():
    s = TorchSession.builder.appName("t").config(
        "spark.rapids.sql.test.enabled", "true").master("local").getOrCreate(
        device="cpu")
    assert s.conf.get("spark.app.name") == "t"
    rows = [(1, "a"), (2, None)]
    for schema in (["n", "s"], "n BIGINT, s STRING", parse_ddl(
            "n bigint, s string")):
        assert s.createDataFrame(rows, schema).collect() == \
            [{"n": 1, "s": "a"}, {"n": 2, "s": None}]
    import pandas as pd
    pdf = pd.DataFrame({"n": [1, 2], "x": [0.5, None]})
    got = s.createDataFrame(pdf).collect()
    assert got[0] == {"n": 1, "x": 0.5} and got[1]["x"] is None
    s.stop()


# --- the device handoff ------------------------------------------------------

def test_to_device_batches_and_arrays():
    ref, dev, host = _frames(lambda s, df: df.select("k", "x", "s"))
    want = ref.collect()
    for df in (dev, host):
        batches = df.to_device_batches()
        assert all(b.device.type == "cpu" for b in batches)
        assert sum(b.num_rows for b in batches) == len(want)
        arrays = df.to_device_arrays()
        assert set(arrays) == {"k", "k__valid", "x", "x__valid", "s"}
        rows = df.collect()
        valid = np.array([r["k"] is not None for r in rows])
        np.testing.assert_array_equal(arrays["k__valid"].numpy(), valid)
        np.testing.assert_array_equal(
            arrays["k"].numpy(),
            np.array([0 if r["k"] is None else r["k"] for r in rows]))
        assert isinstance(arrays["k"], torch.Tensor)
        assert arrays["s"].to_pylist() == [r["s"] for r in rows]
        _same_rows(rows, want, ordered=True)
    empty = dev.filter(TF.col("k") > 5000).to_device_arrays()
    assert empty["k"].shape == (0,) and empty["k"].dtype == torch.int64


def test_to_device_arrays_feed_torch():
    """The ColumnarRdd use: result columns feed a torch computation with no
    host round trip (the reference's jax twin)."""
    t = pa.table({"x": pa.array([float(i) for i in range(1000)]),
                  "y": pa.array([2.0 * i + 1 for i in range(1000)])})
    want = _ref().createDataFrame(t).filter(RF.col("x") < 500.0).collect()
    arrays = _port(True).createDataFrame(t).filter(
        TF.col("x") < 500.0).to_device_arrays()
    x, y = arrays["x"], arrays["y"]
    assert x.shape[0] == len(want) == 500
    slope = float((x * y).sum() / (x * x).sum().clamp(min=1e-9))
    assert abs(slope - 2.0) < 0.1


# --- chip_smoke.py phase 16, rehearsed off the card --------------------------

def test_chip_smoke_phase16_rehearsal(tmp_path):
    """Phase 16's every check at small sizes on the CPU."""
    from spark_rapids_tpu_torch.datagen import tpch_host_tables
    li = tpch_host_tables(1 << 13, 4, ["lineitem"])["lineitem"]
    chip_smoke.surface_paths(TF, TorchSession, "cpu", li, str(tmp_path),
                             device="cpu", range_rows=1 << 14,
                             text_rows=1 << 11, json_rows=1 << 10,
                             q1_rows=1 << 13)
