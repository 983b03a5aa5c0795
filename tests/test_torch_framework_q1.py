"""Framework-level TPC-H Q1 of the PyTorch port held against the JAX
reference: the same Arrow table through ``TpuSession`` and
``TorchSession(device="cpu")``, device-cached in several batches, then the
query bench.py's framework stage runs. Rows compare order-insensitively as
tests/asserts.py does: keys and counts exact, float64 aggregates within
rtol 1e-9 (the two packages sum in different orders)."""

import math

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu.functions as RF
import spark_rapids_tpu_torch.functions as TF
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.memory.device import TorchDeviceManager

# the CPU has no device memory to read: the tests state one for the
# budget (spark.rapids.memory.device.totalBytes)
TorchDeviceManager.initialize(device="cpu", total_bytes=8 << 30)


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
                            ("l_discount", 11)):
            mask = np.zeros(n, bool)
            mask[::every] = True
            arrays[name] = pa.array(cols[name], mask=mask)
    return pa.table(arrays)


def _query(F, df):
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


def _key(row, keys=("l_returnflag", "l_linestatus")):
    return tuple((v is None, v) for v in (row[k] for k in keys))


def _assert_rows_equal(want, got, keys=("l_returnflag", "l_linestatus")):
    assert len(want) == len(got)
    order = lambda r: _key(r, keys)  # noqa: E731
    for w, g in zip(sorted(want, key=order), sorted(got, key=order)):
        assert set(w) == set(g)
        for k in w:
            a, b = w[k], g[k]
            if isinstance(a, float) or isinstance(b, float):
                assert (a is None) == (b is None), (k, a, b)
                if a is not None and not (math.isnan(a) and math.isnan(b)):
                    assert math.isclose(a, b, rel_tol=1e-9), (k, a, b)
            else:
                assert a == b, (k, a, b)


def _small_table():
    """Nullable int/bool/string keys, NaN and zeros among the measures."""
    rng = np.random.default_rng(3)
    n = 600
    null = lambda every: np.arange(n) % every == 0  # noqa: E731
    x = rng.uniform(0, 50, n)
    x[::37] = np.nan
    z = rng.integers(0, 3, n).astype(np.float64)  # zeros: divide → null
    return pa.table({
        "k_int": pa.array(rng.integers(-2, 3, n).astype(np.int32),
                          mask=null(9)),
        "k_bool": pa.array(rng.integers(0, 2, n).astype(bool), mask=null(13)),
        "k_str": pa.array(np.array(["x", "yy", "zzz"])[rng.integers(0, 3, n)],
                          mask=null(11)),
        "x": pa.array(x, mask=null(7)),
        "y": rng.integers(-5, 100, n),
        "z": z,
    })


_SMALL_QUERIES = {
    "int_key": (("k_int",), lambda F, df: df.groupBy("k_int").agg(
        F.sum(F.col("x")).alias("s"), F.count(F.col("x")).alias("c"),
        F.min(F.col("x")).alias("lo"), F.max(F.col("y")).alias("hi"),
        F.avg(F.col("y")).alias("a"))),
    "bool_str_keys_divide": (("k_bool", "k_str"), lambda F, df: df
                             .withColumn("r", F.col("y") / F.col("z"))
                             .groupBy("k_bool", "k_str").agg(
        F.sum(F.col("r")).alias("s"), F.count("*").alias("n"),
        F.min(F.col("y")).alias("lo"), F.max(F.col("x")).alias("hi"))),
    "global_kleene_filter": ((), lambda F, df: df.filter(
        ((F.col("x") >= 1.0) & (F.col("x") < 40.0)) | (F.col("y") > 90))
        .agg(F.sum(F.col("x") * F.col("y")).alias("rev"),
             F.count(F.col("x")).alias("c"))),
    "not_equal_filter": (("k_str",), lambda F, df: df.filter(
        (F.col("k_int") != 2) & ~(F.col("y") < 0)).groupBy("k_str").agg(
        F.max(F.col("x")).alias("m"), F.sum(F.col("y")).alias("s"))),
}


@pytest.mark.parametrize("name", sorted(_SMALL_QUERIES))
def test_small_queries_match_reference(name):
    keys, query = _SMALL_QUERIES[name]
    table = _small_table()
    conf = {"spark.rapids.sql.batchSizeRows": "256"}
    want = query(RF, TpuSession(conf).createDataFrame(table)
                 .device_cache()).collect()
    q = query(TF, TorchSession(conf, device="cpu").createDataFrame(table)
              .device_cache())
    assert "TorchCompiledAggStage" in q.explain()
    _assert_rows_equal(want, q.collect(), keys)


@pytest.mark.parametrize("n,batch_rows,nulls,parts", [
    (4096, 1500, False, 1), (20000, 8000, False, 1), (4096, 1024, True, 1),
    (6000, 1000, False, 3)],
    ids=["4096", "20000", "4096-nulls", "6000-3parts"])
def test_framework_q1_matches_reference(n, batch_rows, nulls, parts):
    table = _lineitem_table(n, nulls)
    conf = {"spark.rapids.sql.batchSizeRows": str(batch_rows)}
    want = _query(RF, TpuSession(conf).createDataFrame(
        table, num_partitions=parts).device_cache()).collect()
    port = TorchSession(conf, device="cpu")
    cached = port.createDataFrame(table, num_partitions=parts).device_cache()
    assert len(cached._plan.batches()) >= 3
    q = _query(TF, cached)
    assert "TorchCompiledAggStage" in q.explain()
    _assert_rows_equal(want, q.collect())


def test_numpy_input_matches_arrow_input():
    """The main path runs on numpy alone: bytes keys in a dict of arrays
    give the same rows as the Arrow table."""
    table = _lineitem_table(3000)
    cols = {name: table.column(name).to_numpy() for name in table.column_names}
    for key in ("l_returnflag", "l_linestatus"):
        cols[key] = cols[key].astype("S")
    s = TorchSession(device="cpu")
    from_np = _query(TF, s.createDataFrame(cols)).collect()
    from_arrow = _query(TF, s.createDataFrame(table)).collect()
    _assert_rows_equal(from_arrow, from_np)


def test_list_of_dicts_and_uncached_plan():
    rows = [{"k": "a", "v": 1.5}, {"k": "b", "v": 2.0}, {"k": "a", "v": None},
            {"k": None, "v": 4.0}]
    s = TorchSession(device="cpu")
    got = (s.createDataFrame(rows).filter(TF.col("v") > 0)
           .groupBy("k").agg(TF.sum(TF.col("v")).alias("s"),
                             TF.count(TF.col("v")).alias("c"),
                             TF.min(TF.col("v")).alias("lo"),
                             TF.max(TF.col("v")).alias("hi"))).collect()
    want = TpuSession().createDataFrame(rows).filter(RF.col("v") > 0) \
        .groupBy("k").agg(RF.sum(RF.col("v")).alias("s"),
                          RF.count(RF.col("v")).alias("c"),
                          RF.min(RF.col("v")).alias("lo"),
                          RF.max(RF.col("v")).alias("hi")).collect()
    srt = lambda rs: sorted(rs, key=lambda r: (r["k"] is None, r["k"]))  # noqa: E731
    assert srt(got) == srt(want)


def test_filter_project_without_aggregate():
    table = _lineitem_table(1000)
    s = TorchSession({"spark.rapids.sql.batchSizeRows": "300"}, device="cpu")
    df = s.createDataFrame(table).filter(TF.col("l_shipdate") <= 9000) \
        .withColumn("q2", TF.col("l_quantity") * 2)
    got = df.collect()
    ship = table.column("l_shipdate").to_numpy()
    assert len(got) == int((ship <= 9000).sum())
    keep = np.nonzero(ship <= 9000)[0]
    assert [r["l_returnflag"] for r in got] == \
        [table.column("l_returnflag")[int(i)].as_py() for i in keep]
    np.testing.assert_array_equal(
        [r["q2"] for r in got], table.column("l_quantity").to_numpy()[keep] * 2)


def test_ineligible_group_key_raises_not_yet_ported():
    """A float group key is ineligible for the compiled stage: the plan
    takes the general sort-based aggregate, whose rows match the
    reference's."""
    cols = {"d": np.array([1.0, 2.0, 1.0]), "v": np.array([1, 2, 3], np.int64)}
    s = TorchSession(device="cpu")
    q = s.createDataFrame(cols).groupBy("d").agg(
        TF.sum(TF.col("v")).alias("s"))
    plan = q.explain()
    assert "TorchCompiledAggStage" not in plan
    assert "TorchHashAggregate[keys=1]" in plan
    want = TpuSession().createDataFrame(pa.table(cols)).groupBy("d").agg(
        RF.sum(RF.col("v")).alias("s")).collect()
    _assert_rows_equal(want, q.collect(), keys=("d",))


def test_max_groups_exceeded_reruns_on_the_general_path():
    """A key domain past maxGroups: the compiled stage re-runs its
    aggregate on the general path, counts the re-run, and the rows match
    the reference's."""
    table = _lineitem_table(4096)
    conf = {"spark.rapids.tpu.agg.compiled.maxGroups": "64",
            "spark.rapids.sql.batchSizeRows": "1500"}

    def query(F, df):
        return df.groupBy("l_shipdate").agg(
            F.sum(F.col("l_quantity")).alias("q"), F.count("*").alias("n"))

    want = query(RF, TpuSession(conf).createDataFrame(table)
                 .device_cache()).collect()
    s = TorchSession(conf, device="cpu")
    q = query(TF, s.createDataFrame(table).device_cache())
    assert "TorchCompiledAggStage" in q.explain()
    got = q.collect()
    assert s.counters["fallback_runs"] == 1
    _assert_rows_equal(want, got, keys=("l_shipdate",))
