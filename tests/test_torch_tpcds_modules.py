"""The expressions and aggregates this slice ports, held to the reference's
device run on the CPU:

* the variance family (``stddev``/``stddev_samp``, ``stddev_pop``,
  ``variance``/``var_samp``, ``var_pop``) by group and over the whole
  input, with groups of 0 (all null), 1 and 2 values, of large values
  around 1e9 and of integers, and a global aggregate over no rows; the
  reference's ``m2 = sumsq - sum² / n``, null for n = 0 and, in the
  sample forms, for n = 1;
* ``coalesce`` (integers, doubles, dates), ``abs`` (the smallest long
  stays itself), ``floor`` (NaN, infinities and values past the long
  range, as Java's (long) casts them), ``concat`` of strings with nulls
  and empty strings, ``isnull`` (of a column, and of a column's name).

Integers, strings and nulls exact, floats within rtol 1e-9."""

import datetime
import functools

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu.functions as RF
from spark_rapids_tpu.session import TpuSession
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu_torch.memory.device import TorchDeviceManager
from spark_rapids_tpu_torch.session import TorchSession

import test_torch_tpcds as T

TorchDeviceManager.initialize(device="cpu", total_bytes=8 << 30)

I64_MIN = -2**63


def _variance_table():
    rng = np.random.default_rng(3)
    g = np.concatenate([[0, 0, 1, 2, 2], np.full(200, 3), np.full(300, 4)])
    x = np.concatenate([[5.0, 6.0, 2.5, 1.0, 4.0],
                        1e9 + rng.normal(size=200),
                        rng.normal(size=300) * 50])
    valid = np.ones(len(g), bool)
    valid[:2] = False  # group 0: every value null
    valid[300:320] = False
    i = rng.integers(-1000, 1000, len(g)).astype(np.int64)
    return {"g": g.astype(np.int64), "x": x, "i": i}, {"x": valid}


def _expr_table():
    f = np.array([1.5, -1.5, np.nan, np.inf, -np.inf, 1e300, -1e300,
                  -0.0, 2.0, None], dtype=object)
    return {
        "a": np.array([1, I64_MIN, -7, 0, 5, 9, -2**62, 3, 4, 8], np.int64),
        "b": np.array([10, 20, 30, 40, 50, 60, 70, 80, 90, 100], np.int64),
        "f": np.array([0.0 if v is None else v for v in f], np.float64),
        "d": np.datetime64("1998-01-01")
        + np.arange(10).astype("timedelta64[D]"),
        "s": np.array(["ab", "", "cd", "", "e", "fg", "", "h", "i", "j"],
                      dtype=object),
        "t": np.array(["X", "Y", "", "Z", "", "W", "V", "", "U", "T"],
                      dtype=object),
    }, {
        "a": np.array([1, 1, 0, 1, 0, 1, 1, 1, 0, 1], bool),
        "b": np.array([1, 0, 1, 0, 1, 1, 1, 1, 0, 1], bool),
        "f": np.array([v is not None for v in f]),
        "d": np.array([1, 0, 1, 1, 0, 1, 1, 1, 1, 1], bool),
        "s": np.array([1, 1, 0, 1, 1, 0, 1, 1, 1, 1], bool),
        "t": np.array([1, 1, 1, 0, 1, 1, 0, 1, 1, 1], bool),
    }


def _frame(session, table, host_valid: bool):
    cols, valid = table()
    if host_valid:
        return session.createDataFrame(cols, num_partitions=2,
                                       validity=valid)
    arrays = {}
    for name, vals in cols.items():
        ok = valid.get(name, np.ones(len(vals), bool))
        if vals.dtype == object:
            arrays[name] = pa.array([v if k else None
                                     for v, k in zip(vals.tolist(), ok)],
                                    pa.string())
        elif vals.dtype.kind == "M":
            arrays[name] = pa.array(vals.astype("datetime64[D]").astype(
                np.int32), pa.int32(), mask=~ok).cast(pa.date32())
        else:
            arrays[name] = pa.array(vals, mask=~ok)
    return session.createDataFrame(pa.table(arrays), num_partitions=2)


def _variance_by_group(F, df):
    return df.groupBy("g").agg(
        F.stddev("x").alias("sd"), F.stddev_samp("i").alias("sd_i"),
        F.stddev_pop("x").alias("sdp"), F.variance("x").alias("var"),
        F.var_samp("i").alias("var_i"), F.var_pop("x").alias("varp"),
        F.count("x").alias("n")).sort("g")


def _variance_global(F, df):
    nothing = df.filter(F.col("g") > 100).agg(
        F.stddev("x").alias("sd"), F.var_pop("x").alias("varp"))
    return df.agg(F.stddev("x").alias("sd"), F.var_pop("x").alias("varp")) \
        .union(nothing)


def _expressions(F, df):
    return df.select(
        F.coalesce(F.col("a"), F.col("b"), F.lit(0)).alias("co_int"),
        F.coalesce(F.col("f"), F.lit(-1.0)).alias("co_dbl"),
        F.coalesce(F.col("d"), F.col("d")).alias("co_date"),
        F.abs(F.col("a")).alias("abs_a"), F.abs(F.col("f")).alias("abs_f"),
        F.floor(F.col("f")).alias("fl_f"), F.floor(F.col("b")).alias("fl_b"),
        F.floor(F.col("f") / 0.7).alias("fl_div"),
        F.concat(F.col("s"), F.lit(", "), F.col("t")).alias("cat"),
        F.concat(F.col("t"), F.col("s")).alias("cat2"),
        F.concat(F.lit(""), F.col("s")).alias("cat3"),
        F.isnull(F.col("s")).alias("nul_s"),
        # A name reads as its column (Spark's ``ColumnOrName``); the
        # reference reads it as a string literal (ROADMAP C-ref-47), so it
        # is handed the column.
        F.isnull("a" if F is PF else F.col("a")).alias("nul_a"))


CASES = {"variance_by_group": (_variance_by_group, _variance_table),
         "variance_global": (_variance_global, _variance_table),
         "expressions": (_expressions, _expr_table)}


@functools.lru_cache(maxsize=None)
def reference(case: str):
    query, table = CASES[case]
    s = TpuSession({"spark.rapids.sql.enabled": "true"})
    return query(RF, _frame(s, table, host_valid=False)).collect()


def port(case: str):
    query, table = CASES[case]
    s = TorchSession({"spark.rapids.sql.test.enabled": "true"},
                     device="cpu")
    return query(PF, _frame(s, table, host_valid=True)).collect()


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_the_reference_device_run(case):
    T.assert_rows_equal(reference(case), port(case), case)


def test_variance_nulls_for_small_groups():
    """n = 0 gives null everywhere; n = 1 gives null for the sample forms
    and 0.0 for the population ones; n = 2 is the textbook value."""
    by_g = {r["g"]: r for r in port("variance_by_group")}
    assert all(by_g[0][c] is None for c in ("sd", "sdp", "var", "varp"))
    assert by_g[1]["sd"] is None and by_g[1]["var"] is None
    assert by_g[1]["sdp"] == 0.0 and by_g[1]["varp"] == 0.0
    assert by_g[2]["var"] == pytest.approx(4.5, rel=1e-12)
    assert by_g[2]["sdp"] == pytest.approx(1.5, rel=1e-12)
    assert port("variance_global")[1] == {"sd": None, "varp": None}


def test_expression_edges():
    got = port("expressions")
    assert got[1]["abs_a"] == I64_MIN  # Java's two's-complement wrap
    assert [r["fl_f"] for r in got[2:7]] == [0, 2**63 - 1, I64_MIN,
                                             2**63 - 1, I64_MIN]
    assert got[0]["cat"] == "ab, X" and got[2]["cat"] is None
    assert got[1]["cat"] == ", Y" and got[3]["cat"] is None
    assert got[1]["co_int"] == I64_MIN and got[2]["co_int"] == 30
    assert got[8]["co_int"] == 0 and got[9]["co_dbl"] == -1.0
    assert got[1]["co_date"] is None and got[0]["co_date"] == \
        datetime.date(1998, 1, 1)
