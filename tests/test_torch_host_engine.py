"""The port's host engine (the ``Cpu*`` operators over pyarrow and the
expressions' ``eval_cpu``) held to the reference's, on the CPU.

* Each exec switch of ``plan/overrides.py`` (``spark.rapids.sql.exec.<X>=
  false``), and ``spark.rapids.sql.enabled=false``, on a small query whose
  plan holds that operator: the port's rows equal the reference's under
  the same conf (integers, strings and nulls exact, floats within rtol
  1e-9), and ``explain_fallback()`` names the same operators with the
  same reasons.
* The 22 TPC-H queries with ``spark.rapids.sql.enabled=false`` (every
  operator in the host engine) at 4,096 lineitem rows in the benchmark's
  layout, against the reference's pyarrow engine, one run of each.
* TPC-DS queries that hold a union, an Expand and the window exec, with
  ``spark.rapids.sql.enabled=false``, against the reference's CPU session
  (``test_torch_tpcds.py``'s compare).

Each fallback runs only where planning put it: with test mode on, a plan
that keeps an operator off the card still fails (``test_torch_overrides``).
"""

import functools
import math

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import benchmarks.tpch as tpch
import spark_rapids_tpu.functions as RF
import spark_rapids_tpu_torch.functions as TF
import test_torch_tpcds as DS
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.window import Window as RW
from spark_rapids_tpu_torch import tpch as port_tpch
from spark_rapids_tpu_torch import tpcds as port_tpcds
from spark_rapids_tpu_torch.datagen import tpch_tables
from spark_rapids_tpu_torch.memory.device import TorchDeviceManager
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.window import Window as TW

TorchDeviceManager.initialize(device="cpu", total_bytes=8 << 30)

#: reference passes the port has not ported, off for a like-for-like plan
REF_ONLY_OFF = {"spark.rapids.tpu.opjit.fuseStages": "false",
                "spark.rapids.tpu.coalesce.enabled": "false"}
BASE = {"spark.rapids.shuffle.mode": "ICI",
        "spark.sql.shuffle.partitions": "4"}


@functools.lru_cache(maxsize=None)
def _tables(n: int = 240):
    rng = np.random.default_rng(11)
    fact = pa.table({
        "k": rng.integers(0, 12, n).astype(np.int64),
        "g": np.array(["a", "bb", "ccc", "dé"])[rng.integers(0, 4, n)],
        "x": np.round(rng.uniform(-50, 50, n), 3),
        "q": rng.integers(1, 40, n).astype(np.int32),
        "s": pa.array([None if i % 9 == 0 else f"w{i % 17}"
                       for i in range(n)], pa.string()),
    })
    dim = pa.table({"dk": np.arange(0, 12, 2, dtype=np.int64),
                    "name": [f"n{i}" for i in range(6)],
                    "lo": np.arange(6, dtype=np.int32) * 5})
    return fact, dim


class _Pkg:
    def __init__(self, F, W, session):
        self.F, self.W, self.s = F, W, session
        fact, dim = _tables()
        self.fact = session.createDataFrame(fact, num_partitions=4)
        self.fact1 = session.createDataFrame(fact)
        self.dim = session.createDataFrame(dim)


def _project(P):
    F = P.F
    return P.fact1.filter(F.col("q") > 3).select(
        (F.col("x") * 2).alias("x2"), (F.col("q") + 1).alias("q1"), "g")


def _filter(P):
    F = P.F
    return P.fact1.groupBy("k").agg(F.sum("x").alias("sx")) \
        .filter((F.col("k") > 2) & (F.col("sx") < 200))


def _sort(P):
    F = P.F
    return P.fact1.select("k", "q", "x").orderBy(F.col("q").desc(), "x")


def _aggregate(P):
    F = P.F
    return P.fact1.groupBy("g").agg(F.sum("x").alias("sx"),
                                    F.count("*").alias("n"),
                                    F.min("s").alias("ms"),
                                    F.max("q").alias("mq"),
                                    F.avg("q").alias("aq"))


def _shuffled_join(P):
    F = P.F
    return P.fact.join(P.dim, F.col("k") == F.col("dk"), "left") \
        .select("k", "q", "name")


def _broadcast_join(P):
    F = P.F
    return P.fact.join(P.dim, F.col("k") == F.col("dk")) \
        .select("k", "x", "name")


def _nested_loop(P):
    F = P.F
    return P.fact1.join(P.dim, F.col("q") < F.col("lo"), "left") \
        .select("q", "lo")


def _cartesian(P):
    F = P.F
    return P.fact1.filter(F.col("q") < 6).crossJoin(P.dim) \
        .select("q", "dk")


def _exchange(P):
    F = P.F
    return P.fact.groupBy("k").agg(F.sum("q").alias("sq"))


def _cached(P):
    F = P.F
    return P.fact1.device_cache().filter(F.col("q") > 30).select("k", "q")


def _top_n(P):
    F = P.F
    return P.fact1.select("k", "q", "x").orderBy(F.col("x").desc()).limit(7)


def _union(P):
    F = P.F
    return P.fact1.select("k", "q").union(
        P.fact1.filter(F.col("q") > 30).select("k", "q"))


def _window(P):
    F, W = P.F, P.W
    w = W.partitionBy("g").orderBy("q", "x")
    return P.fact1.select("g", "q", "x",
                          F.row_number().over(w).alias("rn"),
                          F.sum("x").over(w).alias("run"))


def _expand(P):
    F = P.F
    return P.fact1.rollup("g", "k").agg(F.sum("q").alias("sq"))


def _limit(P):
    F = P.F
    return P.fact1.filter(F.col("q") > 5).select("k", "q").limit(9)


def _file_scan(P, path):
    F = P.F
    return P.s.read.parquet(path).filter(F.col("q") > 20) \
        .groupBy("g").agg(F.sum("x").alias("sx"))


#: exec switch → (query, its conf, ordered): each plan holds that exec
EXEC_CASES = {
    "ProjectExec": (_project, {}, False),
    "FilterExec": (_filter, {}, False),
    "SortExec": (_sort, {}, True),
    "HashAggregateExec": (_aggregate, {}, False),
    "ShuffledHashJoinExec": (_shuffled_join,
                             {"spark.sql.autoBroadcastJoinThreshold": "-1"},
                             False),
    "BroadcastHashJoinExec": (_broadcast_join, {}, False),
    "BroadcastNestedLoopJoinExec": (_nested_loop, {}, False),
    "CartesianProductExec": (_cartesian,
                             {"spark.sql.autoBroadcastJoinThreshold": "1"},
                             False),
    "ShuffleExchangeExec": (_exchange, {}, False),
    "InMemoryTableScanExec": (_cached, {}, False),
    "FileSourceScanExec": (_file_scan, {}, False),
    "TakeOrderedAndProjectExec": (_top_n, {}, True),
    "UnionExec": (_union, {}, False),
    "WindowExec": (_window, {}, False),
    "ExpandExec": (_expand, {}, False),
    "LocalLimitExec": (_limit, {}, True),
    "GlobalLimitExec": (_limit, {}, True),
}


def _key(row):
    return repr([(k, v) for k, v in sorted(row.items())
                 if not isinstance(v, float)]) + repr(
        sorted((k, round(v, 6)) for k, v in row.items()
               if isinstance(v, float)))


def assert_same_rows(want, got, ordered: bool, what: str) -> None:
    """Integers, strings and nulls exact, floats within rtol 1e-9; rows in
    order where the query orders them."""
    assert want and len(got) == len(want), (what, len(got), len(want))
    if not ordered:
        want, got = sorted(want, key=_key), sorted(got, key=_key)
    for w, g in zip(want, got):
        assert sorted(g) == sorted(w), what
        for k, v in w.items():
            if isinstance(v, float) and isinstance(g[k], float):
                assert math.isclose(g[k], v, rel_tol=1e-9) or (
                    math.isnan(v) and math.isnan(g[k])), (what, k, g, w)
            else:
                assert g[k] == v, (what, k, g, w)


def _run_both(build, conf, tmp_path=None):
    """(reference DataFrame, port DataFrame) of one query under ``conf``."""
    ref = _Pkg(RF, RW, TpuSession(dict(REF_ONLY_OFF, **BASE, **conf)))
    port = _Pkg(TF, TW, TorchSession(dict(BASE, **conf), device="cpu"))
    if tmp_path is None:
        return build(ref), build(port)
    path = str(tmp_path / "fact.parquet")
    pq.write_table(_tables()[0], path)
    return build(ref, path), build(port, path)


@pytest.mark.parametrize("exec_name", sorted(EXEC_CASES))
def test_exec_switched_off_runs_in_the_host_engine(exec_name, tmp_path):
    build, extra, ordered = EXEC_CASES[exec_name]
    key = f"spark.rapids.sql.exec.{exec_name}"
    conf = dict(extra, **{key: "false"})
    ref, port = _run_both(build, conf,
                          tmp_path if exec_name == "FileSourceScanExec"
                          else None)
    reasons = port.explain_fallback()
    assert f"disabled via {key}" in reasons, reasons
    # the port's explain_fallback() ends with its scan's demotions line
    assert "\n".join(ln for ln in reasons.splitlines()
                     if not ln.startswith("scan:")) == ref.explain_fallback()
    plan = port.explain().split("== Physical Plan ==")[-1]
    # transitions at the CPU operator's edges: nothing left un-converted
    # but the switched-off operator and the host leaves
    assert "DeviceToHostExec" in plan
    assert_same_rows(ref.collect(), port.collect(), ordered, exec_name)


def test_sql_disabled_runs_every_operator_on_the_host():
    conf = {"spark.rapids.sql.enabled": "false"}
    ref, port = _run_both(_window, conf)
    plan = port.explain().split("== Physical Plan ==")[-1]
    assert not [ln for ln in plan.splitlines()
                if ln.lstrip().startswith("* ")], plan
    assert_same_rows(ref.collect(), port.collect(), False, "sql disabled")


def test_disabled_expression_keeps_only_its_operator_on_the_host():
    conf = {"spark.rapids.sql.expression.Multiply": "false"}
    ref, port = _run_both(_project, conf)
    assert port.explain_fallback() == ref.explain_fallback()
    assert "CpuProject" in port.explain()
    assert_same_rows(ref.collect(), port.collect(), False, "Multiply off")


# ---------------------------------------------------------------------------
# the 22 TPC-H queries with every operator on the host
# ---------------------------------------------------------------------------

TPCH_ROWS = 1 << 12
TPCH_CONF = {"spark.rapids.shuffle.mode": "ICI",
             "spark.sql.shuffle.partitions": "8",
             "spark.rapids.sql.enabled": "false"}
#: queries with ORDER BY over every output row (the others' order is the
#: host engine's: compared as sets)
ORDERED = {"q1", "q2", "q3", "q4", "q5", "q7", "q8", "q9", "q10", "q11",
           "q12", "q13", "q16", "q18", "q20", "q21", "q22"}


@functools.lru_cache(maxsize=None)
def _tpch_sessions():
    ref = TpuSession(dict(TPCH_CONF))
    port = TorchSession(dict(TPCH_CONF), device="cpu")
    return (ref, tpch.load_tables(ref, TPCH_ROWS, parts=4),
            port, tpch_tables(port, TPCH_ROWS, 4))


@pytest.mark.parametrize("query", sorted(port_tpch.QUERIES,
                                         key=lambda q: int(q[1:])))
def test_tpch_query_in_the_host_engine_matches_the_reference(query):
    ref_s, ref_t, _, port_t = _tpch_sessions()
    want = tpch.QUERIES[query](ref_s, ref_t).collect()
    q = port_tpch.QUERIES[query](port_t)
    plan = q.explain().split("== Physical Plan ==")[-1]
    assert not [ln for ln in plan.splitlines()
                if ln.lstrip().startswith("* ")], plan
    got = q.collect()
    if not want:  # q8 and q21 have no rows at this size
        assert got == []
        return
    assert_same_rows(want, got, query in ORDERED, query)


# ---------------------------------------------------------------------------
# TPC-DS: union, Expand and the window exec on the host
# ---------------------------------------------------------------------------

#: q38: the set operations' union; q36 and q27: rollup (Expand); q98 and
#: q12: the window exec
DS_QUERIES = ["q12", "q27", "q36", "q38", "q98"]


@functools.lru_cache(maxsize=None)
def _ds_port():
    s = TorchSession({"spark.rapids.shuffle.mode": "ICI",
                      "spark.sql.shuffle.partitions": "4",
                      "spark.rapids.sql.enabled": "false"}, device="cpu")
    return s, port_tpcds.load_tables(s, DS.ROWS)


@pytest.mark.parametrize("query", DS_QUERIES)
def test_tpcds_query_in_the_host_engine_matches_the_reference(query):
    s, t = _ds_port()
    q = port_tpcds.QUERIES[query](s, t)
    got = q.collect()
    want_cols, want = DS.reference_rows(query, DS.ROWS)
    DS.assert_rows_match(want_cols, want, q.columns, got, query)
