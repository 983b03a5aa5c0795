"""The port's plan cache held against the JAX reference: fingerprint
classes, hit/miss sequences, literal re-binding and invalidation.

* The same set of logical plans falls into the same fingerprint classes in
  both packages: literal-varying plans share a key; changing the
  structure, a plan-relevant conf key or the scan gives another key.
* The same submission script gives the same hit/miss sequence, including
  ``conf.set`` / ``conf.unset`` invalidation.
* ``bench.py``'s hot_repeat shapes at a small size: six literal-varying q6
  submissions over a cached lineitem and the q3 star-join stage over the
  five market segments return the reference's rows for every literal, and
  each shape is one miss and five hits."""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import benchmarks.tpch as ref_tpch
import spark_rapids_tpu.functions as RF
import spark_rapids_tpu_torch.functions as TF
from spark_rapids_tpu.serving.plan_cache import fingerprint as ref_fp
from spark_rapids_tpu.serving.scheduler import QueryScheduler as RefSched
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch.datagen import tpch_tables
from spark_rapids_tpu_torch.serving.bench import (SEGMENTS, q3_variant,
                                                  q6_variant)
from spark_rapids_tpu_torch.serving.plan_cache import fingerprint
from spark_rapids_tpu_torch.serving.scheduler import QueryScheduler
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.memory.device import TorchDeviceManager

# the CPU has no device memory to read: the tests state one for the
# budget (spark.rapids.memory.device.totalBytes)
TorchDeviceManager.initialize(device="cpu", total_bytes=8 << 30)

REF_ONLY_OFF = {"spark.rapids.tpu.opjit.fuseStages": "false",
                "spark.rapids.tpu.coalesce.enabled": "false"}
ROWS = 1 << 12


def _table(n=64):
    return {"k": (np.arange(n) % 8).astype(np.int64),
            "v": np.arange(n, dtype=np.float64),
            "s": np.array([f"s{i % 5}" for i in range(n)], dtype=object)}


def _ref_df(s, n=64, parts=2):
    t = _table(n)
    return s.createDataFrame(pa.table({k: list(v) if v.dtype == object
                                       else v for k, v in t.items()}),
                             num_partitions=parts)


def _port_df(s, n=64, parts=2):
    return s.createDataFrame(_table(n), num_partitions=parts)


def _shapes(F, df, other_df, scan_a, scan_b):
    """name → logical plan. Names that share a class must share a key."""
    return {
        "f10": df.filter(F.col("v") > 10.0).select("k", "v"),
        "f50": df.filter(F.col("v") > 50.0).select("k", "v"),
        "f50_str": df.filter((F.col("v") > 50.0) & (F.col("s") == "s3"))
        .select("k", "v"),
        "f7_str": df.filter((F.col("v") > 7.0) & (F.col("s") == "s1"))
        .select("k", "v"),
        "f10_k": df.filter(F.col("v") > 10.0).select("k"),
        "agg_sum": df.filter(F.col("v") > 10.0).groupBy("k")
        .agg(F.sum(F.col("v")).alias("sv")),
        "agg_sum_30": df.filter(F.col("v") > 30.0).groupBy("k")
        .agg(F.sum(F.col("v")).alias("sv")),
        "agg_max": df.filter(F.col("v") > 10.0).groupBy("k")
        .agg(F.max(F.col("v")).alias("sv")),
        "other_rel": other_df.filter(F.col("v") > 10.0).select("k", "v"),
        "scan_a_1": scan_a.filter(F.col("v") > 1.0).select("k"),
        "scan_a_9": scan_a.filter(F.col("v") > 9.0).select("k"),
        "scan_b": scan_b.filter(F.col("v") > 1.0).select("k"),
    }


def _classes(keys):
    """The partition of names into classes of equal keys."""
    by = {}
    for name, key in keys.items():
        by.setdefault(key, []).append(name)
    return sorted(sorted(v) for v in by.values())


@pytest.fixture(scope="module")
def scan_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("plan_cache_scan")
    paths = []
    for name, n in (("a", 32), ("b", 48)):
        p = str(d / f"{name}.parquet")
        pq.write_table(pa.table({"k": np.arange(n) % 4,
                                 "v": np.arange(n, dtype=np.float64)}), p)
        paths.append(p)
    return paths


def test_fingerprint_classes_match_reference(scan_paths):
    out = {}
    for pkg in ("ref", "port"):
        if pkg == "ref":
            s = TpuSession(dict(REF_ONLY_OFF))
            mk, F, fp = _ref_df, RF, ref_fp
        else:
            s = TorchSession({}, device="cpu")
            mk, F, fp = _port_df, TF, fingerprint
        plans = _shapes(F, mk(s), mk(s), s.read.parquet(scan_paths[0]),
                        s.read.parquet(scan_paths[1]))
        conf = s._rapids_conf()
        keys = {n: fp(df._plan, conf).key for n, df in plans.items()}
        # a plan-relevant conf key gives another key; a scheduler key not
        s.conf.set("spark.sql.shuffle.partitions", "3")
        keys["f10_parts3"] = fp(plans["f10"]._plan, s._rapids_conf()).key
        s.conf.unset("spark.sql.shuffle.partitions")
        s.conf.set("spark.rapids.tpu.sched.maxQueuedQueries", "9")
        keys["f10_sched"] = fp(plans["f10"]._plan, s._rapids_conf()).key
        s.conf.unset("spark.rapids.tpu.sched.maxQueuedQueries")
        params = {n: [(type(p.value).__name__, p.value) for p in
                      fp(df._plan, conf).params] for n, df in plans.items()}
        out[pkg] = (_classes(keys), params)
    assert out["port"] == out["ref"]
    classes = out["port"][0]
    assert ["f10", "f10_sched", "f50"] in classes
    assert ["f50_str", "f7_str"] in classes
    assert ["agg_sum", "agg_sum_30"] in classes
    assert ["scan_a_1", "scan_a_9"] in classes
    assert ["f10_parts3"] in classes and ["other_rel"] in classes


def _script(pkg):
    """One submission script: repeats, literal changes, another shape, a
    plan-relevant and a scheduler conf change, an unset, the cache off."""
    if pkg == "ref":
        RefSched.reset_for_tests()
        s = TpuSession(dict(REF_ONLY_OFF))
        df, F = _ref_df(s), RF
    else:
        QueryScheduler.reset_for_tests()
        s = TorchSession({}, device="cpu")
        df, F = _port_df(s), TF

    def q(cut):
        return df.filter(F.col("v") > cut).groupBy("k") \
            .agg(F.sum(F.col("v")).alias("sv"))

    seq = []

    def run(x):
        rows = sorted(tuple(r.values()) for r in x.collect())
        seq.append((s._last_plan_cache, rows))

    run(q(10.0))
    run(q(10.0))
    run(q(40.0))
    run(df.filter(F.col("v") > 40.0).select("k"))
    s.conf.set("spark.rapids.tpu.sched.maxQueuedQueries", "32")
    run(q(5.0))  # a scheduler key: still a hit
    s.conf.set("spark.sql.shuffle.partitions", "5")
    run(q(5.0))  # plan-relevant: planned again
    run(q(6.0))
    s.conf.unset("spark.sql.shuffle.partitions")
    run(q(6.0))  # the entries planned under "5" went with the unset
    s.conf.set("spark.rapids.tpu.plan.cache.enabled", "false")
    run(q(6.0))
    st = (RefSched if pkg == "ref" else QueryScheduler).get() \
        .plan_cache.stats()
    return seq, {k: st[k] for k in ("hits", "misses", "invalidations",
                                     "entries")}


def test_hit_miss_sequence_matches_reference():
    want, got = _script("ref"), _script("port")
    assert [v for v, _ in got[0]] == [v for v, _ in want[0]]
    assert [v for v, _ in got[0]] == ["miss", "hit", "hit", "miss", "hit",
                                      "miss", "hit", "miss", "off"]
    for (_, w), (_, g) in zip(want[0], got[0]):
        assert [r[0] for r in g] == [r[0] for r in w]  # the int keys
        np.testing.assert_allclose(np.array(g, float), np.array(w, float),
                                   rtol=1e-9)
    assert got[1] == want[1]


def test_conf_set_invalidates_cached_plans():
    QueryScheduler.reset_for_tests()
    s = TorchSession({}, device="cpu")
    df = _port_df(s)
    df.filter(TF.col("v") > 1.0).collect()
    cache = QueryScheduler.get().plan_cache
    assert cache.stats()["entries"] == 1
    s.conf.set("spark.rapids.tpu.obs.metrics.enabled", "true")
    assert cache.stats()["entries"] == 1  # not plan-relevant
    s.conf.set("spark.rapids.sql.batchSizeRows", "1000")
    assert cache.stats()["entries"] == 0
    assert cache.stats()["invalidations"] == 1
    assert "planCache=miss" in df.filter(TF.col("v") > 1.0).explain()


# ---------------------------------------------------------------------------
# bench.py's hot_repeat shapes at a small size
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_hot():
    s = TpuSession({"spark.rapids.shuffle.mode": "ICI",
                    "spark.sql.shuffle.partitions": "8",
                    "spark.rapids.sql.batchSizeRows": str(ROWS),
                    **REF_ONLY_OFF})
    t = ref_tpch.load_tables(s, ROWS, parts=1)
    t["lineitem"] = t["lineitem"].device_cache()
    return s, t


@pytest.fixture(scope="module")
def port_hot():
    QueryScheduler.reset_for_tests()
    s = TorchSession({"spark.sql.shuffle.partitions": "8",
                      "spark.rapids.sql.batchSizeRows": str(ROWS)},
                     device="cpu")
    t = tpch_tables(s, ROWS, parts=1)
    t["lineitem"] = t["lineitem"].device_cache()
    return s, t


def test_q6_literals_rebind_to_reference_rows(ref_hot, port_hot):
    rs, rt = ref_hot
    ps, pt = port_hot
    st0 = QueryScheduler.get().plan_cache.stats()
    verdicts = []
    for i in range(6):
        want = q6_variant(rt["lineitem"], i, RF).collect()
        got = q6_variant(pt["lineitem"], i, TF).collect()
        verdicts.append(ps._last_plan_cache)
        np.testing.assert_allclose(got[0]["revenue"], want[0]["revenue"],
                                   rtol=1e-9)
    st1 = QueryScheduler.get().plan_cache.stats()
    assert verdicts == ["miss"] + ["hit"] * 5
    assert (st1["hits"] - st0["hits"], st1["misses"] - st0["misses"]) == \
        (5, 1)


@pytest.mark.parametrize("i", range(6),
                         ids=[f"{i}-{SEGMENTS[i % 5]}" for i in range(6)])
def test_q3_star_join_rebinds_each_segment(ref_hot, port_hot, i):
    """Submission i of hot_repeat's q3 (segment i mod 5) on the compiled
    star-join stage: a cache hit from i = 1 on, its dimension built for
    its own segment — never answered from another segment's build."""
    rs, rt = ref_hot
    ps, pt = port_hot
    want = q3_variant(rt, i, RF, limit=None).collect()
    q = q3_variant(pt, i, TF, limit=None)
    got = q.collect()
    assert ps._last_plan_cache == ("miss" if i == 0 else "hit")
    if i == 0:
        assert "TorchCompiledJoinAggStage" in q.explain()
    key = lambda r: r["o_orderkey"]  # noqa: E731
    want, got = sorted(want, key=key), sorted(got, key=key)
    assert [(r["o_orderkey"], r["o_orderdate"]) for r in got] == \
        [(r["o_orderkey"], r["o_orderdate"]) for r in want]
    np.testing.assert_allclose([r["revenue"] for r in got],
                               [r["revenue"] for r in want], rtol=1e-9)
    assert got, "the segment selected no rows"
