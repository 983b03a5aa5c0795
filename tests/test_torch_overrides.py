"""The port's planning route held against the JAX reference: optimizer →
CPU plan → override engine → transitions → compiled stages.

``explain()`` of the same query must print the same operator trees in both
packages (node names mapped Tpu → Torch; the reference runs without the
segment fusion and batch coalescing the port has not ported; both
print the plan cache's ``planCache=`` verdict first), and the fallback
reasons must read the same."""

import functools

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

#: reference passes the port has not ported, off for a like-for-like plan
REF_ONLY_OFF = {"spark.rapids.tpu.opjit.fuseStages": "false",
                "spark.rapids.tpu.coalesce.enabled": "false"}


@functools.lru_cache(maxsize=None)
def _table(n: int = 2000):
    rng = np.random.default_rng(42)
    return pa.table({
        "l_returnflag": np.array(["A", "N", "R"])[rng.integers(0, 3, n)],
        "l_linestatus": np.array(["F", "O"])[rng.integers(0, 2, n)],
        "l_quantity": rng.uniform(1, 50, n),
        "l_extendedprice": rng.uniform(900, 100000, n),
        "l_discount": rng.uniform(0, 0.1, n),
        "l_tax": rng.uniform(0, 0.08, n),
        "l_shipdate": rng.integers(8766, 10957, n).astype(np.int32),
    })


def _q1(F, df):
    return (df.filter(F.col("l_shipdate") <= 10471)
            .withColumn("disc_price",
                        F.col("l_extendedprice") * (1 - F.col("l_discount")))
            .withColumn("charge",
                        F.col("l_extendedprice") * (1 - F.col("l_discount"))
                        * (1 + F.col("l_tax")))
            .groupBy("l_returnflag", "l_linestatus")
            .agg(F.sum(F.col("l_quantity")).alias("sum_qty"),
                 F.sum(F.col("disc_price")).alias("sum_disc_price"),
                 F.avg(F.col("l_discount")).alias("avg_disc"),
                 F.count(F.col("l_quantity")).alias("count_order")))


def _q6(F, df):
    return (df.filter((F.col("l_shipdate") >= 8766)
                      & (F.col("l_shipdate") < 9131)
                      & (F.col("l_discount") >= 0.05)
                      & (F.col("l_discount") <= 0.07)
                      & (F.col("l_quantity") < 24))
            .agg(F.sum(F.col("l_extendedprice") * F.col("l_discount"))
                 .alias("revenue")))


def _q1_sorted(F, df):
    return _q1(F, df).orderBy("l_returnflag", "l_linestatus")


QUERIES = {"q1": _q1, "q6": _q6, "q1_sorted": _q1_sorted}


def _device_nodes(tree: str):
    """The lines of a physical plan marked '*' (device operators)."""
    return [line for line in tree.splitlines()
            if line.lstrip().startswith("* ")]


def _plans(name, conf, cached):
    """(reference explain, port explain), the reference's mapped to the
    port's names."""
    q = QUERIES[name]
    ref = TpuSession(dict(REF_ONLY_OFF, **conf)).createDataFrame(_table())
    port = TorchSession(dict(conf), device="cpu").createDataFrame(_table())
    if cached:
        ref, port = ref.device_cache(), port.device_cache()
    want = q(RF, ref).explain()
    got = q(TF, port).explain()
    want = "\n".join(line.replace("Tpu", "Torch")
                     for line in want.splitlines())
    return want, got


@pytest.mark.parametrize("compiled", ["true", "false"])
@pytest.mark.parametrize("cached", [True, False], ids=["cached", "local"])
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_explain_matches_reference(name, cached, compiled):
    conf = {"spark.rapids.tpu.agg.compiledStage.enabled": compiled}
    want, got = _plans(name, conf, cached)
    assert got == want
    assert got.startswith("planCache=miss\nappliedRules=ColumnPruning\n")
    assert ("TorchCompiledAggStage" in got) == (compiled == "true")
    assert got.splitlines()[got.splitlines().index(
        "== Physical Plan ==") + 1] == "  DeviceToHostExec"


def _group_key(row):
    return (row["l_returnflag"], row["l_linestatus"])


def _assert_rows(want, got):
    """The same rows in the same order: keys and counts exact, floats
    within rtol 1e-9."""
    assert want and len(got) == len(want)
    for w, g in zip(want, got):
        assert list(g) == list(w)
        for k, v in w.items():
            if isinstance(v, float):
                np.testing.assert_allclose(g[k], v, rtol=1e-9)
            else:
                assert g[k] == v


def test_sql_disabled_plans_cpu_execs_like_the_reference():
    conf = {"spark.rapids.sql.enabled": "false"}
    want, got = _plans("q1_sorted", conf, cached=False)
    assert got == want
    physical = got.split("== Physical Plan ==\n")[1]
    assert not _device_nodes(physical) and "CpuHashAggregate" in physical
    # every operator runs in the host engine, with the reference's rows
    df = TorchSession(conf, device="cpu").createDataFrame(_table())
    ref = TpuSession(dict(REF_ONLY_OFF, **conf)).createDataFrame(_table())
    _assert_rows(_q1_sorted(RF, ref).collect(),
                 _q1_sorted(TF, df).collect())


def test_disabled_exec_falls_back_with_the_reference_reason():
    conf = {"spark.rapids.sql.exec.HashAggregateExec": "false"}
    ref = _q1(RF, TpuSession(dict(REF_ONLY_OFF, **conf))
              .createDataFrame(_table()))
    port = _q1(TF, TorchSession(conf, device="cpu")
               .createDataFrame(_table()))
    reasons = port.explain_fallback()
    assert reasons == ref.explain_fallback()
    assert ("!Exec CpuHashAggregateExec cannot run on TPU: disabled via "
            "spark.rapids.sql.exec.HashAggregateExec") in reasons
    want = "\n".join(line.replace("Tpu", "Torch")
                     for line in ref.explain().splitlines())
    assert port.explain() == want
    # the aggregate runs in the host engine between its transitions
    _assert_rows(sorted(ref.collect(), key=_group_key),
                 sorted(port.collect(), key=_group_key))


def test_disabled_expression_keeps_its_operator_on_the_cpu():
    conf = {"spark.rapids.sql.expression.Multiply": "false"}
    ref = _q6(RF, TpuSession(dict(REF_ONLY_OFF, **conf))
              .createDataFrame(_table()))
    port = _q6(TF, TorchSession(conf, device="cpu").createDataFrame(_table()))
    assert port.explain_fallback() == ref.explain_fallback()
    assert "has been disabled via spark.rapids.sql.expression.Multiply" \
        in port.explain_fallback()


def test_test_mode_asserts_the_whole_plan_converted():
    conf = {"spark.rapids.sql.exec.HashAggregateExec": "false",
            "spark.rapids.sql.test.enabled": "true"}
    df = TorchSession(conf, device="cpu").createDataFrame(_table())
    with pytest.raises(AssertionError, match="Part of the plan is not "
                       "columnar: CpuHashAggregate"):
        _q1(TF, df).collect()
    with pytest.raises(AssertionError):
        _q1(RF, TpuSession(dict(REF_ONLY_OFF, **conf))
            .createDataFrame(_table())).collect()
    # the whole plan on the device passes the same check
    ok = TorchSession({"spark.rapids.sql.test.enabled": "true",
                       "spark.rapids.tpu.agg.compiledStage.enabled": "false"},
                      device="cpu")
    assert len(_q1(TF, ok.createDataFrame(_table()).device_cache())
               .collect()) == 6


def test_whole_plan_reason_and_explain_only_mode():
    port = _q6(TF, TorchSession(device="cpu").createDataFrame(_table())
               .device_cache())
    assert port.explain_fallback() == "The whole plan can run on the TPU"
    only = TorchSession({"spark.rapids.sql.mode": "explainOnly"},
                        device="cpu")
    plan = _q6(TF, only.createDataFrame(_table())).explain()
    assert not _device_nodes(plan.split("== Physical Plan ==\n")[1])


def test_cost_based_optimizer_is_not_yet_ported():
    s = TorchSession({"spark.rapids.sql.optimizer.enabled": "true"},
                     device="cpu")
    with pytest.raises(NotImplementedError, match="CBO not yet ported"):
        _q6(TF, s.createDataFrame(_table())).collect()


def test_column_pruning_off_keeps_the_plan():
    conf = {"spark.rapids.tpu.optimizer.columnPruning.enabled": "false"}
    want, got = _plans("q6", conf, cached=False)
    assert got == want
    assert "appliedRules" not in got and "TorchProject" not in got
