"""Observability of whole queries: the port's operator metrics, sync
ledger, traced bundle and ``explain("metrics")`` held to the reference's,
on the CPU.

TPC-H Q1 on the general (sort-based) aggregate and q3 over shuffled joins
run traced in both packages at 4,096 lineitem rows over 2 partitions, one
run a query and package (module-scoped). The reference runs with its
passes the port has not ported off (fusion, coalescing, grouped map
dispatch, the pipelined map pool), so both plan and pull the same
operators. Operator names map ``Tpu*`` to ``Torch*``.

* The span trees have the same shape (names and categories, nesting and
  order, timestamps aside).
* Each operator's ``numOutputRows`` is exactly equal.
* ``last_query_metrics`` has the same operator keys at each level.
* Both bundles reconcile; the port's per-operator sync events equal its
  ``last_sync_ledger()``.
* ``explain("metrics")`` lists the same operators.

Then the port alone: a traced collect's rows equal an untraced one's, a
plan-cache hit does not double a metric, two sessions tracing at once
each reconcile their own bundle, tracing off builds no tracer,
the chaos fault and its healing retry share a span, the device parquet
decode's spans and dispatches, the artifacts under ``trace.dir``, the
profiler, the batch dumps and per-query task metrics.
"""

import functools
import glob
import json
import os
import re

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import benchmarks.tpch as ref_tpch
import spark_rapids_tpu_torch.functions as TF
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import tpch as port_tpch
from spark_rapids_tpu_torch.chaos import FaultInjector
from spark_rapids_tpu_torch.datagen import tpch_tables
from spark_rapids_tpu_torch.memory.device import TorchDeviceManager
from spark_rapids_tpu_torch.obs import tracer as port_tracer
from spark_rapids_tpu_torch.profiling import TaskMetricsRegistry, dump_batch
from spark_rapids_tpu_torch.serving.scheduler import QueryScheduler
from spark_rapids_tpu_torch.session import TorchSession

TorchDeviceManager.initialize(device="cpu", total_bytes=8 << 30)

ROWS = 1 << 12
#: reference passes the port has not ported, off for a like-for-like plan
#: and a like-for-like pull order (per-map tasks on the calling thread)
REF_ONLY_OFF = {"spark.rapids.tpu.opjit.fuseStages": "false",
                "spark.rapids.tpu.coalesce.enabled": "false",
                "spark.rapids.tpu.dispatch.partitionBatch": "1",
                "spark.rapids.tpu.shuffle.pipeline.enabled": "false"}
BASE = {"spark.rapids.shuffle.mode": "ICI",
        "spark.sql.shuffle.partitions": "8",
        "spark.rapids.tpu.trace.enabled": "true"}
GENERAL = {"spark.rapids.tpu.agg.compiledStage.enabled": "false"}
QUERIES = {
    "q1": (GENERAL, lambda F, s, t: ref_tpch.q1(s, t),
           lambda t: port_tpch.q1(t)),
    "q3": (dict(GENERAL, **{
        "spark.rapids.tpu.join.compiledStage.enabled": "false",
        "spark.sql.autoBroadcastJoinThreshold": "-1"}),
        lambda F, s, t: ref_tpch.q3(s, t), lambda t: port_tpch.q3(t)),
}
LEVELS = ("ESSENTIAL", "MODERATE", "DEBUG")


def _record(s, rows):
    return {"rows": rows, "profile": s.last_query_profile(),
            "metrics": {lv: s.last_query_metrics(lv) for lv in LEVELS},
            "ledger": s.last_sync_ledger(),
            "explain": s.explain("metrics")}


@functools.lru_cache(maxsize=None)
def _reference(name):
    conf, ref_q, _ = QUERIES[name]
    s = TpuSession(dict(BASE, **conf, **REF_ONLY_OFF))
    t = ref_tpch.load_tables(s, ROWS, parts=2)
    return _record(s, ref_q(None, s, t).collect())


@functools.lru_cache(maxsize=None)
def _port(name):
    conf, _, port_q = QUERIES[name]
    s = TorchSession(dict(BASE, **conf), device="cpu")
    QueryScheduler.get().plan_cache.clear()
    rows = port_q(tpch_tables(s, ROWS, 2)).collect()
    return _record(s, rows)


def _mapped(d):
    return {k.replace("Tpu", "Torch"): v for k, v in d.items()}


def _shape(span, sids=None):
    """(name, category, children) with operator names mapped, the query's
    own name dropped and shuffle ids renumbered in order of first
    appearance: the process-wide counters behind both stand wherever
    earlier queries of the process left them."""
    sids = {} if sids is None else sids
    name = span["name"].replace("Tpu", "Torch")
    if span["cat"] == "query":
        name = "query"
    elif span["cat"].startswith("shuffle"):
        name = re.sub(r"\bs(\d+)", lambda m: "s%d" % sids.setdefault(
            m.group(1), len(sids)), name)
    return (name, span["cat"],
            tuple(_shape(c, sids) for c in span["children"]))


def _flatten(span, depth=0, acc=None):
    acc = acc if acc is not None else []
    acc.append((depth, span))
    for c in span["children"]:
        _flatten(c, depth + 1, acc)
    return acc


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_span_tree_shape_matches_reference(name):
    ref, port = _reference(name), _port(name)
    assert _shape(port["profile"]["spans"]) == _shape(ref["profile"]["spans"])
    # query → plan.build, then partition tasks → operators
    top = [c["name"] for c in port["profile"]["spans"]["children"]]
    assert top[0] == "plan.build" and top[1] == "partition 0"


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_num_output_rows_equal_reference(name):
    ref, port = _reference(name), _port(name)
    want = {k: v["numOutputRows"]
            for k, v in _mapped(ref["metrics"]["ESSENTIAL"]).items()}
    got = {k: v["numOutputRows"]
           for k, v in port["metrics"]["ESSENTIAL"].items()}
    assert got == want
    assert len(port["rows"]) == len(ref["rows"])


@pytest.mark.parametrize("name", sorted(QUERIES))
@pytest.mark.parametrize("level", LEVELS)
def test_metric_keys_equal_reference_at_each_level(name, level):
    ref, port = _reference(name), _port(name)
    assert set(port["metrics"][level]) == \
        set(_mapped(ref["metrics"][level]))


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_bundles_reconcile(name):
    for rec in (_reference(name), _port(name)):
        p = rec["profile"]
        r = p["reconcile"]
        assert not r["overflow"] and r["dispatch_ok"] and r["sync_ok"], r
        assert p["sync_events_total"] == r["sync_total_expected"]
        got = {op: slot["syncs"] for op, slot in p["by_operator"].items()
               if slot.get("syncs")}
        assert got == rec["ledger"]
    # the port's one result download of each partition, through the gate
    assert _port(name)["ledger"]["DeviceToHostExec"]["batch"] >= 1


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_explain_metrics_lists_the_reference_operators(name):
    def nodes(text):
        return [ln.replace("Tpu", "Torch").rstrip()
                for ln in text.splitlines() if "| " not in ln]
    ref, port = _reference(name), _port(name)
    assert nodes(port["explain"]) == nodes(ref["explain"])
    assert "numOutputRows=" in port["explain"]


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_traced_rows_equal_untraced(name):
    conf, _, port_q = QUERIES[name]
    s = TorchSession(dict(BASE, **conf, **{
        "spark.rapids.tpu.trace.enabled": "false"}), device="cpu")
    rows = port_q(tpch_tables(s, ROWS, 2)).collect()
    assert rows == _port(name)["rows"]
    assert s.last_query_profile() is None


def test_plan_cache_hit_does_not_double_metrics():
    s = TorchSession(dict(BASE, **GENERAL), device="cpu")
    QueryScheduler.get().plan_cache.clear()
    q = port_tpch.q1(tpch_tables(s, ROWS, 2))
    q.collect()
    first = s.last_query_metrics("ESSENTIAL")
    q.collect()
    assert s._last_plan_cache == "hit"
    assert s.last_query_metrics("ESSENTIAL") == first
    assert s.last_query_profile()["reconcile"]["sync_ok"]


def test_concurrent_traced_queries_each_reconcile():
    """Two sessions trace at once, each on its own thread: each bundle
    holds its own query and reconciles, against the process-wide deltas
    when its query ran alone or its tracer's own counters otherwise."""
    import threading
    out, errors = {}, []

    def run(i):
        try:
            s = TorchSession(dict(BASE, **GENERAL), device="cpu")
            for _ in range(3):
                rows = port_tpch.q1(tpch_tables(s, ROWS, 2)).collect()
                p = s.last_query_profile()
                out.setdefault(i, []).append((rows, p))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    names = set()
    for runs in out.values():
        for rows, p in runs:
            assert len(rows) == 4
            r = p["reconcile"]
            assert r["dispatch_ok"] and r["sync_ok"] and not r["overflow"]
            names.add(p["query"])
    assert len(names) == 6  # one bundle a query, none shared


def test_untraced_collect_builds_no_tracer(monkeypatch):
    """Tracing off: no tracer is armed and span() is the shared null
    context manager (structural: the suite runs on several workers)."""
    port_tracer.QueryTracer.reset_for_tests()

    def armed(*a, **k):
        raise AssertionError("a tracer was armed with tracing off")

    monkeypatch.setattr(port_tracer, "QueryTracer", armed)
    s = TorchSession(GENERAL, device="cpu")
    rows = port_tpch.q1(tpch_tables(s, ROWS, 2)).collect()
    assert len(rows) == 4
    assert port_tracer._ACTIVE == 0 and not port_tracer._TRACERS
    assert port_tracer.span("x") is port_tracer._NULL_SPAN
    assert s.last_query_profile() is None
    # the metrics and the ledger do not need the tracer
    assert s.last_query_metrics("ESSENTIAL")
    assert s.last_sync_ledger()["DeviceToHostExec"]["batch"] == 1


def test_host_engine_operators_count_their_output():
    s = TorchSession({"spark.rapids.sql.enabled": "false",
                      "spark.sql.shuffle.partitions": "2"}, device="cpu")
    rows = port_tpch.q1(tpch_tables(s, ROWS, 2)).collect()
    m = s.last_query_metrics("ESSENTIAL")
    agg = [v for k, v in m.items() if "CpuHashAggregateExec" in k]
    assert agg and agg[0]["numOutputRows"] == len(rows) == 4
    assert s.counters["opTime.CpuHashAggregateExec"] > 0


def test_explain_modes():
    s = TorchSession(GENERAL, device="cpu")
    q = port_tpch.q1(tpch_tables(s, ROWS, 2))
    assert "<no executed query" in s.explain("metrics")
    q.collect()
    assert q.explain("metrics") == s.explain("metrics")
    assert "TorchHashAggregate" in s.explain("metrics", level="ESSENTIAL")
    assert q.explain().startswith("planCache=")
    with pytest.raises(ValueError):
        s.explain("formatted")


def test_chaos_event_correlated_with_healing_retry():
    """An injected transient device fault shows up as a chaos event INSIDE
    the span it struck, next to the device.retry event that healed it —
    and the query still succeeds (the compiled join stage's launch)."""
    s = TorchSession(dict(BASE, **{
        "spark.rapids.sql.batchSizeRows": str(ROWS)}), device="cpu")
    t = tpch_tables(s, ROWS, 1)
    t["lineitem"] = t["lineitem"].device_cache()
    q = port_tpch.q3(t)
    assert "TorchCompiledJoinAggStage" in q.explain()
    want = q.collect()
    FaultInjector.get().force("device.dispatch", "transient", 1)
    try:
        assert q.collect() == want
        p = s.last_query_profile()
    finally:
        FaultInjector.get().clear_forced()
    chaos, retries = p["chaos_events"], p["retry_events"]
    assert chaos and chaos[0]["kind"] == "transient" \
        and chaos[0]["site"] == "device.dispatch"
    assert retries, "no device.retry event recorded"
    assert chaos[0]["span"] is not None
    assert chaos[0]["span"] == retries[0]["span"], \
        "fault and healing retry must land in the same span"
    ids = {sp["id"]: sp for _, sp in _flatten(p["spans"])}
    assert ids[chaos[0]["span"]]["name"] == "TorchCompiledJoinAggStageExec"
    # the healed launch is counted once, the failed attempt not at all
    assert p["dispatches_by_kind"] == {"compiledjoin": 1}
    assert p["reconcile"]["dispatch_ok"] and p["reconcile"]["sync_ok"]


def test_scan_decode_spans_and_artifacts(tmp_path):
    """The device decode: one scan.decode span and one parquet_decode
    dispatch a row group, reconciled; trace.dir gets the Chrome trace and
    the bundle, named by trace.tag."""
    n, rg = 6000, 2000
    rng = np.random.default_rng(5)
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"k": rng.integers(0, 7, n).astype(np.int32),
                             "v": rng.normal(size=n)}), path,
                   row_group_size=rg)
    out = tmp_path / "traces"
    s = TorchSession(dict(BASE, **{
        "spark.rapids.tpu.parquet.deviceDecode.enabled": "true",
        "spark.rapids.tpu.trace.dir": str(out),
        "spark.rapids.tpu.trace.tag": "scan"}), device="cpu")
    q = s.read.parquet(path).groupBy("k").agg(TF.sum("v").alias("s"))
    rows = q.collect()
    assert len(rows) == 7
    p = s.last_query_profile()
    spans = [sp for _, sp in _flatten(p["spans"])]
    decodes = [sp for sp in spans if sp["name"] == "scan.decode"]
    assert len(decodes) == n // rg
    assert all(sp["cat"] == "io" for sp in decodes)
    assert p["dispatches_by_kind"]["parquet_decode"] == n // rg
    assert p["reconcile"]["dispatch_ok"] and p["reconcile"]["sync_ok"]
    scan = next(v for k, v in s.last_query_metrics("DEBUG").items()
                if "FileScan" in k)
    assert scan["decodeDispatches"] == n // rg and scan["filesRead"] == 1
    arts = p["artifacts"]
    assert os.path.basename(arts["bundle"]) == "scan-1.profile.json"
    with open(arts["chrome_trace"]) as f:
        trace = json.load(f)
    assert any(e.get("name") == "scan.decode" for e in trace["traceEvents"])
    with open(arts["bundle"]) as f:
        assert json.load(f)["query"] == "scan-1"


def test_profiler_requires_prefix():
    s = TorchSession({}, device="cpu")
    with pytest.raises(ValueError):
        s.profiler()


def test_profiler_writes_trace(tmp_path):
    s = TorchSession({"spark.rapids.profile.pathPrefix": str(tmp_path)},
                     device="cpu")
    q = port_tpch.q1(tpch_tables(s, 1 << 10, 1))
    with s.profiler() as prof:
        q.collect()
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any("TorchCompiledAggStageExec" in str(e.get("name"))
               for e in events)


def test_dump_batch_roundtrip(tmp_path):
    from spark_rapids_tpu_torch.columnar.batch import TorchColumnarBatch
    t = pa.table({"a": pa.array(range(10), type=pa.int64())})
    p = dump_batch(TorchColumnarBatch.from_arrow(t), str(tmp_path), "TestOp")
    assert pq.read_table(p).column("a").to_pylist() == list(range(10))


def test_dump_on_operator_failure(tmp_path):
    """An operator that already emitted a batch dumps it to parquet when a
    later batch of the SAME partition fails (reference DumpUtils)."""
    import torch

    from spark_rapids_tpu_torch.columnar.batch import TorchColumnarBatch
    from spark_rapids_tpu_torch.config import RapidsConf
    from spark_rapids_tpu_torch.execs.base import TaskContext, TorchExec
    from spark_rapids_tpu_torch.expressions.base import AttributeReference
    from spark_rapids_tpu_torch.types import LongType

    class TwoBatchThenBoom(TorchExec):
        def __init__(self):
            super().__init__([])

        @property
        def output(self):
            return [AttributeReference("a", LongType(), True)]

        def internal_do_execute_columnar(self, idx, ctx):
            yield TorchColumnarBatch.from_arrow(
                pa.table({"a": pa.array([1, 2, 3], type=pa.int64())}))
            raise RuntimeError("boom after first batch")

    conf = RapidsConf({"spark.rapids.sql.debug.dumpPath": str(tmp_path)})
    exec_ = TwoBatchThenBoom()
    ctx = TaskContext(0, conf, torch.device("cpu"))
    with pytest.raises(RuntimeError, match="boom"):
        list(exec_.execute_partition(0, ctx))
    dumps = glob.glob(str(tmp_path) + "/dump-TwoBatchThenBoom-*.parquet")
    assert len(dumps) == 1
    assert pq.read_table(dumps[0]).column("a").to_pylist() == [1, 2, 3]
    assert exec_.metrics["numOutputRows"].value == 3


def test_last_task_metrics_is_per_query():
    """Task metrics reported per query, not merged across queries."""
    TaskMetricsRegistry.reset_for_tests()
    s = TorchSession({}, device="cpu")
    port_tpch.q1(tpch_tables(s, ROWS, 2)).collect()
    first = s.last_task_metrics()
    port_tpch.q1(tpch_tables(s, 1 << 10, 1)).collect()
    second = s.last_task_metrics()
    assert set(first) == set(TaskMetricsRegistry.KNOWN)
    # the second query's deltas are independent of the first's totals
    assert second["semaphoreWaitNs"] <= first["semaphoreWaitNs"] + \
        TaskMetricsRegistry.get().snapshot()["semaphoreWaitNs"]


def test_chip_smoke_phase15_rehearsal(tmp_path):
    """chip_smoke.py's phase 15 off the card at small sizes: traced
    framework Q1, q3 general and scan_agg against untraced collects and
    their oracles, hot_repeat traced (a plan.build span in every bundle,
    five plan-cache hits), a host-only profile."""
    import chip_smoke
    n = 1 << 15
    cols = chip_smoke.lineitem(n)
    s = TorchSession({"spark.rapids.sql.batchSizeRows": str(n)},
                     device="cpu")
    df = s.createDataFrame(cols, num_partitions=1).device_cache()
    path = str(tmp_path / "lineitem.parquet")
    scan_cols = chip_smoke.write_lineitem(path, 1 << 14, 1 << 13, 1 << 12)
    scan = (str(tmp_path), path, chip_smoke.scan_agg_oracle(scan_cols), 4)
    chip_smoke.obs_paths(TF, TorchSession, "cpu", {}, df, cols,
                         chip_smoke.framework_oracle(cols), scan,
                         device="cpu", mid=1 << 14)
