"""The port's query lifecycle held against the JAX reference: deadlines and
cancels at batch boundaries, fault isolation, ``stop()``, and an N=4
concurrent-session soak under seeded chaos.

After every unwind path (deadline, cancel, an injected fatal error, chaos)
the port's counters are back at their baseline: every semaphore permit
free, the budget's ``used`` at 0, the spill catalog and the shuffle
catalog empty, and no live resource in the ``MemoryCleaner``. Rows are
held against the reference's rows for the same queries over the same
data (made with numpy from a seed); integer measures, so they match
exactly under any retry or split schedule."""

import os
import threading
import time

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu.functions as RF
import spark_rapids_tpu_torch.functions as TF
from spark_rapids_tpu.serving.query_context import \
    QueryDeadlineExceeded as RefDeadline
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch.chaos import FaultInjector
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.memory.cleaner import MemoryCleaner
from spark_rapids_tpu_torch.memory.hbm import HbmBudget
from spark_rapids_tpu_torch.memory.semaphore import TorchSemaphore
from spark_rapids_tpu_torch.memory.spill import TorchBufferCatalog
from spark_rapids_tpu_torch.obs import metrics as obs_metrics
from spark_rapids_tpu_torch.serving.query_context import (
    QueryCancelledError, QueryDeadlineExceeded)
from spark_rapids_tpu_torch.serving.scheduler import QueryScheduler
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.shuffle.exchange import ShuffleCatalog
from spark_rapids_tpu_torch.memory.device import TorchDeviceManager

# the CPU has no device memory to read: the tests state one for the
# budget (spark.rapids.memory.device.totalBytes)
TorchDeviceManager.initialize(device="cpu", total_bytes=8 << 30)

REF_ONLY_OFF = {"spark.rapids.tpu.opjit.fuseStages": "false",
                "spark.rapids.tpu.coalesce.enabled": "false"}

#: latency at every cancel checkpoint: stretches a query so a cancel or a
#: deadline lands mid-run, at a batch boundary
_STRETCH = {"spark.rapids.tpu.test.chaos.enabled": "true",
            "spark.rapids.tpu.test.chaos.sites": "query.cancel",
            "spark.rapids.tpu.test.chaos.kinds": "latency",
            "spark.rapids.tpu.test.chaos.probability": "1.0",
            "spark.rapids.tpu.test.chaos.latencyMs": "20"}


@pytest.fixture(autouse=True)
def _fresh_state():
    FaultInjector.reset_for_tests()
    QueryScheduler.reset_for_tests()
    yield
    FaultInjector.reset_for_tests()
    QueryScheduler.reset_for_tests()
    # a case that shrank the budget must not leave it small for the next
    HbmBudget.reset_for_tests()
    TorchBufferCatalog.reset_for_tests()


def _counter(name):
    cells = obs_metrics.MetricsRegistry.get().snapshot()["counters"].get(
        name, {})
    return sum(cells.values())


def _assert_no_leaks(live_before):
    sem = TorchSemaphore._instance
    if sem is not None:
        assert sem.available() == sem.permits
        assert sem.state()["holders"] == 0 and sem.state()["riders"] == 0
    assert HbmBudget.get().used == 0
    assert TorchBufferCatalog.get().num_entries() == 0
    cat = ShuffleCatalog._instance
    assert cat is None or cat.num_blocks() == 0
    assert len(MemoryCleaner.get().live_resources()) == live_before


def _data(i, n=360):
    j = np.arange(n)
    return {"k": ((j * 7 + i) % 11).astype(np.int64),
            "v": (j * 3 - 50).astype(np.int64),
            "w": (j % 13).astype(np.int64)}


def _dim():
    j = np.arange(11)
    return {"k2": j.astype(np.int64), "q": (j * 11).astype(np.int64)}


def _frames(pkg, s, i):
    if pkg == "ref":
        fd = s.createDataFrame(pa.table(_data(i)), num_partitions=4)
        dd = s.createDataFrame(pa.table(_dim()), num_partitions=2)
    else:
        fd = s.createDataFrame(_data(i), num_partitions=4)
        dd = s.createDataFrame(_dim(), num_partitions=2)
    return fd, dd


def _queries(pkg, s, i):
    """Mixed shapes with integer measures: filter/project, an aggregate, a
    shuffled join under an aggregate, a sort."""
    F = RF if pkg == "ref" else TF
    fd, dd = _frames(pkg, s, i)
    return [
        fd.filter(fd["v"] > 0).select("k", "w"),
        fd.groupBy("k").agg(F.sum(F.col("v")).alias("sv")),
        fd.join(dd, fd["k"] == dd["k2"]).groupBy("k")
        .agg(F.sum(F.col("q")).alias("sq")),
        fd.sort("v", "k", "w"),
    ]


_CONF = {"spark.sql.shuffle.partitions": "4",
         "spark.sql.autoBroadcastJoinThreshold": "-1",
         "spark.rapids.sql.batchSizeRows": "64"}


def _rows(df):
    return sorted(tuple(r.values()) for r in df.collect())


_REF_CACHE = {}


def _reference_rows(i):
    """The reference's rows of session i's queries (computed once)."""
    if i not in _REF_CACHE:
        # the same rows from its broadcast join (sorted rows compare
        # equal): the reference's shuffled join costs ~200 XLA compiles
        conf = {k: v for k, v in _CONF.items()
                if k != "spark.sql.autoBroadcastJoinThreshold"}
        s = TpuSession(dict(conf, **REF_ONLY_OFF))
        _REF_CACHE[i] = [_rows(q) for q in _queries("ref", s, i)]
    return _REF_CACHE[i]


# ---------------------------------------------------------------------------
# deadline and cancel
# ---------------------------------------------------------------------------


def test_conf_deadline_raises_typed_error_like_reference():
    """timeoutMs=1: both packages raise their QueryDeadlineExceeded and
    count it; the port leaves nothing behind."""
    conf = {"spark.rapids.tpu.query.timeoutMs": "1"}
    ref = TpuSession(dict(conf, **REF_ONLY_OFF))
    with pytest.raises(RefDeadline):
        _queries("ref", ref, 0)[1].collect()
    live = len(MemoryCleaner.get().live_resources())
    before = _counter("query.deadline_exceeded")
    s = TorchSession(conf, device="cpu")
    with pytest.raises(QueryDeadlineExceeded):
        _queries("port", s, 0)[1].collect()
    assert _counter("query.deadline_exceeded") == before + 1
    _assert_no_leaks(live)


def test_deadline_trips_at_a_batch_boundary():
    """A stretched query with a 0.15 s deadline raises at the first
    checkpoint past it (one stretched batch pull later, not the query's
    end), and a later query on the session runs clean."""
    s = TorchSession(_CONF, device="cpu")
    # after the session: a session whose conf has no chaos disarms it
    FaultInjector.configure(RapidsConf(_STRETCH))
    q = _queries("port", s, 1)[2]
    live = len(MemoryCleaner.get().live_resources())
    t0 = time.perf_counter()
    with pytest.raises(QueryDeadlineExceeded, match="deadline"):
        q.collect(timeout=0.15)
    late = time.perf_counter() - t0 - 0.15
    assert late < 0.2, f"raised {late:.3f} s past the deadline"
    _assert_no_leaks(live)
    FaultInjector.reset_for_tests()
    assert _rows(q) == _reference_rows(1)[2]


def test_session_cancel_stops_a_running_query():
    s = TorchSession(_CONF, device="cpu")
    FaultInjector.configure(RapidsConf(_STRETCH))
    q = _queries("port", s, 2)[3]
    live = len(MemoryCleaner.get().live_resources())
    out = {}

    def run():
        try:
            q.collect()
        except BaseException as e:  # noqa: BLE001
            out["err"] = e

    t = threading.Thread(target=run)
    t.start()
    sched = QueryScheduler.get()
    end = time.monotonic() + 10
    while not sched._running and time.monotonic() < end:
        time.sleep(0.005)
    time.sleep(0.05)
    assert s.cancel() == 1
    t.join(timeout=20)
    assert isinstance(out.get("err"), QueryCancelledError)
    assert not isinstance(out["err"], QueryDeadlineExceeded)
    _assert_no_leaks(live)


def test_stop_is_idempotent_and_releases_shared_state(monkeypatch):
    import weakref

    from spark_rapids_tpu_torch.serving import scheduler
    # only this test's sessions count as live (earlier tests' sessions may
    # still await collection)
    monkeypatch.setattr(scheduler, "_LIVE_SESSIONS", weakref.WeakSet())
    s1 = TorchSession(_CONF, device="cpu")
    s2 = TorchSession({}, device="cpu")
    _queries("port", s1, 0)[2].collect()  # a shuffled join: blocks exist
    s1.stop()
    s1.stop()
    with pytest.raises(RuntimeError, match="is stopped"):
        _queries("port", s1, 0)[0].collect()
    assert ShuffleCatalog._instance is not None  # s2 still live
    s2.stop()
    s2.stop()
    assert ShuffleCatalog._instance is None  # the last stop released it


# ---------------------------------------------------------------------------
# fault isolation
# ---------------------------------------------------------------------------


def test_fatal_in_one_query_leaves_concurrent_queries_correct(tmp_path):
    """One injected fatal device error kills exactly one in-flight query;
    every other concurrent query (3 sessions × 4 queries × 2 reps) returns
    the reference's rows, the failure is counted and lands in a
    postmortem bundle, and nothing leaks."""
    N = 3
    baselines = [_reference_rows(i) for i in range(N)]
    conf = dict(_CONF, **{"spark.rapids.tpu.obs.postmortemDir":
                          str(tmp_path)})
    sessions = [TorchSession(conf, device="cpu") for _ in range(N)]
    live = len(MemoryCleaner.get().live_resources())
    fatal_before = _counter("device.fatal_errors")
    barrier = threading.Barrier(N)
    results = [[] for _ in range(N)]
    errors = []

    def run(i):
        barrier.wait(timeout=30)
        for _rep in range(2):
            for q in _queries("port", sessions[i], i):
                try:
                    results[i].append(_rows(q))
                except BaseException as e:  # noqa: BLE001
                    results[i].append(None)
                    errors.append(e)

    # ONE fatal, delivered to whichever query allocates next
    FaultInjector.get().force("hbm.alloc", "fatal", 1)
    threads = [threading.Thread(target=run, args=(i,)) for i in range(N)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    FaultInjector.get().clear_forced()
    assert len(errors) == 1, errors
    assert "fatal device error" in str(errors[0])
    for i in range(N):
        for k, got in enumerate(results[i]):
            if got is not None:
                assert got == baselines[i][k % 4], (i, k)
    assert sum(r is None for rs in results for r in rs) == 1
    assert _counter("device.fatal_errors") == fatal_before + 1
    assert [f for f in os.listdir(tmp_path)
            if f.startswith("postmortem-fatal_device_error")]
    _assert_no_leaks(live)
    for s in sessions:
        s.stop()


@pytest.mark.parametrize("site,detail", [
    ("device.dispatch", "compiled_stage"),
    ("device.dispatch", "compiled_join_stage"),
    ("pipeline.task", ""), ("ici.fetch", "")])
def test_transient_device_error_heals_at_each_dispatch_site(site, detail):
    """One transient device error at each dispatch site the port wraps in
    ``with_device_retry`` (reference exchange.py:137,1113, compiled.py:843,
    compiled_join.py:1244): the query re-runs that dispatch, counts one
    ``deviceRetryCount``, and returns the clean run's rows."""
    from spark_rapids_tpu_torch.datagen import tpch_tables
    from spark_rapids_tpu_torch.serving.bench import q3_variant
    live = len(MemoryCleaner.get().live_resources())
    t = None
    if detail == "compiled_join_stage":
        rows = 1 << 12
        s = TorchSession({"spark.sql.shuffle.partitions": "8",
                          "spark.rapids.sql.batchSizeRows": str(rows)},
                         device="cpu")
        t = tpch_tables(s, rows, parts=1)
        t["lineitem"] = t["lineitem"].device_cache()
        q = q3_variant(t, 0, TF)
        assert "TorchCompiledJoinAggStage" in q.explain()
    else:
        s = TorchSession(_CONF, device="cpu")
        q = _queries("port", s, 0)[2]  # shuffled join under the agg stage
    want = _rows(q)
    FaultInjector.get().force(site, "transient", 1)
    got = _rows(q)
    fired = [r for r in FaultInjector.get().trace() if r["site"] == site]
    FaultInjector.get().clear_forced()
    assert got == want
    assert len(fired) == 1 and detail in fired[0]["detail"]
    assert s.last_task_metrics()["deviceRetryCount"] == 1
    if detail != "compiled_join_stage":
        assert want == _reference_rows(0)[2]
    del q, t
    QueryScheduler.get().plan_cache.clear()
    _assert_no_leaks(live)
    s.stop()


def test_a_sticky_cuda_error_fails_every_running_query():
    """A real sticky CUDA error (here an illegal memory access) breaks the
    context for the whole process: a query running beside the failed one
    fails at its next checkpoint with the reason ``device.fatal`` instead
    of finishing. The chaos injector's fatal kind breaks nothing and stays
    quarantined (the case above)."""
    from spark_rapids_tpu_torch import failure
    from spark_rapids_tpu_torch.serving.query_context import (QueryContext,
                                                              checkpoint)
    sched = QueryScheduler.get()
    started, release = threading.Event(), threading.Event()
    out = {}

    def survivor():
        def work():
            started.set()
            release.wait(30)
            checkpoint("after the failure")
            return "finished"
        try:
            out["result"] = sched.submit_and_run(
                QueryContext("survivor", session_id="sess-survivor"), work)
        except QueryCancelledError as e:
            out["error"] = str(e)

    th = threading.Thread(target=survivor)
    th.start()
    assert started.wait(30)
    failed_before = _counter("query.failed_by_fatal")
    err = RuntimeError("CUDA error: an illegal memory access was "
                       "encountered")
    assert failure.is_fatal_device_error(err)
    assert failure.handle_task_failure(err, RapidsConf({}),
                                       exit_on_fatal=False) is None
    release.set()
    th.join(30)
    assert "result" not in out and "device.fatal" in out["error"]
    assert _counter("query.failed_by_fatal") == failed_before + 1


# ---------------------------------------------------------------------------
# the N=4 concurrent-session soak under chaos
# ---------------------------------------------------------------------------

_SOAK_CHAOS = {
    "spark.rapids.tpu.test.chaos.enabled": "true",
    "spark.rapids.tpu.test.chaos.seed": "11",
    # healable kinds only: the bar is identical rows
    "spark.rapids.tpu.test.chaos.kinds":
        "retry_oom,split_oom,transient,latency",
    "spark.rapids.tpu.test.chaos.probability": "0.08",
    "spark.rapids.tpu.test.chaos.latencyMs": "2",
}


def test_concurrent_session_soak_identical_rows_zero_leaks():
    N = 4
    baselines = [_reference_rows(i) for i in range(N)]
    # clean port runs first: chaos off
    clean = []
    for i in range(N):
        s = TorchSession(_CONF, device="cpu")
        clean.append([_rows(q) for q in _queries("port", s, i)])
        s.stop()
    assert clean == baselines
    live = len(MemoryCleaner.get().live_resources())
    # a budget of about two sessions' peak (one session peaks near 23 KB):
    # four concurrent sessions spill each other's batches and blocks
    HbmBudget.reset_for_tests(budget_bytes=48 << 10)
    catalog = TorchBufferCatalog.reset_for_tests()
    sessions = [TorchSession(dict(_CONF, **_SOAK_CHAOS), device="cpu")
                for _ in range(N)]
    barrier = threading.Barrier(N)
    results = [None] * N
    errors = {}

    def run(i):
        try:
            barrier.wait(timeout=60)
            results[i] = [[_rows(q) for q in _queries("port", sessions[i],
                                                      i)]
                          for _rep in range(2)]
        except BaseException as e:  # noqa: BLE001
            errors[i] = e

    threads = [threading.Thread(target=run, args=(i,)) for i in range(N)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    inj = FaultInjector.get()
    sites = {r["site"] for r in inj.trace()}
    assert inj.injection_count() > 0
    assert {"query.cancel", "hbm.alloc"} <= sites
    assert catalog.spilled_to_host > 0  # the budget was real pressure
    for i in range(N):
        for rep in results[i]:
            assert rep == baselines[i], f"session {i} diverged"
    FaultInjector.reset_for_tests()
    _assert_no_leaks(live)
    for s in sessions:
        s.stop()


# ---------------------------------------------------------------------------
# device-error classification and the bounded transient retry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,want", [("transient", ("ok", 3)),
                                       ("fatal", ("raised", 1))])
def test_device_retry_matches_reference(kind, want):
    """Two forced faults at one site: a transient one heals on the third
    attempt in both packages; a fatal one propagates on the first."""
    import spark_rapids_tpu.chaos as ref_chaos
    import spark_rapids_tpu.failure as ref_failure
    import spark_rapids_tpu_torch.chaos as port_chaos
    import spark_rapids_tpu_torch.failure as port_failure
    got = []
    for chaos, failure in ((ref_chaos, ref_failure),
                           (port_chaos, port_failure)):
        chaos.FaultInjector.reset_for_tests()
        chaos.FaultInjector.get().force("device.dispatch", kind, 2)
        calls = []

        def fn():
            calls.append(1)
            chaos.inject("device.dispatch")
            return "ok"

        try:
            out = failure.with_device_retry(fn, max_attempts=4, base_ms=0.1,
                                            max_ms=0.2)
        except RuntimeError:
            out = "raised"
        got.append((out, len(calls)))
        chaos.FaultInjector.reset_for_tests()
    assert got[1] == got[0] == want


def test_cuda_errors_classify():
    """A sticky CUDA context error is fatal; an out-of-memory error is
    neither fatal nor transient (the retry framework takes it); a query's
    exhausted retry budget fails the next transient error at once."""
    import torch

    from spark_rapids_tpu_torch import failure
    from spark_rapids_tpu_torch.serving.query_context import (QueryContext,
                                                              bind)
    sticky = RuntimeError("CUDA error: an illegal memory access was "
                          "encountered")
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                      "allocate 2.00 GiB")
    assert failure.is_fatal_device_error(sticky)
    assert not failure.is_transient_device_error(sticky)
    assert not failure.is_fatal_device_error(oom)
    assert not failure.is_transient_device_error(oom)
    calls = []

    def flaky():
        calls.append(1)
        raise RuntimeError("chaos-injected transient device error")

    q = QueryContext("q", "s", retry_budget=0)
    with bind(q), pytest.raises(RuntimeError):
        failure.with_device_retry(flaky, max_attempts=8, base_ms=0.1)
    assert calls == [1]
    q.close()
