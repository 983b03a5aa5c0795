"""The port's memory runtime held against the JAX reference: the device
budget, the spill catalog's tiers, the retry framework's forced-OOM
sequences, double-close detection and the device semaphore (twins of
``tests/test_memory.py``).

The same input — an int column with nulls and a string column, made from a
seed with numpy — goes through both packages. Rows, retry and split counts,
budget figures and error types must match exactly. The bytes a batch
accounts for differ by layout (Arrow buffers in the reference, the torch
tensors at their capacity in the port), so byte counts are compared only
where the test itself states them."""

import threading
import time

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.chaos import FaultInjector as RefInjector
from spark_rapids_tpu.columnar.batch import TpuColumnarBatch
from spark_rapids_tpu.memory import cleaner as ref_cleaner
from spark_rapids_tpu.memory import hbm as ref_hbm
from spark_rapids_tpu.memory import retry as ref_retry
from spark_rapids_tpu.memory import spill as ref_spill
from spark_rapids_tpu.profiling import TaskMetricsRegistry as RefMetrics
from spark_rapids_tpu_torch.chaos import FaultInjector
from spark_rapids_tpu_torch.columnar.batch import TorchColumnarBatch
from spark_rapids_tpu_torch.memory import cleaner, hbm, retry, spill
from spark_rapids_tpu_torch.profiling import TaskMetricsRegistry
from spark_rapids_tpu_torch.memory.device import TorchDeviceManager

# the CPU has no device memory to read: the tests state one for the
# budget (spark.rapids.memory.device.totalBytes)
TorchDeviceManager.initialize(device="cpu", total_bytes=8 << 30)

REF = {"hbm": ref_hbm, "retry": ref_retry, "spill": ref_spill,
       "cleaner": ref_cleaner, "metrics": RefMetrics,
       "catalog": ref_spill.TpuBufferCatalog, "injector": RefInjector}
PORT = {"hbm": hbm, "retry": retry, "spill": spill, "cleaner": cleaner,
        "metrics": TaskMetricsRegistry,
        "catalog": spill.TorchBufferCatalog, "injector": FaultInjector}
BOTH = pytest.mark.parametrize("pkg", ["ref", "port"])


def _m(pkg):
    return REF if pkg == "ref" else PORT


@pytest.fixture(autouse=True)
def fresh_memory():
    for m in (REF, PORT):
        m["injector"].reset_for_tests()
        m["hbm"].HbmBudget.reset_for_tests(budget_bytes=1 << 30)
        m["catalog"].reset_for_tests()
        m["metrics"].reset_for_tests()
        m["cleaner"].MemoryCleaner.reset_for_tests()
    yield
    # nothing a case made may outlive it in the port. (The reference is not
    # held to this: its catalog registers an entry before the budget
    # allocation that may refuse it, so a forced OOM while a split
    # registers its halves leaves an entry behind — ROADMAP C-ref-9.)
    assert PORT["catalog"].get()._entries == {}
    assert PORT["hbm"].HbmBudget.get().used == 0
    assert PORT["cleaner"].MemoryCleaner.get().check_leaks() == []
    for m in (REF, PORT):
        m["injector"].reset_for_tests()
        m["hbm"].HbmBudget.reset_for_tests()
        m["catalog"].reset_for_tests()


def _columns(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(-1000, 1000, n).astype(np.int32)
    valid = rng.random(n) >= 0.1
    s = np.array(["".join(rng.choice(list("abcdxyz"), rng.integers(0, 9)))
                  for _ in range(n)], dtype=object)
    return a, valid, s


def _batch(pkg, n=128, seed=0):
    a, valid, s = _columns(n, seed)
    if pkg == "ref":
        return TpuColumnarBatch.from_arrow(pa.table(
            {"a": pa.array(a, mask=~valid), "s": pa.array(list(s))}))
    host = TorchColumnarBatch.from_numpy_columns({"a": a, "s": s},
                                                 {"a": valid})
    return host.to_device(torch.device("cpu"))


def _rows(pkg, batch):
    if pkg == "ref":
        return batch.to_arrow().to_pylist()
    return batch.to_host().to_pylist()


@BOTH
def test_rows_of_the_two_layouts_agree(pkg):
    assert _rows(pkg, _batch(pkg, 64, 3)) == _rows("ref", _batch("ref", 64, 3))


# ---------------------------------------------------------------------------
# forced-OOM sequences: the same results and counts in both packages
# ---------------------------------------------------------------------------


def _run_forced(pkg, n_rows, force, no_split=False, max_retries=8):
    m = _m(pkg)
    budget = m["hbm"].HbmBudget.get()
    sb = m["spill"].SpillableColumnarBatch(_batch(pkg, n_rows, 4))
    kind, n = force
    getattr(budget, kind)(n)
    calls = {"n": 0}

    def work(batch):
        calls["n"] += 1
        budget.allocate(0)  # hits the forced OOMs
        return batch.num_rows

    stats = m["retry"].RetryStats()
    try:
        if no_split:
            out = [m["retry"].with_retry_no_split(sb, work, stats=stats,
                                                  max_retries=max_retries)]
        else:
            out = list(m["retry"].with_retry(sb, work, stats=stats,
                                             max_retries=max_retries))
        err = None
    except MemoryError as e:
        out, err = None, type(e).__name__.replace("Tpu", "").replace(
            "Torch", "")
    snap = m["metrics"].get().snapshot()
    return (out, err, stats.retries, stats.split_retries,
            snap["retryCount"], snap["splitAndRetryCount"])


FORCED = {
    "retry2": (64, ("force_retry_oom", 2), False, 8),
    "split1": (64, ("force_split_and_retry_oom", 1), False, 8),
    "split3": (64, ("force_split_and_retry_oom", 3), False, 8),
    "nosplit_raises": (64, ("force_split_and_retry_oom", 1), True, 8),
    "gives_up": (8, ("force_retry_oom", 100), False, 3),
    "nosplit_retry": (16, ("force_retry_oom", 1), True, 8),
}


@pytest.mark.parametrize("case", sorted(FORCED))
def test_forced_oom_sequence_matches_reference(case):
    n, force, no_split, max_retries = FORCED[case]
    want = _run_forced("ref", n, force, no_split, max_retries)
    got = _run_forced("port", n, force, no_split, max_retries)
    assert got == want
    if case == "split3":
        # the third forced split fires while the split registers a half
        assert got == (None, "SplitAndRetryOOM", 0, 1, 0, 1)
        assert len(REF["catalog"].get()._entries) == 1  # C-ref-9
        assert PORT["catalog"].get()._entries == {}
    if case == "retry2":
        assert got[:4] == ([64], None, 2, 0)
    if case == "split1":
        assert got[:4] == ([32, 32], None, 0, 1)


@BOTH
def test_unsplittable_single_row(pkg):
    m = _m(pkg)
    sb = m["spill"].SpillableColumnarBatch(_batch(pkg, 1, 8))
    try:
        with pytest.raises(MemoryError, match="fewer than 2 rows"):
            m["retry"].split_in_half(sb)
    finally:
        sb.close()


def test_real_device_oom_retries_then_splits():
    """torch.cuda.OutOfMemoryError (what the card's allocator raises) takes
    the retry arm: one retry after a spill, then — failing again — a split;
    the halves' results equal the unconstrained result."""
    whole = _batch("port", 64, 9)
    want = sum(r["a"] or 0 for r in _rows("port", whole))
    sb = spill.SpillableColumnarBatch(whole)
    del whole
    calls = []

    def work(batch):
        calls.append(batch.num_rows)
        if batch.num_rows > 32:  # "scratch in proportion to the rows"
            raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
        return sum(r["a"] or 0 for r in _rows("port", batch))

    stats = retry.RetryStats()
    got = list(retry.with_retry(sb, work, stats=stats))
    assert sum(got) == want and len(got) == 2
    assert calls == [64, 64, 32, 32]
    assert (stats.device_ooms, stats.retries, stats.split_retries) == \
        (2, 1, 1)


def test_real_device_oom_past_the_limit_raises():
    sb = spill.SpillableColumnarBatch(_batch("port", 8, 9))

    def work(batch):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory.")

    with pytest.raises(torch.cuda.OutOfMemoryError):
        retry.with_retry_no_split(sb, work, max_retries=2)
    assert TaskMetricsRegistry.get().snapshot()["retryCount"] == 3


# ---------------------------------------------------------------------------
# the budget
# ---------------------------------------------------------------------------


@BOTH
def test_budget_used_and_peak_after_a_sequence(pkg):
    m = _m(pkg)
    b = m["hbm"].HbmBudget.reset_for_tests(budget_bytes=1000)
    trace = []
    for op, n in (("a", 300), ("a", 200), ("f", 100), ("a", 550), ("f", 400),
                  ("a", 50), ("f", 600)):
        (b.allocate if op == "a" else b.free)(n)
        trace.append((b.used, b.peak_used))
    with pytest.raises(MemoryError) as ei:
        b.allocate(2000)  # no spill callback: exhausted after retries
    assert getattr(ei.value, "budget_exhausted", False)
    trace.append((b.used, b.peak_used, b.alloc_count))
    b.free(b.used)
    if pkg == "port":
        ref = REF["hbm"].HbmBudget.reset_for_tests(budget_bytes=1000)
        want = []
        for op, n in (("a", 300), ("a", 200), ("f", 100), ("a", 550),
                      ("f", 400), ("a", 50), ("f", 600)):
            (ref.allocate if op == "a" else ref.free)(n)
            want.append((ref.used, ref.peak_used))
        with pytest.raises(MemoryError):
            ref.allocate(2000)
        want.append((ref.used, ref.peak_used, ref.alloc_count))
        ref.free(ref.used)
        assert trace == want
    assert trace[-1] == (0, 950, 5)


@BOTH
def test_budget_pressure_triggers_spill(pkg):
    m = _m(pkg)
    b1, b2 = _batch(pkg, 256, 2), _batch(pkg, 256, 3)
    big = max(b1.device_memory_size(), b2.device_memory_size())
    sb1 = m["spill"].SpillableColumnarBatch(b1)
    del b1  # the catalog owns each batch from here: a spill frees it
    m["hbm"].HbmBudget.get().budget = big + 100  # no room for two
    sb2 = m["spill"].SpillableColumnarBatch(b2)  # must spill sb1 to fit
    del b2
    cat = m["catalog"].get()
    try:
        assert cat.spilled_to_host == sb1.size_bytes
        assert sb1.get_batch().num_rows == 256  # unspill (spills sb2)
        assert cat.spilled_to_host == sb1.size_bytes + sb2.size_bytes
    finally:
        sb1.close()
        sb2.close()


# ---------------------------------------------------------------------------
# spill tiers
# ---------------------------------------------------------------------------


def _tensors(batch):
    return [t for c in batch.columns for t in (c.data, c.validity, c.offsets)
            if t is not None]


def test_cpu_device_memory_must_be_stated():
    """The budget has no silent size: nothing reads it before a device is
    fixed, a CPU session states its device memory, and a session on
    another device than the first is refused."""
    from spark_rapids_tpu_torch.session import TorchSession
    total = TorchDeviceManager._total_bytes
    TorchDeviceManager.reset_for_tests()
    try:
        with pytest.raises(RuntimeError, match="before any session"):
            TorchDeviceManager.hbm_budget_bytes()
        with pytest.raises(ValueError,
                           match="spark.rapids.memory.device.totalBytes"):
            TorchSession({}, device="cpu")
        TorchSession({"spark.rapids.memory.device.totalBytes": str(total)},
                     device="cpu")
        assert TorchDeviceManager.hbm_budget_bytes() == int(total * 0.75)
        with pytest.raises(RuntimeError, match="cannot share"):
            TorchDeviceManager.initialize(device="meta")
    finally:
        TorchDeviceManager.reset_for_tests()
        TorchDeviceManager.initialize(device="cpu", total_bytes=total)


def test_spill_frees_a_batch_the_catalog_holds_alone():
    """A spill drops every device reference: with no holder outside the
    catalog, the batch's tensors are gone once it spills."""
    import weakref
    b = _batch("port", 512, 1)
    refs = [weakref.ref(t) for t in _tensors(b)]
    sb = spill.SpillableColumnarBatch(b)
    del b
    cat = spill.TorchBufferCatalog.get()
    assert cat.synchronous_spill(1) == sb.size_bytes
    assert all(r() is None for r in refs)
    assert hbm.HbmBudget.get().used == 0
    assert sb.get_batch().num_rows == 512
    sb.close()


@pytest.mark.parametrize("holder", ["batch", "column", "view"])
def test_spill_keeps_a_batch_held_elsewhere_on_the_device(holder):
    """A spill that would free nothing is not made: the entry stays on the
    device, and reading it back makes no second copy."""
    b = _batch("port", 512, 1)
    kept = {"batch": lambda: b, "column": lambda: b.columns[1],
            "view": lambda: b.columns[0].data[:7]}[holder]()
    ptrs = [t.data_ptr() for t in _tensors(b)]
    sb = spill.SpillableColumnarBatch(b)
    del b
    cat = spill.TorchBufferCatalog.get()
    assert cat.synchronous_spill(1 << 40) == 0
    assert cat.spilled_to_host == 0
    assert hbm.HbmBudget.get().used == sb.size_bytes
    assert [t.data_ptr() for t in _tensors(sb.get_batch())] == ptrs
    del kept
    assert cat.synchronous_spill(1) == sb.size_bytes  # now it can go
    sb.close()


def test_retry_spill_frees_the_input_it_owns():
    """with_retry owns the batch it is given: after a retry OOM its spill
    of the input frees the input's tensors, and the retry reads the input
    back from the host."""
    import weakref
    b = _batch("port", 256, 2)
    refs = [weakref.ref(t) for t in _tensors(b)]
    want = _rows("port", b)
    budget = hbm.HbmBudget.get()
    seen = []

    def work(batch):
        seen.append(batch.columns[0].data.data_ptr())
        if len(seen) == 1:  # an OOM in the first attempt, past the input's
            budget.force_retry_oom(1)  # registration
            budget.allocate(0)
        return _rows("port", batch)

    gen = retry.with_retry(b, work)
    del b
    assert list(gen) == [want]
    assert all(r() is None for r in refs)
    assert spill.TorchBufferCatalog.get().spilled_to_host > 0
    assert len(seen) == 2


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_spill_round_trip_is_exact(tier):
    results = {}
    for pkg in ("ref", "port"):
        m = _m(pkg)
        cat = m["catalog"].get()
        if tier == "disk":
            cat.host_limit = 1  # host tier overflows straight to disk
        b = _batch(pkg, 512, 1)
        before = _rows(pkg, b)
        snap = [t.clone() for t in _tensors(b)] if pkg == "port" else None
        sb = m["spill"].SpillableColumnarBatch(b)
        del b
        assert cat.synchronous_spill(1 << 40) > 0
        assert (cat.spilled_to_disk > 0) == (tier == "disk")
        assert m["hbm"].HbmBudget.get().used == 0
        back = sb.get_batch()
        if pkg == "port":
            # byte for byte: every tensor at its full capacity
            got = _tensors(back)
            assert len(got) == len(snap)
            for x, y in zip(got, snap):
                assert x.dtype == y.dtype and torch.equal(x, y)
        results[pkg] = (before, _rows(pkg, back))
        sb.close()
    assert results["port"] == results["ref"]
    assert results["port"][0] == results["port"][1]


@BOTH
def test_corrupted_disk_spill_raises(pkg):
    m = _m(pkg)
    cat = m["catalog"].get()
    cat.host_limit = 1
    m["injector"].get().force("spill.to_disk", "corrupt", 1)
    sb = m["spill"].SpillableColumnarBatch(_batch(pkg, 256, 5))
    cat.synchronous_spill(1 << 40)
    with pytest.raises(m["spill"].SpillCorruptionError, match="xxhash64"):
        sb.get_batch()
    sb.close()


@BOTH
def test_spill_drops_the_catalogs_device_reference(pkg):
    m = _m(pkg)
    sb = m["spill"].SpillableColumnarBatch(_batch(pkg, 64, 6))
    entry = next(iter(m["catalog"].get()._entries.values()))
    assert entry.batch is not None
    m["catalog"].get().synchronous_spill(1)
    assert entry.batch is None and entry.tier == "HOST"
    sb.close()


# ---------------------------------------------------------------------------
# double close, the semaphore
# ---------------------------------------------------------------------------


@BOTH
@pytest.mark.parametrize("debug", [True, False], ids=["debug", "counted"])
def test_double_close(pkg, debug):
    m = _m(pkg)
    mc = m["cleaner"].MemoryCleaner.get()
    mc.set_debug(debug)
    sb = m["spill"].SpillableColumnarBatch(_batch(pkg, 16, 7))
    sb.close()
    if debug:
        with pytest.raises(m["cleaner"].DoubleCloseError):
            sb.close()
    else:
        sb.close()
        assert mc.double_closes == 1


def _peak_concurrency(pkg, permits=2, tasks=6):
    if pkg == "ref":
        from spark_rapids_tpu.config import RapidsConf as Conf
        from spark_rapids_tpu.execs.base import TaskContext
        from spark_rapids_tpu.memory.semaphore import TpuSemaphore as Sem

        def mk():
            return TaskContext(0)
    else:
        from spark_rapids_tpu_torch.config import RapidsConf as Conf
        from spark_rapids_tpu_torch.execs.base import TaskContext
        from spark_rapids_tpu_torch.memory.semaphore import \
            TorchSemaphore as Sem

        def mk():
            return TaskContext(0, Conf(), torch.device("cpu"))
    Sem.reset_for_tests()
    sem = Sem.get(Conf({"spark.rapids.tpu.concurrentTpuTasks":
                        str(permits)}))
    active, peak = [], []
    lock = threading.Lock()

    def task():
        ctx = mk()
        sem.acquire_if_necessary(ctx)
        sem.acquire_if_necessary(ctx)  # a second call is a no-op
        with lock:
            active.append(1)
            peak.append(len(active))
        time.sleep(0.02)
        with lock:
            active.pop()
        ctx.complete()

    threads = [threading.Thread(target=task) for _ in range(tasks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    free = sem._sem._value
    Sem.reset_for_tests()
    return max(peak), free


def test_semaphore_limits_concurrency():
    assert _peak_concurrency("port") == _peak_concurrency("ref") == (2, 2)


def test_semaphore_nested_contexts_ride_the_threads_permit():
    """A second context on a thread that holds a permit rides it: one
    permit, released with the holder, on success and on an exception."""
    from spark_rapids_tpu_torch.config import RapidsConf
    from spark_rapids_tpu_torch.execs.base import TaskContext
    from spark_rapids_tpu_torch.memory.semaphore import TorchSemaphore
    TorchSemaphore.reset_for_tests()
    sem = TorchSemaphore.get(RapidsConf(
        {"spark.rapids.tpu.concurrentTpuTasks": "1"}))
    root = TaskContext(0, RapidsConf(), torch.device("cpu"))
    sem.acquire_if_necessary(root)
    for p in range(3):  # would deadlock on one permit without riding
        child = root.for_partition(p)
        sem.acquire_if_necessary(child)
    assert sem.state()["riders"] == 3 and sem.available() == 0
    try:
        raise RuntimeError("a task failure")
    except RuntimeError:
        root.complete()
    assert sem.state() == {"permits": 1, "available": 1, "holders": 0,
                           "riders": 0, "total_waits_ns":
                           sem.total_waits_ns}
    TorchSemaphore.reset_for_tests()


@BOTH
def test_unspill_under_pressure_keeps_the_entry(pkg):
    """Unspilling a host-tier buffer whose allocation pushes another buffer
    to the host and the host tier over its limit: the buffer coming back is
    not the one sent to disk. (The reference picks it and then reads its
    dropped host table — ROADMAP C-ref-10 — so it is held to raising.)"""
    m = _m(pkg)
    cat = m["catalog"].get()
    b1, b2 = _batch(pkg, 256, 11), _batch(pkg, 256, 11)
    want = _rows(pkg, b1)
    s1 = m["spill"].SpillableColumnarBatch(b1)
    del b1  # the catalog owns each batch from here: a spill frees it
    size = s1.size_bytes
    cat.synchronous_spill(1 << 40)  # s1 → host
    s2 = m["spill"].SpillableColumnarBatch(b2)  # on the device
    del b2
    m["hbm"].HbmBudget.get().budget = size + 10  # room for one
    cat.host_limit = size  # the host tier holds one
    try:
        if pkg == "ref":
            with pytest.raises(AttributeError):
                s1.get_batch()
            return
        assert _rows(pkg, s1.get_batch()) == want
        assert cat.spilled_to_disk == s2.size_bytes
        assert _rows(pkg, s2.get_batch()) == want  # back from disk
    finally:
        s1.close()
        s2.close()


@pytest.mark.parametrize("force,n,key", [
    ("force_retry_oom", 2, "retryCount"),
    ("force_split_and_retry_oom", 1, "splitAndRetryCount")])
def test_forced_ooms_on_the_query_path_heal(force, n, key):
    """A filter → aggregate query on the general path with forced OOMs:
    the port's first operator registers its batch inside the retry
    scope, so the OOMs heal with the counts forced and the clean rows.
    The reference registers it before the scope and fails the query
    (ROADMAP C-ref-11), which the test records."""
    import spark_rapids_tpu.functions as RF
    import spark_rapids_tpu_torch.functions as TF
    from spark_rapids_tpu.session import TpuSession
    from spark_rapids_tpu_torch.session import TorchSession
    conf = {"spark.rapids.tpu.agg.compiledStage.enabled": "false"}
    data = {"k": np.arange(100) % 3, "v": np.arange(100.0)}
    ref = TpuSession(dict(conf, **{
        "spark.rapids.tpu.opjit.fuseStages": "false",
        "spark.rapids.tpu.coalesce.enabled": "false"}))
    rq = ref.createDataFrame(pa.table(data)).filter(RF.col("v") > 5) \
        .groupBy("k").agg(RF.sum(RF.col("v")).alias("s"))
    want = sorted((r["k"], r["s"]) for r in rq.collect())
    getattr(REF["hbm"].HbmBudget.get(), force)(n)
    with pytest.raises(MemoryError):
        rq.collect()
    s = TorchSession(conf, device="cpu")
    q = s.createDataFrame(data).filter(TF.col("v") > 5).groupBy("k") \
        .agg(TF.sum(TF.col("v")).alias("s"))
    getattr(hbm.HbmBudget.get(), force)(n)
    got = sorted((r["k"], r["s"]) for r in q.collect())
    assert got == want
    m = s.last_task_metrics()
    assert m[key] == n
    assert m["retryCount" if key != "retryCount" else
             "splitAndRetryCount"] == 0
