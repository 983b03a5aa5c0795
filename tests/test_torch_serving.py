"""The port's query scheduler held against the JAX reference: the same
submission script gives the same grant order in both schedulers.

Each scenario drives ``QueryScheduler.submit_and_run`` from threads, one
ticket at a time: a submission waits until the scheduler has queued it
before the next one goes, so the order of arrival is fixed and the grant
order is the scheduler's alone. Scenarios: strict class precedence, EDF
within a class, anti-starvation aging, round-robin fairness across
sessions, the budget watermark, tenant quotas, overload shedding (a typed
``QueryShed`` through the front door), and the queue-full error."""

import threading
import time
import types

import pytest

import spark_rapids_tpu.chaos as ref_chaos
import spark_rapids_tpu.memory.hbm as ref_hbm
import spark_rapids_tpu.serving.query_context as ref_qc
import spark_rapids_tpu.serving.scheduler as ref_sched
import spark_rapids_tpu_torch.chaos as port_chaos
import spark_rapids_tpu_torch.memory.hbm as port_hbm
import spark_rapids_tpu_torch.serving.query_context as port_qc
import spark_rapids_tpu_torch.serving.scheduler as port_sched
from spark_rapids_tpu_torch.memory.device import TorchDeviceManager

# the CPU has no device memory to read: the tests state one for the
# budget (spark.rapids.memory.device.totalBytes)
TorchDeviceManager.initialize(device="cpu", total_bytes=8 << 30)

PKGS = {
    "ref": types.SimpleNamespace(sched=ref_sched, qc=ref_qc, hbm=ref_hbm,
                                 chaos=ref_chaos),
    "port": types.SimpleNamespace(sched=port_sched, qc=port_qc,
                                  hbm=port_hbm, chaos=port_chaos),
}


@pytest.fixture(autouse=True)
def _fresh():
    for p in PKGS.values():
        p.chaos.FaultInjector.reset_for_tests()
        p.sched.QueryScheduler.reset_for_tests()
    yield
    for p in PKGS.values():
        p.chaos.FaultInjector.reset_for_tests()
        p.sched.QueryScheduler.reset_for_tests()
        p.hbm.HbmBudget.reset_for_tests()


def _wait(pred, timeout=10.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.005)
    return pred()


class _Submitter:
    """Threads submitting to one package's scheduler."""

    def __init__(self, pkg, **knobs):
        self.p = PKGS[pkg]
        self.sched = self.p.sched.QueryScheduler.get()
        for k, v in knobs.items():
            setattr(self.sched, k, v)
        self.order = []
        self.errs = {}
        self.threads = []

    def occupy(self, priority="interactive", sid="occ"):
        """Hold one slot until the returned release() is called."""
        hold, started = threading.Event(), threading.Event()

        def occupier():
            try:
                with self.p.qc.QueryContext("occ", sid,
                                            priority=priority) as q:
                    self.sched.submit_and_run(
                        q, lambda: (started.set(), hold.wait(15)))
            except BaseException as e:  # noqa: BLE001
                self.errs["occ"] = type(e).__name__

        t = threading.Thread(target=occupier)
        t.start()
        assert started.wait(10)

        def release():
            hold.set()
            t.join(timeout=10)
        return release

    def submit(self, name, sid, priority="interactive", deadline_s=None,
               body=None):
        """Submit on a worker thread and wait until it queued (or ran)."""
        deadline_ns = None if deadline_s is None else \
            time.perf_counter_ns() + int(deadline_s * 1e9)

        def run():
            try:
                with self.p.qc.QueryContext(name, sid, priority=priority,
                                            deadline_ns=deadline_ns) as q:
                    self.sched.submit_and_run(
                        q, body or (lambda: self.order.append(name)))
            except BaseException as e:  # noqa: BLE001 — recorded
                self.errs[name] = type(e).__name__

        t = threading.Thread(target=run)
        t.start()
        self.threads.append(t)
        assert _wait(lambda: self._seen(name) or not t.is_alive())
        return t

    def _seen(self, name):
        """`name` is queued, running, done or failed."""
        with self.sched._mu:
            queued = {tk.qctx.name for per in self.sched._queues.values()
                      for dq in per.values() for tk in dq}
            running = {q.name for q in self.sched._running.values()}
        return name in queued or name in running or name in self.order \
            or name in self.errs

    def join(self):
        for t in self.threads:
            t.join(timeout=15)
        return self.order, dict(self.errs)


def _precedence(pkg):
    d = _Submitter(pkg, max_concurrent=1)
    release = d.occupy()
    d.submit("g1", "G", "background")
    d.submit("b1", "B", "batch")
    d.submit("i1", "I", "interactive")
    release()
    return d.join()


def _round_robin(pkg):
    d = _Submitter(pkg, max_concurrent=1)
    release = d.occupy()
    for name, sid, cls in (("a1", "A", "interactive"),
                           ("a2", "A", "interactive"),
                           ("g1", "G", "background"),
                           ("g2", "G", "background"),
                           ("b1", "B", "interactive"),
                           ("h1", "H", "background"),
                           ("a3", "A", "interactive"),
                           ("c1", "C", "interactive")):
        d.submit(name, sid, cls)
    release()
    return d.join()


def _edf(pkg):
    d = _Submitter(pkg, max_concurrent=1)
    release = d.occupy()
    d.submit("late", "A", deadline_s=600)
    d.submit("early", "B", deadline_s=300)
    d.submit("none", "C")
    d.submit("earliest", "D", deadline_s=100)
    release()
    return d.join()


def _aging(pkg):
    d = _Submitter(pkg, max_concurrent=1, class_aging_ms=150.0)
    release = d.occupy()
    d.submit("g1", "G", "background")
    time.sleep(0.25)  # g1's wait crosses the aging bound
    d.submit("i1", "I", "interactive")
    d.submit("b1", "B", "batch")
    release()
    return d.join()


def _watermark(pkg):
    """A slot is free but the budget is over the watermark: the query
    waits until headroom opens (waived only when nothing runs)."""
    p = PKGS[pkg]
    budget = p.hbm.HbmBudget.reset_for_tests(budget_bytes=1000)
    d = _Submitter(pkg, max_concurrent=2, hbm_watermark=0.5)
    release = d.occupy()
    budget.used = 900
    d.submit("w1", "W")
    time.sleep(0.2)
    seen = list(d.order)  # still queued: over the watermark
    budget.used = 100
    assert _wait(lambda: d.order == ["w1"])
    release()
    order, errs = d.join()
    budget.used = 0
    return seen, order, errs


def _quota(pkg):
    p = PKGS[pkg]
    p.hbm.HbmBudget.reset_for_tests(budget_bytes=1_000_000)
    d = _Submitter(pkg, max_concurrent=4, tenant_hbm_quota=0.1)
    hold, started = threading.Event(), threading.Event()

    def occupier():
        with p.qc.QueryContext("t-big", "T") as q:
            def body():
                q.hbm_bytes = 200_000  # tenant T: 2x over its quota
                started.set()
                hold.wait(15)
            d.sched.submit_and_run(q, body)

    t0 = threading.Thread(target=occupier)
    t0.start()
    assert started.wait(10)
    d.submit("t-next", "T")
    time.sleep(0.2)
    seen = list(d.order)  # T over quota: queues despite free slots
    d.submit("other", "O")
    assert _wait(lambda: d.order == ["other"])
    hold.set()
    t0.join(timeout=10)
    order, errs = d.join()
    return seen, order, errs


def _overload_shed(pkg):
    p = PKGS[pkg]
    d = _Submitter(pkg, max_concurrent=1, shed_after_ms=150.0)
    started = threading.Event()

    def victim_body():
        started.set()
        end = time.monotonic() + 15
        while time.monotonic() < end:
            p.qc.checkpoint("test.loop")
            time.sleep(0.01)

    d.submit("bg", "G", "background", body=victim_body)
    assert started.wait(10)
    d.submit("fg", "I", "interactive")
    order, errs = d.join()
    return order, errs


def _queue_full(pkg):
    d = _Submitter(pkg, max_concurrent=1, max_queue=1, shed_after_ms=0)
    release = d.occupy()
    d.submit("g-queued", "G", "background")
    d.submit("i1", "I", "interactive")  # sheds the lower queued class
    assert _wait(lambda: "g-queued" in d.errs)
    d.submit("i2", "J", "interactive")  # same class: typed backpressure
    assert _wait(lambda: "i2" in d.errs)
    release()
    return d.join()


SCENARIOS = {
    "precedence": (_precedence, (["i1", "b1", "g1"], {})),
    "round_robin": (_round_robin, (["a1", "b1", "c1", "a2", "a3", "g1",
                                    "h1", "g2"], {})),
    "edf": (_edf, (["earliest", "early", "late", "none"], {})),
    "aging": (_aging, (["g1", "i1", "b1"], {})),
    "watermark": (_watermark, ([], ["w1"], {})),
    "quota": (_quota, ([], ["other", "t-next"], {})),
    "overload_shed": (_overload_shed, (["fg"], {"bg": "QueryShedError"})),
    "queue_full": (_queue_full, (["i1"], {"g-queued": "QueryShedError",
                                          "i2": "QueryQueueFull"})),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_same_script_same_grant_order(name):
    fn, expected = SCENARIOS[name]
    want = fn("ref")
    got = fn("port")
    assert got == want
    assert got == expected


def test_front_door_returns_typed_queryshed():
    """Through real sessions: a background query holding the only slot
    while an interactive one waits past shedAfterMs comes back from
    collect() as a typed QueryShed (not an exception) with a retry-after
    hint; the interactive query's rows are the clean run's; nothing
    leaks."""
    import numpy as np

    import spark_rapids_tpu_torch.functions as F
    from spark_rapids_tpu_torch.config import RapidsConf
    from spark_rapids_tpu_torch.memory.cleaner import MemoryCleaner
    from spark_rapids_tpu_torch.memory.hbm import HbmBudget
    from spark_rapids_tpu_torch.session import TorchSession

    def mk(cls):
        return TorchSession({
            "spark.sql.shuffle.partitions": "3",
            "spark.rapids.tpu.query.priority": cls,
            "spark.rapids.tpu.sched.maxConcurrentQueries": "1",
            "spark.rapids.tpu.sched.shedAfterMs": "150"}, device="cpu")

    def agg(s):
        return s.createDataFrame(
            {"k": np.arange(2000) % 20, "v": np.arange(2000)},
            num_partitions=4).groupBy("k").agg(F.sum(F.col("v")).alias("s"))

    bg, fg = mk("background"), mk("interactive")
    bg_df, fg_df = agg(bg), agg(fg)
    clean = sorted(fg_df.collect(), key=str)
    leaks0 = len(MemoryCleaner.get().live_resources())
    # stretch every batch pull so the overload window is wide
    port_chaos.FaultInjector.configure(RapidsConf({
        "spark.rapids.tpu.test.chaos.enabled": "true",
        "spark.rapids.tpu.test.chaos.sites": "query.cancel",
        "spark.rapids.tpu.test.chaos.kinds": "latency",
        "spark.rapids.tpu.test.chaos.probability": "1.0",
        "spark.rapids.tpu.test.chaos.latencyMs": "60"}))
    out = {}
    t = threading.Thread(target=lambda: out.update(bg=bg_df.collect()))
    t.start()
    sched = port_sched.QueryScheduler.get()
    assert _wait(lambda: len(sched._running) == 1)
    out["fg"] = fg_df.collect()
    t.join(timeout=30)
    port_chaos.FaultInjector.reset_for_tests()
    assert isinstance(out["bg"], port_qc.QueryShed)
    assert out["bg"].priority == "background"
    assert out["bg"].retry_after_s > 0
    assert sorted(out["fg"], key=str) == clean
    assert len(MemoryCleaner.get().live_resources()) == leaks0
    assert HbmBudget.get().used == 0
    bg.stop()
    fg.stop()
