"""TorchSemaphore: admission control limiting the concurrent tasks that
hold device memory.

Port of ``spark_rapids_tpu/memory/semaphore.py`` (reference analogue:
GpuSemaphore.acquireIfNecessary/releaseIfNecessary, default
``spark.rapids.tpu.concurrentTpuTasks=2``). A task acquires once before
its device work and releases at task completion, through the
``TaskContext`` completion listener, so the permit returns on success, on
an exception and on a cancel alike.

One difference from the reference: the port runs a query's nested tasks
(an exchange's map tasks, a build side's partitions) on the thread that
runs the query, each under a context of its own. A context acquiring on a
thread that already holds a permit through another live context rides
that permit instead of taking a second one, as the reference's ``adopt``
lets a partition group's members ride their group's permit: two nested
contexts on one thread each waiting for a permit would otherwise deadlock
the thread against ``concurrentTpuTasks``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from ..config import CONCURRENT_TPU_TASKS, RapidsConf


class TorchSemaphore:
    _instance: Optional["TorchSemaphore"] = None
    _lock = threading.Lock()

    def __init__(self, permits: int):
        self.permits = permits
        self._sem = threading.BoundedSemaphore(permits)
        # context id -> (context, holding thread id); the context is held
        # so its id cannot be reused while it is registered
        self._holders: Dict[int, Any] = {}
        self._by_thread: Dict[int, int] = {}  # thread id -> holder ctx id
        self._riders: Dict[int, Any] = {}  # ctx id -> ctx riding a permit
        self._state_lock = threading.Lock()
        self.total_waits_ns = 0

    @classmethod
    def get(cls, conf: Optional[RapidsConf] = None) -> "TorchSemaphore":
        with cls._lock:
            if cls._instance is None:
                conf = conf or RapidsConf()
                cls._instance = TorchSemaphore(conf.get(CONCURRENT_TPU_TASKS))
            return cls._instance

    @classmethod
    def reset_for_tests(cls) -> None:
        with cls._lock:
            cls._instance = None

    def acquire_if_necessary(self, ctx) -> None:
        """The first call for a task blocks for a permit (or rides the
        permit its thread already holds); later calls are no-ops. Release
        is registered as a completion listener of `ctx`."""
        tid = id(ctx)
        th = threading.get_ident()
        with self._state_lock:
            if tid in self._holders or tid in self._riders:
                return
            if th in self._by_thread:
                self._riders[tid] = ctx
                ctx.add_completion_listener(
                    lambda: self.release_if_necessary(ctx))
                return
        t0 = time.perf_counter_ns()
        self._sem.acquire()
        waited = time.perf_counter_ns() - t0
        from ..obs import metrics as _metrics
        from ..profiling import TaskMetricsRegistry
        TaskMetricsRegistry.get().add("semaphoreWaitNs", waited)
        _metrics.counter_inc("semaphore.waits")
        _metrics.counter_inc("semaphore.wait_ns", waited)
        from ..obs import tracer as _obs
        if _obs._ACTIVE:
            _obs.event("semaphore.wait", cat="memory", wait_ns=waited)
        with self._state_lock:
            self.total_waits_ns += waited
            self._holders[tid] = (ctx, th)
            self._by_thread[th] = tid
        ctx.add_completion_listener(lambda: self.release_if_necessary(ctx))

    def release_if_necessary(self, ctx) -> None:
        tid = id(ctx)
        with self._state_lock:
            if self._riders.pop(tid, None) is not None:
                return  # rode another context's permit
            held = self._holders.pop(tid, None)
            if held is None:
                return
            th = held[1]
            if self._by_thread.get(th) == tid:
                del self._by_thread[th]
        self._sem.release()

    def available(self) -> int:
        """Free permits right now."""
        return self._sem._value

    def state(self) -> Dict[str, int]:
        with self._state_lock:
            return {"permits": self.permits, "available": self.available(),
                    "holders": len(self._holders),
                    "riders": len(self._riders),
                    "total_waits_ns": self.total_waits_ns}
