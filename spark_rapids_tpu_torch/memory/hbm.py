"""Device budget accounting — the RMM-pool analogue.

Port of ``spark_rapids_tpu/memory/hbm.py`` (reference analogue: RMM via
GpuDeviceManager.initializeRmm + DeviceMemoryEventHandler.onAllocFailure:
drain the spill store, retry the allocation). The torch caching allocator
owns the physical memory, so this layer tracks *logical* bytes of live
columnar data (the batches registered in the spill catalog) against a
budget; exceeding it triggers the same synchronous spill → retry → OOM
escalation the reference drives, raising TorchRetryOOM /
TorchSplitAndRetryOOM for the retry framework to absorb. A real
``torch.cuda.OutOfMemoryError`` from the allocator enters the same
framework (``memory/retry.py``).

Test hooks mirror RmmSpark.forceRetryOOM / forceSplitAndRetryOOM, routed
through the chaos injector's forced counters as in the reference.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from ..config import OOM_RETRY_MAX, RapidsConf
from .device import TorchDeviceManager


class TorchOOM(MemoryError):
    """Unrecoverable device OOM (reference GpuOOM)."""


class TorchRetryOOM(TorchOOM):
    """Retryable: the caller should release, spill and re-execute
    (reference GpuRetryOOM)."""


class TorchSplitAndRetryOOM(TorchOOM):
    """Retryable with input splitting (reference GpuSplitAndRetryOOM)."""


class HbmBudget:
    """Logical device-memory accounting with synchronous spill-on-pressure."""

    _instance: Optional["HbmBudget"] = None
    _lock = threading.Lock()

    def __init__(self, budget_bytes: int, oom_max_retries: int = 3):
        self.budget = budget_bytes
        self.used = 0
        self.oom_max_retries = oom_max_retries
        self._alloc_lock = threading.RLock()
        self._spill_callback: Optional[Callable[[int], int]] = None
        self.peak_used = 0
        self.alloc_count = 0

    @classmethod
    def get(cls, conf: Optional[RapidsConf] = None) -> "HbmBudget":
        with cls._lock:
            if cls._instance is None:
                conf = conf or RapidsConf()
                cls._instance = HbmBudget(
                    TorchDeviceManager.hbm_budget_bytes(),
                    conf.get(OOM_RETRY_MAX))
            return cls._instance

    @classmethod
    def reset_for_tests(cls, budget_bytes: Optional[int] = None
                        ) -> "HbmBudget":
        from ..chaos import FaultInjector
        # forced-OOM counters are part of the budget's test-hook state: a
        # partially-consumed force must not leak into the next test
        FaultInjector.get().clear_forced("hbm.alloc")
        with cls._lock:
            cls._instance = HbmBudget(
                budget_bytes or TorchDeviceManager.hbm_budget_bytes())
            return cls._instance

    def set_spill_callback(self, cb: Callable[[int], int]) -> None:
        """cb(bytes_needed) -> bytes_freed; called under allocation
        pressure (reference RmmEventHandler.onAllocFailure wiring)."""
        self._spill_callback = cb

    # --- test injection (reference RmmSpark.forceRetryOOM) -----------------
    def force_retry_oom(self, n: int = 1) -> None:
        from ..chaos import FaultInjector
        FaultInjector.get().force("hbm.alloc", "retry_oom", n)

    def force_split_and_retry_oom(self, n: int = 1) -> None:
        from ..chaos import FaultInjector
        FaultInjector.get().force("hbm.alloc", "split_oom", n)

    # --- allocation --------------------------------------------------------
    def allocate(self, nbytes: int) -> None:
        from ..chaos import inject
        from ..obs import metrics as _metrics
        from ..obs import tracer as _obs
        with self._alloc_lock:
            self.alloc_count += 1
            inject("hbm.alloc", detail=f"{nbytes}B")
            if _obs._ACTIVE:
                _obs.event("hbm.alloc", cat="memory", bytes=nbytes,
                           used=self.used)
            retries = 0
            while self.used + nbytes > self.budget:
                freed = 0
                if self._spill_callback is not None:
                    freed = self._spill_callback(
                        self.used + nbytes - self.budget)
                _metrics.counter_inc("hbm.pressure_events")
                if _obs._ACTIVE:
                    _obs.event("hbm.pressure", cat="memory", bytes=nbytes,
                               used=self.used, freed=freed)
                if freed <= 0:
                    retries += 1
                    if retries > self.oom_max_retries:
                        from ..obs import flight as _flight
                        _metrics.counter_inc("hbm.oom_events")
                        exc = TorchRetryOOM(
                            f"device budget exhausted: used={self.used} "
                            f"request={nbytes} budget={self.budget}")
                        # a REAL budget exhaustion (vs a chaos-injected
                        # healable one): failure.handle_task_failure dumps
                        # the postmortem only if the retry framework above
                        # cannot heal it
                        exc.budget_exhausted = True
                        _flight.note("hbm.oom", used=self.used,
                                     request=nbytes, budget=self.budget)
                        raise exc
                    TorchDeviceManager.synchronize()
            self.used += nbytes
            self.peak_used = max(self.peak_used, self.used)
            _metrics.gauge_max("hbm.high_water_bytes", self.peak_used)
        # per-tenant attribution: charged to the query bound on this thread
        from ..serving.query_context import charge_hbm
        charge_hbm(nbytes)

    def free(self, nbytes: int) -> None:
        with self._alloc_lock:
            self.used = max(0, self.used - nbytes)
        from ..serving.query_context import release_hbm
        release_hbm(nbytes)
