"""Task-level metrics and the blocking-sync ledger.

Port of the runtime half of ``spark_rapids_tpu/profiling.py``:

* ``TaskMetricsRegistry`` — process-wide accumulators mirroring the
  reference's GpuTaskMetrics: semaphore wait, retry and split counts, retry
  block time, spill bytes by tier, read-spill time, device-retry counts.
  The scheduler snapshots it around each query
  (``session.last_task_metrics()``).
* ``SyncLedger`` — ``{operator: {kind: count}}`` of blocking device→host
  transfers; the metrics snapshot folds its totals in.

The reference's audited sync helpers and the operator scopes that feed the
ledger, its profiler (``TpuProfiler``), trace scopes, plan metric
collection and batch dumps wait with the rest of observability.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional


class TaskMetricsRegistry:
    """Process-wide accumulators mirroring GpuTaskMetrics."""

    _instance: Optional["TaskMetricsRegistry"] = None
    _lock = threading.Lock()

    KNOWN = ("semaphoreWaitNs", "retryCount", "splitAndRetryCount",
             "retryBlockTimeNs", "spillToHostBytes", "spillToDiskBytes",
             "readSpillTimeNs", "deviceRetryCount", "deviceRetryBlockTimeNs")

    def __init__(self):
        self._vals: Dict[str, int] = {k: 0 for k in self.KNOWN}
        self._mu = threading.Lock()

    @classmethod
    def get(cls) -> "TaskMetricsRegistry":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    @classmethod
    def reset_for_tests(cls) -> "TaskMetricsRegistry":
        with cls._lock:
            cls._instance = cls()
            return cls._instance

    def add(self, name: str, value: int) -> None:
        with self._mu:
            self._vals[name] = self._vals.get(name, 0) + int(value)

    def snapshot(self) -> Dict[str, int]:
        with self._mu:
            return dict(self._vals)


class SyncLedger:
    """Process-wide {operator: {kind: count}} of blocking D→H transfers."""

    _instance: Optional["SyncLedger"] = None
    _lock = threading.Lock()

    def __init__(self):
        self._mu = threading.Lock()
        self._by_op: Dict[str, Dict[str, int]] = {}
        self._total = 0

    @classmethod
    def get(cls) -> "SyncLedger":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    @classmethod
    def reset_for_tests(cls) -> "SyncLedger":
        with cls._lock:
            cls._instance = cls()
            return cls._instance

    def record(self, kind: str, op: str = "<unattributed>") -> None:
        with self._mu:
            ops = self._by_op.setdefault(op, {})
            ops[kind] = ops.get(kind, 0) + 1
            self._total += 1

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        with self._mu:
            return {op: dict(kinds) for op, kinds in self._by_op.items()}

    def total(self) -> int:
        with self._mu:
            return self._total

    def totals_by_op(self) -> Dict[str, int]:
        with self._mu:
            return {op: sum(kinds.values())
                    for op, kinds in self._by_op.items()}
