"""Profiling, tracing and task-level metrics.

Port of ``spark_rapids_tpu/profiling.py``:

* ``TaskMetricsRegistry`` — process-wide accumulators mirroring the
  reference's GpuTaskMetrics: semaphore wait, retry and split counts, retry
  block time, spill bytes by tier, read-spill time, device-retry counts.
  The scheduler snapshots it around each query
  (``session.last_task_metrics()``).
* ``SyncLedger`` — ``{operator: {kind: count}}`` of blocking device→host
  transfers, fed by the audited gate of ``columnar/vector.py`` under the
  operator scope (``sync_scope``) that ``TorchExec.execute_partition``
  keeps around every batch pull.
* ``trace_scope`` — a ``torch.profiler.record_function`` range (the
  reference's NVTX analogue) while ``TorchProfiler`` runs.
* ``TorchProfiler`` — ``torch.profiler`` over the enclosed queries, one
  Chrome trace under ``spark.rapids.profile.pathPrefix``
  (``session.profiler()``).
* ``collect_plan_metrics`` / ``snapshot_plan_metrics`` /
  ``metric_level_filter`` — per-operator metrics keyed ``"i:NodeName"`` in
  preorder, filtered by level.
* ``dump_batch`` — a problem batch to parquet for offline repro
  (reference DumpUtils).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
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

    def record(self, kind: str, op: Optional[str] = None) -> None:
        if op is None:
            op = current_sync_scope()
        with self._mu:
            ops = self._by_op.setdefault(op, {})
            ops[kind] = ops.get(kind, 0) + 1
            self._total += 1
        # the query tracer's sync event and per-query counter, attributed
        # to the same operator scope, so a bundle reconciles against its
        # own query even when others run at the same time
        from .obs import tracer as _obs
        if _obs._ACTIVE:
            _obs.sync_event(op, kind)

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


class _SyncScope(threading.local):
    """Stack of operator names; the top attributes recorded syncs. Thread-
    local: worker threads carry their own."""
    stack = ()


_sync_scope_tls = _SyncScope()


def current_sync_scope() -> str:
    st = _sync_scope_tls.stack
    return st[-1] if st else "<unattributed>"


@contextlib.contextmanager
def sync_scope(name: str):
    """Attribute blocking syncs inside the scope to `name` (set by
    TorchExec.execute_partition around each batch pull, so nested pulls
    re-attribute to the producing operator)."""
    _sync_scope_tls.stack = _sync_scope_tls.stack + (name,)
    try:
        yield
    finally:
        _sync_scope_tls.stack = _sync_scope_tls.stack[:-1]


def record_sync(kind: str, op: Optional[str] = None) -> None:
    """Record one blocking device→host transfer (called by the audited
    gate in columnar/vector.py)."""
    SyncLedger.get().record(kind, op)


# ---------------------------------------------------------------------------
# operator trace scopes (the reference's NVTX analogue)

_PROFILING_ACTIVE = False


@contextlib.contextmanager
def trace_scope(name: str):
    """A named ``torch.profiler.record_function`` range while a
    ``TorchProfiler`` runs; free otherwise."""
    if not _PROFILING_ACTIVE:
        yield
        return
    import torch
    with torch.profiler.record_function(name):
        yield


# ---------------------------------------------------------------------------
# the profiler


class TorchProfiler:
    """The profiler over a query region (reference ProfilerOnExecutor, the
    reference's ``TpuProfiler``): one Chrome trace, ``<path>/trace.json``,
    under ``spark.rapids.profile.pathPrefix``, with the operators'
    ``trace_scope`` ranges. On a CUDA session it records the device's
    kernels and copies too; where the profiler cannot (no CUPTI), ``start``
    raises rather than record the host alone. It drives torch's Kineto
    profiler directly and saves its raw events: ``torch.profiler.profile``
    would also build a Python event tree on exit, about a millisecond a
    device op."""

    def __init__(self, path_prefix: str, device=None):
        import torch
        self.path = os.path.join(path_prefix,
                                 f"rapids-torch-profile-{time.time_ns()}")
        self.trace_path = os.path.join(self.path, "trace.json")
        self._cuda = torch.device(device or "cpu").type == "cuda"
        self._on = False

    def start(self) -> None:
        global _PROFILING_ACTIVE
        import torch
        from torch._C._profiler import ProfilerActivity, _ExperimentalConfig
        from torch.autograd import (ProfilerConfig, ProfilerState,
                                    _enable_profiler, _prepare_profiler)
        acts = {ProfilerActivity.CPU}
        if self._cuda:
            if ProfilerActivity.CUDA not in \
                    torch.profiler.supported_activities():
                raise RuntimeError(
                    "the profiler cannot record CUDA activity here (no "
                    "CUPTI): refusing to profile the host alone")
            acts.add(ProfilerActivity.CUDA)
        os.makedirs(self.path, exist_ok=True)
        config = ProfilerConfig(ProfilerState.KINETO, False, False, False,
                                False, False, _ExperimentalConfig())
        _prepare_profiler(config, acts)
        _enable_profiler(config, acts)
        self._on = True
        _PROFILING_ACTIVE = True

    def stop(self) -> None:
        global _PROFILING_ACTIVE
        if not self._on:
            return
        from torch.autograd import _disable_profiler
        self._on = False
        _PROFILING_ACTIVE = False
        if self._cuda:
            import torch
            torch.cuda.synchronize()  # the queued kernels into the trace
        _disable_profiler().save(self.trace_path)

    def __enter__(self) -> "TorchProfiler":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


# ---------------------------------------------------------------------------
# plan metric collection


_LEVEL_ORDER = {"ESSENTIAL": 0, "MODERATE": 1, "DEBUG": 2}


def collect_plan_metrics(plan, level: str = "MODERATE"
                         ) -> Dict[str, Dict[str, int]]:
    """Per-operator metric values at or above the requested level
    (ESSENTIAL ⊂ MODERATE ⊂ DEBUG, reference GpuMetric levels)."""
    return metric_level_filter(snapshot_plan_metrics(plan), level)


def snapshot_plan_metrics(plan) -> Dict[str, Dict[str, tuple]]:
    """All non-zero metrics with their levels, as plain data — the session
    drops the plan after the query (no device buffers pinned) and still
    filters by level later."""
    out: Dict[str, Dict[str, tuple]] = {}
    for i, node in enumerate(plan.collect_nodes()):
        vals = {m.name: (m.value, m.level) for m in node.metrics.values()
                if m.value}
        if vals:
            out[f"{i}:{node.node_name()}"] = vals
    return out


def metric_level_filter(snapshot: Dict[str, Dict[str, tuple]],
                        level: str) -> Dict[str, Dict[str, int]]:
    want = _LEVEL_ORDER.get(str(level).upper(), 1)
    out: Dict[str, Dict[str, int]] = {}
    for op, vals in snapshot.items():
        kept = {n: v for n, (v, lvl) in vals.items()
                if _LEVEL_ORDER.get(lvl, 1) <= want}
        if kept:
            out[op] = kept
    return out


# ---------------------------------------------------------------------------
# batch dump for offline repro


def dump_batch(batch, path_prefix: str, op_name: str) -> str:
    """Write a problem batch to parquet for offline repro (reference
    DumpUtils.scala). Returns the written path."""
    import pyarrow.parquet as pq
    os.makedirs(path_prefix, exist_ok=True)
    p = os.path.join(path_prefix,
                     f"dump-{op_name}-{int(time.time() * 1000)}.parquet")
    table = batch if hasattr(batch, "num_columns") and not hasattr(
        batch, "to_arrow") else batch.to_host().to_arrow()
    pq.write_table(table, p)
    return p
