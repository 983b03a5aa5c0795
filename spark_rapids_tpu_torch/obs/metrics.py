"""Always-on process-wide metrics registry: counters, gauges and bounded
log2-bucket histograms with per-session/per-query labels.

Port of ``spark_rapids_tpu/obs/metrics.py``. The plan cache, the scheduler,
the device budget, the spill catalog and the chaos injector record into it;
:func:`full_snapshot` is the one readout (``session.metrics_snapshot()``).

Design (as the reference):

* **Always on, near-zero cost when idle**: the hot path is one dict lookup
  plus one in-place add on a pre-resolved cell; locks guard only registry
  structure (first sight of a metric or label set) and snapshots. A rare
  lost update under heavy thread contention is the standard
  monitoring-counter tradeoff.
* **Histograms** use log2 buckets: bucket ``i`` counts observations in
  ``[2^(i-1), 2^i)`` (bucket 0: values < 1), 64 buckets; p50/p95/p99 read
  out as the upper edge of the bucket where the cumulative count crosses
  the rank.
* **Query lifecycle** (:func:`query_begin` / :func:`query_end`) feeds the
  ``queries.active`` gauge and the ``query.latency_ms`` /
  ``query.rows_per_s`` histograms for every query.

The snapshot also folds the dispatch counts (``execs/opjit.py``
``calls_by_kind``) and the shuffle catalog's block count; the reference's
mesh collective counters and shuffle byte counts wait for those planes.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

#: global off-switch (spark.rapids.tpu.obs.metrics.enabled; session init
#: applies it) — read unlocked on every emission
_ENABLED = True

_N_BUCKETS = 64

_REG_LOCK = threading.Lock()


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Hist:
    """One label set's log2 histogram cell."""

    __slots__ = ("buckets", "count", "total")

    def __init__(self):
        self.buckets = [0] * _N_BUCKETS
        self.count = 0
        self.total = 0.0

    def observe(self, value) -> None:
        v = int(value)
        idx = v.bit_length() if v > 0 else 0
        if idx >= _N_BUCKETS:
            idx = _N_BUCKETS - 1
        self.buckets[idx] += 1
        self.count += 1
        self.total += float(value)

    def quantile(self, q: float) -> float:
        """Upper bucket edge where the cumulative count crosses rank
        ``q * count`` (factor-of-two resolution)."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        cum = 0
        for i, n in enumerate(self.buckets):
            cum += n
            if cum >= rank:
                return float(1 << i)
        return float(1 << (_N_BUCKETS - 1))

    def snapshot(self) -> Dict[str, Any]:
        return {
            "count": self.count,
            "sum": self.total,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
            "buckets": {f"<{1 << i}": n
                        for i, n in enumerate(self.buckets) if n},
        }


class MetricsRegistry:
    """Process-wide metric store. Engine code uses the module helpers;
    this class is the storage + snapshot."""

    _instance: Optional["MetricsRegistry"] = None

    def __init__(self):
        # name -> {label_key: cell}; counter/gauge cells are one-element
        # lists (in-place adds stay lock-free), histogram cells are _Hist
        self._counters: Dict[str, Dict[Tuple, list]] = {}
        self._gauges: Dict[str, Dict[Tuple, list]] = {}
        self._hists: Dict[str, Dict[Tuple, _Hist]] = {}

    @classmethod
    def get(cls) -> "MetricsRegistry":
        reg = cls._instance
        if reg is None:
            with _REG_LOCK:
                reg = cls._instance
                if reg is None:
                    reg = cls._instance = cls()
        return reg

    @classmethod
    def reset_for_tests(cls) -> "MetricsRegistry":
        global _ENABLED
        with _REG_LOCK:
            cls._instance = cls()
            _ENABLED = True
            return cls._instance

    def _cell(self, table: Dict[str, Dict], name: str, labels, ctor):
        cells = table.get(name)
        key = _label_key(labels)
        if cells is not None:
            cell = cells.get(key)
            if cell is not None:
                return cell
        with _REG_LOCK:
            cells = table.setdefault(name, {})
            cell = cells.get(key)
            if cell is None:
                cell = cells[key] = ctor()
            return cell

    # --- snapshot ----------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        with _REG_LOCK:
            counters = {n: {self._fmt(k): c[0] for k, c in cells.items()}
                        for n, cells in self._counters.items()}
            gauges = {n: {self._fmt(k): c[0] for k, c in cells.items()}
                      for n, cells in self._gauges.items()}
            hists = {n: {self._fmt(k): h.snapshot()
                         for k, h in cells.items()}
                     for n, cells in self._hists.items()}
        return {"counters": counters, "gauges": gauges,
                "histograms": hists}

    @staticmethod
    def _fmt(key: Tuple) -> str:
        return ",".join(f"{k}={v}" for k, v in key) if key else ""


def set_enabled(on: bool) -> None:
    global _ENABLED
    _ENABLED = bool(on)


def counter_inc(name: str, value: int = 1, **labels) -> None:
    """Add ``value`` to a monotonic counter (one cell per label set)."""
    if not _ENABLED:
        return
    cell = MetricsRegistry.get()._cell(
        MetricsRegistry.get()._counters, name, labels, lambda: [0])
    cell[0] += value


def gauge_set(name: str, value, **labels) -> None:
    """Set a gauge to the latest value."""
    if not _ENABLED:
        return
    cell = MetricsRegistry.get()._cell(
        MetricsRegistry.get()._gauges, name, labels, lambda: [0])
    cell[0] = value


def gauge_max(name: str, value, **labels) -> None:
    """Raise a high-water gauge to ``value`` if it exceeds the current."""
    if not _ENABLED:
        return
    cell = MetricsRegistry.get()._cell(
        MetricsRegistry.get()._gauges, name, labels, lambda: [0])
    if value > cell[0]:
        cell[0] = value


def histogram_observe(name: str, value, **labels) -> None:
    """Record one observation into a log2-bucket histogram."""
    if not _ENABLED:
        return
    MetricsRegistry.get()._cell(
        MetricsRegistry.get()._hists, name, labels, _Hist).observe(value)


# ---------------------------------------------------------------------------
# query lifecycle: every query registers here — the active-query gauge/list,
# the latency and rows/s histograms and the query epoch all come from this
# one place.

_QL_LOCK = threading.Lock()
# token -> (name, t0_ns, priority class or None)
_ACTIVE_QUERIES: Dict[int, Tuple[str, int, Optional[str]]] = {}
_EPOCH = 0
_NEXT_TOKEN = 1


def _set_active_gauges_locked() -> None:
    """queries.active total plus one labelled cell per SLO class with an
    active query: a dashboard watching
    queries.active{cls=interactive} sees exactly the class the shed
    policy protects. Committed under the lifecycle lock — an interleaved
    begin/end pair must not overwrite a gauge with a stale count."""
    gauge_set("queries.active", len(_ACTIVE_QUERIES))
    by_cls: Dict[str, int] = {}
    for _name, _t0, cls in _ACTIVE_QUERIES.values():
        if cls is not None:
            by_cls[cls] = by_cls.get(cls, 0) + 1
    from ..serving.query_context import PRIORITIES
    for cls in PRIORITIES:
        gauge_set("queries.active", by_cls.get(cls, 0), cls=cls)


def query_begin(name: str, session: str = "default",
                cls: Optional[str] = None) -> int:
    """Register a query start; returns the token for :func:`query_end`.
    `cls` is the SLO priority class (None for lifecycle paths that
    predate classes — counted in the total, not any per-class cell)."""
    global _EPOCH, _NEXT_TOKEN
    with _QL_LOCK:
        _EPOCH += 1
        token = _NEXT_TOKEN
        _NEXT_TOKEN += 1
        _ACTIVE_QUERIES[token] = (name, time.perf_counter_ns(), cls)
        _set_active_gauges_locked()
    from . import flight as _flight
    _flight.note("query.begin", query=name, session=session)
    return token


def query_end(token: int, rows: Optional[int] = None,
              failed: bool = False, session: str = "default") -> None:
    """Close a query: latency/rows-per-s histograms + completion counters.
    Idempotent on an unknown token."""
    with _QL_LOCK:
        entry = _ACTIVE_QUERIES.pop(token, None)
        _set_active_gauges_locked()
    if entry is None:
        return
    name, t0, _cls = entry
    latency_ms = (time.perf_counter_ns() - t0) / 1e6
    counter_inc("queries.failed" if failed else "queries.completed",
                session=session)
    histogram_observe("query.latency_ms", latency_ms, session=session)
    if rows is not None and not failed and latency_ms > 0:
        histogram_observe("query.rows_per_s", rows / (latency_ms / 1e3),
                          session=session)
    from . import flight as _flight
    _flight.note("query.end", query=name, session=session,
                 latency_ms=round(latency_ms, 3), rows=rows, failed=failed)


def active_queries() -> List[str]:
    with _QL_LOCK:
        return [name for name, _t0, _cls in _ACTIVE_QUERIES.values()]


def active_query_count() -> int:
    with _QL_LOCK:
        return len(_ACTIVE_QUERIES)


def query_epoch() -> int:
    """Monotone count of query begins (any session)."""
    with _QL_LOCK:
        return _EPOCH


# ---------------------------------------------------------------------------
# the one readout: registry + pre-existing process-wide counters folded in
# at snapshot time (their hot paths stay untouched)


def hbm_state() -> Dict[str, Any]:
    """HBM budget state without side-effect instantiation (shared by the
    metrics snapshot and the flight recorder's postmortem bundle)."""
    from ..memory.hbm import HbmBudget
    b = HbmBudget._instance
    if b is None:
        return {}
    return {"budget": b.budget, "used": b.used,
            "peak_used": b.peak_used, "alloc_count": b.alloc_count}


def full_snapshot() -> Dict[str, Any]:
    """The registry snapshot plus the engine's other process-wide counters
    (SyncLedger totals, task metrics, chaos injections, shuffle blocks,
    the scheduler and budget state) — ``session.metrics_snapshot()``
    serves this. Folding never raises: a source that cannot be read
    reports an error string instead."""
    out = MetricsRegistry.get().snapshot()
    out["schema"] = "spark-rapids-tpu-torch/metrics/1"
    out["queries"] = {"active": active_queries(), "epoch": query_epoch()}
    ext: Dict[str, Any] = {}

    def fold(key, fn):
        try:
            ext[key] = fn()
        except Exception as e:  # noqa: BLE001 — a readout must never fail
            ext[key] = {"error": f"{type(e).__name__}: {e}"[:120]}

    def _syncs():
        from ..profiling import SyncLedger
        led = SyncLedger.get()
        return {"total": led.total(), "by_op": led.totals_by_op()}

    def _task_metrics():
        from ..profiling import TaskMetricsRegistry
        return TaskMetricsRegistry.get().snapshot()

    def _chaos():
        from ..chaos import FaultInjector
        inj = FaultInjector.get()
        return {"injections": inj.injection_count(),
                "enabled": inj.enabled}

    def _shuffle():
        from ..shuffle.exchange import ShuffleCatalog
        cat = ShuffleCatalog._instance  # no side-effect instantiation
        if cat is None:
            return {}
        return {"blocks": cat.num_blocks()}

    def _scheduler():
        # the query scheduler's admission state (queued/running names,
        # limits)
        from ..serving.scheduler import QueryScheduler
        s = QueryScheduler._instance  # no side-effect instantiation
        if s is None:
            return {}
        return s.snapshot()

    def _opjit():
        from ..execs import opjit
        return opjit.cache_stats()

    fold("opjit", _opjit)
    fold("sync_ledger", _syncs)
    fold("task_metrics", _task_metrics)
    fold("chaos", _chaos)
    fold("shuffle", _shuffle)
    fold("scheduler", _scheduler)
    fold("hbm", hbm_state)
    out["external"] = ext
    return out
