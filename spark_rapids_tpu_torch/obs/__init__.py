"""obs: the observability plane (docs/observability.md), port of
``spark_rapids_tpu/obs``.

* **Per-query tracing** (:mod:`.tracer`, near-zero cost when
  ``spark.rapids.tpu.trace.enabled`` is off): each query gets its own
  ring-buffered, thread-aware span/event tracer, with three exports from
  the same record (:mod:`.export`): Chrome trace-event JSON,
  ``session.explain("metrics")`` (:mod:`.explain`; works with tracing off,
  from the session's snapshots) and the diagnostics bundle
  (``session.last_query_profile()``), whose per-operator dispatch and sync
  counts reconcile against its own query's ``calls_by_kind`` and
  SyncLedger deltas.
* **Always-on metrics registry** (:mod:`.metrics`).
* **Crash flight recorder** (:mod:`.flight`).

The reference's mesh profiler waits for the multi-device plane.
"""

from .explain import render_explain_metrics
from .export import build_bundle, chrome_trace, span_tree, write_artifacts
from .tracer import (QueryTracer, SpanRef, begin_query, current_span,
                     end_query, event, inherit, is_active, span,
                     thread_traced)
from . import flight, metrics

__all__ = [
    "QueryTracer", "SpanRef", "begin_query", "build_bundle", "chrome_trace",
    "current_span", "end_query", "event", "flight", "inherit", "is_active",
    "metrics", "render_explain_metrics", "span", "span_tree",
    "thread_traced", "write_artifacts",
]
