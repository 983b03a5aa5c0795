"""Physical plan base classes and reference binding.

Port of ``PhysicalPlan``, ``CpuExec``, ``TaskContext`` and
``bind_references`` from ``spark_rapids_tpu/execs/base.py``, with the
task-completion listeners (the device semaphore releases through them),
the plan cache's clone protocol (``clone_for_execution``), and the
operator metrics of the reference's GpuMetric taxonomy
(GpuExec.scala:41-61): ESSENTIAL/MODERATE/DEBUG levels and the standard
names ``numOutputRows``, ``numOutputBatches`` and ``opTime`` (ns), plus each
operator's ``additional_metrics()``. ``TorchExec.execute_partition`` runs
every batch pull under the operator's sync-ledger scope and a cancel
checkpoint; with tracing or the profiler on, also under a profiler range
and an ``op`` span of the query tracer (``obs/tracer.py``).
"""

from __future__ import annotations

import functools
import threading
import time
from collections import Counter
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Sequence

import torch

from ..config import RapidsConf
from ..expressions.base import AttributeReference, EvalContext, Expression
from ..serving.query_context import checkpoint as _cancel_checkpoint

ESSENTIAL = "ESSENTIAL"
MODERATE = "MODERATE"
DEBUG = "DEBUG"


class TorchMetric:
    """Accumulator metric (reference GpuMetric, the reference's
    ``TpuMetric``). Thread-safe: several threads may add to one operator's
    metrics. Values are host integers (a batch's ``num_rows`` is one), so
    reading a metric never waits on the device."""

    __slots__ = ("name", "level", "_value", "_lock")

    def __init__(self, name: str, level: str = MODERATE):
        self.name = name
        self.level = level
        self._value = 0
        self._lock = threading.Lock()

    def add(self, v: int) -> None:
        with self._lock:
            self._value += int(v)

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    @contextmanager
    def timed(self):
        """Add the host time of the block in ns (no device sync)."""
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.add(time.perf_counter_ns() - t0)


class TaskContext:
    """Per-task execution context: partition id, conf, the session's device
    (where ``HostToDeviceExec`` uploads) and the session's event counters
    (``fallback_runs``, ``fallbackReruns``, ``sort_fallback_runs``,
    ``global_chunked_runs``).
    Completion listeners run at ``complete()`` (reference
    ScalableTaskCompletion): the device semaphore releases a task's permit
    through one."""

    def __init__(self, partition_id: int, conf: RapidsConf,
                 device: torch.device, counters: Optional[Counter] = None):
        self.partition_id = partition_id
        self.conf = conf
        self.device = device
        self.counters = counters if counters is not None else Counter()
        self.eval_ctx = EvalContext(self.conf, partition_id=partition_id,
                                    counters=self.counters)
        self._completion_listeners: List = []
        self._children: List["TaskContext"] = []

    def for_partition(self, partition_id: int) -> "TaskContext":
        """The context of another partition of the same query. It completes
        with this one at the latest; a caller done with it earlier
        completes it itself."""
        child = TaskContext(partition_id, self.conf, self.device,
                            self.counters)
        self._children.append(child)
        return child

    def add_completion_listener(self, cb) -> None:
        """Register a callback run at task end."""
        self._completion_listeners.append(cb)

    def complete(self) -> None:
        """Run the listeners (the minted partition contexts' first), once;
        a listener's failure never masks the task's result."""
        children, self._children = self._children, []
        for c in children:
            c.complete()
        for cb in reversed(self._completion_listeners):
            try:
                cb()
            except Exception:  # noqa: BLE001
                pass
        self._completion_listeners.clear()


import threading as _threading

#: lock flavors replaced wholesale on clone (a clone must never serialize
#: on — or deadlock with — the template's locks)
_LOCK_TYPES = (type(_threading.Lock()), type(_threading.RLock()))


def _rebind_value(v, rebind: dict):
    """Parameter-slot re-binding for ONE attribute value: replace template
    Literal objects (matched by identity) with this submission's literals,
    recursing through lists/tuples/SortOrder. Expression.transform
    preserves unchanged subtrees, so attributes and non-parameter
    expressions stay shared with the template."""

    def rule(e: Expression):
        return rebind.get(id(e))

    def walk(v):
        if isinstance(v, Expression):
            return v.transform(rule)
        if isinstance(v, list):
            return [walk(x) for x in v]
        if isinstance(v, tuple):
            return tuple(walk(x) for x in v)
        if type(v).__name__ == "SortOrder":
            nc = walk(v.child)
            if nc is v.child:
                return v
            import copy
            nv = copy.copy(v)
            nv.child = nc
            return nv
        return v

    return walk(v)


def _rebind_plan_exprs(node: "PhysicalPlan", rebind: dict) -> None:
    """Re-bind every expression attribute of one cloned node — projections,
    filter conditions, pushed parquet filters, join keys, sort orders."""
    for k, v in list(node.__dict__.items()):
        if k == "children" or isinstance(v, dict):
            continue
        node.__dict__[k] = _rebind_value(v, rebind)


def _clone_spec(spec, rebind, memo):
    """Clone a compiled-stage spec object (classes marked ``_PLAN_SPEC``:
    the compiled aggregation and join stages' patterns). Specs capture
    BOTH expressions (filter/project layers, grouping, aggregate functions
    — which must see re-bound literals, or a cache hit would execute the
    template submission's values) and nested PhysicalPlans (a dimension's
    build subtree — which EXECUTES, so it must be this clone's copy).
    Nested plans go through the shared memo so spec links and plan-tree
    links land on the same clones."""
    import copy

    def walk(v):
        if isinstance(v, PhysicalPlan):
            return v.clone_for_execution(rebind, memo)
        if getattr(v, "_PLAN_SPEC", False):
            key = ("spec", id(v))
            got = memo.get(key)
            if got is not None:
                return got
            nv = copy.copy(v)
            memo[key] = nv
            for k, x in list(nv.__dict__.items()):
                nv.__dict__[k] = walk(x)
            return nv
        if isinstance(v, (list, tuple)):
            return type(v)(walk(x) for x in v)
        if rebind:
            return _rebind_value(v, rebind)
        return v

    return walk(spec)


class PhysicalPlan:
    """Base physical operator."""

    children: List["PhysicalPlan"]

    def __init__(self, children: Sequence["PhysicalPlan"]):
        self.children = list(children)
        self.metrics: Dict[str, TorchMetric] = {}
        self._register_metrics()

    @property
    def output(self) -> List[AttributeReference]:
        raise NotImplementedError

    @property
    def is_tpu(self) -> bool:
        """Runs on the device (the reference's name for the property)."""
        return isinstance(self, TorchExec)

    def node_name(self) -> str:
        return type(self).__name__

    def node_desc(self) -> str:
        return self.node_name()

    # --- metrics ----------------------------------------------------------
    def _register_metrics(self) -> None:
        self.metrics["numOutputRows"] = TorchMetric("numOutputRows",
                                                    ESSENTIAL)
        self.metrics["numOutputBatches"] = TorchMetric("numOutputBatches",
                                                       MODERATE)
        self.metrics["opTime"] = TorchMetric("opTime", MODERATE)
        for name, level in self.additional_metrics().items():
            self.metrics[name] = TorchMetric(name, level)

    def additional_metrics(self) -> Dict[str, str]:
        return {}

    def num_partitions(self) -> int:
        return self.children[0].num_partitions() if self.children else 1

    def execute_partition(self, idx: int, ctx: TaskContext) -> Iterator:
        raise NotImplementedError

    # --- plan-cache clone protocol ----------------------------------------
    def clone_for_execution(self, rebind: Optional[dict] = None,
                            memo: Optional[dict] = None) -> "PhysicalPlan":
        """Structural clone of the plan for ONE execution.

        The plan cache (serving/plan_cache.py) stores a physical TEMPLATE
        that never executes; every submission — hit or miss — runs a clone,
        so per-query mutable state (shuffle ids, broadcast builds, the
        compiled join stage's dimension builds) never crosses queries.
        ``rebind`` maps ``id(template_literal)`` → replacement Literal;
        ``memo`` keeps shared subtrees shared in the clone. Immutable
        planning products — expressions, output attributes, conf
        snapshots — are shared with the template."""
        if memo is None:
            memo = {}
        got = memo.get(id(self))
        if got is not None:
            return got
        import copy
        new = copy.copy(self)
        memo[id(self)] = new
        new.children = [c.clone_for_execution(rebind, memo)
                        for c in self.children]
        # plan-valued attrs OUTSIDE children carry expressions and
        # execution state too: a compiled stage's `fallback` subtree, a
        # join's twin; specs hold the stages' patterns
        for k, v in list(new.__dict__.items()):
            if k == "children":
                continue
            if isinstance(v, PhysicalPlan):
                new.__dict__[k] = v.clone_for_execution(rebind, memo)
            elif isinstance(v, (list, tuple)) and v \
                    and all(isinstance(x, PhysicalPlan) for x in v):
                new.__dict__[k] = type(v)(
                    x.clone_for_execution(rebind, memo) for x in v)
            elif getattr(v, "_PLAN_SPEC", False):
                new.__dict__[k] = _clone_spec(v, rebind, memo)
        # each execution counts into its own metrics: a plan-cache hit
        # must not add to the template's (or another clone's) numbers
        new.metrics = {}
        new._register_metrics()
        if rebind:
            _rebind_plan_exprs(new, rebind)
        new._reset_execution_state(rebind)
        return new

    def _reset_execution_state(self, rebind: Optional[dict] = None) -> None:
        """Drop every piece of per-execution state copy.copy carried over,
        by attribute convention: the exchange's materialization, the
        broadcast build, the compiled join stage's dimension builds."""
        d = self.__dict__
        for k, v in list(d.items()):
            if isinstance(v, _LOCK_TYPES):
                d[k] = _threading.Lock()
        d.pop("_last_batch", None)
        if "_shuffle_id" in d:           # exchange materialization
            d["_shuffle_id"] = None
            d["_n_maps"] = 0
        if "_broadcast_done" in d:       # broadcast build-side memo
            d["_broadcast_done"] = False
            d["_broadcast"] = None
        if "_dims_built" in d:           # compiled join stage's dim memo
            d["_dims_built"] = None
        if rebind and "pushed_filters" in d and "_arrow_filter" in d:
            # the derived pyarrow filter bakes the literal VALUES of the
            # pushed filters re-bound above: recompute it, or a hit would
            # prune row groups with the PREVIOUS submission's values
            from ..io.base_scan import arrow_filter_from_condition
            d["_arrow_filter"] = arrow_filter_from_condition(
                d["pushed_filters"])

    def tree_string(self, indent: int = 0) -> str:
        """One line a node; '*' marks operators that run on the device."""
        mark = "*" if self.is_tpu else " "
        lines = ["  " * indent + mark + " " + self.node_desc()]
        for c in self.children:
            lines.append(c.tree_string(indent + 1))
        return "\n".join(lines)

    def collect_nodes(self) -> List["PhysicalPlan"]:
        out = [self]
        for c in self.children:
            out.extend(c.collect_nodes())
        return out


class CpuExec(PhysicalPlan):
    """Host operator: the planner's output and the override engine's input
    (reference CpuExec). Host batches are TorchColumnarBatch on the CPU.
    The host engine's operators count their output (``counts_output``)."""


def counts_output(execute_partition):
    """Decorator for a host-engine operator's ``execute_partition``: each
    batch it yields adds to ``numOutputRows`` and ``numOutputBatches``, as
    ``TorchExec``'s loop counts a device operator's."""

    @functools.wraps(execute_partition)
    def counted(self, idx: int, ctx: TaskContext) -> Iterator:
        rows = self.metrics["numOutputRows"]
        n = self.metrics["numOutputBatches"]
        for b in execute_partition(self, idx, ctx):
            rows.add(b.num_rows)
            n.add(1)
            yield b

    return counted


class TorchExec(PhysicalPlan):
    """Device operator over TorchColumnarBatch (reference TpuExec).
    Subclasses implement internal_do_execute_columnar per partition."""

    def execute_partition(self, idx: int, ctx: TaskContext) -> Iterator:
        from .. import profiling
        from ..config import DEBUG_DUMP_PATH
        from ..obs import tracer as obs
        out_rows = self.metrics["numOutputRows"]
        out_batches = self.metrics["numOutputBatches"]
        keep_last = bool(ctx.conf.get(DEBUG_DUMP_PATH))
        self._last_batch = None  # don't attribute a prior partition's batch
        it = self.internal_do_execute_columnar(idx, ctx)
        # a query that is not traced stays on the plain loop even while a
        # concurrent query on another thread is traced
        tracing = profiling._PROFILING_ACTIVE or (obs._ACTIVE and
                                                  obs.thread_traced())
        name = self.node_name()
        try:
            if not (tracing or keep_last):
                while True:
                    # cooperative cancellation at every batch pull (one
                    # thread-local read when no query is bound); the pull
                    # runs under this operator's sync-ledger scope, so a
                    # blocking transfer attributes to the operator that
                    # caused it
                    _cancel_checkpoint(name)
                    with profiling.sync_scope(name):
                        batch = next(it, None)
                    if batch is None:
                        return
                    out_rows.add(batch.num_rows)
                    out_batches.add(1)
                    yield batch
            while True:
                _cancel_checkpoint(name)
                # each pull is one profiler range and one operator span:
                # upstream operators' pulls run inside this frame on the
                # same thread, so the span tree nests like the plan
                with profiling.trace_scope(name), \
                        profiling.sync_scope(name), \
                        obs.span(name, cat="op", partition=idx):
                    try:
                        batch = next(it)
                    except StopIteration:
                        return
                    except Exception:
                        self._dump_on_failure(ctx)
                        raise
                out_rows.add(batch.num_rows)
                out_batches.add(1)
                if keep_last:
                    self._last_batch = batch
                yield batch
        finally:
            # an abandoned pull (a limit, an unwind) closes the operator's
            # generator now, so its finally blocks release what it holds
            self._last_batch = None
            close = getattr(it, "close", None)
            if close is not None:
                close()

    def _dump_on_failure(self, ctx: TaskContext) -> None:
        """Dump the operator's last good output batch for offline repro when
        spark.rapids.sql.debug.dumpPath is set (reference DumpUtils)."""
        from ..config import DEBUG_DUMP_PATH
        path = ctx.conf.get(DEBUG_DUMP_PATH)
        batch = getattr(self, "_last_batch", None)
        if not path or batch is None:
            return
        try:
            from ..profiling import dump_batch
            dump_batch(batch, str(path), self.node_name())
        except Exception:  # noqa: BLE001 — dumping must not mask the error
            pass

    def internal_do_execute_columnar(self, idx: int,
                                     ctx: TaskContext) -> Iterator:
        raise NotImplementedError


def bind_references(expr: Expression,
                    inputs: List[AttributeReference]) -> Expression:
    """Rewrite AttributeReferences to carry the ordinal of the matching
    input (reference GpuBindReferences)."""
    by_id = {a.expr_id: i for i, a in enumerate(inputs)}

    def rule(e: Expression):
        if isinstance(e, AttributeReference):
            if e.expr_id not in by_id:
                raise ValueError(
                    f"cannot bind {e.name}#{e.expr_id}; inputs: "
                    f"{[f'{a.name}#{a.expr_id}' for a in inputs]}")
            return AttributeReference(e.name, e.dtype, e.nullable,
                                      ordinal=by_id[e.expr_id],
                                      expr_id=e.expr_id)
        return None

    return expr.transform(rule)


def bind_all(exprs: Sequence[Expression],
             inputs: List[AttributeReference]) -> List[Expression]:
    return [bind_references(e, inputs) for e in exprs]


class op_time:
    """Times one operator's own work: ONE host-clock reading feeds both the
    operator's time metric (``opTime`` unless the reference names it
    otherwise, e.g. the transitions' ``uploadTime``/``downloadTime``; ns)
    and the session's ``opTime.<operator>`` counter (ms). Like the
    reference's, it never blocks: on the card it is the time the operator
    spends on the host, launching its work and waiting where the operator
    itself waits, not the device time of what it queued."""

    def __init__(self, ctx: TaskContext, node: PhysicalPlan,
                 metric: str = "opTime"):
        self._ctx, self._node, self._metric = ctx, node, metric

    def __enter__(self) -> "op_time":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter_ns() - self._t0
        self._node.metrics[self._metric].add(dt)
        self._ctx.counters[f"opTime.{self._node.node_name()}"] += dt / 1e6
