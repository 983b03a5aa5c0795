"""Planner: analyzed logical plan → CPU physical plan (port of
``spark_rapids_tpu/plan/planner.py``).

The plan is all-CPU; ``TorchOverrides`` then retargets it to the device, as
the reference does, for the node kinds the port has: LocalRelation,
DeviceCachedRelation, CachedRelation (``df.cache()``), Range, FileScan
(with the pushable conjuncts of a Filter right above it), Project,
Filter, Limit, Sample, Sort, Aggregate, Join, Union, Expand, WindowOp and
Repartition (``shuffle/exchange.plan_cpu_exchange``). Generate and the
other nodes of A6/A8 raise "not yet ported".

A grouped aggregate over more than one partition, and a join that cannot
broadcast its build side, distribute their input through hash exchanges on
their keys (``per_partition``), as in the reference. A join without
equi-keys is a broadcast nested loop join, or a cartesian product when it
is an inner or cross join whose right side is sized past the broadcast
threshold. Dynamic partition pruning (scans of partitioned files) is not
yet ported.
"""

from __future__ import annotations

from ..config import (AUTO_BROADCAST_JOIN_THRESHOLD, LOGICAL_JOIN_STRATEGY,
                      SHUFFLE_PARTITIONS, RapidsConf)
from ..execs import cpu as CE
from ..execs.base import PhysicalPlan
from . import logical as L


def plan_physical(plan: L.LogicalPlan, conf: RapidsConf) -> PhysicalPlan:
    from ..execs.aggregates import CpuHashAggregateExec
    from ..execs.transitions import CpuDeviceScanExec
    from ..io.cache import CachedRelation, DeviceCachedRelation
    from ..shuffle.exchange import CpuShuffleExchangeExec
    if isinstance(plan, CachedRelation):
        return CE.CpuCachedScanExec(plan, plan.output)
    if isinstance(plan, DeviceCachedRelation):
        return CpuDeviceScanExec(plan.batches(), plan.output)
    if isinstance(plan, L.LocalRelation):
        return CE.CpuLocalTableScanExec(plan.table, plan.num_partitions,
                                        plan.output)
    if isinstance(plan, L.Range):
        return CE.CpuRangeExec(plan.start, plan.end, plan.step,
                               plan.num_partitions, plan.output)
    if isinstance(plan, L.FileScan):
        return _plan_file_scan(plan, ())
    if isinstance(plan, L.Project):
        return CE.CpuProjectExec(plan.exprs, plan_physical(plan.child, conf),
                                 plan.output)
    if isinstance(plan, L.Filter):
        if isinstance(plan.child, L.FileScan):
            # pushable conjuncts prune row groups; the exact Filter stays
            # above (reference GpuParquetFileFilterHandler)
            from ..io.base_scan import pushable, split_conjuncts
            pushed = [c for c in split_conjuncts(plan.condition)
                      if pushable(c)]
            return CE.CpuFilterExec(plan.condition,
                                    _plan_file_scan(plan.child, pushed))
        return CE.CpuFilterExec(plan.condition,
                                plan_physical(plan.child, conf))
    if isinstance(plan, L.Limit):
        inner = plan.children[0]
        if isinstance(inner, L.Sort) and inner.global_sort:
            # Limit(Sort) → TopN: a top-n a partition and one merge
            return CE.CpuTopNExec(plan.n, inner.order,
                                  plan_physical(inner.children[0], conf),
                                  plan.offset)
        # the local limit keeps offset + n rows: the global one skips offset
        return CE.CpuGlobalLimitExec(
            plan.n, CE.CpuLocalLimitExec(plan.n + plan.offset,
                                         plan_physical(inner, conf)),
            plan.offset)
    if isinstance(plan, L.Sample):
        from ..execs.sample import CpuSampleExec
        return CpuSampleExec(plan.fraction, plan.with_replacement, plan.seed,
                             plan_physical(plan.children[0], conf))
    if isinstance(plan, L.Repartition):
        from ..shuffle.exchange import plan_cpu_exchange
        return plan_cpu_exchange(plan, conf)
    if isinstance(plan, L.Union):
        return CE.CpuUnionExec([plan_physical(c, conf)
                                for c in plan.children], plan.output)
    if isinstance(plan, L.Sort):
        return CE.CpuSortExec(plan.order, plan.global_sort,
                              plan_physical(plan.children[0], conf))
    if isinstance(plan, L.Aggregate):
        child = plan_physical(plan.children[0], conf)
        if plan.grouping and child.num_partitions() > 1:
            # distribute by the grouping keys: each output partition holds
            # whole groups
            n = min(conf.get(SHUFFLE_PARTITIONS),
                    max(child.num_partitions(), 2))
            child = CpuShuffleExchangeExec(child, "hash", plan.grouping, n)
            return CpuHashAggregateExec(plan.grouping, plan.aggregates, child,
                                        plan.output, per_partition=True)
        return CpuHashAggregateExec(plan.grouping, plan.aggregates, child,
                                    plan.output)
    if isinstance(plan, L.Join):
        return _plan_join(plan, conf)
    if isinstance(plan, L.Expand):
        return CE.CpuExpandExec(plan.projections,
                                plan_physical(plan.children[0], conf),
                                plan.output)
    if isinstance(plan, L.WindowOp):
        return CE.CpuWindowExec(plan.window_exprs,
                                plan_physical(plan.children[0], conf),
                                plan.output)
    raise NotImplementedError(
        f"planning {type(plan).__name__} not yet ported")


def _plan_file_scan(plan: L.FileScan, pushed) -> PhysicalPlan:
    """The CPU file scan of the columns a query reads; a column whose type
    the port cannot carry (a nested type) stops the query here."""
    from ..io.parquet import CpuFileScanExec
    from .typechecks import scan_type_error
    error = scan_type_error(plan.output)
    if error:
        raise NotImplementedError(error)
    return CpuFileScanExec(plan.paths, plan.fmt, plan.output,
                           pushed_filters=pushed, options=plan.options,
                           num_partitions=plan.num_partitions)


def _plan_join(plan: L.Join, conf: RapidsConf) -> PhysicalPlan:
    from ..execs.broadcast import (BROADCAST_RIGHT_TYPES,
                                   CpuBroadcastHashJoinExec,
                                   estimated_size_bytes)
    from ..execs.joins import CpuShuffledHashJoinExec
    from ..shuffle.exchange import CpuShuffleExchangeExec
    left = plan_physical(plan.left, conf)
    right = plan_physical(plan.right, conf)
    threshold = conf.get(AUTO_BROADCAST_JOIN_THRESHOLD)
    r_size = estimated_size_bytes(right)
    if not plan.left_keys:
        return _plan_nested_loop_join(plan, left, right, threshold, r_size)
    if r_size is None and conf.get(LOGICAL_JOIN_STRATEGY):
        # no table to size the build side from: the logical estimate
        from .cbo import estimate_logical_bytes
        r_size = estimate_logical_bytes(plan.right)
    args = (plan.join_type, plan.left_keys, plan.right_keys, plan.condition,
            plan.output)
    if (threshold > 0 and r_size is not None and r_size <= threshold
            and plan.join_type in BROADCAST_RIGHT_TYPES
            and left.num_partitions() > 1):
        return CpuBroadcastHashJoinExec(left, right, *args)
    if left.num_partitions() > 1 or right.num_partitions() > 1:
        n = min(conf.get(SHUFFLE_PARTITIONS),
                max(left.num_partitions(), right.num_partitions(), 2))
        left = CpuShuffleExchangeExec(left, "hash", plan.left_keys, n)
        right = CpuShuffleExchangeExec(right, "hash", plan.right_keys, n)
        return CpuShuffledHashJoinExec(left, right, *args,
                                       per_partition=True)
    return CpuShuffledHashJoinExec(left, right, *args)


def _plan_nested_loop_join(plan: L.Join, left, right, threshold: int,
                           r_size) -> PhysicalPlan:
    """A join without equi-keys: an inner or cross join whose right side is
    sized past the broadcast threshold pairs partitions in a cartesian
    product (Spark's CartesianProductExec); any other one broadcasts
    (reference ``plan_physical``)."""
    from ..execs.joins import (CpuBroadcastNestedLoopJoinExec,
                               CpuCartesianProductExec)
    if plan.join_type in ("inner", "cross") and threshold > 0 \
            and r_size is not None and r_size > threshold:
        return CpuCartesianProductExec(left, right, plan.condition,
                                       plan.output)
    return CpuBroadcastNestedLoopJoinExec(left, right, plan.join_type,
                                          plan.condition, plan.output)
