"""Planner: analyzed logical plan → CPU physical plan (port of
``spark_rapids_tpu/plan/planner.py``).

The plan is all-CPU; ``TorchOverrides`` then retargets it to the device, as
the reference does, for the node kinds the port has: LocalRelation,
DeviceCachedRelation, Project, Filter, Aggregate and Sort.

The reference distributes a grouped aggregate over more than one partition
through a hash exchange on the grouping keys (``per_partition=True``). The
port has no exchange yet: such an aggregate plans as one
``per_partition=False`` aggregate, which reads every partition of its
child, as the reference's own non-per-partition branch does. The exchange
arrives with the shuffle.
"""

from __future__ import annotations

from ..config import RapidsConf
from ..execs import cpu as CE
from ..execs.base import PhysicalPlan
from . import logical as L


def plan_physical(plan: L.LogicalPlan, conf: RapidsConf) -> PhysicalPlan:
    from ..execs.aggregates import CpuHashAggregateExec
    from ..execs.transitions import CpuDeviceScanExec
    from ..io.cache import DeviceCachedRelation
    if isinstance(plan, DeviceCachedRelation):
        return CpuDeviceScanExec(plan.batches(), plan.output)
    if isinstance(plan, L.LocalRelation):
        return CE.CpuLocalTableScanExec(plan.table, plan.num_partitions,
                                        plan.output)
    if isinstance(plan, L.Project):
        return CE.CpuProjectExec(plan.exprs, plan_physical(plan.child, conf),
                                 plan.output)
    if isinstance(plan, L.Filter):
        return CE.CpuFilterExec(plan.condition,
                                plan_physical(plan.child, conf))
    if isinstance(plan, L.Sort):
        return CE.CpuSortExec(plan.order, plan.global_sort,
                              plan_physical(plan.children[0], conf))
    if isinstance(plan, L.Aggregate):
        return CpuHashAggregateExec(plan.grouping, plan.aggregates,
                                    plan_physical(plan.children[0], conf),
                                    plan.output)
    raise NotImplementedError(
        f"planning {type(plan).__name__} not yet ported")
