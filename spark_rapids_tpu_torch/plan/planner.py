"""Planner: analyzed logical plan → physical plan of device operators.

The reference (``spark_rapids_tpu/plan/planner.py``) plans CPU execs and
lets ``TpuOverrides`` retarget them to the device. Until the CPU execs and
the override engine are ported, this planner plans device execs directly,
for the node kinds the port has: LocalRelation, DeviceCachedRelation,
Project, Filter and Aggregate. The compiled-stage post-pass
(``execs.compiled.compile_agg_stages``) then runs as in the reference.
"""

from __future__ import annotations

import torch

from ..config import RapidsConf
from ..execs.base import PhysicalPlan
from . import logical as L


def plan_physical(plan: L.LogicalPlan, conf: RapidsConf,
                  device: torch.device) -> PhysicalPlan:
    from ..execs.aggregates import TorchHashAggregateExec
    from ..execs.basic import TorchFilterExec, TorchProjectExec
    from ..execs.transitions import (TorchDeviceScanExec,
                                     TorchLocalTableScanExec)
    from ..io.cache import DeviceCachedRelation
    if isinstance(plan, DeviceCachedRelation):
        return TorchDeviceScanExec(plan.batches(), plan.output)
    if isinstance(plan, L.LocalRelation):
        return TorchLocalTableScanExec(plan.table, plan.num_partitions,
                                       plan.output, device)
    if isinstance(plan, L.Project):
        return TorchProjectExec(plan.exprs,
                                plan_physical(plan.child, conf, device),
                                plan.output)
    if isinstance(plan, L.Filter):
        return TorchFilterExec(plan.condition,
                               plan_physical(plan.child, conf, device))
    if isinstance(plan, L.Aggregate):
        # the compiled stage aggregates every partition globally, so the
        # reference's hash exchange below a grouped aggregate is not needed
        return TorchHashAggregateExec(
            plan.grouping, plan.aggregates,
            plan_physical(plan.children[0], conf, device), plan.output)
    raise NotImplementedError(
        f"planning {type(plan).__name__} not yet ported")
