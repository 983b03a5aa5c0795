"""Physical plan base classes and reference binding.

Port of ``PhysicalPlan``, ``CpuExec``, ``TaskContext`` and
``bind_references`` from ``spark_rapids_tpu/execs/base.py``. Operator
metrics, the plan-cache clone protocol and the tracing hooks of the
reference are not yet ported; the session's ``counters`` stand in for the
few the port reads.
"""

from __future__ import annotations

from collections import Counter
from typing import Iterator, List, Optional, Sequence

import torch

from ..config import RapidsConf
from ..expressions.base import AttributeReference, EvalContext, Expression


class TaskContext:
    """Per-task execution context: partition id, conf, the session's device
    (where ``HostToDeviceExec`` uploads) and the session's event counters
    (``fallback_runs``, ``fallbackReruns``, ``sort_fallback_runs``)."""

    def __init__(self, partition_id: int, conf: RapidsConf,
                 device: torch.device, counters: Optional[Counter] = None):
        self.partition_id = partition_id
        self.conf = conf
        self.device = device
        self.counters = counters if counters is not None else Counter()
        self.eval_ctx = EvalContext(self.conf, partition_id=partition_id)

    def for_partition(self, partition_id: int) -> "TaskContext":
        """The context of another partition of the same query."""
        return TaskContext(partition_id, self.conf, self.device,
                           self.counters)


class PhysicalPlan:
    """Base physical operator."""

    children: List["PhysicalPlan"]

    def __init__(self, children: Sequence["PhysicalPlan"]):
        self.children = list(children)

    @property
    def output(self) -> List[AttributeReference]:
        raise NotImplementedError

    @property
    def is_tpu(self) -> bool:
        """Runs on the device (the reference's name for the property)."""
        return isinstance(self, TorchExec)

    def node_desc(self) -> str:
        return type(self).__name__

    def num_partitions(self) -> int:
        return self.children[0].num_partitions() if self.children else 1

    def execute_partition(self, idx: int, ctx: TaskContext) -> Iterator:
        raise NotImplementedError

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
    (reference CpuExec). Host batches are TorchColumnarBatch on the CPU."""


class TorchExec(PhysicalPlan):
    """Device operator over TorchColumnarBatch (reference TpuExec)."""

    def execute_partition(self, idx: int, ctx: TaskContext) -> Iterator:
        return self.internal_do_execute_columnar(idx, ctx)

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
