"""Broadcast hash join (port of ``spark_rapids_tpu/execs/broadcast.py``).

The build side (right) materializes once per exec instance, as the
reference's broadcast relation does, and every partition of the stream
side (left) probes it, so the stream keeps its partitioning and needs no
exchange. ``estimated_size_bytes`` sizes a build side from its table for
the planner's broadcast-versus-shuffle choice.
"""

from __future__ import annotations

from typing import Iterator, Optional

from ..columnar.batch import TorchColumnarBatch, concat_batches
from .base import PhysicalPlan, TaskContext
from .joins import CpuShuffledHashJoinExec, TorchShuffledHashJoinExec

#: join types a right-side broadcast supports (Spark's BuildRight)
BROADCAST_RIGHT_TYPES = ("inner", "cross", "leftouter", "left", "leftsemi",
                         "semi", "leftanti", "anti")


class TorchBroadcastHashJoinExec(TorchShuffledHashJoinExec):
    """Equi-join with a collected-once build side (the right)."""

    def __init__(self, left: PhysicalPlan, right: PhysicalPlan,
                 join_type: str, left_keys, right_keys, condition, output):
        super().__init__(left, right, join_type, left_keys, right_keys,
                         condition, output, per_partition=False)
        self._broadcast: Optional[TorchColumnarBatch] = None
        self._broadcast_done = False

    def node_desc(self) -> str:
        return f"TorchBroadcastHashJoin[{self.join_type}]"

    def num_partitions(self) -> int:
        return self.children[0].num_partitions()

    def _build_side(self, ctx: TaskContext) -> Optional[TorchColumnarBatch]:
        if not self._broadcast_done:
            child = self.children[1]
            batches = [b for p in range(child.num_partitions())
                       for b in child.execute_partition(
                           p, ctx.for_partition(p))]
            self._broadcast = concat_batches(batches) if batches else None
            self._broadcast_done = True
        return self._broadcast

    def internal_do_execute_columnar(self, idx: int,
                                     ctx: TaskContext) -> Iterator:
        right = self._build_side(ctx)
        stream = list(self.children[0].execute_partition(idx, ctx))
        if not stream or right is None or not right.num_rows:
            return  # inner join: nothing to emit
        left = concat_batches(stream)
        if left.num_rows:
            out = self._join(left, right, ctx)
            if out.num_rows:
                yield out


class CpuBroadcastHashJoinExec(CpuShuffledHashJoinExec):
    """The planner's broadcast-join node; the override engine converts it."""

    def node_desc(self) -> str:
        return f"CpuBroadcastHashJoin[{self.join_type}]"


def estimated_size_bytes(plan: PhysicalPlan) -> Optional[int]:
    """A build side's size from its in-memory table (Arrow's byte count,
    ``TorchColumnarBatch.nbytes``), through single-child operators; None
    when it cannot be sized so."""
    from .cpu import CpuLocalTableScanExec
    if isinstance(plan, CpuLocalTableScanExec):
        return plan.table.nbytes
    if len(plan.children) == 1:
        return estimated_size_bytes(plan.children[0])
    return None
