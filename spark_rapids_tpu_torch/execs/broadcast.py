"""Broadcast hash join (port of ``spark_rapids_tpu/execs/broadcast.py``).

The build side (right) materializes once per exec instance, as the
reference's broadcast relation does, and every partition of the stream
side (left) probes it, so the stream keeps its partitioning and needs no
exchange. A right-side build supports Spark's BuildRight join types
(``BROADCAST_RIGHT_TYPES``). ``estimated_size_bytes`` sizes a build side
from its table, or a file scan from its files, for the planner's
broadcast-versus-shuffle choice.
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
        if not stream:
            return
        left = concat_batches(stream)
        if not left.num_rows:
            return
        # with an empty build side inner and semi joins emit nothing, anti
        # joins the stream, left outer joins the stream null-extended
        out = self._join_pair(left, right, ctx)
        if out is not None and out.num_rows:
            yield out


class CpuBroadcastHashJoinExec(CpuShuffledHashJoinExec):
    """The planner's broadcast-join node; the override engine converts it."""

    def node_desc(self) -> str:
        return f"CpuBroadcastHashJoin[{self.join_type}]"


def estimated_size_bytes(plan: PhysicalPlan) -> Optional[int]:
    """A build side's size from its in-memory table (Arrow's byte count,
    ``TorchColumnarBatch.nbytes``) or its files, through single-child
    operators; None when it cannot be sized so."""
    import os

    from ..io.parquet import CpuFileScanExec
    from .cpu import CpuLocalTableScanExec
    if isinstance(plan, CpuLocalTableScanExec):
        return plan.table.nbytes
    if isinstance(plan, CpuFileScanExec):
        try:  # the file bytes, times the reference's decode blowup of 3
            return sum(os.path.getsize(p) for p in plan.paths) * 3
        except OSError:
            return None
    if len(plan.children) == 1:
        return estimated_size_bytes(plan.children[0])
    return None
