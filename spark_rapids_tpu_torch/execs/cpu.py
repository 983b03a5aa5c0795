"""CPU physical operators: what the planner emits and the override engine
retargets (port of a subset of ``spark_rapids_tpu/execs/cpu.py``).

``CpuLocalTableScanExec`` executes: it slices the host table (a
TorchColumnarBatch on the CPU) into partitions and batchSizeRows batches.
The reference evaluates the other CPU operators with ``pyarrow``; that host
engine is not yet ported, so executing one of them raises instead of
running silently. Such a node is left in a plan only when the override
engine kept it on the CPU, and ``explain_fallback()`` says why.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

from ..expressions.base import AttributeReference, Expression
from ..plan.logical import SortOrder
from .base import CpuExec, PhysicalPlan, TaskContext, bind_all, bind_references


def _partition_bounds(rows: int, n: int, idx: int):
    base = rows // n
    start = idx * base + min(idx, rows % n)
    return start, base + (1 if idx < rows % n else 0)


class CpuLocalTableScanExec(CpuExec):
    def __init__(self, table, num_partitions: int,
                 output: List[AttributeReference]):
        super().__init__([])
        self.table = table
        self._num_partitions = max(1, num_partitions)
        self._output = list(output)

    @property
    def output(self) -> List[AttributeReference]:
        return self._output

    def num_partitions(self) -> int:
        return self._num_partitions

    def execute_partition(self, idx: int, ctx: TaskContext) -> Iterator:
        names = [a.name for a in self._output]
        start, count = _partition_bounds(self.table.num_rows,
                                         self._num_partitions, idx)
        step = ctx.conf.batch_size_rows
        for off in range(0, max(count, 1), step):
            chunk = self.table.slice(start + off, min(step, count - off))
            if chunk.num_rows or count == 0:
                yield chunk.rename(names)


class _HostEngineNotPorted(CpuExec):
    """A CPU operator whose host execution is not yet ported."""

    def execute_partition(self, idx: int, ctx: TaskContext) -> Iterator:
        raise NotImplementedError(
            f"CPU execution of {type(self).__name__} not yet ported")


class CpuProjectExec(_HostEngineNotPorted):
    def __init__(self, exprs: Sequence[Expression], child: PhysicalPlan,
                 output: List[AttributeReference]):
        super().__init__([child])
        self.exprs = bind_all(list(exprs), child.output)
        self._output = output

    @property
    def output(self):
        return self._output

    def node_desc(self) -> str:
        return f"CpuProject[{', '.join(e.pretty() for e in self.exprs)}]"


class CpuFilterExec(_HostEngineNotPorted):
    def __init__(self, condition: Expression, child: PhysicalPlan):
        super().__init__([child])
        self.condition = bind_references(condition, child.output)

    @property
    def output(self):
        return self.children[0].output

    def node_desc(self) -> str:
        return f"CpuFilter[{self.condition.pretty()}]"


class CpuSortExec(_HostEngineNotPorted):
    def __init__(self, order: List[SortOrder], global_sort: bool,
                 child: PhysicalPlan):
        super().__init__([child])
        self.order = [SortOrder(bind_references(o.child, child.output),
                                o.ascending, o.nulls_first) for o in order]
        self.global_sort = global_sort

    @property
    def output(self):
        return self.children[0].output

    def num_partitions(self) -> int:
        return 1 if self.global_sort else self.children[0].num_partitions()



class CpuLocalLimitExec(_HostEngineNotPorted):
    def __init__(self, n: int, child: PhysicalPlan):
        super().__init__([child])
        self.n = n

    @property
    def output(self):
        return self.children[0].output


class CpuGlobalLimitExec(_HostEngineNotPorted):
    def __init__(self, n: int, child: PhysicalPlan, offset: int = 0):
        super().__init__([child])
        self.n = n
        self.offset = offset

    @property
    def output(self):
        return self.children[0].output

    def num_partitions(self) -> int:
        return 1


class CpuTopNExec(_HostEngineNotPorted):
    """ORDER BY ... LIMIT n as one operator (Spark TakeOrderedAndProject)."""

    def __init__(self, n: int, order: List[SortOrder], child: PhysicalPlan,
                 offset: int = 0):
        super().__init__([child])
        self.n = n
        self.offset = offset
        self.order = [SortOrder(bind_references(o.child, child.output),
                                o.ascending, o.nulls_first) for o in order]

    @property
    def output(self):
        return self.children[0].output

    def num_partitions(self) -> int:
        return 1

    def node_desc(self) -> str:
        return f"CpuTopN[n={self.n}]"
