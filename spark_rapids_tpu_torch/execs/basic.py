"""Project, filter, union, limit and range operators on torch batches (port
of TpuProjectExec, TpuFilterExec, TpuUnionExec, TpuLocalLimitExec,
TpuGlobalLimitExec and TpuRangeExec from
``spark_rapids_tpu/execs/basic.py``). Expressions
evaluate eagerly (the reference's per-operator jit cache is a JAX compile
cache with nothing to port). Project and filter run each batch under the
retry framework (``memory/retry.with_retry``): the input is spillable, and
an out-of-memory error retries after a spill or splits the batch in half,
as both are row-wise."""

from __future__ import annotations

from typing import Iterator, List, Sequence

import torch

from ..columnar.batch import (TorchColumnarBatch, compact, concat_batches,
                             slice_batch)
from ..expressions.base import AttributeReference, Expression, to_column
from .base import (PhysicalPlan, TaskContext, TorchExec, bind_all,
                   bind_references, op_time)


class TorchProjectExec(TorchExec):
    def __init__(self, exprs: Sequence[Expression], child: PhysicalPlan,
                 output: List[AttributeReference]):
        super().__init__([child])
        self.exprs = bind_all(list(exprs), child.output)
        self._output = output

    @property
    def output(self):
        return self._output

    def node_desc(self) -> str:
        return f"TorchProject[{', '.join(e.pretty() for e in self.exprs)}]"

    def internal_do_execute_columnar(self, idx: int,
                                     ctx: TaskContext) -> Iterator:
        from ..config import TASK_RETRY_LIMIT
        from ..memory.retry import with_retry
        names = [a.name for a in self._output]

        def project(batch: TorchColumnarBatch) -> TorchColumnarBatch:
            with op_time(ctx, self):
                cols = [to_column(e.eval_device(batch, ctx.eval_ctx), batch,
                                  a.dtype)
                        for e, a in zip(self.exprs, self._output)]
            return TorchColumnarBatch(cols, batch.num_rows, names)

        for batch in self.children[0].execute_partition(idx, ctx):
            # projection is row-wise, so split halves are independently
            # valid outputs (reference GpuProjectExec withRetry); the
            # framework registers the batch inside its first attempt and
            # owns it: no reference here may outlive a spill of it
            gen = with_retry(batch, project,
                             max_retries=ctx.conf.get(TASK_RETRY_LIMIT))
            del batch
            yield from gen


class TorchFilterExec(TorchExec):
    def __init__(self, condition: Expression, child: PhysicalPlan):
        super().__init__([child])
        self.condition = bind_references(condition, child.output)

    @property
    def output(self):
        return self.children[0].output

    def node_desc(self) -> str:
        return f"TorchFilter[{self.condition.pretty()}]"

    def internal_do_execute_columnar(self, idx: int,
                                     ctx: TaskContext) -> Iterator:
        from ..config import TASK_RETRY_LIMIT
        from ..memory.retry import with_retry

        def do_filter(batch: TorchColumnarBatch) -> TorchColumnarBatch:
            with op_time(ctx, self):
                c = to_column(self.condition.eval_device(batch,
                                                         ctx.eval_ctx),
                              batch)
                mask = c.data.to(torch.bool)
                if c.validity is not None:
                    mask = mask & c.validity  # null predicate drops the row
                return compact(batch, mask)

        for batch in self.children[0].execute_partition(idx, ctx):
            # the framework registers the batch inside its first attempt
            # and owns it
            gen = with_retry(batch, do_filter,
                             max_retries=ctx.conf.get(TASK_RETRY_LIMIT))
            del batch
            yield from gen


class TorchRangeExec(TorchExec):
    """``session.range`` on the device (reference ``TpuRangeExec``,
    GpuRangeExec): ``torch.arange`` in ``batch_rows``-row batches, the
    partitions split as ``CpuRangeExec``'s."""

    def __init__(self, start: int, end: int, step: int, num_partitions: int,
                 output: List[AttributeReference], batch_rows: int = 1 << 20):
        super().__init__([])
        self.start, self.end, self.step = start, end, step
        self._num_partitions = max(1, num_partitions)
        self._output = list(output)
        self.batch_rows = batch_rows

    @property
    def output(self):
        return self._output

    def num_partitions(self) -> int:
        return self._num_partitions

    def node_desc(self) -> str:
        return f"TorchRange({self.start}, {self.end}, step={self.step})"

    def internal_do_execute_columnar(self, idx: int,
                                     ctx: TaskContext) -> Iterator:
        from ..columnar.vector import TorchColumnVector, bucket_capacity
        from ..memory.semaphore import TorchSemaphore
        from ..types import LongT
        from .cpu import range_partition
        lo, cnt = range_partition(self.start, self.end, self.step,
                                  self._num_partitions, idx)
        names = [a.name for a in self._output]
        # the ids take device memory: admission first, as a scan's upload
        TorchSemaphore.get(ctx.conf).acquire_if_necessary(ctx)
        pos = 0
        while True:
            n = min(self.batch_rows, cnt - pos)
            with op_time(ctx, self):
                cap = bucket_capacity(max(n, 1))
                ids = (torch.arange(cap, dtype=torch.int64,
                                    device=ctx.device) + (lo + pos)) \
                    * self.step + self.start
            yield TorchColumnarBatch([TorchColumnVector(LongT, ids, None, n)],
                                     n, names)
            pos += max(n, 1)
            if pos >= cnt:
                return


class TorchUnionExec(TorchExec):
    """UNION ALL: partition i is the i-th partition of the children read in
    turn, each batch renamed to the union's columns (the logical union
    casts a child of another type below it, ``plan/logical.Union``)."""

    def __init__(self, children: Sequence[PhysicalPlan],
                 output: List[AttributeReference]):
        super().__init__(list(children))
        self._output = output

    @property
    def output(self):
        return self._output

    def num_partitions(self) -> int:
        return sum(c.num_partitions() for c in self.children)

    def internal_do_execute_columnar(self, idx: int,
                                     ctx: TaskContext) -> Iterator:
        names = [a.name for a in self._output]
        for c in self.children:
            n = c.num_partitions()
            if idx < n:
                for b in c.execute_partition(idx, ctx):
                    with op_time(ctx, self):
                        out = b.rename(names)
                    yield out
                return
            idx -= n


class TorchLocalLimitExec(TorchExec):
    """The first n rows of each partition."""

    def __init__(self, n: int, child: PhysicalPlan):
        super().__init__([child])
        self.n = n

    @property
    def output(self):
        return self.children[0].output

    def internal_do_execute_columnar(self, idx: int,
                                     ctx: TaskContext) -> Iterator:
        remaining = self.n
        for b in self.children[0].execute_partition(idx, ctx):
            if remaining <= 0:
                break
            if b.num_rows <= remaining:
                remaining -= b.num_rows
                yield b
            else:
                yield slice_batch(b, 0, remaining)
                remaining = 0


class TorchGlobalLimitExec(TorchExec):
    """Rows [offset, offset + n) of the partitions read in order."""

    def __init__(self, n: int, child: PhysicalPlan, offset: int = 0):
        super().__init__([child])
        self.n = n
        self.offset = offset

    @property
    def output(self):
        return self.children[0].output

    def num_partitions(self) -> int:
        return 1

    def internal_do_execute_columnar(self, idx: int,
                                     ctx: TaskContext) -> Iterator:
        got: List[TorchColumnarBatch] = []
        need = self.offset + self.n
        child = self.children[0]
        for p in range(child.num_partitions()):
            for b in child.execute_partition(p, ctx.for_partition(p)):
                got.append(b)
                if sum(x.num_rows for x in got) >= need:
                    break
        if got:
            out = slice_batch(concat_batches(got), self.offset, self.n)
            if out.num_rows:
                yield out
