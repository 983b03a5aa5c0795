"""Project, filter and limit operators on torch batches (port of
TpuProjectExec, TpuFilterExec, TpuLocalLimitExec and TpuGlobalLimitExec
from ``spark_rapids_tpu/execs/basic.py``). Expressions
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
from .base import PhysicalPlan, TaskContext, TorchExec, bind_all, bind_references


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
            c = to_column(self.condition.eval_device(batch, ctx.eval_ctx),
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
