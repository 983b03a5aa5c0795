"""Project and filter operators on torch batches (port of TpuProjectExec
and TpuFilterExec from ``spark_rapids_tpu/execs/basic.py``). Expressions
evaluate eagerly; the reference's per-operator jit cache and spill/retry
wrappers are not yet ported."""

from __future__ import annotations

from typing import Iterator, List, Sequence

import torch

from ..columnar.batch import TorchColumnarBatch, compact
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
        names = [a.name for a in self._output]
        for batch in self.children[0].execute_partition(idx, ctx):
            cols = [to_column(e.eval_device(batch, ctx.eval_ctx), batch,
                              a.dtype)
                    for e, a in zip(self.exprs, self._output)]
            yield TorchColumnarBatch(cols, batch.num_rows, names)


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
        for batch in self.children[0].execute_partition(idx, ctx):
            c = to_column(self.condition.eval_device(batch, ctx.eval_ctx),
                          batch)
            mask = c.data.to(torch.bool)
            if c.validity is not None:
                mask = mask & c.validity  # null predicate drops the row
            yield compact(batch, mask)
