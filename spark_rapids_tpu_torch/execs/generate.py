"""Expand, the grouping sets' row multiplexer (port of ``CpuExpandExec``
and ``TpuExpandExec`` from ``spark_rapids_tpu/execs/generate.py``; Generate
is not yet ported).

Each input batch gives one output batch a projection, each a projection
over the shared input with no row-replication buffer. The input is
spillable while the projections run, and each projection runs under
``memory/retry.with_retry``: an out-of-memory error retries after a spill
or splits the input, as a projection is row-wise.
"""

from __future__ import annotations

from typing import Iterator, List

from ..columnar.batch import TorchColumnarBatch
from ..expressions.base import AttributeReference, Expression, to_column
from .base import (PhysicalPlan, TaskContext, TorchExec, bind_all,
                   op_time)


class TorchExpandExec(TorchExec):
    def __init__(self, projections: List[List[Expression]],
                 child: PhysicalPlan, output: List[AttributeReference]):
        super().__init__([child])
        self.projections = [bind_all(p, child.output) for p in projections]
        self._output = output

    @property
    def output(self):
        return self._output

    def node_desc(self) -> str:
        return f"TorchExpand[{len(self.projections)} projections]"

    def internal_do_execute_columnar(self, idx: int,
                                     ctx: TaskContext) -> Iterator:
        from ..config import TASK_RETRY_LIMIT
        from ..memory.retry import with_retry
        from ..memory.spill import SpillableColumnarBatch
        names = [a.name for a in self._output]

        def project(b: TorchColumnarBatch, proj) -> TorchColumnarBatch:
            cols = [to_column(e.eval_device(b, ctx.eval_ctx), b, a.dtype)
                    for e, a in zip(proj, self._output)]
            return TorchColumnarBatch(cols, b.num_rows, names)

        for batch in self.children[0].execute_partition(idx, ctx):
            with SpillableColumnarBatch(batch) as spill:
                del batch  # the catalog holds the input from here on
                for proj in self.projections:
                    with op_time(ctx, self):
                        # each projection's own retryable handle over the
                        # shared input (the outer one keeps it spillable)
                        outs = list(with_retry(
                            SpillableColumnarBatch(spill.get_batch()),
                            lambda b, _p=proj: project(b, _p),
                            max_retries=ctx.conf.get(TASK_RETRY_LIMIT)))
                    yield from outs
