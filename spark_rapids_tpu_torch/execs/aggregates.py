"""Aggregate plan node and result-expression helpers (port of
``split_result_exprs``, ``_bind_agg_refs`` and the ``TpuHashAggregateExec``
plan node of ``spark_rapids_tpu/execs/aggregates.py``).

The general sort-based aggregate is not yet ported: an aggregate that the
compiled stage (execs/compiled.py) does not take raises when executed.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

from ..expressions.aggregates import AggregateFunction
from ..expressions.base import AttributeReference, Expression
from .base import PhysicalPlan, TaskContext, TorchExec, bind_all, bind_references


def split_result_exprs(aggregates: Sequence[Expression]):
    """Split each output expression into its AggregateFunction leaves + a
    result projection over them (leaf i becomes ``__agg_i``, expr_id
    -(i+1))."""
    agg_fns: List[AggregateFunction] = []
    result_exprs: List[Expression] = []
    for e in aggregates:
        def rule(x: Expression):
            if isinstance(x, AggregateFunction):
                for i, existing in enumerate(agg_fns):
                    if existing is x:
                        idx = i
                        break
                else:
                    agg_fns.append(x)
                    idx = len(agg_fns) - 1
                return AttributeReference(f"__agg_{idx}", x.dtype, x.nullable,
                                          expr_id=-(idx + 1))
            return None
        result_exprs.append(e.transform(rule))
    return agg_fns, result_exprs


def _bind_agg_refs(expr: Expression, num_keys: int,
                   grouping: Sequence[Expression] = ()) -> Expression:
    """Rewrite ``__agg_i`` refs to ordinals in the aggregated table (keys
    first); references to grouping attributes rebind to their key slot."""
    key_slot = {g.expr_id: j for j, g in enumerate(grouping)
                if isinstance(g, AttributeReference)}

    def rule(e: Expression):
        if isinstance(e, AttributeReference) and e.expr_id < 0:
            i = -e.expr_id - 1
            return AttributeReference(e.name, e.dtype, e.nullable,
                                      ordinal=num_keys + i, expr_id=e.expr_id)
        if isinstance(e, AttributeReference) and e.expr_id in key_slot:
            return AttributeReference(e.name, e.dtype, e.nullable,
                                      ordinal=key_slot[e.expr_id],
                                      expr_id=e.expr_id)
        return None

    return expr.transform(rule)


class TorchHashAggregateExec(TorchExec):
    """Grouped aggregation plan node (complete mode). The compiled stage
    replaces it where eligible; executing it directly raises."""

    def __init__(self, grouping: Sequence[Expression],
                 aggregates: Sequence[Expression], child: PhysicalPlan,
                 output: List[AttributeReference]):
        super().__init__([child])
        self.grouping = bind_all(list(grouping), child.output)
        self.aggregates = [bind_references(a, child.output)
                           for a in aggregates]
        self._output = output

    @property
    def output(self):
        return self._output

    def num_partitions(self) -> int:
        return 1

    def node_desc(self) -> str:
        return f"TorchHashAggregate[keys={len(self.grouping)}]"

    def internal_do_execute_columnar(self, idx: int,
                                     ctx: TaskContext) -> Iterator:
        raise NotImplementedError(
            "general aggregate not yet ported: only aggregations the "
            "compiled stage accepts run on the port")
