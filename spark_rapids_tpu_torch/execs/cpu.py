"""CPU physical operators: what the planner emits, what the override
engine retargets, and the host engine that runs an operator the override
engine keeps off the card (port of ``spark_rapids_tpu/execs/cpu.py``).

Host batches are ``TorchColumnarBatch`` on the CPU, as everywhere in the
port: scans, transitions and the spill catalog see no other kind. A CPU
operator evaluates over pyarrow, as the reference's do: it turns each
input batch into a ``pa.Table`` once (``TorchColumnarBatch.to_arrow``),
evaluates its expressions through their ``eval_cpu``, and turns its
output back once (``host_batch``). ``CpuLocalTableScanExec`` slices the
host table into partitions and ``batchSizeRows`` batches;
``CpuCachedScanExec`` decodes a ``df.cache()``d relation a batch at a
time; ``CpuRangeExec`` makes ``session.range``'s ids;
``CpuFileScanExec`` (``io/parquet.py``) reads files on the host.

The host engine is chosen only at planning: a ``Cpu*`` node is left in a
plan where the override engine tagged it off the card, with the reason
``explain_fallback()`` prints, and transitions at its edges. No device
operator gives way to one at run time. Each CPU operator's own work is
timed into its ``opTime`` metric and the session's counters as
``opTime.<operator>`` (one host-clock reading), and it counts its output
(``numOutputRows``, ``numOutputBatches``).
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np

from ..columnar.batch import TorchColumnarBatch
from ..expressions.base import AttributeReference, Expression, arrow_column
from ..plan.logical import SortOrder
from .base import (CpuExec, PhysicalPlan, TaskContext, bind_all,
                   bind_references, counts_output, op_time)


def host_batch(columns, attrs: Sequence[AttributeReference],
               num_rows: int) -> TorchColumnarBatch:
    """Host results (Arrow arrays or constants) as a host batch of
    ``attrs``' names and types: the one conversion back a CPU operator
    makes."""
    import pyarrow as pa
    names = [a.name for a in attrs]
    if not attrs:
        return TorchColumnarBatch([], num_rows, [])
    arrays = [arrow_column(c, num_rows, a.dtype)
              for c, a in zip(columns, attrs)]
    return TorchColumnarBatch.from_arrow(
        pa.Table.from_arrays(arrays, names=names))


def table_batch(table, attrs: Sequence[AttributeReference]
                ) -> TorchColumnarBatch:
    """A whole Arrow table as a host batch of ``attrs``."""
    return host_batch(table.columns, attrs, table.num_rows)


def child_tables(child: PhysicalPlan, ctx: TaskContext,
                 idx=None) -> Iterator:
    """The child's batches as Arrow tables: partition ``idx``, or every
    partition in turn when ``idx`` is None; each child partition runs in
    its own task context, so its expressions see its partition id."""
    parts = range(child.num_partitions()) if idx is None else (idx,)
    for p in parts:
        pctx = ctx if p == ctx.partition_id else ctx.for_partition(p)
        for b in child.execute_partition(p, pctx):
            yield b.to_arrow()


def concat_child(child: PhysicalPlan, ctx: TaskContext, idx=None,
                 prefix: str = ""):
    """One Arrow table of the child's rows (partition ``idx`` or all),
    its columns named ``prefix`` + ordinal when ``prefix`` is given (both
    sides of a join may share names; expressions bind by ordinal)."""
    import pyarrow as pa
    from ..types import to_arrow
    names = [f"{prefix}{i}" if prefix else a.name
             for i, a in enumerate(child.output)]
    tables = [t.rename_columns(names)
              for t in child_tables(child, ctx, idx)]
    if tables:
        return pa.concat_tables(tables)
    return pa.schema([(n, to_arrow(a.dtype))
                      for n, a in zip(names, child.output)]).empty_table()


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


def range_partition(start: int, end: int, step: int, n_parts: int,
                    idx: int):
    """(first id index, id count) of partition ``idx`` of a range: the ids
    split into ``n_parts`` runs of nearly equal length, as Spark's."""
    total = max(0, -(-(end - start) // step))
    base = total // n_parts
    return (idx * base + min(idx, total % n_parts),
            base + (1 if idx < total % n_parts else 0))


class CpuRangeExec(CpuExec):
    """``session.range`` on the host: one batch of ids a partition
    (reference ``CpuRangeExec``)."""

    def __init__(self, start: int, end: int, step: int, num_partitions: int,
                 output: List[AttributeReference]):
        super().__init__([])
        self.start, self.end, self.step = start, end, step
        self._num_partitions = max(1, num_partitions)
        self._output = list(output)

    @property
    def output(self) -> List[AttributeReference]:
        return self._output

    def num_partitions(self) -> int:
        return self._num_partitions

    def node_desc(self) -> str:
        return f"CpuRange({self.start}, {self.end}, step={self.step})"

    @counts_output
    def execute_partition(self, idx: int, ctx: TaskContext) -> Iterator:
        from ..columnar.vector import TorchColumnVector
        from ..types import LongT
        lo, cnt = range_partition(self.start, self.end, self.step,
                                  self._num_partitions, idx)
        with op_time(ctx, self):
            vals = self.start + (lo + np.arange(cnt, dtype=np.int64)) \
                * self.step
            out = TorchColumnarBatch(
                [TorchColumnVector.from_numpy(LongT, vals, None,
                                              capacity=cnt, bucket=False)],
                cnt, [a.name for a in self._output])
        yield out


class CpuCachedScanExec(CpuExec):
    """Scan of a ``df.cache()``d relation (``io/cache.CachedRelation``):
    each parquet-compressed batch decodes on its own (reference: the read
    side of ParquetCachedBatchSerializer). A host source like the local
    table scan; a transition uploads its output."""

    def __init__(self, relation, output: List[AttributeReference]):
        super().__init__([])
        self.relation = relation
        self._output = list(output)

    @property
    def output(self) -> List[AttributeReference]:
        return self._output

    def num_partitions(self) -> int:
        return 1

    def node_desc(self) -> str:
        return f"CpuCachedScan[{self.relation.node_desc()}]"

    @counts_output
    def execute_partition(self, idx: int, ctx: TaskContext) -> Iterator:
        for t in self.relation.iter_tables():
            if t.num_rows:
                with op_time(ctx, self):
                    out = table_batch(t, self._output)
                yield out


class CpuProjectExec(CpuExec):
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

    @counts_output
    def execute_partition(self, idx: int, ctx: TaskContext) -> Iterator:
        for t in child_tables(self.children[0], ctx, idx):
            with op_time(ctx, self):
                out = host_batch([e.eval_cpu(t, ctx.eval_ctx)
                                  for e in self.exprs], self._output,
                                 t.num_rows)
            yield out


class CpuFilterExec(CpuExec):
    def __init__(self, condition: Expression, child: PhysicalPlan):
        super().__init__([child])
        self.condition = bind_references(condition, child.output)

    @property
    def output(self):
        return self.children[0].output

    def node_desc(self) -> str:
        return f"CpuFilter[{self.condition.pretty()}]"

    @counts_output
    def execute_partition(self, idx: int, ctx: TaskContext) -> Iterator:
        import pyarrow.compute as pc
        from ..types import BooleanT
        for t in child_tables(self.children[0], ctx, idx):
            with op_time(ctx, self):
                mask = arrow_column(self.condition.eval_cpu(t, ctx.eval_ctx),
                                    t.num_rows, BooleanT)
                out = table_batch(t.filter(pc.fill_null(mask, False)),
                                  self.output)
            yield out


def sort_indices(table, order: List[SortOrder], ctx: TaskContext):
    """Spark's sort order of an Arrow table's rows (reference
    ``sort_table``): each key's nulls first or last as it asks, NaN above
    every number in either direction, ties in input order (a trailing
    row-index key). Strings order by their UTF-8 bytes, as on the card."""
    import pyarrow as pa
    import pyarrow.compute as pc
    cols, keys = {}, []
    for i, o in enumerate(order):
        arr = arrow_column(o.child.eval_cpu(table, ctx.eval_ctx),
                           table.num_rows, o.child.dtype)
        is_null = pc.is_null(arr)
        # flag levels: nulls first (0) < NaN descending (1) < values (2)
        # < NaN ascending (3) < nulls last (4)
        flag = pc.if_else(is_null,
                          pa.scalar(0 if o.nulls_first else 4, pa.int8()),
                          pa.scalar(2, pa.int8()))
        if pa.types.is_floating(arr.type):
            is_nan = pc.and_(pc.is_nan(pc.fill_null(arr, 0.0)),
                             pc.invert(is_null))
            flag = pc.if_else(is_nan,
                              pa.scalar(3 if o.ascending else 1, pa.int8()),
                              flag)
            arr = pc.if_else(is_nan, pa.scalar(0.0, arr.type), arr)
        cols[f"f{i}"], cols[f"v{i}"] = flag, arr
        keys += [(f"f{i}", "ascending"),
                 (f"v{i}", "ascending" if o.ascending else "descending")]
    cols["row"] = pa.array(np.arange(table.num_rows, dtype=np.int64))
    keys.append(("row", "ascending"))
    key_table = pa.table(cols)
    try:  # pyarrow >= 25 takes a null placement a key
        return pc.sort_indices(key_table,
                               sort_keys=[(k, d, "at_end") for k, d in keys])
    except (ValueError, TypeError):
        return pc.sort_indices(key_table, sort_keys=keys,
                               null_placement="at_end")


def sort_table(table, order: List[SortOrder], ctx: TaskContext):
    return table.take(sort_indices(table, order, ctx))


class CpuSortExec(CpuExec):
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

    @counts_output
    def execute_partition(self, idx: int, ctx: TaskContext) -> Iterator:
        t = concat_child(self.children[0], ctx,
                         None if self.global_sort else idx)
        if t.num_rows == 0:
            return
        with op_time(ctx, self):
            out = table_batch(sort_table(t, self.order, ctx), self.output)
        yield out


class CpuLocalLimitExec(CpuExec):
    def __init__(self, n: int, child: PhysicalPlan):
        super().__init__([child])
        self.n = n

    @property
    def output(self):
        return self.children[0].output

    @counts_output
    def execute_partition(self, idx: int, ctx: TaskContext) -> Iterator:
        remaining = self.n
        for b in self.children[0].execute_partition(idx, ctx):
            if remaining <= 0:
                break
            out = b.slice(0, remaining)
            remaining -= out.num_rows
            yield out


class CpuGlobalLimitExec(CpuExec):
    """The first ``n`` rows after ``offset`` over every partition in turn
    (one output partition)."""

    def __init__(self, n: int, child: PhysicalPlan, offset: int = 0):
        super().__init__([child])
        self.n = n
        self.offset = offset

    @property
    def output(self):
        return self.children[0].output

    def num_partitions(self) -> int:
        return 1

    @counts_output
    def execute_partition(self, idx: int, ctx: TaskContext) -> Iterator:
        t = concat_child(self.children[0], ctx)
        with op_time(ctx, self):
            out = table_batch(t.slice(self.offset, self.n), self.output)
        yield out


class CpuTopNExec(CpuExec):
    """ORDER BY ... LIMIT n as one operator (Spark TakeOrderedAndProject):
    a top-n a partition, then one merge."""

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

    @counts_output
    def execute_partition(self, idx: int, ctx: TaskContext) -> Iterator:
        import pyarrow as pa
        keep = self.offset + self.n
        tops = []
        child = self.children[0]
        for p in range(child.num_partitions()):
            running = None
            for t in child_tables(child, ctx, p):
                with op_time(ctx, self):
                    cand = t if running is None else \
                        pa.concat_tables([running, t])
                    running = sort_table(cand, self.order, ctx).slice(0, keep)
            if running is not None:
                tops.append(running)
        if not tops:
            return
        with op_time(ctx, self):
            whole = sort_table(pa.concat_tables(tops), self.order, ctx)
            out = table_batch(whole.slice(self.offset, self.n), self.output)
        if out.num_rows:
            yield out


class CpuUnionExec(CpuExec):
    """UNION ALL: the children's partitions in turn, renamed to the union's
    columns (the logical union casts a child of another type below it)."""

    def __init__(self, children: Sequence[PhysicalPlan],
                 output: List[AttributeReference]):
        super().__init__(list(children))
        self._output = output

    @property
    def output(self):
        return self._output

    def num_partitions(self) -> int:
        return sum(c.num_partitions() for c in self.children)

    @counts_output
    def execute_partition(self, idx: int, ctx: TaskContext) -> Iterator:
        names = [a.name for a in self._output]
        for c in self.children:
            n = c.num_partitions()
            if idx < n:
                for b in c.execute_partition(idx, ctx):
                    yield b.rename(names)
                return
            idx -= n


class CpuExpandExec(CpuExec):
    """Grouping sets' row multiplexer on the host (reference
    ``CpuExpandExec``): each input batch once a projection."""

    def __init__(self, projections: List[List[Expression]],
                 child: PhysicalPlan, output: List[AttributeReference]):
        super().__init__([child])
        self.projections = [bind_all(p, child.output) for p in projections]
        self._output = output

    @property
    def output(self):
        return self._output

    def node_desc(self) -> str:
        return f"CpuExpand[{len(self.projections)} projections]"

    @counts_output
    def execute_partition(self, idx: int, ctx: TaskContext) -> Iterator:
        for t in child_tables(self.children[0], ctx, idx):
            for proj in self.projections:
                with op_time(ctx, self):
                    out = host_batch([e.eval_cpu(t, ctx.eval_ctx)
                                      for e in proj], self._output,
                                     t.num_rows)
                yield out


class CpuWindowExec(CpuExec):
    """Window functions on the host (the reference's per-partition loop,
    ``execs/window.cpu_window_column``): every input partition in one
    table, one output batch."""

    def __init__(self, window_exprs, child: PhysicalPlan,
                 output: List[AttributeReference]):
        from .window import bind_window_expr
        super().__init__([child])
        self.window_exprs = [bind_window_expr(w, child.output)
                             for w in window_exprs]
        self._output = output

    @property
    def output(self):
        return self._output

    def num_partitions(self) -> int:
        return 1

    @counts_output
    def execute_partition(self, idx: int, ctx: TaskContext) -> Iterator:
        from .window import cpu_window_column
        t = concat_child(self.children[0], ctx)
        if t.num_rows == 0:
            return
        with op_time(ctx, self):
            n_in = t.num_columns
            cols = list(t.columns) + [
                cpu_window_column(we, t, ctx, attr)
                for we, attr in zip(self.window_exprs, self._output[n_in:])]
            out = host_batch(cols, self._output, t.num_rows)
        yield out
