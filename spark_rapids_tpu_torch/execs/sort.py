"""Device sort execs (port of ``spark_rapids_tpu/execs/sort.py``: the
in-core sort, ``TorchSortExec`` and ``TorchTopNExec``).

Algorithm: an order-preserving integer encoding per key, iterated stable
sorts (least-significant key first) and one gather. The reference ranks
string keys on the host with ``pyarrow``; the port sorts them by their
key codes (``expressions.strings.string_key_codes``: UTF-8 byte order,
any length), computed on the device. Past
``batchSizeRows`` rows a global sort goes out of core (execs/oocsort.py).
"""

from __future__ import annotations

from typing import Iterator, List

from ..columnar.batch import (TorchColumnarBatch, concat_batches, gather,
                             slice_batch)
from ..expressions.base import to_column
from ..plan.logical import SortOrder
from .aggregates import encode_group_keys, lex_sort_permutation
from .base import (MODERATE, PhysicalPlan, TaskContext, TorchExec,
                   bind_references)


def sort_permutation(batch: TorchColumnarBatch, order: List[SortOrder],
                     ctx: TaskContext):
    """(permutation over the capacity, key columns) of one batch."""
    key_cols = [to_column(o.child.eval_device(batch, ctx.eval_ctx), batch,
                          o.child.dtype) for o in order]
    enc = encode_group_keys(key_cols, batch.num_rows, batch.capacity)
    perm = lex_sort_permutation(enc, batch.num_rows, batch.capacity,
                                [(o.ascending, o.nulls_first) for o in order])
    return perm, key_cols


def sort_batch(batch: TorchColumnarBatch, order: List[SortOrder],
               ctx: TaskContext) -> TorchColumnarBatch:
    perm, _ = sort_permutation(batch, order, ctx)
    return gather(batch, perm, batch.num_rows, out_capacity=batch.capacity)


class TorchSortExec(TorchExec):
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

    def node_desc(self) -> str:
        return f"TorchSort[{', '.join(o.pretty() for o in self.order)}]"

    def additional_metrics(self):
        return {"sortTime": MODERATE}

    def internal_do_execute_columnar(self, idx: int,
                                     ctx: TaskContext) -> Iterator:
        child = self.children[0]
        sort_time = self.metrics["sortTime"]
        if not self.global_sort:
            for b in child.execute_partition(idx, ctx):
                with sort_time.timed():
                    out = sort_batch(b, self.order, ctx)
                yield out
            return
        max_rows = ctx.conf.batch_size_rows
        batches: List[TorchColumnarBatch] = []
        total = 0
        ooc = None
        try:
            for p in range(child.num_partitions()):
                for b in child.execute_partition(p, ctx.for_partition(p)):
                    total += b.num_rows
                    if ooc is not None:
                        ooc.add_batch(b)
                        continue
                    batches.append(b)
                    if total > max_rows:
                        # past one batch: the out-of-core sort
                        from .oocsort import OutOfCoreSorter
                        ooc = OutOfCoreSorter(self.order, ctx)
                        for queued in batches:
                            ooc.add_batch(queued)
                        batches = []
            if ooc is not None:
                yield from ooc.iter_sorted(max_rows)
                return
        finally:
            if ooc is not None:
                ooc.close()
        if batches:
            with sort_time.timed():
                out = sort_batch(concat_batches(batches), self.order, ctx)
            yield out


class TorchTopNExec(TorchExec):
    """ORDER BY ... LIMIT n: a running top-n a partition (sort the running
    rows with the next batch, keep offset + n), then one merge of the
    partitions' tops (reference TpuTopNExec, Spark's
    TakeOrderedAndProject)."""

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
        keys = ", ".join(o.pretty() for o in self.order)
        return f"TorchTopN[n={self.n}, {keys}]"

    def additional_metrics(self):
        return {"sortTime": MODERATE}

    def _topn_of_partition(self, p: int, ctx: TaskContext, keep: int):
        running = None
        for b in self.children[0].execute_partition(p, ctx.for_partition(p)):
            with self.metrics["sortTime"].timed():
                cand = b if running is None else concat_batches([running, b])
                s = sort_batch(cand, self.order, ctx)
                running = slice_batch(s, 0, min(keep, s.num_rows))
        return running

    def internal_do_execute_columnar(self, idx: int,
                                     ctx: TaskContext) -> Iterator:
        keep = self.offset + self.n
        tops = [t for t in (self._topn_of_partition(p, ctx, keep)
                            for p in range(self.children[0].num_partitions()))
                if t is not None]
        if not tops:
            return
        with self.metrics["sortTime"].timed():
            s = sort_batch(concat_batches(tops), self.order, ctx)
            out = slice_batch(s, self.offset, self.n)
        if out.num_rows:
            yield out
