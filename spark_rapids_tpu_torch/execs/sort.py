"""Device sort exec (port of ``spark_rapids_tpu/execs/sort.py``: the
in-core sort and ``TorchSortExec``; TopN waits with limit).

Algorithm: an order-preserving integer encoding per key, iterated stable
sorts (least-significant key first) and one gather. The reference ranks
string keys on the host with ``pyarrow``; the port sorts them by their
packed encoding (``aggregates.pack_string_keys``), which is lexicographic
for strings of up to 7 bytes and computed on the device. Past
``batchSizeRows`` rows a global sort goes out of core (execs/oocsort.py).
"""

from __future__ import annotations

from typing import Iterator, List

from ..columnar.batch import TorchColumnarBatch, concat_batches, gather
from ..columnar.vector import TorchColumnVector
from ..expressions.base import to_column
from ..plan.logical import SortOrder
from ..types import StringType
from .aggregates import (MAX_PACKED_KEY_BYTES, encode_group_keys,
                         lex_sort_permutation, string_key_overflow)
from .base import PhysicalPlan, TaskContext, TorchExec, bind_references


def encode_sort_keys(cols: List[TorchColumnVector], num_rows: int,
                     capacity: int):
    """(sortable int values, validity) per key; strings longer than the
    packed 7 bytes raise (one host check a string key)."""
    for c in cols:
        if isinstance(c.dtype, StringType) and bool(string_key_overflow(c)):
            raise NotImplementedError(
                f"string sort keys longer than {MAX_PACKED_KEY_BYTES} bytes "
                "not yet ported")
    return encode_group_keys(cols, num_rows, capacity)


def sort_permutation(batch: TorchColumnarBatch, order: List[SortOrder],
                     ctx: TaskContext):
    """(permutation over the capacity, encoded keys) of one batch."""
    key_cols = [to_column(o.child.eval_device(batch, ctx.eval_ctx), batch,
                          o.child.dtype) for o in order]
    enc = encode_sort_keys(key_cols, batch.num_rows, batch.capacity)
    perm = lex_sort_permutation(enc, batch.num_rows, batch.capacity,
                                [(o.ascending, o.nulls_first) for o in order])
    return perm, enc


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

    def internal_do_execute_columnar(self, idx: int,
                                     ctx: TaskContext) -> Iterator:
        child = self.children[0]
        if not self.global_sort:
            for b in child.execute_partition(idx, ctx):
                yield sort_batch(b, self.order, ctx)
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
            yield sort_batch(concat_batches(batches), self.order, ctx)
