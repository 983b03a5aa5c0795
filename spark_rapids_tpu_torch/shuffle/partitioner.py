"""Hash partitioning of device batches (port of ``hash_partition_ids``,
``_split_plan`` and ``split_by_partition`` from
``spark_rapids_tpu/shuffle/partitioner.py``).

Spark's HashPartitioning: pid = pmod(murmur3(keys, 42), n). A batch splits
by a stable sort on the pid (rows keep their input order within a
partition), one host read of the n+1 partition bounds, and one gather a
partition.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..columnar.batch import TorchColumnarBatch, gather
from ..columnar.vector import bucket_capacity
from ..expressions.base import Expression, to_column
from ..expressions.hashexprs import murmur3_batch


def hash_partition_ids(batch: TorchColumnarBatch,
                       key_exprs: Sequence[Expression], n: int, ctx,
                       seed: int = 42) -> torch.Tensor:
    """int32 partition id of every row slot (padding rows included)."""
    cols = [to_column(k.eval_device(batch, ctx.eval_ctx), batch, k.dtype)
            for k in key_exprs]
    h = murmur3_batch(cols, batch.capacity, seed)
    return torch.remainder(h, n).to(torch.int32)  # floor mod: pmod


def _split_plan(pids: torch.Tensor, num_rows: int, n: int):
    """(row order: a stable sort by pid with padding last, the n+1
    partition bounds in that order)."""
    cap = pids.shape[0]
    live = torch.arange(cap, device=pids.device) < num_rows
    key = torch.where(live, pids, n)
    order = torch.argsort(key, stable=True)
    bounds = torch.searchsorted(key[order], torch.arange(
        n + 1, dtype=key.dtype, device=pids.device))
    return order, bounds


def split_by_partition(batch: TorchColumnarBatch, pids: torch.Tensor,
                       n: int) -> List[Optional[TorchColumnarBatch]]:
    """The batch's rows of each partition, in input order (None for an
    empty partition); the bounds are the one host read."""
    order, bounds_dev = _split_plan(pids, batch.num_rows, n)
    bounds = bounds_dev.tolist()
    cap = batch.capacity
    out: List[Optional[TorchColumnarBatch]] = []
    for p in range(n):
        lo, cnt = bounds[p], bounds[p + 1] - bounds[p]
        if cnt == 0:
            out.append(None)
            continue
        out_cap = bucket_capacity(cnt)
        idx = order[(torch.arange(out_cap, device=order.device) + lo)
                    .clamp(max=cap - 1)]
        out.append(gather(batch, idx, cnt, out_cap))
    return out


def hash_split_parts(batch: TorchColumnarBatch,
                     key_exprs: Sequence[Expression], n: int, ctx,
                     seed: int = 42) -> List[Optional[TorchColumnarBatch]]:
    return split_by_partition(
        batch, hash_partition_ids(batch, key_exprs, n, ctx, seed), n)
