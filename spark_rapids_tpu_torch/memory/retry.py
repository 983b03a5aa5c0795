"""Retry framework: idempotent re-execution + input splitting under OOM.

Port of ``spark_rapids_tpu/memory/retry.py`` (reference analogue:
RmmRapidsRetryIterator withRetry / withRetryNoSplit). Any batch-level work
can be retried after a spill, or split in half when a single batch cannot
fit.

The input is a ``SpillableColumnarBatch``, or a batch the framework
registers itself inside the first attempt: an out-of-memory error while
the input registers (the budget's accounting of the batch) then heals like
one inside ``fn`` — a retry after a spill, or a split of the batch.

The framework owns its input: a caller drops its own reference once the
generator is made (``gen = with_retry(batch, fn); del batch``), and the
generator keeps none outside the catalog between attempts, nor of a
result it has yielded. A spill of the input then frees its device
memory, and bringing it back makes no second copy.

The device's own allocator raises ``torch.cuda.OutOfMemoryError``; the
retry arm takes it as a ``TorchRetryOOM``: it counts it, spills, empties
the caching allocator's free blocks and retries. When the same input hits
a real out-of-memory error again after such a retry, a retry alone cannot
fit it and the input splits in half (counted as a split), as a
``TorchSplitAndRetryOOM`` would. Past ``max_retries`` it raises; the work
never moves to the host.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional, TypeVar, Union

import torch

from ..columnar.batch import TorchColumnarBatch, slice_batch
from .hbm import TorchRetryOOM, TorchSplitAndRetryOOM
from .spill import SpillableColumnarBatch, TorchBufferCatalog

T = TypeVar("T")


class RetryStats:
    def __init__(self) -> None:
        self.retries = 0
        self.split_retries = 0
        self.device_ooms = 0


def split_in_half(spillable: SpillableColumnarBatch
                  ) -> List[SpillableColumnarBatch]:
    """Default split policy (reference splitSpillableInHalfByRows)."""
    batch = spillable.get_batch()
    n = batch.num_rows
    if n < 2:
        raise TorchSplitAndRetryOOM(
            "cannot split a batch of fewer than 2 rows")
    half = n // 2
    halves: List[SpillableColumnarBatch] = []
    try:
        halves.append(SpillableColumnarBatch(slice_batch(batch, 0, half)))
        halves.append(SpillableColumnarBatch(slice_batch(batch, half,
                                                         n - half)))
    except BaseException:
        # registering the second half can itself OOM mid-split: the first
        # half must not leak
        for s in halves:
            s.close()
        raise
    del batch
    spillable.close()
    return halves


def _release_device_cache() -> None:
    """After a real out-of-memory error only: hand the caching allocator's
    free blocks back so the retry sees the card's whole free memory."""
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _split_unregistered(batch: TorchColumnarBatch
                        ) -> List[TorchColumnarBatch]:
    n = batch.num_rows
    if n < 2:
        raise TorchSplitAndRetryOOM(
            "cannot split a batch of fewer than 2 rows")
    return [slice_batch(batch, 0, n // 2),
            slice_batch(batch, n // 2, n - n // 2)]


def with_retry(
    spillable: Union[SpillableColumnarBatch, TorchColumnarBatch],
    fn: Callable[[TorchColumnarBatch], T],
    split_policy: Optional[Callable[[SpillableColumnarBatch],
                                    List[SpillableColumnarBatch]]
    ] = split_in_half,
    max_retries: int = 8,
    stats: Optional[RetryStats] = None,
) -> Iterator[T]:
    """Run fn over the spillable input, retrying on TorchRetryOOM or a real
    torch.cuda.OutOfMemoryError (after letting the catalog spill) and
    splitting the input on TorchSplitAndRetryOOM, or on a second real
    out-of-memory error of the same input. fn MUST be idempotent w.r.t. the
    input batch (reference withRetry contract). Yields one result per
    (sub-)batch."""
    import time as _time

    from ..chaos import retry_scope
    from ..obs import metrics as _metrics
    from ..profiling import TaskMetricsRegistry
    reg = TaskMetricsRegistry.get()
    pending: List[SpillableColumnarBatch] = [spillable]
    del spillable  # the framework owns the input: `pending` is its holder
    attempts = 0
    device_oom_retried = False
    try:
        while pending:
            cur = pending[0]
            split = False
            try:
                # chaos scope: injected OOMs are healable exactly here
                with retry_scope(splittable=split_policy is not None
                                 and cur.num_rows >= 2):
                    if isinstance(cur, TorchColumnarBatch):
                        cur = pending[0] = SpillableColumnarBatch(cur)
                    batch = cur.get_batch()
                    out = [fn(batch)]
                batch = None
                pending.pop(0)
                cur.close()
                # yielded from the list: no frame of the generator holds
                # the result while the consumer works on it
                yield out.pop()
                attempts = 0
                device_oom_retried = False
                continue
            # every arm drops the failed attempt's batch and the
            # traceback, whose frames hold its tensors: the spill below
            # must be able to free them
            except TorchSplitAndRetryOOM as e:
                split, err = True, e.with_traceback(None)
            except TorchRetryOOM as e:
                err = e.with_traceback(None)
            except torch.cuda.OutOfMemoryError as e:
                err = e.with_traceback(None)
                if stats:
                    stats.device_ooms += 1
                _metrics.counter_inc("device.oom_caught")
                # a second real OOM of the same input: it cannot fit whole
                split = device_oom_retried and split_policy is not None \
                    and cur.num_rows >= 2
                device_oom_retried = True
                batch = None
                _release_device_cache()
            batch = None
            if split:
                if stats:
                    stats.split_retries += 1
                reg.add("splitAndRetryCount", 1)
                if split_policy is None:
                    raise err
                halves = _split_unregistered(cur) \
                    if isinstance(cur, TorchColumnarBatch) \
                    else split_policy(cur)
                pending = halves + pending[1:]
                device_oom_retried = False
                continue
            if stats:
                stats.retries += 1
            reg.add("retryCount", 1)
            attempts += 1
            if attempts > max_retries:
                raise err
            # let pressure drain: spill what the catalog holds, then retry
            t0 = _time.perf_counter_ns()
            TorchBufferCatalog.get().synchronous_spill(
                cur.device_memory_size()
                if isinstance(cur, TorchColumnarBatch) else cur.size_bytes)
            reg.add("retryBlockTimeNs", _time.perf_counter_ns() - t0)
    finally:
        # fn may raise and a consumer may abandon the generator: never leak
        # the remaining spillables
        for s in pending:
            if isinstance(s, SpillableColumnarBatch):
                s.close()


def with_retry_no_split(spillable: Union[SpillableColumnarBatch,
                                         TorchColumnarBatch],
                        fn: Callable[[TorchColumnarBatch], T],
                        max_retries: int = 8,
                        stats: Optional[RetryStats] = None) -> T:
    """Retry without splitting (reference withRetryNoSplit). Like
    ``with_retry`` it owns its input: pass it as a temporary, or drop your
    reference before the call."""
    gen = with_retry(spillable, fn, split_policy=None,
                     max_retries=max_retries, stats=stats)
    del spillable
    results = list(gen)
    assert len(results) == 1
    return results[0]
