"""The exchange (port of ``TpuShuffleExchangeExec``,
``CpuShuffleExchangeExec`` and ``plan_cpu_exchange`` from
``spark_rapids_tpu/shuffle/exchange.py``: hash, round-robin, coalesce and
single partitioning, the device-resident ``ICI`` shuffle mode).

Materialization runs once per exchange instance: every map partition of
the child is split on the device (``partitioner.py``: by murmur3 of the
keys; round robin from the map id for ``roundrobin`` and ``coalesce``,
which the reference plans as a round-robin exchange; everything to
partition 0 for ``single``) and each
(map, reduce) block is registered in the ``ShuffleCatalog`` as a
``SpillableColumnarBatch`` at the shuffle-output spill priority, so under
budget pressure blocks spill to the host and to disk and come back when a
reduce partition reads them (reference ``IciShuffleCatalog``). A reduce
partition reads its blocks in map order, so it holds the reference's rows
in the reference's order. Each map task runs under its own task context
and a permit of the device semaphore (reference exchange.py:243), with a
cancel checkpoint before it; a nested exchange's map tasks run on the same
thread and ride that permit (``memory/semaphore.py``). Each map task and
each reduce partition's read is a chaos site (``pipeline.task``,
``ici.fetch``) under ``failure.with_device_retry``, as in the reference:
both are idempotent, so a transient device error re-runs them. The
executor removes an exchange's blocks when its query ends
(``cleanup_shuffle``).

Not yet ported: ``range`` partitioning (A8), the ``MULTITHREADED`` mode
(host-serialized shuffle files; it returns the same rows), the AQE
readers, the collective mesh plane, heartbeats and lost peers.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..columnar.batch import TorchColumnarBatch, concat_batches
from ..expressions.base import Expression
from ..execs.base import (MODERATE, CpuExec, PhysicalPlan, TaskContext,
                          TorchExec, bind_all, counts_output)
from ..obs import tracer as obs
from .partitioner import (hash_split_parts, round_robin_partition_ids,
                          split_by_partition)

#: the partitionings the port's exchanges take
PARTITIONINGS = ("hash", "roundrobin", "coalesce", "single")


class ShuffleCatalog:
    """Single-process shuffle blocks keyed by (shuffle id, map id, reduce
    id), each a ``SpillableColumnarBatch`` (reference
    ``IciShuffleCatalog``, without heartbeats, lost peers or chaos)."""

    _instance: Optional["ShuffleCatalog"] = None
    _cls_lock = threading.Lock()

    def __init__(self):
        self._next_id = 0
        self._blocks: Dict[Tuple[int, int, int], object] = {}
        self._maps: Dict[int, set] = {}
        self._mu = threading.Lock()

    @classmethod
    def get(cls) -> "ShuffleCatalog":
        with cls._cls_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    @classmethod
    def shutdown_instance(cls) -> None:
        """Release every block and drop the singleton (the last session's
        stop(), process exit); a later query makes a new one."""
        with cls._cls_lock:
            inst, cls._instance = cls._instance, None
        if inst is not None:
            for sid in list(inst._maps):
                inst.remove_shuffle(sid)

    def new_shuffle_id(self) -> int:
        with self._mu:
            self._next_id += 1
            self._maps[self._next_id] = set()
            return self._next_id

    def put_block(self, sid: int, map_id: int, reduce_id: int,
                  batch: TorchColumnarBatch) -> None:
        from ..memory.spill import (OUTPUT_FOR_SHUFFLE_PRIORITY,
                                    SpillableColumnarBatch)
        sb = SpillableColumnarBatch(batch, OUTPUT_FOR_SHUFFLE_PRIORITY)
        with self._mu:
            old = self._blocks.pop((sid, map_id, reduce_id), None)
            self._blocks[(sid, map_id, reduce_id)] = sb
        if old is not None:
            old.close()

    def mark_map_complete(self, sid: int, map_id: int) -> None:
        with self._mu:
            self._maps[sid].add(map_id)

    def blocks(self, sid: int, reduce_id: int, n_maps: int) -> Iterator:
        """A reduce partition's blocks in map order, each brought back to
        the device as it is read."""
        with self._mu:
            missing = set(range(n_maps)) - self._maps.get(sid, set())
            if missing:
                raise RuntimeError(f"shuffle {sid}: maps {sorted(missing)} "
                                   "have no output")
            held = [self._blocks[k] for k in
                    ((sid, m, reduce_id) for m in range(n_maps))
                    if k in self._blocks]
        for sb in held:
            yield sb.get_batch()

    def remove_shuffle(self, sid: int) -> None:
        with self._mu:
            doomed = [self._blocks.pop(k) for k in
                      [k for k in self._blocks if k[0] == sid]]
            self._maps.pop(sid, None)
        for sb in doomed:
            sb.close()

    def num_blocks(self) -> int:
        with self._mu:
            return len(self._blocks)


def _check_mode(conf) -> None:
    from ..config import SHUFFLE_MODE
    mode = str(conf.get(SHUFFLE_MODE)).upper()
    if mode != "ICI":
        raise NotImplementedError(
            f"shuffle mode {mode} not yet ported (spark.rapids.shuffle.mode"
            "=ICI keeps the blocks on the device)")


class _ExchangeBase:
    def _init_exchange(self, partitioning: str, keys, num_partitions: int):
        if partitioning not in PARTITIONINGS:
            raise NotImplementedError(
                f"{partitioning} partitioning not yet ported (A8)")
        self.partitioning = partitioning
        self.keys = keys
        self._n_out = num_partitions

    def num_partitions(self) -> int:
        return self._n_out


class TorchShuffleExchangeExec(_ExchangeBase, TorchExec):
    """The exchange on the device (hash, round robin, single)."""

    def __init__(self, child: PhysicalPlan, partitioning: str,
                 keys: Sequence[Expression], num_partitions: int):
        TorchExec.__init__(self, [child])
        self._init_exchange(partitioning, bind_all(list(keys), child.output),
                            num_partitions)
        self._shuffle_id: Optional[int] = None
        self._n_maps = 0

    @property
    def output(self):
        return self.children[0].output

    def node_desc(self) -> str:
        return f"TorchShuffleExchange[{self.partitioning}, n={self._n_out}]"

    def additional_metrics(self):
        return {"partitionTime": MODERATE, "deserializationTime": MODERATE}

    def _ensure_materialized(self, ctx: TaskContext) -> None:
        if self._shuffle_id is not None:
            return
        from ..chaos import inject
        from ..failure import with_device_retry
        from ..profiling import sync_scope
        from ..serving.query_context import checkpoint
        _check_mode(ctx.conf)
        catalog = ShuffleCatalog.get()
        sid = catalog.new_shuffle_id()
        child = self.children[0]
        try:
            with obs.span(f"exchange s{sid} materialize", cat="shuffle",
                          shuffle=sid):
                for map_id in range(child.num_partitions()):
                    # one map task under the chaos site and the transient
                    # device-error retry (reference exchange.py:130-137):
                    # a map task is idempotent, as put_block replaces its
                    # blocks
                    def attempt(map_id=map_id) -> None:
                        checkpoint(f"shuffle.map s{sid}m{map_id}")
                        inject("pipeline.task", detail=f"s{sid}m{map_id}")
                        self._materialize_map(sid, map_id, ctx, catalog)

                    with sync_scope(self.node_name()), \
                            obs.span(f"map s{sid}m{map_id}",
                                     cat="shuffle.map", shuffle=sid,
                                     map=map_id):
                        with_device_retry(attempt, ctx.conf)
        except BaseException:
            catalog.remove_shuffle(sid)  # no half-written shuffle remains
            raise
        self._n_maps = child.num_partitions()
        self._shuffle_id = sid

    def _materialize_map(self, sid: int, map_id: int, ctx: TaskContext,
                         catalog: "ShuffleCatalog") -> None:
        from ..memory.semaphore import TorchSemaphore
        n = self._n_out
        map_ctx = ctx.for_partition(map_id)
        try:
            TorchSemaphore.get(ctx.conf).acquire_if_necessary(map_ctx)
            acc: List[List[TorchColumnarBatch]] = [[] for _ in range(n)]
            split_time = self.metrics["partitionTime"]
            for batch in self.children[0].execute_partition(map_id,
                                                            map_ctx):
                if batch.num_rows == 0:
                    continue
                with split_time.timed():
                    parts = self._split(batch, n, map_id, ctx)
                del batch
                for p in range(n):
                    if parts[p] is not None:
                        acc[p].append(parts[p])
                del parts
            for p in range(n):
                # the catalog becomes each block's one holder
                if acc[p]:
                    catalog.put_block(sid, map_id, p, concat_batches(acc[p]))
                acc[p] = []
            catalog.mark_map_complete(sid, map_id)
        finally:
            map_ctx.complete()  # releases the permit

    def _split(self, batch: TorchColumnarBatch, n: int, map_id: int,
               ctx: TaskContext) -> List[Optional[TorchColumnarBatch]]:
        """A map batch's rows by reduce partition (reference
        exchange.py:816-829)."""
        if self.partitioning == "hash":
            return hash_split_parts(batch, self.keys, n, ctx)
        if self.partitioning in ("roundrobin", "coalesce"):
            return split_by_partition(
                batch, round_robin_partition_ids(batch, n, map_id), n)
        return [batch] + [None] * (n - 1)  # single

    def internal_do_execute_columnar(self, idx: int,
                                     ctx: TaskContext) -> Iterator:
        from ..chaos import inject
        from ..failure import with_device_retry
        self._ensure_materialized(ctx)
        names = [a.name for a in self.output]
        catalog, sid = ShuffleCatalog.get(), self._shuffle_id

        def fetch() -> List[TorchColumnarBatch]:
            # the reduce side's read under the chaos site and the transient
            # device-error retry (reference exchange.py:1113, ici.py:179)
            inject("ici.fetch", detail=f"s{sid}r{idx}")
            return list(catalog.blocks(sid, idx, self._n_maps))

        with self.metrics["deserializationTime"].timed():
            blocks = with_device_retry(fetch, ctx.conf)
        while blocks:
            b = blocks.pop(0)
            if b.num_rows:
                if obs._ACTIVE:
                    # one reduce-side block read (its row count is a host
                    # int; an event never reads the device)
                    obs.event("shuffle.read", cat="shuffle")
                yield b.rename(names)
            del b

    def cleanup_shuffle(self) -> None:
        """Drop this exchange's blocks (the session calls it when the query
        ends); a later execution materializes again."""
        if self._shuffle_id is not None:
            ShuffleCatalog.get().remove_shuffle(self._shuffle_id)
            self._shuffle_id = None


class CpuShuffleExchangeExec(_ExchangeBase, CpuExec):
    """The exchange on the host (reference ``CpuShuffleExchangeExec``):
    each map partition's rows split by Spark's HashPartitioning, pid =
    pmod(murmur3(keys, 42), n), the murmur3 the device's own code over CPU
    tensors (``hashexprs.murmur3_arrow``), so a host side and a device side
    of one join co-partition; round robin from the map id, or all to
    partition 0, as on the device. The blocks stay in host memory, a reduce
    partition reads them in map order; materialization runs once per
    exchange instance and the blocks go when the query ends."""

    def __init__(self, child: PhysicalPlan, partitioning: str,
                 keys: Sequence[Expression], num_partitions: int):
        CpuExec.__init__(self, [child])
        self._init_exchange(partitioning, bind_all(list(keys), child.output),
                            num_partitions)
        self._shuffle_id: Optional[int] = None
        self._n_maps = 0
        self._host_blocks: Dict[int, List[TorchColumnarBatch]] = {}

    @property
    def output(self):
        return self.children[0].output

    def node_desc(self) -> str:
        return f"CpuShuffleExchange[{self.partitioning}, n={self._n_out}]"

    def _ensure_materialized(self, ctx: TaskContext) -> None:
        if self._shuffle_id is not None:
            return
        from ..execs.base import op_time
        from ..execs.cpu import table_batch
        from ..serving.query_context import checkpoint
        n, child = self._n_out, self.children[0]
        blocks: Dict[int, List[TorchColumnarBatch]] = \
            {p: [] for p in range(n)}
        for map_id in range(child.num_partitions()):
            checkpoint(f"shuffle.map host m{map_id}")
            for b in child.execute_partition(map_id,
                                             ctx.for_partition(map_id)):
                if b.num_rows == 0:
                    continue
                t = b.to_arrow()
                with op_time(ctx, self):
                    if self.partitioning == "hash":
                        pids = host_partition_ids(t, self.keys, n, ctx)
                    elif self.partitioning == "single":
                        pids = np.zeros(t.num_rows, np.int64)
                    else:  # roundrobin, coalesce
                        pids = (np.arange(t.num_rows) + map_id) % n
                    order = np.argsort(pids, kind="stable")
                    bounds = np.searchsorted(pids[order], np.arange(n + 1))
                    for p in range(n):
                        lo, hi = bounds[p], bounds[p + 1]
                        if hi > lo:
                            blocks[p].append(table_batch(
                                t.take(order[lo:hi]), self.output))
        self._host_blocks = blocks
        self._n_maps = child.num_partitions()
        self._shuffle_id = -1  # materialized: the blocks are on the exec

    @counts_output
    def execute_partition(self, idx: int, ctx: TaskContext) -> Iterator:
        self._ensure_materialized(ctx)
        names = [a.name for a in self.output]
        for b in self._host_blocks.get(idx, []):
            yield b.rename(names)

    def cleanup_shuffle(self) -> None:
        """Drop the host blocks (the session calls it when the query
        ends)."""
        self._host_blocks = {}
        self._shuffle_id = None


def host_partition_ids(table, keys: Sequence[Expression], n: int,
                       ctx: TaskContext, seed: int = 42) -> np.ndarray:
    """Spark's hash partition id of every row of an Arrow table, as the
    device's ``hash_partition_ids`` gives it."""
    import torch
    from ..expressions.base import arrow_column
    from ..expressions.hashexprs import murmur3_arrow
    rows = table.num_rows
    h = murmur3_arrow([arrow_column(k.eval_cpu(table, ctx.eval_ctx), rows,
                                    k.dtype) for k in keys],
                      [k.dtype for k in keys], rows, seed)
    return torch.remainder(h, n).numpy().astype(np.int64)


def plan_cpu_exchange(plan, conf) -> PhysicalPlan:
    """A ``Repartition``'s CPU exchange: hash when it has keys, else its
    own partitioning; ``coalesce`` to at least the child's partition count
    is no exchange at all (reference exchange.py:1313)."""
    from ..plan.planner import plan_physical
    child = plan_physical(plan.children[0], conf)
    part, n = plan.partitioning, plan.num_partitions
    if part == "coalesce" and n >= child.num_partitions():
        return child
    return CpuShuffleExchangeExec(child, "hash" if plan.keys else part,
                                  plan.keys, n)
