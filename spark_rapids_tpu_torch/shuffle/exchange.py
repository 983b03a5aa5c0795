"""The hash exchange (port of ``TpuShuffleExchangeExec`` and
``CpuShuffleExchangeExec`` from ``spark_rapids_tpu/shuffle/exchange.py``,
hash partitioning, the device-resident ``ICI`` shuffle mode).

Materialization runs once per exchange instance: every map partition of
the child is hash-split on the device (``partitioner.py``) and each
(map, reduce) block stays on the device in the ``ShuffleCatalog``. A
reduce partition reads its blocks in map order, so it holds the
reference's rows in the reference's order. The session removes an
exchange's blocks when its query ends (``cleanup_shuffle``).

Not yet ported: the ``MULTITHREADED`` mode (host-serialized shuffle files;
it returns the same rows), the AQE readers, the collective mesh plane,
heartbeats, lost peers and chaos.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from ..columnar.batch import TorchColumnarBatch, concat_batches
from ..expressions.base import Expression
from ..execs.base import (CpuExec, PhysicalPlan, TaskContext, TorchExec,
                          bind_all)
from .partitioner import hash_split_parts


class ShuffleCatalog:
    """Single-process, device-resident shuffle blocks keyed by (shuffle id,
    map id, reduce id) (reference ``IciShuffleCatalog``, without heartbeats,
    lost peers, spill or chaos)."""

    _instance: Optional["ShuffleCatalog"] = None

    def __init__(self):
        self._next_id = 0
        self._blocks: Dict[Tuple[int, int, int], TorchColumnarBatch] = {}
        self._maps: Dict[int, set] = {}

    @classmethod
    def get(cls) -> "ShuffleCatalog":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def new_shuffle_id(self) -> int:
        self._next_id += 1
        self._maps[self._next_id] = set()
        return self._next_id

    def put_block(self, sid: int, map_id: int, reduce_id: int,
                  batch: TorchColumnarBatch) -> None:
        self._blocks[(sid, map_id, reduce_id)] = batch

    def mark_map_complete(self, sid: int, map_id: int) -> None:
        self._maps[sid].add(map_id)

    def blocks(self, sid: int, reduce_id: int,
               n_maps: int) -> List[TorchColumnarBatch]:
        """A reduce partition's blocks in map order."""
        missing = set(range(n_maps)) - self._maps.get(sid, set())
        if missing:
            raise RuntimeError(f"shuffle {sid}: maps {sorted(missing)} "
                               "have no output")
        return [self._blocks[k] for k in
                ((sid, m, reduce_id) for m in range(n_maps))
                if k in self._blocks]

    def remove_shuffle(self, sid: int) -> None:
        for k in [k for k in self._blocks if k[0] == sid]:
            del self._blocks[k]
        self._maps.pop(sid, None)

    def num_blocks(self) -> int:
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
        if partitioning != "hash":
            raise NotImplementedError(
                f"{partitioning} partitioning not yet ported")
        self.partitioning = partitioning
        self.keys = keys
        self._n_out = num_partitions

    def num_partitions(self) -> int:
        return self._n_out


class TorchShuffleExchangeExec(_ExchangeBase, TorchExec):
    """Hash exchange on the device."""

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

    def _ensure_materialized(self, ctx: TaskContext) -> None:
        if self._shuffle_id is not None:
            return
        _check_mode(ctx.conf)
        catalog = ShuffleCatalog.get()
        sid = catalog.new_shuffle_id()
        child, n = self.children[0], self._n_out
        try:
            for map_id in range(child.num_partitions()):
                acc: List[List[TorchColumnarBatch]] = [[] for _ in range(n)]
                for batch in child.execute_partition(
                        map_id, ctx.for_partition(map_id)):
                    if batch.num_rows == 0:
                        continue
                    parts = hash_split_parts(batch, self.keys, n, ctx)
                    for p, sub in enumerate(parts):
                        if sub is not None:
                            acc[p].append(sub)
                for p, batches in enumerate(acc):
                    if batches:
                        catalog.put_block(sid, map_id, p,
                                          concat_batches(batches))
                catalog.mark_map_complete(sid, map_id)
        except BaseException:
            catalog.remove_shuffle(sid)  # no half-written shuffle remains
            raise
        self._n_maps = child.num_partitions()
        self._shuffle_id = sid

    def internal_do_execute_columnar(self, idx: int,
                                     ctx: TaskContext) -> Iterator:
        self._ensure_materialized(ctx)
        names = [a.name for a in self.output]
        for b in ShuffleCatalog.get().blocks(self._shuffle_id, idx,
                                             self._n_maps):
            if b.num_rows:
                yield b.rename(names)

    def cleanup_shuffle(self) -> None:
        """Drop this exchange's blocks (the session calls it when the query
        ends); a later execution materializes again."""
        if self._shuffle_id is not None:
            ShuffleCatalog.get().remove_shuffle(self._shuffle_id)
            self._shuffle_id = None


class CpuShuffleExchangeExec(_ExchangeBase, CpuExec):
    """The planner's exchange node; the override engine converts it. Its
    host execution (pyarrow in the reference) is not yet ported."""

    def __init__(self, child: PhysicalPlan, partitioning: str,
                 keys: Sequence[Expression], num_partitions: int):
        CpuExec.__init__(self, [child])
        self._init_exchange(partitioning, bind_all(list(keys), child.output),
                            num_partitions)

    @property
    def output(self):
        return self.children[0].output

    def node_desc(self) -> str:
        return f"CpuShuffleExchange[{self.partitioning}, n={self._n_out}]"

    def execute_partition(self, idx: int, ctx: TaskContext) -> Iterator:
        raise NotImplementedError(
            "CPU execution of CpuShuffleExchangeExec not yet ported")
