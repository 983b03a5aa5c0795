"""The data-writing command: a write is a plan node (port of
``spark_rapids_tpu/execs/write.py``; reference GpuDataWritingCommandExec
and GpuFileFormatDataWriter), so the override engine tags, converts and
meters it like any other operator. ``TorchDataWritingCommandExec`` takes
device batches from a device child and downloads each once, through the
audited gate, at the file boundary; ``CpuDataWritingCommandExec`` takes
host batches where the engine keeps the write off the card
(``spark.rapids.sql.format.{parquet,orc}.write.enabled=false``, or a host
child with the device off).

Files: ``part-NNNNN-<job>.<ext>`` a task (a partition), with the write
job's id in the name so an append never reuses an earlier job's names;
``partitionBy`` writes into ``k=v`` directories (``io/layout.py``);
``bucketBy(n, cols)`` splits each task's rows into
``part-NNNNN-<job>_BBBBB.<ext>`` by Spark's bucket id,
pmod(murmur3(cols, 42), n), through the port's murmur3
(``expressions/hashexprs.murmur3_arrow``).
"""

from __future__ import annotations

import os
import uuid
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List

from .base import (ESSENTIAL, CpuExec, PhysicalPlan, TaskContext, TorchExec,
                   op_time)


@dataclass
class WriteSpec:
    """What the write exec needs to write one partition's files."""

    fmt: str
    path: str
    ext: str
    write_fn: Callable  # (Arrow table, file path) -> None
    partition_by: List[str] = field(default_factory=list)
    options: Dict[str, str] = field(default_factory=dict)
    bucket_by: List[str] = field(default_factory=list)
    num_buckets: int = 0
    job_id: str = field(default_factory=lambda: uuid.uuid4().hex[:8])

    def bucket_ids(self, table):
        """Spark's bucket id of every row: pmod(murmur3(bucket columns, seed
        42), n), the hash the read side prunes by."""
        import torch
        from ..expressions.hashexprs import murmur3_arrow
        from ..types import from_arrow
        cols = [table.column(c).combine_chunks() for c in self.bucket_by]
        h = murmur3_arrow(cols, [from_arrow(c.type) for c in cols],
                          table.num_rows, 42)
        return torch.remainder(h.to(torch.int64), self.num_buckets).numpy()

    def _write_leaf(self, table, d: str, part_idx: int) -> int:
        """One directory's files: one, or one a bucket id present (the
        rows of a bucket in input order: one stable sort by bucket id,
        one take, a slice a file)."""
        import numpy as np
        import pyarrow as pa
        if not self.num_buckets:
            self.write_fn(table, os.path.join(
                d, f"part-{part_idx:05d}-{self.job_id}.{self.ext}"))
            return 1
        ids = self.bucket_ids(table)
        order = np.argsort(ids, kind="stable")
        ids = ids[order]
        table = table.take(pa.array(order))
        starts = np.flatnonzero(np.r_[True, ids[1:] != ids[:-1]])
        ends = np.r_[starts[1:], len(ids)]
        for lo, hi in zip(starts, ends):
            self.write_fn(table.slice(lo, hi - lo), os.path.join(
                d, f"part-{part_idx:05d}-{self.job_id}_{int(ids[lo]):05d}"
                   f".{self.ext}"))
        return len(starts)

    def write_partition(self, table, part_idx: int) -> int:
        """Write one partition's rows; returns the files written."""
        if not self.partition_by:
            return self._write_leaf(table, self.path, part_idx)
        from ..io.layout import iter_hive_partitions
        n = 0
        for _, subdir, sub in iter_hive_partitions(table, self.partition_by):
            d = os.path.join(self.path, subdir)
            os.makedirs(d, exist_ok=True)
            n += self._write_leaf(sub, d, part_idx)
        return n


class _WriteBase:
    def _init_write(self, spec: WriteSpec) -> None:
        self.spec = spec

    @property
    def output(self):
        return []

    def num_partitions(self) -> int:
        return self.children[0].num_partitions()


class CpuDataWritingCommandExec(_WriteBase, CpuExec):
    """The write in the host engine: host batches from the child."""

    def __init__(self, child: PhysicalPlan, spec: WriteSpec):
        CpuExec.__init__(self, [child])
        self._init_write(spec)

    def node_desc(self) -> str:
        return f"CpuDataWritingCommand[{self.spec.fmt}]"

    def execute_partition(self, idx: int, ctx: TaskContext) -> Iterator:
        import pyarrow as pa
        names = [a.name for a in self.children[0].output]
        tables = [b.to_arrow().rename_columns(names)
                  for b in self.children[0].execute_partition(idx, ctx)
                  if b.num_rows]
        if tables:
            with op_time(ctx, self):
                self.spec.write_partition(pa.concat_tables(tables), idx)
        yield from ()  # a write yields no batch


class TorchDataWritingCommandExec(_WriteBase, TorchExec):
    """The write over device batches (reference GpuDataWritingCommandExec):
    each batch downloads once, at the file boundary; ``writeTime``,
    ``numFiles`` and ``numWrittenRows`` as GpuFileFormatDataWriter
    counts them."""

    def __init__(self, child: PhysicalPlan, spec: WriteSpec):
        TorchExec.__init__(self, [child])
        self._init_write(spec)

    def node_desc(self) -> str:
        return f"TorchDataWritingCommand[{self.spec.fmt}]"

    def additional_metrics(self):
        return {"writeTime": ESSENTIAL, "numFiles": ESSENTIAL,
                "numWrittenRows": ESSENTIAL}

    def internal_do_execute_columnar(self, idx: int,
                                     ctx: TaskContext) -> Iterator:
        import pyarrow as pa
        names = [a.name for a in self.children[0].output]
        tables, rows = [], 0
        for batch in self.children[0].execute_partition(idx, ctx):
            if not batch.num_rows:
                continue
            rows += batch.num_rows
            tables.append(batch.to_host("batch").to_arrow()
                          .rename_columns(names))
            del batch
        if tables:
            with self.metrics["writeTime"].timed():
                n = self.spec.write_partition(pa.concat_tables(tables), idx)
            self.metrics["numFiles"].add(n)
            self.metrics["numWrittenRows"].add(rows)
        yield from ()  # a write yields no batch
