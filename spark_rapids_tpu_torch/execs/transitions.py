"""Host → device transitions and the device scan.

``TorchDeviceScanExec`` ports ``TpuDeviceScanExec``: it serves
device-resident cached batches with no upload, and its column objects stay
the same across runs, so statistics memoized on them survive between
queries. ``TorchLocalTableScanExec`` stands in for the reference's
``CpuLocalTableScanExec`` followed by ``HostToDeviceExec``: the CPU execs
and the override engine that inserts the transition are not yet ported.
"""

from __future__ import annotations

from typing import Iterator

import torch

from .base import TaskContext, TorchExec


def _partition_bounds(rows: int, n: int, idx: int):
    base = rows // n
    start = idx * base + min(idx, rows % n)
    return start, base + (1 if idx < rows % n else 0)


class TorchLocalTableScanExec(TorchExec):
    """Slice a host table into partitions and batchSizeRows batches and
    upload each batch to ``device``."""

    def __init__(self, table, num_partitions: int, output,
                 device: torch.device):
        super().__init__([])
        self.table = table
        self._num_partitions = max(1, num_partitions)
        self._output = list(output)
        self.device = device

    @property
    def output(self):
        return self._output

    def num_partitions(self) -> int:
        return self._num_partitions

    def node_desc(self) -> str:
        return (f"TorchLocalTableScan[{self.table.num_rows} rows, "
                f"{self._num_partitions} partitions]")

    def internal_do_execute_columnar(self, idx: int,
                                     ctx: TaskContext) -> Iterator:
        names = [a.name for a in self._output]
        start, count = _partition_bounds(self.table.num_rows,
                                         self._num_partitions, idx)
        step = ctx.conf.batch_size_rows
        for off in range(0, max(count, 1), step):
            chunk = self.table.slice(start + off, min(step, count - off))
            if chunk.num_rows or count == 0:
                yield chunk.to_device(self.device).rename(names)


class TorchDeviceScanExec(TorchExec):
    """Serve device-resident cached batches, one partition per batch."""

    def __init__(self, batches, output):
        super().__init__([])
        self.batches = list(batches)
        self._output = list(output)

    @property
    def output(self):
        return self._output

    def num_partitions(self) -> int:
        return max(1, len(self.batches))

    def node_desc(self) -> str:
        rows = sum(b.num_rows for b in self.batches)
        return f"TorchDeviceScan[{len(self.batches)} batches, {rows} rows]"

    def internal_do_execute_columnar(self, idx: int,
                                     ctx: TaskContext) -> Iterator:
        if idx < len(self.batches):
            yield self.batches[idx].rename([a.name for a in self._output])
