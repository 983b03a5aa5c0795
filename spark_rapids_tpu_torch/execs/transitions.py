"""Host ↔ device transitions and the device scan (port of
``spark_rapids_tpu/execs/transitions.py``).

Host batches are TorchColumnarBatch on the CPU, so the transitions are an
upload and a download; the reference's row ↔ columnar leg collapses away.
``HostToDeviceExec`` uploads to ``TaskContext.device``, the session's
device: the plan itself names no device.

Both transitions time their own work into their ``uploadTime`` and
``downloadTime`` metrics and the session's counters
(``opTime.HostToDeviceExec``, ``opTime.DeviceToHostExec``; one host-clock
reading): the price of moving an operator off the card. A download waits
for the device work queued before it, so its time holds that wait too; it
is the chain's one blocking download, recorded in the sync ledger as
``batch`` under ``DeviceToHostExec``.

``TorchDeviceScanExec`` serves device-resident cached batches with no
upload, and its column objects stay the same across runs, so statistics
memoized on them survive between queries. ``CpuDeviceScanExec`` is its CPU
view, which the override engine converts.
"""

from __future__ import annotations

from typing import Iterator

from .base import (DEBUG, MODERATE, CpuExec, PhysicalPlan, TaskContext,
                   TorchExec, op_time)


class HostToDeviceExec(TorchExec):
    """Upload host batches to the session's device, padded to the bucket
    capacity (reference HostToDeviceExec)."""

    def __init__(self, child: PhysicalPlan):
        super().__init__([child])

    @property
    def output(self):
        return self.children[0].output

    def additional_metrics(self):
        return {"uploadTime": MODERATE, "numInputBatches": DEBUG}

    def internal_do_execute_columnar(self, idx: int,
                                     ctx: TaskContext) -> Iterator:
        names = [a.name for a in self.output]
        n_in = self.metrics["numInputBatches"]
        for t in self.children[0].execute_partition(idx, ctx):
            n_in.add(1)
            with op_time(ctx, self, "uploadTime"):
                out = t.to_device(ctx.device).rename(names)
            yield out


class CpuDeviceScanExec(CpuExec):
    """CPU view of a device-cached relation (downloads per batch)."""

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
        return f"CpuDeviceScan[{len(self.batches)} batches]"

    def execute_partition(self, idx: int, ctx: TaskContext) -> Iterator:
        from ..profiling import sync_scope
        if idx < len(self.batches):
            with sync_scope(self.node_name()):
                out = self.batches[idx].to_host()
            yield out


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


class DeviceToHostExec(CpuExec):
    """Download device batches to host batches (reference
    DeviceToHostExec)."""

    def __init__(self, child: PhysicalPlan):
        super().__init__([child])

    @property
    def output(self):
        return self.children[0].output

    def additional_metrics(self):
        return {"downloadTime": MODERATE}

    def execute_partition(self, idx: int, ctx: TaskContext) -> Iterator:
        from ..profiling import sync_scope
        name = self.node_name()
        for b in self.children[0].execute_partition(idx, ctx):
            with op_time(ctx, self, "downloadTime"), sync_scope(name):
                out = b.to_host()
            yield out
