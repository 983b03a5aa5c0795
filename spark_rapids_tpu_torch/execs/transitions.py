"""Host ↔ device transitions and the device scan (port of
``spark_rapids_tpu/execs/transitions.py``).

Host batches are TorchColumnarBatch on the CPU, so the transitions are an
upload and a download; the reference's row ↔ columnar leg collapses away.
``HostToDeviceExec`` uploads to ``TaskContext.device``, the session's
device: the plan itself names no device.

Both transitions time their own work into the session's counters
(``opTime.HostToDeviceExec``, ``opTime.DeviceToHostExec``, host clock):
the price of moving an operator off the card. A download waits for the
device work queued before it, so its time holds that wait too.

``TorchDeviceScanExec`` serves device-resident cached batches with no
upload, and its column objects stay the same across runs, so statistics
memoized on them survive between queries. ``CpuDeviceScanExec`` is its CPU
view, which the override engine converts.
"""

from __future__ import annotations

from typing import Iterator

from .base import CpuExec, PhysicalPlan, TaskContext, TorchExec, op_time


class HostToDeviceExec(TorchExec):
    """Upload host batches to the session's device, padded to the bucket
    capacity (reference HostToDeviceExec)."""

    def __init__(self, child: PhysicalPlan):
        super().__init__([child])

    @property
    def output(self):
        return self.children[0].output

    def internal_do_execute_columnar(self, idx: int,
                                     ctx: TaskContext) -> Iterator:
        names = [a.name for a in self.output]
        for t in self.children[0].execute_partition(idx, ctx):
            with op_time(ctx, "HostToDeviceExec"):
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
        if idx < len(self.batches):
            yield self.batches[idx].to_host()


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

    def execute_partition(self, idx: int, ctx: TaskContext) -> Iterator:
        for b in self.children[0].execute_partition(idx, ctx):
            with op_time(ctx, "DeviceToHostExec"):
                out = b.to_host()
            yield out
