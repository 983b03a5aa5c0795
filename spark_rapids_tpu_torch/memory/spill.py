"""Spill framework: a tiered buffer catalog DEVICE → HOST → DISK.

Port of ``spark_rapids_tpu/memory/spill.py`` (reference analogue:
RapidsBufferCatalog with its device, host and disk stores,
SpillPriorities, SpillableColumnarBatch). Device batches register for a
handle; under budget pressure the catalog spills the lowest-priority
buffers to host memory, then past ``spark.rapids.memory.host.spillStorageSize``
to files on disk; ``get_batch`` unspills on demand.

A spill copies every tensor of the batch (values, validity, string
offsets, at their full capacity) to the host and drops the catalog's
device reference, so the caching allocator reuses the memory; the
accounting moves through ``HbmBudget``. A spill that would free nothing
is not made: when another holder still keeps the batch's device tensors
alive (the operator working on it, a cached relation it is a view of),
the entry stays on the device, since its copy on the host would only
come back as a second copy on the card (``_detach_if_sole_holder``). The host tier keeps the tensors; the disk tier writes their
bytes to one file per buffer with an XXH64 checksum of the file, checked
on unspill (``SpillCorruptionError`` on a mismatch). The reference stores
Arrow tables and Arrow IPC files; the port's tiers hold the device
layout itself, so a round trip is exact to the byte and needs no pyarrow.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
import threading
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..columnar.batch import TorchColumnarBatch
from ..columnar.vector import TorchColumnVector
from ..config import HOST_SPILL_STORAGE_SIZE, RapidsConf
from .hbm import HbmBudget

TIER_DEVICE = "DEVICE"
TIER_HOST = "HOST"
TIER_DISK = "DISK"


class SpillCorruptionError(IOError):
    """A disk-spilled buffer failed its integrity check on unspill (bit
    rot, truncation, or chaos-injected corruption)."""


# Spill priorities (reference SpillPriorities.scala): lower spills first
ACTIVE_ON_DECK_PRIORITY = -100
ACTIVE_BATCHING_PRIORITY = 0
OUTPUT_FOR_SHUFFLE_PRIORITY = 100

#: one column's tensors in the order they spill: values, validity, offsets
_Parts = List[Optional[torch.Tensor]]


def _column_parts(c: TorchColumnVector) -> _Parts:
    return [c.data, c.validity, c.offsets]


def _detach_if_sole_holder(e: "_Entry") -> Optional[List[_Parts]]:
    """Drop the entry's device batch, keeping its storages, and tell
    whether anything else still holds its tensors: a weak reference to each
    tensor survives any other holder of the tensor, its column or its batch
    (and a view of it), and a storage's use count any other tensor on it.
    Returns the batch's parts rebuilt over the kept storages when the
    catalog was the one holder (the caller copies them to the host and lets
    them go), else None, with ``e.batch`` rebuilt over the same memory."""
    kept: Dict[int, list] = {}  # id(tensor) -> [storage, dtype, offset,
    # size, stride]
    probes = []
    layout: List[List[Optional[int]]] = []
    for c in e.batch.columns:
        row = []
        for t in _column_parts(c):
            if t is None:
                row.append(None)
                continue
            if id(t) not in kept:
                kept[id(t)] = [t.untyped_storage(), t.dtype,
                               t.storage_offset(), tuple(t.shape),
                               t.stride()]
                probes.append(weakref.ref(t))
            row.append(id(t))
        layout.append(row)
    e.batch = None
    t = c = None  # noqa: F841 — the loop's last references
    held = any(r() is not None for r in probes)
    use_count = getattr(torch._C, "_storage_Use_Count", None)
    if not held and use_count is not None:
        wrappers: Dict[int, int] = {}
        for k in kept.values():
            wrappers[k[0]._cdata] = wrappers.get(k[0]._cdata, 0) + 1
        held = any(use_count(k[0]._cdata) > wrappers[k[0]._cdata]
                   for k in kept.values())
    rebuilt = {i: torch.empty(0, dtype=k[1], device=e.device).set_(
        k[0], k[2], k[3], k[4]) for i, k in kept.items()}
    parts = [[None if i is None else rebuilt[i] for i in row]
             for row in layout]
    if not held:
        return parts
    e.batch = _assemble(e, parts)
    return None


def _assemble(entry: "_Entry", parts: List[_Parts]) -> TorchColumnarBatch:
    cols = [TorchColumnVector(dtype, data, validity, entry.num_rows,
                              offsets=offsets)
            for dtype, (data, validity, offsets) in zip(entry.dtypes, parts)]
    return TorchColumnarBatch(cols, entry.num_rows, entry.names)


def _from_host(entry: "_Entry", host: List[_Parts]) -> TorchColumnarBatch:
    dev = entry.device
    return _assemble(entry, [[None if t is None else t.to(dev) for t in p]
                             for p in host])


def _serialize(host: List[_Parts]) -> Tuple[bytes, list]:
    """The host tensors' bytes back to back, and the layout (torch dtype,
    shape) to read them back."""
    chunks, layout = [], []
    for parts in host:
        for t in parts:
            if t is None:
                layout.append(None)
                continue
            layout.append((t.dtype, tuple(t.shape)))
            # host-tier tensors: no device transfer
            chunks.append(t.contiguous().view(torch.uint8).numpy().tobytes()
                          if t.numel() else b"")
    return b"".join(chunks), layout


def _deserialize(data: bytes, layout: list, n_cols: int) -> List[_Parts]:
    flat: list = []
    at = 0
    for item in layout:
        if item is None:
            flat.append(None)
            continue
        dtype, shape = item
        n = int(np.prod(shape)) * torch.empty(0, dtype=dtype).element_size()
        raw = np.frombuffer(data, dtype=np.uint8, count=n, offset=at).copy()
        flat.append(torch.from_numpy(raw).view(dtype).reshape(shape))
        at += n
    if at != len(data):
        raise SpillCorruptionError(
            f"spill file holds {len(data)} bytes, its layout {at}")
    return [flat[3 * i:3 * i + 3] for i in range(n_cols)]


class _Entry:
    __slots__ = ("handle", "tier", "priority", "batch", "host", "disk_path",
                 "disk_checksum", "disk_layout", "nbytes", "names", "dtypes",
                 "num_rows", "device")

    def __init__(self, handle: int, batch: TorchColumnarBatch, priority: int):
        self.handle = handle
        self.tier = TIER_DEVICE
        self.priority = priority
        self.batch: Optional[TorchColumnarBatch] = batch
        self.host: Optional[List[_Parts]] = None
        self.disk_path: Optional[str] = None
        self.disk_checksum: Optional[int] = None
        self.disk_layout: Optional[list] = None
        self.nbytes = batch.device_memory_size()
        self.names = batch.names
        self.dtypes = [c.dtype for c in batch.columns]
        self.num_rows = batch.num_rows
        self.device = batch.device


class TorchBufferCatalog:
    """Handle-based spillable-buffer registry (reference
    RapidsBufferCatalog)."""

    _instance: Optional["TorchBufferCatalog"] = None
    _lock = threading.Lock()

    def __init__(self, conf: Optional[RapidsConf] = None):
        conf = conf or RapidsConf()
        self._entries: Dict[int, _Entry] = {}
        self._next_handle = 0
        self._reg_lock = threading.RLock()
        self._disk_dir: Optional[str] = None
        self._unspilling: set = set()  # handles coming back to the device
        self.host_limit = conf.get(HOST_SPILL_STORAGE_SIZE)
        self.host_used = 0
        self.host_peak_used = 0
        self.spilled_to_host = 0
        self.spilled_to_disk = 0
        HbmBudget.get(conf).set_spill_callback(self.synchronous_spill)

    @classmethod
    def get(cls, conf: Optional[RapidsConf] = None) -> "TorchBufferCatalog":
        with cls._lock:
            if cls._instance is None:
                cls._instance = TorchBufferCatalog(conf)
            return cls._instance

    @classmethod
    def reset_for_tests(cls, conf: Optional[RapidsConf] = None
                        ) -> "TorchBufferCatalog":
        with cls._lock:
            if cls._instance is not None:
                cls._instance.shutdown()
            cls._instance = TorchBufferCatalog(conf)
            return cls._instance

    def shutdown(self) -> None:
        """Drop every entry and the spill directory."""
        with self._reg_lock:
            for h in list(self._entries):
                self.remove(h)
            if self._disk_dir is not None:
                shutil.rmtree(self._disk_dir, ignore_errors=True)
                self._disk_dir = None

    def num_entries(self) -> int:
        with self._reg_lock:
            return len(self._entries)

    # --- registration ------------------------------------------------------
    def add_batch(self, batch: TorchColumnarBatch,
                  priority: int = ACTIVE_BATCHING_PRIORITY) -> int:
        with self._reg_lock:
            self._next_handle += 1
            h = self._next_handle
            e = _Entry(h, batch, priority)
            # allocate before registering: a refused allocation leaves no
            # entry behind
            HbmBudget.get().allocate(e.nbytes)
            self._entries[h] = e
            return h

    def remove(self, handle: int) -> None:
        with self._reg_lock:
            e = self._entries.pop(handle, None)
            if e is None:
                return
            if e.tier == TIER_DEVICE:
                HbmBudget.get().free(e.nbytes)
            elif e.tier == TIER_HOST:
                self.host_used -= e.nbytes
            elif e.disk_path and os.path.exists(e.disk_path):
                os.unlink(e.disk_path)
            e.batch = None
            e.host = None

    # --- access ------------------------------------------------------------
    def get_batch(self, handle: int) -> TorchColumnarBatch:
        with self._reg_lock:
            e = self._entries[handle]
            if e.tier != TIER_DEVICE:
                self._unspill(e)
            return e.batch

    def _unspill(self, e: _Entry) -> None:
        import time as _time
        from ..obs import metrics as _metrics
        from ..profiling import TaskMetricsRegistry
        t0 = _time.perf_counter_ns()
        if e.tier == TIER_DISK:
            from ..shuffle.serializer import xxhash64_bytes
            with open(e.disk_path, "rb") as f:
                data = f.read()
            if e.disk_checksum is not None \
                    and xxhash64_bytes(data) != e.disk_checksum:
                raise SpillCorruptionError(
                    f"spill file {e.disk_path} failed its xxhash64 "
                    f"integrity check on unspill ({len(data)} bytes)")
            e.host = _deserialize(data, e.disk_layout, len(e.dtypes))
            os.unlink(e.disk_path)
            e.disk_path = None
            e.disk_checksum = None
            e.disk_layout = None
            e.tier = TIER_HOST
            self.host_used += e.nbytes
        if e.tier == TIER_HOST:
            # the allocation may spill other buffers and push the host tier
            # to disk: this entry, on its way back, must not be among them
            self._unspilling.add(e.handle)
            try:
                HbmBudget.get().allocate(e.nbytes)
            finally:
                self._unspilling.discard(e.handle)
            e.batch = _from_host(e, e.host)
            e.host = None
            self.host_used -= e.nbytes
            e.tier = TIER_DEVICE
        dt = _time.perf_counter_ns() - t0
        TaskMetricsRegistry.get().add("readSpillTimeNs", dt)
        _metrics.counter_inc("spill.read_bytes", e.nbytes)
        from ..obs import tracer as _obs
        if _obs._ACTIVE:
            _obs.event("spill.read", cat="memory", bytes=e.nbytes,
                       wait_ns=dt)

    # --- spilling ----------------------------------------------------------
    def synchronous_spill(self, bytes_needed: int) -> int:
        """Spill lowest-priority device buffers until bytes_needed freed
        (reference: an allocation failure drains the device store)."""
        freed = 0
        with self._reg_lock:
            device_entries = sorted(
                (e for e in self._entries.values() if e.tier == TIER_DEVICE),
                key=lambda e: e.priority)
            for e in device_entries:
                if freed >= bytes_needed:
                    break
                freed += self._spill_entry_to_host(e)
        return freed

    def _spill_entry_to_host(self, e: _Entry) -> int:
        """Spill one device entry to the host; 0 when another holder keeps
        its tensors alive (the entry stays on the device)."""
        from ..chaos import inject
        from ..obs import metrics as _metrics
        from ..profiling import TaskMetricsRegistry
        inject("spill.to_host")  # before any state mutation: a raised fault
        # must leave the entry intact on its current tier
        parts = _detach_if_sole_holder(e)
        if parts is None:
            _metrics.counter_inc("spill.held_elsewhere_bytes", e.nbytes)
            return 0
        _metrics.counter_inc("spill.to_host_bytes", e.nbytes)
        from ..obs import tracer as _obs
        if _obs._ACTIVE:
            _obs.event("spill.to_host", cat="memory", bytes=e.nbytes)
        # the spill's own copy: counted in the spill bytes and task
        # metrics, not in the sync ledger (as in the reference)
        e.host = [[None if t is None else t.cpu() for t in p]
                  for p in parts]
        del parts  # the last device references: the memory goes back
        e.tier = TIER_HOST


        HbmBudget.get().free(e.nbytes)
        self.host_used += e.nbytes
        self.host_peak_used = max(self.host_peak_used, self.host_used)
        self.spilled_to_host += e.nbytes
        TaskMetricsRegistry.get().add("spillToHostBytes", e.nbytes)
        if self.host_used > self.host_limit:
            self._spill_host_to_disk()
        return e.nbytes

    def _spill_dir(self) -> str:
        if self._disk_dir is None:
            self._disk_dir = tempfile.mkdtemp(prefix="torch_spill_")
            atexit.register(shutil.rmtree, self._disk_dir, True)
        return self._disk_dir

    def _spill_host_to_disk(self) -> None:
        from ..chaos import corrupt_bytes, inject
        from ..obs import flight as _flight
        from ..obs import metrics as _metrics
        from ..profiling import TaskMetricsRegistry
        from ..shuffle.serializer import xxhash64_bytes
        with self._reg_lock:
            host_entries = sorted(
                (e for e in self._entries.values() if e.tier == TIER_HOST
                 and e.handle not in self._unspilling),
                key=lambda e: e.priority)
            for e in host_entries:
                if self.host_used <= self.host_limit:
                    break
                inject("spill.to_disk")  # pre-mutation, like spill.to_host
                _metrics.counter_inc("spill.to_disk_bytes", e.nbytes)
                _flight.note("spill.to_disk", bytes=e.nbytes)
                from ..obs import tracer as _obs
                if _obs._ACTIVE:
                    _obs.event("spill.to_disk", cat="memory",
                               bytes=e.nbytes)
                path = os.path.join(self._spill_dir(), f"buf_{e.handle}.bin")
                data, layout = _serialize(e.host)
                # checksum BEFORE the chaos mangle: injected corruption
                # must be detectable on unspill, exactly like real bit rot
                e.disk_checksum = xxhash64_bytes(data)
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(corrupt_bytes("spill.to_disk", data))
                os.replace(tmp, path)  # atomic: no truncated spill files
                e.host = None
                e.disk_layout = layout
                e.disk_path = path
                e.tier = TIER_DISK
                self.host_used -= e.nbytes
                self.spilled_to_disk += e.nbytes
                TaskMetricsRegistry.get().add("spillToDiskBytes", e.nbytes)


class SpillableColumnarBatch:
    """RAII wrapper: a batch registered in the catalog, retrievable and
    closable (reference SpillableColumnarBatch.scala). It keeps no
    reference to the batch itself: the catalog's entry is the one holder."""

    def __init__(self, batch: TorchColumnarBatch,
                 priority: int = ACTIVE_BATCHING_PRIORITY):
        from .cleaner import MemoryCleaner
        self._catalog = TorchBufferCatalog.get()
        self._handle: Optional[int] = self._catalog.add_batch(batch,
                                                              priority)
        self.num_rows = batch.num_rows
        self.size_bytes = batch.device_memory_size()
        # pin the cleaner INSTANCE: close() unregisters from the same book
        # this registered in, even across a reset_for_tests
        self._cleaner = MemoryCleaner.get()
        self._cleaner_token = self._cleaner.register(
            f"SpillableColumnarBatch[{self.num_rows}r {self.size_bytes}B]")

    def get_batch(self) -> TorchColumnarBatch:
        if self._handle is None:
            raise ValueError("spillable batch already closed")
        return self._catalog.get_batch(self._handle)

    def close(self) -> None:
        if self._handle is not None:
            self._catalog.remove(self._handle)
            self._handle = None
        # a second unregister of the same token IS the double-close signal
        self._cleaner.unregister(self._cleaner_token)

    def __enter__(self) -> "SpillableColumnarBatch":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
