"""Cached relations (port of ``spark_rapids_tpu/io/cache.py``).

``CachedRelation`` is what ``df.cache()`` makes (reference
ParquetCachedBatchSerializer): the result as per-batch parquet blobs
(zstd), each decodable on its own, held in host memory and spilled whole
to a local file, oldest first, while the blobs exceed
``spark.rapids.sql.cache.hostMemoryLimit``. ``DeviceCachedRelation`` is
what ``df.device_cache()`` makes: the result as device batches, so
repeated queries skip the upload and keep per-column key statistics.
"""

from __future__ import annotations

import io
import os
import tempfile
import threading
from typing import Iterator, List, Optional

from ..expressions.base import AttributeReference
from ..plan.logical import LogicalPlan


class CachedBatch:
    """One parquet-compressed batch: a blob in host memory until spilled to
    a local file; it decodes from either."""

    def __init__(self, table, compression: str):
        import pyarrow.parquet as pq
        buf = io.BytesIO()
        pq.write_table(table, buf, compression=compression)
        self._blob: Optional[bytes] = buf.getvalue()
        self._path: Optional[str] = None
        self.num_rows = table.num_rows
        self.compressed_bytes = len(self._blob)

    @property
    def on_disk(self) -> bool:
        return self._path is not None

    def spill(self, directory: str) -> int:
        """Move the blob to a file; returns the host bytes released."""
        if self._blob is None:
            return 0
        fd, path = tempfile.mkstemp(suffix=".parquet", dir=directory)
        with os.fdopen(fd, "wb") as f:
            f.write(self._blob)
        self._path = path
        released = len(self._blob)
        self._blob = None
        return released

    def table(self):
        import pyarrow.parquet as pq
        if self._blob is not None:
            return pq.read_table(io.BytesIO(self._blob))
        return pq.read_table(self._path)

    def close(self) -> None:
        self._blob = None
        if self._path is not None:
            try:
                os.unlink(self._path)
            except OSError:
                pass
            self._path = None


class CachedRelation(LogicalPlan):
    """A materialized result as parquet-compressed batches of
    ``batch_rows`` rows, under a host budget of ``host_limit_bytes`` (0: no
    cap)."""

    def __init__(self, table, compression: str = "zstd",
                 batch_rows: int = 1 << 18, host_limit_bytes: int = 0,
                 spill_dir: Optional[str] = None):
        from ..types import from_arrow
        self._host_limit = host_limit_bytes
        self._spill_dir = spill_dir or tempfile.gettempdir()
        self._lock = threading.Lock()
        self.batches: List[CachedBatch] = [
            CachedBatch(table.slice(start, batch_rows), compression)
            for start in range(0, max(table.num_rows, 1), batch_rows)]
        self.num_rows = table.num_rows
        self._output = [AttributeReference(f.name, from_arrow(f.type), True)
                        for f in table.schema]
        #: rises on unpersist(): the plan cache keys on it, so no cached
        #: plan replays dropped batches
        self.generation = 0
        self._enforce_host_limit()

    def _enforce_host_limit(self) -> None:
        """Spill the oldest in-memory batches until the blobs fit the host
        budget."""
        if self._host_limit <= 0:
            return
        with self._lock:
            host_bytes = self.host_bytes
            for b in self.batches:
                if host_bytes <= self._host_limit:
                    break
                host_bytes -= b.spill(self._spill_dir)

    @property
    def output(self) -> List[AttributeReference]:
        return self._output

    @property
    def compressed_bytes(self) -> int:
        return sum(b.compressed_bytes for b in self.batches)

    @property
    def host_bytes(self) -> int:
        return sum(b.compressed_bytes for b in self.batches if not b.on_disk)

    def iter_tables(self) -> Iterator:
        """One decoded batch at a time: no reader holds the whole relation
        decompressed."""
        for b in self.batches:
            yield b.table()

    def unpersist(self) -> None:
        """Drop the blobs and spill files."""
        for b in self.batches:
            b.close()
        self.batches = []
        self.generation += 1

    def node_desc(self) -> str:
        disk = sum(1 for b in self.batches if b.on_disk)
        return (f"CachedRelation[{self.num_rows} rows, "
                f"{len(self.batches)} batches, {self.compressed_bytes} bytes"
                + (f", {disk} on disk" if disk else "") + "]")


class DeviceCachedRelation(LogicalPlan):
    """The materialized result held as device batches: repeated queries
    skip the upload and keep per-column memoized key statistics."""

    def __init__(self, batches: List, output):
        self._batches = list(batches)
        self._output = list(output)
        self.num_rows = sum(b.num_rows for b in batches)

    @property
    def output(self) -> List[AttributeReference]:
        return self._output

    def batches(self) -> List:
        return self._batches

    def node_desc(self) -> str:
        return (f"DeviceCachedRelation[{self.num_rows} rows, "
                f"{len(self._batches)} batches]")
