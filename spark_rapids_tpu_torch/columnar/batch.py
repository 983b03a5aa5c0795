"""Columnar batches of torch column vectors + host conversion.

Port of ``TpuColumnarBatch`` (``spark_rapids_tpu/columnar/batch.py``). A
host table (what ``createDataFrame`` holds) is a batch on the CPU with
capacity == num_rows; ``slice``/``to_device`` cut and upload it. Arrow input
is read through its buffers with a lazy ``pyarrow`` import: the main path
runs on numpy alone.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..types import (BooleanType, StringType, StructField,
                     StructType, from_arrow, from_numpy_dtype)
from .vector import TorchColumnVector, bucket_capacity


class TorchColumnarBatch:
    """Columns sharing num_rows/capacity, all on one device."""

    __slots__ = ("columns", "num_rows", "names")

    def __init__(self, columns: List[TorchColumnVector], num_rows: int,
                 names: Optional[List[str]] = None):
        for c in columns:
            if c.num_rows != num_rows:
                raise ValueError("column row counts must agree")
        self.columns = columns
        self.num_rows = int(num_rows)
        self.names = names

    @property
    def capacity(self) -> int:
        return self.columns[0].capacity if self.columns else \
            bucket_capacity(self.num_rows)

    @property
    def device(self) -> torch.device:
        return self.columns[0].device if self.columns else torch.device("cpu")

    def column(self, i: int) -> TorchColumnVector:
        return self.columns[i]

    def schema(self) -> StructType:
        names = self.names or [f"c{i}" for i in range(len(self.columns))]
        return StructType([StructField(n, c.dtype)
                           for n, c in zip(names, self.columns)])

    def rename(self, names: List[str]) -> "TorchColumnarBatch":
        return TorchColumnarBatch(self.columns, self.num_rows, list(names))

    def to_pylist(self) -> List[dict]:
        """Host rows as dicts (the reference ``collect()`` shape)."""
        names = self.names or [f"c{i}" for i in range(len(self.columns))]
        cols = [c.to_pylist() for c in self.columns]
        return [dict(zip(names, vals)) for vals in zip(*cols)] if cols \
            else [{} for _ in range(self.num_rows)]

    # ---- host tables ----
    @staticmethod
    def from_numpy_columns(columns: Dict[str, np.ndarray],
                           validity: Optional[Dict[str, np.ndarray]] = None
                           ) -> "TorchColumnarBatch":
        """Name → numpy array (+ optional name → bool validity) → host
        table. Types follow the numpy dtypes; 'S'/'U'/object are strings."""
        validity = validity or {}
        arrays = {k: np.asarray(v) for k, v in columns.items()}
        lens = {len(v) for v in arrays.values()}
        if len(lens) > 1:
            raise ValueError(f"columns differ in length: {sorted(lens)}")
        n = lens.pop() if lens else 0
        cols = []
        for name, vals in arrays.items():
            dtype = from_numpy_dtype(vals.dtype)
            valid = validity.get(name)
            if vals.dtype.kind == "O" and not isinstance(dtype, StringType):
                raise NotImplementedError("object column of non-strings")
            cols.append(TorchColumnVector.from_numpy(dtype, vals, valid,
                                                     capacity=n, bucket=False))
        return TorchColumnarBatch(cols, n, list(arrays))

    @staticmethod
    def from_pylist(rows: List[dict]) -> "TorchColumnarBatch":
        """List of dicts → host table; python int → bigint, float → double,
        str → string, bool → boolean, None → null (pyarrow's inference)."""
        names: List[str] = []
        for r in rows:
            names.extend(k for k in r if k not in names)
        cols, valid = {}, {}
        for name in names:
            vals = [r.get(name) for r in rows]
            kinds = {type(v) for v in vals if v is not None}
            ok = np.array([v is not None for v in vals], np.bool_)
            if kinds <= {bool} and kinds:
                cols[name] = np.array([bool(v) for v in vals], np.bool_)
            elif kinds <= {int}:
                cols[name] = np.array([v or 0 for v in vals], np.int64)
            elif kinds <= {int, float}:
                cols[name] = np.array([0.0 if v is None else float(v)
                                       for v in vals], np.float64)
            elif kinds <= {str}:
                cols[name] = np.array(vals, dtype=object)
            else:
                raise NotImplementedError(
                    f"column {name!r} of {sorted(k.__name__ for k in kinds)} "
                    "not yet ported")
            valid[name] = ok
        return TorchColumnarBatch.from_numpy_columns(cols, valid)

    @staticmethod
    def from_arrow(table) -> "TorchColumnarBatch":
        """Arrow table → host table, read through the Arrow buffers."""
        import pyarrow as pa
        table = table.combine_chunks()
        cols = []
        for name, arr in zip(table.column_names, table.columns):
            arr = arr.combine_chunks() if isinstance(arr, pa.ChunkedArray) \
                else arr
            dtype = from_arrow(arr.type)
            n = len(arr)
            validity = (np.asarray(arr.is_valid()) if arr.null_count
                        else None)
            if isinstance(dtype, StringType):
                if pa.types.is_large_string(arr.type):
                    arr = arr.cast(pa.string())
                bufs = arr.buffers()
                offsets = np.frombuffer(bufs[1], np.int32, n + 1,
                                        arr.offset * 4).copy()
                base = int(offsets[0])
                offsets -= base
                chars = (np.frombuffer(bufs[2], np.uint8, int(offsets[-1]),
                                       base) if offsets[-1] else
                         np.zeros(0, np.uint8))
                cols.append(TorchColumnVector.from_strings(
                    dtype, offsets, chars, validity, capacity=n,
                    bucket=False))
                continue
            if isinstance(dtype, BooleanType):
                vals = np.asarray(arr.fill_null(False)
                                  .to_numpy(zero_copy_only=False))
            elif dtype.np_dtype is None:
                raise NotImplementedError(f"arrow column {arr.type} not yet "
                                          "ported")
            else:
                phys = np.dtype(dtype.np_dtype)
                vals = np.frombuffer(arr.buffers()[1], phys, n,
                                     arr.offset * phys.itemsize)
            cols.append(TorchColumnVector.from_numpy(
                dtype, vals, validity, capacity=n, bucket=False))
        return TorchColumnarBatch(cols, table.num_rows,
                                  list(table.column_names))

    def slice(self, start: int, length: int) -> "TorchColumnarBatch":
        """Rows [start, start+length) of a host table (unpadded)."""
        end = min(start + length, self.num_rows)
        n = max(end - start, 0)
        cols = []
        for c in self.columns:
            v = c.validity[start:end] if c.validity is not None else None
            if c.offsets is not None:
                offs = c.offsets[start:end + 1]
                lo, hi = int(offs[0]), int(offs[-1])
                cols.append(TorchColumnVector(c.dtype, c.data[lo:hi], v, n,
                                              offsets=offs - lo))
            else:
                cols.append(TorchColumnVector(c.dtype, c.data[start:end], v, n))
        return TorchColumnarBatch(cols, n, self.names)

    def to_device(self, device, bucket: bool = True) -> "TorchColumnarBatch":
        """Upload an unpadded host table, padded to the bucket capacity."""
        n = self.num_rows
        cap = bucket_capacity(n, bucket)
        cols = []
        for c in self.columns:
            v = None
            if c.validity is not None:
                v = torch.zeros(cap, dtype=torch.bool, device=device)
                v[:n] = c.validity[:n]
            if c.offsets is not None:
                offs = torch.empty(cap + 1, dtype=torch.int32, device=device)
                offs[: n + 1] = c.offsets[: n + 1]
                offs[n + 1:] = c.offsets[n]
                nbytes = int(c.offsets[n])
                data = torch.zeros(bucket_capacity(max(nbytes, 1), bucket),
                                   dtype=torch.uint8, device=device)
                data[:nbytes] = c.data[:nbytes]
                cols.append(TorchColumnVector(c.dtype, data, v, n,
                                              offsets=offs))
            else:
                data = torch.zeros(cap, dtype=c.data.dtype, device=device)
                data[:n] = c.data[:n]
                cols.append(TorchColumnVector(c.dtype, data, v, n))
        return TorchColumnarBatch(cols, n, self.names)


def compact(batch: TorchColumnarBatch, mask: torch.Tensor
            ) -> TorchColumnarBatch:
    """Keep the rows where ``mask`` (over the capacity) is True, packed to
    the front of a batch of bucketed capacity (reference ``compact``)."""
    keep = mask & torch.arange(batch.capacity, device=mask.device).lt(
        batch.num_rows)
    idx = torch.nonzero(keep).flatten()
    n = int(idx.shape[0])
    cap = bucket_capacity(n)
    dev = mask.device
    cols = []
    for c in batch.columns:
        v = None
        if c.validity is not None:
            v = torch.zeros(cap, dtype=torch.bool, device=dev)
            v[:n] = c.validity[idx]
        if c.offsets is not None:
            starts = c.offsets[:-1][idx].to(torch.int64)
            lens = (c.offsets[1:][idx] - c.offsets[:-1][idx]).to(torch.int64)
            offs = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
            offs[1:n + 1] = torch.cumsum(lens, 0)
            offs[n + 1:] = offs[n]
            total = int(offs[n])
            pos = (torch.arange(total, device=dev)
                   - torch.repeat_interleave(offs[:n], lens)
                   + torch.repeat_interleave(starts, lens))
            data = torch.zeros(bucket_capacity(max(total, 1)),
                               dtype=torch.uint8, device=dev)
            data[:total] = c.data[pos]
            cols.append(TorchColumnVector(c.dtype, data, v, n,
                                          offsets=offs.to(torch.int32)))
        else:
            data = torch.zeros(cap, dtype=c.data.dtype, device=dev)
            data[:n] = c.data[idx]
            cols.append(TorchColumnVector(c.dtype, data, v, n))
    return TorchColumnarBatch(cols, n, batch.names)
