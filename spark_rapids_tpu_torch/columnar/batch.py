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

from ..types import (BinaryType, BooleanType, StringT, StringType,
                     StructField, StructType, from_arrow, from_numpy_dtype)
from .vector import HostStrings, TorchColumnVector, bucket_capacity


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

    @property
    def nbytes(self) -> int:
        """Bytes of the logical rows as Arrow counts them for a table
        (``pyarrow.Table.nbytes``): the values, four bytes of offsets a
        string row, a validity bitmap where a column has one; booleans are
        bit-packed. The broadcast-versus-shuffle choice reads it."""
        n = self.num_rows
        total = 0
        for c in self.columns:
            if c.validity is not None:
                total += (n + 7) // 8
            if c.offsets is not None:
                total += 4 * n + int(c.offsets[n]) - int(c.offsets[0])
            elif isinstance(c.dtype, BooleanType):
                total += (n + 7) // 8
            else:
                total += n * c.data.element_size()
        return total

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
        """Name → numpy array or ``HostStrings`` (+ optional name → bool
        validity) → host table. Types follow the numpy dtypes; 'S'/'U'/
        object are strings, ``datetime64[D]`` dates."""
        validity = validity or {}
        arrays = {k: v if isinstance(v, HostStrings) else np.asarray(v)
                  for k, v in columns.items()}
        lens = {len(v) for v in arrays.values()}
        if len(lens) > 1:
            raise ValueError(f"columns differ in length: {sorted(lens)}")
        n = lens.pop() if lens else 0
        cols = []
        for name, vals in arrays.items():
            valid = validity.get(name)
            if isinstance(vals, HostStrings):
                cols.append(TorchColumnVector.from_strings(
                    StringT, vals.offsets, vals.chars, valid, capacity=n,
                    bucket=False))
                continue
            dtype = from_numpy_dtype(vals.dtype)
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
            if isinstance(dtype, (StringType, BinaryType)):
                if pa.types.is_large_string(arr.type):
                    arr = arr.cast(pa.string())
                elif pa.types.is_large_binary(arr.type):
                    arr = arr.cast(pa.binary())
                bufs = arr.buffers()
                offsets = np.frombuffer(bufs[1], np.int32, n + 1,
                                        arr.offset * 4).copy() if n \
                    else np.zeros(1, np.int32)
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
                                     arr.offset * phys.itemsize) if n \
                    else np.zeros(0, phys)
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

    def to_host(self) -> "TorchColumnarBatch":
        """The same batch on the CPU (a no-op for a host batch). A string
        column downloads only the bytes its rows use: a gathered column
        keeps its source's byte buffer (``gather``)."""
        cpu = lambda t: None if t is None else t.cpu()  # noqa: E731
        cols = []
        for c in self.columns:
            offsets = cpu(c.offsets)
            data = c.data if offsets is None \
                else c.data[:int(offsets[c.num_rows])]
            cols.append(TorchColumnVector(c.dtype, cpu(data), cpu(c.validity),
                                          c.num_rows, offsets=offsets))
        return TorchColumnarBatch(cols, self.num_rows, self.names)

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


def gather(batch: TorchColumnarBatch, indices: torch.Tensor, out_rows: int,
           out_capacity: Optional[int] = None,
           byte_capacity: Optional[int] = None) -> TorchColumnarBatch:
    """Row gather across all columns (reference ``gather``, cuDF
    ``Table.gather``). ``indices`` is an integer tensor on the batch's
    device; entries past ``out_rows`` are padding, and out-of-range entries
    (e.g. -1) give null rows.

    With distinct indices (a permutation or a subset) a string column's
    bytes fit in the input's byte buffer, so no host sync sizes the output.
    A caller that knows another bound on the output's bytes (a smaller one,
    or a larger one when indices repeat) passes it as ``byte_capacity``."""
    cap = out_capacity if out_capacity is not None \
        else bucket_capacity(out_rows)
    dev = batch.device
    if not batch.capacity:  # nothing to gather from: every row is null
        return TorchColumnarBatch(
            [TorchColumnVector.from_scalar(None, c.dtype, out_rows, cap, dev)
             for c in batch.columns], out_rows, batch.names)
    idx = indices[:cap].to(torch.int64)
    if idx.shape[0] < cap:
        idx = torch.cat([idx, torch.full((cap - idx.shape[0],), -1,
                                         dtype=torch.int64, device=dev)])
    valid_idx = (idx >= 0) & (idx < batch.num_rows)
    mask = valid_idx & (torch.arange(cap, device=dev) < out_rows)
    safe = torch.where(valid_idx, idx, 0)
    cols = []
    for c in batch.columns:
        v = mask if c.validity is None else (c.validity[safe] & mask)
        if c.offsets is None:
            data = torch.where(v, c.data[safe],
                               torch.zeros((), dtype=c.data.dtype, device=dev))
            cols.append(TorchColumnVector(c.dtype, data, v, out_rows))
        else:
            cols.append(_gather_strings(c, safe, v, out_rows, byte_capacity))
    return TorchColumnarBatch(cols, out_rows, batch.names)


def _gather_strings(c: TorchColumnVector, safe: torch.Tensor,
                    valid: torch.Tensor, out_rows: int,
                    byte_capacity: Optional[int] = None) -> TorchColumnVector:
    """Byte gather without a host sync: each output byte finds its row by a
    binary search over the output offsets."""
    dev = c.device
    starts = c.offsets[:-1][safe].to(torch.int64)
    lens = torch.where(valid, c.offsets[1:][safe].to(torch.int64) - starts, 0)
    offs = torch.zeros(safe.shape[0] + 1, dtype=torch.int64, device=dev)
    offs[1:] = torch.cumsum(lens, 0)
    nbytes = c.data.shape[0] if byte_capacity is None \
        else max(byte_capacity, 1)
    pos = torch.arange(nbytes, dtype=torch.int64, device=dev)
    row = torch.searchsorted(offs[1:], pos, right=True).clamp(
        max=safe.shape[0] - 1)
    src = (starts[row] + pos - offs[row]).clamp(0, c.data.shape[0] - 1)
    data = torch.where(pos < offs[-1], c.data[src],
                       torch.zeros((), dtype=torch.uint8, device=dev))
    return TorchColumnVector(c.dtype, data, valid, out_rows,
                             offsets=offs.to(torch.int32))


def slice_batch(batch: TorchColumnarBatch, start: int,
                length: int) -> TorchColumnarBatch:
    """Rows [start, start + length) of a device batch, clipped to its rows
    (reference ``slice_batch``)."""
    n = max(0, min(length, batch.num_rows - start))
    idx = torch.arange(start, start + bucket_capacity(n),
                       device=batch.device)
    return gather(batch, idx, n)


def compact(batch: TorchColumnarBatch, mask: torch.Tensor
            ) -> TorchColumnarBatch:
    """Keep the rows where ``mask`` (over the capacity) is True, packed to
    the front of a batch of bucketed capacity (reference ``compact``); the
    kept row count is the one host sync."""
    keep = mask & torch.arange(batch.capacity, device=mask.device).lt(
        batch.num_rows)
    idx = torch.nonzero(keep).flatten()
    return gather(batch, idx, int(idx.shape[0]))


def concat_batches(batches: List[TorchColumnarBatch]) -> TorchColumnarBatch:
    """Concatenate batches on their device (reference ``concat_batches``).
    String bytes land at device-computed positions, so no host sync reads
    any batch's byte count."""
    if len(batches) == 1:
        return batches[0]
    total = sum(b.num_rows for b in batches)
    cap = bucket_capacity(total)
    dev = batches[0].device
    row_off = np.cumsum([0] + [b.num_rows for b in batches])
    cols = []
    for ci, c0 in enumerate(batches[0].columns):
        parts = [b.columns[ci] for b in batches]
        v = None
        if any(p.validity is not None for p in parts):
            v = torch.zeros(cap, dtype=torch.bool, device=dev)
            for p, off in zip(parts, row_off):
                v[off:off + p.num_rows] = p.validity_or_true()[:p.num_rows]
        if c0.offsets is None:
            data = torch.zeros(cap, dtype=c0.data.dtype, device=dev)
            for p, off in zip(parts, row_off):
                data[off:off + p.num_rows] = p.data[:p.num_rows]
            cols.append(TorchColumnVector(c0.dtype, data, v, total))
            continue
        byte_cap = sum(p.data.shape[0] for p in parts)
        data = torch.zeros(byte_cap + 1, dtype=torch.uint8, device=dev)
        offs = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
        base = torch.zeros((), dtype=torch.int64, device=dev)
        for p, off in zip(parts, row_off):
            n, width = p.num_rows, p.data.shape[0]
            used = p.offsets[n].to(torch.int64)
            at = torch.arange(width, dtype=torch.int64, device=dev)
            # bytes past this batch's last row go to the dump slot
            data[torch.where(at < used, base + at, byte_cap)] = p.data
            offs[off:off + n] = p.offsets[:n].to(torch.int64) + base
            base = base + used
        offs[total:] = base
        cols.append(TorchColumnVector(c0.dtype, data[:max(byte_cap, 1)], v,
                                      total, offsets=offs.to(torch.int32)))
    return TorchColumnarBatch(cols, total, batches[0].names)
