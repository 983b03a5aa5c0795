"""Column vectors backed by torch tensors.

Port of ``TpuColumnVector`` (``spark_rapids_tpu/columnar/vector.py``):
fixed-width data plus a dense bool validity tensor, strings as int32
offsets + uint8 bytes. Every column has a physical ``capacity`` (bucketed to
powers of two) and a logical ``num_rows``; rows in [num_rows, capacity) are
padding, zero-filled and never valid.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..types import DataType, DateType, NullType, StringType, is_fixed_width


def bucket_capacity(n: int, enabled: bool = True, minimum: int = 16) -> int:
    """Round row counts up to power-of-two buckets."""
    if not enabled:
        return max(n, 1)
    cap = minimum
    while cap < n:
        cap <<= 1
    return cap


def row_mask(num_rows: int, capacity: int, device) -> torch.Tensor:
    """True for logical rows, False for padding."""
    return torch.arange(capacity, device=device) < num_rows


class HostStrings(NamedTuple):
    """A host string column already in Arrow layout: int32 offsets [n+1]
    and the uint8 bytes (what the data generator builds, vectorized)."""
    offsets: np.ndarray
    chars: np.ndarray

    def __len__(self) -> int:
        return len(self.offsets) - 1

    @staticmethod
    def concat(parts: Sequence["HostStrings"]) -> "HostStrings":
        offs, base = [np.zeros(1, np.int64)], 0
        for p in parts:
            offs.append(p.offsets[1:].astype(np.int64) + base)
            base += int(p.offsets[-1])
        return HostStrings(np.concatenate(offs).astype(np.int32),
                           np.concatenate([p.chars for p in parts]))


def strings_to_buffers(values: np.ndarray):
    """Host strings → (offsets int32 [n+1], bytes uint8, validity bool or
    None). 'S'/'U' arrays convert vectorised; object arrays (python str or
    None, e.g. from a list of dicts) element by element."""
    n = len(values)
    if values.dtype.kind == "O":
        validity = np.array([v is not None for v in values], dtype=np.bool_)
        enc = [b"" if v is None else
               (v.encode() if isinstance(v, str) else bytes(v)) for v in values]
        lens = np.fromiter((len(e) for e in enc), dtype=np.int64, count=n)
        chars = np.frombuffer(b"".join(enc), dtype=np.uint8)
        offsets = np.zeros(n + 1, np.int32)
        np.cumsum(lens, out=offsets[1:])
        return offsets, chars, (None if validity.all() else validity)
    if values.dtype.kind == "U":
        try:
            values = values.astype("S")
        except UnicodeEncodeError:
            values = np.char.encode(values, "utf-8")
    width = values.dtype.itemsize
    lens = np.char.str_len(values).astype(np.int64) if n else np.zeros(0, np.int64)
    mat = np.ascontiguousarray(values).view(np.uint8).reshape(n, width)
    chars = mat[np.arange(width)[None, :] < lens[:, None]]
    offsets = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=offsets[1:])
    return offsets, chars, None


@dataclass
class TorchColumnVector:
    """One column. fixed-width: ``data`` (capacity,) of the type's carrier;
    string: ``data`` uint8 (char capacity,), ``offsets`` int32
    (capacity + 1,). ``validity`` None means every logical row is valid."""

    dtype: DataType
    data: torch.Tensor
    validity: Optional[torch.Tensor]
    num_rows: int
    offsets: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        if self.offsets is not None:
            return int(self.offsets.shape[0]) - 1
        return int(self.data.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    def validity_or_true(self) -> torch.Tensor:
        if self.validity is not None:
            return self.validity
        return row_mask(self.num_rows, self.capacity, self.device)

    # ---- host materialization ----
    def to_pylist(self) -> List[Any]:
        """Logical values as python objects, None for nulls."""
        n = self.num_rows
        valid = (self.validity[:n].cpu().numpy() if self.validity is not None
                 else np.ones(n, np.bool_))
        if isinstance(self.dtype, NullType):
            return [None] * n
        if isinstance(self.dtype, StringType):
            offs = self.offsets[: n + 1].cpu().numpy().astype(np.int64)
            raw = self.data[: int(offs[-1]) if n else 0].cpu().numpy().tobytes()
            return [raw[offs[i]:offs[i + 1]].decode() if valid[i] else None
                    for i in range(n)]
        vals = self.data[:n].cpu().numpy()
        if isinstance(self.dtype, DateType):
            import datetime
            epoch = datetime.date(1970, 1, 1)
            return [epoch + datetime.timedelta(days=int(v)) if ok else None
                    for v, ok in zip(vals, valid)]
        out = vals.tolist()
        if not valid.all():
            out = [v if ok else None for v, ok in zip(out, valid)]
        return out

    # ---- constructors ----
    @staticmethod
    def from_numpy(dtype: DataType, values: np.ndarray,
                   validity: Optional[np.ndarray] = None,
                   capacity: Optional[int] = None, device="cpu",
                   bucket: bool = True) -> "TorchColumnVector":
        """Host values → column on ``device`` (one copy per buffer; null
        slots are zeroed)."""
        if isinstance(dtype, StringType):
            offsets, chars, v2 = strings_to_buffers(values)
            return TorchColumnVector.from_strings(
                dtype, offsets, chars, validity if validity is not None else v2,
                capacity, device, bucket)
        n = len(values)
        cap = capacity if capacity is not None else bucket_capacity(n, bucket)
        buf = np.zeros(cap, dtype=dtype.np_dtype)
        buf[:n] = values.astype(dtype.np_dtype, copy=False)
        vmask = None
        if validity is not None and not validity.all():
            buf[:n][~validity] = 0
            v = np.zeros(cap, dtype=np.bool_)
            v[:n] = validity
            vmask = torch.from_numpy(v).to(device)
        return TorchColumnVector(dtype, torch.from_numpy(buf).to(device),
                                 vmask, n)

    @staticmethod
    def from_strings(dtype: DataType, offsets: np.ndarray, chars: np.ndarray,
                     validity: Optional[np.ndarray] = None,
                     capacity: Optional[int] = None, device="cpu",
                     bucket: bool = True) -> "TorchColumnVector":
        n = len(offsets) - 1
        cap = capacity if capacity is not None else bucket_capacity(n, bucket)
        nbytes = int(offsets[-1])
        obuf = np.full(cap + 1, nbytes, dtype=np.int32)
        obuf[: n + 1] = offsets
        cbuf = np.zeros(bucket_capacity(max(nbytes, 1), bucket), np.uint8)
        cbuf[:nbytes] = chars[:nbytes]
        vmask = None
        if validity is not None and not validity.all():
            v = np.zeros(cap, dtype=np.bool_)
            v[:n] = validity
            vmask = torch.from_numpy(v).to(device)
        return TorchColumnVector(dtype, torch.from_numpy(cbuf).to(device),
                                 vmask, n,
                                 offsets=torch.from_numpy(obuf).to(device))

    @staticmethod
    def from_scalar(value: Any, dtype: DataType, num_rows: int,
                    capacity: Optional[int] = None,
                    device="cpu") -> "TorchColumnVector":
        cap = capacity if capacity is not None else bucket_capacity(num_rows)
        if isinstance(dtype, StringType):
            vals = np.array([value] * num_rows, dtype=object)
            return TorchColumnVector.from_numpy(dtype, vals, None, cap, device)
        if not is_fixed_width(dtype) and not isinstance(dtype, NullType):
            raise NotImplementedError(f"{dtype} scalar column not yet ported")
        carrier = dtype.torch_dtype or torch.bool
        if value is None:
            return TorchColumnVector(
                dtype, torch.zeros(cap, dtype=carrier, device=device),
                torch.zeros(cap, dtype=torch.bool, device=device), num_rows)
        data = torch.zeros(cap, dtype=carrier, device=device)
        data[:num_rows] = value
        return TorchColumnVector(dtype, data, None, num_rows)


@dataclass(frozen=True)
class TorchScalar:
    """Host-held scalar (reference ``TpuScalar``); value None is null."""
    dtype: DataType
    value: Any

    @property
    def is_null(self) -> bool:
        return self.value is None
