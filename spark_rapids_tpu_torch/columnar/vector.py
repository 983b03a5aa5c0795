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

from ..types import (BinaryType, DataType, DateType, DecimalType, NullType,
                     StringT, StringType, TimestampType, is_fixed_width)


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


# ---------------------------------------------------------------------------
# the audited device→host sync gate (profiling sync ledger; reference
# columnar/vector.py:560-600)
#
# Every explicit BLOCKING device→host transfer of the port routes through
# these helpers: each records itself in the process-wide sync ledger
# (profiling.SyncLedger) under the active operator scope, so a per-batch
# sync shows in the ledger, explain("metrics") and the traced bundle
# instead of only in wall time. The gate records by SITE, whatever the
# tensor's device: on the CPU the tests see the ledger the card sees.
# Torch also syncs inside some ops that are not transfers (boolean-mask
# indexing, nonzero, unique, repeat_interleave without output_size); the
# ledger does not see those, as the reference's does not see XLA's.
# ---------------------------------------------------------------------------


def audited_device_get(tensors: Sequence[Optional[torch.Tensor]],
                       kind: str = "batch") -> List[Optional[torch.Tensor]]:
    """The tensors on the host (None kept), as ONE recorded sync: the first
    copy waits for the queued work, the rest follow it (a whole batch's
    download is one round trip)."""
    from ..profiling import record_sync
    record_sync(kind)
    return [None if t is None else t.cpu() for t in tensors]


def audited_sync_int(value, kind: str = "scalar") -> int:
    """int() of a one-element tensor through the ledger (free for an
    int)."""
    if isinstance(value, (int, np.integer)):
        return int(value)
    from ..profiling import record_sync
    record_sync(kind)
    return int(value.item())


def audited_tolist(value, kind: str = "fetch") -> list:
    """A tensor's values as a Python list through the ledger."""
    from ..profiling import record_sync
    record_sync(kind)
    return value.tolist()


def host_tensors(tensors: Sequence[Optional[torch.Tensor]],
                 kind: Optional[str]) -> List[Optional[torch.Tensor]]:
    """Tensors on the host: through the gate under `kind`; with `kind`
    None the caller holds a host batch, whose CPU tensors need no transfer
    (a device tensor there still downloads through the gate, as
    ``batch``)."""
    if kind is None and all(t is None or t.device.type == "cpu"
                            for t in tensors):
        return list(tensors)
    return audited_device_get(tensors, kind or "batch")


def host_arrays(tensors: Sequence[Optional[torch.Tensor]],
                kind: Optional[str]) -> List[Optional[np.ndarray]]:
    """``host_tensors`` as numpy arrays (host tensors: a view, no copy)."""
    return [None if t is None else t.numpy()
            for t in host_tensors(tensors, kind)]


def lane_mask(mask: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """A row mask shaped to select rows of ``data`` (a two-limb decimal
    column is [n, 2])."""
    return mask.unsqueeze(-1) if data.dim() == 2 and mask.dim() == 1 \
        else mask


# ---------------------------------------------------------------------------
# decimals: the unscaled value, [n] int64 up to precision 18, [n, 2]
# (hi, lo) past it; Arrow's decimal128 is 16 little-endian bytes a row
# ---------------------------------------------------------------------------


def decimal_from_arrow(arr, dtype: DecimalType) -> np.ndarray:
    """An Arrow decimal array's unscaled values in ``dtype``'s carrier,
    read through views of its 16-byte values (null slots zeroed). The
    array must hold ``dtype``'s scale."""
    import pyarrow as pa
    n = len(arr)
    if arr.type != pa.decimal128(dtype.precision, dtype.scale):
        if arr.type.scale != dtype.scale:
            raise ValueError(f"decimal {arr.type} read as {dtype}")
        arr = arr.cast(pa.decimal128(38, dtype.scale))
    words = np.frombuffer(arr.buffers()[1], np.int64, 2 * n,
                          arr.offset * 16).reshape(n, 2) if n \
        else np.zeros((0, 2), np.int64)
    out = words[:, 0].copy() if not dtype.wide else words[:, ::-1].copy()
    if arr.null_count:
        out[~np.asarray(arr.is_valid())] = 0
    return out


def decimal_to_arrow(vals: np.ndarray, dtype: DecimalType,
                     valid: Optional[np.ndarray]):
    """Unscaled values in ``dtype``'s carrier → an Arrow decimal128 array
    (no per-row Python)."""
    import pyarrow as pa
    n = len(vals)
    words = np.empty((n, 2), np.int64)
    if vals.ndim == 2:
        words[:, 0], words[:, 1] = vals[:, 1], vals[:, 0]
    else:
        words[:, 0], words[:, 1] = vals, vals >> 63
    bitmap, nulls = None, 0
    if valid is not None and not valid.all():
        bitmap = pa.py_buffer(np.packbits(valid, bitorder="little").tobytes())
        nulls = int((~valid).sum())
    return pa.Array.from_buffers(
        pa.decimal128(dtype.precision, dtype.scale), n,
        [bitmap, pa.py_buffer(words.tobytes())], null_count=nulls)


def decimal_values(vals: np.ndarray, dtype: DecimalType) -> list:
    """Unscaled carrier values → ``decimal.Decimal`` at the scale."""
    from ..kernels.decimal128 import limbs_to_int, scaled_decimal
    if vals.ndim == 2:
        ints = [limbs_to_int(h, l) for h, l in vals.tolist()]
    else:
        ints = vals.tolist()
    return [scaled_decimal(v, dtype.scale) for v in ints]


def decimal_carrier(value, dtype: DecimalType):
    """A Python Decimal (or int) as ``dtype``'s carrier value: an int, or
    a [hi, lo] list past precision 18."""
    from ..kernels.decimal128 import int_to_limbs, unscaled_int
    u = unscaled_int(value, dtype.scale)
    return list(int_to_limbs(u)) if dtype.wide else u


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
    def to_pylist(self, kind: Optional[str] = "fetch") -> List[Any]:
        """Logical values as python objects, None for nulls; downloaded
        through the sync gate under `kind` (None: a host column)."""
        n = self.num_rows
        if isinstance(self.dtype, NullType):
            return [None] * n
        v = None if self.validity is None else self.validity[:n]
        if isinstance(self.dtype, (StringType, BinaryType)):
            valid, offs = host_arrays([v, self.offsets[: n + 1]], kind)
            offs = offs.astype(np.int64)
            raw = host_arrays([self.data[: int(offs[-1]) if n else 0]],
                              kind and "chars")[0].tobytes()
            valid = np.ones(n, np.bool_) if valid is None else valid
            text = isinstance(self.dtype, StringType)
            return [(raw[offs[i]:offs[i + 1]].decode() if text
                     else raw[offs[i]:offs[i + 1]]) if valid[i] else None
                    for i in range(n)]
        valid, vals = host_arrays([v, self.data[:n]], kind)
        valid = np.ones(n, np.bool_) if valid is None else valid
        if isinstance(self.dtype, DecimalType):
            return [d if ok else None for d, ok in
                    zip(decimal_values(vals, self.dtype), valid)]
        if isinstance(self.dtype, DateType):
            import datetime
            epoch = datetime.date(1970, 1, 1)
            return [epoch + datetime.timedelta(days=int(v)) if ok else None
                    for v, ok in zip(vals, valid)]
        if isinstance(self.dtype, TimestampType):
            import datetime
            epoch = datetime.datetime(1970, 1, 1,
                                      tzinfo=datetime.timezone.utc)
            return [epoch + datetime.timedelta(microseconds=int(v))
                    if ok else None for v, ok in zip(vals, valid)]
        out = vals.tolist()  # a host array: no transfer
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
        buf = np.zeros((cap,) + values.shape[1:], dtype=dtype.np_dtype)
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
            return TorchColumnVector._repeated_string(value, num_rows, cap,
                                                      device)
        if not is_fixed_width(dtype) and not isinstance(dtype, NullType):
            raise NotImplementedError(f"{dtype} scalar column not yet ported")
        carrier = dtype.torch_dtype or torch.bool
        shape = (cap, 2) if isinstance(dtype, DecimalType) and dtype.wide \
            else (cap,)
        if value is None:
            return TorchColumnVector(
                dtype, torch.zeros(shape, dtype=carrier, device=device),
                torch.zeros(cap, dtype=torch.bool, device=device), num_rows)
        if isinstance(dtype, DecimalType):
            value = torch.tensor(decimal_carrier(value, dtype),
                                 dtype=carrier, device=device)
        data = torch.zeros(shape, dtype=carrier, device=device)
        data[:num_rows] = value
        return TorchColumnVector(dtype, data, None, num_rows)


    @staticmethod
    def _repeated_string(value: Optional[str], num_rows: int, cap: int,
                         device) -> "TorchColumnVector":
        """A string literal on every row, built on ``device`` (offsets a
        multiple of its length, its bytes tiled); null: empty strings, no
        row valid."""
        raw = b"" if value is None else value.encode()
        k = len(raw)
        offs = (torch.arange(cap + 1, dtype=torch.int64, device=device)
                .clamp(max=num_rows) * k).to(torch.int32)
        data = torch.zeros(bucket_capacity(max(num_rows * k, 1)),
                           dtype=torch.uint8, device=device)
        if k and num_rows:
            word = torch.tensor(list(raw), dtype=torch.uint8, device=device)
            data[:num_rows * k] = word.repeat(num_rows)
        validity = None if value is not None else \
            torch.zeros(cap, dtype=torch.bool, device=device)
        return TorchColumnVector(StringT, data, validity, num_rows,
                                 offsets=offs)


@dataclass(frozen=True)
class TorchScalar:
    """Host-held scalar (reference ``TpuScalar``); value None is null."""
    dtype: DataType
    value: Any

    @property
    def is_null(self) -> bool:
        return self.value is None


def column_to_arrow(col: TorchColumnVector, kind: Optional[str] = "fetch"):
    """A column's logical rows as an Arrow array (the host hop's
    download: offsets, bytes and validity, no per-row Python), through the
    sync gate under `kind` (None: a host column)."""
    import pyarrow as pa
    n = col.num_rows
    if isinstance(col.dtype, NullType):
        return pa.nulls(n)
    v = None if col.validity is None else col.validity[:n]
    if col.offsets is not None:
        valid, offs = host_arrays([v, col.offsets[:n + 1]], kind)
        offs = offs.astype(np.int64)
        base = int(offs[0])
        offs = (offs - base).astype(np.int32)
        nb = int(offs[-1])
        data = host_arrays([col.data[base:base + nb]],
                           kind and "chars")[0] if nb else \
            np.zeros(0, np.uint8)
        if valid is not None and valid.all():
            valid = None
        bitmap = None if valid is None else pa.py_buffer(
            np.packbits(valid, bitorder="little").tobytes())
        at = pa.binary() if isinstance(col.dtype, BinaryType) else pa.string()
        return pa.Array.from_buffers(
            at, n, [bitmap, pa.py_buffer(offs.tobytes()),
                    pa.py_buffer(data.tobytes())],
            null_count=0 if valid is None else int((~valid).sum()))
    valid, vals = host_arrays([v, col.data[:n]], kind)
    if valid is not None and valid.all():
        valid = None
    mask = None if valid is None else ~valid
    if isinstance(col.dtype, DateType):
        return pa.array(vals.astype(np.int32), type=pa.date32(), mask=mask)
    if isinstance(col.dtype, TimestampType):
        return pa.array(vals.astype(np.int64), type=pa.timestamp("us"),
                        mask=mask)
    if isinstance(col.dtype, DecimalType):
        return decimal_to_arrow(vals, col.dtype, valid)
    return pa.array(vals, mask=mask)
