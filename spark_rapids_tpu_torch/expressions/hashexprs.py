"""Spark's Murmur3 x86_32 hash, seed 42 (port of ``murmur3_int``,
``murmur3_long``, ``_normalize_double``, ``murmur3_col`` and
``murmur3_batch`` from ``spark_rapids_tpu/expressions/hashexprs.py``), and
the ``hash(...)`` expression over them, ``Murmur3Hash``.

It is the shuffle's partitioning hash: partition ids decide which rows meet
in which partition, so the result must be bit-identical to the reference
(and to Spark). torch has no usable unsigned 32-bit arithmetic on CUDA, so
every uint32 lives in the low 32 bits of an int64 (values in [0, 2^32)):
products split into 16-bit halves so nothing overflows, and a right shift
of a non-negative int64 is the logical shift the hash needs.

On the host (``Murmur3Hash.eval_cpu``, and the host engine's hash
exchange through ``host_partition_ids``) the same functions run over CPU
tensors read from the Arrow rows, so the host's bits are the card's by
construction: a host side and a device side of one join co-partition.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..columnar.vector import TorchColumnVector
from ..types import (BooleanType, ByteType, DataType, DateType, DoubleType,
                     FloatType, IntegerT, IntegerType, LongType, ShortType,
                     StringType, TimestampType)
from .base import (_DEFAULT_CTX, Expression, arrow_column, make_column,
                   to_column)

_MASK = 0xFFFFFFFF
_C1 = 0xCC9E2D51
_C2 = 0x1B873593


def _mul(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def _mix_k1(k1: torch.Tensor) -> torch.Tensor:
    return _mul(_rotl(_mul(k1, _C1), 15), _C2)


def _mix_h1(h1: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    h1 = _rotl(h1 ^ k1, 13)
    return (_mul(h1, 5) + 0xE6546B64) & _MASK


def _fmix(h1: torch.Tensor, length) -> torch.Tensor:
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = _mul(h1, 0x85EBCA6B)
    h1 = h1 ^ (h1 >> 13)
    h1 = _mul(h1, 0xC2B2AE35)
    return h1 ^ (h1 >> 16)


def murmur3_int(values_u32: torch.Tensor, seed_u32: torch.Tensor
                ) -> torch.Tensor:
    """Spark hashInt: one 4-byte block (uint32 values in int64 lanes)."""
    return _fmix(_mix_h1(seed_u32, _mix_k1(values_u32)), 4)


def murmur3_long(values_i64: torch.Tensor, seed_u32: torch.Tensor
                 ) -> torch.Tensor:
    """Spark hashLong: the low word, then the high word."""
    lo = values_i64 & _MASK
    hi = (values_i64 >> 32) & _MASK
    h1 = _mix_h1(seed_u32, _mix_k1(lo))
    return _fmix(_mix_h1(h1, _mix_k1(hi)), 8)


def _normalize_double(d: torch.Tensor) -> torch.Tensor:
    """Spark hashes -0.0 as 0.0 and every NaN as the canonical NaN."""
    d = torch.where(d == 0.0, torch.zeros((), dtype=d.dtype,
                                          device=d.device), d)
    return torch.where(torch.isnan(d), torch.full((), float("nan"),
                                                  dtype=d.dtype,
                                                  device=d.device), d)


def _murmur3_string(col: TorchColumnVector, seed: torch.Tensor
                    ) -> torch.Tensor:
    """Spark hashUnsafeBytes: 4-byte little-endian blocks, then each tail
    byte as its own block of its SIGNED value; all rows at once, one block
    position a step (the longest string is the one host read)."""
    offs = col.offsets.to(torch.int64)
    starts, lens = offs[:-1], offs[1:] - offs[:-1]
    max_len = int(lens.max()) if lens.numel() else 0
    last = max(col.data.numel() - 1, 0)
    data = col.data if col.data.numel() else \
        torch.zeros(1, dtype=torch.uint8, device=seed.device)
    h1 = seed
    for b in range(max_len // 4):
        word = torch.zeros_like(h1)
        for k in range(4):
            byte = data[(starts + 4 * b + k).clamp(max=last)].to(torch.int64)
            word = word | (byte << (8 * k))
        h1 = torch.where(lens >= 4 * (b + 1), _mix_h1(h1, _mix_k1(word)), h1)
    for t in range(3):
        pos = (lens // 4) * 4 + t
        byte = data[(starts + pos).clamp(max=last)].to(torch.int8)
        signed = byte.to(torch.int64) & _MASK
        h1 = torch.where(pos < lens, _mix_h1(h1, _mix_k1(signed)), h1)
    return _fmix(h1, lens & _MASK)


def murmur3_col(col: TorchColumnVector, seed: torch.Tensor) -> torch.Tensor:
    """Hash one column into the running per-row seeds; null rows keep
    their incoming seed (Spark skips nulls)."""
    dt, d = col.dtype, col.data
    if isinstance(dt, BooleanType):
        h = murmur3_int(d.to(torch.int64), seed)
    elif isinstance(dt, (ByteType, ShortType, IntegerType, DateType)):
        h = murmur3_int(d.to(torch.int64) & _MASK, seed)
    elif isinstance(dt, (LongType, TimestampType)):
        h = murmur3_long(d.to(torch.int64), seed)
    elif isinstance(dt, FloatType):
        f = _normalize_double(d.to(torch.float32))
        h = murmur3_int(f.view(torch.int32).to(torch.int64) & _MASK, seed)
    elif isinstance(dt, DoubleType):
        h = murmur3_long(_normalize_double(d).view(torch.int64), seed)
    elif isinstance(dt, StringType):
        h = _murmur3_string(col, seed)
    else:
        raise NotImplementedError(f"murmur3 of {dt} not yet ported")
    if col.validity is not None:
        h = torch.where(col.validity, h, seed)
    return h


def murmur3_batch(cols: Sequence[TorchColumnVector], capacity: int,
                  seed: int = 42) -> torch.Tensor:
    """Spark's row hash over several columns (each column's hash seeds the
    next), as int32 values in an int64 tensor."""
    dev = cols[0].device
    h = torch.full((capacity,), seed, dtype=torch.int64, device=dev)
    for c in cols:
        h = murmur3_col(c, h)
    return torch.where(h >= 1 << 31, h - (1 << 32), h)


class Murmur3Hash(Expression):
    """hash(...) (reference ``Murmur3Hash``): Spark's row hash of the
    children, an int, never null (a null child leaves the running seed)."""

    def __init__(self, *children: Expression, seed: int = 42):
        self.children = tuple(children)
        self.seed = seed

    @property
    def dtype(self) -> DataType:
        return IntegerT

    @property
    def nullable(self) -> bool:
        return False

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        cols = [to_column(c.eval_device(batch, ctx), batch, c.dtype)
                for c in self.children]
        h = murmur3_batch(cols, batch.capacity, self.seed)
        return make_column(IntegerT, h.to(torch.int32), None, batch.num_rows)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        import pyarrow as pa
        n = table.num_rows
        h = murmur3_arrow([arrow_column(c.eval_cpu(table, ctx), n, c.dtype)
                           for c in self.children],
                          [c.dtype for c in self.children], n, self.seed)
        # a host tensor (eval_cpu): no device transfer
        return pa.array(h.to(torch.int32).numpy())


def murmur3_arrow(arrays, dtypes, n: int, seed: int = 42) -> torch.Tensor:
    """Spark's row hash of Arrow columns on the host (int32 values in an
    int64 CPU tensor): each column read into a CPU column, then
    ``murmur3_batch``, the device's own code."""
    from ..columnar.batch import TorchColumnarBatch
    import pyarrow as pa
    if not arrays:
        return torch.full((n,), seed, dtype=torch.int64)
    t = pa.Table.from_arrays(list(arrays),
                             names=[f"k{i}" for i in range(len(arrays))])
    cols = TorchColumnarBatch.from_arrow(t).columns
    cols = [c if c.dtype == dt else type(c)(dt, c.data, c.validity,
                                               c.num_rows, c.offsets)
            for c, dt in zip(cols, dtypes)]
    return murmur3_batch(cols, n, seed)[:n]
