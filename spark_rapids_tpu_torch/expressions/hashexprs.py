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

``xxhash64(...)`` (``XxHash64``, seed 42) is Spark's XXH64 over the same
types, chained column to column as murmur3 is; strings hash over their
bytes on the device: 32-byte stripes, then 8-, 4- and 1-byte tails, all
rows at once, one position a step. Its unsigned 64-bit arithmetic lives in
int64 lanes: products and sums wrap alike mod 2^64, the primes past 2^63
are written as their signed values, and a logical right shift is an
arithmetic one masked to the bits that stay. ``hive_hash(...)``
(``HiveHash``) is Hive's ``31·h + field`` fold in int32 lanes, with
Spark's field hashes (a string's signed bytes, a timestamp's seconds and
nanos). Every path hashes -0.0 as 0.0 and every NaN as Java's canonical
NaN (``floatToIntBits``/``doubleToLongBits``); the reference's host paths
view the raw bits (ROADMAP C-ref). ``md5(s)`` (``Md5``) is host-assisted:
``hashlib`` a row at a time in the counted host hop
(``strings.hostPath``), as in the reference.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..columnar.vector import TorchColumnVector
from ..types import (BooleanType, ByteType, DataType, DateType, DecimalType,
                     DoubleType, FloatType, IntegerT, IntegerType, LongT, LongType,
                     ShortType, StringT, StringType, TimestampType)
from .base import (_DEFAULT_CTX, Expression, UnaryExpression, arrow_column,
                   eval_cpu_on_host_tensors, make_column, to_column)

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


def _bitlen64(x: torch.Tensor) -> torch.Tensor:
    """Bit length of each int64 read as unsigned (0 for 0), by a binary
    search over the shifts."""
    n = torch.zeros_like(x)
    for k in (32, 16, 8, 4, 2, 1):
        hi = (x >> k) & ((1 << (64 - k)) - 1)  # logical shift
        up = hi != 0
        n = n + torch.where(up, k, 0)
        x = torch.where(up, hi, x)
    return n + (x != 0).to(torch.int64)


def decimal_hash_bytes(col: TorchColumnVector) -> TorchColumnVector:
    """A two-limb decimal column as the bytes Spark hashes:
    ``BigInteger.toByteArray()`` of the unscaled value, big-endian
    minimal two's complement (1 to 16 bytes a row), in the string layout
    (offsets + bytes) the byte hashes read."""
    h, l = col.data[:, 0], col.data[:, 1]
    neg = h < 0
    mh, ml = torch.where(neg, ~h, h), torch.where(neg, ~l, l)
    bits = torch.where(mh != 0, 64 + _bitlen64(mh), _bitlen64(ml))
    nbytes = bits // 8 + 1
    shifts = torch.arange(56, -8, -8, device=col.device)
    be = torch.cat([(h[:, None] >> shifts) & 0xFF,
                    (l[:, None] >> shifts) & 0xFF], 1).to(torch.uint8)
    keep = torch.arange(16, device=col.device)[None, :] >= (16 - nbytes)[:, None]
    offs = torch.zeros(col.capacity + 1, dtype=torch.int64, device=col.device)
    offs[1:] = torch.cumsum(nbytes, 0)
    return TorchColumnVector(col.dtype, be[keep], col.validity, col.num_rows,
                offsets=offs.to(torch.int32))


def murmur3_col(col: TorchColumnVector, seed: torch.Tensor) -> torch.Tensor:
    """Hash one column into the running per-row seeds; null rows keep
    their incoming seed (Spark skips nulls). A decimal hashes its
    unscaled long up to precision 18, its ``BigInteger`` bytes past it."""
    dt, d = col.dtype, col.data
    if isinstance(dt, DecimalType):
        h = murmur3_long(d, seed) if not dt.wide else \
            _murmur3_string(decimal_hash_bytes(col), seed)
    elif isinstance(dt, BooleanType):
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


# ---------------------------------------------------------------------------
# XXH64 (Spark's XxHash64) in int64 lanes
# ---------------------------------------------------------------------------


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


_XP1 = _signed64(0x9E3779B185EBCA87)
_XP2 = _signed64(0xC2B2AE3D27D4EB4F)
_XP3 = _signed64(0x165667B19E3779F9)
_XP4 = _signed64(0x85EBCA77C2B2AE63)
_XP5 = _signed64(0x27D4EB2F165667C5)
_XP12 = _signed64((0x9E3779B185EBCA87 + 0xC2B2AE3D27D4EB4F) % (1 << 64))


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 lanes by a constant 1 <= s <= 63."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _rotl64(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _lsr(x, 64 - r)


def _xx_fmix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ _lsr(h, 33)
    h = h * _XP2
    h = h ^ _lsr(h, 29)
    h = h * _XP3
    return h ^ _lsr(h, 32)


def _xx_round(acc: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    return _rotl64(acc + val * _XP2, 31) * _XP1


def xxhash64_int(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Spark's XXH64.hashInt (``v`` any integer tensor; its low 32 bits)."""
    h = seed + (_XP5 + 4)
    h = h ^ ((v.to(torch.int64) & _MASK) * _XP1)
    return _xx_fmix(_rotl64(h, 23) * _XP2 + _XP3)


def xxhash64_long(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Spark's XXH64.hashLong."""
    h = seed + (_XP5 + 8)
    h = h ^ (_rotl64(v.to(torch.int64) * _XP2, 31) * _XP1)
    return _xx_fmix(_rotl64(h, 27) * _XP1 + _XP4)


def _read_word(data: torch.Tensor, at: torch.Tensor, nbytes: int,
               last: int) -> torch.Tensor:
    """Little-endian words of ``nbytes`` bytes at each row's ``at``
    (clamped to the buffer; rows past their string's end are masked by
    the caller)."""
    idx = (at[:, None] + torch.arange(nbytes, device=at.device)[None, :]) \
        .clamp(0, last)
    b = data[idx].to(torch.int64)
    word = b[:, 0]
    for k in range(1, nbytes):
        word = word | (b[:, k] << (8 * k))
    return word


def _xxhash64_string(col: TorchColumnVector, seed: torch.Tensor
                     ) -> torch.Tensor:
    """Spark's XXH64.hashUnsafeBytes of every row at once: the
    four-accumulator 32-byte stripe loop, then the 8-byte words, one
    4-byte word and the last bytes (the longest string is the one host
    read)."""
    offs = col.offsets.to(torch.int64)
    starts, lens = offs[:-1], offs[1:] - offs[:-1]
    max_len = int(lens.max()) if lens.numel() else 0
    last = max(col.data.numel() - 1, 0)
    data = col.data if col.data.numel() else \
        torch.zeros(1, dtype=torch.uint8, device=seed.device)
    v1 = seed + _XP12
    v2 = seed + _XP2
    v3 = seed
    v4 = seed - _XP1
    for s in range(max_len // 32):
        at = starts + 32 * s
        live = lens >= 32 * (s + 1)
        v1 = torch.where(live, _xx_round(v1, _read_word(data, at, 8, last)),
                         v1)
        v2 = torch.where(live, _xx_round(v2, _read_word(data, at + 8, 8,
                                                        last)), v2)
        v3 = torch.where(live, _xx_round(v3, _read_word(data, at + 16, 8,
                                                        last)), v3)
        v4 = torch.where(live, _xx_round(v4, _read_word(data, at + 24, 8,
                                                        last)), v4)
    big = _rotl64(v1, 1) + _rotl64(v2, 7) + _rotl64(v3, 12) + _rotl64(v4, 18)
    for v in (v1, v2, v3, v4):
        big = (big ^ _xx_round(torch.zeros_like(v), v)) * _XP1 + _XP4
    h = torch.where(lens >= 32, big, seed + _XP5) + lens
    pos = torch.div(lens, 32, rounding_mode="floor") * 32
    for _ in range(3):  # a tail under 32 bytes: at most three words
        live = pos + 8 <= lens
        k1 = _read_word(data, starts + pos, 8, last)
        nh = _rotl64(h ^ (_rotl64(k1 * _XP2, 31) * _XP1), 27) * _XP1 + _XP4
        h = torch.where(live, nh, h)
        pos = torch.where(live, pos + 8, pos)
    live = pos + 4 <= lens
    w = _read_word(data, starts + pos, 4, last)
    h = torch.where(live, _rotl64(h ^ (w * _XP1), 23) * _XP2 + _XP3, h)
    pos = torch.where(live, pos + 4, pos)
    for _ in range(3):
        live = pos < lens
        b = data[(starts + pos).clamp(0, last)].to(torch.int64)
        h = torch.where(live, _rotl64(h ^ (b * _XP5), 11) * _XP1, h)
        pos = pos + 1
    return _xx_fmix(h)


def xxhash64_col(col: TorchColumnVector, seed: torch.Tensor) -> torch.Tensor:
    """Hash one column into the running per-row seeds; null rows keep
    their incoming seed."""
    dt, d = col.dtype, col.data
    if isinstance(dt, DecimalType):
        h = xxhash64_long(d, seed) if not dt.wide else \
            _xxhash64_string(decimal_hash_bytes(col), seed)
    elif isinstance(dt, (BooleanType, ByteType, ShortType, IntegerType,
                         DateType)):
        h = xxhash64_int(d.to(torch.int64), seed)
    elif isinstance(dt, (LongType, TimestampType)):
        h = xxhash64_long(d, seed)
    elif isinstance(dt, FloatType):
        f = _normalize_double(d.to(torch.float32))
        h = xxhash64_int(f.view(torch.int32).to(torch.int64), seed)
    elif isinstance(dt, DoubleType):
        h = xxhash64_long(_normalize_double(d).view(torch.int64), seed)
    elif isinstance(dt, StringType):
        h = _xxhash64_string(col, seed)
    else:
        raise NotImplementedError(f"xxhash64 of {dt} not yet ported")
    if col.validity is not None:
        h = torch.where(col.validity, h, seed)
    return h


class XxHash64(Expression):
    """xxhash64(...) (reference ``XxHash64``): Spark's XXH64 row hash of
    the children, a bigint, never null."""

    def __init__(self, *children: Expression, seed: int = 42):
        self.children = tuple(children)
        self.seed = seed

    @property
    def dtype(self) -> DataType:
        return LongT

    @property
    def nullable(self) -> bool:
        return False

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        h = torch.full((batch.capacity,), self.seed, dtype=torch.int64,
                       device=batch.device)
        for c in self.children:
            h = xxhash64_col(to_column(c.eval_device(batch, ctx), batch,
                                       c.dtype), h)
        return make_column(LongT, h, None, batch.num_rows)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return eval_cpu_on_host_tensors(self, table, ctx)

    def pretty(self) -> str:
        return f"xxhash64({', '.join(c.pretty() for c in self.children)})"


# ---------------------------------------------------------------------------
# Hive's hash
# ---------------------------------------------------------------------------


def _hive_long(v: torch.Tensor) -> torch.Tensor:
    """(int)((v >>> 32) ^ v) as uint32 in int64 lanes."""
    return (_lsr(v, 32) ^ v) & _MASK


def _hive_string(col: TorchColumnVector) -> torch.Tensor:
    """Hive's string hash: ``h = 31·h + b`` over the signed bytes, int32
    wrap (uint32 in int64 lanes), one byte position a step."""
    offs = col.offsets.to(torch.int64)
    starts, lens = offs[:-1], offs[1:] - offs[:-1]
    max_len = int(lens.max()) if lens.numel() else 0
    last = max(col.data.numel() - 1, 0)
    data = col.data if col.data.numel() else \
        torch.zeros(1, dtype=torch.uint8, device=offs.device)
    h = torch.zeros_like(starts)
    for k in range(max_len):
        b = data[(starts + k).clamp(0, last)].to(torch.int8).to(torch.int64)
        h = torch.where(k < lens, (h * 31 + b) & _MASK, h)
    return h


def _hive_timestamp(v: torch.Tensor) -> torch.Tensor:
    """Spark's HiveHasher.hashTimestamp: seconds << 30 | nanos, folded."""
    secs = torch.div(v, 1_000_000, rounding_mode="trunc")
    nanos = torch.fmod(v, 1_000_000) * 1000
    return _hive_long((secs << 30) | nanos)


def hive_field_hash(col: TorchColumnVector) -> torch.Tensor:
    """One column's Hive field hash (uint32 in int64 lanes); 0 for
    null."""
    dt, d = col.dtype, col.data
    if isinstance(dt, (BooleanType, ByteType, ShortType, IntegerType,
                       DateType)):
        h = d.to(torch.int64) & _MASK
    elif isinstance(dt, LongType):
        h = _hive_long(d.to(torch.int64))
    elif isinstance(dt, TimestampType):
        h = _hive_timestamp(d.to(torch.int64))
    elif isinstance(dt, FloatType):
        f = _normalize_double(d.to(torch.float32))
        h = f.view(torch.int32).to(torch.int64) & _MASK
    elif isinstance(dt, DoubleType):
        h = _hive_long(_normalize_double(d).view(torch.int64))
    elif isinstance(dt, StringType):
        h = _hive_string(col)
    else:
        raise NotImplementedError(f"hive hash of {dt} not yet ported")
    if col.validity is not None:
        h = torch.where(col.validity, h, torch.zeros_like(h))
    return h


class HiveHash(Expression):
    """hive_hash(...) (reference ``HiveHash``): ``h = 31·h + field`` over
    the children, an int, never null (a null field hashes as 0)."""

    def __init__(self, *children: Expression):
        self.children = tuple(children)

    @property
    def dtype(self) -> DataType:
        return IntegerT

    @property
    def nullable(self) -> bool:
        return False

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        h = torch.zeros(batch.capacity, dtype=torch.int64,
                        device=batch.device)
        for c in self.children:
            col = to_column(c.eval_device(batch, ctx), batch, c.dtype)
            h = (h * 31 + hive_field_hash(col)) & _MASK
        h = torch.where(h >= 1 << 31, h - (1 << 32), h)
        return make_column(IntegerT, h.to(torch.int32), None, batch.num_rows)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return eval_cpu_on_host_tensors(self, table, ctx)

    def pretty(self) -> str:
        return f"hive_hash({', '.join(c.pretty() for c in self.children)})"


class Md5(UnaryExpression):
    """md5(string or binary) → its 32-character hex digest. Host-assisted
    (reference ``Md5``): ``hashlib`` a row at a time, the batch counted in
    ``strings.hostPath``."""

    @property
    def dtype(self) -> DataType:
        return StringT

    @staticmethod
    def _hex(v):
        import hashlib
        if v is None:
            return None
        data = v.encode("utf-8") if isinstance(v, str) else bytes(v)
        return hashlib.md5(data).hexdigest()

    def _digests(self, arr):
        import pyarrow as pa
        return pa.array([self._hex(v) for v in arr.to_pylist()],
                        pa.string())

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        from ..columnar.vector import TorchScalar, column_to_arrow
        from .strings import column_from_arrow, host_path
        c = self.child.eval_device(batch, ctx)
        if isinstance(c, TorchScalar):
            return TorchScalar(StringT, self._hex(c.value))
        host_path(ctx, self, "md5")
        return column_from_arrow(self._digests(column_to_arrow(c)), StringT,
                                 batch)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        from .base import is_arrow
        c = self.child.eval_cpu(table, ctx)
        if not is_arrow(c):
            return self._hex(c)
        return self._digests(arrow_column(c, len(c), self.child.dtype))

    def pretty(self) -> str:
        return f"md5({self.child.pretty()})"
