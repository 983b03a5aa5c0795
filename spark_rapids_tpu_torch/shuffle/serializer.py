"""Block checksums: the port's copy of ``xxhash64_bytes`` from
``spark_rapids_tpu/shuffle/serializer.py``. The spill catalog checksums its
disk files with it. The reference's Arrow IPC framing and codecs belong to
the ``MULTITHREADED`` shuffle, which is not yet ported."""

from __future__ import annotations

import struct

# XXH64 primes. Host-bytes variant tuned for large buffers: one
# struct.unpack of the whole lane region, then plain-int arithmetic
_M64 = (1 << 64) - 1
_XP1 = 0x9E3779B185EBCA87
_XP2 = 0xC2B2AE3D27D4EB4F
_XP3 = 0x165667B19E3779F9
_XP4 = 0x85EBCA77C2B2AE63
_XP5 = 0x27D4EB2F165667C5


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


try:  # optional C accelerator; the pure-python path below is the
    # always-available fallback
    import xxhash as _xxh_native
except ImportError:
    _xxh_native = None


def xxhash64_bytes(data: bytes, seed: int = 0) -> int:
    """Standard XXH64 over a byte buffer (Spark's XXH64)."""
    if _xxh_native is not None:
        return _xxh_native.xxh64_intdigest(data, seed)
    n = len(data)
    i = 0
    if n >= 32:
        v1 = (seed + _XP1 + _XP2) & _M64
        v2 = (seed + _XP2) & _M64
        v3 = seed & _M64
        v4 = (seed - _XP1) & _M64
        stripes = (n - i) // 32
        lanes = struct.unpack_from(f"<{stripes * 4}Q", data, i)
        # hot loop: rotl/mask inlined — half a million function calls per
        # MiB otherwise dominate the hash time
        for w1, w2, w3, w4 in zip(lanes[0::4], lanes[1::4], lanes[2::4],
                                  lanes[3::4]):
            v1 = (v1 + w1 * _XP2) & _M64
            v1 = (((v1 << 31) | (v1 >> 33)) & _M64) * _XP1 & _M64
            v2 = (v2 + w2 * _XP2) & _M64
            v2 = (((v2 << 31) | (v2 >> 33)) & _M64) * _XP1 & _M64
            v3 = (v3 + w3 * _XP2) & _M64
            v3 = (((v3 << 31) | (v3 >> 33)) & _M64) * _XP1 & _M64
            v4 = (v4 + w4 * _XP2) & _M64
            v4 = (((v4 << 31) | (v4 >> 33)) & _M64) * _XP1 & _M64
        i += stripes * 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12)
             + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ ((_rotl((v * _XP2) & _M64, 31) * _XP1) & _M64))
                 * _XP1 + _XP4) & _M64
    else:
        h = (seed + _XP5) & _M64
    h = (h + n) & _M64
    while i <= n - 8:
        (w,) = struct.unpack_from("<Q", data, i)
        h = (h ^ ((_rotl((w * _XP2) & _M64, 31) * _XP1) & _M64)) & _M64
        h = (_rotl(h, 27) * _XP1 + _XP4) & _M64
        i += 8
    if i <= n - 4:
        (w,) = struct.unpack_from("<I", data, i)
        h = (h ^ (w * _XP1)) & _M64
        h = (_rotl(h, 23) * _XP2 + _XP3) & _M64
        i += 4
    while i < n:
        h = (h ^ (data[i] * _XP5)) & _M64
        h = (_rotl(h, 11) * _XP1) & _M64
        i += 1
    h ^= h >> 33
    h = (h * _XP2) & _M64
    h ^= h >> 29
    h = (h * _XP3) & _M64
    h ^= h >> 32
    return h
