"""Device-side parquet decode: the host stages raw page bytes, the device
decodes them (port of ``spark_rapids_tpu/io/device_decode.py``).

The host does the O(pages) + O(runs) work only:

* the footer and row-group metadata (pyarrow's ``ParquetFile``), a minimal
  Thrift-compact page-header walk, page decompression (``pa.Codec``), and
  the RLE / bit-packed hybrid run-header walk, plus the per-page non-null
  counts that place runs in the dense value stream;
* BYTE_ARRAY pages: the 4-byte PLAIN length prefixes walk into (start,
  length) tables by vectorized pointer doubling, dictionary pages ship the
  raw dictionary bytes and an index histogram, so the exact byte total of
  the output is known on the host.

Every O(rows) transform runs on the device through
``kernels/parquet_decode.py``: bit unpacking, run expansion, dictionary
gathers, definition levels → validity, null expansion into the padded
batch layout, the PLAIN bit views, and strings into the port's offsets +
bytes layout. A row group's staged buffers go up in one host-to-device
copy (from a pinned, double-buffered staging area on the card), and one
decode program a row group runs them (``decode_program``; eager torch, so
nothing is compiled or cached).

Columns the device decode does not cover (nested, INT96,
FIXED_LEN_BYTE_ARRAY, non-microsecond timestamps, other encodings, a
string chunk that mixes dictionary and PLAIN pages) decode on the host
with pyarrow for that column only and join the same batch. The host-side
structural checks (thrift bounds, decompressed sizes, value-region
lengths, row counts) turn a corrupt or truncated page into a
``DeviceDecodeError``, which re-reads that row group on the host. Every
such demotion is counted (``fallback_columns``, ``fallback_row_groups``,
``fallback_files`` in ``decode_stats()`` and in the session's counters).
An error of the device program itself propagates. Encrypted files raise
``ParquetEncryptedException`` with the reference's message.

The reference also surfaces a string column's parquet dictionary as a
device ``dict_encoding``; that waits for a later slice (results do not
depend on it).
"""

from __future__ import annotations

import struct
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..columnar.vector import (TorchColumnVector, audited_device_get,
                               bucket_capacity)
from ..obs import tracer as _obs
from ..kernels.parquet_decode import RUN_COLS, RUN_PAD_START, RUN_START
from ..types import (BinaryType, BooleanType, ByteType, DataType, DateType,
                     DecimalType, DoubleType, FloatType, IntegerType,
                     LongType, ShortType, StringType, TimestampType,
                     from_arrow as arrow_to_type, to_arrow as type_to_arrow)


class ParquetEncryptedException(RuntimeError):
    """Encrypted parquet input: neither the device decode nor the host
    read supports it (reference GpuParquetScan.scala:590)."""


class DeviceDecodeError(RuntimeError):
    """This file, row group or column cannot decode on the device; the scan
    reads it on the host with identical results, and counts it."""


def import_pyarrow():
    """pyarrow, which the scan's host side needs (footer, codecs, the host
    reads); an error that names it where it does not import."""
    try:
        import pyarrow
        import pyarrow.parquet  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "the parquet scan needs pyarrow (footer, page codecs and host "
            f"reads), which does not import here: {e}") from e
    return pyarrow


# ---------------------------------------------------------------------------
# decode and fallback accounting
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_STATS: Dict[str, int] = {
    "dispatches": 0,           # decode programs run: one a row group
    "row_groups": 0,
    "rows": 0,
    "bytes_staged": 0,         # raw page bytes copied to the device
    "device_columns": 0,
    "fallback_columns": 0,     # per-column host decodes
    "fallback_row_groups": 0,  # row groups re-read on the host
    "fallback_files": 0,       # files read on the host
}

#: the demotion counters a session also keeps (``TorchSession.counters``)
FALLBACK_KEYS = ("fallback_columns", "fallback_row_groups", "fallback_files")


def decode_stats() -> Dict[str, int]:
    with _LOCK:
        return dict(_STATS)


def bump(key: str, n: int = 1, counters=None) -> None:
    """Count process-wide and, for the demotions, in the session's
    counters."""
    with _LOCK:
        _STATS[key] += n
    if counters is not None and key in FALLBACK_KEYS:
        counters[key] += n


class ScanTimes:
    """The scan's time split: host spans on the host clock, device spans
    (the staged upload and the decode program) by CUDA events, read once
    when the scan ends (no sync in between). Totals land in the session's
    counters as ``scan.<name>Ms``."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.host_ms: Dict[str, float] = {}
        self._events: List[Tuple[str, Any, Any]] = []

    @contextmanager
    def host(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.host_ms[name] = self.host_ms.get(name, 0.0) + \
                (time.perf_counter() - t0) * 1e3

    @contextmanager
    def device(self, name: str):
        if not self.cuda:
            with self.host(name):
                yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            self._events.append((name, start, end))

    #: the scan operator's time metric (ns) of each span, as the
    #: reference's TpuFileSourceScanExec names it
    METRICS = {"stage": "scanTime", "upload": "uploadTime",
               "deviceDecode": "decodeTime", "hostDecode": "hostDecodeTime"}

    def flush(self, counters, metrics=None) -> None:
        """Add every span to ``counters`` (ms) and, one reading each, to
        the scan operator's `metrics` (ns); forget them."""
        if self._events:
            self._events[-1][2].synchronize()
        spans = [(name, start.elapsed_time(end))
                 for name, start, end in self._events]
        spans += list(self.host_ms.items())
        for name, ms in spans:
            counters[f"scan.{name}Ms"] += ms
            if metrics is not None and name in self.METRICS:
                metrics[self.METRICS[name]].add(int(ms * 1e6))
        self._events.clear()
        self.host_ms.clear()


# ---------------------------------------------------------------------------
# minimal Thrift compact-protocol reader (parquet page headers + footer).
# Bounds violations raise IndexError/struct.error; callers convert them to
# DeviceDecodeError, so a truncated or corrupt page heals on the host.
# ---------------------------------------------------------------------------


def _varint(buf, pos: int) -> Tuple[int, int]:
    out = sh = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << sh
        if not (b & 0x80):
            return out, pos
        sh += 7
        if sh > 63:
            raise ValueError("varint overflow")


def _zigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def _read_value(buf, pos: int, ctype: int):
    if ctype == 1:
        return True, pos
    if ctype == 2:
        return False, pos
    if ctype == 3:
        return buf[pos], pos + 1
    if ctype in (4, 5, 6):  # i16/i32/i64
        v, pos = _varint(buf, pos)
        return _zigzag(v), pos
    if ctype == 7:  # double
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if ctype == 8:  # binary
        n, pos = _varint(buf, pos)
        if n < 0 or pos + n > len(buf):
            raise ValueError("binary field out of bounds")
        return bytes(buf[pos:pos + n]), pos + n
    if ctype in (9, 10):  # list/set
        h = buf[pos]
        pos += 1
        n, et = h >> 4, h & 0x0F
        if n == 15:
            n, pos = _varint(buf, pos)
        out = []
        for _ in range(n):
            v, pos = _read_value(buf, pos, et)
            out.append(v)
        return out, pos
    if ctype == 11:  # map
        n, pos = _varint(buf, pos)
        if n == 0:
            return {}, pos
        h = buf[pos]
        pos += 1
        out = {}
        for _ in range(n):
            k, pos = _read_value(buf, pos, h >> 4)
            v, pos = _read_value(buf, pos, h & 0x0F)
            out[k] = v
        return out, pos
    if ctype == 12:
        return _read_struct(buf, pos)
    raise ValueError(f"thrift compact type {ctype}")


def _read_struct(buf, pos: int) -> Tuple[Dict[int, Any], int]:
    """Generic struct → {field id: value}; unknown fields parse and keep."""
    fields: Dict[int, Any] = {}
    fid = 0
    while True:
        h = buf[pos]
        pos += 1
        if h == 0:
            return fields, pos
        delta, ctype = h >> 4, h & 0x0F
        if delta:
            fid += delta
        else:
            v, pos = _varint(buf, pos)
            fid = _zigzag(v)
        val, pos = _read_value(buf, pos, ctype)
        fields[fid] = val


# ---------------------------------------------------------------------------
# encrypted-parquet detection (reference GpuParquetScan.scala:590)
# ---------------------------------------------------------------------------

_MAGIC_PLAIN = b"PAR1"
_MAGIC_ENCRYPTED = b"PARE"
#: parquet.thrift FileMetaData field 8 = encryption_algorithm (plaintext
#: footer mode: the footer parses but column chunks are encrypted)
_FMD_ENCRYPTION_ALGORITHM = 8


def detect_encryption(path: str) -> Optional[str]:
    """Return a human-readable reason when `path` is an encrypted parquet
    file (encrypted-footer PARE magic, or plaintext-footer crypto
    metadata), None for ordinary files. Unreadable/short files return None —
    later stages produce their own errors."""
    import os
    try:
        size = os.path.getsize(path)
        if size < 12:
            return None
        with open(path, "rb") as f:
            f.seek(size - 8)
            tail = f.read(8)
            if tail[4:] == _MAGIC_ENCRYPTED:
                return "encrypted footer (PARE magic)"
            if tail[4:] != _MAGIC_PLAIN:
                return None
            flen = struct.unpack("<I", tail[:4])[0]
            if flen <= 0 or flen > size - 8:
                return None
            f.seek(size - 8 - flen)
            footer = f.read(flen)
        fmd, _ = _read_struct(footer, 0)
        if _FMD_ENCRYPTION_ALGORITHM in fmd:
            return ("columns encrypted with plaintext footer "
                    "(encryption_algorithm set)")
    except Exception:  # noqa: BLE001 — detection must never mask real reads
        return None
    return None


def encrypted_message(path: str, reason: str) -> str:
    """Reference message semantics: name the file, the reason, and the CPU
    fallback (GpuParquetScan.scala:590 'The GPU does not support reading
    encrypted Parquet files')."""
    return (f"The GPU does not support reading encrypted Parquet files: "
            f"{path} is encrypted ({reason}). To read this file, fall back "
            f"to the CPU by setting spark.rapids.sql.enabled=false (or "
            f"spark.rapids.sql.format.parquet.enabled=false) and configure "
            f"decryption keys for the CPU reader.")


# ---------------------------------------------------------------------------
# RLE / bit-packed hybrid run-header walk (host: O(runs), tiny)
# ---------------------------------------------------------------------------



def _walk_runs(data, start: int, end: int, bw: int, n: int,
               out_base: int, bit_base: int) -> List[List[int]]:
    """Walk hybrid run headers in data[start:end) covering `n` values.
    Returns run-table rows [out_start, abs_bitoff, value, literal, width]
    with output positions offset by `out_base` and literal bit offsets by
    `bit_base` (both in the staged, concatenated buffers)."""
    runs: List[List[int]] = []
    out = 0
    vbytes = (bw + 7) // 8
    pos = start
    while out < n and pos < end:
        h, pos = _varint(data, pos)
        if h & 1:  # bit-packed literal groups of 8
            cnt = (h >> 1) * 8
            if cnt <= 0:
                raise ValueError("zero-length literal run")
            runs.append([out_base + out, bit_base + (pos - start) * 8,
                         0, 1, bw])
            pos += (cnt * bw + 7) // 8
        else:
            cnt = h >> 1
            if cnt <= 0:
                raise ValueError("zero-length RLE run")
            if pos + vbytes > end:
                raise ValueError("RLE run value out of bounds")
            v = int.from_bytes(data[pos:pos + vbytes], "little") \
                if vbytes else 0
            pos += vbytes
            runs.append([out_base + out, 0, v, 0, 0])
        out += cnt
    if out < n:
        raise ValueError(f"runs cover {out} of {n} values")
    return runs


def _literal_values(data, lit_pos: List[int], lit_take: List[int],
                    bw: int) -> np.ndarray:
    """The values of bit-packed literal runs (byte position, values taken)
    of width ``bw``, in one vectorized pass over the region's bits. A run
    that reaches past the region raises IndexError."""
    takes = np.asarray(lit_take, np.int64)
    total = int(takes.sum())
    if not total or not bw:
        return np.zeros(total, np.int64)
    first = np.cumsum(takes) - takes
    at = np.repeat(np.asarray(lit_pos, np.int64) * 8, takes) + (
        np.arange(total, dtype=np.int64) - np.repeat(first, takes)) * bw
    bits = np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little")
    vals = np.zeros(total, np.int64)
    for b in range(bw):
        vals |= bits[at + b].astype(np.int64) << b
    return vals


def _count_valid(data, start: int, end: int, n: int) -> int:
    """Non-null count of one page's definition levels (bit width 1: flat
    columns only) without expanding them: RLE runs count directly, the
    literal runs' bits sum in one vectorized pass."""
    total = 0
    out = 0
    pos = start
    lit_pos: List[int] = []
    lit_take: List[int] = []
    while out < n and pos < end:
        h, pos = _varint(data, pos)
        if h & 1:
            cnt = (h >> 1) * 8
            lit_pos.append(pos)
            lit_take.append(min(cnt, n - out))
            pos += (cnt + 7) // 8
        else:
            cnt = h >> 1
            v = data[pos]
            pos += 1
            if v:
                total += min(cnt, n - out)
        out += cnt
    return total + int(_literal_values(data, lit_pos, lit_take, 1).sum())


def _byte_array_starts(region: np.ndarray,
                       n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Value start positions + byte lengths of `n` length-prefixed
    BYTE_ARRAY values in `region` (a PLAIN data-page value region or a
    dictionary page), without a per-value Python loop: the next-value map
    (pos → pos + 4 + le32(pos)) is built for every byte position
    vectorized, then the set of value starts doubles each pass (pointer
    jumping: after pass k the first 2^k starts are known — log2(n)
    vectorized gathers total). A chain that runs out of bounds (bogus
    length, truncated region) raises ValueError."""
    if n <= 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    m = len(region)
    if m < 4:
        raise ValueError("BYTE_ARRAY region too short")
    r = region.astype(np.int64)
    le = r[: m - 3] | (r[1: m - 2] << 8) | (r[2: m - 1] << 16) \
        | (r[3:] << 24)
    # positions past m-4 have no readable prefix: they map to the sentinel
    # m, where the jump table is a fixed point — a broken chain parks there
    nxt = np.minimum(np.arange(m - 3, dtype=np.int64) + 4 + le, m)
    nxt = np.concatenate([nxt, np.full(4, m, np.int64)])  # index m valid
    starts = np.zeros(1, np.int64)
    jump = nxt
    while len(starts) < n:
        take = min(len(starts), n - len(starts))
        if int(starts[:take].max(initial=0)) >= m:
            raise ValueError("BYTE_ARRAY values overrun the page")
        starts = np.concatenate([starts, jump[starts[:take]]])
        if len(starts) < n:
            jump = jump[jump]
    starts = starts[:n]
    if int(starts.max()) > m - 4:
        raise ValueError("BYTE_ARRAY values overrun the page")
    lengths = le[starts]
    if int((starts + 4 + lengths).max()) > m:
        raise ValueError("BYTE_ARRAY value out of bounds")
    return starts, lengths


def _accum_index_counts(runs: List[List[int]], data, start: int, bw: int,
                        n: int, out_base: int, bit_base: int,
                        counts: np.ndarray) -> None:
    """Histogram one page's dictionary indices into ``counts`` from the
    run rows ``_walk_runs`` gave for it (output positions from
    ``out_base``, literal bit offsets from ``bit_base``, both as passed to
    it), the literal runs in one vectorized pass. The exact output byte
    total (counts · dictionary lengths) sizes the string column's byte
    buffer on the host. An index outside the dictionary raises (the device
    expansion would gather garbage bytes)."""
    if not runs:
        return
    r = np.asarray(runs, np.int64)
    out_start = r[:, 0] - out_base
    takes = np.diff(np.append(out_start, n))
    lit = r[:, 3] != 0
    rle_vals, rle_takes = r[~lit, 2], takes[~lit]
    # numpy run tables on the host: no device transfer
    vals = _literal_values(data, ((r[lit, 1] - bit_base) // 8 + start)
                           .tolist(), takes[lit].tolist(), bw)
    if (len(vals) and int(vals.max()) >= len(counts)) \
            or bool((rle_vals[rle_takes > 0] >= len(counts)).any()):
        raise ValueError("dictionary index out of range")
    np.add.at(counts, rle_vals, rle_takes)
    counts += np.bincount(vals, minlength=len(counts))


# ---------------------------------------------------------------------------
# per-column decode plans (eligibility) and staged buffers
# ---------------------------------------------------------------------------

#: physical type → (itemsize, value kind) for PLAIN/dictionary values
_PHYS_FIXED = {"INT32": (4, "i"), "INT64": (8, "i"),
               "FLOAT": (4, "f"), "DOUBLE": (8, "f")}

_SUPPORTED_ENCODINGS = {"PLAIN", "RLE", "PLAIN_DICTIONARY", "RLE_DICTIONARY"}

_CODECS = {"UNCOMPRESSED": None, "SNAPPY": "snappy", "ZSTD": "zstd",
           "GZIP": "gzip", "BROTLI": "brotli", "LZ4": "lz4_raw",
           "LZ4_RAW": "lz4_raw"}

_INT_RANK = {ByteType: 0, ShortType: 1, IntegerType: 2, LongType: 3}

#: thrift page types / encodings
_PAGE_DATA_V1, _PAGE_INDEX, _PAGE_DICT, _PAGE_DATA_V2 = 0, 1, 2, 3
_ENC_PLAIN, _ENC_PLAIN_DICT, _ENC_RLE, _ENC_RLE_DICT = 0, 2, 3, 8


def _cast_ok(src: DataType, dst: DataType) -> bool:
    """Value-preserving device cast from the file's column type to the
    scan's output attribute type (mirrors the host path's .cast(schema))."""
    if type(src) is type(dst):
        return True
    sr, dr = _INT_RANK.get(type(src)), _INT_RANK.get(type(dst))
    if sr is not None and dr is not None:
        return dr >= sr
    return isinstance(src, FloatType) and isinstance(dst, DoubleType)


@dataclass
class _ColPlan:
    name: str
    leaf: int               # parquet leaf/column-chunk index
    phys: str               # physical type
    itemsize: int
    vkind: str              # "i"/"f" (ignored for BOOLEAN)
    out_dtype: DataType     # the scan attribute's engine type
    nullable: bool          # max_definition_level == 1


def _column_plan(attr, leaf_idx: int, sc, cc, field_type) -> _ColPlan:
    """Eligibility for one column of one row group; raises DeviceDecodeError
    naming the reason when the column must decode on host."""
    if sc.max_repetition_level > 0 or sc.max_definition_level > 1:
        raise DeviceDecodeError("nested column")
    phys = cc.physical_type
    if phys == "BOOLEAN":
        isz, vkind = 1, "b"
    elif phys in _PHYS_FIXED:
        isz, vkind = _PHYS_FIXED[phys]
    elif phys == "BYTE_ARRAY":
        isz, vkind = 0, "s"  # variable width: offsets+bytes device layout
    else:  # INT96, FIXED_LEN_BYTE_ARRAY
        raise DeviceDecodeError(f"physical type {phys}")
    unsupported = set(cc.encodings) - _SUPPORTED_ENCODINGS
    if unsupported:
        raise DeviceDecodeError(f"encoding {sorted(unsupported)}")
    codec = _CODECS.get(cc.compression)
    if cc.compression not in _CODECS:
        raise DeviceDecodeError(f"codec {cc.compression}")
    if codec is not None:
        import pyarrow as pa
        if not pa.Codec.is_available(codec):
            raise DeviceDecodeError(f"codec {cc.compression} unavailable")
    try:
        src = arrow_to_type(field_type)
    except Exception as e:  # noqa: BLE001 — unmapped arrow type
        raise DeviceDecodeError(f"arrow type {field_type}: {e}")
    import pyarrow as pa
    if pa.types.is_timestamp(field_type) and field_type.unit != "us":
        raise DeviceDecodeError(f"timestamp unit {field_type.unit}")
    if vkind == "s":
        # strings/binary: the value bytes are copied verbatim — only the
        # identity "cast" is value-preserving on device
        if not isinstance(src, (StringType, BinaryType)) \
                or type(src) is not type(attr.dtype):
            raise DeviceDecodeError(f"byte-array type {src} -> {attr.dtype}")
    elif isinstance(src, DecimalType):
        # an INT32/INT64-backed decimal (Spark's writer for p <= 18) is
        # its unscaled integers; FIXED_LEN_BYTE_ARRAY stopped above
        if src != attr.dtype:
            raise DeviceDecodeError(f"cast {src} -> {attr.dtype}")
    elif not isinstance(src, (BooleanType, ByteType, ShortType, IntegerType,
                              LongType, FloatType, DoubleType, DateType,
                              TimestampType)):
        raise DeviceDecodeError(f"column type {src}")
    elif not _cast_ok(src, attr.dtype):
        raise DeviceDecodeError(f"cast {src} -> {attr.dtype}")
    return _ColPlan(attr.name, leaf_idx, phys, isz, vkind, attr.dtype,
                    sc.max_definition_level == 1)

# ---------------------------------------------------------------------------
# page walk → staged buffers for one column chunk
# ---------------------------------------------------------------------------


@dataclass
class _Staged:
    """One column's host-staged buffers and its decode spec."""
    spec: Tuple
    arrays: List[np.ndarray]


def _pad_bytes(parts: List[bytes], min_len: int = 0) -> np.ndarray:
    """Concatenate byte regions and zero-pad to a bucketed capacity (+8
    bytes of slack so unpack_bits' 5-byte window never reads OOB)."""
    total = sum(len(p) for p in parts)
    cap = bucket_capacity(max(total, min_len) + 8)
    out = np.zeros(cap, np.uint8)
    pos = 0
    for p in parts:
        out[pos:pos + len(p)] = np.frombuffer(p, np.uint8)
        pos += len(p)
    return out


def _pad_runs(rows: List[List[int]]) -> np.ndarray:
    cap = bucket_capacity(max(len(rows), 1))
    out = np.full((cap, RUN_COLS), 0, np.int64)
    out[:, RUN_START] = RUN_PAD_START  # searchsorted never lands on padding
    if rows:
        out[:len(rows)] = np.asarray(rows, np.int64)
    return out


def _decompress(codec: Optional[str], body, usize: int) -> bytes:
    if codec is None:
        data = bytes(body)
    else:
        import pyarrow as pa
        data = pa.Codec(codec).decompress(body, usize).to_pybytes()
    if len(data) != usize:
        raise ValueError(f"decompressed {len(data)} != header {usize}")
    return data


_STRING_CHAR_LIMIT = 1 << 31  # int32 offsets: > 2^31 chars cannot address


def _stage_string_column(chunk: bytes, cc, plan: _ColPlan, num_rows: int,
                         cap: int) -> _Staged:
    """BYTE_ARRAY staging: def-level runs exactly like the fixed path;
    value regions stage as either an index run table + raw dictionary
    bytes (RLE_DICTIONARY pages) or per-value (start, length) tables into
    the concatenated PLAIN regions (4-byte prefixes walked host-side by
    vectorized pointer doubling). The exact output char total is computed
    host-side (index histogram · dictionary lengths, or the sum of PLAIN
    lengths), so the decode sizes its byte buffer with no device read."""
    codec = _CODECS[cc.compression]
    lv_runs: List[List[int]] = []
    lv_parts: List[bytes] = []
    lv_bits = 0
    val_runs: List[List[int]] = []      # dictionary-index runs
    val_parts: List[bytes] = []
    val_bits = 0
    idx_counts: Optional[np.ndarray] = None
    plain_srcs: List[np.ndarray] = []   # PLAIN per-value starts (chars)
    plain_lens: List[np.ndarray] = []
    plain_parts: List[bytes] = []
    plain_base = 0
    dict_srcs = dict_lens = None
    dict_bytes: Optional[bytes] = None
    n_dict = 0
    saw_dict = saw_plain = False
    rows_seen = 0
    dense_seen = 0
    try:
        pos = 0
        end = len(chunk)
        while pos < end and rows_seen < num_rows:
            hdr, dpos = _read_struct(chunk, pos)
            ptype, usize, csize = hdr[1], hdr[2], hdr[3]
            if usize < 0 or csize < 0 or dpos + csize > end:
                raise ValueError("page body out of bounds")
            body = chunk[dpos:dpos + csize]
            pos = dpos + csize
            if _obs._ACTIVE:
                _obs.event("scan.page", cat="io", column=plan.name,
                           page_type=ptype, compressed=csize,
                           uncompressed=usize)
            if ptype == _PAGE_DICT:
                dph = hdr[7]
                if dph[2] not in (_ENC_PLAIN, _ENC_PLAIN_DICT):
                    raise ValueError(f"dictionary encoding {dph[2]}")
                data = _decompress(codec, body, usize)
                n_dict = dph[1]
                region = np.frombuffer(data, np.uint8)
                starts, lens = _byte_array_starts(region, n_dict)
                dict_srcs, dict_lens = starts + 4, lens
                dict_bytes = data
                idx_counts = np.zeros(max(n_dict, 1), np.int64)
                continue
            if ptype not in (_PAGE_DATA_V1, _PAGE_DATA_V2):
                continue  # index pages etc.: metadata only
            if ptype == _PAGE_DATA_V1:
                data = _decompress(codec, body, usize)
                dph = hdr[5]
                nv, enc, denc = dph[1], dph[2], dph[3]
                p = 0
                if plan.nullable:
                    if denc != _ENC_RLE:
                        raise ValueError(f"def-level encoding {denc}")
                    (dlen,) = struct.unpack_from("<i", data, 0)
                    p = 4 + dlen
                    if dlen < 0 or p > len(data):
                        raise ValueError("def levels out of bounds")
                    lv_runs += _walk_runs(data, 4, p, 1, nv,
                                          rows_seen, lv_bits)
                    lv_parts.append(data[4:p])
                    lv_bits += dlen * 8
                    nnn = _count_valid(data, 4, p, nv)
                else:
                    nnn = nv
                region = data[p:]
            else:  # v2
                v2 = hdr[8]
                nv, nnulls, enc = v2[1], v2[2], v2[4]
                dl_len, rl_len = v2[5], v2[6]
                if rl_len:
                    raise ValueError("repetition levels on flat column")
                if dl_len + rl_len > csize:
                    raise ValueError("levels out of bounds")
                levels = bytes(body[:dl_len])
                region = body[dl_len:]
                if codec is not None and v2.get(7, True):
                    region = _decompress(codec, region, usize - dl_len)
                else:
                    region = bytes(region)
                if plan.nullable:
                    lv_runs += _walk_runs(levels, 0, dl_len, 1, nv,
                                          rows_seen, lv_bits)
                    lv_parts.append(levels)
                    lv_bits += dl_len * 8
                elif nnulls:
                    raise ValueError("nulls in a required column")
                nnn = nv - nnulls
            rows_seen += nv
            if nnn:
                if enc in (_ENC_PLAIN_DICT, _ENC_RLE_DICT):
                    saw_dict = True
                    if idx_counts is None:
                        raise ValueError("dictionary-encoded page before "
                                         "the dictionary page")
                    if not region:
                        raise ValueError("empty dictionary-indices page")
                    bw = region[0]
                    if bw > 32:
                        raise ValueError(f"index bit width {bw}")
                    page_runs = _walk_runs(region, 1, len(region), bw, nnn,
                                           dense_seen, val_bits)
                    _accum_index_counts(page_runs, region, 1, bw, nnn,
                                        dense_seen, val_bits, idx_counts)
                    val_runs += page_runs
                    val_parts.append(region[1:])
                    val_bits += (len(region) - 1) * 8
                elif enc == _ENC_PLAIN:
                    saw_plain = True
                    rb = np.frombuffer(bytes(region), np.uint8)
                    starts, lens = _byte_array_starts(rb, nnn)
                    plain_srcs.append(starts + 4 + plain_base)
                    plain_lens.append(lens)
                    plain_parts.append(bytes(region))
                    plain_base += len(region)
                else:
                    raise ValueError(f"value encoding {enc}")
            dense_seen += nnn
        if rows_seen != num_rows:
            raise ValueError(f"pages cover {rows_seen} of {num_rows} rows")
        if saw_dict and saw_plain:
            # mid-chunk dictionary fallback on a STRING column (a rare
            # writer-overflow shape): the column demotes to the host
            raise DeviceDecodeError(
                f"column {plan.name}: mixed dictionary+PLAIN string chunk")
        if saw_dict and dict_bytes is None:
            raise ValueError("dictionary-encoded pages without a "
                             "dictionary page")
    except DeviceDecodeError:
        raise
    except (KeyError, ValueError, IndexError, struct.error,
            OverflowError) as e:
        raise DeviceDecodeError(
            f"column {plan.name}: malformed page data ({e})")
    except Exception as e:  # noqa: BLE001 — codec errors etc.
        raise DeviceDecodeError(f"column {plan.name}: {e}")

    out_kind = "s" if isinstance(plan.out_dtype, StringType) else "b"
    arrays: List[np.ndarray] = []
    if plan.nullable:
        lvr = _pad_runs(lv_runs)
        lvb = _pad_bytes(lv_parts)
        arrays += [lvr, lvb]
        lv_shape = (lvr.shape[0], lvb.shape[0])
    else:
        lv_shape = None
    if saw_dict:
        total_chars = int(idx_counts @ dict_lens) if n_dict else 0
        if total_chars >= _STRING_CHAR_LIMIT:
            raise DeviceDecodeError(
                f"column {plan.name}: {total_chars} chars exceed the int32 "
                f"offsets range")
        char_cap = bucket_capacity(max(total_chars, 1))
        vr = _pad_runs(val_runs)
        vb = _pad_bytes(val_parts)
        dict_cap = bucket_capacity(max(n_dict, 1))
        dsrc = np.zeros(dict_cap, np.int64)
        dsrc[:n_dict] = dict_srcs
        dln = np.zeros(dict_cap, np.int32)
        dln[:n_dict] = dict_lens
        db = _pad_bytes([dict_bytes])
        arrays += [vr, vb, dsrc, dln, db]
        spec = ("str_dict", plan.nullable, out_kind, lv_shape,
                (vr.shape[0], vb.shape[0]), dict_cap, db.shape[0], cap,
                char_cap)
        return _Staged(spec, arrays)
    # PLAIN (or an all-null chunk with no staged values)
    all_lens = np.concatenate(plain_lens) if plain_lens \
        else np.zeros(0, np.int64)
    total_chars = int(all_lens.sum())
    if total_chars >= _STRING_CHAR_LIMIT:
        raise DeviceDecodeError(
            f"column {plan.name}: {total_chars} chars exceed the int32 "
            f"offsets range")
    char_cap = bucket_capacity(max(total_chars, 1))
    dense_cap = bucket_capacity(max(dense_seen, 1))
    srcs = np.zeros(dense_cap, np.int64)
    lens = np.zeros(dense_cap, np.int32)
    if len(all_lens):
        srcs[:dense_seen] = np.concatenate(plain_srcs)
        lens[:dense_seen] = all_lens
    vb = _pad_bytes(plain_parts)
    arrays += [srcs, lens, vb]
    spec = ("str_plain", plan.nullable, out_kind, lv_shape, dense_cap,
            vb.shape[0], cap, char_cap)
    return _Staged(spec, arrays)


def _stage_column(chunk: bytes, cc, plan: _ColPlan, num_rows: int,
                  cap: int) -> _Staged:
    """Walk one column chunk's pages: parse headers, decompress, walk run
    headers, and build the staged uint8/run-table buffers the device program
    consumes. Raises DeviceDecodeError on anything structurally off."""
    if plan.vkind == "s":
        return _stage_string_column(chunk, cc, plan, num_rows, cap)
    codec = _CODECS[cc.compression]
    lv_runs: List[List[int]] = []
    lv_parts: List[bytes] = []
    lv_bits = 0          # staged level-bytes length (bits base for runs)
    val_runs: List[List[int]] = []       # dict indices or boolean values
    val_parts: List[bytes] = []
    val_bits = 0
    plain_parts: List[bytes] = []
    #: per-data-page dense-range segments [dense_start, plain_src, 0,
    #: is_plain, 0] — consumed only when the chunk mixes dictionary and
    #: PLAIN pages (mid-chunk dictionary fallback)
    segs: List[List[int]] = []
    plain_seen = 0       # dense PLAIN values staged so far
    dict_bytes: Optional[bytes] = None
    saw_dict_data = saw_plain_data = False
    rows_seen = 0
    dense_seen = 0
    try:
        pos = 0
        end = len(chunk)
        while pos < end and rows_seen < num_rows:
            hdr, dpos = _read_struct(chunk, pos)
            ptype, usize, csize = hdr[1], hdr[2], hdr[3]
            if usize < 0 or csize < 0 or dpos + csize > end:
                raise ValueError("page body out of bounds")
            body = chunk[dpos:dpos + csize]
            pos = dpos + csize
            if _obs._ACTIVE:
                _obs.event("scan.page", cat="io", column=plan.name,
                           page_type=ptype, compressed=csize,
                           uncompressed=usize)
            if ptype == _PAGE_DICT:
                dph = hdr[7]
                if dph[2] not in (_ENC_PLAIN, _ENC_PLAIN_DICT):
                    raise ValueError(f"dictionary encoding {dph[2]}")
                data = _decompress(codec, body, usize)
                if len(data) < dph[1] * plan.itemsize:
                    raise ValueError("dictionary page too short")
                dict_bytes = data
                continue
            if ptype == _PAGE_DATA_V1:
                data = _decompress(codec, body, usize)
                dph = hdr[5]
                nv, enc, denc = dph[1], dph[2], dph[3]
                p = 0
                if plan.nullable:
                    if denc != _ENC_RLE:
                        raise ValueError(f"def-level encoding {denc}")
                    (dlen,) = struct.unpack_from("<i", data, 0)
                    p = 4 + dlen
                    if dlen < 0 or p > len(data):
                        raise ValueError("def levels out of bounds")
                    lv_runs += _walk_runs(data, 4, p, 1, nv,
                                          rows_seen, lv_bits)
                    lv_parts.append(data[4:p])
                    lv_bits += dlen * 8
                    nnn = _count_valid(data, 4, p, nv)
                else:
                    nnn = nv
                rows_seen += nv
                region = data[p:]
                if enc in (_ENC_PLAIN_DICT, _ENC_RLE_DICT):
                    saw_dict_data = True
                    segs.append([dense_seen, 0, 0, 0, 0])
                    if not region:
                        raise ValueError("empty dictionary-indices page")
                    bw = region[0]
                    if bw > 32:
                        raise ValueError(f"index bit width {bw}")
                    val_runs += _walk_runs(region, 1, len(region), bw, nnn,
                                           dense_seen, val_bits)
                    val_parts.append(region[1:])
                    val_bits += (len(region) - 1) * 8
                elif enc == _ENC_PLAIN:
                    saw_plain_data = True
                    if plan.phys == "BOOLEAN":
                        if len(region) * 8 < nnn:
                            raise ValueError("boolean page too short")
                        val_runs.append([dense_seen, val_bits, 0, 1, 1])
                        val_parts.append(region)
                        val_bits += len(region) * 8
                    else:
                        segs.append([dense_seen, plain_seen, 0, 1, 0])
                        need = nnn * plan.itemsize
                        if len(region) < need:
                            raise ValueError("PLAIN values page too short")
                        plain_parts.append(region[:need])
                        plain_seen += nnn
                elif enc == _ENC_RLE and plan.phys == "BOOLEAN":
                    (blen,) = struct.unpack_from("<i", region, 0)
                    if blen < 0 or 4 + blen > len(region):
                        raise ValueError("RLE boolean region out of bounds")
                    val_runs += _walk_runs(region, 4, 4 + blen, 1, nnn,
                                           dense_seen, val_bits)
                    val_parts.append(region[4:4 + blen])
                    val_bits += blen * 8
                else:
                    raise ValueError(f"value encoding {enc}")
                dense_seen += nnn
                continue
            if ptype == _PAGE_DATA_V2:
                v2 = hdr[8]
                nv, nnulls, enc = v2[1], v2[2], v2[4]
                dl_len, rl_len = v2[5], v2[6]
                if rl_len:
                    raise ValueError("repetition levels on flat column")
                if dl_len + rl_len > csize:
                    raise ValueError("levels out of bounds")
                levels = bytes(body[:dl_len])
                vregion = body[dl_len:]
                if codec is not None and v2.get(7, True):
                    vregion = _decompress(codec, vregion, usize - dl_len)
                else:
                    vregion = bytes(vregion)
                if plan.nullable:
                    lv_runs += _walk_runs(levels, 0, dl_len, 1, nv,
                                          rows_seen, lv_bits)
                    lv_parts.append(levels)
                    lv_bits += dl_len * 8
                elif nnulls:
                    raise ValueError("nulls in a required column")
                rows_seen += nv
                nnn = nv - nnulls
                if enc in (_ENC_PLAIN_DICT, _ENC_RLE_DICT):
                    saw_dict_data = True
                    segs.append([dense_seen, 0, 0, 0, 0])
                    if not vregion:
                        raise ValueError("empty dictionary-indices page")
                    bw = vregion[0]
                    if bw > 32:
                        raise ValueError(f"index bit width {bw}")
                    val_runs += _walk_runs(vregion, 1, len(vregion), bw,
                                           nnn, dense_seen, val_bits)
                    val_parts.append(vregion[1:])
                    val_bits += (len(vregion) - 1) * 8
                elif enc == _ENC_PLAIN:
                    saw_plain_data = True
                    if plan.phys == "BOOLEAN":
                        if len(vregion) * 8 < nnn:
                            raise ValueError("boolean page too short")
                        val_runs.append([dense_seen, val_bits, 0, 1, 1])
                        val_parts.append(vregion)
                        val_bits += len(vregion) * 8
                    else:
                        segs.append([dense_seen, plain_seen, 0, 1, 0])
                        need = nnn * plan.itemsize
                        if len(vregion) < need:
                            raise ValueError("PLAIN values page too short")
                        plain_parts.append(vregion[:need])
                        plain_seen += nnn
                elif enc == _ENC_RLE and plan.phys == "BOOLEAN":
                    (blen,) = struct.unpack_from("<i", vregion, 0)
                    if blen < 0 or 4 + blen > len(vregion):
                        raise ValueError("RLE boolean region out of bounds")
                    val_runs += _walk_runs(vregion, 4, 4 + blen, 1, nnn,
                                           dense_seen, val_bits)
                    val_parts.append(vregion[4:4 + blen])
                    val_bits += blen * 8
                else:
                    raise ValueError(f"value encoding {enc}")
                dense_seen += nnn
                continue
            # index pages etc.: metadata only, skip
        if rows_seen != num_rows:
            raise ValueError(f"pages cover {rows_seen} of {num_rows} rows")
        if saw_dict_data and dict_bytes is None:
            raise ValueError("dictionary-encoded pages without a "
                             "dictionary page")
    except DeviceDecodeError:
        raise
    except (KeyError, ValueError, IndexError, struct.error,
            OverflowError) as e:
        raise DeviceDecodeError(
            f"column {plan.name}: malformed page data ({e})")
    except Exception as e:  # noqa: BLE001 — codec errors etc.
        raise DeviceDecodeError(f"column {plan.name}: {e}")

    out_np = str(np.dtype(plan.out_dtype.np_dtype))
    arrays: List[np.ndarray] = []
    if plan.nullable:
        lvr = _pad_runs(lv_runs)
        lvb = _pad_bytes(lv_parts)
        arrays += [lvr, lvb]
        lv_shape = (lvr.shape[0], lvb.shape[0])
    else:
        lv_shape = None
    if plan.phys == "BOOLEAN":
        if saw_dict_data:
            # dict-encoded booleans (legal but exotic): the run table here
            # holds dictionary INDICES, which decode_bool_runs would read
            # as values — demote rather than risk wrong data
            raise DeviceDecodeError(
                f"column {plan.name}: dictionary-encoded boolean pages")
        vr = _pad_runs(val_runs)
        vb = _pad_bytes(val_parts)
        arrays += [vr, vb]
        spec = ("bool", out_np, plan.nullable, lv_shape,
                (vr.shape[0], vb.shape[0]), cap)
    elif saw_dict_data:
        vr = _pad_runs(val_runs)
        vb = _pad_bytes(val_parts)
        db = _pad_bytes([dict_bytes], min_len=plan.itemsize)
        # dictionary buffer must reshape exactly: trim padding to a
        # multiple of the item size
        db = db[: (db.shape[0] // plan.itemsize) * plan.itemsize]
        arrays += [vr, vb, db]
        if saw_plain_data:
            # mid-chunk dictionary fallback: later pages carry PLAIN
            # values merged back into the dense stream by segment table
            seg = _pad_runs(segs)
            pb = _pad_bytes(plain_parts, min_len=plan.itemsize)
            pb = pb[: (pb.shape[0] // plan.itemsize) * plan.itemsize]
            arrays += [seg, pb]
            plain_shape = (seg.shape[0], pb.shape[0])
        else:
            plain_shape = None
        spec = ("dict", plan.itemsize, plan.vkind, out_np, plan.nullable,
                lv_shape, (vr.shape[0], vb.shape[0]), db.shape[0],
                plain_shape, cap)
    else:
        vb = np.zeros(cap * plan.itemsize, np.uint8)
        ppos = 0
        for p in plain_parts:
            vb[ppos:ppos + len(p)] = np.frombuffer(p, np.uint8)
            ppos += len(p)
        arrays += [vb]
        spec = ("plain", plan.itemsize, plan.vkind, out_np, plan.nullable,
                lv_shape, cap)
    return _Staged(spec, arrays)

# ---------------------------------------------------------------------------
# the decode program: every staged column of one row group, on the device
# ---------------------------------------------------------------------------


_TORCH_OF = {np.dtype(np.bool_): torch.bool, np.dtype(np.int8): torch.int8,
             np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32,
             np.dtype(np.int64): torch.int64,
             np.dtype(np.float32): torch.float32,
             np.dtype(np.float64): torch.float64,
             np.dtype(np.uint8): torch.uint8}


def _validity(it, nullable: bool, cap: int, num_rows: int, device):
    from ..kernels import parquet_decode as K
    if nullable:
        lv_runs, lv_bytes = next(it), next(it)
        return K.validity_from_defs(K.expand_runs(lv_runs, lv_bytes, cap), 1,
                                    num_rows)
    return torch.arange(cap, dtype=torch.int64, device=device) < num_rows


def decode_program(specs: Sequence[Tuple], num_rows: int,
                   bufs: Sequence[torch.Tensor]) -> List[Optional[torch.Tensor]]:
    """Decode the staged columns of one row group (the reference's
    ``_build_program`` body). Per column it returns (data, validity) for a
    fixed-width column and (offsets, chars, validity) for a string one;
    validity is None for a required column."""
    from ..kernels import parquet_decode as K
    it = iter(bufs)
    dev = bufs[0].device
    outs: List[Optional[torch.Tensor]] = []
    for spec in specs:
        kind = spec[0]
        if kind in ("str_plain", "str_dict"):
            nullable = spec[1]
            cap = spec[7] if kind == "str_dict" else spec[6]
            char_cap = spec[8] if kind == "str_dict" else spec[7]
            valid = _validity(it, nullable, cap, num_rows, dev)
            if kind == "str_dict":
                vr, vb = next(it), next(it)
                dsrc, dlen, db = next(it), next(it), next(it)
                idx = K.expand_runs(vr, vb, cap)
                src_dense = K.dictionary_gather(dsrc, idx)
                len_dense = K.dictionary_gather(dlen, idx)
            else:
                src_dense, len_dense, db = next(it), next(it), next(it)
            row_len = K.expand_dense(len_dense, valid)
            row_src = K.expand_dense(src_dense, valid)
            offs = K.string_offsets(row_len)
            outs += [offs, K.gather_string_bytes(db, row_src, offs, char_cap),
                     valid if nullable else None]
            continue
        cap = spec[-1]
        nullable = spec[4] if kind != "bool" else spec[2]
        out_np = spec[3] if kind != "bool" else spec[1]
        valid = _validity(it, nullable, cap, num_rows, dev)
        if kind == "bool":
            vr, vb = next(it), next(it)
            dense = K.decode_bool_runs(vr, vb, cap)
        elif kind == "dict":
            isz, vkind = spec[1], spec[2]
            vr, vb, db = next(it), next(it), next(it)
            idx = K.expand_runs(vr, vb, cap)
            dense = K.dictionary_gather(K.plain_fixed_width(db, isz, vkind),
                                        idx)
            if spec[8] is not None:  # mid-chunk dictionary fallback
                seg, pb = next(it), next(it)
                dense = K.merge_plain_segments(
                    seg, K.plain_fixed_width(pb, isz, vkind), dense, cap)
        else:  # plain
            dense = K.plain_fixed_width(next(it), spec[1], spec[2])
        if nullable:
            data = K.expand_dense(dense, valid)
        else:
            data = torch.where(valid, dense[:cap],
                               torch.zeros((), dtype=dense.dtype, device=dev))
        outs += [data.to(_TORCH_OF[np.dtype(out_np)]),
                 valid if nullable else None]
    return outs


# ---------------------------------------------------------------------------
# the staged upload: one host-to-device copy a row group
# ---------------------------------------------------------------------------


_ALIGN = 16


class PinnedStaging:
    """Two pinned host buffers used in turn: a row group's buffers pack
    into one, one asynchronous copy moves them to the card, and the buffer
    is reused two row groups later, after its copy's event. One serves a
    scan partition's files."""

    def __init__(self):
        self._bufs: List[Optional[torch.Tensor]] = [None, None]
        self._events: List[Optional[torch.cuda.Event]] = [None, None]
        self._turn = 0

    def upload(self, arrays: List[np.ndarray],
               device: torch.device) -> List[torch.Tensor]:
        offs, total = [], 0
        for a in arrays:
            offs.append(total)
            total += -(-a.nbytes // _ALIGN) * _ALIGN
        k = self._turn
        self._turn ^= 1
        if self._events[k] is not None:
            self._events[k].synchronize()
        buf = self._bufs[k]
        if buf is None or buf.shape[0] < total:
            buf = torch.empty(max(total, 1 << 20), dtype=torch.uint8,
                              pin_memory=True)
            self._bufs[k] = buf
        host = buf.numpy()  # pinned host memory: no device transfer
        for a, o in zip(arrays, offs):
            host[o:o + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(
                np.uint8)
        dev = torch.empty(max(total, 1), dtype=torch.uint8, device=device)
        dev.copy_(buf[:max(total, 1)], non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self._events[k] = ev
        return [dev[o:o + a.nbytes].view(_TORCH_OF[a.dtype]).view(a.shape)
                for a, o in zip(arrays, offs)]


def _upload(arrays: List[np.ndarray], device: torch.device,
            staging: Optional[PinnedStaging]) -> List[torch.Tensor]:
    if device.type == "cuda":
        return staging.upload(arrays, device)
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# row-group decode: read ranges → stage → upload → decode → batch
# ---------------------------------------------------------------------------


def _chunk_range(cc) -> Tuple[int, int]:
    start = cc.data_page_offset
    # a 0 offset means "absent" (the file magic occupies bytes 0-3)
    if cc.has_dictionary_page and cc.dictionary_page_offset:
        start = min(start, cc.dictionary_page_offset)
    return start, cc.total_compressed_size


def normalize_arrow_column(arr, dtype: DataType):
    """A host-read Arrow column at the scan attribute's type: nanosecond
    timestamps (INT96 among them) truncate to microseconds as Spark does,
    then the column casts to the attribute's Arrow type."""
    pa = import_pyarrow()
    if pa.types.is_timestamp(arr.type) and arr.type.unit == "ns":
        arr = arr.cast(pa.timestamp("us", tz=arr.type.tz), safe=False)
    want = type_to_arrow(dtype)
    if arr.type != want:
        arr = arr.cast(want)
    return arr.combine_chunks() if isinstance(arr, pa.ChunkedArray) else arr


def _host_columns(pf, rgi: int, names: List[str], attrs_by_name: Dict,
                  device: torch.device) -> Dict[str, TorchColumnVector]:
    """pyarrow's decode of the demoted columns of one row group, on the
    device at the row group's capacity."""
    pa = import_pyarrow()
    from ..columnar.batch import TorchColumnarBatch
    t = pf.read_row_groups([rgi], columns=names)
    t = pa.table({n: normalize_arrow_column(t.column(n),
                                            attrs_by_name[n].dtype)
                  for n in names})
    batch = TorchColumnarBatch.from_arrow(t).to_device(device)
    return dict(zip(names, batch.columns))


def _verify_against_host(pf, rgi: int, batch, device_names: List[str],
                         attrs_by_name: Dict) -> None:
    """The device-decoded columns must equal pyarrow's decode of the same
    row group, floats bit for bit; a mismatch re-reads the row group on the
    host (``spark.rapids.tpu.parquet.deviceDecode.verify``)."""
    want = _host_columns(pf, rgi, device_names, attrs_by_name,
                         torch.device("cpu"))
    n = batch.num_rows
    for name, col in zip(batch.names, batch.columns):
        if name not in want:
            continue
        if not _same_values(col, want[name], n):
            raise DeviceDecodeError(
                f"verify: device decode of column {name} in row group "
                f"{rgi} differs from the host decode")


def _same_values(a: TorchColumnVector, b: TorchColumnVector, n: int) -> bool:
    va, vb, da, db = audited_device_get(
        [a.validity_or_true()[:n], b.validity_or_true()[:n],
         a.data[:n], b.data[:n]], "fetch")
    if not torch.equal(va, vb):
        return False
    if a.offsets is not None:
        return a.to_pylist() == b.to_pylist()
    if da.is_floating_point():
        bits = torch.int32 if da.element_size() == 4 else torch.int64
        da, db = da.view(bits), db.view(bits)
    return torch.equal(da[va], db[vb])


class DeviceFileDecoder:
    """Device decode of one parquet file, a row group at a time.

    Construction checks the file: encryption raises
    ``ParquetEncryptedException``; an unreadable footer, a legacy-calendar
    rebase or a missing column raise ``DeviceDecodeError`` (the caller
    reads the whole file on the host). ``decode_row_group`` raises
    ``DeviceDecodeError`` when no column of a row group decodes on the
    device (the caller re-reads just that row group on the host);
    single columns demote to the host decode and join the same batch.
    """

    def __init__(self, path: str, attrs: Sequence, conf, device: torch.device,
                 counters=None, staging: Optional[PinnedStaging] = None):
        import_pyarrow()
        import pyarrow as pa
        import pyarrow.parquet as pq

        from ..config import (PARQUET_DEVICE_DECODE_VERIFY,
                              PARQUET_REBASE_MODE_READ)
        from .rebase import needs_rebase

        self.path = path
        self.attrs = list(attrs)
        self.device = device
        self.counters = counters
        reason = detect_encryption(path)
        if reason is not None:
            raise ParquetEncryptedException(encrypted_message(path, reason))
        try:
            self.pf = pq.ParquetFile(path)
            self.md = self.pf.metadata
        except Exception as e:  # noqa: BLE001 — unreadable footer
            raise DeviceDecodeError(f"{path}: cannot read footer ({e})")
        try:
            if self.md.num_row_groups == 0:
                raise DeviceDecodeError(f"{path}: no row groups")
            self.arrow_schema = self.pf.schema_arrow
            has_datetime = any(
                pa.types.is_date32(f.type) or pa.types.is_timestamp(f.type)
                for f in self.arrow_schema)
            if has_datetime and needs_rebase(
                    self.md.metadata, conf.get(PARQUET_REBASE_MODE_READ)):
                raise DeviceDecodeError(
                    f"{path}: legacy calendar rebase required")
            # leaf (column-chunk) index by name, flat columns only
            self.leaf_by_name: Dict[str, int] = {}
            rg0 = self.md.row_group(0)
            for j in range(rg0.num_columns):
                p = rg0.column(j).path_in_schema
                if "." not in p:
                    self.leaf_by_name[p] = j
            for a in self.attrs:
                if a.name not in self.leaf_by_name:
                    raise DeviceDecodeError(
                        f"{path}: column {a.name} not in file")
            self.attrs_by_name = {a.name: a for a in self.attrs}
            self.verify = bool(conf.get(PARQUET_DEVICE_DECODE_VERIFY))
            self._file = open(path, "rb")
        except BaseException:
            self.pf.close()
            raise
        self._staging = staging if staging is not None or \
            device.type != "cuda" else PinnedStaging()

    def close(self) -> None:
        """Release the byte-range handle and the footer reader."""
        self._file.close()
        self.pf.close()

    def _read(self, start: int, length: int) -> bytes:
        self._file.seek(start)
        data = self._file.read(length)
        if len(data) != length:
            raise OSError(f"{self.path}: short read at {start}")
        return data

    def row_groups(self, row_filter=None) -> List[int]:
        """Non-empty row groups that footer statistics do not exclude (the
        host chunked reader's predicate)."""
        from .base_scan import rg_excluded
        return [rgi for rgi in range(self.md.num_row_groups)
                if self.md.row_group(rgi).num_rows
                and not (row_filter
                         and rg_excluded(self.md.row_group(rgi), row_filter))]

    def decode_row_group(self, rgi: int, times: Optional[ScanTimes] = None):
        """Stage, upload and decode one row group: a ``TorchColumnarBatch``
        on the device, columns in attribute order."""
        from ..columnar.batch import TorchColumnarBatch
        from ..execs import opjit
        times = times or ScanTimes(self.device)
        rg = self.md.row_group(rgi)
        num_rows = rg.num_rows
        cap = bucket_capacity(num_rows)
        plans: List[_ColPlan] = []
        host_names: List[str] = []

        def demote(name: str, err=None) -> None:
            host_names.append(name)
            bump("fallback_columns", 1, self.counters)
            if _obs._ACTIVE:
                _obs.event("scan.fallback", cat="io", column=name,
                           reason=str(err)[:120])

        for a in self.attrs:
            leaf = self.leaf_by_name[a.name]
            try:
                plans.append(_column_plan(
                    a, leaf, self.pf.schema.column(leaf), rg.column(leaf),
                    self.arrow_schema.field(a.name).type))
            except DeviceDecodeError as err:
                demote(a.name, err)
        if not plans:
            raise DeviceDecodeError(
                f"{self.path}: no device-decodable column in row group {rgi}")

        # one span a row group: staging, upload, the decode launch and
        # the host columns (host clock; it closes when the launch is queued)
        with _obs.span("scan.decode", cat="io", file=self.path,
                       row_group=rgi, device=True, rows=num_rows,
                       device_cols=len(plans), host_cols=len(host_names)):
            staged: List[_Staged] = []
            kept: List[_ColPlan] = []
            with times.host("stage"):
                for plan in plans:
                    cc = rg.column(plan.leaf)
                    try:
                        chunk = self._read(*_chunk_range(cc))
                        staged.append(_stage_column(chunk, cc, plan,
                                                    num_rows, cap))
                        kept.append(plan)
                    except (DeviceDecodeError, OSError) as err:
                        demote(plan.name, err)
            if not kept:
                raise DeviceDecodeError(
                    f"{self.path}: every column demoted in row group {rgi}")

            arrays = [a for st in staged for a in st.arrays]
            bump("bytes_staged", sum(a.nbytes for a in arrays))
            with times.device("upload"):
                bufs = _upload(arrays, self.device, self._staging)
            bump("dispatches")
            opjit.record_external_dispatch("parquet_decode")
            bump("row_groups")
            bump("rows", num_rows)
            bump("device_columns", len(kept))
            with times.device("deviceDecode"):
                outs = iter(decode_program([st.spec for st in staged],
                                           num_rows, bufs))
            dev_cols: Dict[str, TorchColumnVector] = {}
            for st, plan in zip(staged, kept):
                if st.spec[0] in ("str_plain", "str_dict"):
                    offs, chars, valid = next(outs), next(outs), next(outs)
                    dev_cols[plan.name] = TorchColumnVector(
                        plan.out_dtype, chars, valid, num_rows, offsets=offs)
                else:
                    data, valid = next(outs), next(outs)
                    dev_cols[plan.name] = TorchColumnVector(
                        plan.out_dtype, data, valid, num_rows)
            host_cols: Dict[str, TorchColumnVector] = {}
            if host_names:
                with times.host("hostDecode"):
                    host_cols = _host_columns(self.pf, rgi, host_names,
                                              self.attrs_by_name, self.device)
            batch = TorchColumnarBatch(
                [dev_cols[a.name] if a.name in dev_cols else host_cols[a.name]
                 for a in self.attrs],
                num_rows, [a.name for a in self.attrs])
        if self.verify:
            _verify_against_host(self.pf, rgi, batch, list(dev_cols),
                                 self.attrs_by_name)
        return batch
