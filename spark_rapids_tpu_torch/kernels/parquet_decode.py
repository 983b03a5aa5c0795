"""Device-side parquet page decode (port of
``spark_rapids_tpu/kernels/parquet_decode.py``): plain torch functions over
uint8 page buffers and int64 run tables on the device.

The host (``io/device_decode.py``) does the O(pages) + O(runs) work: the
footer, the page headers, decompression and the RLE / bit-packed hybrid
run headers. Every O(rows) transform runs here:

* ``unpack_bits``: 1..32-bit little-endian values at any bit offset
  (PLAIN booleans, bit-packed literal runs, dictionary indices);
* ``expand_runs``: the hybrid run table → one value an output element, by
  one ``searchsorted`` over the run starts;
* ``dictionary_gather``: indices into the decoded dictionary values;
* ``validity_from_defs`` and ``expand_dense``: definition levels → the
  validity mask, and the densely stored non-null values scattered into
  their row slots (padding rows stay zero and invalid);
* ``plain_fixed_width``: little-endian value bytes reinterpreted as the
  int or float carrier (a bit view, no arithmetic: floats come out bit
  for bit, NaN payloads and -0.0 included);
* ``merge_plain_segments``: the mid-chunk dictionary fallback;
* ``string_offsets`` and ``gather_string_bytes``: BYTE_ARRAY values into
  the port's int32 offsets + uint8 bytes layout.

Bit arithmetic is in int64: five bytes cover a 32-bit value at any shift,
so no lane needs more than 40 bits. Every ``take`` of the reference clamps
(``mode="clip"``): the index is clamped, then used.
"""

from __future__ import annotations

import torch

#: run-table column indices (int64 [n_runs, 5], built by the host; padding
#: runs start at RUN_PAD_START so no output element lands on them)
RUN_START, RUN_BITOFF, RUN_VALUE, RUN_LITERAL, RUN_WIDTH = range(5)
RUN_COLS = 5
RUN_PAD_START = 1 << 62


def _take(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(values, idx, mode="clip")`` along the first axis."""
    return values[idx.clamp(0, values.shape[0] - 1)]


def unpack_bits(data_u8: torch.Tensor, bit_offsets: torch.Tensor,
                widths: torch.Tensor) -> torch.Tensor:
    """Little-endian bit-packed values of per-element ``widths`` (0..32
    bits) at absolute ``bit_offsets``, as int64. ``data_u8`` carries at
    least 8 bytes of zero padding past the last addressed bit; offsets past
    it clamp into the padding and decode to values the caller masks off."""
    pos = bit_offsets.to(torch.int64)
    byte = pos >> 3
    shift = pos & 7
    word = torch.zeros(pos.shape, dtype=torch.int64, device=pos.device)
    for k in range(5):  # 5 bytes cover any 32-bit value at any bit shift
        word = word | (_take(data_u8, byte + k).to(torch.int64) << (8 * k))
    mask = (torch.ones_like(pos) << widths.to(torch.int64)) - 1
    return (word >> shift) & mask


def expand_runs(run_table: torch.Tensor, data_u8: torch.Tensor,
                out_len: int) -> torch.Tensor:
    """An RLE / bit-packed hybrid run table expanded into ``out_len`` int64
    values: each element finds its run by binary search over the run
    starts, then takes the run's value (RLE) or unpacks its bits (literal
    run). Elements past the last real run are masked downstream."""
    idx = torch.arange(out_len, dtype=torch.int64, device=run_table.device)
    starts = run_table[:, RUN_START].contiguous()
    r = torch.searchsorted(starts, idx, right=True) - 1
    r = r.clamp(0, run_table.shape[0] - 1)
    local = idx - starts[r]
    width = run_table[:, RUN_WIDTH][r]
    bitoff = run_table[:, RUN_BITOFF][r] + local * width
    unpacked = unpack_bits(data_u8, bitoff, width)
    literal = run_table[:, RUN_LITERAL][r] != 0
    return torch.where(literal, unpacked, run_table[:, RUN_VALUE][r])


def validity_from_defs(def_levels: torch.Tensor, max_def: int,
                       num_rows: int) -> torch.Tensor:
    """Definition levels → the validity mask over the padded capacity; rows
    in [num_rows, capacity) are padding and never valid."""
    n = def_levels.shape[0]
    in_range = torch.arange(n, dtype=torch.int64,
                            device=def_levels.device) < num_rows
    return (def_levels == max_def) & in_range


def expand_dense(dense: torch.Tensor, validity: torch.Tensor) -> torch.Tensor:
    """Scatter the densely stored non-null values into their row slots
    (null and padding rows read zero). A chunk with no stored value (all
    null) gives zeros."""
    if dense.shape[0] == 0:
        return torch.zeros(validity.shape, dtype=dense.dtype,
                           device=validity.device)
    pos = torch.cumsum(validity.to(torch.int64), 0) - 1
    g = _take(dense, pos)
    return torch.where(validity, g, torch.zeros((), dtype=dense.dtype,
                                                device=dense.device))


def dictionary_gather(dict_values: torch.Tensor,
                      indices: torch.Tensor) -> torch.Tensor:
    """Dictionary values by expanded index (clamped: padding indices land
    on slot 0 and are masked by validity)."""
    return _take(dict_values, indices.to(torch.int64))


_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_UNSIGNED = {1: torch.uint8, 2: torch.uint16, 4: torch.uint32,
             8: torch.uint64}
_FLOAT = {4: torch.float32, 8: torch.float64}


def plain_fixed_width(data_u8: torch.Tensor, itemsize: int,
                      kind: str) -> torch.Tensor:
    """PLAIN fixed-width values: little-endian bytes viewed as the carrier
    ("i" signed, "u" unsigned, "f" float; itemsize 1, 2, 4 or 8). A buffer
    whose offset is not a multiple of the item size is copied first, since
    a dtype view needs an aligned start."""
    n = data_u8.shape[0] - data_u8.shape[0] % itemsize
    buf = data_u8[:n]
    if not buf.is_contiguous() or buf.storage_offset() % itemsize:
        buf = buf.clone()
    target = {"i": _SIGNED, "u": _UNSIGNED, "f": _FLOAT}[kind][itemsize]
    return buf.view(target)


def merge_plain_segments(seg_table: torch.Tensor, plain_values: torch.Tensor,
                         base: torch.Tensor, out_len: int) -> torch.Tensor:
    """Mid-chunk dictionary fallback: once a writer's dictionary overflows,
    later pages store PLAIN values. ``seg_table`` marks each data page's
    dense range ([dense_start, plain_src_start, 0, is_plain, 0] rows):
    elements of a PLAIN page read ``plain_values[src_start + (i -
    dense_start)]``, the others keep ``base`` (the dictionary stream)."""
    idx = torch.arange(out_len, dtype=torch.int64, device=seg_table.device)
    starts = seg_table[:, RUN_START].contiguous()
    r = (torch.searchsorted(starts, idx, right=True) - 1).clamp(
        0, seg_table.shape[0] - 1)
    src = seg_table[:, RUN_BITOFF][r] + idx - starts[r]
    is_plain = seg_table[:, RUN_LITERAL][r] != 0
    return torch.where(is_plain, _take(plain_values, src), base)


def string_offsets(row_lengths: torch.Tensor) -> torch.Tensor:
    """Row byte lengths → the int32 offsets vector (capacity + 1 entries,
    first 0). Null and padding rows have length 0, so their offsets repeat
    the running total, as ``TorchColumnVector.from_strings`` lays out."""
    out = torch.zeros(row_lengths.shape[0] + 1, dtype=torch.int64,
                      device=row_lengths.device)
    out[1:] = torch.cumsum(row_lengths.to(torch.int64), 0)
    return out.to(torch.int32)


def gather_string_bytes(data_u8: torch.Tensor, row_starts: torch.Tensor,
                        offsets: torch.Tensor, out_len: int) -> torch.Tensor:
    """The output bytes: byte j belongs to row r (a binary search over the
    offsets) and reads ``data_u8[row_starts[r] + j - offsets[r]]``; bytes
    past the total length are zero."""
    dev = data_u8.device
    offs = offsets.to(torch.int64)
    j = torch.arange(out_len, dtype=torch.int64, device=dev)
    r = torch.searchsorted(offs[1:].contiguous(), j, right=True).clamp(
        0, row_starts.shape[0] - 1)
    src = row_starts[r].to(torch.int64) + (j - offs[r])
    got = _take(data_u8, src)
    return torch.where(j < offs[-1], got,
                       torch.zeros((), dtype=torch.uint8, device=dev))


def decode_bool_runs(run_table: torch.Tensor, data_u8: torch.Tensor,
                     out_len: int) -> torch.Tensor:
    """Booleans through the run machinery: a PLAIN bit-packed page stages
    as one literal run of width 1, an RLE page (data page v2) as ordinary
    runs; either way the value is ``expand_runs != 0``."""
    return expand_runs(run_table, data_u8, out_len) != 0
