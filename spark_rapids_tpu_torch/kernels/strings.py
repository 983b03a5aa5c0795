"""Device string kernels over the offsets + bytes layout (port of
``spark_rapids_tpu/kernels/strings.py``).

A string column is int32 offsets [capacity + 1] and a flat uint8 byte
buffer, both on the device. Every op is a composition of three pieces, as
in the reference:

  1. a byte → row map (a binary search over the offsets),
  2. per-row reductions over the bytes (first/last/nth/count a row),
  3. one ragged gather that builds the output bytes from per-row
     (start, length) ranges, into an output capacity bounded without a
     host read.

The reference reduces a row's bytes with ``.at[rows].min/max/add``
scatters (``segment_min``/``segment_max``/``segment_sum``). On CUDA those
are atomics on each row's slot, ~30 bytes contending a row, and an
integer min is a compare-and-swap loop: here a row's first, last or nth
marked byte comes from a prefix count of the marks and one binary search
a row (``nth_true``), and a row's sum from the prefix count read at its
offsets. Nothing is scattered per byte.

Ops with character (not byte) semantics run on the device over ASCII data
(a character is a byte) and leave non-ASCII input to the caller's host
path. Positions and lengths are int64 here (the reference's are int32).

Two walks the reference runs as sequential scans (``greedy_matches``'s
self-overlapping patterns, ``lax.scan`` over the bytes, and the regex
replace's match selection, ``lax.scan`` over row positions) are one
pointer-doubling pass here (``take_chains``): each candidate links to the
first candidate it leaves room for, and ⌈log2 k⌉ steps mark every link of
each row's chain. The chains are the same, so the result is.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------

def starts_lengths(offsets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (start, byte length), int64, from an offsets vector."""
    offs = offsets.to(torch.int64)
    return offs[:-1], offs[1:] - offs[:-1]


def new_offsets(lengths: torch.Tensor) -> torch.Tensor:
    """int64 offsets [n + 1] of rows with these lengths."""
    offs = torch.zeros(lengths.shape[0] + 1, dtype=torch.int64,
                       device=lengths.device)
    offs[1:] = torch.cumsum(lengths.to(torch.int64), 0)
    return offs


def byte_rows(offsets: torch.Tensor, nbytes: int) -> torch.Tensor:
    """Row index of every byte position in [0, nbytes). Bytes past the
    last offset map to the row count (callers mask them)."""
    at = torch.arange(nbytes, dtype=torch.int64, device=offsets.device)
    return torch.searchsorted(offsets[1:].to(torch.int64), at, right=True)


def fill_string_stats(cols) -> None:
    """Memoize on each column object (``col._stats``: every byte ASCII,
    longest row in bytes; ``col._used``: the bytes in use) what it lacks,
    in one host read for all of ``cols``, so the expressions and keys of
    one batch over one column read it once."""
    todo = [c for c in cols if getattr(c, "_stats", None) is None]
    got = []
    for col in todo:
        if col.capacity == 0:
            col._stats, col._used = (True, 0), 0
            continue
        offs = col.offsets.to(torch.int64)
        used = offs[-1]
        longest = (offs[1:] - offs[:-1]).max()
        data = col.data[:max(col.data.numel(), 1)]
        wide = ((data >= 0x80)
                & (torch.arange(data.numel(), device=col.device) < used)
                ).any() if col.data.numel() else \
            torch.zeros((), dtype=torch.bool, device=col.device)
        got.append((col, torch.stack([longest, wide.to(torch.int64),
                                      used])))
    if got:
        from ..columnar.vector import audited_tolist
        vals = audited_tolist(torch.stack([g for _, g in got]), "fetch")
        for (col, _), (longest, wide, used) in zip(got, vals):
            col._stats, col._used = (not wide, int(longest)), int(used)


def string_stats(col) -> Tuple[bool, int]:
    """(every byte ASCII, longest row in bytes) of a string column, read
    once and memoized (``fill_string_stats``)."""
    fill_string_stats([col])
    return col._stats


def tight(col):
    """The column with its byte buffer cut to the bytes its rows use (a
    filter or a gather keeps its input's buffer, and the byte-level passes
    are as long as the buffer); the stats carry over."""
    string_stats(col)
    if col.data.numel() <= max(col._used, 1):
        return col
    out = type(col)(col.dtype, col.data[:max(col._used, 1)], col.validity,
                    col.num_rows, offsets=col.offsets)
    out._stats, out._used = col._stats, col._used
    return out


def _prefix(mask: torch.Tensor) -> torch.Tensor:
    """int64 [n + 1]: how many of mask[:i] are true, for each i."""
    cs = torch.zeros(mask.shape[0] + 1, dtype=torch.int64,
                     device=mask.device)
    cs[1:] = torch.cumsum(mask, 0)
    return cs


def nth_true(mask: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor,
             nth: torch.Tensor) -> torch.Tensor:
    """int64 [n]: the position of the nth (1-based, per row) true byte of
    ``mask`` in each row's [start, end), or -1. A prefix count and one
    binary search a row: no atomics, whatever the rows' lengths."""
    cs = _prefix(mask)
    k0 = cs[starts.clamp(0, mask.shape[0])]
    k1 = cs[ends.clamp(0, mask.shape[0])]
    want = k0 + nth
    pos = torch.searchsorted(cs, want) - 1
    ok = (nth >= 1) & (want <= k1)
    return torch.where(ok, pos, -1)


# ---------------------------------------------------------------------------
# the ragged output builders
# ---------------------------------------------------------------------------

def gather_plan(starts: torch.Tensor, lengths: torch.Tensor, out_cap: int,
                stride: Optional[torch.Tensor] = None):
    """The shared ragged-gather index computation: output slot j of row i
    reads source index starts[i] + k * stride[i], k being j's position in
    its row. Returns (src [out_cap], in_range [out_cap], new offsets
    int64 [n + 1])."""
    n = starts.shape[0]
    offs = new_offsets(lengths.clamp(min=0))
    j = torch.arange(out_cap, dtype=torch.int64, device=starts.device)
    row = torch.searchsorted(offs[1:], j, right=True).clamp(max=max(n - 1, 0))
    pos = j - offs[row]
    step = stride[row] if stride is not None else 1
    src = starts[row] + pos * step
    return src, j < offs[n], offs


def build_ranges(data: torch.Tensor, starts: torch.Tensor,
                 lengths: torch.Tensor, out_cap: int,
                 stride: Optional[torch.Tensor] = None):
    """A new string column whose row i is data[starts[i] : starts[i] +
    lengths[i]] (negative lengths clamp to 0); ``stride`` -1 with a start
    at the row's last byte reverses. Returns (bytes [out_cap], int32
    offsets [n + 1])."""
    out_cap = max(int(out_cap), 1)
    nbytes = data.numel()
    src, in_range, offs = gather_plan(starts, lengths, out_cap, stride)
    if nbytes == 0:
        return torch.zeros(out_cap, dtype=torch.uint8,
                           device=data.device), offs.to(torch.int32)
    out = torch.where(in_range, data[src.clamp(0, nbytes - 1)],
                      torch.zeros((), dtype=torch.uint8, device=data.device))
    return out, offs.to(torch.int32)


def build_from_contributions(data: torch.Tensor, keep: torch.Tensor,
                             offsets: torch.Tensor, out_cap: int,
                             replace_at: Optional[torch.Tensor] = None,
                             replacement: Optional[np.ndarray] = None,
                             mapped: Optional[torch.Tensor] = None):
    """Per-input-byte output: input byte j emits ``replacement`` where
    replace_at[j] (a taken match start), nothing where not keep[j], else
    the byte mapped[j] (default data[j]). Each byte's output position is
    the exclusive prefix sum of the emit counts. Returns (bytes [out_cap],
    int32 offsets [n + 1]) — the translate/replace/delete builder."""
    out_cap = max(int(out_cap), 1)
    nbytes = data.numel()
    dev = data.device
    rlen = 0 if replacement is None else int(len(replacement))
    contrib = keep.to(torch.int64)
    if replace_at is not None:
        contrib = torch.where(replace_at, rlen, contrib)
    cum = torch.zeros(nbytes + 1, dtype=torch.int64, device=dev)
    cum[1:] = torch.cumsum(contrib, 0)
    out_pos = cum[:-1]
    # a row's output length: the emit counts' prefix sum at its offsets
    bounds = offsets.to(torch.int64).clamp(max=nbytes)
    offs = new_offsets(cum[bounds[1:]] - cum[bounds[:-1]])
    src = data if mapped is None else mapped
    out = torch.zeros(out_cap + 1, dtype=torch.uint8, device=dev)
    plain = keep if replace_at is None else keep & ~replace_at
    out[torch.where(plain, out_pos, out_cap).clamp(max=out_cap)] = \
        src.to(torch.uint8)
    if replace_at is not None and rlen:
        at = torch.nonzero(replace_at).flatten()
        base = out_pos[at]
        for k in range(rlen):
            out[(base + k).clamp(max=out_cap)] = int(replacement[k])
    out[out_cap] = 0
    return out[:out_cap], offs.to(torch.int32)


def concat_columns(parts: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]],
                   out_cap: int, part_emit=None, seps=None):
    """Row-wise concatenation of K string sides. ``parts``: per side
    (bytes, start int64 [cap], length int64 [cap]); ``part_emit``: per
    side an optional bool [cap], the rows where that side contributes;
    ``seps``: per side None or (separator bytes, bool [cap] emit), the
    separator written before that side's bytes where emit (concat_ws).
    Each output byte finds its row by a binary search over the new
    offsets and its side by the row's running lengths; nothing is read
    back to the host. Returns (bytes [out_cap], int32 offsets [cap + 1])."""
    out_cap = max(int(out_cap), 1)
    dev = parts[0][1].device
    cap = parts[0][1].shape[0]
    pieces = []  # (kind, payload, length) in output order within a row
    for i, (data, starts, ln) in enumerate(parts):
        ln = ln.clamp(min=0)
        if part_emit is not None and part_emit[i] is not None:
            ln = torch.where(part_emit[i], ln, 0)
        if seps is not None and seps[i] is not None:
            sep, emit = seps[i]
            slen = torch.where(emit, len(sep), 0).to(torch.int64)
            pieces.append(("sep", sep, slen))
        pieces.append(("col", (data, starts), ln))
    offs = new_offsets(sum(p[2] for p in pieces))
    j = torch.arange(out_cap, dtype=torch.int64, device=dev)
    row = torch.searchsorted(offs[1:], j, right=True).clamp(
        max=max(cap - 1, 0))
    pos = j - offs[row]
    live = j < offs[-1]
    out = torch.zeros(out_cap, dtype=torch.uint8, device=dev)
    cum = torch.zeros(cap, dtype=torch.int64, device=dev)
    for kind, payload, ln in pieces:
        at = pos - cum[row]
        sel = (at >= 0) & (at < ln[row]) & live
        if kind == "sep":
            if len(payload):
                sep_t = torch.tensor(list(payload), dtype=torch.uint8,
                                     device=dev)
                out = torch.where(sel, sep_t[at.clamp(0, len(payload) - 1)],
                                  out)
        else:
            data, starts = payload
            if data.numel():
                src = (starts[row] + at).clamp(0, data.numel() - 1)
                out = torch.where(sel, data[src], out)
        cum = cum + ln
    return out, offs.to(torch.int32)


# ---------------------------------------------------------------------------
# pattern search
# ---------------------------------------------------------------------------

def match_windows(data: torch.Tensor, offsets: torch.Tensor,
                  pattern: np.ndarray,
                  wildcard: Optional[np.ndarray] = None) -> torch.Tensor:
    """bool [nbytes]: position j starts a match of ``pattern`` (static
    bytes) that lies inside j's row. ``wildcard`` marks pattern bytes that
    match any byte (LIKE ``_``). An empty pattern matches everywhere. One
    shifted compare a pattern byte: no [nbytes, plen] window is built."""
    nbytes = data.numel()
    plen = int(len(pattern))
    dev = data.device
    if nbytes == 0:
        return torch.zeros(0, dtype=torch.bool, device=dev)
    hit = torch.ones(nbytes, dtype=torch.bool, device=dev)
    if plen == 0:
        return hit
    for k in range(plen):
        if wildcard is not None and wildcard[k]:
            continue
        at = torch.zeros(nbytes, dtype=torch.bool, device=dev)
        if k < nbytes:
            at[:nbytes - k] = data[k:] == int(pattern[k])
        hit &= at
    rows = byte_rows(offsets, nbytes)
    row_end = offsets.to(torch.int64)[(rows + 1).clamp(
        max=offsets.shape[0] - 1)]
    j = torch.arange(nbytes, dtype=torch.int64, device=dev)
    return hit & (j + plen <= row_end) & (rows < offsets.shape[0] - 1)


def _pos_in_row(offsets: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    at = torch.arange(rows.shape[0], dtype=torch.int64, device=rows.device)
    return at - offsets.to(torch.int64)[rows.clamp(max=offsets.shape[0] - 2)]


def first_match(data: torch.Tensor, offsets: torch.Tensor,
                pattern: np.ndarray, from_pos: Optional[torch.Tensor] = None,
                wildcard: Optional[np.ndarray] = None) -> torch.Tensor:
    """int64 [n]: byte position within the row of the first match of
    ``pattern``, or -1; ``from_pos`` [n] keeps positions >= it."""
    n = offsets.shape[0] - 1
    nbytes = data.numel()
    if nbytes == 0 or n == 0:
        return torch.full((n,), -1, dtype=torch.int64, device=data.device)
    hit = match_windows(data, offsets, pattern, wildcard)
    starts, lens = starts_lengths(offsets)
    lo = starts if from_pos is None else starts + from_pos.clamp(min=0)
    at = nth_true(hit, lo, starts + lens, torch.ones_like(starts))
    return torch.where(at >= 0, at - starts, -1)


def take_chains(cand: torch.Tensor, rows: torch.Tensor,
                ends: torch.Tensor) -> torch.Tensor:
    """Left-to-right non-overlapping selection: bool [nbytes] of the
    candidates taken when each row scans left to right and takes a
    candidate j at or past the end of the last one it took (candidate j
    ends at ``ends[j]``, exclusive). Each candidate links to the first
    candidate of its row at or past its end; every row's first candidate
    is taken, and pointer doubling marks the rest of its chain in
    ⌈log2 k⌉ steps for chains of k links."""
    dev = cand.device
    nbytes = cand.shape[0]
    taken = torch.zeros(nbytes, dtype=torch.bool, device=dev)
    at = torch.nonzero(cand).flatten()
    m = at.shape[0]
    if m == 0:
        return taken
    r = rows[at]
    first = torch.ones(m, dtype=torch.bool, device=dev)
    first[1:] = r[1:] != r[:-1]
    k = torch.searchsorted(at, ends[at])
    nxt = torch.where((k < m) & (r[k.clamp(max=m - 1)] == r), k, m)
    on = torch.cat([first, torch.zeros(1, dtype=torch.bool, device=dev)]
                   ).to(torch.int32)
    nxt = torch.cat([nxt, torch.full((1,), m, dtype=nxt.dtype, device=dev)])
    # a chain has at most m links; stop once every jump leaves its row
    while bool((nxt[:-1] < m).any()):
        on = on.scatter_reduce(0, nxt, on, reduce="amax", include_self=True)
        nxt = nxt[nxt]
    taken[at] = on[:-1].to(torch.bool)
    return taken


def greedy_matches(data: torch.Tensor, offsets: torch.Tensor,
                   pattern: np.ndarray) -> torch.Tensor:
    """bool [nbytes]: left-to-right non-overlapping match starts (replace()
    semantics). A pattern that cannot overlap itself takes every window
    match; a self-overlapping one resolves its chains with
    ``take_chains``."""
    plen = int(len(pattern))
    hit = match_windows(data, offsets, pattern)
    if plen <= 1:
        return hit
    p = bytes(pattern.tobytes())
    if not any(p[:k] == p[-k:] for k in range(1, plen)):
        return hit
    nbytes = data.numel()
    if nbytes == 0:
        return hit
    ends = torch.arange(nbytes, dtype=torch.int64, device=data.device) + plen
    return take_chains(hit, byte_rows(offsets, nbytes), ends)


def nth_match(data: torch.Tensor, offsets: torch.Tensor, pattern: np.ndarray,
              nth: int) -> torch.Tensor:
    """int64 [n]: in-row byte position of the nth (1-based) non-overlapping
    left-to-right match, or -1; a negative nth counts from the end."""
    n = offsets.shape[0] - 1
    nbytes = data.numel()
    if nbytes == 0 or n == 0:
        return torch.full((n,), -1, dtype=torch.int64, device=data.device)
    hit = greedy_matches(data, offsets, pattern)
    starts, lens = starts_lengths(offsets)
    ends = starts + lens
    if nth >= 0:
        want = torch.full_like(starts, nth)
    else:
        cs = _prefix(hit)
        total = cs[ends.clamp(max=nbytes)] - cs[starts.clamp(max=nbytes)]
        want = total + (nth + 1)
    at = nth_true(hit, starts, ends, want)
    return torch.where(at >= 0, at - starts, -1)


def build_repeat(data: torch.Tensor, starts: torch.Tensor,
                 lengths: torch.Tensor, times: int, out_cap: int):
    """repeat(str, times): each row's bytes tiled ``times`` times (UTF-8
    safe). Returns (bytes [out_cap], int32 offsets [n + 1])."""
    out_cap = max(int(out_cap), 1)
    n = starts.shape[0]
    nbytes = data.numel()
    lengths = lengths.clamp(min=0)
    times = max(int(times), 0)
    offs = new_offsets(lengths * times)
    if nbytes == 0 or times == 0:
        return torch.zeros(out_cap, dtype=torch.uint8,
                           device=data.device), offs.to(torch.int32)
    j = torch.arange(out_cap, dtype=torch.int64, device=data.device)
    row = torch.searchsorted(offs[1:], j, right=True).clamp(max=max(n - 1, 0))
    pos = j - offs[row]
    src = starts[row] + pos % lengths[row].clamp(min=1)
    out = torch.where(j < offs[n], data[src.clamp(0, nbytes - 1)],
                      torch.zeros((), dtype=torch.uint8, device=data.device))
    return out, offs.to(torch.int32)


def build_pad(data: torch.Tensor, starts: torch.Tensor, lengths: torch.Tensor,
              target: int, pad: np.ndarray, left: bool, out_cap: int,
              active: Optional[torch.Tensor] = None):
    """lpad/rpad to ``target`` characters with the literal ``pad`` (ASCII,
    gated by the caller): longer rows cut to ``target``, an empty pad
    leaves shorter rows as they are; ``active`` [n] keeps padding rows
    empty. Returns (bytes [out_cap], int32 offsets [n + 1])."""
    out_cap = max(int(out_cap), 1)
    n = starts.shape[0]
    nbytes = data.numel()
    plen = int(len(pad))
    target = max(int(target), 0)
    lengths = lengths.clamp(min=0)
    dev = data.device
    if plen == 0:
        return build_ranges(data, starts, lengths.clamp(max=target), out_cap)
    new_lens = torch.full((n,), target, dtype=torch.int64, device=dev)
    if active is not None:
        new_lens = torch.where(active, new_lens, 0)
    offs = new_offsets(new_lens)
    j = torch.arange(out_cap, dtype=torch.int64, device=dev)
    row = torch.searchsorted(offs[1:], j, right=True).clamp(max=max(n - 1, 0))
    pos = j - offs[row]
    ln = lengths[row]
    fill = (target - ln).clamp(min=0)
    pad_t = torch.tensor(list(pad.tobytes()), dtype=torch.uint8, device=dev)
    if left:
        from_pad = pos < fill
        src = starts[row] + pos - fill
        pad_pos = pos % plen
    else:
        from_pad = pos >= ln.clamp(max=target)
        src = starts[row] + pos
        pad_pos = (pos - ln).clamp(min=0) % plen
    byte = pad_t[pad_pos]
    if nbytes:
        byte = torch.where(from_pad, byte, data[src.clamp(0, nbytes - 1)])
    out = torch.where(j < offs[n], byte,
                      torch.zeros((), dtype=torch.uint8, device=dev))
    return out, offs.to(torch.int32)
