"""Strings on the device: comparisons (port of ``string_compare``,
``spark_rapids_tpu/expressions/strings.py``), the order-preserving key
codes that groups, sorts and joins use, SQL ``LIKE`` (port of ``Like``,
``spark_rapids_tpu/expressions/regex.py``) and ``substring`` over ASCII
strings (``Substring``).

The reference compares strings on the host through pyarrow. Here both
sides stay as offsets + bytes on the device: a column, or a literal whose
bytes every row shares. The comparison walks byte position k = 0, 1, ...
over the common prefix of each row's two strings, all rows at once, and
keeps the sign of the first differing byte; rows whose prefixes agree
order by length. That is UTF-8 byte order, which is Spark's (and Arrow's)
string order. The walk is as long as the shorter side's longest string:
a literal's length, or one host read of the two columns' longest strings.

Key codes (``string_key_codes``): the reference dictionary-encodes string
keys on the host with pyarrow, in first-appearance order. Here each
string becomes one int64 whose order is the strings' UTF-8 byte order and
which is equal exactly for equal strings: up to 7 bytes the string packed
into the word itself, longer strings a dense rank over their big-endian
8-byte words with the length as the last tie-break. One host read (the
longest string) picks the form; the bytes never leave the device.
"""

from __future__ import annotations

from typing import List

import torch

from ..columnar.vector import TorchColumnVector, TorchScalar, row_mask
from ..types import BooleanT, DataType, StringT
from .base import (_DEFAULT_CTX, Expression, combine_validity,
                   make_column, to_column)

_INT64_SIGN = -2**63
#: strings up to this many bytes pack into one int64 with their length
PACKED_KEY_BYTES = 7


def _starts_lengths(col: TorchColumnVector):
    offs = col.offsets.to(torch.int64)
    return offs[:-1], offs[1:] - offs[:-1]


def _byte_at(col: TorchColumnVector, starts, lens, k: int) -> torch.Tensor:
    """Byte k of every row as int64, 0 past the row's end."""
    last = col.data.numel() - 1
    if last < 0:
        return torch.zeros_like(starts)
    byte = col.data[(starts + k).clamp(max=last)].to(torch.int64)
    return torch.where(k < lens, byte, 0)


def pack_short_strings(col: TorchColumnVector) -> torch.Tensor:
    """Each string of up to 7 bytes as one int64 whose signed order is the
    strings' byte order: the bytes big-endian in bits 63..8 (zero padded),
    the length in bits 7..0, the top bit flipped. Longer strings are cut
    (``string_key_codes`` ranks those instead)."""
    starts, lens = _starts_lengths(col)
    key = lens.clamp(max=PACKED_KEY_BYTES)
    for j in range(PACKED_KEY_BYTES):
        key = key | (_byte_at(col, starts, lens, j) << (56 - 8 * j))
    return key ^ _INT64_SIGN


def string_words(col: TorchColumnVector, width: int) -> List[torch.Tensor]:
    """The order key of each string as ``width + 1`` int64 columns: its
    bytes as ``width`` big-endian 8-byte words (zero padded, top bit
    flipped, so signed order is unsigned byte order), then its length.
    Compared lexicographically they order the strings by UTF-8 bytes: a
    zero-padded prefix ties with the longer string until the length. Two
    batches' words compare when padded to one width with
    ``PADDING_WORD``."""
    starts, lens = _starts_lengths(col)
    words = []
    for w in range(width):
        word = torch.zeros_like(starts)
        for j in range(8):
            word = word | (_byte_at(col, starts, lens, 8 * w + j)
                           << (56 - 8 * j))
        words.append(word ^ _INT64_SIGN)
    return words + [lens]


#: the word of eight zero bytes (``string_words``' padding)
PADDING_WORD = _INT64_SIGN


def longest_string(cols: List[TorchColumnVector]) -> int:
    """The longest string over the columns' rows: one host read, memoized
    on each column object."""
    todo = [c for c in cols if getattr(c, "_longest", None) is None]
    if todo:
        maxes = torch.stack([_starts_lengths(c)[1].max() if c.capacity
                             else c.offsets.new_zeros((), dtype=torch.int64)
                             for c in todo]).tolist()
        for c, m in zip(todo, maxes):
            c._longest = int(m)
    return max((c._longest for c in cols), default=0)


def string_key_codes(cols: List[TorchColumnVector]) -> List[torch.Tensor]:
    """One int64 code a row for each string column, comparable across all
    of ``cols``: a < b exactly when the strings compare so in UTF-8 byte
    order (Spark's), equal exactly when the strings are. Null and padding
    rows get codes too; callers mask them by validity."""
    longest = longest_string(cols)
    if longest <= PACKED_KEY_BYTES:
        return [pack_short_strings(c) for c in cols]
    width = -(-longest // 8)
    keys = [torch.cat(parts) for parts in
            zip(*(string_words(c, width) for c in cols))]
    # a lexicographic sort: the least significant key (the length) first,
    # each pass stable; then a dense rank over the sorted rows
    perm = torch.argsort(keys[-1], stable=True)
    for k in reversed(keys[:-1]):
        perm = perm[torch.argsort(k[perm], stable=True)]
    new = torch.zeros(perm.shape[0], dtype=torch.bool, device=perm.device)
    for k in keys:
        ks = k[perm]
        new[1:] |= ks[1:] != ks[:-1]
    rank = torch.empty_like(perm)
    rank[perm] = torch.cumsum(new, 0)
    return list(torch.split(rank, [c.capacity for c in cols]))


def _side(x, capacity: int, device):
    """(bytes, start int64 [cap], length int64 [cap], validity or None) of a
    string column or a string literal broadcast over the rows."""
    if isinstance(x, TorchScalar):
        raw = b"" if x.value is None else x.value.encode()
        data = torch.tensor(list(raw) or [0], dtype=torch.uint8,
                            device=device)
        start = torch.zeros(capacity, dtype=torch.int64, device=device)
        length = torch.full((capacity,), len(raw), dtype=torch.int64,
                            device=device)
        valid = None if x.value is not None else \
            torch.zeros(capacity, dtype=torch.bool, device=device)
        return data, start, length, valid
    offs = x.offsets.to(torch.int64)
    data = x.data if x.data.numel() else \
        torch.zeros(1, dtype=torch.uint8, device=device)
    return data, offs[:-1], offs[1:] - offs[:-1], x.validity


def compare_strings(l, r, capacity: int, device) -> tuple:
    """Per-row three-way comparison of two string sides (columns or
    literals): (int8 sign in {-1, 0, 1}, validity or None)."""
    ld, ls, ll, lv = _side(l, capacity, device)
    rd, rs, rl, rv = _side(r, capacity, device)
    # the walk's length: the shorter side's longest string (one host read
    # for the column sides; a literal's length is known)
    longest = [ln.max() if isinstance(x, TorchColumnVector) else ln[0]
               for x, ln in ((l, ll), (r, rl))]
    steps = min(torch.stack(longest).tolist()) if capacity else 0
    common = torch.minimum(ll, rl)
    sign = torch.zeros(capacity, dtype=torch.int8, device=device)
    open_ = torch.ones(capacity, dtype=torch.bool, device=device)
    l_last, r_last = ld.numel() - 1, rd.numel() - 1
    for k in range(steps):
        at = open_ & (k < common)
        lb = ld[(ls + k).clamp(max=l_last)].to(torch.int16)
        rb = rd[(rs + k).clamp(max=r_last)].to(torch.int16)
        diff = at & (lb != rb)
        sign = torch.where(diff, torch.where(lb < rb, -1, 1).to(torch.int8),
                           sign)
        open_ = open_ & ~diff
    by_len = torch.sign(ll - rl).to(torch.int8)
    sign = torch.where(open_, by_len, sign)
    return sign, combine_validity(lv, rv)


def string_compare(cmp_expr, l, r, batch) -> TorchColumnVector:
    """``cmp_expr`` (an EqualTo/LessThan/... node) over string operands,
    with Spark's nulls: null when either side is null."""
    cap, dev = batch.capacity, batch.device
    sign, valid = compare_strings(l, r, cap, dev)
    valid = combine_validity(valid, row_mask(batch.num_rows, cap, dev))
    return make_column(BooleanT, cmp_expr._sign_cmp(sign), valid,
                       batch.num_rows)


# ---------------------------------------------------------------------------
# LIKE
# ---------------------------------------------------------------------------


class Like(Expression):
    """SQL ``LIKE`` with ``%`` and ``_`` wildcards and an escape character
    (reference ``Like``, Spark's nulls: null in, null out).

    The pattern splits at ``%`` into segments of literal bytes and ``_``
    slots. The first segment must match at the start of the string, the
    last at its end, and each middle one at its leftmost match after the
    previous: a window compare over the byte buffer finds every match
    position, and a binary search over them gives each row the first at or
    after its cursor. Literals compare as UTF-8 bytes, which is exact for
    valid UTF-8 (a character's bytes never match inside another's). A
    ``_`` matches one byte, which is one character only over ASCII data:
    over a string with a non-ASCII byte the reference matches on the host
    by character, which is not yet ported here, so that case raises."""

    def __init__(self, child: Expression, pattern: str, escape: str = "\\"):
        self.children = (child,)
        self.pattern = pattern
        self.escape = escape

    @property
    def dtype(self) -> DataType:
        return BooleanT

    @property
    def nullable(self) -> bool:
        return self.children[0].nullable

    def pretty(self) -> str:
        return f"{self.children[0].pretty()} LIKE {self.pattern!r}"

    def _segments(self):
        """``%``-separated segments, each a list of (byte, is ``_``)."""
        segs: list = [[]]
        p, esc, i = self.pattern, self.escape, 0
        while i < len(p):
            ch = p[i]
            if ch == esc and i + 1 < len(p):
                segs[-1].extend((b, False) for b in p[i + 1].encode())
                i += 2
                continue
            if ch == "%":
                segs.append([])
            elif ch == "_":
                segs[-1].append((0, True))
            else:
                segs[-1].extend((b, False) for b in ch.encode())
            i += 1
        return segs

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        c = to_column(self.children[0].eval_device(batch, ctx), batch,
                      self.children[0].dtype)
        cap, dev = batch.capacity, batch.device
        starts, lens = _starts_lengths(c)
        segs = self._segments()
        data = c.data
        if any(w for seg in segs for _, w in seg) and data.numel() and bool(
                (data[:int(c.offsets[c.num_rows])] >= 0x80).any()):
            raise NotImplementedError(
                "LIKE with '_' over non-ASCII strings not yet ported")
        valid = combine_validity(c.validity, row_mask(batch.num_rows, cap,
                                                      dev))

        def window_hits(seg) -> torch.Tensor:
            """Every byte position of the buffer where ``seg`` starts."""
            n = data.numel()
            hit = torch.ones(n, dtype=torch.bool, device=dev)
            for j, (b, wild) in enumerate(seg):
                if wild:
                    continue
                at = torch.zeros(n, dtype=torch.bool, device=dev)
                if j < n:
                    at[:n - j] = data[j:] == b
                hit &= at
            return hit

        def matches_at(seg, pos) -> torch.Tensor:
            """Does ``seg`` match each row at row-relative ``pos``?"""
            fits = (pos >= 0) & (pos + len(seg) <= lens)
            if not data.numel():
                return fits
            at = (starts + pos).clamp(0, data.numel() - 1)
            return fits & window_hits(seg)[at]

        zero = torch.zeros_like(lens)
        if len(segs) == 1:
            ok = lens == len(segs[0])
            if segs[0]:
                ok = ok & matches_at(segs[0], zero)
            return make_column(BooleanT, ok, valid, batch.num_rows)
        ok = torch.ones(cap, dtype=torch.bool, device=dev)
        cur = zero
        if segs[0]:
            ok = ok & matches_at(segs[0], zero)
            cur = torch.full_like(lens, len(segs[0]))
        for seg in segs[1:-1]:
            if not seg:
                continue
            # the first match at or after each row's cursor, by a binary
            # search over the sorted match positions
            at = torch.nonzero(window_hits(seg)).flatten()
            if not at.numel():
                ok = torch.zeros_like(ok)
                continue
            k = torch.searchsorted(at, starts + cur)
            first = at[k.clamp(max=at.numel() - 1)] - starts
            found = (k < at.numel()) & (first + len(seg) <= lens)
            ok = ok & found
            cur = torch.where(found, first + len(seg), cur)
        if segs[-1]:
            tail = lens - len(segs[-1])
            ok = ok & (tail >= cur) & matches_at(segs[-1], tail)
        return make_column(BooleanT, ok, valid, batch.num_rows)


# ---------------------------------------------------------------------------
# substring
# ---------------------------------------------------------------------------


class Substring(Expression):
    """``substring(str, pos, len)`` with Spark's positions (reference
    ``Substring``): ``pos`` counts from 1, 0 acts as 1, a negative ``pos``
    counts from the end; the range clamps to the string and a negative
    ``len`` gives the empty string. Over ASCII strings a character is a
    byte: each row's byte range comes from its length, then one ragged
    gather copies the ranges into a new offsets + bytes column (never a
    view of the input). Over a string with a non-ASCII byte the reference
    slices by character on the host, which is not yet ported, so that
    case raises."""

    def __init__(self, child: Expression, pos: Expression,
                 length: Expression):
        self.children = (child, pos, length)

    @property
    def dtype(self) -> DataType:
        return StringT

    @property
    def nullable(self) -> bool:
        return self.children[0].nullable

    def _literals(self):
        from .base import Literal
        out = []
        for c in self.children[1:]:
            if not isinstance(c, Literal) or c.value is None:
                raise NotImplementedError(
                    "substring with a non-literal position or length not "
                    "yet ported")
            out.append(int(c.value))
        return out

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        pos, ln = self._literals()
        c = to_column(self.children[0].eval_device(batch, ctx), batch,
                      StringT)
        dev = batch.device
        n_bytes = int(c.offsets[c.num_rows])
        if n_bytes and bool((c.data[:n_bytes] >= 0x80).any()):
            raise NotImplementedError(
                "substring over non-ASCII strings not yet ported")
        starts, lens = _starts_lengths(c)
        valid = combine_validity(c.validity, row_mask(c.num_rows, c.capacity,
                                                      dev))
        if valid is not None:
            lens = torch.where(valid, lens, 0)
        if pos > 0:
            s0 = torch.full_like(lens, pos - 1)
        elif pos == 0:
            s0 = torch.zeros_like(lens)
        else:
            s0 = lens + pos
        lo = torch.minimum(s0.clamp(min=0), lens)
        hi = torch.minimum((s0 + max(ln, 0)).clamp(min=0), lens)
        out_lens = (hi - lo).clamp(min=0)
        offs = torch.zeros(c.capacity + 1, dtype=torch.int64, device=dev)
        offs[1:] = torch.cumsum(out_lens, 0)
        # the output is never longer than the input: its byte buffer fits
        src_bytes = c.data if c.data.numel() else \
            torch.zeros(1, dtype=torch.uint8, device=dev)
        at = torch.arange(src_bytes.shape[0], dtype=torch.int64, device=dev)
        row = torch.searchsorted(offs[1:], at, right=True).clamp(
            max=c.capacity - 1)
        src = (starts[row] + lo[row] + at - offs[row]).clamp(
            0, src_bytes.shape[0] - 1)
        data = torch.where(at < offs[-1], src_bytes[src],
                           torch.zeros((), dtype=torch.uint8, device=dev))
        return TorchColumnVector(StringT, data, c.validity, c.num_rows,
                                 offsets=offs.to(torch.int32))

    def pretty(self) -> str:
        c = self.children
        return (f"substring({c[0].pretty()}, {c[1].pretty()}, "
                f"{c[2].pretty()})")


# ---------------------------------------------------------------------------
# concat
# ---------------------------------------------------------------------------


def concat_columns(parts, out_cap: int, emit=None):
    """Row-wise concatenation of K string sides (port of the reference's
    ``kernels/strings.concat_columns``): ``parts`` per side (bytes,
    start int64 [cap], length int64 [cap]); ``emit`` per side an optional
    bool [cap], the rows where that side contributes. Each output byte finds
    its row by a binary search over the new offsets and its side by the
    row's running lengths; nothing is read back to the host. Returns
    (bytes [out_cap], offsets int32 [cap + 1])."""
    dev = parts[0][1].device
    lens = []
    for i, (_, _, ln) in enumerate(parts):
        ln = ln.clamp(min=0)
        if emit is not None and emit[i] is not None:
            ln = torch.where(emit[i], ln, 0)
        lens.append(ln)
    cap = lens[0].shape[0]
    offs = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    offs[1:] = torch.cumsum(sum(lens), 0)
    j = torch.arange(out_cap, dtype=torch.int64, device=dev)
    row = torch.searchsorted(offs[1:], j, right=True).clamp(
        max=max(cap - 1, 0))
    pos = j - offs[row]
    out = torch.zeros(out_cap, dtype=torch.uint8, device=dev)
    cum = torch.zeros(cap, dtype=torch.int64, device=dev)
    for (data, starts, _), ln in zip(parts, lens):
        at = pos - cum[row]
        sel = (at >= 0) & (at < ln[row]) & (j < offs[-1])
        src = (starts[row] + at).clamp(0, max(data.numel() - 1, 0))
        out = torch.where(sel, data[src], out)
        cum = cum + ln
    return out, offs.to(torch.int32)


def string_bytes_bound(values, sides, batch) -> int:
    """A bound on the bytes of a row-wise concatenation, known without a
    host sync: a column's byte buffer, a literal's bytes times the rows."""
    return max(1, sum(int(s[0].numel()) if isinstance(v, TorchColumnVector)
                      else len((v.value or "").encode()) * batch.capacity
                      for v, s in zip(values, sides)))


def string_sides(values, batch):
    """Each value (a string column or literal) as (bytes, start, length,
    validity or None) over the batch's capacity."""
    return [_side(v, batch.capacity, batch.device) for v in values]


class ConcatStr(Expression):
    """``concat(...)`` of strings: null when any input is (Spark's
    concat). One ragged gather over every input's bytes, UTF-8 safe."""

    def __init__(self, *children: Expression):
        self.children = tuple(children)

    @property
    def dtype(self) -> DataType:
        return StringT

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        values = [c.eval_device(batch, ctx) for c in self.children]
        sides = string_sides(values, batch)
        valid = combine_validity(*[s[3] for s in sides],
                                 row_mask(batch.num_rows, batch.capacity,
                                          batch.device))
        data, offs = concat_columns([s[:3] for s in sides],
                                    string_bytes_bound(values, sides, batch),
                                    [valid] * len(sides))
        return TorchColumnVector(StringT, data, valid, batch.num_rows,
                                 offsets=offs)

    def pretty(self) -> str:
        return f"concat({', '.join(c.pretty() for c in self.children)})"
