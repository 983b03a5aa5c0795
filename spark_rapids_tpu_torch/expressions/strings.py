"""String expressions on the device (port of
``spark_rapids_tpu/expressions/strings.py``): comparisons, the
order-preserving key codes that groups, sorts and joins use, SQL ``LIKE``
(the reference's ``Like`` is in ``expressions/regex.py``), ``substring``,
``concat`` and the string function family (``length``, ``upper``/``lower``,
``startswith``/``endswith``/``contains``, the trims, ``reverse``,
``initcap``, ``repeat``, ``replace``, ``locate``/``instr``,
``lpad``/``rpad``, ``translate``, ``concat_ws``, ``substring_index``,
``octet_length``/``bit_length``, ``ascii``, ``format_number``, ``conv``).

A string column is offsets + bytes on the device, and the functions are
compositions of ``kernels/strings.py``'s ragged kernels. The reference's
split between device and host is kept: byte-oriented ops (concat,
replace, repeat, substring_index, the pattern predicates, length) run on
the device for any UTF-8; character-oriented ops (substring, pad, locate,
initcap, reverse, trim, case mapping, ascii, translate, LIKE's ``_``) run
on the device when the column is ASCII (a character is a byte) and on the
host through pyarrow otherwise; a non-literal argument and the host row
ops (``format_number``, ``conv``) go to the host too. Whether a column is
ASCII, and its longest string, is one host read a column a batch
(``kernels/strings.string_stats``). Every batch that takes the host hop is
counted in the session's counters as ``strings.hostPath`` and
``strings.hostPath.<class>.<reason>`` (``host_path_counts``).

Host evaluation (``eval_cpu``, the host engine) runs each function over
Arrow rows with the host hop's own code: pyarrow's kernels where Spark's
rule and Arrow's agree, the reference's row functions elsewhere.

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

import re
from typing import List, Optional

import numpy as np
import torch

from ..columnar.vector import (TorchColumnVector, TorchScalar,
                               audited_tolist, bucket_capacity,
                               column_to_arrow, row_mask)
from ..kernels import strings as SK
from ..kernels.strings import concat_columns  # noqa: F401  (callers here)
from ..types import BooleanT, DataType, IntegerT, StringT
from .base import (_DEFAULT_CTX, Expression, UnaryExpression, arrow_column,
                   combine_validity, is_arrow, make_column, to_column)

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
    """The longest string over the columns' rows, from their memoized
    stats (``kernels/strings.fill_string_stats``: one host read)."""
    SK.fill_string_stats(cols)
    return max((c._stats[1] for c in cols), default=0)


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
    steps = min(audited_tolist(torch.stack(longest), "scalar")) \
        if capacity else 0
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
# the host hop (reference ``_to_arrow_side`` / ``_string_result_from_arrow``)
# ---------------------------------------------------------------------------

#: the session counter of batches an expression took through the host
HOST_PATH = "strings.hostPath"


def host_path(ctx, expr, reason: str) -> None:
    """Count one batch of ``expr`` (an expression, or a class name) through
    the host hop: ``strings.hostPath`` and ``strings.hostPath.<class>.
    <reason>`` in the session's counters."""
    name = expr if isinstance(expr, str) else type(expr).__name__
    ctx.counters[HOST_PATH] += 1
    ctx.counters[f"{HOST_PATH}.{name}.{reason}"] += 1


def host_path_counts(counters) -> dict:
    """{(class, reason): batches} of the host-path counters."""
    out = {}
    for k, v in counters.items():
        if k.startswith(HOST_PATH + ".") and v:
            name, _, reason = k[len(HOST_PATH) + 1:].partition(".")
            out[(name, reason)] = v
    return out


def column_from_arrow(arr, dtype: DataType, batch) -> TorchColumnVector:
    """An Arrow result of the batch's rows as a column at the batch's
    capacity on its device (the host hop's upload)."""
    import pyarrow as pa
    from ..types import DateType, DecimalType, StringType, TimestampType
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    n = len(arr)
    validity = np.asarray(arr.is_valid()) if arr.null_count else None
    if isinstance(dtype, StringType):
        if pa.types.is_large_string(arr.type):
            arr = arr.cast(pa.string())
        bufs = arr.buffers()
        offsets = (np.frombuffer(bufs[1], np.int32, n + 1, arr.offset * 4)
                   .astype(np.int64) if n else np.zeros(1, np.int64))
        base = int(offsets[0])
        offsets = (offsets - base).astype(np.int32)
        nb = int(offsets[-1])
        chars = np.frombuffer(bufs[2], np.uint8, nb, base) if nb else \
            np.zeros(0, np.uint8)
        return TorchColumnVector.from_strings(
            dtype, offsets, chars, validity, capacity=batch.capacity,
            device=batch.device)
    if isinstance(dtype, DecimalType):
        from ..columnar.vector import decimal_from_arrow
        return TorchColumnVector.from_numpy(
            dtype, decimal_from_arrow(arr, dtype), validity,
            capacity=batch.capacity, device=batch.device)
    if isinstance(dtype, DateType):
        arr = arr.cast(pa.int32())
    elif isinstance(dtype, TimestampType):
        arr = arr.cast(pa.int64())
    fill = False if pa.types.is_boolean(arr.type) else 0
    vals = np.asarray(arr.fill_null(fill).to_numpy(zero_copy_only=False))
    return TorchColumnVector.from_numpy(dtype, vals, validity,
                                        capacity=batch.capacity,
                                        device=batch.device)


def rows_of(x, n: int) -> list:
    """A column's (or scalar's) logical rows as Python values."""
    if isinstance(x, TorchScalar):
        return [x.value] * n
    return x.to_pylist()


def cpu_rows_of(x, n: int) -> list:
    """A host result's rows as Python values (a constant repeated)."""
    return x.to_pylist() if is_arrow(x) else [x] * n


def _cpu_unary(expr, table, ctx, fn):
    """``eval_cpu`` of a function of its first (string) child: ``fn`` over
    the child's Arrow rows; a constant child folds to a Python value."""
    import pyarrow as pa
    v = expr.children[0].eval_cpu(table, ctx)
    if is_arrow(v):
        return fn(arrow_column(v, len(v), StringT))
    if v is None:
        return None
    return fn(pa.array([v], pa.string()))[0].as_py()


def _cpu_row_map(expr, table, ctx, row_fn):
    """``eval_cpu`` a row at a time over every child's Python values."""
    import pyarrow as pa
    from ..types import to_arrow
    n = table.num_rows
    ins = [cpu_rows_of(c.eval_cpu(table, ctx), n) for c in expr.children]
    return pa.array([row_fn(*r) for r in zip(*ins)],
                    type=to_arrow(expr.dtype))


def _pat_bytes(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("utf-8"), dtype=np.uint8)


def _literal_value(e: Expression):
    """The value of a literal argument, or ``_NOT_LITERAL``."""
    from .base import Literal
    return e.value if isinstance(e, Literal) else _NOT_LITERAL


_NOT_LITERAL = object()


def _string_input(expr: Expression, batch, ctx) -> TorchColumnVector:
    """A string operand as a column over the batch (a literal built on the
    device), its byte buffer cut to the bytes in use."""
    return SK.tight(to_column(expr.eval_device(batch, ctx), batch, StringT))


def _valid(c: TorchColumnVector, batch) -> Optional[torch.Tensor]:
    return combine_validity(c.validity, row_mask(batch.num_rows,
                                                 batch.capacity,
                                                 batch.device))


def _str_col(batch, data, offsets, validity) -> TorchColumnVector:
    return TorchColumnVector(StringT, data, validity, batch.num_rows,
                             offsets=offsets)


def _ascii(c: TorchColumnVector) -> bool:
    return SK.string_stats(c)[0]


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
    over a string with a non-ASCII byte the batch matches on the host by
    character, as the reference does (its regex translation, counted in
    ``strings.hostPath``)."""

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

    def _to_regex(self) -> str:
        """The pattern as an anchored regex (reference ``_to_regex``)."""
        out, p, i = ["^"], self.pattern, 0
        while i < len(p):
            ch = p[i]
            if ch == self.escape and i + 1 < len(p):
                out.append(re.escape(p[i + 1]))
                i += 2
                continue
            out.append(".*" if ch == "%" else "." if ch == "_"
                       else re.escape(ch))
            i += 1
        out.append("$")
        return "".join(out)

    def _match_host(self, c: TorchColumnVector, batch):
        """Character-wise LIKE on the host (reference ``_match_host``:
        fullmatch, so a trailing newline is not matched by ``$``)."""
        return column_from_arrow(self._host(column_to_arrow(c)), BooleanT,
                                 batch)

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        c = to_column(self.children[0].eval_device(batch, ctx), batch,
                      self.children[0].dtype)
        cap, dev = batch.capacity, batch.device
        starts, lens = _starts_lengths(c)
        segs = self._segments()
        data = c.data
        if any(w for seg in segs for _, w in seg) and not _ascii(c):
            host_path(ctx, self, "non-ASCII")
            return self._match_host(c, batch)
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

    def _host(self, arr):
        """LIKE by character over Arrow rows: Arrow's ``match_like`` (its
        ``%`` and ``_`` match any character, a newline too) where the
        escape is ``\\`` before ``%``, ``_`` or itself; else the pattern's
        regex, a row at a time."""
        import pyarrow as pa
        import pyarrow.compute as pc
        p, i, arrow_ok = self.pattern, 0, self.escape == "\\"
        while i < len(p) and arrow_ok:
            if p[i] == "\\":
                arrow_ok = i + 1 < len(p) and p[i + 1] in "%_\\"
                i += 1
            i += 1
        if arrow_ok:
            return pc.match_like(arr, pattern=p)
        prog = re.compile(self._to_regex(), re.DOTALL)
        return pa.array([None if v is None else bool(prog.fullmatch(v))
                         for v in arr.to_pylist()], pa.bool_())

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return _cpu_unary(self, table, ctx, self._host)


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
    view of the input). Over a string with a non-ASCII byte the batch is
    sliced by character on the host, as the reference does
    (``utf8_slice_codeunits``, counted in ``strings.hostPath``)."""

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
        if not _ascii(c):
            host_path(ctx, self, "non-ASCII")
            return column_from_arrow(self._host(column_to_arrow(c)), StringT,
                                     batch)
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

    def _host(self, arr):
        """Spark's positions by character over Arrow rows."""
        import pyarrow.compute as pc
        pos, ln = self._literals()
        start = pos - 1 if pos > 0 else (0 if pos == 0 else pos)
        if start >= 0:
            stop = start + max(ln, 0)
        else:
            stop = start + ln if start + ln < 0 else np.iinfo(np.int32).max
        return pc.utf8_slice_codeunits(arr, start=start, stop=stop)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return _cpu_unary(self, table, ctx, self._host)


# ---------------------------------------------------------------------------
# concat
# ---------------------------------------------------------------------------


# ``concat_columns`` lives in ``kernels/strings.py`` beside its reference
# counterpart; it is imported here for the callers that name it here.


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
                                    part_emit=[valid] * len(sides))
        return TorchColumnVector(StringT, data, valid, batch.num_rows,
                                 offsets=offs)

    def pretty(self) -> str:
        return f"concat({', '.join(c.pretty() for c in self.children)})"

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        import pyarrow.compute as pc
        vals = [c.eval_cpu(table, ctx) for c in self.children]
        if not any(is_arrow(v) for v in vals):
            return None if any(v is None for v in vals) else "".join(vals)
        n = table.num_rows
        return pc.binary_join_element_wise(
            *[arrow_column(v, n, StringT) for v in vals], "",
            null_handling="emit_null")


# ---------------------------------------------------------------------------
# the string function family (reference stringFunctions.scala through
# ``spark_rapids_tpu/expressions/strings.py``)
# ---------------------------------------------------------------------------


class _StringUnary(UnaryExpression):
    """A one-string-argument function; a literal argument is built as a
    column on the device first."""

    _name = ""

    def _input(self, batch, ctx) -> TorchColumnVector:
        return _string_input(self.child, batch, ctx)

    def pretty(self) -> str:
        return f"{self._name or type(self).__name__.lower()}(" \
            f"{self.child.pretty()})"


class Length(_StringUnary):
    """char_length: UTF-8 characters (not bytes), as Spark: the bytes that
    are not continuation bytes ((b & 0xC0) != 0x80), counted a row by a
    prefix sum read at the offsets."""

    _name = "length"

    @property
    def dtype(self) -> DataType:
        return IntegerT

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        c = self._input(batch, ctx)
        lead = torch.zeros(c.data.numel() + 1, dtype=torch.int64,
                           device=c.device)
        lead[1:] = torch.cumsum((c.data & 0xC0) != 0x80, 0)
        offs = c.offsets.to(torch.int64)
        counts = (lead[offs[1:]] - lead[offs[:-1]]).to(torch.int32)
        return make_column(IntegerT, counts, _valid(c, batch), batch.num_rows)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        import pyarrow.compute as pc
        return _cpu_unary(self, table, ctx, pc.utf8_length)


class _CaseMap(_StringUnary):
    """ASCII case mapping on the device, in place of the bytes; non-ASCII
    input through the host (pyarrow's Unicode case mapping)."""

    _lo, _hi, _delta, _pc = 0, 0, 0, ""

    @property
    def dtype(self) -> DataType:
        return StringT

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        c = self._input(batch, ctx)
        if not _ascii(c):
            import pyarrow.compute as pc
            host_path(ctx, self, "non-ASCII")
            return column_from_arrow(getattr(pc, self._pc)(
                column_to_arrow(c)), StringT, batch)
        hit = (c.data >= self._lo) & (c.data <= self._hi)
        data = torch.where(hit, c.data + self._delta, c.data).to(torch.uint8)
        return _str_col(batch, data, c.offsets, c.validity)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        import pyarrow.compute as pc
        return _cpu_unary(self, table, ctx, getattr(pc, self._pc))


class Upper(_CaseMap):
    _name, _lo, _hi, _delta, _pc = "upper", ord("a"), ord("z"), -32, \
        "utf8_upper"


class Lower(_CaseMap):
    _name, _lo, _hi, _delta, _pc = "lower", ord("A"), ord("Z"), 32, \
        "utf8_lower"


class _PatternPredicate(Expression):
    """startswith / endswith / contains against a pattern: a literal
    pattern on the device (byte matching of well-formed UTF-8 is
    character-safe), a column pattern through the host."""

    _pc = ""

    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    @property
    def dtype(self) -> DataType:
        return BooleanT

    def _device(self, c: TorchColumnVector, pb: np.ndarray):
        raise NotImplementedError

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        c = _string_input(self.children[0], batch, ctx)
        pat = _literal_value(self.children[1])
        valid = _valid(c, batch)
        if pat is _NOT_LITERAL:
            import pyarrow.compute as pc
            host_path(ctx, self, "non-literal argument")
            pats = rows_of(self.children[1].eval_device(batch, ctx),
                           batch.num_rows)
            vals = [None if v is None or p is None else
                    (v.startswith(p) if self._pc == "starts_with" else
                     v.endswith(p) if self._pc == "ends_with" else p in v)
                    for v, p in zip(c.to_pylist(), pats)]
            import pyarrow as pa
            return column_from_arrow(pa.array(vals, pa.bool_()), BooleanT,
                                     batch)
        if pat is None:
            return TorchColumnVector.from_scalar(None, BooleanT,
                                                 batch.num_rows, batch.capacity,
                                                 batch.device)
        pb = _pat_bytes(pat)
        if len(pb) == 0:
            data = torch.ones(batch.capacity, dtype=torch.bool,
                              device=batch.device)
        else:
            data = self._device(c, pb)
        return make_column(BooleanT, data, valid, batch.num_rows)

    def pretty(self) -> str:
        return f"{self._pc.replace('_', '')}({self.children[0].pretty()}, " \
            f"{self.children[1].pretty()})"

    def _row(self, v, p):
        if v is None or p is None:
            return None
        return v.startswith(p) if self._pc == "starts_with" else \
            v.endswith(p) if self._pc == "ends_with" else p in v

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        import pyarrow.compute as pc
        pat = _literal_value(self.children[1])
        if pat is _NOT_LITERAL:
            return _cpu_row_map(self, table, ctx, self._row)
        if pat is None:  # null in, null out (Spark; ROADMAP C-ref-18)
            v = self.children[0].eval_cpu(table, ctx)
            return arrow_column(None, table.num_rows, BooleanT) \
                if is_arrow(v) else None
        fn = "match_substring" if self._pc == "contains" else self._pc
        return _cpu_unary(self, table, ctx,
                          lambda a: getattr(pc, fn)(a, pattern=pat))


def _window_at(c: TorchColumnVector, at: torch.Tensor, pb: np.ndarray):
    """Whether each row's bytes at [at, at + len(pb)) equal ``pb``."""
    hit = torch.ones_like(at, dtype=torch.bool)
    last = c.data.numel() - 1
    for k, b in enumerate(pb.tolist()):  # a numpy pattern: no sync
        hit &= c.data[(at + k).clamp(0, max(last, 0))] == b
    return hit


class StartsWith(_PatternPredicate):
    _pc = "starts_with"

    def _device(self, c, pb):
        starts, lens = SK.starts_lengths(c.offsets)
        return (lens >= len(pb)) & _window_at(c, starts, pb)


class EndsWith(_PatternPredicate):
    _pc = "ends_with"

    def _device(self, c, pb):
        starts, lens = SK.starts_lengths(c.offsets)
        return (lens >= len(pb)) & _window_at(c, starts + lens - len(pb), pb)


class Contains(_PatternPredicate):
    _pc = "contains"

    def _device(self, c, pb):
        return SK.first_match(c.data, c.offsets, pb) >= 0


class _TrimBase(_StringUnary):
    """trim / ltrim / rtrim of ASCII whitespace: each row's first and last
    non-whitespace byte by a segment min/max, then one ragged gather;
    non-ASCII input (Unicode whitespace) through the host."""

    trim_left = trim_right = True
    _pc = ""
    _WS = (9, 10, 11, 12, 13, 32)

    @property
    def dtype(self) -> DataType:
        return StringT

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        c = self._input(batch, ctx)
        if not _ascii(c):
            import pyarrow.compute as pc
            host_path(ctx, self, "non-ASCII")
            return column_from_arrow(getattr(pc, self._pc)(
                column_to_arrow(c)), StringT, batch)
        nbytes = c.data.numel()
        if nbytes == 0:
            return c
        starts, lens = SK.starts_lengths(c.offsets)
        ws = torch.zeros(nbytes, dtype=torch.bool, device=c.device)
        for b in self._WS:
            ws |= c.data == b
        # each row's first and last non-whitespace byte, by a prefix count
        # (no atomics: a scatter-min over every byte contends on its row)
        ends = starts + lens
        kept = ~ws
        first = SK.nth_true(kept, starts, ends, torch.ones_like(starts))
        cs = SK._prefix(kept)
        count = cs[ends] - cs[starts]
        last = SK.nth_true(kept, starts, ends, count)
        has = count > 0
        lead = torch.where(has, first - starts, lens) if self.trim_left \
            else torch.zeros_like(lens)
        end = torch.where(has, last - starts + 1, lead) if self.trim_right \
            else lens
        out, offs = SK.build_ranges(c.data, starts + lead, end - lead, nbytes)
        return _str_col(batch, out, offs, c.validity)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        import pyarrow.compute as pc
        return _cpu_unary(self, table, ctx, getattr(pc, self._pc))


class Trim(_TrimBase):
    _pc = "utf8_trim_whitespace"


class LTrim(_TrimBase):
    trim_right = False
    _pc = "utf8_ltrim_whitespace"


class RTrim(_TrimBase):
    trim_left = False
    _pc = "utf8_rtrim_whitespace"


class Reverse(_StringUnary):
    """reverse: ASCII by a stride -1 ragged gather; non-ASCII (character
    reversal) through the host."""

    _name = "reverse"

    @property
    def dtype(self) -> DataType:
        return StringT

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        c = self._input(batch, ctx)
        if not _ascii(c):
            import pyarrow.compute as pc
            host_path(ctx, self, "non-ASCII")
            return column_from_arrow(pc.utf8_reverse(column_to_arrow(c)),
                                     StringT, batch)
        starts, lens = SK.starts_lengths(c.offsets)
        out, offs = SK.build_ranges(c.data, starts + lens - 1, lens,
                                    c.data.numel(),
                                    stride=torch.full_like(starts, -1))
        return _str_col(batch, out, offs, c.validity)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        import pyarrow.compute as pc
        return _cpu_unary(self, table, ctx, pc.utf8_reverse)


class InitCap(_StringUnary):
    """initcap: the first letter of each space-separated word upper case,
    the rest lower (Spark's). ASCII: a word-start mask and a case map in
    place; non-ASCII through the host."""

    _name = "initcap"

    @property
    def dtype(self) -> DataType:
        return StringT

    @staticmethod
    def _initcap_list(vals):
        return [None if v is None else
                " ".join(w[:1].upper() + w[1:].lower() if w else w
                         for w in v.split(" ")) for v in vals]

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        c = self._input(batch, ctx)
        if not _ascii(c):
            import pyarrow as pa
            host_path(ctx, self, "non-ASCII")
            return column_from_arrow(pa.array(self._initcap_list(
                c.to_pylist()), pa.string()), StringT, batch)
        nbytes = c.data.numel()
        if nbytes == 0:
            return c
        row_start = torch.zeros(nbytes + 1, dtype=torch.bool, device=c.device)
        row_start[c.offsets[:-1].to(torch.int64).clamp(max=nbytes)] = True
        prev = torch.zeros_like(c.data)
        prev[1:] = c.data[:-1]
        word = row_start[:nbytes] | (prev == 32)
        b = c.data
        lower = (b >= ord("a")) & (b <= ord("z"))
        upper = (b >= ord("A")) & (b <= ord("Z"))
        out = torch.where(word & lower, b - 32,
                          torch.where(~word & upper, b + 32, b))
        return _str_col(batch, out.to(torch.uint8), c.offsets, c.validity)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        import pyarrow as pa
        return _cpu_unary(self, table, ctx, lambda a: pa.array(
            self._initcap_list(a.to_pylist()), pa.string()))


class StringRepeat(Expression):
    """repeat(str, n): byte tiling on the device (UTF-8 safe); a
    non-literal count through the host."""

    def __init__(self, child: Expression, times: Expression):
        self.children = (child, times)

    @property
    def dtype(self) -> DataType:
        return StringT

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        c = _string_input(self.children[0], batch, ctx)
        n = _literal_value(self.children[1])
        if n is _NOT_LITERAL or n is None:
            import pyarrow as pa
            host_path(ctx, self, "non-literal argument")
            n = 1 if n is _NOT_LITERAL else n
            return column_from_arrow(pa.array(
                [None if v is None or n is None else v * max(int(n), 0)
                 for v in c.to_pylist()], pa.string()), StringT, batch)
        n = max(int(n), 0)
        starts, lens = SK.starts_lengths(c.offsets)
        out, offs = SK.build_repeat(c.data, starts, lens, n,
                                    bucket_capacity(c.data.numel()
                                                    * max(n, 1)))
        return _str_col(batch, out, offs, c.validity)

    def pretty(self) -> str:
        return f"repeat({self.children[0].pretty()}, " \
            f"{self.children[1].pretty()})"

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return _cpu_row_map(self, table, ctx, lambda v, k: None
                            if v is None or k is None else v * max(int(k), 0))


def _covered(taken: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """bool [nbytes]: bytes inside a taken match [j, ends[j]): +1 at each
    taken start, -1 at its end, a prefix sum (the taken starts gathered
    first, so no update lands on a shared slot)."""
    nbytes = taken.shape[0]
    at = torch.nonzero(taken).flatten()
    delta = torch.zeros(nbytes + 1, dtype=torch.int64, device=taken.device)
    delta.index_add_(0, at, torch.ones_like(at))
    delta.index_add_(0, ends[at].clamp(max=nbytes), torch.full_like(at, -1))
    return torch.cumsum(delta[:-1], 0) > 0


class StringReplace(Expression):
    """replace(str, search, replace), literal: left-to-right
    non-overlapping window matches, then the contribution rebuild (UTF-8
    safe). A non-literal search goes through the host."""

    def __init__(self, child: Expression, search: Expression,
                 replace: Expression):
        self.children = (child, search, replace)

    @property
    def dtype(self) -> DataType:
        return StringT

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        c = _string_input(self.children[0], batch, ctx)
        s = _literal_value(self.children[1])
        r = _literal_value(self.children[2])
        if s is _NOT_LITERAL or r is _NOT_LITERAL:
            import pyarrow.compute as pc
            host_path(ctx, self, "non-literal argument")
            r = "" if r is _NOT_LITERAL else r
            return column_from_arrow(pc.replace_substring(
                column_to_arrow(c), pattern=s, replacement=r), StringT, batch)
        if s is None or s == "":
            return c  # Spark: an empty search leaves the string as it is
        r = r or ""
        sb, rb = _pat_bytes(s), _pat_bytes(r)
        nbytes = c.data.numel()
        if nbytes == 0:
            return c
        taken = SK.greedy_matches(c.data, c.offsets, sb)
        pos = torch.arange(nbytes, dtype=torch.int64, device=c.device)
        covered = _covered(taken, pos + len(sb))
        out_cap = nbytes if len(rb) <= len(sb) else bucket_capacity(
            (nbytes // len(sb)) * len(rb) + nbytes)
        out, offs = SK.build_from_contributions(
            c.data, ~covered, c.offsets, out_cap, replace_at=taken,
            replacement=rb)
        return _str_col(batch, out, offs, c.validity)

    def pretty(self) -> str:
        c = self.children
        return f"replace({c[0].pretty()}, {c[1].pretty()}, {c[2].pretty()})"

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        import pyarrow.compute as pc
        s = _literal_value(self.children[1])
        r = _literal_value(self.children[2])
        if s is _NOT_LITERAL or r is _NOT_LITERAL:
            return _cpu_row_map(self, table, ctx, lambda v, a, b: None
                                if v is None else v if not a
                                else v.replace(a, b or ""))
        if s is None or s == "":
            return self.children[0].eval_cpu(table, ctx)
        return _cpu_unary(self, table, ctx, lambda a: pc.replace_substring(
            a, pattern=s, replacement=r or ""))


class StringLocate(Expression):
    """locate(substr, str[, pos]): the 1-based position of the first
    occurrence at or after ``pos``, 0 when absent (instr: pos 1). ASCII by
    a first match on the device; non-ASCII (character positions) or a
    non-literal argument through the host."""

    def __init__(self, substr: Expression, child: Expression,
                 pos: Optional[Expression] = None):
        from .base import Literal
        self.children = (substr, child,
                         pos if pos is not None else Literal(1))

    @property
    def dtype(self) -> DataType:
        return IntegerT

    @staticmethod
    def _compute_list(subs, vals, start):
        return [None if v is None or subs is None else
                (0 if start < 1 else v.find(subs, start - 1) + 1)
                for v in vals]

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        subs = _literal_value(self.children[0])
        start = _literal_value(self.children[2])
        c = _string_input(self.children[1], batch, ctx)
        literal = subs is not _NOT_LITERAL and start is not _NOT_LITERAL
        if not literal or subs is None or not _ascii(c) \
                or not subs.isascii():
            import pyarrow as pa
            host_path(ctx, self, "non-literal argument" if not literal
                      else "non-ASCII")
            subs = None if subs is _NOT_LITERAL else subs
            start = 1 if start is _NOT_LITERAL else start
            return column_from_arrow(pa.array(self._compute_list(
                subs, c.to_pylist(), start), pa.int32()), IntegerT, batch)
        valid = _valid(c, batch)
        cap = batch.capacity
        if start < 1:
            data = torch.zeros(cap, dtype=torch.int32, device=batch.device)
        elif subs == "":
            # Python's find("", k): k when k <= len, else -1
            _, lens = SK.starts_lengths(c.offsets)
            data = torch.where(start - 1 <= lens, start, 0).to(torch.int32)
        else:
            first = SK.first_match(
                c.data, c.offsets, _pat_bytes(subs),
                from_pos=torch.full((cap,), start - 1, dtype=torch.int64,
                                    device=batch.device))
            data = (first + 1).to(torch.int32)
        return make_column(IntegerT, data, valid, batch.num_rows)

    def pretty(self) -> str:
        return f"locate({self.children[0].pretty()}, " \
            f"{self.children[1].pretty()})"

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        def row(subs, v, start):
            if v is None or subs is None or start is None:
                return None
            return 0 if start < 1 else v.find(subs, start - 1) + 1
        return _cpu_row_map(self, table, ctx, row)


class StringInstr(StringLocate):
    """instr(str, substr) = locate(substr, str, 1)."""

    def __init__(self, child: Expression, substr: Expression):
        super().__init__(substr, child)

    def pretty(self) -> str:
        return f"instr({self.children[1].pretty()}, " \
            f"{self.children[0].pretty()})"


class _PadBase(Expression):
    """lpad / rpad to ``len`` characters with a literal pad (Spark: longer
    strings cut to ``len``, an empty pad leaves shorter ones). ASCII on
    the device; non-ASCII or a non-literal argument through the host."""

    left_side = True

    def __init__(self, child: Expression, length: Expression,
                 pad: Expression):
        self.children = (child, length, pad)

    @property
    def dtype(self) -> DataType:
        return StringT

    def _compute_list(self, vals, n, pad):
        out = []
        for v in vals:
            if v is None:
                out.append(None)
            elif len(v) >= n:
                out.append(v[:n])
            elif not pad:
                out.append(v)
            else:
                fill = (pad * n)[: n - len(v)]
                out.append(fill + v if self.left_side else v + fill)
        return out

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        c = _string_input(self.children[0], batch, ctx)
        n = _literal_value(self.children[1])
        pad = _literal_value(self.children[2])
        literal = n is not _NOT_LITERAL and pad is not _NOT_LITERAL \
            and n is not None and pad is not None
        if not literal or not pad.isascii() or not _ascii(c):
            import pyarrow as pa
            host_path(ctx, self, "non-literal argument" if not literal
                      else "non-ASCII")
            n = 0 if n in (None, _NOT_LITERAL) else int(n)
            pad = " " if pad in (None, _NOT_LITERAL) else pad
            return column_from_arrow(pa.array(self._compute_list(
                c.to_pylist(), n, pad), pa.string()), StringT, batch)
        n = max(int(n), 0)
        starts, lens = SK.starts_lengths(c.offsets)
        out_cap = bucket_capacity(max(c.data.numel(), c.capacity * n))
        out, offs = SK.build_pad(c.data, starts, lens, n, _pat_bytes(pad),
                                 self.left_side, out_cap,
                                 active=row_mask(batch.num_rows, c.capacity,
                                                 batch.device))
        return _str_col(batch, out, offs, c.validity)

    def pretty(self) -> str:
        c = self.children
        name = "lpad" if self.left_side else "rpad"
        return f"{name}({c[0].pretty()}, {c[1].pretty()}, {c[2].pretty()})"

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        def row(v, n, pad):
            if v is None or n is None or pad is None:
                return None
            return self._compute_list([v], int(n), pad)[0]
        return _cpu_row_map(self, table, ctx, row)


class LPad(_PadBase):
    left_side = True


class RPad(_PadBase):
    left_side = False


class StringTranslate(Expression):
    """translate(str, from, to): a character map (a from character past the
    end of ``to`` is deleted). ASCII: a 256-entry table and the
    contribution rebuild; non-ASCII through the host."""

    def __init__(self, child: Expression, from_str: Expression,
                 to_str: Expression):
        self.children = (child, from_str, to_str)

    @property
    def dtype(self) -> DataType:
        return StringT

    def _table(self):
        f = _literal_value(self.children[1])
        t = _literal_value(self.children[2])
        f = "" if f in (None, _NOT_LITERAL) else f
        t = "" if t in (None, _NOT_LITERAL) else t
        m = {}
        for i, ch in enumerate(f):
            if ch not in m:
                m[ch] = t[i] if i < len(t) else None  # None: delete
        return m

    def _compute_list(self, vals):
        m = self._table()
        return [None if v is None else
                "".join(m.get(ch, ch) for ch in v
                        if m.get(ch, ch) is not None) for v in vals]

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        c = _string_input(self.children[0], batch, ctx)
        m = self._table()
        table_ascii = all(ord(k) < 128 and (v is None or ord(v) < 128)
                          for k, v in m.items())
        literal = all(_literal_value(e) is not _NOT_LITERAL
                      for e in self.children[1:])
        if not literal or not table_ascii or not _ascii(c):
            import pyarrow as pa
            host_path(ctx, self, "non-literal argument" if not literal
                      else "non-ASCII")
            return column_from_arrow(pa.array(self._compute_list(
                c.to_pylist()), pa.string()), StringT, batch)
        nbytes = c.data.numel()
        if nbytes == 0:
            return c
        lut = np.arange(256, dtype=np.uint8)
        drop = np.zeros(256, dtype=bool)
        for k, v in m.items():
            if v is None:
                drop[ord(k)] = True
            else:
                lut[ord(k)] = ord(v)
        idx = c.data.to(torch.int64)
        mapped = torch.as_tensor(lut, device=c.device)[idx]
        keep = ~torch.as_tensor(drop, device=c.device)[idx]
        out, offs = SK.build_from_contributions(c.data, keep, c.offsets,
                                                nbytes, mapped=mapped)
        return _str_col(batch, out, offs, c.validity)

    def pretty(self) -> str:
        c = self.children
        return f"translate({c[0].pretty()}, {c[1].pretty()}, " \
            f"{c[2].pretty()})"

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        import pyarrow as pa
        if not all(_literal_value(e) is not _NOT_LITERAL
                   for e in self.children[1:]):
            raise NotImplementedError(
                "translate with a non-literal argument not yet ported")
        return _cpu_unary(self, table, ctx, lambda a: pa.array(
            self._compute_list(a.to_pylist()), pa.string()))


class _HostRowOp(Expression):
    """An op computed a row at a time over Python values on the host (the
    reference's ``_HostRowOp``: ``format_number``, ``conv``). Every batch
    is a counted host hop."""

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        import pyarrow as pa
        from ..types import to_arrow
        host_path(ctx, self, "host row op")
        n = batch.num_rows
        ins = [rows_of(c.eval_device(batch, ctx), n) for c in self.children]
        out = pa.array([self._row(*vals, ctx=ctx) for vals in zip(*ins)],
                       type=to_arrow(self.dtype))
        return column_from_arrow(out, self.dtype, batch)

    def _row(self, *vals, ctx):
        raise NotImplementedError

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return _cpu_row_map(self, table, ctx,
                            lambda *vals: self._row(*vals, ctx=ctx))


class ConcatWs(Expression):
    """concat_ws(sep, cols...): the non-null inputs joined by ``sep``, null
    only when ``sep`` is. A literal separator and string columns on the
    device (one multi-source gather with separators); anything else
    through the host."""

    def __init__(self, sep: Expression, *cols: Expression):
        self.children = (sep,) + tuple(cols)

    @property
    def dtype(self) -> DataType:
        return StringT

    @property
    def nullable(self) -> bool:
        return self.children[0].nullable

    @staticmethod
    def _join(sep, parts):
        if sep is None:
            return None
        return sep.join(p for p in parts if p is not None)

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        from ..types import StringType
        sep = _literal_value(self.children[0])
        args = self.children[1:]
        if sep is _NOT_LITERAL or sep is None or not args or not all(
                isinstance(a.dtype, StringType) for a in args):
            import pyarrow as pa
            host_path(ctx, self, "non-literal argument")
            n = batch.num_rows
            ins = [rows_of(c.eval_device(batch, ctx), n)
                   for c in self.children]
            return column_from_arrow(pa.array(
                [self._join(r[0], r[1:]) for r in zip(*ins)], pa.string()),
                StringT, batch)
        cap, dev = batch.capacity, batch.device
        logical = row_mask(batch.num_rows, cap, dev)
        sep_b = sep.encode()
        parts, emits, seps = [], [], []
        any_before = torch.zeros(cap, dtype=torch.bool, device=dev)
        out_cap = 0
        for i, a in enumerate(args):
            c = _string_input(a, batch, ctx)
            starts, lens = SK.starts_lengths(c.offsets)
            parts.append((c.data, starts, lens))
            nonnull = logical if c.validity is None else c.validity & logical
            emits.append(nonnull)
            seps.append(None if i == 0 else (sep_b, nonnull & any_before))
            any_before = any_before | nonnull
            out_cap += c.data.numel() + len(sep_b) * cap
        out, offs = SK.concat_columns(parts, bucket_capacity(out_cap),
                                      part_emit=emits, seps=seps)
        return _str_col(batch, out, offs, None)

    def pretty(self) -> str:
        return f"concat_ws({', '.join(c.pretty() for c in self.children)})"

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return _cpu_row_map(self, table, ctx,
                            lambda sep, *parts: self._join(sep, parts))


class SubstringIndex(Expression):
    """substring_index(str, delim, count): before the count-th delimiter
    (after the count-th from the end when negative); on the device by the
    nth non-overlapping match (UTF-8 safe)."""

    def __init__(self, child: Expression, delim: Expression,
                 count: Expression):
        self.children = (child, delim, count)

    @property
    def dtype(self) -> DataType:
        return StringT

    @staticmethod
    def _row(s, delim, count):
        if s is None or delim is None or count is None:
            return None
        if delim == "" or count == 0:
            return ""
        parts = s.split(delim)
        if count > 0:
            return delim.join(parts[:count])
        return delim.join(parts[count:])

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        c = _string_input(self.children[0], batch, ctx)
        d = _literal_value(self.children[1])
        cnt = _literal_value(self.children[2])
        if d in (None, _NOT_LITERAL) or cnt in (None, _NOT_LITERAL):
            import pyarrow as pa
            host_path(ctx, self, "non-literal argument")
            d = None if d is _NOT_LITERAL else d
            cnt = None if cnt is _NOT_LITERAL else cnt
            return column_from_arrow(pa.array(
                [self._row(v, d, cnt) for v in c.to_pylist()], pa.string()),
                StringT, batch)
        starts, lens = SK.starts_lengths(c.offsets)
        nbytes = max(c.data.numel(), 1)
        if d == "" or cnt == 0:
            out, offs = SK.build_ranges(c.data, starts,
                                        torch.zeros_like(lens), nbytes)
            return _str_col(batch, out, offs, c.validity)
        db = _pat_bytes(d)
        cnt = int(cnt)
        pos = SK.nth_match(c.data, c.offsets, db, cnt)
        if cnt > 0:
            new_start, new_len = starts, torch.where(pos >= 0, pos, lens)
        else:
            s0 = torch.where(pos >= 0, pos + len(db), 0)
            new_start, new_len = starts + s0, lens - s0
        out, offs = SK.build_ranges(c.data, new_start, new_len, nbytes)
        return _str_col(batch, out, offs, c.validity)

    def pretty(self) -> str:
        c = self.children
        return f"substring_index({c[0].pretty()}, {c[1].pretty()}, " \
            f"{c[2].pretty()})"

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return _cpu_row_map(self, table, ctx, self._row)


class OctetLength(_StringUnary):
    """octet_length: UTF-8 bytes, from the offsets."""

    _name = "octet_length"
    _scale = 1

    @property
    def dtype(self) -> DataType:
        return IntegerT

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        c = self._input(batch, ctx)
        _, lens = SK.starts_lengths(c.offsets)
        return make_column(IntegerT, (lens * self._scale).to(torch.int32),
                           _valid(c, batch), batch.num_rows)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        import pyarrow.compute as pc
        return _cpu_unary(self, table, ctx, lambda a: pc.multiply(
            pc.binary_length(a), self._scale).cast("int32"))


class BitLength(OctetLength):
    """bit_length = octet_length * 8."""

    _name = "bit_length"
    _scale = 8


class FormatNumber(_HostRowOp):
    """format_number(x, d): thousands separators and ``d`` decimals,
    HALF_EVEN as Java's DecimalFormat (reference ``FormatNumber``)."""

    def __init__(self, child: Expression, d: Expression):
        self.children = (child, d)

    @property
    def dtype(self) -> DataType:
        return StringT

    def _row(self, x, d, ctx):
        if x is None or d is None or d < 0:
            return None
        import decimal as _dec
        if isinstance(x, float):
            if x != x or x in (float("inf"), float("-inf")):
                return None
            q = _dec.Decimal(repr(x)).quantize(
                _dec.Decimal(1).scaleb(-d), rounding=_dec.ROUND_HALF_EVEN)
        else:
            q = _dec.Decimal(x).quantize(
                _dec.Decimal(1).scaleb(-d), rounding=_dec.ROUND_HALF_EVEN)
        return f"{q:,.{d}f}"

    def pretty(self) -> str:
        return f"format_number({self.children[0].pretty()}, " \
            f"{self.children[1].pretty()})"


class Conv(_HostRowOp):
    """conv(numStr, fromBase, toBase): Java's NumberConverter — unsigned
    64-bit wraparound, a negative toBase gives signed output, digits read
    up to the first invalid character (reference ``Conv``)."""

    def __init__(self, child: Expression, from_base: Expression,
                 to_base: Expression):
        self.children = (child, from_base, to_base)

    @property
    def dtype(self) -> DataType:
        return StringT

    _DIGITS = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"

    def _row(self, s, fb, tb, ctx):
        if s is None or fb is None or tb is None:
            return None
        if not (2 <= abs(fb) <= 36 and 2 <= abs(tb) <= 36):
            return None
        s = s.strip()
        if not s:
            return None
        neg = s.startswith("-")
        if neg:
            s = s[1:]
        val, seen = 0, False
        for ch in s.upper():
            d = self._DIGITS.find(ch)
            if d < 0 or d >= abs(fb):
                break
            val = (val * abs(fb) + d) & 0xFFFFFFFFFFFFFFFF
            seen = True
        if not seen:
            return "0"
        if neg:
            val = (-val) & 0xFFFFFFFFFFFFFFFF
        if tb < 0:  # signed output
            sval = val - (1 << 64) if val >= (1 << 63) else val
            sign = "-" if sval < 0 else ""
            sval, base = abs(sval), abs(tb)
        else:
            sign, sval, base = "", val, tb
        if sval == 0:
            return "0"
        out = []
        while sval:
            out.append(self._DIGITS[sval % base])
            sval //= base
        return sign + "".join(reversed(out))

    def pretty(self) -> str:
        c = self.children
        return f"conv({c[0].pretty()}, {c[1].pretty()}, {c[2].pretty()})"


class Ascii(_StringUnary):
    """ascii(str): the code point of the first character, 0 for the empty
    string. ASCII: the first byte of each row; non-ASCII through the
    host (the whole code point)."""

    _name = "ascii"

    @property
    def dtype(self) -> DataType:
        return IntegerT

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        c = self._input(batch, ctx)
        if not _ascii(c):
            import pyarrow as pa
            host_path(ctx, self, "non-ASCII")
            return column_from_arrow(pa.array(
                [None if v is None else (ord(v[0]) if v else 0)
                 for v in c.to_pylist()], pa.int32()), IntegerT, batch)
        starts, lens = SK.starts_lengths(c.offsets)
        nbytes = c.data.numel()
        if nbytes == 0:
            data = torch.zeros(c.capacity, dtype=torch.int32,
                               device=c.device)
        else:
            first = c.data[starts.clamp(0, nbytes - 1)].to(torch.int32)
            data = torch.where(lens > 0, first, 0)
        return make_column(IntegerT, data, _valid(c, batch), batch.num_rows)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        import pyarrow as pa
        return _cpu_unary(self, table, ctx, lambda a: pa.array(
            [None if v is None else (ord(v[0]) if v else 0)
             for v in a.to_pylist()], pa.int32()))
