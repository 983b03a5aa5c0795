"""Regular expressions (port of ``spark_rapids_tpu/expressions/regex.py``):
``rlike``, ``regexp_replace`` and ``regexp_extract``, with the reference's
validate / rewrite / reject design.

1. Trivially rewritable patterns become string predicates on the device
   (``^lit`` → startswith, ``lit$`` → endswith, a bare literal →
   contains, ``^lit$`` → equality), as the reference's rewrites.
2. A pattern inside the DFA subset runs on the device as a byte-DFA walk
   (``kernels/regex_dfa.py``): ``rlike`` over whole rows, ``regexp_replace``
   and ``regexp_extract``'s group 0 by span matching.
3. Everything else that parses takes the host hop, counted in
   ``strings.hostPath``: ``rlike`` through pyarrow's RE2
   (``match_substring_regex``), as the reference; ``regexp_replace``
   through RE2 or Python's ``re`` by the reference's rule; capture groups
   through Python's ``re``. A pattern RE2 cannot compile (a
   backreference) is matched by Python's ``re``, Java's semantics there,
   where the reference's host hop raises.
4. A pattern Java reads differently from Python (possessive quantifiers,
   ``\\p{...}``, lookbehind, ``\\G``/``\\Z``) is rejected: the expression is
   tagged off the card (``tpu_supported``).

Java's readings that neither RE2 nor Python's ``re`` share are rewritten
first (``java_pattern``): a ``[`` inside a character class opens a nested
set, unioned into the outer one (``[[:digit:]]`` is one of ``:digit``;
RE2 reads a POSIX class there), so nested sets are flattened. The
replacement of ``regexp_replace`` follows ``Matcher.appendReplacement``
(``java_replacement``): ``\\x`` is a literal ``x``, ``$n`` a group with
Java's greedy group number.

Host evaluation (``eval_cpu``, the host engine) runs the host hop's code
over the Arrow rows, so both sides read a pattern the same way.

``LIKE`` is ``expressions/strings.Like`` in the port.
"""

from __future__ import annotations

import re as _re
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..columnar.vector import bucket_capacity
from ..kernels import regex_dfa as RD
from ..kernels import strings as SK
from ..types import BooleanT, DataType, StringT
from .base import _DEFAULT_CTX, Expression, is_arrow, make_column
from .strings import (Contains, EndsWith, StartsWith, _str_col,
                      _string_input, _valid, column_from_arrow,
                      column_to_arrow, host_path)

_META = set(".^$*+?()[]{}|\\")

# constructs Java supports but Python's re does not (or reads otherwise)
_REJECT_PATTERNS = [
    _re.compile(r"\*\+|\+\+|\?\+"),           # possessive quantifiers
    _re.compile(r"\\[pP]\{"),                  # unicode property classes
    _re.compile(r"\(\?<[=!]"),                 # lookbehind
    _re.compile(r"\\[GZ]"),                    # Java-only anchors
]


def java_pattern(pattern: str) -> Optional[str]:
    """The pattern with Java's nested character classes flattened into
    their enclosing class (a union in Java), or None where Java reads a
    class in a way this cannot express (a negated nested set, ``&&``)."""
    out, depth, i = [], 0, 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\" and i + 1 < len(pattern):
            out.append(pattern[i:i + 2])
            i += 2
            continue
        if ch == "[":
            if depth and pattern.startswith("[^", i):
                return None
            if not depth:
                out.append(ch)
                if pattern.startswith("[^", i):
                    out.append("^")
                    i += 1
            depth += 1
        elif ch == "]" and depth:
            depth -= 1
            if not depth:
                out.append(ch)
        elif depth and pattern.startswith("&&", i):
            return None
        else:
            out.append(ch)
        i += 1
    return "".join(out)


def transpile(pattern: str) -> Optional[str]:
    """Java regex → Python ``re`` pattern (``java_pattern``'s rewrite), or
    None when rejected (reference ``transpile``)."""
    for rej in _REJECT_PATTERNS:
        if rej.search(pattern):
            return None
    flat = java_pattern(pattern)
    if flat is None:
        return None
    try:
        _re.compile(flat)
    except _re.error:
        return None
    return flat


def java_replacement(replacement: str, groups: int) -> List[Union[str, int]]:
    """``Matcher.appendReplacement``'s reading of a replacement: literal
    text and group numbers. ``\\x`` is a literal ``x``; ``$`` takes one
    digit, then more while the number stays a group of the pattern
    (``groups`` of them); Java's errors raise ``ValueError``."""
    parts: List[Union[str, int]] = []
    text, i = [], 0
    while i < len(replacement):
        ch = replacement[i]
        if ch == "\\":
            if i + 1 == len(replacement):
                raise ValueError("character to be escaped is missing")
            text.append(replacement[i + 1])
            i += 2
            continue
        if ch == "$":
            if i + 1 == len(replacement) or \
                    not replacement[i + 1].isdigit():
                raise ValueError("Illegal group reference")
            g = int(replacement[i + 1])
            i += 2
            while i < len(replacement) and replacement[i].isdigit() \
                    and g * 10 + int(replacement[i]) <= groups:
                g = g * 10 + int(replacement[i])
                i += 1
            if g > groups:
                raise ValueError(f"No group {g}")
            if text:
                parts.append("".join(text))
                text = []
            parts.append(g)
            continue
        text.append(ch)
        i += 1
    if text:
        parts.append("".join(text))
    return parts


def literal_prefix_rewrite(pattern: str) -> Optional[Tuple[str, str]]:
    """(kind, literal) for a trivially rewritable pattern, kind one of
    startswith / endswith / contains / equals (reference
    ``literal_prefix_rewrite``)."""

    def is_literal(s: str) -> bool:
        i = 0
        while i < len(s):
            if s[i] == "\\" and i + 1 < len(s) and s[i + 1] in _META:
                i += 2
                continue
            if s[i] in _META:
                return False
            i += 1
        return True

    def unescape(s: str) -> str:
        out, i = [], 0
        while i < len(s):
            if s[i] == "\\" and i + 1 < len(s):
                out.append(s[i + 1])
                i += 2
            else:
                out.append(s[i])
                i += 1
        return "".join(out)

    anchored_start = pattern.startswith("^")
    anchored_end = pattern.endswith("$") and not pattern.endswith("\\$")
    core = pattern[1 if anchored_start else 0:
                   len(pattern) - 1 if anchored_end else len(pattern)]
    if not is_literal(core):
        return None
    lit = unescape(core)
    if anchored_start and anchored_end:
        return ("equals", lit)
    if anchored_start:
        return ("startswith", lit)
    if anchored_end:
        return ("endswith", lit)
    return ("contains", lit)


def _dfa_cap(ctx) -> Optional[int]:
    """The session's DFA state cap (``spark.rapids.tpu.regex.maxDfaStates``)."""
    from ..config import REGEX_MAX_DFA_STATES
    return ctx.conf.get(REGEX_MAX_DFA_STATES)


def _row_cap(ctx, span: bool) -> int:
    from ..config import REGEX_MAX_DEVICE_ROW_BYTES, REGEX_MAX_SPAN_ROW_BYTES
    return ctx.conf.get(REGEX_MAX_SPAN_ROW_BYTES if span
                        else REGEX_MAX_DEVICE_ROW_BYTES)


def _device_gate(dfa, col, ctx, span: bool):
    """(walk length, None) when the DFA walk may run on this column, else
    (None, the host-path reason)."""
    if dfa is None:
        return None, "out-of-subset pattern"
    ascii_, longest = SK.string_stats(col)
    if not dfa.ascii_atoms and not ascii_:
        return None, "non-ASCII"
    if longest > _row_cap(ctx, span):
        return None, "row past the byte cap"
    return longest, None


def _re2_or_python(arr, pattern: str, re2_call, py_call):
    """RE2 (pyarrow) when it compiles the pattern, else Python's ``re``."""
    import pyarrow as pa
    try:
        return re2_call(arr)
    except pa.ArrowInvalid:
        return pa.array(py_call(arr.to_pylist()))


_JAVA_ONLY = _re.compile(r"\\[pP]\{|\\[GZ]")


def _host_pattern(expr) -> str:
    """The pattern the host engines run: Java's reading. A pattern kept off
    the card for its possessive quantifiers or lookbehind runs in Python's
    ``re``, which reads those as Java does; one whose reading neither
    engine shares (``\\p{...}``, ``\\G``, ``\\Z``, a negated nested set)
    raises."""
    if expr._transpiled is not None:
        return expr._transpiled
    flat = java_pattern(expr.pattern)
    if flat is not None and not _JAVA_ONLY.search(flat):
        try:
            _re.compile(flat)
            return flat
        except _re.error:
            pass
    raise NotImplementedError(
        f"pattern {expr.pattern!r}: Java's reading has no host equivalent "
        "(not yet ported)")


def _host_eval(expr, table, ctx):
    """``eval_cpu`` of a regex expression: its host hop over the child's
    Arrow rows (a constant child folds)."""
    import pyarrow as pa
    v = expr.children[0].eval_cpu(table, ctx)
    arr = v if is_arrow(v) else pa.array([v], pa.string())
    out = expr._host(arr)
    return out if is_arrow(v) else out[0].as_py()


class RLike(Expression):
    """rlike / regexp: Java ``find`` semantics (reference ``RLike``)."""

    def __init__(self, child: Expression, pattern: str):
        self.children = (child,)
        self.pattern = pattern
        self._transpiled = transpile(pattern)
        self._rewrite = (literal_prefix_rewrite(self._transpiled)
                         if self._transpiled is not None else None)

    tpu_supported = property(lambda self: self._transpiled is not None)

    @property
    def dtype(self) -> DataType:
        return BooleanT

    def pretty(self) -> str:
        return f"{self.children[0].pretty()} RLIKE {self.pattern!r}"

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        from .base import Literal
        c = self.children[0]
        if self._rewrite is not None:
            kind, lit = self._rewrite
            if kind == "equals":
                from .predicates import EqualTo
                return EqualTo(c, Literal(lit)).eval_device(batch, ctx)
            cls = {"startswith": StartsWith, "endswith": EndsWith,
                   "contains": Contains}[kind]
            return cls(c, Literal(lit)).eval_device(batch, ctx)
        col = _string_input(c, batch, ctx)
        dfa = RD.compile_dfa(self._transpiled, _dfa_cap(ctx))
        steps, reason = _device_gate(dfa, col, ctx, span=False)
        if reason is None:
            data = RD.rlike_device(col.data, col.offsets, dfa, steps)
            return make_column(BooleanT, data, _valid(col, batch),
                               batch.num_rows)
        host_path(ctx, self, reason)
        return column_from_arrow(self._host(column_to_arrow(col)), BooleanT,
                                 batch)

    def _host(self, arr):
        """The match over Arrow rows: RE2, or Python's ``re`` where RE2
        cannot compile the pattern."""
        import pyarrow.compute as pc
        pattern = _host_pattern(self)
        prog = _re.compile(pattern)
        return _re2_or_python(
            arr, pattern,
            lambda a: pc.match_substring_regex(a, pattern=pattern),
            lambda vals: [None if v is None else prog.search(v) is not None
                          for v in vals])

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return _host_eval(self, table, ctx)


class RegexpReplace(Expression):
    """regexp_replace(str, pattern, replacement) (reference
    ``RegexpReplace``): every left-to-right non-overlapping match
    replaced. On the device for a literal replacement and a pattern
    inside the span subset; a group reference or escape in the
    replacement, or anything else, through the host."""

    def __init__(self, child: Expression, pattern: str, replacement: str):
        self.children = (child,)
        self.pattern = pattern
        self.replacement = replacement
        self._transpiled = transpile(pattern)

    tpu_supported = property(lambda self: self._transpiled is not None)

    @property
    def dtype(self) -> DataType:
        return StringT

    def pretty(self) -> str:
        return (f"regexp_replace({self.children[0].pretty()}, "
                f"{self.pattern!r}, {self.replacement!r})")

    def _parts(self) -> List[Union[str, int]]:
        return java_replacement(self.replacement,
                                _re.compile(_host_pattern(self)).groups)

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        col = _string_input(self.children[0], batch, ctx)
        parts = self._parts()
        if any(isinstance(p, int) for p in parts):
            reason = "group reference in the replacement"
        else:
            dfa = RD.compile_exact_dfa(self._transpiled, _dfa_cap(ctx))
            steps, reason = _device_gate(dfa, col, ctx, span=True)
            if reason is None:
                return self._device_replace(col, dfa, steps, batch,
                                            "".join(parts))
        host_path(ctx, self, reason)
        return column_from_arrow(self._host(column_to_arrow(col)), StringT,
                                 batch)

    def _host(self, arr):
        """Every match replaced over Arrow rows. The replacement is
        Java's (``java_replacement``): RE2's rewrite (``\\\\`` a backslash,
        ``\\n`` a group) when its groups are single digits, else a
        function of the match."""
        import pyarrow as pa
        import pyarrow.compute as pc
        pattern = _host_pattern(self)
        prog = _re.compile(pattern)
        parts = self._parts()

        def repl(m):
            return "".join(p if isinstance(p, str) else (m.group(p) or "")
                           for p in parts)

        def python(vals):
            return [None if v is None else prog.sub(repl, v) for v in vals]

        if prog.match("") or any(isinstance(p, int) and p > 9
                                 for p in parts):
            # an empty-matchable pattern: RE2's global replace advances
            # otherwise than Java after a non-empty match; Python's re
            # agrees with Java (the reference's rule)
            return pa.array(python(arr.to_pylist()), pa.string())
        rewrite = "".join(p.replace("\\", "\\\\") if isinstance(p, str)
                          else f"\\{p}" for p in parts)
        return _re2_or_python(arr, pattern, lambda a:
                              pc.replace_substring_regex(
                                  a, pattern=pattern, replacement=rewrite),
                              python)

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return _host_eval(self, table, ctx)

    def _device_replace(self, col, dfa, steps: int, batch, literal: str):
        data, offsets = col.data, col.offsets
        nbytes = data.numel()
        if nbytes == 0:
            return col
        repl = np.frombuffer(literal.encode(), np.uint8)
        mlen = RD.match_lengths_device(data, offsets, dfa, steps)
        taken = RD.select_leftmost_nonoverlapping(mlen, offsets)
        from .strings import _covered
        pos = torch.arange(nbytes, dtype=torch.int64, device=data.device)
        covered = _covered(taken, pos + mlen)
        out_cap = max(nbytes, 1) if len(repl) <= dfa.min_len else \
            bucket_capacity((nbytes // dfa.min_len) * len(repl) + nbytes)
        out, offs = SK.build_from_contributions(
            data, ~covered, offsets, out_cap, replace_at=taken,
            replacement=repl)
        return _str_col(batch, out, offs, col.validity)


class RegexpExtract(Expression):
    """regexp_extract(str, pattern, idx) (reference ``RegexpExtract``): the
    group ``idx`` of the first match, "" when there is none. Group 0 by
    span matching on the device; a capture group through the host
    (Python's ``re``), as the reference."""

    def __init__(self, child: Expression, pattern: str, group: int = 1):
        self.children = (child,)
        self.pattern = pattern
        self.group = group
        self._transpiled = transpile(pattern)

    tpu_supported = property(lambda self: self._transpiled is not None)

    @property
    def dtype(self) -> DataType:
        return StringT

    def pretty(self) -> str:
        return (f"regexp_extract({self.children[0].pretty()}, "
                f"{self.pattern!r}, {self.group})")

    def _extract(self, vals):
        prog = _re.compile(_host_pattern(self))
        out = []
        for v in vals:
            if v is None:
                out.append(None)
                continue
            m = prog.search(v)
            g = None if m is None else m.group(self.group)
            out.append("" if g is None else g)
        return out

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        col = _string_input(self.children[0], batch, ctx)
        if self.group != 0:
            reason = "capture group"
        else:
            dfa = RD.compile_exact_dfa(self._transpiled, _dfa_cap(ctx))
            steps, reason = _device_gate(dfa, col, ctx, span=True)
            if reason is None:
                return self._device_extract(col, dfa, steps, batch)
        host_path(ctx, self, reason)
        return column_from_arrow(self._host(column_to_arrow(col)), StringT,
                                 batch)

    def _host(self, arr):
        import pyarrow as pa
        return pa.array(self._extract(arr.to_pylist()), pa.string())

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return _host_eval(self, table, ctx)

    def _device_extract(self, col, dfa, steps: int, batch):
        data, offsets = col.data, col.offsets
        nbytes = data.numel()
        n = offsets.shape[0] - 1
        if nbytes == 0 or n == 0:
            return col
        mlen = RD.match_lengths_device(data, offsets, dfa, steps)
        starts, lens = SK.starts_lengths(offsets)
        first = SK.nth_true(mlen > 0, starts, starts + lens,
                            torch.ones_like(starts))
        found = first >= 0
        start = torch.where(found, first, 0)
        length = torch.where(found, mlen[start.clamp(0, nbytes - 1)], 0)
        out, offs = SK.build_ranges(data, start, length,
                                    bucket_capacity(nbytes))
        return _str_col(batch, out, offs, col.validity)
