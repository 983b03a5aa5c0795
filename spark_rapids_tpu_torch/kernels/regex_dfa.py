"""The device regex engine (port of
``spark_rapids_tpu/kernels/regex_dfa.py``): a Java-regex subset compiled on
the host to a byte DFA, walked on the device over the offsets + bytes
string layout.

The host compiler (``_Parser``, ``_NFA``, ``DFA``, ``compile_dfa``,
``ExactDFA``, ``compile_exact_dfa``) is the reference's, copied: pure
Python and numpy, so the port needs nothing of the JAX package. Its
tables are held equal to the reference's in the tests.

The walks are torch. ``rlike_device`` advances every row's state one byte
a step, ``max_len`` steps (the longest row): a byte gather and one
``[S, C]`` table lookup a step, as the reference's ``fori_loop``.
``match_lengths_device`` walks from every byte position (a lane a
position), the lanes that reached the dead state dropped as the walk goes,
and ``select_leftmost_nonoverlapping`` takes Java's ``replaceAll`` matches
with ``kernels/strings.take_chains`` (one pointer-doubling pass where the
reference scans row positions). The longest row each walk takes (the
reference's ``MAX_DEVICE_ROW_BYTES``) is a conf key, read by
``expressions/regex._row_cap``: ``spark.rapids.sql.regexp.maxDeviceRowBytes``
and ``maxSpanRowBytes``.

Supported subset (the rest goes to the host engine, as in the
reference): literals, escaped metas, \\d \\D \\w \\W \\s \\S, character
classes with ranges and negation (ASCII), '.', alternation, groups,
greedy/lazy quantifiers * + ? {m} {m,} {m,n} (bounded expansion), a
leading ^ and a trailing $. Rejected: backreferences, lookaround, unicode
properties, possessive quantifiers, mid-pattern anchors, word boundaries,
non-ASCII pattern bytes, a DFA past the state cap.

Without ^ the start state loops on every byte and without $ the accepting
states absorb, so "some substring matches" is "the state after the last
byte accepts", one walk for the rlike, ^ and $ forms.
"""

from __future__ import annotations

import functools
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from .strings import byte_rows, starts_lengths, take_chains

MAX_DFA_STATES = 128
MAX_EXPANSION = 512  # AST atom budget after {m,n} duplication

_ALL = frozenset(range(256))
_LINE_TERMS = frozenset((0x0A, 0x0D))
_DOT = _ALL - _LINE_TERMS
_DIGIT = frozenset(range(0x30, 0x3A))
_WORD = frozenset(
    list(range(0x30, 0x3A)) + list(range(0x41, 0x5B))
    + list(range(0x61, 0x7B)) + [0x5F])
_SPACE = frozenset((0x20, 0x09, 0x0A, 0x0B, 0x0C, 0x0D))


class RegexReject(Exception):
    """Pattern is outside the device subset."""


# --- AST -------------------------------------------------------------------

class _Node:
    pass


class _Lit(_Node):
    def __init__(self, bytes_: FrozenSet[int]):
        self.bytes = bytes_

    def count(self):
        return 1


class _Concat(_Node):
    def __init__(self, parts: List[_Node]):
        self.parts = parts

    def count(self):
        return sum(p.count() for p in self.parts)


class _Alt(_Node):
    def __init__(self, parts: List[_Node]):
        self.parts = parts

    def count(self):
        return sum(p.count() for p in self.parts)


class _Star(_Node):
    def __init__(self, inner: _Node):
        self.inner = inner

    def count(self):
        return self.inner.count()


class _Empty(_Node):
    def count(self):
        return 0


# --- parser ----------------------------------------------------------------

class _Parser:
    def __init__(self, pattern: str):
        try:
            self.p = pattern.encode("ascii")
        except UnicodeEncodeError:
            raise RegexReject("non-ASCII pattern")
        self.i = 0
        self.anchored_start = False
        self.anchored_end = False
        self.top_level_alt = False
        self.has_alternation = False  # any '|' at any depth
        self.has_lazy = False         # any lazy quantifier marker

    def parse(self) -> _Node:
        if self.p.startswith(b"^"):
            self.anchored_start = True
            self.i = 1
        node = self._alt(top=True)
        if self.i != len(self.p):
            raise RegexReject(f"unparsed tail at {self.i}")
        if self.top_level_alt and (self.anchored_start or self.anchored_end):
            # Java scopes a leading ^ / trailing $ to only the first / last
            # alternative ('^a|b' is '(^a)|(b)'), while this parser would
            # anchor the whole alternation.  Per-branch anchor modeling is not
            # implemented, so such patterns must go to the host engine.
            # '^(a|b)$' is unaffected: its '|' is consumed inside a group.
            raise RegexReject("anchor over top-level alternation")
        return node

    def _peek(self) -> int:
        return self.p[self.i] if self.i < len(self.p) else -1

    def _alt(self, top: bool = False) -> _Node:
        parts = [self._concat(top)]
        while self._peek() == 0x7C:  # '|'
            self.i += 1
            self.has_alternation = True
            if top:
                self.top_level_alt = True
            parts.append(self._concat(top))
        return parts[0] if len(parts) == 1 else _Alt(parts)

    def _concat(self, top: bool) -> _Node:
        parts: List[_Node] = []
        while True:
            c = self._peek()
            if c in (-1, 0x7C) or c == 0x29:  # end, '|', ')'
                break
            if c == 0x24:  # '$'
                # only valid as the very last pattern byte at top level
                if top and self.i == len(self.p) - 1:
                    self.anchored_end = True
                    self.i += 1
                    break
                raise RegexReject("mid-pattern $")
            if c == 0x5E:  # '^'
                raise RegexReject("mid-pattern ^")
            parts.append(self._repeat(top))
        if not parts:
            return _Empty()
        return parts[0] if len(parts) == 1 else _Concat(parts)

    def _repeat(self, top: bool) -> _Node:
        node = self._atom(top)
        while True:
            c = self._peek()
            if c == 0x2A:  # '*'
                self.i += 1
                node = _Star(node)
            elif c == 0x2B:  # '+'
                self.i += 1
                node = _Concat([node, _Star(node)])
            elif c == 0x3F:  # '?'
                self.i += 1
                node = _Alt([node, _Empty()])
            elif c == 0x7B:  # '{'
                node = self._bounded(node)
            else:
                break
            # lazy marker: greedy==lazy for boolean acceptance (span-based
            # consumers must check has_lazy and reject)
            if self._peek() == 0x3F:
                self.i += 1
                self.has_lazy = True
            if self._peek() == 0x2B:  # possessive
                raise RegexReject("possessive quantifier")
        return node

    def _bounded(self, node: _Node) -> _Node:
        close = self.p.find(b"}", self.i)
        if close < 0:
            raise RegexReject("unclosed {")
        body = self.p[self.i + 1:close].decode()
        self.i = close + 1
        try:
            if "," in body:
                lo_s, hi_s = body.split(",", 1)
                lo = int(lo_s)
                hi = int(hi_s) if hi_s else None
            else:
                lo = hi = int(body)
        except ValueError:
            raise RegexReject(f"bad bound {{{body}}}")
        if hi is not None and hi < lo:
            raise RegexReject("bad bound order")
        parts: List[_Node] = [node] * lo
        if hi is None:
            parts.append(_Star(node))
        else:
            parts.extend([_Alt([node, _Empty()])] * (hi - lo))
        out = _Concat(parts) if parts else _Empty()
        if out.count() > MAX_EXPANSION:
            raise RegexReject("bound expansion too large")
        return out

    def _atom(self, top: bool) -> _Node:
        c = self._peek()
        if c == 0x28:  # '('
            self.i += 1
            if self.p[self.i:self.i + 2] == b"?:":
                self.i += 2
            elif self._peek() == 0x3F:
                raise RegexReject("special group")
            inner = self._alt()
            if self._peek() != 0x29:
                raise RegexReject("unclosed group")
            self.i += 1
            return inner
        if c == 0x5B:  # '['
            return _Lit(self._char_class())
        if c == 0x2E:  # '.'
            self.i += 1
            return _Lit(_DOT)
        if c == 0x5C:  # '\'
            return _Lit(self._escape())
        if c in (0x2A, 0x2B, 0x3F, 0x7B):
            raise RegexReject("dangling quantifier")
        self.i += 1
        return _Lit(frozenset((c,)))

    def _escape(self) -> FrozenSet[int]:
        self.i += 1
        c = self._peek()
        if c == -1:
            raise RegexReject("trailing backslash")
        self.i += 1
        simple = {0x64: _DIGIT, 0x44: _ALL - _DIGIT, 0x77: _WORD,
                  0x57: _ALL - _WORD, 0x73: _SPACE, 0x53: _ALL - _SPACE}
        if c in simple:
            return simple[c]
        ctrl = {0x6E: 0x0A, 0x74: 0x09, 0x72: 0x0D, 0x66: 0x0C,
                0x61: 0x07, 0x65: 0x1B}
        if c in ctrl:
            return frozenset((ctrl[c],))
        if c == 0x30:  # Java \0n[n[n]] octal escape — digits are REQUIRED
            digits = b""
            while len(digits) < 3 and 0x30 <= self._peek() <= 0x37:
                digits += bytes((self._peek(),))
                self.i += 1
            if not digits:
                raise RegexReject("bare \\0 (illegal octal escape in java)")
            v = int(digits.decode(), 8)
            if v > 0x7F:
                raise RegexReject("non-ASCII octal escape")
            return frozenset((v,))
        if c == 0x78:  # \xhh
            hx = self.p[self.i:self.i + 2]
            try:
                v = int(hx.decode(), 16)
            except ValueError:
                raise RegexReject("bad \\x escape")
            self.i += 2
            if v > 0x7F:
                raise RegexReject("non-ASCII escape")
            return frozenset((v,))
        if chr(c).isalnum():
            raise RegexReject(f"unsupported escape \\{chr(c)}")
        return frozenset((c,))  # escaped punctuation/meta

    def _char_class(self) -> FrozenSet[int]:
        self.i += 1  # '['
        negate = False
        if self._peek() == 0x5E:
            negate = True
            self.i += 1
        out: Set[int] = set()
        first = True
        while True:
            c = self._peek()
            if c == -1:
                raise RegexReject("unclosed class")
            if c == 0x5D and not first:  # ']'
                self.i += 1
                break
            first = False
            if c == 0x5B and self.p[self.i:self.i + 2] == b"[:":
                raise RegexReject("posix class")
            if c == 0x5C:
                s = self._escape()
                if len(s) != 1:
                    out |= s
                    continue
                # a single-byte escape can START a range: [\x41-\x45]
                c = next(iter(s))
            else:
                self.i += 1
            # range?
            if (self._peek() == 0x2D and self.i + 1 < len(self.p)
                    and self.p[self.i + 1] != 0x5D):
                self.i += 1
                hi = self._peek()
                if hi == 0x5C:
                    s = self._escape()
                    if len(s) != 1:
                        raise RegexReject("class range to multi-escape")
                    hi = next(iter(s))
                else:
                    self.i += 1
                if hi < c:
                    raise RegexReject("reversed class range")
                out |= set(range(c, hi + 1))
            else:
                out.add(c)
        if any(b > 0x7F for b in out):
            raise RegexReject("non-ASCII in class")
        return frozenset(_ALL - out) if negate else frozenset(out)


# --- NFA (Thompson) --------------------------------------------------------

class _NFA:
    def __init__(self):
        self.eps: List[List[int]] = []
        self.trans: List[List[Tuple[FrozenSet[int], int]]] = []

    def new_state(self) -> int:
        self.eps.append([])
        self.trans.append([])
        return len(self.eps) - 1

    def add(self, node: _Node, src: int, dst: int) -> None:
        if isinstance(node, _Empty):
            self.eps[src].append(dst)
        elif isinstance(node, _Lit):
            self.trans[src].append((node.bytes, dst))
        elif isinstance(node, _Concat):
            cur = src
            for part in node.parts[:-1]:
                nxt = self.new_state()
                self.add(part, cur, nxt)
                cur = nxt
            self.add(node.parts[-1] if node.parts else _Empty(), cur, dst)
        elif isinstance(node, _Alt):
            for part in node.parts:
                self.add(part, src, dst)
        elif isinstance(node, _Star):
            mid = self.new_state()
            self.eps[src].append(mid)
            self.add(node.inner, mid, mid)
            self.eps[mid].append(dst)
        else:  # pragma: no cover
            raise RegexReject(f"unknown node {node}")

    def eclose(self, states: FrozenSet[int]) -> FrozenSet[int]:
        seen = set(states)
        stack = list(states)
        while stack:
            s = stack.pop()
            for t in self.eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)


class DFA:
    """table[s, cls] transition over byte classes; start/accept metadata."""

    def __init__(self, table: np.ndarray, byte_class: np.ndarray,
                 accepting: np.ndarray, start: int, pattern: str,
                 ascii_atoms: bool):
        self.table = table            # [S, n_classes] int32
        self.byte_class = byte_class  # [256] int32
        self.accepting = accepting    # [S] bool
        self.start = start
        self.pattern = pattern
        # every atom set is ASCII-only => byte-level run is exact for ANY
        # UTF-8 input (multi-byte chars can never match an ASCII atom, and
        # the find-loops consume them exactly like a char-level engine);
        # patterns with '.', negated classes or \D \W \S need ASCII data
        self.ascii_atoms = ascii_atoms

    @property
    def n_states(self) -> int:
        return self.table.shape[0]


def _byte_classes(sets: Sequence[FrozenSet[int]]) -> np.ndarray:
    """Partition 0..255 into equivalence classes under all transition sets
    (bytes with identical membership across every set share a class)."""
    sigs: Dict[Tuple[bool, ...], int] = {}
    out = np.zeros(256, np.int32)
    masks = []
    for s in sets:
        m = np.zeros(256, bool)
        m[list(s)] = True
        masks.append(m)
    for b in range(256):
        key = tuple(m[b] for m in masks)
        out[b] = sigs.setdefault(key, len(sigs))
    return out


@functools.lru_cache(maxsize=256)
def compile_dfa(pattern: str,
                max_states: int = None) -> Optional[DFA]:
    """Compile to a DFA for whole-row acceptance with find semantics folded
    in, or None when the pattern is outside the subset (host fallback)."""
    try:
        parser = _Parser(pattern)
        ast = parser.parse()
        if ast.count() > MAX_EXPANSION:
            raise RegexReject("pattern too large")
        nfa = _NFA()
        start = nfa.new_state()
        accept = nfa.new_state()
        nfa.add(ast, start, accept)
        ascii_atoms = all(max(s, default=0) < 0x80
                          for row in nfa.trans for (s, _) in row)
        if not parser.anchored_start:
            nfa.trans[start].append((_ALL, start))
        if parser.anchored_end:
            # Java (non-MULTILINE) '$' also matches just before a FINAL
            # line terminator: accept --\n-->F, --\r-->F, --\r\n-->F.
            # Unicode terminators (U+0085/U+2028/U+2029) can't be modeled
            # byte-wise, so $-anchored patterns require ASCII data.
            final = nfa.new_state()
            nfa.eps[accept].append(final)
            cr_mid = nfa.new_state()
            nfa.trans[accept].append((frozenset((0x0D,)), cr_mid))
            nfa.trans[cr_mid].append((frozenset((0x0A,)), final))
            nfa.eps[cr_mid].append(final)
            nfa.trans[accept].append((frozenset((0x0A,)), final))
            accept = final
            ascii_atoms = False
        else:
            nfa.trans[accept].append((_ALL, accept))

        all_sets = [s for row in nfa.trans for (s, _) in row] or [_ALL]
        byte_class = _byte_classes(all_sets)
        n_classes = int(byte_class.max()) + 1
        # representative byte per class
        reps = [int(np.argmax(byte_class == c)) for c in range(n_classes)]

        d0 = nfa.eclose(frozenset((start,)))
        states: List[FrozenSet[int]] = [d0]
        ids: Dict[FrozenSet[int], int] = {d0: 0}
        rows: List[List[int]] = []
        i = 0
        while i < len(states):
            cur = states[i]
            row = []
            for rep in reps:
                nxt = set()
                for s in cur:
                    for bs, t in nfa.trans[s]:
                        if rep in bs:
                            nxt.add(t)
                closed = nfa.eclose(frozenset(nxt))
                if closed not in ids:
                    if len(states) >= (max_states or MAX_DFA_STATES):
                        raise RegexReject("DFA too large")
                    ids[closed] = len(states)
                    states.append(closed)
                row.append(ids[closed])
            rows.append(row)
            i += 1
        table = np.asarray(rows, np.int32)
        accepting = np.asarray([accept in st for st in states], bool)
        return DFA(table, byte_class, accepting, 0, pattern, ascii_atoms)
    except RegexReject:
        return None


def _device_tables(dfa: DFA, device):
    """(table flattened int64 [S * C], classes int64 [256], accepting
    bool [S], C) on ``device``, memoized on the DFA a device."""
    memo = dfa.__dict__.setdefault("_device", {})
    key = str(device)
    if key not in memo:
        memo[key] = (torch.as_tensor(dfa.table.reshape(-1), dtype=torch.int64,
                                     device=device),
                     torch.as_tensor(dfa.byte_class, dtype=torch.int64,
                                     device=device),
                     torch.as_tensor(dfa.accepting, dtype=torch.bool,
                                     device=device),
                     int(dfa.table.shape[1]))
    return memo[key]


def rlike_device(data: torch.Tensor, offsets: torch.Tensor, dfa: DFA,
                 max_len: int) -> torch.Tensor:
    """bool [capacity]: whether each row matches. Every row advances one
    byte a step for ``max_len`` steps (a row stops at its end): a gather
    from the byte buffer and a table lookup a step, no host read."""
    dev = data.device
    starts, lens = starts_lengths(offsets)
    table, cls, accepting, n_cls = _device_tables(dfa, dev)
    state = torch.full_like(starts, dfa.start)
    nbytes = data.numel()
    if nbytes == 0 or max_len == 0:
        return accepting[state]
    last = nbytes - 1
    for j in range(max_len):
        byte = data[(starts + j).clamp(max=last)].to(torch.int64)
        nxt = table[state * n_cls + cls[byte]]
        state = torch.where(j < lens, nxt, state)
    return accepting[state]


# --- span matching (regexp_replace / regexp_extract) ------------------------

class ExactDFA(DFA):
    """DFA for exact-at-position matching: no find loops, plus a dead state
    and the shortest accepted length (for output-capacity bounds)."""

    def __init__(self, base: DFA, dead: int, min_len: int):
        super().__init__(base.table, base.byte_class, base.accepting,
                         base.start, base.pattern, base.ascii_atoms)
        self.dead = dead
        self.min_len = min_len


def _flatten_atoms(node: _Node) -> List[_Node]:
    """Top-level atom sequence: Concats inlined, quantified nodes atomic."""
    if isinstance(node, _Concat):
        out: List[_Node] = []
        for p in node.parts:
            out.extend(_flatten_atoms(p))
        return out
    return [node]


def _contains_var(node: _Node) -> bool:
    if isinstance(node, (_Star, _Alt)):
        return True
    if isinstance(node, _Concat):
        return any(_contains_var(p) for p in node.parts)
    return False


def _byteset(node: _Node) -> FrozenSet[int]:
    if isinstance(node, _Lit):
        return node.bytes
    if isinstance(node, _Star):
        return _byteset(node.inner)
    if isinstance(node, (_Concat, _Alt)):
        out: Set[int] = set()
        for p in node.parts:
            out |= _byteset(p)
        return frozenset(out)
    return frozenset()


def _nullable(node: _Node) -> bool:
    if isinstance(node, (_Star, _Empty)):
        return True
    if isinstance(node, _Alt):
        return any(_nullable(p) for p in node.parts)
    if isinstance(node, _Concat):
        return all(_nullable(p) for p in node.parts)
    return False


def _first_set(node: _Node) -> FrozenSet[int]:
    if isinstance(node, _Lit):
        return node.bytes
    if isinstance(node, _Star):
        return _first_set(node.inner)
    if isinstance(node, _Alt):
        out: Set[int] = set()
        for p in node.parts:
            out |= _first_set(p)
        return frozenset(out)
    if isinstance(node, _Concat):
        out = set()
        for p in node.parts:
            out |= _first_set(p)
            if not _nullable(p):
                break
        return frozenset(out)
    return frozenset()


def _var_atom(seg: _Node) -> Optional[_Node]:
    """The single-repetition atom of a variable-length segment, or None if
    the segment is fixed. After the global alternation rejection, any _Alt
    is a desugared '?' / '{m,n}' optional: [node, _Empty]."""
    if isinstance(seg, _Star):
        return seg.inner
    if isinstance(seg, _Alt):
        real = [p for p in seg.parts if not isinstance(p, _Empty)]
        return real[0] if len(real) == 1 else seg
    return None


def _reject_ambiguous_span(ast: _Node) -> None:
    """Greedy backtracking (Java) == leftmost-longest (this DFA) only for
    unambiguous-match-length patterns. Divergence needs a
    variable-length segment V followed — across only nullable segments — by
    another variable segment W whose first-set overlaps V's bytes, where at
    least one of the two repeats a MULTI-byte atom: for `a+(ab)?` on "aab"
    Java matches "aa" (greedy a+ never gives bytes back to lengthen the
    total) while the DFA takes "aab". Single-byte-atom chains (a{0,2}x?,
    [ab]*c*) are safe: one byte per repetition means surrendering a byte to
    a later single-byte quantifier never extends the overall end. Nested
    variable quantifiers ((a*b)+) are rejected outright — their inner
    backtracking order is beyond this static check."""
    segs = _flatten_atoms(ast)
    atoms = [_var_atom(s) for s in segs]
    for i, ai in enumerate(atoms):
        if ai is None:
            continue
        if _contains_var(ai):
            raise RegexReject("nested variable quantifier span")
        multi_i = ai.count() >= 2
        bytes_i = _byteset(segs[i])
        for j in range(i + 1, len(segs)):
            aj = atoms[j]
            if aj is not None:
                if (bytes_i & _first_set(segs[j])
                        and (multi_i or aj.count() >= 2)):
                    raise RegexReject("ambiguous greedy span: variable "
                                      "segments with overlapping byte sets")
            # a required segment ends the competition window ONLY if V
            # could never have consumed it: a required atom overlapping V's
            # bytes may sit inside V's territory ((ab)*a(bab)? — the 'a'
            # does not fence off the later (bab)?), so keep scanning
            if not _nullable(segs[j]) and not (_byteset(segs[j]) & bytes_i):
                break


@functools.lru_cache(maxsize=256)
def compile_exact_dfa(pattern: str,
                      max_states: int = None) -> Optional["ExactDFA"]:
    """Compile for SPAN matching (longest match starting at a position), or
    None when outside the subset. Rejections beyond compile_dfa's:
      * '|' anywhere and lazy quantifiers: Java's backtracking engine picks
        the first-alternative / shortest span, not the longest the DFA
        computes (greedy-only concat/class/quantifier patterns ARE
        leftmost-longest, which is what Java picks for them);
      * anchors: find-with-spans over '^'/'$' is a different machine;
      * nullable patterns: Java's empty-match advance rules
        (replaceAll("a*",..) emitting between every char) are out of scope.
    """
    try:
        parser = _Parser(pattern)
        ast = parser.parse()
        if parser.anchored_start or parser.anchored_end:
            raise RegexReject("anchored pattern for span matching")
        if parser.has_alternation:
            raise RegexReject("alternation: greedy-first != longest")
        if parser.has_lazy:
            raise RegexReject("lazy quantifier span")
        if ast.count() > MAX_EXPANSION:
            raise RegexReject("pattern too large")
        _reject_ambiguous_span(ast)
        nfa = _NFA()
        start = nfa.new_state()
        accept = nfa.new_state()
        nfa.add(ast, start, accept)
        ascii_atoms = all(max(s, default=0) < 0x80
                          for row in nfa.trans for (s, _) in row)

        all_sets = [s for row in nfa.trans for (s, _) in row] or [_ALL]
        byte_class = _byte_classes(all_sets)
        n_classes = int(byte_class.max()) + 1
        reps = [int(np.argmax(byte_class == c)) for c in range(n_classes)]

        d0 = nfa.eclose(frozenset((start,)))
        if accept in d0:
            raise RegexReject("nullable pattern (matches empty)")
        states: List[FrozenSet[int]] = [d0]
        ids: Dict[FrozenSet[int], int] = {d0: 0}
        rows: List[List[int]] = []
        i = 0
        while i < len(states):
            cur = states[i]
            row = []
            for rep in reps:
                nxt = set()
                for s in cur:
                    for bs, t in nfa.trans[s]:
                        if rep in bs:
                            nxt.add(t)
                closed = nfa.eclose(frozenset(nxt))
                if closed not in ids:
                    if len(states) >= (max_states or MAX_DFA_STATES):
                        raise RegexReject("DFA too large")
                    ids[closed] = len(states)
                    states.append(closed)
                row.append(ids[closed])
            rows.append(row)
            i += 1
        table = np.asarray(rows, np.int32)
        accepting = np.asarray([accept in st for st in states], bool)
        dead = ids.get(frozenset())
        if dead is None:  # make an explicit dead state
            dead = len(states)
            table = np.vstack([table, np.full((1, n_classes), dead,
                                              np.int32)])
            accepting = np.append(accepting, False)
        # shortest accepted length: BFS over the DFA
        from collections import deque
        dist = {0: 0}
        dq = deque([0])
        min_len = None
        while dq:
            s = dq.popleft()
            if accepting[s]:
                min_len = dist[s]
                break
            for t in table[s]:
                t = int(t)
                if t not in dist:
                    dist[t] = dist[s] + 1
                    dq.append(t)
        if not min_len:  # unreachable accept or nullable: host
            raise RegexReject("no reachable non-empty match")
        base = DFA(table, byte_class, accepting, 0, pattern, ascii_atoms)
        return ExactDFA(base, dead, min_len)
    except RegexReject:
        return None



def match_lengths_device(data: torch.Tensor, offsets: torch.Tensor,
                         dfa: "ExactDFA", max_len: int) -> torch.Tensor:
    """int64 [nbytes]: the longest match starting at each byte position (0:
    none there). Each position is a lane; step t feeds lane p the byte at
    p + t, the lane dies at its row's end. Lanes in the dead state are
    dropped after steps 1, 2, 4, 8, ... and then every 16 (a host read of
    the live count each time), and the walk ends when none is left."""
    nbytes = data.numel()
    dev = data.device
    mlen = torch.zeros(nbytes, dtype=torch.int64, device=dev)
    if nbytes == 0:
        return mlen
    table, cls, accepting, n_cls = _device_tables(dfa, dev)
    rows = byte_rows(offsets, nbytes)
    offs = offsets.to(torch.int64)
    lane = torch.arange(nbytes, dtype=torch.int64, device=dev)
    end = offs[(rows + 1).clamp(max=offs.shape[0] - 1)]
    end = torch.where(rows < offs.shape[0] - 1, end, lane)
    state = torch.full_like(lane, dfa.start)
    got = torch.zeros_like(lane)
    last = nbytes - 1
    for t in range(max_len):
        idx = lane + t
        b = data[idx.clamp(max=last)].to(torch.int64)
        state = torch.where(idx < end, table[state * n_cls + cls[b]],
                            dfa.dead)
        got = torch.where(accepting[state], t + 1, got)
        step = t + 1
        if step & (step - 1) == 0 or step % 16 == 0:
            mlen[lane] = got
            keep = torch.nonzero(state != dfa.dead).flatten()
            if keep.numel() == 0:
                return mlen
            lane, state, got, end = lane[keep], state[keep], got[keep], \
                end[keep]
    mlen[lane] = got
    return mlen


def select_leftmost_nonoverlapping(mlen: torch.Tensor,
                                   offsets: torch.Tensor) -> torch.Tensor:
    """bool [nbytes]: Java replaceAll's matches — each row scanned left to
    right, a match taken when it starts at or past the end of the last
    one taken."""
    nbytes = mlen.shape[0]
    if nbytes == 0 or offsets.shape[0] < 2:
        return torch.zeros(nbytes, dtype=torch.bool, device=mlen.device)
    ends = torch.arange(nbytes, dtype=torch.int64, device=mlen.device) + mlen
    return take_chains(mlen > 0, byte_rows(offsets, nbytes), ends)
