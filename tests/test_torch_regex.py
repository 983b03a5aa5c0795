"""The port's regex engine (``spark_rapids_tpu_torch/kernels/regex_dfa.py``,
``expressions/regex.py``) held to the reference's.

* The compiler is the reference's, copied: over the reference's pattern
  corpus (``tests/test_regex_dfa.py``) both give equal ``table``,
  ``byte_class``, ``accepting``, ``start`` (and ``dead``, ``min_len`` for
  span matching), and reject the same patterns.
* The span walks (``match_lengths_device``,
  ``select_leftmost_nonoverlapping``) give the reference walks' answers;
  ``rlike_device`` is held through ``rlike`` below.
* ``rlike``, ``regexp_replace`` and ``regexp_extract`` equal the
  reference's ``eval_tpu`` exactly, on the device inside the subset (the
  host hop poisoned, ``strings.hostPath`` 0) and through the counted host
  hop outside it: rejected patterns, non-ASCII rows, rows past the
  row-byte caps, capture groups. A backreference or a lookahead, which
  the reference's RE2 host hop cannot compile, is held to Python's ``re``
  (ROADMAP C-ref-16)."""

import collections
import re

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.columnar.batch import TpuColumnarBatch
from spark_rapids_tpu.columnar.vector import TpuColumnVector
from spark_rapids_tpu.expressions import base as RB
from spark_rapids_tpu.expressions import regex as RRX
from spark_rapids_tpu.kernels import regex_dfa as RD
import spark_rapids_tpu_torch.expressions.regex as PRX
import spark_rapids_tpu_torch.expressions.strings as PS
from spark_rapids_tpu_torch.columnar.batch import TorchColumnarBatch
from spark_rapids_tpu_torch.columnar.vector import TorchColumnVector
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.expressions import base as PB
from spark_rapids_tpu_torch.expressions.base import EvalContext
from spark_rapids_tpu_torch.kernels import regex_dfa as PD
from spark_rapids_tpu_torch.types import StringT

SUBJECTS = ["", "a", "abc", "xabcy", "123", "a1b2c3", "hello world",
            "HELLO", "h\nt", "hat", "ab" * 40, "a@b.com", "x@y.org",
            "café", "éé", "naïve33", "  spaced  ", "a-b_c.d", None,
            "abc\n", "abc\r\n", "a\x07b", "C", "-", "E", "12-345 DELIVER"]
ASCII_SUBJECTS = [s for s in SUBJECTS if s is None or s.isascii()]

DEVICE_PATTERNS = [
    "abc", "^abc", "abc$", "^abc$", "a*", "a+b", "ab?c", "[a-c]+x",
    "a|bc|def", r"\d{2,3}", "h.t", "[^0-9]+", "(ab)+c", r"\w+@\w+",
    r"^\w+@\w+\.(com|org)$", r"\s\s", r"[aeiou]{2}", "x{0,2}y",
    "(a|b)(c|d)e?", r"\.", "a{3,}", "c$", r"\07", "^(a|b)$",
    r"[\x41-\x45]", r"[a-z]+\d", r"^\d{2}-\d{3}", "(DELIVER|TAKE) BACK"]
REJECT_PATTERNS = ["a(?=b)", r"(a)\1", r"\p{L}", "a*+", "café",
                   r"\bword\b", "a$b", "(?<=x)y", "[[:alpha:]]",
                   "a|b$", "^a|b", "^a|b$", "a|b|c$", "\\0"]
REPLACE_PATTERNS = [
    (r"\d+", "#"), ("l+", "L"), (r"\s+", "_"), ("x", "yy"),
    (r"[0-9]{2,3}", "<n>"), (r"[aeiou]", ""), ("ab", "ba"),
    (r"\w\d", "*"), ("h.t", "HAT"), (r"[a-c]{2}", "Z")]
SPAN_ONLY = ["a|b", "a*?b", "^ab", "ab$", "x?", "(a|b)c", "a+(ab)?",
             "xa{0,2}(ab)?", "a*(ab)*", "(ab)?(aba)?", "(a*b)+",
             "[ab]+(ba)?", "a{2,4}", "x[ab]{0,3}", "[0-9]{1,3}", "a+b*",
             "abc[0-9]*", r"\w{3}", r"[a-c]+", r"(\d+)-(\d+)"]
CORPUS = sorted(set(DEVICE_PATTERNS + REJECT_PATTERNS + SPAN_ONLY
                    + [p for p, _ in REPLACE_PATTERNS]))


def _same_dfa(r, p):
    if r is None or p is None:
        return r is None and p is None
    same = (np.array_equal(r.table, p.table)
            and np.array_equal(r.byte_class, p.byte_class)
            and np.array_equal(r.accepting, p.accepting)
            and r.start == p.start and r.ascii_atoms == p.ascii_atoms)
    if isinstance(r, RD.ExactDFA):
        same = same and (r.dead, r.min_len) == (p.dead, p.min_len)
    return same


@pytest.mark.parametrize("pat", CORPUS)
def test_compiler_tables_equal_the_reference(pat):
    assert _same_dfa(RD.compile_dfa(pat), PD.compile_dfa(pat))
    assert _same_dfa(RD.compile_exact_dfa(pat), PD.compile_exact_dfa(pat))
    assert _same_dfa(RD.compile_dfa(pat, 4), PD.compile_dfa(pat, 4))


def test_the_state_cap_rejects_alike():
    pat = "(a|b)*a(a|b)(a|b)(a|b)(a|b)(a|b)"
    assert PD.compile_dfa(pat, 16) is None and RD.compile_dfa(pat, 16) is None
    assert _same_dfa(RD.compile_dfa(pat), PD.compile_dfa(pat))


def _batches(vals):
    arr = pa.array(vals, pa.string())
    rcol = TpuColumnVector.from_arrow(arr)
    pcol = TorchColumnVector.from_numpy(StringT, np.array(vals, dtype=object))
    return (TpuColumnarBatch([rcol], len(vals), names=["s"]),
            RB.AttributeReference("s", rcol.dtype, ordinal=0),
            TorchColumnarBatch([pcol], len(vals), names=["s"]),
            PB.AttributeReference("s", StringT, ordinal=0))


@pytest.mark.parametrize("pat", [r"\d+", "ab", r"[a-c]{2}", r"\w{3}"])
def test_span_walks_equal_the_reference(pat):
    rb, _, pb, _ = _batches(ASCII_SUBJECTS)
    rc, pc = rb.columns[0], pb.columns[0]
    steps = max(len(s or "") for s in ASCII_SUBJECTS)
    rd, pd = RD.compile_exact_dfa(pat), PD.compile_exact_dfa(pat)
    want_j = RD.match_lengths_device(rc.data, rc.offsets, rd, steps)
    want = np.asarray(want_j)
    got = PD.match_lengths_device(pc.data, pc.offsets, pd, steps).numpy()
    end = int(pc.offsets[-1])
    assert (got[:end] == want[:end]).all()
    want_t = np.asarray(RD.select_leftmost_nonoverlapping(
        want_j, rc.offsets, steps))
    got_t = PD.select_leftmost_nonoverlapping(
        PD.match_lengths_device(pc.data, pc.offsets, pd, steps),
        pc.offsets).numpy()
    assert (got_t[:end] == want_t[:end]).all()


def _run(make_ref, make_port, vals, conf=None, poison=None):
    rb, rr, pb, pr = _batches(vals)
    want = make_ref(rr).eval_tpu(rb).to_arrow().to_pylist()[:len(vals)]
    ctx = EvalContext(RapidsConf(conf or {}),
                      counters=collections.Counter())
    if poison is not None:
        def no_hop(*a, **k):
            raise AssertionError("host hop on the device path")
        poison.setattr(PS, "column_to_arrow", no_hop)
        poison.setattr(PRX, "column_to_arrow", no_hop)
    got = make_port(pr).eval_device(pb, ctx)
    if poison is not None:
        poison.undo()
    return got.to_pylist(), want, PS.host_path_counts(ctx.counters)


@pytest.mark.parametrize("pat", DEVICE_PATTERNS)
def test_rlike_equals_the_reference(pat, monkeypatch):
    dfa = PD.compile_dfa(pat)
    on_device = dfa is not None and dfa.ascii_atoms
    got, want, hops = _run(lambda r: RRX.RLike(r, pat),
                           lambda r: PRX.RLike(r, pat), SUBJECTS,
                           poison=monkeypatch if on_device else None)
    assert got == want
    rewritten = PRX.literal_prefix_rewrite(pat) is not None
    assert bool(hops) == (not on_device and not rewritten), hops


#: patterns the reference's host hop (RE2) cannot compile
RE2_REJECTS = [r"(a)\1", r"(\w)\1", "a(?=b)"]


@pytest.mark.parametrize("pat", [p for p in REJECT_PATTERNS
                                 if PRX.transpile(p) is not None
                                 and p not in RE2_REJECTS])
def test_rlike_outside_the_subset_takes_the_counted_host_path(pat):
    got, want, hops = _run(lambda r: RRX.RLike(r, pat),
                           lambda r: PRX.RLike(r, pat), SUBJECTS)
    if "[[" in pat:
        # Java unions a nested set into its class: '[[:alpha:]]' is one of
        # ':alph'. The reference's RE2 reads a POSIX class (ROADMAP C5 and
        # C-ref-20); the port flattens the set, inside the DFA subset
        java = re.compile(PRX.java_pattern(pat))
        assert got == [None if v is None else java.search(v) is not None
                       for v in SUBJECTS]
        assert got != want and hops == {}
        return
    assert got == want
    rewritten = PRX.literal_prefix_rewrite(pat) is not None
    assert hops == ({} if rewritten else
                    {("RLike", "out-of-subset pattern"): 1})


@pytest.mark.parametrize("pat", RE2_REJECTS)
def test_rlike_past_re2_follows_java(pat):
    """The reference's host hop hands a backreference or a lookahead to
    RE2, which cannot compile it (it raises); the port matches it with
    Python's ``re``, which reads it as Java does."""
    vals = ["aa", "ab", "xyzz", None, "", "é", "abcabc", "aab"]
    rb, rr, pb, pr = _batches(vals)
    with pytest.raises(pa.ArrowInvalid):
        RRX.RLike(rr, pat).eval_tpu(rb)
    ctx = EvalContext(counters=collections.Counter())
    got = PRX.RLike(pr, pat).eval_device(pb, ctx).to_pylist()
    assert got == [None if v is None else re.search(pat, v) is not None
                   for v in vals]
    assert PS.host_path_counts(ctx.counters) == {
        ("RLike", "out-of-subset pattern"): 1}


def test_rejected_patterns_are_tagged_off_the_card():
    r = PB.AttributeReference("s", StringT, ordinal=0)
    for pat in ("a*+b", r"\p{L}", "(?<=x)y"):
        assert not PRX.RLike(r, pat).tpu_supported
        assert not RRX.RLike(r, pat).tpu_supported


def test_rows_past_the_byte_caps_take_the_host_path():
    vals = ["x" * 40 + "ab1", "ab", None, "12-345"]
    got, want, hops = _run(lambda r: RRX.RLike(r, "a[b-c]"),
                           lambda r: PRX.RLike(r, "a[b-c]"), vals,
                           conf={"spark.rapids.sql.regexp.maxDeviceRowBytes":
                                 "16"})
    assert got == want
    assert hops == {("RLike", "row past the byte cap"): 1}
    got, want, hops = _run(lambda r: RRX.RegexpReplace(r, r"\d+", "#"),
                           lambda r: PRX.RegexpReplace(r, r"\d+", "#"), vals,
                           conf={"spark.rapids.sql.regexp.maxSpanRowBytes":
                                 "16"})
    assert got == want
    assert hops == {("RegexpReplace", "row past the byte cap"): 1}


@pytest.mark.parametrize("pat,repl", REPLACE_PATTERNS
                         + [("b", "$0x"), ("a|b", "-"), ("c?", "y")])
def test_regexp_replace_equals_the_reference(pat, repl, monkeypatch):
    device = PD.compile_exact_dfa(pat) is not None and "$" not in repl
    got, want, hops = _run(lambda r: RRX.RegexpReplace(r, pat, repl),
                           lambda r: PRX.RegexpReplace(r, pat, repl),
                           ASCII_SUBJECTS,
                           poison=monkeypatch if device else None)
    assert got == want
    assert bool(hops) == (not device), hops


@pytest.mark.parametrize("pat,group", [(r"\d+", 0), ("l+", 0), (r"[a-c]+", 0),
                                       ("h.t", 0), (r"\w{3}", 0),
                                       (r"(\d+)-(\d+)", 1),
                                       (r"(\d+)-(\d+)", 2), ("(a+)(b*)", 2)])
def test_regexp_extract_equals_the_reference(pat, group, monkeypatch):
    device = group == 0
    got, want, hops = _run(lambda r: RRX.RegexpExtract(r, pat, group),
                           lambda r: PRX.RegexpExtract(r, pat, group),
                           SUBJECTS if group else ASCII_SUBJECTS,
                           poison=monkeypatch if device else None)
    assert got == want
    assert hops == ({} if device else {("RegexpExtract", "capture group"): 1})


@pytest.mark.parametrize("pat", ["h_llo%", "%_", "_", "日%", "%テ_ト",
                                 "a\\_b%"])
def test_like_underscore_over_non_ascii_matches_the_reference(pat):
    vals = ["héllo wörld", "hello", "日本語テスト", None, "", "é", "a_bc",
            "ab", "x"]
    got, want, hops = _run(lambda r: RRX.Like(r, pat),
                           lambda r: PS.Like(r, pat), vals)
    assert got == want
    assert hops == ({("Like", "non-ASCII"): 1} if "_" in pat.replace(
        "\\_", "") else {})


def test_replace_fuzz_equals_python():
    rng = np.random.default_rng(7)
    subjects = ["".join(rng.choice(list("ab1 x"), size=rng.integers(0, 12)))
                for _ in range(200)]
    _, _, pb, pr = _batches(subjects)
    for pat, repl in [(r"\d", "N"), ("a+", "A"), ("ab", "-"),
                      (r"[ax]{2}", "!"), (r"\s", ".")]:
        ctx = EvalContext(counters=collections.Counter())
        got = PRX.RegexpReplace(pr, pat, repl).eval_device(pb, ctx)
        assert got.to_pylist() == [re.sub(pat, repl, v) for v in subjects]
        assert not ctx.counters[PS.HOST_PATH]
