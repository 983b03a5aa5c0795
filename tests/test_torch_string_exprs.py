"""The port's string expressions (``spark_rapids_tpu_torch/expressions/
strings.py``) and string kernels (``kernels/strings.py``) held to the
reference's ``eval_tpu`` and kernels on the JAX CPU backend, exactly.

Two corpora go through each expression: the reference's ASCII corpus
(``tests/test_device_strings.py``) with the ASCII rows of 333 rows made
from a numpy seed (words, digits, dashes and runs of spaces; 1 row in 8
with a non-ASCII word, 1 in 10 null, some empty), and the reference's
Unicode corpus with all 333 (the batches' capacities leave padding
rows). Over ASCII input every case must stay on the device: the
host hop is poisoned and ``strings.hostPath`` must stay 0. Over non-ASCII
input the character-oriented ones take the host hop, counted by class and
reason."""

import collections

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.batch import TpuColumnarBatch
from spark_rapids_tpu.columnar.vector import TpuColumnVector
from spark_rapids_tpu.expressions import base as RB
from spark_rapids_tpu.expressions import hashexprs as RH
from spark_rapids_tpu.expressions import regex as RRX
from spark_rapids_tpu.expressions import strings as RS
from spark_rapids_tpu.kernels import strings as RK
import spark_rapids_tpu_torch.expressions.strings as PS
from spark_rapids_tpu_torch.columnar.batch import TorchColumnarBatch
from spark_rapids_tpu_torch.columnar.vector import TorchColumnVector
from spark_rapids_tpu_torch.expressions import base as PB
from spark_rapids_tpu_torch.expressions import hashexprs as PH
from spark_rapids_tpu_torch.expressions.base import EvalContext, to_column
from spark_rapids_tpu_torch.kernels import strings as PK
from spark_rapids_tpu_torch.types import StringT

ASCII_VALS = ["hello world", "", None, "  spaced  ", "aAbBcC", "aaaa",
              "x,y,z,w", "pad", "  ", "ab,cd", "hello", "wxyz", "\tmix ed\n",
              "%odd_chars$", "trailing   ", "   leading", None, "a"]

UNI_VALS = ["héllo wörld", "日本語テスト", None, "  ünïcode  ", "Ça va",
            "αβγαβγ", "", "a👍b,c👍d"]

WORDS = ["deliver", "in", "person", "TAKE", "BACK", "return", "NONE",
         "ship", "air", "aaa", "a,b", "x-1"]
WIDE = ["é", "straße", "中文", "naïve"]


def _seeded(n: int = 333) -> list:
    rng = np.random.default_rng(97)
    out = []
    for i in range(n):
        k = int(rng.integers(0, 6))
        parts = [WORDS[j] for j in rng.integers(0, len(WORDS), k)]
        if rng.random() < 0.3:
            parts.append(f"{rng.integers(0, 100):02d}-{rng.integers(0, 1000)}")
        if rng.random() < 0.125:
            parts.insert(int(rng.integers(0, len(parts) + 1)),
                         WIDE[int(rng.integers(0, len(WIDE)))])
        sep = " " * int(rng.integers(1, 3))
        out.append(None if rng.random() < 0.1 else sep.join(parts)
                   + (" " if rng.random() < 0.2 else ""))
    return out


_SEEDED = _seeded()
CORPORA = {"ascii": ASCII_VALS + [v for v in _SEEDED
                                  if v is None or v.isascii()],
           "mixed": UNI_VALS + _SEEDED}


class _Ns:
    """One package's expression classes under one set of names."""

    def __init__(self, strings, regex, base, like):
        for mod in (regex, strings):
            for k in dir(mod):
                if not k.startswith("_"):
                    setattr(self, k, getattr(mod, k))
        self.Lit = base.Literal
        self.Like = like


REF = _Ns(RS, RRX, RB, RRX.Like)
PORT = _Ns(PS, __import__("spark_rapids_tpu_torch.expressions.regex",
                          fromlist=["x"]), PB, PS.Like)
REF.Murmur3Hash = RH.Murmur3Hash
PORT.Murmur3Hash = PH.Murmur3Hash

CASES = {
    "length": lambda M, r: M.Length(r),
    "upper": lambda M, r: M.Upper(r),
    "lower": lambda M, r: M.Lower(r),
    "trim": lambda M, r: M.Trim(r),
    "ltrim": lambda M, r: M.LTrim(r),
    "rtrim": lambda M, r: M.RTrim(r),
    "reverse": lambda M, r: M.Reverse(r),
    "initcap": lambda M, r: M.InitCap(r),
    "startswith": lambda M, r: M.StartsWith(r, M.Lit("a")),
    "endswith": lambda M, r: M.EndsWith(r, M.Lit("d")),
    "contains": lambda M, r: M.Contains(r, M.Lit("ll")),
    "contains_empty": lambda M, r: M.Contains(r, M.Lit("")),
    "substring_2_3": lambda M, r: M.Substring(r, M.Lit(2), M.Lit(3)),
    "substring_neg": lambda M, r: M.Substring(r, M.Lit(-3), M.Lit(2)),
    "substring_past_end": lambda M, r: M.Substring(r, M.Lit(50), M.Lit(4)),
    "repeat": lambda M, r: M.StringRepeat(r, M.Lit(3)),
    "repeat_0": lambda M, r: M.StringRepeat(r, M.Lit(0)),
    "replace": lambda M, r: M.StringReplace(r, M.Lit("a"), M.Lit("XY")),
    "replace_overlap": lambda M, r: M.StringReplace(r, M.Lit("aa"),
                                                    M.Lit("b")),
    "replace_delete": lambda M, r: M.StringReplace(r, M.Lit("l"), M.Lit("")),
    "locate": lambda M, r: M.StringLocate(M.Lit("l"), r),
    "locate_from_3": lambda M, r: M.StringLocate(M.Lit("a"), r, M.Lit(3)),
    "locate_empty": lambda M, r: M.StringLocate(M.Lit(""), r, M.Lit(2)),
    "instr": lambda M, r: M.StringInstr(r, M.Lit("e")),
    "lpad": lambda M, r: M.LPad(r, M.Lit(6), M.Lit("*#")),
    "rpad": lambda M, r: M.RPad(r, M.Lit(6), M.Lit("*#")),
    "lpad_truncate": lambda M, r: M.LPad(r, M.Lit(3), M.Lit("*")),
    "lpad_empty_pad": lambda M, r: M.LPad(r, M.Lit(6), M.Lit("")),
    "translate": lambda M, r: M.StringTranslate(r, M.Lit("abc"),
                                                M.Lit("AB")),
    "concat_ws": lambda M, r: M.ConcatWs(M.Lit("-"), r, M.Lit("z"), r),
    "substring_index_2": lambda M, r: M.SubstringIndex(r, M.Lit(","),
                                                       M.Lit(2)),
    "substring_index_neg": lambda M, r: M.SubstringIndex(r, M.Lit(" "),
                                                         M.Lit(-2)),
    "substring_index_overlap": lambda M, r: M.SubstringIndex(
        r, M.Lit("aa"), M.Lit(2)),
    "octet_length": lambda M, r: M.OctetLength(r),
    "bit_length": lambda M, r: M.BitLength(r),
    "ascii": lambda M, r: M.Ascii(r),
    "concat": lambda M, r: M.ConcatStr(r, M.Lit("!"), r),
    "like_wild": lambda M, r: M.Like(r, "%l_o%"),
    "like_prefix": lambda M, r: M.Like(r, "a%"),
    "hash": lambda M, r: M.Murmur3Hash(r),
}

#: cases that stay on the device over any UTF-8 (byte-oriented)
BYTE_SAFE = {"length", "startswith", "endswith", "contains",
             "contains_empty", "repeat", "repeat_0", "replace",
             "replace_overlap", "replace_delete", "concat_ws",
             "substring_index_2", "substring_index_neg",
             "substring_index_overlap", "octet_length", "bit_length",
             "concat", "like_prefix", "hash"}


def _batches(vals):
    arr = pa.array(vals, pa.string())
    rcol = TpuColumnVector.from_arrow(arr)
    rbatch = TpuColumnarBatch([rcol], len(vals), names=["s"])
    pcol = TorchColumnVector.from_numpy(StringT, np.array(vals, dtype=object))
    pbatch = TorchColumnarBatch([pcol], len(vals), names=["s"])
    return (rbatch, RB.AttributeReference("s", rcol.dtype, ordinal=0),
            pbatch, PB.AttributeReference("s", StringT, ordinal=0))


def _reference_rows(name, vals):
    rbatch, rref, _, _ = _batches(vals)
    out = CASES[name](REF, rref).eval_tpu(rbatch)
    return out.to_arrow().to_pylist()[:len(vals)]


def _port_rows(name, vals, monkeypatch=None):
    _, _, pbatch, pref = _batches(vals)
    ctx = EvalContext(counters=collections.Counter())
    if monkeypatch is not None:
        def no_hop(*a, **k):
            raise AssertionError("host hop on the device path")
        monkeypatch.setattr(PS, "column_to_arrow", no_hop)
    out = to_column(CASES[name](PORT, pref).eval_device(pbatch, ctx), pbatch)
    if monkeypatch is not None:
        monkeypatch.undo()
    return out.to_pylist(), ctx.counters


@pytest.mark.parametrize("name", sorted(CASES))
def test_ascii_input_stays_on_the_device(name, monkeypatch):
    vals = CORPORA["ascii"]
    got, counters = _port_rows(name, vals, monkeypatch)
    assert got == _reference_rows(name, vals), name
    assert counters[PS.HOST_PATH] == 0, dict(counters)


@pytest.mark.parametrize("name", sorted(CASES))
def test_non_ascii_input_matches_the_reference(name):
    vals = CORPORA["mixed"]
    got, counters = _port_rows(name, vals)
    assert got == _reference_rows(name, vals), name
    hops = PS.host_path_counts(counters)
    if name in BYTE_SAFE:
        assert not hops, hops
    else:
        assert sum(hops.values()) == 1 and all(
            reason == "non-ASCII" for _, reason in hops), hops


def test_all_null_and_empty_columns():
    for vals in ([None, None, None], ["", "", ""], [None, ""]):
        for name in ("trim", "concat", "replace", "lpad"):
            got, _ = _port_rows(name, vals)
            assert got == _reference_rows(name, vals), (name, vals)


def test_initcap_at_exact_byte_capacity():
    """16 bytes == the byte buffer's capacity: the padding rows' offsets
    equal the byte count and must not mark the last byte a word start."""
    vals = ["abcdefgh", "ijklmnop"]
    got, _ = _port_rows("initcap", vals)
    assert got == ["Abcdefgh", "Ijklmnop"] == _reference_rows("initcap", vals)


def test_greedy_replace_of_a_self_overlapping_pattern():
    vals = ["aaaa", "aaa", "aaaaa", "baab", "aaaaaaaaa"]
    got, _ = _port_rows("replace_overlap", vals)
    assert got == ["bb", "ba", "bba", "bbb", "bbbba"]
    assert got == _reference_rows("replace_overlap", vals)


def test_host_row_ops_and_non_literal_arguments_count_their_hop():
    """format_number and conv are host row ops; a column pattern for
    startswith goes through the host too. Each counts one batch."""
    vals = ["ff", "10", None, "-7", "zz"]
    _, _, pbatch, pref = _batches(vals)
    ctx = EvalContext(counters=collections.Counter())
    conv = PS.Conv(pref, PB.Literal(16), PB.Literal(10))
    assert conv.eval_device(pbatch, ctx).to_pylist() == [
        "255", "16", None, "18446744073709551609", "0"]
    sw = PS.StartsWith(pref, pref)
    assert sw.eval_device(pbatch, ctx).to_pylist() == [
        True, True, None, True, True]
    assert PS.host_path_counts(ctx.counters) == {
        ("Conv", "host row op"): 1,
        ("StartsWith", "non-literal argument"): 1}


# ---------------------------------------------------------------------------
# the kernels, each against its reference twin
# ---------------------------------------------------------------------------


def _kernel_inputs(vals):
    arr = pa.array(vals, pa.string())
    rcol = TpuColumnVector.from_arrow(arr)
    pcol = TorchColumnVector.from_numpy(StringT, np.array(vals, dtype=object))
    return rcol, pcol


KERNEL_PATTERNS = ["a", "aa", "ab", "l_o", ",", "aba"]


@pytest.mark.parametrize("pat", KERNEL_PATTERNS)
def test_match_kernels_match_the_reference(pat):
    vals = CORPORA["mixed"] + ["abababa", "aaaa", "xaba"]
    rcol, pcol = _kernel_inputs(vals)
    pb = np.frombuffer(pat.encode(), np.uint8)
    wild = np.array([c == "_" for c in pat])
    n_bytes = int(pcol.offsets[-1])
    want = np.asarray(RK.match_windows(rcol.data, rcol.offsets, pb, wild))
    got = PK.match_windows(pcol.data, pcol.offsets, pb, wild).numpy()
    assert (got[:n_bytes] == want[:n_bytes]).all()
    want = np.asarray(RK.greedy_matches(rcol.data, rcol.offsets, pb))
    got = PK.greedy_matches(pcol.data, pcol.offsets, pb).numpy()
    assert (got[:n_bytes] == want[:n_bytes]).all()
    n = len(vals)
    for nth in (1, 2, -1, -2):
        want = np.asarray(RK.nth_match(rcol.data, rcol.offsets, pb, nth))
        got = PK.nth_match(pcol.data, pcol.offsets, pb, nth).numpy()
        assert (got[:n] == want[:n]).all(), nth
    want = np.asarray(RK.first_match(rcol.data, rcol.offsets, pb))
    got = PK.first_match(pcol.data, pcol.offsets, pb).numpy()
    assert (got[:n] == want[:n]).all()


@pytest.mark.parametrize("left", [True, False])
def test_build_kernels_match_the_reference(left):
    vals = CORPORA["ascii"]
    rcol, pcol = _kernel_inputs(vals)
    n = len(vals)
    rs, rl = RK.starts_lengths(rcol.offsets)
    ps, pl = PK.starts_lengths(pcol.offsets)

    def same(r, p):
        ro, po = np.asarray(r[1]), p[1].numpy()
        assert (ro[:n + 1] == po[:n + 1]).all()
        end = int(po[n])
        assert (np.asarray(r[0])[:end] == p[0].numpy()[:end]).all()

    cap = 8192
    active_r = np.arange(rcol.offsets.shape[0] - 1) < n
    same(RK.build_pad(rcol.data, rs, rl, 9, np.frombuffer(b"*#", np.uint8),
                      left, cap, active=active_r),
         PK.build_pad(pcol.data, ps, pl, 9, np.frombuffer(b"*#", np.uint8),
                      left, cap, active=torch.arange(pcol.capacity) < n))
    same(RK.build_repeat(rcol.data, rs, rl, 2, cap),
         PK.build_repeat(pcol.data, ps, pl, 2, cap))
    same(RK.build_ranges(rcol.data, rs + 1, rl - 2, cap),
         PK.build_ranges(pcol.data, ps + 1, pl - 2, cap))
