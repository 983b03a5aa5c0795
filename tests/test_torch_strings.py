"""String group and sort keys of any length, and SQL LIKE, held against
the JAX reference.

The port's key codes (``expressions/strings.string_key_codes``) order
strings by their UTF-8 bytes and are equal exactly for equal strings, at
any length: the reference dictionary-encodes on the host instead, in
first-appearance order. So grouped results without an ORDER BY compare as
sets, sorted ones in order. The strings hold 0–40 bytes with shared
prefixes, embedded NULs, non-ASCII characters and nulls. LIKE is held
against the reference's ``Like.eval_tpu`` over ASCII and non-ASCII rows,
nulls, empty strings and escapes."""

import functools

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu.functions as RF
import spark_rapids_tpu_torch.functions as TF
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.memory.device import TorchDeviceManager

# the CPU has no device memory to read: the tests state one for the
# budget (spark.rapids.memory.device.totalBytes)
TorchDeviceManager.initialize(device="cpu", total_bytes=8 << 30)

GENERAL = {"spark.rapids.tpu.agg.compiledStage.enabled": "false"}
#: the out-of-core paths: four runs, each its own longest string
OUT_OF_CORE = dict(GENERAL, **{"spark.rapids.sql.batchSizeRows": "100"})

STEMS = ["", "a", "b", "customer#000000", "customer#0000001",
         "customer#00000012", "Customer#000000", "x\x00", "x\x00y", "x",
         "日本語", "日本", "é" * 20, "z" * 40, "4-NOT SPECIFIED", "1-URGENT"]


@functools.lru_cache(maxsize=None)
def _table(n: int = 400) -> pa.Table:
    """s: a stem plus 0–2 digits (so prefixes repeat); t: a second string
    key; x, v: values. The first rows run short, the last long, so the
    out-of-core sort's runs differ in their longest string."""
    rng = np.random.default_rng(23)
    stems = np.array(STEMS, dtype=object)
    s = [stems[i] + "".join(map(str, rng.integers(0, 10, k)))
         for i, k in zip(rng.integers(0, len(STEMS), n),
                         rng.integers(0, 3, n))]
    s[:100] = [w[:3] for w in s[:100]]
    return pa.table({
        "s": pa.array(s, mask=rng.random(n) < 0.1),
        "t": pa.array(rng.choice(["", "PROMO BRUSHED", "PROMO"], n)),
        "x": rng.integers(-5, 5, n),
        "v": rng.uniform(0, 1, n)})


def _groups(F, df, keys):
    return df.groupBy(*keys).agg(F.count("*").alias("n"),
                                 F.sum(F.col("x")).alias("sx"),
                                 F.max(F.col("v")).alias("mv"))


def _as_set(rows):
    return sorted(((r["s"] is None, r["s"] or "", r.get("t") or "", r["n"],
                    r["sx"], r["mv"]) for r in rows))


@functools.lru_cache(maxsize=None)
def _reference(kind: str, arg):
    """The reference's groups (as a set: which of its paths computes them
    does not change them, so its compiled aggregation stage does, the one
    that compiles fastest on the CPU) or its sorted rows."""
    t = _table()
    if kind == "groups":
        return _as_set(_groups(RF, TpuSession().createDataFrame(
            t, num_partitions=4), arg).collect())
    return TpuSession().createDataFrame(t).orderBy(
        *_ORDERS[arg](RF)).collect()


GROUP_CASES = {"compiled": ({}, ("s",)), "general": (GENERAL, ("s",)),
               "general-two-keys": (GENERAL, ("t", "s")),
               "out-of-core": (OUT_OF_CORE, ("s",))}


@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_string_group_keys_match_reference_as_sets(case):
    """Groups by strings longer than 7 bytes: the compiled aggregation
    stage's dictionary, the general aggregate, and its out-of-core sort
    over runs of different widths."""
    conf, keys = GROUP_CASES[case]
    s = TorchSession(dict(conf), device="cpu")
    got = _as_set(_groups(TF, s.createDataFrame(_table(), num_partitions=4),
                          keys).collect())
    assert got == _reference("groups", keys)
    if case == "out-of-core":
        assert s.counters["sort_fallback_runs"] == 1


_ORDERS = {
    "asc": lambda F: ("s", "x", "v"),
    "desc-nulls-first": lambda F: (F.col("s").desc_nulls_first(), "x", "v"),
}


@pytest.mark.parametrize("name", sorted(_ORDERS))
@pytest.mark.parametrize("conf", [{}, OUT_OF_CORE],
                         ids=["in-core", "out-of-core"])
def test_string_sort_matches_reference_in_order(name, conf):
    got = TorchSession(conf, device="cpu").createDataFrame(
        _table(), num_partitions=4).orderBy(*_ORDERS[name](TF)).collect()
    assert got == _reference("sort", name)


def test_string_key_codes_are_byte_order_across_columns():
    """Two columns coded together: every pair of rows compares as its
    UTF-8 bytes do, within a column and across the two."""
    from spark_rapids_tpu_torch.columnar.batch import TorchColumnarBatch
    from spark_rapids_tpu_torch.expressions.strings import string_key_codes
    words = [w for w in _table().column("s").to_pylist() if w is not None]
    a, b = words[:150], words[150:]
    cols = TorchColumnarBatch.from_arrow(pa.table({"a": a})).columns + \
        TorchColumnarBatch.from_arrow(pa.table({"b": b})).columns
    codes = [c[:len(w)].tolist() for c, w in zip(string_key_codes(cols),
                                                  (a, b))]
    pairs = list(zip(a + b, codes[0] + codes[1]))
    raw = [(w.encode(), c) for w, c in pairs]
    for x, cx in raw:
        for y, cy in raw[::7]:
            assert (x < y) == (cx < cy) and (x == y) == (cx == cy)


# ---------------------------------------------------------------------------
# LIKE
# ---------------------------------------------------------------------------

ASCII_ROWS = ["4-NOT SPECIFIED", "1-URGENT", "PROMO BRUSHED BRASS",
              "PROMO", "LARGE BRASS", "", None, "%", "a%b", "a\\b", "x_y",
              "NOT", "NO", "5-LOW", "-", "1-", "PROMO%", "brass", "_-x"]
NON_ASCII_ROWS = ["é-NOT é", "日本語 BRASS", "PROMO 日本", "1-é", None, "",
                  "%é", "NOTé"]
PATTERNS = ["%NOT%", "PROMO%", "%BRASS", "_-%", "\\%%", "%\\%", "", "%",
            "%%", "a\\\\b", "x\\_y", "N_T", "%O%O%", "_", "%_", "\\"]


def _like(mod: str, rows, pattern):
    if mod == "ref":
        from spark_rapids_tpu.columnar.batch import TpuColumnarBatch as B
        from spark_rapids_tpu.expressions.base import AttributeReference
        from spark_rapids_tpu.expressions.regex import Like
        from spark_rapids_tpu.types import StringT
        batch = B.from_arrow(pa.table({"s": pa.array(rows, pa.string())}))
        out = Like(AttributeReference("s", StringT, ordinal=0),
                   pattern).eval_tpu(batch)
        return out.to_arrow().to_pylist()[:len(rows)]
    from spark_rapids_tpu_torch.columnar.batch import TorchColumnarBatch as B
    from spark_rapids_tpu_torch.expressions.base import AttributeReference
    from spark_rapids_tpu_torch.expressions.strings import Like
    from spark_rapids_tpu_torch.types import StringT
    batch = B.from_arrow(pa.table({"s": pa.array(rows, pa.string())})) \
        .to_device("cpu")
    out = Like(AttributeReference("s", StringT, ordinal=0),
               pattern).eval_device(batch)
    return out.to_pylist()


@pytest.mark.parametrize("pattern", PATTERNS)
def test_like_matches_reference_on_ascii(pattern):
    assert _like("port", ASCII_ROWS, pattern) == \
        _like("ref", ASCII_ROWS, pattern)


@pytest.mark.parametrize("pattern", [p for p in PATTERNS if "_" not in p]
                         + ["%é%", "日本%"])
def test_like_matches_reference_on_non_ascii(pattern):
    """Without ``_`` a pattern matches UTF-8 bytes exactly: the reference's
    answer (it matches by character on the host)."""
    assert _like("port", NON_ASCII_ROWS, pattern) == \
        _like("ref", NON_ASCII_ROWS, pattern)


def test_like_underscore_over_non_ascii_is_not_yet_ported():
    """``_`` is one character: over non-ASCII bytes the port matches by
    character on the host, as the reference does, and gives its answer
    (this case raised before the host path was ported)."""
    for pattern in ("_-%", "%é_", "日_語%", "_"):
        assert _like("port", NON_ASCII_ROWS, pattern) == \
            _like("ref", NON_ASCII_ROWS, pattern)


def test_like_through_the_session_keeps_the_filter_on_the_device():
    """``Column.like`` and ``functions.like`` plan a device filter, and
    ``~`` negates it with Spark's nulls."""
    df = TorchSession(device="cpu").createDataFrame(
        pa.table({"s": pa.array(ASCII_ROWS, pa.string())}))
    q = df.filter(~TF.col("s").like("%NOT%"))
    assert "TorchFilter[NOT s LIKE '%NOT%']" in q.explain()
    want = [r for r in ASCII_ROWS if r is not None and "NOT" not in r]
    assert [r["s"] for r in q.collect()] == want
    assert [r["s"] for r in df.filter(TF.like("s", "PROMO%")).collect()] \
        == ["PROMO BRUSHED BRASS", "PROMO", "PROMO%"]
