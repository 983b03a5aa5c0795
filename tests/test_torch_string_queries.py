"""String and regex queries through the port's session on the CPU (test
mode: every operator on the device path) held to the reference's CPU
session, exactly:

* the query sets of ``tests/test_strings.py`` and the string tests of
  ``tests/test_strings2.py`` (``concat_ws``, ``substring_index``,
  ``octet_length``/``bit_length``, ``format_number``, ``conv``), over
  their inputs (``data_gen``'s seeded string columns);
* ``chip_smoke.py`` phase 13's ten queries at 12,000 rows (its lineitem,
  customer and text tables: ASCII and non-ASCII rows, nulls with bytes
  under them, empty strings; string ``CASE WHEN``, string ``min``/``max``
  by groups, ``lag`` of a string with a default and a running ``max`` of a
  string over a window).

One reference run a query; rows compare after sorting."""

import functools

import pyarrow as pa
import pytest

from data_gen import DoubleGen, IntegerGen, LongGen, StringGen, gen_df

import chip_smoke
import spark_rapids_tpu.functions as RF
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.window import Window as RWindow
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu_torch.datagen import tpch_frames
from spark_rapids_tpu_torch.memory.device import TorchDeviceManager
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.window import Window as PWindow

TorchDeviceManager.initialize(device="cpu", total_bytes=8 << 30)

TEST_MODE = {"spark.rapids.sql.test.enabled": "true"}


def _s(n=200, seed=80, alphabet="abc XY%_z", max_len=12):
    return gen_df([("s", StringGen(alphabet=alphabet, max_len=max_len))],
                  n, seed)


def _s2(n=60, seed=31):
    return gen_df(
        [("a", StringGen(nullable=True)), ("b", StringGen(nullable=True)),
         ("x", IntegerGen()), ("y", LongGen()), ("d", DoubleGen())], n, seed)


def _c(F, name):
    return F.col(name)


#: name → (input table, query over (functions, DataFrame))
QUERIES = {
    "trim_family": (lambda: _s(alphabet=" ab "), lambda F, df: df.select(
        F.trim(_c(F, "s")).alias("t"), F.ltrim(_c(F, "s")).alias("lt"),
        F.rtrim(_c(F, "s")).alias("rt"))),
    "pad_repeat_reverse": (_s, lambda F, df: df.select(
        F.lpad(_c(F, "s"), 8, "*").alias("lp"),
        F.rpad(_c(F, "s"), 8, "#").alias("rp"),
        F.repeat(_c(F, "s"), 2).alias("rep"),
        F.reverse(_c(F, "s")).alias("rev"),
        F.initcap(_c(F, "s")).alias("ic"))),
    "replace_translate_locate": (_s, lambda F, df: df.select(
        F.replace(_c(F, "s"), "ab", "Q").alias("rep"),
        F.translate(_c(F, "s"), "abX", "xy").alias("tr"),
        F.locate("b", _c(F, "s")).alias("loc"),
        F.instr(_c(F, "s"), "ab").alias("ins"))),
    "like": (_s, lambda F, df: df.select(
        F.like(_c(F, "s"), "a%").alias("l1"),
        F.like(_c(F, "s"), "%b").alias("l2"),
        F.like(_c(F, "s"), "_b%").alias("l3"))),
    "rlike_rewrites_and_regex": (_s, lambda F, df: df.select(
        F.rlike(_c(F, "s"), "^ab").alias("pre"),
        F.rlike(_c(F, "s"), "bc$").alias("suf"),
        F.rlike(_c(F, "s"), "ab").alias("ct"),
        F.rlike(_c(F, "s"), "^a.*c$").alias("full"),
        F.rlike(_c(F, "s"), "[abc]{2}").alias("cls"))),
    "regexp_replace_extract": (_s, lambda F, df: df.select(
        F.regexp_replace(_c(F, "s"), "a+", "<A>").alias("rr"),
        F.regexp_extract(_c(F, "s"), "(a+)(b*)", 1).alias("g1"),
        F.regexp_extract(_c(F, "s"), "(a+)(b*)", 2).alias("g2"))),
    "column_predicates": (_s, lambda F, df: df.select(
        _c(F, "s").startswith("a").alias("sw"),
        _c(F, "s").endswith("z").alias("ew"),
        _c(F, "s").contains("b").alias("ct"),
        _c(F, "s").rlike("[XY]+").alias("rl"),
        F.length(_c(F, "s")).alias("n"), F.upper(_c(F, "s")).alias("u"),
        F.lower(_c(F, "s")).alias("lo"), F.ascii(_c(F, "s")).alias("a"))),
    "concat_ws": (_s2, lambda F, df: df.select(
        F.concat_ws("-", F.col("a"), F.col("b")).alias("c1"),
        F.concat_ws("", F.col("a"), F.col("a")).alias("c2"))),
    "substring_index": (lambda: pa.table({"v": pa.array(
        ["www.apache.org", "a.b", "nodot", None])}), lambda F, df: df.select(
        F.substring_index(F.col("v"), ".", 2).alias("p"),
        F.substring_index(F.col("v"), ".", -1).alias("m"))),
    "octet_bit_length": (lambda: pa.table({"v": pa.array(
        ["abc", "", "héllo", None])}), lambda F, df: df.select(
        F.octet_length(F.col("v")).alias("o"),
        F.bit_length(F.col("v")).alias("b"))),
    "format_number": (lambda: pa.table({"v": pa.array(
        [1234567.891, 0.5, -0.5, None, 2.5])}), lambda F, df: df.select(
        F.format_number(F.col("v"), 2).alias("f"),
        F.format_number(F.col("v"), 0).alias("f0"))),
    "conv": (lambda: pa.table({"v": pa.array(
        ["100", "ff", "-10", "zz9", "", None])}), lambda F, df: df.select(
        F.conv(F.col("v"), 16, 10).alias("h2d"),
        F.conv(F.col("v"), 10, 2).alias("d2b"),
        F.conv(F.col("v"), 10, -16).alias("d2hs"))),
    "hash_strings": (lambda: _s(max_len=40), lambda F, df: df.select(
        F.hash(_c(F, "s")).alias("h"),
        F.hash(F.upper(_c(F, "s"))).alias("hu"),
        F.hash(F.reverse(_c(F, "s"))).alias("hr"))),
    "hash_rows": (_s2, lambda F, df: df.select(
        F.hash(F.col("a")).alias("ha"), F.hash(F.col("x")).alias("hx"),
        F.hash(F.col("y")).alias("hy"), F.hash(F.col("d")).alias("hd"),
        F.hash(F.col("a"), F.col("b"), F.col("x"), F.col("y"),
               F.col("d")).alias("h"))),
    "sum_of_hashes_by_group": (_s2, lambda F, df: df.groupBy(
        F.length(F.col("a")).alias("k")).agg(
        F.sum(F.hash(F.col("b"))).alias("s"), F.count("*").alias("n"))),
}


def _canon(rows):
    return sorted((tuple(r.values()) for r in rows), key=repr)


@functools.lru_cache(maxsize=None)
def _reference(name):
    make, query = QUERIES[name]
    s = TpuSession({"spark.rapids.sql.enabled": "false"})
    return _canon(query(RF, s.createDataFrame(make())).collect())


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_query_matches_the_reference(name):
    make, query = QUERIES[name]
    s = TorchSession(TEST_MODE, device="cpu")
    assert _canon(query(PF, s.createDataFrame(make())).collect()) \
        == _reference(name)


def test_substring_index_and_conv_values():
    s = TorchSession(TEST_MODE, device="cpu")
    make, query = QUERIES["substring_index"]
    rows = query(PF, s.createDataFrame(make())).collect()
    assert (rows[0]["p"], rows[0]["m"]) == ("www.apache", "org")
    make, query = QUERIES["conv"]
    rows = query(PF, s.createDataFrame(make())).collect()
    assert (rows[0]["h2d"], rows[1]["h2d"], rows[2]["d2hs"]) == \
        ("256", "255", "-A")


def test_rejected_regex_stays_off_the_card_with_its_reason():
    """A possessive quantifier is not transpiled: the projection is
    tagged off the card (and, with no host engine, the query fails)."""
    s = TorchSession({}, device="cpu")
    df = s.createDataFrame(_s()).select(PF.rlike(PF.col("s"), "a*+b")
                                        .alias("x"))
    reasons = df.explain_fallback()
    assert "RLike" in reasons and "disabled on TPU" in reasons


# ---------------------------------------------------------------------------
# phase 13's queries at 12,000 rows
# ---------------------------------------------------------------------------

ROWS = chip_smoke.STR_SMALL


@functools.lru_cache(maxsize=None)
def _host():
    return chip_smoke.strings_host_tables(ROWS)


@functools.lru_cache(maxsize=None)
def _reference_phase13():
    s = TpuSession({"spark.rapids.sql.enabled": "false"})
    t = {name: s.createDataFrame(chip_smoke.arrow_table(cols, valid),
                                 num_partitions=parts)
         for name, (cols, valid, parts) in _host().items()}
    return {name: chip_smoke.sorted_rows(q.collect(), keys)
            for name, (q, keys) in chip_smoke.strings_queries(
                RF, RWindow, t).items()}


@functools.lru_cache(maxsize=None)
def _port_phase13():
    s = TorchSession({}, device="cpu")
    t = tpch_frames(s, _host())
    return {name: chip_smoke.sorted_rows(q.collect(), keys)
            for name, (q, keys) in chip_smoke.strings_queries(
                PF, PWindow, t).items()}


@pytest.mark.parametrize("name", sorted(chip_smoke.STR_EXPECTED_HOPS)
                         + ["d_non_ascii"])
def test_phase13_query_matches_the_reference(name):
    got, want = _port_phase13()[name], _reference_phase13()[name]
    assert got, name
    assert got == want, chip_smoke._first_difference(got, want)
