"""xxhash64, hive_hash and md5, and the partition, row-id, rand and
input-file expressions of the port held to the reference and to Spark's
algorithms on the CPU, with the names of the slice in ``functions``.

Hashes are exact: the port's device path (CPU tensors) and host path
equal each other, a numpy oracle of Spark's algorithm (XXH64 from the
reference's numpy functions, Hive's fold written out here) and the
reference's device path. Every path of the port hashes -0.0 as 0.0 and a
NaN of any payload as Java's canonical NaN; the reference's host paths
view the raw bits, its host xxhash64 of a boolean raises and its hive
hash has no timestamp (ROADMAP C-ref-32, C-ref-33), which the tests
record. ``rand(42)`` is bit-identical to the
reference's threefry values, and the same at two batch sizes.
"""

import collections
import functools
import hashlib

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import spark_rapids_tpu.functions as RF
import spark_rapids_tpu_torch.functions as TF
from spark_rapids_tpu import types as RT
from spark_rapids_tpu.columnar.batch import TpuColumnarBatch
from spark_rapids_tpu.columnar.vector import TpuColumnVector
from spark_rapids_tpu.expressions import base as RB
from spark_rapids_tpu.expressions import hashexprs as RH
from spark_rapids_tpu.expressions import misc as RMISC
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar.batch import TorchColumnarBatch
from spark_rapids_tpu_torch.expressions import base as PB
from spark_rapids_tpu_torch.expressions import hashexprs as PH
from spark_rapids_tpu_torch.expressions import misc as PMISC
from spark_rapids_tpu_torch.expressions import strings as PS
from spark_rapids_tpu_torch.memory.device import TorchDeviceManager
from spark_rapids_tpu_torch.session import TorchSession

TorchDeviceManager.initialize(device="cpu", total_bytes=8 << 30)

N = 120
M64 = (1 << 64) - 1
NAN_PAYLOAD64 = np.array([0x7FF8000000000001, -0x0008000000000000],
                         np.int64).view(np.float64)  # a payload, a -NaN
NAN_PAYLOAD32 = np.array([0x7FC00001, -0x00400000], np.int32) \
    .view(np.float32)


@functools.lru_cache(maxsize=None)
def table() -> pa.Table:
    """Seeded rows of every hashed type: NaNs of other payloads, ±0.0,
    the integers' ends, dates before 1970, timestamps with negative
    micros, strings of 0-80 bytes (some non-ASCII); nulls in each."""
    rng = np.random.default_rng(14)
    x = rng.normal(0, 1e3, N)
    x[:6] = [np.nan, NAN_PAYLOAD64[0], NAN_PAYLOAD64[1], -0.0, 0.0,
             np.inf]
    f = x.astype(np.float32)
    f[:3] = [np.float32("nan"), NAN_PAYLOAD32[0], NAN_PAYLOAD32[1]]
    i = rng.integers(-2 ** 62, 2 ** 62, N)
    i[:4] = [-2 ** 63, 2 ** 63 - 1, 0, -1]
    j = rng.integers(-2 ** 31, 2 ** 31, N).astype(np.int32)
    j[:3] = [-2 ** 31, -1, 0]
    ts = rng.integers(-2 ** 50, 2 ** 50, N)
    ts[:3] = [-1, -1_500_001, 1_000_001]
    words = ["", "a", "hello world", "日本語テキスト", "ß" * 20,
             "x" * 31, "y" * 32, "z" * 33, "q" * 40, "w" * 80]
    s = [words[k % len(words)] + str(k) * (k % 7) for k in range(N)]

    def nulls(k):
        m = np.random.default_rng(300 + k).random(N) < 0.1
        m[:6] = False
        return m

    return pa.table({
        "b": pa.array(rng.random(N) < 0.5, mask=nulls(1)),
        "t8": pa.array(j.astype(np.int8), pa.int8(), mask=nulls(2)),
        "t16": pa.array(j.astype(np.int16), pa.int16(), mask=nulls(3)),
        "j": pa.array(j, pa.int32(), mask=nulls(4)),
        "i": pa.array(i, pa.int64(), mask=nulls(5)),
        "f": pa.array(f, pa.float32(), mask=nulls(6)),
        "x": pa.array(x, pa.float64(), mask=nulls(7)),
        "d": pa.array(rng.integers(-30000, 30000, N).astype(np.int32),
                      pa.int32(), mask=nulls(8)).cast(pa.date32()),
        "ts": pa.array(ts, pa.int64(), mask=nulls(9)).cast(
            pa.timestamp("us", tz="UTC")),
        "s": pa.array(s, pa.string(), mask=nulls(10)),
    })


def _attrs(ns_base, types_mod, tbl):
    return [ns_base.AttributeReference(f.name, types_mod.from_arrow(f.type),
                                       True, ordinal=i)
            for i, f in enumerate(tbl.schema)]


def _cols(names):
    idx = {n: i for i, n in enumerate(table().column_names)}
    return [idx[n] for n in names]


def port_rows(cls, names, counters=None):
    tbl = table()
    a = _attrs(PB, PT, tbl)
    expr = cls(*[a[i] for i in _cols(names)])
    ctx = PB.EvalContext(counters=counters if counters is not None
                         else collections.Counter())
    b = TorchColumnarBatch.from_arrow(tbl)
    dev = PB.to_column(expr.eval_device(b, ctx), b, expr.dtype).to_pylist()
    host = expr.eval_cpu(tbl, PB.EvalContext())
    return dev, host.to_pylist()


def reference_rows(cls, names):
    """(eval_tpu rows, eval_cpu rows or its exception)."""
    tbl = table()
    a = _attrs(RB, RT, tbl)
    expr = cls(*[a[i] for i in _cols(names)])
    b = TpuColumnarBatch([TpuColumnVector.from_arrow(c.combine_chunks())
                          for c in tbl.columns], N, names=tbl.column_names)
    try:
        dev = expr.eval_tpu(b, RB.EvalContext()).to_arrow().to_pylist()[:N]
    except Exception as e:  # noqa: BLE001 — recorded
        dev = e
    try:
        host = expr.eval_cpu(tbl, RB.EvalContext()).to_pylist()
    except Exception as e:  # noqa: BLE001 — recorded
        host = e
    return dev, host


# ---------------------------------------------------------------------------
# Spark's algorithms as oracles
# ---------------------------------------------------------------------------

def _canon64(v: float) -> int:
    """Java's doubleToLongBits of a value hashed by Spark (-0.0 as 0.0)."""
    if v != v:
        return 0x7FF8000000000000
    return int(np.array([0.0 if v == 0 else v]).view(np.int64)[0])


def _canon32(v: float) -> int:
    if v != v:
        return 0x7FC00000
    return int(np.array([0.0 if v == 0 else v], np.float32)
               .view(np.int32)[0])


def _raw_values(name):
    """The column's values as Spark hashes them (ints for dates and
    timestamps, raw float bits kept for the canonicalization)."""
    col = table().column(name).combine_chunks()
    if pa.types.is_date32(col.type):
        col = col.cast(pa.int32())
    elif pa.types.is_timestamp(col.type):
        col = col.cast(pa.int64())
    vals = col.to_pylist()
    if pa.types.is_floating(col.type):
        raw = np.asarray(col.fill_null(0).to_numpy(zero_copy_only=False))
        vals = [None if v is None else r for v, r in zip(vals, raw)]
    return col.type, vals


def spark_xxhash64(names):
    """Spark's XxHash64 (seed 42), column after column."""
    out = []
    cols = [_raw_values(n) for n in names]
    with np.errstate(over="ignore"):
        for r in range(N):
            h = np.uint64(42)
            for t, vals in cols:
                v = vals[r]
                if v is None:
                    continue
                if pa.types.is_string(t):
                    h = np.uint64(RH.np_xxhash64_bytes(v.encode(), h))
                elif pa.types.is_float64(t):
                    h = RH.np_xxhash64_long(np.int64(_canon64(v)), h)
                elif pa.types.is_float32(t):
                    h = RH.np_xxhash64_int(np.int32(_canon32(v)), h)
                elif pa.types.is_int64(t):
                    h = RH.np_xxhash64_long(np.int64(v), h)
                else:
                    h = RH.np_xxhash64_int(np.int32(int(v)), h)
            out.append(int(np.uint64(h).astype(np.int64)))
    return out


def _hive_field(t, v) -> int:
    m32 = 0xFFFFFFFF
    if v is None:
        return 0
    if pa.types.is_boolean(t):
        return 1 if v else 0
    if pa.types.is_string(t):
        h = 0
        for byte in v.encode():
            h = (31 * h + (byte - 256 if byte > 127 else byte)) & m32
        return h

    def fold(x):
        x &= M64
        return ((x >> 32) ^ x) & m32
    if pa.types.is_float64(t):
        return fold(_canon64(v))
    if pa.types.is_float32(t):
        return _canon32(v) & m32
    if pa.types.is_int64(t) and not getattr(t, "is_ts", False):
        return fold(v)
    return int(v) & m32


def _hive_timestamp(v) -> int:
    """Spark's HiveHasher.hashTimestamp: seconds << 30 | nanos."""
    secs = abs(v) // 1_000_000 * (1 if v >= 0 else -1)
    nanos = (abs(v) % 1_000_000 * (1 if v >= 0 else -1)) * 1000
    x = ((secs << 30) & M64) | (nanos & M64)
    return ((x >> 32) ^ x) & 0xFFFFFFFF


def spark_hive_hash(names):
    out = []
    cols = [(n, *_raw_values(n)) for n in names]
    for r in range(N):
        h = 0
        for n, t, vals in cols:
            v = vals[r]
            f = _hive_timestamp(v) if (n == "ts" and v is not None) \
                else _hive_field(t, v)
            h = (31 * h + f) & 0xFFFFFFFF
        out.append(h - (1 << 32) if h >= 1 << 31 else h)
    return out


HASH_CASES = {"bool": ["b"], "byte": ["t8"], "short": ["t16"], "int": ["j"],
              "long": ["i"], "float": ["f"], "double": ["x"], "date": ["d"],
              "timestamp": ["ts"], "string": ["s"],
              "row": ["i", "x", "s", "d", "ts"],
              "all": ["b", "t8", "t16", "j", "i", "f", "x", "d", "ts", "s"]}
#: cases whose reference host path departs from Spark: it views a NaN's
#: raw bits (C-ref-32); the row named is the first NaN of another payload
RAW_NAN_ROWS = {"float": 1, "double": 1, "row": 1, "all": 1}


@pytest.mark.parametrize("case", sorted(HASH_CASES))
def test_xxhash64_matches_spark_and_the_reference(case):
    names = HASH_CASES[case]
    dev, host = port_rows(PH.XxHash64, names)
    want = spark_xxhash64(names)
    assert dev == host == want
    ref_dev, ref_host = reference_rows(RH.XxHash64, names)
    assert ref_dev == want
    if "b" in names:  # the reference's host fills a boolean's nulls with 0
        assert isinstance(ref_host, pa.ArrowInvalid)
    elif case in RAW_NAN_ROWS:
        row = RAW_NAN_ROWS[case]
        assert ref_host[row] != want[row]
        assert [v for k, v in enumerate(ref_host) if k not in (1, 2)] == \
            [v for k, v in enumerate(want) if k not in (1, 2)]
    else:
        assert ref_host == want


@pytest.mark.parametrize("case", sorted(HASH_CASES))
def test_hive_hash_matches_spark_and_the_reference(case):
    names = HASH_CASES[case]
    dev, host = port_rows(PH.HiveHash, names)
    want = spark_hive_hash(names)
    assert dev == host == want
    ref_dev, ref_host = reference_rows(RH.HiveHash, names)
    if "ts" in names:  # the reference has no timestamp hive hash
        assert isinstance(ref_host, Exception)
        return
    assert ref_dev == want
    if case in RAW_NAN_ROWS:
        row = RAW_NAN_ROWS[case]
        assert ref_host[row] != want[row]
    else:
        assert ref_host == want


def test_md5_matches_hashlib_through_the_counted_hop():
    counters = collections.Counter()
    dev, host = port_rows(PH.Md5, ["s"], counters)
    want = [None if v is None else hashlib.md5(v.encode()).hexdigest()
            for v in table().column("s").to_pylist()]
    assert dev == host == want
    assert PS.host_path_counts(counters) == {("Md5", "md5"): 1}
    ref_dev, ref_host = reference_rows(RH.Md5, ["s"])
    assert ref_dev == ref_host == want


# ---------------------------------------------------------------------------
# partition id, row ids, rand, input files
# ---------------------------------------------------------------------------

BASE = {"spark.rapids.shuffle.mode": "ICI",
        "spark.sql.shuffle.partitions": "4"}


@functools.lru_cache(maxsize=None)
def _sessions():
    ref = TpuSession(dict(BASE, **{"spark.rapids.sql.enabled": "false"}))
    port = TorchSession(dict(BASE, **{"spark.rapids.sql.test.enabled":
                                      "true"}), device="cpu")
    host = TorchSession(dict(BASE, **{"spark.rapids.sql.enabled": "false"}),
                        device="cpu")
    return ref, port, host


def test_partition_and_row_ids_over_four_partitions():
    """spark_partition_id and monotonically_increasing_id over range's
    four partitions equal the reference's, on the card's path and in the
    host engine; rand(42) is the reference's, bit for bit."""
    ref, port, host = _sessions()

    def q(F, s):
        return s.range(0, 1000, 1, numPartitions=4).select(
            "id", F.spark_partition_id().alias("p"),
            F.monotonically_increasing_id().alias("m"),
            F.rand(42).alias("r")).collect()

    want = q(RF, ref)
    got = q(TF, port)
    assert got == want
    assert q(TF, host) == want
    parts = collections.Counter(r["p"] for r in got)
    assert sorted(parts) == [0, 1, 2, 3]
    for r in got[:3]:
        assert r["m"] == (r["p"] << 33) + r["id"] - min(
            x["id"] for x in got if x["p"] == r["p"])


def test_rand_is_the_reference_and_independent_of_batch_size():
    """rand(42): the reference's threefry bits, the same whether a
    partition comes in one batch or in batches of 7 rows."""
    tbl = pa.table({"a": pa.array(range(40))})
    ref = RMISC.Rand(RB.Literal(42)).eval_cpu(tbl, RB.EvalContext(
        partition_id=0)).to_pylist()
    assert ref[:4] == [0.4128849788884772, 0.6587797605336443,
                       0.3372600880383978, 0.15742001264744365]
    expr = PMISC.Rand(PB.Literal(42))
    one = PB.to_column(expr.eval_device(TorchColumnarBatch.from_arrow(tbl),
                                        PB.EvalContext()),
                       TorchColumnarBatch.from_arrow(tbl)).to_pylist()
    ctx = PB.EvalContext()
    pieces = []
    for start in range(0, 40, 7):
        b = TorchColumnarBatch.from_arrow(tbl.slice(start, 7))
        pieces += PB.to_column(expr.eval_device(b, ctx), b).to_pylist()
    assert one == pieces == ref
    for p in (1, 3):
        want = RMISC.Rand(RB.Literal(-5)).eval_cpu(
            tbl, RB.EvalContext(partition_id=p)).to_pylist()
        got = PMISC.Rand(PB.Literal(-5)).eval_cpu(
            tbl, PB.EvalContext(partition_id=p)).to_pylist()
        assert got == want


def test_input_file_expressions_in_and_outside_a_scan(tmp_path):
    """The file scans set the input file and its block (the device decode
    and the host read); outside a scan the values are '' and -1."""
    paths = []
    for k in range(2):
        p = tmp_path / f"part-{k}.parquet"
        pq.write_table(pa.table({"v": pa.array(range(k * 50, k * 50 + 50),
                                               pa.int64())}), p)
        paths.append(str(p))
    ref, port, host = _sessions()

    def q(F, s):
        rows = s.read.parquet(str(tmp_path)).select(
            "v", F.input_file_name().alias("f"),
            F.input_file_block_start().alias("st"),
            F.input_file_block_length().alias("ln")).collect()
        return sorted((r["v"], r["f"], r["st"], r["ln"]) for r in rows)

    want = q(RF, ref)
    assert {r[1] for r in want} == set(paths)
    assert q(TF, port) == want
    assert q(TF, host) == want
    for r in want:
        assert r[1] == paths[r[0] // 50] and r[2] == 0 \
            and r[3] == (tmp_path / f"part-{r[0] // 50}.parquet").stat() \
            .st_size
    outside = port.createDataFrame([{"a": 1}]).select(
        TF.input_file_name().alias("f"),
        TF.input_file_block_start().alias("st"),
        TF.input_file_block_length().alias("ln")).collect()
    assert outside == [{"f": "", "st": -1, "ln": -1}]


SLICE_NAMES = """sqrt cbrt exp expm1 log log10 log2 log1p pow sin cos tan
asin acos atan atan2 sinh cosh tanh asinh acosh atanh cot hypot degrees
radians rint signum ceil ceiling bround pmod negative bit_count bitwise_not
shiftleft shiftright shiftrightunsigned isnan nanvl greatest least xxhash64
hive_hash md5 year month dayofmonth quarter dayofweek weekday dayofyear
weekofyear hour minute second last_day date_add date_sub datediff add_months
date_format from_unixtime unix_timestamp to_unix_timestamp timestamp_seconds
timestamp_millis timestamp_micros spark_partition_id
monotonically_increasing_id rand input_file_name input_file_block_start
input_file_block_length""".split()


def test_functions_module_has_the_slice():
    """The 74 names of this slice, each a callable the reference's
    ``functions`` has too; ``Column`` has unary minus and ``%``."""
    assert len(SLICE_NAMES) == len(set(SLICE_NAMES)) == 74
    missing = [n for n in SLICE_NAMES if not callable(getattr(TF, n, None))]
    assert not missing, missing
    assert all(callable(getattr(RF, n, None)) for n in SLICE_NAMES)
    c = TF.col("a")
    assert type((-c)._expr).__name__ == "UnaryMinus"
    assert type((c % 3)._expr).__name__ == "Remainder"


def test_one_query_of_each_family_through_the_session():
    """Hashes, md5, negation and remainder through the session in test
    mode against the reference's host engine (NaN-free columns, where the
    reference's host paths agree with Spark)."""
    ref, port, _ = _sessions()
    rows = [{"j": r["j"], "s": r["s"], "i": r["i"]}
            for r in table().to_pylist()]

    def q(F, s):
        return s.createDataFrame(rows).select(
            F.xxhash64("j", "s", "i").alias("xx"),
            F.hive_hash("j", "s").alias("hh"), F.md5("s").alias("m"),
            (-F.col("j")).alias("n"), (F.col("i") % 7).alias("r")).collect()

    assert q(TF, port) == q(RF, ref)


def test_chip_smoke_phase17_rehearsal(tmp_path):
    """chip_smoke's phase 17 off the card at 2^12 rows: every check of
    (a)-(f) against its numpy, zoneinfo and hashlib oracles and the
    port's host engine (no timing lines)."""
    import chip_smoke
    chip_smoke.scalar_paths(TF, TorchSession, "cpu", str(tmp_path),
                            device="cpu", rows=1 << 12, md5_rows=1 << 9,
                            file_rows=1 << 11)


def test_partition_ids_under_an_operator_that_reads_every_partition():
    """A host operator that reads all its child's partitions (a global
    sort in the host engine) runs each child partition in that
    partition's task context: spark_partition_id below it is the child's
    partition, Spark's answer, as on the card (ROADMAP C6: the port's host
    engine ran them all under the parent's context, id 0, as the
    reference's host engine still does: C-ref-35)."""
    ref, port, host = _sessions()

    def q(F, s):
        return sorted(r["p"] for r in s.range(0, 400, 1, numPartitions=4)
                      .select(F.spark_partition_id().alias("p"), "id")
                      .orderBy("id").collect())

    spark = sorted([0] * 100 + [1] * 100 + [2] * 100 + [3] * 100)
    assert q(TF, host) == spark
    assert q(TF, port) == spark
    assert q(RF, ref) == [0] * 400
