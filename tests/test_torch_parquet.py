"""The port's parquet decode held against the JAX reference.

Each file is written once from a numpy seed with pyarrow (a module-scoped
fixture) and read through the reference's ``TpuSession`` and through
``TorchSession(device="cpu")``. Integers, dates, timestamps, strings,
binary and null masks must match exactly, floats bit for bit: the decode
does no arithmetic. The port's demotions to the host decode are counted in
its session counters and checked per case.

Twins of the decode cases of tests/test_parquet_device_decode.py,
tests/test_string_pipeline.py and tests/test_parquet_parity.py (their
chaos, ORC and dictionary-encoding cases wait for the modules they need),
plus one decoder-level case per function of
``kernels/parquet_decode.py``: the JAX function and the torch one on the
same buffers.
"""

import datetime as dt
import decimal
import struct

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import spark_rapids_tpu.functions as RF
import spark_rapids_tpu_torch.functions as TF
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch.columnar.batch import concat_batches
from spark_rapids_tpu_torch.io import device_decode as dd
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.memory.device import TorchDeviceManager

# the CPU has no device memory to read: the tests state one for the
# budget (spark.rapids.memory.device.totalBytes)
TorchDeviceManager.initialize(device="cpu", total_bytes=8 << 30)

OFF = {"spark.rapids.tpu.parquet.deviceDecode.enabled": "false"}
VERIFY = {"spark.rapids.tpu.parquet.deviceDecode.verify": "true"}


def _nulled(vals, k):
    return [None if k and i % k == 0 else v for i, v in enumerate(vals)]


def _mixed_table(n=4000, null_every=5, seed=7):
    rng = np.random.default_rng(seed)
    f32 = rng.normal(size=n).astype(np.float32)
    f32[3] = np.float32(-0.0)
    f64 = rng.normal(size=n)
    f64[7] = -0.0
    f64[8] = np.frombuffer(struct.pack("<Q", 0x7FF8_0000_DEAD_BEEF),
                           np.float64)[0]  # a NaN with a payload
    return pa.table({
        "i32": pa.array(_nulled([int(x) for x in
                                 rng.integers(-2**31, 2**31, n)],
                                null_every), pa.int32()),
        "i64": pa.array(_nulled([int(x) for x in
                                 rng.integers(-2**63, 2**63, n)],
                                null_every), pa.int64()),
        "f32": pa.array(f32, pa.float32()),
        "f64": pa.array(_nulled([float(x) for x in f64], null_every),
                        pa.float64()),
        "bool": pa.array(_nulled([bool(i % 3 == 0) for i in range(n)],
                                 null_every)),
        "date": pa.array(_nulled([i % 20000 for i in range(n)], null_every),
                         pa.date32()),
        "ts": pa.array(_nulled([1_600_000_000_000_000 + i for i in range(n)],
                               null_every), pa.timestamp("us")),
        "i8": pa.array(_nulled([i % 120 - 60 for i in range(n)], null_every),
                       pa.int8()),
        "lowcard": pa.array((np.arange(n) % 5).astype(np.int64)),
    })


def _string_table(n=3000, null_every=5, seed=11):
    rng = np.random.default_rng(seed)

    def s(i):
        if null_every and i % null_every == 0:
            return None
        if i % 7 == 1:
            return ""  # empty strings are not nulls
        return f"val{int(rng.integers(0, 40))}" * (i % 3 + 1)

    return pa.table({
        "s": pa.array([s(i) for i in range(n)], pa.string()),
        "b": pa.array([None if null_every and i % null_every == 3
                       else f"b{i % 17}".encode() for i in range(n)],
                      pa.binary()),
        "k": pa.array([f"g{i % 9}" for i in range(n)]),
        "v": pa.array(rng.normal(size=n)),
        "q": pa.array(rng.integers(0, 50, n)),
    })


def _bool_table(n=3000):
    return pa.table({
        "b_dense": pa.array([bool(i % 7 == 0) for i in range(n)]),
        "b_null": pa.array([None if i % 4 == 0 else bool(i % 2)
                            for i in range(n)]),
        "b_allnull": pa.array([None] * n, pa.bool_()),
    })


def _density_table(null_every, n=2500):
    vals = _nulled(list(range(n)), null_every)
    return pa.table({"v": pa.array(vals, pa.int64()),
                     "w": pa.array(vals, pa.int32())})


def _fallback_table(n=2000):
    """Written with INT96 timestamps, which decode on the host, per
    column; the other columns decode on the device into the same batch."""
    base = 1_400_000_000_000_000
    return pa.table({
        "dev_i": pa.array(_nulled(list(range(n)), 6), pa.int64()),
        "host_ts": pa.array(_nulled([base + 1000 * i for i in range(n)], 9),
                            pa.timestamp("us")),
        "dev_f": pa.array(np.arange(n) * 0.25, pa.float64()),
        "dev_s": pa.array(_nulled([f"s{i % 23}" for i in range(n)], 9)),
    })


def _overflow_table(n=6000):
    """Distinct values past the dictionary page limit: the writer falls
    back to PLAIN pages mid-chunk."""
    return pa.table({"x": pa.array(np.arange(n, dtype=np.int64) * 7919),
                     "y": pa.array(np.arange(n, dtype=np.float64) / 3),
                     "s": pa.array([f"v{i:06d}" for i in range(n)])})


#: case → (how its table is made, write options, scan conf)
CASES = {
    "plain": (_mixed_table, dict(use_dictionary=False, compression="snappy",
                                 row_group_size=1500), {}),
    "dictionary": (_mixed_table, dict(use_dictionary=True,
                                      compression="snappy",
                                      row_group_size=1500,
                                      data_page_size=800), {}),
    "booleans": (_bool_table, dict(compression="snappy",
                                   row_group_size=1000, data_page_size=200),
                 {}),
    "nulls-none": (lambda: _density_table(0),
                   dict(compression="snappy", row_group_size=800,
                        data_page_size=300), {}),
    "nulls-half": (lambda: _density_table(2),
                   dict(compression="snappy", row_group_size=800,
                        data_page_size=300), {}),
    "nulls-all": (lambda: _density_table(1),
                  dict(compression="snappy", row_group_size=800,
                       data_page_size=300), {}),
    "page-v2": (_mixed_table, dict(compression="snappy",
                                   data_page_version="2.0",
                                   row_group_size=1500, data_page_size=700),
                {}),
    "codec-none": (lambda: _mixed_table(1500), dict(compression="NONE",
                                                    row_group_size=600), {}),
    "codec-snappy": (lambda: _mixed_table(1500),
                     dict(compression="snappy", row_group_size=600), {}),
    "codec-zstd": (lambda: _mixed_table(1500), dict(compression="zstd",
                                                    row_group_size=600), {}),
    "codec-gzip": (lambda: _mixed_table(1500), dict(compression="gzip",
                                                    row_group_size=600), {}),
    "many-pages": (lambda: _mixed_table(6000),
                   dict(compression="snappy", row_group_size=1000,
                        data_page_size=200), {}),
    "verify": (lambda: _mixed_table(1000), dict(row_group_size=400), VERIFY),
    "decode-off": (lambda: _mixed_table(1200), dict(row_group_size=500), OFF),
    "dict-overflow": (_overflow_table,
                      dict(compression="snappy", row_group_size=3000,
                           data_page_size=1000,
                           dictionary_pagesize_limit=4096), {}),
    "str-dict-nulls-none": (lambda: _string_table(2500, 0),
                            dict(compression="snappy", row_group_size=900,
                                 data_page_size=400), {}),
    "str-dict-nulls-half": (lambda: _string_table(2500, 2),
                            dict(compression="snappy", row_group_size=900,
                                 data_page_size=400), {}),
    "str-dict-nulls-all": (lambda: _string_table(2500, 1),
                           dict(compression="snappy", row_group_size=900,
                                data_page_size=400), {}),
    "str-plain": (lambda: _string_table(2200, 4),
                  dict(use_dictionary=False, compression="snappy",
                       row_group_size=800, data_page_size=600), {}),
    "str-v2-zstd": (lambda: _string_table(1800, 3),
                    dict(compression="zstd", data_page_version="2.0",
                         row_group_size=700, data_page_size=300), VERIFY),
    "per-column-fallback": (_fallback_table,
                            dict(compression="snappy", row_group_size=700,
                                 use_deprecated_int96_timestamps=True), {}),
}

#: cases whose columns demote to the host decode, and how many a scan
DEMOTED = {"per-column-fallback": ("fallback_columns", 1),  # INT96
           "dict-overflow": ("fallback_columns", 1)}  # its string column


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_parquet")
    out = {}
    for name, (build, opts, _) in CASES.items():
        p = str(d / f"{name}.parquet")
        pq.write_table(build(), p, **opts)
        out[name] = p
    return out


# ---------------------------------------------------------------------------
# helpers: both packages' rows as comparable columns
# ---------------------------------------------------------------------------


def _ref_columns(table):
    out = {}
    for name in table.column_names:
        arr = table.column(name).combine_chunks()
        valid = np.asarray(arr.is_valid().to_numpy(zero_copy_only=False))
        t = arr.type
        if pa.types.is_string(t) or pa.types.is_binary(t):
            out[name] = (valid, arr.to_pylist())
            continue
        if pa.types.is_date32(t):
            arr = arr.cast(pa.int32())
        elif pa.types.is_timestamp(t):
            arr = arr.cast(pa.int64())
        fill = False if pa.types.is_boolean(arr.type) else 0
        out[name] = (valid, _bits(np.asarray(
            arr.fill_null(fill).to_numpy(zero_copy_only=False))))
    return out


def _bits(vals: np.ndarray) -> np.ndarray:
    if vals.dtype.kind == "f":
        return vals.view(np.int32 if vals.itemsize == 4 else np.int64)
    return vals


def _port_columns(df):
    batches = df.session._execute_batches(df._plan)
    batch = concat_batches(batches) if len(batches) > 1 else batches[0]
    out = {}
    for name, c in zip(df.columns, batch.columns):
        n = batch.num_rows
        valid = c.validity_or_true()[:n].numpy()
        if c.offsets is not None:
            out[name] = (valid, c.to_pylist())
            continue
        vals = c.data[:n].numpy().copy()
        vals[~valid] = 0
        out[name] = (valid, _bits(vals))
    return out


def _assert_same(port, ref):
    assert list(port) == list(ref)
    for name, (pv, pvals) in port.items():
        rv, rvals = ref[name]
        assert np.array_equal(pv, rv), f"column {name}: null masks differ"
        if isinstance(rvals, list):
            assert pvals == rvals, f"column {name}: values differ"
        else:
            assert pvals.dtype == rvals.dtype, name
            assert np.array_equal(pvals, rvals), f"column {name} differs"


def _port_session(conf=None):
    return TorchSession(dict(conf or {}), device="cpu")


# ---------------------------------------------------------------------------
# decode cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_matches_reference(files, case):
    conf = CASES[case][2]
    p = files[case]
    want = _ref_columns(TpuSession(dict(conf)).read.parquet(p).to_arrow())
    s = _port_session(conf)
    _assert_same(_port_columns(s.read.parquet(p)), want)
    md = pq.ParquetFile(p).metadata
    n_rg = md.num_row_groups
    if case == "dict-overflow":  # the writer really fell back mid-chunk
        enc = set(md.row_group(0).column(0).encodings)
        assert "PLAIN" in enc and "RLE_DICTIONARY" in enc, enc
    if conf is OFF:
        assert s.counters["scan.rowGroups"] == 0
        return
    assert s.counters["scan.rowGroups"] == n_rg  # one decode a row group
    key, per_rg = DEMOTED.get(case, (None, 0))
    for k in dd.FALLBACK_KEYS:
        assert s.counters[k] == (per_rg * n_rg if k == key else 0), k
    # the demotions show in explain_fallback()'s scan line
    assert s.read.parquet(p).explain_fallback().splitlines()[-1] == (
        "scan: parquet device decode, " + ", ".join(
            f"{k}={s.counters[k]}" for k in dd.FALLBACK_KEYS))


def test_decode_on_and_off_identical(files):
    p = files["dictionary"]
    on = _port_columns(_port_session().read.parquet(p))
    _assert_same(_port_columns(_port_session(OFF).read.parquet(p)), on)


def test_row_group_pruning_skips_decodes(tmp_path):
    n = 4000
    t = pa.table({"k": pa.array(np.arange(n, dtype=np.int64)),
                  "v": pa.array(np.arange(n, dtype=np.float64))})
    p = str(tmp_path / "t.parquet")
    pq.write_table(t, p, row_group_size=1000)
    s = _port_session()
    rows = s.read.parquet(p).filter(TF.col("k") >= 3500).collect()
    assert sorted(r["k"] for r in rows) == list(range(3500, 4000))
    assert s.counters["scan.rowGroups"] == 1  # 3 of 4 groups pruned
    ref = TpuSession({}).read.parquet(p).filter(RF.col("k") >= 3500)
    assert rows == ref.collect()


def test_partitioned_directory(tmp_path):
    root = tmp_path / "part"
    for k in (1, 2):
        d = root / f"k={k}"
        d.mkdir(parents=True)
        n = 600
        t = pa.table({"v": pa.array(np.arange(n, dtype=np.int64) * k),
                      "f": pa.array(np.arange(n) * 0.5, pa.float64())})
        pq.write_table(t, str(d / "f0.parquet"), row_group_size=250)
    for conf in ({}, OFF):
        s = _port_session(conf)
        df = s.read.parquet(str(root))
        assert df.columns == ["v", "f", "k"]
        ref = TpuSession(dict(conf)).read.parquet(str(root))
        _assert_same(_port_columns(df), _ref_columns(ref.to_arrow()))
        got = df.filter(TF.col("k") == 2).collect()
        assert got == ref.filter(RF.col("k") == 2).collect()
        assert {r["k"] for r in got} == {2} and len(got) == 600


# ---------------------------------------------------------------------------
# parity hardening: calendar rebase, INT96, chunked reads (the twins of
# tests/test_parquet_parity.py)
# ---------------------------------------------------------------------------


def test_rebase_functions_equal_reference():
    from spark_rapids_tpu.io import rebase as R
    from spark_rapids_tpu_torch.io import rebase as T
    days = np.random.default_rng(3).integers(-800_000, 30_000, 5000)
    assert np.array_equal(T.julian_to_gregorian_days(days),
                          R.julian_to_gregorian_days(days))
    us = days * 86_400_000_000 + 12_345
    assert np.array_equal(T.julian_to_gregorian_micros(us),
                          R.julian_to_gregorian_micros(us))
    for kv, mode in (({b"org.apache.spark.legacyDateTime": b""},
                      "CORRECTED"),
                     ({b"org.apache.spark.legacyINT96": b""}, "CORRECTED"),
                     ({b"other": b""}, "CORRECTED"), (None, "CORRECTED"),
                     (None, "LEGACY")):
        assert T.needs_rebase(kv, mode) == R.needs_rebase(kv, mode)


def test_legacy_marked_file_rebases(tmp_path):
    civil = [dt.date(1000, 1, 1), dt.date(1, 1, 1), dt.date(2020, 5, 17)]
    hybrid_days = [-354280, -719164,
                   (dt.date(2020, 5, 17) - dt.date(1970, 1, 1)).days]
    t = pa.table({"d": pa.array(hybrid_days, pa.int32()).cast(pa.date32()),
                  "v": [1, 2, 3]})
    t = t.replace_schema_metadata({b"org.apache.spark.legacyDateTime": b""})
    p = str(tmp_path / "legacy.parquet")
    pq.write_table(t, p)
    want = TpuSession({}).read.parquet(p).collect()
    for conf in ({}, OFF, {"spark.rapids.sql.format.parquet.enabled":
                           "false"}):
        s = _port_session(conf)
        got = s.read.parquet(p).collect()
        assert got == want
        assert sorted((r["v"], r["d"]) for r in got) == list(
            zip([1, 2, 3], civil))
    # the device decode cannot rebase: the file reads on the host, counted
    s = _port_session()
    s.read.parquet(p).collect()
    assert s.counters["fallback_files"] == 1


def test_unmarked_file_reads_as_corrected(tmp_path):
    days = [(dt.date(1000, 1, 6) - dt.date(1970, 1, 1)).days]
    t = pa.table({"d": pa.array(days, pa.int32()).cast(pa.date32())})
    p = str(tmp_path / "modern.parquet")
    pq.write_table(t, p)
    got = _port_session().read.parquet(p).collect()
    assert got == [{"d": dt.date(1000, 1, 6)}]
    assert got == TpuSession({}).read.parquet(p).collect()


@pytest.mark.parametrize("kind", ["int96", "nanos"])
def test_foreign_timestamps_truncate_to_micros(tmp_path, kind):
    p = str(tmp_path / f"{kind}.parquet")
    if kind == "int96":
        ts = [dt.datetime(2015, 3, 14, 9, 26, 53, 589793),
              dt.datetime(1970, 1, 1), dt.datetime(2038, 1, 19, 3, 14, 7)]
        pq.write_table(pa.table({"ts": pa.array(ts, pa.timestamp("us"))}),
                       p, use_deprecated_int96_timestamps=True)
        assert pq.ParquetFile(p).schema.column(0).physical_type == "INT96"
        want = [v.replace(tzinfo=dt.timezone.utc) for v in ts]
    else:
        pq.write_table(pa.table({"ts": pa.array([1_000_000_001,
                                                 1_500_000_999],
                                                pa.timestamp("ns"))}),
                       p, coerce_timestamps=None)
        want = [dt.datetime(1970, 1, 1, 0, 0, 1, tzinfo=dt.timezone.utc),
                dt.datetime(1970, 1, 1, 0, 0, 1, 500000,
                            tzinfo=dt.timezone.utc)]
    ref = _ref_columns(TpuSession({}).read.parquet(p).to_arrow())
    for conf in ({}, OFF):
        s = _port_session(conf)
        df = s.read.parquet(p)
        assert [r["ts"] for r in df.collect()] == want
        _assert_same(_port_columns(df), ref)
    s = _port_session()
    s.read.parquet(p).collect()
    assert s.counters["fallback_row_groups"] == 1  # no column on the device


@pytest.mark.parametrize("reader", ["PERFILE", "COALESCING",
                                    "MULTITHREADED"])
def test_host_readers_equal(tmp_path, reader):
    """The host strategies (with a tiny chunk cap: one chunk a row group)
    give the device decode's rows, and pruning applies in each."""
    n = 8192
    rng = np.random.default_rng(5)
    t = pa.table({"k": rng.integers(0, 100, n), "v": rng.random(n),
                  "a": np.arange(n)})
    for i in range(2):
        pq.write_table(t.slice(i * n // 2, n // 2),
                       str(tmp_path / f"part{i}.parquet"),
                       row_group_size=1024)
    host = {**OFF, "spark.rapids.sql.reader.chunked.maxDecodeBytes": "1024",
            "spark.rapids.sql.format.parquet.reader.type": reader}
    ref = _ref_columns(TpuSession(host).read.parquet(str(tmp_path))
                       .to_arrow())
    for conf in (host, {}):
        df = _port_session(conf).read.parquet(str(tmp_path))
        _assert_same(_port_columns(df), ref)
    got = (_port_session(host).read.parquet(str(tmp_path))
           .filter(TF.col("a") >= n - 500).collect())
    assert sorted(r["a"] for r in got) == list(range(n - 500, n))


# ---------------------------------------------------------------------------
# types the port has no carrier for; encrypted files
# ---------------------------------------------------------------------------


def test_decimal_column_stops_at_planning(tmp_path):
    p = str(tmp_path / "dec.parquet")
    pq.write_table(pa.table({
        "d": pa.array([decimal.Decimal(i) / 4 for i in range(10)],
                      pa.decimal128(25, 2)),
        "i": pa.array(np.arange(10))}), p)
    df = _port_session().read.parquet(p)
    # decimals have carriers now (two int64 limbs past precision 18): the
    # scan reads the column as pyarrow does
    assert df.collect() == pq.read_table(p).to_pylist()
    # a query that does not read the column runs
    assert [r["i"] for r in df.groupBy("i").agg(
        TF.count(TF.col("i")).alias("n")).collect()] == list(range(10))


def _encrypted_footer_file(tmp_path):
    p = str(tmp_path / "plain.parquet")
    pq.write_table(pa.table({"a": pa.array([1, 2, 3], pa.int64())}), p)
    raw = bytearray(open(p, "rb").read())
    raw[-4:] = b"PARE"
    enc = str(tmp_path / "pare.parquet")
    open(enc, "wb").write(bytes(raw))
    return enc


def test_encrypted_footer_message(tmp_path):
    enc = _encrypted_footer_file(tmp_path)
    with pytest.raises(dd.ParquetEncryptedException) as ei:
        _port_session().read.parquet(enc)
    msg = str(ei.value)
    assert enc in msg and "encrypted" in msg and "PARE" in msg \
        and "CPU" in msg
    from spark_rapids_tpu.io import device_decode as ref_dd
    assert dd.detect_encryption(enc) == ref_dd.detect_encryption(enc)


def test_plaintext_footer_crypto_metadata_detected(tmp_path):
    p = str(tmp_path / "a.parquet")
    pq.write_table(pa.table({"a": pa.array([1, 2, 3], pa.int64())}), p)
    raw = bytearray(open(p, "rb").read())
    flen = struct.unpack("<I", raw[-8:-4])[0]
    footer = bytes(raw[-8 - flen:-8])
    fields, endpos = dd._read_struct(footer, 0)
    last = max(fields)
    assert endpos == len(footer) and 0 < 8 - last <= 15
    new_footer = footer[:endpos - 1] \
        + bytes([((8 - last) << 4) | 12, 0x00, 0x00])
    out = bytes(raw[:-8 - flen]) + new_footer \
        + struct.pack("<I", len(new_footer)) + b"PAR1"
    enc = str(tmp_path / "ptfooter.parquet")
    open(enc, "wb").write(out)
    reason = dd.detect_encryption(enc)
    assert reason is not None and "plaintext footer" in reason
    from spark_rapids_tpu.io import device_decode as ref_dd
    assert reason == ref_dd.detect_encryption(enc)
    assert dd.detect_encryption(p) is None
    short = str(tmp_path / "short.bin")
    open(short, "wb").write(b"tiny")
    assert dd.detect_encryption(short) is None


def test_other_formats_not_yet_ported(tmp_path):
    r = _port_session().read
    for call in (lambda: r.avro("x"), lambda: r.hive_text("x"),
                 lambda: r.delta("x"), lambda: r.iceberg("x"),
                 lambda: r.format("avro").load("x")):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            call()
    # csv, json and orc read since the surface slice: a missing file is
    # the error now
    for call in (lambda: r.csv(str(tmp_path / "x.csv")),
                 lambda: r.json(str(tmp_path / "x")),
                 lambda: r.orc(str(tmp_path / "x")),
                 lambda: r.format("orc").load(str(tmp_path / "x"))):
        with pytest.raises(FileNotFoundError):
            call()


# ---------------------------------------------------------------------------
# decoder level: each function of kernels/parquet_decode.py, JAX vs torch
# ---------------------------------------------------------------------------


def _runs_and_bytes(rng):
    """A hybrid run table over random bytes: literal runs of widths 1..20
    and RLE runs, padded as the host pads it."""
    from spark_rapids_tpu_torch.kernels.parquet_decode import (
        RUN_COLS, RUN_PAD_START)
    data = rng.integers(0, 256, 4096).astype(np.uint8)
    rows, out, bit = [], 0, 0
    for i in range(40):
        cnt = int(rng.integers(1, 60))
        if i % 2:
            w = int(rng.integers(1, 21))
            rows.append([out, bit, 0, 1, w])
            bit += cnt * w
        else:
            rows.append([out, 0, int(rng.integers(0, 1000)), 0, 0])
        out += cnt
    table = np.zeros((64, RUN_COLS), np.int64)
    table[:, 0] = RUN_PAD_START
    table[:len(rows)] = rows
    return table, np.concatenate([data, np.zeros(8, np.uint8)]), out


def _decoder_case(name, rng):
    """(function name, numpy args, static args) of one decoder case."""
    if name == "unpack_bits":
        data = rng.integers(0, 256, 1024).astype(np.uint8)
        return ((np.concatenate([data, np.zeros(8, np.uint8)]),
                 rng.integers(0, 1024 * 8 - 40, 3000),
                 rng.integers(1, 33, 3000)), ())
    if name in ("expand_runs", "decode_bool_runs"):
        table, data, out = _runs_and_bytes(rng)
        return (table, data), (out + 50,)
    if name == "validity_from_defs":
        return (rng.integers(0, 2, 512).astype(np.int64),), (1, 400)
    if name == "expand_dense":
        valid = rng.random(512) < 0.6
        return (rng.normal(size=int(valid.sum()) + 3), valid), ()
    if name == "expand_dense_empty":
        return (np.zeros(0, np.float64), np.zeros(256, np.bool_)), ()
    if name == "dictionary_gather":
        return (rng.normal(size=37), rng.integers(-3, 45, 700)), ()
    if name.startswith("plain_fixed_width"):
        _, isz, kind = name.split(":")
        raw = rng.integers(0, 256, 8 * 300).astype(np.uint8)
        raw[:8] = np.frombuffer(struct.pack("<d", -0.0), np.uint8)
        raw[8:16] = np.frombuffer(struct.pack("<Q", 0x7FF4_0000_0000_0001),
                                  np.uint8)
        return (raw,), (int(isz), kind)
    if name == "merge_plain_segments":
        from spark_rapids_tpu_torch.kernels.parquet_decode import (
            RUN_COLS, RUN_PAD_START)
        seg = np.zeros((16, RUN_COLS), np.int64)
        seg[:, 0] = RUN_PAD_START
        seg[:4] = [[0, 0, 0, 0, 0], [100, 0, 0, 1, 0], [180, 0, 0, 0, 0],
                   [250, 80, 0, 1, 0]]
        return (seg, rng.normal(size=160), rng.normal(size=400)), (400,)
    if name == "string_offsets":
        return (rng.integers(0, 30, 300).astype(np.int32),), ()
    if name == "gather_string_bytes":
        lens = rng.integers(0, 20, 200)
        offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
        data = rng.integers(0, 256, 5000).astype(np.uint8)
        return (data, rng.integers(0, 4900, 200), offs), (
            int(offs[-1]) + 64,)
    raise KeyError(name)


DECODERS = ["unpack_bits", "expand_runs", "decode_bool_runs",
            "validity_from_defs", "expand_dense", "expand_dense_empty",
            "dictionary_gather", "merge_plain_segments", "string_offsets",
            "gather_string_bytes", "plain_fixed_width:4:i",
            "plain_fixed_width:8:i", "plain_fixed_width:4:f",
            "plain_fixed_width:8:f", "plain_fixed_width:2:i",
            "plain_fixed_width:1:u"]


@pytest.mark.parametrize("name", DECODERS)
def test_decoder_function_matches_reference(name):
    import jax.numpy as jnp

    from spark_rapids_tpu.kernels import parquet_decode as RK
    from spark_rapids_tpu_torch.kernels import parquet_decode as TK
    args, static = _decoder_case(name, np.random.default_rng(
        DECODERS.index(name)))
    fn = name.split(":")[0].replace("_empty", "")
    got = getattr(TK, fn)(*[torch.from_numpy(np.ascontiguousarray(a))
                            for a in args], *static).numpy()
    if fn == "expand_dense" and not args[0].size:
        # an all-null chunk stores no value: zeros (jnp.take raises on an
        # empty axis, so the reference has no answer to compare here)
        assert not got.any() and got.shape == args[1].shape
        return
    want = np.asarray(getattr(RK, fn)(*[jnp.asarray(a) for a in args],
                                      *static))
    if fn == "plain_fixed_width":
        # the same bytes through an unaligned slice view
        raw = torch.from_numpy(np.concatenate([np.zeros(3, np.uint8),
                                               args[0]]))[3:]
        again = TK.plain_fixed_width(raw, *static).numpy()
        assert again.tobytes() == got.tobytes()
    assert got.shape == want.shape
    if got.dtype.kind == "f":
        assert got.tobytes() == want.astype(got.dtype).tobytes()
    else:
        assert np.array_equal(got.astype(np.int64), want.astype(np.int64))
