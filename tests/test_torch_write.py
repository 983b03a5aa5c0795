"""The port's file writer, its host reads of ORC, CSV and JSON, and
``df.cache()``, held to the reference on the CPU.

The same seeded table goes through ``TpuSession`` (the reference's host
engine, ``spark.rapids.sql.enabled=false``) and ``TorchSession(device=
"cpu")`` (device path on, test mode). Each writes into its own directory:
the relative file layouts (the write job's id taken out of the names)
match exactly, CSV and JSON files match byte for byte, and every file set
reads back to the source rows through both packages' readers.
"""

import functools
import json
import os
import re

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import spark_rapids_tpu.functions as RF
import spark_rapids_tpu_torch.functions as TF
from asserts import _assert_value_equal, _rows_sort_key
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch.memory.device import TorchDeviceManager
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.shuffle.exchange import ShuffleCatalog

TorchDeviceManager.initialize(device="cpu", total_bytes=8 << 30)

BASE = {"spark.rapids.shuffle.mode": "ICI",
        "spark.sql.shuffle.partitions": "4"}
DEVICE = dict(BASE, **{"spark.rapids.sql.test.enabled": "true"})
HOST = dict(BASE, **{"spark.rapids.sql.enabled": "false"})


@functools.lru_cache(maxsize=None)
def _ref():
    return TpuSession(dict(HOST))


@functools.lru_cache(maxsize=None)
def _port(on_device: bool = True):
    return TorchSession(dict(DEVICE if on_device else HOST), device="cpu")


@functools.lru_cache(maxsize=None)
def _table(n: int = 2000, seed: int = 3) -> pa.Table:
    rng = np.random.default_rng(seed)
    return pa.table({
        "g": pa.array(rng.integers(0, 3, n).astype(np.int64),
                      mask=rng.random(n) < 0.03),
        "h": np.array(["a", "b"])[rng.integers(0, 2, n)],
        "k": rng.integers(0, 500, n).astype(np.int64),
        "i": rng.integers(-99, 99, n).astype(np.int32),
        "x": pa.array(np.round(rng.uniform(-1e3, 1e3, n), 3),
                      mask=rng.random(n) < 0.05),
        "b": rng.random(n) < 0.5,
        "s": pa.array([None if v < 0.05 else f"s,{int(v * 1e3)}\"q"
                       for v in rng.random(n)], pa.string()),
    })


def _same_rows(got, want) -> None:
    assert len(got) == len(want), (len(got), len(want))
    got = sorted(got, key=_rows_sort_key)
    want = sorted(want, key=_rows_sort_key)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_value_equal(w, g, f"row[{i}]", True)


def _layout(path: str) -> list:
    """Every file under ``path``, relative, the job id taken out."""
    out = []
    for root, _, files in os.walk(path):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), path)
            out.append(re.sub(r"-[0-9a-f]{8}(?=[._])", "", rel))
    return sorted(out)


def _texts(path: str) -> dict:
    out = {}
    for root, _, files in os.walk(path):
        for f in files:
            p = os.path.join(root, f)
            rel = re.sub(r"-[0-9a-f]{8}(?=[._])", "",
                         os.path.relpath(p, path))
            with open(p, "rb") as fh:
                out[rel] = fh.read()
    return out


def _write(session, path: str, fmt: str, layout: str, parts: int = 2):
    df = session.createDataFrame(_table(), num_partitions=parts)
    w = df.write.mode("overwrite")
    if layout == "partitioned":
        w = w.partitionBy("g", "h")
    elif layout == "bucketed":
        w = w.bucketBy(4, "k")
    getattr(w, fmt)(path)


def _read(session, path: str, fmt: str):
    if fmt == "csv":
        return session.read.csv(path, header=True)
    return getattr(session.read, fmt)(path)


@pytest.mark.parametrize("layout", ["plain", "partitioned", "bucketed"])
@pytest.mark.parametrize("fmt", ["parquet", "orc", "csv", "json"])
def test_write_layout_text_and_read_back(tmp_path, fmt, layout):
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    _write(_ref(), ref_dir, fmt, layout)
    _write(_port(True), port_dir, fmt, layout)
    assert _layout(port_dir) == _layout(ref_dir)
    if fmt in ("csv", "json"):
        assert _texts(port_dir) == _texts(ref_dir)
    if layout == "partitioned" and fmt in ("csv", "json"):
        return  # text reads of hive directories: types differ by file
    want = _table().to_pylist()
    if layout == "partitioned":
        # partition columns come back last; g's null directory
        # (__HIVE_DEFAULT_PARTITION__) makes it a string column
        want = [{**{c: r[c] for c in r if c not in ("g", "h")},
                 "g": None if r["g"] is None else str(r["g"]),
                 "h": r["h"]} for r in want]
    got = _read(_port(True), port_dir, fmt)
    ref = _read(_ref(), ref_dir, fmt)
    assert got.columns == ref.columns
    rows = got.collect()
    _same_rows(rows, ref.collect())
    if fmt in ("parquet", "orc"):
        _same_rows(rows, want)
    else:
        assert len(rows) == len(want)


def test_bucket_ids_are_sparks(tmp_path):
    """Each bucket file holds only rows whose pmod(murmur3(k, 42), 4) is
    its bucket id (the reference's hash through the port's murmur3)."""
    from spark_rapids_tpu.expressions.hashexprs import _np_hash_col
    from spark_rapids_tpu.types import LongT
    path = str(tmp_path / "b")
    _write(_port(True), path, "parquet", "bucketed")
    seen = 0
    for f in os.listdir(path):
        if not f.endswith(".parquet"):
            continue
        bucket = int(f.split("_")[1].split(".")[0])
        k = pq.read_table(os.path.join(path, f)).column("k")
        h = _np_hash_col(LongT, k, np.full(len(k), np.uint32(42), np.uint32))
        assert set(((h.view(np.int32).astype(np.int64) % 4) + 4) % 4) \
            == {bucket}
        seen += len(k)
    assert seen == _table().num_rows


def test_bucketed_write_layout(tmp_path):
    path = str(tmp_path / "bt")
    _port(True).createDataFrame(
        pa.table({"k": list(range(100)), "v": [f"v{i}" for i in range(100)]}),
        num_partitions=2).write.bucketBy(4, "k").mode("overwrite").parquet(
        path)
    files = sorted(os.listdir(path))
    assert "_bucket_spec.json" in files
    with open(os.path.join(path, "_bucket_spec.json")) as f:
        assert json.load(f) == {"numBuckets": 4, "bucketColumns": ["k"]}
    data = [f for f in files if f.endswith(".parquet")]
    buckets = {f.split("_")[1].split(".")[0] for f in data}
    assert buckets <= {f"{b:05d}" for b in range(4)} and len(buckets) > 1
    assert _port(True).read.parquet(path).count() == 100


def test_bucketing_disabled_by_conf(tmp_path):
    s = TorchSession({"spark.rapids.sql.format.write.bucketing.enabled":
                      "false"}, device="cpu")
    s.createDataFrame(pa.table({"k": [1, 2, 3]})).write.bucketBy(
        4, "k").mode("overwrite").parquet(str(tmp_path / "nb"))
    files = os.listdir(str(tmp_path / "nb"))
    assert "_bucket_spec.json" not in files
    assert all("_0" not in f for f in files if f.endswith(".parquet"))


def test_bucketed_append_spec_mismatch_rejected(tmp_path):
    path = str(tmp_path / "bt")
    s = _port(True)
    s.createDataFrame(pa.table({"k": list(range(100)), "v": [
        f"v{i}" for i in range(100)]})).write.bucketBy(4, "k").mode(
        "overwrite").parquet(path)
    df2 = s.createDataFrame(pa.table({"k": [200, 201], "v": ["a", "b"]}))
    with pytest.raises(ValueError, match="bucket spec"):
        df2.write.bucketBy(8, "k").mode("append").parquet(path)
    df2.write.bucketBy(4, "k").mode("append").parquet(path)
    assert s.read.parquet(path).count() == 102


def test_write_modes(tmp_path):
    path = str(tmp_path / "m")
    df = _port(True).createDataFrame(_table())
    df.write.parquet(path)
    with pytest.raises(FileExistsError):
        df.write.parquet(path)
    with pytest.raises(FileExistsError):
        df.write.mode("error").parquet(path)
    df.write.mode("append").parquet(path)
    assert len({re.search(r"part-\d+-([0-9a-f]{8})", f).group(1)
                for f in os.listdir(path)}) == 2
    assert _port(True).read.parquet(path).count() == 2 * _table().num_rows
    df.write.mode("overwrite").parquet(path)
    assert _port(True).read.parquet(path).count() == _table().num_rows
    # ignore: an existing path is left as it is, as Spark does (the
    # reference writes into it: C-ref-23)
    before = sorted(os.listdir(path))
    df.write.mode("ignore").parquet(path)
    assert sorted(os.listdir(path)) == before
    df.write.mode("ignore").format("json").save(str(tmp_path / "new"))
    assert os.listdir(str(tmp_path / "new"))


@pytest.mark.parametrize("fmt", ["parquet", "csv", "json"])
def test_empty_result_writes_schema(tmp_path, fmt):
    def run(s, d, fn):
        q = s.createDataFrame(_table()).filter(fn.col("i") > 1000)
        getattr(q.write, fmt)(d)
    run(_ref(), str(tmp_path / "r"), RF)
    run(_port(True), str(tmp_path / "p"), TF)
    assert _layout(str(tmp_path / "p")) == _layout(str(tmp_path / "r")) \
        == [f"part-00000.{fmt}"]
    assert _texts(str(tmp_path / "p")) == _texts(str(tmp_path / "r")) \
        or fmt == "parquet"
    if fmt == "parquet":
        assert pq.read_schema(os.path.join(str(tmp_path / "p"),
                                           "part-00000.parquet")).names \
            == _table().column_names


def test_write_on_device_metrics_and_shuffle_release(tmp_path):
    s = _port(True)
    df = s.createDataFrame(_table(), num_partitions=3).repartition(4, "k")
    df.write.parquet(str(tmp_path / "w"))
    m = s.last_query_metrics("DEBUG")
    key = next(k for k in m if k.endswith("TorchDataWritingCommandExec"))
    assert m[key]["numWrittenRows"] == _table().num_rows
    assert m[key]["numFiles"] == 4
    assert any("TorchShuffleExchangeExec" in k for k in m)
    assert ShuffleCatalog.get().num_blocks() == 0
    off = TorchSession(dict(BASE, **{
        "spark.rapids.sql.format.parquet.write.enabled": "false"}),
        device="cpu")
    off.createDataFrame(_table()).write.parquet(str(tmp_path / "off"))
    assert any(k.endswith("CpuDataWritingCommandExec")
               for k in off.last_query_metrics("DEBUG"))
    assert off.read.parquet(str(tmp_path / "off")).count() \
        == _table().num_rows
    for fmt in ("delta", "avro", "hivetext"):
        with pytest.raises(NotImplementedError, match="A9"):
            s.createDataFrame(_table()).write.format(fmt).save(
                str(tmp_path / fmt))


# --- host reads --------------------------------------------------------------

def _read_both(build):
    want = build(_ref(), RF).collect()
    for s in (_port(True), _port(False)):
        _same_rows(build(s, TF).collect(), want)
    return want


def test_csv_user_schema_and_sep(tmp_path):
    p = str(tmp_path / "t.csv")
    with open(p, "w") as f:
        f.write("a|b|c\n1|x|2.5\n2|y|-1.0\n3||0.0\n")
    _read_both(lambda s, F: s.read.csv(p, header=True, sep="|",
                                       schema="a INT, b STRING, c DOUBLE")
               .select(F.col("a"), F.col("b"), F.col("c")))


def test_csv_schema_no_header(tmp_path):
    p = str(tmp_path / "t.csv")
    with open(p, "w") as f:
        f.write("1,x\n2,y\n")
    want = _read_both(lambda s, F: s.read.csv(p, schema="k BIGINT, v STRING")
                      .select(F.col("k"), F.col("v")))
    assert want == [{"k": 1, "v": "x"}, {"k": 2, "v": "y"}]


@pytest.mark.parametrize("ddl, cols", [("a INT, b STRING", ("a", "b")),
                                       ("a INT, b STRING, c DOUBLE, d BIGINT",
                                        ("a", "d"))])
def test_csv_schema_column_mismatch(tmp_path, ddl, cols):
    p = str(tmp_path / "t.csv")
    with open(p, "w") as f:
        f.write("a,b,c\n1,x,2.5\n2,y,-1.0\n")
    _read_both(lambda s, F: s.read.csv(p, header=True, schema=ddl)
               .select(*[F.col(c) for c in cols]))


def test_csv_options_and_load(tmp_path):
    p = str(tmp_path / "t.csv")
    with open(p, "w") as f:
        f.write("n;s\n1;a\n2;b\n")
    _read_both(lambda s, F: s.read.option("header", "true").option(
        "sep", ";").format("csv").load(p))


def test_json_scan(tmp_path):
    p = str(tmp_path / "data.json")
    with open(p, "w") as f:
        f.write('{"a": 1, "s": "x"}\n{"a": null, "s": "y"}\n'
                '{"a": 3, "s": null}\n')
    _read_both(lambda s, F: s.read.json(p).select(F.col("a"), F.col("s")))
    assert "TorchFileScanExec[json" in _port(True).read.json(p).explain()


def test_orc_pushdown_filter(tmp_path):
    p = str(tmp_path / "t.orc")
    import pyarrow.orc as paorc
    paorc.write_table(_table(), p)
    want = _read_both(lambda s, F: s.read.orc(p).filter(
        (F.col("k") >= 250) & (F.col("i") < 0)).select("k", "i", "s"))
    assert want and all(r["k"] >= 250 for r in want)


def test_unported_reads_name_a9(tmp_path):
    s = _port(True)
    for fmt in ("avro", "delta", "iceberg"):
        with pytest.raises(NotImplementedError, match="A9"):
            s.read.format(fmt).load(str(tmp_path))
    with pytest.raises(NotImplementedError, match="A9"):
        s.read.hive_text(str(tmp_path))


# --- df.cache() --------------------------------------------------------------

def test_cache_rows_spill_and_unpersist(tmp_path):
    s = TorchSession(dict(DEVICE, **{
        "spark.rapids.sql.cache.batchSizeRows": "300",
        "spark.rapids.sql.cache.hostMemoryLimit": "20k"}), device="cpu")
    df = s.createDataFrame(_table(), num_partitions=2)
    cached = df.cache()
    rel = cached._plan
    assert len(rel.batches) == 7
    assert 0 < sum(b.on_disk for b in rel.batches) < 7
    assert rel.host_bytes <= 20 << 10
    assert "on disk" in cached.explain()
    _same_rows(cached.collect(), _table().to_pylist())
    q = cached.groupBy("g").agg(TF.sum("i").alias("si"))
    want = _ref().createDataFrame(_table()).groupBy("g").agg(
        RF.sum("i").alias("si")).collect()
    _same_rows(q.collect(), want)
    _same_rows(q.collect(), want)  # a plan-cache hit reads the cache again
    assert cached.persist().count() == _table().num_rows
    rel.unpersist()
    assert not rel.batches and q.count() == 0
