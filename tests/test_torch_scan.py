"""Queries over a parquet file through the port, held against the JAX
reference on the same file: bench.py's two ``scan_agg`` queries and TPC-H
Q1 (``chip_smoke.framework_query``).

The file is the reference's datagen lineitem (seed 0, bench.py's layout:
parts of 2048 rows through one writer, snappy, row groups of 1024 rows,
small pages), written once. Each query's reference result is computed
once; the port runs it with the device decode on and off, on the compiled
aggregation stage and on the general aggregate (with the whole plan
asserted on the device), and with the scan kept on the CPU
(``spark.rapids.sql.format.parquet.enabled=false``: the host scan and the
upload). Keys and counts must match exactly, float64 sums and averages
within rtol 1e-9 (the two packages sum in different orders), and the
scan must read only the query's columns and demote nothing.
"""

import functools
import math

import pyarrow.parquet as pq
import pytest

import chip_smoke
import spark_rapids_tpu.functions as RF
import spark_rapids_tpu_torch.functions as TF
from spark_rapids_tpu import datagen as RD
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch.io.device_decode import FALLBACK_KEYS
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.memory.device import TorchDeviceManager

# the CPU has no device memory to read: the tests state one for the
# budget (spark.rapids.memory.device.totalBytes)
TorchDeviceManager.initialize(device="cpu", total_bytes=8 << 30)

ROWS, PART, ROW_GROUP = 8192, 2048, 1024

#: the port's configurations of each query: (conf, physical plan must hold)
PATHS = {
    "decode-on": ({}, "TorchFileScanExec"),
    "decode-off": ({"spark.rapids.tpu.parquet.deviceDecode.enabled":
                    "false"}, "TorchFileScanExec"),
    "general": ({"spark.rapids.tpu.agg.compiledStage.enabled": "false",
                 "spark.rapids.sql.test.enabled": "true"},
                "TorchHashAggregate"),
    "host-scan": ({"spark.rapids.sql.format.parquet.enabled": "false"},
                  "CpuFileScanExec"),
}


def scan_agg_query(F, df):
    """bench.py's _scan_agg query."""
    return (df.filter(F.col("l_quantity") < 30)
            .groupBy("l_returnflag")
            .agg(F.sum(F.col("l_extendedprice")).alias("sum_price"),
                 F.sum(F.col("l_discount")).alias("sum_disc"),
                 F.count(F.col("l_quantity")).alias("cnt")))


def scan_agg_strings_query(F, df):
    """bench.py's _scan_agg strings query: three string scan columns."""
    return (df.groupBy("l_returnflag", "l_linestatus", "l_shipmode")
            .agg(F.sum(F.col("l_quantity")).alias("sum_qty"),
                 F.count(F.col("l_shipinstruct")).alias("cnt")))


QUERIES = {
    "scan_agg": (scan_agg_query, ["l_quantity", "l_extendedprice",
                                  "l_discount", "l_returnflag"]),
    "scan_agg_strings": (scan_agg_strings_query,
                         ["l_quantity", "l_returnflag", "l_linestatus",
                          "l_shipmode", "l_shipinstruct"]),
    "q1": (chip_smoke.framework_query,
           ["l_quantity", "l_extendedprice", "l_discount", "l_tax",
            "l_returnflag", "l_linestatus", "l_shipdate"]),
}


@pytest.fixture(scope="module")
def lineitem(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_scan") / "lineitem.parquet")
    spec = RD.tpch_lineitem(ROWS)
    writer = None
    for part in range(ROWS // PART):
        t = spec.generate_partition(0, part, PART, offset=part * PART)
        if writer is None:
            writer = pq.ParquetWriter(path, t.schema, compression="snappy",
                                      data_page_size=4096)
        writer.write_table(t, row_group_size=ROW_GROUP)
    writer.close()
    return path


@functools.lru_cache(maxsize=None)
def _reference(query: str, path: str):
    build, _ = QUERIES[query]
    return build(RF, TpuSession({}).read.parquet(path)).collect()


def _key(row, names):
    return tuple(row[n] for n in names)


def _assert_rows_close(got, want):
    assert len(got) == len(want)
    names = [k for k, v in want[0].items() if isinstance(v, str)]
    got = sorted(got, key=lambda r: _key(r, names))
    want = sorted(want, key=lambda r: _key(r, names))
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if isinstance(v, float):
                assert math.isclose(g[k], v, rel_tol=1e-9), (k, g[k], v)
            else:
                assert g[k] == v, (k, g[k], v)


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("query", sorted(QUERIES))
def test_query_over_parquet_matches_reference(lineitem, query, path):
    conf, node = PATHS[path]
    build, cols = QUERIES[query]
    s = TorchSession(conf, device="cpu")
    q = build(TF, s.read.parquet(lineitem))
    plan = chip_smoke.quiet_plan(q)
    assert node in plan
    scan = next(line for line in plan.splitlines() if "FileScanExec" in line)
    assert sorted(scan.split("cols=[")[1].rstrip("]").split(", ")) \
        == sorted(cols)
    got = q.collect()
    _assert_rows_close(got, _reference(query, lineitem))
    assert q.collect() == got  # repeat collects are identical
    for k in FALLBACK_KEYS:
        assert s.counters[k] == 0, k
    rgs = s.counters["scan.rowGroups"]
    if path in ("decode-on", "general"):
        assert rgs == 2 * ROWS // ROW_GROUP  # every row group, twice
    else:
        assert rgs == 0
