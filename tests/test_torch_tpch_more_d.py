"""TPC-H q11, q15 and q22 (cross joins with one-row aggregates on the
broadcast nested loop join, round, substring and a string IN) through
the port's whole planning route at 4,096 lineitem rows, held against the
JAX reference in both layouts of ``test_torch_tpch.py``; and every one of
the 22 queries plans wholly on the device in both layouts."""

import io
from contextlib import redirect_stdout

import pytest

import test_torch_tpch as T
from spark_rapids_tpu_torch import tpch
from spark_rapids_tpu_torch.datagen import tpch_tables
from spark_rapids_tpu_torch.session import TorchSession


@pytest.mark.parametrize("layout", ["cached", "benchmark"])
@pytest.mark.parametrize("query", ["q11", "q15", "q22"])
def test_query_matches_reference(query, layout):
    T.assert_query_matches(query, layout)


@pytest.mark.parametrize("layout", ["cached", "benchmark"])
def test_q15_runs_agree(layout):
    """q15 selects by float equality after round(sum, 2): two runs give
    the same supplier."""
    first = T.port("q15", layout)[1]
    assert first and T.port("q15", layout)[1] == first


@pytest.mark.parametrize("layout", ["cached", "benchmark"])
def test_every_query_plans_on_the_device(layout):
    """No ``Cpu*`` operator but the table scans under their uploads, and
    nothing the override engine keeps on the host."""
    _, parts, cached = T.LAYOUTS[layout]
    s = TorchSession(T._conf(layout, 1 << 10), device="cpu")
    t = tpch_tables(s, 1 << 10, parts)
    if cached:
        t["lineitem"] = t["lineitem"].device_cache()
    for name, query in tpch.QUERIES.items():
        q = query(t)
        with redirect_stdout(io.StringIO()):
            lines = T.physical(q.explain())
        for above, line in zip(lines, lines[1:]):
            if "Cpu" in line:
                assert line.strip() == "CpuLocalTableScanExec" \
                    and above.strip() == "* HostToDeviceExec", (name, line)
        reasons = q.explain_fallback().splitlines()
        assert reasons == ["The whole plan can run on the TPU"] or all(
            "CpuLocalTableScanExec" in r for r in reasons), (name, reasons)
