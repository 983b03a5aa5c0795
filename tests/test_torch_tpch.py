"""Shared parts of the port's TPC-H query tests (``test_torch_q4.py``,
``test_torch_q13.py``, ``test_torch_q18.py``, ``test_torch_tpch_more_*.py``):
each query through both packages at 4,096 lineitem rows (or the rows a
file asks for) in the two layouts the reference plans differently (q18
also with its join stage off), the reference's rows computed once per
process.

* ``cached``: lineitem ``device_cache()``d in one batch, every table in
  one partition (the compiled stages' shape);
* ``benchmark``: ``benchmarks/tpch.py``'s layout, lineitem and orders in
  four partitions, eight shuffle partitions, the ``ICI`` shuffle.

The reference runs ``benchmarks/tpch.py``'s query; the port runs the same
query as ``spark_rapids_tpu_torch/tpch.py`` writes it against the port (the
text ``chip_smoke.py`` runs on the card), so these tests also hold the
card's smoke run to the benchmark's queries. An intermediate result the
benchmark has no text for (``q8_parts``, ``q17_thresholds``, ...) runs the
port's text through both packages' functions."""

import functools

import numpy as np

import benchmarks.tpch as tpch
import spark_rapids_tpu.functions as RF
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import tpch as port_tpch
from spark_rapids_tpu_torch.datagen import tpch_tables
from spark_rapids_tpu_torch.session import TorchSession

#: reference passes the port has not ported, off for a like-for-like plan
REF_ONLY_OFF = {"spark.rapids.tpu.opjit.fuseStages": "false",
                "spark.rapids.tpu.coalesce.enabled": "false"}
BASE = {"spark.rapids.shuffle.mode": "ICI",
        "spark.sql.shuffle.partitions": "8"}
ROWS = 1 << 12
#: layout -> (conf, lineitem/orders partitions, device-cached lineitem);
#: the cached layout's batch holds every lineitem row
LAYOUTS = {
    "cached": ({}, 1, True),
    "benchmark": ({}, 4, False),
    "benchmark-join-stage-off": ({
        "spark.rapids.tpu.join.compiledStage.enabled": "false"}, 4, False),
}


#: layouts whose reference rows come from another layout over the same
#: tables (the generated data depends on the partition count, not on the
#: conf): the reference compiles for 7-17 s a query and layout on the CPU.
#: With the join stage off q18 plans no stage, so it cannot re-run.
ROWS_FROM = {"benchmark-join-stage-off": "benchmark"}


def _conf(layout: str, rows: int) -> dict:
    conf, _, cached = LAYOUTS[layout]
    if cached:
        conf = dict(conf, **{"spark.rapids.sql.batchSizeRows": str(rows)})
    return dict(BASE, **conf)


def _reference_query(query: str, layout: str, rows: int):
    _, parts, cached = LAYOUTS[layout]
    s = TpuSession(dict(_conf(layout, rows), **REF_ONLY_OFF))
    t = tpch.load_tables(s, rows, parts=parts)
    if cached:
        t["lineitem"] = t["lineitem"].device_cache()
    if query in tpch.QUERIES:
        return s, tpch.QUERIES[query](s, t)
    return s, getattr(port_tpch, query)(t, RF)


@functools.lru_cache(maxsize=None)
def reference_plan(query: str, layout: str, rows: int = ROWS) -> str:
    """The reference's ``explain()`` (planning only)."""
    return _reference_query(query, layout, rows)[1].explain()


@functools.lru_cache(maxsize=None)
def reference_rows(query: str, layout: str, rows: int = ROWS):
    """(rows, fallbackReruns) of the reference's run (in the ``ROWS_FROM``
    layout where there is one)."""
    if layout in ROWS_FROM:
        out, _ = reference_rows(query, ROWS_FROM[layout], rows)
        assert "CompiledJoinAggStage" not in reference_plan(query, layout,
                                                            rows)
        return out, 0
    s, q = _reference_query(query, layout, rows)
    out = q.collect()
    return out, sum(m.get("fallbackReruns", 0)
                    for m in s.last_query_metrics("DEBUG").values())


def port(query: str, layout: str, rows: int = ROWS):
    """(explain, rows, the session's counters) of the port on the CPU."""
    _, parts, cached = LAYOUTS[layout]
    s = TorchSession(_conf(layout, rows), device="cpu")
    t = tpch_tables(s, rows, parts)
    if cached:
        t["lineitem"] = t["lineitem"].device_cache()
    q = getattr(port_tpch, query)(t)
    return q.explain(), q.collect(), s.counters


def physical(plan: str):
    """The physical plan's operator lines, reference names mapped."""
    tree = plan.split("== Physical Plan ==")[-1]
    return [ln.replace("Tpu", "Torch").rstrip() for ln in tree.splitlines()
            if ln.strip() and not ln.startswith("planCache")]


def assert_same_plan(ref_plan: str, plan: str) -> None:
    """The same physical tree (Tpu → Torch) and the same optimized logical
    plan."""
    assert physical(plan) == physical(ref_plan)
    assert plan.split("== Physical Plan ==")[0] == \
        ref_plan.split("== Physical Plan ==")[0].split("\n", 1)[1]


def assert_rows_equal(want, got) -> None:
    """The same rows in the same order: every value exact but floats,
    which agree within rtol 1e-9."""
    assert len(got) == len(want) and want
    for w, g in zip(want, got):
        assert list(g) == list(w)
        for k in w:
            if isinstance(w[k], float):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-9)
            else:
                assert g[k] == w[k], (k, g, w)


def assert_query_matches(query: str, layout: str, rows: int = ROWS) -> None:
    """The port's plan, rows and re-runs are the reference's, which has
    rows."""
    ref_plan = reference_plan(query, layout, rows)
    want, ref_reruns = reference_rows(query, layout, rows)
    plan, got, counters = port(query, layout, rows)
    assert_same_plan(ref_plan, plan)
    assert_rows_equal(want, got)
    # the compiled aggregation and join stages' re-runs on the general path
    assert counters["fallback_runs"] + counters["fallbackReruns"] \
        == ref_reruns
