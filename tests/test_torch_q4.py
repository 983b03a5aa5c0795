"""TPC-H q4 (orders with a late lineitem, counted by priority: a left semi
join and a 15-byte string group key) through the port's whole planning
route, held against the JAX reference in both layouts of
``test_torch_tpch.py``: the same plan (the compiled aggregation stage over a
shuffled semi join, or over a broadcast one), the same rows in order, the
same compiled-stage re-runs."""

import pytest

import test_torch_tpch as T


@pytest.mark.parametrize("layout", ["cached", "benchmark"])
def test_q4_plan_matches_reference(layout):
    ref_plan = T.reference_plan("q4", layout)
    plan, _, _ = T.port("q4", layout)
    T.assert_same_plan(ref_plan, plan)
    join = {"cached": "TorchShuffledHashJoin[leftsemi]",
            "benchmark": "TorchBroadcastHashJoin[leftsemi]"}[layout]
    assert "TorchCompiledAggStage[keys=o_orderpriority]" in plan \
        and join in plan


@pytest.mark.parametrize("layout", ["cached", "benchmark"])
def test_q4_rows_match_reference(layout):
    want, ref_reruns = T.reference_rows("q4", layout)
    _, got, counters = T.port("q4", layout)
    T.assert_rows_equal(want, got)
    assert counters["fallbackReruns"] == ref_reruns
    assert counters["fallback_runs"] == 0
