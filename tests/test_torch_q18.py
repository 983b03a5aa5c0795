"""TPC-H q18 (large-volume customers: a left semi join against a grouped
lineitem, an 18-byte string group key, the top 100 by price) through the
port's whole planning route, held against the JAX reference: in both
layouts of ``test_torch_tpch.py`` on the compiled star-join stage (its one
dimension, orders ⋉ big ⋈ customer, groups by its row and gathers the
string key c_name when it finalizes, with no re-run), and with the join
stage off on the broadcast semi, symmetric and broadcast joins."""

import pytest

import test_torch_tpch as T

LAYOUTS = ["cached", "benchmark", "benchmark-join-stage-off"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_q18_plan_matches_reference(layout):
    ref_plan = T.reference_plan("q18", layout)
    plan, _, _ = T.port("q18", layout)
    T.assert_same_plan(ref_plan, plan)
    stage = ("TorchCompiledJoinAggStage[keys=c_name, c_custkey, "
             "o_orderkey, o_orderdate, o_totalprice, dims=1]")
    assert (stage in plan) == (layout != "benchmark-join-stage-off")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_q18_rows_match_reference(layout):
    want, ref_reruns = T.reference_rows("q18", layout)
    _, got, counters = T.port("q18", layout)
    T.assert_rows_equal(want, got)
    assert counters["fallbackReruns"] == ref_reruns == 0
    assert any(len(r["c_name"]) > 7 for r in got)
