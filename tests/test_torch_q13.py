"""TPC-H q13 (the distribution of customers' order counts: a left outer
join of customers to orders not LIKE '%NOT%', then two aggregations)
through the port's whole planning route, held against the JAX reference
in both layouts of ``test_torch_tpch.py``: the same plan (the symmetric
shuffled left outer join, under hash exchanges in the benchmark layout),
the same rows in order (two descending sort keys)."""

import pytest

import test_torch_tpch as T


@pytest.mark.parametrize("layout", ["cached", "benchmark"])
def test_q13_plan_matches_reference(layout):
    ref_plan = T.reference_plan("q13", layout)
    plan, _, _ = T.port("q13", layout)
    T.assert_same_plan(ref_plan, plan)
    assert "TorchShuffledSymmetricHashJoin[left]" in plan
    assert "TorchFilter[NOT o_orderpriority LIKE '%NOT%']" in plan


@pytest.mark.parametrize("layout", ["cached", "benchmark"])
def test_q13_rows_match_reference(layout):
    want, ref_reruns = T.reference_rows("q13", layout)
    _, got, counters = T.port("q13", layout)
    T.assert_rows_equal(want, got)
    assert counters["fallbackReruns"] == ref_reruns
    # the customers without an order: the outer join's null-extended rows
    assert any(r["c_count"] == 0 for r in got)
