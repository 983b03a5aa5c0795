"""TPC-H q5, q10, q12, q14, q17 and q19 (the new tables, CASE WHEN inside
sums, the five-way join down the region axis) through the port's whole
planning route, held against the JAX reference in both layouts of
``test_torch_tpch.py``: the same physical and optimized logical plan, the
same rows in order, the same re-runs.

At 4,096 and 20,000 lineitem rows q17's answer is null in both packages
(no part is Brand#23 in a MED BOX, so nothing passes its per-part
threshold); at 40,000 one part is and three of its lineitems pass, so
q17 and its intermediates (the per-part thresholds, the rows under them)
run there. q19's answer is null at 4,096 and 20,000 rows (no lineitem
meets one of its brackets), so the rows that meet its common predicate
are held by brand too."""

import pytest

import test_torch_tpch as T

Q17_ROWS = 40_000


@pytest.mark.parametrize("layout", ["cached", "benchmark"])
@pytest.mark.parametrize("query", ["q5", "q10", "q12", "q14", "q19",
                                   "q19_brands"])
def test_query_matches_reference(query, layout):
    T.assert_query_matches(query, layout)


@pytest.mark.parametrize("layout", ["cached", "benchmark"])
@pytest.mark.parametrize("query", ["q17", "q17_thresholds", "q17_passing"])
def test_q17_matches_reference(query, layout):
    T.assert_query_matches(query, layout, Q17_ROWS)


@pytest.mark.parametrize("layout", ["cached", "benchmark"])
def test_q17_sums_the_rows_under_their_threshold(layout):
    """q17's answer is the passing rows' price over 7, not null."""
    _, passing, _ = T.port("q17_passing", layout, Q17_ROWS)
    _, got, _ = T.port("q17", layout, Q17_ROWS)
    assert passing and got[0]["avg_yearly"] == pytest.approx(
        sum(r["l_extendedprice"] for r in passing) / 7.0, rel=1e-12)


def test_q12_sums_case_when_ints_into_longs():
    """``sum(when(high, 1).otherwise(0))`` is a long count."""
    _, got, _ = T.port("q12", "benchmark")
    assert all(isinstance(r["high_line_count"], int)
               and isinstance(r["low_line_count"], int) for r in got)
    assert sum(r["high_line_count"] + r["low_line_count"] for r in got) > 0
