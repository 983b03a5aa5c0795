"""TPC-H q2, q7, q8 and q9 (casts of dates to years, the nation
self-join through aliased projections, select, LIKE over part names)
through the port's whole planning route at 20,000 lineitem rows, held
against the JAX reference in both layouts of ``test_torch_tpch.py``.
At 4,096 rows q8 returns no rows in the reference; at 20,000 it returns
two, whose market share is 0.0, so each year's numerator and denominator
(``q8_parts``) are held too."""

import pytest

import test_torch_tpch as T

ROWS = 20_000


@pytest.mark.parametrize("layout", ["cached", "benchmark"])
@pytest.mark.parametrize("query", ["q2", "q7", "q8", "q8_parts", "q9"])
def test_query_matches_reference(query, layout):
    T.assert_query_matches(query, layout, ROWS)


@pytest.mark.parametrize("layout", ["cached", "benchmark"])
def test_q8_denominator_is_not_zero(layout):
    _, got, _ = T.port("q8_parts", layout, ROWS)
    assert got and all(r["volume"] > 0 for r in got)
