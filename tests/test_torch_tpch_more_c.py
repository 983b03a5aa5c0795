"""TPC-H q16, q20 and q21 (distinct as a keys-only aggregate, IN lists,
semi and anti joins, the compiled aggregation stage's re-run past
maxGroups) through the port's whole planning route at 20,000 lineitem
rows, held against the JAX reference in both layouts of
``test_torch_tpch.py``. At 4,096 rows q21 returns no rows in the
reference."""

import pytest

import test_torch_tpch as T

ROWS = 20_000


@pytest.mark.parametrize("layout", ["cached", "benchmark"])
@pytest.mark.parametrize("query", ["q16", "q20", "q21"])
def test_query_matches_reference(query, layout):
    T.assert_query_matches(query, layout, ROWS)
