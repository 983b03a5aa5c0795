"""TPC-DS q41-q60 of ``benchmarks/tpcds.py`` through the port on the CPU,
each held to the reference (``test_torch_tpcds.py``): the rows to its CPU
session, the physical plan to its device session's ``explain()``.

q47 runs at 3,000 store_sales rows (``test_torch_tpcds.SMALL_ROWS``:
its reference CPU oracle takes ~27 s at 12,000 and its answer at
3,000 is still 100 rows). q59 is in ``test_torch_tpcds_e.py``."""

import pytest

import test_torch_tpcds as T

QUERIES = [
    "q41", "q42", "q43", "q44", "q45", "q46", "q47", "q48",
    "q49", "q50", "q51", "q52", "q53", "q54", "q55", "q56",
    "q57", "q58", "q60",
]


@pytest.mark.parametrize("query", QUERIES)
def test_query_matches_reference(query):
    T.assert_query_matches(query)
