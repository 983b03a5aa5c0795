"""TPC-DS q1-q20 of ``benchmarks/tpcds.py`` through the port on the CPU,
each held to the reference (``test_torch_tpcds.py``): the rows to its CPU
session, the physical plan to its device session's ``explain()``."""

import pytest

import test_torch_tpcds as T

QUERIES = [
    "q1", "q2", "q3", "q4", "q5", "q6", "q7", "q8",
    "q9", "q10", "q11", "q12", "q13", "q14", "q15", "q16",
    "q17", "q18", "q19", "q20",
]


@pytest.mark.parametrize("query", QUERIES)
def test_query_matches_reference(query):
    T.assert_query_matches(query)
