"""TPC-DS q21-q40 of ``benchmarks/tpcds.py`` through the port on the CPU,
each held to the reference (``test_torch_tpcds.py``): the rows to its CPU
session, the physical plan to its device session's ``explain()``."""

import pytest

import test_torch_tpcds as T

QUERIES = [
    "q21", "q22", "q23", "q24", "q25", "q26", "q27", "q28",
    "q29", "q30", "q31", "q32", "q33", "q34", "q35", "q36",
    "q37", "q38", "q39", "q40",
]


@pytest.mark.parametrize("query", QUERIES)
def test_query_matches_reference(query):
    T.assert_query_matches(query)
