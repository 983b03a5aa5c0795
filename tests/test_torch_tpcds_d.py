"""TPC-DS q61-q80 of ``benchmarks/tpcds.py`` through the port on the CPU,
each held to the reference (``test_torch_tpcds.py``): the rows to its CPU
session, the physical plan to its device session's ``explain()``."""

import pytest

import test_torch_tpcds as T

QUERIES = [
    "q61", "q62", "q63", "q64", "q65", "q66", "q67", "q68",
    "q69", "q70", "q71", "q72", "q73", "q74", "q75", "q76",
    "q77", "q78", "q79", "q80",
]


@pytest.mark.parametrize("query", QUERIES)
def test_query_matches_reference(query):
    T.assert_query_matches(query)
