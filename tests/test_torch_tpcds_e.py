"""TPC-DS q81-q99 of ``benchmarks/tpcds.py`` through the port on the CPU,
each held to the reference (``test_torch_tpcds.py``): the rows to its CPU
session, the physical plan to its device session's ``explain()``.

q59 (from the q41-q60 range) orders by (store name, store id, week)
and cuts at 100 rows through rows tied on those keys: any of the
tied rows is a valid answer, so it is held to the reference's
device run, row for row, rather than to its CPU session."""

import pytest

import test_torch_tpcds as T

QUERIES = [
    "q81", "q82", "q83", "q84", "q85", "q86", "q87", "q88",
    "q89", "q90", "q91", "q92", "q93", "q94", "q95", "q96",
    "q97", "q98", "q99",
]


@pytest.mark.parametrize("query", QUERIES)
def test_query_matches_reference(query):
    T.assert_query_matches(query)


def test_q59_matches_the_reference_device_run():
    T.assert_query_matches_device_run("q59")
