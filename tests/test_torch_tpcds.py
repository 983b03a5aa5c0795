"""Shared parts of the port's TPC-DS query tests
(``test_torch_tpcds_a.py`` ... ``_e.py``), and the 22 TPC-DS tables of
``datagen.tpcds_host_tables`` held to the tables of the reference's
``benchmarks/tpcds.load_tables``, column for column and value for value,
with the same row and partition counts, at 12,000 store_sales rows in one
and in four partitions.

Each query runs as ``benchmarks/tpcds.py`` lays it out: ``load_tables(s,
rows, parts=4)``, four shuffle partitions, the ``ICI`` shuffle. The port
runs ``spark_rapids_tpu_torch/tpcds.py``'s text (the one ``chip_smoke.py``
runs on the card) on the CPU, and is held to:

* the reference's CPU session (``spark.rapids.sql.enabled=false``, its own
  independent host engine) on the rows, with ``tests/test_tpcds.py``'s
  canonical compare: rows sorted, floats rounded to 4 places, then equal
  within ``rel=1e-4, abs=1e-4``;
* the reference device session's ``explain()`` on the plan, node for node
  (``Tpu`` read as ``Torch``), with the reference passes the port has not
  ported switched off (``REF_ONLY_OFF``, as ``test_torch_tpch.py``).

Each reference answer is computed once a process. A query whose answer at
a LIMIT is one of several valid ones (ties straddling the cut) is held to
the reference's device run instead, row for row."""

import functools
import io
import math
from contextlib import redirect_stdout

import numpy as np
import pytest

import benchmarks.tpcds as tpcds
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import tpcds as port_tpcds
from spark_rapids_tpu_torch.columnar.batch import TorchColumnarBatch
from spark_rapids_tpu_torch.datagen import (TPCDS_TABLES, tpcds_date_dim,
                                            tpcds_specs)
from spark_rapids_tpu_torch.memory.device import TorchDeviceManager
from spark_rapids_tpu_torch.serving.scheduler import QueryScheduler
from spark_rapids_tpu_torch.types import from_arrow

# the CPU has no device memory to read: the tests state one for the
# budget (spark.rapids.memory.device.totalBytes)
TorchDeviceManager.initialize(device="cpu", total_bytes=8 << 30)

#: reference passes the port has not ported, off for a like-for-like plan
REF_ONLY_OFF = {"spark.rapids.tpu.opjit.fuseStages": "false",
                "spark.rapids.tpu.coalesce.enabled": "false"}
ROWS = 12_000
#: q47's reference CPU oracle takes ~27 s at 12,000 rows (its per-partition
#: window loop); at 3,000 rows it takes ~1.2 s and still returns 100 rows
SMALL_ROWS = {"q47": 3_000}


def query_rows(query: str) -> int:
    return SMALL_ROWS.get(query, ROWS)


@functools.lru_cache(maxsize=None)
def _reference_cpu(rows: int):
    s = tpcds.make_session(tpu=False)
    return s, tpcds.load_tables(s, rows)


@functools.lru_cache(maxsize=None)
def _reference_device(rows: int):
    s = TpuSession({"spark.rapids.sql.enabled": "true",
                    "spark.rapids.shuffle.mode": "ICI",
                    "spark.sql.shuffle.partitions": "4", **REF_ONLY_OFF})
    return s, tpcds.load_tables(s, rows)


@functools.lru_cache(maxsize=None)
def _port(rows: int):
    s = port_tpcds.make_session("cpu")
    return s, port_tpcds.load_tables(s, rows)


@functools.lru_cache(maxsize=None)
def reference_rows(query: str, rows: int):
    """(column names, rows) of the reference's CPU session."""
    s, t = _reference_cpu(rows)
    out = tpcds.QUERIES[query](s, t).to_arrow()
    return out.column_names, out.to_pylist()


@functools.lru_cache(maxsize=None)
def reference_device_rows(query: str, rows: int):
    s, t = _reference_device(rows)
    return tpcds.QUERIES[query](s, t).collect()


@functools.lru_cache(maxsize=None)
def reference_plan(query: str, rows: int) -> str:
    """The reference device session's ``explain()`` (planning only)."""
    s, t = _reference_device(rows)
    with redirect_stdout(io.StringIO()):
        return tpcds.QUERIES[query](s, t).explain()


def port(query: str, rows: int):
    """(explain, column names, rows) of the port on the CPU. The plan cache
    is cleared first: the reference plans each query fresh (``miss``),
    while a query the port ran before (q38 and q87 differ in a literal
    only) would be a ``hit``."""
    s, t = _port(rows)
    q = port_tpcds.QUERIES[query](s, t)
    QueryScheduler.get().plan_cache.clear()
    with redirect_stdout(io.StringIO()):
        plan = q.explain()
    return plan, q.columns, q.collect()


def physical(plan: str):
    """The physical plan's operator lines, reference names mapped."""
    tree = plan.split("== Physical Plan ==")[-1]
    return [ln.replace("Tpu", "Torch").rstrip() for ln in tree.splitlines()
            if ln.strip() and not ln.startswith("planCache")]


def assert_same_plan(ref_plan: str, plan: str) -> None:
    """The same physical tree, plan-cache verdict and (where an optimizer
    rule applied) optimized logical plan."""
    assert physical(plan) == physical(ref_plan)
    assert plan.splitlines()[0] == ref_plan.splitlines()[0]
    if "== Physical Plan ==" in ref_plan:
        assert plan.split("== Physical Plan ==")[0] == \
            ref_plan.split("== Physical Plan ==")[0]


def canon(columns, rows):
    """``tests/test_tpcds.py``'s sort-insensitive canonical form: columns
    by name, floats rounded to 4 places, rows sorted with nulls low."""
    cols = sorted(columns)
    out = [tuple(round(r[c], 4) if isinstance(r[c], float) else r[c]
                 for c in cols) for r in rows]
    none_low = [tuple((x is None, x if x is not None else 0) for x in r)
                for r in out]
    return [out[i] for i in np.argsort(np.array([str(r)
                                                 for r in none_low]))]


def assert_rows_match(want_cols, want, got_cols, got, name: str) -> None:
    assert want, f"{name}: the reference returned no rows"
    assert len(got) == len(want), f"{name}: {len(got)} vs {len(want)} rows"
    assert sorted(got_cols) == sorted(want_cols)
    for g, w in zip(canon(got_cols, got), canon(want_cols, want)):
        for gv, wv in zip(g, w):
            if isinstance(gv, float) and isinstance(wv, float):
                assert gv == pytest.approx(wv, rel=1e-4, abs=1e-4) or (
                    math.isnan(gv) and math.isnan(wv)), f"{name}: {g} != {w}"
            else:
                assert gv == wv, f"{name}: {g} != {w}"


def assert_rows_equal(want, got, name: str) -> None:
    """The same rows in the same order: every value exact but floats,
    within rtol 1e-9."""
    assert want and len(got) == len(want), name
    for w, g in zip(want, got):
        assert list(g) == list(w), name
        for k in w:
            if isinstance(w[k], float):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-9)
            else:
                assert g[k] == w[k], (name, k, g, w)


def assert_query_matches(query: str) -> None:
    """The port's plan is the reference device session's, and its rows
    the reference CPU session's."""
    rows = query_rows(query)
    plan, cols, got = port(query, rows)
    assert_same_plan(reference_plan(query, rows), plan)
    want_cols, want = reference_rows(query, rows)
    assert_rows_match(want_cols, want, cols, got, query)


def assert_query_matches_device_run(query: str) -> None:
    """A query whose LIMIT cuts through tied rows: the plan is held as
    above, the rows to the reference's device run, in order."""
    rows = query_rows(query)
    plan, _, got = port(query, rows)
    assert_same_plan(reference_plan(query, rows), plan)
    assert_rows_equal(reference_device_rows(query, rows), got, query)


# ---------------------------------------------------------------------------
# the 22 tables
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reference_tables(rows: int, parts: int):
    """``benchmarks/tpcds.load_tables``' own tables: each one's Arrow table
    and partition count, as that benchmark lays them out."""
    s = TpuSession({"spark.rapids.sql.enabled": "false"})
    return {name: (df._plan.table, df._plan.num_partitions)
            for name, df in tpcds.load_tables(s, rows, parts).items()}


@pytest.mark.parametrize("parts", [1, 4])
@pytest.mark.parametrize("name", TPCDS_TABLES)
def test_table_equals_the_reference(name, parts):
    """Every column of the port's table is the reference's: the same
    names, types, values and nulls, in the same order."""
    spec, n, p = tpcds_specs(ROWS, parts)[name]
    cols, valid = tpcds_date_dim(n) if spec is None \
        else spec.generate(42, n, p)
    got = TorchColumnarBatch.from_numpy_columns(cols, valid)
    want, want_parts = _reference_tables(ROWS, parts)[name]
    assert p == want_parts, name
    assert got.names == want.column_names
    assert got.num_rows == want.num_rows == n
    for c, name_, arr in zip(got.columns, want.column_names, want.columns):
        assert c.dtype == from_arrow(arr.type), name_
        assert c.to_pylist() == arr.to_pylist(), name_
