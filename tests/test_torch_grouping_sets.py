"""Grouping sets through the port (``GroupedData._agg_grouping_sets``:
Expand, then Aggregate, then Project; ``execs/generate.TorchExpandExec``)
held to the reference's device run on the CPU: ``rollup``, ``cube`` and
``groupingSets`` with ``grouping()`` and ``grouping_id()``, over string
keys and an integer key that hold real nulls in the data, which
``grouping()`` must tell from the rolled-up nulls. The aggregates see the
real values, not the nulled key copies. The plans must be the reference's
(``Tpu`` read as ``Torch``); integers, strings and nulls exact, floats
within rtol 1e-9."""

import functools
import io
from contextlib import redirect_stdout

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu.functions as RF
from spark_rapids_tpu.session import TpuSession
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu_torch.memory.device import TorchDeviceManager
from spark_rapids_tpu_torch.session import TorchSession

import test_torch_tpcds as T

TorchDeviceManager.initialize(device="cpu", total_bytes=8 << 30)

N = 2_000


def _columns():
    rng = np.random.default_rng(11)
    a = np.array([f"cat{v}" for v in rng.integers(0, 5, N)], dtype=object)
    b = np.array(["", "x", "longer than seven", "y"], dtype=object)[
        rng.integers(0, 4, N)]
    c = rng.integers(0, 4, N).astype(np.int32)
    v = np.round(rng.normal(size=N) * 10, 3)
    return ({"a": a, "b": b, "c": c, "v": v, "q": rng.integers(0, 9, N)},
            {"a": rng.random(N) > 0.05, "b": rng.random(N) > 0.1,
             "c": rng.random(N) > 0.05, "v": rng.random(N) > 0.05})


def _frame(session, host_valid: bool):
    cols, valid = _columns()
    if host_valid:
        return session.createDataFrame(cols, num_partitions=2,
                                       validity=valid)
    arrays = {}
    for name, vals in cols.items():
        ok = valid.get(name, np.ones(N, bool))
        arrays[name] = pa.array([x if k else None for x, k in
                                 zip(vals.tolist(), ok)],
                                type=pa.string() if vals.dtype == object
                                else None)
    arrays["c"] = arrays["c"].cast(pa.int32())
    return session.createDataFrame(pa.table(arrays), num_partitions=2)


def _rollup(F, df):
    return df.rollup("a", "b").agg(
        F.sum("v").alias("s"), F.count_star().alias("n"),
        F.grouping("a").alias("ga"), F.grouping("b").alias("gb"),
        F.grouping_id().alias("gid"))


def _cube(F, df):
    return df.cube("a", "c").agg(F.avg("v").alias("m"),
                                 F.max("q").alias("mq"),
                                 F.grouping_id().alias("gid"))


def _sets(F, df):
    return df.groupingSets([["a"], ["b", "c"], []], "a", "b", "c").agg(
        F.sum("q").alias("sq"), F.min("v").alias("mn"),
        F.grouping("c").alias("gc"))


CASES = {"rollup": _rollup, "cube": _cube, "groupingSets": _sets}


@functools.lru_cache(maxsize=None)
def reference(case: str):
    s = TpuSession({"spark.rapids.sql.enabled": "true",
                    **T.REF_ONLY_OFF})
    q = CASES[case](RF, _frame(s, host_valid=False))
    with redirect_stdout(io.StringIO()):
        plan = q.explain()
    return plan, q.collect()


def _key(r):
    return tuple((v is None, str(v)) for v in r.values())


@pytest.mark.parametrize("case", sorted(CASES))
def test_grouping_sets_match_the_reference_device_run(case):
    ref_plan, want = reference(case)
    s = TorchSession({}, device="cpu")
    q = CASES[case](PF, _frame(s, host_valid=True))
    with redirect_stdout(io.StringIO()):
        plan = q.explain()
    T.assert_same_plan(ref_plan, plan)
    assert "TorchExpand[" in plan
    T.assert_rows_equal(sorted(want, key=_key),
                        sorted(q.collect(), key=_key), case)


def test_rolled_up_null_differs_from_a_null_key():
    """A null in the data and a rolled-up null are different groups:
    ``grouping()`` is 0 for the first and 1 for the second."""
    s = TorchSession({}, device="cpu")
    got = _rollup(PF, _frame(s, host_valid=True)).collect()
    null_b = [(r["gb"], r["gid"]) for r in got
              if r["a"] == "cat0" and r["b"] is None]
    assert sorted(null_b) == [(0, 0), (1, 1)]
    total = [r for r in got if r["gid"] == 3]
    assert len(total) == 1 and total[0]["n"] == N
