"""UNION ALL, INTERSECT and EXCEPT through the port (``TorchUnionExec`` and
the set operations' lowering in ``session.DataFrame._set_op``: a tagged
union, a group-by over every column with the max of each tag, a filter)
held to the reference's device run on the CPU, over two frames with
duplicate rows, nulls in every column and string columns of short, long
and empty strings. Set operations treat two nulls as equal and return
distinct rows; a union keeps every row of both sides, duplicates too. The
plans must be the reference's; the rows are compared as multisets."""

import functools
import io
from collections import Counter
from contextlib import redirect_stdout

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch.memory.device import TorchDeviceManager
from spark_rapids_tpu_torch.session import TorchSession

import test_torch_tpcds as T

TorchDeviceManager.initialize(device="cpu", total_bytes=8 << 30)

WORDS = np.array(["", "a", "bb", "a much longer string", None], dtype=object)


def _columns(seed: int, n: int):
    rng = np.random.default_rng(seed)
    s = WORDS[rng.integers(0, len(WORDS), n)]
    k = rng.integers(0, 6, n).astype(np.int64)
    f = rng.integers(0, 3, n).astype(np.float64) / 2
    return ({"s": s, "k": k, "f": f},
            {"s": np.array([x is not None for x in s]),
             "k": rng.random(n) > 0.1, "f": rng.random(n) > 0.1})


def _frame(session, seed: int, n: int, host_valid: bool):
    cols, valid = _columns(seed, n)
    if host_valid:
        cols = dict(cols, s=np.array(["" if x is None else x
                                      for x in cols["s"]], dtype=object))
        return session.createDataFrame(cols, num_partitions=2,
                                       validity=valid)
    return session.createDataFrame(pa.table({
        name: pa.array([x if ok else None for x, ok in
                        zip(vals.tolist(), valid[name])])
        for name, vals in cols.items()}), num_partitions=2)


CASES = {
    "union": lambda l, r: l.union(r),
    "intersect": lambda l, r: l.intersect(r),
    "subtract": lambda l, r: l.subtract(r),
}


def _sides(session, host_valid):
    return (_frame(session, 1, 400, host_valid),
            _frame(session, 2, 300, host_valid))


@functools.lru_cache(maxsize=None)
def reference(case: str):
    s = TpuSession({"spark.rapids.sql.enabled": "true",
                    **T.REF_ONLY_OFF})
    q = CASES[case](*_sides(s, host_valid=False))
    with redirect_stdout(io.StringIO()):
        plan = q.explain()
    return plan, q.collect()


def _multiset(rows):
    return Counter(tuple(sorted(r.items())) for r in rows)


@pytest.mark.parametrize("case", sorted(CASES))
def test_set_op_matches_the_reference_device_run(case):
    ref_plan, want = reference(case)
    s = TorchSession({}, device="cpu")
    q = CASES[case](*_sides(s, host_valid=True))
    with redirect_stdout(io.StringIO()):
        plan = q.explain()
    T.assert_same_plan(ref_plan, plan)
    got = q.collect()
    assert want and _multiset(got) == _multiset(want)


def test_set_ops_are_null_safe_and_distinct():
    """INTERSECT keeps a row of nulls present on both sides, once."""
    s = TorchSession({}, device="cpu")
    mk = lambda n: s.createDataFrame(  # noqa: E731
        {"s": np.array(["", "x"] * n, dtype=object),
         "k": np.array([1, 2] * n, np.int64)},
        validity={"s": np.array([False, True] * n),
                  "k": np.array([False, True] * n)})
    got = mk(3).intersect(mk(2)).collect()
    assert sorted(got, key=str) == sorted(
        [{"s": None, "k": None}, {"s": "x", "k": 2}], key=str)
    assert mk(3).subtract(mk(1)).collect() == []
    assert len(mk(3).unionAll(mk(2)).collect()) == 10
    assert len(mk(3).union(mk(2)).distinct().collect()) == 2


def test_union_casts_a_side_to_the_union_types():
    """A union column takes its sides' wider type (Spark's
    ``WidenSetOperationTypes``); a side of another numeric type is cast to
    it (the reference keeps the first side's type and passes the other
    through uncast, Queue C C-ref-14)."""
    s = TorchSession({}, device="cpu")
    a = s.createDataFrame({"x": np.array([1, 2], np.int64)})
    b = s.createDataFrame({"x": np.array([3, -4], np.int32)})
    got = a.union(b)
    assert [r["x"] for r in got.collect()] == [1, 2, 3, -4]
    assert got._plan.output[0].dtype.simple_string() == "bigint"
    assert [r["x"] for r in b.union(a).collect()] == [3, -4, 1, 2]
