"""The shuffled hash join's sub-partitioning held against the JAX
reference: past ``batchSizeRows`` both sides split by the same key hash
(seed 100) and the pairs join in part order, so the port's rows come out
in the reference's order. Below the limit nothing splits.

The input is the smallest one that showed the order differ before the
split was ported: left rows ``{a: i % 5, v: i}`` for i < 8, right rows
``{b: i % 5, w: 10 i}`` for i < 6, broadcasting off. Rows must match
exactly and in order."""

import functools

import pytest

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.memory.device import TorchDeviceManager

# the CPU has no device memory to read: the tests state one for the
# budget (spark.rapids.memory.device.totalBytes)
TorchDeviceManager.initialize(device="cpu", total_bytes=8 << 30)

BASE = {"spark.sql.autoBroadcastJoinThreshold": "-1"}


def _join(session, how: str):
    left = session.createDataFrame([{"a": i % 5, "v": float(i)}
                                    for i in range(8)])
    right = session.createDataFrame([{"b": i % 5, "w": 10 * i}
                                     for i in range(6)])
    return left.join(right, left["a"] == right["b"], how)


def _rows(df):
    return [tuple(r[k] for k in ("a", "v", "b", "w")) for r in df.collect()]


@functools.lru_cache(maxsize=None)
def _reference(how: str, batch_rows: int):
    return _rows(_join(TpuSession(
        {**BASE, "spark.rapids.sql.batchSizeRows": str(batch_rows)}), how))


@pytest.mark.parametrize("batch_rows", [4, 1024], ids=["split", "whole"])
@pytest.mark.parametrize("how", ["inner", "left", "full"])
def test_shuffled_join_rows_in_reference_order(how, batch_rows):
    s = TorchSession({**BASE,
                      "spark.rapids.sql.batchSizeRows": str(batch_rows)},
                     device="cpu")
    df = _join(s, how)
    assert "TorchShuffledSymmetricHashJoin" in df.explain()
    assert _rows(df) == _reference(how, batch_rows)


def test_split_changes_order_only_past_batch_rows():
    """The split is what moves the order: the two limits give the same
    multiset of rows in different orders."""
    split, whole = _reference("inner", 4), _reference("inner", 1024)
    assert sorted(split) == sorted(whole) and split != whole
