"""Every hash-join type of the port held against the JAX reference's join
execs over the same batches: inner, left/right/full outer, left semi and
left anti, each with and without a residual condition, on the broadcast,
the shuffled and the symmetric shuffled join (which builds on its smaller
side and mirrors an outer join to do so), with an empty left or right
side, and on string keys of 0–40 bytes (shared prefixes, embedded NULs,
non-ASCII, nulls).

Rows must match exactly and in the reference's order: the pairs
probe-major, then the unmatched left rows, then the unmatched right rows.
Each reference result is computed once for all join types of a case."""

import functools

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.config import RapidsConf as RefConf
from spark_rapids_tpu.execs.base import TaskContext as RefTaskContext
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.execs.base import TaskContext
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.memory.device import TorchDeviceManager

# the CPU has no device memory to read: the tests state one for the
# budget (spark.rapids.memory.device.totalBytes)
TorchDeviceManager.initialize(device="cpu", total_bytes=8 << 30)

ALL_TYPES = ("inner", "leftouter", "rightouter", "fullouter", "leftsemi",
             "leftanti")
#: Spark's BuildRight types: what a broadcast of the right side supports
BROADCAST_TYPES = ("inner", "leftouter", "leftsemi", "leftanti")


def _words(rng, n: int):
    """Strings of 0–40 bytes from a small vocabulary of stems (so both
    sides share keys), with shared prefixes, NULs and non-ASCII."""
    stems = ["", "a", "customer#000000", "customer#0000001",
             "customer#00000012", "日本語テキスト", "x\x00y", "x\x00",
             "Brand#13 PROMO BRUSHED TIN", "é" * 20, "z" * 40]
    idx = rng.integers(0, len(stems), n)
    tails = rng.integers(0, 3, n)
    return [stems[i] + ("" if t == 0 else str(t)) for i, t in
            zip(idx, tails)]


@functools.lru_cache(maxsize=None)
def _tables(kind: str):
    """(left, right) Arrow tables. Keys repeat on both sides (fan-out) and
    hold nulls; ``lv < rv`` is the residual condition (nulls included).
    The symmetric case swaps the two tables, so its left is the smaller
    side and it flips: it then joins the very batches the others do, and
    the reference compiles its programs once for all cases."""
    if kind == "symmetric":
        left, right = _tables("shuffled")
        return (right.rename_columns(left.column_names),
                left.rename_columns(right.column_names))
    rng = np.random.default_rng(17)
    n_l, n_r = 120, 100
    left = pa.table({
        "lk": pa.array(rng.integers(0, 60, n_l), mask=rng.random(n_l) < 0.1),
        "lv": pa.array(rng.uniform(0, 1, n_l), mask=rng.random(n_l) < 0.1),
        "ls": pa.array(_words(rng, n_l), mask=rng.random(n_l) < 0.1)})
    right = pa.table({
        "rk": pa.array(rng.integers(0, 70, n_r).astype(np.int32),
                       mask=rng.random(n_r) < 0.1),
        "rv": pa.array(rng.uniform(0, 1, n_r), mask=rng.random(n_r) < 0.1),
        "rs": pa.array(_words(rng, n_r), mask=rng.random(n_r) < 0.1)})
    return left, right


def _sides(mod: str, kind: str, empty: str):
    """The package's physical plans of the two tables (host scans under an
    upload), one partition each: every kind then joins batches of the same
    shapes, so the reference compiles its programs once for all kinds (the
    stream side's partitions are probed one by one, as q4 and q18 do)."""
    if mod == "ref":
        from spark_rapids_tpu.execs.transitions import HostToDeviceExec
        from spark_rapids_tpu.plan.planner import plan_physical
        s, conf = TpuSession(), RefConf()
    else:
        from spark_rapids_tpu_torch.execs.transitions import HostToDeviceExec
        from spark_rapids_tpu_torch.plan.planner import plan_physical
        s, conf = TorchSession(device="cpu"), RapidsConf()
    left, right = _tables(kind)
    if empty == "left":
        left = left.slice(0, 0)
    if empty == "right":
        right = right.slice(0, 0)
    return [HostToDeviceExec(plan_physical(
        s.createDataFrame(t)._plan, conf)) for t in (left, right)]


def _exec(mod: str, kind: str, sides, jt: str, keys: str, cond: bool):
    """The join exec of ``kind`` over the sides: keys lk = rk (an int32 key
    widened to meet the int64 one) or ls = rs; residual ``lv < rv``."""
    l, r = sides
    if mod == "ref":
        from spark_rapids_tpu.execs.broadcast import \
            TpuBroadcastHashJoinExec as Bcast
        from spark_rapids_tpu.execs.joins import (
            TpuShuffledHashJoinExec as Shuffled,
            TpuShuffledSymmetricHashJoinExec as Symmetric)
        from spark_rapids_tpu.expressions.base import AttributeReference
        from spark_rapids_tpu.expressions.predicates import LessThan
        from spark_rapids_tpu.session import _coerce_join_keys
    else:
        from spark_rapids_tpu_torch.execs.broadcast import \
            TorchBroadcastHashJoinExec as Bcast
        from spark_rapids_tpu_torch.execs.joins import (
            TorchShuffledHashJoinExec as Shuffled,
            TorchShuffledSymmetricHashJoinExec as Symmetric)
        from spark_rapids_tpu_torch.expressions.base import \
            AttributeReference
        from spark_rapids_tpu_torch.expressions.predicates import LessThan
        from spark_rapids_tpu_torch.session import _coerce_join_keys
    at = 2 if keys == "string" else 0
    lk, rk = _coerce_join_keys([l.output[at]], [r.output[at]])
    condition = LessThan(l.output[1], r.output[1]) if cond else None

    def nullable(attrs, outer: bool):
        return [AttributeReference(a.name, a.dtype, True, expr_id=a.expr_id)
                if outer else a for a in attrs]

    # the logical join's output: an outer join's other side nullable, a
    # semi or anti join the left side alone
    output = list(l.output) if jt in ("leftsemi", "leftanti") else (
        nullable(l.output, jt in ("rightouter", "fullouter"))
        + nullable(r.output, jt in ("leftouter", "fullouter")))
    args = (l, r, jt, lk, rk, condition, output)
    if kind == "broadcast":
        return Bcast(*args)
    return (Symmetric if kind == "symmetric" else Shuffled)(
        *args, per_partition=False)


def _rows(mod: str, node):
    out = []
    for p in range(node.num_partitions()):
        if mod == "ref":
            for b in node.execute_partition(p, RefTaskContext(p, RefConf())):
                out.extend(b.to_arrow().to_pylist())
        else:
            for b in node.execute_partition(p, TaskContext(
                    p, RapidsConf(), torch.device("cpu"))):
                out.extend(b.to_host().to_pylist())
    return out


def _canon(rows):
    return [{k: ("nan" if isinstance(v, float) and v != v else v)
             for k, v in r.items()} for r in rows]


@functools.lru_cache(maxsize=None)
def _reference(kind: str, keys: str, cond: bool, empty: str):
    """The reference's rows for every join type of one case."""
    types = BROADCAST_TYPES if kind == "broadcast" else ALL_TYPES
    sides = _sides("ref", kind, empty)
    return {jt: _rows("ref", _exec("ref", kind, sides, jt, keys, cond))
            for jt in types}


CASES = [(kind, "int", cond, empty, jt)
         for kind in ("broadcast", "shuffled", "symmetric")
         for cond in (False, True)
         for empty in ("none", "left", "right")
         for jt in (BROADCAST_TYPES if kind == "broadcast" else ALL_TYPES)]
CASES += [("shuffled", "string", cond, "none", jt)
          for cond in (False, True) for jt in ALL_TYPES]


@pytest.mark.parametrize(
    "kind,keys,cond,empty,jt", CASES,
    ids=[f"{k}-{key}-{'cond' if c else 'nocond'}-{e}-{jt}"
         for k, key, c, e, jt in CASES])
def test_join_type_matches_reference_in_order(kind, keys, cond, empty, jt):
    want = _reference(kind, keys, cond, empty)[jt]
    got = _rows("port", _exec("port", kind, _sides("port", kind, empty), jt,
                              keys, cond))
    assert _canon(got) == _canon(want)
    if empty == "none" and jt in ("inner", "leftsemi", "leftanti"):
        assert want  # the case joins something


def test_symmetric_outer_join_flips_and_mirrors():
    """The symmetric join's left is the smaller side here, so an outer join
    builds on it under the mirrored type (left outer → right outer) and
    puts its columns back; semi and anti joins keep their orientation."""
    from spark_rapids_tpu_torch.execs.joins import _MIRROR_JOIN
    sides = _sides("port", "symmetric", "none")
    node = _exec("port", "symmetric", sides, "leftouter", "int", False)
    assert node._twin is not None and node._twin.join_type == "rightouter"
    assert _MIRROR_JOIN["fullouter"] == "fullouter"
    for jt in ("leftsemi", "leftanti"):
        assert _exec("port", "symmetric", sides, jt, "int",
                     False)._twin is None
