"""The q3 slice's building blocks held against the JAX reference: the data
generator, Spark's murmur3 and the hash partition ids, the hash exchange,
string comparisons and the hash joins.

The same seed-made inputs go through both packages (the port with
``device="cpu"``); integers, strings, partition ids and row order must
match exactly, floats within rtol 1e-9."""

import functools

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu_torch.functions as TF
from spark_rapids_tpu import datagen as RD
from spark_rapids_tpu.columnar.batch import TpuColumnarBatch
from spark_rapids_tpu.execs.base import TaskContext as RefTaskContext
from spark_rapids_tpu.config import RapidsConf as RefConf
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import datagen as TD
from spark_rapids_tpu_torch.columnar.batch import TorchColumnarBatch
from spark_rapids_tpu_torch.columnar.vector import HostStrings
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.execs.base import TaskContext
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.memory.device import TorchDeviceManager

# the CPU has no device memory to read: the tests state one for the
# budget (spark.rapids.memory.device.totalBytes)
TorchDeviceManager.initialize(device="cpu", total_bytes=8 << 30)

#: reference passes the port has not ported, off for a like-for-like plan
REF_ONLY_OFF = {"spark.rapids.tpu.opjit.fuseStages": "false",
                "spark.rapids.tpu.coalesce.enabled": "false"}

SPECS = {"lineitem": (RD.tpch_lineitem, TD.tpch_lineitem),
         "orders": (RD.tpch_orders, TD.tpch_orders),
         "customer": (RD.tpch_customer, TD.tpch_customer)}


def _host_column_values(v):
    """A port host column as the Python values Arrow's to_pylist gives."""
    if isinstance(v, HostStrings):
        offs, raw = v.offsets.astype(np.int64), v.chars.tobytes()
        return [raw[offs[i]:offs[i + 1]].decode() for i in range(len(v))]
    return v


# ---------------------------------------------------------------------------
# datagen
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("table", sorted(SPECS))
@pytest.mark.parametrize("n,parts", [(1000, 1), (1000, 3), (4099, 1),
                                     (4099, 3)])
def test_datagen_tables_equal_reference(table, n, parts):
    ref_spec, port_spec = SPECS[table]
    want = ref_spec(n).generate(42, n, parts)
    got, valid = port_spec(n).generate(42, n, parts)
    assert list(got) == want.column_names and not valid
    for name in want.column_names:
        ref = want.column(name).combine_chunks()
        if isinstance(got[name], HostStrings):
            assert _host_column_values(got[name]) == ref.to_pylist(), name
        else:
            exp = ref.to_numpy(zero_copy_only=False)
            assert got[name].dtype == exp.dtype, name
            assert np.array_equal(got[name], exp), name


@pytest.mark.parametrize("kind,kw", [
    ("string", dict(max_len=6)), ("choice", dict(values=["x", "yy", "é"])),
    ("int", dict(min_val=-5, max_val=5)), ("string", dict(cardinality=4)),
    ("key", dict(cardinality=50, skew=1.2))],
    ids=["string", "choice", "int", "string-dict", "key-zipf"])
def test_datagen_nulls_equal_reference(kind, kw):
    """Columns with nulls (the q3 tables have none): values and null masks
    equal the reference's, nulls drawn from the same stream."""
    ref = RD.ColumnSpec("c", kind, null_prob=0.3, **kw).generate(
        RD._cell_rng(7, "t", "c", 0), 700)
    vals, valid = TD.ColumnSpec("c", kind, null_prob=0.3, **kw).generate(
        TD._cell_rng(7, "t", "c", 0), 700)
    assert np.array_equal(valid, ref.is_valid().to_numpy(
        zero_copy_only=False))
    got = _host_column_values(vals)
    want = ref.to_pylist()
    assert [g if ok else None for g, ok in zip(got, valid)] == want


def test_host_table_nbytes_is_arrow_nbytes():
    """The broadcast decision reads the build table's bytes: Arrow's
    count, so the two packages decide alike near the threshold."""
    cols, _ = TD.tpch_customer(1).generate(42, 3000)
    ref = RD.tpch_customer(1).generate(42, 3000)
    port = TorchColumnarBatch.from_numpy_columns(cols)
    assert port.nbytes == ref.nbytes
    with_nulls = pa.table({"a": pa.array([1, None, 3]),
                           "s": pa.array(["a", None, "ccc"]),
                           "b": pa.array([True, False, None])})
    assert TorchColumnarBatch.from_arrow(with_nulls).nbytes \
        == with_nulls.nbytes


# ---------------------------------------------------------------------------
# murmur3, partition ids, the exchange
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _key_table(n: int = 400) -> pa.Table:
    rng = np.random.default_rng(3)
    mask = rng.random(n) < 0.15
    d = rng.uniform(-5, 5, n)
    d[:6] = [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf]
    words = np.array(["", "a", "héllo", "BUILDING", "abcd", "abcde", "日本語",
                      "twelve bytes", "x\x7f"], dtype=object)
    return pa.table({
        "i": pa.array(rng.integers(-2**31, 2**31, n).astype(np.int32),
                      mask=mask),
        "l": pa.array(rng.integers(-2**62, 2**62, n), mask=mask[::-1]),
        "d": pa.array(rng.integers(0, 20000, n).astype(np.int32),
                      pa.date32(), mask=mask),
        "f": pa.array(d, mask=np.roll(mask, 3)),
        "b": pa.array(rng.integers(0, 2, n).astype(bool), mask=mask),
        "s": pa.array(words[rng.integers(0, len(words), n)].tolist(),
                      mask=np.roll(mask, 5)),
    })


def _both_batches(table):
    ref = TpuColumnarBatch.from_arrow(table)
    port = TorchColumnarBatch.from_arrow(table).to_device("cpu")
    return ref, port


@pytest.mark.parametrize("column", ["i", "l", "d", "f", "b", "s"])
def test_murmur3_col_bit_identical(column):
    from spark_rapids_tpu.expressions.hashexprs import murmur3_col as ref_h
    from spark_rapids_tpu_torch.expressions.hashexprs import murmur3_col
    table = _key_table()
    ref, port = _both_batches(table.select([column]))
    n = table.num_rows
    want = np.asarray(ref_h(ref.columns[0], jnp.full(
        (ref.capacity,), np.uint32(42), jnp.uint32), ref.capacity))[:n]
    got = murmur3_col(port.columns[0], torch.full(
        (port.capacity,), 42, dtype=torch.int64))[:n].numpy()
    assert np.array_equal(got.astype(np.uint32), want)


def _bound_keys(mod, table, names):
    from spark_rapids_tpu.types import from_arrow as ref_type
    from spark_rapids_tpu_torch.types import from_arrow as port_type
    typ = ref_type if mod == "ref" else port_type
    if mod == "ref":
        from spark_rapids_tpu.expressions.base import AttributeReference
    else:
        from spark_rapids_tpu_torch.expressions.base import AttributeReference
    return [AttributeReference(c, typ(table.schema.field(c).type),
                               ordinal=table.column_names.index(c))
            for c in names]


@pytest.mark.parametrize("n", [1, 16])
@pytest.mark.parametrize("keys", [("i",), ("l",), ("d",), ("f",),
                                  ("s",), ("l", "d", "f", "b", "i")],
                         ids=["int", "long", "date", "double", "string",
                              "five-keys"])
def test_hash_partition_ids_bit_identical(n, keys):
    from spark_rapids_tpu.shuffle.partitioner import \
        hash_partition_ids as ref_ids
    from spark_rapids_tpu_torch.shuffle.partitioner import hash_partition_ids
    table = _key_table()
    ref, port = _both_batches(table)
    rows = table.num_rows
    want = np.asarray(ref_ids(ref, _bound_keys("ref", table, keys), n,
                              RefTaskContext(0, RefConf())))[:rows]
    got = hash_partition_ids(port, _bound_keys("port", table, keys), n,
                             TaskContext(0, RapidsConf(),
                                         torch.device("cpu")))[:rows]
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("parts,n_out", [(3, 3)])
def test_exchange_partitions_equal_reference_in_order(parts, n_out):
    """Every reduce partition of the hash exchange holds the reference's
    rows in the reference's order (blocks read in map order)."""
    from spark_rapids_tpu.execs.transitions import \
        HostToDeviceExec as RefH2D
    from spark_rapids_tpu.plan.planner import plan_physical as ref_plan
    from spark_rapids_tpu.shuffle.exchange import TpuShuffleExchangeExec
    from spark_rapids_tpu_torch.execs.transitions import HostToDeviceExec
    from spark_rapids_tpu_torch.plan.planner import plan_physical
    from spark_rapids_tpu_torch.shuffle.exchange import (
        ShuffleCatalog, TorchShuffleExchangeExec)
    table = _key_table().select(["l", "d", "f", "s"])
    conf = {"spark.rapids.shuffle.mode": "ICI"}
    rdf = TpuSession(conf).createDataFrame(table, num_partitions=parts)
    pdf = TorchSession(conf, device="cpu").createDataFrame(
        table, num_partitions=parts)
    ref_child = RefH2D(ref_plan(rdf._plan, RefConf(conf)))
    port_child = HostToDeviceExec(plan_physical(pdf._plan, RapidsConf(conf)))
    ref = TpuShuffleExchangeExec(ref_child, "hash", ref_child.output[:2],
                                 n_out)
    port = TorchShuffleExchangeExec(port_child, "hash",
                                    port_child.output[:2], n_out)
    blocks = ShuffleCatalog.get().num_blocks()
    for p in range(n_out):
        want = [b.to_arrow().to_pylist() for b in ref.execute_partition(
            p, RefTaskContext(p, RefConf(conf)))]
        got = [b.to_host().to_pylist() for b in port.execute_partition(
            p, TaskContext(p, RapidsConf(conf), torch.device("cpu")))]
        assert _canon(sum(got, [])) == _canon(sum(want, [])), p
    port.cleanup_shuffle()
    ref.cleanup_shuffle(RefConf(conf))
    assert ShuffleCatalog.get().num_blocks() == blocks


def test_multithreaded_shuffle_and_aqe_raise_not_yet_ported():
    table = _key_table().select(["l", "i"])
    for conf in ({"spark.rapids.shuffle.mode": "MULTITHREADED"},
                 {"spark.sql.adaptive.coalescePartitions.enabled": "true"}):
        df = TorchSession(dict(conf, **{
            "spark.rapids.tpu.agg.compiledStage.enabled": "false"}),
            device="cpu").createDataFrame(table, num_partitions=2)
        with pytest.raises(NotImplementedError, match="not yet ported"):
            df.groupBy("i").agg(TF.count("*").alias("c")).collect()


# ---------------------------------------------------------------------------
# string comparisons
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _string_table(n: int = 300) -> pa.Table:
    rng = np.random.default_rng(11)
    alphabet = ["a", "b", "é", "日", "\x01", "z"]

    def word():
        return "".join(rng.choice(alphabet, rng.integers(0, 13)))

    l = [word() for _ in range(n)]
    r = [w if rng.random() < 0.3 else word() for w in l]
    l[:4] = ["", "BUILDING", "BUILDINGS", "BUILDIN"]
    return pa.table({"l": pa.array(l, mask=rng.random(n) < 0.1),
                     "r": pa.array(r, mask=rng.random(n) < 0.1)})


@pytest.mark.parametrize("op", ["EqualTo", "LessThan", "LessThanOrEqual",
                                "GreaterThan", "GreaterThanOrEqual", "Ne"])
def test_string_comparisons_match_reference(op):
    """Column vs literal, literal vs column and column vs column, UTF-8
    byte order, nulls; strings of 0–12 characters with multi-byte UTF-8."""
    import spark_rapids_tpu.expressions.base as RB
    import spark_rapids_tpu.expressions.predicates as RP
    import spark_rapids_tpu_torch.expressions.base as TB
    import spark_rapids_tpu_torch.expressions.predicates as TP
    from spark_rapids_tpu.types import StringT as RS
    from spark_rapids_tpu_torch.types import StringT as TS
    table = _string_table()
    ref, port = _both_batches(table)
    n = table.num_rows

    def build(P, B, S, a, b):
        side = {"l": B.AttributeReference("l", S, ordinal=0),
                "r": B.AttributeReference("r", S, ordinal=1)}
        x = side.get(a) or B.Literal(a)
        y = side.get(b) or B.Literal(b)
        if op == "Ne":
            return P.Not(P.EqualTo(x, y))
        return getattr(P, op)(x, y)

    for a, b in (("l", "BUILDING"), ("é", "r"), ("l", "r"), ("l", "")):
        rc = build(RP, RB, RS, a, b).eval_tpu(ref)
        pc = build(TP, TB, TS, a, b).eval_device(port)
        want = rc.to_arrow().to_pylist()[:n]
        got = pc.to_pylist()[:n]
        assert got == want, (a, b)


# ---------------------------------------------------------------------------
# joins
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _join_tables():
    """A fact side with null and repeated keys, and a build side with
    duplicate keys (fan-out) and nulls; a second key pair with -0.0/NaN."""
    rng = np.random.default_rng(5)
    n_l, n_r = 300, 60
    lk = rng.integers(0, 40, n_l)
    rk = rng.integers(0, 50, n_r)
    lf = rng.choice([0.0, -0.0, np.nan, 1.5, 2.5], n_l)
    rf = rng.choice([0.0, np.nan, 1.5, 7.0], n_r)
    left = pa.table({"lk": pa.array(lk, mask=rng.random(n_l) < 0.1),
                     "lf": lf, "lv": rng.uniform(0, 1, n_l),
                     "ls": pa.array(rng.choice(["a", "bb", "ccc"], n_l))})
    right = pa.table({"rk": pa.array(rk.astype(np.int32),
                                     mask=rng.random(n_r) < 0.1),
                      "rf": rf, "rv": rng.integers(0, 100, n_r),
                      "rs": pa.array(rng.choice(["x", "yyyy"], n_r))})
    return left, right


def _canon(rows):
    """Rows with floats made comparable (NaN == NaN)."""
    return [{k: ("nan" if isinstance(v, float) and v != v else v)
             for k, v in r.items()} for r in rows]


def _exec_sides(left, right, parts):
    """Each package's physical plans of the two tables (host scans under
    an upload) and their key attributes."""
    from spark_rapids_tpu.execs.transitions import \
        HostToDeviceExec as RefH2D
    from spark_rapids_tpu.plan.planner import plan_physical as ref_plan
    from spark_rapids_tpu_torch.execs.transitions import HostToDeviceExec
    from spark_rapids_tpu_torch.plan.planner import plan_physical
    out = {}
    for mod, sess, h2d, plan, conf in (
            ("ref", TpuSession, RefH2D, ref_plan, RefConf()),
            ("port", lambda: TorchSession(device="cpu"), HostToDeviceExec,
             plan_physical, RapidsConf())):
        s = sess()
        sides = [h2d(plan(s.createDataFrame(t, num_partitions=p)._plan,
                          conf)) for t, p in ((left, parts), (right, 1))]
        out[mod] = sides
    return out


def _join_rows(mod, exec_cls, sides, n_keys, per_partition=None):
    l, r = sides
    lk = [l.output[0], l.output[1]][:n_keys]
    rk = [r.output[0], r.output[1]][:n_keys]
    if mod == "ref":
        from spark_rapids_tpu.session import _coerce_join_keys
    else:
        from spark_rapids_tpu_torch.session import _coerce_join_keys
    lk, rk = _coerce_join_keys(lk, rk)
    args = (l, r, "inner", lk, rk, None, l.output + r.output)
    node = exec_cls(*args) if per_partition is None \
        else exec_cls(*args, per_partition=per_partition)
    rows = []
    for p in range(node.num_partitions()):
        if mod == "ref":
            batches = node.execute_partition(p, RefTaskContext(p, RefConf()))
            rows.extend(sum((b.to_arrow().to_pylist() for b in batches), []))
        else:
            batches = node.execute_partition(p, TaskContext(
                p, RapidsConf(), torch.device("cpu")))
            rows.extend(sum((b.to_host().to_pylist() for b in batches), []))
    return rows


@pytest.mark.parametrize("kind,n_keys,flip", [
    ("broadcast", 1, False), ("shuffled", 2, False), ("symmetric", 1, True),
    ("symmetric", 2, False)],
    ids=["broadcast-1key", "shuffled-2keys", "symmetric-flip",
         "symmetric-2keys"])
def test_inner_joins_match_reference_in_order(kind, n_keys, flip):
    """Inner joins give the reference's rows in the reference's order:
    probe-major, a probe row's build rows in their input order, null keys
    never matching, an int32 key widened to meet the int64 one, NaN = NaN
    and -0.0 = 0.0 in a double key; the symmetric join builds on the
    smaller side (``flip``: the left) and puts the columns back."""
    from spark_rapids_tpu.execs.broadcast import TpuBroadcastHashJoinExec
    from spark_rapids_tpu.execs.joins import (
        TpuShuffledHashJoinExec, TpuShuffledSymmetricHashJoinExec)
    from spark_rapids_tpu_torch.execs.broadcast import \
        TorchBroadcastHashJoinExec
    from spark_rapids_tpu_torch.execs.joins import (
        TorchShuffledHashJoinExec, TorchShuffledSymmetricHashJoinExec)
    left, right = _join_tables()
    if flip:
        left, right = right.rename_columns(left.column_names), \
            left.rename_columns(right.column_names)
    parts = 3 if kind == "broadcast" else 1
    sides = _exec_sides(left, right, parts)
    classes = {"broadcast": (TpuBroadcastHashJoinExec,
                             TorchBroadcastHashJoinExec, None),
               "shuffled": (TpuShuffledHashJoinExec,
                            TorchShuffledHashJoinExec, False),
               "symmetric": (TpuShuffledSymmetricHashJoinExec,
                             TorchShuffledSymmetricHashJoinExec, False)}
    ref_cls, port_cls, pp = classes[kind]
    want = _join_rows("ref", ref_cls, sides["ref"], n_keys, pp)
    got = _join_rows("port", port_cls, sides["port"], n_keys, pp)
    assert want and _canon(got) == _canon(want)
