"""TPC-H q3 through the port's whole planning route, held against the JAX
reference: the compiled star-join stage, the general path with broadcast
joins, and the general path with hash exchanges and the symmetric shuffled
join; the compiled join stage's counted re-run.

Both packages get the same tables from their own data generators (which
``test_torch_joins.py`` holds equal, column by column). ``explain()``
prints the same operator trees (Tpu → Torch; the reference runs without
its segment fusion and batch coalescing, which the port has not ported);
the top 10 rows match (keys exact, revenue rtol 1e-9), and so does the
whole aggregate without the limit, as a set keyed by o_orderkey."""

import functools

import numpy as np
import pyarrow as pa
import pytest
import torch

import benchmarks.tpch as tpch
import spark_rapids_tpu_torch.functions as TF
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch.datagen import q3_tables
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.memory.device import TorchDeviceManager

# the CPU has no device memory to read: the tests state one for the
# budget (spark.rapids.memory.device.totalBytes)
TorchDeviceManager.initialize(device="cpu", total_bytes=8 << 30)

REF_ONLY_OFF = {"spark.rapids.tpu.opjit.fuseStages": "false",
                "spark.rapids.tpu.coalesce.enabled": "false"}
BASE = {"spark.rapids.shuffle.mode": "ICI",
        "spark.sql.shuffle.partitions": "8"}
ROWS = 1 << 12

#: shape -> (conf, lineitem/orders partitions, device-cached lineitem)
SHAPES = {
    "compiled": ({"spark.rapids.sql.batchSizeRows": str(ROWS)}, 1, True),
    "general-broadcast": ({"spark.rapids.tpu.join.compiledStage.enabled":
                           "false"}, 2, False),
    # the compiled aggregation stage off too: over the joins it re-runs on
    # the general aggregate anyway (general-broadcast covers that re-run),
    # and the reference's attempt costs most of this file's compile time
    "general-exchange": ({"spark.rapids.tpu.join.compiledStage.enabled":
                          "false",
                          "spark.rapids.tpu.agg.compiledStage.enabled":
                          "false",
                          "spark.sql.autoBroadcastJoinThreshold": "-1"},
                         2, False),
}
#: shapes whose reference rows come from another shape over the same tables
#: (same partitions, same caching): the reference's exchange path compiles
#: about 200 XLA programs on the CPU, and ``test_torch_joins.py`` holds the
#: port's exchange and symmetric join to the reference's partition by
#: partition
ROWS_FROM = {"general-exchange": "general-broadcast"}


def _q3_groups(F, t):
    """q3 without ORDER BY / LIMIT: every (order, date, revenue) group."""
    li, orders, cust = t["lineitem"], t["orders"], t["customer"]
    return (cust.filter(F.col("c_mktsegment") == "BUILDING")
            .join(orders, on=cust["c_custkey"] == orders["o_custkey"])
            .join(li, on=orders["o_orderkey"] == li["l_orderkey"])
            .withColumn("revenue",
                        F.col("l_extendedprice") * (1 - F.col("l_discount")))
            .groupBy("o_orderkey", "o_orderdate")
            .agg(F.sum(F.col("revenue")).alias("revenue")))


def _q3(F, t):
    return _q3_groups(F, t).sort(F.col("revenue").desc()).limit(10)


def _port_tables(session, parts, cached):
    t = q3_tables(session, ROWS, parts)
    if cached:
        t["lineitem"] = t["lineitem"].device_cache()
    return t


@functools.lru_cache(maxsize=None)
def _reference(shape):
    """(explain, top-10 rows, every group) of the reference; the rows from
    the ``ROWS_FROM`` shape where there is one."""
    conf, parts, cached = SHAPES[shape]
    s = TpuSession(dict(BASE, **conf, **REF_ONLY_OFF))
    t = tpch.load_tables(s, ROWS, parts=parts)
    if cached:
        t["lineitem"] = t["lineitem"].device_cache()
    q = tpch.q3(s, t)
    if shape in ROWS_FROM:
        assert SHAPES[ROWS_FROM[shape]][1:] == (parts, cached)
        return (q.explain(),) + _reference(ROWS_FROM[shape])[1:]
    return q.explain(), q.collect(), _q3_groups(_ref_functions(), t).collect()


def _ref_functions():
    import spark_rapids_tpu.functions as RF
    return RF


def _physical(plan: str):
    """The physical plan's operator lines, reference names mapped."""
    tree = plan.split("== Physical Plan ==")[-1]
    return [ln.replace("Tpu", "Torch").rstrip() for ln in tree.splitlines()
            if ln.strip() and not ln.startswith("planCache")]


def _assert_top_rows_equal(want, got):
    assert [(r["o_orderkey"], r["o_orderdate"]) for r in got] == \
        [(r["o_orderkey"], r["o_orderdate"]) for r in want]
    np.testing.assert_allclose([r["revenue"] for r in got],
                               [r["revenue"] for r in want], rtol=1e-9)


def _assert_groups_equal(want, got):
    w = {r["o_orderkey"]: (r["o_orderdate"], r["revenue"]) for r in want}
    g = {r["o_orderkey"]: (r["o_orderdate"], r["revenue"]) for r in got}
    assert len(g) == len(got) and g.keys() == w.keys()
    assert all(g[k][0] == w[k][0] for k in w)
    keys = sorted(w)
    np.testing.assert_allclose([g[k][1] for k in keys],
                               [w[k][1] for k in keys], rtol=1e-9)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_q3_matches_reference(shape):
    conf, parts, cached = SHAPES[shape]
    ref_plan, ref_top, ref_groups = _reference(shape)
    s = TorchSession(dict(BASE, **conf), device="cpu")
    t = _port_tables(s, parts, cached)
    q = _q3(TF, t)
    plan = q.explain()
    assert _physical(plan) == _physical(ref_plan)
    assert plan.split("== Physical Plan ==")[0] == \
        ref_plan.split("== Physical Plan ==")[0]
    _assert_top_rows_equal(ref_top, q.collect())
    _assert_groups_equal(ref_groups, _q3_groups(TF, t).collect())
    # the compiled aggregation stage over the joins re-runs on the general
    # aggregate (o_orderkey's domain is past maxGroups), as in the reference
    assert s.counters["fallback_runs"] == \
        (2 if shape == "general-broadcast" else 0)
    assert s.counters["fallbackReruns"] == 0


def test_compiled_join_stage_rerun_gives_the_same_rows():
    """maxDimRows below the dimension's rows: the stage re-runs its original
    subtree on the general join path, counted, with the reference's rows."""
    _, ref_top, _ = _reference("compiled")
    conf, parts, cached = SHAPES["compiled"]
    s = TorchSession(dict(BASE, **conf, **{
        "spark.rapids.tpu.join.compiled.maxDimRows": "16"}), device="cpu")
    q = _q3(TF, _port_tables(s, parts, cached))
    assert "TorchCompiledJoinAggStage[keys=o_orderkey, o_orderdate, dims=1]" \
        in q.explain()
    _assert_top_rows_equal(ref_top, q.collect())
    assert s.counters["fallbackReruns"] == 1
    again = q.collect()
    _assert_top_rows_equal(ref_top, again)
    assert s.counters["fallbackReruns"] == 2


def test_compiled_join_stage_repeat_collects_identical():
    """Repeat collects are bit-identical, and the dimension build is served
    from the cache while its source tables stay the same objects."""
    from spark_rapids_tpu_torch.execs import compiled_join as CJ
    conf, parts, cached = SHAPES["compiled"]
    s = TorchSession(dict(BASE, **conf), device="cpu")
    t = _port_tables(s, parts, cached)
    CJ.clear_dim_cache()
    first = _q3_groups(TF, t).collect()
    entry = next(iter(CJ._DIM_BUILD_CACHE.values()))
    assert first == _q3_groups(TF, t).collect()
    assert next(iter(CJ._DIM_BUILD_CACHE.values())) is entry
    # new source tables (a new orders frame) rebuild the dimension
    t2 = dict(t, orders=q3_tables(s, ROWS, parts)["orders"])
    assert _q3_groups(TF, t2).collect() == first
    assert all(e is not entry for e in CJ._DIM_BUILD_CACHE.values()) \
        or len(CJ._DIM_BUILD_CACHE) == 2


def test_exchange_blocks_leave_with_the_query():
    from spark_rapids_tpu_torch.shuffle.exchange import ShuffleCatalog
    conf, parts, cached = SHAPES["general-exchange"]
    s = TorchSession(dict(BASE, **conf), device="cpu")
    before = ShuffleCatalog.get().num_blocks()
    assert len(_q3(TF, _port_tables(s, parts, cached)).collect()) == 10
    assert ShuffleCatalog.get().num_blocks() == before


def _star_tables(s, dense: bool, strings: bool = False):
    """A fact and a dimension, the dimension's rows unique on (d1, d2), or
    with ``dense`` on d1 alone, whose values are then contiguous; a
    dimension column ``g`` repeats. With ``strings`` two string columns:
    ``name`` is unique a row (16 bytes, the first 13 shared), ``tag``
    repeats (14-18 bytes)."""
    rng = np.random.default_rng(9)
    n_dim, n_fact = 300, 5000
    perm = rng.permutation(n_dim).astype(np.int64)
    d1, d2 = perm // 3, (perm % 3 + 9000).astype("datetime64[D]")
    if dense:
        d1 = perm + 5
    cols = {"d1": d1, "d2": d2, "g": rng.integers(0, 40, n_dim)}
    if strings:
        cols["name"] = np.array([f"customer#{p:07d}" for p in perm], object)
        cols["tag"] = np.array(["shared-prefix-" + "x" * (p % 5)
                                for p in perm], object)
    dim = s.createDataFrame(cols)
    fact = s.createDataFrame({
        "f1": rng.integers(0, 110, n_fact).astype(np.int32),
        "f2": (rng.integers(0, 4, n_fact) + 9000).astype("datetime64[D]"),
        "v": rng.uniform(0, 10, n_fact)}).device_cache()
    return fact, dim


def _star_query(F, s, group, dense: bool):
    """The star tables joined on (f1, f2) = (d1, d2), or with ``dense`` on
    f1 = d1 alone, grouped by ``group``: sum, count and max of v."""
    fact, dim = _star_tables(s, dense, strings=bool(
        {"name", "tag"} & set(group)))
    on = fact["f1"] == dim["d1"]
    if not dense:
        on = on & (fact["f2"] == dim["d2"])
    return (fact.join(dim, on=on)
            .groupBy(*group).agg(F.sum(F.col("v")).alias("s"),
                                 F.count("*").alias("c"),
                                 F.max(F.col("v")).alias("m")))


def _star_groups(rows, group):
    return sorted((tuple(r[k] for k in group), r["c"], r["m"], r["s"])
                  for r in rows)


def _assert_star_groups_equal(want, got):
    """Keys, counts and max exact; sums within rtol 1e-9."""
    assert [g[:3] for g in got] == [w[:3] for w in want]
    np.testing.assert_allclose([g[3] for g in got], [w[3] for w in want],
                               rtol=1e-9)


_STAR = {"composite-key": (("d1", "d2"), False, False),
         "non-unique-group": (("g",), True, False),
         "dense-key": (("d1",), False, True),
         "string-group-key": (("name",), False, False),
         "repeating-string-group-key": (("tag",), True, False)}


def _star_cases(ids):
    return pytest.mark.parametrize("group,rerun,dense",
                                   [_STAR[i] for i in ids], ids=ids)


STAR_CASES = _star_cases(list(_STAR))
#: the repeating string key re-runs like the repeating int key, and the
#: reference's re-run over string columns compiles for ~6 s on the CPU
REF_STAR_CASES = _star_cases([i for i in _STAR
                              if i != "repeating-string-group-key"])


@STAR_CASES
def test_compiled_join_stage_matches_general_joins(group, rerun, dense):
    """Two join keys pack into the dimension's monotone composite; a single
    contiguous key probes by subtraction; grouping by a dimension column
    that repeats across dimension rows re-runs on the general joins; a
    string group key past 7 bytes that is unique a row groups by the
    dimension's row and is gathered at finalize. Each gives the general
    path's groups."""
    def groups(conf):
        s = TorchSession(dict(BASE, **conf), device="cpu")
        q = _star_query(TF, s, group, dense)
        return q.explain(), s.counters, _star_groups(q.collect(), group)
    plan, counters, got = groups({})
    _, _, want = groups({"spark.rapids.tpu.join.compiledStage.enabled":
                         "false"})
    assert "TorchCompiledJoinAggStage" in plan
    assert counters["fallbackReruns"] == int(rerun)
    _assert_star_groups_equal(want, got)


@REF_STAR_CASES
def test_compiled_join_stage_matches_reference(group, rerun, dense):
    """The star-join stage's branches against the reference's stage over
    the same tables: the port takes the branch the case names (a composite
    of two keys, direct addressing of contiguous keys, the re-run), the
    reference re-runs exactly when the port does, and the groups agree."""
    from spark_rapids_tpu_torch.execs import compiled_join as CJ
    ref = TpuSession(dict(BASE, **REF_ONLY_OFF))
    rq = _star_query(_ref_functions(), ref, group, dense)
    assert "TpuCompiledJoinAggStage" in rq.explain()
    want = _star_groups(rq.collect(), group)
    ref_reruns = sum(m.get("fallbackReruns", 0)
                     for m in ref.last_query_metrics("DEBUG").values())

    s = TorchSession(BASE, device="cpu")
    q = _star_query(TF, s, group, dense)
    assert "TorchCompiledJoinAggStage" in q.explain()
    CJ.clear_dim_cache()
    got = _star_groups(q.collect(), group)
    (key, entry), = CJ._DIM_BUILD_CACHE.items()
    assert len(key[1]) == (1 if dense else 2)  # the dimension's join keys
    assert entry[1][3] == dense                 # probed by subtraction
    assert s.counters["fallbackReruns"] == ref_reruns == int(rerun)
    _assert_star_groups_equal(want, got)


def test_group_sum_leaves_the_dropped_rows_out():
    """The stage's float sums reduce only the live groups' segments: each
    equals the sum over exactly its rows, and the dropped rows' slot
    (the last) is 0, whatever those rows hold."""
    from spark_rapids_tpu_torch.execs.compiled_join import _GroupOrder
    rng = np.random.default_rng(3)
    G = 50
    gcode = torch.from_numpy(np.where(rng.random(4000) < 0.8, G - 1,
                                      rng.integers(0, G - 1, 4000)))
    gcode[:7] = 3  # a group whose rows lead
    x = torch.from_numpy(rng.uniform(-5, 5, 4000))
    got = _GroupOrder(gcode, G).sum(x)
    want = torch.zeros(G, dtype=torch.float64)
    live = gcode < G - 1
    want.index_add_(0, gcode[live], x[live])
    assert got.shape == (G,) and got[-1] == 0
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    counts = _GroupOrder(gcode, G).sum(torch.ones(4000, dtype=torch.int64))
    assert torch.equal(counts, torch.bincount(gcode, minlength=G))


def _semi_star_query(F, s):
    """The star tables' fact, semi-joined to a table whose keys repeat and
    hold nulls, joined to the dimension, grouped by the dimension's row."""
    fact, dim = _star_tables(s, False)
    rng = np.random.default_rng(12)
    sdim = s.createDataFrame(pa.table({"k": pa.array(
        rng.integers(0, 80, 200), mask=rng.random(200) < 0.1)}))
    kept = fact.join(sdim, on=fact["f1"] == sdim["k"], how="leftsemi")
    return (kept.join(dim, on=(kept["f1"] == dim["d1"])
                      & (kept["f2"] == dim["d2"]))
            .groupBy("d1", "d2").agg(F.sum(F.col("v")).alias("s"),
                                     F.count("*").alias("c"),
                                     F.max(F.col("v")).alias("m")))


def test_compiled_join_stage_semi_dimension_matches_reference():
    """A left semi join inside the star: its right side becomes a filtering
    dimension (the first row of each key), in both packages, with the
    reference's groups and no re-run."""
    ref = TpuSession(dict(BASE, **REF_ONLY_OFF))
    rq = _semi_star_query(_ref_functions(), ref)
    assert "TpuCompiledJoinAggStage[keys=d1, d2, dims=2]" in rq.explain()
    want = _star_groups(rq.collect(), ("d1", "d2"))
    assert sum(m.get("fallbackReruns", 0)
               for m in ref.last_query_metrics("DEBUG").values()) == 0
    s = TorchSession(BASE, device="cpu")
    q = _semi_star_query(TF, s)
    assert "TorchCompiledJoinAggStage[keys=d1, d2, dims=2]" in q.explain()
    _assert_star_groups_equal(want, _star_groups(q.collect(), ("d1", "d2")))
    assert s.counters["fallbackReruns"] == 0
