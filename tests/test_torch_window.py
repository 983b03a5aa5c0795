"""The port's window exec (``execs/window.TorchWindowExec``) held to the
reference's ``TpuWindowExec`` run on the CPU, through both packages'
sessions, over one table of 3,000 rows in three input partitions: string
partition keys (some partitions of one row, some rows with a null key),
and float order keys with ties, nulls, NaN and -0.0 (which must tie with
0.0), an integer order key with ties, and float and integer values with
nulls.

Every window function of ``window.py`` and sum, count, avg, min and max
over the whole partition, the default RANGE frame (tied rows share the
running value), a running ROWS frame, a bounded ROWS frame (-2..+1) and an
unbounded-following frame; a global ``rank`` with no ``partitionBy``
ranks across the three input partitions. Integers and nulls must be
exact, floats within rtol 1e-9. Each case set is one reference device run
(an XLA compile of its window program, ~10 s on the CPU)."""

import functools

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu.functions as RF
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.window import Window as RWindow
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu_torch.memory.device import TorchDeviceManager
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.window import Window as PWindow

TorchDeviceManager.initialize(device="cpu", total_bytes=8 << 30)

N = 3_000


def _columns():
    rng = np.random.default_rng(7)
    k = rng.integers(0, 60, N)
    # partitions of one row: keys that occur once
    k[:12] = np.arange(1000, 1012)
    keys = np.array([f"part{v:04d}" for v in k], dtype=object)
    key_null = rng.random(N) < 0.03
    o = rng.integers(0, 25, N).astype(np.float64)
    o[rng.random(N) < 0.04] = np.nan
    o[rng.random(N) < 0.04] = -0.0
    o_null = rng.random(N) < 0.04
    x = np.round(rng.normal(size=N) * 100, 3)
    x_null = rng.random(N) < 0.08
    i = rng.integers(-50, 50, N).astype(np.int64)
    i_null = rng.random(N) < 0.05
    j = rng.integers(0, 8, N).astype(np.int32)
    return ({"k": keys, "o": o, "j": j, "x": x, "i": i},
            {"k": ~key_null, "o": ~o_null, "x": ~x_null, "i": ~i_null})


def _frames(session, host_valid):
    cols, valid = _columns()
    if host_valid:
        return session.createDataFrame(cols, num_partitions=3,
                                       validity=valid)
    return session.createDataFrame(pa.table({
        name: pa.array([None if not valid.get(name, np.ones(N, bool))[r]
                        else v for r, v in enumerate(vals.tolist())])
        if name == "k" else
        pa.array(vals, mask=~valid[name] if name in valid else None)
        for name, vals in cols.items()}), num_partitions=3)


def _case_functions(F, Window, df):
    """Every ranking and offset function, over a float and an integer
    order key, and a global rank."""
    w = Window.partitionBy("k").orderBy("o")
    wd = Window.partitionBy("k").orderBy(F.col("j").desc(), "o")
    return df.select(
        "k", "o", "j", "x",
        F.row_number().over(w).alias("rn"),
        F.rank().over(w).alias("rk"),
        F.dense_rank().over(w).alias("dr"),
        F.ntile(4).over(w).alias("nt"),
        F.percent_rank().over(w).alias("pr"),
        F.cume_dist().over(w).alias("cd"),
        F.rank().over(wd).alias("rk_desc"),
        F.lead("x").over(w).alias("ld"),
        F.lag("x").over(w).alias("lg"),
        F.lead("x", 3).over(wd).alias("ld3"),
        F.lag("i", 2, -1).over(w).alias("lg_def"),
        F.rank().over(Window.orderBy("o")).alias("rk_global"),
        F.row_number().over(Window.orderBy("j", "o", "x")).alias("rn_global"))


def _case_frames(F, Window, df):
    """sum/count/avg/min/max over the whole partition, the default RANGE
    frame, running and bounded ROWS frames and an unbounded-following
    frame."""
    part = Window.partitionBy("k")
    rng = Window.partitionBy("k").orderBy("o")
    run = rng.rowsBetween(Window.unboundedPreceding, Window.currentRow)
    bnd = Window.partitionBy("k").orderBy("o", "j").rowsBetween(-2, 1)
    fol = rng.rowsBetween(Window.currentRow, Window.unboundedFollowing)
    return df.select(
        "k", "o", "x", "i",
        F.sum("x").over(part).alias("sum_all"),
        F.count("x").over(part).alias("cnt_all"),
        F.avg("i").over(part).alias("avg_all"),
        F.min("i").over(part).alias("min_all"),
        F.max("i").over(part).alias("max_all"),
        F.sum("x").over(rng).alias("sum_range"),
        F.count("x").over(rng).alias("cnt_range"),
        F.max("x").over(rng).alias("max_range"),
        F.sum("i").over(run).alias("sum_rows"),
        F.min("x").over(run).alias("min_rows"),
        F.avg("x").over(bnd).alias("avg_bnd"),
        F.sum("i").over(bnd).alias("sum_bnd"),
        F.min("x").over(bnd).alias("min_bnd"),
        F.max("i").over(bnd).alias("max_bnd"),
        F.count("i").over(fol).alias("cnt_fol"),
        F.sum("x").over(fol).alias("sum_fol"),
        F.max("x").over(fol).alias("max_fol"))


CASES = {"functions": _case_functions, "frames": _case_frames}


@functools.lru_cache(maxsize=None)
def reference_rows(case: str):
    s = TpuSession({"spark.rapids.sql.enabled": "true"})
    return CASES[case](RF, RWindow, _frames(s, host_valid=False)).collect()


def port(case: str):
    s = TorchSession({}, device="cpu")
    q = CASES[case](PF, PWindow, _frames(s, host_valid=True))
    return q.explain(), q.collect()


def assert_rows_equal(want, got) -> None:
    assert len(got) == len(want) == N
    for w, g in zip(want, got):
        assert list(g) == list(w)
        for c in w:
            if isinstance(w[c], float):
                np.testing.assert_allclose(g[c], w[c], rtol=1e-9,
                                           err_msg=f"{c}: {g} vs {w}")
            else:
                assert g[c] == w[c], (c, g, w)


@pytest.mark.parametrize("case", sorted(CASES))
def test_window_matches_the_reference_device_exec(case):
    plan, got = port(case)
    assert "TorchWindow[" in plan and "Cpu" not in plan.replace(
        "CpuLocalTableScanExec", "")
    assert_rows_equal(reference_rows(case), got)


def test_default_frame_gives_peers_the_same_value():
    """With ORDER BY and no frame, tied order keys (here -0.0 and 0.0
    among them) share the running sum; a ROWS frame does not."""
    _, got = port("frames")
    by_peer = {}
    for r in got:
        o = r["o"]
        key = (r["k"], None if o is None else
               ("nan" if o != o else o + 0.0))
        by_peer.setdefault(key, set()).add(r["sum_range"])
    assert all(len(v) == 1 for v in by_peer.values())
    assert any(len(v) > 1 for v in _rows_sums(got).values())


def _rows_sums(rows):
    out = {}
    for r in rows:
        o = r["o"]
        out.setdefault((r["k"], None if o is None else
                        ("nan" if o != o else o + 0.0)),
                       set()).add(r["sum_rows"])
    return out


def test_lead_lag_of_strings():
    """lead / lag of a string column: the partition's neighbour, null past
    its edge. The reference's device exec takes a string column's bytes
    for its rows here (Queue C, C-ref-12), so this case is held to a plain
    computation over the collected rows instead."""
    s = TorchSession({}, device="cpu")
    w = PWindow.partitionBy("j").orderBy("o", "x", "i")
    got = _frames(s, host_valid=True).select(
        "j", "o", "x", "i", "k", PF.lag("k").over(w).alias("prev"),
        PF.lead("k", 2).over(w).alias("next2")).collect()
    parts = {}
    for pos, r in enumerate(got):
        parts.setdefault(r["j"], []).append((pos, r))
    for rows in parts.values():
        rows.sort(key=lambda t: (_order(t[1]["o"]), _order(t[1]["x"]),
                                 _order(t[1]["i"]), t[0]))
        keys = [r["k"] for _, r in rows]
        for at, (_, r) in enumerate(rows):
            assert r["prev"] == (keys[at - 1] if at else None), r
            assert r["next2"] == (keys[at + 2] if at + 2 < len(keys)
                                  else None), r


def _order(v):
    """Ascending with nulls first and NaN greatest."""
    if v is None:
        return (0, 0.0)
    return (2, 0.0) if v != v else (1, v)


def test_window_off_the_device_raises_with_its_reason():
    """A window aggregate the device does not compute is tagged off it in
    ``explain_fallback()`` and fails under test mode instead of running
    on the host."""
    from spark_rapids_tpu_torch.expressions.aggregates import StddevSamp
    from spark_rapids_tpu_torch.session import Column
    s = TorchSession({"spark.rapids.sql.test.enabled": "true"}, device="cpu")
    df = _frames(s, host_valid=True)
    q = df.select("k", Column(StddevSamp(PF.col("x")._expr)).over(
        PWindow.partitionBy("k")).alias("sd"))
    assert "window aggregate StddevSamp is not supported" in \
        q.explain_fallback()
    with pytest.raises(AssertionError, match="not columnar"):
        q.collect()


def _peer(r):
    """A row's order values as peers compare them (-0.0 ties 0.0, NaN
    ties NaN)."""
    return tuple(None if r[c] is None else ("nan" if r[c] != r[c]
                                            else r[c] + 0)
                 for c in ("o", "x", "i"))


def _expected_string_window(kind, keys, peers):
    """The plain answer of each string window case over one partition's
    rows in order: ``keys`` the strings, ``peers`` the order values."""
    n = len(keys)
    if kind == "lead":
        return [keys[at + 1] if at + 1 < n else "none" for at in range(n)]
    if kind == "lag":
        return [keys[at - 2] if at >= 2 else "none" for at in range(n)]
    out = []
    for at in range(n):
        if kind == "min":  # RANGE frame: up to the current row's last peer
            end = at
            while end + 1 < n and peers[end + 1] == peers[at]:
                end += 1
            frame = keys[:end + 1]
        else:  # max over ROWS -2 .. +1
            frame = keys[max(at - 2, 0):at + 2]
        vals = [v for v in frame if v is not None]
        out.append((min(vals) if kind == "min" else max(vals))
                   if vals else None)
    return out


@pytest.mark.parametrize("fn, reason", [
    (lambda w: PF.lead("k", 1, "none").over(w), "lead"),
    (lambda w: PF.lag("k", 2, "none").over(w), "lag"),
    (lambda w: PF.min("k").over(w), "min"),
    (lambda w: PF.max("k").over(w.rowsBetween(-2, 1)), "max"),
    (lambda w: PF.sum("k").over(w),
     "window aggregate Sum of a string is not supported"),
    (lambda w: PF.avg("k").over(w.rowsBetween(-2, 1)),
     "window aggregate Average of a string is not supported"),
])
def test_window_of_a_string_off_the_device_raises_with_its_reason(fn, reason):
    """lead / lag of a string with a default and min / max of a string run
    on the device's window exec (test mode: nothing off it) and give the
    plain answer over the partition's rows in order (the reference's
    device exec takes a string column's bytes for its rows, C-ref-12). A
    string sum or avg (Spark casts it to double) is still tagged off the
    device in ``explain_fallback()`` and fails under test mode instead of
    failing in the middle of a collect."""
    s = TorchSession({"spark.rapids.sql.test.enabled": "true"}, device="cpu")
    w = PWindow.partitionBy("j").orderBy("o", "x", "i")
    q = _frames(s, host_valid=True).select("j", "o", "x", "i", "k",
                                           fn(w).alias("v"))
    if reason.startswith("window"):
        assert reason in q.explain_fallback()
        with pytest.raises(AssertionError, match="not columnar"):
            q.collect()
        return
    parts = {}
    for pos, r in enumerate(q.collect()):
        parts.setdefault(r["j"], []).append((pos, r))
    for rows in parts.values():
        rows.sort(key=lambda t: (_order(t[1]["o"]), _order(t[1]["x"]),
                                 _order(t[1]["i"]), t[0]))
        want = _expected_string_window(reason, [r["k"] for _, r in rows],
                                       [_peer(r) for _, r in rows])
        assert [r["v"] for _, r in rows] == want


def test_count_of_strings_over_a_window():
    """count of a string column counts its non-null rows, over the whole
    partition and over a running ROWS frame, on the device path."""
    s = TorchSession({}, device="cpu")
    w = PWindow.partitionBy("j").orderBy("o", "x", "i")
    q = _frames(s, host_valid=True).select(
        "j", "o", "x", "i", "k",
        PF.count("k").over(PWindow.partitionBy("j")).alias("n_all"),
        PF.count("k").over(w.rowsBetween(PWindow.unboundedPreceding,
                                         PWindow.currentRow)).alias("n_run"))
    assert "TorchWindow[" in q.explain()
    got = q.collect()
    parts = {}
    for pos, r in enumerate(got):
        parts.setdefault(r["j"], []).append((pos, r))
    for rows in parts.values():
        rows.sort(key=lambda t: (_order(t[1]["o"]), _order(t[1]["x"]),
                                 _order(t[1]["i"]), t[0]))
        total = sum(r["k"] is not None for _, r in rows)
        running = 0
        for _, r in rows:
            running += r["k"] is not None
            assert r["n_all"] == total and r["n_run"] == running, r
