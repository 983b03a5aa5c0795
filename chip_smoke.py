"""Smoke run of the PyTorch/CUDA port on one GPU: TPC-H Q1, Q6 and q3 end
to end.

    python3 chip_smoke.py

Phases (any failure exits nonzero; without a CUDA device it exits 2 and
prints no result):

1. the card: name and power limit as nvidia-smi reports them;
2. build: both Q1 kernels from spark_rapids_tpu_torch/csrc with nvcc for
   sm_90a; ptxas's registers and spills, and q1_agg_simt's geometry
   (resident blocks an SM, shared memory a block);
3. kernels: each kernel against its plain PyTorch version on the card at
   n in {100, 12345, 2^15, 2^24} and with a validity mask, at n around a
   multiple of 4, one block's step and one wave's step, and on columns
   sliced 1, 2 or 3 elements in (all alike: the head path; mixed: the
   scalar loop) (counts exact, sums rtol 1e-4); two launches at 2^24 give
   identical bytes;
4. main path, with every launch counter set to 0 first: entry()'s step at
   2^16 rows, q1_step_best("cuda") at 2^24 and the tensor-core step at 2^24,
   each against the numpy oracle; then framework Q1 at 2^24 rows through
   TorchSession → device_cache → DataFrame → compiled aggregation stage,
   against a numpy float64 oracle (keys and counts exact, rtol 1e-9); the
   counters must show every kernel launched;
5. timing: each kernel's median time by CUDA events against its bound, its
   device time split into the main kernel and the partials pass
   (torch.profiler), its plain version's time, and the framework's
   best-of-5 warm collect();
6. both device paths of the planning route (optimizer -> CPU plan ->
   override engine -> transitions), each against a numpy float64 oracle
   (keys and counts exact, sums and averages rtol 1e-9):
   (a) TPC-H Q6 at 2^24 rows on the compiled stage;
   (b) Q1 at 2^24 on the general sort-based aggregate (compiled stage off,
       test mode on: the whole plan must convert), two collects identical;
   (c) Q1 at 2^22 over batchSizeRows=2^20: the out-of-core sort fallback;
   (d) a group by l_shipdate (2191 keys) past maxGroups=1024: the compiled
       stage re-runs on the general path and counts the re-run;
   (e) Q1 with ORDER BY its keys at 2^24: six rows in key order.
   (a) and (b) each print a line: best of 3 warm collect(), Mrows/s, device
   busy ms, idle share and the top five device ops;
7. TPC-H q3 (customer ⋈ orders ⋈ lineitem, group by order, top 10 by
   revenue) over the port's datagen tables (seed 42), each against a numpy
   oracle (np.searchsorted joins, np.add.reduceat sums; keys exact, revenue
   rtol 1e-9):
   (a) 2^24 lineitem rows device-cached in one batch: the compiled star-join
       stage (dims=1), no re-run, two collects identical;
   (b) 2^22 rows in 4 partitions, 8 shuffle partitions, compiled join stage
       off: hash exchanges (n=4) under the symmetric shuffled join, and a
       broadcast join; the same rows as the compiled stage on those tables;
   (c) 2^18 rows in 4 partitions: broadcast joins only;
   (d) maxDimRows below the dimension's rows: the compiled join stage
       re-runs on the general path (fallbackReruns 0 -> 1);
   (e) hash partition ids of 2^24 int64 keys, n=16: the card's equal the
       CPU's bit for bit;
   (f) c_mktsegment = 'BUILDING' over 2^24 customer-shaped rows: the count
       equals numpy's.
   (a) and (b) print the timing line of phase 6, (a) with the
   device_cache() seconds, and (a) the cost of the deterministic grouped
   sum (stable sort + segmented sum against one index_add_).

The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import time

import numpy as np
import torch

N_BIG = 1 << 24
SIZES = (100, 12345, 1 << 15, N_BIG)
RTOL_KERNEL = 1e-4  # f32 sums in another order (tests/test_q1_kernels.py)
RTOL_FRAMEWORK = 1e-9  # float64 sums in another order
BYTES_PER_ROW = 29  # four int32/f32 + three f32 + one bool, read once
#: f32 ops a row in q1_agg_simt: 8 for the measures, 6 adds into the slots
SIMT_OPS_PER_ROW = 14
#: tensor-core ops a row: 2 TF32 MMAs of 16x8x8 per 8 rows, 2 ops a MAC
MMA_OPS_PER_ROW = 2 * 2 * 16 * 8 * 8 // 8
#: published dense peaks (NVIDIA data sheets): memory B/s, f32 and TF32 op/s
PEAKS = {"H100 PCIe": (2.0e12, 51e12, 378e12),
         "H100 NVL": (3.9e12, 60e12, 418e12),
         "H200": (4.8e12, 67e12, 495e12),
         "H100": (3.35e12, 67e12, 495e12)}


def card_peaks(name: str):
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    raise RuntimeError(f"no published peaks for {name!r}")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def compare_sums(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Kernel vs plain [16, M] sums: count columns (5+) exact, the rest
    within RTOL_KERNEL; returns the max absolute error."""
    torch.cuda.synchronize()
    g, w = got.double().cpu(), want.double().cpu()
    check(torch.equal(g[:, 5:], w[:, 5:]), f"{what}: counts differ")
    err = (g - w).abs()
    check(bool((err[:, :5] <= RTOL_KERNEL * w[:, :5].abs()).all()),
          f"{what}: sums beyond rtol {RTOL_KERNEL}: max err {err.max()}")
    return float(err.max())


def compare_step(out, oracle, what: str) -> None:
    check(np.array_equal(out["count_order"].cpu().numpy(),
                         oracle["count_order"]), f"{what}: count_order")
    for k in ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge"):
        got = out[k].double().cpu().numpy()
        check(bool(np.isfinite(got).all()), f"{what}: {k} not finite")
        np.testing.assert_allclose(got, oracle[k], rtol=RTOL_KERNEL,
                                   err_msg=what)


def time_ms(fn, iters: int, reps: int = 5, warmup: int = 3) -> float:
    """Median over `reps` runs of CUDA-event time across `iters`
    back-to-back calls, per call (the queue stays full, so a gap between
    launches does not count)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / iters)
    return float(np.median(times))


def profile_device(fn, iters: int):
    """torch.profiler over `iters` calls: (device-busy ms per call, every
    device op as (name, ms per call), most time first, device ops a call).
    Busy time sums the device time of every kernel and copy."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    from torch.autograd import DeviceType
    # device-side events only: a CPU op's own device total repeats its
    # kernels' time
    per_op = [(ev.key, ev.self_device_time_total / 1e3 / iters)
              for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA
              and ev.self_device_time_total > 0]
    per_op.sort(key=lambda kv: -kv[1])
    launches = sum(ev.count for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA) / iters
    return sum(ms for _, ms in per_op), per_op, launches


def op_ms(per_op, name: str) -> float:
    """Device ms per call of the ops whose name holds `name`."""
    found = [ms for key, ms in per_op if name in key]
    check(bool(found), f"profiler shows no {name}")
    return sum(found)


def sliced_batch(n: int, offsets, seed: int = 7):
    """make_example_batch's columns, each a contiguous slice starting
    offsets[c] elements in (data pointers off their 16-byte alignment)."""
    from spark_rapids_tpu_torch.kernels.q1 import Q1Inputs, make_example_batch
    full, cutoff = make_example_batch(n + max(offsets), seed=seed,
                                      device="cuda")
    return Q1Inputs(*(t[o:o + n] for t, o in zip(full, offsets))), cutoff


def lineitem(n: int):
    """bench.py's Q1-shaped lineitem columns (seed 42), bytes keys."""
    rng = np.random.default_rng(42)
    return {
        "l_returnflag": np.array([b"A", b"N", b"R"])[rng.integers(0, 3, n)],
        "l_linestatus": np.array([b"F", b"O"])[rng.integers(0, 2, n)],
        "l_quantity": rng.uniform(1, 50, n),
        "l_extendedprice": rng.uniform(900, 100000, n),
        "l_discount": rng.uniform(0, 0.1, n),
        "l_tax": rng.uniform(0, 0.08, n),
        "l_shipdate": rng.integers(8766, 10957, n).astype(np.int32),
    }


def framework_query(F, df):
    """bench.py's _framework_query."""
    return (df.filter(F.col("l_shipdate") <= 10471)
            .withColumn("disc_price",
                        F.col("l_extendedprice") * (1 - F.col("l_discount")))
            .withColumn("charge",
                        F.col("l_extendedprice") * (1 - F.col("l_discount"))
                        * (1 + F.col("l_tax")))
            .groupBy("l_returnflag", "l_linestatus")
            .agg(F.sum(F.col("l_quantity")).alias("sum_qty"),
                 F.sum(F.col("l_extendedprice")).alias("sum_base_price"),
                 F.sum(F.col("disc_price")).alias("sum_disc_price"),
                 F.sum(F.col("charge")).alias("sum_charge"),
                 F.avg(F.col("l_quantity")).alias("avg_qty"),
                 F.avg(F.col("l_extendedprice")).alias("avg_price"),
                 F.avg(F.col("l_discount")).alias("avg_disc"),
                 F.count(F.col("l_quantity")).alias("count_order")))


def framework_oracle(cols):
    """numpy float64 Q1 over the host columns: {(rf, ls): row}."""
    keep = cols["l_shipdate"] <= 10471
    rf = cols["l_returnflag"][keep]
    ls = cols["l_linestatus"][keep]
    keys, inv = np.unique(np.char.add(rf, ls), return_inverse=True)
    price = cols["l_extendedprice"][keep]
    disc = cols["l_discount"][keep]
    qty = cols["l_quantity"][keep]
    disc_price = price * (1 - disc)
    charge = disc_price * (1 + cols["l_tax"][keep])
    cnt = np.bincount(inv, minlength=len(keys))
    s = {name: np.bincount(inv, weights=x, minlength=len(keys))
         for name, x in (("qty", qty), ("price", price), ("disc", disc),
                         ("disc_price", disc_price), ("charge", charge))}
    out = {}
    for i, k in enumerate(keys):
        out[(k[:1].decode(), k[1:].decode())] = {
            "sum_qty": s["qty"][i], "sum_base_price": s["price"][i],
            "sum_disc_price": s["disc_price"][i],
            "sum_charge": s["charge"][i], "avg_qty": s["qty"][i] / cnt[i],
            "avg_price": s["price"][i] / cnt[i],
            "avg_disc": s["disc"][i] / cnt[i], "count_order": int(cnt[i])}
    return out


def check_framework_rows(rows, oracle) -> None:
    got = {(r["l_returnflag"], r["l_linestatus"]): r for r in rows}
    check(set(got) == set(oracle), f"framework keys {sorted(got)}")
    for key, want in oracle.items():
        for k, v in want.items():
            g = got[key][k]
            if k == "count_order":
                check(g == v, f"framework {key} count {g} != {v}")
            else:
                check(abs(g - v) <= RTOL_FRAMEWORK * abs(v),
                      f"framework {key} {k}: {g} vs {v}")


def q6_query(F, df):
    """bench.py's _framework_q6."""
    return (df.filter((F.col("l_shipdate") >= 8766)
                      & (F.col("l_shipdate") < 9131)
                      & (F.col("l_discount") >= 0.05)
                      & (F.col("l_discount") <= 0.07)
                      & (F.col("l_quantity") < 24))
            .agg(F.sum(F.col("l_extendedprice") * F.col("l_discount"))
                 .alias("revenue")))


def q6_oracle(cols) -> float:
    ship, disc = cols["l_shipdate"], cols["l_discount"]
    keep = ((ship >= 8766) & (ship < 9131) & (disc >= 0.05) & (disc <= 0.07)
            & (cols["l_quantity"] < 24))
    return float(np.sum(cols["l_extendedprice"][keep] * disc[keep]))


def check_close(got: float, want: float, what: str) -> None:
    check(abs(got - want) <= RTOL_FRAMEWORK * abs(want),
          f"{what}: {got} vs {want}")


def shipdate_query(F, df):
    return df.groupBy("l_shipdate").agg(
        F.sum(F.col("l_quantity")).alias("q"), F.count("*").alias("n"),
        F.min(F.col("l_discount")).alias("lo"),
        F.max(F.col("l_tax")).alias("hi"))


def check_shipdate_rows(rows, cols) -> None:
    """Rows of shipdate_query against numpy over the day (min/max exact)."""
    day = cols["l_shipdate"] - 8766
    cnt = np.bincount(day)
    qty = np.bincount(day, weights=cols["l_quantity"])
    lo = np.full(len(cnt), np.inf)
    hi = np.full(len(cnt), -np.inf)
    np.minimum.at(lo, day, cols["l_discount"])
    np.maximum.at(hi, day, cols["l_tax"])
    got = {r["l_shipdate"]: r for r in rows}
    days = np.nonzero(cnt)[0]
    check(set(got) == {8766 + int(d) for d in days},
          f"shipdate keys: {len(got)} vs {len(days)}")
    for d in days:
        r = got[8766 + int(d)]
        check(r["n"] == cnt[d], f"shipdate {d} count {r['n']} != {cnt[d]}")
        check_close(r["q"], qty[d], f"shipdate {d} sum")
        check(r["lo"] == lo[d] and r["hi"] == hi[d],
              f"shipdate {d} min/max {r['lo']}, {r['hi']}")


def quiet_plan(q) -> str:
    """The plan explain() prints, without printing it."""
    with contextlib.redirect_stdout(io.StringIO()):
        return q.explain()


def timed_line(key: str, q, rows: int, smi: str, **extra) -> None:
    """Best of 3 warm collect()s, then one profiled collect: one JSON line."""
    q.collect()  # warm-up
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        q.collect()
        best = min(best, time.perf_counter() - t0)
    busy_ms, top, ops = profile_device(q.collect, 1)
    print(json.dumps({key: {
        "rows": rows, "best_collect_s": best, "mrows_per_s": rows / best / 1e6,
        "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / (best * 1e3),
        "device_ops": ops,
        "top_device_ops_ms": [(k[:60], ms) for k, ms in top[:5]], **extra},
        "card": smi}), flush=True)


def general_paths(F, TorchSession, df, cols, oracle, smi) -> None:
    """Phase 6: (a)-(e) over the planning route, on both device paths.
    ``df``: the 2^24-row lineitem cached by phase 4's default session;
    ``oracle``: framework_oracle of its columns."""
    # (a) Q6 on the compiled stage
    q6 = q6_query(F, df)
    check("TorchCompiledAggStage[keys=<global>]" in quiet_plan(q6),
          "Q6 plan lacks the global compiled stage")
    rows = q6.collect()
    check(len(rows) == 1, f"Q6 gave {len(rows)} rows")
    check_close(rows[0]["revenue"], q6_oracle(cols), "Q6 revenue")
    print("(a) Q6 on the compiled stage at 2^24 ok", flush=True)
    timed_line("q6_compiled", q6, N_BIG, smi)

    # (b) Q1 on the general sort-based aggregate, whole plan on the device
    general = TorchSession({"spark.rapids.tpu.agg.compiledStage.enabled":
                            "false", "spark.rapids.sql.test.enabled": "true",
                            "spark.rapids.sql.batchSizeRows": str(N_BIG)},
                           device="cuda")
    q1g = framework_query(F, general.createDataFrame(cols).device_cache())
    plan = quiet_plan(q1g)
    check("  DeviceToHostExec\n  * TorchHashAggregate[keys=2]" in plan
          and "TorchCompiledAggStage" not in plan,
          "general Q1 plan is not DeviceToHostExec over TorchHashAggregate")
    first, second = q1g.collect(), q1g.collect()
    check_framework_rows(first, oracle)
    check(first == second, "two collects of the general path differ")
    print("(b) Q1 on the general path at 2^24 ok; two collects identical",
          flush=True)
    timed_line("q1_general", q1g, N_BIG, smi)
    del q1g, general
    torch.cuda.empty_cache()

    # (c) the out-of-core sort fallback: 2^22 rows in four 2^20-row runs
    n_mid = 1 << 22
    mid = lineitem(n_mid)
    ooc = TorchSession({"spark.rapids.tpu.agg.compiledStage.enabled": "false",
                        "spark.rapids.sql.batchSizeRows": str(1 << 20)},
                       device="cuda")
    mid_df = ooc.createDataFrame(mid).device_cache()
    check(len(mid_df._plan.batches()) == 4, "expected four cached runs")
    check_framework_rows(framework_query(F, mid_df).collect(),
                         framework_oracle(mid))
    check(ooc.counters["sort_fallback_runs"] == 1,
          f"sort fallback ran {ooc.counters['sort_fallback_runs']} times")
    print("(c) Q1 out of core at 2^22 (four runs) ok", flush=True)

    # (d) the compiled stage's runtime fallback: 2191 keys > maxGroups
    fb = TorchSession({"spark.rapids.tpu.agg.compiled.maxGroups": "1024"},
                      device="cuda")
    qd = shipdate_query(F, fb.createDataFrame(mid).device_cache())
    check("TorchCompiledAggStage" in quiet_plan(qd),
          "shipdate plan lacks the compiled stage")
    before = fb.counters["fallback_runs"]
    check_shipdate_rows(qd.collect(), mid)
    check(fb.counters["fallback_runs"] == before + 1,
          "the compiled stage did not re-run on the general path")
    print("(d) compiled stage re-ran on the general path (fallback_runs "
          f"{before} -> {fb.counters['fallback_runs']}) ok", flush=True)
    del mid_df, qd, ooc, fb
    torch.cuda.empty_cache()

    # (e) TPC-H Q1 as written: ORDER BY the group keys
    qe = framework_query(F, df).orderBy("l_returnflag", "l_linestatus")
    check("TorchSort" in quiet_plan(qe), "ordered Q1 plan lacks TorchSort")
    rows = qe.collect()
    keys = [(r["l_returnflag"], r["l_linestatus"]) for r in rows]
    check(keys == sorted(oracle), f"ordered Q1 keys {keys}")
    check_framework_rows(rows, oracle)
    print("(e) Q1 ORDER BY at 2^24 ok: six rows in key order", flush=True)


# ---------------------------------------------------------------------------
# phase 7: TPC-H q3
# ---------------------------------------------------------------------------

Q3_SEGMENT = "BUILDING"


def q3_groups_query(F, t):
    """benchmarks/tpch.py q3 without ORDER BY / LIMIT, written against the
    port: every (order, date, revenue) group."""
    li, orders, cust = t["lineitem"], t["orders"], t["customer"]
    return (cust.filter(F.col("c_mktsegment") == Q3_SEGMENT)
            .join(orders, on=cust["c_custkey"] == orders["o_custkey"])
            .join(li, on=orders["o_orderkey"] == li["l_orderkey"])
            .withColumn("revenue",
                        F.col("l_extendedprice") * (1 - F.col("l_discount")))
            .groupBy("o_orderkey", "o_orderdate")
            .agg(F.sum(F.col("revenue")).alias("revenue")))


def q3_query(F, t):
    """benchmarks/tpch.py q3, written against the port."""
    return q3_groups_query(F, t).sort(F.col("revenue").desc()).limit(10)


def strings_equal(col, word: str) -> np.ndarray:
    """numpy: which rows of a host string column (offsets + bytes) equal
    ``word``."""
    w = np.frombuffer(word.encode(), np.uint8)
    offs = col.offsets.astype(np.int64)
    hit = np.diff(offs) == len(w)
    for k, b in enumerate(w):
        hit &= col.chars[np.minimum(offs[:-1] + k, len(col.chars) - 1)] == b
    return hit


def q3_oracle(host):
    """numpy float64 q3: every group (order key → (order date, revenue))
    and the top 10 rows."""
    cust, orders = host["customer"][0], host["orders"][0]
    li = host["lineitem"][0]
    building = strings_equal(cust["c_mktsegment"], Q3_SEGMENT)
    ck = cust["c_custkey"]
    ci = np.minimum(np.searchsorted(ck, orders["o_custkey"]), len(ck) - 1)
    keep = (ck[ci] == orders["o_custkey"]) & building[ci]
    okey, odate = orders["o_orderkey"][keep], orders["o_orderdate"][keep]
    by_key = np.argsort(okey, kind="stable")
    okey, odate = okey[by_key], odate[by_key]
    lkey = li["l_orderkey"].astype(np.int64)
    oi = np.minimum(np.searchsorted(okey, lkey), max(len(okey) - 1, 0))
    hit = okey[oi] == lkey
    rev = li["l_extendedprice"] * (1 - li["l_discount"])
    g, rev = oi[hit], rev[hit]
    perm = np.argsort(g, kind="stable")
    g, rev = g[perm], rev[perm]
    starts = np.flatnonzero(np.r_[True, g[1:] != g[:-1]])
    sums = np.add.reduceat(rev, starts)
    groups = {int(okey[g[s]]): (odate[g[s]], float(v))
              for s, v in zip(starts, sums)}
    top = sorted(groups.items(), key=lambda kv: -kv[1][1])[:10]
    return groups, top


def check_q3_rows(rows, top, what: str) -> None:
    check(len(rows) == len(top), f"{what}: {len(rows)} rows, want {len(top)}")
    for r, (k, (d, v)) in zip(rows, top):
        check(r["o_orderkey"] == k and np.datetime64(r["o_orderdate"]) == d,
              f"{what}: row {r} != ({k}, {d})")
        check_close(r["revenue"], v, f"{what}: revenue of order {k}")


def check_q3_groups(rows, groups, what: str) -> None:
    """Every group of the oracle, none other: keys and dates exact, revenue
    within RTOL_FRAMEWORK."""
    check(len(rows) == len(groups), f"{what}: {len(rows)} groups, want "
          f"{len(groups)}")
    keys = np.array([r["o_orderkey"] for r in rows], np.int64)
    order = np.argsort(keys)
    want = np.array(sorted(groups), np.int64)
    check(np.array_equal(keys[order], want), f"{what}: the key sets differ")
    dates = np.array([r["o_orderdate"] for r in rows], "datetime64[D]")
    want_dates = np.array([groups[k][0] for k in want], "datetime64[D]")
    bad = np.flatnonzero(dates[order] != want_dates)
    check(not len(bad), f"{what}: {len(bad)} dates differ, first at order "
          f"{want[bad[0]] if len(bad) else None}")
    rev = np.array([r["revenue"] for r in rows], np.float64)[order]
    want_rev = np.array([groups[k][1] for k in want], np.float64)
    bad = np.flatnonzero(np.abs(rev - want_rev)
                         > RTOL_FRAMEWORK * np.abs(want_rev))
    check(not len(bad), f"{what}: {len(bad)} revenues differ, first at "
          f"order {want[bad[0]] if len(bad) else None}")


def plan_child_of(plan: str, parent: str) -> str:
    """The plan line right under the first line naming ``parent``."""
    lines = plan.splitlines()
    at = next((i for i, ln in enumerate(lines) if parent in ln), None)
    return lines[at + 1] if at is not None and at + 1 < len(lines) else ""


def group_sum_cost(rows: int, groups: int, smi) -> None:
    """What the stage's deterministic float sum costs: one stable sort of
    the group codes plus a fixed-order segmented sum, against one
    ``index_add_`` (atomics, no fixed order), at q3's shapes (the last
    group is the stage's dropped-rows slot, which it does not sum)."""
    from spark_rapids_tpu_torch.execs.compiled_join import _GroupOrder
    g = torch.from_numpy(np.random.default_rng(1).integers(
        0, groups + 1, rows)).cuda()
    x = torch.rand(rows, dtype=torch.float64, device="cuda")
    det = _GroupOrder(g, groups + 1).sum(x)
    atomic = torch.zeros(groups + 1, dtype=torch.float64,
                         device="cuda").index_add_(0, g, x)
    torch.testing.assert_close(det[:-1], atomic[:-1], rtol=1e-9, atol=1e-9)
    print(json.dumps({"deterministic_group_sum": {
        "rows": rows, "groups": groups + 1,
        "sort_and_segment_sum_ms": time_ms(
            lambda: _GroupOrder(g, groups + 1).sum(x), 5, reps=3),
        "index_add_ms": time_ms(lambda: torch.zeros(
            groups + 1, dtype=torch.float64, device="cuda").index_add_(
                0, g, x), 5, reps=3)},
        "card": smi}), flush=True)


def q3_paths(F, TorchSession, smi, device: str = "cuda", big: int = N_BIG,
             mid: int = 1 << 22, small: int = 1 << 18,
             mid_conf=None) -> None:
    """Phase 7: (a)-(f). A run with ``device="cpu"`` and small sizes checks
    the script's own logic off the card: it skips the timing lines, and
    ``mid_conf`` (e.g. a lower autoBroadcastJoinThreshold) gives (b) its
    2^22 plan shape at a small size."""
    on_card = device == "cuda"

    def release():
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    from spark_rapids_tpu_torch.columnar.batch import TorchColumnarBatch
    from spark_rapids_tpu_torch.columnar.vector import TorchColumnVector
    from spark_rapids_tpu_torch.config import RapidsConf
    from spark_rapids_tpu_torch.datagen import q3_frames, q3_host_tables
    from spark_rapids_tpu_torch.execs.base import TaskContext
    from spark_rapids_tpu_torch.expressions.base import AttributeReference
    from spark_rapids_tpu_torch.shuffle.partitioner import hash_partition_ids
    from spark_rapids_tpu_torch.types import LongT
    base = {"spark.rapids.shuffle.mode": "ICI",
            "spark.sql.shuffle.partitions": "8"}

    # (a) the compiled star-join stage at 2^24 lineitem rows
    host = q3_host_tables(big, 1)
    groups, top = q3_oracle(host)
    s = TorchSession(dict(base, **{"spark.rapids.sql.batchSizeRows":
                                   str(big)}), device=device)
    t = q3_frames(s, host)
    t0 = time.perf_counter()
    t["lineitem"] = t["lineitem"].device_cache()
    release()
    cache_s = time.perf_counter() - t0
    qa = q3_query(F, t)
    check("TorchCompiledJoinAggStage[keys=o_orderkey, o_orderdate, dims=1]"
          in quiet_plan(qa), "q3 plan lacks the compiled join stage")
    first, second = qa.collect(), qa.collect()
    check_q3_rows(first, top, "q3 compiled 2^24")
    check(first == second, "two collects of the compiled join stage differ")
    check_q3_groups(q3_groups_query(F, t).collect(), groups,
                    "q3 compiled 2^24 without the limit")
    check(s.counters["fallbackReruns"] == 0, "the compiled join stage re-ran")
    print(f"(a) q3 on the compiled join stage at 2^24 ok: top 10 and all "
          f"{len(groups)} groups equal the oracle; two collects identical",
          flush=True)
    if on_card:
        timed_line("q3_compiled", qa, big, smi, device_cache_s=cache_s,
                   groups=len(groups))
        group_sum_cost(big, 1 << 20, smi)
    check(s.counters["fallbackReruns"] == 0, "the compiled join stage re-ran")
    del qa, t, s, host
    release()

    # (b) the general path at 2^22: exchanges, symmetric and broadcast joins
    host = q3_host_tables(mid, 4)
    groups, top = q3_oracle(host)
    g = TorchSession(dict(base, **{
        "spark.rapids.tpu.join.compiledStage.enabled": "false"},
        **(mid_conf or {})), device=device)
    qb = q3_query(F, q3_frames(g, host))
    plan = quiet_plan(qb)
    check("TorchShuffleExchange[hash, n=4]" in plan_child_of(
              plan, "TorchShuffledSymmetricHashJoin[inner]")
          and "TorchBroadcastHashJoin[inner]" in plan,
          "general q3 plan lacks the exchange under the symmetric join or "
          "the broadcast join:\n" + plan)
    rows_b = qb.collect()
    check_q3_rows(rows_b, top, "q3 general 2^22")
    c = TorchSession(dict(base, **{"spark.rapids.sql.batchSizeRows":
                                   str(mid)}), device=device)
    tc = q3_frames(c, host)
    tc["lineitem"] = tc["lineitem"].device_cache()
    qc = q3_query(F, tc)
    check("TorchCompiledJoinAggStage" in quiet_plan(qc),
          "q3 plan at 2^22 lacks the compiled join stage")
    rows_c = qc.collect()
    check([(r["o_orderkey"], r["o_orderdate"]) for r in rows_b]
          == [(r["o_orderkey"], r["o_orderdate"]) for r in rows_c],
          "general and compiled q3 keys differ at 2^22")
    for rb, rc in zip(rows_b, rows_c):
        check_close(rb["revenue"], rc["revenue"], "general vs compiled")
    print("(b) q3 general at 2^22 ok (hash exchanges, symmetric and "
          "broadcast joins); equal to the compiled stage's rows", flush=True)
    if on_card:
        timed_line("q3_general", qb, mid, smi, groups=len(groups))

    # (d) the compiled join stage's re-run: maxDimRows below the dimension
    d = TorchSession(dict(base, **{"spark.rapids.sql.batchSizeRows":
                                   str(mid),
                                   "spark.rapids.tpu.join.compiled."
                                   "maxDimRows": "16"}), device=device)
    td = q3_frames(d, host)
    td["lineitem"] = td["lineitem"].device_cache()
    qd = q3_query(F, td)
    check("TorchCompiledJoinAggStage" in quiet_plan(qd),
          "re-run plan lacks the compiled join stage")
    before = d.counters["fallbackReruns"]
    check_q3_rows(qd.collect(), top, "q3 re-run 2^22")
    check(d.counters["fallbackReruns"] == before + 1,
          "the compiled join stage did not re-run")
    print(f"(d) compiled join stage re-ran (fallbackReruns {before} -> "
          f"{d.counters['fallbackReruns']}) ok", flush=True)
    del qb, qc, qd, tc, td, g, c, d, host
    release()

    # (c) q3_general_4part's shape: 2^18 rows, broadcast joins only
    host = q3_host_tables(small, 4)
    qs = q3_query(F, q3_frames(TorchSession(dict(base, **{
        "spark.rapids.tpu.join.compiledStage.enabled": "false"}),
        device=device), host))
    plan = quiet_plan(qs)
    check("TorchBroadcastHashJoin" in plan and "Exchange" not in plan
          and "Symmetric" not in plan, "q3 at 2^18 is not broadcast-only")
    check_q3_rows(qs.collect(), q3_oracle(host)[1], "q3 general 2^18")
    print("(c) q3 general at 2^18 ok (broadcast joins only)", flush=True)

    # (e) hash partition ids at 2^24 int64 keys, n = 16
    keys = np.random.default_rng(0).integers(0, 1 << 40, big)
    key = AttributeReference("k", LongT, ordinal=0)

    def partition_ids(dev: str):
        col = TorchColumnVector(LongT, torch.from_numpy(keys).to(dev), None,
                                big)
        batch = TorchColumnarBatch([col], big)
        ctx = TaskContext(0, RapidsConf(), torch.device(dev))
        return lambda: hash_partition_ids(batch, [key], 16, ctx)

    on_device = partition_ids(device)
    pid = on_device()
    check(torch.equal(pid.cpu(), partition_ids("cpu")()),
          "partition ids differ card vs CPU")
    if on_card:
        print(json.dumps({"hash_partition_ids": {
            "rows": big, "n": 16, "ms": time_ms(on_device, 5, reps=3),
            "counts": torch.bincount(pid.long(), minlength=16).tolist()},
            "card": smi}), flush=True)
    print("(e) hash partition ids at 2^24 equal the CPU's ok", flush=True)

    # (f) string equality over 2^24 customer-shaped rows
    from spark_rapids_tpu_torch import datagen as dg
    spec = next(c for c in dg.tpch_customer(big).columns
                if c.name == "c_mktsegment")
    seg, _ = spec.generate(dg._cell_rng(42, "customer", "c_mktsegment", 0),
                           big)
    f = TorchSession(device=device).createDataFrame({"c_mktsegment": seg})
    got = f.filter(F.col("c_mktsegment") == Q3_SEGMENT).agg(
        F.count("*").alias("n")).collect()[0]["n"]
    want_n = int(strings_equal(seg, Q3_SEGMENT).sum())
    check(got == want_n, f"BUILDING count {got} != numpy {want_n}")
    print(f"(f) c_mktsegment = 'BUILDING' over 2^24 rows ok ({got})",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from spark_rapids_tpu_torch.entry import entry
    from spark_rapids_tpu_torch.kernels import build, q1_cuda
    from spark_rapids_tpu_torch.kernels.q1 import (make_example_batch,
                                                   q1_reference_numpy)
    from spark_rapids_tpu_torch.kernels.q1_cuda import mma_blocks, simt_plan
    from spark_rapids_tpu_torch.session import TorchSession
    import spark_rapids_tpu_torch.functions as F

    # 1. the card
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    mem_bps, f32_ops, tf32_ops = card_peaks(name)
    print(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in f32

    # 2. build
    t0 = time.perf_counter()
    build.build_all([q1_cuda.SOURCE])
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for line in build.BUILD_LOG.get(q1_cuda.SOURCE, (0, ""))[1].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  " + line.strip())
    geo = q1_cuda.simt_geometry(torch.device("cuda", 0))
    print(f"q1_agg_simt geometry: {geo}", flush=True)
    check(geo.spill_bytes == 0, "q1_agg_simt spills to local memory")

    # 3. each kernel against its plain version on the card
    kernels = {"q1_agg_simt": (q1_cuda.q1_agg_simt, q1_cuda.q1_agg_simt_plain),
               "q1_agg_mma": (q1_cuda.q1_agg_mma, q1_cuda.q1_agg_mma_plain)}
    max_err = {k: 0.0 for k in kernels}
    block_step = 4 * geo.threads  # rows a block covers in one vector step
    wave_step = block_step * geo.blocks_per_sm * geo.sms
    aligned = (0,) * 8
    cases = ([(n, None, aligned) for n in SIZES]
             + [(1 << 12, 3, aligned), (N_BIG, 3, aligned)]
             + [(n, None, aligned) for n in
                (0, 1, 3, 4, 5, 4095, 4097, 4098, 4099, block_step - 1,
                 block_step, block_step + 1, block_step + 5, wave_step - 1,
                 wave_step, wave_step + 3)]
             + [(n, mask, offsets) for n in (5, 12345, wave_step + 3)
                for mask, offsets in ((None, (1,) * 8), (3, (2,) * 8),
                                      (None, (3,) * 8),
                                      (3, (0, 1, 2, 3, 1, 2, 3, 0)))])
    for n, mask_every, offsets in cases:
        batch, cutoff = sliced_batch(n, offsets)
        if mask_every:
            batch.valid[::mask_every] = False
        for kname, (kernel, plain) in kernels.items():
            before = q1_cuda.launches[kname]
            err = compare_sums(kernel(batch, cutoff), plain(batch, cutoff),
                               f"{kname} n={n} mask={mask_every} "
                               f"offsets={offsets}")
            check(q1_cuda.launches[kname] == before + 1,
                  f"{kname} launch counter did not rise")
            if n == N_BIG and mask_every is None:
                max_err[kname] = err
                again = kernel(batch, cutoff)
                check(torch.equal(again, kernel(batch, cutoff)),
                      f"{kname}: two launches at 2^24 differ")
    print(f"kernels vs plain ok: {len(cases)} cases; two launches at 2^24 "
          "identical", flush=True)

    # 4. the main path, counters from 0
    q1_cuda.reset_launch_counts()
    step, (batch, cutoff) = entry()
    compare_step(step(batch, cutoff), q1_reference_numpy(batch, cutoff),
                 "entry() step at 2^16")
    big, big_cut = make_example_batch(N_BIG, device="cuda")
    big_oracle = q1_reference_numpy(big, int(big_cut))
    compare_step(q1_cuda.q1_step_best("cuda")(big, big_cut), big_oracle,
                 "q1_step_best at 2^24")
    compare_step(q1_cuda.q1_step_mma(big, big_cut), big_oracle,
                 "tensor-core step at 2^24")
    print("main path kernel steps ok", flush=True)

    cols = lineitem(N_BIG)
    t0 = time.perf_counter()
    session = TorchSession({"spark.rapids.sql.batchSizeRows": str(N_BIG)},
                           device="cuda")
    df = session.createDataFrame(cols, num_partitions=1).device_cache()
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - t0
    q = framework_query(F, df)
    plan = q.explain()
    check("TorchCompiledAggStage" in plan, "plan lacks the compiled stage")
    oracle = framework_oracle(cols)
    check_framework_rows(q.collect(), oracle)
    print("framework Q1 at 2^24 ok", flush=True)
    launches = dict(q1_cuda.launches)
    for kname in kernels:
        check(launches[kname] > 0, f"{kname} never launched on the main path")

    # 5. timing
    ptrs = [t.data_ptr() for t in big]
    geometry = {
        "q1_agg_simt": {
            "grid": simt_plan(N_BIG, ptrs[:7], ptrs[7], geo.sms,
                              geo.blocks_per_sm, geo.threads).blocks,
            "blocks_per_sm": geo.blocks_per_sm,
            "threads": geo.threads, "registers": geo.registers,
            "smem_bytes_per_block": geo.smem_bytes},
        "q1_agg_mma": {"grid": mma_blocks(N_BIG, geo.sms)}}
    lines = []
    for kname, (kernel, plain) in kernels.items():
        ops_per_row = SIMT_OPS_PER_ROW if kname == "q1_agg_simt" \
            else MMA_OPS_PER_ROW
        peak = f32_ops if kname == "q1_agg_simt" else tf32_ops
        bytes_ms = (BYTES_PER_ROW * N_BIG + 16 * q1_cuda.WIDTH[kname] * 4) \
            / mem_bps * 1e3
        ops_ms = ops_per_row * N_BIG / peak * 1e3
        device_ms, per_op, _ = profile_device(lambda: kernel(big, big_cut),
                                              10)
        before = q1_cuda.launches[kname]
        (q1_cuda.q1_step_simt if kname == "q1_agg_simt"
         else q1_cuda.q1_step_mma)(big, big_cut)
        per_step = q1_cuda.launches[kname] - before
        lines.append({
            "name": kname, "route": "cuda",
            "source": "spark_rapids_tpu_torch/csrc/q1_agg.cu",
            "replaces": ("spark_rapids_tpu/kernels/q1_pallas.py:32"
                         if kname == "q1_agg_simt" else
                         "spark_rapids_tpu/kernels/q1_pallas.py:118"),
            "launches": launches[kname],
            "launches_per_q1_step": per_step,
            "max_abs_err": max_err[kname],
            "ms": time_ms(lambda: kernel(big, big_cut), 20),
            "device_ms": device_ms,
            "plain_ms": time_ms(lambda: plain(big, big_cut), 5, reps=3,
                                warmup=1),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "rows": N_BIG,
            "kernel_device_ms": op_ms(per_op, f"{kname}_kernel"),
            "pass_device_ms": op_ms(per_op, "q1_sum_partials_kernel"),
            **geometry[kname]})
    print(json.dumps({"kernels": lines, "card": smi}), flush=True)

    rows = q.collect()  # warm-up
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        rows = q.collect()
        best = min(best, time.perf_counter() - t0)
    check_framework_rows(rows, oracle)
    busy_ms, top, ops = profile_device(q.collect, 1)
    print(json.dumps({"framework_q1": {
        "rows": N_BIG, "best_collect_s": best,
        "mrows_per_s": N_BIG / best / 1e6, "device_cache_s": cache_s,
        "batches": len(df._plan.batches()),
        "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / (best * 1e3), "device_ops": ops,
        "top_device_ops_ms": [(k[:60], ms) for k, ms in top[:5]]},
        "card": smi}), flush=True)

    # 6. both device paths of the planning route
    general_paths(F, TorchSession, df, cols, oracle, smi)
    del df, q, big, cols
    torch.cuda.empty_cache()

    # 7. TPC-H q3: joins, the hash exchange, TopN, the star-join stage
    q3_paths(F, TorchSession, smi)

    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
