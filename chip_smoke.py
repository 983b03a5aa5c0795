"""Smoke run of the PyTorch/CUDA port on one GPU: all 22 TPC-H queries of
benchmarks/tpch.py end to end (as spark_rapids_tpu_torch/tpch.py writes
them), and the parquet scan.

    python3 chip_smoke.py

Phases (any failure exits nonzero; without a CUDA device it exits 2 and
prints no result):

1. the card: name and power limit as nvidia-smi reports them, and
   whether ``import pyarrow`` succeeds on the machine (the scan needs it:
   the phase fails without it);
2. build: both Q1 kernels from spark_rapids_tpu_torch/csrc with nvcc for
   sm_90a; ptxas's registers and spills, and q1_agg_simt's geometry
   (resident blocks an SM, shared memory a block);
3. kernels: each kernel against its plain PyTorch version on the card at
   n in {100, 12345, 2^15, 2^24} and with a validity mask, at n around a
   multiple of 4, one block's step and one wave's step, and on columns
   sliced 1, 2 or 3 elements in (all alike: the head path; mixed: the
   scalar loop) (counts exact, sums rtol 1e-4); two launches at 2^24 give
   identical bytes; the closest single PyTorch call, index_add_ of the
   masked measures over the group ids at 2^24, timed (the kernels line's
   library_ms) with its counts exact and its f32 atomic sums' error
   against the plain version printed;
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
   sum (stable sort + segmented sum against one index_add_);
8. TPC-H q4, q13 and q18 (semi, anti and outer joins, string keys past
   7 bytes, LIKE) over the same tables, each against a numpy oracle
   (keys, dates, prices and counts exact):
   (a) q18 at 2^24 lineitem rows device-cached in one batch: the compiled
       star-join stage (dims=1: orders ⋉ big ⋈ customer), no re-run; the
       top 100 rows and, without sort and limit, every group; two
       collects identical;
   (b) q4, q13 and q18 at 2^22 in benchmarks/tpch.py's layout (4 + 4
       partitions, 8 shuffle partitions, ICI), default conf; two collects
       identical each;
   (c) q18 at 2^22 with the join stage off: a semi, a symmetric and a
       broadcast hash join;
   (d) every hash-join type (inner, left/right/full outer, left semi,
       left anti) with and without a residual condition over 2^20 probe
       rows, on int64 keys and on string keys of 0-40 bytes with nulls;
       LIKE over 2^24 strings with '%NOT%', 'PROMO%', '%BRASS', '_-%' and
       an escaped '%'.
   (a) and each query of (b) print phase 6's timing line and their
   physical plan;
9. the parquet scan (session.read.parquet → the device page decode →
   the device operators), in a temporary directory deleted at exit:
   (a) the port's datagen lineitem at 2^24 rows written in bench.py's
       layout (parts of 2^21 rows through one writer, snappy, row groups
       of 2^20: 16 row groups), its size printed; the pinned
       host-to-device copy rate;
   (b) bench.py's two scan_agg queries (a filter and a group by
       l_returnflag; a group by three string columns) with the device
       decode on and off (off: pyarrow reads one row group a chunk, so
       both paths hand the aggregate the same batches), each against a
       numpy oracle (keys and counts exact, float64 sums rtol 1e-9); on
       and off identical, two collects identical, every fallback counter
       0, the scan pruned to the query's columns;
   (c) TPC-H Q1 over the same file on the compiled aggregation stage and
       on the general aggregate (test mode on), against framework_oracle;
   (d) one file an encoding class at 2^20 rows (PLAIN int32, int64,
       float32, float64, date and timestamp; RLE_DICTIONARY; booleans;
       nulls at densities 0, 1/2 and all; data page v2; every codec
       pa.Codec has, none first; a dictionary that falls back to PLAIN
       mid-chunk; BYTE_ARRAY strings of 0-40 bytes with nulls, plain and
       dictionary) and a hive-partitioned directory, decoded on the card
       and held byte for byte against pyarrow's read of the same file.
   (b) and (c) print a timing line each: phase 6's fields, the file's
   GB/s, and the scan's split (host stage, upload, device decode and
   host decode ms, row groups, bytes staged) a collect;
10. the other 16 TPC-H queries (q2, q5, q7-q12, q14-q17, q19-q22: the
   five other tables, CASE WHEN, IN, casts, round, substring, distinct,
   the nested-loop join) over phase 8's 2^22-row tables plus supplier,
   part, partsupp, nation and region at the benchmark's ratios, each
   against a numpy float64 oracle (searchsorted joins on unique keys,
   np.unique + bincount groups; integers, strings and nulls exact, floats
   rtol 1e-9, rows in the query's order), with the intermediates of the
   queries whose answer can be null or zero (q8's numerator and
   denominator, q17's per-part thresholds and the rows under them, q19's
   rows by brand): first in benchmarks/tpch.py's layout (4 + 4
   partitions, 8 shuffle partitions, ICI), each query's physical plan
   and phase 6's timing line; then with every table in one partition and
   lineitem device_cache()d in one batch. A line names any null or zero
   in a result's first row.

The kernels line (phase 5) prints again before the card's name and power
limit, and the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
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
             mid_conf=None, tables=None) -> None:
    """Phase 7: (a)-(f). A run with ``device="cpu"`` and small sizes checks
    the script's own logic off the card: it skips the timing lines, and
    ``mid_conf`` (e.g. a lower autoBroadcastJoinThreshold) gives (b) its
    2^22 plan shape at a small size. ``tables`` keeps the host tables for
    phase 8."""
    tables = {} if tables is None else tables
    on_card = device == "cuda"

    def release():
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch.columnar.batch import TorchColumnarBatch
    from spark_rapids_tpu_torch.columnar.vector import TorchColumnVector
    from spark_rapids_tpu_torch.config import RapidsConf
    from spark_rapids_tpu_torch.datagen import q3_frames
    from spark_rapids_tpu_torch.execs.base import TaskContext
    from spark_rapids_tpu_torch.expressions.base import AttributeReference
    from spark_rapids_tpu_torch.shuffle.partitioner import hash_partition_ids
    from spark_rapids_tpu_torch.types import LongT
    base = {"spark.rapids.shuffle.mode": "ICI",
            "spark.sql.shuffle.partitions": "8"}

    # (a) the compiled star-join stage at 2^24 lineitem rows
    host = tpch_host(tables, big, 1)
    groups, top = q3_oracle(host)
    s = TorchSession(dict(base, **{"spark.rapids.sql.batchSizeRows":
                                   str(big)}), device=device)
    t = q3_frames(s, host)
    t0 = time.perf_counter()
    t["lineitem"] = t["lineitem"].device_cache()
    release()
    cache_s = time.perf_counter() - t0
    qa = tpch.q3(t)
    check("TorchCompiledJoinAggStage[keys=o_orderkey, o_orderdate, dims=1]"
          in quiet_plan(qa), "q3 plan lacks the compiled join stage")
    first, second = qa.collect(), qa.collect()
    check_q3_rows(first, top, "q3 compiled 2^24")
    check(first == second, "two collects of the compiled join stage differ")
    check_q3_groups(tpch.q3_groups(t).collect(), groups,
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
    host = tpch_host(tables, mid, 4)
    groups, top = q3_oracle(host)
    g = TorchSession(dict(base, **{
        "spark.rapids.tpu.join.compiledStage.enabled": "false"},
        **(mid_conf or {})), device=device)
    qb = tpch.q3(q3_frames(g, host))
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
    qc = tpch.q3(tc)
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
    qd = tpch.q3(td)
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
    host = tpch_host(tables, small, 4)
    qs = tpch.q3(q3_frames(TorchSession(dict(base, **{
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


# ---------------------------------------------------------------------------
# phase 8: TPC-H q4, q13 and q18; every hash-join type; LIKE
# ---------------------------------------------------------------------------


def host_strings(col, rows=None) -> list:
    """Python strings of a host string column (offsets + bytes), of every
    row or of the rows given."""
    offs = col.offsets.astype(np.int64)
    raw = col.chars.tobytes()
    rows = range(len(offs) - 1) if rows is None else rows
    return [raw[offs[i]:offs[i + 1]].decode() for i in rows]


def word_codes(col, words) -> np.ndarray:
    """numpy: each row's index in ``words`` (-1 for none) of a host string
    column built from those words."""
    code = np.full(len(col.offsets) - 1, -1, np.int64)
    for i, w in enumerate(words):
        code[strings_equal(col, w)] = i
    return code


#: the tables phases 7 and 8 read
Q3_TABLES = ("lineitem", "orders", "customer")


def tpch_host(tables: dict, rows: int, parts: int, names=Q3_TABLES):
    """``datagen.tpch_host_tables`` memoized in ``tables`` (main's) table
    by table, so the phases share one build of each table and size."""
    from spark_rapids_tpu_torch.datagen import tpch_host_tables
    have = tables.setdefault((rows, parts), {})
    missing = [n for n in names if n not in have]
    if missing:
        have.update(tpch_host_tables(rows, parts, missing))
    return {n: have[n] for n in names}


def q4_oracle(host):
    """numpy q4: [(priority, order count)] in priority order."""
    from spark_rapids_tpu_torch.datagen import _PRIORITIES
    orders, li = host["orders"][0], host["lineitem"][0]
    n_o = len(orders["o_orderkey"])
    late = li["l_commitdate"] < li["l_receiptdate"]
    has_late = np.zeros(n_o, bool)
    has_late[li["l_orderkey"][late]] = True
    od = orders["o_orderdate"].astype(np.int64)
    sel = (od >= 8582) & (od < 8674) & has_late[orders["o_orderkey"]]
    code = word_codes(orders["o_orderpriority"], _PRIORITIES)
    counts = np.bincount(code[sel], minlength=len(_PRIORITIES))
    return sorted((p, int(c)) for p, c in zip(_PRIORITIES, counts) if c)


def q13_oracle(host):
    """numpy q13: [(c_count, custdist)] by custdist, then c_count, both
    descending."""
    from spark_rapids_tpu_torch.datagen import _PRIORITIES
    orders, cust = host["orders"][0], host["customer"][0]
    code = word_codes(orders["o_orderpriority"], _PRIORITIES)
    not_like = ~np.isin(code, [i for i, p in enumerate(_PRIORITIES)
                               if "NOT" in p])
    ck = cust["c_custkey"]
    ok = orders["o_custkey"][not_like].astype(np.int64)
    ci = np.minimum(np.searchsorted(ck, ok), len(ck) - 1)
    c_count = np.bincount(ci[ck[ci] == ok], minlength=len(ck))
    dist = np.bincount(c_count)
    return sorted(((int(c), int(n)) for c, n in enumerate(dist) if n),
                  key=lambda cn: (-cn[1], -cn[0]))


def q18_oracle(host):
    """numpy q18: every group (o_orderkey → (c_name, c_custkey,
    o_orderdate, o_totalprice, sum_qty)) and the top 100 rows."""
    orders, cust, li = (host[k][0] for k in ("orders", "customer",
                                             "lineitem"))
    n_o = len(orders["o_orderkey"])
    # float64 sums of integer quantities are exact (far below 2^53)
    qty = np.bincount(li["l_orderkey"], weights=li["l_quantity"],
                      minlength=n_o).astype(np.int64)
    ck = cust["c_custkey"]
    ok = orders["o_custkey"].astype(np.int64)
    ci = np.minimum(np.searchsorted(ck, ok), len(ck) - 1)
    sel = np.flatnonzero((qty[orders["o_orderkey"]] > 150) & (ck[ci] == ok))
    okey = orders["o_orderkey"][sel]
    names = host_strings(cust["c_name"], ci[sel])
    groups = {int(k): (nm, int(ck[c]), d, float(p), int(qty[k]))
              for k, nm, c, d, p in zip(okey, names, ci[sel],
                                        orders["o_orderdate"][sel],
                                        orders["o_totalprice"][sel])}
    top = sorted(groups.items(), key=lambda kv: (-kv[1][3], kv[1][2]))[:100]
    return groups, top


def q18_row(r):
    return (r["o_orderkey"], (r["c_name"], r["c_custkey"],
                              np.datetime64(r["o_orderdate"], "D"),
                              r["o_totalprice"], r["sum_qty"]))


def check_q18(rows, want, what: str) -> None:
    """Rows in the oracle's order, every value exact."""
    check(len(rows) == len(want), f"{what}: {len(rows)} rows, want "
          f"{len(want)}")
    for r, w in zip(rows, want):
        check(q18_row(r) == w, f"{what}: row {r} != {w}")


def check_q18_groups(rows, groups, what: str) -> None:
    got = dict(q18_row(r) for r in rows)
    check(len(got) == len(rows) == len(groups), f"{what}: {len(rows)} "
          f"groups, want {len(groups)}")
    bad = [k for k, v in groups.items() if got.get(k) != v]
    check(not bad, f"{what}: {len(bad)} groups differ, first at order "
          f"{bad[:1]}")


def physical_plan(q) -> str:
    return quiet_plan(q).split("== Physical Plan ==")[-1].strip("\n")


def join_oracle(lk, lv, rk, rv, cond: bool):
    """numpy: the (probe row, build row) pairs of an equi-join on lk = rk
    (-1: null, never matching), with ``lv < rv`` when ``cond`` (NaN:
    null)."""
    order = np.argsort(rk, kind="stable")
    ok_r = order[rk[order] >= 0]
    sk = rk[ok_r]
    lo = np.searchsorted(sk, lk, "left")
    hi = np.searchsorted(sk, lk, "right")
    cnt = np.where(lk >= 0, hi - lo, 0)
    li = np.repeat(np.arange(len(lk)), cnt)
    starts = np.repeat(lo - (np.cumsum(cnt) - cnt), cnt)
    ri = ok_r[starts + np.arange(len(li))]
    if cond:
        keep = lv[li] < rv[ri]  # False where either side is NaN
        li, ri = li[keep], ri[keep]
    return li, ri


def join_types(F, TorchSession, smi, device: str, probe: int) -> None:
    """Phase 8 (d): every hash-join type, with and without the residual
    lv < rv, over ``probe`` probe rows (four partitions) and a build side
    of probe/16 rows, on int64 keys and on string keys of 0–40 bytes
    (nulls in both); each output's (probe id, build id) multiset against
    the numpy oracle."""
    from spark_rapids_tpu_torch import datagen as dg
    rng = np.random.default_rng(8)
    n_r = max(probe // 16, 1)
    dom = max(probe // 8, 1)
    vocab = [""] + [("customer#%09d" % i)[:rng.integers(0, 19)]
                    + "é" * int(i % 3) + "z" * int(rng.integers(0, 21))
                    for i in range(1, dom)]
    vocab = list(dict.fromkeys(vocab))  # distinct: a word's index is its key
    sides = {}
    for name, n in (("l", probe), ("r", n_r)):
        key = rng.integers(0, len(vocab), n)
        null = rng.random(n) < 0.05
        v = rng.uniform(0, 1, n)
        vnull = rng.random(n) < 0.05
        sides[name] = (np.where(null, -1, key), np.where(vnull, np.nan, v),
                       {f"{name}k": key, f"{name}s": dg._strings_from_words(
                           vocab, key), f"{name}v": v,
                        f"{name}id": np.arange(n, dtype=np.int64)},
                       {f"{name}k": ~null, f"{name}s": ~null,
                        f"{name}v": ~vnull})
    s = TorchSession(device=device)
    frames = {name: s.createDataFrame(cols, num_partitions=4 if name == "l"
                                      else 1, validity=valid)
              for name, (_, _, cols, valid) in sides.items()}
    L, R = frames["l"], frames["r"]
    (lk, lv, _, _), (rk, rv, _, _) = sides["l"], sides["r"]
    checked = 0
    for keys in ("int64", "string"):
        on = (L["lk"] == R["rk"]) if keys == "int64" else \
            (L["ls"] == R["rs"])
        for cond in (False, True):
            li, ri = join_oracle(lk, lv, rk, rv, cond)
            pairs = np.stack([li, ri], 1)
            un_l = np.setdiff1d(np.arange(len(lk)), li)
            un_r = np.setdiff1d(np.arange(len(rk)), ri)
            none_l = np.full(len(un_r), -1)
            none_r = np.full(len(un_l), -1)
            want = {
                "inner": pairs,
                "leftouter": np.concatenate([pairs, np.stack(
                    [un_l, none_r], 1)]),
                "rightouter": np.concatenate([pairs, np.stack(
                    [none_l, un_r], 1)]),
                "fullouter": np.concatenate([pairs, np.stack(
                    [un_l, none_r], 1), np.stack([none_l, un_r], 1)]),
                "leftsemi": np.unique(li)[:, None],
                "leftanti": un_l[:, None]}
            for jt, w in want.items():
                q = L.join(R, on=(on & (L["lv"] < R["rv"])) if cond else on,
                           how=jt)
                got = host_ids(s, q, ("lid", "rid")[:w.shape[1]])
                w = w[np.lexsort(w.T[::-1])]
                check(np.array_equal(got, w), f"{jt} join on {keys} keys "
                      f"cond={cond}: {len(got)} rows, want {len(w)}")
                checked += 1
    print(f"(d) {checked} joins (6 types x residual or not x int64 or "
          f"string keys) over {probe} probe rows ok", flush=True)


def host_ids(s, q, names) -> np.ndarray:
    """The query's id columns as one sorted int64 array (-1 for null),
    read from its host batches without building Python rows."""
    cols = q.columns
    parts = []
    for b in s._execute_batches(q._plan):
        n = b.num_rows
        block = []
        for name in names:
            c = b.columns[cols.index(name)]
            v = c.data[:n].numpy().astype(np.int64)
            if c.validity is not None:
                v = np.where(c.validity[:n].numpy(), v, -1)
            block.append(v)
        parts.append(np.stack(block, 1))
    out = np.concatenate(parts) if parts else np.zeros((0, len(names)),
                                                        np.int64)
    return out[np.lexsort(out.T[::-1])]


LIKE_PATTERNS = ("%NOT%", "PROMO%", "%BRASS", "_-%", "%\\%%")


def like_regex(pattern: str) -> str:
    """The oracle's reading of a LIKE pattern (escape '\\') as a regex."""
    import re
    out, i = [], 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\" and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        out.append(".*" if ch == "%" else "." if ch == "_"
                   else re.escape(ch))
        i += 1
    return "".join(out)


def like_paths(F, TorchSession, smi, device: str, rows: int) -> None:
    """Phase 8 (d), LIKE: over ``rows`` strings shaped like o_orderpriority,
    p_type and c_name (and a few with '%'), each pattern's match mask
    against Python's regex over the vocabulary, and a filter's count."""
    import re
    from spark_rapids_tpu_torch import datagen as dg
    from spark_rapids_tpu_torch.columnar.batch import TorchColumnarBatch
    from spark_rapids_tpu_torch.expressions.base import AttributeReference
    from spark_rapids_tpu_torch.expressions.strings import Like
    from spark_rapids_tpu_torch.types import StringT
    vocab = (dg._PRIORITIES
             + [f"{a} {b} {c}" for a in ("PROMO", "STANDARD", "ECONOMY")
                for b in ("BRUSHED", "PLATED") for c in ("BRASS", "TIN")]
             + ["100% COTTON", "%", "", "5-LOWEST", "-"]
             + ["customer#%09d" % i for i in range(20)])
    idx = np.random.default_rng(4).integers(0, len(vocab), rows)
    col = dg._strings_from_words(vocab, idx)
    batch = TorchColumnarBatch.from_numpy_columns({"s": col}).to_device(
        device)
    df = TorchSession(device=device).createDataFrame({"s": col})
    ref = AttributeReference("s", StringT, ordinal=0)
    for pat in LIKE_PATTERNS:
        e = Like(ref, pat)
        rx = re.compile(like_regex(pat), re.DOTALL)
        hit = np.array([bool(rx.fullmatch(w)) for w in vocab])[idx]
        got = e.eval_device(batch).data[:rows].cpu().numpy()
        check(np.array_equal(got, hit), f"LIKE {pat!r}: "
              f"{int((got != hit).sum())} rows differ")
        n = df.filter(F.col("s").like(pat)).agg(
            F.count_star().alias("n")).collect()[0]["n"]
        check(n == int(hit.sum()), f"LIKE {pat!r} count {n} != {hit.sum()}")
    if device == "cuda":
        e = Like(ref, "%NOT%")
        print(json.dumps({"like": {
            "rows": rows, "pattern": "%NOT%",
            "ms": time_ms(lambda: e.eval_device(batch), 5, reps=3)},
            "card": smi}), flush=True)
    print(f"(d) LIKE over {rows} rows ok: {', '.join(LIKE_PATTERNS)}",
          flush=True)


def tpch_more_paths(F, TorchSession, smi, tables: dict,
                    device: str = "cuda", big: int = N_BIG,
                    mid: int = 1 << 22, probe: int = 1 << 20,
                    like_rows: int = N_BIG) -> None:
    """Phase 8: (a)-(d). With ``device="cpu"`` and small sizes it checks
    the script's own logic off the card (no timing lines)."""
    on_card = device == "cuda"
    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch.datagen import tpch_frames
    base = {"spark.rapids.shuffle.mode": "ICI",
            "spark.sql.shuffle.partitions": "8"}

    def release():
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def timed(key, q, rows, **extra):
        print(f"{key} plan:\n{physical_plan(q)}", flush=True)
        if on_card:
            timed_line(key, q, rows, smi, **extra)

    # (a) q18 on the compiled star-join stage at 2^24, one cached batch
    host = tpch_host(tables, big, 1)
    groups, top = q18_oracle(host)
    s = TorchSession(dict(base, **{"spark.rapids.sql.batchSizeRows":
                                   str(big)}), device=device)
    t = tpch_frames(s, host)
    t0 = time.perf_counter()
    t["lineitem"] = t["lineitem"].device_cache()
    release()
    cache_s = time.perf_counter() - t0
    qa = tpch.q18(t)
    check("TorchCompiledJoinAggStage[keys=c_name, c_custkey, o_orderkey, "
          "o_orderdate, o_totalprice, dims=1]" in quiet_plan(qa),
          "q18 plan lacks the compiled join stage")
    first, second = qa.collect(), qa.collect()
    check_q18(first, top, "q18 compiled 2^24")
    check(first == second, "two collects of q18 on the join stage differ")
    check_q18_groups(tpch.q18_groups(t).collect(), groups,
                     "q18 compiled 2^24 without the limit")
    check(s.counters["fallbackReruns"] == 0, "the q18 join stage re-ran")
    print(f"(a) q18 on the compiled join stage at {big} ok: top 100 and all "
          f"{len(groups)} groups equal the oracle; two collects identical",
          flush=True)
    timed("q18_compiled", qa, big, device_cache_s=cache_s,
          groups=len(groups))
    check(s.counters["fallbackReruns"] == 0, "the q18 join stage re-ran")
    del qa, t, s
    release()

    # (b) q4, q13 and q18 in benchmarks/tpch.py's layout, default conf
    host = tpch_host(tables, mid, 4)
    oracles = {"q4": q4_oracle(host), "q13": q13_oracle(host),
               "q18": q18_oracle(host)[1]}
    # at 2^22 the semi join's build side is past the broadcast threshold:
    # both packages shuffle it (at 4,096 rows both broadcast it)
    plans = {"q4": ("TorchCompiledAggStage[keys=o_orderpriority]",
                    "HashJoin[leftsemi]"),
             "q13": ("TorchShuffledSymmetricHashJoin[left]",
                     "TorchShuffleExchange[hash"),
             "q18": ("TorchCompiledJoinAggStage[keys=c_name",)}
    for name, query in (("q4", tpch.q4), ("q13", tpch.q13),
                        ("q18", tpch.q18)):
        s = TorchSession(base, device=device)
        q = query(tpch_frames(s, host))
        plan = quiet_plan(q)
        check(all(p in plan for p in plans[name]),
              f"{name} plan at {mid}:\n{plan}")
        first, second = q.collect(), q.collect()
        check(first == second, f"two collects of {name} differ")
        if name == "q18":
            check_q18(first, oracles[name], f"{name} {mid}")
        else:
            keys = ("o_orderpriority", "order_count") if name == "q4" \
                else ("c_count", "custdist")
            got = [(r[keys[0]], r[keys[1]]) for r in first]
            check(got == oracles[name], f"{name} {mid}: {got[:5]} vs "
                  f"{oracles[name][:5]}")
        check(s.counters["fallbackReruns"] == 0, f"{name} re-ran")
        print(f"(b) {name} at {mid} in the benchmark layout ok "
              f"({len(first)} rows equal the oracle; two collects "
              "identical)", flush=True)
        timed(f"{name}_general", q, mid)
        del q, s
        release()

    # (c) q18 with the join stage off: broadcast semi, symmetric, broadcast
    s = TorchSession(dict(base, **{
        "spark.rapids.tpu.join.compiledStage.enabled": "false"}),
        device=device)
    qc = tpch.q18(tpch_frames(s, host))
    plan = quiet_plan(qc)
    check("HashJoin[leftsemi]" in plan
          and "TorchShuffledSymmetricHashJoin[inner]" in plan
          and "TorchBroadcastHashJoin[inner]" in plan,
          f"q18 with the join stage off:\n{plan}")
    check_q18(qc.collect(), oracles["q18"], f"q18 general {mid}")
    print(f"(c) q18 at {mid} on a semi, a symmetric and a broadcast join "
          "ok", flush=True)
    print(f"q18_joins plan:\n{physical_plan(qc)}", flush=True)
    del qc, s
    release()

    # (d) every join type; LIKE
    join_types(F, TorchSession, smi, device, probe)
    release()
    like_paths(F, TorchSession, smi, device, like_rows)
    release()


# ---------------------------------------------------------------------------
# phase 9: the parquet scan
# ---------------------------------------------------------------------------

_RF, _LS = ["A", "N", "R"], ["F", "O"]


def lineitem_arrow(cols):
    """One datagen partition of lineitem as an Arrow table (bench.py's
    file schema)."""
    import pyarrow as pa

    from spark_rapids_tpu_torch.columnar.vector import HostStrings
    out = {}
    for name, v in cols.items():
        if isinstance(v, HostStrings):
            out[name] = pa.StringArray.from_buffers(
                len(v), pa.py_buffer(v.offsets.astype(np.int32)),
                pa.py_buffer(v.chars))
        else:
            out[name] = pa.array(v)
    return pa.table(out)


def fixed_strings(col) -> np.ndarray:
    """A host string column (offsets + bytes) as a numpy 'S' array."""
    offs = col.offsets.astype(np.int64)
    lens = np.diff(offs)
    mat = np.zeros((len(lens), max(int(lens.max(initial=0)), 1)), np.uint8)
    rows = np.repeat(np.arange(len(lens)), lens)
    mat[rows, np.arange(int(offs[-1])) - np.repeat(offs[:-1], lens)] = \
        col.chars[:int(offs[-1])]
    return mat.view(f"S{mat.shape[1]}").ravel()


def write_lineitem(path: str, rows: int, part_rows: int, row_group: int):
    """bench.py's scan_agg file: datagen lineitem (seed 0) written a part
    at a time through one writer, snappy, row groups of ``row_group`` rows.
    Returns the host columns the oracles read (strings as 'S' arrays)."""
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch.datagen import tpch_lineitem
    spec = tpch_lineitem(rows)
    writer, keep = None, {}
    for part, offset in enumerate(range(0, rows, part_rows)):
        n = min(part_rows, rows - offset)
        cols, valid = spec.generate_partition(0, part, n, offset=offset)
        check(not valid, "datagen lineitem has nulls")
        t = lineitem_arrow(cols)
        if writer is None:
            writer = pq.ParquetWriter(path, t.schema, compression="snappy")
        writer.write_table(t, row_group_size=row_group)
        for name in ("l_quantity", "l_extendedprice", "l_discount", "l_tax",
                     "l_shipdate", "l_returnflag", "l_linestatus",
                     "l_shipmode", "l_shipinstruct"):
            v = cols[name]
            v = fixed_strings(v) if hasattr(v, "chars") else v
            keep.setdefault(name, []).append(v)
    writer.close()
    return {k: np.concatenate(v) for k, v in keep.items()}


def scan_agg_query(F, df):
    """bench.py's _scan_agg query."""
    return (df.filter(F.col("l_quantity") < 30)
            .groupBy("l_returnflag")
            .agg(F.sum(F.col("l_extendedprice")).alias("sum_price"),
                 F.sum(F.col("l_discount")).alias("sum_disc"),
                 F.count(F.col("l_quantity")).alias("cnt")))


def scan_agg_strings_query(F, df):
    """bench.py's _scan_agg strings query: three string scan columns."""
    return (df.groupBy("l_returnflag", "l_linestatus", "l_shipmode")
            .agg(F.sum(F.col("l_quantity")).alias("sum_qty"),
                 F.count(F.col("l_shipinstruct")).alias("cnt")))


def word_unique(words: np.ndarray):
    """np.unique of an 'S' array of at most 8 bytes a value, through
    its uint64 view (keys as str, the inverse)."""
    keys, inv = np.unique(words.astype("S8").view("<u8"), return_inverse=True)
    return [k.decode() for k in keys.view("S8")], inv


def scan_agg_oracle(cols):
    """numpy scan_agg: {returnflag: (sum price, sum disc, count)}."""
    keep = cols["l_quantity"] < 30
    keys, inv = word_unique(cols["l_returnflag"][keep])
    price = np.bincount(inv, weights=cols["l_extendedprice"][keep])
    disc = np.bincount(inv, weights=cols["l_discount"][keep])
    cnt = np.bincount(inv)
    return {k: (price[i], disc[i], int(cnt[i])) for i, k in enumerate(keys)}


def scan_agg_strings_oracle(cols):
    """numpy strings query: {(rf, ls, shipmode): (sum qty, count)}."""
    parts = [word_unique(cols[c])
             for c in ("l_returnflag", "l_linestatus", "l_shipmode")]
    code = np.zeros(len(cols["l_quantity"]), np.int64)
    for keys, inv in parts:
        code = code * len(keys) + inv
    qty = np.bincount(code, weights=cols["l_quantity"].astype(np.float64))
    cnt = np.bincount(code)
    out = {}
    for c in np.flatnonzero(cnt):
        key, rest = [], int(c)
        for keys, _ in reversed(parts):
            key.append(keys[rest % len(keys)])
            rest //= len(keys)
        out[tuple(reversed(key))] = (int(qty[c]), int(cnt[c]))
    return out


def check_scan_agg(rows, oracle, what: str) -> None:
    got = {r["l_returnflag"]: r for r in rows}
    check(set(got) == set(oracle), f"{what}: keys {sorted(got)}")
    for k, (price, disc, cnt) in oracle.items():
        r = got[k]
        check(r["cnt"] == cnt, f"{what} {k}: count {r['cnt']} != {cnt}")
        check_close(r["sum_price"], price, f"{what} {k} sum_price")
        check_close(r["sum_disc"], disc, f"{what} {k} sum_disc")


def check_scan_agg_strings(rows, oracle, what: str) -> None:
    got = {(r["l_returnflag"], r["l_linestatus"], r["l_shipmode"]):
           (r["sum_qty"], r["cnt"]) for r in rows}
    check(got == oracle, f"{what}: {len(got)} groups differ from the "
          f"oracle's {len(oracle)}")


def q1_oracle_cols(cols):
    """framework_oracle's input from the scan file's columns."""
    return {**cols, "l_shipdate": cols["l_shipdate"].astype(np.int32),
            "l_quantity": cols["l_quantity"].astype(np.float64)}


def scan_columns(plan: str):
    """The column list of the plan's file scan."""
    line = next(ln for ln in plan.splitlines() if "FileScanExec" in ln)
    return sorted(line.split("cols=[")[1].split("]")[0].split(", "))


def scan_timed_line(key: str, q, s, rows: int, file_bytes: int, smi: str,
                    **extra) -> None:
    """timed_line's fields (the caller's collects were the warm-up) plus
    the scan's GB/s and the best collect's time split."""
    from spark_rapids_tpu_torch.io.device_decode import decode_stats
    best = float("inf")
    for _ in range(3):
        before, bytes0 = dict(s.counters), decode_stats()["bytes_staged"]
        t0 = time.perf_counter()
        q.collect()
        took = time.perf_counter() - t0
        if took < best:
            best = took
            split = {k: s.counters[k] - before.get(k, 0) for k in s.counters
                     if k.startswith("scan.")}
            staged = decode_stats()["bytes_staged"] - bytes0
    busy_ms, top, ops = profile_device(q.collect, 1)
    print(json.dumps({key: {
        "rows": rows, "best_collect_s": best,
        "mrows_per_s": rows / best / 1e6,
        "file_gb_per_s": file_bytes / best / 1e9,
        "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / (best * 1e3),
        "device_ops": ops,
        "top_device_ops_ms": [(k[:60], ms) for k, ms in top[:5]],
        "host_decode_ms": split.get("scan.hostDecodeMs", 0.0),
        "stage_ms": split.get("scan.stageMs", 0.0),
        "upload_ms": split.get("scan.uploadMs", 0.0),
        "device_decode_ms": split.get("scan.deviceDecodeMs", 0.0),
        "row_groups": split.get("scan.rowGroups", 0),
        "bytes_staged": staged, **extra}, "card": smi}), flush=True)


def encoding_tables(n: int, seed: int = 9):
    """One small table a device-decode encoding class: (name, table,
    write options). Values from numpy with the seed."""
    import pyarrow as pa
    rng = np.random.default_rng(seed)

    def nulls(k):
        return None if k == 0 else (np.arange(n) % k == 0)

    fixed = pa.table({
        "i32": pa.array(rng.integers(-2**31, 2**31, n, dtype=np.int64)
                        .astype(np.int32), mask=nulls(5)),
        "i64": pa.array(rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)),
        "f32": pa.array(rng.normal(size=n).astype(np.float32),
                        mask=nulls(7)),
        "f64": pa.array(rng.normal(size=n)),
        "date": pa.array(rng.integers(-20000, 20000, n).astype(np.int32),
                         mask=nulls(3)).cast(pa.date32()),
        "ts": pa.array(rng.integers(0, 2**52, n), mask=nulls(11)).cast(
            pa.timestamp("us")),
    })
    lowcard = pa.table({
        "k": pa.array(rng.integers(0, 40, n)),
        "f": pa.array(rng.integers(0, 90, n) * 0.25, mask=nulls(4)),
        "d": pa.array(rng.integers(8000, 8100, n).astype(np.int32))
        .cast(pa.date32()),
    })
    bools = pa.table({
        "b": pa.array(rng.random(n) < 0.3),
        "b_null": pa.array(rng.random(n) < 0.5, mask=nulls(4)),
        "b_all_null": pa.nulls(n, pa.bool_()),
    })
    densities = pa.table({
        "none": pa.array(rng.integers(0, 1000, n)),
        "half": pa.array(rng.integers(0, 1000, n), mask=nulls(2)),
        "all": pa.nulls(n, pa.int64()),
    })
    # k bytes each, "é" being two
    words = np.array(["é" * (k // 4) + "w" * (k - 2 * (k // 4))
                      for k in range(41)], dtype=object)
    lens = rng.integers(0, 41, n)
    text = words[lens]
    text[np.arange(n) % 6 == 0] = None
    strings = pa.table({
        "s": pa.array(text, pa.string()),
        "key": pa.array(np.array(["alpha", "beta", "", "gamma-delta"],
                                 dtype=object)[rng.integers(0, 4, n)]),
    })
    overflow = pa.table({"x": pa.array(np.arange(n, dtype=np.int64) * 7919),
                         "y": pa.array(np.arange(n) / 3.0)})
    out = [("plain", fixed, dict(use_dictionary=False)),
           ("dictionary", lowcard, dict(use_dictionary=True)),
           ("booleans", bools, {}),
           ("null-densities", densities, {}),
           ("page-v2", fixed, dict(data_page_version="2.0")),
           ("dict-overflow", overflow,
            dict(dictionary_pagesize_limit=1 << 16)),
           ("strings-plain", strings, dict(use_dictionary=False)),
           ("strings-dictionary", strings, dict(use_dictionary=True))]
    for codec in ("NONE", "snappy", "gzip", "brotli", "zstd", "lz4"):
        if codec == "NONE" or pa.Codec.is_available(codec):
            out.append((f"codec-{codec}", fixed, dict(compression=codec)))
    return out


def arrow_equal_columns(batch, table, what: str) -> None:
    """A host batch of the port against an Arrow table, byte for byte:
    null masks, fixed-width values under them, strings' bytes."""
    import pyarrow as pa
    n = batch.num_rows
    check(n == table.num_rows, f"{what}: {n} rows, want {table.num_rows}")
    for name, col in zip(batch.names, batch.columns):
        arr = table.column(name).combine_chunks()
        valid = np.asarray(arr.is_valid().to_numpy(zero_copy_only=False))
        got_valid = col.validity_or_true()[:n].numpy()
        check(np.array_equal(got_valid, valid), f"{what} {name}: nulls")
        if col.offsets is not None:
            offs = np.frombuffer(arr.buffers()[1], np.int32, n + 1,
                                 arr.offset * 4).astype(np.int64)
            chars = np.frombuffer(arr.buffers()[2], np.uint8) \
                if arr.buffers()[2] is not None else np.zeros(0, np.uint8)
            got_offs = col.offsets[:n + 1].numpy().astype(np.int64)
            lens = np.where(valid, np.diff(offs), 0)
            check(np.array_equal(np.diff(got_offs), lens),
                  f"{what} {name}: string lengths")
            src = np.repeat(offs[:-1], lens) + (
                np.arange(int(lens.sum())) - np.repeat(
                    np.cumsum(lens) - lens, lens))
            check(np.array_equal(col.data[:int(got_offs[-1])].numpy(),
                                 chars[src]), f"{what} {name}: bytes")
            continue
        t = arr.type
        if pa.types.is_date32(t):
            arr = arr.cast(pa.int32())
        elif pa.types.is_timestamp(t):
            arr = arr.cast(pa.int64())
        want = np.asarray(arr.fill_null(
            False if pa.types.is_boolean(arr.type) else 0).to_numpy(
            zero_copy_only=False))
        got = col.data[:n].numpy()
        if got.dtype.kind == "f":
            got, want = got.view(f"i{got.itemsize}"), want.view(
                f"i{want.itemsize}")
        check(np.array_equal(np.where(valid, got, 0),
                             np.where(valid, want, 0)),
              f"{what} {name}: values")


def encoding_classes(TorchSession, d: str, n: int, device: str) -> None:
    """(d): one file an encoding class, decoded on the device and held
    byte for byte against pyarrow's read of the same file; then a
    hive-partitioned directory."""
    import os

    import pyarrow as pa
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch.columnar.batch import concat_batches
    from spark_rapids_tpu_torch.io.device_decode import FALLBACK_KEYS

    def device_read(path, want):
        s = TorchSession({}, device=device)
        df = s.read.parquet(path)
        batches = s._execute_batches(df._plan)
        batch = concat_batches(batches).rename(df.columns)
        for k in FALLBACK_KEYS:
            check(s.counters[k] == 0, f"{path}: {k} = {s.counters[k]}")
        check(s.counters["scan.rowGroups"] == want,
              f"{path}: {s.counters['scan.rowGroups']} row groups decoded, "
              f"want {want}")
        return batch

    names = []
    tables = encoding_tables(n)
    for name, table, opts in tables:
        path = f"{d}/{name}.parquet"
        opts = {"row_group_size": n // 4, "data_page_size": 1 << 16,
                "compression": "snappy", **opts}
        pq.write_table(table, path, **opts)
        md = pq.ParquetFile(path).metadata
        if name == "dict-overflow":
            enc = set(md.row_group(0).column(0).encodings)
            check({"PLAIN", "RLE_DICTIONARY"} <= enc,
                  f"the writer did not fall back mid-chunk: {enc}")
        want = pq.read_table(path)
        want = pa.table({f.name: (want.column(f.name).cast(
            pa.timestamp("us", tz="UTC")) if pa.types.is_timestamp(f.type)
            else want.column(f.name)) for f in want.schema})
        arrow_equal_columns(device_read(path, md.num_row_groups), want, name)
        names.append(name)
    # a hive-partitioned directory: two partition values, two files each
    root = f"{d}/hive"
    table = tables[0][1]
    for k in (3, 7):
        os.makedirs(f"{root}/part={k}")
        for i in range(2):
            pq.write_table(table.slice(i * n // 2, n // 2),
                           f"{root}/part={k}/f{i}.parquet",
                           row_group_size=n // 4)
    got = device_read(root, 8)
    want = pa.concat_tables([table.slice(i * n // 2, n // 2)
                             for _ in (3, 7) for i in range(2)])
    want = pa.table({f.name: (want.column(f.name).cast(
        pa.timestamp("us", tz="UTC")) if pa.types.is_timestamp(f.type)
        else want.column(f.name)) for f in want.schema})
    want = want.append_column("part", pa.array([3] * n + [7] * n,
                                               pa.int64()))
    arrow_equal_columns(got, want, "hive")
    names.append("hive")
    print(f"(d) {len(names)} encoding classes at {n} rows decoded on the "
          f"device equal pyarrow byte for byte: {', '.join(names)}",
          flush=True)


def copy_rate_gbps(nbytes: int = 256 << 20) -> float:
    """Pinned host-to-device copy rate by CUDA events (median of 5)."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    ms = time_ms(lambda: dev.copy_(host, non_blocking=True), 1)
    return nbytes / (ms / 1e3) / 1e9


def scan_paths(F, TorchSession, smi, device: str = "cuda",
               rows: int = N_BIG, part_rows: int = 1 << 21,
               row_group: int = 1 << 20, enc_rows: int = 1 << 20) -> None:
    """Phase 9: (a)-(d). With ``device="cpu"`` and small sizes it checks
    the script's own logic off the card (no timing lines)."""
    import os
    import tempfile

    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch.io.device_decode import FALLBACK_KEYS
    on_card = device == "cuda"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scan_") as d:
        # (a) the file
        path = os.path.join(d, "lineitem.parquet")
        t0 = time.perf_counter()
        cols = write_lineitem(path, rows, part_rows, row_group)
        file_bytes = os.path.getsize(path)
        n_rg = pq.ParquetFile(path).metadata.num_row_groups
        check(n_rg == -(-rows // row_group), f"{n_rg} row groups")
        print(f"(a) lineitem at {rows} rows written in "
              f"{time.perf_counter() - t0:.1f} s: {file_bytes / 1e9:.3f} GB, "
              f"{n_rg} row groups of {row_group}", flush=True)
        if on_card:
            rate = copy_rate_gbps()
            print(json.dumps({"pinned_h2d_copy_gbps": rate,
                              "hbm_bound_gbps": card_peaks(
                                  torch.cuda.get_device_name(0))[0] / 1e9,
                              "card": smi}), flush=True)

        # (b) bench.py's scan_agg queries, device decode on and off; (c) Q1
        on = {}
        # the host path reads one row group a chunk, so both paths hand
        # the aggregation the same batches and their rows compare exactly
        off = {"spark.rapids.tpu.parquet.deviceDecode.enabled": "false",
               "spark.rapids.sql.reader.chunked.maxDecodeBytes": "1"}
        general = {"spark.rapids.tpu.agg.compiledStage.enabled": "false",
                   "spark.rapids.sql.test.enabled": "true"}
        t_case = time.perf_counter()
        q1_oracle = framework_oracle(q1_oracle_cols(cols))
        agg_oracle = scan_agg_oracle(cols)
        strings_oracle = scan_agg_strings_oracle(cols)
        del cols
        print(f"  oracles: {time.perf_counter() - t_case:.1f} s", flush=True)
        cases = [
            ("scan_agg", scan_agg_query, (on, off),
             lambda r, w: check_scan_agg(r, agg_oracle, w),
             ["l_discount", "l_extendedprice", "l_quantity",
              "l_returnflag"]),
            ("scan_agg_strings", scan_agg_strings_query, (on, off),
             lambda r, w: check_scan_agg_strings(r, strings_oracle, w),
             ["l_linestatus", "l_quantity", "l_returnflag", "l_shipinstruct",
              "l_shipmode"]),
            ("q1_scan", framework_query, (on, general),
             lambda r, w: check_framework_rows(r, q1_oracle),
             ["l_discount", "l_extendedprice", "l_linestatus", "l_quantity",
              "l_returnflag", "l_shipdate", "l_tax"])]
        for key, query, confs, check_rows, want_cols in cases:
            results = []
            for conf in confs:
                tag = "on" if conf is on else ("off" if conf is off
                                               else "general")
                t_case = time.perf_counter()
                s = TorchSession(conf, device=device)
                q = query(F, s.read.parquet(path))
                plan = quiet_plan(q)
                check(scan_columns(plan) == want_cols,
                      f"{key} {tag}: scan columns {scan_columns(plan)}")
                # count(l_shipinstruct) reads a string that is not a
                # group key: that query plans the general aggregate
                compiled = conf is not general and key != "scan_agg_strings"
                check(("TorchCompiledAggStage" in plan) == compiled
                      and "TorchFileScanExec" in plan,
                      f"{key} {tag}: plan\n{plan}")
                first, second = q.collect(), q.collect()
                check_rows(first, f"{key} {tag}")
                check(first == second, f"{key} {tag}: two collects differ")
                for k in FALLBACK_KEYS:
                    check(s.counters[k] == 0, f"{key} {tag}: {k} = "
                          f"{s.counters[k]}")
                if conf is not off:
                    check(s.counters["scan.rowGroups"] == 2 * n_rg,
                          f"{key} {tag}: {s.counters['scan.rowGroups']} "
                          "row groups decoded")
                results.append(sorted(first, key=str))
                print(f"({'c' if key == 'q1_scan' else 'b'}) {key} decode "
                      f"{tag} at {rows} rows ok ({len(first)} rows equal the "
                      "oracle; two collects identical; no fallback)",
                      flush=True)
                if on_card:
                    scan_timed_line(f"{key}_{tag}", q, s, rows, file_bytes,
                                    smi)
                print(f"  {key} {tag}: {time.perf_counter() - t_case:.1f} s",
                      flush=True)
                del q, s
            if confs[1] is off:
                check(results[0] == results[1],
                      f"{key}: device decode on and off differ")
            if on_card:
                torch.cuda.empty_cache()

        # (d) every encoding class, and a partitioned directory
        t_case = time.perf_counter()
        encoding_classes(TorchSession, d, enc_rows, device)
        print(f"  (d): {time.perf_counter() - t_case:.1f} s", flush=True)
    print(f"phase 9: {time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 10: the other 16 TPC-H queries
# ---------------------------------------------------------------------------

#: the TPC-H queries phase 10 runs (the ones phases 4-9 do not)
REST_QUERIES = ("q2", "q5", "q7", "q8", "q9", "q10", "q11", "q12", "q14",
                "q15", "q16", "q17", "q19", "q20", "q21", "q22")
#: intermediates held beside the queries whose answer can be null or zero
REST_PARTS = ("q8_parts", "q17_thresholds", "q17_passing", "q19_brands")


def _lookup(keys: np.ndarray, probe: np.ndarray):
    """numpy many-to-one join: each probe value's row in ``keys`` (unique
    values) and whether it has one."""
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    i = np.minimum(np.searchsorted(sk, probe), max(len(sk) - 1, 0))
    return order[i], sk[i] == probe


def _groups(*keys):
    """numpy group-by: (the distinct key rows in order, each row's group)."""
    k = np.stack([np.asarray(x, np.int64) for x in keys], 1)
    uniq, inv = np.unique(k, axis=0, return_inverse=True)
    return uniq, inv.ravel()


def _days(col) -> np.ndarray:
    return col.astype("datetime64[D]").astype(np.int64)


def _year(days: np.ndarray) -> np.ndarray:
    """``(days.cast("int") / 365).cast("int")``: double division, truncated
    toward zero."""
    return np.trunc(days / 365.0).astype(np.int64)


def _word_mask(col, words, pred) -> np.ndarray:
    """Rows of a host string column (built from ``words``) whose word
    satisfies ``pred``."""
    code = word_codes(col, words)
    ok = np.array([pred(w) for w in words] + [False])
    return ok[code]


def _names(col, codes) -> list:
    return host_strings(col, [int(c) for c in codes])


def rest_oracles(T) -> dict:
    """numpy float64 answers of phase 10's queries and intermediates over
    the host tables ``T`` (name → columns), each as the list of rows the
    query returns, in its order."""
    from spark_rapids_tpu_torch import datagen as D
    from spark_rapids_tpu_torch.tpch import Q22_CODES
    li, o, c, s, p, ps, n, r = (T[k] for k in (
        "lineitem", "orders", "customer", "supplier", "part", "partsupp",
        "nation", "region"))
    out = {}
    n_name = host_strings(n["n_name"])
    s_name = host_strings(s["s_name"])
    rev = li["l_extendedprice"] * (1 - li["l_discount"])
    ship, commit, receipt = (_days(li[k]) for k in (
        "l_shipdate", "l_commitdate", "l_receiptdate"))
    odate = _days(o["o_orderdate"])
    oi, ohit = _lookup(o["o_orderkey"], li["l_orderkey"])
    si, shit = _lookup(s["s_suppkey"], li["l_suppkey"])
    pi, phit = _lookup(p["p_partkey"], li["l_partkey"])
    oci, ochit = _lookup(c["c_custkey"], o["o_custkey"])
    sni, snhit = _lookup(n["n_nationkey"], s["s_nationkey"])
    cni, cnhit = _lookup(n["n_nationkey"], c["c_nationkey"])

    def region_nations(name):
        key = r["r_regionkey"][strings_equal(r["r_name"], name)]
        return np.isin(n["n_regionkey"], key)

    def nation_key(name):
        return n["n_nationkey"][strings_equal(n["n_name"], name)]

    types = D._TYPES

    # q2: the minimum-cost European supplier of size-15 brass parts
    eu_supp = snhit & region_nations("EUROPE")[sni]
    psi, pshit = _lookup(s["s_suppkey"], ps["ps_suppkey"])
    eps = pshit & eu_supp[psi]
    mc_keys, mc_inv = np.unique(ps["ps_partkey"][eps], return_inverse=True)
    mc = np.full(len(mc_keys), np.inf)
    np.minimum.at(mc, mc_inv, ps["ps_supplycost"][eps])
    brass = (p["p_size"] == 15) & _word_mask(p["p_type"], types,
                                             lambda w: w.endswith("BRASS"))
    ppi, pphit = _lookup(p["p_partkey"], ps["ps_partkey"])
    big = eps & pphit & brass[ppi]
    big &= ps["ps_supplycost"] == mc[np.minimum(np.searchsorted(
        mc_keys, ps["ps_partkey"]), max(len(mc_keys) - 1, 0))]
    mfgr = word_codes(p["p_mfgr"], [f"Manufacturer#{i}" for i in
                                    range(1, 6)])
    rows = [{"s_acctbal": float(s["s_acctbal"][psi[k]]),
             "s_name": s_name[psi[k]], "n_name": n_name[sni[psi[k]]],
             "p_partkey": int(ps["ps_partkey"][k]),
             "p_mfgr": f"Manufacturer#{mfgr[ppi[k]] + 1}"}
            for k in np.flatnonzero(big)]
    out["q2"] = sorted(rows, key=lambda x: (-x["s_acctbal"], x["n_name"],
                                            x["s_name"],
                                            x["p_partkey"]))[:100]

    # q5: revenue by Asian nation where customer and supplier share it
    cust_nat = c["c_nationkey"][oci[oi]]
    keep = (ohit & ochit[oi] & shit & (cust_nat == s["s_nationkey"][si])
            & snhit[si] & region_nations("ASIA")[sni[si]]
            & (odate[oi] >= 8766) & (odate[oi] < 9131))
    g = sni[si][keep]
    sums = np.bincount(g, weights=rev[keep], minlength=len(n_name))
    out["q5"] = sorted(({"n_name": n_name[k], "revenue": float(sums[k])}
                        for k in np.unique(g)), key=lambda x: -x["revenue"])

    # q7: shipping between FRANCE and GERMANY by year
    sn = sni[si]
    cn = cni[oci[oi]]
    fr, ge = (int(np.flatnonzero(strings_equal(n["n_name"], w))[0])
              for w in ("FRANCE", "GERMANY"))
    keep = ((ship >= 9131) & (ship <= 9861) & shit & ohit & ochit[oi]
            & snhit[si] & cnhit[oci[oi]]
            & (((sn == fr) & (cn == ge)) | ((sn == ge) & (cn == fr))))
    uniq, inv = _groups(sn[keep], cn[keep], _year(ship[keep]))
    sums = np.bincount(inv, weights=rev[keep], minlength=len(uniq))
    out["q7"] = sorted(({"supp_nation": n_name[a], "cust_nation": n_name[b],
                         "l_year": int(y), "revenue": float(v)}
                        for (a, b, y), v in zip(uniq, sums)),
                       key=lambda x: (x["supp_nation"], x["cust_nation"],
                                      x["l_year"]))

    # q8: BRAZIL's share of AMERICA's steel imports by order year
    steel = strings_equal(p["p_type"], "ECONOMY ANODIZED STEEL")
    brazil = int(np.flatnonzero(strings_equal(n["n_name"], "BRAZIL"))[0])
    keep = (phit & steel[pi] & shit & ohit & ochit[oi] & cnhit[oci[oi]]
            & region_nations("AMERICA")[cn] & snhit[si]
            & (odate[oi] >= 9131) & (odate[oi] <= 9861))
    years, inv = np.unique(_year(odate[oi][keep]), return_inverse=True)
    vol = np.bincount(inv, weights=rev[keep], minlength=len(years))
    bra = np.bincount(inv, weights=np.where(sn[keep] == brazil, rev[keep],
                                            0.0), minlength=len(years))
    out["q8"] = [{"o_year": int(y), "mkt_share": float(b / v)}
                 for y, b, v in zip(years, bra, vol)]
    out["q8_parts"] = [{"o_year": int(y), "brazil_volume": float(b),
                        "volume": float(v)}
                       for y, b, v in zip(years, bra, vol)]

    # q9: profit on green parts by nation and year
    green = _word_mask(p["p_name"], [f"{a} {b}" for a in D._COLORS
                                     for b in ("metal", "steel", "satin")],
                       lambda w: "green" in w)
    width = int(max(ps["ps_suppkey"].max(), li["l_suppkey"].max())) + 1
    ps_key = ps["ps_partkey"].astype(np.int64) * width + ps["ps_suppkey"]
    check(len(np.unique(ps_key)) == len(ps_key),
          "partsupp (part, supplier) pairs repeat")
    qi, qhit = _lookup(ps_key, li["l_partkey"].astype(np.int64) * width
                       + li["l_suppkey"])
    keep = phit & green[pi] & shit & qhit & ohit & snhit[si]
    amount = rev - ps["ps_supplycost"][qi] * li["l_quantity"]
    uniq, inv = _groups(sn[keep], _year(odate[oi][keep]))
    sums = np.bincount(inv, weights=amount[keep], minlength=len(uniq))
    out["q9"] = sorted(({"n_name": n_name[a], "o_year": int(y),
                         "sum_profit": float(v)}
                        for (a, y), v in zip(uniq, sums)),
                       key=lambda x: (x["n_name"], -x["o_year"]))

    # q10: revenue lost to returns, top 20 customers
    returned = strings_equal(li["l_returnflag"], "R")
    ci = oci[oi]
    keep = (returned & ohit & ochit[oi] & cnhit[ci] & (odate[oi] >= 8674)
            & (odate[oi] < 8766))
    custs, inv = np.unique(ci[keep], return_inverse=True)
    sums = np.bincount(inv, weights=rev[keep], minlength=len(custs))
    top = np.argsort(-sums, kind="stable")[:20]
    names = _names(c["c_name"], custs[top])
    phones = _names(c["c_phone"], custs[top])
    out["q10"] = [{"c_custkey": int(c["c_custkey"][k]), "c_name": nm,
                   "c_acctbal": float(c["c_acctbal"][k]), "c_phone": ph,
                   "n_name": n_name[cni[k]], "revenue": float(v)}
                  for k, nm, ph, v in zip(custs[top], names, phones,
                                          sums[top])]

    # q11: German stock worth more than 0.0001 of the national total
    keep = pshit & snhit[psi] & np.isin(s["s_nationkey"][psi],
                                        nation_key("GERMANY"))
    value = ps["ps_supplycost"] * ps["ps_availqty"]
    parts, inv = np.unique(ps["ps_partkey"][keep], return_inverse=True)
    pv = np.bincount(inv, weights=value[keep], minlength=len(parts))
    over = np.flatnonzero(pv > value[keep].sum() * 0.0001)
    out["q11"] = sorted(({"ps_partkey": int(parts[k]),
                          "part_value": float(pv[k])} for k in over),
                        key=lambda x: (-x["part_value"], x["ps_partkey"]))

    # q12: late MAIL/SHIP lines by priority
    modes = word_codes(li["l_shipmode"], ["MAIL", "SHIP"])
    keep = ((modes >= 0) & (commit < receipt) & (ship < commit)
            & (receipt >= 8766) & (receipt < 9131) & ohit)
    high = word_codes(o["o_orderpriority"], ["1-URGENT", "2-HIGH"]) >= 0
    h = high[oi]
    out["q12"] = [{"l_shipmode": m,
                   "high_line_count": int((keep & h & (modes == i)).sum()),
                   "low_line_count": int((keep & ~h & (modes == i)).sum())}
                  for i, m in enumerate(["MAIL", "SHIP"])
                  if (keep & (modes == i)).any()]

    # q14: the promotion revenue share of one month
    promo = _word_mask(p["p_type"], types, lambda w: w.startswith("PROMO"))
    keep = (ship >= 9374) & (ship < 9404) & phit
    out["q14"] = [{"promo_revenue": float(
        100.0 * rev[keep & promo[pi]].sum() / rev[keep].sum())}]

    # q15: the top supplier by rounded revenue of one quarter
    keep = (ship >= 9496) & (ship < 9587)
    supps, inv = np.unique(li["l_suppkey"][keep], return_inverse=True)
    tot = np.bincount(inv, weights=rev[keep], minlength=len(supps))
    tot = np.trunc(tot * 100.0 + np.where(tot >= 0, 0.5, -0.5)) / 100.0
    top = np.flatnonzero(tot == tot.max())
    ti, thit = _lookup(s["s_suppkey"], supps[top])
    out["q15"] = sorted(({"s_suppkey": int(supps[k]), "s_name": s_name[i],
                          "total_revenue": float(tot[k])}
                         for k, i, ok in zip(top, ti, thit) if ok),
                        key=lambda x: x["s_suppkey"])

    # q16: suppliers per brand/type/size, complaining suppliers excluded
    comments = D._SUPPLIER_COMMENTS
    bad = _word_mask(s["s_comment"], comments,
                     lambda w: re.fullmatch(".*Customer.*Complaints.*", w)
                     is not None)
    brands = word_codes(p["p_brand"], D._BRANDS)
    tcode = word_codes(p["p_type"], types)
    sel = ((brands != D._BRANDS.index("Brand#45"))
           & ~_word_mask(p["p_type"], types,
                         lambda w: w.startswith("MEDIUM POLISHED"))
           & np.isin(p["p_size"], [49, 14, 23, 45, 19, 3, 36, 9]))
    keep = pphit & sel[ppi] & ~(pshit & bad[psi])
    uniq = np.unique(np.stack([brands[ppi][keep], tcode[ppi][keep],
                               p["p_size"][ppi][keep].astype(np.int64),
                               ps["ps_suppkey"][keep]], 1), axis=0)
    grp, cnt = np.unique(uniq[:, :3], axis=0, return_counts=True)
    out["q16"] = sorted(({"p_brand": D._BRANDS[b], "p_type": types[t],
                          "p_size": int(z), "supplier_cnt": int(k)}
                         for (b, t, z), k in zip(grp, cnt)),
                        key=lambda x: (-x["supplier_cnt"], x["p_brand"],
                                       x["p_type"], x["p_size"]))

    # q17: lines under 0.2 * their part's average quantity
    sel = (strings_equal(p["p_brand"], "Brand#23")
           & strings_equal(p["p_container"], "MED BOX"))
    j = phit & sel[pi]
    parts, inv = np.unique(li["l_partkey"][j], return_inverse=True)
    avg = np.bincount(inv, weights=li["l_quantity"][j].astype(np.float64),
                      minlength=len(parts)) / np.bincount(
                          inv, minlength=len(parts))
    thresh = avg * 0.2
    out["q17_thresholds"] = [{"th_partkey": int(k), "qty_thresh": float(v)}
                             for k, v in zip(parts, thresh)]
    passing = li["l_quantity"][j] < thresh[inv]
    rows = [{"p_partkey": int(k), "l_quantity": int(q),
             "l_extendedprice": float(e), "qty_thresh": float(v)}
            for k, q, e, v in zip(li["l_partkey"][j][passing],
                                  li["l_quantity"][j][passing],
                                  li["l_extendedprice"][j][passing],
                                  thresh[inv][passing])]
    out["q17_passing"] = sorted(rows, key=lambda x: (
        x["p_partkey"], x["l_quantity"], x["l_extendedprice"]))
    out["q17"] = [{"avg_yearly": float(sum(x["l_extendedprice"] for x in
                                           out["q17_passing"]) / 7.0)
                   if rows else None}]

    # q19: three bracketed part/quantity conditions
    common = ((word_codes(li["l_shipmode"], ["AIR", "REG AIR"]) >= 0)
              & strings_equal(li["l_shipinstruct"], "DELIVER IN PERSON")
              & phit)
    qty, size = li["l_quantity"], p["p_size"][pi]
    cont = word_codes(p["p_container"], D._CONTAINERS)[pi]

    def bracket(brand, prefix, lo, hi, top):
        return ((brands[pi] == D._BRANDS.index(brand))
                & np.isin(cont, [i for i, w in enumerate(D._CONTAINERS)
                                 if w.startswith(prefix)])
                & (qty >= lo) & (qty <= hi) & (size >= 1) & (size <= top))
    hit = common & (bracket("Brand#12", "SM", 1, 11, 5)
                    | bracket("Brand#23", "MED", 10, 20, 10)
                    | bracket("Brand#34", "LG", 20, 30, 15))
    out["q19"] = [{"revenue": float(rev[hit].sum()) if hit.any()
                   else None}]
    bcode = brands[pi][common]
    out["q19_brands"] = [
        {"p_brand": D._BRANDS[b], "lines": int((bcode == b).sum()),
         "revenue": float(rev[common][bcode == b].sum())}
        for b in sorted(np.unique(bcode), key=lambda b: D._BRANDS[b])]

    # q20: EGYPT's suppliers with surplus forest-part stock
    forest = _word_mask(p["p_name"], [f"{a} {b}" for a in D._COLORS
                                      for b in ("metal", "steel", "satin")],
                        lambda w: w.startswith("forest"))
    fps = pphit & forest[ppi]
    keep = (ship >= 8766) & (ship < 9131)
    uniq, inv = _groups(li["l_partkey"][keep], li["l_suppkey"][keep])
    half = np.bincount(inv, weights=li["l_quantity"][keep].astype(
        np.float64), minlength=len(uniq)) * 0.5
    hi_, hhit = _lookup(uniq[:, 0] * width + uniq[:, 1], ps_key)
    qual = fps & hhit & (ps["ps_availqty"] > np.where(hhit, half[hi_], 0))
    egypt = np.isin(s["s_nationkey"], nation_key("EGYPT"))
    ok = np.isin(s["s_suppkey"], ps["ps_suppkey"][qual]) & egypt
    out["q20"] = [{"s_name": w} for w in
                  sorted(s_name[k] for k in np.flatnonzero(ok))]

    # q21: Saudi suppliers who alone kept a multi-supplier order waiting
    late = receipt > commit
    lok = li["l_orderkey"].astype(np.int64)
    pairs = np.unique(np.stack([lok, li["l_suppkey"]], 1), axis=0)
    nsupp = np.bincount(pairs[:, 0], minlength=len(o["o_orderkey"]))
    lpairs = np.unique(np.stack([lok[late], li["l_suppkey"][late]], 1),
                       axis=0)
    nlate = np.bincount(lpairs[:, 0], minlength=len(o["o_orderkey"]))
    f_status = strings_equal(o["o_orderstatus"], "F")
    keep = (late & ohit & f_status[oi] & shit
            & np.isin(s["s_nationkey"][si], nation_key("SAUDI ARABIA"))
            & (nsupp[lok] > 1) & (nlate[lok] == 1))
    counts: dict = {}
    for k in si[keep]:
        counts[s_name[k]] = counts.get(s_name[k], 0) + 1
    out["q21"] = sorted(({"s_name": k, "numwait": v}
                         for k, v in counts.items()),
                        key=lambda x: (-x["numwait"], x["s_name"]))[:100]

    # q22: orderless customers above the cohort's average balance
    code = np.array([ph[:2] for ph in host_strings(c["c_phone"])],
                    dtype=object)
    bal = c["c_acctbal"]
    cohort = np.isin(code, Q22_CODES)
    avg_bal = bal[cohort & (bal > 0.0)].mean()
    keep = cohort & ~np.isin(c["c_custkey"], o["o_custkey"]) \
        & (bal > avg_bal)
    out["q22"] = [{"cntrycode": k, "numcust": int((code[keep] == k).sum()),
                   "totacctbal": float(bal[keep][code[keep] == k].sum())}
                  for k in sorted(set(code[keep]))]
    return out


def check_rest(rows, want, what: str) -> None:
    """The oracle's rows in its order, the same columns; integers, strings
    and nulls exact, floats within RTOL_FRAMEWORK."""
    check(len(rows) == len(want), f"{what}: {len(rows)} rows, want "
          f"{len(want)}")
    for r, w in zip(rows, want):
        check(list(r) == list(w), f"{what}: columns {list(r)} != "
              f"{list(w)}")
        for k, v in w.items():
            g = r[k]
            if isinstance(v, float) and g is not None:
                check(abs(g - v) <= RTOL_FRAMEWORK * abs(v),
                      f"{what}: {k} {g!r} != {v!r}")
            else:
                check(g == v, f"{what}: {k} {g!r} != {v!r} in {r}")


def tpch_rest_paths(F, TorchSession, smi, tables: dict,
                    device: str = "cuda", rows: int = 1 << 22) -> None:
    """Phase 10. With ``device="cpu"`` and a small ``rows`` it checks the
    script's oracles off the card (no timing lines)."""
    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch.datagen import TPCH_TABLES, tpch_frames
    on_card = device == "cuda"
    t0 = time.perf_counter()
    host = tpch_host(tables, rows, 4, TPCH_TABLES)
    t_oracle = time.perf_counter()
    oracles = rest_oracles({k: v[0] for k, v in host.items()})
    print(f"phase 10 tables {t_oracle - t0:.1f} s, oracles "
          f"{time.perf_counter() - t_oracle:.1f} s", flush=True)
    for name in REST_QUERIES + REST_PARTS:
        check(bool(oracles[name]), f"the oracle of {name} has no rows")
    base = {"spark.rapids.shuffle.mode": "ICI",
            "spark.sql.shuffle.partitions": "8"}
    layouts = {"benchmark": (base, None),
               "cached": (dict(base, **{"spark.rapids.sql.batchSizeRows":
                                        str(rows)}), 1)}
    for layout, (conf, parts) in layouts.items():
        s = TorchSession(conf, device=device)
        t = tpch_frames(s, host, parts)
        if parts == 1:
            t["lineitem"] = t["lineitem"].device_cache()
        for name in REST_QUERIES + REST_PARTS:
            q = getattr(tpch, name)(t)
            got = q.collect()
            check_rest(got, oracles[name], f"{name} {layout} {rows}")
            weak = [k for k, v in got[0].items() if v is None or v == 0]
            print(f"(10) {name} {layout} at {rows} ok: {len(got)} rows "
                  f"equal the oracle" + (f"; null or zero in the first "
                                         f"row: {weak}" if weak else ""),
                  flush=True)
            if layout == "benchmark" and name in REST_QUERIES:
                print(f"{name}_benchmark plan:\n{physical_plan(q)}",
                      flush=True)
                if on_card:
                    timed_line(f"{name}_benchmark", q, rows, smi)
        del t, s
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
    print(f"phase 10: {time.perf_counter() - t0:.1f} s", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from spark_rapids_tpu_torch.entry import entry
    from spark_rapids_tpu_torch.kernels import build, q1_cuda
    from spark_rapids_tpu_torch.kernels.q1 import (make_example_batch,
                                                   q1_group_and_measures,
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
    # the parquet scan's host side (footer, codecs, host reads) needs it
    has_pyarrow = subprocess.run([sys.executable, "-c", "import pyarrow"],
                                 capture_output=True).returncode == 0
    print(f"import pyarrow: {'ok' if has_pyarrow else 'fails'}", flush=True)
    check(has_pyarrow, "pyarrow does not import: the parquet scan needs it")
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

    # the closest single PyTorch call to both kernels: index_add_ of the
    # masked, projected measures over the group ids (float atomics in no
    # fixed order), at 2^24 rows
    lib_batch, lib_cut = sliced_batch(N_BIG, aligned)
    lib_group, lib_meas = q1_group_and_measures(lib_batch, lib_cut)
    lib_gid = lib_group.long()

    def library_call():
        return torch.zeros((16, lib_meas.shape[1]), dtype=lib_meas.dtype,
                           device="cuda").index_add_(0, lib_gid, lib_meas)
    # it adds each group's ~10^6 rows into one f32 by atomics, so its sums
    # drift further than the kernels' partials (reported, not gated); its
    # counts are exact
    lib = library_call().double().cpu()
    plain = q1_cuda.q1_agg_simt_plain(lib_batch, lib_cut).double().cpu()
    check(torch.equal(lib[:, 5:], plain[:, 5:]), "index_add_ counts differ")
    check(bool(torch.isfinite(lib).all()), "index_add_ sums not finite")
    library_ms = time_ms(library_call, 20)
    print(json.dumps({"q1_library_index_add": {
        "rows": N_BIG, "ms": library_ms, "max_rel_err_vs_plain": float(
            ((lib - plain).abs() / plain.abs().clamp(min=1)).max())},
        "card": smi}), flush=True)
    del lib_batch, lib_group, lib_meas, lib_gid

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
            "library_ms": library_ms, "rows": N_BIG,
            "kernel_device_ms": op_ms(per_op, f"{kname}_kernel"),
            "pass_device_ms": op_ms(per_op, "q1_sum_partials_kernel"),
            **geometry[kname]})
    kernels_line = json.dumps({"kernels": lines, "card": smi})
    print(kernels_line, flush=True)

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
    tables: dict = {}
    q3_paths(F, TorchSession, smi, tables=tables)
    torch.cuda.empty_cache()

    # 8. TPC-H q4, q13 and q18; every hash-join type; LIKE
    tpch_more_paths(F, TorchSession, smi, tables)
    torch.cuda.empty_cache()

    # 9. the parquet scan: bench.py's scan_agg queries and Q1 from parquet
    scan_paths(F, TorchSession, smi)

    # 10. the other 16 TPC-H queries over phase 8's 2^22-row tables
    tpch_rest_paths(F, TorchSession, smi, tables)
    tables.clear()

    print(kernels_line, flush=True)  # again, near the end of the output
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
