"""Smoke run of the PyTorch/CUDA port on one GPU: all 22 TPC-H queries of
benchmarks/tpch.py end to end (as spark_rapids_tpu_torch/tpch.py writes
them), the parquet scan, the query lifecycle (bench.py's hot_repeat
and serving stages, spill and out-of-memory retry, deadline and cancel)
all 99 TPC-DS queries of benchmarks/tpcds.py (as
spark_rapids_tpu_torch/tpcds.py writes them), strings and regex, and
fallback to the host engine (the 22 TPC-H queries with every operator on
the CPU, and each operator switched off in turn).

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
   (the profiler's device trace), its plain version's time, and the framework's
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
   (a) and (b) each print a line: best of 2 warm collect(), Mrows/s, device
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
   (a) the port's datagen lineitem at 2^22 rows (bench.py: 2^24; halved
       for phase 16's room in the script's time, again for phase 18's)
       written in bench.py's layout (parts of 2^21 rows through one
       writer, snappy, row groups of 2^20: 4 row groups), its size
       printed; the pinned
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

11. the query lifecycle (every collect() of every phase goes through the
   scheduler: admission, the plan cache, the task semaphore, spillable
   batches and out-of-memory retry):
   (a) bench.py's hot_repeat: six literal-varying q6 submissions over
       phase 4's cached lineitem and six q3 submissions over the five
       market segments on the star-join stage (lineitem cached in one
       batch at 2^22 rows; bench.py runs 2^18), each against the numpy
       oracle of its own literals; one plan-cache miss and five hits per
       query; first, steady and warm-p50 times;
   (b) bench.py's serving stage: N in {1, 4, 16} tenant threads (own
       session and 2^20-row tables each; bench.py runs 2^12), classes
       round-robin, q1, q6 and q3 (reps 2, 1 at N=16) with
       maxConcurrentQueries=4 and shedAfterMs=500; every non-shed result
       against its oracle, no tenant error; rows/s, per-class p50/p95,
       admission-wait p95 and sheds;
   (c) the memory runtime: Q1 on the general path at 2^24 with two forced
       retry OOMs, then one forced split (the oracle's rows, the counts
       forced); q3 on the general path at 2^22 under a budget of a
       quarter of its unconstrained peak, first with host spill only, then
       with a host limit that sends some to disk (the unconstrained rows,
       spill bytes by tier and pressure events > 0, and a lower peak of
       torch.cuda.max_memory_allocated() than unconstrained); a spilled
       2^24-row batch that only the catalog holds leaves the card and
       comes back as one copy, one held elsewhere is not spilled; a real
       torch.cuda.OutOfMemoryError in with_retry over 2^24 rows healed by
       one retry and a split. After each case the budget is at 0, every
       permit free, the spill and shuffle catalogs empty, no resource
       leaked and torch.cuda.memory_allocated() back at its value before;
   (d) q21 in the benchmark layout: a 0.2 s deadline raises
       QueryDeadlineExceeded, a session.cancel() from a second thread
       stops it; the milliseconds from the deadline (the cancel) to the
       raise, and no leak;
   (e) the lifecycle's own costs: one batch through with_retry, a bare
       register/read/close, a no-op admission, q21's fingerprint and
       clone.
12. the 99 TPC-DS queries (the 22 tables, union and the set operations,
   grouping sets through Expand, the window exec, stddev) in
   benchmarks/tpcds.py's layout (load_tables(s, rows, parts=4), four
   shuffle partitions, ICI):
   (a) every query at 12,000 store_sales rows on the card against the
       same query through the port on the CPU over the same tables (a
       second process, ``chip_smoke.py --tpcds-cpu``), with the tests'
       compare (rows sorted, floats to 4 places, rel/abs 1e-4);
   (b) every query at 2^20 store_sales rows (the other tables at
       load_tables' ratios; 2^22 before phase 16, 2^21 before phase 18:
       halved for each in the script's time) in test mode (an operator
       left off the card fails): rows (q75's answer, the brands whose yearly sales count
       fell 10 %, is empty at this size: then every brand's ratio from
       q75_brand_years must be at least 0.9), two collects identical;
       q98, q47, q51, q44, q22,
       q38, q87 and q39 against numpy float64 oracles (integers, strings
       and nulls exact, floats rtol 1e-9, rows in the query's order);
   (c) a timing line a query at 2^20: one warm collect(); the
       first collect, profiled (its rows are (b)'s), for the busy, HtoD,
       idle share (busy over the best warm collect) and device ops; the
       opTime of the window, Expand and union execs and the compiled
       stages' re-runs of a warm collect. It launches neither Q1 kernel.

13. strings and regex over lineitem at 2^22 rows, customer at its TPC-H
   ratio and a text table of 2^22 rows built with numpy (0-120 bytes of
   words, digits, dashes and runs of spaces; 1 row in 64 with a non-ASCII
   word, 1 in 32 null, some empty; ~250 MB): ten queries (the string
   functions summed by ship mode over the ASCII rows, a 4,096-row sample
   with format_number, conv and casts, casts to and from strings over
   lineitem, rlike / regexp_replace / regexp_extract inside the DFA
   subset and one backreference outside it, string CASE WHEN, string
   min/max by groups, lag with a string default and a running max of a
   string over a window, and the non-ASCII rows through the host hop):
   (a) at 12,000 rows on the card against the port on the CPU, exactly
       (the CPU answers, the 2^22-row tables and their oracles made by a
       process main starts at the beginning, ``chip_smoke.py
       --strings-prep``);
   (b) at 2^22 rows in test mode (the non-ASCII query outside it) against
       pyarrow.compute and Python ``re`` oracles, exactly, two collects
       identical, each query's host hops (strings.hostPath by class and
       reason) the ones the reference's design takes and no other;
   (c) a timing line a query (as phase 12's) and the DFA walk alone by
       CUDA events with its step count. It launches neither Q1 kernel.

15. observability on the card (spark.rapids.tpu.trace.enabled, the
   operator metrics, the sync ledger, the profiler), over phase 4's
   cached lineitem, phase 7's 2^22-row tables and phase 9's file:
   (a) framework Q1 at 2^24 (cached), q3 on the general path at 2^22 (4
       partitions, 8 shuffle partitions, compiled join off) and scan_agg
       with the device decode on, each traced with trace.dir in a
       temporary directory: the bundle reconciles, the span tree is query
       → plan.build → partition p → operators with one scan.decode span a
       row group, the root's numOutputRows equals the oracle's rows, the
       rows equal an untraced collect's, the Chrome trace loads as JSON;
   (b) hot_repeat traced at phase 11's shapes (q6 at 2^24, q3 on the
       star-join stage at 2^22, six submissions each): every bundle holds
       a plan.build span, the steady submissions hit the plan cache; the
       steady planning share (summed plan.build over summed end-to-end);
   (c) the tracer's price: best of 2 warm collects untraced and traced,
       framework Q1 and q3 general, with the count of spans;
   (d) one collect each of q3 general and scan_agg under
       torch.cuda.set_sync_debug_mode("warn"): the synchronizing calls
       beside the SyncLedger's total, and the top Python lines of those
       the audited gate did not see (printed, not checked);
   (e) one collect under session.profiler(): the trace file holds CUDA
       kernel events and the operators' ranges.
16. the DataFrame and session surface in test mode, over phase 10's
   2^22-row datagen lineitem (4 partitions):
   (a) session.range(0, 2^27, 1, numPartitions=4) (1 GiB of int64 ids on
       the card) filtered, summed and counted against the closed form;
       count();
   (b) sample(0.1, seed) and sample(True, 0.5, seed): the rows of a numpy
       oracle of the same hash, and of the port's host engine;
   (c) repartition(16), repartition(16, "l_orderkey"), coalesce(2): each
       partition's rows from to_device_batches' partitions equal the host
       engine's, and the rows are the source's;
   (d) the writer over device batches: parquet partitionBy(l_returnflag,
       l_linestatus) and bucketBy(8, l_orderkey) (each bucket file's ids
       Spark's) read back through the device decode; orc and csv at 2^20
       rows, json at 2^15 (written row by row, as the reference): csv and
       json text equal pyarrow's and json.dumps' of the same rows, each
       read back; a write_<fmt> line each (wall, MB, files, writeTime,
       numWrittenRows);
   (e) cache() of a 2^22-row Q1 lineitem: framework Q1 twice against its
       oracle, its rows beside device_cache()'s; count(), show(5),
       toPandas() (where pandas imports), to_device_arrays() on the card,
       dropDuplicates(["l_orderkey"]) (First on the card: each key's first
       row) and a join on names. Neither Q1 kernel launches; nothing
       leaks.

17. the scalar functions in test mode over a 2^22-row events table (seed
   17, 4 partitions: dates 1900-2100, timestamps 1960-2040 with 1 row in
   16 near an America/Los_Angeles transition, doubles with NaN, ±0.0,
   ±inf and subnormals, longs with MinValue, strings of 0-40 bytes):
   (a) a group by year and quarter and 13 date functions against numpy's
       calendar, exactly;
   (b) under UTC and America/Los_Angeles (``conf.set``): hour, minute,
       second, date_format on the card and with a host pattern,
       from_unixtime, unix_timestamp of the formatted strings (an overlap
       takes the earlier offset), timestamp_seconds/_millis/_micros,
       against zoneinfo and the port's CPU answer, exactly;
   (c) 36 math functions against numpy within rtol 1e-12 / atol 1e-15
       (bround, round, rint, the logs' nulls exact);
   (d) pmod, %, div, negative, the shifts, bit_count, the bitwise
       operators, greatest/least, isnan, nanvl, AtLeastNNonNulls, exact;
       ANSI i + i raises one message on the card and on the host;
   (e) xxhash64 and hive_hash of (i, x, s, d, ts) against numpy oracles
       of Spark's algorithms; md5 of 2^20 strings against hashlib;
   (f) spark_partition_id, monotonically_increasing_id, rand(42) (the
       card, the host and another batch size bit-identical) and
       input_file_name over a 2^20-row parquet file (the device decode).
   A timing line a part ((a), (b), (e) profiled), the host-hop counts;
   neither Q1 kernel launches; nothing leaks. ``python3 chip_smoke.py
   --phase17`` runs phase 1 and phase 17 alone.

18. decimals in test mode:
   (a) TPC-H Q1 and Q6 as Spark types them over bench.py's lineitem at
       2^24 rows with the four measures decimal(12, 2) (the same draws
       rounded to cents, seed 42), ``device_cache()``d: every row exact
       against numpy int64 oracles of the unscaled values and Spark's
       HALF_UP avg, the collects identical when repeated, no decimal host
       hop; best warm collect, device busy, idle share and device ops a
       query, and the limb primitives alone (``decimal_limb_ops_ms``);
   (b) the table's first 2^23 rows written INT64-backed and as
       FIXED_LEN_BYTE_ARRAY, read back for Q1 and Q6, exact; the scan's
       device and host-decoded column counts;
   (c) a sweep over a 2^22-row table (seed 18): + - * neg abs, a
       two-limb product past 10^38 (null; ANSI raises), comparisons
       across scales, casts each way, sum/avg/min/max by a decimal key
       and ungrouped over four chunks (their states merged), a decimal
       join key and sort key, murmur3 of decimal64 and
       decimal128, and / % pmod on the card over the first 2^12 rows,
       each checked against Python ``decimal``;
   (d) over a 2^22-row decimal(12, 2) table (seed 19, 1 row in 10 with
       a null, rounding ties at scales -1, 0 and 1, zero divisors, and
       divisors that put a / b exactly halfway at its last place): round
       and bround at scales -1, 0, 1 and 3, floor and ceil; a / b, a % b
       and pmod(a, b); a window sum/avg/min/max over a partitioned,
       ordered frame. Numpy oracles for every row of the rounding family,
       % and pmod; each query's first 2^16 rows exactly the port's host
       engine's; no decimal host hop. A timing line each (best of 2 warm
       collects, busy, idle, device ops, host hops by class) and
       ``decimal_divmod_ms`` (the 128-bit divmod alone).
   Neither Q1 kernel launches. ``python3 chip_smoke.py --phase18`` runs
   phase 1 and phase 18 alone.

19. Queue C's faults C8-C13, in test mode on the card, exact: a union's
   wider types (int and double, int and bigint, two decimals; intersect
   and except), string <-> timestamp casts in the session zone with the
   year padded, date_format's letters (D, E, MMMM, y, hh, Q, SSS, XXX)
   and the week-based refusal, coalesce/isnull of column names, date and
   datetime literals, -0.0 group, distinct, join and window keys.
   Neither Q1 kernel launches. ``python3 chip_smoke.py --phase19`` runs
   phase 1 and phase 19 alone (``--phase18 --phase19`` both).

After each phase a phase_wall line gives its wall, its collects, their
planning ms and the batches the spill catalog registered.

The kernels line (phase 5) prints again before the card's name and power
limit, and the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import decimal
import gc
import io
import json
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_BIG = 1 << 24
#: phase 9's parquet file (bench.py's scan_agg: 2^24; halved to make room
#: for phase 16 in the script's time, and again for phase 18)
SCAN_ROWS = 1 << 22
SIZES = (100, 12345, 1 << 15, N_BIG)
RTOL_KERNEL = 1e-4  # f32 sums in another order (tests/test_q1_kernels.py)
RTOL_FRAMEWORK = 1e-9  # float64 sums in another order
#: host seconds of idle card before and after the calls of a trace that
#: profile_device takes again, so that no device event sits at the edge
#: of its window
PAD_S = 0.05
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


def profile_device(fn, iters: int, warm: bool = True, need: str = None,
                   tries: int = 3):
    """The card's activity over `iters` calls: (device-busy ms per call,
    every device op as (name, ms per call), most time first, device ops a
    call). Busy time sums the device time of every kernel and copy. With
    `warm`, one untraced call first (a caller whose `fn` just ran passes
    False).

    The device activity alone is traced, and the profiler's raw events
    are summed by name as the tracer returns them: torch.profiler's own
    summary builds a Python event tree over the host ops too, about a
    millisecond a device op, so a query of 70,000 ops spent a minute in it
    (NVIDIA H100 80GB HBM3, 700 W).

    A trace has come back with no device event at all, or without one
    kernel's records, while the calls had run and their launch counters
    had risen: both times in phase 5's traces of a few milliseconds. So a
    trace that holds no device event, or none whose name holds `need`,
    is taken again, up to `tries` traces in all, each retry's calls
    inside a window padded by PAD_S of idle card on either side (each
    retry runs `fn` `iters` times more). Only then does the check fail."""
    from torch._C._profiler import ProfilerActivity, _ExperimentalConfig
    from torch.autograd import (DeviceType, ProfilerConfig, ProfilerState,
                                _disable_profiler, _enable_profiler,
                                _prepare_profiler)
    if warm:
        fn()
    torch.cuda.synchronize()
    config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False,
                            False, _ExperimentalConfig())
    activities = {ProfilerActivity.CUDA}
    for attempt in range(1, tries + 1):
        _prepare_profiler(config, activities)
        _enable_profiler(config, activities)
        pad = PAD_S if attempt > 1 else 0.0
        try:
            time.sleep(pad)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        finally:
            result = _disable_profiler()
        by_name: dict = {}
        n = 0
        for ev in result.events():
            if ev.device_type() != DeviceType.CUDA:
                continue
            n += 1
            by_name[ev.name()] = by_name.get(ev.name(), 0.0) \
                + ev.duration_ns() / 1e6 / iters
        missing = "no device event" if n == 0 else (
            f"no {need}" if need and not any(need in k for k in by_name)
            else None)
        if missing is None:
            break
        print(f"profiler: trace {attempt} of {tries} holds {missing}",
              flush=True)
    check(n > 0, f"the profiler traced no device activity in {tries} "
          "traces")
    per_op = sorted(((k, ms) for k, ms in by_name.items() if ms > 0),
                    key=lambda kv: -kv[1])
    return sum(ms for _, ms in per_op), per_op, n / iters


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
    """Best of 2 warm collect()s (the caller's collects were the warm-up),
    then one profiled collect: one JSON line."""
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        q.collect()
        best = min(best, time.perf_counter() - t0)
    busy_ms, top, ops = profile_device(q.collect, 1, warm=False)
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


def q3_oracle(host, segment: str = Q3_SEGMENT):
    """numpy float64 q3 (c_mktsegment = ``segment``): every group (order
    key → (order date, revenue)) and the top 10 rows."""
    cust, orders = host["customer"][0], host["orders"][0]
    li = host["lineitem"][0]
    building = strings_equal(cust["c_mktsegment"], segment)
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


def timed_scan_collect(q, s):
    """One collect: (its rows, (seconds, the scan's time split, bytes
    staged))."""
    from spark_rapids_tpu_torch.io.device_decode import decode_stats
    before, bytes0 = dict(s.counters), decode_stats()["bytes_staged"]
    t0 = time.perf_counter()
    rows = q.collect()
    took = time.perf_counter() - t0
    split = {k: s.counters[k] - before.get(k, 0) for k in s.counters
             if k.startswith("scan.")}
    return rows, (took, split, decode_stats()["bytes_staged"] - bytes0)


def scan_timed_line(key: str, q, s, rows: int, file_bytes: int, smi: str,
                    profiled, timing, **extra) -> None:
    """timed_line's fields plus the scan's GB/s and the best collect's
    time split: the caller's first collect was the profiled one
    (``profiled``) and its second a timed one (``timing``); one more
    timed collect here."""
    _, again = timed_scan_collect(q, s)
    best, split, staged = min(timing, again, key=lambda x: x[0])
    busy_ms, top, ops = profiled
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
               row_group: int = 1 << 20, enc_rows: int = 1 << 20,
               keep: dict = None) -> None:
    """Phase 9: (a)-(d). With ``device="cpu"`` and small sizes it checks
    the script's own logic off the card (no timing lines). ``keep`` gets
    the file for phase 15 (``keep["scan"]``: its directory, removed at
    exit, its path, the scan_agg oracle and its row groups)."""
    import atexit
    import os
    import shutil
    import tempfile

    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch.io.device_decode import FALLBACK_KEYS
    on_card = device == "cuda"
    d = tempfile.mkdtemp(prefix="chip_smoke_scan_")
    if keep is not None:
        atexit.register(shutil.rmtree, d, True)
    try:
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
                # the first collect is the profiled one, the second a
                # timed one (the timing line's)
                runs: list = []
                profiled = None
                if on_card:
                    profiled = profile_device(
                        lambda: runs.append(q.collect()), 1, warm=False)
                else:
                    runs.append(q.collect())
                first = runs[0]
                second, timing = timed_scan_collect(q, s)
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
                                    smi, profiled, timing)
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
        if keep is not None:
            keep["scan"] = (d, path, agg_oracle, n_rg)
    finally:
        if keep is None:
            shutil.rmtree(d, ignore_errors=True)
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
    """numpy group-by: (the distinct key rows in order, each row's group).
    Keys whose ranges multiply below 2^62 group as one mixed-radix int64
    (the first key most significant, so the order is the rows' order)."""
    cols = [np.asarray(x, np.int64) for x in keys]
    if cols and len(cols[0]):
        lo = [int(c.min()) for c in cols]
        span = [int(c.max()) - m + 1 for c, m in zip(cols, lo)]
        if float(np.prod([float(x) for x in span])) < 2.0 ** 62:
            code = np.zeros(len(cols[0]), np.int64)
            for c, m, w in zip(cols, lo, span):
                code = code * w + (c - m)
            uniq, inv = np.unique(code, return_inverse=True)
            rows = np.empty((len(uniq), len(cols)), np.int64)
            for j in range(len(cols) - 1, -1, -1):
                rows[:, j] = uniq % span[j] + lo[j]
                uniq = uniq // span[j]
            return rows, inv.ravel()
    k = np.stack(cols, 1)
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
    # Spark's round: the sum's decimal text, HALF_UP at two places
    tot = np.array([float(decimal.Decimal(repr(float(v))).quantize(
        decimal.Decimal("0.01"), rounding=decimal.ROUND_HALF_UP))
        for v in tot])
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
                    device: str = "cuda", rows: int = 1 << 22,
                    keep: dict = None) -> None:
    """Phase 10. With ``device="cpu"`` and a small ``rows`` it checks the
    script's oracles off the card (no timing lines). ``keep`` receives the
    oracles (phase 14 holds the host engine to them)."""
    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch.datagen import TPCH_TABLES, tpch_frames
    on_card = device == "cuda"
    t0 = time.perf_counter()
    host = tpch_host(tables, rows, 4, TPCH_TABLES)
    t_oracle = time.perf_counter()
    oracles = rest_oracles({k: v[0] for k, v in host.items()})
    if keep is not None:
        keep["rest_oracles"] = oracles
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


# ---------------------------------------------------------------------------
# phase 11: the query lifecycle — hot_repeat, serving, the memory runtime,
# deadline and cancel
# ---------------------------------------------------------------------------

#: bench.py's sizes for the two lifecycle stages (what it ran): the card runs
#: larger, as at these sizes the device does almost no work
BENCH_HOT_REPEAT_Q3_ROWS = 1 << 18
BENCH_SERVING_ROWS = 1 << 12


def release_plans() -> None:
    """Drop the plan cache's entries (each pins its query's relations, a
    cached one's device batches too) and the allocator's free blocks."""
    from spark_rapids_tpu_torch.serving.scheduler import QueryScheduler
    QueryScheduler.get().plan_cache.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def lifecycle_counts() -> dict:
    """How many collects the scheduler planned (and their planning time,
    the plan cache's fingerprint and clone included) and how many batches
    the spill catalog registered, so far in this process."""
    from spark_rapids_tpu_torch.memory.spill import TorchBufferCatalog
    from spark_rapids_tpu_torch.obs import metrics as obs_metrics
    plan = obs_metrics.full_snapshot()["histograms"].get(
        "plan.build_ms", {}).get("", {})
    cat = TorchBufferCatalog._instance  # none before the first query
    return {"collects": plan.get("count", 0),
            "plan_ms": plan.get("sum", 0.0),
            "registrations": 0 if cat is None else cat._next_handle}


class PhaseClock:
    """Prints one ``phase_wall`` line a phase: its wall and the lifecycle
    work in it (collects, their planning time, batch registrations)."""

    def __init__(self, smi: str):
        self.smi = smi
        self.t = time.perf_counter()
        self.counts = lifecycle_counts()

    def mark(self, phase: int) -> None:
        now, counts = time.perf_counter(), lifecycle_counts()
        # null where the phase reset the catalog's count (phase 11)
        delta = {k: counts[k] - self.counts[k] for k in counts}
        print(json.dumps({"phase_wall": {
            "phase": phase, "s": now - self.t,
            **{k: v if v >= 0 else None for k, v in delta.items()}},
            "card": self.smi}), flush=True)
        self.t, self.counts = now, counts


def lifecycle_overhead(TorchSession, smi, cols6, tables) -> None:
    """(11e) The lifecycle's own cost, the parts a collect and a batch pay
    whatever the query: one batch through ``with_retry`` (registration in
    the spill catalog, the budget, the cleaner, the chaos scope) and a
    register/read/close alone, on a 2^18-row batch; a no-op query through
    the scheduler's admission; the plan cache's fingerprint and clone of
    q21's plan. With ``phase_wall``'s counts they bound the lifecycle's
    share of each phase."""
    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch.columnar.batch import TorchColumnarBatch
    from spark_rapids_tpu_torch.datagen import TPCH_TABLES, tpch_frames
    from spark_rapids_tpu_torch.memory.retry import with_retry
    from spark_rapids_tpu_torch.memory.spill import SpillableColumnarBatch
    from spark_rapids_tpu_torch.serving.plan_cache import fingerprint
    from spark_rapids_tpu_torch.serving.query_context import QueryContext
    from spark_rapids_tpu_torch.serving.scheduler import QueryScheduler
    before = runtime_state(True)
    n = 1 << 18
    batch = TorchColumnarBatch.from_numpy_columns(
        {k: cols6[k][:n] for k in ("l_quantity", "l_extendedprice",
                                   "l_discount", "l_tax")}).to_device(
        torch.device("cuda"))

    def per_call_us(fn, reps):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e6

    def retry_once():
        for _ in with_retry(batch, lambda b: b):
            pass

    def register_once():
        sb = SpillableColumnarBatch(batch)
        sb.get_batch()
        sb.close()

    sched = QueryScheduler.get()
    admit_us = per_call_us(lambda: sched.submit_and_run(
        QueryContext("noop", session_id="sess-overhead"), lambda: None), 200)
    # the retry path registers a batch a caller still holds: the spill
    # would skip it, which this timing does not reach
    retry_us = per_call_us(retry_once, 500)
    register_us = per_call_us(register_once, 500)
    del batch
    host = tpch_host(tables, 1 << 16, 4, TPCH_TABLES)
    s = TorchSession({"spark.rapids.shuffle.mode": "ICI",
                      "spark.sql.shuffle.partitions": "8"}, device="cuda")
    q = tpch.q21(tpch_frames(s, host))
    conf = s._rapids_conf()
    fp_ms = per_call_us(lambda: fingerprint(q._plan, conf), 50) / 1e3
    q.collect()  # caches the plan: the next collects clone it
    entry = next(iter(sched.plan_cache._entries.values()))
    clone_ms = per_call_us(entry.template.clone_for_execution, 50) / 1e3
    del q, s, entry
    QueryScheduler.get().plan_cache.clear()
    print(json.dumps({"lifecycle_overhead": {
        "with_retry_per_batch_us": retry_us,
        "register_get_close_us": register_us,
        "admission_noop_query_us": admit_us,
        "fingerprint_q21_ms": fp_ms, "clone_q21_ms": clone_ms},
        "card": smi}), flush=True)
    check_no_leak(before, True, "lifecycle overhead")


def runtime_state(on_card: bool) -> dict:
    """The memory runtime's counters that every unwind path must return to
    baseline, and the allocator's live bytes."""
    from spark_rapids_tpu_torch.memory.cleaner import MemoryCleaner
    from spark_rapids_tpu_torch.memory.hbm import HbmBudget
    from spark_rapids_tpu_torch.memory.semaphore import TorchSemaphore
    from spark_rapids_tpu_torch.memory.spill import TorchBufferCatalog
    from spark_rapids_tpu_torch.shuffle.exchange import ShuffleCatalog
    gc.collect()  # garbage in reference cycles is not live, only late
    if on_card:
        torch.cuda.synchronize()
    sem = TorchSemaphore._instance
    shuffle = ShuffleCatalog._instance
    return {"budget_used": HbmBudget.get().used,
            "permits_free": None if sem is None else sem.available(),
            "permits": None if sem is None else sem.permits,
            "catalog_entries": TorchBufferCatalog.get().num_entries(),
            "shuffle_blocks": 0 if shuffle is None else shuffle.num_blocks(),
            "leaks": len(MemoryCleaner.get().check_leaks()),
            "allocated": torch.cuda.memory_allocated() if on_card else 0}


def check_no_leak(before: dict, on_card: bool, what: str) -> dict:
    """After a case: budget 0, every permit free, the spill and shuffle
    catalogs empty, no live resource, and the allocator back at its live
    bytes before the case (the dimension cache cleared: the phase keeps
    only the cached relations, which were live before)."""
    from spark_rapids_tpu_torch.execs.compiled_join import clear_dim_cache
    clear_dim_cache()
    after = runtime_state(on_card)
    check(after["budget_used"] == 0, f"{what}: budget used {after}")
    check(after["permits_free"] == after["permits"],
          f"{what}: permits held {after}")
    check(after["catalog_entries"] == 0, f"{what}: catalog entries {after}")
    check(after["shuffle_blocks"] == 0, f"{what}: shuffle blocks {after}")
    check(after["leaks"] == before["leaks"], f"{what}: leaked {after}")
    delta = after["allocated"] - before["allocated"]
    check(delta <= 0, f"{what}: {delta} more device bytes live after")
    print(f"(11) {what}: no leak (allocated {before['allocated']} -> "
          f"{after['allocated']} bytes)", flush=True)
    return after


def q6_variant_oracle(cols, i: int) -> float:
    from spark_rapids_tpu_torch.serving.bench import q6_literals
    lo, qty = q6_literals(i)
    ship, disc = cols["l_shipdate"], cols["l_discount"]
    keep = ((ship >= lo) & (ship < 9131) & (disc >= 0.05) & (disc <= 0.07)
            & (cols["l_quantity"] < qty))
    return float(np.sum(cols["l_extendedprice"][keep] * disc[keep]))


def datagen_q1_cols(li) -> dict:
    """The datagen lineitem in the shape framework_oracle and q6_oracle
    read (bytes flags, integer days)."""
    return {"l_returnflag": np.array(host_strings(li["l_returnflag"]),
                                     dtype="S1"),
            "l_linestatus": np.array(host_strings(li["l_linestatus"]),
                                     dtype="S1"),
            "l_shipdate": _days(li["l_shipdate"]),
            **{k: li[k] for k in ("l_quantity", "l_extendedprice",
                                  "l_discount", "l_tax")}}


def hot_repeat_paths(F, TorchSession, smi, tables, df6, cols6, device,
                     mid: int) -> None:
    """(11a) bench.py's hot_repeat: six literal-varying submissions each of
    q6 (over phase 4's cached lineitem) and q3 (star-join stage, lineitem
    cached in one batch), each submission against its own oracle."""
    from spark_rapids_tpu_torch.datagen import tpch_frames
    from spark_rapids_tpu_torch.serving.bench import (SEGMENTS, q3_variant,
                                                      q6_variant,
                                                      run_repeated)
    from spark_rapids_tpu_torch.serving.scheduler import QueryScheduler
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    QueryScheduler.get().plan_cache.clear()  # cold first submissions
    before = runtime_state(on_card)
    r6 = run_repeated(df6.session, lambda i: q6_variant(df6, i, F), 6, sync)
    for i, rows in enumerate(r6["rows"]):
        check_close(rows[0]["revenue"], q6_variant_oracle(cols6, i),
                    f"hot_repeat q6 submission {i}")
    check((r6["hits"], r6["misses"]) == (5, 1),
          f"hot_repeat q6: {r6['hits']} hits {r6['misses']} misses")
    host = tpch_host(tables, mid, 4, Q3_TABLES)
    s3 = TorchSession({"spark.rapids.shuffle.mode": "ICI",
                       "spark.sql.shuffle.partitions": "8",
                       "spark.rapids.sql.batchSizeRows": str(mid)},
                      device=device)
    t = tpch_frames(s3, host, 1)
    t["lineitem"] = t["lineitem"].device_cache()
    plan = physical_plan(q3_variant(t, 0, F))
    check("TorchCompiledJoinAggStage" in plan,
          f"hot_repeat q3 is not on the star-join stage:\n{plan}")
    r3 = run_repeated(s3, lambda i: q3_variant(t, i, F), 6, sync)
    for i, rows in enumerate(r3["rows"]):
        check_q3_rows(rows, q3_oracle(host, SEGMENTS[i % 5])[1],
                      f"hot_repeat q3 submission {i} ({SEGMENTS[i % 5]})")
    check((r3["hits"], r3["misses"]) == (5, 1),
          f"hot_repeat q3: {r3['hits']} hits {r3['misses']} misses")
    check(s3.counters["fallbackReruns"] == 0, "hot_repeat q3 re-ran")
    rows6 = len(cols6["l_shipdate"])
    for key, r, rows in (("q6", r6, rows6), ("q3_compiled", r3, mid)):
        print(json.dumps({f"hot_repeat_{key}": {
            "rows": rows, **{k: r[k] for k in (
                "iters", "first_ms", "steady_ms", "warm_p50_ms", "hits",
                "misses", "cache_by_iter")},
            "bench_py_rows": (N_BIG if key == "q6"
                              else BENCH_HOT_REPEAT_Q3_ROWS)},
            "card": smi}), flush=True)
    del t, s3
    QueryScheduler.get().plan_cache.clear()
    check_no_leak(before, on_card, "hot_repeat")


def serving_paths(TorchSession, smi, tables, device, rows: int,
                  tenants=(1, 4, 16)) -> None:
    """(11b) bench.py's serving stage: N tenant threads (own session and
    tables each, classes round-robin), q1, q6 and q3 through the
    scheduler's admission; every non-shed result against its oracle."""
    from spark_rapids_tpu_torch.serving.bench import serving_run
    from spark_rapids_tpu_torch.serving.scheduler import QueryScheduler
    on_card = device == "cuda"
    host = tpch_host(tables, rows, 2, Q3_TABLES)
    q1c = datagen_q1_cols(host["lineitem"][0])
    oracle = {"q1": framework_oracle(q1c), "q6": q6_oracle(q1c),
              "q3": q3_oracle(host)[1]}
    before = runtime_state(on_card)
    for n in tenants:
        r = serving_run(n, host, reps=1 if n >= 16 else 2, device=device,
                        sync=torch.cuda.synchronize if on_card
                        else (lambda: None))
        check(not r["errors"], f"serving n={n}: {r['errors']}")
        for i, qname, got in r["results"]:
            what = f"serving n={n} tenant {i} {qname}"
            if qname == "q1":
                check_framework_rows(got, oracle["q1"])
            elif qname == "q6":
                check_close(got[0]["revenue"], oracle["q6"], what)
            else:
                check_q3_rows(got, oracle["q3"], what)
        check(r["queries_done"] + r["shed_total"]
              == n * 3 * r["reps"], f"serving n={n}: queries missing")
        summary = {k: v for k, v in r.items() if k != "results"}
        print(json.dumps({f"serving_n{n}": dict(
            summary, bench_py_rows=BENCH_SERVING_ROWS)}, default=str),
            flush=True)
        print(f"(11) serving n={n} ok: {r['queries_done']} results equal "
              f"their oracles, {r['shed_total']} shed | card: {smi}",
              flush=True)
    QueryScheduler.reset_for_tests()  # the tenants retuned its knobs
    check_no_leak(before, on_card, "serving")


def forced_oom_paths(F, TorchSession, smi, df6, oracle, device) -> None:
    """(11c-i) Q1 on the general path over phase 4's cached lineitem with
    two forced retry OOMs, then one forced split: the oracle's rows, and
    the counts forced."""
    from spark_rapids_tpu_torch.memory.hbm import HbmBudget
    from spark_rapids_tpu_torch.session import DataFrame
    on_card = device == "cuda"
    rows6 = df6._plan.num_rows
    s = TorchSession({"spark.rapids.tpu.agg.compiledStage.enabled": "false",
                      "spark.rapids.sql.batchSizeRows": str(rows6)},
                     device=device)
    q = framework_query(F, DataFrame(df6._plan, s))
    check("TorchHashAggregate" in physical_plan(q), "Q1 not general")
    before = runtime_state(on_card)
    for force, n, key in (("force_retry_oom", 2, "retryCount"),
                          ("force_split_and_retry_oom", 1,
                           "splitAndRetryCount")):
        getattr(HbmBudget.get(), force)(n)
        t0 = time.perf_counter()
        rows = q.collect()
        wall = time.perf_counter() - t0
        check_framework_rows(rows, oracle)
        m = s.last_task_metrics()
        other = "splitAndRetryCount" if key == "retryCount" \
            else "retryCount"
        check(m[key] == n and m[other] == 0,
              f"{force}({n}): task metrics {m}")
        print(json.dumps({f"forced_oom_{key}": {
            "rows": rows6, "forced": n, "retryCount": m["retryCount"],
            "splitAndRetryCount": m["splitAndRetryCount"],
            "collect_s": wall}, "card": smi}), flush=True)
    check_no_leak(before, on_card, "forced OOMs")


def real_budget_paths(F, TorchSession, smi, tables, device, rows: int,
                      batch_rows: int) -> None:
    """(11c-ii) q3 on the general path (shuffled joins) under a budget of
    about a quarter of its unconstrained peak, with a host spill limit
    small enough that some spill reaches disk: the unconstrained rows."""
    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch.config import RapidsConf
    from spark_rapids_tpu_torch.datagen import tpch_frames
    from spark_rapids_tpu_torch.memory.device import TorchDeviceManager
    from spark_rapids_tpu_torch.memory.hbm import HbmBudget
    from spark_rapids_tpu_torch.memory.spill import TorchBufferCatalog
    from spark_rapids_tpu_torch.obs import metrics as obs_metrics
    from spark_rapids_tpu_torch.shuffle.serializer import _xxh_native
    on_card = device == "cuda"
    conf = {"spark.rapids.shuffle.mode": "ICI",
            "spark.sql.shuffle.partitions": "8",
            "spark.rapids.tpu.join.compiledStage.enabled": "false",
            "spark.sql.autoBroadcastJoinThreshold": "-1",
            "spark.rapids.sql.batchSizeRows": str(batch_rows)}
    total = TorchDeviceManager._total_bytes
    # the CPU has no device memory to read: each re-initialization states
    # the one the process started with
    fixed = {} if on_card else {"spark.rapids.memory.device.totalBytes":
                                str(total)}
    conf.update(fixed)
    host = tpch_host(tables, rows, 4, Q3_TABLES)
    groups, top = q3_oracle(host)

    def run(extra, host_limit=None):
        """A fresh budget (allocFraction from `extra`) and catalog, then
        q3's every group and top 10."""
        TorchDeviceManager.reset_for_tests()
        s = TorchSession(dict(conf, **extra), device=device)
        b = HbmBudget.reset_for_tests()
        cat = TorchBufferCatalog.reset_for_tests(RapidsConf(dict(
            conf, **({"spark.rapids.memory.host.spillStorageSize":
                      str(host_limit)} if host_limit else {}))))
        t = tpch_frames(s, host)
        before = runtime_state(on_card)
        p0 = obs_metrics.full_snapshot()["counters"].get(
            "hbm.pressure_events", {}).get("", 0)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        all_rows = tpch.q3_groups(t).collect()
        got_top = tpch.q3(t).collect()
        wall = time.perf_counter() - t0
        # the query's own peak on the card, above what was live before it
        peak_card = (torch.cuda.max_memory_allocated()
                     - before["allocated"]) if on_card else 0
        check_q3_groups(all_rows, groups, "q3 general under budget")
        check_q3_rows(got_top, top, "q3 general under budget")
        pressure = obs_metrics.full_snapshot()["counters"].get(
            "hbm.pressure_events", {}).get("", 0) - p0
        out = {"budget": b.budget, "peak_used": b.peak_used,
               "spilled_to_host": cat.spilled_to_host,
               "spilled_to_disk": cat.spilled_to_disk,
               "host_peak_used": cat.host_peak_used,
               "pressure_events": pressure, "collect_s": wall,
               "card_peak_bytes": peak_card,
               "task_metrics": s.last_task_metrics()}
        del t, s
        check_no_leak(before, on_card, f"q3 under budget {b.budget}")
        return out

    free = run({})
    peak = free["peak_used"]
    frac = {"spark.rapids.memory.tpu.allocFraction": repr(peak / 4 / total)}
    host_only = run(frac, host_limit=1 << 40)
    check(host_only["spilled_to_host"] > 0 and
          host_only["pressure_events"] > 0, f"no pressure: {host_only}")
    # the host tier's peak less an eighth: some of it must go to disk
    limit = host_only["host_peak_used"] * 7 // 8
    disk = run(frac, host_limit=limit)
    check(disk["spilled_to_disk"] > 0 and disk["spilled_to_host"] > 0 and
          disk["pressure_events"] > 0, f"no disk spill: {disk}")
    # what spilled left the card: the constrained runs peak lower there
    for what, r in (("host only", host_only), ("with disk", disk)):
        check(not on_card or r["card_peak_bytes"] < free["card_peak_bytes"],
              f"q3 under budget ({what}) peaked at {r['card_peak_bytes']} "
              f"card bytes, unconstrained {free['card_peak_bytes']}")
    print(json.dumps({"q3_real_budget": {
        "rows": rows, "batch_rows": batch_rows, "unconstrained": free,
        "quarter_budget_host_only": host_only,
        "quarter_budget_with_disk": dict(disk, host_limit=limit),
        "xxhash_native": _xxh_native is not None}, "card": smi}),
        flush=True)
    # back to the default budget for what follows
    TorchDeviceManager.reset_for_tests()
    TorchSession(fixed, device=device)
    HbmBudget.reset_for_tests()
    TorchBufferCatalog.reset_for_tests()


def spill_frees_paths(smi, cols6) -> None:
    """(11c-ii') A spill frees what it spills: a 2^24-row batch that only
    the catalog holds leaves the card when it spills (memory_allocated
    falls by its bytes) and comes back as one copy; one that an outside
    holder keeps alive is not spilled (nothing would be freed) and reads
    back as the same memory."""
    from spark_rapids_tpu_torch.columnar.batch import TorchColumnarBatch
    from spark_rapids_tpu_torch.memory.spill import (SpillableColumnarBatch,
                                                     TorchBufferCatalog)
    before = runtime_state(True)
    cat = TorchBufferCatalog.get()

    def make():
        return TorchColumnarBatch.from_numpy_columns(
            {k: cols6[k] for k in ("l_extendedprice", "l_discount")}
        ).to_device(torch.device("cuda"))

    sb = SpillableColumnarBatch(make())  # the catalog is its one holder
    nbytes = sb.size_bytes
    torch.cuda.synchronize()
    a0 = torch.cuda.memory_allocated()
    freed = cat.synchronous_spill(nbytes)
    a1 = torch.cuda.memory_allocated()
    sb.get_batch()
    torch.cuda.synchronize()
    a2 = torch.cuda.memory_allocated()
    sb.close()
    check(freed == nbytes and a0 - a1 >= nbytes,
          f"spill freed {freed} of {nbytes} bytes, the card {a0 - a1}")
    check(nbytes <= a2 - a1 < 2 * nbytes,
          f"unspill of {nbytes} bytes took {a2 - a1} on the card")
    held = make()
    sb = SpillableColumnarBatch(held)
    h0 = torch.cuda.memory_allocated()
    freed_held = cat.synchronous_spill(nbytes)
    same = sb.get_batch().columns[0].data.data_ptr() \
        == held.columns[0].data.data_ptr()
    h1 = torch.cuda.memory_allocated()
    sb.close()
    del held
    check(freed_held == 0 and same and h1 == h0,
          f"a held batch: spill freed {freed_held}, same memory {same}, "
          f"allocated {h0} -> {h1}")
    print(json.dumps({"spill_frees": {
        "rows": len(cols6["l_discount"]), "batch_bytes": nbytes,
        "spill_freed_on_card": a0 - a1, "unspill_took_on_card": a2 - a1,
        "held_batch_spilled": freed_held}, "card": smi}), flush=True)
    check_no_leak(before, True, "spill frees")


def real_oom_paths(smi, cols6) -> None:
    """(11c-iii) a real torch.cuda.OutOfMemoryError: with_retry over a
    2^24-row batch whose function allocates scratch in proportion to its
    rows, sized from mem_get_info so the whole batch cannot fit and a
    half can. The error turns into one retry, then a split; the halves'
    results equal the unconstrained result."""
    from spark_rapids_tpu_torch.columnar.batch import TorchColumnarBatch
    from spark_rapids_tpu_torch.memory.retry import RetryStats, with_retry
    before = runtime_state(True)
    host = TorchColumnarBatch.from_numpy_columns(
        {k: cols6[k] for k in ("l_extendedprice", "l_discount")})
    batch = host.to_device(torch.device("cuda"))
    n = batch.num_rows
    want = float((batch.columns[0].data[:n]
                  * batch.columns[1].data[:n]).sum())
    free = torch.cuda.mem_get_info()[0]
    per_row = int(0.7 * free / (n // 2))  # half: 0.7 of free; whole: 1.4

    def work(b):
        m = b.num_rows
        scratch = torch.empty(m * per_row, dtype=torch.uint8,
                              device="cuda")
        scratch[::1 << 20] = 1
        out = float((b.columns[0].data[:m] * b.columns[1].data[:m]).sum())
        del scratch
        return out

    stats = RetryStats()
    t0 = time.perf_counter()
    parts = list(with_retry(batch, work, stats=stats))
    wall = time.perf_counter() - t0
    del batch
    check_close(sum(parts), want, "real OOM: the halves' sum")
    check(len(parts) == 2 and stats.device_ooms == 2 and stats.retries == 1
          and stats.split_retries == 1,
          f"real OOM: {len(parts)} parts, {vars(stats)}")
    print(json.dumps({"real_device_oom": {
        "rows": n, "free_bytes": free, "scratch_bytes_per_row": per_row,
        "parts": len(parts), **vars(stats), "wall_s": wall},
        "card": smi}), flush=True)
    check_no_leak(before, True, "real OOM")


def deadline_cancel_paths(TorchSession, smi, tables, device, rows: int,
                          timeout: float = 0.2) -> None:
    """(11d) q21 in the benchmark layout: a deadline of `timeout` s raises
    QueryDeadlineExceeded, and session.cancel() from a second thread stops
    a running q21; neither leaves anything behind."""
    import threading

    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch.datagen import TPCH_TABLES, tpch_frames
    from spark_rapids_tpu_torch.serving.query_context import (
        QueryCancelledError, QueryDeadlineExceeded)
    from spark_rapids_tpu_torch.serving.scheduler import QueryScheduler
    on_card = device == "cuda"
    host = tpch_host(tables, rows, 4, TPCH_TABLES)
    s = TorchSession({"spark.rapids.shuffle.mode": "ICI",
                      "spark.sql.shuffle.partitions": "8"}, device=device)
    q = tpch.q21(tpch_frames(s, host))
    before = runtime_state(on_card)
    t0 = time.perf_counter()
    raised = False
    try:
        q.collect(timeout=timeout)
    except QueryDeadlineExceeded:
        raised = True  # the exception itself (and the frames its
        # traceback holds, with their tensors) goes with the except block
    late = time.perf_counter() - t0 - timeout
    check(raised, "q21 ran past its deadline without raising")
    check_no_leak(before, on_card, "q21 deadline")
    out = {}

    def run():
        try:
            q.collect()
        except BaseException as e:  # noqa: BLE001 — checked below
            out["t"] = time.perf_counter()
            out["err"] = type(e)  # not e: its traceback holds tensors

    th = threading.Thread(target=run)
    th.start()
    sched = QueryScheduler.get()
    end = time.monotonic() + 30
    while not sched._running and time.monotonic() < end:
        time.sleep(0.001)
    time.sleep(timeout)
    t_cancel = time.perf_counter()
    flagged = s.cancel()
    th.join(timeout=60)
    err = out.get("err")
    check(flagged == 1 and err is not None
          and issubclass(err, QueryCancelledError)
          and not issubclass(err, QueryDeadlineExceeded),
          f"q21 cancel: flagged {flagged}, raised {err!r}")
    check_no_leak(before, on_card, "q21 cancel")
    print(json.dumps({"q21_deadline_cancel": {
        "rows": rows, "timeout_s": timeout,
        "deadline_to_raise_ms": late * 1e3,
        "cancel_to_raise_ms": (out["t"] - t_cancel) * 1e3},
        "card": smi}), flush=True)
    s.stop()


def lifecycle_paths(F, TorchSession, smi, tables, df6, cols6, oracle6,
                    device: str = "cuda", mid: int = 1 << 22,
                    tenant_rows: int = 1 << 20, tenants=(1, 4, 16),
                    budget_batch_rows: int = 1 << 18,
                    deadline_s: float = 0.2) -> None:
    """Phase 11. With ``device="cpu"`` and small sizes it checks the
    script's logic off the card (the real-OOM case needs the card)."""
    t0 = time.perf_counter()
    hot_repeat_paths(F, TorchSession, smi, tables, df6, cols6, device, mid)
    serving_paths(TorchSession, smi, tables, device, tenant_rows, tenants)
    forced_oom_paths(F, TorchSession, smi, df6, oracle6, device)
    real_budget_paths(F, TorchSession, smi, tables, device, mid,
                      budget_batch_rows)
    if device == "cuda":
        spill_frees_paths(smi, cols6)
        real_oom_paths(smi, cols6)
    deadline_cancel_paths(TorchSession, smi, tables, device, mid,
                          deadline_s)
    if device == "cuda":
        lifecycle_overhead(TorchSession, smi, cols6, tables)
    print(f"phase 11: {time.perf_counter() - t0:.1f} s | card: {smi}",
          flush=True)


# ---------------------------------------------------------------------------
# phase 12: the 99 TPC-DS queries
# ---------------------------------------------------------------------------

#: the queries phase 12 holds to numpy float64 oracles at TPCDS_BIG rows,
#: one or more a new operator
TPCDS_ORACLE_QUERIES = ("q98", "q47", "q51", "q44", "q22", "q38", "q87",
                        "q39")
TPCDS_SMALL = 12_000
#: phase 12's (b) and (c), and phase 14's TPC-DS cases (2^22 before phase
#: 16, 2^21 before phase 18: halved to make room for each in the script's
#: time)
TPCDS_BIG = 1 << 20


def tpcds_cpu_answers(rows: int, path: str) -> None:
    """Every TPC-DS query through the port on the CPU over the benchmark's
    tables at ``rows``: (columns, rows) a query, pickled to ``path``."""
    import pickle
    from spark_rapids_tpu_torch import tpcds
    from spark_rapids_tpu_torch.memory.device import TorchDeviceManager
    TorchDeviceManager.initialize(device="cpu", total_bytes=8 << 30)
    s = tpcds.make_session("cpu")
    t = tpcds.load_tables(s, rows)
    out = {}
    for name, query in tpcds.QUERIES.items():
        q = query(s, t)
        out[name] = (q.columns, q.collect())
    with open(path, "wb") as f:
        pickle.dump(out, f)


def tpcds_canon(columns, rows):
    """tests/test_tpcds.py's canonical form: columns by name, floats
    rounded to 4 places, rows sorted with nulls low."""
    cols = sorted(columns)
    out = [tuple(round(r[c], 4) if isinstance(r[c], float) else r[c]
                 for c in cols) for r in rows]
    low = [str(tuple((x is None, x if x is not None else 0) for x in r))
           for r in out]
    return [out[i] for i in np.argsort(np.array(low))]


def check_tpcds_match(got_cols, got, want_cols, want, what: str) -> None:
    """The tests' compare: the same rows after canonical sorting, floats
    within rel 1e-4 / abs 1e-4 after rounding to 4 places."""
    check(bool(want), f"{what}: the CPU answer has no rows")
    check(len(got) == len(want), f"{what}: {len(got)} rows vs "
          f"{len(want)}")
    check(sorted(got_cols) == sorted(want_cols), f"{what}: columns")
    for g, w in zip(tpcds_canon(got_cols, got),
                    tpcds_canon(want_cols, want)):
        for gv, wv in zip(g, w):
            if isinstance(gv, float) and isinstance(wv, float):
                check(abs(gv - wv) <= 1e-4 + 1e-4 * abs(wv)
                      or (gv != gv and wv != wv), f"{what}: {g} != {w}")
            else:
                check(gv == wv, f"{what}: {g} != {w}")


def _ds_strings(col) -> np.ndarray:
    return np.array(host_strings(col), dtype=object)


def _ds_codes(col):
    """(distinct strings in order, each row's code) of a host string
    column: code order is string order."""
    words, code = np.unique(_ds_strings(col), return_inverse=True)
    return words, code.ravel()


def _ds_valid(table, name) -> np.ndarray:
    cols, valid = table[0], table[1]
    return valid.get(name, np.ones(len(cols[name]), bool))


def _ds_group_sum(inv, n_groups, vals, ok):
    """Per group: the sum of the valid values and their count."""
    s = np.bincount(inv[ok], weights=vals[ok], minlength=n_groups)
    c = np.bincount(inv[ok], minlength=n_groups)
    return s, c


def tpcds_oracles(host) -> dict:
    """numpy float64 answers of the phase's oracle queries over the host
    tables (``datagen.tpcds_host_tables``): a query -> (every row in the
    query's order before its LIMIT, its sort-key columns, its LIMIT)."""
    D = host["date_dim"][0]
    d_days = _days(D["d_date"])
    d_year, d_moy, d_mseq = D["d_year"], D["d_moy"], D["d_month_seq"]
    I = host["item"][0]
    cat_w, cat = _ds_codes(I["i_category"])
    cls_w, cls = _ds_codes(I["i_class"])
    brand_w, brand = _ds_codes(I["i_brand"])
    iid_w, iid = _ds_codes(I["i_item_id"])
    SS, SSV = host["store_sales"][0], host["store_sales"]
    ss_date = SS["ss_sold_date_sk"].astype(np.int64)
    ss_dok = _ds_valid(SSV, "ss_sold_date_sk")
    ss_date = np.where(ss_dok, ss_date, 0)
    ss_item = SS["ss_item_sk"].astype(np.int64)
    out = {}

    # q98: revenue by item over the classes' totals (a window sum over
    # the whole partition)
    sel = np.isin(cat_w, ["Sports", "Books", "Home"])[cat]
    keep = ss_dok & sel[ss_item] & (d_days[ss_date] >= 10371) \
        & (d_days[ss_date] <= 10401)
    it = ss_item[keep]
    price_bits = I["i_current_price"].view(np.int64)
    keys, inv = _groups(iid[it], cat[it], cls[it], price_bits[it])
    rev = np.bincount(inv, weights=SS["ss_ext_sales_price"][keep])
    total = np.bincount(keys[:, 2], weights=rev)
    rows = [{"i_item_id": iid_w[k[0]], "i_category": cat_w[k[1]],
             "i_class": cls_w[k[2]], "itemrevenue": float(r),
             "revenueratio": float(r * 100.0 / total[k[2]])}
            for k, r in zip(keys, rev)]
    rows.sort(key=lambda r: (r["i_category"], r["i_class"], r["i_item_id"]))
    out["q98"] = (rows, ("i_category", "i_class", "i_item_id"), 100)

    # q47: monthly brand sales against the year's average, with the prior
    # and next month's (avg, lag and lead windows)
    ST = host["store"][0]
    sname_w, sname = _ds_codes(ST["s_store_name"])
    yrs = np.isin(d_year, [1999, 2000, 2001])
    keep = ss_dok & yrs[ss_date]
    it, st, dk = ss_item[keep], SS["ss_store_sk"][keep], ss_date[keep]
    keys, inv = _groups(cat[it], brand[it], sname[st], d_year[dk],
                        d_moy[dk])
    price_ok = _ds_valid(SSV, "ss_sales_price")[keep]
    s, c = _ds_group_sum(inv, len(keys), SS["ss_sales_price"][keep],
                         price_ok)
    sums = [float(v) if n else None for v, n in zip(s, c)]
    part_y = {}
    for k, v in zip(map(tuple, keys[:, :4]), sums):
        if v is not None:
            part_y.setdefault(k, []).append(v)
    avg_y = {k: sum(v) / len(v) for k, v in part_y.items()}
    rows = []
    for g, k in enumerate(keys):
        if k[3] != 2000 or sums[g] is None:
            continue
        avg = avg_y.get(tuple(k[:4]))
        if avg is None or not avg > 0 \
                or not abs(sums[g] - avg) / avg > 0.1:
            continue
        same = lambda h: 0 <= h < len(keys) and \
            tuple(keys[h][:3]) == tuple(k[:3])  # noqa: E731
        rows.append({"i_category": cat_w[k[0]], "i_brand": brand_w[k[1]],
                     "s_store_name": sname_w[k[2]], "d_year": int(k[3]),
                     "d_moy": int(k[4]), "sum_sales": sums[g],
                     "avg_monthly_sales": avg,
                     "psum": sums[g - 1] if same(g - 1) else None,
                     "nsum": sums[g + 1] if same(g + 1) else None})
    rows.sort(key=lambda r: (r["sum_sales"] - r["avg_monthly_sales"],
                             r["s_store_name"], r["d_moy"]))
    out["q47"] = (rows, ("sum_sales", "avg_monthly_sales", "s_store_name",
                         "d_moy"), 100)

    # q51: running sums of web and store sales a day, full outer joined
    period = (d_mseq >= 350) & (d_mseq <= 355)

    def cume(fact, date_col, item_col, price_col):
        T = host[fact]
        dk = T[0][date_col].astype(np.int64)
        dok = _ds_valid(T, date_col)
        dk = np.where(dok, dk, 0)
        keep = dok & period[dk]
        keys, inv = _groups(T[0][item_col][keep], d_days[dk[keep]])
        pok = _ds_valid(T, price_col)[keep]
        s, c = _ds_group_sum(inv, len(keys), T[0][price_col][keep], pok)
        acc, seen, prev, res = 0.0, 0, None, {}
        for k, v, n in zip(keys, s, c):
            if k[0] != prev:
                acc, seen, prev = 0.0, 0, k[0]
            if n:
                acc, seen = acc + v, seen + 1
            res[(int(k[0]), int(k[1]))] = acc if seen else None
        return res

    web = cume("web_sales", "ws_sold_date_sk", "ws_item_sk",
               "ws_sales_price")
    sto = cume("store_sales", "ss_sold_date_sk", "ss_item_sk",
               "ss_sales_price")
    epoch = np.datetime64("1970-01-01")
    rows = []
    for key in set(web) | set(sto):
        w, sv = web.get(key), sto.get(key)
        if (w if w is not None else 0.0) > (sv if sv is not None else 0.0):
            rows.append({"item_sk": key[0], "d_date": (
                epoch + np.timedelta64(key[1], "D")).astype(object),
                "w_cume": w, "s_cume": sv})
    rows.sort(key=lambda r: (r["item_sk"], r["d_date"]))
    out["q51"] = (rows, ("item_sk", "d_date"), 100)

    # q44: best and worst items of a store by average profit (global
    # rank windows), joined on rank
    keep = SS["ss_store_sk"] == 4
    keys, inv = _groups(ss_item[keep])
    s, c = _ds_group_sum(inv, len(keys), SS["ss_net_profit"][keep],
                         np.ones(int(keep.sum()), bool))
    avg = s / c
    srt = np.sort(avg)
    rank_asc = np.searchsorted(srt, avg, side="left") + 1
    rank_desc = len(avg) - np.searchsorted(srt, avg, side="right") + 1
    ids = host_strings(I["i_item_id"])
    rows = []
    for a in np.nonzero(rank_asc <= 10)[0]:
        for d in np.nonzero(rank_desc == rank_asc[a])[0]:
            rows.append({"rnk": int(rank_asc[a]),
                         "best_performing": ids[keys[a][0]],
                         "worst_performing": ids[keys[d][0]]})
    rows.sort(key=lambda r: r["rnk"])
    out["q44"] = (rows, ("rnk",), None)

    # q22: average quantity on hand over the item hierarchy's rollup
    INV = host["inventory"]
    idate = INV[0]["inv_date_sk"].astype(np.int64)
    keep = ((d_mseq >= 350) & (d_mseq <= 361))[idate]
    it = INV[0]["inv_item_sk"][keep]
    qoh = INV[0]["inv_quantity_on_hand"][keep].astype(np.float64)
    qok = _ds_valid(INV, "inv_quantity_on_hand")[keep]
    levels = [cat[it], cls[it], brand[it], iid[it]]
    words = [cat_w, cls_w, brand_w, iid_w]
    names = ["i_category", "i_class", "i_brand", "i_item_id"]
    rows = []
    for depth in range(4, -1, -1):
        if depth:
            keys, inv = _groups(*levels[:depth])
        else:
            keys, inv = np.zeros((1, 0), np.int64), np.zeros(len(it), int)
        s, c = _ds_group_sum(inv, len(keys), qoh, qok)
        for k, v, n in zip(keys, s, c):
            r = {nm: (words[j][k[j]] if j < depth else None)
                 for j, nm in enumerate(names)}
            r["qoh"] = float(v / n) if n else None
            rows.append(r)
    low = lambda v: (v is not None, v if v is not None else 0)  # noqa: E731
    rows.sort(key=lambda r: tuple(low(r[k]) for k in ["qoh"] + names))
    out["q22"] = (rows, ("qoh", *names), 100)

    # q38 / q87: distinct (last name, first name, date) a channel, then
    # INTERSECT and EXCEPT
    C = host["customer"][0]
    _, last = _ds_codes(C["c_last_name"])
    _, first = _ds_codes(C["c_first_name"])
    period = (d_mseq >= 350) & (d_mseq <= 361)

    def chan(fact, date_col, cust_col):
        T = host[fact]
        dk = T[0][date_col].astype(np.int64)
        dok = _ds_valid(T, date_col)
        dk = np.where(dok, dk, 0)
        keep = dok & period[dk]
        cu = T[0][cust_col][keep].astype(np.int64)
        return np.unique((last[cu] * 1000 + first[cu]) * 100_000
                         + d_days[dk[keep]])

    s_set = chan("store_sales", "ss_sold_date_sk", "ss_customer_sk")
    c_set = chan("catalog_sales", "cs_sold_date_sk", "cs_bill_customer_sk")
    w_set = chan("web_sales", "ws_sold_date_sk", "ws_bill_customer_sk")
    out["q38"] = ([{"cnt": len(np.intersect1d(np.intersect1d(s_set, c_set),
                                              w_set))}], (), None)
    out["q87"] = ([{"cnt": len(np.setdiff1d(np.setdiff1d(s_set, c_set),
                                            w_set))}], (), None)

    # q39: the inventory's coefficient of variation a warehouse and month
    # (stddev), January joined to February
    keep = (d_year == 2000)[idate]
    wh = INV[0]["inv_warehouse_sk"][keep]
    moy = d_moy[idate[keep]]
    q = INV[0]["inv_quantity_on_hand"][keep].astype(np.float64)
    qok = _ds_valid(INV, "inv_quantity_on_hand")[keep]
    keys, inv = _groups(wh, moy)
    s, c = _ds_group_sum(inv, len(keys), q, qok)
    s2 = np.bincount(inv[qok], weights=q[qok] ** 2, minlength=len(keys))
    cov = {}
    for k, sm, sq, n in zip(keys, s, s2, c):
        if n < 2:
            continue
        sd = np.sqrt(max((sq - sm * sm / n) / (n - 1), 0.0))
        mean = sm / n
        if mean > 0 and sd / mean > 0.5:
            cov[(int(k[0]), int(k[1]))] = float(sd / mean)
    rows = [{"w1": w, "cov1": cov[(w, 1)], "cov2": cov[(w, 2)]}
            for w in sorted({w for w, _ in cov})
            if (w, 1) in cov and (w, 2) in cov]
    out["q39"] = (rows, ("w1",), None)
    return out


def _ds_close(g, w) -> bool:
    if isinstance(w, float) and isinstance(g, float):
        return abs(g - w) <= RTOL_FRAMEWORK * abs(w)
    return g == w


def check_tpcds_oracle(rows, oracle, what: str) -> None:
    """The oracle's rows in the query's order: integers, strings, dates
    and nulls exact, floats within RTOL_FRAMEWORK. Rows tied on the sort
    keys may come in any order among themselves; where the LIMIT cuts
    through such a tie, the rows kept are some of the tied ones."""
    want, sort_keys, limit = oracle
    n = len(want) if limit is None else min(limit, len(want))
    check(len(rows) == n, f"{what}: {len(rows)} rows, want {n}")
    for r in rows:
        check(list(r) == list(want[0]), f"{what}: columns {list(r)}")

    def key(r):
        return tuple(r[k] for k in sort_keys)

    def canon(r):
        return tuple((v is None, round(v, 6) if isinstance(v, float)
                      else str(v)) for v in r.values())

    i = 0
    while i < n:
        j = i + 1
        while j < len(want) and key(want[j]) == key(want[i]):
            j += 1
        grp_w = sorted(want[i:j], key=canon)
        grp_g = sorted(rows[i:min(j, n)], key=canon)
        if j <= n:
            pairs = list(zip(grp_g, grp_w))
        else:  # the LIMIT cuts this tie: each row kept is a tied one
            pairs = [(g, next((w for w in grp_w if all(
                _ds_close(g[k], w[k]) for k in w)), grp_w[0]))
                for g in grp_g]
        for g, w in pairs:
            for k in w:
                check(_ds_close(g[k], w[k]),
                      f"{what}: {k} {g[k]!r} != {w[k]!r} in {g}")
        i = j


class CpuAnswers:
    """Phase 12 (a)'s CPU answers: with ``start``, computed by a process
    of its own (``chip_smoke.py --tpcds-cpu``; a process's sessions share
    one device), which main starts at the beginning of the run so the
    answers are ready by phase 12; else computed in this process when
    asked for."""

    def __init__(self, rows: int, start: bool):
        import os
        import tempfile
        self.rows = rows
        self.dir = tempfile.mkdtemp(prefix="tpcds_cpu_")
        self.path = os.path.join(self.dir, "answers.pkl")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--tpcds-cpu",
             str(rows), self.path]) if start else None

    def result(self) -> dict:
        import pickle
        if self.proc is None:
            tpcds_cpu_answers(self.rows, self.path)
        else:
            check(self.proc.wait(timeout=900) == 0,
                  "the CPU answers failed")
        with open(self.path, "rb") as f:
            return pickle.load(f)

    def close(self) -> None:
        import shutil
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        shutil.rmtree(self.dir, ignore_errors=True)


def tpcds_paths(F, TorchSession, smi, device: str = "cuda",
                small: int = TPCDS_SMALL, big: int = TPCDS_BIG,
                cpu_answers: "CpuAnswers" = None, keep: dict = None) -> None:
    """Phase 12. With ``device="cpu"`` it checks the script's oracles and
    compares off the card at the sizes given (no timing lines). ``keep``
    receives the TPCDS_BIG-row tables and their oracles (for phase 14)."""
    from spark_rapids_tpu_torch import tpcds
    from spark_rapids_tpu_torch.datagen import tpcds_host_tables, tpch_frames
    on_card = device == "cuda"
    t0 = time.perf_counter()
    names = sorted(tpcds.QUERIES, key=lambda q: int(q[1:]))
    base = {"spark.rapids.shuffle.mode": "ICI",
            "spark.sql.shuffle.partitions": "4"}

    # (a) every query at `small` rows on the device against the same query
    # through the port on the CPU over the same tables
    own = cpu_answers is None
    if own:
        cpu_answers = CpuAnswers(small, start=on_card)
    try:
        s = TorchSession(base, device=device)
        t = tpch_frames(s, tpcds_host_tables(small, 4))
        card = {}
        for name in names:
            q = tpcds.QUERIES[name](s, t)
            card[name] = (q.columns, q.collect())
        del t, s
        cpu = cpu_answers.result()
    finally:
        if own:
            cpu_answers.close()
    for name in names:
        check_tpcds_match(*card[name], *cpu[name], f"{name} at {small}")
    print(f"(12a) all {len(names)} TPC-DS queries at {small} rows on "
          f"{device} equal the port's CPU answers", flush=True)
    if on_card:
        release_plans()

    # (b) + (c) at `big` rows, test mode on: nothing may stay on the host
    t1 = time.perf_counter()
    host = tpcds_host_tables(big, 4)
    t2 = time.perf_counter()
    oracles = tpcds_oracles(host)
    if keep is not None:
        keep["tpcds"] = (host, oracles)
    print(f"phase 12 tables {t2 - t1:.1f} s, oracles "
          f"{time.perf_counter() - t2:.1f} s", flush=True)
    for name in TPCDS_ORACLE_QUERIES:
        check(bool(oracles[name][0]), f"the oracle of {name} has no rows")
    s = TorchSession(dict(base, **{"spark.rapids.sql.test.enabled": "true"}),
                     device=device)
    t = tpch_frames(s, host)
    del host
    failed = []  # every query runs; the phase fails after the last
    for name in names:
        try:
            tpcds_query_at_scale(name, s, t, oracles, big, smi, on_card)
        except Exception as e:  # noqa: BLE001
            failed.append(f"{name}: {e!r}")
            print(f"(12b) {name} at {big} FAILED: {e!r}", flush=True)
    check(not failed, f"phase 12 at {big}: {failed}")
    print(f"(12b) all {len(names)} TPC-DS queries at {big} rows on "
          f"{device} in test mode: rows, two collects identical; "
          f"{', '.join(TPCDS_ORACLE_QUERIES)} equal their numpy oracles",
          flush=True)
    del t, s
    print(f"phase 12: {time.perf_counter() - t0:.1f} s", flush=True)


def _first_difference(a, b) -> str:
    if len(a) != len(b):
        return f"{len(a)} rows vs {len(b)}"
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return f"row {i}: {x} vs {y}"
    return "none"


def tpcds_query_at_scale(name, s, t, oracles, big, smi, on_card) -> None:
    """(12b) and (c) for one query: two collects, the first profiled;
    its rows (and oracle), the warm collect identical to it, its timing
    line."""
    from spark_rapids_tpu_torch import tpcds
    q = tpcds.QUERIES[name](s, t)
    # the first collect is the profiled one (c); its rows are the ones
    # checked (b)
    runs: list = []
    c0 = time.perf_counter()
    if on_card:
        busy_ms, per_op, ops = profile_device(
            lambda: runs.append(q.collect()), 1, warm=False)
    else:
        runs.append(q.collect())
    first = time.perf_counter() - c0
    got = runs[0]
    if name == "q75" and not got:
        # q75 keeps brands whose year-over-year count fell under 0.9;
        # at this size a brand's yearly count sums ~10^4 sales, so
        # none may fall that far: the answer is empty exactly when
        # every joined brand's ratio is at least 0.9
        years = tpcds.q75_brand_years(s, t).collect()
        ratios = [r["c_cnt"] / r["p_cnt"] for r in years
                  if r["p_cnt"] and r["p_cnt"] > 0]
        check(bool(ratios) and min(ratios) >= 0.9,
              f"q75 at {big}: no rows, yet a ratio under 0.9")
        print(f"(12b) q75 at {big}: no rows, as its {len(years)} "
              f"brands' count ratios are all >= 0.9 (lowest "
              f"{min(ratios):.4f})", flush=True)
    else:
        check(bool(got), f"{name} at {big}: no rows")
    if name in TPCDS_ORACLE_QUERIES:
        check_tpcds_oracle(got, oracles[name], f"{name} at {big}")
    before = dict(s.counters)
    c0 = time.perf_counter()
    again = q.collect()
    best = time.perf_counter() - c0
    check(again == got, f"{name} at {big}: two collects differ: "
          f"{_first_difference(got, again)}")
    delta = {k: v - before.get(k, 0) for k, v in s.counters.items()
             if v != before.get(k, 0)}
    line = {"rows": big, "result_rows": len(got),
            "first_collect_s": first, "best_collect_s": best,
            "op_time_ms": {k[len("opTime."):]: v for k, v in delta.items()
                           if k.startswith("opTime.")},
            # a collect's compiled-stage re-runs and sorts out of core
            "reruns": {k: v for k, v in delta.items()
                       if not k.startswith("opTime.")}}
    if on_card:
        line.update({
            "device_busy_ms": busy_ms,
            "htod_ms": sum(ms for k, ms in per_op if "HtoD" in k),
            "idle_share": 1.0 - busy_ms / (best * 1e3),
            "device_ops": ops,
            "top_device_ops_ms": [(k[:60], ms) for k, ms in per_op[:3]]})
    print(json.dumps({f"tpcds_{name}": line, "card": smi}), flush=True)


# ---------------------------------------------------------------------------
# phase 13: strings and regex
# ---------------------------------------------------------------------------

STR_BIG = 1 << 22
STR_SMALL = 12_000
#: the text rows (by id) the sample queries compare row by row
STR_SAMPLE = 4096
#: the text table's vocabulary: words, digit groups, runs of spaces
TEXT_WORDS = ["deliver", "in", "person", "take", "back", "return", "none",
              "collect", "cod", "SHIP", "mail", "truck", "air", "rail",
              "Express", "PACKAGE", "carefully", "final", "deposits",
              "sleep", "quickly", "ironic", "requests", "-", "--", "a-b",
              "  ", "   ", "12-345", "007", "2024-10", "99", "5-6-7",
              "4096", "x1y2", "eel", "INPUT", "aeiou", "instructions",
              "accounts", "packages", "furiously", "pinto beans",
              "regular", "blithely", "slyly even", "314-15-9265"]
#: the non-ASCII words, one in each of 1 row in 64
TEXT_WIDE = ["café", "straße", "中文", "naïve", "größe", "日本語"]
TEXT_MODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]


def text_table(n: int, seed: int = 13):
    """The text table: ``id`` (0..n-1), ``mode`` (a TPC-H ship mode) and
    ``s``, 4-16 words of ``TEXT_WORDS`` joined by spaces, cut to the words
    that fit in 120 bytes (one row in 16 empty), one row in 64 with a
    non-ASCII word first, one row in 32 null (its bytes kept: they must
    not reach a result). Built with numpy, no loop over rows. Returns
    (columns, validity)."""
    from spark_rapids_tpu_torch.columnar.vector import HostStrings
    rng = np.random.default_rng(seed)
    words = [w.encode() for w in TEXT_WORDS + TEXT_WIDE]
    n_plain = len(TEXT_WORDS)
    wlen = np.array([len(w) for w in words], np.int32)
    mat = np.zeros((len(words), 12), np.uint8)
    for i, w in enumerate(words):
        mat[i, :len(w)] = np.frombuffer(w, np.uint8)
    kmax = 16
    k = rng.integers(4, kmax + 1, n).astype(np.int32)
    k[rng.random(n) < 1 / 16] = 0
    tok = rng.integers(0, n_plain, (n, kmax)).astype(np.int32)
    wide = (rng.random(n) < 1 / 64) & (k > 0)
    tok[wide, 0] = n_plain + rng.integers(0, len(TEXT_WIDE),
                                          int(wide.sum()))
    use = np.arange(kmax)[None, :] < k[:, None]
    slot = np.where(use, wlen[tok] + 1, 0).astype(np.int64)
    # the words that fit: a row is its slots less the last space
    use &= np.cumsum(slot, axis=1) - 1 <= 120
    k = use.sum(1).astype(np.int32)
    slot = np.where(use, slot, 0)
    has = k > 0
    slot[np.nonzero(has)[0], k[has] - 1] -= 1  # no space after the last
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(slot.sum(1), out=offsets[1:])
    # each byte: its slot, its place in the slot, its word; int32 (the
    # table stays under 2^31 bytes)
    flat = slot.ravel().astype(np.int32)
    starts = (np.cumsum(flat, dtype=np.int64) - flat).astype(np.int32)
    of_byte = np.repeat(np.arange(flat.size, dtype=np.int32), flat)
    pos = np.arange(of_byte.size, dtype=np.int32)
    pos -= starts[of_byte]
    t = tok.ravel()[of_byte]
    del of_byte
    space = pos >= wlen[t]
    src = t * 12 + np.minimum(pos, 11)
    del t, pos
    chars = mat.ravel()[src]
    chars[space] = 32
    del src, space
    mode = rng.integers(0, len(TEXT_MODES), n)
    from spark_rapids_tpu_torch.datagen import _strings_from_words
    cols = {"id": np.arange(n, dtype=np.int64),
            "mode": _strings_from_words(TEXT_MODES, mode),
            "s": HostStrings(offsets.astype(np.int32), chars)}
    return cols, {"s": rng.random(n) >= 1 / 32}


def strings_host_tables(rows: int, text_rows: int = None) -> dict:
    """Phase 13's tables: lineitem at ``rows`` and customer at its TPC-H
    ratio (``datagen.tpch_host_tables``, seed 42) and the text table at
    ``text_rows`` (default ``rows``); each (columns, validity,
    partitions)."""
    from spark_rapids_tpu_torch.datagen import tpch_host_tables
    host = tpch_host_tables(rows, 4, names=("lineitem", "customer"))
    cols, valid = text_table(rows if text_rows is None else text_rows)
    host["text"] = (cols, valid, 4)
    return host


def arrow_table(cols: dict, valid: dict):
    """A host table (numpy, ``HostStrings``) as an Arrow table, nulls from
    ``valid`` (the reference's ``createDataFrame`` reads Arrow)."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.columnar.vector import HostStrings
    out = {}
    for name, v in cols.items():
        mask = None if name not in valid else ~valid[name]
        if isinstance(v, HostStrings):
            n = len(v)
            bitmap = None if mask is None else pa.py_buffer(np.packbits(
                ~mask, bitorder="little").tobytes())
            out[name] = pa.Array.from_buffers(
                pa.string(), n, [bitmap, pa.py_buffer(v.offsets.tobytes()),
                                 pa.py_buffer(v.chars.tobytes())],
                null_count=0 if mask is None else int(mask.sum()))
        else:
            out[name] = pa.array(v, mask=mask)
    return pa.table(out)


def _ascii_text(F, text):
    return text.filter((F.length("s") == F.octet_length("s"))
                       | F.col("s").isNull())


#: the string-valued text functions, all on the device over ASCII
TEXT_STRING_FNS = {
    "upper": lambda F, c: F.upper(c), "lower": lambda F, c: F.lower(c),
    "trim": lambda F, c: F.trim(c), "ltrim": lambda F, c: F.ltrim(c),
    "rtrim": lambda F, c: F.rtrim(c), "reverse": lambda F, c: F.reverse(c),
    "initcap": lambda F, c: F.initcap(c),
    "repeat": lambda F, c: F.repeat(c, 2),
    "replace": lambda F, c: F.replace(c, "e", "EE"),
    "translate": lambda F, c: F.translate(c, "aeiou", "AEI"),
    "lpad": lambda F, c: F.lpad(c, 20, "*"),
    "rpad": lambda F, c: F.rpad(c, 20, "-="),
    "concat_ws": lambda F, c: F.concat_ws("|", c, F.col("mode")),
    "substring_index": lambda F, c: F.substring_index(c, " ", 2),
    "substring": lambda F, c: F.substring(c, 3, 5)}
#: the integer-valued ones
TEXT_INT_FNS = {
    "length": lambda F, c: F.length(c),
    "octet_length": lambda F, c: F.octet_length(c),
    "bit_length": lambda F, c: F.bit_length(c),
    "ascii": lambda F, c: F.ascii(c),
    "locate": lambda F, c: F.locate("in", c),
    "instr": lambda F, c: F.instr(c, "e"),
    "startswith": lambda F, c: c.startswith("de").cast("int"),
    "endswith": lambda F, c: c.endswith("n").cast("int"),
    "contains": lambda F, c: c.contains("ship").cast("int")}
#: the ones whose oracle is Python a row at a time (no pyarrow.compute
#: function has Spark's definition), in the prep process over the whole
#: table too
PY_ORACLE = {"initcap", "translate", "rpad", "substring_index", "ascii"}


#: phase 13's regex patterns: inside the DFA subset, and one outside it
RX_PHONE = r"^\d{2}-\d{3}"
RX_INSTRUCT = "(DELIVER|TAKE) BACK"
RX_WORDS = "[A-Z]+ [A-Z]{2} "
RX_BACKREF = r"(\d)\1"
RX_DIGITS = r"\d+"
RX_PAIR = r"(\d+)-(\d+)"
RX_TEXT = r"[0-9]{2}-[0-9]{3}"


def strings_queries(F, Window, t) -> dict:
    """Phase 13's queries over ``strings_host_tables``' frames ``t``, built
    with either package's ``functions`` and ``Window``: name → (DataFrame,
    the columns its rows sort by)."""
    text, li, cu = t["text"], t["lineitem"], t["customer"]
    s = F.col("s")
    asc = _ascii_text(F, text)
    # a string function's sum of lengths and of Spark's hash of its rows
    # (a digest of every byte in its place)
    aggs = [F.count("*").alias("n")]
    for name, fn in TEXT_STRING_FNS.items():
        aggs += [F.sum(F.length(fn(F, s))).alias(f"len_{name}"),
                 F.sum(F.hash(fn(F, s))).alias(f"hash_{name}")]
    for name, fn in TEXT_INT_FNS.items():
        aggs.append(F.sum(fn(F, s)).alias(f"sum_{name}"))
    aggs += [F.min(F.upper(s)).alias("min_upper"),
             F.max(F.trim(s)).alias("max_trim"),
             F.min(s).alias("min_s"), F.max(s).alias("max_s")]
    sample = asc.filter(F.col("id") < STR_SAMPLE).select(
        "id", s, *[fn(F, s).alias(name)
                   for name, fn in TEXT_STRING_FNS.items()],
        *[fn(F, s).alias(name) for name, fn in TEXT_INT_FNS.items()],
        F.format_number(F.col("id") * 1.25, 2).alias("format_number"),
        F.conv(F.col("id").cast("string"), 10, 16).alias("conv"),
        F.regexp_replace(s, RX_DIGITS, "#").alias("regexp_replace"),
        F.regexp_extract(s, RX_TEXT, 0).alias("regexp_extract"),
        F.rlike(s, RX_TEXT).alias("rlike"))
    q_ = F.col("l_quantity")
    p_ = F.col("l_extendedprice")
    d_ = F.col("l_shipdate")
    casts = li.groupBy("l_shipmode").agg(
        F.count("*").alias("n"),
        F.sum(F.length(q_.cast("string"))).alias("len_q"),
        F.sum(F.length(p_.cast("string"))).alias("len_p"),
        F.min(d_.cast("string")).alias("min_d"),
        F.max(d_.cast("string")).alias("max_d"),
        F.sum(q_.cast("string").cast("int")).alias("sum_q"),
        F.sum(F.when(p_.cast("string").cast("double") == p_, 1)
              .otherwise(0)).alias("p_round_trips"),
        F.sum(F.when(d_.cast("string").cast("date") == d_, 1)
              .otherwise(0)).alias("d_round_trips"),
        F.sum(F.length(F.upper(F.col("l_shipinstruct")))).alias("len_up"),
        F.min("l_shipinstruct").alias("min_i"),
        F.max("l_shipinstruct").alias("max_i"))
    phone = F.col("c_phone")
    regex_cu = cu.groupBy("c_mktsegment").agg(
        F.count("*").alias("n"),
        F.sum(F.rlike(phone, RX_PHONE).cast("int")).alias("phone"),
        F.sum(F.rlike(phone, RX_BACKREF).cast("int")).alias("backref"),
        F.sum(F.length(F.regexp_extract(phone, RX_PAIR, 1)))
        .alias("len_g1"),
        F.max(F.regexp_extract(phone, RX_PAIR, 1)).alias("max_g1"))
    ins = F.col("l_shipinstruct")
    regex_li = li.groupBy("l_shipmode").agg(
        F.count("*").alias("n"),
        F.sum(F.rlike(ins, RX_INSTRUCT).cast("int")).alias("take_back"),
        F.sum(F.rlike(ins, RX_WORDS).cast("int")).alias("words"))
    regex_text = asc.groupBy("mode").agg(
        F.count("*").alias("n"),
        F.sum(F.rlike(s, RX_TEXT).cast("int")).alias("rlike"),
        F.sum(F.length(F.regexp_replace(s, RX_DIGITS, "#")))
        .alias("len_replace"),
        F.sum(F.length(F.regexp_extract(s, RX_TEXT, 0)))
        .alias("len_extract"))
    flag = F.col("l_returnflag")
    case = li.select(F.when(flag == "R", F.col("l_shipmode"))
                     .when(ins.like("DELIVER%"), F.lit("deliver"))
                     .otherwise(F.concat(F.col("l_linestatus"), F.lit("-"),
                                         flag)).alias("c"),
                     ins).groupBy("c").agg(
        F.count("*").alias("n"), F.min(ins).alias("min_i"),
        F.max(ins).alias("max_i"))
    minmax = li.groupBy("l_returnflag", "l_linestatus").agg(
        F.count("*").alias("n"), F.min(ins).alias("min_i"),
        F.max(ins).alias("max_i"), F.min("l_shipmode").alias("min_m"),
        F.max("l_shipmode").alias("max_m"))
    w = Window.partitionBy("l_returnflag").orderBy(
        "l_orderkey", "l_extendedprice", "l_partkey")
    window = li.select(
        "l_returnflag",
        F.lag("l_shipmode", 1, "none").over(w).alias("prev_mode"),
        F.max(ins).over(w).alias("max_i")).groupBy(
        "l_returnflag", "prev_mode", "max_i").agg(F.count("*").alias("n"))
    wide = text.filter(F.length("s") != F.octet_length("s")).select(
        "id", s, *[fn(F, s).alias(name)
                   for name, fn in TEXT_STRING_FNS.items()
                   if name != "concat_ws"],
        *[fn(F, s).alias(name) for name, fn in TEXT_INT_FNS.items()],
        s.like("%a_e%").alias("like"),
        F.regexp_replace(s, RX_DIGITS, "#").alias("regexp_replace"))
    return {"a_text": (asc.groupBy("mode").agg(*aggs), ["mode"]),
            "a_sample": (sample, ["id"]),
            "a_casts": (casts, ["l_shipmode"]),
            "b_customer": (regex_cu, ["c_mktsegment"]),
            "b_lineitem": (regex_li, ["l_shipmode"]),
            "b_text": (regex_text, ["mode"]),
            "c_case": (case, ["c"]),
            "c_minmax": (minmax, ["l_returnflag", "l_linestatus"]),
            "c_window": (window, ["l_returnflag", "prev_mode", "max_i"]),
            "d_non_ascii": (wide, ["id"])}


#: the host hops phase 13 expects a query to take, by (class, reason):
#: the reference's design (string casts, host row ops, the string
#: min/max segment, capture groups, an out-of-subset pattern, non-ASCII
#: input); every other string expression stays on the card
_MINMAX = {("Min", "string min/max segment"),
           ("Max", "string min/max segment")}
STR_EXPECTED_HOPS = {
    "a_text": _MINMAX,
    "a_sample": {("FormatNumber", "host row op"), ("Conv", "host row op"),
                 ("Cast", "string cast")},
    "a_casts": _MINMAX | {("Cast", "string cast")},
    "b_customer": {("RLike", "out-of-subset pattern"),
                   ("RegexpExtract", "capture group"),
                   ("Max", "string min/max segment")},
    "b_lineitem": set(),
    "b_text": set(),
    "c_case": _MINMAX,
    "c_minmax": _MINMAX,
    "c_window": set(),
}


def sorted_rows(rows, keys):
    """Rows sorted by ``keys`` (nulls first), as tuples of every column."""
    def k(r):
        return tuple((r[c] is not None, r[c] if r[c] is not None else "")
                     for c in keys)
    return [tuple(r.values()) for r in sorted(rows, key=k)]


def strings_cpu_answers(rows: int, path: str) -> None:
    """Phase 13's queries through the port on the CPU at ``rows``: sorted
    rows a query, pickled to ``path``."""
    import pickle
    from spark_rapids_tpu_torch.memory.device import TorchDeviceManager
    from spark_rapids_tpu_torch.session import TorchSession
    from spark_rapids_tpu_torch.window import Window
    import spark_rapids_tpu_torch.functions as F
    from spark_rapids_tpu_torch.datagen import tpch_frames
    TorchDeviceManager.initialize(device="cpu", total_bytes=8 << 30)
    s = TorchSession({}, device="cpu")
    t = tpch_frames(s, strings_host_tables(rows))
    out = {name: sorted_rows(q.collect(), keys)
           for name, (q, keys) in strings_queries(F, Window, t).items()}
    with open(path, "wb") as f:
        pickle.dump(out, f)


def _pc_text(pc, pa, s, mode) -> dict:
    """pyarrow.compute answers of the text functions over ``s`` (the ones
    of ``PY_ORACLE`` left out)."""
    return {
        "upper": pc.utf8_upper(s), "lower": pc.utf8_lower(s),
        "trim": pc.utf8_trim_whitespace(s),
        "ltrim": pc.utf8_ltrim_whitespace(s),
        "rtrim": pc.utf8_rtrim_whitespace(s),
        "reverse": pc.utf8_reverse(s), "repeat": pc.binary_repeat(s, 2),
        "replace": pc.replace_substring(s, pattern="e", replacement="EE"),
        # Spark's lpad cuts a longer string to the width
        "lpad": pc.utf8_lpad(pc.utf8_slice_codeunits(s, 0, 20), width=20,
                             padding="*"),
        "concat_ws": pc.binary_join_element_wise(s, mode, "|",
                                                 null_handling="skip"),
        "substring": pc.utf8_slice_codeunits(s, 2, 7),
        "length": pc.utf8_length(s), "octet_length": pc.binary_length(s),
        "bit_length": pc.multiply(pc.binary_length(s), 8),
        "locate": pc.add(pc.find_substring(s, "in"), 1),
        "instr": pc.add(pc.find_substring(s, "e"), 1),
        "startswith": pc.cast(pc.starts_with(s, "de"), pa.int32()),
        "endswith": pc.cast(pc.ends_with(s, "n"), pa.int32()),
        "contains": pc.cast(pc.match_substring(s, "ship"), pa.int32())}


def _py_text() -> dict:
    """Python answers (Spark's definitions) of the text functions a row at
    a time, and of the regex ones by Python's ``re``."""
    import re as _re

    def initcap(v):
        return " ".join(w[:1].upper() + w[1:].lower() if w else w
                        for w in v.split(" "))

    table = str.maketrans("aei", "AEI", "ou")

    def translate(v):
        return v.translate(table)

    def rpad(v):
        return v[:20] if len(v) >= 20 else v + ("-=" * 20)[:20 - len(v)]

    def extract(v):
        m = _re.search(RX_TEXT, v)
        return m.group(0) if m else ""
    return {"initcap": initcap, "translate": translate, "rpad": rpad,
            "locate": lambda v: v.find("in") + 1,
            "instr": lambda v: v.find("e") + 1,
            "substring_index": lambda v: " ".join(v.split(" ")[:2]),
            "ascii": lambda v: ord(v[0]) if v else 0,
            "regexp_replace": lambda v: _re.sub(RX_DIGITS, "#", v),
            "regexp_extract": extract,
            "rlike": lambda v: _re.search(RX_TEXT, v) is not None,
            "like": lambda v: _re.fullmatch("(?s).*a.e.*", v) is not None}


def _text_rows(pc, pa, table, extra) -> list:
    """Every text function of ``table``'s rows, with ``extra`` (name →
    (function of a Python value, Arrow type)), sorted by id: the rows of
    the sample and non-ASCII queries."""
    s = table["s"].combine_chunks()
    vals = s.to_pylist()
    py = _py_text()
    fns = _pc_text(pc, pa, s, table["mode"].combine_chunks())

    def col(f, typ):
        return pa.array([None if v is None else f(v) for v in vals], typ)
    cols = {"id": table["id"], "s": s}
    for name in list(TEXT_STRING_FNS) + list(TEXT_INT_FNS):
        if name in extra:
            continue
        if name in PY_ORACLE or name in ("locate", "instr"):
            # (find_substring counts bytes; locate counts characters)
            cols[name] = col(py[name], pa.int32() if name in TEXT_INT_FNS
                             else pa.string())
        else:
            cols[name] = fns[name]
    for name, (f, typ) in extra.items():
        if f is not None:
            cols[name] = col(f, typ)
    return sorted_rows(pa.table(cols).to_pylist(), ["id"])


def a_casts_oracle(host) -> list:
    """``a_casts``' answer from pyarrow.compute over the lineitem."""
    import pyarrow as pa
    import pyarrow.compute as pc
    li_cols, li_valid = host["lineitem"][0], host["lineitem"][1]
    li = arrow_table(li_cols, li_valid)
    q = li["l_quantity"].combine_chunks()
    p = li["l_extendedprice"].combine_chunks()
    ins = li["l_shipinstruct"].combine_chunks()
    dtext = pc.cast(li["l_shipdate"].combine_chunks(), pa.string())
    one = pa.array(np.ones(len(li), np.int64))
    lt = pa.table({
        "l_shipmode": li["l_shipmode"],
        "q": pc.utf8_length(pc.cast(q, pa.string())),
        "p": pc.utf8_length(pa.array(_java_double_text(p.to_numpy()))),
        "d": dtext, "qq": pc.cast(q, pa.int64()), "one": one,
        "up": pc.utf8_length(pc.utf8_upper(ins)), "i": ins})
    return _group_rows(lt, ["l_shipmode"], [
        ("n", "i", "count_all"), ("len_q", "q", "sum"), ("len_p", "p", "sum"),
        ("min_d", "d", "min"), ("max_d", "d", "max"), ("sum_q", "qq", "sum"),
        ("p_round_trips", "one", "sum"), ("d_round_trips", "one", "sum"),
        ("len_up", "up", "sum"), ("min_i", "i", "min"), ("max_i", "i", "max")])


def strings_oracles(host) -> dict:
    """Phase 13's answers from pyarrow.compute and Python's ``re`` over
    the host tables, independent of the port: name → sorted rows."""
    import re as _re

    import pyarrow as pa
    import pyarrow.compute as pc
    py = _py_text()
    text = arrow_table(host["text"][0], host["text"][1])
    s_all = text["s"].combine_chunks()
    ascii_ = pc.equal(pc.utf8_length(s_all), pc.binary_length(s_all))
    asc = text.filter(pc.or_kleene(ascii_, pc.is_null(s_all)))
    sa = asc["s"].combine_chunks()
    mode = asc["mode"].combine_chunks()
    fns = _pc_text(pc, pa, sa, mode)
    vals = sa.to_pylist()
    for name in PY_ORACLE:
        typ = pa.int32() if name in TEXT_INT_FNS else pa.string()
        fns[name] = pa.array([None if v is None else py[name](v)
                              for v in vals], typ)
    del vals
    # the regex answers over the whole table by RE2 (for these patterns
    # RE2, Python's re and Java agree); the sample's by Python's re
    fns["regexp_replace"] = pc.replace_substring_regex(sa, RX_DIGITS, "#")
    fns["rlike"] = pc.cast(pc.match_substring_regex(sa, RX_TEXT),
                           pa.int64())
    fns["regexp_extract"] = pc.if_else(
        pc.is_null(sa), pa.scalar(None, pa.string()),
        pc.fill_null(pc.struct_field(pc.extract_regex(
            sa, f"(?P<m>{RX_TEXT})"), [0]), ""))
    cols, specs = {"mode": mode, "s": sa}, [("n", "s", "count_all")]
    for name in TEXT_STRING_FNS:
        cols[f"len_{name}"] = pc.utf8_length(fns[name])
        cols[f"hash_{name}"] = pa.array(spark_hash(fns[name]))
        specs += [(f"len_{name}", f"len_{name}", "sum"),
                  (f"hash_{name}", f"hash_{name}", "sum")]
    for name in TEXT_INT_FNS:
        cols[f"sum_{name}"] = pc.cast(fns[name], pa.int64())
        specs.append((f"sum_{name}", f"sum_{name}", "sum"))
    cols["upper"], cols["trim"] = fns["upper"], fns["trim"]
    specs += [("min_upper", "upper", "min"), ("max_trim", "trim", "max"),
              ("min_s", "s", "min"), ("max_s", "s", "max")]
    out = {"a_text": _group_rows(pa.table(cols), ["mode"], specs)}
    tt = pa.table({"mode": mode, "s": sa, "r": fns["rlike"],
                   "rr": pc.utf8_length(fns["regexp_replace"]),
                   "re": pc.utf8_length(fns["regexp_extract"])})
    out["b_text"] = _group_rows(tt, ["mode"], [
        ("n", "s", "count_all"), ("rlike", "r", "sum"),
        ("len_replace", "rr", "sum"), ("len_extract", "re", "sum")])

    sample = asc.filter(pc.less(asc["id"], STR_SAMPLE))
    out["a_sample"] = _text_rows(pc, pa, sample, {
        "format_number": (None, None), "conv": (None, None),
        "regexp_replace": (py["regexp_replace"], pa.string()),
        "regexp_extract": (py["regexp_extract"], pa.string()),
        "rlike": (py["rlike"], pa.bool_())})
    out["a_sample"] = _with_id_columns(out["a_sample"],
                                       sorted(sample["id"].to_pylist()))

    out["a_casts"] = a_casts_oracle(host)
    li_cols, li_valid = host["lineitem"][0], host["lineitem"][1]
    li = arrow_table(li_cols, li_valid)
    ins = li["l_shipinstruct"].combine_chunks()

    cu = arrow_table(host["customer"][0], host["customer"][1])
    phone = cu["c_phone"].combine_chunks().to_pylist()

    def g1(v):
        m = _re.search(RX_PAIR, v)
        return m.group(1) if m else ""
    ct = pa.table({
        "c_mktsegment": cu["c_mktsegment"],
        "phone": pa.array([int(_re.search(RX_PHONE, v) is not None)
                           for v in phone], pa.int64()),
        "backref": pa.array([int(_re.search(RX_BACKREF, v) is not None)
                             for v in phone], pa.int64()),
        "g1": pa.array([g1(v) for v in phone]),
        "len_g1": pa.array([len(g1(v)) for v in phone], pa.int64())})
    out["b_customer"] = _group_rows(ct, ["c_mktsegment"], [
        ("n", "phone", "count_all"), ("phone", "phone", "sum"),
        ("backref", "backref", "sum"), ("len_g1", "len_g1", "sum"),
        ("max_g1", "g1", "max")])

    words = ins.dictionary_encode()
    dic = words.dictionary.to_pylist()

    def by_word(pat):
        hit = np.array([int(_re.search(pat, w) is not None) for w in dic])
        return pa.array(hit[words.indices.to_numpy()], pa.int64())
    out["b_lineitem"] = _group_rows(pa.table({
        "l_shipmode": li["l_shipmode"], "i": ins, "tb": by_word(RX_INSTRUCT),
        "w": by_word(RX_WORDS)}), ["l_shipmode"], [
        ("n", "i", "count_all"), ("take_back", "tb", "sum"),
        ("words", "w", "sum")])

    flag = li["l_returnflag"].combine_chunks()
    status = li["l_linestatus"].combine_chunks()
    smode = li["l_shipmode"].combine_chunks()
    c = pc.if_else(pc.equal(flag, "R"), smode,
                   pc.if_else(pc.starts_with(ins, "DELIVER"), "deliver",
                              pc.binary_join_element_wise(status, flag,
                                                          "-")))
    out["c_case"] = _group_rows(pa.table({"c": c, "i": ins}), ["c"], [
        ("n", "i", "count_all"), ("min_i", "i", "min"),
        ("max_i", "i", "max")])
    out["c_minmax"] = _group_rows(pa.table({
        "l_returnflag": flag, "l_linestatus": status, "i": ins,
        "m": smode}), ["l_returnflag", "l_linestatus"], [
        ("n", "i", "count_all"), ("min_i", "i", "min"), ("max_i", "i", "max"),
        ("min_m", "m", "min"), ("max_m", "m", "max")])

    # the window, in the stable order of (flag, orderkey, price, partkey),
    # over dictionary codes: a flag's code for its partition, the
    # instruction's rank among the distinct instructions for the running max
    def codes(arr):
        enc = arr.dictionary_encode()
        return enc.indices.to_numpy().astype(np.int64), \
            np.array(enc.dictionary.to_pylist(), dtype=object)
    f_code, f_words = codes(flag)
    m_code, m_words = codes(smode)
    i_code, i_words = codes(ins)
    i_rank = np.argsort(np.argsort(i_words))  # code -> rank in byte order
    order = np.lexsort((np.arange(len(f_code)), li_cols["l_partkey"],
                        li_cols["l_extendedprice"], li_cols["l_orderkey"],
                        f_code))
    fo = f_code[order]
    start = np.ones(len(fo), bool)
    start[1:] = fo[1:] != fo[:-1]
    prev = np.empty(len(fo), np.int64)  # -1: the default, "none"
    prev[1:] = m_code[order][:-1]
    prev[start] = -1
    seg = np.cumsum(start) - 1
    rank = i_rank[i_code[order]]
    # a running max within each partition: a later partition's ranks
    # lifted above every earlier one's
    run = np.maximum.accumulate(rank + seg * len(i_words)) \
        - seg * len(i_words)
    key = (fo * (len(m_words) + 1) + prev + 1) * len(i_words) + run
    uniq, counts = np.unique(key, return_counts=True)
    by_rank = np.array(sorted(i_words), dtype=object)
    m_names = np.concatenate([np.array(["none"], dtype=object), m_words])
    out["c_window"] = sorted_rows([
        {"l_returnflag": f_words[k // len(i_words) // (len(m_words) + 1)],
         "prev_mode": m_names[k // len(i_words) % (len(m_words) + 1)],
         "max_i": by_rank[k % len(i_words)], "n": int(c)}
        for k, c in zip(uniq.tolist(), counts.tolist())],
        ["l_returnflag", "prev_mode", "max_i"])

    wide = text.filter(pc.invert(pc.fill_null(ascii_, True)))
    out["d_non_ascii"] = _text_rows(pc, pa, wide, {
        "concat_ws": (None, None),
        "like": (py["like"], pa.bool_()),
        "regexp_replace": (py["regexp_replace"], pa.string())})
    return out


def spark_hash(arr) -> np.ndarray:
    """Spark's ``hash`` of each row of a pyarrow string array (Murmur3
    x86_32, seed 42, over the UTF-8 bytes as ``hashUnsafeBytes``: 4-byte
    little-endian blocks, then each tail byte alone, sign-extended), by
    numpy: int64 values of the int32 hashes; a null row keeps the seed."""
    import pyarrow as pa
    arr = arr.cast(pa.large_string())
    n = len(arr)
    offs = np.frombuffer(arr.buffers()[1], np.int64)[
        arr.offset:arr.offset + n + 1]
    data = np.frombuffer(arr.buffers()[2], np.uint8) \
        if arr.buffers()[2] is not None else np.zeros(0, np.uint8)
    starts, lens = offs[:-1], offs[1:] - offs[:-1]
    u = np.uint32

    def rotl(x, r):
        return (x << u(r)) | (x >> u(32 - r))

    def mix(h, k):
        k = rotl(k * u(0xCC9E2D51), 15) * u(0x1B873593)
        return rotl(h ^ k, 13) * u(5) + u(0xE6546B64)
    h = np.full(n, 42, np.uint32)
    blocks = lens // 4
    for b in range(int(blocks.max()) if n else 0):
        rows = np.nonzero(blocks > b)[0]
        at = starts[rows] + 4 * b
        word = data[at].astype(np.uint32)
        for k in range(1, 4):
            word |= data[at + k].astype(np.uint32) << u(8 * k)
        h[rows] = mix(h[rows], word)
    for t in range(3):
        pos = blocks * 4 + t
        rows = np.nonzero(pos < lens)[0]
        byte = data[starts[rows] + pos[rows]].view(np.int8)
        h[rows] = mix(h[rows], byte.astype(np.int32).view(np.uint32))
    h ^= lens.astype(np.uint32)
    h ^= h >> u(16)
    h *= u(0x85EBCA6B)
    h ^= h >> u(13)
    h *= u(0xC2B2AE35)
    h ^= h >> u(16)
    valid = np.asarray(arr.is_valid())
    return np.where(valid, h.view(np.int32).astype(np.int64), 42)


def _with_id_columns(rows, ids) -> list:
    """The sample's rows with format_number(id * 1.25, 2) and conv(id, 10,
    16), by Python's formatting, where the query has them (after the
    integer functions)."""
    at = 2 + len(TEXT_STRING_FNS) + len(TEXT_INT_FNS)
    out = []
    for r, i in zip(rows, ids):
        r = list(r)
        out.append(tuple(r[:at] + [f"{i * 1.25:,.2f}", format(i, "X")]
                         + r[at:]))
    return out


def _java_double_text(v: np.ndarray) -> list:
    """Java's ``Double.toString`` of values in [1e-3, 1e7): the shortest
    round-trip digits, a ".0" where they have no point (what phase 13's
    prices are)."""
    check(bool(((np.abs(v) >= 1e-3) & (np.abs(v) < 1e7)).all()),
          "a price outside [1e-3, 1e7)")
    text = v.astype(str)
    return np.where(np.char.find(text, ".") >= 0, text,
                    np.char.add(text, ".0")).tolist()


def _group_rows(table, keys, specs) -> list:
    """Grouped rows of a pyarrow table as ``sorted_rows`` gives them;
    ``specs``: (output name, column, sum | min | max | count_all)."""
    import pyarrow.compute as pc
    agg = table.group_by(keys).aggregate(
        [(col, "count", pc.CountOptions(mode="all")) if how == "count_all"
         else (col, how) for _, col, how in specs])
    rows = []
    for r in agg.to_pylist():
        row = {k: r[k] for k in keys}
        for out, col, how in specs:
            row[out] = r[f"{col}_{'count' if how == 'count_all' else how}"]
        rows.append(row)
    return sorted_rows(rows, keys)


def _hop_delta(before: dict, after: dict) -> dict:
    from spark_rapids_tpu_torch.expressions.strings import host_path_counts
    b = host_path_counts(before)
    return {k: v - b.get(k, 0) for k, v in host_path_counts(after).items()
            if v - b.get(k, 0)}


def check_hops(name: str, hops: dict) -> None:
    """A query's host hops are the ones the reference's design takes."""
    if name == "d_non_ascii":
        check(bool(hops) and all(r == "non-ASCII" for _, r in hops),
              f"{name}: host hops {hops}")
        return
    want = STR_EXPECTED_HOPS[name]
    check(set(hops) == want, f"{name}: host hops {hops}, expected "
          f"{sorted(want)}")


def strings_prep(small: int, big: int, out_dir: str) -> None:
    """Phase 13's host work, in a process of its own: the port's CPU
    answers at ``small`` rows, then the tables at ``big`` rows and their
    oracles, each pickled into ``out_dir`` as it is done."""
    import os
    import pickle
    strings_cpu_answers(small, os.path.join(out_dir, "answers.pkl"))
    host = strings_host_tables(big)
    with open(os.path.join(out_dir, "tables.pkl"), "wb") as f:
        pickle.dump(host, f, protocol=5)
    oracles = strings_oracles(host)
    with open(os.path.join(out_dir, "oracles.pkl"), "wb") as f:
        pickle.dump(oracles, f, protocol=5)


class StringsPrep(CpuAnswers):
    """Phase 13's CPU answers, tables and oracles: with ``start``, made by a
    process of its own (``chip_smoke.py --strings-prep``), which main
    starts at the beginning of the run so they are ready by phase 13 (it
    runs on the host beside the card's phases); else made in this process
    when asked for."""

    def __init__(self, small: int, big: int, start: bool):
        import os
        import tempfile
        self.small, self.big = small, big
        self.dir = tempfile.mkdtemp(prefix="strings_prep_")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--strings-prep",
             str(small), str(big), self.dir]) if start else None

    def result(self):
        """(CPU answers, host tables, oracles)."""
        import os
        import pickle
        if self.proc is None:
            strings_prep(self.small, self.big, self.dir)
        else:
            check(self.proc.wait(timeout=1200) == 0,
                  "phase 13's host work failed")
        out = []
        for name in ("answers", "tables", "oracles"):
            with open(os.path.join(self.dir, f"{name}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return tuple(out)


def dfa_walks_of(q, smi) -> None:
    """The DFA walks of one collect of ``q``, measured: every call of
    ``rlike_device`` and ``match_lengths_device`` that the collect makes is
    recorded, then the same calls are replayed alone, profiled for their
    device ops (launches) and timed by CUDA events."""
    from spark_rapids_tpu_torch.kernels import regex_dfa as RD
    calls = {"rlike_device": [], "match_lengths_device": []}
    real = {k: getattr(RD, k) for k in calls}

    def recorder(kind):
        def call(*args):
            calls[kind].append(args)
            return real[kind](*args)
        return call
    try:
        for k in calls:
            setattr(RD, k, recorder(k))
        q.collect()
    finally:
        for k, f in real.items():
            setattr(RD, k, f)
    out = {}
    for kind, args in calls.items():
        if not args:
            continue

        def replay(kind=kind, args=args):
            for a in args:
                real[kind](*a)
        busy, _, ops = profile_device(replay, 1)
        out[kind] = {"walks": len(args), "steps": [a[3] for a in args],
                     "launches": ops, "busy_ms": busy,
                     "ms": time_ms(replay, 3, reps=3, warmup=1)}
    del calls
    print(json.dumps({"dfa_walks_b_text_collect": out, "card": smi}),
          flush=True)


def dfa_walk_ms(t, smi) -> None:
    """The DFA walk alone (``kernels/regex_dfa.rlike_device``) by CUDA
    events over the card's columns: l_shipinstruct and the text's ASCII
    rows, with its step count (the longest row) and launches a walk (its
    device ops, profiled)."""
    from spark_rapids_tpu_torch.columnar.vector import TorchColumnVector
    from spark_rapids_tpu_torch.kernels import regex_dfa as RD
    from spark_rapids_tpu_torch.kernels.strings import string_stats
    from spark_rapids_tpu_torch.types import StringT
    out = {}
    for key, (hs, pat) in t.items():
        col = TorchColumnVector.from_strings(StringT, hs.offsets, hs.chars,
                                             device="cuda")
        dfa = RD.compile_dfa(pat)
        ascii_, steps = string_stats(col)
        check(ascii_ or dfa.ascii_atoms, f"{key}: the walk's input")
        RD.rlike_device(col.data, col.offsets, dfa, steps)  # warm
        ms = time_ms(lambda: RD.rlike_device(col.data, col.offsets, dfa,
                                             steps), 5, reps=3, warmup=1)
        _, _, ops = profile_device(lambda: RD.rlike_device(
            col.data, col.offsets, dfa, steps), 1, warm=False)
        out[key] = {"rows": len(hs), "bytes": int(hs.offsets[-1]),
                    "pattern": pat, "dfa_states": int(dfa.table.shape[0]),
                    "steps": steps, "ms": ms, "ms_per_step": ms / steps,
                    "launches": ops, "launches_per_step": ops / steps}
    print(json.dumps({"dfa_walk": out, "card": smi}), flush=True)


def strings_paths(F, TorchSession, smi, device: str = "cuda",
                  small: int = STR_SMALL, big: int = STR_BIG,
                  prep: "StringsPrep" = None) -> None:
    """Phase 13. With ``device="cpu"`` it checks the script's oracles and
    compares off the card at the sizes given (no timing lines)."""
    from spark_rapids_tpu_torch.datagen import tpch_frames
    from spark_rapids_tpu_torch.window import Window
    on_card = device == "cuda"
    t0 = time.perf_counter()

    # the card (or this process) at `small` rows against the port on the
    # CPU over the same tables
    own = prep is None
    if own:
        prep = StringsPrep(small, big, start=on_card)
    try:
        s = TorchSession({}, device=device)
        t = tpch_frames(s, strings_host_tables(small))
        mine = {name: sorted_rows(q.collect(), keys) for name, (q, keys)
                in strings_queries(F, Window, t).items()}
        del t, s
        t1 = time.perf_counter()
        cpu, host, oracles = prep.result()
    finally:
        if own:
            prep.close()
    for name, rows in mine.items():
        check(bool(rows), f"{name} at {small}: no rows")
        check(rows == cpu[name], f"{name} at {small}: the card and the CPU "
              f"differ: {_first_difference(rows, cpu[name])}")
    print(f"(13) all {len(mine)} queries at {small} rows on {device} equal "
          "the port's CPU answers", flush=True)
    if on_card:
        release_plans()
    print(f"phase 13 waited {time.perf_counter() - t1:.1f} s for its "
          "CPU answers, 2^22-row tables and oracles; text bytes "
          f"{int(host['text'][0]['s'].offsets[-1])}", flush=True)
    s = TorchSession({"spark.rapids.sql.test.enabled": "true"},
                     device=device)
    wide = TorchSession({}, device=device)  # (d): the host hop, off test mode
    t = tpch_frames(s, host)
    tw = {"text": tpch_frames(wide, {"text": host["text"]})["text"],
          "lineitem": t["lineitem"], "customer": t["customer"]}
    queries = strings_queries(F, Window, t)
    queries["d_non_ascii"] = strings_queries(F, Window, tw)["d_non_ascii"]
    for name, (q, keys) in queries.items():
        sess = wide if name == "d_non_ascii" else s
        before = dict(sess.counters)
        c0 = time.perf_counter()
        runs: list = []
        if on_card:
            busy_ms, per_op, ops = profile_device(
                lambda: runs.append(q.collect()), 1, warm=False)
        else:
            runs.append(q.collect())
        first = time.perf_counter() - c0
        hops = _hop_delta(before, dict(sess.counters))
        got = sorted_rows(runs[0], keys)
        check(got == oracles[name], f"{name} at {big}: differs from the "
              f"oracle: {_first_difference(got, oracles[name])}")
        check_hops(name, hops)
        c0 = time.perf_counter()
        again = q.collect()
        best = time.perf_counter() - c0
        check(again == runs[0], f"{name} at {big}: two collects differ")
        # the rows its functions see: a grouped query's count column, a
        # query of rows its result
        seen = sum(r["n"] for r in runs[0]) \
            if runs[0] and "n" in runs[0][0] else len(got)
        line = {"table_rows": big, "rows": seen, "result_rows": len(got),
                "first_collect_s": first, "best_collect_s": best,
                "host_path": {f"{c}.{r}": n for (c, r), n in hops.items()}}
        if on_card:
            line.update({
                "device_busy_ms": busy_ms,
                "htod_ms": sum(ms for k, ms in per_op if "HtoD" in k),
                "idle_share": 1.0 - busy_ms / (best * 1e3),
                "device_ops": ops,
                "top_device_ops_ms": [(k[:60], ms) for k, ms in per_op[:3]]})
        print(json.dumps({f"strings_{name}": line, "card": smi}), flush=True)
        if on_card and name == "b_text":
            dfa_walks_of(q, smi)
    print(f"(13) all {len(queries)} queries at {big} rows on {device}: "
          "oracles equal, two collects identical, host hops as designed, "
          "(a)-(c) in test mode", flush=True)
    del t, tw, s, wide, queries
    if on_card:
        li = host["lineitem"][0]["l_shipinstruct"]
        dfa_walk_ms({"l_shipinstruct": (li, RX_INSTRUCT),
                     "text": (_ascii_strings(host["text"][0]["s"]),
                              RX_TEXT)}, smi)
    print(f"phase 13: {time.perf_counter() - t0:.1f} s", flush=True)


def _ascii_strings(hs):
    """The rows of a host string column whose bytes are all ASCII."""
    from spark_rapids_tpu_torch.datagen import _keep_rows
    offs = hs.offsets.astype(np.int64)
    wide = np.concatenate([[0], np.cumsum(hs.chars >= 0x80)])
    return _keep_rows(hs, wide[offs[1:]] == wide[offs[:-1]])


# ---------------------------------------------------------------------------
# phase 14: fallback on the card (the host engine)
# ---------------------------------------------------------------------------

#: host leaves every plan may keep (no device rule: they feed the upload)
HOST_LEAVES = {"CpuLocalTableScanExec"}
TRANSITIONS = {"HostToDeviceExec", "DeviceToHostExec"}


def plan_nodes(plan: str) -> list:
    """(depth, on the card, node name, parent index) of each line of
    explain()'s physical plan."""
    tree = plan.split("== Physical Plan ==")[-1]
    out, stack = [], []
    for ln in tree.splitlines():
        body = ln.lstrip(" ")
        if not body or ln.startswith("planCache"):
            continue
        dev = body.startswith("* ")
        pos = len(ln) - len(body)
        depth = pos // 2 if dev else (pos - 2) // 2
        name = (body[2:] if dev else body).split("[")[0].strip()
        while stack and stack[-1][0] >= depth:
            stack.pop()
        out.append((depth, dev, name, stack[-1][1] if stack else None))
        stack.append((depth, len(out) - 1))
    return out


def check_host_edges(plan: str, what: str) -> int:
    """Every host-engine operator in a mixed plan sits between
    transitions: its parent is the root, a HostToDeviceExec or another
    host operator, each child a DeviceToHostExec, a host operator or a
    host leaf. Returns the number of host-engine operators."""
    nodes = plan_nodes(plan)
    host = [i for i, (_, dev, name, _) in enumerate(nodes)
            if not dev and name not in TRANSITIONS | HOST_LEAVES]
    for i in host:
        parent = nodes[i][3]
        if parent is not None:
            check(not nodes[parent][1]
                  or nodes[parent][2] == "HostToDeviceExec",
                  f"{what}: {nodes[i][2]} under {nodes[parent][2]} "
                  "without an upload")
        for j, (_, dev, name, p) in enumerate(nodes):
            if p == i:
                check(not dev, f"{what}: {nodes[i][2]} over device node "
                      f"{name} without a download")
    return len(host)


def fallback_classes(reasons: str) -> set:
    """The operators explain_fallback() keeps off the card, host leaves
    aside."""
    return {ln.split()[1] for ln in reasons.splitlines()
            if ln.startswith("!Exec ")} - HOST_LEAVES


def _row_key(r):
    return tuple((k, v) for k, v in r.items() if not isinstance(v, float))


def check_same_rows(got, want, ordered: bool, what: str) -> None:
    """Integers, strings and nulls exact, floats within RTOL_FRAMEWORK;
    in order where the query orders its rows."""
    check(len(got) == len(want), f"{what}: {len(got)} rows, want "
          f"{len(want)}")
    if not ordered:
        got, want = sorted(got, key=repr_key), sorted(want, key=repr_key)
    for g, w in zip(got, want):
        check(list(g) == list(w), f"{what}: columns {list(g)}")
        for k, v in w.items():
            x = g[k]
            if isinstance(v, float) and isinstance(x, float):
                check(x == v or abs(x - v) <= RTOL_FRAMEWORK * abs(v)
                      or (x != x and v != v), f"{what}: {k} {x!r} != {v!r}")
            else:
                check(x == v, f"{what}: {k} {x!r} != {v!r} in {g}")


def repr_key(r) -> str:
    return repr(_row_key(r))


def tpch_checks(host: dict, rest: dict) -> dict:
    """A check of each of the 22 queries' rows against the numpy oracles
    of phases 6-8 and 10 over ``host``."""
    cols = datagen_q1_cols(host["lineitem"][0])
    q1 = framework_oracle(cols)
    q6 = q6_oracle(cols)
    _, q3_top = q3_oracle(host)
    q4, q13, q18 = q4_oracle(host), q13_oracle(host), q18_oracle(host)[1]

    def check_q1(rows, what):
        check_framework_rows(rows, q1)
        keys = [(r["l_returnflag"], r["l_linestatus"]) for r in rows]
        check(keys == sorted(keys), f"{what}: rows out of key order")

    def pairs(keys, want):
        return lambda rows, what: check(
            [(r[keys[0]], r[keys[1]]) for r in rows] == want,
            f"{what}: {rows[:3]} vs {want[:3]}")
    out = {"q1": check_q1,
           "q3": lambda rows, what: check_q3_rows(rows, q3_top, what),
           "q4": pairs(("o_orderpriority", "order_count"), q4),
           "q6": lambda rows, what: check_close(rows[0]["revenue"], q6,
                                                what),
           "q13": pairs(("c_count", "custdist"), q13),
           "q18": lambda rows, what: check_q18(rows, q18, what)}
    for name in REST_QUERIES:
        out[name] = lambda rows, what, n=name: check_rest(rows, rest[n],
                                                          what)
    return out


def host_engine_tpch(F, TorchSession, smi, host, checks, device,
                     rows: int) -> None:
    """(14a) The 22 TPC-H queries with every operator in the host engine."""
    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch.datagen import tpch_frames
    s = TorchSession({"spark.rapids.shuffle.mode": "ICI",
                      "spark.sql.shuffle.partitions": "8",
                      "spark.rapids.sql.enabled": "false"}, device=device)
    t = tpch_frames(s, host)
    total = 0.0
    for name in sorted(tpch.QUERIES, key=lambda q: int(q[1:])):
        q = tpch.QUERIES[name](t)
        nodes = plan_nodes(quiet_plan(q))
        check(not any(dev for _, dev, _, _ in nodes),
              f"(14a) {name}: a device node with the SQL engine off")
        before = dict(s.counters)
        c0 = time.perf_counter()
        got = q.collect()
        took = time.perf_counter() - c0
        total += took
        checks[name](got, f"(14a) {name} host engine {rows}")
        op = {k[len("opTime."):]: v - before.get(k, 0)
              for k, v in s.counters.items()
              if k.startswith("opTime.") and v != before.get(k, 0)}
        print(json.dumps({f"host_engine_{name}": {
            "rows": rows, "result_rows": len(got), "collect_s": took,
            "op_time_ms": op}, "card": smi}), flush=True)
    print(f"(14a) all {len(tpch.QUERIES)} TPC-H queries at {rows} rows in "
          f"the host engine equal their oracles; plans hold no device "
          f"node; {total:.1f} s of collects", flush=True)
    del t, s


def fallback_case(TorchSession, smi, case: str, base: dict, switch: dict,
                  make, expect: set, check_rows, ordered: bool,
                  on_card: bool, rows: int, device: str,
                  shared: dict = None) -> None:
    """(14b) and (c) for one switch: the all-card answer (held to its
    oracle), the switched-off plan (its reason, transitions at each edge
    of the host operator), the same rows, and best of 2 warm collects of
    each with the host engine's opTime and the transitions' ms. Cases of
    one query and conf share their all-card run through ``shared``."""
    def best_of_2(s, q):
        best, delta = float("inf"), {}
        for _ in range(2):
            before = dict(s.counters)
            c0 = time.perf_counter()
            q.collect()
            took = time.perf_counter() - c0
            if took < best:
                best = took
                delta = {k[len("opTime."):]: v - before.get(k, 0)
                         for k, v in s.counters.items()
                         if k.startswith("opTime.")
                         and v != before.get(k, 0)}
        return best, delta

    shared = {} if shared is None else shared
    if "want" not in shared:
        card = TorchSession(dict(base), device=device)
        qc = make(card)
        shared["want"] = qc.collect()
        check_rows(shared["want"], f"(14b) {case} all on the card")
        shared["card_s"] = best_of_2(card, qc)[0]
        del qc, card
    want, card_s = shared["want"], shared["card_s"]
    off = TorchSession(dict(base, **switch), device=device)
    qo = make(off)
    reasons = qo.explain_fallback()
    named = fallback_classes(reasons)
    check(named == expect and all(k in reasons for k in switch),
          f"(14b) {case}: explain_fallback() names "
        f"{sorted(named)}, want {sorted(expect)}:\n{reasons}")
    n_host = check_host_edges(quiet_plan(qo), f"(14b) {case}")
    check(n_host > 0, f"(14b) {case}: no host operator in the plan")
    got = qo.collect()
    check_same_rows(got, want, ordered, f"(14b) {case}")
    print(f"(14b) {case} at {rows} ok: {len(got)} rows equal the all-card "
          f"answer; {n_host} host operator(s) between transitions",
          flush=True)
    off_s, op = best_of_2(off, qo)
    print(json.dumps({f"fallback_{case}": {
        "rows": rows, "switch": switch, "host_ops": sorted(expect),
        "card_best_s": card_s, "fallback_best_s": off_s,
        "host_op_time_ms": {k: v for k, v in op.items()
                            if k.startswith("Cpu")},
        "download_ms": op.get("DeviceToHostExec", 0.0),
        "upload_ms": op.get("HostToDeviceExec", 0.0)}, "card": smi}),
        flush=True)
    del qo, off
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def fallback_paths(F, TorchSession, smi, tables: dict, keep: dict = None,
                   device: str = "cuda", rows: int = 1 << 22,
                   ds_rows: int = TPCDS_BIG, cast_rows: int = 1 << 20,
                   small_joins: bool = False) -> None:
    """Phase 14. ``tables`` holds phase 10's TPC-H host tables, ``keep``
    phase 12's TPC-DS tables and oracles and phase 13's string tables
    (each built here when missing); the cast switches run over a lineitem
    of ``cast_rows`` (the string casts take the host hop on the card too).
    With ``device="cpu"`` and small sizes
    it rehearses the phase off the card (``small_joins``: a broadcast
    threshold that gives the joins their 2^22 shapes)."""
    import os
    import tempfile

    from spark_rapids_tpu_torch import tpcds, tpch
    from spark_rapids_tpu_torch.datagen import (TPCH_TABLES,
                                                tpcds_host_tables,
                                                tpch_frames)
    from spark_rapids_tpu_torch.window import Window
    keep = {} if keep is None else keep
    on_card = device == "cuda"
    t0 = time.perf_counter()
    host = tpch_host(tables, rows, 4, TPCH_TABLES)
    rest = keep.get("rest_oracles") or rest_oracles(
        {k: v[0] for k, v in host.items()})
    checks = tpch_checks(host, rest)
    print(f"phase 14 TPC-H oracles {time.perf_counter() - t0:.1f} s",
          flush=True)

    # (a) the 22 TPC-H queries, every operator on the host
    host_engine_tpch(F, TorchSession, smi, host, checks, device, rows)

    # (b) + (c) one exec switch (or expression, or cast) off at a time
    base = {"spark.rapids.shuffle.mode": "ICI",
            "spark.sql.shuffle.partitions": "8"}
    joins = {"spark.sql.autoBroadcastJoinThreshold": "100000"} \
        if small_joins else {}
    general = {"spark.rapids.tpu.agg.compiledStage.enabled": "false"}
    no_stage = {"spark.rapids.tpu.join.compiledStage.enabled": "false"}
    cached = {"spark.rapids.sql.batchSizeRows": str(rows)}

    makers: dict = {}

    def tq(name, cache=False):
        def make(s):
            t = tpch_frames(s, host)
            if cache:
                t["lineitem"] = t["lineitem"].device_cache()
            return tpch.QUERIES[name](t)
        return makers.setdefault((name, cache), make)

    def limit_make(s):
        return limit_query(F, tpch_frames(s, host))

    def off(name):
        return {f"spark.rapids.sql.exec.{name}": "false"}
    cases = [
        ("FilterExec", base, off("FilterExec"), tq("q6"), {"CpuFilterExec"},
         checks["q6"], False),
        ("ProjectExec", base, off("ProjectExec"), tq("q6"),
         {"CpuProjectExec"}, checks["q6"], False),
        ("HashAggregateExec", dict(base, **general),
         off("HashAggregateExec"), tq("q1"), {"CpuHashAggregateExec"},
         checks["q1"], True),
        ("SortExec", dict(base, **general), off("SortExec"), tq("q1"),
         {"CpuSortExec"}, checks["q1"], True),
        ("TakeOrderedAndProjectExec", dict(base, **no_stage, **joins),
         off("TakeOrderedAndProjectExec"), tq("q3"), {"CpuTopNExec"},
         checks["q3"], True),
        ("BroadcastHashJoinExec", dict(base, **no_stage, **joins),
         off("BroadcastHashJoinExec"), tq("q3"),
         {"CpuBroadcastHashJoinExec"}, checks["q3"], True),
        ("ShuffledHashJoinExec", dict(base, **joins),
         off("ShuffledHashJoinExec"), tq("q4"),
         {"CpuShuffledHashJoinExec"}, checks["q4"], True),
        ("ShuffleExchangeExec", dict(base, **joins),
         off("ShuffleExchangeExec"), tq("q4"), {"CpuShuffleExchangeExec"},
         checks["q4"], True),
        ("BroadcastNestedLoopJoinExec", base,
         off("BroadcastNestedLoopJoinExec"), tq("q22"),
         {"CpuBroadcastNestedLoopJoinExec"}, checks["q22"], True),
        ("LocalLimitExec", base, off("LocalLimitExec"), limit_make,
         {"CpuLocalLimitExec"}, limit_check(host), True),
        ("GlobalLimitExec", base, off("GlobalLimitExec"), limit_make,
         {"CpuGlobalLimitExec"}, limit_check(host), True),
        ("InMemoryTableScanExec", dict(base, **cached),
         off("InMemoryTableScanExec"), tq("q1", cache=True),
         {"CpuDeviceScanExec"}, checks["q1"], True),
        ("Multiply", base, {"spark.rapids.sql.expression.Multiply": "false"},
         tq("q1"), {"CpuProjectExec"}, checks["q1"], True),
    ]
    if not small_joins:  # q15's cross join plans a cartesian product at
        # 2^22 (its right side past the broadcast threshold)
        cases.append(("CartesianProductExec", base,
                      off("CartesianProductExec"), tq("q15"),
                      {"CpuCartesianProductExec"}, checks["q15"], True))
    else:
        cases.append(("CartesianProductExec",
                      dict(base, **{"spark.sql.autoBroadcastJoinThreshold":
                                    "1"}),
                      off("CartesianProductExec"), tq("q15"),
                      {"CpuCartesianProductExec"}, checks["q15"], True))
    shared: dict = {}
    for case in cases:
        # cases over one query and conf share the all-card run
        key = (case[3], repr(sorted(case[1].items())))
        fallback_case(TorchSession, smi, case[0], *case[1:],
                      on_card=on_card, rows=rows, device=device,
                      shared=shared.setdefault(key, {}))
    if on_card:
        release_plans()

    # the file scan: Q1 over a parquet file of the datagen's lineitem shape
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fallback_") as d:
        path = os.path.join(d, "lineitem.parquet")
        cols = write_lineitem(path, rows, min(rows, 1 << 21),
                              min(rows, 1 << 20))
        q1_file = framework_oracle(q1_oracle_cols(cols))
        del cols
        fallback_case(TorchSession, smi, "FileSourceScanExec", {},
                      off("FileSourceScanExec"),
                      lambda s: framework_query(F, s.read.parquet(path)),
                      {"CpuFileScanExec"},
                      lambda r, w: check_framework_rows(r, q1_file), False,
                      on_card=on_card, rows=rows, device=device)
    if on_card:
        release_plans()

    # TPC-DS: union (q38), Expand (q22's rollup), the window exec (q98)
    ds = keep.get("tpcds")
    if ds is None:
        ds_host = tpcds_host_tables(ds_rows, 4)
        ds = (ds_host, tpcds_oracles(ds_host))
    ds_host, ds_oracles = ds
    ds_base = {"spark.rapids.shuffle.mode": "ICI",
               "spark.sql.shuffle.partitions": "4"}
    for exec_name, query, cls in (("UnionExec", "q38", "CpuUnionExec"),
                                  ("ExpandExec", "q22", "CpuExpandExec"),
                                  ("WindowExec", "q98", "CpuWindowExec")):
        fallback_case(
            TorchSession, smi, exec_name, ds_base, off(exec_name),
            lambda s, q=query: tpcds.QUERIES[q](s, tpch_frames(s, ds_host)),
            {cls}, lambda r, w, q=query: check_tpcds_oracle(
                r, ds_oracles[q], w), True, on_card=on_card, rows=ds_rows,
            device=device)
    del ds, ds_host
    if on_card:
        release_plans()

    # the restored cast switches on phase 13's a_casts (its oracle is
    # phase 13's; here the all-card answer is the reference the host
    # engine's is held to)
    shost = strings_host_tables(cast_rows, text_rows=16)
    a_casts = a_casts_oracle(shost)

    def casts(s):
        return strings_queries(F, Window, tpch_frames(s, shost))["a_casts"][0]

    def check_casts(r, what):
        check(sorted_rows(r, ["l_shipmode"]) == a_casts,
              f"{what}: differs from the oracle")
    shared = {}
    for switch in ("castFloatToString", "castStringToFloat"):
        fallback_case(TorchSession, smi, switch, {},
                      {f"spark.rapids.sql.{switch}.enabled": "false"}, casts,
                      {"CpuHashAggregateExec"}, check_casts, False,
                      on_card=on_card, rows=cast_rows, device=device,
                      shared=shared)
    ts_want = timestamp_oracle(shost["lineitem"][0])
    fallback_case(TorchSession, smi, "castStringToTimestamp", {},
                  {"spark.rapids.sql.castStringToTimestamp.enabled":
                   "false"},
                  lambda s: timestamp_query(F, tpch_frames(s, shost)),
                  {"CpuHashAggregateExec"},
                  lambda r, w: check(sorted_rows(r, ["l_shipmode"])
                                     == ts_want, f"{w}: {r[:2]}"), False,
                  on_card=on_card, rows=cast_rows, device=device)
    print(f"phase 14: {time.perf_counter() - t0:.1f} s", flush=True)


def limit_query(F, t):
    """A limit without an order: the first 1,000 lineitem rows (in
    partition order) with l_quantity under 3."""
    return t["lineitem"].filter(F.col("l_quantity") < 3).select(
        "l_orderkey", "l_partkey", "l_extendedprice").limit(1000)


def limit_check(host):
    li = host["lineitem"][0]
    keep = np.flatnonzero(li["l_quantity"] < 3)[:1000]
    want = [(int(li["l_orderkey"][i]), int(li["l_partkey"][i]),
             float(li["l_extendedprice"][i])) for i in keep]
    return lambda rows, what: check(
        [(r["l_orderkey"], r["l_partkey"], r["l_extendedprice"])
         for r in rows] == want, f"{what}: {rows[:2]} vs {want[:2]}")


def timestamp_query(F, t):
    """The string → timestamp cast: each ship mode's latest ship date of
    the rows with l_quantity under 5, read back as a timestamp."""
    ts = F.col("l_shipdate").cast("string").cast("timestamp").cast("string")
    return t["lineitem"].filter(F.col("l_quantity") < 5).groupBy(
        "l_shipmode").agg(F.max(ts).alias("latest"),
                          F.count("*").alias("n"))


def timestamp_oracle(li) -> list:
    modes = np.array(host_strings(li["l_shipmode"]))
    days = _days(li["l_shipdate"])
    small = li["l_quantity"] < 5
    out = []
    for m in sorted(set(modes[small].tolist())):
        sel = (modes == m) & small
        d = int(days[sel].max())
        out.append((m, str(np.datetime64(d, "D")) + " 00:00:00",
                    int(sel.sum())))
    return out


# ---------------------------------------------------------------------------
# phase 15: observability on the card — the traced bundle, hot_repeat's
# planning share, the tracer's price, the sync ledger against the syncs it
# does not see, the profiler
# ---------------------------------------------------------------------------


def flat_spans(span, acc=None) -> list:
    acc = [] if acc is None else acc
    acc.append(span)
    for c in span["children"]:
        flat_spans(c, acc)
    return acc


def root_output_rows(profile) -> int:
    """numOutputRows of the plan's topmost operator that counts its output
    (the result download, as in the reference, does not)."""
    return next(v["numOutputRows"][0] for v in profile["metrics"].values()
                if "numOutputRows" in v)


def check_bundle(key: str, p, want_rows: int, n_parts: int,
                 row_groups: int = 0) -> None:
    """(15a)'s checks of one traced collect's bundle."""
    rec = p["reconcile"]
    check(not rec["overflow"] and rec["dispatch_ok"] and rec["sync_ok"],
          f"{key}: the bundle does not reconcile: {rec}")
    root = p["spans"]
    top = [(c["name"], c["cat"]) for c in root["children"]]
    check(top == [("plan.build", "plan")]
          + [(f"partition {i}", "task") for i in range(n_parts)],
          f"{key}: query span's children {top}")
    for part in root["children"][1:]:
        check(part["children"] and all(c["cat"] == "op"
                                       for c in part["children"]),
              f"{key}: {part['name']} holds no operator spans")
    decodes = [sp for sp in flat_spans(root) if sp["name"] == "scan.decode"]
    check(len(decodes) == row_groups,
          f"{key}: {len(decodes)} scan.decode spans, {row_groups} row groups")
    got = root_output_rows(p)
    check(got == want_rows, f"{key}: root numOutputRows {got} != {want_rows}")
    with open(p["artifacts"]["chrome_trace"]) as f:
        trace = json.load(f)
    check(len(trace["traceEvents"]) > 0, f"{key}: empty Chrome trace")


def best_collect_s(q, n: int = 2) -> float:
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        q.collect()
        best = min(best, time.perf_counter() - t0)
    return best


def set_trace(session, on: bool, trace_dir: str = None,
              tag: str = None) -> None:
    session.conf.set("spark.rapids.tpu.trace.enabled", str(on).lower())
    if trace_dir:
        session.conf.set("spark.rapids.tpu.trace.dir", trace_dir)
    if tag:
        session.conf.set("spark.rapids.tpu.trace.tag", tag)


def gate_lines() -> set:
    """(file, line) of every line of the audited sync gate."""
    import inspect
    import os

    from spark_rapids_tpu_torch.columnar import vector
    from spark_rapids_tpu_torch.execs import compiled_join
    out = set()
    for fn in (vector.audited_device_get, vector.audited_sync_int,
               vector.audited_tolist, compiled_join._to_host):
        lines, start = inspect.getsourcelines(fn)
        f = os.path.realpath(inspect.getsourcefile(fn))
        out.update((f, n) for n in range(start, start + len(lines)))
    return out


def sync_audit(key: str, q, s, smi) -> None:
    """(15d) One collect under torch.cuda.set_sync_debug_mode("warn"):
    every synchronizing call torch reports, beside the SyncLedger's total
    for the query; the Python lines of the ones outside the audited gate
    (boolean-mask indexing, nonzero, unique, ...). Printed, not checked."""
    import collections
    import os
    import warnings
    gate = gate_lines()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            q.collect()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    hidden = collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in syncs
        if (os.path.realpath(w.filename), w.lineno) not in gate)
    ledger = sum(sum(k.values()) for k in s.last_sync_ledger().values())
    print(json.dumps({f"sync_audit_{key}": {
        "sync_calls": len(syncs),
        "gate_calls": len(syncs) - sum(hidden.values()),
        "ledger_total": ledger, "ledger": s.last_sync_ledger(),
        "hidden_calls": sum(hidden.values()),
        "top_hidden_lines": hidden.most_common(12)}, "card": smi}),
        flush=True)


def obs_paths(F, TorchSession, smi, tables, df, cols, oracle, scan,
              device: str = "cuda", mid: int = 1 << 22) -> None:
    """Phase 15: (a)-(e). ``df`` is phase 4's cached lineitem (``cols``,
    its framework ``oracle``), ``tables`` holds phase 7's 2^22-row
    tables, ``scan`` is phase 9's file (dir, path, scan_agg oracle, row
    groups). With ``device="cpu"`` and small sizes it checks the script's
    own logic off the card (no sync audit, a host-only profile)."""
    import os
    import tempfile

    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch.datagen import q3_frames, tpch_frames
    from spark_rapids_tpu_torch.serving.bench import (SEGMENTS, q3_variant,
                                                      q6_variant,
                                                      run_repeated)
    from spark_rapids_tpu_torch.serving.scheduler import QueryScheduler
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_phase = time.perf_counter()
    _scan_dir, scan_path, agg_oracle, n_rg = scan
    host = tpch_host(tables, mid, 4)
    q3_top = q3_oracle(host)[1]
    base = {"spark.rapids.shuffle.mode": "ICI",
            "spark.sql.shuffle.partitions": "8"}
    g = TorchSession(dict(base, **{
        "spark.rapids.tpu.join.compiledStage.enabled": "false"}),
        device=device)
    sc = TorchSession({}, device=device)
    queries = {
        "framework_q1": (df.session, framework_query(F, df), len(oracle),
                         lambda r: check_framework_rows(r, oracle), 0),
        "q3_general": (g, tpch.q3(q3_frames(g, host)), len(q3_top),
                       lambda r: check_q3_rows(r, q3_top, "q3 traced"), 0),
        "scan_agg": (sc, scan_agg_query(F, sc.read.parquet(scan_path)),
                     len(agg_oracle),
                     lambda r: check_scan_agg(r, agg_oracle, "scan traced"),
                     n_rg)}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tdir:
        # (a) traced queries against untraced collects and the oracles;
        # (c) the tracer's price, best of 2 warm collects each way
        for key, (s, q, want, check_rows, rgs) in queries.items():
            set_trace(s, False)
            plain_rows = q.collect()
            untraced_s = best_collect_s(q) if key != "scan_agg" else None
            set_trace(s, True, tdir, key)
            rows = q.collect()
            p = s.last_query_profile()
            check(rows == plain_rows, f"{key}: traced rows differ")
            check_rows(rows)
            n_parts = sum(1 for c in p["spans"]["children"]
                          if c["cat"] == "task")
            check(n_parts >= 1, f"{key}: no partition task span")
            check_bundle(key, p, want, n_parts, rgs)
            traced_s = best_collect_s(q) if key != "scan_agg" else None
            set_trace(s, False)
            spans = flat_spans(p["spans"])
            print(json.dumps({f"obs_traced_{key}": {
                "rows": len(rows), "spans": len(spans),
                "op_spans": sum(sp["cat"] == "op" for sp in spans),
                "event_counts": p["event_counts"],
                "dispatches_by_kind": p["dispatches_by_kind"],
                "sync_events": p["sync_events_total"],
                "duration_ms": p["duration_ms"],
                "plan_build_ms": sum(sp["dur_ns"] / 1e6 for sp in spans
                                     if sp["name"] == "plan.build"),
                "partitions": n_parts, "scan_decode_spans": rgs,
                "root_num_output_rows": root_output_rows(p),
                "reconcile": p["reconcile"],
                "trace_bytes": os.path.getsize(
                    p["artifacts"]["chrome_trace"])}, "card": smi}),
                flush=True)
            if untraced_s is not None:
                print(json.dumps({f"tracer_price_{key}": {
                    "untraced_best_s": untraced_s, "traced_best_s": traced_s,
                    "traced_over_untraced": traced_s / untraced_s,
                    "spans": len(spans)}, "card": smi}), flush=True)
        print("(a) traced framework Q1, q3 general and scan_agg ok: bundles "
              "reconcile, the span trees hold plan.build and the partition "
              "tasks, one scan.decode a row group, the root's numOutputRows "
              "equal the oracle's rows, the rows equal the untraced ones | "
              f"card: {smi}", flush=True)

        # (b) hot_repeat traced, at phase 11's shapes
        QueryScheduler.get().plan_cache.clear()
        set_trace(df.session, True, tdir, "hot_repeat_q6")
        try:
            r6 = run_repeated(df.session, lambda i: q6_variant(df, i, F), 6,
                              sync)
        finally:
            set_trace(df.session, False)
        for i, rows in enumerate(r6["rows"]):
            check_close(rows[0]["revenue"], q6_variant_oracle(cols, i),
                        f"hot_repeat traced q6 submission {i}")
        s3 = TorchSession(dict(base, **{
            "spark.rapids.sql.batchSizeRows": str(mid)}), device=device)
        set_trace(s3, True, tdir, "hot_repeat_q3")
        t = tpch_frames(s3, host, 1)
        t["lineitem"] = t["lineitem"].device_cache()
        r3 = run_repeated(s3, lambda i: q3_variant(t, i, F), 6, sync)
        top0 = q3_oracle(host, SEGMENTS[0])[1]
        for i in (0, 5):
            check_q3_rows(r3["rows"][i], top0,
                          f"hot_repeat traced q3 submission {i}")
        for key, r in (("q6", r6), ("q3_compiled", r3)):
            check("plan_ms" in r and all(ms > 0 for ms in r["plan_ms"]),
                  f"hot_repeat {key}: a bundle without a plan.build span")
            check(r["cache_by_iter"][1:] == ["hit"] * 5,
                  f"hot_repeat {key}: {r['cache_by_iter']}")
            print(json.dumps({f"hot_repeat_traced_{key}": {
                "rows": len(cols["l_shipdate"]) if key == "q6" else mid,
                "planning_share": r["planning_share"],
                "planning_share_pct": 100.0 * r["planning_share"],
                "plan_ms": r["plan_ms"], "e2e_ms": r["e2e_ms"],
                **{k: r[k] for k in ("first_ms", "steady_ms", "warm_p50_ms",
                                     "hits", "misses", "cache_by_iter")}},
                "card": smi}), flush=True)
        del t, s3
        QueryScheduler.get().plan_cache.clear()
        print("(b) hot_repeat traced ok: a plan.build span in every "
              "submission's bundle, five plan-cache hits each | "
              f"card: {smi}", flush=True)

        # (d) the sync ledger against every synchronizing call
        if on_card:
            for key in ("q3_general", "scan_agg"):
                s, q = queries[key][:2]
                sync_audit(key, q, s, smi)

        # (e) the profiler over one collect
        s, q = queries["framework_q1"][:2]
        s.conf.set("spark.rapids.profile.pathPrefix",
                   os.path.join(tdir, "profile"))
        with s.profiler() as prof:
            check_framework_rows(q.collect(), oracle)
        with open(prof.trace_path) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        check(not on_card or len(kernels) > 0,
              "the profiler's trace holds no CUDA kernel event")
        check(any(e.get("name") == "TorchCompiledAggStageExec"
                  for e in events), "no operator range in the trace")
        print(json.dumps({"profiler_trace": {
            "events": len(events), "kernel_events": len(kernels),
            "file_bytes": os.path.getsize(prof.trace_path)}, "card": smi}),
            flush=True)
    del queries, g, sc
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s | card: {smi}",
          flush=True)

# ---------------------------------------------------------------------------
# phase 16: the DataFrame and session surface on the card — range, sample,
# repartition and coalesce, the file writer, cache() and the actions
# ---------------------------------------------------------------------------

SURFACE_SEED = 16
SURFACE_RANGE = 1 << 27  # 1 GiB of int64 ids on the card
SURFACE_TEXT_ROWS = 1 << 20  # orc and csv
SURFACE_JSON_ROWS = 1 << 15  # json: written row by row, as the reference
SURFACE_Q1_ROWS = 1 << 22  # framework Q1 over cache()
_M32 = 0xFFFFFFFF


def sample_uniforms(seed: int, part: int, start: int, n: int) -> np.ndarray:
    """The sample exec's uniforms, by numpy uint32: the murmur3 finalizer
    over (seed, partition, row index in the partition) (the reference's
    ``execs/sample._uniform_np``)."""
    u = np.uint32
    h = (np.arange(start, start + n, dtype=np.int64) & _M32).astype(u)
    h ^= u((((seed & _M32) * 0x9E3779B1) & _M32)
           ^ ((part * 0x85EBCA6B) & _M32))
    h ^= h >> u(16)
    h *= u(0x85EBCA6B)
    h ^= h >> u(13)
    h *= u(0xC2B2AE35)
    h ^= h >> u(16)
    return h.astype(np.float64) / float(1 << 32)


def _poisson_cdf(lam: float) -> np.ndarray:
    import math
    p = math.exp(-lam)
    cum, out = p, [p]
    for k in range(1, max(16, int(lam + 10.0 * math.sqrt(lam) + 10.0)) + 1):
        p *= lam / k
        cum += p
        out.append(cum)
        if cum > 1.0 - 1e-12:
            break
    return np.array(out)


def local_partition_rows(n: int, parts: int) -> list:
    """createDataFrame's split of n rows into parts partitions."""
    return [n // parts + (1 if p < n % parts else 0) for p in range(parts)]


def sample_oracle(part_rows, fraction: float, replace: bool,
                  seed: int) -> np.ndarray:
    """The rows (global indices, in output order) a sample keeps."""
    out, off = [], 0
    for p, n in enumerate(part_rows):
        u = sample_uniforms(seed, p, 0, n)
        if replace:
            counts = np.searchsorted(_poisson_cdf(fraction), u, side="right")
            out.append(np.repeat(np.arange(n), counts) + off)
        else:
            out.append(np.flatnonzero(u < fraction) + off)
        off += n
    return np.concatenate(out)


def spark_hash_int(v: np.ndarray) -> np.ndarray:
    """Spark's ``hash`` of int32 values (Murmur3 x86_32 of the 4 bytes,
    seed 42), by numpy: int64 values of the int32 hashes."""
    u = np.uint32

    def rotl(x, r):
        return (x << u(r)) | (x >> u(32 - r))
    k = rotl(v.astype(np.int32).view(u) * u(0xCC9E2D51), 15) * u(0x1B873593)
    h = rotl(np.full(len(v), 42, u) ^ k, 13) * u(5) + u(0xE6546B64)
    h ^= u(4)
    h ^= h >> u(16)
    h *= u(0x85EBCA6B)
    h ^= h >> u(13)
    h *= u(0xC2B2AE35)
    h ^= h >> u(16)
    return h.view(np.int32).astype(np.int64)


def _row_codes(arrays, lows=None) -> np.ndarray:
    """Rows of equal-length non-negative integer arrays as sorted int64
    codes, each array in its own bits (a multiset of rows in one sort;
    ``lows`` gives the bit widths, so two sides pack alike)."""
    code = np.zeros(len(arrays[0]), np.int64)
    for a, bits in zip(arrays, lows or [int(np.max(a, initial=0))
                                        .bit_length() for a in arrays]):
        code = (code << np.int64(bits)) | a.astype(np.int64)
    return np.sort(code)


def _widths(arrays) -> list:
    widths = [int(np.max(a, initial=0)).bit_length() for a in arrays]
    check(sum(widths) <= 63, f"row codes need {sum(widths)} bits")
    return widths


def _letter_codes(arr, letters) -> np.ndarray:
    """A string column's values as their index in ``letters``."""
    import pyarrow as pa
    import pyarrow.compute as pc
    codes = pc.index_in(arr, value_set=pa.array(list(letters)))
    check(codes.null_count == 0, f"a value outside {letters}")
    return codes.to_numpy(zero_copy_only=False).astype(np.int64)


def _dir_stats(d: str):
    import os
    files = [os.path.join(r, f) for r, _, fs in os.walk(d) for f in fs
             if not f.startswith("_")]
    return files, sum(os.path.getsize(f) for f in files)


def _write_metrics(s) -> dict:
    m = s.last_query_metrics("DEBUG")
    key = [k for k in m if k.endswith("TorchDataWritingCommandExec")]
    check(len(key) == 1, f"the write plan holds no device write: {list(m)}")
    return m[key[0]]


def surface_paths(F, TorchSession, smi, li, tmpdir: str,
                  device: str = "cuda", range_rows: int = SURFACE_RANGE,
                  text_rows: int = SURFACE_TEXT_ROWS,
                  json_rows: int = SURFACE_JSON_ROWS,
                  q1_rows: int = SURFACE_Q1_ROWS) -> None:
    """Phase 16: (a)-(e) in test mode. ``li`` is phase 10's datagen
    lineitem (host columns, validity, partitions). With ``device="cpu"``
    and small sizes it checks the script's own logic off the card."""
    import os

    import pyarrow as pa
    import pyarrow.csv as pacsv
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch.columnar.batch import TorchColumnarBatch
    from spark_rapids_tpu_torch.serving.scheduler import QueryScheduler
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_phase = time.perf_counter()
    base = {"spark.rapids.shuffle.mode": "ICI",
            "spark.sql.shuffle.partitions": "8"}
    s = TorchSession(dict(base, **{"spark.rapids.sql.test.enabled": "true"}),
                     device=device)
    # the port's host engine: "the port's CPU answer"
    h = TorchSession(dict(base, **{"spark.rapids.sql.enabled": "false"}),
                     device=device)
    state0 = runtime_state(on_card)
    ms: dict = {}

    def timed(key, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        ms[key] = (time.perf_counter() - t0) * 1e3
        return out

    # (a) range: 1 GiB of ids on the card, a filter, sum and count
    r = s.range(0, range_rows, 1, numPartitions=4)
    lo, hi = range_rows // 5, range_rows // 5 * 4
    q = r.filter((F.col("id") >= lo) & (F.col("id") < hi)).agg(
        F.sum("id").alias("s"), F.count("id").alias("c"))
    check("TorchRange" in quiet_plan(q), "range plan lacks TorchRange")
    rows = timed("range_filter_sum", q.collect)
    check(rows == [{"s": (lo + hi - 1) * (hi - lo) // 2, "c": hi - lo}],
          f"range sum/count {rows}")
    check(timed("range_count", r.count) == range_rows, "range count")
    print(f"(16a) range at {range_rows} rows ok: filtered sum and count "
          "equal the closed form", flush=True)

    # (b) sample: the rows of a numpy oracle of the same hash, and the
    # host engine's
    cols, valid, parts = li
    n = len(cols["l_orderkey"])
    keys = ["l_orderkey", "l_partkey", "l_quantity"]
    df = s.createDataFrame(cols, num_partitions=parts, validity=valid)
    hdf = h.createDataFrame(cols, num_partitions=parts, validity=valid)
    for replace, frac in ((False, 0.1), (True, 0.5)):
        tag = f"sample_{'replace' if replace else 'bernoulli'}"
        q = df.select(*keys).sample(replace, frac, SURFACE_SEED)
        check("TorchSample" in quiet_plan(q), f"{tag}: no TorchSample")
        got = timed(tag, q.to_arrow)
        idx = sample_oracle(local_partition_rows(n, parts), frac, replace,
                            SURFACE_SEED)
        for k in keys:
            check(np.array_equal(got.column(k).to_numpy(), cols[k][idx]),
                  f"{tag}: {k} differs from the oracle")
        cpu = hdf.select(*keys).sample(replace, frac, SURFACE_SEED) \
            .to_arrow()
        check(cpu.equals(got), f"{tag}: the host engine's rows differ")
        print(f"(16b) {tag} at {n} rows ok: {got.num_rows} rows equal the "
              "numpy oracle and the host engine's", flush=True)

    # (c) repartition and coalesce: partition row counts as the host
    # engine's, the source's rows
    widths = _widths([cols[k] for k in keys])
    src = _row_codes([cols[k] for k in keys], widths)
    for tag, q, hq in (
            ("repartition_16", df.select(*keys).repartition(16),
             hdf.select(*keys).repartition(16)),
            ("repartition_16_key",
             df.select(*keys).repartition(16, "l_orderkey"),
             hdf.select(*keys).repartition(16, "l_orderkey")),
            ("coalesce_2", df.select(*keys).coalesce(2),
             hdf.select(*keys).coalesce(2))):
        plan = quiet_plan(q)
        want_kind = "hash" if tag.endswith("key") else (
            "coalesce" if tag.startswith("coalesce") else "roundrobin")
        check(f"TorchShuffleExchange[{want_kind}" in plan, f"{tag}: {plan}")
        parts_dev = timed(tag, q._device_partitions)
        counts = [sum(b.num_rows for b in p) for p in parts_dev]
        want = [sum(b.num_rows for b in p) for p in hq._device_partitions()]
        check(counts == want, f"{tag}: partition rows {counts} vs {want}")
        flat = [b for p in parts_dev for b in p]
        check(all(b.device.type == device for b in flat),
              f"{tag}: a batch off the {device}")
        got = _row_codes([np.concatenate([
            b.columns[i].data[:b.num_rows].cpu().numpy() for b in flat])
            for i in range(len(keys))], widths)
        check(np.array_equal(got, src), f"{tag}: rows differ from the source")
        del parts_dev, flat
        print(f"(16c) {tag} ok: partition rows {counts} equal the host "
              "engine's; the rows are the source's", flush=True)

    # (d) writes: the device batches download once, at the file boundary
    full = TorchColumnarBatch.from_numpy_columns(cols, valid).to_arrow()
    dc = s.createDataFrame(full, num_partitions=parts).device_cache()
    part_keys = keys + ["l_returnflag", "l_linestatus"]

    def write_line(fmt, d, rows_written, wall_ms, s_):
        files, nbytes = _dir_stats(d)
        m = _write_metrics(s_)
        check(m.get("numWrittenRows") == rows_written,
              f"write_{fmt}: numWrittenRows {m}")
        check(m.get("numFiles") == len(files), f"write_{fmt}: numFiles {m}")
        print(json.dumps({f"write_{fmt}": {
            "rows": rows_written, "wall_ms": wall_ms, "mb": nbytes / 1e6,
            "files": len(files), "write_time_ms": m["writeTime"] / 1e6,
            "num_written_rows": m["numWrittenRows"]}, "card": smi}),
            flush=True)

    def part_codes(t):
        return _row_codes([t.column(k).to_numpy() for k in keys]
                          + [_letter_codes(t.column("l_returnflag"), "ANR"),
                             _letter_codes(t.column("l_linestatus"), "FO")],
                          widths + [2, 1])
    want_part = part_codes(full)
    d = os.path.join(tmpdir, "parquet_partitioned")
    timed("write_parquet_partitioned", lambda: dc.write.partitionBy(
        "l_returnflag", "l_linestatus").parquet(d))
    write_line("parquet_partitioned", d, n, ms["write_parquet_partitioned"],
               s)
    back = timed("read_parquet_partitioned", lambda: s.read.parquet(d)
                 .select(*part_keys).to_arrow())
    check(np.array_equal(part_codes(back), want_part),
          "partitioned parquet read back differs")
    d = os.path.join(tmpdir, "parquet_bucketed")
    timed("write_parquet_bucketed", lambda: dc.write.bucketBy(
        8, "l_orderkey").parquet(d))
    write_line("parquet_bucketed", d, n, ms["write_parquet_bucketed"], s)
    for f in os.listdir(d):
        if f.endswith(".parquet"):
            ok = pq.read_table(os.path.join(d, f), columns=["l_orderkey"])
            ids = set(np.mod(spark_hash_int(
                ok.column(0).to_numpy()), 8).tolist())
            check(ids == {int(f.split("_")[1].split(".")[0])},
                  f"bucket file {f} holds buckets {ids}")
    back = timed("read_parquet_bucketed", lambda: s.read.parquet(d)
                 .select(*keys).to_arrow())
    check(np.array_equal(_row_codes([back.column(k).to_numpy()
                                     for k in keys], widths), src),
          "bucketed parquet read back differs")
    print("(16d) parquet partitionBy(l_returnflag, l_linestatus) and "
          "bucketBy(8, l_orderkey) ok: every bucket file's ids are Spark's; "
          "both read back (the device decode) to the source rows",
          flush=True)
    del dc
    for fmt, rows_n in (("orc", text_rows), ("csv", text_rows),
                        ("json", json_rows)):
        t = full.slice(0, rows_n)
        tdf = s.createDataFrame(t, num_partitions=2)
        d = os.path.join(tmpdir, fmt)
        timed(f"write_{fmt}", lambda: getattr(tdf.write, fmt)(d))
        write_line(fmt, d, rows_n, ms[f"write_{fmt}"], s)
        names = sorted(f for f in os.listdir(d) if not f.startswith("_"))
        check(len(names) == 2, f"{fmt}: files {names}")
        start = 0
        for name, cnt in zip(names, local_partition_rows(rows_n, 2)):
            part = t.slice(start, cnt)
            start += cnt
            if fmt == "orc":
                continue
            buf = io.BytesIO()
            if fmt == "csv":
                pacsv.write_csv(part, buf, write_options=pacsv.WriteOptions(
                    include_header=True))
                want_text = buf.getvalue()
            else:
                want_text = "".join(json.dumps(row, default=str) + "\n"
                                    for row in part.to_pylist()).encode()
            with open(os.path.join(d, name), "rb") as fh:
                check(fh.read() == want_text,
                      f"{fmt} file {name} differs from the oracle's text")
        if fmt == "orc":
            back = timed("read_orc", lambda: s.read.orc(d).to_arrow())
            check(back.equals(t.cast(back.schema)), "orc read back differs")
        elif fmt == "csv":
            back = timed("read_csv", lambda: s.read.csv(d, header=True)
                         .select(*keys).to_arrow())
            check(all(np.array_equal(back.column(k).to_numpy(),
                                     t.column(k).to_numpy())
                      for k in keys), "csv read back differs")
        else:
            back = timed("read_json", lambda: s.read.json(d).select(
                *keys).to_arrow())
            check(all(np.array_equal(back.column(k).to_numpy(),
                                     t.column(k).to_numpy())
                      for k in keys), "json read back differs")
    print(f"(16d) orc and csv at {text_rows} rows, json at {json_rows}: "
          "csv and json text equal pyarrow's and json.dumps' of the same "
          "rows; every format reads back", flush=True)

    # (e) cache() and the actions
    q1cols = lineitem(q1_rows)
    cached = timed("cache", s.createDataFrame(q1cols).cache)
    check("CpuCachedScan" in quiet_plan(cached), "no cached scan")
    oracle = framework_oracle(q1cols)
    fq = framework_query(F, cached)
    first = timed("framework_q1_cached", fq.collect)
    second = fq.collect()
    check_framework_rows(first, oracle)
    check(first == second, "two collects over cache() differ")
    dq = s.createDataFrame(q1cols).device_cache()
    a = timed("cached_to_arrow", cached.to_arrow)
    b = timed("device_cache_to_arrow", dq.to_arrow)
    check(a.equals(b), "cache() and device_cache() rows differ")
    del a, b
    check(timed("count", cached.count) == q1_rows, "count of cache()")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cached.show(5)
    lines = out.getvalue().splitlines()
    check(len(lines) == 10 and lines[-1] == "only showing top 5 rows",
          f"show(5): {lines}")
    try:
        import pandas  # noqa: F401
        has_pandas = True
    except ImportError:
        has_pandas = False
    if has_pandas:
        m = min(1 << 16, q1_rows)
        pdf = timed("to_pandas", dq.limit(m).toPandas)
        check(pdf.shape == (m, len(q1cols)), f"toPandas {pdf.shape}")
    arrays = timed("to_device_arrays", dq.select(
        "l_quantity", "l_shipdate").to_device_arrays)
    check(all(v.device.type == device for v in arrays.values()),
          "to_device_arrays: a tensor off the card")
    check(np.array_equal(arrays["l_quantity"].cpu().numpy(),
                         q1cols["l_quantity"])
          and np.array_equal(arrays["l_shipdate"].cpu().numpy(),
                             q1cols["l_shipdate"]),
          "to_device_arrays differ from the rows")
    del arrays, dq, cached, fq
    dd = df.dropDuplicates(["l_orderkey"]).select(*keys)
    check("TorchHashAggregate" in quiet_plan(dd), "dropDuplicates plan")
    got = timed("drop_duplicates", dd.to_arrow)
    uk, first_idx = np.unique(cols["l_orderkey"], return_index=True)
    order = np.argsort(got.column("l_orderkey").to_numpy(), kind="stable")
    for k in keys:
        check(np.array_equal(got.column(k).to_numpy()[order],
                             cols[k][first_idx]),
              f"dropDuplicates: {k} is not each key's first row")
    agg = df.groupBy("l_orderkey").agg(F.count("l_quantity").alias("n"))
    j = df.select("l_orderkey", "l_quantity").join(agg, "l_orderkey")
    check(j.columns == ["l_orderkey", "l_quantity", "n"],
          f"join on names: columns {j.columns}")
    got = timed("join_on_names", j.to_arrow)
    _, inv, cnt = np.unique(cols["l_orderkey"], return_inverse=True,
                            return_counts=True)
    check(got.num_rows == n and int(np.sum(got.column("n").to_numpy()))
          == int(np.sum(cnt.astype(np.int64) ** 2)), "join on names rows")
    print(f"(16e) cache() ok: framework Q1 over {q1_rows} cached rows "
          "equals the oracle twice, its rows equal device_cache()'s; "
          f"count, show(5), toPandas ({'ok' if has_pandas else 'no pandas'}"
          "), to_device_arrays on the device, dropDuplicates (First), a "
          "join on names", flush=True)
    del df, hdf, dd, agg, j, got, full
    s.stop()
    h.stop()
    QueryScheduler.get().plan_cache.clear()
    if on_card:
        torch.cuda.empty_cache()
    check_no_leak(state0, on_card, "phase 16")
    print(json.dumps({"surface_ms": ms, "card": smi}), flush=True)
    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s | card: {smi}",
          flush=True)



# ---------------------------------------------------------------------------
# phase 17: the scalar functions on the card — dates and timestamps in the
# session time zone, the math family, integral arithmetic with ANSI checks,
# bitwise, NaN handling, greatest/least, the hashes, the row and input-file
# expressions
# ---------------------------------------------------------------------------

SCALAR_ROWS = 1 << 22
SCALAR_SEED = 17
SCALAR_ZONE = "America/Los_Angeles"
#: md5's host hop is hashlib a row at a time: its check runs over the
#: events' first 2^20 strings (the other parts over all 2^22 rows)
SCALAR_MD5_ROWS = 1 << 20
SCALAR_FILE_ROWS = 1 << 20  # the parquet file input_file_name reads
MATH_RTOL, MATH_ATOL = 1e-12, 1e-15
I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1


def _epoch_micros(text: str) -> int:
    return int((np.datetime64(text, "us")
                - np.datetime64("1970-01-01T00:00:00", "us"))
               .astype(np.int64))


def events_table(n: int, seed: int = SCALAR_SEED):
    """Phase 17's events table as Arrow, and its numpy columns and null
    masks: ``d`` dates 1900-2100 with every 29 February, ``ts`` 1960-2040
    with 1 row in 16 within ±2 h of a Los Angeles transition, ``x``
    doubles with NaN, ±0.0, ±inf, negatives and subnormals, ``i`` longs
    with MinValue, -1 and 0, ``j`` ints, ``s`` strings of 0-40 bytes (1 in
    64 non-ASCII); 1 row in 10 null in each column."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.tzdb import TimeZoneDB
    rng = np.random.default_rng(seed)
    epoch = np.datetime64("1970-01-01", "D")
    lo = int((np.datetime64("1900-01-01") - epoch).astype(np.int64))
    hi = int((np.datetime64("2100-12-31") - epoch).astype(np.int64))
    d = rng.integers(lo, hi + 1, n).astype(np.int32)
    leap = np.array([(np.datetime64(f"{y}-02-29") - epoch).astype(np.int64)
                     for y in range(1904, 2100, 4)], np.int32)
    d[:min(n, len(leap))] = leap[:n]
    t_lo, t_hi = _epoch_micros("1960-01-01"), _epoch_micros("2040-01-01")
    ts = rng.integers(t_lo, t_hi, n)
    tr = TimeZoneDB.require(SCALAR_ZONE).trans_micros
    tr = tr[(tr > t_lo) & (tr < t_hi)]
    near = np.arange(n) % 16 == 5
    ts[near] = tr[rng.integers(0, len(tr), int(near.sum()))] + rng.integers(
        -2 * 3600 * 10 ** 6, 2 * 3600 * 10 ** 6, int(near.sum()))
    x = rng.normal(0, 100, n)
    x[::4] = rng.uniform(-1, 1, len(x[::4]))
    special = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf, 5e-324,
                        -2.5e-310, -1.5, 2.5, 1.0, -1.0, 0.5, 1e300, -1e300,
                        2.675, 1.005, 0.125])
    at = np.arange(3, n, 32)
    x[at] = special[np.arange(len(at)) % len(special)]
    i = rng.integers(-(1 << 62), 1 << 62, n)
    i[7::97] = np.array([I64_MIN, -1, 0, I64_MAX])[np.arange(len(i[7::97]))
                                                   % 4]
    j = rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
    j[11::89] = np.array([-(1 << 31), -1, 0, 1], np.int32)[
        np.arange(len(j[11::89])) % 4]
    j[7::97 * 4] = -1  # MinValue div / % / pmod -1
    lens = rng.integers(0, 41, n)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    chars = rng.integers(97, 123, int(offs[-1])).astype(np.uint8)
    wide = np.nonzero((np.arange(n) % 64 == 9) & (lens >= 2))[0]
    chars[offs[wide]] = 0xC3  # "é": two bytes of UTF-8
    chars[offs[wide] + 1] = 0xA9
    nulls = {k: rng.random(n) < 0.1 for k in "dtxijs"}

    def bitmap(k):
        return pa.py_buffer(np.packbits(~nulls[k], bitorder="little")
                            .tobytes())
    s = pa.StringArray.from_buffers(
        n, pa.py_buffer(offs.astype(np.int32).tobytes()),
        pa.py_buffer(chars.tobytes()), bitmap("s"), int(nulls["s"].sum()))
    tbl = pa.table({
        "d": pa.array(d, pa.int32(), mask=nulls["d"]).cast(pa.date32()),
        "ts": pa.array(ts, pa.int64(), mask=nulls["t"]).cast(
            pa.timestamp("us", tz="UTC")),
        "x": pa.array(x, pa.float64(), mask=nulls["x"]),
        "i": pa.array(i, pa.int64(), mask=nulls["i"]),
        "j": pa.array(j, pa.int32(), mask=nulls["j"]),
        "s": s})
    cols = {"d": d, "ts": ts, "x": x, "i": i, "j": j, "s": (offs, chars)}
    return tbl, cols, nulls


def _arrow_vals(col, fill=0):
    """(values, null mask) of an Arrow column; dates and timestamps as
    their integers."""
    import pyarrow as pa
    col = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
    if pa.types.is_date32(col.type):
        col = col.cast(pa.int32())
    elif pa.types.is_timestamp(col.type):
        col = col.cast(pa.int64())
    null = np.asarray(col.is_null())
    if pa.types.is_boolean(col.type):
        fill = False
    return np.asarray(col.fill_null(fill).to_numpy(zero_copy_only=False)), \
        null


def check_exact(got_col, want, want_null, what: str) -> None:
    """An Arrow column equal to numpy values with the same nulls."""
    vals, null = _arrow_vals(got_col)
    check(np.array_equal(null, want_null), f"{what}: null positions differ")
    ok = ~null
    bad = np.nonzero(vals[ok] != np.asarray(want)[ok])[0]
    check(len(bad) == 0, f"{what}: {len(bad)} rows differ, first "
          f"{vals[ok][bad[:3]]} vs {np.asarray(want)[ok][bad[:3]]}")


def check_float(got_col, want, want_null, what: str,
                rtol: float = MATH_RTOL, atol: float = MATH_ATOL) -> None:
    """Doubles within rtol/atol, the same NaN, ±inf and null positions."""
    vals, null = _arrow_vals(got_col, fill=0.0)
    want = np.asarray(want, np.float64)
    check(np.array_equal(null, want_null), f"{what}: null positions differ")
    ok = ~null
    g, w = vals[ok], want[ok]
    with np.errstate(all="ignore"):
        # equal (±inf too), or both NaN, or finite and within the tolerance
        good = (g == w) | (np.isnan(g) & np.isnan(w)) \
            | (np.abs(g - w) <= atol + rtol * np.abs(w))
    bad = np.nonzero(~good)[0]
    check(len(bad) == 0, f"{what}: {len(bad)} rows differ, first "
          f"{g[bad[:3]]} vs {w[bad[:3]]}")


def _civil(days):
    """numpy's calendar: (year, month, day) of int day numbers."""
    dd = days.astype("datetime64[D]")
    y = dd.astype("datetime64[Y]").astype(np.int64) + 1970
    m = dd.astype("datetime64[M]").astype(np.int64) % 12 + 1
    dom = (dd - dd.astype("datetime64[M]")).astype(np.int64) + 1
    return y, m, dom


def date_oracles(d, j):
    """numpy oracles of phase 17 (a)'s date functions."""
    d64 = d.astype(np.int64)
    y, m, dom = _civil(d64)
    jan1 = (y - 1970).astype("datetime64[Y]").astype("datetime64[D]") \
        .astype(np.int64)
    month0 = d64.astype("datetime64[D]").astype("datetime64[M]")
    last = ((month0 + 1).astype("datetime64[D]").astype(np.int64) - 1)
    thursday = d64 - (d64 + 3) % 7 + 3
    ty = thursday.astype("datetime64[D]").astype("datetime64[Y]")
    woy = (thursday - ty.astype("datetime64[D]").astype(np.int64)) // 7 + 1
    delta = np.fmod(j.astype(np.int64), 10000)
    k = np.fmod(j.astype(np.int64), 240)
    target = month0 + k
    t_days = (target + 1).astype("datetime64[D]").astype(np.int64) - \
        target.astype("datetime64[D]").astype(np.int64)
    am = target.astype("datetime64[D]").astype(np.int64) + \
        np.minimum(dom, t_days) - 1
    return {"y": y, "m": m, "dom": dom, "q": (m - 1) // 3 + 1,
            "dow": (d64 + 4) % 7 + 1, "wd": (d64 + 3) % 7,
            "doy": d64 - jan1 + 1, "woy": woy, "ld": last,
            "add": (d64 + delta).astype(np.int32), "sub": d64 - 45,
            "diff": d64 - last, "am": am}


def _piecewise_offsets(secs, off):
    """``off(sec)`` (an offset in micros, constant between a zone's
    transitions) of every instant: one call at each end of a distinct
    day; the rows of a day holding a transition again by hour, then by
    minute, then one call a row (a day with two transitions back to the
    same offset would pass unseen: no zone has one)."""
    out = np.empty(len(secs), np.int64)
    rest = np.arange(len(secs))
    for unit in (86400, 3600, 60):
        if not len(rest):
            return out
        b = np.floor_divide(secs[rest], unit)
        uniq, inv = np.unique(b, return_inverse=True)
        first = np.array([off(u * unit) for u in uniq], np.int64)
        last = np.array([off(u * unit + unit - 1) for u in uniq], np.int64)
        same = (first == last)[inv]
        out[rest[same]] = first[inv][same]
        rest = rest[~same]
    for k in rest:
        out[k] = off(secs[k])
    return out


def zone_offsets_micros(utc_micros, zone: str):
    """zoneinfo's UTC offset (micros) of each UTC instant (some
    transitions fall off the hour: Los Angeles, 1948-03-14 02:01)."""
    import datetime as _dt
    from zoneinfo import ZoneInfo
    if zone == "UTC":
        return np.zeros(len(utc_micros), np.int64)
    zi = ZoneInfo(zone)

    def off(sec):
        return int(_dt.datetime.fromtimestamp(int(sec), zi).utcoffset()
                   .total_seconds()) * 1_000_000
    return _piecewise_offsets(np.floor_divide(utc_micros, 1_000_000), off)


def wall_to_utc_micros(local_micros, zone: str):
    """zoneinfo's instant of each wall time with fold=0 (java.time's: an
    overlap takes the earlier offset)."""
    import datetime as _dt
    from zoneinfo import ZoneInfo
    if zone == "UTC":
        return local_micros
    zi = ZoneInfo(zone)
    base = _dt.datetime(1970, 1, 1)

    def off(sec):
        return int((base + _dt.timedelta(seconds=int(sec))).replace(
            tzinfo=zi, fold=0).utcoffset().total_seconds()) * 1_000_000
    return local_micros - _piecewise_offsets(
        np.floor_divide(local_micros, 1_000_000), off)


def _u64(v):
    return np.asarray(v).astype(np.uint64)


_P1, _P2, _P3 = (np.uint64(0x9E3779B185EBCA87), np.uint64(0xC2B2AE3D27D4EB4F),
                 np.uint64(0x165667B19E3779F9))
_P4, _P5 = np.uint64(0x85EBCA77C2B2AE63), np.uint64(0x27D4EB2F165667C5)


def _rotl64(x, r):
    return (x << np.uint64(r)) | (x >> np.uint64(64 - r))


def _xx_fmix(h):
    h ^= h >> np.uint64(33)
    h *= _P2
    h ^= h >> np.uint64(29)
    h *= _P3
    return h ^ (h >> np.uint64(32))


def _xx_int(v32, seed):
    h = seed + _P5 + np.uint64(4)
    h ^= (_u64(np.asarray(v32).astype(np.int64)) & np.uint64(0xFFFFFFFF)) * _P1
    return _xx_fmix(_rotl64(h, 23) * _P2 + _P3)


def _xx_long(v64, seed):
    h = seed + _P5 + np.uint64(8)
    h ^= _rotl64(_u64(v64) * _P2, 31) * _P1
    return _xx_fmix(_rotl64(h, 27) * _P1 + _P4)


def _xx_round(acc, val):
    return _rotl64(acc + val * _P2, 31) * _P1


def _string_matrix(offs, chars, width: int, right: bool = False):
    """(byte matrix [rows, width] zero-padded at the end, or at the start
    with ``right``, lengths) of strings."""
    lens = np.diff(offs)
    mat = np.zeros((len(lens), width), np.uint8)
    if offs[-1] > offs[0]:
        rows = np.repeat(np.arange(len(lens), dtype=np.int32), lens)
        cols = np.arange(offs[0], offs[-1], dtype=np.int64) \
            - np.repeat(offs[:-1] - (width - lens if right else 0), lens)
        mat[rows, cols.astype(np.int32)] = chars[offs[0]:offs[-1]]
    return mat, lens


def _xx_strings(offs, chars, seed):
    """Spark's XXH64.hashUnsafeBytes of every row, vectorized numpy: the
    rows of one length share every offset, so each length's rows go
    through the stripe, word and byte steps as whole columns."""
    mat, lens = _string_matrix(offs, chars, 40)
    out = np.empty(len(lens), np.uint64)

    def word(m, at, nbytes):
        return np.ascontiguousarray(m[:, at:at + nbytes]).view(
            {8: "<u8", 4: "<u4"}[nbytes]).reshape(-1).astype(np.uint64)
    for ln in np.unique(lens):
        rows = np.nonzero(lens == ln)[0]
        m, s0 = mat[rows], seed[rows]
        pos = 0
        if ln >= 32:
            v = [s0 + _P1 + _P2, s0 + _P2, s0.copy(), s0 - _P1]
            v = [_xx_round(v[k], word(m, 8 * k, 8)) for k in range(4)]
            h = _rotl64(v[0], 1) + _rotl64(v[1], 7) + _rotl64(v[2], 12) + \
                _rotl64(v[3], 18)
            for vk in v:
                h = (h ^ _xx_round(np.zeros_like(vk), vk)) * _P1 + _P4
            pos = 32
        else:
            h = s0 + _P5
        h = h + np.uint64(ln)
        while pos + 8 <= ln:
            k1 = word(m, pos, 8)
            h = _rotl64(h ^ (_rotl64(k1 * _P2, 31) * _P1), 27) * _P1 + _P4
            pos += 8
        if pos + 4 <= ln:
            h = _rotl64(h ^ (word(m, pos, 4) * _P1), 23) * _P2 + _P3
            pos += 4
        while pos < ln:
            h = _rotl64(h ^ (m[:, pos].astype(np.uint64) * _P5), 11) * _P1
            pos += 1
        out[rows] = _xx_fmix(h)
    return out


def _canonical_double_bits(x):
    """Java's doubleToLongBits after Spark's -0.0 → 0.0."""
    x = np.where(x == 0.0, 0.0, x)
    bits = x.view(np.int64)
    return np.where(np.isnan(x), np.int64(0x7FF8000000000000), bits)


def _by_chunks(fn, cols, nulls, chunk: int = 1 << 20):
    """``fn`` over row chunks (the strings' byte matrix stays small)."""
    n = len(cols["i"])
    offs, chars = cols["s"]
    out = []
    for a in range(0, n, chunk):
        b = min(a + chunk, n)
        part = {k: (v[a:b] if k != "s" else (offs[a:b + 1], chars))
                for k, v in cols.items()}
        out.append(fn(part, {k: m[a:b] for k, m in nulls.items()}))
    return np.concatenate(out) if out else np.zeros(0, np.int64)


def xxhash64_oracle(cols, nulls):
    """Spark's xxhash64(i, x, s, d, ts) (seed 42), numpy."""
    if len(cols["i"]) > 1 << 20:
        return _by_chunks(xxhash64_oracle, cols, nulls)
    n = len(cols["i"])
    with np.errstate(over="ignore"):
        h = np.full(n, 42, np.uint64)
        for k, kind in (("i", "long"), ("x", "double"), ("s", "string"),
                        ("d", "int"), ("ts", "long")):
            valid = ~nulls["t" if k == "ts" else k]
            if kind == "long":
                nh = _xx_long(cols[k], h)
            elif kind == "double":
                nh = _xx_long(_canonical_double_bits(cols[k]), h)
            elif kind == "int":
                nh = _xx_int(cols[k], h)
            else:
                nh = _xx_strings(*cols[k], h)
            h = np.where(valid, nh, h)
    return h.view(np.int64)


def hive_hash_oracle(cols, nulls):
    """Spark's hive_hash(i, x, s, d, ts): 31·h + field, numpy (uint32
    arithmetic in uint64 lanes)."""
    if len(cols["i"]) > 1 << 20:
        return _by_chunks(hive_hash_oracle, cols, nulls)
    m32 = np.uint64(0xFFFFFFFF)

    def fold(v):
        u = _u64(v)
        return ((u >> np.uint64(32)) ^ u) & m32
    n = len(cols["i"])
    with np.errstate(over="ignore"):
        # right-aligned bytes: the leading zero padding leaves 31·h + b
        # at 0, so every row folds all 40 columns
        mat, lens = _string_matrix(*cols["s"], 40, right=True)
        sh32 = np.zeros(n, np.uint32)
        for b in range(40):
            sh32 = sh32 * np.uint32(31) + mat[:, b].view(np.int8).astype(
                np.int32).view(np.uint32)
        sh = sh32.astype(np.uint64)
        ts = cols["ts"]
        secs = np.where(ts >= 0, ts // 1_000_000, -((-ts) // 1_000_000))
        nanos = np.fmod(ts, 1_000_000) * 1000
        fields = {"i": fold(cols["i"]),
                  "x": fold(_canonical_double_bits(cols["x"])),
                  "s": sh, "d": _u64(cols["d"].astype(np.int64)) & m32,
                  "ts": fold((_u64(secs) << np.uint64(30)) | _u64(nanos))}
        h = np.zeros(n, np.uint64)
        for k in ("i", "x", "s", "d", "ts"):
            f = np.where(nulls["t" if k == "ts" else k], np.uint64(0),
                         fields[k])
            h = (h * np.uint64(31) + f) & m32
    return h.astype(np.uint32).view(np.int32)


def _java_rem(a, b):
    """Java's % of int64 arrays; b holds no zero (x % -1 is 0)."""
    safe = np.where(b == -1, 1, b)
    return np.fmod(a, safe)


def _java_div(a, b):
    """Java's / of int64 arrays (MinValue / -1 wraps); b holds no 0."""
    safe = np.where(b == -1, 1, b)
    q = np.fmod(a, safe)  # a - q*b ... by truncated division
    q = (a - q) // safe
    with np.errstate(over="ignore"):
        return np.where(b == -1, -a, q)


def _java_long_of(v):
    v = np.where(np.isnan(v), 0.0, v)
    out = np.where(np.abs(v) < 2.0 ** 63, v, 0.0).astype(np.int64)
    out = np.where(v >= 2.0 ** 63, I64_MAX, out)
    return np.where(v <= -2.0 ** 63, I64_MIN, out)


def math_oracles(x, j):
    """Spark's math functions over doubles as numpy (Java's specials for
    pow; Spark's own asinh, acosh, atanh)."""
    jd = j.astype(np.float64)
    with np.errstate(all="ignore"):
        out = {
            "sqrt": np.sqrt(x), "cbrt": np.cbrt(x), "exp": np.exp(x),
            "expm1": np.expm1(x), "sin": np.sin(x), "cos": np.cos(x),
            "tan": np.tan(x), "asin": np.arcsin(x), "acos": np.arccos(x),
            "atan": np.arctan(x), "sinh": np.sinh(x), "cosh": np.cosh(x),
            "tanh": np.tanh(x), "cot": 1.0 / np.tan(x),
            "asinh": np.where(x == -np.inf, -np.inf,
                              np.log(x + np.sqrt(x * x + 1.0))),
            "acosh": np.log(x + np.sqrt(x * x - 1.0)),
            "atanh": 0.5 * (np.log1p(x) - np.log1p(-x)),
            "degrees": x * 57.29577951308232,
            "radians": x * 0.017453292519943295,
            "rint": np.rint(x),
            "signum": np.where(x > 0, 1.0, np.where(x < 0, -1.0, x)),
            "log": np.log(x), "log10": np.log10(x), "log2": np.log2(x),
            "log1p": np.log1p(x), "log_2": np.log(x) / np.log(2.0),
            "pow3": np.power(x, 3.0),
            "pow1": np.where(np.isnan(x) | np.isinf(x), np.nan, 1.0),
            "atan2": np.arctan2(x, jd), "hypot": np.hypot(x, jd),
            "sqrt_j": np.sqrt(jd), "exp_j": np.exp(jd / 1e9),
            "ceil": _java_long_of(np.ceil(x)),
            "floor": _java_long_of(np.floor(x))}
    asym = {"log": 0.0, "log10": 0.0, "log2": 0.0, "log1p": -1.0,
            "log_2": 0.0}
    return out, asym


def round_oracle(x, rounding=decimal.ROUND_HALF_EVEN):
    """Spark's bround(x, 2) (round with ROUND_HALF_UP): the decimal text
    rounded at 2 digits, vectorized for the rows clear of a tie and below
    2^52 (where both modes agree with rint), exact through Python's
    decimal for the others."""
    with np.errstate(all="ignore"):
        y = x * 100.0
        out = np.rint(y) / 100.0 + 0.0
        ay = np.abs(y)
        near = (np.abs(ay - np.floor(ay) - 0.5) <= ay * 2.0 ** -40 + 1e-9) \
            | ~(ay < 2.0 ** 52)
    out = np.where(np.isfinite(x), out, x)
    for k in np.nonzero(near & np.isfinite(x))[0]:
        dec = decimal.Decimal(repr(float(x[k])))
        out[k] = float(dec.quantize(decimal.Decimal("0.01"),
                                    rounding=rounding)) + 0.0 \
            if dec.as_tuple().exponent < -2 else float(x[k])
    return out


def reduced(F, q):
    """``q`` reduced to one row on the card: the sum of Spark's hash of
    every column (what a timing line collects, so the download does not
    dominate; every column stays live)."""
    return q.agg(F.sum(F.hash(*[F.col(c) for c in q.columns])).alias("h"))


def best_of_2_line(key: str, q, rows: int, smi: str) -> None:
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        q.collect()
        best = min(best, time.perf_counter() - t0)
    print(json.dumps({key: {"rows": rows, "best_collect_s": best,
                            "mrows_per_s": rows / best / 1e6},
                      "card": smi}), flush=True)


def scalar_paths(F, TorchSession, smi, tmpdir: str, device: str = "cuda",
                 rows: int = SCALAR_ROWS, md5_rows: int = SCALAR_MD5_ROWS,
                 file_rows: int = SCALAR_FILE_ROWS) -> None:
    """Phase 17: (a)-(f) in test mode over the events table. With
    ``device="cpu"`` and small sizes it checks the script's own logic off
    the card (no timing lines)."""
    import datetime as _dt
    import hashlib
    import os

    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch.expressions import arithmetic as PA
    from spark_rapids_tpu_torch.expressions import bitwise as PBW
    from spark_rapids_tpu_torch.expressions import nullexprs as PN
    from spark_rapids_tpu_torch.expressions.base import ExpressionError
    from spark_rapids_tpu_torch.expressions.datetime import \
        host_path_counts as dt_hops
    from spark_rapids_tpu_torch.expressions.strings import \
        host_path_counts as str_hops
    from spark_rapids_tpu_torch.serving.scheduler import QueryScheduler
    from spark_rapids_tpu_torch.session import Column
    from spark_rapids_tpu_torch.tzdb import TimeZoneDB
    on_card = device == "cuda"
    t_phase = time.perf_counter()
    if TimeZoneDB.get(SCALAR_ZONE) is None:
        print(f"(17) no TZif file for {SCALAR_ZONE} on this machine",
              flush=True)
        check(False, f"phase 17 needs the TZif file of {SCALAR_ZONE}")
    tbl, cols, nulls = events_table(rows)
    base = {"spark.rapids.shuffle.mode": "ICI",
            "spark.sql.shuffle.partitions": "8",
            "spark.rapids.sql.batchSizeRows": str(1 << 20)}
    s = TorchSession(dict(base, **{"spark.rapids.sql.test.enabled": "true"}),
                     device=device)
    h = TorchSession(dict(base, **{"spark.rapids.sql.enabled": "false"}),
                     device=device)
    state0 = runtime_state(on_card)
    df = s.createDataFrame(tbl, num_partitions=4)
    dc = df.device_cache()
    hdf = h.createDataFrame(tbl, num_partitions=4)
    counters0 = dict(s.counters)
    t_setup = time.perf_counter() - t_phase
    parts: dict = {"setup": t_setup}
    t_part = time.perf_counter()

    def part_done(key):
        nonlocal t_part
        now = time.perf_counter()
        parts[key] = now - t_part
        t_part = now
    print(f"(17) events table: {rows} rows in 4 partitions, "
          f"{tbl.nbytes / 1e9:.3f} GB, setup {t_setup:.1f} s", flush=True)

    # (a) dates: a group by year and quarter, every date field and the date
    # arithmetic against numpy's calendar, exactly
    qa = dc.groupBy(F.year("d").alias("y"), F.quarter("d").alias("q")).agg(
        F.sum("x").alias("sx"), F.count("x").alias("n"),
        F.sum("j").alias("sj"))
    got = qa.to_arrow().sort_by([("y", "ascending"), ("q", "ascending")])
    o = date_oracles(cols["d"], cols["j"])
    dv = ~nulls["d"]
    key = o["y"][dv] * 4 + o["q"][dv] - 1
    uk, inv = np.unique(key, return_inverse=True)
    xv = ~nulls["x"][dv]
    jv = ~nulls["j"][dv]
    want_n = np.bincount(inv, weights=xv, minlength=len(uk)).astype(np.int64)
    want_sj = np.bincount(inv[jv], weights=cols["j"][dv][jv].astype(
        np.float64), minlength=len(uk))
    want_sx = np.bincount(inv[xv], weights=cols["x"][dv][xv],
                          minlength=len(uk))
    # the null date's group: Spark groups the nulls together
    check(got.num_rows == len(uk) + 1, f"(17a) {got.num_rows} groups")
    body = got.slice(0, len(uk)) if got.column("y")[0].is_valid \
        else got.slice(1, len(uk))
    check_exact(body.column("y"), uk // 4, np.zeros(len(uk), bool),
                "(17a) year")
    check_exact(body.column("q"), uk % 4 + 1, np.zeros(len(uk), bool),
                "(17a) quarter")
    check_exact(body.column("n"), want_n, np.zeros(len(uk), bool),
                "(17a) count")
    # a group without a non-null value sums to null
    check_exact(body.column("sj"), want_sj.astype(np.int64),
                np.bincount(inv[jv], minlength=len(uk)) == 0,
                "(17a) sum(j)")
    check_float(body.column("sx"), want_sx, want_n == 0, "(17a) sum(x)",
                rtol=1e-9, atol=1e-6)
    q = dc.select(
        F.year("d").alias("y"), F.month("d").alias("m"),
        F.dayofmonth("d").alias("dom"), F.quarter("d").alias("q"),
        F.dayofweek("d").alias("dow"), F.weekday("d").alias("wd"),
        F.dayofyear("d").alias("doy"), F.weekofyear("d").alias("woy"),
        F.last_day("d").alias("ld"),
        F.date_add(F.col("d"), F.col("j") % 10000).alias("add"),
        F.date_sub("d", 45).alias("sub"),
        F.datediff(F.col("d"), F.last_day("d")).alias("diff"),
        F.add_months(F.col("d"), F.col("j") % 240).alias("am"))
    got = q.to_arrow()
    for k in ("y", "m", "dom", "q", "dow", "wd", "doy", "woy", "ld", "sub",
              "diff"):
        check_exact(got.column(k), o[k], nulls["d"], f"(17a) {k}")
    both = nulls["d"] | nulls["j"]
    check_exact(got.column("add"), o["add"], both, "(17a) date_add")
    check_exact(got.column("am"), o["am"], both, "(17a) add_months")
    print(f"(17a) dates ok: {len(uk)} (year, quarter) groups and 13 date "
          "functions over every row equal numpy's calendar", flush=True)
    if on_card:
        timed_line("scalar_a_dates", qa, rows, smi)
    part_done("a")

    # (b) timestamps under UTC, then America/Los_Angeles: fields, the
    # device format, a host pattern, from_unixtime, the round trip of
    # unix_timestamp, timestamp_seconds/_millis/_micros, against zoneinfo
    # and the port's CPU answer, exactly
    ts, j = cols["ts"], cols["j"].astype(np.int64)
    host_pat = "EEE, dd MMM yyyy HH:mm a"  # outside the device set
    for zone in ("UTC", SCALAR_ZONE):
        for sess in (s, h):
            sess.conf.set("spark.sql.session.timeZone", zone)

        def qb_of(frame):
            f = F.date_format("ts", "yyyy-MM-dd HH:mm:ss")
            return frame.select(
                F.hour("ts").alias("hh"), F.minute("ts").alias("mi"),
                F.second("ts").alias("ss"), f.alias("f"),
                F.date_format("ts", host_pat).alias("g"),
                F.from_unixtime("j").alias("fu"),
                F.unix_timestamp(f).alias("rt"),
                F.timestamp_seconds("j").alias("t_s"),
                F.timestamp_millis("j").alias("t_ms"),
                F.timestamp_micros("i").alias("t_us"))
        qb = qb_of(dc)
        got = qb.to_arrow()
        cpu = qb_of(hdf).to_arrow()
        for c in got.column_names:
            check(got.column(c).equals(cpu.column(c)),
                  f"(17b) {zone} {c}: the card differs from the CPU answer")
        local = ts + zone_offsets_micros(ts, zone)
        tod = np.mod(local, 86_400_000_000)
        tn = nulls["t"]
        check_exact(got.column("hh"), tod // 3_600_000_000, tn,
                    f"(17b) {zone} hour")
        check_exact(got.column("mi"), tod // 60_000_000 % 60, tn,
                    f"(17b) {zone} minute")
        check_exact(got.column("ss"), tod // 1_000_000 % 60, tn,
                    f"(17b) {zone} second")
        fcol = got.column("f").combine_chunks()
        lens_ok = pc.all(pc.equal(pc.utf8_length(fcol), 19)).as_py()
        check(lens_ok in (True, None), f"(17b) {zone} format widths")
        parsed, pnull = _arrow_vals(pc.strptime(
            fcol, format="%Y-%m-%d %H:%M:%S", unit="s", error_is_null=True))
        check(np.array_equal(pnull, tn), f"(17b) {zone} format nulls")
        check(np.array_equal(parsed[~tn], np.floor_divide(local, 1_000_000)
                             [~tn]), f"(17b) {zone} formatted wall time")
        sample = np.nonzero(~tn)[0][:: max(1, rows // 4096)]
        gcol = got.column("g").combine_chunks()
        for k in sample:
            want = _dt.datetime(1970, 1, 1) + _dt.timedelta(
                microseconds=int(local[k]))
            check(gcol[int(k)].as_py() == want.strftime(
                "%a, %d %b %Y %H:%M %p"), f"(17b) {zone} host pattern "
                f"row {k}: {gcol[int(k)]} vs {want}")
        ju = j * 1_000_000
        lj = ju + zone_offsets_micros(ju, zone)
        fu, funull = _arrow_vals(pc.strptime(
            got.column("fu").combine_chunks(), format="%Y-%m-%d %H:%M:%S",
            unit="s", error_is_null=True))
        check(np.array_equal(funull, nulls["j"]), f"(17b) {zone} fu nulls")
        check(np.array_equal(fu[~nulls["j"]], np.floor_divide(
            lj, 1_000_000)[~nulls["j"]]), f"(17b) {zone} from_unixtime")
        wall = np.floor_divide(local, 1_000_000) * 1_000_000
        want_rt = np.floor_divide(wall_to_utc_micros(wall, zone), 1_000_000)
        check_exact(got.column("rt"), want_rt, tn,
                    f"(17b) {zone} unix_timestamp round trip")
        moved = int(np.sum((want_rt != np.floor_divide(ts, 1_000_000))
                           & ~tn))
        check((moved > 0) == (zone != "UTC"),
              f"(17b) {zone}: {moved} round trips moved by an overlap")
        check_exact(got.column("t_s"), j * 1_000_000, nulls["j"],
                    f"(17b) {zone} timestamp_seconds")
        check_exact(got.column("t_ms"), j * 1000, nulls["j"],
                    f"(17b) {zone} timestamp_millis")
        check_exact(got.column("t_us"), cols["i"], nulls["i"],
                    f"(17b) {zone} timestamp_micros")
        print(f"(17b) timestamps under {zone} ok: fields, formats, "
              f"from_unixtime and the round trip ({moved} rows in an "
              "overlap take the earlier offset) equal zoneinfo and the "
              "CPU answer", flush=True)
        if on_card and zone == SCALAR_ZONE:  # one timing line for (b)
            timed_line("scalar_b_timestamps", reduced(F, qb), rows, smi,
                       zone=zone)
        part_done(f"b_{zone}")

    # (c) math: the 31 functions over x (and j) against numpy
    x = cols["x"]
    mo, asym = math_oracles(x, cols["j"])
    fns = ["sqrt", "cbrt", "exp", "expm1", "sin", "cos", "tan", "asin",
           "acos", "atan", "sinh", "cosh", "tanh", "cot", "asinh", "acosh",
           "atanh", "degrees", "radians", "rint", "signum", "log", "log10",
           "log2", "log1p", "ceil", "floor"]
    exprs = [getattr(F, k)("x").alias(k) for k in fns] + [
        F.log(2.0, "x").alias("log_2"), F.pow("x", 3.0).alias("pow3"),
        F.pow(F.lit(1.0), "x").alias("pow1"),
        F.atan2("x", "j").alias("atan2"), F.hypot("x", "j").alias("hypot"),
        F.sqrt("j").alias("sqrt_j"),
        F.exp(F.col("j") / 1e9).alias("exp_j"),
        F.bround("x", 2).alias("bround"), F.round("x", 2).alias("round")]
    qc = dc.select(*exprs)
    got = qc.to_arrow()
    for k, want in mo.items():
        nl = nulls["j"] if k in ("sqrt_j", "exp_j") else nulls["x"]
        if k in ("atan2", "hypot"):
            nl = nulls["x"] | nulls["j"]
        if k in asym:
            with np.errstate(invalid="ignore"):
                nl = nl | (x <= asym[k])
        if k in ("ceil", "floor"):
            check_exact(got.column(k), want, nl, f"(17c) {k}")
        elif k == "rint":
            check_float(got.column(k), want, nl, f"(17c) {k}", 0.0, 0.0)
        else:
            check_float(got.column(k), want, nl, f"(17c) {k}")
    check_float(got.column("bround"), round_oracle(x), nulls["x"],
                "(17c) bround", 0.0, 0.0)
    check_float(got.column("round"), round_oracle(x, decimal.ROUND_HALF_UP),
                nulls["x"], "(17c) round", 0.0, 0.0)
    print(f"(17c) math ok: {len(got.column_names)} functions within rtol "
          f"{MATH_RTOL} / atol {MATH_ATOL} of numpy (bround, round, rint, "
          "the logs' nulls exact)", flush=True)
    if on_card:
        best_of_2_line("scalar_c_math", reduced(F, qc), rows, smi)
    part_done("c")

    # (d) integral functions, bitwise, NaN and nulls, greatest/least, exact
    i64, j64 = cols["i"], cols["j"].astype(np.int64)
    qd = dc.select(
        F.pmod("i", "j").alias("pmod"), (F.col("i") % F.col("j")).alias("rem"),
        Column(PA.IntegralDivide(F.col("i")._expr, F.col("j")._expr))
        .alias("div"),
        F.negative("i").alias("neg"), F.shiftleft("i", 7).alias("shl"),
        F.shiftright("i", 5).alias("shr"),
        F.shiftrightunsigned("i", 13).alias("shru"),
        F.shiftrightunsigned("j", 3).alias("shru_j"),
        F.bit_count("i").alias("bc"), F.bit_count("j").alias("bc_j"),
        F.bitwise_not("j").alias("bn"),
        Column(PBW.BitwiseOr(F.col("i")._expr, F.col("j")._expr)).alias("or"),
        Column(PBW.BitwiseXor(F.col("i")._expr, F.col("j")._expr))
        .alias("xor"),
        F.greatest("i", "j").alias("gr"), F.least("i", "j").alias("le"),
        F.isnan("x").alias("isnan"), F.nanvl("x", F.lit(-1.0)).alias("nv"),
        Column(PN.AtLeastNNonNulls(2, F.col("x")._expr, F.col("i")._expr,
                                   F.col("j")._expr)).alias("ann"))
    got = qd.to_arrow()
    ij = nulls["i"] | nulls["j"]
    nz = (j64 != 0) & ~ij
    safe = np.where(j64 == 0, 1, j64)
    with np.errstate(over="ignore"):
        rem = _java_rem(i64, safe)
        wrap = np.where(rem < 0, rem + safe, 0)  # int64 wrap, as Java
        pm = np.where(rem < 0, _java_rem(wrap, safe), rem)
        check_exact(got.column("pmod"), pm, ij | ~nz, "(17d) pmod")
        check_exact(got.column("rem"), rem, ij | ~nz, "(17d) %")
        check_exact(got.column("div"), _java_div(i64, safe), ij | ~nz,
                    "(17d) div")
        check_exact(got.column("neg"), -i64, nulls["i"], "(17d) negative")
        check_exact(got.column("shl"), i64 << np.int64(7), nulls["i"],
                    "(17d) shiftleft")
    check_exact(got.column("shr"), i64 >> np.int64(5), nulls["i"],
                "(17d) shiftright")
    check_exact(got.column("shru"), (i64.view(np.uint64) >> np.uint64(13))
                .view(np.int64), nulls["i"], "(17d) shiftrightunsigned")
    check_exact(got.column("shru_j"), (cols["j"].view(np.uint32)
                                       >> np.uint32(3)).view(np.int32),
                nulls["j"], "(17d) shiftrightunsigned int")

    def popcount(v):
        u = np.ascontiguousarray(v.astype(np.int64))
        return np.unpackbits(u.view(np.uint8)).reshape(len(u), 64).sum(1)
    check_exact(got.column("bc"), popcount(i64), nulls["i"],
                "(17d) bit_count")
    check_exact(got.column("bc_j"), popcount(j64), nulls["j"],
                "(17d) bit_count int")
    check_exact(got.column("bn"), ~cols["j"], nulls["j"], "(17d) ~")
    check_exact(got.column("or"), i64 | j64, ij, "(17d) |")
    check_exact(got.column("xor"), i64 ^ j64, ij, "(17d) ^")
    gi = np.where(nulls["i"], j64, np.where(nulls["j"], i64,
                                            np.maximum(i64, j64)))
    le = np.where(nulls["i"], j64, np.where(nulls["j"], i64,
                                            np.minimum(i64, j64)))
    both_null = nulls["i"] & nulls["j"]
    check_exact(got.column("gr"), gi, both_null, "(17d) greatest")
    check_exact(got.column("le"), le, both_null, "(17d) least")
    check_exact(got.column("isnan"), np.isnan(x) & ~nulls["x"],
                np.zeros(rows, bool), "(17d) isnan")
    check_float(got.column("nv"), np.where(np.isnan(x), -1.0, x),
                nulls["x"], "(17d) nanvl", 0.0, 0.0)
    nonnull = (~nulls["x"] & ~np.isnan(x)).astype(int) \
        + (~nulls["i"]).astype(int) + (~nulls["j"]).astype(int)
    check_exact(got.column("ann"), nonnull >= 2, np.zeros(rows, bool),
                "(17d) AtLeastNNonNulls")
    # ANSI on: i + i over MinValue raises, on the card and on the host,
    # with one message
    msgs = []
    for conf in ({"spark.rapids.sql.test.enabled": "true"},
                 {"spark.rapids.sql.enabled": "false"}):
        a = TorchSession(dict(base, **conf, **{"spark.sql.ansi.enabled":
                                               "true"}), device=device)
        try:
            a.createDataFrame(tbl, num_partitions=4).select(
                (F.col("i") + F.col("i")).alias("z")).to_arrow()
            msgs.append(None)
        except ExpressionError as e:
            msgs.append(str(e))
        a.stop()
    check(msgs[0] is not None and msgs[0] == msgs[1]
          and "overflow" in msgs[0], f"(17d) ANSI messages {msgs}")
    print(f"(17d) integral, bitwise and NaN functions ok (exact); ANSI i + i"
          f" raises on the card and the host: {msgs[0]!r}", flush=True)
    if on_card:
        best_of_2_line("scalar_d_integral", reduced(F, qd), rows, smi)
    part_done("d")

    # (e) hashes against numpy oracles of Spark's algorithms; md5 against
    # hashlib over the first md5_rows strings
    qe = dc.select(F.xxhash64("i", "x", "s", "d", "ts").alias("xx"),
                   F.hive_hash("i", "x", "s", "d", "ts").alias("hh"))
    got = qe.to_arrow()
    check_exact(got.column("xx"), xxhash64_oracle(cols, nulls),
                np.zeros(rows, bool), "(17e) xxhash64")
    check_exact(got.column("hh"), hive_hash_oracle(cols, nulls),
                np.zeros(rows, bool), "(17e) hive_hash")
    small = tbl.select(["s"]).slice(0, md5_rows)
    md = s.createDataFrame(small).select(F.md5("s").alias("m")).to_arrow()
    want = [None if v is None else hashlib.md5(v).hexdigest()
            for v in small.column("s").cast(pa.binary()).to_pylist()]
    check(md.column("m").to_pylist() == want, "(17e) md5 differs from hashlib")
    print(f"(17e) hashes ok: xxhash64 and hive_hash of (i, x, s, d, ts) "
          f"over {rows} rows equal Spark's algorithms; md5 of {md5_rows} "
          "strings equals hashlib", flush=True)
    if on_card:
        timed_line("scalar_e_hashes", reduced(F, qe), rows, smi)
    part_done("e")

    # (f) partition ids, row ids, rand, the input file
    qf = df.select(F.spark_partition_id().alias("p"),
                   F.monotonically_increasing_id().alias("mid"),
                   F.rand(42).alias("r"))
    got = qf.to_arrow()
    part_rows = local_partition_rows(rows, 4)
    want_p = np.repeat(np.arange(4), part_rows)
    within = np.concatenate([np.arange(k) for k in part_rows])
    check_exact(got.column("p"), want_p, np.zeros(rows, bool),
                "(17f) spark_partition_id")
    check_exact(got.column("mid"), (want_p.astype(np.int64) << 33) + within,
                np.zeros(rows, bool), "(17f) monotonically_increasing_id")
    cpu = hdf.select(F.spark_partition_id().alias("p"),
                     F.monotonically_increasing_id().alias("mid"),
                     F.rand(42).alias("r")).to_arrow()
    check(cpu.equals(got), "(17f) the host engine's ids or rand differ")
    s2 = TorchSession(dict(base, **{"spark.rapids.sql.test.enabled": "true",
                                    "spark.rapids.sql.batchSizeRows":
                                    str(max(rows // 64, 1))}), device=device)
    other = s2.createDataFrame(tbl, num_partitions=4).select(
        F.rand(42).alias("r")).to_arrow()
    check(other.column("r").equals(got.column("r")),
          "(17f) rand differs at another batch size")
    s2.stop()
    path = os.path.join(tmpdir, "events.parquet")
    pq.write_table(tbl.select(["i", "j"]).slice(0, file_rows), path,
                   row_group_size=1 << 18)
    qi = s.read.parquet(path).select(
        F.input_file_name().alias("f"),
        F.input_file_block_start().alias("st"),
        F.input_file_block_length().alias("ln"), "j")
    check("TorchFileScan" in quiet_plan(qi), "(17f) no device file scan")
    got_f = qi.to_arrow()
    size = os.path.getsize(path)
    check(got_f.num_rows == min(file_rows, rows)
          and pc.all(pc.equal(got_f.column("f"), path)).as_py()
          and pc.all(pc.equal(got_f.column("st"), 0)).as_py()
          and pc.all(pc.equal(got_f.column("ln"), size)).as_py(),
          "(17f) input_file_name / block start / length")
    check(s.counters.get("fallback_row_groups", 0) == counters0.get(
        "fallback_row_groups", 0), "(17f) the file left the device decode")
    print(f"(17f) misc ok: partition and row ids over 4 partitions exact; "
          "rand(42) identical on the card, the host and at another batch "
          f"size; input_file_name over {got_f.num_rows} rows of "
          f"{size} bytes", flush=True)
    if on_card:
        best_of_2_line("scalar_f_misc", reduced(F, qf), rows, smi)
    part_done("f")

    hops = {"datetime": {f"{c}.{r}": v for (c, r), v in
                         dt_hops(s.counters).items()},
            "strings": {f"{c}.{r}": v for (c, r), v in
                        str_hops(s.counters).items()
                        if (c, r) not in str_hops(counters0)}}
    print(json.dumps({"scalar_parts_s": parts, "card": smi}), flush=True)
    print(json.dumps({"scalar_host_paths": {
        "datetime.hostPath": s.counters.get("datetime.hostPath", 0)
        - counters0.get("datetime.hostPath", 0),
        "strings.hostPath": s.counters.get("strings.hostPath", 0)
        - counters0.get("strings.hostPath", 0), **hops},
        "card": smi}), flush=True)
    del dc, df, hdf, q, qa, qb, qc, qd, qe, qf, qi, got, cpu, got_f
    s.stop()
    h.stop()
    QueryScheduler.get().plan_cache.clear()
    TimeZoneDB.clear_device_tables()  # the zones' tables on the card
    if on_card:
        torch.cuda.empty_cache()
    check_no_leak(state0, on_card, "phase 17")
    print(f"phase 17: {time.perf_counter() - t_phase:.1f} s | card: {smi}",
          flush=True)


# ---------------------------------------------------------------------------
# phase 18: decimals
# ---------------------------------------------------------------------------

DEC_ROWS = 1 << 24
#: (b)'s parquet files: the first half of (a)'s table
DEC_FILE_ROWS = 1 << 23
DEC_SWEEP_ROWS = 1 << 22
DEC_SAMPLE = 1 << 12
#: the sweep's / % pmod on the card over the table's first rows, each one
#: checked against Python ``decimal``
DEC_DIV_ROWS = DEC_SAMPLE
#: (d)'s table: the rounding family, / % pmod and windows over decimal(12,
#: 2), checked against the host engine over its first rows
DEC_REST_ROWS = 1 << 22
DEC_REST_CHECK = 1 << 16


def _half_up_div(n: int, d: int) -> int:
    q, r = divmod(abs(n), d)
    q += 2 * r >= d
    return q if n >= 0 else -q


def _np_half_up(v: np.ndarray, m: int) -> np.ndarray:
    """HALF_UP of int64 ``v / m`` (ties away from zero)."""
    q = (np.abs(v) + m // 2) // m
    return np.where(v < 0, -q, q)


def decimal_q1_oracle(c):
    """Spark's decimal Q1 over ``lineitem_decimal``'s unscaled columns by
    numpy int64 (the per-row charge, at scale 6, fits): {(rf, ls): unscaled
    sums, Spark's HALF_UP averages (the quotient at scale 18, then 6) and
    the count}."""
    keep = c["l_shipdate"] <= 10471
    key = np.char.add(c["l_returnflag"][keep], c["l_linestatus"][keep])
    keys, inv = np.unique(key, return_inverse=True)
    order = np.argsort(inv, kind="stable")
    starts = np.searchsorted(inv[order], np.arange(len(keys)))
    qty, price, disc, tax = (c[k][keep][order] for k in (
        "l_quantity", "l_extendedprice", "l_discount", "l_tax"))
    disc_price = price * (100 - disc)
    measures = {"sum_qty": (qty, 2), "sum_base_price": (price, 2),
                "sum_disc_price": (disc_price, 4),
                "sum_charge": (disc_price * (100 + tax), 6)}
    sums = {k: np.add.reduceat(v, starts) for k, (v, _) in measures.items()}
    disc_sum = np.add.reduceat(disc, starts)
    counts = np.diff(np.append(starts, len(order)))
    out = {}
    for g, k in enumerate(keys):
        n = int(counts[g])
        row = {name: (int(sums[name][g]), scale)
               for name, (_, scale) in measures.items()}
        for name, total in (("avg_qty", sums["sum_qty"][g]),
                            ("avg_price", sums["sum_base_price"][g]),
                            ("avg_disc", disc_sum[g])):
            q18 = _half_up_div(int(total) * 10 ** 16, n)
            row[name] = (_half_up_div(q18, 10 ** 12), 6)
        row["count_order"] = n
        out[(k[:1].decode(), k[1:].decode())] = row
    return out


def decimal_q6_oracle(c) -> int:
    """Q6's revenue (decimal(35, 4)) as its unscaled int."""
    keep = ((c["l_shipdate"] >= 8766) & (c["l_shipdate"] < 9131)
            & (c["l_discount"] >= 5) & (c["l_discount"] <= 7)
            & (c["l_quantity"] < 2400))
    return int((c["l_extendedprice"][keep] * c["l_discount"][keep]).sum())


def _unscaled(v, scale: int, what: str) -> int:
    check(isinstance(v, decimal.Decimal)
          and v.as_tuple().exponent == -scale, f"{what}: {v!r} is not a "
          f"decimal of scale {scale}")
    return int(v.scaleb(scale, context=decimal.Context(prec=100)))


def check_decimal_q1(rows, oracle, what: str) -> None:
    check(len(rows) == len(oracle), f"{what}: {len(rows)} groups, "
          f"want {len(oracle)}")
    for r in rows:
        want = oracle[(r["l_returnflag"], r["l_linestatus"])]
        check(r["count_order"] == want["count_order"], f"{what}: count")
        for name, value in want.items():
            if name == "count_order":
                continue
            v, scale = value
            got = _unscaled(r[name], scale, f"{what} {name}")
            check(got == v, f"{what}: {name} {got} != {v}")


def check_decimal_q6(rows, want: int, what: str) -> None:
    check(len(rows) == 1, f"{what}: {len(rows)} rows")
    got = _unscaled(rows[0]["revenue"], 4, f"{what} revenue")
    check(got == want, f"{what}: revenue {got} != {want}")


def arrow_unscaled(table, name: str):
    """A result column's unscaled values as int64 (a two-limb column must
    hold int64 values: its high limb the low one's sign) and its nulls."""
    from spark_rapids_tpu_torch.columnar.vector import decimal_from_arrow
    from spark_rapids_tpu_torch.types import DecimalType
    arr = table.column(name).combine_chunks()
    t = arr.type
    vals = decimal_from_arrow(arr, DecimalType(t.precision, t.scale))
    null = np.asarray(arr.is_null()) if arr.null_count else \
        np.zeros(len(arr), bool)
    if vals.ndim == 2:
        fits = vals[:, 0] == (vals[:, 1] >> 63)
        check(bool(fits[~null].all()), f"{name}: values past int64")
        vals = vals[:, 1]
    return vals, null


def check_unscaled(table, name: str, want, want_null, what: str) -> None:
    got, null = arrow_unscaled(table, name)
    check(np.array_equal(null, want_null), f"{what}: {name} nulls differ")
    bad = np.nonzero((got != want) & ~null)[0]
    check(not bad.size, f"{what}: {name} differs at {bad[:5]} "
          f"({got[bad[:5]]} != {np.asarray(want)[bad[:5]]})")


def spark_hash_long(v: np.ndarray) -> np.ndarray:
    """Spark's ``hash`` of int64 values (``hashLong``: the low word, then
    the high word, seed 42), by numpy: int64 values of the int32
    hashes."""
    u = np.uint32

    def rotl(x, r):
        return (x << u(r)) | (x >> u(32 - r))

    def mix(h, k):
        k = rotl(k * u(0xCC9E2D51), 15) * u(0x1B873593)
        return rotl(h ^ k, 13) * u(5) + u(0xE6546B64)
    w = v.astype(np.int64).view(u).reshape(-1, 2)
    h = mix(mix(np.full(len(v), 42, u), w[:, 0]), w[:, 1])
    h ^= u(8)
    h ^= h >> u(16)
    h *= u(0x85EBCA6B)
    h ^= h >> u(13)
    h *= u(0xC2B2AE35)
    h ^= h >> u(16)
    return h.view(np.int32).astype(np.int64)


def sweep_table(n: int, seed: int = 18):
    """(c)'s table: decimal(12, 2) ``a`` and ``b`` (b: zeros and nulls),
    decimal(10, 4) ``c``, a decimal(10, 2) key ``k`` of 100 values, a
    decimal(38, 4) ``w`` with 1 row in 4096 past 10^33 (unscaled), int
    ``i`` and double ``x`` (three places, so ties at two)."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.columnar.vector import decimal_to_arrow
    from spark_rapids_tpu_torch.kernels.decimal128 import int_to_limbs
    from spark_rapids_tpu_torch.types import DecimalType
    rng = np.random.default_rng(seed)
    ids = np.arange(n)
    a = rng.integers(-10 ** 9, 10 ** 9, n)
    b = rng.integers(-10 ** 9, 10 ** 9, n)
    b[ids % 64 == 3] = 0
    b_null = ids % 32 == 5
    b[b_null] = 0
    c = rng.integers(-10 ** 9, 10 ** 9, n)
    k = rng.integers(0, 100, n) * 25 - 1000
    w_small = rng.integers(-10 ** 13, 10 ** 13, n)
    big_rows = np.nonzero(ids % 4096 == 7)[0]
    big = {int(r): (1 if r % 2 else -1) * (10 ** 33 + int(r))
           for r in big_rows}
    w = np.stack([w_small >> 63, w_small], 1)
    for r, v in big.items():
        w[r] = int_to_limbs(v)
    cols = {"a": a, "b": b, "b_null": b_null, "c": c, "k": k,
            "w_small": w_small, "w_big": big,
            "i": rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32),
            "x": np.round(rng.uniform(-1e5, 1e5, n), 3)}
    table = pa.table({
        "a": decimal_to_arrow(a, DecimalType(12, 2), None),
        "b": decimal_to_arrow(b, DecimalType(12, 2), ~b_null),
        "c": decimal_to_arrow(c, DecimalType(10, 4), None),
        "k": decimal_to_arrow(k, DecimalType(10, 2), None),
        "w": decimal_to_arrow(w, DecimalType(38, 4), None),
        "i": pa.array(cols["i"]), "x": pa.array(cols["x"])})
    return table, cols


def decimal_limb_ops_line(smi: str, rows: int) -> None:
    """The limb primitives alone on the card at ``rows`` (CUDA events):
    what a later PR weighs a hand-written kernel against (ROADMAP Queue
    B)."""
    from spark_rapids_tpu_torch.kernels import decimal128 as D
    g = torch.Generator(device="cuda").manual_seed(5)
    h = torch.randint(-2 ** 40, 2 ** 40, (rows,), device="cuda", generator=g)
    l = torch.randint(-2 ** 62, 2 ** 62, (rows,), device="cuda", generator=g)
    seg = torch.sort(torch.randint(0, 6, (rows,), device="cuda",
                                   generator=g)).values
    bounds = torch.searchsorted(seg, torch.arange(7, device="cuda"))

    def int_sum(x):
        c = torch.zeros(rows + 1, dtype=torch.int64, device="cuda")
        c[1:] = torch.cumsum(x, 0)
        return c[bounds[1:]] - c[bounds[:-1]]
    cnt = torch.full((rows,), 12345, dtype=torch.int64, device="cuda")
    ops = {"mul128": lambda: D.mul128(h, l, h, l),
           "add128": lambda: D.add128(h, l, h, l),
           "cmp128": lambda: D.cmp128(h, l, l, h),
           "rescale_down_2": lambda: D.rescale_down(h, l, 2),
           "precision_overflow": lambda: D.precision_overflow(h, l, 38),
           "segment_sum128": lambda: D.segment_sum128(h, l, int_sum),
           "div_half_up_16": lambda: D.div_half_up(h, l, cnt, 16)}
    print(json.dumps({"decimal_limb_ops_ms": {
        "rows": rows, **{k: time_ms(fn, 5, reps=3, warmup=1)
                         for k, fn in ops.items()}}, "card": smi}),
        flush=True)


def decimal_paths(F, TorchSession, smi, tmpdir: str, device: str = "cuda",
                  rows: int = DEC_ROWS, file_rows: int = DEC_FILE_ROWS,
                  sweep_rows: int = DEC_SWEEP_ROWS,
                  div_rows: int = DEC_DIV_ROWS,
                  rest_rows: int = DEC_REST_ROWS,
                  rest_check: int = DEC_REST_CHECK) -> None:
    """Phase 18: (a)-(d) in test mode. With ``device="cpu"`` and small
    sizes it checks the script's own logic off the card (no timing
    lines)."""
    import os

    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch import datagen, tpch
    from spark_rapids_tpu_torch.expressions.base import ExpressionError
    on_card = device != "cpu"
    test = {"spark.rapids.sql.test.enabled": "true"}

    # (a) Q1 and Q6 over the cached decimal lineitem
    cols = datagen.lineitem_decimal(rows)
    table = datagen.decimal_lineitem_arrow(cols)
    s = TorchSession({**test, "spark.rapids.sql.batchSizeRows": str(rows)},
                     device=device)
    t0 = time.perf_counter()
    df = s.createDataFrame(table).device_cache()
    if on_card:
        torch.cuda.synchronize()
    cache_s = time.perf_counter() - t0
    q1 = tpch.q1_decimal({"lineitem": df}, F)
    q6 = tpch.q6_decimal({"lineitem": df}, F)
    plan = quiet_plan(q1)
    check("TorchHashAggregate" in plan
          and "TorchCompiledAggStage" not in plan,
          "decimal Q1 is not on the general aggregate")
    o1, o6 = decimal_q1_oracle(cols), decimal_q6_oracle(cols)
    r1 = q1.collect()
    check_decimal_q1(r1, o1, f"(18a) decimal Q1 at {rows}")
    check(q1.collect() == r1, "(18a) decimal Q1 differs when repeated")
    r6 = q6.collect()
    check_decimal_q6(r6, o6, f"(18a) decimal Q6 at {rows}")
    check(q6.collect() == r6, "(18a) decimal Q6 differs when repeated")
    check(s.counters["decimal.hostPath"] == 0,
          "(18a) a decimal host hop in Q1/Q6")
    print(f"(18a) decimal Q1 and Q6 at {rows} ok (exact, repeated)",
          flush=True)
    if on_card:
        timed_line("decimal_q1", q1, rows, smi, device_cache_s=cache_s)
        timed_line("decimal_q6", q6, rows, smi)
        decimal_limb_ops_line(smi, rows)
    del df, q1, q6
    if on_card:
        release_plans()

    # (b) the same table's first rows from parquet, INT64-backed and
    # FIXED_LEN_BYTE_ARRAY
    sub = {k: v[:file_rows] for k, v in cols.items()}
    o1, o6 = decimal_q1_oracle(sub), decimal_q6_oracle(sub)
    for kind in ("int64", "flba"):
        p = os.path.join(tmpdir, f"decimal_{kind}.parquet")
        pq.write_table(table.slice(0, file_rows), p,
                       store_decimal_as_integer=kind == "int64")
        fs = TorchSession(test, device=device)
        fdf = fs.read.parquet(p)
        r1 = tpch.q1_decimal({"lineitem": fdf}, F).collect()
        check_decimal_q1(r1, o1, f"(18b) decimal Q1 from {kind} parquet")
        r6 = tpch.q6_decimal({"lineitem": fdf}, F).collect()
        check_decimal_q6(r6, o6, f"(18b) decimal Q6 from {kind} parquet")
        groups = pq.ParquetFile(p).metadata.num_row_groups
        fallback = fs.counters["fallback_columns"]
        # Q1 reads the 7 columns, Q6 4, each of every row group
        read = 11 * groups
        want_fallback = 0 if kind == "int64" else 7 * groups
        check(fallback == want_fallback, f"(18b) {kind}: {fallback} "
              f"columns decoded on the host, want {want_fallback}")
        print(json.dumps({f"decimal_scan_{kind}": {
            "rows": file_rows, "row_groups": groups,
            "device_columns": read - fallback, "fallback_columns": fallback,
            "file_bytes": os.path.getsize(p)}, "card": smi}), flush=True)
        os.remove(p)
    del table, cols, sub
    if on_card:
        release_plans()

    # (c) the expression sweep
    st, c = sweep_table(sweep_rows)
    n = sweep_rows
    s = TorchSession({**test, "spark.rapids.sql.batchSizeRows": str(n)},
                     device=device)
    df = s.createDataFrame(st)
    D_ = decimal.Decimal
    a, b, bn, cc, k = c["a"], c["b"], c["b_null"], c["c"], c["k"]
    none = np.zeros(n, bool)
    big_idx = np.array(sorted(c["w_big"]), np.int64)
    # arithmetic: + - * unary, and the two-limb product past 10^38
    q = df.select((F.col("a") + F.col("b")).alias("add"),
                  (F.col("a") - F.col("b")).alias("sub"),
                  (F.col("a") * F.col("b")).alias("mul"),
                  (-F.col("a")).alias("neg"), F.abs(F.col("c")).alias("abs"),
                  (F.col("w") * F.col("w")).alias("ww"))
    out = q.to_arrow()
    check_unscaled(out, "add", a + b, bn, "(18c) a + b")
    check_unscaled(out, "sub", a - b, bn, "(18c) a - b")
    check_unscaled(out, "mul", a * b, bn, "(18c) a * b")
    check_unscaled(out, "neg", -a, none, "(18c) -a")
    check_unscaled(out, "abs", np.abs(cc), none, "(18c) abs(c)")
    ws = c["w_small"]
    ww_null = none.copy()
    ww_null[big_idx] = True
    # w*w: (38,4)·(38,4) is (38, 6): the exact product at scale 8 HALF_UP
    ws2 = [(_half_up_div(int(v) * int(v), 100)) for v in ws[:DEC_SAMPLE]]
    got = [None if v is None else _unscaled(v, 6, "w*w") for v in
           out.column("ww").slice(0, DEC_SAMPLE).to_pylist()]
    check([g is None for g in got] == ww_null[:DEC_SAMPLE].tolist(),
          "(18c) w*w nulls")
    check(all(g == w for g, w in zip(got, ws2) if g is not None),
          "(18c) w*w differs")
    check(bool(np.asarray(out.column("ww").is_null())[big_idx].all()),
          "(18c) a product past 10^38 is not null")
    check(s.counters["decimal.hostPath.Multiply.product past 10^38"] >= 1,
          "(18c) the product past 10^38 took no host hop")
    print(f"(18c) + - * neg abs at {n} ok; {len(big_idx)} products past "
          "10^38 null", flush=True)
    if on_card:
        best_of_2_line("decimal_arith", reduced(F, q.select(
            "add", "sub", "mul", "neg", "abs")), n, smi)
    ansi = TorchSession({**test, "spark.sql.ansi.enabled": "true",
                         "spark.rapids.sql.batchSizeRows": str(n)},
                        device=device)
    try:
        ansi.createDataFrame(st).select(
            (F.col("w") * F.col("w")).alias("ww")).collect()
        check(False, "(18c) ANSI decimal overflow did not raise")
    except ExpressionError as e:
        check("decimal overflow in multiply" in str(e), f"(18c) ANSI: {e}")
    print("(18c) ANSI decimal overflow raises", flush=True)
    # comparisons across scales: a (12,2) against c (10,4) at (14,4)
    q = df.select((F.col("a") < F.col("c")).alias("lt"),
                  (F.col("a") == F.col("c")).alias("eq"),
                  (F.col("a") >= F.lit(D_("0.50"))).alias("ge"))
    out = q.to_arrow()
    for name, want in (("lt", a * 100 < cc), ("eq", a * 100 == cc),
                       ("ge", a >= 50)):
        got = np.asarray(out.column(name).to_numpy(zero_copy_only=False))
        check(np.array_equal(got, want), f"(18c) comparison {name}")
    # casts each way
    q = df.select(F.col("a").cast("decimal(10,1)").alias("a1"),
                  F.col("c").cast("decimal(8,2)").alias("c2"),
                  F.col("a").cast("int").alias("ai"),
                  F.col("i").cast("decimal(12,2)").alias("id"),
                  F.col("a").cast("double").alias("ad"),
                  F.col("x").cast("decimal(12,2)").alias("xd"),
                  F.col("w").cast("decimal(20,2)").alias("w2"))
    out = q.to_arrow()
    check_unscaled(out, "a1", _np_half_up(a, 10), none, "(18c) a as (10,1)")
    check_unscaled(out, "c2", _np_half_up(cc, 100), none, "(18c) c as (8,2)")
    got = np.asarray(out.column("ai").to_numpy(zero_copy_only=False))
    check(np.array_equal(got, np.where(a < 0, -(-a // 100), a // 100)),
          "(18c) a as int")
    check_unscaled(out, "id", c["i"].astype(np.int64) * 100, none,
                   "(18c) i as (12,2)")
    got = np.asarray(out.column("ad").to_numpy(zero_copy_only=False))
    check(np.array_equal(got, a / 100.0), "(18c) a as double")
    xs = c["x"][:DEC_SAMPLE]
    want = [int(D_(repr(float(v))).quantize(
        D_("0.01"), rounding=decimal.ROUND_HALF_UP).scaleb(2)) for v in xs]
    got, _ = arrow_unscaled(out.slice(0, DEC_SAMPLE), "xd")
    check(got.tolist() == want, "(18c) x as (12,2)")
    w2_null = none.copy()
    w2_null[big_idx] = True  # past 18 integral digits
    check_unscaled(out, "w2", _np_half_up(ws, 100), w2_null,
                   "(18c) w as (20,2)")
    print("(18c) comparisons and casts ok", flush=True)
    if on_card:
        best_of_2_line("decimal_casts", reduced(F, q), n, smi)
    # sum/avg/min/max by a decimal key; a decimal join key; a sort key
    q = df.groupBy("k").agg(F.sum(F.col("a")).alias("sa"),
                            F.avg(F.col("a")).alias("ma"),
                            F.min(F.col("w")).alias("mn"),
                            F.max(F.col("w")).alias("mx"),
                            F.sum(F.col("w")).alias("sw"),
                            F.count(F.col("a")).alias("n")).orderBy("k")
    rows_ = q.collect()
    keys, inv = np.unique(k, return_inverse=True)
    check([_unscaled(r["k"], 2, "key") for r in rows_] == keys.tolist(),
          "(18c) group keys")
    order = np.argsort(inv, kind="stable")
    starts = np.searchsorted(inv[order], np.arange(len(keys)))
    sa = np.add.reduceat(a[order], starts)
    cnt = np.diff(np.append(starts, n))
    wsmall = ws.copy()
    wsmall[big_idx] = 0
    sw = np.add.reduceat(wsmall[order], starts).tolist()
    wmin = np.where(np.isin(np.arange(n), big_idx), 2 ** 62, ws)
    wmax = np.where(np.isin(np.arange(n), big_idx), -2 ** 62, ws)
    mn = np.minimum.reduceat(wmin[order], starts).tolist()
    mx = np.maximum.reduceat(wmax[order], starts).tolist()
    for r_, v in c["w_big"].items():
        g = int(inv[r_])
        sw[g] += v
        mn[g] = min(mn[g], v)
        mx[g] = max(mx[g], v)
    for g, r in enumerate(rows_):
        check(_unscaled(r["sa"], 2, "sum(a)") == int(sa[g]), "(18c) sum(a)")
        q18 = _half_up_div(int(sa[g]) * 10 ** 16, int(cnt[g]))
        check(_unscaled(r["ma"], 6, "avg(a)") == _half_up_div(q18, 10 ** 12),
              "(18c) avg(a)")
        for name, want in (("mn", mn[g]), ("mx", mx[g]), ("sw", sw[g])):
            got = _unscaled(r[name], 4, name)
            check(got == want, f"(18c) {name} of group {g}: {got} != "
                  f"{want}")
        check(r["n"] == int(cnt[g]), "(18c) count")
    if on_card:
        best_of_2_line("decimal_group", q, n, smi)
    # the same aggregates ungrouped over four partitions of n / 4 rows
    # under batchSizeRows n / 4: per-chunk states merged
    gs = TorchSession({**test, "spark.rapids.sql.batchSizeRows":
                       str(max(n // 4, 1))}, device=device)
    gq = gs.createDataFrame(st, num_partitions=4).agg(
        F.sum(F.col("a")).alias("sa"), F.avg(F.col("a")).alias("ma"),
        F.min(F.col("w")).alias("mn"), F.max(F.col("w")).alias("mx"),
        F.sum(F.col("w")).alias("sw"))
    g = gq.collect()[0]
    check(gs.counters["global_chunked_runs"] == 1,
          "(18c) the ungrouped decimal aggregate did not merge chunks")
    total_a = sum(int(v) for v in sa.tolist())
    q18 = _half_up_div(total_a * 10 ** 16, n)
    for name, scale, want in (("sa", 2, total_a),
                              ("ma", 6, _half_up_div(q18, 10 ** 12)),
                              ("mn", 4, min(mn)), ("mx", 4, max(mx)),
                              ("sw", 4, sum(sw))):
        check(_unscaled(g[name], scale, name) == want,
              f"(18c) ungrouped {name}")
    print("(18c) sum/avg/min/max by group and merged over chunks ok",
          flush=True)
    del gs, gq
    import pyarrow as pa
    from spark_rapids_tpu_torch.columnar.vector import decimal_to_arrow
    from spark_rapids_tpu_torch.types import DecimalType
    dim_keys = keys[::2]
    dim = s.createDataFrame(pa.table({
        "k2": decimal_to_arrow(dim_keys, DecimalType(10, 2), None),
        "v": pa.array(np.arange(len(dim_keys), dtype=np.int64))}))
    jq = df.join(dim, df["k"] == dim["k2"]).agg(
        F.count(F.col("v")).alias("n"), F.sum(F.col("v")).alias("sv"),
        F.sum(F.col("a")).alias("sa"))
    jr = jq.collect()[0]
    hit = np.isin(k, dim_keys)
    vpos = np.searchsorted(dim_keys, k[hit])
    check(jr["n"] == int(hit.sum()) and jr["sv"] == int(vpos.sum())
          and _unscaled(jr["sa"], 2, "join sum") == int(a[hit].sum()),
          "(18c) decimal join key")
    sq = df.orderBy(F.col("k").desc(), F.col("i")).select("k", "i")
    out = sq.to_arrow()
    want = np.lexsort((c["i"], -k))
    got, _ = arrow_unscaled(out, "k")
    check(np.array_equal(got, k[want]) and np.array_equal(
        np.asarray(out.column("i").to_numpy()), c["i"][want]),
        "(18c) decimal sort key")
    hq = df.select(F.hash(F.col("a")).alias("h"),
                   F.hash(F.col("w")).alias("hw"))
    out = hq.to_arrow()
    check(np.array_equal(np.asarray(out.column("h").to_numpy()),
                         spark_hash_long(a)), "(18c) murmur3 of decimal64")
    hw = np.asarray(out.column("hw").to_numpy())[:DEC_SAMPLE]
    from spark_rapids_tpu_torch.kernels.decimal128 import limbs_to_int
    wv = np.stack([ws >> 63, ws], 1)[:DEC_SAMPLE]
    want = []
    for j, (h_, l_) in enumerate(wv.tolist()):
        u = c["w_big"].get(j, limbs_to_int(h_, l_))
        nb = (u.bit_length() if u >= 0 else (~u).bit_length()) // 8 + 1
        want.append(murmur3_bytes(u.to_bytes(nb, "big", signed=True)))
    check(hw.tolist() == want, "(18c) murmur3 of decimal128")
    print("(18c) group, join, sort and murmur3 ok", flush=True)
    if on_card:
        best_of_2_line("decimal_sort", reduced(F, sq), n, smi)
    # / % pmod on the card, each row against Python decimal
    dq = s.createDataFrame(st.slice(0, div_rows)).select(
        (F.col("a") / F.col("b")).alias("div"),
        (F.col("a") % F.col("b")).alias("rem"),
        F.pmod(F.col("a"), F.col("b")).alias("pmod"))
    check("CpuProject" not in physical_plan(dq), "(18c) / left the card")
    t0 = time.perf_counter()
    out = dq.to_arrow()
    div_s = time.perf_counter() - t0
    got = {name: out.column(name).to_pylist()
           for name in ("div", "rem", "pmod")}
    ctx = decimal.Context(prec=100, rounding=decimal.ROUND_HALF_UP)
    for j in range(div_rows):
        x, y = int(a[j]), int(b[j])
        if bn[j] or y == 0:
            check(all(got[m][j] is None for m in got), "(18c) / by 0")
            continue
        # Spark: the quotient at scale 38 HALF_UP, then at the type's 15
        qv = ctx.divide(D_(x), D_(y)).quantize(D_(1).scaleb(-38),
                                               context=ctx)
        want_div = qv.quantize(D_(1).scaleb(-15), context=ctx)
        r = _java_rem_int(x, y)
        pm = r if r >= 0 else _java_rem_int(r + y, y)
        check(got["div"][j] == want_div, f"(18c) a / b row {j}")
        check(got["rem"][j] == D_(r).scaleb(-2), f"(18c) a % b row {j}")
        check(got["pmod"][j] == D_(pm).scaleb(-2), f"(18c) pmod row {j}")
    print(f"(18c) / % pmod on the card at {div_rows} ok "
          f"({div_s:.2f} s)", flush=True)
    del df, st, c
    if on_card:
        release_plans()

    # (d) the rounding family, / % pmod and windows
    decimal_rest_paths(F, TorchSession, smi, device, rest_rows, rest_check)
    if on_card:
        release_plans()


def rest_table(n: int, seed: int = 19):
    """(d)'s table: decimal(12, 2) ``a`` and ``b`` over their whole range
    (1 row in 10 with a null), rounding ties placed at scales -1, 0 and 1
    (a ending in 500, 50 or 5, both signs), zero divisors, divisors of
    655.36 under odd dividends (a / b then lies exactly halfway at the
    quotient's 15th place: HALF_UP ties), a partition key ``g`` of 64
    rows each and an order key ``o``."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.columnar.vector import decimal_to_arrow
    from spark_rapids_tpu_torch.types import DecimalType
    rng = np.random.default_rng(seed)
    ids = np.arange(n)
    top = 10 ** 12 - 1
    a = rng.integers(-top, top + 1, n)
    b = rng.integers(-top, top + 1, n)
    sign = np.where(a < 0, -1, 1)
    for rem, unit in ((1, 1000), (2, 100), (3, 10)):
        r = ids % 10 == rem
        a[r] = (np.abs(a[r]) // unit * unit + unit // 2) % (top + 1) \
            * sign[r]
    tie = ids % 64 == 9
    b[tie] = np.where(ids[tie] % 128 == 9, 65536, -65536)
    a[tie] |= 1
    b[ids % 64 == 3] = 0
    a_null = ids % 20 == 7
    b_null = ids % 20 == 17
    a[a_null] = 0
    b[b_null] = 0
    cols = {"a": a, "b": b, "a_null": a_null, "b_null": b_null}
    t = DecimalType(12, 2)
    table = pa.table({
        "a": decimal_to_arrow(a, t, ~a_null),
        "b": decimal_to_arrow(b, t, ~b_null),
        "g": pa.array(ids // 64), "o": pa.array(ids)})
    return table, cols


def _np_round(v: np.ndarray, k: int, mode: str) -> np.ndarray:
    """int64 ``v / 10^k`` rounded HALF_UP, HALF_EVEN, floor or ceiling."""
    m = 10 ** k
    q, r = np.abs(v) // m, np.abs(v) % m
    if mode == "half_up":
        up = 2 * r >= m
    elif mode == "half_even":
        up = (2 * r > m) | ((2 * r == m) & (q % 2 == 1))
    else:
        up = (r != 0) & ((v < 0) if mode == "floor" else (v > 0))
    q = q + up
    return np.where(v < 0, -q, q)


#: (d)'s rounding columns: (name, function, scale)
ROUND_CASES = [(f"{fn}_{tag}", fn, sc) for fn in ("round", "bround")
               for tag, sc in (("m1", -1), ("0", 0), ("1", 1), ("3", 3))] \
    + [("floor", "floor", 0), ("ceil", "ceil", 0)]


def _round_oracle(a: np.ndarray, fn: str, scale: int):
    """(unscaled int64 values, their scale) of ``fn(a, scale)`` over
    decimal(12, 2) ``a`` (Spark 3.4's result types: scale min(2, s') for
    s' >= 0, else 0 with the value a multiple of 10^-s')."""
    mode = {"round": "half_up", "bround": "half_even", "floor": "floor",
            "ceil": "ceil"}[fn]
    if scale >= 2:
        return a, 2
    v = _np_round(a, 2 - scale, mode)
    return (v * 10 ** -scale, 0) if scale < 0 else (v, scale)


def host_path_delta(before: dict, counters) -> dict:
    """``decimal.hostPath.<class>.<reason>`` batches since ``before``."""
    now = {k: v for k, v in counters.items()
           if k.startswith("decimal.hostPath.")}
    return {k[len("decimal.hostPath."):]: v - before.get(k, 0)
            for k, v in now.items() if v != before.get(k, 0)}


def decimal_divmod_line(smi: str, rows: int) -> None:
    """``decimal128.divmod128`` and ``round_pow10`` alone on the card at
    ``rows`` (CUDA events): decimal(12, 2) / decimal(12, 2)'s shape (a
    90-bit dividend, a 40-bit divisor: three digits of long division),
    and a two-limb divisor (127 bits by 100: bit by bit)."""
    from spark_rapids_tpu_torch.kernels import decimal128 as D
    g = torch.Generator(device="cuda").manual_seed(6)
    nh = torch.randint(0, 2 ** 26, (rows,), device="cuda", generator=g)
    nl = torch.randint(-2 ** 63, 2 ** 63 - 1, (rows,), device="cuda",
                       generator=g)
    dl = torch.randint(1, 2 ** 40, (rows,), device="cuda", generator=g)
    wh = torch.randint(0, 2 ** 62, (rows,), device="cuda", generator=g)
    dh = torch.randint(1, 2 ** 35, (rows,), device="cuda", generator=g)
    zero = torch.zeros_like(dl)
    ops = {"divmod128_90_by_40": lambda: D.divmod128(nh, nl, zero, dl,
                                                     90, 40),
           "divmod128_127_by_100": lambda: D.divmod128(wh, nl, dh, dl,
                                                       127, 100),
           "round_pow10_3_half_even": lambda: D.round_pow10(nh, nl, 3,
                                                            "half_even")}
    print(json.dumps({"decimal_divmod_ms": {
        "rows": rows, **{k: time_ms(fn, 3, reps=3, warmup=1)
                         for k, fn in ops.items()}}, "card": smi}),
        flush=True)


def decimal_rest_paths(F, TorchSession, smi, device: str, rows: int,
                       check_rows: int) -> None:
    """Phase 18 (d), in test mode over ``rest_table(rows)``: round and
    bround at scales -1, 0, 1 and 3, floor and ceil; a / b, a % b and
    pmod(a, b); a window sum/avg/min/max over a partitioned, ordered
    frame. Every row of the rounding family, % and pmod against numpy
    oracles; each query's first ``check_rows`` rows (whole partitions)
    exactly equal to the port's host engine over those rows; no decimal
    host hop. On the card a timing line each: best of 2 warm collects,
    busy, idle, device ops, the host-hop batches by class."""
    from spark_rapids_tpu_torch.window import Window
    on_card = device != "cpu"
    st, c = rest_table(rows)
    a, b, an, bn = c["a"], c["b"], c["a_null"], c["b_null"]
    test = {"spark.rapids.sql.test.enabled": "true",
            "spark.rapids.sql.batchSizeRows": str(rows)}
    s = TorchSession(test, device=device)
    host = TorchSession({"spark.rapids.sql.enabled": "false"},
                        device=device)
    df = s.createDataFrame(st)
    hdf = host.createDataFrame(st.slice(0, check_rows))
    fns = {"round": F.round, "bround": F.bround}

    def rounding(d):
        return d.select(*[
            (fns[fn](F.col("a"), sc) if fn in fns else
             getattr(F, fn)(F.col("a"))).alias(name)
            for name, fn, sc in ROUND_CASES])

    def divmod_(d):
        return d.select((F.col("a") / F.col("b")).alias("div"),
                        (F.col("a") % F.col("b")).alias("rem"),
                        F.pmod(F.col("a"), F.col("b")).alias("pmod"))
    run = Window.partitionBy("g").orderBy("o")
    near = Window.partitionBy("g").orderBy("o").rowsBetween(-8, 8)

    def window(d):
        return d.select("o", F.sum(F.col("a")).over(run).alias("ws"),
                        F.avg(F.col("a")).over(run).alias("wa"),
                        F.min(F.col("a")).over(near).alias("wmin"),
                        F.max(F.col("a")).over(near).alias("wmax"))
    for key, build in (("decimal_round", rounding),
                       ("decimal_divmod", divmod_),
                       ("decimal_window", window)):
        q = build(df)
        check("Cpu" not in physical_plan(q).replace(
            "CpuLocalTableScanExec", ""), f"(18d) {key} left the card")
        before = {k: v for k, v in s.counters.items()
                  if k.startswith("decimal.hostPath.")}
        out = q.to_arrow()
        if key == "decimal_window":
            out = out.sort_by("o")
        hops = host_path_delta(before, s.counters)
        check(not hops, f"(18d) {key}: decimal host hops {hops}")
        want = build(hdf).to_arrow()
        if key == "decimal_window":
            want = want.sort_by("o")
        check(out.slice(0, check_rows).equals(want),
              f"(18d) {key}: the card differs from the host engine over "
              f"the first {check_rows} rows")
        if key == "decimal_round":
            for name, fn, sc in ROUND_CASES:
                v, scale = _round_oracle(a, fn, sc)
                check(out.schema.field(name).type.scale == scale,
                      f"(18d) {name}: scale")
                check_unscaled(out, name, v, an, f"(18d) {name}")
        elif key == "decimal_divmod":
            zero = bn | (b == 0)
            safe = np.where(zero, 1, b)
            rem = np.fmod(a, safe)
            pm = np.where((rem < 0) & (safe > 0), rem + safe, rem)
            check_unscaled(out, "rem", rem, an | zero, "(18d) a % b")
            check_unscaled(out, "pmod", pm, an | zero, "(18d) pmod(a, b)")
        print(f"(18d) {key} at {rows} ok (numpy oracles; the host engine "
              f"over {check_rows} rows; no host hop)", flush=True)
        if on_card:
            before = {k: v for k, v in s.counters.items()
                      if k.startswith("decimal.hostPath.")}
            timed_line(key, reduced(F, q), rows, smi,
                       host_path=host_path_delta(before, s.counters))
        del q, out, want
    if on_card:
        decimal_divmod_line(smi, rows)
    del df, hdf, st, c


# ---------------------------------------------------------------------------
# phase 19: Queue C's faults C8-C13 on the card
# ---------------------------------------------------------------------------


def fault_paths(F, TorchSession, device: str = "cuda") -> None:
    """Phase 19: C8-C13's inputs in test mode on the card, each exact:
    a union's wider types (and intersect, except), string <-> timestamp
    casts in the session zone, the date_format letters and the
    week-based refusal, coalesce/isnull of column names, date and
    datetime literals, and -0.0 group, distinct, join and partition
    keys."""
    import datetime as _dt
    import math

    import pyarrow as pa
    from spark_rapids_tpu_torch.window import Window
    D_ = decimal.Decimal
    utc = _dt.timezone.utc
    test = {"spark.rapids.sql.test.enabled": "true"}
    la = {**test, "spark.sql.session.timeZone": "America/Los_Angeles"}
    s = TorchSession(test, device=device)
    # C8: a union column takes its sides' wider type
    i32 = s.createDataFrame(pa.table({"x": pa.array([1, 2], pa.int32())}))
    f64 = s.createDataFrame(pa.table({"x": pa.array([2.75, 5e9])}))
    i64 = s.createDataFrame(pa.table({"x": pa.array([2 ** 40], pa.int64())}))
    d12 = s.createDataFrame(pa.table({"x": pa.array(
        [D_("1.50")], pa.decimal128(12, 2))}))
    d10 = s.createDataFrame(pa.table({"x": pa.array(
        [D_("1.4999")], pa.decimal128(10, 4))}))
    u = i32.union(f64)
    check(u.to_arrow().schema.field("x").type == pa.float64()
          and [r["x"] for r in u.collect()] == [1.0, 2.0, 2.75, 5e9],
          "(19) C8 int union double")
    check([r["x"] for r in i32.union(i64).collect()] == [1, 2, 2 ** 40],
          "(19) C8 int union bigint")
    got = d12.union(d10).to_arrow()
    check(got.schema.field("x").type == pa.decimal128(14, 4)
          and got.column("x").to_pylist() == [D_("1.5000"), D_("1.4999")],
          "(19) C8 decimal(12,2) union decimal(10,4)")
    f2 = s.createDataFrame(pa.table({"x": pa.array([1.5, 2.0, 2.75])}))
    check([r["x"] for r in i32.intersect(f2).collect()] == [2.0]
          and [r["x"] for r in i32.subtract(f2).collect()] == [1.0],
          "(19) C8 intersect and except")
    print("(19) C8 union types ok", flush=True)
    # C9: string <-> timestamp casts in the session zone
    z = TorchSession(la, device=device)
    t = z.createDataFrame([{"t": _dt.datetime(2020, 3, 8, 10, 30,
                                              tzinfo=utc),
                            "s": "2020-02-29 12:00:00"}])
    r = t.select(F.col("t").cast("string").alias("ts"),
                 F.col("s").cast("timestamp").alias("p")).collect()[0]
    check(r["ts"] == "2020-03-08 03:30:00"
          and r["p"] == _dt.datetime(2020, 2, 29, 20, 0, tzinfo=utc),
          f"(19) C9 casts in the session zone: {r}")
    one = s.createDataFrame([{"t": _dt.datetime(1, 1, 1, tzinfo=utc)}])
    r = one.select(F.col("t").cast("string").alias("ts")).collect()[0]
    check(r["ts"] == "0001-01-01 00:00:00", f"(19) C9 year padding: {r}")
    print("(19) C9 timestamp casts ok", flush=True)
    # C10: the pattern letters, and Spark 3's refusal of week-based ones
    df = s.createDataFrame([{
        "d": _dt.date(2020, 1, 31),
        "t": _dt.datetime(2020, 3, 8, 10, 30, 0, 123000, tzinfo=utc)}])
    pats = {"D": "31", "E": "Fri", "MMMM": "January", "y": "2020",
            "hh": "12", "Q": "1"}
    r = df.select(*[F.date_format("d", p).alias(f"p{i}")
                    for i, p in enumerate(pats)],
                  F.date_format("t", "SSS").alias("sss"),
                  F.date_format("t", "XXX").alias("xxx")).collect()[0]
    check([r[f"p{i}"] for i in range(len(pats))] == list(pats.values())
          and r["sss"] == "123" and r["xxx"] == "Z",
          f"(19) C10 date_format letters: {r}")
    try:
        df.select(F.date_format("d", "YYYY").alias("w")).collect()
        check(False, "(19) C10 a week-based pattern did not raise")
    except ValueError as e:
        check("week-based" in str(e), f"(19) C10: {e}")
    print("(19) C10 date_format letters ok", flush=True)
    # C11: coalesce and isnull read column names
    n = s.createDataFrame([{"a": None, "b": "y"}, {"a": "x", "b": "z"}])
    r = n.select(F.coalesce("a", "b").alias("c"),
                 F.isnull("a").alias("n")).collect()
    check(r == [{"c": "y", "n": True}, {"c": "x", "n": False}],
          f"(19) C11 coalesce/isnull of names: {r}")
    print("(19) C11 coalesce and isnull ok", flush=True)
    # C12: date and datetime literals
    r = t.select(F.datediff(F.lit(_dt.date(2020, 3, 8)),
                            F.lit(_dt.date(2000, 1, 1))).alias("dd"),
                 F.lit(_dt.datetime(2020, 1, 1, 12, 0)).cast(
                     "string").alias("wall"),
                 F.lit(_dt.datetime(2020, 1, 1, 12, 0, tzinfo=utc)).cast(
                     "string").alias("inst")).collect()[0]
    check(r == {"dd": 7372, "wall": "2020-01-01 12:00:00",
                "inst": "2020-01-01 04:00:00"},
          f"(19) C12 date and datetime literals: {r}")
    print("(19) C12 literals ok", flush=True)
    # C13: -0.0 keys come out 0.0 and meet 0.0
    fk = s.createDataFrame(pa.table({
        "f": pa.array([float("nan"), 1.0, -0.0, 0.0, None]),
        "v": pa.array([1, 2, 3, 4, 5])}))
    g = {(None if r["f"] is None else
          (math.copysign(1.0, r["f"]), r["f"] if r["f"] == r["f"] else
           "nan")): r["count"] for r in fk.groupBy("f").count().collect()}
    check(g == {None: 1, (1.0, 1.0): 1, (1.0, 0.0): 2, (1.0, "nan"): 1},
          f"(19) C13 group keys: {g}")
    signs = sorted(math.copysign(1.0, r["f"]) for r in
                   fk.select("f").distinct().collect() if r["f"] is not None)
    check(signs == [1.0, 1.0, 1.0], f"(19) C13 distinct keys: {signs}")
    zero = s.createDataFrame(pa.table({"z": pa.array([0.0])}))
    j = sorted(r["v"] for r in fk.join(zero, fk["f"] == zero["z"]).collect())
    check(j == [3, 4], f"(19) C13 join keys: {j}")
    w = {r["v"]: r["c"] for r in fk.select(
        "v", F.count("v").over(Window.partitionBy("f")).alias("c")).collect()}
    check(w[3] == 2 and w[4] == 2, f"(19) C13 window partitions: {w}")
    print("(19) C13 float keys ok", flush=True)


def _java_rem_int(p: int, q: int) -> int:
    """Java's ``%`` of two Python ints: the dividend's sign."""
    r = abs(p) % abs(q)
    return -r if p < 0 else r


def murmur3_bytes(data: bytes, seed: int = 42) -> int:
    """Spark's ``Murmur3_x86_32.hashUnsafeBytes`` in Python (4-byte
    blocks, then each tail byte sign-extended)."""
    M = 0xFFFFFFFF

    def mix_k(k):
        k = (k * 0xCC9E2D51) & M
        return (((k << 15) | (k >> 17)) & M) * 0x1B873593 & M

    def mix_h(h, k):
        h ^= k
        h = ((h << 13) | (h >> 19)) & M
        return (h * 5 + 0xE6546B64) & M
    h = seed
    n4 = len(data) // 4 * 4
    for i in range(0, n4, 4):
        h = mix_h(h, mix_k(int.from_bytes(data[i:i + 4], "little")))
    for b in data[n4:]:
        h = mix_h(h, mix_k((b - 256 if b > 127 else b) & M))
    h ^= len(data)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M
    h ^= h >> 16
    return h - (1 << 32) if h >= 1 << 31 else h



def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "--strings-prep":
        # phase 13's CPU answers, tables and oracles, beside the card's run
        torch.set_num_threads(2)
        strings_prep(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return 0
    if len(sys.argv) == 4 and sys.argv[1] == "--tpcds-cpu":
        # phase 12's CPU answers, beside the card's run: two threads, so
        # the card's host side keeps its cores
        torch.set_num_threads(2)
        tpcds_cpu_answers(int(sys.argv[2]), sys.argv[3])
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import spark_rapids_tpu_torch  # noqa: F401  (fails outside the repo)

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
    has_pandas = subprocess.run([sys.executable, "-c", "import pandas"],
                                capture_output=True).returncode == 0
    # toPandas() needs it; phase 16 checks it where it imports
    print(f"import pandas: {'ok' if has_pandas else 'fails'}", flush=True)
    check(has_pyarrow, "pyarrow does not import: the parquet scan needs it")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in f32
    if sys.argv[1:] and set(sys.argv[1:]) <= {"--phase18", "--phase19"}:
        # phase 18 and/or 19 alone (no kernel build, no contract line)
        import spark_rapids_tpu_torch.functions as F
        from spark_rapids_tpu_torch.session import TorchSession
        if "--phase18" in sys.argv:
            with tempfile.TemporaryDirectory(
                    prefix="chip_smoke_decimal_") as d:
                decimal_paths(F, TorchSession, smi, d)
            print("phase 18 alone: ok", flush=True)
        if "--phase19" in sys.argv:
            fault_paths(F, TorchSession)
            print("phase 19 alone: ok", flush=True)
        return 0
    if sys.argv[1:] == ["--phase17"]:
        # phase 17 alone (no kernel build, no contract line): the quickest
        # look at the scalar functions on the card
        import spark_rapids_tpu_torch.functions as F
        from spark_rapids_tpu_torch.session import TorchSession
        with tempfile.TemporaryDirectory(prefix="chip_smoke_scalar_") as d:
            scalar_paths(F, TorchSession, smi, d)
        print("phase 17 alone: ok", flush=True)
        return 0

    clock = PhaseClock(smi)
    # phase 12's CPU answers and phase 13's host work, done meanwhile by
    # processes of their own
    cpu_answers = CpuAnswers(TPCDS_SMALL, start=True)
    prep = StringsPrep(STR_SMALL, STR_BIG, start=True)
    try:
        return run_phases(smi, name, mem_bps, f32_ops, tf32_ops, clock,
                          cpu_answers, prep)
    finally:
        cpu_answers.close()
        prep.close()


def run_phases(smi, name, mem_bps, f32_ops, tf32_ops, clock,
               cpu_answers, prep) -> int:
    """Phases 2-19 (``main`` prints phase 1 and starts phase 12's CPU
    answers and phase 13's host work)."""
    from spark_rapids_tpu_torch.entry import entry
    from spark_rapids_tpu_torch.kernels import build, q1_cuda
    from spark_rapids_tpu_torch.kernels.q1 import (make_example_batch,
                                                   q1_group_and_measures,
                                                   q1_reference_numpy)
    from spark_rapids_tpu_torch.kernels.q1_cuda import mma_blocks, simt_plan
    from spark_rapids_tpu_torch.session import TorchSession
    import spark_rapids_tpu_torch.functions as F
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
        device_ms, per_op, _ = profile_device(
            lambda: kernel(big, big_cut), 50, need=f"{kname}_kernel")
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

    clock.mark(5)  # phases 1-5: the card, build, kernels, main path, timing

    # 6. both device paths of the planning route
    general_paths(F, TorchSession, df, cols, oracle, smi)
    del q, big  # phase 4's cached lineitem stays for phase 11
    release_plans()
    clock.mark(6)

    # 7. TPC-H q3: joins, the hash exchange, TopN, the star-join stage
    tables: dict = {}
    q3_paths(F, TorchSession, smi, tables=tables)
    release_plans()
    clock.mark(7)

    # 8. TPC-H q4, q13 and q18; every hash-join type; LIKE
    tpch_more_paths(F, TorchSession, smi, tables)
    release_plans()
    clock.mark(8)

    # 9. the parquet scan: bench.py's scan_agg queries and Q1 from parquet,
    # at 2^22 rows (bench.py: 2^24; cut for phases 16 and 18's time)
    scan_keep: dict = {}  # the file phase 15 reads again
    scan_paths(F, TorchSession, smi, rows=SCAN_ROWS, keep=scan_keep)
    release_plans()
    clock.mark(9)

    # 10. the other 16 TPC-H queries over phase 8's 2^22-row tables
    keep: dict = {}  # tables and oracles phase 14 takes from 10, 12, 13
    tpch_rest_paths(F, TorchSession, smi, tables, keep=keep)
    release_plans()
    clock.mark(10)

    # 11. the query lifecycle: hot_repeat, serving, the memory runtime,
    # deadline and cancel
    lifecycle_paths(F, TorchSession, smi, tables, df, cols, oracle)
    clock.mark(11)
    for key in [k for k in tables if k != (1 << 22, 4)]:
        del tables[key]  # phase 10's tables stay for phases 14 and 15
    release_plans()

    # 12. the 99 TPC-DS queries: the card against the port's CPU answers
    # at 12,000 rows; at 2^20 rows in test mode, eight against numpy
    # oracles, and a timing line each. It launches neither Q1 kernel.
    before = dict(q1_cuda.launches)
    tpcds_paths(F, TorchSession, smi, cpu_answers=cpu_answers, keep=keep)
    check(dict(q1_cuda.launches) == before, "phase 12 launched a Q1 kernel")
    release_plans()
    clock.mark(12)

    # 13. strings and regex: the card against the port's CPU answers at
    # 12,000 rows; at 2^22 rows against pyarrow/Python oracles, the host
    # hops counted. It launches neither Q1 kernel.
    before = dict(q1_cuda.launches)
    strings_paths(F, TorchSession, smi, prep=prep)
    check(dict(q1_cuda.launches) == before, "phase 13 launched a Q1 kernel")
    release_plans()
    clock.mark(13)

    # 14. fallback on the card: the 22 TPC-H queries in the host engine;
    # each exec switch (an expression, a cast switch) off in turn, mixed
    # plans against the all-card answer; what a fallback costs. It
    # launches neither Q1 kernel.
    before = dict(q1_cuda.launches)
    fallback_paths(F, TorchSession, smi, tables, keep)
    check(dict(q1_cuda.launches) == before, "phase 14 launched a Q1 kernel")
    del keep
    release_plans()
    clock.mark(14)

    # 15. observability on the card: traced framework Q1, q3 general and
    # scan_agg (bundles, span trees, artifacts), hot_repeat's planning
    # share, the tracer's price, the sync ledger against every sync torch
    # reports, the profiler
    obs_paths(F, TorchSession, smi, tables, df, cols, oracle,
              scan_keep["scan"])
    del df, cols
    release_plans()
    clock.mark(15)

    # 16. the DataFrame and session surface: range, sample, repartition
    # and coalesce, the writer and its formats read back, cache() and the
    # actions, in test mode over phase 10's 2^22-row lineitem. It launches
    # neither Q1 kernel.
    before = dict(q1_cuda.launches)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_surface_") as d:
        surface_paths(F, TorchSession, smi,
                      tpch_host(tables, 1 << 22, 4, ("lineitem",))
                      ["lineitem"], d)
    check(dict(q1_cuda.launches) == before, "phase 16 launched a Q1 kernel")
    tables.clear()
    release_plans()
    clock.mark(16)

    # 17. the scalar functions: dates and timestamps in the session zone,
    # math, integral arithmetic with ANSI, bitwise, NaN handling, hashes,
    # partition and row ids, rand, the input file; in test mode over the
    # 2^22-row events table. It launches neither Q1 kernel.
    before = dict(q1_cuda.launches)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scalar_") as d:
        scalar_paths(F, TorchSession, smi, d)
    check(dict(q1_cuda.launches) == before, "phase 17 launched a Q1 kernel")
    release_plans()
    clock.mark(17)

    # 18. decimals: Q1 and Q6 over decimal(12, 2) measures, cached and from
    # parquet (INT64-backed and FIXED_LEN_BYTE_ARRAY), an expression
    # sweep, and the rounding family, / % pmod and windows, in test mode.
    # It launches neither Q1 kernel.
    before = dict(q1_cuda.launches)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_decimal_") as d:
        decimal_paths(F, TorchSession, smi, d)
    check(dict(q1_cuda.launches) == before, "phase 18 launched a Q1 kernel")
    release_plans()
    clock.mark(18)

    # 19. Queue C's faults C8-C13 on the card, exact. It launches neither
    # Q1 kernel.
    before = dict(q1_cuda.launches)
    fault_paths(F, TorchSession)
    check(dict(q1_cuda.launches) == before, "phase 19 launched a Q1 kernel")
    release_plans()
    clock.mark(19)

    print(kernels_line, flush=True)  # again, near the end of the output
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
