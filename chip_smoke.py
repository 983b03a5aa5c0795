"""Smoke run of the PyTorch/CUDA port on one GPU: TPC-H Q1 end to end.

    python3 chip_smoke.py

Phases (any failure exits nonzero; without a CUDA device it exits 2 and
prints no result):

1. the card: name and power limit as nvidia-smi reports them;
2. build: both Q1 kernels from spark_rapids_tpu_torch/csrc with nvcc for
   sm_90a;
3. kernels: each kernel against its plain PyTorch version on the card at
   n in {100, 12345, 2^15, 2^24} and with a validity mask (counts exact,
   sums rtol 1e-4);
4. main path, with every launch counter set to 0 first: entry()'s step at
   2^16 rows, q1_step_best("cuda") at 2^24 and the tensor-core step at 2^24,
   each against the numpy oracle; then framework Q1 at 2^24 rows through
   TorchSession → device_cache → DataFrame → compiled aggregation stage,
   against a numpy float64 oracle (keys and counts exact, rtol 1e-9); the
   counters must show every kernel launched;
5. timing: each kernel's median time by CUDA events against its bound, its
   plain version's time, and the framework's best-of-5 warm collect().

The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

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
#: f32 ops a row for the masked reductions: 16 groups x 6 measures x 2
SIMT_OPS_PER_ROW = 192
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
    """torch.profiler over `iters` calls: (device-busy ms per call, the
    five device ops with most time as (name, ms per call)). Busy time sums
    the device time of every kernel and copy."""
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
    return sum(ms for _, ms in per_op), [(k[:60], ms) for k, ms in per_op[:5]]


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from spark_rapids_tpu_torch.entry import entry
    from spark_rapids_tpu_torch.kernels import build, q1_cuda
    from spark_rapids_tpu_torch.kernels.q1 import (make_example_batch,
                                                   q1_reference_numpy)
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
        if "registers" in line or "spill" in line:
            print("  " + line.strip())

    # 3. each kernel against its plain version on the card
    kernels = {"q1_agg_simt": (q1_cuda.q1_agg_simt, q1_cuda.q1_agg_simt_plain),
               "q1_agg_mma": (q1_cuda.q1_agg_mma, q1_cuda.q1_agg_mma_plain)}
    max_err = {k: 0.0 for k in kernels}
    cases = [(n, None) for n in SIZES] + [(1 << 12, 3), (N_BIG, 3)]
    for n, mask_every in cases:
        batch, cutoff = make_example_batch(n, seed=7, device="cuda")
        if mask_every:
            batch.valid[::mask_every] = False
        for kname, (kernel, plain) in kernels.items():
            before = q1_cuda.launches[kname]
            err = compare_sums(kernel(batch, cutoff), plain(batch, cutoff),
                               f"{kname} n={n} mask={mask_every}")
            check(q1_cuda.launches[kname] == before + 1,
                  f"{kname} launch counter did not rise")
            if n == N_BIG and mask_every is None:
                max_err[kname] = err
        print(f"kernels vs plain ok: n={n} mask={mask_every}", flush=True)

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
    lines = []
    for kname, (kernel, plain) in kernels.items():
        ops_per_row = SIMT_OPS_PER_ROW if kname == "q1_agg_simt" \
            else MMA_OPS_PER_ROW
        peak = f32_ops if kname == "q1_agg_simt" else tf32_ops
        bytes_ms = (BYTES_PER_ROW * N_BIG + 16 * q1_cuda.WIDTH[kname] * 4) \
            / mem_bps * 1e3
        ops_ms = ops_per_row * N_BIG / peak * 1e3
        device_ms, _ = profile_device(lambda: kernel(big, big_cut), 10)
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
            "library_ms": None, "rows": N_BIG})
    print(json.dumps({"kernels": lines, "card": smi}), flush=True)

    rows = q.collect()  # warm-up
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        rows = q.collect()
        best = min(best, time.perf_counter() - t0)
    check_framework_rows(rows, oracle)
    busy_ms, top = profile_device(q.collect, 1)
    print(json.dumps({"framework_q1": {
        "rows": N_BIG, "best_collect_s": best,
        "mrows_per_s": N_BIG / best / 1e6, "device_cache_s": cache_s,
        "batches": len(df._plan.batches()),
        "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / (best * 1e3),
        "top_device_ops_ms": top}, "card": smi}), flush=True)
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
