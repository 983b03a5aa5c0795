"""The port's counterparts of two ``bench.py`` stages that run on the query
lifecycle: ``hot_repeat`` (``bench.py:421``) and ``serving``
(``benchmarks/serving.py``). Both drive real sessions through the
scheduler; ``chip_smoke.py`` runs them on the card and checks their rows.

* :func:`run_repeated` — N literal-varying submissions of one query shape:
  the first plans cold and seeds the plan cache, every later one re-binds
  its literals into the cached template. Reports the first, steady and
  warm-p50 wall times and the plan cache's hit and miss deltas; when the
  session traces (``spark.rapids.tpu.trace.enabled``), each submission's
  ``plan.build`` time and end-to-end time from its bundle, and the steady
  planning share (their sums over the submissions after the first), as
  the reference's hot_repeat reads them (``bench.py:421-490``).
* :func:`serving_run` — N tenant threads, each its own session and tables,
  an SLO class each (round-robin over ``CLASS_OF``), running q1, q6 and q3
  ``reps`` times through the scheduler's admission path. Reports rows/s
  over the stage wall, per-class p50/p95 latency, the p95 admission wait
  and the shed count, and returns every non-shed result for the caller's
  oracle.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

#: q3's five market segments, in ``bench.py``'s order
SEGMENTS = ("BUILDING", "AUTOMOBILE", "MACHINERY", "HOUSEHOLD", "FURNITURE")

#: tenant class mix of ``benchmarks/serving.py``: one interactive tenant in
#: three
CLASS_OF = ("interactive", "batch", "background")


def q6_variant(li, i: int, F):
    """``bench.py``'s q6 submission i: the shipdate lower bound and the
    quantity cut vary (same plan shape, other literal values)."""
    return (li.filter((F.col("l_shipdate") >= 8766 + i)
                      & (F.col("l_shipdate") < 9131)
                      & (F.col("l_discount") >= 0.05)
                      & (F.col("l_discount") <= 0.07)
                      & (F.col("l_quantity") < 24 + (i % 3)))
            .agg(F.sum(F.col("l_extendedprice") * F.col("l_discount"))
                 .alias("revenue")))


def q6_literals(i: int):
    """(shipdate lower bound, quantity cut) of submission i."""
    return 8766 + i, 24 + (i % 3)


def q3_variant(t, i: int, F, limit: Optional[int] = 10):
    """``bench.py``'s q3 submission i: the market segment cycles through
    ``SEGMENTS``. ``limit=None`` leaves out ORDER BY/LIMIT (every group)."""
    li, orders, cust = t["lineitem"], t["orders"], t["customer"]
    q = (cust.filter(F.col("c_mktsegment") == SEGMENTS[i % len(SEGMENTS)])
         .join(orders, on=cust["c_custkey"] == orders["o_custkey"])
         .join(li, on=orders["o_orderkey"] == li["l_orderkey"])
         .withColumn("revenue", F.col("l_extendedprice")
                     * (1 - F.col("l_discount")))
         .groupBy("o_orderkey", "o_orderdate")
         .agg(F.sum(F.col("revenue")).alias("revenue")))
    if limit is None:
        return q
    return q.sort(F.col("revenue").desc()).limit(limit)


def _p50(vals):
    xs = sorted(vals)
    return xs[len(xs) // 2] if xs else None


def _percentile(vals, q: float):
    if not vals:
        return None
    s = sorted(vals)
    return s[min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))]


def _cache_stats() -> Dict:
    from .scheduler import QueryScheduler
    inst = QueryScheduler.peek()
    return dict(inst.plan_cache.stats()) if inst is not None else {}


def run_repeated(session, make_query: Callable, iters: int = 6,
                 sync: Callable[[], None] = lambda: None) -> Dict:
    """Submit ``make_query(i)`` for i < iters, timing each ``collect()``
    (``sync`` waits for the device after it). Returns the timings, the
    plan cache's verdict per submission, its hit/miss deltas and every
    submission's rows."""
    st0 = _cache_stats()
    walls, verdicts, rows, profiles = [], [], [], []
    for i in range(iters):
        q = make_query(i)
        t0 = time.perf_counter()
        out = q.collect()
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
        verdicts.append(getattr(session, "_last_plan_cache", None))
        rows.append(out)
        profiles.append(session.last_query_profile())
    st1 = _cache_stats()
    steady = walls[1:] or walls
    out = {"iters": iters, "first_ms": walls[0],
           "steady_ms": min(steady), "warm_p50_ms": _p50(steady),
           "hits": st1.get("hits", 0) - st0.get("hits", 0),
           "misses": st1.get("misses", 0) - st0.get("misses", 0),
           "cache_by_iter": verdicts, "rows": rows}
    if all(p is not None for p in profiles):
        plan = [plan_build_ms(p["spans"]) for p in profiles]
        e2e = [p["duration_ms"] or w for p, w in zip(profiles, walls)]
        out.update(plan_ms=plan, e2e_ms=e2e,
                   planning_share=sum(plan[1:] or plan)
                   / (sum(e2e[1:] or e2e) or 1.0))
    return out


def plan_build_ms(span) -> float:
    """The summed ``plan.build`` span time (ms) of a bundle's span tree."""
    total, stack = 0.0, [span]
    while stack:
        nd = stack.pop()
        if nd.get("name") == "plan.build" and nd.get("dur_ns"):
            total += nd["dur_ns"] / 1e6
        stack.extend(nd.get("children") or ())
    return total


def serving_run(n_sessions: int, host_tables: Dict, reps: int = 2,
                max_concurrent: int = 4, shed_after_ms: float = 500.0,
                queries=("q1", "q6", "q3"), device=None,
                sync: Callable[[], None] = lambda: None) -> Dict:
    """One serving round: N tenant threads × `reps` passes over the mixed
    query set, every tenant with its own session and DataFrames over
    ``host_tables`` (``datagen.tpch_host_tables``). A shed submission is
    counted, not retried. Returns the summary and ``results``: (tenant,
    query, rows) of every query that was not shed."""
    from .. import tpch
    from ..datagen import tpch_frames
    from ..session import TorchSession
    from .query_context import QueryShed

    rows_in = len(host_tables["lineitem"][0]["l_orderkey"])
    barrier = threading.Barrier(n_sessions)
    lock = threading.Lock()
    per_query: List = []  # (cls, wall_ms, admit_wait_ms)
    sheds: List = []
    errors: List[str] = []
    results: List = []

    def tenant(i: int) -> None:
        cls = CLASS_OF[i % len(CLASS_OF)]
        s = TorchSession({
            "spark.sql.shuffle.partitions": "4",
            "spark.rapids.tpu.query.priority": cls,
            "spark.rapids.tpu.sched.maxConcurrentQueries":
                str(max_concurrent),
            "spark.rapids.tpu.sched.shedAfterMs": str(shed_after_ms),
        }, device=device)
        try:
            t = tpch_frames(s, host_tables, parts=2)
            barrier.wait(timeout=300)
            for _rep in range(reps):
                for qname in queries:
                    q = getattr(tpch, qname)(t)
                    t0 = time.perf_counter()
                    # interactive tenants submit WITH a generous deadline
                    # so EDF ordering within the class is live
                    out = q.collect(
                        timeout=300 if cls == "interactive" else None)
                    sync()
                    wall_ms = (time.perf_counter() - t0) * 1e3
                    if isinstance(out, QueryShed):
                        with lock:
                            sheds.append((cls, out.retry_after_s))
                        # honor the hint (bounded), never resubmit
                        time.sleep(min(out.retry_after_s, 0.25))
                        continue
                    with lock:
                        per_query.append((cls, wall_ms,
                                          s.last_admit_wait_ms()))
                        results.append((i, qname, out))
        except Exception as e:  # noqa: BLE001 — summarized per tenant
            with lock:
                errors.append(f"{cls}[{i}]: {type(e).__name__}: {e}")
        finally:
            s.stop()

    t_start = time.perf_counter()
    threads = [threading.Thread(target=tenant, args=(i,),
                                name=f"serving-tenant-{i}", daemon=True)
               for i in range(n_sessions)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall_s = time.perf_counter() - t_start
    classes = {}
    for cls in CLASS_OF[:max(1, min(n_sessions, len(CLASS_OF)))]:
        walls = [w for c, w, _a in per_query if c == cls]
        waits = [a for c, _w, a in per_query if c == cls and a is not None]
        n_shed = sum(1 for c, _h in sheds if c == cls)
        if not walls and not n_shed:
            continue
        classes[cls] = {"n": len(walls), "shed": n_shed,
                        "p50_ms": _percentile(walls, 0.50),
                        "p95_ms": _percentile(walls, 0.95),
                        "admit_wait_p95_ms": _percentile(waits, 0.95)}
    all_waits = [a for _c, _w, a in per_query if a is not None]
    return {"sessions": n_sessions, "rows": rows_in, "reps": reps,
            "max_concurrent": max_concurrent,
            "shed_after_ms": shed_after_ms, "wall_s": wall_s,
            "queries_done": len(per_query), "shed_total": len(sheds),
            "rows_per_s": (rows_in * len(per_query) / wall_s
                           if wall_s > 0 else None),
            "admit_wait_p95_ms": _percentile(all_waits, 0.95),
            "classes": classes, "errors": errors or None,
            "results": results}
