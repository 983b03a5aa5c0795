"""explain("metrics"): the executed physical plan annotated per node with
its actual metrics, dispatch counts and blocking-sync counts.

Port of ``spark_rapids_tpu/obs/explain.py`` (the Spark SQL UI analogue,
reference GpuExec SQLMetrics rendered on the plan graph). Works without
the tracer: the inputs are the session's always-captured snapshots (plan
tree, metric snapshot, sync-ledger delta).

Sync counts attribute by OPERATOR NAME (the SyncLedger's thread-local scope
granularity): two nodes of the same class share one ledger bucket, and the
annotation says so (``syncs[class]``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

_LEVELS = {"ESSENTIAL": 0, "MODERATE": 1, "DEBUG": 2}

#: metric names rendered as durations (the engine records ns)
_TIME_SUFFIXES = ("Time", "TimeNs", "WaitNs", "Ns")


def _fmt_val(name: str, v: int) -> str:
    if any(name.endswith(s) for s in _TIME_SUFFIXES) and isinstance(
            v, (int, float)) and v >= 10_000:
        return f"{v / 1e6:.1f}ms"
    if isinstance(v, int) and v >= 10_000:
        return f"{v:,}"
    return str(v)


def render_explain_metrics(plan_tree: List[Dict[str, Any]],
                           metrics: Dict[str, Dict[str, tuple]],
                           sync_ledger: Optional[Dict[str, Dict[str, int]]]
                           = None,
                           level: str = "MODERATE") -> str:
    """Render the annotated tree. ``plan_tree`` is the session's per-node
    snapshot ({"i","depth","name","desc","tpu"} in collect_nodes preorder);
    ``metrics`` is the snapshot_plan_metrics form ({"i:Name": {metric:
    (value, level)}})."""
    if not plan_tree:
        return "<no executed query: run a collect() first>"
    want = _LEVELS.get(str(level).upper(), 1)
    sync_ledger = sync_ledger or {}
    # class-name collision detection for the honest "[class]" marker
    name_counts: Dict[str, int] = {}
    for n in plan_tree:
        name_counts[n["name"]] = name_counts.get(n["name"], 0) + 1
    lines: List[str] = []
    for n in plan_tree:
        key = f"{n['i']}:{n['name']}"
        vals = metrics.get(key, {})
        shown = {m: v for m, (v, lvl) in vals.items()
                 if _LEVELS.get(lvl, 1) <= want and v}
        parts = ["  " * n["depth"] + ("*" if n.get("tpu") else " ") + " "
                 + n["desc"]]
        ann = []
        # dispatch accounting rides the per-exec opjit metrics
        hits = vals.get("opJitCacheHits", (0, None))[0]
        misses = vals.get("opJitCacheMisses", (0, None))[0]
        core = {m: v for m, v in shown.items()
                if not m.startswith("opJit")}
        if core:
            ann.append("metrics: " + ", ".join(
                f"{m}={_fmt_val(m, v)}" for m, v in sorted(core.items())))
        if hits or misses:
            ann.append(f"dispatches: {hits + misses} "
                       f"(hits={hits} misses={misses})")
        syncs = sync_ledger.get(n["name"])
        if syncs:
            tag = "[class]" if name_counts[n["name"]] > 1 else ""
            ann.append(f"syncs{tag}: " + ", ".join(
                f"{k}={v}" for k, v in sorted(syncs.items())))
        if ann:
            parts.append("  " * n["depth"] + "     | " + " | ".join(ann))
        lines.extend(parts)
    return "\n".join(lines)
