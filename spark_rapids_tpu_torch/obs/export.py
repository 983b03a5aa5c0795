"""Exports over one raw tracer profile: Chrome trace JSON, the span tree,
and the per-query diagnostics bundle.

Port of ``spark_rapids_tpu/obs/export.py`` (docs/observability.md "Bundle
schema"); three views of the SAME ring record:

* :func:`chrome_trace` — trace-event JSON loadable in perfetto or
  ``chrome://tracing``;
* :func:`span_tree` — the nested query → task → operator → shuffle-map
  structure with per-span instant events;
* :func:`build_bundle` — the machine-readable diagnostics bundle
  (``session.last_query_profile()``), including per-operator dispatch and
  sync counts RECONCILED against the ``execs/opjit`` ``calls_by_kind``
  delta and the SyncLedger delta for the same query — a mismatch (other
  than ring-buffer overflow) marks the bundle unreconciled rather than
  silently disagreeing.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

from .tracer import (REC_ARGS, REC_CAT, REC_NAME, REC_OP, REC_PARENT,
                     REC_PHASE, REC_SPAN, REC_TID, REC_TS)


def span_tree(profile: Dict[str, Any]) -> Dict[str, Any]:
    """Reconstruct the span tree from the raw ring. Spans whose begin
    record was overwritten (ring overflow) are dropped; spans recorded on
    threads with no open parent attach to the query root."""
    root_id = profile["root"]
    nodes: Dict[int, Dict[str, Any]] = {}
    order: List[int] = []
    for rec in profile["events"]:
        ph = rec[REC_PHASE]
        if ph == "B":
            nodes[rec[REC_SPAN]] = {
                "id": rec[REC_SPAN], "name": rec[REC_NAME],
                "cat": rec[REC_CAT], "op": rec[REC_OP],
                "tid": rec[REC_TID], "t_start_ns": rec[REC_TS],
                "dur_ns": None, "parent": rec[REC_PARENT],
                "args": rec[REC_ARGS] or {}, "children": [], "events": []}
            order.append(rec[REC_SPAN])
        elif ph == "E":
            n = nodes.get(rec[REC_SPAN])
            if n is not None:
                n["dur_ns"] = rec[REC_TS] - n["t_start_ns"]
        else:  # instant
            n = nodes.get(rec[REC_SPAN]) if rec[REC_SPAN] else None
            target = n if n is not None else nodes.get(root_id)
            if target is not None:
                target["events"].append({
                    "name": rec[REC_NAME], "cat": rec[REC_CAT],
                    "op": rec[REC_OP], "t_ns": rec[REC_TS],
                    "args": rec[REC_ARGS] or {}})
    root = nodes.get(root_id)
    if root is None:  # root begin overwritten: synthesize
        root = {"id": root_id, "name": profile.get("name", "query"),
                "cat": "query", "op": None, "tid": None, "t_start_ns": 0,
                "dur_ns": profile.get("duration_ns"), "parent": None,
                "args": {}, "children": [], "events": []}
        nodes[root_id] = root
    for sid in order:
        if sid == root_id:
            continue
        n = nodes[sid]
        parent = nodes.get(n["parent"]) if n["parent"] is not None else None
        (parent if parent is not None else root)["children"].append(n)
    for n in nodes.values():
        n.pop("parent", None)
    return root


def chrome_trace(profile: Dict[str, Any],
                 process_name: str = "spark-rapids-tpu") -> Dict[str, Any]:
    """Chrome trace-event JSON (the "JSON object format"): open in perfetto
    (ui.perfetto.dev → Open trace) or chrome://tracing. B/E pairs are
    emitted per thread in record order, which the per-thread span stacks
    guarantee to be properly nested."""
    evs: List[Dict[str, Any]] = []
    tids = set()
    opened = set()
    for rec in profile["events"]:
        ph = rec[REC_PHASE]
        ts_us = rec[REC_TS] / 1e3
        tids.add(rec[REC_TID])
        if ph == "B":
            opened.add(rec[REC_SPAN])
            args = dict(rec[REC_ARGS] or {})
            if rec[REC_OP]:
                args.setdefault("op", rec[REC_OP])
            evs.append({"ph": "B", "name": rec[REC_NAME],
                        "cat": rec[REC_CAT], "ts": ts_us, "pid": 1,
                        "tid": rec[REC_TID], "args": args})
        elif ph == "E":
            # ring overflow can evict a long-lived span's B while its E
            # survives; a stray E would pop the wrong slice in the viewer
            # (same orphan handling as span_tree)
            if rec[REC_SPAN] not in opened:
                continue
            evs.append({"ph": "E", "ts": ts_us, "pid": 1,
                        "tid": rec[REC_TID]})
        else:
            args = dict(rec[REC_ARGS] or {})
            if rec[REC_OP]:
                args.setdefault("op", rec[REC_OP])
            evs.append({"ph": "i", "s": "t", "name": rec[REC_NAME],
                        "cat": rec[REC_CAT], "ts": ts_us, "pid": 1,
                        "tid": rec[REC_TID], "args": args})
    meta = [{"ph": "M", "name": "process_name", "pid": 1,
             "args": {"name": process_name}}]
    meta += [{"ph": "M", "name": "thread_name", "pid": 1, "tid": t,
              "args": {"name": f"thread-{t}"}} for t in sorted(tids)]
    return {"traceEvents": meta + evs,
            "displayTimeUnit": "ms",
            "otherData": {"query": profile.get("name"),
                          "dropped_events": profile.get("dropped", 0)}}


def _counts(profile: Dict[str, Any]):
    """Aggregate instant events: (by_operator, dispatch_by_kind, sync_total,
    event_counts_by_cat, chaos_events, retry_events)."""
    by_op: Dict[str, Dict[str, Dict[str, int]]] = {}
    disp_by_kind: Dict[str, int] = {}
    by_cat: Dict[str, int] = {}
    chaos: List[Dict[str, Any]] = []
    retries: List[Dict[str, Any]] = []
    sync_total = 0
    for rec in profile["events"]:
        if rec[REC_PHASE] != "i":
            continue
        cat = rec[REC_CAT]
        by_cat[cat] = by_cat.get(cat, 0) + 1
        args = rec[REC_ARGS] or {}
        op = rec[REC_OP] or "<unattributed>"
        slot = by_op.setdefault(op, {})
        if cat == "dispatch":
            kind = str(args.get("kind", "?"))
            d = slot.setdefault("dispatches", {})
            d[kind] = d.get(kind, 0) + 1
            c = slot.setdefault("dispatch_cache", {})
            hit = str(args.get("cache", "?"))
            c[hit] = c.get(hit, 0) + 1
            if args.get("source") == "opjit" or args.get("cache") == "extern":
                # "extern" = launches recorded into calls_by_kind from
                # outside the opjit cache (opjit.record_external_dispatch,
                # e.g. the parquet device-decode programs) — they must
                # count here too or reconciliation would always fail
                disp_by_kind[kind] = disp_by_kind.get(kind, 0) + 1
        elif cat == "sync":
            kind = str(args.get("kind", "?"))
            s = slot.setdefault("syncs", {})
            s[kind] = s.get(kind, 0) + 1
            sync_total += 1
        elif cat == "chaos":
            chaos.append({"span": rec[REC_SPAN], "op": op,
                          "t_ns": rec[REC_TS], **args})
        elif cat == "retry":
            retries.append({"span": rec[REC_SPAN], "op": op,
                            "t_ns": rec[REC_TS], **args})
        else:
            e = slot.setdefault("events", {})
            e[rec[REC_NAME]] = e.get(rec[REC_NAME], 0) + 1
    return by_op, disp_by_kind, sync_total, by_cat, chaos, retries


def build_bundle(profile: Dict[str, Any],
                 plan_tree: Optional[List[Dict[str, Any]]] = None,
                 metrics: Optional[Dict[str, Dict[str, int]]] = None,
                 sync_ledger: Optional[Dict[str, Dict[str, int]]] = None,
                 dispatch_delta: Optional[Dict[str, int]] = None,
                 task_metrics: Optional[Dict[str, int]] = None
                 ) -> Dict[str, Any]:
    """The machine-readable per-query diagnostics bundle
    (docs/observability.md "Bundle schema"). `sync_ledger` and
    `dispatch_delta` are the SAME-query deltas of the SyncLedger and of
    ``execs/opjit.cache_stats()["calls_by_kind"]`` — the bundle's own
    event counts must reconcile with them exactly unless the ring
    overflowed. The reference's ``mesh`` section waits for the port's
    multi-device plane; like a reference session without a mesh, the
    bundle has none."""
    by_op, disp_by_kind, sync_total, by_cat, chaos, retries = \
        _counts(profile)
    dropped = int(profile.get("dropped", 0))
    # exclusive: no other query (traced or not) overlapped this one, so
    # process-wide counter deltas were attributable; when False the caller
    # passed the tracer's own per-query counters instead (obs/tracer.py)
    reconcile: Dict[str, Any] = {
        "overflow": dropped > 0,
        "exclusive": bool(profile.get("exclusive", True))}
    if dispatch_delta is not None:
        want = {k: v for k, v in dispatch_delta.items() if v}
        reconcile["dispatch_ok"] = dropped > 0 or disp_by_kind == want
        reconcile["dispatch_expected"] = want
    if sync_ledger is not None:
        want_syncs = {op: dict(kinds) for op, kinds in sync_ledger.items()}
        got_syncs = {op: slot["syncs"] for op, slot in by_op.items()
                     if slot.get("syncs")}
        reconcile["sync_ok"] = dropped > 0 or got_syncs == want_syncs
        reconcile["sync_total_expected"] = sum(
            sum(k.values()) for k in want_syncs.values())
    bundle = {
        "schema": "spark-rapids-tpu/query-profile/1",
        "query": profile.get("name"),
        "duration_ms": round(profile.get("duration_ns", 0) / 1e6, 3),
        "dropped_events": dropped,
        "event_counts": by_cat,
        "spans": span_tree(profile),
        "plan": plan_tree or [],
        "metrics": metrics or {},
        "task_metrics": task_metrics or {},
        "by_operator": by_op,
        "dispatches_by_kind": disp_by_kind,
        "sync_events_total": sync_total,
        "chaos_events": chaos,
        "retry_events": retries,
        "reconcile": reconcile,
    }
    return bundle


def write_artifacts(bundle: Dict[str, Any], profile: Dict[str, Any],
                    out_dir: str, stem: str) -> Dict[str, str]:
    """Write the Chrome trace and the bundle JSON under ``out_dir``;
    returns {"chrome_trace": path, "bundle": path} (also recorded inside
    the bundle as ``artifacts``)."""
    import os
    os.makedirs(out_dir, exist_ok=True)
    trace_path = os.path.join(out_dir, f"{stem}.trace.json")
    bundle_path = os.path.join(out_dir, f"{stem}.profile.json")
    with open(trace_path, "w") as f:
        json.dump(chrome_trace(profile), f)
    paths = {"chrome_trace": trace_path, "bundle": bundle_path}
    bundle["artifacts"] = paths
    with open(bundle_path, "w") as f:
        json.dump(bundle, f, default=str)
    return paths
