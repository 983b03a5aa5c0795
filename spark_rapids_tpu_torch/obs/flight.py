"""Crash flight recorder: a small always-on ring of recent notable events
plus the postmortem bundle written when a query dies hard.

Port of ``spark_rapids_tpu/obs/flight.py`` (reference analogue: the
plugin's GpuCoreDumpHandler, which captures an incident artifact even
though nobody was profiling):

* :func:`note` — an always-on, bounded ring (``deque(maxlen=...)``, conf
  ``spark.rapids.tpu.obs.flightRecorderEvents``) of RARE, notable events:
  query begin/end, chaos injections, device retries, budget pressure/OOM,
  disk spills, fatal failures. The per-batch hot path never notes.
* :func:`postmortem` — on a fatal device error
  (``failure.handle_task_failure``), an exhausted transient retry
  (``failure.with_device_retry``) or a genuine budget OOM, dump one JSON
  bundle under ``spark.rapids.tpu.obs.postmortemDir``: the last-K flight
  events, the metrics-registry snapshot, budget / semaphore / spill-catalog
  / scheduler state, the active query names and the failure. Writing never
  raises and never masks the original error.

Each note is tagged with the thread's traced query or, untraced, its
bound query context.
"""

from __future__ import annotations

import json
import os
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, List, Optional

_DEFAULT_RING = 512

_LOCK = threading.Lock()
_RING: deque = deque(maxlen=_DEFAULT_RING)
_SEQ = 0
#: process-wide postmortem output dir (session init applies the conf, the
#: same arm-once pattern as chaos.FaultInjector.maybe_configure); failure
#: sites have no session handle
_POSTMORTEM_DIR: Optional[str] = None


def maybe_configure(conf) -> None:
    """Apply ``spark.rapids.tpu.obs.*`` flight-recorder settings from a
    session's conf (ring size, postmortem dir) — called at session init."""
    global _RING, _POSTMORTEM_DIR
    from ..config import OBS_FLIGHT_EVENTS, OBS_POSTMORTEM_DIR
    size = max(16, int(conf.get(OBS_FLIGHT_EVENTS)))
    pdir = conf.get(OBS_POSTMORTEM_DIR)
    with _LOCK:
        if size != _RING.maxlen:
            _RING = deque(_RING, maxlen=size)
        if pdir and str(pdir) != "None":
            _POSTMORTEM_DIR = str(pdir)


def reset_for_tests() -> None:
    global _RING, _SEQ, _POSTMORTEM_DIR
    with _LOCK:
        _RING = deque(maxlen=_DEFAULT_RING)
        _SEQ = 0
        _POSTMORTEM_DIR = None


def note(event: str, **fields) -> None:
    """Append one notable event to the always-on ring. Call only at RARE
    sites (faults, retries, pressure, spill-to-disk, query lifecycle) —
    never per batch. Field values must already be host scalars (a note
    must never wait on the device)."""
    global _SEQ
    from ..serving.query_context import current
    from .tracer import current_query_name
    name = current_query_name()
    if name is None:
        q = current()
        name = None if q is None else q.name
    if name is not None:
        fields.setdefault("query", name)
    rec = {"seq": 0, "ts": time.time(),
           "thread": threading.current_thread().name, "event": event,
           **fields}
    with _LOCK:
        _SEQ += 1
        rec["seq"] = _SEQ
        _RING.append(rec)


def snapshot(last_k: Optional[int] = None) -> List[Dict[str, Any]]:
    with _LOCK:
        recs = list(_RING)
    return recs[-last_k:] if last_k else recs


def _engine_state() -> Dict[str, Any]:
    """Budget / semaphore / spill-catalog / scheduler state for the bundle;
    each source folds independently and never raises (the process may be
    dying)."""
    state: Dict[str, Any] = {}

    def fold(key, fn):
        try:
            state[key] = fn()
        except Exception as e:  # noqa: BLE001 — a dump must never fail
            state[key] = {"error": f"{type(e).__name__}: {e}"[:120]}

    def _sem():
        from ..memory.semaphore import TorchSemaphore
        s = TorchSemaphore._instance
        if s is None:
            return {}
        return s.state()

    def _spill():
        from ..memory.spill import TorchBufferCatalog
        c = TorchBufferCatalog._instance
        if c is None:
            return {}
        return {"host_used": c.host_used,
                "spilled_to_host": c.spilled_to_host,
                "spilled_to_disk": c.spilled_to_disk}

    def _sched():
        from ..serving.scheduler import QueryScheduler
        s = QueryScheduler._instance
        if s is None:
            return {}
        # a postmortem must NAME the queries that were queued, running
        # or cancelling when the process died
        return s.snapshot()

    from . import metrics as _metrics
    fold("hbm", _metrics.hbm_state)
    fold("semaphore", _sem)
    fold("spill", _spill)
    fold("scheduler", _sched)
    return state


def build_postmortem(reason: str, exc: Optional[BaseException] = None,
                     last_k: int = 256) -> Dict[str, Any]:
    """Assemble the postmortem bundle as plain data (the write path and
    tests share this)."""
    from . import metrics as _metrics
    bundle: Dict[str, Any] = {
        "schema": "spark-rapids-tpu-torch/postmortem/1",
        "reason": reason,
        "timestamp": time.time(),
        "active_queries": _metrics.active_queries(),
        "flight_events": snapshot(last_k),
        "engine_state": _engine_state(),
    }
    if exc is not None:
        bundle["error_type"] = type(exc).__name__
        bundle["error"] = str(exc)
        bundle["traceback"] = traceback.format_exception(
            type(exc), exc, exc.__traceback__)
    try:
        bundle["metrics"] = _metrics.full_snapshot()
    except Exception as e:  # noqa: BLE001 — a dump must never fail
        bundle["metrics"] = {"error": f"{type(e).__name__}: {e}"[:120]}
    return bundle


def postmortem(reason: str, exc: Optional[BaseException] = None,
               conf=None) -> Optional[str]:
    """Write the postmortem bundle under the configured dir (conf argument
    wins over the session-armed process-wide dir). Returns the written
    path, or None when no dir is configured. Never raises — the caller is
    already handling a failure and this must not mask it."""
    try:
        out_dir = None
        if conf is not None:
            from ..config import OBS_POSTMORTEM_DIR
            d = conf.get(OBS_POSTMORTEM_DIR)
            if d and str(d) != "None":
                out_dir = str(d)
        if out_dir is None:
            out_dir = _POSTMORTEM_DIR
        if not out_dir:
            return None
        bundle = build_postmortem(reason, exc)
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(
            out_dir, f"postmortem-{reason}-{int(time.time() * 1000)}.json")
        with open(path, "w") as f:
            json.dump(bundle, f, indent=2, default=str)
        note("postmortem.written", reason=reason, path=path)
        return path
    except Exception:  # noqa: BLE001 — never mask the original failure
        return None
