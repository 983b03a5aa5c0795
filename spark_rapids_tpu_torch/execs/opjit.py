"""Dispatch accounting: the process-wide count of program launches by kind.

The reference's ``execs/opjit.py`` is an executable cache whose
``cache_stats()["calls_by_kind"]`` is the ground truth that a traced
query's ``dispatch`` events reconcile against. The port has no executable
cache (torch launches eagerly); this module keeps only those counters, for
the launches that correspond to the reference's dispatch events:

* ``compiledagg`` — one compiled aggregation stage run
  (``execs/compiled.py``);
* ``compiledjoin`` — one compiled star-join stage run
  (``execs/compiled_join.py``);
* ``parquet_decode`` — one row group's device decode
  (``io/device_decode.py``), as the reference's
  ``record_external_dispatch("parquet_decode")`` counts it.

Each is recorded with ``cache="extern"`` (a launch outside an executable
cache), so the bundle's reconciliation counts it on both sides.
"""

from __future__ import annotations

import threading
from typing import Any, Dict

from ..obs import tracer as _obs

_LOCK = threading.Lock()
_KIND_CALLS: Dict[str, int] = {}


def record_external_dispatch(kind: str) -> None:
    """Count one launch of `kind` in ``calls_by_kind`` and, when this
    thread's query is traced, as its ``dispatch`` event."""
    with _LOCK:
        _KIND_CALLS[kind] = _KIND_CALLS.get(kind, 0) + 1
    if _obs._ACTIVE:
        _obs.dispatch_event(kind, cache="extern", source=kind)


def cache_stats() -> Dict[str, Any]:
    with _LOCK:
        return {"calls_by_kind": dict(_KIND_CALLS)}
