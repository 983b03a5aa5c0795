"""Shutdown leak tracking + double-close detection for device resources.

Port of ``spark_rapids_tpu/memory/cleaner.py`` (reference analogue: cuDF's
MemoryCleaner leak report at shutdown and the refcount double-close
logging). Torch tensors are garbage-collected, so a leak here never
corrupts memory — but an unclosed SpillableColumnarBatch keeps device
memory accounted in the catalog past its useful life, which is the class
of bug the tracker surfaces.

Always-on cheap tracking (a dict of live tokens); in debug mode
(``set_debug(True)``) each registration also captures its creation stack,
and double-closes raise instead of being counted.
"""

from __future__ import annotations

import atexit
import sys
import threading
import traceback
from typing import Dict, List, Optional


class DoubleCloseError(RuntimeError):
    pass


class _Record:
    __slots__ = ("token", "kind", "stack", "closed")

    def __init__(self, token: int, kind: str, stack: Optional[str]):
        self.token = token
        self.kind = kind
        self.stack = stack
        self.closed = False


class MemoryCleaner:
    """Process-wide registry of closeable device resources."""

    _instance: Optional["MemoryCleaner"] = None
    _lock = threading.Lock()

    def __init__(self):
        self._live: Dict[int, _Record] = {}
        self._next = 0
        self._mu = threading.Lock()
        self.debug = False
        self.double_closes = 0

    @classmethod
    def get(cls) -> "MemoryCleaner":
        with cls._lock:
            if cls._instance is None:
                cls._instance = MemoryCleaner()
                atexit.register(cls._instance._at_shutdown)
            return cls._instance

    @classmethod
    def reset_for_tests(cls) -> "MemoryCleaner":
        with cls._lock:
            cls._instance = MemoryCleaner()
            return cls._instance

    def set_debug(self, on: bool) -> None:
        self.debug = on

    def register(self, kind: str) -> int:
        with self._mu:
            token = self._next
            self._next += 1
            stack = "".join(traceback.format_stack(limit=12)) \
                if self.debug else None
            self._live[token] = _Record(token, kind, stack)
            return token

    def unregister(self, token: int) -> None:
        """Mark closed; a second unregister of the same token is a
        double-close (raises in debug mode, counted otherwise)."""
        with self._mu:
            if self._live.pop(token, None) is not None:
                return
            self.double_closes += 1
            if self.debug:
                raise DoubleCloseError(
                    f"resource token {token} closed twice")

    def live_resources(self) -> List[_Record]:
        with self._mu:
            return list(self._live.values())

    def check_leaks(self, raise_on_leak: bool = False) -> List[str]:
        """Report (and optionally fail on) unclosed resources — the
        test-suite analogue of the shutdown hook."""
        leaks = [f"{r.kind} (token {r.token})"
                 + (f"\n{r.stack}" if r.stack else "")
                 for r in self.live_resources()]
        if leaks and raise_on_leak:
            raise AssertionError(
                f"{len(leaks)} leaked device resources:\n" + "\n".join(leaks))
        return leaks

    def _at_shutdown(self) -> None:
        # catalog-held shuffle blocks and the compiled join stage's
        # dimension builds are OWNED state: release them first so the
        # report below only shows genuine leaks
        try:
            from ..shuffle.exchange import ShuffleCatalog
            ShuffleCatalog.shutdown_instance()
        except Exception:  # noqa: BLE001 — report must never fail shutdown
            pass
        try:
            from ..execs.compiled_join import clear_dim_cache
            clear_dim_cache()
        except Exception:  # noqa: BLE001
            pass
        leaks = self.check_leaks(raise_on_leak=False)
        if leaks:
            print(f"[spark-rapids-tpu-torch] MemoryCleaner: {len(leaks)} "
                  f"leaked resources at shutdown:", file=sys.stderr)
            for item in leaks[:20]:
                print(f"  {item}", file=sys.stderr)
