"""Device-error classification, transient retry, and diagnostic capture.

Port of ``spark_rapids_tpu/failure.py`` (reference analogue:
RapidsExecutorPlugin.onTaskFailed → containsCudaFatalException →
logGpuDebugInfoAndExit, and GpuCoreDumpHandler). The reference classifies
XLA status strings; the port classifies what CUDA raises through torch:

* ``torch.cuda.OutOfMemoryError`` is **retryable**: the retry framework
  (``memory/retry.py``) takes it as a ``TorchRetryOOM`` — spill, retry,
  split. It is never a device error here.
* **fatal**: the errors that leave the CUDA context sticky-broken — an
  illegal memory access or address, an unspecified launch failure, a
  device-side assert, an ECC error, an illegal instruction. Every later
  call on that context fails, so nothing retries them:
  ``handle_task_failure`` writes the diagnostic bundle (device name,
  ``torch.cuda.memory_stats()``, the budget, the task metrics, the error)
  under ``spark.rapids.tpu.coreDump.dir``, fails every query the
  scheduler holds (none of them can finish on a broken context) and — when
  ``exit_on_fatal`` — ends the process so a cluster manager reschedules.
  The reference instead quarantines a fatal error while other queries run,
  on the premise that they finish; on CUDA that holds only for the chaos
  injector's ``fatal`` kind, which breaks nothing, so only that kind is
  quarantined.
* **transient**: a device that is busy or unavailable for the moment;
  dispatch sites wrap themselves in ``with_device_retry`` (bounded
  exponential backoff + jitter). A message carrying both classes is fatal.

The chaos injector's ``transient`` and ``fatal`` kinds raise
``RuntimeError``s that classify the same way.
"""

from __future__ import annotations

import json
import os
import random
import time
import traceback
from typing import Callable, Iterator, Optional, TypeVar

T = TypeVar("T")

#: sticky CUDA context errors (the message texts of cudaErrorIllegalAddress,
#: cudaErrorLaunchFailure, cudaErrorAssert, cudaErrorECCUncorrectable,
#: cudaErrorMisalignedAddress, cudaErrorIllegalInstruction, ...)
_FATAL_MARKERS = (
    "illegal memory access", "illegal address", "unspecified launch failure",
    "device-side assert", "ECC error", "uncorrectable ECC",
    "misaligned address", "illegal instruction", "hardware stack error",
    "chaos-injected fatal device error",
)

#: the chaos injector's stand-in for a fatal error: it leaves the CUDA
#: context intact, so concurrent queries can still finish
_INJECTED_FATAL = "chaos-injected fatal device error"

#: a device that will answer again shortly (cudaErrorDevicesUnavailable,
#: cudaErrorNotReady surfacing through a sync)
_TRANSIENT_MARKERS = (
    "busy or unavailable", "device not ready",
    "chaos-injected transient device error",
)


def _device_error_messages(exc: BaseException) -> Iterator[str]:
    """Messages of device-error-shaped exceptions across the cause chain:
    RuntimeErrors (torch raises CUDA errors as RuntimeError /
    torch.AcceleratorError) that are not out-of-memory errors."""
    import torch
    seen = set()
    cur: Optional[BaseException] = exc
    while cur is not None and id(cur) not in seen:
        seen.add(id(cur))
        if isinstance(cur, RuntimeError) and not isinstance(
                cur, (MemoryError, torch.cuda.OutOfMemoryError)):
            yield str(cur)
        cur = cur.__cause__ or cur.__context__


def is_fatal_device_error(exc: BaseException) -> bool:
    """Does this error mean the device context is unusable (reference
    containsCudaFatalException walking the cause chain)?"""
    return any(any(m in msg for m in _FATAL_MARKERS)
               for msg in _device_error_messages(exc))


def _is_injected_fatal(exc: BaseException) -> bool:
    """Is every fatal marker in the chain the chaos injector's?"""
    fatal = [msg for msg in _device_error_messages(exc)
             if any(m in msg for m in _FATAL_MARKERS)]
    return bool(fatal) and all(_INJECTED_FATAL in msg for msg in fatal)


def is_transient_device_error(exc: BaseException) -> bool:
    """A device error expected to heal on re-dispatch. Fatal markers win
    when both appear; out-of-memory errors have their own framework and
    are never transient."""
    transient = False
    for msg in _device_error_messages(exc):
        if any(m in msg for m in _FATAL_MARKERS):
            return False
        if any(m in msg for m in _TRANSIENT_MARKERS):
            transient = True
    return transient


def with_device_retry(fn: Callable[[], T], conf=None,
                      max_attempts: Optional[int] = None,
                      base_ms: Optional[float] = None,
                      max_ms: Optional[float] = None) -> T:
    """Run `fn`, re-attempting on TRANSIENT device errors with bounded
    exponential backoff + jitter (attempt n sleeps
    min(base * 2^(n-1), max) * U[0.5, 1.0]). Everything else — fatal
    device errors, out-of-memory errors, ordinary exceptions — propagates
    on the first raise. `fn` must be idempotent. Retries and blocked time
    surface as the deviceRetryCount / deviceRetryBlockTimeNs task
    metrics."""
    if conf is not None:
        from .config import (DEVICE_RETRY_BACKOFF_BASE_MS,
                             DEVICE_RETRY_BACKOFF_MAX_MS,
                             DEVICE_RETRY_MAX_ATTEMPTS)
        if max_attempts is None:
            max_attempts = conf.get(DEVICE_RETRY_MAX_ATTEMPTS)
        if base_ms is None:
            base_ms = conf.get(DEVICE_RETRY_BACKOFF_BASE_MS)
        if max_ms is None:
            max_ms = conf.get(DEVICE_RETRY_BACKOFF_MAX_MS)
    attempts_left = 4 if max_attempts is None else int(max_attempts)
    base = 10.0 if base_ms is None else float(base_ms)
    cap = 2000.0 if max_ms is None else float(max_ms)
    attempt = 0
    while True:
        try:
            return fn()
        except BaseException as exc:  # noqa: BLE001 — classified below
            from .obs import flight as _flight
            from .obs import metrics as _metrics
            transient = is_transient_device_error(exc)
            if attempt >= attempts_left or not transient:
                if transient:
                    # exhausted retry: dump a postmortem before propagating
                    _flight.note("device.retry_exhausted", attempts=attempt,
                                 error=type(exc).__name__,
                                 message=str(exc)[:120])
                    _flight.postmortem("retry_exhausted", exc, conf)
                raise
            # the per-query retry budget caps the SUM over all sites
            from .serving.query_context import consume_retry_budget
            if not consume_retry_budget():
                _metrics.counter_inc("query.retry_budget_exhausted")
                _flight.note("query.retry_budget_exhausted",
                             error=type(exc).__name__,
                             message=str(exc)[:120])
                raise
            attempt += 1
            from .obs import tracer as _obs
            from .profiling import TaskMetricsRegistry
            if _obs._ACTIVE:
                # the healing retry lands in the SAME span as the failure
                # (and as any chaos injection that caused it)
                _obs.event("device.retry", cat="retry", attempt=attempt,
                           error=type(exc).__name__, message=str(exc)[:120])
            _metrics.counter_inc("device.retries")
            _flight.note("device.retry", attempt=attempt,
                         error=type(exc).__name__, message=str(exc)[:120])
            reg = TaskMetricsRegistry.get()
            reg.add("deviceRetryCount", 1)
            delay = min(cap, base * (2 ** (attempt - 1))) / 1000.0
            delay *= 0.5 + 0.5 * random.random()
            t0 = time.perf_counter_ns()
            time.sleep(delay)
            reg.add("deviceRetryBlockTimeNs", time.perf_counter_ns() - t0)


def _device_state() -> dict:
    """The card's name and allocator statistics (never raises: a broken
    context must not stop the dump)."""
    import torch
    out: dict = {}
    try:
        from .memory.device import TorchDeviceManager
        dev = TorchDeviceManager._device
        out["device"] = str(dev)
        if dev is not None and dev.type == "cuda":
            out["name"] = torch.cuda.get_device_name(dev)
            out["memory_stats"] = torch.cuda.memory_stats(dev)
    except Exception as e:  # noqa: BLE001
        out["error"] = f"{type(e).__name__}: {e}"[:200]
    return out


def write_diagnostic_bundle(exc: BaseException, dump_dir: str,
                            extra: Optional[dict] = None) -> str:
    """GpuCoreDumpHandler analogue: the device, its allocator statistics,
    the budget, the task metrics and the failure into a JSON bundle."""
    os.makedirs(dump_dir, exist_ok=True)
    bundle = {
        "timestamp": time.time(),
        "error_type": type(exc).__name__,
        "error": str(exc),
        "traceback": traceback.format_exception(type(exc), exc,
                                                exc.__traceback__),
        "device": _device_state(),
    }
    try:
        from .memory.hbm import HbmBudget
        b = HbmBudget._instance
        if b is not None:
            bundle["hbm"] = {"budget": b.budget, "used": b.used,
                             "peak_used": b.peak_used}
    except Exception:  # noqa: BLE001
        pass
    try:
        from .profiling import TaskMetricsRegistry
        bundle["task_metrics"] = TaskMetricsRegistry.get().snapshot()
    except Exception:  # noqa: BLE001
        pass
    if extra:
        bundle["extra"] = extra
    path = os.path.join(dump_dir,
                        f"torch-diagnostic-{int(time.time() * 1000)}.json")
    with open(path, "w") as f:
        json.dump(bundle, f, indent=2, default=str)
    return path


def handle_task_failure(exc: BaseException, conf,
                        exit_on_fatal: bool = True) -> Optional[str]:
    """Executor failure hook (reference RapidsExecutorPlugin.onTaskFailed).
    Returns the diagnostic path when a fatal error was captured."""
    from .config import CORE_DUMP_DIR
    from .memory.hbm import TorchOOM
    from .obs import flight as _flight
    from .obs import metrics as _metrics
    # a GENUINE budget exhaustion that reached the task-failure hook was
    # not healed by the retry framework: dump the postmortem here
    cur: Optional[BaseException] = exc
    seen: set = set()
    while cur is not None and id(cur) not in seen:
        seen.add(id(cur))
        if isinstance(cur, TorchOOM) and getattr(cur, "budget_exhausted",
                                                 False):
            _flight.note("hbm.oom_unhealed", error=str(cur)[:200])
            _flight.postmortem("hbm_oom", exc, conf)
            break
        cur = cur.__cause__ or cur.__context__
    if not is_fatal_device_error(exc):
        return None
    _metrics.counter_inc("device.fatal_errors")
    _flight.note("device.fatal", error=type(exc).__name__,
                 message=str(exc)[:200])
    _flight.postmortem("fatal_device_error", exc, conf)
    dump_dir = conf.get(CORE_DUMP_DIR)
    path = None
    if dump_dir:
        try:
            path = write_diagnostic_bundle(exc, str(dump_dir))
        except Exception:  # noqa: BLE001 — never mask the original failure
            pass
    if _is_injected_fatal(exc):
        # an injected fatal breaks no context: with CONCURRENT queries in
        # flight it is quarantined — the failed query unwinds and the
        # survivors finish
        if _metrics.active_query_count() > 1:
            _metrics.counter_inc("query.quarantined")
            _flight.note("query.quarantined",
                         active=_metrics.active_query_count(),
                         error=type(exc).__name__)
            return path
    else:
        # a sticky CUDA error breaks the context for the whole process:
        # every other query fails at its next checkpoint rather than on
        # its next CUDA call
        from .serving.scheduler import QueryScheduler
        failed = QueryScheduler.get().cancel_all(reason="device.fatal")
        _metrics.counter_inc("query.failed_by_fatal", failed)
        _flight.note("query.failed_by_fatal", queries=failed,
                     error=type(exc).__name__)
    if exit_on_fatal:
        os._exit(1)
    return path
