"""Per-query lifecycle state: cancel token, deadline, retry budget.

Port of ``spark_rapids_tpu/serving/query_context.py`` (reference analogue:
Spark cancels a job group by flagging its TaskContexts and letting tasks
observe the flag at safe points). A CUDA kernel is not preempted, so
cancellation is **cooperative**: the engine checks :func:`checkpoint` at
every task boundary — a partition-task start, each batch pull of every
device operator, each exchange map task — never mid-kernel, and a tripped
check raises :class:`QueryCancelledError` / :class:`QueryDeadlineExceeded`,
unwinding through the existing release paths (finally blocks, ``with``
scopes, task-completion listeners).

State machine::

    QUEUED ──admit──► RUNNING ──ok──► FINISHED
      │                 │ └─error───► FAILED
      │                 └─cancel/deadline──► CANCELLING ─unwound─► CANCELLED
      └─cancel/deadline/queue-reject while queued ────────────────► CANCELLED
                                                    (deadline → TIMED_OUT)
                                                    (shed     → SHED)

SLO classes: every submission carries a *priority class* —
``interactive`` > ``batch`` > ``background`` — and an optional deadline.
The scheduler admits earliest-deadline-first within a class with strict
precedence across classes (plus an anti-starvation aging bound), and under
sustained overload **sheds** the lowest class through the same cancel
token: :meth:`QueryContext.shed` arms it with a retry-after hint, the next
checkpoint raises :class:`QueryShedError`, and the front door answers with
a typed :class:`QueryShed` result.

:func:`bind` attaches a context to the calling thread; an unbound thread's
:func:`checkpoint` is a single thread-local read.

The errors subclass ``BaseException`` on purpose: no generic ``except
Exception`` recovery path (a device retry, a fallback re-run) may heal a
cancellation into more work. ``QueryQueueFull`` is an ordinary
``Exception``: backpressure is a normal, retryable client-facing condition.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Iterator, Optional

#: lifecycle states
QUEUED = "QUEUED"
RUNNING = "RUNNING"
CANCELLING = "CANCELLING"
FINISHED = "FINISHED"
FAILED = "FAILED"
CANCELLED = "CANCELLED"
TIMED_OUT = "TIMED_OUT"
SHED = "SHED"

_TERMINAL = (FINISHED, FAILED, CANCELLED, TIMED_OUT, SHED)

#: SLO priority classes, best first: strict precedence
#: across classes at admission, EDF within a class, and under sustained
#: overload the WORST class is shed first. Rank = index (lower is better).
PRIORITIES = ("interactive", "batch", "background")
PRIORITY_RANK = {cls: i for i, cls in enumerate(PRIORITIES)}


def validate_priority(priority: str) -> str:
    p = str(priority).lower()
    if p not in PRIORITY_RANK:
        raise ValueError(
            f"unknown priority class {priority!r} "
            f"(expected one of {', '.join(PRIORITIES)})")
    return p


class QueryCancelledError(BaseException):
    """The query's cancel token was set (user cancel, session.stop(),
    chaos `query.cancel`). BaseException: see module docstring."""


class QueryDeadlineExceeded(QueryCancelledError):
    """The query ran past its deadline (spark.rapids.tpu.query.timeoutMs
    or df.collect(timeout=...)) and was cancelled at a checkpoint."""


class QueryShedError(QueryCancelledError):
    """The scheduler shed this query to protect higher classes under
    sustained overload. Unwinds through
    the same cancel paths as any cancellation; the executor front door
    converts it into a :class:`QueryShed` RESULT carrying the retry-after
    hint — client code never sees this exception from collect()."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class QueryShed:
    """Typed load-shed RESULT (not an error): the query was unwound
    leak-free before completion; resubmit after ``retry_after_s``.
    Returned by df.collect()/to_arrow() in place of the row payload."""

    __slots__ = ("query", "session", "priority", "reason", "retry_after_s")

    def __init__(self, query: str, session: str, priority: str,
                 reason: str, retry_after_s: float):
        self.query = query
        self.session = session
        self.priority = priority
        self.reason = reason
        self.retry_after_s = float(retry_after_s)

    def __repr__(self) -> str:
        return (f"QueryShed(query={self.query!r}, session={self.session!r},"
                f" priority={self.priority!r}, reason={self.reason!r},"
                f" retry_after_s={self.retry_after_s:.3f})")


class QueryQueueFull(Exception):
    """Typed backpressure: the scheduler's bounded admission queue is full
    (spark.rapids.tpu.sched.maxQueuedQueries). The submission was rejected
    BEFORE any resource was acquired — resubmit later or shed load."""


class QueryContext:
    """One submitted query's lifecycle handle: cancel token + optional
    deadline + per-query retry budget. Owner discipline: created
    by the executor front door, used as a ``with`` context so the
    scheduler registration releases on every path."""

    def __init__(self, name: str, session_id: str = "default",
                 deadline_ns: Optional[int] = None,
                 retry_budget: int = 64,
                 priority: str = "interactive"):
        self.name = name
        self.session_id = session_id
        #: absolute time.perf_counter_ns() deadline, or None
        self.deadline_ns = deadline_ns
        #: SLO class (PRIORITIES); drives admission order and shed order
        self.priority = validate_priority(priority)
        self.state = QUEUED
        self.cancel_reason: Optional[str] = None
        #: retry-after hint set by QueryScheduler when this query is shed
        self.shed_retry_after_s: Optional[float] = None
        #: measured admission wait (ms), written at grant time — the
        #: bench serving stage reads it back per query
        self.admit_wait_ms: Optional[float] = None
        #: net HBM bytes charged by this query's bound threads (lock-free
        #: GIL adds, the metrics-cell idiom: a rare lost update is the
        #: standard monitoring tradeoff). The scheduler sums a tenant's
        #: live contexts against its quota at admission time.
        self.hbm_bytes = 0
        self._cancel = threading.Event()
        self._mu = threading.Lock()
        self._retry_budget = int(retry_budget)
        self._closed = False

    # --- cancellation -------------------------------------------------------
    def cancel(self, reason: str = "user") -> None:
        """Arm the cancel token (idempotent; first reason wins). The query
        keeps running until its next cooperative checkpoint observes the
        token — there is nothing safe to interrupt mid-kernel."""
        with self._mu:
            if self._cancel.is_set() or self.state in _TERMINAL:
                return
            self.cancel_reason = reason
            if self.state == RUNNING:
                self.state = CANCELLING
        self._cancel.set()
        from ..obs import flight as _flight
        _flight.note("query.cancelling", query=self.name,
                     session=self.session_id, reason=reason)

    def shed(self, retry_after_s: float = 1.0,
             reason: str = "shed") -> None:
        """Arm the cancel token for LOAD SHEDDING: same cooperative
        machinery as cancel() (idempotent, observed at the next
        checkpoint, unwinds through the same release paths) but
        the check raises QueryShedError so the front door can answer with
        a typed QueryShed result instead of an error."""
        with self._mu:
            if self._cancel.is_set() or self.state in _TERMINAL:
                return
            self.shed_retry_after_s = float(retry_after_s)
        self.cancel(reason=reason)

    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set()

    def deadline_exceeded(self) -> bool:
        return (self.deadline_ns is not None
                and time.perf_counter_ns() >= self.deadline_ns)

    def check(self, boundary: str = "") -> None:
        """Raise if cancelled or past deadline — the cooperative
        cancellation point. Deadline expiry arms the cancel token too, so
        every other thread serving this query trips at ITS next check."""
        if self._cancel.is_set():
            if self.cancel_reason == "deadline":
                raise QueryDeadlineExceeded(
                    f"query {self.name} exceeded its deadline "
                    f"(observed at {boundary or 'checkpoint'})")
            if self.shed_retry_after_s is not None:
                raise QueryShedError(
                    f"query {self.name} ({self.priority}) shed by the "
                    f"scheduler ({self.cancel_reason}) at "
                    f"{boundary or 'checkpoint'}",
                    retry_after_s=self.shed_retry_after_s)
            raise QueryCancelledError(
                f"query {self.name} cancelled "
                f"({self.cancel_reason or 'unknown'}) "
                f"at {boundary or 'checkpoint'}")
        if self.deadline_exceeded():
            self.cancel(reason="deadline")
            raise QueryDeadlineExceeded(
                f"query {self.name} exceeded its deadline at "
                f"{boundary or 'checkpoint'}")

    # --- retry budget -------------------------------------------------------
    def consume_retry(self) -> bool:
        """Take one unit of the per-query transient-retry budget
        (spark.rapids.tpu.query.retryBudget). False = exhausted: the
        caller fails THIS query instead of retrying — one flapping query
        cannot sit in retry loops starving the shared pool."""
        with self._mu:
            if self._retry_budget <= 0:
                return False
            self._retry_budget -= 1
            return True

    # --- state machine ------------------------------------------------------
    def mark_running(self) -> None:
        with self._mu:
            if self.state == QUEUED:
                self.state = RUNNING

    def finish(self, exc: Optional[BaseException] = None) -> str:
        """Record the terminal state from the execution outcome."""
        with self._mu:
            if self.state in _TERMINAL:
                return self.state
            if exc is None:
                self.state = FINISHED
            elif isinstance(exc, QueryDeadlineExceeded):
                self.state = TIMED_OUT
            elif isinstance(exc, QueryShedError):
                self.state = SHED
            elif isinstance(exc, QueryCancelledError):
                self.state = CANCELLED
            else:
                self.state = FAILED
            return self.state

    # --- ownership ----------------------------------------------------------
    def close(self) -> None:
        """Deregister from the scheduler's active-query index (idempotent).
        A context that dies unregistered would keep session.cancel() and
        the postmortem's queued/running listing lying forever."""
        if self._closed:
            return
        self._closed = True
        from .scheduler import QueryScheduler
        sched = QueryScheduler._instance
        if sched is not None:
            sched._deregister(self)

    def __enter__(self) -> "QueryContext":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.finish(exc)
        self.close()


# --- thread binding ---------------------------------------------------------

_TL = threading.local()


@contextlib.contextmanager
def bind(qctx: Optional[QueryContext]) -> Iterator[None]:
    """Bind `qctx` to the calling thread for the scope (None = keep the
    current binding)."""
    prev = getattr(_TL, "q", None)
    _TL.q = qctx if qctx is not None else prev
    try:
        yield
    finally:
        _TL.q = prev


def current() -> Optional[QueryContext]:
    return getattr(_TL, "q", None)


def checkpoint(boundary: str = "") -> None:
    """The cooperative cancellation point, called at every pre-existing
    task boundary. Unbound thread: one thread-local read, nothing else.
    Bound: the chaos `query.cancel` site fires first (so a seeded soak can
    race a cancellation against this exact boundary), then the context's
    cancel/deadline check."""
    q = getattr(_TL, "q", None)
    if q is None:
        return
    from ..chaos import inject
    inject("query.cancel", detail=boundary)
    q.check(boundary)


def consume_retry_budget() -> bool:
    """failure.with_device_retry's hook: True when no query is bound (the
    per-site attempt bound still applies) or budget remains."""
    q = getattr(_TL, "q", None)
    return True if q is None else q.consume_retry()


def charge_hbm(nbytes: int) -> None:
    """HbmBudget.allocate's attribution hook: charge device bytes to the
    query bound on the allocating thread (no-op unbound — pool warm-up,
    session caches). Per-tenant quota admission sums the tenant's live
    contexts' net charges."""
    q = getattr(_TL, "q", None)
    if q is not None:
        q.hbm_bytes += nbytes


def release_hbm(nbytes: int) -> None:
    """HbmBudget.free's hook: un-charge bytes freed on a bound thread.
    Frees on UNBOUND threads (MemoryCleaner, session teardown) are not
    attributable; the residue disappears when the context closes — quota
    accounting is admission-time and per-live-query by design, so the
    skew is bounded by one query's lifetime."""
    q = getattr(_TL, "q", None)
    if q is not None:
        q.hbm_bytes = max(0, q.hbm_bytes - nbytes)
