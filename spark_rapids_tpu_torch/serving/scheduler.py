"""The query scheduler/executor service: ONE device owner, many frontends.

Port of ``spark_rapids_tpu/serving/scheduler.py`` (reference analogue:
GpuSemaphore gates how many tasks may hold the device, and the plugin's
failure hooks isolate a fatal task; the "columnar compute service" shape
has many session frontends submitting to one device-owning scheduler):

* :class:`QueryScheduler` — process-wide admission control. A submitted
  query enters a bounded queue (per session, within its SLO class); past
  the bound the submission fails FAST with the typed
  :class:`QueryQueueFull` backpressure error — unless a strictly lower
  class is queued, in which case the LOWEST class is shed to make room. A
  queued query is admitted only when a concurrency slot is free
  (``spark.rapids.tpu.sched.maxConcurrentQueries``) AND the device budget
  is under the admission watermark
  (``spark.rapids.tpu.sched.hbmAdmissionWatermark`` × budget — waived when
  nothing is running) AND the tenant is under its quota
  (``spark.rapids.tpu.sched.tenantHbmQuota``). Admission order: strict
  class precedence (``interactive`` > ``batch`` > ``background``),
  earliest-deadline-first within a class across session queue heads,
  round-robin across a class's sessions on deadline ties, and an
  anti-starvation aging bound (``spark.rapids.tpu.sched.classAgingMs``).
  Sustained overload (a higher-class ticket waiting past
  ``spark.rapids.tpu.sched.shedAfterMs`` with every slot held and a lower
  class running) sheds the LOWEST running class through its cancel token;
  the client gets a typed ``QueryShed`` result with a retry-after hint.
  Execution is caller-runs: the submitting thread executes its own query
  once admitted, on the device's current stream (no side streams), so a
  batch never crosses threads.
* :func:`execute_plan` — the executor that ``DataFrame.collect`` reaches:
  one conf snapshot, a :class:`~.query_context.QueryContext` (cancel
  token, deadline, retry budget), admission, planning through the plan
  cache, and the per-partition loop with each task's context completed on
  every path. The reference's traced branch (the query tracer and its
  bundles) is not yet ported.

Nothing blocking runs under ``QueryScheduler._mu``: grant waits happen on
per-ticket events outside the lock, and chaos/flight emission happens
after release.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from typing import Any, Dict, List, Optional

from ..execs.base import TaskContext
from ..obs import flight as _flight
from ..obs import metrics as _metrics
from .query_context import (PRIORITIES, PRIORITY_RANK, QueryCancelledError,
                            QueryContext, QueryDeadlineExceeded,
                            QueryQueueFull, QueryShed, QueryShedError, bind,
                            checkpoint)

#: sessions alive in this process (weak: an abandoned, never-stopped
#: session must not pin itself here forever). TorchSession registers at
#: construction and discards itself in stop(); the LAST session to stop
#: releases the process-wide shuffle catalog.
_LIVE_SESSIONS: "weakref.WeakSet" = weakref.WeakSet()


def register_session(session) -> None:
    # a new frontend re-owns the shared state: any pending release from
    # a previous last-session stop() is obsolete (this session's stop()
    # will re-request it)
    global _SHARED_RELEASE_PENDING
    _SHARED_RELEASE_PENDING = False
    _LIVE_SESSIONS.add(session)


def release_session(session) -> None:
    _LIVE_SESSIONS.discard(session)


def other_live_sessions(session) -> bool:
    """Any session frontend OTHER than `session` still alive? Gates the
    shared-resource teardown in TorchSession.stop()."""
    return any(s is not session for s in _LIVE_SESSIONS)


#: set when the last session stopped but shared state could not be
#: released yet (a straggler query outlived stop()'s drain timeout);
#: re-checked when queries end, so the release happens when the
#: straggler finally finishes instead of never
_SHARED_RELEASE_PENDING = False


def request_shared_release() -> bool:
    """Mark the process-wide shuffle catalog for release (called by the
    LAST session's stop()) and attempt it now. Returns True if released."""
    global _SHARED_RELEASE_PENDING
    _SHARED_RELEASE_PENDING = True
    return maybe_release_shared()


def maybe_release_shared() -> bool:
    """Release the shuffle catalog iff a release is pending AND no live
    session or active query remains. Cheap no-op otherwise (one module
    bool read) — execute_plan calls this after every query so a query
    that outlived its session's stop() drain still triggers the
    teardown when it ends."""
    global _SHARED_RELEASE_PENDING
    if not _SHARED_RELEASE_PENDING:
        return False
    if len(_LIVE_SESSIONS) or _metrics.active_query_count():
        return False
    from ..shuffle.exchange import ShuffleCatalog
    _SHARED_RELEASE_PENDING = False
    ShuffleCatalog.shutdown_instance()
    return True


class _Ticket:
    __slots__ = ("qctx", "granted", "enq_ns", "quota_deferred")

    def __init__(self, qctx: QueryContext):
        self.qctx = qctx
        self.granted = threading.Event()
        self.enq_ns = time.perf_counter_ns()
        # sched.quota_defer_total counts DEFERRED TICKETS, not admission
        # passes: set on the first quota skip so the 50ms re-poll loop
        # cannot inflate the counter
        self.quota_deferred = False


class QueryScheduler:
    """Process-wide admission-controlled query scheduler (module doc)."""

    _instance: Optional["QueryScheduler"] = None
    _cls_lock = threading.Lock()

    def __init__(self, max_queue: int = 64, max_concurrent: int = 8,
                 hbm_watermark: float = 0.9, class_aging_ms: float = 10000.0,
                 tenant_hbm_quota: float = 0.0,
                 shed_after_ms: float = 5000.0):
        self.max_queue = int(max_queue)
        self.max_concurrent = int(max_concurrent)
        self.hbm_watermark = float(hbm_watermark)
        #: a ticket queued past this bound is promoted over class
        #: precedence (anti-starvation: background still drains); 0 = off
        self.class_aging_ms = float(class_aging_ms)
        #: per-tenant HBM quota as a fraction of the budget; <=0 = off
        self.tenant_hbm_quota = float(tenant_hbm_quota)
        #: sustained-overload bound: a higher-class ticket waiting past
        #: this with all slots held sheds the lowest running class; 0 = off
        self.shed_after_ms = float(shed_after_ms)
        self._mu = threading.Lock()
        # class -> session id -> FIFO of queued tickets (FIFO per session
        # within a class; EDF across session heads within the class);
        # _rr[cls] holds ids of that class's sessions with a non-empty
        # queue — rotation is PER CLASS, so one class draining cannot
        # perturb another class's fairness position
        self._queues: Dict[str, Dict[str, deque]] = {}
        self._rr: Dict[str, deque] = {}
        self._queued = 0
        self._running: Dict[int, QueryContext] = {}  # id(ticket) -> qctx
        # every live QueryContext (queued or running) by session, for
        # session.cancel()/stop(), tenant-quota accounting and the
        # postmortem listing
        self._by_session: Dict[str, List[QueryContext]] = {}
        self._tls = threading.local()
        # EMA of completed-query wall seconds — the retry-after hint's
        # scale (GIL attr, monitoring-counter discipline)
        self._lat_ema_s = 0.5
        # process-wide plan cache (serving/plan_cache.py): scheduler-owned
        # so ALL session frontends share one cache; its own lock, never _mu
        from .plan_cache import PlanCache
        self.plan_cache = PlanCache()

    # --- lifecycle ----------------------------------------------------------
    @classmethod
    def get(cls, conf=None) -> "QueryScheduler":
        with cls._cls_lock:
            if cls._instance is None:
                cls._instance = QueryScheduler()
            inst = cls._instance
        if conf is not None:
            inst._maybe_configure(conf)
        return inst

    @classmethod
    def peek(cls) -> Optional["QueryScheduler"]:
        """The live instance WITHOUT creating one (invalidation hooks must
        not boot a scheduler just to find an empty cache)."""
        with cls._cls_lock:
            return cls._instance

    @classmethod
    def reset_for_tests(cls) -> "QueryScheduler":
        global _SHARED_RELEASE_PENDING
        _SHARED_RELEASE_PENDING = False
        with cls._cls_lock:
            cls._instance = QueryScheduler()
            return cls._instance

    def _maybe_configure(self, conf) -> None:
        """Only EXPLICITLY SET sched keys overwrite the process state (a
        default-conf session must not silently resize another session's
        scheduler)."""
        from ..config import (PLAN_CACHE_MAX_ENTRIES, SCHED_CLASS_AGING_MS,
                              SCHED_HBM_WATERMARK, SCHED_MAX_CONCURRENT,
                              SCHED_MAX_QUEUE, SCHED_SHED_AFTER_MS,
                              SCHED_TENANT_HBM_QUOTA)
        with self._mu:
            if conf.get_raw(SCHED_MAX_QUEUE.key) is not None:
                self.max_queue = int(conf.get(SCHED_MAX_QUEUE))
            if conf.get_raw(SCHED_MAX_CONCURRENT.key) is not None:
                self.max_concurrent = max(
                    1, int(conf.get(SCHED_MAX_CONCURRENT)))
            if conf.get_raw(SCHED_HBM_WATERMARK.key) is not None:
                self.hbm_watermark = float(conf.get(SCHED_HBM_WATERMARK))
            if conf.get_raw(SCHED_CLASS_AGING_MS.key) is not None:
                self.class_aging_ms = float(conf.get(SCHED_CLASS_AGING_MS))
            if conf.get_raw(SCHED_TENANT_HBM_QUOTA.key) is not None:
                self.tenant_hbm_quota = float(
                    conf.get(SCHED_TENANT_HBM_QUOTA))
            if conf.get_raw(SCHED_SHED_AFTER_MS.key) is not None:
                self.shed_after_ms = float(conf.get(SCHED_SHED_AFTER_MS))
        if conf.get_raw(PLAN_CACHE_MAX_ENTRIES.key) is not None:
            self.plan_cache.configure(conf.get(PLAN_CACHE_MAX_ENTRIES))

    # --- admission core (self._mu held) ------------------------------------
    def _hbm_headroom_ok(self) -> bool:
        from ..memory.hbm import HbmBudget
        b = HbmBudget._instance  # no side-effect instantiation
        if b is None or b.budget <= 0:
            return True
        return b.used <= self.hbm_watermark * b.budget

    def _quota_bytes(self) -> Optional[int]:
        """Per-tenant HBM quota in bytes, or None when disabled (quota
        conf <= 0, or no budget to take a fraction of)."""
        if self.tenant_hbm_quota <= 0:
            return None
        from ..memory.hbm import HbmBudget
        b = HbmBudget._instance  # no side-effect instantiation
        if b is None or b.budget <= 0:
            return None
        return int(self.tenant_hbm_quota * b.budget)

    def _over_quota_locked(self, sid: str,
                           quota_bytes: Optional[int]) -> bool:
        """Tenant usage = the net HBM bytes charged to the tenant's LIVE
        QueryContexts (query_context.charge_hbm at HbmBudget.allocate).
        Over quota, the tenant's next ticket queues even when the device
        has headroom — the global watermark still applies on top."""
        if quota_bytes is None:
            return False
        return sum(q.hbm_bytes
                   for q in self._by_session.get(sid, ())) > quota_bytes

    def _skip_quota_locked(self, ticket: _Ticket, sid: str,
                           quota_bytes: Optional[int]) -> bool:
        if not self._over_quota_locked(sid, quota_bytes):
            return False
        if not ticket.quota_deferred:
            ticket.quota_deferred = True
            _metrics.counter_inc("sched.quota_defer_total", session=sid)
            _flight.note("query.quota_deferred", query=ticket.qctx.name,
                         session=sid)
        return True

    def _take_locked(self, cls: str, sid: str, ticket: _Ticket) -> _Ticket:
        """Dequeue a picked ticket and advance the PER-CLASS round-robin:
        the granted session moves to the back of ITS class's rotation
        only — fairness counters are per class, so a background grant can
        never advance the cursor interactive grants are ordered by."""
        dq = self._queues[cls][sid]
        dq.popleft()
        rot = self._rr.get(cls)
        if rot is not None:
            try:
                rot.remove(sid)
            except ValueError:
                pass
            if dq:
                rot.append(sid)
            if not rot:
                del self._rr[cls]
        if not dq:
            del self._queues[cls][sid]
            if not self._queues[cls]:
                del self._queues[cls]
        self._queued -= 1
        return ticket

    def _pick_locked(self, now_ns: int) -> Optional[_Ticket]:
        """SLO-aware pick: (1) anti-starvation aging — the OLDEST ticket
        queued past classAgingMs wins regardless of class, so background
        still drains under a persistent interactive load; (2) strict
        class precedence, earliest-deadline-first across the class's
        session queue heads (per-session order stays FIFO), rotation
        order breaking deadline ties (per-class round-robin). Over-quota
        tenants are skipped in both passes. None = nothing admittable."""
        quota = self._quota_bytes()
        if self.class_aging_ms > 0:
            bound_ns = int(self.class_aging_ms * 1e6)
            aged: Optional[tuple] = None
            for cls in PRIORITIES:
                for sid in self._rr.get(cls, ()):
                    dq = self._queues.get(cls, {}).get(sid)
                    if not dq:
                        continue
                    head = dq[0]
                    if now_ns - head.enq_ns < bound_ns:
                        continue
                    if self._skip_quota_locked(head, sid, quota):
                        continue
                    if aged is None or head.enq_ns < aged[2].enq_ns:
                        aged = (cls, sid, head)
            if aged is not None:
                return self._take_locked(*aged)
        for cls in PRIORITIES:
            best: Optional[tuple] = None
            best_key = float("inf")
            for sid in self._rr.get(cls, ()):
                dq = self._queues.get(cls, {}).get(sid)
                if not dq:
                    continue
                head = dq[0]
                if self._skip_quota_locked(head, sid, quota):
                    continue
                key = (float(head.qctx.deadline_ns)
                       if head.qctx.deadline_ns is not None
                       else float("inf"))
                # strict < keeps the earliest rotation position on ties:
                # deadline-less tickets fall back to pure round-robin
                if best is None or key < best_key:
                    best, best_key = (cls, sid, head), key
            if best is not None:
                return self._take_locked(*best)
        return None

    def _overload_victim_locked(self, now_ns: int
                                ) -> Optional[QueryContext]:
        """Sustained overload: a higher-class ticket has waited past
        shedAfterMs with every slot held while a strictly lower class
        runs → shed the LOWEST running class, one victim per pass (the
        freed slot re-evaluates before anything else is shed)."""
        if (self.shed_after_ms <= 0 or not self._queued
                or len(self._running) < self.max_concurrent):
            return None
        quota = self._quota_bytes()
        bound_ns = int(self.shed_after_ms * 1e6)
        waiter_rank: Optional[int] = None
        for cls, per_sid in self._queues.items():
            r = PRIORITY_RANK[cls]
            for sid, dq in per_sid.items():
                if not dq:
                    continue
                head = dq[0]
                # an over-quota tenant's wait is self-inflicted
                # backpressure, not device overload — never sheds others
                if self._over_quota_locked(sid, quota):
                    continue
                if (now_ns - head.enq_ns >= bound_ns
                        and (waiter_rank is None or r < waiter_rank)):
                    waiter_rank = r
        if waiter_rank is None:
            return None
        victim: Optional[QueryContext] = None
        vrank = waiter_rank
        for q in self._running.values():
            r = PRIORITY_RANK.get(q.priority, 0)
            if r > vrank and not q.cancelled:
                victim, vrank = q, r
        return victim

    def _admit_locked(self) -> Optional[QueryContext]:
        """Grant as many queued tickets as the watermarks allow (SLO
        order — _pick_locked). Grants are Event.set — the waiting
        submitter thread runs its own query. Returns the overload-shed
        victim, if any, for the CALLER to arm outside the lock (the
        cancel token's flight/chaos emission must not run under _mu)."""
        now_ns = time.perf_counter_ns()
        while self._queued and len(self._running) < self.max_concurrent:
            # HBM admission watermark, waived when the device is idle so
            # admission can always make progress (a budget left high by
            # parked state must not wedge the queue)
            if self._running and not self._hbm_headroom_ok():
                break
            ticket = self._pick_locked(now_ns)
            if ticket is None:
                break
            self._running[id(ticket)] = ticket.qctx
            ticket.granted.set()
        victim = self._overload_victim_locked(now_ns)
        # committed under the lock (the _QL_LOCK idiom): an interleaved
        # enqueue/release pair must never publish a stale depth
        _metrics.gauge_set("sched.queue_depth", self._queued)
        return victim

    def _admit_and_shed(self) -> None:
        """The admission entry point off the submit/poll/release paths:
        run one admission pass, then arm any overload victim OUTSIDE the
        lock (chaos + cancel-token flight emission)."""
        with self._mu:
            victim = self._admit_locked()
        if victim is not None:
            self._shed_victim(victim, reason="overload")

    # --- load shedding -----------------------------------------------------
    def _retry_after_s(self) -> float:
        """Client retry hint: roughly how long until a resubmission could
        be admitted — queue depth over concurrency, scaled by the EMA of
        recent query walls. A hint, not a promise (GIL reads)."""
        ema = max(0.05, float(self._lat_ema_s))
        depth = self._queued / max(1, self.max_concurrent)
        return min(30.0, round((depth + 1.0) * ema, 3))

    def _arm_shed(self, qctx: QueryContext, reason: str) -> None:
        if qctx.cancelled:
            return
        hint = self._retry_after_s()
        qctx.shed(retry_after_s=hint, reason=f"shed.{reason}")
        _metrics.counter_inc("sched.shed_total", cls=qctx.priority)
        _flight.note("query.shed", query=qctx.name,
                     session=qctx.session_id, cls=qctx.priority,
                     reason=reason, retry_after_s=hint)

    def _shed_victim(self, qctx: QueryContext, reason: str) -> bool:
        """Shed one RUNNING victim: the chaos `sched.shed` site fires
        BEFORE the token arms (latency delays the shed; io_error fails
        the shed attempt — the victim survives this pass and the next
        admission pass re-decides), then the cooperative cancel token
        arms with the retry-after hint. The victim unwinds through the
        usual release paths at its next checkpoint."""
        from ..chaos import inject
        try:
            inject("sched.shed", detail=qctx.name)
        except OSError:
            _flight.note("query.shed_aborted", query=qctx.name,
                         session=qctx.session_id, reason=reason)
            return False
        self._arm_shed(qctx, reason)
        return True

    def _try_shed_queued(self, ticket: _Ticket, reason: str) -> bool:
        """Shed one QUEUED victim to make room for a higher-class
        submission. Chaos fires before any state change; io_error fails
        the shed (False → the submission degrades to typed QueryQueueFull
        backpressure). The victim's waiting thread observes its armed
        token at the next 50ms poll tick and unwinds without ever having
        run. True = scheduler state may have changed; retry the enqueue
        (the victim may instead have been granted in the race window —
        that also frees queue space)."""
        from ..chaos import inject
        try:
            inject("sched.shed", detail=ticket.qctx.name)
        except OSError:
            _flight.note("query.shed_aborted", query=ticket.qctx.name,
                         session=ticket.qctx.session_id, reason=reason)
            return False
        with self._mu:
            removed = self._remove_ticket_locked(ticket)
        if removed:
            self._arm_shed(ticket.qctx, reason)
        return True

    def _remove_ticket_locked(self, ticket: _Ticket) -> bool:
        """Drop a still-queued ticket from its class/session queue
        (shed-while-queued, or a never-admitted release). Idempotent."""
        cls = ticket.qctx.priority
        sid = ticket.qctx.session_id
        per_sid = self._queues.get(cls)
        dq = per_sid.get(sid) if per_sid else None
        if dq is None:
            return False
        try:
            dq.remove(ticket)
        except ValueError:
            return False
        self._queued -= 1
        if not dq:
            del per_sid[sid]
            if not per_sid:
                del self._queues[cls]
            rot = self._rr.get(cls)
            if rot is not None:
                try:
                    rot.remove(sid)
                except ValueError:
                    pass
                if not rot:
                    del self._rr[cls]
        return True

    def _release(self, ticket: _Ticket) -> None:
        """Return `ticket`'s slot (running) or queue entry (never admitted)
        and admit successors. Idempotent."""
        with self._mu:
            if self._running.pop(id(ticket), None) is None:
                self._remove_ticket_locked(ticket)
            victim = self._admit_locked()
        if victim is not None:
            self._shed_victim(victim, reason="overload")

    def _deregister(self, qctx: QueryContext) -> None:
        """QueryContext.close() hook: drop it from the session index."""
        with self._mu:
            lst = self._by_session.get(qctx.session_id)
            if lst is None:
                return
            lst[:] = [q for q in lst if q is not qctx]
            if not lst:
                del self._by_session[qctx.session_id]

    # --- the submission path ------------------------------------------------
    def submit_and_run(self, qctx: QueryContext, fn):
        """Enqueue `qctx`, wait for admission, then run `fn` on the calling
        thread with the context bound. Raises QueryQueueFull past the queue
        bound; a cancel/deadline while QUEUED raises without running
        anything. Nested execution (a query submitting a query on the same
        thread) bypasses admission — the caller-runs model would deadlock
        a thread against its own held slot."""
        if getattr(self._tls, "admitted", False):
            # nested execution rides the OUTER query's admission slot AND
            # its cancel token: the outer (registered) context stays
            # bound, so session.cancel()/stop()/deadlines interrupt the
            # nested work too — re-binding the nested context would hand
            # checkpoints a token nothing can ever arm (the nested
            # context is registered nowhere; it is part of the outer
            # query's work)
            qctx.mark_running()
            return fn()
        ticket = _Ticket(qctx)
        my_rank = PRIORITY_RANK[qctx.priority]
        cls = qctx.priority
        enqueued = False
        victim: Optional[QueryContext] = None
        # bounded shed-to-make-room loop: a full queue rejects a
        # submission ONLY when no strictly lower class is queued behind
        # it — otherwise the lowest (youngest-first) class is shed and
        # the enqueue retried. Same-or-higher classes queued means the
        # typed QueryQueueFull backpressure stands, exactly as before.
        for _attempt in range(4):
            queued_victim: Optional[_Ticket] = None
            with self._mu:
                if self._queued < self.max_queue:
                    self._queues.setdefault(cls, {}).setdefault(
                        qctx.session_id, deque()).append(ticket)
                    rot = self._rr.setdefault(cls, deque())
                    if qctx.session_id not in rot:
                        rot.append(qctx.session_id)
                    self._queued += 1
                    self._by_session.setdefault(qctx.session_id,
                                                []).append(qctx)
                    victim = self._admit_locked()
                    enqueued = True
                else:
                    queued_victim = self._find_queued_victim_locked(
                        my_rank)
            if enqueued:
                break
            if queued_victim is None or not self._try_shed_queued(
                    queued_victim, reason="queue_full"):
                break
        if victim is not None:
            self._shed_victim(victim, reason="overload")
        if not enqueued:
            _metrics.counter_inc("query.rejected_queue_full")
            _flight.note("query.rejected", query=qctx.name,
                         session=qctx.session_id, reason="queue_full")
            raise QueryQueueFull(
                f"query {qctx.name} rejected: admission queue full "
                f"(spark.rapids.tpu.sched.maxQueuedQueries="
                f"{self.max_queue})")
        _flight.note("query.queued", query=qctx.name,
                     session=qctx.session_id, cls=qctx.priority)
        try:
            # grant wait OFF the lock; short poll so a cancel or deadline
            # arriving while queued is observed promptly, and admission is
            # re-evaluated each tick (HBM headroom can open mid-query,
            # with no completion event to trigger a grant)
            while not ticket.granted.wait(timeout=0.05):
                qctx.check("sched.queue")
                self._admit_and_shed()
            # chaos `sched.admit` fires BEFORE the admission is recorded:
            # latency extends the measured queue delay (it lands in the
            # sched.admit_wait_ms histogram), io_error fails the query
            # still QUEUED — no query.admitted flight event, no query
            # work started, no resource acquired
            from ..chaos import inject
            inject("sched.admit", detail=qctx.name)
            wait_ms = (time.perf_counter_ns() - ticket.enq_ns) / 1e6
            qctx.admit_wait_ms = wait_ms
            _metrics.histogram_observe("sched.admit_wait_ms", wait_ms)
            _metrics.histogram_observe("sched.class_admit_wait_ms",
                                       wait_ms, cls=qctx.priority)
            _flight.note("query.admitted", query=qctx.name,
                         session=qctx.session_id, cls=qctx.priority,
                         wait_ms=round(wait_ms, 3))
            self._tls.admitted = True
            try:
                with bind(qctx):
                    qctx.mark_running()
                    out = fn()
            finally:
                self._tls.admitted = False
            # completed-query wall EMA — the retry-after hint's scale
            run_s = ((time.perf_counter_ns() - ticket.enq_ns) / 1e9
                     - wait_ms / 1e3)
            self._lat_ema_s = (0.8 * self._lat_ema_s
                               + 0.2 * max(1e-3, run_s))
            return out
        except QueryShedError:
            # counted at arm time (sched.shed_total); deliberately NOT
            # query.cancelled — shedding is a scheduler answer, and the
            # front door converts it into a typed QueryShed result
            _flight.note("query.shed_unwound", query=qctx.name,
                         session=qctx.session_id, cls=qctx.priority)
            raise
        except QueryDeadlineExceeded:
            _metrics.counter_inc("query.deadline_exceeded")
            _flight.note("query.deadline_exceeded", query=qctx.name,
                         session=qctx.session_id)
            raise
        except QueryCancelledError:
            _metrics.counter_inc("query.cancelled")
            _flight.note("query.cancelled", query=qctx.name,
                         session=qctx.session_id,
                         reason=qctx.cancel_reason)
            raise
        finally:
            self._release(ticket)

    def _find_queued_victim_locked(self, my_rank: int
                                   ) -> Optional["_Ticket"]:
        """Lowest-class queued ticket STRICTLY below `my_rank`, youngest
        first (least sunk queue wait), for shed-to-make-room."""
        for cls in reversed(PRIORITIES):
            if PRIORITY_RANK[cls] <= my_rank:
                return None
            per_sid = self._queues.get(cls)
            if not per_sid:
                continue
            youngest: Optional[_Ticket] = None
            for dq in per_sid.values():
                for t in dq:
                    if youngest is None or t.enq_ns > youngest.enq_ns:
                        youngest = t
            if youngest is not None:
                return youngest
        return None

    # --- session-level control ---------------------------------------------
    def cancel_session(self, session_id: str,
                       reason: str = "session.cancel") -> int:
        """Arm the cancel token of every queued/running query of one
        session frontend; returns how many were flagged."""
        with self._mu:
            targets = list(self._by_session.get(session_id, ()))
        for q in targets:
            q.cancel(reason=reason)
        return len(targets)

    def cancel_all(self, reason: str) -> int:
        """Arm the cancel token of every queued/running query of every
        session (a sticky device error: none of them can finish); returns
        how many were flagged."""
        with self._mu:
            targets = [q for qs in self._by_session.values() for q in qs]
        for q in targets:
            q.cancel(reason=reason)
        return len(targets)

    def drain_session(self, session_id: str, timeout_s: float = 30.0
                      ) -> bool:
        """Wait (bounded) until a session has no queued or running query —
        the stop() barrier after cancel_session."""
        end = time.monotonic() + timeout_s
        while time.monotonic() < end:
            with self._mu:
                if not self._by_session.get(session_id):
                    return True
            time.sleep(0.01)
        with self._mu:
            return not self._by_session.get(session_id)

    # --- observability ------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Queued/running query names + states for the postmortem bundle
        and metrics_snapshot — a crash dump must NAME the queries that
        were queued, running or cancelling when the process died."""
        with self._mu:
            running = [{"query": q.name, "session": q.session_id,
                        "cls": q.priority, "state": q.state}
                       for q in self._running.values()]
            queued = [{"query": t.qctx.name, "session": sid, "cls": cls,
                       "state": t.qctx.state}
                      for cls, per_sid in self._queues.items()
                      for sid, dq in per_sid.items() for t in dq]
            tenant_hbm = {sid: sum(q.hbm_bytes for q in qs)
                          for sid, qs in self._by_session.items()}
            return {"max_concurrent": self.max_concurrent,
                    "max_queue": self.max_queue,
                    "hbm_watermark": self.hbm_watermark,
                    "class_aging_ms": self.class_aging_ms,
                    "tenant_hbm_quota": self.tenant_hbm_quota,
                    "shed_after_ms": self.shed_after_ms,
                    "queue_depth": self._queued,
                    "tenant_hbm_bytes": tenant_hbm,
                    "running": running, "queued": queued,
                    "plan_cache": self.plan_cache.stats()}


# ---------------------------------------------------------------------------
# the executor service: the per-partition driving loop that DataFrame
# .collect reaches (session.py keeps the front door and session state)
# ---------------------------------------------------------------------------


def execute_plan(session, plan, timeout: Optional[float] = None,
                 priority: Optional[str] = None, on_device: bool = False):
    """Plan, admit and execute one query for `session`, returning its
    batches (host batches, or with ``on_device`` the device batches under
    the final download) — or a typed :class:`QueryShed` result when the
    scheduler shed the query under overload. `timeout` (seconds)
    overrides the session's spark.rapids.tpu.query.timeoutMs deadline for
    this call; `priority` overrides its spark.rapids.tpu.query.priority
    class."""
    from ..config import (QUERY_PRIORITY, QUERY_RETRY_BUDGET,
                          QUERY_TIMEOUT_MS, TRACE_TAG)
    # ONE conf snapshot at submission: every later planning step (logical
    # optimize, physical plan, override pass, plan-cache fingerprint) reads
    # this frozen view, so a concurrent conf.set() can never produce a
    # plan half-built under two conf views
    conf = session._rapids_conf()
    session._query_seq = getattr(session, "_query_seq", 0) + 1
    tag = conf.get(TRACE_TAG)
    if tag and str(tag) != "None":
        # tagged names stay `<tag>-<n>`: the artifact files' stems
        qname = f"{tag}-{session._query_seq}"
    else:
        # untagged sessions fold the session id into the query name, so
        # concurrent sessions' queries never share one
        sid_n = session._session_id.rsplit("-", 1)[-1]
        qname = f"query-s{sid_n}-{session._query_seq}"
    timeout_ms = float(timeout) * 1000.0 if timeout is not None \
        else float(conf.get(QUERY_TIMEOUT_MS))
    deadline_ns = (time.perf_counter_ns() + int(timeout_ms * 1e6)
                   if timeout_ms and timeout_ms > 0 else None)
    cls = str(priority if priority is not None
              else conf.get(QUERY_PRIORITY))
    sched = QueryScheduler.get(conf)

    def plan_fn():
        from .plan_cache import build_or_fetch
        final, cache_status, rules = build_or_fetch(session, sched, plan,
                                                    conf)
        session._last_plan_cache = cache_status
        session._last_opt_rules = rules
        return final

    try:
        with QueryContext(qname, session_id=session._session_id,
                          deadline_ns=deadline_ns,
                          retry_budget=conf.get(QUERY_RETRY_BUDGET),
                          priority=cls) as qctx:
            try:
                return sched.submit_and_run(
                    qctx, lambda: _run_admitted(session, plan_fn, conf,
                                                qctx, qname, on_device))
            except QueryShedError as e:
                # typed load-shed RESULT, not an error: the unwind already
                # ran the release paths; finish(e) records the SHED state
                # here, as the swallowed exception never reaches __exit__
                qctx.finish(e)
                return QueryShed(
                    query=qname, session=session._session_id,
                    priority=qctx.priority,
                    reason=qctx.cancel_reason or "shed",
                    retry_after_s=e.retry_after_s)
            finally:
                session._last_admit_wait_ms = qctx.admit_wait_ms
    finally:
        # a query that outlived its session's stop() drain releases the
        # shared state the stop could not (no-op unless pending)
        maybe_release_shared()


def _run_admitted(session, plan_fn, conf, qctx: QueryContext, qname: str,
                  on_device: bool) -> List:
    """One admitted query's execution window: planning (through the
    scheduler-owned plan cache), the partition loop, failure handling and
    the per-query snapshots (task metrics, operator metrics, the plan
    tree, the sync-ledger delta, the traced bundle). Runs on the
    submitting thread with the QueryContext bound; planning runs AFTER the
    tracer arms, so the plan.build span is part of the query's bundle."""
    from .. import obs
    from ..config import (FATAL_ERROR_EXIT, TRACE_BUFFER_EVENTS,
                          TRACE_CATEGORIES, TRACE_ENABLED,
                          TRACE_MAX_CONCURRENT)
    from ..execs.transitions import DeviceToHostExec, HostToDeviceExec
    from ..failure import handle_task_failure
    from ..profiling import (SyncLedger, TaskMetricsRegistry,
                             snapshot_plan_metrics)
    task_metrics_before = TaskMetricsRegistry.get().snapshot()
    syncs_before = SyncLedger.get().snapshot()
    qtok = _metrics.query_begin(qname, cls=qctx.priority)
    qroot = None
    opjit_before = None
    final = None
    out: List = []
    failed = True  # cleared by the last statement of the try body
    try:
        if conf.get(TRACE_ENABLED):
            from ..execs import opjit
            # armed first inside the try whose finally ends it: an
            # exception never strands an armed tracer. The dispatch
            # snapshot before arming is trusted only when the query ran
            # alone; otherwise the bundle reconciles against the tracer's
            # own per-query counters
            opjit_before = opjit.cache_stats()["calls_by_kind"]
            qroot = obs.begin_query(
                qname, buffer_events=conf.get(TRACE_BUFFER_EVENTS),
                categories=conf.get(TRACE_CATEGORIES),
                max_concurrent=conf.get(TRACE_MAX_CONCURRENT))
        # planning: a plan-cache fetch (literal re-bind) or the full
        # optimize → physical plan → override pass — one span, one
        # histogram, so the planning share is measurable from the bundle
        t_plan0 = time.perf_counter_ns()
        with obs.span("plan.build", cat="plan"):
            final = plan_fn()
        _metrics.histogram_observe(
            "plan.build_ms", (time.perf_counter_ns() - t_plan0) / 1e6)
        run = final
        if on_device:
            while isinstance(run, DeviceToHostExec):
                run = run.children[0]
            if not run.is_tpu:  # a host plan (e.g. a bare table): upload
                run = HostToDeviceExec(run)
        for p in range(run.num_partitions()):
            # cooperative cancellation at partition-task start: a
            # cancelled or timed-out query stops before this partition
            # acquires anything
            checkpoint(f"task.start p{p}")
            ctx = TaskContext(p, conf, session.device, session.counters)
            try:
                with obs.span(f"partition {p}", cat="task", partition=p):
                    out.extend(run.execute_partition(p, ctx))
            except BaseException as exc:
                # fatal device errors capture diagnostics and (when
                # configured) exit (RapidsExecutorPlugin.onTaskFailed)
                handle_task_failure(exc, conf,
                                    exit_on_fatal=conf.get(FATAL_ERROR_EXIT))
                raise
            finally:
                ctx.complete()
        failed = False  # reached only when every partition completed
    finally:
        # metrics and the plan as plain data, so no plan (and no device
        # buffer it holds) outlives the query; a planning failure leaves
        # no stale snapshot of the previous query
        session._last_metrics_snapshot = (
            snapshot_plan_metrics(final) if final is not None else None)
        session._last_plan_tree = (
            _plan_tree_snapshot(final) if final is not None else None)
        after = TaskMetricsRegistry.get().snapshot()
        session._last_task_metrics = {
            k: after.get(k, 0) - task_metrics_before.get(k, 0)
            for k in after}
        session._last_sync_ledger = _ledger_delta(
            syncs_before, SyncLedger.get().snapshot())
        if qroot is not None:
            _finish_query_profile(session, qroot, conf, opjit_before)
        else:
            # an untraced query leaves no earlier query's bundle behind
            session._last_query_profile = None
        # the query's shuffle blocks leave the device with it (reference:
        # Spark's ContextCleaner removing shuffle state)
        if final is not None:
            for node in final.collect_nodes():
                if hasattr(node, "cleanup_shuffle"):
                    node.cleanup_shuffle()
        _metrics.query_end(qtok, rows=sum(b.num_rows for b in out),
                           failed=failed)
    return out


def _ledger_delta(before: Dict[str, Dict[str, int]],
                  after: Dict[str, Dict[str, int]]
                  ) -> Dict[str, Dict[str, int]]:
    """Per-operator blocking-sync counts this query added to the
    process-wide ledger."""
    ledger = {}
    for op, kinds in after.items():
        prev = before.get(op, {})
        d = {k: v - prev.get(k, 0) for k, v in kinds.items()
             if v - prev.get(k, 0)}
        if d:
            ledger[op] = d
    return ledger


def _finish_query_profile(session, qroot, conf, opjit_before) -> None:
    """Close the tracer, build the diagnostics bundle (metric snapshot,
    sync-ledger delta, dispatch-by-kind delta, the span/event record) and
    write the Chrome trace and bundle under spark.rapids.tpu.trace.dir
    when it is set. The bundle reconciles the tracer's events against
    these deltas: the tracer must have seen every launch
    (``calls_by_kind``) and every blocking sync (SyncLedger)."""
    from .. import obs
    from ..config import TRACE_DIR
    from ..execs import opjit
    profile = obs.end_query(qroot)
    if profile.get("exclusive", True):
        # no other query overlapped: the process-wide deltas belong to
        # this query (counters kept independently of the tracer)
        disp_after = opjit.cache_stats()["calls_by_kind"]
        disp_delta = {
            k: disp_after.get(k, 0) - (opjit_before or {}).get(k, 0)
            for k in set(disp_after) | set(opjit_before or {})}
    else:
        # concurrent queries: process-wide deltas cross-bleed, so the
        # bundle reconciles against the query's own counters, kept by the
        # tracer where calls_by_kind and the SyncLedger increment
        disp_delta = {k: v for k, v in
                      profile.get("dispatch_counts", {}).items() if v}
        session._last_sync_ledger = {
            op: dict(kinds)
            for op, kinds in profile.get("sync_counts", {}).items()}
    bundle = obs.build_bundle(
        profile, plan_tree=session._last_plan_tree,
        metrics=session._last_metrics_snapshot,
        sync_ledger=session._last_sync_ledger, dispatch_delta=disp_delta,
        task_metrics=session._last_task_metrics)
    out_dir = conf.get(TRACE_DIR)
    if out_dir and str(out_dir) != "None":
        try:
            obs.write_artifacts(bundle, profile, str(out_dir),
                                profile.get("name", "query"))
        except OSError:
            bundle["artifacts"] = {"error": "trace.dir not writable"}
    session._last_query_profile = bundle


def _plan_tree_snapshot(plan) -> List[dict]:
    """Plain-data snapshot of the executed physical plan for
    explain("metrics") and the bundle — preorder, so index i matches
    snapshot_plan_metrics's "i:NodeName" keys."""
    out: List[dict] = []

    def walk(node, depth: int) -> None:
        out.append({"i": len(out), "depth": depth,
                    "name": node.node_name(), "desc": node.node_desc(),
                    "tpu": node.is_tpu})
        for c in node.children:
            walk(c, depth + 1)

    walk(plan, 0)
    return out
