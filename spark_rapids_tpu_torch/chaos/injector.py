"""Deterministic, seeded, site-based fault injector.

Port of ``spark_rapids_tpu/chaos/injector.py``, with the reference's site
names and per-site seeded streams, so one seed and site list pick the same
injections in both packages:

* **Sites** are stable names woven through the stack. A site either
  *checks* (`inject(site)` — may raise a fault or sleep) or *mangles* a
  byte stream (`corrupt_bytes(site, data)`). The port weaves the sites of
  the modules it has (``hbm.alloc``, ``spill.to_host``, ``spill.to_disk``,
  ``sched.admit``, ``query.cancel``, ``sched.shed``); the rest are known
  names with no site yet.

* **Determinism**: each site owns an independent PRNG seeded from
  (seed, site) via sha256, so the per-site sequence of draws — and the
  per-site injection trace — is identical run to run even though thread
  interleaving may hand a given draw to a different caller. `trace_text()`
  serializes the trace sorted by (site, seq).

* **Healability gating**: the OOM kinds (`retry_oom`, `split_oom`) only
  fire inside a retry-framework scope (`retry_scope`, entered by
  memory/retry.py around each attempt). `split_oom` degrades to
  `retry_oom` when the scope says the input cannot be split. Gating is
  applied AFTER the PRNG draw so the draw sequence stays independent of
  scope state.

* **Forced counters**: the deterministic `HbmBudget.force_retry_oom`-style
  test hooks route through `force(site, kind, n)` — they fire ahead of any
  randomized draw, bypass scope gating, and work with the injector
  otherwise disabled.
"""

from __future__ import annotations

import contextlib
import hashlib
import random
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

ALL_SITES = (
    "hbm.alloc", "spill.to_host", "spill.to_disk", "device.dispatch",
    "shuffle.serialize", "shuffle.write", "shuffle.read", "ici.fetch",
    "pipeline.task", "scan.read", "mesh.shard", "mesh.link",
    "sched.admit", "query.cancel", "sched.shed",
)

ALL_KINDS = (
    "retry_oom", "split_oom", "transient", "fatal", "corrupt", "truncate",
    "io_error", "latency", "cancel",
)

#: which fault kinds make sense at each site. `inject` draws from the
#: configured kinds ∩ this set; `corrupt_bytes` additionally restricts to
#: the byte-stream kinds (corrupt/truncate). Raise-kinds at byte sites fire
#: through the adjacent `inject` call the site also makes.
SITE_KINDS: Dict[str, Tuple[str, ...]] = {
    "hbm.alloc": ("retry_oom", "split_oom", "latency"),
    "spill.to_host": ("retry_oom", "latency", "io_error"),
    "spill.to_disk": ("latency", "io_error", "corrupt", "truncate"),
    "device.dispatch": ("transient", "fatal", "latency"),
    "shuffle.serialize": ("latency", "io_error"),
    "shuffle.write": ("corrupt", "truncate", "io_error", "latency"),
    "shuffle.read": ("corrupt", "truncate", "io_error", "latency"),
    "ici.fetch": ("transient", "latency"),
    "pipeline.task": ("transient", "latency", "io_error"),
    "scan.read": ("corrupt", "truncate", "io_error", "latency"),
    # mesh data plane: a LOST SHARD (io_error at the
    # collective read — the exchange converts it into catalog invalidation
    # so FetchFailed lineage recovery re-runs the collective) and a SLOW
    # SHARD (latency); a SLOW or FLAPPING ICI LINK fires inside the
    # collective launch (latency stalls the transfer; transient heals via
    # with_device_retry re-running the idempotent staging)
    "mesh.shard": ("io_error", "latency"),
    "mesh.link": ("transient", "latency"),
    # query lifecycle: the scheduler's admission point (latency = queue delay; io_error = a
    # failed admission — the query dies QUEUED, before any resource is
    # acquired) and the cooperative cancellation checkpoints (cancel =
    # the bound query's cancel token arms AT this exact boundary, racing
    # a user cancel against every task boundary in the stack; latency =
    # a slow checkpoint)
    "sched.admit": ("latency", "io_error"),
    "query.cancel": ("cancel", "latency"),
    # the load-shed decision point: fires BEFORE the
    # victim's cancel token arms — latency delays the shed, io_error
    # fails the shed attempt itself (the victim survives the pass; a
    # queue-full submission degrades to typed QueryQueueFull
    # backpressure, the overload path re-decides next tick)
    "sched.shed": ("latency", "io_error"),
}

_BYTE_KINDS = ("corrupt", "truncate")

# --- retry-scope tracking (memory/retry.py enters; OOM kinds gate on it) ---

_TL = threading.local()


@contextlib.contextmanager
def retry_scope(splittable: bool = True):
    """Mark the current thread as inside a retry-framework attempt: injected
    TorchRetryOOM/TorchSplitAndRetryOOM here is healable by design."""
    prev = getattr(_TL, "scope", None)
    _TL.scope = {"splittable": bool(splittable)}
    try:
        yield
    finally:
        _TL.scope = prev


def in_retry_scope() -> bool:
    return getattr(_TL, "scope", None) is not None


def _scope_splittable() -> bool:
    s = getattr(_TL, "scope", None)
    return bool(s and s["splittable"])


# --- the injector -----------------------------------------------------------


class _Record:
    __slots__ = ("site", "seq", "kind", "detail", "forced")

    def __init__(self, site: str, seq: int, kind: str, detail: str = "",
                 forced: bool = False):
        self.site = site
        self.seq = seq
        self.kind = kind
        self.detail = detail
        self.forced = forced

    def render(self) -> str:
        tag = "forced " if self.forced else ""
        extra = f" {self.detail}" if self.detail else ""
        return f"{self.site}#{self.seq} {tag}{self.kind}{extra}"


def _site_seed(seed: int, site: str) -> int:
    # sha256, not hash(): str hashing is randomized per process, and the
    # trace must replay across processes for the same conf
    h = hashlib.sha256(f"{seed}:{site}".encode()).digest()
    return int.from_bytes(h[:8], "little")


class FaultInjector:
    """Process-wide seeded fault injector (see module docstring)."""

    _instance: Optional["FaultInjector"] = None
    _cls_lock = threading.Lock()

    def __init__(self, enabled: bool = False, seed: int = 0,
                 sites: Sequence[str] = (), kinds: Sequence[str] = (),
                 probability: float = 0.0, max_injections: int = 0,
                 latency_ms: float = 2.0):
        for s in sites:
            if s not in ALL_SITES:
                raise ValueError(f"unknown chaos site {s!r}; known: "
                                 f"{', '.join(ALL_SITES)}")
        for k in kinds:
            if k not in ALL_KINDS:
                raise ValueError(f"unknown chaos fault kind {k!r}; known: "
                                 f"{', '.join(ALL_KINDS)}")
        self.enabled = bool(enabled)
        self.seed = int(seed)
        self.sites = tuple(sites) or ALL_SITES
        self.kinds = tuple(kinds) or ALL_KINDS
        self.probability = float(probability)
        self.max_injections = int(max_injections)
        self.latency_ms = float(latency_ms)
        self._mu = threading.Lock()
        self._rngs: Dict[str, random.Random] = {}
        self._seqs: Dict[str, int] = {}
        self._trace: List[_Record] = []
        self._injected = 0
        self._forced: Dict[Tuple[str, str], int] = {}
        # checks to SKIP before a forced counter starts firing: lets a
        # test land a fault at exactly the k-th visit of a site
        self._forced_skip: Dict[Tuple[str, str], int] = {}
        # read un-locked on the hot path; flipped under the lock
        self._armed = self.enabled

    # --- lifecycle ---------------------------------------------------------
    @classmethod
    def get(cls) -> "FaultInjector":
        with cls._cls_lock:
            if cls._instance is None:
                cls._instance = FaultInjector()
            return cls._instance

    @classmethod
    def configure(cls, conf) -> "FaultInjector":
        """Build an injector from `spark.rapids.tpu.test.chaos.*`; forced
        counters survive reconfiguration (they are independent test hooks)."""
        from ..config import (CHAOS_ENABLED, CHAOS_KINDS, CHAOS_LATENCY_MS,
                              CHAOS_MAX_INJECTIONS, CHAOS_PROBABILITY,
                              CHAOS_SEED, CHAOS_SITES)
        inj = FaultInjector(
            enabled=conf.get(CHAOS_ENABLED), seed=conf.get(CHAOS_SEED),
            sites=conf.get(CHAOS_SITES), kinds=conf.get(CHAOS_KINDS),
            probability=conf.get(CHAOS_PROBABILITY),
            max_injections=conf.get(CHAOS_MAX_INJECTIONS),
            latency_ms=conf.get(CHAOS_LATENCY_MS))
        with cls._cls_lock:
            old = cls._instance
            if old is not None:
                with old._mu:
                    pending = {k: n for k, n in old._forced.items() if n > 0}
                inj._forced.update(pending)
                inj._armed = inj.enabled or bool(pending)
            cls._instance = inj
            return inj

    @classmethod
    def maybe_configure(cls, conf) -> None:
        """Session hook: (re)configure only when the conf mentions chaos —
        ordinary sessions must not clear another test's armed injector."""
        from ..config import CHAOS_ENABLED
        cur = cls._instance
        if conf.get(CHAOS_ENABLED) or (cur is not None and cur.enabled):
            cls.configure(conf)

    @classmethod
    def reset_for_tests(cls) -> "FaultInjector":
        with cls._cls_lock:
            cls._instance = FaultInjector()
            return cls._instance

    # --- test hooks (reference RmmSpark.forceRetryOOM) ---------------------
    def force(self, site: str, kind: str, n: int = 1,
              skip: int = 0) -> None:
        """Arm `n` deterministic one-shot faults at `site` (SET, not add —
        the RmmSpark.forceRetryOOM counter semantics). `skip` lets the
        first `skip` checks of the site pass clean first, so a test can
        land the fault at exactly the k-th boundary visit."""
        if site not in ALL_SITES or kind not in ALL_KINDS:
            raise ValueError(f"unknown chaos site/kind {site!r}/{kind!r}")
        with self._mu:
            self._forced[(site, kind)] = int(n)
            self._forced_skip[(site, kind)] = int(skip)
            self._armed = self.enabled or any(
                v > 0 for v in self._forced.values())

    def clear_forced(self, site: Optional[str] = None) -> None:
        """Drop pending forced counters (all sites, or one) — called by the
        singletons' reset_for_tests so a partially-consumed force cannot
        leak OOMs into a later test."""
        with self._mu:
            for key in list(self._forced):
                if site is None or key[0] == site:
                    del self._forced[key]
                    self._forced_skip.pop(key, None)
            self._armed = self.enabled or any(
                v > 0 for v in self._forced.values())

    # --- trace -------------------------------------------------------------
    def trace(self) -> List[Dict]:
        with self._mu:
            recs = list(self._trace)
        recs.sort(key=lambda r: (r.site, r.seq))
        return [{"site": r.site, "seq": r.seq, "kind": r.kind,
                 "detail": r.detail, "forced": r.forced} for r in recs]

    def trace_text(self) -> str:
        with self._mu:
            recs = list(self._trace)
        recs.sort(key=lambda r: (r.site, r.seq))
        return "\n".join(r.render() for r in recs)

    def injection_count(self) -> int:
        with self._mu:
            return len(self._trace)

    # --- the check ---------------------------------------------------------
    def _rng(self, site: str) -> random.Random:
        rng = self._rngs.get(site)
        if rng is None:
            rng = self._rngs[site] = random.Random(_site_seed(self.seed,
                                                              site))
        return rng

    def _pop_forced(self, site: str, wanted: Tuple[str, ...]
                    ) -> Optional[str]:
        # split before retry mirrors the old HbmBudget counter precedence
        order = ("cancel", "split_oom", "retry_oom", "transient", "fatal",
                 "corrupt", "truncate", "io_error", "latency")
        for kind in order:
            if kind not in wanted:
                continue
            n = self._forced.get((site, kind), 0)
            if n > 0:
                sk = self._forced_skip.get((site, kind), 0)
                if sk > 0:  # this kind passes the visit clean; other
                    # forced kinds at the site still get their turn
                    self._forced_skip[(site, kind)] = sk - 1
                    continue
                self._forced[(site, kind)] = n - 1
                self._armed = self.enabled or any(
                    v > 0 for v in self._forced.values())
                return kind
        return None

    def _draw(self, site: str, applicable: Tuple[str, ...]
              ) -> Tuple[Optional[str], float, int]:
        """One randomized decision for `site` under the lock. Returns
        (kind-or-None, latency_seconds, seq). The draw sequence per site is
        fixed by (seed, site) alone — gating never skips a draw."""
        rng = self._rng(site)
        seq = self._seqs.get(site, 0)
        self._seqs[site] = seq + 1
        r = rng.random()
        if r >= self.probability:
            return None, 0.0, seq
        kinds = tuple(k for k in self.kinds if k in applicable)
        if not kinds:
            return None, 0.0, seq
        kind = kinds[rng.randrange(len(kinds))]
        delay = 0.0
        if kind == "latency":
            delay = (self.latency_ms / 1000.0) * (0.25 + 0.75 * rng.random())
        # scope gating AFTER the draws: an un-healable OOM is suppressed,
        # not re-rolled, so the stream stays deterministic
        if kind in ("retry_oom", "split_oom"):
            if not in_retry_scope():
                return None, 0.0, seq
            if kind == "split_oom" and not _scope_splittable():
                kind = "retry_oom"
        if self.max_injections and self._injected >= self.max_injections:
            return None, 0.0, seq
        self._injected += 1
        return kind, delay, seq

    def check(self, site: str, detail: str = "") -> None:
        """Maybe raise a fault (or sleep) at `site`."""
        delay = 0.0
        with self._mu:
            kind = self._pop_forced(
                site, tuple(k for k in ALL_KINDS if k not in _BYTE_KINDS))
            forced = kind is not None
            if forced:
                seq = self._seqs.get(site, 0)  # forced: no draw consumed
            elif (self.enabled and site in self.sites):
                kind, delay, seq = self._draw(
                    site, tuple(k for k in SITE_KINDS[site]
                                if k not in _BYTE_KINDS))
            if kind is None:
                return
            self._trace.append(_Record(site, seq, kind,
                                       detail=detail, forced=forced))
        self._obs_event(site, seq, kind, detail, forced)
        self._raise(site, kind, delay)

    def mangle(self, site: str, data: bytes) -> bytes:
        """Maybe corrupt or truncate a byte stream at `site`."""
        if not data:
            return data
        with self._mu:
            kind = self._pop_forced(site, _BYTE_KINDS)
            forced = kind is not None
            offset = 0
            if forced:
                seq = self._seqs.get(site, 0)
                rng = self._rng(site)
            elif (self.enabled and site in self.sites):
                kind, _, seq = self._draw(
                    site, tuple(k for k in SITE_KINDS[site]
                                if k in _BYTE_KINDS))
                rng = self._rng(site)
            if kind is None:
                return data
            offset = rng.randrange(len(data))
            self._trace.append(_Record(
                site, seq, kind, detail=f"@{offset}/{len(data)}",
                forced=forced))
        self._obs_event(site, seq, kind, f"@{offset}/{len(data)}", forced)
        if kind == "truncate":
            return data[:offset]
        return data[:offset] + bytes([data[offset] ^ 0x5A]) \
            + data[offset + 1:]

    @staticmethod
    def _obs_event(site: str, seq: int, kind: str, detail: str,
                   forced: bool) -> None:
        """Every injection lands in the always-on registry (per-site
        counter), the crash flight recorder, so a postmortem bundle shows
        the fault that preceded the death, and — when the query is traced —
        the timeline, inside whatever span the injection interrupted."""
        from ..obs import flight as _flight
        from ..obs import metrics as _metrics
        from ..obs import tracer as _obs
        _metrics.counter_inc("chaos.injections", site=site, kind=kind)
        _flight.note("chaos.inject", site=site, seq=seq, kind=kind,
                     detail=detail, forced=forced)
        if _obs._ACTIVE:
            _obs.event("chaos", cat="chaos", site=site, seq=seq, kind=kind,
                       detail=detail, forced=forced)

    def _raise(self, site: str, kind: str, delay: float) -> None:
        if kind == "latency":
            time.sleep(delay)
            return
        if kind in ("retry_oom", "split_oom"):
            from ..memory.hbm import TorchRetryOOM, TorchSplitAndRetryOOM
            exc = (TorchSplitAndRetryOOM if kind == "split_oom"
                   else TorchRetryOOM)(f"chaos-injected {kind} at {site}")
            raise exc
        if kind == "transient":
            raise RuntimeError(
                f"UNAVAILABLE: chaos-injected transient device error "
                f"at {site}")
        if kind == "fatal":
            raise RuntimeError(
                f"INTERNAL: chaos-injected fatal device error at {site}")
        if kind == "io_error":
            raise OSError(f"chaos-injected io error at {site}")
        if kind == "cancel":
            # query-lifecycle chaos: arm the bound query's cancel token — so every
            # OTHER thread serving the query trips at its next checkpoint
            # too, exactly like a user cancel — then raise here, at this
            # boundary
            from ..serving.query_context import (QueryCancelledError,
                                                 current)
            q = current()
            if q is not None:
                q.cancel(reason=f"chaos at {site}")
            raise QueryCancelledError(
                f"chaos-injected cancel at {site}")
        raise AssertionError(f"unhandled chaos kind {kind}")


# --- module-level fast path (sites call these) ------------------------------


def inject(site: str, detail: str = "") -> None:
    inj = FaultInjector._instance
    if inj is None or not inj._armed:
        return
    inj.check(site, detail)


def corrupt_bytes(site: str, data: bytes) -> bytes:
    inj = FaultInjector._instance
    if inj is None or not inj._armed:
        return data
    return inj.mangle(site, data)
