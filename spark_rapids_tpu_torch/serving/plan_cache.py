"""Scheduler-owned plan cache with literal parameter slots.

Port of ``spark_rapids_tpu/serving/plan_cache.py``. Production traffic is
the same parameterized query shapes arriving over and over; planning
(logical optimize → physical plan → override pass) is pure host work that
repeats verbatim. This module caches the finished physical plan under a
three-part key:

* **structure** — the normalized LOGICAL plan (node kinds, scalar
  properties, expression shapes with attribute expr_ids canonicalized by
  first-use order, so two independently-built but structurally identical
  plans collide), including the output schema;
* **scan identity** — every FileScan's (path, size, mtime) triple, so a
  table swap (same path, new bytes) never serves the plan chosen for the
  old file statistics;
* **conf** — the PLAN-RELEVANT session confs (every explicitly-set key
  except the observability/scheduler/cache knobs that cannot change a
  plan).

**Parameter slots**: literals inside Filter conditions and Project
expressions are hole-punched out of the fingerprint (only their dtype is
kept) and collected in walk order. A later submission with different
literal values produces the same key plus its own literal list; the hit
path re-binds the cached template's literal objects (paired positionally,
replaced by identity) into a fresh execution clone
(``PhysicalPlan.clone_for_execution``). Literals anywhere else (aggregate
expressions, join conditions, limits) stay part of the fingerprint.

The cached template NEVER executes: every submission (hit or miss) runs a
clone, so cached entries hold no shuffle ids, broadcast buffers or
dimension builds.

Invalidation (each counts ``plan.cache_invalidated`` with a reason):
``invalidate_conf`` drops entries planned under a different value of a
plan-relevant conf (wired to ``session.conf.set/unset``); inserting an
entry drops same-structure/same-conf entries whose scan identity went
stale. A ``df.cache()``d relation keys on its generation, which its
``unpersist()`` raises, so no entry replays dropped batches (the
reference evicts by relation id instead).
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from ..expressions.base import AttributeReference, Expression, Literal
from ..obs import metrics as _metrics
from ..plan import logical as L
from ..types import DataType


class _Uncacheable(Exception):
    """Plan shape this fingerprint does not understand — not an error, the
    query simply plans fresh every time."""


_SCALARS = (str, int, float, bool, bytes, type(None))

#: conf prefixes that can NEVER change a physical plan: observability,
#: scheduling/admission, query-lifecycle budgets, and the plan cache's own
#: knobs. Everything else explicitly set participates in the fingerprint
#: (shuffle partitions, broadcast threshold, optimizer toggles, batch
#: sizes ... all shape plans).
_NONPLAN_PREFIXES = (
    "spark.rapids.tpu.trace.",
    "spark.rapids.tpu.obs.",
    "spark.rapids.tpu.sched.",
    "spark.rapids.tpu.query.",
    "spark.rapids.tpu.plan.cache.",
    "spark.rapids.profile.",
)


def plan_relevant_conf(conf) -> Dict[str, Any]:
    """The explicitly-set conf keys that participate in plan fingerprints
    (and whose changes invalidate cached entries)."""
    return {k: v for k, v in sorted(conf._settings.items())
            if not k.startswith(_NONPLAN_PREFIXES)}


def is_plan_relevant(key: str) -> bool:
    return not str(key).startswith(_NONPLAN_PREFIXES)


def _safe_repr(v) -> str:
    if isinstance(v, _SCALARS):
        return repr(v)
    if isinstance(v, DataType):
        return str(v)
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_safe_repr(x) for x in v) + "]"
    if isinstance(v, dict):
        return "{" + ",".join(f"{_safe_repr(k)}:{_safe_repr(x)}"
                              for k, x in sorted(v.items(),
                                                 key=lambda kv: str(kv[0]))
                              ) + "}"
    raise _Uncacheable(f"unfingerprintable value {type(v).__name__}")


def _expr_sig(e: Expression, id_map: Dict[int, int], punch: bool,
              params: List[Literal]) -> str:
    """Normalized expression signature. ``punch=True`` hole-punches
    Literals into parameter slots (dtype kept, value collected)."""
    if isinstance(e, Literal):
        wall = ":wall" if e.wall else ""  # a session-zone wall time
        if punch:
            params.append(e)
            return f"?{e.dtype}{wall}"
        return f"lit:{e.dtype}{wall}:{_safe_repr(e.value)}"
    if isinstance(e, AttributeReference):
        cid = id_map.setdefault(e.expr_id, len(id_map))
        return f"a{cid}:{e.name}:{e.dtype}:{int(e.nullable)}"
    scalars = []
    for k in sorted(vars(e)):
        if k == "children" or k.startswith("_oj"):
            continue
        v = vars(e)[k]
        if isinstance(v, Expression):
            if not any(v is c for c in e.children):
                raise _Uncacheable(
                    f"{type(e).__name__} holds a non-child expression")
            continue
        scalars.append(f"{k}={_safe_repr(v)}")
    kids = ",".join(_expr_sig(c, id_map, punch, params) for c in e.children)
    return f"{type(e).__name__}({kids})[{';'.join(scalars)}]"


def _order_sig(o: L.SortOrder, id_map, params) -> str:
    return (f"{_expr_sig(o.child, id_map, False, params)}"
            f":{int(o.ascending)}:{int(o.nulls_first)}")


def _attrs_sig(attrs, id_map) -> str:
    parts = []
    for a in attrs:
        cid = id_map.setdefault(a.expr_id, len(id_map))
        parts.append(f"a{cid}:{a.name}:{a.dtype}:{int(a.nullable)}")
    return ",".join(parts)


def _scan_file_sig(paths) -> str:
    """Per-file identity: (path, size, mtime_ns). A rewritten file — same
    path, new bytes — changes this signature, so the old entry can never
    hit again (and is evicted when the fresh plan inserts)."""
    parts = []
    for p in paths:
        try:
            st = os.stat(p)
        except OSError as e:
            raise _Uncacheable(f"unstatable scan path {p}") from e
        parts.append(f"{p}:{st.st_size}:{st.st_mtime_ns}")
    return ";".join(parts)


def _node_sig(plan, id_map: Dict[int, int], params: List[Literal],
              tokens: List[str], scan_paths: List[str]) -> None:
    """Append one preorder token per node; raises _Uncacheable on node
    kinds the fingerprint does not model (windows, generators, ...)."""
    from ..io.cache import CachedRelation, DeviceCachedRelation
    t = type(plan)
    if isinstance(plan, CachedRelation):
        tokens.append(f"{t.__name__}:{id(plan)}:{plan.generation}:"
                      f"{_attrs_sig(plan.output, id_map)}")
        return
    if isinstance(plan, L.Range):
        tokens.append(f"range:{plan.start}:{plan.end}:{plan.step}:"
                      f"{plan.num_partitions}")
        return
    if isinstance(plan, DeviceCachedRelation):
        # identity fingerprint: the entry keeps the logical plan (and so
        # this relation) alive, which pins the id()
        tokens.append(f"{t.__name__}:{id(plan)}:"
                      f"{_attrs_sig(plan.output, id_map)}")
        return
    if isinstance(plan, L.LocalRelation):
        tokens.append(f"local:{id(plan)}:{plan.num_partitions}:"
                      f"{_attrs_sig(plan.output, id_map)}")
        return
    if isinstance(plan, L.FileScan):
        # the file SET is key material twice over: the path list rides in
        # the structure token, while each file's (size, mtime) identity
        # lands in the separate scan signature
        scan_paths.extend(plan.paths)
        tokens.append(
            f"scan:{plan.fmt}:{_safe_repr(sorted(plan.paths))}:"
            f"{_safe_repr(plan.options)}:{plan.num_partitions}:"
            f"{_attrs_sig(plan._output, id_map)}")
        return
    if t is L.Project:
        sig = ",".join(_expr_sig(e, id_map, True, params)
                       for e in plan.exprs)
        tokens.append(f"project[{sig}]")
    elif t is L.Filter:
        tokens.append(
            f"filter[{_expr_sig(plan.condition, id_map, True, params)}]")
    elif t is L.Aggregate:
        g = ",".join(_expr_sig(e, id_map, False, params)
                     for e in plan.grouping)
        a = ",".join(_expr_sig(e, id_map, False, params)
                     for e in plan.aggregates)
        tokens.append(f"agg[{g}][{a}][{_attrs_sig(plan._output, id_map)}]")
    elif t is L.Join:
        lk = ",".join(_expr_sig(e, id_map, False, params)
                      for e in plan.left_keys)
        rk = ",".join(_expr_sig(e, id_map, False, params)
                      for e in plan.right_keys)
        c = (_expr_sig(plan.condition, id_map, False, params)
             if plan.condition is not None else "")
        tokens.append(f"join:{plan.join_type}[{lk}][{rk}][{c}]")
    elif t is L.Repartition:
        k = ",".join(_expr_sig(e, id_map, False, params) for e in plan.keys)
        tokens.append(
            f"repart:{plan.partitioning}:{plan.num_partitions}[{k}]")
    elif t is L.Sample:
        tokens.append(f"sample:{plan.fraction}:"
                      f"{int(plan.with_replacement)}:{plan.seed}")
    elif t is L.Sort:
        o = ",".join(_order_sig(o, id_map, params) for o in plan.order)
        tokens.append(f"sort:{int(plan.global_sort)}[{o}]")
    elif t is L.Limit:
        tokens.append(f"limit:{plan.n}:{plan.offset}")
    elif t is L.Union:
        tokens.append(f"union:{len(plan.children)}:"
                      f"{_attrs_sig(plan.output, id_map)}")
    else:
        raise _Uncacheable(f"node {t.__name__}")
    for c in plan.children:
        _node_sig(c, id_map, params, tokens, scan_paths)


class Fingerprint:
    """The three-part cache key plus everything the entry needs to pin and
    invalidate: ``key = (struct_sig, scan_sig, conf_sig)``."""

    __slots__ = ("struct_sig", "scan_sig", "conf_sig", "params", "pins")

    def __init__(self, struct_sig: str, scan_sig: str, conf_sig: str,
                 params: List[Literal], pins: List[Any]) -> None:
        self.struct_sig = struct_sig
        self.scan_sig = scan_sig
        self.conf_sig = conf_sig
        self.params = params
        self.pins = pins

    @property
    def key(self) -> Tuple[str, str, str]:
        return (self.struct_sig, self.scan_sig, self.conf_sig)


def fingerprint(plan, conf) -> Optional[Fingerprint]:
    """Normalize `plan` under `conf` — or None when the plan is
    uncacheable (the query plans fresh, every time)."""
    id_map: Dict[int, int] = {}
    params: List[Literal] = []
    tokens: List[str] = []
    scan_paths: List[str] = []
    try:
        _node_sig(plan, id_map, params, tokens, scan_paths)
        scan_sig = _scan_file_sig(scan_paths)
    except (_Uncacheable, AttributeError):
        return None
    pins: List[Any] = [plan]
    conf_items = plan_relevant_conf(conf)
    try:
        conf_sig = ",".join(f"{k}={_safe_repr(str(v))}"
                            for k, v in conf_items.items())
    except _Uncacheable:
        return None
    struct = "|".join(tokens)
    return Fingerprint(
        hashlib.sha256(struct.encode()).hexdigest(),
        hashlib.sha256(scan_sig.encode()).hexdigest() if scan_sig else "",
        hashlib.sha256(conf_sig.encode()).hexdigest(),
        params, pins)


class PlanCacheEntry:
    __slots__ = ("key", "label", "template", "params", "conf_items",
                 "rules", "pins", "hits")

    def __init__(self, fp: Fingerprint, template,
                 conf_items: Dict[str, Any], rules: List[str]) -> None:
        self.key = fp.key
        self.label = hashlib.sha1(
            "/".join(fp.key).encode()).hexdigest()[:10]
        self.template = template
        self.params = fp.params
        self.conf_items = conf_items
        self.rules = rules
        # pins the logical plan (identity-fingerprinted relations stay
        # alive, their id() stable)
        self.pins = fp.pins
        self.hits = 0


class PlanCache:
    """Bounded LRU of physical-plan templates, owned by the process-wide
    QueryScheduler so every session shares one cache. All state under its
    own lock (never the scheduler's — planning happens on submitter
    threads while admission keeps running)."""

    def __init__(self, capacity: int = 256):
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Tuple[str, str, str], PlanCacheEntry]" \
            = OrderedDict()
        self.capacity = int(capacity)
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    def configure(self, capacity: int) -> None:
        with self._lock:
            self.capacity = max(0, int(capacity))
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def lookup(self, key) -> Optional[PlanCacheEntry]:
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            e.hits += 1
        _metrics.counter_inc("plan.cache_hit", entry=e.label)
        return e

    def peek(self, key) -> bool:
        """True when `key` is cached; no LRU/counter side effects (explain)."""
        with self._lock:
            return key in self._entries

    def insert(self, entry: PlanCacheEntry) -> None:
        """Insert, evicting same-structure/same-conf entries whose scan
        identity went stale — the file set changed under the paths, so
        those templates can never legitimately hit again."""
        struct, scan, conf = entry.key
        with self._lock:
            doomed = [k for k in self._entries
                      if k[0] == struct and k[2] == conf and k[1] != scan]
            labels = [self._entries.pop(k).label for k in doomed]
            self.invalidations += len(doomed)
            inserted = self.capacity > 0
            if inserted:
                self._entries[entry.key] = entry
                self._entries.move_to_end(entry.key)
                while len(self._entries) > self.capacity:
                    self._entries.popitem(last=False)
        for lb in labels:
            _metrics.counter_inc("plan.cache_invalidated", entry=lb,
                                 reason="fileset")

    def count_miss(self, label: str = "") -> None:
        _metrics.counter_inc("plan.cache_miss",
                             **({"entry": label} if label else {}))

    def _evict_where(self, pred, reason: str) -> int:
        with self._lock:
            doomed = [k for k, e in self._entries.items() if pred(e)]
            labels = [self._entries.pop(k).label for k in doomed]
            self.invalidations += len(doomed)
        for lb in labels:
            _metrics.counter_inc("plan.cache_invalidated", entry=lb,
                                 reason=reason)
        return len(labels)

    def invalidate_conf(self, key: str, value) -> int:
        """A plan-relevant conf changed: drop every entry planned under a
        DIFFERENT value of that key (entries that never saw the key set
        were planned under its default — also stale)."""
        if not is_plan_relevant(key):
            return 0
        sval = None if value is None else str(value)
        return self._evict_where(
            lambda e: (None if key not in e.conf_items
                       else str(e.conf_items[key])) != sval,
            reason="conf")

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "entries": len(self._entries),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "invalidations": self.invalidations,
                "per_entry_hits": {e.label: e.hits
                                   for e in self._entries.values()},
            }


def build_or_fetch(session, sched, plan, conf):
    """The scheduler's planning step: fingerprint → hit (re-bind literals
    into a fresh clone) or miss (optimize → plan → override → cache the
    never-executed template, run a clone). Returns
    (executable physical plan, "hit"|"miss"|"off"|"uncacheable",
    applied optimizer rule names)."""
    from ..config import PLAN_CACHE_ENABLED
    from ..plan.optimizer import optimize_logical

    def plan_fresh():
        optimized, rules = optimize_logical(plan, conf)
        return session._final_plan(optimized, conf), rules

    cache: Optional[PlanCache] = getattr(sched, "plan_cache", None)
    if not conf.get(PLAN_CACHE_ENABLED) or cache is None:
        final, rules = plan_fresh()
        return final, "off", rules

    fp = fingerprint(plan, conf)
    if fp is None:
        final, rules = plan_fresh()
        cache.count_miss()
        return final, "uncacheable", rules

    entry = cache.lookup(fp.key)
    if entry is not None:
        # parameter-slot re-bind: pair this submission's literals with the
        # template's by walk position (same key ⇒ same walk ⇒ same arity)
        rebind = {id(t): n for t, n in zip(entry.params, fp.params)
                  if t is not n and (t.value != n.value
                                     or t.dtype != n.dtype)}
        return (entry.template.clone_for_execution(rebind or None),
                "hit", entry.rules)

    final, rules = plan_fresh()
    entry = PlanCacheEntry(fp, final, plan_relevant_conf(conf), rules)
    cache.insert(entry)
    cache.count_miss(entry.label)
    # the template never executes: run a clone even on the cold path
    return final.clone_for_execution(), "miss", rules
