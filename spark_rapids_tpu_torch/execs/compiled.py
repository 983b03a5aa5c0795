"""Whole-stage compiled aggregation: scan → filter → project → group-by as
one stage per batch over a direct-indexed group table.

Port of ``spark_rapids_tpu/execs/compiled.py``. The reference traces the
stage into one jitted XLA program and caches it process-wide; eager torch
has nothing to trace or cache, so the stage is a plain function built per
run. The algorithm is the reference's:

* group keys are direct column references of integral/date/bool/string
  type; string keys are dictionary-encoded ONCE per column object
  (memoized), integral domains come from per-column min/max (memoized);
* combined key code = Σ code_k · stride_k over a static domain (each key's
  domain has a trailing null slot);
* the reduction runs chunk by chunk, one-hot [chunk, G] masks with the
  chunk sized so the working set stays near 2^21 cells, into float64 /
  int64 accumulators (deterministic: no scatter, no atomics);
* per-batch carries merge on the host, where the tiny result table is
  finalized and projected, then goes back to the device.

Where a run turns out ineligible (a domain past ``maxGroups``, a value
outside the measured domain) or runs out of device memory (the budget's
``TorchRetryOOM`` / ``TorchSplitAndRetryOOM``, or the allocator's own
``torch.cuda.OutOfMemoryError``), the stage re-runs its original aggregate
subtree (``fallback``) on the general device path, which has the full
spill/retry/split machinery, as the reference does, and counts the re-run
in ``TaskContext.counters["fallback_runs"]``. The batches the stage holds
between its two passes are spillable, and each batch's stage run is the
``device.dispatch`` chaos site under ``failure.with_device_retry``, and
each launch is one ``compiledagg`` dispatch (``execs/opjit.py``).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..columnar.batch import TorchColumnarBatch, gather
from ..columnar.vector import (TorchColumnVector, audited_tolist,
                               host_arrays, row_mask)
from ..expressions import arithmetic as A
from ..expressions import bitwise as BW
from ..expressions import conditional as CO
from ..expressions import mathexprs as M
from ..expressions import nullexprs as N
from ..expressions import predicates as P
from ..expressions.aggregates import (AggregateFunction, Average, Count, Max,
                                      Min, Sum)
from ..expressions.base import (Alias, AttributeReference, Expression,
                                Literal, to_column)
from ..expressions.cast import Cast
from ..types import (BooleanType, DataType, DateType, DecimalType, DoubleType,
                     FloatType, IntegralType, StringType, is_fixed_width)
from .base import (DEBUG, MODERATE, PhysicalPlan, TaskContext, TorchExec,
                   op_time)

_SUPPORTED_AGGS = (Sum, Count, Average, Min, Max)

#: expression classes the stage can evaluate on the device (the
#: reference's: every registered expression that is not host-assisted;
#: a string operand keeps its expression out, as there)
_DEVICE_EXPRS = (Literal, AttributeReference, Alias, A.Add, A.Subtract,
                 A.Multiply, A.Divide, P.EqualTo, P.LessThan,
                 P.LessThanOrEqual, P.GreaterThan, P.GreaterThanOrEqual,
                 P.And, P.Or, P.Not, P.In, P.InSet, N.IsNull, N.IsNotNull,
                 N.Coalesce, CO.If, CO.CaseWhen, M.Round, M.Floor, A.Abs,
                 BW.BitwiseAnd, BW.ShiftRight, Cast)


class _StageFallback(Exception):
    """Internal: abandon the compiled path, run the original subtree."""


# ---------------------------------------------------------------------------
# eligibility
# ---------------------------------------------------------------------------


def _device_pure(expr: Expression) -> bool:
    """Expression evaluates entirely on the device, over fixed-width types."""
    if not isinstance(expr, _DEVICE_EXPRS):
        return False
    if isinstance(expr.dtype, (StringType, DecimalType)) \
            or not is_fixed_width(expr.dtype):
        return False
    return all(_device_pure(c) for c in expr.children)


def _key_eligible(dtype: DataType) -> bool:
    return isinstance(dtype, (IntegralType, DateType, BooleanType, StringType))


def _agg_eligible(fn: AggregateFunction) -> bool:
    if not isinstance(fn, _SUPPORTED_AGGS):
        return False
    if fn.children:
        child = fn.children[0]
        if isinstance(child.dtype, (DecimalType, BooleanType)):
            return False
        if not _device_pure(child):
            return False
    return True


# ---------------------------------------------------------------------------
# pattern extraction
# ---------------------------------------------------------------------------


class _StageSpec:
    """Extracted pattern: source → layers (bottom-up) → grouping/aggs."""

    _PLAN_SPEC = True  # cloned with the plan (execs/base._clone_spec)

    def __init__(self, source, layers, grouping, key_source_ordinals,
                 agg_fns, result_exprs, output, needed_source_ordinals):
        self.source = source
        self.layers = layers  # ("filter", cond) | ("project", exprs, outs)
        self.grouping = grouping
        self.key_source_ordinals = key_source_ordinals
        self.agg_fns = agg_fns
        self.result_exprs = result_exprs
        self.output = output
        self.needed_source_ordinals = needed_source_ordinals


def _identity_source_ordinal(final_ordinal: int, layers) -> Optional[int]:
    """Walk a final-layer ordinal down identity projections to the source
    ordinal; None when any layer computes rather than forwards it."""
    ordinal = final_ordinal
    for layer in reversed(layers):  # top-down
        if layer[0] == "filter":
            continue
        exprs = layer[1]
        if ordinal >= len(exprs):
            return None
        e = exprs[ordinal]
        if isinstance(e, Alias):
            e = e.children[0]
        if not isinstance(e, AttributeReference) or e.ordinal is None:
            return None
        ordinal = e.ordinal
    return ordinal


def _refs(e: Expression) -> List[int]:
    return [a.ordinal for a in
            e.collect(lambda x: isinstance(x, AttributeReference))
            if a.ordinal is not None]


def walk_pure_chain(node: PhysicalPlan):
    """Walk a device-pure filter/project chain downward: (the node under
    it, its layers bottom-up), or None when an expression is not
    device-pure. Identity forwards may carry any type (string keys)."""
    from .basic import TorchFilterExec, TorchProjectExec
    chain: List[Tuple] = []  # top-down
    while isinstance(node, (TorchProjectExec, TorchFilterExec)):
        if isinstance(node, TorchProjectExec):
            for e in node.exprs:
                inner = e.children[0] if isinstance(e, Alias) else e
                if not isinstance(inner, AttributeReference) \
                        and not _device_pure(e):
                    return None
            chain.append(("project", list(node.exprs), list(node.output)))
        else:
            if not _device_pure(node.condition):
                return None
            chain.append(("filter", node.condition))
        node = node.children[0]
    return node, list(reversed(chain))


def try_extract_stage(agg) -> Optional[_StageSpec]:
    """Match TorchHashAggregateExec over [exchange] over a project/filter
    chain over a device source; None when ineligible."""
    from .aggregates import TorchHashAggregateExec, split_result_exprs

    if not isinstance(agg, TorchHashAggregateExec):
        return None
    agg_fns, result_exprs = split_result_exprs(agg.aggregates)
    if not agg_fns or not all(_agg_eligible(f) for f in agg_fns):
        return None
    grouping = list(agg.grouping)
    if not all(isinstance(g, AttributeReference) and g.ordinal is not None
               and _key_eligible(g.dtype) for g in grouping):
        return None

    node = agg.children[0]
    # an exchange below a grouped aggregate only redistributes rows; the
    # stage aggregates globally, so it is skipped
    from ..shuffle.exchange import TorchShuffleExchangeExec
    while isinstance(node, TorchShuffleExchangeExec):
        node = node.children[0]
    walked = walk_pure_chain(node)
    if walked is None or not isinstance(walked[0], TorchExec):
        return None
    node, layers = walked

    # group keys must forward untouched to a source column
    key_source_ordinals = []
    for g in grouping:
        src = _identity_source_ordinal(g.ordinal, layers)
        if src is None or src >= len(node.output):
            return None
        key_source_ordinals.append(src)

    # needed source ordinals (column pruning for the stage inputs)
    cur = set(g.ordinal for g in grouping)
    for f in agg_fns:
        for c in f.children:
            cur.update(_refs(c))
    for layer in reversed(layers):  # top-down
        if layer[0] == "filter":
            cur.update(_refs(layer[1]))
        else:
            nxt = set()
            for o in cur:
                if o < len(layer[1]):
                    nxt.update(_refs(layer[1][o]))
            cur = nxt
    needed = cur

    # needed source columns must be fixed-width, except string group keys
    key_set = set(key_source_ordinals)
    for o in sorted(needed):
        dt = node.output[o].dtype
        if isinstance(dt, StringType):
            if o not in key_set:
                return None
        elif not is_fixed_width(dt) or isinstance(dt, DecimalType):
            return None

    return _StageSpec(node, layers, grouping, key_source_ordinals, agg_fns,
                      result_exprs, list(agg.output),
                      sorted(needed | key_set))


# ---------------------------------------------------------------------------
# key statistics (memoized on column objects)
# ---------------------------------------------------------------------------


class _KeyDomain:
    """Static per-key domain: ints carry [lo, hi]; strings the global
    dictionary. ``size`` includes the trailing null slot."""

    def __init__(self, dtype: DataType):
        self.dtype = dtype
        self.lo: Optional[int] = None
        self.hi: Optional[int] = None
        self.values: List = []
        self.value_code: Dict = {}

    @property
    def size(self) -> int:
        if isinstance(self.dtype, StringType):
            return len(self.values) + 1
        if isinstance(self.dtype, BooleanType):
            return 3
        if self.lo is None:
            return 2  # all-null key column: one dummy value slot + null slot
        return int(self.hi - self.lo) + 2


def _int_stats(col: TorchColumnVector) -> Tuple[Optional[int], Optional[int]]:
    """min/max of valid rows (one sync; memoized on the column object)."""
    memo = getattr(col, "_gb_range", None)
    if memo is not None:
        return memo
    mask = col.validity_or_true()
    data = col.data.to(torch.int64)
    big = torch.iinfo(torch.int64).max
    lo = torch.where(mask, data, big).min()
    hi = torch.where(mask, data, -big - 1).max()
    lo, hi, n = audited_tolist(torch.stack([lo, hi, mask.sum()]), "bounds")
    stats = (None, None) if n == 0 else (int(lo), int(hi))
    col._gb_range = stats
    return stats


def _encode_strings(col: TorchColumnVector):
    """Dictionary-encode a string column on its device: (sorted distinct
    values, int32 codes over the capacity with -1 for nulls and padding).
    The codes come from the strings' key codes (byte order, any length);
    only the distinct values come to the host."""
    from ..expressions.strings import string_key_codes
    valid = col.validity_or_true()
    uniq, inv = torch.unique(string_key_codes([col])[0][valid], sorted=True,
                             return_inverse=True)
    codes = torch.full((col.capacity,), -1, dtype=torch.int32,
                       device=col.device)
    codes[valid] = inv.to(torch.int32)
    # one row a distinct value: the first that holds it
    rows = torch.nonzero(valid).flatten()
    first = torch.full((uniq.shape[0],), col.capacity, dtype=torch.int64,
                       device=col.device).scatter_reduce_(
                           0, inv, rows, "amin")
    values = gather(TorchColumnarBatch([col], col.num_rows), first,
                    uniq.shape[0]).columns[0].to_pylist()
    return values, codes


def _string_codes(col: TorchColumnVector, domain: _KeyDomain) -> torch.Tensor:
    """Global dictionary codes for a string key column (int32 on the
    device; nulls and padding carry -1). The local encode is memoized per
    column object; the local → global remap is a host lookup over the small
    dictionary."""
    memo = getattr(col, "_gb_dict", None)
    if memo is None:
        memo = _encode_strings(col)
        col._gb_dict = memo
    values, local_codes = memo
    remap = np.empty(len(values) + 1, np.int32)
    remap[-1] = -1
    for i, v in enumerate(values):
        if v not in domain.value_code:
            domain.value_code[v] = len(domain.values)
            domain.values.append(v)
        remap[i] = domain.value_code[v]
    if np.array_equal(remap[:-1], np.arange(len(values), dtype=np.int32)):
        return local_codes  # local == global: no remap
    # index -1 (null) wraps to remap's trailing -1 slot
    return torch.from_numpy(remap).to(local_codes.device)[local_codes.long()]


# ---------------------------------------------------------------------------
# the stage body
# ---------------------------------------------------------------------------


def _is_fp(dtype: DataType) -> bool:
    return isinstance(dtype, (FloatType, DoubleType))


def apply_layers(batch: TorchColumnarBatch, layers, mask: torch.Tensor,
                 eval_ctx):
    """Run a stage's filter/project layers (bottom-up) over a full-capacity
    batch: a filter narrows the row mask, a projection forwards or computes
    columns. Returns (the top batch, the mask)."""
    cap = batch.capacity
    for layer in layers:
        if layer[0] == "filter":
            c = to_column(layer[1].eval_device(batch, eval_ctx), batch)
            m = c.data.to(torch.bool)
            if c.validity is not None:
                m = m & c.validity
            mask = mask & m
            continue
        new_cols = []
        for e, a in zip(layer[1], layer[2]):
            src = e.children[0] if isinstance(e, Alias) else e
            if isinstance(src, AttributeReference) and src.ordinal is not None:
                new_cols.append(batch.columns[src.ordinal])
            else:
                new_cols.append(to_column(e.eval_device(batch, eval_ctx),
                                          batch, a.dtype))
        batch = TorchColumnarBatch(new_cols, cap)
    return batch, mask


def _build_stage_fn(spec: _StageSpec, cap: int,
                    domains: List[_KeyDomain], eval_ctx):
    """Build the stage function fn(rowmask, *flat) -> (oob, rowcount,
    *carry) for one batch capacity and key domain."""
    source_attrs = list(spec.source.output)
    needed = spec.needed_source_ordinals
    key_set = {o: k for k, o in enumerate(spec.key_source_ordinals)}
    G = 1
    strides = []
    for d in domains:
        strides.append(G)
        G *= d.size

    # chunk length: bound the [CH, G] working set to ~2^21 cells
    ch = max(256, (1 << 21) // max(G, 1))
    ch = 1 << (ch.bit_length() - 1)
    ch = min(ch, cap)
    n_chunks = max(cap // ch, 1)
    if cap % n_chunks:
        n_chunks = 1  # unpadded capacities: one chunk
    ch = cap // n_chunks

    agg_fns = spec.agg_fns
    layers = spec.layers
    sizes = tuple(d.size for d in domains)
    los = tuple(d.lo for d in domains)

    def stage(rowmask, *flat):
        dev = rowmask.device
        cols: List[Optional[TorchColumnVector]] = [None] * len(source_attrs)
        key_cols: List[Optional[TorchColumnVector]] = [None] * len(domains)
        for j, o in enumerate(needed):
            data, valid = flat[2 * j], flat[2 * j + 1]
            attr = source_attrs[o]
            if o in key_set:
                key_cols[key_set[o]] = TorchColumnVector(
                    attr.dtype, data, valid, cap)
            if not isinstance(attr.dtype, StringType):
                cols[o] = TorchColumnVector(attr.dtype, data,
                                            valid & rowmask, cap)
        for o in range(len(source_attrs)):
            if cols[o] is None:
                cols[o] = TorchColumnVector(
                    source_attrs[o].dtype,
                    torch.zeros(cap, dtype=torch.int32, device=dev),
                    torch.zeros(cap, dtype=torch.bool, device=dev), cap)
        batch, mask = apply_layers(TorchColumnarBatch(cols, cap), layers,
                                   rowmask, eval_ctx)

        # combined group code + out-of-domain detection
        code = torch.zeros(cap, dtype=torch.int32, device=dev)
        oob = torch.zeros((), dtype=torch.bool, device=dev)
        for k, (d_size, d_lo, stride) in enumerate(zip(sizes, los, strides)):
            kc = key_cols[k]
            kv = kc.validity if kc.validity is not None else rowmask
            dt = domains[k].dtype
            if isinstance(dt, StringType):
                raw = kc.data  # global codes; -1 == null
                ci = torch.where(raw >= 0, raw, d_size - 1)
            elif isinstance(dt, BooleanType):
                ci = torch.where(kv, kc.data.to(torch.int32), 2)
            else:
                lo = d_lo if d_lo is not None else 0
                raw = (kc.data.to(torch.int64) - lo).to(torch.int32)
                oob = oob | (mask & kv & ((raw < 0) | (raw >= d_size - 1))).any()
                ci = torch.where(kv, raw.clamp(0, d_size - 2), d_size - 1)
            code = code + ci.to(torch.int32) * stride
        code = code.clamp(0, G - 1)

        # measure inputs, evaluated once over the full batch
        meas = []
        for fn_ in agg_fns:
            if fn_.children:
                c = to_column(fn_.children[0].eval_device(batch, eval_ctx),
                              batch, fn_.children[0].dtype)
                v = c.validity if c.validity is not None else rowmask
                meas.append((c.data, v & mask))
            else:
                meas.append((None, mask))

        carry = _init_carries(agg_fns, meas, G, dev)
        gidx = torch.arange(G, dtype=torch.int32, device=dev)
        for i in range(n_chunks):
            sl = slice(i * ch, (i + 1) * ch)
            onehot = code[sl][:, None] == gidx[None, :]
            _update_carries(carry, onehot, mask[sl], agg_fns,
                            [(None if x is None else x[sl], v[sl])
                             for x, v in meas])
        return (oob,) + tuple(carry)

    return stage


def _init_carries(agg_fns, meas, G: int, dev) -> List[torch.Tensor]:
    i64 = dict(dtype=torch.int64, device=dev)
    init = [torch.zeros(G, **i64)]  # rowcount
    for fn_, (x0, _v0) in zip(agg_fns, meas):
        op = fn_.update_op
        if op == "count":
            init.append(torch.zeros(G, **i64))
        elif op in ("sum", "avg"):
            acc = torch.float64 if op == "avg" else fn_.dtype.torch_dtype
            init.append(torch.zeros(G, dtype=acc, device=dev))
            init.append(torch.zeros(G, **i64))
        elif x0.dtype.is_floating_point:  # min/max
            neutral = float("inf") if op == "min" else float("-inf")
            init.extend([torch.full((G,), neutral, dtype=x0.dtype, device=dev),
                         torch.zeros(G, dtype=torch.bool, device=dev),
                         torch.zeros(G, **i64), torch.zeros(G, **i64)])
        else:
            info = torch.iinfo(x0.dtype)
            neutral = info.max if op == "min" else info.min
            init.extend([torch.full((G,), neutral, dtype=x0.dtype, device=dev),
                         torch.zeros(G, **i64)])
    return init


def _update_carries(carry: List[torch.Tensor], onehot, mask, agg_fns,
                    meas) -> None:
    """Fold one chunk into the carries, in place."""
    carry[0] += (onehot & mask[:, None]).sum(0, dtype=torch.int64)
    ci = 1
    for fn_, (x, v) in zip(agg_fns, meas):
        op = fn_.update_op
        ohv = onehot & v[:, None]
        nn = ohv.sum(0, dtype=torch.int64)
        if x is None or op == "count":  # count(*) or count(x)
            carry[ci] += nn
            ci += 1
        elif op in ("sum", "avg"):
            acc = carry[ci].dtype
            contrib = torch.where(ohv, x[:, None], 0).to(acc)
            carry[ci] += contrib.sum(0)
            carry[ci + 1] += nn
            ci += 2
        elif x.dtype.is_floating_point:  # min/max with Spark NaN ordering
            nan_x = torch.isnan(x)[:, None]
            neutral = float("inf") if op == "min" else float("-inf")
            clean = torch.where(ohv & ~nan_x, x[:, None], neutral)
            if op == "min":
                carry[ci] = torch.minimum(carry[ci], clean.amin(0))
            else:
                carry[ci] = torch.maximum(carry[ci], clean.amax(0))
            carry[ci + 1] |= (ohv & nan_x).any(0)
            carry[ci + 2] += (ohv & ~nan_x).sum(0, dtype=torch.int64)
            carry[ci + 3] += nn
            ci += 4
        else:
            info = torch.iinfo(x.dtype)
            neutral = info.max if op == "min" else info.min
            red = torch.where(ohv, x[:, None], neutral)
            if op == "min":
                carry[ci] = torch.minimum(carry[ci], red.amin(0))
            else:
                carry[ci] = torch.maximum(carry[ci], red.amax(0))
            carry[ci + 1] += nn
            ci += 2


def _np_merge_carries(spec: _StageSpec, carries: List[Tuple]):
    """Merge per-batch host carries into (rowcount, per-fn state dicts).
    Float sums may legitimately reach NaN (+inf and -inf in two batches),
    matching Java: the NaN is the answer, not an accident."""
    with np.errstate(invalid="ignore", over="ignore"):
        rowcount = None
        merged: List[Dict] = []
        for bi, carry in enumerate(carries):
            rc = carry[0]
            rowcount = rc.copy() if rowcount is None else rowcount + rc
            ci = 1
            for i, fn in enumerate(spec.agg_fns):
                op = fn.update_op
                first = bi == 0
                if first:
                    merged.append(None)
                st = merged[i]
                if op == "count":
                    merged[i] = {"count": carry[ci].copy()} if first \
                        else {"count": st["count"] + carry[ci]}
                    ci += 1
                elif op in ("sum", "avg"):
                    k2 = "nonnull" if op == "sum" else "count"
                    merged[i] = {"sum": carry[ci].copy(),
                                 k2: carry[ci + 1].copy()} if first else \
                        {"sum": st["sum"] + carry[ci],
                         k2: st[k2] + carry[ci + 1]}
                    ci += 2
                elif fn.children and _is_fp(fn.children[0].dtype):
                    comb = np.minimum if op == "min" else np.maximum
                    if first:
                        merged[i] = {"clean": carry[ci].copy(),
                                     "nan_any": carry[ci + 1].copy(),
                                     "nonnan": carry[ci + 2].copy(),
                                     "nonnull": carry[ci + 3].copy()}
                    else:
                        merged[i] = {"clean": comb(st["clean"], carry[ci]),
                                     "nan_any": st["nan_any"] | carry[ci + 1],
                                     "nonnan": st["nonnan"] + carry[ci + 2],
                                     "nonnull": st["nonnull"] + carry[ci + 3]}
                    ci += 4
                else:
                    comb = np.minimum if op == "min" else np.maximum
                    merged[i] = {op: carry[ci].copy(),
                                 "nonnull": carry[ci + 1].copy()} if first \
                        else {op: comb(st[op], carry[ci]),
                              "nonnull": st["nonnull"] + carry[ci + 1]}
                    ci += 2
        return rowcount, merged


def _np_finalize(fn: AggregateFunction, st: Optional[Dict], idx: np.ndarray):
    """Merged state → (values, validity) over the occupied group indices,
    with Spark's null/NaN semantics."""
    op = fn.update_op
    n = len(idx)
    carrier = np.dtype(fn.dtype.np_dtype)
    if st is None:  # empty input, global agg
        if op == "count":
            return np.zeros(n, np.int64), np.ones(n, np.bool_)
        return np.zeros(n, carrier), np.zeros(n, np.bool_)
    if op == "count":
        return st["count"][idx], np.ones(n, np.bool_)
    if op == "sum":
        return st["sum"][idx], st["nonnull"][idx] > 0
    if op == "avg":
        cnt = st["count"][idx]
        valid = cnt > 0
        with np.errstate(invalid="ignore"):
            vals = st["sum"][idx] / np.where(valid, cnt, 1)
        return vals.astype(np.float64), valid
    valid = st["nonnull"][idx] > 0
    if "clean" in st:  # fp: Spark NaN ordering
        vals = st["clean"][idx].copy()
        if op == "min":
            vals[(st["nonnan"][idx] == 0) & valid] = np.nan
        else:
            vals[st["nan_any"][idx] & valid] = np.nan
    else:
        vals = st[op][idx]
    return vals, valid


class TorchCompiledAggStageExec(TorchExec):
    """The fused scan→filter→project→group-by stage."""

    def __init__(self, spec: _StageSpec, fallback: PhysicalPlan,
                 max_groups: int):
        super().__init__([spec.source])
        self.spec = spec
        self.fallback = fallback
        self.max_groups = max_groups

    @property
    def output(self):
        return self.spec.output

    def num_partitions(self) -> int:
        return 1

    def collect_nodes(self):
        # the fallback subtree holds exchanges whose blocks the session
        # releases when the query ends
        out = super().collect_nodes()
        seen = {id(n) for n in out}
        return out + [n for n in self.fallback.collect_nodes()
                      if id(n) not in seen]

    def node_desc(self) -> str:
        keys = ", ".join(g.name for g in self.spec.grouping) or "<global>"
        return f"TorchCompiledAggStage[keys={keys}]"

    def additional_metrics(self):
        return {"stageTime": MODERATE, "numGroups": DEBUG,
                "fallbackReruns": DEBUG}

    def internal_do_execute_columnar(self, idx: int,
                                     ctx: TaskContext) -> Iterator:
        from ..memory.hbm import TorchRetryOOM, TorchSplitAndRetryOOM
        from ..memory.retry import _release_device_cache
        try:
            with op_time(ctx, self, "stageTime"):
                result = self._run_compiled(ctx)
        except (_StageFallback, TorchRetryOOM, TorchSplitAndRetryOOM):
            # ineligible at runtime OR memory pressure: the general path
            # has the full spill/retry/split machinery
            result = None
        except torch.cuda.OutOfMemoryError:
            result = None
            _release_device_cache()
        if result is None:
            # re-run on the general (sort-based) device path
            ctx.counters["fallback_runs"] += 1
            self.metrics["fallbackReruns"].add(1)
            for p in range(self.fallback.num_partitions()):
                yield from self.fallback.execute_partition(
                    p, ctx.for_partition(p))
            return
        self.metrics["numGroups"].add(result.num_rows)
        yield result

    def _run_compiled(self, ctx: TaskContext) -> TorchColumnarBatch:
        from ..memory.spill import SpillableColumnarBatch
        spec = self.spec
        src = self.children[0]
        held: List[SpillableColumnarBatch] = []
        domains = [_KeyDomain(g.dtype) for g in spec.grouping]
        try:
            # pass 1: collect batches (spillable) + key statistics
            # (memoized on the column objects, so cached relations pay
            # once)
            for p in range(src.num_partitions()):
                pctx = ctx.for_partition(p)
                try:
                    for b in src.execute_partition(p, pctx):
                        if b.num_rows:
                            self._update_domains(b, domains)
                            held.append(SpillableColumnarBatch(b))
                        del b  # the catalog's entry is the stage's holder
                finally:
                    pctx.complete()
            G = 1
            for d in domains:
                G *= d.size
            if G > self.max_groups:
                raise _StageFallback(f"{G} groups exceed maxGroups "
                                     f"{self.max_groups}")
            # pass 2: one stage run per batch; the host reads the carries
            # once every batch is queued
            outs = [self._run_batch(sb.get_batch(), domains, ctx)
                    for sb in held]
            flat = iter(host_arrays([t for out in outs for t in out],
                                    "fetch"))
            host = [[next(flat) for _ in out] for out in outs]
        finally:
            for sb in held:
                sb.close()
        if any(bool(h[0]) for h in host):
            raise _StageFallback("a key value fell outside its measured "
                                 "domain")
        return self._assemble(domains, [h[1:] for h in host], ctx)

    def _update_domains(self, b: TorchColumnarBatch,
                        domains: List[_KeyDomain]) -> None:
        for k, o in enumerate(self.spec.key_source_ordinals):
            d = domains[k]
            col = b.columns[o]
            if isinstance(d.dtype, StringType):
                _string_codes(col, d)  # grows the global dictionary
                if len(d.values) + 1 > self.max_groups:
                    raise _StageFallback("string key dictionary exceeds "
                                         "maxGroups")
            elif not isinstance(d.dtype, BooleanType):
                lo, hi = _int_stats(col)
                if lo is not None:
                    d.lo = lo if d.lo is None else min(d.lo, lo)
                    d.hi = hi if d.hi is None else max(d.hi, hi)

    def _run_batch(self, b: TorchColumnarBatch, domains: List[_KeyDomain],
                   ctx: TaskContext):
        spec = self.spec
        cap = b.capacity
        rowmask = row_mask(b.num_rows, cap, b.device)
        key_ord = {o: k for k, o in enumerate(spec.key_source_ordinals)}
        flat = []
        for o in spec.needed_source_ordinals:
            col = b.columns[o]
            if o in key_ord and isinstance(domains[key_ord[o]].dtype,
                                           StringType):
                codes = _string_codes(col, domains[key_ord[o]])
                flat.extend([codes, codes >= 0])
            else:
                flat.extend([col.data, col.validity if col.validity is not None
                             else rowmask])
        fn = _build_stage_fn(spec, cap, domains, ctx.eval_ctx)
        from ..chaos import inject
        from ..failure import with_device_retry
        from . import opjit

        def dispatch():
            # the stage is pure over its device inputs: a transient device
            # error re-runs it (reference compiled.py:837-843)
            inject("device.dispatch", detail="compiled_stage")
            opjit.record_external_dispatch("compiledagg")
            return fn(rowmask, *flat)

        return with_device_retry(dispatch, ctx.conf)

    def _assemble(self, domains: List[_KeyDomain], carries: List[Tuple],
                  ctx: TaskContext) -> TorchColumnarBatch:
        """Host work over the fetched carries: merge, finalize, decode keys,
        project results over the tiny table; the result goes to the task's
        device for the operators above (a join or a sort may meet a device
        batch there)."""
        from .aggregates import _bind_agg_refs
        spec = self.spec
        G = 1
        strides = []
        for d in domains:
            strides.append(G)
            G *= d.size
        names = [a.name for a in spec.output]

        if not carries:
            if spec.grouping:  # grouped agg over empty input: no rows
                return TorchColumnarBatch(
                    [TorchColumnVector.from_scalar(None, a.dtype, 0,
                                                   device=ctx.device)
                     for a in spec.output], 0, names)
            rowcount = np.zeros(G, np.int64)
            states: List[Optional[Dict]] = [None] * len(spec.agg_fns)
        else:
            rowcount, states = _np_merge_carries(spec, carries)

        occ_idx = np.nonzero(rowcount > 0)[0] if spec.grouping \
            else np.array([0])
        n = len(occ_idx)

        def host_col(dtype, vals, valid):
            return TorchColumnVector.from_numpy(dtype, vals, valid,
                                                capacity=n, bucket=False)

        key_cols = []
        for d, stride in zip(domains, strides):
            comp = (occ_idx // stride) % d.size
            valid = comp != d.size - 1
            if isinstance(d.dtype, StringType):
                vals = np.array([d.values[c] if ok else None
                                 for c, ok in zip(comp, valid)], dtype=object)
            elif isinstance(d.dtype, BooleanType):
                valid = comp != 2
                vals = comp.astype(np.bool_)
            else:
                vals = (d.lo if d.lo is not None else 0) + comp
            key_cols.append(host_col(d.dtype, vals, valid))
        agg_cols = [host_col(fn.dtype, *_np_finalize(fn, st, occ_idx))
                    for fn, st in zip(spec.agg_fns, states)]
        table = TorchColumnarBatch(key_cols + agg_cols, n)

        ng = len(spec.grouping)
        out_cols = list(key_cols)
        for expr, attr in zip(spec.result_exprs, spec.output[ng:]):
            bound = _bind_agg_refs(expr, ng, spec.grouping)
            out_cols.append(to_column(bound.eval_device(table, ctx.eval_ctx),
                                      table, attr.dtype))
        return TorchColumnarBatch(out_cols, n, names).to_device(ctx.device)


def compile_agg_stages(plan: PhysicalPlan, conf) -> PhysicalPlan:
    """Post-pass over the physical tree: replace eligible aggregate subtrees
    with compiled stages (spark.rapids.tpu.agg.compiledStage.enabled)."""
    from ..config import (ANSI_ENABLED, COMPILED_AGG_ENABLED,
                          COMPILED_AGG_MAX_GROUPS)
    if not conf.get(COMPILED_AGG_ENABLED) or conf.get(ANSI_ENABLED):
        return plan
    max_groups = conf.get(COMPILED_AGG_MAX_GROUPS)

    def rewrite(node: PhysicalPlan) -> PhysicalPlan:
        spec = try_extract_stage(node)
        if spec is not None:
            return TorchCompiledAggStageExec(spec, node, max_groups)
        node.children = [rewrite(c) for c in node.children]
        return node

    return rewrite(plan)
