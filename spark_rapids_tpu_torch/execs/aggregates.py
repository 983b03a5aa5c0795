"""Hash-aggregate execs: the CPU plan node and the device's general,
sort-based aggregate (port of ``spark_rapids_tpu/execs/aggregates.py``).

Algorithm (the reference's): encode the group keys as order- and
equality-preserving integers, sort the rows lexicographically by them with
stable sorts, find the segment boundaries, and reduce each segment. The
reference reduces with ``.at[seg_ids]`` scatters; on CUDA a float scatter
adds through atomics and repeated runs can differ in the last bits, so the
port reduces the contiguous segments instead:

* counts and integer sums: an int64 prefix sum read at the segment bounds
  (exact, and wrapping as Spark's non-ANSI long sum does);
* float sums and float min/max: ``torch.segment_reduce`` over the segment
  lengths (a fixed reduction order a segment, no atomics);
* integer min/max: ``scatter_reduce`` (min and max are exact in any order).

The host reads one number a batch, the group count that sizes the group
table, together with the check that every string key fits its packed
encoding. Rows stay on the device throughout. Over ``batchSizeRows`` rows
a grouped aggregate sorts out of core and aggregates key-aligned slices
(``_sort_fallback``); a global one merges per-chunk states
(``_global_chunked``). The reference's opjit-traced and fused one-launch
variants of ``_aggregate_batch`` are a JAX compile cache that gives the
eager body's results; they are not ported.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..columnar.batch import TorchColumnarBatch, concat_batches, gather
from ..columnar.vector import TorchColumnVector, bucket_capacity, row_mask
from ..expressions.aggregates import AggregateFunction, Count
from ..expressions.base import AttributeReference, Expression, to_column
from ..types import DoubleT, LongT, StringType, is_fixed_width
from .base import (PhysicalPlan, TaskContext, TorchExec, bind_all,
                   bind_references)
from .cpu import _HostEngineNotPorted


def split_result_exprs(aggregates: Sequence[Expression]):
    """Split each output expression into its AggregateFunction leaves + a
    result projection over them (leaf i becomes ``__agg_i``, expr_id
    -(i+1))."""
    agg_fns: List[AggregateFunction] = []
    result_exprs: List[Expression] = []
    for e in aggregates:
        def rule(x: Expression):
            if isinstance(x, AggregateFunction):
                for i, existing in enumerate(agg_fns):
                    if existing is x:
                        idx = i
                        break
                else:
                    agg_fns.append(x)
                    idx = len(agg_fns) - 1
                return AttributeReference(f"__agg_{idx}", x.dtype, x.nullable,
                                          expr_id=-(idx + 1))
            return None
        result_exprs.append(e.transform(rule))
    return agg_fns, result_exprs


def _bind_agg_refs(expr: Expression, num_keys: int,
                   grouping: Sequence[Expression] = ()) -> Expression:
    """Rewrite ``__agg_i`` refs to ordinals in the aggregated table (keys
    first); references to grouping attributes rebind to their key slot."""
    key_slot = {g.expr_id: j for j, g in enumerate(grouping)
                if isinstance(g, AttributeReference)}

    def rule(e: Expression):
        if isinstance(e, AttributeReference) and e.expr_id < 0:
            i = -e.expr_id - 1
            return AttributeReference(e.name, e.dtype, e.nullable,
                                      ordinal=num_keys + i, expr_id=e.expr_id)
        if isinstance(e, AttributeReference) and e.expr_id in key_slot:
            return AttributeReference(e.name, e.dtype, e.nullable,
                                      ordinal=key_slot[e.expr_id],
                                      expr_id=e.expr_id)
        return None

    return expr.transform(rule)


class CpuHashAggregateExec(_HostEngineNotPorted):
    """Grouped aggregate on the host (reference ``CpuHashAggregateExec``).
    ``per_partition``: the child is hash-distributed by the grouping keys
    (a hash exchange below), so each partition aggregates on its own."""

    def __init__(self, grouping: Sequence[Expression],
                 aggregates: Sequence[Expression], child: PhysicalPlan,
                 output: List[AttributeReference],
                 per_partition: bool = False):
        super().__init__([child])
        self.grouping = bind_all(list(grouping), child.output)
        self.aggregates = [bind_references(a, child.output)
                           for a in aggregates]
        self._output = output
        self.per_partition = per_partition

    @property
    def output(self):
        return self._output

    def num_partitions(self) -> int:
        return self.children[0].num_partitions() if self.per_partition else 1

    def node_desc(self) -> str:
        return f"CpuHashAggregate[keys={len(self.grouping)}]"


# ---------------------------------------------------------------------------
# key encodings
# ---------------------------------------------------------------------------

_INT64_SIGN = -2**63
#: string keys are packed into one int64 (up to 7 bytes + the length)
MAX_PACKED_KEY_BYTES = 7


def pack_string_keys(col: TorchColumnVector) -> torch.Tensor:
    """Each string of up to 7 bytes as one int64 whose signed order is the
    strings' byte-wise lexicographic order: the bytes big-endian in bits
    63..8 (zero padded), the length in bits 7..0, the top bit flipped.
    Equal strings give equal keys, so the one encoding serves grouping and
    sorting. Longer strings are cut: ``string_key_overflow`` detects them.
    Nulls and padding rows carry 0."""
    offs = col.offsets.to(torch.int64)
    starts = offs[:-1]
    lens = offs[1:] - starts
    key = lens.clamp(max=MAX_PACKED_KEY_BYTES)
    last = col.data.numel() - 1
    for j in range(MAX_PACKED_KEY_BYTES if last >= 0 else 0):
        byte = col.data[(starts + j).clamp(max=last)].to(torch.int64)
        key = key | (torch.where(j < lens, byte, 0) << (56 - 8 * j))
    return torch.where(col.validity_or_true(), key ^ _INT64_SIGN, 0)


def string_key_overflow(col: TorchColumnVector) -> torch.Tensor:
    """Device bool: some valid string is longer than the packed 7 bytes."""
    offs = col.offsets.to(torch.int64)
    return (col.validity_or_true()
            & (offs[1:] - offs[:-1] > MAX_PACKED_KEY_BYTES)).any()


def unpack_string_key(key: int) -> str:
    """Host decode of one ``pack_string_keys`` value."""
    u = (key ^ _INT64_SIGN) % (1 << 64)
    n = u & 0xFF
    return bytes((u >> (56 - 8 * j)) & 0xFF for j in range(n)).decode()


def _sortable_bits(col: TorchColumnVector) -> torch.Tensor:
    """Order/equality-preserving integer encoding of a fixed-width column
    (floats: sign-flipped IEEE bits with NaN canonicalized and -0 → 0).
    The reference narrows float64 to float32 on backends without 64-bit
    bitcasts (``utils/hw.sortable_float_dtype``); torch has them on every
    device, so float64 keeps all its bits here."""
    d = col.data
    if d.is_floating_point():
        zero = torch.zeros((), dtype=d.dtype, device=d.device)
        d = torch.where(d == 0.0, zero, d)
        d = torch.where(torch.isnan(d), torch.full((), float("nan"),
                                                   dtype=d.dtype,
                                                   device=d.device), d)
        if d.dtype == torch.float64:
            bits, sign = d.view(torch.int64), _INT64_SIGN
        else:
            bits, sign = d.view(torch.int32), -2**31
        return torch.where(bits < 0, ~bits, bits | sign) ^ sign
    if d.dtype == torch.bool:
        return d.to(torch.int32)
    return d


def encode_group_keys(cols: List[TorchColumnVector], num_rows: int,
                      capacity: int):
    """Per-key (sortable_value, validity) pairs; strings are packed
    (``pack_string_keys``: equality and lexicographic order preserved).
    Null lanes carry 0, so two nulls compare equal whatever payload an
    expression left under them."""
    out = []
    for c in cols:
        vals = pack_string_keys(c) if isinstance(c.dtype, StringType) \
            else _sortable_bits(c)
        if c.validity is not None:
            vals = torch.where(c.validity, vals,
                               torch.zeros((), dtype=vals.dtype,
                                           device=vals.device))
        out.append((vals, c.validity))
    return out


def segment_boundaries(enc, perm: torch.Tensor, rowmask: torch.Tensor):
    """Group boundaries over key-sorted rows: (is_new, seg_ids, n_groups),
    ``n_groups`` a device scalar (callers sync when they need the int)."""
    cap = perm.shape[0]
    dev = perm.device
    is_new = torch.zeros(cap, dtype=torch.bool, device=dev)
    is_new[0] = True
    for vals, validity in enc:
        sv = vals[perm]
        neq = torch.ones(cap, dtype=torch.bool, device=dev)
        neq[1:] = sv[1:] != sv[:-1]
        if validity is not None:
            nv = validity[perm]
            neq[1:] |= nv[1:] != nv[:-1]
        is_new |= neq
    pad = rowmask[perm]
    is_new &= pad
    seg_ids = torch.cumsum(is_new, 0, dtype=torch.int32) - 1
    ng = torch.where(pad, seg_ids, -1).max() + 1
    return is_new, seg_ids, ng


def lex_sort_permutation(keys, num_rows: int, capacity: int,
                         orders: Optional[List[Tuple[bool, bool]]] = None
                         ) -> torch.Tensor:
    """Stable lexicographic sort permutation over encoded keys.
    keys: list of (values, validity_or_None); orders: per-key (ascending,
    nulls_first); padding rows always sort last."""
    dev = keys[0][0].device
    perm = torch.arange(capacity, dtype=torch.int64, device=dev)
    if orders is None:
        orders = [(True, True)] * len(keys)
    # least-significant key first, each pass a stable sort. Within one key
    # the order is (null group, value): a value pass then a null-flag pass,
    # since a sentinel encoding would collide with real extreme values
    for (vals, validity), (asc, nulls_first) in list(zip(keys, orders))[::-1]:
        v = vals[perm]
        if validity is not None:
            # null lanes hold arbitrary payloads: pin them so the value pass
            # keeps the earlier passes' order among them
            v = torch.where(validity[perm], v,
                            torch.zeros((), dtype=v.dtype, device=dev))
        if not asc:
            v = _invert_order(v)
        perm = perm[torch.argsort(v, stable=True)]
        if validity is not None:
            nv = validity[perm]
            flag = (nv if nulls_first else ~nv).to(torch.int8)
            perm = perm[torch.argsort(flag, stable=True)]
    pad = (perm >= num_rows).to(torch.int8)
    return perm[torch.argsort(pad, stable=True)]


def _invert_order(v: torch.Tensor) -> torch.Tensor:
    if v.dtype == torch.int64:
        return -1 ^ v
    return -1 ^ v.to(torch.int32)


# ---------------------------------------------------------------------------
# segmented reductions
# ---------------------------------------------------------------------------


class _Segments:
    """Rows in sorted order (``perm[:n]``), grouped into contiguous
    segments: group g spans sorted positions [bounds[g], bounds[g+1]);
    bounds[g] is n for every g past the last group."""

    def __init__(self, perm, seg_ids, bounds, n: int, n_groups: int,
                 g_cap: int):
        self.perm = perm[:n]
        self.seg_ids = seg_ids[:n].to(torch.int64)
        self.bounds = bounds
        self.lengths = bounds[1:] - bounds[:-1]
        self.n = n
        self.n_groups = n_groups
        self.g_cap = g_cap

    def count(self, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """Per-group count of True (a prefix sum read at the bounds); with
        no mask, the segment lengths."""
        return self.lengths if mask is None \
            else self.int_sum(mask.to(torch.int64))

    def int_sum(self, x: torch.Tensor) -> torch.Tensor:
        c = torch.zeros(self.n + 1, dtype=torch.int64, device=x.device)
        c[1:] = torch.cumsum(x.to(torch.int64), 0)
        return c[self.bounds[1:]] - c[self.bounds[:-1]]

    def float_reduce(self, x: torch.Tensor, op: str,
                     empty: float) -> torch.Tensor:
        """Per-group sum/min/max of x (sorted order), ``empty`` past the
        last group."""
        out = torch.full((self.g_cap,), empty, dtype=x.dtype, device=x.device)
        if self.n and self.n_groups:
            out[:self.n_groups] = torch.segment_reduce(
                x, op, lengths=self.lengths[:self.n_groups], unsafe=True)
        return out


def _segment_update(fn: AggregateFunction, col: Optional[TorchColumnVector],
                    segs: _Segments) -> Dict[str, torch.Tensor]:
    """Per-group partial state of one aggregate over the sorted rows."""
    op = fn.update_op
    valid = None  # None: every row is valid
    if col is not None and col.validity is not None:
        valid = col.validity[segs.perm]
    if op == "count":
        return {"count": segs.count(valid)}
    if col.offsets is not None:
        # the tagging layer keeps string min/max off the device
        raise NotImplementedError(f"{op} of strings not yet ported")
    data = col.data[segs.perm]
    nn = segs.count(valid)
    if valid is not None and op in ("sum", "avg"):
        data = torch.where(valid, data, torch.zeros((), dtype=data.dtype,
                                                    device=data.device))
    if op == "sum" and not fn.dtype.torch_dtype.is_floating_point:
        return {"sum": segs.int_sum(data), "nonnull": nn}
    if op in ("sum", "avg"):
        key = "nonnull" if op == "sum" else "count"
        return {"sum": segs.float_reduce(data.to(torch.float64), "sum", 0.0),
                key: nn}
    if op in ("min", "max"):
        if data.is_floating_point():
            # Spark orders NaN above everything: min skips NaN unless the
            # whole group is NaN; max is NaN if any NaN is present
            neutral = float("inf") if op == "min" else float("-inf")
            nan = torch.isnan(data)
            real = ~nan if valid is None else valid & ~nan
            clean = torch.where(real, data,
                                torch.full((), neutral, dtype=data.dtype,
                                           device=data.device))
            red = segs.float_reduce(clean, op, neutral)
            if op == "min":
                all_nan = (segs.count(real) == 0) & (nn > 0)
                red = torch.where(all_nan, float("nan"), red)
            else:
                has_nan = nan if valid is None else valid & nan
                red = torch.where(segs.count(has_nan) > 0, float("nan"), red)
            return {op: red, "nonnull": nn}
        info = torch.iinfo(data.dtype)
        neutral = info.max if op == "min" else info.min
        if valid is not None:
            data = torch.where(valid, data, neutral)
        red = torch.full((segs.g_cap,), neutral, dtype=data.dtype,
                         device=data.device).scatter_reduce(
            0, segs.seg_ids, data,
            reduce="amin" if op == "min" else "amax", include_self=True)
        return {op: red, "nonnull": nn}
    raise NotImplementedError(f"update op {op} not yet ported")


def _evaluate_agg(fn: AggregateFunction, state: Dict[str, torch.Tensor],
                  n_groups: int, cap: int) -> TorchColumnVector:
    dev = next(iter(state.values())).device
    gmask = row_mask(n_groups, cap, dev)
    op = fn.update_op
    if op == "count":
        return TorchColumnVector(LongT, state["count"], None, n_groups)
    if op == "sum":
        valid = (state["nonnull"] > 0) & gmask
        return TorchColumnVector(fn.dtype, state["sum"], valid, n_groups)
    if op == "avg":
        cnt = state["count"]
        valid = (cnt > 0) & gmask
        data = state["sum"] / torch.where(cnt > 0, cnt, 1).to(torch.float64)
        return TorchColumnVector(DoubleT, torch.where(valid, data, 0.0),
                                 valid, n_groups)
    if op in ("min", "max"):
        valid = (state["nonnull"] > 0) & gmask
        data = torch.where(valid, state[op],
                           torch.zeros((), dtype=state[op].dtype, device=dev))
        return TorchColumnVector(fn.dtype, data, valid, n_groups)
    raise NotImplementedError(f"aggregate {op} not yet ported")


def _global_mergeable(fn: AggregateFunction) -> bool:
    """Whether the ungrouped chunked-merge path can combine this
    aggregate's partial states."""
    op = fn.update_op
    if op in ("count", "sum", "avg"):
        return True
    if op in ("min", "max"):
        child = fn.children[0] if fn.children else None
        return child is None or is_fixed_width(child.dtype)
    return False


def _merge_global_states(fn: AggregateFunction,
                         states: List[Dict]) -> Dict:
    """Merge per-chunk one-group partial states into one state dict (the
    reference's merge expressions)."""
    if len(states) == 1:
        return states[0]
    op = fn.update_op
    stk = {k: torch.stack([s[k] for s in states]) for k in states[0]}
    if op == "count":
        return {"count": stk["count"].sum(0)}
    if op == "sum":
        return {"sum": stk["sum"].sum(0), "nonnull": stk["nonnull"].sum(0)}
    if op == "avg":
        return {"sum": stk["sum"].sum(0), "count": stk["count"].sum(0)}
    if op in ("min", "max"):
        red, nn = stk[op], stk["nonnull"]
        nonnull = nn.sum(0)
        has = nn > 0
        if red.is_floating_point():
            # a chunk's red is NaN iff (min) the chunk was all NaN, (max)
            # the chunk held a NaN
            isnan = torch.isnan(red)
            if op == "max":
                m = torch.where(has & ~isnan, red, float("-inf")).amax(0)
                m = torch.where((has & isnan).any(0), float("nan"), m)
            else:
                m = torch.where(has & ~isnan, red, float("inf")).amin(0)
                m = torch.where(~(has & ~isnan).any(0) & (nonnull > 0),
                                float("nan"), m)
            return {op: m, "nonnull": nonnull}
        info = torch.iinfo(red.dtype)
        clean = torch.where(has, red, info.max if op == "min" else info.min)
        m = clean.amin(0) if op == "min" else clean.amax(0)
        return {op: m, "nonnull": nonnull}
    raise NotImplementedError(f"merge of {op} not yet ported")


# ---------------------------------------------------------------------------
# the device exec
# ---------------------------------------------------------------------------


class TorchHashAggregateExec(TorchExec):
    """Sort-based grouped aggregation on the device (complete mode). Over a
    hash exchange (``per_partition``) each partition aggregates its own
    groups; otherwise it reads every partition of its child into one
    aggregation."""

    def __init__(self, grouping: Sequence[Expression],
                 aggregates: Sequence[Expression], child: PhysicalPlan,
                 output: List[AttributeReference],
                 per_partition: bool = False):
        super().__init__([child])
        self.grouping = bind_all(list(grouping), child.output)
        self.aggregates = [bind_references(a, child.output)
                           for a in aggregates]
        self._output = output
        self.per_partition = per_partition

    @property
    def output(self):
        return self._output

    def num_partitions(self) -> int:
        return self.children[0].num_partitions() if self.per_partition else 1

    def node_desc(self) -> str:
        return f"TorchHashAggregate[keys={len(self.grouping)}]"

    def internal_do_execute_columnar(self, idx: int,
                                     ctx: TaskContext) -> Iterator:
        child = self.children[0]
        batches: List[TorchColumnarBatch] = []
        if self.per_partition:
            batches.extend(child.execute_partition(idx, ctx))
        else:
            for p in range(child.num_partitions()):
                batches.extend(child.execute_partition(p,
                                                       ctx.for_partition(p)))
        yield from self.aggregate_batches(batches, ctx)

    def aggregate_batches(self, batches: List[TorchColumnarBatch],
                          ctx: TaskContext) -> Iterator:
        agg_fns, result_exprs = split_result_exprs(self.aggregates)
        if not batches:
            if not self.grouping:
                yield self._empty_global_result(agg_fns, result_exprs, ctx)
            return
        max_rows = ctx.conf.batch_size_rows
        total = sum(b.num_rows for b in batches)
        if self.grouping and total > max_rows:
            # out-of-core sort by the grouping keys, then aggregate
            # key-aligned slices: no group straddles two slices
            ctx.counters["sort_fallback_runs"] += 1
            yield from self._sort_fallback(batches, agg_fns, result_exprs,
                                           ctx, max_rows)
            return
        if not self.grouping and total > max_rows and len(batches) > 1 \
                and all(_global_mergeable(fn) for fn in agg_fns):
            # per-chunk partial states merged into one final state: the
            # whole input is never concatenated
            yield self._global_chunked(batches, agg_fns, result_exprs, ctx,
                                       max_rows)
            return
        batch = concat_batches(batches)
        yield self._aggregate_batch(batch, agg_fns, result_exprs, ctx)

    def _sort_fallback(self, batches, agg_fns, result_exprs, ctx,
                       max_rows: int) -> Iterator:
        from ..plan.logical import SortOrder
        from .oocsort import OutOfCoreSorter
        ooc = OutOfCoreSorter([SortOrder(g, True, True)
                               for g in self.grouping], ctx)
        try:
            for b in batches:
                ooc.add_batch(b)
            for sl in ooc.iter_sorted(max_rows, group_boundaries=True):
                yield self._aggregate_batch(sl, agg_fns, result_exprs, ctx)
        finally:
            ooc.close()

    def _eval_agg_input(self, fn, batch: TorchColumnarBatch,
                        ctx: TaskContext) -> Optional[TorchColumnVector]:
        if fn.children:
            return to_column(fn.children[0].eval_device(batch, ctx.eval_ctx),
                             batch, fn.children[0].dtype)
        return None

    def _global_chunked(self, batches, agg_fns, result_exprs, ctx,
                        max_rows: int) -> TorchColumnarBatch:
        """Ungrouped aggregate over the row budget: chunk the input, compute
        a one-group partial state per chunk, merge states, finalize once."""
        chunks: List[List[TorchColumnarBatch]] = []
        cur: List[TorchColumnarBatch] = []
        cur_rows = 0
        for b in batches:
            if cur and cur_rows + b.num_rows > max_rows:
                chunks.append(cur)
                cur, cur_rows = [], 0
            cur.append(b)
            cur_rows += b.num_rows
        if cur:
            chunks.append(cur)
        g_cap = bucket_capacity(1)
        per_fn: List[List[Dict]] = [[] for _ in agg_fns]
        for group in chunks:
            chunk = concat_batches(group)
            segs = self._global_segments(chunk, g_cap)
            for i, fn in enumerate(agg_fns):
                per_fn[i].append(_segment_update(
                    fn, self._eval_agg_input(fn, chunk, ctx), segs))
        agg_cols = [_evaluate_agg(fn, _merge_global_states(fn, sts), 1, g_cap)
                    for fn, sts in zip(agg_fns, per_fn)]
        return self._project_result(TorchColumnarBatch(agg_cols, 1), [],
                                    result_exprs, ctx)

    @staticmethod
    def _global_segments(batch: TorchColumnarBatch, g_cap: int) -> _Segments:
        """One segment over every row, in input order."""
        dev = batch.device
        cap, n = batch.capacity, batch.num_rows
        bounds = torch.full((g_cap + 1,), n, dtype=torch.int64, device=dev)
        bounds[0] = 0
        return _Segments(torch.arange(cap, device=dev),
                         torch.zeros(cap, dtype=torch.int32, device=dev),
                         bounds, n, 1, g_cap)

    def _aggregate_batch(self, batch: TorchColumnarBatch, agg_fns,
                         result_exprs, ctx: TaskContext) -> TorchColumnarBatch:
        """Sort phase, then the segmented reduction (the reference's eager
        two-phase body)."""
        n, cap, dev = batch.num_rows, batch.capacity, batch.device
        if not self.grouping:
            segs = self._global_segments(batch, bucket_capacity(1))
            key_cols: List[TorchColumnVector] = []
        else:
            key_cols = [to_column(g.eval_device(batch, ctx.eval_ctx), batch,
                                  g.dtype) for g in self.grouping]
            enc = encode_group_keys(key_cols, n, cap)
            perm = lex_sort_permutation(enc, n, cap)
            _, seg_ids, ng = segment_boundaries(enc, perm,
                                                row_mask(n, cap, dev))
            checks = [ng.to(torch.int64)] + [
                string_key_overflow(c).to(torch.int64) for c in key_cols
                if isinstance(c.dtype, StringType)]
            n_groups, *overflow = torch.stack(checks).tolist()  # host sync
            if any(overflow):
                raise NotImplementedError(
                    f"string group keys longer than {MAX_PACKED_KEY_BYTES} "
                    "bytes not yet ported")
            g_cap = bucket_capacity(max(n_groups, 1))
            bounds = torch.searchsorted(
                seg_ids[:n], torch.arange(g_cap + 1, dtype=seg_ids.dtype,
                                          device=dev))
            segs = _Segments(perm, seg_ids, bounds, n, n_groups, g_cap)
        states = [_segment_update(fn, self._eval_agg_input(fn, batch, ctx),
                                  segs) for fn in agg_fns]
        agg_cols = [_evaluate_agg(fn, st, segs.n_groups, segs.g_cap)
                    for fn, st in zip(agg_fns, states)]
        out_keys: List[TorchColumnVector] = []
        if self.grouping:
            # each group's key from the first row of its segment
            first = torch.cat([segs.perm, segs.perm.new_full((1,), -1)])[
                segs.bounds[:-1]]
            # string keys are at most MAX_PACKED_KEY_BYTES (checked above)
            out_keys = gather(TorchColumnarBatch(key_cols, n), first,
                              segs.n_groups, segs.g_cap,
                              byte_capacity=segs.g_cap
                              * MAX_PACKED_KEY_BYTES).columns
        return self._project_result(
            TorchColumnarBatch(out_keys + agg_cols, segs.n_groups), out_keys,
            result_exprs, ctx)

    def _project_result(self, agg_batch: TorchColumnarBatch,
                        key_cols: List[TorchColumnVector], result_exprs,
                        ctx: TaskContext) -> TorchColumnarBatch:
        """Keys, then the result projection over (keys + aggregates)."""
        nk = len(key_cols)
        cols = list(key_cols)
        for expr, attr in zip(result_exprs, self._output[nk:]):
            bound = _bind_agg_refs(expr, nk, self.grouping)
            cols.append(to_column(bound.eval_device(agg_batch, ctx.eval_ctx),
                                  agg_batch, attr.dtype))
        return TorchColumnarBatch(cols, agg_batch.num_rows,
                                  [a.name for a in self._output])

    def _empty_global_result(self, agg_fns, result_exprs, ctx):
        """Global aggregate over zero rows: count 0, the others null."""
        cols = [TorchColumnVector.from_numpy(LongT, np.zeros(1, np.int64),
                                             device=ctx.device)
                if isinstance(fn, Count) else
                TorchColumnVector.from_scalar(None, fn.dtype, 1,
                                              device=ctx.device)
                for fn in agg_fns]
        return self._project_result(TorchColumnarBatch(cols, 1), [],
                                    result_exprs, ctx)
