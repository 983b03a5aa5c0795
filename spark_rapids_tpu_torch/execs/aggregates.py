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
* integer min/max: ``scatter_reduce`` (min and max are exact in any order);
* the variance family: an (n, sum, sumsq) state of float64 segment sums,
  finished with the reference's ``m2 = sumsq - sum² / n``.

The host reads one number a batch, the group count that sizes the group
table, and one a string key, its longest string (it picks the key
encoding). Rows stay on the device throughout. Over ``batchSizeRows`` rows
a grouped aggregate sorts out of core and aggregates key-aligned slices
(``_sort_fallback``); a global one merges per-chunk states
(``_global_chunked``). The in-core aggregate and each global chunk run
under ``memory/retry.with_retry_no_split`` (reference :1369, :1430): an
out-of-memory error retries after a spill. The reference's opjit-traced
and fused one-launch variants of ``_aggregate_batch`` are a JAX compile
cache that gives the eager body's results; they are not ported.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..columnar.batch import TorchColumnarBatch, concat_batches, gather
from ..columnar.vector import (TorchColumnVector, audited_sync_int,
                               bucket_capacity, host_arrays, lane_mask,
                               row_mask)
from ..expressions.aggregates import (VARIANCE_OPS, AggregateFunction,
                                      Count)
from ..expressions.base import (AttributeReference, Expression, arrow_column,
                                to_column)
from ..expressions.strings import longest_string, string_key_codes
from ..types import (DecimalType, DoubleT, LongT, StringType, is_fixed_width,
                     sum_decimal_type)
from .base import (DEBUG, CpuExec, PhysicalPlan, TaskContext, TorchExec,
                   bind_all, bind_references, counts_output, op_time)
from .cpu import concat_child, host_batch


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


class CpuHashAggregateExec(CpuExec):
    """Grouped aggregate on the host (reference ``CpuHashAggregateExec``):
    Arrow's ``group_by`` with Spark's semantics layered over it
    (``_arrow_aggregate``). ``per_partition``: the child is
    hash-distributed by the grouping keys (a hash exchange below), so each
    partition aggregates on its own."""

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

    @counts_output
    def execute_partition(self, idx: int, ctx: TaskContext) -> Iterator:
        import pyarrow as pa
        base = concat_child(self.children[0], ctx,
                            idx if self.per_partition else None)
        if base.num_rows == 0 and self.grouping:
            return
        with op_time(ctx, self):
            ectx, n = ctx.eval_ctx, base.num_rows
            agg_fns, result_exprs = split_result_exprs(self.aggregates)
            cols, keys, specs = {}, [], []
            for i, g in enumerate(self.grouping):
                cols[f"k{i}"] = _normalize_fp_key_arrow(
                    arrow_column(g.eval_cpu(base, ectx), n, g.dtype))
                keys.append(f"k{i}")
            for i, fn in enumerate(agg_fns):
                inp = fn.children[0] if fn.children else None
                cols[f"a{i}"] = pa.array(np.ones(n, np.int64)) \
                    if inp is None else \
                    arrow_column(inp.eval_cpu(base, ectx), n, inp.dtype)
                specs.append((f"a{i}", fn))
            flat = pa.Table.from_arrays(list(cols.values()),
                                        names=list(cols)) if cols \
                else pa.table({"_": pa.nulls(n)}).select([])
            agg = _arrow_aggregate(flat, keys, specs, ectx.ansi)
            ng = len(self.grouping)
            out = [agg.column(i) for i in range(ng)]
            for expr in result_exprs:
                bound = _bind_agg_refs(expr, ng, self.grouping)
                out.append(bound.eval_cpu(agg, ectx))
            batch = host_batch(out, self._output, agg.num_rows)
        yield batch


def _normalize_fp_key_arrow(arr):
    """-0.0 groups with 0.0 (Arrow's hashing already groups NaNs)."""
    import pyarrow as pa
    import pyarrow.compute as pc
    if pa.types.is_floating(arr.type):
        zero = pa.scalar(0.0, arr.type)
        return pc.if_else(pc.equal(arr, zero), zero, arr)
    return arr


_ARROW_AGG = {"sum": "sum", "count": "count", "min": "min", "max": "max",
              "avg": "mean", "first": "first", "last": "last",
              "stddev_samp": "stddev", "stddev_pop": "stddev",
              "var_samp": "variance", "var_pop": "variance"}


def _arrow_aggregate(flat, keys: List[str], specs, ansi: bool = False):
    """Grouped (or global) aggregation of ``flat`` by ``keys`` with Spark's
    semantics over Arrow's kernels (reference ``_arrow_aggregate``): a
    table of the keys, then one column an aggregate. Spark orders NaN
    above every double: a float min skips NaN unless the whole group is
    NaN, a float max is NaN when any value is; Arrow propagates NaN, so
    float min/max decompose into a NaN-free reduction and NaN flags."""
    import pyarrow as pa
    import pyarrow.compute as pc
    work = {k: flat.column(k) for k in keys}
    calls, plans = [], []
    for i, (name, fn) in enumerate(specs):
        col = flat.column(name)
        op = _ARROW_AGG[fn.update_op]
        opts = None
        if fn.update_op in ("stddev_samp", "var_samp"):
            opts = pc.VarianceOptions(ddof=1)
        elif fn.update_op in ("stddev_pop", "var_pop"):
            opts = pc.VarianceOptions(ddof=0)
        elif fn.update_op in ("first", "last"):
            opts = pc.ScalarAggregateOptions(skip_nulls=fn.ignore_nulls)
        if pa.types.is_decimal(col.type) and fn.update_op in ("first",
                                                              "last"):
            # Arrow has no decimal first/last: the chosen row's index
            # (min or max among the rows it may take), then a take
            idx = pa.array(np.arange(len(col), dtype=np.int64))
            if fn.ignore_nulls and col.null_count:
                idx = pc.if_else(pc.is_valid(col), idx,
                                 pa.scalar(None, pa.int64()))
            work[f"c{i}"] = idx
            op = "min" if fn.update_op == "first" else "max"
            calls.append((f"c{i}", op, None))
            plans.append(("pick", i, op, fn))
        elif pa.types.is_decimal(col.type) and fn.update_op in ("sum",
                                                                "avg"):
            # Arrow's decimal sum wraps past 2^127: the unscaled values'
            # 32-bit words summed in int64 as on the card, and the count,
            # finished to Spark's types by ``_decimal_finish``
            from ..expressions.decimals import arrow_words
            for j, w in enumerate(arrow_words(col)):
                work[f"c{i}w{j}"] = w
                calls.append((f"c{i}w{j}", "sum", None))
            work[f"c{i}"] = col
            calls.append((f"c{i}", "count", None))
            plans.append(("dec", i, "count", fn))
        elif pa.types.is_floating(col.type) and fn.update_op in ("min",
                                                                  "max"):
            nan = pc.fill_null(pc.is_nan(col), False)
            neutral = pa.scalar(np.inf if fn.update_op == "min" else -np.inf,
                                col.type)
            work[f"c{i}"] = pc.if_else(nan, neutral, col)
            # null-preserving NaN flag: its min says all NaN, max any NaN
            work[f"n{i}"] = pc.if_else(pc.is_null(col),
                                       pa.scalar(None, pa.int8()),
                                       pc.cast(nan, pa.int8()))
            calls += [(f"c{i}", op, None), (f"n{i}", "min", None),
                      (f"n{i}", "max", None)]
            plans.append(("fp", i, op, fn))
        else:
            work[f"c{i}"] = col
            calls.append((f"c{i}", op, opts))
            plans.append(("plain", i, op, fn))
    table = pa.Table.from_arrays(list(work.values()), names=list(work)) \
        if work else flat
    if keys:
        if not calls:  # keys only: the distinct key rows
            table = table.append_column(
                "_d", pa.array(np.ones(table.num_rows, np.int8)))
            calls.append(("_d", "count", None))
        # first/last are ordered: Arrow takes them only single-threaded,
        # which keeps each group's rows in input order
        ordered = any(op in ("first", "last") for _, op, _ in calls)
        res = table.group_by(keys, use_threads=not ordered).aggregate(
            [(c, op) if o is None else (c, op, o) for c, op, o in calls])

        def get(c, op):
            return res.column(f"{c}_{op}")
        out = [res.column(k) for k in keys]
    else:
        fns = {"sum": pc.sum, "count": pc.count, "min": pc.min,
               "max": pc.max, "mean": pc.mean, "first": pc.first,
               "last": pc.last, "stddev": pc.stddev,
               "variance": pc.variance}
        vals = {}
        for c, op, o in calls:
            v = fns[op](table.column(c), options=o) if o is not None \
                else fns[op](table.column(c))
            vals[(c, op)] = pa.array([v.as_py()], type=v.type
                                     if v.type != pa.null() else pa.int64())

        def get(c, op):
            return vals[(c, op)]
        out = []
    for mode, i, op, fn in plans:
        red = get(f"c{i}", op)
        if mode == "dec":
            out.append(_decimal_finish(
                fn, [get(f"c{i}w{j}", "sum") for j in range(4)], red, ansi))
            continue
        if mode == "pick":
            out.append(flat.column(specs[i][0]).take(red))
            continue
        if mode == "fp":
            flag = get(f"n{i}", "min" if fn.update_op == "min" else "max")
            red = pc.if_else(pc.equal(pc.fill_null(flag, 0), 1),
                             pa.scalar(float("nan"), red.type), red)
        out.append(red)
    names = list(keys) + [f"agg{i}" for i in range(len(plans))]
    return pa.Table.from_arrays(
        [o.combine_chunks() if isinstance(o, pa.ChunkedArray) else o
         for o in out], names=names)


def _decimal_finish(fn, words, counts, ansi: bool):
    """Spark's decimal sum or avg (``decimals.finish_sum_avg``) from the
    groups' summed 32-bit words (``arrow_words``) and counts."""
    import pyarrow.compute as pc
    from ..expressions import decimals as DEC
    w = [np.asarray(pc.fill_null(x, 0).to_numpy(zero_copy_only=False),
                    np.int64).astype(object) for x in words]
    n = np.asarray(pc.fill_null(counts, 0).to_numpy(zero_copy_only=False),
                   np.int64).astype(object)
    v, ok = DEC.finish_sum_avg(
        fn, w[0] + (w[1] << 32) + (w[2] << 64) + (w[3] << 96), n, ansi)
    return DEC.ints_to_arrow(v, fn.dtype, ok)


# ---------------------------------------------------------------------------
# key encodings
# ---------------------------------------------------------------------------

_INT64_SIGN = -2**63


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


def _normalize_fp_key(col: TorchColumnVector) -> TorchColumnVector:
    """A float key column with -0.0 as 0.0 and every NaN canonical, as
    Spark's ``NormalizeFloatingNumbers`` leaves a group key (the output
    key is a group's first row; ``_sortable_bits`` already groups them
    alike)."""
    if not col.data.is_floating_point():
        return col
    from ..expressions.nullexprs import normalize_nan_zero
    return TorchColumnVector(col.dtype, normalize_nan_zero(col.data),
                             col.validity, col.num_rows)


def encode_group_keys(cols: List[TorchColumnVector], num_rows: int,
                      capacity: int):
    """Per-key (sortable_value, validity) pairs; strings take their key
    codes (``expressions.strings.string_key_codes``: byte order and
    equality preserved, any length). Null lanes carry 0, so two nulls
    compare equal whatever payload an expression left under them."""
    out = []
    for c in cols:
        vals = string_key_codes([c])[0] if isinstance(c.dtype, StringType) \
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


def _host_string_minmax(op: str, col: TorchColumnVector, segs: _Segments,
                        ctx) -> Dict:
    """min/max of a string column by groups, the reference's host-assisted
    segment (``spark_rapids_tpu/execs/aggregates.py:975``): the strings and
    each row's group id go to the host, an Arrow hash aggregate takes each
    group's min or max (Arrow orders strings by their bytes, as Spark),
    and the groups' strings come back as one upload. Counted in
    ``strings.hostPath`` under the aggregate's class."""
    import pyarrow as pa
    from ..expressions.strings import column_to_arrow, host_path
    from ..types import to_arrow
    host_path(ctx, "Min" if op == "min" else "Max", "string min/max segment")
    n, g = segs.n, segs.n_groups
    out = pa.nulls(g, pa.string())
    if n and g:
        arr = column_to_arrow(col)
        group = np.empty(n, np.int64)  # each input row's group
        perm, seg_ids = host_arrays([segs.perm, segs.seg_ids], "fetch")
        group[perm] = seg_ids
        agg = pa.table({"g": group, "v": arr}).group_by("g").aggregate(
            [("v", op)])
        at = np.full(g, -1, np.int64)
        at[agg["g"].to_numpy()] = np.arange(agg.num_rows)
        out = agg[f"v_{op}"].combine_chunks().take(
            pa.array(at, mask=at < 0))
    if out.type != to_arrow(col.dtype):
        out = out.cast(to_arrow(col.dtype))
    offsets = np.frombuffer(out.buffers()[1], np.int32, g + 1,
                            out.offset * 4).astype(np.int64) if g \
        else np.zeros(1, np.int64)
    base = int(offsets[0])
    chars = np.frombuffer(out.buffers()[2], np.uint8,
                          int(offsets[-1]) - base, base) \
        if g and offsets[-1] > base else np.zeros(0, np.uint8)
    valid = np.asarray(out.is_valid().to_numpy(zero_copy_only=False),
                       dtype=bool) if g else np.zeros(0, bool)
    return {"column": TorchColumnVector.from_strings(
        col.dtype, (offsets - base).astype(np.int32), chars, valid,
        capacity=segs.g_cap, device=col.device)}


def _segment_update(fn: AggregateFunction, col: Optional[TorchColumnVector],
                    segs: _Segments, ctx=None) -> Dict[str, torch.Tensor]:
    """Per-group partial state of one aggregate over the sorted rows."""
    op = fn.update_op
    valid = None  # None: every row is valid
    if col is not None and col.validity is not None:
        valid = col.validity[segs.perm]
    if op == "count":
        return {"count": segs.count(valid)}
    if op in ("first", "last"):
        return _segment_pick(fn, col, segs, valid)
    if col.offsets is not None:
        if op in ("min", "max"):
            return _host_string_minmax(op, col, segs, ctx)
        raise NotImplementedError(f"{op} of strings not yet ported")
    if isinstance(col.dtype, DecimalType):
        return _decimal_state(fn, col, segs, valid)
    data = col.data[segs.perm]
    nn = segs.count(valid)
    if op in VARIANCE_OPS:
        # the (n, sum, sumsq) state; the final step makes m2 of it
        x = data.to(torch.float64)
        if valid is not None:
            x = torch.where(valid, x, 0.0)
        return {"n": nn, "sum": segs.float_reduce(x, "sum", 0.0),
                "sumsq": segs.float_reduce(x * x, "sum", 0.0)}
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


def _segment_pick(fn: AggregateFunction, col: TorchColumnVector,
                  segs: _Segments, valid: Optional[torch.Tensor]) -> Dict:
    """first/last: each group's first (last) row in input order, among its
    non-null rows with ``ignore_nulls`` (the reference's selection by row
    position, ``execs/aggregates.py:720``). The group sort is stable, so a
    group's sorted positions keep the input order; one gather takes the
    chosen rows of any column type, and a group with no row to choose
    gives null."""
    first = fn.update_op == "first"
    n, dev = segs.n, segs.perm.device
    sent = n if first else -1
    sel = torch.full((segs.g_cap,), sent, dtype=torch.int64, device=dev)
    if n:
        pos = torch.arange(n, dtype=torch.int64, device=dev)
        if fn.ignore_nulls and valid is not None:
            pos = torch.where(valid, pos, sent)
        sel = sel.scatter_reduce(0, segs.seg_ids, pos,
                                 reduce="amin" if first else "amax",
                                 include_self=True)
    has = sel != sent
    rows = torch.where(has, segs.perm[sel.clamp(0, max(n - 1, 0))]
                       if n else sel, -1)
    picked = gather(TorchColumnarBatch([col], col.num_rows), rows,
                    segs.n_groups, segs.g_cap)
    return {"column": picked.columns[0]}


def _decimal_state(fn: AggregateFunction, col: TorchColumnVector,
                   segs: _Segments, valid: Optional[torch.Tensor]) -> Dict:
    """The partial state of a decimal sum/avg/min/max by groups, with the
    non-null count; states of chunks merge (``_merge_global_states``) and
    ``_decimal_result`` finishes one:

    * sum/avg: each value's four 32-bit words summed exactly in int64 by
      the segments' prefix sums (``decimal128.segment_words128``), merged
      by addition;
    * min/max: one lane by ``scatter_reduce``; two limbs the high limb
      first, then the low limb (unsigned) among the rows that hold the
      group's high limb; merged by ``cmp128``."""
    from ..kernels import decimal128 as D
    op = fn.update_op
    data = col.data[segs.perm]
    nn = segs.count(valid)
    if valid is not None:
        data = torch.where(lane_mask(valid, data), data,
                           torch.zeros((), dtype=data.dtype,
                                       device=data.device))
    if op in ("min", "max"):
        return {op: _decimal_minmax(op, data, valid, segs), "nonnull": nn}
    h, l = D.limbs_of(data)
    return {"words": D.segment_words128(h, l, segs.int_sum), "nonnull": nn}


def _decimal_result(fn: AggregateFunction, state: Dict, n_groups: int,
                    cap: int, ansi: bool) -> TorchColumnVector:
    """Spark's result of a decimal aggregate's state: min/max as they
    are; sum one carry pass (``decimal128.carry_words128``), past the sum
    type's precision (p + 10) null, ANSI an error; avg that sum over the
    count as Spark's decimal ``Divide`` gives it (HALF_UP at the
    quotient's scale, ``decimal128.div_half_up``), then cast HALF_UP to
    the avg type (p + 4, s + 4)."""
    from ..expressions.decimals import overflow_check
    from ..kernels import decimal128 as D
    from ..types import decimal_result_type
    op, out_t = fn.update_op, fn.dtype
    nn = state["nonnull"]
    ok = (nn > 0) & row_mask(n_groups, cap, nn.device)
    if op in ("min", "max"):
        out, v = state[op], ok
    else:
        sh, sl, ovf = D.carry_words128(state["words"])
        if op == "sum":
            ovf = ovf | D.precision_overflow(sh, sl, out_t.precision)
            qh, ql = sh, sl
        else:
            # Spark's sum type, then Divide(sum, count as decimal(20, 0))
            sum_t = sum_decimal_type(fn.children[0].dtype)
            q_t = decimal_result_type("/", sum_t, DecimalType(20, 0))
            ovf = ovf | D.precision_overflow(sh, sl, sum_t.precision)
            qh, ql, qo = D.div_half_up(sh, sl, torch.where(nn > 0, nn, 1),
                                       q_t.scale - sum_t.scale)
            ovf = ovf | qo | D.precision_overflow(qh, ql, q_t.precision)
            k = q_t.scale - out_t.scale
            if k > 0:
                qh, ql = D.rescale_down(qh, ql, k)
            elif k < 0:
                qh, ql, o2 = D.rescale_up(qh, ql, -k)
                ovf = ovf | o2
            ovf = ovf | D.precision_overflow(qh, ql, out_t.precision)
        v = overflow_check(ovf & ok, ok, ansi, f"decimal overflow in {op}")
        out = D.join(qh, ql) if out_t.wide else ql
    return TorchColumnVector(out_t, torch.where(
        lane_mask(v, out), out, torch.zeros((), dtype=out.dtype,
                                            device=out.device)), v, n_groups)


def _decimal_minmax(op: str, data: torch.Tensor,
                    valid: Optional[torch.Tensor], segs: _Segments
                    ) -> torch.Tensor:
    """Per-group min/max of a decimal carrier in sorted order (null rows
    excluded; a group with none gives 0, masked by the caller)."""
    red = "amin" if op == "min" else "amax"
    neutral = (2 ** 63 - 1) if op == "min" else -2 ** 63
    dev = data.device

    def reduce(x):
        if valid is not None:
            x = torch.where(valid, x, neutral)
        return torch.full((segs.g_cap,), neutral, dtype=torch.int64,
                          device=dev).scatter_reduce(
            0, segs.seg_ids, x, reduce=red, include_self=True)

    if data.dim() == 1:
        return reduce(data)
    hi = reduce(data[:, 0])
    at = data[:, 0] == hi[segs.seg_ids]
    # the low limb as unsigned: flip the sign bit, reduce, flip back
    lo = data[:, 1] ^ (-2 ** 63)
    lo = torch.where(at, lo, neutral)
    lo = reduce(lo) ^ (-2 ** 63)
    return torch.stack([hi, lo], -1)


def _evaluate_agg(fn: AggregateFunction, state: Dict[str, torch.Tensor],
                  n_groups: int, cap: int, ansi: bool) -> TorchColumnVector:
    if "column" in state:  # first/last, a string min/max: the chosen rows
        return state["column"]
    if fn.children and isinstance(fn.children[0].dtype, DecimalType) \
            and fn.update_op != "count":
        return _decimal_result(fn, state, n_groups, cap, ansi)
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
    if op in VARIANCE_OPS:
        # the reference's formula, m2 = sumsq - sum^2 / n (not Welford):
        # null for n = 0, and for n = 1 in the sample forms
        n = state["n"].to(torch.float64)
        s, s2 = state["sum"], state["sumsq"]
        m2 = s2 - (s * s) / torch.where(n > 0, n, 1.0)
        denom = n - (1.0 if op.endswith("samp") else 0.0)
        ok = denom > 0
        var = torch.where(ok, m2 / torch.where(ok, denom, 1.0), 0.0)
        var = var.clamp(min=0.0)
        out = torch.sqrt(var) if op.startswith("stddev") else var
        valid = ok & (n > 0) & gmask
        return TorchColumnVector(DoubleT, torch.where(valid, out, 0.0),
                                 valid, n_groups)
    raise NotImplementedError(f"aggregate {op} not yet ported")


def _global_mergeable(fn: AggregateFunction) -> bool:
    """Whether the ungrouped chunked-merge path can combine this
    aggregate's partial states."""
    op = fn.update_op
    child = fn.children[0] if fn.children else None
    if op in ("count", "sum", "avg") or op in VARIANCE_OPS:
        return True
    if op in ("min", "max"):
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
    if "words" in stk:  # a decimal sum/avg: word sums and counts add
        return {k: v.sum(0) for k, v in stk.items()}
    if op in ("min", "max") and stk[op].dim() == 3:
        return _merge_decimal128_minmax(op, stk[op], stk["nonnull"])
    if op == "sum":
        return {"sum": stk["sum"].sum(0), "nonnull": stk["nonnull"].sum(0)}
    if op == "avg":
        return {"sum": stk["sum"].sum(0), "count": stk["count"].sum(0)}
    if op in VARIANCE_OPS:
        return {k: v.sum(0) for k, v in stk.items()}
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


def _merge_decimal128_minmax(op: str, red: torch.Tensor,
                             nn: torch.Tensor) -> Dict:
    """Two-limb decimal min/max states of chunks (``[chunks, groups,
    2]``) merged by ``cmp128``, among the chunks that saw a value."""
    from ..kernels import decimal128 as D
    m, seen = red[0], nn[0] > 0
    for r, has in zip(red[1:], nn[1:] > 0):
        c = D.cmp128(r[..., 0], r[..., 1], m[..., 0], m[..., 1])
        take = has & (~seen | ((c < 0) if op == "min" else (c > 0)))
        m = torch.where(take[..., None], r, m)
        seen = seen | has
    return {op: m, "nonnull": nn.sum(0)}


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

    def additional_metrics(self):
        return {"numGroups": DEBUG}

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
            ctx.counters["global_chunked_runs"] += 1
            yield self._global_chunked(batches, agg_fns, result_exprs, ctx,
                                       max_rows)
            return
        from ..memory.retry import with_retry_no_split
        whole = [concat_batches(batches)]
        batches.clear()  # the retry framework owns the input from here on
        yield with_retry_no_split(
            whole.pop(),
            lambda b: self._aggregate_batch(b, agg_fns, result_exprs, ctx))

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
        del cur
        batches.clear()  # each chunk's retry owns it from here on
        g_cap = bucket_capacity(1)
        per_fn: List[List[Dict]] = [[] for _ in agg_fns]
        from ..memory.retry import with_retry_no_split

        def chunk_states(chunk: TorchColumnarBatch) -> List[Dict]:
            segs = self._global_segments(chunk, g_cap)
            return [_segment_update(fn, self._eval_agg_input(fn, chunk, ctx),
                                    segs, ctx) for fn in agg_fns]

        while chunks:
            # the same OOM-retry discipline as the in-core path: the chunk
            # is spillable while its partial state is computed
            states = with_retry_no_split(concat_batches(chunks.pop(0)),
                                         chunk_states)
            for i in range(len(agg_fns)):
                per_fn[i].append(states[i])
        agg_cols = [_evaluate_agg(fn, _merge_global_states(fn, sts), 1, g_cap,
                                  ctx.eval_ctx.ansi)
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
        two-phase body), timed as the operator's opTime."""
        with op_time(ctx, self):
            out = self._aggregate_sorted(batch, agg_fns, result_exprs, ctx)
        self.metrics["numGroups"].add(out.num_rows)
        return out

    def _aggregate_sorted(self, batch: TorchColumnarBatch, agg_fns,
                          result_exprs, ctx: TaskContext
                          ) -> TorchColumnarBatch:
        n, cap, dev = batch.num_rows, batch.capacity, batch.device
        if not self.grouping:
            segs = self._global_segments(batch, bucket_capacity(1))
            key_cols: List[TorchColumnVector] = []
        else:
            key_cols = [_normalize_fp_key(to_column(
                g.eval_device(batch, ctx.eval_ctx), batch, g.dtype))
                for g in self.grouping]
            enc = encode_group_keys(key_cols, n, cap)
            perm = lex_sort_permutation(enc, n, cap)
            _, seg_ids, ng = segment_boundaries(enc, perm,
                                                row_mask(n, cap, dev))
            # host sync: it sizes the group table
            n_groups = audited_sync_int(ng, "rows")
            g_cap = bucket_capacity(max(n_groups, 1))
            bounds = torch.searchsorted(
                seg_ids[:n], torch.arange(g_cap + 1, dtype=seg_ids.dtype,
                                          device=dev))
            segs = _Segments(perm, seg_ids, bounds, n, n_groups, g_cap)
        states = [_segment_update(fn, self._eval_agg_input(fn, batch, ctx),
                                  segs, ctx) for fn in agg_fns]
        agg_cols = [_evaluate_agg(fn, st, segs.n_groups, segs.g_cap,
                                  ctx.eval_ctx.ansi)
                    for fn, st in zip(agg_fns, states)]
        out_keys: List[TorchColumnVector] = []
        if self.grouping:
            # each group's key from the first row of its segment
            first = torch.cat([segs.perm, segs.perm.new_full((1,), -1)])[
                segs.bounds[:-1]]
            # a group's string key is at most the longest (known from the
            # encode)
            longest = longest_string([c for c in key_cols
                                      if c.offsets is not None])
            out_keys = gather(TorchColumnarBatch(key_cols, n), first,
                              segs.n_groups, segs.g_cap,
                              byte_capacity=segs.g_cap
                              * max(longest, 1)).columns
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
