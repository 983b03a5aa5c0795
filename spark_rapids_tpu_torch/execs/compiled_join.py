"""Compiled star-join aggregation: fact scan → filter → project → a chain of
many-to-one equi-joins → group-by, as one stage per fact batch (port of
``spark_rapids_tpu/execs/compiled_join.py``).

* Each dimension (build) side materializes ONCE as device arrays: its
  join keys as one sorted int64 array (several keys pack into a monotone
  composite) and the columns the stage reads, in key order
  (``_build_dim``). A dimension build is cached across queries while its
  source tables are the same objects (``_DIM_BUILD_CACHE``).
* The fact side runs its filters and projections, probes each dimension
  by ``searchsorted`` (by subtraction when the keys are contiguous) and
  gathers the payloads; unmatched rows are masked, never compacted, since
  every probe row matches at most one dimension row.
* The aggregate groups by the group dimension's ROW: q3's
  (o_orderkey, o_orderdate) is "group by orders row", G = the dimension's
  capacity + 1 groups.

The reference traces the stage into one XLA program and sums with
``jax.ops.segment_sum``. Eager torch runs it as a sequence of kernels, and
a CUDA float scatter-add adds through atomics in no fixed order, so the
rows sort by group (one stable sort a batch, shared by every aggregate)
and each group's contiguous segment reduces in a fixed order: float sums
by ``segment_reduce``, counts and integer sums by an int64 prefix sum read
at the segment bounds. Repeated collects are identical. Min/max
scatter-reduce, which is exact in any order.

Where a run turns out ineligible (a dimension past ``maxDimRows``, a
duplicated dimension key, a string payload) the stage re-runs its original
subtree on the general join path, as the reference does, counted in
``TaskContext.counters["fallbackReruns"]``. Not ported: the re-run on a
device out-of-memory (with the retry framework), spill, and the
reference's device-resident finalize (``device_output``): the occupied
groups' carries come to the host, are finalized there and go back up.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..columnar.batch import TorchColumnarBatch, compact, concat_batches, \
    gather
from ..columnar.vector import TorchColumnVector, bucket_capacity, row_mask
from ..expressions.base import AttributeReference, Expression
from ..types import (DateType, DecimalType, IntegralType, StringType,
                     is_fixed_width)
from .base import PhysicalPlan, TaskContext, TorchExec
from .compiled import (_agg_eligible, _identity_source_ordinal, _is_fp,
                       _np_finalize, _np_merge_carries, _refs, apply_layers,
                       walk_pure_chain)

_INT64_MAX = torch.iinfo(torch.int64).max


class _Ineligible(Exception):
    pass


class _JoinStageFallback(Exception):
    """Internal: abandon the compiled path, run the original subtree."""


# ---------------------------------------------------------------------------
# pattern extraction
# ---------------------------------------------------------------------------


class _DimSpec:
    """One build side: ``plan`` materializes once; the fact probes its
    ``key_ordinals`` columns with the values at ``probe_locs`` (each
    ("fact", o) or ("dim", earlier dim index, o))."""

    def __init__(self, plan: PhysicalPlan, key_ordinals: List[int],
                 probe_locs: List):
        self.plan = plan
        self.key_ordinals = list(key_ordinals)
        self.probe_locs = list(probe_locs)
        self.payload_ordinals: List[int] = []  # columns the stage gathers


class _JoinStageSpec:
    def __init__(self, fact_source, fact_layers, fact_needed_source,
                 dims, top_output, col_loc, top_layers, grouping, group_dim,
                 group_key_ordinals, agg_fns, result_exprs, output,
                 needed_top, group_unique_check):
        self.fact_source = fact_source
        self.fact_layers = fact_layers          # bottom-up
        self.fact_needed_source = fact_needed_source
        self.dims = dims                        # probe order
        self.top_output = top_output            # the top join's output
        self.col_loc = col_loc                  # top ordinal -> location
        self.top_layers = top_layers            # between join and aggregate
        self.grouping = grouping
        self.group_dim = group_dim              # dim index, None: global
        self.group_key_ordinals = group_key_ordinals
        self.agg_fns = agg_fns
        self.result_exprs = result_exprs
        self.output = output
        self.needed_top = needed_top            # top ordinals the stage reads
        self.group_unique_check = group_unique_check


def _join_classes():
    from ..shuffle.exchange import TorchShuffleExchangeExec
    from .joins import TorchShuffledHashJoinExec
    return TorchShuffleExchangeExec, TorchShuffledHashJoinExec


def _strip_exchanges(node: PhysicalPlan) -> PhysicalPlan:
    exchange, _ = _join_classes()
    while isinstance(node, exchange):
        node = node.children[0]
    return node


def _unwrap_widening_cast(e: Expression) -> Expression:
    """Integral/date widening casts on join keys (the key coercion's) are
    transparent: the probe compares in int64, and widening keeps
    equality."""
    from ..expressions.cast import Cast
    if isinstance(e, Cast) and isinstance(e.children[0], AttributeReference) \
            and isinstance(e.dtype, (IntegralType, DateType)) \
            and isinstance(e.children[0].dtype, (IntegralType, DateType)):
        return e.children[0]
    return e


def _flatten_join_tree(node: PhysicalPlan):
    """A tree of inner hash joins → (leaves, conditions); a condition is
    (left key attrs, right key attrs)."""
    _, join_cls = _join_classes()
    node = _strip_exchanges(node)
    if not isinstance(node, join_cls):
        return [node], []
    if node.join_type != "inner" \
            or node.condition is not None or not node.left_keys \
            or len(node.left_keys) != len(node.right_keys):
        raise _Ineligible()
    lks = [_unwrap_widening_cast(k) for k in node.left_keys]
    rks = [_unwrap_widening_cast(k) for k in node.right_keys]
    if not all(isinstance(k, AttributeReference) for k in lks + rks):
        raise _Ineligible()
    l_leaves, l_conds = _flatten_join_tree(node.children[0])
    r_leaves, r_conds = _flatten_join_tree(node.children[1])
    return l_leaves + r_leaves, l_conds + r_conds + [(lks, rks)]


def _estimate_rows(plan: PhysicalPlan) -> int:
    """A leaf's size: the largest scan below it."""
    best = 0
    for n in plan.collect_nodes():
        t = getattr(n, "table", None)
        if t is not None:
            best = max(best, t.num_rows)
        b = getattr(n, "batches", None)
        if b is not None:
            best = max(best, sum(x.num_rows for x in b))
    return best


def _walk_pure_chain(node: PhysicalPlan):
    walked = walk_pure_chain(node)
    if walked is None:
        raise _Ineligible()
    return walked


def _extract_fact_chain(leaf: PhysicalPlan):
    node, layers = _walk_pure_chain(leaf)
    if not isinstance(node, TorchExec):
        raise _Ineligible()
    return node, layers


def _walk_needed(top_ordinals, layers) -> set:
    """Ordinals needed at the top of a layer chain → at its base."""
    cur = set(top_ordinals)
    for layer in reversed(layers):  # top-down
        if layer[0] == "filter":
            cur.update(_refs(layer[1]))
        else:
            cur = {r for o in cur if o < len(layer[1])
                   for r in _refs(layer[1][o])}
    return cur


def _traceable(dtype) -> bool:
    return is_fixed_width(dtype) and not isinstance(dtype, (StringType,
                                                            DecimalType))


def try_extract_join_stage(agg) -> Optional[_JoinStageSpec]:
    """Match an aggregate over [exchange] over a pure chain over a tree of
    hash joins whose largest leaf is a pure chain over a device source;
    None when ineligible."""
    from .aggregates import TorchHashAggregateExec, split_result_exprs
    exchange, join_cls = _join_classes()
    if not isinstance(agg, TorchHashAggregateExec):
        return None
    agg_fns, result_exprs = split_result_exprs(agg.aggregates)
    if not agg_fns or not all(_agg_eligible(f) for f in agg_fns):
        return None
    grouping = list(agg.grouping)
    if not all(isinstance(g, AttributeReference) and g.ordinal is not None
               for g in grouping):
        return None
    try:
        node, top_layers = _walk_pure_chain(_strip_exchanges(agg.children[0]))
        node = _strip_exchanges(node)
        if not isinstance(node, join_cls):
            return None
        top_output = list(node.output)
        leaves, conds = _flatten_join_tree(node)
        leaf_loc: Dict[int, Tuple[int, int]] = {}
        for li, leaf in enumerate(leaves):
            for o, a in enumerate(leaf.output):
                leaf_loc[a.expr_id] = (li, o)
        # the fact is the largest leaf
        fact_idx = int(np.argmax([_estimate_rows(lf) for lf in leaves]))
        fact_source, fact_layers = _extract_fact_chain(leaves[fact_idx])
        dims, dim_of_leaf = _order_dims(conds, leaves, leaf_loc, fact_idx)

        col_loc: Dict[int, Tuple] = {}
        for o, a in enumerate(top_output):
            loc = leaf_loc.get(a.expr_id)
            if loc is not None:
                li, lo = loc
                col_loc[o] = ("fact", lo) if li == fact_idx else \
                    ("dim", dim_of_leaf[li], lo)

        # group keys all on ONE dimension (or none: global)
        group_dim: Optional[int] = None
        group_key_ordinals: List[int] = []
        for g in grouping:
            src = _identity_source_ordinal(g.ordinal, top_layers)
            loc = col_loc.get(src) if src is not None else None
            if loc is None or loc[0] != "dim" \
                    or group_dim not in (None, loc[1]):
                raise _Ineligible()
            group_dim = loc[1]
            group_key_ordinals.append(loc[2])
        # grouping by the dimension row is right only when the group keys
        # are unique a row: covering the dim's join keys proves it (the
        # build checks those for duplicates); otherwise the build checks
        group_unique_check = group_dim is not None and not (
            set(dims[group_dim].key_ordinals) <= set(group_key_ordinals))

        agg_refs = {r for f in agg_fns for c in f.children for r in _refs(c)}
        needed_top = sorted(_walk_needed(agg_refs, top_layers))
        for o in needed_top:
            loc = col_loc.get(o)
            if loc is None or not _traceable(top_output[o].dtype):
                raise _Ineligible()
            if loc[0] == "dim":
                _add_payload(dims[loc[1]], loc[2])
        for d in dims:  # probe values read from earlier dims gather too
            for loc in d.probe_locs:
                if loc[0] == "dim":
                    if not _traceable(dims[loc[1]].plan.output[loc[2]].dtype):
                        raise _Ineligible()
                    _add_payload(dims[loc[1]], loc[2])
        for d in dims:
            d.payload_ordinals.sort()

        fact_top_needed = {col_loc[o][1] for o in needed_top
                           if col_loc[o][0] == "fact"}
        fact_top_needed |= {loc[1] for d in dims for loc in d.probe_locs
                            if loc[0] == "fact"}
        fact_needed_source = sorted(_walk_needed(fact_top_needed,
                                                 fact_layers))
        for o in fact_needed_source:
            if o >= len(fact_source.output) \
                    or not _traceable(fact_source.output[o].dtype):
                raise _Ineligible()
        return _JoinStageSpec(
            fact_source, fact_layers, fact_needed_source, dims, top_output,
            col_loc, top_layers, grouping, group_dim, group_key_ordinals,
            agg_fns, result_exprs, list(agg.output), needed_top,
            group_unique_check)
    except _Ineligible:
        return None


def _add_payload(d: _DimSpec, ordinal: int) -> None:
    if ordinal not in d.payload_ordinals:
        d.payload_ordinals.append(ordinal)


def _order_dims(conds, leaves, leaf_loc, fact_idx):
    """The probe order: a condition is ready when its probe-side values are
    on the fact or on an already-probed dimension."""
    dims: List[_DimSpec] = []
    dim_of_leaf: Dict[int, int] = {}
    pending = list(conds)
    while pending:
        progressed = False
        for cond in list(pending):
            lks, rks = cond
            l_locs = [leaf_loc.get(k.expr_id) for k in lks]
            r_locs = [leaf_loc.get(k.expr_id) for k in rks]
            if any(x is None for x in l_locs + r_locs):
                raise _Ineligible()
            for p_locs, d_locs, d_attrs in ((l_locs, r_locs, rks),
                                            (r_locs, l_locs, lks)):
                d_leaves = {loc[0] for loc in d_locs}
                if len(d_leaves) != 1:
                    continue
                d_leaf = next(iter(d_leaves))
                if d_leaf == fact_idx or d_leaf in dim_of_leaf or not all(
                        isinstance(a.dtype, (IntegralType, DateType))
                        for a in d_attrs):
                    continue
                probe_locs = []
                for p_leaf, p_ord in p_locs:
                    if p_leaf == fact_idx:
                        probe_locs.append(("fact", p_ord))
                    elif p_leaf in dim_of_leaf:
                        probe_locs.append(("dim", dim_of_leaf[p_leaf],
                                           p_ord))
                    else:
                        break
                else:
                    dim_of_leaf[d_leaf] = len(dims)
                    dims.append(_DimSpec(leaves[d_leaf],
                                         [loc[1] for loc in d_locs],
                                         probe_locs))
                    pending.remove(cond)
                    progressed = True
                    break
        if not progressed:
            raise _Ineligible()
    if len(dim_of_leaf) != len(leaves) - 1:
        raise _Ineligible()
    return dims, dim_of_leaf


# ---------------------------------------------------------------------------
# the stage body
# ---------------------------------------------------------------------------


class _GroupOrder:
    """Rows sorted stably by group code, once a batch, shared by every
    aggregate: each group's rows are one contiguous segment, so sums reduce
    in a fixed order (float: ``segment_reduce``; integer and counts: an
    int64 prefix sum read at the segment bounds) with no atomics.

    The last group (G - 1) is the dropped rows' slot, which nothing reads.
    Float sums reduce only the live groups' segments, given by their start
    offsets: the dropped rows sort last, past every segment, and their slot
    is left at 0. They are most rows of a selective join (~80 % in q3), and
    ``segment_reduce`` reduces a segment in one thread block, so summing
    them would cost more than every other group."""

    def __init__(self, gcode: torch.Tensor, G: int):
        # int32 codes sort faster than int64 (G is far below 2^31)
        self.perm = torch.argsort(gcode.to(torch.int32), stable=True)
        self.bounds = torch.searchsorted(
            gcode[self.perm], torch.arange(G + 1, dtype=gcode.dtype,
                                           device=gcode.device))

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_floating_point():
            # segment g is rows [bounds[g], bounds[g + 1]) for g < G - 1;
            # unsafe=True skips only the check that the offsets ascend
            # (searchsorted's do), which reads the device
            live = torch.segment_reduce(x[self.perm], "sum",
                                        offsets=self.bounds[:-1],
                                        unsafe=True)
            return torch.cat([live, live.new_zeros(1)])
        c = torch.zeros(x.shape[0] + 1, dtype=torch.int64, device=x.device)
        c[1:] = torch.cumsum(x[self.perm].to(torch.int64), 0)
        return (c[self.bounds[1:]] - c[self.bounds[:-1]]).to(x.dtype)


def _scatter_reduce(op: str, x: torch.Tensor, gcode: torch.Tensor, G: int,
                    init) -> torch.Tensor:
    """Per-group min/max (exact in any order)."""
    out = torch.full((G,), init, dtype=x.dtype, device=x.device)
    return out.scatter_reduce_(0, gcode, x, op, include_self=True)


def _segment_states(fn, x, v, gcode, G: int, order: _GroupOrder):
    """One aggregate's per-group carry arrays, laid out as the compiled
    aggregation stage's carries (``_np_merge_carries`` reads both)."""
    i64 = torch.int64
    nn = order.sum(v.to(i64))
    if x is None or fn.update_op == "count":
        return [nn]
    op = fn.update_op
    if op in ("sum", "avg"):
        acc = torch.float64 if op == "avg" else fn.dtype.torch_dtype
        contrib = torch.where(v, x, torch.zeros((), dtype=x.dtype,
                                                device=x.device)).to(acc)
        return [order.sum(contrib), nn]
    red_op = "amin" if op == "min" else "amax"
    if x.is_floating_point():
        neutral = float("inf") if op == "min" else float("-inf")
        nan_x = torch.isnan(x)
        clean = torch.where(v & ~nan_x, x, neutral)
        return [_scatter_reduce(red_op, clean, gcode, G, neutral),
                order.sum((v & nan_x).to(i64)) > 0,
                order.sum((v & ~nan_x).to(i64)), nn]
    info = torch.iinfo(x.dtype)
    neutral = info.max if op == "min" else info.min
    return [_scatter_reduce(red_op, torch.where(v, x, neutral), gcode, G,
                            neutral), nn]


def _probe(flat, probe_parts, cap: int, dense: bool):
    """(dim row index, matched) of every fact row."""
    keys, n_valid, lo, mins, strides, maxs = flat[:6]
    if len(probe_parts) == 1:
        pdata, pvalid = probe_parts[0]
        probe, in_range = pdata.to(torch.int64), pvalid
    else:
        # the build's monotone composite; a key outside its build range
        # could alias a real composite, so such rows are excluded
        probe = torch.zeros(cap, dtype=torch.int64, device=keys.device)
        in_range = torch.ones(cap, dtype=torch.bool, device=keys.device)
        for k, (pdata, pvalid) in enumerate(probe_parts):
            pv = pdata.to(torch.int64)
            in_range = in_range & pvalid & (pv >= mins[k]) & (pv <= maxs[k])
            probe = probe + (pv - mins[k]) * strides[k]
    last = keys.shape[0] - 1
    if dense:  # contiguous keys: direct addressing
        rel = probe - lo
        idx = rel.clamp(0, last)
        return idx, (rel >= 0) & (rel < n_valid) & in_range
    idx = torch.searchsorted(keys, probe).clamp(max=last)
    return idx, (keys[idx] == probe) & (idx < n_valid) & in_range


def _placeholder(dtype, cap: int, dev) -> TorchColumnVector:
    """An all-null column standing in for one the stage never reads."""
    return TorchColumnVector(dtype, torch.zeros(1, device=dev).expand(cap),
                             torch.zeros(1, dtype=torch.bool,
                                         device=dev).expand(cap), cap)


def _fact_batch(attrs, needed, batch: TorchColumnarBatch,
                rowmask: torch.Tensor) -> TorchColumnarBatch:
    """The fact source over its full capacity: the needed columns with the
    row mask folded into their validity, the others placeholders."""
    cap, dev = batch.capacity, batch.device
    cols = []
    for o, a in enumerate(attrs):
        if o in needed:
            c = batch.columns[o]
            v = c.validity if c.validity is not None else rowmask
            cols.append(TorchColumnVector(a.dtype, c.data, v & rowmask, cap))
        else:
            cols.append(_placeholder(a.dtype, cap, dev))
    return TorchColumnarBatch(cols, cap)


def _run_stage(spec: _JoinStageSpec, batch: TorchColumnarBatch, dim_flats,
               dim_caps, dim_dense, eval_ctx):
    """One fact batch → its carries (device tensors over G groups)."""
    cap = batch.capacity
    rowmask = row_mask(batch.num_rows, cap, batch.device)
    fact, alive = apply_layers(
        _fact_batch(spec.fact_source.output, set(spec.fact_needed_source),
                    batch, rowmask),
        spec.fact_layers, rowmask, eval_ctx)
    dims = spec.dims
    dim_idx: List[Optional[torch.Tensor]] = [None] * len(dims)

    def payload(di: int, o: int):
        j = dims[di].payload_ordinals.index(o)
        flat = dim_flats[di]
        return flat[6 + 2 * j][dim_idx[di]], flat[7 + 2 * j][dim_idx[di]]

    def resolve(loc):
        if loc[0] == "fact":
            c = fact.columns[loc[1]]
            return c.data, c.validity if c.validity is not None else rowmask
        return payload(loc[1], loc[2])

    for di, d in enumerate(dims):
        idx, matched = _probe(dim_flats[di],
                              [resolve(loc) for loc in d.probe_locs], cap,
                              dim_dense[di])
        dim_idx[di] = idx
        alive = alive & matched

    top_cols = []
    needed_top = set(spec.needed_top)
    for o, a in enumerate(spec.top_output):
        if o in needed_top:
            loc = spec.col_loc[o]
            if loc[0] == "fact":
                top_cols.append(fact.columns[loc[1]])
            else:
                data, valid = payload(loc[1], loc[2])
                top_cols.append(TorchColumnVector(a.dtype, data, valid, cap))
        else:
            top_cols.append(_placeholder(a.dtype, cap, batch.device))
    joined, alive = apply_layers(TorchColumnarBatch(top_cols, cap),
                                 spec.top_layers, alive, eval_ctx)

    if spec.group_dim is not None:
        G = dim_caps[spec.group_dim] + 1
        gcode = torch.where(alive, dim_idx[spec.group_dim], G - 1)
    else:
        G = 2
        gcode = torch.where(alive, 0, 1).to(torch.int64)
    order = _GroupOrder(gcode, G)
    carry = [order.sum(alive.to(torch.int64))]
    for fn in spec.agg_fns:
        if fn.children:
            from ..expressions.base import to_column
            c = to_column(fn.children[0].eval_device(joined, eval_ctx),
                          joined, fn.children[0].dtype)
            v = c.validity if c.validity is not None else rowmask
            carry.extend(_segment_states(fn, c.data, v & alive, gcode, G,
                                         order))
        else:
            carry.extend(_segment_states(fn, None, alive, gcode, G, order))
    return carry


# ---------------------------------------------------------------------------
# the dimension build cache
# ---------------------------------------------------------------------------

# (structure, key/payload ordinals, conf) -> (source objects, build,
# {group ordinals: uniqueness verdict}). An entry is served only while its
# source tables are the same objects (held, so an id cannot be reused);
# the verdicts live in the entry, so a rebuild starts with none.
_DIM_BUILD_CACHE: "collections.OrderedDict" = collections.OrderedDict()


def clear_dim_cache() -> None:
    """Release the cached dimension builds (their device arrays too)."""
    _DIM_BUILD_CACHE.clear()


def _dim_sources(plan: PhysicalPlan) -> list:
    out = []
    for n in plan.collect_nodes():
        if getattr(n, "table", None) is not None:
            out.append(n.table)
        out.extend(getattr(n, "batches", None) or ())
    return out


def _dim_structure(plan: PhysicalPlan) -> str:
    return "|".join(n.node_desc() for n in plan.collect_nodes())


# ---------------------------------------------------------------------------
# the exec
# ---------------------------------------------------------------------------


class TorchCompiledJoinAggStageExec(TorchExec):
    """The fused fact → probe chain → group-by stage."""

    def __init__(self, spec: _JoinStageSpec, fallback: PhysicalPlan,
                 max_dim_rows: int):
        super().__init__([spec.fact_source])
        self.spec = spec
        self.fallback = fallback
        self.max_dim_rows = max_dim_rows
        self._dims_built = None  # per plan instance, like a broadcast

    @property
    def output(self):
        return self.spec.output

    def num_partitions(self) -> int:
        return 1

    def collect_nodes(self):
        # the fallback and dimension subtrees hold exchanges whose blocks
        # the session releases when the query ends
        out = super().collect_nodes()
        seen = {id(n) for n in out}
        for sub in [self.fallback] + [d.plan for d in self.spec.dims]:
            for n in sub.collect_nodes():
                if id(n) not in seen:
                    seen.add(id(n))
                    out.append(n)
        return out

    def node_desc(self) -> str:
        keys = ", ".join(g.name for g in self.spec.grouping) or "<global>"
        return (f"TorchCompiledJoinAggStage[keys={keys}, "
                f"dims={len(self.spec.dims)}]")

    def internal_do_execute_columnar(self, idx: int,
                                     ctx: TaskContext) -> Iterator:
        try:
            result = self._run_compiled(ctx)
        except _JoinStageFallback:
            # re-run on the general join path
            ctx.counters["fallbackReruns"] += 1
            for p in range(self.fallback.num_partitions()):
                yield from self.fallback.execute_partition(
                    p, ctx.for_partition(p))
            return
        yield result

    # -- dimension build ---------------------------------------------------

    def _build_dim(self, d: _DimSpec, ctx: TaskContext):
        """One dimension → (its rows with valid keys in key order, device
        arrays (sorted int64 keys padded with int64 max, row count, dense
        base, composite mins/strides/maxs, payload data + validity), the
        capacity, whether the keys are contiguous)."""
        batches = [b for p in range(d.plan.num_partitions())
                   for b in d.plan.execute_partition(p, ctx.for_partition(p))]
        table = concat_batches(batches) if batches else TorchColumnarBatch(
            [TorchColumnVector.from_scalar(None, a.dtype, 0,
                                           device=ctx.device)
             for a in d.plan.output], 0)
        if table.num_rows > self.max_dim_rows:
            raise _JoinStageFallback(f"dimension of {table.num_rows} rows "
                                     f"past maxDimRows {self.max_dim_rows}")
        valid = row_mask(table.num_rows, table.capacity, table.device)
        for o in d.key_ordinals:
            v = table.columns[o].validity
            if v is not None:
                valid = valid & v
        table = compact(table, valid)
        n, dev = table.num_rows, table.device
        parts = [table.columns[o].data[:n].to(torch.int64)
                 for o in d.key_ordinals]
        i64 = dict(dtype=torch.int64, device=dev)
        if len(parts) == 1:
            keys = parts[0]
            mins, strides = torch.zeros(1, **i64), torch.ones(1, **i64)
            maxs = torch.full((1,), _INT64_MAX - 1, **i64)
        else:
            # monotone composite: Σ (k_i - min_i) · stride_i
            lo_hi = torch.stack([torch.stack([p.min(), p.max()])
                                 for p in parts]).tolist() if n else \
                [[0, 0]] * len(parts)
            spans = [hi - lo + 1 for lo, hi in lo_hi]
            if np.prod([float(s) for s in spans]) >= 2.0 ** 62:
                raise _JoinStageFallback("composite key would overflow")
            st = [1] * len(parts)
            for i in range(len(parts) - 2, -1, -1):
                st[i] = st[i + 1] * spans[i + 1]
            mins = torch.tensor([lo for lo, _ in lo_hi], **i64)
            maxs = torch.tensor([hi for _, hi in lo_hi], **i64)
            strides = torch.tensor(st, **i64)
            keys = sum((p - lo) * s for p, (lo, _), s in zip(parts, lo_hi,
                                                            st))
        order = torch.argsort(keys, stable=True)
        keys = keys[order]
        dup = torch.zeros(n, dtype=torch.bool, device=dev)
        if n > 1:
            dup[1:] = keys[1:] == keys[:-1]
        if bool(dup.any()):
            raise _JoinStageFallback("duplicate dimension keys (fan-out)")
        dense = bool(len(parts) == 1 and n and
                     int(keys[-1]) - int(keys[0]) == n - 1)
        cap_d = bucket_capacity(n)
        sorted_tbl = gather(table, order, n, cap_d)
        padded = torch.full((cap_d,), _INT64_MAX, **i64)
        padded[:n] = keys
        lo = int(keys[0]) if dense else 0
        flat = [padded, torch.tensor(n, **i64), torch.tensor(lo, **i64),
                mins, strides, maxs]
        for o in d.payload_ordinals:
            c = sorted_tbl.columns[o]
            if c.offsets is not None:
                raise _JoinStageFallback("string dimension payload")
            flat.extend([c.data, c.validity_or_true()])
        return sorted_tbl, flat, cap_d, dense

    def _dims(self, ctx: TaskContext):
        if self._dims_built is not None:
            return self._dims_built
        from ..config import ANSI_ENABLED, COMPILED_JOIN_DIM_CACHE_SIZE
        spec = self.spec
        tables, flats, caps, dense, entries = [], [], [], [], []
        for d in spec.dims:
            key = (_dim_structure(d.plan), tuple(d.key_ordinals),
                   tuple(d.payload_ordinals), str(ctx.device),
                   ctx.conf.get(ANSI_ENABLED))
            srcs = _dim_sources(d.plan)
            hit = _DIM_BUILD_CACHE.get(key)
            if hit is not None and len(hit[0]) == len(srcs) \
                    and all(a is b for a, b in zip(hit[0], srcs)):
                entry = hit
                _DIM_BUILD_CACHE.move_to_end(key)
            else:
                entry = (srcs, self._build_dim(d, ctx), {})
                _DIM_BUILD_CACHE[key] = entry
                while len(_DIM_BUILD_CACHE) > ctx.conf.get(
                        COMPILED_JOIN_DIM_CACHE_SIZE):
                    _DIM_BUILD_CACHE.popitem(last=False)
            tbl, flat, cap_d, dn = entry[1]
            tables.append(tbl)
            flats.append(flat)
            caps.append(cap_d)
            dense.append(dn)
            entries.append(entry)
        if spec.group_unique_check and not self._group_keys_unique(
                entries[spec.group_dim], tables[spec.group_dim]):
            raise _JoinStageFallback("group keys repeat across dim rows")
        self._dims_built = (tables, flats, tuple(caps), tuple(dense))
        return self._dims_built

    def _group_keys_unique(self, entry, table: TorchColumnarBatch) -> bool:
        """Are the group key columns unique over the dimension's rows? The
        verdict is memoized in the dimension's cache entry."""
        from .aggregates import (encode_group_keys, lex_sort_permutation,
                                 segment_boundaries)
        ords = tuple(self.spec.group_key_ordinals)
        if ords not in entry[2]:
            n = table.num_rows
            cols = [table.columns[o] for o in ords]
            enc = encode_group_keys(cols, n, table.capacity)
            perm = lex_sort_permutation(enc, n, table.capacity)
            _, _, ng = segment_boundaries(
                enc, perm, row_mask(n, table.capacity, table.device))
            entry[2][ords] = n <= 1 or int(ng) == n
        return entry[2][ords]

    # -- the run -----------------------------------------------------------

    def _run_compiled(self, ctx: TaskContext) -> TorchColumnarBatch:
        spec = self.spec
        tables, flats, caps, dense = self._dims(ctx)
        src = self.children[0]
        carries = []
        for p in range(src.num_partitions()):
            for b in src.execute_partition(p, ctx.for_partition(p)):
                if not b.num_rows:
                    continue
                if any(b.columns[o].offsets is not None
                       for o in spec.fact_needed_source):
                    raise _JoinStageFallback("string fact column")
                carries.append(_run_stage(spec, b, flats, caps, dense,
                                          ctx.eval_ctx))
        if not carries:
            return self._assemble(tables, None, [], 0, ctx)
        occ, carry_np, nocc = self._merge_and_compact(carries)
        return self._assemble(tables, occ, carry_np, nocc, ctx)

    def _carry_combine_ops(self) -> List[str]:
        """The elementwise merge of each carry slot, in the carry layout."""
        ops = ["sum"]  # rowcount
        for fn in self.spec.agg_fns:
            op = fn.update_op
            if not fn.children or op == "count":
                ops.append("sum")
            elif op in ("sum", "avg"):
                ops.extend(["sum", "sum"])
            elif _is_fp(fn.children[0].dtype):
                ops.extend([op, "or", "sum", "sum"])
            else:
                ops.extend([op, "sum"])
        return ops

    def _merge_and_compact(self, carries):
        """Merge the batches' carries on the device, then bring only the
        occupied groups' carries to the host (slot G-1 holds the dropped
        rows); the occupied count is the one scalar read."""
        merged = list(carries[0])
        for nxt in carries[1:]:
            for i, op in enumerate(self._carry_combine_ops()):
                merged[i] = {"sum": torch.add, "min": torch.minimum,
                             "max": torch.maximum,
                             "or": torch.logical_or}[op](merged[i], nxt[i])
        G = merged[0].shape[0]
        if self.spec.grouping:
            occ = torch.nonzero(merged[0][:G - 1] > 0).flatten()
        else:
            occ = torch.zeros(1, dtype=torch.int64, device=merged[0].device)
        return occ, [_to_host(m[occ]) for m in merged], int(occ.shape[0])

    def _assemble(self, dim_tables, occ, carry_np, nocc: int,
                  ctx: TaskContext) -> TorchColumnarBatch:
        """Finalize the occupied groups on the host; the group keys gather
        from the group dimension's rows on the device; the result goes
        back to the device for the operators above."""
        from .aggregates import _bind_agg_refs
        from ..expressions.base import to_column
        spec = self.spec
        names = [a.name for a in spec.output]
        ng = len(spec.grouping)
        if nocc == 0 and spec.grouping:
            return TorchColumnarBatch(
                [TorchColumnVector.from_scalar(None, a.dtype, 0,
                                               device=ctx.device)
                 for a in spec.output], 0, names)
        if not carry_np:  # global aggregate over no rows
            rowcount = np.zeros(1, np.int64)
            states: List[Optional[Dict]] = [None] * len(spec.agg_fns)
            nocc = 1
        else:
            rowcount, states = _np_merge_carries(spec, [tuple(carry_np)])
        cap = bucket_capacity(nocc)
        key_cols = []
        if spec.grouping:
            rows = gather(dim_tables[spec.group_dim], occ, nocc, cap)
            key_cols = [rows.columns[o] for o in spec.group_key_ordinals]
        agg_cols = [TorchColumnVector.from_numpy(
            fn.dtype, *_np_finalize(fn, st, np.arange(nocc)), capacity=cap,
            device=ctx.device) for fn, st in zip(spec.agg_fns, states)]
        table = TorchColumnarBatch(key_cols + agg_cols, nocc)
        out = list(key_cols)
        for expr, attr in zip(spec.result_exprs, spec.output[ng:]):
            bound = _bind_agg_refs(expr, ng, spec.grouping)
            out.append(to_column(bound.eval_device(table, ctx.eval_ctx),
                                 table, attr.dtype))
        return TorchColumnarBatch(out, nocc, names)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A device tensor as numpy, through pinned host memory from a card
    (a pageable copy runs at a fraction of the link's rate)."""
    if not t.is_cuda:
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host.numpy()


def compile_join_agg_stages(plan: PhysicalPlan, conf) -> PhysicalPlan:
    """Post-pass over the physical tree: replace eligible join-aggregate
    subtrees with compiled join stages
    (spark.rapids.tpu.join.compiledStage.enabled). It runs before the
    compiled aggregation pass, so join pipelines get the star-join stage."""
    from ..config import (ANSI_ENABLED, COMPILED_JOIN_ENABLED,
                          COMPILED_JOIN_MAX_DIM_ROWS)
    if not conf.get(COMPILED_JOIN_ENABLED) or conf.get(ANSI_ENABLED):
        return plan
    max_dim = conf.get(COMPILED_JOIN_MAX_DIM_ROWS)

    def rewrite(node: PhysicalPlan) -> PhysicalPlan:
        spec = try_extract_join_stage(node)
        if spec is not None:
            return TorchCompiledJoinAggStageExec(spec, node, max_dim)
        node.children = [rewrite(c) for c in node.children]
        return node

    return rewrite(plan)
