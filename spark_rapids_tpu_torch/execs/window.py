"""The window exec on the device (port of ``TpuWindowExec`` from
``spark_rapids_tpu/execs/window.py``; its ``CpuWindowExec`` is
``execs/cpu.CpuWindowExec``, whose host engine, the reference's
per-partition loop, is ``cpu_window_column`` at the end of this file).

One sorted pass a window expression: every input partition concatenated
into one batch (a global ``rank`` ranks across them), the rows sorted by
(partition keys ascending, order keys) with the stable lexicographic sort
of the aggregate (nulls first when ascending, NaN greatest, -0.0 equal to
0.0), the partition and peer-group boundaries marked, and each row's
segment start found by a ``cummax`` of the boundary positions and its
segment end by a ``cummin`` over the reversed array. Then:

* ranks and row numbers from the boundaries;
* sum, count and avg over any frame as differences of prefix sums read at
  the frame's ends (NaN and infinities kept out of the sums and put back
  from their own prefix counts, as the reference does); a float prefix
  sum adds in a fixed order (``_float_prefix_sum``), so two runs agree
  bit for bit;
* min and max over a frame from doubling sparse tables, two lookups a row
  (the reference takes an associative scan for running ROWS frames and a
  segment scatter for the whole partition: min and max are exact, so the
  values agree);
* lead and lag as a row gather inside the segment.

Decimals (``_decimal_frames_device``): sum and avg from the prefix sums of
each value's four 32-bit words, finished as the aggregate finishes a
group; min and max over one lane as int64, over two limbs by each value's
rank among the column's distinct values. A two-limb decimal partition or
order key stays off the card (``plan/overrides._tag_window``).

The result scatters back to input order. ``collect_list`` and
``collect_set`` over a window, and the reference's host-assisted path for
them, are not yet ported: the override engine keeps such a window off the
device with its reason (``plan/overrides._tag_window``).
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np
import torch

from ..columnar.batch import TorchColumnarBatch, concat_batches, gather
from ..columnar.vector import (TorchColumnVector, audited_sync_int,
                               bucket_capacity, lane_mask, row_mask)
from ..expressions.aggregates import AggregateFunction
from ..expressions.base import (AttributeReference, Literal, arrow_column,
                                device_parts, to_column)
from ..expressions.decimals import rows_as
from ..plan.logical import SortOrder
from ..window import (CURRENT_ROW, UNBOUNDED_FOLLOWING, UNBOUNDED_PRECEDING,
                      CumeDist, DenseRank, Lag, Lead, NTile, PercentRank,
                      Rank, RowNumber, WindowExpression, WindowSpec)
from ..expressions.strings import string_key_codes, string_sides
from ..kernels.strings import concat_columns
from ..types import DecimalType, StringType
from .aggregates import encode_group_keys, lex_sort_permutation
from .base import (PhysicalPlan, TaskContext, TorchExec, bind_references,
                   op_time)
from .cpu import sort_indices

#: the window functions the device computes
DEVICE_FUNCTIONS = (RowNumber, Rank, DenseRank, Lead, Lag, NTile,
                    PercentRank, CumeDist)
#: the aggregates the device computes over a frame
DEVICE_AGGREGATES = ("sum", "count", "avg", "min", "max")


def ntile_tiles(fn) -> int:
    """NTile's tile count: a positive integer literal."""
    nt = fn.children[0]
    if not isinstance(nt, Literal) or int(nt.value or 0) <= 0:
        raise ValueError("ntile requires a positive integer literal")
    return int(nt.value)


def bind_window_expr(we: WindowExpression, inputs) -> WindowExpression:
    spec = we.spec
    return WindowExpression(
        bind_references(we.function, inputs),
        WindowSpec([bind_references(p, inputs) for p in spec.partition_by],
                   [SortOrder(bind_references(o.child, inputs), o.ascending,
                              o.nulls_first) for o in spec.order_by],
                   spec.frame, spec.frame_type))


def _next_start_before(is_new: torch.Tensor, idxs: torch.Tensor,
                       cap: int) -> torch.Tensor:
    """For each sorted position, the position where the next segment (of
    the ``is_new`` boundaries) starts: a reversed ``cummin``."""
    nxt = torch.where(is_new, idxs, cap)
    nxt = torch.flip(torch.cummin(torch.flip(nxt, (0,)), 0).values, (0,))
    return torch.cat([nxt[1:], nxt.new_full((1,), cap)])


class TorchWindowExec(TorchExec):
    def __init__(self, window_exprs: Sequence[WindowExpression],
                 child: PhysicalPlan, output: List[AttributeReference]):
        super().__init__([child])
        self.window_exprs = [bind_window_expr(w, child.output)
                             for w in window_exprs]
        self._output = output

    @property
    def output(self):
        return self._output

    def num_partitions(self) -> int:
        return 1

    def node_desc(self) -> str:
        return f"TorchWindow[{len(self.window_exprs)} exprs]"

    def internal_do_execute_columnar(self, idx: int,
                                     ctx: TaskContext) -> Iterator:
        child = self.children[0]
        batches = []
        for p in range(child.num_partitions()):
            batches.extend(child.execute_partition(p, ctx.for_partition(p)))
        if not batches:
            return
        batch = concat_batches(batches)
        del batches
        with op_time(ctx, self):
            cols = list(batch.columns)
            for we in self.window_exprs:
                cols.append(self._eval_window(we, batch, ctx))
        yield TorchColumnarBatch(cols, batch.num_rows,
                                 [a.name for a in self._output])

    # ------------------------------------------------------------------
    def _eval_window(self, we: WindowExpression, batch: TorchColumnarBatch,
                     ctx: TaskContext) -> TorchColumnVector:
        cap, n, dev = batch.capacity, batch.num_rows, batch.device
        spec = we.spec
        part_cols = [to_column(p.eval_device(batch, ctx.eval_ctx), batch,
                               p.dtype) for p in spec.partition_by]
        order_cols = [to_column(o.child.eval_device(batch, ctx.eval_ctx),
                                batch, o.child.dtype) for o in spec.order_by]
        enc = encode_group_keys(part_cols + order_cols, n, cap)
        idxs = torch.arange(cap, dtype=torch.int64, device=dev)
        if enc:
            orders = ([(True, True)] * len(part_cols)
                      + [(o.ascending, o.nulls_first) for o in spec.order_by])
            perm = lex_sort_permutation(enc, n, cap, orders)
        else:
            perm = idxs

        def boundaries(keys, start: torch.Tensor) -> torch.Tensor:
            out = start.clone()
            for vals, validity in keys:
                sv = vals[perm]
                out[1:] |= sv[1:] != sv[:-1]
                if validity is not None:
                    nv = validity[perm]
                    out[1:] |= nv[1:] != nv[:-1]
            return out

        first = torch.zeros(cap, dtype=torch.bool, device=dev)
        first[0] = True
        is_new_part = boundaries(enc[:len(part_cols)], first)
        # a peer group (tied order keys) ends where the partition or any
        # order key changes
        is_new_order = boundaries(enc[len(part_cols):], is_new_part)
        seg_start = torch.cummax(torch.where(is_new_part, idxs, 0), 0).values
        seg_end = _next_start_before(is_new_part, idxs, cap).clamp(max=n)
        fn = we.function
        if isinstance(fn, (Lead, Lag)):
            return self._offset(fn, batch, ctx, perm, idxs, seg_start,
                                seg_end)
        if isinstance(fn, AggregateFunction) and fn.update_op in (
                "min", "max") and isinstance(fn.dtype, StringType):
            return self._string_minmax(fn, spec, batch, ctx, perm, idxs,
                                       seg_start, seg_end, is_new_order)
        result, validity = self._compute_fn(
            fn, spec, batch, ctx, perm, idxs, is_new_order, seg_start,
            seg_end)
        # back to input order
        inv = torch.empty_like(perm)
        inv[perm] = idxs
        mask = row_mask(n, cap, dev)
        valid = mask if validity is None else validity[inv] & mask
        data = result[inv]
        data = torch.where(lane_mask(valid, data), data,
                           torch.zeros((), dtype=data.dtype, device=dev))
        return TorchColumnVector(fn.dtype, data, valid, n)

    def _compute_fn(self, fn, spec, batch, ctx, perm, idxs, is_new_order,
                    seg_start, seg_end):
        cap = idxs.shape[0]
        if isinstance(fn, RowNumber):
            return (idxs - seg_start + 1).to(torch.int32), None
        if isinstance(fn, (Rank, PercentRank)):
            last_bnd = torch.cummax(torch.where(is_new_order, idxs, 0),
                                    0).values
            rank = last_bnd - seg_start + 1
            if isinstance(fn, Rank):
                return rank.to(torch.int32), None
            size = seg_end - seg_start
            pr = (rank - 1).to(torch.float64) \
                / (size - 1).clamp(min=1).to(torch.float64)
            return torch.where(size > 1, pr, 0.0), None
        if isinstance(fn, DenseRank):
            c = torch.cumsum(is_new_order.to(torch.int64), 0)
            return (c - c[seg_start] + 1).to(torch.int32), None
        if isinstance(fn, NTile):
            tiles = ntile_tiles(fn)
            size = seg_end - seg_start
            k = idxs - seg_start
            base = torch.div(size, tiles, rounding_mode="floor")
            rem = size % tiles
            cut = rem * (base + 1)
            tile = torch.where(
                k < cut,
                torch.div(k, (base + 1).clamp(min=1), rounding_mode="floor"),
                rem + torch.div(k - cut, base.clamp(min=1),
                                rounding_mode="floor"))
            return (tile + 1).to(torch.int32), None
        if isinstance(fn, CumeDist):
            peer_end = torch.minimum(
                _next_start_before(is_new_order, idxs, cap), seg_end)
            size = (seg_end - seg_start).clamp(min=1)
            return ((peer_end - seg_start).to(torch.float64)
                    / size.to(torch.float64)), None
        if isinstance(fn, AggregateFunction):
            return self._agg_over_frame(fn, spec, batch, ctx, perm, idxs,
                                        seg_start, seg_end, is_new_order)
        raise NotImplementedError(
            f"window function {type(fn).__name__} not yet ported")

    def _offset(self, fn, batch, ctx, perm, idxs, seg_start, seg_end):
        """lead / lag: the row ``offset`` rows after (before) in the
        segment, null (or the default) past its edge."""
        cap, n, dev = batch.capacity, batch.num_rows, batch.device
        col = to_column(fn.children[0].eval_device(batch, ctx.eval_ctx),
                        batch, fn.children[0].dtype)
        off = fn.offset if isinstance(fn, Lead) else -fn.offset
        tgt = idxs + off
        in_seg = (tgt >= seg_start) & (tgt < seg_end)
        src_sorted = torch.where(in_seg, perm[tgt.clamp(0, cap - 1)], -1)
        src = torch.empty_like(perm)
        src[perm] = src_sorted
        outside = torch.empty_like(in_seg)
        outside[perm] = ~in_seg
        out = gather(TorchColumnarBatch([col], n), src, n, cap).columns[0]
        if fn.default is None:
            return out
        take = outside & row_mask(n, cap, dev)
        default = fn.default.eval_device(batch, ctx.eval_ctx)
        if out.offsets is not None:
            return _string_default(out, take, default, batch)
        if isinstance(out.dtype, DecimalType):  # the column's carrier
            dd, dv = rows_as(default, fn.default.dtype, out.dtype, cap, dev)
        else:
            dd, dv = device_parts(default, cap, dev)
            dd = torch.broadcast_to(dd, (cap,)).to(out.data.dtype)
        data = torch.where(lane_mask(take, out.data), dd, out.data)
        valid = out.validity_or_true() | (take if dv is None
                                          else take & dv)
        return TorchColumnVector(out.dtype, torch.where(
            lane_mask(valid, data), data,
            torch.zeros((), dtype=data.dtype, device=dev)), valid, n)

    def _string_minmax(self, fn, spec, batch, ctx, perm, idxs, seg_start,
                       seg_end, is_new_order) -> TorchColumnVector:
        """Window min / max of a string: the frame's min / max over the
        strings' order-preserving key codes (equal exactly for equal
        strings, ``expressions/strings.string_key_codes``), then a row with
        that code gathered for each result."""
        cap, n, dev = batch.capacity, batch.num_rows, batch.device
        col = to_column(fn.children[0].eval_device(batch, ctx.eval_ctx),
                        batch, fn.children[0].dtype)
        codes = string_key_codes([col])[0]
        red, valid = self._agg_over_frame(fn, spec, batch, ctx, perm, idxs,
                                          seg_start, seg_end, is_new_order,
                                          values=(codes, col))
        ok = col.validity_or_true()
        key = torch.where(ok, codes, torch.iinfo(torch.int64).max)
        sorted_codes, order = torch.sort(key)
        at = torch.searchsorted(sorted_codes, red).clamp(max=cap - 1)
        rows_sorted = torch.where(valid, order[at], -1)
        inv = torch.empty_like(perm)
        inv[perm] = idxs
        rows = torch.where(row_mask(n, cap, dev), rows_sorted[inv], -1)
        lens = (col.offsets[1:] - col.offsets[:-1]).to(torch.int64)
        # one host read: the result's bytes (a row may repeat)
        total = audited_sync_int(torch.where(
            rows >= 0, lens[rows.clamp(min=0)], 0).sum(), "chars")
        return gather(TorchColumnarBatch([col], n), rows, n, cap,
                      byte_capacity=bucket_capacity(max(total, 1))
                      ).columns[0]

    def _agg_over_frame(self, fn, spec, batch, ctx, perm, idxs, seg_start,
                        seg_end, is_new_order, values=None):
        cap, n, dev = batch.capacity, batch.num_rows, batch.device
        op = fn.update_op
        if values is not None:  # a string's key codes, with its column
            codes, col = values
            sdata = codes[perm]
            svalid = col.validity_or_true()[perm]
        elif fn.children:
            col = to_column(fn.children[0].eval_device(batch, ctx.eval_ctx),
                            batch, fn.children[0].dtype)
            if col.offsets is None:
                sdata = col.data[perm]
            elif op == "count":  # only the validity counts
                sdata = torch.ones(cap, dtype=torch.int64, device=dev)
            else:  # tagged off the card by the override rule
                raise NotImplementedError(
                    f"window {op} of strings not yet ported")
            svalid = col.validity_or_true()[perm]
        else:
            sdata = torch.ones(cap, dtype=torch.int64, device=dev)
            svalid = torch.ones(cap, dtype=torch.bool, device=dev)
        svalid = svalid & row_mask(n, cap, dev)[perm]

        frame = spec.frame
        range_mode = spec.frame_type == "range" or frame is None
        if frame is None:
            # Spark's default: with ORDER BY a RANGE frame from unbounded
            # preceding to the current row; without, the whole partition
            frame = ((UNBOUNDED_PRECEDING, CURRENT_ROW) if spec.order_by
                     else (UNBOUNDED_PRECEDING, UNBOUNDED_FOLLOWING))
        lo_off, hi_off = frame
        # in a RANGE frame CURRENT ROW is the row's whole peer group
        peer_start = peer_end = None
        if range_mode and spec.order_by:
            peer_start = torch.cummax(torch.where(is_new_order, idxs, 0),
                                      0).values
            peer_end = torch.minimum(
                _next_start_before(is_new_order, idxs, cap), seg_end)
        if lo_off == UNBOUNDED_PRECEDING:
            lo = seg_start
        elif peer_start is not None and lo_off == CURRENT_ROW:
            lo = peer_start
        else:
            lo = torch.maximum(idxs + lo_off, seg_start)
        if hi_off == UNBOUNDED_FOLLOWING:
            hi = seg_end - 1
        elif peer_end is not None and hi_off == CURRENT_ROW:
            hi = peer_end - 1
        else:
            hi = torch.minimum(idxs + hi_off, seg_end - 1)

        if op not in ("sum", "count", "avg", "min", "max"):
            raise NotImplementedError(f"window aggregate {op} not yet ported")
        if values is None and fn.children and op != "count" \
                and isinstance(fn.children[0].dtype, DecimalType):
            return _decimal_frames_device(fn, sdata, svalid, lo, hi,
                                          ctx.eval_ctx.ansi)
        if op in ("min", "max"):
            return _bounded_minmax(op, sdata, svalid, lo, hi)
        if sdata.dim() == 2:  # a two-limb decimal's count: its validity
            sdata = svalid
        is_fp = sdata.is_floating_point()
        acc = torch.float64 if op == "avg" or is_fp else torch.int64
        zero = torch.zeros((), dtype=sdata.dtype, device=dev)
        x = torch.where(svalid, sdata, zero).to(acc)

        c = _range_sum(_prefix(svalid), lo, hi)
        if op == "count":
            return c, None
        if is_fp:
            # NaN and infinities would poison the prefix sums across
            # partitions: count them apart and put them back
            n_nan = _range_sum(_prefix(svalid & torch.isnan(sdata)), lo, hi)
            n_pinf = _range_sum(_prefix(svalid & torch.isposinf(sdata)),
                                lo, hi)
            n_ninf = _range_sum(_prefix(svalid & torch.isneginf(sdata)),
                                lo, hi)
            x = torch.where(torch.isfinite(x), x, 0.0)
        s = _range_sum(_prefix(x), lo, hi)
        if is_fp:
            s = torch.where((n_nan > 0) | ((n_pinf > 0) & (n_ninf > 0)),
                            float("nan"),
                            torch.where(n_pinf > 0, float("inf"),
                                        torch.where(n_ninf > 0,
                                                    float("-inf"), s)))
        valid = c > 0
        if op == "sum":
            out = fn.dtype.torch_dtype
            return torch.where(valid, s, 0).to(out), valid
        avg = s.to(torch.float64) / torch.where(valid, c, 1).to(torch.float64)
        return torch.where(valid, avg, 0.0), valid


def _prefix(t: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums: a float column's in a fixed order, an
    integral (or boolean) one's in int64."""
    if t.is_floating_point():
        return _float_prefix_sum(t)
    return torch.cumsum(t.to(torch.int64), 0)


def _range_sum(prefix: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
               ) -> torch.Tensor:
    """The sum over each row's sorted positions [lo, hi] (0 when lo >
    hi) from the prefix sums: a difference (an int64 one wraps, exact
    while the frame's own sum fits)."""
    cap = prefix.shape[0]
    zero = torch.zeros((), dtype=prefix.dtype, device=prefix.device)
    hi_v = prefix[hi.clamp(0, cap - 1)]
    lo_v = torch.where(lo > 0, prefix[(lo - 1).clamp(0, cap - 1)], zero)
    return torch.where(hi >= lo, hi_v - lo_v, zero)


def _decimal_frames_device(fn, sdata: torch.Tensor, svalid: torch.Tensor,
                           lo: torch.Tensor, hi: torch.Tensor, ansi: bool):
    """A decimal sum, avg, min or max over every row's frame, in sorted
    order: (result carrier, validity). Sum and avg take each value's four
    32-bit words (``decimal128.segment_words128``) summed over the frame
    by prefix-sum differences, finished as the aggregate finishes its
    groups (``aggregates._decimal_result``: null past the sum type, avg's
    quotient by ``div_half_up``). Min and max of one lane are the int64
    sparse tables; of two limbs, the same over each value's rank among
    the column's distinct values, mapped back."""
    from ..kernels import decimal128 as D
    from .aggregates import _decimal_result
    op, cap = fn.update_op, sdata.shape[0]
    if op in ("min", "max"):
        if sdata.dim() == 1:
            return _bounded_minmax(op, sdata, svalid, lo, hi)
        codes, table = _distinct_codes128(sdata)
        red, valid = _bounded_minmax(op, codes, svalid, lo, hi)
        return table[red], valid
    h, l = D.limbs_of(sdata)
    h, l = torch.where(svalid, h, 0), torch.where(svalid, l, 0)
    state = {"words": D.segment_words128(
        h, l, lambda w: _range_sum(_prefix(w), lo, hi)),
             "nonnull": _range_sum(_prefix(svalid), lo, hi)}
    out = _decimal_result(fn, state, cap, cap, ansi)
    return out.data, out.validity


def _distinct_codes128(data: torch.Tensor):
    """Each two-limb value's rank among the distinct values (signed
    128-bit order) and the table of values by rank: (codes [n], table [n,
    2])."""
    h, l = data[:, 0], data[:, 1]
    o1 = torch.sort(l ^ -2 ** 63, stable=True).indices  # unsigned low limb
    order = o1[torch.sort(h[o1], stable=True).indices]
    sh, sl = h[order], l[order]
    new = torch.ones_like(sh, dtype=torch.bool)
    new[1:] = (sh[1:] != sh[:-1]) | (sl[1:] != sl[:-1])
    ranked = torch.cumsum(new.to(torch.int64), 0) - 1
    codes = torch.empty_like(ranked)
    codes[order] = ranked
    table = torch.zeros_like(data)
    table[ranked] = data[order]
    return codes, table


def _float_prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a float column in a fixed order (a
    Hillis-Steele scan: log2(n) shifted adds). ``torch.cumsum`` of floats
    on CUDA may add in another order from run to run, and two collects of
    a query must give identical answers."""
    out = x.clone()
    shift = 1
    while shift < out.shape[0]:
        nxt = out.clone()
        nxt[shift:] += out[:-shift]
        out = nxt
        shift <<= 1
    return out


def _neutral(op: str, dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _bounded_minmax(op: str, sdata: torch.Tensor, svalid: torch.Tensor,
                    lo: torch.Tensor, hi: torch.Tensor):
    """min / max over each row's sorted positions [lo, hi] from doubling
    sparse tables: level k reduces [i, i + 2^k), and a range of length L is
    the overlap of two blocks of 2^floor(log2 L). NaN orders greatest, as
    in Spark: max is NaN when the frame holds a NaN, min only when every
    valid value in it is NaN."""
    cap, dev = sdata.shape[0], sdata.device
    is_fp = sdata.is_floating_point()
    nanmask = svalid & torch.isnan(sdata) if is_fp \
        else torch.zeros(cap, dtype=torch.bool, device=dev)
    clean = svalid & ~nanmask
    neutral = _neutral(op, sdata.dtype)
    reduce2 = torch.minimum if op == "min" else torch.maximum
    levels = max(int(np.ceil(np.log2(max(cap, 2)))), 1) + 1
    vals = [torch.where(clean, sdata, torch.full((), neutral,
                                                 dtype=sdata.dtype,
                                                 device=dev))]
    anyc, anyn = [clean], [nanmask]
    for k in range(1, levels):
        shift = 1 << (k - 1)
        if shift >= cap:
            vals.append(vals[-1])
            anyc.append(anyc[-1])
            anyn.append(anyn[-1])
            continue
        pv, pc, pn = vals[-1], anyc[-1], anyn[-1]
        vals.append(reduce2(pv, torch.cat([pv[shift:], pv.new_full(
            (shift,), neutral)])))
        anyc.append(pc | torch.cat([pc[shift:], pc.new_zeros(shift)]))
        anyn.append(pn | torch.cat([pn[shift:], pn.new_zeros(shift)]))
    T, C, N = torch.stack(vals), torch.stack(anyc), torch.stack(anyn)
    length = hi - lo + 1
    empty = length <= 0
    k = torch.floor(torch.log2(length.clamp(min=1).to(torch.float64))).to(
        torch.int64).clamp(0, levels - 1)
    # float log2 can land one off at powers of two: fix k so 2^k <= L
    k = torch.where((1 << (k + 1)) <= length, k + 1, k).clamp(0, levels - 1)
    k = torch.where((1 << k) > length.clamp(min=1), k - 1, k).clamp(min=0)
    a = lo.clamp(0, cap - 1)
    b = (hi - (1 << k) + 1).clamp(0, cap - 1)
    red = reduce2(T[k, a], T[k, b])
    any_clean = (C[k, a] | C[k, b]) & ~empty
    any_nan = (N[k, a] | N[k, b]) & ~empty
    valid = any_clean | any_nan
    if is_fp:
        nan = torch.full((), float("nan"), dtype=sdata.dtype, device=dev)
        if op == "max":
            red = torch.where(any_nan, nan, torch.where(any_clean, red, nan))
        else:
            red = torch.where(any_clean, red, nan)
    return torch.where(valid, red, torch.zeros((), dtype=sdata.dtype,
                                               device=dev)), valid


def _string_default(out: TorchColumnVector, take: torch.Tensor, default,
                    batch) -> TorchColumnVector:
    """lead / lag of a string with a default: the gathered rows, the
    default's bytes where the offset leaves the partition (``take``); one
    ragged gather of the two sides."""
    sides = string_sides([out, default], batch)
    keep = out.validity_or_true() & ~take
    use = take if sides[1][3] is None else take & sides[1][3]
    data, offs = concat_columns(
        [sides[0][:3], sides[1][:3]],
        out.data.numel() + sides[1][0].numel() * batch.capacity,
        part_emit=[keep, use])
    return TorchColumnVector(out.dtype, data, keep | use, out.num_rows,
                             offsets=offs)


# ---------------------------------------------------------------------------
# the host engine's window (reference ``CpuWindowExec``, the per-partition
# loop)
# ---------------------------------------------------------------------------


def _canon(v):
    """A value as a key of Python equality: NaN equals NaN."""
    return ("NaN",) if isinstance(v, float) and v != v else v


def _nan_greatest(v):
    return (1, 0.0) if isinstance(v, float) and v != v else (0, v)


def _host_agg(op: str, vals: list, integral: bool):
    """One frame's aggregate over its non-null values (Spark's: NaN
    greatest for min/max, a long sum wraps)."""
    if op == "count":
        return len(vals)
    if not vals:
        return None
    if op == "sum":
        s = sum(vals)
        return (s + 2**63) % 2**64 - 2**63 if integral else s
    if op == "avg":
        return sum(vals) / len(vals)
    return (min if op == "min" else max)(vals, key=_nan_greatest)


def _frame_bounds(spec, n: int, peers_lo, peers_hi):
    """Each row's [lo, hi] frame inside a partition of ``n`` rows (RANGE
    frames by peer group)."""
    frame = spec.frame
    range_mode = frame is None or spec.frame_type == "range"
    if frame is None:
        frame = ((UNBOUNDED_PRECEDING, CURRENT_ROW) if spec.order_by
                 else (UNBOUNDED_PRECEDING, UNBOUNDED_FOLLOWING))
    lo_off, hi_off = frame
    out = []
    for k in range(n):
        if lo_off == UNBOUNDED_PRECEDING:
            lo = 0
        elif range_mode and spec.order_by and lo_off == CURRENT_ROW:
            lo = peers_lo[k]
        else:
            lo = max(0, k + lo_off)
        if hi_off == UNBOUNDED_FOLLOWING:
            hi = n - 1
        elif range_mode and spec.order_by and hi_off == CURRENT_ROW:
            hi = peers_hi[k]
        else:
            hi = min(n - 1, k + hi_off)
        out.append((lo, hi))
    return out


def _frame_aggregates(op: str, vals: list, bounds, integral: bool) -> list:
    """The aggregate of every frame. Frames that start at the partition's
    start and never shrink (running and whole-partition frames) accumulate
    in one left-to-right pass (the reference's float order); the others
    reduce their own rows."""
    if not (all(lo == 0 for lo, _ in bounds)
            and all(b[1] <= c[1] for b, c in zip(bounds, bounds[1:]))):
        return [_host_agg(op, [v for v in vals[lo:hi + 1] if v is not None],
                          integral) for lo, hi in bounds]
    out, at, cnt, acc = [], 0, 0, None
    for _, hi in bounds:
        while at <= hi:
            v = vals[at]
            at += 1
            if v is None:
                continue
            cnt += 1
            if acc is None:
                acc = v
            elif op in ("sum", "avg"):
                acc = acc + v
            elif op in ("min", "max"):
                acc = (min if op == "min" else max)((acc, v),
                                                      key=_nan_greatest)
        if op == "count":
            out.append(cnt)
        elif acc is None:
            out.append(None)
        elif op == "sum":
            out.append((acc + 2**63) % 2**64 - 2**63 if integral else acc)
        elif op == "avg":
            out.append(acc / cnt)
        else:
            out.append(acc)
    return out


def _decimal_sum_avg(fn) -> bool:
    return isinstance(fn, AggregateFunction) and fn.update_op in (
        "sum", "avg") and isinstance(fn.children[0].dtype, DecimalType)


def _decimal_frames(fn, vals: list, bounds, ansi: bool) -> list:
    """A decimal sum/avg of every frame from the rows' unscaled ints:
    exact frame sums and counts, finished as the aggregate finishes them
    (``decimals.finish_sum_avg``), as ``decimal.Decimal`` values."""
    from ..expressions.decimals import finish_sum_avg
    from ..kernels.decimal128 import scaled_decimal
    sums = np.empty(len(bounds), dtype=object)
    sums[:] = [v or 0 for v in _frame_aggregates("sum", vals, bounds, False)]
    counts = np.empty(len(bounds), dtype=object)
    counts[:] = _frame_aggregates("count", vals, bounds, False)
    v, ok = finish_sum_avg(fn, sums, counts, ansi)
    return [scaled_decimal(int(x), fn.dtype.scale) if k else None
            for x, k in zip(v, ok)]


def cpu_window_column(we: WindowExpression, table, ctx: TaskContext, attr):
    """One window expression over an Arrow table on the host: the rows in
    (partition keys ascending, nulls first; order keys) order by the host
    sort, then each partition's function a row at a time, as the
    reference's loop. A string ``sum``/``avg`` reads its strings as
    doubles (Spark's implicit cast); ``lead``/``lag`` take a default of
    any type."""
    import pyarrow as pa
    from ..types import DoubleT, to_arrow
    n, spec, fn = table.num_rows, we.spec, we.function
    ectx = ctx.eval_ctx

    def rows(e):
        arr = arrow_column(e.eval_cpu(table, ectx), n, e.dtype)
        # dates and timestamps as their integers: the same order, and no
        # Python datetime a row (the result array takes them back)
        if pa.types.is_date32(arr.type) or pa.types.is_timestamp(arr.type):
            arr = arr.cast(pa.int32() if pa.types.is_date32(arr.type)
                           else pa.int64())
        return arr.to_pylist()

    keys = [SortOrder(p, True, True) for p in spec.partition_by] \
        + list(spec.order_by)
    order = sort_indices(table, keys, ctx).to_numpy() if keys \
        else np.arange(n)
    part_vals = [rows(p) for p in spec.partition_by]
    order_vals = [rows(o.child) for o in spec.order_by]
    pkey = [tuple(_canon(v[r]) for v in part_vals) for r in order]
    okey = [tuple(_canon(v[r]) for v in order_vals) for r in order]
    values = None
    if isinstance(fn, (AggregateFunction, Lead, Lag)) and fn.children:
        child = fn.children[0]
        if isinstance(fn, AggregateFunction) and fn.update_op in (
                "sum", "avg") and isinstance(child.dtype, StringType):
            from ..expressions.cast import parse_string
            values = parse_string(arrow_column(child.eval_cpu(table, ectx),
                                               n, child.dtype),
                                  DoubleT).to_pylist()
        elif _decimal_sum_avg(fn):
            # the unscaled Python ints: exact sums, finished by Spark's rule
            from ..expressions.decimals import arrow_ints
            values = arrow_ints(arrow_column(child.eval_cpu(table, ectx), n,
                                             child.dtype), child.dtype)
        else:
            values = rows(child)
    results = [None] * n
    i = 0
    while i < n:
        j = i
        while j < n and pkey[j] == pkey[i]:
            j += 1
        _host_partition(fn, spec, order[i:j], okey[i:j], values, results,
                        table, ectx)
        i = j
    return pa.array(results, type=to_arrow(attr.dtype))


def _host_partition(fn, spec, rows, okey, values, results, table, ectx):
    from ..types import IntegralType
    n = len(rows)
    peers_lo, peers_hi = [0] * n, [0] * n
    start = 0
    for k in range(1, n + 1):
        if k == n or okey[k] != okey[start]:
            for m in range(start, k):
                peers_lo[m], peers_hi[m] = start, k - 1
            start = k
    if isinstance(fn, RowNumber):
        for k, r in enumerate(rows):
            results[r] = k + 1
    elif isinstance(fn, (Rank, DenseRank, PercentRank)):
        dense = 0
        for k, r in enumerate(rows):
            if peers_lo[k] == k:
                dense += 1
            rank = peers_lo[k] + 1
            results[r] = rank if isinstance(fn, Rank) else dense \
                if isinstance(fn, DenseRank) else \
                ((rank - 1) / (n - 1) if n > 1 else 0.0)
    elif isinstance(fn, CumeDist):
        for k, r in enumerate(rows):
            results[r] = (peers_hi[k] + 1) / n
    elif isinstance(fn, NTile):
        tiles = ntile_tiles(fn)
        base, rem = n // tiles, n % tiles
        for k, r in enumerate(rows):
            results[r] = k // (base + 1) + 1 if k < rem * (base + 1) \
                else rem + (k - rem * (base + 1)) // max(base, 1) + 1
    elif isinstance(fn, (Lead, Lag)):
        off = fn.offset if isinstance(fn, Lead) else -fn.offset
        default = None
        if fn.default is not None and not isinstance(fn.default, Literal):
            default = arrow_column(fn.default.eval_cpu(table, ectx),
                                   table.num_rows,
                                   fn.default.dtype).to_pylist()
        for k, r in enumerate(rows):
            tk = k + off
            if 0 <= tk < n:
                results[r] = values[rows[tk]]
            elif fn.default is None:
                results[r] = None
            else:
                results[r] = fn.default.value if default is None \
                    else default[r]
    elif isinstance(fn, AggregateFunction):
        vals = [values[r] for r in rows] if fn.children else [1] * n
        integral = bool(fn.children) and isinstance(fn.children[0].dtype,
                                                     IntegralType)
        bounds = _frame_bounds(spec, n, peers_lo, peers_hi)
        if _decimal_sum_avg(fn):
            out = _decimal_frames(fn, vals, bounds, ectx.ansi)
        else:
            out = _frame_aggregates(fn.update_op, vals, bounds, integral)
        for r, v in zip(rows, out):
            results[r] = v
    else:
        raise NotImplementedError(
            f"host window function {type(fn).__name__} not yet ported")
