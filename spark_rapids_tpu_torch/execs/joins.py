"""Hash joins on the device: the shuffled and the symmetric shuffled hash
join, and the CPU plan node (port of ``spark_rapids_tpu/execs/joins.py``,
inner equi-joins on fixed-width keys).

The matcher is the reference's sorted-build / range-probe design:

1. each side's keys become one comparable int64 a row: a single key its
   order-preserving bits (``_sortable_bits``), several keys a dense rank
   over both sides (a joint lexicographic sort), so equal values (and only
   those) compare equal; a row with a null key never matches;
2. the build side sorts stably by that code, valid rows first;
3. two ``searchsorted`` calls give every probe row its range of matching
   build rows; the candidate count is the ONE host read, and it sizes the
   output;
4. the pairs expand probe-major, and within one probe row the build rows
   come in their input order (the stable sort), which is the reference's
   pair order whatever its hash.

The reference hashes the keys first (``_mix64``) and verifies equality
after expanding the candidate ranges, so it reads a second count; equal
codes here ARE equal keys, so every candidate is a match and the one read
suffices. Left/right/full outer, semi and anti joins, residual conditions,
string keys and the sub-partitioning of sides past ``batchSizeRows`` are
not yet ported: the override engine keeps such a join on the CPU, whose
execution is not yet ported either.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import torch

from ..columnar.batch import TorchColumnarBatch, concat_batches, gather
from ..columnar.vector import TorchColumnVector, bucket_capacity, row_mask
from ..expressions.base import AttributeReference, Expression, to_column
from ..types import StringType
from .aggregates import (_sortable_bits, lex_sort_permutation,
                         segment_boundaries)
from .base import (PhysicalPlan, TaskContext, TorchExec, bind_all,
                   bind_references)
from .cpu import _HostEngineNotPorted

_INT64_MAX = torch.iinfo(torch.int64).max

def encode_fixed_key_pair(lc: TorchColumnVector, rc: TorchColumnVector,
                          l_enc: list, r_enc: list) -> None:
    """Append one key pair's cross-side comparable int64 codes."""
    for c, out in ((lc, l_enc), (rc, r_enc)):
        out.append((_sortable_bits(c).to(torch.int64), c.validity))


def _encode_sides(left_cols: List[TorchColumnVector],
                  right_cols: List[TorchColumnVector]):
    """Per-key (int64 code, validity) lists of both sides."""
    l_enc: list = []
    r_enc: list = []
    for lc, rc in zip(left_cols, right_cols):
        if isinstance(lc.dtype, StringType) or isinstance(rc.dtype,
                                                          StringType):
            raise NotImplementedError("string join keys not yet ported")
        encode_fixed_key_pair(lc, rc, l_enc, r_enc)
    return l_enc, r_enc


def _row_codes(build_enc, b_rows: int, probe_enc, p_rows: int):
    """One int64 code a row of each side plus the rows that can match
    (every key non-null, not padding). Several keys dense-rank over the
    concatenation of both sides."""
    def ok_mask(enc, rows):
        cap = enc[0][0].shape[0]
        ok = row_mask(rows, cap, enc[0][0].device)
        for _, v in enc:
            if v is not None:
                ok = ok & v
        return ok

    b_ok, p_ok = ok_mask(build_enc, b_rows), ok_mask(probe_enc, p_rows)
    if len(build_enc) == 1:
        return build_enc[0][0], b_ok, probe_enc[0][0], p_ok
    b_cap = build_enc[0][0].shape[0]
    joint = [(torch.cat([bv, pv]), None)
             for (bv, _), (pv, _) in zip(build_enc, probe_enc)]
    ok = torch.cat([b_ok, p_ok])
    joint = [(torch.where(ok, v, 0), None) for v, _ in joint]
    cap = ok.shape[0]
    perm = lex_sort_permutation(joint, cap, cap)
    _, seg_ids, _ = segment_boundaries(joint, perm, torch.ones_like(ok))
    rank = torch.empty(cap, dtype=torch.int64, device=ok.device)
    rank[perm] = seg_ids.to(torch.int64)
    return rank[:b_cap], b_ok, rank[b_cap:], p_ok


def _join_probe_ranges(b_code, b_ok, p_code, p_ok):
    """Stable sort of the build codes (valid rows first), and every probe
    row's range [lo, lo + count) of matching build rows in that order."""
    key_order = torch.argsort(b_code, stable=True)
    order = key_order[torch.argsort((~b_ok[key_order]).to(torch.int8),
                                    stable=True)]
    n_valid = b_ok.sum()
    b_cap = b_code.shape[0]
    sorted_codes = torch.where(
        torch.arange(b_cap, device=b_code.device) < n_valid, b_code[order],
        _INT64_MAX)
    lo = torch.searchsorted(sorted_codes, p_code, right=False)
    hi = torch.searchsorted(sorted_codes, p_code, right=True)
    lo, hi = lo.clamp(max=n_valid), hi.clamp(max=n_valid)
    counts = torch.where(p_ok, hi - lo, 0)
    return counts, lo, order


def _join_emit_pairs(counts, lo, order, total: int, out_cap: int):
    """Expand the ranges into (probe row, build row) pairs, probe-major;
    slots past ``total`` carry -1."""
    dev = counts.device
    ends = torch.cumsum(counts, 0)
    starts = ends - counts
    j = torch.arange(out_cap, device=dev)
    pi = torch.searchsorted(ends, j, right=True).clamp(max=counts.shape[0]
                                                       - 1)
    bi_sorted = (lo[pi] + j - starts[pi]).clamp(0, order.shape[0] - 1)
    live = j < total
    return torch.where(live, pi, -1), torch.where(live, order[bi_sorted], -1)


def _device_equi_join(build_enc, build_rows: int, probe_enc,
                      probe_rows: int):
    """(probe index, build index, pair count, capacity) of the matching
    pairs; one host read (the pair count)."""
    b_code, b_ok, p_code, p_ok = _row_codes(build_enc, build_rows, probe_enc,
                                            probe_rows)
    counts, lo, order = _join_probe_ranges(b_code, b_ok, p_code, p_ok)
    total = int(counts.sum())  # the host sync: it sizes the output
    out_cap = bucket_capacity(max(total, 1))
    pi, bi = _join_emit_pairs(counts, lo, order, total, out_cap)
    return pi, bi, total, out_cap


def _string_bytes(batch: TorchColumnarBatch, idx: torch.Tensor) -> int:
    """Bytes the gathered rows of the batch's string columns need (0 when
    it has none; otherwise one host read)."""
    need = [(c.offsets[1:].to(torch.int64) - c.offsets[:-1].to(torch.int64))
            [idx.clamp(min=0)].mul(idx >= 0).sum()
            for c in batch.columns if c.offsets is not None]
    return int(torch.stack(need).max()) if need else 0


def gather_pairs(batch: TorchColumnarBatch, idx: torch.Tensor, rows: int,
                 cap: int) -> TorchColumnarBatch:
    """Row gather where indices repeat (a build row matched many times)."""
    return gather(batch, idx, rows, cap,
                  byte_capacity=_string_bytes(batch, idx) or None)


class TorchShuffledHashJoinExec(TorchExec):
    """Equi-join building on the right side (reference
    GpuShuffledHashJoinExec, Spark's BuildRight)."""

    def __init__(self, left: PhysicalPlan, right: PhysicalPlan,
                 join_type: str, left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression],
                 condition: Optional[Expression],
                 output: List[AttributeReference],
                 per_partition: bool = False):
        super().__init__([left, right])
        if join_type != "inner" or condition is not None:
            raise NotImplementedError(
                f"{join_type} join with condition={condition is not None} "
                "not yet ported")
        self.join_type = join_type
        self.left_keys = bind_all(list(left_keys), left.output)
        self.right_keys = bind_all(list(right_keys), right.output)
        self.condition = None
        self._output = output
        # both sides hash-partitioned by the keys below: partitions join
        # independently
        self.per_partition = per_partition

    @property
    def output(self):
        return self._output

    def num_partitions(self) -> int:
        return self.children[0].num_partitions() if self.per_partition else 1

    def node_desc(self) -> str:
        return f"TorchShuffledHashJoin[{self.join_type}]"

    def _collect_side(self, child: PhysicalPlan, ctx: TaskContext,
                      idx: int) -> Optional[TorchColumnarBatch]:
        if self.per_partition:
            batches = list(child.execute_partition(idx, ctx))
        else:
            batches = [b for p in range(child.num_partitions())
                       for b in child.execute_partition(
                           p, ctx.for_partition(p))]
        return concat_batches(batches) if batches else None

    def internal_do_execute_columnar(self, idx: int,
                                     ctx: TaskContext) -> Iterator:
        left = self._collect_side(self.children[0], ctx, idx)
        right = self._collect_side(self.children[1], ctx, idx)
        if left is None or right is None or not left.num_rows \
                or not right.num_rows:
            return  # an inner join with an empty side is empty
        out = self._join(left, right, ctx)
        if out.num_rows:
            yield out

    def _join(self, left: TorchColumnarBatch, right: TorchColumnarBatch,
              ctx: TaskContext) -> TorchColumnarBatch:
        lk = [to_column(k.eval_device(left, ctx.eval_ctx), left, k.dtype)
              for k in self.left_keys]
        rk = [to_column(k.eval_device(right, ctx.eval_ctx), right, k.dtype)
              for k in self.right_keys]
        l_enc, r_enc = _encode_sides(lk, rk)
        # probe = left, build = right
        pi, bi, n, out_cap = _device_equi_join(r_enc, right.num_rows, l_enc,
                                               left.num_rows)
        lg = gather_pairs(left, pi, n, out_cap)
        rg = gather_pairs(right, bi, n, out_cap)
        return TorchColumnarBatch(lg.columns + rg.columns, n,
                                  [a.name for a in self._output])


class TorchShuffledSymmetricHashJoinExec(TorchShuffledHashJoinExec):
    """Builds each partition on whichever side materialized smaller: when
    the left is smaller the sides flip (an inner join is its own mirror),
    and the output columns are put back in order."""

    def __init__(self, left, right, join_type, left_keys, right_keys,
                 condition, output, per_partition: bool = False):
        super().__init__(left, right, join_type, left_keys, right_keys,
                         condition, output, per_partition)
        self._twin = TorchShuffledHashJoinExec(
            right, left, join_type, right_keys, left_keys,
            condition, list(right.output) + list(left.output), per_partition)
        self._n_left_cols = len(left.output)

    def node_desc(self) -> str:
        return f"TorchShuffledSymmetricHashJoin[{self.join_type}]"

    def _join(self, left: TorchColumnarBatch, right: TorchColumnarBatch,
              ctx: TaskContext) -> TorchColumnarBatch:
        if left.num_rows < right.num_rows:
            out = self._twin._join(right, left, ctx)
            nl = self._n_left_cols
            cols = out.columns[len(out.columns) - nl:] + \
                out.columns[:len(out.columns) - nl]
            return TorchColumnarBatch(cols, out.num_rows,
                                      [a.name for a in self._output])
        return super()._join(left, right, ctx)


class CpuShuffledHashJoinExec(_HostEngineNotPorted):
    """The planner's hash-join node; the override engine converts it."""

    def __init__(self, left: PhysicalPlan, right: PhysicalPlan,
                 join_type: str, left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression],
                 condition: Optional[Expression],
                 output: List[AttributeReference],
                 per_partition: bool = False):
        super().__init__([left, right])
        self.join_type = join_type
        self.left_keys = bind_all(list(left_keys), left.output)
        self.right_keys = bind_all(list(right_keys), right.output)
        self.condition = (bind_references(condition,
                                          left.output + right.output)
                          if condition is not None else None)
        self._output = output
        self.per_partition = per_partition

    @property
    def output(self):
        return self._output

    def num_partitions(self) -> int:
        return self.children[0].num_partitions() if self.per_partition else 1

    def node_desc(self) -> str:
        return f"CpuShuffledHashJoin[{self.join_type}]"
