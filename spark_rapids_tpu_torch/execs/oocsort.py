"""Out-of-core sort: sorted runs + a host merge over the key encodings
(port of ``spark_rapids_tpu/execs/oocsort.py``).

Each input batch is sorted in-core into a run, and its keys' int64
encodings are copied to the host: 8 bytes a row a fixed-width key, and a
string key as its 8-byte words and its length (``string_words``), which
compare across runs once padded to one width. The global order is
one ``np.lexsort`` over every run's keys; each output slice gathers its
rows run by run and finish-sorts in-core. For aggregation, slice ends snap
to group-key boundaries so no group straddles two output batches.

Sorted runs are parked in the spill catalog (device → host → disk) as
``SpillableColumnarBatch``es, as in the reference, and come back to the
device when a slice gathers from them. The host holds only int64 key
words, never a string.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..columnar.batch import (TorchColumnarBatch, bucket_capacity,
                              concat_batches, gather)
from ..columnar.vector import host_arrays
from ..expressions.strings import PADDING_WORD, longest_string, string_words
from ..plan.logical import SortOrder


def _run_key_words(col) -> List[torch.Tensor]:
    """A key column's int64 words for the host merge: its sortable bits
    (fixed width), or its ``string_words`` at this run's width."""
    from .aggregates import _sortable_bits
    if col.offsets is not None:
        return string_words(col, -(-longest_string([col]) // 8))
    return [_sortable_bits(col).to(torch.int64)]


class OutOfCoreSorter:
    def __init__(self, order: List[SortOrder], ctx):
        self.order = order
        self.ctx = ctx
        self.runs: List = []  # SpillableColumnarBatch per sorted run
        # per run, per key: (int64 words, validity or None) on the host
        self.run_keys: List[List[Tuple[List[np.ndarray],
                                       Optional[np.ndarray]]]] = []
        self.total_rows = 0

    def add_batch(self, batch: TorchColumnarBatch) -> None:
        """Sort the run in-core, snapshot its host keys, park it
        spillable."""
        from ..memory.spill import SpillableColumnarBatch
        from .sort import sort_permutation
        perm, key_cols = sort_permutation(batch, self.order, self.ctx)
        n = batch.num_rows
        run = gather(batch, perm, n, out_capacity=batch.capacity)
        rows = perm[:n]
        # the run's key words and validity, one download
        keys = [([w[rows] for w in _run_key_words(c)],
                 None if c.validity is None else c.validity[rows])
                for c in key_cols]
        host = iter(host_arrays([t for ws, v in keys for t in ws + [v]],
                                "fetch"))
        self.run_keys.append([([next(host) for _ in ws], next(host))
                              for ws, _ in keys])
        self.runs.append(SpillableColumnarBatch(run))
        self.total_rows += n

    # -- host-side global order --------------------------------------------

    def _transformed_keys(self) -> List[np.ndarray]:
        """Per sort key, its null flag and then its words as int64 arrays
        over all runs, so ascending np.lexsort yields the requested order
        without a sentinel encoding. A string key's runs pad their words to
        the widest run's, before the length."""
        out = []
        for ki, o in enumerate(self.order):
            parts = [rk[ki] for rk in self.run_keys]
            width = max((len(p[0]) for p in parts), default=1)
            words = [p[0][:-1] + [np.full(len(p[0][-1]), PADDING_WORD,
                                          np.int64)] * (width - len(p[0]))
                     + p[0][-1:] for p in parts]
            valid = np.concatenate(
                [p[1] if p[1] is not None else np.ones(len(p[0][0]), bool)
                 for p in parts]) if parts else np.array([], dtype=bool)
            flag = np.where(valid, 1, 0) if o.nulls_first \
                else np.where(valid, 0, 1)
            out.append(flag.astype(np.int64))
            for i in range(width):
                v = np.concatenate([w[i] for w in words]) if parts else \
                    np.array([], dtype=np.int64)
                if not o.ascending:
                    v = np.int64(-1) ^ v
                out.append(np.where(valid, v, 0))  # the flag orders nulls
        return out

    def _global_order(self):
        """→ (run_id, row_id, keys) arrays in global sorted order."""
        run_ids = np.concatenate(
            [np.full(len(rk[0][0][0]), i, dtype=np.int32)
             for i, rk in enumerate(self.run_keys)]) \
            if self.run_keys else np.array([], np.int32)
        row_ids = np.concatenate(
            [np.arange(len(rk[0][0][0]), dtype=np.int64)
             for rk in self.run_keys]) if self.run_keys else \
            np.array([], np.int64)
        keys = self._transformed_keys()
        if not len(run_ids):
            return run_ids, row_ids, keys
        # np.lexsort: the LAST key is primary; stability keeps (run, row)
        order = np.lexsort(tuple(reversed(keys)))
        return run_ids[order], row_ids[order], [k[order] for k in keys]

    # -- output ------------------------------------------------------------

    def iter_sorted(self, target_rows: int,
                    group_boundaries: bool = False
                    ) -> Iterator[TorchColumnarBatch]:
        """Emit globally sorted slices of about target_rows. With
        group_boundaries, slice ends move forward to the next key change."""
        rid, row, keys = self._global_order()
        total = len(rid)
        if not total:
            return
        boundary = None
        if group_boundaries and keys:
            neq = np.zeros(total, dtype=bool)
            for k in keys:
                neq[1:] |= k[1:] != k[:-1]
            boundary = np.nonzero(neq)[0]  # where a new group starts
        start = 0
        while start < total:
            end = min(start + max(1, target_rows), total)
            if boundary is not None and end < total:
                at = np.searchsorted(boundary, end)
                nxt = boundary[at] if at < len(boundary) else total
                end = int(nxt) if nxt > start else total
            yield self._emit_slice(rid, row, start, end)
            start = end

    def _emit_slice(self, rid, row, start: int,
                    end: int) -> TorchColumnarBatch:
        from .sort import sort_batch
        pieces = []
        sl_rid = rid[start:end]
        sl_row = row[start:end]
        for run_idx in np.unique(sl_rid):
            sel = sl_row[sl_rid == run_idx]
            b = self.runs[run_idx].get_batch()
            cap = bucket_capacity(len(sel))
            padded = np.full(cap, -1, dtype=np.int64)
            padded[:len(sel)] = sel
            pieces.append(gather(b, torch.from_numpy(padded).to(b.device),
                                 len(sel), cap))
        # finish-sort the bounded slice in-core (the pieces interleave)
        return sort_batch(concat_batches(pieces), self.order, self.ctx)

    def close(self) -> None:
        for r in self.runs:
            r.close()
        self.runs = []
        self.run_keys = []
