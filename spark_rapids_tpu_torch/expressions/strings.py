"""String comparisons on the device (port of ``string_compare``,
``spark_rapids_tpu/expressions/strings.py``).

The reference compares strings on the host through pyarrow. Here both
sides stay as offsets + bytes on the device: a column, or a literal whose
bytes every row shares. The comparison walks byte position k = 0, 1, ...
over the common prefix of each row's two strings, all rows at once, and
keeps the sign of the first differing byte; rows whose prefixes agree
order by length. That is UTF-8 byte order, which is Spark's (and Arrow's)
string order. The walk is as long as the shorter side's longest string:
a literal's length, or one host read of the two columns' longest strings.
"""

from __future__ import annotations

import torch

from ..columnar.vector import TorchColumnVector, TorchScalar, row_mask
from ..types import BooleanT
from .base import combine_validity, make_column


def _side(x, capacity: int, device):
    """(bytes, start int64 [cap], length int64 [cap], validity or None) of a
    string column or a string literal broadcast over the rows."""
    if isinstance(x, TorchScalar):
        raw = b"" if x.value is None else x.value.encode()
        data = torch.tensor(list(raw) or [0], dtype=torch.uint8,
                            device=device)
        start = torch.zeros(capacity, dtype=torch.int64, device=device)
        length = torch.full((capacity,), len(raw), dtype=torch.int64,
                            device=device)
        valid = None if x.value is not None else \
            torch.zeros(capacity, dtype=torch.bool, device=device)
        return data, start, length, valid
    offs = x.offsets.to(torch.int64)
    data = x.data if x.data.numel() else \
        torch.zeros(1, dtype=torch.uint8, device=device)
    return data, offs[:-1], offs[1:] - offs[:-1], x.validity


def compare_strings(l, r, capacity: int, device) -> tuple:
    """Per-row three-way comparison of two string sides (columns or
    literals): (int8 sign in {-1, 0, 1}, validity or None)."""
    ld, ls, ll, lv = _side(l, capacity, device)
    rd, rs, rl, rv = _side(r, capacity, device)
    # the walk's length: the shorter side's longest string (one host read
    # for the column sides; a literal's length is known)
    longest = [ln.max() if isinstance(x, TorchColumnVector) else ln[0]
               for x, ln in ((l, ll), (r, rl))]
    steps = min(torch.stack(longest).tolist()) if capacity else 0
    common = torch.minimum(ll, rl)
    sign = torch.zeros(capacity, dtype=torch.int8, device=device)
    open_ = torch.ones(capacity, dtype=torch.bool, device=device)
    l_last, r_last = ld.numel() - 1, rd.numel() - 1
    for k in range(steps):
        at = open_ & (k < common)
        lb = ld[(ls + k).clamp(max=l_last)].to(torch.int16)
        rb = rd[(rs + k).clamp(max=r_last)].to(torch.int16)
        diff = at & (lb != rb)
        sign = torch.where(diff, torch.where(lb < rb, -1, 1).to(torch.int8),
                           sign)
        open_ = open_ & ~diff
    by_len = torch.sign(ll - rl).to(torch.int8)
    sign = torch.where(open_, by_len, sign)
    return sign, combine_validity(lv, rv)


def string_compare(cmp_expr, l, r, batch) -> TorchColumnVector:
    """``cmp_expr`` (an EqualTo/LessThan/... node) over string operands,
    with Spark's nulls: null when either side is null."""
    cap, dev = batch.capacity, batch.device
    sign, valid = compare_strings(l, r, cap, dev)
    valid = combine_validity(valid, row_mask(batch.num_rows, cap, dev))
    return make_column(BooleanT, cmp_expr._sign_cmp(sign), valid,
                       batch.num_rows)
