"""TPC-H Q1 pipeline step on torch tensors: the plain PyTorch counterpart of
``spark_rapids_tpu/kernels/q1.py``.

Filter (shipdate <= cutoff) + projection + grouped partial aggregation over
the (returnflag, linestatus) domain of 16 groups. ``q1_partial`` is the
one-hot [n,16] x [n,6] contraction in f32, exactly as the reference; the
hand-written Hopper kernels that replace it live in ``kernels/q1_cuda.py``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

N_FLAGS = 4
N_STATUS = 4
N_GROUPS = N_FLAGS * N_STATUS

#: Q1's measure columns, in ``Q1State`` order (count last)
MEASURES = ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge",
            "sum_disc", "count")


class Q1Inputs(NamedTuple):
    """One columnar batch of lineitem (dictionary-encoded keys)."""
    returnflag: torch.Tensor     # int32 codes [0, N_FLAGS)
    linestatus: torch.Tensor     # int32 codes [0, N_STATUS)
    quantity: torch.Tensor       # float32
    extendedprice: torch.Tensor  # float32
    discount: torch.Tensor       # float32
    tax: torch.Tensor            # float32
    shipdate: torch.Tensor       # int32 days since epoch
    valid: torch.Tensor          # bool row mask (padding/validity)


class Q1State(NamedTuple):
    """Per-group partial aggregate state."""
    sum_qty: torch.Tensor
    sum_base_price: torch.Tensor
    sum_disc_price: torch.Tensor
    sum_charge: torch.Tensor
    sum_disc: torch.Tensor
    count: torch.Tensor


def q1_group_and_measures(batch: Q1Inputs, cutoff_days
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(group int32 [n], measures f32 [n, 6]) with the filter folded into
    the weight ``w``: the shared front half of every Q1 partial."""
    keep = batch.valid & (batch.shipdate <= int(cutoff_days))
    group = (batch.returnflag * N_STATUS + batch.linestatus).to(torch.int32)
    w = keep.to(torch.float32)
    qty = batch.quantity * w
    price = batch.extendedprice * w
    disc_price = batch.extendedprice * (1.0 - batch.discount) * w
    charge = disc_price * (1.0 + batch.tax)
    disc = batch.discount * w
    return group, torch.stack([qty, price, disc_price, charge, disc, w], dim=1)


def state_from_sums(sums: torch.Tensor) -> Q1State:
    """[16, >=6] f32 group sums → Q1State (count cast to int32 as the
    reference does after carrying it in f32)."""
    return Q1State(sum_qty=sums[:, 0], sum_base_price=sums[:, 1],
                   sum_disc_price=sums[:, 2], sum_charge=sums[:, 3],
                   sum_disc=sums[:, 4], count=sums[:, 5].to(torch.int32))


def q1_partial(batch: Q1Inputs, cutoff_days) -> Q1State:
    """Filter + project + grouped partial aggregation as one f32 one-hot
    contraction (the reference's einsum). Out-of-domain group codes match
    no group, as ``jax.nn.one_hot`` gives them a zero row."""
    group, measures = q1_group_and_measures(batch, cutoff_days)
    gidx = torch.arange(N_GROUPS, dtype=torch.int32, device=group.device)
    onehot = (group[:, None] == gidx[None, :]).to(torch.float32)
    return state_from_sums(onehot.T @ measures)


def q1_final(state: Q1State) -> Dict[str, torch.Tensor]:
    """Final projection: averages from sums/counts."""
    n = torch.clamp(state.count, min=1).to(torch.float32)
    return {
        "sum_qty": state.sum_qty,
        "sum_base_price": state.sum_base_price,
        "sum_disc_price": state.sum_disc_price,
        "sum_charge": state.sum_charge,
        "avg_qty": state.sum_qty / n,
        "avg_price": state.sum_base_price / n,
        "avg_disc": state.sum_disc / n,
        "count_order": state.count,
    }


def q1_step(batch: Q1Inputs, cutoff_days) -> Dict[str, torch.Tensor]:
    """Single-device forward step of the whole query (plain PyTorch)."""
    return q1_final(q1_partial(batch, cutoff_days))


def make_example_batch(n: int = 1 << 16, seed: int = 0,
                       device: DeviceLike = None) -> Tuple[Q1Inputs, np.int32]:
    """The reference's example batch, byte for byte: the same numpy RNG
    calls in the same order, then one copy to ``device``."""
    rng = np.random.default_rng(seed)
    arrays = dict(
        returnflag=rng.integers(0, 3, n, dtype=np.int32),
        linestatus=rng.integers(0, 2, n, dtype=np.int32),
        quantity=rng.integers(1, 51, n).astype(np.float32),
        extendedprice=(rng.random(n) * 1e5).astype(np.float32),
        discount=(rng.random(n) * 0.1).astype(np.float32),
        tax=(rng.random(n) * 0.08).astype(np.float32),
        shipdate=rng.integers(8000, 11000, n, dtype=np.int32),
        valid=np.ones((n,), np.bool_),
    )
    return q1_inputs_from_numpy(arrays, device), np.int32(10471)


_INPUT_DTYPES = dict(returnflag=torch.int32, linestatus=torch.int32,
                     quantity=torch.float32, extendedprice=torch.float32,
                     discount=torch.float32, tax=torch.float32,
                     shipdate=torch.int32, valid=torch.bool)


def q1_inputs_from_numpy(arrays: Dict[str, np.ndarray],
                         device: DeviceLike = None) -> Q1Inputs:
    """Field name → numpy array (e.g. a reference ``Q1Inputs._asdict()``
    passed through numpy) → the port's ``Q1Inputs`` on ``device``. The copy
    makes read-only views (numpy views of jax arrays) safe for torch."""
    dev = resolve_device(device)
    return Q1Inputs(**{
        k: torch.from_numpy(np.array(arrays[k], copy=True)).to(
            device=dev, dtype=dt)
        for k, dt in _INPUT_DTYPES.items()})


def q1_reference_numpy(batch: Q1Inputs, cutoff: int) -> Dict[str, np.ndarray]:
    """Pure-numpy oracle (float64 sums, integer counts)."""
    # the oracle's own copy of its inputs, off the engine's path: no gate
    b = {k: v.detach().cpu().numpy() for k, v in batch._asdict().items()}
    keep = b["valid"] & (b["shipdate"] <= cutoff)
    group = b["returnflag"] * N_STATUS + b["linestatus"]
    out = {}
    disc_price = b["extendedprice"] * (1 - b["discount"])
    charge = disc_price * (1 + b["tax"])
    sums = {"sum_qty": b["quantity"], "sum_base_price": b["extendedprice"],
            "sum_disc_price": disc_price, "sum_charge": charge}
    for name, col in sums.items():
        out[name] = np.bincount(group[keep], weights=col[keep],
                                minlength=N_GROUPS).astype(np.float64)
    out["count_order"] = np.bincount(group[keep], minlength=N_GROUPS)
    return out
