"""Hopper kernels for the Q1 partial aggregation: the counterpart of
``spark_rapids_tpu/kernels/q1_pallas.py``.

Two kernels in ``csrc/q1_agg.cu``, each beside its plain PyTorch version and
a launch counter:

* ``q1_agg_simt`` replaces ``_q1_kernel`` (masked VPU reductions): per-thread
  register accumulators, then a fixed-order partials pass.
* ``q1_agg_mma`` replaces ``_q1_kernel_mxu`` (one-hot MXU matmul): TF32
  ``mma.sync`` with the measures split hi/lo to keep f32 accuracy.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. There is no probe and no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict

import torch

from ..device import DeviceLike, resolve_device
from . import build
from .q1 import (N_GROUPS, Q1Inputs, Q1State, _INPUT_DTYPES, q1_final,
                 q1_group_and_measures, q1_step, state_from_sums)

SOURCE = "q1_agg"
_THREADS = 256
_BLOCKS_PER_SM = 4
#: measure columns each kernel accumulates (mma pads to 8 with w, as the
#: TPU kernel pads its measure stack)
WIDTH = {"q1_agg_simt": 6, "q1_agg_mma": 8}

#: launches of each kernel, counted by its wrapper where it launches
launches: Dict[str, int] = {name: 0 for name in WIDTH}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int32, ctypes.c_longlong,
                                     ctypes.c_void_p, ctypes.c_int32,
                                     ctypes.c_void_p, ctypes.c_void_p]


def _kernel_fn(name: str):
    fn = getattr(build.load(SOURCE), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(batch: Q1Inputs) -> int:
    n = batch.quantity.shape[0]
    dev = batch.quantity.device
    for field, t in batch._asdict().items():
        if t.dtype != _INPUT_DTYPES[field]:
            raise TypeError(f"{field}: expected {_INPUT_DTYPES[field]}, "
                            f"got {t.dtype}")
        if t.device != dev or t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"{field}: every column must be 1-D of {n} rows "
                             f"on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{field} must be contiguous")
    return n


def _launch(name: str, batch: Q1Inputs, cutoff) -> torch.Tensor:
    n = _check(batch)
    cutoff = int(cutoff)
    if not -(2 ** 31) <= cutoff < 2 ** 31:
        raise ValueError(f"cutoff {cutoff} does not fit int32")
    dev = batch.quantity.device
    width = WIDTH[name]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = max(1, min(-(-n // _THREADS), sms * _BLOCKS_PER_SM))
    partials = torch.empty((blocks, N_GROUPS * width), dtype=torch.float32,
                           device=dev)
    out = torch.empty((N_GROUPS, width), dtype=torch.float32, device=dev)
    fn = _kernel_fn(name)
    b = batch
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(b.returnflag.data_ptr(), b.linestatus.data_ptr(),
                b.quantity.data_ptr(), b.extendedprice.data_ptr(),
                b.discount.data_ptr(), b.tax.data_ptr(),
                b.shipdate.data_ptr(), b.valid.data_ptr(), cutoff, n,
                partials.data_ptr(), blocks, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")
    launches[name] += 1
    return out


def q1_agg_simt_plain(batch: Q1Inputs, cutoff) -> torch.Tensor:
    """Plain version of ``q1_agg_simt``: one masked sum per group."""
    group, meas = q1_group_and_measures(batch, cutoff)
    return torch.stack([torch.where((group == g)[:, None], meas, 0.0).sum(0)
                        for g in range(N_GROUPS)])


def q1_agg_mma_plain(batch: Q1Inputs, cutoff) -> torch.Tensor:
    """Plain version of ``q1_agg_mma``: one-hot [n,16] @ measures [n,8] in
    full f32 (TF32 matmul switched off for the product)."""
    group, meas = q1_group_and_measures(batch, cutoff)
    meas = torch.cat([meas, meas[:, 5:6], meas[:, 5:6]], dim=1)
    gidx = torch.arange(N_GROUPS, dtype=torch.int32, device=group.device)
    onehot = (group[:, None] == gidx[None, :]).to(torch.float32)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return onehot.T @ meas
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def q1_agg_simt(batch: Q1Inputs, cutoff) -> torch.Tensor:
    """[16, 6] f32 group sums (count in column 5)."""
    if batch.quantity.device.type == "cpu":
        return q1_agg_simt_plain(batch, cutoff)
    return _launch("q1_agg_simt", batch, cutoff)


def q1_agg_mma(batch: Q1Inputs, cutoff) -> torch.Tensor:
    """[16, 8] f32 group sums (count in columns 5-7)."""
    if batch.quantity.device.type == "cpu":
        return q1_agg_mma_plain(batch, cutoff)
    return _launch("q1_agg_mma", batch, cutoff)


def q1_partial_simt(batch: Q1Inputs, cutoff) -> Q1State:
    return state_from_sums(q1_agg_simt(batch, cutoff))


def q1_partial_mma(batch: Q1Inputs, cutoff) -> Q1State:
    return state_from_sums(q1_agg_mma(batch, cutoff))


def q1_step_simt(batch: Q1Inputs, cutoff):
    return q1_final(q1_partial_simt(batch, cutoff))


def q1_step_mma(batch: Q1Inputs, cutoff):
    return q1_final(q1_partial_mma(batch, cutoff))


def q1_step_best(device: DeviceLike = None) -> Callable:
    """The Q1 step for ``device``: on CUDA the step built on ``q1_agg_simt``
    (the reference picks its VPU kernel here), on the CPU the plain step."""
    dev = resolve_device(device)
    return q1_step_simt if dev.type == "cuda" else q1_step
