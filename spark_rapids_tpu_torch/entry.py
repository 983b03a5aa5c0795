"""Entry point of the port: the flagship compiled query step (TPC-H Q1)."""

from __future__ import annotations

from .device import DeviceLike


def entry(device: DeviceLike = "cuda"):
    """(fn, example_args): the Q1 forward step and its 2^16-row example
    batch on ``device`` (the counterpart of ``__graft_entry__.entry``)."""
    from .kernels.q1 import make_example_batch
    from .kernels.q1_cuda import q1_step_best

    batch, cutoff = make_example_batch(1 << 16, device=device)
    return q1_step_best(device), (batch, int(cutoff))
