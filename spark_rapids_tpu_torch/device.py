"""Device resolution for the PyTorch/CUDA port.

Every entry point runs on ``cuda`` unless the caller passes ``device="cpu"``.
With no device given and no CUDA device present, resolution raises: the port
never continues silently on the host. On a CPU tensor each kernel wrapper
runs its plain PyTorch version; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` or ``"cuda"`` → the current CUDA device (raises without one);
    ``"cpu"`` → the host."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "spark_rapids_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev
