"""Device manager: the device the budget accounts for, and the budget's
size.

Port of ``spark_rapids_tpu/memory/device.py`` (reference analogue:
GpuDeviceManager.initializeGpuAndMemory). The torch caching allocator owns
the physical memory, so the budget is logical accounting against
``allocFraction`` × the device's memory:

* on a CUDA device the total is the card's, ``torch.cuda.mem_get_info``,
  unless ``spark.rapids.memory.device.totalBytes`` states another;
* on the CPU (the port's test device) the total is what the caller states:
  that key, or ``initialize(total_bytes=...)``. With neither, the session
  raises: the host's memory is not a device's, and no figure is assumed.

The first session fixes the device and the budget for the process; a
session on another device raises. Nothing reads the budget before a
session (or a test) has initialized it.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

import torch

from ..config import DEVICE_TOTAL_BYTES, HBM_ALLOC_FRACTION, RapidsConf

log = logging.getLogger("spark_rapids_tpu_torch")


class TorchDeviceManager:
    _lock = threading.Lock()
    _initialized = False
    _device: Optional[torch.device] = None
    _total_bytes: int = 0
    _hbm_budget_bytes: int = 0

    @classmethod
    def initialize(cls, conf: Optional[RapidsConf] = None,
                   device: Optional[torch.device] = None,
                   total_bytes: Optional[int] = None) -> None:
        """Fix the device and the budget (once a process; the first session
        to start decides, as the reference's startup-only conf does)."""
        if device is None:
            raise TypeError("TorchDeviceManager.initialize needs the "
                            "session's device")
        device = torch.device(device)
        with cls._lock:
            if cls._initialized:
                if cls._device != device:
                    raise RuntimeError(
                        f"the process's memory budget is fixed for "
                        f"{cls._device}; a session on {device} cannot "
                        "share it")
                return
            conf = conf or RapidsConf()
            if total_bytes is None:
                total_bytes = conf.get(DEVICE_TOTAL_BYTES)
            if total_bytes is None:
                if device.type != "cuda":
                    raise ValueError(
                        f"a session on {device} has no device memory to "
                        f"read: set {DEVICE_TOTAL_BYTES.key}")
                total_bytes = torch.cuda.mem_get_info(device)[1]
            cls._device = device
            cls._total_bytes = int(total_bytes)
            cls._hbm_budget_bytes = int(cls._total_bytes
                                        * conf.get(HBM_ALLOC_FRACTION))
            cls._initialized = True
            log.info("TorchDeviceManager: device=%s total=%d budget=%d",
                     cls._device, cls._total_bytes, cls._hbm_budget_bytes)

    @classmethod
    def hbm_budget_bytes(cls) -> int:
        with cls._lock:
            if not cls._initialized:
                raise RuntimeError(
                    "the device budget is read before any session fixed "
                    "its device (TorchDeviceManager.initialize)")
            return cls._hbm_budget_bytes

    @classmethod
    def synchronize(cls) -> None:
        """Block until outstanding device work completes (reference
        Cuda.deviceSynchronize)."""
        dev = cls._device
        if dev is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)

    @classmethod
    def reset_for_tests(cls) -> None:
        with cls._lock:
            cls._initialized = False
            cls._device = None
