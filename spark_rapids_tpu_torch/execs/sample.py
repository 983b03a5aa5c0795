"""Sample execs: Bernoulli and Poisson row sampling (port of
``spark_rapids_tpu/execs/sample.py``; reference GpuSampleExec,
basicPhysicalOperators.scala:873, and GpuFastSampleExec, :948).

Each row draws a uniform from a counter-based hash, a murmur3-style 32-bit
finalizer over ``(seed, partition, row index in the partition)``, so the
device, the host engine and the reference keep the same rows for a seed.
Without replacement a row stays when its uniform is below the fraction;
with replacement it repeats Poisson(fraction) times, the count read off
the inverse CDF at the same uniform.

The device computes the hash in int64 lanes with every product split in
16-bit halves and masked to 32 bits, since not every backend multiplies
``uint32``; the host engine computes it in numpy ``uint32``, as the
reference does. Both give the reference's bits.
"""

from __future__ import annotations

import math
from typing import Iterator, List

import numpy as np
import torch

from ..columnar.batch import TorchColumnarBatch, compact, gather
from .base import (MODERATE, CpuExec, PhysicalPlan, TaskContext, TorchExec,
                   counts_output, op_time)

_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B1
_MASK32 = 0xFFFFFFFF


def _key(seed: int, part: int) -> int:
    """The 32-bit word a partition's row indices are xor-ed with."""
    return (((seed & _MASK32) * _GOLDEN) & _MASK32) \
        ^ ((part * _C1) & _MASK32)


def _mix_np(h: np.ndarray) -> np.ndarray:
    h = h.astype(np.uint32)
    h ^= h >> np.uint32(16)
    h *= np.uint32(_C1)
    h ^= h >> np.uint32(13)
    h *= np.uint32(_C2)
    h ^= h >> np.uint32(16)
    return h


def uniform_np(seed: int, part: int, start: int, n: int) -> np.ndarray:
    """The uniforms of rows [start, start + n) of a partition (host)."""
    idx = np.arange(start, start + n, dtype=np.int64).astype(np.uint32)
    return _mix_np(idx ^ np.uint32(_key(seed, part))).astype(np.float64) \
        / float(1 << 32)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for h in [0, 2^32), exact in int64 lanes."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def uniform_torch(seed: int, part: int, start: int, n: int,
                  device) -> torch.Tensor:
    """The same uniforms as ``uniform_np``, computed on ``device``."""
    h = (torch.arange(n, dtype=torch.int64, device=device) + start) \
        & _MASK32
    h = h ^ _key(seed, part)
    h = h ^ (h >> 16)
    h = _mul32(h, _C1)
    h = h ^ (h >> 13)
    h = _mul32(h, _C2)
    h = h ^ (h >> 16)
    return h.to(torch.float64) / float(1 << 32)


def poisson_thresholds(lam: float) -> List[float]:
    """Cumulative P(X <= k); a row's count is the number of thresholds at
    or below its uniform. The tail runs far enough past the mean that the
    clamp's bias is negligible."""
    max_k = max(16, int(lam + 10.0 * math.sqrt(lam) + 10.0))
    p = math.exp(-lam)
    cum = p
    out = [cum]
    for k in range(1, max_k + 1):
        p *= lam / k
        cum += p
        out.append(cum)
        if cum > 1.0 - 1e-12:
            break
    return out


class _SampleBase:
    def _init_sample(self, fraction: float, with_replacement: bool,
                     seed: int) -> None:
        self.fraction = fraction
        self.with_replacement = with_replacement
        self.seed = seed

    @property
    def output(self):
        return self.children[0].output


class CpuSampleExec(_SampleBase, CpuExec):
    """Sampling in the host engine (numpy uniforms, an Arrow filter or
    take)."""

    def __init__(self, fraction: float, with_replacement: bool, seed: int,
                 child: PhysicalPlan):
        CpuExec.__init__(self, [child])
        self._init_sample(fraction, with_replacement, seed)

    def node_desc(self) -> str:
        return f"CpuSample[{self.fraction}]"

    @counts_output
    def execute_partition(self, idx: int, ctx: TaskContext) -> Iterator:
        import pyarrow as pa
        from .cpu import table_batch
        start = 0
        for b in self.children[0].execute_partition(idx, ctx):
            t = b.to_arrow()
            with op_time(ctx, self):
                u = uniform_np(self.seed, idx, start, t.num_rows)
                start += t.num_rows
                if self.with_replacement:
                    counts = np.searchsorted(
                        np.array(poisson_thresholds(self.fraction)), u,
                        side="right")
                    t = t.take(pa.array(np.repeat(np.arange(t.num_rows),
                                                  counts)))
                else:
                    t = t.filter(pa.array(u < self.fraction))
                out = table_batch(t, self.output) if t.num_rows else None
            if out is not None:
                yield out


class TorchSampleExec(_SampleBase, TorchExec):
    """Sampling on the device: the uniforms, the keep mask or the repeat
    counts and the gather all on the card; the kept row count is the one
    host read a batch (with replacement, with the repeated rows' bytes)."""

    def __init__(self, fraction: float, with_replacement: bool, seed: int,
                 child: PhysicalPlan):
        TorchExec.__init__(self, [child])
        self._init_sample(fraction, with_replacement, seed)

    def node_desc(self) -> str:
        r = ", replace" if self.with_replacement else ""
        return f"TorchSample[{self.fraction}{r}]"

    def additional_metrics(self):
        return {"sampleTime": MODERATE}

    def internal_do_execute_columnar(self, idx: int,
                                     ctx: TaskContext) -> Iterator:
        start = 0
        for b in self.children[0].execute_partition(idx, ctx):
            n = b.num_rows
            with self.metrics["sampleTime"].timed():
                u = uniform_torch(self.seed, idx, start, b.capacity,
                                  b.device)
                start += n
                out = self._repeat(b, u) if self.with_replacement \
                    else compact(b, u < self.fraction)
            if out.num_rows:
                yield out

    def _repeat(self, b: TorchColumnarBatch,
                u: torch.Tensor) -> TorchColumnarBatch:
        from ..columnar.vector import audited_tolist, bucket_capacity
        n, dev = b.num_rows, b.device
        th = torch.tensor(poisson_thresholds(self.fraction),
                          dtype=torch.float64, device=dev)
        counts = torch.searchsorted(th, u[:n], right=True)
        # the output's rows and, where strings repeat, their bytes: one
        # host read
        sizes = [counts.sum()]
        for c in b.columns:
            if c.offsets is not None:
                lens = (c.offsets[1:n + 1] - c.offsets[:n]).to(torch.int64)
                sizes.append((lens * counts).sum())
        sizes = audited_tolist(torch.stack(sizes), "rows")
        rows = sizes[0]
        idx = torch.repeat_interleave(
            torch.arange(n, dtype=torch.int64, device=dev), counts,
            output_size=rows)
        return gather(b, idx, rows, bucket_capacity(rows),
                      byte_capacity=max(sizes[1:], default=None))
