"""Task-context and nondeterministic expressions (port of
``spark_rapids_tpu/expressions/misc.py``): ``spark_partition_id()``,
``monotonically_increasing_id()``, ``rand(seed)``, ``input_file_name()``
and the input file's block start and length.

They read the task's ``EvalContext``: its partition id, the file the
scan's current batch came from (``''`` and -1 outside a file scan), and
running row offsets keyed by expression, so a partition's row index runs
on across its batches.

``rand(seed)`` reproduces the reference's bits: JAX's threefry-2x32 with
``jax_threefry_partitionable`` and 64-bit keys, the key
``fold_in(fold_in(PRNGKey(seed), partition), row)`` and a float64
``uniform`` from its 64 random bits. Threefry is a fixed arithmetic
recipe (20 rounds of add, rotate and xor over uint32 pairs); here it runs
in int64 lanes masked to 32 bits, on the card or on CPU tensors alike.
Spark's own ``rand`` is XORShiftRandom, whose sequence neither package
reproduces (ROADMAP C-ref).
"""

from __future__ import annotations

import torch

from ..columnar.vector import TorchColumnVector, row_mask
from ..types import DataType, DoubleT, IntegerT, LongT, StringT
from .base import (_DEFAULT_CTX, Expression, Literal,
                   eval_cpu_on_host_tensors, make_column)

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor):
    """JAX's threefry2x32 hash of the counter pair (x0, x1) under the key
    (k0, k1): uint32 values in int64 lanes (keys ints or tensors)."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _fold_in(k0, k1, data: torch.Tensor):
    """``jax.random.fold_in(key, data)``: threefry of (0, data)."""
    return threefry2x32(k0, k1, torch.zeros_like(data), data & _M32)


def rand_values(seed: int, partition: int, rows: torch.Tensor
                ) -> torch.Tensor:
    """The reference's ``rand(seed)`` of row indices ``rows`` (int64) in
    ``partition``: uniform float64 in [0, 1)."""
    s = int(seed) & ((1 << 64) - 1)
    one = torch.ones((), dtype=torch.int64, device=rows.device)
    # PRNGKey(seed) is (seed >> 32, seed & 0xffffffff); fold in the
    # partition on a one-element tensor (the key is the same for all rows)
    pk0, pk1 = _fold_in(one * (s >> 32), one * (s & _M32),
                        one * (int(partition) & _M32))
    k0, k1 = _fold_in(pk0, pk1, rows.to(torch.int64))
    zeros = torch.zeros_like(k0)
    b0, b1 = threefry2x32(k0, k1, zeros, zeros)
    # 64 random bits (b0 high) → the top 52 as the mantissa of [1, 2)
    mant = ((b0 << 20) | (b1 >> 12)) & ((1 << 52) - 1)
    return (mant | 0x3FF0000000000000).view(torch.float64) - 1.0


def _rows_only(data: torch.Tensor, batch) -> torch.Tensor:
    """``data`` with the padding rows zeroed (no validity: never null)."""
    keep = row_mask(batch.num_rows, batch.capacity, batch.device)
    return torch.where(keep, data, torch.zeros((), dtype=data.dtype,
                                               device=data.device))


class _Leaf(Expression):
    children = ()

    @property
    def nullable(self) -> bool:
        return False

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return eval_cpu_on_host_tensors(self, table, ctx)


class SparkPartitionID(_Leaf):
    """spark_partition_id(): the task's partition index."""

    @property
    def dtype(self) -> DataType:
        return IntegerT

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        cap, dev = batch.capacity, batch.device
        data = torch.full((cap,), ctx.partition_id, dtype=torch.int32,
                          device=dev)
        return make_column(IntegerT, _rows_only(data, batch), None,
                           batch.num_rows)

    def pretty(self) -> str:
        return "spark_partition_id()"


class MonotonicallyIncreasingID(_Leaf):
    """monotonically_increasing_id(): (partition << 33) + the row's index
    in its partition, counted across batches."""

    @property
    def dtype(self) -> DataType:
        return LongT

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        cap, dev = batch.capacity, batch.device
        base = (ctx.partition_id << 33) + ctx.next_rows(self, batch.num_rows)
        data = base + torch.arange(cap, dtype=torch.int64, device=dev)
        return make_column(LongT, _rows_only(data, batch), None,
                           batch.num_rows)

    def pretty(self) -> str:
        return "monotonically_increasing_id()"


class Rand(_Leaf):
    """rand(seed): uniform [0, 1) doubles, fixed by (seed, partition,
    row index in the partition) whatever the batch boundaries."""

    def __init__(self, seed: Expression = None):
        self.children = (seed if seed is not None else Literal(0),)

    @property
    def dtype(self) -> DataType:
        return DoubleT

    def _seed(self) -> int:
        s = self.children[0]
        return int(s.value) if isinstance(s, Literal) and s.value is not None \
            else 0

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        cap, dev = batch.capacity, batch.device
        off = ctx.next_rows(self, batch.num_rows)
        rows = off + torch.arange(cap, dtype=torch.int64, device=dev)
        return make_column(DoubleT, _rows_only(
            rand_values(self._seed(), ctx.partition_id, rows), batch), None,
            batch.num_rows)

    def pretty(self) -> str:
        return f"rand({self.children[0].pretty()})"


class InputFileName(_Leaf):
    """input_file_name(): the scan's current file, ``''`` outside a file
    scan."""

    @property
    def dtype(self) -> DataType:
        return StringT

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        return TorchColumnVector.from_scalar(ctx.input_file or "", StringT,
                                             batch.num_rows, batch.capacity,
                                             batch.device)

    def pretty(self) -> str:
        return "input_file_name()"


class _InputFileLong(_Leaf):
    _field = "input_block_start"

    @property
    def dtype(self) -> DataType:
        return LongT

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        data = torch.full((batch.capacity,), getattr(ctx, self._field),
                          dtype=torch.int64, device=batch.device)
        return make_column(LongT, _rows_only(data, batch), None,
                           batch.num_rows)


class InputFileBlockStart(_InputFileLong):
    """input_file_block_start(): 0 in a file scan, -1 outside one."""
    _field = "input_block_start"

    def pretty(self) -> str:
        return "input_file_block_start()"


class InputFileBlockLength(_InputFileLong):
    """input_file_block_length(): the file's size in a file scan, -1
    outside one."""
    _field = "input_block_length"

    def pretty(self) -> str:
        return "input_file_block_length()"
