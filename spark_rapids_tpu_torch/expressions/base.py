"""Expression-layer core: evaluation contract, binding helpers, nulls.

Port of ``spark_rapids_tpu/expressions/base.py``. Each expression implements
``eval_device(batch, ctx) -> TorchColumnVector | TorchScalar`` on the
batch's device (the reference's ``eval_tpu``). Evaluation is eager torch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..columnar.vector import TorchColumnVector, TorchScalar, row_mask
from ..config import RapidsConf
from ..types import (BooleanT, DataType, DoubleT, IntegerT, LongT, NullT,
                     StringT)


class EvalContext:
    """Per-task evaluation context: conf snapshot + ANSI flag."""

    def __init__(self, conf: Optional[RapidsConf] = None,
                 partition_id: int = 0):
        self.conf = conf or RapidsConf()
        self.ansi = self.conf.ansi_enabled
        self.partition_id = partition_id


_DEFAULT_CTX = EvalContext()


class Expression:
    """Base logical expression; doubles as the evaluable node."""

    children: Tuple["Expression", ...] = ()

    @property
    def dtype(self) -> DataType:
        raise NotImplementedError(type(self).__name__)

    @property
    def nullable(self) -> bool:
        return True

    def with_children(self, children: Sequence["Expression"]) -> "Expression":
        import copy
        new = copy.copy(self)
        new.children = tuple(children)
        return new

    def eval_device(self, batch, ctx: EvalContext = _DEFAULT_CTX):
        raise NotImplementedError(
            f"{type(self).__name__} is not yet ported")

    def pretty(self) -> str:
        name = type(self).__name__
        if self.children:
            return f"{name}({', '.join(c.pretty() for c in self.children)})"
        return name

    def transform(self, fn: Callable[["Expression"], Optional["Expression"]]
                  ) -> "Expression":
        """Bottom-up transform (Catalyst transformUp)."""
        new_children = [c.transform(fn) for c in self.children]
        node = self if all(a is b for a, b in zip(new_children, self.children)) \
            else self.with_children(new_children)
        replaced = fn(node)
        return replaced if replaced is not None else node

    def collect(self, pred: Callable[["Expression"], bool]) -> List["Expression"]:
        out = [self] if pred(self) else []
        for c in self.children:
            out.extend(c.collect(pred))
        return out


@dataclass(init=False)
class Literal(Expression):
    value: Any
    _dtype: DataType

    def __init__(self, value: Any, dtype: Optional[DataType] = None):
        self.children = ()
        self.value = value
        self._dtype = dtype if dtype is not None else infer_literal_type(value)

    @property
    def dtype(self) -> DataType:
        return self._dtype

    @property
    def nullable(self) -> bool:
        return self.value is None

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        return TorchScalar(self._dtype, self.value)

    def pretty(self) -> str:
        return repr(self.value)


def infer_literal_type(value: Any) -> DataType:
    if value is None:
        return NullT
    if isinstance(value, (bool, np.bool_)):
        return BooleanT
    if isinstance(value, (int, np.integer)):
        return IntegerT if -(2**31) <= int(value) < 2**31 else LongT
    if isinstance(value, (float, np.floating)):
        return DoubleT
    if isinstance(value, str):
        return StringT
    raise NotImplementedError(f"literal {value!r} not yet ported")


@dataclass(init=False)
class UnresolvedAttribute(Expression):
    name: str

    def __init__(self, name: str):
        self.children = ()
        self.name = name

    @property
    def dtype(self) -> DataType:
        raise ValueError(f"unresolved attribute {self.name}")

    def pretty(self) -> str:
        return f"'{self.name}"


_NEXT_EXPR_ID = [0]


def _new_expr_id() -> int:
    _NEXT_EXPR_ID[0] += 1
    return _NEXT_EXPR_ID[0]


@dataclass(init=False)
class AttributeReference(Expression):
    """Resolved column reference: a unique expr_id and, once bound, the
    ordinal of its slot in the input batch."""
    name: str
    _dtype: DataType
    _nullable: bool
    ordinal: int
    expr_id: int

    def __init__(self, name: str, dtype: DataType, nullable: bool = True,
                 ordinal: int = -1, expr_id: Optional[int] = None):
        self.children = ()
        self.name = name
        self._dtype = dtype
        self._nullable = nullable
        self.ordinal = ordinal
        self.expr_id = expr_id if expr_id is not None else _new_expr_id()

    @property
    def dtype(self) -> DataType:
        return self._dtype

    @property
    def nullable(self) -> bool:
        return self._nullable

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        return batch.column(self.ordinal)

    def pretty(self) -> str:
        return self.name


@dataclass(init=False)
class Alias(Expression):
    name: str

    def __init__(self, child: Expression, name: str):
        self.children = (child,)
        self.name = name

    @property
    def child(self) -> Expression:
        return self.children[0]

    @property
    def dtype(self) -> DataType:
        return self.child.dtype

    @property
    def nullable(self) -> bool:
        return self.child.nullable

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        return self.child.eval_device(batch, ctx)

    def pretty(self) -> str:
        return f"{self.child.pretty()} AS {self.name}"


def output_name(expr: Expression, default: Optional[str] = None) -> str:
    if isinstance(expr, (Alias, AttributeReference, UnresolvedAttribute)):
        return expr.name
    return default if default is not None else expr.pretty()


# ---------------------------------------------------------------------------
# device-eval helpers: broadcasting + null propagation
# ---------------------------------------------------------------------------

ColOrScalar = Union[TorchColumnVector, TorchScalar]


def device_parts(x: ColOrScalar, capacity: int, device):
    """(data, validity_or_None) with data broadcastable to (capacity,).
    Fixed-width only."""
    if isinstance(x, TorchScalar):
        carrier = x.dtype.torch_dtype or torch.bool
        if x.value is None:
            return (torch.zeros((), dtype=carrier, device=device),
                    torch.zeros(capacity, dtype=torch.bool, device=device))
        return torch.tensor(x.value, dtype=carrier, device=device), None
    return x.data, x.validity


def combine_validity(*vs) -> Optional[torch.Tensor]:
    acc = None
    for v in vs:
        if v is None:
            continue
        acc = v if acc is None else (acc & v)
    return acc


def make_column(dtype: DataType, data: torch.Tensor, validity,
                num_rows: int) -> TorchColumnVector:
    """Column with null slots zeroed, so no consumer sees garbage."""
    if validity is not None:
        data = torch.where(validity, data, torch.zeros((), dtype=data.dtype,
                                                       device=data.device))
    return TorchColumnVector(dtype, data, validity, num_rows)


def to_column(x: ColOrScalar, batch, dtype: Optional[DataType] = None
              ) -> TorchColumnVector:
    """Materialize a scalar result as a full column."""
    if isinstance(x, TorchColumnVector):
        return x
    return TorchColumnVector.from_scalar(x.value, dtype or x.dtype,
                                         batch.num_rows, batch.capacity,
                                         batch.device)


class BinaryExpression(Expression):
    """Binary op with standard null propagation (null if either side is)."""

    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    @property
    def left(self) -> Expression:
        return self.children[0]

    @property
    def right(self) -> Expression:
        return self.children[1]

    @property
    def nullable(self) -> bool:
        return self.left.nullable or self.right.nullable

    def _compute(self, ldata, rdata, ctx: EvalContext, valid):
        raise NotImplementedError

    def _fold(self, l, r, ctx: EvalContext):
        """Both sides scalar: evaluate on a one-row host batch."""
        from ..columnar.batch import TorchColumnarBatch
        one = TorchColumnarBatch([], 1)
        cols = [TorchColumnVector.from_scalar(s.value, s.dtype, 1)
                for s in (l, r)]
        data, valid = self._eval_parts(cols[0], cols[1], one, ctx)
        ok = valid is None or bool(valid[0])
        return TorchScalar(self.dtype, data[0].item() if ok else None)

    def _eval_parts(self, l, r, batch, ctx):
        cap, dev = batch.capacity, batch.device
        ld, lv = device_parts(l, cap, dev)
        rd, rv = device_parts(r, cap, dev)
        valid = combine_validity(lv, rv, row_mask(batch.num_rows, cap, dev))
        return self._compute(ld, rd, ctx, valid), valid

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        l = self.left.eval_device(batch, ctx)
        r = self.right.eval_device(batch, ctx)
        if isinstance(l, TorchScalar) and isinstance(r, TorchScalar):
            return self._fold(l, r, ctx)
        data, valid = self._eval_parts(l, r, batch, ctx)
        return make_column(self.dtype, data, valid, batch.num_rows)


class UnaryExpression(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def child(self) -> Expression:
        return self.children[0]

    @property
    def nullable(self) -> bool:
        return self.child.nullable

    @property
    def dtype(self) -> DataType:
        return self.child.dtype
