"""Expression-layer core: evaluation contract, binding helpers, nulls.

Port of ``spark_rapids_tpu/expressions/base.py``. Each expression implements
two evaluations:

* ``eval_device(batch, ctx) -> TorchColumnVector | TorchScalar`` on the
  batch's device (the reference's ``eval_tpu``), eager torch;
* ``eval_cpu(table, ctx) -> pyarrow.Array | Python scalar`` over a
  ``pyarrow.Table`` (the reference's ``eval_cpu``): the host engine's
  evaluation, which the CPU operators (``execs/cpu.py`` and the other
  ``Cpu*`` execs) run where the override engine kept an operator off the
  card. A constant subtree gives a Python scalar (None for null).
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..columnar.vector import (TorchColumnVector, TorchScalar,
                               decimal_carrier, lane_mask, row_mask)
from ..config import RapidsConf
from ..types import (BooleanT, DataType, DateT, DecimalType, DoubleT,
                     IntegerT, LongT, NullT, StringT, TimestampT)


class EvalContext:
    """Per-task evaluation context: conf snapshot + ANSI flag and session
    time zone, the session's event counters (an expression that takes the
    host path counts it there as ``strings.hostPath``), and the task-scoped
    fields the nondeterministic expressions read: the partition id, the
    current input file and its block (set by the file scans; ``''`` and -1
    outside one), and running row offsets keyed by expression
    (``monotonically_increasing_id``, ``rand``)."""

    def __init__(self, conf: Optional[RapidsConf] = None,
                 partition_id: int = 0, counters: Optional[Counter] = None):
        from ..config import SESSION_TZ
        self.conf = conf or RapidsConf()
        self.ansi = self.conf.ansi_enabled
        self.tz = self.conf.get(SESSION_TZ) or "UTC"
        self.partition_id = partition_id
        self.counters = counters if counters is not None else Counter()
        self.input_file: Optional[str] = None
        self.input_block_start: int = -1
        self.input_block_length: int = -1
        self.row_counters: dict = {}

    def set_input_file(self, path: str, start: int = 0,
                       length: Optional[int] = None) -> None:
        """The file a scan's next batch comes from (reference
        ``InputFileUtils``): its block is the whole file."""
        import os
        self.input_file = path
        self.input_block_start = start
        if length is None:
            try:
                length = os.path.getsize(path)
            except OSError:
                length = -1
        self.input_block_length = length

    def next_rows(self, key, n: int) -> int:
        """The running row offset of ``key`` in this task, advanced by
        ``n``."""
        off = self.row_counters.get(key, 0)
        self.row_counters[key] = off + n
        return off


class ExpressionError(Exception):
    """A runtime error of an expression: ANSI mode's overflow and division
    by zero (reference ``ExpressionError``)."""


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

    def eval_cpu(self, table, ctx: EvalContext = _DEFAULT_CTX):
        raise NotImplementedError(
            f"host evaluation of {type(self).__name__} is not yet ported")

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
    """A constant. A ``datetime.date`` is a DateType day number; an aware
    ``datetime.datetime`` a TimestampType instant; a naive one a wall
    time in the session zone (``wall``, as a SQL ``TIMESTAMP '…'``
    literal), turned into its instant when evaluated."""
    value: Any
    _dtype: DataType
    wall: bool = False

    def __init__(self, value: Any, dtype: Optional[DataType] = None):
        import datetime
        self.children = ()
        self.wall = False
        if isinstance(value, datetime.datetime):
            self.wall = value.tzinfo is None
            epoch = datetime.datetime(1970, 1, 1, tzinfo=None if self.wall
                                      else datetime.timezone.utc)
            value = (value - epoch) // datetime.timedelta(microseconds=1)
            dtype = dtype or TimestampT
        elif isinstance(value, datetime.date):
            value = (value - datetime.date(1970, 1, 1)).days
            dtype = dtype or DateT
        self.value = value
        self._dtype = dtype if dtype is not None else infer_literal_type(value)

    @property
    def dtype(self) -> DataType:
        return self._dtype

    @property
    def nullable(self) -> bool:
        return self.value is None

    def value_in(self, ctx):
        """The value in the session of ``ctx`` (a wall time's instant)."""
        if not self.wall or self.value is None:
            return self.value
        from .datetime import session_zone
        db = session_zone(ctx)
        return self.value if db is None else int(db.local_to_utc_np(
            np.array([self.value], np.int64))[0])

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        return TorchScalar(self._dtype, self.value_in(ctx))

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return self.value_in(ctx)

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
    import decimal
    if isinstance(value, decimal.Decimal):
        return decimal_literal_type(value)
    raise NotImplementedError(f"literal {value!r} not yet ported")


def decimal_literal_type(value) -> DecimalType:
    """Spark's type of a ``BigDecimal`` literal (``Decimal.set``): its
    digits and scale, the precision at least the scale; a negative
    exponent widens the integral digits at scale 0 (``1E+2`` is
    decimal(3, 0))."""
    _, digits, exp = value.as_tuple()
    if not isinstance(exp, int):
        raise ValueError(f"decimal literal {value!r} is not finite")
    if exp > 0:
        return DecimalType(len(digits) + exp, 0)
    scale = -exp
    return DecimalType(max(len(digits), scale), scale)


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

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return table.column(self.ordinal).combine_chunks()

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

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        return self.child.eval_cpu(table, ctx)

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
        wide = isinstance(x.dtype, DecimalType) and x.dtype.wide
        if x.value is None:
            return (torch.zeros((2,) if wide else (), dtype=carrier,
                                device=device),
                    torch.zeros(capacity, dtype=torch.bool, device=device))
        value = decimal_carrier(x.value, x.dtype) \
            if isinstance(x.dtype, DecimalType) else x.value
        return torch.tensor(value, dtype=carrier, device=device), None
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
        data = torch.where(lane_mask(validity, data), data,
                           torch.zeros((), dtype=data.dtype,
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


# ---------------------------------------------------------------------------
# host-eval helpers (pyarrow)
# ---------------------------------------------------------------------------


def is_arrow(x) -> bool:
    import pyarrow as pa
    return isinstance(x, (pa.Array, pa.ChunkedArray))


def arrow_column(x, n: int, dtype: DataType):
    """A host result as a ``pa.Array`` of ``n`` rows of ``dtype``'s Arrow
    type (a scalar repeated; an array cast where its type differs)."""
    import pyarrow as pa
    from ..types import to_arrow
    at = to_arrow(dtype)
    if not is_arrow(x):
        if isinstance(x, pa.Scalar):
            x = x.as_py()
        return pa.nulls(n, at) if x is None else \
            pa.repeat(pa.scalar(x, type=at), n)
    if isinstance(x, pa.ChunkedArray):
        x = x.combine_chunks()
    return x if x.type == at else x.cast(at, safe=False)


def arrow_numpy(x, n: int, dtype: DataType):
    """(values as numpy with nulls filled, null mask) of a host result;
    dates and timestamps as their integers."""
    import pyarrow as pa
    arr = arrow_column(x, n, dtype)
    fill = False if pa.types.is_boolean(arr.type) else 0
    if pa.types.is_date32(arr.type):
        arr = arr.cast(pa.int32())
    elif pa.types.is_timestamp(arr.type):
        arr = arr.cast(pa.int64())
    null = np.asarray(arr.is_null()) if arr.null_count else \
        np.zeros(len(arr), np.bool_)
    vals = np.asarray(arr.fill_null(fill).to_numpy(zero_copy_only=False)) \
        if arr.null_count else np.asarray(arr.to_numpy(zero_copy_only=False))
    return vals, null


def scalar_value(data: torch.Tensor, dtype: DataType):
    """Row 0 of a one-row host result as a Python value (a decimal as
    ``decimal.Decimal``)."""
    if isinstance(dtype, DecimalType):
        from ..columnar.vector import decimal_values
        return decimal_values(data[:1].numpy(), dtype)[0]
    return data[0].item()


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
        # a one-row host batch: no device transfer
        return TorchScalar(self.dtype, scalar_value(data, self.dtype)
                           if ok else None)

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

    def _cpu_compute(self, l, r, ctx: EvalContext):
        """The host operation over Arrow operands (arrays or scalars)."""
        raise NotImplementedError(
            f"host evaluation of {type(self).__name__} is not yet ported")

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        """Null in, null out over Arrow operands; two constants fold to a
        Python scalar."""
        l = self.left.eval_cpu(table, ctx)
        r = self.right.eval_cpu(table, ctx)
        if not is_arrow(l) and not is_arrow(r):
            if l is None or r is None:
                return None
            out = self._cpu_compute(arrow_column(l, 1, self.left.dtype),
                                    arrow_column(r, 1, self.right.dtype),
                                    ctx)
            return arrow_column(out, 1, self.dtype)[0].as_py()
        n = len(l) if is_arrow(l) else len(r)
        out = self._cpu_compute(arrow_column(l, n, self.left.dtype),
                                arrow_column(r, n, self.right.dtype), ctx)
        return arrow_column(out, n, self.dtype)


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

    def _compute(self, data, ctx: EvalContext, valid):
        raise NotImplementedError(
            f"{type(self).__name__} is not yet ported")

    def _cpu_compute(self, arr, ctx: EvalContext):
        """The host operation over an Arrow array."""
        raise NotImplementedError(
            f"host evaluation of {type(self).__name__} is not yet ported")

    def eval_cpu(self, table, ctx=_DEFAULT_CTX):
        """Null in, null out over the child's Arrow rows; a constant child
        folds to a Python scalar."""
        c = self.child.eval_cpu(table, ctx)
        if not is_arrow(c):
            if c is None:
                return None
            out = self._cpu_compute(arrow_column(c, 1, self.child.dtype), ctx)
            return arrow_column(out, 1, self.dtype)[0].as_py()
        return arrow_column(self._cpu_compute(
            arrow_column(c, len(c), self.child.dtype), ctx), len(c),
            self.dtype)

    def eval_device(self, batch, ctx=_DEFAULT_CTX):
        """Null in, null out: ``_compute`` over the child's data."""
        cap, dev = batch.capacity, batch.device
        d, v = device_parts(self.child.eval_device(batch, ctx), cap, dev)
        wide = isinstance(self.child.dtype, DecimalType) \
            and self.child.dtype.wide
        d = torch.broadcast_to(d, (cap, 2) if wide else (cap,))
        valid = combine_validity(v, row_mask(batch.num_rows, cap, dev))
        return make_column(self.dtype, self._compute(d, ctx, valid), valid,
                           batch.num_rows)


def eval_cpu_on_host_tensors(expr: Expression, table, ctx: EvalContext,
                             fn=None):
    """Host evaluation through the expression's device code on CPU
    tensors: each non-literal child's ``eval_cpu`` rows read into a host
    column, ``eval_device`` over that host batch, the result back as
    Arrow. The host engine's answer is then the card's by construction
    (as murmur3's, ``hashexprs.murmur3_arrow``); no device is touched. A
    constant subtree folds to a Python scalar."""
    from ..columnar.batch import TorchColumnarBatch
    from ..columnar.vector import column_to_arrow
    import pyarrow as pa
    n = table.num_rows
    kids, cols = [], []
    any_arrow = all(isinstance(c, Literal) for c in expr.children)
    for c in expr.children:
        if isinstance(c, Literal):
            kids.append(c)
            continue
        v = c.eval_cpu(table, ctx)
        any_arrow = any_arrow or is_arrow(v)
        kids.append(c)
        cols.append((c, v))
    rows = n if any_arrow else 1
    host_cols = []
    for c, v in cols:
        arr = arrow_column(v, rows, c.dtype)
        host_cols.append(host_column(arr, c.dtype))
    batch = TorchColumnarBatch(host_cols, rows)
    i = 0
    bound = []
    for c in kids:
        if isinstance(c, Literal):
            bound.append(c)
        else:
            bound.append(AttributeReference(f"c{i}", c.dtype, c.nullable,
                                            ordinal=i))
            i += 1
    # all-literal children: the expression itself (a row counter is keyed
    # by it)
    node = expr if all(b is c for b, c in zip(bound, expr.children)) \
        else expr.with_children(bound)
    res = node.eval_device(batch, ctx) if fn is None else fn(node, batch,
                                                               ctx)
    out = to_column(res, batch, expr.dtype)
    arr = column_to_arrow(out, kind=None)
    if any_arrow:
        return arrow_column(arr, rows, expr.dtype)
    return arrow_column(arr, 1, expr.dtype)[0].as_py()


def host_column(arr, dtype: DataType) -> TorchColumnVector:
    """An Arrow array of ``dtype``'s Arrow type as a host column of
    ``dtype`` (capacity = rows), read through its buffers."""
    import pyarrow as pa
    from ..columnar.batch import TorchColumnarBatch
    col = TorchColumnarBatch.from_arrow(pa.table({"c": arr})).columns[0]
    return col if col.dtype == dtype else TorchColumnVector(
        dtype, col.data, col.validity, col.num_rows, col.offsets)
