"""Spark-compatible data types and their numpy/torch carriers.

Port of the Q1 subset of ``spark_rapids_tpu/types.py``: the logical type
hierarchy, the singletons, ``numeric_promote`` and the carrier maps. Dates
are int32 days, strings are int32 offsets + uint8 bytes (no fixed carrier).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch


class DataType:
    """Base of the Spark-mirroring logical type hierarchy."""

    #: numpy dtype of the device carrier, or None when not fixed-width
    np_dtype: Optional[np.dtype] = None

    def simple_string(self) -> str:
        return type(self).__name__.replace("Type", "").lower()

    def __repr__(self) -> str:
        return self.simple_string()

    def __eq__(self, other: object) -> bool:
        return type(self) is type(other)

    def __hash__(self) -> int:
        return hash(type(self).__name__)

    @property
    def torch_dtype(self) -> Optional[torch.dtype]:
        """torch dtype of the device carrier (None when not fixed-width)."""
        return None if self.np_dtype is None else _NP_TO_TORCH[np.dtype(self.np_dtype)]


class NullType(DataType):
    np_dtype = np.dtype(np.bool_)

    def simple_string(self) -> str:
        return "void"


class BooleanType(DataType):
    np_dtype = np.dtype(np.bool_)


class NumericType(DataType):
    pass


class IntegralType(NumericType):
    pass


class ByteType(IntegralType):
    np_dtype = np.dtype(np.int8)

    def simple_string(self) -> str:
        return "tinyint"


class ShortType(IntegralType):
    np_dtype = np.dtype(np.int16)

    def simple_string(self) -> str:
        return "smallint"


class IntegerType(IntegralType):
    np_dtype = np.dtype(np.int32)

    def simple_string(self) -> str:
        return "int"


class LongType(IntegralType):
    np_dtype = np.dtype(np.int64)

    def simple_string(self) -> str:
        return "bigint"


class FractionalType(NumericType):
    pass


class FloatType(FractionalType):
    np_dtype = np.dtype(np.float32)


class DoubleType(FractionalType):
    np_dtype = np.dtype(np.float64)


@dataclass(frozen=True, eq=False)
class DecimalType(FractionalType):
    """Declared so the eligibility checks can name it; no decimal
    expression is ported yet."""
    precision: int = 10
    scale: int = 0

    @property
    def np_dtype(self):  # type: ignore[override]
        return None

    def simple_string(self) -> str:
        return f"decimal({self.precision},{self.scale})"

    def __eq__(self, other: object) -> bool:
        return (isinstance(other, DecimalType) and other.precision == self.precision
                and other.scale == self.scale)

    def __hash__(self) -> int:
        return hash(("decimal", self.precision, self.scale))


class StringType(DataType):
    np_dtype = None  # int32 offsets + uint8 bytes


class DateType(DataType):
    np_dtype = np.dtype(np.int32)  # days since epoch


@dataclass(frozen=True)
class StructField:
    name: str
    data_type: DataType
    nullable: bool = True


@dataclass(eq=False)
class StructType(DataType):
    fields: Tuple[StructField, ...] = ()
    np_dtype = None

    def __init__(self, fields: Iterable[StructField] = ()):
        object.__setattr__(self, "fields", tuple(fields))

    @property
    def field_names(self) -> List[str]:
        return [f.name for f in self.fields]

    def simple_string(self) -> str:
        inner = ",".join(f"{f.name}:{f.data_type.simple_string()}" for f in self.fields)
        return f"struct<{inner}>"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, StructType) and other.fields == self.fields

    def __hash__(self) -> int:
        return hash(("struct", self.fields))


NullT = NullType()
BooleanT = BooleanType()
ByteT = ByteType()
ShortT = ShortType()
IntegerT = IntegerType()
LongT = LongType()
FloatT = FloatType()
DoubleT = DoubleType()
StringT = StringType()
DateT = DateType()

_NP_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}

#: numpy dtype of a host column → logical type (createDataFrame inference)
_NP_TO_TYPE = {
    np.dtype(np.bool_): BooleanT,
    np.dtype(np.int8): ByteT,
    np.dtype(np.int16): ShortT,
    np.dtype(np.int32): IntegerT,
    np.dtype(np.int64): LongT,
    np.dtype(np.float32): FloatT,
    np.dtype(np.float64): DoubleT,
}


def is_fixed_width(dt: DataType) -> bool:
    return dt.np_dtype is not None and not isinstance(dt, NullType)


def from_numpy_dtype(dt: np.dtype) -> DataType:
    """Logical type of a numpy column ('S'/'U'/object → string)."""
    dt = np.dtype(dt)
    if dt.kind in "SUO":
        return StringT
    if dt.kind == "M" and dt == np.dtype("datetime64[D]"):
        return DateT
    if dt not in _NP_TO_TYPE:
        raise NotImplementedError(f"numpy dtype {dt} not yet ported")
    return _NP_TO_TYPE[dt]


def from_arrow(at) -> DataType:
    """Arrow → Spark type for the types the port carries."""
    import pyarrow as pa
    if pa.types.is_string(at) or pa.types.is_large_string(at):
        return StringT
    if pa.types.is_date32(at):
        return DateT
    if pa.types.is_null(at):
        return NullT
    if pa.types.is_decimal(at):
        return DecimalType(at.precision, at.scale)
    try:
        return from_numpy_dtype(np.dtype(at.to_pandas_dtype()))
    except (NotImplementedError, TypeError):
        raise NotImplementedError(f"arrow type {at} not yet ported") from None


def numeric_promote(a: DataType, b: DataType) -> DataType:
    """Spark's binary-arithmetic common type for non-decimal numerics."""
    order = [ByteT, ShortT, IntegerT, LongT, FloatT, DoubleT]
    if a == b:
        return a
    if isinstance(a, DecimalType) or isinstance(b, DecimalType):
        raise NotImplementedError("decimal promotion not yet ported")
    return order[max(order.index(a), order.index(b))]
