"""Spark-compatible data types and their numpy/torch carriers.

Port of the Q1 subset of ``spark_rapids_tpu/types.py``: the logical type
hierarchy, the singletons, ``numeric_promote`` and the carrier maps. Dates
are int32 days, timestamps int64 microseconds since the epoch (UTC),
strings and binary int32 offsets + uint8 bytes (no fixed carrier).
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


class BinaryType(DataType):
    np_dtype = None  # int32 offsets + uint8 bytes, as strings


class DateType(DataType):
    np_dtype = np.dtype(np.int32)  # days since epoch


class TimestampType(DataType):
    np_dtype = np.dtype(np.int64)  # microseconds since epoch, UTC


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
BinaryT = BinaryType()
DateT = DateType()
TimestampT = TimestampType()

#: Spark SQL type names (``Column.cast("int")``) → type, as the
#: reference's ``session._type_from_string`` resolves them
_TYPE_NAMES = {"boolean": BooleanT, "byte": ByteT, "tinyint": ByteT,
               "short": ShortT, "smallint": ShortT, "int": IntegerT,
               "integer": IntegerT, "long": LongT, "bigint": LongT,
               "float": FloatT, "double": DoubleT, "string": StringT,
               "binary": BinaryT, "date": DateT, "timestamp": TimestampT}


def type_from_string(name: str) -> DataType:
    """The type a Spark SQL type name denotes (case and surrounding space
    ignored): ``"int"``, ``"double"``, ``"long"``, ``"date"``, ... and
    ``"decimal(p, s)"`` (``decimal`` alone is decimal(10, 0))."""
    key = name.strip().lower()
    if key in _TYPE_NAMES:
        return _TYPE_NAMES[key]
    if key.startswith("decimal"):
        import re
        m = re.match(r"decimal\((\d+),\s*(\d+)\)", key)
        return DecimalType(int(m.group(1)), int(m.group(2))) if m \
            else DecimalType(10, 0)
    raise ValueError(f"unknown type string {name!r}")


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
    if pa.types.is_binary(at) or pa.types.is_large_binary(at):
        return BinaryT
    if pa.types.is_date32(at):
        return DateT
    if pa.types.is_timestamp(at):
        return TimestampT
    if pa.types.is_null(at):
        return NullT
    if pa.types.is_decimal(at):
        return DecimalType(at.precision, at.scale)
    try:
        return from_numpy_dtype(np.dtype(at.to_pandas_dtype()))
    except (NotImplementedError, TypeError):
        raise NotImplementedError(f"arrow type {at} not yet ported") from None


def to_arrow(dt: DataType):
    """Spark → Arrow type (the reference's ``to_arrow``) for the types the
    port carries."""
    import pyarrow as pa
    fixed = {BooleanType: pa.bool_(), ByteType: pa.int8(),
             ShortType: pa.int16(), IntegerType: pa.int32(),
             LongType: pa.int64(), FloatType: pa.float32(),
             DoubleType: pa.float64(), StringType: pa.string(),
             BinaryType: pa.binary(), DateType: pa.date32(),
             TimestampType: pa.timestamp("us", tz="UTC"),
             NullType: pa.null()}
    if type(dt) not in fixed:
        raise NotImplementedError(f"arrow type of {dt} not yet ported")
    return fixed[type(dt)]


# ---------------------------------------------------------------------------
# TypeSig: the can-this-run-on-the-device matrix (reference types.py:324)
# ---------------------------------------------------------------------------


class TypeEnum:
    BOOLEAN = "BOOLEAN"
    BYTE = "BYTE"
    SHORT = "SHORT"
    INT = "INT"
    LONG = "LONG"
    FLOAT = "FLOAT"
    DOUBLE = "DOUBLE"
    DATE = "DATE"
    TIMESTAMP = "TIMESTAMP"
    STRING = "STRING"
    BINARY = "BINARY"
    DECIMAL = "DECIMAL"
    NULL = "NULL"
    STRUCT = "STRUCT"


_TYPE_ENUMS = ((BooleanType, TypeEnum.BOOLEAN), (ByteType, TypeEnum.BYTE),
               (ShortType, TypeEnum.SHORT), (IntegerType, TypeEnum.INT),
               (LongType, TypeEnum.LONG), (FloatType, TypeEnum.FLOAT),
               (DoubleType, TypeEnum.DOUBLE), (DateType, TypeEnum.DATE),
               (TimestampType, TypeEnum.TIMESTAMP),
               (StringType, TypeEnum.STRING), (BinaryType, TypeEnum.BINARY),
               (DecimalType, TypeEnum.DECIMAL),
               (NullType, TypeEnum.NULL), (StructType, TypeEnum.STRUCT))


def _type_enum_of(dt: DataType) -> str:
    for cls, te in _TYPE_ENUMS:
        if isinstance(dt, cls):
            return te
    raise NotImplementedError(f"type {dt} not yet ported")


class TypeSig:
    """A set of supported ``TypeEnum``s; ``check(dt)`` returns None when
    supported or a human-readable reason (reference TypeSig)."""

    def __init__(self, initial: Iterable[str] = ()):
        self.types = frozenset(initial)

    def __add__(self, other: "TypeSig") -> "TypeSig":
        return TypeSig(self.types | other.types)

    def supports(self, dt: DataType) -> bool:
        return self.check(dt) is None

    def check(self, dt: DataType) -> Optional[str]:
        if _type_enum_of(dt) not in self.types:
            return f"{dt.simple_string()} is not supported"
        if isinstance(dt, StructType):
            for f in dt.fields:
                r = self.check(f.data_type)
                if r:
                    return f"struct field {f.name}: {r}"
        return None


class TypeSigs:
    """Standard signatures over the types the port carries. No decimal
    expression is ported, so DECIMAL is in no signature and a decimal
    column keeps its operator on the CPU."""
    BOOLEAN = TypeSig([TypeEnum.BOOLEAN])
    integral = TypeSig([TypeEnum.BYTE, TypeEnum.SHORT, TypeEnum.INT,
                        TypeEnum.LONG])
    fp = TypeSig([TypeEnum.FLOAT, TypeEnum.DOUBLE])
    numeric = integral + fp
    STRING = TypeSig([TypeEnum.STRING])
    DATE = TypeSig([TypeEnum.DATE])
    NULL = TypeSig([TypeEnum.NULL])
    comparable = numeric + BOOLEAN + STRING + DATE + NULL
    all_basic = comparable
    #: what a file scan can carry: the basic types, timestamps and binary
    scan = all_basic + TypeSig([TypeEnum.TIMESTAMP, TypeEnum.BINARY])


def numeric_promote(a: DataType, b: DataType) -> DataType:
    """Spark's binary-arithmetic common type for non-decimal numerics."""
    order = [ByteT, ShortT, IntegerT, LongT, FloatT, DoubleT]
    if a == b:
        return a
    if isinstance(a, DecimalType) or isinstance(b, DecimalType):
        raise NotImplementedError("decimal promotion not yet ported")
    return order[max(order.index(a), order.index(b))]
