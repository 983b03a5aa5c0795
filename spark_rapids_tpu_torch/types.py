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
    """decimal(precision, scale): the unscaled value in int64 lanes, one a
    row ``[n]`` up to precision 18, two a row ``[n, 2]`` (hi, lo) past it
    (``kernels/decimal128.py``; reference types.py:108-119)."""
    precision: int = 10
    scale: int = 0

    MAX_PRECISION = 38
    MAX_LONG_DIGITS = 18  # the one-lane carrier

    @property
    def np_dtype(self):  # type: ignore[override]
        return np.dtype(np.int64)

    @property
    def wide(self) -> bool:
        """Carried as two limbs a row."""
        return self.precision > self.MAX_LONG_DIGITS

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


# DDL schema strings ("a INT, b STRING"): Spark's StructType.fromDDL syntax,
# as in read.schema() (reference types.py:486-551)


def parse_ddl(ddl: str) -> StructType:
    """A DDL field list (``"a INT, b: STRING"``, or ``"struct<...>"``) as a
    StructType of nullable fields."""
    ddl = ddl.strip()
    if ddl.lower().startswith("struct<") and ddl.endswith(">"):
        ddl = ddl[7:-1]
    fields = []
    for part in _split_top_level(ddl):
        part = part.strip()
        if not part:
            continue
        if ":" in part.split("<")[0]:  # "name: type", struct-field style
            name, typ = part.split(":", 1)
        else:
            bits = part.split(None, 1)
            if len(bits) != 2:
                raise ValueError(f"cannot parse DDL field {part!r}")
            name, typ = bits
        fields.append(StructField(name.strip().strip("`"),
                                  parse_ddl_type(typ.strip()), True))
    return StructType(tuple(fields))


def _split_top_level(s: str, sep: str = ",") -> list:
    out, depth, cur = [], 0, []
    for ch in s:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        if ch == sep and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    return out


_DDL_SIMPLE = {
    "boolean": BooleanType, "tinyint": ByteType, "byte": ByteType,
    "smallint": ShortType, "short": ShortType, "int": IntegerType,
    "integer": IntegerType, "bigint": LongType, "long": LongType,
    "float": FloatType, "real": FloatType, "double": DoubleType,
    "string": StringType, "binary": BinaryType, "date": DateType,
    "timestamp": TimestampType, "void": NullType, "null": NullType,
}


def parse_ddl_type(s: str) -> DataType:
    """One DDL type: the simple names, ``decimal(p, s)`` and
    ``struct<...>``; arrays and maps wait for the nested types (A6)."""
    s = s.strip()
    low = s.lower()
    if low in _DDL_SIMPLE:
        return _DDL_SIMPLE[low]()
    if low.startswith("decimal"):
        m = s[s.index("(") + 1: s.rindex(")")] if "(" in s else "10,0"
        p, sc = (m.split(",") + ["0"])[:2]
        return DecimalType(int(p), int(sc))
    if low.startswith(("array<", "map<")) and s.endswith(">"):
        raise NotImplementedError(
            f"DDL type {s!r}: arrays and maps not yet ported (A6)")
    if low.startswith("struct<") and s.endswith(">"):
        return parse_ddl(s[7:-1])
    raise ValueError(f"cannot parse DDL type {s!r}")


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
    if isinstance(dt, DecimalType):
        return pa.decimal128(dt.precision, dt.scale)
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
    DECIMAL_64 = "DECIMAL_64"
    DECIMAL_128 = "DECIMAL_128"
    NULL = "NULL"
    STRUCT = "STRUCT"


_TYPE_ENUMS = ((BooleanType, TypeEnum.BOOLEAN), (ByteType, TypeEnum.BYTE),
               (ShortType, TypeEnum.SHORT), (IntegerType, TypeEnum.INT),
               (LongType, TypeEnum.LONG), (FloatType, TypeEnum.FLOAT),
               (DoubleType, TypeEnum.DOUBLE), (DateType, TypeEnum.DATE),
               (TimestampType, TypeEnum.TIMESTAMP),
               (StringType, TypeEnum.STRING), (BinaryType, TypeEnum.BINARY),
               (NullType, TypeEnum.NULL), (StructType, TypeEnum.STRUCT))


def _type_enum_of(dt: DataType) -> str:
    if isinstance(dt, DecimalType):
        return TypeEnum.DECIMAL_128 if dt.wide else TypeEnum.DECIMAL_64
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
    """Standard signatures over the types the port carries (reference
    types.py:379-394): DECIMAL_64 is numeric and comparable; DECIMAL_128
    is in ``scan`` and in the signatures of the expressions that carry
    two-limb values (``plan/typechecks.py``)."""
    BOOLEAN = TypeSig([TypeEnum.BOOLEAN])
    integral = TypeSig([TypeEnum.BYTE, TypeEnum.SHORT, TypeEnum.INT,
                        TypeEnum.LONG])
    fp = TypeSig([TypeEnum.FLOAT, TypeEnum.DOUBLE])
    DECIMAL_64 = TypeSig([TypeEnum.DECIMAL_64])
    DECIMAL_128 = TypeSig([TypeEnum.DECIMAL_64, TypeEnum.DECIMAL_128])
    numeric = integral + fp + DECIMAL_64
    STRING = TypeSig([TypeEnum.STRING])
    DATE = TypeSig([TypeEnum.DATE])
    NULL = TypeSig([TypeEnum.NULL])
    comparable = numeric + BOOLEAN + STRING + DATE + NULL
    all_basic = comparable
    #: what a file scan can carry: the basic types, timestamps and binary
    scan = all_basic + DECIMAL_128 + TypeSig([TypeEnum.TIMESTAMP,
                                              TypeEnum.BINARY])


def numeric_promote(a: DataType, b: DataType) -> DataType:
    """Spark's binary-arithmetic common type: the wider of two
    non-decimal numerics; with a decimal, ``decimal_common_type``."""
    order = [ByteT, ShortT, IntegerT, LongT, FloatT, DoubleT]
    if a == b:
        return a
    if isinstance(a, DecimalType) or isinstance(b, DecimalType):
        return decimal_common_type(a, b)
    return order[max(order.index(a), order.index(b))]


def wider_type(a: DataType, b: DataType) -> Optional[DataType]:
    """Spark's ``findWiderTypeForTwo`` (``WidenSetOperationTypes``: the
    type a union column takes from its children): the wider numeric (a
    decimal with an integral widens to the decimal that holds both, with
    a float or double to double), timestamp over date, string over any
    other atomic type but boolean and binary; None when there is none."""
    if a == b:
        return a
    if isinstance(a, NullType):
        return b
    if isinstance(b, NullType):
        return a
    if isinstance(a, NumericType) and isinstance(b, NumericType):
        return numeric_promote(a, b)
    if {type(a), type(b)} == {DateType, TimestampType}:
        return TimestampT
    for s, o in ((a, b), (b, a)):
        if isinstance(s, StringType) and not isinstance(
                o, (BooleanType, BinaryType, StructType)):
            return StringT
    return None


# ---------------------------------------------------------------------------
# Spark's decimal types (DecimalPrecision, allowPrecisionLoss=true)
# ---------------------------------------------------------------------------

#: digits of each integral type as a decimal (Spark's
#: DecimalType.forType)
_INTEGRAL_DIGITS = {ByteType: 3, ShortType: 5, IntegerType: 10,
                    LongType: 20}


def integral_decimal(dt: DataType) -> "DecimalType":
    """An integral type as the decimal that holds it: byte (3,0), short
    (5,0), int (10,0), long (20,0)."""
    return DecimalType(_INTEGRAL_DIGITS[type(dt)], 0)


def adjust_precision_scale(precision: int, scale: int) -> "DecimalType":
    """Spark's ``DecimalType.adjustPrecisionScale``: past 38 digits keep
    the integral digits and at least min(scale, 6) fraction digits."""
    if precision <= DecimalType.MAX_PRECISION:
        return DecimalType(precision, scale)
    int_digits = precision - scale
    min_scale = min(scale, 6)
    return DecimalType(DecimalType.MAX_PRECISION,
                       max(DecimalType.MAX_PRECISION - int_digits, min_scale))


def decimal_result_type(op: str, a: "DecimalType",
                        b: "DecimalType") -> "DecimalType":
    """The result type of ``a op b`` over two decimals, ``op`` one of
    ``+ - * / % pmod``."""
    p1, s1, p2, s2 = a.precision, a.scale, b.precision, b.scale
    if op in ("+", "-"):
        s = max(s1, s2)
        return adjust_precision_scale(max(p1 - s1, p2 - s2) + s + 1, s)
    if op == "*":
        return adjust_precision_scale(p1 + p2 + 1, s1 + s2)
    if op == "/":
        s = max(6, s1 + p2 + 1)
        return adjust_precision_scale(p1 - s1 + s2 + s, s)
    if op in ("%", "pmod"):
        s = max(s1, s2)
        return adjust_precision_scale(min(p1 - s1, p2 - s2) + s, s)
    raise ValueError(op)


def decimal_wider_type(a: "DecimalType", b: "DecimalType") -> "DecimalType":
    """The decimal both sides of a comparison (or a branch) widen to:
    ``s = max(s1, s2)``, ``p = min(38, max(p1-s1, p2-s2) + s)``."""
    s = max(a.scale, b.scale)
    p = max(a.precision - a.scale, b.precision - b.scale) + s
    return DecimalType(min(p, DecimalType.MAX_PRECISION), s)


def decimal_common_type(a: DataType, b: DataType) -> DataType:
    """The common type of a decimal and another numeric: double with a
    float or double, else the wider decimal (an integral widened by
    ``integral_decimal``)."""
    if isinstance(a, (FloatType, DoubleType)) \
            or isinstance(b, (FloatType, DoubleType)):
        return DoubleT
    if isinstance(a, IntegralType):
        a = integral_decimal(a)
    if isinstance(b, IntegralType):
        b = integral_decimal(b)
    return decimal_wider_type(a, b)


def round_decimal_type(t: "DecimalType", scale: int) -> "DecimalType":
    """``round``/``bround`` of a decimal at ``scale`` (Spark 3.4's
    ``RoundBase.dataType``, SPARK-39226: one more integral digit for the
    carry): (min(38, p − s + 1 + min(s, scale)), min(s, scale)) for a
    scale >= 0, else (min(38, max(p − s + 1, 1 − scale)), 0)."""
    p, s = t.precision, t.scale
    if scale < 0:
        return DecimalType(min(max(p - s + 1, 1 - scale),
                               DecimalType.MAX_PRECISION), 0)
    new_s = min(s, scale)
    return DecimalType(min(p - s + 1 + new_s, DecimalType.MAX_PRECISION),
                       new_s)


def floor_ceil_decimal_type(t: "DecimalType") -> "DecimalType":
    """``floor``/``ceil`` of a decimal (Spark's ``Floor``/``Ceil``
    ``dataType``): the type itself at scale 0, else (min(38, p − s + 1),
    0)."""
    if t.scale == 0:
        return t
    return DecimalType(min(t.precision - t.scale + 1,
                           DecimalType.MAX_PRECISION), 0)


def sum_decimal_type(t: "DecimalType") -> "DecimalType":
    """Spark's ``sum`` of a decimal: (min(38, p + 10), s)."""
    return DecimalType(min(t.precision + 10, 38), t.scale)


def avg_decimal_type(t: "DecimalType") -> "DecimalType":
    """Spark's ``avg`` of a decimal: (min(38, p + 4), min(38, s + 4))."""
    return DecimalType(min(t.precision + 4, 38), min(t.scale + 4, 38))
