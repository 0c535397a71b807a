"""Spark SQL data types.

Mirrors org.apache.spark.sql.types, which the reference's TypeSig algebra
(sql-plugin TypeChecks.scala:171) enumerates: BOOLEAN, BYTE, SHORT, INT,
LONG, FLOAT, DOUBLE, DATE, TIMESTAMP, STRING, DECIMAL, NULL, BINARY,
CALENDAR, ARRAY, MAP, STRUCT, UDT.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


class DataType:
    """Base of the SQL type lattice."""

    @property
    def simple_string(self) -> str:
        return type(self).__name__.replace("Type", "").lower()

    def __repr__(self) -> str:
        return self.simple_string

    def __eq__(self, other) -> bool:
        return type(self) is type(other)

    def __hash__(self) -> int:
        return hash(type(self).__name__)

    @property
    def default_size(self) -> int:
        return 8


class NumericType(DataType):
    pass


class IntegralType(NumericType):
    pass


class FractionalType(NumericType):
    pass


class AtomicType(DataType):
    pass


class NullType(DataType):
    default_size = 1


class BooleanType(AtomicType):
    np_dtype = np.bool_
    default_size = 1


class ByteType(IntegralType):
    np_dtype = np.int8
    default_size = 1
    simple_string = "tinyint"


class ShortType(IntegralType):
    np_dtype = np.int16
    default_size = 2
    simple_string = "smallint"


class IntegerType(IntegralType):
    np_dtype = np.int32
    default_size = 4
    simple_string = "int"


class LongType(IntegralType):
    np_dtype = np.int64
    default_size = 8
    simple_string = "bigint"


class FloatType(FractionalType):
    np_dtype = np.float32
    default_size = 4


class DoubleType(FractionalType):
    np_dtype = np.float64
    default_size = 8


class StringType(AtomicType):
    default_size = 20


class BinaryType(AtomicType):
    default_size = 100


class DateType(AtomicType):
    """Days since epoch, int32 (Spark internal representation)."""
    np_dtype = np.int32
    default_size = 4


class TimestampType(AtomicType):
    """Microseconds since epoch UTC, int64 (Spark internal representation)."""
    np_dtype = np.int64
    default_size = 8


class CalendarIntervalType(DataType):
    default_size = 16
    simple_string = "interval"


@dataclass(frozen=True)
class DecimalType(FractionalType):
    """Fixed decimal(precision, scale); unscaled int64 storage up to
    precision 18 (DECIMAL64), two-limb beyond (the reference gates most ops
    at DECIMAL64, TypeChecks.scala gpuNumeric)."""

    precision: int = 10
    scale: int = 0

    MAX_PRECISION = 38
    MAX_LONG_DIGITS = 18

    @property
    def simple_string(self) -> str:
        return f"decimal({self.precision},{self.scale})"

    @property
    def default_size(self) -> int:
        return 8 if self.precision <= 18 else 16

    def __eq__(self, other) -> bool:
        return (isinstance(other, DecimalType)
                and other.precision == self.precision
                and other.scale == self.scale)

    def __hash__(self) -> int:
        return hash(("decimal", self.precision, self.scale))


@dataclass(frozen=True)
class ArrayType(DataType):
    element_type: DataType = field(default_factory=NullType)
    contains_null: bool = True

    @property
    def simple_string(self) -> str:
        return f"array<{self.element_type.simple_string}>"

    def __eq__(self, other) -> bool:
        return (isinstance(other, ArrayType)
                and other.element_type == self.element_type)

    def __hash__(self) -> int:
        return hash(("array", self.element_type))


@dataclass(frozen=True)
class MapType(DataType):
    key_type: DataType = field(default_factory=NullType)
    value_type: DataType = field(default_factory=NullType)
    value_contains_null: bool = True

    @property
    def simple_string(self) -> str:
        return (f"map<{self.key_type.simple_string},"
                f"{self.value_type.simple_string}>")

    def __eq__(self, other) -> bool:
        return (isinstance(other, MapType) and other.key_type == self.key_type
                and other.value_type == self.value_type)

    def __hash__(self) -> int:
        return hash(("map", self.key_type, self.value_type))


@dataclass(frozen=True)
class StructField:
    name: str
    data_type: DataType
    nullable: bool = True


@dataclass(frozen=True)
class StructType(DataType):
    fields: tuple = ()

    def __init__(self, fields=()):
        object.__setattr__(self, "fields", tuple(fields))

    @property
    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    @property
    def simple_string(self) -> str:
        inner = ",".join(
            f"{f.name}:{f.data_type.simple_string}" for f in self.fields)
        return f"struct<{inner}>"

    def add(self, name: str, dt: DataType, nullable: bool = True
            ) -> "StructType":
        return StructType(self.fields + (StructField(name, dt, nullable),))

    def field_index(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(name)

    def __eq__(self, other) -> bool:
        return isinstance(other, StructType) and other.fields == self.fields

    def __hash__(self) -> int:
        return hash(("struct", self.fields))

    def __len__(self) -> int:
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)


# Singletons, Spark style
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


def is_integral(dt: DataType) -> bool:
    return isinstance(dt, IntegralType)


def is_numeric(dt: DataType) -> bool:
    return isinstance(dt, NumericType)


def is_floating(dt: DataType) -> bool:
    return isinstance(dt, (FloatType, DoubleType))


def storage_zeros(dt: DataType, n: int) -> np.ndarray:
    """Zeroed host buffer in the engine's storage layout for ``dt``.
    DECIMAL128 is the one type whose storage is not a flat numpy dtype:
    its unscaled value lives in an (n, 2) int64 [hi, lo] limb pair (the
    layout transfer.py ships and ops/int128.py computes over), so
    buffer allocation must go through here, not numpy_dtype."""
    if is_limb_decimal(dt):
        return np.zeros((n, 2), dtype=np.int64)
    return np.zeros(n, dtype=numpy_dtype(dt))


def numpy_dtype(dt: DataType) -> np.dtype:
    """numpy storage dtype for the fixed-width physical representation."""
    if isinstance(dt, DecimalType):
        if dt.precision <= DecimalType.MAX_LONG_DIGITS:
            return np.dtype(np.int64)
        raise TypeError(f"decimal > 18 digits not fixed-width-64: {dt}")
    if isinstance(dt, (StringType, BinaryType)):
        return np.dtype(object)
    if isinstance(dt, (ArrayType, MapType, StructType)):
        # host representation: object array of python lists/dicts/tuples
        return np.dtype(object)
    if isinstance(dt, NullType):
        return np.dtype(np.int8)
    nd = getattr(dt, "np_dtype", None)
    if nd is None:
        raise TypeError(f"no numpy dtype for {dt}")
    return np.dtype(nd)


# Numeric widening lattice for binary op type coercion
# (Spark TypeCoercion.findTightestCommonType).
_NUMERIC_ORDER = [ByteType(), ShortType(), IntegerType(), LongType(),
                  FloatType(), DoubleType()]


def is_limb_decimal(dt: DataType) -> bool:
    """True for DECIMAL128 storage: unscaled value kept as two int64
    limbs (precision beyond DecimalType.MAX_LONG_DIGITS)."""
    return (isinstance(dt, DecimalType)
            and dt.precision > DecimalType.MAX_LONG_DIGITS)


def decimal_for_integral(dt: DataType) -> DecimalType:
    """Spark DecimalType.forType: the exact decimal an integral fits."""
    if isinstance(dt, ByteType):
        return DecimalType(3, 0)
    if isinstance(dt, ShortType):
        return DecimalType(5, 0)
    if isinstance(dt, IntegerType):
        return DecimalType(10, 0)
    return DecimalType(20, 0)  # long / boolean-as-int never reaches here


def adjust_precision_scale(p: int, s: int) -> DecimalType:
    """Spark DecimalPrecision.adjustPrecisionScale with
    spark.sql.decimalOperations.allowPrecisionLoss=true (the default):
    cap at 38 digits, sacrificing scale but keeping at least 6
    fractional digits when possible."""
    if p <= DecimalType.MAX_PRECISION:
        return DecimalType(max(p, 1), s)
    int_digits = p - s
    min_scale = min(s, 6)
    adjusted = max(DecimalType.MAX_PRECISION - int_digits, min_scale)
    return DecimalType(DecimalType.MAX_PRECISION, adjusted)


def decimal_binary_result(op: str, lt: DecimalType, rt: DecimalType
                          ) -> DecimalType:
    """Spark DecimalPrecision result types for +,-,*,/ (arithmetic.scala
    / DecimalPrecision.scala; the reference re-checks these in
    GpuDecimalMultiply etc., decimalExpressions.scala)."""
    p1, s1, p2, s2 = lt.precision, lt.scale, rt.precision, rt.scale
    if op in ("+", "-"):
        s = max(s1, s2)
        p = max(p1 - s1, p2 - s2) + s + 1
    elif op == "*":
        p = p1 + p2 + 1
        s = s1 + s2
    elif op == "/":
        s = max(6, s1 + p2 + 1)
        p = p1 - s1 + s2 + s
    else:
        raise ValueError(op)
    return adjust_precision_scale(p, s)


def wider_decimal(a: DecimalType, b: DecimalType) -> DecimalType:
    """Loss-free common type for comparisons/set ops (Spark
    DecimalPrecision.widerDecimalType), 38-capped."""
    s = max(a.scale, b.scale)
    rng = max(a.precision - a.scale, b.precision - b.scale)
    return DecimalType(min(rng + s, DecimalType.MAX_PRECISION), s)


def tightest_common_type(a: DataType, b: DataType) -> Optional[DataType]:
    if a == b:
        return a
    if isinstance(a, NullType):
        return b
    if isinstance(b, NullType):
        return a
    if a in _NUMERIC_ORDER and b in _NUMERIC_ORDER:
        return _NUMERIC_ORDER[max(_NUMERIC_ORDER.index(a),
                                  _NUMERIC_ORDER.index(b))]
    if isinstance(a, DecimalType) or isinstance(b, DecimalType):
        # fractional side wins entirely (Spark: decimal + float/double
        # -> double); integral side is lifted to its exact decimal and
        # widened loss-free
        if isinstance(a, (FloatType, DoubleType)) or \
                isinstance(b, (FloatType, DoubleType)):
            return DoubleT
        if isinstance(a, DecimalType) and isinstance(b, DecimalType):
            return wider_decimal(a, b)
        other = b if isinstance(a, DecimalType) else a
        dec = a if isinstance(a, DecimalType) else b
        if other in _NUMERIC_ORDER[:4]:
            return wider_decimal(dec, decimal_for_integral(other))
    return None
