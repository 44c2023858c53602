"""SQL type system mapped to fixed-width TPU-friendly physical layouts.

The reference models SQL types as accessor objects over columnar blocks
(``core/trino-spi/src/main/java/io/trino/spi/type/`` — e.g. ``BigintType``,
``DecimalType``, ``DateType``).  Here every SQL type maps to a fixed-width
numpy/JAX dtype so whole columns are dense device arrays:

- BIGINT/INTEGER          -> int64 / int32
- BOOLEAN                 -> bool_
- DOUBLE                  -> float64 (kept f64 for bit-exact aggregation;
                             hot kernels may downcast where safe)
- DECIMAL(p<=18, s)       -> int64 holding unscaled value (Trino's "short
                             decimal", ``spi/type/DecimalType.java``); TPC-H
                             money is DECIMAL(15,2) = int64 cents
- DATE                    -> int32 days since 1970-01-01 (same physical
                             encoding as the reference: ``spi/type/DateType``)
- VARCHAR/CHAR            -> dictionary codes (int32) + host-side dictionary,
                             or fixed-width uint8 bytes [N, width] for device
                             substring matching (LIKE kernels)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class DataType:
    """Base class for SQL logical types."""

    name: str = field(init=False, default="unknown")

    @property
    def np_dtype(self):
        raise NotImplementedError

    def __str__(self) -> str:  # pragma: no cover - debugging aid
        return self.name


@dataclass(frozen=True)
class BigintType(DataType):
    name: str = field(init=False, default="bigint")

    @property
    def np_dtype(self):
        return np.int64


@dataclass(frozen=True)
class IntegerType(DataType):
    name: str = field(init=False, default="integer")

    @property
    def np_dtype(self):
        return np.int32


@dataclass(frozen=True)
class BooleanType(DataType):
    name: str = field(init=False, default="boolean")

    @property
    def np_dtype(self):
        return np.bool_


@dataclass(frozen=True)
class DoubleType(DataType):
    name: str = field(init=False, default="double")

    @property
    def np_dtype(self):
        return np.float64


@dataclass(frozen=True)
class DecimalType(DataType):
    """Short decimal: unscaled int64 value with static (precision, scale).

    Mirrors Trino's exact-decimal semantics (``spi/type/Decimals.java``)
    without Int128: TPC-H needs at most DECIMAL(15,2) columns and the engine
    widens intermediate precision like the reference's type-inference rules.
    """

    precision: int = 15
    scale: int = 2
    name: str = field(init=False, default="decimal")

    @property
    def np_dtype(self):
        return np.int64

    def __str__(self) -> str:
        return f"decimal({self.precision},{self.scale})"


@dataclass(frozen=True)
class DateType(DataType):
    name: str = field(init=False, default="date")

    @property
    def np_dtype(self):
        return np.int32


@dataclass(frozen=True)
class TimestampType(DataType):
    """Microseconds since epoch as int64.  ``precision`` is the declared
    fractional-second digits (reference: 5 timestamp variants in
    ``spi/type/`` — TIMESTAMP(0..12); micros bound ours at 6).  Physical
    layout is identical for every precision; rendering truncates."""

    precision: int = 6
    name: str = field(init=False, default="timestamp")

    @property
    def np_dtype(self):
        return np.int64

    def __str__(self) -> str:
        return f"timestamp({self.precision})" if self.precision != 6             else "timestamp"


@dataclass(frozen=True)
class TimestampTzType(DataType):
    """TIMESTAMP(p) WITH TIME ZONE.

    The reference packs (millisUtc, zoneKey) into one long
    (``spi/type/TimestampWithTimeZoneType``, ``spi/DateTimeEncoding.java``)
    — bit-packing is hostile to vector arithmetic, so the TPU layout keeps
    two dense arrays: the UTC instant in micros (``values``, int64) and the
    per-row zone offset in minutes (``values2``, int32).  Comparison,
    grouping, and ordering use the instant alone (reference semantics:
    ``TimestampWithTimeZoneOperators`` compares unpacked millis); the
    offset only affects rendering and field extraction."""

    precision: int = 3
    name: str = field(init=False, default="timestamp with time zone")

    @property
    def np_dtype(self):
        return np.int64

    def __str__(self) -> str:
        return (f"timestamp({self.precision}) with time zone"
                if self.precision != 3 else "timestamp with time zone")


@dataclass(frozen=True)
class IntervalDayTimeType(DataType):
    """INTERVAL DAY TO SECOND as microseconds int64 (reference:
    ``spi/type/IntervalDayTimeType`` — millis there, micros here to
    match the timestamp unit)."""

    name: str = field(init=False, default="interval day to second")

    @property
    def np_dtype(self):
        return np.int64


@dataclass(frozen=True)
class IntervalYearMonthType(DataType):
    """INTERVAL YEAR TO MONTH as whole months int64 (reference:
    ``spi/type/IntervalYearMonthType``)."""

    name: str = field(init=False, default="interval year to month")

    @property
    def np_dtype(self):
        return np.int64


@dataclass(frozen=True)
class VarcharType(DataType):
    """Variable-width string; physical layout chosen per column (dictionary
    codes or fixed-width bytes). ``length`` is the DDL bound (None=unbounded)."""

    length: Optional[int] = None
    name: str = field(init=False, default="varchar")

    @property
    def np_dtype(self):
        # logical accessor dtype when dictionary-encoded
        return np.int32

    def __str__(self) -> str:
        return f"varchar({self.length})" if self.length is not None else "varchar"


@dataclass(frozen=True)
class CharType(DataType):
    length: int = 1
    name: str = field(init=False, default="char")

    @property
    def np_dtype(self):
        return np.int32

    def __str__(self) -> str:
        return f"char({self.length})"


@dataclass(frozen=True)
class ArrayType(DataType):
    """ARRAY(element): fixed-capacity device layout — values ``[N, W]`` of
    the element's physical dtype + per-row lengths ``[N]`` (the static-shape
    redesign of the reference's offset-based ``spi/block/ArrayBlock.java``;
    W is the column's max cardinality, padded positions are masked)."""

    element: DataType = None
    name: str = field(init=False, default="array")

    @property
    def np_dtype(self):
        return self.element.np_dtype

    def __str__(self) -> str:
        return f"array({self.element})"


@dataclass(frozen=True)
class RowType(DataType):
    """ROW(name type, ...): anonymous-struct type.

    Physical layout is SHREDDED struct-of-arrays (the columnar engines'
    standard struct decomposition): a row-typed column ``r`` with fields
    ``x, y`` lives as independent device columns ``r.x`` and ``r.y`` —
    the TPU-first redesign of the reference's ``spi/block/RowBlock.java``
    (child blocks behind one object header).  Rows re-assemble only at
    the client edge (``data/column.py`` ROW kind)."""

    fields: Tuple[Tuple[str, DataType], ...] = ()
    name: str = field(init=False, default="row")

    @property
    def np_dtype(self):
        raise TypeError("row type has no single physical dtype (shredded)")

    def __str__(self) -> str:
        inner = ",".join(f"{n} {t}" for n, t in self.fields)
        return f"row({inner})"


@dataclass(frozen=True)
class MapType(DataType):
    """MAP(key, value): paired fixed-capacity layouts — key values
    ``[N, W]`` + map values ``[N, W]`` + lengths ``[N]`` (reference:
    ``spi/block/MapBlock.java`` flattened to two dense matrices)."""

    key: DataType = None
    value: DataType = None
    name: str = field(init=False, default="map")

    @property
    def np_dtype(self):
        return self.key.np_dtype

    def __str__(self) -> str:
        return f"map({self.key},{self.value})"


BIGINT = BigintType()
TIMESTAMP = TimestampType()
TIMESTAMP_TZ = TimestampTzType()
INTEGER = IntegerType()
BOOLEAN = BooleanType()
INTERVAL_DAY_TIME = IntervalDayTimeType()
INTERVAL_YEAR_MONTH = IntervalYearMonthType()
DOUBLE = DoubleType()
DATE = DateType()
VARCHAR = VarcharType()


def decimal(precision: int = 15, scale: int = 2) -> DecimalType:
    return DecimalType(precision, scale)


def varchar(length: Optional[int] = None) -> VarcharType:
    return VarcharType(length)


def char(length: int) -> CharType:
    return CharType(length)


def array(element: DataType) -> ArrayType:
    return ArrayType(element)


def map_(key: DataType, value: DataType) -> MapType:
    return MapType(key, value)


def is_array(t: DataType) -> bool:
    return isinstance(t, ArrayType)


def is_map(t: DataType) -> bool:
    return isinstance(t, MapType)


def is_string(t: DataType) -> bool:
    return isinstance(t, (VarcharType, CharType))


def is_numeric(t: DataType) -> bool:
    return isinstance(t, (BigintType, IntegerType, DoubleType, DecimalType))


def is_decimal(t: DataType) -> bool:
    return isinstance(t, DecimalType)


def is_long_decimal(t: DataType) -> bool:
    """DECIMAL(p>18): unscaled value exceeds int64 — stored as paired
    int64 words [N,2] (reference: ``spi/block/Int128ArrayBlock.java``)."""
    return isinstance(t, DecimalType) and t.precision > 18


def is_integral(t: DataType) -> bool:
    return isinstance(t, (BigintType, IntegerType))


def is_timestamp_tz(t: DataType) -> bool:
    return isinstance(t, TimestampTzType)


def is_row(t: DataType) -> bool:
    return isinstance(t, RowType)


def row(*fields) -> RowType:
    return RowType(tuple(fields))


def common_super_type(a: DataType, b: DataType) -> DataType:
    """Type unification for binary expressions (reference:
    ``sql/analyzer/TypeCoercion.java``)."""
    if a == b:
        return a
    if isinstance(a, DoubleType) or isinstance(b, DoubleType):
        return DOUBLE
    if is_decimal(a) or is_decimal(b):
        # integral+decimal -> decimal; decimal+decimal -> widest
        da = a if is_decimal(a) else DecimalType(19, 0)
        db = b if is_decimal(b) else DecimalType(19, 0)
        scale = max(da.scale, db.scale)
        ip = max(da.precision - da.scale, db.precision - db.scale)
        return DecimalType(min(ip + scale, 38), scale)
    if is_integral(a) and is_integral(b):
        return BIGINT
    if is_string(a) and is_string(b):
        return VARCHAR
    if isinstance(a, DateType) and isinstance(b, DateType):
        return DATE
    if isinstance(a, TimestampType) and isinstance(b, TimestampType):
        return TimestampType(precision=max(a.precision, b.precision))
    if isinstance(a, TimestampTzType) and isinstance(b, TimestampTzType):
        return TimestampTzType(precision=max(a.precision, b.precision))
    if {type(a), type(b)} <= {TimestampType, TimestampTzType}:
        # plain comparand is coerced to the instant (session zone = UTC)
        return a if isinstance(a, TimestampTzType) else b
    if {type(a), type(b)} <= {DateType, TimestampType}:
        return a if isinstance(a, TimestampType) else b
    if isinstance(a, IntervalDayTimeType) and \
            isinstance(b, IntervalDayTimeType):
        return INTERVAL_DAY_TIME
    if isinstance(a, IntervalYearMonthType) and \
            isinstance(b, IntervalYearMonthType):
        return INTERVAL_YEAR_MONTH
    raise TypeError(f"no common super type for {a} and {b}")


# Arithmetic result types for exact decimals, following Trino's
# DecimalOperators rules (add/sub: s=max(s1,s2); mul: s=s1+s2).
def decimal_add_type(a: DecimalType, b: DecimalType) -> DecimalType:
    scale = max(a.scale, b.scale)
    ip = max(a.precision - a.scale, b.precision - b.scale) + 1
    return DecimalType(min(ip + scale, 38), scale)


def decimal_mul_type(a: DecimalType, b: DecimalType) -> DecimalType:
    return DecimalType(min(a.precision + b.precision, 38), a.scale + b.scale)
