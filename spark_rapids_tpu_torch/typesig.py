"""Declarative per-operator type support (the counterpart of
``spark_rapids_tpu.typesig``, the reference's TypeChecks ``TypeSig``).

A ``TypeSig`` is an immutable set of type tags plus a decimal precision
bound, combined with ``+``/``-`` and checked with ``sig.support(dtype)``
(None, or the reason a type is refused). The port tags plans with
``ops.exprs.type_reason`` over the three signatures its rule table names
(``FLAT``, ``STRUCT``, ``NESTED``); this module is the same three as
type sets, which the support matrix (``tools.generate_supported_ops``,
``docs/torch/supported_ops.md``) renders and which
``tests/test_torch_typesig.py`` holds equal to the tagging, reason for
reason.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, Optional

from spark_rapids_tpu_torch.sql import types as T

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
ARRAY = "ARRAY"
MAP = "MAP"
STRUCT = "STRUCT"

_TAG_OF = {
    T.BooleanType: BOOLEAN, T.ByteType: BYTE, T.ShortType: SHORT,
    T.IntegerType: INT, T.LongType: LONG, T.FloatType: FLOAT,
    T.DoubleType: DOUBLE, T.DateType: DATE, T.TimestampType: TIMESTAMP,
    T.StringType: STRING, T.BinaryType: BINARY, T.DecimalType: DECIMAL,
    T.NullType: NULL, T.ArrayType: ARRAY, T.MapType: MAP,
    T.StructType: STRUCT,
}


def tag_of(dt: T.DataType) -> Optional[str]:
    for cls, tag in _TAG_OF.items():
        if isinstance(dt, cls):
            return tag
    return None


@dataclass(frozen=True)
class TypeSig:
    """Immutable set of supported type tags; ``max_decimal_precision``
    bounds DECIMAL support (0: no decimals)."""

    tags: FrozenSet[str] = frozenset()
    max_decimal_precision: int = 0

    def __add__(self, other: "TypeSig") -> "TypeSig":
        return TypeSig(self.tags | other.tags,
                       max(self.max_decimal_precision,
                           other.max_decimal_precision))

    def __sub__(self, other: "TypeSig") -> "TypeSig":
        return TypeSig(self.tags - other.tags, self.max_decimal_precision)

    def support(self, dt: T.DataType) -> Optional[str]:
        """None when supported, else the reason the type is refused."""
        tag = tag_of(dt)
        if tag is None:
            return f"unknown type {dt!r} is not supported"
        if tag == DECIMAL:
            if DECIMAL not in self.tags:
                return "decimal is not supported"
            if dt.precision > self.max_decimal_precision:
                return (f"decimal precision {dt.precision} exceeds max "
                        f"supported {self.max_decimal_precision}")
            return None
        if tag not in self.tags:
            return f"{tag.lower()} is not supported"
        if tag == ARRAY:
            r = self.support(dt.element_type)
            if r:
                return f"array element: {r}"
        if tag == STRUCT:
            for f in dt.fields:
                if tag_of(f.data_type) in (ARRAY, MAP, STRUCT):
                    return (f"struct field {f.name}: nested types in "
                            "structs are not supported")
                r = self.support(f.data_type)
                if r:
                    return f"struct field {f.name}: {r}"
        return None

    def render(self) -> str:
        """The matrix cell: the sorted tags, as the JAX package's matrix
        prints them (its cell never shows the decimal bound; the doc
        states it once, above the tables)."""
        return ", ".join(sorted(self.tags)) or "none"


def _sig(*tags: str, decimal_precision: int = 0) -> TypeSig:
    return TypeSig(frozenset(tags), decimal_precision)


integral = _sig(BYTE, SHORT, INT, LONG)
fp = _sig(FLOAT, DOUBLE)
numeric = integral + fp
DECIMAL_128 = _sig(DECIMAL, decimal_precision=38)
# every flat type a device column holds
common = numeric + DECIMAL_128 + _sig(BOOLEAN, DATE, TIMESTAMP, STRING,
                                      BINARY)
# a struct of flat fields rides through exchanges, sorts and aggregates
common_struct = common + _sig(STRUCT)
# arrays and structs pass through projections, filters and explode
common_nested = common + _sig(ARRAY, STRUCT)

# the rule table's signature names (``ops.exprs.FLAT``/``STRUCT``/
# ``NESTED``) -> their type sets
BY_NAME: Dict[str, TypeSig] = {"flat": common, "struct": common_struct,
                               "nested": common_nested}


def sig_of(name: str) -> TypeSig:
    return BY_NAME[name]
