"""Logical column types for the TPU columnar engine.

Port copy of ``nds_tpu/engine/types.py``: it imports nothing of ``nds_tpu``.

The reference expresses schemas as PySpark ``StructType``s
(`nds/nds_schema.py:49-568`, `nds-h/nds_h_schema.py:36-148`) and toggles
DecimalType vs DoubleType via ``use_decimal`` (`nds/nds_schema.py:43-47`).
Here the logical types are engine-owned and chosen for how they lay out on
TPU:

- integers      -> int32 where the domain fits (TPU-native), int64 otherwise
- DECIMAL(p,s)  -> scaled int64 (exact; reference's use_decimal=True), or
                   float when the config enables floats mode (reference's
                   --floats / use_decimal=False epsilon path)
- DATE          -> int32 days since 1970-01-01 (epoch days); civil-date
                   fields are computed with integer ops on device
- CHAR/VARCHAR  -> dictionary-encoded: int32 codes on device, the code
                   order equals lexicographic value order so comparisons
                   and ORDER BY work directly on codes; the value
                   dictionary stays on host
- IDENTIFIER    -> join keys; int64 by default (sr_ticket_number-style
                   overflow rationale, `nds/nds_schema.py:328-331`)

Nothing here depends on jax; this module is shared by the CPU oracle and
the device engine.
"""

from __future__ import annotations

from dataclasses import dataclass, field


class DType:
    """Base logical type. Instances are immutable and hashable."""

    name: str = "dtype"

    def __repr__(self) -> str:
        return self.name

    def __eq__(self, other) -> bool:
        return repr(self) == repr(other)

    def __hash__(self) -> int:
        return hash(repr(self))


class IntType(DType):
    def __init__(self, bits: int = 32) -> None:
        assert bits in (8, 16, 32, 64)
        self.bits = bits
        self.name = f"int{bits}"


class FloatType(DType):
    def __init__(self, bits: int = 64) -> None:
        assert bits in (32, 64)
        self.bits = bits
        self.name = f"float{bits}"


class DecimalType(DType):
    """Exact decimal; physically a scaled int64 unless floats mode."""

    def __init__(self, precision: int, scale: int) -> None:
        self.precision = precision
        self.scale = scale
        self.name = f"decimal({precision},{scale})"


class DateType(DType):
    name = "date"


class StringType(DType):
    """Dictionary-encoded string; length arg kept for schema fidelity."""

    def __init__(self, length: int | None = None, fixed: bool = False) -> None:
        self.length = length
        self.fixed = fixed
        kind = "char" if fixed else "varchar"
        self.name = f"{kind}({length})" if length is not None else "string"


class BoolType(DType):
    name = "bool"


INT32 = IntType(32)
INT64 = IntType(64)
FLOAT32 = FloatType(32)
FLOAT64 = FloatType(64)
DATE = DateType()
STRING = StringType()
BOOL = BoolType()


def char(n: int) -> StringType:
    return StringType(n, fixed=True)


def varchar(n: int) -> StringType:
    return StringType(n, fixed=False)


def decimal(p: int, s: int) -> DecimalType:
    return DecimalType(p, s)


def is_numeric(t: DType) -> bool:
    return isinstance(t, (IntType, FloatType, DecimalType))


@dataclass(frozen=True)
class Field:
    name: str
    dtype: DType
    nullable: bool = True


@dataclass
class Schema:
    fields: list[Field] = field(default_factory=list)

    @classmethod
    def of(cls, *cols: tuple) -> "Schema":
        fs = []
        for c in cols:
            name, dtype = c[0], c[1]
            nullable = c[2] if len(c) > 2 else True
            fs.append(Field(name, dtype, nullable))
        return cls(fs)

    @property
    def names(self) -> list[str]:
        return [f.name for f in self.fields]

    def field(self, name: str) -> Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        return any(f.name == name for f in self.fields)

    def __iter__(self):
        return iter(self.fields)

    def __len__(self) -> int:
        return len(self.fields)
