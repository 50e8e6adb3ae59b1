"""Logical dtype system for cudf_tpu_torch.

Carried over unchanged from ``cudf_tpu/core/dtypes.py`` (it depends on
numpy only), plus :func:`torch_dtype`, the storage dtype of a column's
``torch.Tensor`` buffer.

A ``DType`` is the *logical* type of a column (libcudf's ``type_id`` +
``data_type``, cpp/include/cudf/types.hpp:184-216).  The *physical*
storage dtype can differ: timestamps and durations are stored as int64
ticks, dictionary columns store int32 codes, strings store (int64
offsets, uint8 chars) buffers.  DType is frozen and hashable.
"""

from __future__ import annotations

import enum
import re
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import numpy as np
import torch


class TypeId(enum.Enum):
    EMPTY = 0
    INT8 = 1
    INT16 = 2
    INT32 = 3
    INT64 = 4
    UINT8 = 5
    UINT16 = 6
    UINT32 = 7
    UINT64 = 8
    FLOAT32 = 9
    FLOAT64 = 10
    BOOL8 = 11
    TIMESTAMP_DAYS = 12
    TIMESTAMP_SECONDS = 13
    TIMESTAMP_MILLISECONDS = 14
    TIMESTAMP_MICROSECONDS = 15
    TIMESTAMP_NANOSECONDS = 16
    DURATION_DAYS = 17
    DURATION_SECONDS = 18
    DURATION_MILLISECONDS = 19
    DURATION_MICROSECONDS = 20
    DURATION_NANOSECONDS = 21
    DICTIONARY32 = 22
    STRING = 23
    LIST = 24
    DECIMAL32 = 25
    DECIMAL64 = 26
    DECIMAL128 = 27
    STRUCT = 28
    INTERVAL = 29


_NUMERIC_IDS = frozenset(
    {
        TypeId.INT8,
        TypeId.INT16,
        TypeId.INT32,
        TypeId.INT64,
        TypeId.UINT8,
        TypeId.UINT16,
        TypeId.UINT32,
        TypeId.UINT64,
        TypeId.FLOAT32,
        TypeId.FLOAT64,
    }
)
_INTEGER_IDS = frozenset(
    {
        TypeId.INT8,
        TypeId.INT16,
        TypeId.INT32,
        TypeId.INT64,
        TypeId.UINT8,
        TypeId.UINT16,
        TypeId.UINT32,
        TypeId.UINT64,
    }
)
_FLOAT_IDS = frozenset({TypeId.FLOAT32, TypeId.FLOAT64})
_TIMESTAMP_IDS = frozenset(
    {
        TypeId.TIMESTAMP_DAYS,
        TypeId.TIMESTAMP_SECONDS,
        TypeId.TIMESTAMP_MILLISECONDS,
        TypeId.TIMESTAMP_MICROSECONDS,
        TypeId.TIMESTAMP_NANOSECONDS,
    }
)
_DURATION_IDS = frozenset(
    {
        TypeId.DURATION_DAYS,
        TypeId.DURATION_SECONDS,
        TypeId.DURATION_MILLISECONDS,
        TypeId.DURATION_MICROSECONDS,
        TypeId.DURATION_NANOSECONDS,
    }
)

# TypeId -> numpy storage dtype (what the column's buffer holds)
_STORAGE: dict = {
    TypeId.INT8: np.dtype("int8"),
    TypeId.INT16: np.dtype("int16"),
    TypeId.INT32: np.dtype("int32"),
    TypeId.INT64: np.dtype("int64"),
    TypeId.UINT8: np.dtype("uint8"),
    TypeId.UINT16: np.dtype("uint16"),
    TypeId.UINT32: np.dtype("uint32"),
    TypeId.UINT64: np.dtype("uint64"),
    TypeId.FLOAT32: np.dtype("float32"),
    TypeId.FLOAT64: np.dtype("float64"),
    TypeId.BOOL8: np.dtype("bool"),
    TypeId.TIMESTAMP_DAYS: np.dtype("int32"),
    TypeId.TIMESTAMP_SECONDS: np.dtype("int64"),
    TypeId.TIMESTAMP_MILLISECONDS: np.dtype("int64"),
    TypeId.TIMESTAMP_MICROSECONDS: np.dtype("int64"),
    TypeId.TIMESTAMP_NANOSECONDS: np.dtype("int64"),
    TypeId.DURATION_DAYS: np.dtype("int32"),
    TypeId.DURATION_SECONDS: np.dtype("int64"),
    TypeId.DURATION_MILLISECONDS: np.dtype("int64"),
    TypeId.DURATION_MICROSECONDS: np.dtype("int64"),
    TypeId.DURATION_NANOSECONDS: np.dtype("int64"),
    TypeId.DICTIONARY32: np.dtype("int32"),
    TypeId.DECIMAL32: np.dtype("int32"),
    TypeId.DECIMAL64: np.dtype("int64"),
    # DECIMAL128 stores int64 reps (precision <= 18), as in the reference
    TypeId.DECIMAL128: np.dtype("int64"),
}

# numpy storage dtype -> torch dtype of the column's tensor buffer
_TORCH: dict = {
    np.dtype("int8"): torch.int8,
    np.dtype("int16"): torch.int16,
    np.dtype("int32"): torch.int32,
    np.dtype("int64"): torch.int64,
    np.dtype("uint8"): torch.uint8,
    np.dtype("uint16"): torch.uint16,
    np.dtype("uint32"): torch.uint32,
    np.dtype("uint64"): torch.uint64,
    np.dtype("float32"): torch.float32,
    np.dtype("float64"): torch.float64,
    np.dtype("bool"): torch.bool,
}

_TIME_UNIT: dict = {
    TypeId.TIMESTAMP_SECONDS: "s",
    TypeId.TIMESTAMP_MILLISECONDS: "ms",
    TypeId.TIMESTAMP_MICROSECONDS: "us",
    TypeId.TIMESTAMP_NANOSECONDS: "ns",
    TypeId.DURATION_SECONDS: "s",
    TypeId.DURATION_MILLISECONDS: "ms",
    TypeId.DURATION_MICROSECONDS: "us",
    TypeId.DURATION_NANOSECONDS: "ns",
}


@dataclass(frozen=True)
class DType:
    """Logical column type.  Frozen + hashable → usable as a static jit arg.

    ``scale`` is used by decimal types (power-of-10 exponent, matching
    cudf's fixed_point scale semantics, fixed_point.hpp:37).
    ``fields`` is used by STRUCT (tuple of (name, DType)).
    ``value_type`` is used by LIST and DICTIONARY32 (the child/category type).
    """

    id: TypeId
    scale: int = 0
    fields: Tuple[Tuple[str, "DType"], ...] = field(default=())
    value_type: Optional["DType"] = None
    # IANA zone name for tz-aware timestamps (ticks are always UTC epochs,
    # like Arrow/cudf; tz is presentation metadata used by dt accessors)
    tz: Optional[str] = None
    # provenance marker: column came from a pandas nullable extension dtype
    # (Int64/UInt8/boolean/Float64...) — to_pandas round-trips it as such
    # instead of degrading int+nulls to float64/NaN
    nullable: bool = False
    # provenance marker: column came from a pandas ArrowDtype
    # ("uint64[pyarrow]" ...) — to_pandas round-trips as ArrowExtensionArray
    arrow: bool = False
    # a DICTIONARY32 column's categories are ordered (pandas' ordered
    # Categorical): ``cat.as_ordered`` sets it, ``to_pandas`` keeps it
    ordered: bool = False

    # ---- classification -------------------------------------------------
    @property
    def is_numeric(self) -> bool:
        return self.id in _NUMERIC_IDS

    @property
    def is_integer(self) -> bool:
        return self.id in _INTEGER_IDS

    @property
    def is_signed_integer(self) -> bool:
        return self.id in (TypeId.INT8, TypeId.INT16, TypeId.INT32, TypeId.INT64)

    @property
    def is_unsigned_integer(self) -> bool:
        return self.is_integer and not self.is_signed_integer

    @property
    def is_float(self) -> bool:
        return self.id in _FLOAT_IDS

    @property
    def is_bool(self) -> bool:
        return self.id == TypeId.BOOL8

    @property
    def is_timestamp(self) -> bool:
        return self.id in _TIMESTAMP_IDS

    @property
    def is_duration(self) -> bool:
        return self.id in _DURATION_IDS

    @property
    def is_temporal(self) -> bool:
        return self.is_timestamp or self.is_duration

    @property
    def is_string(self) -> bool:
        return self.id == TypeId.STRING

    @property
    def is_dictionary(self) -> bool:
        return self.id == TypeId.DICTIONARY32

    @property
    def is_decimal(self) -> bool:
        return self.id in (TypeId.DECIMAL32, TypeId.DECIMAL64, TypeId.DECIMAL128)

    @property
    def is_nested(self) -> bool:
        return self.id in (TypeId.LIST, TypeId.STRUCT)

    @property
    def is_list(self) -> bool:
        return self.id == TypeId.LIST

    @property
    def is_struct(self) -> bool:
        return self.id == TypeId.STRUCT

    @property
    def is_fixed_width(self) -> bool:
        return self.id in _STORAGE

    @property
    def time_unit(self) -> Optional[str]:
        return _TIME_UNIT.get(self.id)

    # ---- numpy duck-typing (pandas' asserters/validators read these) ----
    @property
    def kind(self) -> str:
        try:
            return self.to_numpy().kind
        except TypeError:
            return "O"

    @property
    def name(self) -> str:
        return repr(self)

    @property
    def names(self):
        """numpy structured-dtype field names: always None (flat dtypes);
        read by numpy/pandas validation code paths."""
        return None

    @property
    def type(self):
        """scalar type constructor, numpy-dtype style."""
        try:
            return self.to_numpy().type
        except TypeError:
            return object

    # ---- storage mapping -------------------------------------------------
    @property
    def storage(self) -> np.dtype:
        """numpy dtype of the physical buffer holding this column's data."""
        try:
            return _STORAGE[self.id]
        except KeyError:
            raise TypeError(f"{self} has no single storage buffer") from None

    @property
    def torch_storage(self) -> torch.dtype:
        """torch dtype of the tensor holding this column's data."""
        return _TORCH[self.storage]

    def to_numpy(self) -> np.dtype:
        """The user-facing numpy dtype (datetime64/timedelta64 for temporal)."""
        if self.is_timestamp:
            unit = _TIME_UNIT.get(self.id, "D" if self.id == TypeId.TIMESTAMP_DAYS else None)
            return np.dtype(f"datetime64[{unit}]")
        if self.is_duration:
            unit = _TIME_UNIT.get(self.id, "D" if self.id == TypeId.DURATION_DAYS else None)
            return np.dtype(f"timedelta64[{unit}]")
        if self.is_string:
            return np.dtype(object)
        return self.storage

    @property
    def itemsize(self) -> int:
        return self.storage.itemsize

    def __repr__(self) -> str:
        if self.arrow:
            base = _CANONICAL_NAMES.get(self.id, self.id.name.lower())
            if self.is_string:
                base = "string"
            if self.is_timestamp:
                tz = "" if self.tz is None else f", tz={self.tz}"
                base = f"timestamp[{self.time_unit or 'ns'}{tz}]"
            return f"{base}[pyarrow]"
        if self.nullable:
            if self.id == TypeId.BOOL8:
                return "boolean"
            if self.is_string:
                return "string"
            base = _CANONICAL_NAMES.get(self.id, self.id.name.lower())
            return base.title().replace("Uint", "UInt")  # pandas-style Int64/UInt8
        if self.tz is not None:
            return f"datetime64[{self.time_unit or 'ns'}, {self.tz}]"
        if self.is_decimal:
            return f"{self.id.name.lower()}(scale={self.scale})"
        if self.id == TypeId.LIST:
            return f"list<{self.value_type!r}>"
        if self.id == TypeId.STRUCT:
            inner = ", ".join(f"{n}: {t!r}" for n, t in self.fields)
            return f"struct<{inner}>"
        if self.id == TypeId.DICTIONARY32:
            return f"dictionary<{self.value_type!r}>"
        return _CANONICAL_NAMES.get(self.id, self.id.name.lower())


_CANONICAL_NAMES = {
    TypeId.INT8: "int8",
    TypeId.INT16: "int16",
    TypeId.INT32: "int32",
    TypeId.INT64: "int64",
    TypeId.UINT8: "uint8",
    TypeId.UINT16: "uint16",
    TypeId.UINT32: "uint32",
    TypeId.UINT64: "uint64",
    TypeId.FLOAT32: "float32",
    TypeId.FLOAT64: "float64",
    TypeId.BOOL8: "bool",
    TypeId.STRING: "str",
    TypeId.TIMESTAMP_SECONDS: "datetime64[s]",
    TypeId.TIMESTAMP_MILLISECONDS: "datetime64[ms]",
    TypeId.TIMESTAMP_MICROSECONDS: "datetime64[us]",
    TypeId.TIMESTAMP_NANOSECONDS: "datetime64[ns]",
    TypeId.DURATION_SECONDS: "timedelta64[s]",
    TypeId.DURATION_MILLISECONDS: "timedelta64[ms]",
    TypeId.DURATION_MICROSECONDS: "timedelta64[us]",
    TypeId.DURATION_NANOSECONDS: "timedelta64[ns]",
}

# Canonical singletons
INT8 = DType(TypeId.INT8)
INT16 = DType(TypeId.INT16)
INT32 = DType(TypeId.INT32)
INT64 = DType(TypeId.INT64)
UINT8 = DType(TypeId.UINT8)
UINT16 = DType(TypeId.UINT16)
UINT32 = DType(TypeId.UINT32)
UINT64 = DType(TypeId.UINT64)
FLOAT32 = DType(TypeId.FLOAT32)
FLOAT64 = DType(TypeId.FLOAT64)
BOOL8 = DType(TypeId.BOOL8)
STRING = DType(TypeId.STRING)
TIMESTAMP_S = DType(TypeId.TIMESTAMP_SECONDS)
TIMESTAMP_MS = DType(TypeId.TIMESTAMP_MILLISECONDS)
TIMESTAMP_US = DType(TypeId.TIMESTAMP_MICROSECONDS)
TIMESTAMP_NS = DType(TypeId.TIMESTAMP_NANOSECONDS)
DURATION_S = DType(TypeId.DURATION_SECONDS)
DURATION_MS = DType(TypeId.DURATION_MILLISECONDS)
DURATION_US = DType(TypeId.DURATION_MICROSECONDS)
DURATION_NS = DType(TypeId.DURATION_NANOSECONDS)


def list_dtype(value_type: DType) -> DType:
    return DType(TypeId.LIST, value_type=value_type)


def struct_dtype(fields) -> DType:
    return DType(TypeId.STRUCT, fields=tuple((str(n), dtype(t)) for n, t in fields))


def dictionary_dtype(value_type: DType = STRING) -> DType:
    return DType(TypeId.DICTIONARY32, value_type=value_type)


def decimal_dtype(scale: int = 0, bits: int = 64) -> DType:
    tid = {32: TypeId.DECIMAL32, 64: TypeId.DECIMAL64, 128: TypeId.DECIMAL128}[bits]
    return DType(tid, scale=scale)


_FROM_NP_KIND_UNIT = {
    ("M", "s"): TIMESTAMP_S,
    ("M", "ms"): TIMESTAMP_MS,
    ("M", "us"): TIMESTAMP_US,
    ("M", "ns"): TIMESTAMP_NS,
    ("m", "s"): DURATION_S,
    ("m", "ms"): DURATION_MS,
    ("m", "us"): DURATION_US,
    ("m", "ns"): DURATION_NS,
}

_STR_ALIASES = {
    "str": STRING,
    "string": STRING,
    "object": STRING,
    "O": STRING,
    "unicode": STRING,
    "category": dictionary_dtype(None),   # value type follows the source
    "bool": BOOL8,
    # pandas: the string "boolean" names the NULLABLE extension dtype
    "boolean": DType(TypeId.BOOL8, nullable=True),
    "int": INT64,
    "uint": UINT64,
    "float": FLOAT64,
    "double": FLOAT64,
    "datetime64": TIMESTAMP_NS,
    "timedelta64": DURATION_NS,
}


# a decimal dtype's own name ("decimal64(scale=-2)"), as ``repr`` gives it
_DECIMAL_NAME = re.compile(r"decimal(32|64|128)\(scale=(-?\d+)\)")


def dtype(obj: Any) -> DType:
    """Coerce numpy/pandas/python dtype-likes to a DType."""
    if isinstance(obj, DType):
        return obj
    if obj is None:
        return FLOAT64
    if obj is int:
        return INT64
    if obj is float:
        return FLOAT64
    if obj is bool:
        return BOOL8
    if obj is str:
        return STRING
    if isinstance(obj, str):
        alias = _STR_ALIASES.get(obj)
        if alias is not None:
            return alias
        _NULLABLE_NAMES = {
            "Int8": TypeId.INT8, "Int16": TypeId.INT16, "Int32": TypeId.INT32,
            "Int64": TypeId.INT64, "UInt8": TypeId.UINT8,
            "UInt16": TypeId.UINT16, "UInt32": TypeId.UINT32,
            "UInt64": TypeId.UINT64, "Float32": TypeId.FLOAT32,
            "Float64": TypeId.FLOAT64, "boolean": TypeId.BOOL8,
        }
        if obj in _NULLABLE_NAMES:
            return DType(_NULLABLE_NAMES[obj], nullable=True)
        if obj.startswith("datetime64[") and "," in obj:
            unit, tzname = obj[len("datetime64["):-1].split(",", 1)
            base = _FROM_NP_KIND_UNIT.get(("M", unit.strip()), TIMESTAMP_NS)
            return DType(base.id, tz=tzname.strip())
        dec = _DECIMAL_NAME.fullmatch(obj)
        if dec:
            return decimal_dtype(int(dec.group(2)), int(dec.group(1)))
        if obj.endswith("[pyarrow]"):
            base = dtype(obj[:-len("[pyarrow]")].strip())
            return DType(base.id, tz=base.tz, arrow=True)
        obj = np.dtype(obj)
    # pandas extension dtypes
    tname = type(obj).__name__
    if tname == "DatetimeTZDtype":
        base = _FROM_NP_KIND_UNIT.get(("M", obj.unit), TIMESTAMP_NS)
        return DType(base.id, tz=str(obj.tz))
    _NULLABLE_EXT = {
        "Int8Dtype": TypeId.INT8, "Int16Dtype": TypeId.INT16,
        "Int32Dtype": TypeId.INT32, "Int64Dtype": TypeId.INT64,
        "UInt8Dtype": TypeId.UINT8, "UInt16Dtype": TypeId.UINT16,
        "UInt32Dtype": TypeId.UINT32, "UInt64Dtype": TypeId.UINT64,
        "Float32Dtype": TypeId.FLOAT32, "Float64Dtype": TypeId.FLOAT64,
        "BooleanDtype": TypeId.BOOL8,
    }
    if tname in _NULLABLE_EXT:
        return DType(_NULLABLE_EXT[tname], nullable=True)
    if tname == "CategoricalDtype":
        cats = getattr(obj, "categories", None)
        vt = dtype(cats.dtype) if cats is not None and len(cats) else None
        return dictionary_dtype(vt)
    if tname == "StringDtype":
        # "string"/"string[pyarrow]" (pd.NA) keep extension provenance;
        # the pandas-3 default "str" (na_value=nan) maps to plain STRING
        return DType(TypeId.STRING, nullable=str(obj).startswith("string"))
    if tname == "ArrowDtype":
        pa_type = obj.pyarrow_dtype
        if str(pa_type).startswith("decimal"):
            return decimal_dtype(-pa_type.scale, 128)
        if "string" in str(pa_type):
            return DType(TypeId.STRING, arrow=True)
        base = dtype(obj.numpy_dtype)
        tz = getattr(pa_type, "tz", None)
        return DType(base.id, tz=None if tz is None else str(tz), arrow=True)
    npd = np.dtype(obj) if not isinstance(obj, np.dtype) else obj
    if npd.kind in ("M", "m"):
        unit = np.datetime_data(npd)[0]
        if unit == "D":
            return DType(TypeId.TIMESTAMP_DAYS if npd.kind == "M" else TypeId.DURATION_DAYS)
        key = (npd.kind, unit)
        if key in _FROM_NP_KIND_UNIT:
            return _FROM_NP_KIND_UNIT[key]
        # generic datetime64 with no unit → ns
        return TIMESTAMP_NS if npd.kind == "M" else DURATION_NS
    if npd.kind in ("U", "S", "O"):
        return STRING
    for tid, st in _STORAGE.items():
        if tid in _TIMESTAMP_IDS or tid in _DURATION_IDS:
            continue
        if tid in (TypeId.DICTIONARY32, TypeId.DECIMAL32, TypeId.DECIMAL64):
            continue
        if st == npd:
            return DType(tid)
    raise TypeError(f"unsupported dtype: {obj!r}")


def from_torch(t: torch.dtype) -> DType:
    """The plain logical DType of a torch storage dtype."""
    for npd, td in _TORCH.items():
        if td == t:
            return dtype(npd)
    raise TypeError(f"unsupported torch dtype: {t}")


def common_dtype(a: DType, b: DType) -> DType:
    """numpy-style type promotion between two logical dtypes."""
    if a == b:
        return a
    if a.is_numeric and b.is_numeric or (a.is_bool or b.is_bool):
        return dtype(np.promote_types(a.storage, b.storage))
    if a.is_timestamp and b.is_timestamp or a.is_duration and b.is_duration:
        # finer unit wins
        order = ["s", "ms", "us", "ns"]
        ua, ub = a.time_unit or "s", b.time_unit or "s"
        unit = ua if order.index(ua) >= order.index(ub) else ub
        base = "TIMESTAMP" if a.is_timestamp else "DURATION"
        return DType(TypeId[f"{base}_{_UNIT_NAME[unit]}"])
    if a.is_timestamp and b.is_duration:
        return a
    if a.is_duration and b.is_timestamp:
        return b
    if a.is_string and b.is_string:
        return STRING
    raise TypeError(f"no common dtype for {a} and {b}")


_UNIT_NAME = {"s": "SECONDS", "ms": "MILLISECONDS", "us": "MICROSECONDS", "ns": "NANOSECONDS"}


def unit_dtype(kind: str, unit: str) -> DType:
    """kind in {'M','m'} and numpy unit → temporal DType."""
    base = "TIMESTAMP" if kind == "M" else "DURATION"
    return DType(TypeId[f"{base}_{_UNIT_NAME[unit]}"])
