"""Column — a columnar buffer over ``torch.Tensor``s.

Port of ``cudf_tpu/core/column.py`` for these layouts:

- fixed width (numeric, bool): ``data`` is a 1-D tensor in the storage
  dtype;
- temporal (timestamps and durations in s, ms, us or ns): ``data`` holds
  int64 ticks, the unit is the ``DType``'s;
- STRING: ``data`` is a uint8 tensor of the UTF-8 bytes of every row and
  ``offsets`` an int64[n + 1] tensor, row i being
  ``data[offsets[i]:offsets[i + 1]]``;
- DICTIONARY32: ``data`` holds int32 codes and ``children`` one column,
  the dictionary's keys (STRING or numeric, no nulls);
- LIST: no ``data``, ``offsets`` int64[n + 1] starting at 0 and one
  child column, the values of every row one after another (Arrow's list
  layout; row i is ``child[offsets[i]:offsets[i + 1]]``);
- STRUCT: no ``data``, one child column a field, each of the column's
  length, and the row mask in ``validity`` (a field's own nulls stay in
  the field);
- DECIMAL32/64/128: ``data`` holds the unscaled values (int32, int64),
  the value being ``data * 10 ** dtype.scale`` (libcudf's fixed_point).
  A DECIMAL128 column whose values pass int64 holds two limbs: ``data``
  the low 64 bits (as int64 bits) and one child, the high int64 limb
  (``ops/decimal128.py``).

``validity`` is a ``bool`` tensor of the column's length or None (all
valid).  A numeric or bool dtype may carry pandas' nullable provenance
(``Int64``, ``boolean``, ``Float32`` ...): the layout is the same, and
``to_pandas_array`` gives the masked pandas array back; so may a STRING
dtype (pandas' ``string``, pd.NA for null) and any dtype may carry Arrow
provenance (``int64[pyarrow]``, ``string[pyarrow]`` ...: an
``ArrowExtensionArray`` back).  A tz-aware timestamp holds UTC ticks and
its zone in ``DType.tz``, as Arrow does.  A day-unit timestamp or
duration (numpy's ``datetime64[D]`` / ``timedelta64[D]``, Arrow's
``date32``) holds int32 days; the ``dt`` fields, casts and comparisons
read it as the same instants in seconds (``ops/datetime.py``
``days_as_seconds``), as pandas, which has no day unit, holds them.

A column lives where its tensors live, its dictionary's keys included.
Nothing here picks a device: constructors from host data take
``device=`` explicitly.  A column is never modified after it is built,
so it may cache what it derives from itself (a STRING column's Python
strings, a dictionary's key ranks) in ``_cache``.
"""

from __future__ import annotations

import datetime as _datetime
import decimal as _pydec
import numbers
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from cudf_tpu_torch.core import bitmask as bm
from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.dtypes import DType

_UNITS = ("s", "ms", "us", "ns")
_DAY_IDS = (dt.TypeId.TIMESTAMP_DAYS, dt.TypeId.DURATION_DAYS)
_BEYOND = "ROADMAP.md, beyond the reference"


def _check_supported(dtype: DType) -> None:
    if dtype.is_numeric or dtype.is_bool or dtype.is_string or dtype.is_dictionary or \
            dtype.is_nested or dtype.is_decimal:
        return
    if dtype.is_temporal and dtype.time_unit in _UNITS and (dtype.tz is None
                                                            or dtype.is_timestamp):
        return
    if dtype.id in _DAY_IDS and dtype.tz is None:
        return
    raise NotImplementedError(
        f"column dtype {dtype!r}: interval, period and sparse columns are {_BEYOND}")


def is_null_scalar(v) -> bool:
    """None, NaN, NaT, pandas NA (the reference's ``_is_null``)."""
    if v is None:
        return True
    if isinstance(v, (float, np.floating)) and v != v:
        return True
    if isinstance(v, (np.datetime64, np.timedelta64)) and np.isnat(v):
        return True
    return type(v).__name__ in ("NAType", "_NAType", "NaTType")


def infer_dtype(values: Sequence[Any]) -> DType:
    """The column dtype of host scalars (the reference's
    ``_infer_dtype``): strings, temporals, then float over int over bool."""
    kinds = set()
    for v in values:
        if isinstance(v, str):
            return dt.STRING
        if isinstance(v, _pydec.Decimal):
            return dt.decimal_dtype(int(v.as_tuple().exponent))
        if isinstance(v, (np.datetime64, np.timedelta64)):
            unit = np.datetime_data(v.dtype)[0]
            return dt.unit_dtype("M" if isinstance(v, np.datetime64) else "m",
                                 unit if unit in _UNITS else "s")
        if isinstance(v, _datetime.datetime):
            return dt.TIMESTAMP_NS
        if isinstance(v, _datetime.timedelta):
            return dt.DURATION_NS
        if isinstance(v, (bool, np.bool_)):
            kinds.add("b")
        elif isinstance(v, (int, np.integer)):
            kinds.add("i")
        elif isinstance(v, (float, np.floating)):
            kinds.add("f")
        else:
            raise TypeError(f"cannot infer a column dtype from {type(v).__name__}")
    if "f" in kinds:
        return dt.FLOAT64
    if "i" in kinds:
        return dt.INT64
    return dt.BOOL8 if kinds else dt.FLOAT64


def to_ticks(value, dtype: DType) -> int:
    """A host timestamp or duration (numpy's, the standard library's or
    pandas') as int ticks of ``dtype``'s unit."""
    if hasattr(value, "to_datetime64"):          # pandas' Timestamp, to the ns
        value = value.to_datetime64()
    elif hasattr(value, "to_timedelta64"):       # pandas' Timedelta
        value = value.to_timedelta64()
    elif isinstance(value, _datetime.datetime):
        value = np.datetime64(value)
    elif isinstance(value, _datetime.timedelta):
        value = np.timedelta64(value)
    if isinstance(value, (np.datetime64, np.timedelta64)):
        return int(value.astype(dtype.to_numpy()).astype(np.int64))
    return int(value)


# At most this many host values are matched by one equality pass each
# (``isin``, ``replace``) rather than by a search.
FEW_VALUES = 16


def plain_fixed(dtype: DType) -> bool:
    """Fixed-width dtypes whose values PyTorch compares on both devices."""
    return (dtype.is_numeric or dtype.is_bool or dtype.is_temporal) and \
        dtype.torch_storage not in (torch.uint16, torch.uint32, torch.uint64)


def holds(dtype: DType, value) -> bool:
    """Whether a column of ``dtype`` holds the host scalar without a change
    of dtype (pandas keeps the dtype then).  A timestamp column holds
    numpy's, the standard library's and pandas' timestamps without a time
    zone; a duration column their durations."""
    if isinstance(value, _datetime.datetime):
        return dtype.is_timestamp and value.tzinfo is None
    if isinstance(value, np.datetime64):
        return dtype.is_timestamp
    if isinstance(value, (np.timedelta64, _datetime.timedelta)):   # numpy's is Integral
        return dtype.is_duration
    if isinstance(value, (bool, np.bool_)):
        return dtype.is_bool
    if isinstance(value, numbers.Integral):
        if not dtype.is_integer:
            return dtype.is_float
        info = np.iinfo(dtype.storage)
        return info.min <= int(value) <= info.max
    if isinstance(value, numbers.Real):
        return dtype.is_float or (dtype.is_integer and float(value).is_integer()
                                  and np.isfinite(value))
    return isinstance(value, str) and (dtype.is_string or dtype.is_dictionary)


_NULLABLE_PANDAS = frozenset(f"{k}Dtype" for k in (
    "Int8", "Int16", "Int32", "Int64", "UInt8", "UInt16", "UInt32", "UInt64", "Boolean",
    "Float32", "Float64"))


def _encode(strings: Sequence[Optional[str]]):
    enc = [("" if s is None else str(s)).encode("utf-8") for s in strings]
    offsets = np.zeros(len(enc) + 1, np.int64)
    np.cumsum([len(b) for b in enc], out=offsets[1:])
    return np.frombuffer(b"".join(enc), np.uint8).copy(), offsets


def _missing(v) -> bool:
    """A null among nested host values (a list or dict is never null)."""
    return not isinstance(v, (list, tuple, np.ndarray, dict)) and is_null_scalar(v)


def host_layout(values: Sequence[Any], want: Optional[DType] = None) -> Optional[str]:
    """"list", "struct" or "decimal" when host values (or ``want``) call
    for that layout, else None."""
    if want is not None:
        return "list" if want.is_list else "struct" if want.is_struct else \
            "decimal" if want.is_decimal else None
    for v in values:
        if isinstance(v, (list, tuple, np.ndarray)):
            return "list"
        if isinstance(v, dict):
            return "struct"
        if isinstance(v, _pydec.Decimal):
            return "decimal"
    return None


def distinct_bytes(buffers) -> int:
    """Bytes the buffers cover, each byte of a storage counted once (the
    union of the views' spans in each storage); a buffer that is no tensor
    (a spilled buffer's host marker) counts its ``nbytes``."""
    spans, total = {}, 0
    for b in buffers:
        if not isinstance(b, torch.Tensor):
            total += int(b.nbytes)
            continue
        size = b.element_size()
        if not b.numel():
            continue
        key = (b.device, b.untyped_storage().data_ptr())
        lo = b.storage_offset() * size
        spans.setdefault(key, []).append((lo, lo + b.numel() * size))
    for ranges in spans.values():
        ranges.sort()
        end = -1
        for lo, hi in ranges:
            if hi > end:
                total += hi - max(lo, end)
                end = hi
    return total


class Column:
    __slots__ = ("dtype", "length", "data", "validity", "offsets", "children", "_cache",
                 "_device", "__weakref__")

    def __init__(self, dtype: DType, length: int, data: Optional[torch.Tensor],
                 validity: Optional[torch.Tensor] = None,
                 offsets: Optional[torch.Tensor] = None, children: Sequence["Column"] = ()):
        _check_supported(dtype)
        self.dtype = dtype
        self.length = int(length)
        self.data = data
        self.validity = validity
        self.offsets = offsets
        self.children = tuple(children)
        self._cache = {}
        held = [t for t in (data, offsets, validity) if t is not None]
        if held:
            self._device = held[0].device
        elif self.children:
            self._device = self.children[0].device
        else:
            raise ValueError(f"a {dtype!r} column needs a buffer or a child to live on")
        self._check_layout()

    def _check_layout(self) -> None:
        n, dev = self.length, self._device
        if self.dtype.is_nested:
            self._check_nested_layout()
        elif self.dtype.is_string:
            ok = (self.data.dtype == torch.uint8 and self.data.ndim == 1
                  and self.offsets is not None and self.offsets.dtype == torch.int64
                  and self.offsets.shape == (n + 1,) and self.offsets.device == dev)
            what = "uint8 chars and int64[n + 1] offsets"
        else:
            ok = self.data.dtype == self.dtype.torch_storage and self.data.shape == (n,)
            what = f"{n} values of {self.dtype!r}"
            if self.dtype.is_dictionary:
                kd = self.children[0].dtype if len(self.children) == 1 else None
                ok = ok and kd is not None and (kd.is_string or kd.is_numeric or kd.is_temporal) \
                    and self.children[0].validity is None and self.children[0].device == dev
                what += " and one keys column (STRING, numeric or temporal, no nulls, same device)"
            elif self.dtype.is_decimal and self.children:
                hi = self.children[0]
                ok = ok and self.dtype.id == dt.TypeId.DECIMAL128 and len(self.children) == 1 \
                    and hi.dtype == dt.INT64 and hi.length == n and hi.device == dev
                what += " and, for two limbs, one int64 high-limb column"
        if not self.dtype.is_nested and not ok:
            raise ValueError(f"buffers {tuple(self.data.shape)} {self.data.dtype} do not "
                             f"hold {what}")
        if self.validity is not None and (self.validity.dtype != torch.bool
                                          or self.validity.shape != (n,)
                                          or self.validity.device != dev):
            raise ValueError("validity must be a bool tensor of the column's "
                             "length on the column's device")

    def _check_nested_layout(self) -> None:
        n, dev = self.length, self._device
        if self.data is not None:
            raise ValueError(f"a {self.dtype!r} column holds no data buffer")
        if any(c.device != dev for c in self.children):
            raise ValueError("a nested column's children live on its device")
        if self.dtype.is_list:
            if not (len(self.children) == 1 and self.offsets is not None
                    and self.offsets.dtype == torch.int64 and self.offsets.shape == (n + 1,)
                    and self.offsets.device == dev):
                raise ValueError("a LIST column holds int64[n + 1] offsets and one child")
        elif len(self.children) != len(self.dtype.fields) or any(
                c.length != n for c in self.children):
            raise ValueError("a STRUCT column holds one child of its length a field")

    def __len__(self) -> int:
        return self.length

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def keys(self) -> "Column":
        """A dictionary column's keys."""
        return self.children[0]

    @property
    def null_count(self) -> int:
        return bm.null_count(self.validity, self.length)

    @property
    def has_nulls(self) -> bool:
        return self.validity is not None and self.null_count > 0

    def with_validity(self, validity: Optional[torch.Tensor]) -> "Column":
        return Column(self.dtype, self.length, self.data, validity, self.offsets, self.children)

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @classmethod
    def from_tensor(cls, data: torch.Tensor,
                    validity: Optional[torch.Tensor] = None) -> "Column":
        """Wrap a 1-D tensor (kept on its device, not copied)."""
        if data.ndim != 1:
            raise ValueError("Column.from_tensor expects a 1-D tensor")
        return cls(dt.from_torch(data.dtype), data.shape[0], data.contiguous(), validity)

    @classmethod
    def from_numpy(cls, arr: np.ndarray, *, device) -> "Column":
        """Build from a 1-D numpy array onto ``device``.  NaN in a float
        array and NaT are nulls, as in the reference's pandas path; str
        and object arrays become STRING columns (None and NaN nulls)."""
        arr = np.asarray(arr)
        if arr.ndim != 1:
            raise ValueError("Column.from_numpy expects a 1-D array")
        if arr.dtype.kind in ("U", "S", "O"):
            vals = list(arr) if arr.dtype.kind == "O" else arr.tolist()
            if arr.dtype.kind == "O" and host_layout(vals):
                return cls.from_pylist(vals, device=device)
            return cls.from_strings([None if is_null_scalar(v) else v for v in vals],
                                    device=device)
        if arr.dtype.kind in ("M", "m"):
            unit = np.datetime_data(arr.dtype)[0]
            if unit == "D":
                mask = ~np.isnat(arr)
                days = np.where(mask, arr.view(np.int64), 0).astype(np.int32)
                return cls(dt.dtype(arr.dtype), arr.shape[0], torch.from_numpy(days).to(device),
                           bm.from_numpy_mask(mask, device))
            if unit not in _UNITS:
                arr = arr.astype(("datetime64" if arr.dtype.kind == "M" else "timedelta64")
                                 + "[s]")
            logical = dt.dtype(arr.dtype)
            mask = ~np.isnat(arr)
            data = torch.from_numpy(arr.view(np.int64).copy()).to(device)
            return cls(logical, arr.shape[0], data, bm.from_numpy_mask(mask, device))
        logical = dt.dtype(arr.dtype)
        _check_supported(logical)
        mask = ~np.isnan(arr) if logical.is_float else None
        # a copy: the column must not alias the caller's (possibly
        # read-only) array, even on the CPU
        data = torch.from_numpy(np.array(arr, order="C")).to(device)
        return cls(logical, arr.shape[0], data, bm.from_numpy_mask(mask, device))

    @classmethod
    def from_strings(cls, strings: Sequence[Optional[str]], *, device) -> "Column":
        """A STRING column from host strings (None: null), built on the
        host and copied to ``device`` (cudf::make_strings_column)."""
        strings = list(strings)
        chars, offsets = _encode(strings)
        mask = np.array([s is not None for s in strings], bool)
        col = cls(dt.STRING, len(strings), torch.from_numpy(chars).to(device),
                  bm.from_numpy_mask(mask, device), torch.from_numpy(offsets).to(device))
        col._cache["strings"] = strings
        return col

    @classmethod
    def from_pylist(cls, values: Sequence[Any], dtype=None, *, device) -> "Column":
        """A column of host scalars (None, NaN and NaT are nulls), in
        ``dtype`` or the one ``infer_dtype`` gives."""
        values = list(values)
        layout = host_layout(values, None if dtype is None else dt.dtype(dtype))
        if layout == "list":
            from cudf_tpu_torch.ops.lists import from_pylists

            vt = None if dtype is None else dt.dtype(dtype).value_type
            return from_pylists([None if _missing(v) else v for v in values], vt,
                                device=device)
        if layout == "struct":
            from cudf_tpu_torch.ops.structs import from_pydicts

            return from_pydicts([None if _missing(v) else v for v in values], device=device)
        if layout == "decimal":
            from cudf_tpu_torch.ops.decimal import cast_to_decimal, from_decimals

            col = from_decimals(values, device=device)
            return col if dtype is None else cast_to_decimal(col, dt.dtype(dtype))
        null = np.array([is_null_scalar(v) for v in values], bool)
        want = infer_dtype([v for v, m in zip(values, null) if not m]) if dtype is None \
            else dt.dtype(dtype)
        if want.is_string:
            return cls.from_strings([None if m else v for v, m in zip(values, null)],
                                    device=device)
        _check_supported(want)
        if want.is_temporal:
            host = np.array([0 if m else to_ticks(v, want) for v, m in zip(values, null)],
                            np.int64)
        else:
            host = np.array([0 if m else v for v, m in zip(values, null)], want.storage)
        return cls(want, len(values), torch.from_numpy(host).to(device),
                   bm.from_numpy_mask(~null, device))

    @classmethod
    def from_dictionary(cls, codes: torch.Tensor, keys: "Column",
                        validity: Optional[torch.Tensor] = None) -> "Column":
        """A DICTIONARY32 column of int32 codes into ``keys``: its value
        type is the keys' dtype (numeric or temporal, unit included), or
        STRING for any string keys."""
        value_type = dt.STRING if keys.dtype.is_string else keys.dtype
        return cls(dt.dictionary_dtype(value_type), codes.shape[0], codes.to(torch.int32),
                   validity, children=(keys,))

    @classmethod
    def full(cls, length: int, value: Any, dtype=None, *, device) -> "Column":
        """``length`` copies of a host scalar (None: all null)."""
        want = dt.dtype(dtype) if dtype is not None else infer_dtype(
            [] if is_null_scalar(value) else [value])
        if is_null_scalar(value):
            if want.is_string:
                return cls(dt.STRING, length, torch.zeros(0, dtype=torch.uint8, device=device),
                           torch.zeros(length, dtype=torch.bool, device=device),
                           torch.zeros(length + 1, dtype=torch.int64, device=device))
            _check_supported(want)
            return cls(want, length, torch.zeros(length, dtype=want.torch_storage, device=device),
                       torch.zeros(length, dtype=torch.bool, device=device))
        if want.is_string:
            return cls.from_strings([str(value)] * length, device=device)
        _check_supported(want)
        v = to_ticks(value, want) if want.is_temporal else value
        return cls(want, length, torch.full((length,), v, dtype=want.torch_storage,
                                            device=device))

    @classmethod
    def empty(cls, dtype, *, device) -> "Column":
        want = dt.dtype(dtype)
        if want.is_string:
            return cls.from_strings([], device=device)
        if want.is_list:
            return cls(want, 0, None, offsets=torch.zeros(1, dtype=torch.int64, device=device),
                       children=[cls.empty(want.value_type, device=device)])
        if want.is_struct:
            return cls(want, 0, None, torch.zeros(0, dtype=torch.bool, device=device),
                       children=[cls.empty(t, device=device) for _, t in want.fields])
        return cls(want, 0, torch.zeros(0, dtype=want.torch_storage, device=device))

    @classmethod
    def from_pandas(cls, series, *, device) -> "Column":
        """A pandas Series: numpy-backed numeric, bool and datetime64 /
        timedelta64 columns, pandas' nullable integer, boolean and float
        columns (pd.NA is null), str or object strings (nulls from NaN and
        None), and Categoricals as DICTIONARY32 over their categories (pandas
        itself is not imported)."""
        pdt = series.dtype
        name = type(pdt).__name__
        if name == "CategoricalDtype":
            cat = series.array
            codes = np.asarray(cat.codes).astype(np.int32)
            keys = cls.from_numpy(np.asarray(cat.categories.to_numpy()), device=device)
            if keys.validity is not None:
                raise ValueError("a Categorical's categories hold no nulls")
            valid = codes >= 0
            codes_t = torch.from_numpy(np.where(valid, codes, 0)).to(device)
            col = cls.from_dictionary(codes_t, keys, bm.from_numpy_mask(valid, device))
            return col._as(dt.DType(col.dtype.id, value_type=col.dtype.value_type,
                                    ordered=True)) if cat.ordered else col
        if name == "StringDtype" or (isinstance(pdt, np.dtype) and pdt.kind == "O"):
            col = cls.from_numpy(series.to_numpy(dtype=object, na_value=None), device=device)
            if name == "StringDtype" and pdt.na_value is not np.nan:
                col = col._as(dt.DType(dt.TypeId.STRING, nullable=True))
            return col
        if name in _NULLABLE_PANDAS:
            # Int8-Int64, UInt8-UInt64, boolean, Float32/Float64: pd.NA is null
            # (a NaN a Float column computed stays a value), the dtype keeps
            # its pandas name
            logical = dt.dtype(pdt)
            arr = series.array
            values = np.asarray(arr.to_numpy(dtype=logical.storage, na_value=0))
            valid = ~np.asarray(arr.isna(), dtype=bool)
            if logical.is_float:
                valid |= np.isnan(values)
            return cls(logical, values.shape[0], torch.from_numpy(values.copy()).to(device),
                       bm.from_numpy_mask(valid, device))
        if name == "ArrowDtype":
            col = cls.from_arrow(series.array._pa_array, device=device)
            keep = col.dtype.is_dictionary or col.dtype.is_nested or col.dtype.is_decimal
            return col if keep else col._as(dt.dtype(pdt))
        if name == "DatetimeTZDtype":
            # the UTC instants' ticks, the zone in the dtype
            utc = np.asarray(series.dt.tz_convert(None).to_numpy())
            col = cls.from_numpy(utc, device=device)
            return col._as(dt.DType(col.dtype.id, tz=str(pdt.tz)))
        if not isinstance(pdt, np.dtype):
            raise NotImplementedError(
                f"pandas extension dtype {pdt}: interval, period and sparse columns are "
                f"{_BEYOND}")
        return cls.from_numpy(series.to_numpy(), device=device)

    @classmethod
    def from_arrow(cls, arr, *, device) -> "Column":
        """A pyarrow Array or ChunkedArray of a fixed-width, temporal (a
        tz-aware timestamp keeps its UTC ticks and its zone), string or
        dictionary type (the reference's ``Column.from_arrow`` for those
        layouts)."""
        import pyarrow as pa

        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        t = arr.type
        valid = None if arr.null_count == 0 else ~np.asarray(arr.is_null())
        if pa.types.is_dictionary(t):
            keys = cls.from_arrow(arr.dictionary, device=device)
            codes = np.asarray(arr.indices.fill_null(0).to_numpy(zero_copy_only=False))
            return cls.from_dictionary(torch.from_numpy(codes.astype(np.int32)).to(device),
                                       keys, bm.from_numpy_mask(valid, device))
        if pa.types.is_list(t) or pa.types.is_large_list(t) or pa.types.is_struct(t):
            return cls._from_arrow_nested(pa.concat_arrays([arr]), device)
        if pa.types.is_decimal(t):
            return cls._from_arrow_decimal(arr, valid, device)
        if pa.types.is_string(t) or pa.types.is_large_string(t):
            arr = arr.cast(pa.large_string())
            _, offbuf, charbuf = arr.buffers()
            n = len(arr)
            off = np.frombuffer(offbuf, np.int64, count=n + 1 + arr.offset)[arr.offset:]
            chars = np.zeros(0, np.uint8) if charbuf is None else \
                np.frombuffer(charbuf, np.uint8)[off[0]:off[-1]]
            return cls(dt.STRING, n, torch.from_numpy(chars.copy()).to(device),
                       bm.from_numpy_mask(valid, device),
                       torch.from_numpy((off - off[0]).copy()).to(device))
        if pa.types.is_date32(t):
            days = np.asarray(arr.cast(pa.int32()).fill_null(0).to_numpy(zero_copy_only=False))
            return cls(dt.DType(dt.TypeId.TIMESTAMP_DAYS), len(arr),
                       torch.from_numpy(days.astype(np.int32)).to(device),
                       bm.from_numpy_mask(valid, device))
        if pa.types.is_date64(t):
            arr = arr.cast(pa.timestamp("ms"))
            t = arr.type
        if pa.types.is_timestamp(t) or pa.types.is_duration(t):
            ticks = np.asarray(arr.cast(pa.int64()).fill_null(0).to_numpy(zero_copy_only=False))
            base = dt.unit_dtype("M" if pa.types.is_timestamp(t) else "m", t.unit)
            tz = getattr(t, "tz", None)
            return cls(dt.DType(base.id, tz=None if tz is None else str(tz)), len(arr),
                       torch.from_numpy(ticks.astype(np.int64)).to(device),
                       bm.from_numpy_mask(valid, device))
        if not (pa.types.is_integer(t) or pa.types.is_floating(t) or pa.types.is_boolean(t)):
            raise NotImplementedError(f"arrow {t}: {_BEYOND}")
        filled = arr if valid is None else arr.fill_null(False if pa.types.is_boolean(t) else 0)
        values = np.ascontiguousarray(filled.to_numpy(zero_copy_only=False))
        return cls(dt.dtype(values.dtype), len(arr), torch.from_numpy(values.copy()).to(device),
                   bm.from_numpy_mask(valid, device))

    @classmethod
    def _from_arrow_nested(cls, arr, device) -> "Column":
        """A list, large list or struct array at offset 0."""
        import pyarrow as pa

        validity = None if arr.null_count == 0 else \
            torch.from_numpy(~np.asarray(arr.is_null())).to(device)
        if pa.types.is_struct(arr.type):
            from cudf_tpu_torch.ops.structs import make_struct_column

            fields = [(arr.type.field(i).name, cls.from_arrow(arr.field(i), device=device))
                      for i in range(arr.type.num_fields)]
            if not fields and validity is None:
                validity = torch.ones(len(arr), dtype=torch.bool, device=device)
            return make_struct_column(fields, validity)
        from cudf_tpu_torch.ops.lists import make_list_column

        off = np.asarray(arr.offsets).astype(np.int64)
        child = cls.from_arrow(arr.values.slice(int(off[0]), int(off[-1] - off[0])),
                               device=device)
        return make_list_column(torch.from_numpy(off - off[0]).to(device), child, validity)

    @classmethod
    def _from_arrow_decimal(cls, arr, valid, device) -> "Column":
        """A decimal128 array as DECIMAL128 at scale ``-arrow scale``: one
        int64 limb when every value fits it, else two (its 16-byte values
        read as (lo, hi) pairs, no Python Decimals)."""
        import pyarrow as pa

        t = arr.type
        if t.bit_width != 128:
            if t.bit_width > 128:
                raise NotImplementedError(f"arrow {t}: 256-bit decimals: {_BEYOND}")
            arr = arr.cast(pa.decimal128(38, t.scale))
        n = len(arr)
        raw = np.frombuffer(arr.buffers()[1], np.int64, count=2 * (n + arr.offset))
        pairs = raw[2 * arr.offset:].reshape(n, 2).copy()
        if valid is not None:
            pairs[~valid] = 0
        lo, hi = pairs[:, 0], pairs[:, 1]
        scale = -t.scale
        validity = bm.from_numpy_mask(valid, device)
        if (hi == (lo >> 63)).all():
            return cls(dt.decimal_dtype(scale, 128), n, torch.from_numpy(lo).to(device),
                       validity)
        from cudf_tpu_torch.ops.decimal128 import make_decimal128

        return make_decimal128(torch.from_numpy(hi).to(device), torch.from_numpy(lo).to(device),
                               scale, validity)

    def _as(self, dtype: DType) -> "Column":
        """The same buffers under another logical dtype of the same layout."""
        return Column(dtype, self.length, self.data, self.validity, self.offsets, self.children)

    def buffers(self):
        """The column's buffers, its children's included (a spilled
        buffer is its host marker, ``utils/spill.py``)."""
        for b in (self.data, self.validity, self.offsets):
            if b is not None:
                yield b
        for c in self.children:
            yield from c.buffers()

    @property
    def nbytes(self) -> int:
        """Bytes of the column's buffers, each byte of a storage counted
        once: views of one storage (``ops/copying.slice``'s) count the
        span they cover, not the storage."""
        return distinct_bytes(self.buffers())

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------
    def host_strings(self) -> List[Optional[str]]:
        """A STRING column's rows as Python strings (None: null), read
        once and cached."""
        if "strings" not in self._cache:
            chars = self.data.cpu().numpy().tobytes()
            offs = self.offsets.cpu().tolist()
            valid = None if self.validity is None else self.validity.cpu().tolist()
            self._cache["strings"] = [
                None if valid is not None and not valid[i]
                else chars[offs[i]:offs[i + 1]].decode("utf-8")
                for i in range(self.length)]
        return self._cache["strings"]

    def decode_dictionary(self) -> "Column":
        """DICTIONARY32 -> the keys gathered by code (cudf::dictionary::decode)."""
        if not self.dtype.is_dictionary:
            return self
        from cudf_tpu_torch.ops import copying

        codes = self.data if self.validity is None else torch.where(self.validity, self.data, 0)
        out = copying.gather(self.keys, codes.long(), bounds_check=False)
        return out.with_validity(self.validity)

    def to_numpy(self) -> np.ndarray:
        """Copy to host.  Nulls become NaN in float columns, NaT in
        temporal ones and None in string ones; an int column with nulls
        becomes float64 with NaN (pandas' own representation); a bool
        column with nulls becomes object with None.  A dictionary column
        gives its decoded values."""
        if self.dtype.is_string:
            return np.array(self.host_strings(), dtype=object)
        if self.dtype.is_dictionary:
            return self.decode_dictionary().to_numpy()
        if self.dtype.is_nested or self.dtype.is_decimal:
            out = np.empty(self.length, dtype=object)
            out[:] = self.to_pylist()
            return out
        data = self.data.cpu().numpy()
        if self.dtype.is_temporal:
            data = data.astype(np.int64).view(self.dtype.to_numpy())
        if self.validity is None:
            return data
        valid = self.validity.cpu().numpy()
        if valid.all():
            return data
        if self.dtype.is_bool:
            out = data.astype(object)
            out[~valid] = None
            return out
        if self.dtype.is_temporal:
            out = data.copy()
            out[~valid] = np.datetime64("NaT") if self.dtype.is_timestamp else np.timedelta64("NaT")
            return out
        out = data.astype(np.float64) if self.dtype.is_integer else data.copy()
        out[~valid] = np.nan
        return out

    def to_pylist(self) -> list:
        """The rows as Python values, None for nulls: lists, dicts and
        Decimals for the nested and decimal layouts, strings, numbers,
        numpy datetime64 / timedelta64 (counted host routes for the
        nested ones, as in the reference)."""
        if self.dtype.is_list:
            from cudf_tpu_torch.ops.lists import to_pylists

            return to_pylists(self)
        if self.dtype.is_struct:
            from cudf_tpu_torch.ops.structs import to_pydicts

            return to_pydicts(self)
        if self.dtype.is_decimal:
            from cudf_tpu_torch.ops.decimal import to_decimals

            return to_decimals(self)
        if self.dtype.is_dictionary:
            return self.decode_dictionary().to_pylist()
        if self.dtype.is_string:
            return list(self.host_strings())
        if self.dtype.is_float and not self.dtype.nullable:
            return self.to_numpy().tolist()          # pandas' NaN for a missing float
        data = self.data.cpu().numpy()
        vals = list(data.astype(np.int64).view(self.dtype.to_numpy())) \
            if self.dtype.is_temporal else data.tolist()
        if self.validity is None:
            return vals
        return [v if ok else None for v, ok in zip(vals, self.validity.cpu().tolist())]

    def __arrow_c_array__(self, requested_schema=None):
        """The Arrow PyCapsule protocol (``arrow_cdata.py``): the buffers
        cross on the host."""
        from cudf_tpu_torch import arrow_cdata

        return arrow_cdata.column_capsules(self, requested_schema=requested_schema)

    def to_arrow(self):
        """A pyarrow Array (the reference's ``Column.to_arrow``): a LIST
        column as a large list, a STRUCT as a struct array, a decimal as
        decimal128(38, -scale) from its limbs."""
        import pyarrow as pa

        mask = None if self.validity is None else ~self.validity.cpu().numpy()
        if self.dtype.is_list:
            offs = pa.array(self.offsets.cpu().numpy(), pa.int64())
            return pa.LargeListArray.from_arrays(
                offs, self.children[0].to_arrow(), mask=None if mask is None else pa.array(mask))
        if self.dtype.is_struct:
            return pa.StructArray.from_arrays(
                [c.to_arrow() for c in self.children], [n for n, _ in self.dtype.fields],
                mask=None if mask is None else pa.array(mask))
        if self.dtype.is_decimal:
            from cudf_tpu_torch.ops.decimal128 import limbs

            hi, lo = limbs(self)
            pairs = np.stack([lo.cpu().numpy(), hi.cpu().numpy()], 1).reshape(-1)
            buf = None if mask is None else pa.py_buffer(np.packbits(~mask, bitorder="little"))
            return pa.Array.from_buffers(pa.decimal128(38, -self.dtype.scale), self.length,
                                         [buf, pa.py_buffer(pairs.copy())],
                                         0 if mask is None else int(mask.sum()))
        if self.dtype.is_string:
            offs = self.offsets.cpu().numpy()
            buf = None if mask is None else pa.py_buffer(np.packbits(~mask, bitorder="little"))
            arr = pa.LargeStringArray.from_buffers(
                self.length, pa.py_buffer(offs), pa.py_buffer(self.data.cpu().numpy()), buf,
                int(mask.sum()) if mask is not None else 0)
            return arr.cast(pa.string()) if offs[-1] < 2 ** 31 else arr
        if self.dtype.is_dictionary:
            return pa.DictionaryArray.from_arrays(
                pa.array(self.data.cpu().numpy(), mask=mask), self.keys.to_arrow())
        data = self.data.cpu().numpy()
        if self.dtype.id == dt.TypeId.TIMESTAMP_DAYS:
            return pa.array(data, mask=mask).cast(pa.date32())
        if self.dtype.id == dt.TypeId.DURATION_DAYS:      # Arrow has no day duration
            return pa.array(data.astype(np.int64) * 86_400, mask=mask).cast(pa.duration("s"))
        if self.dtype.is_temporal:
            unit = self.dtype.time_unit
            typ = pa.duration(unit) if self.dtype.is_duration else pa.timestamp(unit,
                                                                               tz=self.dtype.tz)
            return pa.array(data.astype(np.int64), mask=mask).cast(typ)
        return pa.array(data, mask=mask)

    def to_pandas_array(self):
        """What the reference's ``column_to_pandas_array`` gives: numpy
        values, datetime64 / timedelta64 (tz-aware: in their zone), strings
        as pandas infers them (``string``: pd.NA for null), a Categorical over
        a dictionary's keys, and an ``ArrowExtensionArray`` for Arrow
        provenance."""
        import pandas as pd

        if self.dtype.arrow:
            return pd.arrays.ArrowExtensionArray(self.to_arrow())
        if self.dtype.is_nested or self.dtype.is_decimal:
            return self.to_numpy()
        if self.dtype.is_string and self.dtype.nullable:
            return pd.array(self.host_strings(), dtype="string")
        if self.dtype.nullable:
            values = self.data.cpu().numpy()
            mask = np.zeros(self.length, bool) if self.validity is None else \
                ~self.validity.cpu().numpy()
            if self.dtype.is_bool:
                return pd.arrays.BooleanArray(values, mask)
            if self.dtype.is_float:
                return pd.arrays.FloatingArray(values, mask)
            return pd.arrays.IntegerArray(values, mask)
        if self.dtype.is_dictionary:
            codes = self.data.cpu().numpy().astype(np.int64)
            if self.validity is not None:
                codes = np.where(self.validity.cpu().numpy(), codes, -1)
            return pd.Categorical.from_codes(codes, categories=pd.Index(self.keys.to_numpy()),
                                             ordered=self.dtype.ordered)
        if self.dtype.is_string:
            return pd.Series(self.to_numpy()).array
        if self.dtype.tz is not None:
            return pd.DatetimeIndex(self.to_numpy()).tz_localize("UTC").tz_convert(
                self.dtype.tz).array
        return self.to_numpy()

    def to_pandas(self):
        import pandas as pd

        return pd.Series(self.to_pandas_array())

    def __repr__(self) -> str:
        return f"Column<{self.dtype!r}>[{self.length}] on {self.device}"
