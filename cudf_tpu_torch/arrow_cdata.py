"""The Arrow C data interface (port of ``cudf_tpu/arrow_cdata.py``): the
``ArrowSchema`` / ``ArrowArray`` / ``ArrowArrayStream`` C structs in
ctypes, export and import of columns and tables, and the PyCapsule
protocol (``__arrow_c_schema__`` / ``__arrow_c_array__`` /
``__arrow_c_stream__``) that pyarrow >= 14, polars and pandas speak.  No
pyarrow object is on the path, so it works where pyarrow is not
installed.

Buffers cross on the host, as in the reference: an export copies each
device buffer to host memory that the exported structs point at (kept
alive until the consumer releases them); an import copies the producer's
buffers, releases them, and moves them to ``device``.  The C *device*
interface (``ArrowDeviceArray``) is not here.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.dtypes import DType, TypeId

# ---------------------------------------------------------------------------
# C ABI structs (https://arrow.apache.org/docs/format/CDataInterface.html)
# ---------------------------------------------------------------------------


class ArrowSchema(ctypes.Structure):
    pass


ArrowSchema._fields_ = [
    ("format", ctypes.c_char_p),
    ("name", ctypes.c_char_p),
    ("metadata", ctypes.c_char_p),
    ("flags", ctypes.c_int64),
    ("n_children", ctypes.c_int64),
    ("children", ctypes.POINTER(ctypes.POINTER(ArrowSchema))),
    ("dictionary", ctypes.POINTER(ArrowSchema)),
    ("release", ctypes.CFUNCTYPE(None, ctypes.POINTER(ArrowSchema))),
    ("private_data", ctypes.c_void_p),
]


class ArrowArray(ctypes.Structure):
    pass


ArrowArray._fields_ = [
    ("length", ctypes.c_int64),
    ("null_count", ctypes.c_int64),
    ("offset", ctypes.c_int64),
    ("n_buffers", ctypes.c_int64),
    ("n_children", ctypes.c_int64),
    ("buffers", ctypes.POINTER(ctypes.c_void_p)),
    ("children", ctypes.POINTER(ctypes.POINTER(ArrowArray))),
    ("dictionary", ctypes.POINTER(ArrowArray)),
    ("release", ctypes.CFUNCTYPE(None, ctypes.POINTER(ArrowArray))),
    ("private_data", ctypes.c_void_p),
]


class ArrowArrayStream(ctypes.Structure):
    pass


ArrowArrayStream._fields_ = [
    ("get_schema", ctypes.CFUNCTYPE(
        ctypes.c_int, ctypes.POINTER(ArrowArrayStream),
        ctypes.POINTER(ArrowSchema))),
    ("get_next", ctypes.CFUNCTYPE(
        ctypes.c_int, ctypes.POINTER(ArrowArrayStream),
        ctypes.POINTER(ArrowArray))),
    ("get_last_error", ctypes.CFUNCTYPE(
        ctypes.c_char_p, ctypes.POINTER(ArrowArrayStream))),
    ("release", ctypes.CFUNCTYPE(None, ctypes.POINTER(ArrowArrayStream))),
    ("private_data", ctypes.c_void_p),
]

ARROW_FLAG_NULLABLE = 2

# ---------------------------------------------------------------------------
# format strings
# ---------------------------------------------------------------------------

_PRIM_FMT = {
    TypeId.INT8: "c", TypeId.UINT8: "C",
    TypeId.INT16: "s", TypeId.UINT16: "S",
    TypeId.INT32: "i", TypeId.UINT32: "I",
    TypeId.INT64: "l", TypeId.UINT64: "L",
    TypeId.FLOAT32: "f", TypeId.FLOAT64: "g",
}
_FMT_PRIM = {v: k for k, v in _PRIM_FMT.items()}
_TS_UNIT = {
    TypeId.TIMESTAMP_SECONDS: "s", TypeId.TIMESTAMP_MILLISECONDS: "m",
    TypeId.TIMESTAMP_MICROSECONDS: "u", TypeId.TIMESTAMP_NANOSECONDS: "n",
}
_UNIT_TS = {v: k for k, v in _TS_UNIT.items()}
_DUR_UNIT = {
    TypeId.DURATION_SECONDS: "s", TypeId.DURATION_MILLISECONDS: "m",
    TypeId.DURATION_MICROSECONDS: "u", TypeId.DURATION_NANOSECONDS: "n",
}
_UNIT_DUR = {v: k for k, v in _DUR_UNIT.items()}


def _format_for(dtype: DType) -> str:
    tid = dtype.id
    if tid in _PRIM_FMT:
        return _PRIM_FMT[tid]
    if tid == TypeId.BOOL8:
        return "b"
    if tid == TypeId.TIMESTAMP_DAYS:
        return "tdD"
    if tid in _TS_UNIT:
        return f"ts{_TS_UNIT[tid]}:{dtype.tz or ''}"
    if tid in _DUR_UNIT:
        return f"tD{_DUR_UNIT[tid]}"
    if tid == TypeId.STRING:
        return "U"            # large_utf8 — offsets are int64 from day one
    if tid == TypeId.LIST:
        return "+L"
    if tid == TypeId.STRUCT:
        return "+s"
    if tid == TypeId.DICTIONARY32:
        return "i"            # codes format; categories go in .dictionary
    if tid in (TypeId.DECIMAL32, TypeId.DECIMAL64, TypeId.DECIMAL128):
        prec = {TypeId.DECIMAL32: 9, TypeId.DECIMAL64: 18,
                TypeId.DECIMAL128: 38}[tid]
        return f"d:{prec},{-dtype.scale}"
    raise NotImplementedError(f"Arrow C export: {dtype}")


def _dtype_for(fmt: str) -> DType:
    if fmt in _FMT_PRIM:
        return DType(_FMT_PRIM[fmt])
    if fmt == "b":
        return dt.BOOL8
    if fmt == "tdD":
        return DType(TypeId.TIMESTAMP_DAYS)
    if fmt.startswith("ts") and len(fmt) >= 3 and fmt[3:4] == ":":
        tz = fmt[4:] or None
        return DType(_UNIT_TS[fmt[2]], tz=tz)
    if fmt.startswith("tD") and len(fmt) == 3:
        return DType(_UNIT_DUR[fmt[2]])
    if fmt in ("u", "U", "vu"):
        return dt.STRING
    if fmt in ("z", "Z"):
        return dt.STRING          # binary imported as string bytes
    if fmt in ("+l", "+L"):
        return DType(TypeId.LIST)
    if fmt == "+s":
        return DType(TypeId.STRUCT)
    if fmt.startswith("d:"):
        parts = fmt[2:].split(",")
        prec, scale = int(parts[0]), int(parts[1])
        if len(parts) > 2 and int(parts[2]) != 128:
            raise NotImplementedError(f"decimal bitwidth in {fmt!r}")
        tid = (TypeId.DECIMAL32 if prec <= 9 else
               TypeId.DECIMAL64 if prec <= 18 else TypeId.DECIMAL128)
        return DType(tid, scale=-scale)
    raise NotImplementedError(f"Arrow C import: format {fmt!r}")


# ---------------------------------------------------------------------------
# keepalive registry: exported structs hold Python buffer references until
# the consumer calls release (or the owning capsule is destroyed)
# ---------------------------------------------------------------------------

_LIVE: Dict[int, object] = {}
_NEXT_ID = [1]


class _Holder:
    """Owns everything an exported tree points at: numpy buffers, ctypes
    child structs/arrays, callback objects.  One holder per export; each
    node's release decrements; freed at zero."""

    def __init__(self):
        self.keep: List[object] = []
        self.refs = 0
        self.key = _NEXT_ID[0]
        _NEXT_ID[0] += 1

    def retain(self):
        self.refs += 1
        _LIVE[self.key] = self

    def release_one(self, _live=_LIVE):  # bound: survives module teardown
        self.refs -= 1
        if self.refs <= 0:
            _live.pop(self.key, None)


# concrete objects bound as defaults (never module attributes): consumers
# may call release during interpreter shutdown after module globals — and
# module attribute values — are cleared to None
_NULL_SCHEMA_RELEASE = ctypes.cast(None, ArrowSchema._fields_[7][1])
_NULL_ARRAY_RELEASE = ctypes.cast(None, ArrowArray._fields_[8][1])


def _release_schema_cb(ptr, _live=_LIVE, _null=_NULL_SCHEMA_RELEASE):
    if not ptr or not ptr[0].release:
        return
    key = ptr[0].private_data
    ptr[0].release = _null
    h = _live.get(key)
    if h is not None:
        h.release_one()


def _release_array_cb(ptr, _live=_LIVE, _null=_NULL_ARRAY_RELEASE):
    if not ptr or not ptr[0].release:
        return
    key = ptr[0].private_data
    ptr[0].release = _null
    h = _live.get(key)
    if h is not None:
        h.release_one()


_SCHEMA_RELEASE = ArrowSchema._fields_[7][1](_release_schema_cb)
_ARRAY_RELEASE = ArrowArray._fields_[8][1](_release_array_cb)

# Consumers hold only the RAW function pointer of these trampolines, not a
# Python reference; if module teardown frees them before the consumer's own
# destructor runs (exit-time ordering is arbitrary) the release call lands
# on freed memory.  Immortalize them — a constant, bounded leak.
_Py_IncRef = ctypes.PYFUNCTYPE(None, ctypes.py_object)(
    ("Py_IncRef", ctypes.pythonapi))
_Py_IncRef(_SCHEMA_RELEASE)
_Py_IncRef(_ARRAY_RELEASE)


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------


def _host(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    return None if t is None else np.ascontiguousarray(t.cpu().numpy())


def _host_buffers(col) -> Tuple[Optional[np.ndarray], np.ndarray,
                                Optional[np.ndarray], int]:
    """(validity_bits | None, data, offsets | None, null_count) on host."""
    nulls = 0
    vbits = None
    if col.validity is not None:
        v = _host(col.validity)
        nulls = int((~v).sum())
        if nulls:
            vbits = np.packbits(v, bitorder="little")
        # all valid: no bitmap (the flags still say NULLABLE)
    data = _host(col.data)
    offs = None if col.offsets is None else _host(col.offsets.to(torch.int64))
    return vbits, data, offs, nulls


def _addr(arr: Optional[np.ndarray]):
    if arr is None or arr.size == 0:
        return None
    return arr.ctypes.data


def _fill_schema(sc: ArrowSchema, dtype: DType, name: str, holder: _Holder):
    fmt = _format_for(dtype).encode()
    nm = name.encode()
    holder.keep.extend([fmt, nm])
    sc.format = fmt
    sc.name = nm
    sc.metadata = None
    sc.flags = ARROW_FLAG_NULLABLE
    sc.dictionary = None
    children: List[Tuple[DType, str]] = []
    if dtype.id == TypeId.LIST:
        children = [(dtype.value_type or dt.INT64, "item")]
    elif dtype.id == TypeId.STRUCT:
        children = [(fdt, fname) for fname, fdt in dtype.fields]
    sc.n_children = len(children)
    if children:
        arr_t = ctypes.POINTER(ArrowSchema) * len(children)
        ptrs = arr_t()
        for i, (cdt, cname) in enumerate(children):
            child = ArrowSchema()
            _fill_schema(child, cdt, cname, holder)
            holder.keep.append(child)
            ptrs[i] = ctypes.pointer(child)
        holder.keep.append(ptrs)
        sc.children = ptrs
    else:
        sc.children = None
    if dtype.id == TypeId.DICTIONARY32:
        d = ArrowSchema()
        _fill_schema(d, dtype.value_type or dt.STRING, "", holder)
        holder.keep.append(d)
        sc.dictionary = ctypes.pointer(d)
    sc.release = _SCHEMA_RELEASE
    sc.private_data = holder.key
    holder.retain()


def _fill_array(ar: ArrowArray, col, holder: _Holder):
    vbits, data, offs, nulls = _host_buffers(col)
    tid = col.dtype.id
    bufs: List[Optional[np.ndarray]] = [vbits]
    children = list(col.children)
    dict_col = None
    if tid == TypeId.STRING:
        bufs += [offs, data]
    elif tid == TypeId.LIST:
        bufs += [offs]
    elif tid == TypeId.STRUCT:
        pass
    elif tid == TypeId.DICTIONARY32:
        codes = data.astype(np.int32, copy=False)
        # Arrow dictionary nulls live in the validity bitmap; our -1/OOB
        # codes (if any) are clamped — validity already marks them null
        bufs += [np.where(codes < 0, 0, codes).astype(np.int32)]
        dict_col = children[0]
        children = []
    elif tid == TypeId.BOOL8:
        bufs += [np.packbits(data.astype(bool), bitorder="little")]
    elif tid in (TypeId.DECIMAL32, TypeId.DECIMAL64, TypeId.DECIMAL128):
        # 128-bit little-endian two's complement: the low limb, then the
        # high limb (a DECIMAL128 column's child) or the sign extension
        lo = data.astype(np.int64)
        wide = np.zeros((len(lo), 2), dtype=np.int64)
        wide[:, 0] = lo
        wide[:, 1] = _host(children[0].data) if children else np.where(lo < 0, -1, 0)
        bufs += [wide]
        children = []
    else:
        bufs += [data]
    for b in bufs:
        if b is not None:
            holder.keep.append(b)
    buf_t = ctypes.c_void_p * len(bufs)
    bptrs = buf_t(*[_addr(b) for b in bufs])
    holder.keep.append(bptrs)
    ar.length = col.length
    ar.null_count = nulls
    ar.offset = 0
    ar.n_buffers = len(bufs)
    ar.buffers = bptrs
    ar.n_children = len(children)
    if children:
        arr_t = ctypes.POINTER(ArrowArray) * len(children)
        ptrs = arr_t()
        for i, ch in enumerate(children):
            carr = ArrowArray()
            _fill_array(carr, ch, holder)
            holder.keep.append(carr)
            ptrs[i] = ctypes.pointer(carr)
        holder.keep.append(ptrs)
        ar.children = ptrs
    else:
        ar.children = None
    if dict_col is not None:
        darr = ArrowArray()
        _fill_array(darr, dict_col, holder)
        holder.keep.append(darr)
        ar.dictionary = ctypes.pointer(darr)
    else:
        ar.dictionary = None
    ar.release = _ARRAY_RELEASE
    ar.private_data = holder.key
    holder.retain()


def export_column(col, name: str, schema_addr: int, array_addr: int) -> None:
    """Fill caller-allocated ArrowSchema/ArrowArray structs for a Column
    (the ``pa.Array._import_from_c`` handoff convention)."""
    holder = _Holder()
    sc = ArrowSchema.from_address(schema_addr)
    ar = ArrowArray.from_address(array_addr)
    _fill_schema(sc, col.dtype, name, holder)
    _fill_array(ar, col, holder)


def _struct_of(table):
    """A Table as one STRUCT column (a record batch's layout)."""
    from cudf_tpu_torch.core.column import Column

    names = list(table.names)
    struct_dt = DType(TypeId.STRUCT, fields=tuple((str(n), table[n].dtype) for n in names))
    return Column(struct_dt, table.num_rows, None, children=[table[n] for n in names])


def export_table(table, schema_addr: int, array_addr: int) -> None:
    """Export a Table as a struct-typed ArrowArray (one record batch)."""
    holder = _Holder()
    struct_col = _struct_of(table)
    struct_dt = struct_col.dtype
    sc = ArrowSchema.from_address(schema_addr)
    ar = ArrowArray.from_address(array_addr)
    _fill_schema(sc, struct_dt, "", holder)
    _fill_array(ar, struct_col, holder)


# ---------------------------------------------------------------------------
# import
# ---------------------------------------------------------------------------


def _read_buf(addr, count: int, np_dtype) -> np.ndarray:
    np_dtype = np.dtype(np_dtype)
    if count == 0 or not addr:
        return np.zeros((count,), np_dtype)
    return np.ctypeslib.as_array(
        ctypes.cast(addr, ctypes.POINTER(ctypes.c_uint8)),
        shape=(count * np_dtype.itemsize,)).view(np_dtype).copy()


def _import_validity(ar: ArrowArray, n: int, off: int):
    if ar.null_count == 0 or ar.n_buffers < 1 or not ar.buffers[0]:
        return None
    nbytes = (off + n + 7) // 8
    bits = _read_buf(ar.buffers[0], nbytes, np.uint8)
    return np.unpackbits(bits, bitorder="little")[off:off + n].astype(bool)


def _import_node(ar: ArrowArray, sc: ArrowSchema, device):
    """Recursively build a Column on ``device`` from C structs (copies)."""
    from cudf_tpu_torch.core.column import Column

    fmt = sc.format.decode()
    n = int(ar.length)
    off = int(ar.offset)
    valid = _import_validity(ar, n, off)
    v = None if valid is None else torch.from_numpy(valid).to(device)

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if fmt in ("u", "U", "z", "Z"):
        wide = fmt in ("U", "Z")
        offs = _read_buf(ar.buffers[1], off + n + 1,
                         np.int64 if wide else np.int32).astype(np.int64)[off:]
        nchars = int(offs[-1]) if len(offs) else 0
        chars = _read_buf(ar.buffers[2], nchars, np.uint8)[offs[0]:]
        return Column(dt.STRING, n, dev(chars), v, dev(offs - offs[0]))
    if fmt in ("+l", "+L"):
        offs = _read_buf(ar.buffers[1], off + n + 1,
                         np.int64 if fmt == "+L" else np.int32).astype(np.int64)[off:]
        child = _import_node(ar.children[0][0], sc.children[0][0], device)
        base = int(offs[0])
        if base or int(offs[-1]) != child.length:
            from cudf_tpu_torch.ops.copying import slice as slice_column

            child = slice_column(child, base, int(offs[-1]))
            offs = offs - base
        return Column(dt.list_dtype(child.dtype), n, None, v, dev(offs), [child])
    if fmt == "+s":
        children, fields = [], []
        for i in range(int(ar.n_children)):
            csc = sc.children[i][0]
            ch = _import_node(ar.children[i][0], csc, device)
            children.append(ch)
            fields.append(((csc.name or b"").decode(), ch.dtype))
        return Column(dt.struct_dtype(fields), n, None, v, children=children)
    if sc.dictionary:
        # dictionary-encoded: this node's buffers are the codes
        idx_dt = _dtype_for(fmt)
        codes = _read_buf(ar.buffers[1], off + n, idx_dt.storage)[off:].astype(np.int32)
        if valid is not None:
            codes = np.where(valid, codes, 0).astype(np.int32)
        keys = _import_node(ar.dictionary[0], sc.dictionary[0], device)
        return Column.from_dictionary(dev(codes), keys, v)

    dtype = _dtype_for(fmt)
    if fmt == "b":
        nbytes = (off + n + 7) // 8
        bits = _read_buf(ar.buffers[1], nbytes, np.uint8)
        vals = np.unpackbits(bits, bitorder="little")[off:off + n].astype(bool)
        return Column(dt.BOOL8, n, dev(vals), v)
    if dtype.id in (TypeId.DECIMAL32, TypeId.DECIMAL64, TypeId.DECIMAL128):
        raw = _read_buf(ar.buffers[1], (off + n) * 2, np.int64)[off * 2:]
        lo, hi = raw[0::2], raw[1::2]
        if np.array_equal(hi, np.where(lo < 0, -1, 0)):
            return Column(dt.decimal_dtype(dtype.scale, 64), n, dev(lo), v)
        return Column(dt.decimal_dtype(dtype.scale, 128), n, dev(lo), v,
                      children=[Column(dt.INT64, n, dev(hi))])
    vals = _read_buf(ar.buffers[1], off + n, dtype.storage)[off:]
    return Column(dtype, n, dev(vals), v)


def import_column(array_addr: int, schema_addr: int, *, device):
    """Consume caller-provided ArrowArray + ArrowSchema -> an owning Column
    on ``device``: copies, then calls the producer's release callbacks."""
    ar = ArrowArray.from_address(array_addr)
    sc = ArrowSchema.from_address(schema_addr)
    out = _import_node(ar, sc, device)
    if ar.release:
        ar.release(ctypes.pointer(ar))
    if sc.release:
        sc.release(ctypes.pointer(sc))
    return out


def _struct_table(col):
    from cudf_tpu_torch.core.table import Table

    if col.dtype.id != TypeId.STRUCT:
        raise ValueError("expected a struct-typed array for a table")
    if col.validity is not None and bool((~col.validity).any()):
        raise NotImplementedError("top-level struct nulls in a table import")
    names = [f[0] or f"f{i}" for i, f in enumerate(col.dtype.fields)]
    return Table(dict(zip(names, col.children)))


def import_table(array_addr: int, schema_addr: int, *, device):
    """Struct-typed ArrowArray -> Table (a record batch)."""
    return _struct_table(import_column(array_addr, schema_addr, device=device))


# ---------------------------------------------------------------------------
# PyCapsule protocol (pyarrow>=14 / polars / pandas consume these)
# ---------------------------------------------------------------------------

# Own C-API prototypes (do NOT set argtypes on the shared ctypes.pythonapi
# function objects — that mutates process-global state).  The destructor
# callback parameter is a RAW c_void_p, never py_object: ctypes py_object
# args incref an object whose refcount is already 0 inside its own
# dealloc, which double-destroys the capsule.
_PyCapsule_New = ctypes.PYFUNCTYPE(
    ctypes.py_object, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p)(
    ("PyCapsule_New", ctypes.pythonapi))
_PyCapsule_GetPointer = ctypes.PYFUNCTYPE(
    ctypes.c_void_p, ctypes.py_object, ctypes.c_char_p)(
    ("PyCapsule_GetPointer", ctypes.pythonapi))
_PyCapsule_GetPointer_raw = ctypes.PYFUNCTYPE(
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p)(
    ("PyCapsule_GetPointer", ctypes.pythonapi))
_PyCapsule_IsValid_raw = ctypes.PYFUNCTYPE(
    ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p)(
    ("PyCapsule_IsValid", ctypes.pythonapi))

_CAPSULE_DTOR = ctypes.CFUNCTYPE(None, ctypes.c_void_p)

# capsules carry a pointer to a heap-allocated struct; the struct's Python
# ctypes object must outlive the capsule → registry keyed by address
_CAPSULE_STRUCTS: Dict[object, object] = {}


def _release_struct_at(addr: int, struct_type) -> None:
    node = struct_type.from_address(addr)
    if node.release:
        node.release(ctypes.pointer(node))


def _make_capsule_dtor(name: bytes, struct_type):
    def dtor(capsule_raw):
        try:
            if not _PyCapsule_IsValid_raw(capsule_raw, name):
                return
            addr = _PyCapsule_GetPointer_raw(capsule_raw, name)
            if addr:
                _release_struct_at(addr, struct_type)
                _CAPSULE_STRUCTS.pop(addr, None)
        except Exception:
            pass
    return _CAPSULE_DTOR(dtor)


_SCHEMA_DTOR_F = _make_capsule_dtor(b"arrow_schema", ArrowSchema)
_ARRAY_DTOR_F = _make_capsule_dtor(b"arrow_array", ArrowArray)
_STREAM_DTOR_F = _make_capsule_dtor(b"arrow_array_stream", ArrowArrayStream)
for _cb in (_SCHEMA_DTOR_F, _ARRAY_DTOR_F, _STREAM_DTOR_F):
    _Py_IncRef(_cb)  # capsules may outlive module teardown (see above)
del _cb


def _new_capsule(struct, name: bytes, dtor) -> object:
    addr = ctypes.addressof(struct)
    _CAPSULE_STRUCTS[addr] = struct
    return _PyCapsule_New(addr, name, ctypes.cast(dtor, ctypes.c_void_p))


def schema_capsule(dtype: DType, name: str = "") -> object:
    holder = _Holder()
    sc = ArrowSchema()
    _fill_schema(sc, dtype, name, holder)
    return _new_capsule(sc, b"arrow_schema", _SCHEMA_DTOR_F)


def column_capsules(col, name: str = "",
                    requested_schema=None) -> Tuple[object, object]:
    """(schema_capsule, array_capsule) for ``__arrow_c_array__``."""
    holder = _Holder()
    sc, ar = ArrowSchema(), ArrowArray()
    _fill_schema(sc, col.dtype, name, holder)
    _fill_array(ar, col, holder)
    return (_new_capsule(sc, b"arrow_schema", _SCHEMA_DTOR_F),
            _new_capsule(ar, b"arrow_array", _ARRAY_DTOR_F))


def table_capsules(table, requested_schema=None) -> Tuple[object, object]:
    return column_capsules(_struct_of(table))


def table_stream_capsule(table, requested_schema=None) -> object:
    """One-batch ArrowArrayStream for ``__arrow_c_stream__``."""
    struct_col = _struct_of(table)
    struct_dt = struct_col.dtype

    state = {"done": False}
    keep: List[object] = []

    def get_schema(stream_ptr, out_schema_ptr):
        holder = _Holder()
        _fill_schema(out_schema_ptr[0], struct_dt, "", holder)
        return 0

    def get_next(stream_ptr, out_array_ptr):
        if state["done"]:
            out_array_ptr[0].release = ctypes.cast(
                None, ArrowArray._fields_[8][1])
            return 0
        holder = _Holder()
        _fill_array(out_array_ptr[0], struct_col, holder)
        state["done"] = True
        return 0

    def get_last_error(stream_ptr):
        return None

    def release(stream_ptr):
        if stream_ptr and stream_ptr[0].release:
            stream_ptr[0].release = ctypes.cast(
                None, ArrowArrayStream._fields_[3][1])
            _CAPSULE_STRUCTS.pop(("stream-keep", id(keep)), None)

    st = ArrowArrayStream()
    cb_schema = ArrowArrayStream._fields_[0][1](get_schema)
    cb_next = ArrowArrayStream._fields_[1][1](get_next)
    cb_err = ArrowArrayStream._fields_[2][1](get_last_error)
    cb_rel = ArrowArrayStream._fields_[3][1](release)
    keep.extend([cb_schema, cb_next, cb_err, cb_rel, struct_col, state])
    st.get_schema = cb_schema
    st.get_next = cb_next
    st.get_last_error = cb_err
    st.release = cb_rel
    st.private_data = None
    _CAPSULE_STRUCTS[("stream-keep", id(keep))] = keep
    return _new_capsule(st, b"arrow_array_stream", _STREAM_DTOR_F)


def from_c_array(obj, *, device):
    """A Column (a STRUCT for a record batch) from any object with
    ``__arrow_c_array__``; no pyarrow on the path."""
    schema_cap, array_cap = obj.__arrow_c_array__()
    s_addr = _PyCapsule_GetPointer(schema_cap, b"arrow_schema")
    a_addr = _PyCapsule_GetPointer(array_cap, b"arrow_array")
    return import_column(a_addr, s_addr, device=device)


def from_c_stream(obj, *, device):
    """Consume ``__arrow_c_stream__`` -> a list of STRUCT Columns (the
    batches) on ``device``."""
    cap = obj.__arrow_c_stream__()
    addr = _PyCapsule_GetPointer(cap, b"arrow_array_stream")
    st = ArrowArrayStream.from_address(addr)
    out_schema = ArrowSchema()
    rc = st.get_schema(ctypes.pointer(st), ctypes.pointer(out_schema))
    if rc != 0:
        raise OSError(f"get_schema failed: {rc}")
    batches = []
    while True:
        out = ArrowArray()
        rc = st.get_next(ctypes.pointer(st), ctypes.pointer(out))
        if rc != 0:
            raise OSError(f"get_next failed: {rc}")
        if not out.release:
            break
        col = _import_node(out, out_schema, device)
        if out.release:
            out.release(ctypes.pointer(out))
        batches.append(col)
    if out_schema.release:
        out_schema.release(ctypes.pointer(out_schema))
    if st.release:
        st.release(ctypes.pointer(st))
    return batches


def from_c_stream_table(obj, *, device):
    """A Table from ``__arrow_c_stream__`` (its batches one after another)."""
    from cudf_tpu_torch.ops.copying import concatenate_tables

    tables = [_struct_table(b) for b in from_c_stream(obj, device=device)]
    if not tables:
        raise ValueError("an Arrow stream without batches")
    return tables[0] if len(tables) == 1 else concatenate_tables(tables)
