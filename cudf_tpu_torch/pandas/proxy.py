"""Fast/slow proxy machinery for the pandas accelerator (port of
``cudf_tpu/pandas/proxy.py``).

Two concrete proxy classes (DataFrame/Series) hold EITHER a fast
``cudf_tpu_torch`` object or a slow pandas object, converting lazily in
whichever direction a call needs.  Unknown attributes resolve against the
fast object first, then the slow one; results that are port or pandas
frames are re-wrapped so chains stay accelerated (the reference's design,
itself after cudf.pandas' ``fast_slow_proxy.py``).

Where the port differs from the reference:

- Every fast construction and every fast reader or function is given the
  device ``install`` was given (``state["device"]``): the port never
  picks a device itself.
- Kernel build and launch errors, torch's CUDA errors and a missing CUDA
  device are never caught (``_never_caught``): a call that fails on the
  card raises, it does not run again on the CPU.
- The reflected operators, ``__pos__``, ``__round__``, ``__divmod__`` and
  ``__matmul__`` dispatch like the other operators; a proxy pickles to
  its pandas object (to the port's object where there is no slow side)
  and is unhashable, as pandas objects are.
- With no slow side (``state["slow"] is None``: on any device but the
  CPU, and on the CPU where pandas is not importable), a call that would fall
  back counts as slow (``_record(name, False)``) and raises
  ``NoSlowSide``, which names ROADMAP.md item 9.  The places that always
  go to pandas in the reference (dtype-like attributes, private
  attributes, indexes, ``inplace=True`` and the reshapes) resolve from
  the port's object where it has the answer, and raise otherwise
  (numpy's protocols always: the port's objects take neither);
  ``NO_SLOW_ROUTES`` counts each such resolution by route.

Nothing here imports pandas at module level: pandas is the slow side
only on the CPU, and only where it is importable.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import pickle
import sys
import threading
import types
from typing import Any

profiler_stats: dict = {"active": False}

# the device every fast construction goes to, and the slow module (real
# pandas) or None where there is no slow side; set by ``install``
state: dict = {"device": None, "slow": None}

# places the reference always sends to pandas, resolved from the port's
# object where there is no slow side, by route
NO_SLOW_ROUTES: dict = {"force_slow_attr": 0, "private_attr": 0, "index": 0, "inplace": 0,
                        "reshape": 0}

ITEM = "ROADMAP.md item 9 (the pandas accelerator)"


class NoSlowSide(NotImplementedError):
    """A call the port has no fast path for, where there is no slow side
    to fall back to (pandas is not importable)."""


class NoSlowSideAttribute(NoSlowSide, AttributeError):
    """``NoSlowSide`` of an attribute the port's object lacks: also an
    AttributeError, so ``hasattr`` and ``getattr(obj, name, default)``
    keep working."""


class NoDevice(RuntimeError):
    """The device ``install`` was given is not there."""


# Reentrancy guard: while cudf_tpu_torch internals run (fast path), any
# use of the proxied `pandas` module inside them must hit REAL pandas —
# otherwise to_pandas() would construct proxies recursively (the
# reference disables its module accelerator inside the fast library the
# same way).
_guard = threading.local()


@contextlib.contextmanager
def _entering_fast():
    # ``import pandas`` inside also gives real pandas: a library that
    # caches the module at its first import (pyarrow's pandas shim) must
    # not keep the proxy module
    prev = getattr(_guard, "in_fast", False)
    _guard.in_fast = True
    try:
        with _real_pandas_module():
            yield
    finally:
        _guard.in_fast = prev


@contextlib.contextmanager
def _real_pandas_module():
    """``sys.modules["pandas"]`` is real pandas for the duration (where
    there is a slow side)."""
    if state["slow"] is None:
        yield
        return
    held = sys.modules.get("pandas")
    sys.modules["pandas"] = state["slow"]
    try:
        yield
    finally:
        sys.modules["pandas"] = held


def _in_fast() -> bool:
    return getattr(_guard, "in_fast", False)


def _record(name: str, fast: bool):
    if not profiler_stats.get("active"):
        return
    profiler_stats["fast" if fast else "slow"] = profiler_stats.get("fast" if fast else "slow", 0) + 1
    f, s = profiler_stats.setdefault("calls", {}).get(name, (0, 0))
    profiler_stats["calls"][name] = (f + 1, s) if fast else (f, s + 1)


def _has_slow() -> bool:
    return state["slow"] is not None


def _no_slow(name: str, cause: BaseException = None, attribute: bool = False):
    """The fallback where there is no slow side: counted, then raised
    (from ``cause``, the fast side's error, where there is one)."""
    _record(name, False)
    cls = NoSlowSideAttribute if attribute else NoSlowSide
    raise cls(f"{name}: the port has no fast path for this call and there is no slow side "
              f"(pandas) to fall back to ({ITEM})") from cause


def _slow_pandas():
    if state["slow"] is None:
        _no_slow("pandas")
    return state["slow"]


def _device():
    """The device of fast constructions; raises where it is a CUDA device
    and there is none (never a quiet fall back to the CPU)."""
    import torch

    dev = torch.device(state["device"] or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoDevice(f"the accelerator was installed on {dev}, and torch sees no CUDA "
                       "device; install(device='cpu') runs the port on the CPU")
    return dev


def _never_caught(exc: BaseException) -> bool:
    """Errors the fallback lets through: a kernel build or launch error,
    torch's CUDA errors, a missing device, and the no-slow-side error."""
    from cudf_tpu_torch.kernels._build import BuildError, LaunchError

    if isinstance(exc, (BuildError, LaunchError, NoDevice, NoSlowSide)):
        return True
    name = type(exc).__name__
    if name in ("AcceleratorError", "OutOfMemoryError", "CudaError"):
        return True
    return isinstance(exc, RuntimeError) and ("CUDA error" in str(exc)
                                              or "CUDA driver" in str(exc))


def _unwrap(obj, to_fast: bool):
    """Convert proxies / containers into fast or slow domain objects."""
    if isinstance(obj, _FastSlowProxy):
        return obj._fast_obj() if to_fast else obj._slow_obj()
    if isinstance(obj, _AccessorProxy):
        # accessor handed around as a VALUE (e.g. cat(others=s.str)):
        # unwrap to the domain object so receivers see a real accessor
        # (pandas iterates unknown objects via the legacy __getitem__
        # protocol, which never terminates on a proxy)
        if to_fast:
            return obj._raw
        sf = obj.__dict__.get("_slow_factory")
        return sf() if sf is not None else obj._raw
    if getattr(type(obj), "_wb_base", None) is not None:
        return _plain_index(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unwrap(o, to_fast) for o in obj)
    if isinstance(obj, dict):
        return {k: _unwrap(v, to_fast) for k, v in obj.items()}
    return obj


# ----------------------------------------------------------------------
# write-back index wrappers: `df.columns.names = [...]` / `df.index.name
# = ...` must mutate the PROXY, not a temporary copy (upstream pandas
# tests use this idiom constantly; the reference's _IntermediateProxy
# write-back plays the same role)
# ----------------------------------------------------------------------

_WB_CACHE: dict = {}


def _plain_index(idx):
    """Copy a write-back index wrapper back to its plain pandas class
    (asserters do `type(x) is Index` checks — wrappers must not leak)."""
    base = getattr(type(idx), "_wb_base", None)
    if base is None:
        return idx
    out = idx.copy()
    out.__class__ = base
    return out


def _writeback_wrap(idx, parent, attrname: str):
    """Reassign ``idx``'s class to a subclass whose name/names mutations
    write through to ``parent``'s slow domain (fast invalidated)."""
    base = type(idx)
    wb_base = getattr(base, "_wb_base", None)
    if wb_base is not None:
        base = wb_base
    cls = _WB_CACHE.get(base)
    if cls is None:
        def _setattr(self, n, v, _base=base):
            _base.__setattr__(self, n, v)
            if n in ("name", "names"):
                par = self.__dict__.get("_wb_parent")
                at = self.__dict__.get("_wb_attrname")
                if par is not None:
                    try:
                        plain = _plain_index(self)
                        setattr(par._slow_obj(), at, plain)
                        par._invalidate_fast()
                    except Exception:
                        pass
        # pandas gates engine/libjoin fast paths on `type(self) is Index`
        # (core/indexes/base.py); a subclass silently takes the wrong
        # branch.  Delegate the identity-sensitive members by flipping the
        # instance's class to the base for the duration of the call.
        def _as_base(self, member, _base=base):
            cls_ = self.__class__
            self.__class__ = _base
            try:
                return getattr(self, member)
            finally:
                self.__class__ = cls_

        def _get_engine_target(self):
            return _as_base(self, "_get_engine_target")()

        def _get_join_target(self):
            return _as_base(self, "_get_join_target")()

        cls = type(f"_WB{base.__name__}", (base,),
                   {"__setattr__": _setattr, "_wb_base": base,
                    "_get_engine_target": _get_engine_target,
                    "_get_join_target": _get_join_target,
                    "_can_use_libjoin": property(
                        lambda self: _as_base(self, "_can_use_libjoin")),
                    "_engine": property(
                        lambda self: _as_base(self, "_engine"))})
        # repr uses type(self).__name__ — don't leak the wrapper name
        cls.__name__ = base.__name__
        _WB_CACHE[base] = cls
    try:
        idx.__class__ = cls
    except TypeError:
        return idx
    idx.__dict__["_wb_parent"] = parent
    idx.__dict__["_wb_attrname"] = attrname
    return idx


_INDEXERS = ("_DataFrameLoc", "_DataFrameILoc", "_SeriesLoc", "_SeriesILoc",
             "_LocIndexer", "_ILocIndexer")
_ACCESSOR_ATTRS = {"StringMethods": "str", "DatetimeProperties": "dt",
                   "CategoricalAccessor": "cat"}


def _wrap(result):
    """Wrap fast/slow results back into proxies where appropriate."""
    from cudf_tpu_torch.frame.dataframe import DataFrame as _FastFrame
    from cudf_tpu_torch.frame.index import Index as _FastIndex
    from cudf_tpu_torch.frame.series import Series as _FastSeries

    if isinstance(result, _FastFrame):
        return ProxyDataFrame(fast=result)
    if isinstance(result, _FastSeries):
        return ProxySeries(fast=result)
    pd = state["slow"]
    if pd is not None:
        if isinstance(result, pd.DataFrame):
            return ProxyDataFrame(slow=result)
        if isinstance(result, pd.Series):
            return ProxySeries(slow=result)
    if isinstance(result, _FastIndex):
        # indexes cross the boundary as real pandas objects: pandas
        # internals isinstance-check them constantly and they're small
        # relative to column data (reference wraps them as proxies too);
        # with no slow side the port's Index is the answer
        if pd is None:
            NO_SLOW_ROUTES["index"] += 1
            return result
        with _entering_fast():
            return result.to_pandas()
    frames = (_FastFrame, _FastSeries) + ((pd.DataFrame, pd.Series) if pd is not None else ())
    if isinstance(result, (list, tuple)) and any(isinstance(r, frames) for r in result):
        return type(result)(_wrap(r) for r in result)
    if type(result).__name__ in _INDEXERS:
        return _IndexerProxy(result)
    module = type(result).__module__
    if module == "cudf_tpu_torch.frame.accessors":
        # namespace accessors fall back PER-CALL to the pandas accessor
        # of the same name (exotic signatures, regex long tail) — the
        # fast_slow_proxy retry discipline
        acc_attr = _ACCESSOR_ATTRS.get(type(result).__name__)
        s = getattr(result, "_s", None)
        if acc_attr is not None and s is not None and pd is not None:
            def _slow_acc(_s=s, _a=acc_attr):
                with _entering_fast():
                    slow = _s.to_pandas()
                return getattr(slow, _a)

            return _AccessorProxy(result, _slow_acc)
        return _AccessorProxy(result)
    if module in ("cudf_tpu_torch.frame.groupby", "cudf_tpu_torch.frame.window",
                  "cudf_tpu_torch.frame.resample"):
        return _AccessorProxy(result)
    return result


def _holds_callable(obj) -> bool:
    """True when a user callable (UDF) hides anywhere in the argument —
    a lambda, np.sum, a partial, or one nested in a list/dict agg spec."""
    if isinstance(obj, (list, tuple, set)):
        return any(_holds_callable(o) for o in obj)
    if isinstance(obj, dict):
        return any(_holds_callable(v) for v in obj.values())
    return callable(obj) and not isinstance(obj, (type, str))


class _AccessorProxy:
    """Wraps fast-domain accessors / GroupBy / Rolling objects so their
    results re-enter the proxy domain.  ``slow_factory`` lazily builds
    the pandas counterpart for per-CALL fallback (UDF aggs, exotic
    signatures) — the fast_slow_proxy retry-on-slow pattern."""

    def __init__(self, raw, slow_factory=None):
        object.__setattr__(self, "_raw", raw)
        object.__setattr__(self, "_slow_factory", slow_factory)

    def __getattr__(self, name):
        attr = getattr(self._raw, name, None)
        if attr is None and self._slow_factory is None:
            if not _has_slow():
                _no_slow(name, attribute=True)
            raise AttributeError(name)
        if attr is None or callable(attr):
            def call(*a, **k):
                # UDF-shaped calls (apply/filter/pipe, or any callable in
                # the agg spec) go straight to real pandas: per-group
                # Python execution gains nothing on device and the result
                # shape rules are pandas-internal (the reference routes
                # JIT-incompatible UDFs the same way); with no slow side
                # the port runs them
                skip_fast = self._slow_factory is not None and (
                    name in ("apply", "filter", "pipe", "aggregate", "agg",
                             "transform") and
                    (_holds_callable(a) or _holds_callable(k)))
                if attr is not None and not skip_fast:
                    try:
                        with _entering_fast():
                            out = attr(*_unwrap(a, True), **_unwrap(k, True))
                        _record(name, True)
                        return _wrap(out)
                    except Exception as e:
                        if _never_caught(e):
                            raise
                        if not _has_slow():
                            _no_slow(name, e)
                        if self._slow_factory is None:
                            raise
                slow = self._slow_factory()
                out = getattr(slow, name)(*_unwrap(a, False), **_unwrap(k, False))
                _record(name, False)
                return _wrap(out)

            if attr is not None:
                functools.update_wrapper(
                    call, attr, assigned=("__name__", "__doc__"), updated=())
            return call
        return _wrap(attr)

    def __getitem__(self, key):
        res = _wrap(self._raw[_unwrap(key, True)])
        if isinstance(res, _AccessorProxy) and res._slow_factory is None \
                and self._slow_factory is not None:
            def make_slow(sf=self._slow_factory, k=key):
                return sf()[_unwrap(k, False)]
            object.__setattr__(res, "_slow_factory", make_slow)
        return res

    def __iter__(self):
        for item in self._raw:
            if isinstance(item, tuple):
                yield tuple(_wrap(x) for x in item)
            else:
                yield _wrap(item)


class _IndexerProxy:
    """Wraps .loc/.iloc indexers so their results re-enter the proxy
    domain; mutations fall back to the slow object (pandas semantics for
    upcasts/raises) and invalidate the stale representation."""

    def __init__(self, raw, parent=None, name=None, raw_is_fast=True):
        self._raw = raw
        self._parent = parent
        self._name = name
        self._raw_is_fast = raw_is_fast

    def _slow_indexer(self):
        if self._parent is None or self._name is None or not _has_slow():
            return None
        return getattr(self._parent._slow_obj(), self._name)

    def __getitem__(self, key):
        try:
            with _entering_fast():
                out = self._raw[_unwrap(key, self._raw_is_fast)]
            return _wrap(out)
        except Exception as e:
            if _never_caught(e):
                raise
            slow = self._slow_indexer()
            if slow is None:
                if not _has_slow():
                    _no_slow(self._name or "indexer", e)
                raise
            _record(self._name or "indexer", False)
            return _wrap(slow[_unwrap(key, False)])

    def __setitem__(self, key, value):
        if not self._raw_is_fast:
            # slow-domain indexer: mutate in place with exact pandas
            # semantics (upcast TypeErrors must surface) and mark the
            # FAST side stale — wiping slow here would orphan the proxy
            self._raw[_unwrap(key, False)] = _unwrap(value, False)
            if self._parent is not None:
                self._parent._invalidate_fast()
            _record(self._name or "indexer", False)
            return
        try:
            with _entering_fast():
                self._raw[_unwrap(key, True)] = _unwrap(value, True)
            if self._parent is not None:
                self._parent._invalidate_slow()
        except Exception as e:
            if _never_caught(e):
                raise
            slow = self._slow_indexer()
            if slow is None:
                if not _has_slow():
                    _no_slow(self._name or "indexer", e)
                raise
            slow[_unwrap(key, False)] = _unwrap(value, False)
            self._parent._invalidate_fast()
            _record(self._name or "indexer", False)


class _ProxyMeta(type):
    """isinstance(real_pandas_obj, ProxyClass) must hold: pandas submodules
    imported lazily after install() bind ProxyDataFrame as `DataFrame` and
    run isinstance checks against it with real objects
    (reference: _FastSlowProxyMeta)."""

    def __getattr__(cls, name):
        # pandas-internal code reaches class attributes on the proxied
        # DataFrame/Series (e.g. concat → DataFrame._get_axis_number);
        # delegate unknown class attrs to the real pandas class
        if name.startswith("__") or name == "_real_class":
            raise AttributeError(name)
        real = cls.__dict__.get("_real_class")
        if real is None:
            for base in cls.__mro__:
                real = base.__dict__.get("_real_class")
                if real is not None:
                    break
        if real is not None:
            return getattr(real, name)
        raise AttributeError(name)

    def __instancecheck__(cls, obj):
        if type.__instancecheck__(cls, obj):
            return True
        real = getattr(cls, "_real_class", None)
        return real is not None and isinstance(obj, real)


class _FastSlowProxy:
    _fast: Any = None
    _slow: Any = None
    # pandas objects are unhashable; so is a proxy of one
    __hash__ = None

    def __init__(self, fast=None, slow=None):
        object.__setattr__(self, "_fast", fast)
        object.__setattr__(self, "_slow", slow)

    @property
    def __class__(self):
        # isinstance(proxy, real pandas.Series/DataFrame) must hold for
        # pandas-internal code imported BEFORE install() (e.g.
        # pandas._testing.asserters binds the real classes at import) —
        # same trick as the reference (fast_slow_proxy.py __class__)
        real = getattr(type(self), "_real_class", None)
        return real if real is not None else type(self)

    def __reduce_ex__(self, protocol):
        # the reported __class__ is the real class, which pickle's
        # __newobj__ check refuses for a proxy, and `pandas.Series` names
        # the proxy class while installed: pickle the pandas object (the
        # port's object where there is no slow side) with the name
        # `pandas` bound to real pandas
        if _has_slow():
            obj = self._slow_obj()
            with _real_pandas_module():
                return _unpickle, (pickle.dumps(obj, protocol),)
        return _unpickle, (pickle.dumps(self._fast_obj(), protocol),)

    # domain transport -------------------------------------------------
    def _fast_obj(self):
        if self._fast is None:
            import cudf_tpu_torch

            _check_fast_convertible(self._slow)
            with _entering_fast():
                object.__setattr__(self, "_fast",
                                   cudf_tpu_torch.from_pandas(self._slow, device=_device()))
        return self._fast

    def _slow_obj(self):
        if self._slow is None:
            if not _has_slow():
                _no_slow("to_pandas")
            with _entering_fast():
                slow = self._fast.to_pandas()
                # pandas mutates in place (fillna(inplace=True),
                # __setitem__) — hand the slow domain its own memory
                try:
                    slow = slow.copy(deep=True)
                except Exception:
                    pass
            at = self.__dict__.get("_proxy_attrs")
            if at:
                slow.attrs = dict(at)
            object.__setattr__(self, "_slow", slow)
        return self._slow

    # pandas metadata dict, retained through method calls (__finalize__
    # semantics); lives on the proxy so fast-path results keep it
    @property
    def attrs(self):
        d = self.__dict__.get("_proxy_attrs")
        if d is None:
            slow = self.__dict__.get("_slow")
            if slow is not None and getattr(slow, "attrs", None):
                d = dict(slow.attrs)
            else:
                d = {}
            object.__setattr__(self, "_proxy_attrs", d)
        return d

    @attrs.setter
    def attrs(self, value):
        object.__setattr__(self, "_proxy_attrs", dict(value))
        slow = self.__dict__.get("_slow")
        if slow is not None:
            slow.attrs = dict(value)

    def _invalidate_fast(self):
        object.__setattr__(self, "_fast", None)

    def _invalidate_slow(self):
        object.__setattr__(self, "_slow", None)

    def __finalize__(self, other, method=None, **kwargs):
        """pandas NDFrame metadata-propagation hook: user code and
        pandas internals call result.__finalize__(orig) on proxies.  Copy
        attrs, return self."""
        try:
            src = getattr(other, "attrs", None)
            if src:
                object.__setattr__(self, "_proxy_attrs", dict(src))
        except Exception:
            pass
        return self

    # attribute dispatch ----------------------------------------------
    def __getattr__(self, name):
        if name.startswith("_"):
            if name.startswith("__") or name in ("_fast", "_slow"):
                raise AttributeError(name)
            # pandas-internal private API (_values, _mgr, ...): serve from
            # the slow domain so pandas' own code paths (asserters,
            # indexing internals) work against proxies; with no slow side
            # from the port's object where it has the attribute
            if not _has_slow():
                fast = self._fast_obj()
                if hasattr(fast, name):
                    NO_SLOW_ROUTES["private_attr"] += 1
                    return getattr(fast, name)
                _no_slow(name, attribute=True)
            return getattr(self._slow_obj(), name)
        return _FastSlowAttr(self, name).resolve()

    def __setattr__(self, name, value):
        if name.startswith("_"):
            object.__setattr__(self, name, value)
            return
        if name == "attrs":
            _FastSlowProxy.attrs.fset(self, value)
            return
        # mutate both domains coherently: apply to the current primary
        try:
            if name in ("index", "columns"):
                import numpy as np

                vdt = getattr(value, "dtype", None)
                if _unsupported_ext_dtype(value) or (
                        isinstance(vdt, np.dtype) and vdt == np.dtype("O")):
                    # object/Period/Interval axes must not enter the
                    # fast domain (stringification would change dtype)
                    raise TypeError("extension axis — slow path")
            with _entering_fast():
                fast = self._fast_obj()
                if hasattr(fast, "_table") and name in fast._table.names:
                    # pandas attribute-style COLUMN assignment (df.col = ...)
                    # only updates existing columns; plain setattr on the
                    # fast frame would silently create an instance attribute
                    fast[name] = _unwrap(value, True)
                else:
                    setattr(fast, name, _unwrap(value, True))
            self._invalidate_slow()
        except Exception as e:
            if _never_caught(e):
                raise
            if not _has_slow():
                _no_slow(name, e)
            setattr(self._slow_obj(), name, _unwrap(value, False))
            self._invalidate_fast()

    # common dunders ---------------------------------------------------
    def __len__(self):
        return len(self._fast if self._fast is not None else self._slow)

    def __repr__(self):
        # pandas' own repr where there is a slow side
        if _has_slow():
            return repr(self._slow_obj())
        return repr(self._fast)

    def __iter__(self):
        return iter(self._fast if self._fast is not None else self._slow_obj())

    def __array__(self, dtype=None, copy=None):
        import numpy as np

        base = self._fast if self._fast is not None else self._slow
        with _entering_fast():
            arr = base.to_numpy() if hasattr(base, "to_numpy") else base
        return np.asarray(arr, dtype=dtype)

    # numpy interception (the _wrappers/numpy.py table role): ufuncs and
    # array functions applied to proxies route through the slow pandas
    # object (which preserves index/name semantics) and wrap back; the
    # port's objects take neither protocol, so with no slow side they raise
    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        if not _has_slow():
            _no_slow(f"np.{ufunc.__name__}")
        inputs = tuple(_unwrap(i, False) for i in inputs)
        kwargs = {k: _unwrap(v, False) for k, v in kwargs.items()}
        out = getattr(ufunc, method)(*inputs, **kwargs)
        _record(f"np.{ufunc.__name__}", False)
        return _wrap(out)

    def __array_function__(self, func, types, args, kwargs):
        if not _has_slow():
            _no_slow(f"np.{func.__name__}")
        args = _unwrap(args, False)
        kwargs = {k: _unwrap(v, False) for k, v in kwargs.items()}
        out = func(*args, **kwargs)
        _record(f"np.{func.__name__}", False)
        return _wrap(out)

    def __getitem__(self, key):
        return _dispatch_call(self, "__getitem__", (key,), {})

    def __setitem__(self, key, value):
        if self._fast is None:
            # slow-resident: mutate in place with exact pandas semantics
            # (incompatible-value TypeErrors/upcasts must surface; a fast
            # conversion round-trip would mask them)
            self._slow_obj()[_unwrap(key, False)] = _unwrap(value, False)
            self._invalidate_fast()
            _record("__setitem__", False)
            return
        try:
            with _entering_fast():
                self._fast_obj()[_unwrap(key, True)] = _unwrap(value, True)
            self._invalidate_slow()
            _record("__setitem__", True)
        except Exception as e:
            if _never_caught(e):
                raise
            if not _has_slow():
                _no_slow("__setitem__", e)
            self._slow_obj()[_unwrap(key, False)] = _unwrap(value, False)
            self._invalidate_fast()
            _record("__setitem__", False)

    def to_pandas(self):
        return self._slow_obj()




def _unpickle(payload: bytes):
    """A pickled proxy: its pandas (or port) object, as a proxy while the
    accelerator is installed."""
    if state["slow"] is not None:
        with _real_pandas_module():
            obj = pickle.loads(payload)
    else:
        obj = pickle.loads(payload)
    installed = getattr(sys.modules.get("pandas"), "DataFrame", None) is ProxyDataFrame
    return _wrap(obj) if installed else obj


def _is_object_dtype_req(t) -> bool:
    import numpy as np

    try:
        if t is object or t is np.object_ or (
                isinstance(t, (str, np.dtype)) and t == "object"):
            return True
        # the NA-variant extension string dtype ('string' / StringDtype
        # with pd.NA) is distinct from pandas-3's default 'str' (nan);
        # the reference's fast layer models only the latter
        if isinstance(t, str) and t in ("string", "string[python]",
                                        "string[pyarrow]"):
            return True
        if type(t).__name__ == "StringDtype" and state["slow"] is not None:
            return t.na_value is state["slow"].NA
    except Exception:
        return False
    return False


_RESHAPES = ("pivot", "pivot_table", "unstack", "stack", "crosstab", "transpose", "T", "melt",
             "swaplevel", "reorder_levels")


def _force_slow_call(name: str, args, kwargs) -> bool:
    """Calls whose fast-domain semantics legitimately differ from pandas
    go straight to the slow object.  astype(object): the columnar layer
    maps object→string (cudf parity, the reference does the same), but
    proxy users need a genuine object-dtype pandas result."""
    if name == "astype":
        return _is_object_dtype_req(args[0] if args else kwargs.get("dtype"))
    if name == "convert_dtypes":
        # result dtypes are pandas nullable extension dtypes (Int64,
        # string[pd.NA], boolean) — only dtype bookkeeping, no compute
        return True
    # reshape results are MultiIndex-heavy (index/columns levels, names,
    # categorical index classes): proxy users get the metadata-faithful
    # pandas result
    return name in _RESHAPES


def _dispatch_call(proxy: _FastSlowProxy, name: str, args, kwargs):
    if kwargs.get("inplace") is True:
        # in-place mutation with pandas identity semantics (returns
        # None, receiver object mutates): run on the slow object and
        # mark fast stale — a fast call would hand back a new frame.
        # With no slow side the port computes the new value and the
        # proxy takes it
        if not _has_slow():
            rest = {k: v for k, v in kwargs.items() if k != "inplace"}
            with _entering_fast():
                out = getattr(proxy._fast_obj(), name)(*_unwrap(args, True),
                                                       **_unwrap(rest, True))
            object.__setattr__(proxy, "_fast", out)
            NO_SLOW_ROUTES["inplace"] += 1
            _record(name, True)
            return None
        with _entering_fast():
            slow = proxy._slow_obj()
        out = getattr(slow, name)(*_unwrap(args, False),
                                  **_unwrap(kwargs, False))
        proxy._invalidate_fast()
        _record(name, False)
        if out is slow:
            return proxy              # pandas-3 inplace returns self
        return _wrap(out)
    if _force_slow_call(name, args, kwargs):
        if not _has_slow():
            if name in _RESHAPES and hasattr(proxy._fast_obj(), name):
                NO_SLOW_ROUTES["reshape"] += 1
            else:
                _no_slow(name)
        else:
            with _entering_fast():
                slow = proxy._slow_obj()
            out = getattr(slow, name)(*_unwrap(args, False),
                                      **_unwrap(kwargs, False))
            _record(name, False)
            return _wrap(out)
    try:
        with _entering_fast():
            fast = proxy._fast_obj()
            fn = getattr(fast, name)
            out = fn(*_unwrap(args, True), **_unwrap(kwargs, True))
        _record(name, True)
        res = _wrap(out)
        at = proxy.__dict__.get("_proxy_attrs")
        if at and isinstance(res, _FastSlowProxy):
            object.__setattr__(res, "_proxy_attrs", dict(at))
        if isinstance(res, _AccessorProxy) and res._slow_factory is None and _has_slow():
            def make_slow(p=proxy, nm=name, a=args, k=kwargs):
                return getattr(p._slow_obj(), nm)(*_unwrap(a, False),
                                                  **_unwrap(k, False))
            object.__setattr__(res, "_slow_factory", make_slow)
        return res
    except Exception as e:
        if _never_caught(e):
            raise
        if not _has_slow():
            _no_slow(name, e)
        with _entering_fast():
            slow = proxy._slow_obj()
        fn = getattr(slow, name)
        out = fn(*_unwrap(args, False), **_unwrap(kwargs, False))
        _record(name, False)
        return _wrap(out)


def _check_fast_convertible(slow) -> None:
    """Refuse the fast domain for pandas extension dtypes whose masked /
    arrow-backed semantics the reference's columnar layer would flatten
    to numpy — such objects stay ENTIRELY on the slow path, preserving
    dtype fidelity (the curated-surface discipline of the reference's
    _wrappers/pandas.py: unsupported types never enter the fast domain)."""
    import numpy as np

    pd = _slow_pandas()
    from pandas.api.types import is_extension_array_dtype

    def bad(dtype) -> bool:
        if not is_extension_array_dtype(dtype):
            # true object columns hold arbitrary python values; the
            # columnar layer would stringify them
            return isinstance(dtype, np.dtype) and dtype == np.dtype("O")
        if isinstance(dtype, pd.CategoricalDtype):
            return False                      # dictionary-encoded: fast
        if isinstance(dtype, pd.DatetimeTZDtype):
            return False                      # tz layer handles these
        try:
            from pandas.core.dtypes.dtypes import BaseMaskedDtype

            if isinstance(dtype, BaseMaskedDtype):
                return True                   # Int64/Float64/boolean
        except ImportError:
            pass
        if isinstance(dtype, pd.StringDtype):
            # 'string' (pd.NA variant) is a distinct extension dtype;
            # only pandas-3's default 'str' (nan) maps to fast columns
            return dtype.na_value is pd.NA
        return isinstance(dtype, (pd.ArrowDtype, pd.PeriodDtype,
                                  pd.IntervalDtype, pd.SparseDtype))

    dtypes = []
    if isinstance(slow, pd.DataFrame):
        dtypes = list(slow.dtypes) + [slow.index.dtype,
                                      slow.columns.dtype]
    elif isinstance(slow, pd.Series):
        dtypes = [slow.dtype, slow.index.dtype]
    for d in dtypes:
        if bad(d):
            raise TypeError(
                f"pandas extension dtype {d} stays on the slow path")


_INDEXER_TYPES = ("seriesloc", "seriesiloc", "dataframeloc", "dataframeiloc",
                  "locindexer", "ilocindexer", "atindexer", "iatindexer")


class _FastSlowAttr:
    """Attribute that may be a method (call-dispatched) or a value."""

    def __init__(self, proxy: _FastSlowProxy, name: str):
        self._proxy = proxy
        self._name = name

    # attrs pandas internals consume structurally: must be REAL pandas/
    # numpy objects (np.dtype etc.), so resolve from the slow object.
    # T: the columnar layer can't carry axis names through a transpose
    _FORCE_SLOW = {"dtype", "dtypes", "attrs", "flags", "T"}

    def resolve(self):
        p, name = self._proxy, self._name
        if name in self._FORCE_SLOW:
            if not _has_slow():
                with _entering_fast():
                    fast = p._fast_obj()
                    if not hasattr(fast, name):
                        _no_slow(name, attribute=True)
                    out = getattr(fast, name)
                NO_SLOW_ROUTES["force_slow_attr"] += 1
                _record(name, True)
                return _wrap(out)
            _record(name, False)
            return _wrap(getattr(p._slow_obj(), name))
        try:
            with _entering_fast():
                attr = getattr(p._fast if p._fast is not None else p._fast_obj(), name)
            is_fast = True
        except Exception as e:
            if _never_caught(e):
                raise
            if not _has_slow():
                _no_slow(name, e, attribute=isinstance(e, AttributeError))
            attr = getattr(p._slow_obj(), name)
            is_fast = False
        # indexers are CALLABLE in pandas (loc(axis=...)) — never wrap
        # them as methods; carry the parent for slow-fallback mutation
        if type(attr).__name__.lstrip("_").lower() in _INDEXER_TYPES:
            _record(name, is_fast)
            return _IndexerProxy(attr, parent=p, name=name, raw_is_fast=is_fast)
        if name in ("columns", "index"):
            _record(name, is_fast)
            out = _wrap(attr)
            pd = state["slow"]
            if pd is not None and isinstance(out, pd.Index):
                out = _writeback_wrap(out, p, name)
            return out
        if callable(attr) and not isinstance(attr, type):
            def method(*args, **kwargs):
                return _dispatch_call(p, name, args, kwargs)

            functools.update_wrapper(method, attr, assigned=("__name__", "__doc__"), updated=())
            return method
        _record(name, is_fast)
        return _wrap(attr)


# the binary operators and their reflections, all dispatched alike
_BINARY = ["__add__", "__sub__", "__mul__", "__truediv__", "__floordiv__", "__mod__",
           "__pow__", "__matmul__", "__divmod__", "__eq__", "__ne__", "__lt__", "__gt__",
           "__le__", "__ge__", "__and__", "__or__", "__xor__",
           "__radd__", "__rsub__", "__rmul__", "__rtruediv__", "__rfloordiv__", "__rmod__",
           "__rpow__", "__rmatmul__", "__rdivmod__", "__rand__", "__ror__", "__rxor__"]
_UNARY = ["__invert__", "__neg__", "__pos__", "__abs__"]


def _make_binops(cls):
    for dunder in _BINARY:
        def make(d=dunder):
            def f(self, other):
                return _dispatch_call(self, d, (other,), {})
            f.__name__ = d
            return f
        setattr(cls, dunder, make())
    for undunder in _UNARY:
        def make1(d=undunder):
            def f(self):
                return _dispatch_call(self, d, (), {})
            f.__name__ = d
            return f
        setattr(cls, undunder, make1())

    def __round__(self, ndigits=0):
        # round(s, n) is the round method, in pandas as in the port
        return _dispatch_call(self, "round", (ndigits,), {})
    cls.__round__ = __round__


class ProxyDataFrame(_FastSlowProxy, metaclass=_ProxyMeta):
    def __new__(cls, *args, fast=None, slow=None, **kwargs):
        if _in_fast() and fast is None and slow is None:
            # cudf_tpu_torch internals asked for a real pandas DataFrame
            return _slow_pandas().DataFrame(*args, **kwargs)
        return super().__new__(cls)

    def __init__(self, *args, fast=None, slow=None, **kwargs):
        if fast is not None or slow is not None:
            super().__init__(fast=fast, slow=slow)
            return
        # user constructed pd.DataFrame(...) — try fast first
        import cudf_tpu_torch

        dev = _device()
        try:
            if _is_object_dtype_req(kwargs.get("dtype")) \
                    or _unsupported_ext_dtype(kwargs.get("index")) \
                    or _unsupported_ext_dtype(kwargs.get("columns")) \
                    or any(_unsupported_ext_dtype(a) for a in args[:3]) \
                    or (args and isinstance(args[0], dict) and any(
                        _unsupported_ext_dtype(v) for v in args[0].values())):
                raise TypeError("unsupported dtype — slow construction")
            with _entering_fast():
                f = cudf_tpu_torch.DataFrame(*_unwrap(args, True), device=dev,
                                             **_unwrap(kwargs, True))
            super().__init__(fast=f)
            _record("DataFrame", True)
        except Exception as e:
            if _never_caught(e):
                raise
            if not _has_slow():
                _no_slow("DataFrame", e)
            pd = _slow_pandas()
            super().__init__(slow=pd.DataFrame(*_unwrap(args, False), **_unwrap(kwargs, False)))
            _record("DataFrame", False)


def _unsupported_ext_dtype(obj) -> bool:
    dt = getattr(obj, "dtype", None)
    return dt is not None and type(dt).__name__ in (
        "PeriodDtype", "IntervalDtype", "SparseDtype")


def _fast_safe_data(args, kwargs=None) -> bool:
    """False when the payload holds python objects the fast library would
    silently coerce (np.dtype instances, tuples, sets, …) — those must
    construct on the slow side to keep type fidelity."""
    if kwargs and _unsupported_ext_dtype(kwargs.get("index")):
        return False
    if len(args) > 1 and _unsupported_ext_dtype(args[1]):
        return False
    if not args:
        return True
    data = args[0]
    import numpy as np

    if isinstance(data, np.ndarray) and data.dtype == object:
        # object ndarrays keep object dtype in pandas-3; the fast layer
        # would stringify — stay slow for dtype fidelity (plain python
        # lists still infer str/numeric and take the fast path)
        return False
    if isinstance(data, (list, tuple)):
        import datetime

        ok = (type(None), bool, int, float, complex, str, bytes,
              datetime.date, datetime.datetime, datetime.timedelta,
              np.generic)
        return all(isinstance(x, ok) or (x != x if isinstance(x, float)
                                         else False) for x in data)
    # Period/Interval/Sparse containers must construct slow — the fast
    # library has no equivalent and would silently coerce them to their
    # integer storage
    if _unsupported_ext_dtype(data):
        return False
    if isinstance(data, dict):
        return not any(_unsupported_ext_dtype(v) for v in data.values())
    return True


class ProxySeries(_FastSlowProxy, metaclass=_ProxyMeta):
    def __new__(cls, *args, fast=None, slow=None, **kwargs):
        if _in_fast() and fast is None and slow is None:
            return _slow_pandas().Series(*args, **kwargs)
        return super().__new__(cls)

    def __init__(self, *args, fast=None, slow=None, **kwargs):
        if fast is not None or slow is not None:
            super().__init__(fast=fast, slow=slow)
            return
        import cudf_tpu_torch

        dev = _device()
        try:
            if not _fast_safe_data(args, kwargs) or \
                    _is_object_dtype_req(kwargs.get("dtype")):
                raise TypeError("object payload — slow construction")
            with _entering_fast():
                f = cudf_tpu_torch.Series(*_unwrap(args, True), device=dev,
                                          **_unwrap(kwargs, True))
            super().__init__(fast=f)
            _record("Series", True)
        except Exception as e:
            if _never_caught(e):
                raise
            if not _has_slow():
                _no_slow("Series", e)
            pd = _slow_pandas()
            super().__init__(slow=pd.Series(*_unwrap(args, False), **_unwrap(kwargs, False)))
            _record("Series", False)


_make_binops(ProxyDataFrame)
_make_binops(ProxySeries)

# functions routed to the fast library first
_FAST_FUNCS = {
    "read_csv", "read_parquet", "read_json", "read_feather", "read_orc",
    "concat", "merge", "to_datetime", "to_numeric", "get_dummies", "melt",
    "isna", "isnull", "notna", "notnull", "unique", "factorize", "cut", "qcut",
    "date_range", "crosstab", "pivot_table",
}


_PANDAS_DIR = None


def _caller_is_pandas_internal() -> bool:
    """pandas internals sometimes re-import from the top-level package at
    runtime (e.g. merge's ``from pandas import concat``) and would
    receive our proxied functions; a proxy leaking into pandas' own code
    paths breaks it.  The reference's ModuleAccelerator solves this the
    same way — detect a pandas-internal caller and hand back plain pandas
    behavior (module_accelerator.py caller-path check)."""
    global _PANDAS_DIR
    if not _has_slow():
        return False
    if _PANDAS_DIR is None:
        import os

        _PANDAS_DIR = os.path.dirname(_slow_pandas().__file__) + os.sep
    try:
        fname = sys._getframe(2).f_code.co_filename
    except ValueError:
        return False
    return fname.startswith(_PANDAS_DIR)


def _takes_device(fn) -> bool:
    try:
        return "device" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


def _proxy_function(name: str, slow_fn):
    def f(*args, **kwargs):
        import cudf_tpu_torch

        if _in_fast():
            if slow_fn is None:
                _no_slow(name)
            return slow_fn(*args, **kwargs)
        if _caller_is_pandas_internal():
            return slow_fn(*_unwrap(args, False), **_unwrap(kwargs, False))
        fast_fn = getattr(cudf_tpu_torch, name, None)
        if fast_fn is not None:
            try:
                fast_kwargs = _unwrap(kwargs, True)
                if _takes_device(fast_fn) and "device" not in fast_kwargs:
                    fast_kwargs["device"] = _device()
                with _entering_fast():
                    out = fast_fn(*_unwrap(args, True), **fast_kwargs)
                _record(name, True)
                return _wrap(out)
            except Exception as e:
                if _never_caught(e):
                    raise
                if slow_fn is None:
                    _no_slow(name, e)
        if slow_fn is None:
            _no_slow(name)
        out = slow_fn(*_unwrap(args, False), **_unwrap(kwargs, False))
        _record(name, False)
        return _wrap(out)

    if slow_fn is not None:
        functools.update_wrapper(f, slow_fn)
    else:
        f.__name__ = f.__qualname__ = name
    return f


_LAZY_SUBMODULES = [
    "pandas.io.formats.style",
    "pandas.io.formats.format",
    "pandas.api.types",
    "pandas.testing",
    "pandas.plotting",
]


def make_proxy_module(real_pandas) -> types.ModuleType:
    """The module that stands for ``pandas``: the proxy classes and
    ``_FAST_FUNCS`` over ``real_pandas``, the slow side, or over nothing
    (``real_pandas`` None: every other name raises ``NoSlowSide``)."""
    ProxyDataFrame._real_class = getattr(real_pandas, "DataFrame", None)
    ProxySeries._real_class = getattr(real_pandas, "Series", None)
    mod = types.ModuleType("pandas")
    mod.__dict__["__proxy_for__"] = real_pandas
    if real_pandas is not None:
        # import lazily-loaded submodules NOW so their `from pandas import
        # DataFrame` binds the real class, not the proxy
        import importlib

        for name in _LAZY_SUBMODULES:
            try:
                importlib.import_module(name)
            except Exception:
                pass
        for name in dir(real_pandas):
            if name.startswith("_"):
                continue
            mod.__dict__[name] = getattr(real_pandas, name)
        mod.__dict__["__version__"] = real_pandas.__version__
    mod.DataFrame = ProxyDataFrame
    mod.Series = ProxySeries
    for name in _FAST_FUNCS:
        slow_fn = getattr(real_pandas, name, None)
        if real_pandas is None or slow_fn is not None:
            mod.__dict__[name] = _proxy_function(name, slow_fn)

    def __getattr__(n):
        if real_pandas is not None:
            return getattr(real_pandas, n)
        if n.startswith("__"):
            raise AttributeError(n)
        _no_slow(f"pandas.{n}", attribute=True)

    mod.__dict__["__getattr__"] = __getattr__
    return mod
