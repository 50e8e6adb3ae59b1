"""Device-to-host spilling of cold column buffers (port of
``cudf_tpu/utils/spill.py``; cudf's SpillManager and SpillableBuffer).

- ``SpillManager.register(col)`` keeps a weak reference to a column and
  its last access; ``touch`` marks it used.
- ``spill(col)`` copies each of the column's device buffers into a pinned
  host tensor (a non-blocking copy, synchronised before the device tensor
  is dropped) and puts a ``HostSpilled`` marker in its place.  The column
  keeps its logical device; its ``_cache`` (which may hold device
  tensors) is dropped.  Any op that reaches a marker raises
  ``SpilledBufferError``: nothing computes on the host copy.  A
  dictionary's keys stay on the device: every column over that dictionary
  shares them, the frames the executor reads from included.
- ``ensure_on_device(col)`` copies the markers back (bit for bit).
- ``spill_to_budget(budget)`` spills coldest first until the device
  bytes that spilling can release fit the budget.  Bytes are counted once
  a storage: a storage that something outside the registered columns also
  holds (a resident frame that partitions view) is neither counted nor
  spilled, since spilling its views releases nothing.
- The bytes reported as freed are those of storages that were released,
  checked after the device tensors were dropped (a weak reference to each
  storage): a view of a storage that something else still holds frees
  nothing and is reported so.

On the CPU a spill still moves each buffer into a marker (a copy), so the
same code runs in the CPU tests.
"""

from __future__ import annotations

import itertools
import weakref
from typing import Dict, List, Optional

import torch

__all__ = ["HostSpilled", "SpillManager", "SpillStatistics", "SpilledBufferError",
           "get_spill_manager", "spill", "unspill"]

_ATTRS = ("data", "validity", "offsets")


class SpilledBufferError(RuntimeError):
    """An op reached a buffer that was spilled to the host."""


class SpillStatistics:
    """``spills``/``unspills`` count columns moved; ``bytes_spilled`` and
    ``bytes_unspilled`` the bytes copied each way; ``bytes_freed`` the
    bytes of device storage the spills released."""

    def __init__(self):
        self.spills = 0
        self.unspills = 0
        self.bytes_spilled = 0
        self.bytes_unspilled = 0
        self.bytes_freed = 0

    def as_dict(self) -> dict:
        return dict(spills=self.spills, unspills=self.unspills,
                    bytes_spilled=self.bytes_spilled, bytes_unspilled=self.bytes_unspilled,
                    bytes_freed=self.bytes_freed)

    def __repr__(self):
        return (f"SpillStatistics(spills={self.spills}, unspills={self.unspills}, "
                f"spilled={self.bytes_spilled}B, unspilled={self.bytes_unspilled}B, "
                f"freed={self.bytes_freed}B)")


class HostSpilled:
    """A spilled buffer: its host copy and the device it came from."""

    __slots__ = ("host", "device")

    def __init__(self, host: torch.Tensor, device: torch.device):
        self.host = host
        self.device = device

    @property
    def nbytes(self) -> int:
        return self.host.numel() * self.host.element_size()

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        raise SpilledBufferError(f"a buffer spilled to the host was used as a tensor "
                                 f"(.{name}); call SpillManager.ensure_on_device first")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        raise SpilledBufferError(f"a buffer spilled to the host reached "
                                 f"{getattr(func, '__name__', func)}; call "
                                 f"SpillManager.ensure_on_device first")

    def _used(self, *args, **kwargs):
        raise SpilledBufferError("a buffer spilled to the host was used; call "
                                 "SpillManager.ensure_on_device first")

    __getitem__ = __setitem__ = __array__ = __float__ = __int__ = __index__ = __bool__ = \
        __len__ = __iter__ = _used


def _owned(col):
    """(owner, attribute) of every buffer slot spilling moves: the column's
    and its children's, but not a dictionary's keys."""
    for attr in _ATTRS:
        if getattr(col, attr) is not None:
            yield col, attr
    if not col.dtype.is_dictionary:
        for child in col.children:
            yield from _owned(child)


def _storage_key(t: torch.Tensor):
    return t.device, t.untyped_storage().data_ptr()


def _holders(t: torch.Tensor) -> Optional[int]:
    """Tensors that hold ``t``'s storage (None where torch cannot say)."""
    count = getattr(torch._C, "_storage_Use_Count", None)
    if count is None:
        return None
    s = t.untyped_storage()
    n = count(s._cdata) - 1                       # less this storage object
    del s
    return n


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    if t.device.type == "cuda":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host
    return t.clone()


class SpillManager:
    def __init__(self):
        self._registry: Dict[int, weakref.ref] = {}
        self._last_access: Dict[int, int] = {}
        self._clock = itertools.count()
        self.statistics = SpillStatistics()

    def register(self, col) -> None:
        key = id(col)
        self._registry[key] = weakref.ref(col, lambda _, key=key: self._forget(key))
        self.touch(col)

    def unregister(self, col) -> None:
        """Stop tracking the column: no later spill reaches it."""
        self._forget(id(col))

    def _forget(self, key: int) -> None:
        self._registry.pop(key, None)
        self._last_access.pop(key, None)

    def touch(self, col) -> None:
        self._last_access[id(col)] = next(self._clock)

    def live_columns(self) -> List:
        """The registered columns still alive, coldest first."""
        cols = [c for c in (r() for r in list(self._registry.values())) if c is not None]
        cols.sort(key=lambda c: self._last_access.get(id(c), -1))
        return cols

    def device_bytes(self) -> int:
        """Bytes of the device storages that spilling the registered
        columns could release (each storage once)."""
        return sum(self._releasable(self.live_columns()).values())

    def _releasable(self, cols) -> Dict:
        """storage key -> bytes, over the storages of the columns' device
        buffers that no tensor outside those columns holds."""
        tensors: Dict = {}
        for c in cols:
            for owner, attr in _owned(c):
                t = getattr(owner, attr)
                if isinstance(t, torch.Tensor) and t.numel():
                    tensors.setdefault(_storage_key(t), {})[id(t)] = t
        out = {}
        for key, held in tensors.items():
            sample = next(iter(held.values()))
            holders = _holders(sample)
            if holders is None or holders <= len(held):
                out[key] = sample.untyped_storage().nbytes()
        return out

    def spill(self, col) -> int:
        """Move the column's device buffers to the host; the bytes of
        device storage that this released."""
        slots = [(o, a) for o, a in _owned(col) if isinstance(getattr(o, a), torch.Tensor)]
        if not slots:
            return 0
        from torch.multiprocessing.reductions import StorageWeakRef

        tensors = [getattr(o, a) for o, a in slots]
        sizes = {}
        for t in tensors:
            key = _storage_key(t)
            if key not in sizes and t.numel():
                sizes[key] = (StorageWeakRef(t.untyped_storage()),
                              t.untyped_storage().nbytes())
        hosts = [_host_copy(t) for t in tensors]
        for dev in {t.device for t in tensors if t.device.type == "cuda"}:
            torch.cuda.current_stream(dev).synchronize()
        moved = sum(h.numel() * h.element_size() for h in hosts)
        for (owner, attr), t, h in zip(slots, tensors, hosts):
            setattr(owner, attr, HostSpilled(h, t.device))
            owner._cache = {}
        col._cache = {}
        del tensors, hosts, t, h
        freed = sum(nbytes for ref, nbytes in sizes.values() if ref.expired())
        self.statistics.spills += 1
        self.statistics.bytes_spilled += moved
        self.statistics.bytes_freed += freed
        return freed

    def ensure_on_device(self, col) -> None:
        """Copy the column's spilled buffers back to its device."""
        restored = 0
        for owner, attr in _owned(col):
            buf = getattr(owner, attr)
            if isinstance(buf, HostSpilled):
                setattr(owner, attr, buf.host.to(buf.device, non_blocking=True))
                restored += buf.nbytes
        if restored:
            self.statistics.unspills += 1
            self.statistics.bytes_unspilled += restored
        if id(col) in self._registry:
            self.touch(col)

    def spill_to_budget(self, budget_bytes: int) -> int:
        """Spill coldest first until the releasable device bytes fit the
        budget; the bytes of device storage released."""
        cols = self.live_columns()
        releasable = self._releasable(cols)
        live = sum(releasable.values())
        freed = 0
        for c in cols:
            if live - freed <= budget_bytes:
                break
            keys = {_storage_key(getattr(o, a)) for o, a in _owned(c)
                    if isinstance(getattr(o, a), torch.Tensor)}
            if keys & releasable.keys():
                freed += self.spill(c)
        return freed


def is_spilled(col) -> bool:
    return any(isinstance(getattr(o, a), HostSpilled) for o, a in _owned(col))


_manager: Optional[SpillManager] = None


def get_spill_manager() -> SpillManager:
    global _manager
    if _manager is None:
        _manager = SpillManager()
    return _manager


def _columns(obj):
    if hasattr(obj, "_table"):
        return list(obj._table.columns)
    if hasattr(obj, "_column"):
        return [obj._column]
    if hasattr(obj, "columns") and hasattr(obj, "num_rows"):
        return list(obj.columns)
    return [obj]


def spill(obj) -> int:
    """Spill a DataFrame, Series, Table or Column to the host; the bytes
    of device storage released."""
    mgr = get_spill_manager()
    return sum(mgr.spill(c) for c in _columns(obj))


def unspill(obj) -> None:
    """Bring a DataFrame, Series, Table or Column back to its device."""
    mgr = get_spill_manager()
    for c in _columns(obj):
        mgr.ensure_on_device(c)
