"""cudf_tpu_torch.pandas — the pandas accelerator (port of
``cudf_tpu/pandas/``, after cudf.pandas).

``install(device)`` replaces ``sys.modules['pandas']`` with a proxy
module.  DataFrame/Series results are fast/slow proxies: operations run
on the port (``cudf_tpu_torch``, on ``device``) first.

- On the CPU (``device="cpu"``), pandas is the slow side where it is
  importable: a call the port does not serve falls back to pandas per
  call, the reference's resilience model (the tests and ``suite.py``
  run the proxy so).
- On the card, or on the CPU where pandas is not importable, there is
  no slow side: every call runs on the device, and a call that would
  fall back is counted as slow by ``Profiler`` and raises
  ``proxy.NoSlowSide``.  Work on the card's frames never moves to CPU
  pandas.

Usage:
    python -m cudf_tpu_torch.pandas [--device DEV] script.py [args...]
    # or
    import cudf_tpu_torch.pandas; cudf_tpu_torch.pandas.install(device="cuda")
    import pandas as pd   # now accelerated

A CUDA device that is not there raises on the first fast construction;
the proxy never falls back to the CPU quietly.
"""

from __future__ import annotations

import importlib
import sys

import torch

from cudf_tpu_torch.pandas.proxy import (NO_SLOW_ROUTES, NoSlowSide, ProxyDataFrame,
                                         ProxySeries, make_proxy_module, profiler_stats,
                                         state)

__all__ = ["install", "uninstall", "Profiler", "NoSlowSide", "NO_SLOW_ROUTES",
           "ProxyDataFrame", "ProxySeries", "load_ipython_extension",
           "unload_ipython_extension"]

_installed = False
# what sys.modules["pandas"] held before install (a module, None where
# pandas is blocked, or nothing), put back by uninstall
_MISSING = object()
_before = {"pandas": _MISSING}


def _import_slow():
    """Real pandas, or None where it is not importable."""
    if "_slow_pandas" in sys.modules:
        return sys.modules["_slow_pandas"]
    try:
        return importlib.import_module("pandas")
    except ImportError:
        return None


def _has_slow_side(device) -> bool:
    """pandas is the slow side only for a CPU device."""
    return torch.device(device).type == "cpu"


def install(device="cuda"):
    """Make ``import pandas`` give the proxy module over ``device``;
    returns the module.  On the CPU, pandas is the slow side where it is
    importable; on any other device there is none, and every call runs
    on ``device`` or raises ``NoSlowSide``."""
    global _installed
    if _installed:
        uninstall()
    _before["pandas"] = sys.modules.get("pandas", _MISSING)
    real_pandas = _import_slow() if _has_slow_side(device) else None
    if real_pandas is not None:
        # keep the real module importable under a private name
        sys.modules["_slow_pandas"] = real_pandas
    state.update(device=device, slow=real_pandas)
    proxy = make_proxy_module(real_pandas)
    sys.modules["pandas"] = proxy
    _installed = True
    return proxy


def uninstall():
    global _installed
    if not _installed:
        return
    slow = sys.modules.pop("_slow_pandas", None)
    if slow is not None:
        sys.modules["pandas"] = slow
    elif _before["pandas"] is _MISSING:
        sys.modules.pop("pandas", None)
    else:
        sys.modules["pandas"] = _before["pandas"]
    # proxies made while installed keep their device and slow side
    _installed = False


class Profiler:
    """Fast/slow call attribution (reference: pandas/profiler.py)."""

    def __enter__(self):
        profiler_stats.clear()
        profiler_stats.update({"fast": 0, "slow": 0, "calls": {}})
        profiler_stats["active"] = True
        return self

    def __exit__(self, *a):
        profiler_stats["active"] = False

    @property
    def stats(self):
        return dict(profiler_stats)

    def print_per_function_stats(self):
        print(f"fast ({state['device']}) calls: {profiler_stats.get('fast', 0)}")
        print(f"slow (CPU pandas) fallbacks: {profiler_stats.get('slow', 0)}")
        for name, (f, s) in sorted(profiler_stats.get("calls", {}).items()):
            print(f"  {name}: fast={f} slow={s}")


def load_ipython_extension(ipython):
    """`%load_ext cudf_tpu_torch.pandas` (the reference's `%load_ext
    cudf.pandas` magic), on the CUDA device."""
    install()


def unload_ipython_extension(ipython):
    uninstall()
