"""pandas scripts run through the accelerator (``cudf_tpu_torch.pandas``).

Each script under ``pandas_scripts/`` is a file of plain ``import pandas
as pd`` code: ``load(...)`` reads or builds its frames, ``REQUESTS`` maps
a request's name to a function of those frames, and run as ``__main__``
it loads, answers every request (``ANSWERS``) and prints the answers'
shapes.

- ``g1_csv``: db-benchmark's pandas solution over G1 read from CSV
  (``read_csv`` of ``g1.csv``, id1-id3 as categories), the ten questions;
- ``tpch_parquet``: ``read_parquet`` of lineitem, orders and part, then
  ``tpch.FRAME_QUERIES`` q1, q6, q12 and q14;
- ``sweep``: the reference accelerator's parity sweep, 31 requests over a
  frame of int, float and string columns built from numpy draws.

``run_script(name, args, device)`` runs one as ``python -m
cudf_tpu_torch.pandas`` does: ``install(device)``, then
``runpy.run_path`` as ``__main__`` with ``sys.argv`` set; it returns the
script's globals (``FRAMES``, ``REQUESTS``, ``ANSWERS``).
``run_direct(name, args, device)`` runs the same script with ``pandas``
bound to the port itself (``direct_module``: its functions with the
device bound, no proxy), so each answer can be held to the port's own.
``agree`` compares a proxy's answer with the direct one: keys, counts,
integers, strings and row order exact, floats within rtol 1e-12 (atomic
adds land in any order).  ``NEEDS[name][request]`` are the kernels of
A-H each request launches on the card.
"""

from __future__ import annotations

import contextlib
import functools
import runpy
import sys
import types
from pathlib import Path

import torch

from cudf_tpu_torch.core.column import Column

SCRIPTS_DIR = Path(__file__).resolve().parent / "pandas_scripts"
SCRIPTS = {name: SCRIPTS_DIR / f"{name}.py" for name in ("g1_csv", "tpch_parquet", "sweep")}

ONEHOT = ["onehot_groupby_aggregate"]
RADIX = ["digit_histogram", "tile_sort_data", "merge_scatter", "bucket_aggregate"]
JOIN = RADIX + ["window_probe"]
NEEDS = {
    "g1_csv": {"q1": ONEHOT, "q2": [], "q3": RADIX, "q4": ONEHOT, "q5": RADIX, "q6": [],
               "q7": RADIX, "q8": [], "q9": [], "q10": []},
    # from Parquet l_shipmode is STRING (in memory DICTIONARY32): q12's
    # groupby takes the sort tier, so A is not launched
    "tpch_parquet": {"q1": [], "q6": [], "q12": JOIN, "q14": JOIN},
    "sweep": {},
}
# groupby("k").sum() takes the string column too: the sort tier; the
# merge's right side (20 rows) is one window: D builds it, H probes it
NEEDS["sweep"].update({"groupby_agg_mean": ONEHOT, "merge": ["bucket_aggregate",
                                                             "window_probe"]})
# absolute bounds beside rtol 1e-12: q9's r2 = corr^2 carries the absolute
# rounding of its centred sums where the correlation is near 0; a prefix
# sum's rounding is relative to the largest partial sum (SCALED: rtol times
# the answer's largest magnitude)
ATOL = {("g1_csv", "q9"): 1e-15}
SCALED = {("sweep", "cumsum")}


def atol_for(name: str, request: str, exp, rtol: float = 1e-12) -> float:
    """The absolute bound beside rtol for one request's answer ``exp``."""
    if (name, request) in SCALED:
        data = exp._column.data
        return rtol * float(data.abs().max()) if data.numel() else 0.0
    return ATOL.get((name, request), 0.0)


@contextlib.contextmanager
def _argv(argv):
    saved = sys.argv
    sys.argv = list(argv)
    try:
        yield
    finally:
        sys.argv = saved


def run_script(name: str, args=(), device="cuda") -> dict:
    """Script ``name`` through the accelerator on ``device``, as ``python
    -m cudf_tpu_torch.pandas --device DEVICE script args`` runs it; its
    globals after the run."""
    from cudf_tpu_torch import pandas as accel

    accel.install(device=device)
    path = str(SCRIPTS[name])
    with _argv([path, *map(str, args)]):
        return runpy.run_path(path, run_name="__main__")


def direct_module(device) -> types.ModuleType:
    """A module that stands for ``pandas`` with the port's own frames: its
    constructors, readers and functions with ``device`` bound, no proxy."""
    import cudf_tpu_torch as ct

    mod = types.ModuleType("pandas")
    for name in ct.__all__:
        fn = getattr(ct, name)
        if callable(fn) and not isinstance(fn, type):
            from cudf_tpu_torch.pandas.proxy import _takes_device

            fn = functools.partial(fn, device=device) if _takes_device(fn) else fn
        mod.__dict__[name] = fn
    mod.DataFrame = functools.partial(ct.DataFrame, device=device)
    mod.Series = functools.partial(ct.Series, device=device)
    return mod


def run_direct(name: str, args=(), device="cuda") -> dict:
    """Script ``name`` with ``import pandas`` giving ``direct_module``: the
    same requests on the port's frames, no proxy; its globals."""
    saved = sys.modules.get("pandas", None)
    had = "pandas" in sys.modules
    sys.modules["pandas"] = direct_module(device)
    try:
        path = str(SCRIPTS[name])
        with _argv([path, *map(str, args)]):
            return runpy.run_path(path, run_name="__main__")
    finally:
        if had:
            sys.modules["pandas"] = saved
        else:
            del sys.modules["pandas"]


# ----------------------------------------------------------------------
# answers
# ----------------------------------------------------------------------

class Mismatch(AssertionError):
    pass


def _need(cond, what):
    if not cond:
        raise Mismatch(what)


def port_object(obj):
    """A proxy's port object (the object itself otherwise)."""
    from cudf_tpu_torch.pandas.proxy import _FastSlowProxy

    if isinstance(obj, _FastSlowProxy):
        return obj._fast_obj()
    return obj


def _same_column(got: Column, exp: Column, what: str, rtol: float,
                 atol: float = 0.0) -> float:
    """Two columns: dtype, length, validity and offsets exact; float data
    within rtol (and atol) over valid rows (NaN where NaN); other data bit
    for bit; a dictionary's keys and codes; children in turn."""
    _need(got.dtype == exp.dtype, f"{what}: dtype {got.dtype!r} vs {exp.dtype!r}")
    _need(got.length == exp.length, f"{what}: {got.length} rows vs {exp.length}")
    gv, ev = got.validity, exp.validity
    gv = None if gv is None or bool(gv.all()) else gv
    ev = None if ev is None or bool(ev.all()) else ev
    _need((gv is None) == (ev is None) and (gv is None or torch.equal(gv, ev)),
          f"{what}: validity differs")
    if got.offsets is not None or exp.offsets is not None:
        a, b = got.offsets, exp.offsets
        _need(a is not None and b is not None and torch.equal(a - a[0], b - b[0]),
              f"{what}: offsets differ")
    err = 0.0
    a, b = got.data, exp.data
    _need((a is None) == (b is None), f"{what}: data missing")
    if a is not None:
        if got.offsets is not None:
            a = a[int(got.offsets[0]):int(got.offsets[-1])]
            b = b[int(exp.offsets[0]):int(exp.offsets[-1])]
        _need(a.dtype == b.dtype and a.shape == b.shape, f"{what}: data {a.dtype}{list(a.shape)}"
                                                         f" vs {b.dtype}{list(b.shape)}")
        if a.is_floating_point():
            if gv is not None:
                a, b = a[gv], b[gv]
            _need(torch.allclose(a, b, rtol=rtol, atol=atol, equal_nan=True),
                  f"{what}: floats differ beyond rtol {rtol}, atol {atol}")
            fin = torch.isfinite(b)
            if bool(fin.any()):
                err = float((a[fin].double() - b[fin].double()).abs().max())
        else:
            _need(torch.equal(a, b), f"{what}: data differs")
    if got.dtype.is_dictionary:
        err = max(err, _same_column(got.keys, exp.keys, f"{what} keys", rtol))
    for i, (x, y) in enumerate(zip(got.children, exp.children)):
        err = max(err, _same_column(x, y, f"{what} child {i}", rtol))
    return err


def _same_index(got, exp, what: str, rtol: float) -> float:
    from cudf_tpu_torch.frame.index import MultiIndex, RangeIndex

    _need(type(got) is type(exp), f"{what}: {type(got).__name__} vs {type(exp).__name__}")
    if isinstance(exp, RangeIndex):
        _need((got.start, got.stop, got.step, got.name) == (exp.start, exp.stop, exp.step,
                                                             exp.name), f"{what} differs")
        return 0.0
    if isinstance(exp, MultiIndex):
        _need(tuple(got.names) == tuple(exp.names), f"{what}: names {got.names}")
        return max([_same_column(a, b, f"{what} level {i}", rtol)
                    for i, (a, b) in enumerate(zip(got._columns, exp._columns))] or [0.0])
    _need(got.name == exp.name, f"{what}: name {got.name!r} vs {exp.name!r}")
    return _same_column(got._column, exp._column, what, rtol)


def agree(what: str, got, exp, rtol: float = 1e-12, atol: float = 0.0) -> float:
    """A proxy's answer (``got``) against the port's direct one: frames by
    column names, columns and index; Series by name, column and index;
    scalars (floats within rtol, and atol); returns the largest float
    error."""
    from cudf_tpu_torch.frame.dataframe import DataFrame
    from cudf_tpu_torch.frame.series import Series

    got = port_object(got)
    if isinstance(exp, DataFrame):
        _need(isinstance(got, DataFrame), f"{what}: {type(got).__name__}, not a DataFrame")
        _need(list(got._table.names) == list(exp._table.names),
              f"{what}: columns {list(got._table.names)} vs {list(exp._table.names)}")
        err = _same_index(got.index, exp.index, f"{what} index", rtol)
        for n in exp._table.names:
            err = max(err, _same_column(got._table[n], exp._table[n], f"{what} {n}", rtol,
                                        atol))
        return err
    if isinstance(exp, Series):
        _need(isinstance(got, Series), f"{what}: {type(got).__name__}, not a Series")
        _need(got.name == exp.name, f"{what}: name {got.name!r} vs {exp.name!r}")
        return max(_same_index(got.index, exp.index, f"{what} index", rtol),
                   _same_column(got._column, exp._column, what, rtol, atol))
    if isinstance(exp, float) or isinstance(got, float):
        g, e = float(got), float(exp)
        _need(g == e or abs(g - e) <= rtol * abs(e) + atol or (g != g and e != e),
              f"{what}: {g!r} vs {e!r}")
        return abs(g - e) if e == e else 0.0
    _need(type(got) is type(exp) and got == exp, f"{what}: {got!r} vs {exp!r}")
    return 0.0
