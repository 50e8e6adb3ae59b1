"""Helpers of the accelerator's tests (``tests/test_torch_pandas_*.py``):
run pandas code under the reference's proxy (``cudf_tpu.pandas``, JAX on
the CPU), under the port's (``cudf_tpu_torch.pandas`` on the CPU, pandas
the slow side) or under plain pandas, and compare the results."""

from __future__ import annotations

import contextlib
import sys

import numpy as np

KINDS = ("pandas", "reference", "port")


def _bind_pyarrow_to_real_pandas():
    """pyarrow imports pandas at its first conversion and keeps that
    module: make it real pandas before any proxy is installed (the
    reference's proxy converts through pyarrow with its own module
    installed)."""
    try:
        import pyarrow
    except ImportError:
        return
    pyarrow.table({"a": [1]}).to_pandas()


_bind_pyarrow_to_real_pandas()


@contextlib.contextmanager
def under(kind: str):
    """The module ``import pandas`` gives under ``kind``; each proxy is
    uninstalled after."""
    if kind == "pandas":
        import pandas

        yield pandas
        return
    if kind == "reference":
        import cudf_tpu.pandas as accel

        mod = accel.install()
    else:
        import cudf_tpu_torch.pandas as accel

        mod = accel.install(device="cpu")
    try:
        assert sys.modules["pandas"] is mod
        yield mod
    finally:
        accel.uninstall()


def plain(obj):
    """A result as plain pandas / Python: a proxy's pandas object, the
    items of a tuple or list in turn, a numpy scalar as a Python one."""
    if hasattr(obj, "_slow_obj") and hasattr(obj, "_fast_obj"):
        return obj.to_pandas()
    if isinstance(obj, (tuple, list)):
        return type(obj)(plain(o) for o in obj)
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def _same_values(got, exp, what, rtol, atol=0.0):
    import pandas as pd

    g, e = np.asarray(got), np.asarray(exp)
    assert g.shape == e.shape, f"{what}: shape {g.shape} vs {e.shape}"
    if e.dtype.kind == "f" or g.dtype.kind == "f":
        gm, em = pd.isna(got).to_numpy(), pd.isna(exp).to_numpy()
        assert (gm == em).all(), f"{what}: missing rows differ"
        np.testing.assert_allclose(g[~gm].astype(float), e[~em].astype(float), rtol=rtol,
                                   atol=atol, err_msg=what)
    else:
        assert list(got) == list(exp), f"{what}: {list(got)[:10]} vs {list(exp)[:10]}"


def same(got, exp, what="result", rtol=1e-12, check_dtype=True, atol=0.0):
    """Two plain results: frames and Series by labels, values and (with
    check_dtype) dtypes, integers, keys and strings exact, floats within
    rtol (and atol, 0 unless given); scalars likewise."""
    import pandas as pd

    got, exp = plain(got), plain(exp)
    if isinstance(exp, pd.DataFrame):
        assert isinstance(got, pd.DataFrame), f"{what}: {type(got)}"
        assert list(got.columns) == list(exp.columns), f"{what}: {list(got.columns)}"
        same(got.index, exp.index, f"{what} index", rtol, check_dtype)
        for c in exp.columns:
            same(got[c], exp[c], f"{what}[{c!r}]", rtol, check_dtype, atol)
        return
    if isinstance(exp, pd.Series):
        assert isinstance(got, pd.Series), f"{what}: {type(got)}"
        assert got.name == exp.name, f"{what}: name {got.name!r} vs {exp.name!r}"
        if check_dtype:
            assert got.dtype == exp.dtype, f"{what}: dtype {got.dtype} vs {exp.dtype}"
        same(got.index, exp.index, f"{what} index", rtol, check_dtype)
        _same_values(got, exp, what, rtol, atol)
        return
    if isinstance(exp, pd.Index):
        assert isinstance(got, pd.Index), f"{what}: {type(got)}"
        assert list(got.names) == list(exp.names), f"{what}: names {got.names}"
        if check_dtype:
            assert got.dtype == exp.dtype, f"{what}: dtype {got.dtype} vs {exp.dtype}"
        if isinstance(exp, pd.MultiIndex):
            assert list(got) == list(exp), what
        else:
            _same_values(got.to_series(), exp.to_series(), what, rtol)
        return
    if isinstance(exp, tuple):
        assert isinstance(got, tuple) and len(got) == len(exp), what
        for i, (g, e) in enumerate(zip(got, exp)):
            same(g, e, f"{what}[{i}]", rtol, check_dtype)
        return
    if isinstance(exp, float):
        assert isinstance(got, (float, int)), f"{what}: {got!r}"
        assert (got != got and exp != exp) or abs(got - exp) <= rtol * abs(exp), \
            f"{what}: {got!r} vs {exp!r}"
        return
    assert got == exp, f"{what}: {got!r} vs {exp!r}"
