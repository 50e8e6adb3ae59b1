"""pytest plugin: install the cudf_tpu_torch.pandas proxy before collection.

Used by ``cudf_tpu_torch/pandas/suite.py`` to run pandas' own tests with
the accelerator active (the cudf.pandas CI pattern — upstream pandas'
suite is the conformance oracle).  The device is the environment's
``CUDF_TPU_TORCH_PANDAS_DEVICE`` (``suite.py --device``; default cuda,
where there is no slow side; pandas is the slow side only on the CPU).
"""

import os

# install at PLUGIN IMPORT time: pytest loads -p plugins before the
# target directory's conftest files, and pandas/conftest.py binds
# `from pandas import DataFrame, Series` at module level — those must
# already be the proxy classes (fixture identity checks like
# `frame_or_series is Series` break otherwise)
from cudf_tpu_torch.pandas import install as _install

_install(device=os.environ.get("CUDF_TPU_TORCH_PANDAS_DEVICE", "cuda"))


def pytest_configure(config):
    # pandas' asserters compare type() identity; hand them real pandas
    # objects (the reference's module accelerator does the same unwrap
    # for pandas-internal callers)
    import functools

    from cudf_tpu_torch.pandas.proxy import (ProxyDataFrame, ProxySeries, _FastSlowProxy,
                                             _plain_index, _slow_pandas)

    def _unp(o):
        if isinstance(o, _FastSlowProxy):
            o = o._slow_obj()
        o = _plain_index(o)
        # write-back index wrappers reassign the class of the index
        # object held by the frame — reset in place for the class-
        # identity checks (the hook is moot once we're asserting)
        for ax in ("index", "columns"):
            idx = getattr(o, ax, None)
            base = getattr(type(idx), "_wb_base", None) if idx is not None \
                else None
            if base is not None:
                idx.__class__ = base
        return o

    import pandas._testing as tm

    def _patched(orig):
        @functools.wraps(orig)
        def run(left=None, right=None, *a, **k):
            return orig(_unp(left), _unp(right), *a, **k)

        return run

    for mod in (tm, __import__("pandas").testing):
        for name in ("assert_series_equal", "assert_frame_equal",
                     "assert_index_equal", "assert_equal",
                     "assert_almost_equal"):
            orig = getattr(mod, name, None)
            if orig is not None and not getattr(orig, "_cudf_tpu_torch_patch", False):
                wrapped = _patched(orig)
                wrapped._cudf_tpu_torch_patch = True
                setattr(mod, name, wrapped)

    # box_expected dispatches on `box_cls is Series` against the REAL
    # classes it bound at import; tests parametrize over the proxy
    # classes — map them across
    if not getattr(tm.box_expected, "_cudf_tpu_torch_patch", False):
        _orig_box = tm.box_expected
        _spd = _slow_pandas()

        def _box(expected, box_cls, transpose=True):
            if box_cls is ProxySeries:
                box_cls = _spd.Series
            elif box_cls is ProxyDataFrame:
                box_cls = _spd.DataFrame
            return _orig_box(_unp(expected), box_cls, transpose)

        _box._cudf_tpu_torch_patch = True
        tm.box_expected = _box
