"""``DataFrame.merge`` (``cudf_tpu_torch/frame/join.py``) against pandas on
the seeded frames of ``tests/test_torch_join_merge.py``: inner, left,
right and cross on one int key, two keys and a string key, with and
without null keys and values (pandas pairs null keys, and so does the
port).  Every comparison is exact."""

import pytest

import cudf_tpu_torch as ct
from torch_join_merge_helpers import CPU, _check, _frames


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("how", ["inner", "left", "right", "cross"])
@pytest.mark.parametrize("on", ["k", ["k", "j"], "s"])
def test_merge_matches_pandas(on, how, nulls):
    left, right = _frames(9, nulls)
    l, r = ct.DataFrame.from_pandas(left, device=CPU), ct.DataFrame.from_pandas(right, device=CPU)
    if how == "cross":
        _check(l.merge(r, how="cross"), left.merge(right, how="cross"))
        return
    _check(l.merge(r, on=on, how=how), left.merge(right, on=on, how=how))
    _check(l.merge(r, on=on, how=how, sort=True), left.merge(right, on=on, how=how, sort=True))
