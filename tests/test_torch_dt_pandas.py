"""``Series.dt`` of the port (``cudf_tpu_torch/frame/accessors.py``) against
pandas 3 on every call of ``DT_CALLS`` over the seeded timestamps of
``tests/test_torch_accessors.py`` (the calls against the reference stay
there); ``dt.is_*`` of NaT False, as pandas.  Every value and null exact."""

import pytest

from torch_accessors_helpers import DT, DT_CALLS, ours, same


@pytest.mark.parametrize("name", list(DT_CALLS))
def test_dt_matches_pandas(name):
    fn = DT_CALLS[name]
    same(fn(ours(DT)), fn(DT))
