"""``Series.str`` of the port (``cudf_tpu_torch/frame/accessors.py``) against
pandas 3 on every call of ``STR_CALLS`` over the seeded text of
``tests/test_torch_accessors.py`` (the calls against the reference stay
there).  Every value and null exact; predicates of a missing value False
(pandas 3's ``str`` dtype)."""

import pytest

from torch_accessors_helpers import STR_CALLS, TEXT, ours, same


@pytest.mark.parametrize("name", list(STR_CALLS))
def test_str_matches_pandas(name):
    fn = STR_CALLS[name]
    same(fn(ours(TEXT)), fn(TEXT))
    same(fn(ours(TEXT.astype("category"))), fn(TEXT.astype("category")))   # over the keys
