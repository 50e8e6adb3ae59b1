"""The port's string ops (``cudf_tpu_torch/ops/strings.py`` and
``ops/unicode_case.py``) against the reference's ``cudf_tpu/ops/strings.py``
and ``ops/unicode_case.py`` on the JAX CPU backend, and against Python's
own ``str`` methods, on the same seeded strings (ASCII, Latin-1, CJK,
emoji, empty and null rows).

Every result exact: the same Python strings, integers and bools, nulls
in the same rows.  ``get`` past a row's end is held to pandas (null; the
reference's slice gives ""), and so are the ops the reference hands to
the host for non-ASCII text.  ``STRING_ROUTES`` must count the device
route for everything but the expanding case maps (ß -> SS).
"""

import numpy as np
import pytest
import torch

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
from cudf_tpu.core.column import Column as RefColumn
from cudf_tpu.ops import strings as ref_str
from cudf_tpu.ops import unicode_case as ref_uc
from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.ops import strings as so
from cudf_tpu_torch.ops import unicode_case as uc
from cudf_tpu_torch.ops import unary
from torch_strings_helpers import CPU, VALS, port, values

torch.set_num_threads(1)


ASCII = [v for v in VALS if v is None or v.isascii()]


REF_CASES = {
    "length": (so.length, ref_str.length, ()),
    "byte_count": (so.byte_count, ref_str.byte_count, ()),
    "lower": (so.lower, ref_str.lower, ()),
    "upper": (so.upper, ref_str.upper, ()),
    "swapcase": (so.swapcase, ref_str.swapcase, ()),
    "strip": (so.strip, ref_str.strip, ()),
    "lstrip_ab": (so.strip, ref_str.strip, ("ab", "left")),
    "slice_1_4": (so.slice_strings, ref_str.slice_strings, (1, 4)),
    "slice_neg": (so.slice_strings, ref_str.slice_strings, (-3, None)),
    "find_b": (so.find_literal, ref_str.find_literal, ("b",)),
    "rfind_ab": (so.find_literal, ref_str.find_literal, ("ab", True)),
    "contains_ab": (so.contains_literal, ref_str.contains_literal, ("ab",)),
    "startswith_a": (so.startswith, ref_str.startswith, ("a",)),
    "endswith_b": (so.endswith, ref_str.endswith, ("b",)),
    "count_a": (so.count_literal, ref_str.count_literal, ("a",)),
    "rjust": (so.pad, ref_str.pad, (8, "left", "*")),
    "zfill": (so.zfill, ref_str.zfill, (6,)),
    "repeat": (so.repeat_strings, ref_str.repeat_strings, (2,)),
}


@pytest.mark.parametrize("name", list(REF_CASES))
def test_ops_match_reference(name):
    """Over ASCII rows (where the reference stays on its device tier)."""
    ours, ref, args = REF_CASES[name]
    got = values(ours(port(ASCII), *args))
    assert got == ref(RefColumn.from_strings(ASCII), *args).to_pylist()


def test_routes_counted():
    before = dict(so.STRING_ROUTES)
    so.upper(port(["añb", "x"]))
    so.contains_literal(port(["añb"]), "ñ")
    assert so.STRING_ROUTES["device"] - before["device"] == 2
    assert so.STRING_ROUTES["host"] == before["host"]
    assert values(so.upper(port(["straße"]))) == ["STRASSE"]   # an expanding map: the host
    assert so.STRING_ROUTES["host"] == before["host"] + 1


def test_unicode_decode_encode_match_reference():
    vals = [v for v in VALS if v is not None and "😀" not in v]
    cp, row, idx = uc.decode_utf8(port(vals))
    rcp, rrow, ridx = ref_uc.decode_utf8(RefColumn.from_strings(vals))
    assert cp.tolist() == np.asarray(rcp).tolist()
    assert row.tolist() == np.asarray(rrow).tolist()
    assert idx.tolist() == np.asarray(ridx).tolist()
    assert uc.encode_utf8(cp, row, len(vals), None).host_strings() == vals
    astral = port(["😀a"])                          # 4-byte sequences encode too
    assert uc.encode_utf8(*uc.decode_utf8(astral)[:2], 1, None).host_strings() == ["😀a"]


NUMBERS = ["1", "-22", "0003", " 7 ", "1.5", "-2.50", "1e3", ".5", "5.", "abc", "", None,
           "inf", "-nan", "12345678901234567890", "3.14159265358979323846", "1e-320"]


def test_parse_numbers_match_python():
    col = port(NUMBERS)
    ints, ok = so.parse_numbers(col, floats=False)
    for v, got, good in zip(NUMBERS, ints.tolist(), ok.tolist()):
        try:
            exp = int(v) if v is not None and abs(int(v)) < 2 ** 63 else None
        except ValueError:
            exp = None
        assert (got if good else None) == exp, v
    floats, ok = so.parse_numbers(col, floats=True)
    for v, got, good in zip(NUMBERS, floats.tolist(), ok.tolist()):
        try:
            exp = None if v is None else float(v)
        except ValueError:
            exp = None
        if exp is None or exp != exp:
            assert (not good) if exp is None else got != got, v
        else:
            assert good and got == exp, v


def test_casts_match_reference():
    ints = ["12", "-7", "0", "123456789"]
    assert values(unary.cast(port(ints), dt.INT64)) == \
        ref_str.to_numbers(RefColumn.from_strings(ints), ref_dt_int64()).to_pylist()
    with pytest.raises(ValueError):
        unary.cast(port(["1", "x"]), dt.INT32)
    nums = Column.from_pylist([5, -120, None, 0, 2 ** 62], dt.INT64, device=CPU)
    ref = ref_str.from_column(RefColumn.from_sequence([5, -120, None, 0, 2 ** 62]))
    assert values(unary.cast(nums, dt.STRING)) == ref.to_pylist()
    extreme = Column.from_pylist([-2 ** 63, 2 ** 63 - 1], dt.INT64, device=CPU)
    assert values(so.from_column(extreme)) == [str(-2 ** 63), str(2 ** 63 - 1)]
    flags = Column.from_pylist([True, False, None], dt.BOOL8, device=CPU)
    assert values(so.from_column(flags)) == ["True", "False", None]
    floats = Column.from_pylist([1.5, 0.1, None], dt.FLOAT64, device=CPU)
    assert values(so.from_column(floats)) == ["1.5", "0.1", None]


def ref_dt_int64():
    from cudf_tpu.core import dtypes as ref_dt

    return ref_dt.INT64


def test_concat_and_scatter():
    a, b = port(["x", None, "ñ", ""]), port(["1", "2", None, "3"])
    assert values(so.concat([a, "_", b])) == ["x_1", None, None, "_3"]
    assert values(so.concat(["<", a])) == ["<x", None, "<ñ", "<"]
    from cudf_tpu_torch.ops import copying

    out = copying.scatter(port(["p", "q"]), torch.tensor([3, 0]), a)
    assert values(out) == ["q", None, "ñ", "p"]


def test_split_record_is_the_counted_host_route():
    """Whitespace splits (no separator) take the counted host route; a
    separator the span engine takes stays on the device.  Both give a
    LIST<STRING> column."""
    before = so.STRING_ROUTES["host"]
    assert so.split_record(port(["a b", None, "c"]), None).to_pylist() == \
        [["a", "b"], None, ["c"]]
    assert so.STRING_ROUTES["host"] == before + 1
    assert so.split_record(port(["a b", None, "c"]), " ").to_pylist() == \
        [["a", "b"], None, ["c"]]
    assert so.STRING_ROUTES["host"] == before + 1
