"""Row UDFs of the port (``Series.map`` / ``apply``, ``DataFrame.apply``,
``utils/masked.py`` ``Masked``) against the reference's on the same
seeded inputs, and against pandas for what pandas defines.

``apply`` vmaps the UDF over the column (``torch.func.vmap``, the
reference's ``jax.vmap``); a UDF vmap cannot trace takes the host loop,
and ``UDF_ROUTES`` counts each route.  Python floats promote integers to
float64, as in pandas (torch alone would give float32).  Values exact,
floats rtol 1e-12.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import cudf_tpu
import cudf_tpu_torch as ct
from cudf_tpu.utils.masked import Masked as RefMasked
from cudf_tpu.utils.masked import where as ref_where
from cudf_tpu_torch.frame.series import UDF_ROUTES
from cudf_tpu_torch.utils.masked import Masked, where

torch.set_num_threads(1)

CPU = torch.device("cpu")
N = 30


def _pdf():
    rng = np.random.default_rng(17)
    v = rng.normal(0, 2, N).round(3)
    v[[1, 7, 19]] = np.nan
    return pd.DataFrame({"k": rng.integers(1, 6, N), "v": v,
                         "w": rng.integers(-5, 6, N).astype(np.int32),
                         "f": rng.random(N).round(4), "s": rng.choice(["a", "bb", "c"], N)})


PDF = _pdf()
PORT = ct.DataFrame.from_pandas(PDF, device=CPU)
REF = cudf_tpu.DataFrame.from_pandas(PDF)


def like(got, exp, **kw):
    got = got.to_pandas() if hasattr(got, "to_pandas") else got
    exp = exp.to_pandas() if hasattr(exp, "to_pandas") else exp
    opts = dict(check_exact=False, rtol=1e-12)
    opts.update(kw)
    if isinstance(exp, pd.DataFrame):
        pd.testing.assert_frame_equal(got, exp, **opts)
    else:
        pd.testing.assert_series_equal(got, exp, **opts)


def routes(fn):
    """(the result, the routes it took)."""
    before = dict(UDF_ROUTES)
    out = fn()
    return out, {k: UDF_ROUTES[k] - before[k] for k in before}


MASKED_UDFS = {
    "arith": lambda m: m * 2 + 1,
    "reflected": lambda m: 10 - m / 4,
    "power_mod": lambda m: (m ** 2) % 3,
    "neg_abs": lambda m: abs(-m),
    "compare": lambda m: m > 0.5,
    "fillna": lambda m: m.fillna(-1.0),
    "is_na": lambda m: m.is_na(),
}


@pytest.mark.parametrize("name", list(MASKED_UDFS))
def test_masked_udf_matches_reference(name):
    """``apply(masked=True)`` over a column with nulls: each UDF's values
    and nulls as the reference's."""
    fn = MASKED_UDFS[name]
    got, took = routes(lambda: PORT["v"].apply(fn, masked=True))
    assert took == {"vmap": 1, "host": 0}
    like(got, REF["v"].apply(fn, masked=True))


def test_masked_pairs_and_where():
    """Two Masked operands (validity the and of both) and ``where`` with
    a Masked condition, through a row UDF on both packages."""
    def udf(ns_where):
        return lambda row: ns_where(row["v"] > 0, row["v"] + row["f"], row["w"] * 1.0)

    got = PORT.apply(udf(where), axis=1, engine="torch", masked=True)
    exp = REF.apply(udf(ref_where), axis=1, engine="jax", masked=True)
    like(got, exp, check_names=False)
    m = Masked(torch.tensor([1.0, 2.0]), torch.tensor([True, False]))
    r = RefMasked(np.array([1.0, 2.0]), np.array([True, False]))
    for f in (lambda a: a + a, lambda a: a == 1.0, lambda a: 3 * a):
        out, ref = f(m), f(r)
        assert out.value.tolist() == np.asarray(ref.value).tolist()
        assert out.valid.tolist() == np.asarray(ref.valid).tolist()


@pytest.mark.parametrize("col", ["v", "w", "k"])
def test_apply_vmaps_and_matches_reference_and_pandas(col):
    """A traceable UDF takes the vmap route; an integer column times a
    Python float comes back float64, as pandas gives it; an integer UDF
    keeps the integer dtype; a UDF of a Python scalar broadcasts."""
    for fn in (lambda x: x * 2.0 + 1.0, lambda x: x - 3, lambda x: 7.0):
        got, took = routes(lambda: PORT[col].apply(fn))
        assert took == {"vmap": 1, "host": 0}
        exp = PDF[col].apply(fn)
        like(got, exp, check_dtype=not (col == "w" and exp.dtype == np.int64))
        if fn(1) != 7.0:
            like(got, REF[col].apply(fn), check_dtype=False)
    assert PORT["w"].apply(lambda x: x * 2.0 + 1.0).dtype == ct.Series(
        [1.0], device=CPU).dtype


def test_untraceable_udf_takes_the_host_loop():
    """Python control flow on a value, or a string result: the host route
    (counted), equal to pandas; an error the UDF raises itself propagates."""
    fn = lambda x: x * 2 if x > 0 else -x          # noqa: E731
    got, took = routes(lambda: PORT["w"].apply(fn))
    assert took == {"vmap": 0, "host": 1}
    like(got, PDF["w"].apply(fn), check_dtype=False)
    like(got, REF["w"].apply(fn), check_dtype=False)
    got, took = routes(lambda: PORT["k"].apply(lambda x: "big" if x > 2 else "small"))
    assert took == {"vmap": 0, "host": 1}
    like(got, PDF["k"].apply(lambda x: "big" if x > 2 else "small"))

    def bad(x):
        raise KeyError("the UDF's own error")

    with pytest.raises(KeyError, match="own error"):
        PORT["k"].apply(bad)


def test_map_of_a_dict_series_and_callable():
    """map looks values up on the device (unmatched: null), as the
    reference and pandas; a callable loops on the host."""
    mapper = {1: 10.5, 2: 20.5, 4: 40.5}
    like(PORT["k"].map(mapper), PDF["k"].map(mapper))
    like(PORT["k"].map(mapper), REF["k"].map(mapper))
    ints = {k: 1000 + k for k in range(1, 4)}
    like(PORT["k"].map(ints), PDF["k"].map(ints))
    by_series = pd.Series([5.0, 6.0, 7.0], index=[3, 1, 5])
    like(PORT["k"].map(ct.Series([5.0, 6.0, 7.0], index=[3, 1, 5], device=CPU)),
         PDF["k"].map(by_series))
    like(PORT["s"].map({"a": 1, "c": 3}), PDF["s"].map({"a": 1, "c": 3}))
    like(PORT["v"].map({np.float64(PDF["v"].iloc[0]): 1.0}),
         PDF["v"].map({np.float64(PDF["v"].iloc[0]): 1.0}))
    got, took = routes(lambda: PORT["k"].map(lambda x: x * 3))
    assert took == {"vmap": 0, "host": 1}
    like(got, PDF["k"].map(lambda x: x * 3))
    like(PORT["v"].map(lambda x: -x, na_action="ignore"),
         PDF["v"].map(lambda x: -x, na_action="ignore"))
    like(PORT["k"].map({}), PDF["k"].map({}).astype("float64"))


def test_frame_apply_on_both_axes():
    """axis=0 a function of each column; axis=1 vmapped over a dict of the
    column tensors (``engine="torch"``, the reference's ``"jax"``), with
    ``masked=True`` Masked fields, or a host loop over row dicts."""
    num = ["k", "w", "f"]
    like(PORT[num].apply(lambda s: s.max()), PDF[num].apply(lambda s: s.max()),
         check_dtype=False)
    like(PORT[num].apply(lambda s: s * 2), PDF[num].apply(lambda s: s * 2), check_dtype=False)
    row = lambda r: r["k"] * 2 + r["f"]                # noqa: E731
    got, took = routes(lambda: PORT[num].apply(row, axis=1, engine="torch"))
    assert took == {"vmap": 1, "host": 0}
    like(got, PDF[num].apply(row, axis=1))
    like(got, REF[num].apply(row, axis=1, engine="jax"))
    masked = lambda r: (r["v"] + r["f"]).fillna(0.0)    # noqa: E731
    like(PORT.apply(masked, axis=1, engine="torch", masked=True),
         REF.apply(masked, axis=1, engine="jax", masked=True))
    got, took = routes(lambda: PORT[num + ["s"]].apply(
        lambda r: r["k"] if r["s"] == "a" else r["w"], axis=1))
    assert took == {"vmap": 0, "host": 1}
    like(got, PDF[num + ["s"]].apply(lambda r: r["k"] if r["s"] == "a" else r["w"], axis=1))
