"""The ten db-benchmark G1 questions in the form ``chip_smoke.py`` runs
them (``cudf_tpu_torch/models/g1.py``: the pandas solution's
``groupby(..., as_index=False, sort=False, observed=True, dropna=False)``)
on a small G1 frame (id1, id2 and id3 categories, K = 10), against the
same functions on pandas, with the kernel tiers on (at every size, through
their plain versions on the CPU) and off; and against cudf_tpu's frames
where the reference is right: its groups come sorted (it ignores
sort=False, ROADMAP.md queue 3), so those are compared by key, and q9's
corr with small integer v1 and v2, where its one-pass sums are exact.

Tolerances: keys, group order, counts, integer sums, minima and maxima
and row selections exact; float sums rtol 1e-12; means, std and corr
rtol 1e-9 (r2 also atol 1e-15: a correlation near 0 carries the absolute
rounding of its centred sums).
"""

import numpy as np
import pandas as pd
import pytest
import torch

import cudf_tpu
import cudf_tpu_torch as ct
from cudf_tpu_torch.models import g1
from cudf_tpu_torch.utils.config import option_context

torch.set_num_threads(1)

CPU = torch.device("cpu")
N, K = 3000, 10
RTOL = {"q3": 1e-9, "q4": 1e-9, "q6": 1e-9, "q9": 1e-9}


def _cat(values):
    return pd.Categorical(values, categories=sorted(set(values)))


@pytest.fixture(scope="module")
def frames():
    """groupby-datagen.R's G1 at N rows and K = 10, in pandas and the port."""
    rng = np.random.default_rng(2024)
    pdf = pd.DataFrame({
        "id1": _cat([f"id{i:03d}" for i in rng.integers(1, K + 1, N)]),
        "id2": _cat([f"id{i:03d}" for i in rng.integers(1, K + 1, N)]),
        "id3": _cat([f"id{i:010d}" for i in rng.integers(1, N // K + 1, N)]),
        "id4": rng.integers(1, K + 1, N).astype(np.int32),
        "id5": rng.integers(1, K + 1, N).astype(np.int32),
        "id6": rng.integers(1, N // K + 1, N).astype(np.int32),
        "v1": rng.integers(1, 6, N).astype(np.int32),
        "v2": rng.integers(1, 16, N).astype(np.int32),
        "v3": np.round(rng.uniform(0, 100, N), 6),
    })
    return pdf, ct.DataFrame.from_pandas(pdf, device=CPU)


def _values(col):
    """A column's values for comparison: categories as strings, numbers
    as float64 (integer columns exactly)."""
    if isinstance(col.dtype, pd.CategoricalDtype) or col.dtype == object or \
            str(col.dtype) in ("str", "string"):
        return np.asarray(col.astype(str))
    return np.asarray(col, dtype=np.float64)


def _check(q, got, exp, rtol, atol=0.0):
    if isinstance(exp, pd.Series):
        np.testing.assert_allclose(_values(got), _values(exp), rtol=rtol, atol=atol)
        for i in range(exp.index.nlevels - 1):            # the keys; pandas 3 drops them
            assert got.index.get_level_values(i).size == exp.size
        return
    assert list(got.columns) == list(exp.columns), (q, list(got.columns))
    np.testing.assert_array_equal(np.asarray(got.index), np.asarray(exp.index))
    for c in exp.columns:
        g, e = _values(got[c]), _values(exp[c])
        if g.dtype.kind == "f" and exp[c].dtype.kind == "f":
            np.testing.assert_allclose(g, e, rtol=rtol, atol=atol, err_msg=f"{q} {c}")
        else:
            np.testing.assert_array_equal(g, e, err_msg=f"{q} {c}")


@pytest.mark.parametrize("kernel_tiers", [True, False])
@pytest.mark.parametrize("q", list(g1.QUESTIONS))
def test_question_matches_pandas(frames, q, kernel_tiers):
    pdf, df = frames
    opt = ("groupby.fast_path_min_rows", 0) if kernel_tiers else \
        ("groupby.onehot_fast_path", False)
    with option_context(*opt):
        got = g1.QUESTIONS[q](df).to_pandas()
    _check(q, got, g1.QUESTIONS[q](pdf), RTOL.get(q, 1e-12), 1e-15 if q == "q9" else 0.0)


def test_q9_keys_and_apply_form_match_pandas(frames):
    """q9's (id2, id4) keys in first-appearance order, and its apply form
    (a host loop over the groups) equal to its corr form and to pandas'."""
    pdf, df = frames
    got = g1.q9(df).to_pandas()
    exp_keys = pdf[["id2", "id4"]].drop_duplicates()
    np.testing.assert_array_equal(np.asarray(got.index.get_level_values(0).astype(str)),
                                  np.asarray(exp_keys["id2"].astype(str)))
    np.testing.assert_array_equal(got.index.get_level_values(1), exp_keys["id4"])
    applied = g1.q9_apply(df).to_pandas()
    exp = g1.q9_apply(pdf)
    np.testing.assert_array_equal(applied["id2"].astype(str), exp["id2"].astype(str))
    np.testing.assert_allclose(applied[0], exp[None], rtol=1e-9, atol=1e-15)
    np.testing.assert_allclose(applied[0], got.to_numpy(), rtol=1e-9, atol=1e-15)


REF_SPECS = {"q1": ("id1", {"v1": "sum"}), "q2": (["id1", "id2"], {"v1": "sum"}),
             "q3": ("id3", {"v1": "sum", "v3": "mean"}),
             "q4": ("id4", {"v1": "mean", "v2": "mean", "v3": "mean"}),
             "q5": ("id6", {"v1": "sum", "v2": "sum", "v3": "sum"}),
             "q7": ("id3", {"v1": "max", "v2": "min"}),
             "q10": (["id1", "id2", "id3", "id4", "id5", "id6"], {"v3": "sum", "v1": "size"})}


# the reference's sort-tier sums are prefix-sum differences over the
# sorted rows: q10's groups of one or two rows lose ~1e-10 of their v3 sum
# to the running total (the port's index_add_ sums are pandas', above)
REF_WRONG = {"q10": ["v3"]}


@pytest.fixture(scope="module")
def ref_frame(frames):
    return cudf_tpu.DataFrame.from_pandas(frames[0])


@pytest.mark.parametrize("q", list(REF_SPECS))
def test_question_matches_reference_by_key(frames, ref_frame, q):
    """The reference's groups come sorted: both answers sorted by key."""
    _, df = frames
    keys, spec = REF_SPECS[q]
    ref = ref_frame.groupby(keys, as_index=False, dropna=False).agg(spec).to_pandas()
    got = g1.QUESTIONS[q](df).to_pandas()
    if q == "q7":
        ref["range_v1_v2"] = ref["v1"] - ref["v2"]
        ref = ref[["id3", "range_v1_v2"]]
    by = [keys] if isinstance(keys, str) else keys
    sort = [c for c in got.columns if c in by]
    got = got.assign(**{c: got[c].astype(str) for c in sort}).sort_values(sort)
    ref = ref.assign(**{c: ref[c].astype(str) for c in sort}).sort_values(sort)
    for c in ref.columns:
        if c in REF_WRONG.get(q, ()):
            continue
        g, e = _values(got[c]), _values(ref[c])
        if c in sort or g.dtype.kind != "f":
            np.testing.assert_array_equal(g, e, err_msg=f"{q} {c}")
        else:
            np.testing.assert_allclose(g, e, rtol=RTOL.get(q, 1e-12), err_msg=f"{q} {c}")


def test_q9_matches_reference_on_small_integers(frames, ref_frame):
    """v1 and v2 are small integers: the reference's one-pass corr is exact."""
    _, df = frames
    ref = ref_frame[["id2", "id4", "v1", "v2"]].groupby(["id2", "id4"])[["v1", "v2"]].corr()
    ref = ref.to_pandas()
    r2_ref = (ref["v2"].to_numpy()[0::2]) ** 2
    keys_ref = list(zip(ref.index.get_level_values(0).astype(str)[0::2],
                        ref.index.get_level_values(1)[0::2]))
    got = g1.q9(df).to_pandas()
    keys = list(zip(got.index.get_level_values(0).astype(str), got.index.get_level_values(1)))
    order = sorted(range(len(keys)), key=lambda i: keys[i])
    assert [keys[i] for i in order] == keys_ref
    np.testing.assert_allclose(got.to_numpy()[order], r2_ref, rtol=1e-9, atol=1e-15)
