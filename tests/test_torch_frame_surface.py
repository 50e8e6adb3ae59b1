"""The frame methods and parameters the port gained to match the
reference's public surface (``tests/test_torch_surface.py``), each held to
the reference on the CPU over the same numpy-seeded inputs: integers,
ranks and strings exactly, float products and spreads within rtol 1e-12.
``sample`` is held to its contract (the generators differ);
``from_dict(orient="index")``, ``info``'s layout and ``to_numeric``'s
``downcast`` (which the reference ignores) to pandas."""

import io

import numpy as np
import pandas as pd
import pytest

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
import cudf_tpu as ref
import cudf_tpu_torch as ct

RTOL = 1e-12


def _frame(n=40, seed=3):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=n)
    v[rng.random(n) < 0.15] = np.nan
    return pd.DataFrame({
        "k": rng.integers(0, 5, n).astype(np.int32),
        "i": rng.integers(-3, 4, n),
        "v": v,
        "b": rng.random(n) < 0.5,
        "t": pd.to_datetime("2024-01-01") + pd.to_timedelta(rng.integers(0, 6, n), "D"),
        "s": rng.choice(["ab", "c", "dd", "e"], n),
    })


def _both(pdf):
    return ref.DataFrame.from_pandas(pdf), ct.DataFrame.from_pandas(pdf, device="cpu")


def _same(got, exp):
    """Frames equal: exact outside floats, floats within RTOL."""
    assert list(got.columns) == list(exp.columns)
    assert got.index.tolist() == exp.index.tolist()
    for c in exp.columns:
        g, e = got[c], exp[c]
        if e.dtype.kind == "f" or g.dtype.kind == "f":
            np.testing.assert_allclose(g.to_numpy(float), e.to_numpy(float), rtol=RTOL)
        else:
            assert g.tolist() == e.tolist(), c


@pytest.mark.parametrize("kw", [{}, {"method": "min"}, {"method": "max"}, {"method": "first"},
                                {"method": "dense"}, {"ascending": False, "pct": True}])
def test_rank_matches_reference(kw):
    r, p = _both(_frame())
    exp, got = r.rank(**kw).to_pandas(), p.rank(**kw).to_pandas()
    assert list(got.columns) == ["k", "i", "v", "b", "t"]      # no string column
    _same(got, exp)


def test_mode_is_padded_to_the_longest_as_the_reference():
    pdf = pd.DataFrame({"a": [1, 2, 2, 3, 3, 9], "f": [0.5, 0.5, 1.5, 2.5, 3.5, 4.5],
                        "s": ["x", "y", "x", "y", "z", "z"]})
    r, p = _both(pdf)
    exp, got = r.mode().to_pandas(), p.mode().to_pandas()
    _same(got, exp)
    assert got.equals(pdf.mode())


@pytest.mark.parametrize("replace", [False, True])
def test_sample_keeps_its_contract(replace):
    pdf = _frame(200, seed=5)
    df = ct.DataFrame.from_pandas(pdf, device="cpu")
    out = df.sample(50, replace=replace, random_state=11)
    got = out.to_pandas()
    labels = got.index.to_numpy()
    assert len(got) == 50
    assert replace or len(set(labels)) == 50
    _same(got, pdf.loc[labels])                       # the frame's rows at the drawn labels
    assert got.equals(df.sample(50, replace=replace, random_state=11).to_pandas())
    assert not got.index.equals(df.sample(50, replace=replace, random_state=12).to_pandas().index)
    assert len(df.sample(frac=0.1, random_state=1)) == 20


def test_memory_usage_counts_the_columns_buffers():
    pdf = pd.DataFrame({"a": np.arange(7, dtype=np.int32), "f": np.linspace(0, 1, 7)})
    r, p = _both(pdf)
    assert p.memory_usage().to_pandas().tolist() == r.memory_usage().to_pandas().tolist() \
        == [28, 56]
    s = ct.DataFrame.from_pandas(_frame(), device="cpu")
    assert s.memory_usage().to_pandas().to_dict() == {n: c.nbytes for n, c in
                                                      s._table.items()}
    assert p["f"].memory_usage() == r["f"].memory_usage() == 56


def test_from_dict_matches_pandas_and_the_reference():
    rows = {"r1": {"a": 1, "b": 2.5}, "r2": {"a": 3, "c": "x"}, "r0": {"b": -1.0}}
    got = ct.DataFrame.from_dict(rows, orient="index", device="cpu").to_pandas()
    exp = pd.DataFrame.from_dict(rows, orient="index")
    assert got.index.tolist() == exp.index.tolist() and list(got.columns) == list(exp.columns)
    for c in exp.columns:
        assert got[c].isna().tolist() == exp[c].isna().tolist()
        assert got[c].dropna().tolist() == exp[c].dropna().tolist()
    lists = {"x": [1, 2, 3], "y": [4, 5, 6]}
    got = ct.DataFrame.from_dict(lists, orient="index", columns=["p", "q", "r"],
                                 device="cpu").to_pandas()
    assert got.equals(pd.DataFrame.from_dict(lists, orient="index", columns=["p", "q", "r"]))
    cols = {"a": [1, 2], "s": ["u", "v"]}
    assert ct.DataFrame.from_dict(cols, device="cpu").to_pandas().equals(
        ref.DataFrame.from_dict(cols).to_pandas())


def test_from_records_matches_the_reference():
    recs = [(1, "a", 0.5), (2, "b", 1.5), (3, None, 2.5)]
    got = ct.DataFrame.from_records(recs, columns=["i", "s", "f"], device="cpu").to_pandas()
    exp = ref.DataFrame.from_records(recs, columns=["i", "s", "f"]).to_pandas()
    assert got["i"].tolist() == exp["i"].tolist() and got["f"].tolist() == exp["f"].tolist()
    assert got["s"].tolist()[:2] == exp["s"].tolist()[:2] and got["s"].isna().tolist() == \
        exp["s"].isna().tolist()
    arr = np.array([(1, 2.0), (3, 4.0)], dtype=[("x", "i8"), ("y", "f8")])
    assert ct.DataFrame.from_records(arr, device="cpu").to_pandas().equals(
        pd.DataFrame.from_records(arr))
    dicts = [{"x": 1, "y": 2}, {"x": 3, "y": 4}]
    assert ct.DataFrame.from_records(dicts, device="cpu").to_pandas().equals(
        pd.DataFrame.from_records(dicts))


def test_row_iterators_and_records_match_the_reference():
    pdf = _frame(6).fillna({"v": 0.25})
    r, p = _both(pdf)
    for (li, lr), (ri, rr) in zip(p.iterrows(), r.iterrows()):
        assert li == ri and lr.equals(rr)
    assert list(p.itertuples(name="Row")) == list(r.itertuples(name="Row"))
    assert list(p.itertuples(index=False)) == list(r.itertuples(index=False))
    assert p.to_records().tolist() == r.to_records().tolist()
    assert p.to_records(index=False).dtype.names == r.to_records(index=False).dtype.names
    assert [n for n, _ in p.iteritems()] == [n for n, _ in r.iteritems()] == list(pdf.columns)


def test_info_lays_out_what_pandas_does():
    pdf = pd.DataFrame({"a": np.arange(4), "v": [1.0, np.nan, 3.0, 4.0],
                        "b": [True, False, True, True]})
    buf, exp = io.StringIO(), io.StringIO()
    ct.DataFrame.from_pandas(pdf, device="cpu").info(buf=buf)
    pdf.info(buf=exp)
    got, want = buf.getvalue().splitlines(), exp.getvalue().splitlines()
    assert got[0] == "<class 'cudf_tpu_torch.frame.dataframe.DataFrame'>"
    assert want[0] == f"<class '{pd.DataFrame.__module__}.DataFrame'>"   # str(type(df))
    assert got[1:-1] == want[1:-1]
    assert got[-1].startswith("memory usage: ")


def test_shift_by_a_frequency_moves_the_index_as_the_reference():
    idx = pd.date_range("2024-03-01", periods=5, freq="h")
    pdf = pd.DataFrame({"a": np.arange(5), "v": np.linspace(0.0, 1.0, 5)}, index=idx)
    r, p = _both(pdf)
    for periods, freq in ((1, "2h"), (-2, "30min"), (3, "D")):
        exp = r.shift(periods, freq=freq).to_pandas()
        got = p.shift(periods, freq=freq).to_pandas()
        assert got.index.tolist() == exp.index.tolist() == \
            pdf.shift(periods, freq=freq).index.tolist()
        _same(got, exp)


def test_shift_along_the_columns_matches_the_reference():
    pdf = pd.DataFrame({"a": [1, 2, 3], "b": [4, 5, 6], "c": [7, 8, 9]})
    r, p = _both(pdf)
    for periods in (1, -1, 2):
        exp = r.shift(periods, axis=1).to_pandas()
        got = p.shift(periods, axis=1).to_pandas()
        assert got.equals(exp) and got.equals(pdf.shift(periods, axis=1)), periods


def test_shift_along_the_columns_fills_as_pandas():
    """The reference drops ``fill_value`` along the columns
    (``cudf_tpu/frame/dataframe.py:617-628``); the port fills as pandas."""
    pdf = pd.DataFrame({"a": [1, 2, 3], "b": [4, 5, 6]})
    got = ct.DataFrame.from_pandas(pdf, device="cpu").shift(-1, axis=1, fill_value=0)
    assert got.to_pandas().equals(pdf.shift(-1, axis=1, fill_value=0))
    assert ref.DataFrame.from_pandas(pdf).shift(-1, axis=1, fill_value=0).to_pandas()[
        "b"].isna().all()


def test_groupby_takes_group_keys_and_observed_as_the_reference():
    pdf = _frame()[["k", "i", "v"]]
    r, p = _both(pdf)
    for kw in ({"group_keys": False}, {"group_keys": True, "observed": True}):
        exp = r.groupby("k", sort=True, **kw).sum().to_pandas()
        got = p.groupby("k", **kw).sum().to_pandas()
        for c in ("i", "v"):
            np.testing.assert_allclose(got[c].to_numpy(float), exp[c].to_numpy(float), rtol=RTOL)
        assert got.index.tolist() == exp.index.tolist()
    s = p["v"].groupby(p["k"], group_keys=False).max().to_pandas()
    assert s.equals(pdf["v"].groupby(pdf["k"]).max())


def test_stack_takes_level_and_dropna():
    pdf = pd.DataFrame({"a": [1.0, np.nan], "b": [3.0, 4.0]}, index=["x", "y"])
    df = ct.DataFrame.from_pandas(pdf, device="cpu")
    exp = pdf.stack()
    got = df.stack(level=-1).to_pandas()
    assert got.index.tolist() == exp.index.tolist()
    np.testing.assert_array_equal(got.to_numpy(), exp.to_numpy())
    assert df.stack(0).to_pandas().index.tolist() == exp.index.tolist()
    dropped = df.stack(dropna=True).to_pandas()
    assert dropped.index.tolist() == exp.dropna().index.tolist()
    with pytest.raises(IndexError):
        df.stack(level=1)


@pytest.mark.parametrize("ddof", [0, 2])
def test_std_and_var_take_ddof_as_the_reference(ddof):
    pdf = _frame()[["i", "v"]]
    r, p = _both(pdf)
    for name in ("std", "var"):
        exp = getattr(r, name)(ddof=ddof).to_pandas()
        got = getattr(p, name)(ddof=ddof).to_pandas()
        np.testing.assert_allclose(got.to_numpy(), exp.to_numpy(), rtol=RTOL)
        np.testing.assert_allclose(getattr(p, name)(axis=1, ddof=ddof).to_pandas().to_numpy(),
                                   getattr(pdf, name)(axis=1, ddof=ddof).to_numpy(), rtol=RTOL)


def test_groupby_product_is_prod_as_the_reference():
    rng = np.random.default_rng(8)
    pdf = pd.DataFrame({"k": rng.integers(0, 4, 60), "v": rng.uniform(0.5, 1.5, 60),
                        "i": rng.integers(1, 3, 60)})
    r, p = _both(pdf)
    exp = r.groupby("k", sort=True).product().to_pandas()
    got = p.groupby("k").product().to_pandas()
    assert got.index.tolist() == exp.index.tolist()
    assert got["i"].tolist() == exp["i"].tolist()
    np.testing.assert_allclose(got["v"].to_numpy(), exp["v"].to_numpy(), rtol=RTOL)
    s_exp = r["v"].groupby(r["k"], sort=True).product().to_pandas()
    s_got = p["v"].groupby(p["k"]).product().to_pandas()
    np.testing.assert_allclose(s_got.to_numpy(), s_exp.to_numpy(), rtol=RTOL)


@pytest.mark.parametrize("values, downcast", [
    ([1.0, 2.0, 250.0], "integer"), ([1.5, 2.0], "integer"), ([1, 300, -5], "signed"),
    ([1, 300, 70000], "unsigned"), ([-1, 3], "unsigned"), ([0.1, 2.2], "float"),
    ([1e300, 1.0], "float"), (["7", "-8", "9"], "integer"), ([True, False], "integer"),
    ([2 ** 40, 1], "integer")])
def test_to_numeric_downcasts_as_pandas(values, downcast):
    """The reference accepts ``downcast`` and ignores it
    (``cudf_tpu/frame/tools.py:45``); the port downcasts as pandas."""
    exp = pd.to_numeric(pd.Series(values), downcast=downcast)
    got = ct.to_numeric(ct.Series(pd.Series(values), device="cpu"), downcast=downcast)
    assert str(got.to_pandas().dtype) == str(exp.dtype)
    assert got.to_pandas().tolist() == exp.tolist()
    if not isinstance(values[0], (str, bool)):
        assert ref.to_numeric(ref.Series(pd.Series(values)), downcast=downcast).to_pandas(
        ).dtype == pd.Series(values).dtype


def test_tpch_queries_name_the_reference_queries():
    from cudf_tpu_torch.models import tpch_queries

    assert set(tpch_queries()) == {"q1", "q3", "q4", "q5", "q6", "q9", "q10", "q12", "q14",
                                   "generate"}


def test_the_frame_api_requests_of_the_new_surface_equal_their_plain_versions(monkeypatch):
    """The card's new G1 requests (``models/frame_api.py``) at 20000 rows on
    the CPU, each answer against its plain version at its RTOL."""
    import torch

    from cudf_tpu_torch.models import frame_api as fa
    from cudf_tpu_torch.models import io_paths

    monkeypatch.setattr(fa, "SAMPLE_ROWS", 500)
    frames = {"g1": io_paths.g1_frame(20_000, device="cpu")}
    for name in ("rank_v1_v3", "mode_id4_id5_v1", "product_v3_by_id6", "sample_1e6",
                 "memory_usage"):
        assert name in fa.GROUPS["g1"] and fa.NEEDS[name] == []
        got = fa.ANSWERS[name](fa.REQUESTS[name](frames), frames)
        exp = fa.PLAIN[name](frames)
        assert list(got) == list(exp), name
        for key in exp:
            a, b = got[key], exp[key]
            assert a.dtype == b.dtype and a.shape == b.shape, (name, key)
            if a.is_floating_point():
                assert torch.allclose(a, b, rtol=fa.RTOL[name], atol=0.0), (name, key)
            else:
                assert torch.equal(a, b), (name, key)
