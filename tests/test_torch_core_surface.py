"""The core, option and small surface the port gained to match the
reference's (``tests/test_torch_surface.py``), each held to the reference
on the CPU over the same inputs: integers, strings and masks exactly,
floats within rtol 1e-12.  The IO options are held to the routes they
choose (``io.IO_ROUTES``) and to the same frames either way."""

import contextlib
import io

import numpy as np
import pandas as pd
import pytest
import torch

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
import cudf_tpu as ref
import cudf_tpu_torch as ct
from cudf_tpu.core import bitmask as ref_bm
from cudf_tpu_torch.core import bitmask as bm

RTOL = 1e-12


def test_the_top_level_exports_the_references_names():
    from cudf_tpu_torch.core.dtypes import DType, dtype
    from cudf_tpu_torch.utils import config, missing

    assert set(ref.__all__) <= set(ct.__all__)
    assert ct.DType is DType and ct.dtype is dtype and ct.get_option is config.get_option
    assert ct.NA is missing.NA and repr(ct.NA) == repr(ref.NA) == "<NA>"
    assert np.isnat(ct.NaT) and np.isnat(ref.NaT)
    assert str(ct.dtype("int32")) == str(ref.dtype("int32")) == "int32"
    assert ct.engine.col is not None and hasattr(ct.engine, "LazyFrame")


def test_the_core_package_exports_the_references_names():
    import cudf_tpu.core as ref_core

    import cudf_tpu_torch.core as core

    assert core.__all__ == ref_core.__all__
    assert [t.name for t in core.TypeId] == [t.name for t in ref_core.TypeId]


@pytest.mark.parametrize("values, dtype", [([1, None, 3], None), ([0.5, None, 2.0], "float64"),
                                           (["a", None, "ccc"], None), ([True, None], None),
                                           ([1, 2, 3], "int16")])
def test_from_sequence_and_as_column_match_the_reference(values, dtype):
    got = ct.core.Column.from_sequence(values, dtype, device="cpu")
    exp = ref.core.Column.from_sequence(values, dtype)
    assert str(got.dtype) == str(exp.dtype) and got.size == exp.size == len(values)
    assert got.to_pandas().tolist() == exp.to_pandas().tolist() or \
        got.to_pandas().isna().tolist() == exp.to_pandas().isna().tolist()
    assert got.null_count == exp.null_count
    assert ct.core.as_column(values, dtype, device="cpu").to_pandas().equals(got.to_pandas())
    present = [v for v in values if v is not None]
    for obj in (np.array(present), pd.Series(present)):
        a = ct.core.as_column(obj, dtype, device="cpu")
        b = ref.core.as_column(obj, dtype)
        assert str(a.dtype) == str(b.dtype) and a.to_pylist() == b.to_pylist()
    assert ct.core.as_column(torch.tensor([1, 2]), "float64").to_pylist() == [1.0, 2.0]
    with pytest.raises(ValueError, match="device"):
        ct.core.as_column([1, 2])


def test_as_column_is_column_of_and_refuses_a_device_the_data_is_not_on():
    """``frame.series.column_of`` is ``core.as_column``: a tensor on another
    device than the one asked for raises, and "category" dictionary-encodes
    a list as ``Series(..., dtype="category")`` does."""
    from cudf_tpu_torch.frame.series import column_of

    elsewhere = torch.empty(3, dtype=torch.int64, device="meta")
    for build in (lambda: ct.core.as_column(elsewhere, device="cpu"),
                  lambda: column_of(elsewhere, device="cpu")):
        with pytest.raises(ValueError, match="asked for cpu"):
            build()
    assert ct.core.as_column(torch.tensor([4, 5]), device="cpu").to_pylist() == [4, 5]
    for build in (ct.core.as_column, column_of):
        cat = build(["b", "a", None, "b"], dtype="category", device="cpu")
        exp = pd.Series(["b", "a", None, "b"], dtype="category")
        assert cat.dtype.is_dictionary
        assert cat.to_pandas().astype(object).where(cat.to_pandas().notna(), None).tolist() \
            == exp.astype(object).where(exp.notna(), None).tolist()
    with pytest.raises(TypeError, match="cannot build a column"):
        ct.core.as_column({1, 2}, device="cpu")


def test_from_numpy_and_from_strings_take_a_mask_as_the_reference():
    arr, mask = np.array([1.5, 2.5, np.nan, 4.0]), np.array([True, False, True, True])
    got = ct.Column.from_numpy(arr, mask, device="cpu")
    exp = ref.Column.from_numpy(arr, mask)
    assert got.null_count == 2 and exp.null_count == 1       # the port's NaN is a null too
    assert got.to_pandas().isna().tolist() == [False, True, True, False]
    ints = np.arange(4)
    assert ct.Column.from_numpy(ints, mask, device="cpu").to_pandas().tolist()[::2] == \
        ref.Column.from_numpy(ints, mask).to_pandas().tolist()[::2] == [0.0, 2.0]
    s = ct.Column.from_strings(["x", "y", None], np.array([True, False, True]), device="cpu")
    r = ref.Column.from_strings(["x", "y", ""], mask=np.array([True, False, False]))
    assert s.to_pylist() == r.to_pylist() == ["x", None, None]


def test_column_copy_size_and_nullable_export():
    col = ct.Column.from_pylist([1, None, 3], device="cpu")
    deep, shallow = col.copy(), col.copy(deep=False)
    assert deep.data.data_ptr() != col.data.data_ptr()
    assert shallow.data.data_ptr() == col.data.data_ptr()
    deep.data[0] = 7
    assert col.to_pylist() == [1, None, 3] and col.size == 3
    exp = ref.Column.from_sequence([1, None, 3]).copy()
    assert exp.to_pandas().tolist()[0] == col.to_pandas().tolist()[0] == 1.0
    assert str(col.to_pandas(nullable=True).dtype) == "Int64"
    assert col.to_pandas(nullable=True).tolist()[::2] == [1, 3]
    s = ct.Column.from_pylist(["a", None], device="cpu").to_pandas(nullable=True)
    assert str(s.dtype) == "string" and s.isna().tolist() == [False, True]


def test_table_surface_matches_the_reference():
    pdf = pd.DataFrame({"a": [1, 2, 3], "s": ["x", None, "z"], "f": [0.5, np.nan, 1.5]})
    got = ct.Table.from_pandas(pdf, device="cpu")
    exp = ref.Table.from_pandas(pdf)
    assert got.names == exp.names
    assert got.select_by_index([2, 0]).names == exp.select_by_index([2, 0]).names == ("f", "a")
    assert list(got.to_dict()) == list(exp.to_dict()) and got.to_dict()["a"] is got["a"]
    g, e = got.to_pandas(), exp.to_pandas()
    assert g["a"].tolist() == e["a"].tolist() and g["s"].isna().tolist() == \
        e["s"].isna().tolist()
    np.testing.assert_allclose(g["f"].to_numpy(), e["f"].to_numpy(), rtol=RTOL)


def test_bitmask_or_and_valid_count_match_the_reference():
    a, b = np.array([True, False, False, True]), np.array([False, False, True, True])
    got = bm.or_masks(torch.from_numpy(a), torch.from_numpy(b))
    exp = ref_bm.or_masks(ref_bm.from_numpy_mask(a), ref_bm.from_numpy_mask(b))
    assert got.tolist() == np.asarray(exp).tolist()
    assert bm.or_masks(torch.from_numpy(a), None) is None is ref_bm.or_masks(
        ref_bm.from_numpy_mask(a), None)
    assert bm.valid_count(torch.from_numpy(a), 4) == ref_bm.valid_count(
        ref_bm.from_numpy_mask(a), 4) == 2
    assert bm.valid_count(None, 5) == ref_bm.valid_count(None, 5) == 5


def test_describe_option_prints_as_the_reference():
    outs = []
    for mod in (ref, ct):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.describe_option("display.max_rows")
        outs.append(buf.getvalue())
    assert outs[0].split(":")[0] == outs[1].split(":")[0] == "display.max_rows"
    assert outs[0].endswith("(default 60, current 60)\n") and outs[1].endswith(
        "(default 60, current 60)\n")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ct.describe_option()
    assert len(buf.getvalue().splitlines()) == len(ct.utils.config._registry) == 27


def test_the_new_options_set_and_refuse_as_registered():
    from cudf_tpu_torch.utils.config import _registry

    # read nowhere: each takes its default alone, so a setting the port would
    # ignore raises instead
    others = {"display.max_rows": 5, "mode.pandas_compatible": False,
              "default_integer_bitwidth": 32, "default_float_bitwidth": 32,
              "strings.host_fallback": False, "io.parquet.chunk_read_limit": 1 << 20,
              "io.parquet.device_decode": False}
    for name, other in others.items():
        assert "read nowhere" in _registry[name].description, name
        default = _registry[name].default
        with pytest.raises(ValueError):
            ct.set_option(name, other)
        with pytest.raises(ValueError):
            ct.set_option(name, float(default) if isinstance(default, int) else str(default))
        ct.set_option(name, default)
        assert ct.get_option(name) == default
    with ct.option_context("display.max_rows", 60, "io.csv.device_tokenizer", False):
        assert ct.get_option("io.csv.device_tokenizer") is False
    assert ct.get_option("io.csv.device_tokenizer") is True
    with pytest.raises(ValueError):
        ct.set_option("default_integer_bitwidth", 16)


def _routes():
    from cudf_tpu_torch.io import IO_ROUTES

    return dict(IO_ROUTES)


def _route_of(fn):
    before = _routes()
    out = fn()
    after = _routes()
    return out, {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


@pytest.mark.parametrize("fmt", ["csv", "json", "orc", "parquet"])
def test_the_io_options_choose_the_tier(fmt, tmp_path):
    rng = np.random.default_rng(4)
    pdf = pd.DataFrame({"a": rng.integers(0, 9, 30), "f": rng.normal(size=30)})
    df = ct.DataFrame.from_pandas(pdf, device="cpu")
    path = str(tmp_path / f"t.{fmt}")
    read = {"csv": lambda: ct.read_csv(path, device="cpu"),
            "json": lambda: ct.read_json(path, lines=True, device="cpu"),
            "orc": lambda: ct.read_orc(path, device="cpu"),
            "parquet": lambda: ct.read_parquet(path, device="cpu")}[fmt]
    write = {"csv": lambda: pdf.to_csv(path, index=False),
             "json": lambda: pdf.to_json(path, orient="records", lines=True),
             "orc": lambda: df.to_orc(path), "parquet": lambda: df.to_parquet(path)}[fmt]
    option = {"csv": "io.csv.device_tokenizer", "json": "io.json.device_tokenizer",
              "orc": "io.orc.native_reader", "parquet": "io.parquet.native_reader"}[fmt]
    _, wrote = _route_of(write)
    native, on = _route_of(read)
    with ct.option_context(option, False):
        host, off = _route_of(read)
    assert on == {"native": 1} and off == {"pyarrow": 1}, (on, off)
    assert wrote in ({}, {"native": 1})
    a, b = native.to_pandas(), host.to_pandas()
    assert a["a"].tolist() == b["a"].tolist() == pdf["a"].tolist()
    np.testing.assert_allclose(a["f"].to_numpy(), b["f"].to_numpy(), rtol=RTOL)
    if fmt in ("orc", "parquet"):
        with ct.option_context(f"io.{fmt}.native_writer", False):
            _, off = _route_of(write)
        assert off == {"pyarrow": 1}
        assert ct.read_orc(path, device="cpu").to_pandas()["a"].tolist() == pdf["a"].tolist() \
            if fmt == "orc" else True


def test_the_hybrid_scan_option_reads_the_same_rows(tmp_path):
    from cudf_tpu_torch.io import parquet_native

    rng = np.random.default_rng(6)
    df = ct.DataFrame({"k": torch.from_numpy(np.sort(rng.integers(0, 1000, 4000))),
                       "v": torch.from_numpy(rng.normal(size=4000))})
    path = str(tmp_path / "h.parquet")
    df.to_parquet(path, row_group_size=1000, data_page_rows=100, write_page_index=True)
    flt = [("k", ">=", 400), ("k", "<", 420)]
    calls = []
    real = parquet_native._hybrid_exact_intervals

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)
    parquet_native._hybrid_exact_intervals = spy
    try:
        on = ct.read_parquet(path, filters=flt, device="cpu").to_pandas()
        n_on = len(calls)
        with ct.option_context("io.parquet.hybrid_scan", False):
            off = ct.read_parquet(path, filters=flt, device="cpu").to_pandas()
    finally:
        parquet_native._hybrid_exact_intervals = real
    assert n_on > 0 and len(calls) == n_on
    assert on.equals(off) and on["k"].between(400, 419).all() and len(on) > 0


def test_renamed_parameters_take_the_references_names(tmp_path):
    from cudf_tpu_torch.engine import col, from_dataframe
    from cudf_tpu_torch.engine.streaming import evaluate_streaming
    from cudf_tpu_torch.frame.reshape import unstack
    from cudf_tpu_torch.io.csv import write_csv

    df = ct.DataFrame({"k": torch.arange(20) % 3, "v": torch.arange(20.0)})
    plan = from_dataframe(df).group_by("k").agg(col("v").sum())._node
    got = evaluate_streaming(plan, mesh_or_nparts=4)
    assert sorted(got["v"].to_pylist()) == [57.0, 63.0, 70.0]
    grid = ct.DataFrame({"a": torch.arange(6) // 3, "b": torch.arange(6) % 3,
                         "w": torch.arange(6.0)}).set_index(["a", "b"])["w"]
    assert unstack(frame=grid).to_pandas().equals(grid.unstack().to_pandas())
    path = str(tmp_path / "w.csv")
    write_csv(df=df, path=path, index=False)
    assert pd.read_csv(path)["v"].tolist() == list(np.arange(20.0))


def test_small_functions_match_the_reference():
    from cudf_tpu.frame.accessors import binaryop_concat as ref_concat
    from cudf_tpu.frame.series import column_to_pandas_array as ref_array

    from cudf_tpu_torch.frame.accessors import binaryop_concat
    from cudf_tpu_torch.frame.series import column_to_pandas_array

    a, b = ["ab", None, "c"], ["x", "y", "zz"]
    got = binaryop_concat(ct.Column.from_pylist(a, device="cpu"),
                          ct.Column.from_pylist(b, device="cpu"))
    exp = ref_concat(ref.Column.from_sequence(a), ref.Column.from_sequence(b))
    assert got.to_pylist() == exp.to_pylist() == ["abx", None, "czz"]
    vals = [1.5, None, 3.0]
    assert column_to_pandas_array(ct.Column.from_pylist(vals, device="cpu"), pd).tolist()[::2] \
        == list(ref_array(ref.Column.from_sequence(vals), pd))[::2]
    s = ct.Series(torch.tensor([1.0, 2.0]))
    assert s.apply(lambda x: x + 1, convert_dtype=False).tolist() == [2.0, 3.0]
