"""The reference accelerator's parity sweep
(``models/pandas_scripts/sweep.py``, the 31 statements of
``tests/test_pandas_accelerator.py`` ``test_parity_sweep_no_fallbacks``)
under the port's proxy on the CPU, the reference's and plain pandas."""

import runpy

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
from torch_pandas_helpers import plain, same, under

ROWS = 200


def _sweep():
    from cudf_tpu_torch.models.pandas_form import SCRIPTS

    g = runpy.run_path(str(SCRIPTS["sweep"]), run_name="sweep")
    frames = g["load"](ROWS, 42)
    return {name: fn(frames) for name, fn in g["REQUESTS"].items()}


def _reference_form(name, got, ref):
    """The port's answer and the reference's where the reference departs
    from pandas (ROADMAP.md section 3), each cut to what both hold:
    ``groupby("k").sum()`` drops the string column pandas sums by joining;
    ``value_counts`` orders tied counts otherwise than pandas' first
    appearance; ``get_dummies`` prefixes the column names; ``cut`` labels
    its bins at full precision (compared here by bin code)."""
    if name == "groupby_sum":
        assert list(ref.columns) == ["v", "w"] and list(got.columns) == ["v", "w", "s"]
        return got[["v", "w"]], ref
    if name == "value_counts":
        return got.sort_index(), ref.sort_index()
    if name == "get_dummies":
        assert list(ref.columns) == [f"s_{c}" for c in got.columns]
        return got, ref.set_axis(got.columns, axis=1)
    if name == "cut":
        return got.cat.codes, ref.cat.codes
    return got, ref


def test_the_sweep_runs_fast_on_both_proxies_and_agrees():
    """Profiler slow 0 and fast >= 40 on both proxies; every answer the
    same under the port and pandas (dtypes too; ``cut``'s bins as their
    labels, the port having no interval dtype), and under the port and
    the reference (values; ``_reference_form``).  The rolling mean is held
    within 1e-12 of the values' scale (1.0, the clipped values' largest)
    as well as rtol 1e-12: pandas adds and subtracts as the window moves
    and the reference differences prefix sums, so a mean near 0 carries an
    error relative to the values."""
    import cudf_tpu.pandas as reference
    import cudf_tpu_torch.pandas as port

    answers, stats = {}, {}
    for kind, accel in (("pandas", None), ("reference", reference), ("port", port)):
        with under(kind):
            if accel is None:
                answers[kind] = _sweep()
                continue
            with accel.Profiler() as prof:
                answers[kind] = {k: plain(v) for k, v in _sweep().items()}
            stats[kind] = prof.stats
    for kind in ("reference", "port"):
        assert stats[kind]["slow"] == 0, (kind, stats[kind])
        assert stats[kind]["fast"] >= 40, (kind, stats[kind])
    assert len(answers["port"]) == 31
    for name, exp in answers["pandas"].items():
        got, ref = answers["port"][name], answers["reference"][name]
        # a rolling mean's rounding is relative to the window's values
        atol = 1e-12 * float(answers["pandas"]["clip"].abs().max()) if name == "rolling_mean" \
            else 0.0
        if name == "cut":
            same(got.astype(str), exp.astype(str), "sweep cut: port vs pandas labels")
        else:
            same(got, exp, f"sweep {name}: port vs pandas", atol=atol)
        got, ref = _reference_form(name, got, ref)
        same(got, ref, f"sweep {name}: port vs reference", check_dtype=False, atol=atol)
