"""TPC-H q12 over ``scan_parquet`` sources through the port's engine
against the reference's engine over the same files (``benchmarks/tpch.py``'s
q12 with its sources swapped for the reference's ``scan_parquet``; its
join compiles for 20-30 s on the CPU, so it has this file to itself).
The files are written by the port's writer from ``generate(0.002,
seed=7)``; the reference reads them too (DICTIONARY columns written as
their strings, which its own writer cannot do).  Keys and counts exact.
"""

import pytest
import torch

from benchmarks import tpch as ref_tpch
from cudf_tpu.engine import lazy as ref_lazy

from cudf_tpu_torch.engine import scan_parquet
from cudf_tpu_torch.io import IO_ROUTES
from cudf_tpu_torch.models import tpch

CPU = torch.device("cpu")


@pytest.mark.parametrize("optimized", [True, False])
def test_q12_from_parquet_against_the_reference_engine(tmp_path, monkeypatch, optimized):
    t = tpch.generate(0.002, seed=7, device=CPU)
    paths = {}
    for name in ("lineitem", "orders"):
        paths[name] = str(tmp_path / f"{name}.parquet")
        t[name].to_parquet(paths[name], row_group_size=3000)
    before = IO_ROUTES["pyarrow"]
    got = tpch.q12({n: scan_parquet(p, device=CPU) for n, p in paths.items()},
                   no_optimization=not optimized)
    assert IO_ROUTES["pyarrow"] == before
    orig = ref_tpch.from_dataframe
    monkeypatch.setattr(ref_tpch, "from_dataframe",
                        lambda x: x if isinstance(x, ref_lazy.LazyFrame) else orig(x))
    if optimized:
        exp = ref_tpch.q12({n: ref_lazy.scan_parquet(p) for n, p in paths.items()})
        e = exp.to_pandas()
        g = got.to_pandas()
        assert g["l_shipmode"].astype(str).tolist() == e["l_shipmode"].astype(str).tolist()
        for c in ("high_line_count", "low_line_count"):
            assert g[c].tolist() == e[c].tolist()
    mem = tpch.answer("q12", tpch.q12(t))
    file = tpch.answer("q12", got)
    assert file[0] == mem[0] and torch.equal(file[1], mem[1]) and torch.equal(file[2], mem[2])
