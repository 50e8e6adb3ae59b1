"""TPC-H q5 through the port's engine against the reference's
engine and ``pandas_reference`` (as ``tests/test_torch_tpch.py`` holds
the other queries: the reference engine compiles for 20-30 s a join
query on the CPU, so these take files of their own).
"""

import pytest

from test_torch_tpch import check_query, ref_tables, tables  # noqa: F401 (fixtures)


@pytest.mark.parametrize("query", ['q5'])
def test_query_matches_reference_engine_and_pandas(tables, ref_tables, query):  # noqa: F811
    check_query(tables, ref_tables, query)
